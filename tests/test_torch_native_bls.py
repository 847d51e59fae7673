"""The port's native BLS12-381 binding (crypto/native_bls, its own g++ build of
native/bls12_381.cpp) against the port's pure-Python `_py_*` oracles and
against the JAX package's binding, on the same seeded inputs: G1/G2
multiplies (generic and subgroup ladders), adds, weighted sums, the MSM, the
short-Horner folds, decompression, the subgroup checks, both pairing checks
and hash_to_g2, with infinity and the zero scalar.  Points compare by their
affine coordinates.  Also: a failing build raises with the compiler's
output, and HYDRABADGER_NO_NATIVE_BLS=1 selects the pure path."""
import importlib
import os
import random

import pytest

from hydrabadger_tpu.crypto import bls12_381 as jbls
from hydrabadger_tpu.crypto import native_bls as jnb
from hydrabadger_tpu_torch.crypto import bls12_381 as bls
from hydrabadger_tpu_torch.crypto import native_bls as nb
from hydrabadger_tpu_torch.crypto import dkg, threshold

R = bls.R


def aff(pt):
    """Affine coordinates as ints (either package's points); None at infinity."""
    a = (bls if isinstance(pt[0], (bls.FQ, bls.FQ2)) else jbls).normalize(pt)
    if a is None:
        return None
    return tuple(c.n if hasattr(c, "n") else tuple(c.coeffs) for c in a)


def jpt(pt):
    """A port point as the JAX package's point (through the compressed bytes)."""
    if isinstance(pt[0], bls.FQ):
        return jbls.g1_from_bytes(bls.g1_to_bytes(pt))
    return jbls.g2_from_bytes(bls.g2_to_bytes(pt))


def jax_native(name, *args):
    """The JAX binding's result where its library is built, else None."""
    return getattr(jnb, name)(*args) if jnb.available() else None


@pytest.fixture(scope="module")
def pts():
    rng = random.Random(2024)
    g1 = [bls._py_multiply(bls.G1, rng.randrange(1, R)) for _ in range(4)]
    g2 = [bls._py_hash_to_g2(b"native-%d" % i) for i in range(2)]
    return rng, g1, g2


def test_the_binding_builds_loads_and_is_selected():
    assert nb.available() and nb._load().bls381_version() == nb.ABI_VERSION
    assert nb.LIB_PATH.exists() and nb.LIB_PATH.parent.name == "host_native"
    stamp = nb.LIB_PATH.with_name(nb.LIB_PATH.name + ".stamp").read_text()
    assert stamp == nb._stamp(os.environ.get("CXX") or "g++")


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_multiplies_and_adds_equal_the_oracle_and_the_jax_binding(pts, group):
    rng, g1, g2 = pts
    base = g1 if group == "g1" else g2
    field = bls.FQ if group == "g1" else bls.FQ2
    inf = bls.infinity(field)
    scalars = [0, 1, 2, R - 1, R + 3, -7, rng.randrange(R), 2**255 + 11]
    for k in scalars:
        want = aff(bls._py_multiply(base[0], k))
        assert aff(bls.multiply(base[0], k)) == want, k
        assert aff(bls.mul_sub(base[0], k)) == want, k
        j = jax_native(f"{group}_mul_sub", jpt(base[0]), k % R)
        assert j is None or aff(j) == aff(bls._py_multiply(base[0], k % R))
    assert bls.is_inf(bls.multiply(inf, 5)) and bls.is_inf(bls.mul_sub(inf, 5))
    a, b = base[0], base[1]
    for p, q in ((a, b), (a, a), (a, bls.neg(a)), (inf, a), (a, inf), (inf, inf)):
        want = aff(bls._py_add(p, q))
        assert aff(bls.add(p, q)) == want
        j = jax_native(f"{group}_add", jpt(p), jpt(q))
        assert j is None or aff(j) == want


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_weighted_sums_equal_the_pure_interpolation(pts, group):
    rng, g1, g2 = pts
    base = g1 if group == "g1" else g2
    points = {1: base[0], 3: base[1], 4: bls.infinity(type(base[0][0])) if group == "g1" else base[0]}
    lam = threshold.lagrange_coeffs_at_zero(list(points))
    want = bls.infinity(type(base[0][0]))
    for pt, li in zip(points.values(), lam):
        want = bls._py_add(want, bls._py_multiply(pt, li))
    assert aff(threshold.interpolate_g_at_zero(points)) == aff(want)
    j = jax_native(f"{group}_weighted_sum", [jpt(p) for p in points.values()], lam)
    assert j is None or aff(j) == aff(want)


def test_msm_and_folds_equal_the_plain_sums(pts):
    rng, g1, _g2 = pts
    inf = bls.infinity(bls.FQ)
    points = g1[:3] + [inf]
    scalars = [rng.randrange(R), 0, 2**64 - 1, 5]
    want = inf
    for p, k in zip(points, scalars):
        want = bls._py_add(want, bls._py_multiply(p, k))
    assert aff(dkg.g1_msm_or_fallback(points, scalars)) == aff(want)
    assert bls.is_inf(nb.g1_msm([], []))
    j = jax_native("g1_msm", [jpt(p) for p in points], scalars)
    assert j is None or aff(j) == aff(want)
    matrix = [[g1[0], g1[1], inf], [g1[2], g1[3], g1[0]]]  # J = 2 rows, K = 3 columns
    for axis, x in ((0, 7), (1, 3), (1, 65535)):
        got = nb.g1_fold_pow(matrix, x, axis)
        if axis == 0:
            plain = [bls._py_add(matrix[0][k], bls._py_multiply(matrix[1][k], x)) for k in range(3)]
        else:
            plain = [bls._py_add(bls._py_add(row[0], bls._py_multiply(row[1], x)),
                                 bls._py_multiply(row[2], x * x)) for row in matrix]
        assert [aff(p) for p in got] == [aff(p) for p in plain], (axis, x)
        j = jax_native("g1_fold_pow", [[jpt(p) for p in row] for row in matrix], x, axis)
        assert j is None or [aff(p) for p in j] == [aff(p) for p in plain]
    with pytest.raises(ValueError, match="16 bits"):
        nb.g1_fold_pow(matrix, 1 << 16, 0)


def test_decompression_and_subgroup_checks(pts):
    _rng, g1, g2 = pts
    for pt in (g1[0], g1[1]):
        raw = bls.g1_to_bytes(pt)
        assert aff(nb.g1_decompress(raw)) == aff(pt) == aff(jbls.g1_from_bytes(raw))
        assert aff(bls.g1_from_bytes(raw)) == aff(pt)
    for pt in g2:
        raw = bls.g2_to_bytes(pt)
        assert aff(nb.g2_decompress(raw)) == aff(pt) == aff(jbls.g2_from_bytes(raw))
    assert bls.is_inf(bls.g1_from_bytes(bytes([0xC0]) + bytes(47)))
    assert bls.is_inf(bls.g2_from_bytes(bytes([0xC0]) + bytes(95)))
    # on the curve, outside the r-order subgroup: x = 0 on E(Fp)
    y = (bls.FQ(0) * bls.FQ(0) * bls.FQ(0) + bls.B1).sqrt()
    off = (bls.FQ(0), y, bls.FQ(1))
    assert bls.in_g1_subgroup(off) is nb.g1_in_subgroup(off) is False
    assert bls.in_g1_subgroup(g1[0]) and bls.in_g2_subgroup(g2[0])
    with pytest.raises(ValueError):
        bls.g1_from_bytes(bls.g1_to_bytes(off))
    # an on-curve E'(Fp2) point before cofactor clearing is outside G2
    x = bls.FQ2([5, 0])
    while (x * x * x + bls.B2).sqrt() is None:
        x = x + bls.FQ2([1, 0])
    raw_pt = (x, (x * x * x + bls.B2).sqrt(), bls.FQ2.one())
    assert nb.g2_in_subgroup(raw_pt) is False and bls.in_g2_subgroup(raw_pt) is False
    with pytest.raises(ValueError):
        bls.g2_from_bytes(bls.g2_to_bytes(raw_pt))
    bad = bytearray(bls.g1_to_bytes(g1[0]))
    bad[-1] ^= 1  # x moves off the curve or out of the subgroup
    with pytest.raises(ValueError):
        bls.g1_from_bytes(bytes(bad))


def test_pairing_checks_and_hash_equal_the_oracle():
    p1, q1 = bls._py_multiply(bls.G1, 35), bls._py_multiply(bls.G2, 11)
    for k in (35 * 11, 35 * 11 + 1):
        p2 = bls._py_multiply(bls.G1, k)
        want = bls._py_pairing_check_eq(p1, q1, p2, bls.G2)
        assert want == (k == 35 * 11)
        assert bls.pairing_check_eq(p1, q1, p2, bls.G2) == want
    pairs = [(bls.neg(bls._py_multiply(bls.G1, 6)), bls.G2),
             (bls._py_multiply(bls.G1, 2), bls._py_multiply(bls.G2, 3))]
    assert bls.pairing_product_check(pairs) and bls._py_pairing_product_check(pairs)
    pairs[1] = (bls._py_multiply(bls.G1, 3), bls._py_multiply(bls.G2, 3))
    assert not bls.pairing_product_check(pairs)
    # infinity in a pair contributes the identity
    assert bls.pairing_product_check([(bls.infinity(bls.FQ), bls.G2)])
    for msg in (b"", b"abc", bytes(range(200))):
        want = aff(bls._py_hash_to_g2(msg))
        assert aff(nb.hash_to_g2(msg, b"HBTPU-G2")) == want
        assert aff(jbls._py_hash_to_g2(msg)) == want
        j = jax_native("hash_to_g2", msg, b"HBTPU-G2")
        assert j is None or aff(j) == want


def test_a_failing_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="native BLS build failed"):
        nb.build_library(tmp_path / "libbls381.so")
    assert not (tmp_path / "libbls381.so").exists()
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run"):
        nb.build_library(tmp_path / "libbls381.so")
    # the loader raises too: no silent fall back to pure Python
    monkeypatch.setattr(nb, "_LIB", None)
    monkeypatch.setattr(nb, "LIB_PATH", tmp_path / "libbls381.so")
    with pytest.raises(RuntimeError):
        nb.available()
    with pytest.raises(RuntimeError):
        bls.multiply(bls.G1, 3)


def test_no_native_env_selects_the_pure_path(monkeypatch):
    monkeypatch.setenv("HYDRABADGER_NO_NATIVE_BLS", "1")
    try:
        importlib.reload(nb)
        assert nb.available() is False

        def boom(*_a):
            raise AssertionError("native path taken")

        monkeypatch.setattr(nb, "g1_mul", boom)
        monkeypatch.setattr(nb, "g1_mul_sub", boom)
        assert aff(bls.multiply(bls.G1, 9)) == aff(bls._py_multiply(bls.G1, 9))
        assert aff(bls.mul_sub(bls.G1, 9)) == aff(bls._py_multiply(bls.G1, 9))
        sk = threshold.SecretKey(12345)
        assert sk.public_key().verify(sk.sign(b"pure"), b"pure")
    finally:
        monkeypatch.delenv("HYDRABADGER_NO_NATIVE_BLS")
        importlib.reload(nb)
    assert nb.available()
    nb.set_enabled(False)
    try:
        assert nb.available() is False
    finally:
        nb.set_enabled(True)
    assert nb.available()
