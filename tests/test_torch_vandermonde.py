"""The port's batched commitment folds (ops/vandermonde_torch, the plain
versions of kernel B2 on the CPU) against the JAX package's host folds,
`BivarCommitment.row_commitment` / `column_commitment`, through its native
Horner and through its pure-Python path (both exact): t in {1, 2, 3} at
xs = 1..7, a matrix with infinity entries, a crafted collision x·acc ==
C[j] that only the complete chain add survives, and x = 0 and x = 2^16,
which the fold refuses.  The port's `warm_folds` caches the same points.
"""
import random

import pytest
import torch

from hydrabadger_tpu.crypto import bls12_381 as jbls
from hydrabadger_tpu.crypto import dkg as jdkg
from hydrabadger_tpu.crypto import native_bls
from hydrabadger_tpu_torch.crypto import bls12_381 as bls
from hydrabadger_tpu_torch.crypto import dkg
from hydrabadger_tpu_torch.ops import fq_torch, limbs
from hydrabadger_tpu_torch.ops import vandermonde_torch as vt

XS = list(range(1, 8))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run many tiny ops: one thread each, and no
    autograd bookkeeping (inference mode: the same values, less overhead
    per op)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.inference_mode():
        yield
    torch.set_num_threads(before)


@pytest.fixture(params=["native", "pure"])
def jax_route(request):
    """The JAX host fold through its native library or its Python path."""
    if request.param == "native" and not native_bls.available():
        pytest.skip("the JAX package's native BLS library is not built")
    native_bls.set_enabled(request.param == "native")
    yield request.param
    native_bls.set_enabled(True)


def matrix(t, seed, inf=()):
    """A (t+1) x (t+1) matrix of scalars of G1 (None: infinity)."""
    rng = random.Random(seed)
    m = [[rng.getrandbits(250) | 1 for _ in range(t + 1)] for _ in range(t + 1)]
    for j, k in inf:
        m[j][k] = None
    return m


def points(mod, m):
    return [[mod.infinity(mod.FQ) if k is None else mod.mul_sub(mod.G1, k) for k in row] for row in m]


def affine(pt, mod):
    return None if mod.is_inf(pt) else tuple(c.n for c in mod.normalize(pt)[:2])


def fold(m, xs, kind, ladd=False):
    """The port's fold of the matrix (kind "row": over j; "col": over k)
    -> xs-major lists of affine points."""
    C = torch.from_numpy(limbs.points_to_limbs([p for row in points(bls, m) for p in row]))
    C = C.reshape(3, limbs.N_LIMBS, len(m), len(m))
    if kind == "col":
        C = C.transpose(2, 3).contiguous()
    if ladd:  # the incomplete add in the chain, to show the collision bites
        real = fq_torch.ENTRIES["add"]
        fq_torch.ENTRIES["add"] = (fq_torch.jac_add_ladder, fq_torch.jac_add_ladder_plain)
        try:
            out = vt.fold_points_batch(C, xs)
        finally:
            fq_torch.ENTRIES["add"] = real
    else:
        out = vt.fold_points_batch(C, xs)
    pts = limbs.limbs_to_points(out.numpy())
    k = len(m)
    return [[affine(p, bls) for p in pts[i * k:(i + 1) * k]] for i in range(len(xs))]


def jax_fold(m, xs, kind):
    c = jdkg.BivarCommitment(points(jbls, m))
    f = c.row_commitment if kind == "row" else c.column_commitment
    return [[affine(p, jbls) for p in f(x)] for x in xs]


@pytest.mark.parametrize("t", [1, 2, 3])
def test_folds_equal_the_jax_host_folds(jax_route, t):
    m = matrix(t, 10 + t)
    for kind in ("row", "col"):
        assert fold(m, XS, kind) == jax_fold(m, XS, kind)


def test_a_matrix_with_infinity_entries(jax_route):
    m = matrix(2, 5, inf=[(0, 0), (1, 2), (2, 1), (2, 2)])
    for kind in ("row", "col"):
        assert fold(m, XS, kind) == jax_fold(m, XS, kind)


def test_the_chain_add_survives_a_crafted_collision(jax_route):
    """C[0][k] == x * C[1][k]: the chain's add meets acc == C[j] at x, and
    only the complete add (its doubling arm) gets 2x * C[1][k]."""
    x = 5
    rng = random.Random(3)
    top = [rng.getrandbits(250) | 1 for _ in range(2)]
    m = [[x * k % bls.R for k in top], top]  # row 0 = x * row 1
    want = jax_fold(m, [x, 3], "row")
    assert fold(m, [x, 3], "row") == want
    assert want[0] == [affine(bls.mul_sub(bls.G1, 2 * x * k % bls.R), bls) for k in top]
    broken = fold(m, [x, 3], "row", ladd=True)
    assert broken[0] != want[0] and broken[1] == want[1]


@pytest.mark.parametrize("bad", [0, 1 << 16])
def test_points_outside_the_small_range_raise(bad):
    C = fq_torch.jac_infinity(4, "cpu").reshape(3, limbs.N_LIMBS, 2, 2)
    with pytest.raises(AssertionError, match="small points"):
        vt.fold_points_batch(C, [1, bad])


def test_warm_folds_caches_the_host_folds(monkeypatch):
    monkeypatch.setenv(dkg.GPU_DKG_ENV, "1")
    m = matrix(2, 9)
    host = dkg.BivarCommitment(points(bls, m))
    warm = dkg.BivarCommitment(points(bls, m))
    with dkg.plane_device("cpu"):
        warm.warm_folds([1, 4, 7], kinds=("row", "col"))
    assert len(warm._fold_cache) == 6
    for i in (1, 4, 7):
        for kind in ("row_commitment", "column_commitment"):
            got, want = getattr(warm, kind)(i), getattr(host, kind)(i)
            assert [affine(p, bls) for p in got] == [affine(p, bls) for p in want]
    assert vt.launches(3, [1, 4, 7]) == 2 * (2 * 3 + 1)
