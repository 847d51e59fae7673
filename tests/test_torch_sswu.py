"""The port's SSWU hash-to-G2 (crypto/sswu) against the JAX package's on
seeded messages: expand_message_xmd's bytes, hash_to_field, the derived
iso curve and Z, map_to_curve_sswu, iso_map and hash_to_g2_sswu, plus the
structural pins of tests/test_sswu.py on the port's copy."""
import random

import pytest

from hydrabadger_tpu.crypto import bls12_381 as jbls
from hydrabadger_tpu.crypto import sswu as jsswu
from hydrabadger_tpu_torch.crypto import bls12_381 as bls
from hydrabadger_tpu_torch.crypto import sswu
from hydrabadger_tpu_torch.crypto.bls12_381 import FQ2


def _fq2(e) -> tuple:
    return tuple(int(c) for c in e.coeffs)


def _messages(n: int, seed: int) -> list:
    rng = random.Random(seed)
    return [rng.randbytes(rng.randrange(0, 80)) for _ in range(n)]


@pytest.mark.parametrize("n_bytes", [1, 32, 96, 255])
def test_expand_message_xmd_equals_jax(n_bytes):
    for msg in _messages(4, n_bytes):
        for dst in (b"DST", b"HBTPU-G2-SSWU", bytes(range(40))):
            out = sswu.expand_message_xmd(msg, dst, n_bytes)
            assert len(out) == n_bytes and out == jsswu.expand_message_xmd(msg, dst, n_bytes)
    with pytest.raises(ValueError):
        sswu.expand_message_xmd(b"x", b"DST", 256 * 32)


def test_the_derived_iso_curve_and_z_equal_jax():
    iso, jiso = sswu._iso(), jsswu._iso()
    assert set(iso) == set(jiso)
    for key, val in iso.items():
        if key == "velu_map":  # a function: held through iso_map's outputs below
            continue
        assert _fq2(val) == _fq2(jiso[key]), key
    assert _fq2(sswu._z()) == _fq2(jsswu._z())
    assert iso["A2"] != FQ2.zero() and iso["B2_2"] != FQ2.zero()


def test_map_to_curve_and_iso_map_equal_jax():
    for i, msg in enumerate(_messages(6, 11)):
        us = sswu.hash_to_field_fq2(msg, b"SSWU-TEST", 2)
        jus = jsswu.hash_to_field_fq2(msg, b"SSWU-TEST", 2)
        assert [_fq2(u) for u in us] == [_fq2(u) for u in jus]
        for u, ju in zip(us, jus):
            x, y = sswu.map_to_curve_sswu(u)
            jx, jy = jsswu.map_to_curve_sswu(ju)
            assert (_fq2(x), _fq2(y)) == (_fq2(jx), _fq2(jy))
            iso = sswu._iso()
            assert y * y == (x * x + iso["A2"]) * x + iso["B2_2"]
            X, Y = sswu.iso_map(x, y)
            assert (_fq2(X), _fq2(Y)) == tuple(_fq2(c) for c in jsswu.iso_map(jx, jy))
            assert Y * Y == X * X * X + sswu.B2


def test_hash_to_g2_sswu_equals_jax():
    for msg in _messages(3, 7) + [b"", b"msg"]:
        for dst in (b"HBTPU-G2-SSWU", b"DST-2"):
            pt = sswu.hash_to_g2_sswu(msg, dst)
            jpt = jsswu.hash_to_g2_sswu(msg, dst)
            assert bls.g2_to_bytes(pt) == jbls.g2_to_bytes(jpt)
            assert bls.in_g2_subgroup(pt) and not bls.is_inf(pt)
    a = sswu.hash_to_g2_sswu(b"msg", b"DST-1")
    assert not bls.eq(a, sswu.hash_to_g2_sswu(b"msg", b"DST-2"))
    assert not bls.eq(a, sswu.hash_to_g2_sswu(b"msg2", b"DST-1"))
    assert bls.eq(a, sswu.hash_to_g2_sswu(b"msg", b"DST-1"))
