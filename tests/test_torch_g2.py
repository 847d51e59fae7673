"""The port's G2 plane against the JAX package: the FQ2 / G2 / hash /
serialisation host copy against crypto/bls12_381, the G2 limb layout
against bls_g2_jax's, and ops/fq2_torch's plain versions (kernel B4's
entries) and kernel B4's layered point programs (as a block runs them,
tests/test_torch_point_block) against the jitted composed bls_g2_jax ops
limb for limb at B = 4; the plain ladder against the host oracle and the
interpreted kernel ladder (and, slow, against bls_g2_jax's XLA ladder
limb for limb)."""
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hydrabadger_tpu.crypto import bls12_381 as jbls
from hydrabadger_tpu.crypto import threshold as jth
from hydrabadger_tpu.ops import bls_g2_jax as jg2
from hydrabadger_tpu.ops import bls_jax as bj
from hydrabadger_tpu_torch.crypto import bls12_381 as bls
from hydrabadger_tpu_torch.crypto import threshold as th
from hydrabadger_tpu_torch.ops import bls_g2_torch as g2
from hydrabadger_tpu_torch.ops import fq2_torch as f2
from hydrabadger_tpu_torch.ops import limbs
from test_torch_point_block import block_entry, block_ladder, g2_lanes


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run thousands of tiny ops: one thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jitted():
    """The composed bls_g2_jax ops, each compiled once for the module."""
    return {"mul": jax.jit(jg2.fq2_mul), "dbl": jax.jit(jg2.g2_double), "add": jax.jit(jg2.g2_add)}


def _affine(pt):
    aff = bls.normalize(pt)
    return None if aff is None else [c.coeffs for c in aff]


def _jaffine(pt):
    aff = jbls.normalize(pt)
    return None if aff is None else [c.coeffs for c in aff]


@pytest.fixture(scope="module")
def hashed():
    """Three hashed G2 points (host copy), the port's and the JAX package's."""
    docs = [b"coin-0", b"ABA-COINhb/0/7\x00\x00\x00\x01", b""]
    return [bls.hash_to_g2(d) for d in docs], [jbls.hash_to_g2(d) for d in docs]


# -- host copy ---------------------------------------------------------------------


def test_host_g2_copy_equals_the_jax_package(hashed):
    mine, theirs = hashed
    for a, b in zip(mine, theirs):
        assert _affine(a) == _jaffine(b)
        assert bls.g2_to_bytes(a) == jbls.g2_to_bytes(b)
        assert th.Signature(a).parity() == jth.Signature(b).parity()
    for k in (1, 2, 12345, bls.R - 1):
        assert _affine(bls.multiply(bls.G2, k)) == _jaffine(jbls.multiply(jbls.G2, k))
    x = bls.FQ2([3, 5])
    y = jbls.FQ2([3, 5])
    assert (x * x + x).coeffs == (y * y + y).coeffs and x.inv().coeffs == y.inv().coeffs
    assert bls.psi(bls.G2)[0].coeffs == jbls.psi(jbls.G2)[0].coeffs
    p = mine[0]
    assert bls.eq(bls.add(p, bls.neg(p)), bls.infinity(bls.FQ2))
    assert bls.g2_to_bytes(bls.infinity(bls.FQ2)) == jbls.g2_to_bytes(jbls.infinity(jbls.FQ2))
    assert (bls.B2.coeffs, bls.G2[0].coeffs) == (jbls.B2.coeffs, jbls.G2[0].coeffs)


def test_signature_shares_combine_to_the_master_signature():
    sk_set = th.SecretKeySet.random(1, random.Random(3))
    msg = b"round-1"
    shares = {i: sk_set.secret_key_share(i).sign_share(msg) for i in (0, 2)}
    combined = sk_set.public_keys().combine_signatures(shares)
    assert combined == th.Signature(bls.mul_sub(bls.hash_to_g2(msg), sk_set.secret_key().scalar))
    with pytest.raises(ValueError):
        sk_set.public_keys().combine_signatures({0: shares[0]})


# -- layout ------------------------------------------------------------------------


def test_g2_limb_layout_round_trips_and_matches_bls_g2_jax(hashed):
    mine, theirs = hashed
    pts = mine + [bls.double(mine[0]), bls.infinity(bls.FQ2)]
    jpts = theirs + [jbls.double(theirs[0]), jbls.infinity(jbls.FQ2)]
    jax_limbs = jg2.g2_points_to_limbs(jpts)  # [5, 3, 2, 32]
    port = limbs.g2_points_to_limbs(pts)  # [3, 2, 12, 5]
    assert port.shape == (3, 2, 12, 5) and port.dtype == np.int32
    assert np.array_equal(limbs.g2_limbs_from_jax(jax_limbs), port)
    assert np.array_equal(limbs.g2_limbs_to_jax(port), jax_limbs)
    assert np.array_equal(limbs.g2_limbs_to_jax(port[..., :4], (2, 2)), jax_limbs[:4].reshape(2, 2, 3, 2, 32))
    back = limbs.limbs_to_g2_points(port)
    assert all(bls.eq(a, b) for a, b in zip(back, pts))
    assert bls.is_inf(back[-1]) and back[0][2] == bls.FQ2.one()
    inf = f2.g2_infinity(1, "cpu").numpy()
    assert np.array_equal(inf[..., 0], port[..., 4])


def test_scalars_to_windows_matches_bls_jax():
    ks = [0, 1, bls.R - 1, 0xFEDCBA9876543210 << 130, (1 << 256) - 1]
    assert np.array_equal(g2.scalars_to_windows(ks), bj.scalars_to_windows(ks).T)


# -- B4 plain versions against bls_g2_jax ---------------------------------------------


@pytest.fixture(scope="module")
def lanes(hashed):
    """Two non-normalised [3, 2, 12, 4] batches whose lanes are P + P,
    P + (-P), infinity + Q and P + infinity."""
    h = hashed[0]
    a = [h[0], h[1], bls.infinity(bls.FQ2), h[2]]
    b = [h[0], bls.neg(h[1]), h[2], bls.infinity(bls.FQ2)]
    p1 = f2.g2_double_plain(torch.from_numpy(limbs.g2_points_to_limbs(a)))
    p2 = f2.g2_double_plain(torch.from_numpy(limbs.g2_points_to_limbs(b)))
    return p1, p2


def _jax(x: torch.Tensor):
    return jnp.asarray(limbs.g2_limbs_to_jax(x.numpy()))


def _from_jax(y) -> torch.Tensor:
    return torch.from_numpy(limbs.g2_limbs_from_jax(np.asarray(y)))


def test_fq2_mul_plain_equals_jax(jitted, lanes):
    a, b = lanes[0][1], lanes[1][2]  # [2, 12, 4] Fp2 batches (y of p1, z of p2)
    got = f2.fq2_mul_plain(a, b)
    ja = jnp.asarray(limbs.g2_limbs_to_jax(torch.stack([a, a, a]).numpy())[:, 0])  # [4, 2, 32]
    jb = jnp.asarray(limbs.g2_limbs_to_jax(torch.stack([b, b, b]).numpy())[:, 0])
    want = np.asarray(jitted["mul"](ja, jb))
    assert np.array_equal(limbs.words_from_jax_limbs(want).transpose(1, 2, 0), got.numpy())


def test_fq2_complex_square_equals_jax_product_with_itself(jitted, lanes):
    """The double and the add square by (a0 + a1)(a0 - a1), 2 a0 a1: the
    same canonical limbs as JAX's Karatsuba fq2_mul(a, a)."""
    a = lanes[0][1]
    got = f2._fe2_w(f2.fq2_sqr_h(f2._fe2_h(a)), a.shape[-1])
    assert torch.equal(got, f2.fq2_mul_plain(a, a))
    ja = jnp.asarray(limbs.g2_limbs_to_jax(torch.stack([a, a, a]).numpy())[:, 0])
    want = np.asarray(jitted["mul"](ja, ja))
    assert np.array_equal(limbs.words_from_jax_limbs(want).transpose(1, 2, 0), got.numpy())


def test_g2_double_plain_equals_jax(jitted, lanes):
    p1 = lanes[0]
    assert torch.equal(f2.g2_double_plain(p1), _from_jax(jitted["dbl"](_jax(p1))))


def test_g2_add_plain_equals_jax_with_edge_lanes(jitted, lanes):
    p1, p2 = lanes
    got = f2.g2_add_plain(p1, p2)
    assert torch.equal(got, _from_jax(jitted["add"](_jax(p1), _jax(p2))))
    pts = limbs.limbs_to_g2_points(got.numpy())
    q1, q2 = limbs.limbs_to_g2_points(p1.numpy()), limbs.limbs_to_g2_points(p2.numpy())
    assert bls.eq(pts[0], bls.double(q1[0]))  # P + P
    assert bls.is_inf(pts[1])  # P + (-P)
    assert torch.equal(got[..., 2], p2[..., 2]) and torch.equal(got[..., 3], p1[..., 3])  # infinity


def test_window_step_plain_equals_jax_with_edge_lanes(jitted, lanes):
    """One step against JAX's composed window (4 doubles, select, add):
    acc == sel, acc == -sel, digit 0, and acc at infinity with digit 0
    (a scalar-0 lane)."""
    p1 = lanes[0]
    acc = p1.clone()
    acc[..., 3] = f2.g2_infinity(1, "cpu")[..., 0]
    a16 = acc
    for _ in range(4):
        a16 = f2.g2_double_plain(a16)
    base = p1.clone()
    base[..., 0] = a16[..., 0]  # table[1] == 16 acc
    base[..., 1] = f2.g2_neg(a16[..., 1:2])[..., 0]  # table[1] == -16 acc
    table = f2.g2_table_plain(base)
    digits = torch.tensor([1, 1, 0, 0], dtype=torch.int32)
    got = f2.g2_window_step_plain(acc, table, digits)
    j = _jax(acc)
    for _ in range(4):
        j = jitted["dbl"](j)
    sel = torch.stack([table[int(d), ..., i] for i, d in enumerate(digits)], -1)
    assert torch.equal(got, _from_jax(jitted["add"](j, _jax(sel))))
    pts = limbs.limbs_to_g2_points(got.numpy())
    sel_pts = limbs.limbs_to_g2_points(sel.numpy())
    a16_pts = limbs.limbs_to_g2_points(a16.numpy())
    assert bls.eq(sel_pts[0], a16_pts[0]) and bls.eq(sel_pts[1], bls.neg(a16_pts[1]))
    assert bls.eq(pts[0], bls.multiply(limbs.limbs_to_g2_points(acc[..., :1].numpy())[0], 32))
    assert bls.is_inf(pts[1]) and bls.is_inf(pts[3])
    assert torch.equal(got[..., 2], a16[..., 2])  # digit 0: table[0] is infinity


def test_table_entries_equal_host_multiples(hashed):
    pts = [hashed[0][0], bls.double(hashed[0][1]), bls.infinity(bls.FQ2)]
    table = f2.g2_table_plain(torch.from_numpy(limbs.g2_points_to_limbs(pts)))
    assert table.shape == (16, 3, 2, 12, 3)
    for i in range(16):
        got = limbs.limbs_to_g2_points(table[i].numpy())
        assert all(bls.eq(g, bls.multiply(p, i)) for g, p in zip(got, pts)), i


@pytest.fixture(scope="module")
def plain_ladder():
    """Four host points, their scalars and the plain ladder's [3, 2, 12, 4]
    products through the host entry (one plain ladder for the module)."""
    h = bls.hash_to_g2(b"coin")
    ks = [0, 1, bls.R - 1, random.Random(0).randrange(bls.R)]
    pts = [h, bls.double(h), h, bls.G2]
    return pts, ks, g2.g2_scalar_mul_dispatch(pts, ks, device="cpu")


def test_plain_ladder_equals_the_host(plain_ladder):
    pts, ks, products = plain_ladder
    out = g2.to_host(products)
    for p, k, o in zip(pts, ks, out):
        assert bls.eq(o, bls.mul_sub(p, k))
    assert bls.is_inf(out[0]) and bls.eq(out[2], bls.neg(pts[0]))


def test_interpreted_ladder_equals_the_plain_ladder(plain_ladder):
    """Kernel B4's `ladder` as a block runs it (tests/test_torch_point_block)
    against the plain ladder, limb for limb."""
    pts, ks, products = plain_ladder
    points = torch.from_numpy(limbs.g2_points_to_limbs(pts))
    windows = torch.from_numpy(g2.scalars_to_windows(ks))
    assert torch.equal(block_ladder(2, points, windows), products)


def test_point_programs_equal_jax_g2_ops(jitted, lanes):
    """Kernel B4's layered double, four doublings and complete add (the
    programs of ops/point_block, as a block runs them) against the jitted
    bls_g2_jax ops, limb for limb: the edge lanes, and lanes of raw
    coordinates p - 1 and 0."""
    raw1, raw2 = g2_lanes()
    for p1, p2 in (lanes, (raw1[..., 3:], raw2[..., 3:])):
        assert torch.equal(block_entry(2, "add", p1, p2), _from_jax(jitted["add"](_jax(p1), _jax(p2))))
        j = _jax(p1)
        assert torch.equal(block_entry(2, "dbl", p1, k=1), _from_jax(jitted["dbl"](j)))
        for _ in range(4):
            j = jitted["dbl"](j)
        assert torch.equal(block_entry(2, "dblk", p1, k=4), _from_jax(j))


@pytest.mark.slow
def test_plain_ladder_equals_the_jax_xla_ladder(hashed):
    pts = hashed[1][:2]
    ks = [bls.R - 1, 0xC0FFEE << 200]
    jp = jnp.asarray(jg2.g2_points_to_limbs(pts))
    jw = jnp.asarray(bj.scalars_to_windows(ks))
    want = _from_jax(jg2._g2_scalar_mul_windowed_xla(jp, jw))
    mine = torch.from_numpy(limbs.g2_points_to_limbs(hashed[0][:2]))
    got = g2.g2_scalar_mul_windowed(mine, torch.from_numpy(g2.scalars_to_windows(ks)))
    assert torch.equal(got, want)
