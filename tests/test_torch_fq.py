"""The port's host copies, limb layout and B2 plain versions against the JAX
package: crypto/bls12_381 and crypto/threshold on sampled scalars and a
key set, the 12-bit <-> 32-bit limb regrouping, and ops/fq_torch's point
bodies and kernel B2's layered point programs (as a block runs them,
tests/test_torch_point_block) against ops/fq_T limb for limb at B = 4."""
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hydrabadger_tpu.crypto import bls12_381 as jbls
from hydrabadger_tpu.crypto import threshold as jth
from hydrabadger_tpu.ops import bls_jax as bj
from hydrabadger_tpu.ops import fq_T
from hydrabadger_tpu_torch.crypto import bls12_381 as bls
from hydrabadger_tpu_torch.crypto import threshold as th
from hydrabadger_tpu_torch.ops import fq_torch as fq
from hydrabadger_tpu_torch.ops import limbs
from test_torch_point_block import block_entry, g1_lanes


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run thousands of tiny ops: one thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jitted_fq_T():
    """fq_T's CPU entry points call their bodies op by op; jit each body
    once so the whole module compiles four graphs."""
    mp = pytest.MonkeyPatch()
    for name in ("_jac_double_body", "_jac_add_body", "_jac_add_ladder_body"):
        mp.setattr(fq_T, name, jax.jit(getattr(fq_T, name)))
    yield jax.jit(fq_T.fq_mul_T)
    mp.undo()


def _scalars(seed, n, bits):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(bits // 8), "little") for _ in range(n)]


# -- host copies ---------------------------------------------------------------


def test_host_bls_copy_equals_the_jax_package():
    for k in _scalars(1, 3, 64) + [1, 2, bls.R - 1]:
        mine, theirs = bls.multiply(bls.G1, k), jbls.multiply(jbls.G1, k)
        assert bls.normalize(mine) is not None
        assert [c.n for c in bls.normalize(mine)] == [c.n for c in jbls.normalize(theirs)]
        assert [c.n for c in bls.normalize(bls.mul_sub(bls.G1, k))] == [
            c.n for c in jbls.normalize(jbls.mul_sub(jbls.G1, k))
        ]
    p, q = bls.multiply(bls.G1, 5), bls.multiply(bls.G1, 7)
    assert bls.eq(bls.add(p, q), bls.multiply(bls.G1, 12))
    assert bls.eq(bls.add(p, p), bls.multiply(bls.G1, 10))
    assert bls.eq(bls.add(p, bls.neg(p)), bls.infinity())
    assert bls.eq(bls.add(bls.infinity(), q), q) and bls.normalize(bls.infinity()) is None
    assert (bls.P, bls.R, bls.X_PARAM) == (jbls.P, jbls.R, jbls.X_PARAM)


def test_key_set_for_a_seed_equals_the_jax_package():
    mine = th.SecretKeySet.random(5, random.Random(11))
    theirs = jth.SecretKeySet.random(5, random.Random(11))
    assert mine.coeffs == theirs.coeffs and mine.threshold == theirs.threshold == 5
    assert mine.secret_key().scalar == theirs.secret_key().scalar
    assert [mine.secret_key_share(i).scalar for i in range(8)] == [
        theirs.secret_key_share(i).scalar for i in range(8)
    ]
    xs = [1, 2, 4, 7]
    assert th.lagrange_coeffs_at_zero(xs) == jth.lagrange_coeffs_at_zero(xs)
    pts = {x: bls.multiply(bls.G1, 3 * x + 1) for x in xs}
    jpts = {x: jbls.multiply(jbls.G1, 3 * x + 1) for x in xs}
    got = bls.normalize(th.interpolate_g_at_zero(pts))
    want = jbls.normalize(jth.interpolate_g_at_zero(jpts))
    assert [c.n for c in got] == [c.n for c in want]


# -- layout ----------------------------------------------------------------------


def test_limb_layout_round_trips_and_matches_bls_jax():
    pts = [bls.multiply(bls.G1, k) for k in (3, 1 << 40, 12345)] + [bls.infinity()]
    jpts = [jbls.multiply(jbls.G1, k) for k in (3, 1 << 40, 12345)] + [jbls.infinity(jbls.FQ)]
    jax_limbs = bj.points_to_limbs(jpts)  # [4, 3, 32]
    port = limbs.points_to_limbs(pts)  # [3, 12, 4]
    assert np.array_equal(limbs.limbs_from_jax(jax_limbs), port)
    assert np.array_equal(limbs.limbs_to_jax(port), jax_limbs)
    back = limbs.limbs_to_points(port)
    assert all(bls.eq(a, b) for a, b in zip(back, pts))
    rng = np.random.default_rng(2)
    words = rng.integers(-(2**31), 2**31, (5, 2, 12)).astype(np.int32)
    assert np.array_equal(limbs.words_from_jax_limbs(limbs.jax_limbs_from_words(words)), words)
    assert np.array_equal(limbs.int_to_limbs(bls.P), limbs.P_LIMBS)
    assert limbs.limbs_to_ints_batch(limbs.ONE_MONT[None]) == [limbs.R_MONT % bls.P]
    assert np.array_equal(limbs.words_from_jax_limbs(bj.BETA_MONT), limbs.BETA_MONT)
    assert limbs.GLV_LAMBDA == bj.GLV_LAMBDA and limbs.GLV_BETA == bj.GLV_BETA


# -- B2 plain versions against fq_T ---------------------------------------------------


@pytest.fixture(scope="module")
def lanes():
    """Two [3, 12, 4] point batches whose lanes are P + (-P), P + P,
    infinity + Q and P + infinity, in non-normalised Jacobian form."""
    a = [bls.multiply(bls.G1, k) for k in (11, 13, 17, 19)]
    b = [bls.neg(a[0]), a[1], bls.multiply(bls.G1, 23), bls.infinity()]
    a[2] = bls.infinity()
    p1 = fq.jac_double_plain(torch.from_numpy(limbs.points_to_limbs(a)))
    p2 = fq.jac_double_plain(torch.from_numpy(limbs.points_to_limbs(b)))
    return p1, p2


def _to_T(pt: torch.Tensor):
    """Port [3, 12, B] -> the fq_T (x, y, z) tuple of [32, B]."""
    j = limbs.limbs_to_jax(pt.numpy())  # [B, 3, 32]
    return tuple(jnp.asarray(np.ascontiguousarray(j[:, c].T)) for c in range(3))


def _from_T(tup) -> np.ndarray:
    j = np.stack([np.asarray(c).T for c in tup], axis=1)  # [B, 3, 32]
    return limbs.limbs_from_jax(j)


def test_fq_mul_add_sub_plain_equal_fq_T(jitted_fq_T, lanes):
    p1, p2 = lanes
    a, b = p1[0], p2[1]
    got = fq.fq_mul(a, b)  # a CPU tensor: the plain version
    want = jitted_fq_T(_to_T(p1)[0], _to_T(p2)[1])
    assert np.array_equal(got.numpy(), _from_T((want, want, want))[0])
    ai, bi = (limbs.limbs_to_ints_batch(x.numpy().T) for x in (a, b))
    p = bls.P
    assert limbs.limbs_to_ints_batch(fq.fq_add(a, b).numpy().T) == [(x + y) % p for x, y in zip(ai, bi)]
    assert limbs.limbs_to_ints_batch(fq.fq_sub(a, b).numpy().T) == [(x - y) % p for x, y in zip(ai, bi)]
    rinv = pow(limbs.R_MONT, -1, p)
    assert limbs.limbs_to_ints_batch(got.numpy().T) == [x * y * rinv % p for x, y in zip(ai, bi)]


def test_fq_mul_by_one_element_equals_the_full_operand(lanes, monkeypatch):
    p1, p2 = lanes
    a, c = p1[0], p2[1][:, 2:3]  # c: one element for every lane
    want = fq.fq_mul(a, c.expand(a.shape).contiguous())
    assert torch.equal(fq.fq_mul(a, c), want)
    monkeypatch.setattr(fq, "_CHUNK", 3)  # the chunked product broadcasts too
    assert torch.equal(fq.fq_mul(a, c), want)


@pytest.mark.parametrize("body", ["dbl", "add", "ladd", "dblk2", "win1"])
def test_point_bodies_plain_equal_fq_T(jitted_fq_T, lanes, body):
    p1, p2 = lanes
    t1, t2 = _to_T(p1), _to_T(p2)
    if body == "dbl":
        got, want = fq.jac_double(p1), fq_T.jac_double_T(t1)
    elif body == "add":
        got, want = fq.jac_add(p1, p2), fq_T.jac_add_T(t1, t2)
    elif body == "ladd":
        got, want = fq.jac_add_ladder(p1, p2), fq_T.jac_add_ladder_T(t1, t2)
    elif body == "dblk2":
        got, want = fq.jac_double_k(p1, 2), fq_T.jac_double_k_T(t1, 2)
    else:
        got, want = fq.window_step(p1, p2, p1, 1), fq_T.window_step_T(t1, t2, t1, 1)
    assert np.array_equal(got.numpy(), _from_T(want))


def test_point_programs_equal_fq_T_bodies(jitted_fq_T, lanes):
    """Kernel B2's layered double, complete and ladder adds and window (the
    programs of ops/point_block, as a block runs them) against fq_T's
    bodies limb for limb: the edge lanes, and lanes of raw coordinates
    p - 1 and 0."""
    raw1, raw2 = g1_lanes()
    for p1, p2 in (lanes, (raw1[..., 4:], raw2[..., 4:])):
        t1, t2 = _to_T(p1), _to_T(p2)
        cases = [("dbl", dict(k=1), fq_T.jac_double_T(t1)),
                 ("dblk", dict(k=2), fq_T.jac_double_k_T(t1, 2)),
                 ("add", dict(b=p2), fq_T.jac_add_T(t1, t2)),
                 ("ladd", dict(b=p2), fq_T.jac_add_ladder_T(t1, t2)),
                 ("win", dict(b=p2, third=p1, k=1), fq_T.window_step_T(t1, t2, t1, 1))]
        for entry, kw, want in cases:
            assert np.array_equal(block_entry(1, entry, p1, **kw).numpy(), _from_T(want)), entry


def test_complete_add_cases_against_the_host_oracle(lanes):
    p1, p2 = lanes
    got = limbs.limbs_to_points(fq.jac_add(p1, p2).numpy())
    a = limbs.limbs_to_points(p1.numpy())
    b = limbs.limbs_to_points(p2.numpy())
    for g, x, y in zip(got, a, b):
        assert bls.eq(g, bls.add(x, y))
    assert bls.is_inf(got[0])  # P + (-P)
    assert fq.products("win6") == 74 and fq.products("dblk4") == 28 and fq.products("add") == 23


def test_wrappers_check_their_operands():
    with pytest.raises(TypeError):
        fq.jac_double(torch.zeros((3, 12, 4), dtype=torch.int64))
    with pytest.raises(ValueError):
        fq.jac_add(torch.zeros((3, 11, 4), dtype=torch.int32), torch.zeros((3, 11, 4), dtype=torch.int32))
    inf = fq.jac_infinity(3, "cpu")
    assert inf.shape == (3, 12, 3) and not inf[2].any()
    assert limbs.limbs_to_ints_batch(inf[0].T.numpy()) == [limbs.R_MONT % bls.P] * 3
