"""The port's threshold decryption on the CPU: the host copy of the threshold
encryption against the JAX package's, `GpuEngine(device="cpu")`'s
decrypt-share and combine entries (the plain versions of kernel B2's G1
ladders, ops/bls_torch) against the JAX package's CpuEngine, with edge
lanes, and the decrypt round.  The slow tests hold the whole plain G1
ladders limb for limb against fq_T's CPU forms (several minutes of XLA
compile each)."""
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hydrabadger_tpu.crypto import bls12_381 as jbls
from hydrabadger_tpu.crypto import engine as jengine
from hydrabadger_tpu.crypto import threshold as jth
from hydrabadger_tpu.ops import bls_jax as bj
from hydrabadger_tpu.ops import fq_T
from hydrabadger_tpu_torch.crypto import bls12_381 as bls
from hydrabadger_tpu_torch.crypto import engine
from hydrabadger_tpu_torch.crypto import threshold as th
from hydrabadger_tpu_torch.ops import bls_torch, fq_torch as fq, limbs
from hydrabadger_tpu_torch.sim import decrypt
from test_torch_point_block import block_ladder


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run thousands of tiny ops: one thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _affine(pt):
    aff = bls.normalize(pt)
    return None if aff is None else [c.n for c in aff]


def _jaffine(pt):
    aff = jbls.normalize(pt)
    return None if aff is None else [c.n for c in aff]


# a scalar below lambda has a zero k2 half
K2_ZERO = 0xC0FFEE
assert divmod(K2_ZERO, limbs.GLV_LAMBDA)[0] == 0


def _ciphertexts(n):
    """n (port, JAX) ciphertext pairs over U = k*G1, the same in both packages
    (W is unused by decryption)."""
    out = []
    for k in range(3, 3 + n):
        out.append((th.Ciphertext(bls.multiply(bls.G1, k), b"v", bls.G2),
                    jth.Ciphertext(jbls.multiply(jbls.G1, k), b"v", jbls.G2)))
    return out


def test_host_threshold_encryption_equals_the_jax_package():
    """The same key set and rng give the same ciphertext, shares and plaintext."""
    t, msg = 2, b"an epoch's contribution"
    sk_set, jsk_set = th.SecretKeySet.random(t, random.Random(9)), jth.SecretKeySet.random(t, random.Random(9))
    pk_set, jpk_set = sk_set.public_keys(), jsk_set.public_keys()
    ct = pk_set.public_key().encrypt(msg, random.Random(3))
    jct = jpk_set.public_key().encrypt(msg, random.Random(3))
    assert ct.v == jct.v and ct.to_bytes() == jct.to_bytes()
    assert _affine(ct.u) == _jaffine(jct.u)
    shares = {i: sk_set.secret_key_share(i).decrypt_share(ct) for i in (0, 2, 3)}
    jshares = {i: jsk_set.secret_key_share(i).decrypt_share(jct) for i in (0, 2, 3)}
    assert [_affine(s.point) for s in shares.values()] == [_jaffine(s.point) for s in jshares.values()]
    assert pk_set.decrypt(shares, ct) == jpk_set.decrypt(jshares, jct) == msg
    with pytest.raises(ValueError):
        pk_set.decrypt({0: shares[0], 2: shares[2]}, ct)


def test_gpu_engine_decrypt_shares_equal_the_jax_cpu_engine():
    """Edge lanes: scalar 0, r - 1, a zero k2 half, U repeated; the submit
    twin on a batch whose every lane shares one U."""
    cts = _ciphertexts(2)
    scalars = [0, bls.R - 1, K2_ZERO, 0xDEADBEEF << 190, 7]
    which = [0, 0, 0, 1, 1]
    gpu, jcpu = engine.GpuEngine(device="cpu"), jengine.CpuEngine()
    items = [(th.SecretKeyShare(k), cts[w][0]) for k, w in zip(scalars, which)]
    jitems = [(jth.SecretKeyShare(k), cts[w][1]) for k, w in zip(scalars, which)]
    got = gpu.decrypt_share_batch(items)
    want = jcpu.decrypt_share_batch(jitems)
    assert [_affine(s.point) for s in got] == [_jaffine(s.point) for s in want]
    assert _affine(got[0].point) is None

    same = [(th.SecretKeyShare(k), cts[1][0]) for k in (1, K2_ZERO, bls.R - 2)]
    jsame = [(jth.SecretKeyShare(k), cts[1][1]) for k in (1, K2_ZERO, bls.R - 2)]
    pending = gpu.submit_decrypt_share_batch(same)
    assert [_affine(s.point) for s in pending.result()] == \
        [_jaffine(s.point) for s in jcpu.decrypt_share_batch(jsame)]
    assert gpu.decrypt_share_batch([]) == []


def test_gpu_engine_combines_two_quorum_sizes_as_the_jax_cpu_engine():
    """One combine over quorums of 2 (t = 1) and 3 (t = 2): the plaintexts
    equal the JAX CpuEngine's and the messages, and the device tensor holds
    U * master in job order."""
    gpu, jcpu = engine.GpuEngine(device="cpu"), jengine.CpuEngine()
    jobs, jjobs, msgs, masters = [], [], [], []
    for t, ids, seed in ((1, (3, 0), 1), (2, (1, 2, 4), 2), (1, (2, 1), 3)):
        sk_set, jsk_set = th.SecretKeySet.random(t, random.Random(seed)), jth.SecretKeySet.random(t, random.Random(seed))
        pk_set, jpk_set = sk_set.public_keys(), jsk_set.public_keys()
        msg = b"contribution %d" % seed
        ct = pk_set.public_key().encrypt(msg, random.Random(seed + 10))
        jct = jpk_set.public_key().encrypt(msg, random.Random(seed + 10))
        jobs.append((pk_set, {i: sk_set.secret_key_share(i).decrypt_share(ct) for i in ids}, ct))
        jjobs.append((jpk_set, {i: jsk_set.secret_key_share(i).decrypt_share(jct) for i in ids}, jct))
        msgs.append(msg)
        masters.append(bls.mul_sub(ct.u, sk_set.secret_key().scalar))
    out, pending = gpu.dispatch_combine_decryption_shares_batch(jobs)
    assert pending.result() == jcpu.combine_decryption_shares_batch(jjobs) == msgs
    assert out.shape == (3, 12, 3)
    assert [_affine(g) for g in bls_torch.to_host(out)] == [_affine(m) for m in masters]


def test_g1_batch_entries_on_the_cpu_equal_host_multiplies():
    """The host entry points around the two ladders: the products, the
    device tensor beside the finisher, and a two-term weighted sum."""
    pts = [bls.multiply(bls.G1, k) for k in (3, 5)]
    ks = [K2_ZERO, bls.R - 1]
    want = [_affine(bls.multiply(p, k)) for p, k in zip(pts, ks)]
    assert [_affine(p) for p in bls_torch.g1_scalar_mul_batch(pts, ks, device="cpu")] == want
    got = bls_torch.g1_weighted_sum_batch([pts], [[2, 9]], device="cpu")
    assert [_affine(p) for p in got] == [_affine(bls.add(bls.multiply(pts[0], 2),
                                                         bls.multiply(pts[1], 9)))]
    out, finish = bls_torch.g1_scalar_mul_batch_submit([], [], device="cpu")
    assert out.shape == (3, 12, 0) and finish() == []
    assert bls_torch.g1_weighted_sum_batch([], [], device="cpu") == []


def test_decrypt_round_on_the_cpu_recovers_every_contribution():
    cfg = decrypt.DecryptConfig(n_nodes=4, contribution_bytes=16)
    rnd = decrypt.DecryptRound(cfg, device="cpu", seed=1)
    assert rnd.run() == rnd.contributions
    plan = rnd.plan()
    assert bls_torch.launch_counts(plan["share"]) == {"glv_ladder": 1}
    assert bls_torch.launch_counts(plan["combine"]) == {"windowed_ladder": 1, "add": 1}
    assert rnd.last_launches == {"share": 0, "combine": 0}  # the plain versions launch nothing
    assert rnd.shares_limbs.shape == (3, 12, 16) and rnd.combined_limbs.shape == (3, 12, 4)
    assert rnd.oracle_check([0, 6, 15])


def test_interpreted_glv_ladder_equals_the_plain_ladder():
    """Kernel B2's `glv_ladder` as a block runs it (tests/test_torch_point_block)
    against the plain GLV ladder, limb for limb, with a scalar 0, r - 1 and
    one whose k2 half is 0."""
    pts = [bls.multiply(bls.G1, k) for k in (3, 5, 7)]
    p, d = bls_torch.scalar_mul_operands(pts, [0, bls.R - 1, K2_ZERO], "cpu")
    assert torch.equal(block_ladder(1, p, d, glv=True), fq.glv_ladder_plain(p, d))


def test_decrypt_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError):
        decrypt.DecryptRound(decrypt.DecryptConfig(n_nodes=4))
    with pytest.raises(RuntimeError):
        bls_torch.g1_scalar_mul_batch([bls.G1], [1])


# -- the whole plain ladders against fq_T's CPU forms (minutes of XLA compile) ---------


def _ladder_points():
    pts = [bls.multiply(bls.G1, k) for k in (3, 5, 7, 11)]
    jpts = [jbls.multiply(jbls.G1, k) for k in (3, 5, 7, 11)]
    return pts, jpts, [0, bls.R - 1, K2_ZERO, 0xDEADBEEF << 190]


@pytest.mark.slow
@pytest.mark.parametrize("ladder", ["glv", "windowed"])
def test_plain_g1_ladder_equals_fq_T_ladder(ladder):
    """The plain ladders limb for limb against fq_T.glv_ladder_T and
    windowed_ladder_T as they run on the CPU (_use_pallas() false)."""
    assert not fq_T._use_pallas()
    pts, jpts, ks = _ladder_points()
    base = jnp.asarray(bj.points_to_limbs(jpts))  # [4, 3, 32]
    if ladder == "glv":
        p, d = bls_torch.scalar_mul_operands(pts, ks, "cpu")
        got = bls_torch.g1_scalar_mul_glv(p, d)
        w1, w2 = bj.scalars_to_glv_windows(ks)
        want = jax.jit(lambda b, x, y: fq_T.glv_ladder_T(fq_T.from_points_BC(b), x, y,
                                                         jnp.asarray(bj.BETA_COL)))(
            base, jnp.asarray(w1.T), jnp.asarray(w2.T))
    else:
        wins = bls_torch.scalars_to_windows(ks)
        p = torch.from_numpy(limbs.points_to_limbs(pts))
        got = bls_torch.g1_scalar_mul_windowed(p, torch.from_numpy(wins))
        want = jax.jit(lambda b, w: fq_T.windowed_ladder_T(fq_T.from_points_BC(b), w))(
            base, jnp.asarray(bj.scalars_to_windows(ks).T))
    assert np.array_equal(limbs.limbs_to_jax(got.numpy()),
                          np.asarray(fq_T.to_points_BC(want)))
