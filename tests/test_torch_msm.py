"""The port's batched MSM plane (ops/msm_torch, the plain versions of
kernel B2 on the CPU) against the JAX package's host MSM,
`crypto.dkg.g1_msm_or_fallback` (the oracle ops/msm_T is pinned to): the
tier-1 cases of tests/test_msm_T.py (ragged random jobs with a pinned
64-bit top scalar, identity points and zero scalars, a batch of one and an
empty job, an empty batch and a length mismatch that raises) and one job
of full-width scalars, which takes the GLV ladder.  Points compare affine.
"""
import random

import pytest
import torch

from hydrabadger_tpu.crypto import bls12_381 as jbls
from hydrabadger_tpu.crypto.dkg import g1_msm_or_fallback
from hydrabadger_tpu_torch.crypto import bls12_381 as bls
from hydrabadger_tpu_torch.crypto import engine
from hydrabadger_tpu_torch.ops import msm_torch

# a 64-bit scalar with the top bit pinned (tests/test_msm_T.py)
TOP64 = (1 << 63) | 0x5DEECE66D


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


def affine(pt, mod):
    return None if mod.is_inf(pt) else tuple(c.n for c in mod.normalize(pt)[:2])


def check(jobs):
    """jobs as (scalars of G1 for the points, scalars): both packages'
    points made from the same ints."""
    ours = msm_torch.g1_msm_batch(
        [([bls.infinity(bls.FQ) if k is None else bls.mul_sub(bls.G1, k) for k in pk], ks)
         for pk, ks in jobs], device="cpu")
    theirs = [g1_msm_or_fallback(
        [jbls.infinity(jbls.FQ) if k is None else jbls.mul_sub(jbls.G1, k) for k in pk], ks)
        for pk, ks in jobs]
    assert len(ours) == len(jobs)
    assert [affine(p, bls) for p in ours] == [affine(p, jbls) for p in theirs]
    return ours


def test_random_jobs_match_the_jax_host_msm():
    rng = random.Random(42)
    jobs = []
    for size in (4, 3, 2, 1):
        jobs.append(([rng.getrandbits(200) | 1 for _ in range(size)],
                     [rng.getrandbits(64) | 1 for _ in range(size)]))
    jobs[0][1][0] = TOP64
    check(jobs)


def test_identity_points_and_zero_scalars():
    jobs = [([None, 7, None, 9], [TOP64, 5, 3, 0]), ([None], [TOP64]), ([11, 12], [0, 0])]
    out = check(jobs)
    assert bls.is_inf(out[1]) and bls.is_inf(out[2])


def test_batch_of_one_and_a_ragged_empty_job():
    check([([3, 4, 5, 6], [TOP64, 2, 3, 4])])
    out = check([([], []), ([2, 3, 4, 5], [TOP64, 1, 2, 3])])
    assert bls.is_inf(out[0])


def test_empty_batch_and_length_mismatch():
    assert msm_torch.g1_msm_batch([], device="cpu") == []
    with pytest.raises(ValueError, match="mismatch"):
        msm_torch.g1_msm_batch([([bls.G1], [1, 2])], device="cpu")


def test_full_width_scalars_take_the_glv_ladder():
    rng = random.Random(7)
    jobs = [([2, 3, 4], [rng.getrandbits(255) % bls.R for _ in range(3)]), ([9], [bls.R - 1])]
    _pts, digits, b, s = msm_torch.operands(
        [([bls.G1] * len(ks), ks) for _pk, ks in jobs], "cpu")
    assert digits.shape == (2, 33, b * s) and (b, s) == (2, 3)
    check(jobs)


def test_lane_layout_and_launch_count():
    """Jobs padded job-major to the widest; windows for the widest scalar;
    one ladder and one add launch per tree level."""
    jobs = [([bls.G1] * 6, [TOP64] + [1] * 5), ([bls.G1], [3])]
    pts, digits, b, s = msm_torch.operands(jobs, "cpu")
    assert (b, s) == (2, 6) and pts.shape == (3, 12, 12) and digits.shape == (16, 12)
    assert int(pts[2, :, 7:].abs().sum()) == 0  # job 1's padding lanes: z = 0
    assert [msm_torch.launches(1, s) for s in (1, 2, 3, 6, 16, 17)] == [1, 2, 3, 4, 5, 6]


def test_gpu_engine_on_the_cpu_equals_the_host_engine():
    g = [bls.mul_sub(bls.G1, k) for k in (5, 6, 7)]
    jobs = [(g, [TOP64, 2, 3]), (g[:1], [4])]
    host = engine.get_engine("cpu").g1_msm_batch(jobs)
    gpu = engine.GpuEngine(device="cpu").g1_msm_batch(jobs)
    assert [affine(p, bls) for p in gpu] == [affine(p, bls) for p in host]
    assert engine.GpuEngine(device="cpu").submit_g1_msm_batch([]).result() == []
