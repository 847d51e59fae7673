"""Batched independent G1 multi-scalar multiplications: the DKG's MSM plane.

Counterpart of hydrabadger_tpu/ops/msm_T.py.  The era switch's
verifications are many small independent MSMs: every part carries a
row check sum_k r_k E[k] over t + 1 commitment points with 64-bit random
scalars (crypto/dkg `_rlc_scalars`), and every complete proposal settles
its stored ack values with one column check sum_j w_j col[j] + (-lhs) G1
over full-width weights.  A batch of B such jobs runs on kernel B2
(ops/fq_torch, csrc/fq_point.cu) with no kernel of its own:

    lanes        (job, term), job-major: term i of job b at lane b*S + i,
                 every job padded to the batch's widest job S with
                 (infinity, 0) lanes, both identities of the ladder
    ladder       every scalar <= 128 bits (the RLC scalars): one
                 `windowed_ladder` launch over ceil(bits / 4) MSB-first
                 4-bit windows (msm_T's _msm_windowed_T); otherwise one
                 `glv_ladder` launch over the GLV split (_msm_glv_T)
    tree         each job's S products through a pairwise tree of B2's
                 complete `add`: the first half of the terms plus the
                 second half, an odd tail carried up a level, one launch
                 per level (msm_T's _reduce_jobs_T)
    affine       one batched inversion on the host (`limbs.limbs_to_points`)

Every add is the complete body (the doubling arm and the infinity masks):
the points are attacker-chosen commitment points, and an identity point
or a zero scalar is an ordinary lane.  msm_T's shape buckets (`_bucket`)
are not ported: they exist only to bound XLA's compile cache, and the
port has none.  The results are points equal to the host sum
(crypto/dkg `g1_msm_or_fallback`), pinned by tests/test_torch_msm.py.

`use_kernel=False` runs the same steps on the plain versions on any
device; a CPU device always runs them.  A failure on the card raises.
`calls` counts the batches by (B, S, digit rows: w windows, or 33 for the
GLV ladder); chip_smoke reads it to replay a run's shapes.
"""
from __future__ import annotations

from collections import Counter
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..crypto import bls12_381 as bls
from ..device import resolve_device
from ..obs import metrics as M
from . import fq_torch as fq
from . import limbs
from .bls_g2_torch import scalars_to_windows
from .bls_torch import glv_windows

# scalars this wide or narrower take the single-table windowed ladder
# (msm_T._SHORT_BITS); wider ones the GLV ladder
SHORT_BITS = 128

Job = Tuple[Sequence, Sequence[int]]

calls: Counter = Counter()


def pack_jobs(jobs: Sequence[Job]) -> Tuple[List, List[int], int, int]:
    """Jobs -> (flat points, flat scalars mod r, B, S): each job padded to
    S = the widest job's length (at least 1) with (infinity, 0) lanes.
    Raises ValueError where a job's points and scalars differ in length."""
    b = len(jobs)
    s = max(1, max(len(pts) for pts, _ks in jobs))
    inf = bls.infinity(bls.FQ)
    flat_pts: List = []
    flat_ks: List[int] = []
    for pts, ks in jobs:
        if len(pts) != len(ks):
            raise ValueError("points/scalars length mismatch")
        pad = s - len(pts)
        flat_pts.extend(list(pts) + [inf] * pad)
        flat_ks.extend([int(k) % bls.R for k in ks] + [0] * pad)
    return flat_pts, flat_ks, b, s


def short_windows(scalars: Sequence[int], n_win: int) -> np.ndarray:
    """Scalars below 2^(4 n_win) -> [n_win, n] int32 4-bit digits, MSB first."""
    return np.ascontiguousarray(scalars_to_windows(scalars)[64 - n_win:])


def operands(jobs: Sequence[Job], device="cuda"):
    """Jobs -> (points [3, 12, B*S], digits, B, S) on the device: digits
    [w, B*S] 4-bit windows for the windowed ladder, or [2, 33, B*S] GLV
    digits where a scalar is wider than SHORT_BITS."""
    dev = resolve_device(device)
    flat_pts, flat_ks, b, s = pack_jobs(jobs)
    pts = torch.from_numpy(limbs.points_to_limbs(flat_pts)).to(dev)
    max_bits = max([k.bit_length() for k in flat_ks] + [1])
    if max_bits <= SHORT_BITS:
        digits = short_windows(flat_ks, -(-max_bits // 4))
    else:
        digits = glv_windows(flat_ks)
    return pts, torch.from_numpy(digits).to(dev), b, s


def reduce_jobs(acc: torch.Tensor, b: int, s: int, use_kernel: bool = True) -> torch.Tensor:
    """[3, 12, B*S] job-major products -> [3, 12, B] per-job sums: each
    level adds the first half of every job's terms to its second half in
    one complete `add` over B * (S // 2) lanes, an odd tail carried."""
    add = fq.ENTRIES["add"][0 if use_kernel else 1]
    cols = acc.reshape(3, limbs.N_LIMBS, b, s)
    while s > 1:
        h = s // 2
        left = cols[..., :h].reshape(3, limbs.N_LIMBS, b * h)
        right = cols[..., h : 2 * h].reshape(3, limbs.N_LIMBS, b * h)
        merged = add(left, right).reshape(3, limbs.N_LIMBS, b, h)
        cols = torch.cat([merged, cols[..., 2 * h :]], -1) if s % 2 else merged
        s = cols.shape[-1]
    return cols[..., 0].contiguous()


def msm(points: torch.Tensor, digits: torch.Tensor, b: int, s: int,
        use_kernel: bool = True) -> torch.Tensor:
    """The batch on the device: one ladder launch over the B*S lanes (the
    windowed ladder for [w, n] digits, the GLV ladder for [2, 33, n]),
    then the tree -> [3, 12, B] Jacobian sums."""
    col = 0 if use_kernel else 1
    entry = "glv_ladder" if digits.dim() == 3 else "windowed_ladder"
    calls[(b, s, digits.shape[-2])] += 1
    return reduce_jobs(fq.ENTRIES[entry][col](points, digits), b, s, use_kernel)


def launches(b: int, s: int) -> int:
    """B2 launches of one batch: the ladder and one add per tree level."""
    n = 1
    while s > 1:
        n, s = n + 1, s - s // 2
    return n


def g1_msm_batch_submit(jobs: Sequence[Job], device="cuda", use_kernel: bool = True):
    """Launch B independent MSMs now and defer the host step: returns a
    zero-argument finisher that copies the sums back and converts them to
    affine host points (one per job)."""
    if not jobs:
        return lambda: []
    pts, digits, b, s = operands(jobs, device)
    real = sum(len(p) for p, _ks in jobs)
    reg = M.default_registry()
    reg.gauge(M.MSM_BATCH_LANES).track(b * s)
    reg.counter(M.MSM_PAD_LANES).inc(b * s - real)
    reg.counter(M.MSM_REAL_LANES).inc(real)
    out = msm(pts, digits, b, s, use_kernel)
    return lambda: limbs.limbs_to_points(out.cpu().numpy())


def g1_msm_batch(jobs: Sequence[Job], device="cuda", use_kernel: bool = True) -> List:
    """sum_i ks[i] * pts[i] for every (pts, ks) job: host points and ints
    in, one affine host point per job out."""
    return g1_msm_batch_submit(jobs, device, use_kernel)()
