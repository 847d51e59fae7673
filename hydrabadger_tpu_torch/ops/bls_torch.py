"""Batched BLS12-381 G1 scalar multiplication — threshold decryption.

Counterpart of the G1 batch plane of hydrabadger_tpu/ops/bls_jax.py with
the ladders of its TPU path, ops/fq_T.py.  A decryption share is U * sk_i
over G1 and a combine is a Lagrange-weighted sum of t + 1 shares, so a
threshold-decrypt round is G1 group math, run here on kernel B2
(ops/fq_torch, csrc/fq_point.cu) with no kernel of its own:

    g1_scalar_mul_glv          fq_T.glv_ladder_T in one `glv_ladder` launch:
                               the table T[i] = i*P (14 complete adds), its
                               beta-twisted copy, then 33 windows of 4
                               doublings and two complete adds of the
                               entries T1[k1 digit] and T2[k2 digit]
    g1_weighted_sum_windowed   fq_T.windowed_ladder_T over the [S * B] lanes
                               of B jobs of S terms in one `windowed_ladder`
                               launch (the table, then 64 windows of 4
                               doublings and one complete add), then the
                               pairwise tree of complete adds, one `add`
                               launch per level (5 levels at S = 22)

The adds are the COMPLETE body, as in fq_T: a digit 0 adds the table's
infinity, and an accumulator at infinity takes the table entry itself.
Every lane computes what fq_T's ladder computes, op for op, so the result
equals it limb for limb.

The host entry points take host points: `g1_scalar_mul_dispatch` and
`g1_weighted_sum_dispatch` convert them to limbs (each distinct point
object once), copy the points and the digits to the device once and
return the device result without waiting; `to_host` converts it back
(affine host points).  `g1_scalar_mul_batch_submit` returns the device
result and its finisher, and `g1_scalar_mul_batch` /
`g1_weighted_sum_batch` are the two steps together.  `use_kernel=False`
runs the plain versions on any device; a CPU device always runs them.
bls_jax._pad_mul_batch's lane bucketing is not ported: it exists only to
spare XLA retraces.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..crypto.bls12_381 import R
from ..device import resolve_device
from . import fq_torch as fq
from . import limbs
from .bls_g2_torch import scalars_to_windows, tree_levels, window_needs
from .decrypt_torch import glv_digits
from .roofline import Launch

WINDOW = 4
TABLE_SIZE = 1 << WINDOW

# Montgomery products of a doubling and of the add's general arm (ops/fq_torch)
DBL_PRODUCTS = fq.PRODUCTS["dbl"]
GENERAL_ADD_PRODUCTS = fq.PRODUCTS["ladd"]


def glv_windows(scalars: Sequence[int]) -> np.ndarray:
    """Python ints -> [2, 33, n] int32 GLV digits, MSB first: [0] the k1
    windows, [1] the k2 (beta-twisted) windows of k = k1 + k2 lambda
    (bls_jax.scalars_to_glv_windows, lane axis last)."""
    return np.ascontiguousarray(glv_digits(scalars, WINDOW).transpose(1, 2, 0))


def _entries(use_kernel: bool):
    col = 0 if use_kernel else 1
    return {name: fns[col] for name, fns in fq.ENTRIES.items()}


def g1_scalar_mul_glv(points: torch.Tensor, digits: torch.Tensor,
                      use_kernel: bool = True) -> torch.Tensor:
    """[3, 12, n] points x [2, 33, n] int32 GLV digits (same device) ->
    [3, 12, n] Jacobian products: one `glv_ladder` launch."""
    return _entries(use_kernel)["glv_ladder"](points, digits)


def g1_scalar_mul_windowed(points: torch.Tensor, windows: torch.Tensor,
                           use_kernel: bool = True) -> torch.Tensor:
    """[3, 12, n] points x [64, n] int32 4-bit digits -> [3, 12, n]: one
    `windowed_ladder` launch."""
    return _entries(use_kernel)["windowed_ladder"](points, windows)


def g1_weighted_sum_windowed(points: torch.Tensor, windows: torch.Tensor, terms: int,
                             use_kernel: bool = True) -> torch.Tensor:
    """sum_s coeff[s] * P[s] for each of B jobs.  points [3, 12, S*B] and
    windows [64, S*B] hold term s of job b at lane s*B + b; returns
    [3, 12, B].  Adjacent terms pair up as in bls_jax._reduce_tree, one
    add launch per level."""
    add = _entries(use_kernel)["add"]
    prods = g1_scalar_mul_windowed(points, windows, use_kernel)
    b = prods.shape[-1] // terms
    cols = prods.reshape(3, limbs.N_LIMBS, terms, b)
    while cols.shape[2] > 1:
        k = cols.shape[2]
        half = k // 2
        pair = [cols[:, :, i : 2 * half : 2].reshape(3, limbs.N_LIMBS, half * b) for i in (0, 1)]
        nxt = add(*pair).reshape(3, limbs.N_LIMBS, half, b)
        cols = torch.cat([nxt, cols[:, :, k - 1 :]], 2) if k % 2 else nxt
    return cols[:, :, 0].contiguous()


# ---------------------------------------------------------------------------
# Launch plans: every B2 launch of a ladder and the products its data needs
# ---------------------------------------------------------------------------

# the table: T[2] = P + P by the doubling arm, T[3..15] by the general formula
TABLE_PRODUCTS = DBL_PRODUCTS + (TABLE_SIZE - 3) * GENERAL_ADD_PRODUCTS


def glv_plan(digits: np.ndarray) -> List[Launch]:
    """The launches of g1_scalar_mul_glv over these [2, 33, n] digits: one
    `glv_ladder` (the table, its 16 twist products, and per window the
    doublings of started lanes and the adds whose formula is general)."""
    n = digits.shape[-1]
    general, started = window_needs(np.stack([digits[0], digits[1]], axis=1).reshape(-1, n))
    products = (n * (TABLE_PRODUCTS + TABLE_SIZE) + int(started[::2].sum()) * WINDOW * DBL_PRODUCTS
                + int(general.sum()) * GENERAL_ADD_PRODUCTS)
    return [Launch("glv_ladder", n, products, 6, "ladder", 4 * digits[:, :, 0].size)]


def weighted_sum_plan(windows: np.ndarray, terms: int) -> List[Launch]:
    """The launches of g1_weighted_sum_windowed over these [64, S*B]
    windows: one `windowed_ladder`, then one general add per pair at each
    tree level."""
    lanes = windows.shape[-1]
    general, started = window_needs(windows)
    products = (lanes * TABLE_PRODUCTS + int(started.sum()) * WINDOW * DBL_PRODUCTS
                + int(general.sum()) * GENERAL_ADD_PRODUCTS)
    b = lanes // terms
    return [Launch("windowed_ladder", lanes, products, 6, "ladder", 4 * windows.shape[0])] + [
        Launch("add", half * b, half * b * GENERAL_ADD_PRODUCTS, 9, "tree")
        for half in tree_levels(terms)]


def launch_counts(plan: Sequence[Launch]) -> Dict[str, int]:
    """A plan's launches by entry."""
    return dict(Counter(r.entry for r in plan))


# ---------------------------------------------------------------------------
# Host entry points (crypto/engine.GpuEngine calls g1_scalar_mul_batch_submit
# and g1_weighted_sum_dispatch)
# ---------------------------------------------------------------------------


def to_host(out: torch.Tensor) -> list:
    """[3, 12, n] device limbs -> n affine host points (waits for the device)."""
    return limbs.limbs_to_points(out.cpu().numpy()) if out.shape[-1] else []


def scalar_mul_operands(points: Sequence, scalars: Sequence[int], device="cuda"):
    """n host G1 points x n scalars -> (points [3, 12, n], digits
    [2, 33, n] int32) on the device.  Each distinct point object is
    converted to limbs once (a decrypt round shares each U n times)."""
    dev = resolve_device(device)
    distinct = {id(p): p for p in points}
    col = {key: k for k, key in enumerate(distinct)}
    base = limbs.points_to_limbs(list(distinct.values()))
    pts = torch.from_numpy(np.ascontiguousarray(base[..., [col[id(p)] for p in points]])).to(dev)
    return pts, torch.from_numpy(glv_windows(scalars)).to(dev)


def g1_scalar_mul_dispatch(points: Sequence, scalars: Sequence[int], device="cuda",
                           use_kernel: bool = True) -> torch.Tensor:
    """n host G1 points x n scalars -> the [3, 12, n] products on the
    device, dispatched and not waited for."""
    if not points:
        return torch.empty((3, limbs.N_LIMBS, 0), dtype=torch.int32, device=resolve_device(device))
    pts, digits = scalar_mul_operands(points, scalars, device)
    return g1_scalar_mul_glv(pts, digits, use_kernel)


def g1_scalar_mul_batch_submit(points: Sequence, scalars: Sequence[int], device="cuda",
                               use_kernel: bool = True):
    """Dispatch the batched ladder now, defer the device-to-host copy and
    the affine conversion: returns (the products on the device, not waited
    for; a zero-argument finisher that returns the host points)."""
    out = g1_scalar_mul_dispatch(points, scalars, device, use_kernel)
    return out, lambda: to_host(out)


def g1_scalar_mul_batch(points: Sequence, scalars: Sequence[int], device="cuda",
                        use_kernel: bool = True) -> list:
    """U * sk over G1 for every (U, sk) pair: decryption-share generation
    for a whole batch of (instance, node) pairs at once."""
    return g1_scalar_mul_batch_submit(points, scalars, device, use_kernel)[1]()


def weighted_sum_operands(points_batch: Sequence[Sequence], coeffs_batch: Sequence[Sequence[int]],
                          device="cuda"):
    """[B][S] host G1 points x [B][S] Fr coefficients -> (points
    [3, 12, S*B], windows [64, S*B] int32, S) on the device, term s of job
    b at lane s*B + b."""
    b, s = len(points_batch), len(points_batch[0])
    if any(len(row) != s for row in points_batch) or [len(c) for c in coeffs_batch] != [s] * b:
        raise ValueError("every job needs the same number S of points and coefficients")
    dev = resolve_device(device)
    flat_pts = [points_batch[j][i] for i in range(s) for j in range(b)]
    flat_coeffs = [coeffs_batch[j][i] % R for i in range(s) for j in range(b)]
    pts = torch.from_numpy(limbs.points_to_limbs(flat_pts)).to(dev)
    wins = torch.from_numpy(scalars_to_windows(flat_coeffs)).to(dev)
    return pts, wins, s


def g1_weighted_sum_dispatch(points_batch: Sequence[Sequence], coeffs_batch: Sequence[Sequence[int]],
                             device="cuda", use_kernel: bool = True) -> torch.Tensor:
    """[B][S] host G1 points x [B][S] Fr coefficients -> the B combined
    points [3, 12, B] on the device, dispatched and not waited for."""
    pts, wins, s = weighted_sum_operands(points_batch, coeffs_batch, device)
    return g1_weighted_sum_windowed(pts, wins, s, use_kernel)


def g1_weighted_sum_batch(points_batch: Sequence[Sequence], coeffs_batch: Sequence[Sequence[int]],
                          device="cuda", use_kernel: bool = True) -> list:
    """The ThresholdDecrypt Lagrange combine for B jobs at once: B points."""
    if not points_batch:
        return []
    return to_host(g1_weighted_sum_dispatch(points_batch, coeffs_batch, device, use_kernel))
