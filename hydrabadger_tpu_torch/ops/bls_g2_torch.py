"""Batched BLS12-381 G2 scalar multiplication — threshold signatures and the coin.

Counterpart of hydrabadger_tpu/ops/bls_g2_jax.py.  Signatures live in G2
(`sign` is sk * hash_to_g2(msg)), so a coin round's work is G2 group
math: a signature share per (node, instance) and a Lagrange combine per
instance.  Both run here as one fixed-window (w = 4) ladder over all
lanes on kernel B4 (ops/fq2_torch, csrc/fq2_point.cu):

    g2_scalar_mul_windowed     one `ladder` launch: the table and 64 windows
    g2_weighted_sum_windowed   one ladder over the [S * B] lanes of B jobs
                               of S terms each, then the pairwise tree of
                               complete adds, one `add` launch per level over
                               all B jobs (5 levels at S = 22)

`scalar_mul_plan` and `weighted_sum_plan` list those launches with the
Montgomery products the digits need (ops/roofline.Launch).

The host entry points take host points: `g2_scalar_mul_dispatch` and
`g2_weighted_sum_dispatch` convert them to limbs, copy the points and the
digits to the device once and return the device result without waiting;
`to_host` converts it back (affine host points).
`g2_scalar_mul_batch_submit` returns the device result and its finisher,
and `g2_scalar_mul_batch` / `g2_weighted_sum_batch` are the two steps
together.  `use_kernel=False` runs the plain versions on any
device; a CPU device always runs them.  bls_jax._pad_mul_batch's lane
bucketing is not ported: it exists only to spare XLA retraces.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..crypto.bls12_381 import R
from ..device import resolve_device
from . import fq2_torch as fq2
from . import limbs
from .roofline import Launch

N_WINDOWS = 64  # 4-bit windows of 256-bit scalars


def scalars_to_windows(scalars: Sequence[int]) -> np.ndarray:
    """Python ints in [0, 2^256) -> [64, n] int32 4-bit digits, MSB first
    (row j is window j of every lane; bls_jax.scalars_to_windows
    transposed, lane axis last)."""
    raw = b"".join(int(s).to_bytes(32, "big") for s in scalars)
    octets = np.frombuffer(raw, dtype=np.uint8).reshape(len(scalars), 32)
    digits = np.stack([octets >> 4, octets & 15], axis=-1).reshape(len(scalars), N_WINDOWS)
    return np.ascontiguousarray(digits.T.astype(np.int32))


def window_needs(digit_rows) -> tuple:
    """[k, n] digits in the order a ladder adds them -> (lanes whose add
    takes the general formula, lanes already started) per row: an add is
    general where its digit and an earlier one are nonzero (a zero digit
    adds infinity, the first nonzero one adds to infinity), and a doubling
    is needed only after the lane's first nonzero digit."""
    nz = np.asarray(digit_rows) != 0
    started_before = (np.cumsum(nz, axis=0) - nz) > 0
    return (nz & started_before).sum(axis=1), started_before.sum(axis=1)


def scalar_mul_plan(windows: np.ndarray) -> List[Launch]:
    """The launches of g2_scalar_mul_windowed over these [64, n] windows:
    one `ladder` (the table, and per window the doublings of started lanes
    and the adds whose formula is general)."""
    n = windows.shape[-1]
    general, started = window_needs(windows)
    products = (n * fq2.TABLE_PRODUCTS + int(started.sum()) * fq2.DOUBLINGS * fq2.DBL_PRODUCTS
                + int(general.sum()) * fq2.GENERAL_ADD_PRODUCTS)
    return [Launch("ladder", n, products, fq2.ELEMENTS["ladder"], "ladder", 4 * windows.shape[0])]


def weighted_sum_plan(windows: np.ndarray, terms: int) -> List[Launch]:
    """The launches of g2_weighted_sum_windowed over these [64, S*B]
    windows: the ladder, then one general add per pair at each tree level."""
    b = windows.shape[-1] // terms
    return scalar_mul_plan(windows) + [
        Launch("add", half * b, half * b * fq2.GENERAL_ADD_PRODUCTS, fq2.ELEMENTS["add"], "tree")
        for half in tree_levels(terms)]


def tree_levels(terms: int) -> list:
    """The pairwise tree's adds per job at each level (an odd last term
    carries to the next level): [11, 5, 3, 1, 1] at 22 terms."""
    out = []
    while terms > 1:
        out.append(terms // 2)
        terms = (terms + 1) // 2
    return out


def _entries(use_kernel: bool):
    col = 0 if use_kernel else 1
    return {name: fns[col] for name, fns in fq2.ENTRIES.items()}


def g2_scalar_mul_windowed(points: torch.Tensor, windows: torch.Tensor,
                           use_kernel: bool = True) -> torch.Tensor:
    """[3, 2, 12, n] points x [64, n] int32 digits (same device) ->
    [3, 2, 12, n] Jacobian products: one `ladder` launch."""
    return _entries(use_kernel)["ladder"](points, windows)


def g2_weighted_sum_windowed(points: torch.Tensor, windows: torch.Tensor, terms: int,
                             use_kernel: bool = True) -> torch.Tensor:
    """sum_s coeff[s] * P[s] for each of B jobs.  points [3, 2, 12, S*B]
    and windows [64, S*B] hold term s of job b at lane s*B + b; returns
    [3, 2, 12, B].  Adjacent terms pair up as in bls_g2_jax (an odd last
    one carries to the next level), one add launch per level."""
    add = _entries(use_kernel)["add"]
    prods = g2_scalar_mul_windowed(points, windows, use_kernel)
    b = prods.shape[-1] // terms
    cols = prods.reshape(3, 2, limbs.N_LIMBS, terms, b)
    while cols.shape[3] > 1:
        k = cols.shape[3]
        half = k // 2
        pair = [cols[:, :, :, i : 2 * half : 2].reshape(3, 2, limbs.N_LIMBS, half * b)
                for i in (0, 1)]
        nxt = add(*pair).reshape(3, 2, limbs.N_LIMBS, half, b)
        cols = torch.cat([nxt, cols[:, :, :, k - 1 :]], 3) if k % 2 else nxt
    return cols[:, :, :, 0].contiguous()


# ---------------------------------------------------------------------------
# Host entry points (crypto/engine.GpuEngine calls g2_scalar_mul_batch_submit
# and g2_weighted_sum_dispatch)
# ---------------------------------------------------------------------------


def to_host(out: torch.Tensor) -> list:
    """[3, 2, 12, n] device limbs -> n affine host points (waits for the device)."""
    return limbs.limbs_to_g2_points(out.cpu().numpy()) if out.shape[-1] else []


def g2_scalar_mul_dispatch(points: Sequence, scalars: Sequence[int], device="cuda",
                           use_kernel: bool = True) -> torch.Tensor:
    """n host G2 points x n scalars -> the [3, 2, 12, n] products on the
    device, dispatched and not waited for.  Each distinct point object is
    converted to limbs once (a coin round signs each document n times)."""
    dev = resolve_device(device)
    if not points:
        return torch.empty((3, 2, limbs.N_LIMBS, 0), dtype=torch.int32, device=dev)
    distinct = {id(p): p for p in points}
    col = {key: k for k, key in enumerate(distinct)}
    base = limbs.g2_points_to_limbs(list(distinct.values()))
    pts = torch.from_numpy(np.ascontiguousarray(base[..., [col[id(p)] for p in points]])).to(dev)
    wins = torch.from_numpy(scalars_to_windows([s % R for s in scalars])).to(dev)
    return g2_scalar_mul_windowed(pts, wins, use_kernel)


def g2_scalar_mul_batch_submit(points: Sequence, scalars: Sequence[int], device="cuda",
                               use_kernel: bool = True):
    """Dispatch the batched ladder now, defer the device-to-host copy and
    the affine conversion: returns (the products on the device, not waited
    for; a zero-argument finisher that returns the host points)."""
    out = g2_scalar_mul_dispatch(points, scalars, device, use_kernel)
    return out, lambda: to_host(out)


def g2_scalar_mul_batch(points: Sequence, scalars: Sequence[int], device="cuda",
                        use_kernel: bool = True) -> list:
    """sk * P over G2 for every (P, sk) pair: signature-share generation
    for a whole batch of (node, instance) coin rounds at once."""
    return g2_scalar_mul_batch_submit(points, scalars, device, use_kernel)[1]()


def weighted_sum_operands(points_batch: Sequence[Sequence], coeffs_batch: Sequence[Sequence[int]],
                          device="cuda"):
    """[B][S] host G2 points x [B][S] Fr coefficients -> (points
    [3, 2, 12, S*B], windows [64, S*B], S) on the device, term s of job b
    at lane s*B + b."""
    b, s = len(points_batch), len(points_batch[0])
    if any(len(row) != s for row in points_batch) or [len(c) for c in coeffs_batch] != [s] * b:
        raise ValueError("every job needs the same number S of points and coefficients")
    dev = resolve_device(device)
    flat_pts = [points_batch[j][i] for i in range(s) for j in range(b)]
    flat_coeffs = [coeffs_batch[j][i] % R for i in range(s) for j in range(b)]
    pts = torch.from_numpy(limbs.g2_points_to_limbs(flat_pts)).to(dev)
    wins = torch.from_numpy(scalars_to_windows(flat_coeffs)).to(dev)
    return pts, wins, s


def g2_weighted_sum_dispatch(points_batch: Sequence[Sequence], coeffs_batch: Sequence[Sequence[int]],
                             device="cuda", use_kernel: bool = True) -> torch.Tensor:
    """[B][S] host G2 points x [B][S] Fr coefficients -> the B combined
    points [3, 2, 12, B] on the device, dispatched and not waited for."""
    pts, wins, s = weighted_sum_operands(points_batch, coeffs_batch, device)
    return g2_weighted_sum_windowed(pts, wins, s, use_kernel)


def g2_weighted_sum_batch(points_batch: Sequence[Sequence], coeffs_batch: Sequence[Sequence[int]],
                          device="cuda", use_kernel: bool = True) -> list:
    """The ThresholdSign Lagrange combine for B jobs at once: B points."""
    if not points_batch:
        return []
    return to_host(g2_weighted_sum_dispatch(points_batch, coeffs_batch, device, use_kernel))
