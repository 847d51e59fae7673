"""Batched Vandermonde point folds: the DKG's commitment folds.

Counterpart of hydrabadger_tpu/ops/vandermonde_T.py (`fold_points_batch`,
the jitted `_fold_fn`).  A proposer publishes a (t+1) x (t+1) commitment
matrix C, and every node m folds it at its own index:

    row_commitment(x)[k]    = sum_j C[j][k] * x^j
    column_commitment(y)[j] = sum_k C[j][k] * y^k

Here all M nodes' folds of one matrix run together on kernel B2
(ops/fq_torch): the lanes are (node m, output k), m-major, and Horner
walks the J rows from the last to the first.  Each step multiplies the
accumulator by the lane's small evaluation point x_m (0 < x_m < 2^16)
with a masked double-and-add over nbits = the widest x's bit length, MSB
first: per bit a `dbl` of the running t, a `ladd` of t and the
accumulator, and a per-lane select of the sum where the bit of x_m is
set (`torch.where`, as jnp.where in the JAX fold); then a complete `add`
of the next row.

Add-body choice, as in the JAX fold: the masked steps may use the
incomplete ladder add, since t == acc would need a bit-prefix of x equal
to 1 mod r, i.e. only at the leading bit, where t is still the masked
infinity.  The chain add x*acc + C[j] folds attacker-chosen points, and a
proposer who knows its coefficients' discrete logs can force x*acc ==
C[j], so it is the complete add (tests/test_torch_vandermonde.py holds
that collision).  One fold is (J - 1) * (2 * nbits + 1) B2 launches;
doing it in one launch is a later redesign of the fold.

`use_kernel=False` runs the same steps on the plain versions on any
device; a CPU tensor always runs them.  A failure on the card raises.
`calls` counts the folds by (J, K, xs); chip_smoke reads it to replay a
run's shapes.
"""
from __future__ import annotations

from collections import Counter
from typing import Sequence

import torch

from . import fq_torch as fq
from .limbs import N_LIMBS

calls: Counter = Counter()


def bit_masks(xs: Sequence[int], k: int, device) -> torch.Tensor:
    """[nbits, M*K] bool: bit b (MSB first) of x_m at every lane (m, k)."""
    nbits = max(int(x).bit_length() for x in xs)
    rows = [[(int(x) >> (nbits - 1 - b)) & 1 for x in xs for _k in range(k)]
            for b in range(nbits)]
    return torch.tensor(rows, dtype=torch.bool, device=device)


def launches(j: int, xs: Sequence[int]) -> int:
    """B2 launches of one fold of J rows at the points xs."""
    return (j - 1) * (2 * max(int(x).bit_length() for x in xs) + 1)


def fold_points_batch(C: torch.Tensor, xs: Sequence[int], use_kernel: bool = True) -> torch.Tensor:
    """C: [3, 12, J, K] Jacobian words; xs: M small positive ints.
    Returns [3, 12, M, K] with out[..., m, k] = sum_j C[..., j, k] * xs[m]^j."""
    xs = [int(x) for x in xs]
    assert xs and all(0 < x < (1 << 16) for x in xs), "small points only"
    col = 0 if use_kernel else 1
    dbl, ladd, add = (fq.ENTRIES[name][col] for name in ("dbl", "ladd", "add"))
    _, _, J, K = C.shape
    M = len(xs)
    calls[(J, K, tuple(xs))] += 1
    masks = bit_masks(xs, K, C.device)
    # row j tiled across the M nodes: lane m*K + k holds C[j][k]
    rows = C.permute(2, 0, 1, 3).repeat(1, 1, 1, M)  # [J, 3, 12, M*K]
    acc = rows[J - 1].contiguous()
    inf = fq.jac_infinity(M * K, C.device)
    for j in range(J - 2, -1, -1):
        t = inf
        for m in masks:
            t = dbl(t)
            t = torch.where(m, ladd(t, acc), t)
        # complete add: the row is attacker-chosen (module docstring)
        acc = add(t, rows[j].contiguous())
    return acc.reshape(3, N_LIMBS, M, K)
