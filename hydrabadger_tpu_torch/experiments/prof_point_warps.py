"""Kernels B2 and B4's warps per block, swept on the card.

    python -m hydrabadger_tpu_torch.experiments.prof_point_warps

csrc/point_block.cuh runs a block of 32 lanes x T warps, warp t computing
products t, t + T, ... of each layer of a point program.  The wrappers pick
T with no knob: the widest layer of any program of the set, at most 8 (5
for G1, 8 for G2; ops/point_block).  This probe runs the three ladder
entries at the coin and decrypt rounds' lane counts, 4096 and 1408, at
every T from 1 to 8 (`point_block.warps`): B4's `ladder`, B2's
`glv_ladder` and `windowed_ladder`, over points and scalars from a seed
(scalar-0, 1 and r - 1 lanes included).  Every T's result is first held
equal to the wrappers' own launch, which is held equal to the plain
version.  Each launch is timed by the difference of two launch counts
(CUDA events).  One JSON line each: shape, T, whether the wrapper picks
that T, ms per launch, the bound (ops/roofline, from the digits' launch
plan) and the card.
"""
from __future__ import annotations

import numpy as np
import torch

from ..crypto import bls12_381 as bls
from ..ops import bls_g2_torch as g2, bls_torch, fq2_torch, fq_torch, limbs, point_block
from ..ops.circuit_torch import MAX_WARPS
from ._common import card, cuda_device, diff_ms, emit, parser

LANES = (4096, 1408)  # a round's share ladder, its combine's ladder (22 x 64)
ENTRIES = ("ladder", "glv_ladder", "windowed_ladder")


def _scalars(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    ks = [int.from_bytes(rng.bytes(32), "little") % bls.R for _ in range(n)]
    ks[0], ks[1], ks[2], ks[n // 2] = 0, 1, bls.R - 1, 0
    return ks


def _operands(entry: str, n: int, dev):
    """(points, digits, launch plan) of `entry` over n lanes."""
    rng = np.random.default_rng(n)
    ks = _scalars(n, n)
    if entry == "ladder":
        h = [bls.hash_to_g2(b"warps-%d" % i) for i in range(4)]
        pool = fq2_torch.g2_table_plain(torch.from_numpy(limbs.g2_points_to_limbs(h)))[1:]
        pool = pool.permute(1, 2, 3, 0, 4).reshape(3, 2, limbs.N_LIMBS, -1)
        digits = g2.scalars_to_windows(ks)
        plan = g2.scalar_mul_plan(digits)
    else:
        base = [bls.multiply(bls.G1, int(k)) for k in rng.integers(2, 2**20, 64)]
        pool = torch.from_numpy(limbs.points_to_limbs(base))
        if entry == "glv_ladder":
            digits = bls_torch.glv_windows(ks)
            plan = bls_torch.glv_plan(digits)
        else:
            digits = g2.scalars_to_windows(ks)
            plan = bls_torch.weighted_sum_plan(digits, 1)
    points = pool[..., rng.integers(0, pool.shape[-1], n)].contiguous().to(dev)
    return points, torch.from_numpy(digits).to(dev), plan[0]


def _same(got, want, what):
    if not torch.equal(got, want):
        raise RuntimeError(f"{what} != its reference")


def measure(device="cuda") -> list:
    dev = cuda_device(device)
    rows = []
    for entry in ENTRIES:
        c = 2 if entry == "ladder" else 1
        module = fq2_torch if c == 2 else fq_torch
        kernel, plain = module.ENTRIES[entry]
        picked = point_block.programs(c).warps
        for n in LANES:
            points, digits, launch = _operands(entry, n, dev)
            want = kernel(points, digits)
            _same(want, plain(points, digits), f"{entry} x {n}")
            ops_ms, bytes_ms = launch.bound()
            for t in range(1, MAX_WARPS + 1):
                with point_block.warps(c, t):
                    _same(kernel(points, digits), want, f"{entry} x {n} at T = {t}")

                    def run(k):
                        for _ in range(k):
                            kernel(points, digits)

                    ms = diff_ms(run, 1, 3)
                rows.append({"shape": f"{entry} x {n}", "warps": t, "picked": t == picked,
                             "ms": ms, "bound_ms": max(ops_ms, bytes_ms),
                             "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"})
    return rows


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    emit(measure(args.device), card(cuda_device(args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
