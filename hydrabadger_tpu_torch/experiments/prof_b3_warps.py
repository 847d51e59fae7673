"""Kernel B3's warps per block, swept on the card.

    python -m hydrabadger_tpu_torch.experiments.prof_b3_warps

csrc/circuit.cu runs a block of 32 lanes x T warps, warp t computing
products t, t + T, ... of each layer.  The wrappers pick T with no knob:
a circuit's widest layer (5 for the three decrypt circuits), and for a
chain at least the elements of a table entry (3).  This probe runs the
config-8 epoch's B3 launch shapes at every T from 1 to 8 on instances of
its own whose T it sets: `dblk6_add`, `add` and `dblk4_add` at 94,208
lanes (stage 1's width) and 4096 lanes, and the Straus chain at 4096
lanes (T >= 3) over a table of distinct points, with config 8's Lagrange
coefficients (the lowest t + 1 quorum) and key shares from a seed.  Every T's result is first held equal to the wrappers' own
launch, which is held equal to the plain version.  Each launch is timed
by the difference of two launch counts (CUDA events).  One JSON line
each: shape, T, whether the wrapper picks that T, ms per launch, the
bound (ops/roofline) and the card.
"""
from __future__ import annotations

import numpy as np
import torch

from ..crypto import bls12_381 as bls, threshold as th
from ..ops import decrypt_torch as dt, fq_torch as fq
from ..ops.circuit_torch import MAX_WARPS, CircuitChain, CircuitExec
from ._common import card, cuda_device, diff_ms, emit, fp_operands, parser, product_bound_ms

LANES, Q = 4096, 22  # config 8: 64 nodes x 64 instances, a quorum of t + 1 = 22
STAGE1 = (Q + 1) * LANES  # stage 1's q + 1 ladders side by side: 94,208 lanes


def _repeat(fn):
    def run(k):
        for _ in range(k):
            fn()
    return run


def _same(got, want, what):
    if not torch.equal(got, want):
        raise RuntimeError(f"{what} != its reference")


def _circuit_rows(circ: CircuitExec, lanes: int, dev) -> list:
    x = fp_operands(circ.n_inputs * lanes, lanes, dev).reshape(12, circ.n_inputs, lanes)
    x = x.transpose(0, 1).contiguous()  # [6, 12, lanes]
    want = circ(x)
    _same(want, circ.plain(x), f"{circ.name} x {lanes}")
    bound, by = product_bound_ms(circ.n_products * lanes,
                                 (circ.n_inputs + circ.n_outputs) * lanes)
    rows = []
    for t in range(1, MAX_WARPS + 1):
        mine = CircuitExec(circ.circ, circ.name)
        mine.slots = mine.slots._replace(warps=t)
        _same(mine(x), want, f"{circ.name} x {lanes} at T = {t}")
        ms = diff_ms(_repeat(lambda: mine(x)), 10, 50)
        rows.append({"shape": f"{circ.name} x {lanes}", "warps": t,
                     "picked": t == circ.slots.warps, "ms": ms, "bound_ms": bound,
                     "bound_by": by})
    return rows


def _chain_rows(dev) -> list:
    rng = np.random.default_rng(8)
    sks = [int.from_bytes(rng.bytes(32), "little") % bls.R for _ in range(Q + 1)]
    lams = th.lagrange_coeffs_at_zero(range(1, Q + 1))
    ep = dt.DecryptEpoch(LANES, sks[:Q], lams, sks[Q], dev)
    pts = fp_operands(3 * Q * LANES, 40, dev).reshape(12, 3, Q * LANES).transpose(0, 1)
    tabs = dt._build_table(pts, 1 << dt.W2, dt._Ops(True)).reshape(
        3, 12, (1 << dt.W2) * Q, LANES)
    acc0 = fq.jac_infinity(LANES, dev)
    chain = ep.straus
    want = chain(acc0, tabs)
    _same(want, chain.plain(acc0, tabs), "straus chain")
    bound, by = product_bound_ms(chain.products * LANES, chain.elements() * LANES)
    rows = []
    for t in range(chain.n_sel, MAX_WARPS + 1):
        mine = CircuitChain(chain.circuits, chain.steps, chain.n_acc, chain.name)
        mine.warps = t
        _same(mine(acc0, tabs), want, f"straus chain at T = {t}")
        ms = diff_ms(_repeat(lambda: mine(acc0, tabs)), 2, 6)
        rows.append({"shape": f"straus chain x {LANES} ({len(chain.steps)} steps, "
                              f"{chain.products} products per lane)", "warps": t,
                     "picked": t == chain.warps, "ms": ms, "bound_ms": bound, "bound_by": by})
    return rows


def measure(device="cuda") -> list:
    dev = cuda_device(device)
    rows = []
    for lanes in (STAGE1, LANES):
        for circ in (dt._dblk_add_circuit(6), dt._add_circuit(), dt._dblk_add_circuit(4)):
            rows += _circuit_rows(circ, lanes, dev)
    return rows + _chain_rows(dev)


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    emit(measure(args.device), card(cuda_device(args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
