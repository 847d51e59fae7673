"""E4 on the card: the fixed cost of one kernel launch.

    python -m hydrabadger_tpu_torch.experiments.prof_fixed_cost

Counterpart of experiments/prof_fixed_cost.py, which chained 100 no-op
Pallas calls (x + inner over [32, 1024] int32, inner 1 or 100) with and
without `skip_device_barrier`, beside a plain XLA add chain.  The barrier
option has no counterpart here.  `fp_probe`'s `noop` entry computes
x + inner over the same [32, 1024] int32, chained 100 times, and is timed
three ways by CUDA events:

    queued         the 100 launches as the host queues them (the card waits
                   on the host's Python and ctypes path between launches)
    back_to_back   the same 100 queued behind a spin kernel, so they run
                   without host gaps: the card's cost of a launch in a stream
    graph          the 100 captured once as a CUDA graph and replayed: the
                   card's own cost per launch without the host

and `x + 1` in PyTorch, the one library call that computes the same
function (queued, as the JAX script's XLA chain).  One JSON line each:
us per launch, the bound (the [32, 1024] input read and the output
written once at the card's memory rate), the plain version's host us for
one call.
"""
from __future__ import annotations

import torch

from ..ops import fp_probe_torch as fp
from ._common import bound_ms, card, cuda_device, emit, events_ms, parser, wall_ms

SHAPE, LAUNCHES = (32, 1024), 100


def _chain(fn, x, count):
    def run():
        y = x
        for _ in range(count):
            y = fn(y)
        return y
    return run


def measure(device="cuda") -> list:
    dev = cuda_device(device)
    x = torch.zeros(SHAPE, dtype=torch.int32, device=dev)
    n = x.numel()
    bound, by = bound_ms(0, 2 * 4 * n)
    rows = []

    def row(variant, inner, total_ms):
        rows.append({"probe": "E4", "entry": variant, "inner": inner, "launches": LAUNCHES,
                     "us_per_launch": total_ms * 1e3 / LAUNCHES, "bound_us": bound * 1e3,
                     "bound_by": by, "plain_us": plain_us[inner]})

    plain_us = {inner: 1e3 * wall_ms(lambda inner=inner: fp.noop_plain(x, inner)) for inner in (1, 100)}

    for inner in (1, 100):
        fn = _chain(lambda y, inner=inner: fp.noop(y, inner), x, LAUNCHES)
        if not torch.equal(fn(), torch.full_like(x, LAUNCHES * inner)):
            raise RuntimeError("fp_probe noop chain != x + launches * inner")
        fn()
        row("queued", inner, min(events_ms(fn, spin=False) for _ in range(3)))
        row("back_to_back", inner, min(events_ms(fn) for _ in range(3)))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = fn()
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(out, torch.full_like(x, LAUNCHES * inner)):
            raise RuntimeError("fp_probe noop graph replay != x + launches * inner")
        row("graph", inner, min(events_ms(graph.replay) for _ in range(3)))
    lib = _chain(lambda y: y + 1, x, LAUNCHES)
    lib()
    row("torch x + 1 queued", 1, min(events_ms(lib, spin=False) for _ in range(3)))
    row("torch x + 1 back_to_back", 1, min(events_ms(lib) for _ in range(3)))
    return rows


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    emit(measure(args.device), card(cuda_device(args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
