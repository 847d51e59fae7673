"""What the probes share: operands, timing by CUDA events, bounds, output."""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops import limbs, roofline


def card(device: torch.device) -> dict:
    """The card's name and power limit as nvidia-smi reports them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    return {"device": torch.cuda.get_device_name(device), "card": line}


def cuda_device(device="cuda") -> torch.device:
    """The probe's device: a card, never the CPU (a CPU time is no
    measurement of the card)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the probes time the card: pass a cuda device")
    return dev


def fp_operands(n: int, seed: int, device) -> torch.Tensor:
    """[12, n] canonical Fp elements (below p) from a numpy seed."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 1 << 32, size=(n, limbs.N_LIMBS), dtype=np.uint64)
    vals = [int.from_bytes(r.astype("<u4").tobytes(), "little") % limbs.P for r in raw]
    return torch.from_numpy(limbs.ints_to_limbs_batch(vals).T.copy()).to(device)


def events_ms(fn, spin: bool = True) -> float:
    """Device ms of one call of fn between two CUDA events.  With `spin` a
    spin kernel keeps the card busy while the host queues the call's
    launches, so they run back to back and no host gap is timed; without
    it the card waits on the host as a caller's queue would make it."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if spin:
        torch.cuda._sleep(20_000_000)  # ~10 ms of spinning ahead of the queue
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def timed_ms(fn, reps: int, flush: torch.Tensor | None = None) -> float:
    """Median device time of fn() in ms, CUDA events around each call;
    `flush` (a buffer larger than L2) is rewritten before each call so
    every call starts with a cold cache."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def diff_ms(run, lo: int, hi: int) -> float:
    """ms per unit of `run(k)` from two lengths: (t(hi) - t(lo)) / (hi - lo),
    each the least of 3 timings by CUDA events; the difference cancels what
    does not scale with k (launch jitter, a chain's loads and stores)."""
    run(lo)
    best = {}
    for _ in range(3):
        for k in (lo, hi):
            t = events_ms(lambda: run(k))
            best[k] = min(best.get(k, float("inf")), t)
    return (best[hi] - best[lo]) / (hi - lo)


def bound_ms(ops: float, nbytes: float) -> tuple:
    """(bound ms, "operations" or "bytes") of `ops` int8 operations and
    `nbytes` bytes (ops/roofline)."""
    return roofline.bound_ms(*roofline.ops_bytes_ms(ops, nbytes))


def product_bound_ms(products: int, elements: int) -> tuple:
    """The bound of `products` Fp products that move `elements` field elements."""
    return roofline.bound_ms(*roofline.product_ms(products, elements))


def wall_ms(fn) -> float:
    """Host ms of one call of fn ended by a synchronize: the median of 5
    calls after a warm-up (the plain versions' and the host entry points'
    time; one host-timed call varies several-fold)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="the card to time (default cuda)")
    return ap


def emit(rows, extra: dict) -> None:
    for row in rows:
        print(json.dumps({**row, **extra}))
