"""Trace an epoch loop: where the device time of an epoch goes.

    python -m hydrabadger_tpu_torch.sim.trace_epoch [--epochs 20]
        [--instances 1024] [--trace PATH]
    python -m hydrabadger_tpu_torch.sim.trace_epoch --full-crypto
        [--epochs 3] [--instances 64] [--trace PATH]
    python -m hydrabadger_tpu_torch.sim.trace_epoch --coin
        [--instances 64] [--trace PATH]
    python -m hydrabadger_tpu_torch.sim.trace_epoch --decrypt [--trace PATH]

Warms a `TensorSim` at the config-6 geometry (64 nodes, 12-byte shards),
or with --full-crypto a `FullCryptoTensorSim` at the config-8 geometry
(64 nodes; its set-up makes one host G1 multiply per ciphertext), then
runs `run(epochs)` under `torch.profiler` and prints one JSON object:
the window's wall ms, the device's busy ms (the union of its kernel and
copy intervals) and idle share, and device ms per epoch for each kernel
name; with --full-crypto also kernel B3's device ms per epoch split into
its circuit launches (stage 1) and its chain launch (the Straus
combine), with their launches per epoch.  With --coin it warms a `CoinRound` (64 nodes; set-up: 22 host G1
multiplies and one host hash onto G2 per instance), traces one round and
splits its device time into kernel B4's launches by entry (`ladder`,
`add`; `table` and `step` where a caller still launches them) and the
glue (every other kernel and copy).  With --decrypt it warms a
`DecryptRound` (64 nodes; set-up: 22 host G1 multiplies and one host
encryption per proposer), traces one round and splits its device time
into kernel B2's launches (`glv_ladder`, `windowed_ladder`, the `tree`
adds, matched to the round's launch plan in order) and the glue.  `--trace` also
writes the Chrome trace.  The profiler adds host
cost to every launch, so the traced epochs/s is below the untraced one;
the device times are the kernels' own.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .coin import CoinConfig, CoinRound
from .decrypt import DecryptConfig, DecryptRound
from .tensor import FullCryptoConfig, FullCryptoTensorSim, TensorSim, TensorSimConfig

# kernel B4's entries by their instantiation (csrc/fq2_point.cu's Kind)
_B4_PARTS = {"table": "0", "step": "1", "add": "2", "ladder": "3"}


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if start > end:
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy


def _trace_sim(sim, instances: int, epochs: int, warmup: int, trace_path=None) -> dict:
    if not sim.run(warmup):  # builds the kernels, uploads the constants
        raise RuntimeError("warm-up epochs: the epoch's check failed")
    on_card = sim.device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    if on_card:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        ok = sim.run(epochs)  # ends in the verdict's host sync
        wall_ms = (time.perf_counter() - t0) * 1e3
    if not ok:
        raise RuntimeError("traced epochs: the epoch's check failed")
    if trace_path:
        prof.export_chrome_trace(trace_path)
    device_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    per_name = defaultdict(float)
    for e in device_events:
        per_name[e.name] += e.time_range.elapsed_us()
    busy_ms = _union_us((e.time_range.start, e.time_range.end) for e in device_events) / 1e3
    return {
        "device": torch.cuda.get_device_name(sim.device) if on_card else "cpu",
        "epochs": epochs,
        "instances": instances,
        "wall_ms": wall_ms,
        "traced_epochs_per_s": epochs / (wall_ms / 1e3),
        "device_busy_ms": busy_ms if device_events else None,
        "device_idle_share": 1 - busy_ms / wall_ms if device_events else None,
        "device_ms_per_epoch": {
            name: us / 1e3 / epochs
            for name, us in sorted(per_name.items(), key=lambda kv: -kv[1])
        },
    }


def _b4_part(name: str) -> str:
    for part, kind in _B4_PARTS.items():
        if f"fq2_point_kernel<{kind}>" in name or f"fq2_point_kernelILi{kind}E" in name:
            return part
    return "glue"


def trace_coin(cfg: CoinConfig, device="cuda", trace_path=None) -> dict:
    """Profile one coin round after a warm-up round: wall, device busy and
    idle share, and device ms by part (B4's entries / glue)."""
    cr = CoinRound(cfg, device=device)
    cr.run()  # builds the kernel, warms the allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cr.run()  # ends in the host's fetch of the shares and signatures
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace_path:
        prof.export_chrome_trace(trace_path)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    parts = defaultdict(float)
    for e in events:
        parts[_b4_part(e.name)] += e.time_range.elapsed_us() / 1e3
    busy_ms = _union_us((e.time_range.start, e.time_range.end) for e in events) / 1e3
    return {
        "device": torch.cuda.get_device_name(cr.engine.device),
        "nodes": cfg.n_nodes,
        "instances": cfg.instances,
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if events else None,
        "device_idle_share": 1 - busy_ms / wall_ms if events else None,
        "device_ms": dict(parts),
        "launches": cr.last_launches,
    }


def trace_decrypt(cfg: DecryptConfig, device="cuda", trace_path=None) -> dict:
    """Profile one threshold-decrypt round after a warm-up round: wall,
    device busy and idle share, and device ms by part (glv_ladder /
    windowed_ladder / tree / glue)."""
    rnd = DecryptRound(cfg, device=device)
    rnd.run()  # builds the kernel, warms the allocator
    plan = rnd.plan()
    parts_in_order = [r.entry if r.part == "ladder" else r.part
                      for r in plan["share"] + plan["combine"]]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rnd.run()  # ends in the host's unwrap of the plaintexts
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace_path:
        prof.export_chrome_trace(trace_path)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    b2 = sorted((e for e in events if "fq_point" in e.name), key=lambda e: e.time_range.start)
    if len(b2) != len(parts_in_order):
        raise RuntimeError(f"traced {len(b2)} B2 launches, the plan has {len(parts_in_order)}")
    parts = defaultdict(float)
    for e, part in zip(b2, parts_in_order):
        parts[part] += e.time_range.elapsed_us() / 1e3
    for e in events:
        if "fq_point" not in e.name:
            parts["glue"] += e.time_range.elapsed_us() / 1e3
    busy_ms = _union_us((e.time_range.start, e.time_range.end) for e in events) / 1e3
    return {
        "device": torch.cuda.get_device_name(rnd.engine.device),
        "nodes": cfg.n_nodes,
        "ciphertexts": cfg.n_nodes,
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if events else None,
        "device_idle_share": 1 - busy_ms / wall_ms if events else None,
        "device_ms": dict(parts),
        "launches": rnd.last_launches,
    }


def trace(cfg: TensorSimConfig, epochs: int, device="cuda", trace_path=None) -> dict:
    """Profile `epochs` fast-path epochs after a warm-up; see the module docstring."""
    return _trace_sim(TensorSim(cfg, device=device), cfg.instances, epochs, 2, trace_path)


# kernel B3's two entries by their kernel names (csrc/circuit.cu)
_B3_PARTS = (("straus chain", "circuit_chain_kernel"), ("stage-1 circuits", "circuit_kernel"))


def trace_full_crypto(cfg: FullCryptoConfig, epochs: int, device="cuda", trace_path=None) -> dict:
    """Profile `epochs` threshold-decrypt epochs after one warm-up epoch."""
    sim = FullCryptoTensorSim(cfg, device=device)
    out = _trace_sim(sim, cfg.instances, epochs, 1, trace_path)
    b3 = defaultdict(float)
    for name, ms in out["device_ms_per_epoch"].items():
        part = next((p for p, kernel in _B3_PARTS if kernel in name), None)
        if part:
            b3[part] += ms
    counts = sim.epoch.launch_counts()["circuit"]
    out["b3_ms_per_epoch"] = dict(b3)
    out["b3_launches_per_epoch"] = {
        "straus chain": counts.get(sim.epoch.straus.name, 0),
        "stage-1 circuits": sum(v for k, v in counts.items() if k != sim.epoch.straus.name),
    }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full-crypto", action="store_true",
                    help="trace FullCryptoTensorSim (config 8) instead of TensorSim")
    ap.add_argument("--coin", action="store_true",
                    help="trace one CoinRound (64 nodes) instead of TensorSim")
    ap.add_argument("--decrypt", action="store_true",
                    help="trace one DecryptRound (64 nodes) instead of TensorSim")
    ap.add_argument("--epochs", type=int, default=None, help="default 20, or 3 with --full-crypto")
    ap.add_argument("--instances", type=int, default=None,
                    help="default 1024, or 64 with --full-crypto or --coin")
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    args = ap.parse_args(argv)
    if args.decrypt:
        out = trace_decrypt(DecryptConfig(), trace_path=args.trace)
    elif args.coin:
        out = trace_coin(CoinConfig(n_nodes=64, instances=args.instances or 64),
                         trace_path=args.trace)
    elif args.full_crypto:
        cfg = FullCryptoConfig(n_nodes=64, instances=args.instances or 64)
        out = trace_full_crypto(cfg, args.epochs or 3, trace_path=args.trace)
    else:
        cfg = TensorSimConfig(n_nodes=64, instances=args.instances or 1024, shard_len=12)
        out = trace(cfg, args.epochs or 20, trace_path=args.trace)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
