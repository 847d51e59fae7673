#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check every result.

    python3 chip_smoke.py

Runs from the root of a checkout (it imports `hydrabadger_tpu_torch` from
beside itself) and needs one CUDA card with nvcc.  Phases, each fatal on
failure:

  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build every kernel from csrc/ (one nvcc per source, in parallel);
  3. each kernel against its plain PyTorch version on the card, exact
     bytes, at the main path's shapes and a ragged one, and against the
     numpy GF(2^8) reference on sampled instances;
  4. the main path: TensorSim at the config-6 geometry (64 nodes x 1024
     instances, 12-byte shards), 50 epochs with every launch counter set
     to 0 just before and read just after; the verdict, 2 launches per
     epoch, the final state against the same epochs through the plain
     version, and one epoch of sampled instances against the host oracle;
  5. timings: epochs/s, each kernel's time per launch against its bound,
     its plain version and a torch.matmul yardstick.

The line before the last is one JSON object {"kernels": [...]}; the last
is {"ok": true, "device": {...}}.  Without a card it exits 2 and prints
no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM peaks (NVIDIA data sheet, dense, at a 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS_PER_S = 1979e12

N_NODES, INSTANCES, SHARD_LEN, EPOCHS = 64, 1024, 12, 50


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


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


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int32) - b.to(torch.int32)).abs().max().item())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run",
              file=sys.stderr)
        return 2

    from hydrabadger_tpu_torch.crypto import gf256
    from hydrabadger_tpu_torch.crypto.rs import decode_matrix, encode_matrix
    from hydrabadger_tpu_torch.ops import _kernels, gf256_torch
    from hydrabadger_tpu_torch.sim import tensor as ts

    dev = torch.device("cuda", 0)
    # the plain version's float32 product must stay full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. the card -------------------------------------------------------
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    tag = f"[{card}]"

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    built = _kernels.build()
    print(f"build: {time.perf_counter() - t0:.2f} s wall for {sorted(built) or 'none (cached)'}")
    for name, (seconds, output) in built.items():
        print(f"  {name}: nvcc {seconds:.2f} s")
        for line in output.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"    {line.strip()}")
    for name in _kernels.LIBRARIES:
        _kernels.load(name)

    # -- 3. kernels against their plain versions -----------------------------
    cfg = ts.TensorSimConfig(n_nodes=N_NODES, instances=INSTANCES, shard_len=SHARD_LEN)
    k, p = cfg.data_shards, cfg.parity_shards
    n = k + p
    B = INSTANCES * N_NODES  # B*L = 786,432 byte columns per call
    rng = np.random.default_rng(7)
    data = torch.from_numpy(rng.integers(0, 256, (B, k, SHARD_LEN), dtype=np.uint8)).to(dev)
    rows = tuple(range(p, n))
    enc_op = gf256_torch.operand(encode_matrix(k, p)[k:], dev)
    dec_op = gf256_torch.operand(decode_matrix(k, p, rows), dev)
    worst = 0

    def hold(op, x, label, out=None):
        nonlocal worst
        got = gf256_torch.gf_matmul(op, x, out=out)
        want = gf256_torch.gf_matmul_bits_plain(op, x)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        worst = max(worst, err)
        check(torch.equal(got, want), f"gf256_matmul != plain at {label} (max err {err})")
        print(f"kernel == plain, exact: {label}")
        return got

    parity = hold(enc_op, data, f"encode ({p},{k}) x [{B},{k},{SHARD_LEN}]")
    codeword = torch.cat([data, parity], dim=1)  # [B, n, L]
    survivors = codeword[:, p:n]  # the main path's strided view
    recovered = hold(dec_op, survivors, f"reconstruct ({k},{k}) x strided [{B},{k},{SHARD_LEN}] view")
    check(torch.equal(recovered, data), "reconstruct did not recover the data rows")
    into = torch.zeros((B, n, SHARD_LEN), dtype=torch.uint8, device=dev)
    hold(enc_op, data, "encode into the codeword's parity rows (strided out)", out=into[:, k:])
    shifted = torch.zeros((B, k, SHARD_LEN + 1), dtype=torch.uint8, device=dev)
    shifted[:, :, 1:] = data  # a view at an odd address: the byte-by-byte path
    bytewise = hold(enc_op, shifted[:, :, 1:], "encode from an unaligned view (byte path)")
    check(torch.equal(bytewise, parity), "byte path != word path")
    rag_mat = rng.integers(0, 256, (3, 5), dtype=np.uint8)
    rag = torch.from_numpy(rng.integers(0, 256, (5, 1013), dtype=np.uint8)).to(dev)
    rag_out = hold(gf256_torch.operand(rag_mat, dev), rag, "ragged (3,5) x [5,1013]")
    check(np.array_equal(rag_out.cpu().numpy(), gf256.matmul(rag_mat, rag.cpu().numpy())),
          "ragged kernel != numpy gf256.matmul")
    rag3 = torch.from_numpy(rng.integers(0, 256, (3, 5, 1013), dtype=np.uint8)).to(dev)
    hold(gf256_torch.operand(rag_mat, dev), rag3, "ragged (3,5) x [3,5,1013]")
    sample = [0, 1, B // 2, B - 1]
    host_data = data[sample].cpu().numpy()
    host_par = parity[sample].cpu().numpy()
    host_rec = recovered[sample].cpu().numpy()
    for i in range(len(sample)):
        check(np.array_equal(host_par[i], gf256.matmul(encode_matrix(k, p)[k:], host_data[i])),
              "encode kernel != numpy gf256.matmul on a sampled instance")
        check(np.array_equal(host_rec[i], host_data[i]), "sampled reconstruct != data")
    print(f"kernel == numpy gf256.matmul on sampled instances {sample}")

    # -- 4. the main path --------------------------------------------------
    sim = ts.TensorSim(cfg, device="cuda")
    plain = ts.TensorSim(cfg, device="cuda", use_kernel=False)
    check(sim.run(2), "warm-up epochs: totality violated")
    check(plain.run(2), "plain warm-up epochs: totality violated")
    torch.cuda.synchronize()

    gf256_torch.launches = 0
    t0 = time.perf_counter()
    ok = sim.run(EPOCHS)  # one host sync, at the end
    main_s = time.perf_counter() - t0
    counts = {"gf256_matmul": gf256_torch.launches}
    check(ok, "main path: totality violated")
    check(counts["gf256_matmul"] == 2 * EPOCHS,
          f"main path made {counts['gf256_matmul']} gf256_matmul launches, want {2 * EPOCHS}")
    print(f"main path: {EPOCHS} epochs ok, launches {counts}")

    check(plain.run(EPOCHS), "plain main path: totality violated")
    check(torch.equal(sim._state, plain._state), "final state != the plain version's")
    print("final state == the same epochs through the plain version")

    idx = [0, INSTANCES // 3, INSTANCES - 1]
    sampled = sim._state[idx].contiguous()
    decoded, ok_s = ts.epoch(sampled, k, p)
    oracle = ts.cpu_fast_path_epoch(sampled.cpu().numpy(), k, p)
    check(bool(ok_s.all()), "sampled epoch: totality violated")
    check(np.array_equal(decoded.cpu().numpy(), oracle), "sampled epoch != cpu_fast_path_epoch")
    print(f"one epoch of instances {idx} == cpu_fast_path_epoch")

    # -- 5. timings --------------------------------------------------------
    eps = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(sim.run(EPOCHS), "timed run: totality violated")
        eps.append(EPOCHS / (time.perf_counter() - t0))
    print(f"epochs/s at {N_NODES} nodes x {INSTANCES} instances: main path "
          f"{EPOCHS / main_s:.2f}, timed runs {[round(e, 2) for e in eps]} {tag}")

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    cols = B * SHARD_LEN
    shapes = []
    for label, op, x in (("encode", enc_op, data), ("reconstruct", dec_op, survivors)):
        m = op.shape[0]
        out = torch.empty((B, m, SHARD_LEN), dtype=torch.uint8, device=dev)
        ms = timed_ms(lambda: gf256_torch._launch(op, x, out), 20, flush)
        plain_ms = timed_ms(lambda: gf256_torch.gf_matmul_bits_plain(op, x), 5, flush)
        a16 = op.abits.to(torch.bfloat16)
        x16 = torch.randint(0, 2, (8 * k, cols), device=dev).to(torch.bfloat16)
        yard_ms = timed_ms(lambda: torch.matmul(a16, x16), 10, flush)
        del x16
        nbytes = cols * (k + m) + m * k * 8 * 4  # data + out once, the constant table
        ops = 2 * (8 * m) * (8 * k) * cols  # bit-product form, one MAC = 2 ops
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_INT8_OPS_PER_S * 1e3
        shapes.append({
            "shape": label, "m": m, "k": k, "cols": cols, "ms": ms, "plain_ms": plain_ms,
            "matmul_bf16_yardstick_ms": yard_ms, "bytes": nbytes, "int8_ops": ops,
            "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
        })
        print(f"gf256_matmul {label} ({m},{k}) x {cols} cols: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bf16 matmul yardstick {yard_ms:.4f} ms, bound "
              f"{max(bytes_ms, ops_ms):.4f} ms (bytes {bytes_ms:.4f}, int8 ops {ops_ms:.4f}) {tag}")
    del flush
    epoch_ms = 1e3 / float(np.median(eps))
    kernel_ms = sum(s["ms"] for s in shapes)
    print(f"epoch {epoch_ms:.4f} ms, of which the two gf256_matmul launches "
          f"{kernel_ms:.4f} ms ({100 * kernel_ms / epoch_ms:.1f}%) {tag}")
    print(json.dumps({"shapes": shapes, "card": card}))

    ops_total = sum(s["ops_bound_ms"] for s in shapes)
    bytes_total = sum(s["bytes_bound_ms"] for s in shapes)
    kernels = [{
        "name": "gf256_matmul",
        "route": "cuda",
        "source": "hydrabadger_tpu_torch/csrc/gf256_matmul.cu",
        "replaces": "hydrabadger_tpu/ops/gf256_jax.py:148",
        "launches": counts["gf256_matmul"],
        "max_abs_err": worst,
        "per": f"one epoch: encode ({p},{k}) + reconstruct ({k},{k}), {cols} columns each",
        "ms": kernel_ms,
        "plain_ms": sum(s["plain_ms"] for s in shapes),
        "bound_ms": max(ops_total, bytes_total),
        "bound_by": "operations" if ops_total >= bytes_total else "bytes",
        "library_ms": None,
    }]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
