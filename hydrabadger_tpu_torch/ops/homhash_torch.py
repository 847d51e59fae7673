"""Batched homomorphic shard sketches on kernel B1 — the low-comm RBC fold.

Counterpart of hydrabadger_tpu/ops/homhash_jax.py, the device twin of
crypto/homhash.sketch_batch_np:

    sketches^T [8, B] = matrix_T(seed, L) [8, L]  x  shards^T [L, B]

one GF(2^8) product, `gf256_torch.gf_matmul`: kernel B1 for a CUDA device
(launches per call: `gf256_torch.chunks(8, L)`, one while the operand fits),
its plain version for the CPU.  The product takes any shape, so nothing is
padded (the JAX twin pads both axes only to bound XLA recompiles; the
counter-mode matrix makes zero padding exact either way).  The shards go
up as one contiguous [L, B] copy transposed on the host: the kernel reads
it by 4-byte words when B % 4 == 0, by row tiles when B is at least a third
of a tile's columns, and byte by byte otherwise.  B = 0 or
L = 0 returns zeros without a launch, as the host twin does.

`calls` counts the products by (B, L); chip_smoke reads it to replay the
simulator's call shapes.  Lane counters go to the default registry, as the
JAX twin's do.
"""
from __future__ import annotations

from collections import Counter
from typing import Callable, Optional

import numpy as np
import torch

from ..crypto import homhash
from ..device import resolve_device
from ..obs import metrics as M
from ..obs.metrics import default_registry
from . import gf256_torch

calls: Counter = Counter()


def _note_lanes(real: int) -> None:
    reg = default_registry()
    reg.counter(M.HOMHASH_REAL_LANES).inc(real)
    reg.counter(M.HOMHASH_PAD_LANES).inc(0)
    reg.gauge(M.HOMHASH_LANE_OCCUPANCY).track(1.0)


def _dispatch(shards, seed: bytes, device, use_kernel: bool) -> Optional[torch.Tensor]:
    """Launch the product; the [8, B] sketches on `device`, or None when
    B * L == 0 (nothing launched)."""
    shards = np.asarray(shards, dtype=np.uint8)
    if shards.ndim != 2:
        raise ValueError(f"expected [B, L] shards, got {shards.shape}")
    b, length = shards.shape
    if b == 0 or length == 0:
        return None
    dev = resolve_device(device)
    _note_lanes(b)
    op = gf256_torch.operand(homhash.matrix_T(seed, length), dev)
    data = torch.from_numpy(np.ascontiguousarray(shards.T)).to(dev)
    calls[(b, length)] += 1
    if not use_kernel:
        return gf256_torch.gf_matmul_bits_plain(op, data)
    return gf256_torch.gf_matmul(op, data)


def sketch_batch_submit(shards, seed: bytes, device="cuda",
                        use_kernel: bool = True) -> Callable[[], np.ndarray]:
    """Dispatch now; the returned finisher copies the [B, 8] sketches to the
    host.  `use_kernel=False` runs the plain version on the device."""
    out = _dispatch(shards, bytes(seed), device, use_kernel)
    if out is None:
        empty = np.zeros((np.shape(shards)[0], homhash.SKETCH_BYTES), dtype=np.uint8)
        return lambda: empty
    return lambda: np.ascontiguousarray(out.cpu().numpy().T)


def sketch_batch(shards, seed: bytes, device="cuda", use_kernel: bool = True) -> np.ndarray:
    """[B, L] uint8 shards -> [B, SKETCH_BYTES] sketches, one product."""
    return sketch_batch_submit(shards, seed, device, use_kernel)()
