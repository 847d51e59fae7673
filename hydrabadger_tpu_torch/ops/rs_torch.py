"""Batched Reed-Solomon erasure coding in PyTorch.

Counterpart of hydrabadger_tpu/ops/rs_jax.py: crypto/rs.py's
per-instance encode/reconstruct lifted into single device calls over a
whole batch of broadcast instances.

    encode:      [B, k, L] -> [B, n, L]   (parity rows from one GF matmul)
    reconstruct: [B, k, L] surviving shards (same survivor pattern
                 across the batch) -> [B, k, L] data rows

Both run one `gf256_torch.gf_matmul` each: the CUDA kernel for a CUDA
tensor, its plain version for a CPU tensor.  `use_kernel=False` runs the
plain version on any device (as rs_jax's `use_pallas=False` runs the XLA
path); chip_smoke.py holds the kernel against it that way.  Every result
is byte-equal to the CPU reference, a hard protocol requirement: every
node must derive identical shards whatever runs them.

The encode and decode matrices are built by the port's own crypto/rs.py
(the host `mat_inv` under `lru_cache`) and cached on the device per
(k, p) and per (k, p, rows).
"""
from __future__ import annotations

from functools import lru_cache

import torch

from ..crypto.rs import decode_matrix, encode_matrix
from . import gf256_torch


@lru_cache(maxsize=256)
def _parity_operand(data_shards: int, parity_shards: int, device: torch.device):
    mat = encode_matrix(data_shards, parity_shards)[data_shards:]
    return gf256_torch.operand(mat, device)


@lru_cache(maxsize=512)
def _decode_operand(data_shards: int, parity_shards: int, rows: tuple, device):
    return gf256_torch.operand(decode_matrix(data_shards, parity_shards, rows), device)


def _apply(op, x: torch.Tensor, out: torch.Tensor, use_kernel: bool) -> None:
    if use_kernel:
        gf256_torch.gf_matmul(op, x, out=out)
    else:
        out.copy_(gf256_torch.gf_matmul_bits_plain(op, x))


def _as_uint8(x) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x).__name__}")
    return x.to(torch.uint8)


def rs_encode_batch(
    data: torch.Tensor, data_shards: int, parity_shards: int, use_kernel: bool = True
) -> torch.Tensor:
    """[B, k, L] uint8 -> [B, k+p, L]: systematic batch encode.

    The parity is written straight into rows k.. of the result."""
    data = _as_uint8(data)
    if data.ndim != 3 or data.shape[1] != data_shards:
        raise ValueError(f"expected [B, {data_shards}, L], got {tuple(data.shape)}")
    B, k, L = data.shape
    out = torch.empty((B, k + parity_shards, L), dtype=torch.uint8, device=data.device)
    out[:, :k] = data
    op = _parity_operand(data_shards, parity_shards, data.device)
    _apply(op, data, out[:, k:], use_kernel)
    return out


def rs_reconstruct_batch(
    surviving: torch.Tensor,
    rows,
    data_shards: int,
    parity_shards: int,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Recover data rows for a batch sharing one survivor pattern.

    surviving: [B, k, L] — the shards at indices `rows` (sorted, length k),
    any strides.  Returns [B, k, L] original data rows.
    """
    rows = tuple(int(r) for r in rows)
    if len(rows) != data_shards:
        raise ValueError(f"need exactly {data_shards} survivor rows")
    surviving = _as_uint8(surviving)
    if surviving.ndim != 3 or surviving.shape[1] != data_shards:
        raise ValueError(
            f"expected [B, {data_shards}, L], got {tuple(surviving.shape)}"
        )
    op = _decode_operand(data_shards, parity_shards, rows, surviving.device)
    out = torch.empty_like(surviving, memory_format=torch.contiguous_format)
    _apply(op, surviving, out, use_kernel)
    return out
