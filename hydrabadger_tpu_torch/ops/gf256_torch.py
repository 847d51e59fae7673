"""GF(2^8) linear algebra in PyTorch — the Reed-Solomon hot kernel.

Counterpart of hydrabadger_tpu/ops/gf256_jax.py.  Multiplication by a
constant in GF(2^8) is linear over GF(2), so an [m, k] GF(2^8) matrix
lifts to an [8m, 8k] bit matrix and a whole RS encode becomes

    bits(out) = (bit_matrix @ bits(data)) mod 2

Three implementations, all byte-equal to crypto/gf256.matmul:
  - `gf_matmul_gather`:     log/exp-table gathers + XOR reduce (reference
                            semantics, any shape)
  - `gf_matmul_bits_plain`: the kernel's plain version: a float32 0/1 bit
                            product (exact: sums <= 8k <= 2040 < 2^24),
                            mod 2, pack
  - `gf_matmul`:            the CUDA kernel csrc/gf256_matmul.cu for a CUDA
                            tensor; the plain version for a CPU tensor

Layouts follow the JAX package: bits are LSB-first with row order
i*8 + bit, data is [k, L] or batched [B, k, L] with the shard bytes on the
last axis.  The kernel takes its own strides, so a batch may be a view.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache, reduce
from typing import Optional, Union

import numpy as np
import torch

from ..crypto import gf256
from . import _kernels

# Kernel launches made by `gf_matmul` (one per launch, none for CPU
# tensors).  chip_smoke.py sets it to 0 before the main path and reads it
# after, to show that the path went through the kernel.
launches = 0

_EXP = torch.from_numpy(gf256.EXP_TABLE.astype(np.int64))  # [512]
_LOG = torch.from_numpy(gf256.LOG_TABLE.astype(np.int64))  # [256]

# Row tiles the kernel is instantiated for (csrc/gf256_matmul.cu's switch).
TILE_M = (22, 16, 11, 8, 4)


# ---------------------------------------------------------------------------
# Bit packing helpers (LSB-first, matching gf256.expand_to_bit_matrix)
# ---------------------------------------------------------------------------


def bytes_to_bits(x: torch.Tensor) -> torch.Tensor:
    """[..., k, L] uint8 -> [..., 8k, L] uint8 of 0/1 (row order i*8 + bit)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)[:, None]
    bits = (x.unsqueeze(-2) >> shifts) & 1  # [..., k, 8, L]
    return bits.reshape(*x.shape[:-2], x.shape[-2] * 8, x.shape[-1])


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """[..., 8m, L] 0/1 integers -> [..., m, L] uint8."""
    m8, L = bits.shape[-2], bits.shape[-1]
    grouped = bits.reshape(*bits.shape[:-2], m8 // 8, 8, L).to(torch.int32)
    weights = (1 << torch.arange(8, dtype=torch.int32, device=bits.device))[:, None]
    # an integer sum would promote to int64; distinct powers of two sum <= 255
    return (grouped * weights).sum(dim=-2, dtype=torch.int32).to(torch.uint8)


# ---------------------------------------------------------------------------
# Gather path: direct table formulation
# ---------------------------------------------------------------------------


def gf_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Element-wise GF(2^8) product of uint8 tensors (broadcasting)."""
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    exp, log = _EXP.to(a.device), _LOG.to(a.device)
    out = exp[log[a64] + log[b64]]
    return torch.where((a64 == 0) | (b64 == 0), 0, out).to(torch.uint8)


def gf_matmul_gather(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[m, k] x [k, L] GF matmul via gathers + XOR reduction."""
    prod = gf_mul(a[:, :, None], b[None, :, :])  # [m, k, L]
    return reduce(torch.bitwise_xor, prod.unbind(1))


# ---------------------------------------------------------------------------
# Device-resident operands of one GF matrix
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GfOperand:
    """A host-static [m, k] GF(2^8) matrix and its operands on one device.

    abits:  [8m, 8k] float32 0/1 bit matrix (the plain version's operand)
    consts: the kernel's word table (see `kernel_consts`) as int32; only
            on a CUDA device
    """

    matrix: np.ndarray
    device: torch.device
    abits: torch.Tensor
    consts: Optional[torch.Tensor]
    tile_m: int

    @property
    def shape(self) -> tuple[int, int]:
        return self.matrix.shape


def choose_tile_m(m: int) -> int:
    """The kernel's row tile for m output rows: least padding, then largest."""
    return min(TILE_M, key=lambda t: (-(-m // t) * t, -t))


def kernel_consts(matrix: np.ndarray) -> tuple[np.ndarray, int]:
    """The kernel's constant table for `matrix`, and its row tile.

    Returns ([m_pad, k, 8] uint32, tile_m): word (i, j, b) holds the GF
    product A[i, j] * 2^b in each of its four bytes, and rows m..m_pad-1
    (padding to a whole number of row tiles) are zero.
    """
    matrix = np.asarray(matrix, dtype=np.uint8)
    m, k = matrix.shape
    tile_m = choose_tile_m(m)
    m_pad = -(-m // tile_m) * tile_m
    powers = (1 << np.arange(8)).astype(np.uint8)
    prod = gf256.MUL_TABLE[matrix[:, :, None], powers[None, None, :]]  # [m, k, 8]
    table = np.zeros((m_pad, k, 8), dtype=np.uint32)
    table[:m] = prod.astype(np.uint32) * np.uint32(0x01010101)
    return table, tile_m


@lru_cache(maxsize=512)
def _operand(matrix_bytes: bytes, m: int, k: int, device: torch.device) -> GfOperand:
    mat = np.frombuffer(matrix_bytes, dtype=np.uint8).reshape(m, k)
    abits = torch.from_numpy(gf256.expand_to_bit_matrix(mat).astype(np.float32))
    table, tile_m = kernel_consts(mat)
    consts = None
    if device.type == "cuda":
        consts = torch.from_numpy(table.view(np.int32)).to(device)
    return GfOperand(mat, device, abits.to(device), consts, tile_m)


def operand(matrix: np.ndarray, device) -> GfOperand:
    """The cached device operands of a host [m, k] GF(2^8) matrix."""
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    if matrix.ndim != 2:
        raise ValueError(f"expected an [m, k] matrix, got {matrix.shape}")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())  # as tensors report it
    return _operand(matrix.tobytes(), *matrix.shape, device)


MatrixLike = Union[np.ndarray, GfOperand]


def _as_operand(matrix: MatrixLike, device: torch.device) -> GfOperand:
    if isinstance(matrix, GfOperand):
        if matrix.device != device:
            raise ValueError(f"operand on {matrix.device}, data on {device}")
        return matrix
    return operand(matrix, device)


# ---------------------------------------------------------------------------
# Plain version: float32 bit product
# ---------------------------------------------------------------------------


def gf_matmul_bits_plain(matrix: MatrixLike, data: torch.Tensor) -> torch.Tensor:
    """[m, k] GF matrix x [..., k, L] uint8 data -> [..., m, L], any device.

    The kernel's plain version: a float32 0/1 bit product (exact, since
    each sum is at most 8k < 2^24), mod 2, then pack.
    """
    op = _as_operand(matrix, data.device)
    dbits = bytes_to_bits(data).to(torch.float32)
    acc = torch.matmul(op.abits, dbits)  # [..., 8m, L]
    return bits_to_bytes(torch.remainder(acc, 2.0).to(torch.uint8))


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------


def gf_matmul(
    matrix: MatrixLike, data: torch.Tensor, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """[m, k] host GF matrix x [k, L] or [B, k, L] uint8 data -> [(B,) m, L].

    For a CUDA tensor this launches csrc/gf256_matmul.cu on the current
    stream (or raises); for a CPU tensor it runs `gf_matmul_bits_plain`.
    `out`, if given, is an [(B,) m, L] uint8 tensor, possibly a strided
    view, that receives the result; it must not overlap `data`.
    """
    if data.dtype != torch.uint8:
        raise TypeError(f"expected uint8 data, got {data.dtype}")
    if data.ndim not in (2, 3):
        raise ValueError(f"expected [k, L] or [B, k, L] data, got {tuple(data.shape)}")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gf_matmul runs on cuda or cpu tensors, not {data.device}")
    op = _as_operand(matrix, data.device)
    m, k = op.shape
    if data.shape[-2] != k:
        raise ValueError(f"matrix is [{m}, {k}] but data has {data.shape[-2]} rows")
    data3 = data if data.ndim == 3 else data.unsqueeze(0)
    B, _, L = data3.shape
    if out is None:
        out3 = torch.empty((B, m, L), dtype=torch.uint8, device=data.device)
    else:
        if out.shape != data.shape[:-2] + (m, L) or out.dtype != torch.uint8:
            raise ValueError(f"out must be uint8 {(*data.shape[:-2], m, L)}")
        if out.device != data.device:
            raise ValueError(f"out on {out.device}, data on {data.device}")
        out3 = out if out.ndim == 3 else out.unsqueeze(0)
    if data.device.type == "cuda":
        _launch(op, data3, out3)
    else:
        out3.copy_(gf_matmul_bits_plain(op, data3))
    return out3 if data.ndim == 3 else out3[0]


def _launch(op: GfOperand, data: torch.Tensor, out: torch.Tensor) -> None:
    global launches
    B, k, L = data.shape
    m = op.shape[0]
    if any(s < 0 for s in data.stride()) or any(
        s <= 0 and n > 1 for s, n in zip(out.stride(), out.shape)
    ):
        raise ValueError("gf_matmul: data needs strides >= 0, out distinct elements")
    if B * L == 0:
        return
    lib = _kernels.load("gf256_matmul")
    stream = torch.cuda.current_stream(data.device).cuda_stream
    rc = lib.gf256_matmul_launch(
        data.device.index,
        op.consts.data_ptr(),
        data.data_ptr(), *data.stride(),
        out.data_ptr(), *out.stride(),
        m, k, L, B, op.tile_m,
        stream,
    )
    _kernels.check("gf256_matmul", lib, rc, "gf256_error_string")
    launches += 1
