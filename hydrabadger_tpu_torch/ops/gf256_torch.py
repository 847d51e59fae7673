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
  - `gf_matmul`:            the CUDA kernel csrc/gf256_matmul.cu (the bit
                            product on the int8 tensor cores) for a CUDA
                            tensor; the plain version for a CPU tensor

Layouts follow the JAX package: bits are LSB-first with row order
i*8 + bit, data is [k, L] or batched [B, k, L] with the shard bytes on the
last axis.  The kernel takes its own strides, so a batch may be a view.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from functools import lru_cache, reduce
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..crypto import gf256
from . import _kernels

# Kernel launches made by `gf_matmul` (one per launch, none for CPU
# tensors).  chip_smoke.py sets it to 0 before the main path and reads it
# after, to show that the path went through the kernel.
launches = 0
# Host seconds spent building operands (`operand` and `kernel_operand` on
# a cache miss); chip_smoke.py reads it around the simulator's run.
operand_s = 0.0

_EXP = torch.from_numpy(gf256.EXP_TABLE.astype(np.int64))  # [512]
_LOG = torch.from_numpy(gf256.LOG_TABLE.astype(np.int64))  # [256]

# The kernel's launch parameters: its form (0: mma.sync.m16n8k32 per warp;
# 1, 2: wgmma m64nNk32 per warpgroup, passes of N = 32, 64), warps per
# block, M tiles of 16 byte columns per warp, and data ring stages.
# csrc/gf256_matmul.cu instantiates FORM_TILES; experiments/prof_gf_tiles.py
# sweeps them at the epoch's two shapes, and these are its pick.
FORM, WARPS, M_TILES, STAGES = 1, 4, 4, 3
FORM_TILES = {0: (2, 4), 1: (2, 4), 2: (2,)}  # form -> M tiles instantiated
STAGE_COUNTS = (2, 3)
SMEM_MAX = 232_448  # dynamic shared memory one block may use on an H100
# A launch keeps one chunk of A's bits in shared memory (`chunks`): up to
# K_CHUNK_MAX data rows, and as many output rows (a multiple of 4) as fit
# B_CHUNK_MAX bytes of operand.  Every RS shape (m + k <= 255) is one K
# chunk; longer K runs as K chunks whose launches XOR into the output.
B_CHUNK_MAX = 98_304
K_CHUNK_MAX = 256


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
# The kernel's operand and launch plan
# ---------------------------------------------------------------------------


def _ceil4(x: int) -> int:
    return -(-x // 4) * 4


def b_operand(matrix: np.ndarray) -> np.ndarray:
    """A's bits as the kernel's B operand: [ceil4(k) / 4, ceil4(m), 2, 8, 16] uint8.

    One 32 x 8 int8 tile B[K, n] per K tile kt (data bytes 4kt .. 4kt + 3,
    K = 8 * byte + bit) and N tile nt = 4G + q: column n holds output byte
    4G + n // 2, bit 2q + n % 2, scaled by 2^bit (bit 7: 0x80, i.e. -128 as
    int8), so each int32 sum carries its parity at that bit.  Rows and
    columns past m and k are zero.  Entry [kt, nt, kh, n, b] is B[16 kh + b,
    n] of tile (kt, nt): wgmma's K-major layout without swizzle, 128-byte
    core matrices of 8 columns x 16 K bytes, a tile's two K halves 128 B
    apart and tiles (kt * NT + nt) * 256 B from the start.
    """
    matrix = np.asarray(matrix, dtype=np.uint8)
    m, k = matrix.shape
    mp, kp = _ceil4(m), _ceil4(k)
    bits = np.zeros((8 * mp, 8 * kp), dtype=np.int64)
    bits[: 8 * m, : 8 * k] = gf256.expand_to_bit_matrix(matrix)
    kt, nt, kh, n, b = np.ix_(np.arange(kp // 4), np.arange(mp), np.arange(2),
                              np.arange(8), np.arange(16))
    bit = 2 * (nt % 4) + n % 2
    row = 8 * (4 * (nt // 4) + n // 2) + bit
    return (bits[row, 32 * kt + 16 * kh + b] << bit).astype(np.uint8)


class Chunk(NamedTuple):
    """One launch's share of A: output rows m0:m1, data rows k0:k1."""

    m0: int
    m1: int
    k0: int
    k1: int


def chunks(m: int, k: int) -> list[Chunk]:
    """The launches of an [m, k] product, in order: K chunks of at most
    K_CHUNK_MAX rows (the first stores, the rest XOR in), each split into
    row chunks whose operand fits B_CHUNK_MAX bytes."""
    out = []
    for k0 in range(0, k, K_CHUNK_MAX):
        k1 = min(k, k0 + K_CHUNK_MAX)
        mc = max(4, B_CHUNK_MAX // (64 * _ceil4(k1 - k0)) // 4 * 4)
        out += [Chunk(m0, min(m, m0 + mc), k0, k1) for m0 in range(0, m, mc)]
    return out


class LaunchShape(NamedTuple):
    """A launch's block geometry: the kernel's form, warps, M tiles per
    warp, ring stages, the ring's row stride and the block's dynamic shared
    memory (bytes)."""

    form: int
    warps: int
    m_tiles: int
    stages: int
    row: int
    smem: int


def launch_shape(m: int, k: int, form: Optional[int] = None, warps: Optional[int] = None,
                 m_tiles: Optional[int] = None, stages: Optional[int] = None) -> LaunchShape:
    """The block geometry of one launch over an [m, k] chunk.

    Shared memory holds the operand (64 * ceil4(m) * ceil4(k) bytes) and
    `stages` ring tiles of ceil4(k) rows x `row` bytes; a row is the
    tile's 16 * m_tiles * warps columns plus one warp's 16 * m_tiles, so
    the two data rows a warp reads at once fall on different banks.
    Where the default stages do not fit, fewer are taken (at least 2).
    """
    form = FORM if form is None else form
    warps = WARPS if warps is None else warps
    m_tiles = M_TILES if m_tiles is None else m_tiles
    want = STAGES if stages is None else stages
    if m_tiles not in FORM_TILES.get(form, ()) or want not in STAGE_COUNTS or not (
            0 < warps <= 8 and (form == 0 or warps % 4 == 0)):
        raise ValueError(f"gf_matmul: no kernel instance for form {form}, {warps} warps, "
                         f"{m_tiles} M tiles, {want} stages")
    row = 16 * m_tiles * (warps + 1)
    kp = _ceil4(k)
    b_bytes = 64 * _ceil4(m) * kp
    fit = (SMEM_MAX - b_bytes) // (kp * row)
    stages = min(want, fit) if stages is None else want
    if stages < 2 or stages > fit:
        raise ValueError(f"gf_matmul: an [{m}, {k}] chunk with {warps} warps x {m_tiles} "
                         f"M tiles does not fit {SMEM_MAX} B of shared memory at 2 stages")
    return LaunchShape(form, warps, m_tiles, stages, row, b_bytes + stages * kp * row)


_override: dict = {}


@contextlib.contextmanager
def tiles(**choices):
    """Launch with another form or block geometry inside the block
    (`launch_shape`'s keywords; the sweep in experiments/prof_gf_tiles.py)."""
    saved = dict(_override)
    _override.update({k: v for k, v in choices.items() if v is not None})
    try:
        yield
    finally:
        _override.clear()
        _override.update(saved)


# ---------------------------------------------------------------------------
# Device-resident operands of one GF matrix
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GfOperand:
    """A host-static [m, k] GF(2^8) matrix and its operands on one device.

    abits:  [8m, 8k] float32 0/1 bit matrix (the plain version's operand)
    The kernel's operand of each launch chunk (`chunks`) is built on first
    use and kept (`kernel_operand`).
    """

    matrix: np.ndarray
    device: torch.device
    abits: torch.Tensor
    _bops: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def shape(self) -> tuple[int, int]:
        return self.matrix.shape

    def kernel_operand(self, chunk: "Chunk") -> torch.Tensor:
        """`b_operand` of the chunk's rows and columns, on the device."""
        global operand_s
        if chunk not in self._bops:
            t0 = time.perf_counter()
            part = self.matrix[chunk.m0:chunk.m1, chunk.k0:chunk.k1]
            self._bops[chunk] = torch.from_numpy(b_operand(part)).to(self.device)
            operand_s += time.perf_counter() - t0
        return self._bops[chunk]


@lru_cache(maxsize=512)
def _operand(matrix_bytes: bytes, m: int, k: int, device: torch.device) -> GfOperand:
    global operand_s
    t0 = time.perf_counter()
    mat = np.frombuffer(matrix_bytes, dtype=np.uint8).reshape(m, k)
    abits = torch.from_numpy(gf256.expand_to_bit_matrix(mat).astype(np.float32))
    op = GfOperand(mat, device, abits.to(device))
    operand_s += time.perf_counter() - t0
    return op


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
        if k == 0:
            out3.zero_()  # an empty sum: no launch (`chunks(m, 0)` is empty)
        else:
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
    for chunk in chunks(m, k):
        mc, kc = chunk.m1 - chunk.m0, chunk.k1 - chunk.k0
        shape = launch_shape(mc, kc, **_override)
        bop = op.kernel_operand(chunk)
        x, y = data[:, chunk.k0:chunk.k1], out[:, chunk.m0:chunk.m1]
        rc = lib.gf256_matmul_launch(
            data.device.index,
            bop.data_ptr(), bop.numel(),
            x.data_ptr(), *x.stride(),
            y.data_ptr(), *y.stride(),
            mc, kc, L, B,
            shape.form, shape.warps, shape.m_tiles, shape.stages, shape.row, shape.smem,
            int(chunk.k0 > 0),
            stream,
        )
        _kernels.check("gf256_matmul", lib, rc, "gf256_error_string")
        launches += 1
