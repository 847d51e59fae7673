"""GF(2^8) arithmetic — the field under Reed-Solomon erasure coding.

The port's own copy of `hydrabadger_tpu/crypto/gf256.py` (the port
imports nothing of the JAX package): same polynomial, tables and
functions, plain numpy.  tests/test_torch_gf256.py holds every table and
function equal to the original.

We use the primitive polynomial x^8 + x^4 + x^3 + x^2 + 1 (0x11d) with
generator alpha = 2, the conventional choice for RS erasure codes.  All
host-side ops are vectorised numpy over uint8; the CUDA path
(hydrabadger_tpu_torch.ops.gf256_torch) is built from the same tables.
"""
from __future__ import annotations

import numpy as np

POLY = 0x11D  # primitive polynomial for GF(2^8)
GENERATOR = 2

# ---------------------------------------------------------------------------
# Table construction (runs once at import; ~microseconds)
# ---------------------------------------------------------------------------


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, dtype=np.uint8)  # doubled so exp[log a + log b] works
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    for i in range(255, 512):
        exp[i] = exp[i - 255]
    return exp, log


EXP_TABLE, LOG_TABLE = _build_tables()

# Full 256x256 multiplication table — used by tests and by bit_matrix_of_const.
_A = np.arange(256, dtype=np.int32)
MUL_TABLE = np.where(
    (_A[:, None] == 0) | (_A[None, :] == 0),
    0,
    EXP_TABLE[(LOG_TABLE[_A[:, None]] + LOG_TABLE[_A[None, :]]) % 255],
).astype(np.uint8)


# ---------------------------------------------------------------------------
# Scalar / vector ops
# ---------------------------------------------------------------------------


def add(a, b):
    """Addition in GF(2^8) is XOR."""
    return np.bitwise_xor(a, b)


def mul(a, b) -> np.ndarray:
    """Element-wise product over GF(2^8); accepts scalars or uint8 arrays."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    out = EXP_TABLE[LOG_TABLE[a.astype(np.int32)] + LOG_TABLE[b.astype(np.int32)]]
    return np.where((a == 0) | (b == 0), 0, out).astype(np.uint8)


def inv(a) -> np.ndarray:
    a = np.asarray(a, dtype=np.uint8)
    if np.any(a == 0):
        raise ZeroDivisionError("inverse of 0 in GF(2^8)")
    return EXP_TABLE[255 - LOG_TABLE[a.astype(np.int32)]].astype(np.uint8)


def div(a, b) -> np.ndarray:
    """Element-wise quotient a / b over GF(2^8); b = 0 raises."""
    b = np.asarray(b, dtype=np.uint8)
    return mul(a, inv(b))


def pow_(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(EXP_TABLE[(int(LOG_TABLE[a]) * n) % 255])


# ---------------------------------------------------------------------------
# Matrix ops (the RS workhorses)
# ---------------------------------------------------------------------------


def matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix product: XOR-accumulate of element products.

    a: [m, k] uint8, b: [k, n] uint8 -> [m, n] uint8.  Vectorised as a
    log-gather + exp-gather + XOR-reduction; this is the exact computation
    the CUDA kernel (csrc/gf256_matmul.cu) reproduces.
    """
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    la = LOG_TABLE[a.astype(np.int32)]  # [m, k]
    lb = LOG_TABLE[b.astype(np.int32)]  # [k, n]
    prod = EXP_TABLE[la[:, :, None] + lb[None, :, :]]  # [m, k, n]
    prod = np.where((a[:, :, None] == 0) | (b[None, :, :] == 0), 0, prod)
    return np.bitwise_xor.reduce(prod.astype(np.uint8), axis=1)


def matvec(a: np.ndarray, v: np.ndarray) -> np.ndarray:
    """[m, k] x [k] -> [m]: the matrix product with one column."""
    return matmul(a, v[:, None])[:, 0]


def mat_inv(m: np.ndarray) -> np.ndarray:
    """Invert a square matrix over GF(2^8) by Gauss-Jordan elimination.

    Raises ValueError if singular.  Used during RS reconstruction to invert
    the surviving-rows submatrix of the encode matrix.
    """
    m = np.array(m, dtype=np.uint8, copy=True)
    n = m.shape[0]
    if m.shape != (n, n):
        raise ValueError("matrix must be square")
    aug = np.concatenate([m, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivot = None
        for r in range(col, n):
            if aug[r, col] != 0:
                pivot = r
                break
        if pivot is None:
            raise ValueError("singular matrix over GF(2^8)")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        aug[col] = mul(aug[col], inv(aug[col, col]))
        mask = aug[:, col] != 0
        mask[col] = False
        if np.any(mask):
            factors = aug[mask, col][:, None]
            aug[mask] = add(aug[mask], mul(factors, aug[col][None, :]))
    return aug[:, n:]


def vandermonde(rows: int, cols: int) -> np.ndarray:
    """V[i, j] = alpha^(i*j) — full-rank for rows <= 255."""
    out = np.zeros((rows, cols), dtype=np.uint8)
    for i in range(rows):
        for j in range(cols):
            out[i, j] = pow_(GENERATOR, i * j)
    return out


def bit_matrix_of_const(c: int) -> np.ndarray:
    """GF(2)-linear 8x8 bit matrix M s.t. bits(c*x) = M @ bits(x) mod 2.

    Column j of M is bits(c * 2^j).  This is what lets a whole GF(2^8)
    matrix multiply be written as an integer matmul mod 2 (the plain
    version in ops/gf256_torch.py).
    """
    m = np.zeros((8, 8), dtype=np.uint8)
    for j in range(8):
        prod = int(MUL_TABLE[c, 1 << j])
        for i in range(8):
            m[i, j] = (prod >> i) & 1
    return m


def expand_to_bit_matrix(gf_matrix: np.ndarray) -> np.ndarray:
    """Lift an [m, k] GF(2^8) matrix to its [8m, 8k] GF(2) bit matrix."""
    gf_matrix = np.asarray(gf_matrix, dtype=np.uint8)
    m, k = gf_matrix.shape
    out = np.zeros((8 * m, 8 * k), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            out[8 * i : 8 * i + 8, 8 * j : 8 * j + 8] = bit_matrix_of_const(
                int(gf_matrix[i, j])
            )
    return out
