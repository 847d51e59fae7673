"""Plain GF(2^8) and the systematic Reed-Solomon code of HoneyBadger's broadcast.

The field is GF(2)[x] / (x^8 + x^4 + x^3 + x^2 + 1) (0x11d) with generator
2, as in the reed-solomon-erasure crate that hbbft uses.  The encode matrix
is the n x k Vandermonde matrix V[i, j] = 2^(i*j), normalised so that its
top k x k block is the identity: any k of the n shards reconstruct.

Everything is NumPy over uint8 with table lookups; no byte goes through the
program under test.
"""
from __future__ import annotations

import numpy as np

POLY = 0x11D
GENERATOR = 2


def _tables():
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    exp[255:510] = exp[:255]
    return exp, log


EXP, LOG = _tables()
_A = np.arange(256)
# MUL[a, b] = a * b in GF(2^8)
MUL = np.where((_A[:, None] == 0) | (_A[None, :] == 0), 0,
               EXP[(LOG[_A[:, None]] + LOG[_A[None, :]]) % 255]).astype(np.uint8)


def inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("0 has no inverse in GF(2^8)")
    return int(EXP[(255 - LOG[a]) % 255])


def matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[m, k] x [k, c] -> [m, c] over GF(2^8): one table row per entry of
    `a`, XOR-accumulated (the columns of `b` may be many)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    for i in range(a.shape[0]):
        for j in range(a.shape[1]):
            if a[i, j]:
                out[i] ^= MUL[a[i, j]][b[j]]
    return out


def mat_inv(m: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse of a square matrix over GF(2^8)."""
    n = m.shape[0]
    aug = np.concatenate([np.asarray(m, dtype=np.uint8), np.eye(n, dtype=np.uint8)], 1)
    for col in range(n):
        pivot = next((r for r in range(col, n) if aug[r, col]), None)
        if pivot is None:
            raise ValueError("singular matrix over GF(2^8)")
        aug[[col, pivot]] = aug[[pivot, col]]
        aug[col] = MUL[inv(int(aug[col, col]))][aug[col]]
        for r in range(n):
            if r != col and aug[r, col]:
                aug[r] ^= MUL[aug[r, col]][aug[col]]
    return aug[:, n:].copy()


def encode_matrix(k: int, p: int) -> np.ndarray:
    """[k + p, k] systematic encode matrix: identity on top."""
    n = k + p
    if not (0 < k and 0 <= p and n <= 255):
        raise ValueError("need 0 < k, 0 <= p and k + p <= 255")
    vm = np.array([[EXP[(i * j) % 255] for j in range(k)] for i in range(n)], dtype=np.uint8)
    return matmul(vm, mat_inv(vm[:k]))


def decode_matrix(k: int, p: int, rows) -> np.ndarray:
    """[k, k]: the data rows from the k shards at `rows`."""
    return mat_inv(encode_matrix(k, p)[list(rows)])


def encode(data: np.ndarray, k: int, p: int) -> np.ndarray:
    """Proposals [..., k, L] -> every shard [..., k + p, L]."""
    lead, L = data.shape[:-2], data.shape[-1]
    cols = np.moveaxis(data.reshape(-1, k, L), 1, 0).reshape(k, -1)  # [k, C]
    parity = matmul(encode_matrix(k, p)[k:], cols)  # [p, C]
    parity = np.moveaxis(parity.reshape(p, -1, L), 0, 1).reshape(*lead, p, L)
    return np.concatenate([data, parity], axis=-2)


def reconstruct(shards: np.ndarray, rows, k: int, p: int) -> np.ndarray:
    """The k shards [..., k, L] found at `rows` -> the data rows [..., k, L]."""
    lead, L = shards.shape[:-2], shards.shape[-1]
    cols = np.moveaxis(shards.reshape(-1, k, L), 1, 0).reshape(k, -1)
    data = matmul(decode_matrix(k, p, rows), cols)
    return np.moveaxis(data.reshape(k, -1, L), 0, 1).reshape(*lead, k, L)


def fast_path_epoch(state: np.ndarray, k: int, p: int):
    """One fault-free HoneyBadger epoch of every instance, plainly.

    state [B, N, k, L]: node i's proposal split into k shards.  Every node
    encodes its proposal into n = k + p shards, node j receives shard j of
    every proposal, and every node rebuilds every proposal from the shards
    of the last k nodes (the parity-heavy quorum).  Returns (shards
    [B, N, n, L], decoded [B, N, k, L], total: every decode equals its
    proposal, next state): the next epoch proposes the decode rotated by
    one byte, XOR 1."""
    n = k + p
    shards = encode(state, k, p)
    decoded = reconstruct(shards[:, :, p:n], range(p, n), k, p)
    total = bool((decoded == state).all())
    return shards, decoded, total, np.roll(decoded, 1, axis=-1) ^ 1


def state_after(state0: np.ndarray, epochs: int) -> np.ndarray:
    """The state after `epochs` total epochs from `state0`: every decode
    equals its proposal, so each epoch rotates the bytes by one and XORs 1.
    tests/ hold it equal to `fast_path_epoch` iterated."""
    return np.roll(state0, epochs, axis=-1) ^ np.uint8(epochs & 1)
