"""GF(2^8)-linear shard sketches — the homomorphic hash of the low-comm
reliable broadcast (the port's copy of hydrabadger_tpu/crypto/homhash.py).

    sketch(s) = s . M(seed)        M(seed) in GF(2^8)^[L, D]

`M` is a public matrix derived from `seed` in counter mode, so the sketch
is GF(2^8)-linear in the shard and every shard of a codeword is sketched
by the same map: one batched GF product checks all peers' shards at once.
Because `M` is public, the sketch is a filter against garbage shards,
never the safety anchor: the low-comm Broadcast re-derives the SHA-256
payload hash and commitment from every decoded payload.

This module is the host engine's path and the oracle of the device twin
(ops/homhash_torch, kernel B1); its products run in the host GF(2^8)
library (`crypto/_native`), as the JAX package's do.
"""
from __future__ import annotations

import hashlib
from functools import lru_cache
from typing import List, Sequence

import numpy as np

from . import _native

# sketch width in GF(2^8) symbols: 2^-64 per random forgery
SKETCH_BYTES = 8

_DOMAIN = b"hbtpu-homhash-v1"


@lru_cache(maxsize=512)
def _matrix_T(seed: bytes, length: int) -> np.ndarray:
    """[SKETCH_BYTES, length] transposed sketch matrix for `seed`.

    Digest c of SHA-256(domain || seed || c) supplies rows 4c .. 4c+3 of the
    un-transposed [L, D] matrix.  Digests do not depend on the length, so
    the matrix of a longer length is a strict extension: zero bytes
    appended to the shards leave every sketch unchanged."""
    per = 32 // SKETCH_BYTES  # rows per digest
    rows = bytearray()
    for c in range(-(-length // per)):
        rows += hashlib.sha256(_DOMAIN + seed + c.to_bytes(4, "big")).digest()
    m = np.frombuffer(bytes(rows), dtype=np.uint8)[: length * SKETCH_BYTES]
    out = np.ascontiguousarray(m.reshape(length, SKETCH_BYTES).T)
    out.flags.writeable = False
    return out


def matrix_T(seed: bytes, length: int) -> np.ndarray:
    """The cached, read-only [SKETCH_BYTES, length] matrix of `seed`."""
    return _matrix_T(bytes(seed), int(length))


def sketch_batch_np(shards: np.ndarray, seed: bytes) -> np.ndarray:
    """[B, L] uint8 shards -> [B, SKETCH_BYTES] sketches, one host product."""
    shards = np.ascontiguousarray(shards, dtype=np.uint8)
    if shards.ndim != 2:
        raise ValueError(f"expected [B, L] shards, got {shards.shape}")
    if shards.shape[1] == 0:
        return np.zeros((shards.shape[0], SKETCH_BYTES), dtype=np.uint8)
    out = _native.gf_matmul(matrix_T(seed, shards.shape[1]), np.ascontiguousarray(shards.T))
    return np.ascontiguousarray(out.T)


def sketch_shards(shards: Sequence[bytes], seed: bytes) -> List[bytes]:
    """Equal-length byte shards -> their SKETCH_BYTES-byte digests."""
    if not shards:
        return []
    arr = np.stack([np.frombuffer(s, dtype=np.uint8) for s in shards])
    out = sketch_batch_np(arr, seed)
    return [out[i].tobytes() for i in range(out.shape[0])]
