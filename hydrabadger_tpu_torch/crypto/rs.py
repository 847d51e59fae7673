"""Systematic Reed-Solomon erasure coding over GF(2^8), host numpy.

The port's own copy of the matrix route of `hydrabadger_tpu/crypto/rs.py`:
a proposal is split into `data_shards` pieces, extended with
`parity_shards` parity pieces, and any `data_shards` of the
`data_shards + parity_shards` total reconstruct the original;
`encode_bytes` / `reconstruct_data` do it for a byte payload, as the
consensus cores' Broadcast calls them.

Encoding matrix: Vandermonde V[n, k] normalised so the top k x k block is
the identity (systematic), so every k x k submatrix is invertible.

Every encode and reconstruct product of the matrix route runs in the host
GF(2^8) library (`crypto/_native`, native/gf256_rs.cpp), as the JAX
package's does; the matrices themselves come from `gf256`.  This module
builds the encode and decode matrices that the device path (ops/rs_torch.py)
uploads, and it is the oracle of `sim/tensor.cpu_fast_path_epoch`.

The FFT route (JAX `crypto/rs._route_ntt`): from `_ntt_min_shards()` total
shards the encode, reconstruct and verify maps run through the additive
FFT plane (ops/rs_fft, host numpy here: the host route never touches a
card), byte-identical to the matrix route.  The threshold is keyed on the
host library as JAX keys it on its native library: where the library is
built the route never fires by default (the matrix route wins at every
n <= 255); without it, from 128 shards.  `HYDRABADGER_NTT_MIN_SHARDS`
overrides the threshold and `HYDRABADGER_NTT=0` pins the matrix route.
"""
from __future__ import annotations

import os
from functools import lru_cache
from typing import Optional, Sequence

import numpy as np

from . import _native, gf256


class ReedSolomonError(ValueError):
    pass


_NTT_OFF_THRESHOLD = 1 << 30  # never routes: n is capped at 255


def ntt_enabled() -> bool:
    return os.environ.get("HYDRABADGER_NTT", "1") != "0"


def _ntt_min_shards() -> int:
    env = os.environ.get("HYDRABADGER_NTT_MIN_SHARDS", "")
    if env:
        return int(env)
    return 128 if not _native.native_available() else _NTT_OFF_THRESHOLD


@lru_cache(maxsize=256)
def encode_matrix(data_shards: int, parity_shards: int) -> np.ndarray:
    """[n, k] systematic encode matrix: identity on top, parity rows below."""
    n = data_shards + parity_shards
    if data_shards <= 0 or parity_shards < 0:
        raise ReedSolomonError("shard counts must be positive")
    if n > 255:
        raise ReedSolomonError("total shards must be <= 255 for GF(2^8)")
    vm = gf256.vandermonde(n, data_shards)
    top_inv = gf256.mat_inv(vm[:data_shards])
    mat = gf256.matmul(vm, top_inv)
    mat.flags.writeable = False
    return mat


@lru_cache(maxsize=512)
def decode_matrix(data_shards: int, parity_shards: int, rows: tuple) -> np.ndarray:
    """[k, k] GF matrix recovering the k data rows from survivor `rows`."""
    sub = encode_matrix(data_shards, parity_shards)[list(rows)]
    inv = gf256.mat_inv(sub)
    inv.flags.writeable = False
    return inv


class ReedSolomon:
    """Erasure codec with the same contract as reed-solomon-erasure."""

    def __init__(self, data_shards: int, parity_shards: int):
        self.data_shards = int(data_shards)
        self.parity_shards = int(parity_shards)
        self.total_shards = self.data_shards + self.parity_shards
        self.matrix = encode_matrix(self.data_shards, self.parity_shards)

    def _route_ntt(self) -> bool:
        """Route this codec's geometry through the FFT plane?"""
        return (
            self.parity_shards > 0
            and self.total_shards >= _ntt_min_shards()
            and ntt_enabled()
        )

    def _parity_of(self, data: np.ndarray) -> np.ndarray:
        """[k, L] -> [p, L] parity rows; both routes give the same bytes."""
        if self._route_ntt():
            from ..ops import rs_fft

            return rs_fft.encode_parity(data, self.data_shards, self.parity_shards)
        return _native.gf_matmul(self.matrix[self.data_shards :], data)

    def encode(self, data: np.ndarray) -> np.ndarray:
        """data: [k, shard_len] uint8 -> [n, shard_len] (data rows + parity)."""
        data = np.ascontiguousarray(data, dtype=np.uint8)
        if data.ndim != 2 or data.shape[0] != self.data_shards:
            raise ReedSolomonError(
                f"expected [{self.data_shards}, L] data, got {data.shape}"
            )
        return np.concatenate([data, self._parity_of(data)], axis=0)

    def encode_bytes(self, payload: bytes) -> list[bytes]:
        """Pad and split a byte string into n shards (shards 0..k-1 carry
        data): a 4-byte big-endian length prefix, the payload, zeros to a
        multiple of data_shards (hbbft broadcast's layout)."""
        prefixed = len(payload).to_bytes(4, "big") + payload
        shard_len = -(-len(prefixed) // self.data_shards)
        padded = prefixed + b"\0" * (shard_len * self.data_shards - len(prefixed))
        data = np.frombuffer(padded, dtype=np.uint8).reshape(self.data_shards, shard_len)
        full = self.encode(data)
        return [full[i].tobytes() for i in range(self.total_shards)]

    def reconstruct(
        self, shards: Sequence[Optional[np.ndarray]], data_only: bool = False
    ) -> list[np.ndarray]:
        """Fill in missing (None) shards; needs >= data_shards present."""
        if len(shards) != self.total_shards:
            raise ReedSolomonError(
                f"expected {self.total_shards} shard slots, got {len(shards)}"
            )
        present = [i for i, s in enumerate(shards) if s is not None]
        if len(present) < self.data_shards:
            raise ReedSolomonError(
                f"need {self.data_shards} shards, have {len(present)}"
            )
        arrs = {}
        shard_len = None
        for i in present:
            a = np.ascontiguousarray(shards[i], dtype=np.uint8)
            if a.ndim != 1:
                raise ReedSolomonError("shards must be 1-D uint8")
            if shard_len is None:
                shard_len = a.shape[0]
            elif a.shape[0] != shard_len:
                raise ReedSolomonError("shard length mismatch")
            arrs[i] = a

        out: list[Optional[np.ndarray]] = [
            arrs.get(i) for i in range(self.total_shards)
        ]
        if self._route_ntt():
            # one interpolation and one forward transform recover every
            # missing row, data and parity, as the matrix route's bytes
            from ..ops import rs_fft

            missing = [
                i
                for i in range(self.data_shards if data_only else self.total_shards)
                if out[i] is None
            ]
            if missing:
                rows = present[: self.data_shards]
                stacked = np.stack([arrs[i] for i in rows])  # [k, L]
                recovered = rs_fft.reconstruct_rows(
                    stacked, rows, missing, self.data_shards, self.parity_shards
                )
                for row, i in enumerate(missing):
                    out[i] = recovered[row]
            return [o for o in out if o is not None] if data_only else out  # type: ignore
        missing_data = [i for i in range(self.data_shards) if out[i] is None]
        if missing_data:
            rows = tuple(present[: self.data_shards])
            inv = decode_matrix(self.data_shards, self.parity_shards, rows)
            stacked = np.stack([arrs[i] for i in rows])  # [k, L]
            recovered = _native.gf_matmul(inv[missing_data], stacked)
            for row, i in enumerate(missing_data):
                out[i] = recovered[row]
        if not data_only:
            missing_parity = [
                i for i in range(self.data_shards, self.total_shards) if out[i] is None
            ]
            if missing_parity:
                data = np.stack(out[: self.data_shards])
                recovered = _native.gf_matmul(self.matrix[missing_parity], data)
                for row, i in enumerate(missing_parity):
                    out[i] = recovered[row]
        return [o for o in out if o is not None] if data_only else out  # type: ignore

    def reconstruct_data(self, shards: Sequence[Optional[bytes]]) -> bytes:
        """Recover the payload of `encode_bytes` from >= k shards (bytes or None)."""
        arrays = [np.frombuffer(s, dtype=np.uint8) if s is not None else None for s in shards]
        full = self.reconstruct(arrays, data_only=True)
        joined = b"".join(full[i].tobytes() for i in range(self.data_shards))
        length = int.from_bytes(joined[:4], "big")
        if length > len(joined) - 4:
            raise ReedSolomonError("corrupt length prefix")
        return joined[4 : 4 + length]

    def verify(self, shards: Sequence[np.ndarray]) -> bool:
        """Check parity rows match the data rows (the parity recomputed on
        the route encode takes)."""
        data = np.stack(
            [np.asarray(s, dtype=np.uint8) for s in shards[: self.data_shards]]
        )
        got = np.stack(
            [np.asarray(s, dtype=np.uint8) for s in shards[self.data_shards :]]
        )
        return bool(np.array_equal(self._parity_of(data), got))
