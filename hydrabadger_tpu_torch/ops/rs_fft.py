"""FFT-backed Reed-Solomon encode and reconstruct over GF(2^8), byte-
identical to the matrix route of crypto/rs.py.

The port's own copy of hydrabadger_tpu/ops/rs_fft.py.  The systematic
encode matrix of crypto/rs.py is the interpolate-then-evaluate map:
parity row i holds f(alpha^{k+i}), where f is the unique degree-<k
polynomial through (alpha^j, data_j).  This module computes that same map
transform-side:

  1. interpolate f from the k data (or survivor) locators through a
     subproduct tree: the Lagrange numerators combine bottom-up, every
     product through the Cantor-basis additive FFT (ops/ntt_torch), so
     interpolation costs O(k log^2 k) byte operations per column instead
     of the matrix route's O(k^2);
  2. one forward transform of f evaluates it at all 256 field elements;
     the wanted rows (parity locators, erased rows) are a constant gather
     off its output.

Both steps are exact GF(2^8) arithmetic, so the bytes equal the matrix
route's (tests/test_torch_ntt.py, at every tier-1 geometry): every node
must derive identical shards whatever its route.

Batch shape: the coefficients carry arbitrary trailing axes ([L] for one
instance, [B, L] for a batch), so a whole batch rides one pipeline, the
batch being the transform's lane axis.  Where JAX probes for a TPU backend
(`_use_device`), the port takes an explicit `device`: the host routes
(crypto/rs) pass none and stay numpy, and only the GPU engine passes its
device, on which the dominant forward transform then runs
(ops/afft_torch).  Nothing on the host route touches torch's device state.

Plans (tree, derivative values, locator slots) are cached per geometry:
per (k, p) for encode, per (k, p, survivor rows) for reconstruct.
"""
from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np

from ..crypto import gf256
from . import ntt_torch

_MUL = gf256.MUL_TABLE

# schoolbook-vs-transform cutoff for polynomial products (result
# length); transform overhead loses below this on host numpy
_MUL_CUTOFF = 32


def _poly_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(2^8) polynomial product; operands are [la, *tail] /
    [lb, *tail'] with broadcastable tails (scalar polys have none)."""
    la, lb = a.shape[0], b.shape[0]
    res_len = la + lb - 1
    # rank-align the tails (scalar tree polys against batched data):
    # leading length-1 axes broadcast without replicating the data
    rank = max(a.ndim, b.ndim)
    if a.ndim < rank:
        a = a.reshape((la,) + (1,) * (rank - a.ndim) + a.shape[1:])
    if b.ndim < rank:
        b = b.reshape((lb,) + (1,) * (rank - b.ndim) + b.shape[1:])
    if res_len <= _MUL_CUTOFF:
        tail = np.broadcast_shapes(a.shape[1:], b.shape[1:])
        out = np.zeros((res_len,) + tail, dtype=np.uint8)
        for i in range(la):
            out[i : i + lb] ^= _MUL[a[i], b]
        return out
    if res_len > 256:  # pragma: no cover - callers keep products < 256
        raise ValueError("GF(256) transform caps products at 256 coeffs")
    m = (res_len - 1).bit_length()
    n = 1 << m
    pad_a = np.zeros((n,) + a.shape[1:], dtype=np.uint8)
    pad_a[:la] = a
    pad_b = np.zeros((n,) + b.shape[1:], dtype=np.uint8)
    pad_b[:lb] = b
    ea = ntt_torch.gf_afft(pad_a, m)
    eb = ntt_torch.gf_afft(pad_b, m)
    return ntt_torch.gf_iafft(_MUL[ea, eb], m)[:res_len]


def _build_tree(xs: Sequence[int]) -> List[List[np.ndarray]]:
    """Subproduct tree over the locators: level 0 holds the monic
    linears (x + x_i), each later level pairwise products (odd tails
    carry up unpaired)."""
    level = [
        np.asarray([x, 1], dtype=np.uint8) for x in xs
    ]
    tree = [level]
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level) - 1, 2):
            nxt.append(_poly_mul(level[i], level[i + 1]))
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
        tree.append(level)
    return tree


def _eval_everywhere(
    poly: np.ndarray, real_rows: int, device=None
) -> np.ndarray:
    """[<=256, *tail] coefficients -> [256, *tail] values indexed by
    AFFT slot; the dominant dispatch (lane-accounted in ntt_torch), on
    `device` where one is given."""
    pad = np.zeros((256,) + poly.shape[1:], dtype=np.uint8)
    pad[: poly.shape[0]] = poly
    return ntt_torch.gf_afft_dispatch(pad, 8, real_rows, device)


@lru_cache(maxsize=256)
def _locators(n: int) -> Tuple[int, ...]:
    """alpha^i for i < n — the evaluation points of encode_matrix's
    Vandermonde construction."""
    return tuple(
        gf256.pow_(gf256.GENERATOR, i) for i in range(n)
    )


class _Plan:
    """Interpolation plan for one locator subset: tree + scaled-
    Lagrange constants, reused across calls (geometry-cached)."""

    __slots__ = ("xs", "tree", "inv_da", "k")

    def __init__(self, xs: Sequence[int]):
        self.xs = tuple(int(x) for x in xs)
        self.k = len(self.xs)
        self.tree = _build_tree(self.xs)
        root = self.tree[-1][0]
        # A'(x) in char 2: the odd-degree coefficients of A
        da = np.asarray(
            [root[i] if i % 2 == 1 else 0 for i in range(1, len(root))],
            dtype=np.uint8,
        )
        vals = ntt_torch.gf_afft(
            np.concatenate(
                [da, np.zeros(256 - len(da), dtype=np.uint8)]
            ),
            8,
        )
        slot = ntt_torch.afft_slot_of()
        da_at = vals[slot[list(self.xs)]]
        self.inv_da = gf256.inv(da_at)  # [k]

    def interpolate(self, ys: np.ndarray) -> np.ndarray:
        """[k, *tail] values at self.xs -> [<=k, *tail] coefficients
        of the unique degree-<k interpolant (exact)."""
        c = _MUL[self.inv_da.reshape((self.k,) + (1,) * (ys.ndim - 1)), ys]
        tail = ys.shape[1:]
        # climb: N_parent = N_left * A_right + N_right * A_left
        level_n = [c[i : i + 1] for i in range(self.k)]
        for d in range(len(self.tree) - 1):
            polys = self.tree[d]
            nxt = []
            for i in range(0, len(polys) - 1, 2):
                left = _poly_mul(level_n[i], polys[i + 1])
                right = _poly_mul(level_n[i + 1], polys[i])
                ln = max(left.shape[0], right.shape[0])
                acc = np.zeros((ln,) + tail, dtype=np.uint8)
                acc[: left.shape[0]] ^= left
                acc[: right.shape[0]] ^= right
                nxt.append(acc)
            if len(polys) % 2:
                nxt.append(level_n[-1])
            level_n = nxt
        return level_n[0]


@lru_cache(maxsize=256)
def _encode_plan(k: int, p: int) -> Tuple[_Plan, np.ndarray, np.ndarray]:
    """(plan over the k data locators, parity slots, data slots)."""
    xs = _locators(k + p)
    slot = ntt_torch.afft_slot_of()
    return (
        _Plan(xs[:k]),
        slot[list(xs[k:])],
        slot[list(xs[:k])],
    )


@lru_cache(maxsize=512)
def _reconstruct_plan(
    k: int, p: int, rows: Tuple[int, ...]
) -> Tuple[_Plan, np.ndarray]:
    """(plan over the survivor locators, slot of every codeword row)."""
    xs = _locators(k + p)
    slot = ntt_torch.afft_slot_of()
    return _Plan([xs[r] for r in rows]), slot[list(xs)]


def encode_parity(
    data: np.ndarray, data_shards: int, parity_shards: int, device=None
) -> np.ndarray:
    """[k, *tail] data rows -> [p, *tail] parity rows, byte-identical
    to ``encode_matrix[k:] @ data``."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    plan, parity_slots, _data_slots = _encode_plan(
        data_shards, parity_shards
    )
    f = plan.interpolate(data)
    vals = _eval_everywhere(f, f.shape[0], device)
    return vals[parity_slots]


def encode_batch(
    data: np.ndarray, data_shards: int, parity_shards: int, device=None
) -> np.ndarray:
    """[B, k, L] -> [B, k+p, L]: the whole batch folds into the
    transform's tail axes (quorum size is the transform length, batch
    the lane width): one pipeline, one forward transform on `device`."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    if data.ndim != 3 or data.shape[1] != data_shards:
        raise ValueError(
            f"expected [B, {data_shards}, L], got {data.shape}"
        )
    rows = np.moveaxis(data, 1, 0)  # [k, B, L]
    parity = encode_parity(rows, data_shards, parity_shards, device)
    return np.concatenate([data, np.moveaxis(parity, 0, 1)], axis=1)


def reconstruct_rows(
    surviving: np.ndarray,
    rows: Sequence[int],
    want_rows: Sequence[int],
    data_shards: int,
    parity_shards: int,
    device=None,
) -> np.ndarray:
    """Recover codeword rows ``want_rows`` from the k survivor rows
    ``rows`` ([k, *tail] values): interpolate once, evaluate
    everywhere, gather — byte-identical to the matrix-inverse route."""
    surviving = np.ascontiguousarray(surviving, dtype=np.uint8)
    rows = tuple(int(r) for r in rows)
    if len(rows) != data_shards or surviving.shape[0] != data_shards:
        raise ValueError(
            f"need exactly {data_shards} survivor rows, got {len(rows)}"
        )
    plan, all_slots = _reconstruct_plan(
        data_shards, parity_shards, rows
    )
    f = plan.interpolate(surviving)
    vals = _eval_everywhere(f, f.shape[0], device)
    return vals[all_slots[list(want_rows)]]
