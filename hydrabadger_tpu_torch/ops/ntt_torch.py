"""The transform plane: the Fr NTT's names and the GF(2^8) additive FFT.

Counterpart of hydrabadger_tpu/ops/ntt_T.py, in the port's own copy:

* **Radix-2/4 NTT over Fr** (the BLS12-381 scalar field): host Python-int
  arithmetic in ops/fr_poly, re-exported here as the plane's public names
  (`fr_ntt`, `fr_intt`, `fr_poly_mul`, `FR_TWO_ADICITY`, ...).

* **Additive (Cantor-basis) FFT over GF(2^8)**, the Reed-Solomon byte
  plane.  GF(256) admits a full Cantor basis v_1..v_8 (v_1 = 1,
  v_{i+1}^2 + v_{i+1} = v_i), under which the Gao-Mateer radix-2(x^2+x)
  recursion needs no twisting: one Taylor shuffle (pure XOR) and one
  masked table multiply per level, O(n log n) byte operations vectorised
  over the trailing axes (shard bytes x instance batch).  The numpy twins
  here (`gf_afft`, `gf_iafft`) are the host route and the plain versions
  of the device route, ops/afft_torch (torch tensor ops on the caller's
  device), which `gf_afft_dispatch` imports only when it is given a
  device: nothing the host RS route runs touches torch's device state.

Evaluation-point order: slot j of a forward transform holds the value at
`afft_points()[j]` = XOR of v_{i+1} over the set bits i of j; with m = 8
that enumerates all of GF(256), so evaluation at any point set (the RS
code's alpha^i locators) is a constant gather off the transform's output
(`afft_slot_of()[element]`).

Every dispatch notes its lanes in the process registry as JAX does:
`ntt_batch_lanes` (a gauge), `ntt_pad_lanes` and `ntt_real_lanes`.
"""
from __future__ import annotations

from functools import lru_cache
from typing import List, Optional, Sequence

import numpy as np

from ..crypto import gf256
from ..obs import metrics as M
from . import fr_poly as _frp

# ---------------------------------------------------------------------------
# Fr radix-2/4 NTT (ops/fr_poly), re-exported as the plane's public surface
# ---------------------------------------------------------------------------

FR_TWO_ADICITY = _frp.FR_TWO_ADICITY
FR_GENERATOR = _frp.FR_GENERATOR
FR_ROOT_OF_UNITY = _frp.FR_ROOT_OF_UNITY


def fr_ntt(vec: Sequence[int], invert: bool = False) -> List[int]:
    """Radix-2/4 NTT over Fr (see ops/fr_poly.fr_ntt)."""
    return _frp.fr_ntt(vec, invert)


def fr_intt(vec: Sequence[int]) -> List[int]:
    """Inverse NTT (scaled): fr_intt(fr_ntt(v)) == v."""
    return _frp.fr_intt(vec)


def fr_poly_mul(a: Sequence[int], b: Sequence[int]) -> List[int]:
    """Polynomial product over Fr via the NTT (coefficients low to high)."""
    return _frp.fr_poly_mul(a, b)


# ---------------------------------------------------------------------------
# Cantor basis for GF(2^8)
# ---------------------------------------------------------------------------

_MUL = gf256.MUL_TABLE


@lru_cache(maxsize=1)
def _cantor_plan():
    """(basis, points, pt2, slot_of): the Cantor basis v_1..v_8 under
    gf256's 0x11d representation, the transform's point order, the
    butterfly twiddles and the element -> slot permutation."""
    basis = [1]
    for _ in range(7):
        target = basis[-1]
        root = next((r for r in range(256) if (int(_MUL[r, r]) ^ r) == target), None)
        if root is None:  # pragma: no cover - the algebra guarantees a root
            raise RuntimeError(f"no Artin-Schreier root for {target}")
        basis.append(root)
    pts = np.zeros(256, dtype=np.uint8)
    for j in range(256):
        acc = 0
        for i in range(8):
            if (j >> i) & 1:
                acc ^= basis[i]
        pts[j] = acc
    if len(set(int(p) for p in pts)) != 256:  # pragma: no cover
        raise RuntimeError("Cantor basis is degenerate")
    # butterfly twiddles: the zero-v1 preimage of local point k under x^2+x
    # is pts[2k] at every level (the basis shift does not depend on depth)
    pt2 = np.asarray([pts[2 * k] for k in range(128)], dtype=np.uint8)
    slot_of = np.zeros(256, dtype=np.int64)
    for j in range(256):
        slot_of[int(pts[j])] = j
    return tuple(basis), pts, pt2, slot_of


def afft_points() -> np.ndarray:
    """[256] uint8: slot j of a forward transform evaluates at this."""
    return _cantor_plan()[1]


def afft_slot_of() -> np.ndarray:
    """[256] int: the transform output slot holding each field element."""
    return _cantor_plan()[3]


# ---------------------------------------------------------------------------
# numpy twins (the host route; the plain versions of ops/afft_torch)
# ---------------------------------------------------------------------------


def _mul_const_np(consts: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Elementwise GF product of an [h] constant vector against
    [..., h, *tail] data (constants broadcast over the other axes)."""
    shape = [1] * v.ndim
    shape[1] = len(consts)
    return _MUL[consts.reshape(shape), v]


def _taylor_np(work: np.ndarray) -> np.ndarray:
    """Taylor expansion in (x^2+x) of every block of [B, s, *tail]: blocks
    shrink s -> 4 level by level (pure XOR)."""
    b, s = work.shape[:2]
    tail = work.shape[2:]
    size = s
    while size >= 4:
        x = work.reshape((-1, size) + tail)
        q = size // 4
        a, bq, c, d = x[:, :q], x[:, q : 2 * q], x[:, 2 * q : 3 * q], x[:, 3 * q :]
        x = np.concatenate([a, bq ^ c ^ d, c ^ d, d], axis=1)
        work = x.reshape((b, s) + tail)
        size //= 2
    return work


def _itaylor_np(work: np.ndarray) -> np.ndarray:
    """Inverse of _taylor_np (ascending block sizes)."""
    b, s = work.shape[:2]
    tail = work.shape[2:]
    size = 4
    while size <= s:
        x = work.reshape((-1, size) + tail)
        q = size // 4
        a, bq, c, d = x[:, :q], x[:, q : 2 * q], x[:, 2 * q : 3 * q], x[:, 3 * q :]
        x = np.concatenate([a, bq ^ c, c ^ d, d], axis=1)  # bq ^ (c ^ d) ^ d == b
        work = x.reshape((b, s) + tail)
        size *= 2
    return work


def gf_afft(coeffs: np.ndarray, m: int) -> np.ndarray:
    """Forward additive FFT: [2^m, *tail] uint8 coefficients ->
    [2^m, *tail] evaluations at afft_points()[:2^m]."""
    pt2 = _cantor_plan()[2]
    n = 1 << m
    work = np.ascontiguousarray(coeffs, dtype=np.uint8)
    if work.shape[0] != n:
        raise ValueError(f"expected {n} coefficients, got {work.shape[0]}")
    tail = work.shape[1:]
    work = work.reshape((1, n) + tail)
    # down pass: Taylor shuffle and even/odd split, all subproblems batched
    s = n
    while s >= 2:
        work = _taylor_np(work)
        b = work.shape[0]
        w2 = work.reshape((b, s // 2, 2) + tail)
        work = np.stack((w2[:, :, 0], w2[:, :, 1]), axis=1).reshape((2 * b, s // 2) + tail)
        s //= 2
    # up pass: butterflies with the depth-free pt2 twiddles
    b, h = n, 1
    vals = work
    while h < n:
        b2 = b // 2
        w = vals.reshape((b2, 2, h) + tail)
        u, v = w[:, 0], w[:, 1]
        w0 = u ^ _mul_const_np(pt2[:h], v)
        vals = np.stack((w0, w0 ^ v), axis=2).reshape((b2, 2 * h) + tail)
        b, h = b2, 2 * h
    return vals.reshape((n,) + tail)


def gf_iafft(vals: np.ndarray, m: int) -> np.ndarray:
    """Inverse additive FFT: gf_iafft(gf_afft(c, m), m) == c."""
    pt2 = _cantor_plan()[2]
    n = 1 << m
    work = np.ascontiguousarray(vals, dtype=np.uint8)
    if work.shape[0] != n:
        raise ValueError(f"expected {n} values, got {work.shape[0]}")
    tail = work.shape[1:]
    work = work.reshape((1, n) + tail)
    # down pass: inverse butterflies
    b, h = 1, n
    while h > 1:
        w = work.reshape((b, h // 2, 2) + tail)
        v = w[:, :, 0] ^ w[:, :, 1]
        u = w[:, :, 0] ^ _mul_const_np(pt2[: h // 2], v)
        work = np.stack((u, v), axis=1).reshape((2 * b, h // 2) + tail)
        b, h = 2 * b, h // 2
    # up pass: merge the (g0, g1) pairs and undo the Taylor shuffle
    s = 1
    while s < n:
        b2 = work.shape[0] // 2
        w = work.reshape((b2, 2, s) + tail)
        merged = np.stack((w[:, 0], w[:, 1]), axis=2).reshape((b2, 2 * s) + tail)
        work = _itaylor_np(merged)
        s *= 2
    return work.reshape((n,) + tail)


# ---------------------------------------------------------------------------
# Dispatch and lane accounting
# ---------------------------------------------------------------------------


def _note_lanes(n_lanes: int, real: int) -> None:
    reg = M.default_registry()
    reg.gauge(M.NTT_BATCH_LANES).track(n_lanes)
    reg.counter(M.NTT_PAD_LANES).inc(max(0, n_lanes - real))
    reg.counter(M.NTT_REAL_LANES).inc(real)


def gf_afft_dispatch(coeffs: np.ndarray, m: int, real_rows: int,
                     device: Optional[object] = None) -> np.ndarray:
    """One batched forward transform with lane accounting: on `device`
    (a torch device, the GPU engine's) through ops/afft_torch, or, with
    no device, through the numpy twin.  `real_rows` counts the coefficient
    rows that are not padding, for the occupancy counters."""
    tail_lanes = int(np.prod(coeffs.shape[1:], dtype=np.int64)) or 1
    _note_lanes((1 << m) * tail_lanes, real_rows * tail_lanes)
    if device is None:
        return gf_afft(coeffs, m)
    import torch

    from . import afft_torch

    x = torch.from_numpy(np.ascontiguousarray(coeffs, dtype=np.uint8)).to(device)
    return afft_torch.afft_fwd(x, m).cpu().numpy()
