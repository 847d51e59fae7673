"""The port's limb layouts for BLS12-381 Fp and Fp2, and the host conversions.

Counterpart of the numpy parts of hydrabadger_tpu/ops/bls_jax.py and
ops/bls_g2_jax.py (the Montgomery constants, GLV constants, int <-> limb
and point <-> limb conversions).

Layout.  A field element is 12 little-endian 32-bit words (R = 2^384,
the JAX package's R too), held as the bit pattern in int32.  A batch
keeps the lane axis last:

    field elements   [12, n]         int32
    points           [3, 12, n]      int32   (Jacobian x, y, z; Montgomery)
    Fp2 elements     [2, 12, n]      int32   (c0 + c1 u, u^2 = -1)
    G2 points        [3, 2, 12, n]   int32   (coordinate, Fp2 component,
                                              word, lane)

so neighbouring CUDA threads (lanes) read neighbouring words.  Every
value the kernels and their plain versions emit is canonical (< p), as
the JAX package's are, so a JAX array of 32 12-bit limbs and a port
array of 12 32-bit words hold the same bits: `limbs_from_jax` /
`limbs_to_jax` regroup bits and do no arithmetic.  Infinity is
x = y = R mod p (Montgomery one), z = 0; on G2 x = y = (one, 0), z = 0.
A G2 point's six Fp elements x0 x1 y0 y1 z0 z1 are thus consecutive
[12, n] blocks, and the JAX package's [B, 3, 2, 32] G2 batch regroups
into it with `g2_limbs_from_jax` / `g2_limbs_to_jax`.
"""
from __future__ import annotations

import time
from typing import Sequence

import numpy as np

from ..crypto import bls12_381 as bls
from ..crypto.bls12_381 import FQ, FQ2, P

LIMB_BITS = 32
N_LIMBS = 12  # 384 bits >= 381-bit p
R_MONT = 1 << (LIMB_BITS * N_LIMBS)  # 2^384

JAX_LIMB_BITS = 12  # the JAX package's limbs: 32 of 12 bits in int32
JAX_N_LIMBS = 32


def int_to_limbs(n: int) -> np.ndarray:
    """Python int -> [12] int32 little-endian 32-bit words."""
    if not 0 <= n < R_MONT:
        raise ValueError("out of limb range")
    return np.frombuffer(n.to_bytes(48, "little"), dtype="<u4").view(np.int32).copy()


def ints_to_limbs_batch(ns: Sequence[int]) -> np.ndarray:
    """Python ints (< 2^384) -> [len, 12] int32 words."""
    raw = b"".join(int(n).to_bytes(48, "little") for n in ns)
    return np.frombuffer(raw, dtype="<u4").view(np.int32).reshape(len(ns), N_LIMBS).copy()


def limbs_to_ints_batch(arr) -> list[int]:
    """[B, 12] words -> B Python ints."""
    arr = np.ascontiguousarray(np.asarray(arr).astype("<u4"))
    return [int.from_bytes(r.tobytes(), "little") for r in arr]


P_LIMBS = int_to_limbs(P)
ONE_MONT = int_to_limbs(R_MONT % P)
R_INV = pow(R_MONT, -1, P)

# GLV: lambda = z^2 - 1 and lambda^2 + lambda + 1 == r exactly, so any
# scalar splits as k = k1 + k2*lambda with both halves <= 129 bits by
# plain divmod; phi(x, y) = (beta*x, y) acts as multiplication by lambda.
GLV_LAMBDA = (bls.X_PARAM * bls.X_PARAM - 1) % bls.R
assert (GLV_LAMBDA * GLV_LAMBDA + GLV_LAMBDA + 1) % bls.R == 0
_g = 2
while pow(_g, (P - 1) // 3, P) == 1:
    _g += 1
_beta = pow(_g, (P - 1) // 3, P)
# two non-trivial cube roots; pick the one matching GLV_LAMBDA
_probe = bls._py_multiply(bls.G1, 12345)
_target = bls.normalize(bls._py_multiply(_probe, GLV_LAMBDA))
_aff = bls.normalize(_probe)
if _target[0] != FQ(_aff[0].n * _beta % P):
    _beta = _beta * _beta % P
assert bls.normalize((FQ(_aff[0].n * _beta % P), _aff[1], FQ(1)))[0] == _target[0]
GLV_BETA = _beta
BETA_MONT = int_to_limbs(GLV_BETA * R_MONT % P)


def _batch_inverse(vals: Sequence[int]) -> list[int]:
    """Montgomery's trick: len(vals) inverses for one pow(-1)."""
    prefix = [1]
    for v in vals:
        prefix.append(prefix[-1] * v % P)
    inv_all = pow(prefix[-1], -1, P)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = prefix[i] * inv_all % P
        inv_all = inv_all * vals[i] % P
    return out


def points_to_limbs(pts: Sequence) -> np.ndarray:
    """Host projective points -> [3, 12, B] Montgomery Jacobian words,
    normalised to Z = 1 (infinity -> x = y = one, z = 0), as
    bls_jax.points_to_limbs normalises them."""
    rp = R_MONT % P
    zs = [int(pt[2].n) for pt in pts]
    invs = iter(_batch_inverse([z for z in zs if z]))
    xs, ys, zouts = [], [], []
    for pt, z in zip(pts, zs):
        if z == 0:
            xs.append(rp)
            ys.append(rp)
            zouts.append(0)
            continue
        zi = next(invs)
        xs.append(pt[0].n * zi % P * rp % P)
        ys.append(pt[1].n * zi % P * rp % P)
        zouts.append(rp)
    words = ints_to_limbs_batch(xs + ys + zouts).reshape(3, len(pts), N_LIMBS)
    return np.ascontiguousarray(words.transpose(0, 2, 1))


# host seconds spent in limbs_to_points (chip_smoke reads and resets it)
to_points_s = 0.0


def limbs_to_points(arr) -> list:
    """[3, 12, ...] Montgomery Jacobian words -> flat list of host points
    (affine representatives, Z = 1; infinity as bls.infinity())."""
    global to_points_s
    t0 = time.perf_counter()
    arr = np.asarray(arr)
    flat = arr.reshape(3, N_LIMBS, -1)
    xs, ys, zs = (
        [v * R_INV % P for v in limbs_to_ints_batch(flat[c].T)] for c in range(3)
    )
    invs = iter(_batch_inverse([z for z in zs if z]))
    out = []
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(bls.infinity())
            continue
        zi = next(invs)
        zi2 = zi * zi % P
        out.append((FQ(x * zi2 % P), FQ(y * zi2 % P * zi % P), FQ(1)))
    to_points_s += time.perf_counter() - t0
    return out


def _fq2_batch_inverse(els: Sequence) -> list:
    """Montgomery's trick over FQ2 (one .inv() per batch)."""
    if not els:
        return []
    prefix = [els[0]]
    for e in els[1:]:
        prefix.append(prefix[-1] * e)
    inv_all = prefix[-1].inv()
    out = [None] * len(els)
    for i in range(len(els) - 1, 0, -1):
        out[i] = inv_all * prefix[i - 1]
        inv_all = inv_all * els[i]
    out[0] = inv_all
    return out


def g2_points_to_limbs(pts: Sequence) -> np.ndarray:
    """Host projective G2 points -> [3, 2, 12, B] Montgomery Jacobian
    words, normalised to Z = 1 with one batched FQ2 inversion (infinity
    -> x = y = (one, 0), z = 0), as bls_g2_jax.g2_points_to_limbs
    normalises them."""
    rp = R_MONT % P
    one = FQ2.one()
    todo = [pt[2] for pt in pts if not bls.is_inf(pt) and pt[2] != one]
    invs = iter(_fq2_batch_inverse(todo))
    cols = [[] for _ in range(6)]  # x0 x1 y0 y1 z0 z1
    for pt in pts:
        if bls.is_inf(pt):
            vals = (rp, 0, rp, 0, 0, 0)
        else:
            x, y, z = pt
            if z != one:
                zi = next(invs)
                x, y = x * zi, y * zi
            vals = (x.coeffs[0] * rp % P, x.coeffs[1] * rp % P,
                    y.coeffs[0] * rp % P, y.coeffs[1] * rp % P, rp, 0)
        for col, v in zip(cols, vals):
            col.append(v)
    words = ints_to_limbs_batch([v for col in cols for v in col]).reshape(6, len(pts), N_LIMBS)
    return np.ascontiguousarray(words.transpose(0, 2, 1)).reshape(3, 2, N_LIMBS, len(pts))


def limbs_to_g2_points(arr) -> list:
    """[3, 2, 12, ...] Montgomery Jacobian words -> flat list of host G2
    points (affine representatives, Z = 1; infinity as bls.infinity(FQ2))."""
    flat = np.asarray(arr).reshape(6, N_LIMBS, -1)
    x0, x1, y0, y1, z0, z1 = (
        [v * R_INV % P for v in limbs_to_ints_batch(flat[c].T)] for c in range(6)
    )
    zs = [FQ2([a, b]) for a, b in zip(z0, z1)]
    invs = iter(_fq2_batch_inverse([z for z in zs if not z.is_zero()]))
    out = []
    for i, z in enumerate(zs):
        if z.is_zero():
            out.append(bls.infinity(FQ2))
            continue
        zi = next(invs)
        zi2 = zi * zi
        out.append((FQ2([x0[i], x1[i]]) * zi2, FQ2([y0[i], y1[i]]) * zi2 * zi, FQ2.one()))
    return out


# ---------------------------------------------------------------------------
# Carry-across: the JAX package's 12-bit limbs <-> the port's 32-bit words
# ---------------------------------------------------------------------------


def words_from_jax_limbs(a) -> np.ndarray:
    """[..., 32] int32 12-bit limbs -> [..., 12] int32 32-bit words
    (the same 384 bits, regrouped)."""
    a = np.asarray(a)
    bits = (a[..., None].astype(np.int64) >> np.arange(JAX_LIMB_BITS)) & 1
    bits = bits.reshape(*a.shape[:-1], N_LIMBS, LIMB_BITS)
    words = (bits << np.arange(LIMB_BITS, dtype=np.int64)).sum(-1)
    return words.astype(np.uint32).view(np.int32)


def jax_limbs_from_words(w) -> np.ndarray:
    """[..., 12] int32 32-bit words -> [..., 32] int32 12-bit limbs."""
    w = np.asarray(w).astype(np.uint32).astype(np.int64)
    bits = (w[..., None] >> np.arange(LIMB_BITS)) & 1
    bits = bits.reshape(*w.shape[:-1], JAX_N_LIMBS, JAX_LIMB_BITS)
    return (bits << np.arange(JAX_LIMB_BITS, dtype=np.int64)).sum(-1).astype(np.int32)


def limbs_from_jax(points) -> np.ndarray:
    """JAX points [..., 3, 32] -> the port's [3, 12, N] with the batch
    axes flattened into the lane axis N."""
    w = words_from_jax_limbs(points)  # [..., 3, 12]
    w = w.reshape(-1, 3, N_LIMBS)
    return np.ascontiguousarray(w.transpose(1, 2, 0))


def limbs_to_jax(x, batch_shape=None) -> np.ndarray:
    """The port's [3, 12, N] -> JAX points [*batch_shape, 3, 32]
    (batch_shape defaults to (N,))."""
    x = np.asarray(x)
    n = x.shape[-1]
    out = jax_limbs_from_words(x.reshape(3, N_LIMBS, n).transpose(2, 0, 1))
    return out.reshape(*(batch_shape or (n,)), 3, JAX_N_LIMBS)


def g2_limbs_from_jax(points) -> np.ndarray:
    """JAX G2 points [..., 3, 2, 32] -> the port's [3, 2, 12, N] with the
    batch axes flattened into the lane axis N."""
    w = words_from_jax_limbs(points).reshape(-1, 3, 2, N_LIMBS)
    return np.ascontiguousarray(w.transpose(1, 2, 3, 0))


def g2_limbs_to_jax(x, batch_shape=None) -> np.ndarray:
    """The port's [3, 2, 12, N] -> JAX G2 points [*batch_shape, 3, 2, 32]
    (batch_shape defaults to (N,))."""
    x = np.asarray(x)
    n = x.shape[-1]
    out = jax_limbs_from_words(x.reshape(3, 2, N_LIMBS, n).transpose(3, 0, 1, 2))
    return out.reshape(*(batch_shape or (n,)), 3, 2, JAX_N_LIMBS)
