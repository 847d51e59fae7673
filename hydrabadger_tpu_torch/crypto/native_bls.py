"""ctypes bindings for the native BLS12-381 host library (native/bls12_381.cpp).

The port's copy of hydrabadger_tpu/crypto/native_bls.py.  This is host C++,
not a kernel: the per-frame BLS signatures and verifications of the TCP
tier, the pairing checks and the DKG's host folds and MSMs run on the
host's CPU, as in the JAX package.  `crypto/bls12_381.py` dispatches its
public group and pairing operations here; its pure-Python bodies stay as
the `_py_*` oracles.

The port builds its own library from the repo's source: at first use, g++
(or $CXX) compiles native/bls12_381.cpp with native/Makefile's flags into
build/host_native/libbls381.so through utils/host_native (a file lock, a
stamp of the source, compiler, flags and CPU features; a changed stamp
rebuilds).  There is no silent fallback: a build that fails, a library that
does not load or reports another ABI version raises, with the compiler's
output.
HYDRABADGER_NO_NATIVE_BLS=1 at import, or set_enabled(False), selects the
pure-Python path.

Point interchange format (the C ABI):
  G1: 96 bytes  big-endian affine x||y, all-zero = infinity
  G2: 192 bytes big-endian affine x0||x1||y0||y1, all-zero = infinity
"""
from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import List, Sequence, Tuple

from ..utils import host_native

LIBRARY = host_native.BLS
LIB_PATH = LIBRARY.dest
ABI_VERSION = 1

_LIB = None
_ENABLED = os.environ.get("HYDRABADGER_NO_NATIVE_BLS", "") != "1"


def _stamp(cxx: str) -> str:
    return LIBRARY.stamp(cxx)


def build_library(dest: Path = None) -> Path:
    """The built library at `dest` (default LIB_PATH), compiling it when its
    stamp does not match (utils/host_native); `LIBRARY.build_seconds` is
    this process's compile time.  Raises RuntimeError with the compiler's
    output when the build fails."""
    return LIBRARY.build(dest or LIB_PATH)


def _load():
    """The loaded library, built first where needed; raises on failure."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build_library(LIB_PATH)))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.c_int64
    for name, args, res in [
        ("bls381_version", [], ctypes.c_int),
        ("bls_g1_add", [u8p, u8p, u8p], None),
        ("bls_g1_mul", [u8p, u8p, i64, u8p], None),
        ("bls_g2_add", [u8p, u8p, u8p], None),
        ("bls_g2_mul", [u8p, u8p, i64, u8p], None),
        ("bls_g2_mul_gls", [u8p, u8p, u8p, u8p], None),
        ("bls_g1_mul_glv", [u8p, u8p, u8p, u8p], None),
        ("bls_g1_weighted_sum", [u8p, u8p, i64, i64, u8p], None),
        ("bls_g2_weighted_sum", [u8p, u8p, i64, i64, u8p], None),
        ("bls_g1_msm", [u8p, u8p, i64, u8p], None),
        ("bls_g1_fold_pow", [u8p, i64, i64, ctypes.c_uint64, i64, u8p], None),
        ("bls_g1_in_subgroup", [u8p], ctypes.c_int),
        ("bls_g2_in_subgroup", [u8p], ctypes.c_int),
        ("bls_g1_decompress", [u8p, u8p], ctypes.c_int),
        ("bls_g2_decompress", [u8p, u8p], ctypes.c_int),
        ("bls_pairing_product_check", [u8p, u8p, i64], ctypes.c_int),
        ("bls_pairing_check_eq", [u8p, u8p, u8p, u8p], ctypes.c_int),
        ("bls_hash_to_g2", [u8p, i64, u8p, i64, u8p], None),
    ]:
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res
    version = lib.bls381_version()
    if version != ABI_VERSION:
        raise RuntimeError(f"native BLS library reports ABI version {version}, want {ABI_VERSION}")
    _LIB = lib
    return _LIB


def available() -> bool:
    """True when the native path is selected (building and loading the
    library on first use, and raising if that fails); False only where
    HYDRABADGER_NO_NATIVE_BLS=1 or set_enabled(False) chose the pure path."""
    return _ENABLED and _load() is not None


def set_enabled(flag: bool) -> None:
    """Select the native (True) or the pure-Python (False) path without
    unloading the library.  Clears the hash_to_g2, signature and
    verified-frame caches, so points computed on one path cannot mask the
    other's."""
    global _ENABLED
    _ENABLED = bool(flag)
    from . import bls12_381 as bls
    from . import engine as _eng
    from . import threshold as _th

    bls._hash_cache_clear()
    _th._SIGN_CACHE.clear()
    _eng._VERIFIED_FRAMES.clear()


def _buf(raw: bytes):
    return (ctypes.c_uint8 * len(raw)).from_buffer_copy(raw)


def _out(n: int):
    return (ctypes.c_uint8 * n)()


# -- conversions (projective FQ/FQ2 tuples <-> raw affine bytes) ------------


def _g1_to_raw(pt) -> bytes:
    from . import bls12_381 as bls

    aff = bls.normalize(pt)
    if aff is None:
        return bytes(96)
    x, y = aff
    return x.n.to_bytes(48, "big") + y.n.to_bytes(48, "big")


def _g1_from_raw(raw: bytes):
    from . import bls12_381 as bls

    if not any(raw):
        return bls.infinity(bls.FQ)
    return (
        bls.FQ(int.from_bytes(raw[:48], "big")),
        bls.FQ(int.from_bytes(raw[48:], "big")),
        bls.FQ(1),
    )


def _g2_to_raw(pt) -> bytes:
    from . import bls12_381 as bls

    aff = bls.normalize(pt)
    if aff is None:
        return bytes(192)
    x, y = aff
    return (
        x.coeffs[0].to_bytes(48, "big")
        + x.coeffs[1].to_bytes(48, "big")
        + y.coeffs[0].to_bytes(48, "big")
        + y.coeffs[1].to_bytes(48, "big")
    )


def _g2_from_raw(raw: bytes):
    from . import bls12_381 as bls

    if not any(raw):
        return bls.infinity(bls.FQ2)
    return (
        bls.FQ2([
            int.from_bytes(raw[0:48], "big"),
            int.from_bytes(raw[48:96], "big"),
        ]),
        bls.FQ2([
            int.from_bytes(raw[96:144], "big"),
            int.from_bytes(raw[144:192], "big"),
        ]),
        bls.FQ2([1, 0]),
    )


def _scalar_be(n: int) -> bytes:
    """Non-negative scalar, minimal-length big-endian (>= 1 byte)."""
    return n.to_bytes(max(1, (n.bit_length() + 7) // 8), "big")


# -- group operations -------------------------------------------------------


def g1_mul(pt, n: int):
    from . import bls12_381 as bls

    lib = _load()
    if n < 0:
        pt, n = bls.neg(pt), -n
    k = _scalar_be(n)
    out = _out(96)
    lib.bls_g1_mul(_buf(_g1_to_raw(pt)), _buf(k), len(k), out)
    return _g1_from_raw(bytes(out))


def g2_mul(pt, n: int):
    from . import bls12_381 as bls

    lib = _load()
    if n < 0:
        pt, n = bls.neg(pt), -n
    k = _scalar_be(n)
    out = _out(192)
    lib.bls_g2_mul(_buf(_g2_to_raw(pt)), _buf(k), len(k), out)
    return _g2_from_raw(bytes(out))


_X_ABS = 0xD201000000010000  # |x|, the BLS parameter magnitude


def g2_mul_sub(pt, n: int):
    """[n]P for P in the r-order SUBGROUP of E'(Fp2) via 4-dim GLS.

    k mod r is written in base |x| as k0 + k1|x| + k2|x|^2 + k3|x|^3
    (exact, digits < 2^64); since x = -|x|, the x-power digits are
    (k0, -k1, k2, -k3) and [k]P = sum [d_i] psi^i(P).  ~64 doublings
    instead of 255.  Callers must not pass cofactor-component points."""
    lib = _load()
    k = n % _order()
    k1, k0 = divmod(k, _X_ABS)
    k2, k1 = divmod(k1, _X_ABS)
    k3, k2 = divmod(k2, _X_ABS)
    digs = b"".join(d.to_bytes(8, "big") for d in (k0, k1, k2, k3))
    signs = bytes([0, 1, 0, 1])  # alternating: x^i = (-|x|)^i
    out = _out(192)
    lib.bls_g2_mul_gls(_buf(_g2_to_raw(pt)), _buf(digs), _buf(signs), out)
    return _g2_from_raw(bytes(out))


def g1_mul_sub(pt, n: int):
    """[n]P for P in the r-order subgroup of E(Fp) via 2-dim GLV.

    k = k0 + k1 |x|^2 exactly with digits < 2^128; |x|^2 = x^2 = -lambda,
    so [k]P = [k0]P - [k1] phi(P).  ~128 doublings instead of 255."""
    lib = _load()
    k = n % _order()
    k1, k0 = divmod(k, _X_ABS * _X_ABS)
    digs = k0.to_bytes(16, "big") + k1.to_bytes(16, "big")
    signs = bytes([0, 1])
    out = _out(96)
    lib.bls_g1_mul_glv(_buf(_g1_to_raw(pt)), _buf(digs), _buf(signs), out)
    return _g1_from_raw(bytes(out))


def g1_add(a, b):
    lib = _load()
    out = _out(96)
    lib.bls_g1_add(_buf(_g1_to_raw(a)), _buf(_g1_to_raw(b)), out)
    return _g1_from_raw(bytes(out))


def g2_add(a, b):
    lib = _load()
    out = _out(192)
    lib.bls_g2_add(_buf(_g2_to_raw(a)), _buf(_g2_to_raw(b)), out)
    return _g2_from_raw(bytes(out))


def g1_mul_batch(points: Sequence, scalars: Sequence[int]) -> List:
    """Batch of independent G1 scalar muls via the GLV ladder.

    Scalars are reduced mod r — callers pass subgroup points only."""
    return [g1_mul_sub(p, s) for p, s in zip(points, scalars)]


def g2_mul_batch(points: Sequence, scalars: Sequence[int]) -> List:
    """Batch of independent G2 scalar muls via the GLS ladder.

    Scalars are reduced mod r — callers pass subgroup points only."""
    return [g2_mul_sub(p, s) for p, s in zip(points, scalars)]


def g1_fold_pow(
    point_matrix: Sequence[Sequence], base: int, axis: int, raw96=None
) -> List:
    """Horner fold of a G1 point matrix by powers of a SMALL base along
    `axis` (0: out[k] = sum_j P[j][k] base^j; 1: out[j] = sum_k P[j][k]
    base^k) — the DKG row/column commitment evaluations, with short
    double-and-add per step instead of full scalar muls."""
    lib = _load()
    rows = len(point_matrix)
    cols = len(point_matrix[0])
    if not 0 < base < (1 << 16):
        raise ValueError("fold base must fit 16 bits")
    raw = raw96 if raw96 is not None else b"".join(
        _g1_to_raw(p) for row in point_matrix for p in row
    )
    n_out = cols if axis == 0 else rows
    out = _out(96 * n_out)
    lib.bls_g1_fold_pow(
        _buf(raw),
        ctypes.c_int64(rows),
        ctypes.c_int64(cols),
        ctypes.c_uint64(base),
        ctypes.c_int64(axis),
        out,
    )
    return [
        _g1_from_raw(bytes(out[96 * i : 96 * (i + 1)])) for i in range(n_out)
    ]


def g1_msm(points: Sequence, scalars: Sequence[int]):
    """Pippenger multi-scalar multiplication: sum_i scalars[i] * points[i]."""
    lib = _load()
    n = len(points)
    if n == 0:
        from . import bls12_381 as bls

        return bls.infinity(bls.FQ)
    from . import bls12_381 as bls

    raw = b"".join(_g1_to_raw(p) for p in points)
    ks = b"".join((int(s) % bls.R).to_bytes(32, "big") for s in scalars)
    out = _out(96)
    lib.bls_g1_msm(_buf(raw), _buf(ks), ctypes.c_int64(n), out)
    return _g1_from_raw(bytes(out))


def g1_weighted_sum(points: Sequence, scalars: Sequence[int]):
    """Σ k_i P_i in one call (Lagrange combine in the exponent)."""
    lib = _load()
    n = len(points)
    klen = 32
    kbuf = b"".join((s % _order()).to_bytes(klen, "big") for s in scalars)
    pbuf = b"".join(_g1_to_raw(p) for p in points)
    out = _out(96)
    lib.bls_g1_weighted_sum(_buf(pbuf), _buf(kbuf), klen, n, out)
    return _g1_from_raw(bytes(out))


def g2_weighted_sum(points: Sequence, scalars: Sequence[int]):
    lib = _load()
    n = len(points)
    klen = 32
    kbuf = b"".join((s % _order()).to_bytes(klen, "big") for s in scalars)
    pbuf = b"".join(_g2_to_raw(p) for p in points)
    out = _out(192)
    lib.bls_g2_weighted_sum(_buf(pbuf), _buf(kbuf), klen, n, out)
    return _g2_from_raw(bytes(out))


def _order() -> int:
    from . import bls12_381 as bls

    return bls.R


# NB: scalar-mul entry points reduce scalars mod r, which is only valid for
# points inside the r-order subgroup.  Cofactor clearing (the one caller
# with scalars > r on non-subgroup points) goes through g1_mul/g2_mul,
# which keep the full-width scalar.


def g1_decompress(raw: bytes):
    """48-byte compressed -> projective tuple; curve + subgroup checked."""
    out = _out(96)
    if not _load().bls_g1_decompress(_buf(raw), out):
        raise ValueError("invalid G1 encoding (curve or subgroup check)")
    return _g1_from_raw(bytes(out))


def g2_decompress(raw: bytes):
    """96-byte compressed -> projective tuple; curve + subgroup checked."""
    out = _out(192)
    if not _load().bls_g2_decompress(_buf(raw), out):
        raise ValueError("invalid G2 encoding (curve or subgroup check)")
    return _g2_from_raw(bytes(out))


def g1_in_subgroup(pt) -> bool:
    return bool(_load().bls_g1_in_subgroup(_buf(_g1_to_raw(pt))))


def g2_in_subgroup(pt) -> bool:
    return bool(_load().bls_g2_in_subgroup(_buf(_g2_to_raw(pt))))


# -- pairing checks ---------------------------------------------------------


def pairing_check_eq(p1, q1, p2, q2) -> bool:
    lib = _load()
    return bool(
        lib.bls_pairing_check_eq(
            _buf(_g1_to_raw(p1)),
            _buf(_g2_to_raw(q1)),
            _buf(_g1_to_raw(p2)),
            _buf(_g2_to_raw(q2)),
        )
    )


def pairing_product_check(pairs: Sequence[Tuple]) -> bool:
    lib = _load()
    n = len(pairs)
    ps = b"".join(_g1_to_raw(p) for p, _q in pairs)
    qs = b"".join(_g2_to_raw(q) for _p, q in pairs)
    return bool(lib.bls_pairing_product_check(_buf(ps), _buf(qs), n))


# -- hashing ----------------------------------------------------------------


def hash_to_g2(msg: bytes, domain: bytes):
    lib = _load()
    out = _out(192)
    lib.bls_hash_to_g2(_buf(msg) if msg else _buf(b"\0"), len(msg),
                       _buf(domain), len(domain), out)
    return _g2_from_raw(bytes(out))
