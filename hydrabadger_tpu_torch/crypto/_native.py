"""The host GF(2^8) library: native/gf256_rs.cpp behind ctypes.

The port's copy of hydrabadger_tpu/crypto/_native.py: the host RS codec
(`crypto/rs.py`) and the sketches' host twin (`crypto/homhash.py`) run
their GF(2^8) products here, in C++, as the JAX package's do.  The library
is built from the repo's source into build/host_native/libgf256_rs.so at
first use (utils/host_native); a build or load that fails raises, and there
is no path override: nothing but that build is loaded.  `gf256.matmul`
stays the oracle, equal byte for byte.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..utils import host_native

_LIB = None


def _load():
    """The loaded library, built first where needed; raises on failure."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(host_native.GF.build()))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.gf256_matmul.argtypes = [u8p, u8p, u8p, ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int64]
        lib.gf256_matmul.restype = None
        _LIB = lib
    return _LIB


def native_available() -> bool:
    """Is the host library built and loaded (building it here if needed)?
    crypto/rs keys its FFT-route threshold on this, as the JAX package
    keys it on its native library; a failed build answers False here and
    still raises at the first product."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[m, k] x [k, n] GF(2^8) matmul in the host library."""
    a = np.ascontiguousarray(a, dtype=np.uint8)
    b = np.ascontiguousarray(b, dtype=np.uint8)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gf_matmul: shapes {a.shape} x {b.shape}")
    m, k = a.shape
    n = b.shape[1]
    out = np.empty((m, n), dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    _load().gf256_matmul(a.ctypes.data_as(u8p), b.ctypes.data_as(u8p), out.ctypes.data_as(u8p),
                         m, k, n)
    return out
