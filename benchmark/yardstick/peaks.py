"""One NVIDIA H100's published peaks and the cost model of a bound.

Frozen copy of the peaks and formulas of the program's ops/roofline.py.
NVIDIA's data sheet for the H100 SXM, dense rates at the 700 W limit.  A
bound is the larger of two times: the int8 operations of the work at the
int8 tensor-core peak, and the bytes the work must move (each input read
once, each output written once) at the memory rate.
"""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS_PER_S = 1979e12

# A 384-bit Montgomery product in its cheapest exact form at a published
# peak: int8 digit MACs, 48 x 48 for a*b, the low half (48*49/2) for
# m = t p' mod 2^384, 48 x 48 for m*p; one MAC is 2 operations.
OPS_PER_PRODUCT = 2 * (48 * 48 + 48 * 49 // 2 + 48 * 48)
ELEMENT_BYTES = 48  # one Fp element


def ops_bytes_ms(ops: float, nbytes: float) -> tuple:
    """(operations ms, bytes ms) of `ops` int8 operations and `nbytes` bytes."""
    return ops / PEAK_INT8_OPS_PER_S * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3


def gf_matmul_ms(m: int, k: int, cols: int) -> tuple:
    """(operations ms, bytes ms) of an [m, k] GF(2^8) product over `cols`
    byte columns: its bit-product form, 2 * (8m) * (8k) int8 operations a
    column, and the data and the output once plus the matrix."""
    return ops_bytes_ms(2 * (8 * m) * (8 * k) * cols, cols * (k + m) + m * k)


def bound_ms(ops_ms: float, bytes_ms: float) -> float:
    return max(ops_ms, bytes_ms)
