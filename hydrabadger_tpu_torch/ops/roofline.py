"""The bound model every kernel is held against: the card's peaks and what
one Fp product and one field element cost at them.

A kernel's bound is the larger of two times: the int8 operations of its
work at the card's int8 tensor-core peak, and the bytes it must move (each
input read once, each output written once) at the card's memory rate.
"""
from __future__ import annotations

from typing import NamedTuple

# H100 SXM peaks (NVIDIA data sheet, dense, at a 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS_PER_S = 1979e12

# A 384-bit Montgomery product in its cheapest exact form at a published
# peak: int8 digit MACs on the tensor cores, 48x48 for a*b, the low half
# (48*49/2) for m = t p' mod R, 48x48 for m*p; one MAC = 2 ops.
OPS_PER_PRODUCT = 2 * (48 * 48 + 48 * 49 // 2 + 48 * 48)
ELEMENT_BYTES = 48  # one Fp element, 12 words


def ops_bytes_ms(ops: float, nbytes: float) -> tuple[float, float]:
    """(operations ms, bytes ms) of `ops` int8 operations and `nbytes` bytes."""
    return ops / PEAK_INT8_OPS_PER_S * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3


def gf_matmul_ms(m: int, k: int, cols: int) -> tuple[float, float]:
    """(operations ms, bytes ms) of an [m, k] GF(2^8) product over `cols`
    byte columns (kernel B1): its bit-product form, 2 * (8m) * (8k) int8
    operations per column, and the data and output once plus the matrix."""
    return ops_bytes_ms(2 * (8 * m) * (8 * k) * cols, cols * (k + m) + m * k)


def product_ms(products: int, elements: int) -> tuple[float, float]:
    """(operations ms, bytes ms) of `products` Fp products that move
    `elements` field elements."""
    return ops_bytes_ms(products * OPS_PER_PRODUCT, elements * ELEMENT_BYTES)


def pairing_ms(products: int, checks: int) -> tuple[float, float]:
    """(operations ms, bytes ms) of a batch of `checks` pairing checks that
    makes `products` Fp products (ops/pairing_torch.bound counts them from
    the recorded circuits and the launch schedule): each check reads its
    four affine points once (12 field elements) and writes a one-byte
    verdict."""
    return ops_bytes_ms(products * OPS_PER_PRODUCT, checks * (12 * ELEMENT_BYTES + 1))


def bound_ms(ops_ms: float, bytes_ms: float) -> tuple[float, str]:
    """(bound ms, "operations" or "bytes"): the larger of the two times."""
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


class Launch(NamedTuple):
    """One launch of a ladder's plan (ops/bls_torch, ops/bls_g2_torch): the
    products its data needs and what it must move, each once."""

    entry: str  # the launch counters' key
    lanes: int
    products: int  # Montgomery products these digits need, over all lanes
    elements: int  # field elements per lane read or written
    part: str  # "ladder" or "tree"
    digit_bytes: int = 0  # digit bytes per lane read

    def bound(self) -> tuple[float, float]:
        """(operations ms, bytes ms) of this launch."""
        return ops_bytes_ms(self.products * OPS_PER_PRODUCT,
                            self.lanes * (self.elements * ELEMENT_BYTES + self.digit_bytes))
