"""The work of one verified threshold-decrypt epoch (driver `tpke_byz`), from the shapes.

A fixed model of the algorithm, counted in Fp products as work_tpke; it
reads nothing of the program's circuits or launch plans.  Per ciphertext,
with q quorum and f faulty nodes:

- work_tpke's decrypt: q + 1 ladders and the q-term combine;
- f + q share checks and one ciphertext check, each e(a, b) == e(c, d) as
  a product of two pairings: one Miller loop over |x| with a shared Fp12
  square (63 doubling steps: the square, and per pairing a sparse line
  product and a doubling step with its line; 5 addition steps: per pairing
  a sparse product and an addition step with its line), then one final
  exponentiation (easy part: a conjugate times an inverse, a p^2
  Frobenius times the result; hard part: five powers by |x| in cyclotomic
  squares, 10 products and 3 Frobenius maps);
- a 255-bit G2 ladder with w = 4 windows: a 16-entry table (14
  additions), 255 doublings and 64 additions (W's next value);
- f + q + 1 G1 affine conversions (the shares and U) and one in G2 (W),
  each one Fp inversion (Fermat's, by the bits of p - 2) and its products;
- f complete G1 additions (the forged shares S_k + U).

Costs: an Fp2 product 3 Fp products, an Fp2 square 2; an Fp6 product 6
Fp2 products; an Fp12 product 3 Fp6 products, a square 2; a sparse line
product 13 Fp2 products; a cyclotomic square 9 Fp2 squares; a Frobenius
5 Fp2 products; the Miller doubling step 2 Fp2 products, 7 Fp2 squares
and 4 Fp products (homogeneous coordinates, the line's P-coefficients),
the addition step 11, 2 and 4; a G2 doubling 2 Fp2 products and 5
squares, an addition 12 and 4; a G1 addition 11 products and 5 squares.
Bytes: U and W read and written once, and each check's four operands
read once.
"""
from __future__ import annotations

from . import peaks, work_tpke

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
X_ABS_SQUARES, X_ABS_MULTIPLIES = 63, 5  # the bits of |x| = 0xd201000000010000 below the top

M2, S2 = 3, 2
F6 = 6 * M2
F12_MUL, F12_SQR = 3 * F6, 2 * F6
SPARSE = 13 * M2
CYC_SQR = 9 * S2
FROB = 5 * M2
FP_INV = (P - 2).bit_length() - 1 + bin(P - 2).count("1") - 1
F2_INV = 2 + FP_INV + 2
F6_INV = 12 * M2 + F2_INV
F12_INV = 2 * F6 + F6_INV + 2 * F6

MILLER_DBL = 2 * M2 + 7 * S2 + 4
MILLER_ADD = 11 * M2 + 2 * S2 + 4
MILLER = (X_ABS_SQUARES * (F12_SQR + 2 * (SPARSE + MILLER_DBL))
          + X_ABS_MULTIPLIES * 2 * (SPARSE + MILLER_ADD))
POW_X = X_ABS_SQUARES * CYC_SQR + X_ABS_MULTIPLIES * F12_MUL
FINAL_EXP = (F12_INV + F12_MUL + FROB + F12_MUL) + 5 * POW_X + 10 * F12_MUL + 3 * FROB
CHECK = MILLER + FINAL_EXP

G2_DBL, G2_ADD = 2 * M2 + 5 * S2, 12 * M2 + 4 * S2
G2_LADDER = 14 * G2_ADD + 255 * G2_DBL + 64 * G2_ADD
G1_AFFINE = FP_INV + 4  # Z^-2, X Z^-2, Z^-3, Y Z^-3
G2_AFFINE = 2 + FP_INV + 2 + S2 + 3 * M2  # the norm, Z^-1, Z^-2, Z^-3, x, y
G1_ADD = 11 + 5

CHECK_ELEMENTS = 2 + 4 + 2 + 4  # a and c affine in G1, b and d in G2


def products_per_ciphertext(q: int, f: int) -> int:
    checks = f + q + 1
    return (work_tpke.products_per_ciphertext(q) + checks * CHECK + G2_LADDER
            + checks * G1_AFFINE + G2_AFFINE + f * G1_ADD)


def epoch(config: dict, traffic: dict) -> dict:
    q, f = config["threshold"] + 1, len(config["faulty"])
    n_ct = traffic["instances"] * config["n_nodes"]
    products = n_ct * products_per_ciphertext(q, f)
    ops = products * peaks.OPS_PER_PRODUCT
    nbytes = n_ct * (2 * 3 + 2 * 6 + (f + q + 1) * CHECK_ELEMENTS) * peaks.ELEMENT_BYTES
    bound = peaks.bound_ms(*peaks.ops_bytes_ms(ops, nbytes))
    return {"ops": ops, "bytes": nbytes, "bound_ms": bound}
