"""The work of one threshold-decrypt epoch (driver `tpke`), from the shapes.

A fixed model of the algorithm, counted in Fp products; it reads nothing
of the program's circuits or launch plans.  Per ciphertext U:

- q + 1 scalar multiplications of U (the q quorum members' shares U sk_i
  and the check U (master + 1)), 255-bit scalars split by the GLV
  endomorphism into two halves of 128 bits, off one shared table of
  2^W1 multiples of U and its endomorphic image: 128 doublings and
  2 * ceil(128 / W1) additions each;
- one q-term combine sum_i lam_i share_i by Straus's method with W2-bit
  windows: 4 * ceil(255 / W2) shared doublings, q * ceil(255 / W2)
  additions, and q tables of 2^W2 multiples;
- the final addition U + combine and the projective check (8 products).

Jacobian formulas on y^2 = x^3 + 4: a doubling 2M + 5S (7 products), an
addition 11M + 5S (16).  Bytes: U read once and U_next written once.
"""
from __future__ import annotations

from . import peaks

DBL, ADD = 7, 16
W1, W2 = 6, 4
HALF_BITS, SCALAR_BITS = 128, 255
CHECK = 8


def products_per_ciphertext(q: int) -> int:
    table = DBL + ((1 << W1) - 2) * ADD + (1 << W1)  # the shared table and its twist
    ladder = HALF_BITS * DBL + 2 * -(-HALF_BITS // W1) * ADD
    windows = -(-SCALAR_BITS // W2)
    combine = (q * (DBL + ((1 << W2) - 3) * ADD) + W2 * windows * DBL
               + q * windows * ADD)
    return table + (q + 1) * ladder + combine + ADD + CHECK


def epoch(config: dict, traffic: dict) -> dict:
    q = config["threshold"] + 1
    n_ct = traffic["instances"] * config["n_nodes"]
    products = n_ct * products_per_ciphertext(q)
    ops = products * peaks.OPS_PER_PRODUCT
    nbytes = n_ct * 2 * 3 * peaks.ELEMENT_BYTES
    return {"ops": ops, "bytes": nbytes, "bound_ms": peaks.bound_ms(*peaks.ops_bytes_ms(ops, nbytes))}
