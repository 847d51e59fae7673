"""Constant-time-shaped SSWU hash-to-G2 in the RFC 9380 construction.

The port's own copy of hydrabadger_tpu/crypto/sswu.py, function for
function (tests/test_torch_sswu.py holds every output equal to the
original's).  The pipeline is the RFC's:

    hash_to_field (expand_message_xmd, SHA-256, L=64)  ->  2 x Fp2
    map_to_curve_simple_swu on an AB != 0 isogenous curve
    3-isogeny eval back to E'(Fp2): y^2 = x^3 + 4(1+u)
    clear_cofactor (Budroni-Pintore, crypto/bls12_381.clear_cofactor_g2)

One deliberate divergence from the RFC, kept from the original: the
3-isogenous curve and its rational maps are DERIVED here from first
principles (Velu's formulas over a Galois-stable order-3 kernel of E')
rather than transcribed from the RFC's suite constants.  The
construction is therefore *an* SSWU suite for G2 (same security
argument, same structure) but NOT bit-compatible with
BLS12381G2_XMD:SHA-256_SSWU_RO_ (different iso curve, different Z).
The default wire hash remains crypto/bls12_381.hash_to_g2; no module of
the port calls this one.
"""
from __future__ import annotations

import hashlib
from typing import List, Tuple

from .bls12_381 import (
    FQ2,
    P,
    add,
    clear_cofactor_g2,
    in_g2_subgroup,
    is_inf,
)

B2 = FQ2([4, 4])  # E' : y^2 = x^3 + 4(1+u)


# ---------------------------------------------------------------------------
# expand_message_xmd (RFC 9380 section 5.3.1, SHA-256)
# ---------------------------------------------------------------------------

_H_BLOCK = 64  # SHA-256 block size (r_in_bytes)
_H_OUT = 32  # b_in_bytes


def expand_message_xmd(msg: bytes, dst: bytes, n_bytes: int) -> bytes:
    if len(dst) > 255:
        dst = hashlib.sha256(b"H2C-OVERSIZE-DST-" + dst).digest()
    ell = (n_bytes + _H_OUT - 1) // _H_OUT
    if ell > 255 or n_bytes > 65535:
        raise ValueError("requested too many bytes")
    dst_prime = dst + len(dst).to_bytes(1, "big")
    z_pad = b"\x00" * _H_BLOCK
    l_i_b_str = n_bytes.to_bytes(2, "big")
    b0 = hashlib.sha256(
        z_pad + msg + l_i_b_str + b"\x00" + dst_prime
    ).digest()
    b1 = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    out = [b1]
    for i in range(2, ell + 1):
        prev = out[-1]
        mixed = bytes(a ^ b for a, b in zip(b0, prev))
        out.append(
            hashlib.sha256(mixed + i.to_bytes(1, "big") + dst_prime).digest()
        )
    return b"".join(out)[:n_bytes]


def hash_to_field_fq2(msg: bytes, dst: bytes, count: int) -> List[FQ2]:
    """RFC 9380 section 5.2 with m=2, L=64."""
    L = 64
    raw = expand_message_xmd(msg, dst, count * 2 * L)
    out = []
    for i in range(count):
        cs = []
        for j in range(2):
            off = L * (j + i * 2)
            cs.append(int.from_bytes(raw[off : off + L], "big") % P)
        out.append(FQ2(cs))
    return out


# ---------------------------------------------------------------------------
# Derive the 3-isogenous SSWU curve via Velu
# ---------------------------------------------------------------------------


def _fq2_cube_root(c: FQ2) -> FQ2 | None:
    """A cube root of c in Fp2, via factoring x^3 - c with the p^2-power
    Frobenius gcd (tiny degree-3 polynomial arithmetic)."""
    # polynomial arithmetic over FQ2, poly = list of coeffs low->high
    def pmulmod(a, b, mod):
        res = [FQ2.zero()] * (len(a) + len(b) - 1)
        for i, ai in enumerate(a):
            if ai == FQ2.zero():
                continue
            for j, bj in enumerate(b):
                res[i + j] = res[i + j] + ai * bj
        # reduce by mod (monic cubic)
        while len(res) >= len(mod):
            d = len(res) - len(mod)
            lead = res[-1]
            for i in range(len(mod)):
                res[d + i] = res[d + i] - lead * mod[i]
            res.pop()
        return res

    def ptrim(a):
        a = list(a)
        while a and a[-1] == FQ2.zero():
            a.pop()
        return a

    def pmod(a, b):
        """a mod b (b nonzero, trimmed)."""
        a = list(a)
        binv = b[-1].inv()
        while len(a) >= len(b):
            q = a[-1] * binv
            d = len(a) - len(b)
            for i in range(len(b)):
                a[d + i] = a[d + i] - q * b[i]
            a.pop()
            a = ptrim(a)
            if not a:
                break
        return a

    def pgcd(a, b):
        a, b = ptrim(a), ptrim(b)
        while b:
            a, b = b, pmod(a, b)
        return a

    mod = [-c, FQ2.zero(), FQ2.zero(), FQ2.one()]  # x^3 - c
    # x^(p^2) mod (x^3 - c) by square-and-multiply over the exponent
    base = [FQ2.zero(), FQ2.one()]  # x
    acc = [FQ2.one()]
    e = P * P
    while e:
        if e & 1:
            acc = pmulmod(acc, base, mod)
        base = pmulmod(base, base, mod)
        e >>= 1
    # gcd(x^(p^2) - x, x^3 - c) splits off the Fp2-rational roots
    acc = acc + [FQ2.zero()] * (3 - len(acc))
    diff = [acc[0], acc[1] - FQ2.one(), acc[2]]

    def monic(a):
        a = ptrim(a)
        inv = a[-1].inv()
        return [x * inv for x in a]

    def ppowmod(base_p, exp, modp):
        acc_p = [FQ2.one()]
        b = [x for x in base_p]
        while exp:
            if exp & 1:
                acc_p = pmulmod(acc_p, b, modp)
            b = pmulmod(b, b, modp)
            exp >>= 1
        return ptrim(acc_p)

    g = pgcd(mod, diff)
    # equal-degree splitting: gcd(g, (x+t)^((p^2-1)/2) - 1) halves g
    for _ in range(80):
        g = monic(g)
        if len(g) == 2:  # linear: root = -g0
            return -g[0]
        if len(g) < 2:
            return None
        found = False
        for trial in range(1, 64):
            # deterministic Fp2 sweep: Fp-only shifts can fail to
            # separate conjugate root pairs of a fully split cubic
            shift = FQ2([trial % 8, trial // 8])
            h = ppowmod([shift, FQ2.one()], (P * P - 1) // 2, g)
            h = ptrim(
                [h[0] - FQ2.one() if h else -FQ2.one()] + h[1:]
            )
            s = pgcd(g, h)
            if 1 < len(s) < len(g):
                g = s
                found = True
                break
        if not found:
            return None
    return None


def _derive_iso() -> dict:
    """Build E_iso (A*B != 0) and the explicit 3-isogeny E_iso -> E'.

    Steps (module docstring): quotient E' by the Galois-stable kernel
    {O, (xk, +-yk)} with xk^3 = -4*B2 (Velu) to get E2; quotient E2 by
    the image of E'[3]'s (0, +-sqrt(B2)) subgroup to get E3 ~ E'; the
    Weierstrass isomorphism E3 -> E' closes the loop.  SSWU targets E2;
    iso_map = iso o velu2."""
    zero = FQ2.zero()

    # kernel 1: x-coords with x^3 = -4 B2
    xk = _fq2_cube_root(-(B2 + B2 + B2 + B2))
    assert xk is not None, "no Fp2-rational order-3 kernel"
    # Velu sums for the +-pair (only xk and yk^2 = xk^3 + B2 appear)
    yk2 = xk * xk * xk + B2
    gx = FQ2([3, 0]) * xk * xk
    v1 = gx + gx
    u1 = FQ2([4, 0]) * yk2
    w1 = u1 + v1 * xk
    A2 = -(FQ2([5, 0]) * v1)
    B2_2 = B2 - FQ2([7, 0]) * w1
    assert A2 != zero and B2_2 != zero, "iso curve must have A*B != 0"

    def velu_map(x, y, xq, vq, uq):
        """Velu rational map for a single +-pair kernel at x-coord xq."""
        d = x - xq
        dinv = d.inv()
        d2 = dinv * dinv
        xx = x + vq * dinv + uq * d2
        yy = y * (FQ2.one() - vq * d2 - (uq + uq) * dinv * d2)
        return xx, yy

    # kernel 2 on E2: image of (0, +-sqrt(B2)) under velu1 — only the
    # x-coordinate is needed, X(0) = 0 + v1/(0-xk) + u1/(0-xk)^2
    d0 = (zero - xk).inv()
    x2k = v1 * d0 + u1 * d0 * d0
    y2k2 = x2k * x2k * x2k + A2 * x2k + B2_2
    gx2 = FQ2([3, 0]) * x2k * x2k + A2
    v2 = gx2 + gx2
    u2 = FQ2([4, 0]) * y2k2
    w2 = u2 + v2 * x2k
    A3 = A2 - FQ2([5, 0]) * v2
    B3 = B2_2 - FQ2([7, 0]) * w2
    # E3 must be isomorphic to E' (j = 0): A3 == 0, c^6 = B2 / B3
    assert A3 == zero, f"dual-quotient curve not j=0: A3={A3.coeffs}"
    c6 = B2 * B3.inv()
    # Weierstrass scaling E3 -> E': (x, y) -> (a x, b y) with
    # b^2 = a^3 = B2/B3; a = cbrt, b = sqrt of the same value
    c2 = _fq2_cube_root(c6)
    assert c2 is not None, "no cube root for the Weierstrass twist"
    c3 = c6.sqrt()
    assert c3 is not None, "no square root for the Weierstrass twist"
    assert c3 * c3 == c2 * c2 * c2  # both equal c6

    return {
        "A2": A2,
        "B2_2": B2_2,
        "xk": xk,
        "v1": v1,
        "u1": u1,
        "x2k": x2k,
        "v2": v2,
        "u2": u2,
        "c2": c2,
        "c3": c3,
        "velu_map": velu_map,
    }


_ISO = None


def _iso():
    global _ISO
    if _ISO is None:
        _ISO = _derive_iso()
    return _ISO


def iso_map(x: FQ2, y: FQ2) -> Tuple[FQ2, FQ2]:
    """E_iso(A2, B2_2) -> E': the second Velu step (E2 -> E3) composed
    with the Weierstrass scaling E3 -> E'.  (The first Velu step
    E' -> E2 exists only to DERIVE E2; the runtime map is degree 3.)"""
    iso = _iso()
    x, y = iso["velu_map"](x, y, iso["x2k"], iso["v2"], iso["u2"])
    return iso["c2"] * x, iso["c3"] * y


# ---------------------------------------------------------------------------
# Simplified SWU map on E_iso (RFC 9380 section 6.6.2)
# ---------------------------------------------------------------------------


def _sgn0(e: FQ2) -> int:
    """RFC 9380 section 4.1 sgn0 for m=2."""
    s0 = e.coeffs[0] % 2
    z0 = 1 if e.coeffs[0] == 0 else 0
    s1 = e.coeffs[1] % 2
    return s0 | (z0 & s1)


def _find_z() -> FQ2:
    """RFC 9380 appendix H.2 selection criteria for the SSWU Z:
    non-square, not -1, g(x) - Z irreducible-not-required but
    g(B / (Z*A)) must be square (totality of the exceptional case)."""
    iso = _iso()
    A, B = iso["A2"], iso["B2_2"]

    def g(x):
        return x * x * x + A * x + B

    for a in range(0, 9):
        for b in range(0, 9):
            for sa in (1, -1):
                for sb in (1, -1):
                    if a == 0 and b == 0:
                        continue
                    z = FQ2([sa * a, sb * b])
                    if z == FQ2([-1, 0]):
                        continue
                    if z.sqrt() is not None:  # must be non-square
                        continue
                    if g(B * (z * A).inv()).sqrt() is None:
                        continue
                    return z
    raise RuntimeError("no SSWU Z found in search range")


_Z = None


def _z() -> FQ2:
    global _Z
    if _Z is None:
        _Z = _find_z()
    return _Z


def map_to_curve_sswu(u: FQ2) -> Tuple[FQ2, FQ2]:
    """RFC 9380 section 6.6.2 simplified SWU onto E_iso."""
    iso = _iso()
    A, B = iso["A2"], iso["B2_2"]
    Z = _z()
    one = FQ2.one()
    zu2 = Z * u * u
    denom = zu2 * zu2 + zu2  # Z^2 u^4 + Z u^2
    neg_b_over_a = -(B * A.inv())
    if denom == FQ2.zero():
        x1 = B * (Z * A).inv()  # exceptional case: x = B/(Z*A)
    else:
        x1 = neg_b_over_a * (one + denom.inv())
    gx1 = (x1 * x1 + A) * x1 + B
    y1 = gx1.sqrt()
    if y1 is not None:
        x, y = x1, y1
    else:
        x2 = zu2 * x1
        gx2 = (x2 * x2 + A) * x2 + B
        y2 = gx2.sqrt()
        assert y2 is not None, "SSWU: neither gx1 nor gx2 square"
        x, y = x2, y2
    if _sgn0(u) != _sgn0(y):
        y = -y
    return x, y


def hash_to_g2_sswu(msg: bytes, dst: bytes = b"HBTPU-G2-SSWU") -> tuple:
    """Full RO construction: two field elements, two maps, add, clear."""
    u0, u1 = hash_to_field_fq2(msg, dst, 2)
    p0 = iso_map(*map_to_curve_sswu(u0))
    p1 = iso_map(*map_to_curve_sswu(u1))
    q0 = (p0[0], p0[1], FQ2.one())
    q1 = (p1[0], p1[1], FQ2.one())
    s = add(q0, q1)
    out = clear_cofactor_g2(s)
    assert not is_inf(out) and in_g2_subgroup(out)
    return out
