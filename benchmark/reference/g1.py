"""Plain BLS12-381 G1 over Python integers, and the threshold-decrypt epoch's algebra.

G1 is y^2 = x^3 + 4 over Fp.  Points are Jacobian (X, Y, Z), x = X/Z^2,
y = Y/Z^3, infinity Z = 0.  The formulas are the textbook ones (a = 0
doubling, general addition with its doubling and inverse cases); speed is
not a goal, exactness is.

The program's point layout, which the inputs are handed in and the state
is read back in: [..., 3, 32] int32, each coordinate in Montgomery form
(c * 2^384 mod p) as 32 little-endian 12-bit limbs.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
B = 4
G = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
    1,
)
INF = (1, 1, 0)

MONT = 1 << 384
MONT_INV = pow(MONT, -1, P)
LIMB_BITS = 12
N_LIMBS = 32

Point = Tuple[int, int, int]


def on_curve(pt: Point) -> bool:
    x, y, z = pt
    if z % P == 0:
        return True
    z2 = z * z % P
    return (y * y - x * x * x - B * z2 * z2 % P * z2) % P == 0


def dbl(pt: Point) -> Point:
    x, y, z = pt
    if z == 0 or y == 0:
        return INF
    a = x * x % P
    b = y * y % P
    c = b * b % P
    d = 2 * ((x + b) ** 2 - a - c) % P
    e = 3 * a % P
    x3 = (e * e - 2 * d) % P
    y3 = (e * (d - x3) - 8 * c) % P
    z3 = 2 * y * z % P
    return (x3, y3, z3)


def add(p1: Point, p2: Point) -> Point:
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    if z1 == 0:
        return p2
    if z2 == 0:
        return p1
    z1z1 = z1 * z1 % P
    z2z2 = z2 * z2 % P
    u1 = x1 * z2z2 % P
    u2 = x2 * z1z1 % P
    s1 = y1 * z2 * z2z2 % P
    s2 = y2 * z1 * z1z1 % P
    if u1 == u2:
        return dbl(p1) if s1 == s2 else INF
    h = (u2 - u1) % P
    r = (s2 - s1) % P
    hh = h * h % P
    hhh = h * hh % P
    v = u1 * hh % P
    x3 = (r * r - hhh - 2 * v) % P
    y3 = (r * (v - x3) - s1 * hhh) % P
    z3 = z1 * z2 * h % P
    return (x3, y3, z3)


def mul(pt: Point, k: int) -> Point:
    """k * pt by double-and-add, MSB first."""
    k %= R
    acc = INF
    for bit in bin(k)[2:] if k else "":
        acc = dbl(acc)
        if bit == "1":
            acc = add(acc, pt)
    return acc


def to_affine(pts: Sequence[Point]) -> List[Optional[Tuple[int, int]]]:
    """Jacobian -> affine (x, y), None for infinity; one inversion for all
    (Montgomery's batch trick)."""
    zs = [z % P for _, _, z in pts]
    prefix, acc = [], 1
    for z in zs:
        prefix.append(acc)
        if z:
            acc = acc * z % P
    inv = pow(acc, -1, P)
    out: List[Optional[Tuple[int, int]]] = [None] * len(pts)
    for i in range(len(pts) - 1, -1, -1):
        z = zs[i]
        if not z:
            continue
        zi = inv * prefix[i] % P
        inv = inv * z % P
        zi2 = zi * zi % P
        x, y, _ = pts[i]
        out[i] = (x * zi2 % P, y * zi2 * zi % P)
    return out


def chain(start: Point, step: Point, count: int) -> List[Point]:
    """[start + j*step for j < count], by count - 1 additions."""
    out, acc = [], start
    for _ in range(count):
        out.append(acc)
        acc = add(acc, step)
    return out


# -- the program's limb layout ---------------------------------------------

_SHIFTS = np.arange(N_LIMBS, dtype=object) * LIMB_BITS


def limbs_of(values: Sequence[int]) -> np.ndarray:
    """Field elements -> [len, 32] int32 12-bit limbs of their Montgomery form."""
    mask = (1 << LIMB_BITS) - 1
    out = np.empty((len(values), N_LIMBS), dtype=np.int32)
    for i, v in enumerate(values):
        m = v * MONT % P
        out[i] = [(m >> (LIMB_BITS * j)) & mask for j in range(N_LIMBS)]
    return out


def values_of(limbs: np.ndarray) -> List[int]:
    """[len, 32] 12-bit limbs in Montgomery form -> field elements."""
    rows = np.asarray(limbs, dtype=np.int64).reshape(-1, N_LIMBS)
    if (rows < 0).any() or (rows >> LIMB_BITS).any():
        raise ValueError("a limb outside 12 bits")
    return [int((row.astype(object) << _SHIFTS).sum()) * MONT_INV % P for row in rows]


def points_to_layout(pts: Sequence[Tuple[int, int]]) -> np.ndarray:
    """Affine points -> [len, 3, 32] Jacobian with Z = 1, the program's layout."""
    xs = limbs_of([x for x, _ in pts])
    ys = limbs_of([y for _, y in pts])
    zs = np.broadcast_to(limbs_of([1]), xs.shape)
    return np.stack([xs, ys, zs], axis=1)


def layout_points(arr: np.ndarray) -> List[Point]:
    """[..., 3, 32] in the program's layout -> Jacobian points."""
    flat = np.asarray(arr).reshape(-1, 3, N_LIMBS)
    coords = [values_of(flat[:, c]) for c in range(3)]
    return list(zip(*coords))


def lanes_differing(got: Sequence[Point], want: Sequence[Tuple[int, int]]) -> int:
    """How many Jacobian points of `got` are not the affine points of `want`
    (infinity never matches): X == x Z^2 and Y == y Z^3 with Z != 0."""
    bad = 0
    for (X, Y, Z), (x, y) in zip(got, want):
        Z %= P
        z2 = Z * Z % P
        if Z == 0 or (X - x * z2) % P or (Y - y * z2 * Z) % P:
            bad += 1
    return bad + abs(len(got) - len(want))


# -- the threshold-decrypt epoch ---------------------------------------------


def lagrange_at_zero(xs: Sequence[int]) -> List[int]:
    """Lagrange coefficients at 0 of the points xs, mod R."""
    out = []
    for xi in xs:
        num, den = 1, 1
        for xj in xs:
            if xj != xi:
                num = num * xj % R
                den = den * (xj - xi) % R
        out.append(num * pow(den, -1, R) % R)
    return out


def poly_eval(coeffs: Sequence[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % R
    return acc


def decrypt_epoch(u: Point, shares_of: Sequence[int], quorum: Sequence[int]) -> Point:
    """One epoch of one ciphertext, plainly: every quorum member i emits
    its decryption share U * sk_i, the shares combine by Lagrange at 0 to
    U * master, and the next ciphertext is U + U * master.
    shares_of[i] is the key share of node i, the polynomial at i + 1."""
    lam = lagrange_at_zero([i + 1 for i in quorum])
    combined = INF
    for i, li in zip(quorum, lam):
        combined = add(combined, mul(mul(u, shares_of[i]), li))
    return add(u, combined)


def state_scalar(master: int, epochs: int) -> int:
    """The factor every ciphertext is multiplied by over `epochs` epochs:
    each epoch takes U to U + U * master = U * (master + 1).  tests/ hold
    it equal to `decrypt_epoch` iterated."""
    return pow((master + 1) % R, epochs, R)
