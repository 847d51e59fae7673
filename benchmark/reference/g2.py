"""Plain BLS12-381 G2 over Python integers, and the program's G2 layout.

G2 lives on the twist y^2 = x^3 + 4 (1 + u) over Fp2 = Fp[u]/(u^2 + 1);
an Fp2 element is a pair (c0, c1) = c0 + c1 u.  Points are Jacobian
(X, Y, Z) of Fp2 elements, x = X/Z^2, y = Y/Z^3, infinity Z = 0.  The
formulas are g1's over Fp2; speed is not a goal, exactness is.

The program's G2 layout, which the inputs are handed in and the state is
read back in: [..., 3, 2, 32] int32, coordinate c then Fp2 component k,
each in Montgomery form as 32 little-endian 12-bit limbs (g1's).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import g1

P, R = g1.P, g1.R

Fp2 = Tuple[int, int]
Point = Tuple[Fp2, Fp2, Fp2]

ZERO: Fp2 = (0, 0)
ONE: Fp2 = (1, 0)
B = (4, 4)  # 4 (1 + u)
G = (
    (0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
     0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E),
    (0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
     0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE),
    ONE,
)
INF: Point = (ONE, ONE, ZERO)


# -- Fp2 ----------------------------------------------------------------------


def f2_add(a: Fp2, b: Fp2) -> Fp2:
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a: Fp2, b: Fp2) -> Fp2:
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a: Fp2) -> Fp2:
    return (-a[0] % P, -a[1] % P)


def f2_mul(a: Fp2, b: Fp2) -> Fp2:
    return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def f2_scale(a: Fp2, k: int) -> Fp2:
    return (a[0] * k % P, a[1] * k % P)


def f2_conj(a: Fp2) -> Fp2:
    return (a[0], -a[1] % P)


def f2_inv(a: Fp2) -> Fp2:
    """1 / a = conj(a) / (c0^2 + c1^2); raises for 0."""
    return f2_scale(f2_conj(a), pow((a[0] * a[0] + a[1] * a[1]) % P, -1, P))


def f2_pow(a: Fp2, k: int) -> Fp2:
    out = ONE
    for bit in bin(k)[2:]:
        out = f2_mul(out, out)
        if bit == "1":
            out = f2_mul(out, a)
    return out


def is_zero(a: Fp2) -> bool:
    return a[0] % P == 0 and a[1] % P == 0


# -- points -------------------------------------------------------------------


def on_curve(pt: Point) -> bool:
    x, y, z = pt
    if is_zero(z):
        return True
    z2 = f2_mul(z, z)
    z6 = f2_mul(f2_mul(z2, z2), z2)
    return is_zero(f2_sub(f2_mul(y, y), f2_add(f2_mul(f2_mul(x, x), x), f2_mul(B, z6))))


def dbl(pt: Point) -> Point:
    x, y, z = pt
    if is_zero(z) or is_zero(y):
        return INF
    a = f2_mul(x, x)
    b = f2_mul(y, y)
    c = f2_mul(b, b)
    xb = f2_add(x, b)
    d = f2_scale(f2_sub(f2_sub(f2_mul(xb, xb), a), c), 2)
    e = f2_scale(a, 3)
    x3 = f2_sub(f2_mul(e, e), f2_scale(d, 2))
    y3 = f2_sub(f2_mul(e, f2_sub(d, x3)), f2_scale(c, 8))
    z3 = f2_scale(f2_mul(y, z), 2)
    return (x3, y3, z3)


def add(p1: Point, p2: Point) -> Point:
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    if is_zero(z1):
        return p2
    if is_zero(z2):
        return p1
    z1z1 = f2_mul(z1, z1)
    z2z2 = f2_mul(z2, z2)
    u1 = f2_mul(x1, z2z2)
    u2 = f2_mul(x2, z1z1)
    s1 = f2_mul(f2_mul(y1, z2), z2z2)
    s2 = f2_mul(f2_mul(y2, z1), z1z1)
    if u1 == u2:
        return dbl(p1) if s1 == s2 else INF
    h = f2_sub(u2, u1)
    r = f2_sub(s2, s1)
    hh = f2_mul(h, h)
    hhh = f2_mul(h, hh)
    v = f2_mul(u1, hh)
    x3 = f2_sub(f2_sub(f2_mul(r, r), hhh), f2_scale(v, 2))
    y3 = f2_sub(f2_mul(r, f2_sub(v, x3)), f2_mul(s1, hhh))
    z3 = f2_mul(f2_mul(z1, z2), h)
    return (x3, y3, z3)


def neg(pt: Point) -> Point:
    return (pt[0], f2_neg(pt[1]), pt[2])


def mul(pt: Point, k: int) -> Point:
    """k * pt by double-and-add, MSB first."""
    k %= R
    acc = INF
    for bit in bin(k)[2:] if k else "":
        acc = dbl(acc)
        if bit == "1":
            acc = add(acc, pt)
    return acc


def to_affine(pts: Sequence[Point]) -> List[Optional[Tuple[Fp2, Fp2]]]:
    """Jacobian -> affine (x, y), None for infinity."""
    out: List[Optional[Tuple[Fp2, Fp2]]] = []
    for x, y, z in pts:
        if is_zero(z):
            out.append(None)
            continue
        zi = f2_inv(z)
        zi2 = f2_mul(zi, zi)
        out.append((f2_mul(x, zi2), f2_mul(y, f2_mul(zi2, zi))))
    return out


def chain(start: Point, step: Point, count: int) -> List[Point]:
    """[start + j*step for j < count], by count - 1 additions."""
    out, acc = [], start
    for _ in range(count):
        out.append(acc)
        acc = add(acc, step)
    return out


def quadratic_chain(e0: int, e1: int, e2: int, count: int) -> List[Point]:
    """[(e0 + j e1 + j^2 e2) G for j < count] by finite differences: the
    step from lane j to j + 1 is (e1 + (2j + 1) e2) G, and each step grows
    by 2 e2 G; two additions a lane."""
    out, acc = [], mul(G, e0)
    step, grow = mul(G, e1 + e2), mul(G, 2 * e2)
    for _ in range(count):
        out.append(acc)
        acc = add(acc, step)
        step = add(step, grow)
    return out


# -- the program's layout -------------------------------------------------------


def points_to_layout(pts: Sequence[Tuple[Fp2, Fp2]]) -> np.ndarray:
    """Affine points -> [len, 3, 2, 32] Jacobian with Z = 1."""
    cols = [g1.limbs_of([pt[c][k] for pt in pts]) for c in (0, 1) for k in (0, 1)]
    one, zero = g1.limbs_of([1]), g1.limbs_of([0])
    n = len(pts)
    z = np.stack([np.broadcast_to(one, (n, g1.N_LIMBS)), np.broadcast_to(zero, (n, g1.N_LIMBS))], 1)
    xy = np.stack(cols, 1).reshape(n, 2, 2, g1.N_LIMBS)
    return np.concatenate([xy, z[:, None]], 1)


def layout_points(arr: np.ndarray) -> List[Point]:
    """[..., 3, 2, 32] in the program's layout -> Jacobian points."""
    flat = np.asarray(arr).reshape(-1, 3, 2, g1.N_LIMBS)
    comps = [g1.values_of(flat[:, c, k]) for c in range(3) for k in range(2)]
    return [((a, b), (c, d), (e, f)) for a, b, c, d, e, f in zip(*comps)]


def lanes_differing(got: Sequence[Point], want: Sequence[Tuple[Fp2, Fp2]]) -> int:
    """How many Jacobian points of `got` are not the affine points of
    `want` (infinity never matches)."""
    bad = 0
    for (X, Y, Z), (x, y) in zip(got, want):
        if is_zero(Z):
            bad += 1
            continue
        z2 = f2_mul(Z, Z)
        if f2_sub(X, f2_mul(x, z2)) != ZERO or f2_sub(Y, f2_mul(y, f2_mul(z2, Z))) != ZERO:
            bad += 1
    return bad + abs(len(got) - len(want))
