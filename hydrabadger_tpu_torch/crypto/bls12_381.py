"""BLS12-381 G1 over Fp — the pure-Python host oracle the port needs.

Copy of the G1 part of hydrabadger_tpu/crypto/bls12_381.py: the field
FQ, the generator G1, projective add / double / multiply / normalize /
eq, and the parameters P, R, X_PARAM.  No native engine: `mul_sub` is
the plain double-and-add ladder (the JAX package's pure-Python fallback),
which gives the same group element as the native GLV ladder.

Points are projective (X, Y, Z) tuples of FQ; Z == 0 at infinity.
"""
from __future__ import annotations

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
X_PARAM = -0xD201000000010000  # the BLS parameter; negative for this curve


class FQ:
    """Element of the prime field Fp."""

    __slots__ = ("n",)

    def __init__(self, n: int):
        self.n = n % P

    def __add__(self, other):
        return FQ(self.n + (other.n if isinstance(other, FQ) else other))

    __radd__ = __add__

    def __sub__(self, other):
        return FQ(self.n - (other.n if isinstance(other, FQ) else other))

    def __rsub__(self, other):
        return FQ(other - self.n)

    def __mul__(self, other):
        return FQ(self.n * (other.n if isinstance(other, FQ) else other))

    __rmul__ = __mul__

    def __neg__(self):
        return FQ(-self.n)

    def __eq__(self, other):
        if isinstance(other, FQ):
            return self.n == other.n
        return self.n == other % P

    def __hash__(self):
        return hash(("FQ", self.n))

    def inv(self):
        return FQ(pow(self.n, -1, P))

    def __repr__(self):
        return f"FQ(0x{self.n:x})"

    @classmethod
    def one(cls):
        return cls(1)

    @classmethod
    def zero(cls):
        return cls(0)


G1 = (
    FQ(0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB),
    FQ(0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1),
    FQ(1),
)


def is_inf(pt) -> bool:
    return pt[2] == 0


def infinity(field=FQ):
    return (field.one(), field.one(), field.zero())


def double(pt):
    x, y, z = pt
    W = 3 * x * x
    S = y * z
    B = x * y * S
    H = W * W - 8 * B
    S_sq = S * S
    return (
        2 * H * S,
        W * (4 * B - H) - 8 * y * y * S_sq,
        8 * S * S_sq,
    )


def add(p1, p2):
    if is_inf(p1):
        return p2
    if is_inf(p2):
        return p1
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    U1 = y2 * z1
    U2 = y1 * z2
    V1 = x2 * z1
    V2 = x1 * z2
    if V1 == V2:
        if U1 == U2:
            return double(p1)
        return infinity()
    U = U1 - U2
    V = V1 - V2
    V_sq = V * V
    V_sq_V2 = V_sq * V2
    V_cu = V * V_sq
    W = z1 * z2
    A = U * U * W - V_cu - 2 * V_sq_V2
    return (V * A, U * (V_sq_V2 - A) - V_cu * U2, V_cu * W)


def neg(pt):
    x, y, z = pt
    return (x, -y, z)


def multiply(pt, n: int):
    """Scalar multiplication (double-and-add, MSB first)."""
    if n < 0:
        pt, n = neg(pt), -n
    if n == 0 or is_inf(pt):
        return infinity()
    result = None
    for bit in bin(n)[2:]:
        if result is not None:
            result = double(result)
        if bit == "1":
            result = pt if result is None else add(result, pt)
    return result


def mul_sub(pt, n: int):
    """Scalar multiplication of an r-order subgroup point (every protocol
    point).  The same group element as the JAX package's GLV ladder."""
    return multiply(pt, n)


def normalize(pt):
    """Projective -> affine (x, y); None at infinity."""
    if is_inf(pt):
        return None
    x, y, z = pt
    if z.n == 1:
        return (x, y)
    zinv = z.inv()
    return (x * zinv, y * zinv)


def eq(p1, p2) -> bool:
    if is_inf(p1) or is_inf(p2):
        return is_inf(p1) and is_inf(p2)
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    return x1 * z2 == x2 * z1 and y1 * z2 == y2 * z1
