"""BLS12-381 over Fp, Fp2 and Fp12: the host group and pairing operations.

Copy of what the port needs of hydrabadger_tpu/crypto/bls12_381.py: the
fields FQ, FQ2 (Fp[u]/(u^2 + 1)) and FQ12, the generators G1 and G2, the
curve constants B1 and B2, projective add / double / multiply / normalize /
eq / is_on_curve for points over any of them, the ate pairing
(`miller_loop`, `final_exponentiation`, `pairing_check_eq`,
`pairing_product_check`), the psi endomorphism, cofactor clearing and the
subgroup checks, `hash_to_fr`, `hash_to_g2` (try-and-increment, then
clearing; cached by digest) and the compressed G1 and G2 encodings both
ways.

As in the JAX module, the public group and pairing operations dispatch to
the native host library (crypto/native_bls: native/bls12_381.cpp, built by
the port with g++) at the end of this file, and the pure-Python bodies stay
as the `_py_*` oracles (`_py_multiply`, `_py_add`, `_py_pairing_check_eq`,
`_py_pairing_product_check`, `_py_hash_to_g2`): plain copies of the JAX
package's pure-Python fallbacks, giving the same group elements and
verdicts.  HYDRABADGER_NO_NATIVE_BLS=1 (or native_bls.set_enabled(False))
selects them; a missing or failing native library raises.

Points are projective (X, Y, Z) tuples of FQ, FQ2 or FQ12; Z == 0 at
infinity.
"""
from __future__ import annotations

import hashlib
from functools import lru_cache

from ..utils.lru import DigestLRU

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

    def __truediv__(self, other):
        return self * other.inv()

    def __pow__(self, e: int):
        return FQ(pow(self.n, e, P))

    def __repr__(self):
        return f"FQ(0x{self.n:x})"

    def sqrt(self):
        """Square root (P = 3 mod 4), or None if non-residue."""
        c = pow(self.n, (P + 1) // 4, P)
        return FQ(c) if c * c % P == self.n else None

    @classmethod
    def one(cls):
        return cls(1)

    @classmethod
    def zero(cls):
        return cls(0)


class _FQP:
    """Polynomial extension field over Fp; coeffs are plain ints mod P."""

    __slots__ = ("coeffs",)
    degree: int = 0
    # sparse (index, coeff) pairs of the modulus polynomial (sans leading 1)
    mc_tuples: tuple = ()

    def __init__(self, coeffs):
        self.coeffs = [c % P for c in coeffs]
        assert len(self.coeffs) == self.degree

    def __add__(self, other):
        return type(self)([a + b for a, b in zip(self.coeffs, other.coeffs)])

    def __sub__(self, other):
        return type(self)([a - b for a, b in zip(self.coeffs, other.coeffs)])

    def __neg__(self):
        return type(self)([-a for a in self.coeffs])

    def __eq__(self, other):
        return type(self) is type(other) and self.coeffs == other.coeffs

    def __hash__(self):
        return hash((type(self).__name__, tuple(self.coeffs)))

    def __mul__(self, other):
        if isinstance(other, int):
            return type(self)([c * other for c in self.coeffs])
        if isinstance(other, FQ):
            return type(self)([c * other.n for c in self.coeffs])
        d = self.degree
        b = [0] * (d * 2 - 1)
        sc, oc = self.coeffs, other.coeffs
        for i in range(d):
            ai = sc[i]
            if ai:
                for j in range(d):
                    b[i + j] += ai * oc[j]
        for exp in range(d * 2 - 2, d - 1, -1):
            top = b[exp]
            if top:
                b[exp] = 0
                for i, c in self.mc_tuples:
                    b[exp - d + i] -= top * c
        return type(self)([c % P for c in b[:d]])

    __rmul__ = __mul__

    def square(self):
        """self * self with each cross term taken once (d(d+1)/2 products
        for d^2): the same value, a quarter off the final exponentiation."""
        d = self.degree
        a = self.coeffs
        b = [0] * (d * 2 - 1)
        for i in range(d):
            ai = a[i]
            if ai:
                b[2 * i] += ai * ai
                twice = 2 * ai
                for j in range(i + 1, d):
                    b[i + j] += twice * a[j]
        for exp in range(d * 2 - 2, d - 1, -1):
            top = b[exp]
            if top:
                b[exp] = 0
                for i, c in self.mc_tuples:
                    b[exp - d + i] -= top * c
        return type(self)(b[:d])

    def __pow__(self, e: int):
        result = type(self).one()
        base = self
        if e < 0:
            base = base.inv()
            e = -e
        while e:
            if e & 1:
                result = result * base
            e >>= 1
            if e:
                base = base.square()
        return result

    def inv(self):
        """Extended-Euclid inversion in the polynomial quotient ring."""
        d = self.degree
        lm, hm = [1] + [0] * d, [0] * (d + 1)
        low = self.coeffs + [0]
        high = [0] * (d + 1)
        for i, c in self.mc_tuples:
            high[i] = c % P
        high[d] = 1
        while _deg(low):
            r = _poly_rounded_div(high, low)
            r += [0] * (d + 1 - len(r))
            nm, new = hm[:], high[:]
            for i in range(d + 1):
                for j in range(d + 1 - i):
                    nm[i + j] -= lm[i] * r[j]
                    new[i + j] -= low[i] * r[j]
            nm = [x % P for x in nm]
            new = [x % P for x in new]
            lm, low, hm, high = nm, new, lm, low
        inv_low0 = pow(low[0], -1, P)
        return type(self)([c * inv_low0 % P for c in lm[:d]])

    def __truediv__(self, other):
        return self * other.inv()

    def is_zero(self):
        return all(c == 0 for c in self.coeffs)

    def __repr__(self):
        return f"{type(self).__name__}({self.coeffs})"

    @classmethod
    def one(cls):
        return cls([1] + [0] * (cls.degree - 1))

    @classmethod
    def zero(cls):
        return cls([0] * cls.degree)


def _deg(poly):
    d = len(poly) - 1
    while d and poly[d] == 0:
        d -= 1
    return d


def _poly_rounded_div(a, b):
    dega, degb = _deg(a), _deg(b)
    temp = a[:]
    out = [0] * len(a)
    inv_b = pow(b[degb], -1, P)
    for i in range(dega - degb, -1, -1):
        out[i] = (out[i] + temp[degb + i] * inv_b) % P
        for c in range(degb + 1):
            temp[c + i] = (temp[c + i] - out[i] * b[c]) % P
    return [x % P for x in out[: _deg(out) + 1]]


class FQ2(_FQP):
    """Fp2 = Fp[u]/(u^2 + 1)."""

    degree = 2
    mc_tuples = ((0, 1),)

    def conjugate(self):
        return FQ2([self.coeffs[0], -self.coeffs[1]])

    def sqrt(self):
        """Square root via the norm method, or None if non-residue."""
        a0, a1 = self.coeffs
        if a1 == 0:
            r = FQ(a0).sqrt()
            if r is not None:
                return FQ2([r.n, 0])
            # a0 is a non-residue in Fp: sqrt is purely imaginary
            r = (FQ(a0) * FQ(-1).inv()).sqrt()  # sqrt(-a0)
            return FQ2([0, r.n]) if r is not None else None
        norm = FQ(a0 * a0 + a1 * a1)
        alpha = norm.sqrt()
        if alpha is None:
            return None
        inv2 = pow(2, -1, P)
        delta = (a0 + alpha.n) * inv2 % P
        x0 = FQ(delta).sqrt()
        if x0 is None:
            delta = (a0 - alpha.n) * inv2 % P
            x0 = FQ(delta).sqrt()
            if x0 is None:
                return None
        x1 = a1 * pow(2 * x0.n, -1, P) % P
        cand = FQ2([x0.n, x1])
        return cand if cand * cand == self else None


class FQ12(_FQP):
    """Fp12 = Fp[w]/(w^12 - 2 w^6 + 2); Fp2 embeds via u = w^6 - 1."""

    degree = 12
    mc_tuples = ((0, 2), (6, -2))

    def conjugate(self):
        """f^(p^6): w -> -w, i.e. negate odd coefficients."""
        return FQ12([c if i % 2 == 0 else -c for i, c in enumerate(self.coeffs)])


def fq2_to_fq12(el: FQ2) -> FQ12:
    """Embed a0 + a1*u  ->  (a0 - a1) + a1*w^6."""
    a0, a1 = el.coeffs
    co = [0] * 12
    co[0] = a0 - a1
    co[6] = a1
    return FQ12(co)


# ---------------------------------------------------------------------------
# Curve ops (projective: (X, Y, Z), point = (X/Z, Y/Z), infinity when Z == 0)
# ---------------------------------------------------------------------------

B1 = FQ(4)  # G1: y^2 = x^3 + 4
B2 = FQ2([4, 4])  # the twist: y^2 = x^3 + 4(u + 1)

G1 = (
    FQ(0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB),
    FQ(0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1),
    FQ(1),
)
G2 = (
    FQ2([
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ]),
    FQ2([
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ]),
    FQ2([1, 0]),
)


def _field(pt):
    """The field type of a point's coordinates (FQ or FQ2)."""
    return FQ if isinstance(pt[0], FQ) else type(pt[0])


def is_inf(pt) -> bool:
    z = pt[2]
    return z == 0 if isinstance(z, FQ) else z.is_zero()


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
    return _add_impl(p1, p2)


def _add_impl(p1, p2):
    """The pure complete add (the `_py_add` oracle; no dispatch re-entry)."""
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
        return infinity(_field(p1))
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
    """Scalar multiplication (double-and-add, MSB first).  Self-contained
    pure Python: this body stays as the `_py_multiply` oracle after the
    native dispatch section rebinds the public name."""
    if n < 0:
        pt, n = neg(pt), -n
    if n == 0 or is_inf(pt):
        return infinity(_field(pt))
    result = None
    for bit in bin(n)[2:]:
        if result is not None:
            result = double(result)
        if bit == "1":
            result = pt if result is None else _add_impl(result, pt)
    return result


def normalize(pt):
    """Projective -> affine (x, y); None at infinity."""
    if is_inf(pt):
        return None
    x, y, z = pt
    if isinstance(z, FQ):
        if z.n == 1:
            return (x, y)
    elif z.coeffs[0] == 1 and all(c == 0 for c in z.coeffs[1:]):
        return (x, y)
    zinv = z.inv()
    return (x * zinv, y * zinv)


def normalize_batch(pts):
    """Projective -> affine for a list of points with ONE field inversion
    (Montgomery's trick) and 3 products per point; points already affine
    (z == 1) are taken as they are.  Element for element what normalize()
    gives: (x, y), or None at infinity."""
    def _is_one(z):
        if isinstance(z, FQ):
            return z.n == 1
        return z.coeffs[0] == 1 and all(c == 0 for c in z.coeffs[1:])

    idx, zs = [], []
    for i, pt in enumerate(pts):
        if not is_inf(pt) and not _is_one(pt[2]):
            idx.append(i)
            zs.append(pt[2])
    invs = [None] * len(zs)
    if zs:
        pre = [zs[0]]
        for z in zs[1:]:
            pre.append(pre[-1] * z)
        acc = pre[-1].inv()
        for j in range(len(zs) - 1, 0, -1):
            invs[j] = acc * pre[j - 1]
            acc = acc * zs[j]
        invs[0] = acc
    inv_at = dict(zip(idx, invs))
    out = []
    for i, pt in enumerate(pts):
        if is_inf(pt):
            out.append(None)
        elif i in inv_at:
            zi = inv_at[i]
            out.append((pt[0] * zi, pt[1] * zi))
        else:
            out.append((pt[0], pt[1]))
    return out


def eq(p1, p2) -> bool:
    if is_inf(p1) or is_inf(p2):
        return is_inf(p1) and is_inf(p2)
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    return x1 * z2 == x2 * z1 and y1 * z2 == y2 * z1


def is_on_curve(pt, b) -> bool:
    if is_inf(pt):
        return True
    x, y, z = pt
    return y * y * z == x * x * x + b * z * z * z  # y^2 z = x^3 + b z^3


# ---------------------------------------------------------------------------
# Pairing
# ---------------------------------------------------------------------------

_W = FQ12([0, 1] + [0] * 10)
_W2_INV = (_W * _W).inv()
_W3_INV = (_W * _W * _W).inv()


def twist(pt):
    """Map a G2 point (over Fp2, curve b = 4(u+1)) into E(Fp12) (b = 4)."""
    x, y, z = pt
    return (fq2_to_fq12(x) * _W2_INV, fq2_to_fq12(y) * _W3_INV, fq2_to_fq12(z))


def cast_g1_to_fq12(pt):
    x, y, z = pt
    return tuple(FQ12([c.n] + [0] * 11) for c in (x, y, z))


def _linefunc(p1, p2, t):
    """Line through p1, p2 evaluated at t; returns (numerator, denominator)."""
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    xt, yt, zt = t
    m_num = y2 * z1 - y1 * z2
    m_den = x2 * z1 - x1 * z2
    if not m_den.is_zero():
        return (m_num * (xt * z1 - x1 * zt) - m_den * (yt * z1 - y1 * zt), m_den * zt * z1)
    if m_num.is_zero():
        m_num = 3 * x1 * x1
        m_den = 2 * y1 * z1
        return (m_num * (xt * z1 - x1 * zt) - m_den * (yt * z1 - y1 * zt), m_den * zt * z1)
    return (xt * z1 - x1 * zt, z1 * zt)


ATE_LOOP_COUNT = -X_PARAM  # 0xd201000000010000
_HARD_EXP = (P**4 - P**2 + 1) // R


@lru_cache(maxsize=1)
def _frob2_basis():
    """w^(i*p^2) for i in 0..11: the basis images under the p^2 Frobenius."""
    wp2 = _W ** (P * P)
    basis = [FQ12.one()]
    for _ in range(11):
        basis.append(basis[-1] * wp2)
    return basis


def _frobenius_p2(f: FQ12) -> FQ12:
    """f^(p^2): the coefficients are in Fp (fixed); w^i -> w^(i p^2)."""
    basis = _frob2_basis()
    acc = FQ12.zero()
    for i, c in enumerate(f.coeffs):
        if c:
            acc = acc + basis[i] * c
    return acc


def final_exponentiation(f: FQ12) -> FQ12:
    f1 = f.conjugate()  # f^(p^6)
    f2 = f1 * f.inv()  # f^(p^6 - 1)
    f3 = _frobenius_p2(f2) * f2  # f^((p^6 - 1)(p^2 + 1))
    return f3**_HARD_EXP


def miller_loop(q_twisted, p_casted) -> FQ12:
    """Ate Miller loop; inputs are E(Fp12) projective points."""
    if is_inf(q_twisted) or is_inf(p_casted):
        return FQ12.one()
    r_pt = q_twisted
    f_num, f_den = FQ12.one(), FQ12.one()
    for b in bin(ATE_LOOP_COUNT)[3:]:  # skip the MSB
        n_, d_ = _linefunc(r_pt, r_pt, p_casted)
        f_num = f_num * f_num * n_
        f_den = f_den * f_den * d_
        r_pt = double(r_pt)
        if b == "1":
            n_, d_ = _linefunc(r_pt, q_twisted, p_casted)
            f_num = f_num * n_
            f_den = f_den * d_
            r_pt = _add_impl(r_pt, q_twisted)
    return f_num / f_den


def pairing(q, p, final: bool = True) -> FQ12:
    """e(p in G1, q in G2) (hbbft's argument order, G2 first)."""
    f = miller_loop(twist(q), cast_g1_to_fq12(p))
    return final_exponentiation(f) if final else f


def pairing_check_eq(p1, q1, p2, q2) -> bool:
    """e(p1, q1) == e(p2, q2), as e(p1, q1) * e(-p2, q2) == 1 with one
    final exponentiation."""
    f = miller_loop(twist(q1), cast_g1_to_fq12(p1)) * miller_loop(
        twist(q2), cast_g1_to_fq12(neg(p2)))
    return final_exponentiation(f) == FQ12.one()


def pairing_product_check(pairs) -> bool:
    """prod e(p_i in G1, q_i in G2) == 1 with one final exponentiation."""
    f = FQ12.one()
    for p, q in pairs:
        f = f * miller_loop(twist(q), cast_g1_to_fq12(p))
    return final_exponentiation(f) == FQ12.one()


# ---------------------------------------------------------------------------
# Hashing onto G2, serialization
# ---------------------------------------------------------------------------


def _expand_message(msg: bytes, domain: bytes, n_bytes: int) -> bytes:
    out = b""
    counter = 0
    while len(out) < n_bytes:
        out += hashlib.sha256(domain + counter.to_bytes(4, "big") + msg).digest()
        counter += 1
    return out[:n_bytes]


def hash_to_fr(msg: bytes, domain: bytes = b"HBTPU-FR") -> int:
    return int.from_bytes(_expand_message(msg, domain, 40), "big") % R


def _hash_to_g2(msg: bytes, domain: bytes = b"HBTPU-G2") -> tuple:
    """Deterministic hash onto the r-torsion of E'(Fp2): try-and-increment
    on x, then cofactor clearing.  The same group element as the JAX
    package's (and its native engine's) hash_to_g2."""
    ctr = 0
    while True:
        raw = _expand_message(msg, domain + ctr.to_bytes(4, "big"), 97)
        x = FQ2([int.from_bytes(raw[0:48], "big"), int.from_bytes(raw[48:96], "big")])
        y = (x * x * x + B2).sqrt()
        if y is not None:
            if raw[96] & 1:
                y = -y
            pt = clear_cofactor_g2((x, y, FQ2.one()))
            if not is_inf(pt):
                return pt
        ctr += 1


# psi = untwist-Frobenius-twist on E'(Fp2): eigenvalue x on G2; phi(x, y) =
# (beta x, y) on E(Fp): eigenvalue -x^2 on G1.  A point passing either test
# has order dividing r.  Cofactor clearing is Budroni-Pintore
# eta = (x^2-x-1) + (x-1) psi + 2 psi^2, which maps all of E'(Fp2) into G2.
_PSI_CX = (FQ2([1, 1]) ** ((P - 1) // 3)).inv()
_PSI_CY = (FQ2([1, 1]) ** ((P - 1) // 2)).inv()
_SQRT_M3 = pow(P - 3, (P + 1) // 4, P)
BETA = (-1 + _SQRT_M3) * pow(2, -1, P) % P  # a cube root of unity for phi


def psi(pt):
    """The p-power endomorphism on E'(Fp2) (projective-safe)."""
    x, y, z = pt
    return (x.conjugate() * _PSI_CX, y.conjugate() * _PSI_CY, z.conjugate())


def in_g1_subgroup(pt) -> bool:
    """phi(P) == [-x^2]P."""
    if is_inf(pt):
        return True
    if _nb.available():
        return _nb.g1_in_subgroup(pt)
    x, y, z = pt
    return eq((FQ(BETA) * x, y, z), neg(_py_multiply(pt, X_PARAM * X_PARAM)))


def in_g2_subgroup(pt) -> bool:
    """psi(P) == [x]P."""
    if is_inf(pt):
        return True
    if _nb.available():
        return _nb.g2_in_subgroup(pt)
    return eq(psi(pt), neg(_py_multiply(pt, -X_PARAM)))


def clear_cofactor_g2(pt):
    """[x^2-x-1]P + [x-1]psi(P) + psi^2(2P): lands in G2 for all of E'.
    Pure-Python internals: the input may carry cofactor components, which
    the subgroup ladders must never see (the native hash clears in C++)."""
    t1 = _py_multiply(pt, X_PARAM * X_PARAM - X_PARAM - 1)
    t2 = _py_multiply(psi(pt), X_PARAM - 1)
    t3 = psi(psi(_py_add(pt, pt)))
    return _py_add(_py_add(t1, t2), t3)


def _fq_sign(n: int) -> int:
    return 1 if n > (P - 1) // 2 else 0


def g1_to_bytes(pt) -> bytes:
    """48-byte compressed encoding (zcash-style flag bits)."""
    aff = normalize(pt)
    if aff is None:
        return bytes([0xC0] + [0] * 47)
    x, y = aff
    out = bytearray(x.n.to_bytes(48, "big"))
    out[0] |= 0x80  # compressed
    if _fq_sign(y.n):
        out[0] |= 0x20
    return bytes(out)


def g1_from_bytes(raw: bytes):
    if len(raw) != 48:
        raise ValueError("G1 encoding must be 48 bytes")
    if raw[0] & 0x40:
        return infinity(FQ)
    if _nb.available():
        return _nb.g1_decompress(raw)
    sign = (raw[0] >> 5) & 1
    x = FQ(int.from_bytes(bytes([raw[0] & 0x1F]) + raw[1:], "big"))
    y = (x * x * x + B1).sqrt()
    if y is None:
        raise ValueError("invalid G1 x coordinate")
    if _fq_sign(y.n) != sign:
        y = -y
    pt = (x, y, FQ(1))
    if not is_on_curve(pt, B1):
        raise ValueError("point not on curve")
    if not in_g1_subgroup(pt):
        # a cofactor component would defeat batch verification's soundness
        raise ValueError("G1 point not in the r-order subgroup")
    return pt


def g2_to_bytes(pt) -> bytes:
    """96-byte compressed encoding (c1 || c0, flags in first byte)."""
    aff = normalize(pt)
    if aff is None:
        return bytes([0xC0] + [0] * 95)
    x, y = aff
    out = bytearray(x.coeffs[1].to_bytes(48, "big") + x.coeffs[0].to_bytes(48, "big"))
    out[0] |= 0x80
    sign = _fq_sign(y.coeffs[1]) if y.coeffs[1] != 0 else _fq_sign(y.coeffs[0])
    if sign:
        out[0] |= 0x20
    return bytes(out)


def g2_from_bytes(raw: bytes):
    if len(raw) != 96:
        raise ValueError("G2 encoding must be 96 bytes")
    if raw[0] & 0x40:
        return infinity(FQ2)
    if _nb.available():
        return _nb.g2_decompress(raw)
    sign = (raw[0] >> 5) & 1
    c1 = int.from_bytes(bytes([raw[0] & 0x1F]) + raw[1:48], "big")
    c0 = int.from_bytes(raw[48:96], "big")
    x = FQ2([c0, c1])
    y = (x * x * x + B2).sqrt()
    if y is None:
        raise ValueError("invalid G2 x coordinate")
    ysign = _fq_sign(y.coeffs[1]) if y.coeffs[1] != 0 else _fq_sign(y.coeffs[0])
    if ysign != sign:
        y = -y
    pt = (x, y, FQ2.one())
    if not is_on_curve(pt, B2):
        raise ValueError("point not on curve")
    if not in_g2_subgroup(pt):
        # E'(Fp2)'s cofactor has small factors (13^2, 23^2, ...): a mauled
        # signature sig + T would pass a batch check with probability ~1/13
        raise ValueError("G2 point not in the r-order subgroup")
    return pt


# ---------------------------------------------------------------------------
# Native dispatch
# ---------------------------------------------------------------------------
# The native host library (native/bls12_381.cpp through crypto/native_bls)
# takes over the public group and pairing operations.  The pure-Python
# definitions above remain the oracle: the tests run both and compare.

_py_multiply = multiply
_py_add = add
_py_pairing_check_eq = pairing_check_eq
_py_pairing_product_check = pairing_product_check
_py_hash_to_g2 = _hash_to_g2

from . import native_bls as _nb  # noqa: E402  (needs FQ/FQ2 defined)


def multiply(pt, n: int):  # noqa: F811
    """Scalar multiplication; native for G1/G2, Python for E(Fp12).
    Correct for any curve point; mul_sub() takes the GLV/GLS ladders for
    points of the r-order subgroup."""
    if _nb.available():
        t = type(pt[0])
        if t is FQ:
            return _nb.g1_mul(pt, n)
        if t is FQ2:
            return _nb.g2_mul(pt, n)
    return _py_multiply(pt, n)


def mul_sub(pt, n: int):
    """Scalar multiplication for points known to lie in the r-order
    subgroup (every protocol point): the 2-dim GLV (G1) / 4-dim GLS (G2)
    ladders natively, the plain ladder otherwise.  Not valid for
    cofactor-bearing points."""
    if _nb.available():
        t = type(pt[0])
        if t is FQ:
            return _nb.g1_mul_sub(pt, n)
        if t is FQ2:
            return _nb.g2_mul_sub(pt, n)
    return _py_multiply(pt, n)


def add(p1, p2):  # noqa: F811
    if _nb.available():
        t = type(p1[2])
        if t is FQ:
            return _nb.g1_add(p1, p2)
        if t is FQ2:
            return _nb.g2_add(p1, p2)
    return _py_add(p1, p2)


def pairing_check_eq(p1, q1, p2, q2) -> bool:  # noqa: F811
    if _nb.available():
        return _nb.pairing_check_eq(p1, q1, p2, q2)
    return _py_pairing_check_eq(p1, q1, p2, q2)


def pairing_product_check(pairs) -> bool:  # noqa: F811
    pairs = list(pairs)
    if _nb.available():
        return _nb.pairing_product_check(pairs)
    return _py_pairing_product_check(pairs)


# Digest-keyed LRU of hash_to_g2: a coin round hashes one document per node
# and the verify paths hash it again.  Keys are digests of (domain, msg),
# never the message bodies.
_H_CACHE: DigestLRU = DigestLRU(4096)


def _hash_cache_clear() -> None:
    _H_CACHE.clear()


def hash_to_g2(msg: bytes, domain: bytes = b"HBTPU-G2") -> tuple:
    """H(msg) onto G2 through the digest cache: native, else `_py_hash_to_g2`."""
    key = hashlib.sha256(len(domain).to_bytes(4, "big") + domain + msg).digest()
    pt = _H_CACHE.get(key)
    if pt is None:
        pt = _nb.hash_to_g2(msg, domain) if _nb.available() else _py_hash_to_g2(msg, domain)
        _H_CACHE.put(key, pt)
    return pt
