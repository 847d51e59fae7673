"""The plain optimal-ate pairing of BLS12-381 over Python integers, and the
verified threshold-decrypt epoch's semantics.

The tower: Fp2 = Fp[u]/(u^2 + 1) (reference/g2), Fp6 = Fp2[v]/(v^3 - xi)
with xi = 1 + u, Fp12 = Fp6[w]/(w^2 - v), so w^6 = xi.  An Fp6 element is
a triple of Fp2 coefficients of (1, v, v^2), an Fp12 element a pair
(g, h) = g + h w.

The pairing, textbook: G2 maps into E(Fp12) by the untwist
psi(x, y) = (x w^-2, y w^-3); the Miller loop runs over the bits of
|x| = 0xd201000000010000 with affine steps on the twist, each line through
psi(T) evaluated at P in full,

    l(P) = yP - lambda xP w^-1 + (lambda xT - yT) w^-3,

no factor dropped; x < 0, so f is conjugated at the end; the final
exponentiation is f^((p^6 - 1)(p^2 + 1)) by a conjugate, an inverse and
the p^2 Frobenius, then the hard part (p^4 - p^2 + 1) / r by square and
multiply.  Exact, slow (a tenth of a second or so a check).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from . import g1, g2
from .g2 import ONE, ZERO, f2_add, f2_conj, f2_inv, f2_mul, f2_neg, f2_pow, f2_scale, f2_sub

P, R = g1.P, g1.R
X_ABS = 0xD201000000010000
XI = (1, 1)
HARD = (P**4 - P**2 + 1) // R

# -- Fp6 ------------------------------------------------------------------------


def _mxi(a):
    """a * xi = (a0 - a1) + (a0 + a1) u."""
    return ((a[0] - a[1]) % P, (a[0] + a[1]) % P)


def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_neg(a):
    return tuple(f2_neg(x) for x in a)


def f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0, t1, t2 = f2_mul(a0, b0), f2_mul(a1, b1), f2_mul(a2, b2)
    c0 = f2_add(t0, _mxi(f2_add(f2_mul(a1, b2), f2_mul(a2, b1))))
    c1 = f2_add(f2_add(f2_mul(a0, b1), f2_mul(a1, b0)), _mxi(t2))
    c2 = f2_add(f2_add(f2_mul(a0, b2), f2_mul(a2, b0)), t1)
    return (c0, c1, c2)


def f6_mul_v(a):
    """a * v."""
    return (_mxi(a[2]), a[0], a[1])


def f6_inv(a):
    a0, a1, a2 = a
    c0 = f2_sub(f2_mul(a0, a0), _mxi(f2_mul(a1, a2)))
    c1 = f2_sub(_mxi(f2_mul(a2, a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_mul(a1, a1), f2_mul(a0, a2))
    t = f2_add(f2_mul(a0, c0), _mxi(f2_add(f2_mul(a2, c1), f2_mul(a1, c2))))
    ti = f2_inv(t)
    return (f2_mul(c0, ti), f2_mul(c1, ti), f2_mul(c2, ti))


F6_ZERO = (ZERO, ZERO, ZERO)
F6_ONE = (ONE, ZERO, ZERO)

# -- Fp12 -----------------------------------------------------------------------

F12_ONE = (F6_ONE, F6_ZERO)


def f12_mul(a, b):
    g0, h0 = a
    g1_, h1 = b
    t0, t1 = f6_mul(g0, g1_), f6_mul(h0, h1)
    cross = f6_sub(f6_sub(f6_mul(f6_add(g0, h0), f6_add(g1_, h1)), t0), t1)
    return (f6_add(t0, f6_mul_v(t1)), cross)


def f12_conj(a):
    return (a[0], f6_neg(a[1]))


def f12_inv(a):
    """(g + h w)^-1 = (g - h w) / (g^2 - h^2 v)."""
    g, h = a
    d = f6_inv(f6_sub(f6_mul(g, g), f6_mul_v(f6_mul(h, h))))
    return (f6_mul(g, d), f6_neg(f6_mul(h, d)))


def f12_pow(a, k: int):
    out = F12_ONE
    for bit in bin(k)[2:]:
        out = f12_mul(out, out)
        if bit == "1":
            out = f12_mul(out, a)
    return out


def _coeffs(a) -> List[Tuple[int, int]]:
    """a as six Fp2 coefficients of w^0 .. w^5 (g_k at w^2k, h_k at w^2k+1)."""
    (g0, g1_, g2_), (h0, h1, h2) = a
    return [g0, h0, g1_, h1, g2_, h2]


def _from_coeffs(c):
    return ((c[0], c[2], c[4]), (c[1], c[3], c[5]))


# (c w^i)^p = conj(c) xi^(i (p - 1) / 6) w^i
_GAMMA = [f2_pow(XI, i * (P - 1) // 6) for i in range(6)]


def f12_frob(a):
    return _from_coeffs([f2_mul(f2_conj(c), gm) for c, gm in zip(_coeffs(a), _GAMMA)])


def f12_scale(a, s):
    """a * s for s in Fp2."""
    return _from_coeffs([f2_mul(c, s) for c in _coeffs(a)])


def f12_of_fp(x: int):
    return (((x % P, 0), ZERO, ZERO), F6_ZERO)


W = (F6_ZERO, F6_ONE)
W_INV = f12_inv(W)
W_INV3 = f12_mul(f12_mul(W_INV, W_INV), W_INV)

# -- the pairing ------------------------------------------------------------------

Affine1 = Optional[Tuple[int, int]]
Affine2 = Optional[Tuple[Tuple[int, int], Tuple[int, int]]]


def _line(lam, xt, yt, p: Tuple[int, int]):
    """The line of slope lambda through psi(T), at P: yP - lambda xP w^-1
    + (lambda xT - yT) w^-3."""
    xp, yp = p
    a = f2_neg(f2_scale(lam, xp))
    b = f2_sub(f2_mul(lam, xt), yt)
    l = f12_of_fp(yp)
    for coef, basis in ((a, W_INV), (b, W_INV3)):
        term = f12_scale(basis, coef)
        l = (f6_add(l[0], term[0]), f6_add(l[1], term[1]))
    return l


def miller(p: Affine1, q: Affine2):
    """The ate Miller loop f_{x, Q}(P), conjugated for x < 0 (1 where P or
    Q is infinity)."""
    if p is None or q is None:
        return F12_ONE
    f = F12_ONE
    xt, yt = q
    for bit in bin(X_ABS)[3:]:
        lam = f2_mul(f2_scale(f2_mul(xt, xt), 3), f2_inv(f2_scale(yt, 2)))
        f = f12_mul(f12_mul(f, f), _line(lam, xt, yt, p))
        x3 = f2_sub(f2_mul(lam, lam), f2_scale(xt, 2))
        xt, yt = x3, f2_sub(f2_mul(lam, f2_sub(xt, x3)), yt)
        if bit == "1":
            xq, yq = q
            lam = f2_mul(f2_sub(yq, yt), f2_inv(f2_sub(xq, xt)))
            f = f12_mul(f, _line(lam, xt, yt, p))
            x3 = f2_sub(f2_sub(f2_mul(lam, lam), xt), xq)
            xt, yt = x3, f2_sub(f2_mul(lam, f2_sub(xt, x3)), yt)
    return f12_conj(f)


def final_exp(f):
    """f^((p^12 - 1) / r)."""
    f = f12_mul(f12_conj(f), f12_inv(f))  # ^(p^6 - 1)
    f = f12_mul(f12_frob(f12_frob(f)), f)  # ^(p^2 + 1)
    return f12_pow(f, HARD)


def pairing(p: Affine1, q: Affine2):
    return final_exp(miller(p, q))


def check_eq(a: Affine1, b: Affine2, c: Affine1, d: Affine2) -> bool:
    """e(a, b) == e(c, d), as f_b(a) f_d(-c) with one final exponentiation."""
    neg_c = None if c is None else (c[0], -c[1] % P)
    return final_exp(f12_mul(miller(a, b), miller(neg_c, d))) == F12_ONE


# -- the verified epoch -------------------------------------------------------------

G1_AFF = (g1.G[0], g1.G[1])


def share_valid(share: Affine1, h: Affine2, pk: Affine1, w: Affine2) -> bool:
    """hbbft's decryption-share check: e(S_i, H) == e(pk_i, W)."""
    return check_eq(share, h, pk, w)


def ciphertext_valid(u: Affine1, w: Affine2, h: Affine2) -> bool:
    """The ciphertext's check: e(G1, W) == e(U, H)."""
    return check_eq(G1_AFF, w, u, h)


def forged_share(share: g1.Point, u: g1.Point) -> g1.Point:
    """What faulty node n - f + k sends for quorum node k's share S_k:
    S_k + U, a point of G1 that is no node's share."""
    return g1.add(share, u)


def verified_epoch(u: g1.Point, w: g2.Point, h: Affine2, sks: Sequence[int], master: int,
                   quorum: Sequence[int], faulty: Sequence[int]) -> Dict[str, object]:
    """One epoch of one ciphertext (U, W) with hash point H, plainly: every
    quorum node i's share U sk_i, and faulty node faulty[k]'s forged share
    (U sk_quorum[k]) + U, are each checked against the sender's public key
    share sk_i G1; the ciphertext is checked; the quorum's shares combine
    to U master and the next ciphertext is (U, W) (master + 1).  Returns
    the verdicts {"forged": [len(faulty)], "quorum": [len(quorum)],
    "ciphertext": bool} and "u_next", "w_next" (Jacobian)."""
    shares = [g1.mul(u, sks[i]) for i in quorum]
    forged = [forged_share(shares[k], u) for k in range(len(faulty))]
    w_aff = g2.to_affine([w])[0]
    pks = {i: g1.to_affine([g1.mul(g1.G, sks[i])])[0] for i in [*quorum, *faulty]}
    aff = g1.to_affine(shares + forged)
    return {
        "quorum": [share_valid(aff[k], h, pks[i], w_aff) for k, i in enumerate(quorum)],
        "forged": [share_valid(aff[len(quorum) + k], h, pks[i], w_aff)
                   for k, i in enumerate(faulty)],
        "ciphertext": ciphertext_valid(g1.to_affine([u])[0], w_aff, h),
        "u_next": g1.decrypt_epoch(u, sks, quorum),
        "w_next": g2.mul(w, master + 1),
    }
