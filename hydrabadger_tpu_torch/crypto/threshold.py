"""Threshold BLS signatures and threshold encryption — the host oracle.

Copy of hydrabadger_tpu/crypto/threshold.py (the group operations dispatch
to the native host library through crypto/bls12_381, as there):

  - plain BLS signatures: pk in G1, sig = H_G2(msg) * sk in G2
    (`SecretKey.sign`, `PublicKey.verify`);
  - Shamir secret sharing of sk over Fr (share i is poly(i+1)),
    `poly_interpolate_at_zero`, Lagrange coefficients at zero and
    interpolation in the exponent;
  - signature shares and their combine (the common coin is a
    signature's parity), `PublicKeySet.verify_signature_share`;
  - the label-free hybrid threshold encryption (U, V, W):

        U = g1*r,  V = m xor KDF(pk*r),  W = H_G2(U, V)*r

    with `Ciphertext.verify` (the CCA pairing check), decryption shares
    U*sk_i verified by pairing (`PublicKeyShare.verify_decryption_share`),
    their combine in the exponent and the KDF unwrap.

Every type has `to_bytes` / `from_bytes`, byte-equal to the JAX package's,
so keys, ciphertexts and shares cross between the packages.  Every
function draws from the caller's `random.Random` in the same order as the
original, so a seed gives the same keys and ciphertexts in both packages.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Mapping, Optional, Sequence

from ..utils.lru import DigestLRU
from . import bls12_381 as bls
from .bls12_381 import (
    FQ,
    G1,
    R,
    add,
    eq,
    g1_from_bytes,
    g1_to_bytes,
    g2_from_bytes,
    g2_to_bytes,
    hash_to_g2,
    infinity,
    mul_sub,
    multiply,
    pairing_check_eq,
)

# Signatures by digest of (secret scalar, message): a frame's body is signed
# once per peer stream.
_SIGN_CACHE: "DigestLRU[Signature]" = DigestLRU(1024)

# ---------------------------------------------------------------------------
# Fr helpers
# ---------------------------------------------------------------------------


def fr_random(rng) -> int:
    """Random nonzero Fr scalar from a `random.Random`-like rng."""
    while True:
        v = rng.getrandbits(256) % R
        if v:
            return v


def poly_random(degree: int, rng) -> list[int]:
    """Random polynomial over Fr: coeffs[k] is the x^k coefficient."""
    return [fr_random(rng) for _ in range(degree + 1)]


def poly_eval(coeffs: Sequence[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % R
    return acc


def lagrange_coeffs_at_zero(xs: Sequence[int]) -> list[int]:
    out = []
    for xi in xs:
        num, den = 1, 1
        for xj in xs:
            if xj == xi:
                continue
            num = num * xj % R
            den = den * (xj - xi) % R
        out.append(num * pow(den, -1, R) % R)
    return out


def poly_interpolate_at_zero(points: Mapping[int, int]) -> int:
    """Interpolate the polynomial through {x: y} (distinct x in Fr) at 0."""
    xs = list(points)
    return sum(points[x] * lam for x, lam in zip(xs, lagrange_coeffs_at_zero(xs))) % R


def interpolate_g_at_zero(points: Mapping[int, tuple]) -> tuple:
    """Lagrange interpolation *in the exponent*: sum of lambda_i * P_i at
    x=0, as one native weighted sum where the library is selected."""
    from . import native_bls as _nb

    xs = list(points.keys())
    lam = lagrange_coeffs_at_zero(xs)
    field = bls._field(points[xs[0]])
    if _nb.available():
        pts = [points[xi] for xi in xs]
        if field is FQ:
            return _nb.g1_weighted_sum(pts, lam)
        if field is bls.FQ2:
            return _nb.g2_weighted_sum(pts, lam)
    acc = infinity(field)
    for xi, li in zip(xs, lam):
        acc = add(acc, multiply(points[xi], li))
    return acc


def _kdf(point, n_bytes: int, domain: bytes = b"HBTPU-KDF") -> bytes:
    return bls._expand_message(g1_to_bytes(point), domain, n_bytes)


def unwrap_ciphertext(g, ct: "Ciphertext") -> bytes:
    """Recover the plaintext from the combined share point g = U*sk: the one
    KDF-XOR unwrap of the host path and the batched device engine."""
    return bytes(a ^ b for a, b in zip(ct.v, _kdf(g, len(ct.v))))


def _te_hash(ct: "Ciphertext") -> tuple:
    """H_G2(U, V), the point W is a multiple of."""
    return hash_to_g2(g1_to_bytes(ct.u) + ct.v, b"HBTPU-TE")


# ---------------------------------------------------------------------------
# Keys and signatures
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Signature:
    """BLS signature: a G2 point."""

    point: tuple

    def to_bytes(self) -> bytes:
        return g2_to_bytes(self.point)

    @classmethod
    def from_bytes(cls, raw: bytes) -> "Signature":
        return cls(g2_from_bytes(raw))

    def parity(self) -> bool:
        """Deterministic bit of the signature — the common-coin value."""
        return bool(hashlib.sha256(self.to_bytes()).digest()[0] & 1)

    def __eq__(self, other):
        return isinstance(other, Signature) and eq(self.point, other.point)

    def __hash__(self):
        return hash(self.to_bytes())


class SignatureShare(Signature):
    pass


@dataclass(frozen=True)
class PublicKey:
    """G1 public key."""

    point: tuple

    def to_bytes(self) -> bytes:
        return g1_to_bytes(self.point)

    @classmethod
    def from_bytes(cls, raw: bytes) -> "PublicKey":
        return cls(g1_from_bytes(raw))

    def verify(self, sig: Signature, msg: bytes) -> bool:
        return pairing_check_eq(G1, sig.point, self.point, hash_to_g2(msg))  # e(g1, sig) == e(pk, H)

    def encrypt(self, msg: bytes, rng) -> "Ciphertext":
        r = fr_random(rng)
        u = mul_sub(G1, r)
        v = bytes(a ^ b for a, b in zip(msg, _kdf(mul_sub(self.point, r), len(msg))))
        w = mul_sub(hash_to_g2(g1_to_bytes(u) + v, b"HBTPU-TE"), r)
        return Ciphertext(u, v, w)

    def __eq__(self, other):
        return isinstance(other, PublicKey) and eq(self.point, other.point)

    def __hash__(self):
        return hash(self.to_bytes())


class PublicKeyShare(PublicKey):
    def verify_decryption_share(self, share: "DecryptionShare", ct: "Ciphertext") -> bool:
        return pairing_check_eq(share.point, _te_hash(ct), self.point, ct.w)  # e(S_i, H) == e(pk_i, W)


@dataclass(frozen=True)
class SecretKey:
    """Fr scalar secret key."""

    scalar: int

    @classmethod
    def random(cls, rng) -> "SecretKey":
        return cls(fr_random(rng))

    @classmethod
    def from_bytes(cls, raw: bytes) -> "SecretKey":
        return cls(int.from_bytes(raw, "big") % R)

    def to_bytes(self) -> bytes:
        return self.scalar.to_bytes(32, "big")

    def __repr__(self) -> str:
        # never the scalar
        return f"<{type(self).__name__} [redacted]>"

    def public_key(self) -> PublicKey:
        return PublicKey(mul_sub(G1, self.scalar))

    def sign(self, msg: bytes) -> Signature:
        # digest-keyed LRU: a broadcast frame is signed once per peer
        # stream with the same body (net/peer.Peers.wire_to_all); keys are
        # digests, never message bodies
        key = hashlib.sha256(self.scalar.to_bytes(32, "big") + hashlib.sha256(msg).digest()).digest()
        sig = _SIGN_CACHE.get(key)
        if sig is None:
            sig = Signature(mul_sub(hash_to_g2(msg), self.scalar))
            _SIGN_CACHE.put(key, sig)
        return sig

    def decrypt(self, ct: "Ciphertext", verify: bool = True) -> Optional[bytes]:
        """Non-threshold decryption by the whole key's owner; `verify=False`
        skips the CCA pairing check."""
        if verify and not ct.verify():
            return None
        return unwrap_ciphertext(mul_sub(ct.u, self.scalar), ct)


class SecretKeyShare(SecretKey):
    def sign_share(self, msg: bytes) -> SignatureShare:
        return SignatureShare(mul_sub(hash_to_g2(msg), self.scalar))

    def decrypt_share(self, ct: "Ciphertext") -> "DecryptionShare":
        return DecryptionShare(mul_sub(ct.u, self.scalar))

    def public_key_share(self) -> PublicKeyShare:
        return PublicKeyShare(mul_sub(G1, self.scalar))


# ---------------------------------------------------------------------------
# Threshold encryption
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Ciphertext:
    u: tuple  # G1
    v: bytes
    w: tuple  # G2

    def verify(self) -> bool:
        """CCA check: e(g1, W) == e(U, H(U, V))."""
        return pairing_check_eq(G1, self.w, self.u, _te_hash(self))

    def to_bytes(self) -> bytes:
        return g1_to_bytes(self.u) + g2_to_bytes(self.w) + self.v

    @classmethod
    def from_bytes(cls, raw: bytes) -> "Ciphertext":
        return cls(g1_from_bytes(raw[:48]), raw[144:], g2_from_bytes(raw[48:144]))

    def __eq__(self, other):
        return (isinstance(other, Ciphertext) and eq(self.u, other.u) and self.v == other.v
                and eq(self.w, other.w))

    def __hash__(self):
        return hash(self.to_bytes())


@dataclass(frozen=True)
class DecryptionShare:
    point: tuple  # G1: U * sk_i

    def to_bytes(self) -> bytes:
        return g1_to_bytes(self.point)

    @classmethod
    def from_bytes(cls, raw: bytes) -> "DecryptionShare":
        return cls(g1_from_bytes(raw))


# ---------------------------------------------------------------------------
# Key sets (Shamir)
# ---------------------------------------------------------------------------


class SecretKeySet:
    """Dealer-side master polynomial; degree == threshold t."""

    def __init__(self, coeffs: Sequence[int]):
        self.coeffs = [c % R for c in coeffs]

    def __repr__(self) -> str:
        # coefficients ARE the master secret; repr only the degree
        return f"<SecretKeySet t={self.threshold} [redacted]>"

    @classmethod
    def random(cls, threshold: int, rng) -> "SecretKeySet":
        return cls(poly_random(threshold, rng))

    @property
    def threshold(self) -> int:
        return len(self.coeffs) - 1

    def secret_key(self) -> SecretKey:
        return SecretKey(self.coeffs[0])

    def secret_key_share(self, i: int) -> SecretKeyShare:
        return SecretKeyShare(poly_eval(self.coeffs, i + 1))

    def public_keys(self) -> "PublicKeySet":
        return PublicKeySet([mul_sub(G1, c) for c in self.coeffs])


class PublicKeySet:
    """Commitment to the master polynomial: a G1 point per coefficient."""

    def __init__(self, commitment: Sequence[tuple]):
        self.commitment = list(commitment)
        # share keys are pure in i and asked for every epoch: one per index
        self._share_cache: dict = {}

    @property
    def threshold(self) -> int:
        return len(self.commitment) - 1

    def public_key(self) -> PublicKey:
        return PublicKey(self.commitment[0])

    def public_key_share(self, i: int) -> PublicKeyShare:
        share = self._share_cache.get(i)
        if share is None:
            x, acc, xk = i + 1, infinity(FQ), 1
            for c in self.commitment:
                acc = add(acc, mul_sub(c, xk))
                xk = xk * x % R
            share = self._share_cache[i] = PublicKeyShare(acc)
        return share

    def verify_signature_share(self, i: int, share: SignatureShare, msg: bytes) -> bool:
        return self.public_key_share(i).verify(share, msg)

    def combine_signatures(self, shares: Mapping[int, SignatureShare]) -> Signature:
        """Lagrange-combine >= t+1 verified shares (indexed by node i)."""
        if len(shares) <= self.threshold:
            raise ValueError(f"need {self.threshold + 1} shares, got {len(shares)}")
        pts = {i + 1: s.point for i, s in shares.items()}
        return Signature(interpolate_g_at_zero(pts))

    def decrypt(self, shares: Mapping[int, DecryptionShare], ct: Ciphertext) -> bytes:
        """Lagrange-combine >= t+1 decryption shares in the exponent, then unwrap."""
        if len(shares) <= self.threshold:
            raise ValueError(f"need {self.threshold + 1} shares, got {len(shares)}")
        pts = {i + 1: s.point for i, s in shares.items()}
        return unwrap_ciphertext(interpolate_g_at_zero(pts), ct)

    def to_bytes(self) -> bytes:
        return b"".join(g1_to_bytes(c) for c in self.commitment)

    @classmethod
    def from_bytes(cls, raw: bytes) -> "PublicKeySet":
        if len(raw) % 48:
            raise ValueError("bad PublicKeySet encoding")
        return cls([g1_from_bytes(raw[i : i + 48]) for i in range(0, len(raw), 48)])

    def __eq__(self, other):
        return (isinstance(other, PublicKeySet) and len(self.commitment) == len(other.commitment)
                and all(eq(a, b) for a, b in zip(self.commitment, other.commitment)))

    def __hash__(self):
        return hash(self.to_bytes())
