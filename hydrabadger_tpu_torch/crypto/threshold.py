"""Shamir key sets, threshold decryption and signature shares — the host oracle.

Copy of what the port's epochs need of hydrabadger_tpu/crypto/threshold.py:
the Fr helpers, `SecretKeySet` (dealer-side master polynomial; share i is
poly(i+1)), the Lagrange coefficients at zero, interpolation in the
exponent, the G2 `Signature` / `SignatureShare` (the common coin is a
signature's parity), `SecretKeyShare.sign_share` and
`PublicKeySet.combine_signatures`, and the label-free hybrid threshold
encryption (U, V, W):

    U = g1*r,  V = m xor KDF(pk*r),  W = H_G2(U, V)*r

with `PublicKey.encrypt`, `SecretKeyShare.decrypt_share` (U*sk_i, a
`DecryptionShare`), `PublicKeySet.decrypt` (combine in the exponent,
then the KDF unwrap) and `unwrap_ciphertext`.  Every function draws from
the caller's `random.Random` in the same order as the original, so a seed
gives the same keys and ciphertexts in both packages.  Pairing
verification (of ciphertexts and of shares) is not copied yet.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Mapping, Sequence

from . import bls12_381 as bls
from .bls12_381 import (
    G1,
    R,
    add,
    eq,
    g1_to_bytes,
    g2_to_bytes,
    hash_to_g2,
    infinity,
    mul_sub,
    multiply,
)


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


def interpolate_g_at_zero(points: Mapping[int, tuple]) -> tuple:
    """Lagrange interpolation *in the exponent*: sum of lambda_i * P_i at x=0."""
    xs = list(points.keys())
    first = points[xs[0]]
    acc = infinity(type(first[0]))
    for xi, li in zip(xs, lagrange_coeffs_at_zero(xs)):
        acc = add(acc, multiply(points[xi], li))
    return acc


def _kdf(point, n_bytes: int, domain: bytes = b"HBTPU-KDF") -> bytes:
    return bls._expand_message(g1_to_bytes(point), domain, n_bytes)


def unwrap_ciphertext(g, ct: "Ciphertext") -> bytes:
    """Recover the plaintext from the combined share point g = U*sk: the one
    KDF-XOR unwrap of the host path and the batched device engine."""
    return bytes(a ^ b for a, b in zip(ct.v, _kdf(g, len(ct.v))))


@dataclass(frozen=True)
class Signature:
    """BLS signature: a G2 point."""

    point: tuple

    def to_bytes(self) -> bytes:
        return g2_to_bytes(self.point)

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

    def encrypt(self, msg: bytes, rng) -> "Ciphertext":
        r = fr_random(rng)
        u = mul_sub(G1, r)
        v = bytes(a ^ b for a, b in zip(msg, _kdf(mul_sub(self.point, r), len(msg))))
        w = mul_sub(hash_to_g2(g1_to_bytes(u) + v, b"HBTPU-TE"), r)
        return Ciphertext(u, v, w)


@dataclass(frozen=True)
class SecretKey:
    """Fr scalar secret key."""

    scalar: int

    def __repr__(self) -> str:
        # never the scalar
        return f"<{type(self).__name__} [redacted]>"


class SecretKeyShare(SecretKey):
    def sign_share(self, msg: bytes) -> SignatureShare:
        return SignatureShare(mul_sub(hash_to_g2(msg), self.scalar))

    def decrypt_share(self, ct: "Ciphertext") -> "DecryptionShare":
        return DecryptionShare(mul_sub(ct.u, self.scalar))


@dataclass(frozen=True)
class Ciphertext:
    u: tuple  # G1
    v: bytes
    w: tuple  # G2

    def to_bytes(self) -> bytes:
        return g1_to_bytes(self.u) + g2_to_bytes(self.w) + self.v

    def __eq__(self, other):
        return (isinstance(other, Ciphertext) and eq(self.u, other.u) and self.v == other.v
                and eq(self.w, other.w))

    def __hash__(self):
        return hash(self.to_bytes())


@dataclass(frozen=True)
class DecryptionShare:
    point: tuple  # G1: U * sk_i


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

    @property
    def threshold(self) -> int:
        return len(self.commitment) - 1

    def public_key(self) -> PublicKey:
        return PublicKey(self.commitment[0])

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
