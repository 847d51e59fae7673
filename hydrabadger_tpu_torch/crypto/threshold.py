"""Shamir key sets and threshold decryption shares — the host oracle.

Copy of what the full-crypto epoch needs of
hydrabadger_tpu/crypto/threshold.py: the Fr helpers, `SecretKeySet`
(dealer-side master polynomial; share i is poly(i+1)), the Lagrange
coefficients at zero, interpolation in the exponent, and
`DecryptionShare`.  Every function draws from the caller's
`random.Random` in the same order as the original, so a seed gives the
same key set in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

from .bls12_381 import R, add, infinity, multiply


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
    acc = infinity()
    for xi, li in zip(xs, lagrange_coeffs_at_zero(xs)):
        acc = add(acc, multiply(points[xi], li))
    return acc


@dataclass(frozen=True)
class SecretKey:
    """Fr scalar secret key."""

    scalar: int


class SecretKeyShare(SecretKey):
    pass


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
