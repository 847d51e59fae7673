"""Batched BLS12-381 pairing checks on kernel B3: share verification.

Counterpart of hydrabadger_tpu/ops/pairing_jax.py (the circuit recorders
and `pairing_eq_batch`) and ops/pairing_T.py (the launch sequence).  B independent
checks e(a_i, b_i) == e(c_i, d_i) run as recorded Fp circuits on
ops/circuit_torch's executor (kernel B3, csrc/circuit.cu, for CUDA
tensors; its plain version for CPU tensors):

  - Fp12 = Fp2[w]/(w^6 - xi) via Fp6[w]/(w^2 - v), 12 Fp elements in the
    slot order (g0, g1, g2, h0, h1, h2) of w-powers (0, 2, 4, 1, 3, 5),
    each slot an Fp2 pair (c0, c1);
  - the ate Miller loop of both sides as one batch of 2B lanes, segmented
    over the static bits of |x|: 63 launches of the one-step double-and-
    tangent circuit and 5 of the chord-and-add circuit, the lines sparse
    (w^0, w^3, w^5) with the Fp2 factors the final exponentiation kills
    dropped;
  - the final exponentiation by 3 lambda, exact for the check f == 1:
    Granger-Scott cyclotomic squarings, Fp12 products fused with a
    conjugate and a Frobenius, and one Fp12 inversion whose single Fp
    inversion per lane is one launch of a recorded Fermat circuit (the
    square-and-multiply chain of p - 2, one product per layer).

Every launch is one `CircuitExec` call on a [n_inputs, 12, lanes] batch;
the Miller loop's operands are re-packed by `torch.cat` between launches.
`schedule(B)` gives the launches one batch of B checks makes, by circuit
name.  JAX's `HB_PAIRING_UNROLL` (k chained steps per circuit) is left
out: its 4-step Miller double needs more shared memory than one B3
block has.  Lanes with a point at infinity never reach the device: the
host oracle answers them.
"""
from __future__ import annotations

import time
from collections import Counter
from functools import lru_cache
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from ..crypto import bls12_381 as bls
from ..crypto.bls12_381 import P
from ..device import resolve_device
from . import roofline
from .circuit_torch import CircuitExec, executor
from .fp12_circuit import CircuitBuilder, Sym
from .fq_torch import fq_sub
from .limbs import N_LIMBS, R_MONT, int_to_limbs, ints_to_limbs_batch

X_ABS = 0xD201000000010000  # |x|, the BLS parameter magnitude

# Host seconds of the entries' conversions, by step (chip_smoke reads and
# resets them): "normalize_batch", "words" (Montgomery words and the
# upload), "oracle" (infinity lanes), and the engine's "hash_to_g2".
host_s: Dict[str, float] = Counter()

# ---------------------------------------------------------------------------
# Symbolic tower (values are fp12_circuit.Sym handles)
# ---------------------------------------------------------------------------


class S2:
    """Fp2 = Fp[u]/(u^2+1) over circuit symbols."""

    def __init__(self, c0: Sym, c1: Sym):
        self.c = (c0, c1)

    def __add__(self, o):
        return S2(self.c[0] + o.c[0], self.c[1] + o.c[1])

    def __sub__(self, o):
        return S2(self.c[0] - o.c[0], self.c[1] - o.c[1])

    def __neg__(self):
        return S2(-self.c[0], -self.c[1])

    def dbl(self):
        return S2(self.c[0].dbl(), self.c[1].dbl())

    def __mul__(self, o):
        # Karatsuba: 3 lane products
        t0 = self.c[0] * o.c[0]
        t1 = self.c[1] * o.c[1]
        t2 = (self.c[0] + self.c[1]) * (o.c[0] + o.c[1])
        return S2(t0 - t1, t2 - t0 - t1)

    def mul_fp(self, s: Sym):
        return S2(self.c[0] * s, self.c[1] * s)

    def mul_xi(self):
        return S2(self.c[0] - self.c[1], self.c[0] + self.c[1])

    def conj(self):
        return S2(self.c[0], -self.c[1])


class S6:
    """Fp6 = Fp2[v]/(v^3 - xi)."""

    def __init__(self, c0: S2, c1: S2, c2: S2):
        self.c = (c0, c1, c2)

    def __add__(self, o):
        return S6(*(a + b for a, b in zip(self.c, o.c)))

    def __sub__(self, o):
        return S6(*(a - b for a, b in zip(self.c, o.c)))

    def __neg__(self):
        return S6(*(-a for a in self.c))

    def __mul__(self, o):
        a0, a1, a2 = self.c
        b0, b1, b2 = o.c
        t0 = a0 * b0
        t1 = a1 * b1
        t2 = a2 * b2
        c0 = t0 + ((a1 + a2) * (b1 + b2) - t1 - t2).mul_xi()
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_xi()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return S6(c0, c1, c2)

    def mul_v(self):
        return S6(self.c[2].mul_xi(), self.c[0], self.c[1])


class S12:
    """Fp12 = Fp6[w]/(w^2 - v)."""

    def __init__(self, g: S6, h: S6):
        self.g = g
        self.h = h

    def __mul__(self, o):
        t0 = self.g * o.g
        t1 = self.h * o.h
        t2 = (self.g + self.h) * (o.g + o.h) - t0 - t1
        return S12(t0 + t1.mul_v(), t2)

    def sqr(self):
        gh = self.g * self.h
        big = (self.g + self.h) * (self.g + self.h.mul_v())
        return S12(big - gh - gh.mul_v(), gh + gh)

    def conj(self):
        return S12(self.g, -self.h)

    def coeffs(self):
        out = []
        for six in (self.g, self.h):
            for two in six.c:
                out.extend(two.c)
        return out


def _s12_from_inputs(b: CircuitBuilder, base: int) -> S12:
    def two(i):
        return S2(b.input(base + i), b.input(base + i + 1))

    return S12(S6(two(0), two(2), two(4)), S6(two(6), two(8), two(10)))


def _s2_from_inputs(b: CircuitBuilder, base: int) -> S2:
    return S2(b.input(base), b.input(base + 1))


# Frobenius: slot s of (g0,g1,g2,h0,h1,h2) carries w-power (0,2,4,1,3,5);
# coefficient conj (k odd) then multiply by xi^(j (p^k-1)/6) in Fp2.
_WPOW = (0, 2, 4, 1, 3, 5)


def _frob_sym(b: CircuitBuilder, f: S12, k: int) -> S12:
    xi = bls.FQ2([1, 1])
    outs = []
    for s, two in enumerate([*f.g.c, *f.h.c]):
        if k % 2 == 1:
            two = two.conj()
        cst = xi ** (_WPOW[s] * (P**k - 1) // 6)
        outs.append(two * S2(b.const(cst.coeffs[0] * R_MONT), b.const(cst.coeffs[1] * R_MONT)))
    return S12(S6(outs[0], outs[1], outs[2]), S6(outs[3], outs[4], outs[5]))


# ---------------------------------------------------------------------------
# Circuits (each a CircuitExec named for the launch counters)
# ---------------------------------------------------------------------------


def _sparse035(f: S12, a0: S2, a3: S2, a5: S2) -> S12:
    """f *= a0 + a3 w^3 + a5 w^5 (tower slots c0.c0, c1.c1, c1.c2)."""
    g, h = f.g, f.h
    t0 = S6(g.c[0] * a0, g.c[1] * a0, g.c[2] * a0)
    d0, d1, d2 = h.c
    t1 = S6(
        (d1 * a5 + d2 * a3).mul_xi(),
        d0 * a3 + (d2 * a5).mul_xi(),
        d0 * a5 + d1 * a3,
    )
    t2 = (g + h) * S6(a0, a3, a5)
    return S12(t0 + t1.mul_v(), t2 - t0 - t1)


def _miller_dbl_step(f: S12, X: S2, Y: S2, Z: S2, px, py):
    """One squaring-and-tangent Miller iteration on symbols."""
    f2 = f.sqr()
    XX = X * X
    YY = Y * Y
    S = Y * Z
    ZZ = Z * Z
    a0 = -(Y * ZZ).dbl().mul_fp(py).mul_xi()
    X3 = XX * X
    a3 = (YY * Z).dbl() - (X3.dbl() + X3)
    t = XX * Z
    a5 = (t.dbl() + t).mul_fp(px)
    fd = _sparse035(f2, a0, a3, a5)
    W = XX.dbl() + XX
    B = (X * Y) * S
    B4 = B.dbl().dbl()
    H = W * W - B4.dbl()
    S2_ = S * S
    Rd_x = (H * S).dbl()
    Rd_y = W * (B4 - H) - (YY * S2_).dbl().dbl().dbl()
    Rd_z = (S * S2_).dbl().dbl().dbl()
    return fd, Rd_x, Rd_y, Rd_z


@lru_cache(maxsize=None)
def _miller_dbl_circuit_k(k: int) -> CircuitExec:
    """k chained Miller double steps as one circuit.  Only k = 1 fits one
    B3 block (k = 4 needs ~278,000 B of shared memory; CircuitExec raises)."""
    b = CircuitBuilder(24)
    f = _s12_from_inputs(b, 0)
    X = _s2_from_inputs(b, 12)
    Y = _s2_from_inputs(b, 14)
    Z = _s2_from_inputs(b, 16)
    px, py = b.input(22), b.input(23)
    for _ in range(k):
        f, X, Y, Z = _miller_dbl_step(f, X, Y, Z, px, py)
    return executor(b.compile(f.coeffs() + [*X.c, *Y.c, *Z.c]),
                    "miller_dbl" if k == 1 else f"miller_dbl{k}")


def _miller_dbl_circuit() -> CircuitExec:
    """Inputs: f(12) R(6: X,Y,Z as Fp2 pairs) qx(2) qy(2) px(1) py(1) =
    24.  Outputs: f_dbl(12), R_dbl(6): one squaring-and-tangent step."""
    return _miller_dbl_circuit_k(1)


@lru_cache(maxsize=None)
def _miller_add_circuit() -> CircuitExec:
    """Inputs as _miller_dbl_circuit.  Outputs: f_add(12), R_add(6), the
    chord-and-mixed-add at a set ate bit (after that iteration's double)."""
    b = CircuitBuilder(24)
    f = _s12_from_inputs(b, 0)
    X = _s2_from_inputs(b, 12)
    Y = _s2_from_inputs(b, 14)
    Z = _s2_from_inputs(b, 16)
    qx = _s2_from_inputs(b, 18)
    qy = _s2_from_inputs(b, 20)
    px, py = b.input(22), b.input(23)

    lam = qy * Z - Y
    dl = qx * Z - X
    b0 = -(dl.mul_fp(py) * Z).mul_xi()
    b3 = dl * Y - lam * X
    b5 = (lam * Z).mul_fp(px)
    fa = _sparse035(f, b0, b3, b5)
    l2 = lam * lam
    d2 = dl * dl
    d3 = d2 * dl
    d2x = d2 * X
    A = l2 * Z - d3 - d2x.dbl()
    Ra_x = dl * A
    Ra_y = lam * (d2x - A) - d3 * Y
    Ra_z = d3 * Z
    return executor(b.compile(fa.coeffs() + [*Ra_x.c, *Ra_y.c, *Ra_z.c]), "miller_add")


@lru_cache(maxsize=None)
def _sqr_circuit() -> CircuitExec:
    """f(12) -> f^2(12), the generic Fp12 square."""
    b = CircuitBuilder(12)
    f = _s12_from_inputs(b, 0)
    return executor(b.compile(f.sqr().coeffs()), "sqr")


def _s2_sqr(x: S2) -> S2:
    """(a + bu)^2 = (a+b)(a-b) + 2ab u: 2 lanes against Karatsuba's 3."""
    t = (x.c[0] + x.c[1]) * (x.c[0] - x.c[1])
    m = x.c[0] * x.c[1]
    return S2(t, m.dbl())


def _fp4_sqr(x0: S2, x1: S2) -> tuple:
    """(x0 + x1 y)^2 with y^2 = xi: (x0^2 + xi x1^2, 2 x0 x1), 6 lanes."""
    t0 = _s2_sqr(x0)
    t1 = _s2_sqr(x1)
    s = _s2_sqr(x0 + x1)
    return t0 + t1.mul_xi(), s - t0 - t1


def _cyc_sqr_step(f: S12) -> S12:
    """One Granger-Scott cyclotomic squaring on symbols."""
    g0, g1, g2 = f.g.c
    h0, h1, h2 = f.h.c
    a20, a21 = _fp4_sqr(g0, h1)
    b20, b21 = _fp4_sqr(h0, g2)
    c20, c21 = _fp4_sqr(g1, h2)

    def three(x):
        return x.dbl() + x

    ng0 = three(a20) - g0.dbl()
    nh1 = three(a21) + h1.dbl()
    nh0 = three(c21.mul_xi()) + h0.dbl()
    ng2 = three(c20) - g2.dbl()
    ng1 = three(b20) - g1.dbl()
    nh2 = three(b21) + h2.dbl()
    return S12(S6(ng0, ng1, ng2), S6(nh0, nh1, nh2))


def _reduce12(b: CircuitBuilder, f: S12) -> S12:
    """Every coordinate times Montgomery one (a value-preserving product):
    resets the coefficient masses that chained squarings compound past the
    mix-mass cap."""
    one = b.const(R_MONT % P)

    def red6(s6: S6) -> S6:
        return S6(*(S2(c.c[0] * one, c.c[1] * one) for c in s6.c))

    return S12(red6(f.g), red6(f.h))


@lru_cache(maxsize=None)
def _cyc_sqr_circuit_k(k: int) -> CircuitExec:
    """k chained cyclotomic squarings as one circuit."""
    b = CircuitBuilder(12)
    f = _s12_from_inputs(b, 0)
    for i in range(k):
        if i:
            f = _reduce12(b, f)
        f = _cyc_sqr_step(f)
    return executor(b.compile(f.coeffs()), "cyc_sqr" if k == 1 else f"cyc_sqr{k}")


def _cyc_sqr_circuit() -> CircuitExec:
    """Granger-Scott squaring in the cyclotomic subgroup: 18 lanes against
    the generic 36.  Write f = A + B w + C w^2 over Fp4 = Fp2[y]/(y^2 - xi)
    with y = w^3; in the slot basis the Fp4 pairs are A = (g0, h1),
    B = (h0, g2), C = (g1, h2).  For unitary f:
      f^2 = (3A^2 - 2conj(A)) + (3 y C^2 + 2conj(B)) w + (3B^2 - 2conj(C)) w^2.
    Valid only on cyclotomic inputs."""
    return _cyc_sqr_circuit_k(1)


def _exp_segments(value: int) -> List[int]:
    """MSB-first square-and-multiply schedule of a static exponent: run
    lengths [r0, r1, ...], r0 squarings then a multiply, r1 squarings then
    a multiply, ...; the last entry is the tail run (possibly 0) with no
    multiply after it."""
    bits = [(value >> i) & 1 for i in range(value.bit_length() - 2, -1, -1)]
    segs, run = [], 0
    for bit in bits:
        run += 1
        if bit:
            segs.append(run)
            run = 0
    segs.append(run)
    return segs


@lru_cache(maxsize=None)
def _mul_circuit() -> CircuitExec:
    b = CircuitBuilder(24)
    a = _s12_from_inputs(b, 0)
    c = _s12_from_inputs(b, 12)
    return executor(b.compile((a * c).coeffs()), "mul")


@lru_cache(maxsize=None)
def _mul_conj_frob_circuit(k: int, conj_second: bool) -> CircuitExec:
    """a * frob_k(b), b conjugated first if conj_second."""
    b_ = CircuitBuilder(24)
    a = _s12_from_inputs(b_, 0)
    c = _s12_from_inputs(b_, 12)
    if conj_second:
        c = c.conj()
    if k:
        c = _frob_sym(b_, c, k)
    return executor(b_.compile((a * c).coeffs()),
                    f"mul_conj_frob{k}" if conj_second else f"mul_frob{k}")


@lru_cache(maxsize=None)
def _inv_front_circuit() -> CircuitExec:
    """f(12) -> [A(2), B(2), C(2), t(2), norm(1)]: the tower inversion up
    to its one Fp inversion."""
    b = CircuitBuilder(12)
    f = _s12_from_inputs(b, 0)
    g, h = f.g, f.h
    D = g * g - (h * h).mul_v()
    d0, d1, d2 = D.c
    A = d0 * d0 - (d1 * d2).mul_xi()
    Bc = (d2 * d2).mul_xi() - d0 * d1
    C = d1 * d1 - d0 * d2
    t = d0 * A + (d1 * C).mul_xi() + (d2 * Bc).mul_xi()
    norm = t.c[0] * t.c[0] + t.c[1] * t.c[1]
    return executor(b.compile([*A.c, *Bc.c, *C.c, *t.c, norm]), "inv_front")


@lru_cache(maxsize=None)
def _inv_back_circuit() -> CircuitExec:
    """(f(12), A(2), B(2), C(2), t(2), ninv(1)) -> f^-1 (12)."""
    b = CircuitBuilder(21)
    f = _s12_from_inputs(b, 0)
    A = _s2_from_inputs(b, 12)
    Bc = _s2_from_inputs(b, 14)
    C = _s2_from_inputs(b, 16)
    t = _s2_from_inputs(b, 18)
    ninv = b.input(20)
    tinv = S2(t.c[0] * ninv, -(t.c[1] * ninv))  # t^-1 = conj(t) / norm(t)
    Dinv = S6(A * tinv, Bc * tinv, C * tinv)
    g, h = f.g, f.h
    return executor(b.compile(S12(g * Dinv, (-h) * Dinv).coeffs()), "inv_back")


@lru_cache(maxsize=None)
def _conj_circuit() -> CircuitExec:
    """f -> conj(f) = f^(p^6): an output mix only, no product layer."""
    b = CircuitBuilder(12)
    f = _s12_from_inputs(b, 0)
    return executor(b.compile(f.conj().coeffs()), "conj")


_P_MINUS_2_BITS = [(P - 2) >> i & 1 for i in range(P.bit_length() - 2, -1, -1)]


@lru_cache(maxsize=None)
def _fq_inv_circuit() -> CircuitExec:
    """a -> a^(p-2) = a^-1 (0 -> 0): the Fermat square-and-multiply chain
    over the bits of p - 2 below the top one, one product per layer, in one
    launch (the counterpart of pairing_jax._fq_inv's scan of fq_mul)."""
    b = CircuitBuilder(1)
    a = b.input(0)
    acc = a
    for bit in _P_MINUS_2_BITS:
        acc = acc * acc
        if bit:
            acc = acc * a
    return executor(b.compile([acc]), "fq_inv")


def circuits() -> Dict[str, CircuitExec]:
    """Every circuit `pairing_eq_kernel` launches, by name."""
    return {c.name: c for c in (
        _miller_dbl_circuit(), _miller_add_circuit(), _mul_circuit(),
        _mul_conj_frob_circuit(1, False), _mul_conj_frob_circuit(2, False),
        _cyc_sqr_circuit(), _conj_circuit(), _inv_front_circuit(), _fq_inv_circuit(),
        _inv_back_circuit(),
    )}


_ONE12 = np.zeros((12, N_LIMBS), np.int32)
_ONE12[0] = int_to_limbs(R_MONT % P)

# ---------------------------------------------------------------------------
# The launch sequence: [n, 12, lanes] int32 Montgomery words, every launch on B3
# ---------------------------------------------------------------------------

# How a circuit runs: CircuitExec.__call__ (B3 on a CUDA tensor) or CircuitExec.plain
Run = Callable[[CircuitExec, torch.Tensor], torch.Tensor]


_ONE12_ON: Dict[torch.device, torch.Tensor] = {}


def _one12(n: int, device: torch.device) -> torch.Tensor:
    """Fp12's one on every lane (one copy per device, kept: a batch makes
    no host-to-device copy after its first, so it can be captured in a
    CUDA graph)."""
    if device not in _ONE12_ON:
        _ONE12_ON[device] = torch.as_tensor(_ONE12, device=device)[:, :, None]
    return _ONE12_ON[device].expand(12, N_LIMBS, n)


def _fq12_mul(a, b, run: Run):
    return run(_mul_circuit(), torch.cat([a, b]))


def _fq12_conj(f, run: Run):
    return run(_conj_circuit(), f)


def _fq12_inv(f, run: Run):
    """f^-1: the tower's front half, one Fp inversion per lane, the back."""
    front = run(_inv_front_circuit(), f)
    ninv = run(_fq_inv_circuit(), front[8:9])
    return run(_inv_back_circuit(), torch.cat([f, front[:8], ninv]))


def _pow_x_abs(a, run: Run):
    """a^|x| for a in the cyclotomic subgroup: runs of Granger-Scott
    squarings, a multiply at each of the 5 in-loop set bits."""
    sqr = _cyc_sqr_circuit()
    segs = _exp_segments(X_ABS)
    acc = a
    for n in segs[:-1]:
        for _ in range(n):
            acc = run(sqr, acc)
        acc = _fq12_mul(acc, a, run)
    for _ in range(segs[-1]):
        acc = run(sqr, acc)
    return acc


def _cyc_pow_x(a, run: Run):
    """a^x, x < 0, in the cyclotomic subgroup (conj = inverse)."""
    return _fq12_conj(_pow_x_abs(a, run), run)


def _final_exp_is_one(f, run: Run) -> torch.Tensor:
    """f^(3 lambda (p^6-1)(p^2+1)) == 1 ?  [12, 12, n] -> bool [n]."""
    frob1, frob2 = _mul_conj_frob_circuit(1, False), _mul_conj_frob_circuit(2, False)
    # easy part: m = frob2(u) * u with u = conj(f) * f^-1
    u = _fq12_mul(_fq12_conj(f, run), _fq12_inv(f, run), run)
    m = run(frob2, torch.cat([u, u]))
    # hard part
    t = _fq12_conj(_fq12_mul(_pow_x_abs(m, run), m, run), run)  # m^(x-1)
    t = _fq12_conj(_fq12_mul(_pow_x_abs(t, run), t, run), run)  # m^((x-1)^2)
    t = run(frob1, torch.cat([_cyc_pow_x(t, run), t]))  # ^(x+p)
    a = _fq12_mul(
        _cyc_pow_x(_cyc_pow_x(t, run), run),
        run(frob2, torch.cat([_fq12_conj(t, run), t])),
        run,
    )  # t^(x^2) * t^-1 * frob2(t)
    m3 = _fq12_mul(_fq12_mul(m, m, run), m, run)
    out = _fq12_mul(a, m3, run)
    return (out == _one12(out.shape[-1], out.device)).all(1).all(0)


def _miller(qx, qy, px, py, run: Run):
    """qx, qy [2, 12, n]; px, py [1, 12, n] -> f [12, 12, n]: the segmented
    ate loop, a double launch per bit and an add launch per set bit."""
    n = px.shape[-1]
    f = _one12(n, px.device)
    R = torch.cat([qx, qy, _one12(n, px.device)[:2]])
    dbl, add = _miller_dbl_circuit(), _miller_add_circuit()

    def step(circ, f, R):
        out = run(circ, torch.cat([f, R, qx, qy, px, py]))
        return out[:12], out[12:18]

    segs = _exp_segments(X_ABS)
    for k in segs[:-1]:
        for _ in range(k):
            f, R = step(dbl, f, R)
        f, R = step(add, f, R)
    for _ in range(segs[-1]):
        f, R = step(dbl, f, R)
    return f


def pairing_eq_kernel(ax, ay, bx, by, cx, cy, dx, dy, use_kernel: bool = True) -> torch.Tensor:
    """e(a, b) == e(c, d) per lane as miller(b, a) * miller(d, -c) == 1
    after the final exponentiation, both Miller loops as one batch of 2B
    lanes.  a*, c* [1, 12, B]; b*, d* [2, 12, B] (affine Montgomery
    words, no lane at infinity) -> bool [B] on their device.  Every launch
    is B3 on a CUDA tensor (the plain versions with use_kernel=False), the
    plain versions on a CPU tensor."""
    run = CircuitExec.__call__ if use_kernel else CircuitExec.plain
    neg_cy = fq_sub(torch.zeros_like(cy), cy)  # p - y (y = 0 -> 0)
    p_x = torch.cat([ax, cx], dim=-1)
    p_y = torch.cat([ay, neg_cy], dim=-1)
    q_x = torch.cat([bx, dx], dim=-1)
    q_y = torch.cat([by, dy], dim=-1)
    fboth = _miller(q_x, q_y, p_x, p_y, run)
    b = ax.shape[-1]
    f = _fq12_mul(fboth[..., :b], fboth[..., b:], run)
    return _final_exp_is_one(f, run)


def schedule(b: int) -> Dict[str, int]:
    """The launches one batch of b checks (none at infinity) makes, by
    circuit name, as `pairing_eq_kernel`'s code implies them (0 for b = 0)."""
    if b == 0:
        return {}
    segs = _exp_segments(X_ABS)
    squarings, multiplies = sum(segs), len(segs) - 1  # of |x|: 63 and 5
    # _pow_x_abs runs 5 times (2 in the hard part's t's, 3 in _cyc_pow_x)
    return {
        "miller_dbl": squarings,
        "miller_add": multiplies,
        "cyc_sqr": 5 * squarings,
        # the halves' join, the easy part's, the pow runs', 2 in the hard
        # part's t's, a, m^3 (2) and out
        "mul": 1 + 1 + 5 * multiplies + 2 + 1 + 2 + 1,
        # conj(f), the two t's, the three _cyc_pow_x, conj(t)
        "conj": 1 + 2 + 3 + 1,
        "mul_frob1": 1,
        "mul_frob2": 2,
        "inv_front": 1,
        "fq_inv": 1,
        "inv_back": 1,
    }


def products(b: int) -> int:
    """Fp products one batch of b checks makes: each circuit's products a
    lane times its launches and their lanes (`schedule`)."""
    circ = circuits()
    return sum(count * circ[name].n_products * (2 * b if name.startswith("miller") else b)
               for name, count in schedule(b).items())


def bound(b: int) -> tuple:
    """(operations ms, bytes ms) of one batch of b checks at the card's
    peaks (ops/roofline.pairing_ms)."""
    return roofline.pairing_ms(products(b), b)


# ---------------------------------------------------------------------------
# Host entry
# ---------------------------------------------------------------------------


def _g1_words(affs) -> np.ndarray:
    """Affine G1 points -> [2, 12, n] Montgomery words (x, y)."""
    n = len(affs)
    ints = [a[0].n * R_MONT % P for a in affs] + [a[1].n * R_MONT % P for a in affs]
    return ints_to_limbs_batch(ints).reshape(2, n, N_LIMBS).transpose(0, 2, 1)


def _g2_words(affs) -> np.ndarray:
    """Affine G2 points -> [4, 12, n] Montgomery words (x0, x1, y0, y1)."""
    n = len(affs)
    ints = [a[j].coeffs[k] * R_MONT % P for j in (0, 1) for k in (0, 1) for a in affs]
    return ints_to_limbs_batch(ints).reshape(4, n, N_LIMBS).transpose(0, 2, 1)


def operands(g1_a: Sequence, g2_b: Sequence, g1_c: Sequence, g2_d: Sequence,
             device: torch.device) -> tuple:
    """Finite points -> `pairing_eq_kernel`'s eight operands on `device`:
    affine by `normalize_batch` (one inversion a list), Montgomery words,
    one upload (their host seconds into `host_s`)."""
    t0 = time.perf_counter()
    affs = [bls.normalize_batch(pts) for pts in (g1_a, g2_b, g1_c, g2_d)]
    t1 = time.perf_counter()
    words = np.concatenate([_g1_words(affs[0]), _g2_words(affs[1]),
                            _g1_words(affs[2]), _g2_words(affs[3])])  # [12, 12, n]
    x = torch.from_numpy(np.ascontiguousarray(words)).to(device)
    host_s["normalize_batch"] += t1 - t0
    host_s["words"] += time.perf_counter() - t1
    return x[0:1], x[1:2], x[2:4], x[4:6], x[6:7], x[7:8], x[8:10], x[10:12]


def pairing_eq_batch(g1_a: Sequence, g2_b: Sequence, g1_c: Sequence, g2_d: Sequence,
                     device="cuda", use_kernel: bool = True) -> np.ndarray:
    """B independent checks e(a_i, b_i) == e(c_i, d_i) -> bool [B].

    a, c: G1 points (projective tuples); b, d: G2 points, members of the
    r-order subgroups.  Lanes with a point at infinity (legal on the wire:
    the compressed 0x40 flag decodes to it) are answered by the host oracle
    (bls12_381.pairing_check_eq), so one degenerate share never reaches
    the device or aborts its batch; the rest run through
    `pairing_eq_kernel` on `device` in one batch (any lane count: B3
    takes ragged batches)."""
    dev = resolve_device(device)
    lanes = list(zip(g1_a, g2_b, g1_c, g2_d))
    out = np.zeros(len(lanes), dtype=bool)
    finite = []
    t0 = time.perf_counter()
    for i, lane in enumerate(lanes):
        if any(bls.is_inf(pt) for pt in lane):
            out[i] = bls.pairing_check_eq(*lane)
        else:
            finite.append(i)
    host_s["oracle"] += time.perf_counter() - t0
    if not finite:
        return out
    args = operands(*([lanes[i][j] for i in finite] for j in range(4)), dev)
    out[finite] = pairing_eq_kernel(*args, use_kernel=use_kernel).cpu().numpy()
    return out
