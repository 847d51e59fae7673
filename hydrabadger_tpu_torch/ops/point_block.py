"""The layered point programs of kernels B2 and B4 (csrc/point_block.cuh).

A block of csrc/fq_point.cu or csrc/fq2_point.cu runs 32 lanes x T warps.
Each Jacobian point formula is a recorded Fp circuit (ops/fp12_circuit,
from the port's own formulas `fq_torch.jac_double_formula` /
`jac_add_core_formula`), compiled by `circuit_torch.slot_program` into
layers of independent Fp products: warp t computes products t, t + T, ...
of a layer for its 32 lanes, a block barrier separates the layers, and the
wires live in shared-memory slots [slot][12 words][32 lanes].  Over Fp2
(G2, c = 2) an element is two Fp wires, a Karatsuba product three Fp
products and a complex square two, spread over the warps like any other.

The slots hold, below every program's own:

    0 .. K-1                   the accumulator (K = 3c field elements)
    K (1 + t) .. K (2 + t) - 1  operand region t (t < OPERANDS[c])

Every program keeps its inputs (`slot_program(keep_inputs=True)`), so it
writes only above them:
    dbl, dblk4   one and four chained doublings of the accumulator, read
                 from slots 0 .. K-1, the result in their output slots;
                 the operand regions stay intact (a block fetches the
                 next window's operands while it doubles);
    add{t}       the complete add's general formula of acc + operand t,
                 outputs x3, y3, z3, h, r (h = r = 0 marks the doubling
                 case);
    arm          the doubling arm: one doubling of the accumulator whose
                 kept inputs also cover every slot an add's outputs use,
                 so the general result survives it.
The kernel picks per lane, in fq_T._jac_add_body's order: acc at infinity
-> the operand, operand at infinity -> acc, h = r = 0 -> the arm, else
the general result; the arm runs only when some lane of the block needs
it (`__syncthreads_or`).

The program set is one int32 buffer [n_programs, offset of each program
from the set's start, the programs], in the order of PROGRAMS.
"""
from __future__ import annotations

from contextlib import contextmanager
from functools import lru_cache
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from .circuit_torch import MAX_WARPS, SlotProgram, _fit, slot_program
from .fp12_circuit import Circuit, CircuitBuilder
from .fq_torch import jac_add_core_formula, jac_double_formula

# the set's programs in the order of its offset table (csrc/point_block.cuh)
PROGRAMS = ("dbl", "dblk4", "arm", "add0", "add1")
OPERANDS = {1: 2, 2: 1}  # operand regions: G1 (a GLV window adds two entries), G2


# -- the formulas over Sym (G1) and over pairs of Syms (G2) ---------------------

_FP_OPS = (
    lambda a, b: a * b,
    lambda a: a * a,  # a square is one product lane
    lambda a, b: a + b,
    lambda a, b: a - b,
)


def _fp2_mul(a, b):
    """Karatsuba with u^2 = -1 (fq2_torch.fq2_mul_h): 3 products."""
    t0, t1 = a[0] * b[0], a[1] * b[1]
    cross = (a[0] + a[1]) * (b[0] + b[1])
    return t0 - t1, cross - t0 - t1


def _fp2_sqr(a):
    """Complex squaring (fq2_torch.fq2_sqr_h): 2 products."""
    c1 = a[0] * a[1]
    return (a[0] + a[1]) * (a[0] - a[1]), c1 + c1


_FP2_OPS = (
    _fp2_mul,
    _fp2_sqr,
    lambda a, b: (a[0] + b[0], a[1] + b[1]),
    lambda a, b: (a[0] - b[0], a[1] - b[1]),
)


def _ops(c: int):
    return _FP_OPS if c == 1 else _FP2_OPS


def _point(b: CircuitBuilder, first: int, c: int):
    """The point at inputs first .. first + 3c - 1 as (x, y, z)."""
    if c == 1:
        return tuple(b.input(first + i) for i in range(3))
    return tuple((b.input(first + 2 * i), b.input(first + 2 * i + 1)) for i in range(3))


def _flat(coords, c: int) -> list:
    return list(coords) if c == 1 else [s for pair in coords for s in pair]


def record_double(c: int, k: int, n_keep: int) -> Circuit:
    """k chained doublings of the point at inputs 0 .. 3c-1 (n_keep inputs)."""
    b = CircuitBuilder(n_keep)
    p = _point(b, 0, c)
    for _ in range(k):
        p = jac_double_formula(*p, *_ops(c))
    return b.compile(_flat(p, c))


def record_add(c: int, op: int, n_keep: int) -> Circuit:
    """The add's general formula of the points at inputs 0 and op:
    outputs x3, y3, z3, h, r."""
    b = CircuitBuilder(n_keep)
    out = jac_add_core_formula(*_point(b, 0, c), *_point(b, op, c), *_ops(c))
    return b.compile(_flat(out, c))


# -- the program set -----------------------------------------------------------------


class PointPrograms(NamedTuple):
    """One kernel's program set (see the module docstring)."""

    c: int  # Fp elements per coordinate: 1 (G1, B2) or 2 (G2, B4)
    words: np.ndarray  # the int32 set
    circuits: Tuple[Circuit, ...]  # in the order of PROGRAMS
    programs: Tuple[SlotProgram, ...]
    n_slots: int
    warps: int  # T of an entry that adds: the widest layer of any program, at most MAX_WARPS
    dbl_warps: int  # T of an entry that only doubles (B2's dbl, dblk{k}): the doublings' widest
    smem: int  # shared memory of one block: the set padded to 16 bytes, the slots

    @property
    def k(self) -> int:
        return 3 * self.c


@lru_cache(maxsize=None)
def _build(c: int) -> PointPrograms:
    k = 3 * c
    n_fixed = k * (1 + OPERANDS[c])
    circs = [record_double(c, 1, n_fixed), record_double(c, 4, n_fixed)]
    adds = [record_add(c, k * (1 + t), n_fixed) for t in range(OPERANDS[c])]
    add_slots = max(slot_program(a, keep_inputs=True).n_slots_chain for a in adds)
    circs += [record_double(c, 1, add_slots)] + adds
    progs = [slot_program(circ, keep_inputs=True) for circ in circs]
    words = [len(progs)] + [0] * len(progs)
    for i, p in enumerate(progs):
        words[1 + i] = len(words)
        words += p.words.tolist()
    n_slots = max(p.n_slots_chain for p in progs)
    widest = [max(circ.n_lanes) for circ in circs]
    warps, dbl_warps = (max(1, min(MAX_WARPS, max(w))) for w in (widest, widest[:2]))
    words = np.asarray(words, np.int32)
    smem = _fit(f"point programs (c = {c})", len(words), 0, n_slots)
    return PointPrograms(c, words, tuple(circs), tuple(progs), n_slots, warps, dbl_warps, smem)


_WARPS: Dict[int, int] = {}  # a probe's override of T, by c
_ON_DEVICE: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def programs(c: int) -> PointPrograms:
    """The program set of B2 (c = 1) or B4 (c = 2), with T as set by `warps`."""
    prog = _build(c)
    return prog._replace(warps=_WARPS[c], dbl_warps=_WARPS[c]) if c in _WARPS else prog


@contextmanager
def warps(c: int, t: int):
    """Run c's kernel at T = t warps per block, every entry, inside the
    block (a probe's sweep; the wrappers otherwise take the widest layer
    of the programs an entry runs)."""
    if not 1 <= t <= MAX_WARPS:
        raise ValueError(f"T = {t}: a block runs 1 .. {MAX_WARPS} warps")
    _WARPS[c] = t
    try:
        yield
    finally:
        del _WARPS[c]


def words_on(c: int, device: torch.device) -> torch.Tensor:
    """c's program set as an int32 tensor on `device` (uploaded once)."""
    key = (c, device)
    if key not in _ON_DEVICE:
        _ON_DEVICE[key] = torch.as_tensor(_build(c).words, device=device)
    return _ON_DEVICE[key]
