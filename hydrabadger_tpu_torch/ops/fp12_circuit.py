"""Symbolic recorder of layered Fp circuits (numpy only).

Copy of the recorder half of hydrabadger_tpu/ops/fp12_circuit.py: `Sym`,
`CircuitBuilder` and `Circuit`'s matrices.  A formula runs over `Sym`
handles that track small-integer linear combinations of wires; each
product schedules a lane in the first layer where both operands are
ready.  The recorded (left mix, right mix) matrices per layer and the
output mix T ARE the circuit.  Executing it is ops/circuit_torch's work
(kernel B3 and its plain version), which takes the place of the JAX
module's `Circuit._mix` / `__call__`.

Wire columns are in execution order: inputs, constants, then the
products layer by layer.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np

from .limbs import N_LIMBS, P, int_to_limbs

_MIX_CAP = 64  # max absolute coefficient mass of any linear mix


class Sym:
    """A circuit value: a small-integer linear combination of wires."""

    __slots__ = ("builder", "vec")

    def __init__(self, builder: "CircuitBuilder", vec: Dict[int, int]):
        self.builder = builder
        self.vec = vec

    def __add__(self, other: "Sym") -> "Sym":
        v = dict(self.vec)
        for k, c in other.vec.items():
            nc = v.get(k, 0) + c
            if nc:
                v[k] = nc
            else:
                v.pop(k, None)
        return Sym(self.builder, v)

    def __sub__(self, other: "Sym") -> "Sym":
        v = dict(self.vec)
        for k, c in other.vec.items():
            nc = v.get(k, 0) - c
            if nc:
                v[k] = nc
            else:
                v.pop(k, None)
        return Sym(self.builder, v)

    def __neg__(self) -> "Sym":
        return Sym(self.builder, {k: -c for k, c in self.vec.items()})

    def dbl(self) -> "Sym":
        return Sym(self.builder, {k: 2 * c for k, c in self.vec.items()})

    def __mul__(self, other: "Sym") -> "Sym":
        return self.builder.mul(self, other)

    def is_zero(self) -> bool:
        return not self.vec


@dataclass
class _Layer:
    lefts: List[Dict[int, int]] = field(default_factory=list)
    rights: List[Dict[int, int]] = field(default_factory=list)
    prod_wires: List[int] = field(default_factory=list)


class CircuitBuilder:
    """Records a layered circuit: wires are inputs, constants, and
    product lanes; a product whose operands need layer k's outputs is
    scheduled into layer k+1."""

    def __init__(self, n_inputs: int):
        self.n_inputs = n_inputs
        self.n_wires = n_inputs
        self.layers: List[_Layer] = []
        self.wire_layer: Dict[int, int] = {i: -1 for i in range(n_inputs)}
        self.constants: Dict[int, int] = {}

    def input(self, i: int) -> Sym:
        if not 0 <= i < self.n_inputs:
            raise IndexError(i)
        return Sym(self, {i: 1})

    def const(self, value: int) -> Sym:
        value %= P
        for w, v in self.constants.items():
            if v == value:
                return Sym(self, {w: 1})
        w = self.n_wires
        self.n_wires += 1
        self.wire_layer[w] = -1
        self.constants[w] = value
        return Sym(self, {w: 1})

    def zero(self) -> Sym:
        return Sym(self, {})

    def mul(self, a: Sym, b: Sym) -> Sym:
        if a.is_zero() or b.is_zero():
            return self.zero()
        ready = max(
            max((self.wire_layer[w] for w in a.vec), default=-1),
            max((self.wire_layer[w] for w in b.vec), default=-1),
        )
        lay = ready + 1
        while len(self.layers) <= lay:
            self.layers.append(_Layer())
        w = self.n_wires
        self.n_wires += 1
        self.wire_layer[w] = lay
        L = self.layers[lay]
        L.lefts.append(dict(a.vec))
        L.rights.append(dict(b.vec))
        L.prod_wires.append(w)
        return Sym(self, {w: 1})

    def compile(self, outputs: Sequence[Sym]) -> "Circuit":
        return Circuit(self, [dict(o.vec) for o in outputs])


class Circuit:
    """A recorded circuit's matrices: per layer (left mix, right mix) over
    the wires available before it, and the output mix T over all wires.
    `const_vals` holds the constants as [n_const, 12] port words."""

    def __init__(self, b: CircuitBuilder, out_vecs: List[Dict[int, int]]):
        self.n_inputs = b.n_inputs
        const_wires = sorted(b.constants)
        self.const_vals = (
            np.stack([int_to_limbs(b.constants[w]) for w in const_wires])
            if const_wires
            else np.zeros((0, N_LIMBS), np.int32)
        )
        exec_order = (
            list(range(b.n_inputs))
            + const_wires
            + [w for lay in b.layers for w in lay.prod_wires]
        )
        col_of = {w: i for i, w in enumerate(exec_order)}

        def remap(vecs: List[Dict[int, int]], width: int) -> np.ndarray:
            M = np.zeros((len(vecs), width), np.int32)
            for o, vec in enumerate(vecs):
                for w, c in vec.items():
                    M[o, col_of[w]] = c
            return M

        self.mats = []
        avail = b.n_inputs + len(const_wires)
        for lay in b.layers:
            SL = remap(lay.lefts, avail)
            SR = remap(lay.rights, avail)
            self.mats.append((SL, SR))
            avail += len(lay.prod_wires)
        self.T = remap(out_vecs, avail)
        for M in [m for pair in self.mats for m in pair] + [self.T]:
            mass = np.abs(M).sum(axis=1).max(initial=0)
            if mass > _MIX_CAP:
                raise ValueError(f"mix mass {mass} exceeds ladder cap")
        self.n_outputs = self.T.shape[0]
        self.n_lanes = [SL.shape[0] for SL, _ in self.mats]
