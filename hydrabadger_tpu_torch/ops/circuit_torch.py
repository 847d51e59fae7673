"""Executor of recorded Fp circuits — kernel B3 and its plain version.

Counterpart of hydrabadger_tpu/ops/circuit_T.py.  A circuit recorded by
ops/fp12_circuit (per layer: signed small-integer linear mixes of the
wires so far, then one product per lane; then an output mix) runs over a
batch of lanes:

    x [n_inputs, 12, n...] int32  ->  [n_outputs, 12, n...] int32

with every output canonical (< p) Montgomery form, so the result equals
the JAX executor's bit for bit after regrouping limbs.

Unlike the TPU executor, which keeps wires in a redundant < 2p form and
normalises each mix with a dominating K*p offset, one Barrett quotient
step and a short subtraction ladder (the TPU's 12-bit carries make that
the cheap route), both versions here keep EVERY wire fully reduced and
compute each mix exactly mod p:

    V = sum_{c>0} c*x + negsum*p - sum_{c<0} |c|*x,    0 <= V < mass*p

(negsum = sum of |c| over the negative coefficients, mass <= 64), then
q = floor(floor(V / 2^352) / (floor(p / 2^352) + 1)) undershoots the
quotient by at most one, and V - q*p < 2p takes one conditional
subtraction.

The kernel (csrc/circuit.cu) interprets a flat int32 program of these
rows, one CUDA thread per lane; the plain version runs the same rows as
one float64 matrix product per layer (exact: every sum is < 2^23) and
the digit arithmetic of ops/fq_torch.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from . import _kernels
from .fp12_circuit import Circuit
from .fq_torch import N_HALF, _carry, consts as fq_consts, mont_mul_h, to_half, to_words
from .limbs import N_LIMBS, P

# Kernel launches made by `CircuitExec.__call__` (one per launch, none for
# CPU tensors), in all and per circuit name.
launches = 0
launches_by_circuit: Dict[str, int] = {}

P_TOP = P >> 352  # the quotient estimate's divisor is P_TOP + 1
_WIDE = N_HALF + 2  # 26 digits hold any mix value (< 64p < 2^388)


def _row_program(row: np.ndarray) -> List[int]:
    """One mix row as [n_terms, negsum, w0, c0, w1, c1, ...].  The kernel
    tells the rows of circuit_T's per-row plan apart by these fields:
    zero (no terms), select (one term, +1), negated select (one term,
    -1) and general (a reduced signed mix)."""
    nz = np.nonzero(row)[0]
    out = [len(nz), int(_negsum(row[None])[0])]
    for w in nz:
        out += [int(w), int(row[w])]
    return out


def _negsum(m: np.ndarray) -> np.ndarray:
    return np.where(m < 0, -m, 0).sum(axis=1).astype(np.int64)


class CircuitExec:
    """Executable form of a recorded `Circuit` (see the module docstring).

    `program` is the kernel's int32 program:
        [n_inputs, n_const, n_products, n_outputs,
         (left row, right row) per product in wire order, row per output]
    """

    def __init__(self, circ: Circuit, name: str = "circuit"):
        self.circ = circ
        self.name = name
        self.n_inputs = circ.n_inputs
        self.n_outputs = circ.n_outputs
        self.n_const = circ.const_vals.shape[0]
        self.n_products = int(sum(circ.n_lanes))
        prog = [self.n_inputs, self.n_const, self.n_products, self.n_outputs]
        for sl, sr in circ.mats:
            for i in range(sl.shape[0]):
                prog += _row_program(sl[i]) + _row_program(sr[i])
        for o in range(self.n_outputs):
            prog += _row_program(circ.T[o])
        self.program = np.asarray(prog, np.int32)
        self._on_device: Dict[torch.device, tuple] = {}

    def _operands(self, device: torch.device):
        """Per device: the plain version's per-layer stacked float64 mix
        matrices and negsums, the constants, and the kernel's program."""
        if device in self._on_device:
            return self._on_device[device]
        layers = []
        for sl, sr in self.circ.mats:
            m = np.concatenate([sl, sr], axis=0)
            layers.append((
                torch.as_tensor(m, dtype=torch.float64, device=device),
                torch.as_tensor(_negsum(m), device=device),
            ))
        out = (
            torch.as_tensor(self.circ.T, dtype=torch.float64, device=device),
            torch.as_tensor(_negsum(self.circ.T), device=device),
        )
        const_w = torch.as_tensor(self.circ.const_vals, device=device)  # [n_const, 12]
        prog = torch.as_tensor(self.program, device=device)
        self._on_device[device] = (layers, out, const_w, prog)
        return self._on_device[device]

    # -- the plain version -------------------------------------------------

    def plain(self, x: torch.Tensor) -> torch.Tensor:
        """[n_inputs, 12, n...] -> [n_outputs, 12, n...] on any device."""
        self._check(x)
        lanes = x.shape[2:]
        xs = x.reshape(self.n_inputs, N_LIMBS, -1)
        n = xs.shape[-1]
        layers, (t_mat, t_neg), const_w, _ = self._operands(x.device)
        n_fixed = self.n_inputs + self.n_const
        # every wire in half form, canonical: [24, wire, lane]
        wires = torch.empty((N_HALF, n_fixed + self.n_products, n), dtype=torch.float64,
                            device=x.device)
        wires[:, : self.n_inputs] = to_half(xs.transpose(0, 1))
        if self.n_const:
            wires[:, self.n_inputs : n_fixed] = to_half(const_w.T)[:, :, None]
        avail = n_fixed
        for (m, neg), lane_n in zip(layers, self.circ.n_lanes):
            v = _mix(m, neg, wires[:, :avail])  # [24, 2L, n]: left rows, right rows
            prod = mont_mul_h(v[:, :lane_n].reshape(N_HALF, -1), v[:, lane_n:].reshape(N_HALF, -1))
            wires[:, avail : avail + lane_n] = prod.reshape(N_HALF, lane_n, n)
            avail += lane_n
        out = to_words(_mix(t_mat, t_neg, wires[:, :avail]))  # [12, n_out, n]
        return out.transpose(0, 1).reshape(self.n_outputs, N_LIMBS, *lanes)

    # -- the kernel's wrapper ----------------------------------------------

    def _check(self, x: torch.Tensor) -> None:
        if not isinstance(x, torch.Tensor) or x.dtype != torch.int32:
            raise TypeError(f"{self.name}: expected an int32 tensor")
        if x.dim() < 3 or tuple(x.shape[:2]) != (self.n_inputs, N_LIMBS):
            raise ValueError(
                f"{self.name}: expected [{self.n_inputs}, {N_LIMBS}, n...], got {tuple(x.shape)}"
            )
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{self.name} runs on cuda or cpu tensors, not {x.device}")

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """The circuit over every lane of x: csrc/circuit.cu for a CUDA
        tensor (or raises), the plain version for a CPU tensor."""
        self._check(x)
        if x.device.type != "cuda":
            return self.plain(x)
        return self._launch(x)

    def _launch(self, x: torch.Tensor) -> torch.Tensor:
        global launches
        lanes = x.shape[2:]
        xs = x.contiguous()
        n = xs[0, 0].numel()
        out = torch.empty((self.n_outputs, N_LIMBS, *lanes), dtype=torch.int32, device=x.device)
        if n == 0:
            return out
        _, _, const_w, prog = self._operands(x.device)
        scratch = torch.empty((max(self.n_products, 1), N_LIMBS, n), dtype=torch.int32,
                              device=x.device)
        lib = _kernels.load("circuit")
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.circuit_launch(
            x.device.index, prog.data_ptr(), int(prog.numel()), xs.data_ptr(),
            const_w.data_ptr() if self.n_const else 0, scratch.data_ptr(),
            out.data_ptr(), n, stream,
        )
        _kernels.check("circuit", lib, rc, "circuit_error_string")
        launches += 1
        launches_by_circuit[self.name] = launches_by_circuit.get(self.name, 0) + 1
        return out


def _mix(m: torch.Tensor, negsum: torch.Tensor, wires: torch.Tensor) -> torch.Tensor:
    """Rows of m (float64 [rows, w]) over canonical half-form wires
    ([24, w, n] float64) -> [24, rows, n] canonical digits, exact mod p."""
    rows, n = m.shape[0], wires.shape[-1]
    c = fq_consts(wires.device)
    v = F.pad(torch.matmul(m, wires).to(torch.int64), (0, 0, 0, 0, 0, _WIDE - N_HALF))
    v += negsum[None, :, None] * c.p26[:, :, None]  # V = mix + negsum p, 0 <= V < 64p
    d = _carry(v.reshape(_WIDE, -1))
    top = d[22] | (d[23] << 16) | (d[24] << 32) | (d[25] << 48)  # V >> 352
    qp = torch.div(top, P_TOP + 1, rounding_mode="floor") * c.p26  # q p, V - q p < 2p
    r = _carry(torch.cat([d - qp, d - qp - c.p26], dim=1))
    k = rows * n
    out = torch.where(r[_WIDE - 1, k:] != 0, r[:N_HALF, :k], r[:N_HALF, k:])
    return out.reshape(N_HALF, rows, n)


_EXECUTORS: Dict[int, CircuitExec] = {}


def executor(circ: Circuit, name: str = "circuit") -> CircuitExec:
    """Cached CircuitExec for a (cached) Circuit instance."""
    key = id(circ)
    if key not in _EXECUTORS:
        _EXECUTORS[key] = CircuitExec(circ, name)
    return _EXECUTORS[key]
