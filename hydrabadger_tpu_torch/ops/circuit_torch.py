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

The kernel (csrc/circuit.cu) runs a block of 32 lanes x T warps: warp t
computes products t, t + T, ... of each layer, the wires live in
shared-memory slots reused by liveness, and a block barrier separates
the layers.  `slot_program` compiles a circuit into the int32 program it
reads (the format is documented at the top of circuit.cu), and
`CircuitChain` runs a static schedule of circuit steps over one
accumulator in one launch (the decrypt epoch's Straus combine).  The
plain version runs the same rows as one float64 matrix product per
layer (exact: every sum is < 2^23) and the digit arithmetic of
ops/fq_torch; the chain's plain version is a loop of circuit calls.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _kernels
from .fp12_circuit import Circuit
from .fq_torch import HALF, N_HALF, _carry, consts as fq_consts, mont_mul_h, to_half, to_words
from .limbs import N_LIMBS, P

# Kernel launches made by `CircuitExec.__call__` and `CircuitChain.__call__`
# (one per launch, none for CPU tensors), in all and per circuit or chain
# name.
launches = 0
launches_by_circuit: Dict[str, int] = {}

P_TOP = P >> 352  # the quotient estimate's divisor is P_TOP + 1
_WIDE = N_HALF + 2  # 26 digits hold any mix value (< 64p < 2^388)

# The program's layout (csrc/circuit.cu documents the same words).
HEADER = 4  # n_inputs, n_layers, n_outputs, n_products
MAX_WARPS = 8  # warps per block: 32 lanes x at most 8 warps
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on the H100 (227 KB)
SLOT_BYTES = N_LIMBS * 32 * 4  # one slot: 12 words for each of a block's 32 lanes

# A chain step's `take`: an output group g >= 0 (outputs [g*n_acc,
# (g+1)*n_acc) become the accumulator) or the table entry itself.
SEL = -1


def _negsum(m: np.ndarray) -> np.ndarray:
    return np.where(m < 0, -m, 0).sum(axis=1).astype(np.int64)


def _row(row: np.ndarray, ref_of) -> List[int]:
    """One mix row as [n_terms, negsum, ref0, c0, ref1, c1, ...], terms in
    wire order; ref_of maps a wire column to its slot (>= 0) or constant
    (-1 - index)."""
    nz = np.nonzero(row)[0]
    out = [len(nz), int(_negsum(row[None])[0])]
    for w in nz:
        out += [ref_of(int(w)), int(row[w])]
    return out


class SlotProgram(NamedTuple):
    """A circuit compiled for csrc/circuit.cu (see `slot_program`)."""

    words: np.ndarray  # the int32 program
    n_slots: int  # slots the layers use (a launch of the circuit alone)
    n_slots_chain: int  # with the output slots a chain step writes
    warps: int  # T, warps per block: the widest layer (no warp runs two
    # products of a layer), at most MAX_WARPS


def slot_program(circ: Circuit, const_base: int = 0, keep_inputs: bool = False) -> SlotProgram:
    """Compile `circ` into csrc/circuit.cu's int32 program.

    Inputs take slots 0 .. n_inputs-1.  A wire's slot is freed after the
    last layer that reads it (the output mix counts as layer n_layers),
    and a layer's products take the lowest free slots, so a slot freed by
    a layer's reads is reused from the next layer on: no product can
    overwrite a wire another warp of its own layer still reads.  The
    output slots (written only by a chain step) are free at the output
    mix, distinct, and above the inputs' slots.  Constants are not slots:
    a row names constant k as -1 - (const_base + k).  With `keep_inputs`
    no input slot is ever freed, so the program writes only slots at or
    above n_inputs (csrc/point_block.cuh keeps its points there).
    """
    n_in, n_const = circ.n_inputs, circ.const_vals.shape[0]
    n_fixed = n_in + n_const
    widths = list(circ.n_lanes)
    n_layers, n_products, n_out = len(widths), sum(widths), circ.n_outputs
    last = np.full(n_fixed + n_products, -1)
    for layer, (sl, sr) in enumerate(circ.mats):
        last[: sl.shape[1]][(sl != 0).any(0) | (sr != 0).any(0)] = layer
    last[(circ.T != 0).any(0)] = n_layers
    if keep_inputs:
        last[:n_in] = n_layers + 1  # released after the output mix: never

    slot_of: Dict[int, int] = {w: w for w in range(n_in)}
    release: Dict[int, List[int]] = {}
    for w in range(n_in):
        release.setdefault(int(last[w]), []).append(w)
    free: List[int] = [slot_of[w] for w in release.get(-1, [])]
    heapq.heapify(free)
    n_slots = n_in
    col = n_fixed
    for layer, width in enumerate(widths):
        for _ in range(width):
            if free:
                slot_of[col] = heapq.heappop(free)
            else:
                slot_of[col] = n_slots
                n_slots += 1
            release.setdefault(max(layer, int(last[col])), []).append(col)
            col += 1
        for w in release.get(layer, []):
            heapq.heappush(free, slot_of[w])
    pool = sorted(s for s in free if s >= n_in)
    out_slots = pool[:n_out]
    out_slots += range(n_slots, n_slots + n_out - len(out_slots))
    n_slots_chain = max([n_slots, *(s + 1 for s in out_slots)])

    def ref_of(w: int) -> int:
        if n_in <= w < n_fixed:
            return -1 - (const_base + w - n_in)
        return slot_of[w]

    layer_start = np.concatenate([[0], np.cumsum(widths, dtype=np.int64)]).tolist()
    tables = n_layers + 1 + n_products + n_out
    body: List[int] = []
    prod_pc, out_pc = [], []
    col = n_fixed
    for sl, sr in circ.mats:
        for i in range(sl.shape[0]):
            prod_pc.append(HEADER + tables + len(body))
            body += [slot_of[col]] + _row(sl[i], ref_of) + _row(sr[i], ref_of)
            col += 1
    for o in range(n_out):
        out_pc.append(HEADER + tables + len(body))
        body += [out_slots[o]] + _row(circ.T[o], ref_of)
    words = [n_in, n_layers, n_out, n_products] + layer_start + prod_pc + out_pc + body
    return SlotProgram(np.asarray(words, np.int32), n_slots, n_slots_chain,
                       max(1, min(MAX_WARPS, max(widths, default=1))))


def smem_bytes(prog_words: int, n_const: int, n_slots: int) -> int:
    """Shared memory of one block, which a launch passes to csrc/circuit.cu
    (its layout): the program padded to 16 bytes, the constants, and the
    slots."""
    return 4 * (-(-prog_words // 4) * 4 + N_LIMBS * n_const) + SLOT_BYTES * n_slots


def _fit(what: str, prog_words: int, n_const: int, n_slots: int) -> int:
    """The shared memory of one block (`smem_bytes`); raises beyond what
    one block may use."""
    need = smem_bytes(prog_words, n_const, n_slots)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"{what}: {n_slots} slots x {SLOT_BYTES} B + a {4 * prog_words}-byte program + "
            f"{n_const} constants need {need} B of shared memory per block; one block may use "
            f"{SMEM_LIMIT} B"
        )
    return need


class CircuitExec:
    """Executable form of a recorded `Circuit` (see the module docstring);
    `slots` is its compiled program (`slot_program`)."""

    def __init__(self, circ: Circuit, name: str = "circuit"):
        self.circ = circ
        self.name = name
        self.n_inputs = circ.n_inputs
        self.n_outputs = circ.n_outputs
        self.n_const = circ.const_vals.shape[0]
        self.n_products = int(sum(circ.n_lanes))
        self.slots = slot_program(circ)
        self.smem = _fit(name, len(self.slots.words), self.n_const, self.slots.n_slots)
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
                # hblint: disable=limb-layout -- exact integer product: float64 carries 16-bit digit sums below 2^53 without rounding (the plain version's dense product; torch's CUDA matmul takes floating types only)
                torch.as_tensor(m, dtype=torch.float64, device=device),
                torch.as_tensor(_negsum(m), device=device),
            ))
        out = (
            # hblint: disable=limb-layout -- exact integer product: float64 carries 16-bit digit sums below 2^53 without rounding (the plain version's dense product; torch's CUDA matmul takes floating types only)
            torch.as_tensor(self.circ.T, dtype=torch.float64, device=device),
            torch.as_tensor(_negsum(self.circ.T), device=device),
        )
        const_w = torch.as_tensor(self.circ.const_vals, device=device)  # [n_const, 12]
        prog = torch.as_tensor(self.slots.words, device=device)
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
        # hblint: disable=limb-layout -- exact integer product: float64 carries 16-bit digit sums below 2^53 without rounding (the plain version's dense product; torch's CUDA matmul takes floating types only)
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
        lanes = x.shape[2:]
        xs = x.contiguous()
        n = xs[0, 0].numel()
        out = torch.empty((self.n_outputs, N_LIMBS, *lanes), dtype=torch.int32, device=x.device)
        if n == 0:
            return out
        _, _, const_w, prog = self._operands(x.device)
        lib = _kernels.load("circuit")
        rc = lib.circuit_launch(
            x.device.index, prog.data_ptr(), int(prog.numel()), self.smem, self.slots.warps,
            xs.data_ptr(), const_w.data_ptr() if self.n_const else 0, self.n_const,
            out.data_ptr(), n, torch.cuda.current_stream(x.device).cuda_stream,
        )
        _kernels.check("circuit", lib, rc, "circuit_error_string")
        _note_launch(self.name)
        return out


def _note_launch(name: str) -> None:
    global launches
    launches += 1
    launches_by_circuit[name] = launches_by_circuit.get(name, 0) + 1


class CircuitChain:
    """A static schedule of circuit steps over one accumulator, in one
    launch of csrc/circuit.cu's chain entry.

    Every circuit takes the accumulator (n_acc elements) then a table
    entry (n_inputs - n_acc elements) as its inputs.  A step is
    (circuit index, entry, take): the circuit runs on (acc, table[entry])
    and the accumulator becomes its output group `take` (outputs
    [take*n_acc, (take+1)*n_acc)); a step with no circuit (None) takes
    the entry itself (take == SEL).  The accumulator stays in the
    kernel's shared-memory slots from step to step; only the entries are
    read from device memory.
    """

    def __init__(self, circuits: Sequence[CircuitExec],
                 steps: Sequence[Tuple[Optional[int], int, int]], n_acc: int,
                 name: str = "chain"):
        self.circuits = list(circuits)
        self.name = name
        self.n_acc = n_acc
        n_in = {c.n_inputs for c in self.circuits}
        if len(n_in) != 1:
            raise ValueError(f"{name}: the chain's circuits take {sorted(n_in)} inputs")
        self.n_sel = n_in.pop() - n_acc
        if self.n_sel <= 0:
            raise ValueError(f"{name}: no table entry among the circuits' inputs")
        for c, entry, take in steps:
            if c is None:
                if take != SEL or self.n_sel != n_acc:
                    raise ValueError(f"{name}: a step without a circuit must take its entry")
            elif not 0 <= take < self.circuits[c].n_outputs // n_acc:
                raise ValueError(f"{name}: circuit {self.circuits[c].name} has no output "
                                 f"group {take}")
        self.steps = [tuple(s) for s in steps]
        # one program buffer: [n_circuits, offset of each program, programs]
        n_c = len(self.circuits)
        progs, consts, words = [], [], [n_c] + [0] * n_c
        for i, c in enumerate(self.circuits):
            words[1 + i] = len(words)
            prog = slot_program(c.circ, const_base=sum(len(k) for k in consts))
            progs.append(prog)
            consts.append(c.circ.const_vals)
            words += prog.words.tolist()
        self.words = np.asarray(words, np.int32)
        self.const_vals = np.concatenate(consts) if consts else np.zeros((0, N_LIMBS), np.int32)
        self.n_const = self.const_vals.shape[0]
        self.n_slots = max(p.n_slots_chain for p in progs)
        # warp e fetches element e of the next step's entry
        if self.n_sel > MAX_WARPS:
            raise ValueError(f"{name}: an entry of {self.n_sel} elements needs more than "
                             f"{MAX_WARPS} warps")
        self.warps = max(self.n_sel, *(p.warps for p in progs))
        self.smem = _fit(name, len(self.words), self.n_const, self.n_slots)
        self.step_words = np.asarray(
            [[-1 if c is None else c, entry, take] for c, entry, take in self.steps], np.int32
        ).reshape(-1)
        self.products = sum(self.circuits[c].n_products for c, _, _ in self.steps if c is not None)
        self.entries = len({entry for _, entry, _ in self.steps})
        self._on_device: Dict[torch.device, tuple] = {}

    def elements(self) -> int:
        """Field elements per lane a launch must move, each once: the
        initial accumulator, every distinct entry it reads, the result."""
        return 2 * self.n_acc + self.n_sel * self.entries

    def _check(self, acc: torch.Tensor, table: torch.Tensor) -> int:
        if not isinstance(acc, torch.Tensor) or acc.dtype != torch.int32:
            raise TypeError(f"{self.name}: expected an int32 acc")
        if not isinstance(table, torch.Tensor) or table.dtype != torch.int32:
            raise TypeError(f"{self.name}: expected an int32 table")
        if acc.dim() != 3 or tuple(acc.shape[:2]) != (self.n_acc, N_LIMBS):
            raise ValueError(f"{self.name}: acc must be [{self.n_acc}, {N_LIMBS}, n], "
                             f"got {tuple(acc.shape)}")
        n = acc.shape[-1]
        if table.dim() != 4 or tuple(table.shape[:2]) != (self.n_sel, N_LIMBS) \
                or table.shape[-1] != n:
            raise ValueError(f"{self.name}: table must be [{self.n_sel}, {N_LIMBS}, entries, "
                             f"{n}], got {tuple(table.shape)}")
        top = max((entry for _, entry, _ in self.steps), default=-1)
        if top >= table.shape[2]:
            raise ValueError(f"{self.name}: a step reads entry {top} of {table.shape[2]}")
        if acc.device != table.device or acc.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{self.name}: acc on {acc.device}, table on {table.device}")
        return n

    def plain(self, acc: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        """The steps as a loop of `CircuitExec.plain` calls, on any device."""
        self._check(acc, table)
        k = self.n_acc
        for c, entry, take in self.steps:
            sel = table[:, :, entry]
            if c is None:
                acc = sel
            else:
                acc = self.circuits[c].plain(torch.cat([acc, sel]))[take * k : (take + 1) * k]
        return acc.contiguous()

    def __call__(self, acc: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        """[n_acc, 12, n] x [n_sel, 12, entries, n] -> [n_acc, 12, n]: the
        chain entry of csrc/circuit.cu for CUDA tensors (or raises), the
        plain version for CPU tensors."""
        n = self._check(acc, table)
        if acc.device.type != "cuda":
            return self.plain(acc, table)
        return self._launch(acc, table, n)

    def _launch(self, acc: torch.Tensor, table: torch.Tensor, n: int) -> torch.Tensor:
        out = torch.empty_like(acc, memory_format=torch.contiguous_format)
        if n == 0 or not self.steps:
            out.copy_(acc)
            return out
        dev = acc.device
        if dev not in self._on_device:
            self._on_device[dev] = (
                torch.as_tensor(self.words, device=dev),
                torch.as_tensor(self.step_words, device=dev),
                torch.as_tensor(self.const_vals, device=dev),
            )
        progs, steps, const_w = self._on_device[dev]
        acc_c, table_c = acc.contiguous(), table.contiguous()
        lib = _kernels.load("circuit")
        rc = lib.circuit_chain_launch(
            dev.index, progs.data_ptr(), int(progs.numel()), self.smem, self.warps,
            steps.data_ptr(), len(self.steps), table_c.data_ptr(), table.shape[2],
            acc_c.data_ptr(), const_w.data_ptr() if self.n_const else 0, self.n_const,
            out.data_ptr(), n, self.n_acc, torch.cuda.current_stream(dev).cuda_stream,
        )
        _kernels.check("circuit", lib, rc, "circuit_error_string")
        _note_launch(self.name)
        return out


def _mix(m: torch.Tensor, negsum: torch.Tensor, wires: torch.Tensor) -> torch.Tensor:
    """Rows of m (float64 [rows, w]) over canonical half-form wires
    ([24, w, n] float64) -> [24, rows, n] canonical digits, exact mod p."""
    rows, n = m.shape[0], wires.shape[-1]
    c = fq_consts(wires.device)
    v = F.pad(torch.matmul(m, wires).to(torch.int64), (0, 0, 0, 0, 0, _WIDE - N_HALF))
    v += negsum[None, :, None] * c.p26[:, :, None]  # V = mix + negsum p, 0 <= V < 64p
    d = _carry(v.reshape(_WIDE, -1))
    top = d[22] | (d[23] << HALF) | (d[24] << 2 * HALF) | (d[25] << 3 * HALF)  # V >> 352
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
