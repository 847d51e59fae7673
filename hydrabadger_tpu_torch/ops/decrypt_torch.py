"""Fused threshold-decrypt epoch engine — the config-8 hot path.

Counterpart of hydrabadger_tpu/ops/decrypt_T.py (`build_epoch` with its
default fused-circuit window path).  Every node's decryption share
U*sk_i of every ciphertext U, their Lagrange combine, and the on-device
check, over n_ct ciphertexts at once:

    U [3, 12, n_ct]  ->  U_next = U + sum_i lam_i (U sk_i),  ok

with ok = (U_next == U*(master+1)) on every lane.  The arithmetic per
lane is the JAX engine's, step for step, so U_next equals the JAX
engine's limb for limb (not only projectively):

1. a shared w=6 GLV dual table of U (entry 2 an explicit double, then
   61 ladder adds; the beta-twisted copy in one product launch);
2. the q share ladders and the check ladder U*(master+1) off that table,
   22 windows each of the (2^6 acc + sel) circuit and the add circuit;
3. the Straus combine: w=4 tables of the q shares, then 64 windows of
   the (2^4 acc + sel) circuit and q-1 add circuits;
4. the final complete add and the projective equality check.

What differs from the JAX engine is how the loop is laid out, not what
each lane computes:
  - the S = q+1 ladders of stage 1 run as ONE batch of S*n_ct lanes per
    window (JAX scans over q), each ladder segment gathering its own
    table entry (`index_select`) and taking its own glue select;
  - the digits are static, so `started` and `digit != 0` are host
    booleans: glue selects are plain tensor choices or one `where` with
    a per-segment mask built at construction, never a host sync, and a
    circuit launch whose every result the glue would discard is skipped
    (`launch_counts` gives the numbers the digits imply);
  - the Straus combine is ONE launch of the circuit kernel's chain entry
    (`circuit_torch.CircuitChain`, JAX's `lax.scan`): its steps, table
    entries and glue are fixed by the Lagrange digits at construction,
    and the accumulator stays on the card's SMs between steps.

`HYDRABADGER_WIN_CIRCUIT=0` (read at construction, as JAX reads it when
it traces) selects decrypt_T's other window path, B2's point entries in
place of B3's circuits: stage 1 is one `win6` launch per GLV window over
all S*n_ct lanes (6 doublings and two ladder adds of the gathered entries,
the accumulator starting at infinity: `fq_T.window_step_T`), and the
Straus combine per window one `dblk4` and then q `ladd`s of the w=4 tables'
entries.  It makes no B3 launch; its U_next equals the circuit path's
projectively (JAX's contract, tests/test_decrypt_T.py).
"""
from __future__ import annotations

import os
from functools import lru_cache
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from ..crypto import bls12_381 as bls
from . import fq_torch
from .circuit_torch import SEL as TAKE_ENTRY, CircuitChain, CircuitExec, executor
from .fp12_circuit import CircuitBuilder
from .fq_torch import jac_add_core_formula, jac_double_formula, jac_infinity
from .limbs import BETA_MONT, GLV_LAMBDA, N_LIMBS

W1 = 6  # window of the shared GLV dual table and the share ladders
W2 = 4  # window of the Straus combine's tables


def _digits_msb(k: int, w: int, n_win: int) -> List[int]:
    """k -> n_win w-bit digits, MSB first."""
    return [(k >> (w * (n_win - 1 - i))) & ((1 << w) - 1) for i in range(n_win)]


def glv_digits(scalars: Sequence[int], w: int) -> np.ndarray:
    """GLV-split static digits: [len(scalars), 2, n_win] int32 —
    [:, 0] the k1 (plain) half, [:, 1] the k2 (beta-twisted) half."""
    n_win = -(-130 // w)  # both halves < 2^129 < 2^(w*n_win)
    out = []
    for k in scalars:
        k2, k1 = divmod(int(k) % bls.R, GLV_LAMBDA)
        out.append([_digits_msb(k1, w, n_win), _digits_msb(k2, w, n_win)])
    return np.asarray(out, np.int32)


def plain_digits(scalars: Sequence[int], w: int) -> np.ndarray:
    """[len(scalars), n_win] static w-bit digits of full 255-bit scalars."""
    n_win = -(-256 // w)
    return np.asarray([_digits_msb(int(k) % bls.R, w, n_win) for k in scalars], np.int32)


# ---------------------------------------------------------------------------
# The window circuits, recorded from the port's own formulas
# ---------------------------------------------------------------------------

_SYM_OPS = (
    lambda a, b: a * b,  # mul
    lambda a: a * a,  # sqr (the recorder treats it as a product lane)
    lambda a, b: a + b,  # add
    lambda a, b: a - b,  # sub
)


def _sym_dbl(pt):
    return jac_double_formula(*pt, *_SYM_OPS)


def _sym_ladd(p1, p2):
    x3, y3, z3, _h, _r = jac_add_core_formula(*p1, *p2, *_SYM_OPS)
    return (x3, y3, z3)


@lru_cache(maxsize=None)
def _dblk_add_circuit(k: int) -> CircuitExec:
    """Inputs acc(3), sel(3); outputs (2^k acc + sel)(3), (2^k acc)(3)."""
    b = CircuitBuilder(6)
    acc = tuple(b.input(c) for c in range(3))
    sel = tuple(b.input(3 + c) for c in range(3))
    for _ in range(k):
        acc = _sym_dbl(acc)
    added = _sym_ladd(acc, sel)
    return executor(b.compile([*added, *acc]), f"dblk{k}_add")


@lru_cache(maxsize=None)
def _add_circuit() -> CircuitExec:
    """Inputs acc(3), sel(3); outputs (acc + sel)(3)."""
    b = CircuitBuilder(6)
    acc = tuple(b.input(c) for c in range(3))
    sel = tuple(b.input(3 + c) for c in range(3))
    return executor(b.compile([*_sym_ladd(acc, sel)]), "add")


# ---------------------------------------------------------------------------
# Glue: one conditional table add resolved outside the branch-free circuit
# ---------------------------------------------------------------------------

ADDED, BASE, SEL, PREV = range(4)


def _glue_codes(started: np.ndarray, nz: np.ndarray) -> np.ndarray:
    """Per ladder: which candidate `decrypt_T._glue_add` takes.

    started & nz -> the circuit's sum; started & !nz -> the base (the
    doubled accumulator, or prev for a plain add); !started & nz -> the
    table entry itself; !started & !nz -> prev (clean infinity)."""
    return np.where(started, np.where(nz, ADDED, BASE), np.where(nz, SEL, PREV))


def _chain_steps(plan, q: int):
    """The Straus plan as `CircuitChain` steps over a [3, 12, 16 q, n]
    table (entry dig*q + i): circuit 0 (dbl^4 + add) for member 0 of a
    window, circuit 1 (add) for the others.  ADDED takes output group 0,
    BASE the doubled accumulator (group 1) for member 0 and the
    accumulator itself otherwise; SEL takes the entry; PREV keeps the
    accumulator.  A step whose result the glue discards is not a step."""
    steps = []
    for col in plan:
        for i, (dig, need, code) in enumerate(col):
            entry = dig * q + i
            if code == SEL:
                steps.append((None, entry, TAKE_ENTRY))
            elif need:
                steps.append((0 if i == 0 else 1, entry, 0 if code == ADDED else 1))
    return steps


class Launch(NamedTuple):
    """One launch shape of an epoch."""

    kernel: str  # "fq_point" (B2) or "circuit" (B3)
    name: str  # the B2 entry, the circuit or the chain: the launch counters' key
    lanes: int
    count: int  # launches per epoch
    elements: int  # field elements per lane the launch must read or write, each once
    form: str = ""  # a B2 `mul`'s operands: "a*b", "a*a" (a square) or "a*const"
    products: int = 0  # B3: Montgomery products per lane of one launch


class _Ops(fq_torch.PointOps):
    """The B2 entries and the circuit calls the decrypt engine uses: the
    kernels' wrappers, or the plain versions on any device
    (use_kernel=False)."""

    def circuit(self, circ: CircuitExec, x: torch.Tensor) -> torch.Tensor:
        return circ(x) if self.use_kernel else circ.plain(x)

    def chain(self, chain: CircuitChain, acc: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        return chain(acc, table) if self.use_kernel else chain.plain(acc, table)


def _use_win_circuit() -> bool:
    return os.environ.get("HYDRABADGER_WIN_CIRCUIT", "1") != "0"


def jac_eq(a: torch.Tensor, b: torch.Tensor, mul) -> torch.Tensor:
    """Projective equality of [3, 12, n] points on every lane -> 0-d
    bool: X1 Z2^2 == X2 Z1^2 and Y1 Z2^3 == Y2 Z1^3, in three batched
    calls of `mul` (B2's product or its plain version)."""
    n = a.shape[-1]
    x1, y1, z1 = a
    x2, y2, z2 = b
    zs = torch.cat([z1, z2], 1)
    zz = mul(zs, zs)
    z1s, z2s = zz[:, :n], zz[:, n:]
    m = mul(torch.cat([x1, x2, y1, y2], 1), torch.cat([z2s, z1s, z2s, z1s], 1))
    yy = mul(m[:, 2 * n:], torch.cat([z2, z1], 1))
    x_ok = (m[:, :n] == m[:, n:2 * n]).all(0)
    y_ok = (yy[:, :n] == yy[:, n:]).all(0)
    return (x_ok & y_ok).all()


# the three product launches of jac_eq: (lanes per ciphertext, elements per
# lane, operand form)
JAC_EQ_MULS = ((2, 2, "a*a"), (4, 3, "a*b"), (2, 3, "a*b"))


def _build_table(pt: torch.Tensor, order: int, ops: _Ops) -> torch.Tensor:
    """[3, 12, n] -> [3, 12, order, n]: entry i is i*pt.  Entry 2 is an
    explicit double (the guaranteed equal-points case); higher entries
    chain with the incomplete ladder add, (prev, pt) as in decrypt_T."""
    n = pt.shape[-1]
    tab = torch.empty((3, N_LIMBS, order, n), dtype=torch.int32, device=pt.device)
    tab[:, :, 0] = jac_infinity(n, pt.device)
    tab[:, :, 1] = pt
    prev = ops.dbl(pt)
    tab[:, :, 2] = prev
    for i in range(3, order):
        prev = ops.ladd(prev, pt)
        tab[:, :, i] = prev
    return tab


class DecryptEpoch:
    """One config-8 epoch over n_ct ciphertexts (see the module docstring).

    sks: the quorum's q secret-key shares; lams: their Lagrange
    coefficients at zero; mp1: master+1 (the check scalar).  All static:
    their digits fix every table index and glue select at construction.
    """

    def __init__(self, n_ct: int, sks: Sequence[int], lams: Sequence[int], mp1: int,
                 device, use_kernel: bool = True):
        q = len(sks)
        if len(lams) != q:
            raise ValueError(f"{q} key shares but {len(lams)} Lagrange coefficients")
        self.n_ct, self.q = n_ct, q
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())  # as tensors report it
        self.device = dev
        self.ops = _Ops(use_kernel)
        # stage 1: S = q+1 ladders (the q shares, then the check lane)
        d = np.concatenate([glv_digits(sks, W1), glv_digits([mp1], W1)])  # [S, 2, n_win]
        self.glv_d = d
        self.lam_d = plain_digits(lams, W2)  # [q, n_win2]
        self._idx = [
            (torch.as_tensor(d[:, 0, j], dtype=torch.int64, device=dev),
             torch.as_tensor(d[:, 1, j], dtype=torch.int64, device=dev))
            for j in range(d.shape[-1])
        ]
        self._masks: Dict[tuple, torch.Tensor] = {}
        self._beta = torch.as_tensor(BETA_MONT, device=dev)[:, None]  # one element, every lane
        self.win_circuit = _use_win_circuit()
        self.circ_da1 = _dblk_add_circuit(W1)
        self.circ_a = _add_circuit()
        self.circ_da2 = _dblk_add_circuit(W2)
        self._plan1 = self._stage1_plan()
        self.straus = (CircuitChain([self.circ_da2, self.circ_a],
                                    _chain_steps(self._straus_plan(), q), 3, "straus")
                       if self.win_circuit else None)

    # -- the static plan ----------------------------------------------------

    def _stage1_plan(self):
        """Per window: (codes of the dbl+add glue, launch it?, codes of the
        add glue, launch it?) for every ladder segment."""
        S = self.glv_d.shape[0]
        started = np.zeros(S, bool)
        plan = []
        for j in range(self.glv_d.shape[-1]):
            nz1 = self.glv_d[:, 0, j] != 0
            codes1, need_da = _glue_codes(started, nz1), bool(started.any())
            started = started | nz1
            nz2 = self.glv_d[:, 1, j] != 0
            codes2, need_a = _glue_codes(started, nz2), bool((started & nz2).any())
            started = started | nz2
            plan.append((codes1, need_da, codes2, need_a))
        return plan

    def _straus_plan(self):
        """Per window, per quorum member: (digit, launch its circuit?,
        glue code) for the single combine ladder."""
        started = False
        plan = []
        for j in range(self.lam_d.shape[1]):
            col = []
            for i in range(self.q):
                dig = int(self.lam_d[i, j])
                nz = dig != 0
                need = started if i == 0 else (started and nz)
                col.append((dig, need, int(_glue_codes(np.array(started), np.array(nz)))))
                started = started or nz
            plan.append(col)
        return plan

    def launch_shapes(self) -> List[Launch]:
        """The kernel launches of one epoch, derived from the digits: one
        `Launch` per shape and operand form."""
        n, q = self.n_ct, self.q
        S = q + 1
        stage1, straus = self._plan1, self.straus
        da1, a = self.circ_da1, self.circ_a
        rows = [
            Launch("fq_point", "dbl", n, 1, 6),  # the shared table's entry 2
            Launch("fq_point", "ladd", n, (1 << W1) - 3, 9),  # its chain
            Launch("fq_point", "mul", (1 << W1) * n, 1, 2, "a*const"),  # the beta twist
            Launch("fq_point", "dbl", q * n, 1, 6),  # the Straus tables
            Launch("fq_point", "ladd", q * n, (1 << W2) - 3, 9),
            Launch("fq_point", "add", n, 1, 9),  # the final complete add
            *(Launch("fq_point", "mul", k * n, 1, el, form) for k, el, form in JAC_EQ_MULS),
        ]
        if self.win_circuit:
            rows += [
                Launch("circuit", da1.name, S * n, sum(p[1] for p in stage1),
                       da1.n_inputs + da1.n_outputs, products=da1.n_products),
                Launch("circuit", a.name, S * n, sum(p[3] for p in stage1),
                       a.n_inputs + a.n_outputs, products=a.n_products),
                Launch("circuit", straus.name, n, 1, straus.elements(),
                       products=straus.products),
            ]
        else:
            n_win2 = self.lam_d.shape[1]
            rows += [
                Launch("fq_point", f"win{W1}", S * n, self.glv_d.shape[-1], 12),
                Launch("fq_point", f"dblk{W2}", n, n_win2, 6),
                Launch("fq_point", "ladd", n, n_win2 * q, 9),
            ]
        return [r for r in rows if r.count]

    def launch_counts(self) -> Dict[str, Dict[str, int]]:
        """Kernel launches one epoch makes: {"fq_point": per B2 entry,
        "circuit": per circuit name}."""
        out: Dict[str, Dict[str, int]] = {"fq_point": {}, "circuit": {}}
        for r in self.launch_shapes():
            out[r.kernel][r.name] = out[r.kernel].get(r.name, 0) + r.count
        return out

    # -- helpers ------------------------------------------------------------

    def _choose(self, codes: np.ndarray, cands) -> torch.Tensor:
        """Per ladder segment s, cands[codes[s]] ([3, 12, S, n] each)."""
        vals = np.unique(codes)
        out = cands[vals[0]]
        for v in vals[1:]:
            key = (codes.tobytes(), int(v))
            mask = self._masks.get(key)
            if mask is None:
                mask = torch.as_tensor(codes == v, device=self.device)[None, None, :, None]
                self._masks[key] = mask
            out = torch.where(mask, cands[v], out)
        return out

    # -- the epoch ----------------------------------------------------------

    def dual_table(self, U: torch.Tensor):
        """Stage 1's shared W1 GLV dual table of U [3, 12, n] and its
        beta-twisted copy: two [3, 12, 2^W1, n] tables."""
        t1 = _build_table(U, 1 << W1, self.ops)
        bx = self.ops.mul(t1[0].reshape(N_LIMBS, -1), self._beta)
        return t1, torch.cat([bx.reshape(1, *t1.shape[1:]), t1[1:]], 0)

    def window_operands(self, t1: torch.Tensor, t2: torch.Tensor, j: int):
        """GLV window j's table entries for every ladder segment: two
        [3, 12, S, n] gathers, one off each half's table."""
        i1, i2 = self._idx[j]
        return t1.index_select(2, i1), t2.index_select(2, i2)

    def __call__(self, U: torch.Tensor):
        """U [3, 12, n_ct] int32 -> (U_next [3, 12, n_ct], ok 0-d bool)."""
        return self.finish(U, self.ladders(U))

    def ladders(self, U: torch.Tensor) -> torch.Tensor:
        """Steps 1-2: U [3, 12, n_ct] -> the S = q+1 ladders' results
        [3, 12, S, n_ct]: the q shares U sk_i, then U (master+1)."""
        ops, n, q = self.ops, self.n_ct, self.q
        S = q + 1
        if tuple(U.shape) != (3, N_LIMBS, n) or U.device != self.device:
            raise ValueError(f"expected [3, {N_LIMBS}, {n}] int32 on {self.device}")

        # 1. shared W1 GLV dual table of U, and its beta-twisted copy
        t1, t2 = self.dual_table(U)

        # 2. the q share ladders and the check ladder, one batch of S*n lanes
        acc = jac_infinity(S * n, self.device).reshape(3, N_LIMBS, S, n)
        for j, (codes1, need_da, codes2, need_a) in enumerate(self._plan1):
            s1, s2 = self.window_operands(t1, t2, j)
            if not self.win_circuit:  # one B2 window step, infinity masked in it
                acc = ops.win(acc, s1, s2, W1)
                continue
            added = doubled = None
            if need_da:
                out = ops.circuit(self.circ_da1, torch.cat([acc, s1], 0))
                added, doubled = out[:3], out[3:]
            acc = self._choose(codes1, (added, doubled, s1, acc))
            added2 = None
            if need_a:
                added2 = ops.circuit(self.circ_a, torch.cat([acc, s2], 0))
            acc = self._choose(codes2, (added2, acc, s2, acc))
        return acc

    def finish(self, U: torch.Tensor, acc: torch.Tensor):
        """Steps 3-4: U and its ladders (`ladders`) -> (U_next, ok)."""
        ops, n, q = self.ops, self.n_ct, self.q
        shares, direct = acc[:, :, :q], acc[:, :, q]

        # 3. Straus combine: U + sum_i lam_i share_i
        tabs = _build_table(shares.reshape(3, N_LIMBS, q * n), 1 << W2, ops)
        if self.win_circuit:
            comb = ops.chain(self.straus, jac_infinity(n, self.device),
                             tabs.reshape(3, N_LIMBS, (1 << W2) * q, n))
        else:
            comb = self._straus_points(tabs)

        # 4. the final add is the COMPLETE body (U == comb is legitimate
        # when master == 1), then the check against the direct lane
        U_next = ops.add(U, comb.contiguous())
        return U_next, jac_eq(U_next, direct.contiguous(), ops.mul)

    def _straus_points(self, tabs: torch.Tensor) -> torch.Tensor:
        """The Straus combine on B2's point entries (decrypt_T's
        WIN_CIRCUIT=0 loop): per window 4 doublings of the accumulator, then
        one ladder add per quorum member of its table's digit entry, the
        accumulator starting at infinity.  tabs: [3, 12, 16, q*n]."""
        ops, n, q = self.ops, self.n_ct, self.q
        # [16, q, 3, 12, n]: entry (digit, member) one contiguous point batch
        by_entry = tabs.reshape(3, N_LIMBS, 1 << W2, q, n).permute(2, 3, 0, 1, 4).contiguous()
        acc = jac_infinity(n, self.device)
        for col in self.lam_d.T.tolist():
            acc = ops.dblk(acc, W2)
            for i, dig in enumerate(col):
                acc = ops.ladd(acc, by_entry[dig, i])
        return acc


def build_epoch(n_ct: int, sks: Sequence[int], lams: Sequence[int], mp1: int,
                device="cuda", use_kernel: bool = True) -> DecryptEpoch:
    """The epoch over n_ct ciphertexts as a callable: U -> (U_next, ok)."""
    return DecryptEpoch(n_ct, sks, lams, mp1, device, use_kernel)
