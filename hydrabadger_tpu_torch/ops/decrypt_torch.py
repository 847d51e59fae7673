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
"""
from __future__ import annotations

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


class _Ops:
    """The B2 entries and circuit calls an engine uses: the kernels'
    wrappers, or the plain versions on any device (use_kernel=False)."""

    def __init__(self, use_kernel: bool):
        col = 0 if use_kernel else 1
        e = fq_torch.ENTRIES
        self.mul, self.dbl = e["mul"][col], e["dbl"][col]
        self.add, self.ladd = e["add"][col], e["ladd"][col]
        self.use_kernel = use_kernel

    def circuit(self, circ: CircuitExec, x: torch.Tensor) -> torch.Tensor:
        return circ(x) if self.use_kernel else circ.plain(x)

    def chain(self, chain: CircuitChain, acc: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        return chain(acc, table) if self.use_kernel else chain.plain(acc, table)


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
        self.circ_da1 = _dblk_add_circuit(W1)
        self.circ_a = _add_circuit()
        self.circ_da2 = _dblk_add_circuit(W2)
        self._plan1 = self._stage1_plan()
        self.straus = CircuitChain([self.circ_da2, self.circ_a],
                                   _chain_steps(self._straus_plan(), q), 3, "straus")

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
            Launch("fq_point", "mul", 2 * n, 1, 2, "a*a"),  # the check: Z^2
            Launch("fq_point", "mul", 4 * n, 1, 3, "a*b"),  # X Z^2, Y Z^2
            Launch("fq_point", "mul", 2 * n, 1, 3, "a*b"),  # Y Z^2 * Z
            Launch("circuit", da1.name, S * n, sum(p[1] for p in stage1),
                   da1.n_inputs + da1.n_outputs, products=da1.n_products),
            Launch("circuit", a.name, S * n, sum(p[3] for p in stage1),
                   a.n_inputs + a.n_outputs, products=a.n_products),
            Launch("circuit", straus.name, n, 1, straus.elements(), products=straus.products),
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

    def _jac_eq(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Projective equality of [3, 12, n] points on every lane -> 0-d
        bool: X1 Z2^2 == X2 Z1^2 and Y1 Z2^3 == Y2 Z1^3, three batched
        product launches."""
        n = a.shape[-1]
        mul = self.ops.mul
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

    # -- the epoch ----------------------------------------------------------

    def __call__(self, U: torch.Tensor):
        """U [3, 12, n_ct] int32 -> (U_next [3, 12, n_ct], ok 0-d bool)."""
        ops, n, q = self.ops, self.n_ct, self.q
        S = q + 1
        if tuple(U.shape) != (3, N_LIMBS, n) or U.device != self.device:
            raise ValueError(f"expected [3, {N_LIMBS}, {n}] int32 on {self.device}")

        # 1. shared W1 GLV dual table of U, and its beta-twisted copy
        t1 = _build_table(U, 1 << W1, ops)  # [3, 12, 64, n]
        tx = t1[0].reshape(N_LIMBS, -1)
        bx = ops.mul(tx, self._beta)
        t2 = torch.cat([bx.reshape(1, *t1.shape[1:]), t1[1:]], 0)

        # 2. the q share ladders and the check ladder, one batch of S*n lanes
        acc = jac_infinity(S * n, self.device).reshape(3, N_LIMBS, S, n)
        for (i1, i2), (codes1, need_da, codes2, need_a) in zip(self._idx, self._plan1):
            s1 = t1.index_select(2, i1)  # [3, 12, S, n]
            s2 = t2.index_select(2, i2)
            added = doubled = None
            if need_da:
                out = ops.circuit(self.circ_da1, torch.cat([acc, s1], 0))
                added, doubled = out[:3], out[3:]
            acc = self._choose(codes1, (added, doubled, s1, acc))
            added2 = None
            if need_a:
                added2 = ops.circuit(self.circ_a, torch.cat([acc, s2], 0))
            acc = self._choose(codes2, (added2, acc, s2, acc))
        shares, direct = acc[:, :, :q], acc[:, :, q]

        # 3. Straus combine: U + sum_i lam_i share_i
        tabs = _build_table(shares.reshape(3, N_LIMBS, q * n), 1 << W2, ops)
        comb = ops.chain(self.straus, jac_infinity(n, self.device),
                         tabs.reshape(3, N_LIMBS, (1 << W2) * q, n))

        # 4. the final add is the COMPLETE body (U == comb is legitimate
        # when master == 1), then the check against the direct lane
        U_next = ops.add(U, comb.contiguous())
        return U_next, self._jac_eq(U_next, direct.contiguous())


def build_epoch(n_ct: int, sks: Sequence[int], lams: Sequence[int], mp1: int,
                device="cuda", use_kernel: bool = True) -> DecryptEpoch:
    """The epoch over n_ct ciphertexts as a callable: U -> (U_next, ok)."""
    return DecryptEpoch(n_ct, sks, lams, mp1, device, use_kernel)
