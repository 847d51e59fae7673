"""BLS12-381 Fp2 and Jacobian G2 point ops — kernel B4 and its plain version.

Counterpart of hydrabadger_tpu/ops/fq2_T.py (the fused table and window
step) and of the composed Fp2 / G2 ops of ops/bls_g2_jax.py.  Layout
(ops/limbs.py): an Fp2 batch is [2, 12, n] int32, a G2 point batch
[3, 2, 12, n], a window table [16, 3, 2, 12, n] (entry-major, so one
entry is contiguous across lanes).  Every result is canonical (< p)
Montgomery form with R = 2^384, the same value and so the same bits as
the JAX package's 12-bit-limb result.

The kernel: csrc/fq2_point.cu, a block of 32 lanes x T warps running
the layered point programs of ops/point_block (warp t computes products
t, t + T, ... of each layer of independent Fp products), with four
entries:
  - `table` (B4a, fq2_T._pallas_table_call): [inf, P, 2P, ..., 15P] by 14
    chained complete adds;
  - `step` (B4b, fq2_T._pallas_step_call): 4 doublings, then the table
    entry the lane's 4-bit digit names (a gather; the TPU kernel used a
    16-way one-hot sum for lack of one), then a complete add;
  - `add`: the complete add alone, for the Lagrange combine's pairwise
    tree (composed XLA in bls_g2_jax.g2_weighted_sum_windowed);
  - `ladder`: a whole w = 4 scalar multiplication, the table and every
    window, in one launch (the table in a device scratch, each window's
    entry gathered in the kernel).
Each wrapper below launches it for a CUDA tensor (or raises) and runs the
plain version for a CPU tensor; `*_plain` runs the plain version on any
device.

The plain version reuses fq_torch's half form (24 16-bit digits in
int64) and its point formulas `jac_double_formula` /
`jac_add_core_formula`, the formulas fq2_T uses, over Fp2 ops: an Fp2
batch in half form is one [24, 2N] tensor, its c0 lanes then its c1
lanes, so an Fp2 add is one `add_h`, a Karatsuba product (u^2 = -1)
one `mont_mul_h` over 3N lanes and a complex square one over 2N.  The JAX selection order of the complete
add is kept: p1 at infinity -> p2, then p2 at infinity -> p1, then
h = r = 0 -> 2 p1, else the general result.  The double never
short-circuits infinity (X, Y stay nonzero with Z = 0, as in JAX), so
ladder states stay equal to JAX's limb for limb.
"""
from __future__ import annotations

import torch

from . import _kernels
from . import fq_torch as fq
from . import point_block
from .limbs import N_LIMBS

# Kernel launches made by the wrappers (one per launch, none for CPU
# tensors), in all and per entry.  chip_smoke.py sets them to 0 before
# the main path and reads them after.
launches = 0
launches_by_kind: dict[str, int] = {}

TABLE_SIZE = 16  # w = 4 windows
DOUBLINGS = 4

# kinds of csrc/fq2_point.cu's launch entry
KIND_TABLE, KIND_STEP, KIND_ADD, KIND_LADDER = range(4)

# Fp Montgomery products per lane, 3 per Karatsuba Fp2 product and 2 per
# complex Fp2 square: a double is 2 products and 5 squares, the complete
# add's general formula 12 and 4.  What the data needs of an add is its
# general formula alone (the doubling arm runs only where P == Q, and an
# add with infinity on either side needs none), and of a table 2P by the
# doubling arm and 13 general adds.
DBL_PRODUCTS = 2 * 3 + 5 * 2
GENERAL_ADD_PRODUCTS = 12 * 3 + 4 * 2
TABLE_PRODUCTS = DBL_PRODUCTS + (TABLE_SIZE - 3) * GENERAL_ADD_PRODUCTS

# field elements each entry must read and write per lane: a point is 6;
# the step reads its accumulator, the one selected entry and writes one;
# the ladder reads its point and writes its product (and reads the digits)
ELEMENTS = {"table": 6 + 6 * TABLE_SIZE, "step": 18, "add": 18, "ladder": 12}


# ---------------------------------------------------------------------------
# Fp2 in half form: [24, 2N], c0 lanes then c1 lanes
# ---------------------------------------------------------------------------


def fq2_mul_h(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Karatsuba (a0 + a1 u)(b0 + b1 u) with u^2 = -1: c0 = a0 b0 - a1 b1,
    c1 = (a0 + a1)(b0 + b1) - a0 b0 - a1 b1; the 3 products as one call."""
    n = a.shape[1] // 2
    sums = fq.add_h(torch.cat([a[:, :n], b[:, :n]], 1), torch.cat([a[:, n:], b[:, n:]], 1))
    t = fq.mont_mul_h(torch.cat([a, sums[:, :n]], 1), torch.cat([b, sums[:, n:]], 1))
    t0, t1, cross = t[:, :n], t[:, n : 2 * n], t[:, 2 * n :]
    d = fq.sub_h(torch.cat([t0, cross], 1), torch.cat([t1, t0], 1))  # c0 | cross - t0
    return torch.cat([d[:, :n], fq.sub_h(d[:, n:], t1)], 1)


def fq2_sqr_h(a: torch.Tensor) -> torch.Tensor:
    """Complex squaring: c0 = (a0 + a1)(a0 - a1), c1 = 2 a0 a1; the 2
    products as one call (the same canonical value as fq2_mul_h(a, a))."""
    n = a.shape[1] // 2
    a0, a1 = a[:, :n], a[:, n:]
    t = fq.mont_mul_h(torch.cat([fq.add_h(a0, a1), a0], 1), torch.cat([fq.sub_h(a0, a1), a1], 1))
    return torch.cat([t[:, :n], fq.add_h(t[:, n:], t[:, n:])], 1)


def fq2_is_zero_h(a: torch.Tensor) -> torch.Tensor:
    """[24, 2N] -> bool [N]: the element is 0."""
    return fq.is_zero_h(a).reshape(2, -1).all(0)


_H2_OPS = (fq2_mul_h, fq2_sqr_h, fq.add_h, fq.sub_h)


def _pick(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(mask.repeat(2).unsqueeze(0), a, b)


def g2_double_h(x, y, z):
    """a = 0 Jacobian doubling on the twist (infinity through Z3 = 2YZ = 0)."""
    return fq.jac_double_formula(x, y, z, *_H2_OPS)


def g2_add_h(x1, y1, z1, x2, y2, z2):
    """Branch-free complete add: the core, the doubling arm, and the
    infinity masks selecting exactly as fq2_T._jac2_add_body."""
    x3, y3, z3, h, r = fq.jac_add_core_formula(x1, y1, z1, x2, y2, z2, *_H2_OPS)
    dx, dy, dz = g2_double_h(x1, y1, z1)
    inf1, inf2 = fq2_is_zero_h(z1), fq2_is_zero_h(z2)
    dbl_case = fq2_is_zero_h(h) & fq2_is_zero_h(r)

    def pick(gen, dbl, a1, a2):
        return _pick(inf1, a2, _pick(inf2, a1, _pick(dbl_case, dbl, gen)))

    return pick(x3, dx, x1, x2), pick(y3, dy, y1, y2), pick(z3, dz, z1, z2)


# ---------------------------------------------------------------------------
# Plain versions on word tensors (any device)
# ---------------------------------------------------------------------------


def _fe2_h(a: torch.Tensor) -> torch.Tensor:
    """[2, 12, n] words -> [24, 2n]."""
    return fq.to_half(a.reshape(2, N_LIMBS, -1).transpose(0, 1)).reshape(2 * N_LIMBS, -1)


def _fe2_w(h: torch.Tensor, n: int) -> torch.Tensor:
    """[24, 2n] -> [2, 12, n] words."""
    return fq.to_words(h.reshape(2 * N_LIMBS, 2, n)).transpose(0, 1).contiguous()


def _pt2_h(pt: torch.Tensor):
    """[3, 2, 12, n] words -> (x, y, z), each [24, 2n]."""
    n = pt.shape[-1]
    h = fq.to_half(pt.reshape(6, N_LIMBS, n).transpose(0, 1)).reshape(2 * N_LIMBS, 3, 2 * n)
    return h[:, 0], h[:, 1], h[:, 2]


def _pt2_w(coords, n: int) -> torch.Tensor:
    """(x, y, z), each [24, 2n] -> [3, 2, 12, n] words."""
    w = fq.to_words(torch.stack(coords, 1))  # [12, 3, 2n]
    return w.reshape(N_LIMBS, 3, 2, n).permute(1, 2, 0, 3).contiguous()


def fq2_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[2, 12, n] x [2, 12, n] -> the Fp2 Montgomery product."""
    return _fe2_w(fq2_mul_h(_fe2_h(a), _fe2_h(b)), a.shape[-1])


def g2_infinity(n: int, device) -> torch.Tensor:
    """[3, 2, 12, n] infinity: x = y = (Montgomery one, 0), z = 0."""
    out = torch.zeros((3, 2, N_LIMBS, n), dtype=torch.int32, device=device)
    one = fq.consts(torch.device(device)).one_w[:, None]
    out[0, 0] = one
    out[1, 0] = one
    return out


def g2_neg(pt: torch.Tensor) -> torch.Tensor:
    """[3, 2, 12, n] -> -P (y negated); plain PyTorch on any device."""
    x, y, z = _pt2_h(pt)
    return _pt2_w((x, fq.sub_h(torch.zeros_like(y), y), z), pt.shape[-1])


def g2_double_plain(pt: torch.Tensor) -> torch.Tensor:
    return _pt2_w(g2_double_h(*_pt2_h(pt)), pt.shape[-1])


def g2_add_plain(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    return _pt2_w(g2_add_h(*_pt2_h(p1), *_pt2_h(p2)), p1.shape[-1])


def g2_table_plain(pt: torch.Tensor) -> torch.Tensor:
    """[3, 2, 12, n] -> [16, 3, 2, 12, n]: [inf, P, 2P, ..., 15P], entry
    i + 1 = add(entry i, P) as in fq2_T._table_body."""
    n = pt.shape[-1]
    p = _pt2_h(pt)
    acc = p
    entries = [g2_infinity(n, pt.device), pt]
    for _ in range(TABLE_SIZE - 2):
        acc = g2_add_h(*acc, *p)
        entries.append(_pt2_w(acc, n))
    return torch.stack(entries)


def _select(table: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """table[digit[l], ..., l] for every lane l -> [3, 2, 12, n]."""
    idx = (digits.to(torch.int64) & (TABLE_SIZE - 1)).reshape(1, 1, 1, 1, -1)
    return table.gather(0, idx.expand(1, *table.shape[1:])).squeeze(0)


def g2_window_step_plain(acc: torch.Tensor, table: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """One w = 4 window: 4 doublings, select table[digit], complete add
    (fq2_T._step_body)."""
    h = _pt2_h(acc)
    for _ in range(DOUBLINGS):
        h = g2_double_h(*h)
    return _pt2_w(g2_add_h(*h, *_pt2_h(_select(table, digits))), acc.shape[-1])


def g2_ladder_plain(points: torch.Tensor, windows: torch.Tensor) -> torch.Tensor:
    """[3, 2, 12, n] points x [w, n] int32 digits, MSB first -> [3, 2, 12, n]:
    the table, then per window 4 doublings and a complete add of the
    entry the digit names, from infinity (bls_g2_jax's windowed ladder)."""
    table = g2_table_plain(points)
    acc = g2_infinity(points.shape[-1], points.device)
    for j in range(windows.shape[0]):
        acc = g2_window_step_plain(acc, table, windows[j])
    return acc


# ---------------------------------------------------------------------------
# The kernel's wrappers
# ---------------------------------------------------------------------------


def _check(x: torch.Tensor, shape: tuple, what: str, dtype=torch.int32) -> None:
    if not isinstance(x, torch.Tensor) or x.dtype != dtype:
        raise TypeError(f"{what}: expected a {dtype} tensor")
    if tuple(x.shape) != shape:
        raise ValueError(f"{what}: expected shape {shape}, got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu tensors, not {x.device}")


def _launch(kind: int, label: str, a: torch.Tensor, out_shape: tuple, b=None, digits=None,
            scratch_shape=None):
    """One csrc/fq2_point.cu launch over the last axis of `a`; every
    operand on one card and contiguous.  `scratch_shape`: the ladder's
    table, allocated here for the kernel's own use."""
    global launches
    dev = a.device
    a, b, digits = (None if x is None else x.contiguous() for x in (a, b, digits))
    if any(x is not None and x.device != dev for x in (b, digits)):
        raise ValueError("fq2_point: operands must share one device")
    out = torch.empty(out_shape, dtype=torch.int32, device=dev)
    n = out_shape[-1]
    if n:
        prog = point_block.programs(2)
        words = point_block.words_on(2, dev)
        table = None if scratch_shape is None else torch.empty(scratch_shape, dtype=torch.int32,
                                                               device=dev)
        windows = digits.shape[0] if kind == KIND_LADDER else 0
        lib = _kernels.load("fq2_point")
        ptrs = [0 if x is None else x.data_ptr() for x in (a, b, digits)]
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fq2_point_launch(dev.index, kind, words.data_ptr(), int(words.numel()),
                                  prog.smem, prog.warps, *ptrs, windows,
                                  0 if table is None else table.data_ptr(), out.data_ptr(), n,
                                  stream)
        _kernels.check("fq2_point", lib, rc, "fq2_point_error_string")
        launches += 1
        launches_by_kind[label] = launches_by_kind.get(label, 0) + 1
    return out


def g2_table(pt: torch.Tensor) -> torch.Tensor:
    """[3, 2, 12, n] -> the [16, 3, 2, 12, n] w = 4 window table."""
    n = pt.shape[-1] if pt.dim() == 4 else -1
    _check(pt, (3, 2, N_LIMBS, n), "g2_table")
    if pt.device.type == "cuda":
        return _launch(KIND_TABLE, "table", pt, (TABLE_SIZE, 3, 2, N_LIMBS, n))
    return g2_table_plain(pt)


def g2_window_step(acc: torch.Tensor, table: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """One window: 4 doublings of acc [3, 2, 12, n], then a complete add of
    table[digits[l]] per lane l (digits: [n] int32, each 0..15; the kernel
    and the plain version both read digit & 15)."""
    n = acc.shape[-1] if acc.dim() == 4 else -1
    _check(acc, (3, 2, N_LIMBS, n), "g2_window_step acc")
    _check(table, (TABLE_SIZE, 3, 2, N_LIMBS, n), "g2_window_step table")
    _check(digits, (n,), "g2_window_step digits")
    if acc.device.type == "cuda":
        return _launch(KIND_STEP, "step", acc, acc.shape, b=table, digits=digits)
    return g2_window_step_plain(acc, table, digits)


def g2_add(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Complete Jacobian G2 add (infinity on either side, P + P, P + (-P))."""
    n = p1.shape[-1] if p1.dim() == 4 else -1
    _check(p1, (3, 2, N_LIMBS, n), "g2_add")
    _check(p2, (3, 2, N_LIMBS, n), "g2_add")
    if p1.device.type == "cuda":
        return _launch(KIND_ADD, "add", p1, p1.shape, b=p2)
    return g2_add_plain(p1, p2)


def g2_ladder(points: torch.Tensor, windows: torch.Tensor) -> torch.Tensor:
    """The whole windowed ladder in one launch: [3, 2, 12, n] points x
    [w, n] int32 4-bit digits, MSB first (each read & 15) -> [3, 2, 12, n]."""
    n = points.shape[-1] if points.dim() == 4 else -1
    _check(points, (3, 2, N_LIMBS, n), "g2_ladder points")
    w = windows.shape[0] if windows.dim() == 2 else -1
    _check(windows, (w, n), "g2_ladder windows")
    if points.device.type == "cuda":
        return _launch(KIND_LADDER, "ladder", points, points.shape, digits=windows,
                       scratch_shape=(TABLE_SIZE, 3, 2, N_LIMBS, n))
    return g2_ladder_plain(points, windows)


# The entries as (name -> (kernel wrapper, plain version)); the G2 ladder
# picks one column (use_kernel) and chip_smoke holds one against the other.
ENTRIES = {
    "table": (g2_table, g2_table_plain),
    "step": (g2_window_step, g2_window_step_plain),
    "add": (g2_add, g2_add_plain),
    "ladder": (g2_ladder, g2_ladder_plain),
}
