"""BLS12-381 Fp and Jacobian G1 point ops — kernel B2 and its plain version.

Counterpart of hydrabadger_tpu/ops/fq_T.py.  Layout (ops/limbs.py): a
field element batch is [12, n] int32 (32-bit words, lane axis last), a
point batch is [3, 12, n].  Every result is canonical (< p) Montgomery
form with R = 2^384, the same value — and so the same bits — as the JAX
package's 12-bit-limb result.

The kernel: csrc/fq_point.cu, with the entries of
fq_T._pallas_point_call: `mul` (one thread per lane), and `dbl`, `add`
(complete), `ladd` (incomplete ladder add), `dblk{k}` and `win{k}` on a
block of 32 lanes x T warps running the layered point programs of
ops/point_block; and the two G1 ladders of ops/bls_torch in one launch
each, `glv_ladder` (fq_T.glv_ladder_T) and `windowed_ladder`
(fq_T.windowed_ladder_T).  Each wrapper below launches it for a CUDA
tensor (or raises) and runs the plain version for a CPU tensor;
`*_plain` runs the plain version on any device.

The plain version works on 24 16-bit digits in int64 ("half" form, [24,
...] with the lane axes after the digit axis).  Products of two digits
are < 2^32 and sums of 24 of them < 2^37, so a schoolbook product is one
broadcast multiply and a skewed sum, and every carry is exact:
`_carry` resolves a whole carry chain with a fixed number of tensor ops
(no loop over digits): two folding rounds bring every position to
<= 2^16 + 1, and the remaining ripple is one 48-bit integer addition of
the packed generate/propagate bit-vectors, whose carries are the ripple.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from . import _kernels
from .limbs import BETA_MONT, LIMB_BITS, N_LIMBS, ONE_MONT, P, R_MONT

# Kernel launches made by the wrappers (one per launch, none for CPU
# tensors), in all and per entry.  chip_smoke.py sets them to 0 before
# the main path and reads them after.
launches = 0
launches_by_kind: dict[str, int] = {}

HALF = 16
N_HALF = 2 * N_LIMBS  # 24 16-bit digits
MASK = (1 << HALF) - 1
PINV = (-pow(P, -1, R_MONT)) % R_MONT  # p * PINV == -1 mod R

# kinds of csrc/fq_point.cu's launch entry
(KIND_MUL, KIND_DBL, KIND_ADD, KIND_LADD, KIND_DBLK, KIND_WIN, KIND_MULC, KIND_GLV_LADDER,
 KIND_WINDOWED_LADDER) = range(9)
TABLE_SIZE = 16  # the ladders' w = 4 tables

# Montgomery products per launch per lane of each B2 entry (from the
# formulas: jac_double 5 squares + 2 muls, the ladder add 12 muls + 4
# squares, the complete add that plus its doubling arm)
PRODUCTS = {"mul": 1, "dbl": 7, "ladd": 16, "add": 23}


def products(kind: str) -> int:
    """Montgomery products per lane of one B2 launch of `kind`."""
    if kind.startswith("dblk"):
        return 7 * int(kind[4:])
    if kind.startswith("win"):
        return 7 * int(kind[3:]) + 2 * PRODUCTS["ladd"]
    return PRODUCTS[kind]


def _digits(n: int, count: int) -> np.ndarray:
    return np.array([(n >> (HALF * i)) & MASK for i in range(count)], np.int64)


# ---------------------------------------------------------------------------
# Device constants
# ---------------------------------------------------------------------------


class _Consts:
    def __init__(self, device: torch.device):
        def t(a, dtype=torch.int64):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        pinv = _digits(PINV, N_HALF)
        p = _digits(P, N_HALF)
        # [k, i] = pinv[k - i]: the low half of (t * PINV) as one product
        # (float64 is exact: every sum is < 2^42)
        self.pinv_toeplitz = t(
            [[pinv[k - i] if k >= i else 0 for i in range(N_HALF)] for k in range(N_HALF)],
            # hblint: disable=limb-layout -- exact integer product: float64 carries 16-bit digit sums below 2^53 without rounding (the plain version's dense product; torch's CUDA matmul takes floating types only)
            torch.float64,
        )
        # [k, i] = p[k - i]: m * P, every sum < 2^37
        self.p_toeplitz = t(
            [[p[k - i] if 0 <= k - i < N_HALF else 0 for i in range(N_HALF)]
             for k in range(2 * N_HALF)],
            # hblint: disable=limb-layout -- exact integer product: float64 carries 16-bit digit sums below 2^53 without rounding (the plain version's dense product; torch's CUDA matmul takes floating types only)
            torch.float64,
        )
        self.p25 = t(np.append(p, 0))[:, None]
        self.p26 = t(np.append(p, [0, 0]))[:, None]
        self.p_r49 = t(np.concatenate([np.zeros(N_HALF, np.int64), p, [0]]))[:, None]
        # a redundant form of 0 mod 2^(16W) whose positions dominate any
        # negative input position (see _carry)
        z = np.full(2 * N_HALF + 2, (1 << 30) * MASK, np.int64)
        z[0] = 1 << 46
        self.zero_pad = t(z)[:, None]
        self.idx = t(np.arange(2 * N_HALF + 2))[:, None]
        self.one_w = t(ONE_MONT, torch.int32)


@lru_cache(maxsize=None)
def consts(device: torch.device) -> _Consts:
    return _Consts(torch.device(device))


def _c(x: torch.Tensor) -> _Consts:
    return consts(x.device)


# ---------------------------------------------------------------------------
# Half form: 24 16-bit digits in int64, [24, N] with the lanes flattened
# ---------------------------------------------------------------------------


def to_half(w: torch.Tensor) -> torch.Tensor:
    """[12, ...] int32 words -> [24, ...] int64 16-bit digits."""
    w64 = w.to(torch.int64) & ((1 << LIMB_BITS) - 1)
    h = torch.stack([w64 & MASK, w64 >> HALF], dim=1)
    return h.reshape(N_HALF, *w.shape[1:])


def to_words(h: torch.Tensor) -> torch.Tensor:
    """[24, ...] canonical digits -> [12, ...] int32 words."""
    h2 = h.reshape(N_LIMBS, 2, *h.shape[1:])
    v = h2[:, 0] | (h2[:, 1] << HALF)
    return (v - ((v >> (LIMB_BITS - 1)) << LIMB_BITS)).to(torch.int32)


def _carry(x: torch.Tensor) -> torch.Tensor:
    """[W, N] int64 positions, each in [-2^46 + 2^30, 2^46] -> the
    canonical 16-bit digits of (sum_i x_i 2^(16 i)) mod 2^(16 W), W <= 50.

    Adding a redundant zero (z_0 = 2^46, z_i = 2^30 (2^16 - 1): sum z_i
    2^(16i) = 2^30 2^(16W) == 0 mod 2^(16W)) makes every position
    nonnegative, so a signed value comes out in two's complement."""
    W = x.shape[0]
    c = _c(x)
    x = x + c.zero_pad[:W]  # now 0 <= x < 2^48
    # round 1: the three 16-bit pieces of each position moved into place
    y = x & MASK
    y[1:] += (x[:-1] >> HALF) & MASK
    y[2:] += x[:-2] >> (2 * HALF)
    # round 2: every position <= 2^16 + 1, and <= 1 in its low digit if > 2^16 - 1
    hi = y >> HALF
    y &= MASK
    y[1:] += hi[:-1]
    # the ripple that remains: carries of the packed generate/propagate
    # bit-vectors (g and p are disjoint), i.e. one integer addition
    g = y >> HALF
    y &= MASK
    idx = c.idx[:W]
    gw = (g << idx).sum(0)
    aw = gw | ((y == MASK).to(torch.int64) << idx).sum(0)
    carries = (aw + gw) ^ aw ^ gw  # bit i: the carry into position i
    y += (carries >> idx) & 1
    return y.bitwise_and_(MASK)


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product of two [24, N] digit vectors -> [48, N] raw
    positions (each < 24 * 2^32 < 2^37)."""
    n = a.shape[1]
    outer = a[:, None] * b[None, :]  # [24, 24, N]
    skew = F.pad(outer, (0, 0, 0, N_HALF))  # row i: 24 products, 24 zeros
    skew = skew.reshape(N_HALF * 2 * N_HALF, n)[: N_HALF * (2 * N_HALF - 1)]
    t = skew.reshape(N_HALF, 2 * N_HALF - 1, n).sum(0)  # row i shifted by i
    return F.pad(t, (0, 0, 0, 1))


def _f64_mm(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    # hblint: disable=limb-layout -- exact integer product: float64 carries 16-bit digit sums below 2^53 without rounding (the plain version's dense product; torch's CUDA matmul takes floating types only)
    return torch.matmul(m, x.to(torch.float64)).to(torch.int64)


_CHUNK = 1 << 18  # lanes per plain product (bounds its [24, 48, N] scratch)


def mont_mul_h(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b/R mod p of canonical [24, N] digit batches
    (b may be one [24, 1] element for every lane)."""
    n = a.shape[1]
    if n > _CHUNK:
        return torch.cat(
            [mont_mul_h(a[:, i : i + _CHUNK], b if b.shape[1] == 1 else b[:, i : i + _CHUNK])
             for i in range(0, n, _CHUNK)],
            dim=1,
        )
    c = _c(a)
    t = _conv(a, b)
    # m = -t p^-1 mod R needs only t mod R: fold the low half once
    # (positions < 2^22) and take one exact float64 product
    tl = t[:N_HALF] & MASK
    tl[1:] += t[: N_HALF - 1] >> HALF
    m = _carry(_f64_mm(c.pinv_toeplitz, tl))
    w = F.pad(t + _f64_mm(c.p_toeplitz, m), (0, 0, 0, 1))  # R * r, r < 2p
    # r and r - p in one carry: the top digit of R (r - p) is 0xFFFF iff r < p
    both = _carry(torch.cat([w, w - c.p_r49], dim=1))
    return torch.where(both[2 * N_HALF, n:] != 0, both[N_HALF : 2 * N_HALF, :n],
                       both[N_HALF : 2 * N_HALF, n:])


def add_h(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    n = a.shape[1]
    s = F.pad(a + b, (0, 0, 0, 1))
    both = _carry(torch.cat([s, s - _c(a).p25], dim=1))
    return torch.where(both[N_HALF, n:] != 0, both[:N_HALF, :n], both[:N_HALF, n:])


def sub_h(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    n = a.shape[1]
    d = F.pad(a - b, (0, 0, 0, 1))
    both = _carry(torch.cat([d, d + _c(a).p25], dim=1))
    return torch.where(both[N_HALF, :n] != 0, both[:N_HALF, n:], both[:N_HALF, :n])


def is_zero_h(a: torch.Tensor) -> torch.Tensor:
    """[24, N] -> bool [N]: the element is 0."""
    return (a == 0).all(0)


# ---------------------------------------------------------------------------
# Point formulas (generic over the op domain, as in fq_T)
# ---------------------------------------------------------------------------


def jac_double_formula(x, y, z, mul, sqr, add, sub):
    """a=0 Jacobian doubling (dbl-2009-l shape: 5 squares + 2 muls),
    generic over the op domain — the plain version's digit ops AND the
    circuit recorder's Sym operators share this ONE body."""
    a = sqr(x)
    b = sqr(y)
    c = sqr(b)
    t = add(x, b)
    d = sub(sub(sqr(t), a), c)
    d = add(d, d)
    e = add(add(a, a), a)
    f = sqr(e)
    x3 = sub(f, add(d, d))
    c8 = add(c, c)
    c8 = add(c8, c8)
    c8 = add(c8, c8)
    y3 = sub(mul(e, sub(d, x3)), c8)
    yz = mul(y, z)
    z3 = add(yz, yz)
    return x3, y3, z3


def jac_add_core_formula(x1, y1, z1, x2, y2, z2, mul, sqr, add, sub):
    """General Jacobian add core (12 muls + 4 squares), NO case
    handling — callers layer inf masks / doubling arms / glue selects
    per their domain."""
    z1z1 = sqr(z1)
    z2z2 = sqr(z2)
    u1 = mul(x1, z2z2)
    u2 = mul(x2, z1z1)
    s1 = mul(mul(y1, z2), z2z2)
    s2 = mul(mul(y2, z1), z1z1)
    h = sub(u2, u1)
    r = sub(s2, s1)
    hh = sqr(h)
    hhh = mul(h, hh)
    v = mul(u1, hh)
    rr = sqr(r)
    x3 = sub(sub(rr, hhh), add(v, v))
    y3 = sub(mul(r, sub(v, x3)), mul(s1, hhh))
    z3 = mul(mul(z1, z2), h)
    return x3, y3, z3, h, r


_H_OPS = (mont_mul_h, lambda u: mont_mul_h(u, u), add_h, sub_h)


def _pick(mask, a, b):
    return torch.where(mask.unsqueeze(0), a, b)


def jac_double_h(x, y, z):
    return jac_double_formula(x, y, z, *_H_OPS)


def jac_add_h(x1, y1, z1, x2, y2, z2):
    """Branch-free complete add: the core, the doubling arm, and the
    infinity masks selecting exactly as fq_T._jac_add_body."""
    x3, y3, z3, h, r = jac_add_core_formula(x1, y1, z1, x2, y2, z2, *_H_OPS)
    dx, dy, dz = jac_double_h(x1, y1, z1)
    inf1, inf2 = is_zero_h(z1), is_zero_h(z2)
    dbl_case = is_zero_h(h) & is_zero_h(r)

    def pick(gen, dbl, a1, a2):
        return _pick(inf1, a2, _pick(inf2, a1, _pick(dbl_case, dbl, gen)))

    return pick(x3, dx, x1, x2), pick(y3, dy, y1, y2), pick(z3, dz, z1, z2)


def jac_add_ladder_h(x1, y1, z1, x2, y2, z2):
    """INCOMPLETE ladder add (16 products, infinity masks, no doubling
    arm) — sound where P1 == P2 cannot occur (see fq_T)."""
    x3, y3, z3, _h, _r = jac_add_core_formula(x1, y1, z1, x2, y2, z2, *_H_OPS)
    inf1, inf2 = is_zero_h(z1), is_zero_h(z2)

    def pick(gen, a1, a2):
        return _pick(inf1, a2, _pick(inf2, a1, gen))

    return pick(x3, x1, x2), pick(y3, y1, y2), pick(z3, z1, z2)


# ---------------------------------------------------------------------------
# Plain versions on word tensors (any device)
# ---------------------------------------------------------------------------


def _pt_h(pt: torch.Tensor):
    h = to_half(pt.reshape(3, N_LIMBS, -1).transpose(0, 1))  # [24, 3, N]
    return h[:, 0], h[:, 1], h[:, 2]


def _pt_w(coords, like: torch.Tensor) -> torch.Tensor:
    return torch.stack([to_words(c) for c in coords]).reshape(like.shape)


def _fe_op(fn, *xs: torch.Tensor) -> torch.Tensor:
    """fn over [12, n...] word tensors through their [24, N] half form."""
    return to_words(fn(*(to_half(x.reshape(N_LIMBS, -1)) for x in xs))).reshape(xs[0].shape)


def fq_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _fe_op(mont_mul_h, a, b)


def fq_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p on [12, n...] words; plain PyTorch on any device."""
    return _fe_op(add_h, a, b)


def fq_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p on [12, n...] words; plain PyTorch on any device."""
    return _fe_op(sub_h, a, b)


def jac_double_plain(pt):
    return _pt_w(jac_double_h(*_pt_h(pt)), pt)


def jac_add_plain(p1, p2):
    return _pt_w(jac_add_h(*_pt_h(p1), *_pt_h(p2)), p1)


def jac_add_ladder_plain(p1, p2):
    return _pt_w(jac_add_ladder_h(*_pt_h(p1), *_pt_h(p2)), p1)


def jac_double_k_plain(pt, k: int):
    h = _pt_h(pt)
    for _ in range(k):
        h = jac_double_h(*h)
    return _pt_w(h, pt)


def window_step_plain(acc, sel1, sel2, k: int):
    h = _pt_h(acc)
    for _ in range(k):
        h = jac_double_h(*h)
    h = jac_add_ladder_h(*h, *_pt_h(sel1))
    return _pt_w(jac_add_ladder_h(*h, *_pt_h(sel2)), acc)


def jac_infinity(n: int, device) -> torch.Tensor:
    """[3, 12, n] infinity: x = y = Montgomery one, z = 0."""
    one = consts(torch.device(device)).one_w[:, None].expand(N_LIMBS, n)
    return torch.stack([one, one, torch.zeros_like(one)])


def _table_plain(points: torch.Tensor) -> torch.Tensor:
    """[3, 12, n] -> [16, 3, 12, n]: entry i is i*P (infinity, P, then 14
    chained complete adds)."""
    tbl = [jac_infinity(points.shape[-1], points.device), points]
    for _ in range(TABLE_SIZE - 2):
        tbl.append(jac_add_plain(tbl[-1], points))
    return torch.stack(tbl)


def _gather(table: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """[16, 3, 12, n] table x [n] digits -> [3, 12, n]: lane l's table[digits[l]]."""
    n = table.shape[-1]
    idx = (digits.to(torch.int64) & (TABLE_SIZE - 1)).view(1, 1, 1, n)
    return table.gather(0, idx.expand(1, 3, N_LIMBS, n))[0]


def glv_ladder_plain(points: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """fq_T.glv_ladder_T: [3, 12, n] points x [2, w, n] GLV digits, MSB
    first -> [3, 12, n]: the table T1[i] = i*P, its beta-twisted copy T2,
    then per window 4 doublings and the complete adds of T1[k1 digit] and
    T2[k2 digit], from infinity."""
    t1 = _table_plain(points)
    beta = torch.as_tensor(BETA_MONT, device=points.device)[:, None]  # one element
    t2 = t1.clone()
    t2[:, 0] = fq_mul_plain(t1[:, 0].transpose(0, 1).contiguous(), beta).transpose(0, 1)
    acc = jac_infinity(points.shape[-1], points.device)
    for j in range(digits.shape[1]):
        acc = jac_double_k_plain(acc, 4)
        acc = jac_add_plain(acc, _gather(t1, digits[0, j]))
        acc = jac_add_plain(acc, _gather(t2, digits[1, j]))
    return acc


def windowed_ladder_plain(points: torch.Tensor, windows: torch.Tensor) -> torch.Tensor:
    """fq_T.windowed_ladder_T: [3, 12, n] points x [w, n] 4-bit digits,
    MSB first -> [3, 12, n]: the table, then per window 4 doublings and a
    complete add of the entry the digit names, from infinity."""
    table = _table_plain(points)
    acc = jac_infinity(points.shape[-1], points.device)
    for j in range(windows.shape[0]):
        acc = jac_double_k_plain(acc, 4)
        acc = jac_add_plain(acc, _gather(table, windows[j]))
    return acc


# ---------------------------------------------------------------------------
# The kernel's wrappers
# ---------------------------------------------------------------------------


def _check(x: torch.Tensor, lead: tuple, what: str) -> None:
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int32:
        raise TypeError(f"{what}: expected an int32 tensor")
    if tuple(x.shape[: len(lead)]) != lead or x.dim() < len(lead) + 1:
        raise ValueError(f"{what}: expected [{', '.join(map(str, lead))}, n...], got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu tensors, not {x.device}")


def _launch(kind: int, k: int, label: str, ins, lead: tuple, const=None, digits=None,
            scratch_elements: int = 0) -> torch.Tensor:
    """One csrc/fq_point.cu launch over the lanes of `ins` (all on one
    card, same shape), with `const` (one [12, 1...] element: KIND_MULC's
    operand, the GLV ladder's beta) after them; a ladder also takes its
    digits and a [16, scratch_elements, 12, n] table scratch, allocated
    here for the kernel's own use.  Returns the [*lead, n...] result."""
    global launches
    dev = ins[0].device
    if any(x.device != dev or x.shape != ins[0].shape for x in ins):
        raise ValueError("fq_point: operands must share one device and one shape")
    flat = [x.contiguous() for x in ins]
    if const is not None:
        if const.device != dev:
            raise ValueError("fq_point: operands must share one device")
        flat.append(const.reshape(N_LIMBS).contiguous())
    if digits is not None:
        if digits.device != dev:
            raise ValueError("fq_point: operands must share one device")
        digits = digits.contiguous()
    out = torch.empty_like(flat[0])
    n = flat[0][(0,) * len(lead)].numel()
    if n:
        from . import point_block  # its recorder imports this module's formulas

        prog = point_block.programs(1)
        words = point_block.words_on(1, dev)
        table = (torch.empty((TABLE_SIZE, scratch_elements, N_LIMBS, n), dtype=torch.int32,
                             device=dev) if scratch_elements else None)
        lib = _kernels.load("fq_point")
        ptrs = [x.data_ptr() for x in flat] + [0] * (3 - len(flat))
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fq_point_launch(
            dev.index, kind, k, words.data_ptr(), int(words.numel()), prog.smem,
            prog.dbl_warps if kind in (KIND_DBL, KIND_DBLK) else prog.warps,
            *ptrs, 0 if digits is None else digits.data_ptr(),
            0 if digits is None else digits.shape[-2], 0 if table is None else table.data_ptr(),
            out.data_ptr(), n, stream)
        _kernels.check("fq_point", lib, rc, "fq_point_error_string")
        launches += 1
        launches_by_kind[label] = launches_by_kind.get(label, 0) + 1
    return out


def fq_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[12, n...] x [12, n...] -> Montgomery product a*b/R mod p.  b may
    also be one element [12, 1...] for every lane: the kernel then reads
    those 12 words, never a copy per lane."""
    _check(a, (N_LIMBS,), "fq_mul")
    _check(b, (N_LIMBS,), "fq_mul")
    if a.device.type == "cuda":
        if b[0].numel() == 1 and a[0].numel() != 1:
            return _launch(KIND_MULC, 0, "mul", (a,), (N_LIMBS,), const=b)
        return _launch(KIND_MUL, 0, "mul", (a, b), (N_LIMBS,))
    return fq_mul_plain(a, b)


def jac_double(pt: torch.Tensor) -> torch.Tensor:
    """[3, 12, n...] -> the doubled points."""
    _check(pt, (3, N_LIMBS), "jac_double")
    if pt.device.type == "cuda":
        return _launch(KIND_DBL, 1, "dbl", (pt,), (3, N_LIMBS))
    return jac_double_plain(pt)


def jac_add(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Complete Jacobian add (infinity on either side, P + P, P + (-P))."""
    _check(p1, (3, N_LIMBS), "jac_add")
    _check(p2, (3, N_LIMBS), "jac_add")
    if p1.device.type == "cuda":
        return _launch(KIND_ADD, 0, "add", (p1, p2), (3, N_LIMBS))
    return jac_add_plain(p1, p2)


def jac_add_ladder(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Incomplete ladder add (16 products; no doubling arm)."""
    _check(p1, (3, N_LIMBS), "jac_add_ladder")
    _check(p2, (3, N_LIMBS), "jac_add_ladder")
    if p1.device.type == "cuda":
        return _launch(KIND_LADD, 0, "ladd", (p1, p2), (3, N_LIMBS))
    return jac_add_ladder_plain(p1, p2)


def jac_double_k(pt: torch.Tensor, k: int) -> torch.Tensor:
    """k successive doublings in one launch."""
    _check(pt, (3, N_LIMBS), "jac_double_k")
    if pt.device.type == "cuda":
        return _launch(KIND_DBLK, k, f"dblk{k}", (pt,), (3, N_LIMBS))
    return jac_double_k_plain(pt, k)


def window_step(acc, sel1, sel2, k: int) -> torch.Tensor:
    """One GLV dual-table window: k doublings + two ladder adds."""
    for x in (acc, sel1, sel2):
        _check(x, (3, N_LIMBS), "window_step")
    if acc.device.type == "cuda":
        return _launch(KIND_WIN, k, f"win{k}", (acc, sel1, sel2), (3, N_LIMBS))
    return window_step_plain(acc, sel1, sel2, k)


def _check_digits(digits: torch.Tensor, lead: tuple, n: int, what: str) -> None:
    if not isinstance(digits, torch.Tensor) or digits.dtype != torch.int32:
        raise TypeError(f"{what}: expected int32 digits")
    if digits.dim() != len(lead) + 2 or tuple(digits.shape[: len(lead)]) != lead \
            or digits.shape[-1] != n:
        raise ValueError(f"{what}: digits must be [{', '.join(map(str, lead + ('w',)))}, {n}], "
                         f"got {tuple(digits.shape)}")


def glv_ladder(points: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """The GLV ladder in one launch: [3, 12, n] points x [2, w, n] int32
    GLV digits, MSB first (each read & 15) -> [3, 12, n]."""
    _check(points, (3, N_LIMBS), "glv_ladder")
    _check_digits(digits, (2,), points.shape[-1], "glv_ladder")
    if points.device.type == "cuda":
        beta = torch.as_tensor(BETA_MONT, device=points.device)
        return _launch(KIND_GLV_LADDER, 0, "glv_ladder", (points,), (3, N_LIMBS), const=beta,
                       digits=digits, scratch_elements=4)
    return glv_ladder_plain(points, digits)


def windowed_ladder(points: torch.Tensor, windows: torch.Tensor) -> torch.Tensor:
    """The single-table ladder in one launch: [3, 12, n] points x [w, n]
    int32 4-bit digits, MSB first (each read & 15) -> [3, 12, n]."""
    _check(points, (3, N_LIMBS), "windowed_ladder")
    _check_digits(windows, (), points.shape[-1], "windowed_ladder")
    if points.device.type == "cuda":
        return _launch(KIND_WINDOWED_LADDER, 0, "windowed_ladder", (points,), (3, N_LIMBS),
                       digits=windows, scratch_elements=3)
    return windowed_ladder_plain(points, windows)


# The entries as (name -> (kernel wrapper, plain version)); an engine
# picks one column (PointOps) and chip_smoke holds one against the other.
ENTRIES = {
    "mul": (fq_mul, fq_mul_plain),
    "dbl": (jac_double, jac_double_plain),
    "add": (jac_add, jac_add_plain),
    "ladd": (jac_add_ladder, jac_add_ladder_plain),
    "dblk": (jac_double_k, jac_double_k_plain),
    "win": (window_step, window_step_plain),
    "glv_ladder": (glv_ladder, glv_ladder_plain),
    "windowed_ladder": (windowed_ladder, windowed_ladder_plain),
}


class PointOps:
    """The B2 entries an engine calls: the kernels' wrappers, or their
    plain versions on any device (use_kernel=False)."""

    def __init__(self, use_kernel: bool):
        col = 0 if use_kernel else 1
        e = ENTRIES
        self.mul, self.dbl = e["mul"][col], e["dbl"][col]
        self.add, self.ladd = e["add"][col], e["ladd"][col]
        self.dblk, self.win = e["dblk"][col], e["win"][col]
        self.glv_ladder = e["glv_ladder"][col]
        self.use_kernel = use_kernel
