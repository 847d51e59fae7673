"""Kernels B2 and B4's layered point programs (ops/point_block), on the CPU.

csrc/point_block.cuh has no CPU mode, so its programs are held here
through `Block`, a plain interpreter of what a block does: the program
set's words (offset table, headers, layers, rows, output slots), the
slots (the accumulator in 0 .. K-1, operand region t above it), a layer's
products written after the layer's reads (a program never writes a slot
its own layer reads: the property test below checks that on random
recorded circuits), the complete add's per-lane selects in fq_T's order
with the doubling arm run only when some lane needs it, and the ladders'
tables in a scratch read back through per-lane gathers.  The entries are
held against the plain versions (ops/fq_torch, ops/fq2_torch) here;
tests/test_torch_fq.py and tests/test_torch_g2.py hold the programs
against the JAX package's point ops, and tests/test_torch_g2.py and
tests/test_torch_decrypt.py hold `block_ladder` against the plain G2 and
GLV ladders (beside their own plain-ladder tests, to share the cost).  Also: the launch
plans of a coin round and a decrypt round."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from hydrabadger_tpu_torch.crypto import bls12_381 as bls
from hydrabadger_tpu_torch.ops import bls_g2_torch as g2
from hydrabadger_tpu_torch.ops import bls_torch, circuit_torch as ct, limbs
from hydrabadger_tpu_torch.ops import fq2_torch as f2
from hydrabadger_tpu_torch.ops import fq_torch as fq
from hydrabadger_tpu_torch.ops import point_block as pb
from hydrabadger_tpu_torch.ops.fp12_circuit import Circuit
from test_torch_circuit import _check_slots, recorded_circuits

DBL, DBLK4, ARM, ADD = range(4)  # csrc/point_block.cuh's Prog
P = bls.P


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# The interpreter
# ---------------------------------------------------------------------------


def _row(prog, pc):
    """The row at pc: ({slot: coeff}, negsum) and the pc after it."""
    k, negsum = prog[pc], prog[pc + 1]
    body = prog[pc + 2 : pc + 2 + 2 * k]
    terms = dict(zip(body[::2], body[1::2]))
    assert min(terms, default=0) >= 0, "a point program has no constants"
    assert negsum == sum(-c for c in terms.values() if c < 0)
    return terms, pc + 2 + 2 * k


def _mat(rows, n_slots):
    m = torch.zeros((len(rows), n_slots), dtype=torch.float64)
    for i, terms in enumerate(rows):
        for s, c in terms.items():
            m[i, s] = c
    return m, torch.as_tensor(ct._negsum(m.numpy().astype(np.int64)))


def _decode(prog, n_slots):
    """One program -> ([(dest slots, left+right mix matrix, negsums)] per
    layer, (output slots, output matrix, negsums))."""
    n_in, n_layers, n_out, n_prod = prog[: ct.HEADER]
    layer_start = prog[ct.HEADER : ct.HEADER + n_layers + 1]
    prod_pc = prog[ct.HEADER + n_layers + 1 : ct.HEADER + n_layers + 1 + n_prod]
    out_pc = prog[ct.HEADER + n_layers + 1 + n_prod : ct.HEADER + n_layers + 1 + n_prod + n_out]
    layers = []
    for lay in range(n_layers):
        dests, lefts, rights = [], [], []
        for j in range(layer_start[lay], layer_start[lay + 1]):
            pc = prod_pc[j]
            dests.append(prog[pc])
            left, pc = _row(prog, pc + 1)
            right, _ = _row(prog, pc)
            lefts.append(left)
            rights.append(right)
        layers.append((dests, *_mat(lefts + rights, n_slots)))
    outs = [prog[pc] for pc in out_pc]
    return n_in, layers, (outs, *_mat([_row(prog, pc + 1)[0] for pc in out_pc], n_slots))


class Block:
    """What one block of csrc/point_block.cuh does, over n lanes at once."""

    def __init__(self, c: int, n: int):
        self.c, self.k, self.n = c, 3 * c, n
        sp = pb.programs(c)
        w = sp.words.tolist()
        self.progs = [_decode(w[w[1 + i]:], sp.n_slots) for i in range(w[0])]
        # every slot as canonical 16-bit digits; -1: never written
        self.slots = torch.full((fq.N_HALF, sp.n_slots, n), -1, dtype=torch.int64)

    def put(self, first: int, pt: torch.Tensor) -> None:
        """Slots first .. first+K-1 <- a [K, 12, n] word batch."""
        self.slots[:, first : first + pt.shape[0]] = fq.to_half(pt.transpose(0, 1))

    def get(self, first: int) -> torch.Tensor:
        return fq.to_words(self.slots[:, first : first + self.k]).transpose(0, 1).contiguous()

    def run(self, i: int) -> list:
        """Program i's layers, then its outputs; returns its output slots."""
        _, layers, (outs, t_mat, t_neg) = self.progs[i]
        for dests, m, neg in layers:
            assert min(dests) >= self.progs[i][0], "a program wrote one of its kept inputs"
            v = ct._mix(m, neg, self.slots.to(torch.float64))
            half = len(dests)
            prod = fq.mont_mul_h(v[:, :half].reshape(fq.N_HALF, -1), v[:, half:].reshape(fq.N_HALF, -1))
            self.slots[:, dests] = prod.reshape(fq.N_HALF, half, self.n)
        self.slots[:, outs] = ct._mix(t_mat, t_neg, self.slots.to(torch.float64))
        return outs

    def doublings(self, k: int) -> None:
        while k > 0:
            outs = self.run(DBLK4 if k >= 4 else DBL)
            self.slots[:, : self.k] = self.slots[:, outs[: self.k]]
            k -= 4 if k >= 4 else 1

    def _zero(self, first: int, count: int) -> torch.Tensor:
        return (self.slots[:, first : first + count] == 0).all(0).all(0)

    def add(self, t: int, complete: bool) -> None:
        op, c, k = self.k * (1 + t), self.c, self.k
        outs = self.run(ADD + t)
        inf1, inf2 = self._zero(2 * c, c), self._zero(op + 2 * c, c)
        hr0 = (self.slots[:, outs[k : k + 2 * c]] == 0).all(0).all(0)
        dbl = complete & hr0 & ~inf1 & ~inf2
        arm = self.run(ARM) if bool(dbl.any()) else outs  # only when some lane needs it
        for e in range(k):
            pick = torch.where(inf1, op + e, torch.where(inf2, e, torch.where(
                dbl, arm[e], outs[e])))
            self.slots[:, e] = self.slots[:, pick, torch.arange(self.n)]

    def infinity(self) -> None:
        inf = fq.jac_infinity(self.n, "cpu") if self.c == 1 else f2.g2_infinity(self.n, "cpu")
        self.put(0, inf.reshape(self.k, limbs.N_LIMBS, self.n))

    def build_table(self, kt: int) -> torch.Tensor:
        """The table of the point in operand region 0: [16, kt, 12, n]."""
        table = torch.zeros((16, kt, limbs.N_LIMBS, self.n), dtype=torch.int32)
        self.slots[:, : self.k] = self.slots[:, self.k : 2 * self.k]
        self.infinity()
        table[0, : self.k] = self.get(0)
        self.slots[:, : self.k] = self.slots[:, self.k : 2 * self.k]
        table[1, : self.k] = self.get(0)
        for i in range(2, 16):
            self.add(0, True)
            table[i, : self.k] = self.get(0)
        return table

    def fetch(self, first: int, table: torch.Tensor, digits: torch.Tensor, x_elem: int = 0):
        elems = [x_elem] + list(range(1, self.k))
        idx = (digits.to(torch.int64) & 15)[None, None, None].expand(1, self.k, limbs.N_LIMBS, self.n)
        self.put(first, table[:, elems].gather(0, idx)[0])


def _flat(pt: torch.Tensor) -> torch.Tensor:
    return pt.reshape(-1, limbs.N_LIMBS, pt.shape[-1])


def block_entry(c: int, entry: str, a, b=None, third=None, k: int = 0):
    """An entry of fq_point.cu (c = 1) or fq2_point.cu (c = 2) as a block
    runs it: dbl/dblk (k), add, ladd, win (k, b and third), table, step
    (b: the table, third: the digits)."""
    blk = Block(c, a.shape[-1])
    if entry == "table":
        blk.put(blk.k, _flat(a))
        return blk.build_table(blk.k).reshape(16, *a.shape)
    blk.put(0, _flat(a))
    if entry in ("dbl", "dblk"):
        blk.doublings(k)
    elif entry in ("add", "ladd"):
        blk.put(blk.k, _flat(b))
        blk.add(0, entry == "add")
    elif entry == "win":
        blk.put(blk.k, _flat(b))
        blk.put(2 * blk.k, _flat(third))
        blk.doublings(k)
        blk.add(0, False)
        blk.add(1, False)
    elif entry == "step":
        blk.fetch(blk.k, b.reshape(16, blk.k, limbs.N_LIMBS, -1), third)
        blk.doublings(4)
        blk.add(0, True)
    return blk.get(0).reshape(a.shape)


def block_ladder(c: int, points: torch.Tensor, digits: torch.Tensor, glv: bool = False):
    """fq2_point.cu's `ladder` (c = 2), fq_point.cu's `windowed_ladder`
    (c = 1) or `glv_ladder` (c = 1, glv)."""
    blk = Block(c, points.shape[-1])
    blk.put(blk.k, _flat(points))
    table = blk.build_table(4 if glv else blk.k)
    if glv:
        beta = torch.as_tensor(limbs.BETA_MONT)[:, None]
        table[:, 3] = fq.fq_mul_plain(table[:, 0].transpose(0, 1).contiguous(), beta).transpose(0, 1)
    blk.infinity()
    rows = [digits] if not glv else [digits[0], digits[1]]
    for j in range(rows[0].shape[0]):
        for t, r in enumerate(rows):
            blk.fetch(blk.k * (1 + t), table, r[j], 3 if t else 0)
        blk.doublings(4)
        for t in range(len(rows)):
            blk.add(t, True)
    return blk.get(0).reshape(points.shape)


# ---------------------------------------------------------------------------
# Operands: edge lanes, and the values p - 1 and 0
# ---------------------------------------------------------------------------


def g1_lanes():
    """Two [3, 12, 8] batches: P + (-P), P + P, infinity + Q, P +
    infinity, infinity + infinity, and three lanes of raw coordinates p - 1
    and 0 (the formulas take any field values)."""
    a = [bls.multiply(bls.G1, k) for k in (11, 13, 17, 19, 23)]
    b = [bls.neg(a[0]), a[1], bls.multiply(bls.G1, 29), bls.infinity(), bls.infinity()]
    a[2] = a[4] = bls.infinity()
    p1 = fq.jac_double_plain(torch.from_numpy(limbs.points_to_limbs(a)))
    p2 = fq.jac_double_plain(torch.from_numpy(limbs.points_to_limbs(b)))
    raw = [[P - 1, 0, P - 1], [0, P - 1, 1], [P - 1, P - 1, P - 1]]
    r1 = torch.from_numpy(limbs.ints_to_limbs_batch([v for row in raw for v in row]))
    r2 = torch.from_numpy(limbs.ints_to_limbs_batch([v for row in raw[::-1] for v in row]))
    r1, r2 = (r.reshape(3, 3, limbs.N_LIMBS).permute(1, 2, 0) for r in (r1, r2))  # [3, 12, 3]
    return torch.cat([p1, r1], -1), torch.cat([p2, r2], -1)


def g2_lanes():
    """Two [3, 2, 12, 7] batches: P + P, P + (-P), infinity + Q, P +
    infinity, and three lanes of raw coordinates p - 1 and 0."""
    h = [bls.hash_to_g2(b"block-%d" % i) for i in range(3)]
    a = [h[0], h[1], bls.infinity(bls.FQ2), h[2]]
    b = [h[0], bls.neg(h[1]), h[2], bls.infinity(bls.FQ2)]
    p1 = f2.g2_double_plain(torch.from_numpy(limbs.g2_points_to_limbs(a)))
    p2 = f2.g2_double_plain(torch.from_numpy(limbs.g2_points_to_limbs(b)))
    vals = [P - 1, 0, 1, P - 1, P - 1, 0, 0, P - 1, P - 1, P - 1, 5, P - 1]
    r = torch.from_numpy(limbs.ints_to_limbs_batch(vals[:6])).reshape(3, 2, limbs.N_LIMBS, 1)
    s = torch.from_numpy(limbs.ints_to_limbs_batch(vals[6:])).reshape(3, 2, limbs.N_LIMBS, 1)
    raw1 = torch.cat([r, s, r.flip(0)], -1)
    raw2 = torch.cat([s, s.flip(1), r], -1)
    return torch.cat([p1, raw1], -1), torch.cat([p2, raw2], -1)


# ---------------------------------------------------------------------------
# The program sets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c", [1, 2])
def test_program_sets_keep_what_the_kernel_needs(c):
    """Every program keeps the accumulator and the operand regions; the arm
    keeps every slot an add's outputs use; T, slots and shared memory fit."""
    sp = pb.programs(c)
    k, n_fixed = 3 * c, 3 * c * (1 + pb.OPERANDS[c])
    w = sp.words.tolist()
    assert w[0] == len(sp.programs) == 3 + pb.OPERANDS[c]
    for i, (circ, prog) in enumerate(zip(sp.circuits, sp.programs)):
        assert w[w[1 + i] : w[1 + i] + len(prog.words)] == prog.words.tolist()
        written = _written(prog.words.tolist())
        assert circ.n_inputs >= n_fixed
        assert min(written) >= circ.n_inputs and max(written) < sp.n_slots
        _check_slots(circ, prog)
    adds = sp.programs[ADD:]
    assert sp.circuits[ARM].n_inputs == max(p.n_slots_chain for p in adds)
    assert [circ.n_outputs for circ in sp.circuits[ADD:]] == [5 * c] * len(adds)
    assert sp.warps == min(ct.MAX_WARPS, max(max(circ.n_lanes) for circ in sp.circuits))
    assert sp.dbl_warps == max(max(circ.n_lanes) for circ in sp.circuits[:ARM])
    assert (sp.warps, sp.dbl_warps, sp.n_slots) == {1: (5, 3, 33), 2: (8, 7, 71)}[c]
    assert sp.smem <= ct.SMEM_LIMIT
    layers = [len(circ.n_lanes) for circ in sp.circuits]
    assert layers == [3, 12, 3] + [5] * pb.OPERANDS[c]
    products = [sum(circ.n_lanes) for circ in sp.circuits]
    assert products == {1: [7, 28, 7, 16, 16], 2: [16, 64, 16, 44]}[c]
    assert products[ADD] == (f2.GENERAL_ADD_PRODUCTS if c == 2 else bls_torch.GENERAL_ADD_PRODUCTS)
    with pb.warps(c, 4):
        assert pb.programs(c).warps == pb.programs(c).dbl_warps == 4
    assert pb.programs(c).warps == sp.warps
    with pytest.raises(ValueError):
        with pb.warps(c, ct.MAX_WARPS + 1):
            pass


@settings(max_examples=40, deadline=None)
@given(recorded_circuits(), st.integers(0, 6))
def test_no_slot_is_overwritten_while_its_wire_is_live_with_kept_inputs(circ, extra):
    """slot_program(keep_inputs=True) on random recorded circuits, some
    with kept inputs that no row reads: the liveness walk of
    tests/test_torch_circuit.py holds, and nothing is ever written below
    n_inputs."""
    if extra:
        circ = _with_spare_inputs(circ, extra)
    sp = ct.slot_program(circ, keep_inputs=True)
    _check_slots(circ, sp)
    assert min(_written(sp.words.tolist()), default=circ.n_inputs) >= circ.n_inputs


def _written(prog):
    """Every slot a program writes: its products' and its outputs' slots."""
    n_layers, n_out, n_prod = prog[1:4]
    tables = prog[ct.HEADER + n_layers + 1 :]
    return [prog[pc] for pc in tables[: n_prod + n_out]]


def _with_spare_inputs(circ, extra):
    """The same circuit with `extra` more inputs that nothing reads."""
    shift = lambda m: np.insert(m, [circ.n_inputs] * extra, 0, axis=1)  # noqa: E731
    out = Circuit.__new__(Circuit)
    out.n_inputs = circ.n_inputs + extra
    out.const_vals = circ.const_vals
    out.mats = [(shift(sl), shift(sr)) for sl, sr in circ.mats]
    out.T = shift(circ.T)
    out.n_outputs, out.n_lanes = circ.n_outputs, circ.n_lanes
    return out


# ---------------------------------------------------------------------------
# The entries and ladders against the plain versions
# ---------------------------------------------------------------------------


def test_interpreted_g1_entries_equal_plain():
    a, b = g1_lanes()
    c = a.roll(3, -1)
    cases = {
        "dbl": (fq.jac_double_plain(a), dict(k=1)),
        "dblk": (fq.jac_double_k_plain(a, 6), dict(k=6)),
        "add": (fq.jac_add_plain(a, b), dict(b=b)),
        "ladd": (fq.jac_add_ladder_plain(a, b), dict(b=b)),
        "win": (fq.window_step_plain(a, b, c, 5), dict(b=b, third=c, k=5)),
    }
    for entry, (want, kw) in cases.items():
        assert torch.equal(block_entry(1, entry, a, **kw), want), entry


def test_interpreted_g2_entries_equal_plain():
    a, b = g2_lanes()
    assert torch.equal(block_entry(2, "add", a, b), f2.g2_add_plain(a, b))
    assert torch.equal(block_entry(2, "table", a), f2.g2_table_plain(a))
    acc16 = b
    for _ in range(4):
        acc16 = f2.g2_double_plain(acc16)
    base = a.clone()
    base[..., 0] = acc16[..., 0]  # the doubled accumulator equals its entry
    table = f2.g2_table_plain(base)
    digits = torch.tensor([1, 0, 3, 15, 1, 2, 0], dtype=torch.int32)
    got = block_entry(2, "step", b, table, digits)
    assert torch.equal(got, f2.g2_window_step_plain(b, table, digits))


def test_ladder_wrappers_check_their_digits():
    pts = fq.jac_infinity(3, "cpu")
    with pytest.raises(TypeError):
        fq.glv_ladder(pts, torch.zeros((2, 33, 3), dtype=torch.int64))
    with pytest.raises(ValueError):
        fq.windowed_ladder(pts, torch.zeros((64, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        f2.g2_ladder(f2.g2_infinity(3, "cpu"), torch.zeros((64,), dtype=torch.int32))
    zero = fq.windowed_ladder(pts, torch.zeros((2, 3), dtype=torch.int32))
    assert torch.equal(zero[2], pts[2])  # scalar 0: still at infinity


# ---------------------------------------------------------------------------
# Launch plans
# ---------------------------------------------------------------------------


def test_launch_plans_give_seven_launches_per_round():
    """A coin round (4096 signature shares, 64 combines of 22) and a
    decrypt round (4096 decryption shares, 64 combines of 22) each launch
    one ladder per batch and one add per tree level: 7 launches."""
    rng = np.random.default_rng(7)
    ks = [int.from_bytes(rng.bytes(32), "little") % bls.R for _ in range(4096)]
    coeffs = ks[: 22 * 64]
    coin = g2.scalar_mul_plan(g2.scalars_to_windows(ks)) + g2.weighted_sum_plan(
        g2.scalars_to_windows(coeffs), 22)
    dec = bls_torch.glv_plan(bls_torch.glv_windows(ks)) + bls_torch.weighted_sum_plan(
        g2.scalars_to_windows(coeffs), 22)
    assert bls_torch.launch_counts(coin) == {"ladder": 2, "add": 5}
    assert bls_torch.launch_counts(dec) == {"glv_ladder": 1, "windowed_ladder": 1, "add": 5}
    assert [r.lanes for r in coin] == [4096, 1408, 704, 320, 192, 64, 64]
    for plan, per_window in ((coin, f2.DOUBLINGS * f2.DBL_PRODUCTS + f2.GENERAL_ADD_PRODUCTS),
                             (dec, 4 * bls_torch.DBL_PRODUCTS + bls_torch.GENERAL_ADD_PRODUCTS)):
        ladder = plan[0] if plan is coin else plan[1]
        # random 256-bit digits: nearly every window doubles and adds
        assert 0.9 < ladder.products / (ladder.lanes * 64 * per_window) < 1.1
        ops_ms, bytes_ms = ladder.bound()
        assert ops_ms > bytes_ms > 0
