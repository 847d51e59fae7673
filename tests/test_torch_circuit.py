"""The port's circuit recorder and B3 executor against the JAX package:
the three decrypt circuits record the same matrices as ops/fp12_circuit,
and ops/circuit_torch's plain executor equals circuit_T.CircuitT limb for
limb at B = 4, plus the round-3 signed-mix regression vector of
tests/test_circuit_T.py.

Kernel B3 (csrc/circuit.cu) has no CPU mode, so its slotted int32 program
is held here through `_run_program` / `_run_chain`, a plain interpreter
that walks exactly what the kernel reads: the header and offset tables,
the slots (inputs in 0 .. n_inputs-1, products into their dest slots),
the layers warp by warp (warp t runs products t, t + T, ... and writes at
once, as a warp may before another warp of its layer reads), the
constant refs, and for the chain the entry loads, output slots and
copies.  It is held against `CircuitExec.plain`, `circuit_T.CircuitT`
and the per-circuit Straus loop; a property test checks on random
recorded circuits that no slot is overwritten while its wire is live."""
from functools import lru_cache

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from hydrabadger_tpu.ops import decrypt_T as jdt
from hydrabadger_tpu_torch.crypto import bls12_381 as bls
from hydrabadger_tpu_torch.ops import decrypt_torch as dt
from hydrabadger_tpu_torch.ops import fq_torch as fq
from hydrabadger_tpu_torch.ops import circuit_torch as ct
from hydrabadger_tpu_torch.ops import limbs
from hydrabadger_tpu_torch.ops.circuit_torch import CircuitExec
from hydrabadger_tpu_torch.ops.fp12_circuit import CircuitBuilder
from hydrabadger_tpu_torch.sim import tensor as ts

P = bls.P

CIRCUITS = {
    "dblk6_add": (lambda: dt._dblk_add_circuit(6), lambda: jdt._dblk_add_circuit(6)),
    "add": (dt._add_circuit, jdt._add_circuit),
    "dblk4_add": (lambda: dt._dblk_add_circuit(4), lambda: jdt._dblk_add_circuit(4)),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_recorder_copy_gives_the_same_matrices(name):
    mine, theirs = (f().circ for f in CIRCUITS[name])
    assert mine.n_inputs == theirs.n_inputs and mine.n_outputs == theirs.n_outputs
    assert mine.n_lanes == theirs.n_lanes
    assert len(mine.mats) == len(theirs.mats)
    for (ml, mr), (tl, tr) in zip(mine.mats, theirs.mats):
        assert np.array_equal(ml, tl) and np.array_equal(mr, tr)
    assert np.array_equal(mine.T, theirs.T)
    assert mine.const_vals.shape[0] == theirs.const_vals.shape[0] == 0


def _inputs(b=4):
    """[6, 12, b]: two non-normalised point batches, lane 1 equal points."""
    a = [bls.multiply(bls.G1, k) for k in range(31, 31 + b)]
    c = [bls.multiply(bls.G1, k) for k in range(71, 71 + b)]
    c[1] = a[1]
    x = torch.from_numpy(np.concatenate([limbs.points_to_limbs(a), limbs.points_to_limbs(c)]))
    return torch.cat([fq.jac_double_plain(x[:3]), fq.jac_double_plain(x[3:])])


@lru_cache(maxsize=None)
def _circuit_T_out(name):
    """circuit_T.CircuitT's outputs on `_inputs()`, as port words (one XLA
    compile per circuit, shared by the tests below)."""
    mine, theirs = (f() for f in CIRCUITS[name])
    x = _inputs()
    b = x.shape[-1]
    xj = limbs.jax_limbs_from_words(x.numpy().transpose(0, 2, 1))  # [6, b, 32]
    xj = np.ascontiguousarray(xj.transpose(0, 2, 1).reshape(6 * 32, b))
    want = np.asarray(theirs(jnp.asarray(xj))).reshape(mine.n_outputs, 32, b)
    return limbs.words_from_jax_limbs(want.transpose(0, 2, 1)).transpose(0, 2, 1)


@pytest.mark.parametrize("name", ["add", "dblk4_add"])
def test_plain_executor_equals_circuit_T(name):
    mine = CIRCUITS[name][0]()
    got = mine(_inputs())  # a CPU tensor: the plain executor
    assert np.array_equal(got.numpy(), _circuit_T_out(name))


def _signed_mix():
    """tests/test_circuit_T.py's crafted -1-deficit vector (one output row
    [1, -3], no layers) and a row mix with a constant, a negative select
    and a zero row: (circuit, x [2, 12, 1], the outputs as integers)."""
    mask = 4095
    kp = [(4 * P >> (12 * i)) & mask for i in range(35)]
    t = np.zeros(32, np.int64)
    t[2] = -4096 - kp[2]
    t[3], t[4], t[5] = -kp[3], -kp[4], -kp[5]
    x0 = np.zeros(32, np.int64)
    x1 = np.zeros(32, np.int64)
    for j in range(32):
        tj = int(t[j])
        x0[j] = (3 - (-tj) % 3) % 3
        x1[j] = (x0[j] - tj) // 3
    v0 = sum(int(x0[i]) << (12 * i) for i in range(32))
    v1 = sum(int(x1[i]) << (12 * i) for i in range(32))
    b = CircuitBuilder(2)
    i0, i1 = b.input(0), b.input(1)
    k = b.const(12345)
    circ = CircuitExec(b.compile([i0 - i1 - i1 - i1, -i1, i0 * k - i1 * i1, b.zero()]), "mix")
    assert np.array_equal(circ.circ.T[0, :2], [1, -3])
    x = torch.from_numpy(limbs.ints_to_limbs_batch([v0, v1]))[:, :, None]
    rinv = pow(limbs.R_MONT, -1, P)
    return circ, x, [(v0 - 3 * v1) % P, (-v1) % P, (v0 * 12345 - v1 * v1) * rinv % P, 0]


def test_signed_mix_regression_vector():
    """tests/test_circuit_T.py's crafted -1-deficit vector, through the
    port's mix (one output row [1, -3], no layers), and a row mix with a
    constant, a negative select and a zero row."""
    circ, x, want = _signed_mix()
    got = limbs.limbs_to_ints_batch(circ(x)[:, :, 0].numpy())
    assert got == want


# ---------------------------------------------------------------------------
# Kernel B3's slotted program, through a plain interpreter of what it reads
# ---------------------------------------------------------------------------


def _header(prog):
    """(n_inputs, n_layers, n_outputs, layer_start, prod_pc, out_pc)."""
    n_in, n_layers, n_out, n_products = prog[: ct.HEADER]
    at = ct.HEADER
    layer_start = prog[at : at + n_layers + 1]
    prod_pc = prog[at + n_layers + 1 : at + n_layers + 1 + n_products]
    out_pc = prog[at + n_layers + 1 + n_products : at + n_layers + 1 + n_products + n_out]
    return n_in, n_layers, n_out, layer_start, prod_pc, out_pc


def _terms(prog, pc):
    """The row at pc: (negsum, [(ref, coeff), ...]), and the pc after it."""
    k = prog[pc]
    body = prog[pc + 2 : pc + 2 + 2 * k]
    return prog[pc + 1], list(zip(body[::2], body[1::2])), pc + 2 + 2 * k


def _eval_row(prog, pc, slots, consts):
    """A row over the slots ([n_slots, 12, n] words) and the constants
    ([n_const, 12]) -> [12, n] canonical words."""
    negsum, terms, _ = _terms(prog, pc)
    n = slots.shape[-1]
    if not terms:
        return torch.zeros((12, n), dtype=torch.int32)
    vals = torch.stack([slots[r] if r >= 0 else consts[-1 - r][:, None].expand(12, n)
                        for r, _ in terms])  # [k, 12, n]
    m = torch.tensor([[c for _, c in terms]], dtype=torch.float64)
    assert negsum == sum(-c for _, c in terms if c < 0)
    v = ct._mix(m, torch.tensor([negsum]), fq.to_half(vals.transpose(0, 1)).to(torch.float64))
    return fq.to_words(v[:, 0])


def _run_layers(prog, slots, consts, warps):
    """Every layer, warp by warp; each product is written when computed."""
    _, n_layers, _, layer_start, prod_pc, _ = _header(prog)
    for layer in range(n_layers):
        for t in range(warps):
            for j in range(layer_start[layer] + t, layer_start[layer + 1], warps):
                pc = prod_pc[j]
                left = _eval_row(prog, pc + 1, slots, consts)
                right = _eval_row(prog, _terms(prog, pc + 1)[2], slots, consts)
                prod = fq.mont_mul_h(fq.to_half(left), fq.to_half(right))
                slots[prog[pc]] = fq.to_words(prod)


def _run_program(sp, consts, x):
    """csrc/circuit.cu's circuit entry: [n_inputs, 12, n] -> [n_outputs, 12, n]."""
    prog = sp.words.tolist()
    n_in, _, n_out, _, _, out_pc = _header(prog)
    slots = torch.full((sp.n_slots, 12, x.shape[-1]), -1, dtype=torch.int32)  # unwritten
    slots[:n_in] = x
    _run_layers(prog, slots, torch.as_tensor(consts), sp.warps)
    return torch.stack([_eval_row(prog, out_pc[o] + 1, slots, torch.as_tensor(consts))
                        for o in range(n_out)])


def _run_chain(chain, acc, table):
    """csrc/circuit.cu's chain entry: the accumulator in slots 0 .. n_acc-1
    from step to step, warp e loading element e of each entry beside it
    (or over it, for a step without a circuit), the output group through
    its output slots."""
    words = chain.words.tolist()
    consts = torch.as_tensor(chain.const_vals)
    k = chain.n_acc
    n_sel = words[words[1]] - k
    assert n_sel == chain.n_sel <= chain.warps
    slots = torch.full((chain.n_slots, 12, acc.shape[-1]), -1, dtype=torch.int32)
    slots[:k] = acc
    for c, entry, take in chain.step_words.reshape(-1, 3).tolist():
        first = 0 if c < 0 else k
        for t in range(n_sel):  # warps n_sel .. load nothing
            slots[first + t] = table[t, :, entry]
        if c < 0:
            continue
        prog = words[words[1 + c]:]
        _run_layers(prog, slots, consts, chain.warps)
        out_pc = _header(prog)[5][take * k : (take + 1) * k]
        for t in range(chain.warps):
            for i in range(t, k, chain.warps):
                slots[prog[out_pc[i]]] = _eval_row(prog, out_pc[i] + 1, slots, consts)
        for i in range(k):
            slots[i] = slots[prog[out_pc[i]]]
    return slots[:k].clone()


def _const_circuit(k1=7, k2=P - 5):
    """A small recorded circuit with constants in its mixes and products."""
    b = CircuitBuilder(3)
    i0, i1, i2 = (b.input(i) for i in range(3))
    k1, k2 = b.const(k1), b.const(k2)
    y = (i0 + k1) * (i1 - k2)
    z = y * y - i2 * k1
    w = (z + k2) * (y.dbl() - i0)
    return CircuitExec(b.compile([w, z - k1, y + w, -k2]), "consts")


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_slot_program_equals_the_plain_executor(name):
    circ = CIRCUITS[name][0]()
    x = _inputs()
    assert torch.equal(_run_program(circ.slots, circ.circ.const_vals, x), circ.plain(x))


@pytest.mark.parametrize("name", ["add", "dblk4_add"])
def test_slot_program_equals_circuit_T(name):
    circ = CIRCUITS[name][0]()
    got = _run_program(circ.slots, circ.circ.const_vals, _inputs())
    assert np.array_equal(got.numpy(), _circuit_T_out(name))


def test_slot_program_with_constants_and_the_signed_mix_vector():
    circ = _const_circuit()
    assert circ.n_const == 2
    x = _inputs(3)[:3]
    assert torch.equal(_run_program(circ.slots, circ.circ.const_vals, x), circ.plain(x))
    mix, x, want = _signed_mix()
    got = _run_program(mix.slots, mix.circ.const_vals, x)
    assert torch.equal(got, mix.plain(x))
    assert limbs.limbs_to_ints_batch(got[:, :, 0].numpy()) == want


def test_decrypt_circuits_fit_the_slots():
    """Slots, warps and shared memory of the three decrypt circuits and the
    Straus chain, and the most wires live at a layer boundary."""
    want = {"dblk6_add": (17, 19, 5), "add": (11, 12, 5), "dblk4_add": (17, 19, 5)}
    for name, (slots, chain_slots, warps) in want.items():
        sp = CIRCUITS[name][0]().slots
        assert (sp.n_slots, sp.n_slots_chain, sp.warps) == (slots, chain_slots, warps)
        assert ct.smem_bytes(len(sp.words), 0, sp.n_slots) < 32 * 1024
    assert max(_live_at_boundaries(CIRCUITS[n][0]().circ) for n in CIRCUITS) == 13
    b = CircuitBuilder(1)
    x = b.input(0)
    wide = b.compile([x * x for _ in range(160)])  # 160 products, all live at the output mix
    with pytest.raises(ValueError, match="161 slots"):
        CircuitExec(wide, "too_wide")


def _live_at_boundaries(circ):
    """The most wires (inputs and products) live across a layer boundary."""
    n_in, widths = circ.n_inputs, circ.n_lanes
    n_fixed = n_in + circ.const_vals.shape[0]
    last = np.full(n_fixed + sum(widths), -1)
    for layer, (sl, sr) in enumerate(circ.mats):
        last[: sl.shape[1]][(sl != 0).any(0) | (sr != 0).any(0)] = layer
    last[(circ.T != 0).any(0)] = len(widths)
    born = [-1] * n_in + [None] * (n_fixed - n_in)
    for layer, w in enumerate(widths):
        born += [layer] * w
    return max(sum(1 for w, b0 in enumerate(born) if b0 is not None and b0 < layer <= last[w])
               for layer in range(len(widths) + 1))


# -- liveness: no slot is overwritten while its wire is live ----------------


def _check_slots(circ, sp):
    """Walk the program against the circuit's matrices: every ref of every
    row holds the wire the circuit names, no product writes a slot its own
    layer reads, and the output slots are distinct, above the inputs and
    not read by the output rows."""
    prog = sp.words.tolist()
    n_in, n_layers, n_out, layer_start, prod_pc, out_pc = _header(prog)
    assert (n_in, n_layers, n_out) == (circ.n_inputs, len(circ.n_lanes), circ.n_outputs)
    assert layer_start == np.concatenate([[0], np.cumsum(circ.n_lanes)]).tolist()
    n_fixed = n_in + circ.const_vals.shape[0]
    content = {s: s for s in range(n_in)}  # slot -> the wire column it holds

    def reads(pc, row):
        negsum, terms, after = _terms(prog, pc)
        cols = np.nonzero(row)[0]
        assert [c for _, c in terms] == row[cols].tolist()
        assert negsum == int(np.where(row < 0, -row, 0).sum())
        for (ref, _), col in zip(terms, cols):
            if col < n_in or col >= n_fixed:
                assert ref >= 0 and content.get(ref) == col, "a slot lost its wire while live"
            else:
                assert ref == -1 - (col - n_in)
        return {ref for ref, _ in terms if ref >= 0}, after

    col = n_fixed
    for layer, (sl, sr) in enumerate(circ.mats):
        read, written = set(), []
        for i, j in enumerate(range(layer_start[layer], layer_start[layer + 1])):
            pc = prod_pc[j]
            r1, after = reads(pc + 1, sl[i])
            r2, _ = reads(after, sr[i])
            read |= r1 | r2
            written.append(prog[pc])
        assert len(set(written)) == len(written) and not read & set(written)
        assert max(written) < sp.n_slots
        for dest in written:
            content[dest] = col
            col += 1
    read = set()
    for o in range(n_out):
        read |= reads(out_pc[o] + 1, circ.T[o])[0]
    outs = [prog[out_pc[o]] for o in range(n_out)]
    assert len(set(outs)) == n_out and min(outs, default=n_in) >= n_in
    assert not read & set(outs) and max(outs, default=0) < sp.n_slots_chain


@st.composite
def recorded_circuits(draw):
    """A random recorded circuit: products of small signed mixes of the
    inputs, constants and earlier products, then a few output mixes."""
    n_in = draw(st.integers(1, 4))
    b = CircuitBuilder(n_in)
    pool = [b.input(i) for i in range(n_in)]
    pool += [b.const(draw(st.integers(1, P - 1))) for _ in range(draw(st.integers(0, 2)))]

    def mix():
        out = b.zero()
        for _ in range(draw(st.integers(1, 3))):
            x = pool[draw(st.integers(0, len(pool) - 1))]
            c = draw(st.sampled_from([1, -1, 2, -2]))
            out = out + (x if abs(c) == 1 else x.dbl()) if c > 0 else out - (x if c == -1 else x.dbl())
        return out

    for _ in range(draw(st.integers(1, 30))):
        v = mix() * mix()
        if not v.is_zero():
            pool.append(v)
    return b.compile([mix() for _ in range(draw(st.integers(1, 5)))])


@settings(max_examples=60, deadline=None)
@given(recorded_circuits())
def test_no_slot_is_overwritten_while_its_wire_is_live(circ):
    sp = ct.slot_program(circ)
    _check_slots(circ, sp)
    assert 1 <= sp.warps <= ct.MAX_WARPS and sp.n_slots >= circ.n_inputs


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_decrypt_circuits_keep_their_wires_live(name):
    circ = CIRCUITS[name][0]()
    _check_slots(circ.circ, circ.slots)


# -- the chain entry ----------------------------------------------------------


@pytest.fixture(scope="module")
def straus():
    """The 4 x 1 epoch's Straus chain and a [3, 12, 16 q, n] table of
    non-normalised points, distinct per quorum member."""
    sim = ts.FullCryptoTensorSim(ts.FullCryptoConfig(n_nodes=4, instances=1, seed=3), device="cpu")
    ep = sim.epoch
    pts = torch.cat([fq.jac_double_plain(sim._U.roll(i, -1)) for i in range(ep.q)], -1)
    tabs = dt._build_table(pts, 1 << dt.W2, dt._Ops(False))
    return ep, tabs.reshape(3, 12, (1 << dt.W2) * ep.q, ep.n_ct)


def _straus_loop(ep, tabs):
    """The Straus combine as one circuit call per step, glued as
    decrypt_T._glue_add defines it."""
    tabs = tabs.reshape(3, 12, 1 << dt.W2, ep.q, ep.n_ct)
    comb = fq.jac_infinity(ep.n_ct, "cpu")
    for col in ep._straus_plan():
        for i, (dig, need, code) in enumerate(col):
            sel = tabs[:, :, dig, i]
            added = doubled = None
            if need:
                out = (ep.circ_da2 if i == 0 else ep.circ_a).plain(torch.cat([comb, sel]))
                added, doubled = out[:3], out[3:]
            comb = (added, doubled if i == 0 else comb, sel, comb)[code]
    return comb


def test_chain_equals_the_per_circuit_straus_loop(straus):
    ep, tabs = straus
    chain = ep.straus
    steps = chain.step_words.reshape(-1, 3)
    assert (steps[:, 0] == -1).any() and {0, 1} <= set(steps[:, 0].tolist())
    assert {0, 1} <= set(steps[steps[:, 0] == 0, 2].tolist())  # both groups taken
    want = _straus_loop(ep, tabs)
    acc0 = fq.jac_infinity(ep.n_ct, "cpu")
    assert torch.equal(chain.plain(acc0, tabs), want)
    assert torch.equal(_run_chain(chain, acc0, tabs), want)


def test_chain_checks_its_steps_and_operands(straus):
    ep, tabs = straus
    a, da = ep.circ_a, ep.circ_da2
    with pytest.raises(ValueError, match="output group"):
        ct.CircuitChain([a], [(0, 0, 1)], 3)
    with pytest.raises(ValueError, match="take its entry"):
        ct.CircuitChain([a], [(None, 0, 0)], 3)
    chain = ct.CircuitChain([da, a], [(None, 1, ct.SEL), (0, 2, 1), (1, 30, 0)], 3)
    acc0 = fq.jac_infinity(ep.n_ct, "cpu")
    with pytest.raises(ValueError, match="reads entry 30"):
        chain(acc0, tabs[:, :, :16])
    assert chain.products == da.n_products + a.n_products
    assert chain.elements() == 3 + 3 * 3 + 3
    want = chain.plain(acc0, tabs)
    assert torch.equal(chain(acc0, tabs), want)  # a CPU tensor: the plain version
    assert torch.equal(_run_chain(chain, acc0, tabs), want)


def test_chain_gives_each_entry_element_a_warp():
    """A chain runs at least one warp per element of an entry (warp e
    fetches element e of the next step's entry), however narrow its
    circuits' layers, and refuses an entry wider than a block's warps."""
    b = CircuitBuilder(5)
    x = [b.input(i) for i in range(5)]
    y = ((x[0] * x[1]) * x[2] + x[3]) * x[4]  # layers of one product
    narrow = CircuitExec(b.compile([y, x[0] - y]), "narrow")
    assert narrow.slots.warps == 1
    chain = ct.CircuitChain([narrow], [(0, 1, 0), (0, 0, 1), (0, 1, 0)], 1, "narrow")
    assert (chain.n_sel, chain.warps) == (4, 4)
    v = _inputs(3)[:5]  # [5, 12, 3]
    acc, table = v[:1], torch.stack([v[1:], v[:4]], 2)  # [4, 12, 2 entries, 3 lanes]
    want = chain.plain(acc, table)
    assert torch.equal(_run_chain(chain, acc, table), want)
    assert not torch.equal(want, acc)
    b = CircuitBuilder(ct.MAX_WARPS + 2)
    wide = CircuitExec(b.compile([b.input(0) * b.input(ct.MAX_WARPS + 1)]), "wide_entry")
    with pytest.raises(ValueError, match=f"entry of {ct.MAX_WARPS + 1} elements"):
        ct.CircuitChain([wide], [(0, 0, 0)], 1)


def test_chain_of_circuits_with_constants():
    """Two circuits with different constants in one chain: each program
    names its own constants in the chain's one constant table."""
    c1, c2 = _const_circuit(), _const_circuit(11, 3)
    chain = ct.CircuitChain([c1, c2], [(0, 1, 0), (1, 2, 3), (1, 0, 2), (0, 2, 1)], 1, "consts")
    assert chain.n_const == 4 and np.array_equal(chain.const_vals[2:], c2.circ.const_vals)
    x = _inputs(3)  # [6, 12, 3]
    acc = x[:1]  # one accumulator element, entries of two
    table = torch.stack([x[1:3], x[3:5], x[4:6]], 2)  # [2, 12, 3 entries, 3 lanes]
    want = chain.plain(acc, table)
    assert torch.equal(_run_chain(chain, acc, table), want)
    assert not torch.equal(want, acc)
