"""The port's batched pairing check (ops/pairing_torch on kernel B3's
executor) against the JAX package and the host oracles.

- Every recorded pairing circuit has the matrices, constants and lane
  counts of JAX ops/pairing_jax's recording (numpy only, no compile).
- Each circuit's plain version at 3 lanes equals the port's host FQ12
  arithmetic through one slot converter (slots g0 g1 g2 h0 h1 h2 carry
  w-powers 0 2 4 1 3 5, each an Fp2 pair, u = w^6 - 1): the Miller double
  and add against f^2 * line / f * line and the host point double / add,
  the cyclotomic squaring on genuine cyclotomic elements, the inverse's
  three launches against FQ12.inv.
- The slotted programs of `miller_dbl` and `mul_frob1` / `mul_frob2` equal
  the plain version through tests/test_torch_circuit.py's interpreter of
  what csrc/circuit.cu reads; every circuit fits one block, the 4-step
  Miller double does not.
- `pairing_eq_batch(device="cpu")` on true, forged and infinity lanes
  gives the verdicts of JAX `pairing_check_eq` and the port's, with the
  launches by circuit equal to `schedule`; the GPU engine's two pairing
  entries equal the host engine's per-share verdicts.

The card-only cases are in tests/test_torch_cuda.py.
"""
from collections import Counter

import numpy as np
import pytest
import torch

from hydrabadger_tpu.crypto import bls12_381 as jbls
from hydrabadger_tpu.ops import pairing_jax as pj
from hydrabadger_tpu_torch.crypto import bls12_381 as bls
from hydrabadger_tpu_torch.crypto import threshold as th
from hydrabadger_tpu_torch.crypto.engine import CpuEngine, GpuEngine
from hydrabadger_tpu_torch.ops import circuit_torch, limbs, roofline
from hydrabadger_tpu_torch.ops import pairing_torch as pt
from hydrabadger_tpu_torch.ops.circuit_torch import CircuitExec
from test_torch_circuit import _check_slots, _run_program

P = bls.P
FQ, FQ2, FQ12 = bls.FQ, bls.FQ2, bls.FQ12
XI = FQ2([1, 1])
N = 3  # lanes of the circuit checks

CIRCUITS = {
    "miller_dbl": (pt._miller_dbl_circuit, pj._miller_dbl_circuit),
    "miller_add": (pt._miller_add_circuit, pj._miller_add_circuit),
    "sqr": (pt._sqr_circuit, pj._sqr_circuit),
    "cyc_sqr": (pt._cyc_sqr_circuit, pj._cyc_sqr_circuit),
    "mul": (pt._mul_circuit, pj._mul_circuit),
    "mul_frob1": (lambda: pt._mul_conj_frob_circuit(1, False),
                  lambda: pj._mul_conj_frob_circuit(1, False)),
    "mul_frob2": (lambda: pt._mul_conj_frob_circuit(2, False),
                  lambda: pj._mul_conj_frob_circuit(2, False)),
    "inv_front": (pt._inv_front_circuit, pj._inv_front_circuit),
    "inv_back": (pt._inv_back_circuit, pj._inv_back_circuit),
    "conj": (pt._conj_circuit, pj._conj_circuit),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# Converters: host values <-> [n, 12, lanes] Montgomery words
# ---------------------------------------------------------------------------


def to_words(rows) -> torch.Tensor:
    """rows[e][lane] ints -> [n_elements, 12, lanes] Montgomery words."""
    flat = [v % P * limbs.R_MONT % P for row in rows for v in row]
    w = limbs.ints_to_limbs_batch(flat).reshape(len(rows), len(rows[0]), 12)
    return torch.from_numpy(np.ascontiguousarray(w.transpose(0, 2, 1)))


def from_words(x: torch.Tensor) -> list:
    """[n, 12, lanes] Montgomery words -> rows[e][lane] ints."""
    n, _, lanes = x.shape
    ints = limbs.limbs_to_ints_batch(x.permute(0, 2, 1).reshape(-1, 12).numpy())
    return [[v * limbs.R_INV % P for v in ints[e * lanes:(e + 1) * lanes]] for e in range(n)]


def fq12_slots(f) -> list:
    """FQ12 -> its 12 circuit inputs (c0, c1 of slots g0 g1 g2 h0 h1 h2)."""
    c = [int(v) % P for v in f.coeffs]
    out = []
    for k in pt._WPOW:
        out += [(c[k] + c[k + 6]) % P, c[k + 6]]
    return out


def slots_fq12(vals) -> "FQ12":
    """12 circuit outputs -> FQ12 (u = w^6 - 1)."""
    c = [0] * 12
    for s, k in enumerate(pt._WPOW):
        c0, c1 = vals[2 * s], vals[2 * s + 1]
        c[k] = (c0 - c1) % P
        c[k + 6] = c1
    return FQ12(c)


def line(a0, a3, a5) -> "FQ12":
    """a0 + a3 w^3 + a5 w^5 (slots g0, h1, h2)."""
    z = [0] * 12
    z[0:2], z[8:10], z[10:12] = a0.coeffs, a3.coeffs, a5.coeffs
    return slots_fq12([int(v) % P for v in z])


def lanes_in(*per_lane_inputs) -> torch.Tensor:
    """Per lane a list of input ints -> [n_inputs, 12, lanes]."""
    return to_words([list(col) for col in zip(*per_lane_inputs)])


def lanes_out(x: torch.Tensor) -> list:
    """[n, 12, lanes] -> per lane a list of output ints."""
    return [list(col) for col in zip(*from_words(x))]


def rand_fq12(rng) -> "FQ12":
    return FQ12([int.from_bytes(rng.bytes(48), "little") % P for _ in range(12)])


def rand_fq2(rng) -> "FQ2":
    return FQ2([int.from_bytes(rng.bytes(48), "little") % P for _ in range(2)])


def cyclotomic(f) -> "FQ12":
    """f^((p^6 - 1)(p^2 + 1)), in the cyclotomic subgroup."""
    u = f.conjugate() * f.inv()
    return bls._frobenius_p2(u) * u


# ---------------------------------------------------------------------------
# The recordings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_recording_equals_the_jax_recording(name):
    mine, theirs = CIRCUITS[name][0]().circ, CIRCUITS[name][1]()
    assert (mine.n_inputs, mine.n_outputs) == (theirs.n_inputs, theirs.n_outputs)
    assert list(mine.n_lanes) == list(theirs.n_lanes)
    assert len(mine.mats) == len(theirs.mats)
    for (ml, mr), (tl, tr) in zip(mine.mats, theirs.mats):
        assert np.array_equal(ml, tl) and np.array_equal(mr, tr)
    assert np.array_equal(mine.T, theirs.T)
    jc = [sum(int(v) << (12 * i) for i, v in enumerate(row)) for row in np.asarray(theirs.const_vals)]
    assert limbs.limbs_to_ints_batch(mine.const_vals) == jc


def test_constants_and_schedule_equal_the_jax_ones():
    assert pt.X_ABS == pj.X_ABS
    assert pt._exp_segments(pt.X_ABS) == pj._exp_segments(pj.X_ABS)
    assert pt._P_MINUS_2_BITS == pj._P_MINUS_2_BITS.tolist()
    one = limbs.limbs_to_ints_batch(pt._ONE12)
    assert one == [sum(int(v) << (12 * i) for i, v in enumerate(r)) for r in pj._ONE12]
    s = pt.schedule(8)
    assert (s["miller_dbl"], s["miller_add"], s["cyc_sqr"]) == (63, 5, 315)
    assert sum(s.values()) == 429 and pt.schedule(0) == {}


def test_bound_counts_the_schedules_products():
    assert pt.products(1) == 26086 and pt.products(1024) == 1024 * 26086
    ops_ms, bytes_ms = pt.bound(1024)
    assert ops_ms == pytest.approx(1024 * 26086 * roofline.OPS_PER_PRODUCT / roofline.PEAK_INT8_OPS_PER_S * 1e3)
    assert bytes_ms == pytest.approx(1024 * (12 * 48 + 1) / roofline.PEAK_BYTES_PER_S * 1e3)


def _affine_ints(a):
    """An affine point of either package (or None) as plain ints."""
    if a is None:
        return None
    return [int(v) % P for c in a for v in (c.coeffs if hasattr(c, "coeffs") else [c.n])]


def test_normalize_batch_equals_the_jax_one():
    g1, g2 = bls.G1, bls.G2
    z = FQ(7)
    pts1 = [bls.multiply(g1, 5), (g1[0] * z, g1[1] * z, z), bls.infinity(FQ), g1]
    z2 = FQ2([3, 4])
    pts2 = [(g2[0] * z2, g2[1] * z2, z2), bls.infinity(FQ2), g2]
    for pts, to_jax in ((pts1, _jax_g1), (pts2, _jax_g2)):
        mine = bls.normalize_batch(pts)
        theirs = jbls.normalize_batch([to_jax(p_) for p_ in pts])
        assert mine == [bls.normalize(p_) for p_ in pts]
        assert [_affine_ints(a) for a in mine] == [_affine_ints(a) for a in theirs]


def test_every_circuit_fits_one_block_and_the_unrolled_double_does_not():
    for c in pt.circuits().values():
        assert c.smem <= circuit_torch.SMEM_LIMIT
        assert c.smem == circuit_torch.smem_bytes(len(c.slots.words), c.n_const, c.slots.n_slots)
    with pytest.raises(ValueError, match="shared memory"):
        pt._miller_dbl_circuit_k(4)


# ---------------------------------------------------------------------------
# Each circuit's plain version against the host tower
# ---------------------------------------------------------------------------


def test_fp12_circuits_equal_host_arithmetic():
    rng = np.random.default_rng(11)
    fs = [rand_fq12(rng) for _ in range(N)]
    gs = [rand_fq12(rng) for _ in range(N)]
    x1 = lanes_in(*[fq12_slots(f) for f in fs])
    x2 = lanes_in(*[fq12_slots(f) + fq12_slots(g) for f, g in zip(fs, gs)])

    def got(circ, x):
        return [slots_fq12(v) for v in lanes_out(circ(x))]

    assert got(pt._sqr_circuit(), x1) == [f * f for f in fs]
    assert got(pt._conj_circuit(), x1) == [f.conjugate() for f in fs]
    assert got(pt._mul_circuit(), x2) == [f * g for f, g in zip(fs, gs)]
    assert got(pt._mul_conj_frob_circuit(2, False), x2) == [
        f * bls._frobenius_p2(g) for f, g in zip(fs, gs)]
    assert got(pt._mul_conj_frob_circuit(1, False), x2) == [f * g ** P for f, g in zip(fs, gs)]
    # the inverse: front, one Fp inversion per lane, back
    front = pt._inv_front_circuit()(x1)
    ninv = pt._fq_inv_circuit()(front[8:9])
    assert from_words(ninv)[0] == [pow(v, P - 2, P) for v in from_words(front[8:9])[0]]
    back = pt._inv_back_circuit()(torch.cat([x1, front[:8], ninv]))
    assert [slots_fq12(v) for v in lanes_out(back)] == [f.inv() for f in fs]


def test_cyclotomic_squaring_on_cyclotomic_elements():
    rng = np.random.default_rng(12)
    cs = [cyclotomic(rand_fq12(rng)) for _ in range(N)]
    assert all(c ** (P**4 - P**2 + 1) == FQ12.one() for c in cs[:1])  # genuinely cyclotomic
    got = lanes_out(pt._cyc_sqr_circuit()(lanes_in(*[fq12_slots(c) for c in cs])))
    assert [slots_fq12(v) for v in got] == [c * c for c in cs]


def _miller_lanes(rng):
    """Per lane: f, a projective twist point R with a random Z, an affine
    Q, an affine G1 point (px, py)."""
    out = []
    for i in range(N):
        f = rand_fq12(rng)
        r = bls.multiply(bls.G2, 1000 + i)
        z = rand_fq2(rng)
        R = (r[0] * z, r[1] * z, r[2] * z)
        Q = bls.normalize(bls.multiply(bls.G2, 77 + 3 * i))
        p = bls.normalize(bls.multiply(bls.G1, 5 + i))
        out.append((f, R, Q, p))
    return out


def _pack(f, R, Q, p) -> list:
    return (fq12_slots(f) + [int(v) for c in R for v in c.coeffs]
            + [int(v) for c in Q for v in c.coeffs] + [p[0].n, p[1].n])


def test_miller_double_and_add_equal_host_lines_and_points():
    rng = np.random.default_rng(13)
    lanes = _miller_lanes(rng)
    x = lanes_in(*[_pack(*lane) for lane in lanes])
    for name, circ in (("dbl", pt._miller_dbl_circuit()), ("add", pt._miller_add_circuit())):
        for (f, R, Q, p), out in zip(lanes, lanes_out(circ(x))):
            X, Y, Z = R
            px, py = FQ2([p[0].n, 0]), FQ2([p[1].n, 0])
            if name == "dbl":
                a0 = -(Y * Z * Z * py * 2) * XI
                a3 = Y * Y * Z * 2 - X * X * X * 3
                a5 = X * X * Z * px * 3
                want_f, want_r = f * f * line(a0, a3, a5), bls.double(R)
            else:
                lam = Q[1] * Z - Y
                dl = Q[0] * Z - X
                b0 = -(dl * py * Z) * XI
                b3 = dl * Y - lam * X
                b5 = lam * Z * px
                want_f = f * line(b0, b3, b5)
                want_r = bls._py_add(R, (Q[0], Q[1], FQ2.one()))
            assert slots_fq12(out[:12]) == want_f, name
            got_r = tuple(FQ2(out[12 + 2 * j: 14 + 2 * j]) for j in range(3))
            assert bls.eq(got_r, want_r), name


# ---------------------------------------------------------------------------
# Kernel B3's slotted programs, through the interpreter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["miller_dbl", "mul_frob1", "mul_frob2"])
def test_slot_program_equals_the_plain_version(name):
    circ = CIRCUITS[name][0]()
    _check_slots(circ.circ, circ.slots)
    rng = np.random.default_rng(14)
    if name == "miller_dbl":
        x = lanes_in(*[_pack(*lane) for lane in _miller_lanes(rng)])
    else:
        x = lanes_in(*[fq12_slots(rand_fq12(rng)) + fq12_slots(rand_fq12(rng)) for _ in range(N)])
    assert torch.equal(_run_program(circ.slots, circ.circ.const_vals, x), circ.plain(x))


# ---------------------------------------------------------------------------
# The batch entry and the engine
# ---------------------------------------------------------------------------


@pytest.fixture
def counted(monkeypatch):
    """Counts the plain circuit calls by name."""
    calls = Counter()
    plain = CircuitExec.plain

    def counting(self, x):
        calls[self.name] += 1
        return plain(self, x)

    monkeypatch.setattr(CircuitExec, "plain", counting)
    return calls


def _jax_g1(pt_):
    return jbls.g1_from_bytes(bls.g1_to_bytes(pt_))


def _jax_g2(pt_):
    return jbls.g2_from_bytes(bls.g2_to_bytes(pt_))


def test_pairing_eq_batch_gives_the_oracles_verdicts(counted):
    g1, g2 = bls.G1, bls.G2
    inf1, inf2 = bls.infinity(FQ), bls.infinity(FQ2)
    lanes = [
        (bls.multiply(g1, 3), bls.multiply(g2, 11), bls.multiply(g1, 33), g2),  # true
        (bls.multiply(g1, 5), bls.multiply(g2, 13), bls.multiply(g1, 66), g2),  # forged
        (inf1, bls.multiply(g2, 7), bls.multiply(g1, 9), inf2),  # infinity: 1 == 1
        (bls.multiply(g1, 7), g2, g1, bls.multiply(g2, 7)),  # true, d = b * 7
        (inf1, g2, g1, g2),  # infinity: 1 != e(g1, g2)
    ]
    got = pt.pairing_eq_batch(*zip(*lanes), device="cpu")
    mine = [bls.pairing_check_eq(*lane) for lane in lanes]
    theirs = [jbls.pairing_check_eq(_jax_g1(a), _jax_g2(b), _jax_g1(c), _jax_g2(d))
              for a, b, c, d in lanes]
    assert got.tolist() == mine == theirs == [True, False, True, True, False]
    assert dict(counted) == pt.schedule(3)  # the three finite lanes, one batch
    counted.clear()
    assert pt.pairing_eq_batch([inf1], [g2], [g1], [g2], device="cpu").tolist() == [False]
    assert not counted  # no finite lane: nothing reaches the device path
    if not torch.cuda.is_available():  # the default device is the card: raises without one
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt.pairing_eq_batch(*zip(*lanes))


def _key_material(n):
    import random

    rng = random.Random(7)
    sks = th.SecretKeySet.random(1, rng)
    pks = sks.public_keys()
    cts = [pks.public_key().encrypt(b"%032d" % i, rng) for i in range(n)]
    return rng, sks, pks, cts


def test_engine_decryption_share_pairs_equal_the_host_verdicts():
    _rng, sks, pks, cts = _key_material(3)
    shares = [sks.secret_key_share(i % 2).decrypt_share(ct) for i, ct in enumerate(cts)]
    pk_shares = [pks.public_key_share(i % 2) for i in range(3)]
    shares[1] = sks.secret_key_share(0).decrypt_share(cts[1])  # forged: key 0's share for node 1
    shares[2] = th.DecryptionShare(bls.infinity(FQ))  # a share at infinity
    host = CpuEngine()
    want = [host.verify_decryption_share(pk, s, ct) for pk, s, ct in zip(pk_shares, shares, cts)]
    assert want == [True, False, False]
    got = GpuEngine(device="cpu").verify_decryption_share_pairs(pk_shares, shares, cts)
    assert got == want
    assert GpuEngine(device="cpu").verify_decryption_share_pairs([], [], []) == []


def test_engine_signature_share_pairs_equal_the_host_verdicts():
    _rng, sks, pks, _cts = _key_material(0)
    msgs = [b"coin-a", b"coin-b"]
    shares = [sks.secret_key_share(0).sign_share(msgs[0]), sks.secret_key_share(1).sign_share(b"x")]
    host = CpuEngine()
    want = [host.verify_signature_share(pks, i, s, m) for i, (s, m) in enumerate(zip(shares, msgs))]
    assert want == [True, False]
    got = GpuEngine(device="cpu").verify_signature_share_pairs(
        [pks.public_key_share(i) for i in range(2)], shares, msgs)
    assert got == want
