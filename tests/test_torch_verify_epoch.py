"""The verified threshold-decrypt epoch (ops/verify_torch, sim/tensor
FullCryptoTensorSim with verify on) on the CPU at 4 nodes, f = 1 faulty,
one instance, against the plain reference of benchmark/reference (Python
integers, a textbook pairing): two epochs with every U, W and verdict
equal to the reference's, the forged shares rejected and counted, the
verify stage's launches as its schedule; shares forged other ways (a
random G1 point, last epoch's share replayed) rejected and the epoch
failed; a faulty node's valid share accepted by the engine and the
epoch failed by the sim's adversary check; with verification off the
decrypt engine's epoch as it was; the seeded sim's ciphertexts valid; and
the configuration's errors."""
import random

import pytest
import torch

from benchmark.reference import g1, g2
from benchmark.reference import pairing as ref
from hydrabadger_tpu_torch.crypto import bls12_381 as bls
from hydrabadger_tpu_torch.obs import metrics as M
from hydrabadger_tpu_torch.ops import circuit_torch, decrypt_torch, limbs, verify_torch
from hydrabadger_tpu_torch.sim import tensor as ts

N, T = 4, 1
QUORUM, FAULTY = [0, 1], [3]
N_CT = N  # one instance


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(seed: int):
    """Keys and one instance's ciphertexts as the benchmark's closed form:
    U_j = (a + j b) G1, H_j = (c + j d) G2, W_j = (a + j b) H_j."""
    rng = random.Random(seed)
    coeffs = [rng.getrandbits(256) % g1.R for _ in range(T + 1)]
    a, b, c, d = (rng.getrandbits(256) % g1.R for _ in range(4))
    sks = [g1.poly_eval(coeffs, i + 1) for i in range(N)]
    u = g1.to_affine(g1.chain(g1.mul(g1.G, a), g1.mul(g1.G, b), N_CT))
    h = g2.to_affine(g2.chain(g2.mul(g2.G, c), g2.mul(g2.G, d), N_CT))
    w = g2.to_affine(g2.quadratic_chain(a * c % g1.R, (a * d + b * c) % g1.R, b * d % g1.R, N_CT))
    return sks, coeffs[0], u, h, w


def _sim(sks, master, u, h, w):
    return ts.FullCryptoTensorSim.from_jax(
        g1.points_to_layout(u).reshape(1, N, 3, g1.N_LIMBS), sks, master, QUORUM, device="cpu",
        W=g2.points_to_layout(w).reshape(1, N, 3, 2, g1.N_LIMBS),
        H=g2.points_to_layout(h).reshape(1, N, 3, 2, g1.N_LIMBS), faulty=len(FAULTY))


class _CountPlain:
    """Counts the plain circuit calls by name while it is entered."""

    def __init__(self):
        self.calls = {}

    def __enter__(self):
        plain = self.real = circuit_torch.CircuitExec.plain

        def counting(circ, x):
            self.calls[circ.name] = self.calls.get(circ.name, 0) + 1
            return plain(circ, x)

        circuit_torch.CircuitExec.plain = counting
        return self

    def __exit__(self, *exc):
        circuit_torch.CircuitExec.plain = self.real


@pytest.fixture(scope="module")
def two_epochs():
    """A verified 4-node sim, its inputs, and per epoch the state before,
    the verdict, the verdicts, the state after and the verify stage's
    plain circuit calls."""
    sks, master, u, h, w = _inputs(2**33 + 5)
    sim = _sim(sks, master, u, h, w)
    checks = sim.epoch.checks
    counters = M.default_registry().snapshot()["counters"]
    epochs = []
    for _ in range(2):
        before = (g1.layout_points(sim.state()), g2.layout_points(sim.w_state()))
        counted = _CountPlain()

        def counted_checks(*args, counted=counted):
            with counted:
                return checks(*args)

        sim.epoch.checks = counted_checks
        ok = sim.run(1)
        sim.epoch.checks = checks
        epochs.append({"before": before, "ok": ok, "verdicts": sim.last_verdicts(),
                       "after": (sim.state(), sim.w_state()), "calls": counted.calls,
                       "rejected": sim.rejected_total})
    return {"sim": sim, "sks": sks, "master": master, "h": h, "epochs": epochs,
            "counters_before": counters}


def test_every_lane_and_verdict_equal_the_reference(two_epochs):
    sks, master, h = two_epochs["sks"], two_epochs["master"], two_epochs["h"]
    for ep in two_epochs["epochs"]:
        us, ws = ep["before"]
        want = [ref.verified_epoch(us[j], ws[j], h[j], sks, master, QUORUM, FAULTY)
                for j in range(N_CT)]
        v = ep["verdicts"]
        assert v["quorum"].shape == (len(QUORUM), 1, N) and v["forged"].shape == (1, 1, N)
        assert v["quorum"][:, 0].T.tolist() == [r["quorum"] for r in want]
        assert v["forged"][:, 0].T.tolist() == [r["forged"] for r in want]
        assert v["ciphertext"][0].tolist() == [r["ciphertext"] for r in want]
        assert want[0]["quorum"] == [True, True] and want[0]["forged"] == [False]
        u_next, w_next = ep["after"]
        assert g1.lanes_differing(g1.layout_points(u_next),
                                  g1.to_affine([r["u_next"] for r in want])) == 0
        assert g2.lanes_differing(g2.layout_points(w_next),
                                  g2.to_affine([r["w_next"] for r in want])) == 0


def test_forged_shares_rejected_and_counted(two_epochs):
    eps = two_epochs["epochs"]
    assert [ep["ok"] for ep in eps] == [True, True]
    assert [ep["rejected"] for ep in eps] == [N_CT, 2 * N_CT]  # one forged share a ciphertext
    after = M.default_registry().snapshot()["counters"]
    before = two_epochs["counters_before"]

    def delta(name):
        return after.get(name, 0) - before.get(name, 0)

    assert delta(M.TDEC_SHARES_REJECTED) == 2 * N_CT
    assert M.default_registry().snapshot()["histograms"][M.VERIFY_ISSUE_S]["total"] >= 2


def test_the_verify_stage_calls_its_schedule(two_epochs):
    sim = two_epochs["sim"]
    want = sim.epoch.checks.launch_counts()
    assert two_epochs["epochs"][0]["calls"] == want
    assert want["fq_inv"] == 2 and want["miller_dbl"] == 63 and sum(want.values()) == 429 + 4
    counts = sim.launch_counts()
    dec = sim.epoch.dec.launch_counts()
    assert counts["fq_point"] == {**dec["fq_point"], "add": dec["fq_point"]["add"] + 1}
    assert sim.epoch.launch_counts()["fq_point"] == dec["fq_point"]  # the forgery is the sim's
    assert counts["fq2_point"] == {"ladder": 1}
    assert not set(want) & set(dec["circuit"])
    assert counts["circuit"] == {**dec["circuit"], **want}


def test_other_forgeries_are_rejected_and_fail_the_epoch(two_epochs):
    """Ciphertext 0's quorum share of node 0 replaced by a random G1 point,
    ciphertext 1's of node 1 by that node's share of the last epoch and
    ciphertext 2's of node 0 by infinity, at the checks only: each
    rejected, the epoch failed, the combine (which reads the true shares)
    still right."""
    sim, sks = two_epochs["sim"], two_epochs["sks"]
    u_prev = two_epochs["epochs"][-1]["before"][0]
    random_pt = g1.to_affine([g1.mul(g1.G, 0xC0FFEE)])[0]
    replayed = g1.to_affine([g1.mul(u_prev[1], sks[1])])[0]
    checks = sim.epoch.checks
    f = len(FAULTY)

    def tampered(shares, U, W):
        shares = shares.clone()
        for slot, lane, pt in ((f + 0, 0, random_pt), (f + 1, 1, replayed), (f + 0, 2, None)):
            host = bls.infinity() if pt is None else (bls.FQ(pt[0]), bls.FQ(pt[1]), bls.FQ(1))
            words = limbs.points_to_limbs([host])
            shares[:, :, slot * N_CT + lane] = torch.from_numpy(words[:, :, 0])
        return checks(shares, U, W)

    before = sim.rejected_total
    sim.epoch.checks = tampered
    try:
        ok = sim.run(1)
    finally:
        sim.epoch.checks = checks
    v = sim.last_verdicts()
    assert ok is False
    assert v["quorum"][0, 0].tolist() == [False, True, False, True]
    assert v["quorum"][1, 0].tolist() == [True, False, True, True]
    assert not v["forged"].any() and v["ciphertext"].all()
    assert sim.rejected_total - before == N_CT + 3
    assert sim.oracle_check(range(N_CT))


def test_a_forgery_that_passes_fails_the_epoch(two_epochs):
    """The faulty node hands its own valid share U sk_3 in place of a
    forgery: the engine, which knows nothing of who forges, finds every
    share valid and rejects none, and the sim's verdict fails because a
    faulty node's share passed; the chain itself stays right."""
    sim, sks = two_epochs["sim"], two_epochs["sks"]
    us = g1.layout_points(sim.state())
    own = limbs.points_to_limbs([(bls.FQ(x), bls.FQ(y), bls.FQ(1))
                                 for x, y in g1.to_affine([g1.mul(u, sks[FAULTY[0]]) for u in us])])
    forged = sim._forged
    sim._forged = lambda acc, U: torch.from_numpy(own).to(U.device)
    before = sim.rejected_total
    try:
        ok = sim.run(1)
    finally:
        sim._forged = forged
    v = sim.last_verdicts()
    assert ok is False and sim.rejected_total == before
    assert v["forged"].all() and v["quorum"].all() and v["ciphertext"].all()
    assert sim.oracle_check(range(N_CT))


def test_verification_off_keeps_the_decrypt_epoch():
    """The default sim's engine is the decrypt engine itself, with the
    launches it had before the verified mode (4 nodes, seed 3)."""
    sim = ts.FullCryptoTensorSim(ts.FullCryptoConfig(n_nodes=4, instances=1, seed=3), device="cpu")
    assert type(sim.epoch) is decrypt_torch.DecryptEpoch and sim._W is None
    assert sim.epoch.launch_counts() == {
        "fq_point": {"dbl": 2, "ladd": 74, "mul": 4, "add": 1},
        "circuit": {"dblk6_add": 21, "add": 21, "straus": 1}}


def test_seeded_verified_sim_holds_valid_ciphertexts():
    """The seeded sim encrypts as crypto/threshold: e(G1, W) == e(U, H)
    for every ciphertext, on the host oracle; its W is what it holds."""
    cfg = ts.FullCryptoConfig(n_nodes=4, instances=2, seed=11, verify=True, faulty=1)
    _, _, u0, (ws, hs) = ts._seeded_ciphertexts(cfg, 1, 2)
    us = limbs.limbs_to_points(u0)
    assert all(bls.pairing_check_eq(bls.G1, w, u, h) for u, w, h in zip(us, ws, hs))
    sim = ts.FullCryptoTensorSim.instance_slice(cfg, 1, 2, device="cpu")
    assert isinstance(sim.epoch, verify_torch.VerifiedEpoch)
    assert sim.epoch.checks.slots == 3 and sim.epoch.n_ct == 4
    held = limbs.limbs_to_g2_points(limbs.g2_limbs_from_jax(sim.w_state()))
    assert all(bls.eq(a, b) for a, b in zip(held, ws))


def test_configuration_errors(monkeypatch):
    sks, master, u, h, w = _inputs(3)
    layout = g1.points_to_layout(u).reshape(1, N, 3, g1.N_LIMBS)
    g2_layout = g2.points_to_layout(w).reshape(1, N, 3, 2, g1.N_LIMBS)
    with pytest.raises(ValueError, match="W and H"):
        ts.FullCryptoTensorSim.from_jax(layout, sks, master, QUORUM, device="cpu",
                                        W=g2_layout, H=g2_layout[:, :2])
    with pytest.raises(ValueError, match="only where the sim verifies"):
        ts.FullCryptoTensorSim.from_jax(layout, sks, master, QUORUM, device="cpu", faulty=1)
    with pytest.raises(ValueError, match="overlap the quorum"):
        ts.FullCryptoTensorSim.from_jax(layout, sks, master, QUORUM, device="cpu",
                                        W=g2_layout, H=g2_layout, faulty=3)
    with pytest.raises(ValueError, match="forge from 3 quorum shares"):  # 7 nodes: t = 2
        ts.FullCryptoTensorSim(ts.FullCryptoConfig(n_nodes=7, instances=1, verify=True, faulty=4),
                               device="cpu")
    monkeypatch.setenv("HYDRABADGER_DECRYPT_T", "0")
    with pytest.raises(ValueError, match="decrypt engine"):
        ts.FullCryptoTensorSim.from_jax(layout, sks, master, QUORUM, device="cpu",
                                        W=g2_layout, H=g2_layout)
