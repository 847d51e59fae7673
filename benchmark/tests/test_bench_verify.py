"""The verified configuration's yardstick: the reference pairing, the
closed forms of driver `tpke_byz` held to it, `work_verify` against a hand
count, and runs of a tiny cell of hb64-tpke-byz (4 nodes, f = 1, one
instance) on the CPU: a sound run correct, a program that accepts every
share not, and the control failing exactly `verdicts_wrong` and
`rejections_not_total`."""
import json

import pytest

from benchmark.reference import g1, g2
from benchmark.reference import pairing as ref
from benchmark.run import cell_parts, load_module, load_spec, metrics_of, run_cell
from benchmark.tests.conftest import REPO, tiny_copy
from benchmark.yardstick import work_tpke, work_verify

G1 = (g1.G[0], g1.G[1])
G2 = (g2.G[0], g2.G[1])


def _g1(k):
    return g1.to_affine([g1.mul(g1.G, k)])[0]


def _g2(k):
    return g2.to_affine([g2.mul(g2.G, k)])[0]


def test_the_new_cell_loads():
    """pairing64-verify as test_bench_discovery holds the first four cells:
    one chip, its configuration and traffic found by name, every metric it
    reports a reader; it reports the new per-layer metrics and the
    accepted ones without a list, not the other rooflines."""
    spec = load_spec()
    entry, config, traffic = cell_parts(spec, "pairing64-verify")
    assert entry["chips"] == 1 and config["name"] == entry["config"] == "hb64-tpke-byz"
    assert config["n_nodes"] == 64 and config["faulty"] == list(range(43, 64))
    assert config["reduced"] == ["hash_to_g2_per_epoch"] and traffic["instances"] == 8
    assert config["hash_to_g2_per_epoch"] == 0
    assert next(c for c in spec["configs"] if c["name"] == "hb64-tpke-byz")["reduced"] == [
        "hash_to_g2_per_epoch"]
    driver = load_module("drivers", config["driver"]).Driver(config, traffic, 1, "cpu")
    assert driver.contributions_per_epoch == 512
    e2e, layer = metrics_of(spec, "pairing64-verify")
    assert {m["name"] for m in e2e} == {"commit_rate", "epoch_p95_ms", "setup_s"}
    assert {m["name"] for m in layer} == {
        "verify_roofline", "unlisted_kernel_ms_per_epoch",
        "glue_ms_per_epoch", "launches_per_epoch", "device_idle_pct"}
    for m in e2e + layer:
        assert callable(load_module("metrics", m["name"]).read)
    assert work_verify.epoch(config, traffic)["bound_ms"] > 2.5


def test_the_reference_pairing_is_bilinear_and_nondegenerate():
    e = ref.pairing(G1, G2)
    assert e != ref.F12_ONE and ref.f12_pow(e, g1.R) == ref.F12_ONE
    a, b = 0x1234567, 0xABCDEF01
    assert ref.pairing(_g1(a), _g2(b)) == ref.f12_pow(e, a * b)
    assert ref.pairing(_g1(a), G2) == ref.pairing(G1, _g2(a))
    assert ref.f12_mul(ref.pairing(_g1(a), G2), ref.pairing(_g1(g1.R - a), G2)) == ref.F12_ONE
    assert ref.pairing(None, G2) == ref.F12_ONE
    assert ref.check_eq(_g1(a), _g2(b), _g1(a * b), G2)
    assert not ref.check_eq(_g1(a), _g2(b), _g1(a * b + 1), G2)


def test_the_tower_and_the_g2_arithmetic():
    x = ((3, 5), (7, 11), (13, 17)), ((19, 23), (29, 31), (37, 41))
    assert ref.f12_mul(x, ref.f12_inv(x)) == ref.F12_ONE
    assert ref.f12_frob(x) == ref.f12_pow(x, ref.P)
    assert ref.f12_mul(ref.W, ref.W_INV) == ref.F12_ONE
    assert g2.on_curve(g2.mul(g2.G, 99)) and g2.mul(g2.G, g2.R)[2] == g2.ZERO
    assert g2.to_affine([g2.add(g2.mul(g2.G, 5), g2.mul(g2.G, 7))]) == [_g2(12)]
    assert g2.to_affine(g2.quadratic_chain(3, 5, 7, 4)) == [_g2(3 + 5 * j + 7 * j * j)
                                                              for j in range(4)]
    pts = [_g2(9), _g2(10)]
    assert g2.lanes_differing(g2.layout_points(g2.points_to_layout(pts)), pts) == 0


def _tiny_byz(dst):
    root = tiny_copy(dst)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "benchmark/configs/hb64-tpke-byz.json").read_text())
    cfg.update(name="hb4-tpke-byz", n_nodes=4, f=1, threshold=1, quorum=2, faulty=[3])
    (root / "benchmark/configs/hb4-tpke-byz.json").write_text(json.dumps(cfg))
    (root / "benchmark/workloads/tiny1.json").write_text(
        json.dumps({"instances": 1, "txns_per_node": 1}))
    spec["configs"].append({"name": "hb4-tpke-byz", "source": "a test's cut of hb64-tpke-byz",
                            "file": "benchmark/configs/hb4-tpke-byz.json", "reduced": ["n_nodes"],
                            "why": "test"})
    spec["workloads"].append({"name": "byz-tiny", "config": "hb4-tpke-byz", "traffic": "tiny1",
                              "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root, cfg


@pytest.fixture(scope="module")
def tiny_byz(tmp_path_factory):
    return _tiny_byz(tmp_path_factory.mktemp("bench"))


def test_the_closed_forms_equal_the_reference(tiny_byz):
    root, cfg = tiny_byz
    d = load_module("drivers", "tpke_byz", root).Driver(cfg, {"instances": 1}, 2**33 + 3, "cpu")
    d.make_inputs()
    us = g1.layout_points(d.u0)
    ws = g2.layout_points(d.w0)
    hs = g2.to_affine(g2.layout_points(d.h))
    want = d.expected_verdicts()
    for j in (0, 3):
        r = ref.verified_epoch(us[j], ws[j], hs[j], d.sks, d.master, d.quorum, d.faulty)
        assert r["quorum"] == want["quorum"][:, 0, j].tolist() == [True, True]
        assert r["forged"] == want["forged"][:, 0, j].tolist() == [False]
        assert r["ciphertext"] is bool(want["ciphertext"][0, j]) is True
        r_h = (d.a + j * d.b) * (d.c + j * d.d)
        assert g2.to_affine([ws[j]]) == g2.to_affine([g2.mul(g2.G, r_h)])
        # E epochs of the reference's W step are the closed form's factor
        w = ws[j]
        for _ in range(2):
            w = ref.verified_epoch(us[j], w, hs[j], d.sks, d.master, d.quorum, [])["w_next"]
        assert g2.to_affine([w]) == [d.expected_w(g1.state_scalar(d.master, 2))[j]]


def test_work_model_against_a_hand_count():
    """N = 4, t = 1, f = 1: q = 2, three share checks and one ciphertext
    check per ciphertext."""
    fp_inv = 380 + 228  # p - 2: 381 bits, 229 of them set
    fp12_inv = 2 * 18 + (12 * 3 + 2 + fp_inv + 2) + 2 * 18
    miller = 63 * (36 + 2 * (39 + 24)) + 5 * 2 * (39 + 41)
    final = (fp12_inv + 54 + 15 + 54) + 5 * (63 * 18 + 5 * 54) + 10 * 54 + 3 * 15
    check = miller + final
    assert (fp_inv, miller, final, check) == (608, 11_006, 8_448, 19_454)
    ladder = 14 * 44 + 255 * 16 + 64 * 44
    per_ct = (work_tpke.products_per_ciphertext(2) + 4 * check + ladder + 4 * (fp_inv + 4)
              + (2 + fp_inv + 2 + 2 + 9) + 16)
    assert work_verify.products_per_ciphertext(2, 1) == per_ct
    w = work_verify.epoch({"threshold": 1, "faulty": [3], "n_nodes": 4}, {"instances": 2})
    assert w["ops"] == 8 * per_ct * 11_568 and w["bytes"] == 8 * (18 + 4 * 12) * 48


def _program(driver):
    driver.build_system()
    return driver.sim


def _run(root, system, epochs=1):
    return run_cell("byz-tiny", 2**33 + 29, 1e9, False, device="cpu", root=root,
                    max_epochs=epochs, system=system)


def test_sound_run_is_correct_and_accepting_every_share_is_not(tiny_byz):
    root, _ = tiny_byz
    r = _run(root, _program)
    assert r["correct"] and r["attempted"] == 1 and r["failed"] == 0, r["checks"]

    def accepts_every_share(driver):
        sim = _program(driver)
        checks = sim.epoch.checks
        sim.epoch.checks = lambda *a: checks(*a) | True
        return sim

    r = _run(root, accepts_every_share)
    assert not r["correct"] and r["failed"] == 1
    bad = {k for k, c in r["checks"].items() if c["value"] > c["limit"]}
    assert bad == {"verdicts_wrong", "rejections_not_total", "epochs_check_failed"}
    assert r["checks"]["verdicts_wrong"]["value"] == 4


def test_the_control_fails_exactly_the_verdicts_and_rejections(tiny_byz):
    root, _ = tiny_byz
    control = load_module("drivers", "tpke_byz", root).Control
    r = _run(root, control, 3)
    bad = {k: c["value"] for k, c in r["checks"].items() if c["value"] > c["limit"]}
    assert not r["correct"] and bad == {"verdicts_wrong": 4, "rejections_not_total": 12}


def test_the_metric_readers_find_nothing_without_their_sources(tiny_byz):
    """A run without a trace, or of another configuration, reads None, not
    an error."""
    from types import SimpleNamespace

    root, cfg = tiny_byz
    ctx = SimpleNamespace(config=cfg, traffic={"instances": 1}, device_events=[], epochs=1)
    assert load_module("metrics", "verify_roofline", root).read(ctx) is None
    assert load_module("metrics", "verify_roofline", root).read(
        SimpleNamespace(**{**vars(ctx), "config": {"n_nodes": 4}})) is None
