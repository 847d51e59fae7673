"""BENCHMARK.json against the contract's form, and cells, configurations
and metrics found by name, so that a new one is files of its own."""
import hashlib
import json
import re

from benchmark.run import cell_parts, load_module, load_spec, metrics_of, run_cell
from benchmark.tests.conftest import REPO, tiny_copy

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = ["rs64-inst1024", "tpke64-inst64", "tpke64-inst1", "rs64-batch64k"]


def test_names_and_units():
    spec = load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]]
    names += [w[k] for w in spec["workloads"] for k in ("config", "traffic")]
    metrics = spec["end_to_end"] + spec["per_layer"]
    names += [m["name"] for m in metrics] + [k for c in spec["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in spec[group]}) == len(spec[group])
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in spec["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"} for w in spec["workloads"])
    for text in [c[k] for c in spec["configs"] for k in ("source", "why")] + [
            w["why"] for w in spec["workloads"]] + [m["layer"] for m in spec["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(json.dumps(spec)) < 64 * 1024


def test_the_four_cells_load():
    spec = load_spec()
    assert [w["name"] for w in spec["workloads"]] == CELLS
    assert {c["name"] for c in spec["configs"]} == {"hb64", "hb64-tpke"}
    for cell in CELLS:
        entry, config, traffic = cell_parts(spec, cell)
        assert entry["chips"] == 1 and len(entry["why"]) <= 200
        assert config["name"] == entry["config"] and config["n_nodes"] == 64
        driver = load_module("drivers", config["driver"]).Driver(config, traffic, 1, "cpu")
        assert driver.contributions_per_epoch == traffic["instances"] * 64
        e2e, layer = metrics_of(spec, cell)
        reported = {m["name"] for m in e2e}
        assert "setup_s" in reported and len(reported) >= 2 and layer
        for m in e2e + layer:
            assert callable(load_module("metrics", m["name"]).read)


def test_bounds_and_window():
    spec = load_spec()
    assert 1 <= spec["run_seconds"] <= 51
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in spec["end_to_end"] if m["name"] == "setup_s")["bound"] == 0.25
    for m in spec["per_layer"]:
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
    # a full check of 24 cells fits its 43,200 s
    runs, cells = 2 + 14 * 24, 24
    assert runs * (spec["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_and_metric_are_files_of_their_own(tmp_path):
    root = tiny_copy(tmp_path)
    before = _digests(root)
    (root / "benchmark/workloads/one-net.json").write_text(
        json.dumps({"instances": 1, "txns_per_node": 1}))
    (root / "benchmark/metrics/epochs_in_window.py").write_text(
        "def read(ctx):\n    return float(ctx.epochs)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "rs64-one", "config": "hb64", "traffic": "one-net",
                              "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "epochs_in_window", "unit": "epochs", "better": "higher",
                               "bound": 0.05, "source": "host_clock", "workloads": ["rs64-one"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    r = run_cell("rs64-one", 11, 1e9, False, device="cpu", root=root, max_epochs=2)
    assert r["correct"] and r["metrics"]["epochs_in_window"]["value"] == 2.0
    assert set(r["metrics"]) == {"commit_rate", "epoch_p95_ms", "setup_s", "epochs_in_window"}
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before  # nothing edited
    assert REPO.joinpath("benchmark/workloads/one-net.json").exists() is False
