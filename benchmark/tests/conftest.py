"""A copy of the benchmark with two tiny cells the CPU can run.

`rs-tiny`: hb64 at 2 instances (the plain GF product on the CPU);
`tpke-tiny`: hb64-tpke cut to 4 nodes, t = 1, 2 instances.  Only the
copy's BENCHMARK.json and two new data files differ from the benchmark.
"""
import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


def tiny_copy(dst: Path) -> Path:
    shutil.copytree(REPO / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    spec = json.loads((dst / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "benchmark/configs/hb64-tpke.json").read_text())
    cfg.update(name="hb4-tpke", n_nodes=4, f=1, threshold=1, quorum=2)
    (dst / "benchmark/configs/hb4-tpke.json").write_text(json.dumps(cfg))
    (dst / "benchmark/workloads/tiny2.json").write_text(
        json.dumps({"instances": 2, "txns_per_node": 1}))
    spec["configs"].append({"name": "hb4-tpke", "source": "a test's cut of hb64-tpke",
                            "file": "benchmark/configs/hb4-tpke.json", "reduced": ["n_nodes"],
                            "why": "test"})
    spec["workloads"] += [
        {"name": "rs-tiny", "config": "hb64", "traffic": "tiny2", "chips": 1, "why": "test"},
        {"name": "tpke-tiny", "config": "hb4-tpke", "traffic": "tiny2", "chips": 1, "why": "test"},
    ]
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return tiny_copy(tmp_path_factory.mktemp("bench"))
