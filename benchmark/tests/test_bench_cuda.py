"""Every cell on the card for two seconds: a result line that keeps the contract.

Run on a host with a card: `python -m pytest benchmark/tests/test_bench_cuda.py`.
It decides inside the test whether there is a card, and skips here."""
import json
import subprocess
import sys

import pytest

from benchmark.run import load_spec, metrics_of
from benchmark.tests.conftest import REPO


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in load_spec(REPO)["workloads"]])
def test_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cells run the program's hand-written kernels")
    for trace in (0, 1):
        out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell,
                              "--seed", str(2**31 + 99), "--seconds", "2", "--trace", str(trace)],
                             cwd=REPO, capture_output=True, text=True, timeout=1200)
        assert out.returncode == 0, out.stderr[-4000:]
        r = json.loads(out.stdout.strip().splitlines()[-1])
        assert list(r)[-1] == "checks" and r["correct"], r["checks"]
        assert r["attempted"] > 0 and r["failed"] == 0
        assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
        e2e, layer = metrics_of(load_spec(REPO), cell)
        want = {m["name"] for m in (layer if trace else e2e)}
        assert set(r["metrics"]) == want
        if trace:
            assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
            assert len(r["breakdown"]["device_ops"]) <= 10
