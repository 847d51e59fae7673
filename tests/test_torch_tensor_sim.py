"""The port's fast-path tensor simulator against the JAX package's, the
device rule, and the rule that the port imports nothing of JAX."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hydrabadger_tpu.sim import tensor as jts
from hydrabadger_tpu_torch import device as port_device
from hydrabadger_tpu_torch.sim import tensor as ts

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "hydrabadger_tpu_torch"


def _cfgs(n_nodes, instances, shard_len, seed=0):
    return (
        ts.TensorSimConfig(n_nodes=n_nodes, instances=instances, shard_len=shard_len, seed=seed),
        jts.TensorSimConfig(n_nodes=n_nodes, instances=instances, shard_len=shard_len, seed=seed),
    )


@pytest.mark.parametrize("n_nodes,instances,shard_len", [(7, 4, 8), (64, 2, 12)])
def test_state_equals_jax_tensor_sim_after_three_epochs(n_nodes, instances, shard_len):
    cfg, jcfg = _cfgs(n_nodes, instances, shard_len)
    assert (cfg.f, cfg.data_shards, cfg.parity_shards) == (
        jcfg.f, jcfg.data_shards, jcfg.parity_shards)
    assert np.array_equal(ts._initial_proposals(cfg), jts._initial_proposals(jcfg))
    sim, jsim = ts.TensorSim(cfg, device="cpu"), jts.TensorSim(jcfg)
    assert sim.run(3) is True and jsim.run(3) is True
    assert np.array_equal(sim.state(), np.asarray(jsim._state))
    assert sim.committed_bytes_per_epoch() == jsim.committed_bytes_per_epoch()


def test_from_jax_state_resumes_identically():
    cfg, jcfg = _cfgs(7, 3, 8, seed=5)
    jsim = jts.TensorSim(jcfg)
    assert jsim.run(2)
    sim = ts.TensorSim.from_jax_state(np.asarray(jsim._state), cfg, device="cpu")
    assert sim.run(2) and jsim.run(2)
    assert np.array_equal(sim.state(), np.asarray(jsim._state))
    with pytest.raises(ValueError):
        ts.TensorSim.from_jax_state(np.zeros((1, 7, 3, 8), np.uint8), cfg, device="cpu")


def test_cpu_fast_path_epoch_matches_jax_oracle_and_device_epoch():
    cfg, jcfg = _cfgs(7, 3, 8, seed=2)
    proposals = ts._initial_proposals(cfg)
    k, p = cfg.data_shards, cfg.parity_shards
    oracle = ts.cpu_fast_path_epoch(proposals, k, p)
    assert np.array_equal(oracle, jts.cpu_fast_path_epoch(proposals, k, p))
    assert np.array_equal(oracle, proposals)  # totality: the decode is the proposals
    decoded, ok = ts.epoch(torch.from_numpy(proposals), k, p)
    assert bool(ok.all()) and np.array_equal(decoded.numpy(), oracle)


def test_corruption_is_detected():
    cfg, _ = _cfgs(7, 2, 8)
    k, p = cfg.data_shards, cfg.parity_shards
    proposals = ts._initial_proposals(cfg)
    bad = proposals.copy()
    bad[0, 0, 0, 0] ^= 0xFF
    decoded, _ = ts.epoch(torch.from_numpy(bad), k, p)
    ok = (decoded.numpy() == proposals).reshape(cfg.instances, -1).all(axis=1)
    assert not ok[0] and ok[1]
    state, ok_all = ts.run_epochs(torch.from_numpy(proposals), k, p, 0)
    assert bool(ok_all) and np.array_equal(state.numpy(), proposals)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_device.resolve_device()
    with pytest.raises(RuntimeError):
        ts.TensorSim(ts.TensorSimConfig(n_nodes=4, instances=1, shard_len=4))
    assert port_device.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        port_device.resolve_device("meta")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_sources_import_neither_jax_nor_the_jax_package():
    banned = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "hydrabadger_tpu"):
                    banned.append(f"{path.relative_to(REPO)}: {name}")
    assert not banned


def test_importing_the_port_loads_no_jax():
    mods = [
        "hydrabadger_tpu_torch." + str(p.relative_to(PORT).with_suffix("")).replace(os.sep, ".")
        for p in sorted(PORT.rglob("*.py"))
        if p.name != "__init__.py"
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')"
        " or m == 'hydrabadger_tpu' or m.startswith('hydrabadger_tpu.')]\n"
        "assert not bad, bad\n"
        "import hydrabadger_tpu_torch.ops._kernels as k\n"
        "assert not k._loaded\n"
        "print(len(sys.modules))\n"
    )
    env = {key: v for key, v in os.environ.items() if key != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    for name in ("crypto.bls12_381", "crypto.threshold", "ops.limbs", "ops.fq_torch",
                 "ops.fp12_circuit", "ops.circuit_torch", "ops.decrypt_torch", "sim.tensor"):
        assert "hydrabadger_tpu_torch." + name in mods



def test_trace_epoch_on_cpu_reports_no_device_time():
    from hydrabadger_tpu_torch.sim import trace_epoch

    assert trace_epoch._union_us([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0
    cfg, _ = _cfgs(7, 2, 8)
    got = trace_epoch.trace(cfg, 2, device="cpu")
    assert got["device"] == "cpu" and got["epochs"] == 2 and got["wall_ms"] > 0
    assert got["device_busy_ms"] is None and got["device_idle_share"] is None
