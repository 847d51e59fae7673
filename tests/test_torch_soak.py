"""The port's soak tiers (hydrabadger_tpu_torch/sim/soak.py) against the JAX
package's at the same arguments, on the host engine at small sizes.

Each tier's deterministic fields equal the JAX soak's: bytes per epoch and
by kind, the state census rows at era 0 and at the end, injections and
observed faults, epochs, queue peaks and agreement.  The sim and era tiers
run on the native ACS core in both packages, the JAX soak's on its host
engine.  The CLI writes its `--out`, by default SOAK_torch.json, and never
SOAK.json.
"""
import functools
import json
import os

import pytest
import torch

from hydrabadger_tpu.sim import network as jnetwork
from hydrabadger_tpu.sim import soak as jsoak
from hydrabadger_tpu_torch.sim import soak

CPU = {"engine": "cpu", "device": "cpu"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def jax_host_engine(monkeypatch):
    """The JAX soak's sims on the host engine."""
    monkeypatch.setattr(jnetwork, "SimConfig", functools.partial(jnetwork.SimConfig, engine="cpu"))


def _pick(row: dict, keys) -> dict:
    return {k: row[k] for k in keys}


def test_rbc_soak_equals_the_jax_soak():
    ours = soak.rbc_soak(epochs=1, n_nodes=4, **CPU)
    theirs = jsoak.rbc_soak(epochs=1, n_nodes=4)
    keys = ("tier", "epochs", "bytes_per_epoch_bracha", "bytes_per_epoch_lowcomm",
            "bytes_rx_by_kind_bracha", "bytes_rx_by_kind_lowcomm", "bytes_reduction",
            "batches_point_identical", "agreement_ok")
    assert _pick(ours, keys) == _pick(theirs, keys)
    assert ours["bytes_reduction"] > 0
    # the port pads nothing: every lane of the twin's dispatch is real
    assert ours["homhash_lane_occupancy"] == 1.0


def test_era_soak_equals_the_jax_soak(jax_host_engine):
    kw = dict(n_nodes=4, steady_epochs=2, eras=1)
    ours = soak.era_soak(**kw, **CPU)
    theirs = jsoak.era_soak(**kw)
    keys = ("tier", "epochs", "eras_crossed", "era_epochs_to_switch", "era_switch_epochs",
            "census_era0", "census_final", "census_flat", "shadow_dkg_stall_epochs",
            "agreement_ok")
    assert _pick(ours, keys) == _pick(theirs, keys)
    assert any(k.startswith("DynamicHoneyBadger.") for k in ours["census_final"])
    assert ours["device_backend"] == "none"  # a CPU run never claims a card


def test_sim_soak_equals_the_jax_soak(jax_host_engine):
    ours = soak.sim_soak(epochs=10, n_nodes=4, **CPU)
    theirs = jsoak.sim_soak(epochs=10, n_nodes=4)
    assert ours["tier"] == theirs["tier"] == "sim_native_acs"
    keys = ("epochs", "max_deferred", "queue_peaks", "agreement_ok")
    assert _pick(ours, keys) == _pick(theirs, keys)
    assert ours["metrics"]["counters"] == theirs["metrics"]["counters"]
    assert sorted(ours["metrics"]["gauges"]) == sorted(theirs["metrics"]["gauges"])


def test_slo_soak_equals_the_jax_soak():
    ours = soak.slo_soak(epochs=2, n_nodes=4, **CPU)
    theirs = jsoak.slo_soak(epochs=2, n_nodes=4)
    assert _pick(ours, ("tier", "epochs", "agreement_ok")) == _pick(
        theirs, ("tier", "epochs", "agreement_ok"))
    for leg in ("honest", "chaos"):
        keys = ("count", "submitted", "resubmitted", "slo_violations")
        assert _pick(ours[leg], keys) == _pick(theirs[leg], keys)
    assert ours["chaos"]["ring_sample"].split(":")[0] == theirs["chaos"]["ring_sample"].split(":")[0]


def test_byz_soak_equals_the_jax_soak():
    ours = soak.byz_soak(epochs=2, n_nodes=4, **CPU)
    theirs = jsoak.byz_soak(epochs=2, n_nodes=4)
    keys = ("tier", "n_byzantine", "epochs", "queue_peaks", "byz_injected", "byz_faults",
            "agreement_ok")
    assert _pick(ours, keys) == _pick(theirs, keys)
    assert ours["byz_injected"] and ours["byz_faults"]


def test_cli_writes_its_out_and_never_soak_json(tmp_path, monkeypatch, capsys):
    repo_soak = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "SOAK.json")
    before = open(repo_soak, "rb").read()
    monkeypatch.chdir(tmp_path)
    assert soak.main(["--era-only", "--era-nodes", "4", "--engine", "cpu",
                      "--device", "cpu"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["tier"] == "era_switch_4node_shadow_dkg" and row["census_flat"]
    assert sorted(os.listdir(tmp_path)) == ["SOAK_torch.json"]
    with open(tmp_path / "SOAK_torch.json") as fh:
        assert json.load(fh) == [row]
    out = tmp_path / "rows.json"
    assert soak.main(["--era-only", "--era-nodes", "4", "--engine", "cpu", "--device", "cpu",
                      "--out", str(out)]) == 0
    assert out.exists() and not (tmp_path / "SOAK.json").exists()
    assert open(repo_soak, "rb").read() == before
    if not torch.cuda.is_available():  # the tiers' default is the card
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            soak.rbc_soak(epochs=1, n_nodes=4)
