"""The port's QueueingHoneyBadger simulator against the JAX package's.

`SimNetwork(engine="cpu", native_acs=False)` in the port and in the JAX
package, on the same config, commit the same batches on every
node, byte for byte, with equal `messages_delivered`, `txns_committed` and
`faults`: the protocol tier (both broadcast variants, two seeds), the full
crypto tier (threshold encryption and the threshold coin, shares verified
and not), and a drop adversary.  The GPU engine on the CPU (kernel B1's
plain version for the low-comm sketches) equals the host engine.  Entry
points default to the card and raise without one; `native_acs=True` on a
config the native core cannot run raises the JAX sim's ValueError (the
native core is tests/test_torch_native_acs.py's, DynamicHoneyBadger
tests/test_torch_dhb.py's); the CLI's JSON line has the JAX CLI's keys.
"""
import json

import pytest
import torch

from hydrabadger_tpu.sim import __main__ as jcli
from hydrabadger_tpu.sim import network as jnet
from hydrabadger_tpu_torch.crypto import engine
from hydrabadger_tpu_torch.ops import homhash_torch
from hydrabadger_tpu_torch.sim import __main__ as cli
from hydrabadger_tpu_torch.sim import network


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run many tiny ops: one thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jax_batches(net, nid):
    return [(b.epoch, tuple((p, tuple(bytes(t) for t in v)) for p, v in sorted(b.contributions.items())))
            for b in net.nodes[nid].batches]


def run_both(engine_spec="cpu", jax_adversary=None, adversary=None, **kw):
    jsim = jnet.SimNetwork(jnet.SimConfig(engine="cpu", native_acs=False, adversary=jax_adversary, **kw))
    jm = jsim.run()
    sim = network.SimNetwork(network.SimConfig(engine=engine_spec, native_acs=False,
                                               adversary=adversary, **kw))
    m = sim.run()
    return jsim, jm, sim, m


def assert_same(jsim, jm, sim, m, epochs):
    assert m.agreement_ok and jm.agreement_ok
    assert m.epochs_done == jm.epochs_done == epochs
    for nid in sim.ids:
        assert sim.batch_bytes(nid) == jax_batches(jsim, nid)
    assert (m.messages_delivered, m.txns_committed, m.bytes_committed, m.faults) == (
        jm.messages_delivered, jm.txns_committed, jm.bytes_committed, jm.faults)


@pytest.mark.parametrize("variant", ["bracha", "lowcomm"])
@pytest.mark.parametrize("seed", [0, 11])
def test_protocol_tier_commits_the_jax_batches(seed, variant):
    assert_same(*run_both(n_nodes=4, epochs=3, seed=seed, rbc_variant=variant), 3)


@pytest.mark.parametrize("verify", [False, True])
def test_full_crypto_tier_commits_the_jax_batches(verify):
    jsim, jm, sim, m = run_both(n_nodes=4, epochs=1, seed=0, encrypt=True, coin_mode="threshold",
                                verify_shares=verify, rbc_variant="lowcomm")
    assert_same(jsim, jm, sim, m, 1)
    assert m.txns_committed == 20


def test_gpu_engine_on_the_cpu_equals_the_host_engine():
    kw = dict(n_nodes=4, epochs=2, seed=3, rbc_variant="lowcomm", native_acs=False)
    host = network.SimNetwork(network.SimConfig(engine="cpu", **kw))
    host.run()
    before = sum(homhash_torch.calls.values())
    gpu = network.SimNetwork(network.SimConfig(engine=engine.GpuEngine(device="cpu"), **kw))
    m = gpu.run()
    assert m.agreement_ok and m.epochs_done == 2
    for nid in gpu.ids:
        assert gpu.batch_bytes(nid) == host.batch_bytes(nid)
    assert gpu.router.delivered == host.router.delivered
    assert sum(homhash_torch.calls.values()) > before  # the sketches went through ops/homhash_torch


def test_drop_adversary_run_equals_the_jax_run():
    kw = dict(n_nodes=4, epochs=3, seed=2, rbc_variant="bracha")
    jsim, jm, sim, m = run_both(jax_adversary=jnet.drop_adversary(0.05, 2),
                                adversary=network.drop_adversary(0.05, 2), **kw)
    assert m.agreement_ok
    assert m.epochs_done == jm.epochs_done
    for nid in sim.ids:
        assert sim.batch_bytes(nid) == jax_batches(jsim, nid)
    assert (m.messages_delivered, m.txns_committed, m.faults) == (
        jm.messages_delivered, jm.txns_committed, jm.faults)


@pytest.mark.parametrize("make", [
    lambda: network.delay_adversary(0.2, seed=1), lambda: network.duplicate_adversary(0.2, 1),
    lambda: network.crash_adversary(["n003"]), lambda: network.byzantine_adversary(["n002"], 4),
])
def test_agreement_survives_the_canned_adversaries(make):
    m = network.SimNetwork(network.SimConfig(n_nodes=4, epochs=2, seed=1, engine="cpu",
                                             adversary=make())).run()
    assert m.agreement_ok and m.epochs_done == 2


def test_the_card_is_the_default_and_raises_without_one(monkeypatch):
    assert network.SimConfig().engine == "gpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delitem(engine._INSTANCES, "gpu", raising=False)
    with pytest.raises(RuntimeError, match="cuda"):
        network.SimNetwork(network.SimConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--nodes", "4", "--epochs", "1"])


@pytest.mark.parametrize("field,value", [("native_acs", True)])
def test_what_is_not_ported_raises(field, value):
    """native_acs=True on a config the native core cannot run (encryption)
    raises the JAX sim's ValueError at the first epoch, in both packages."""
    kw = dict(n_nodes=4, encrypt=True, **{field: value})
    for sim in (network.SimNetwork(network.SimConfig(engine="cpu", **kw)),
                jnet.SimNetwork(jnet.SimConfig(engine="cpu", **kw))):
        with pytest.raises(ValueError, match="native_acs=True requires fast tier"):
            sim.run(1)


def test_cli_json_line_has_the_jax_cli_keys(capsys):
    argv = ["--engine", "cpu", "--nodes", "4", "--epochs", "2", "--rbc", "lowcomm", "--json"]
    assert cli.main(argv) == 0
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jcli.main(argv) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(ours) == sorted(theirs)
    assert ours["agreement_ok"] and ours["epochs_done"] == 2


def test_byte_meter_and_trace_equal_the_jax_ones():
    """The router's codec byte meter (by kind) and the recorded spans and
    wire events, every attribute but the clock's."""
    kw = dict(n_nodes=4, epochs=1, seed=4, rbc_variant="lowcomm", meter_bytes=True, trace=True,
              trace_wire_sample=1)
    jsim, jm, sim, m = run_both(**kw)
    assert m.bytes_tx_total > 0 and m.bytes_rx_by_kind.get("bc_echo_lc", 0) > 0
    assert (m.bytes_tx_total, m.bytes_rx_total, m.bytes_rx_by_kind) == (
        jm.bytes_tx_total, jm.bytes_rx_total, jm.bytes_rx_by_kind)
    assert sim.metrics.counter("bytes_tx_total").value == m.bytes_tx_total

    def events(net):
        return [(e.name, e.phase, sorted(e.attrs.items())) for e in net.recorder.events]

    ours = events(sim)
    assert ours == events(jsim)
    assert {"rbc", "ba", "subset", "epoch", "wire_tx", "wire_rx"} <= {name for name, _p, _a in ours}
