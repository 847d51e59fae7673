"""The port's native ACS core (hydrabadger_tpu_torch/sim/native_acs.py, a
build of native/acs_engine.cpp into build/host_native/) against the JAX
package's binding of the same source.

JAX `tests/test_native_acs.py`'s five cases run on the port; on every input
of those cases the port's mask and stats equal JAX's.  Through the sim: an
8-node qhb run and a 16-node dhb removal era switch (the DKG plane off, the
host engine) on the native core commit the JAX package's native-core bytes,
eras and key sets; a native-core sim resumed from a snapshot commits the
uninterrupted run's bytes; eligibility follows JAX's rules; the opt-out and
a failing build raise where JAX falls back.
"""
import dataclasses

import pytest
import torch

from hydrabadger_tpu.sim import native_acs as jacs
from hydrabadger_tpu.sim import network as jnet
from hydrabadger_tpu_torch import checkpoint as ckpt
from hydrabadger_tpu_torch.crypto import dkg
from hydrabadger_tpu_torch.sim import native_acs
from hydrabadger_tpu_torch.sim import network
from hydrabadger_tpu_torch.utils import host_native


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _payloads(n, size=48, tag=b"p"):
    return [bytes([i]) * size + tag for i in range(n)]


# -- JAX tests/test_native_acs.py on the port -----------------------------


def test_mask_covers_quorum_and_round_trips():
    n, f = 8, 2
    mask, stats = native_acs.acs_run(_payloads(n), f, b"sid-1", seed=7)
    assert len(mask) == n
    assert sum(mask) >= n - f
    assert stats.delivered > 0


def test_deterministic_under_seed():
    n, f = 8, 2
    a, _ = native_acs.acs_run(_payloads(n), f, b"sid-2", seed=42)
    b, _ = native_acs.acs_run(_payloads(n), f, b"sid-2", seed=42)
    assert a == b


def test_large_payloads_exercise_coding_path():
    n, f = 10, 3
    payloads = [bytes((i * 31 + j) % 256 for j in range(100_000)) for i in range(n)]
    mask, stats = native_acs.acs_run(payloads, f, b"sid-big", seed=3)
    assert sum(mask) >= n - f
    assert stats.delivered > 0


def test_unequal_payload_sizes():
    n, f = 7, 2
    payloads = [bytes([i]) * (1 + 977 * i) for i in range(n)]
    mask, _ = native_acs.acs_run(payloads, f, b"sid-uneq", seed=9)
    assert sum(mask) >= n - f


def test_sim_agreement_and_totality_through_engine():
    net = network.SimNetwork(network.SimConfig(n_nodes=8, protocol="qhb", txns_per_node_per_epoch=3,
                                               txn_bytes=8, seed=11, engine="cpu"))
    assert net._native_eligible()
    m = net.run(6)
    assert m.agreement_ok
    assert m.txns_committed == 8 * 3 * 6


# -- the port's build against JAX's -----------------------------------------


INPUTS = {
    "quorum": (_payloads(8), 2, b"sid-1", True, 7),
    "seeded": (_payloads(8), 2, b"sid-2", True, 42),
    "big": ([bytes((i * 31 + j) % 256 for j in range(100_000)) for i in range(10)], 3, b"sid-big",
            True, 3),
    "unequal": ([bytes([i]) * (1 + 977 * i) for i in range(7)], 2, b"sid-uneq", True, 9),
    "unshuffled": (_payloads(16, size=300), 5, b"hb/4", False, 1_000_003 * 5 + 4),
}


@pytest.mark.parametrize("case", sorted(INPUTS))
def test_mask_and_stats_equal_the_jax_build(case):
    payloads, f, sid, shuffle, seed = INPUTS[case]
    assert jacs.available(), "the JAX package's native ACS build is missing"
    mask, stats = native_acs.acs_run(payloads, f, sid, shuffle=shuffle, seed=seed)
    jmask, jstats = jacs.acs_run(payloads, f, sid, shuffle=shuffle, seed=seed)
    assert mask == jmask
    assert (stats.delivered, stats.faults, stats.extra_rounds) == (
        jstats.delivered, jstats.faults, jstats.extra_rounds)
    assert host_native.ACS.dest.parent.name == "host_native"


def _qhb_batches(sim, nid):
    return [(b.epoch, tuple((p, tuple(bytes(t) for t in v))
                            for p, v in sorted(b.contributions.items())))
            for b in sim.nodes[nid].batches]


def test_qhb_sim_commits_the_jax_native_batches():
    kw = dict(n_nodes=8, protocol="qhb", txns_per_node_per_epoch=3, txn_bytes=8, seed=11,
              native_acs=True)
    sim = network.SimNetwork(network.SimConfig(engine="cpu", **kw))
    m = sim.run(6)
    jsim = jnet.SimNetwork(jnet.SimConfig(engine="cpu", **kw))
    jm = jsim.run(6)
    assert m.agreement_ok and jm.agreement_ok
    for nid in sim.ids:
        assert _qhb_batches(sim, nid) == _qhb_batches(jsim, nid)
    assert (m.txns_committed, m.messages_delivered, m.bytes_committed, m.faults) == (
        jm.txns_committed, jm.messages_delivered, jm.bytes_committed, jm.faults)
    assert m.messages_delivered > 0 and sim.census.history


def _dhb_removal(net_mod, **kw):
    """Config 5's leg at 16 nodes on the native core: a bootstrap epoch, a
    removal vote for the last node from every other, epochs until every
    survivor is in the new era, two steady epochs."""
    sim = net_mod.SimNetwork(net_mod.SimConfig(
        n_nodes=16, protocol="dhb", txns_per_node_per_epoch=4, txn_bytes=2, seed=7, engine="cpu",
        native_acs=True, **kw))
    sim.run(1)
    victim = sim.ids[-1]
    for nid in sim.ids[:-1]:
        sim.router.dispatch_step(nid, sim.nodes[nid].vote_to_remove(victim))
    for _ in range(8):
        sim.run(1)
        if all(sim.nodes[nid].era > 0 for nid in sim.ids[:-1]):
            break
    m = sim.run(2)
    return {
        "batches": {nid: [(b.epoch, b.era, b.change,
                           tuple((p, bytes(v)) for p, v in sorted(b.contributions.items())))
                          for b in sim.nodes[nid].batches] for nid in sim.ids},
        "eras": {nid: sim.nodes[nid].era for nid in sim.ids},
        "pk_set": {nid: sim.nodes[nid].netinfo.pk_set.to_bytes() for nid in sim.ids},
        "validators": {nid: tuple(sim.nodes[nid].netinfo.node_ids) for nid in sim.ids},
        "counts": (m.epochs_done, m.messages_delivered, m.bytes_committed, m.faults,
                   m.agreement_ok),
        "faults": [(s, f.node_id, f.kind) for s, f in sim.router.faults],
    }


def test_dhb_removal_commits_the_jax_native_bytes():
    dkg.clear_caches()
    ours = _dhb_removal(network, tpu_dkg=False)
    theirs = _dhb_removal(jnet, tpu_dkg=False)
    assert ours == theirs
    survivors = tuple(f"n{i:03d}" for i in range(15))
    assert all(era > 0 for era in ours["eras"].values())
    assert all(ours["validators"][nid] == survivors for nid in survivors)
    assert ours["counts"][4] and ours["counts"][1] > 0


def test_resumed_native_sim_commits_the_uninterrupted_bytes():
    """A 4-node dhb removal on the native core, snapshotted two epochs after
    the vote and resumed: the uninterrupted run's bytes and eras."""
    def voted():
        sim = network.SimNetwork(network.SimConfig(n_nodes=4, protocol="dhb", seed=19,
                                                   engine="cpu", native_acs=True))
        sim.run(1)
        for nid in sim.ids[:-1]:
            sim.nodes[nid].vote_to_remove(sim.ids[-1])
        return sim

    straight = voted()
    straight.run(5)
    interrupted = voted()
    interrupted.run(2)
    assert all(d.key_gen is not None for d in interrupted.nodes.values())  # the DKG is live
    resumed = ckpt.sim_from_bytes(ckpt.sim_to_bytes(interrupted))
    resumed.run(3)
    for nid in straight.ids:
        assert resumed.batch_bytes(nid) == straight.batch_bytes(nid)
        assert resumed.nodes[nid].era == straight.nodes[nid].era > 0
    assert resumed.router.delivered == straight.router.delivered > 0


@pytest.mark.parametrize("kw", [
    {}, {"protocol": "dhb"}, {"rbc_variant": "lowcomm"}, {"trace": True}, {"meter_bytes": True},
    {"encrypt": True}, {"coin_mode": "threshold"}, {"native_acs": False},
])
def test_eligibility_follows_the_jax_rules(kw):
    cfg = dict(n_nodes=4, seed=1, **kw)
    ours = network.SimNetwork(network.SimConfig(engine="cpu", **cfg))._native_eligible()
    theirs = jnet.SimNetwork(jnet.SimConfig(engine="cpu", **cfg))._native_eligible()
    assert ours == theirs


def test_the_opt_out_and_a_failing_build_raise(monkeypatch, tmp_path):
    monkeypatch.setenv("HYDRABADGER_NO_NATIVE_ACS", "1")
    assert native_acs.available() is False
    sim = network.SimNetwork(network.SimConfig(n_nodes=4, engine="cpu"))
    assert sim._native_eligible() is False
    m = sim.run(1)  # the Python cores
    assert m.agreement_ok and m.epochs_done == 1
    with pytest.raises(RuntimeError, match="opts out"):
        network.SimNetwork(network.SimConfig(n_nodes=4, engine="cpu", native_acs=True)).run(1)
    monkeypatch.delenv("HYDRABADGER_NO_NATIVE_ACS")
    monkeypatch.setenv("CXX", "false")
    broken = dataclasses.replace(host_native.ACS, dest=tmp_path / "libacs.so")
    with pytest.raises(RuntimeError, match="native ACS build failed"):
        broken.build()
    monkeypatch.setattr(host_native, "ACS", broken)
    monkeypatch.setattr(native_acs, "_LIB", None)
    with pytest.raises(RuntimeError, match="native ACS build failed"):
        native_acs.available()
    assert not (tmp_path / "libacs.so").exists()
