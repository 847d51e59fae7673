"""The port's adversarial scenario plane (sim/scenario.py, sim/byzantine.py)
against the JAX package's.

JAX tests/test_scenario.py case for case on the port (injection mechanics,
the fault-observability contract, liveness under attack, the per-sender
duplicate LRU), the low-comm equivocation case of tests/test_rbc_lowcomm.py
and the keygen_withhold case of tests/test_shadow_dkg.py.  Across the
packages: the same SimConfig and spec commit the same honest batches byte
for byte, inject the same counts, log the same (node, kind) faults and fold
the same byz_* counters; the observability registries are equal.
"""
import random

import pytest
import torch

from hydrabadger_tpu.consensus import types as JT
from hydrabadger_tpu.sim import network as jnet
from hydrabadger_tpu.sim import scenario as jscen
from hydrabadger_tpu_torch.consensus import types as T
from hydrabadger_tpu_torch.crypto import threshold as th
from hydrabadger_tpu_torch.obs.metrics import BYZ_FAULTS_PREFIX, MetricsRegistry
from hydrabadger_tpu_torch.sim import scenario as tscen
from hydrabadger_tpu_torch.sim.network import SimConfig, SimNetwork
from hydrabadger_tpu_torch.sim.scenario import (
    FAULT_OBSERVABLES,
    InjectionLog,
    LinkPolicy,
    PartitionWindow,
    ScenarioAdversary,
    ScenarioSpec,
    assert_observability,
    attack_spec,
    verify_observability,
)

pytestmark = pytest.mark.byz


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run many tiny ops: one thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def cfg(**kw):
    return SimConfig(engine="cpu", native_acs=False, **kw)


# -- injection mechanics -----------------------------------------------------


def _adv(spec, n=4):
    ids = [f"n{i:03d}" for i in range(n)]
    return ScenarioAdversary(spec, ids, metrics=MetricsRegistry()), ids


def test_link_drop_policy_counts_every_loss():
    adv, ids = _adv(ScenarioSpec(seed=1, default_link=LinkPolicy(drop=1.0)))
    for k in range(10):
        assert adv.inject(ids[0], ids[1], ("m", k)) == []
    assert adv.log.counts[T.BYZ_LINK_DROP] == 10
    assert adv.flush() == []  # drops are loss, not holds


def test_link_duplicate_policy_amplifies_and_counts():
    adv, ids = _adv(ScenarioSpec(seed=1, default_link=LinkPolicy(duplicate=1.0)))
    out = adv.inject(ids[0], ids[1], ("m", 0))
    assert out == [(ids[0], ids[1], ("m", 0))] * 2
    assert adv.log.counts[T.BYZ_LINK_DUP] == 1


def test_link_delay_holds_then_releases_without_loss():
    adv, ids = _adv(ScenarioSpec(seed=1, default_link=LinkPolicy(delay=1.0, delay_max=4)))
    held = [("m", k) for k in range(6)]
    released = []
    for msg in held:
        out = adv.inject(ids[0], ids[1], msg) or []
        released.extend(out)  # expired holds ride later enqueues
        assert msg not in [m for _s, _r, m in out]  # never same-tick
    released.extend(adv.flush())  # quiescence releases the rest
    assert sorted(m for _s, _r, m in released) == sorted(held)
    assert adv.log.counts[T.BYZ_LINK_DELAY] == 6


def test_first_matching_link_policy_wins():
    spec = ScenarioSpec(seed=1, links=((0, 1, LinkPolicy(drop=1.0)), (None, None, LinkPolicy())))
    adv, ids = _adv(spec)
    assert adv.inject(ids[0], ids[1], "x") == []  # severed link
    assert adv.inject(ids[1], ids[0], "y") is None  # reverse direction clean


def test_partition_window_severs_then_heals():
    spec = ScenarioSpec(seed=1, partitions=(PartitionWindow(groups=((0, 1), (2, 3)), start=0, heal=4),))
    adv, ids = _adv(spec)
    assert adv.inject(ids[0], ids[2], "cross") == []  # cross-group: held
    assert adv.inject(ids[0], ids[1], "intra") is None  # intra-group: delivered
    assert adv.log.counts[T.BYZ_PARTITION] == 1
    # enqueues 3 and 4 cross the heal boundary: the held frame re-emerges
    adv.inject(ids[1], ids[0], "a")
    out = adv.inject(ids[2], ids[3], "b") or []
    assert [(s, r, m) for s, r, m in out if m == "cross"] == [(ids[0], ids[2], "cross")]


def test_open_partition_heals_at_flush():
    spec = ScenarioSpec(seed=1, partitions=(PartitionWindow(groups=((0,), (1,)), start=0),))
    adv, ids = _adv(spec)
    assert adv.inject(ids[0], ids[1], "held") == []
    assert (ids[0], ids[1], "held") in adv.flush()


def test_scenario_and_adversary_mutually_exclusive():
    with pytest.raises(ValueError, match="mutually exclusive"):
        SimNetwork(cfg(n_nodes=4, seed=1, adversary=lambda s, r, m: None, scenario=ScenarioSpec()))


def test_unknown_strategy_name_rejected():
    from hydrabadger_tpu_torch.sim.byzantine import build_strategies

    with pytest.raises(ValueError, match="unknown Byzantine strategy"):
        build_strategies(["no_such_attack"], random.Random(0), InjectionLog())


def test_attack_spec_bounds_f():
    with pytest.raises(ValueError):
        attack_spec(4, n_byzantine=2)  # f max is (4-1)//3 = 1
    assert len(attack_spec(16).byzantine_map()) == 5


# -- the observability contract ----------------------------------------------


def test_unobserved_injection_fails_the_verifier():
    """An injected kind with no materialized observable fails the check."""
    log = InjectionLog(metrics=None)  # no metrics: nothing self-counts
    log.note(T.BYZ_EQUIVOCATION, 3)
    violations = verify_observability(log, faults=[], metrics=MetricsRegistry())
    assert len(violations) == 1
    assert "tolerated it silently" in violations[0]
    with pytest.raises(AssertionError, match="observability contract"):
        assert_observability(log, [], MetricsRegistry())


def test_unregistered_fault_kind_is_itself_a_violation():
    log = InjectionLog()
    log.note("novel_attack", 1)
    violations = verify_observability(log, [], MetricsRegistry())
    assert any("no FAULT_OBSERVABLES entry" in v for v in violations)


def test_matching_fault_log_entry_satisfies_the_contract():
    log = InjectionLog()
    log.note(T.BYZ_EQUIVOCATION, 1)
    fault = T.Fault("n001", "broadcast: mixed echo roots (proposer ...)")
    assert verify_observability(log, [("n0", fault)], MetricsRegistry()) == []


def test_self_counting_kinds_observed_via_their_counter():
    metrics = MetricsRegistry()
    log = InjectionLog(metrics=metrics)
    log.note(T.BYZ_WITHHELD_SHARE, 2)
    assert metrics.counter(BYZ_FAULTS_PREFIX + T.BYZ_WITHHELD_SHARE).value == 2
    assert verify_observability(log, [], metrics) == []


def test_every_taxonomy_kind_has_an_observables_entry():
    """The sim registry covers every sim-injectable kind and the wire
    registry adds the socket-boundary kinds; the process tier's clock skew
    waits for its registry (net/cluster.py is not ported yet)."""
    from hydrabadger_tpu_torch.net.chaos import WIRE_FAULT_OBSERVABLES

    wire_only = {T.BYZ_LINK_RESET, T.BYZ_SIG_CORRUPT, T.BYZ_CRASH}
    proc_only = {T.BYZ_CLOCK_SKEW}
    assert set(FAULT_OBSERVABLES) == set(T.BYZ_KINDS) - wire_only - proc_only
    assert set(WIRE_FAULT_OBSERVABLES) == set(T.BYZ_KINDS) - proc_only


def test_registries_and_taxonomy_equal_the_jax_ones():
    from hydrabadger_tpu.net import chaos as jchaos
    from hydrabadger_tpu_torch.net import chaos as tchaos

    def plain(reg):
        return {k: (v.fault_any, v.counters, v.gauges) for k, v in reg.items()}

    assert T.BYZ_KINDS == JT.BYZ_KINDS
    assert plain(FAULT_OBSERVABLES) == plain(jscen.FAULT_OBSERVABLES)
    assert tscen.SELF_COUNTING_KINDS == jscen.SELF_COUNTING_KINDS
    assert plain(tchaos.WIRE_FAULT_OBSERVABLES) == plain(jchaos.WIRE_FAULT_OBSERVABLES)
    assert tchaos.DEFAULT_WIRE_STRATEGIES == jchaos.DEFAULT_WIRE_STRATEGIES
    from hydrabadger_tpu.sim import byzantine as jbyz
    from hydrabadger_tpu_torch.sim import byzantine as tbyz

    assert sorted(tbyz.STRATEGIES) == sorted(jbyz.STRATEGIES)
    assert {k: v.kind for k, v in tbyz.STRATEGIES.items()} == {
        k: v.kind for k, v in jbyz.STRATEGIES.items()}


# -- liveness under attack ---------------------------------------------------


def _run_attack(n_nodes, epochs, seed, protocol="qhb", spec=None, **kw):
    net = SimNetwork(cfg(n_nodes=n_nodes, protocol=protocol, epochs=epochs, seed=seed, encrypt=True,
                         verify_shares=True, scenario=spec or attack_spec(n_nodes, seed=seed), **kw))
    return net, net.run()


def test_attack_scenario_4node_liveness_and_observability():
    net, m = _run_attack(4, 3, seed=2)
    assert m.agreement_ok
    assert m.epochs_done == 3
    log = net.scenario_log
    for kind in (T.BYZ_EQUIVOCATION, T.BYZ_GARBAGE_SHARE, T.BYZ_WITHHELD_SHARE, T.BYZ_REPLAY_FLOOD):
        assert log.counts.get(kind, 0) > 0, f"{kind} never injected"
    net.verify_scenario()
    net.shutdown()
    fault_kinds = {f.kind for _nid, f in net.router.faults}
    assert any("threshold_decrypt: invalid share" in k for k in fault_kinds)
    assert any("broadcast: mixed echo roots" in k for k in fault_kinds)


def test_dkg_corrupt_under_churn_faults_and_commits():
    spec = ScenarioSpec(name="dkg", seed=7, byzantine=((3, ("dkg_corrupt",)),))
    net = SimNetwork(cfg(n_nodes=4, protocol="dhb", epochs=4, seed=7, scenario=spec))
    for nid in net.honest_ids:
        net.router.dispatch_step(nid, net.nodes[nid].vote_to_remove(net.ids[3]))
    m = net.run()
    assert m.agreement_ok
    assert m.epochs_done == 4
    assert net.scenario_log.counts.get(T.BYZ_DKG_CORRUPT, 0) > 0
    net.verify_scenario()
    assert any("keygen" in f.kind for _nid, f in net.router.faults)
    assert all(net.nodes[nid].era > 0 for nid in net.honest_ids)


def _combined_spec(mod):
    return mod.ScenarioSpec(
        name="combined", seed=5,
        default_link=mod.LinkPolicy(duplicate=0.05, delay=0.1, delay_max=16),
        partitions=(mod.PartitionWindow(groups=((0, 1), (2, 3)), start=50, heal=400),),
        byzantine=((3, ("equivocate", "withhold_shares", "garbage_shares")),),
    )


def test_attack_with_link_faults_and_partition_heals():
    net, m = _run_attack(4, 3, seed=5, spec=_combined_spec(tscen))
    assert m.agreement_ok
    assert m.epochs_done == 3
    assert net.scenario_log.counts.get(T.BYZ_PARTITION, 0) > 0
    net.verify_scenario()


def _era_spec(mod):
    return mod.ScenarioSpec(name="era", seed=9,
                            byzantine=((3, ("equivocate", "dkg_corrupt", "replay_flood")),))


def _era_run(sim_cls, config, mod, **kw):
    net = sim_cls(config(n_nodes=4, protocol="dhb", epochs=4, seed=9, scenario=_era_spec(mod), **kw))
    for nid in net.honest_ids:
        net.router.dispatch_step(nid, net.nodes[nid].vote_to_remove(net.ids[3]))
    return net, net.run()


def _dhb_batches(net, nid):
    return [(b.era, b.epoch, tuple((p, bytes(v)) for p, v in sorted(b.contributions.items())),
             b.change) for b in net.nodes[nid].batches]


def test_async_sync_point_identity_under_attack():
    """The honest batches are identical with the futures' deferral on and
    off, through an attacked era switch."""
    def run(async_on):
        net, m = _era_run(SimNetwork, cfg, tscen, async_dispatch=async_on)
        assert m.agreement_ok
        assert m.epochs_done == 4
        net.verify_scenario()
        net.shutdown()
        return _dhb_batches(net, net.honest_ids[0])

    assert run(True) == run(False)


def test_pre_ciphertext_share_equivocation_is_faulted():
    from hydrabadger_tpu_torch.consensus.threshold_decrypt import MSG_DEC_SHARE, ThresholdDecrypt
    from hydrabadger_tpu_torch.crypto import bls12_381 as bls
    from hydrabadger_tpu_torch.crypto.threshold import DecryptionShare

    ni = T.NetworkInfo("n0", ["n0", "n1", "n2", "n3"], pk_set=None)
    td = ThresholdDecrypt(ni, engine="cpu")
    first = DecryptionShare(bls.G1)
    conflicting = DecryptionShare(bls.double(bls.G1))
    assert td.handle_message("n1", (MSG_DEC_SHARE, first.to_bytes())).fault_log == []
    assert td.handle_message("n1", (MSG_DEC_SHARE, first.to_bytes())).fault_log == []
    step = td.handle_message("n1", (MSG_DEC_SHARE, conflicting.to_bytes()))
    assert any("conflicting share" in f.kind for f in step.fault_log)
    assert td.pending["n1"].to_bytes() == first.to_bytes()


def test_scenario_run_refuses_to_checkpoint():
    from hydrabadger_tpu_torch.checkpoint import CheckpointError, sim_to_bytes

    net = SimNetwork(cfg(n_nodes=4, epochs=1, seed=3, scenario=attack_spec(4, seed=3)))
    with pytest.raises(CheckpointError, match="ScenarioSpec"):
        sim_to_bytes(net)


def test_dropped_future_fails_sim_teardown_loudly():
    from hydrabadger_tpu_torch.crypto import futures as fut

    net = SimNetwork(cfg(n_nodes=4, epochs=1, seed=3))
    net.run()
    net.shutdown()
    f = fut.CryptoFuture(lambda: 42, label="byz-orphan")
    del f  # dropped without result()
    with pytest.raises(RuntimeError, match="dropped without result"):
        net.shutdown()
    net.shutdown()  # the raise drained the ledger: loud exactly once


@pytest.mark.slow
def test_attack_scenario_16node_liveness():
    net, m = _run_attack(16, 2, seed=4)
    assert m.agreement_ok
    assert m.epochs_done == 2
    assert len(net.honest_ids) == 11
    net.verify_scenario()
    net.shutdown()


# -- per-sender duplicate-frame LRU -----------------------------------------


def test_duplicate_frames_suppressed_per_sender():
    net = SimNetwork(cfg(n_nodes=4, epochs=1, seed=5))
    me, a, b = net.ids[0], net.ids[1], net.ids[2]
    msg = ("hb", 0, ("cs", 1, ("bc_probe", b"payload")))
    assert net._handle(me, a, msg) is not None
    assert net._handle(me, a, msg) is None  # suppressed
    assert net.metrics.counter("byz_dup_suppressed").value == 1
    assert net._handle(me, b, msg) is not None  # another sender: not a duplicate
    assert net.metrics.counter("byz_dup_suppressed").value == 1


def test_duplicate_lru_bounded_per_sender():
    net = SimNetwork(cfg(n_nodes=4, epochs=1, seed=5))
    me, a = net.ids[0], net.ids[1]
    for i in range(net.DUP_LRU_PER_SENDER + 10):
        net._handle(me, a, ("hb", 0, ("probe", i)))
    assert len(net._dup_seen[me][a]) == net.DUP_LRU_PER_SENDER


def test_duplicate_suppression_preserves_liveness_and_agreement():
    net, m = _run_attack(4, 4, seed=29)
    assert m.agreement_ok and m.epochs_done >= 4
    net.verify_scenario()
    net.shutdown()


# -- the other packages' scenario cases ---------------------------------------


def test_equivocate_scenario_under_lowcomm_verifies_contract():
    spec = ScenarioSpec(name="lc-equiv", seed=3, byzantine=((3, ("equivocate",)),))
    net, m = _run_attack(4, 3, seed=3, spec=spec, rbc_variant="lowcomm")
    assert m.agreement_ok
    assert m.epochs_done == 3
    assert net.scenario_log.counts.get(T.BYZ_EQUIVOCATION, 0) > 0
    net.verify_scenario()
    net.shutdown()
    assert any("mixed echo roots" in f.kind for _nid, f in net.router.faults)


def test_withheld_parts_stall_is_loud_and_era_keeps_committing(monkeypatch):
    monkeypatch.setenv("HYDRABADGER_SHADOW_STALL_EPOCHS", "3")
    spec = ScenarioSpec(name="kg_withhold", seed=5,
                        byzantine=((2, ("keygen_withhold",)), (3, ("keygen_withhold",))))
    net = SimNetwork(cfg(n_nodes=4, protocol="dhb", encrypt=False, coin_mode="hash", seed=5,
                         scenario=spec))
    joiner_pk = th.SecretKey.random(random.Random(77)).public_key()
    for nid in net.ids:
        net.nodes[nid].vote_to_add("n900", joiner_pk)
    m = net.run(10)
    assert m.epochs_done == 10
    assert m.agreement_ok
    assert all(getattr(net.nodes[nid], "era", 0) == 0 for nid in net.ids)
    assert any("shadow keygen stalled" in f.kind for _nid, f in net.router.faults)
    assert net.metrics.gauge("shadow_dkg_stall_epochs").high_water >= 3
    assert net.scenario_log.counts.get(T.BYZ_KEYGEN_WITHHOLD, 0) > 0
    net.verify_scenario()
    net.shutdown()


# -- parity with the JAX package ---------------------------------------------


def _jax_qhb_batches(net, nid):
    return [(b.epoch, tuple((p, tuple(bytes(t) for t in v)) for p, v in sorted(b.contributions.items())))
            for b in net.nodes[nid].batches]


def _byz_counters(net):
    return {k: v for k, v in net.metrics.snapshot()["counters"].items() if k.startswith("byz_")}


def _faults(net):
    return [(s, f.node_id, f.kind) for s, f in net.router.faults]


def _assert_same_attack(tsim, tm, jsim, jm):
    assert tm.agreement_ok and jm.agreement_ok
    assert tm.epochs_done == jm.epochs_done
    assert tsim.honest_ids == jsim.honest_ids
    assert tsim.scenario_log.counts == jsim.scenario_log.counts
    assert _faults(tsim) == _faults(jsim)
    tsim.verify_scenario()
    jsim.verify_scenario()
    assert _byz_counters(tsim) == _byz_counters(jsim)
    assert (tm.messages_delivered, tm.txns_committed, tm.faults) == (
        jm.messages_delivered, jm.txns_committed, jm.faults)


@pytest.mark.parametrize("case", ["attack_spec", "links_and_partition", "lowcomm_equivocation"])
def test_attacked_runs_equal_the_jax_runs(case):
    """The same config and spec: the honest batches byte for byte, the
    injection counts, the (node, kind) faults and the byz_* counters."""
    kw = dict(n_nodes=4, epochs=3, encrypt=True, coin_mode="threshold", verify_shares=True)
    if case == "attack_spec":
        kw.update(seed=2)
        specs = attack_spec(4, seed=2), jscen.attack_spec(4, seed=2)
    elif case == "links_and_partition":
        kw.update(seed=5)
        specs = _combined_spec(tscen), _combined_spec(jscen)
    else:
        kw.update(seed=3, rbc_variant="lowcomm")
        specs = (tscen.ScenarioSpec(name="lc-equiv", seed=3, byzantine=((3, ("equivocate",)),)),
                 jscen.ScenarioSpec(name="lc-equiv", seed=3, byzantine=((3, ("equivocate",)),)))
    tsim = SimNetwork(cfg(scenario=specs[0], **kw))
    tm = tsim.run()
    jsim = jnet.SimNetwork(jnet.SimConfig(engine="cpu", native_acs=False, scenario=specs[1], **kw))
    jm = jsim.run()
    _assert_same_attack(tsim, tm, jsim, jm)
    assert tm.epochs_done == 3
    for nid in tsim.honest_ids:
        assert tsim.batch_bytes(nid) == _jax_qhb_batches(jsim, nid)
    tsim.shutdown()


def test_attacked_era_switch_equals_the_jax_run():
    """The dhb era switch voting the equivocating, keygen-corrupting,
    replay-flooding node out (seed 9): eras, changes and batches equal."""
    tsim, tm = _era_run(SimNetwork, cfg, tscen)
    jsim, jm = _era_run(jnet.SimNetwork,
                        lambda **kw: jnet.SimConfig(engine="cpu", native_acs=False, **kw), jscen)
    _assert_same_attack(tsim, tm, jsim, jm)
    for nid in tsim.honest_ids:
        assert _dhb_batches(tsim, nid) == _dhb_batches(jsim, nid)
        assert tsim.nodes[nid].era == jsim.nodes[nid].era > 0
    tsim.shutdown()


def test_slo_violation_is_a_fault_and_equals_the_jax_run():
    """An impossible SLO: the sim counts slo_violations and logs "slo"
    faults, at the same epochs as the JAX sim's."""
    from hydrabadger_tpu.obs.latency import SloSpec as JSloSpec
    from hydrabadger_tpu_torch.obs.latency import SloSpec

    kw = dict(n_nodes=4, epochs=3, seed=1)
    spec = dict(percentile=0.5, threshold_s=1e-9, window=64, min_samples=4)
    tsim = SimNetwork(cfg(slo=SloSpec(**spec), **kw))
    tm = tsim.run()
    jsim = jnet.SimNetwork(jnet.SimConfig(engine="cpu", native_acs=False, slo=JSloSpec(**spec), **kw))
    jsim.run()
    assert tm.agreement_ok
    assert tsim.metrics.counter("slo_violations").value == jsim.metrics.counter(
        "slo_violations").value > 0
    slo = [f.kind for s, f in tsim.router.faults if s == "slo"]
    assert slo and all(k.startswith("slo violation:") for k in slo)
    assert len(slo) == len([f for s, f in jsim.router.faults if s == "slo"])
    assert tsim.slo_tracker.violations == jsim.slo_tracker.violations
