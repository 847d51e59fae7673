"""The port's process-tier chaos harness (hydrabadger_tpu_torch/net/cluster.py)
against the JAX package's: tests/test_cluster.py case for case on the port,
the schedule grammar, restart policy, observability registry and child
command pinned equal to JAX's, a 4-node cluster of real port processes
taking a real SIGKILL and restarting from disk with agreeing batch digests,
and a child asked for a card it cannot reach reported at once.

Children run `python -m hydrabadger_tpu_torch --engine cpu --device cpu`.
Localhost ports 15700-15749.
"""
import json
import os

import pytest

from hydrabadger_tpu.net import cluster as jcluster
from hydrabadger_tpu_torch.consensus import types as T
from hydrabadger_tpu_torch.net.cluster import (
    PROC_FAULT_OBSERVABLES,
    ClusterSupervisor,
    KillSpec,
    RestartPolicy,
    _wait,
    parse_kill_spec,
    rolling_kills,
    run_process_chaos,
    verify_process_scenario,
)
from hydrabadger_tpu_torch.obs.metrics import BYZ_FAULTS_PREFIX

CPU = {"engine": "cpu", "device": "cpu"}


# -- schedule grammar ---------------------------------------------------------


def test_kill_spec_grammar():
    assert parse_kill_spec("2:1") == KillSpec(2.0, 1, "kill", None)
    assert parse_kill_spec("2.5:0:term") == KillSpec(2.5, 0, "term", None)
    assert parse_kill_spec("5:3:kill:2.5") == KillSpec(5.0, 3, "kill", 2.5)
    for bad in ("", "5", "1:2:sigquit", "1:2:kill:3:4", "x:1"):
        with pytest.raises(ValueError):
            parse_kill_spec(bad)
        with pytest.raises(ValueError):
            jcluster.parse_kill_spec(bad)
    for text in ("2:1", "2.5:0:term", "5:3:kill:2.5", "0:0:term:1"):
        ours, theirs = parse_kill_spec(text), jcluster.parse_kill_spec(text)
        assert (ours.at_s, ours.node, ours.sig, ours.restart_after_s) == (
            theirs.at_s, theirs.node, theirs.sig, theirs.restart_after_s)


def test_rolling_kills_stagger():
    ks = rolling_kills(3, start_s=2.0, stagger_s=4.0, down_s=2.5)
    assert [k.node for k in ks] == [0, 1, 2]
    assert [k.at_s for k in ks] == [2.0, 6.0, 10.0]
    assert all(k.restart_after_s == 2.5 for k in ks)
    # stagger > down: at most one node down at any instant
    for a, b in zip(ks, ks[1:]):
        assert a.at_s + a.restart_after_s < b.at_s
    theirs = jcluster.rolling_kills(3, start_s=2.0, stagger_s=4.0, down_s=2.5, sig="term")
    ours = rolling_kills(3, start_s=2.0, stagger_s=4.0, down_s=2.5, sig="term")
    assert [vars(k) for k in ours] == [vars(k) for k in theirs]


def test_restart_policy():
    never = RestartPolicy(mode="never")
    on_fail = RestartPolicy(mode="on_failure", max_restarts=2)
    always = RestartPolicy(mode="always", max_restarts=2)
    assert not never.should_restart(-9, 0)
    assert on_fail.should_restart(-9, 0)  # SIGKILL'd
    assert not on_fail.should_restart(0, 0)  # graceful exit stays down
    assert not on_fail.should_restart(-9, 2)  # budget exhausted
    assert always.should_restart(0, 1)
    assert not always.should_restart(0, 2)
    for mode in ("never", "on_failure", "always"):
        ours = RestartPolicy(mode=mode, max_restarts=2)
        theirs = jcluster.RestartPolicy(mode=mode, max_restarts=2)
        assert (ours.backoff_s, RestartPolicy().mode) == (theirs.backoff_s,
                                                          jcluster.RestartPolicy().mode)
        for rc in (None, 0, 1, -9):
            for restarts in range(4):
                assert ours.should_restart(rc, restarts) == theirs.should_restart(rc, restarts)


def test_command_equals_the_jax_supervisor_but_module_and_engine(tmp_path):
    """Each child's argv is JAX's but for `-m hydrabadger_tpu_torch` and the
    trailing `--engine`/`--device` pair; no JAX_PLATFORMS is set for it."""
    kw = dict(n=3, base_port=15700, workdir=str(tmp_path), fast_crypto=False,
              txn_interval_ms=120, checkpoint_every=2, metrics_interval_s=0.3, seed=5)
    ours = ClusterSupervisor(**kw, engine="gpu", device="cuda:1")
    theirs = jcluster.ClusterSupervisor(**kw)
    for i in range(3):
        a, b = ours._command(ours.children[i]), theirs._command(theirs.children[i])
        assert a[1:3] == ["-m", "hydrabadger_tpu_torch"] and b[1:3] == ["-m", "hydrabadger_tpu"]
        assert a[-4:] == ["--engine", "gpu", "--device", "cuda:1"]
        assert a[:1] + a[3:-4] == b[:1] + b[3:]
    fast = ClusterSupervisor(n=2, base_port=15702, workdir=str(tmp_path), **CPU)
    assert fast._command(fast.children[0])[-5:] == ["--fast-crypto", "--engine", "cpu",
                                                    "--device", "cpu"]
    with pytest.raises(ValueError):
        ClusterSupervisor(n=1, workdir=str(tmp_path), engine="tpu")


# -- the observability contract ----------------------------------------------


def test_clock_skew_is_self_counting(tmp_path):
    """Clock skew is pure timing, so the injection counter IS the declared
    observable; the process registry equals the JAX supervisor's."""
    from hydrabadger_tpu_torch.sim.scenario import SELF_COUNTING_KINDS

    assert T.BYZ_CLOCK_SKEW in SELF_COUNTING_KINDS
    assert T.BYZ_CLOCK_SKEW in PROC_FAULT_OBSERVABLES
    assert sorted(PROC_FAULT_OBSERVABLES) == sorted(jcluster.PROC_FAULT_OBSERVABLES)
    for kind, spec in PROC_FAULT_OBSERVABLES.items():
        theirs = jcluster.PROC_FAULT_OBSERVABLES[kind]
        assert (spec.fault_any, spec.counters) == (theirs.fault_any, theirs.counters), kind
    sup = ClusterSupervisor(n=2, workdir=str(tmp_path), base_port=15704,
                            clock_skew={1: (0.5, 1.25)}, **CPU)
    sup.arm_skew()
    assert sup.log.counts[T.BYZ_CLOCK_SKEW] == 1
    assert sup.metrics.counter(BYZ_FAULTS_PREFIX + T.BYZ_CLOCK_SKEW).value == 1
    assert verify_process_scenario(sup) == []
    assert sup.children[1].env_extra == {"HYDRABADGER_CLOCK_SKEW_S": "0.5",
                                         "HYDRABADGER_CLOCK_RATE": "1.25"}


def test_kill_without_recovery_trace_fails(tmp_path):
    """A SIGKILL with no recovery trace (welcome-back replay, f+1
    fast-forward, observer re-adoption) fails the contract."""
    sup = ClusterSupervisor(n=2, workdir=str(tmp_path), base_port=15706, **CPU)
    sup.log.note(T.BYZ_CRASH)
    violations = verify_process_scenario(sup)
    assert len(violations) == 1 and T.BYZ_CRASH in violations[0]
    sup.metrics.counter("welcome_back_replays").inc()
    assert verify_process_scenario(sup) == []


def test_summaries_merge_across_incarnations(tmp_path):
    """Counters reset when a killed node's replacement reuses the metrics
    file: the supervisor groups lines by pid and SUMS the incarnations; the
    device work is read per incarnation."""
    sup = ClusterSupervisor(n=1, workdir=str(tmp_path), base_port=15708, **CPU)
    lines = [
        # incarnation A: two periodic lines (no final: SIGKILL)
        {"pid": 100, "node": "aa", "counters": {"epochs_committed": 3},
         "gauges": {"internal_queue_depth": 7}, "faults": ["wire: x"]},
        {"pid": 100, "node": "aa",
         "counters": {"epochs_committed": 5, "verify_batch_device_batches": 4,
                      "verify_batch_device_lanes": 12},
         "gauges": {"internal_queue_depth": 9}, "faults": ["wire: x"],
         "launches": {"fq_point": 4, "gf256_matmul": 0}},
        # incarnation B after restart: counters restart from zero
        {"pid": 200, "node": "aa",
         "counters": {"epochs_committed": 2, "node_fast_forwards": 1,
                      "verify_batch_device_batches": 1, "verify_batch_device_lanes": 3},
         "gauges": {"internal_queue_depth": 4},
         "faults": ["wire: fast-forward"], "launches": {"fq_point": 1}},
    ]
    with open(sup.children[0].metrics_path, "w") as fh:
        for ln in lines:
            fh.write(json.dumps(ln) + "\n")
        fh.write("{torn-final-line-from-a-sigkill\n")  # must be skipped
    merged = sup.merged_metrics().snapshot()
    assert merged["counters"]["epochs_committed"] == 5 + 2
    assert merged["counters"]["node_fast_forwards"] == 1
    assert merged["counters"]["verify_batch_device_batches"] == 5
    assert merged["gauges"]["internal_queue_depth"]["high_water"] == 9
    kinds = [f.kind for _n, f in sup.fault_entries()]
    assert "wire: fast-forward" in kinds
    assert sup.device_work(0) == [
        {"pid": 100, "verify_batches": 4, "verify_lanes": 12,
         "launches": {"fq_point": 4, "gf256_matmul": 0}},
        {"pid": 200, "verify_batches": 1, "verify_lanes": 3, "launches": {"fq_point": 1}},
    ]
    # the JAX supervisor folds the same feed to the same registry
    jsup = jcluster.ClusterSupervisor(n=1, workdir=str(tmp_path), base_port=15708)
    assert jsup.merged_metrics().snapshot() == merged
    sup.log.note(T.BYZ_CRASH)
    assert verify_process_scenario(sup) == []


# -- the node clock (skew injection target) -----------------------------------


@pytest.mark.asyncio
async def test_node_clock_honors_injected_skew(monkeypatch):
    """The drift assertion drives the injected `_mono_base` seam instead of
    sleeping, so the pin is exact."""
    import time as _time

    from conftest import FakeMono
    from hydrabadger_tpu_torch.net.node import Config, Hydrabadger
    from hydrabadger_tpu_torch.utils.ids import InAddr

    monkeypatch.setenv("HYDRABADGER_CLOCK_SKEW_S", "120.0")
    monkeypatch.setenv("HYDRABADGER_CLOCK_RATE", "2.0")
    skewed = Hydrabadger(InAddr("127.0.0.1", 15710), Config(engine="cpu"), seed=1)
    monkeypatch.delenv("HYDRABADGER_CLOCK_SKEW_S")
    monkeypatch.delenv("HYDRABADGER_CLOCK_RATE")
    honest = Hydrabadger(InAddr("127.0.0.1", 15711), Config(engine="cpu"), seed=2)
    now = _time.monotonic()
    assert abs(honest._now() - now) < 1.0
    # offset + 2x drift: the skewed node's timers run fast
    assert skewed._now() == pytest.approx(120.0 + 2.0 * now, rel=0.01)
    assert skewed._last_progress_t >= 120.0
    fake = FakeMono(t0=50.0)
    skewed._mono_base = fake
    a = skewed._now()
    fake.advance(0.05)
    assert skewed._now() - a == pytest.approx(0.1)
    w = skewed.wall_now()
    fake.advance(1.0)
    assert skewed.wall_now() - w == pytest.approx(1.0, abs=0.05)


@pytest.mark.asyncio
async def test_transcript_cooldowns_ride_the_node_clock():
    """The era-transcript processing cooldown reads the node clock, with a
    hand-advanced clock and no wall sleeps; a clock-behind node still
    processes its first attempt."""
    from types import SimpleNamespace

    from conftest import FakeMono
    from hydrabadger_tpu_torch.net.node import Config, Hydrabadger
    from hydrabadger_tpu_torch.utils.ids import InAddr

    node = Hydrabadger(InAddr("127.0.0.1", 15712), Config(engine="cpu"), seed=3)
    fake = FakeMono(t0=200.0)
    node._mono_base = fake
    calls = []
    node.dhb = SimpleNamespace(
        era=1,
        netinfo=SimpleNamespace(sk_share=None, node_ids=(node.uid.bytes, b"\x01" * 16)),
        install_share_from_transcript=lambda entries, kg: (calls.append(kg) or False),
    )
    payload = (1, 0, ())
    node._on_era_transcript(payload)
    assert len(calls) == 1  # first attempt processes
    fake.advance(1.0)
    node._on_era_transcript(payload)
    assert len(calls) == 1  # inside the 3 s cooldown: rate-limited
    fake.advance(2.5)
    node._on_era_transcript(payload)
    assert len(calls) == 2  # cooldown elapsed on the NODE clock
    node2 = Hydrabadger(InAddr("127.0.0.1", 15713), Config(engine="cpu"), seed=4)
    node2._mono_base = FakeMono(t0=-400000.0)
    node2.dhb = node.dhb
    calls.clear()
    node2._on_era_transcript(payload)
    assert len(calls) == 1, "negative node clock wedged the cooldown gate"


# -- real subprocesses --------------------------------------------------------


def test_sigterm_graceful_stop_subprocess(tmp_path):
    """A real `python -m hydrabadger_tpu_torch` child under SIGTERM drains,
    persists a FINAL durable checkpoint and exits 0, while a SIGKILLed
    sibling exits nonzero and leaves no final summary line."""
    from hydrabadger_tpu_torch.checkpoint import CheckpointStore

    sup = ClusterSupervisor(n=3, base_port=15714, workdir=str(tmp_path), fast_crypto=True,
                            txn_interval_ms=100, metrics_interval_s=0.25, **CPU)
    try:
        sup.start_all()
        _wait(lambda: all((sup.last_summary(i) or {}).get("state") == "validator"
                          for i in range(3)), "bootstrap DKG", 120.0, sup)
        _wait(lambda: all(sup.frontier(i) >= 1 for i in range(3)), "first commits", 60.0, sup)
        sup.kill(2)
        assert sup.children[2].last_exit != 0
        assert not [s for s in sup.summaries(2) if s.get("final")], (
            "a SIGKILLed process cannot write a goodbye")
        rc = sup.terminate(0)
        assert rc == 0
        finals = [s for s in sup.summaries(0) if s.get("final")]
        assert finals and finals[-1]["reason"] == "sigterm"
        # the port's summary lines carry the launch counts (none on the CPU)
        assert finals[-1]["launches"] == {"fq_point": 0, "gf256_matmul": 0}
        ckpt = CheckpointStore(sup.children[0].ckpt_path).load()
        assert ckpt is not None and ckpt.sk_share
        assert ckpt.epoch >= 1
    finally:
        sup.stop_all(timeout_s=10.0)


def test_supervisor_watchdog_restarts_on_failure(tmp_path):
    """A child that dies OUTSIDE the kill schedule is respawned per
    RestartPolicy(on_failure), from its on-disk checkpoint, and the
    unexpected exit is counted."""
    import signal as _signal
    import time as _time

    sup = ClusterSupervisor(n=3, base_port=15718, workdir=str(tmp_path), fast_crypto=True,
                            txn_interval_ms=100, metrics_interval_s=0.25,
                            restart_policy=RestartPolicy(mode="on_failure", backoff_s=0.1),
                            **CPU)
    try:
        sup.start_all()
        _wait(lambda: all(sup.frontier(i) >= 1 for i in range(3)), "first commits", 120.0, sup)
        os.kill(sup.children[1].proc.pid, _signal.SIGKILL)  # an unplanned death
        t0 = _time.monotonic()
        while not (sup.children[1].alive and sup.children[1].restarts == 1):
            sup.poll()
            _time.sleep(0.1)
            assert _time.monotonic() - t0 < 30.0, "watchdog never restarted"
        assert sup.metrics.counter("proc_unexpected_exits").value == 1
        assert sup.metrics.counter("proc_restarts").value == 1
    finally:
        sup.stop_all(timeout_s=10.0)


def test_child_without_a_card_exits_nonzero_and_is_reported(tmp_path):
    """A child asked for the card where there is none exits nonzero, and
    the harness's wait fails at once naming it: nothing retries on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card: the child would reach it")
    sup = ClusterSupervisor(n=1, base_port=15722, workdir=str(tmp_path), engine="gpu",
                            device="cuda", restart_policy=RestartPolicy(mode="never"))
    try:
        sup.spawn(0)  # spawn alone: no kernel build before it
        with pytest.raises(AssertionError, match="node 0 exited rc=1") as err:
            _wait(lambda: False, "bootstrap DKG across processes", 60.0, sup)
        assert "torch.cuda.is_available() is" in str(err.value)
        assert sup.children[0].last_exit == 1 and not sup.children[0].alive
    finally:
        sup.stop_all(timeout_s=10.0)


def test_four_node_sigkill_restart_agrees(tmp_path):
    """Four port processes at the fast tier (f = 1): node 1 takes a real
    SIGKILL at +1 s and restarts from its store 1.5 s later.  Agreement by
    digest across every process and incarnation, the recovery trace,
    graceful exits.  (Three nodes have f = 0: the JAX supervisor's own
    3-node run wedges in the catch-up about half the time, so the kill
    runs where the protocol tolerates it.)"""
    row = run_process_chaos(
        n=4, epochs=2, base_port=15724, workdir=str(tmp_path), fast_crypto=True,
        txn_interval_ms=100, clock_skew={},
        kills=(KillSpec(at_s=1.0, node=1, sig="kill", restart_after_s=1.5),),
        deadline_s=120.0, **CPU)
    assert row["agreement_ok"] and row["contract_ok"] and row["epochs"] >= 2
    assert row["recovery_catchup_s"] is not None
    assert row["txn_latency"]["killed_node_incarnations"] >= 2
    assert len(row["device_work"]["1"]) >= 2  # both incarnations' feeds

    def rows(i):
        with open(tmp_path / f"node{i}.batches.jsonl") as fh:
            return {r["epoch"]: r["digest"] for r in map(json.loads, fh)}

    victim, survivor = rows(1), rows(0)
    shared = set(victim) & set(survivor)
    assert shared and all(victim[e] == survivor[e] for e in shared)
    assert max(victim) >= max(survivor) - 1, "victim never caught up"


@pytest.mark.slow
class TestCrossProcessRecovery:
    def test_sigkill_mid_era_restart_matches_uninterrupted_twin(self, tmp_path):
        """A 4-node process-per-node port cluster takes a genuine SIGKILL on
        one member mid-era; restarted from its on-disk store, its committed
        batches and pk_set are byte-identical (by digest) to its
        uninterrupted twins' while the honest quorum kept committing."""
        row = run_process_chaos(
            n=4, epochs=4, base_port=15730, workdir=str(tmp_path), fast_crypto=True,
            kills=(KillSpec(at_s=1.0, node=1, sig="kill", restart_after_s=2.0),), **CPU)
        assert row["agreement_ok"] and row["contract_ok"]
        assert row["epochs"] >= 4
        assert row["recovery_catchup_s"] is not None

        def rows(i):
            batches, pks = {}, {}
            with open(tmp_path / f"node{i}.batches.jsonl") as fh:
                for line in fh:
                    r = json.loads(line)
                    batches[r["epoch"]] = (r["digest"], r["era"])
                    # keyed by the era the pk_set belongs to: around a
                    # cutover a node logs the last epoch of an era with the
                    # next era's keys already installed
                    pks[r["pk_era"]] = r["pk_set"]
            return batches, pks

        (victim, victim_pks), (survivor, survivor_pks) = rows(1), rows(0)
        shared = set(victim) & set(survivor)
        assert shared, "victim and survivor share no epochs"
        for e in shared:
            assert victim[e] == survivor[e], f"divergence at epoch {e}"
        for era in set(victim_pks) & set(survivor_pks):
            assert victim_pks[era] == survivor_pks[era], f"pk_set divergence in era {era}"
        assert max(victim) >= max(survivor) - 1, "victim never caught up"
        det = row["detections"]
        assert (det["welcome_back_replays"] > 0 or det["node_fast_forwards"] > 0
                or det["observer_adoptions"] > 0)
