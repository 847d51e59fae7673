"""Long-run soak gates on the port: bounded memory, flat state, liveness.

The port's copy of hydrabadger_tpu/sim/soak.py, the reference's mem-debug
regimen (run to epoch 1000 and exit) as a reproducible, ASSERTING run:

  - RSS stays bounded (growth after warmup within an explicit budget),
  - the capped buffers stay small under load: HB `deferred`, DHB
    `future_msgs`, and (TCP) the wire-retry and epoch-outbox rings,
  - throughput does not decay (last-quartile epochs/s vs first).

Tiers: `sim_soak` (in-process SimNetwork epochs on the native ACS core,
"sim_native_acs"), `byz_soak` (the attacked full-crypto sim),
`era_soak` (dhb era switches with the state-census flatness check),
`wire_chaos_soak` (net/chaos), `process_chaos_soak` (net/cluster: real OS
processes, a real SIGKILL), `tcp_soak` (a 4-node localhost cluster at full
crypto), `rbc_soak` (the metered bracha vs low-comm legs and the sketch
plane's device twin on kernel B1) and `slo_soak`.

Every tier that builds an engine or nodes takes `engine` ("gpu", the
default: the card, which raises where there is none; or "cpu") and
`device`, and passes them through; nothing falls back to the CPU.

CLI: `python -m hydrabadger_tpu_torch.sim.soak [--epochs N] [--skip-tcp]
[--engine {gpu,cpu}] [--device D]` prints one JSON line per tier and writes
the rows to `--out` (default SOAK_torch.json).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List

from ..crypto.engine import named_engine

_PAGE = os.sysconf("SC_PAGESIZE")

# localhost ports of the soak's TCP tiers (the port's own range)
TCP_BASE_PORT = 15940
WIRE_BASE_PORT = 15960
PROC_BASE_PORT = 15980


def rss_mb() -> float:
    with open("/proc/self/statm") as fh:
        return int(fh.read().split()[1]) * _PAGE / 1e6


def _throughput_stable(epoch_durations: List[float]) -> bool:
    """Last-quartile epochs/s must be >= half the first-quartile's."""
    q = max(1, len(epoch_durations) // 4)
    first = q / sum(epoch_durations[:q])
    last = q / sum(epoch_durations[-q:])
    return last >= 0.5 * first


def _overlap_fields() -> Dict:
    from ..crypto import futures as _futures

    overlap = _futures.overlap_snapshot()
    return {k: overlap[k] for k in ("device_overlap_ratio", "device_overlap_ratio_raw",
                                    "device_backend", "device_idle_s")}


def sim_soak(epochs: int = 1000, n_nodes: int = 16, rss_budget_mb: float = 256.0,
             engine: str = "gpu", device: str = "cuda") -> Dict:
    """In-process epochs with bounded-memory assertions."""
    from .network import SimConfig, SimNetwork

    net = SimNetwork(
        SimConfig(n_nodes=n_nodes, protocol="qhb", txns_per_node_per_epoch=5, txn_bytes=8,
                  seed=11, engine=named_engine(engine, device))
    )
    net.run(10)  # warmup (allocator pools, codec caches, native libs)
    rss0 = rss_mb()
    max_deferred = 0
    trimmed = 0
    chunk = max(1, epochs // 10)
    done = 10
    while done < epochs + 10:
        m = net.run(chunk)
        done += chunk
        max_deferred = max(max_deferred, max(len(net.nodes[nid].hb.deferred) for nid in net.ids))
        # agreement holds on the retained window, then TRIM the batch
        # history: the soak asserts the RUNTIME does not leak; the
        # deliberately unbounded batch log would otherwise dominate RSS
        assert m.agreement_ok, "soak lost agreement"
        window = min(len(net.nodes[nid].batches) for nid in net.ids)
        if window > 4:
            cut = window - 4
            trimmed += cut
            for nid in net.ids:
                del net.nodes[nid].batches[:cut]
    rss1 = rss_mb()
    committed = trimmed + min(len(net.nodes[nid].batches) for nid in net.ids)
    assert committed >= epochs, "soak under-ran"
    assert rss1 - rss0 < rss_budget_mb, (
        f"sim soak RSS grew {rss1 - rss0:.1f} MB (> {rss_budget_mb})"
    )
    assert max_deferred <= 1000, f"deferred buffer blew up: {max_deferred}"
    assert _throughput_stable(net.epoch_durations[10:]), "throughput decayed"
    # one queue_peaks schema across tiers; deferred has no gauge, so the
    # per-chunk max above folds in
    peaks = dict(net.queue_peaks())
    peaks["deferred"] = max(peaks["deferred"], max_deferred)
    return {
        "tier": "sim_native_acs",
        "epochs": committed,
        "epochs_per_sec": round(committed / net.total_wall_s, 2),
        "rss_start_mb": round(rss0, 1),
        "rss_end_mb": round(rss1, 1),
        "rss_growth_mb": round(rss1 - rss0, 1),
        "max_deferred": max_deferred,
        "queue_peaks": peaks,
        **_overlap_fields(),
        "txn_latency": net.txn_latency_snapshot(),
        "metrics": net.metrics.snapshot(),
        "agreement_ok": m.agreement_ok,
    }


def byz_soak(epochs: int = 200, n_nodes: int = 4, rss_budget_mb: float = 256.0,
             engine: str = "gpu", device: str = "cuda") -> Dict:
    """Liveness under attack: the full-crypto sim with the LAST f nodes
    running the complete attack catalog.  The honest quorum commits every
    epoch in agreement at a rate within 2x of an honest-only calibration
    leg at the same config, and every injected fault kind surfaces through
    the observability contract."""
    from .network import SimConfig, SimNetwork
    from .scenario import attack_spec

    eng = named_engine(engine, device)

    def cfg(scenario):
        return SimConfig(
            n_nodes=n_nodes, protocol="qhb", encrypt=True, verify_shares=True,
            txns_per_node_per_epoch=5, txn_bytes=8, seed=17, scenario=scenario, engine=eng,
        )

    # honest calibration leg: the 2x bound's denominator.  Both legs
    # exclude a warmup window from their timed rate, or the honest leg
    # would pay the one-time cold start alone and weaken the gate
    honest = SimNetwork(cfg(None))
    calib = max(10, min(epochs // 2, 40))
    honest.run(5)
    warm_wall = honest.total_wall_s
    honest.run(calib)
    honest_eps = calib / (honest.total_wall_s - warm_wall)
    honest.shutdown()  # the dropped-future ledger is process-global

    net = SimNetwork(cfg(attack_spec(n_nodes, seed=17)))
    net.run(5)  # warmup, excluded from the rate like the honest leg's
    rss0 = rss_mb()
    t0 = time.perf_counter()
    chunk = max(1, epochs // 10)
    done = 0
    trimmed = 0
    while done < epochs:
        m = net.run(chunk)
        done += chunk
        assert m.agreement_ok, "byz soak: honest quorum lost agreement"
        # trim the batch history (see sim_soak); every node's core is
        # honest underneath, so all of them grow
        window = min(len(net._batches(nid)) for nid in net.ids)
        if window > 4:
            cut = window - 4
            trimmed += cut
            for nid in net.ids:
                del net._batches(nid)[:cut]
    wall = time.perf_counter() - t0
    rss1 = rss_mb()
    committed = trimmed + min(len(net._batches(nid)) for nid in net.honest_ids)
    attacked_eps = done / wall
    assert committed >= epochs + 5, "byz soak under-ran"
    assert rss1 - rss0 < rss_budget_mb, (
        f"byz soak RSS grew {rss1 - rss0:.1f} MB (> {rss_budget_mb})"
    )
    assert attacked_eps >= 0.5 * honest_eps, (
        f"byz soak: attacked rate {attacked_eps:.2f} eps fell below "
        f"half the honest baseline {honest_eps:.2f} eps"
    )
    # every injected kind surfaced as a declared observable (also folds
    # the fault log into the byz_faults_* counters the row carries)
    net.verify_scenario()
    txn_latency = net.txn_latency_snapshot()
    net.shutdown()
    counters = net.metrics.snapshot()["counters"]
    f = n_nodes - len(net.honest_ids)
    return {
        "tier": f"sim_byzantine_{n_nodes}node_full_crypto",
        "n_byzantine": f,
        "epochs": committed,
        "epochs_per_sec": round(attacked_eps, 2),
        "honest_epochs_per_sec": round(honest_eps, 2),
        "vs_honest_baseline": round(attacked_eps / honest_eps, 3),
        "rss_start_mb": round(rss0, 1),
        "rss_end_mb": round(rss1, 1),
        "rss_growth_mb": round(rss1 - rss0, 1),
        "queue_peaks": net.queue_peaks(),
        "byz_injected": dict(net.scenario_log.counts),
        "byz_faults": {k: v for k, v in sorted(counters.items()) if k.startswith("byz_faults_")},
        "txn_latency": txn_latency,
        "agreement_ok": True,
        "metrics": net.metrics.snapshot(),
    }


def era_soak(n_nodes: int = 16, steady_epochs: int = 6, era_gap_floor_s: float = 2.0,
             eras: int = 2, engine: str = "gpu", device: str = "cuda") -> Dict:
    """Multi-era gate: a dhb sim crosses `eras` era switches and asserts

      * the committed-epoch gap across every switch stays within
        `max(2x steady p50, era_gap_floor_s)`;
      * era-age flatness: later-era steady epoch time within 1.2x the
        era-0 steady p50 (plus the same floor);
      * state-census flatness: every `per_epoch`/`per_era` container (the
        lint registry's STATE_LIFECYCLE, read by obs/census) no larger at
        the end of the last era than at the end of era 0;
      * every switch happened, agreement held, and the shadow-DKG stall
        observable stayed silent.

    HYDRABADGER_GPU_DKG=1 forces the DKG's device plane (kernel B2 on a
    GpuEngine).  The row carries the device provenance of the era-gap
    fields."""
    from ..obs.census import flatness_violations
    from .network import SimConfig, SimNetwork

    net = SimNetwork(
        SimConfig(
            n_nodes=n_nodes, protocol="dhb", txns_per_node_per_epoch=max(1, 256 // n_nodes),
            txn_bytes=8, seed=23, engine=named_engine(engine, device),
        )
    )
    net.run(steady_epochs)

    def _p50(walls: List[float]) -> float:
        ordered = sorted(walls)
        return ordered[len(ordered) // 2]

    # era-0 steady p50 over the LAST half of the warmup window: the first
    # epochs pay the one-time cold start
    era0_walls = net.epoch_durations[steady_epochs // 2:]
    steady_p50s = [_p50(era0_walls)]
    census_base = net.census.latest()
    victims = list(net.ids[-eras:])
    switch_epochs: List[int] = []
    m = None
    for k, victim in enumerate(victims):
        gone = set(victims[:k])
        watchers = [nid for nid in net.ids
                    if nid != victim and nid not in gone and net.nodes[nid].is_validator]
        # era = start-epoch index, NOT a counter: detect the flip as a
        # CHANGE from the pre-vote snapshot
        era_before = {nid: net.nodes[nid].era for nid in watchers}
        for nid in watchers:
            net.router.dispatch_step(nid, net.nodes[nid].vote_to_remove(victim))
        switched_at = None
        for i in range(24):
            m = net.run(1)
            assert m.agreement_ok, f"era soak lost agreement mid-switch {k + 1}"
            if all(net.nodes[nid].era != era_before[nid] for nid in watchers):
                switched_at = i + 1
                break
        assert switched_at is not None, (
            f"era switch {k + 1}/{eras} never completed under shadow DKG (cutover wedged?)"
        )
        switch_epochs.append(switched_at)
        before = len(net.epoch_durations)
        m = net.run(steady_epochs)  # the NEW era commits steady epochs
        assert m.agreement_ok, f"era soak lost agreement post-switch {k + 1}"
        steady_p50s.append(_p50(net.epoch_durations[before:]))
    net.shutdown()
    gap = net.era_gap_snapshot()
    bound = max(2.0 * gap["steady_epoch_p50_s"], era_gap_floor_s)
    assert gap["era_commit_gap_s"] <= bound, (
        f"era commit gap {gap['era_commit_gap_s']:.3f}s exceeded the bound {bound:.3f}s "
        f"(steady p50 {gap['steady_epoch_p50_s']:.3f}s): the era-switch wall is back"
    )
    # era-age flatness: an era must not pay for its predecessors
    age_bound = max(1.2 * steady_p50s[0], steady_p50s[0] + era_gap_floor_s)
    for era_idx, p50 in enumerate(steady_p50s[1:], start=1):
        assert p50 <= age_bound, (
            f"era-age slowdown: era {era_idx} steady p50 {p50:.3f}s exceeds the flatness "
            f"bound {age_bound:.3f}s (era-0 p50 {steady_p50s[0]:.3f}s); see the census row"
        )
    # state-census flatness: scoped containers back at (or below) their
    # era-0 levels once the last era's steady phase ends
    census_end = net.census.latest()
    leaks = flatness_violations(census_base, census_end)
    assert not leaks, f"state census grew across eras for scoped containers: {leaks}"
    # the stall detector must stay silent through HEALTHY switches
    stall_faults = [f for _nid, f in net.router.faults if "shadow keygen stalled" in f.kind]
    assert not stall_faults, stall_faults
    return {
        "tier": f"era_switch_{n_nodes}node_shadow_dkg",
        "epochs": m.epochs_done,
        "epochs_per_sec": round(m.epochs_per_sec, 2),
        "eras_crossed": eras,
        "era_epochs_to_switch": switch_epochs[0],
        "era_switch_epochs": switch_epochs,
        "era_steady_p50_s": [round(p, 4) for p in steady_p50s],
        "era_age_bound_s": round(age_bound, 4),
        "era_gap_bound_s": round(bound, 4),
        "census_era0": census_base,
        "census_final": census_end,
        "census_flat": True,
        **gap,
        "agreement_ok": True,
    }


def wire_chaos_soak(epochs: int = 8, engine: str = "gpu", device: str = "cuda",
                    base_port: int = WIRE_BASE_PORT) -> Dict:
    """Wire-tier chaos gate (net/chaos.py): the 4-node full-crypto cluster
    with f = 1 Byzantine peer, link faults, in-flight signature corruption
    and one crash/restart from a stale checkpoint.  The row carries the
    longest commit gap under fault and the recovery catch-up time."""
    from ..net.chaos import run_chaos_cluster

    return run_chaos_cluster(epochs=epochs, base_port=base_port, engine=engine, device=device)


def process_chaos_soak(epochs: int = 6, rss_budget_mb: float = 64.0, workdir: str = None,
                       engine: str = "gpu", device: str = "cuda",
                       base_port: int = PROC_BASE_PORT) -> Dict:
    """Process-tier chaos gate (net/cluster.py): a 4-node cluster of REAL
    OS processes (`python -m hydrabadger_tpu_torch` per validator, on
    `engine`/`device`) bootstraps over real sockets, one validator takes a
    real SIGKILL mid-era and restarts from its on-disk checkpoint store,
    and the supervisor asserts liveness, cross-process agreement, graceful
    SIGTERM exits and the process-tier observability contract.  The
    supervisor's own RSS must stay flat (the feeds are files).  `workdir`
    pins the artifact directory for a later `obs.aggregate` run."""
    from ..net.cluster import run_process_chaos

    row = run_process_chaos(epochs=epochs, base_port=base_port, workdir=workdir,
                            deadline_s=240.0, engine=engine, device=device)
    assert row["supervisor_rss_growth_mb"] < rss_budget_mb, (
        f"supervisor RSS grew {row['supervisor_rss_growth_mb']:.1f} MB (> {rss_budget_mb})"
    )
    return row


def tcp_soak(epochs: int = 1000, rss_budget_mb: float = 256.0, engine: str = "gpu",
             device: str = "cuda", base_port: int = TCP_BASE_PORT) -> Dict:
    """4-node localhost cluster, DEFAULT (full) crypto tier, to `epochs`
    committed batches with queue/RSS bounds sampled live."""
    import asyncio

    from ..net.node import Config, Hydrabadger
    from ..utils.ids import InAddr, OutAddr

    n, base = 4, base_port

    async def run() -> Dict:
        cfg = Config(txn_gen_interval_ms=50, keygen_peer_count=n - 1,
                     engine=named_engine(engine, device))
        nodes = [Hydrabadger(InAddr("127.0.0.1", base + i), cfg, seed=500 + i) for i in range(n)]
        gen = lambda count, size: [b"%02dx" % i * size for i in range(count)]  # noqa: E731
        for i, node in enumerate(nodes):
            remotes = [OutAddr("127.0.0.1", base + j) for j in range(n) if j != i]
            await node.start(remotes, gen)
        while not all(m.is_validator() for m in nodes):
            await asyncio.sleep(0.2)
        # procfs sampling off the loop: the cluster under test runs on it
        loop = asyncio.get_running_loop()
        rss0 = await loop.run_in_executor(None, rss_mb)
        t0 = time.perf_counter()
        peaks = {"deferred": 0, "future": 0, "retry": 0, "outbox": 0}
        committed = [0] * n
        last_report = t0
        while min(committed) < epochs:
            await asyncio.sleep(0.5)
            now = time.perf_counter()
            if now - last_report > 30.0:
                # live progress: per-node counts expose a stalled node,
                # the rate exposes throughput decay
                done = min(committed)
                rss_now = await loop.run_in_executor(None, rss_mb)
                print(f"soak progress: {committed} epochs, {done / (now - t0):.3f} eps, "
                      f"rss {rss_now:.0f} MB", flush=True)
                last_report = now
            for i, m in enumerate(nodes):
                committed[i] += len(m.batches)
                # trim the history (see sim_soak) and drain the consumer
                # queue nobody reads in this harness
                m.batches.clear()
                try:
                    while True:
                        m.batch_queue.get_nowait()
                except asyncio.QueueEmpty:
                    pass
                if m.dhb is None:
                    continue
                peaks["deferred"] = max(peaks["deferred"], len(m.dhb.hb.deferred))
                peaks["future"] = max(peaks["future"], len(m.dhb.future_msgs))
                peaks["retry"] = max(peaks["retry"], len(m._wire_retry))
                peaks["outbox"] = max(peaks["outbox"], len(m._epoch_outbox))
        dt = time.perf_counter() - t0
        rss1 = await loop.run_in_executor(None, rss_mb)
        # counters sum, gauges take the worst node
        merged = _merge_metrics([m.metrics.snapshot() for m in nodes])
        from ..obs.latency import merge_sketch_dicts

        e2e = merge_sketch_dicts([m.txn_lifecycle.sketch_feed() for m in nodes]).get("e2e")
        for m in nodes:
            await m.stop()
        epochs_done = min(committed)
        assert rss1 - rss0 < rss_budget_mb, (
            f"tcp soak RSS grew {rss1 - rss0:.1f} MB (> {rss_budget_mb})"
        )
        assert peaks["deferred"] <= 1000, peaks
        assert peaks["future"] <= 1000, peaks
        assert peaks["retry"] <= 4096, peaks
        return {
            "tier": "tcp_4node_full_crypto",
            "epochs": epochs_done,
            "epochs_per_sec": round(epochs_done / dt, 2),
            "rss_start_mb": round(rss0, 1),
            "rss_end_mb": round(rss1, 1),
            "rss_growth_mb": round(rss1 - rss0, 1),
            "queue_peaks": peaks,
            **_overlap_fields(),
            "txn_latency": {
                "count": e2e.count if e2e else 0,
                "p50_s": round(e2e.quantile(0.5), 6) if e2e else None,
                "p99_s": round(e2e.quantile(0.99), 6) if e2e else None,
            },
            "metrics": merged,
        }

    return asyncio.run(run())


def _merge_metrics(snapshots: List[Dict]) -> Dict:
    """Fold per-node registry snapshots: counters sum, gauges keep the
    worst (value AND high_water), histograms add bucket counts and merge
    the sketch backing so the folded p50/p99 are quantiles of the union."""
    from ..obs.latency import LatencySketch

    out: Dict = {"counters": {}, "gauges": {}, "histograms": {}}
    for snap in snapshots:
        for k, v in snap.get("counters", {}).items():
            out["counters"][k] = out["counters"].get(k, 0) + v
        for k, g in snap.get("gauges", {}).items():
            cur = out["gauges"].setdefault(k, {"value": 0, "high_water": 0})
            cur["value"] = max(cur["value"], g["value"])
            cur["high_water"] = max(cur["high_water"], g["high_water"])
        for k, h in snap.get("histograms", {}).items():
            cur = out["histograms"].get(k)
            if cur is None or cur["edges"] != h["edges"]:
                out["histograms"][k] = dict(h)
            else:
                cur["counts"] = [a + b for a, b in zip(cur["counts"], h["counts"])]
                cur["total"] += h["total"]
                cur["sum"] = round(cur["sum"] + h["sum"], 6)
                if "sketch" in cur and "sketch" in h:
                    folded = LatencySketch.from_dict(cur["sketch"])
                    folded.merge(LatencySketch.from_dict(h["sketch"]))
                    cur["sketch"] = folded.to_dict()
                    cur["p50"] = round(folded.quantile(0.5), 6)
                    cur["p99"] = round(folded.quantile(0.99), 6)
    return out


def rbc_soak(epochs: int = 5, n_nodes: int = 16, engine: str = "gpu",
             device: str = "cuda") -> Dict:
    """Bandwidth-metered RBC variant gate: one short sim leg per broadcast
    variant (Merkle bracha vs the low-comm), same topology and seed, the
    router pricing every frame at its codec size.  Committed batches are
    identical across the variants, and low-comm is strictly cheaper in
    bytes per epoch.  The low-comm leg's sketches run on the engine
    (kernel B1 on a GpuEngine); the sketch plane's device twin
    (ops/homhash_torch on `device`) is held once against the host
    sketches, so the row's lane occupancy is a real dispatch's."""
    import numpy as _np

    from ..crypto import homhash as _hh
    from ..obs import metrics as M
    from ..obs.metrics import default_registry
    from ..ops import homhash_torch as _hht
    from .network import SimConfig, SimNetwork

    eng = named_engine(engine, device)

    def leg(variant: str):
        net = SimNetwork(
            SimConfig(n_nodes=n_nodes, protocol="qhb", epochs=epochs, seed=29,
                      rbc_variant=variant, meter_bytes=True, native_acs=False, engine=eng)
        )
        m = net.run()
        assert m.agreement_ok, f"rbc soak ({variant}) lost agreement"
        assert m.epochs_done >= epochs, f"rbc soak ({variant}) under-ran"
        batches = [[(p, tuple(bytes(t) for t in ts)) for p, ts in sorted(b.contributions.items())]
                   for b in net._batches(net.ids[0])]
        net.shutdown()
        return m, batches

    m_bracha, b_bracha = leg("bracha")
    m_lc, b_lc = leg("lowcomm")
    assert b_bracha == b_lc, "rbc soak: committed batches diverged across RBC variants"
    assert m_lc.bytes_tx_total > 0 and m_bracha.bytes_tx_total > 0, (
        "rbc soak: byte metering recorded nothing"
    )
    assert m_lc.bytes_per_epoch < m_bracha.bytes_per_epoch, (
        f"rbc soak: lowcomm not cheaper ({m_lc.bytes_per_epoch:.0f} vs "
        f"{m_bracha.bytes_per_epoch:.0f} bytes/epoch)"
    )
    probe = _np.arange(n_nodes * 64, dtype=_np.uint8).reshape(n_nodes, 64)
    assert _np.array_equal(
        _hht.sketch_batch(probe, b"rbc-soak", device=device),
        _hh.sketch_batch_np(probe, b"rbc-soak"),
    ), "rbc soak: homhash device twin diverged from host"
    reg = default_registry()
    return {
        "tier": f"rbc_lowcomm_{n_nodes}node",
        "epochs": epochs,
        "bytes_per_epoch_bracha": round(m_bracha.bytes_per_epoch),
        "bytes_per_epoch_lowcomm": round(m_lc.bytes_per_epoch),
        # per-kind attribution: the cut must come from the echo tier
        "bytes_rx_by_kind_bracha": dict(sorted(m_bracha.bytes_rx_by_kind.items())),
        "bytes_rx_by_kind_lowcomm": dict(sorted(m_lc.bytes_rx_by_kind.items())),
        "bytes_reduction": round(1 - m_lc.bytes_per_epoch / m_bracha.bytes_per_epoch, 3),
        "epochs_per_sec_bracha": round(m_bracha.epochs_per_sec, 2),
        "epochs_per_sec_lowcomm": round(m_lc.epochs_per_sec, 2),
        "homhash_lane_occupancy": reg.gauge(M.HOMHASH_LANE_OCCUPANCY).value,
        "batches_point_identical": True,
        "agreement_ok": True,
    }


def slo_soak(epochs: int = 10, n_nodes: int = 4, engine: str = "gpu",
             device: str = "cuda") -> Dict:
    """Latency-SLO gate: two short qhb sim legs, one on each side of the
    SLO contract.

      * HONEST leg, generous SLO (p99 < 5 s): the plane measures real
        submit->commit latency without false positives.
      * CHAOS leg, strict SLO (p90 < 0.1 ms) under the attack catalog: a
        target the attacked cluster cannot meet, so the violation path
        MUST fire (the slo_violations counter and the fault-ring entry).
    """
    from ..obs.latency import SloSpec
    from .network import SimConfig, SimNetwork
    from .scenario import attack_spec

    eng = named_engine(engine, device)

    def leg(scenario, spec):
        net = SimNetwork(
            SimConfig(n_nodes=n_nodes, protocol="qhb", encrypt=True, verify_shares=True,
                      txns_per_node_per_epoch=5, txn_bytes=8, seed=23, scenario=scenario,
                      slo=spec, engine=eng)
        )
        m = net.run(epochs)
        assert m.agreement_ok, "slo gate lost agreement"
        row = net.txn_latency_snapshot()
        counters = net.metrics.snapshot()["counters"]
        ring = [f.kind for _n, f in net.router.faults if f.kind.startswith("slo violation")]
        net.shutdown()
        return row, counters.get("slo_violations", 0), ring

    honest, h_violations, h_ring = leg(
        None, SloSpec(percentile=0.99, threshold_s=5.0, min_samples=8))
    assert honest["count"] > 0, "slo gate honest leg measured nothing"
    assert h_violations == 0 and not h_ring, (
        f"honest load tripped the SLO ({h_violations} violations): either the cluster is "
        "pathologically slow or the threshold machinery is firing falsely"
    )
    chaos, c_violations, c_ring = leg(
        attack_spec(n_nodes, seed=23), SloSpec(percentile=0.9, threshold_s=1e-4, min_samples=8))
    assert c_violations > 0, (
        "chaos leg met a 0.1 ms p90 target: the SLO violation path cannot be firing"
    )
    assert c_ring and "burn rate" in c_ring[0], (
        f"violations counted but the fault ring stayed quiet: {c_ring!r}"
    )
    return {
        "tier": f"slo_gate_{n_nodes}node",
        "epochs": epochs,
        "honest": dict(honest, slo_violations=h_violations),
        "chaos": dict(chaos, slo_violations=c_violations, ring_sample=c_ring[0]),
        "agreement_ok": True,
    }


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--tcp-epochs", type=int, default=None,
                   help="TCP tier target (default: same as --epochs)")
    p.add_argument("--byz-epochs", type=int, default=None,
                   help="Byzantine tier target (default: --epochs / 5; the full-crypto "
                   "attacked tier is the slowest)")
    p.add_argument("--skip-tcp", action="store_true")
    p.add_argument("--skip-byz", action="store_true")
    p.add_argument("--skip-wire", action="store_true")
    p.add_argument("--skip-era", action="store_true")
    p.add_argument("--skip-proc", action="store_true")
    p.add_argument("--era-only", action="store_true",
                   help="run ONLY the era-switch gate (shadow-DKG cutover crossing >= 1 era "
                   "with the commit-gap bound asserted)")
    p.add_argument("--era-nodes", type=int, default=16, help="node count for the era-switch tier")
    p.add_argument("--byz-only", action="store_true",
                   help="run ONLY the Byzantine liveness-under-attack tier")
    p.add_argument("--wire-only", action="store_true",
                   help="run ONLY the wire-tier chaos gate (TCP link faults + Byzantine peer + "
                   "crash/restart)")
    p.add_argument("--wire-epochs", type=int, default=8,
                   help="wire-chaos tier committed-epoch target")
    p.add_argument("--proc-only", action="store_true",
                   help="run ONLY the process-tier chaos gate (real OS processes, real SIGKILL "
                   "+ disk-checkpoint restart, supervisor contract asserted)")
    p.add_argument("--proc-epochs", type=int, default=6,
                   help="process-chaos tier committed-epoch target (counted across the armed "
                   "window, per surviving node)")
    p.add_argument("--proc-workdir", default=None, metavar="DIR",
                   help="pin the process-chaos artifact directory (checkpoints, metrics/batch/"
                   "trace feeds, flight dumps) for a later obs.aggregate run; default: a fresh "
                   "tempdir")
    p.add_argument("--slo-only", action="store_true",
                   help="run ONLY the latency-SLO gate (honest leg green under a generous "
                   "SLO, chaos leg proving the violation path fires)")
    p.add_argument("--skip-slo", action="store_true")
    p.add_argument("--slo-epochs", type=int, default=10, help="epochs per SLO-gate leg (two legs)")
    p.add_argument("--rbc-only", action="store_true",
                   help="run ONLY the bandwidth-metered RBC variant gate (identical batches + "
                   "bytes/epoch delta bracha vs lowcomm)")
    p.add_argument("--skip-rbc", action="store_true")
    p.add_argument("--rbc-epochs", type=int, default=5,
                   help="epochs per RBC-gate leg (two metered legs)")
    p.add_argument("--engine", choices=["gpu", "cpu"], default="gpu",
                   help="every tier's crypto engine (gpu: the card, raises without one); the "
                   "process tier's children run on it too")
    p.add_argument("--device", default="cuda",
                   help="the gpu engine's torch device, and the sketch twin's")
    p.add_argument("--out", default="SOAK_torch.json",
                   help="where the rows go (the JAX package's SOAK.json is never written)")
    args = p.parse_args(argv)
    dev = {"engine": args.engine, "device": args.device}

    results = []
    only = (args.byz_only or args.wire_only or args.era_only or args.proc_only
            or args.rbc_only or args.slo_only)

    def emit(row: Dict) -> None:
        print(json.dumps(row), flush=True)
        results.append(row)

    if args.rbc_only or (not only and not args.skip_rbc):
        emit(rbc_soak(args.rbc_epochs, **dev))
    if not only:
        emit(sim_soak(args.epochs, **dev))
    if args.era_only or (not only and not args.skip_era):
        emit(era_soak(args.era_nodes, **dev))
    if args.slo_only or (not only and not args.skip_slo):
        emit(slo_soak(args.slo_epochs, **dev))
    if not args.skip_byz and not (args.wire_only or args.era_only or args.proc_only
                                  or args.rbc_only or args.slo_only):
        emit(byz_soak(args.byz_epochs or max(20, args.epochs // 5), **dev))
    if not args.skip_wire and not (args.byz_only or args.era_only or args.proc_only
                                   or args.rbc_only or args.slo_only):
        emit(wire_chaos_soak(args.wire_epochs, **dev))
    if args.proc_only or (not only and not args.skip_proc):
        emit(process_chaos_soak(args.proc_epochs, workdir=args.proc_workdir, **dev))
    if not args.skip_tcp and not only:
        emit(tcp_soak(args.tcp_epochs or args.epochs, **dev))
    with open(args.out, "w") as fh:
        json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
