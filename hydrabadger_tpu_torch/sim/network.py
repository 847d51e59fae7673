"""In-process multi-node HoneyBadger simulator on the port.

The port's copy of hydrabadger_tpu/sim/network.py: N QueueingHoneyBadger
(`protocol="qhb"`) or DynamicHoneyBadger (`protocol="dhb"`) nodes over the
deterministic router, a seeded transaction workload, and first-class
metrics (epochs/s, messages/epoch, committed transactions, agreement).
The same `SimConfig` gives, on the host engine, the same batches, message
counts and faults as the JAX package's `SimNetwork(engine="cpu")` on the
same core (Python or native): the same `trusted_setup` keys, the same draws from
every `random.Random` (a DHB node's DKG draws from its own
`random.Random(seed * 1_000_003 + 2 + index)`), the same delivery order.

The crypto engine is `SimConfig.engine`: "gpu" (the default; raises
without a card), "cpu" (the host engine, asked for by name) or an engine
instance.  As in the JAX package, every per-item crypto call of the cores
runs on the host.  The device calls are the low-comm broadcast's shard
sketches (`rbc_variant="lowcomm"`: `engine.homhash_batch`, kernel B1 on
the GPU engine) and, under "dhb" with the DKG's device plane on
(`tpu_dkg=True`, crypto/dkg), an era switch's batched MSMs, commitment
folds and channel keys on kernel B2, on the engine's device.  Crypto
tiers: pure protocol (`encrypt=False, coin_mode="hash"`), threshold
encryption and the threshold coin, and share verification
(`verify_shares=True`), all in pure-Python BLS.

Each epoch scopes three planes as the JAX sim does, restoring them after:
`tpu_dkg` (HYDRABADGER_GPU_DKG; None inherits it), `async_dispatch`
(HYDRABADGER_ASYNC) and `coalesce` (HYDRABADGER_COALESCE, on by default:
every node's DKG MSMs of a router tick flush as one batch).  Under "qhb"
they change nothing.

The adversarial scenario plane: `scenario` (sim/scenario.ScenarioSpec)
compiles into the router adversary and wraps the nodes it names in
sim/byzantine's attack strategies; progress and agreement are judged over
the honest nodes, and `verify_scenario()` checks the fault-observability
contract.  `slo` (obs/latency.SloSpec) is evaluated at every epoch over
the newly committed samples; a violation is a fault.  `timeline_report()`
aggregates a traced run's events (obs/aggregate).  A device error inside
an attacked run raises like any other: it is never counted as a fault.

The state census (obs/census.py) is sampled at every epoch boundary into
`census`, its `state_census_*` gauges into `metrics`; a sim snapshot
(checkpoint.save_sim) carries it.

The native ACS core (sim/native_acs, host C++): as in the JAX package, an
eligible config (no adversary or scenario, no encryption, the hash coin, no
byte metering, no tracing) runs each epoch's Subset storm in one `acs_run`
call and applies the agreed batch to every core in Python (votes, the DKG
transcript and era switches included).  `native_acs=None` takes it where
eligible unless HYDRABADGER_NO_NATIVE_ACS opts out; True raises where the
config is ineligible or the core is opted out; False runs the Python cores.
The broadcast variant does not enter eligibility (as in the JAX package):
an eligible low-comm config runs the native Bracha core and computes no
sketch.
"""
from __future__ import annotations

import os
import random
import time
from collections import OrderedDict
from contextlib import ExitStack, contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..consensus.dynamic_honey_badger import DynamicHoneyBadger
from ..consensus.queueing import QueueingHoneyBadger
from ..consensus.types import Fault, NetworkInfo
from ..crypto import dkg, futures
from ..crypto import threshold as th
from ..crypto.engine import get_engine
from ..obs import metrics as M
from ..obs.aggregate import aggregate_events
from ..obs.census import StateCensus, node_objects
from ..obs.latency import LatencySketch, SloTracker, TxnLifecycle, txn_id
from ..obs.metrics import MetricsRegistry
from ..obs.recorder import DOMAIN_PERF, NULL_RECORDER, Recorder
from ..utils.envflags import resolve_rbc_variant
from . import byzantine as byz
from . import native_acs
from .router import Router
from .scenario import ScenarioAdversary, assert_observability, fold_fault_counters


@dataclass
class SimConfig:
    n_nodes: int = 16
    protocol: str = "qhb"  # "qhb" | "dhb"
    epochs: int = 10
    # workload (the reference's defaults: 5 txns x 2 bytes per interval)
    txns_per_node_per_epoch: int = 5
    txn_bytes: int = 2
    batch_size: int = 100
    # crypto tier
    encrypt: bool = False
    coin_mode: str = "hash"  # "hash" | "threshold"
    verify_shares: bool = False
    engine: object = "gpu"  # "gpu" | "cpu" | an engine instance
    # scheduling
    seed: int = 0
    shuffle: bool = True
    adversary: Optional[Callable] = None
    # the adversarial scenario plane (sim/scenario.ScenarioSpec): link
    # faults, partition windows and ByzantineNode wrappers for the nodes it
    # names; mutually exclusive with `adversary`.  Strategies that forge
    # decryption shares assume verify_shares=True
    scenario: Optional[object] = None
    # router quiescence budget per epoch; None = auto (an epoch's message
    # complexity is O(N^3))
    max_messages_per_epoch: Optional[int] = None
    # the native ACS core (sim/native_acs): None = where eligible and not
    # opted out; True = required (raises where ineligible); False = never
    native_acs: Optional[bool] = None
    # the DKG's device plane (crypto/dkg, HYDRABADGER_GPU_DKG), on the
    # engine's device: None = inherit the environment; True/False = force
    # it for each run_epoch and restore it after (the JAX name is kept)
    tpu_dkg: Optional[bool] = None
    # the futures plane's cross-poll deferral (HYDRABADGER_ASYNC), scoped
    # like tpu_dkg
    async_dispatch: Optional[bool] = None
    # per-tick MSM coalescing (crypto/futures.MsmCoalescer): None = on
    coalesce: Optional[bool] = None
    # record consensus spans into SimNetwork.recorder; the router stamps
    # them at each delivery, plus a wire_tx/wire_rx event for every
    # `trace_wire_sample`-th enqueue when `trace_wire` is on
    trace: bool = False
    trace_wire: bool = True
    trace_wire_sample: int = 32
    # reliable-broadcast variant: None = HYDRABADGER_RBC or "bracha"
    rbc_variant: Optional[str] = None
    # price every router send and delivery at its codec size
    meter_bytes: bool = False
    # per-txn submit -> committed ledgers on every node (obs/latency.py);
    # "qhb" only: the dhb workload proposes opaque concatenated payloads
    txn_latency: bool = True
    # a latency SLO (obs/latency.SloSpec) evaluated at every epoch over the
    # newly committed e2e samples; a burn-rate violation is a fault
    slo: Optional[object] = None


@dataclass
class SimMetrics:
    epochs_done: int = 0
    wall_s: float = 0.0
    messages_delivered: int = 0
    txns_committed: int = 0
    bytes_committed: int = 0
    agreement_ok: bool = True
    faults: int = 0
    bytes_tx_total: int = 0
    bytes_rx_total: int = 0
    bytes_rx_by_kind: Dict[str, int] = field(default_factory=dict)
    latency_p50_ms: float = 0.0
    latency_p90_ms: float = 0.0
    latency_p99_ms: float = 0.0
    txn_latency: Dict[str, float] = field(default_factory=dict)

    @property
    def epochs_per_sec(self) -> float:
        return self.epochs_done / self.wall_s if self.wall_s else 0.0

    @property
    def msgs_per_epoch(self) -> float:
        return self.messages_delivered / self.epochs_done if self.epochs_done else 0.0

    @property
    def txns_per_sec(self) -> float:
        return self.txns_committed / self.wall_s if self.wall_s else 0.0

    @property
    def bytes_per_epoch(self) -> float:
        return self.bytes_tx_total / self.epochs_done if self.epochs_done else 0.0

    def as_dict(self) -> dict:
        return {
            "epochs_done": self.epochs_done,
            "wall_s": round(self.wall_s, 4),
            "epochs_per_sec": round(self.epochs_per_sec, 3),
            "messages_delivered": self.messages_delivered,
            "msgs_per_epoch": round(self.msgs_per_epoch, 1),
            "txns_committed": self.txns_committed,
            "txns_per_sec": round(self.txns_per_sec, 1),
            "bytes_committed": self.bytes_committed,
            "agreement_ok": self.agreement_ok,
            "faults": self.faults,
            "bytes_tx_total": self.bytes_tx_total,
            "bytes_rx_total": self.bytes_rx_total,
            "bytes_rx_by_kind": dict(sorted(self.bytes_rx_by_kind.items())),
            "bytes_per_epoch": round(self.bytes_per_epoch, 1),
            "latency_p50_ms": round(self.latency_p50_ms, 3),
            "latency_p90_ms": round(self.latency_p90_ms, 3),
            "latency_p99_ms": round(self.latency_p99_ms, 3),
            "txn_latency": dict(self.txn_latency),
        }


def trusted_setup(n: int, seed: int):
    """Dealer-based keys for simulation, draw for draw the JAX package's."""
    rng = random.Random(seed)
    ids = [f"n{i:03d}" for i in range(n)]
    t = (n - 1) // 3
    sks = th.SecretKeySet.random(t, rng)
    pk_set = sks.public_keys()
    netinfos = {nid: NetworkInfo(nid, ids, pk_set, sks.secret_key_share(i))
                for i, nid in enumerate(ids)}
    id_sks = {nid: th.SecretKey.random(rng) for nid in ids}
    return ids, netinfos, id_sks


@contextmanager
def _env_flag(name: str, flag: Optional[bool]):
    """Scoped boolean env override, restored on exit: a run forcing a
    plane must not leak it process-wide into later runs."""
    if flag is None:
        yield
        return
    prev = os.environ.get(name)
    os.environ[name] = "1" if flag else "0"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prev


class SimNetwork:
    # per-(receiver, sender) duplicate-frame LRU depth
    DUP_LRU_PER_SENDER = 128

    def __init__(self, cfg: SimConfig):
        if cfg.protocol not in ("qhb", "dhb"):
            raise ValueError(f"unknown protocol {cfg.protocol!r}")
        self.cfg = cfg
        self.ids, self.netinfos, self.id_sks = trusted_setup(cfg.n_nodes, cfg.seed)
        self.rng = random.Random(cfg.seed + 1)
        self.engine = get_engine(cfg.engine)
        # the DKG device plane runs on the engine's device ("cpu": the
        # host engine, or the plain versions)
        self.plane_device = getattr(self.engine, "device", torch.device("cpu"))
        self.rbc_variant = resolve_rbc_variant(cfg.rbc_variant)
        self.recorder = (Recorder(clock=time.perf_counter, clock_domain=DOMAIN_PERF)
                         if cfg.trace else NULL_RECORDER)
        self.metrics = MetricsRegistry()
        self.lifecycles: Dict = ({nid: TxnLifecycle() for nid in self.ids}
                                 if cfg.protocol == "qhb" and cfg.txn_latency else {})
        self.slo_tracker = SloTracker(cfg.slo) if cfg.slo is not None else None
        self._slo_cursor: Dict = {nid: 0 for nid in self.lifecycles}
        if cfg.protocol == "qhb":
            self.nodes: Dict = {
                nid: QueueingHoneyBadger(
                    self.netinfos[nid],
                    batch_size=cfg.batch_size,
                    encrypt=cfg.encrypt,
                    coin_mode=cfg.coin_mode,
                    verify_shares=cfg.verify_shares,
                    engine=self.engine,
                    recorder=self.recorder.bind(node=nid),
                    rbc_variant=self.rbc_variant,
                    lifecycle=self.lifecycles.get(nid),
                )
                for nid in self.ids
            }
        else:
            pub_keys = {nid: self.id_sks[nid].public_key() for nid in self.ids}
            self.nodes = {
                nid: DynamicHoneyBadger(
                    nid,
                    self.id_sks[nid],
                    self.netinfos[nid],
                    pub_keys,
                    encrypt=cfg.encrypt,
                    coin_mode=cfg.coin_mode,
                    verify_shares=cfg.verify_shares,
                    # per-node seed: DKG secrets must differ across nodes
                    rng=random.Random(cfg.seed * 1_000_003 + 2 + idx),
                    engine=self.engine,
                    recorder=self.recorder.bind(node=nid),
                    rbc_variant=self.rbc_variant,
                )
                for idx, nid in enumerate(self.ids)
            }
        adversary, byzantine = self._compile_scenario()
        # wrapping replaces entries: the roster keeps the fixed topology
        self.nodes = {nid: byzantine.get(nid, node) for nid, node in self.nodes.items()}
        self.honest_ids = [nid for nid in self.ids if not hasattr(self.nodes[nid], "unwrap")]
        self.router = Router(
            self.ids,
            self._handle,
            adversary=adversary,
            seed=cfg.seed + 3,
            shuffle=cfg.shuffle,
            recorder=self.recorder,
            metrics=self.metrics,
            meter_bytes=cfg.meter_bytes,
            wire_events=cfg.trace_wire,
            wire_sample=cfg.trace_wire_sample,
        )
        # the tick boundary: the router settles in-flight device work at
        # each quiescence
        self.router.drain_hook = self._drain_async
        self.router.lifecycles = self.lifecycles
        self._txn_counter = 0
        self.total_wall_s = 0.0  # cumulative across run() calls
        self.epoch_durations: List[float] = []
        # per-sender duplicate-frame LRU: every handler is duplicate-
        # tolerant, so an identical (sender, message) re-delivery is
        # absorbed before the core re-verifies it; only roster senders
        # are tracked, so adversary-minted ids cannot grow it
        self._dup_seen: Dict = {}
        self._dup_ids = frozenset(self.ids)
        # era-gap accounting: the highest era any node has reached, and
        # the steady (no live keygen, no era flip) epoch durations
        self._era_seen = 0
        self._steady_durations: List[float] = []
        # the per-epoch state census: every declared container's size
        self.census = StateCensus(metrics=self.metrics)

    def _compile_scenario(self) -> Tuple[Optional[Callable], Dict]:
        """The router's adversary (`cfg.adversary`, or the scenario compiled
        into a ScenarioAdversary) and, by id, the nodes the scenario names
        wrapped in their attack strategies (each seeded as the JAX sim seeds
        it)."""
        self.scenario_log = None
        scen = self.cfg.scenario
        if scen is None:
            return self.cfg.adversary, {}
        if self.cfg.adversary is not None:
            raise ValueError("SimConfig.scenario and SimConfig.adversary are mutually exclusive")
        adv = ScenarioAdversary(scen, self.ids, metrics=self.metrics)
        self.scenario_log = adv.log
        wrapped = {}
        for idx, names in sorted(scen.byzantine_map().items()):
            nid = self.ids[idx]
            wrapped[nid] = byz.ByzantineNode(
                self.nodes[nid],
                byz.build_strategies(names, random.Random(scen.seed * 7919 + 11 + idx), adv.log),
                log=adv.log,
            )
        return adv, wrapped

    def _handle(self, me, sender, message):
        if sender in self._dup_ids:
            per = self._dup_seen.setdefault(me, {}).setdefault(sender, OrderedDict())
            try:
                if message in per:
                    per.move_to_end(message)
                    self.metrics.counter(M.BYZ_DUP_SUPPRESSED).inc()
                    return None
                per[message] = None
                if len(per) > self.DUP_LRU_PER_SENDER:
                    per.popitem(last=False)
            except TypeError:
                pass  # unhashable message shape: deliver without dedup
        return self.nodes[me].handle_message(sender, message)

    def _gen_txn(self) -> bytes:
        self._txn_counter += 1
        prefix = self._txn_counter.to_bytes(4, "big")
        pad = max(0, self.cfg.txn_bytes - 4)
        return prefix + bytes(self.rng.getrandbits(8) for _ in range(pad))

    def _native_eligible(self) -> bool:
        cfg = self.cfg
        if cfg.native_acs is False:
            return False
        ok = (
            cfg.adversary is None
            and cfg.scenario is None
            and not cfg.encrypt
            and cfg.coin_mode == "hash"
            # the native core has no message plane to meter
            and not cfg.meter_bytes
            # nor the consensus spans and wire events a traced run wants
            and not self.recorder.enabled
        )
        if cfg.native_acs is True:
            if not ok:
                raise ValueError("native_acs=True requires fast tier, hash coin, no adversary, "
                                 "no byte metering, no tracing")
            if not native_acs.available():
                raise RuntimeError("native_acs=True, but HYDRABADGER_NO_NATIVE_ACS opts out of the "
                                   "native ACS core")
            return True
        return ok and native_acs.available()

    def _run_epoch_native(self) -> None:
        """One epoch through the native ACS core: gather the contributions,
        agree natively, apply the batch to every core's QHB/DHB pipeline
        (votes, era switches and queue pruning run in Python as on the
        message plane)."""
        cfg = self.cfg
        if cfg.protocol == "qhb":
            for nid in self.ids:
                lc = self.lifecycles.get(nid)
                for _ in range(cfg.txns_per_node_per_epoch):
                    txn = self._gen_txn()
                    if lc is not None and not lc.submit(txn_id(txn), time.perf_counter()):
                        self.metrics.counter(M.TXN_RESUBMITTED).inc()
                    self.nodes[nid].push_transaction(txn)
            validators = list(self.ids)
            payloads = [self.nodes[nid].external_contribution(self.rng) for nid in validators]
        else:
            validators = [nid for nid in self.ids if self.nodes[nid].is_validator]
            payloads = [
                self.nodes[nid].external_contribution(
                    b"".join(self._gen_txn() for _ in range(cfg.txns_per_node_per_epoch)))
                for nid in validators
            ]
        hb = self.nodes[validators[0]].hb
        if list(hb.netinfo.node_ids) != validators:
            raise RuntimeError(f"validator order drift: {hb.netinfo.node_ids} != {validators}")
        sid = hb.session_id + b"/" + str(hb.epoch).encode()
        mask, stats = native_acs.acs_run(payloads, hb.netinfo.num_faulty, sid,
                                         shuffle=cfg.shuffle, seed=cfg.seed * 1_000_003 + hb.epoch)
        contributions = {nid: payloads[i] for i, nid in enumerate(validators) if mask[i]}
        self.router.delivered += stats.delivered
        for nid in self.ids:
            step = self.nodes[nid].apply_external_batch(dict(contributions))
            if step.messages:  # era-switch follow-up traffic, if any
                self.router.dispatch_step(nid, step)
        if self.lifecycles:
            # no per-delivery boundary here: the batch application is the
            # epoch's commit moment
            now = time.perf_counter()
            for lc in self.lifecycles.values():
                lc.stamp(now)
        if self.router.queue:
            self.router.run(cfg.max_messages_per_epoch or max(1_000_000, 60 * cfg.n_nodes**3))

    def _planes(self) -> ExitStack:
        """The epoch's scoped planes: the DKG's device plane and its device,
        the futures' deferral, the per-tick MSM coalescer (on by default)."""
        cfg = self.cfg
        stack = ExitStack()
        stack.enter_context(_env_flag(dkg.GPU_DKG_ENV, cfg.tpu_dkg))
        stack.enter_context(_env_flag("HYDRABADGER_ASYNC", cfg.async_dispatch))
        stack.enter_context(_env_flag("HYDRABADGER_COALESCE",
                                      True if cfg.coalesce is None else cfg.coalesce))
        stack.enter_context(dkg.plane_device(self.plane_device))
        return stack

    def run_epoch(self) -> None:
        """Generate the workload, propose everywhere, run to quiescence."""
        with self._planes():
            self._run_epoch_inner()
            self._drain_async()
        self._note_era_gap()
        # events emitted outside a delivery (the proposals) are stamped at
        # the epoch boundary, the sim's other I/O boundary
        if self.recorder.enabled:
            self.recorder.stamp(time.perf_counter())
        if self.lifecycles:
            now = time.perf_counter()
            for lc in self.lifecycles.values():
                lc.stamp(now)
            self._note_txn_latency()

    def _note_txn_latency(self) -> None:
        """Mirror the cross-node e2e sketch merge and the lifecycle counts
        into the registry."""
        merged = LatencySketch()
        submitted = committed = 0
        for lc in self.lifecycles.values():
            merged.merge(lc.sketches["e2e"])
            submitted += lc.submitted
            committed += lc.committed_count
        self.metrics.counter(M.TXN_SUBMITTED).value = submitted
        self.metrics.counter(M.TXN_COMMITTED).value = committed
        if merged.count:
            pcts = merged.percentiles()
            self.metrics.gauge(M.TXN_LATENCY_P50_S).track(round(pcts["p50"], 6))
            self.metrics.gauge(M.TXN_LATENCY_P90_S).track(round(pcts["p90"], 6))
            self.metrics.gauge(M.TXN_LATENCY_P99_S).track(round(pcts["p99"], 6))
            self.metrics.gauge(M.TXN_LATENCY_P999_S).track(round(pcts["p999"], 6))
        if self.slo_tracker is None:
            return
        # the SLO sees each newly committed sample once; a violation is a
        # fault in the router's log, like a silently tolerated attack
        for nid, lc in self.lifecycles.items():
            for v in lc.samples[self._slo_cursor.get(nid, 0):]:
                self.slo_tracker.observe(v)
            self._slo_cursor[nid] = len(lc.samples)
        msg = self.slo_tracker.check()
        if msg is not None:
            self.metrics.counter(M.SLO_VIOLATIONS).inc()
            self.router.faults.append(("slo", Fault("slo", msg)))

    def span_sketches(self) -> Dict[str, LatencySketch]:
        """Cross-node merge of every lifecycle span sketch, fresh objects."""
        merged: Dict[str, LatencySketch] = {}
        for lc in self.lifecycles.values():
            for name, sp in lc.sketches.items():
                merged.setdefault(name, LatencySketch(sp.rel_err)).merge(sp)
        return merged

    def txn_latency_snapshot(self) -> dict:
        """Merged e2e percentiles (seconds) and the lifecycle counts."""
        merged = self.span_sketches().get("e2e")
        if merged is None or not merged.count:
            return {}
        out = {k: round(v, 6) for k, v in merged.percentiles().items() if v is not None}
        out["count"] = merged.count
        out["submitted"] = sum(lc.submitted for lc in self.lifecycles.values())
        out["resubmitted"] = sum(lc.resubmitted for lc in self.lifecycles.values())
        return out

    def exact_e2e_samples(self) -> List[float]:
        """Every node's exact retained e2e samples (the sketches' ground
        truth)."""
        return [v for lc in self.lifecycles.values() for v in lc.samples]

    def timeline_report(self) -> Optional[dict]:
        """The traced run's cluster timeline (obs/aggregate): per-epoch
        critical path and wire-event message latency over the shared
        recorder; None when tracing is off.  One clock: no alignment."""
        if not self.recorder.enabled:
            return None
        return aggregate_events(list(self.recorder.events))

    def _note_era_gap(self) -> None:
        """After each epoch: the committed-epoch gap across an era-switch
        window (a keygen live or the era flipped) against the steady
        durations, and the loud-stall mirror of the shadow DKG."""
        if not self.epoch_durations:
            return
        dur = self.epoch_durations[-1]
        nodes = [self.nodes[nid] for nid in self.ids]
        kg_live = any(getattr(n, "key_gen", None) is not None for n in nodes)
        era_now = max(getattr(n, "era", 0) for n in nodes)
        stall = max([n.shadow_stall_epochs() for n in nodes if hasattr(n, "shadow_stall_epochs")]
                    + [0])
        switched = era_now != self._era_seen
        self._era_seen = era_now
        if kg_live or switched:
            self.metrics.gauge(M.ERA_COMMIT_GAP_S).track(round(dur, 4))
        elif len(self._steady_durations) < 4096:
            self._steady_durations.append(dur)
        self.metrics.gauge(M.SHADOW_DKG_STALL_EPOCHS).track(stall)

    def steady_epoch_p50(self) -> float:
        """Median steady epoch wall (no live keygen, no era flip)."""
        if not self._steady_durations:
            return 0.0
        ordered = sorted(self._steady_durations)
        return ordered[len(ordered) // 2]

    def era_gap_snapshot(self) -> dict:
        """The era-cutover gauges as one dict, with the device provenance of
        the futures' gauges."""
        gap = self.metrics.gauge(M.ERA_COMMIT_GAP_S).high_water
        steady = self.steady_epoch_p50()
        backend = futures.device_backend()
        return {
            "era_commit_gap_s": round(gap, 4),
            "steady_epoch_p50_s": round(steady, 4),
            "era_gap_vs_steady": round(gap / steady, 2) if steady else 0.0,
            "shadow_dkg": dkg.shadow_scheduling(),
            "shadow_dkg_stall_epochs": self.metrics.gauge(M.SHADOW_DKG_STALL_EPOCHS).high_water,
            "device_backend": backend,
            "device_overlap_has_device": 1 if backend == "gpu" else 0,
        }

    def _drain_async(self) -> None:
        """The tick boundary: settle every node's in-flight crypto (a DHB
        node's keygen flush), surface the futures' overlap gauges in this
        sim's registry, and fail the run here if any CryptoFuture was
        dropped unmaterialized (device work and its protocol effect
        silently discarded)."""
        for nid in self.ids:
            drain = getattr(self.nodes[nid], "drain_async", None)
            if drain is not None:
                self.router.dispatch_step(nid, drain())
        futures.stamp_gauges(self.metrics)
        futures.check_dropped()

    def _run_epoch_inner(self) -> None:
        t0 = time.perf_counter()
        cfg = self.cfg
        if self._native_eligible():
            self._run_epoch_native()
            self.epoch_durations.append(time.perf_counter() - t0)
            self._census_sample()
            return
        if cfg.protocol == "dhb":
            for nid in self.ids:
                node = self.nodes[nid]
                if node.is_validator:
                    payload = b"".join(self._gen_txn() for _ in range(cfg.txns_per_node_per_epoch))
                    self.router.dispatch_step(nid, node.propose(payload, self.rng))
        else:
            self._propose_qhb()
        self.router.run(cfg.max_messages_per_epoch or max(1_000_000, 60 * cfg.n_nodes**3))
        self.epoch_durations.append(time.perf_counter() - t0)
        self._census_sample()

    def _census_sample(self) -> None:
        """One state-census row per epoch: every node's consensus core
        (unwrapped from any Byzantine shim), the network, the router and
        the latency plane's ledgers."""
        objs: list = [self, self.router]
        for nid in self.ids:
            node = self.nodes[nid]
            unwrap = getattr(node, "unwrap", None)
            if unwrap is not None:
                node = unwrap()
            objs.extend(node_objects(node))
        objs.extend(self.lifecycles.values())
        self.census.sample(objs, label=len(self.epoch_durations))

    def _propose_qhb(self) -> None:
        for nid in self.ids:
            lc = self.lifecycles.get(nid)
            for _ in range(self.cfg.txns_per_node_per_epoch):
                txn = self._gen_txn()
                # submission is stamped per txn at enqueue; a deduplicated
                # resubmission keeps the original's stamp
                if lc is not None and not lc.submit(txn_id(txn), time.perf_counter()):
                    self.metrics.counter(M.TXN_RESUBMITTED).inc()
                self.nodes[nid].push_transaction(txn)
            if lc is not None:
                lc.stamp(time.perf_counter())  # admitted notes
        for nid in self.ids:
            self.router.dispatch_step(nid, self.nodes[nid].force_propose(self.rng))
            lc = self.lifecycles.get(nid)
            if lc is not None:
                lc.stamp(time.perf_counter())  # proposed notes

    def run(self, epochs: Optional[int] = None) -> SimMetrics:
        """Run `epochs` more epochs; the metrics are lifetime-cumulative."""
        epochs = self.cfg.epochs if epochs is None else epochs
        m = SimMetrics()
        t0 = time.perf_counter()
        for _ in range(epochs):
            self.run_epoch()
        self.total_wall_s += time.perf_counter() - t0
        m.wall_s = self.total_wall_s
        m.messages_delivered = self.router.delivered
        m.faults = len(self.router.faults)
        m.bytes_tx_total = self.router.bytes_tx
        m.bytes_rx_total = self.router.bytes_rx
        m.bytes_rx_by_kind = dict(self.router.bytes_rx_by_kind)
        # progress and agreement are judged over the honest nodes: liveness
        # under attack is a claim about what the honest quorum commits
        m.epochs_done = min(len(self._batches(nid)) for nid in self.honest_ids)
        m.agreement_ok = self._check_agreement()
        if self.cfg.meter_bytes:
            self.metrics.counter(M.BYTES_TX_TOTAL).value = m.bytes_tx_total
            self.metrics.counter(M.BYTES_RX_TOTAL).value = m.bytes_rx_total
            self.metrics.gauge(M.BYTES_PER_EPOCH).track(round(m.bytes_per_epoch, 1))
        if self.epoch_durations:
            ordered = sorted(self.epoch_durations)

            def pct(q: float) -> float:
                return ordered[min(len(ordered) - 1, int(q * len(ordered)))] * 1000.0

            m.latency_p50_ms, m.latency_p90_ms, m.latency_p99_ms = pct(0.50), pct(0.90), pct(0.99)
        m.txn_latency = self.txn_latency_snapshot()
        for batch in self._batches(self.honest_ids[0]):
            for _, txns in sorted(batch.contributions.items()):
                if isinstance(txns, (list, tuple)):
                    m.txns_committed += len(txns)
                    m.bytes_committed += sum(len(t) for t in txns)
                else:  # a dhb contribution: one opaque payload
                    m.bytes_committed += len(txns)
        return m

    def verify_scenario(self) -> None:
        """Assert the fault-observability contract (sim/scenario.py): fold
        the run's fault log into the ``byz_faults_*`` counters, then check
        that every injected kind surfaced."""
        if self.scenario_log is None:
            raise RuntimeError("no scenario attached to this SimNetwork")
        fold_fault_counters(self.router.faults, self.metrics, injected=set(self.scenario_log.counts))
        assert_observability(self.scenario_log, self.router.faults, self.metrics)

    def shutdown(self) -> None:
        """Teardown: fail loudly if any CryptoFuture was dropped."""
        self._drain_async()

    def queue_peaks(self) -> dict:
        """High-water marks of the sim tier's bounded buffers: the router's
        queue, a core's deferred future-epoch messages, and a DHB node's
        future-era messages."""
        deferred = max((len(self.nodes[nid].hb.deferred) for nid in self.ids), default=0)
        future = max((len(getattr(self.nodes[nid], "future_msgs", ())) for nid in self.ids),
                     default=0)
        return {
            "router_queue": self.metrics.gauge(M.ROUTER_QUEUE_DEPTH).high_water,
            "deferred": deferred,
            "future": future,
        }

    def _batches(self, nid) -> List:
        return self.nodes[nid].batches

    def batch_bytes(self, nid) -> List[tuple]:
        """A node's committed batches as (epoch, ((proposer, txns), ...)),
        a dhb contribution as its payload bytes."""
        return [(b.epoch, tuple((p, tuple(bytes(t) for t in v) if isinstance(v, (list, tuple))
                                 else bytes(v))
                                for p, v in sorted(b.contributions.items())))
                for b in self._batches(nid)]

    def _check_agreement(self) -> bool:
        seqs = {nid: [items for _e, items in self.batch_bytes(nid)] for nid in self.honest_ids}
        shortest = min(len(s) for s in seqs.values())
        first = seqs[self.honest_ids[0]][:shortest]
        return all(s[:shortest] == first for s in seqs.values())


# -- canned adversaries -----------------------------------------------------


def drop_adversary(rate: float, seed: int = 0) -> Callable:
    """Drop a uniform fraction of messages (a lossy channel: liveness, not
    safety, may suffer)."""
    rng = random.Random(seed)

    def adv(sender, recipient, message):
        if rng.random() < rate:
            return []
        return None

    return adv


def duplicate_adversary(rate: float, seed: int = 0) -> Callable:
    rng = random.Random(seed)

    def adv(sender, recipient, message):
        if rng.random() < rate:
            return [(sender, recipient, message), (sender, recipient, message)]
        return None

    return adv


def delay_adversary(rate: float, max_delay: int = 64, seed: int = 0) -> Callable:
    """Hold a fraction of messages back, releasing each after 1..max_delay
    later deliveries pass it (reordering; agreement must survive it)."""
    rng = random.Random(seed)
    held: List[tuple] = []  # (release_countdown, sender, recipient, message)

    def adv(sender, recipient, message):
        out = []  # releases as explicit triples, so the sender survives
        for i in range(len(held) - 1, -1, -1):
            cnt, s, r, m = held[i]
            if cnt <= 1:
                out.append((s, r, m))
                held.pop(i)
            else:
                held[i] = (cnt - 1, s, r, m)
        if rng.random() < rate:
            held.append((rng.randint(1, max_delay), sender, recipient, message))
            return out
        return out + [(sender, recipient, message)]

    def flush():
        """Release everything still held (the router calls it at
        quiescence, so delays model reordering, not loss)."""
        released = [(s, r, m) for _cnt, s, r, m in held]
        held.clear()
        return released

    adv.flush = flush
    return adv


def crash_adversary(crashed, after_deliveries: int = 0) -> Callable:
    """Fail-stop: silence all traffic from `crashed` nodes after their first
    `after_deliveries` point-to-point deliveries."""
    crashed = set(crashed)
    sent: Dict = {}

    def adv(sender, recipient, message):
        if sender in crashed:
            n = sent.get(sender, 0) + 1
            sent[sender] = n
            if n > after_deliveries:
                return []
        return None

    return adv


def byzantine_adversary(corrupt, seed: int = 0) -> Callable:
    """Corrupt nodes replay earlier messages to random victims on top of
    their real traffic; honest nodes must still agree."""
    corrupt = set(corrupt)
    rng = random.Random(seed)
    history: List[tuple] = []

    def adv(sender, recipient, message):
        if sender not in corrupt:
            return None
        out = [(sender, recipient, message)]
        if history and rng.random() < 0.5:
            _, old = history[rng.randrange(len(history))]
            out.append((sender, recipient, old))
        if len(history) < 10_000:
            history.append((sender, message))
        return out

    return adv
