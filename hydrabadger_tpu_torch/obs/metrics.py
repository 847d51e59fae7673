"""Process-local counters, gauges with high-water marks and fixed-edge
histograms: the port's copy of hydrabadger_tpu/obs/metrics.py.
`snapshot()` returns one JSON-able dict.

Every metric name the port mints is declared here, each constant with
the JAX package's identifier and string where the JAX package has the
name; the names only the port mints (the verify-batch counters of the
card's signature batches, the verified threshold-decrypt epoch's) sit
beside them.  The JAX package's
retrace_sigs_ and mul_batch_* families have no counterpart: the port
has no jit entry points and no padded scalar-mul lanes.  The contract
is machine-checked by `python -m hydrabadger_tpu_torch.lint`
(contract-drift)."""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

from .latency import LatencySketch


def _round_q(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(v, 6)


# the futures' overlap gauges (crypto/futures.stamp_gauges)
DEVICE_OVERLAP_RATIO = "device_overlap_ratio"
DEVICE_IDLE_S = "device_idle_s"
DEVICE_OVERLAP_HAS_DEVICE = "device_overlap_has_device"
# every future made (crypto/futures): submitted and fetched (an immediate
# future counts as both at once), and dropped without result()
CRYPTO_FUTURES_SUBMITTED = "crypto_futures_submitted"
CRYPTO_FUTURES_FETCHED = "crypto_futures_fetched"
CRYPTO_FUTURES_DROPPED = "crypto_futures_dropped"

# the router's byte meter, mirrored by SimNetwork.run; on the TCP tier the
# framed bytes at each node's streams (net/wire.WireStream), received bytes
# also by wire kind under the prefix
BYTES_TX_TOTAL = "bytes_tx_total"
BYTES_RX_TOTAL = "bytes_rx_total"
BYTES_PER_EPOCH = "bytes_per_epoch"
BYTES_RX_BY_KIND_PREFIX = "bytes_rx_by_kind_"

# the TCP tier's wire-signature batches on the card (GpuEngine.verify_batch's
# r_i * pk_i terms on kernel B2): device batches, their lanes, and the host
# ms of the affine conversion (ops/limbs.limbs_to_points)
VERIFY_DEVICE_BATCHES = "verify_batch_device_batches"
VERIFY_DEVICE_LANES = "verify_batch_device_lanes"
VERIFY_TO_POINTS_MS = "verify_batch_to_points_ms"

# the verified threshold-decrypt epoch (sim/tensor.FullCryptoTensorSim with
# verify on, ops/verify_torch): decryption shares whose pairing check failed
# on the device, and the host seconds of issuing the verify stage, one
# observation an epoch
TDEC_SHARES_REJECTED = "tdec_shares_rejected"
VERIFY_ISSUE_S = "verify_issue_s"

# the sim's queue and adversary counters
ROUTER_QUEUE_DEPTH = "router_queue_depth"
ROUTER_ADV_ABSORBED = "router_adv_absorbed"
ROUTER_ADV_EMITTED = "router_adv_emitted"
BYZ_DUP_SUPPRESSED = "byz_dup_suppressed"

# the sketch plane's lanes per dispatch (ops/homhash_torch)
HOMHASH_REAL_LANES = "homhash_real_lanes"
HOMHASH_PAD_LANES = "homhash_pad_lanes"
HOMHASH_LANE_OCCUPANCY = "homhash_lane_occupancy"

# the DKG's MSM plane (ops/msm_torch): lanes per dispatch, padding and real
MSM_BATCH_LANES = "msm_batch_lanes"
MSM_PAD_LANES = "msm_pad_lanes"
MSM_REAL_LANES = "msm_real_lanes"
# the per-tick MSM coalescer (crypto/futures.MsmCoalescer)
MSM_COALESCE_SUBMISSIONS = "msm_coalesce_submissions"
MSM_COALESCE_FLUSHES = "msm_coalesce_flushes"
MSM_COALESCE_WIDTH = "msm_coalesce_width"
# the Fr multipoint plane (ops/fr_poly): NTT lanes per call
FR_NTT_BATCH_LANES = "fr_ntt_batch_lanes"
FR_NTT_PAD_LANES = "fr_ntt_pad_lanes"
FR_NTT_REAL_LANES = "fr_ntt_real_lanes"
# the GF(2^8) additive-FFT plane (ops/ntt_torch): lanes per transform, the
# zero padding to the 2^m grid and the real coefficient rows' lanes
NTT_BATCH_LANES = "ntt_batch_lanes"
NTT_PAD_LANES = "ntt_pad_lanes"
NTT_REAL_LANES = "ntt_real_lanes"

# the shadow-DKG era cutover (sim/network.py): the high-water wall between
# committed batches across an era-switch window, and the epochs since a
# live shadow DKG last advanced
ERA_COMMIT_GAP_S = "era_commit_gap_s"
SHADOW_DKG_STALL_EPOCHS = "shadow_dkg_stall_epochs"

# transaction latency (obs/latency.py)
TXN_LATENCY_P50_S = "txn_latency_p50_s"
TXN_LATENCY_P90_S = "txn_latency_p90_s"
TXN_LATENCY_P99_S = "txn_latency_p99_s"
TXN_LATENCY_P999_S = "txn_latency_p999_s"
TXN_SUBMITTED = "txn_submitted"
TXN_RESUBMITTED = "txn_resubmitted"
TXN_COMMITTED = "txn_committed"

# the per-epoch state census (obs/census.py): one gauge per declared
# "Class.attr" container, a fixed keyspace
STATE_CENSUS_PREFIX = "state_census_"

# the Byzantine scenario plane (sim/scenario.py): both prefixes are suffixed
# by a consensus/types.py BYZ_* token, so the family stays bounded by the
# fixed taxonomy whatever the injection volume.  BYZ_INJECTED_PREFIX counts
# what the plane did; BYZ_FAULTS_PREFIX what the system observed (fault_log
# entries folded in by the verifier, or the injection itself for the kinds
# an asynchronous system cannot detect)
BYZ_INJECTED_PREFIX = "byz_injected_"
BYZ_FAULTS_PREFIX = "byz_faults_"

# SloTracker burn-rate violations pushed through the fault ring
SLO_VIOLATIONS = "slo_violations"

# durable checkpoints (checkpoint.CheckpointStore and the node's cadence):
# generations written; a corrupt generation rejected at load; a load served
# by an older generation; a persist that raised (disk full: the node keeps
# committing); a persist skipped because the previous write still syncs
CHECKPOINTS_PERSISTED = "checkpoints_persisted"
CHECKPOINT_CORRUPT_REJECTED = "checkpoint_corrupt_rejected"
CHECKPOINT_GENERATION_FALLBACKS = "checkpoint_generation_fallbacks"
CHECKPOINT_PERSIST_FAILURES = "checkpoint_persist_failures"
CHECKPOINT_PERSISTS_SKIPPED = "checkpoint_persists_skipped"

# Wire-tier detection counters (net/node.py fault paths).  Every name is
# fixed here so the wire-tier observability contract
# (net/chaos.py:WIRE_FAULT_OBSERVABLES) and the detection sites bind to
# one spelling — a renamed counter would silently void the contract:
#
#   WIRE_SIG_REJECTED — a verified-kind frame failed its BLS signature
#       check (the observable for in-flight signature corruption).
#   WIRE_FRONTIER_REJECTED — a net_state frontier claim failed its
#       validator signature check.
#   WIRE_SRC_SPOOF — a message/key_gen frame claimed a source other
#       than the authenticated connection peer.
#   PEER_DISCONNECTS — established connections torn down (the
#       observable for injected connection resets).
#   WIRE_RETRY_ABANDONED — a targeted frame dropped LOUDLY after its
#       per-frame retry budget was exhausted.
#   NODE_FAST_FORWARDS — a stranded validator/observer re-adopted the
#       network's certified (era, epoch) frontier (the crash/restart
#       recovery observable).
WIRE_SIG_REJECTED = "wire_sig_rejected"
WIRE_FRONTIER_REJECTED = "wire_frontier_rejected"
WIRE_SRC_SPOOF = "wire_src_spoof"
PEER_DISCONNECTS = "peer_disconnects"
WIRE_RETRY_ABANDONED = "wire_retry_abandoned"
NODE_FAST_FORWARDS = "node_fast_forwards"

# Per-kind received-frame counters: the prefix is suffixed by a
# net/wire.py:KINDS member, so the family is bounded by the fixed wire
# vocabulary (same stance as BYTES_RX_BY_KIND_PREFIX).
WIRE_RX_PREFIX = "wire_rx_"

# Epoch/commit plane (net/node.py commit path):
#
#   EPOCHS_COMMITTED — committed epochs, the denominator every per-epoch
#       rate (bytes, duration, faults) divides by.
#   EPOCH_DURATION_S — histogram of wall seconds per committed epoch.
#   CONSENSUS_FAULTS — fault_log entries the cores reported (the raw
#       feed the byz_faults_* attribution folds from).
EPOCHS_COMMITTED = "epochs_committed"
EPOCH_DURATION_S = "epoch_duration_s"
CONSENSUS_FAULTS = "consensus_faults"

# Crash/partition healing plane (net/node.py recovery paths).  The
# wire-tier observability contract (net/chaos.py) reads several of
# these, so the spellings are load-bearing:
#
#   WELCOME_BACK_REPLAYS — a reconnecting peer was served the in-flight
#       epoch's traffic again (barely-behind recovery).
#   OBSERVER_ADOPTIONS — a voted-out-and-readded node recovered through
#       observer adoption.
#   EPOCH_REPLAYS — epoch outbox replays served to lagging peers (the
#       partition/link-loss healing observable).
#   EPOCH_REPLAYS_SUPPRESSED — replay requests absorbed by the
#       per-peer replay budget.
#   WIRE_RETRY_DROPPED — frames dropped when the retry ring was full
#       (bounded loss under sustained peer absence).
#   HANDSHAKE_TIMEOUTS — inbound connections that never completed the
#       hello exchange.
WELCOME_BACK_REPLAYS = "welcome_back_replays"
OBSERVER_ADOPTIONS = "observer_adoptions"
EPOCH_REPLAYS = "epoch_replays"
EPOCH_REPLAYS_SUPPRESSED = "epoch_replays_suppressed"
WIRE_RETRY_DROPPED = "wire_retry_dropped"
HANDSHAKE_TIMEOUTS = "handshake_timeouts"

# Bounded-queue inventory: every bounded queue of the node exports its
# depth as a gauge (current, high-water) and its shed events as a
# counter, sampled by net/node.py's per-epoch census (ROUTER_QUEUE_DEPTH
# above is the sim router's).
INTERNAL_QUEUE_DEPTH = "internal_queue_depth"
INTERNAL_QUEUE_OVERFLOWS = "internal_queue_overflows"
WIRE_RETRY_DEPTH = "wire_retry_depth"
EPOCH_OUTBOX_DEPTH = "epoch_outbox_depth"
KEYGEN_OUTBOX_DEPTH = "keygen_outbox_depth"
KEYGEN_INBOX_DEPTH = "keygen_inbox_depth"
IOM_QUEUE_DEPTH = "iom_queue_depth"
PENDING_USER_DEPTH = "pending_user_depth"
PENDING_ACKS_DEPTH = "pending_acks_depth"
PEER_SEND_QUEUE_DEPTH = "peer_send_queue_depth"
PEER_SEND_QUEUE_OVERFLOWS = "peer_send_queue_overflows"

# Transport/bridge bookkeeping:
#
#   WIRE_TX_FRAMES — frames handed to peer send queues.
#   BRIDGE_* — the crypto micro-batching bridge's dispatch plane
#       (net/bridge.py).
#   CHAOS_PARTITION_LOST / CHAOS_DELAY_LOST — a chaos-held frame whose
#       connection died before release: at the wire tier a hold CAN
#       become a loss, and the counter keeps it observable.
WIRE_TX_FRAMES = "wire_tx_frames"
BRIDGE_BATCHES_DISPATCHED = "bridge_batches_dispatched"
BRIDGE_REQUESTS_SERVED = "bridge_requests_served"
CHAOS_PARTITION_LOST = "chaos_partition_lost"
CHAOS_DELAY_LOST = "chaos_delay_lost"

# Process-tier supervisor (net/cluster.py): child lifecycle counts the
# crash-restart soak rows assert on.
PROC_SPAWNS = "proc_spawns"
PROC_SIGKILLS = "proc_sigkills"
PROC_SIGTERMS = "proc_sigterms"
PROC_RESTARTS = "proc_restarts"
PROC_UNEXPECTED_EXITS = "proc_unexpected_exits"


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-set value plus the high-water mark since creation."""

    __slots__ = ("value", "high_water")

    def __init__(self):
        self.value = 0
        self.high_water = 0

    def set(self, v) -> None:
        self.value = v
        if v > self.high_water:
            self.high_water = v

    track = set


# Default edges suit epoch and stage durations in seconds: 1 ms .. ~1 min.
DEFAULT_EDGES: Tuple[float, ...] = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0)


class Histogram:
    """Fixed-edge histogram: ``counts[i]`` counts observations ``v`` with
    ``edges[i-1] < v <= edges[i]``; ``counts[0]`` is ``v <= edges[0]`` and
    ``counts[-1]`` the overflow bucket.  A LatencySketch twin sees every
    observation and serves relative-error quantiles past the last edge."""

    __slots__ = ("edges", "counts", "total", "sum", "sketch")

    def __init__(self, edges: Optional[Sequence[float]] = None):
        self.edges: Tuple[float, ...] = tuple(edges or DEFAULT_EDGES)
        if list(self.edges) != sorted(self.edges):
            raise ValueError("histogram edges must be sorted")
        self.counts: List[int] = [0] * (len(self.edges) + 1)
        self.total = 0
        self.sum = 0.0
        self.sketch = LatencySketch()

    def observe(self, v: float) -> None:
        i = 0
        for edge in self.edges:
            if v <= edge:
                break
            i += 1
        self.counts[i] += 1
        self.total += 1
        self.sum += v
        self.sketch.add(v)

    def quantile(self, q: float) -> Optional[float]:
        return self.sketch.quantile(q)


class MetricsRegistry:
    """Name -> metric; get-or-create accessors, one-shot snapshot."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def __getstate__(self):
        """Picklable (sim checkpoints pickle the owning SimNetwork): the
        creation lock is process-local, recreated on load."""
        state = self.__dict__.copy()
        state.pop("_lock", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter())
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge())
        return g

    def histogram(self, name: str, edges: Optional[Sequence[float]] = None) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram(edges))
        return h

    def snapshot(self) -> dict:
        return {
            "counters": {k: c.value for k, c in sorted(self._counters.items())},
            "gauges": {k: {"value": g.value, "high_water": g.high_water}
                       for k, g in sorted(self._gauges.items())},
            "histograms": {k: {"edges": list(h.edges), "counts": list(h.counts), "total": h.total,
                               "sum": round(h.sum, 6), "p50": _round_q(h.quantile(0.5)),
                               "p99": _round_q(h.quantile(0.99)),
                               "sketch": h.sketch.to_dict()}
                           for k, h in sorted(self._histograms.items())},
        }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry (the sketch plane's lane counters)."""
    return _DEFAULT
