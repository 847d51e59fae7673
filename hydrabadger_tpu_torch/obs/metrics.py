"""Process-local counters and gauges with high-water marks: the port's copy
of the parts of hydrabadger_tpu/obs/metrics.py that the sim, the futures,
the sketch plane and the DKG's planes use.  `snapshot()` returns one
JSON-able dict."""
from __future__ import annotations

import threading
from typing import Dict

# the futures' overlap gauges (crypto/futures.stamp_gauges)
DEVICE_OVERLAP_RATIO = "device_overlap_ratio"
DEVICE_IDLE_S = "device_idle_s"
DEVICE_OVERLAP_HAS_DEVICE = "device_overlap_has_device"

# the router's byte meter, mirrored by SimNetwork.run
BYTES_TX_TOTAL = "bytes_tx_total"
BYTES_RX_TOTAL = "bytes_rx_total"
BYTES_PER_EPOCH = "bytes_per_epoch"

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


class MetricsRegistry:
    """Name -> metric; get-or-create accessors, one-shot snapshot."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
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

    def snapshot(self) -> dict:
        return {
            "counters": {k: c.value for k, c in sorted(self._counters.items())},
            "gauges": {k: {"value": g.value, "high_water": g.high_water}
                       for k, g in sorted(self._gauges.items())},
        }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry (the sketch plane's lane counters)."""
    return _DEFAULT
