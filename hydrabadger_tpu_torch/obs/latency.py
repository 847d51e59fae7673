"""Transaction latency, submit to committed: the port's copy of
hydrabadger_tpu/obs/latency.py.

* `LatencySketch`: a DDSketch-style log-bucketed quantile sketch with
  relative-error-bounded quantiles in bounded memory, mergeable by adding
  buckets; `scale()` shifts the distribution by a clock-rate factor (drift
  alignment before a cross-node merge, `merge_sketch_dicts`).
* `TxnLifecycle`: the per-node ledger.  The sans-io core calls
  `note_stage(txn_id, stage)` with no timestamp; the I/O boundary calls
  `submit(txn_id, t)` and `stamp(t)`, which resolves the buffered notes to
  its own moment.  A committed note closes the record into the sketches.
* `SloSpec` / `SloTracker`: a target percentile, a threshold and a burn-rate
  window, evaluated continuously; the caller pushes a violation into its
  fault ring.
"""
from __future__ import annotations

import hashlib
import math
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

DEFAULT_REL_ERR = 0.01
DEFAULT_MAX_BUCKETS = 2048

STAGE_SUBMIT = "submit"
STAGE_ADMITTED = "admitted"
STAGE_PROPOSED = "proposed"
STAGE_COMMITTED = "committed"

# (span name, start stage, end stage)
SPANS: Tuple[Tuple[str, str, str], ...] = (
    ("e2e", STAGE_SUBMIT, STAGE_COMMITTED),
    ("admission", STAGE_SUBMIT, STAGE_ADMITTED),
    ("propose_wait", STAGE_ADMITTED, STAGE_PROPOSED),
    ("consensus", STAGE_PROPOSED, STAGE_COMMITTED),
)

PERCENTILES: Tuple[Tuple[str, float], ...] = (
    ("p50", 0.50), ("p90", 0.90), ("p99", 0.99), ("p999", 0.999),
)


def txn_id(txn: bytes) -> str:
    """Compact identity tag of a transaction: 8-byte blake2b, hex."""
    return hashlib.blake2b(bytes(txn), digest_size=8).hexdigest()


class LatencySketch:
    """Relative-error quantile sketch: `index = ceil(log_gamma(v))` with
    `gamma = (1 + rel_err) / (1 - rel_err)`; over `max_buckets` the lowest
    two buckets collapse.  The lowest index is cached (`_lo`, None when
    unknown), so a full sketch absorbs a value below its lowest bucket in
    O(1): the collapse would fold that value's new bucket straight into the
    lowest one."""

    _ZERO_EPS = 1e-9
    _lo: Optional[int] = None

    def __init__(self, rel_err: float = DEFAULT_REL_ERR,
                 max_buckets: int = DEFAULT_MAX_BUCKETS):
        if not 0.0 < rel_err < 1.0:
            raise ValueError("rel_err must be in (0, 1)")
        self.rel_err = float(rel_err)
        self.gamma = (1.0 + self.rel_err) / (1.0 - self.rel_err)
        self._log_gamma = math.log(self.gamma)
        self.max_buckets = int(max_buckets)
        self.buckets: Dict[int, int] = {}
        self.zero_count = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def _lowest(self) -> int:
        if self._lo is None:
            self._lo = min(self.buckets)
        return self._lo

    def add(self, v: float, n: int = 1) -> None:
        v = float(v)
        self.count += n
        self.sum += v * n
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if v <= self._ZERO_EPS:
            self.zero_count += n
            return
        idx = math.ceil(math.log(v) / self._log_gamma)
        b = self.buckets
        if idx in b:
            b[idx] += n
            return
        if len(b) >= self.max_buckets and idx < self._lowest():
            b[self._lo] += n  # what the collapse of its new bucket would do
            return
        if self._lo is not None and idx < self._lo:
            self._lo = idx
        self.buckets[idx] = n
        while len(self.buckets) > self.max_buckets:
            spill = self.buckets.pop(self._lowest())
            self._lo = nxt = min(self.buckets)
            self.buckets[nxt] += spill

    def merge(self, other: "LatencySketch") -> None:
        if abs(other.gamma - self.gamma) > 1e-12:
            raise ValueError("cannot merge sketches with different rel_err")
        self.zero_count += other.zero_count
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        for idx, c in other.buckets.items():
            self.buckets[idx] = self.buckets.get(idx, 0) + c
        self._lo = None
        while len(self.buckets) > self.max_buckets:
            spill = self.buckets.pop(self._lowest())
            self._lo = nxt = min(self.buckets)
            self.buckets[nxt] += spill

    def scale(self, factor: float) -> "LatencySketch":
        """Multiply the whole distribution by `factor`: a duration read on a
        clock running at rate r is r times the true one, and `scale(1/r)`
        restores it.  Log buckets make this an index shift (quantized to one
        bucket, within `rel_err`)."""
        if factor <= 0.0:
            raise ValueError("scale factor must be positive")
        if factor != 1.0 and self.buckets:
            shift = int(round(math.log(factor) / self._log_gamma))
            self.buckets = {idx + shift: c for idx, c in self.buckets.items()}
            self._lo = None
        if factor != 1.0:
            self.sum *= factor
            if self.count:
                self.min = self.min * factor
                self.max = self.max * factor
        return self

    def quantile(self, q: float) -> Optional[float]:
        """The q-quantile's estimate (the bucket's geometric midpoint,
        clamped to [min, max]); None when empty."""
        if self.count == 0:
            return None
        rank = q * (self.count - 1)
        if rank < self.zero_count:
            return 0.0
        seen = float(self.zero_count)
        for idx in sorted(self.buckets):
            seen += self.buckets[idx]
            if seen > rank:
                v = 2.0 * self.gamma ** idx / (self.gamma + 1.0)
                return min(max(v, self.min), self.max)
        return self.max if self.max > -math.inf else None

    def percentiles(self) -> Dict[str, Optional[float]]:
        return {name: self.quantile(q) for name, q in PERCENTILES}

    def to_dict(self) -> dict:
        """JSON-able form for summary feeds."""
        return {
            "rel_err": self.rel_err,
            "zero": self.zero_count,
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "buckets": {str(idx): c for idx, c in sorted(self.buckets.items())},
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "LatencySketch":
        sketch = cls(rel_err=float(d.get("rel_err", DEFAULT_REL_ERR)))
        sketch.zero_count = int(d.get("zero", 0))
        sketch.count = int(d.get("count", 0))
        sketch.sum = float(d.get("sum", 0.0))
        mn, mx = d.get("min"), d.get("max")
        sketch.min = math.inf if mn is None else float(mn)
        sketch.max = -math.inf if mx is None else float(mx)
        sketch.buckets = {int(idx): int(c) for idx, c in (d.get("buckets") or {}).items()}
        sketch._lo = None
        return sketch


def merge_sketch_dicts(feeds: Iterable[Mapping],
                       rates: Optional[Mapping[str, float]] = None) -> Dict[str, LatencySketch]:
    """Fold per-node `{span: sketch_dict}` feeds (each optionally tagged with
    its node id under "node") into one sketch per span, undoing each node's
    clock rate first: offsets cancel inside a duration, rates scale it."""
    merged: Dict[str, LatencySketch] = {}
    for feed in feeds:
        node = feed.get("node") if isinstance(feed, Mapping) else None
        rate = float((rates or {}).get(node, 1.0)) if node is not None else 1.0
        for span, payload in feed.items():
            if span == "node" or not isinstance(payload, Mapping):
                continue
            sketch = LatencySketch.from_dict(payload)
            if rate not in (0.0, 1.0):
                sketch.scale(1.0 / rate)
            if span in merged:
                merged[span].merge(sketch)
            else:
                merged[span] = sketch
    return merged


@dataclass(frozen=True)
class SloSpec:
    """"The `percentile` of submit-to-committed latency stays under
    `threshold_s`", judged over a sliding `window` of commits.  The error
    budget is 1 - percentile; a burn rate (the windowed over-threshold
    fraction over the budget) above 1 is a violation."""

    name: str = "txn_latency"
    percentile: float = 0.99
    threshold_s: float = 5.0
    window: int = 256
    min_samples: int = 16

    @property
    def budget(self) -> float:
        return max(1.0 - self.percentile, 1e-9)


class SloTracker:
    """Continuous SLO evaluation over a bounded commit window: `observe()`
    each committed e2e latency, `check()` at the caller's cadence; a
    non-None result is the violation message for the fault ring."""

    def __init__(self, spec: SloSpec):
        self.spec = spec
        self._window: deque = deque(maxlen=int(spec.window))
        self.violations = 0

    def observe(self, latency_s: float) -> None:
        self._window.append(1 if latency_s > self.spec.threshold_s else 0)

    def burn_rate(self) -> float:
        if not self._window:
            return 0.0
        return sum(self._window) / float(len(self._window)) / self.spec.budget

    def check(self) -> Optional[str]:
        if len(self._window) < self.spec.min_samples:
            return None
        rate = self.burn_rate()
        if rate <= 1.0:
            return None
        self.violations += 1
        return ("slo violation: %s p%g > %.3fs (burn rate %.1fx budget over last %d commits)"
                % (self.spec.name, self.spec.percentile * 100.0, self.spec.threshold_s, rate,
                   len(self._window)))


class TxnLifecycle:
    """Per-node transaction lifecycle ledger.  Everything that grows is
    bounded: `pending` is an LRU, the note buffer and the exact samples are
    admission-guarded."""

    def __init__(self, rel_err: float = DEFAULT_REL_ERR, max_pending: int = 1 << 14,
                 notes_cap: int = 1 << 16, samples_cap: int = 1 << 17):
        self.rel_err = float(rel_err)
        self.max_pending = int(max_pending)
        self.notes_cap = int(notes_cap)
        self.samples_cap = int(samples_cap)
        self.pending: "OrderedDict[str, Dict[str, float]]" = OrderedDict()
        self._notes: List[Tuple[str, str]] = []
        self.sketches: Dict[str, LatencySketch] = {
            name: LatencySketch(self.rel_err) for name, _, _ in SPANS
        }
        self.samples: List[float] = []
        self.submitted = 0
        self.resubmitted = 0
        self.committed_count = 0
        self.dropped_notes = 0
        self.evicted_pending = 0

    def submit(self, tid: str, t: float) -> bool:
        """Open a record at submission time `t`; False (a counted
        resubmission, the original's stamp kept) when `tid` is in flight."""
        if tid in self.pending:
            self.resubmitted += 1
            return False
        self.pending[tid] = {STAGE_SUBMIT: float(t)}
        self.submitted += 1
        while len(self.pending) > self.max_pending:
            self.pending.popitem(last=False)
            self.evicted_pending += 1
        return True

    def stamp(self, t: float) -> int:
        """Resolve every buffered note to time `t`; returns how many
        matched an open record."""
        if not self._notes:
            return 0
        notes, self._notes = self._notes, []
        resolved = 0
        t = float(t)
        for tid, stage in notes:
            rec = self.pending.get(tid)
            if rec is None or stage in rec:
                continue  # foreign txn, or a duplicate stage note
            rec[stage] = t
            resolved += 1
            if stage == STAGE_COMMITTED:
                self._finish(tid, rec)
        return resolved

    def note_stage(self, tid: str, stage: str) -> None:
        if len(self._notes) < self.notes_cap:
            self._notes.append((tid, stage))
        else:
            self.dropped_notes += 1

    def sketch_feed(self) -> Dict[str, dict]:
        """``{span: sketch_dict}``: the JSON-able per-node feed."""
        return {name: sk.to_dict() for name, sk in self.sketches.items()}

    def _finish(self, tid: str, rec: Dict[str, float]) -> None:
        self.pending.pop(tid, None)
        self.committed_count += 1
        for name, start, end in SPANS:
            t0, t1 = rec.get(start), rec.get(end)
            if t0 is not None and t1 is not None:
                self.sketches[name].add(max(t1 - t0, 0.0))
        t0, t1 = rec.get(STAGE_SUBMIT), rec.get(STAGE_COMMITTED)
        if t0 is not None and t1 is not None and len(self.samples) < self.samples_cap:
            self.samples.append(max(t1 - t0, 0.0))

    def e2e_percentiles(self) -> Dict[str, Optional[float]]:
        return self.sketches["e2e"].percentiles()


def exact_quantile(samples: List[float], q: float) -> Optional[float]:
    """Exact nearest-rank quantile with the sketch's convention (rank =
    floor(q * (n - 1)), not interpolated), so a comparison with the sketch
    picks the same rank."""
    if not samples:
        return None
    s = sorted(samples)
    return s[int(math.floor(q * (len(s) - 1)))]
