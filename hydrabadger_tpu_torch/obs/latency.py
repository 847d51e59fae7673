"""Transaction latency, submit to committed: the port's copy of the parts
of hydrabadger_tpu/obs/latency.py that the queueing core and the sim use.

* `LatencySketch`: a DDSketch-style log-bucketed quantile sketch with
  relative-error-bounded quantiles in bounded memory, mergeable by adding
  buckets.
* `TxnLifecycle`: the per-node ledger.  The sans-io core calls
  `note_stage(txn_id, stage)` with no timestamp; the I/O boundary calls
  `submit(txn_id, t)` and `stamp(t)`, which resolves the buffered notes to
  its own moment.  A committed note closes the record into the sketches.
"""
from __future__ import annotations

import hashlib
import math
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

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
    two buckets collapse."""

    _ZERO_EPS = 1e-9

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

    def _trim(self) -> None:
        while len(self.buckets) > self.max_buckets:
            spill = self.buckets.pop(min(self.buckets))
            nxt = min(self.buckets)
            self.buckets[nxt] = self.buckets.get(nxt, 0) + spill

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
        self.buckets[idx] = self.buckets.get(idx, 0) + n
        self._trim()

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
        self._trim()

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
