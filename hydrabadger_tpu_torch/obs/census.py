"""Per-epoch state census: the size of every long-lived container, live.

The port's copy of hydrabadger_tpu/obs/census.py.  Every growing container
on a node-lifetime class carries a declared lifecycle (`STATE_LIFECYCLE`
below): "per_epoch" and "per_era" state must shrink back at its scope's
end, "bounded" state is capped, "process_lifetime" state is exempt with a
stated reason.  `StateCensus.sample` snapshots `len()` of every declared
container reachable from the given objects, exports
`state_census_<Class>.<attr>` gauges (current size and high-water), and
`flatness_violations` backs the soak's assertion that era- and
epoch-scoped state is flat across era boundaries.

The JAX package builds its table from its lint registry; the port carries
its own, the same "Class.attr" -> (lifecycle, arg) declarations, keyed by
the bare class name (the port's classes carry the JAX package's names).

The census is cheap (a few hundred `len()` calls per epoch) and itself
bounded: history rides a capped deque.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

from .metrics import STATE_CENSUS_PREFIX, MetricsRegistry, default_registry

GAUGE_PREFIX = STATE_CENSUS_PREFIX

# census history depth (epochs); enough for any soak window
HISTORY_CAP = 4096

# "Class.attr" -> (lifecycle, arg).  Lifecycles: "per_epoch" / "per_era"
# (arg None), "bounded" (arg = the cap, documentary), "process_lifetime"
# (arg = the justification).
STATE_LIFECYCLE: Dict[str, Tuple[str, Optional[str]]] = {
    # -- DynamicHoneyBadger ------------------------------------------
    "DynamicHoneyBadger.future_msgs": ("bounded", "10_000 literal len() guard in handle_message"),
    "DynamicHoneyBadger.batches": (
        "process_lifetime",
        "app-facing batch ledger; consumers (sim soak trims, chain "
        "builders) own retention"),
    "DynamicHoneyBadger.votes": ("per_era", None),
    "DynamicHoneyBadger.pub_keys": ("per_era", None),
    "DynamicHoneyBadger.pending_kg": ("per_era", None),
    "DynamicHoneyBadger._deferred_faults": ("per_epoch", None),
    # -- HoneyBadger -------------------------------------------------
    "HoneyBadger.has_input": ("per_epoch", None),
    "HoneyBadger.epochs": ("per_epoch", None),
    "HoneyBadger.deferred": ("per_epoch", None),
    # -- QueueingHoneyBadger -----------------------------------------
    "QueueingHoneyBadger.queue": ("per_epoch", None),
    "QueueingHoneyBadger.batches": (
        "process_lifetime",
        "app-facing batch ledger; tests and callers read full history"),
    # -- SyncKeyGen --------------------------------------------------
    "SyncKeyGen._chan_keys": (
        "process_lifetime",
        "pairwise-channel key memo, <= one entry per roster member; the "
        "SyncKeyGen object itself is era-scoped (replaced on era flip)"),
    "SyncKeyGen.parts": (
        "process_lifetime",
        "one _ProposalState per validator proposal, <= n entries; the "
        "SyncKeyGen object itself is era-scoped (replaced on era flip)"),
    # -- Hydrabadger -------------------------------------------------
    "Hydrabadger.epoch_listeners": (
        "process_lifetime",
        "public subscription API; one entry per register_epoch_listener "
        "caller, caller-paced"),
    "Hydrabadger._tasks": (
        "process_lifetime",
        "one handle per long-lived service task; cancelled in stop()"),
    "Hydrabadger.fault_log": ("bounded", "FAULT_RING_CAP deque(maxlen=) ring"),
    "Hydrabadger._dialing": (
        "process_lifetime",
        "in-flight outgoing dial set, discarded on completion; <= one entry "
        "per known peer"),
    "Hydrabadger._internal": ("bounded", "Queue(maxsize=) construction bound"),
    "Hydrabadger._overflow_tasks": ("bounded", "1024 len() guard + done-callback discard"),
    "Hydrabadger._pending_user": ("bounded", "deque(maxlen=4096)"),
    "Hydrabadger._transcript_served": (
        "process_lifetime",
        "per-peer transcript rate-limit stamps; <= one entry per peer uid"),
    "Hydrabadger._ff_claims": (
        "process_lifetime",
        "fast-forward frontier claims; <= one entry per peer uid"),
    "Hydrabadger.keygen_outbox": (
        "bounded",
        "KEYGEN_OUTBOX_CAP len() guard; also reset each batch"),
    "Hydrabadger.keygen_inbox": ("bounded", "KEYGEN_INBOX_CAP len() guard"),
    "Hydrabadger._keygen_inbox_seen": (
        "process_lifetime",
        "dedup mirror of keygen_inbox: grows in lockstep under the same "
        "KEYGEN_INBOX_CAP branch (cap on the sibling container, invisible "
        "to the guard recognizer); reset when bootstrap keygen restarts"),
    "Hydrabadger.user_key_gens": ("bounded", "MAX_USER_KEYGENS len() guard"),
    "Hydrabadger.iom_queue": ("bounded", "IOM_QUEUE_CAP len() guard; drain-swapped each pump"),
    "Hydrabadger._epoch_outbox": ("bounded", "deque(maxlen=EPOCH_OUTBOX_MAX)"),
    "Hydrabadger.batches": ("process_lifetime", "app-facing batch ledger; consumers own retention"),
    "Hydrabadger.batch_queue": (
        "process_lifetime",
        "public batch delivery queue, consumer-paced by design (same "
        "verdict as the hbtaint suppression on this attr)"),
    "Hydrabadger._wire_retry": ("bounded", "WIRE_RETRY_MAX_QUEUE popleft trim"),
    "Hydrabadger._retry_attempts": (
        "bounded",
        "WIRE_RETRY_MAX_QUEUE popitem(last=False) trim loop"),
    # -- SimNetwork --------------------------------------------------
    "SimNetwork._dup_seen": (
        "process_lifetime",
        "per-(sender,kind) dup-suppression LRU rings trimmed in place "
        "through a local alias (per = ...; per.popitem), a shape the len() "
        "guard recognizer cannot see; cap is DUP_LRU_CAP per ring"),
    "SimNetwork._steady_durations": ("bounded", "4096 len() guard"),
    "SimNetwork.epoch_durations": (
        "process_lifetime",
        "one float per simulated epoch; the percentile source for era-gap "
        "bounds and bench attribution"),
    "SimNetwork._slo_cursor": (
        "process_lifetime",
        "one consumed-samples cursor per node id; keys mirror "
        "self.lifecycles (fixed topology), values are ints"),
    # -- LatencySketch -----------------------------------------------
    "LatencySketch.buckets": (
        "bounded",
        "max_buckets collapse-lowest trim loop in add() AND merge()"),
    # -- TxnLifecycle ------------------------------------------------
    "TxnLifecycle.pending": ("bounded", "max_pending popitem(last=False) LRU trim in submit()"),
    "TxnLifecycle._notes": (
        "bounded",
        "notes_cap len() admission guard; drain-swapped each stamp()"),
    "TxnLifecycle.samples": ("bounded", "samples_cap len() admission guard"),
    "TxnLifecycle.sketches": (
        "process_lifetime",
        "fixed keyset: one LatencySketch per SPANS entry, built whole in "
        "__init__; _finish feeds values (each bucket-bounded above), never "
        "inserts keys"),
    # -- SloTracker --------------------------------------------------
    "SloTracker._window": ("bounded", "deque(maxlen=spec.window) construction"),
    # -- Router ------------------------------------------------------
    "Router._size_cache": ("bounded", "SIZE_CACHE_CAP popitem trim"),
    "Router.outputs": (
        "process_lifetime",
        "test-facing per-sender output ledger; tests assert on full history"),
    "Router.faults": ("process_lifetime", "test-facing fault ledger; tests assert on full history"),
    "Router.bytes_rx_by_kind": ("bounded", "RX_KIND_CAP len() guard"),
}

_TABLE: Optional[Dict[str, Dict[str, Tuple[str, Optional[str]]]]] = None


def lifecycle_table() -> Dict[str, Dict[str, Tuple[str, Optional[str]]]]:
    """`{ClassName: {attr: (lifecycle, arg)}}` from STATE_LIFECYCLE.

    Keyed by bare class name: at runtime we meet objects, not modules, and
    every scoped class name is unique across the package."""
    global _TABLE
    if _TABLE is None:
        table: Dict[str, Dict[str, Tuple[str, Optional[str]]]] = {}
        for cls_attr, decl in STATE_LIFECYCLE.items():
            cls_name, attr = cls_attr.split(".", 1)
            table.setdefault(cls_name, {})[attr] = decl
        _TABLE = table
    return _TABLE


def lifecycle_of(key: str) -> Optional[str]:
    """Lifecycle for a census key `"Class.attr"` (None if undeclared)."""
    cls_name, attr = key.split(".", 1)
    decl = lifecycle_table().get(cls_name, {}).get(attr)
    return decl[0] if decl is not None else None


def _size(value) -> Optional[int]:
    """Best-effort container size: `len()` or a queue's `qsize()`."""
    try:
        return len(value)
    except TypeError:
        qsize = getattr(value, "qsize", None)
        if qsize is not None:
            try:
                return int(qsize())
            except (TypeError, ValueError, RuntimeError):
                return None
        return None


def take(obj) -> Dict[str, int]:
    """Snapshot `{"Class.attr": size}` for one object; unknown classes
    return `{}`, so callers can feed any object mix."""
    attrs = lifecycle_table().get(type(obj).__name__)
    if not attrs:
        return {}
    out: Dict[str, int] = {}
    cls_name = type(obj).__name__
    for attr in attrs:
        n = _size(getattr(obj, attr, None))
        if n is not None:
            out[f"{cls_name}.{attr}"] = n
    return out


def node_objects(node) -> List[object]:
    """The census-relevant objects reachable from one consensus node: the
    node itself, its inner HoneyBadger, and the live SyncKeyGen."""
    objs: List[object] = [node]
    hb = getattr(node, "hb", None)
    if hb is not None:
        objs.append(hb)
    kg_state = getattr(node, "key_gen", None)
    kg = getattr(kg_state, "key_gen", None)
    if kg is not None:
        objs.append(kg)
    return objs


class StateCensus:
    """Accumulates per-epoch censuses over a set of objects.

    Each `sample` folds the per-object snapshots with `max` (the worst node
    is the one a leak shows up on first), emits `state_census_*` gauges
    into `metrics`, and appends the folded row to a capped history."""

    def __init__(self, metrics: Optional[MetricsRegistry] = None):
        self.metrics = metrics if metrics is not None else default_registry()
        # (label, {key: max size across sampled objects}) rows
        self.history: deque = deque(maxlen=HISTORY_CAP)

    def sample(self, objs: Iterable[object], label=None) -> Dict[str, int]:
        folded: Dict[str, int] = {}
        for obj in objs:
            for key, n in take(obj).items():
                if n > folded.get(key, -1):
                    folded[key] = n
        for key, n in folded.items():
            self.metrics.gauge(f"{GAUGE_PREFIX}{key}").track(n)
        self.history.append((label, folded))
        return folded

    def latest(self) -> Dict[str, int]:
        return dict(self.history[-1][1]) if self.history else {}


def flatness_violations(
    baseline: Dict[str, int],
    later: Dict[str, int],
    slack_abs: int = 16,
    slack_ratio: float = 1.5,
    lifecycles: Tuple[str, ...] = ("per_epoch", "per_era"),
) -> List[str]:
    """Scoped-state flatness between two census rows.

    A key declared `per_epoch`/`per_era` whose later size exceeds BOTH
    `baseline + slack_abs` and `baseline * slack_ratio` is growing where
    its lifecycle says it must not: returned as `"Class.attr: 12 -> 400"`.
    `bounded` keys may fill to their cap and `process_lifetime` keys are
    exempt, so neither is checked by default.  The two-sided slack keeps
    in-flight jitter (a queue sampled mid-burst) out of the verdict."""
    bad: List[str] = []
    for key, after in sorted(later.items()):
        if lifecycle_of(key) not in lifecycles:
            continue
        before = baseline.get(key, 0)
        if after > before + slack_abs and after > before * slack_ratio:
            bad.append(f"{key}: {before} -> {after}")
    return bad
