"""Per-epoch state census: the runtime twin of the hbstate analyzer.

The port's copy of hydrabadger_tpu/obs/census.py.
`lint/state_lifecycle.py` statically verifies that every growing
container on a node-lifetime class carries a declared lifecycle
(`lint/registry.py:STATE_LIFECYCLE`): "per_epoch" and "per_era" state
must shrink back at its scope's end, "bounded" state is capped,
"process_lifetime" state is exempt with a stated reason.  This module
watches the same containers live, from the same table:
`StateCensus.sample` snapshots `len()` of every declared container
reachable from the given objects, exports `state_census_<Class>.<attr>`
gauges (current size and high-water), and `flatness_violations` backs the
soak's assertion that era- and epoch-scoped state is flat across era
boundaries.

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

_TABLE: Optional[Dict[str, Dict[str, Tuple[str, Optional[str]]]]] = None


def lifecycle_table() -> Dict[str, Dict[str, Tuple[str, Optional[str]]]]:
    """`{ClassName: {attr: (lifecycle, arg)}}` from the lint registry.

    Keyed by bare class name: at runtime we meet objects, not modules, and
    every scoped class name is unique across the package (the analyzer
    keeps the registry consistent with the code)."""
    global _TABLE
    if _TABLE is None:
        from ..lint import registry

        table: Dict[str, Dict[str, Tuple[str, Optional[str]]]] = {}
        for full, decl in registry.STATE_LIFECYCLE.items():
            cls_name, attr = full.split("::", 1)[1].split(".", 1)
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
