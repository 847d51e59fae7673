"""Declarative fault injection for the sim router: the port's copy of
hydrabadger_tpu/sim/scenario.py, the injection half of the adversarial
scenario plane.

  * :class:`ScenarioSpec` — one declarative object describing per-link
    policies (drop / duplicate / delay-reorder), partition + heal
    windows, and which nodes run which :mod:`sim.byzantine` attack
    strategies;
  * :class:`ScenarioAdversary` — the router-compatible adversary
    compiled from a spec.  Every injected fault is counted into an
    :class:`InjectionLog` and mirrored as ``byz_injected_*`` metrics;
  * the **fault-observability contract** — :data:`FAULT_OBSERVABLES`
    maps every injectable fault kind (consensus/types.py BYZ_* taxonomy)
    to the observable that proves the system noticed or absorbed it: a
    ``fault_log`` substring, a ``byz_faults_*`` counter, or a declared
    queue high-water.  :func:`verify_observability` asserts the contract
    mechanically, so a fault the system tolerates *silently* is a test
    failure.

The router stays the single enqueue chokepoint (sim/router.py counts
adversary drops/injections/rewrites); this module only decides.  The
random draws are the JAX module's, in its order, so one seed gives one
schedule in both packages.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..consensus import types as T
from ..obs.metrics import BYZ_FAULTS_PREFIX, BYZ_INJECTED_PREFIX

# Fault kinds whose ``byz_faults_*`` counter is stamped by the INJECTION
# layer itself: an asynchronous system cannot distinguish a withheld
# share from a slow one, or a dropped frame from a late one, so the
# declared observable for these is the injection counter surfacing in
# the run's metrics/soak/bench rows.  Every other kind must be observed
# by the protocol side (a fault_log entry) — the verifier will NOT
# accept the injector's own word for those.
SELF_COUNTING_KINDS = frozenset(
    {
        T.BYZ_WITHHELD_SHARE,
        T.BYZ_LINK_DROP,
        T.BYZ_LINK_DUP,
        T.BYZ_LINK_DELAY,
        T.BYZ_PARTITION,
        # a skewed clock is pure timing: an asynchronous protocol makes
        # NO timing assumptions, so there is nothing protocol-side to
        # detect — the declared observable is the injection counter
        # (the process tier)
        T.BYZ_CLOCK_SKEW,
    }
)


@dataclass(frozen=True)
class ObsSpec:
    """What proves a fault kind was noticed: ANY listed observable."""

    fault_any: Tuple[str, ...] = ()  # fault_log kind substrings
    counters: Tuple[str, ...] = ()  # metric counters that must be > 0
    gauges: Tuple[str, ...] = ()  # gauges whose high_water must be > 0


def _self_counter(kind: str) -> ObsSpec:
    return ObsSpec(counters=(BYZ_FAULTS_PREFIX + kind,))


# The observability contract.  Protocol-detectable kinds list the
# fault_log substrings the cores emit on detection (broadcast.py,
# threshold_decrypt.py, dynamic_honey_badger.py fault paths);
# injection-observable kinds declare their ``byz_faults_*`` counter.
FAULT_OBSERVABLES: Dict[str, ObsSpec] = {
    T.BYZ_EQUIVOCATION: ObsSpec(
        fault_any=(
            "broadcast: mixed echo roots",
            "broadcast: conflicting Echo",
            "broadcast: root mismatch",
        )
    ),
    T.BYZ_GARBAGE_SHARE: ObsSpec(
        fault_any=(
            "threshold_decrypt: invalid share",
            "threshold_decrypt: conflicting share",
        )
    ),
    T.BYZ_DKG_CORRUPT: ObsSpec(
        # "dhb keygen: <outcome fault>", "dhb: malformed keygen
        # message", "dhb: unknown keygen message", "dhb: keygen
        # message flood" all carry the token
        fault_any=("keygen",)
    ),
    T.BYZ_REPLAY_FLOOD: ObsSpec(
        # replayed cross-sender frames fail the per-sender proof/index
        # checks or collide with the sender's real messages; repeats of
        # an already-replayed frame are absorbed by the per-sender
        # duplicate LRU (network._handle) before reaching a core, so
        # the suppression counter is a declared observable too
        fault_any=(
            "broadcast: invalid",
            "broadcast: conflicting",
            "broadcast: Value from non-proposer",
            "threshold_decrypt: conflicting share",
            "malformed message",
        ),
        counters=("byz_dup_suppressed",),
    ),
    T.BYZ_KEYGEN_WITHHOLD: ObsSpec(
        # withheld DKG Parts/Acks stall the SHADOW era while the current
        # era keeps committing; the declared observable is the dhb stall
        # detector — the periodic fault and the harness-mirrored gauge
        # (obs.metrics.SHADOW_DKG_STALL_EPOCHS).  "shadow keygen
        # stalled" is strictly longer than BYZ_DKG_CORRUPT's "keygen"
        # token, so exclusive attribution separates the two families.
        fault_any=("shadow keygen stalled",),
        gauges=("shadow_dkg_stall_epochs",),
    ),
    T.BYZ_WITHHELD_SHARE: _self_counter(T.BYZ_WITHHELD_SHARE),
    T.BYZ_LINK_DROP: _self_counter(T.BYZ_LINK_DROP),
    T.BYZ_LINK_DUP: _self_counter(T.BYZ_LINK_DUP),
    T.BYZ_LINK_DELAY: _self_counter(T.BYZ_LINK_DELAY),
    T.BYZ_PARTITION: _self_counter(T.BYZ_PARTITION),
}


class InjectionLog:
    """What the scenario plane actually did, by taxonomy kind.

    The keyspace is the fixed BYZ_* taxonomy (never attacker data), so
    both the dict and the mirrored metric names stay bounded by
    construction even when injection volume is attacker-paced."""

    def __init__(self, metrics=None):
        self.counts: Dict[str, int] = {}
        self.metrics = metrics

    def note(self, kind: str, n: int = 1) -> None:
        if n <= 0:
            return
        self.counts[kind] = self.counts.get(kind, 0) + n
        if self.metrics is not None:
            self.metrics.counter(BYZ_INJECTED_PREFIX + kind).inc(n)
            if kind in SELF_COUNTING_KINDS:
                # injection IS the declared observable for these kinds
                self.metrics.counter(BYZ_FAULTS_PREFIX + kind).inc(n)


# -- the declarative spec ----------------------------------------------------


@dataclass(frozen=True)
class LinkPolicy:
    """Per-link fault rates.  ``delay`` holds a fraction of frames for
    1..``delay_max`` later deliveries (reordering, never loss — held
    frames release at quiescence); ``drop`` breaks the reliable-delivery
    assumption HBBFT's liveness rests on, so scenarios asserting
    liveness should prefer delay/duplicate."""

    drop: float = 0.0
    duplicate: float = 0.0
    delay: float = 0.0
    delay_max: int = 64


@dataclass(frozen=True)
class PartitionWindow:
    """Hold all traffic crossing group boundaries between the
    ``start``-th and ``heal``-th enqueue (router enqueue counter —
    the sim's only clock).  ``heal=None`` heals at quiescence.  Held
    frames are RELEASED at heal: a partition reorders, never loses."""

    groups: Tuple[Tuple[int, ...], ...]  # node INDEXES per side
    start: int = 0
    heal: Optional[int] = None


@dataclass(frozen=True)
class ScenarioSpec:
    """One declarative adversarial scenario.

    ``byzantine`` maps node INDEXES (into the sorted sim id list) to
    tuples of sim/byzantine.py strategy names; link policies address
    nodes the same way (``None`` matches any node)."""

    name: str = "scenario"
    seed: int = 0
    default_link: LinkPolicy = field(default_factory=LinkPolicy)
    # ((src_idx | None, dst_idx | None, LinkPolicy), ...) — first match wins
    links: Tuple[Tuple[Optional[int], Optional[int], LinkPolicy], ...] = ()
    partitions: Tuple[PartitionWindow, ...] = ()
    byzantine: Tuple[Tuple[int, Tuple[str, ...]], ...] = ()

    def byzantine_map(self) -> Dict[int, Tuple[str, ...]]:
        return {idx: tuple(names) for idx, names in self.byzantine}


def attack_spec(
    n_nodes: int,
    n_byzantine: Optional[int] = None,
    seed: int = 0,
    strategies: Tuple[str, ...] = (
        "equivocate",
        "withhold_shares",
        "garbage_shares",
        "replay_flood",
    ),
) -> ScenarioSpec:
    """The canonical liveness-under-attack scenario (bench config 11 /
    the Byzantine SOAK tier): the LAST ``f`` nodes run the full attack
    catalog against an otherwise clean network."""
    f = (n_nodes - 1) // 3 if n_byzantine is None else n_byzantine
    if not 0 <= f <= (n_nodes - 1) // 3:
        raise ValueError(f"need 0 <= f <= (n-1)//3, got f={f} n={n_nodes}")
    return ScenarioSpec(
        name=f"attack_{n_nodes}n_{f}f",
        seed=seed,
        byzantine=tuple(
            (n_nodes - 1 - i, tuple(strategies)) for i in range(f)
        ),
    )


# -- the compiled adversary --------------------------------------------------


class ScenarioAdversary:
    """Router adversary compiled from a :class:`ScenarioSpec`.

    Implements the sim/router.py contract: ``inject(sender, recipient,
    message)`` returns ``None`` (deliver unchanged) or a replacement
    list of triples; ``flush()`` releases everything held at quiescence
    so delays and partitions model reordering, never permanent loss."""

    # held-frame sanity ceiling: beyond this, deliver instead of hold
    # (a pathological schedule must degrade to reordering, not fill
    # host memory — the same stance as Router.MAX_QUEUE)
    HOLD_CAP = 200_000

    def __init__(self, spec: ScenarioSpec, ids, metrics=None):
        self.spec = spec
        self.ids = list(ids)
        self._index = {nid: i for i, nid in enumerate(self.ids)}
        self.rng = random.Random(spec.seed ^ 0x5CE7A210)
        self.log = InjectionLog(metrics)
        self.enqueued = 0
        # (countdown, sender, recipient, message) delay holds
        self._delayed: List[tuple] = []
        # frames held by an open partition window, keyed by window slot
        self._partitioned: List[List[tuple]] = [
            [] for _ in spec.partitions
        ]

    def _policy(self, s_idx: int, r_idx: int) -> LinkPolicy:
        for src, dst, pol in self.spec.links:
            if (src is None or src == s_idx) and (
                dst is None or dst == r_idx
            ):
                return pol
        return self.spec.default_link

    def _partition_slot(self, s_idx: int, r_idx: int) -> Optional[int]:
        """Index of the partition window currently severing this link."""
        for w, win in enumerate(self.spec.partitions):
            if self.enqueued < win.start:
                continue
            if win.heal is not None and self.enqueued >= win.heal:
                continue
            s_grp = r_grp = None
            for g, members in enumerate(win.groups):
                if s_idx in members:
                    s_grp = g
                if r_idx in members:
                    r_grp = g
            if s_grp is not None and r_grp is not None and s_grp != r_grp:
                return w
        return None

    def _release_due(self, out: List[tuple]) -> None:
        """Move expired delay holds and healed partition holds to out."""
        for i in range(len(self._delayed) - 1, -1, -1):
            cnt, s, r, m = self._delayed[i]
            if cnt <= 1:
                out.append((s, r, m))
                self._delayed.pop(i)
            else:
                self._delayed[i] = (cnt - 1, s, r, m)
        for w, win in enumerate(self.spec.partitions):
            if win.heal is not None and self.enqueued >= win.heal:
                held = self._partitioned[w]
                if held:
                    out.extend(held)
                    self._partitioned[w] = []

    def inject(self, sender, recipient, message):
        """The router's per-enqueue hook (lint: attacker-taint source —
        ``message`` is adversary-relayed protocol data)."""
        self.enqueued += 1
        out: List[tuple] = []
        self._release_due(out)
        s_idx = self._index.get(sender, -1)
        r_idx = self._index.get(recipient, -1)
        slot = self._partition_slot(s_idx, r_idx)
        if slot is not None and len(self._partitioned[slot]) < self.HOLD_CAP:
            self._partitioned[slot].append((sender, recipient, message))
            self.log.note(T.BYZ_PARTITION)
            return out
        pol = self._policy(s_idx, r_idx)
        if pol.drop and self.rng.random() < pol.drop:
            self.log.note(T.BYZ_LINK_DROP)
            return out
        if (
            pol.delay
            and len(self._delayed) < self.HOLD_CAP
            and self.rng.random() < pol.delay
        ):
            self._delayed.append(
                (
                    self.rng.randint(1, max(1, pol.delay_max)),
                    sender,
                    recipient,
                    message,
                )
            )
            self.log.note(T.BYZ_LINK_DELAY)
            return out
        out.append((sender, recipient, message))
        if pol.duplicate and self.rng.random() < pol.duplicate:
            out.append((sender, recipient, message))
            self.log.note(T.BYZ_LINK_DUP)
        if len(out) == 1 and out[0][2] is message:
            # nothing released, nothing changed: let the router take
            # the fast path (and not count a rewrite)
            return None
        return out

    __call__ = inject

    def flush(self) -> List[tuple]:
        """Quiescence release: delays expire, open partitions heal —
        the router calls this so no schedule models permanent loss."""
        released = [(s, r, m) for _c, s, r, m in self._delayed]
        self._delayed = []
        for w in range(len(self._partitioned)):
            released.extend(self._partitioned[w])
            self._partitioned[w] = []
        return released


# -- the observability verifier ----------------------------------------------


def _attribute(fault_kind: str, injected, registry=None) -> Optional[str]:
    """Attribute ONE fault_log entry to at most ONE taxonomy kind.

    The substring families overlap (a replayed frame and an equivocating
    sender both produce ``broadcast: conflicting`` entries), so a naive
    any-match would count one fault into several ``byz_faults_*`` kinds
    and let a fault caused by attack A satisfy attack B's observability
    requirement.  Exclusive attribution picks the best single candidate:
    prefer a kind the scenario actually injected, then the most specific
    (longest) matching substring, with sorted-kind order as the final
    deterministic tie-break."""
    registry = FAULT_OBSERVABLES if registry is None else registry
    best = None
    for kind in sorted(registry):
        for sub in registry[kind].fault_any:
            if sub in fault_kind:
                rank = (kind in injected, len(sub))
                if best is None or rank > best[0]:
                    best = (rank, kind)
    return None if best is None else best[1]


def attribute_faults(faults, injected=frozenset(), registry=None) -> Dict[str, int]:
    """Exclusive per-kind counts of the run's fault_log entries (each
    entry counted once — ``sum(values)`` never exceeds ``len(faults)``).
    ``registry`` selects the observability registry (default: the sim
    tier's FAULT_OBSERVABLES; the wire tier passes its own)."""
    counts: Dict[str, int] = {}
    for _nid, f in faults:
        kind = _attribute(f.kind, injected, registry)
        if kind is not None:
            counts[kind] = counts.get(kind, 0) + 1
    return counts


def fold_fault_counters(faults, metrics, injected=frozenset(), registry=None) -> None:
    """Classify the run's fault_log entries by taxonomy kind and fold
    them into ``byz_faults_*`` counters — the mechanical bridge from
    free-form core fault strings to the bounded counter family the
    soak/bench rows surface.  Pass the injected kinds so ambiguous
    entries resolve toward attacks that actually ran."""
    for kind, n in attribute_faults(faults, injected, registry).items():
        metrics.counter(BYZ_FAULTS_PREFIX + kind).inc(n)


def verify_observability(log: InjectionLog, faults, metrics, registry=None) -> List[str]:
    """The fault-observability contract, checked mechanically.

    For every fault kind the scenario injected, at least one registered
    observable must have materialized: a matching fault_log entry, a
    nonzero ``byz_faults_*``/declared counter, or a declared queue
    gauge's high-water.  Returns human-readable violations (empty =
    contract holds); an injected kind with NO registry entry is itself
    a violation — new attacks cannot ship without an observability
    story.  The same verifier serves both tiers: the sim passes the
    default FAULT_OBSERVABLES, the wire tier (net/chaos.py) its
    WIRE_FAULT_OBSERVABLES."""
    registry = FAULT_OBSERVABLES if registry is None else registry
    violations: List[str] = []
    # exclusive attribution: a fault entry satisfies ONE kind, so a
    # replay-induced "conflicting share" cannot stand in for garbage
    # shares that sailed through verification undetected
    attributed = attribute_faults(faults, injected=set(log.counts), registry=registry)
    for kind, injected in sorted(log.counts.items()):
        if injected <= 0:
            continue
        spec = registry.get(kind)
        if spec is None:
            violations.append(
                f"injected fault kind {kind!r} has no FAULT_OBSERVABLES "
                "entry — declare how it must surface"
            )
            continue
        if attributed.get(kind, 0) > 0:
            continue
        if any(metrics.counter(name).value > 0 for name in spec.counters):
            continue
        if any(metrics.gauge(name).high_water > 0 for name in spec.gauges):
            continue
        wanted = (
            list(spec.fault_any) + list(spec.counters) + list(spec.gauges)
        )
        violations.append(
            f"fault kind {kind!r} injected {injected}x but NO observable "
            f"materialized (wanted any of: {wanted}) — the system "
            "tolerated it silently"
        )
    return violations


def assert_observability(log: InjectionLog, faults, metrics, registry=None) -> None:
    violations = verify_observability(log, faults, metrics, registry)
    if violations:
        raise AssertionError(
            "scenario observability contract violated:\n  "
            + "\n  ".join(violations)
        )
