"""Cluster timeline aggregator: cross-node trace merge, skew-corrected
clock alignment, per-epoch critical-path attribution.

The port's copy of hydrabadger_tpu/obs/aggregate.py.  It merges the
per-node feeds (the sim's shared recorder, the TCP tier's ``--trace`` JSONL
dumps, flight-recorder black boxes from killed incarnations (obs/flight.py)
and batch logs) into ONE perfetto-loadable cluster timeline, and computes:

  * **clock alignment** — per-node linear fits (rate + offset) onto a
    reference node's clock, anchored on committed batches: epoch ``e``
    committed everywhere within one network round-trip, so shared
    (era, epoch) commit stamps are the cross-node synchronization
    points.  Injected skew and drift are CORRECTED from the data rather
    than trusted; traces from different clock domains (the sim's
    ``perf_counter`` vs a node's wall clock) are refused without
    anchors (:class:`~.export.ClockDomainMismatch`) and aligned loudly
    with them.
  * **per-epoch critical path** — the straggler node (last aligned
    commit) and its gating stage: the RBC/BA/subset/tdec/DKG-settle
    span that ended last on the straggler before its commit.
  * **message latency** — wire ``wire_tx``/``wire_rx`` events (stamped
    at the socket/router boundaries, paired by message id) give
    per-message network latency p50/p99 across the aligned timeline.

Feed reading is torn-tail tolerant: a kill can tear the final JSONL line
mid-write — unparseable lines are skipped AND counted, corrupt flight
dumps are rejected loudly with fallback to their previous generation
(CheckpointStore semantics).

CLI::

    python -m hydrabadger_tpu_torch.obs.aggregate WORKDIR \
        [--trace-out merged.json] [--report-out report.json] \
        [--require-flight] [--require-critical-path]

prints the text straggler report and writes the merged Chrome trace.
"""
from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import export as _export
from .export import ClockDomainMismatch, require_uniform_domain
from .recorder import DOMAIN_UNSPECIFIED, Event

# the gating-stage vocabulary: every stage span the consensus cores
# emit that can sit on an epoch's critical path
STAGES = ("rbc", "ba", "subset", "tdec", "dkg_settle")


# -- message-shape introspection ---------------------------------------------


def consensus_tags(message) -> dict:
    """Best-effort (era, epoch, instance, innermost kind) extraction
    from a nested consensus message tuple — the sim router and wire
    boundary tag their tx/rx events with these so per-stage cross-node
    ordering is reconstructable.  Unknown shapes yield what was
    walkable; never raises."""
    tags: dict = {}
    depth = 0
    try:
        while (
            isinstance(message, tuple)
            and len(message) >= 2
            and isinstance(message[0], str)
            and depth < 6
        ):
            depth += 1
            tag = message[0]
            if tag == "dhb" and len(message) >= 3:
                tags["era"] = int(message[1])
                message = message[2]
            elif tag == "hb" and len(message) >= 3:
                tags["epoch"] = int(message[1])
                message = message[2]
            elif tag == "cs" and len(message) == 2:
                # hb's subset envelope: ("cs", subset_msg)
                message = message[1]
            elif tag in ("cs", "td") and len(message) >= 3:
                # subset routing / hb's tdec envelope: (tag, idx, inner)
                tags["instance"] = int(message[1])
                message = message[2]
            else:
                tags["ckind"] = tag
                break
    except (TypeError, ValueError):
        pass
    return tags


def _nkey(v) -> str:
    """Canonical node key: the same normalization the JSONL exporter
    applies, so in-memory and file-loaded events group identically."""
    return str(_export._jsonable(v))


# -- tolerant feed reading ----------------------------------------------------


@dataclass
class Feed:
    """One per-node JSONL trace feed (meta + events + torn-line count)."""

    path: str
    meta: dict = field(default_factory=dict)
    events: List[Event] = field(default_factory=list)
    skipped_lines: int = 0


def read_jsonl_tolerant(path: str) -> Tuple[List[dict], int]:
    """Parse a JSONL feed line by line, skipping (and counting) torn or
    corrupt lines — a SIGKILL tears the final line mid-write, and the
    aggregator must read everything the dead process DID flush."""
    rows: List[dict] = []
    skipped = 0
    try:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except ValueError:
                    skipped += 1
                    continue
                if isinstance(row, dict):
                    rows.append(row)
                else:
                    skipped += 1
    except OSError:
        return [], 0
    return rows, skipped


def load_trace_feed(path: str) -> Feed:
    rows, skipped = read_jsonl_tolerant(path)
    feed = Feed(path=path, skipped_lines=skipped)
    for d in rows:
        if d.get("ph") == "M":
            if d.get("name") == _export.TRACE_META:
                feed.meta.update(
                    {k: v for k, v in d.items() if k not in ("name", "ph")}
                )
            continue
        d = dict(d)
        try:
            feed.events.append(
                Event(
                    name=d.pop("name"), phase=d.pop("ph"),
                    t=d.pop("t"), attrs=d,
                )
            )
        except KeyError:
            feed.skipped_lines += 1
    return feed


def events_from_dicts(rows: List[dict]) -> List[Event]:
    """Flight-dump payload events (as_dict shape) back into Events."""
    out: List[Event] = []
    for d in rows:
        d = dict(d)
        try:
            out.append(
                Event(
                    name=d.pop("name"), phase=d.pop("ph"),
                    t=d.pop("t"), attrs=d,
                )
            )
        except KeyError:
            continue
    return out


# -- clock alignment ----------------------------------------------------------


def commit_anchors(
    events: List[Event],
    batch_rows: Optional[Dict[str, List[dict]]] = None,
) -> Dict[str, Dict[tuple, float]]:
    """Per-node committed-batch anchor stamps.  Three anchor families,
    keyed with distinct prefixes so they can never cross-match between
    nodes: batch-log rows ("b", era, epoch — the process tier's
    append-per-commit feed, alive up to the instant of a SIGKILL),
    ``epoch_commit`` instants ("c") and ``epoch`` span ends ("e").
    Every family keys on values all nodes agree on byzantine-free, so a
    shared key IS a synchronization point."""
    anchors: Dict[str, Dict[tuple, float]] = {}

    def put(node: str, key: tuple, t) -> None:
        if t is None:
            return
        anchors.setdefault(node, {}).setdefault(key, float(t))

    for node, rows in (batch_rows or {}).items():
        for row in rows:
            if "epoch" in row and "t" in row:
                put(node, ("b", row.get("era", 0), row["epoch"]), row["t"])
    for ev in events:
        node = _nkey(ev.attrs.get("node", "?"))
        if ev.name == "epoch_commit" and ev.phase == "i":
            put(
                node,
                ("c", ev.attrs.get("era", 0), ev.attrs.get("epoch")),
                ev.t,
            )
        elif ev.name == "epoch" and ev.phase == "E":
            put(
                node,
                ("e", ev.attrs.get("era", 0), ev.attrs.get("epoch")),
                ev.t,
            )
    return anchors


def fit_alignment(
    anchors: Dict[str, Dict[tuple, float]],
) -> Tuple[Optional[str], Dict[str, dict]]:
    """Least-squares per-node linear map ``t_ref = rate * t + offset``
    over shared anchors against the best-covered reference node.  Two
    or more anchors recover offset AND drift rate (a skewed node has both);
    one anchor recovers offset only; zero leaves the node unaligned
    (identity, flagged in the report)."""
    if not anchors:
        return None, {}
    ref = max(sorted(anchors), key=lambda n: len(anchors[n]))
    fits: Dict[str, dict] = {}
    for node, a in anchors.items():
        shared = sorted(set(a) & set(anchors[ref]))
        xs = [a[k] for k in shared]
        ys = [anchors[ref][k] for k in shared]
        rate, offset = 1.0, 0.0
        if len(shared) >= 2 and max(xs) - min(xs) > 1e-9:
            n = len(xs)
            mx = sum(xs) / n
            my = sum(ys) / n
            vxx = sum((x - mx) ** 2 for x in xs)
            vxy = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
            rate = vxy / vxx
            offset = my - rate * mx
        elif len(shared) >= 1:
            offset = ys[0] - xs[0]
        # full precision, no rounding: at wall-clock magnitudes
        # (~1.7e9 s) even a 1e-9 rate rounding error shears the aligned
        # timeline by seconds — display rounding lives in report_text
        fits[node] = {
            "rate": rate,
            "offset_s": offset,
            "anchors": len(shared),
        }
    return ref, fits


def apply_alignment(
    events: List[Event], fits: Dict[str, dict]
) -> List[Event]:
    """Map every event onto the reference clock (copies; inputs stay
    untouched), then time-order the merged list."""
    out: List[Event] = []
    for ev in events:
        if ev.t is None:
            continue
        fit = fits.get(_nkey(ev.attrs.get("node", "?")))
        t = ev.t
        if fit is not None:
            t = fit["rate"] * t + fit["offset_s"]
        out.append(Event(ev.name, ev.phase, dict(ev.attrs), t))
    out.sort(key=lambda e: e.t)
    return out


# -- critical path ------------------------------------------------------------


def stage_spans(events: List[Event]) -> List[dict]:
    """Pair B/E stage events into spans keyed (node, stage, era, epoch,
    instance), FIFO per key — the async-nestable pairing the exporter
    uses, replayed for analysis."""
    open_spans: Dict[tuple, List[dict]] = {}
    spans: List[dict] = []
    for ev in events:
        if ev.name not in STAGES or ev.phase not in ("B", "E"):
            continue
        key = (
            _nkey(ev.attrs.get("node", "?")),
            ev.name,
            ev.attrs.get("era", 0),
            ev.attrs.get("epoch"),
            ev.attrs.get("instance"),
        )
        if ev.phase == "B":
            span = {
                "node": key[0], "name": ev.name, "era": key[2],
                "epoch": key[3], "instance": key[4],
                "t0": ev.t, "t1": None,
            }
            open_spans.setdefault(key, []).append(span)
            spans.append(span)
        else:
            pending = open_spans.get(key)
            if pending:
                pending.pop(0)["t1"] = ev.t
    return spans


def _decompose(
    spans: List[dict], t0: float, t1: float
) -> Dict[str, float]:
    """Partition the straggler's epoch window [t0, t1] across its leaf
    stage spans: each instant is attributed to the INNERMOST active
    stage (latest begin wins — a tdec running inside an epoch's tail
    owns that time, not the long-finished rbc), un-covered time is
    ``other``.  A partition by construction: the values sum to exactly
    t1 - t0, which is what lets the report assert the decomposition
    against the measured end-to-end instead of hand-waving it."""
    clipped = [
        (max(s["t0"], t0), min(s["t1"], t1), s["name"])
        for s in spans
        if s["t1"] is not None and s["name"] != "subset"
        and min(s["t1"], t1) > max(s["t0"], t0)
    ]
    out: Dict[str, float] = {"other": 0.0}
    cuts = sorted({t0, t1, *(a for a, _b, _n in clipped),
                   *(b for _a, b, _n in clipped)})
    for a, b in zip(cuts, cuts[1:]):
        if b <= t0 or a >= t1:
            continue
        active = [(sa, name) for sa, sb, name in clipped if sa <= a and sb >= b]
        name = max(active)[1] if active else "other"
        out[name] = out.get(name, 0.0) + (b - a)
    return {k: round(v, 6) for k, v in out.items()}


def critical_path(events: List[Event]) -> List[dict]:
    """Per committed epoch: the straggler node (last aligned ``epoch``
    span end) and the stage span that gated it — the last
    RBC/BA/subset/tdec/DKG-settle end on the straggler at or before its
    commit.  Epochs only one node committed (trace windows differ) are
    skipped for straggler purposes but still reported."""
    commits: Dict[tuple, Dict[str, float]] = {}
    begins: Dict[tuple, Dict[str, float]] = {}
    for ev in events:
        if ev.name == "epoch" and ev.phase in ("B", "E") and ev.t is not None:
            key = (ev.attrs.get("era", 0), ev.attrs.get("epoch"))
            if key[1] is None:
                continue
            node = _nkey(ev.attrs.get("node", "?"))
            table = commits if ev.phase == "E" else begins
            table.setdefault(key, {})[node] = ev.t
    by_owner: Dict[tuple, List[dict]] = {}
    for span in stage_spans(events):
        if span["t1"] is None:
            continue
        by_owner.setdefault(
            (span["era"], span["epoch"], span["node"]), []
        ).append(span)
    rows: List[dict] = []
    for key in sorted(commits, key=lambda k: (k[0], k[1])):
        nodes = commits[key]
        straggler = max(nodes, key=lambda n: (nodes[n], n))
        t_commit = nodes[straggler]
        cands = [
            s
            for s in by_owner.get((key[0], key[1], straggler), [])
            if s["t1"] <= t_commit + 1e-9
        ]
        # prefer the innermost gating stage: the subset span is a
        # container whose end is DETERMINED by its last inner
        # rbc/ba/tdec event, so when any leaf stage is attributable it
        # names the actual work; subset stands in only when the leaves
        # were outside the trace window
        leaves = [s for s in cands if s["name"] != "subset"]
        cands = leaves or cands
        gate = max(cands, key=lambda s: s["t1"]) if cands else None
        # stage decomposition: the straggler's epoch window, partitioned
        # across its leaf stage spans (epoch-B anchored; falls back to
        # the earliest stage begin when the B event fell outside the
        # trace window — then e2e under-counts honestly rather than
        # inventing an anchor)
        t_begin = begins.get(key, {}).get(straggler)
        if t_begin is None and cands:
            t_begin = min(s["t0"] for s in cands)
        stages = (
            _decompose(
                by_owner.get((key[0], key[1], straggler), []),
                t_begin, t_commit,
            )
            if t_begin is not None and t_begin < t_commit else {}
        )
        rows.append(
            {
                "era": key[0],
                "epoch": key[1],
                "straggler_node": straggler,
                "critical_stage": gate["name"] if gate else "unknown",
                "critical_instance": gate.get("instance") if gate else None,
                "commit_t": round(t_commit, 6),
                "commit_spread_s": round(
                    t_commit - min(nodes.values()), 6
                ),
                "nodes_committed": len(nodes),
                "e2e_s": (
                    round(t_commit - t_begin, 6)
                    if t_begin is not None else None
                ),
                "stages_s": stages,
            }
        )
    return rows


def _modal(values: List) -> Optional[str]:
    counts: Dict = {}
    for v in values:
        counts[v] = counts.get(v, 0) + 1
    if not counts:
        return None
    return max(sorted(counts, key=str), key=lambda v: counts[v])


# -- message latency ----------------------------------------------------------


def message_latency(events: List[Event]) -> dict:
    """Pair ``wire_tx``/``wire_rx`` events by (src, dst, kind, mid) on
    the aligned timeline.  ``mid`` is the frame digest at the TCP tier
    (exact under reordering/duplication) and the router sequence number
    in the sim; unmatched events (drops, pre-handshake frames, chaos
    corruption) simply contribute no sample."""
    tx: Dict[tuple, List[float]] = {}
    samples: List[float] = []
    n_tx = n_rx = 0
    for ev in sorted(events, key=lambda e: e.t or 0.0):
        mid = ev.attrs.get("mid")
        if mid is None:
            continue
        if ev.name == "wire_tx":
            n_tx += 1
            key = (
                _nkey(ev.attrs.get("node", "?")),
                _nkey(ev.attrs.get("dst", "?")),
                ev.attrs.get("kind"),
                str(mid),
            )
            tx.setdefault(key, []).append(ev.t)
        elif ev.name == "wire_rx":
            n_rx += 1
            key = (
                _nkey(ev.attrs.get("src", "?")),
                _nkey(ev.attrs.get("node", "?")),
                ev.attrs.get("kind"),
                str(mid),
            )
            pending = tx.get(key)
            if pending:
                samples.append(max(0.0, ev.t - pending.pop(0)))
    out = {
        "pairs": len(samples),
        "wire_tx_events": n_tx,
        "wire_rx_events": n_rx,
        "msg_latency_p50_s": None,
        "msg_latency_p99_s": None,
    }
    if samples:
        samples.sort()

        def pct(q: float) -> float:
            return samples[min(len(samples) - 1, int(q * len(samples)))]

        out["msg_latency_p50_s"] = round(pct(0.50), 6)
        out["msg_latency_p99_s"] = round(pct(0.99), 6)
    return out


# -- the aggregations ---------------------------------------------------------


def timeline_report(
    events: List[Event],
    align_fits: Optional[Dict[str, dict]] = None,
    reference: Optional[str] = None,
) -> dict:
    """Critical path + message latency over one (already merged,
    already aligned) event list — the report core shared by the
    directory aggregator and the in-process harnesses (the sim's
    timeline_report, the chaos cluster's row)."""
    epochs = critical_path(events)
    lat = message_latency(events)
    nodes = sorted({_nkey(e.attrs["node"]) for e in events if "node" in e.attrs})
    multi = [r for r in epochs if r["nodes_committed"] > 1]
    # per-stage attribution folded across epochs: where committed wall
    # time actually went.  Each epoch's partition sums to its e2e by
    # construction, so the totals sum to total attributed e2e too.
    stage_totals: Dict[str, float] = {}
    attributed_e2e = 0.0
    for r in epochs:
        if not r["stages_s"]:
            continue
        attributed_e2e += r["e2e_s"] or 0.0
        for name, v in r["stages_s"].items():
            stage_totals[name] = stage_totals.get(name, 0.0) + v
    return {
        "nodes": nodes,
        "events": len(events),
        "clock": {
            "reference": reference,
            "alignment": align_fits or {},
        },
        "epochs": epochs,
        # attributed = a gating stage was actually named; epochs whose
        # stage spans fell outside the trace window report "unknown"
        # and do not count
        "epochs_attributed": sum(
            1 for r in epochs if r["critical_stage"] != "unknown"
        ),
        "epoch_critical_stage": _modal(
            [r["critical_stage"] for r in epochs if r["critical_stage"] != "unknown"]
        ),
        "straggler_node": _modal([r["straggler_node"] for r in multi]),
        "commit_spread_max_s": round(
            max((r["commit_spread_s"] for r in multi), default=0.0), 6
        ),
        "stage_totals_s": {
            k: round(v, 6) for k, v in sorted(stage_totals.items())
        },
        "stage_e2e_s": round(attributed_e2e, 6),
        **lat,
    }


def aggregate_events(events: List[Event], align: bool = False) -> dict:
    """In-process entry point: one shared-clock event list (the sim's
    recorder, an in-process TCP harness).  ``align=True`` additionally
    anchor-aligns per-node clocks — a no-op when they already agree."""
    fits: Dict[str, dict] = {}
    ref = None
    if align:
        ref, fits = fit_alignment(commit_anchors(events))
        events = apply_alignment(events, fits)
    else:
        events = [e for e in events if e.t is not None]
        events = sorted(events, key=lambda e: e.t)
    return timeline_report(events, fits, ref)


def aggregate_dir(
    workdir: str, return_events: bool = False
):
    """The cluster aggregation: merge every per-node feed under
    ``workdir`` — ``*.trace.jsonl`` dumps, ``*.flight.*.json`` black
    boxes (torn dumps rejected loudly, previous generation served),
    ``*.batches.jsonl`` commit anchors — into one skew-corrected
    timeline + report.  Mixed clock domains WITHOUT anchors raise
    :class:`~.export.ClockDomainMismatch`; with anchors the mix is
    aligned and flagged in the report."""
    from .flight import load_flight_with_fallback

    feeds = [
        load_trace_feed(p)
        for p in sorted(glob.glob(os.path.join(workdir, "*.trace.jsonl")))
    ]
    events: List[Event] = []
    seen: set = set()
    domains: List[str] = []

    def fold(evs: List[Event], domain: str) -> int:
        """Dedup fold: a final incarnation's flight dump repeats the
        tail of its own trace dump — identical (node, name, t, attrs)
        events fold once."""
        added = 0
        for ev in evs:
            if ev.t is None:
                continue
            key = (
                ev.name, ev.phase, ev.t,
                json.dumps(ev.attrs, sort_keys=True, default=repr),
            )
            if key in seen:
                continue
            seen.add(key)
            events.append(ev)
            added += 1
        if added:
            domains.append(domain or DOMAIN_UNSPECIFIED)
        return added

    feed_info = []
    for feed in feeds:
        added = fold(
            feed.events, feed.meta.get("clock_domain", DOMAIN_UNSPECIFIED)
        )
        feed_info.append(
            {
                "path": os.path.basename(feed.path),
                "events": added,
                "skipped_lines": feed.skipped_lines,
                "clock_domain": feed.meta.get(
                    "clock_domain", DOMAIN_UNSPECIFIED
                ),
            }
        )

    # flight black boxes: <stem>.flight.<pid>.json (+ .1 fallback)
    flight_found: List[dict] = []
    flight_rejected: List[str] = []
    for path in sorted(glob.glob(os.path.join(workdir, "*.flight.*.json"))):
        payload, rejected = load_flight_with_fallback(path)
        flight_rejected.extend(os.path.basename(r) for r in rejected)
        if payload is None:
            continue
        added = fold(
            events_from_dicts(payload.get("events", [])),
            payload.get("clock_domain", DOMAIN_UNSPECIFIED),
        )
        flight_found.append(
            {
                "path": os.path.basename(path),
                "node": payload.get("node"),
                "pid": payload.get("pid"),
                "reason": payload.get("reason"),
                "events": added,
                "used_fallback": bool(rejected),
            }
        )

    # committed-batch anchors from the process tier's batch logs,
    # mapped file->node id through each slot's metrics feed / trace meta
    batch_rows: Dict[str, List[dict]] = {}
    torn_tail_lines = 0
    for path in sorted(glob.glob(os.path.join(workdir, "*.batches.jsonl"))):
        rows, skipped = read_jsonl_tolerant(path)
        torn_tail_lines += skipped
        stem = os.path.basename(path)[: -len(".batches.jsonl")]
        node = None
        for feed in feeds:
            if os.path.basename(feed.path).startswith(stem + "."):
                node = feed.meta.get("node")
                break
        if node is None:
            mrows, ms = read_jsonl_tolerant(
                os.path.join(workdir, stem + ".metrics.jsonl")
            )
            torn_tail_lines += ms
            node = mrows[0].get("node") if mrows else stem
        batch_rows.setdefault(_nkey(node), []).extend(rows)

    anchors = commit_anchors(events, batch_rows)
    ref, fits = fit_alignment(anchors)
    try:
        require_uniform_domain(domains)
        mixed = False
    except ClockDomainMismatch:
        # mixed domains are mergeable ONLY when every node actually
        # anchors onto the reference clock — otherwise an unanchored
        # feed would ride the merge on its arbitrary origin
        span_nodes = {
            _nkey(e.attrs["node"]) for e in events if "node" in e.attrs
        }
        if not span_nodes or any(
            fits.get(n, {}).get("anchors", 0) < 1 for n in span_nodes
        ):
            raise
        mixed = True  # aligned below — loud, never silent
    merged = apply_alignment(events, fits)
    report = timeline_report(merged, fits, ref)
    report["feeds"] = feed_info
    report["torn_tail_lines_skipped"] = torn_tail_lines + sum(
        f["skipped_lines"] for f in feed_info
    )
    report["mixed_domains_aligned"] = mixed
    report["flight"] = {
        "found": flight_found,
        "rejected": flight_rejected,
    }
    if return_events:
        return report, merged
    return report


# -- the text straggler report ------------------------------------------------


def report_text(report: dict) -> str:
    lines = [
        f"cluster timeline: {len(report['nodes'])} node(s), "
        f"{report['events']} events"
        + (
            f", reference clock {report['clock']['reference']}"
            if report["clock"].get("reference")
            else ""
        )
    ]
    fits = report["clock"].get("alignment") or {}
    if fits:
        lines.append("clock alignment (t_ref = rate * t + offset):")
        for node in sorted(fits):
            f = fits[node]
            lines.append(
                f"  {node}: offset {f['offset_s']:+.3f}s "
                f"rate {f['rate']:.6f} ({f['anchors']} anchors)"
            )
    fl = report.get("flight")
    if fl is not None:
        lines.append(
            f"flight dumps: {len(fl['found'])} loaded"
            + (
                f", {len(fl['rejected'])} rejected "
                "(torn/corrupt; fallback generation served where present)"
                if fl["rejected"]
                else ""
            )
        )
    lines.append("per-epoch critical path:")
    for row in report["epochs"]:
        lines.append(
            f"  era {row['era']} epoch {row['epoch']}: "
            f"straggler {row['straggler_node']}, gated by "
            f"{row['critical_stage']}"
            + (
                f"[{row['critical_instance']}]"
                if row["critical_instance"] is not None
                else ""
            )
            + f" (commit spread {row['commit_spread_s']:.4f}s, "
            f"{row['nodes_committed']} nodes)"
        )
    if report.get("msg_latency_p99_s") is not None:
        lines.append(
            f"msg latency p50/p99: {report['msg_latency_p50_s']:.6f}s / "
            f"{report['msg_latency_p99_s']:.6f}s "
            f"over {report['pairs']} matched pairs"
        )
    lines.append(
        "headline: "
        f"epoch_critical_stage={report['epoch_critical_stage']} "
        f"straggler_node={report['straggler_node']} "
        f"msg_latency_p99_s={report['msg_latency_p99_s']}"
    )
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m hydrabadger_tpu_torch.obs.aggregate",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("workdir", help="directory holding the per-node feeds")
    p.add_argument(
        "--trace-out", default=None, metavar="PATH",
        help="merged perfetto-loadable Chrome trace (default: "
        "WORKDIR/cluster_timeline.json)",
    )
    p.add_argument(
        "--report-out", default=None, metavar="PATH",
        help="write the JSON report alongside the text one",
    )
    p.add_argument(
        "--require-flight", action="store_true",
        help="exit nonzero unless at least one flight dump loaded "
        "(the chaos-gate assertion: every SIGKILL leaves a black box)",
    )
    p.add_argument(
        "--require-critical-path", action="store_true",
        help="exit nonzero unless at least one epoch's critical path "
        "was attributed",
    )
    args = p.parse_args(argv)
    report, merged = aggregate_dir(args.workdir, return_events=True)
    trace_out = args.trace_out or os.path.join(
        args.workdir, "cluster_timeline.json"
    )
    n = _export.write_chrome_trace(
        merged, trace_out, meta={"clock": report["clock"]}
    )
    print(report_text(report))
    print(f"merged trace: {n} events -> {trace_out}")
    if args.report_out:
        with open(args.report_out, "w") as fh:
            json.dump(report, fh, indent=1, default=repr)
    if args.require_flight and not report["flight"]["found"]:
        print("FAIL: no flight dump loaded (black-box contract)")
        return 1
    if args.require_critical_path and not any(
        r["critical_stage"] != "unknown" for r in report["epochs"]
    ):
        print("FAIL: no epoch's critical path attributed")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
