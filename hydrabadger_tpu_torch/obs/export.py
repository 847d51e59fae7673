"""Trace exporters: JSONL (one event per line) and Chrome trace events
(the ``traceEvents`` JSON array Perfetto and chrome://tracing load).

The port's copy of hydrabadger_tpu/obs/export.py: the writers (both CLIs'
--trace), the readers and the merge gate of the cluster aggregator
(obs/aggregate.py).

The mapping is deliberately mechanical: a recorder event's ``name``/``phase``/``t``/attrs become the Chrome
event's ``name``/``ph``/``ts`` (microseconds)/``args``.  Track layout:

  * ``pid`` — one process row per distinct ``node`` attribute (the
    node whose recorder emitted the event), named via
    ``process_name`` metadata events;
  * ``tid`` — one thread row per stage name (``rbc``, ``ba``,
    ``subset``, ``tdec``, ``epoch``…), so one committed epoch reads as
    stacked stage spans under its node;
  * spans export as *async nestable* events (``ph`` ``b``/``e``) with
    an ``id`` derived from (stage, epoch, instance) — concurrent
    same-name spans (the four RBC instances of one epoch, adjacent
    overlapping epochs) pair by id, which the synchronous ``B``/``E``
    stack discipline cannot express.

Unstamped events (still pending at export time) are skipped: a span
that never reached an I/O boundary never became externally visible.

Traces carry a **clock-domain header**: the stamping boundaries use
different clocks (the sim router stamps ``perf_counter``, the TCP handler
poll a — possibly skewed — wall clock), so a JSONL dump's first line is a
``trace_meta`` metadata record declaring the domain, and
:func:`require_uniform_domain` is the merge gate: combining feeds from
different domains without anchor alignment raises
:class:`ClockDomainMismatch` instead of silently interleaving timelines
with unrelated origins.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Tuple

from .recorder import DOMAIN_UNSPECIFIED, Event

# stable thread ordering for the known stages; unknown names follow
_STAGE_ORDER = ("epoch", "rbc", "ba", "subset", "tdec")

TRACE_META = "trace_meta"


class ClockDomainMismatch(ValueError):
    """Feeds from different clock domains offered for an unaligned merge:
    perf_counter origins are arbitrary per process, so the merge would be
    meaningless."""


def require_uniform_domain(domains: Iterable[Optional[str]]) -> str:
    """The merge gate: every feed must declare the SAME clock domain
    (unspecified counts as its own domain).  Returns the common domain;
    raises :class:`ClockDomainMismatch` otherwise.  Aggregators that can
    align feeds from committed-batch anchors (obs/aggregate.py) catch this
    and align instead, and say so in their report."""
    seen = {d or DOMAIN_UNSPECIFIED for d in domains}
    if len(seen) > 1:
        raise ClockDomainMismatch(
            "refusing to merge traces from mixed clock domains "
            f"{sorted(seen)} without anchor alignment"
        )
    return next(iter(seen)) if seen else DOMAIN_UNSPECIFIED


def write_jsonl(
    events: Iterable[Event], path: str, meta: Optional[dict] = None
) -> int:
    """One JSON object per line; returns the number written.  ``meta``
    (clock_domain, node, pid…) becomes a leading ``trace_meta``
    metadata line the readers surface separately from events."""
    n = 0
    with open(path, "w") as fh:
        if meta is not None:
            fh.write(
                json.dumps({"name": TRACE_META, "ph": "M", **meta}) + "\n"
            )
        for ev in events:
            if ev.t is None:
                continue
            fh.write(json.dumps(ev.as_dict(), default=repr) + "\n")
            n += 1
    return n


def read_jsonl(path: str) -> List[Event]:
    return read_feed(path)[1]


def read_feed(path: str) -> Tuple[dict, List[Event]]:
    """Read one JSONL trace: (meta, events).  Metadata records ("M" phase)
    fold into meta; events keep their order."""
    meta: dict = {}
    out: List[Event] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if d.get("ph") == "M":
                if d.get("name") == TRACE_META:
                    meta.update({k: v for k, v in d.items() if k not in ("name", "ph")})
                continue
            out.append(Event(name=d.pop("name"), phase=d.pop("ph"), t=d.pop("t"), attrs=d))
    return meta, out


def chrome_trace_events(events: Iterable[Event]) -> List[dict]:
    """Map recorder events onto Chrome trace-event dicts."""
    pids: Dict[str, int] = {}
    tids: Dict[str, int] = {}
    for stage in _STAGE_ORDER:
        tids[stage] = len(tids) + 1
    out: List[dict] = []

    def pid_for(node) -> int:
        key = str(node)
        if key not in pids:
            pids[key] = len(pids) + 1
            out.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": pids[key],
                    "args": {"name": f"node {key}"},
                }
            )
        return pids[key]

    for ev in events:
        if ev.t is None:
            continue
        attrs = dict(ev.attrs)
        node = attrs.pop("node", "proc")
        tid = tids.setdefault(ev.name, len(tids) + 1)
        rec = {
            "name": ev.name,
            "ph": ev.phase,
            "ts": round(ev.t * 1e6, 3),
            "pid": pid_for(node),
            "tid": tid,
            "args": {k: _jsonable(v) for k, v in attrs.items()},
        }
        if ev.phase == "i":
            rec["s"] = "t"  # instant scope: thread
        elif ev.phase in ("B", "E"):
            # async nestable events pair by (cat, id, pid), not by
            # stack order — required because same-name spans overlap
            rec["ph"] = "b" if ev.phase == "B" else "e"
            rec["cat"] = ev.name
            # era disambiguates: each era restarts its HB epoch counter
            rec["id"] = (
                f"{ev.name}:r{attrs.get('era', '-')}"
                f":e{attrs.get('epoch', '-')}"
                f":i{attrs.get('instance', '-')}"
            )
        out.append(rec)
    return out


def write_chrome_trace(
    events: Iterable[Event], path: str, meta: Optional[dict] = None
) -> int:
    """Perfetto-loadable dump; returns the non-metadata event count.
    ``meta`` rides the top-level ``metadata`` key (clock domain,
    alignment report) — Perfetto ignores unknown keys."""
    recs = chrome_trace_events(events)
    doc = {"traceEvents": recs, "displayTimeUnit": "ms"}
    if meta is not None:
        doc["metadata"] = meta
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return sum(1 for r in recs if r["ph"] != "M")


def _jsonable(v):
    if isinstance(v, (bytes, bytearray, memoryview)):
        return bytes(v).hex()[:16]
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return repr(v)


def read_chrome_trace(path: str) -> List[dict]:
    with open(path) as fh:
        doc = json.load(fh)
    return doc["traceEvents"] if isinstance(doc, dict) else doc
