"""Profiler-window arithmetic: busy time, time by name, idle gaps.

Frozen copy of the arithmetic of the program's sim/trace_epoch.py: the
device is busy where any kernel or copy runs (the union of their
intervals), idle elsewhere in the traced window.  Times are microseconds
on the profiler's clock.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Iterable, List, NamedTuple, Sequence, Tuple


class Event(NamedTuple):
    name: str
    start: float  # us
    end: float  # us


def merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, disjoint cover of the intervals."""
    out: List[List[float]] = []
    for start, stop in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], stop)
        else:
            out.append([start, stop])
    return [(a, b) for a, b in out]


def busy_us(events: Sequence[Event]) -> float:
    return sum(b - a for a, b in merged((e.start, e.end) for e in events))


def by_name(events: Sequence[Event]) -> dict:
    """Total us per event name, largest first."""
    out = defaultdict(float)
    for e in events:
        out[e.name] += e.end - e.start
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def idle_gaps(device: Sequence[Event], host: Sequence[Event]) -> dict:
    """The device's idle gaps between its first and last event, in us,
    summed by what the host was doing: the outermost host operation that
    covers most of each gap ("host: outside any op" where none does).
    `host` holds the outermost host operations only."""
    spans = merged((e.start, e.end) for e in device)
    hosts = sorted(host, key=lambda e: e.start)
    starts = [e.start for e in hosts]
    out = defaultdict(float)
    for (_, gap_lo), (gap_hi, _) in zip(spans, spans[1:]):
        best, best_cover = "host: outside any op", 0.0
        i = max(bisect.bisect_right(starts, gap_lo) - 1, 0)
        while i < len(hosts) and hosts[i].start < gap_hi:
            e = hosts[i]
            cover = min(e.end, gap_hi) - max(e.start, gap_lo)
            if cover > best_cover:
                best, best_cover = e.name, cover
            i += 1
        out[best] += gap_hi - gap_lo
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
