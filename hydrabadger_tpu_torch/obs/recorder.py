"""Sans-io span/event recorder: the port's copy of
hydrabadger_tpu/obs/recorder.py.

Protocol cores emit logical events (span begins and ends, instants)
tagged with what they know (epoch, instance, stage) and never a
timestamp.  Events wait in a pending buffer until the I/O boundary that
drove the core (the sim router's delivery loop) calls `stamp` with its own
clock.  `bind(**attrs)` returns a view that merges default attributes into
every emission.  Disabled tracing is `NULL_RECORDER`, whose methods do
nothing and whose `bind` returns itself.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional

PHASE_BEGIN = "B"
PHASE_END = "E"
PHASE_INSTANT = "i"

# a 4-node full-crypto epoch emits a few hundred events; the ring drops
# the oldest beyond this
DEFAULT_CAPACITY = 1 << 18

# the clock a recorder's stamping boundary reads: the TCP node's (possibly
# skewed) wall clock, the sim's perf_counter, or undeclared
DOMAIN_WALL = "wall"
DOMAIN_PERF = "perf_counter"
DOMAIN_UNSPECIFIED = "unspecified"


def domain_clock(domain: str) -> Callable[[], float]:
    """The reader for a declared clock domain (unknown -> wall)."""
    return time.perf_counter if domain == DOMAIN_PERF else time.time


@dataclass
class Event:
    """One structured trace event; `t` is None until the boundary stamps it."""

    name: str
    phase: str
    attrs: Dict = field(default_factory=dict)
    t: Optional[float] = None

    def as_dict(self) -> dict:
        return {"name": self.name, "ph": self.phase, "t": self.t, **self.attrs}


class Recorder:
    """Collects events; bounded by construction (ring buffer)."""

    enabled = True

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 clock: Optional[Callable[[], float]] = None,
                 clock_domain: str = DOMAIN_UNSPECIFIED):
        self.events: Deque[Event] = deque(maxlen=capacity)
        self._pending: List[Event] = []
        self._pending_cap = capacity
        self.clock_domain = clock_domain
        self.clock = clock or domain_clock(clock_domain)

    def __getstate__(self):
        """Picklable (sim checkpoints hold the owning SimNetwork's
        recorder): the clock may be a harness-bound method, so it is
        dropped and rebuilt from the declared domain on load."""
        state = self.__dict__.copy()
        state.pop("clock", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.clock = domain_clock(self.clock_domain)

    def emit(self, name: str, phase: str = PHASE_INSTANT, **attrs) -> None:
        if len(self._pending) >= self._pending_cap:
            del self._pending[: self._pending_cap // 2]
        self._pending.append(Event(name, phase, attrs))

    def begin(self, name: str, **attrs) -> None:
        self.emit(name, PHASE_BEGIN, **attrs)

    def end(self, name: str, **attrs) -> None:
        self.emit(name, PHASE_END, **attrs)

    def instant(self, name: str, **attrs) -> None:
        self.emit(name, PHASE_INSTANT, **attrs)

    def emit_stamped(self, name: str, t: Optional[float] = None,
                     phase: str = PHASE_INSTANT, **attrs) -> None:
        """Emit an already-timed event straight into the ring (a boundary
        that times its own effect, such as the router's wire events)."""
        self.events.append(Event(name, phase, attrs, self.clock() if t is None else t))

    def stamp(self, t: float) -> int:
        """Assign time `t` to every pending event and move them into the
        ring.  Returns how many were stamped."""
        if not self._pending:
            return 0
        pending, self._pending = self._pending, []
        for ev in pending:
            ev.t = t
        self.events.extend(pending)
        return len(pending)

    def bind(self, **attrs) -> "BoundRecorder":
        return BoundRecorder(self, attrs)

    def drain(self) -> List[Event]:
        """All stamped events, oldest first; clears the ring."""
        out = list(self.events)
        self.events.clear()
        return out


class BoundRecorder:
    """A view over a Recorder that merges default attrs into every
    emission.  Explicit attrs win over bound ones."""

    enabled = True

    __slots__ = ("_rec", "_attrs")

    def __init__(self, rec: Recorder, attrs: Dict):
        self._rec = rec
        self._attrs = attrs

    def emit(self, name: str, phase: str = PHASE_INSTANT, **attrs) -> None:
        self._rec.emit(name, phase, **{**self._attrs, **attrs})

    def begin(self, name: str, **attrs) -> None:
        self.emit(name, PHASE_BEGIN, **attrs)

    def end(self, name: str, **attrs) -> None:
        self.emit(name, PHASE_END, **attrs)

    def instant(self, name: str, **attrs) -> None:
        self.emit(name, PHASE_INSTANT, **attrs)

    def emit_stamped(self, name: str, t: Optional[float] = None,
                     phase: str = PHASE_INSTANT, **attrs) -> None:
        self._rec.emit_stamped(name, t, phase, **{**self._attrs, **attrs})

    def bind(self, **attrs) -> "BoundRecorder":
        return BoundRecorder(self._rec, {**self._attrs, **attrs})

    def stamp(self, t: float) -> int:
        return self._rec.stamp(t)


class NullRecorder:
    """Tracing disabled: every method does nothing, `bind` returns self."""

    enabled = False
    clock_domain = DOMAIN_UNSPECIFIED

    def emit(self, name: str, phase: str = PHASE_INSTANT, **attrs) -> None:
        pass

    def emit_stamped(self, name: str, t: Optional[float] = None,
                     phase: str = PHASE_INSTANT, **attrs) -> None:
        pass

    def begin(self, name: str, **attrs) -> None:
        pass

    def end(self, name: str, **attrs) -> None:
        pass

    def instant(self, name: str, **attrs) -> None:
        pass

    def stamp(self, t: float) -> int:
        return 0

    def bind(self, **attrs) -> "NullRecorder":
        return self

    def drain(self) -> list:
        return []


NULL_RECORDER = NullRecorder()


def resolve(recorder) -> object:
    """None -> the null singleton; anything else passes through."""
    return NULL_RECORDER if recorder is None else recorder
