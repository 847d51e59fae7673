"""Crash-surviving flight recorder, the per-node black box: the port's
copy of hydrabadger_tpu/obs/flight.py.

A SIGKILL retracts everything a node only held in memory: its recorder
ring, its fault ring, the counters since the last summary line.  The
flight recorder keeps a bounded in-memory snapshot of exactly that —
the recent stamped spans/wire events, the fault-ring kinds, the counter
snapshot — and dumps it to disk **atomically** (write-tmp + fsync +
rename + dir fsync, previous generation rotated to ``.1``) at the
moments that precede death or explain it:

  * every fault-ring entry (debounced to at most one dump per
    ``min_interval_s``);
  * a periodic heartbeat (the CLI's ``--metrics-interval`` loop calls
    :meth:`maybe_dump`), so even a fault-free incarnation that takes a
    SIGKILL leaves a dump at most one interval stale;
  * SIGTERM / graceful stop (``Hydrabadger.stop``) and
    checkpoint-corruption rejection (the store's fault hook routes
    through ``_note_fault``).

Dump paths embed the incarnation's pid (``<prefix>.<pid>.json``) so a
restarted process never rotates its predecessor's black box away.

Integrity mirrors :class:`~hydrabadger_tpu_torch.checkpoint.CheckpointStore`:
the payload carries a SHA-256 digest, a torn or bit-flipped dump is
rejected LOUDLY at load (:class:`FlightCorrupt`), and
:func:`load_flight_with_fallback` serves the previous generation instead
of silently trusting a half-written file.  A dump's payload and digest
rule are the JAX package's, so either package reads the other's dumps.

``HYDRABADGER_FLIGHT=0`` disables dumping (the ring keeps recording).
"""
from __future__ import annotations

import asyncio
import hashlib
import json
import os
import threading
import time
from typing import List, Optional, Tuple

from .recorder import DOMAIN_UNSPECIFIED

FLIGHT_SUFFIX = ".json"


def flight_enabled() -> bool:
    return os.environ.get("HYDRABADGER_FLIGHT", "1") != "0"


class FlightCorrupt(ValueError):
    """A flight dump failed its parse or digest check — torn write
    (SIGKILL mid-dump) or on-disk corruption.  Callers fall back to the
    previous generation, never trust the torn bytes."""


def _payload_digest(payload: dict) -> str:
    blob = json.dumps(payload, sort_keys=True, default=repr).encode()
    return hashlib.sha256(blob).hexdigest()


class FlightRecorder:
    """Bounded black box for one node incarnation.

    ``prefix`` is the per-slot path stem (``workdir/node2.flight``);
    the dump file is ``<prefix>.<pid>.json`` with one rotated previous
    generation at ``.1``.  The recorder/metrics/fault-ring references
    are the node's own live objects — nothing is copied until a dump.
    """

    def __init__(
        self,
        prefix: str,
        node: str = "?",
        recorder=None,
        metrics=None,
        fault_ring=None,
        capacity: int = 4096,
        min_interval_s: float = 1.0,
        clock=None,
        mono=None,
    ):
        self.prefix = prefix
        self.node = node
        self.recorder = recorder
        self.metrics = metrics
        self.fault_ring = fault_ring
        self.capacity = capacity
        self.min_interval_s = min_interval_s
        self.clock = clock or time.time
        # the debounce ruler: injectable (harness passes node._now) so
        # injected skew — and a test's fake clock — reaches the dump
        # cadence like every other node timer
        self._mono = mono or time.monotonic
        self.path = f"{prefix}.{os.getpid()}{FLIGHT_SUFFIX}"
        self.dumps = 0
        # self._mono domain; -inf = never dumped.  The injected seam is
        # the node's SKEWED clock, which a negative offset can hold
        # below zero for the whole run — a 0.0 sentinel would debounce
        # every dump away and the node would leave no black box at all.
        self._last_dump_t = float("-inf")
        self._write_inflight = None  # at most one executor write
        # serializes the executor-offloaded write against an inline
        # (sync=True) stop dump: both share one tmp path and one
        # rotation sequence, and interleaving them would tear the very
        # black box the stop path exists to leave behind
        self._write_lock = threading.Lock()
        self._dirty = False
        # tail fingerprint of the recorder ring at the last dump: the
        # heartbeat must keep dumping while a FAULT-FREE node makes
        # progress (new spans = a staler black box), not only on faults
        self._last_tail = None
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)

    # -- triggers ------------------------------------------------------------

    def note_fault(self, kind: str) -> None:
        """A fault-ring entry landed: dump (debounced) — faults are the
        events a post-mortem needs the surrounding spans for."""
        self._dirty = True
        self.maybe_dump(f"fault:{kind}")

    def _ring_tail(self):
        """Cheap fingerprint of the recorder ring's current tail."""
        ring = getattr(self.recorder, "events", None)
        if not ring:
            return None
        last = ring[-1]
        return (len(ring), last.name, last.t)

    def maybe_dump(self, reason: str) -> bool:
        """Debounced dump: at most one per ``min_interval_s`` (the
        fault-storm guard), and the periodic heartbeat skips only when
        literally nothing new was recorded since the last dump — a
        fault-free node that keeps committing keeps dumping, so the
        black box stays at most one interval stale."""
        now = self._mono()
        if now - self._last_dump_t < self.min_interval_s:
            return False
        if (
            reason == "periodic"
            and not self._dirty
            and self.dumps > 0
            and self._ring_tail() == self._last_tail
        ):
            return False
        self.dump(reason)
        return True

    # -- the dump ------------------------------------------------------------

    def black_box(self, reason: str) -> dict:
        # the JAX package's name (not "snapshot", MetricsRegistry's)
        events: List[dict] = []
        clock_domain = DOMAIN_UNSPECIFIED
        if self.recorder is not None:
            ring = getattr(self.recorder, "events", ())
            tail = list(ring)[-self.capacity:]
            events = [ev.as_dict() for ev in tail if ev.t is not None]
            clock_domain = getattr(
                self.recorder, "clock_domain", DOMAIN_UNSPECIFIED
            )
        faults: List[str] = []
        if self.fault_ring is not None:
            faults = [f.kind for _nid, f in self.fault_ring]
        counters = {}
        if self.metrics is not None:
            counters = self.metrics.snapshot()["counters"]
        return {
            "node": self.node,
            "pid": os.getpid(),
            "reason": reason,
            "t_wall": self.clock(),
            "clock_domain": clock_domain,
            "events": events,
            "faults": faults,
            "counters": counters,
        }

    def dump(self, reason: str, sync: bool = False) -> Optional[str]:
        """Atomic generational dump; returns the path (None when the
        plane is disabled, the write failed — a full disk must never
        take the node down with it — or an offloaded write is still in
        flight).

        The payload is captured synchronously from the live rings (they
        mutate under the event loop), then the disk half — two fsyncs +
        rotation — is offloaded to the default executor when a loop is
        running: a fault storm inside the handler loop must debounce
        into background writes, not stall the wire plane for the fsync
        latency (the checkpoint persist makes the same move).
        ``sync=True`` (graceful stop / SIGTERM, loop-less harnesses)
        writes inline: the process is about to exit and the black box
        must hit disk first."""
        if not flight_enabled():
            return None
        payload = self.black_box(reason)
        doc = {"flight": payload, "sha256": _payload_digest(payload)}
        loop = None
        if not sync:
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                loop = None
        if loop is not None:
            if (
                self._write_inflight is not None
                and not self._write_inflight.done()
            ):
                return None  # one write in flight; the debounce owns cadence
            fut = loop.run_in_executor(None, self._write, doc)
            self._write_inflight = fut
            # bookkeeping at submit time: the debounce window starts
            # when the dump was TAKEN (the payload is already frozen)...
            self.dumps += 1
            self._last_dump_t = self._mono()
            self._dirty = False
            self._last_tail = self._ring_tail()

            def _settled(f):
                # ...but a FAILED write (disk full) must not stand as a
                # dump: restore the dirty/tail state so the next
                # heartbeat retries instead of skipping a quiescent node
                failed = f.cancelled() or f.exception() is not None
                if not failed and f.result() is not None:
                    return
                self.dumps -= 1
                self._dirty = True
                self._last_tail = None

            fut.add_done_callback(_settled)
            return self.path
        if self._write(doc) is None:
            return None
        self.dumps += 1
        self._last_dump_t = self._mono()
        self._dirty = False
        self._last_tail = self._ring_tail()
        return self.path

    def _write(self, doc: dict) -> Optional[str]:
        """The blocking half: tmp-write + fsync + rotate + dir fsync.
        Runs inline (stop path) or on the default executor; the lock
        serializes the two, so a terminal stop dump and an in-flight
        heartbeat write can never interleave on the shared tmp path or
        rotation — whichever lands second rotates the other to ``.1``,
        and the loader reads both generations."""
        with self._write_lock:
            return self._write_locked(doc)

    def _write_locked(self, doc: dict) -> Optional[str]:
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "w") as fh:
                json.dump(doc, fh, default=repr)
                fh.flush()
                os.fsync(fh.fileno())
            if os.path.exists(self.path):
                os.replace(self.path, self.path + ".1")
            os.replace(tmp, self.path)
            dirfd = os.open(os.path.dirname(self.path) or ".", os.O_RDONLY)
            try:
                os.fsync(dirfd)
            finally:
                os.close(dirfd)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
        return self.path


# -- loading (the reader's side) ----------------------------------------------


def load_flight(path: str) -> dict:
    """Load + verify one dump.  Raises :class:`FlightCorrupt` on torn
    JSON (SIGKILL mid-write) or a digest mismatch — the CheckpointStore
    discipline: corruption is rejected loudly, never skipped over."""
    try:
        with open(path) as fh:
            doc = json.loads(fh.read())
    except (OSError, ValueError) as exc:
        raise FlightCorrupt(f"flight dump {path}: unreadable ({exc})")
    if not isinstance(doc, dict) or "flight" not in doc:
        raise FlightCorrupt(f"flight dump {path}: missing payload")
    payload = doc["flight"]
    if doc.get("sha256") != _payload_digest(payload):
        raise FlightCorrupt(f"flight dump {path}: digest mismatch")
    return payload


def load_flight_with_fallback(
    path: str,
) -> Tuple[Optional[dict], List[str]]:
    """Newest loadable generation of one dump path: try ``path``, fall
    back to ``path + '.1'``.  Returns (payload-or-None, rejected-paths)
    — callers surface every rejection; a reader that silently skipped
    a torn black box would defeat its purpose."""
    rejected: List[str] = []
    for candidate in (path, path + ".1"):
        if not os.path.exists(candidate):
            continue
        try:
            return load_flight(candidate), rejected
        except FlightCorrupt:
            rejected.append(candidate)
    return None, rejected
