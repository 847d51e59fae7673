"""CryptoFuture — the port's deferred result of one submitted device batch.

Copy of the contract of hydrabadger_tpu/crypto/futures.py:

* `submit(fn)` wraps a materializer `fn` that captures an ALREADY
  dispatched device computation: the engine's `submit_*` entry points
  launch the kernels at once (CUDA launches return before the card is
  done) and defer only the device-to-host copy and the host conversion
  into `fn`.  `immediate(value)` wraps a value computed already (the CPU
  engine's futures), so callers never branch on the engine.
* `result()` runs the materializer exactly once and caches its value or
  its exception: the protocol effect a result drives happens once.
* A future dropped without `result()` is device work thrown away and a
  protocol effect that never happened: `__del__` warns loudly
  (`DroppedFutureWarning`) and remembers its label, which
  `check_dropped` raises at the sim's tick boundary.
* Submitted futures keep the overlap accounting `stamp_gauges` writes: of
  the wall between a submit and its `result()`, the share the host spent
  elsewhere (`device_overlap_ratio`), and the wall with nothing in flight
  (`device_idle_s`).
* `enabled()` reads `HYDRABADGER_ASYNC` ("0": consumers settle at the
  submission site).
"""
from __future__ import annotations

import os
import time
import warnings
from typing import Any, Callable, List, Optional

import torch

from ..obs import metrics as M


class DroppedFutureWarning(RuntimeWarning):
    """A CryptoFuture was garbage-collected before its result() ran."""


_inflight = 0
_overlap_s = 0.0  # submit -> result(), the host elsewhere
_block_s = 0.0  # the host inside the materializer
_idle_since: Optional[float] = None
_idle_s = 0.0
_dropped: List[str] = []


def enabled() -> bool:
    """Is cross-poll deferral on?"""
    return os.environ.get("HYDRABADGER_ASYNC", "1") != "0"


def _leave(now: float) -> None:
    global _inflight, _idle_since
    _inflight = max(0, _inflight - 1)
    if _inflight == 0:
        _idle_since = now


def stamp_gauges(reg) -> None:
    """Write the cumulative overlap and idle gauges into `reg`, with the
    provenance gauge: 1 when this process has used a card."""
    total = _overlap_s + _block_s
    reg.gauge(M.DEVICE_OVERLAP_RATIO).set(round(_overlap_s / total, 4) if total else 0.0)
    reg.gauge(M.DEVICE_IDLE_S).set(round(_idle_s, 4))
    reg.gauge(M.DEVICE_OVERLAP_HAS_DEVICE).set(1 if torch.cuda.is_initialized() else 0)


def check_dropped() -> None:
    """Raise if any future was dropped unmaterialized since the last check."""
    if _dropped:
        labels, count = list(_dropped), len(_dropped)
        _dropped.clear()
        raise RuntimeError(
            f"{count} CryptoFuture(s) dropped without result(): {labels[:8]} — "
            "device work and its protocol effect were silently discarded"
        )


class CryptoFuture:
    """A deferred host materialization of one submitted device batch."""

    __slots__ = ("_fn", "_value", "_exc", "_done", "label", "_submit_t")

    def __init__(self, fn: Optional[Callable[[], Any]], label: str = "crypto"):
        global _inflight, _idle_s, _idle_since
        self._fn = fn
        self._value: Any = None
        self._exc: Optional[BaseException] = None
        self._done = False
        self.label = label
        self._submit_t = time.perf_counter()
        if _inflight == 0 and _idle_since is not None:
            _idle_s += self._submit_t - _idle_since
            _idle_since = None
        _inflight += 1

    @property
    def done(self) -> bool:
        """Has the host materialization run?"""
        return self._done

    def result(self) -> Any:
        global _overlap_s, _block_s
        if not self._done:
            fn, self._fn = self._fn, None
            t0 = time.perf_counter()
            try:
                self._value = fn()  # type: ignore[misc]
            except BaseException as e:
                # cache the failure: a second call re-raises it, never None
                self._exc = e
                raise
            finally:
                now = time.perf_counter()
                self._done = True
                _overlap_s += t0 - self._submit_t
                _block_s += now - t0
                _leave(now)
        if self._exc is not None:
            raise self._exc
        return self._value

    def __del__(self):
        if not self._done:
            try:
                _leave(time.perf_counter())
                _dropped.append(self.label)
            except Exception:
                pass  # interpreter teardown: the module may be gone
            warnings.warn(
                f"CryptoFuture {self.label!r} dropped without result(): device "
                "work and its protocol effect were discarded",
                DroppedFutureWarning,
                stacklevel=2,
            )

    def __repr__(self) -> str:
        return f"<CryptoFuture {self.label} {'done' if self._done else 'pending'}>"


def immediate(value: Any, label: str = "immediate") -> CryptoFuture:
    """A future that already holds its value (the CPU engine's submit_*),
    outside the overlap accounting: nothing was deferred."""
    fut = CryptoFuture.__new__(CryptoFuture)
    fut._fn, fut._value, fut._exc, fut._done, fut.label = None, value, None, True, label
    fut._submit_t = 0.0
    return fut


def submit(fn: Callable[[], Any], label: str = "crypto") -> CryptoFuture:
    """Wrap a deferred materializer of an already dispatched computation."""
    return CryptoFuture(fn, label)
