"""CryptoFuture — the port's deferred result of one submitted device batch.

Copy of the contract of hydrabadger_tpu/crypto/futures.py, without its
metrics registry and overlap accounting:

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
  (`DroppedFutureWarning`).
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Optional


class DroppedFutureWarning(RuntimeWarning):
    """A CryptoFuture was garbage-collected before its result() ran."""


class CryptoFuture:
    """A deferred host materialization of one submitted device batch."""

    __slots__ = ("_fn", "_value", "_exc", "_done", "label")

    def __init__(self, fn: Optional[Callable[[], Any]], label: str = "crypto"):
        self._fn = fn
        self._value: Any = None
        self._exc: Optional[BaseException] = None
        self._done = False
        self.label = label

    @property
    def done(self) -> bool:
        """Has the host materialization run?"""
        return self._done

    def result(self) -> Any:
        if not self._done:
            fn, self._fn = self._fn, None
            try:
                self._value = fn()  # type: ignore[misc]
            except BaseException as e:
                # cache the failure: a second call re-raises it, never None
                self._exc = e
                raise
            finally:
                self._done = True
        if self._exc is not None:
            raise self._exc
        return self._value

    def __del__(self):
        if not self._done:
            warnings.warn(
                f"CryptoFuture {self.label!r} dropped without result(): device "
                "work and its protocol effect were discarded",
                DroppedFutureWarning,
                stacklevel=2,
            )

    def __repr__(self) -> str:
        return f"<CryptoFuture {self.label} {'done' if self._done else 'pending'}>"


def immediate(value: Any, label: str = "immediate") -> CryptoFuture:
    """A future that already holds its value (the CPU engine's submit_*)."""
    fut = CryptoFuture(None, label)
    fut._value = value
    fut._done = True
    return fut


def submit(fn: Callable[[], Any], label: str = "crypto") -> CryptoFuture:
    """Wrap a deferred materializer of an already dispatched computation."""
    return CryptoFuture(fn, label)
