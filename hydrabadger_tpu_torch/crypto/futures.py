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
* Every future counts itself in the process registry under JAX's names:
  `crypto_futures_submitted` when made, `crypto_futures_fetched` when its
  `result()` first runs (an immediate future counts both at once) and
  `crypto_futures_dropped` when it dies unfetched; each fetch stamps the
  overlap gauges there too.
* Submitted futures keep the overlap accounting `stamp_gauges` writes: of
  the wall between a submit and its `result()`, the share the host spent
  elsewhere (`device_overlap_ratio`), and the wall with nothing in flight
  (`device_idle_s`).
* `enabled()` reads `HYDRABADGER_ASYNC` ("0": consumers settle at the
  submission site).
* Completion order on the device is not protocol order: consumers apply
  effects in submission order, and `settle_in_order` is the one drain
  loop that does.
* `MsmCoalescer` (scoped on by `HYDRABADGER_COALESCE=1`, as the DHB sim
  does): within one router tick every node's DKG MSM batch only queues,
  and the first `result()` flushes the whole queue as one batched MSM
  (ops/msm_torch) on the device.  A failure of that launch raises in
  every queued submission; nothing falls back to the host.
"""
from __future__ import annotations

import os
import time
import warnings
from typing import Any, Callable, List, Optional, Sequence

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


def device_backend() -> str:
    """Provenance of the overlap gauges: "gpu" once this process holds a
    CUDA context, else "none" (never initialises the card)."""
    return "gpu" if torch.cuda.is_initialized() else "none"


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
    reg.gauge(M.DEVICE_OVERLAP_HAS_DEVICE).set(1 if device_backend() == "gpu" else 0)


def overlap_snapshot() -> dict:
    """The cumulative accounting as one JSON-able dict; the ratio reads
    "n/a (no device)" where no card was used (the raw value stays in
    `device_overlap_ratio_raw`)."""
    total = _overlap_s + _block_s
    ratio = round(_overlap_s / total, 4) if total else 0.0
    backend = device_backend()
    return {
        "device_overlap_ratio": ratio if backend == "gpu" else "n/a (no device)",
        "device_overlap_ratio_raw": ratio,
        "device_backend": backend,
        "device_overlap_s": round(_overlap_s, 4),
        "device_block_s": round(_block_s, 4),
        "device_idle_s": round(_idle_s, 4),
        "futures_dropped": len(_dropped),
    }


def reset_accounting() -> None:
    """Zero the cumulative accounting and the in-flight count (callers
    scope it at run boundaries, where nothing is in flight)."""
    global _overlap_s, _block_s, _idle_s, _idle_since, _inflight
    _overlap_s = _block_s = _idle_s = 0.0
    _idle_since = None
    _inflight = 0
    _dropped.clear()


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
        M.default_registry().counter(M.CRYPTO_FUTURES_SUBMITTED).inc()

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
                reg = M.default_registry()
                reg.counter(M.CRYPTO_FUTURES_FETCHED).inc()
                stamp_gauges(reg)
        if self._exc is not None:
            raise self._exc
        return self._value

    def __del__(self):
        if not self._done:
            try:
                _leave(time.perf_counter())
                _dropped.append(self.label)
                M.default_registry().counter(M.CRYPTO_FUTURES_DROPPED).inc()
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
    outside the overlap accounting: nothing was deferred.  It counts as
    submitted and fetched at once."""
    fut = CryptoFuture.__new__(CryptoFuture)
    fut._fn, fut._value, fut._exc, fut._done, fut.label = None, value, None, True, label
    fut._submit_t = 0.0
    reg = M.default_registry()
    reg.counter(M.CRYPTO_FUTURES_SUBMITTED).inc()
    reg.counter(M.CRYPTO_FUTURES_FETCHED).inc()
    return fut


def submit(fn: Callable[[], Any], label: str = "crypto") -> CryptoFuture:
    """Wrap a deferred materializer of an already dispatched computation."""
    return CryptoFuture(fn, label)


def settle_in_order(futures: Sequence[CryptoFuture], apply: Callable[[int, Any], None]) -> None:
    """Drain `futures`, applying effects in submission order:
    `apply(i, value)` runs strictly at ascending i, whatever order the
    device finished them in."""
    for i, fut in enumerate(futures):
        apply(i, fut.result())


# -- cross-node tick coalescing ---------------------------------------------


class MsmCoalescer:
    """Per-tick MSM coalescing for in-process multi-node runtimes.

    With coalescing scoped on, a submission only queues its jobs; the
    first `result()` of any queued future (in practice the tick-boundary
    drain) flushes the whole queue as one batched MSM and hands each
    submission its slice.  Jobs are independent lanes and the
    padding lanes are ladder identities, so this changes the launch count,
    never a value.  A submission whose points and scalars differ in length
    gets the structural ValueError at its own `result()`; the others still
    run.  A failure of the device launch itself raises in every submission
    of that flush: nothing falls back to the host."""

    def __init__(self):
        self._pending: List[tuple] = []  # (jobs, device, slot)

    def submit(self, jobs: Sequence, device, label: str = "msm-coalesced") -> CryptoFuture:
        slot: dict = {}
        self._pending.append((list(jobs), device, slot))
        M.default_registry().counter(M.MSM_COALESCE_SUBMISSIONS).inc()

        def _materialize():
            if "value" not in slot and "error" not in slot:
                self._flush()
            if "error" in slot:
                raise slot["error"]
            return slot["value"]

        return CryptoFuture(_materialize, label)

    def _flush(self) -> None:
        """One batched MSM over every well-formed queued submission, on the
        first one's device (the jobs are host points either way)."""
        from ..ops import msm_torch

        batch, self._pending = self._pending, []
        if not batch:
            return
        reg = M.default_registry()
        reg.counter(M.MSM_COALESCE_FLUSHES).inc()
        reg.gauge(M.MSM_COALESCE_WIDTH).track(len(batch))
        valid = []
        for jobs, device, slot in batch:
            if any(len(pts) != len(ks) for pts, ks in jobs):
                slot["error"] = ValueError("points/scalars length mismatch")
            else:
                valid.append((jobs, device, slot))
        if not valid:
            return
        try:
            results = msm_torch.g1_msm_batch_submit(
                [j for jobs, _d, _s in valid for j in jobs], valid[0][1])()
        except Exception as e:
            for _jobs, _d, slot in valid:
                slot["error"] = e
            raise
        i = 0
        for jobs, _d, slot in valid:
            slot["value"] = results[i : i + len(jobs)]
            i += len(jobs)


_MSM_COALESCER = MsmCoalescer()


def msm_coalescer() -> Optional[MsmCoalescer]:
    """The process coalescer while `HYDRABADGER_COALESCE=1`, else None (a
    future queued while the scope was on still flushes after it ends: its
    closure holds the coalescer)."""
    if os.environ.get("HYDRABADGER_COALESCE", "0") == "1":
        return _MSM_COALESCER
    return None
