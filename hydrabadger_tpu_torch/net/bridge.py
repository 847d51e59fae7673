"""Async crypto micro-batching bridge.

The port's copy of hydrabadger_tpu/net/bridge.py.  The reference verifies
one BLS signature inline per wire frame (src/lib.rs:406-416) and generates
one decryption share at a time inside the consensus step (state.rs:487).
On the batch engines that shape is wrong: the card (and even the host
batch verifier's shared final exponentiation) want *many* operations per
dispatch.  `CryptoBridge` is the inference-server-style collector that
makes the conversion:

  * callers `await bridge.verify(pk, sig, msg)` (or `decrypt_share`)
    and get their single result back;
  * a collector task drains whatever requests accumulated, waits at
    most `max_delay_ms` for stragglers, and dispatches ONE
    `engine.verify_batch` / `engine.decrypt_share_batch` call in a
    worker thread — so the event loop never blocks on crypto, and
    per-connection checks amortise across connections;
  * under light load the delay bound keeps single-message latency flat
    (no batching cliff); under heavy load batches grow toward
    `max_batch` and throughput follows the engine's batch curve.

The node runtime additionally batches handler-queue traffic directly
(node.Hydrabadger._preverify_batch) — that path needs no futures because
the handler is the single consumer.  This bridge is the general-purpose
front door for library embedders and per-connection tasks.
"""
from __future__ import annotations

import asyncio
from typing import Any, List, Optional, Tuple

from ..crypto.engine import EngineLike, get_engine


class CryptoBridge:
    """Batches await-style crypto requests onto a batch engine."""

    def __init__(
        self,
        engine: EngineLike = None,
        max_batch: int = 512,
        max_delay_ms: float = 2.0,
        metrics=None,
    ):
        self.engine = get_engine(engine)
        self.max_batch = max_batch
        self.max_delay_s = max_delay_ms / 1000.0
        self._pending: List[Tuple[str, Any, asyncio.Future]] = []
        self._wake: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._closed = False
        # counters.  When a node's MetricsRegistry is passed, the same
        # counts mirror into it as `bridge_batches_dispatched` /
        # `bridge_requests_served`.
        self.metrics = metrics
        self.batches_dispatched = 0
        self.requests_served = 0

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._task is None:
            self._wake = asyncio.Event()
            self._task = asyncio.get_running_loop().create_task(
                self._collector()
            )

    async def stop(self) -> None:
        self._closed = True
        if self._wake is not None:
            self._wake.set()
        # swap-then-await (the double-buffer discipline): writing
        # self._task = None AFTER the await would clobber a task a
        # concurrent start() installed during the cancellation await
        task, self._task = self._task, None
        if task is not None:
            task.cancel()  # don't wait out a straggler window
            try:
                await task
            except asyncio.CancelledError:
                pass
        for _kind, _args, fut in self._pending:
            if not fut.done():
                fut.cancel()
        self._pending.clear()

    # -- request API ----------------------------------------------------------

    def _submit(self, kind: str, args) -> asyncio.Future:
        if self._closed:
            raise RuntimeError("CryptoBridge is stopped")
        if self._task is None:
            self.start()
        fut = asyncio.get_running_loop().create_future()
        self._pending.append((kind, args, fut))
        self._wake.set()
        return fut

    async def verify(self, pk, sig, msg: bytes) -> bool:
        """One signature check, transparently batched."""
        return await self._submit("verify", (pk, sig, msg))

    async def decrypt_share(self, sk_share, ct):
        """One threshold-decryption share, transparently batched."""
        return await self._submit("decrypt_share", (sk_share, ct))

    # -- collector -------------------------------------------------------------

    async def _collector(self) -> None:
        while not self._closed:
            if not self._pending:
                self._wake.clear()
                await self._wake.wait()
                continue
            # stragglers window: let concurrent tasks pile on, bounded
            if len(self._pending) < self.max_batch and self.max_delay_s > 0:
                await asyncio.sleep(self.max_delay_s)
            batch, self._pending = (
                self._pending[: self.max_batch],
                self._pending[self.max_batch :],
            )
            by_kind: dict = {}
            for kind, args, fut in batch:
                by_kind.setdefault(kind, []).append((args, fut))
            for kind, reqs in by_kind.items():
                args_list = [a for a, _f in reqs]
                try:
                    results = await asyncio.get_running_loop().run_in_executor(
                        None, self._dispatch, kind, args_list
                    )
                except asyncio.CancelledError:
                    # stop() mid-dispatch: the whole drained batch already
                    # left _pending, so cancel every future in it (not
                    # just this kind's) or their awaiters hang forever
                    for _kind, _args, fut in batch:
                        if not fut.done():
                            fut.cancel()
                    raise
                except Exception as exc:  # engine blew up: fail the batch
                    for _a, fut in reqs:
                        if not fut.done():
                            fut.set_exception(
                                exc if len(reqs) == 1 else RuntimeError(str(exc))
                            )
                    continue
                self.batches_dispatched += 1
                self.requests_served += len(reqs)
                if self.metrics is not None:
                    self.metrics.counter("bridge_batches_dispatched").inc()
                    self.metrics.counter("bridge_requests_served").inc(
                        len(reqs)
                    )
                for (_a, fut), res in zip(reqs, results):
                    if not fut.done():
                        fut.set_result(res)

    def _dispatch(self, kind: str, args_list) -> list:
        if kind == "verify":
            return self.engine.verify_batch(args_list)
        if kind == "decrypt_share":
            return self.engine.decrypt_share_batch(args_list)
        raise ValueError(f"unknown bridge op {kind!r}")
