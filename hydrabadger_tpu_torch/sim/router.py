"""Deterministic in-process message router for consensus cores.

The port's copy of hydrabadger_tpu/sim/router.py: N protocol instances
stepped in lockstep, a queue of (sender, recipient, message) delivered in
FIFO order or, with `shuffle`, in a seeded random order, and adversary
hooks.  The same seed draws the same deliveries in both packages, so the
same cores commit the same bytes.
"""
from __future__ import annotations

import random
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple, TypeVar

from ..consensus.types import Step
from ..obs.aggregate import consensus_tags
from ..obs.recorder import resolve as _resolve_recorder
from ..utils import codec

N = TypeVar("N", bound=Hashable)

# adversary: fn(sender, recipient, message) -> None to deliver unchanged,
# or a list of (sender, recipient, message) triples replacing the delivery
# (empty = drop; >1 = duplicate; sender is explicit so held/forged traffic
# keeps its true origin).  An adversary may also expose `flush()` returning
# such triples; the router calls it at quiescence so schedules that hold
# messages back (delay) model reordering, never permanent loss.
Adversary = Callable[[Any, Any, Any], Optional[List[Tuple[Any, Any, Any]]]]


class Router:
    """Routes Steps between named protocol instances until quiescence."""

    def __init__(
        self,
        node_ids,
        handle: Callable[[Any, Any, Any], Step],
        adversary: Optional[Adversary] = None,
        seed: int = 0,
        shuffle: bool = False,
        recorder=None,
        metrics=None,
        meter_bytes: bool = False,
        wire_events: bool = True,
        wire_sample: int = 32,
    ):
        self.node_ids = list(node_ids)
        self.handle = handle  # (our_id, sender, message) -> Step
        self.adversary = adversary
        self.rng = random.Random(seed)
        self.shuffle = shuffle
        # bandwidth metering: when on, every send attempt is priced at
        # its canonical wire size (the codec encoding of the message) at
        # the two chokepoints: tx at _enqueue (whether or not an
        # adversary then drops or holds it), rx at deliver_one (what
        # arrived, adversary-minted duplicates included).  Off by
        # default: the encode costs wall on the hot router path.
        self.meter_bytes = meter_bytes
        self.bytes_tx = 0
        self.bytes_rx = 0
        # per-kind rx byte attribution: innermost consensus
        # kind -> bytes, so the low-comm RBC cut is attributable to the
        # echo tier specifically.  Bounded: kinds come from the cores'
        # fixed protocol vocabulary; anything past the cap folds into
        # "other" so adversary-minted shapes cannot grow the dict.
        self.bytes_rx_by_kind: Dict[str, int] = {}
        # wire-event sequence: assigned at enqueue, carried with the
        # queue entry, echoed by the rx event — exact tx/rx pairing even
        # under shuffle delivery.  wire_events=False keeps span tracing
        # without the per-message tx/rx stamps.
        # wire_sample=N stamps every Nth enqueue (seq-deterministic, so
        # the sampled tx always has its sampled rx); =1 for exhaustive
        # pairing.
        self._wire_seq = 0
        self.wire_events = wire_events
        self.wire_sample = max(1, int(wire_sample))
        # id -> (message, size): identity-keyed, HOLDING the message so
        # its id cannot be recycled while cached (a bare id key could
        # alias a freed tuple's reused address and price a different
        # message at a stale size).  Bounded FIFO; sized so a queued
        # frame usually still has its entry when deliver_one prices the
        # rx side — without it every delivery would re-encode.
        self._size_cache: "OrderedDict[int, Tuple[Any, int]]" = OrderedDict()
        # the router IS the sim's I/O boundary: it stamps the cores'
        # pending events after each delivery and exports its own queue
        # depth
        self.obs = _resolve_recorder(recorder)
        self.metrics = metrics
        # txn-lifecycle ledgers (obs/latency.py), node id -> TxnLifecycle,
        # installed wholesale by the owning network: the delivery loop is
        # the sim's rx I/O boundary, so it stamps the recipient's buffered
        # lifecycle notes with the same clock read the recorder gets
        self.lifecycles: Dict[Any, Any] = {}
        # container by mode: a list supports the O(1) swap-pop random
        # pick shuffle needs; a deque supports the O(1) popleft FIFO
        # needs.  (deque.rotate for the random pick was O(queue) per
        # delivery — with ~10^5 queued messages at N=64 it dominated
        # the logic tier's wall time.)
        self.queue = [] if shuffle else deque()
        self.outputs: Dict[Any, List[Any]] = {nid: [] for nid in self.node_ids}
        self.faults: List[Tuple[Any, Any]] = []
        self.delivered = 0
        # hbasync: called once at each true quiescence, BEFORE run()
        # returns — the tick boundary where the owning network settles
        # the nodes' in-flight device work (drain completions next
        # tick).  A drain may enqueue follow-up traffic; the run loop
        # re-enters delivery if it did.
        self.drain_hook: Optional[Callable[[], None]] = None

    # size-cache FIFO bound: entries hold references to messages that
    # are (almost always) sitting in the queue anyway, so the cap only
    # limits bookkeeping overhead, not message lifetime
    SIZE_CACHE_CAP = 65536

    def _msg_size(self, message) -> int:
        """Canonical wire size of a sim message (codec encoding — the
        bytes the TCP tier would put in a frame body).  Cached by
        identity with the object held: a multicast enqueues the SAME
        object once per recipient and deliver_one prices it again on
        the rx side, so one encode serves the whole fan-out."""
        key = id(message)
        ent = self._size_cache.get(key)
        if ent is not None and ent[0] is message:
            return ent[1]
        try:
            size = len(codec.encode(message))
        except (TypeError, ValueError):
            size = 0  # non-codec test payloads: meter what we can
        self._size_cache[key] = (message, size)
        if len(self._size_cache) > self.SIZE_CACHE_CAP:
            self._size_cache.popitem(last=False)
        return size

    def dispatch_step(self, sender, step: Step) -> None:
        """Queue a step's messages; record its outputs/faults."""
        self.outputs[sender].extend(step.output)
        self.faults.extend((sender, f) for f in step.fault_log)
        for tm in step.messages:
            for recipient in self.node_ids:
                if recipient == sender:
                    continue  # multicasts are self-handled by cores
                if tm.target.includes(recipient):
                    self._enqueue(sender, recipient, tm.message)

    # Queue sanity ceiling: run() bounds DELIVERIES (max_messages), but
    # the queue itself can outgrow that between deliveries — a broken
    # core or an amplifying adversary schedule enqueueing faster than
    # deliver_one drains.  Fail loudly instead of filling host memory.
    MAX_QUEUE = 4_000_000

    # per-kind rx ledger cap: the cores' kind vocabulary is ~a dozen
    # tokens; 64 leaves slack, overflow folds into "other"
    RX_KIND_CAP = 64

    def _msg_kind(self, message) -> str:
        """Innermost consensus kind of a sim message (bc_echo, ba,
        dec_share, part…) for the per-kind byte ledger."""
        return str(consensus_tags(message).get("ckind", "other"))

    def _enqueue(self, sender, recipient, message) -> None:
        if self.meter_bytes:
            self.bytes_tx += self._msg_size(message)
        if len(self.queue) >= self.MAX_QUEUE:
            # record the terminal depth BEFORE raising: the loud-ceiling
            # post-mortem starts from the high-water gauge
            if self.metrics is not None:
                self.metrics.gauge("router_queue_depth").track(
                    len(self.queue)
                )
            raise RuntimeError(
                "router queue exceeded MAX_QUEUE — livelocked cores or "
                "an amplifying adversary schedule"
            )
        if self.adversary is not None:
            replacement = self.adversary(sender, recipient, message)
            if replacement is not None:
                # The router is the single enqueue chokepoint, so it
                # accounts the adversary's MECHANICAL wire effects.
                # Purely positional — one inject() call may drop the
                # original WHILE releasing frames held earlier, so
                # intent (drop vs hold vs duplicate) is only knowable
                # to the adversary itself (InjectionLog counts it by
                # taxonomy kind; these counters are the cross-check):
                #   absorbed — the original frame did not pass through
                #       this call (dropped, or held for later release);
                #   emitted  — extra frames beyond the pass-through
                #       (duplicates, replays, releases of held frames).
                if self.metrics is not None:
                    passed = sum(
                        1 for _s, _r, m in replacement if m is message
                    )
                    if passed == 0:
                        self.metrics.counter("router_adv_absorbed").inc()
                    extra = len(replacement) - min(passed, 1)
                    if extra > 0:
                        self.metrics.counter("router_adv_emitted").inc(
                            extra
                        )
                self.queue.extend(replacement)
                return
        if self.obs.enabled and self.wire_events:
            # cluster-timeline wire event: the enqueue IS the sim's tx
            # boundary.  Stamped directly (emit_stamped) — routing it
            # through the pending buffer would mis-stamp it with the
            # NEXT delivery's clock.  The seq AND the extracted tags
            # ride the queue entry so the rx event pairs exactly even
            # under shuffle and the nested-tuple walk runs once per
            # message, not once per side.  Unsampled messages pay one
            # increment + modulo.
            self._wire_seq += 1
            seq = self._wire_seq
            if seq % self.wire_sample == 0:
                tags = consensus_tags(message)
                self.obs.emit_stamped(
                    "wire_tx",
                    time.perf_counter(),
                    node=sender,
                    dst=recipient,
                    kind="message",
                    mid=seq,
                    **tags,
                )
                self.queue.append((sender, recipient, message, seq, tags))
                return
        self.queue.append((sender, recipient, message))

    def deliver_one(self) -> bool:
        if not self.queue:
            return False
        if self.shuffle:
            # uniform random pick in O(1): swap with the tail and pop
            idx = self.rng.randrange(len(self.queue))
            last = self.queue.pop()
            if idx == len(self.queue):
                item = last
            else:
                item = self.queue[idx]
                self.queue[idx] = last
        else:
            item = self.queue.popleft()
        # entries are (sender, recipient, message[, seq, tags]): the
        # seq/tags ride only traced enqueues; adversary-injected and
        # checkpoint-era entries stay 3-tuples
        sender, recipient, message = item[0], item[1], item[2]
        if self.meter_bytes:
            size = self._msg_size(message)
            self.bytes_rx += size
            kind = self._msg_kind(message)
            if kind not in self.bytes_rx_by_kind and (
                len(self.bytes_rx_by_kind) >= self.RX_KIND_CAP
            ):
                kind = "other"
            self.bytes_rx_by_kind[kind] = (
                self.bytes_rx_by_kind.get(kind, 0) + size
            )
        if self.obs.enabled and self.wire_events and len(item) > 3:
            # only sampled enqueues carry a seq: the rx event mirrors
            # exactly the tx events that exist
            self.obs.emit_stamped(
                "wire_rx",
                time.perf_counter(),
                node=recipient,
                src=sender,
                kind="message",
                mid=item[3],
                **item[4],
            )
        step = self.handle(recipient, sender, message)
        self.delivered += 1
        if step is not None:
            self.dispatch_step(recipient, step)
        if self.metrics is not None:
            self.metrics.gauge("router_queue_depth").track(len(self.queue))
        if self.obs.enabled or self.lifecycles:
            now = time.perf_counter()
            if self.obs.enabled:
                self.obs.stamp(now)
            # notes buffered by the recipient's core during this
            # delivery (admitted/proposed/committed) resolve to the
            # same boundary moment the trace events get
            lc = self.lifecycles.get(recipient)
            if lc is not None:
                lc.stamp(now)
        return True

    def run(self, max_messages: int = 1_000_000) -> int:
        count = 0
        while True:
            while self.deliver_one():
                count += 1
                if count > max_messages:
                    raise RuntimeError("router did not quiesce (livelock?)")
            # adversaries holding messages (e.g. delay) release them at
            # quiescence: delays model reordering, not permanent loss
            flush = getattr(self.adversary, "flush", None)
            released = flush() if flush is not None else None
            if released:
                for sender, recipient, message in released:
                    self.queue.append((sender, recipient, message))
                continue
            if self.drain_hook is not None:
                # settle in-flight device work at the tick boundary; a
                # second pass is a no-op (nothing left in flight), so
                # this cannot livelock the quiescence loop
                self.drain_hook()
                if self.queue:
                    continue
            return count
