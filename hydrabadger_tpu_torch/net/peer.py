"""Peer connection management for the TCP runtime.

The port's copy of hydrabadger_tpu/net/peer.py.

Re-creates the reference's L2 (src/peer.rs, SURVEY.md §1): one pump task
per socket draining a per-peer queue (peer.rs:92-114), a registry
addressable by socket address and node id (peer.rs:431-435), handshake
state per peer (peer.rs:219-236), and broadcast helpers
(`wire_to_all` / `wire_to_validators`, peer.rs:557-575).
"""
from __future__ import annotations

import asyncio
import time as _time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

from ..crypto.threshold import PublicKey
from ..obs.logging import get_logger
from ..utils.ids import InAddr, OutAddr, Uid
from .wire import WireMessage, WireStream

log = get_logger("hydrabadger_tpu_torch.net.peer")

# Per-peer outbound backlog ceiling.  The pump drains the queue onto the
# socket; a peer that stops reading (slow-loris) freezes the pump on TCP
# backpressure while broadcasts keep queueing — without a cap every
# attacker-triggered reply (pongs, transcripts, gossip) pins memory
# forever.  Beyond the cap the link is treated as dead: the node's
# disconnect path salvages undelivered frames into its wire-retry queue.
SEND_QUEUE_CAP = 8192


@dataclass
class Peer:
    """One live connection and what we know about the node behind it."""

    out_addr: OutAddr
    wire: WireStream
    outgoing: bool = False  # we dialled (vs accepted)
    uid: Optional[Uid] = None
    in_addr: Optional[InAddr] = None
    pk: Optional[PublicKey] = None
    state: str = "handshaking"  # handshaking | established
    send_queue: asyncio.Queue = field(default_factory=asyncio.Queue)
    pump_task: Optional[asyncio.Task] = None
    # frames that raced ahead of this connection's handshake; replayed
    # (in order) once the peer establishes — the reference parks the
    # same race in its wire retry queue (handler.rs:660-670)
    parked: List[tuple] = field(default_factory=list)
    parked_bytes: int = 0  # cumulative body bytes parked (budgeted)
    # when this connection was opened: a peer stuck in "handshaking"
    # past the node's handshake timeout (a hello/welcome lost in
    # flight on a lossy link) is culled and re-dialled,
    # because handshake frames are sent exactly once and nothing else
    # retries them.  The owning node stamps this from its OWN clock
    # (Hydrabadger._now) so the cull subtraction stays in one clock
    # domain; the host default covers peers built outside a node.
    born: float = field(default_factory=_time.monotonic)
    # obs/metrics registry of the owning node (set when the node adopts
    # the connection); per-frame tx counters + overflow events land here
    metrics: Optional[object] = None

    def establish(self, uid: Uid, in_addr: InAddr, pk: PublicKey) -> None:
        self.uid = uid
        self.in_addr = in_addr
        self.pk = pk
        self.wire.peer_pk = pk
        # once the peer authenticates, its stream knows the node id
        self.wire.peer_uid = uid.bytes
        self.state = "established"

    async def _pump(self) -> None:
        try:
            while True:
                msg = await self.send_queue.get()
                if msg is None:
                    break
                await self.wire.send(msg)
        except (ConnectionError, asyncio.IncompleteReadError, OSError):
            pass
        finally:
            self.wire.close()

    def start_pump(self) -> None:
        if self.pump_task is None:
            self.pump_task = asyncio.create_task(self._pump())

    def send(self, msg: WireMessage) -> None:
        if self.metrics is not None:
            self.metrics.counter("wire_tx_frames").inc()
        if self.send_queue.qsize() >= SEND_QUEUE_CAP:
            if self.metrics is not None:
                self.metrics.counter("peer_send_queue_overflows").inc()
            # a peer not draining thousands of frames is dead or
            # hostile; dropping the CONNECTION (not silently the frame)
            # routes recovery through the salvage/wire-retry path.  The
            # triggering frame is still enqueued first so drain_unsent
            # salvages it along with the rest of the backlog.
            log.warning(
                "send queue overflow to %s; dropping connection",
                self.out_addr,
            )
            self.send_queue.put_nowait(msg)
            self.abort()
            return
        self.send_queue.put_nowait(msg)

    def close(self) -> None:
        # graceful: the pump drains queued frames, then exits on the
        # sentinel.  Idempotent — repeated closes (overflow +
        # disconnect races) must not queue a sentinel per call.
        if self.state != "closing":
            self.state = "closing"
            self.send_queue.put_nowait(None)

    def abort(self) -> None:
        """Hard close: tear the transport down NOW.  A pump wedged in
        ``wire.send`` behind TCP backpressure would never reach a
        sentinel queued behind thousands of frames; closing the socket
        errors both the pump and the node's reader task, which routes
        recovery through ``_drop_peer`` -> ``drain_unsent`` salvage."""
        self.close()
        self.wire.close()

    def drain_unsent(self) -> List[WireMessage]:
        """Frames queued but not yet pumped onto the socket — salvaged by
        the node's wire-retry queue when a connection dies (a duplicate-
        connection tie-break mid-epoch must not lose RBC/ABA multicasts
        the protocol assumes delivered)."""
        out: List[WireMessage] = []
        try:
            while True:
                msg = self.send_queue.get_nowait()
                if msg is not None:
                    out.append(msg)
        except asyncio.QueueEmpty:
            pass
        return out


class Peers:
    """Registry of live peers, addressable by address and node id."""

    def __init__(self):
        self.by_addr: Dict[OutAddr, Peer] = {}
        self.by_uid: Dict[Uid, OutAddr] = {}

    def add(self, peer: Peer) -> None:
        self.by_addr[peer.out_addr] = peer

    def establish(self, peer: Peer) -> None:
        assert peer.uid is not None
        self.by_uid[peer.uid] = peer.out_addr

    def remove(self, peer: Peer) -> None:
        # identity check: a stale disconnect for an old connection must not
        # evict a live replacement peer registered at the same address
        if self.by_addr.get(peer.out_addr) is peer:
            self.by_addr.pop(peer.out_addr, None)
        if peer.uid is not None and self.by_uid.get(peer.uid) == peer.out_addr:
            live = self.by_addr.get(peer.out_addr)
            if live is None or live is peer:
                self.by_uid.pop(peer.uid, None)

    def get_by_uid(self, uid: Uid) -> Optional[Peer]:
        addr = self.by_uid.get(uid)
        return self.by_addr.get(addr) if addr is not None else None

    def established(self) -> Iterable[Peer]:
        return [p for p in self.by_addr.values() if p.state == "established"]

    def wire_to_all(self, msg: WireMessage) -> None:
        for peer in self.established():
            peer.send(msg)

    def wire_to_validators(self, msg: WireMessage, validator_uids) -> None:
        """Targeted multicast with an all-or-broadcast exclusion rule.

        The reference never implemented the exclusion: its
        ``wire_to_validators`` broadcasts to every peer with a FIXME
        ("Exclude non-validators", peer.rs:567-575), because HBBFT
        tolerates over-delivery (every handler drops frames from/for
        ids outside its validator set) but NOT under-delivery (a
        validator that misses a targeted RBC shard stalls the epoch).
        This port resolves the FIXME in the only direction that is
        safe under that asymmetry:

        * every uid in ``validator_uids`` resolves to an established
          connection -> send to exactly those peers (the exclusion the
          reference wanted);
        * ANY uid is unknown or still handshaking -> fall back to the
          reference's full broadcast, so the unresolved validator can
          still receive the frame via a connection registered after
          this check (e.g. both directions of a duplicate-connection
          tie-break).

        Over-delivery costs bandwidth; under-delivery costs liveness.
        """
        targets = [self.get_by_uid(uid) for uid in validator_uids]
        if any(p is None or p.state != "established" for p in targets):
            self.wire_to_all(msg)
            return
        for peer in targets:
            peer.send(msg)

    def wire_to(self, uid: Uid, msg: WireMessage) -> bool:
        peer = self.get_by_uid(uid)
        if peer is None or peer.state != "established":
            return False
        peer.send(msg)
        return True

    def count_established(self) -> int:
        return sum(1 for _ in self.established())

    def close_all(self) -> None:
        for peer in list(self.by_addr.values()):
            peer.close()
