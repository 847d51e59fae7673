"""Signed, length-delimited wire protocol for the real-network plane.

The port's copy of hydrabadger_tpu/net/wire.py: the same kinds, payload
tuples and frame bytes, so a port node and a JAX node talk to each other.

Re-creates the reference's L1 (SURVEY.md §1): every frame is a
canonically-encoded message wrapped with a BLS signature
(`SignedWireMessage`, lib.rs:350-355), length-prefixed on a TCP stream
(LengthDelimitedCodec, lib.rs:359), signed on send (lib.rs:429-447) and
signature-verified on receive for consensus/key-gen kinds
(lib.rs:397-423).

Message kinds (reference WireMessageKind, lib.rs:250-270 — same
semantic surface, our own encoding):

  hello_request_change_add  — dialler's greeting; asks to join
  welcome_received_change_add — listener's reply with a NetworkState
  hello_from_validator      — validator's greeting during key-gen
  goodbye                   — graceful disconnect
  message                   — consensus payload (signed+verified)
  key_gen                   — DKG Part/Ack (signed+verified)
  join_plan                 — committed JoinPlan broadcast
  net_state_request / net_state — discovery gossip
  transaction               — user txn relay
  ping/pong                 — liveness
"""
from __future__ import annotations

import asyncio
import hashlib
import time
from dataclasses import dataclass
from typing import Any, Optional, Tuple

from ..crypto.threshold import PublicKey, SecretKey, Signature
from ..obs.aggregate import consensus_tags
from ..obs.metrics import BYTES_RX_BY_KIND_PREFIX, BYTES_RX_TOTAL, BYTES_TX_TOTAL
from ..obs.recorder import NULL_RECORDER
from ..utils import codec
from ..utils.ids import Uid

MAX_FRAME = 64 * 1024 * 1024

# kinds whose payload must be signature-verified (the reference verifies
# Message/KeyGen, lib.rs:406-416; net_state and join_plan too: discovery
# gossip and join plans steer a node's view of the network, so when frame
# signing is on their frames must verify like consensus traffic.  The
# frontier claim INSIDE a net_state additionally carries its own validator
# signature, checked against the committed identity key regardless of the
# frame tier.)
VERIFIED_KINDS = frozenset({"message", "key_gen", "net_state", "join_plan"})

KINDS = frozenset(
    {
        "hello_request_change_add",
        "welcome_received_change_add",
        "hello_from_validator",
        "goodbye",
        "message",
        "key_gen",
        "join_plan",
        "era_transcript_request",
        "era_transcript",
        "net_state_request",
        "net_state",
        "transaction",
        "ping",
        "pong",
    }
)


@dataclass(frozen=True)
class WireMessage:
    kind: str
    payload: Any  # codec-encodable

    def encode(self) -> bytes:
        return codec.encode((self.kind, self.payload))

    @classmethod
    def decode(cls, raw: bytes) -> "WireMessage":
        """Decode one frame body.  Raises ValueError — and ONLY
        ValueError — on every malformed input (truncation, forged
        collection counts, wrong arity, non-sequence bodies, unknown
        kinds), so the read loops' fault path is the single exit for
        adversarial bytes."""
        body = codec.decode(raw)
        if not isinstance(body, tuple) or len(body) != 2:
            # a valid codec value of the wrong SHAPE (an int — or a
            # 2-key dict, whose iteration would unpack into its KEYS —
            # where the (kind, payload) pair belongs) is as malformed
            # as a bad byte — reject it on the same fault path
            raise ValueError(
                f"malformed wire frame: body is {type(body).__name__}, "
                "not a (kind, payload) pair"
            )
        kind, payload = body
        if not isinstance(kind, str) or kind not in KINDS:
            raise ValueError(f"unknown wire kind {kind!r}")
        return cls(kind, payload)


class WireError(ConnectionError):
    pass


class WireStream:
    """Framed signed messages over an asyncio stream pair."""

    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        secret_key: SecretKey,
        sign_frames: bool = True,
    ):
        self.reader = reader
        self.writer = writer
        self.secret_key = secret_key
        self.sign_frames = sign_frames
        self.peer_pk: Optional[PublicKey] = None  # set after handshake
        # the authenticated peer's node id, installed by Peer.establish
        # alongside peer_pk: it attributes a stream to the node behind it
        self.peer_uid: Optional[bytes] = None
        # bandwidth accounting: the stream IS the node's wire boundary,
        # so framed bytes are counted here — every send/recv, headers
        # included — into the owning node's registry (obs/metrics
        # BYTES_TX_TOTAL / BYTES_RX_TOTAL), wired by the owner
        # (Hydrabadger._new_stream assigns its registry)
        self.metrics = None
        # cluster-timeline correlation: with tracing on, the
        # stream stamps a wire_tx event as each frame is built and a
        # wire_rx event as each frame is read — tagged (node via the
        # bound recorder, peer uid, kind, frame digest as the message
        # id, plus era/epoch/instance for consensus payloads) so the
        # aggregator reconstructs per-message network latency and
        # cross-node stage ordering.  Events go straight into the
        # stamped ring (emit_stamped) on THIS node's clock — wired by
        # _new_stream alongside metrics; inert on the null recorder.
        self.obs = NULL_RECORDER
        self.clock = time.time

    def _peer_hex(self) -> str:
        return self.peer_uid.hex()[:8] if self.peer_uid else "?"

    def _wire_tags(self, msg: WireMessage) -> dict:
        """(era, epoch, instance, inner kind) for consensus payloads —
        best-effort, trace-path only.  The nested message sits at a
        different payload slot per kind: ``message`` is (src, payload),
        ``key_gen`` is (src, instance_id, payload)."""
        try:
            if msg.kind == "message":
                return consensus_tags(msg.payload[1])
            if msg.kind == "key_gen":
                return consensus_tags(msg.payload[2])
        except (TypeError, IndexError):
            pass
        return {}

    def _frame(self, msg: WireMessage) -> bytes:
        """Sign + length-prefix one message into its on-wire bytes.
        Factored from send() so a stream that builds frames another way
        keeps the codec/signing contract; the wire_tx trace event is
        stamped here."""
        body = msg.encode()
        sig = self.secret_key.sign(body).to_bytes() if self.sign_frames else b""
        frame = self._assemble(body, sig)
        if self.obs.enabled:
            # the frame digest is the message id: it pairs a send with
            # its receive exactly, whatever reorders frames
            self.obs.emit_stamped(
                "wire_tx",
                self.clock(),
                dst=self._peer_hex(),
                kind=msg.kind,
                mid=hashlib.sha256(frame).hexdigest()[:16],
                frame_bytes=len(frame),
                **self._wire_tags(msg),
            )
        return frame

    @staticmethod
    def _assemble(body: bytes, sig: bytes) -> bytes:
        # hblint: disable=secret-taint -- `sig` is a BLS SIGNATURE (public wire data derived via sign(); the reference ships it in every SignedWireMessage, lib.rs:350-355), not key material; the secret key itself never reaches this function
        frame = codec.encode((body, sig))
        if len(frame) > MAX_FRAME:
            raise WireError("frame too large")
        return len(frame).to_bytes(4, "big") + frame

    async def send(self, msg: WireMessage) -> None:
        # one write() call per frame: concurrent senders interleave at
        # frame, never byte, granularity
        frame = self._frame(msg)
        if self.metrics is not None:
            self.metrics.counter(BYTES_TX_TOTAL).inc(len(frame))
        self.writer.write(frame)
        await self.writer.drain()

    async def recv(self) -> Tuple[WireMessage, bytes, bytes]:
        """Read one frame.  Returns (message, body, signature) — signature
        verification happens at the *handler*, not here: the reader task
        can race ahead of the handshake frames still queued for the
        handler, so the pk may not be installed yet (per-connection FIFO
        guarantees the handler sees the hello first).
        """
        header = await self.reader.readexactly(4)
        length = int.from_bytes(header, "big")
        if length > MAX_FRAME:
            raise WireError("oversized frame")
        frame = await self.reader.readexactly(length)
        if self.metrics is not None:
            self.metrics.counter(BYTES_RX_TOTAL).inc(4 + length)
        body, sig_bytes = codec.decode(frame)
        msg = WireMessage.decode(bytes(body))
        if self.metrics is not None:
            # per-kind byte attribution: name space bounded
            # by wire.KINDS — decode above rejects anything else
            self.metrics.counter(BYTES_RX_BY_KIND_PREFIX + msg.kind).inc(
                4 + length
            )
        if self.obs.enabled:
            self.obs.emit_stamped(
                "wire_rx",
                self.clock(),
                src=self._peer_hex(),
                kind=msg.kind,
                mid=hashlib.sha256(header + frame).hexdigest()[:16],
                frame_bytes=4 + length,
                **self._wire_tags(msg),
            )
        return msg, bytes(body), bytes(sig_bytes)

    def verify(self, body: bytes, sig_bytes: bytes) -> bool:
        """Check a frame's signature against the handshaken peer key."""
        if self.peer_pk is None:
            return False
        try:
            sig = Signature.from_bytes(sig_bytes)
        except ValueError:
            return False
        return self.peer_pk.verify(sig, body)

    def close(self) -> None:
        try:
            self.writer.close()
        except Exception:
            pass


# -- payload helpers --------------------------------------------------------


def hello_request_change_add(uid: Uid, bind_host: str, bind_port: int, pk: PublicKey) -> WireMessage:
    return WireMessage(
        "hello_request_change_add",
        (uid.bytes, bind_host, bind_port, pk.to_bytes()),
    )


def welcome_received_change_add(
    uid: Uid, bind_host: str, bind_port: int, pk: PublicKey, net_state: tuple
) -> WireMessage:
    return WireMessage(
        "welcome_received_change_add",
        (uid.bytes, bind_host, bind_port, pk.to_bytes(), net_state),
    )


def hello_from_validator(
    uid: Uid, bind_host: str, bind_port: int, pk: PublicKey, net_state: tuple
) -> WireMessage:
    return WireMessage(
        "hello_from_validator",
        (uid.bytes, bind_host, bind_port, pk.to_bytes(), net_state),
    )


def consensus_message(src: Uid, payload: tuple) -> WireMessage:
    return WireMessage("message", (src.bytes, payload))


def key_gen_message(src: Uid, instance_id: tuple, payload: tuple) -> WireMessage:
    return WireMessage("key_gen", (src.bytes, instance_id, payload))


def goodbye(uid: Uid) -> WireMessage:
    return WireMessage("goodbye", (uid.bytes,))


def transaction(payload: bytes) -> WireMessage:
    """User txn relay (reference WireMessageKind::Transaction): an
    observer or client-facing node forwards a raw transaction to the
    validators, who fold it into their next contribution."""
    return WireMessage("transaction", bytes(payload))


def ping() -> WireMessage:
    """Liveness probe; the peer answers with pong()."""
    return WireMessage("ping", None)


def pong() -> WireMessage:
    return WireMessage("pong", None)
