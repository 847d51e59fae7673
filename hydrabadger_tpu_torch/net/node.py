"""The TCP node runtime: state machine, event handler, public API.

Re-creates the reference's L3-L5 (SURVEY.md §1) on asyncio:

  - `Config` with the reference's defaults (hydrabadger.rs:35-78)
  - `Hydrabadger` public API: run_node / propose_user_contribution /
    vote_for / register_epoch_listener / batch_queue / state / peers
    (hydrabadger.rs:127-603)
  - node state machine Disconnected -> AwaitingMorePeers ->
    GeneratingKeys -> Validator, or -> Observer via an active network's
    join info (state.rs:26-105 semantics)
  - bootstrap DKG over the wire with the reference's strict completion
    gate (all n parts, >= n^2 acks; key_gen.rs:373-386)
  - the single-consumer event handler: every socket task funnels into
    one internal queue, preserving the reference's one-lock-per-poll
    core (handler.rs:630; SURVEY.md §2.3)
  - dynamic membership: hello -> vote_to_add; disconnect ->
    vote_to_remove (handler.rs:77-88, 397-426); observers promoted when
    their committed change completes (handler.rs:698-715)

The consensus core is the same sans-io DynamicHoneyBadger the simulator
runs — the network plane only moves bytes.

The port's copy of hydrabadger_tpu/net/node.py: the same messages, state
machine and random draws, so port nodes and JAX nodes form one cluster.
Its seams:

  - `Config.engine` defaults to "gpu" (the card, which raises where there
    is none); the JAX package's default is "cpu".  An unknown name raises.
  - A failing `engine.verify_batch` is logged and re-raised: the handler
    task fails and `stop()` surfaces the error, instead of the per-frame
    fallback the JAX handler takes.
  - The handler scopes the DKG's device plane (crypto/dkg.plane_device) to
    the node's engine's device: `GpuEngine.device`, "cpu" for the host
    engine.
  - Durable checkpoints (`Config.checkpoint_path`, `checkpoint()`,
    `from_checkpoint`, checkpoint.CheckpointStore) are the JAX package's,
    byte for byte.  `crash()` settles the in-flight keygen flushes and
    `drain_async` and raises a device error once the sockets are closed,
    where the JAX handler discards it.
  - The wire chaos plane (`chaos=`, net/chaos.ChaosPlane) wraps every
    stream the node opens in its fault injector, and `set_slo()` installs
    a latency SLO whose violations land in the fault ring, as in the JAX
    node.
"""
from __future__ import annotations

import asyncio
import random
import time as _time
from collections import OrderedDict, deque, namedtuple
from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Dict, List, Optional

from ..checkpoint import CheckpointStore, NodeCheckpoint
from ..consensus.dynamic_honey_badger import DhbBatch, DynamicHoneyBadger, JoinPlan
from ..consensus.types import NetworkInfo, Step, quorum_exists
from ..crypto import dkg as _dkg
from ..crypto.dkg import Ack, Part, SyncKeyGen
from ..crypto.engine import get_engine
from ..crypto.threshold import PublicKey, SecretKey, Signature
from ..obs.latency import (
    STAGE_ADMITTED, STAGE_COMMITTED, STAGE_PROPOSED, SloTracker, TxnLifecycle, txn_id,
)
from ..obs.logging import get_logger
from ..obs.metrics import (
    CHECKPOINT_PERSIST_FAILURES,
    CHECKPOINT_PERSISTS_SKIPPED,
    MetricsRegistry,
)
from ..obs.recorder import resolve as _resolve_recorder
from ..utils.ids import InAddr, OutAddr, Uid
from . import wire
from .peer import Peer, Peers
from .wire import WireMessage, WireStream

if TYPE_CHECKING:
    from ..obs.flight import FlightRecorder

log = get_logger("hydrabadger_tpu_torch.net")

# Pre-handshake frame parking budgets (per connection): frames that race
# ahead of the handshake are held and replayed on establish, but an
# unauthenticated peer gets a small, fixed budget — count AND bytes.
PARKED_FRAME_CAP = 512
PARKED_BYTES_CAP = 4 * 1024 * 1024
# Keygen frames arriving before our own machine starts are queued for
# replay; retry storms re-send the transcript every tick, so membership
# checks must be O(1) (a set mirrors the ordered list).
KEYGEN_INBOX_CAP = 4096
# Targeted-frame retry queue (the reference retries undeliverable
# targeted messages up to 10 times: handler.rs:660-670, peer.rs:581-600,
# cap at mod.rs:17).  HBBFT assumes reliable delivery; a targeted RBC
# shard to a momentarily-unconnected peer must not be silently dropped.
WIRE_RETRY_CAP = 10
WIRE_RETRY_MAX_QUEUE = 4096
WIRE_RETRY_TICK_S = 0.25
# A connection still handshaking after this long has lost its hello or
# welcome in flight — those frames are sent exactly once, so nothing
# else would ever heal the link (one dropped handshake frame would wedge
# a connection into parking verified traffic forever).  Cull it;
# outgoing links re-dial.
HANDSHAKE_TIMEOUT_S = 5.0
# epoch liveness replay: if no batch commits for a tick, the node
# re-broadcasts its current-epoch consensus frames (bounded ring)
EPOCH_OUTBOX_MAX = 8192
EPOCH_REPLAY_TICK_S = 1.0
# Hard (jittered) ceiling on the backed-off INTER-REPLAY spacing (up
# to 16x the stall threshold without it): under repeated connection
# resets an EMA inflated by the fault window times the 16x backoff would
# push the next replay minutes out — precisely when replay is the only
# healer.  The stall THRESHOLD itself stays EMA-honest and uncapped (a
# 60 s full-crypto epoch is not a stall at 20 s); the +-20% jitter
# desynchronizes a cluster whose nodes all wedged at the same instant.
REPLAY_GAP_CEILING_S = 20.0
# connection keepalive (reference ping/pong, lib.rs WireMessageKind):
# a quiet link and a dead link are indistinguishable to TCP for
# minutes; a periodic ping keeps NAT/conntrack state warm and turns a
# dead socket into a prompt reader-task error
KEEPALIVE_TICK_S = 20.0
# wire `transaction` frames are unsigned and reachable pre-handshake,
# so the relay path bounds them; larger payloads belong in a signed
# validator contribution
MAX_TXN_BYTES = 1024 * 1024
# The single-consumer handler queue is attacker-paced (every socket
# frame lands here): bounded so a flooding peer hits TCP backpressure
# (the read loops await put) instead of growing host memory.
INTERNAL_QUEUE_CAP = 65536
# net_state gossip is unsigned and attacker-writable: clamp the dial
# fan-out one frame can trigger (honest rosters re-gossip, so a
# truncated roster still converges over later frames)
DISCOVERY_FANOUT_CAP = 256
# replay transcript bound (our part + <= n acks per live instance);
# shares the inbox ceiling so both sides of the replay net agree
KEYGEN_OUTBOX_CAP = KEYGEN_INBOX_CAP
# any established peer can open user-scoped DKG instances by sending a
# fresh instance id; each one costs a Part broadcast (n^2 traffic), so
# the live-instance count is capped
MAX_USER_KEYGENS = 64
# consensus frames arriving before the DHB exists; senders replay via
# their epoch-replay loop, so dropping beyond the cap only delays
IOM_QUEUE_CAP = 8192
# wire-tier fault ring: the TCP analogue of the sim router's fault_log.
# Every detection path (bad signature, src spoof, retry abandonment,
# fast-forward recovery) and every consensus-core fault entry lands here.
FAULT_RING_CAP = 1024
# A node this many epochs behind the certified network frontier is
# wedged, not slow (live peers stay within ~1 epoch of each other):
# rebuild the consensus core at the frontier.  The gap must clear 1 —
# a transient +1 between a committing peer and us is normal pipelining.
FAST_FORWARD_GAP = 3
# Disconnect-to-remove-vote grace: reconnect within this window and no
# removal vote is cast.  Votes persist per voter, so without the grace
# a season of independent transient resets would eventually accumulate
# a committed removal of a perfectly live validator.
REMOVE_VOTE_GRACE_S = 5.0

# wire-origin fault entries (ring shape matches the sim router's
# (node_id, fault-with-.kind) tuples)
WireFault = namedtuple("WireFault", ("kind",))


@dataclass
class Config:
    """Node configuration (reference defaults: hydrabadger.rs:35-45).

    ``engine`` is the resolved contract of the reference's "convert to
    builder pattern" TODO (hydrabadger.rs:49): backend selection hangs
    off this Config and nowhere else.  The name ("gpu" | "cpu" | any
    ``register_engine`` entry) is resolved through
    ``crypto.engine.get_engine`` exactly once per consumer — at node
    construction for the wire-signature plane (``Hydrabadger.engine``)
    and at consensus-core construction for the batch crypto plane
    (threaded into ``DynamicHoneyBadger``, including the
    ``from_join_plan`` resume path) — so one Config swaps every crypto
    backend coherently and an unknown name fails fast with
    ``ValueError`` instead of falling back silently.  The port's default
    is "gpu", the card: it raises where there is none.
    """

    txn_gen_count: int = 5
    txn_gen_interval_ms: int = 5000
    txn_gen_bytes: int = 2
    keygen_peer_count: int = 2
    output_extra_delay_ms: int = 0
    start_epoch: int = 0
    # crypto tier (the reference is always "full"; the fast tiers exist
    # for tests and CPU-bound development)
    encrypt: bool = True
    coin_mode: str = "threshold"
    verify_shares: bool = True
    wire_sign: bool = True  # BLS-sign/verify every frame (lib.rs:429-447)
    # CryptoEngine backend name — see the class docstring
    engine: str = "gpu"
    # reliable-broadcast variant (consensus/broadcast.py VARIANTS):
    # None resolves via HYDRABADGER_RBC, default "bracha"; "lowcomm"
    # selects the reduced-communication RBC (ROADMAP item 2).  Resolved
    # ONCE at node construction and threaded into every consensus-core
    # build (bootstrap DKG, observer join, checkpoint restore)
    rbc_variant: Optional[str] = None
    # durable checkpointing: when set, the node persists an era/epoch-
    # stamped NodeCheckpoint to this path (generational store,
    # checkpoint.CheckpointStore) every ``checkpoint_every`` committed
    # epochs and once more on graceful stop — the disk artifact a
    # SIGKILL'd process restarts from
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 1


class KeyGenMachine:
    """Async wrapper around one SyncKeyGen session over the wire.

    The reference's key_gen::Machine (key_gen.rs:59-123): await peers,
    generate, complete — with the strict gate of key_gen.rs:373-386
    (every proposal complete and >= n^2 acks observed).
    """

    def __init__(self, instance_id: tuple):
        self.instance_id = instance_id
        self.state = "awaiting_peers"
        self.kg: Optional[SyncKeyGen] = None
        self.n = 0
        self.event_queue: asyncio.Queue = asyncio.Queue()
        # acks that raced ahead of their part (the reference queues these
        # until the part count is complete, key_gen.rs:96-114), keyed by
        # (sender, proposer_idx) — replays dedup to one slot, and with
        # proposer indices range-checked the key space is exactly n^2,
        # so the queue is bounded by construction
        self.pending_acks: Dict[tuple, Ack] = {}

    def start(self, our_uid, our_sk, pub_keys: Dict, rng) -> Part:
        self.n = len(pub_keys)
        threshold = self.n // 3
        self.kg = SyncKeyGen(
            our_uid,
            our_sk,
            pub_keys,
            threshold,
            rng,
            session=str(self.instance_id).encode(),
        )
        self.state = "generating"
        return self.kg.propose()

    def handle_part(self, sender, part: Part):
        outcome = self.kg.handle_part(sender, part)
        if outcome.valid or outcome.recorded:
            self._drain_pending_acks()
        return outcome

    def handle_parts(self, items: List[tuple]) -> List:
        """A poll's worth of parts in one call: the underlying
        SyncKeyGen batches every row RLC check into a single MSM and
        seals the resulting ack values in one pass."""
        return self.handle_parts_submit(items)()

    def handle_parts_submit(self, items: List[tuple]):
        """Submit a poll's parts (hbasync): the row-RLC MSM dispatches
        now; the returned settle fetches the verdicts, replays any
        acks that raced ahead of their parts, and returns the
        outcomes.  The node's poll flush holds the settle across the
        NEXT poll's submit — the double buffer that keeps the device
        busy through the DKG storm."""
        settle_kg = self.kg.handle_parts_submit(items)

        def settle() -> List:
            outcomes = settle_kg()
            if any(o.valid or o.recorded for o in outcomes):
                self._drain_pending_acks()
            return outcomes

        return settle

    def handle_ack(self, sender, ack: Ack):
        if ack.proposer_idx not in self.kg.parts:
            from ..crypto.dkg import AckOutcome

            # a valid proposer index is a member slot: junk for
            # never-possible parts is rejected outright instead of
            # cycling through the pending queue forever
            n = len(self.kg.node_ids)
            if not 0 <= int(ack.proposer_idx) < n:
                return AckOutcome(False, fault="proposer index out of range")
            if len(self.pending_acks) >= n * n:
                # unreachable for honest + Byzantine senders combined
                # (<= n senders x n proposer slots after dedup); a loud
                # guard in case the invariant ever breaks
                return AckOutcome(False, fault="pending-ack overflow")
            self.pending_acks.setdefault((sender, ack.proposer_idx), ack)
            return AckOutcome(True)  # queued, not judged yet
        return self.kg.handle_ack(sender, ack)

    @property
    def ack_count(self) -> int:
        """Distinct (sender, proposer) acks recorded — duplicates from
        outbox replays on reconnect must not satisfy the n^2 gate."""
        if self.kg is None:
            return 0
        return sum(len(st.acks) for st in self.kg.parts.values())

    def _drain_pending_acks(self) -> None:
        pending, self.pending_acks = self.pending_acks, {}
        for (sender, _proposer), ack in pending.items():
            self.handle_ack(sender, ack)

    def is_complete(self) -> bool:
        return (
            self.kg is not None
            and self.kg.count_complete() == self.n
            and self.ack_count >= self.n * self.n
        )

    def generate(self):
        self.state = "complete"
        return self.kg.generate()


class Hydrabadger:
    """A consensus node (the reference's clone-able handle + runtime)."""

    def __init__(
        self,
        bind: InAddr,
        config: Optional[Config] = None,
        uid: Optional[Uid] = None,
        seed: Optional[int] = None,
        recorder=None,
        chaos=None,
    ):
        self.uid = uid or Uid()
        self.bind = bind
        self.cfg = config or Config()
        # RBC variant resolved once (explicit Config value wins over
        # the HYDRABADGER_RBC ambient default; utils/envflags) so every
        # core this node ever builds — bootstrap, join, restore,
        # fast-forward — agrees on the broadcast wire dialect
        from ..utils.envflags import resolve_rbc_variant

        self.rbc_variant = resolve_rbc_variant(
            getattr(self.cfg, "rbc_variant", None)
        )
        # wire-tier chaos plane (net/chaos.ChaosPlane, duck-typed so this
        # module never imports net/chaos): when set, every stream this node
        # opens is wrapped in the plane's fault injector
        self.chaos = chaos
        # hbtrace: the recorder is THE stamping boundary for this node's
        # consensus cores (handler poll = one stamp); metrics registry
        # is per-node so multi-node harnesses don't cross streams
        self.obs = _resolve_recorder(recorder).bind(
            node=self.uid.bytes.hex()[:8]
        )
        self.metrics = MetricsRegistry()
        # transaction-latency plane (obs/latency.py): this node IS the
        # I/O boundary, so submit/admitted/proposed/committed all stamp
        # inline on wall_now() — the same skewed-wall clock every other
        # feed reads, so the aggregator's alignment genuinely applies
        self.txn_lifecycle = TxnLifecycle()
        # SLO evaluation is opt-in per harness: install via set_slo()
        self._slo_tracker: Optional[SloTracker] = None
        # seed=None must mean real entropy: the uid is broadcast in every
        # hello frame, so deriving the RNG (hence the identity secret key
        # and encryption randomness) from it would be publicly replayable.
        # Explicit seeds remain available for deterministic tests.
        import os as _os

        self.rng = random.Random(
            seed if seed is not None
            else int.from_bytes(_os.urandom(16), "big")
        )
        self.secret_key = SecretKey.random(self.rng)
        self.public_key = self.secret_key.public_key()
        self.peers = Peers()
        self.state = "disconnected"
        self.dhb: Optional[DynamicHoneyBadger] = None
        self.key_gen: Optional[KeyGenMachine] = None
        self.user_key_gens: Dict[bytes, KeyGenMachine] = {}
        # everything we broadcast for in-flight keygens, resent to peers
        # whose handshake lands late (the reference keeps a wire retry
        # queue for the same race, handler.rs:660-670)
        self.keygen_outbox: List[WireMessage] = []
        # keygen traffic that arrived before our own machine started
        self.keygen_inbox: List[tuple] = []
        self._keygen_inbox_seen: set = set()  # O(1) dedup mirror
        # poll-scoped keygen part buffer: non-None only while
        # the handler loop drains one 50-msg poll — every part in the
        # poll settles its row RLC check in ONE batched MSM at flush
        self._kg_poll: Optional[List[tuple]] = None
        # hbasync double buffer: the PREVIOUS poll's submitted part
        # flushes, their MSMs still in flight — settled after the next
        # poll's submit (overlap) or immediately when the handler queue
        # is empty (no next poll imminent: deferring would stall the
        # DKG).  Entries: (machine, instance_id, items, settle).
        self._kg_prev: List[tuple] = []
        self.iom_queue: List[tuple] = []  # messages before DHB exists
        self.batch_queue: asyncio.Queue = asyncio.Queue()
        self.batches: List[DhbBatch] = []
        self.epoch_listeners: List[asyncio.Queue] = []
        self.current_epoch = self.cfg.start_epoch
        self._internal: asyncio.Queue = asyncio.Queue(
            maxsize=INTERNAL_QUEUE_CAP
        )
        self._overflow_tasks: set = set()  # awaited puts on a full queue
        self._dialing: set = set()  # OutAddrs with a connect in flight
        self._tasks: List[asyncio.Task] = []
        self._share_recovery_task: Optional[asyncio.Task] = None
        self._wire_retry: deque = deque()  # (uid, msg, attempts)
        # per-frame CUMULATIVE retry attempts: the deque tuples reset to
        # attempts=0 whenever a dying connection's salvage re-parks a
        # frame, so a peer that never returns could cycle one frame
        # through salvage->retry forever.  This bounded LRU remembers
        # attempts across cycles; at WIRE_RETRY_CAP the frame is dropped
        # LOUDLY (wire_retry_abandoned + fault ring).
        self._retry_attempts: OrderedDict = OrderedDict()
        # wire-tier fault ring (see FAULT_RING_CAP): (nid_hex, WireFault)
        self.fault_log: deque = deque(maxlen=FAULT_RING_CAP)
        # (era, epoch, net_state) frontier claims per established peer:
        # a fast-forward needs f+1 DISTINCT claimants at/above the
        # target, or one lying peer could wedge us at a forged epoch
        self._ff_claims: Dict[bytes, tuple] = {}
        # current-epoch outbound consensus frames, replayed by the
        # liveness tick if the epoch stalls (closed-socket in-flight
        # loss is invisible to sender-side salvage; every consensus
        # handler is duplicate-tolerant, so replay is always safe)
        self._epoch_outbox: deque = deque(maxlen=EPOCH_OUTBOX_MAX)
        self._last_progress_batches = 0
        # adaptive replay pacing: a fixed 1 s stall threshold would
        # declare EVERY full-crypto epoch stalled, and an unpruned outbox
        # makes each replay re-verify hundreds of stale frames at every
        # receiver — a quadratic death spiral.  Track the epoch-duration
        # EMA and back off.
        self._epoch_ema_s: Optional[float] = None
        # per-node clock seams: an offset and/or drift RATE may be
        # injected via the environment; every node timer reads the
        # skewed clock (_now) and every observability stamp the skewed
        # wall clock (wall_now).  _mono_base is the injectable monotonic
        # ruler underneath both (tests may swap in a fake clock).
        self._mono_base: Callable[[], float] = _time.monotonic
        self._clock_offset_s = float(
            _os.environ.get("HYDRABADGER_CLOCK_SKEW_S") or 0.0
        )
        self._clock_rate = float(
            _os.environ.get("HYDRABADGER_CLOCK_RATE") or 1.0
        )
        self._last_progress_t = self._now()
        self._replay_backoff = 1.0
        # node-clock time of the last replay.  -inf = never: the node
        # clock is SKEWED (a negative HYDRABADGER_CLOCK_SKEW_S can make
        # _now() negative for the whole run), so 0.0 is not "long ago"
        # — it would permanently suppress replays on a clock-behind
        # node.  Same discipline for every "last fired" sentinel below.
        self._last_replay_t = float("-inf")
        self._replayed_since_progress = False
        # user/generator contributions awaiting an epoch whose proposal
        # slot is still free (merged, in order, at the next opportunity)
        self._pending_user: deque = deque(maxlen=4096)
        self._transcript_served: Dict[OutAddr, float] = {}  # rate limiting
        # node-clock time of the last transcript REPLAY attempt (the
        # O(n^2) processing side); None = never (see _last_replay_t)
        self._last_transcript_attempt: Optional[float] = None
        self._server: Optional[asyncio.base_events.Server] = None
        self._stopped = asyncio.Event()
        self._gen_txns: Optional[Callable[[int, int], List[bytes]]] = None
        self.engine = get_engine(self.cfg.engine)
        # the DKG's device plane runs on the engine's device: the card for
        # GpuEngine, the plain versions on the host engine's CPU
        self.plane_device = getattr(self.engine, "device", "cpu")
        # flight recorder (obs/flight.py): mounted by the harness
        # (__main__ --flight); every fault-ring entry and the graceful
        # stop dump the black box
        self.flight: Optional["FlightRecorder"] = None
        # durable checkpoint store (Config.checkpoint_path): every
        # rejection/fallback inside the store lands in this node's fault
        # ring and metrics, exactly like a wire fault
        self._ckpt_store = None
        self._ckpt_inflight = None  # at most one executor write in flight
        if self.cfg.checkpoint_path:
            self._ckpt_store = CheckpointStore(
                self.cfg.checkpoint_path,
                metrics=self.metrics,
                fault=self._note_fault,
            )

    def _now(self) -> float:
        """This node's monotonic clock, with injected skew applied.

        THE timer seam: every raw clock read in the node routes through
        here, so injected skew — and a test's fake ``_mono_base`` —
        reaches every timer: replay backoff, stall declarations,
        handshake culls, transcript cooldowns."""
        return self._clock_offset_s + self._clock_rate * self._mono_base()

    def wall_now(self) -> float:
        """This node's WALL clock — host wall time plus the injected
        offset and drift (drift accrues on the monotonic axis so the
        result stays a plausible epoch timestamp).  Every observability
        feed this node writes (trace stamps, wire events, batch-log
        ``t`` fields) reads THIS clock."""
        return (
            _time.time()
            + self._clock_offset_s
            + (self._clock_rate - 1.0) * self._mono_base()
        )

    # -- public API (hydrabadger.rs:127-603) --------------------------------

    @property
    def our_id(self) -> bytes:
        return self.uid.bytes

    def is_validator(self) -> bool:
        return self.dhb is not None and self.dhb.is_validator

    def register_epoch_listener(self) -> asyncio.Queue:
        q: asyncio.Queue = asyncio.Queue()
        self.epoch_listeners.append(q)
        return q

    def propose_user_contribution(self, contribution: bytes) -> bool:
        """Queue a contribution; False when not (yet) a validator."""
        if not self.is_validator():
            return False
        self._internal_put(("api_propose", bytes(contribution)))
        return True

    def vote_for(self, change: tuple) -> bool:
        if self.dhb is None:
            return False
        self._internal_put(("api_vote", tuple(change)))
        return True

    def set_slo(self, spec) -> None:
        """Install a latency SLO (obs/latency.SloSpec), evaluated at every
        committed batch; a burn-rate violation is a fault-ring entry and an
        slo_violations count.  None removes it."""
        self._slo_tracker = SloTracker(spec) if spec is not None else None

    def submit_transaction(self, txn: bytes) -> bool:
        """Inject a raw transaction (reference Transaction relay).

        A validator folds it straight into its own pending
        contributions.  An observer relays it to ONE reachable
        validator (the first in the era's sorted validator set) — relaying
        to all of them would commit the same txn under every proposer,
        and nothing downstream dedups across contributions.  Before the
        validator set is known (still bootstrapping) the relay is a
        best-effort broadcast.  Returns False when the txn is oversized
        (MAX_TXN_BYTES — receivers drop larger unsigned frames) or no
        plausible recipient is reachable; True means handed off, not
        committed — exactly-once semantics remain an application
        concern (duplicate submissions to different validators commit
        twice)."""
        txn = bytes(txn)
        if len(txn) > MAX_TXN_BYTES:
            return False
        if self.is_validator():
            self._internal_put(("api_propose", txn))
            return True
        msg = wire.transaction(txn)
        if self.dhb is not None:
            for nid in self.dhb.netinfo.node_ids:
                if nid == self.uid.bytes:
                    continue
                if self.peers.wire_to(Uid(bytes(nid)), msg):
                    return True
            return False  # only non-validators reachable: would be lost
        if self.peers.count_established() == 0:
            return False
        self.peers.wire_to_all(msg)  # validator set unknown: best effort
        return True

    def checkpoint(self):
        """Snapshot durable consensus identity (a NodeCheckpoint).

        Only meaningful once the network is active (validator/observer);
        raises otherwise."""
        if self.dhb is None:
            raise RuntimeError("nothing to checkpoint: network not active")
        return NodeCheckpoint.capture(self.secret_key, self.dhb)

    @classmethod
    def from_checkpoint(
        cls,
        bind: InAddr,
        ckpt,
        config: Optional[Config] = None,
        seed: Optional[int] = None,
        chaos=None,
        recorder=None,
    ) -> "Hydrabadger":
        """Rebuild a node from a NodeCheckpoint (the port's or the JAX
        package's): same identity and keys, consensus core fast-forwarded
        to the saved era/epoch.  The node rejoins as validator (or
        observer if the checkpoint has no key share) instead of re-running
        DKG — the resume path the reference approximates with start_epoch
        + JoinPlan (state.rs:298, handler.rs:256-264).  If the network
        moved past the saved epoch while the node was down, the
        certified-frontier fast-forward (_maybe_fast_forward) catches it
        up after reconnect."""
        node = cls(
            bind, config, uid=Uid(ckpt.uid), seed=seed,
            recorder=recorder, chaos=chaos,
        )
        node.secret_key = SecretKey.from_bytes(ckpt.secret_key)
        node.public_key = node.secret_key.public_key()
        node.dhb = node._wrap_dhb(ckpt.restore_dhb(
            encrypt=node.cfg.encrypt,
            coin_mode=node.cfg.coin_mode,
            verify_shares=node.cfg.verify_shares,
            rng=node.rng,
            engine=node.cfg.engine,
            recorder=node.obs,
            rbc_variant=node.rbc_variant,
        ))
        node.current_epoch = ckpt.epoch
        node.state = "validator" if ckpt.sk_share else "observer"
        return node

    def new_key_gen_instance(self) -> asyncio.Queue:
        """Start a user-scoped DKG among current validators; events
        (('complete', pk_set, share) | ('failed', reason)) arrive on the
        returned queue.  (reference: hydrabadger.rs:312-320)"""
        machine = KeyGenMachine(("user", self.uid.bytes))
        self._internal_put(("api_user_keygen", machine))
        return machine.event_queue

    async def run_node(
        self,
        remotes: Optional[List[OutAddr]] = None,
        gen_txns: Optional[Callable[[int, int], List[bytes]]] = None,
    ) -> None:
        """Start the server, dial remotes, run until stop()."""
        await self.start(remotes, gen_txns)
        await self._stopped.wait()

    async def start(self, remotes=None, gen_txns=None) -> None:
        self._gen_txns = gen_txns
        self._server = await asyncio.start_server(
            self._on_incoming, self.bind.host, self.bind.port
        )
        self._tasks.append(asyncio.create_task(self._handler_loop()))
        self._tasks.append(asyncio.create_task(self._keygen_retry_loop()))
        self._tasks.append(asyncio.create_task(self._wire_retry_loop()))
        self._tasks.append(asyncio.create_task(self._epoch_replay_loop()))
        self._tasks.append(asyncio.create_task(self._keepalive_loop()))
        if gen_txns is not None:
            self._tasks.append(asyncio.create_task(self._generator_loop()))
        for remote in remotes or []:
            self._tasks.append(asyncio.create_task(self._connect_outgoing(remote)))
        log.info("%s listening on %s", self.uid, self.bind)

    async def crash(self) -> None:
        """SIGKILL emulation: tear the node down with NO goodbyes and no
        graceful pump drain — every socket dies mid-stream exactly as a
        killed process's would, queued frames and all — and write no
        checkpoint.  Peers observe reader errors, vote us out or retry,
        and the node restarts from its last checkpoint (from_checkpoint).

        One in-process concession: in-flight device work is settled and
        its effects discarded first, because the futures' drop ledger is
        process-global here, where a real SIGKILL takes the whole
        process's futures down with it.  A device error raised by that
        settle is raised once the sockets are closed, not swallowed."""
        self._stopped.set()
        errors = []
        prev, self._kg_prev = self._kg_prev, []
        with _dkg.plane_device(self.plane_device):
            for entry in prev:
                try:
                    entry[3]()  # materialize; effects discarded with the node
                except Exception as exc:
                    errors.append(exc)
            if self.dhb is not None:
                try:
                    self.dhb.drain_async()
                except Exception as exc:
                    errors.append(exc)
        if self._server is not None:
            self._server.close()
        for peer in list(self.peers.by_addr.values()):
            peer.wire.close()  # transport down NOW; no sentinel drain
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        if errors:
            raise errors[0]

    def _persist_checkpoint(self, sync: bool = False) -> None:
        """Write the durable consensus identity to the generational
        on-disk store (checkpoint.CheckpointStore).  Never raises: a full
        disk must not take down a committing node — the failure is
        counted, ringed and logged instead, and the previous generation
        stays loadable.

        The snapshot is captured synchronously (consensus state mutates
        under the handler loop) but the disk work — two fsyncs and the
        rotation — runs on the default executor, so the wire plane never
        stalls for the fsync latency on a committed epoch.  One write in
        flight at a time; an epoch arriving while the previous write is
        still syncing skips its persist (counted), leaving the cadence
        >= checkpoint_every.  ``sync=True`` (graceful stop) writes
        inline, AFTER the caller has awaited any write in flight."""
        if self._ckpt_store is None or self.dhb is None:
            return
        try:
            ckpt = self.checkpoint()
        except Exception:
            self._note_fault("checkpoint: persist failed", CHECKPOINT_PERSIST_FAILURES)
            log.exception("checkpoint capture failed")
            return
        if sync:
            try:
                self._ckpt_store.save(ckpt)
            except Exception:
                self._note_fault("checkpoint: persist failed", CHECKPOINT_PERSIST_FAILURES)
                log.exception("checkpoint persist failed")
            return
        if self._ckpt_inflight is not None and not self._ckpt_inflight.done():
            self.metrics.counter(CHECKPOINT_PERSISTS_SKIPPED).inc()
            return
        fut = asyncio.get_event_loop().run_in_executor(None, self._ckpt_store.save, ckpt)
        self._ckpt_inflight = fut

        def _done(f):
            try:
                f.result()
            except Exception:
                self._note_fault("checkpoint: persist failed", CHECKPOINT_PERSIST_FAILURES)
                log.exception("checkpoint persist failed")

        fut.add_done_callback(_done)

    async def stop(self) -> None:
        self._stopped.set()
        # settle any in-flight keygen flushes: device work must never be
        # silently discarded (crypto/futures drop detection is loud)
        prev, self._kg_prev = self._kg_prev, []
        with _dkg.plane_device(self.plane_device):
            for entry in prev:
                self._settle_kg_flush(entry)
        if self.dhb is not None:
            try:
                self.dhb.drain_async()
            except Exception:
                log.exception("drain_async failed during stop")
        # graceful stop: the LAST act before the transport dies is a final
        # durable checkpoint, so a restart resumes from the exact stop
        # epoch.  Await any executor write still in flight first — the
        # store's rotation is not safe under two concurrent writers.
        if self._ckpt_inflight is not None and not self._ckpt_inflight.done():
            try:
                await self._ckpt_inflight
            except Exception:
                pass  # already counted, ringed and logged by its done-callback
        self._persist_checkpoint(sync=True)
        if self.flight is not None:
            # a graceful stop leaves a final flight dump next to the final
            # checkpoint, inline: the process may exit right after
            self.flight.dump("stop", sync=True)
        if self._server is not None:
            self._server.close()
        self.peers.close_all()
        for t in self._tasks:
            t.cancel()
        results = await asyncio.gather(*self._tasks, return_exceptions=True)
        # a task that failed (the handler after a verify_batch failure)
        # surfaces here: a fault on the card must not pass for a stop
        for r in results:
            if isinstance(r, Exception):
                raise r

    # -- connection plumbing ------------------------------------------------

    def _new_stream(self, reader, writer) -> WireStream:
        """Build this node's side of a connection: with a chaos plane
        attached, the plane's fault injector (link drops, delays,
        duplicates, resets, partition holds applied at THIS socket
        boundary)."""
        if self.chaos is not None:
            stream = self.chaos.wrap_stream(reader, writer, self.secret_key, self.cfg.wire_sign,
                                            self.uid.bytes)
        else:
            stream = WireStream(reader, writer, self.secret_key, self.cfg.wire_sign)
        # bandwidth accounting: framed bytes counted at the stream,
        # attributed to this node's registry
        stream.metrics = self.metrics
        # cluster-timeline correlation: the stream stamps
        # wire_tx/wire_rx events into this node's bound recorder on the
        # node's (possibly skewed) wall clock
        stream.obs = self.obs
        stream.clock = self.wall_now
        return stream

    def _wrap_dhb(self, dhb):
        """Hook: every path that installs a consensus core routes the
        instance through here (bootstrap DKG, observer join, checkpoint
        restore, fast-forward).  The node is honest — identity;
        net/chaos.ByzantineHydrabadger wraps the core in the sim's
        ByzantineNode strategy pipeline."""
        return dhb

    def _note_fault(self, kind: str, counter: Optional[str] = None) -> None:
        """Record a wire-tier detection: fault ring entry (+ optional
        counter).  With a flight recorder mounted (obs/flight.py) every
        ring entry also triggers a debounced black-box dump, checkpoint
        corruption rejections included (the store's fault hook routes
        here)."""
        if counter is not None:
            self.metrics.counter(counter).inc()
        self.fault_log.append((self.uid.bytes.hex()[:8], WireFault(kind)))
        if self.flight is not None:
            self.flight.note_fault(kind)

    async def _on_incoming(self, reader, writer) -> None:
        addr = writer.get_extra_info("peername") or ("?", 0)
        out_addr = OutAddr(addr[0], addr[1])
        stream = self._new_stream(reader, writer)
        # born on the NODE clock: the handshake-cull subtraction must
        # not mix the skewed node domain with the host's
        peer = Peer(out_addr, stream, metrics=self.metrics, born=self._now())
        peer.start_pump()
        self.peers.add(peer)
        try:
            first, _body, _sig = await stream.recv()
            # the reference requires the first frame to be a hello
            # (hydrabadger.rs:339)
            if first.kind != "hello_request_change_add":
                log.warning("first frame from %s was %s", out_addr, first.kind)
                return
            self._internal_put(("incoming_hello", peer, first))
            await self._read_loop(peer, stream)
        except (ConnectionError, asyncio.IncompleteReadError, OSError, ValueError):
            pass
        finally:
            self._drop_peer(peer)

    async def _connect_outgoing(self, remote: OutAddr) -> None:
        # dial with bounded backoff: peers launched simultaneously (the
        # run-node script topology) race their listeners; the reference
        # absorbs the same race with its wire retry queue (capped at 10
        # attempts, handler.rs:660-670 / mod.rs:17)
        if remote in self._dialing:
            return  # a connect (incl. backoff sleeps) is already running:
            # a second dial to the same address would storm the registry
        self._dialing.add(remote)
        try:
            await self._connect_outgoing_inner(remote)
        finally:
            self._dialing.discard(remote)

    async def _connect_outgoing_inner(self, remote: OutAddr) -> None:
        reader = writer = None
        for attempt in range(10):
            try:
                reader, writer = await asyncio.open_connection(
                    remote.host, remote.port
                )
                break
            except OSError as e:
                log.warning(
                    "connect to %s failed (attempt %d): %r", remote, attempt, e
                )
                if attempt < 9:
                    await asyncio.sleep(min(0.2 * 2**attempt, 5.0))
        if reader is None:
            log.error("giving up dialling %s", remote)
            return
        stream = self._new_stream(reader, writer)
        peer = Peer(
            remote, stream, outgoing=True, metrics=self.metrics,
            born=self._now(),  # node clock: see _cull_stalled_handshakes
        )
        peer.start_pump()
        self.peers.add(peer)
        peer.send(
            wire.hello_request_change_add(
                self.uid, self.bind.host, self.bind.port, self.public_key
            )
        )
        try:
            await self._read_loop(peer, stream)
        except (ConnectionError, asyncio.IncompleteReadError, OSError, ValueError):
            pass
        finally:
            self._drop_peer(peer)

    async def _read_loop(self, peer: Peer, stream: WireStream) -> None:
        while True:
            msg, body, sig = await stream.recv()
            # awaited put: when the handler queue is full the reader
            # stops reading, so a flooding peer stalls on its own TCP
            # window instead of growing our memory
            await self._internal.put(("peer_msg", peer, msg, body, sig))

    def _drop_peer(self, peer: Peer) -> None:
        if peer.out_addr in self.peers.by_addr:
            self._internal_put(("peer_disconnect", peer))

    def _internal_put(self, item: tuple) -> None:
        """Enqueue a control-plane event onto the (bounded) handler
        queue.  On overflow — a node at its flood ceiling — fall back to
        an awaited put in a tracked task so disconnects and API calls
        are delayed, never silently dropped."""
        try:
            self._internal.put_nowait(item)
        except asyncio.QueueFull:
            self.metrics.counter("internal_queue_overflows").inc()
            if len(self._overflow_tasks) >= 1024:
                # a node this far past its flood ceiling is not making
                # progress; dropping (loudly) beats unbounded tasks
                log.warning("handler overflow backlog full; dropping an event")
                return
            t = asyncio.create_task(self._internal.put(item))
            self._overflow_tasks.add(t)
            t.add_done_callback(self._overflow_tasks.discard)

    # -- the single-consumer handler (handler.rs:621-783) -------------------

    async def _handler_loop(self) -> None:
        while True:
            item = await self._internal.get()
            batch = [item]
            # drain whatever else is queued (bounded like the reference's
            # MESSAGES_PER_TICK=50 poll budget, handler.rs:628) so wire
            # signature checks amortise into one engine.verify_batch call
            while not self._internal.empty() and len(batch) < 50:
                batch.append(self._internal.get_nowait())
            # the poll runs with the DKG's device plane on this node's
            # engine's device (a poll is synchronous: no other node's
            # scope interleaves)
            with _dkg.plane_device(self.plane_device):
                try:
                    self._preverify_batch(batch)
                except Exception:
                    # a failing batch check (a launch on the card) must
                    # not turn into host work: the handler task fails,
                    # and stop() surfaces the error
                    log.exception("batched signature verification failed")
                    raise
                self._kg_poll = []
                try:
                    for it in batch:
                        try:
                            self._handle_internal(it)
                        except Exception:
                            log.exception("handler error on %s", it[0])
                    try:
                        self._flush_kg_poll()
                    except Exception:
                        # same containment as the per-item guard: the
                        # handler coroutine must survive (senders replay
                        # keygen parts until the DKG completes, so a lost
                        # flush heals)
                        log.exception("keygen poll flush failed")
                finally:
                    self._kg_poll = None
            # the poll boundary is THE stamping point: everything the
            # cores emitted while this poll drained becomes externally
            # visible now — and the bounded queues get sampled at the
            # same cadence (depth + high-water, obs/metrics)
            self._obs_poll()

    def _obs_poll(self) -> None:
        """Per-poll metrics sample + trace stamp: every bounded queue
        exports current depth and high-water through one gauge."""
        m = self.metrics
        m.gauge("internal_queue_depth").track(self._internal.qsize())
        m.gauge("wire_retry_depth").track(len(self._wire_retry))
        m.gauge("epoch_outbox_depth").track(len(self._epoch_outbox))
        m.gauge("keygen_outbox_depth").track(len(self.keygen_outbox))
        m.gauge("keygen_inbox_depth").track(len(self.keygen_inbox))
        m.gauge("iom_queue_depth").track(len(self.iom_queue))
        m.gauge("pending_user_depth").track(len(self._pending_user))
        if self.key_gen is not None:
            m.gauge("pending_acks_depth").track(
                len(self.key_gen.pending_acks)
            )
        depth = 0
        for p in self.peers.by_addr.values():
            q = p.send_queue.qsize()
            if q > depth:
                depth = q
        m.gauge("peer_send_queue_depth").track(depth)
        if self.obs.enabled:
            # the node's wall clock (wall_now), not time.time(): with
            # injected skew the trace must carry the skewed stamps the
            # aggregator aligns, not a secretly honest clock
            self.obs.stamp(self.wall_now())

    def _preverify_batch(self, batch: List[tuple]) -> None:
        """Amortised wire-signature checks (SURVEY.md §7 hard part 3).

        All queued peer messages whose sender pk is already installed are
        verified in ONE engine.verify_batch call (shared final
        exponentiation on the host; the r_i * pk_i G1 multiplies on
        kernel B2 on the gpu engine);
        items are rewritten in place to carry their verdict.  Messages
        whose handshake is still in this same batch keep the inline
        per-frame path in _on_peer_msg — per-connection FIFO guarantees
        the hello precedes them in the batch."""
        if not self.cfg.wire_sign:
            return
        jobs = []
        for i, it in enumerate(batch):
            if it[0] != "peer_msg":
                continue
            peer, msg, body, sig = it[1], it[2], it[3], it[4]
            if msg.kind not in wire.VERIFIED_KINDS:
                continue
            if peer.wire.peer_pk is None:
                continue
            try:
                sig_obj = Signature.from_bytes(bytes(sig))
            except ValueError:
                continue  # malformed: inline path rejects it
            jobs.append((i, peer.wire.peer_pk, sig_obj, bytes(body)))
        if len(jobs) < 2:
            return  # nothing to amortise
        verdicts = self.engine.verify_batch(
            [(pk, sig, body) for _i, pk, sig, body in jobs]
        )
        for (i, _pk, _sig, _body), ok in zip(jobs, verdicts):
            it = batch[i]
            batch[i] = ("peer_msg", it[1], it[2], it[3], it[4], bool(ok))

    def _handle_internal(self, item: tuple) -> None:
        kind = item[0]
        if kind == "incoming_hello":
            self._on_hello(item[1], item[2], incoming=True)
        elif kind == "peer_msg":
            verdict = item[5] if len(item) > 5 else None
            self._on_peer_msg(item[1], item[2], item[3], item[4], verdict)
        elif kind == "peer_disconnect":
            self._on_disconnect(item[1])
        elif kind == "api_propose":
            # Queue-and-merge, never fire-and-forget: DHB accepts ONE
            # contribution per epoch, and the txn generator usually owns
            # it — a direct propose() here would be silently swallowed
            # by hb.has_input (a real starvation: user contributions on
            # a generator-driven node could miss every epoch forever).
            self._note_txn_submit(bytes(item[1]))
            self._pending_user.append(bytes(item[1]))
            self._flush_user_contributions()
        elif kind == "api_vote":
            if self.dhb is not None:
                self.dhb.vote_for(item[1])
        elif kind == "api_user_keygen":
            self._start_user_keygen(item[1])

    # -- handshake / discovery ----------------------------------------------

    @staticmethod
    def _frontier_doc(era, epoch, roster, validator_pks, pk_set_b,
                      session) -> bytes:
        """The signed document of one frontier claim: exactly the plan
        fingerprint _certified_frontier groups by (era, roster, the
        VALIDATORS' identity keys, pk_set, session) plus the claimed
        epoch — everything an adoption would trust."""
        from ..utils import codec

        return b"HBTPU-FRONTIER" + codec.encode(
            (
                int(era),
                int(epoch),
                tuple(roster),
                tuple(validator_pks),
                bytes(pk_set_b),
                bytes(session),
            )
        )

    def _frontier_sig(self, plan) -> bytes:
        """Our identity-key signature over the current frontier claim,
        cached per (era, epoch) — _net_state is rebuilt on every
        welcome/gossip reply, and one BLS sign per epoch is plenty."""
        cached = getattr(self, "_frontier_sig_cache", None)
        if cached is not None and cached[0] == (plan.era, plan.epoch):
            return cached[1]
        roster = tuple(plan.node_ids)
        doc = self._frontier_doc(
            plan.era,
            plan.epoch,
            roster,
            tuple((n, plan.pub_keys[n]) for n in roster),
            plan.pk_set_bytes,
            plan.session_id,
        )
        sig = self.secret_key.sign(doc).to_bytes()
        self._frontier_sig_cache = ((plan.era, plan.epoch), sig)
        return sig

    def _net_state(self) -> tuple:
        peers_info = tuple(
            (p.uid.bytes, p.in_addr.host, p.in_addr.port, p.pk.to_bytes())
            for p in self.peers.established()
            if p.uid is not None and p.in_addr is not None and p.pk is not None
        )
        if self.dhb is not None:
            plan = self.dhb.join_plan()
            return (
                "active",
                plan.era,
                plan.epoch,
                tuple(plan.node_ids),
                {k: v for k, v in plan.pub_keys.items()},
                plan.pk_set_bytes,
                plan.session_id,
                peers_info,
                # validator signature over the frontier claim: net_state
                # gossip itself is
                # relayable/attacker-writable, so _certified_frontier
                # counts only claims that verify under the COMMITTED
                # identity key of the claimed validator
                self._frontier_sig(plan),
            )
        if self.state == "generating_keys":
            return ("generating_keys", peers_info)
        return ("awaiting_more_peers", peers_info)

    def _on_hello(self, peer: Peer, msg: WireMessage, incoming: bool) -> None:
        uid_b, host, port, pk_b = msg.payload
        uid = Uid(bytes(uid_b))
        pk = PublicKey.from_bytes(bytes(pk_b))
        if not self._resolve_duplicate(peer, uid):
            return
        peer.establish(uid, InAddr(str(host), int(port)), pk)
        self.peers.establish(peer)
        self._replay_parked(peer)
        if self.state == "disconnected":
            self.state = "awaiting_more_peers"
        peer.send(
            wire.welcome_received_change_add(
                self.uid, self.bind.host, self.bind.port,
                self.public_key, self._net_state(),
            )
        )
        self._after_peer_established(uid, pk)

    def _on_peer_msg(
        self,
        peer: Peer,
        msg: WireMessage,
        body: bytes,
        sig: bytes,
        preverified: Optional[bool] = None,
    ) -> None:
        kind = msg.kind
        # per-kind rx counters: the name space is bounded by the fixed
        # wire.KINDS set (WireMessage construction enforces membership)
        self.metrics.counter("wire_rx_" + kind).inc()
        if kind in wire.VERIFIED_KINDS:
            if peer.uid is None:
                # frame raced ahead of this connection's handshake: park
                # it BEFORE the signature gate (no pk installed yet to
                # verify against); replay re-enters here with the pk set
                self._park(peer, msg, body, sig)
                return
            if self.cfg.wire_sign:
                ok = preverified if preverified is not None \
                    else peer.wire.verify(body, sig)
                if not ok:
                    self._note_fault(
                        "wire: bad signature", "wire_sig_rejected"
                    )
                    log.warning(
                        "bad %s signature from %s", kind, peer.out_addr
                    )
                    return
        if kind == "welcome_received_change_add":
            uid_b, host, port, pk_b, net_state = msg.payload
            uid = Uid(bytes(uid_b))
            pk = PublicKey.from_bytes(bytes(pk_b))
            if peer.state != "established":
                if not self._resolve_duplicate(peer, uid):
                    return
                peer.establish(uid, InAddr(str(host), int(port)), pk)
                self.peers.establish(peer)
                self._replay_parked(peer)
            if self.state == "disconnected":
                self.state = "awaiting_more_peers"
            self._on_net_state(net_state, peer)
            self._after_peer_established(uid, pk)
        elif kind == "hello_from_validator":
            uid_b, host, port, pk_b, net_state = msg.payload
            uid = Uid(bytes(uid_b))
            pk = PublicKey.from_bytes(bytes(pk_b))
            if peer.state != "established":
                if not self._resolve_duplicate(peer, uid):
                    return
                peer.establish(uid, InAddr(str(host), int(port)), pk)
                self.peers.establish(peer)
                self._replay_parked(peer)
                self._after_peer_established(uid, pk)
            self._on_net_state(net_state, peer)
        elif kind == "hello_request_change_add":
            self._on_hello(peer, msg, incoming=False)
        elif kind == "message":
            src_b, payload = msg.payload
            # the claimed source must be the authenticated connection peer
            # (the reference asserts this, peer.rs:158): otherwise any
            # connected peer could impersonate any validator
            if bytes(src_b) != peer.uid.bytes:
                self._note_fault("wire: src spoof", "wire_src_spoof")
                log.warning("message src spoof from %s", peer.out_addr)
                return
            self._on_consensus_message(bytes(src_b), payload)
        elif kind == "key_gen":
            src_b, instance_id, payload = msg.payload
            if bytes(src_b) != peer.uid.bytes:
                self._note_fault("wire: src spoof", "wire_src_spoof")
                log.warning("key_gen src spoof from %s", peer.out_addr)
                return
            self._on_key_gen_message(bytes(src_b), tuple(instance_id), payload)
        elif kind == "join_plan":
            self._on_join_plan(msg.payload)
        elif kind == "era_transcript_request":
            # serve the committed DKG transcript of our latest era switch
            # to a stranded added node (public, self-authenticating data).
            # Per-peer cooldown: the transcript is O(n^2) ciphertexts, so
            # repeat requests must not become a bandwidth amplifier.
            try:
                want_era = int(msg.payload)
            except (ValueError, TypeError):
                log.warning("bad era_transcript_request from %s", peer.out_addr)
                return
            if (
                self.dhb is not None
                and self.dhb.last_transcript is not None
                and self.dhb.last_transcript[0] == want_era
            ):
                # node clock (_now), not loop.time(): injected skew
                # must reach the serve cooldown like every other timer.
                # None = never served (a 0.0 sentinel would close the
                # gate forever on a clock-behind node whose _now() is
                # negative)
                now = self._now()
                last = self._transcript_served.get(peer.out_addr)
                if last is not None and now - last < 3.0:
                    return
                self._transcript_served[peer.out_addr] = now
                era, kg_era, entries = self.dhb.last_transcript
                peer.send(
                    WireMessage(
                        "era_transcript", (era, kg_era, tuple(entries))
                    )
                )
        elif kind == "era_transcript":
            self._on_era_transcript(msg.payload)
        elif kind == "net_state_request":
            peer.send(WireMessage("net_state", self._net_state()))
            # a gossiping peer that belongs to the bootstrap validator
            # set is a straggler: replay the keygen transcript so it can
            # close its n^2 ack gate even after we completed.  Joiners
            # from later eras get the join plan via net_state instead.
            if self.keygen_outbox and (
                self.dhb is None
                or (
                    self.dhb.era == self.cfg.start_epoch
                    and peer.uid is not None
                    and peer.uid.bytes in self.dhb.netinfo.node_ids
                )
            ):
                for kg_msg in self.keygen_outbox:
                    peer.send(kg_msg)
        elif kind == "net_state":
            self._on_net_state(msg.payload, peer)
        elif kind == "transaction":
            # unsigned kind, reachable before the handshake: accept only
            # bounded raw bytes from an established peer.  (bytes() on an
            # attacker-chosen codec value is the trap — bytes(10**12) is
            # a terabyte zero-buffer allocation.)
            if (
                peer.state == "established"
                and isinstance(msg.payload, (bytes, bytearray, memoryview))
                and len(msg.payload) <= MAX_TXN_BYTES
                and self.is_validator()
            ):
                self._internal_put(("api_propose", bytes(msg.payload)))
        elif kind == "goodbye":
            peer.close()
        elif kind == "ping":
            peer.send(wire.pong())
        elif kind == "pong":
            pass  # keepalive reply; receipt itself is the signal

    def _on_net_state(self, net_state, peer: Optional[Peer] = None) -> None:
        tag = net_state[0]
        if tag in ("awaiting_more_peers", "generating_keys"):
            peers_info = net_state[1]
            self._discover(peers_info)
        elif tag == "active" and self.dhb is None:
            if (
                self.key_gen is not None
                and self.uid.bytes in tuple(bytes(n) for n in net_state[3])
            ):
                # we are IN the validator set and our own bootstrap DKG is
                # still converging (a stalled link now healing via gossip):
                # joining as an observer would discard our validator share
                # — but keep dialling the peers the gossip just taught us
                self._discover(net_state[7])
                return
            (_tag, era, epoch, node_ids, pub_keys, pk_set_b, session,
             peers_info, _sig) = net_state
            plan = JoinPlan(
                era=int(era),
                epoch=int(epoch),
                node_ids=tuple(bytes(n) for n in node_ids),
                pub_keys={bytes(k): bytes(v) for k, v in pub_keys.items()},
                pk_set_bytes=bytes(pk_set_b),
                session_id=bytes(session),
            )
            self._become_observer(plan)
            self._discover(peers_info)
        elif tag == "active":
            # live consensus already: this gossip is a frontier claim —
            # the crash/restart recovery signal (see _maybe_fast_forward)
            self._note_frontier_claim(net_state, peer)
            self._discover(net_state[7])

    # -- crash/restart recovery: certified epoch fast-forward ---------------

    def _note_frontier_claim(self, net_state, peer: Optional[Peer]) -> None:
        """Record an established validator's claimed (era, epoch)
        frontier.  Two independent defenses (a frontier hijack moves a
        node's whole consensus view): the claim must carry a signature
        verifying under the COMMITTED identity key registered for the
        claiming validator — a connection that merely hello'd as a
        validator uid cannot mint claims — and even then no single claim moves us: a
        fast-forward requires f+1 distinct authenticated claimants at/
        above the target epoch, at least one of them honest."""
        if peer is None or peer.uid is None or self.dhb is None:
            return
        if peer.uid.bytes not in self.dhb.netinfo.node_ids:
            return  # only validator claims count toward certification
        try:
            # validate the FULL shape up front: a malformed claim that
            # only failed at adoption time would otherwise sit at the
            # frontier and permanently block recovery.  The fingerprint
            # is everything an adoption would trust — era, roster, the
            # VALIDATORS' identity keys, pk_set, session — so the f+1
            # certification covers the payload, not just the ordinal
            # (observer pub_keys entries legitimately differ between
            # honest peers and are deliberately excluded).
            (_tag, era, epoch, node_ids, pub_keys, pk_set_b, session,
             _peers_info, sig_b) = net_state
            era, epoch = int(era), int(epoch)
            roster = tuple(bytes(n) for n in node_ids)
            pks = {bytes(k): bytes(v) for k, v in pub_keys.items()}
            validator_pks = tuple((n, pks[n]) for n in roster)
            fingerprint = (
                era,
                roster,
                validator_pks,
                bytes(pk_set_b),
                bytes(session),
            )
            sig = Signature.from_bytes(bytes(sig_b))
        except (TypeError, ValueError, IndexError, KeyError):
            return
        # authenticate against the pk COMMITTED for this validator in
        # our era's pub_keys (identity keys are long-lived, so a
        # later-era claimant still verifies) — never the hello-presented
        # key, which any connection chooses freely
        pk = self.dhb.pub_keys.get(peer.uid.bytes)
        doc = self._frontier_doc(
            era, epoch, roster, validator_pks, pk_set_b, session
        )
        if pk is None or not pk.verify(sig, doc):
            self._note_fault(
                "wire: frontier claim rejected", "wire_frontier_rejected"
            )
            log.warning(
                "unauthenticated frontier claim from %s", peer.out_addr
            )
            return
        self._ff_claims[peer.uid.bytes] = (era, epoch, fingerprint)
        self._maybe_fast_forward()

    def _rebuild_same_era(self, d, epoch: int) -> None:
        """Rebuild the consensus core at ``epoch`` within our CURRENT
        era — own keys, own pk_set, our secret share carried over:
        nothing attacker-supplied.  (No logging in here: the share is
        live key material.)"""
        plan = d.join_plan()
        plan = JoinPlan(
            era=plan.era,
            epoch=epoch,
            node_ids=plan.node_ids,
            pub_keys=plan.pub_keys,
            pk_set_bytes=plan.pk_set_bytes,
            session_id=plan.session_id,
        )
        share = d.netinfo.sk_share
        self.dhb = self._wrap_dhb(
            DynamicHoneyBadger.from_join_plan(
                self.uid.bytes,
                self.secret_key,
                plan,
                encrypt=self.cfg.encrypt,
                coin_mode=self.cfg.coin_mode,
                verify_shares=self.cfg.verify_shares,
                rng=self.rng,
                engine=self.cfg.engine,
                recorder=self.obs,
                sk_share=share,
                rbc_variant=self.rbc_variant,
            )
        )
        self.state = "validator" if share is not None else "observer"

    def _certified_frontier(self) -> Optional[tuple]:
        """The highest (era, epoch) at least f+1 distinct validators
        claim to have reached — Byzantine-safe in BOTH dimensions: with
        at most f liars, the (f+1)-th largest epoch within a group of
        claims sharing one PLAN FINGERPRINT (era, roster, validator
        identity keys, pk_set, session) is backed by an honest node,
        and so is the fingerprint itself.  Certifying only the ordinal
        would let a Byzantine validator ride an honest (era, epoch)
        with a forged pk_set/roster payload and hijack the recovering
        node's view.  Returns (era, epoch, fingerprint) of an
        honest-backed claim, or None."""
        if self.dhb is None:
            return None
        n = len(self.dhb.netinfo.node_ids)
        f = (n - 1) // 3
        groups: Dict[tuple, List[tuple]] = {}
        for claim in self._ff_claims.values():
            groups.setdefault(claim[2], []).append(claim)
        best = None
        for members in groups.values():
            if len(members) < quorum_exists(n, f):
                continue
            members = sorted(
                members, key=lambda c: (c[0], c[1]), reverse=True
            )
            candidate = members[f]  # (f+1)-th largest epoch in-group
            if best is None or (candidate[0], candidate[1]) > (
                best[0], best[1]
            ):
                best = candidate
        return best

    def _maybe_fast_forward(self) -> None:
        """Re-adopt the certified network frontier when wedged behind it.

        A validator restarted from a checkpoint (or stranded by a long
        partition) resumes at a stale epoch; the network has moved on
        and nobody re-serves concluded epochs' traffic, so without this
        it would stall forever while the honest quorum keeps committing.
        When f+1 validators claim an epoch >= ours + FAST_FORWARD_GAP:

          * same era — rebuild the consensus core from OUR OWN join
            plan (own keys, own pk_set: nothing attacker-supplied) at
            the certified epoch, carrying our secret share over, so we
            come back as a validator and catch the in-flight epoch via
            the peers' welcome-back replay;
          * later era — our share is stale; adopt the CERTIFIED plan
            (built from the f+1-backed fingerprint, never one
            claimant's raw payload) as an observer and recover the new
            era's share through the committed-transcript flow
            (_maybe_recover_share)."""
        d = self.dhb
        cert = self._certified_frontier()
        if d is None or cert is None:
            return
        era, epoch, fingerprint = cert
        if era < d.era or (era == d.era and epoch < d.epoch + FAST_FORWARD_GAP):
            return
        # settle in-flight device work before discarding the old core —
        # a dropped CryptoFuture is a loud process-global failure
        try:
            d.drain_async()
        except Exception:
            log.exception("drain_async failed during fast-forward")
        if era == d.era:
            self._rebuild_same_era(d, int(epoch))
        else:
            _era, roster, validator_pks, pk_set_b, session = fingerprint
            self._become_observer(
                JoinPlan(
                    era=int(era),
                    epoch=int(epoch),
                    node_ids=roster,
                    pub_keys=dict(validator_pks),
                    pk_set_bytes=pk_set_b,
                    session_id=session,
                )
            )
            self._maybe_recover_share()
        old_epoch, self.current_epoch = self.current_epoch, int(epoch)
        # frames of concluded epochs would only cost every receiver a
        # signature check on our next stall replay
        self._epoch_outbox.clear()
        self._last_progress_t = self._now()
        self._replay_backoff = 1.0
        self._note_fault("wire: fast-forward", "node_fast_forwards")
        log.info(
            "%s fast-forwarded era %d epoch %d -> era %d epoch %d "
            "(certified by f+1 peers)",
            self.uid, d.era, old_epoch, era, int(epoch),
        )

    def _discover(self, peers_info) -> None:
        """Dial newly-learned peers (handler.rs:377-393).

        net_state gossip is unsigned (attacker-writable), so the dial
        fan-out one frame can trigger is clamped and completed dial
        tasks are pruned before new ones are tracked — a forged
        million-entry roster must cost neither a million sockets nor a
        million task objects.  Honest rosters re-gossip every retry
        tick, so truncation still converges."""
        if len(peers_info) > DISCOVERY_FANOUT_CAP:
            log.warning(
                "truncating oversized peers_info gossip (%d entries)",
                len(peers_info),
            )
            peers_info = peers_info[:DISCOVERY_FANOUT_CAP]
        self._tasks = [t for t in self._tasks if not t.done()]
        for uid_b, host, port, pk_b in peers_info:
            uid = Uid(bytes(uid_b))
            if uid == self.uid or self.peers.get_by_uid(uid) is not None:
                continue
            remote = OutAddr(str(host), int(port))
            if remote in self.peers.by_addr or remote in self._dialing:
                continue
            self._tasks.append(
                asyncio.create_task(self._connect_outgoing(remote))
            )

    def _park(self, peer: Peer, msg, body: bytes, sig: bytes) -> None:
        """Hold a verified-kind frame that raced ahead of this
        connection's handshake; _replay_parked re-runs it (in order,
        signature still checked) once the peer's identity is known."""
        # budget by count AND bytes: an unauthenticated connection must
        # not be able to pin memory by streaming huge pre-handshake
        # frames (frame cap is 64 MB; 512 of those would be 32 GB)
        if (
            len(peer.parked) < PARKED_FRAME_CAP
            and peer.parked_bytes + len(body) <= PARKED_BYTES_CAP
        ):
            peer.parked.append((msg, bytes(body), bytes(sig)))
            peer.parked_bytes += len(body)
        else:
            log.warning("parked-frame overflow from %s", peer.out_addr)

    def _replay_parked(self, peer: Peer) -> None:
        parked, peer.parked = peer.parked, []
        peer.parked_bytes = 0
        for msg, body, sig in parked:
            self._on_peer_msg(peer, msg, body, sig)

    def _resolve_duplicate(self, peer: Peer, uid: Uid) -> bool:
        """Keep one connection per node pair.  Both ends agree on the
        survivor: the link dialled by the lexicographically-lower uid.
        Returns False when `peer` is the redundant one (already closed)."""
        if uid == self.uid:
            peer.close()
            self.peers.remove(peer)
            return False
        existing = self.peers.get_by_uid(uid)
        if existing is None or existing is peer:
            return True
        keep_new = peer.outgoing == (self.uid.bytes < uid.bytes)
        if keep_new:
            self.peers.remove(existing)
            self._salvage_unsent(existing)
            existing.close()
            return True
        self._salvage_unsent(peer)
        peer.close()
        self.peers.remove(peer)
        return False

    def _after_peer_established(self, uid: Uid, pk: PublicKey) -> None:
        # late handshake during keygen: ship the transcript so far
        if self.keygen_outbox and self.dhb is None:
            target = self.peers.get_by_uid(uid)
            if target is not None:
                for msg in self.keygen_outbox:
                    target.send(msg)
        if self.dhb is not None:
            # active network: vote the newcomer in (handler.rs:77-88)
            if self.dhb.is_validator and uid.bytes not in self.dhb.netinfo.node_ids:
                self.dhb.vote_to_add(uid.bytes, pk)
            elif uid.bytes in self.dhb.netinfo.node_ids:
                # welcome-back replay: a fellow validator (re)connecting
                # mid-epoch missed whatever we sent before this link
                # existed — a crash/restart or a chaos-plane reset.  Our
                # epoch outbox holds exactly the current epoch's frames;
                # every consensus handler is duplicate-tolerant, so
                # replaying them to the newcomer is unconditionally safe
                # and is what lets a recovered node catch the in-flight
                # epoch instead of stalling until the next fast-forward.
                target = self.peers.get_by_uid(uid)
                if target is not None and self._epoch_outbox:
                    n = 0
                    for _epoch, tgt, msg in list(self._epoch_outbox):
                        if tgt is None or tgt == uid:
                            target.send(msg)
                            n += 1
                    if n:
                        self.metrics.counter("welcome_back_replays").inc()
                        log.info(
                            "%s replayed %d epoch frames to rejoining %s",
                            self.uid, n, uid,
                        )
            return
        if (
            self.state == "awaiting_more_peers"
            and self.peers.count_established() >= self.cfg.keygen_peer_count
        ):
            self._start_bootstrap_keygen()

    # -- bootstrap keygen ----------------------------------------------------

    def _keygen_pub_keys(self) -> Dict[bytes, PublicKey]:
        pub_keys = {self.uid.bytes: self.public_key}
        for p in self.peers.established():
            if p.uid is not None and p.pk is not None:
                pub_keys[p.uid.bytes] = p.pk
        return pub_keys

    def _start_bootstrap_keygen(self) -> None:
        self.state = "generating_keys"
        self.key_gen = KeyGenMachine(("builtin",))
        part = self.key_gen.start(
            self.uid.bytes, self.secret_key, self._keygen_pub_keys(), self.rng
        )
        # announce validator-hood + our part (key_gen.rs:257-271)
        self.peers.wire_to_all(
            wire.hello_from_validator(
                self.uid, self.bind.host, self.bind.port,
                self.public_key, self._net_state(),
            )
        )
        self._broadcast_keygen(
            ("builtin",), ("part", part.commit_bytes, tuple(part.enc_rows))
        )
        # self-handle our own part -> our own ack
        outcome = self.key_gen.handle_part(self.uid.bytes, part)
        if outcome.ack is not None:
            self._broadcast_keygen(
                ("builtin",),
                ("ack", outcome.ack.proposer_idx, tuple(outcome.ack.enc_values)),
            )
            self.key_gen.handle_ack(self.uid.bytes, outcome.ack)
        # replay keygen traffic that beat us here
        pending, self.keygen_inbox = self.keygen_inbox, []
        self._keygen_inbox_seen = set()
        for src, instance_id, payload in pending:
            self._on_key_gen_message(src, instance_id, payload)
        self._maybe_finish_keygen(self.key_gen)

    def _broadcast_keygen(self, instance_id: tuple, payload: tuple) -> None:
        msg = wire.key_gen_message(self.uid, instance_id, payload)
        # the replay transcript is bounded: honest traffic is one part +
        # <= n acks per live instance, far under the cap — only a flood
        # of attacker-spawned instances could reach it
        if len(self.keygen_outbox) < KEYGEN_OUTBOX_CAP:
            self.keygen_outbox.append(msg)
        else:
            log.warning("keygen outbox full; frame not recorded for replay")
        self.peers.wire_to_all(msg)

    def _on_key_gen_message(self, src: bytes, instance_id: tuple, payload) -> None:
        if instance_id == ("builtin",):
            machine = self.key_gen
            if (machine is None or machine.kg is None) and self.dhb is None:
                # peers ahead of us in the handshake dance; replayed when
                # our own machine starts
                entry = (src, instance_id, payload)
                # retry re-broadcasts repeat the transcript every tick:
                # dedup (O(1) via the set mirror) + cap so a stalled
                # bootstrap cannot grow the inbox without bound
                if entry not in self._keygen_inbox_seen:
                    if len(self.keygen_inbox) < KEYGEN_INBOX_CAP:
                        self.keygen_inbox.append(entry)
                        # hblint: disable=attacker-taint -- 1:1 mirror of keygen_inbox; growth is bounded by the same KEYGEN_INBOX_CAP guard above
                        self._keygen_inbox_seen.add(entry)
                    else:
                        log.warning("keygen inbox overflow; dropping frame")
                return
        else:
            machine = self.user_key_gens.get(bytes(instance_id[1]))
            if machine is None and self.dhb is not None:
                # a peer-initiated instance: join it by proposing our own
                # Part (the reference forwards these to the handler which
                # instantiates a machine per InstanceId, handler.rs:523-538)
                machine = KeyGenMachine(tuple(instance_id))
                self._activate_user_keygen(machine)
        if machine is None or machine.kg is None:
            return
        tag = payload[0]
        if tag == "part":
            part = Part(bytes(payload[1]), tuple(bytes(r) for r in payload[2]))
            if self._kg_poll is not None:
                # poll-level aggregation: defer to _flush_kg_poll so all
                # parts of this poll verify as one batched MSM; an ack
                # racing its part within the same poll already parks in
                # KeyGenMachine.pending_acks and drains at flush
                # hblint: disable=attacker-taint -- poll-scoped buffer: reset to [] by the handler loop every poll, so growth is bounded by the 50-message poll budget
                self._kg_poll.append((machine, tuple(instance_id), src, part))
                return
            outcome = machine.handle_part(src, part)
            self._emit_part_outcome(machine, tuple(instance_id), src, outcome)
        elif tag == "ack":
            ack = Ack(int(payload[1]), tuple(bytes(v) for v in payload[2]))
            outcome = machine.handle_ack(src, ack)
            if not outcome.valid:
                log.warning("keygen ack fault from %s: %s", src.hex()[:8], outcome.fault)
        self._maybe_finish_keygen(machine)

    def _emit_part_outcome(
        self, machine: KeyGenMachine, instance_id: tuple, src: bytes, outcome
    ) -> None:
        """Broadcast/self-handle the ack a handled part produced (or log
        its fault) — shared by the inline path and the poll flush."""
        if outcome.valid and outcome.ack is not None:
            self._broadcast_keygen(
                instance_id,
                ("ack", outcome.ack.proposer_idx, tuple(outcome.ack.enc_values)),
            )
            machine.handle_ack(self.uid.bytes, outcome.ack)
        elif not outcome.valid:
            log.warning(
                "keygen part fault from %s: %s", src.hex()[:8], outcome.fault
            )

    def _flush_kg_poll(self) -> None:
        """Flush the poll's deferred keygen parts per machine: one
        SyncKeyGen.handle_parts call batches every row RLC check into a
        single MSM and seals all resulting ack values through the
        batched channel plane.

        Double-buffered (hbasync): this poll's MSMs are SUBMITTED
        first, then the PREVIOUS poll's flushes — their device work
        having overlapped an entire handler poll of host work — settle
        and emit their acks.  When the handler queue is empty the new
        submissions settle immediately too: with no next poll imminent,
        holding them would stall the DKG (peers wait on our acks)."""
        buf = self._kg_poll
        from ..crypto import futures as _futures

        submitted: List[tuple] = []
        if buf:
            grouped: Dict[int, tuple] = {}
            for machine, instance_id, src, part in buf:
                grouped.setdefault(id(machine), (machine, instance_id, []))[
                    2
                ].append((src, part))
            use_async = _futures.enabled()
            for machine, instance_id, items in grouped.values():
                try:
                    if use_async:
                        settle = machine.handle_parts_submit(items)
                    else:
                        outcomes = machine.handle_parts(items)
                        settle = lambda _o=outcomes: _o  # noqa: E731
                except Exception:
                    log.exception("keygen poll batch failed")
                    continue
                submitted.append((machine, instance_id, items, settle))
        # settle the previous poll's in-flight flushes AFTER submitting
        # this poll's — submission order is effect order either way
        prev, self._kg_prev = self._kg_prev, []
        for entry in prev:
            self._settle_kg_flush(entry)
        if submitted and _futures.enabled() and not self._internal.empty():
            # more traffic already queued: hold this poll's flushes in
            # flight across the next poll's host work
            self._kg_prev = submitted
        else:
            for entry in submitted:
                self._settle_kg_flush(entry)

    def _settle_kg_flush(self, entry: tuple) -> None:
        """Fetch one submitted flush's verdicts and emit its acks."""
        machine, instance_id, items, settle = entry
        try:
            outcomes = settle()
        except Exception:
            log.exception("keygen poll batch failed")
            return
        for (src, _part), outcome in zip(items, outcomes):
            # per-item guard, the old inline path's granularity: an
            # emission error (e.g. a dying transport) must not
            # abandon the REMAINING acks — a replayed part hits the
            # duplicate path (ack=None), so a dropped ack would
            # never regenerate
            try:
                self._emit_part_outcome(machine, instance_id, src, outcome)
            except Exception:
                log.exception(
                    "keygen ack emit failed for %s", src.hex()[:8]
                )
        self._maybe_finish_keygen(machine)

    def _maybe_finish_keygen(self, machine: KeyGenMachine) -> None:
        if machine is None or not machine.is_complete():
            return
        if machine.state == "complete":
            # already generated: with hbasync a deferred poll-flush
            # settle can revisit a machine an inline ack completed —
            # re-generating would rebuild self.dhb and wipe its history
            return
        pk_set, sk_share = machine.generate()
        if machine.instance_id == ("builtin",):
            node_ids = sorted(machine.kg.pub_keys.keys())
            netinfo = NetworkInfo(self.uid.bytes, node_ids, pk_set, sk_share)
            self.dhb = self._wrap_dhb(DynamicHoneyBadger(
                self.uid.bytes,
                self.secret_key,
                netinfo,
                dict(machine.kg.pub_keys),
                era=self.cfg.start_epoch,
                session_id=b"net",
                encrypt=self.cfg.encrypt,
                coin_mode=self.cfg.coin_mode,
                verify_shares=self.cfg.verify_shares,
                rng=self.rng,
                engine=self.cfg.engine,
                recorder=self.obs,
                rbc_variant=self.rbc_variant,
            ))
            self.key_gen = None
            # keep the outbox: stragglers behind a healing link still need
            # the transcript (served on their net_state_request gossip)
            self.state = "validator"
            # start the replay clock at consensus birth, not node
            # construction — the bootstrap DKG interval must not seed
            # the epoch-duration EMA (it would inflate the stall
            # threshold by minutes exactly when replay matters most)
            self._last_progress_t = self._now()
            log.info("%s validator: era %d, %d nodes", self.uid,
                     self.cfg.start_epoch, len(node_ids))
            # replay messages that arrived during keygen (state.rs:473-514)
            pending, self.iom_queue = self.iom_queue, []
            for src, payload in pending:
                self._on_consensus_message(src, payload)
        else:
            machine.event_queue.put_nowait(("complete", pk_set, sk_share))

    def _start_user_keygen(self, machine: KeyGenMachine) -> None:
        if self.dhb is None:
            machine.event_queue.put_nowait(("failed", "network not active"))
            return
        self._activate_user_keygen(machine)

    def _activate_user_keygen(self, machine: KeyGenMachine) -> None:
        """Begin our participation in a user key-gen instance: register,
        propose our Part, broadcast it, and self-handle (key_gen.rs:195-218).
        Used by the initiator (`new_key_gen_instance`) and by every other
        node when the instance's first message arrives (handler.rs:523-538)."""
        instance_id = machine.instance_id
        key = bytes(instance_id[1])
        # any established peer can mint fresh instance ids, and every
        # instance costs a Part broadcast: cap the live set
        if key not in self.user_key_gens and (
            len(self.user_key_gens) >= MAX_USER_KEYGENS
        ):
            log.warning("user keygen cap reached; ignoring new instance")
            machine.event_queue.put_nowait(
                ("failed", "too many live keygen instances")
            )
            return
        self.user_key_gens[key] = machine
        part = machine.start(
            self.uid.bytes, self.secret_key, self._keygen_pub_keys(), self.rng
        )
        self._broadcast_keygen(
            instance_id,
            ("part", part.commit_bytes, tuple(part.enc_rows)),
        )
        outcome = machine.handle_part(self.uid.bytes, part)
        if outcome.ack is not None:
            self._broadcast_keygen(
                instance_id,
                ("ack", outcome.ack.proposer_idx, tuple(outcome.ack.enc_values)),
            )
            machine.handle_ack(self.uid.bytes, outcome.ack)

    # -- consensus plumbing ---------------------------------------------------

    def _become_observer(self, plan: JoinPlan) -> None:
        self.dhb = self._wrap_dhb(DynamicHoneyBadger.from_join_plan(
            self.uid.bytes,
            self.secret_key,
            plan,
            encrypt=self.cfg.encrypt,
            coin_mode=self.cfg.coin_mode,
            verify_shares=self.cfg.verify_shares,
            rng=self.rng,
            engine=self.cfg.engine,
            recorder=self.obs,
            rbc_variant=self.rbc_variant,
        ))
        # chaos-contract observable: a crash/restart that was voted out
        # and re-added recovers through one (or more) of these adoptions
        self.metrics.counter("observer_adoptions").inc()
        self.state = "observer"
        self._last_progress_t = self._now()  # see _maybe_finish_keygen
        log.info("%s observer at era %d epoch %d", self.uid, plan.era, plan.epoch)
        pending, self.iom_queue = self.iom_queue, []
        for src, payload in pending:
            self._on_consensus_message(src, payload)

    def _on_consensus_message(self, src: bytes, payload) -> None:
        if self.dhb is None:
            # bounded pre-consensus buffer: a flood before the DKG
            # completes must not grow host memory; dropped frames heal
            # via the senders' epoch-replay loops
            if len(self.iom_queue) < IOM_QUEUE_CAP:
                self.iom_queue.append((src, payload))
            else:
                log.warning("pre-consensus queue full; dropping frame")
            return
        step = self.dhb.handle_message(src, payload)
        self._dispatch_step(step)

    def _dispatch_step(self, step: Step) -> None:
        if step is None:
            return
        for tm in step.messages:
            msg = wire.consensus_message(self.uid, tm.message)
            if tm.target.kind == "nodes":
                for nid in tm.target.nodes:
                    uid = Uid(bytes(nid))
                    self._epoch_outbox.append((self.current_epoch, uid, msg))
                    if not self.peers.wire_to(uid, msg):
                        self._queue_wire_retry(uid, msg)
            else:
                # all / all_except: broadcast (observers need the traffic
                # too — deliberately mirrors the reference, peer.rs:567).
                # Loss of an in-flight broadcast (socket tie-breaks,
                # reconnects) is covered by the epoch replay loop.
                self._epoch_outbox.append((self.current_epoch, None, msg))
                self.peers.wire_to_all(msg)
        for fault in step.fault_log:
            # mirror the cores' fault entries into the wire-tier ring:
            # the chaos contract attributes them exactly like the sim
            # verifier attributes router.faults (same kind strings)
            self.metrics.counter("consensus_faults").inc()
            self.fault_log.append(
                (str(fault.node_id)[:16], WireFault(fault.kind))
            )
            log.debug("fault: %s %s", str(fault.node_id)[:16], fault.kind)
        for batch in step.output:
            if isinstance(batch, DhbBatch):
                self._on_batch(batch)
        if self.state == "observer" and self.dhb is not None and self.dhb.is_validator:
            self.state = "validator"
            log.info("%s promoted to validator (era %d)", self.uid, self.dhb.era)

    def _flush_user_contributions(self) -> None:
        """Propose the merged pending contributions if the current epoch
        is still open.  Payloads that decode as codec tuples (the txn
        generator's shape) are flattened so transactions merge into one
        tuple; opaque payloads ride as single elements."""
        if (
            not self._pending_user
            or self.dhb is None
            or not self.dhb.is_validator
            or self.dhb.hb.has_input.get(self.dhb.hb.epoch)
        ):
            return
        from ..utils import codec

        elements: List[bytes] = []
        for payload in self._pending_user:
            flat = None
            try:
                items = codec.decode(payload)
                if isinstance(items, tuple) and all(
                    isinstance(x, (bytes, bytearray, memoryview))
                    for x in items
                ):
                    flat = [bytes(x) for x in items]
            except (ValueError, TypeError):
                pass
            # only tuples-of-bytes (the txn generator's shape) flatten;
            # anything else rides opaquely and atomically
            elements.extend(flat if flat is not None else [payload])
        self._pending_user.clear()
        # the flush moment is both admission into a contribution and
        # the proposal itself (DHB has no intermediate queue): stamp
        # both stages here, so submit→admitted carries the
        # _pending_user queueing delay
        for t in elements:
            tid = txn_id(t)
            self.txn_lifecycle.note_stage(tid, STAGE_ADMITTED)
            self.txn_lifecycle.note_stage(tid, STAGE_PROPOSED)
        self.txn_lifecycle.stamp(self.wall_now())
        self._dispatch_step(
            self.dhb.propose(codec.encode(tuple(elements)), self.rng)
        )

    def _note_txn_submit(self, payload: bytes) -> None:
        """Stamp submission PER TXN at enqueue (satellite of the
        latency plane): generator payloads are codec tuples of txns and
        split to individual ids; opaque user payloads ride as one txn.
        A deduplicated resubmission keeps the original's stamp and
        counts separately — re-stamping would erase queueing delay."""
        from ..utils import codec

        txns = None
        try:
            items = codec.decode(payload)
            if isinstance(items, tuple) and all(
                isinstance(x, (bytes, bytearray, memoryview)) for x in items
            ):
                txns = [bytes(x) for x in items]
        except (ValueError, TypeError):
            pass
        now = self.wall_now()
        for t in txns if txns is not None else [payload]:
            if not self.txn_lifecycle.submit(txn_id(t), now):
                self.metrics.counter("txn_resubmitted").inc()

    def _note_txn_commits(self, batch: DhbBatch) -> None:
        """Close lifecycle records for every txn in the committed batch
        (codec-tuple contributions carry per-txn identity; opaque
        payloads close as single txns), mirror lifecycle counts and the
        txn_latency_* percentile gauges from this node's e2e sketch,
        and evaluate the installed SLO — a burn-rate violation is a
        fault-ring entry, not a log line."""
        from ..utils import codec

        lc = self.txn_lifecycle
        for payload in batch.contributions.values():
            txns = None
            try:
                items = codec.decode(bytes(payload))
                if isinstance(items, tuple) and all(
                    isinstance(x, (bytes, bytearray, memoryview))
                    for x in items
                ):
                    txns = [bytes(x) for x in items]
            except (ValueError, TypeError):
                pass  # opaque payload: closes as a single txn below
            for t in txns if txns is not None else [bytes(payload)]:
                lc.note_stage(txn_id(t), STAGE_COMMITTED)
        before = len(lc.samples)
        lc.stamp(self.wall_now())
        # lifetime values mirrored with set, not inc: the lifecycle
        # holds the cumulative truth (the meter_bytes idiom)
        self.metrics.counter("txn_submitted").value = lc.submitted
        self.metrics.counter("txn_committed").value = lc.committed_count
        e2e_sketch = lc.sketches["e2e"]
        if e2e_sketch.count:
            p = e2e_sketch.percentiles()
            self.metrics.gauge("txn_latency_p50_s").track(round(p["p50"], 6))
            self.metrics.gauge("txn_latency_p90_s").track(round(p["p90"], 6))
            self.metrics.gauge("txn_latency_p99_s").track(round(p["p99"], 6))
            self.metrics.gauge("txn_latency_p999_s").track(
                round(p["p999"], 6)
            )
        if self._slo_tracker is not None:
            for v in lc.samples[before:]:
                self._slo_tracker.observe(v)
            msg = self._slo_tracker.check()
            if msg is not None:
                self._note_fault(msg, "slo_violations")

    def _on_batch(self, batch: DhbBatch) -> None:
        if self.keygen_outbox and self.dhb.era != self.cfg.start_epoch:
            # past the bootstrap era: no straggler can use the transcript
            self.keygen_outbox = []
        # Prune CONCLUDED epochs' frames from the replay outbox (they
        # are safe but not free: every replayed frame costs a signature
        # verify at each receiver, and a long run death-spirals on
        # exactly that).  Entries are epoch-tagged at send time and the
        # deque is append-ordered, so a front-pop sweep suffices; the
        # current epoch's (and pipelined successors') frames stay.
        while self._epoch_outbox and self._epoch_outbox[0][0] < batch.epoch:
            self._epoch_outbox.popleft()
        now = self._now()
        raw_dt = now - self._last_progress_t
        dt = min(raw_dt, 60.0)
        # committed-epoch gap across the era-switch window (a live shadow
        # keygen or the flip itself) — the TCP mirror of the sim's
        # era_commit_gap_s gauge — plus the loud-stall mirror
        kg_live = getattr(self.dhb, "key_gen", None) is not None
        prev_era = getattr(self, "_last_batch_era", None)
        if kg_live or (prev_era is not None and batch.era != prev_era):
            self.metrics.gauge("era_commit_gap_s").track(round(raw_dt, 3))
        self._last_batch_era = batch.era
        stall_fn = getattr(self.dhb, "shadow_stall_epochs", None)
        if stall_fn is not None:
            self.metrics.gauge("shadow_dkg_stall_epochs").track(stall_fn())
        # Clamp so a single slow epoch cannot push the stall threshold
        # beyond ~minutes.  Replayed intervals fold at REDUCED weight
        # instead of being skipped: with a full skip, a
        # threshold latched below the true epoch duration (fast warm-up
        # epochs, then slow full-crypto ones) made EVERY sample a
        # replayed one, so the EMA could never adapt upward out of the
        # one-replay-burst-per-epoch state.  The replayed sample is
        # additionally capped at a small multiple of the CURRENT
        # estimate: un-latching only needs the EMA to be able to GROW
        # toward a true duration above it — absorbing the full stall
        # length would re-inflate the threshold and delay the next
        # genuine recovery (the original death-spiral ingredient).
        prev = self._epoch_ema_s
        if self._replayed_since_progress:
            # the cap also applies to an UNSEEDED ema (prev None, e.g. a
            # node booting into a wedged network): seeding with the full
            # stall length would start the threshold at minutes
            dt = min(dt, 4.0 * max(prev or 0.0, EPOCH_REPLAY_TICK_S))
            w = 0.15
        else:
            w = 0.3
        self._epoch_ema_s = dt if prev is None else (1.0 - w) * prev + w * dt
        self._last_progress_t = now
        self._replay_backoff = 1.0
        self._replayed_since_progress = False
        self.metrics.counter("epochs_committed").inc()
        # the UNCLAMPED duration: the 60 s clamp protects the stall-EMA
        # above, but feeding it here would erase the tail the histogram
        # exists to show.  The histogram's sketch twin keeps the real
        # p99 a real number at any magnitude.
        self.metrics.histogram("epoch_duration_s").observe(raw_dt)
        self._note_txn_commits(batch)
        self.obs.instant(
            "epoch_commit",
            epoch=batch.epoch,
            era=batch.era,
            contributions=len(batch.contributions),
        )
        # (The outbox is pruned, NOT cleared: the same Step that commits
        # epoch e already recorded our first epoch-e+1 frames — tagged e
        # at dispatch time, so the `< batch.epoch` sweep keeps them for
        # stall replay.)
        # hblint: disable=attacker-taint -- epoch-paced (one entry per COMMITTED epoch, not per frame); retention of the batch history is the application's call
        self.batches.append(batch)
        self._flush_user_contributions()  # the next epoch just opened
        self.current_epoch = batch.epoch + 1
        # hblint: disable=attacker-taint -- epoch-paced public-API queue; the application consumer owns drain pacing (register via batch_queue)
        self.batch_queue.put_nowait(batch)
        # durable-checkpoint cadence: epoch-stamped, so a SIGKILL at any
        # instant restarts at most checkpoint_every epochs stale
        if (
            self._ckpt_store is not None
            and batch.epoch % max(1, self.cfg.checkpoint_every) == 0
        ):
            self._persist_checkpoint()
        if batch.join_plan is not None:
            self.peers.wire_to_all(
                WireMessage("join_plan", batch.join_plan.wire())
            )
        for q in self.epoch_listeners:
            q.put_nowait(self.current_epoch)

    def _on_join_plan(self, payload) -> None:
        """Adopt a JoinPlan (batch.join_plan broadcast, handler.rs:692-696).

        Beyond the reference: an OBSERVER whose era is behind the plan's
        re-adopts the newer snapshot.  Era switches can outrun a joiner —
        the cluster commits the add-vote and moves to era N+1 while the
        joiner still digests an era-N plan; the pre-switch epochs it
        would need to follow the switch are no longer being served, so
        without the jump it is stranded forever (the reference documents
        this class of join race as fatal, README.md:44-50).  Every batch
        carries a fresh plan, so a stranded observer heals on the next
        batch broadcast.  Validators never re-adopt: they ARE part of
        the consensus that mints plans."""
        if self.dhb is None:
            self._become_observer(JoinPlan.from_wire(payload))
            self._maybe_recover_share()
            return
        if not self.dhb.is_validator:
            plan = JoinPlan.from_wire(payload)
            if plan.era > self.dhb.era:
                log.info(
                    "%s observer stranded at era %d; jumping to era %d",
                    self.uid,
                    self.dhb.era,
                    plan.era,
                )
                self._become_observer(plan)
            self._maybe_recover_share()

    def _maybe_recover_share(self) -> None:
        """If we are a committed member of the current era's validator set
        but hold no secret share (the era switch out-ran us and we missed
        the live DKG), start requesting the committed transcript."""
        d = self.dhb
        if (
            d is None
            or d.netinfo.sk_share is not None
            or self.uid.bytes not in d.netinfo.node_ids
        ):
            return
        if self._share_recovery_task is None or self._share_recovery_task.done():
            self._share_recovery_task = asyncio.create_task(
                self._share_recovery_loop(d.era)
            )
            self._tasks.append(self._share_recovery_task)

    async def _share_recovery_loop(self, era: int) -> None:
        delay = 0.5
        rr = 0
        while True:
            d = self.dhb
            if (
                d is None
                or d.era != era
                or d.netinfo.sk_share is not None
                or self.uid.bytes not in d.netinfo.node_ids
            ):
                return
            # one peer per tick (round-robin): every eligible validator
            # holds the same transcript, n redundant multi-MB replies
            # per tick would be pure waste
            established = list(self.peers.established())
            if established:
                established[rr % len(established)].send(
                    WireMessage("era_transcript_request", int(era))
                )
                rr += 1
            await asyncio.sleep(delay)
            delay = min(delay * 1.5, 8.0)

    def _on_era_transcript(self, payload) -> None:
        d = self.dhb
        if d is None or d.netinfo.sk_share is not None:
            return
        # Transcript replay is O(n^2) crypto: rate-limit PROCESSING
        # (mirroring the 3 s serve cooldown) and cap the accepted entry
        # count by what this era's DKG could legitimately produce —
        # without this, any established peer could burn our CPU with
        # repeated forged transcripts while we are stranded.
        try:
            era, kg_era, entries = payload
            era, kg_era = int(era), int(kg_era)
        except (ValueError, TypeError):
            return
        if era != d.era:
            return
        n = len(d.netinfo.node_ids)
        # n parts + n^2 acks + batch-boundary markers; markers are
        # bounded by TRAFFIC-BEARING BATCHES (worst case one message per
        # batch, i.e. up to n + n^2 of them), so the honest ceiling is
        # 2(n + n^2) — an honest transcript must never trip the cap or
        # the stranded joiner it exists to heal stays stranded
        if len(entries) > 2 * n * (n + 1):
            return
        # rate-limit only the EXPENSIVE replay, and only after the cheap
        # structural checks — a peer spamming trivially-invalid frames
        # must not be able to renew the window and starve the genuine
        # transcript forever.  Node clock (_now): injected skew must
        # reach the processing cooldown like the serve cooldown; None
        # sentinel for the same negative-skew reason as the serve side.
        now = self._now()
        last = self._last_transcript_attempt
        if last is not None and now - last < 3.0:
            return
        self._last_transcript_attempt = now
        if d.install_share_from_transcript(entries, kg_era):
            self.state = "validator"
            log.info(
                "%s recovered era-%d secret share from committed transcript; "
                "promoted to validator",
                self.uid,
                d.era,
            )

    def _on_disconnect(self, peer: Peer) -> None:
        if peer.state == "established":
            # the observable for injected connection resets (and real
            # link failures): a torn-down authenticated connection
            self.metrics.counter("peer_disconnects").inc()
        self.peers.remove(peer)
        self._salvage_unsent(peer)
        peer.close()
        if peer.uid is not None:
            self._ff_claims.pop(peer.uid.bytes, None)
        if (
            peer.uid is not None
            and self.dhb is not None
            and self.dhb.is_validator
            and peer.uid.bytes in self.dhb.netinfo.node_ids
            and not self._stopped.is_set()
        ):
            # re-dial a fellow validator whose link died: a connection
            # reset (chaos plane, NAT flap, crash) is otherwise healed
            # only by the next discovery gossip, which a healthy
            # network never sends.  Both ends re-dialling is fine —
            # _resolve_duplicate tie-breaks, exactly the path this
            # exercises; a really-dead peer costs one bounded-backoff
            # dial task.
            if peer.in_addr is not None:
                self._tasks.append(
                    asyncio.create_task(
                        self._connect_outgoing(
                            OutAddr(peer.in_addr.host, peer.in_addr.port)
                        )
                    )
                )
            # vote the dead validator out (handler.rs:397-426) — after a
            # grace window: votes are remembered per voter, so voting on
            # EVERY transient reset would let independent blips
            # accumulate into a committed removal of a live validator
            self._tasks.append(
                asyncio.create_task(self._vote_remove_later(peer.uid))
            )

    async def _vote_remove_later(self, uid: Uid) -> None:
        await asyncio.sleep(REMOVE_VOTE_GRACE_S)
        if self._stopped.is_set():
            return
        p = self.peers.get_by_uid(uid)
        if p is not None and p.state == "established":
            return  # the peer came back: a blip, not a death
        if (
            self.dhb is not None
            and self.dhb.is_validator
            and uid.bytes in self.dhb.netinfo.node_ids
        ):
            self.dhb.vote_to_remove(uid.bytes)

    def _salvage_unsent(self, peer: Peer) -> None:
        """Re-park frames still queued on a dying connection into the
        wire-retry queue (frames the pump never flushed would otherwise
        vanish in a tie-break/disconnect — reliable-delivery hole)."""
        if peer.uid is None:
            return
        for msg in peer.drain_unsent():
            self._queue_wire_retry(peer.uid, msg)

    def _retry_key(self, uid: Uid, msg: WireMessage):
        """Stable identity of one targeted frame for the cumulative
        attempt ledger.  Targeted retries are consensus frames (tuples
        of bytes/ints — hashable); anything unhashable falls back to
        per-cycle accounting only."""
        try:
            key = (uid.bytes, msg)
            hash(key)
            return key
        except TypeError:
            return None

    def _abandon_retry(self, uid: Uid, msg: WireMessage, quiet: bool = False) -> None:
        """Per-frame retry budget exhausted: drop LOUDLY — counter +
        fault ring entry (the chaos contract's declared observable for
        link faults that outlive every retry) + warning.  ``quiet``
        marks a refused RE-park of an already-abandoned frame (epoch
        replay re-offering it every stall tick): counted and ringed the
        same, logged at debug so the warning stream stays readable."""
        # keep the exhausted entry: a re-park of the same frame (epoch
        # replay, another salvage cycle) is refused outright while the
        # ledger remembers it; LRU eviction eventually grants a fresh
        # budget, so a much-later legitimate resend is not starved
        self._note_attempts(self._retry_key(uid, msg), WIRE_RETRY_CAP)
        self._note_fault("wire: retry abandoned", "wire_retry_abandoned")
        # legacy name, kept incrementing so existing soak/bench row
        # consumers see the same signal under the old spelling too
        self.metrics.counter("wire_retry_dropped").inc()
        (log.debug if quiet else log.warning)(
            "abandoning targeted frame to %s after %d attempts",
            uid,
            WIRE_RETRY_CAP,
        )

    def _queue_wire_retry(self, uid: Uid, msg: WireMessage) -> None:
        """Park an undeliverable targeted frame for the retry tick
        (handler.rs:660-670 semantics; bounded, oldest dropped first).

        Attempts are CUMULATIVE across salvage cycles: a frame salvaged
        off a dying connection re-enters here with its prior attempt
        count intact (the `_retry_attempts` ledger), so a peer that
        never returns cannot cycle one frame through
        salvage -> retry -> salvage forever — after WIRE_RETRY_CAP total
        attempts it is abandoned loudly instead."""
        key = self._retry_key(uid, msg)
        attempts = 0
        if key is not None:
            attempts = self._retry_attempts.get(key, 0)
            if attempts >= WIRE_RETRY_CAP:
                self._abandon_retry(uid, msg, quiet=True)
                return
            # bounded ledger: oldest tracked frames evict beyond the
            # queue's own ceiling (they lose cross-cycle memory only)
            self._note_attempts(key, attempts)
        if len(self._wire_retry) >= WIRE_RETRY_MAX_QUEUE:
            self._wire_retry.popleft()
        self._wire_retry.append((uid, msg, attempts))

    def _note_attempts(self, key, attempts: int) -> None:
        if key is None:
            return
        self._retry_attempts[key] = attempts
        self._retry_attempts.move_to_end(key)
        while len(self._retry_attempts) > WIRE_RETRY_MAX_QUEUE:
            self._retry_attempts.popitem(last=False)

    def _wire_retry_tick(self) -> None:
        """One drain of the retry queue (factored from the loop so the
        attempt-budget schedule is unit-testable without sockets).

        Only FAILED deliveries charge the cumulative budget: a frame
        repeatedly salvaged off flapping-but-returning links keeps
        getting re-offered (each salvage cycle proves the peer came
        back), while a frame whose every attempt finds no established
        peer burns through WIRE_RETRY_CAP and is abandoned loudly."""
        pending, self._wire_retry = self._wire_retry, deque()
        for uid, msg, attempts in pending:
            if self.peers.wire_to(uid, msg):
                # handed to an established peer's pump; if THAT
                # connection dies pre-flush, salvage re-parks the frame
                # with its failed-attempt count intact (the ledger)
                continue
            attempts += 1
            key = self._retry_key(uid, msg)
            if attempts < WIRE_RETRY_CAP:
                self._note_attempts(key, attempts)
                self._wire_retry.append((uid, msg, attempts))
            else:
                self._abandon_retry(uid, msg)

    def _cull_stalled_handshakes(self) -> None:
        """Abort connections wedged in "handshaking" past the timeout.

        Hello/welcome frames are sent exactly once; a lossy link that
        eats one leaves the connection parking
        verified frames forever while both ends believe it is merely
        slow.  Aborting errors both pumps; outgoing links re-dial
        (their out_addr IS the remote's listener), incoming ones are
        re-dialled by the remote's own cull.

        Node clock on BOTH sides of the age subtraction: ``peer.born``
        is stamped from this node's ``_now()`` at construction, so the
        handshake-stall timer lives in one clock domain and injected
        skew/drift genuinely reaches it."""
        now = self._now()
        for peer in list(self.peers.by_addr.values()):
            if (
                peer.state != "handshaking"
                or now - peer.born < HANDSHAKE_TIMEOUT_S
            ):
                continue
            self.metrics.counter("handshake_timeouts").inc()
            log.warning(
                "culling connection to %s: handshake stalled %.1fs",
                peer.out_addr,
                now - peer.born,
            )
            peer.abort()
            if peer.outgoing and not self._stopped.is_set():
                self._tasks.append(
                    asyncio.create_task(
                        self._connect_outgoing(peer.out_addr)
                    )
                )

    async def _wire_retry_loop(self) -> None:
        """Re-attempt targeted frames to not-yet/re-connected peers.

        The reference drains its SegQueue of (target, message, retries)
        each handler poll and re-queues failures up to 10 attempts
        (handler.rs:660-670, peer.rs:581-600, cap mod.rs:17); here a
        timed tick drains ours so a link flap mid-epoch does not lose
        RBC shards the protocol assumes delivered.  The tick doubles as
        the handshake-stall sweep."""
        while True:
            await asyncio.sleep(WIRE_RETRY_TICK_S)
            self._cull_stalled_handshakes()
            # prune completed dial/grace-vote tasks: every disconnect
            # spawns a couple, and only _discover used to sweep them —
            # rare in steady state, so a long chaos run would otherwise
            # retain thousands of finished task objects
            if any(t.done() for t in self._tasks):
                self._tasks = [t for t in self._tasks if not t.done()]
            if self._wire_retry:
                self._wire_retry_tick()

    def _replay_due(self, now: float) -> bool:
        """The replay-pacing gate, factored out of the loop so the
        backoff schedule is unit-testable against a synthetic clock.

        Adaptive stall threshold: "stalled" means
        no progress for clearly longer than this node's own recent
        epoch duration — a fixed 1 s threshold misfires on every
        full-crypto epoch and the replay traffic itself (a signature
        verify per frame per receiver) then starves consensus.

        Back off on time since the LAST REPLAY, not since last
        progress: with a gate on the latter, once a genuinely wedged epoch
        stalled past backoff_cap x threshold the elapsed-since-progress
        term exceeded it on every tick and the node reverted to one
        full outbox replay per second — the flood the backoff was meant
        to bound.  Inter-replay spacing doubles up to 16x regardless of
        stall age; suppressed ticks are counted so a flood held back by
        the gate is still observable (``epoch_replays_suppressed``).

        Capped: once a stall is declared, the backed-off inter-replay
        spacing clamps to a jittered REPLAY_GAP_CEILING_S, so
        compounded resets + backoff can never hold consecutive replays
        minutes apart.  The stall THRESHOLD itself stays EMA-honest and
        uncapped — see the inline note.  Worst-case inter-replay gap is
        1.2x the ceiling.

        Returns True — and advances the backoff state — when a replay
        should fire now."""
        ema = self._epoch_ema_s or EPOCH_REPLAY_TICK_S
        # The stall threshold stays EMA-honest and UNCAPPED: it answers
        # "is this epoch stalled at all", and a 60 s full-crypto epoch
        # genuinely is not stalled at 20 s — capping it here would
        # re-create the misfire of replays flooding every healthy long
        # epoch.  Only the INTER-REPLAY spacing clamps to the jittered
        # ceiling: once a stall is declared, compounded backoff can
        # never hold consecutive replays more than ~1.2x the ceiling
        # apart.
        threshold = max(3.0 * ema, 2.0 * EPOCH_REPLAY_TICK_S)
        if now - self._last_progress_t < threshold:
            return False
        ceiling = REPLAY_GAP_CEILING_S * (0.8 + 0.4 * self.rng.random())
        spacing = min(threshold * self._replay_backoff, ceiling)
        if now - self._last_replay_t < spacing:
            self.metrics.counter("epoch_replays_suppressed").inc()
            return False
        self._replay_backoff = min(self._replay_backoff * 2.0, 16.0)
        self._last_replay_t = now
        self._replayed_since_progress = True
        self.metrics.counter("epoch_replays").inc()
        return True

    async def _epoch_replay_loop(self) -> None:
        """Liveness net for in-flight frame loss: a frame can die in a
        closed socket's buffers on EITHER side of a duplicate-connection
        tie-break or reconnect — invisible to sender-side salvage — and
        HBBFT assumes reliable delivery, so one lost Conf or coin share
        stalls the epoch forever.  If no batch commits for a whole tick,
        re-broadcast the epoch's outbound frames; every consensus
        handler (RBC/ABA/coin/decrypt) ignores duplicates, so replay is
        unconditionally safe."""
        while True:
            await asyncio.sleep(EPOCH_REPLAY_TICK_S)
            if self.dhb is None or not self._epoch_outbox:
                continue
            if len(self.batches) != self._last_progress_batches:
                self._last_progress_batches = len(self.batches)
                continue
            if not self._replay_due(self._now()):
                continue
            frames = list(self._epoch_outbox)
            log.debug(
                "%s epoch stalled %.1fs (ema %.1fs): replaying %d frames",
                self.uid,
                self._now() - self._last_progress_t,
                self._epoch_ema_s or EPOCH_REPLAY_TICK_S,
                len(frames),
            )
            for _epoch, target, msg in frames:
                if target is None:
                    self.peers.wire_to_all(msg)
                elif not self.peers.wire_to(target, msg):
                    self._queue_wire_retry(target, msg)
            # stall watchdog: a wedged node may be BEHIND, not just
            # unlucky — gossip for frontier claims so the certified
            # fast-forward (crash/restart recovery) can trigger.  The
            # replies also re-teach us any peers we lost.
            self.peers.wire_to_all(WireMessage("net_state_request", None))

    async def _keepalive_loop(self) -> None:
        """Periodic ping to every established peer (wire `ping`/`pong`).

        HBBFT itself is message-driven, so a fully-idle network sends
        nothing — and a silently-dead TCP link then goes unnoticed until
        the next consensus frame times out into the retry path.  The
        ping forces traffic through each socket so the pump/reader tasks
        observe breakage promptly; the pong reply needs no handling
        beyond its dispatch arm."""
        while True:
            await asyncio.sleep(KEEPALIVE_TICK_S)
            self.peers.wire_to_all(wire.ping())

    async def _keygen_retry_loop(self) -> None:
        """Bootstrap liveness: gossip + re-broadcast until DKG completes.

        Two races can strand a booting network forever without retries:
        (a) discovery only rides handshakes, so a node that dialled
        before a mutual peer existed never learns about it — periodic
        net_state_request gossip closes the gap (the reference re-gossips
        NetworkState on its own retry ticks, handler.rs:319-395);
        (b) duplicate connections being tie-broken can drop a Part/Ack
        queued on the losing socket, stalling the n^2 ack gate — the
        reference survives this with its wire retry queue
        (handler.rs:660-670).  SyncKeyGen is duplicate-tolerant, so
        periodic replay is safe and restores liveness."""
        delay = 1.5
        while self.dhb is None:
            await asyncio.sleep(delay)
            delay = min(delay * 1.5, 12.0)  # back off: retries are a
            # liveness net, not the primary delivery path
            if self.dhb is not None:
                return  # consensus is live; dhb never goes back to None
            self.peers.wire_to_all(WireMessage("net_state_request", None))
            for msg in self.keygen_outbox:
                self.peers.wire_to_all(msg)

    # -- workload generator (hydrabadger.rs:431-476) -------------------------

    async def _generator_loop(self) -> None:
        while not self._stopped.is_set():
            await asyncio.sleep(self.cfg.txn_gen_interval_ms / 1000)
            if self.cfg.output_extra_delay_ms:
                await asyncio.sleep(self.cfg.output_extra_delay_ms / 1000)
            if self.is_validator() and self._gen_txns is not None:
                txns = self._gen_txns(
                    self.cfg.txn_gen_count, self.cfg.txn_gen_bytes
                )
                from ..utils import codec

                self._internal_put(
                    ("api_propose", codec.encode(tuple(txns)))
                )
