"""DynamicHoneyBadger: HoneyBadger with a dynamic validator set.

The port's copy of hydrabadger_tpu/consensus/dynamic_honey_badger.py,
hbbft's `dynamic_honey_badger` equivalent: the same messages, committed
payload bytes, faults and era switches.  Capabilities:

  - `vote_for(change)` — signed Add/Remove votes ride inside contributions
    and are tallied once *committed*, so every node sees the same tally.
  - key generation by consensus: once a change wins a majority, a
    SyncKeyGen session for the new validator set runs with its Part/Ack
    messages embedded in committed contributions — totally ordered, so
    all nodes step the DKG identically.  A node being added participates
    passively: its rows/values are decryptable from the committed
    transcript, so it derives its share without sending anything.
  - eras: when the committed DKG transcript is ready, everyone switches
    to a fresh HoneyBadger over the new `NetworkInfo` at the same epoch;
    `Batch.change` reports `InProgress` / `Complete`.
  - join plans: batches at change-commit points carry a `JoinPlan` enough
    for a fresh node to come up as an *observer*; it is promoted when a
    later committed change includes it.
  - shadow DKG scheduling: parts are recorded structurally at commit and
    their row crypto drains at a per-epoch budget; the era flips at the
    committed batch where more than f validators' cutover markers stand.

Sender attribution for votes / DKG messages comes from the ACS slot of
the contribution that carried them (each slot is bound to its proposer by
Broadcast), plus an explicit signature on votes so they cannot be forged
by a relaying proposer.

The native ACS core (sim/native_acs) drives an epoch through
`external_contribution` and `apply_external_batch`.  Of the checkpoint
pickling hooks only `__getstate__` is kept (it settles the in-flight keygen
flush); the JAX `__setstate__` filled in fields that older JAX snapshots
lacked, and the port loads no JAX snapshot.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Hashable, List, Optional, Tuple, TypeVar

from ..crypto.dkg import (
    Ack,
    Part,
    SyncKeyGen,
    shadow_budget as _shadow_budget,
    shadow_scheduling as _shadow_scheduling,
    shadow_stall_after as _shadow_stall_after,
)
from ..crypto.threshold import PublicKey, PublicKeySet, SecretKey
from ..obs.recorder import resolve as _resolve_recorder
from ..utils import codec
from .honey_badger import Batch, HoneyBadger
from .types import NetworkInfo, Step, dkg_degree, guarded_handler

N = TypeVar("N", bound=Hashable)

MSG = "dhb"


def _as_bytes(v) -> bytes:
    """bytes() on attacker-controlled values must never hit the int
    overload (bytes(2**31) allocates 2 GB from a 10-byte frame)."""
    if isinstance(v, (bytes, bytearray, memoryview)):
        return bytes(v)
    raise ValueError("expected a bytes-like value")


def _freeze(value):
    """Hashable canonical form of nested tuples/bytes for dedup matching."""
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    if isinstance(value, (bytes, bytearray, memoryview)):
        return bytes(value)
    return value


# -- changes ----------------------------------------------------------------


def change_add(node_id, pub_key: PublicKey) -> tuple:
    return ("add", node_id, pub_key.to_bytes())


def change_remove(node_id) -> tuple:
    return ("remove", node_id)


@dataclass(frozen=True)
class JoinPlan:
    era: int
    epoch: int  # first epoch the observer will see
    node_ids: tuple
    pub_keys: dict  # node_id -> pk bytes (all known nodes)
    pk_set_bytes: bytes
    session_id: bytes

    def wire(self) -> tuple:
        return (
            self.era,
            self.epoch,
            tuple(self.node_ids),
            {k: v for k, v in sorted(self.pub_keys.items())},
            self.pk_set_bytes,
            self.session_id,
        )

    @classmethod
    def from_wire(cls, w) -> "JoinPlan":
        era, epoch, node_ids, pub_keys, pk_set_bytes, session_id = w
        return cls(
            int(era),
            int(epoch),
            tuple(node_ids),
            dict(pub_keys),
            bytes(pk_set_bytes),
            bytes(session_id),
        )


@dataclass(frozen=True)
class DhbBatch:
    """An epoch's output: contributions + membership-change progress."""

    epoch: int
    era: int
    contributions: dict  # proposer -> user payload bytes
    change: Optional[tuple] = None  # ("in_progress"|"complete", change)
    join_plan: Optional[JoinPlan] = None


@dataclass
class _KeyGenState:
    change: tuple
    new_ids: list
    new_pub_keys: dict
    key_gen: SyncKeyGen
    # committed keygen messages in commit order — the public transcript a
    # stranded joiner replays to derive its secret share (era_transcript)
    transcript: list = dataclasses.field(default_factory=list)
    # -- shadow-DKG cutover state ------------------------------------------
    # committed (proposer, Part) pairs whose row settlement is still owed;
    # drained by the per-epoch shadow budget.  Plain committed data.
    shadow_queue: list = dataclasses.field(default_factory=list)
    # the structural era-switch gate crossed: the committed transcript is
    # SEALED here — later part/ack traffic is ignored (exactly what the
    # legacy flip-at-ready discarded), so generate() over the sealed
    # state is deterministic no matter how many epochs the cutover takes
    sealed: bool = False
    ready_epoch: Optional[int] = None
    # distinct current-era validators whose committed ("cutover", era)
    # marker we have seen; the era flips when > f of them exist
    cutover_votes: set = dataclasses.field(default_factory=set)
    # deep-frozen (proposer, msg) pairs already committed this era —
    # validators retransmit their whole pending_kg backlog until they see
    # it committed, so late keygen epochs would otherwise re-reconstruct,
    # re-transcript and re-handle the same acks thousands of times (the
    # era-age slowdown at scale); O(1) membership here caps the transcript
    # at unique messages and makes duplicate commits free
    committed_seen: set = dataclasses.field(default_factory=set)
    cutover_sent: bool = False
    # pre-generated (pk_set, sk_share) once sealed + fully settled, so
    # the cutover batch installs the new era in O(1) crypto
    gen_cache: Optional[tuple] = None
    # stall detector: fingerprint of the committed DKG state and the
    # epoch it last advanced
    progress_sig: Optional[tuple] = None
    progress_epoch: int = 0


class DynamicHoneyBadger:
    def __init__(
        self,
        our_id,
        our_sk: SecretKey,
        netinfo: NetworkInfo,
        pub_keys: Dict,
        era: int = 0,
        epoch: Optional[int] = None,
        session_id: bytes = b"dhb",
        encrypt: bool = True,
        coin_mode: str = "threshold",
        verify_shares: bool = True,
        rng=None,
        engine=None,
        recorder=None,
        rbc_variant=None,
    ):
        self.our_id = our_id
        self.our_sk = our_sk
        self.netinfo = netinfo
        self.pub_keys = dict(pub_keys)  # all known nodes incl. observers
        self.era = era
        self.epoch = era if epoch is None else epoch  # absolute epoch counter
        self.session_id = bytes(session_id)
        self.encrypt = encrypt
        self.coin_mode = coin_mode
        self.verify_shares = verify_shares
        self.rbc_variant = rbc_variant
        self.engine = engine
        self.rng = rng
        self.obs = _resolve_recorder(recorder)
        self.hb = self._make_hb()
        self.votes: Dict = {}  # voter -> change (latest committed vote)
        self.our_vote: Optional[tuple] = None
        self.key_gen: Optional[_KeyGenState] = None
        # keygen msgs ship with every contribution until seen committed —
        # an ACS slot may legitimately decide 0, dropping that proposal
        self.pending_kg: List[tuple] = []
        self.batches: List[DhbBatch] = []
        # messages for eras we haven't reached yet (rushed peers); replayed
        # after each era switch so their era-start proposals aren't lost
        self.future_msgs: List[tuple] = []
        self._just_switched = False
        # (era, entries) for the most recent era switch: served to stranded
        # added nodes so they can recover their share (see era_transcript)
        self.last_transcript: Optional[tuple] = None
        # the futures plane's double-buffer: (parts_buf, settle) of the
        # last committed batch's keygen-part flush, its row-RLC MSM still
        # in flight on the device.  Settled (effects applied in submission
        # order) at the next flush, at propose (before the pending_kg
        # snapshot the acks must ride), at an era switch, and by
        # drain_async() — never reordered, never dropped.
        self._kg_inflight: Optional[tuple] = None
        # faults from settles that ran outside a live Step (propose /
        # drain): prepended to the next step _filter processes
        self._deferred_faults: List = []

    # -- construction helpers ----------------------------------------------

    def _make_hb(self) -> HoneyBadger:
        return HoneyBadger(
            self.netinfo,
            session_id=self.session_id + b"/era" + str(self.era).encode(),
            encrypt=self.encrypt,
            coin_mode=self.coin_mode,
            verify_shares=self.verify_shares,
            engine=self.engine,
            recorder=self.obs.bind(era=self.era),
            rbc_variant=self.rbc_variant,
        )

    @classmethod
    def from_join_plan(
        cls,
        our_id,
        our_sk: SecretKey,
        plan: JoinPlan,
        encrypt: bool = True,
        coin_mode: str = "threshold",
        verify_shares: bool = True,
        rng=None,
        engine=None,
        recorder=None,
        sk_share=None,
        rbc_variant=None,
    ) -> "DynamicHoneyBadger":
        """Instantiate as an observer from a committed JoinPlan
        (hbbft's `new_joining` path).

        ``sk_share`` re-installs a secret key share that is still valid
        for the plan's era — the crash/restart fast-forward path
        of the TCP node: a validator wedged behind the network within its
        OWN era rebuilds at the certified epoch as a validator, not an
        observer, because its era keys never changed."""
        pub_keys = {
            nid: PublicKey.from_bytes(bytes(pk))
            for nid, pk in plan.pub_keys.items()
        }
        pk_set = PublicKeySet.from_bytes(plan.pk_set_bytes)
        netinfo = NetworkInfo(our_id, list(plan.node_ids), pk_set, sk_share)
        dhb = cls(
            our_id,
            our_sk,
            netinfo,
            pub_keys,
            era=plan.era,
            epoch=plan.epoch,
            session_id=plan.session_id,
            encrypt=encrypt,
            coin_mode=coin_mode,
            verify_shares=verify_shares,
            rng=rng,
            engine=engine,
            recorder=recorder,
            rbc_variant=rbc_variant,
        )
        dhb.hb.epoch = plan.epoch - plan.era  # skip the era's earlier epochs
        return dhb

    def __getstate__(self):
        """Pickle (sim checkpoints): an in-flight settle closure holds
        device buffers and is not host state, so it is settled first (its
        effects are host state the snapshot must hold anyway; its faults
        ride _deferred_faults, which pickles).  A device error raises."""
        self._settle_keygen_inflight()
        return self.__dict__

    # -- API ----------------------------------------------------------------

    @property
    def is_validator(self) -> bool:
        return self.netinfo.is_validator() and self.netinfo.sk_share is not None

    def vote_for(self, change: tuple) -> Step:
        """Set our vote; it ships with every contribution until committed."""
        self.our_vote = tuple(change)
        return Step()

    def vote_to_add(self, node_id, pub_key: PublicKey) -> Step:
        return self.vote_for(change_add(node_id, pub_key))

    def vote_to_remove(self, node_id) -> Step:
        return self.vote_for(change_remove(node_id))

    def propose(self, contribution: bytes, rng) -> Step:
        if not self.is_validator:
            return Step()
        # settle any in-flight keygen flush FIRST: its acks must ride
        # THIS contribution's pending_kg snapshot, exactly where the
        # synchronous path put them
        self._settle_keygen_inflight()
        votes = []
        # re-send until our vote shows up in the committed tally: a slot
        # that decides 0 silently drops its contribution
        if self.our_vote is not None and self.votes.get(self.our_id) != self.our_vote:
            sig = self.our_sk.sign(self._vote_doc(self.our_vote))
            votes.append((self.our_id, self.our_vote, sig.to_bytes()))
        internal = codec.encode(
            (bytes(contribution), tuple(votes), tuple(self.pending_kg))
        )
        step = self.hb.propose(internal, rng)
        return self._filter(step)

    def external_contribution(self, contribution: bytes) -> bytes:
        """The internal payload propose() would feed the ACS (user bytes,
        pending votes and keygen messages), for an external (native) ACS run
        that bypasses the message plane."""
        self._settle_keygen_inflight()  # acks ride this snapshot
        votes = []
        if self.our_vote is not None and self.votes.get(self.our_id) != self.our_vote:
            sig = self.our_sk.sign(self._vote_doc(self.our_vote))
            votes.append((self.our_id, self.our_vote, sig.to_bytes()))
        return codec.encode((bytes(contribution), tuple(votes), tuple(self.pending_kg)))

    def apply_external_batch(self, contributions: dict) -> Step:
        """Apply an externally agreed epoch: the whole DHB batch pipeline
        (vote commits, the keygen transcript, era switches) runs in
        _filter's _on_batch as for a message-plane epoch."""
        return self._filter(self.hb.apply_external_batch(contributions))

    @guarded_handler("dhb")
    def handle_message(self, sender, message) -> Step:
        _tag, era, inner = message[0], int(message[1]), message[2]
        if era > self.era:
            # a peer that committed the era-switch batch before us; buffer so
            # its era-start traffic survives until we switch too
            if len(self.future_msgs) < 10_000:
                self.future_msgs.append((era, sender, message))
            return Step()
        if era < self.era:
            return Step()  # stale era, outcome already absorbed
        step = self.hb.handle_message(sender, inner)
        return self._filter(step)

    def join_plan(self) -> JoinPlan:
        return JoinPlan(
            era=self.era,
            epoch=self.epoch,
            node_ids=tuple(self.netinfo.node_ids),
            pub_keys={
                nid: pk.to_bytes() for nid, pk in self.pub_keys.items()
            },
            pk_set_bytes=self.netinfo.pk_set.to_bytes(),
            session_id=self.session_id,
        )

    def install_share_from_transcript(self, entries, kg_era: int) -> bool:
        """Recover this node's secret share by replaying a committed DKG
        transcript (stranded-joiner healing).

        An added node that could not follow the era switch live (the
        cluster out-ran it) is a member of the committed validator set
        but holds no share.  The transcript of Part/Ack messages is
        committed PUBLIC data: its rows/values are encrypted to each
        member's long-lived key, so replaying it through our own
        SyncKeyGen derives exactly the share the live path would have.
        The result is self-authenticating — accepted only if the derived
        PublicKeySet equals the adopted JoinPlan's — so the transcript
        needs no trusted sender.  Returns True iff the share was
        installed (in place on NetworkInfo, visible to the running HB)."""
        if self.netinfo.sk_share is not None:
            return True
        if self.our_id not in self.netinfo.node_ids:
            return False
        threshold = (len(self.netinfo.node_ids) - 1) // 3
        pub_keys = {
            nid: self.pub_keys[nid]
            for nid in self.netinfo.node_ids
            if nid in self.pub_keys
        }
        if len(pub_keys) != len(self.netinfo.node_ids):
            return False
        kg = SyncKeyGen(
            self.our_id,
            self.our_sk,
            pub_keys,
            threshold,
            self.rng,
            session=self._kg_session(kg_era),
        )
        # The replay must reproduce the LIVE acceptance schedule, not
        # the flat entry order: live nodes defer a batch's parts to one
        # end-of-batch flush while acks process inline, so a
        # Byzantine same-batch (part, ack-for-it) pair is rejected live
        # — replaying the flat transcript inline would ACCEPT that ack,
        # diverge the completed-proposal set, fail the pk_set equality
        # below, and strand the joiner forever.  "batch" boundary
        # markers in the transcript (appended by _on_batch) carry the
        # schedule; parts buffer until the marker.
        deferred: List[Tuple] = []

        def _flush_deferred() -> None:
            if not deferred:
                return
            try:
                kg.handle_parts(list(deferred))
            except (ValueError, TypeError, KeyError, IndexError):
                pass
            deferred.clear()

        for proposer, msg in entries:
            # wire transport delivers ids as raw bytes; logic-tier
            # callers pass whatever id type the network uses
            if isinstance(proposer, (bytes, bytearray, memoryview)):
                proposer = bytes(proposer)
            # per-entry guard mirroring _commit_keygen_msg: live nodes
            # fault a malformed committed entry and keep going, so the
            # replay must skip it too — one Byzantine entry in the
            # committed transcript must not defeat recovery
            try:
                kind = msg[0]
                if kind == "part":
                    deferred.append(
                        (
                            proposer,
                            Part(
                                _as_bytes(msg[1]),
                                tuple(_as_bytes(r) for r in msg[2]),
                            ),
                        )
                    )
                elif kind == "ack":
                    kg.handle_ack(
                        proposer,
                        Ack(int(msg[1]), tuple(_as_bytes(v) for v in msg[2])),
                    )
                elif kind == "batch":
                    _flush_deferred()
            except (ValueError, TypeError, KeyError, IndexError):
                continue
        _flush_deferred()  # tail batch (defensive: markers close batches)
        try:
            pk_set, sk_share = kg.generate()
        except (ValueError, TypeError, KeyError, IndexError):
            return False
        if pk_set.to_bytes() != self.netinfo.pk_set.to_bytes():
            return False  # wrong/forged transcript: reject silently
        if sk_share is None:
            return False
        # in-place: every protocol instance holds this NetworkInfo object
        self.netinfo.sk_share = sk_share
        return True

    # -- internals ----------------------------------------------------------

    def _kg_session(self, era: int) -> bytes:
        """Per-DKG-instance channel nonce: the era the keygen STARTED in
        (all live participants share it; stranded joiners get it with the
        served transcript).  Distinct per instance, so the pairwise
        channel keystreams never repeat across eras."""
        return self.session_id + b"/kg-era" + str(era).encode()

    def _vote_doc(self, change: tuple) -> bytes:
        return b"DHB-VOTE" + codec.encode((self.era, tuple(change)))

    def _filter(self, step: Step) -> Step:
        """Relabel era-scoped messages and post-process batches."""
        step.map_messages(lambda m: (MSG, self.era, m))
        if self._deferred_faults:
            # faults from settles that ran outside a live Step (propose /
            # drain_async): surface them on the next step out
            step.fault_log[:0] = self._deferred_faults
            self._deferred_faults = []
        out = []
        faults = []
        for item in step.output:
            if isinstance(item, Batch):
                batch, fstep = self._on_batch(item)
                out.append(batch)
                faults.append(fstep)
        step.output = out
        for f in faults:
            step.extend(f)
        # after an era switch, replay buffered traffic for the new era
        while self._just_switched:
            self._just_switched = False
            pending, self.future_msgs = self.future_msgs, []
            for era, sender, message in pending:
                if era > self.era:
                    self.future_msgs.append((era, sender, message))
                elif era == self.era:
                    step.extend(self.handle_message(sender, message))
        return step

    def _on_batch(self, hb_batch: Batch) -> Tuple[DhbBatch, Step]:
        step = Step()
        contributions = {}
        batch_votes: List[Tuple] = []  # (proposer, vote) in commit order
        kg_parts: List[Tuple] = []  # (proposer, Part) deferred to one flush
        own_committed: set = set()  # our keygen msgs seen committed
        kg_state = self.key_gen  # the keygen receiving this batch's msgs
        kg_tlen = len(kg_state.transcript) if kg_state is not None else 0
        for proposer, payload in sorted(hb_batch.contributions.items()):
            try:
                user, votes, kg_msgs = codec.decode(bytes(payload))
            except (ValueError, TypeError):
                step.fault(proposer, "dhb: malformed contribution")
                continue
            contributions[proposer] = bytes(user)
            for vote in votes:
                batch_votes.append((proposer, vote))
            # Per-contribution keygen-message cap: an honest node ships
            # at most its own part plus one ack per peer per batch (and
            # retransmits until seen committed), so n(n+2) bounds every
            # legitimate backlog.  A Byzantine proposer stuffing more
            # into one contribution is a flood — fault it and truncate,
            # so one committed contribution cannot drive an unbounded
            # handle_part/handle_ack storm.
            kg_cap = self.netinfo.num_nodes * (self.netinfo.num_nodes + 2)
            if len(kg_msgs) > kg_cap:
                step.fault(proposer, "dhb: keygen message flood")
                kg_msgs = kg_msgs[:kg_cap]
            for kg in kg_msgs:
                if proposer == self.our_id:
                    # our own keygen msg committed: stop retransmitting it
                    own_committed.add(_freeze(kg))
                self._commit_keygen_msg(proposer, kg, step, kg_parts)
        if own_committed and self.pending_kg:
            # one pass over the backlog per batch — the per-message spelling
            # re-froze the whole backlog for every own committed message
            # (O(own x pending) _freeze calls per keygen epoch)
            self.pending_kg = [
                m for m in self.pending_kg if _freeze(m) not in own_committed
            ]
        self._flush_keygen_parts(kg_parts, step)
        if kg_state is not None and len(kg_state.transcript) > kg_tlen:
            # batch-boundary marker: install_share_from_transcript
            # replays parts on the live deferred-flush schedule, and the
            # flat transcript cannot express where a batch ended without
            # it (only batches that committed keygen traffic need one)
            kg_state.transcript.append((b"", ("batch",)))
        self._commit_votes_batch(batch_votes, step)
        self.epoch = self.era + hb_batch.epoch + 1
        change = None
        join_plan = None
        # start keygen once a change wins a committed majority
        if self.key_gen is None:
            winner = self._winning_change()
            if winner is not None:
                self._start_key_gen(winner)
        kg_state2 = self.key_gen
        era_switched = False
        if kg_state2 is not None:
            if not kg_state2.sealed and self._keygen_ready():
                # SEAL: the structural gate crossed at THIS committed
                # batch on every node, so the committed transcript is
                # frozen here — generate() over the sealed state is the
                # canonical result no matter how many epochs the
                # cutover-marker quorum takes to commit, and later
                # part/ack traffic is ignored exactly as the legacy
                # flip-at-ready discarded it.
                kg_state2.sealed = True
                kg_state2.ready_epoch = self.epoch
            # budgeted shadow settlement + cutover pre-generation run
            # every committed batch while a keygen is live (quiet
            # batches drain the queue too)
            self._schedule_shadow(step)
            self._maybe_emit_cutover(step)
            self._note_keygen_progress(step)
            if kg_state2.sealed and self._cutover_committed():
                change = ("complete", kg_state2.change)
                era_switched = True
            else:
                change = ("in_progress", kg_state2.change)
        batch = DhbBatch(
            epoch=self.epoch - 1,
            era=self.era,
            contributions=contributions,
            change=change,
        )
        if era_switched:
            self._switch_era(step)
            batch = DhbBatch(
                epoch=batch.epoch,
                era=batch.era,
                contributions=batch.contributions,
                change=batch.change,
                join_plan=self.join_plan(),
            )
        self.batches.append(batch)
        return batch, step

    def _commit_votes_batch(self, batch_votes, step: Step) -> None:
        """Commit a batch's signed votes with ONE RLC pairing check per
        distinct vote document instead of one pairing per vote.

        All votes on the same (era, change) share the message, so
        e(G1, sum r_i sig_i) == e(sum r_i pk_i, H(doc)) verifies the
        whole group with 2 pairings and short scalar muls (random 64-bit
        r_i — a forged vote passes with probability 2^-64).  On group
        failure the per-vote path re-runs for fault attribution, so
        verdicts and fault logs match the sequential semantics."""
        import hashlib

        from ..crypto.threshold import Signature

        parsed = []  # (proposer, voter, change, sig)
        for proposer, vote in batch_votes:
            try:
                voter, change, sig_bytes = vote
                change = tuple(change)
                sig = Signature.from_bytes(bytes(sig_bytes))
            except (ValueError, TypeError):
                step.fault(proposer, "dhb: malformed vote")
                continue
            pk = self.pub_keys.get(voter)
            if pk is None or voter not in self.netinfo._index:
                step.fault(proposer, "dhb: vote from non-validator")
                continue
            parsed.append((proposer, voter, change, sig))
        if not parsed:
            return
        from collections import defaultdict

        from ..crypto import bls12_381 as bls
        from ..crypto.dkg import rlc_scalars

        groups = defaultdict(list)
        for idx, item in enumerate(parsed):
            groups[self._vote_doc(item[2])].append((idx, item))
        verified: Dict[int, bool] = {}
        for doc, items in groups.items():
            if len(items) > 1:
                # Fiat-Shamir seed binds the doc and every signature in
                # the group (the data under verification)
                h_seed = hashlib.sha256()
                h_seed.update(b"HBTPU-DHB-votes")
                h_seed.update(doc)
                for _idx, (_p, voter, _c, sig) in items:
                    h_seed.update(hashlib.sha256(sig.to_bytes()).digest())
                rs = rlc_scalars(h_seed.digest(), len(items))
                hpt = bls.hash_to_g2(doc)
                agg_sig = bls.infinity(bls.FQ2)
                agg_pk = bls.infinity(bls.FQ)
                for r, (_idx, (_p, voter, _c, sig)) in zip(rs, items):
                    agg_sig = bls.add(agg_sig, bls.mul_sub(sig.point, r))
                    agg_pk = bls.add(
                        agg_pk, bls.mul_sub(self.pub_keys[voter].point, r)
                    )
                if bls.pairing_check_eq(bls.G1, agg_sig, agg_pk, hpt):
                    for idx, _item in items:
                        verified[idx] = True
                    continue
                # fall through: attribute faults vote by vote
            for idx, (_p, voter, change, sig) in items:
                if self.pub_keys[voter].verify(sig, doc):
                    verified[idx] = True
                else:
                    verified[idx] = False
                    step.fault(_p, "dhb: bad vote signature")
        # apply verified votes in COMMIT order (sequential semantics:
        # the last committed vote per voter wins)
        for idx, (_p, voter, change, _s) in enumerate(parsed):
            if verified.get(idx):
                self.votes[voter] = change

    def _commit_vote(self, proposer, vote, step: Step) -> None:
        try:
            voter, change, sig_bytes = vote
            change = tuple(change)
            from ..crypto.threshold import Signature

            sig = Signature.from_bytes(bytes(sig_bytes))
        except (ValueError, TypeError):
            step.fault(proposer, "dhb: malformed vote")
            return
        pk = self.pub_keys.get(voter)
        if pk is None or voter not in self.netinfo._index:
            step.fault(proposer, "dhb: vote from non-validator")
            return
        if not pk.verify(sig, self._vote_doc(change)):
            step.fault(proposer, "dhb: bad vote signature")
            return
        self.votes[voter] = change

    def _keygen_ready(self) -> bool:
        """Deterministic era-switch gate, evaluated on committed data only:
        more than `threshold` proposals complete.  (The strict all-n gate of
        the bootstrap keygen cannot work here — a node
        being *added* observes the transcript but never proposes a Part.)
        """
        state = self.key_gen
        t = (len(state.new_ids) - 1) // 3
        return state.key_gen.count_complete() >= dkg_degree(t)

    def _winning_change(self) -> Optional[tuple]:
        counts: Dict[tuple, int] = {}
        for change in self.votes.values():
            counts[change] = counts.get(change, 0) + 1
        n = self.netinfo.num_nodes
        for change, count in sorted(counts.items(), key=lambda kv: -kv[1]):
            if count * 2 > n:
                return change
        return None

    def _start_key_gen(self, change: tuple) -> None:
        if change[0] == "add":
            node_id, pk_bytes = change[1], bytes(change[2])
            new_ids = sorted(set(self.netinfo.node_ids) | {node_id})
            new_pub_keys = {
                nid: self.pub_keys[nid]
                for nid in self.netinfo.node_ids
                if nid in self.pub_keys
            }
            new_pub_keys[node_id] = PublicKey.from_bytes(pk_bytes)
            self.pub_keys.setdefault(node_id, new_pub_keys[node_id])
        else:
            node_id = change[1]
            new_ids = sorted(set(self.netinfo.node_ids) - {node_id})
            new_pub_keys = {
                nid: self.pub_keys[nid] for nid in new_ids if nid in self.pub_keys
            }
        if self.our_id in new_ids:
            threshold = (len(new_ids) - 1) // 3
            kg = SyncKeyGen(
                self.our_id,
                self.our_sk,
                new_pub_keys,
                threshold,
                self.rng,
                session=self._kg_session(self.era),
            )
            state = _KeyGenState(tuple(change), new_ids, new_pub_keys, kg)
            state.progress_epoch = self.epoch
            self.key_gen = state
            if self.is_validator:
                part = kg.propose()
                self.pending_kg.append(
                    ("part", part.commit_bytes, tuple(part.enc_rows))
                )
        else:
            # we are being removed: follow the transcript without a DKG role
            self.key_gen = _KeyGenState(
                tuple(change), new_ids, new_pub_keys, _RemovedTracker(new_ids)
            )
            self.key_gen.progress_epoch = self.epoch

    def _commit_keygen_msg(
        self, proposer, kg, step: Step, parts_buf: Optional[List] = None
    ) -> None:
        state = self.key_gen
        if state is None:
            return  # no active keygen: stale message
        try:
            frozen = _freeze(kg)
            kind = frozen[0]
        except (ValueError, TypeError, IndexError):
            step.fault(proposer, "dhb: malformed keygen message")
            return
        seen = state.committed_seen
        dedup_key = (proposer, frozen)
        if dedup_key in seen:
            # retransmitted duplicate of an already-committed message:
            # validators re-ship their pending_kg backlog until they see
            # it committed, so every keygen epoch past the first commits
            # thousands of these at scale — skip before reconstruction,
            # transcript append and handle_* (first commit did it all)
            return
        if kind == "cutover":
            # Era-cutover marker: a current-era validator's
            # committed claim that its shadow DKG is fully settled.  The
            # era flips at the first committed batch where the sealed
            # gate holds AND > f distinct proposers have marked — both
            # committed data, so every node flips at the same batch.
            # Markers are schedule data like the "batch" boundary
            # markers: never transcripted (a replaying joiner derives
            # its share from parts/acks alone), and a stale-era marker
            # is ignored rather than counted.
            try:
                if int(frozen[1]) == self.era:
                    state.cutover_votes.add(proposer)
                    seen.add(dedup_key)
            except (ValueError, TypeError, IndexError):
                step.fault(proposer, "dhb: malformed keygen message")
            return
        if state.sealed:
            # the transcript sealed when the structural gate crossed:
            # later-committed part/ack traffic can no longer change this
            # era switch's outcome (the legacy flip-at-ready discarded
            # it identically) — ignore, never fault honest retransmits
            return
        if kind in ("part", "ack"):
            # Only replayable protocol messages enter the committed
            # transcript.  The "batch" boundary markers _on_batch
            # appends are OUT-OF-BAND schedule data: recording an
            # attacker-SENT ("batch",) here would let one Byzantine
            # validator inject an early part-flush into every future
            # replayer's schedule and desync it from the live gate.
            seen.add(dedup_key)
            state.transcript.append((proposer, frozen))
        try:
            if kind == "part":
                part = Part(
                    _as_bytes(kg[1]), tuple(_as_bytes(r) for r in kg[2])
                )
                if parts_buf is not None and hasattr(
                    state.key_gen, "handle_parts"
                ):
                    # Poll-level aggregation: defer the part
                    # so the whole committed batch's row RLC checks
                    # settle as ONE batched MSM in _flush_keygen_parts.
                    # Order-safe for honest flows: an ack is only ever
                    # produced AFTER its part commits, so it rides a
                    # strictly later batch — no committed ack can
                    # reference a same-batch part.  (A Byzantine sender
                    # violating that ordering faults either way.)
                    parts_buf.append((proposer, part))
                    return
                outcome = state.key_gen.handle_part(proposer, part)
                self._apply_part_outcome(proposer, outcome, step)
            elif kind == "ack":
                ack = Ack(int(kg[1]), tuple(_as_bytes(v) for v in kg[2]))
                outcome = state.key_gen.handle_ack(proposer, ack)
                if outcome is not None and not outcome.valid:
                    step.fault(proposer, f"dhb keygen: {outcome.fault}")
            else:
                step.fault(proposer, "dhb: unknown keygen message")
        except (ValueError, TypeError, KeyError):
            step.fault(proposer, "dhb: malformed keygen message")

    def _apply_part_outcome(self, proposer, outcome, step: Step) -> None:
        if outcome is None:
            return
        if not outcome.valid:
            step.fault(proposer, f"dhb keygen: {outcome.fault}")
        elif outcome.ack is not None and self.is_validator:
            self.pending_kg.append(
                (
                    "ack",
                    outcome.ack.proposer_idx,
                    tuple(outcome.ack.enc_values),
                )
            )

    def _flush_keygen_parts(self, parts_buf: List, step: Step) -> None:
        """Intake all parts deferred from one committed batch.

        Shadow mode (the default — ``HYDRABADGER_SHADOW_DKG=0``
        reverts): only the STRUCTURAL half runs here on the commit path
        (``record_parts``: the objective proposal set, a few decodes
        per part); the row crypto is pushed onto the era's shadow queue
        and drained by :meth:`_schedule_shadow` at a bounded per-epoch
        budget, so a DKG part storm never walls a committed batch.

        Legacy mode: every row/commitment RLC check runs as one batched
        MSM and the ack values seal through the batched channel plane
        (SyncKeyGen.handle_parts) — n host Pippengers and n^2 per-value
        seal calls collapse into one call each per batch.

        Double-buffered: with the futures plane on, batch
        k's MSM is SUBMITTED here and left in flight while the host
        commits the rest of the batch (vote pairings, other nodes'
        work in an in-process runtime); its settle — verdicts fetched,
        our acks appended to pending_kg — runs at the NEXT flush
        (after batch k+1's submit, so the device never drains), at
        propose (the acks must ride that snapshot), or at an era
        switch.  Settles always apply in
        submission order, so the effect sequence is bit-identical to
        the synchronous path."""
        if not parts_buf:
            return
        state = self.key_gen
        if state is None:
            return
        from ..crypto import futures as _futures

        kg = state.key_gen
        if _shadow_scheduling() and hasattr(kg, "record_parts"):
            try:
                outcomes, deferred = kg.record_parts(list(parts_buf))
            except (ValueError, TypeError, KeyError):
                # defensive only — see the sync branch's rationale
                for proposer, _part in parts_buf:
                    step.fault(proposer, "dhb: keygen part batch failed")
                return
            for (proposer, _part), outcome in zip(parts_buf, outcomes):
                if outcome is not None:
                    self._apply_part_outcome(proposer, outcome, step)
            state.shadow_queue.extend(
                (sid, part) for _i, sid, part in deferred
            )
            return
        if _futures.enabled() and hasattr(kg, "handle_parts_submit"):
            try:
                settle = kg.handle_parts_submit(list(parts_buf))
            except (ValueError, TypeError, KeyError):
                # Defensive only — see the sync branch's rationale.
                for proposer, _part in parts_buf:
                    step.fault(proposer, "dhb: keygen part batch failed")
                return
            prev, self._kg_inflight = (
                self._kg_inflight,
                (list(parts_buf), settle),
            )
            if prev is not None:
                # batch k+1 submitted above; NOW settle batch k — the
                # double-buffer: one flush always in flight
                self._settle_flush(prev, step)
            return
        # sync branch: a flush left in flight by a mid-run plane toggle
        # must settle first (its acks precede this batch's in pending_kg)
        self._settle_keygen_inflight(step)
        try:
            outcomes = kg.handle_parts(parts_buf)
        except (ValueError, TypeError, KeyError):
            # Defensive only: handle_parts judges malformed input via
            # outcomes (non-member senders included) and its batched
            # crypto is internally guarded, so this should be
            # unreachable.  Do NOT re-run per part: the batch records
            # proposal state as it goes, so a re-run would take the
            # duplicate path (ack=None) and silently withhold our acks.
            # Fault loudly instead — if our crypto plane is throwing we
            # cannot ack anyway, and a missed era switch degrades us to
            # observer (_switch_era's generate guard) rather than
            # forking anyone.
            for proposer, _part in parts_buf:
                step.fault(proposer, "dhb: keygen part batch failed")
            return
        for (proposer, _part), outcome in zip(parts_buf, outcomes):
            self._apply_part_outcome(proposer, outcome, step)

    def _settle_flush(self, pending: tuple, step: Step) -> None:
        """Apply one deferred flush's outcomes (fetch verdicts, emit
        acks/faults) — the per-part containment of the sync path."""
        parts_buf, settle = pending
        try:
            outcomes = settle()
        except (ValueError, TypeError, KeyError):
            for proposer, _part in parts_buf:
                step.fault(proposer, "dhb: keygen part batch failed")
            return
        for (proposer, _part), outcome in zip(parts_buf, outcomes):
            self._apply_part_outcome(proposer, outcome, step)

    def _settle_keygen_inflight(self, step: Optional[Step] = None) -> None:
        """Settle the in-flight keygen flush, if any.  Without a live
        Step the faults are deferred to the next one out (_filter)."""
        pending, self._kg_inflight = self._kg_inflight, None
        if pending is None:
            return
        local = step if step is not None else Step()
        self._settle_flush(pending, local)
        if step is None and local.fault_log:
            self._deferred_faults.extend(local.fault_log)

    # -- shadow-DKG scheduling + atomic cutover ----------------------------

    def _schedule_shadow(self, step: Step) -> None:
        """Drain up to one budget's worth of owed row settlements — the
        per-epoch shadow slot.  Runs at every committed batch while a
        keygen is live (quiet batches drain too), double-buffered
        through ``_kg_inflight`` exactly like the legacy flush, so the
        settlement MSM overlaps host work when the futures plane is on
        and the DKG's crypto fills the device's idle shadow instead of
        blocking the commit path."""
        state = self.key_gen
        if state is None or not state.shadow_queue:
            return
        from ..crypto import futures as _futures

        kg = state.key_gen
        budget = _shadow_budget()
        chunk = state.shadow_queue[:budget]
        del state.shadow_queue[:budget]
        # the DKG-settle stage span (the cluster timeline): the
        # per-epoch shadow slot is the one DKG cost still riding the
        # commit path, so it competes with RBC/BA/subset/tdec for an
        # epoch's critical path and must be attributable like them.
        # Epoch is the ERA-LOCAL hb epoch — the key the other stage
        # spans and the epoch span itself carry.
        obs = self.obs
        obs.begin(
            "dkg_settle", era=self.era, epoch=self.hb.epoch,
            parts=len(chunk),
        )
        try:
            try:
                settle = kg.settle_parts_submit(list(chunk))
            except (ValueError, TypeError, KeyError):
                for proposer, _part in chunk:
                    step.fault(proposer, "dhb: keygen part batch failed")
                return
            if _futures.enabled():
                prev, self._kg_inflight = (
                    self._kg_inflight, (list(chunk), settle),
                )
                if prev is not None:
                    self._settle_flush(prev, step)
            else:
                self._settle_flush((list(chunk), settle), step)
        finally:
            obs.end("dkg_settle", era=self.era, epoch=self.hb.epoch)

    def _maybe_emit_cutover(self, step: Step) -> None:
        """Once SEALED and fully settled: pre-generate the next era's
        keys in the current era's shadow and (validators) commit the
        cutover marker.  The marker is the atomic-cutover signal — the
        era flips only at the committed batch where > f distinct
        validators have marked, so at least one honest node had
        finished its settlement before the network cut over, and the
        flip batch itself installs cached keys in O(1) crypto."""
        state = self.key_gen
        if (
            state is None
            or not state.sealed
            or state.cutover_sent
            or state.shadow_queue
        ):
            return
        # the final settlement chunk may still be in flight: settle it
        # now — the marker asserts "fully settled", and with the queue
        # empty there is no next submit for it to overlap
        self._settle_keygen_inflight(step)
        kg = state.key_gen
        if state.gen_cache is None and not isinstance(kg, _RemovedTracker):
            # generate() over the SEALED state — deterministic, equal to
            # what the flip batch would compute — so the cutover batch
            # tears down the old era without a key-derivation wall.
            # A failure here is deterministic too: leave the cache empty
            # and let _switch_era's observer-degrade path own it.
            try:
                state.gen_cache = kg.generate()
            except (ValueError, TypeError, KeyError, IndexError):
                state.gen_cache = None
        state.cutover_sent = True
        if self.is_validator:
            self.pending_kg.append(("cutover", self.era))

    def _cutover_committed(self) -> bool:
        """Flip gate: > f distinct committed cutover markers (current-era
        proposers), evaluated on committed data only — with at most f
        Byzantine validators, at least one marker came from an honest
        node that truly finished its shadow settlement."""
        state = self.key_gen
        f = (self.netinfo.num_nodes - 1) // 3
        return len(state.cutover_votes) > f

    def _note_keygen_progress(self, step: Step) -> None:
        """Stall detector: the shadow DKG must degrade LOUDLY, never
        wedge.  If the committed DKG state (proposals, structural acks,
        cutover markers) stops advancing — withheld Parts, a starved
        marker quorum — the current era keeps committing (nothing here
        blocks the batch path) and a periodic fault + the
        ``shadow_dkg_stall_epochs`` gauge (mirrored by the sim/net
        harnesses) make the stall observable; silent tolerance fails
        scenario runs via FAULT_OBSERVABLES."""
        state = self.key_gen
        kg = state.key_gen
        if hasattr(kg, "parts"):
            acks = sum(len(s.acks) for s in kg.parts.values())
            sig = (len(kg.parts), acks, len(state.cutover_votes), state.sealed)
        else:  # _RemovedTracker
            acks = sum(len(a) for a in kg.ack_counts.values())
            sig = (
                len(kg.commitments), acks,
                len(state.cutover_votes), state.sealed,
            )
        if sig != state.progress_sig:
            state.progress_sig = sig
            state.progress_epoch = self.epoch
            return
        stalled = self.epoch - state.progress_epoch
        limit = _shadow_stall_after()
        if stalled > 0 and stalled % limit == 0:
            step.fault(
                self.our_id,
                f"dhb: shadow keygen stalled ({stalled} epochs without "
                "DKG progress; current era keeps committing)",
            )
            self.obs.instant(
                "shadow_dkg_stall", era=self.era, epochs=stalled,
            )

    def shadow_stall_epochs(self) -> int:
        """Epochs since the live shadow DKG last advanced (0 = healthy
        or no keygen) — the number behind the harness-owned
        ``shadow_dkg_stall_epochs`` gauge."""
        state = self.key_gen
        if state is None:
            return 0
        return max(0, self.epoch - state.progress_epoch)

    def drain_async(self) -> Step:
        """Settle any in-flight device work and return its step — the
        tick-boundary drain the sim calls after each router run (and
        harness teardowns call so no future is ever dropped).  Faults
        deferred by earlier step-less settles ride out here too: the
        drain may be the last step this node ever emits."""
        step = Step()
        self._settle_keygen_inflight(step)
        if self._deferred_faults:
            step.fault_log[:0] = self._deferred_faults
            self._deferred_faults = []
        return step

    def _switch_era(self, step: Step) -> None:
        # the in-flight flush belongs to the completing keygen: settle it
        # BEFORE generate() and before pending_kg is cleared, so our acks
        # land (and are cleared) exactly as on the synchronous path
        self._settle_keygen_inflight(step)
        state = self.key_gen
        # Settlement still owed when the cutover committed (f+1 faster
        # peers marked first): the owed work is our OUTGOING acks and
        # per-proposer fault attribution for the OLD era — both moot
        # once the era flips (pending_kg clears below; our share derives
        # from the sealed ack VALUES, never from our row settlements).
        # Discard rather than paying a settlement wall at the flip batch.
        state.shadow_queue = []
        new_era = self.epoch
        kg_era = self.era  # the era this keygen's channel nonces used
        try:
            if isinstance(state.key_gen, _RemovedTracker):
                pk_set, sk_share = state.key_gen.generate(), None
            elif state.gen_cache is not None:
                # pre-generated in the shadow at cutover-marker time —
                # identical to generate() here (the state is sealed)
                pk_set, sk_share = state.gen_cache
            else:
                pk_set, sk_share = state.key_gen.generate()
        except ValueError:
            # >t Byzantine ackers left a complete proposal without
            # enough verified values (dkg.generate's defensive guard):
            # degrade to OBSERVER for the new era instead of crashing
            # mid-switch.  The public key set is rebuilt
            # from the committed commitments alone (objective data, so
            # every honest node still switches identically at this
            # batch); only our own share is lost.
            step.fault(
                self.our_id,
                "dhb: keygen generate failed; continuing as observer",
            )
            from ..crypto.bls12_381 import FQ, add, infinity
            from ..crypto.threshold import PublicKeySet

            sk_share = None
            t_thr = (len(state.new_ids) - 1) // 3
            acc = [infinity(FQ) for _ in range(t_thr + 1)]
            for st in state.key_gen.parts.values():
                if st.is_complete(t_thr):
                    row0 = st.commitment.row_commitment(0)
                    acc = [add(a, b) for a, b in zip(acc, row0)]
            pk_set = PublicKeySet(acc)
        if self.our_id not in state.new_ids:
            sk_share = None
        self.netinfo = NetworkInfo(
            self.our_id, state.new_ids, pk_set, sk_share
        )
        self.pub_keys = dict(state.new_pub_keys)
        self.era = new_era
        self.last_transcript = (new_era, kg_era, tuple(state.transcript))
        self.obs.instant(
            "era_switch",
            era=new_era,
            validators=len(state.new_ids),
            validator="yes" if sk_share is not None else "observer",
        )
        self.hb = self._make_hb()
        self.votes = {}
        self.key_gen = None
        self.pending_kg = []
        if self.our_vote == state.change:
            self.our_vote = None  # our change just completed
        self._just_switched = True


class _RemovedTracker:
    """DKG transcript follower for a node *leaving* the validator set.

    It cannot decrypt rows/values, so it mirrors SyncKeyGen's completion
    accounting structurally (one value per committed ack) to fire the
    same era-switch gate at the same batch, and reconstructs the public
    key set from the committed commitments alone.  Assumes committed acks
    are honest (the validators verify them cryptographically; a bad ack
    would be flagged there).
    """

    def __init__(self, new_ids):
        self.new_ids = sorted(new_ids)
        self.threshold = (len(self.new_ids) - 1) // 3
        self.commitments: Dict[int, object] = {}  # proposer idx -> commitment
        self.ack_counts: Dict[int, set] = {}

    def handle_part(self, sender_id, part: Part):
        from ..crypto.dkg import BivarCommitment, PartOutcome

        if sender_id not in self.new_ids:
            return PartOutcome(False, fault="part from non-member")
        idx = self.new_ids.index(sender_id)
        # the same STRUCTURAL checks SyncKeyGen applies — the leaver's
        # recorded proposal set must match the validators' exactly or the
        # era-switch gate fires at different committed batches
        try:
            commit = BivarCommitment.from_bytes(part.commit_bytes)
        except (ValueError, TypeError):
            return PartOutcome(False, fault="undecodable commitment")
        if commit.t != self.threshold:
            return PartOutcome(False, fault="wrong degree")
        if len(part.enc_rows) != len(self.new_ids):
            return PartOutcome(False, fault="wrong row count")
        if idx in self.commitments:
            if self.commitments[idx].to_bytes() != part.commit_bytes:
                return PartOutcome(False, fault="conflicting part")
            return PartOutcome(True)
        self.commitments[idx] = commit
        self.ack_counts[idx] = set()
        return PartOutcome(True)

    def handle_parts(self, items):
        """Batch twin of handle_part (sequential — the tracker does no
        crypto).  Load-bearing for gate agreement: _on_batch DEFERS
        parts to one end-of-batch flush whenever the keygen object has
        handle_parts, so the tracker must defer on the same schedule —
        if it recorded parts inline while validators deferred, a
        Byzantine same-batch (part, ack-for-it) pair would be counted
        by the tracker but faulted by the validators, firing the
        era-switch gate at different committed batches."""
        return [self.handle_part(s, p) for s, p in items]

    def handle_ack(self, sender_id, ack: Ack):
        from ..crypto.dkg import AckOutcome

        if ack.proposer_idx not in self.ack_counts:
            return AckOutcome(False, fault="ack for unknown part")
        if sender_id not in self.new_ids:
            return AckOutcome(False, fault="ack from non-member")
        if len(ack.enc_values) != len(self.new_ids):
            return AckOutcome(False, fault="wrong value count")
        self.ack_counts[ack.proposer_idx].add(sender_id)
        return AckOutcome(True)

    def _complete(self):
        # 2t+1 structural acks — the same objective gate as
        # _ProposalState.is_complete, so leaver and validators agree
        return [
            i
            for i in sorted(self.commitments)
            if len(self.ack_counts.get(i, ())) > 2 * self.threshold
        ]

    def count_complete(self) -> int:
        return len(self._complete())

    def generate(self) -> PublicKeySet:
        from ..crypto.bls12_381 import add as g_add

        acc = None
        for idx in self._complete():
            row0 = self.commitments[idx].row_commitment(0)
            acc = row0 if acc is None else [g_add(a, b) for a, b in zip(acc, row0)]
        return PublicKeySet(acc)
