"""Reliable Broadcast (RBC): Bracha broadcast over RS-coded payloads.

The port's copy of hydrabadger_tpu/consensus/broadcast.py.  Semantics
follow hbbft's `broadcast` module: the proposer
Reed-Solomon-codes its value into N shards (N-2f data, 2f parity), binds
them with a Merkle tree, and sends each node its proof.  Nodes Echo their
proofs to everyone, send Ready on N-f echoes (or f+1 readys), and decode
once 2f+1 readys + N-2f echoes are in.  Every multicast is self-handled,
so `Target.all()` means "all *other* nodes" to the transport.

This per-instance core is intentionally scalar: its RS coding is the
engine's host `rs_encode_bytes` / `rs_reconstruct_data` on every engine.

Two selectable variants (``variant=``, plumbed from SimConfig /
``HYDRABADGER_RBC`` via utils.envflags):

``bracha`` (default, and the fallback)
    The reference protocol above: every Value/Echo ships a full Merkle
    branch, verified per message on the host.

``lowcomm`` (reduced-communication RBC, arXiv 2404.08070 and 2010.04607)
    Reduced-communication RBC: echoes carry a bare shard bound only by
    a 32-byte commitment — no Merkle branch, no per-message hashing —
    so the O(n²) echo tier drops from ``shard + 32·(log n + 1)`` to
    ``shard + 64`` bytes per message.  The commitment is
    SHA-256(payload_hash ‖ homomorphic sketch vector ‖ geometry); the
    proposer's Value additionally carries the sketch vector
    (crypto/homhash: a GF(2^8)-linear hash of each shard), so at decode
    time a receiver verifies ALL peers' shards as ONE batched engine
    fold (``engine.homhash_batch``: kernel B1 on the GPU engine)
    instead of n host hash chains.  Safety never rests on the sketch:
    every decode re-derives the payload hash and the full commitment
    from the decoded bytes, so a sketch collision can stall this
    instance (fault, loudly) but can never decide a wrong payload.
    Liveness caveat, documented: a node that missed the proposer's
    Value has no sketch vector to pre-filter with; its decode retries
    as echoes arrive and is safe, but an adversary pairing shard
    garbage with Value suppression can delay it — the Merkle variant
    remains the default wherever that trade is wrong.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Hashable, Optional, Tuple, TypeVar

from ..crypto.engine import get_engine
from ..obs.recorder import resolve as _resolve_recorder
from .merkle import MerkleTree, Proof
from .types import (
    NetworkInfo,
    Step,
    guarded_handler,
    quorum_exists,
    quorum_intersect,
)

N = TypeVar("N", bound=Hashable)

MSG_VALUE = "bc_value"
MSG_ECHO = "bc_echo"
MSG_READY = "bc_ready"

# low-communication variant wire kinds
MSG_VALUE_LC = "bc_value_lc"  # (payload_hash, sketch_vec, shard)
MSG_ECHO_LC = "bc_echo_lc"  # (commitment, shard)
MSG_READY_LC = "bc_ready_lc"  # commitment

VARIANTS = ("bracha", "lowcomm")

_LC_DOMAIN = b"hbtpu-rbc-lc-v1"

# sketch width must match the engine's homhash plane (crypto/homhash);
# spelled as a literal here so the sans-io core needs no crypto import
# at module load (pinned equal in tests/test_torch_homhash.py)
SKETCH_BYTES = 8


def lc_commitment(payload_hash: bytes, sketch_vec: bytes, n: int, k: int) -> bytes:
    """The 32-byte root of the low-comm variant: binds the payload hash,
    the per-shard homomorphic sketch vector and the coding geometry."""
    return hashlib.sha256(
        _LC_DOMAIN
        + n.to_bytes(2, "big")
        + k.to_bytes(2, "big")
        + payload_hash
        + sketch_vec
    ).digest()


class Broadcast:
    """One broadcast instance: `proposer_id` disseminates one payload."""

    def __init__(
        self,
        netinfo: NetworkInfo,
        proposer_id,
        engine=None,
        recorder=None,
        variant: Optional[str] = None,
    ):
        self.netinfo = netinfo
        self.proposer_id = proposer_id
        self.engine = get_engine(engine)
        # sans-io: the ambient-env default resolves at the constructing
        # I/O layer (utils.envflags); None here simply means the
        # reference protocol
        self.variant = "bracha" if variant is None else variant
        if self.variant not in VARIANTS:
            raise ValueError(
                f"unknown RBC variant {self.variant!r}; have {VARIANTS}"
            )
        # pure event emission only (obs/recorder.py): spans carry what
        # this core knows (stage transitions); identity attrs and wall
        # time arrive via binding/stamping at the layers above
        self.obs = _resolve_recorder(recorder)
        self._span_open = False
        n, f = netinfo.num_nodes, netinfo.num_faulty
        self.data_shards = n - 2 * f
        self.parity_shards = 2 * f
        self.echo_sent = False
        self.ready_sent = False
        self.decided = False
        self.payload: Optional[bytes] = None  # set when decoding succeeds
        self.value_received = False
        self.echos: Dict = {}  # sender -> Proof | (commitment, ph, shard)
        self.readys: Dict = {}  # sender -> root/commitment bytes
        self.fault_estimate = 0
        self._mixed_roots_flagged = False
        # branches we built or already validated ourselves: the Merkle
        # re-hash of OUR echoed proof on the _handle_echo hot path is a
        # pure recompute, skipped via this (bounded, <= 2 entry) cache
        self._own_proof_wires: set = set()
        # lowcomm state: the proposer's sketch vector + payload hash
        # (known only after a Value; decode pre-filters with it), and
        # the once-per-instance sketchless-decode-failure flag
        self.lc_sketch_vec: Optional[bytes] = None
        self.lc_payload_hash: Optional[bytes] = None
        self._lc_mismatch_flagged = False
        # senders whose echoed shard already failed the sketch filter:
        # excluded from later decode attempts (no re-fold, no re-fault
        # — one injected garbage shard records ONE fault), bounded by
        # the roster
        self._lc_rejected: set = set()
        # fingerprint of the last FAILED decode sweep: a Ready arriving
        # with an unchanged candidate set must not re-pay the k+1
        # attempt sweep (adversary-amplifiable otherwise — one forged
        # echo, hundreds of re-decodes)
        self._lc_fail_fp = None

    # -- API ----------------------------------------------------------------

    def broadcast(self, payload: bytes, rng=None) -> Step:
        """Proposer entry point: shard, prove, disseminate."""
        if self.netinfo.our_id != self.proposer_id:
            raise ValueError("only the proposer may broadcast")
        if self.value_received:
            return Step.empty()
        self._obs_open()
        shards = self.engine.rs_encode_bytes(
            payload, self.data_shards, self.parity_shards
        )
        if self.variant == "lowcomm":
            return self._broadcast_lc(payload, shards)
        tree = MerkleTree(shards)
        step = Step()
        my_proof = None
        for i, nid in enumerate(self.netinfo.node_ids):
            proof = tree.proof(i)
            if nid == self.netinfo.our_id:
                my_proof = proof
            else:
                step.to(nid, (MSG_VALUE, proof.wire()))
        self.value_received = True
        if my_proof is not None:
            # built from our own tree: _handle_echo may skip the re-hash
            self._own_proof_wires.add(my_proof.wire())
            step.extend(self._send_echo(my_proof))
        return step

    @guarded_handler("broadcast")
    def handle_message(self, sender, message) -> Step:
        kind, payload = message[0], message[1]
        self._obs_open()
        if self.variant == "lowcomm":
            if kind == MSG_VALUE_LC:
                return self._handle_value_lc(sender, payload)
            if kind == MSG_ECHO_LC:
                return self._handle_echo_lc(sender, payload)
            if kind == MSG_READY_LC:
                return self._handle_ready_lc(sender, bytes(payload))
            return Step().fault(
                sender, f"broadcast: unknown message {kind!r}"
            )
        if kind == MSG_VALUE:
            return self._handle_value(sender, Proof.from_wire(payload))
        if kind == MSG_ECHO:
            return self._handle_echo(sender, Proof.from_wire(payload))
        if kind == MSG_READY:
            return self._handle_ready(sender, bytes(payload))
        return Step().fault(sender, f"broadcast: unknown message {kind!r}")

    # -- internals ----------------------------------------------------------

    def _obs_open(self) -> None:
        if not self._span_open:
            self._span_open = True
            self.obs.begin("rbc")

    def _n_leaves(self) -> int:
        return self.netinfo.num_nodes

    def _handle_value(self, sender, proof: Proof) -> Step:
        if sender != self.proposer_id:
            return Step().fault(sender, "broadcast: Value from non-proposer")
        if self.value_received:
            return Step()
        our_idx = self.netinfo.index(self.netinfo.our_id)
        if proof.index != our_idx or not proof.validate(self._n_leaves()):
            return Step().fault(sender, "broadcast: invalid Value proof")
        self.value_received = True
        # just validated: our own echo of this proof (self-handled via
        # _send_echo) need not re-hash the branch on the hot path
        self._own_proof_wires.add(proof.wire())
        return self._send_echo(proof)

    def _send_echo(self, proof: Proof) -> Step:
        if self.echo_sent:
            return Step()
        self.echo_sent = True
        step = Step().broadcast((MSG_ECHO, proof.wire()))
        return step.extend(self._handle_echo(self.netinfo.our_id, proof))

    def _handle_echo(self, sender, proof: Proof) -> Step:
        if sender in self.echos:
            prev = self.echos[sender]
            if prev.wire() != proof.wire():
                return Step().fault(sender, "broadcast: conflicting Echo")
            return Step()
        expected_idx = self.netinfo.index(sender)
        # our own echoed proof was built (broadcast) or validated
        # (_handle_value) moments ago: equality against the cached wire
        # bytes replaces the full branch re-hash on this hot path
        trusted = (
            sender == self.netinfo.our_id
            and proof.wire() in self._own_proof_wires
        )
        if proof.index != expected_idx or not (
            trusted or proof.validate(self._n_leaves())
        ):
            return Step().fault(sender, "broadcast: invalid Echo proof")
        self.echos[sender] = proof
        step = Step()
        n, f = self.netinfo.num_nodes, self.netinfo.num_faulty
        root = proof.root
        # Distinct validated roots within one instance mean SOMEBODY
        # misbehaved: either the proposer disseminated shards of two
        # different codings (split-root equivocation), or an echoer
        # fabricated a whole alternative tree.  Either way the instance
        # can stall without any per-message check firing — log it once
        # so an equivocating proposer is never SILENTLY tolerated.  The
        # fault names the proposer (the overwhelmingly likely author)
        # but the kind records the attribution ambiguity.
        if not self._mixed_roots_flagged and any(
            p.root != root for p in self.echos.values()
        ):
            self._mixed_roots_flagged = True
            self.obs.instant("rbc_mixed_roots")
            step.fault(
                self.proposer_id,
                "broadcast: mixed echo roots (proposer equivocation "
                "or forged echo)",
            )
        if self._count_echos(root) >= n - f and not self.ready_sent:
            step.extend(self._send_ready(root))
        if (
            self._count_readys(root) >= quorum_intersect(n, f)
            and self._count_echos(root) >= self.data_shards
        ):
            step.extend(self._try_decode(root))
        return step

    def _send_ready(self, root: bytes) -> Step:
        if self.ready_sent:
            return Step()
        self.ready_sent = True
        step = Step().broadcast((MSG_READY, root))
        return step.extend(self._handle_ready(self.netinfo.our_id, root))

    def _handle_ready(self, sender, root: bytes) -> Step:
        if sender in self.readys:
            if self.readys[sender] != root:
                return Step().fault(sender, "broadcast: conflicting Ready")
            return Step()
        self.readys[sender] = root
        step = Step()
        n, f = self.netinfo.num_nodes, self.netinfo.num_faulty
        if self._count_readys(root) >= quorum_exists(n, f) and not self.ready_sent:
            step.extend(self._send_ready(root))
        if (
            self._count_readys(root) >= quorum_intersect(n, f)
            and self._count_echos(root) >= self.data_shards
        ):
            step.extend(self._try_decode(root))
        return step

    def _count_echos(self, root: bytes) -> int:
        return sum(1 for p in self.echos.values() if p.root == root)

    def _count_readys(self, root: bytes) -> int:
        return sum(1 for r in self.readys.values() if r == root)

    def _try_decode(self, root: bytes) -> Step:
        if self.decided:
            return Step()
        slots = [None] * self.netinfo.num_nodes
        for sender, proof in self.echos.items():
            if proof.root == root:
                slots[proof.index] = proof.value
        try:
            payload = self.engine.rs_reconstruct_data(
                slots, self.data_shards, self.parity_shards
            )
        except ValueError:
            self.obs.instant("rbc_undecodable")
            return Step().fault(
                self.proposer_id, "broadcast: undecodable shards"
            )
        # Recompute the tree: catches a proposer whose shards don't form a
        # consistent coding (split-root attack).
        full = self.engine.rs_encode_bytes(
            payload, self.data_shards, self.parity_shards
        )
        if MerkleTree(full).root != root:
            self.decided = True
            self.obs.end("rbc", ok=False)
            return Step().fault(self.proposer_id, "broadcast: root mismatch")
        self.decided = True
        self.payload = payload
        self.obs.end("rbc", ok=True, payload_bytes=len(payload))
        step = Step()
        step.output.append(payload)
        return step

    # -- low-communication variant (arxiv 2404.08070 / 2010.04607) ----------

    def _broadcast_lc(self, payload: bytes, shards) -> Step:
        """Proposer dissemination, low-comm: one batched sketch fold
        over all n shards, then per-node (payload_hash, sketch_vec,
        shard) Values — no Merkle tree anywhere."""
        ph = hashlib.sha256(payload).digest()
        sketch_vec = b"".join(self.engine.homhash_batch(shards, ph))
        commitment = lc_commitment(
            ph, sketch_vec, self.netinfo.num_nodes, self.data_shards
        )
        self.lc_payload_hash = ph
        self.lc_sketch_vec = sketch_vec
        step = Step()
        my_shard = None
        for i, nid in enumerate(self.netinfo.node_ids):
            if nid == self.netinfo.our_id:
                my_shard = shards[i]
            else:
                step.to(nid, (MSG_VALUE_LC, (ph, sketch_vec, shards[i])))
        self.value_received = True
        if my_shard is not None:
            step.extend(self._send_echo_lc(commitment, my_shard))
        return step

    def _lc_slice(self, sketch_vec: bytes, idx: int) -> bytes:
        return sketch_vec[idx * SKETCH_BYTES : (idx + 1) * SKETCH_BYTES]

    def _handle_value_lc(self, sender, payload) -> Step:
        if sender != self.proposer_id:
            return Step().fault(sender, "broadcast: Value from non-proposer")
        if self.value_received:
            return Step()
        try:
            ph, sketch_vec, shard = payload
            ph, sketch_vec, shard = bytes(ph), bytes(sketch_vec), bytes(shard)
        except (TypeError, ValueError):
            return Step().fault(sender, "broadcast: malformed Value")
        if (
            len(ph) != 32
            or len(sketch_vec) != self.netinfo.num_nodes * SKETCH_BYTES
        ):
            return Step().fault(sender, "broadcast: malformed Value")
        our_idx = self.netinfo.index(self.netinfo.our_id)
        (got,) = self.engine.homhash_batch([shard], ph)
        if got != self._lc_slice(sketch_vec, our_idx):
            return Step().fault(
                sender, "broadcast: invalid Value shard sketch"
            )
        self.value_received = True
        self.lc_payload_hash = ph
        self.lc_sketch_vec = sketch_vec
        commitment = lc_commitment(
            ph, sketch_vec, self.netinfo.num_nodes, self.data_shards
        )
        return self._send_echo_lc(commitment, shard)

    def _send_echo_lc(self, commitment: bytes, shard: bytes) -> Step:
        if self.echo_sent:
            return Step()
        self.echo_sent = True
        step = Step().broadcast((MSG_ECHO_LC, (commitment, shard)))
        return step.extend(
            self._handle_echo_lc(self.netinfo.our_id, (commitment, shard))
        )

    def _handle_echo_lc(self, sender, payload) -> Step:
        try:
            commitment, shard = payload
            entry = (bytes(commitment), bytes(shard))
        except (TypeError, ValueError):
            return Step().fault(sender, "broadcast: malformed Echo")
        if sender in self.echos:
            if self.echos[sender] != entry:
                return Step().fault(sender, "broadcast: conflicting Echo")
            return Step()
        if not self.netinfo.is_validator(sender):
            return Step().fault(sender, "broadcast: Echo from non-member")
        # NO per-message crypto here — that is the variant's point; the
        # shard is judged at decode time by one batched sketch fold
        self.echos[sender] = entry
        commitment = entry[0]
        step = Step()
        n, f = self.netinfo.num_nodes, self.netinfo.num_faulty
        # the bracha-variant equivocation observable, verbatim: distinct
        # validated commitments within one instance mean the proposer
        # disseminated two codings or an echoer forged one
        if not self._mixed_roots_flagged and any(
            e[0] != commitment for e in self.echos.values()
        ):
            self._mixed_roots_flagged = True
            self.obs.instant("rbc_mixed_roots")
            step.fault(
                self.proposer_id,
                "broadcast: mixed echo roots (proposer equivocation "
                "or forged echo)",
            )
        if self._count_echos_lc(commitment) >= n - f and not self.ready_sent:
            step.extend(self._send_ready_lc(commitment))
        if (
            self._count_readys(commitment) >= quorum_intersect(n, f)
            and self._count_echos_lc(commitment) >= self.data_shards
        ):
            step.extend(self._try_decode_lc(commitment))
        return step

    def _send_ready_lc(self, commitment: bytes) -> Step:
        if self.ready_sent:
            return Step()
        self.ready_sent = True
        step = Step().broadcast((MSG_READY_LC, commitment))
        return step.extend(
            self._handle_ready_lc(self.netinfo.our_id, commitment)
        )

    def _handle_ready_lc(self, sender, commitment: bytes) -> Step:
        if sender in self.readys:
            if self.readys[sender] != commitment:
                return Step().fault(sender, "broadcast: conflicting Ready")
            return Step()
        self.readys[sender] = commitment
        step = Step()
        n, f = self.netinfo.num_nodes, self.netinfo.num_faulty
        if (
            self._count_readys(commitment) >= quorum_exists(n, f)
            and not self.ready_sent
        ):
            step.extend(self._send_ready_lc(commitment))
        if (
            self._count_readys(commitment) >= quorum_intersect(n, f)
            and self._count_echos_lc(commitment) >= self.data_shards
        ):
            step.extend(self._try_decode_lc(commitment))
        return step

    def _count_echos_lc(self, commitment: bytes) -> int:
        return sum(1 for e in self.echos.values() if e[0] == commitment)

    def _try_decode_lc(self, commitment: bytes) -> Step:
        """Decode attempt: ONE batched sketch fold filters every
        candidate shard, then erasure-decode + full commitment re-check.
        Retries harmlessly as more echoes arrive (nothing is consumed);
        safety rests on the SHA-256 re-derivation, never the sketch."""
        if self.decided:
            return Step()
        step = Step()
        candidates: Dict[int, Tuple] = {}  # shard index -> (sender, shard)
        for sender, entry in self.echos.items():
            if entry[0] == commitment and sender not in self._lc_rejected:
                candidates[self.netinfo.index(sender)] = (sender, entry[1])
        if not candidates:
            return step
        # honest echoes of one coding share a shard length; outliers
        # are skipped (they cannot stack into the decode anyway)
        lengths = [len(s) for _, s in candidates.values()]
        shard_len = max(set(lengths), key=lengths.count)
        ordered = sorted(
            (idx, c)
            for idx, c in candidates.items()
            if len(c[1]) == shard_len
        )
        have_vec = (
            self.lc_sketch_vec is not None
            and self.lc_payload_hash is not None
            and lc_commitment(
                self.lc_payload_hash,
                self.lc_sketch_vec,
                self.netinfo.num_nodes,
                self.data_shards,
            )
            == commitment
        )
        # unchanged inputs -> unchanged outcome: a Ready arriving with
        # the same candidate set (and no newly-installed sketch vector)
        # must not re-pay the fold + k+1 attempt sweep — one forged
        # echo must never buy hundreds of re-decodes
        fp = (commitment, have_vec, tuple(idx for idx, _c in ordered))
        if fp == self._lc_fail_fp:
            return step
        if have_vec:
            # the batched fold: every peer's shard for this instance in
            # one engine call (kernel B1 on the GPU engine)
            sketches = self.engine.homhash_batch(
                [c[1] for _idx, c in ordered], self.lc_payload_hash
            )
            kept = []
            for (idx, c), got in zip(ordered, sketches):
                if got == self._lc_slice(self.lc_sketch_vec, idx):
                    kept.append((idx, c))
                else:
                    # a garbage shard under the true commitment: LOUD,
                    # once — the sender joins _lc_rejected so retries
                    # neither re-fold nor re-fault it
                    self._lc_rejected.add(c[0])
                    self.obs.instant("rbc_sketch_reject")
                    step.fault(
                        c[0], "broadcast: invalid shard sketch"
                    )
            ordered = kept
        if len(ordered) < self.data_shards:
            # sketch rejections may have dropped us below k: remember
            # the sweep input so an unchanged retry exits above
            self._lc_fail_fp = fp
            return step
        # decode attempts: the full candidate set first, then — because
        # an 8-byte public-matrix sketch admits OFFLINE collisions, so
        # a forged shard CAN survive the filter — bounded leave-one-out
        # over the base subset.  The instance never terminalizes on a
        # failed attempt: a Byzantine echoer must not be able to kill
        # an honest proposer's broadcast (nor get the proposer blamed);
        # colluding multi-forger collisions can only STALL it (liveness,
        # loud), never decide a wrong payload — binding is re-derived
        # below from the decoded bytes every time.
        k = self.data_shards
        base = ordered[:k]
        attempts = [ordered]
        for drop_pos in range(len(base)):
            if len(ordered) - 1 >= k:
                attempts.append(
                    base[:drop_pos] + base[drop_pos + 1 :] + ordered[k:]
                )
        decoded = None
        for subset in attempts:
            decoded = self._lc_attempt(subset, commitment)
            if decoded is not None:
                break
        if decoded is None:
            self._lc_fail_fp = fp
            self.obs.instant("rbc_undecodable")
            if not self._lc_mismatch_flagged:
                self._lc_mismatch_flagged = True
                # attribution is genuinely ambiguous here (proposer
                # inconsistency OR forged sketch-colliding echoes);
                # the kind records that, the instance stays LIVE
                step.fault(
                    self.proposer_id,
                    "broadcast: root mismatch (inconsistent coding or "
                    "sketch-colliding echo)",
                )
            return step
        payload, ph, full, vec = decoded
        # post-decode attribution: the decoded codeword is now ground
        # truth, so any echoed shard that differs from its true row is
        # PROVABLY forged — including one that beat the sketch filter
        for idx, c in ordered:
            if c[1] != full[idx]:
                self._lc_rejected.add(c[0])
                self.obs.instant("rbc_sketch_reject")
                step.fault(c[0], "broadcast: invalid shard sketch")
        self.decided = True
        self.payload = payload
        self.lc_payload_hash = ph
        self.lc_sketch_vec = vec
        self.obs.end("rbc", ok=True, payload_bytes=len(payload))
        step.output.append(payload)
        return step

    def _lc_attempt(self, subset, commitment: bytes):
        """One decode attempt from an explicit shard subset: decode,
        then re-derive payload hash + re-encoded shards + sketch vector
        + commitment from the decoded bytes (THE binding check).
        Returns (payload, ph, full_shards, sketch_vec) on success,
        None on any mismatch."""
        slots = [None] * self.netinfo.num_nodes
        for idx, c in subset:
            slots[idx] = c[1]
        try:
            payload = self.engine.rs_reconstruct_data(
                slots, self.data_shards, self.parity_shards
            )
        except ValueError:
            return None
        ph = hashlib.sha256(payload).digest()
        full = self.engine.rs_encode_bytes(
            payload, self.data_shards, self.parity_shards
        )
        vec = b"".join(self.engine.homhash_batch(full, ph))
        if (
            lc_commitment(ph, vec, self.netinfo.num_nodes, self.data_shards)
            != commitment
        ):
            return None
        return payload, ph, full, vec

    @property
    def terminated(self) -> bool:
        return self.decided
