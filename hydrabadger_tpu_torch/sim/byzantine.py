"""ByzantineNode: an honest core wrapped in pluggable attack strategies.

The port's copy of hydrabadger_tpu/sim/byzantine.py, the attack half of the
adversarial scenario plane.  Every random draw is the JAX module's, in its
order, so one seed forges the same points, codings and replays.  A
ByzantineNode runs the REAL honest protocol core underneath — so its
internal state stays coherent and the network topology is undisturbed —
and corrupts only its *outgoing* Steps, exactly the power model of a
Byzantine validator: arbitrary messages, correct delivery.

Strategy catalog (names are the ScenarioSpec vocabulary):

  equivocate      — split-root RBC: conflicting ``Value``/``Echo``
                    shards from two different codings sent to disjoint
                    peer halves (the adversary of arxiv 2404.08070's
                    reduced-communication RBC model);
  garbage_shares  — threshold-decryption shares replaced by attacker-
                    chosen G1 points (valid curve points, wrong shares —
                    the inputs the complete-add MSM/pairing verify plane
                    was built to survive, arxiv 2108.05982's robustness
                    assumption);
  withhold_shares — our decryption share silently never sent;
  dkg_corrupt     — malformed Part/Ack/unknown keygen messages stuffed
                    into our committed contributions;
  replay_flood    — other senders' recent frames replayed under OUR
                    identity at every delivery we handle.

Every injection is recorded in the scenario :class:`InjectionLog`, and
the scenario verifier (sim/scenario.py) asserts each injected kind
surfaced as an observable — fault_log entry, ``byz_faults_*`` counter,
or declared queue high-water.
"""
from __future__ import annotations

import hashlib
import random
from typing import Dict, List, Optional, Tuple

from ..consensus import types as T
from ..consensus.broadcast import (
    MSG_ECHO,
    MSG_ECHO_LC,
    MSG_VALUE,
    MSG_VALUE_LC,
    lc_commitment,
)
from ..consensus.merkle import MerkleTree, Proof
from ..consensus.threshold_decrypt import MSG_DEC_SHARE
from ..consensus.types import Step, Target, TargetedMessage
from .scenario import InjectionLog

# -- nested-message surgery --------------------------------------------------
#
# Sim messages nest as ("dhb", era, ("hb", epoch, ("cs", ("cs", pidx,
# leaf)))) / (..., ("td", pidx, leaf)); every wrapper carries its payload
# LAST.  _rewrite walks to the innermost protocol tuple and hands the
# enclosing subset lane (proposer index) to the callback, so strategies
# can scope attacks to their own RBC instance.

_LEAF_PREFIXES = ("bc_", "td_")


def _rewrite(msg, fn, pidx: Optional[int] = None):
    """Apply ``fn(leaf, pidx) -> leaf`` to the innermost protocol tuple;
    returns ``msg`` unchanged (identity) when ``fn`` declines."""
    if not (isinstance(msg, tuple) and msg and isinstance(msg[0], str)):
        return msg
    kind = msg[0]
    if kind.startswith(_LEAF_PREFIXES):
        out = fn(msg, pidx)
        return msg if out is None else out
    if kind in ("cs", "td") and len(msg) == 3:
        pidx = int(msg[1])
    if len(msg) >= 2:
        sub = _rewrite(msg[-1], fn, pidx)
        if sub is not msg[-1]:
            return msg[:-1] + (sub,)
    return msg


# -- strategies --------------------------------------------------------------


class Strategy:
    """One attack behaviour.  Hooks are all optional overrides."""

    kind: str = ""

    def __init__(self, rng: random.Random, log: InjectionLog):
        self.rng = rng
        self.log = log

    def on_receive(self, node: "ByzantineNode", sender, message) -> None:
        """Observe an inbound delivery (before the core handles it)."""

    def before_propose(self, node: "ByzantineNode") -> None:
        """Tamper with the core's state ahead of a proposal."""

    def mutate_step(self, node: "ByzantineNode", step: Step) -> Step:
        """Rewrite the outgoing step (the attack's wire surface)."""
        return step


class EquivocateRbc(Strategy):
    """Split-root broadcast: peers at even indexes get shards/echoes of
    the real coding, peers at odd indexes get a second, conflicting
    coding — disjoint peer sets, two roots, one instance.  Attacks BOTH
    RBC dialects: the Merkle variant (two trees) and the low-comm
    variant (two sketch commitments — the adversary model of arxiv
    2404.08070; the mixed-commitment detector must fire identically)."""

    kind = T.BYZ_EQUIVOCATION

    def __init__(self, rng, log):
        super().__init__(rng, log)
        self._alt: Dict[bytes, MerkleTree] = {}  # real root -> alt tree
        self._alt_lc: Dict[bytes, tuple] = {}  # commitment -> lc artifacts

    def _alt_payload_shards(self, node: "ByzantineNode", root: bytes):
        netinfo = node.netinfo
        n, f = netinfo.num_nodes, netinfo.num_faulty
        payload = hashlib.sha256(b"byz-equivocation" + root).digest() * 4
        return payload, node.hb.engine.rs_encode_bytes(
            payload, n - 2 * f, 2 * f
        )

    def _alt_tree(self, node: "ByzantineNode", root: bytes) -> MerkleTree:
        tree = self._alt.get(root)
        if tree is not None:
            return tree
        if len(self._alt) > 64:
            self._alt.clear()  # bounded: one live instance per epoch
        _payload, shards = self._alt_payload_shards(node, root)
        tree = MerkleTree(shards)
        self._alt[root] = tree
        return tree

    def _alt_coding_lc(self, node: "ByzantineNode", commitment: bytes):
        """(ph2, vec2, commitment2, shards2): a SELF-CONSISTENT second
        coding — every forged shard matches its own sketch vector, so
        only the cross-commitment detector can catch it."""
        art = self._alt_lc.get(commitment)
        if art is not None:
            return art
        if len(self._alt_lc) > 64:
            self._alt_lc.clear()
        netinfo = node.netinfo
        n, f = netinfo.num_nodes, netinfo.num_faulty
        payload, shards = self._alt_payload_shards(node, commitment)
        ph2 = hashlib.sha256(payload).digest()
        vec2 = b"".join(node.hb.engine.homhash_batch(shards, ph2))
        commitment2 = lc_commitment(ph2, vec2, n, n - 2 * f)
        art = (ph2, vec2, commitment2, shards)
        self._alt_lc[commitment] = art
        return art

    def _forged_leaf(self, node, leaf, r_idx: int):
        """The odd-half replacement for one RBC leaf, both dialects."""
        netinfo = node.netinfo
        n, f = netinfo.num_nodes, netinfo.num_faulty
        if leaf[0] in (MSG_VALUE, MSG_ECHO):
            proof = Proof.from_wire(leaf[1])
            alt = self._alt_tree(node, proof.root).proof(proof.index)
            return (leaf[0], alt.wire()) + tuple(leaf[2:])
        if leaf[0] == MSG_VALUE_LC:
            ph, vec, _shard = leaf[1]
            real = lc_commitment(bytes(ph), bytes(vec), n, n - 2 * f)
            ph2, vec2, _c2, shards2 = self._alt_coding_lc(node, real)
            # a Value carries the RECIPIENT's shard
            return (leaf[0], (ph2, vec2, shards2[r_idx]))
        # MSG_ECHO_LC: our echo carries OUR shard under the commitment
        our_idx = netinfo.index(netinfo.our_id)
        real = bytes(leaf[1][0])
        _ph2, _vec2, c2, shards2 = self._alt_coding_lc(node, real)
        return (leaf[0], (c2, shards2[our_idx]))

    def mutate_step(self, node: "ByzantineNode", step: Step) -> Step:
        netinfo = node.netinfo
        our_idx = netinfo.index(netinfo.our_id)
        out: List[TargetedMessage] = []
        for tm in step.messages:
            leaf_seen: List[tuple] = []

            def probe(leaf, pidx):
                if pidx == our_idx and leaf[0] in (
                    MSG_VALUE,
                    MSG_ECHO,
                    MSG_VALUE_LC,
                    MSG_ECHO_LC,
                ):
                    leaf_seen.append(leaf)
                return None

            _rewrite(tm.message, probe)
            if not leaf_seen:
                out.append(tm)
                continue
            forged = 0
            for rid in netinfo.node_ids:
                if rid == netinfo.our_id or not tm.target.includes(rid):
                    continue
                r_idx = netinfo.index(rid)
                if r_idx % 2 == 0:
                    out.append(TargetedMessage(Target.node(rid), tm.message))
                    continue
                # odd half: same leaf kind, conflicting coding
                alt_leaf = self._forged_leaf(node, leaf_seen[0], r_idx)

                def swap(lf, pidx):
                    if lf is not leaf_seen[0]:
                        return None
                    return alt_leaf

                out.append(
                    TargetedMessage(
                        Target.node(rid), _rewrite(tm.message, swap)
                    )
                )
                forged += 1
            if forged:
                self.log.note(self.kind, forged)
        step.messages = out
        return step


class GarbageShares(Strategy):
    """Replace our outgoing decryption shares with attacker-chosen G1
    points: valid curve encodings (they travel the complete-add batch
    verify plane), cryptographically wrong shares."""

    kind = T.BYZ_GARBAGE_SHARE

    def _garbage_point_bytes(self) -> bytes:
        from ..crypto.bls12_381 import G1, R, g1_to_bytes, mul_sub

        return g1_to_bytes(mul_sub(G1, self.rng.randrange(1, R)))

    def mutate_step(self, node: "ByzantineNode", step: Step) -> Step:
        forged = 0

        def swap(leaf, _pidx):
            nonlocal forged
            if leaf[0] != MSG_DEC_SHARE:
                return None
            forged += 1
            return (leaf[0], self._garbage_point_bytes())

        step.messages = [
            TargetedMessage(tm.target, _rewrite(tm.message, swap))
            for tm in step.messages
        ]
        if forged:
            self.log.note(self.kind, forged)
        return step


class WithholdShares(Strategy):
    """Never send (a fraction of) our decryption shares.  Undetectable
    by design in an asynchronous system — the declared observable is the
    injection counter (scenario.SELF_COUNTING_KINDS)."""

    kind = T.BYZ_WITHHELD_SHARE

    def __init__(self, rng, log, rate: float = 0.5):
        # default withholds HALF the shares so a scenario combining
        # withhold_shares with garbage_shares exercises both kinds
        # (list withhold FIRST: garbage only corrupts what survives)
        super().__init__(rng, log)
        self.rate = rate

    def mutate_step(self, node: "ByzantineNode", step: Step) -> Step:
        kept: List[TargetedMessage] = []
        withheld = 0
        for tm in step.messages:
            has_share: List[tuple] = []

            def probe(leaf, _pidx):
                if leaf[0] == MSG_DEC_SHARE:
                    has_share.append(leaf)
                return None

            _rewrite(tm.message, probe)
            if has_share and self.rng.random() < self.rate:
                withheld += 1
                continue
            kept.append(tm)
        step.messages = kept
        if withheld:
            self.log.note(self.kind, withheld)
        return step


class DkgCorrupt(Strategy):
    """Stuff malformed keygen traffic into our committed contributions:
    an undecodable Part, an Ack for proposer 0 with garbage values, and
    an unknown-kind message — once per (era, keygen session)."""

    kind = T.BYZ_DKG_CORRUPT

    def __init__(self, rng, log):
        super().__init__(rng, log)
        self._stuffed_eras: set = set()

    def before_propose(self, node: "ByzantineNode") -> None:
        core = node.unwrap()
        key_gen = getattr(core, "key_gen", None)
        pending = getattr(core, "pending_kg", None)
        if key_gen is None or pending is None:
            return
        era = getattr(core, "era", 0)
        if era in self._stuffed_eras:
            return
        if len(self._stuffed_eras) > 1024:
            self._stuffed_eras.clear()  # bounded across very long runs
        self._stuffed_eras.add(era)
        garbage = [
            ("part", b"\x00byz-garbage-commitment", (b"row0",)),
            ("ack", 0, (b"byz-garbage-value",)),
            ("byz_unknown_kind", 1),
        ]
        pending.extend(garbage)
        self.log.note(self.kind, len(garbage))


class KeygenWithhold(Strategy):
    """Never ship our DKG traffic: pending keygen messages (our Part,
    our Acks, our cutover marker) are cleared before every proposal, so
    the shadow DKG this node should feed starves.  With enough
    withholding colluders the era switch stalls FOREVER while the
    current era keeps committing — the scenario the shadow-DKG stall
    observable exists for: the contract requires the stall to surface
    loudly (``dhb: shadow keygen stalled`` faults + the
    ``shadow_dkg_stall_epochs`` gauge), never to wedge the commit
    path."""

    kind = T.BYZ_KEYGEN_WITHHOLD

    def before_propose(self, node: "ByzantineNode") -> None:
        core = node.unwrap()
        pending = getattr(core, "pending_kg", None)
        if pending:
            self.log.note(self.kind, len(pending))
            pending.clear()


class ReplayFlood(Strategy):
    """Replay other senders' recent frames under OUR identity, ``burst``
    per handled delivery — the sim analogue of the wire-replay floods
    the node's ``_last_replay_t`` backoff and queue caps bound."""

    kind = T.BYZ_REPLAY_FLOOD

    def __init__(self, rng, log, burst: int = 1, history: int = 64):
        super().__init__(rng, log)
        from collections import deque

        self.burst = burst
        self.history = deque(maxlen=history)

    def on_receive(self, node: "ByzantineNode", sender, message) -> None:
        if sender != node.netinfo.our_id:
            self.history.append(message)

    def mutate_step(self, node: "ByzantineNode", step: Step) -> Step:
        if not self.history:
            return step
        peers = [
            nid
            for nid in node.netinfo.node_ids
            if nid != node.netinfo.our_id
        ]
        if not peers:
            return step
        for _ in range(self.burst):
            old = self.history[self.rng.randrange(len(self.history))]
            step.messages.append(
                TargetedMessage(
                    Target.node(peers[self.rng.randrange(len(peers))]), old
                )
            )
        self.log.note(self.kind, self.burst)
        return step


STRATEGIES = {
    "equivocate": EquivocateRbc,
    "garbage_shares": GarbageShares,
    "withhold_shares": WithholdShares,
    "dkg_corrupt": DkgCorrupt,
    "keygen_withhold": KeygenWithhold,
    "replay_flood": ReplayFlood,
}


def build_strategies(
    names, rng: random.Random, log: InjectionLog
) -> Tuple[Strategy, ...]:
    try:
        return tuple(STRATEGIES[name](rng, log) for name in names)
    except KeyError as e:
        raise ValueError(
            f"unknown Byzantine strategy {e.args[0]!r}; "
            f"catalog: {sorted(STRATEGIES)}"
        ) from None


# -- the node wrapper --------------------------------------------------------


class ByzantineNode:
    """Wraps an honest QueueingHoneyBadger/DynamicHoneyBadger; every
    outgoing Step passes through the strategy pipeline.  All other
    attributes delegate, so the sim drives it exactly like the honest
    node it impersonates.  The wire tier mounts the same wrapper over a
    real ``net/`` node's consensus core (net/chaos.ByzantineHydrabadger),
    so one strategy catalog attacks both planes."""

    def __init__(self, node, strategies: Tuple[Strategy, ...], log=None):
        self._node = node
        self._strategies = tuple(strategies)
        self.injection_log = log

    def unwrap(self):
        """The honest core underneath (strategies tamper via this)."""
        return self._node

    def _mutate(self, step: Step) -> Step:
        for s in self._strategies:
            step = s.mutate_step(self, step)
        return step

    # -- the sim's driving surface, corrupted --------------------------------

    def handle_message(self, sender, message) -> Step:
        """Inbound delivery (lint: attacker-taint source — ``message``
        is adversary-relayed protocol data, same as the honest path)."""
        for s in self._strategies:
            s.on_receive(self, sender, message)
        return self._mutate(self._node.handle_message(sender, message))

    def propose(self, contribution, rng) -> Step:
        for s in self._strategies:
            s.before_propose(self)
        return self._mutate(self._node.propose(contribution, rng))

    def force_propose(self, rng) -> Step:
        for s in self._strategies:
            s.before_propose(self)
        return self._mutate(self._node.force_propose(rng))

    def push_transaction(self, txn, rng=None) -> Step:
        return self._mutate(self._node.push_transaction(txn, rng))

    # -- transparent delegation ----------------------------------------------

    def __getstate__(self):
        """Explicit: without this, pickle's protocol lookups would fall
        through __getattr__ to the WRAPPED node's __getstate__ and
        checkpoint the honest core as if it were the wrapper."""
        return self.__dict__

    def __setstate__(self, state):
        self.__dict__.update(state)

    def __getattr__(self, name):
        node = self.__dict__.get("_node")
        if node is None:  # mid-unpickle: nothing to delegate to yet
            raise AttributeError(name)
        attr = getattr(node, name)
        if name == "drain_async":
            # tick-boundary settle of in-flight device work: its step
            # is wire traffic like any other (the TCP runtime dispatches
            # it onto real sockets), so it travels the strategy pipeline
            # too.  Resolved HERE, not as a method, so cores without the
            # hbasync plane (QueueingHoneyBadger) keep raising
            # AttributeError and the sim's feature detection still works.
            # Only steps CARRYING traffic are mutated: traffic-minting
            # strategies (replay_flood) appending to every empty drain
            # would turn the router's quiescence drain into a livelock.
            def _drain():
                step = attr()
                return self._mutate(step) if step.messages else step

            return _drain
        return attr
