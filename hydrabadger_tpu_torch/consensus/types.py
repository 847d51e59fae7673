"""Shared types for the pure sans-io consensus cores (the port's copy of
hydrabadger_tpu/consensus/types.py, the scenario plane's fault taxonomy
included).

Every protocol exposes methods returning a `Step`, the contract mirrored
from hbbft's `CpStep`: a batch of outbound `TargetedMessage`s, any
protocol `output`, and a `fault_log` of observed misbehaviour.  Cores
never touch sockets, clocks or ambient randomness; all effects flow
through Steps and explicit rng arguments.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, FrozenSet, Generic, Hashable, List, Optional, TypeVar

N = TypeVar("N", bound=Hashable)


@dataclass(frozen=True)
class Target(Generic[N]):
    """Message routing target: all peers, all-except, or an explicit set."""

    kind: str  # "all" | "all_except" | "nodes"
    nodes: FrozenSet[N] = frozenset()

    @classmethod
    def all(cls) -> "Target":
        return cls("all")

    @classmethod
    def all_except(cls, nodes) -> "Target":
        return cls("all_except", frozenset(nodes))

    @classmethod
    def node(cls, node) -> "Target":
        return cls("nodes", frozenset([node]))

    @classmethod
    def nodes_(cls, nodes) -> "Target":
        return cls("nodes", frozenset(nodes))

    def includes(self, node: N) -> bool:
        if self.kind == "all":
            return True
        if self.kind == "all_except":
            return node not in self.nodes
        return node in self.nodes


@dataclass(frozen=True)
class TargetedMessage(Generic[N]):
    target: Target[N]
    message: Any


@dataclass(frozen=True)
class Fault(Generic[N]):
    node_id: N
    kind: str


# -- Byzantine fault-kind taxonomy ------------------------------------------
#
# Canonical tokens naming each injectable fault class of the adversarial
# scenario plane (sim/scenario.py, sim/byzantine.py, net/chaos.py).  The
# cores' fault_log kinds stay free-form protocol strings ("broadcast: ...");
# these tokens name the INJECTION side, and the scenario verifier
# (sim/scenario.py:FAULT_OBSERVABLES) maps every token to the observable
# that proves the system noticed or absorbed it.

BYZ_EQUIVOCATION = "equivocation"  # conflicting RBC Value/Echo to disjoint sets
BYZ_GARBAGE_SHARE = "garbage_share"  # attacker-chosen G1 point as a tdec share
BYZ_WITHHELD_SHARE = "withheld_share"  # own decryption share never sent
BYZ_DKG_CORRUPT = "dkg_corrupt"  # malformed Part/Ack in committed contributions
BYZ_REPLAY_FLOOD = "replay_flood"  # other senders' frames replayed as our own
BYZ_KEYGEN_WITHHOLD = "keygen_withhold"  # own DKG Parts/Acks never shipped
BYZ_LINK_DROP = "link_drop"  # per-link loss (breaks the reliable-delivery model)
BYZ_LINK_DUP = "link_dup"  # per-link duplication
BYZ_LINK_DELAY = "link_delay"  # per-link hold/reorder
BYZ_PARTITION = "partition"  # cross-group traffic held until heal
# wire-tier-only kinds (net/chaos.py): injectable at the real socket
# boundary, unreachable from the sim router's lossless message plane
BYZ_LINK_RESET = "link_reset"  # connection torn down mid-stream (TCP RST)
BYZ_SIG_CORRUPT = "sig_corrupt"  # frame signature bit-flipped in flight
BYZ_CRASH = "crash_restart"  # validator killed and restarted from checkpoint
# process-tier-only kind: injectable only where each validator is a real OS
# process whose environment a supervisor owns
BYZ_CLOCK_SKEW = "clock_skew"  # per-node wall-clock offset/drift injected

BYZ_KINDS = frozenset({
    BYZ_EQUIVOCATION, BYZ_GARBAGE_SHARE, BYZ_WITHHELD_SHARE, BYZ_DKG_CORRUPT,
    BYZ_REPLAY_FLOOD, BYZ_KEYGEN_WITHHOLD, BYZ_LINK_DROP, BYZ_LINK_DUP,
    BYZ_LINK_DELAY, BYZ_PARTITION, BYZ_LINK_RESET, BYZ_SIG_CORRUPT, BYZ_CRASH,
    BYZ_CLOCK_SKEW,
})


@dataclass
class Step(Generic[N]):
    """The sole output channel of a protocol core."""

    messages: List[TargetedMessage[N]] = field(default_factory=list)
    output: List[Any] = field(default_factory=list)
    fault_log: List[Fault[N]] = field(default_factory=list)

    def send(self, target: Target[N], message: Any) -> "Step[N]":
        self.messages.append(TargetedMessage(target, message))
        return self

    def broadcast(self, message: Any) -> "Step[N]":
        return self.send(Target.all(), message)

    def to(self, node: N, message: Any) -> "Step[N]":
        return self.send(Target.node(node), message)

    def fault(self, node_id: N, kind: str) -> "Step[N]":
        self.fault_log.append(Fault(node_id, kind))
        return self

    def extend(self, other: "Step[N]") -> "Step[N]":
        self.messages.extend(other.messages)
        self.output.extend(other.output)
        self.fault_log.extend(other.fault_log)
        return self

    def map_messages(self, fn) -> "Step[N]":
        """Wrap each message payload (e.g. tag with an instance id)."""
        self.messages = [
            TargetedMessage(tm.target, fn(tm.message)) for tm in self.messages
        ]
        return self

    @classmethod
    def empty(cls) -> "Step[N]":
        return cls()


def quorum_exists(n: int, f: int) -> int:
    """Existence quorum: among any ``f + 1`` distinct senders at least
    one is honest.  ``n`` is accepted for call-site symmetry with
    :func:`quorum_intersect`; under ``n = 3f + 1`` the bound is
    independent of it."""
    return f + 1


def quorum_intersect(n: int, f: int) -> int:
    """Intersection quorum: any two sets of ``2f + 1`` distinct senders
    share at least one honest node (``n = 3f + 1``; the ``n - f``
    rendering of the same class stays inline where the wait-for-all-
    correct reading is the point)."""
    return 2 * f + 1


def dkg_degree(t: int) -> int:
    """Interpolation threshold: ``t + 1`` shares determine a degree-t
    polynomial — the combine gate of threshold signing/decryption and
    the committed-DKG readiness gate."""
    return t + 1


def guarded_handler(protocol: str):
    """Decorator for `handle_message(self, sender, message)`: a malformed
    message from a Byzantine peer must yield a fault entry, never an
    exception escaping the core (one bad frame must not crash a node).
    The exception text is preserved in the fault kind for diagnosis.
    """

    def deco(fn):
        def wrapper(self, sender, message):
            try:
                return fn(self, sender, message)
            except (ValueError, TypeError, AttributeError, IndexError, KeyError) as e:
                return Step().fault(
                    sender, f"{protocol}: malformed message ({type(e).__name__}: {e})"
                )

        wrapper.__name__ = fn.__name__
        wrapper.__doc__ = fn.__doc__
        return wrapper

    return deco


class NetworkInfo(Generic[N]):
    """Static per-era network topology + key material.

    The analogue of hbbft's `NetworkInfo`: sorted validator list,
    this node's id and (optional — observers lack one) secret key share,
    and the era's master `PublicKeySet`.
    """

    def __init__(self, our_id: N, node_ids, pk_set, sk_share=None):
        self.our_id = our_id
        self.node_ids = sorted(node_ids)
        self.pk_set = pk_set
        self.sk_share = sk_share
        self._index = {nid: i for i, nid in enumerate(self.node_ids)}

    @property
    def num_nodes(self) -> int:
        return len(self.node_ids)

    @property
    def num_faulty(self) -> int:
        return (len(self.node_ids) - 1) // 3

    @property
    def num_correct(self) -> int:
        return len(self.node_ids) - self.num_faulty

    def index(self, node_id: N) -> Optional[int]:
        return self._index.get(node_id)

    def our_index(self) -> Optional[int]:
        return self._index.get(self.our_id)

    def is_validator(self, node_id: Optional[N] = None) -> bool:
        nid = self.our_id if node_id is None else node_id
        return nid in self._index

    def public_key_share(self, node_id: N):
        return self.pk_set.public_key_share(self._index[node_id])
