"""Subset (Asynchronous Common Subset, ACS).

The port's copy of hydrabadger_tpu/consensus/subset.py, hbbft's `subset`
equivalent: one Reliable
Broadcast per proposer disseminates contributions; one Binary Agreement
per proposer decides membership.  A proposer's slot enters the subset
when its ABA decides 1; once N-f slots have decided 1, the node votes 0
for every remaining slot.  The final output — identical at every correct
node — is the set of (proposer, payload) pairs whose ABA decided 1.

All N broadcast + N ABA instances per node are independent state
machines.
"""
from __future__ import annotations

from typing import Dict, Hashable, Optional, TypeVar

from ..obs.recorder import resolve as _resolve_recorder
from .binary_agreement import BinaryAgreement
from .broadcast import Broadcast
from .types import NetworkInfo, Step, guarded_handler

N = TypeVar("N", bound=Hashable)

MSG = "cs"


class Subset:
    def __init__(
        self,
        netinfo: NetworkInfo,
        session_id: bytes,
        coin_mode: str = "threshold",
        verify_coin_shares: bool = True,
        engine=None,
        recorder=None,
        rbc_variant=None,
    ):
        self.netinfo = netinfo
        self.session_id = bytes(session_id)
        self.obs = _resolve_recorder(recorder)
        self._span_open = False
        # each child instance gets the recorder bound to its proposer
        # slot, so RBC/BA spans correlate to a subset lane without the
        # child cores knowing the schema
        self.broadcasts: Dict = {
            nid: Broadcast(
                netinfo,
                nid,
                engine=engine,
                recorder=self.obs.bind(instance=i),
                variant=rbc_variant,
            )
            for i, nid in enumerate(netinfo.node_ids)
        }
        self.agreements: Dict = {
            nid: BinaryAgreement(
                netinfo,
                self.session_id + b"/" + str(i).encode(),
                coin_mode=coin_mode,
                verify_coin_shares=verify_coin_shares,
                engine=engine,
                recorder=self.obs.bind(instance=i),
            )
            for i, nid in enumerate(netinfo.node_ids)
        }
        self.broadcast_results: Dict = {}
        self.ba_results: Dict = {}
        self._accepted = 0  # count of True decisions (O(1) global check)
        self._voted_zero = False  # the N-f vote-0 sweep fires once
        self.decided = False
        self.result: Optional[dict] = None

    # -- API ----------------------------------------------------------------

    def propose(self, value: bytes) -> Step:
        """Contribute our payload (validators only)."""
        self._obs_open()
        bc = self.broadcasts.get(self.netinfo.our_id)
        if bc is None:
            return Step()
        step = bc.broadcast(value).map_messages(
            lambda m: self._wrap(self.netinfo.our_id, m)
        )
        step.output.clear()
        return Step().extend(step).extend(self._progress())

    @guarded_handler("subset")
    def handle_message(self, sender, message) -> Step:
        _tag, pidx, inner = message[0], int(message[1]), message[2]
        self._obs_open()
        if not 0 <= pidx < self.netinfo.num_nodes:
            return Step().fault(sender, "subset: bad proposer index")
        proposer = self.netinfo.node_ids[pidx]
        step = Step()
        if inner[0].startswith("bc_"):
            sub = self.broadcasts[proposer].handle_message(sender, inner)
        elif inner[0] == "ba":
            sub = self.agreements[proposer].handle_message(sender, inner)
        else:
            return step.fault(sender, f"subset: unknown inner {inner[0]!r}")
        step.extend(self._relabel(proposer, sub))
        # incremental progress: only the touched proposer's instances can
        # have changed state; the full O(N) sweep runs only on the global
        # transitions it flags (threshold reached / completion possible).
        # At N=64 the full sweep per message made the logic tier O(N^3)
        # with an O(N) constant — the dominant sim cost.
        step.extend(self._progress_one(proposer))
        return step

    # -- internals ----------------------------------------------------------

    def _obs_open(self) -> None:
        if not self._span_open:
            self._span_open = True
            self.obs.begin("subset")

    def _wrap(self, proposer, message) -> tuple:
        return (MSG, self.netinfo.index(proposer), message)

    def _relabel(self, proposer, sub: Step) -> Step:
        """Tag a sub-protocol step's messages; consume its outputs."""
        sub.map_messages(lambda m: self._wrap(proposer, m))
        sub.output.clear()
        return sub

    def _progress_one(self, proposer) -> Step:
        """Incremental _progress: fold in state changes of ONE proposer's
        broadcast/agreement, then run only the (rare, one-shot) global
        transitions.  Equivalent to the full sweep because a message can
        only change the instance it was routed to; self-generated
        sub-steps re-fold incrementally, and the full sweep remains for
        propose() and for _global_transitions' own cascades."""
        step = Step()
        bc = self.broadcasts.get(proposer)
        if (
            bc is not None
            and proposer not in self.broadcast_results
            and bc.terminated
            and bc.payload is not None
        ):
            self.broadcast_results[proposer] = bc.payload
            ba = self.agreements[proposer]
            if ba.estimate is None and not ba.terminated:
                step.extend(self._relabel(proposer, ba.propose(True)))
        ba = self.agreements.get(proposer)
        if ba is not None and proposer not in self.ba_results and ba.terminated:
            self._record_decision(proposer, ba.decision)
        step.extend(self._global_transitions())
        # sub-steps above may have terminated the touched instances
        if step.messages and not self.decided:
            step.extend(self._progress_one(proposer))
        return step

    def _record_decision(self, proposer, decision) -> None:
        self.ba_results[proposer] = decision
        if decision:
            self._accepted += 1  # O(1) for the per-message global check

    def _progress(self) -> Step:
        """Drive cross-instance rules; idempotent (full sweep)."""
        step = Step()
        # capture broadcast payloads
        for nid, bc in self.broadcasts.items():
            if nid not in self.broadcast_results and bc.terminated:
                payload = bc.payload
                if payload is not None:
                    self.broadcast_results[nid] = payload
                    ba = self.agreements[nid]
                    if ba.estimate is None and not ba.terminated:
                        step.extend(
                            self._relabel(nid, ba.propose(True))
                        )
        # capture ABA decisions
        for nid, ba in self.agreements.items():
            if nid not in self.ba_results and ba.terminated:
                self._record_decision(nid, ba.decision)
        step.extend(self._global_transitions())
        # newly-produced sub-steps may have terminated more instances
        if step.messages and not self.decided:
            step.extend(self._progress())
        return step

    def _global_transitions(self) -> Step:
        """One-shot network-wide rules, driven by cheap counters."""
        step = Step()
        # N-f slots accepted: vote 0 everywhere else
        if self._accepted >= self.netinfo.num_correct and not self._voted_zero:
            self._voted_zero = True
            for nid, ba in self.agreements.items():
                if ba.estimate is None and not ba.terminated:
                    step.extend(self._relabel(nid, ba.propose(False)))
        # completion: all ABAs decided, and payloads present for accepted
        if not self.decided and len(self.ba_results) == self.netinfo.num_nodes:
            pending = [
                nid
                for nid, dec in self.ba_results.items()
                if dec and nid not in self.broadcast_results
            ]
            if not pending:
                self.decided = True
                self.result = {
                    nid: self.broadcast_results[nid]
                    for nid, dec in sorted(self.ba_results.items())
                    if dec
                }
                self.obs.end("subset", accepted=len(self.result))
                step.output.append(self.result)
        # newly-produced sub-steps may have terminated more instances
        if step.messages and not self.decided:
            step.extend(self._progress())
        return step

    @property
    def terminated(self) -> bool:
        return self.decided
