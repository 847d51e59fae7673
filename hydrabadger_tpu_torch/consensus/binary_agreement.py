"""Binary Agreement (ABA): Mostéfaoui-Moumen-Raynal with a common coin.

The port's copy of hydrabadger_tpu/consensus/binary_agreement.py,
hbbft's `binary_agreement` equivalent.  Round
structure per epoch r:

  1. BVal broadcast: re-broadcast a value seen from f+1 nodes; a value
     backed by 2f+1 nodes enters `bin_values`.
  2. Aux: once bin_values is non-empty, multicast one element; wait for
     N-f Aux messages whose values are inside bin_values.
  3. Conf: multicast the candidate set; wait for N-f Confs contained in
     bin_values.
  4. Common coin (ThresholdSign over (session, round) — or a hash coin
     for keyless simulation); decide when the candidate set is the
     singleton equal to the coin, else next round with estimate = coin
     or the singleton.

Termination shortcut: deciders multicast Term(b); f+1 matching Terms
decide immediately (covers crashed coin rounds), mirroring hbbft.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, Hashable, Optional, Set, TypeVar

from ..obs.recorder import resolve as _resolve_recorder
from .threshold_sign import ThresholdSign
from .types import (
    NetworkInfo,
    Step,
    guarded_handler,
    quorum_exists,
    quorum_intersect,
)

N = TypeVar("N", bound=Hashable)

MSG = "ba"
MAX_ROUNDS = 200


@dataclass
class _RoundState:
    received_bval: Dict[bool, Set] = field(default_factory=lambda: {False: set(), True: set()})
    sent_bval: Set[bool] = field(default_factory=set)
    bin_values: Set[bool] = field(default_factory=set)
    aux_sent: bool = False
    received_aux: Dict = field(default_factory=dict)  # sender -> bool
    conf_sent: bool = False
    received_conf: Dict = field(default_factory=dict)  # sender -> frozenset
    conf_values: Optional[frozenset] = None
    coin: Optional[ThresholdSign] = None
    coin_invoked: bool = False


class BinaryAgreement:
    """One ABA instance identified by `session_id` (bytes)."""

    def __init__(
        self,
        netinfo: NetworkInfo,
        session_id: bytes,
        coin_mode: str = "threshold",
        verify_coin_shares: bool = True,
        engine=None,
        recorder=None,
    ):
        if coin_mode not in ("threshold", "hash"):
            raise ValueError("coin_mode must be 'threshold' or 'hash'")
        self.netinfo = netinfo
        self.session_id = bytes(session_id)
        self.coin_mode = coin_mode
        self.verify_coin_shares = verify_coin_shares
        self.engine = engine
        self.obs = _resolve_recorder(recorder)
        self._span_open = False
        self.round = 0
        self.estimate: Optional[bool] = None
        self.decision: Optional[bool] = None
        self.terminated = False
        self.rounds: Dict[int, _RoundState] = {}
        self.received_term: Dict[bool, Set] = {False: set(), True: set()}
        self.term_sent = False

    # -- API ----------------------------------------------------------------

    def propose(self, value: bool) -> Step:
        if self.estimate is not None or self.terminated:
            return Step()
        self._obs_open()
        self.estimate = bool(value)
        return self._send_bval(self.round, bool(value))

    @guarded_handler("ba")
    def handle_message(self, sender, message) -> Step:
        _tag, rnd, content = message[0], int(message[1]), message[2]
        self._obs_open()
        kind = content[0]
        if kind == "term":
            # Term is processed even after termination: a node whose
            # round bound exhausted (terminated, decision None) must
            # still be rescuable by f+1 matching Terms, or honest nodes
            # could diverge (one decides in round MAX_ROUNDS-1, another
            # exhausts).  _handle_term is idempotent once decided.
            return self._handle_term(sender, bool(content[1]))
        if self.terminated:
            return Step()
        if rnd >= MAX_ROUNDS:
            return Step().fault(sender, "ba: round out of range")
        if rnd < self.round:
            return Step()  # stale round; outcome already absorbed
        state = self._state(rnd)
        if kind == "bval":
            return self._handle_bval(rnd, state, sender, bool(content[1]))
        if kind == "aux":
            return self._handle_aux(rnd, state, sender, bool(content[1]))
        if kind == "conf":
            vals = frozenset(bool(v) for v in content[1])
            return self._handle_conf(rnd, state, sender, vals)
        if kind == "coin":
            return self._handle_coin_msg(rnd, state, sender, content[1])
        return Step().fault(sender, f"ba: unknown message {kind!r}")

    # -- round machinery ----------------------------------------------------

    def _obs_open(self) -> None:
        if not self._span_open:
            self._span_open = True
            self.obs.begin("ba")

    def _state(self, rnd: int) -> _RoundState:
        if rnd not in self.rounds:
            self.rounds[rnd] = _RoundState()
        return self.rounds[rnd]

    def _msg(self, rnd: int, content) -> tuple:
        return (MSG, rnd, content)

    def _send_bval(self, rnd: int, b: bool) -> Step:
        if self.netinfo.our_index() is None:
            return Step()  # observers track, never speak
        state = self._state(rnd)
        if b in state.sent_bval:
            return Step()
        state.sent_bval.add(b)
        step = Step().broadcast(self._msg(rnd, ("bval", b)))
        return step.extend(self._handle_bval(rnd, state, self.netinfo.our_id, b))

    def _handle_bval(self, rnd, state, sender, b: bool) -> Step:
        if sender in state.received_bval[b]:
            return Step()
        state.received_bval[b].add(sender)
        step = Step()
        count = len(state.received_bval[b])
        n, f = self.netinfo.num_nodes, self.netinfo.num_faulty
        if count == quorum_exists(n, f) and b not in state.sent_bval:
            step.extend(self._send_bval(rnd, b))
        if count == quorum_intersect(n, f):
            first = not state.bin_values
            state.bin_values.add(b)
            if (first and rnd == self.round and not state.aux_sent
                    and self.netinfo.our_index() is not None):
                state.aux_sent = True
                step.broadcast(self._msg(rnd, ("aux", b)))
                step.extend(self._handle_aux(rnd, state, self.netinfo.our_id, b))
            elif rnd == self.round:
                # bin_values grew: the aux/conf counts may now satisfy
                step.extend(self._check_aux(rnd, state))
        return step

    def _handle_aux(self, rnd, state, sender, b: bool) -> Step:
        if sender in state.received_aux:
            return Step()
        state.received_aux[sender] = b
        if rnd != self.round:
            return Step()
        return self._check_aux(rnd, state)

    def _check_aux(self, rnd, state) -> Step:
        """N-f Aux values inside bin_values -> multicast Conf."""
        if state.conf_sent or not state.bin_values or rnd != self.round:
            return Step()
        good = [
            s for s, v in state.received_aux.items() if v in state.bin_values
        ]
        if len(good) < self.netinfo.num_correct:
            return Step()
        vals = frozenset(
            v for s, v in state.received_aux.items() if v in state.bin_values
        )
        if self.netinfo.our_index() is None:
            # observer: move straight to the coin phase bookkeeping
            state.conf_sent = True
            return self._check_conf(rnd, state)
        state.conf_sent = True
        step = Step().broadcast(self._msg(rnd, ("conf", tuple(sorted(vals)))))
        return step.extend(
            self._handle_conf(rnd, state, self.netinfo.our_id, vals)
        )

    def _handle_conf(self, rnd, state, sender, vals: frozenset) -> Step:
        if sender in state.received_conf:
            return Step()
        state.received_conf[sender] = vals
        if rnd != self.round:
            return Step()
        return self._check_conf(rnd, state)

    def _check_conf(self, rnd, state) -> Step:
        if state.coin_invoked or rnd != self.round:
            return Step()
        good = [
            v
            for v in state.received_conf.values()
            if v and v.issubset(state.bin_values)
        ]
        if len(good) < self.netinfo.num_correct:
            return Step()
        state.conf_values = frozenset().union(*good)
        return self._invoke_coin(rnd, state)

    # -- coin ---------------------------------------------------------------

    def _coin_doc(self, rnd: int) -> bytes:
        return b"ABA-COIN" + self.session_id + rnd.to_bytes(4, "big")

    def _invoke_coin(self, rnd, state) -> Step:
        state.coin_invoked = True
        if self.coin_mode == "hash":
            bit = bool(hashlib.sha256(self._coin_doc(rnd)).digest()[0] & 1)
            return self._on_coin(rnd, state, bit)
        if state.coin is None:
            state.coin = ThresholdSign(
                self.netinfo,
                self._coin_doc(rnd),
                self.verify_coin_shares,
                engine=self.engine,
            )
        step = state.coin.sign().map_messages(
            lambda m: self._msg(rnd, ("coin", m))
        )
        step.output.clear()  # the signature is consumed via _drain_coin
        out = self._drain_coin(rnd, state)
        return Step().extend(step).extend(out)

    def _handle_coin_msg(self, rnd, state, sender, inner) -> Step:
        if self.coin_mode == "hash":
            return Step()
        if state.coin is None:
            state.coin = ThresholdSign(
                self.netinfo,
                self._coin_doc(rnd),
                self.verify_coin_shares,
                engine=self.engine,
            )
        step = state.coin.handle_message(sender, inner).map_messages(
            lambda m: self._msg(rnd, ("coin", m))
        )
        step.output.clear()  # the signature is consumed via _drain_coin
        return Step().extend(step).extend(self._drain_coin(rnd, state))

    def _drain_coin(self, rnd, state) -> Step:
        if state.coin is None or not state.coin.terminated:
            return Step()
        if rnd != self.round or not state.coin_invoked:
            return Step()
        if state.conf_values is None:
            return Step()
        bit = state.coin.signature.parity()
        return self._on_coin(rnd, state, bit)

    def _on_coin(self, rnd, state, coin: bool) -> Step:
        if self.terminated or rnd != self.round:
            return Step()
        vals = state.conf_values
        step = Step()
        if vals == frozenset([coin]):
            return step.extend(self._decide(coin))
        if len(vals) == 1:
            (b,) = vals
            self.estimate = b
        else:
            self.estimate = coin
        self.round = rnd + 1
        if self.round >= MAX_ROUNDS:
            # Terminal fault entry, never an exception: a coin-splitting
            # adversary must not be able to crash the node.  `decision`
            # stays None, which Subset records as a not-accepted slot —
            # liveness for this instance is already gone if an adversary
            # kept the coin split for MAX_ROUNDS rounds.
            self.terminated = True
            self.obs.end("ba", rounds=self.round, decision=None)
            return step.fault(
                self.netinfo.our_id,
                "ba: round bound exhausted without agreement",
            )
        step.extend(self._send_bval(self.round, self.estimate))
        step.extend(self._replay_round(self.round))
        return step

    def _replay_round(self, rnd: int) -> Step:
        """Re-evaluate thresholds with messages that arrived early."""
        state = self._state(rnd)
        step = Step()
        # bin_values may already be populated; trigger aux if due
        if (state.bin_values and not state.aux_sent
                and self.netinfo.our_index() is not None):
            b = next(iter(state.bin_values))
            state.aux_sent = True
            step.broadcast(self._msg(rnd, ("aux", b)))
            step.extend(self._handle_aux(rnd, state, self.netinfo.our_id, b))
        step.extend(self._check_aux(rnd, state))
        if state.conf_sent:
            step.extend(self._check_conf(rnd, state))
        step.extend(self._drain_coin(rnd, state))
        return step

    # -- termination --------------------------------------------------------

    def _decide(self, b: bool) -> Step:
        if self.decision is not None:
            return Step()
        self.decision = b
        self.terminated = True
        self.obs.end("ba", rounds=self.round + 1, decision=bool(b))
        step = Step()
        step.output.append(b)
        if not self.term_sent and self.netinfo.our_index() is not None:
            self.term_sent = True
            step.broadcast(self._msg(self.round, ("term", b)))
        return step

    def _handle_term(self, sender, b: bool) -> Step:
        if sender in self.received_term[b]:
            return Step()
        self.received_term[b].add(sender)
        n, f = self.netinfo.num_nodes, self.netinfo.num_faulty
        if (
            len(self.received_term[b]) >= quorum_exists(n, f)
            and self.decision is None
        ):
            return self._decide(b)
        return Step()
