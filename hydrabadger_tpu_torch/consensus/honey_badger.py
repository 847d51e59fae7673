"""HoneyBadger: epochs of ACS over threshold-encrypted contributions.

The port's copy of hydrabadger_tpu/consensus/honey_badger.py, hbbft's
`honey_badger` equivalent: each epoch
every validator threshold-encrypts its contribution (censorship
resistance), proposes the ciphertext into a Subset instance, and the
agreed ciphertexts are collaboratively decrypted.  The epoch's `Batch`
is the map proposer -> decrypted contribution, identical at all correct
nodes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Hashable, List, Optional, TypeVar

from ..crypto.engine import get_engine
from ..crypto.threshold import Ciphertext
from ..obs.recorder import resolve as _resolve_recorder
from .subset import Subset
from .threshold_decrypt import ThresholdDecrypt
from .types import NetworkInfo, Step, guarded_handler

N = TypeVar("N", bound=Hashable)

MSG = "hb"
MAX_FUTURE_EPOCHS = 16


@dataclass(frozen=True)
class Batch:
    """One epoch's agreed output."""

    epoch: int
    contributions: dict  # proposer -> bytes

    def __iter__(self):
        return iter(sorted(self.contributions.items()))


@dataclass
class _EpochState:
    subset: Subset
    decrypts: Dict = field(default_factory=dict)  # proposer -> ThresholdDecrypt
    ciphertexts: Optional[dict] = None
    plaintexts: Dict = field(default_factory=dict)
    batch_done: bool = False
    obs: object = None  # epoch-bound recorder view (obs/recorder.py)


class HoneyBadger:
    def __init__(
        self,
        netinfo: NetworkInfo,
        session_id: bytes = b"hb",
        encrypt: bool = True,
        coin_mode: str = "threshold",
        verify_shares: bool = True,
        start_epoch: int = 0,
        engine=None,
        recorder=None,
        rbc_variant=None,
    ):
        self.netinfo = netinfo
        self.session_id = bytes(session_id)
        self.encrypt = encrypt
        self.coin_mode = coin_mode
        self.verify_shares = verify_shares
        # RBC variant for every broadcast instance this badger spawns
        # (consensus/broadcast.py VARIANTS; None = "bracha")
        self.rbc_variant = rbc_variant
        self.engine = get_engine(engine)
        self.obs = _resolve_recorder(recorder)
        self.epoch = start_epoch
        self.epochs: Dict[int, _EpochState] = {}
        self.has_input: Dict[int, bool] = {}
        # messages beyond the pipelining window (a laggard's view of far-ahead
        # peers); buffered, not dropped — they are never resent
        self.deferred: List[tuple] = []

    # -- API ----------------------------------------------------------------

    def propose(self, contribution: bytes, rng) -> Step:
        """Contribute to the current epoch (validators only)."""
        if not self.netinfo.is_validator() or self.has_input.get(self.epoch):
            return Step()
        self.has_input[self.epoch] = True
        if self.encrypt:
            payload = self.engine.encrypt(
                self.netinfo.pk_set.public_key(), bytes(contribution), rng
            ).to_bytes()
        else:
            payload = bytes(contribution)
        state = self._epoch_state(self.epoch)
        epoch = self.epoch
        sub = state.subset.propose(payload)
        step = self._relabel_cs(epoch, sub)
        step.extend(self._progress(epoch))
        return step

    def apply_external_batch(self, contributions: dict) -> Step:
        """Install the current epoch's result from an external ACS run (the
        native core, sim/native_acs.py): advance the epoch and emit the Batch
        as _progress would.  The unencrypted tier only: the external run
        agrees on plaintext contributions, so there is no decrypt stage."""
        if self.encrypt:
            raise RuntimeError("apply_external_batch requires encrypt=False")
        epoch = self.epoch
        step = Step()
        step.output.append(Batch(epoch, {p: bytes(v) for p, v in sorted(contributions.items())}))
        self.epoch = epoch + 1
        self.epochs.pop(epoch, None)
        self.has_input.pop(epoch, None)
        return step

    @guarded_handler("hb")
    def handle_message(self, sender, message) -> Step:
        if not self.netinfo.is_validator(sender):
            # only validators participate; observers just listen
            return Step().fault(sender, "hb: message from non-validator")
        _tag, epoch, inner = message[0], int(message[1]), message[2]
        if epoch < self.epoch:
            return Step()  # stale epoch; already concluded
        if epoch > self.epoch + MAX_FUTURE_EPOCHS:
            if len(self.deferred) < 100_000:
                self.deferred.append((epoch, sender, message))
            return Step()
        state = self._epoch_state(epoch)
        step = Step()
        if inner[0] == "cs":
            sub = state.subset.handle_message(sender, inner[1])
            step.extend(self._relabel_cs(epoch, sub))
        elif inner[0] == "td":
            pidx = int(inner[1])
            if not 0 <= pidx < self.netinfo.num_nodes:
                return Step().fault(sender, "hb: bad decrypt index")
            proposer = self.netinfo.node_ids[pidx]
            td = self._decrypt_instance(state, proposer)
            sub = td.handle_message(sender, inner[2])
            step.extend(self._relabel_td(epoch, proposer, sub))
        else:
            return Step().fault(sender, f"hb: unknown inner {inner[0]!r}")
        step.extend(self._progress(epoch))
        return step

    # -- internals ----------------------------------------------------------

    def _epoch_state(self, epoch: int) -> _EpochState:
        if epoch not in self.epochs:
            eobs = self.obs.bind(epoch=epoch)
            eobs.begin("epoch")
            self.epochs[epoch] = _EpochState(
                Subset(
                    self.netinfo,
                    self.session_id + b"/" + str(epoch).encode(),
                    coin_mode=self.coin_mode,
                    verify_coin_shares=self.verify_shares,
                    engine=self.engine,
                    recorder=eobs,
                    rbc_variant=self.rbc_variant,
                ),
                obs=eobs,
            )
        return self.epochs[epoch]

    def _decrypt_instance(self, state: _EpochState, proposer) -> ThresholdDecrypt:
        if proposer not in state.decrypts:
            pidx = self.netinfo.index(proposer)
            state.decrypts[proposer] = ThresholdDecrypt(
                self.netinfo,
                verify_shares=self.verify_shares,
                engine=self.engine,
                recorder=state.obs.bind(instance=pidx),
            )
        return state.decrypts[proposer]

    def _relabel_cs(self, epoch: int, sub: Step) -> Step:
        sub.map_messages(lambda m: (MSG, epoch, ("cs", m)))
        sub.output.clear()
        return sub

    def _relabel_td(self, epoch: int, proposer, sub: Step) -> Step:
        pidx = self.netinfo.index(proposer)
        sub.map_messages(lambda m: (MSG, epoch, ("td", pidx, m)))
        sub.output.clear()
        return sub

    def _progress(self, epoch: int) -> Step:
        step = Step()
        state = self.epochs.get(epoch)
        if state is None or state.batch_done:
            return step
        # subset concluded -> start decryption (or finish, if unencrypted)
        if state.ciphertexts is None and state.subset.terminated:
            state.ciphertexts = dict(state.subset.result)
            if self.encrypt:
                for proposer, ct_bytes in state.ciphertexts.items():
                    td = self._decrypt_instance(state, proposer)
                    try:
                        ct = Ciphertext.from_bytes(bytes(ct_bytes))
                        sub = td.set_ciphertext(ct, check=self.verify_shares)
                    except ValueError:
                        # proposer agreed-in garbage: exclude deterministically
                        state.plaintexts[proposer] = None
                        step.fault(proposer, "hb: invalid agreed ciphertext")
                        continue
                    step.extend(self._relabel_td(epoch, proposer, sub))
        if state.ciphertexts is not None:
            if self.encrypt:
                for proposer in state.ciphertexts:
                    if proposer in state.plaintexts:
                        continue
                    td = state.decrypts.get(proposer)
                    if td is not None and td.terminated:
                        state.plaintexts[proposer] = td.plaintext
            else:
                for proposer, payload in state.ciphertexts.items():
                    state.plaintexts[proposer] = bytes(payload)
            if len(state.plaintexts) == len(state.ciphertexts):
                state.batch_done = True
                batch = Batch(
                    epoch,
                    {
                        p: v
                        for p, v in sorted(state.plaintexts.items())
                        if v is not None
                    },
                )
                state.obs.end("epoch", contributions=len(batch.contributions))
                step.output.append(batch)
                if epoch == self.epoch:
                    self.epoch = epoch + 1
                    self.epochs.pop(epoch, None)
                    self.has_input.pop(epoch, None)
                    # replay messages that were beyond the window
                    if self.deferred:
                        pending, self.deferred = self.deferred, []
                        for ep, sender, msg in pending:
                            if ep <= self.epoch + MAX_FUTURE_EPOCHS:
                                step.extend(self.handle_message(sender, msg))
                            else:
                                self.deferred.append((ep, sender, msg))
                    # the next epoch may already be satisfied by buffered
                    # messages; drive it now or it would stall quiescent
                    step.extend(self._progress(self.epoch))
        return step
