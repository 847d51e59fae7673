"""QueueingHoneyBadger: a transaction queue feeding HoneyBadger epochs.

The port's copy of hydrabadger_tpu/consensus/queueing.py, hbbft's
`queueing_honey_badger` equivalent.  Transactions are pushed
into a local queue; each epoch proposes a bounded random sample from the
queue front (randomisation de-correlates proposers so the union covers
the queue), and committed transactions are pruned everywhere.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Hashable, List, TypeVar

from ..obs.latency import (
    STAGE_ADMITTED, STAGE_COMMITTED, STAGE_PROPOSED, txn_id,
)
from ..utils import codec
from .honey_badger import Batch, HoneyBadger
from .types import NetworkInfo, Step

N = TypeVar("N", bound=Hashable)


class QueueingHoneyBadger:
    def __init__(
        self,
        netinfo: NetworkInfo,
        batch_size: int = 100,
        session_id: bytes = b"qhb",
        encrypt: bool = True,
        coin_mode: str = "threshold",
        verify_shares: bool = True,
        rng=None,
        auto_propose: bool = True,
        engine=None,
        recorder=None,
        rbc_variant=None,
        lifecycle=None,
    ):
        self.netinfo = netinfo
        self.batch_size = max(1, batch_size)
        self.rng = rng
        self.auto_propose = auto_propose
        # sans-io txn-lifecycle ledger (obs/latency.py): the core NOTES
        # identity-tagged inclusion events with no timestamps; the I/O
        # boundary stamps them — the recorder contract, per-transaction
        self.lifecycle = lifecycle
        self.queue: "OrderedDict[bytes, None]" = OrderedDict()
        self.hb = HoneyBadger(
            netinfo,
            session_id=session_id,
            encrypt=encrypt,
            coin_mode=coin_mode,
            verify_shares=verify_shares,
            engine=engine,
            recorder=recorder,
            rbc_variant=rbc_variant,
        )
        self.batches: List[Batch] = []

    # -- API ----------------------------------------------------------------

    def push_transaction(self, txn: bytes, rng=None) -> Step:
        """Queue a transaction; kicks off an epoch if none is in flight."""
        self.queue[bytes(txn)] = None
        if self.lifecycle is not None:
            self.lifecycle.note_stage(txn_id(txn), STAGE_ADMITTED)
        rng = rng or self.rng
        if rng is not None:
            return self._maybe_propose(rng)
        return Step()

    def handle_message(self, sender, message) -> Step:
        step = self.hb.handle_message(sender, message)
        return self._filter(step)

    def force_propose(self, rng) -> Step:
        """Propose for the current epoch even if the queue is empty."""
        return self._filter(self._propose(rng))

    def external_contribution(self, rng) -> bytes:
        """The payload this node would propose, for an external (native) ACS
        run that bypasses the message plane."""
        return codec.encode(tuple(self._sample(rng)))

    def apply_external_batch(self, contributions: dict) -> Step:
        """Apply an externally agreed epoch (the native ACS core)."""
        return self._filter(self.hb.apply_external_batch(contributions))

    # -- internals ----------------------------------------------------------

    def _sample(self, rng) -> List[bytes]:
        """Random sample of the queue front (avalanche-avoidance: sample
        batch_size items from the first `batch_size * num_nodes`)."""
        window = list(self.queue.keys())[
            : self.batch_size * max(1, self.netinfo.num_nodes)
        ]
        per_node = max(1, self.batch_size // max(1, self.netinfo.num_nodes))
        picked = (
            window if len(window) <= per_node
            else rng.sample(window, per_node)
        )
        if self.lifecycle is not None:
            for t in picked:
                self.lifecycle.note_stage(txn_id(t), STAGE_PROPOSED)
        return picked

    def _propose(self, rng) -> Step:
        contribution = codec.encode(tuple(self._sample(rng)))
        return self.hb.propose(contribution, rng)

    def _maybe_propose(self, rng) -> Step:
        if self.hb.has_input.get(self.hb.epoch):
            return Step()
        return self._filter(self._propose(rng))

    def _decode_batches(self, step: Step) -> list:
        """Decode committed contributions in-place; prune the queue."""
        out = []
        for item in step.output:
            if not isinstance(item, Batch):
                continue
            contributions = {}
            for proposer, payload in item.contributions.items():
                try:
                    txns = [bytes(t) for t in codec.decode(bytes(payload))]
                except (ValueError, TypeError):
                    continue  # malformed contribution: proposer's loss
                contributions[proposer] = txns
                for t in txns:
                    self.queue.pop(t, None)
                    # committed-batch membership, for EVERY txn in the
                    # batch: only the submitting node holds the open
                    # record, foreign ids resolve to nothing
                    if self.lifecycle is not None:
                        self.lifecycle.note_stage(txn_id(t), STAGE_COMMITTED)
            batch = Batch(item.epoch, contributions)
            self.batches.append(batch)
            out.append(batch)
        step.output = out
        return out

    def _filter(self, step: Step) -> Step:
        committed = self._decode_batches(step)
        # a committed batch opens the next epoch: keep the pipeline moving
        # while transactions remain queued (hbbft re-proposes on output);
        # iterative so instantly-committing topologies (n=1) don't recurse
        while (
            committed
            and self.auto_propose
            and self.rng is not None
            and self.queue
            and not self.hb.has_input.get(self.hb.epoch)
        ):
            sub = self._propose(self.rng)
            committed = self._decode_batches(sub)
            step.messages.extend(sub.messages)
            step.fault_log.extend(sub.fault_log)
            step.output.extend(sub.output)
        return step

    @property
    def epoch(self) -> int:
        return self.hb.epoch
