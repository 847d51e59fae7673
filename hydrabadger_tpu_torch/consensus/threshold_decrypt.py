"""ThresholdDecrypt: collaborative decryption of one ciphertext.

The port's copy of hydrabadger_tpu/consensus/threshold_decrypt.py,
hbbft's `threshold_decrypt` equivalent: HoneyBadger's output stage
decrypts each agreed contribution this way.
"""
from __future__ import annotations

from typing import Dict, Hashable, Optional, TypeVar

from ..crypto.engine import get_engine
from ..crypto.threshold import Ciphertext, DecryptionShare
from ..obs.recorder import resolve as _resolve_recorder
from .types import NetworkInfo, Step, dkg_degree, guarded_handler

N = TypeVar("N", bound=Hashable)

MSG_DEC_SHARE = "td_share"


class ThresholdDecrypt:
    def __init__(
        self,
        netinfo: NetworkInfo,
        verify_shares: bool = True,
        engine=None,
        recorder=None,
    ):
        self.netinfo = netinfo
        self.verify_shares = verify_shares
        self.engine = get_engine(engine)
        self.obs = _resolve_recorder(recorder)
        self._span_open = False
        self.ciphertext: Optional[Ciphertext] = None
        self.shares: Dict = {}
        self.pending: Dict = {}  # shares that arrived before the ciphertext
        self._verified: set = set()  # senders whose shares passed the batch
        self.terminated = False
        self.plaintext: Optional[bytes] = None

    def set_ciphertext(self, ct: Ciphertext, check: bool = True) -> Step:
        """Install the ciphertext and contribute our share."""
        if self.ciphertext is not None:
            return Step()
        if check and not ct.verify():
            raise ValueError("invalid ciphertext")
        self._obs_open()
        self.ciphertext = ct
        step = Step()
        if self.netinfo.sk_share is not None:
            share = self.engine.decrypt_share(self.netinfo.sk_share, ct)
            step.broadcast((MSG_DEC_SHARE, share.to_bytes()))
            step.extend(self._handle_share(self.netinfo.our_id, share))
        for sender, share in list(self.pending.items()):
            step.extend(self._handle_share(sender, share))
        self.pending.clear()
        return step

    @guarded_handler("threshold_decrypt")
    def handle_message(self, sender, message) -> Step:
        kind, payload = message[0], message[1]
        self._obs_open()
        if kind != MSG_DEC_SHARE:
            return Step().fault(sender, f"threshold_decrypt: unknown {kind!r}")
        try:
            share = DecryptionShare.from_bytes(bytes(payload))
        except ValueError:
            return Step().fault(sender, "threshold_decrypt: bad share bytes")
        if self.ciphertext is None:
            prior = self.pending.get(sender)
            if prior is not None and prior.to_bytes() != share.to_bytes():
                # pre-ciphertext equivocation: keep the first share so
                # the overwrite can't launder the conflict past the
                # quorum-time check in _handle_share
                return Step().fault(
                    sender, "threshold_decrypt: conflicting share"
                )
            self.pending[sender] = share
            return Step()
        return self._handle_share(sender, share)

    def _obs_open(self) -> None:
        if not self._span_open:
            self._span_open = True
            self.obs.begin("tdec")

    def _handle_share(self, sender, share: DecryptionShare) -> Step:
        """Share verification is DEFERRED to quorum time: hbbft verifies
        each share on arrival (2 pairings each); here arriving shares are
        queued and the whole quorum is checked in one aggregated
        2-pairing test (engine.verify_decryption_shares_batch), with a
        per-share fallback attributing faults to exactly the same
        senders the eager path would have flagged."""
        if self.terminated:
            return Step()
        if sender in self.shares:
            # a second, DIFFERENT share from the same sender is
            # equivocation (a duplicate of the first is routine replay
            # noise and stays silent)
            if self.shares[sender].to_bytes() != share.to_bytes():
                return Step().fault(
                    sender, "threshold_decrypt: conflicting share"
                )
            return Step()
        idx = self.netinfo.index(sender)
        if idx is None:
            return Step().fault(sender, "threshold_decrypt: not a validator")
        self.shares[sender] = share
        return self._try_decrypt()

    def _try_decrypt(self) -> Step:
        t = self.netinfo.pk_set.threshold
        if self.terminated or len(self.shares) < dkg_degree(t):
            return Step()
        step = Step()
        if self.verify_shares:
            unverified = [
                nid for nid in self.shares if nid not in self._verified
            ]
            if unverified:
                oks = self.engine.verify_decryption_shares_batch(
                    [
                        self.netinfo.pk_set.public_key_share(
                            self.netinfo.index(nid)
                        )
                        for nid in unverified
                    ],
                    [self.shares[nid] for nid in unverified],
                    self.ciphertext,
                )
                for nid, ok in zip(unverified, oks):
                    if ok:
                        self._verified.add(nid)
                    else:
                        del self.shares[nid]
                        step.fault(nid, "threshold_decrypt: invalid share")
            if len(self.shares) < dkg_degree(t):
                return step
        plaintext = self.engine.combine_decryption_shares(
            self.netinfo.pk_set,
            {self.netinfo.index(nid): s for nid, s in self.shares.items()},
            self.ciphertext,
        )
        self.terminated = True
        self.plaintext = plaintext
        self.obs.end("tdec", shares=len(self.shares))
        step.output.append(plaintext)
        return step
