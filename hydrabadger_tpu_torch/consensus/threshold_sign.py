"""ThresholdSign: collaborative BLS signature — the common coin.

The port's copy of hydrabadger_tpu/consensus/threshold_sign.py, hbbft's
`threshold_sign` equivalent (reached through BinaryAgreement's coin).  Each validator contributes a signature
share over an agreed document; any t+1 verified shares combine into the
unique master signature, whose hash parity is an unpredictable common
coin.  Share verification is pairing-heavy: the engine checks a quorum
with one aggregated two-pairing test.
"""
from __future__ import annotations

from typing import Dict, Hashable, Optional, TypeVar

from ..crypto.engine import get_engine
from ..crypto.threshold import Signature, SignatureShare
from .types import NetworkInfo, Step, dkg_degree, guarded_handler

N = TypeVar("N", bound=Hashable)

MSG_SHARE = "ts_share"


class ThresholdSign:
    def __init__(
        self,
        netinfo: NetworkInfo,
        doc: bytes,
        verify_shares: bool = True,
        engine=None,
    ):
        self.netinfo = netinfo
        self.doc = bytes(doc)
        self.verify_shares = verify_shares
        self.engine = get_engine(engine)
        self.shares: Dict = {}  # node -> SignatureShare
        self._verified: set = set()  # senders whose shares passed the batch
        self.had_input = False
        self.terminated = False
        self.signature: Optional[Signature] = None

    def sign(self) -> Step:
        """Contribute our share (validators only; observers just listen)."""
        if self.had_input:
            return Step()
        self.had_input = True
        if self.netinfo.sk_share is None:
            return Step()
        share = self.engine.sign_share(self.netinfo.sk_share, self.doc)
        step = Step().broadcast((MSG_SHARE, share.to_bytes()))
        return step.extend(self._handle_share(self.netinfo.our_id, share))

    @guarded_handler("threshold_sign")
    def handle_message(self, sender, message) -> Step:
        kind, payload = message[0], message[1]
        if kind != MSG_SHARE:
            return Step().fault(sender, f"threshold_sign: unknown {kind!r}")
        try:
            share = SignatureShare.from_bytes(bytes(payload))
        except ValueError:
            return Step().fault(sender, "threshold_sign: undecodable share")
        return self._handle_share(sender, share)

    def _handle_share(self, sender, share: SignatureShare) -> Step:
        """Verification is deferred to quorum time and batched: the whole
        quorum is checked in one aggregated 2-pairing test
        (engine.verify_signature_shares_batch) instead of 2 pairings per
        share, with per-share fallback for fault attribution."""
        if self.terminated or sender in self.shares:
            return Step()
        idx = self.netinfo.index(sender)
        if idx is None:
            return Step().fault(sender, "threshold_sign: not a validator")
        self.shares[sender] = share
        return self._try_combine()

    def _try_combine(self) -> Step:
        t = self.netinfo.pk_set.threshold
        if self.terminated or len(self.shares) < dkg_degree(t):
            return Step()
        step = Step()
        if self.verify_shares:
            unverified = [
                nid for nid in self.shares if nid not in self._verified
            ]
            if unverified:
                oks = self.engine.verify_signature_shares_batch(
                    self.netinfo.pk_set,
                    [self.netinfo.index(nid) for nid in unverified],
                    [self.shares[nid] for nid in unverified],
                    self.doc,
                )
                for nid, ok in zip(unverified, oks):
                    if ok:
                        self._verified.add(nid)
                    else:
                        del self.shares[nid]
                        step.fault(nid, "threshold_sign: invalid share")
            if len(self.shares) < dkg_degree(t):
                return step
        sig = self.engine.combine_signature_shares(
            self.netinfo.pk_set,
            {self.netinfo.index(nid): s for nid, s in self.shares.items()},
        )
        if not self.verify_shares and not self.engine.verify(
            self.netinfo.pk_set.public_key(), sig, self.doc
        ):
            # optimistic path failed: a bad share slipped in.  Fall back to
            # verifying shares individually and flagging the culprit(s).
            good = {}
            for nid, s in list(self.shares.items()):
                if self.engine.verify_signature_share(
                    self.netinfo.pk_set, self.netinfo.index(nid), s, self.doc
                ):
                    good[nid] = s
                else:
                    del self.shares[nid]
                    step.fault(nid, "threshold_sign: invalid share")
            if len(good) < dkg_degree(t):
                # not enough verified shares left: stay live and wait
                # for more instead of terminating on a bogus combine
                return step
            sig = self.engine.combine_signature_shares(
                self.netinfo.pk_set,
                {self.netinfo.index(nid): s for nid, s in good.items()},
            )
        self.terminated = True
        self.signature = sig
        step.output.append(sig)
        return step

    def coin_value(self) -> Optional[bool]:
        return self.signature.parity() if self.signature else None
