"""One common-coin round for every binary-agreement instance of an epoch.

Binary agreement takes its coin from a threshold BLS signature over G2:
every node signs the round's coin document with its key share, any t+1
shares Lagrange-combine to the unique master signature, and the coin is
the signature's parity (hydrabadger_tpu/consensus/threshold_sign.py,
`Signature.parity`).  `CoinRound` runs that work for all instances of an
epoch at once through the port's `GpuEngine`, as the JAX package's
TpuEngine batches it:

    sign      n_nodes x instances shares sk_i * H(doc_j), one G2 ladder
              (one `ladder` launch of kernel B4)
    combine   one Lagrange combine of t+1 shares per instance, one ladder
              over the t+1 x instances terms and the pairwise tree
              (1 + 5 launches at t + 1 = 22)

At `CoinConfig()` (64 nodes x 64 instances, the config-8 geometry of the
JAX bench applied to the coin) that is 4096 shares and 64 combines of 22,
7 launches (`plan` lists them from the digits).  The key set comes from `random.Random(seed)` in the JAX
sim's order (`SecretKeySet.random`), the quorums from the same generator
after it (t + 1 distinct nodes per instance, so the Lagrange sets
differ).  Each document is hashed onto G2 once, at set-up (pure Python,
~28 ms each), so a timed `run()` holds no hashing.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from ..crypto import threshold as th
from ..crypto.bls12_381 import eq, mul_sub
from ..crypto.engine import GpuEngine
from ..ops import bls_g2_torch, fq2_torch
from ..ops.roofline import Launch


def coin_doc(epoch: int, instance: int, rnd: int) -> bytes:
    """The coin document of ABA instance `instance` (proposer) of HoneyBadger
    epoch `epoch` in round `rnd`: b"ABA-COIN" + session id + round, with
    HoneyBadger's session ids b"hb/<epoch>/<proposer>"."""
    return b"ABA-COIN" + b"hb/%d/%d" % (epoch, instance) + rnd.to_bytes(4, "big")


@dataclass(frozen=True)
class CoinConfig:
    """An N-node network's first coin round (round 0 of epoch 0) for every
    one of `instances` ABA instances."""

    n_nodes: int = 64
    instances: int = 64

    @property
    def threshold(self) -> int:
        return (self.n_nodes - 1) // 3


class CoinRound:
    """The batched coin round on a `GpuEngine(device, use_kernel)`."""

    def __init__(self, cfg: Optional[CoinConfig] = None, device="cuda", seed: int = 0,
                 use_kernel: bool = True):
        cfg = cfg or CoinConfig()
        self.cfg = cfg
        self.engine = GpuEngine(device, use_kernel)
        rng = random.Random(seed)
        n, t = cfg.n_nodes, cfg.threshold
        sk_set = th.SecretKeySet.random(t, rng)
        self._master = sk_set.secret_key().scalar
        self._sks = [sk_set.secret_key_share(i) for i in range(n)]
        self.pk_set = sk_set.public_keys()  # t + 1 host G1 multiplies
        self.quorums = [sorted(rng.sample(range(n), t + 1)) for _ in range(cfg.instances)]
        self.docs = [coin_doc(0, j, 0) for j in range(cfg.instances)]
        for doc in self.docs:  # set-up: the engine caches each H(doc)
            self.engine.hash_to_g2(doc)
        self.shares: list = []
        self.signatures: list = []
        # the last run's device results: [3, 2, 12, n_nodes * instances]
        # shares and [3, 2, 12, instances] combined signatures
        self.shares_limbs: Optional[torch.Tensor] = None
        self.signatures_limbs: Optional[torch.Tensor] = None
        self.coins: list = []
        self.last_launches: dict = {}

    def plan(self) -> Dict[str, List[Launch]]:
        """Every B4 launch of a round, from the digits: {"sign": the share
        ladder's, "combine": the weighted sum's}."""
        q = self.cfg.threshold + 1
        sign = [sk.scalar for _doc in self.docs for sk in self._sks]
        lams = [th.lagrange_coeffs_at_zero([i + 1 for i in qu]) for qu in self.quorums]
        # term s of job b at lane s*B + b (bls_g2_torch.weighted_sum_operands)
        coeffs = [lams[b][s] for s in range(q) for b in range(len(lams))]
        return {"sign": bls_g2_torch.scalar_mul_plan(bls_g2_torch.scalars_to_windows(sign)),
                "combine": bls_g2_torch.weighted_sum_plan(
                    bls_g2_torch.scalars_to_windows(coeffs), q)}

    def run(self):
        """Sign every share, combine every instance's quorum; returns the
        instances' signatures and coin bits.  Share j*n + i is node i's
        share of instance j."""
        n = self.cfg.n_nodes
        items = [(sk, doc) for doc in self.docs for sk in self._sks]
        before = fq2_torch.launches
        self.shares_limbs, pending = self.engine.dispatch_sign_share_batch(items)
        signed = fq2_torch.launches
        shares = pending.result()
        jobs = [(self.pk_set, {i: shares[j * n + i] for i in q}) for j, q in enumerate(self.quorums)]
        self.signatures_limbs, combined = self.engine.dispatch_combine_signature_shares_batch(jobs)
        sigs = combined.result()
        self.last_launches = {"sign": signed - before, "combine": fq2_torch.launches - signed}
        self.shares, self.signatures = shares, sigs
        self.coins = [s.parity() for s in sigs]
        return sigs, self.coins

    def oracle_check(self, share_idx: Sequence[int]) -> bool:
        """Hold the shares at `share_idx` against host mul_sub(H(doc), sk_i)
        and every combined signature against master * H(doc)."""
        if not self.signatures:
            raise RuntimeError("oracle_check needs a run first")
        n = self.cfg.n_nodes
        for k in share_idx:
            j, i = divmod(k, n)
            want = mul_sub(self.engine.hash_to_g2(self.docs[j]), self._sks[i].scalar)
            if not eq(self.shares[k].point, want):
                return False
        return all(
            sig == th.Signature(mul_sub(self.engine.hash_to_g2(doc), self._master))
            for sig, doc in zip(self.signatures, self.docs)
        )
