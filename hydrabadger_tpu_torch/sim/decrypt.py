"""One HoneyBadger epoch's threshold decryption, every ciphertext at once.

HoneyBadger hides each proposer's contribution until the common subset is
agreed: every proposer threshold-encrypts its contribution to the
network's key, and after agreement every node publishes a decryption
share U * sk_i of every accepted ciphertext, and any t + 1 shares combine
in the exponent to U * master, which unwraps the plaintext
(hbbft::threshold_decrypt; hydrabadger_tpu/consensus/threshold_decrypt.py).
`DecryptRound` runs that work for a whole epoch through the port's
`GpuEngine`, as the JAX package's TpuEngine batches it:

    share     n_nodes x proposers shares sk_i * U_j, one G1 GLV ladder
              (one `glv_ladder` launch of kernel B2)
    combine   one Lagrange combine of t + 1 shares per ciphertext, one
              windowed ladder over the t + 1 x proposers terms and the
              pairwise tree (1 + 5 launches at t + 1 = 22)

At `DecryptConfig()` (64 nodes, each proposing one contribution: the
config-8 geometry) that is 4096 shares and 64 combines of 22.  The key
set comes from `random.Random(seed)` in the JAX sim's order
(`SecretKeySet.random`), then the contributions, their encryptions and
the quorums (t + 1 distinct nodes per ciphertext, so the Lagrange sets
differ) from the same generator.  Set-up is the host's: the key set, t + 1
G1 multiplies for the public keys and one pure-Python encryption per
proposer (two G1 multiplies, a hash onto G2 and a G2 multiply, ~90 ms).
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from ..crypto import threshold as th
from ..crypto.bls12_381 import eq, mul_sub
from ..crypto.engine import GpuEngine
from ..ops import bls_torch, fq_torch
from ..ops.bls_g2_torch import scalars_to_windows


@dataclass(frozen=True)
class DecryptConfig:
    """An N-node network's threshold decryption of one epoch: every node
    proposes one contribution of `contribution_bytes` bytes."""

    n_nodes: int = 64
    contribution_bytes: int = 64

    @property
    def threshold(self) -> int:
        return (self.n_nodes - 1) // 3


class DecryptRound:
    """The batched threshold decryption on a `GpuEngine(device, use_kernel)`."""

    def __init__(self, cfg: Optional[DecryptConfig] = None, device="cuda", seed: int = 0,
                 use_kernel: bool = True):
        cfg = cfg or DecryptConfig()
        self.cfg = cfg
        self.engine = GpuEngine(device, use_kernel)
        rng = random.Random(seed)
        n, t = cfg.n_nodes, cfg.threshold
        sk_set = th.SecretKeySet.random(t, rng)
        self._master = sk_set.secret_key().scalar
        self._sks = [sk_set.secret_key_share(i) for i in range(n)]
        self.pk_set = sk_set.public_keys()  # t + 1 host G1 multiplies
        pk = self.pk_set.public_key()
        self.contributions = [rng.getrandbits(8 * cfg.contribution_bytes).to_bytes(
            cfg.contribution_bytes, "big") for _ in range(n)]
        self.ciphertexts = [pk.encrypt(m, rng) for m in self.contributions]
        self.quorums = [sorted(rng.sample(range(n), t + 1)) for _ in range(n)]
        self.shares: list = []
        self.plaintexts: List[bytes] = []
        # the last run's device results: [3, 12, n_nodes * proposers] shares
        # and [3, 12, proposers] combined points U * master
        self.shares_limbs: Optional[torch.Tensor] = None
        self.combined_limbs: Optional[torch.Tensor] = None
        self.last_launches: Dict[str, int] = {}

    def items(self) -> list:
        """The share batch: item j*n + i is node i's share of ciphertext j."""
        return [(sk, ct) for ct in self.ciphertexts for sk in self._sks]

    def lagrange(self) -> List[List[int]]:
        """Each ciphertext's quorum's Lagrange coefficients at zero."""
        return [th.lagrange_coeffs_at_zero([i + 1 for i in q]) for q in self.quorums]

    def plan(self) -> Dict[str, List[bls_torch.Launch]]:
        """Every B2 launch of a round, from the digits: {"share": the GLV
        ladder's, "combine": the weighted sum's}."""
        sk_scalars = [sk.scalar for sk, _ct in self.items()]
        lams = self.lagrange()
        q = self.cfg.threshold + 1
        # term s of job b at lane s*B + b (bls_torch.weighted_sum_operands)
        coeffs = [lams[b][s] for s in range(q) for b in range(len(lams))]
        return {"share": bls_torch.glv_plan(bls_torch.glv_windows(sk_scalars)),
                "combine": bls_torch.weighted_sum_plan(scalars_to_windows(coeffs), q)}

    def run(self) -> List[bytes]:
        """Every share, then every ciphertext's combine and unwrap; returns
        the plaintexts in proposer order."""
        n = self.cfg.n_nodes
        before = fq_torch.launches
        self.shares_limbs, pending = self.engine.dispatch_decrypt_share_batch(self.items())
        shared = fq_torch.launches
        shares = pending.result()
        jobs = [(self.pk_set, {i: shares[j * n + i] for i in q}, ct)
                for j, (q, ct) in enumerate(zip(self.quorums, self.ciphertexts))]
        self.combined_limbs, combined = self.engine.dispatch_combine_decryption_shares_batch(jobs)
        self.plaintexts = combined.result()
        self.last_launches = {"share": shared - before, "combine": fq_torch.launches - shared}
        self.shares = shares
        return self.plaintexts

    def oracle_check(self, share_idx: Sequence[int]) -> bool:
        """Hold the shares at `share_idx` against host mul_sub(U_j, sk_i),
        every combined point against U_j * master and every plaintext
        against the contribution encrypted."""
        if not self.shares:
            raise RuntimeError("oracle_check needs a run first")
        n = self.cfg.n_nodes
        for k in share_idx:
            j, i = divmod(k, n)
            if not eq(self.shares[k].point, mul_sub(self.ciphertexts[j].u, self._sks[i].scalar)):
                return False
        combined = bls_torch.to_host(self.combined_limbs)
        return self.plaintexts == self.contributions and all(
            eq(g, mul_sub(ct.u, self._master)) for g, ct in zip(combined, self.ciphertexts))
