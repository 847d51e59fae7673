"""Device-resident tensor simulator — the fault-free fast-path epoch.

Counterpart of the fast path of hydrabadger_tpu/sim/tensor.py
(`TensorSimConfig`, `_epoch`, `_run_epochs`, `TensorSim`,
`cpu_fast_path_epoch`).  With no faults and timely delivery every
Reliable Broadcast completes and every Binary Agreement decides 1 in its
first round, so an epoch's outcome — every node commits the batch of all
N proposals — is fixed by the data plane: RS-encode each proposal into N
shards, disseminate (node j holds shard j of every proposal), rebuild
every proposal from k shards, and check totality on the device.

Shapes (B instances of an N-node network, k data + p parity shards,
L-byte shards):

    proposals   [B, N, k, L]   uint8   (node i's contribution, sharded)
    encoded     [B, N, n, L]           one GF matmul (ops/rs_torch)
    received    [B, n, N, L]           dissemination: a view of encoded
    decoded     [B, N, k, L]           one GF matmul from a k-quorum
    ok          [B]             bool   totality check

Epochs chain through a Python loop (the next epoch's proposals derive
from the previous decode); the totality flags are AND-ed on the device,
so `TensorSim.run` syncs with the host once per call, not once per
epoch.  The initial state comes from the same numpy stream as the JAX
package's, so the two simulators agree byte for byte.

`FullCryptoTensorSim` (below) is the other half of an epoch with
threshold encryption on: every node's decryption share of every
proposer's ciphertext and their Lagrange combine (bench config 8), on
ops/decrypt_torch, or with `HYDRABADGER_DECRYPT_T=0` on the generic
full-crypto epoch (`build_full_crypto_epoch`).  With
`FullCryptoConfig(verify=True)` every decryption share and every
ciphertext is checked by a pairing inside the epoch, while `faulty`
nodes send forged shares (ops/verify_torch.VerifiedEpoch).
"""
from __future__ import annotations

import os
import random
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..crypto import bls12_381 as bls
from ..crypto import threshold as th
from ..crypto.rs import ReedSolomon
from ..device import resolve_device
from ..obs import metrics as M
from ..ops import bls_torch, decrypt_torch, fq_torch, limbs, rs_torch, verify_torch
from ..ops.decrypt_torch import JAC_EQ_MULS, Launch


@dataclass(frozen=True)
class TensorSimConfig:
    n_nodes: int = 64
    instances: int = 1024
    shard_len: int = 32  # L; payload per node = k * L (256 B at N=64)
    seed: int = 0

    @property
    def f(self) -> int:
        return (self.n_nodes - 1) // 3

    @property
    def data_shards(self) -> int:
        return self.n_nodes - 2 * self.f

    @property
    def parity_shards(self) -> int:
        return 2 * self.f


def _initial_proposals(cfg: TensorSimConfig) -> np.ndarray:
    rng = np.random.default_rng(cfg.seed)
    return rng.integers(
        0,
        256,
        (cfg.instances, cfg.n_nodes, cfg.data_shards, cfg.shard_len),
    ).astype(np.uint8)


def epoch(proposals: torch.Tensor, k: int, p: int, use_kernel: bool = True):
    """One fast-path epoch for every instance at once.

    proposals: [B, N, k, L] -> (decoded [B, N, k, L], ok [B])
    """
    B, N, _k, L = proposals.shape
    n = k + p
    # 1. every node RS-encodes its proposal (fold nodes into the batch)
    encoded = rs_torch.rs_encode_batch(
        proposals.reshape(B * N, k, L), k, p, use_kernel
    ).reshape(B, N, n, L)
    # 2. dissemination: node j ends up holding shard j of every proposal.
    #    The JAX package materialises this swap and the one below; here
    #    both stay views of `encoded` (the same bytes at the same indices),
    #    and the reconstruct reads them through their strides.
    received = encoded.transpose(1, 2)  # [B, n(holder), N(proposer), L]
    # 3. every node reconstructs every proposal from k gathered shards,
    #    from the parity-heavy quorum (the worst case), so the real
    #    reconstruction matmul runs — the systematic rows would be the
    #    data verbatim
    rows = tuple(range(p, n))  # all parity + tail data rows
    parity_quorum = received[:, p:n].transpose(1, 2)  # [B, N, k, L] view
    decoded = rs_torch.rs_reconstruct_batch(
        parity_quorum.reshape(B * N, k, L), rows, k, p, use_kernel
    ).reshape(B, N, k, L)
    # 4. totality/agreement: every instance's decode matches its proposals
    ok = (decoded == proposals).reshape(B, -1).all(dim=-1)
    return decoded, ok


def run_epochs(
    proposals: torch.Tensor, k: int, p: int, epochs: int, use_kernel: bool = True
):
    """Chain `epochs` fast-path epochs; returns (final state, ok).

    The next epoch's proposals are a byte-rotation of the decode, XOR 1,
    as in the JAX package.  `ok` is a 0-d bool tensor on the device: the
    AND of every instance's totality flag over every epoch."""
    ok = torch.ones((), dtype=torch.bool, device=proposals.device)
    state = proposals
    for _ in range(epochs):
        decoded, ok_epoch = epoch(state, k, p, use_kernel)
        ok &= ok_epoch.all()
        state = torch.roll(decoded, 1, -1) ^ 1
    return state, ok


class TensorSim:
    """B-instance fast-path HoneyBadger network resident on one device.

    `use_kernel=False` runs the plain PyTorch version of the GF kernel on
    the device instead (the reference the kernel is held against)."""

    def __init__(
        self,
        cfg: Optional[TensorSimConfig] = None,
        device="cuda",
        use_kernel: bool = True,
    ):
        self.cfg = cfg or TensorSimConfig()
        self.device = resolve_device(device)
        self.use_kernel = use_kernel
        self._state = torch.from_numpy(_initial_proposals(self.cfg)).to(self.device)

    @classmethod
    def from_jax_state(
        cls,
        state: np.ndarray,
        cfg: TensorSimConfig,
        device="cuda",
        use_kernel: bool = True,
    ) -> "TensorSim":
        """Resume from a JAX `TensorSim._state` read as numpy
        ([instances, n_nodes, data_shards, shard_len] uint8)."""
        state = np.asarray(state)
        want = (cfg.instances, cfg.n_nodes, cfg.data_shards, cfg.shard_len)
        if state.shape != want or state.dtype != np.uint8:
            raise ValueError(f"expected uint8 {want}, got {state.dtype} {state.shape}")
        sim = cls.__new__(cls)
        sim.cfg = cfg
        sim.device = resolve_device(device)
        sim.use_kernel = use_kernel
        sim._state = torch.from_numpy(state.copy()).to(sim.device)
        return sim

    def run(self, epochs: int) -> bool:
        """Run epochs on the device; returns the totality verdict (all
        instances, all epochs).  State stays on the device between calls;
        the verdict is the only host sync."""
        cfg = self.cfg
        self._state, ok = run_epochs(
            self._state, cfg.data_shards, cfg.parity_shards, epochs, self.use_kernel
        )
        return bool(ok)

    def state(self) -> np.ndarray:
        """The current proposals, copied to the host."""
        return self._state.cpu().numpy()

    def committed_bytes_per_epoch(self) -> int:
        cfg = self.cfg
        return cfg.instances * cfg.n_nodes * cfg.data_shards * cfg.shard_len


def cpu_fast_path_epoch(proposals: np.ndarray, k: int, p: int) -> np.ndarray:
    """Byte-identical host reference for one fast-path epoch: the
    per-instance, per-node loop (numpy RS).  The correctness oracle."""
    B, N, _k, L = proposals.shape
    n = k + p
    rs = ReedSolomon(k, p)
    decoded = np.empty_like(proposals)
    rows = list(range(p, n))
    for b in range(B):
        encoded = np.stack([rs.encode(proposals[b, i]) for i in range(N)])
        received = np.swapaxes(encoded, 0, 1)
        parity_quorum = np.swapaxes(received[p:n], 0, 1)  # [N, k, L]
        for i in range(N):
            slots: list = [None] * n
            for j, r in enumerate(rows):
                slots[r] = parity_quorum[i, j]
            shards = rs.reconstruct(slots, data_only=True)
            decoded[b, i] = np.stack(shards[:k])
    return decoded


# ---------------------------------------------------------------------------
# Full-crypto fast path: threshold decryption inside the epoch (config 8)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FullCryptoConfig:
    """N-node x B-instance threshold-decryption plane.

    Every node emits a decryption share U*sk_i for every proposer's
    ciphertext U, and t+1 shares Lagrange-combine to the plaintext point:
    B*N ciphertexts per epoch, chained through U_next = U + combine so no
    epoch can be elided.  `share_chunks` is the number of sequential
    ladder launches per stage of the generic epoch (it bounds the ladders'
    table memory); the decrypt engine does not chunk.

    `verify` checks, every epoch, every share received and every
    ciphertext as hbbft's threshold_decrypt does (ops/verify_torch): each
    ciphertext then carries W in G2 beside U, and its hash point H.  The
    last `faulty` nodes are Byzantine: node n - faulty + k sends quorum
    member k's share plus U, which every check must reject."""

    n_nodes: int = 64
    instances: int = 256
    seed: int = 0
    share_chunks: int = 32
    verify: bool = False
    faulty: int = 0

    @property
    def threshold(self) -> int:
        return (self.n_nodes - 1) // 3


class _FullCryptoEpoch:
    """The generic full-crypto epoch over B*n ciphertexts (JAX
    `build_full_crypto_epoch`), on kernel B2.

    Both pipeline stages run over S = t+2 lanes per ciphertext (lane
    ct*S + s):
        stage 1 scalars: [sk_1 .. sk_q, master+1]
        stage 2 scalars: [lam_1 .. lam_q, 1]
    so lane i < q ends as lam_i (U sk_i) and lane q as U (master+1).  Each
    stage is `chunks` sequential `glv_ladder` launches of B*n*S / chunks
    lanes (JAX's 33 MSB-first 4-bit GLV windows per half, the complete
    adds of fq_T's ladder).  The epoch then folds U with the q weighted
    lanes (U_next = U + combine, q complete `add` launches) and checks
    U_next against the check lane projectively (three `mul` launches):
    exactly as strong as combine == U*master, since adding U is
    injective.  `use_kernel=False` runs the plain versions on any device;
    a CPU device always runs them."""

    def __init__(self, B: int, n: int, t: int, chunks: int, device, use_kernel: bool = True):
        self.q, self.chunks = t + 1, chunks
        self.S = self.q + 1
        self.n_ct = B * n
        if (self.n_ct * self.S) % chunks:
            raise ValueError("share_chunks must divide instances * n_nodes * (threshold+2)")
        self.device = resolve_device(device)
        self.ops = fq_torch.PointOps(use_kernel)
        self._one = torch.from_numpy(bls_torch.glv_windows([1])).to(self.device)  # [2, 33, 1]

    def lane_digits(self, scalar_w: torch.Tensor) -> torch.Tensor:
        """[2, 33, S] digits of a stage's S scalars -> [2, 33, B*n*S]: lane
        ct*S + s takes scalar s."""
        w = scalar_w.shape[1]
        return scalar_w[:, :, None, :].expand(2, w, self.n_ct, self.S).reshape(2, w, -1)

    def _stage(self, lanes: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
        m = lanes.shape[-1] // self.chunks
        out = torch.empty_like(lanes)
        for c in range(self.chunks):
            sl = slice(c * m, (c + 1) * m)
            out[..., sl] = self.ops.glv_ladder(lanes[..., sl].contiguous(),
                                               digits[..., sl].contiguous())
        return out

    def __call__(self, U: torch.Tensor, sk_w: torch.Tensor, lam_w: torch.Tensor,
                 m_w: torch.Tensor):
        """U [3, 12, B*n] int32; sk_w [2, 33, >= q] the key shares' GLV
        digits (the first q are the quorum's), lam_w [2, 33, q] the
        Lagrange coefficients', m_w [2, 33, 1] master+1's -> (U_next
        [3, 12, B*n], ok 0-d bool)."""
        q, S, n_ct = self.q, self.S, self.n_ct
        if tuple(U.shape) != (3, limbs.N_LIMBS, n_ct):
            raise ValueError(f"expected [3, {limbs.N_LIMBS}, {n_ct}] int32")
        s1 = torch.cat([sk_w[:, :, :q], m_w], 2)
        s2 = torch.cat([lam_w, self._one], 2)
        lanes = U[:, :, :, None].expand(3, limbs.N_LIMBS, n_ct, S).reshape(3, limbs.N_LIMBS, -1)
        for scalar_w in (s1, s2):
            lanes = self._stage(lanes, self.lane_digits(scalar_w))
        # [S, 3, 12, n_ct]: lane s of every ciphertext one contiguous batch
        by_s = lanes.reshape(3, limbs.N_LIMBS, n_ct, S).permute(3, 0, 1, 2).contiguous()
        U_next = U
        for i in range(q):
            U_next = self.ops.add(U_next, by_s[i])
        return U_next, decrypt_torch.jac_eq(U_next, by_s[q], self.ops.mul)

    def launch_shapes(self) -> List[Launch]:
        """The B2 launches of one epoch, from the config."""
        n_ct = self.n_ct
        return [
            Launch("fq_point", "glv_ladder", n_ct * self.S // self.chunks, 2 * self.chunks, 6),
            Launch("fq_point", "add", n_ct, self.q, 9),
            *(Launch("fq_point", "mul", k * n_ct, 1, el, form) for k, el, form in JAC_EQ_MULS),
        ]

    def launch_counts(self) -> Dict[str, Dict[str, int]]:
        """Kernel launches one epoch makes, as DecryptEpoch.launch_counts:
        2 * chunks `glv_ladder`, q `add` and the check's 3 `mul`."""
        out: Dict[str, Dict[str, int]] = {"fq_point": {}, "circuit": {}}
        for r in self.launch_shapes():
            out[r.kernel][r.name] = out[r.kernel].get(r.name, 0) + r.count
        return out


def build_full_crypto_epoch(B: int, n: int, t: int, chunks: int, device="cuda",
                            use_kernel: bool = True) -> _FullCryptoEpoch:
    """The generic full-crypto epoch over [B, n] ciphertexts as a callable:
    (U, sk_w, lam_w, m_w) -> (U_next, ok) (see _FullCryptoEpoch)."""
    return _FullCryptoEpoch(B, n, t, chunks, device, use_kernel)


def seeded_start(cfg: FullCryptoConfig, lo: int = 0, hi: Optional[int] = None):
    """(key shares, master key, initial U) of the sim `cfg` seeds, from
    `random.Random(cfg.seed)` in the JAX sim's order (the key set, then one
    128-bit scalar per ciphertext).  U is [3, 12, (hi - lo) * N] int32, the
    ciphertexts of instances [lo, hi) only (lane (b - lo) * N + i): every
    scalar is drawn, one host G1 multiply is made per ciphertext kept."""
    sks, master, u0, _ = _seeded_ciphertexts(cfg, lo, hi)
    return sks, master, u0


def _seeded_ciphertexts(cfg: FullCryptoConfig, lo: int = 0, hi: Optional[int] = None):
    """`seeded_start`, and with `cfg.verify` each kept ciphertext's (W, H)
    as crypto/threshold encrypts: a 32-byte V per ciphertext drawn after
    every scalar r, H = H_G2(U, V) and W = H r (host points); else None."""
    hi = cfg.instances if hi is None else hi
    if not 0 <= lo < hi <= cfg.instances:
        raise ValueError(f"instances [{lo}, {hi}) outside [0, {cfg.instances})")
    rng = random.Random(cfg.seed)
    n = cfg.n_nodes
    sk_set = th.SecretKeySet.random(cfg.threshold, rng)
    sks = [sk_set.secret_key_share(i).scalar for i in range(n)]
    r0 = [rng.getrandbits(128) for _ in range(cfg.instances * n)]
    us = [bls.mul_sub(bls.G1, r) for r in r0[lo * n:hi * n]]
    wh = None
    if cfg.verify:
        vs = [rng.getrandbits(256).to_bytes(32, "big") for _ in range(cfg.instances * n)]
        hs = [th._te_hash(th.Ciphertext(u, v, None)) for u, v in zip(us, vs[lo * n:hi * n])]
        wh = ([bls.mul_sub(h, r) for h, r in zip(hs, r0[lo * n:hi * n])], hs)
    return sks, sk_set.secret_key().scalar, limbs.points_to_limbs(us), wh


class FullCryptoTensorSim:
    """Device-resident threshold-decrypt epochs over B*N ciphertexts.

    The key set and the initial ciphertext points come from
    `random.Random(cfg.seed)` in the JAX sim's order (the key set, then
    one 128-bit scalar per ciphertext), so both sims start equal; the
    initial U costs one host G1 multiply per ciphertext.  The state U is
    [3, 12, B*N] int32 on the device (lane b*N + i: instance b, proposer
    i); `state()` gives it in the JAX layout.  `use_kernel=False` runs the
    plain PyTorch versions of the kernels on the device instead.

    The engine is read from `HYDRABADGER_DECRYPT_T` at construction, as
    JAX reads it: "0" selects the generic epoch (`build_full_crypto_epoch`, whose
    divisibility rule on `share_chunks` it then asserts), "1" or unset
    the decrypt engine (ops/decrypt_torch) on every device.  `self.epoch`
    is the engine; `launch_counts()` gives one epoch's launches.

    With `cfg.verify` the engine is ops/verify_torch.VerifiedEpoch over
    the decrypt engine: the state adds W [3, 2, 12, B*N] (`w_state()`),
    the sim's adversary hands it the faulty nodes' forged shares
    (`_forged`) beside the quorum's, `run`'s verdict folds in every share
    and ciphertext check and fails where a forged share passed, and the
    epochs' failed share checks are counted on the device and read at
    the verdict's one sync (`rejected_total`; `last_verdicts()` gives the
    last epoch's).  The seeded sim encrypts as crypto/threshold does
    (H = H_G2(U, V), W = H r).
    """

    def __init__(self, cfg: Optional[FullCryptoConfig] = None, device="cuda",
                 use_kernel: bool = True):
        cfg = cfg or FullCryptoConfig()
        self._seeded(cfg, 0, cfg.instances, device, use_kernel)

    @classmethod
    def instance_slice(cls, cfg: FullCryptoConfig, lo: int, hi: int, device="cuda",
                       use_kernel: bool = True) -> "FullCryptoTensorSim":
        """Instances [lo, hi) of the sim that `cfg` seeds, as a sim of hi - lo
        instances: the same keys and those instances' initial U (a mesh
        rank's share, parallel/mesh.py), its engine built for its own lanes."""
        sim = cls.__new__(cls)
        sim._seeded(cfg, lo, hi, device, use_kernel)
        return sim

    def _seeded(self, cfg: FullCryptoConfig, lo: int, hi: int, device, use_kernel: bool):
        sks, master, u0, wh = _seeded_ciphertexts(cfg, lo, hi)
        w0, hs = (None, None) if wh is None else (limbs.g2_points_to_limbs(wh[0]), wh[1])
        self._setup(replace(cfg, instances=hi - lo), u0, sks, master,
                    list(range(cfg.threshold + 1)), resolve_device(device), use_kernel, w0, hs)

    @classmethod
    def from_jax(cls, U, sks: Sequence[int], master: int, quorum: Sequence[int],
                 device="cuda", use_kernel: bool = True, share_chunks: int = 1,
                 W=None, H=None, faulty: int = 0):
        """Resume from a JAX `FullCryptoTensorSim`: its `_U` read as numpy
        ([instances, n_nodes, 3, 32] int32 12-bit limbs), `_sks`,
        `_master` and `_quorum`, into the engine `HYDRABADGER_DECRYPT_T`
        selects (`share_chunks` sizes the generic epoch's launches).
        With W and H (each [instances, n_nodes, 3, 2, 32] G2 points in the
        same limbs: every ciphertext's W and hash point) the sim verifies,
        the last `faulty` nodes forging."""
        U = np.asarray(U)
        if U.ndim != 4 or U.shape[2:] != (3, limbs.JAX_N_LIMBS) or U.shape[1] != len(sks):
            raise ValueError(f"expected [instances, {len(sks)}, 3, 32] limbs, got {U.shape}")
        cfg = FullCryptoConfig(n_nodes=U.shape[1], instances=U.shape[0],
                               share_chunks=share_chunks, verify=W is not None, faulty=faulty)
        if list(quorum) != list(range(cfg.threshold + 1)):
            raise ValueError("the port runs the fixed lowest-(t+1) quorum")
        if faulty and not cfg.verify:
            raise ValueError("faulty nodes forge shares only where the sim verifies (W, H)")
        w0 = hs = None
        if cfg.verify:
            g2_shape = U.shape[:2] + (3, 2, limbs.JAX_N_LIMBS)
            if np.shape(W) != g2_shape or np.shape(H) != g2_shape:
                raise ValueError(f"expected W and H of shape {g2_shape}")
            w0 = limbs.g2_limbs_from_jax(W)
            hs = limbs.limbs_to_g2_points(limbs.g2_limbs_from_jax(H))
        sim = cls.__new__(cls)
        sim._setup(cfg, limbs.limbs_from_jax(U), list(sks), master, list(quorum),
                   resolve_device(device), use_kernel, w0, hs)
        return sim

    def _setup(self, cfg, u0: np.ndarray, sks, master: int, quorum, dev, use_kernel,
               w0: Optional[np.ndarray] = None, hs: Optional[Sequence] = None):
        self.cfg = cfg
        self.device = dev
        self.use_kernel = use_kernel
        self._sks = sks
        self._master = master
        self._quorum = quorum
        self._lam = th.lagrange_coeffs_at_zero([i + 1 for i in quorum])
        mp1 = (master + 1) % bls.R
        if mp1 == 0:
            raise ValueError("degenerate master key (master == -1 mod R)")
        self._mp1 = mp1
        self._U = torch.from_numpy(u0).to(dev)
        self._U_prev = None  # the state before the last epoch (oracle_check)
        self.generic = os.environ.get("HYDRABADGER_DECRYPT_T", "") == "0"
        self._W = None
        self.rejected_total = 0  # failed share checks over every epoch run
        self._verdicts = None  # the last verified epoch's
        if cfg.verify:
            n = cfg.n_nodes
            if self.generic:
                raise ValueError("the verified epoch runs on the decrypt engine only")
            if len(quorum) + cfg.faulty > n:
                raise ValueError(f"{cfg.faulty} faulty nodes overlap the quorum of {len(quorum)}")
            if cfg.faulty > len(quorum):
                raise ValueError(f"{cfg.faulty} faulty nodes forge from {len(quorum)} quorum shares")
            self.epoch = verify_torch.VerifiedEpoch(
                sks, quorum, range(n - cfg.faulty, n), self._lam, mp1, hs, dev, use_kernel)
            self._adversary = fq_torch.PointOps(use_kernel)
            self._W = torch.from_numpy(np.ascontiguousarray(w0)).to(dev)
            self._windows = ()
        elif self.generic:  # its stage 1 takes the first q key shares: the quorum
            self.epoch = build_full_crypto_epoch(cfg.instances, cfg.n_nodes, cfg.threshold,
                                                 cfg.share_chunks, dev, use_kernel)
            # the fixed scalars' GLV digits, resident on the device
            self._windows = tuple(torch.from_numpy(bls_torch.glv_windows(k)).to(dev)
                                  for k in (sks, self._lam, [mp1]))
        else:
            self.epoch = decrypt_torch.build_epoch(
                cfg.instances * cfg.n_nodes, [sks[i] for i in quorum], self._lam, mp1,
                device=dev, use_kernel=use_kernel,
            )
            self._windows = ()

    def run(self, epochs: int) -> bool:
        """Run epochs on the device; returns the check verdict (all lanes,
        all epochs).  The verdict is the only host sync."""
        if self.cfg.verify:
            return self._run_verified(epochs)
        ok = torch.ones((), dtype=torch.bool, device=self.device)
        for _ in range(epochs):
            self._U_prev = self._U
            self._U, ok_epoch = self.epoch(self._U, *self._windows)
            ok &= ok_epoch
        return bool(ok)

    def _run_verified(self, epochs: int) -> bool:
        """`run` with every share and ciphertext checked: the verdict and
        the failed share checks come to the host in one read."""
        ok = torch.ones((), dtype=torch.bool, device=self.device)
        rejected = torch.zeros((), dtype=torch.int64, device=self.device)
        reg = M.default_registry()
        issue = reg.histogram(M.VERIFY_ISSUE_S)
        forged = self.cfg.faulty * self.cfg.instances * self.cfg.n_nodes
        for _ in range(epochs):
            self._U_prev = self._U
            acc = self.epoch.shares(self._U)
            self._U, self._W, ok_epoch, rej_epoch, self._verdicts = self.epoch(
                self._U, self._W, acc, self._forged(acc, self._U))
            ok &= ok_epoch & ~self._verdicts[:forged].any()  # no forgery passed
            rejected += rej_epoch
            issue.observe(self.epoch.issue_s)
        ok_host, rejected_host = torch.stack([ok.to(torch.int64), rejected]).tolist()
        self.rejected_total += rejected_host
        reg.counter(M.TDEC_SHARES_REJECTED).inc(rejected_host)
        return bool(ok_host)

    def _forged(self, acc: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
        """The Byzantine nodes' shares: node n - faulty + k sends quorum
        member k's share plus U, S_k + U, a point of G1 that is no node's
        share, for every ciphertext: [3, 12, faulty * n_ct], one complete
        `add` (kernel B2) over the engine's ladders `acc`."""
        f, n_ct = self.cfg.faulty, U.shape[-1]
        if not f:
            return U[:, :, :0]
        return self._adversary.add(acc[:, :, :f].reshape(3, limbs.N_LIMBS, f * n_ct),
                                   U.repeat(1, 1, f))

    def launch_counts(self) -> Dict[str, Dict[str, int]]:
        """Kernel launches one epoch makes: the engine's, and where nodes
        forge their shares' one B2 `add`."""
        out = self.epoch.launch_counts()
        if self.cfg.faulty:
            out["fq_point"]["add"] = out["fq_point"].get("add", 0) + 1
        return out

    def state(self) -> np.ndarray:
        """U in the JAX layout: [instances, n_nodes, 3, 32] int32 12-bit limbs."""
        cfg = self.cfg
        return limbs.limbs_to_jax(self._U.cpu().numpy(), (cfg.instances, cfg.n_nodes))

    def w_state(self) -> np.ndarray:
        """W in the JAX layout, [instances, n_nodes, 3, 2, 32] (verified sims)."""
        cfg = self.cfg
        return limbs.g2_limbs_to_jax(self._W.cpu().numpy(), (cfg.instances, cfg.n_nodes))

    def last_verdicts(self) -> Dict[str, np.ndarray]:
        """The last verified epoch's verdicts: "forged" [faulty, B, N] (node
        n - faulty + k's forged share of each ciphertext), "quorum" [q, B, N]
        (member i's share) and "ciphertext" [B, N]."""
        if self._verdicts is None:
            raise RuntimeError("last_verdicts needs a verified epoch run")
        cfg = self.cfg
        shape = (cfg.instances, cfg.n_nodes)
        v = self._verdicts.cpu().numpy()
        k, n_ct = cfg.faulty * shape[0] * shape[1], shape[0] * shape[1]
        return {"forged": v[:k].reshape(cfg.faulty, *shape),
                "quorum": v[k:-n_ct].reshape(-1, *shape),
                "ciphertext": v[-n_ct:].reshape(shape)}

    def oracle_check(self, lanes: Sequence[int]) -> bool:
        """Hold sampled lanes of the last epoch against the host oracle:
        U_next == U + sum_i lam_i (U sk_i), through crypto/threshold."""
        if self._U_prev is None:
            raise RuntimeError("oracle_check needs at least one epoch run")
        lanes = list(lanes)
        before = limbs.limbs_to_points(self._U_prev[:, :, lanes].cpu().numpy())
        after = limbs.limbs_to_points(self._U[:, :, lanes].cpu().numpy())
        for u, got in zip(before, after):
            shares = {i: th.DecryptionShare(bls.mul_sub(u, self._sks[i])) for i in self._quorum}
            combined = th.interpolate_g_at_zero({i + 1: s.point for i, s in shares.items()})
            if not bls.eq(got, bls.add(u, combined)):
                return False
        return True
