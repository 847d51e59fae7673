"""Share verification inside the threshold-decrypt epoch, on the device.

hbbft's threshold_decrypt checks every decryption share it receives and
the ciphertext itself before it combines anything:

    share S_i of node i      e(S_i, H) == e(pk_i, W)
    ciphertext (U, V, W)     e(G1, W)  == e(U, H)

with H = H_G2(U, V) (crypto/threshold.PublicKeyShare.verify_decryption_share
and Ciphertext.verify).  `ShareChecks` runs both kinds for a whole epoch
as one batch of pairing checks, from device tensors with no host round
trip:

1. affine operands: one `fq_inv` launch (pairing_torch's Fermat circuit,
   kernel B3) inverts every share's and every U's Z and every W's norm
   Z0^2 + Z1^2 (the `g2_norm` circuit) at once; the `g1_affine` and
   `g2_affine` circuits then make (x, y) = (X Z^-2, Y Z^-3);
2. one `pairing_torch.pairing_eq_kernel` batch of every share check and
   every ciphertext check (B3, both Miller loops of a check in one batch).

It is handed the shares, the senders' public key shares and (H, W, U)
only: which shares are valid comes from the pairings alone.  A share at
infinity is never valid (U is not, nor is a key share 0); its Z inverts
to 0, it reads as the point (0, 0), off the curve, and its check fails.

`VerifiedEpoch` is the epoch around it (sim/tensor.FullCryptoTensorSim
with FullCryptoConfig(verify=True)): the decrypt engine's share ladders,
the checks of the shares it is handed and of the quorum's own, the next
W = W (master + 1) by B4's ladder (it mirrors U's step, so W stays U's r
times H), the engine's combine and check; `ok` folds the quorum's and
the ciphertexts' verdicts in.  Which nodes send the handed shares, and
whether any is forged, is the caller's business (the sim tier's
adversary).  `use_kernel=False` runs every plain version on any device;
a CPU device always runs them.
"""
from __future__ import annotations

import time
from functools import lru_cache
from typing import Dict, Sequence

import numpy as np
import torch

from ..crypto import bls12_381 as bls
from . import bls_g2_torch, decrypt_torch, pairing_torch
from .circuit_torch import CircuitExec, executor
from .fp12_circuit import CircuitBuilder
from .limbs import N_LIMBS
from .pairing_torch import S2

# ---------------------------------------------------------------------------
# The affine circuits (kernel B3)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _g2_norm_circuit() -> CircuitExec:
    """(Z0, Z1) -> Z0^2 + Z1^2, the norm a G2 Z is inverted through."""
    b = CircuitBuilder(2)
    z0, z1 = b.input(0), b.input(1)
    return executor(b.compile([z0 * z0 + z1 * z1]), "g2_norm")


@lru_cache(maxsize=None)
def _g1_affine_circuit() -> CircuitExec:
    """(X, Y, Z^-1) -> (X Z^-2, Y Z^-3)."""
    b = CircuitBuilder(3)
    x, y, zi = b.input(0), b.input(1), b.input(2)
    zi2 = zi * zi
    return executor(b.compile([x * zi2, y * (zi2 * zi)]), "g1_affine")


@lru_cache(maxsize=None)
def _g2_affine_circuit() -> CircuitExec:
    """(X, Y, Z as Fp2 pairs, 1 / norm(Z)) -> (x, y) as Fp2 pairs:
    Z^-1 = conj(Z) / norm(Z)."""
    b = CircuitBuilder(7)
    x, y, z = (S2(b.input(2 * c), b.input(2 * c + 1)) for c in range(3))
    ninv = b.input(6)
    zi = S2(z.c[0] * ninv, -(z.c[1] * ninv))
    zi2 = zi * zi
    return executor(b.compile([*(x * zi2).c, *(y * (zi2 * zi)).c]), "g2_affine")


def circuits() -> Dict[str, CircuitExec]:
    """The affine circuits `ShareChecks` launches beside the pairing's."""
    return {c.name: c for c in (_g2_norm_circuit(), _g1_affine_circuit(), _g2_affine_circuit())}


def _g1_words(pts) -> np.ndarray:
    """Host G1 points -> [2, 12, n] affine Montgomery words."""
    return pairing_torch._g1_words(bls.normalize_batch(list(pts)))


def _g2_words(pts) -> np.ndarray:
    """Host G2 points -> [4, 12, n] affine Montgomery words."""
    return pairing_torch._g2_words(bls.normalize_batch(list(pts)))


class ShareChecks:
    """Every share check and ciphertext check of an epoch as one batch.

    `pks`: the public key share of each share slot's sender (host G1
    points); `hs`: each ciphertext's H (host G2 points).  A call takes the
    shares [3, 12, slots * n_ct] (slot s of ciphertext j at lane
    s * n_ct + j, Jacobian), U [3, 12, n_ct] and W [3, 2, 12, n_ct] on the
    device and returns the verdicts bool [slots * n_ct + n_ct]: the share
    lanes, then one ciphertext check per ciphertext."""

    def __init__(self, pks: Sequence, hs: Sequence, device, use_kernel: bool = True):
        self.slots, self.n_ct = len(pks), len(hs)
        self.use_kernel = use_kernel
        dev = torch.device(device)
        n, m = self.n_ct, self.slots * self.n_ct

        def held(words: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(words)).to(dev)

        pk = held(_g1_words(pks))  # [2, 12, slots]
        h = held(_g2_words(hs))  # [4, 12, n]
        g1 = held(_g1_words([bls.G1]))
        self._pk = pk[:, :, :, None].expand(2, N_LIMBS, self.slots, n).reshape(2, N_LIMBS, m)
        self._gen = g1.expand(2, N_LIMBS, n)
        self._h_shares = h.repeat(1, 1, self.slots)  # [4, 12, m]: lane s * n + j holds H_j
        self._h = h

    def _run(self, circ: CircuitExec, x: torch.Tensor) -> torch.Tensor:
        return circ(x) if self.use_kernel else circ.plain(x)

    def affine(self, shares: torch.Tensor, U: torch.Tensor, W: torch.Tensor):
        """(shares and U affine [2, 12, m + n], W affine [4, 12, n]), one
        inversion launch for all of them."""
        n, m = self.n_ct, shares.shape[-1]
        w = W.reshape(6, N_LIMBS, n)
        norm = self._run(_g2_norm_circuit(), w[4:6])
        zinv = self._run(pairing_torch.circuits()["fq_inv"],
                         torch.cat([shares[2:3], U[2:3], norm], -1))
        g1 = self._run(_g1_affine_circuit(), torch.cat(
            [torch.cat([shares[:2], U[:2]], -1), zinv[:, :, : m + n]]))
        g2 = self._run(_g2_affine_circuit(), torch.cat([w, zinv[:, :, m + n :]]))
        return g1, g2

    def __call__(self, shares: torch.Tensor, U: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
        n, m = self.n_ct, self.slots * self.n_ct
        if tuple(shares.shape) != (3, N_LIMBS, m):
            raise ValueError(f"expected shares [3, {N_LIMBS}, {m}] int32")
        g1, w = self.affine(shares, U, W)
        a = torch.cat([g1[:, :, :m], self._gen], -1)  # the shares, then G1
        c = torch.cat([self._pk, g1[:, :, m:]], -1)  # their senders' keys, then U
        b = torch.cat([self._h_shares, w], -1)  # H, then W
        d = torch.cat([w.repeat(1, 1, self.slots), self._h], -1)  # W, then H
        return pairing_torch.pairing_eq_kernel(a[0:1], a[1:2], b[0:2], b[2:4], c[0:1], c[1:2],
                                               d[0:2], d[2:4], use_kernel=self.use_kernel)

    def launch_counts(self) -> Dict[str, int]:
        """B3 launches of one call, by circuit name."""
        out = dict(pairing_torch.schedule(self.slots * self.n_ct + self.n_ct))
        for name in ("g2_norm", "g1_affine", "g2_affine"):
            out[name] = 1
        out["fq_inv"] = out.get("fq_inv", 0) + 1
        return out


class VerifiedEpoch:
    """One verified epoch over n_ct ciphertexts (see the module docstring).

    sks: every node's key share; quorum: the combine's members (the
    engine's fixed lowest t + 1), whose shares the epoch makes itself;
    received: the other nodes whose share of every ciphertext the epoch is
    handed, checked before the quorum's (the order they arrive in).  An
    epoch is `acc = shares(U)`, then `(U, W, acc, handed)` -> (U_next,
    W_next, ok, rejected, verdicts), where `handed` [3, 12, r * n_ct]
    holds node received[s]'s share of ciphertext j at lane s * n_ct + j.
    The verdicts are the handed shares', the quorum's (slot-major, as
    `handed`) and one per ciphertext; `rejected` counts the failed share
    checks (0-d int64) and `ok` is the engine's check with every quorum
    and ciphertext verdict true (0-d bool), both on the device.  `issue_s`
    holds the last call's host seconds in the verify stage (the operands,
    the pairing batch, W's ladder)."""

    def __init__(self, sks: Sequence[int], quorum: Sequence[int], received: Sequence[int],
                 lams: Sequence[int], mp1: int, hs: Sequence, device, use_kernel: bool = True):
        self.q, self.r, self.n_ct = len(quorum), len(received), len(hs)
        self.use_kernel = use_kernel
        self.dec = decrypt_torch.DecryptEpoch(self.n_ct, [sks[i] for i in quorum], lams, mp1,
                                              device, use_kernel)
        senders = list(received) + list(quorum)
        self.checks = ShareChecks([bls.mul_sub(bls.G1, sks[i]) for i in senders], hs,
                                  self.dec.device, use_kernel)
        win = bls_g2_torch.scalars_to_windows([mp1])  # [64, 1]
        win = np.ascontiguousarray(np.broadcast_to(win, (win.shape[0], self.n_ct)))
        self._windows = torch.from_numpy(win).to(self.dec.device)
        self.issue_s = 0.0

    def shares(self, U: torch.Tensor) -> torch.Tensor:
        """The decrypt engine's ladders, [3, 12, q + 1, n_ct]: the quorum's
        shares U sk_i, then U (master + 1)."""
        return self.dec.ladders(U)

    def __call__(self, U: torch.Tensor, W: torch.Tensor, acc: torch.Tensor,
                 handed: torch.Tensor):
        n, q, r = self.n_ct, self.q, self.r
        if tuple(handed.shape) != (3, N_LIMBS, r * n):
            raise ValueError(f"expected handed shares [3, {N_LIMBS}, {r * n}] int32")
        t0 = time.perf_counter()
        shares = torch.cat([handed, acc[:, :, :q].reshape(3, N_LIMBS, q * n)], -1)
        verdicts = self.checks(shares, U, W)
        W_next = bls_g2_torch.g2_scalar_mul_windowed(W, self._windows, self.use_kernel)
        self.issue_s = time.perf_counter() - t0
        U_next, ok = self.dec.finish(U, acc)
        rejected = (~verdicts[: (r + q) * n]).sum()
        ok = ok & verdicts[r * n :].all()
        return U_next, W_next, ok, rejected, verdicts

    def launch_counts(self) -> Dict[str, Dict[str, int]]:
        """Kernel launches one epoch makes: the decrypt engine's, the
        checks' circuits and W's `ladder`."""
        out = self.dec.launch_counts()
        for name, count in self.checks.launch_counts().items():
            out["circuit"][name] = out["circuit"].get(name, 0) + count
        out["fq2_point"] = {"ladder": 1}
        return out
