"""The port's CryptoEngine: a host engine, a GPU engine, and their registry.

Counterpart of hydrabadger_tpu/crypto/engine.py for the entry points the
port has kernels for.  Every piece of crypto-heavy batch work a consensus
core performs goes through one engine, so the host reference path and
the batched device path are interchangeable without touching protocol
logic.  Two engines:

* `CpuEngine` ("cpu"): the host versions, copied from the JAX package's
  CpuEngine, of exactly the entries GpuEngine overrides: per-instance
  numpy Reed-Solomon (crypto/rs.py) and the pure-Python BLS12-381 oracle
  (crypto/threshold.py).
* `GpuEngine` ("gpu", `device="cuda"`): `rs_encode_batch` /
  `rs_reconstruct_batch` on kernel B1 (ops/rs_torch), `sign_share_batch`
  and `combine_signature_shares_batch` on kernel B4 (ops/bls_g2_torch),
  `decrypt_share_batch` and `combine_decryption_shares_batch` on kernel
  B2 (ops/bls_torch), each batch one device dispatch.  Its `submit_*`
  twins dispatch at once and defer only the device-to-host copy and the
  affine conversion (crypto/futures).  `device="cpu"` runs the kernels'
  plain versions on the host; `use_kernel=False` runs them on the card.

Both engines hash each distinct document onto G2 once and keep the point
in a bounded per-engine cache (`hash_to_g2` is pure Python, ~28 ms).
The registry (`get_engine`, `register_engine`) is the port's own; nothing
is registered into the JAX package.  Its default is "gpu", which raises
without a card; the host engine, the oracle, is had only by its name.
Signature-share and decryption-share verification (pairings) are not
ported yet.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from functools import lru_cache
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..ops import bls_g2_torch, bls_torch, limbs, rs_torch
from . import futures
from . import threshold as th
from .bls12_381 import hash_to_g2, mul_sub
from .rs import ReedSolomon

HASH_CACHE_SIZE = 4096


@lru_cache(maxsize=256)
def _rs(data_shards: int, parity_shards: int) -> ReedSolomon:
    return ReedSolomon(data_shards, parity_shards)


def quorum_prep(jobs_shares):
    """Shared combine scaffold: pick the lowest t+1 share ids per job,
    compute Lagrange-at-zero coefficients, and group job indices by
    quorum size (the combine tensor is [S * B] lanes, so one dispatch
    per S; a coin round shares one S)."""
    by_size: Dict[int, List[int]] = {}
    prepared = []
    for idx, (threshold, shares) in enumerate(jobs_shares):
        if len(shares) <= threshold:
            raise ValueError(f"need {threshold + 1} shares, got {len(shares)}")
        ids = sorted(shares)[: threshold + 1]
        lam = th.lagrange_coeffs_at_zero([i + 1 for i in ids])
        prepared.append(([shares[i].point for i in ids], lam))
        by_size.setdefault(len(ids), []).append(idx)
    return prepared, by_size


class CpuEngine:
    """Reference engine: per-instance host crypto (numpy / pure Python)."""

    name = "cpu"

    def __init__(self):
        self._h_cache: "OrderedDict[bytes, tuple]" = OrderedDict()

    def hash_to_g2(self, msg: bytes) -> tuple:
        """H(msg) on G2, cached by the message's digest (LRU, 4096 points)."""
        key = hashlib.sha256(msg).digest()
        pt = self._h_cache.get(key)
        if pt is None:
            pt = hash_to_g2(msg)
            self._h_cache[key] = pt
            if len(self._h_cache) > HASH_CACHE_SIZE:
                self._h_cache.popitem(last=False)
        else:
            self._h_cache.move_to_end(key)
        return pt

    # -- Reed-Solomon erasure coding (hbbft::broadcast's inner loop) --------

    def rs_encode_batch(self, data, data_shards: int, parity_shards: int) -> np.ndarray:
        """[B, k, L] -> [B, k+p, L]; the host baseline loops per instance."""
        data = np.asarray(data, dtype=np.uint8)
        rs = _rs(data_shards, parity_shards)
        return np.stack([rs.encode(data[i]) for i in range(data.shape[0])])

    def rs_reconstruct_batch(self, surviving, rows: Sequence[int], data_shards: int,
                             parity_shards: int) -> np.ndarray:
        """[B, k, L] shards at indices `rows` -> [B, k, L] data rows."""
        surviving = np.asarray(surviving, dtype=np.uint8)
        rs = _rs(data_shards, parity_shards)
        n = data_shards + parity_shards
        rows = [int(r) for r in rows]
        out = np.empty((surviving.shape[0], data_shards, surviving.shape[2]), np.uint8)
        for b in range(surviving.shape[0]):
            slots: List[Optional[np.ndarray]] = [None] * n
            for j, r in enumerate(rows):
                slots[r] = surviving[b, j]
            out[b] = np.stack(rs.reconstruct(slots, data_only=True)[:data_shards])
        return out

    def submit_rs_encode_batch(self, data, data_shards: int, parity_shards: int):
        return futures.immediate(self.rs_encode_batch(data, data_shards, parity_shards),
                                 "rs_encode_batch")

    def submit_rs_reconstruct_batch(self, surviving, rows, data_shards: int, parity_shards: int):
        return futures.immediate(
            self.rs_reconstruct_batch(surviving, rows, data_shards, parity_shards),
            "rs_reconstruct_batch",
        )

    # -- threshold signatures (hbbft::threshold_sign; the common coin) ------

    def sign_share_batch(self, items: Sequence[Tuple[th.SecretKeyShare, bytes]]
                         ) -> List[th.SignatureShare]:
        """sk_i * H(m) across (node, instance) coin rounds, one host ladder
        each; one hash per distinct message."""
        return [th.SignatureShare(mul_sub(self.hash_to_g2(msg), sk.scalar)) for sk, msg in items]

    def submit_sign_share_batch(self, items) -> futures.CryptoFuture:
        return futures.immediate(self.sign_share_batch(items), "sign_share_batch")

    def combine_signature_shares_batch(
        self, jobs: Sequence[Tuple[th.PublicKeySet, Mapping[int, th.SignatureShare]]]
    ) -> List[th.Signature]:
        """Lagrange combine in the exponent over G2, job by job."""
        return [pk_set.combine_signatures(shares) for pk_set, shares in jobs]

    # -- threshold decryption (hbbft::threshold_decrypt) --------------------

    def decrypt_share_batch(self, items: Sequence[Tuple[th.SecretKeyShare, th.Ciphertext]]
                            ) -> List[th.DecryptionShare]:
        """U * sk_i across (instance, node) pairs, one host ladder each."""
        return [sk.decrypt_share(ct) for sk, ct in items]

    def submit_decrypt_share_batch(self, items) -> futures.CryptoFuture:
        return futures.immediate(self.decrypt_share_batch(items), "decrypt_share_batch")

    def combine_decryption_shares_batch(
        self, jobs: Sequence[Tuple[th.PublicKeySet, Mapping[int, th.DecryptionShare], th.Ciphertext]]
    ) -> List[bytes]:
        """Lagrange combine in the exponent over G1 and the KDF unwrap, job by job."""
        return [pk_set.decrypt(shares, ct) for pk_set, shares, ct in jobs]

    def __repr__(self) -> str:
        return f"<{type(self).__name__}>"


class GpuEngine(CpuEngine):
    """Batched engine: each batch entry is one device dispatch.

    The signature entries' `dispatch_*` forms return the device tensor
    (the Jacobian limbs before the affine conversion) beside the future of
    the host result; the coin round and chip_smoke hold those limbs
    against a run of the plain versions."""

    name = "gpu"

    def __init__(self, device="cuda", use_kernel: bool = True):
        super().__init__()
        self.device = resolve_device(device)
        self.use_kernel = use_kernel

    def __repr__(self) -> str:
        return f"<GpuEngine {self.device}{'' if self.use_kernel else ' plain'}>"

    # -- Reed-Solomon on kernel B1 ------------------------------------------

    def _upload(self, x) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8)).to(self.device)

    def submit_rs_encode_batch(self, data, data_shards: int, parity_shards: int):
        out = rs_torch.rs_encode_batch(self._upload(data), data_shards, parity_shards,
                                       use_kernel=self.use_kernel)
        return futures.submit(lambda: out.cpu().numpy(), "rs_encode_batch")

    def submit_rs_reconstruct_batch(self, surviving, rows, data_shards: int, parity_shards: int):
        out = rs_torch.rs_reconstruct_batch(self._upload(surviving), rows, data_shards,
                                            parity_shards, use_kernel=self.use_kernel)
        return futures.submit(lambda: out.cpu().numpy(), "rs_reconstruct_batch")

    def rs_encode_batch(self, data, data_shards: int, parity_shards: int) -> np.ndarray:
        return self.submit_rs_encode_batch(data, data_shards, parity_shards).result()

    def rs_reconstruct_batch(self, surviving, rows, data_shards: int, parity_shards: int):
        return self.submit_rs_reconstruct_batch(surviving, rows, data_shards, parity_shards).result()

    # -- threshold signatures on kernel B4 ----------------------------------

    def dispatch_sign_share_batch(self, items) -> Tuple[torch.Tensor, futures.CryptoFuture]:
        """All shares as lanes of one G2 ladder -> (the [3, 2, 12, n] shares
        on the device, dispatched and not waited for; the future of the host
        shares).  Each distinct message is hashed (cached) and converted to
        limbs once."""
        hashed = {msg: self.hash_to_g2(msg) for msg in dict.fromkeys(m for _sk, m in items)}
        out, finish = bls_g2_torch.g2_scalar_mul_batch_submit(
            [hashed[msg] for _sk, msg in items], [sk.scalar for sk, _msg in items],
            self.device, self.use_kernel,
        )
        return out, futures.submit(
            lambda: [th.SignatureShare(p) for p in finish()], "sign_share_batch"
        )

    def submit_sign_share_batch(self, items) -> futures.CryptoFuture:
        return self.dispatch_sign_share_batch(items)[1]

    def sign_share_batch(self, items) -> List[th.SignatureShare]:
        return self.submit_sign_share_batch(items).result()

    def dispatch_combine_signature_shares_batch(self, jobs
                                                ) -> Tuple[torch.Tensor, futures.CryptoFuture]:
        """Lagrange combines in the exponent over G2 -> (the [3, 2, 12, B]
        combined signatures on the device in job order, dispatched and not
        waited for; the future of the host signatures).  One weighted-sum
        dispatch per quorum size S (a coin round shares one S)."""
        prepared, by_size = quorum_prep([(pk_set.threshold, shares) for pk_set, shares in jobs])
        out = torch.empty((3, 2, limbs.N_LIMBS, len(jobs)), dtype=torch.int32, device=self.device)
        for idxs in by_size.values():
            out[..., idxs] = bls_g2_torch.g2_weighted_sum_dispatch(
                [prepared[i][0] for i in idxs], [prepared[i][1] for i in idxs],
                self.device, self.use_kernel,
            )
        return out, futures.submit(
            lambda: [th.Signature(g) for g in bls_g2_torch.to_host(out)],
            "combine_signature_shares_batch",
        )

    def combine_signature_shares_batch(self, jobs) -> List[th.Signature]:
        return self.dispatch_combine_signature_shares_batch(jobs)[1].result()

    # -- threshold decryption on kernel B2 ----------------------------------

    def dispatch_decrypt_share_batch(self, items) -> Tuple[torch.Tensor, futures.CryptoFuture]:
        """All shares as lanes of one G1 GLV ladder -> (the [3, 12, n]
        shares on the device, dispatched and not waited for; the future of
        the host shares).  Each distinct U is converted to limbs once."""
        out, finish = bls_torch.g1_scalar_mul_batch_submit(
            [ct.u for _sk, ct in items], [sk.scalar for sk, _ct in items],
            self.device, self.use_kernel,
        )
        return out, futures.submit(
            lambda: [th.DecryptionShare(p) for p in finish()], "decrypt_share_batch"
        )

    def submit_decrypt_share_batch(self, items) -> futures.CryptoFuture:
        return self.dispatch_decrypt_share_batch(items)[1]

    def decrypt_share_batch(self, items) -> List[th.DecryptionShare]:
        return self.submit_decrypt_share_batch(items).result()

    def dispatch_combine_decryption_shares_batch(self, jobs
                                                 ) -> Tuple[torch.Tensor, futures.CryptoFuture]:
        """Lagrange combines in the exponent over G1 -> (the [3, 12, B]
        combined points U * master on the device in job order, dispatched
        and not waited for; the future of the B plaintexts, each unwrapped
        with the KDF).  One weighted-sum dispatch per quorum size S."""
        prepared, by_size = quorum_prep([(pk_set.threshold, shares) for pk_set, shares, _ct in jobs])
        out = torch.empty((3, limbs.N_LIMBS, len(jobs)), dtype=torch.int32, device=self.device)
        for idxs in by_size.values():
            out[..., idxs] = bls_torch.g1_weighted_sum_dispatch(
                [prepared[i][0] for i in idxs], [prepared[i][1] for i in idxs],
                self.device, self.use_kernel,
            )
        return out, futures.submit(
            lambda: [th.unwrap_ciphertext(g, ct) for g, (_pk, _shares, ct)
                     in zip(bls_torch.to_host(out), jobs)],
            "combine_decryption_shares_batch",
        )

    def combine_decryption_shares_batch(self, jobs) -> List[bytes]:
        return self.dispatch_combine_decryption_shares_batch(jobs)[1].result()


_REGISTRY: Dict[str, type] = {"cpu": CpuEngine, "gpu": GpuEngine}
_INSTANCES: Dict[str, CpuEngine] = {}

EngineLike = Union[None, str, CpuEngine]


def get_engine(spec: EngineLike = None) -> CpuEngine:
    """Resolve None (the card's engine, "gpu") / a name ("cpu", "gpu") / an
    instance.  Named engines are built once per process; "gpu" raises
    without a card, and the host engine is only had by its name."""
    if spec is None:
        spec = "gpu"
    if isinstance(spec, str):
        try:
            cls = _REGISTRY[spec]
        except KeyError:
            raise ValueError(f"unknown crypto engine {spec!r}; have {sorted(_REGISTRY)}") from None
        if spec not in _INSTANCES:
            _INSTANCES[spec] = cls()
        return _INSTANCES[spec]
    return spec


def register_engine(name: str, cls: type) -> None:
    """Extension point for tests and other backends."""
    _REGISTRY[name] = cls
    _INSTANCES.pop(name, None)
