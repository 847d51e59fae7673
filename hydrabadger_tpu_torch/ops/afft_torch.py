"""The GF(2^8) additive FFT as torch tensor ops on the tensor's device.

Counterpart of hydrabadger_tpu/ops/afft_T.py (`_afft_fwd_T`,
`_afft_inv_T`), which the JAX package compiles with `jax.jit` alone: no
`pallas_call`, so no hand-written kernel here either.  The functions are
written as tensor ops and run wherever their input lies (the card on the
GPU engine's FFT route of RS, the CPU in the tests).  Their plain versions
are the numpy twins `ops/ntt_torch.gf_afft` / `gf_iafft`, which they equal
byte for byte.

Shapes: [2^m, *tail] uint8, the trailing axes flattened into one lane axis
for the shuffles.  The Taylor shuffles are XORs of contiguous quarter
blocks (`_taylor`, `_itaylor`); the butterflies' twiddle multiply is a
log/exp table gather under a zero mask (`_mul_const`).  The exp and log
tables, and each level's twiddle logs, are uploaded once per device.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..crypto import gf256
from .ntt_torch import _cantor_plan


@lru_cache(maxsize=None)
def _tables(device: torch.device):
    """(exp, log) GF(2^8) tables as int64 tensors on `device`."""
    return (torch.as_tensor(np.asarray(gf256.EXP_TABLE, np.int64), device=device),
            torch.as_tensor(np.asarray(gf256.LOG_TABLE, np.int64), device=device))


@lru_cache(maxsize=None)
def _twiddles(device: torch.device, h: int):
    """The first h butterfly twiddles as ([1, h, 1] logs, [1, h, 1] zero
    mask) on `device`."""
    consts = _cantor_plan()[2][:h]
    clog = np.asarray(gf256.LOG_TABLE, np.int64)[consts.astype(np.int64)]
    return (torch.as_tensor(clog, device=device).reshape(1, h, 1),
            torch.as_tensor(consts == 0, device=device).reshape(1, h, 1))


def _mul_const(h: int, v: torch.Tensor) -> torch.Tensor:
    """GF product of the first h twiddles against [b, h, T] uint8 lanes:
    a log gather, an exp gather, zero where either factor is zero."""
    exp_t, log_t = _tables(v.device)
    clog, czero = _twiddles(v.device, h)
    out = exp_t[clog + log_t[v.long()]]
    return torch.where(czero | (v == 0), 0, out).to(torch.uint8)


def _taylor(work: torch.Tensor) -> torch.Tensor:
    """ntt_torch._taylor_np on [b, s, T]."""
    b, s, t = work.shape
    size = s
    while size >= 4:
        x = work.reshape(-1, size, t)
        q = size // 4
        a, bq, c, d = x[:, :q], x[:, q : 2 * q], x[:, 2 * q : 3 * q], x[:, 3 * q :]
        work = torch.cat([a, bq ^ c ^ d, c ^ d, d], 1).reshape(b, s, t)
        size //= 2
    return work


def _itaylor(work: torch.Tensor) -> torch.Tensor:
    """ntt_torch._itaylor_np on [b, s, T]."""
    b, s, t = work.shape
    size = 4
    while size <= s:
        x = work.reshape(-1, size, t)
        q = size // 4
        a, bq, c, d = x[:, :q], x[:, q : 2 * q], x[:, 2 * q : 3 * q], x[:, 3 * q :]
        work = torch.cat([a, bq ^ c, c ^ d, d], 1).reshape(b, s, t)
        size *= 2
    return work


def _lanes(x: torch.Tensor, m: int, what: str) -> torch.Tensor:
    n = 1 << m
    if x.dtype != torch.uint8 or x.dim() < 1 or x.shape[0] != n:
        raise ValueError(f"{what}: expected uint8 [{n}, ...], got {x.dtype} {tuple(x.shape)}")
    return x.reshape(1, n, -1)


def afft_fwd(coeffs: torch.Tensor, m: int) -> torch.Tensor:
    """Forward transform (ntt_torch.gf_afft): [2^m, *tail] uint8
    coefficients -> evaluations at afft_points()[:2^m], on their device."""
    n = 1 << m
    work = _lanes(coeffs, m, "afft_fwd")
    t = work.shape[-1]
    s = n
    while s >= 2:
        work = _taylor(work)
        b = work.shape[0]
        w2 = work.reshape(b, s // 2, 2, t)
        work = torch.stack((w2[:, :, 0], w2[:, :, 1]), 1).reshape(2 * b, s // 2, t)
        s //= 2
    b, h = n, 1
    while h < n:
        b2 = b // 2
        w = work.reshape(b2, 2, h, t)
        u, v = w[:, 0], w[:, 1]
        w0 = u ^ _mul_const(h, v)
        work = torch.stack((w0, w0 ^ v), 2).reshape(b2, 2 * h, t)
        b, h = b2, 2 * h
    return work.reshape(coeffs.shape)


def afft_inv(vals: torch.Tensor, m: int) -> torch.Tensor:
    """Inverse transform (ntt_torch.gf_iafft): afft_inv(afft_fwd(c)) == c."""
    n = 1 << m
    work = _lanes(vals, m, "afft_inv")
    t = work.shape[-1]
    b, h = 1, n
    while h > 1:
        w = work.reshape(b, h // 2, 2, t)
        v = w[:, :, 0] ^ w[:, :, 1]
        u = w[:, :, 0] ^ _mul_const(h // 2, v)
        work = torch.stack((u, v), 1).reshape(2 * b, h // 2, t)
        b, h = 2 * b, h // 2
    s = 1
    while s < n:
        b2 = work.shape[0] // 2
        w = work.reshape(b2, 2, s, t)
        work = _itaylor(torch.stack((w[:, 0], w[:, 1]), 2).reshape(b2, 2 * s, t))
        s *= 2
    return work.reshape(vals.shape)
