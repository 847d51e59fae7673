"""The Fp probes E1-E4 — kernel `fp_probe` and its plain versions.

Counterpart of the Pallas prototypes that measured the TPU's Fp floor:
experiments/pallas_fq.py (E1, a fused Montgomery product),
experiments/prof_mul_variants.py (E2, the product's parts chained inside
one kernel), experiments/prof_mix_vs_mul.py (E3, a circuit's multiply
layer alone) and experiments/prof_fixed_cost.py (E4, the fixed cost of a
launch).  The kernel is csrc/fp_probe.cu; its product is fp381.cuh's, the
one kernels B2-B4 run.  Layout: [12, n] int32 words, lane axis last,
Montgomery form with R = 2^384 (ops/limbs).  The probe modules under
hydrabadger_tpu_torch/experiments/ time these entries on the card.

    fp_mul(a, b, threads)          a*b/R mod p, `threads` per block (E1)
    fp_chain(x, b, body, iters)    `iters` chained x = body(x, b) in one
                                   launch (E2); body "full", "fdigit"
                                   (schoolbook on the FP64 pipe, the same
                                   canonical result), "product" (a*b mod
                                   2^384) or "carry" ((a + b) mod 2^384)
    fp_mul_layer(x, threads)       [12, 2W] -> [12, W]: column l times
                                   column W + l (E3)
    noop(x, inner)                 x + inner on int32 (E4)

Each wrapper launches the kernel for a CUDA tensor (or raises) and runs
the plain version for a CPU tensor; `*_plain` runs the plain version on
any device.  The plain versions work in fq_torch's 16-bit-digit half form.
"""
from __future__ import annotations

import torch

from . import _kernels
from .fq_torch import N_HALF, _carry, _conv, fq_mul_plain, mont_mul_h, to_half, to_words
from .limbs import N_LIMBS
from .roofline import OPS_PER_PRODUCT

# Kernel launches made by the wrappers (one per launch, none for CPU
# tensors), in all and per entry.
launches = 0
launches_by_entry: dict[str, int] = {}

KIND_MUL, KIND_CHAIN, KIND_MUL_LAYER, KIND_NOOP = range(4)
BODIES = ("full", "fdigit", "product", "carry")
CHAIN_THREADS = 128  # csrc/fp_probe.cu's block for `chain`
NOOP_THREADS = 256

# int8 operations of one body per lane, counted at the card's int8 peak
# in the cheapest exact form (ops/roofline): a whole Fp product for `full`
# and `fdigit`; `product` is the low half of a*b alone (48 * 49 / 2 digit
# MACs, 2 ops each); `carry` one add per byte of the 384-bit sum.
OPS = {"full": OPS_PER_PRODUCT, "fdigit": OPS_PER_PRODUCT,
       "product": 2 * (48 * 49 // 2), "carry": 48}


# ---------------------------------------------------------------------------
# Plain versions (any device)
# ---------------------------------------------------------------------------


def _body_h(body: str):
    if body in ("full", "fdigit"):
        return mont_mul_h
    if body == "product":
        return lambda a, b: _carry(_conv(a, b)[:N_HALF])
    if body == "carry":
        return lambda a, b: _carry(a + b)
    raise ValueError(f"unknown chain body {body!r}; have {BODIES}")


def fp_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fq_mul_plain(a, b)


def fp_chain_plain(x: torch.Tensor, b: torch.Tensor, body: str, iters: int) -> torch.Tensor:
    fn = _body_h(body)
    h = to_half(x.reshape(N_LIMBS, -1))
    hb = to_half(b.reshape(N_LIMBS, -1))
    for _ in range(iters):
        h = fn(h, hb)
    return to_words(h).reshape(x.shape)


def fp_mul_layer_plain(x: torch.Tensor) -> torch.Tensor:
    w = x.shape[1] // 2
    return fq_mul_plain(x[:, :w], x[:, w:])


def noop_plain(x: torch.Tensor, inner: int = 1) -> torch.Tensor:
    return x + inner


# ---------------------------------------------------------------------------
# The kernel's wrappers
# ---------------------------------------------------------------------------


def _check(x: torch.Tensor, what: str, words: bool = True) -> None:
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int32:
        raise TypeError(f"{what}: expected an int32 tensor")
    if words and (x.dim() != 2 or x.shape[0] != N_LIMBS):
        raise ValueError(f"{what}: expected [{N_LIMBS}, n], got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu tensors, not {x.device}")


def _empty(like: torch.Tensor) -> torch.Tensor:
    return torch.empty(like.shape, dtype=torch.int32, device=like.device)


def _launch(kind: int, label: str, ins, out: torch.Tensor, n: int, body: int = 0,
            iters: int = 0, threads: int = 128) -> torch.Tensor:
    """One csrc/fp_probe.cu launch over n lanes of `ins` (one or two
    tensors on one card) into `out`."""
    global launches
    dev = ins[0].device
    if any(x.device != dev for x in ins):
        raise ValueError("fp_probe: operands must share one device")
    if threads < 32 or threads > 512 or threads % 32:
        raise ValueError(f"fp_probe: threads per block {threads} not a multiple of 32 in [32, 512]")
    flat = [x.contiguous() for x in ins]
    if n:
        lib = _kernels.load("fp_probe")
        b_ptr = flat[1].data_ptr() if len(flat) > 1 else 0
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fp_probe_launch(dev.index, kind, body, iters, threads, flat[0].data_ptr(),
                                 b_ptr, out.data_ptr(), n, stream)
        _kernels.check("fp_probe", lib, rc, "fp_probe_error_string")
        launches += 1
        launches_by_entry[label] = launches_by_entry.get(label, 0) + 1
    return out


def fp_mul(a: torch.Tensor, b: torch.Tensor, threads: int = 128) -> torch.Tensor:
    """[12, n] x [12, n] -> a*b/R mod p (E1), `threads` lanes per block."""
    _check(a, "fp_mul")
    _check(b, "fp_mul")
    if a.shape != b.shape:
        raise ValueError("fp_mul: operands must share one shape")
    if a.device.type == "cuda":
        return _launch(KIND_MUL, "mul", (a, b), _empty(a), a.shape[1],
                       threads=threads)
    return fp_mul_plain(a, b)


def fp_chain(x: torch.Tensor, b: torch.Tensor, body: str, iters: int) -> torch.Tensor:
    """`iters` chained x = body(x, b) in one launch (E2)."""
    _check(x, "fp_chain")
    _check(b, "fp_chain")
    if x.shape != b.shape:
        raise ValueError("fp_chain: operands must share one shape")
    if body not in BODIES:
        raise ValueError(f"unknown chain body {body!r}; have {BODIES}")
    if iters < 0:
        raise ValueError("fp_chain: iters must be >= 0")
    if x.device.type == "cuda":
        return _launch(KIND_CHAIN, f"chain_{body}", (x, b), _empty(x), x.shape[1],
                       body=BODIES.index(body), iters=iters, threads=CHAIN_THREADS)
    return fp_chain_plain(x, b, body, iters)


def fp_mul_layer(x: torch.Tensor, threads: int = 128) -> torch.Tensor:
    """[12, 2W] stacked operand -> [12, W]: column l times column W + l (E3)."""
    _check(x, "fp_mul_layer")
    if x.shape[1] % 2:
        raise ValueError("fp_mul_layer: expected [12, 2W]")
    w = x.shape[1] // 2
    if x.device.type == "cuda":
        out = torch.empty((N_LIMBS, w), dtype=torch.int32, device=x.device)
        return _launch(KIND_MUL_LAYER, "mul_layer", (x,), out, w, threads=threads)
    return fp_mul_layer_plain(x)


def noop(x: torch.Tensor, inner: int = 1) -> torch.Tensor:
    """x + inner on any int32 tensor, `inner` adds in the kernel (E4)."""
    _check(x, "noop", words=False)
    if inner < 0:
        raise ValueError("noop: inner must be >= 0")
    if x.device.type == "cuda":
        return _launch(KIND_NOOP, "noop", (x,), _empty(x), x.numel(), iters=inner,
                       threads=NOOP_THREADS)
    return noop_plain(x, inner)

