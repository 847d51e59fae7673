"""E3 on the card: a circuit's multiply layer alone, against kernel B3.

    python -m hydrabadger_tpu_torch.experiments.prof_mix_vs_mul

Counterpart of experiments/prof_mix_vs_mul.py, which timed one stacked
lazy Montgomery multiply of a [32, 2 * lanes * b] operand's halves (a
circuit's multiply layer without its mixes) in blocks of 64 or 128 lanes.
Here `fp_probe`'s `mul_layer` entry multiplies column l of a [12, 2W]
stacked operand by column W + l, W = lanes * batch = 18,432 products,
reading lane-fastest words from device memory, and B3 (csrc/circuit.cu)
itself runs the decrypt epoch's `add` circuit (16 products per lane) at
W / 16 = 1152 lanes, the same number of products.  What B3 spends per
product beyond `mul_layer`'s is what its program walk, mixes and layer
barriers cost.
Each is timed by the difference of 100 and 10 launches (CUDA events) and
first held against its plain version.  One JSON line each: ms per launch,
ns per product, the bound (bytes: the elements read and written once;
operations: the products at the int8 peak), the plain version's ms.
"""
from __future__ import annotations

import torch

from ..ops import fp_probe_torch as fp
from ..ops.decrypt_torch import _add_circuit
from ._common import card, cuda_device, diff_ms, emit, fp_operands, parser, product_bound_ms, wall_ms

LANES, BATCH, THREADS = 18, 1024, (64, 128)
LO, HI = 10, 100


def _repeat(fn):
    def run(k):
        for _ in range(k):
            fn()
    return run


def measure(device="cuda") -> list:
    dev = cuda_device(device)
    w = LANES * BATCH
    x = fp_operands(2 * w, 5, dev)
    plain = wall_ms(lambda: fp.fp_mul_layer_plain(x))
    bound, by = product_bound_ms(w, 3 * w)
    rows = []
    for t in THREADS:
        if not torch.equal(fp.fp_mul_layer(x, t), fp.fp_mul_layer_plain(x)):
            raise RuntimeError("fp_probe mul_layer != its plain version")
        ms = diff_ms(_repeat(lambda t=t: fp.fp_mul_layer(x, t)), LO, HI)
        rows.append({"probe": "E3", "entry": "mul_layer", "products": w, "threads": t, "ms": ms,
                     "ns_per_product": ms * 1e6 / w, "bound_ms": bound, "bound_by": by,
                     "plain_ms": plain})
    circ = _add_circuit()
    n = w // circ.n_products
    xin = fp_operands(circ.n_inputs * n, 6, dev).reshape(12, circ.n_inputs, n).transpose(0, 1)
    xin = xin.contiguous()  # [6, 12, n]
    if not torch.equal(circ(xin), circ.plain(xin)):
        raise RuntimeError("circuit add != its plain version")
    ms = diff_ms(_repeat(lambda: circ(xin)), LO, HI)
    c_bound, c_by = product_bound_ms(circ.n_products * n, (circ.n_inputs + circ.n_outputs) * n)
    rows.append({"probe": "E3", "entry": f"circuit {circ.name}", "lanes": n,
                 "products": circ.n_products * n, "ms": ms,
                 "ns_per_product": ms * 1e6 / (circ.n_products * n), "bound_ms": c_bound,
                 "bound_by": c_by, "plain_ms": wall_ms(lambda: circ.plain(xin))})
    return rows


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    emit(measure(args.device), card(cuda_device(args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
