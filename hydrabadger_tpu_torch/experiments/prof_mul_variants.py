"""E2 on the card: the Fp product's parts, each chained inside one kernel.

    python -m hydrabadger_tpu_torch.experiments.prof_mul_variants
        [--lanes 8192 4096 94208]

Counterpart of experiments/prof_mul_variants.py, which chained x = body(x,
b) in a Pallas fori_loop at two lengths (10 and 110).  Here `fp_probe`'s `chain` entry
runs the loop inside one launch, one lane per thread, and the difference
of the two lengths gives the time of one body over all lanes.  Bodies:

    full     fp381.cuh's Montgomery product (CIOS, 32-bit words), the
             product kernels B2-B4 run
    fdigit   the same Montgomery product with its schoolbook on the FP64
             pipe (16 24-bit digits: every partial sum below 2^53, so exact)
             and an integer word-serial reduction: the same canonical bits
             (the Pallas script's f32_conv_mul asked the same of the TPU's
             f32 pipe)
    product  the unreduced schoolbook's low 384 bits, a*b mod 2^384: the
             nearest value-level counterpart of the Pallas script's
             "convolution only + mask", a layout artifact of 12-bit limbs
    carry    (a + b) mod 2^384 over 12 words, its "carry only"

Every body is first held against its plain version on 64 lanes.  One JSON
line per (body, lanes): ms per body over all lanes, ns per lane, the
bound of one body (its int8 operations at the card's peak: the loads and
stores of a chain cancel in the difference), the plain version's ms for
one body.  The default lanes are the
Pallas script's 8192 and the decrypt path's 4096 and 94,208.
"""
from __future__ import annotations

from ..ops import fp_probe_torch as fp
from ._common import bound_ms, card, cuda_device, diff_ms, emit, fp_operands, parser, wall_ms

LANES, ITERS = (8192, 4096, 94208), (10, 110)


def measure(device="cuda", lanes=LANES) -> list:
    dev = cuda_device(device)
    lo, hi = ITERS
    rows = []
    for n in lanes:
        x, b = fp_operands(n, 3, dev), fp_operands(n, 4, dev)
        for body in fp.BODIES:
            if not fp.fp_chain(x[:, :64], b[:, :64], body, 3).cpu().equal(
                    fp.fp_chain_plain(x[:, :64].cpu(), b[:, :64].cpu(), body, 3)):
                raise RuntimeError(f"fp_probe chain {body} != its plain version")
            ms = diff_ms(lambda k: fp.fp_chain(x, b, body, k), lo, hi)
            bound, by = bound_ms(fp.OPS[body] * n, 0)
            plain = wall_ms(lambda: fp.fp_chain_plain(x, b, body, 1))
            rows.append({"probe": "E2", "entry": "chain", "body": body, "lanes": n, "ms": ms,
                         "ns_per_lane": ms * 1e6 / n, "bound_ms": bound, "bound_by": by,
                         "plain_ms": plain})
    return rows


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--lanes", type=int, nargs="+", default=list(LANES))
    args = ap.parse_args(argv)
    emit(measure(args.device, args.lanes), card(cuda_device(args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
