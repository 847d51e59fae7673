"""E1 on the card: ns per Fp product of a standalone product kernel.

    python -m hydrabadger_tpu_torch.experiments.cuda_fq [--lanes 65536]
        [--chain 128] [--threads 64 128 256 512]

Counterpart of experiments/pallas_fq.py (the fused Pallas Montgomery
product, [32, B] 12-bit limbs in blocks of `blk` lanes).  Here the product
is `fp_probe`'s `mul` entry (fp381.cuh's CIOS over 32-bit words, one lane
per thread) over [12, B] words with `threads` lanes per block, timed as
the Pallas script times it: R dependent launches x = x * b minus R/8 of
them, by CUDA events.  First the result is held against Python integers.
One JSON line per block width: ms per launch, ns per product, the bound
(the larger of the bytes, three elements per lane, and the int8
operations of the products), the plain version's ms per launch.
"""
from __future__ import annotations

from ..ops import fp_probe_torch as fp
from ..ops import limbs
from ._common import card, cuda_device, diff_ms, emit, fp_operands, parser, product_bound_ms, wall_ms

LANES, CHAIN, THREADS = 65536, 128, (64, 128, 256, 512)


def check_exact(a, b) -> None:
    """The kernel's first 8 lanes against a*b/R mod p in Python integers."""
    got = limbs.limbs_to_ints_batch(fp.fp_mul(a, b).T[:8].cpu().numpy())
    x = limbs.limbs_to_ints_batch(a.T[:8].cpu().numpy())
    y = limbs.limbs_to_ints_batch(b.T[:8].cpu().numpy())
    want = [u * v * limbs.R_INV % limbs.P for u, v in zip(x, y)]
    if got != want:
        raise RuntimeError("fp_probe mul != a*b/R mod p")


def measure(device="cuda", lanes: int = LANES, chain: int = CHAIN, threads=THREADS) -> list:
    dev = cuda_device(device)
    a, b = fp_operands(lanes, 1, dev), fp_operands(lanes, 2, dev)
    check_exact(a, b)
    plain = wall_ms(lambda: fp.fp_mul_plain(a, b))
    bound, by = product_bound_ms(lanes, 3 * lanes)
    rows = []
    for t in threads:
        def run(k, t=t):
            x = a
            for _ in range(k):
                x = fp.fp_mul(x, b, t)

        ms = diff_ms(run, chain // 8, chain)
        rows.append({"probe": "E1", "entry": "mul", "lanes": lanes, "threads": t, "ms": ms,
                     "ns_per_product": ms * 1e6 / lanes, "bound_ms": bound, "bound_by": by,
                     "plain_ms": plain})
    return rows


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--lanes", type=int, default=LANES)
    ap.add_argument("--chain", type=int, default=CHAIN)
    ap.add_argument("--threads", type=int, nargs="+", default=list(THREADS))
    args = ap.parse_args(argv)
    rows = measure(args.device, args.lanes, args.chain, args.threads)
    emit(rows, card(cuda_device(args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
