"""Kernel B1's launch parameters, swept on the card at the epoch's shapes.

    python -m hydrabadger_tpu_torch.experiments.prof_gf_tiles

csrc/gf256_matmul.cu has three forms of its product (F = 0: mma.sync.m16n8k32
per warp; 1, 2: wgmma m64nNk32 per warpgroup, passes of N = 32, 64) and runs
blocks of W warps, each warp holding MT M tiles of 16 byte columns
(a tile is 16 * MT * W columns), over a ring of S shared-memory data
tiles.  The wrapper launches with gf256_torch.FORM, WARPS, M_TILES and
STAGES, on the path (tile layout) that gf256_torch.launch_path picks; this
probe runs two epochs' two launches each (the encode (42, 22) into the
codeword's parity rows and the reconstruct (22, 22) from the parity-quorum
view, data from a seed): config 6's (65,536 rows of 12 bytes, 786,432 byte
columns) and rs64-batch64k's (64 rows of 11,637 bytes, 744,768 columns),
at every F, W in (4, 8), MT in gf256_torch.FORM_TILES[F] and S in (2, 3)
through `gf256_torch.tiles`.  The default launch is held equal to the plain
version, and every setting to the default's output.  Each is timed as
chip_smoke times B1 (CUDA events, L2 flushed before each call, median of
20: `ms`) and back to back (the difference of 10 and 2 launches, warm L2:
`warm_ms`).  One JSON line each: shape, the path taken, F, W, MT, S,
whether it is the wrapper's pick, the two times, the bound
(ops/roofline.gf_matmul_ms) and the card.  Then the row and the byte path,
forced, at the default geometry, on the encode over ragged rows of 13 to
515 bytes (~745,000 columns each): where the row path starts to win,
which sets launch_path's threshold.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from ..crypto.rs import decode_matrix, encode_matrix
from ..ops import gf256_torch as gt, roofline
from ._common import card, cuda_device, diff_ms, emit, parser, timed_ms

NODES = 64
EPOCHS = {"config6": (1024, 12), "batch64k": (1, 11_637)}  # instances, shard length
WARPS = (4, 8)
RAGGED = (13, 33, 65, 81, 89, 97, 129, 161, 193, 225, 257, 385, 515)  # shard lengths


def _shapes(dev, instances: int, shard_len: int):
    """(label, operand, data view, out view) of the epoch's two launches."""
    f = (NODES - 1) // 3
    k, p = NODES - 2 * f, 2 * f
    B = NODES * instances
    rng = np.random.default_rng(6)
    data = torch.from_numpy(rng.integers(0, 256, (B, k, shard_len), dtype=np.uint8)).to(dev)
    codeword = torch.empty((B, k + p, shard_len), dtype=torch.uint8, device=dev)
    codeword[:, :k] = data
    enc = gt.operand(encode_matrix(k, p)[k:], dev)
    dec = gt.operand(decode_matrix(k, p, tuple(range(p, k + p))), dev)
    gt.gf_matmul(enc, data, out=codeword[:, k:])
    recovered = torch.empty_like(data)
    return [("encode", enc, data, codeword[:, k:]),
            ("reconstruct", dec, codeword[:, p:], recovered)]


def _launch(op, x, y) -> str:
    """One launch of the wrapper; returns the path it took."""
    before = dict(gt.launches_by_path)
    gt._launch(op, x, y)
    return next(p for p, n in gt.launches_by_path.items() if n > before[p])


def _sweep(flush, epoch: str, shapes) -> list:
    rows = []
    for label, op, x, y in shapes:
        m, k = op.shape
        want = gt.gf_matmul(op, x)
        if not torch.equal(want, gt.gf_matmul_bits_plain(op, x)):
            raise RuntimeError(f"{epoch} {label}: kernel != plain version")
        ops_ms, bytes_ms = roofline.gf_matmul_ms(m, k, x.shape[0] * x.shape[2])
        bound = max(ops_ms, bytes_ms)
        settings = [(f, w, mt, s) for f, mts in gt.FORM_TILES.items()
                    for w, mt, s in itertools.product(WARPS, mts, gt.STAGE_COUNTS)]
        for f, w, mt, s in settings:
            with gt.tiles(form=f, warps=w, m_tiles=mt, stages=s):
                y.fill_(0)
                path = _launch(op, x, y)
                if not torch.equal(y, want):
                    raise RuntimeError(f"{epoch} {label} at F={f} W={w} MT={mt} S={s} "
                                       "!= the default")
                ms = timed_ms(lambda: gt._launch(op, x, y), 20, flush)

                def run(n):
                    for _ in range(n):
                        gt._launch(op, x, y)

                warm_ms = diff_ms(run, 2, 10)
            picked = (f, w, mt, s) == (gt.FORM, gt.WARPS, gt.M_TILES, gt.STAGES)
            rows.append({"shape": f"{epoch} {label} ({m},{k})", "path": path, "form": f,
                         "warps": w, "m_tiles": mt, "stages": s, "picked": picked, "ms": ms,
                         "warm_ms": warm_ms, "bound_ms": bound,
                         "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                         "ms_over_bound": ms / bound})
    return rows


def _crossover(dev, flush) -> list:
    """The encode over ragged rows, forced onto the byte and the row path."""
    rows = []
    for L in RAGGED:
        instances = max(1, round(745_000 / (NODES * L)))
        _label, op, x, y = _shapes(dev, instances, L)[0]
        want = gt.gf_matmul_bits_plain(op, x)
        y.fill_(0)
        picked = _launch(op, x, y)
        ms = {}
        for path in ("bytes", "rows"):
            y.fill_(0)
            gt._launch(op, x, y, path)
            if not torch.equal(y, want):
                raise RuntimeError(f"encode at L={L} on the {path} path != plain")
            ms[path] = timed_ms(lambda: gt._launch(op, x, y, path), 20, flush)
        rows.append({"shape": "encode (42,22)", "shard_len": L, "columns": x.shape[0] * L,
                     "bytes_ms": ms["bytes"], "rows_ms": ms["rows"],
                     "rows_over_bytes": ms["rows"] / ms["bytes"], "picked": picked})
    return rows


def measure(device="cuda") -> list:
    dev = cuda_device(device)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    rows = []
    for epoch, (instances, shard_len) in EPOCHS.items():
        rows += _sweep(flush, epoch, _shapes(dev, instances, shard_len))
    return rows + _crossover(dev, flush)


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    emit(measure(args.device), card(cuda_device(args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
