"""Where kernel B1's time goes: variants of its source, timed on the card.

    python -m hydrabadger_tpu_torch.experiments.prof_gf_variants

Builds csrc/gf256_matmul.cu as it is and four edited copies (nvcc, the
same flags, into build/torch_kernels/variants/), and runs each at two
epochs' two launches (the encode (42, 22) into the codeword's parity rows
and the reconstruct (22, 22) from the parity-quorum view; data from a
seed): config 6's on the word path and rs64-batch64k's on the row path
(experiments/prof_gf_tiles.EPOCHS), each with the wrapper's path and
launch shape (gf256_torch.launch_path, launch_shape):

  kernel       the source as it is;
  no_pack      the mod-2-and-pack epilogue replaced by an XOR of every sum,
               stored only when it equals a value no input gives, so every
               product stays live and nothing is packed or stored (the row
               path's staged rows are not written out either);
  no_wait      no_pack, and the passes issued back to back with one wait
               per column tile: the tensor cores' rate in this structure;
  swizzle128   A's bits in wgmma's 128-byte-swizzled K-major layout instead
               of the unswizzled one (the operand re-laid here);
  no_realign   the row path's A fragments read as the word path reads them,
               without each data row's byte shift: what the realignment
               costs (no_pack bounds what any other store could save).

`kernel` and `swizzle128` are held equal to the plain version (`exact`);
the other three compute no product (no_realign a wrong one on rows).  Each is timed as chip_smoke times B1
(CUDA events, L2 flushed before each call, median of 20: `ms`) and back to
back (`warm_ms`).  One JSON line each, with the padded work's int8 rate
(`tops`: 2 * 64 * ceil4(m) * ceil4(k) operations per column) and the card.
Each edit finds its anchor in the source or raises.
"""
from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch

from ..ops import _kernels, gf256_torch as gt
from . import prof_gf_tiles
from ._common import card, cuda_device, diff_ms, emit, parser, timed_ms

_SINK = ("uint32_t x = 0; _Pragma(\"unroll\") for (int mt = 0; mt < MT; ++mt) "
         "_Pragma(\"unroll\") for (int q = 0; q < NQ; ++q) _Pragma(\"unroll\") "
         "for (int r = 0; r < 4; ++r) x ^= (uint32_t)acc[mt][q][r]; "
         "if (x == 0x7fffffffu && m == 77777) *out = (uint8_t)x;")

_PACK = """        if constexpr (ROWS)
          epilogue<MT, NQ, true>(acc, G0, ng, t, m, off, live, ost, orow, 0);
        else
          epilogue<MT, NQ, WORDS>(acc, G0, ng, t, m, off, live, out, o_sm, accumulate);"""
_PASS_LOOP = """        int acc[MT][NQ][4];
        for (int kc = 0; kc < KT; kc += kKC) {
          if (G0 == 0 || KT > kKC)
            expand_a<MT, ROWS>(a, st, row, wcol, t, kc, KT, rlo, (uint32_t)d_sk);
          wgmma_pass<FORM, MT, NQ>(acc, a, desc0, kc, KT, NT, G0, ng);
          wgmma_wait<0>();  // before the A fragments or the sums are touched
        }
""" + _PACK


def _edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"prof_gf_variants: anchor not in the source: {old[:60]!r}")
    return src.replace(old, new)


def _body(src: str, signature: str, body: str) -> str:
    """`src` with the body of the function that starts at `signature` replaced."""
    start = src.find(signature)
    if start < 0:
        raise RuntimeError(f"prof_gf_variants: no {signature!r} in the source")
    i = src.index("{", start)
    depth = 0
    for j in range(i, len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return src[:i] + "{" + body + "}" + src[j + 1:]
    raise RuntimeError("prof_gf_variants: unbalanced braces")


def variants(src: str) -> dict[str, str]:
    no_pack = _body(_body(src, "__device__ __forceinline__ void epilogue(", _SINK),
                    "__device__ __forceinline__ void store_rows(", "")
    # the sums are read once per tile, after its last pass: reading them while
    # a pass is in flight would make ptxas serialize every wgmma
    no_wait = _edit(no_pack, _PASS_LOOP, _PASS_LOOP.replace(
        "          wgmma_wait<0>();  // before the A fragments or the sums are touched\n", "")
        .replace(_PACK, "        if (G0 + GS >= NG) {\n          wgmma_wait<0>();\n" + _PACK
                 + "\n        }"))
    sw = _edit(src, "return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |\n"
               "         ((uint64_t)(256 >> 4) << 32);",
               "return (uint64_t)((saddr & 0x3FFFF) >> 4) | (1ull << 16) |\n"
               "         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);")
    sw = _edit(sw, "desc[kk] = desc0 + 16 * (uint64_t)((kc + kk) * NT + 4 * G0);",
               "desc[kk] = desc0 + (uint64_t)((((kc + kk) >> 2) * NT + 4 * G0) * 64"
               " + ((kc + kk) & 3) * 2);")
    sw = _edit(sw, "  uint8_t* bsh = smem;\n  uint8_t* ring = smem + bop_bytes;",
               "  uint8_t* bsh = smem + ((1024 - ((uint32_t)__cvta_generic_to_shared(smem) & 1023))"
               " & 1023);\n  uint8_t* ring = bsh + bop_bytes;")
    sw = _edit(sw, "bop_bytes != 64 * mp * kp ||", "")
    sw = _edit(sw, "(long long)smem < (long long)bop_bytes", "(long long)smem < 1024LL + bop_bytes")
    no_realign = _edit(src, "        if constexpr (ROWS) {\n          const int o = wcol",
                       "        if constexpr (false) {\n          const int o = wcol")
    return {"kernel": src, "no_pack": no_pack, "no_wait": no_wait, "swizzle128": sw,
            "no_realign": no_realign}


def swizzle128_operand(matrix: np.ndarray) -> np.ndarray:
    """`gt.b_operand` re-laid in the 128-byte swizzle: rows of 128 bytes (4
    K tiles), 8 rows per N tile (1024 B), each 16-byte chunk's index XORed
    with the row."""
    tiles = gt.b_operand(matrix)  # [kt, nt, 2 K halves, 8, 16]
    kt_n, nt_n = tiles.shape[:2]
    tiles = tiles.transpose(0, 1, 3, 2, 4).reshape(kt_n, nt_n, 8, 32)
    kb = -(-kt_n // 4)
    logical = np.zeros((kb * 4, nt_n, 8, 32), dtype=np.uint8)
    logical[:kt_n] = tiles
    logical = logical.reshape(kb, 4, nt_n, 8, 32).transpose(0, 2, 3, 1, 4).reshape(-1)
    off = np.arange(logical.size)
    out = np.empty_like(logical)
    out[off ^ (((off >> 7) & 7) << 4)] = logical
    return out


def _build(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    folder = _kernels.BUILD_DIR / "variants"
    folder.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (folder / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-o", str(folder / f"{name}.so"),
             str(folder / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        output, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{output}")
        lib = ctypes.CDLL(str(folder / f"{name}.so"))
        for fn, (argtypes, restype) in _kernels.LIBRARIES["gf256_matmul"][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs


def measure(device="cuda") -> list:
    dev = cuda_device(device)
    libs = _build(variants((_kernels.CSRC_DIR / "gf256_matmul.cu").read_text()))
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    rows = []
    shapes = [(epoch, *s) for epoch, size in prof_gf_tiles.EPOCHS.items()
              for s in prof_gf_tiles._shapes(dev, *size)]
    for epoch, label, op, x, y in shapes:
        m, k = op.shape
        B, _, L = x.shape
        want = gt.gf_matmul_bits_plain(op, x)
        shape = gt.launch_shape(m, k)
        path = gt.launch_path(L, x.data_ptr(), x.stride(), y.data_ptr(), y.stride(),
                              16 * shape.warps * shape.m_tiles)
        shape = gt.launch_shape(m, k, rows=path == "rows")
        layout = gt.PATHS.index(path)
        tops_ops = 2 * 64 * (-(-m // 4) * 4) * (-(-k // 4) * 4) * B * L
        for name, lib in libs.items():
            swz = name == "swizzle128"
            host = swizzle128_operand(op.matrix) if swz else gt.b_operand(op.matrix).reshape(-1)
            bop = torch.from_numpy(host).to(dev)
            smem = shape.smem - 64 * (-(-m // 4) * 4) * (-(-k // 4) * 4) + bop.numel() + 1024 * swz

            def launch():
                rc = lib.gf256_matmul_launch(
                    x.device.index, bop.data_ptr(), bop.numel(), x.data_ptr(), *x.stride(),
                    y.data_ptr(), *y.stride(), m, k, L, B, shape.form, shape.warps,
                    shape.m_tiles, shape.stages, shape.row, smem, 0, layout,
                    torch.cuda.current_stream(dev).cuda_stream)
                _kernels.check(f"gf256_matmul variant {name}", lib, rc, "gf256_error_string")

            y.fill_(0)
            launch()
            exact = bool(torch.equal(y, want)) if name in ("kernel", "swizzle128") else None
            if exact is False:
                raise RuntimeError(f"variant {name} at {label} != the plain version")
            ms = timed_ms(launch, 20, flush)

            def run(n):
                for _ in range(n):
                    launch()

            warm = diff_ms(run, 2, 10)
            rows.append({"variant": name, "shape": f"{epoch} {label} ({m},{k})", "path": path,
                         "exact": exact,
                         "ms": ms, "warm_ms": warm, "tops": tops_ops / ms / 1e9,
                         "launch": shape._asdict()})
        y.copy_(want)  # the reconstruct reads the encode's output
    return rows


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    emit(measure(args.device), card(cuda_device(args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
