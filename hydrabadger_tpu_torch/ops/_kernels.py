"""Build the port's CUDA sources with nvcc and bind them with ctypes.

Each `csrc/*.cu` source has a plain C interface and compiles on its own:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/torch_kernels/<name>-<hash>.so

into `build/torch_kernels/` at the repository root (listed in .gitignore).
The file name carries a hash of the sources and flags, so an edit to a
source rebuilds it and an unchanged source loads the library already
built.  Nothing here runs at import: the first CUDA launch builds what it
needs (`load`), and `build` builds a set of libraries in parallel, one
nvcc each, all started together.  A file lock (`build/torch_kernels/
build.lock`, fcntl.flock) makes one process build while the others wait
and then load its libraries: node processes started together on one card
each run nvcc on nothing.

Every pointer and the stream cross as `c_void_p`, 64-bit integers as
`c_longlong`.  Each C launch entry returns `cudaGetLastError()`, and
`check` raises on anything but 0.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int

# library name -> (source in csrc/, {C function: (argtypes, restype)})
LIBRARIES = {
    "gf256_matmul": (
        "gf256_matmul.cu",
        {
            # device, bop, bop_bytes, data, d_sb, d_sk, d_sl, out, o_sb, o_sm,
            # o_sl, m, k, L, B, form, warps, m_tiles, stages, row, smem,
            # accumulate, layout, stream
            "gf256_matmul_launch": (
                [_I, _P, _I, _P, _LL, _LL, _LL, _P, _LL, _LL, _LL,
                 _I, _I, _I, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _P],
                _I,
            ),
            "gf256_error_string": ([_I], ctypes.c_char_p),
        },
    ),
    "fq_point": (
        "fq_point.cu",
        {
            # device, kind, k, set, set_len, smem, warps, a, b, c, digits,
            # windows, table, out, n, stream
            "fq_point_launch": (
                [_I, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P, _LL, _P],
                _I,
            ),
            "fq_point_error_string": ([_I], ctypes.c_char_p),
        },
    ),
    "circuit": (
        "circuit.cu",
        {
            # device, prog, prog_len, smem, warps, in, consts, n_const, out, n, stream
            "circuit_launch": ([_I, _P, _I, _I, _I, _P, _P, _I, _P, _LL, _P], _I),
            # device, progs, progs_len, smem, warps, steps, n_steps, table,
            # n_entries, acc_in, consts, n_const, acc_out, n, n_acc, stream
            "circuit_chain_launch": (
                [_I, _P, _I, _I, _I, _P, _I, _P, _LL, _P, _P, _I, _P, _LL, _I, _P],
                _I,
            ),
            "circuit_error_string": ([_I], ctypes.c_char_p),
        },
    ),
    "fq2_point": (
        "fq2_point.cu",
        {
            # device, kind, set, set_len, smem, warps, a, b, digits, windows,
            # table, out, n, stream
            "fq2_point_launch": ([_I, _I, _P, _I, _I, _I, _P, _P, _P, _I, _P, _P, _LL, _P], _I),
            "fq2_point_error_string": ([_I], ctypes.c_char_p),
        },
    ),
    "fp_probe": (
        "fp_probe.cu",
        {
            # device, kind, body, iters, threads, a, b, out, n, stream
            "fp_probe_launch": ([_I, _I, _I, _I, _I, _P, _P, _P, _LL, _P], _I),
            "fp_probe_error_string": ([_I], ctypes.c_char_p),
        },
    ),
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for cand in candidates:
        if os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's CUDA "
        "kernels are built from csrc/ at their first launch"
    )


def library_path(name: str) -> Path:
    """Where `name`'s library lives: keyed by its source, headers and flags."""
    source, _ = LIBRARIES[name]
    h = hashlib.sha256()
    for path in [CSRC_DIR / source, *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, tuple[float, str]]:
    """Build every library in `names` (default: all) that is not built yet.

    One nvcc per source, all started together.  Returns, for each library
    built now, (seconds, compiler output: ptxas registers and shared
    memory per kernel).  Raises RuntimeError naming each failed build.
    """
    names = list(LIBRARIES) if names is None else list(names)
    if all(library_path(n).exists() for n in names):
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        # another process may have built them while we waited
        todo = [n for n in names if not library_path(n).exists()]
        return _build_locked(todo) if todo else {}


def _build_locked(todo: list) -> dict[str, tuple[float, str]]:
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        target = library_path(name)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / LIBRARIES[name][0])]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            target,
            time.perf_counter(),
        )
    done = {}

    def finish(name, proc, t0):  # each build's own seconds, not its turn to be read
        output, _ = proc.communicate()
        done[name] = (output, time.perf_counter() - t0)

    waiters = [threading.Thread(target=finish, args=(name, proc, t0))
               for name, (proc, _, _, t0) in procs.items()]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    built, failed = {}, []
    for name, (proc, tmp, target, _) in procs.items():
        output, seconds = done[name]
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{output}")
            continue
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
        built[name] = (seconds, output)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return built


def load(name: str) -> ctypes.CDLL:
    """The bound library `name`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (argtypes, restype) in LIBRARIES[name][1].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _loaded[name] = lib
        return lib


def check(name: str, lib: ctypes.CDLL, rc: int, error_fn: str) -> None:
    """Raise if a launch entry returned a CUDA error code."""
    if rc != 0:
        msg = getattr(lib, error_fn)(rc)
        # hblint: disable=secret-taint -- rc is the launch's CUDA status code and msg the runtime's fixed error string for it; the analyzer joins an opaque ctypes call's return with its pointer arguments, but no lane value comes back through the status int
        raise RuntimeError(
            f"{name} launch failed: CUDA error {rc} "
            f"({msg.decode() if msg else 'unknown'})"
        )
