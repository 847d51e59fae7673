"""Which device events are the program's hand-written kernels, and whose.

The table below is frozen: each kernel of the main path by the name of
its `__global__` function, under the kernel (B1-B4) whose work it does.
A later change to the program cannot move a kernel out of a roofline by
moving or renaming it: a hand-written kernel that the table does not
name is *unlisted*.  Every hand-written kernel is found by scanning the
program's sources (`__global__` functions in any .cu/.cuh, `@triton.jit`
functions in any .py); an unlisted one is charged to every roofline's
time, so a share can only read lower for it, and has a metric of its
own (`unlisted_kernel_ms_per_epoch`).  A device event belongs to a
kernel when the kernel's name appears in the event's name as a whole
word (the profiler gives the demangled signature, template arguments
and all).
"""
from __future__ import annotations

import functools
import re
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

PROGRAM = Path(__file__).resolve().parents[2] / "hydrabadger_tpu_torch"

# kernel -> the __global__ functions that do its work (the program's csrc/)
TABLE: Dict[str, Tuple[str, ...]] = {
    "B1": ("gf256_mma_kernel",),  # csrc/gf256_matmul.cu
    "B2": ("fq_point_block_kernel", "fq_point_kernel"),  # csrc/fq_point.cu
    "B3": ("circuit_chain_kernel", "circuit_kernel"),  # csrc/circuit.cu
    "B4": ("fq2_point_kernel",),  # csrc/fq2_point.cu
    "probes": ("chain_kernel", "mul_kernel", "mul_layer_kernel", "noop_kernel"),  # csrc/fp_probe.cu
}

_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
_TRITON = re.compile(r"@triton\.jit[^\n]*\n(?:\s*@[^\n]*\n)*\s*def\s+(\w+)\s*\(")


def listed(*kernels: str) -> List[str]:
    """The table's function names of the given kernels (all where none)."""
    return sorted({n for k, fns in TABLE.items() if not kernels or k in kernels for n in fns})


@functools.lru_cache(maxsize=None)
def hand_written(program: Path = PROGRAM) -> Tuple[str, ...]:
    """Every hand-written kernel's function name in the program's sources."""
    out = set()
    for pattern, regex in (("*.cu", _GLOBAL), ("*.cuh", _GLOBAL), ("*.py", _TRITON)):
        for path in program.rglob(pattern):
            out.update(regex.findall(path.read_text(errors="replace")))
    return tuple(sorted(out))


def unlisted(program: Path = PROGRAM) -> List[str]:
    """Hand-written kernels that the table does not name."""
    return sorted(set(hand_written(program)) - set(listed()))


def matches(event_name: str, kernel_names: Iterable[str]) -> bool:
    return any(re.search(rf"\b{re.escape(k)}\b", event_name) for k in kernel_names)


def device_us(events, kernel_names: Iterable[str]) -> float:
    """Device microseconds of the events that belong to the named kernels."""
    names = list(kernel_names)
    return sum(e.end - e.start for e in events if names and matches(e.name, names))
