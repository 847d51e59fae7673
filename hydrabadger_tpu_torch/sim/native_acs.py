"""ctypes bridge to the native ACS core (native/acs_engine.cpp).

The port's copy of hydrabadger_tpu/sim/native_acs.py.  One `acs_run` call
runs a whole fast-tier epoch's Subset message storm for all N nodes in
host C++: Bracha RBC (RS, Merkle and the split-root re-encode checks),
binary agreement with the hash coin, and the subset sweep.  The Python
consensus cores stay the semantic oracle; the DHB layer (votes, the DKG
transcript, era switches) consumes the agreed subset in Python
(sim/network.SimNetwork's native epoch).

The library is built from the repo's source into
build/host_native/libacs.so at first use (utils/host_native), never loaded
from native/.  A build or load that fails raises (the JAX package returns
None and runs the Python cores).  HYDRABADGER_NO_NATIVE_ACS set to anything
non-empty makes `available()` false, as in the JAX package.  The library is
held at module level, so a sim snapshot never reaches a ctypes handle.
"""
from __future__ import annotations

import ctypes
import os
from typing import List, Sequence, Tuple

from ..utils import host_native

_LIB = None


def _load():
    """The loaded library, built first where needed; raises on failure."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(host_native.ACS.build()))
        lib.acs_run.restype = ctypes.c_int64
        lib.acs_run.argtypes = [
            ctypes.c_int32,  # n
            ctypes.c_int32,  # f
            ctypes.c_char_p,  # sid
            ctypes.c_int32,  # sid_len
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),  # payloads
            ctypes.POINTER(ctypes.c_int32),  # payload lengths
            ctypes.c_int32,  # shuffle
            ctypes.c_uint64,  # seed
            ctypes.c_uint64,  # max messages (0: the core's own bound)
            ctypes.POINTER(ctypes.c_uint8),  # out mask
            ctypes.POINTER(ctypes.c_uint64),  # out stats
        ]
        _LIB = lib
    return _LIB


def available() -> bool:
    """False where HYDRABADGER_NO_NATIVE_ACS opts out; else True once the
    library is built and loaded (raising if that fails)."""
    if os.environ.get("HYDRABADGER_NO_NATIVE_ACS"):
        return False
    _load()
    return True


class AcsStats:
    __slots__ = ("delivered", "faults", "extra_rounds")

    def __init__(self, delivered: int, faults: int, extra_rounds: int):
        self.delivered = delivered
        self.faults = faults
        self.extra_rounds = extra_rounds


def acs_run(payloads: Sequence[bytes], f: int, sid: bytes, shuffle: bool = True,
            seed: int = 0) -> Tuple[List[bool], AcsStats]:
    """Run one N-node fast-tier ACS epoch natively.

    payloads[i] is proposer i's contribution.  Returns (mask, stats): mask[i]
    says whether slot i entered the agreed subset.  The core checks that all
    N nodes agreed and that every accepted payload round-tripped exactly; any
    internal failure raises."""
    lib = _load()
    n = len(payloads)
    bufs = [ctypes.create_string_buffer(bytes(p), len(p)) for p in payloads]
    ptrs = (ctypes.POINTER(ctypes.c_uint8) * n)(
        *[ctypes.cast(b, ctypes.POINTER(ctypes.c_uint8)) for b in bufs])
    lens = (ctypes.c_int32 * n)(*[len(p) for p in payloads])
    mask = (ctypes.c_uint8 * n)()
    stats = (ctypes.c_uint64 * 3)()
    rc = lib.acs_run(n, f, bytes(sid), len(sid),
                     ctypes.cast(ptrs, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))), lens,
                     1 if shuffle else 0, seed & 0xFFFFFFFFFFFFFFFF, 0, mask, stats)
    if rc != 0:
        raise RuntimeError(f"native ACS failed (rc={rc})")
    return [bool(v) for v in mask], AcsStats(int(stats[0]), int(stats[1]), int(stats[2]))
