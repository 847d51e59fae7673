"""Builds the port's host libraries from the repo's C and C++ sources.

Four libraries of host code (not kernels) serve the port, each compiled
from `native/` into `build/host_native/` at its first use:

  - BLS: native/bls12_381.cpp -> libbls381.so (crypto/native_bls),
  - GF: native/gf256_rs.cpp -> libgf256_rs.so (crypto/_native),
  - ACS: native/acs_engine.cpp -> libacs.so (sim/native_acs),
  - CODEC: native/hb_codec.c -> hb_codec<EXT_SUFFIX>, a CPython extension
    built against the running interpreter's headers (utils/codec).

The port never loads `native/*.so`.  A build runs under a file lock beside
its target (test workers and node processes started together build once),
is renamed into place, and leaves a stamp of the sources, the compiler, the
flags and the CPU features `-march=native` resolves to on this host; a
changed stamp rebuilds, so a library built for another CPU is never loaded.
A build that fails raises RuntimeError with the compiler's output: nothing
falls back.  $CXX overrides g++ and $CC overrides gcc.
"""
from __future__ import annotations

import fcntl
import functools
import hashlib
import os
import subprocess
import sysconfig
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Tuple

ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = ROOT / "native"
OUT_DIR = ROOT / "build" / "host_native"

CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")


@functools.lru_cache(maxsize=8)
def _target_features(cc: str) -> str:
    """What `-march=native` means to `cc` on this host."""
    try:
        return subprocess.run([cc, "-march=native", "-Q", "--help=target"],
                              capture_output=True, text=True).stdout
    except OSError as exc:
        raise RuntimeError(f"cannot run {cc!r}: {exc}") from exc


@dataclass
class HostLibrary:
    """One library: `sources[0]` is compiled, the rest (headers) enter the
    stamp.  `build_seconds` is this process's compile time, None while no
    build ran here (an earlier one was reused)."""

    label: str
    sources: Tuple[Path, ...]
    dest: Path
    flags: Tuple[str, ...]
    compiler_env: str = "CXX"
    compiler: str = "g++"
    build_seconds: Optional[float] = field(default=None, compare=False)

    def cc(self) -> str:
        return os.environ.get(self.compiler_env) or self.compiler

    def stamp(self, cc: str) -> str:
        """Digest of the sources, the compiler and flags, and the target
        features `-march=native` means on this host."""
        try:
            target = _target_features(cc)
        except RuntimeError as exc:
            raise RuntimeError(f"{self.label} build: {exc}") from exc
        h = hashlib.sha256(" ".join((cc,) + self.flags).encode() + target.encode())
        for src in self.sources:
            h.update(src.read_bytes())
        return h.hexdigest()

    def build(self, dest: Optional[Path] = None) -> Path:
        """The built library at `dest` (default `self.dest`), compiling it
        when its stamp does not match.  Raises RuntimeError with the
        compiler's output when the build fails."""
        dest = Path(dest or self.dest)
        cc = self.cc()
        stamp = self.stamp(cc)
        stamp_path = dest.with_name(dest.name + ".stamp")

        def current() -> bool:
            return dest.exists() and stamp_path.exists() and stamp_path.read_text() == stamp

        if current():
            return dest
        dest.parent.mkdir(parents=True, exist_ok=True)
        with open(dest.with_name(dest.name + ".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if current():  # another process built it while we waited
                return dest
            tmp = dest.with_name(f".{dest.name}.{os.getpid()}.tmp")
            cmd = [cc, *self.flags, "-o", str(tmp), str(self.sources[0])]
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as exc:
                raise RuntimeError(f"{self.label} build: cannot run {cc!r}: {exc}") from exc
            if proc.returncode != 0 or not tmp.exists():
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"{self.label} build failed ({' '.join(cmd)}: exit {proc.returncode}):\n"
                    f"{proc.stderr}{proc.stdout}")
            os.replace(tmp, dest)
            tmp_stamp = stamp_path.with_name(f".{stamp_path.name}.{os.getpid()}.tmp")
            tmp_stamp.write_text(stamp)
            os.replace(tmp_stamp, stamp_path)
            self.build_seconds = time.perf_counter() - t0
        return dest


BLS = HostLibrary("native BLS", (NATIVE_DIR / "bls12_381.cpp", NATIVE_DIR / "bls381_constants.h"),
                  OUT_DIR / "libbls381.so", CXXFLAGS)
GF = HostLibrary("host GF(2^8)", (NATIVE_DIR / "gf256_rs.cpp",), OUT_DIR / "libgf256_rs.so",
                 CXXFLAGS)
ACS = HostLibrary("native ACS", (NATIVE_DIR / "acs_engine.cpp",), OUT_DIR / "libacs.so", CXXFLAGS)
CODEC = HostLibrary(
    "codec C twin", (NATIVE_DIR / "hb_codec.c",),
    OUT_DIR / f"hb_codec{sysconfig.get_config_var('EXT_SUFFIX')}",
    ("-O3", "-march=native", "-fPIC", "-shared", f"-I{sysconfig.get_paths()['include']}"),
    compiler_env="CC", compiler="gcc")
LIBRARIES = (BLS, GF, ACS, CODEC)


def build_all() -> None:
    """Build every host library that is not built yet (each one's
    `build_seconds` says what this process compiled)."""
    for lib in LIBRARIES:
        lib.build()
