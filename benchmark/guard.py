"""The import guard: no run may load JAX or the JAX package.

A module counts by its top-level name (the part before the first dot),
compared whole: `hydrabadger_tpu_torch` is the program, `hydrabadger_tpu`
the JAX package it was ported from.
"""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "hydrabadger_tpu"})


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    """Top-level names of loaded modules that are forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)


def check(where: str) -> None:
    """Exit with code 3, naming what was found on stderr, if a forbidden
    module is loaded."""
    found = forbidden_loaded()
    if found:
        print(f"import guard ({where}): loaded {', '.join(found)}", file=sys.stderr)
        raise SystemExit(3)
