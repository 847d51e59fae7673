"""Rule ``sans-io``: consensus cores never touch the outside world.

Contract (consensus/types.py module docstring): "Cores never touch
sockets, clocks or ambient randomness; all effects flow through Steps
and explicit rng arguments."  A core that reads a clock or an ambient
RNG diverges across replicas — exactly the nondeterminism HBBFT's
safety argument excludes — and a core that opens a socket can deadlock
the single-consumer handler.

Flags, anywhere under ``consensus/``:

  * imports of effectful stdlib modules (``time``, ``random``,
    ``socket``, ``asyncio``, ``os``, ``secrets``, ``threading``,
    ``selectors``, ``ssl``, ``subprocess``);
  * ambient NumPy randomness (``np.random`` / ``numpy.random``);
  * ``open()`` / ``input()`` / ``__import__()`` calls;
  * ``object.__setattr__`` — the only way to mutate a frozen dataclass,
    which would let per-node state leak into shared messages.
"""
from __future__ import annotations

import ast
from typing import List

from . import Finding, SourceFile, dotted_name

RULE = "sans-io"

BANNED_MODULES = frozenset(
    {
        "time",
        "random",
        "socket",
        "asyncio",
        "os",
        "secrets",
        "threading",
        "selectors",
        "ssl",
        "subprocess",
    }
)

BANNED_CALLS = frozenset({"open", "input", "__import__"})


def applies(relpath: str) -> bool:
    return relpath.startswith("consensus/")


def check(sf: SourceFile) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                root = alias.name.split(".")[0]
                if root in BANNED_MODULES:
                    out.append(
                        sf.finding(
                            RULE,
                            node,
                            f"import of effectful module {alias.name!r} in a "
                            "sans-io consensus core",
                        )
                    )
        elif isinstance(node, ast.ImportFrom):
            root = (node.module or "").split(".")[0]
            if node.level == 0 and root in BANNED_MODULES:
                out.append(
                    sf.finding(
                        RULE,
                        node,
                        f"import from effectful module {node.module!r} in a "
                        "sans-io consensus core",
                    )
                )
        elif isinstance(node, ast.Attribute):
            dn = dotted_name(node)
            if dn and (
                dn.startswith("np.random") or dn.startswith("numpy.random")
            ):
                out.append(
                    sf.finding(
                        RULE,
                        node,
                        "ambient NumPy RNG in a consensus core — thread an "
                        "explicit rng argument instead",
                    )
                )
        elif isinstance(node, ast.Call):
            dn = dotted_name(node.func)
            if dn in BANNED_CALLS:
                out.append(
                    sf.finding(
                        RULE, node, f"{dn}() call in a sans-io consensus core"
                    )
                )
            elif dn == "object.__setattr__":
                out.append(
                    sf.finding(
                        RULE,
                        node,
                        "object.__setattr__ mutates a frozen dataclass — "
                        "consensus values must stay immutable once emitted",
                    )
                )
    return out
