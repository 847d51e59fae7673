"""Rule ``env-flag``: every HYDRABADGER_* environment read names a
registered flag.

Environment variables are the package's de-facto config plane —
kill-switches (``HYDRABADGER_SHADOW_DKG``, ``HYDRABADGER_NTT``),
routing thresholds, library paths.  An unregistered read is a flag
nobody can discover: it appears in no inventory, no README table and
no kill-switch audit — which is exactly how a plane-disabling switch
rots into a landmine.  Every literal ``os.environ.get(...)`` /
``os.getenv(...)`` / ``os.environ[...]`` read of a ``HYDRABADGER_*``
name must match a key in ``lint/registry.py:ENV_FLAGS`` (flag ->
one-line owner description).  Variable-name reads (e.g. the sim's
scoped ``_env_flag`` helper) are out of scope by construction — they
read flags their CALLERS name literally.

The registry's liveness (no stale entries) is enforced by
tests/test_torch_lint.py, which greps the package for each registered name.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from . import Finding, SourceFile, dotted_name
from . import registry

RULE = "env-flag"

_GET_CALLS = frozenset(
    {
        "os.environ.get",
        "environ.get",
        "_os.environ.get",
        "os.getenv",
        "getenv",
        "os.environ.setdefault",
        "environ.setdefault",
    }
)
_ENVIRON_NAMES = frozenset({"os.environ", "environ", "_os.environ"})


def applies(relpath: str) -> bool:
    return True  # any package file may read configuration


def _env_name(node: ast.AST) -> Optional[str]:
    """The literal env-var name this node reads, if any."""
    if isinstance(node, ast.Call):
        dn = dotted_name(node.func)
        if dn in _GET_CALLS and node.args:
            a = node.args[0]
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                return a.value
        return None
    if isinstance(node, ast.Subscript):
        dn = dotted_name(node.value)
        if dn in _ENVIRON_NAMES:
            sl = node.slice
            if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
                return sl.value
    return None


def check(sf: SourceFile) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(sf.tree):
        name = _env_name(node)
        if (
            name
            and name.startswith("HYDRABADGER")
            and name not in registry.ENV_FLAGS
        ):
            out.append(
                sf.finding(
                    RULE,
                    node,
                    f"unregistered environment flag {name!r} — add it to "
                    "lint/registry.py:ENV_FLAGS with a one-line owner "
                    "description (the kill-switch inventory)",
                )
            )
    return out
