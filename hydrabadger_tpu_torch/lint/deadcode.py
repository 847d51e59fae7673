"""Rule ``dead-code``: unused module-level imports.

The import-graph walk that powers the other rules also sees which
imported names a module never references.  An unused import is not just
noise: in this codebase a module-level ``import triton`` or CUDA-touching
import would fail or start a device context in a process that never
launches a kernel (the port imports triton and builds kernels inside the
functions that launch them), and unused ``from x import y`` lines are
how stale cross-module contracts linger after refactors.

Flags module-level ``import`` / ``from ... import`` names that are
never referenced anywhere in the module.  Exemptions:

  * ``__init__.py`` files (re-export surface);
  * ``from __future__ import ...``;
  * names listed in ``__all__``;
  * underscore-prefixed aliases (``import os as _os`` conventions are
    function-local in this repo anyway);
  * star imports (nothing to track).
"""
from __future__ import annotations

import ast
import re
from typing import List

from . import Finding, SourceFile

RULE = "dead-code"


def applies(relpath: str) -> bool:
    return not relpath.endswith("__init__.py")


def _exported_names(tree: ast.Module) -> set:
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "__all__"
            for t in node.targets
        ):
            return {
                c.value
                for c in ast.walk(node.value)
                if isinstance(c, ast.Constant) and isinstance(c.value, str)
            }
    return set()


def check(sf: SourceFile) -> List[Finding]:
    imported = {}  # bound name -> (node, shown as)
    for node in sf.tree.body:
        if isinstance(node, ast.Import):
            for alias in node.names:
                bound = alias.asname or alias.name.split(".")[0]
                imported[bound] = (node, alias.name)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for alias in node.names:
                if alias.name == "*":
                    continue
                bound = alias.asname or alias.name
                imported[bound] = (node, alias.name)
    if not imported:
        return []
    used = set()
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            # 'a.b' usage marks 'a' via the Name child; nothing extra
            continue
    used |= _exported_names(sf.tree)
    out: List[Finding] = []
    for bound, (node, shown) in imported.items():
        if bound in used or bound.startswith("_"):
            continue
        # conservative fallback: a whole-word mention anywhere outside the
        # import's own line (string annotations, doctest snippets) counts
        # as a use — a linter that cries wolf gets disabled
        pattern = re.compile(rf"\b{re.escape(bound)}\b")
        if any(
            pattern.search(line)
            for i, line in enumerate(sf.lines, start=1)
            if not (node.lineno <= i <= (node.end_lineno or node.lineno))
        ):
            continue
        out.append(
            sf.finding(
                RULE,
                node,
                f"imported name {bound!r} ({shown}) is never used in this "
                "module",
            )
        )
    return out
