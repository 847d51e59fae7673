"""Rule ``await-interference``: a read-modify-write of shared node
state must not straddle a suspension point unvalidated.

Every asyncio coroutine in the node plane (handler loop, replay loop,
retry/keepalive ticks, ``stop``/``crash``) mutates the same
``Hydrabadger`` instance.  Between an ``await`` and the statement after
it, ANY other coroutine may run — so code that snapshots shared state,
awaits (a ``submit_*`` future, a sleep, a socket op), and then writes
the snapshot-derived value back has silently assumed nothing moved.
That assumption is exactly what the hbasync double-buffer discipline
exists to avoid (``bridge._collector`` re-reads ``self._pending`` at
the swap), and its violations are unreproducible-by-construction: they
need a context switch in a specific window.

The pass flags, per ``async def``:

* a write to a SHARED slot (``self.attr`` touched by functions
  reachable from >= 2 coroutine roots over the lint/callgraph — task
  spawns via ``create_task``/``gather`` resolve like any call — or a
  module global declared ``global`` in >= 2 such functions) ...
* ... preceded by a read of the same slot with at least one suspension
  point between read and write ...
* ... with NO re-read of the slot after the last suspension before the
  write (the write's own RHS re-reading the slot, an ``if self.attr
  ...`` re-validation, and ``AugAssign`` all count as fresh), and no
  ``lint/registry.py:AWAIT_RMW_GUARDS`` declaration.

A guard entry naming a function that no longer exists is itself a
finding (stale declaration), like every registry table of the analyzer.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Set

from . import Finding, PACKAGE_ROOT, SourceFile
from . import registry
from .asyncflow import AwaitWalk, reachable_map
from .callgraph import CallGraph, FuncInfo, build as build_graph

RULE = "await-interference"

ANCHOR = "__init__.py"  # package pass: runs once, anchored on the root


def applies(relpath: str) -> bool:
    return relpath == ANCHOR


def _class_family(graph: CallGraph, ci) -> str:
    """Stable id shared by a class and its package ancestors, so a
    subclass's coroutines count as peers of the base's (chaos-plane
    ``ByzantineHydrabadger`` shares the base node's state)."""
    seen = set()
    cur = ci
    while True:
        seen.add(cur.qualname)
        bases = [
            b
            for b in getattr(cur, "_base_infos", [])
            if b.qualname not in seen
        ]
        if not bases:
            return cur.qualname
        cur = bases[0]


def _attr_accessors(graph: CallGraph) -> Dict[str, Set[str]]:
    """(class family + attr) -> qualnames of methods touching it."""
    family: Dict[str, str] = {}
    for ci in graph.classes.values():
        family[ci.name] = _class_family(graph, ci)
    out: Dict[str, Set[str]] = {}
    for fi in graph.functions.values():
        if fi.cls is None:
            continue
        fam = family.get(fi.cls, fi.cls)
        for node in ast.walk(fi.node):
            if (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
            ):
                out.setdefault(f"{fam}::self.{node.attr}", set()).add(
                    fi.qualname
                )
    return out


def _global_accessors(graph: CallGraph) -> Dict[str, Set[str]]:
    """(relpath + global name) -> qualnames declaring it ``global``."""
    out: Dict[str, Set[str]] = {}
    for fi in graph.functions.values():
        for stmt in ast.walk(fi.node):
            if isinstance(stmt, ast.Global):
                for name in stmt.names:
                    out.setdefault(f"{fi.relpath}::{name}", set()).add(
                        fi.qualname
                    )
    return out


def check_root(root: Path, shown_prefix: str) -> List[Finding]:
    graph = build_graph(root)
    reach = reachable_map(graph)
    attr_accessors = _attr_accessors(graph)
    global_accessors = _global_accessors(graph)
    family: Dict[str, str] = {
        ci.name: _class_family(graph, ci) for ci in graph.classes.values()
    }
    findings: List[Finding] = []

    def emit(fi: FuncInfo, node, message: str) -> None:
        findings.append(
            Finding(
                rule=RULE,
                path=f"{shown_prefix}/{fi.relpath}",
                line=getattr(node, "lineno", fi.lineno),
                message=message,
            )
        )

    # stale guard declarations: validated against the real package
    # graph; a fixture root only validates entries naming its own files
    real_root = root.resolve() == PACKAGE_ROOT.resolve()
    for key, _just in registry.AWAIT_RMW_GUARDS.items():
        relpath, _, rest = key.partition("::")
        qual, _, _attr = rest.partition("::")
        if not real_root and relpath not in graph.sources:
            continue
        if f"{relpath}::{qual}" not in graph.functions:
            findings.append(
                Finding(
                    rule=RULE,
                    path=f"{shown_prefix}/lint/registry.py",
                    line=1,
                    message=(
                        f"AWAIT_RMW_GUARDS entry {key!r} names a function "
                        "that no longer exists — remove the stale "
                        "declaration"
                    ),
                )
            )

    def roots_touching(access_key: str, fi: FuncInfo) -> Set[str]:
        if access_key.startswith("self."):
            fam = family.get(fi.cls or "", fi.cls or "")
            holders = attr_accessors.get(f"{fam}::{access_key}", set())
        else:
            holders = global_accessors.get(
                f"{fi.relpath}::{access_key}", set()
            )
        roots: Set[str] = set()
        for qual in holders:
            roots |= reach.get(qual, set())
        return roots

    for fi in graph.functions.values():
        if not isinstance(fi.node, ast.AsyncFunctionDef):
            continue
        walk = AwaitWalk(fi.node)
        if walk.await_count == 0:
            continue
        for w in walk.accesses:
            if w.mode != "write" or w.fresh_rhs:
                continue
            guard_key = (
                f"{fi.relpath}::"
                f"{(fi.cls + '.') if fi.cls else ''}{fi.name}::"
                f"{w.key.split('.')[-1]}"
            )
            if guard_key in registry.AWAIT_RMW_GUARDS:
                continue
            reads = [
                a
                for a in walk.accesses
                if a.key == w.key and a.mode == "read" and a.order < w.order
            ]
            stale = [r for r in reads if r.epoch < w.epoch]
            fresh = [r for r in reads if r.epoch == w.epoch]
            if not stale or fresh:
                continue
            if len(roots_touching(w.key, fi)) < 2:
                continue
            r = stale[-1]
            emit(
                fi,
                w.node,
                f"await-straddling read-modify-write of {w.key} in "
                f"{fi.name!r}: snapshot read at line "
                f"{getattr(r.node, 'lineno', '?')} crosses "
                f"{w.epoch - r.epoch} suspension point(s) before this "
                "write — another coroutine may have advanced the state; "
                "re-read/re-validate after the await or declare the "
                "discipline in lint/registry.py:AWAIT_RMW_GUARDS",
            )
    findings.sort(key=lambda f: (f.path, f.line))
    return findings


def check(sf: SourceFile) -> List[Finding]:
    root = sf.path.parent if sf.relpath == ANCHOR else PACKAGE_ROOT
    return check_root(root, PACKAGE_ROOT.name)
