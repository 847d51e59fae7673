"""Rule ``task-retention``: no fire-and-forget ``asyncio.create_task``.

The event loop holds only a WEAK reference to tasks: a task whose
last strong reference is the ``create_task`` return value the caller
discarded can be garbage-collected mid-flight, silently cancelling the
coroutine (the CPython-documented hazard).  In this codebase every
background task is either appended to a tracked list (``self._tasks``,
torn down by ``stop``/``crash``) or parked in a set with a
done-callback discard (``_overflow_tasks``, the chaos plane's
``_spawn``) — a bare ``asyncio.create_task(...)`` expression statement
is a dropped reference and a latent lost-liveness bug.

Flagged: a ``create_task``/``ensure_future`` call whose value is
discarded (an ``Expr`` statement) or bound to a name that is never
used again in the same function.  Retain the handle (the package
idiom: ``self._tasks.append(...)`` or ``set.add`` +
``add_done_callback(discard)``) or suppress with a justification
saying what else keeps the task alive.
"""
from __future__ import annotations

import ast
from typing import List

from . import Finding, SourceFile, dotted_name
from .asyncflow import own_nodes

RULE = "task-retention"

_SPAWNERS = frozenset({"create_task", "ensure_future"})


def _is_spawn(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    dn = dotted_name(node.func) or ""
    return dn.split(".")[-1] in _SPAWNERS


def check(sf: SourceFile) -> List[Finding]:
    out: List[Finding] = []
    for fn in ast.walk(sf.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        bound: dict = {}  # name -> binding statement (this body only)
        uses: set = set()
        for node in own_nodes(fn):
            if isinstance(node, ast.Expr) and _is_spawn(node.value):
                out.append(
                    sf.finding(
                        RULE,
                        node,
                        "fire-and-forget create_task: the loop holds only "
                        "a weak reference, so GC can cancel the task "
                        "mid-flight — retain the handle (self._tasks / a "
                        "done-callback-pruned set) or justify what keeps "
                        "it alive",
                    )
                )
            elif isinstance(node, ast.Assign) and _is_spawn(node.value):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        bound[tgt.id] = node
            elif isinstance(node, ast.Name) and isinstance(
                node.ctx, ast.Load
            ):
                uses.add(node.id)  # any further use counts: stored,
                # awaited, appended, returned, callback-wired
        for name, stmt in bound.items():
            if name not in uses:
                out.append(
                    sf.finding(
                        RULE,
                        stmt,
                        f"task handle {name!r} bound from create_task is "
                        "never used — the reference dies with the scope "
                        "and GC can cancel the task mid-flight; retain it "
                        "or justify what keeps it alive",
                    )
                )
    return out
