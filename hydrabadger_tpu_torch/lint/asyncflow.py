"""Shared async-flow machinery for the hbrace passes.

Two facilities on top of ``lint/callgraph``:

* **coroutine reachability** — which functions run (transitively) under
  which ``async def`` roots.  Call edges resolve the inner call of
  ``asyncio.create_task(self._loop())`` / ``asyncio.gather(f(), g())``
  for free (the coroutine-building call IS a resolved call site), so
  reachability follows task spawns and fan-outs without special cases.
  Traversal can be stopped at declared boundary functions (the
  executor-offload declarations of the blocking-in-async pass) and
  skips the callgraph's low-confidence ``fallback`` edges — a guessed
  edge must never smear a blocking verdict across unrelated planes.

* **await-ordered access walk** — a source-order walk of one function
  body that numbers every ``self.attr`` (and declared-``global`` name)
  access with the count of await/async-for/async-with suspension
  points crossed before it.  Two accesses with different epochs have a
  suspension between them: any other coroutine may have run.  Branches
  are walked sequentially (the lint-grade convention of
  ``lint/dataflow.py``); an await inside either arm counts for the
  code after the branch.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set

from . import dotted_name
from .callgraph import CallGraph, FuncInfo


# -- coroutine reachability ---------------------------------------------------


def coroutine_roots(graph: CallGraph) -> List[FuncInfo]:
    return [
        fi
        for fi in graph.functions.values()
        if isinstance(fi.node, ast.AsyncFunctionDef)
    ]


def reachable_map(
    graph: CallGraph, boundaries: Sequence[str] = ()
) -> Dict[str, Set[str]]:
    """qualname -> set of coroutine-root qualnames that reach it.

    A root reaches itself.  Traversal does not descend THROUGH a
    boundary function (the boundary itself is reached — its body is
    where the offload happens) and ignores ``fallback``-resolved edges.
    """
    stop = set(boundaries)
    out: Dict[str, Set[str]] = {}
    for root in coroutine_roots(graph):
        seen: Set[str] = set()
        stack = [root.qualname]
        while stack:
            cur = stack.pop()
            if cur in seen:
                continue
            seen.add(cur)
            if cur in stop and cur != root.qualname:
                continue
            for site in graph.calls_by_caller.get(cur, []):
                if site.via == "fallback":
                    continue
                stack.extend(t for t in site.targets if t not in seen)
        for qual in seen:
            out.setdefault(qual, set()).add(root.qualname)
    return out


# -- await-ordered accesses ---------------------------------------------------


@dataclass
class Access:
    """One shared-state touch inside a coroutine body."""

    key: str  # "self.attr" or a module-global name
    mode: str  # "read" | "write"
    epoch: int  # suspension points crossed before this access
    order: int  # global source-order index
    node: ast.AST
    fresh_rhs: bool = False  # write whose RHS re-reads the same slot


class AwaitWalk:
    """Source-order walk of one (async) function body."""

    def __init__(self, fn_node: ast.AST):
        self.accesses: List[Access] = []
        self.await_count = 0
        self._order = 0
        self._globals: Set[str] = {
            name
            for stmt in ast.walk(fn_node)
            if isinstance(stmt, ast.Global)
            for name in stmt.names
        }
        for stmt in getattr(fn_node, "body", []):
            self._stmt(stmt)

    # expression side: record Loads, bump the epoch at suspension points

    def _key(self, node: ast.AST) -> Optional[str]:
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            return f"self.{node.attr}"
        if isinstance(node, ast.Name) and node.id in self._globals:
            return node.id
        return None

    def _record(self, key: str, mode: str, node: ast.AST, fresh=False) -> None:
        self._order += 1
        self.accesses.append(
            Access(key, mode, self.await_count, self._order, node, fresh)
        )

    def _expr(self, node: Optional[ast.AST]) -> None:
        if node is None:
            return
        if isinstance(node, ast.Await):
            self._expr(node.value)  # operand evaluates BEFORE suspension
            self.await_count += 1
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return  # nested defs are their own analysis units
        key = self._key(node)
        if key is not None and isinstance(
            getattr(node, "ctx", None), ast.Load
        ):
            self._record(key, "read", node)
        for child in ast.iter_child_nodes(node):
            self._expr(child)

    # statement side

    def _targets(self, stmt: ast.stmt) -> List[ast.AST]:
        if isinstance(stmt, ast.Assign):
            return list(stmt.targets)
        if isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            return [stmt.target]
        return []

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            rhs = stmt.value
            self._expr(rhs)
            rhs_keys = (
                {
                    self._key(sub)
                    for sub in ast.walk(rhs)
                    if self._key(sub) is not None
                }
                if rhs is not None
                else set()
            )
            for tgt in self._targets(stmt):
                # tuple targets unpack; subscript/attr-chain bases are reads
                for sub in ast.walk(tgt):
                    key = self._key(sub)
                    if key is None:
                        continue
                    if isinstance(sub.ctx, ast.Store):
                        fresh = key in rhs_keys or isinstance(
                            stmt, ast.AugAssign
                        )
                        self._record(key, "write", sub, fresh=fresh)
                    else:
                        self._record(key, "read", sub)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._expr(stmt.iter)
            if isinstance(stmt, ast.AsyncFor):
                self.await_count += 1
            for s in stmt.body:
                self._stmt(s)
            for s in stmt.orelse:
                self._stmt(s)
            return
        if isinstance(stmt, ast.While):
            self._expr(stmt.test)
            for s in stmt.body:
                self._stmt(s)
            for s in stmt.orelse:
                self._stmt(s)
            return
        if isinstance(stmt, ast.If):
            self._expr(stmt.test)
            for s in stmt.body:
                self._stmt(s)
            for s in stmt.orelse:
                self._stmt(s)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._expr(item.context_expr)
            if isinstance(stmt, ast.AsyncWith):
                self.await_count += 1
            for s in stmt.body:
                self._stmt(s)
            return
        if isinstance(stmt, ast.Try):
            for s in stmt.body:
                self._stmt(s)
            for handler in stmt.handlers:
                for s in handler.body:
                    self._stmt(s)
            for s in stmt.orelse:
                self._stmt(s)
            for s in stmt.finalbody:
                self._stmt(s)
            return
        # Expr / Return / Raise / Assert / Delete / ...
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.stmt):
                self._stmt(child)
            else:
                self._expr(child)


def own_nodes(fn_node: ast.AST):
    """Walk a function's OWN body: every node except those inside
    nested function/lambda definitions (a closure's body does not run
    when the enclosing function does — it is its own analysis unit)."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


# -- submit-future detection (shared with lint/async_fetch) -------------------


def is_submit_call(node: ast.AST) -> bool:
    """A call whose target name marks a future-returning entry point
    (``engine.submit_g1_msm_batch``, ``handle_parts_submit``...)."""
    if not isinstance(node, ast.Call):
        return False
    dn = dotted_name(node.func)
    if dn is None:
        return False
    last = dn.rsplit(".", 1)[-1]
    return last.endswith("_submit") or last.startswith("submit_")


def submit_bound_names(fn_node: ast.AST) -> Set[str]:
    """Names bound from a submit_* call anywhere in ``fn_node``."""
    out: Set[str] = set()
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Assign) and is_submit_call(node.value):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out.add(tgt.id)
    return out
