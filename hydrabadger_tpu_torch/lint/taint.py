"""Rule ``attacker-taint``: adversary-controlled data must be clamped
before it drives resource consumption.

HBBFT's value proposition is safety under adversarial inputs, and the
batched-crypto planes push attacker-chosen data (commitment points,
wire-decoded scalars, batch shapes) deep into the kernel planes where
the only defenses are hand-placed entry caps and length checks.  This pass machine-checks that those defenses exist on every
path:

  * **sources** — wire-decode outputs (``codec.decode``,
    ``WireMessage.decode``, ``WireStream.recv``), ``.payload`` /
    encrypted-row/value attribute reads, and the seeded handler
    parameters in ``lint/registry.py:TAINT_SOURCE_PARAMS`` (sim-router
    deliveries, net_state gossip, key-gen payloads);
  * **propagation** — interprocedural over the lint/callgraph edges:
    a tainted argument taints the callee's parameter, a tainted return
    taints the caller's call expression (lint/dataflow.InterEngine);
  * **sanitizers** — a ``len()``/cap comparison guarding an abort
    (return/raise/continue/break), a ``min``/``max`` clamp against a
    clean bound, or a constant-bound slice;
  * **sinks** —
      1. *loop bounds*: ``range(t)`` / sequence repetition ``x * t``
         with a tainted, unclamped ``t``;
      2. *unbounded container growth* (scoped to ``net/`` and ``sim/``,
         the planes where raw attacker bytes land): ``append`` /
         ``extend`` / ``add`` / ``put_nowait`` / subscript-store of
         tainted data into a persistent (``self.``) container that is
         neither len-guarded at the write site nor bounded by
         construction (``deque(maxlen=...)``).

The JAX package's third sink, a tainted value reaching a ``@jax.jit``
entry point unbucketed, has no counterpart: the port has no jit entry
points and launches its kernels at the caller's exact lane count.

Every finding means: clamp the value, cap the container, or add an
``# hblint: disable=attacker-taint -- <why this is bounded>`` with the
justification a reviewer can audit.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional, Set

from . import Finding, PACKAGE_ROOT, SourceFile
from . import registry
from .callgraph import CallGraph, FuncInfo, build as build_graph
from .dataflow import CLEAN, InterEngine, Policy

RULE = "attacker-taint"

ANCHOR = "__init__.py"  # package pass: runs once, anchored on the root

_GROWTH_METHODS = frozenset(
    {"append", "extend", "add", "put_nowait", "appendleft", "setdefault"}
)


def applies(relpath: str) -> bool:
    return relpath == ANCHOR


class TaintPolicy(Policy):
    TOP = 2
    guard_sanitizes = True
    slice_bounds_sanitize = True  # peers_info[:CAP] bounds the fan-out

    def param_state(self, fi: FuncInfo, param: str) -> int:
        if (fi.relpath, fi.name, param) in registry.TAINT_SOURCE_PARAMS:
            return self.TOP
        return CLEAN

    def attr_state(self, attr: str, base_state: int, node) -> int:
        if attr in registry.TAINT_SOURCE_ATTRS:
            return self.TOP
        return base_state

    def call_state(self, walker, node, dotted, site, base_state, arg_states):
        dn = dotted or ""
        bare = dn.split(".")[-1]
        if any(dn.endswith(s) for s in registry.TAINT_SOURCE_CALLS):
            return self.TOP
        if bare in registry.TAINT_SOURCE_METHODS and "." in dn:
            return self.TOP
        if bare in registry.CLAMP_FUNCS and any(
            s == CLEAN for s in arg_states
        ):
            return CLEAN
        if site is not None and site.targets and walker.engine is not None:
            if site.kind == "ctor":
                return max(arg_states, default=CLEAN)
            return max(
                (walker.engine.returns.get(t, CLEAN) for t in site.targets),
                default=CLEAN,
            )
        return max([base_state] + arg_states, default=CLEAN)


# -- sink scanning -----------------------------------------------------------


def _bounded_containers(graph: CallGraph) -> Set[str]:
    """'ClassName.attr' slots bounded by construction: assigned a
    ``deque(maxlen=...)`` (or dict/Queue with an explicit bound) in
    ``__init__``."""
    bounded: Set[str] = set()
    for ci in graph.classes.values():
        init = ci.methods.get("__init__")
        if init is None:
            continue
        for node in ast.walk(init.node):
            if not (
                isinstance(node, (ast.Assign, ast.AnnAssign))
                and isinstance(getattr(node, "value", None), ast.Call)
            ):
                continue
            ctor = node.value
            has_bound = any(
                kw.arg in ("maxlen", "maxsize") and not (
                    isinstance(kw.value, ast.Constant) and kw.value.value in (0, None)
                )
                for kw in ctor.keywords
            )
            if not has_bound:
                continue
            targets = (
                node.targets
                if isinstance(node, ast.Assign)
                else [node.target]
            )
            for t in targets:
                if (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    bounded.add(f"{ci.name}.{t.attr}")
    return bounded


def _container_base(expr: ast.expr) -> Optional[str]:
    """'self.X' for self-attribute containers (incl. one subscript hop:
    ``self.outputs[k].extend`` -> 'self.outputs')."""
    if isinstance(expr, ast.Subscript):
        expr = expr.value
    if (
        isinstance(expr, ast.Attribute)
        and isinstance(expr.value, ast.Name)
        and expr.value.id == "self"
    ):
        return f"self.{expr.attr}"
    return None


def _len_guarded(stmt_stack: List[ast.stmt], container: str, fn_node) -> bool:
    """Is the write protected by a cap? — a ``len(<container>)``
    compared against a non-None bound in an ``if``/``while`` test of
    this function (``is not None`` existence checks do NOT count)."""
    attr = container.split(".")[-1]

    def is_cap_compare(cmp: ast.Compare) -> bool:
        sides = [cmp.left] + list(cmp.comparators)
        mentions = False
        for side in sides:
            for sub in ast.walk(side):
                if (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Name)
                    and sub.func.id == "len"
                    and sub.args
                ):
                    base = _container_base(sub.args[0])
                    arg = sub.args[0]
                    if base == container or (
                        isinstance(arg, ast.Name) and arg.id == attr
                    ):
                        mentions = True
                elif (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr == "qsize"
                    and _container_base(sub.func.value) == container
                ):
                    mentions = True  # asyncio.Queue length probe
        if not mentions:
            return False
        return not any(
            isinstance(s, ast.Constant) and s.value is None for s in sides
        )

    def test_guards(test: ast.expr) -> bool:
        return any(
            isinstance(sub, ast.Compare) and is_cap_compare(sub)
            for sub in ast.walk(test)
        )

    for anc in stmt_stack:
        if isinstance(anc, (ast.If, ast.While)) and test_guards(anc.test):
            return True
    for sub in ast.walk(fn_node):
        if isinstance(sub, (ast.If, ast.While)) and test_guards(sub.test):
            return True
    return False


class _SinkScanner:
    def __init__(
        self,
        graph: CallGraph,
        engine: InterEngine,
        shown_prefix: str,
    ):
        self.graph = graph
        self.engine = engine
        self.shown_prefix = shown_prefix
        self.bounded = _bounded_containers(graph)
        self.findings: List[Finding] = []

    def _emit(self, fi: FuncInfo, node, message: str) -> None:
        self.findings.append(
            Finding(
                rule=RULE,
                path=f"{self.shown_prefix}/{fi.relpath}",
                line=getattr(node, "lineno", fi.lineno),
                message=message,
            )
        )

    def scan_function(self, fi: FuncInfo) -> None:
        fa = self.engine.final_analysis(fi.qualname)
        if fa is None:
            return
        growth_scope = fi.relpath.startswith(registry.GROWTH_SCOPE)
        stack: List[ast.stmt] = []

        def tainted(expr: ast.expr, stmt: ast.stmt) -> bool:
            return fa.eval(expr, fa.env_at(stmt)) == TaintPolicy.TOP

        def visit_stmt(stmt: ast.stmt) -> None:
            if isinstance(
                stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                return  # nested defs are separate FuncInfos
            stack.append(stmt)
            try:
                self._scan_exprs(fi, fa, stmt, stack, growth_scope, tainted)
                for sub in ast.iter_child_nodes(stmt):
                    if isinstance(sub, ast.stmt):
                        visit_stmt(sub)
                    elif isinstance(sub, ast.excepthandler):
                        for inner in sub.body:
                            visit_stmt(inner)
            finally:
                stack.pop()

        for stmt in getattr(fi.node, "body", []):
            visit_stmt(stmt)

    def _scan_exprs(self, fi, fa, stmt, stack, growth_scope, tainted) -> None:
        loop_scope = fi.relpath.startswith(registry.LOOP_BOUND_SCOPE)
        # 1. loop bounds + repetition
        for node in ast.iter_child_nodes(stmt):
            if not isinstance(node, ast.expr):
                continue
            for sub in ast.walk(node):
                if (
                    loop_scope
                    and isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Name)
                    and sub.func.id == "range"
                ):
                    for arg in sub.args:
                        if tainted(arg, stmt):
                            self._emit(
                                fi,
                                sub,
                                "attacker-tainted loop bound in "
                                f"{fi.name!r} — clamp the count before "
                                "iterating (a forged length is a CPU/"
                                "memory bomb)",
                            )
                            break
                elif loop_scope and isinstance(sub, ast.BinOp) and isinstance(
                    sub.op, ast.Mult
                ):
                    for side, other in (
                        (sub.left, sub.right),
                        (sub.right, sub.left),
                    ):
                        # sequence repetition only — `2 * n` arithmetic
                        # on a tainted int is not an allocation
                        if (
                            isinstance(other, (ast.List, ast.Tuple))
                            or (
                                isinstance(other, ast.Constant)
                                and isinstance(
                                    other.value, (str, bytes)
                                )
                            )
                        ) and tainted(side, stmt):
                            self._emit(
                                fi,
                                sub,
                                "attacker-tainted repetition count in "
                                f"{fi.name!r} — a forged length "
                                "allocates unbounded memory",
                            )
                            break
                elif isinstance(sub, ast.Call):
                    self._scan_call(fi, fa, stmt, stack, growth_scope, tainted, sub)
        # 2b. subscript-store growth: self.X[tainted_key] = value
        if growth_scope and isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Subscript):
                    base = _container_base(t)
                    if base is None:
                        continue
                    if self._is_bounded(fi, base):
                        continue
                    if _len_guarded(stack, base, fi.node):
                        continue
                    if tainted(t.slice, stmt) or tainted(stmt.value, stmt):
                        self._emit(
                            fi,
                            stmt,
                            f"unbounded growth of {base} in {fi.name!r}: "
                            "attacker-influenced entries stored with no "
                            "size cap — bound the container or guard the "
                            "write with a len() check",
                        )

    def _scan_call(self, fi, fa, stmt, stack, growth_scope, tainted, call) -> None:
        # 2. container growth: tainted VALUE stored, or any store inside
        # a loop whose iterable the attacker sized (fan-out)
        if (
            growth_scope
            and isinstance(call.func, ast.Attribute)
            and call.func.attr in _GROWTH_METHODS
        ):
            base = _container_base(call.func.value)
            if base is not None and not self._is_bounded(fi, base):
                if not _len_guarded(stack, base, fi.node):
                    loop_tainted = any(
                        isinstance(anc, (ast.For, ast.AsyncFor))
                        and tainted(anc.iter, anc)
                        for anc in stack
                    )
                    if loop_tainted or any(
                        tainted(a, stmt) for a in call.args
                    ):
                        why = (
                            "one write per entry of an attacker-sized "
                            "iterable"
                            if loop_tainted
                            else "attacker-paced "
                            f".{call.func.attr}() of tainted data"
                        )
                        self._emit(
                            fi,
                            call,
                            f"unbounded growth of {base} in {fi.name!r}: "
                            f"{why} with no size cap — bound the "
                            "container or guard the write with a len() "
                            "check",
                        )

    def _is_bounded(self, fi: FuncInfo, base: str) -> bool:
        attr = base.split(".", 1)[1]
        if fi.cls is not None and f"{fi.cls}.{attr}" in self.bounded:
            return True
        # dataclass field(default_factory=deque-with-maxlen) is rare;
        # a field annotated deque but built unbounded stays flagged
        return False


# -- the rule ----------------------------------------------------------------


def check_root(root: Path, shown_prefix: str) -> List[Finding]:
    graph = build_graph(root)
    engine = InterEngine(graph, TaintPolicy())
    engine.run()
    scanner = _SinkScanner(graph, engine, shown_prefix)
    for fi in graph.functions.values():
        scanner.scan_function(fi)
    scanner.findings.sort(key=lambda f: (f.path, f.line))
    return scanner.findings


def check(sf: SourceFile) -> List[Finding]:
    root = sf.path.parent if sf.relpath == ANCHOR else PACKAGE_ROOT
    return check_root(root, PACKAGE_ROOT.name)
