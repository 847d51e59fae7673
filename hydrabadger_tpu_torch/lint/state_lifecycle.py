"""Rule ``state-lifecycle``: every long-lived mutable container on a
node-lifetime object carries a registry-declared lifecycle, verified
against the code (hbstate).

The config-5 era-age debt (ROADMAP 5a) was exactly the bug class no
pass owned: hbtaint catches *attacker-paced unbounded* growth, but
nothing checked that state scoped to an era or epoch is actually
**reset** when that era or epoch ends — a ledger that only ever grows
makes every later era pay for every earlier one.  hbstate closes the
gap with the repo's declare-then-check discipline:

  * **scope** — the classes in ``lint/registry.py:STATE_SCOPE_CLASSES``
    (consensus cores, the net node, sim network/router, the DKG
    session): objects that live as long as the node does.  Every
    container attribute of a scoped class that has a *growth site*
    (``append``/``extend``/``add``/``setdefault``/``put_nowait``/
    ``+=``/subscript-store) must appear in
    ``registry.STATE_LIFECYCLE`` with one of four lifecycles:

      - ``("per_epoch", None)`` — pruned/cleared on the epoch commit
        path: a reset or per-key eviction of the attr must be
        reachable over the callgraph from
        ``registry.EPOCH_COMMIT_ANCHORS``;
      - ``("per_era", None)`` — cleared/replaced on the era-flip path:
        a reset must be reachable from ``registry.ERA_FLIP_ANCHORS``;
      - ``("bounded", "<CAP name>")`` — every growth site is protected
        by a recognized cap: bounded construction (``deque(maxlen=)``/
        ``Queue(maxsize=)``), a direction-aware ``len()`` admission
        guard, or an adjacent trim/reject/deflect under an over-cap
        test — a ``len()`` compare pointing the WRONG way (grow when
        already over the cap) is itself the finding;
      - ``("process_lifetime", "<justification>")`` — deliberately
        unbounded for the process lifetime; the justification is
        mandatory and audited in review.

  * **findings** — an undeclared growing attr; a ``per_era`` attr with
    no reset on the era-flip path; a ``per_epoch`` attr with no
    reset/eviction on the commit path; a ``bounded`` attr whose growth
    sites have no recognized cap; a ``process_lifetime`` entry with an
    empty justification; and a *stale* registry entry (scoped class or
    attr that no longer exists, or an attr with no growth site left).

The runtime twin is ``obs/census.py``: a per-epoch state census that
snapshots ``len()`` of every declared container, emits
``state_census_*`` gauges, and backs the SOAK assertion that declared
per-era state is flat across era boundaries.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from . import Finding, PACKAGE_ROOT, SourceFile
from . import registry
from .callgraph import CallGraph, FuncInfo, build as build_graph
from .taint import _bounded_containers, _container_base

RULE = "state-lifecycle"

ANCHOR = "__init__.py"  # package pass: runs once, anchored on the root

LIFECYCLES = ("per_epoch", "per_era", "bounded", "process_lifetime")

_GROWTH_METHODS = frozenset(
    {"append", "extend", "add", "appendleft", "put_nowait", "setdefault",
     "update"}
)
# a reset replaces or empties the whole container
_RESET_METHODS = frozenset({"clear"})
# an eviction removes individual entries — enough for per_epoch attrs
# that are pruned as each epoch completes (``epochs.pop(done)``)
_EVICT_METHODS = frozenset(
    {"pop", "popitem", "popleft", "remove", "discard", "get_nowait"}
)
_CONTAINER_CTORS = frozenset(
    {"list", "dict", "set", "deque", "OrderedDict", "defaultdict",
     "Counter", "Queue", "LifoQueue", "PriorityQueue", "DigestLRU"}
)


def applies(relpath: str) -> bool:
    return relpath == ANCHOR


def _is_container_expr(expr: ast.expr) -> bool:
    """Does this RHS build a fresh mutable container?"""
    if isinstance(expr, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    if isinstance(expr, ast.Call):
        fn = expr.func
        bare = fn.attr if isinstance(fn, ast.Attribute) else getattr(
            fn, "id", None
        )
        return bare in _CONTAINER_CTORS
    return False


def _mentions_len(expr: ast.expr, container: str, attr: str) -> bool:
    """Does this side of a compare measure the container's size?
    (``len(self.X)``, ``len(X)`` for a bare local alias, ``.qsize()``)"""
    for sub in ast.walk(expr):
        if (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Name)
            and sub.func.id == "len"
            and sub.args
        ):
            arg = sub.args[0]
            if _container_base(arg) == container or (
                isinstance(arg, ast.Name) and arg.id == attr
            ):
                return True
        elif (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr == "qsize"
            and _container_base(sub.func.value) == container
        ):
            return True
    return False


_FLIP = {"Lt": "Gt", "LtE": "GtE", "Gt": "Lt", "GtE": "LtE"}


def _test_direction(test: ast.expr, container: str, attr: str) -> Optional[str]:
    """Which way does a size compare in this if/while test point?

    ``"small"`` — true while the container is under the bound
    (``len(x) < CAP``): a genuine admission cap for any growth in the
    function.  ``"large"`` — true once the container is already big
    (``len(x) >= CAP``): only a cap when the body trims, rejects or
    deflects (see ``_large_guard_ok``) — a *fake* cap guarding the
    wrong direction otherwise.  ``None`` — no size compare against a
    usable bound (``is not None`` existence probes don't count)."""
    direction = None
    for cmp in (
        sub for sub in ast.walk(test) if isinstance(sub, ast.Compare)
    ):
        sides = [cmp.left] + list(cmp.comparators)
        for i, op in enumerate(cmp.ops):
            left, right = sides[i], sides[i + 1]
            for side, other, flipped in (
                (left, right, False), (right, left, True)
            ):
                if not _mentions_len(side, container, attr):
                    continue
                if isinstance(other, ast.Constant) and other.value is None:
                    continue
                name = type(op).__name__
                if flipped:
                    name = _FLIP.get(name, name)
                if name in ("Lt", "LtE"):
                    return "small"
                if name in ("Gt", "GtE"):
                    direction = "large"
    return direction


def _large_guard_ok(node: ast.stmt, container: str) -> bool:
    """Is an over-the-cap test a legitimate guard?  Yes when its body
    trims the container (evict/clear — the ``while len > CAP: pop``
    loop), rejects the write (return/raise/break/continue before the
    growth can run), or deflects it (rebinds a name, e.g. clamping the
    key to ``"other"``).  A body that just grows anyway is the fake."""
    for sub in ast.walk(node):
        if isinstance(sub, (ast.Return, ast.Raise, ast.Break, ast.Continue)):
            return True
        if isinstance(sub, ast.Assign) and any(
            isinstance(t, ast.Name) for t in sub.targets
        ):
            return True
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute):
            if sub.func.attr in (_EVICT_METHODS | _RESET_METHODS) and (
                _container_base(sub.func.value) == container
            ):
                return True
    return False


def _cap_guarded(attr: str, fn_node) -> bool:
    """Direction-aware cap recognition over the whole function (growth
    and trim may sit in separate statements — grow-then-trim is the
    repo's LRU idiom).  Unlike hbtaint's ``_len_guarded`` this rejects
    a guard comparing the WRONG way: ``if len(x) > CAP: x.append(v)``
    grows precisely when it is already over its cap."""
    container = f"self.{attr}"
    for sub in ast.walk(fn_node):
        if isinstance(sub, (ast.If, ast.While)):
            d = _test_direction(sub.test, container, attr)
            if d == "small":
                return True
            if d == "large" and _large_guard_ok(sub, container):
                return True
    return False


def _self_attr(expr: ast.expr) -> Optional[str]:
    """'X' for a plain ``self.X`` attribute expression."""
    if (
        isinstance(expr, ast.Attribute)
        and isinstance(expr.value, ast.Name)
        and expr.value.id == "self"
    ):
        return expr.attr
    return None


class _ClassAudit:
    """All container-attr facts for one scoped class."""

    def __init__(self, key: str, graph: CallGraph):
        self.key = key  # "relpath::ClassName"
        self.ci = graph.classes.get(key)
        self.graph = graph
        # attr -> lineno of the defining assignment in __init__
        self.containers: Dict[str, int] = {}
        # attr -> [(FuncInfo, node)] growth / reset / evict sites
        self.growth: Dict[str, List[Tuple[FuncInfo, ast.AST]]] = {}
        self.resets: Dict[str, List[FuncInfo]] = {}
        self.evicts: Dict[str, List[FuncInfo]] = {}
        # growth sites NOT covered by a recognized cap guard
        self.unguarded: Dict[str, List[Tuple[FuncInfo, ast.AST]]] = {}
        if self.ci is not None:
            self._collect()

    def _methods(self) -> List[FuncInfo]:
        ci = self.ci
        return [
            fi
            for fi in self.graph.functions.values()
            if fi.cls == ci.name and fi.relpath == ci.relpath
        ]

    def _collect(self) -> None:
        init = self.ci.methods.get("__init__")
        defining = [init.node] if init is not None else []
        # dataclass-style class bodies define containers via annotated
        # field(default_factory=...) assignments
        for stmt in self.ci.node.body:
            if isinstance(stmt, ast.AnnAssign) and isinstance(
                stmt.target, ast.Name
            ):
                val = stmt.value
                if isinstance(val, ast.Call) and getattr(
                    val.func, "id", getattr(val.func, "attr", None)
                ) == "field":
                    for kw in val.keywords:
                        if kw.arg == "default_factory" and isinstance(
                            kw.value, (ast.Name, ast.Attribute, ast.Lambda)
                        ):
                            self.containers[stmt.target.id] = stmt.lineno
        for node in defining:
            for sub in ast.walk(node):
                if not isinstance(sub, (ast.Assign, ast.AnnAssign)):
                    continue
                value = getattr(sub, "value", None)
                if value is None or not _is_container_expr(value):
                    continue
                targets = (
                    sub.targets if isinstance(sub, ast.Assign)
                    else [sub.target]
                )
                for t in targets:
                    attr = _self_attr(t)
                    if attr is not None:
                        self.containers.setdefault(attr, t.lineno)
        bounded = _bounded_containers(self.graph)
        for fi in self._methods():
            if fi.name == "__init__":
                continue  # construction, not runtime growth
            self._scan_method(fi, bounded)
        # drain-refill: a growth site in a function that also
        # whole-container-resets the same attr (``pending, self.X =
        # self.X, []`` then conditional re-append) only re-adds what it
        # just drained — cap-preserving, not new growth
        for attr, sites in list(self.unguarded.items()):
            reset_fns = {fi.qualname for fi in self.resets.get(attr, [])}
            kept = [(fi, n) for fi, n in sites if fi.qualname not in reset_fns]
            if kept:
                self.unguarded[attr] = kept
            else:
                self.unguarded.pop(attr, None)

    def _scan_method(self, fi: FuncInfo, bounded: Set[str]) -> None:
        stack: List[ast.stmt] = []

        def record_growth(attr: str, node: ast.AST) -> None:
            self.growth.setdefault(attr, []).append((fi, node))
            if f"{self.ci.name}.{attr}" in bounded:
                return  # bounded by construction
            if not _cap_guarded(attr, fi.node):
                self.unguarded.setdefault(attr, []).append((fi, node))

        def visit(stmt: ast.stmt) -> None:
            if isinstance(
                stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                return
            stack.append(stmt)
            try:
                self._scan_stmt(fi, stmt, record_growth)
                for sub in ast.iter_child_nodes(stmt):
                    if isinstance(sub, ast.stmt):
                        visit(sub)
                    elif isinstance(sub, ast.excepthandler):
                        for inner in sub.body:
                            visit(inner)
            finally:
                stack.pop()

        for stmt in getattr(fi.node, "body", []):
            visit(stmt)

    def _scan_stmt(self, fi: FuncInfo, stmt: ast.stmt, record_growth) -> None:
        # whole-container replacement: self.X = <fresh container>
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            value = getattr(stmt, "value", None)
            targets = (
                stmt.targets if isinstance(stmt, ast.Assign)
                else [stmt.target]
            )
            for t in targets:
                attr = _self_attr(t)
                if attr is None:
                    continue
                if value is not None and _is_container_expr(value):
                    if fi.name != "__init__":
                        self.resets.setdefault(attr, []).append(fi)
                elif isinstance(t, ast.Subscript):
                    pass  # handled below via the subscript branch
            # drain-swap reset: ``pending, self.X = self.X, []``
            for t in targets:
                if (
                    isinstance(t, ast.Tuple)
                    and isinstance(value, ast.Tuple)
                    and len(t.elts) == len(value.elts)
                ):
                    for te, ve in zip(t.elts, value.elts):
                        attr = _self_attr(te)
                        if attr is not None and _is_container_expr(ve):
                            self.resets.setdefault(attr, []).append(fi)
            # subscript-store growth: self.X[k] = v  (one subscript hop)
            for t in targets:
                if isinstance(t, ast.Subscript):
                    base = _container_base(t)
                    if base is not None:
                        attr = base.split(".", 1)[1]
                        if isinstance(t.slice, ast.Slice):
                            # slice replacement self.X[:] = ... is a reset
                            self.resets.setdefault(attr, []).append(fi)
                        else:
                            record_growth(attr, stmt)
        elif isinstance(stmt, ast.AugAssign):
            base = _container_base(stmt.target)
            attr = _self_attr(stmt.target)
            if attr is not None or base is not None:
                record_growth(attr or base.split(".", 1)[1], stmt)
        elif isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                if isinstance(t, ast.Subscript):
                    base = _container_base(t)
                    if base is None:
                        continue
                    attr = base.split(".", 1)[1]
                    if isinstance(t.slice, ast.Slice):
                        self.resets.setdefault(attr, []).append(fi)
                    else:
                        self.evicts.setdefault(attr, []).append(fi)
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Call) and isinstance(
                sub.func, ast.Attribute
            ):
                base = _container_base(sub.func.value)
                if base is None:
                    continue
                attr = base.split(".", 1)[1]
                if sub.func.attr in _GROWTH_METHODS:
                    record_growth(attr, sub)
                elif sub.func.attr in _RESET_METHODS:
                    self.resets.setdefault(attr, []).append(fi)
                elif sub.func.attr in _EVICT_METHODS:
                    self.evicts.setdefault(attr, []).append(fi)


def _declared(key: str) -> Dict[str, Tuple[str, Optional[str]]]:
    """Registry entries for one class key -> {attr: (lifecycle, arg)}."""
    out: Dict[str, Tuple[str, Optional[str]]] = {}
    prefix = key + "."
    for full, decl in registry.STATE_LIFECYCLE.items():
        if full.startswith(prefix):
            out[full[len(prefix):]] = decl
    return out


def check_root(root: Path, shown_prefix: str) -> List[Finding]:
    graph = build_graph(root)
    findings: List[Finding] = []

    def emit(relpath: str, line: int, message: str) -> None:
        findings.append(
            Finding(
                rule=RULE,
                path=f"{shown_prefix}/{relpath}",
                line=line,
                message=message,
            )
        )

    era_reach = graph.reachable_from(list(registry.ERA_FLIP_ANCHORS))
    epoch_reach = graph.reachable_from(list(registry.EPOCH_COMMIT_ANCHORS))
    # the anchors themselves count even when the graph cannot resolve a
    # call INTO them (they are protocol entrypoints)
    era_reach |= set(registry.ERA_FLIP_ANCHORS)
    epoch_reach |= set(registry.EPOCH_COMMIT_ANCHORS)

    anchor_line = 1
    for key in registry.STATE_SCOPE_CLASSES:
        audit = _ClassAudit(key, graph)
        relpath, cls_name = key.split("::", 1)
        if audit.ci is None:
            emit(
                "lint/registry.py",
                anchor_line,
                f"stale STATE_SCOPE_CLASSES entry: {key} does not exist",
            )
            continue
        declared = _declared(key)
        growing = set(audit.growth)
        for attr in sorted(growing - set(declared)):
            fi, node = audit.growth[attr][0]
            if attr not in audit.containers:
                # grown-but-never-defined-in-__init__ attrs (locals that
                # shadow, inherited slots) are out of scope for the
                # census contract; only node-lifetime containers defined
                # by the class itself need a declaration
                continue
            emit(
                fi.relpath,
                getattr(node, "lineno", fi.lineno),
                f"undeclared state growth: {cls_name}.{attr} grows in "
                f"{fi.name!r} but has no lifecycle in "
                "lint/registry.py:STATE_LIFECYCLE — declare per_epoch, "
                "per_era, bounded(cap) or process_lifetime(justification)",
            )
        for attr, (lifecycle, arg) in sorted(declared.items()):
            line = audit.containers.get(attr, audit.ci.node.lineno)
            if lifecycle not in LIFECYCLES:
                emit(
                    relpath, line,
                    f"unknown lifecycle {lifecycle!r} declared for "
                    f"{cls_name}.{attr} — one of {', '.join(LIFECYCLES)}",
                )
                continue
            if attr not in audit.containers and attr not in audit.growth:
                emit(
                    relpath,
                    audit.ci.node.lineno,
                    f"stale STATE_LIFECYCLE entry: {cls_name}.{attr} is "
                    "not a container attribute of the class any more — "
                    "drop it from lint/registry.py",
                )
                continue
            if attr not in audit.growth:
                emit(
                    relpath, line,
                    f"stale STATE_LIFECYCLE entry: {cls_name}.{attr} has "
                    "no growth site left — drop it from lint/registry.py",
                )
                continue
            if lifecycle == "per_era":
                ok = any(
                    fi.qualname in era_reach
                    for fi in audit.resets.get(attr, [])
                )
                if not ok:
                    emit(
                        relpath, line,
                        f"per_era state {cls_name}.{attr} is never "
                        "cleared/replaced on the era-flip path "
                        "(registry.ERA_FLIP_ANCHORS) — every era would "
                        "pay for every earlier one",
                    )
            elif lifecycle == "per_epoch":
                ok = any(
                    fi.qualname in epoch_reach
                    for fi in (
                        audit.resets.get(attr, [])
                        + audit.evicts.get(attr, [])
                    )
                )
                if not ok:
                    emit(
                        relpath, line,
                        f"per_epoch state {cls_name}.{attr} is never "
                        "reset/evicted on the epoch commit path "
                        "(registry.EPOCH_COMMIT_ANCHORS)",
                    )
            elif lifecycle == "bounded":
                bad = audit.unguarded.get(attr, [])
                if bad:
                    fi, node = bad[0]
                    emit(
                        fi.relpath,
                        getattr(node, "lineno", fi.lineno),
                        f"state {cls_name}.{attr} is declared "
                        f"bounded({arg}) but this growth site in "
                        f"{fi.name!r} has no recognized cap guard "
                        "(bounded construction, len() guard, or trim "
                        "loop in the same function)",
                    )
            elif lifecycle == "process_lifetime":
                if not arg or not str(arg).strip():
                    emit(
                        relpath, line,
                        f"process_lifetime state {cls_name}.{attr} has "
                        "no justification — unbounded-for-the-process "
                        "retention must say why",
                    )
    findings.sort(key=lambda f: (f.path, f.line))
    return findings


def check(sf: SourceFile) -> List[Finding]:
    root = sf.path.parent if sf.relpath == ANCHOR else PACKAGE_ROOT
    return check_root(root, PACKAGE_ROOT.name)
