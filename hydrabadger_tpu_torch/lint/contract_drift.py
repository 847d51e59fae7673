"""Rule ``contract-drift``: the observability registries, the metric
name space and the BYZ_* taxonomy stay bound to the code (hbquorum).

Three prose contracts tie the Byzantine planes together, and all three
drift silently because nothing re-checks them after an edit:

  * **fault substrings** — ``sim/scenario.py:FAULT_OBSERVABLES`` (and
    the wire/process tiers that extend it) declares, per injectable
    fault kind, the ``fault_log`` substrings that prove detection.  A
    reworded fault string in a consensus core voids the declaration
    without failing anything until an adversarial soak happens to
    exercise that kind.

  * **metric names** — a metric is a plain string minted at the call
    site; ``obs/metrics.py`` fixes the spellings surfaces bind to.  A
    minted name nobody declared (or a declared name nobody mints any
    more) splits the name space in two.

  * **taxonomy closure** — every ``consensus/types.py:BYZ_*`` kind must
    have an injection site (an ``InjectionLog.note`` call or a
    ``sim/byzantine.py`` strategy ``kind =`` binding) and a non-empty
    observable in every tier registry that claims it — a kind that can
    be injected but not observed is exactly the "silent tolerance"
    hole the runtime verifier exists to close.

The pass re-evaluates the tier registries STATICALLY (dict literals,
``dict(BASE)`` copies resolved through imports, ``.update({...})`` and
subscript assignment, ``ObsSpec`` construction, ``_self_counter``-style
single-return helpers inlined with arguments bound), collects every
statically reachable fault-emit string (``Step.fault`` /
``_note_fault`` arguments; f-strings contribute their static segments,
and an unresolvable interpolation is a match barrier), and mirrors
``sim/scenario.py:_attribute``'s exclusive-attribution rule: a fully
literal emit string that ties two registry families at maximal
substring length is a finding unless the tie is declared in
``lint/registry.py:CONTRACT_SHARED_SUBSTRINGS``.

Metric mints are classified **full** (a resolvable string — must equal
a declared ``obs/metrics.py`` constant value or extend a declared
``*_PREFIX``), **prefix** (``PREFIX + expr`` / an f-string with a
static head — the head must extend a declared prefix), or **dynamic**
(anything else — legal only inside a registered mint wrapper
(``registry.METRIC_MINT_WRAPPERS``; its call sites then mint the
name-argument) or a declared dynamic site
(``registry.METRIC_DYNAMIC_MINTS``)).  The reverse direction holds
too: a declared constant that is never minted and a declared prefix
with no prefix mint are findings, as is a stale registry entry.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from . import Finding, PACKAGE_ROOT, SourceFile, dotted_name
from . import registry
from .callgraph import CallGraph, build as build_graph

RULE = "contract-drift"

ANCHOR = "__init__.py"  # package pass: runs once, anchored on the root

REGISTRY_PATH = "lint/registry.py"

# files whose code is scanned for fault emits and metric mints; the
# lint plane itself carries contract TEXT (registry tables, docstrings)
# but never emits or mints
_SKIP_PREFIXES = ("lint/",)


def applies(relpath: str) -> bool:
    return relpath == ANCHOR


# -- static string resolution ------------------------------------------------


class _Strings:
    """Resolve expressions to compile-time strings: literals, module
    constants (followed through imports, ``T.BYZ_X`` style), ``+``
    concatenation, and fully static f-strings."""

    def __init__(self, graph: CallGraph):
        self.graph = graph
        self._consts: Dict[str, Dict[str, ast.expr]] = {}
        self._cache: Dict[Tuple[str, str], Optional[str]] = {}

    def module_consts(self, relpath: str) -> Dict[str, ast.expr]:
        table = self._consts.get(relpath)
        if table is None:
            table = {}
            sf = self.graph.sources.get(relpath)
            body = sf.tree.body if sf is not None else []
            for stmt in body:
                if isinstance(stmt, ast.Assign):
                    for tgt in stmt.targets:
                        if isinstance(tgt, ast.Name):
                            table[tgt.id] = stmt.value
                elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                    if isinstance(stmt.target, ast.Name):
                        table[stmt.target.id] = stmt.value
            self._consts[relpath] = table
        return table

    def const(self, relpath: str, name: str) -> Optional[str]:
        key = (relpath, name)
        if key in self._cache:
            return self._cache[key]
        self._cache[key] = None  # recursion guard
        expr = self.module_consts(relpath).get(name)
        if expr is not None:
            self._cache[key] = self.resolve(relpath, expr)
        else:
            target = self.graph.imports.get(relpath, {}).get(name)
            if target and "::" in target:
                rel, sym = target.split("::", 1)
                self._cache[key] = self.const(rel, sym)
        return self._cache[key]

    def resolve(
        self,
        relpath: str,
        expr: ast.expr,
        env: Optional[Dict[str, str]] = None,
    ) -> Optional[str]:
        if isinstance(expr, ast.Constant):
            return expr.value if isinstance(expr.value, str) else None
        if isinstance(expr, ast.Name):
            if env and expr.id in env:
                return env[expr.id]
            return self.const(relpath, expr.id)
        if isinstance(expr, ast.Attribute):
            dotted = dotted_name(expr)
            if dotted is None:
                return None
            base, _, rest = dotted.partition(".")
            target = self.graph.imports.get(relpath, {}).get(base)
            if target and "::" not in target and rest and "." not in rest:
                return self.const(target, rest)
            return None
        if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
            left = self.resolve(relpath, expr.left, env)
            right = self.resolve(relpath, expr.right, env)
            if left is not None and right is not None:
                return left + right
            return None
        if isinstance(expr, ast.JoinedStr):
            parts: List[str] = []
            for v in expr.values:
                if isinstance(v, ast.Constant) and isinstance(v.value, str):
                    parts.append(v.value)
                    continue
                if isinstance(v, ast.FormattedValue) and v.format_spec is None:
                    s = self.resolve(relpath, v.value, env)
                    if s is not None:
                        parts.append(s)
                        continue
                return None
            return "".join(parts)
        return None

    def segments(
        self, relpath: str, expr: ast.expr
    ) -> Tuple[List[str], Optional[str]]:
        """(static segments, full string if fully resolvable).  Each
        unresolvable f-string interpolation is a match barrier between
        segments."""
        full = self.resolve(relpath, expr)
        if full is not None:
            return [full], full
        if isinstance(expr, ast.JoinedStr):
            segs: List[str] = []
            cur = ""
            for v in expr.values:
                s: Optional[str] = None
                if isinstance(v, ast.Constant) and isinstance(v.value, str):
                    s = v.value
                elif isinstance(v, ast.FormattedValue) and v.format_spec is None:
                    s = self.resolve(relpath, v.value)
                if s is not None:
                    cur += s
                else:
                    if cur:
                        segs.append(cur)
                    cur = ""
            if cur:
                segs.append(cur)
            return segs, None
        return [], None


# -- tier registry evaluation ------------------------------------------------


class _Entry:
    """One evaluated tier row: kind -> ObsSpec fields, with the line of
    the declaration that last set it."""

    def __init__(self, fault_any, counters, gauges, relpath, line):
        self.fault_any: Tuple[str, ...] = fault_any
        self.counters: Tuple[str, ...] = counters
        self.gauges: Tuple[str, ...] = gauges
        self.relpath = relpath
        self.line = line


class _TierError(Exception):
    def __init__(self, line: int, message: str):
        super().__init__(message)
        self.line = line
        self.message = message


def _resolve_func(graph: CallGraph, relpath: str, fn: ast.expr):
    """FuncInfo for a Name call, local first then through imports."""
    if not isinstance(fn, ast.Name):
        return None
    fi = graph.functions.get(f"{relpath}::{fn.id}")
    if fi is not None:
        return fi
    target = graph.imports.get(relpath, {}).get(fn.id)
    if target and "::" in target:
        return graph.functions.get(target)
    return None


def _eval_str_tuple(
    strings: _Strings, relpath: str, expr: ast.expr, env
) -> Tuple[str, ...]:
    if not isinstance(expr, (ast.Tuple, ast.List)):
        raise _TierError(
            expr.lineno, "observable list is not a literal tuple/list"
        )
    out: List[str] = []
    for el in expr.elts:
        s = strings.resolve(relpath, el, env)
        if s is None:
            raise _TierError(
                el.lineno, "observable name does not resolve to a string"
            )
        out.append(s)
    return tuple(out)


def _eval_obsspec(
    graph: CallGraph,
    strings: _Strings,
    relpath: str,
    expr: ast.expr,
    env: Optional[Dict[str, str]] = None,
    depth: int = 0,
) -> Tuple[Tuple[str, ...], Tuple[str, ...], Tuple[str, ...]]:
    """Evaluate an ``ObsSpec(...)`` construction (or a single-return
    helper that builds one, arguments bound) to its three name tuples."""
    if depth > 2 or not isinstance(expr, ast.Call):
        raise _TierError(
            getattr(expr, "lineno", 1), "registry value is not ObsSpec(...)"
        )
    callee = expr.func
    bare = callee.attr if isinstance(callee, ast.Attribute) else getattr(
        callee, "id", ""
    )
    if bare == "ObsSpec":
        fields = {"fault_any": (), "counters": (), "gauges": ()}
        order = ("fault_any", "counters", "gauges")
        for i, arg in enumerate(expr.args):
            if i >= len(order):
                raise _TierError(arg.lineno, "too many ObsSpec arguments")
            fields[order[i]] = _eval_str_tuple(strings, relpath, arg, env)
        for kw in expr.keywords:
            if kw.arg not in fields:
                raise _TierError(
                    expr.lineno, f"unknown ObsSpec field {kw.arg!r}"
                )
            fields[kw.arg] = _eval_str_tuple(strings, relpath, kw.value, env)
        return fields["fault_any"], fields["counters"], fields["gauges"]
    # helper inlining: a single-return function whose body constructs
    # the spec from its (string-resolved) arguments
    fi = _resolve_func(graph, relpath, callee)
    if fi is None:
        raise _TierError(
            expr.lineno, f"cannot resolve registry value constructor {bare!r}"
        )
    stmts = [s for s in fi.node.body if not isinstance(s, ast.Expr)]
    if len(stmts) != 1 or not isinstance(stmts[0], ast.Return):
        raise _TierError(
            expr.lineno, f"{bare!r} is not a single-return spec helper"
        )
    params = [p for p in fi.params if p != "self"]
    if expr.keywords or len(params) != len(expr.args):
        raise _TierError(expr.lineno, f"cannot bind arguments of {bare!r}")
    inner_env: Dict[str, str] = {}
    for name, arg in zip(params, expr.args):
        s = strings.resolve(relpath, arg, env)
        if s is None:
            raise _TierError(
                arg.lineno, f"argument of {bare!r} does not resolve"
            )
        inner_env[name] = s
    return _eval_obsspec(
        graph, strings, fi.relpath, stmts[0].value, inner_env, depth + 1
    )


def _eval_tier(
    graph: CallGraph,
    strings: _Strings,
    relpath: str,
    dict_name: str,
    evaluated: Dict[str, Dict[str, _Entry]],
) -> Dict[str, _Entry]:
    """Re-run the tier dict's module-level construction statically."""
    sf = graph.sources.get(relpath)
    if sf is None:
        raise _TierError(1, f"tier module {relpath!r} not found")

    entries: Dict[str, _Entry] = {}
    found = False

    def add_items(d: ast.Dict) -> None:
        for k, v in zip(d.keys, d.values):
            if k is None:
                raise _TierError(d.lineno, "** expansion in a tier dict")
            kind = strings.resolve(relpath, k)
            if kind is None:
                raise _TierError(
                    k.lineno, "tier key does not resolve to a string"
                )
            fa, cs, gs = _eval_obsspec(graph, strings, relpath, v)
            entries[kind] = _Entry(fa, cs, gs, relpath, k.lineno)

    for stmt in sf.tree.body:
        tgt = None
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            tgt = stmt.targets[0]
        elif isinstance(stmt, ast.AnnAssign):
            tgt = stmt.target
        if tgt is not None and isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            value = stmt.value
            if isinstance(tgt, ast.Name) and tgt.id == dict_name:
                found = True
                if isinstance(value, ast.Dict):
                    add_items(value)
                elif (
                    isinstance(value, ast.Call)
                    and isinstance(value.func, ast.Name)
                    and value.func.id == "dict"
                    and len(value.args) == 1
                    and isinstance(value.args[0], ast.Name)
                ):
                    src = value.args[0].id
                    target = graph.imports.get(relpath, {}).get(src, "")
                    base = evaluated.get(target) or evaluated.get(
                        f"{relpath}::{src}"
                    )
                    if base is None:
                        raise _TierError(
                            stmt.lineno,
                            f"dict({src}) copies a registry this pass has "
                            "not evaluated (tier order in "
                            "registry.CONTRACT_TIERS must be innermost "
                            "first)",
                        )
                    entries.update(base)
                else:
                    raise _TierError(
                        stmt.lineno,
                        f"cannot statically evaluate the {dict_name} "
                        "construction",
                    )
            elif (
                isinstance(tgt, ast.Subscript)
                and isinstance(tgt.value, ast.Name)
                and tgt.value.id == dict_name
                and value is not None
            ):
                kind = strings.resolve(relpath, tgt.slice)
                if kind is None:
                    raise _TierError(
                        stmt.lineno, "tier key does not resolve to a string"
                    )
                fa, cs, gs = _eval_obsspec(graph, strings, relpath, value)
                entries[kind] = _Entry(fa, cs, gs, relpath, stmt.lineno)
        elif (
            isinstance(stmt, ast.Expr)
            and isinstance(stmt.value, ast.Call)
            and isinstance(stmt.value.func, ast.Attribute)
            and stmt.value.func.attr == "update"
            and isinstance(stmt.value.func.value, ast.Name)
            and stmt.value.func.value.id == dict_name
        ):
            if len(stmt.value.args) != 1 or not isinstance(
                stmt.value.args[0], ast.Dict
            ):
                raise _TierError(
                    stmt.lineno,
                    f"{dict_name}.update(...) argument is not a dict "
                    "literal",
                )
            add_items(stmt.value.args[0])
    if not found:
        raise _TierError(1, f"no module-level {dict_name} in {relpath}")
    return entries


# -- emit / injection / mint collection --------------------------------------


class _Emit:
    def __init__(self, relpath, line, segments, full):
        self.relpath = relpath
        self.line = line
        self.segments: List[str] = segments
        self.full: Optional[str] = full


class _Mint:
    """One metric-name creation: a ``.counter/.gauge/.histogram`` call
    or a registered wrapper call site."""

    def __init__(self, relpath, line, qual, kind, value):
        self.relpath = relpath
        self.line = line
        self.qual = qual  # enclosing "relpath::Qualname"
        self.kind = kind  # "full" | "prefix" | "dynamic"
        self.value = value  # name / static prefix / None


def _scan_module(
    sf: SourceFile,
    strings: _Strings,
    wrappers: Dict[str, Tuple[str, Tuple]],
    emits: List[_Emit],
    injected: Set[str],
    mints: List[_Mint],
    quals: Set[str],
) -> None:
    """One walk per module: fault emits, injection sites, metric mints
    (attributed to their enclosing function) and wrapper call sites."""
    relpath = sf.relpath

    def visit(node: ast.AST, stack: List[str]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            stack = stack + [node.name]
            qual = f"{relpath}::{'.'.join(stack)}"
            quals.add(qual)
            if isinstance(node, ast.ClassDef):
                # strategy-style injection declaration: kind = T.BYZ_X
                for stmt in node.body:
                    if isinstance(stmt, ast.Assign):
                        for t in stmt.targets:
                            if isinstance(t, ast.Name) and t.id == "kind":
                                s = strings.resolve(relpath, stmt.value)
                                if s is not None:
                                    injected.add(s)
        if isinstance(node, ast.Call):
            fn = node.func
            bare = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", None
            )
            qual = f"{relpath}::{'.'.join(stack)}" if stack else relpath
            if bare == "fault" and isinstance(fn, ast.Attribute) and node.args:
                arg = node.args[1] if len(node.args) >= 2 else node.args[0]
                segs, full = strings.segments(relpath, arg)
                if segs:
                    emits.append(_Emit(relpath, node.lineno, segs, full))
            elif bare == "_note_fault" and node.args:
                segs, full = strings.segments(relpath, node.args[0])
                if segs:
                    emits.append(_Emit(relpath, node.lineno, segs, full))
            elif bare == "note" and isinstance(fn, ast.Attribute) and node.args:
                s = strings.resolve(relpath, node.args[0])
                if s is not None:
                    injected.add(s)
            if (
                bare in ("counter", "gauge", "histogram")
                and isinstance(fn, ast.Attribute)
                and len(node.args) == 1
                and not node.keywords
            ):
                arg = node.args[0]
                full = strings.resolve(relpath, arg)
                if full is not None:
                    mints.append(_Mint(relpath, node.lineno, qual, "full", full))
                else:
                    prefix = None
                    if isinstance(arg, ast.BinOp) and isinstance(
                        arg.op, ast.Add
                    ):
                        prefix = strings.resolve(relpath, arg.left)
                    elif isinstance(arg, ast.JoinedStr):
                        segs, _ = strings.segments(relpath, arg)
                        head = arg.values[0] if arg.values else None
                        leads = segs and not (
                            isinstance(head, ast.Constant)
                            or (
                                isinstance(head, ast.FormattedValue)
                                and strings.resolve(relpath, head.value)
                                is not None
                            )
                        )
                        if segs and not leads:
                            prefix = segs[0]
                    if prefix:
                        mints.append(
                            _Mint(relpath, node.lineno, qual, "prefix", prefix)
                        )
                    else:
                        mints.append(
                            _Mint(relpath, node.lineno, qual, "dynamic", None)
                        )
            if bare in wrappers:
                wrapper_qual, (pos, kw) = wrappers[bare]
                arg = None
                if kw is not None:
                    for k in node.keywords:
                        if k.arg == kw:
                            arg = k.value
                if arg is None and pos is not None and pos < len(node.args):
                    arg = node.args[pos]
                if arg is not None and not (
                    isinstance(arg, ast.Constant) and arg.value is None
                ):
                    s = strings.resolve(relpath, arg)
                    mints.append(_Mint(
                        relpath, node.lineno, qual,
                        "full" if s is not None else "dynamic", s,
                    ))
        for child in ast.iter_child_nodes(node):
            visit(child, stack)

    for stmt in sf.tree.body:
        visit(stmt, [])


# -- the check ---------------------------------------------------------------


def check_root(root: Path, shown_prefix: str) -> List[Finding]:
    graph = build_graph(root)
    strings = _Strings(graph)
    findings: List[Finding] = []

    def emit(relpath: str, line: int, message: str) -> None:
        findings.append(Finding(
            rule=RULE,
            path=f"{shown_prefix}/{relpath}",
            line=line,
            message=message,
        ))

    # -- evaluate the tier registries, innermost first
    tiers: List[Tuple[str, str, Dict[str, _Entry]]] = []
    evaluated: Dict[str, Dict[str, _Entry]] = {}
    for relpath, dict_name in registry.CONTRACT_TIERS:
        try:
            entries = _eval_tier(graph, strings, relpath, dict_name, evaluated)
        except _TierError as e:
            emit(relpath, e.line, f"{dict_name}: {e.message} — the "
                 "analyzer cannot verify a registry it cannot evaluate")
            continue
        evaluated[f"{relpath}::{dict_name}"] = entries
        tiers.append((relpath, dict_name, entries))

    # -- the BYZ_* taxonomy
    tax_rel = registry.CONTRACT_TAXONOMY_MODULE
    taxonomy: Dict[str, Tuple[str, int]] = {}  # value -> (NAME, line)
    tax_sf = graph.sources.get(tax_rel)
    for stmt in (tax_sf.tree.body if tax_sf is not None else []):
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            t = stmt.targets[0]
            if (
                isinstance(t, ast.Name)
                and t.id.startswith("BYZ_")
                and isinstance(stmt.value, ast.Constant)
                and isinstance(stmt.value.value, str)
            ):
                taxonomy[stmt.value.value] = (t.id, stmt.lineno)

    # -- declared metric names
    met_rel = registry.CONTRACT_METRICS_MODULE
    declared_full: Dict[str, Tuple[str, int]] = {}
    declared_prefix: Dict[str, Tuple[str, int]] = {}
    met_sf = graph.sources.get(met_rel)
    for stmt in (met_sf.tree.body if met_sf is not None else []):
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            t = stmt.targets[0]
            if (
                isinstance(t, ast.Name)
                and t.id.isupper()
                and isinstance(stmt.value, ast.Constant)
                and isinstance(stmt.value.value, str)
            ):
                table = (
                    declared_prefix if t.id.endswith("_PREFIX")
                    else declared_full
                )
                table[stmt.value.value] = (t.id, stmt.lineno)

    # -- one scan: emits, injections, mints, wrapper call sites
    wrappers: Dict[str, Tuple[str, Tuple]] = {}
    for wq, spec in registry.METRIC_MINT_WRAPPERS.items():
        wrappers[wq.rsplit(".", 1)[-1].split("::")[-1]] = (wq, spec)
    emits: List[_Emit] = []
    injected: Set[str] = set()
    mints: List[_Mint] = []
    quals: Set[str] = set()
    for relpath in sorted(graph.sources):
        if relpath.startswith(_SKIP_PREFIXES):
            continue
        sf = graph.sources[relpath]
        keep_mints = relpath != met_rel  # the registry module itself
        sub_mints: List[_Mint] = []
        _scan_module(
            sf, strings, wrappers, emits, injected,
            sub_mints if not keep_mints else mints, quals,
        )

    # registered wrapper/dynamic sites must still exist
    for wq in sorted(registry.METRIC_MINT_WRAPPERS):
        if wq not in quals:
            emit(REGISTRY_PATH, 1,
                 f"stale METRIC_MINT_WRAPPERS entry: {wq!r} names no "
                 "function — drop it or fix the qualname")
    dynamic_used: Set[str] = set()

    # -- check every mint against the declared name space
    prefix_minted: Set[str] = set()
    minted_full: Set[str] = set()
    dynamic_names: Set[str] = set()
    for dq, (names, _why) in registry.METRIC_DYNAMIC_MINTS.items():
        for n in names or ():
            dynamic_names.add(n)

    def name_declared(name: str) -> bool:
        return name in declared_full or any(
            name.startswith(p) for p in declared_prefix
        )

    for m in mints:
        if m.kind == "full":
            minted_full.add(m.value)
            if not name_declared(m.value):
                emit(m.relpath, m.line,
                     f"metric name {m.value!r} is minted here but not "
                     f"declared in {met_rel} — fix the spelling or "
                     "declare the constant")
        elif m.kind == "prefix":
            if not any(m.value.startswith(p) for p in declared_prefix):
                emit(m.relpath, m.line,
                     f"metric name family {m.value + '*'!r} is minted "
                     f"here but no declared *_PREFIX in {met_rel} "
                     "covers it")
            else:
                prefix_minted.add(m.value)
        else:  # dynamic
            if m.qual in registry.METRIC_MINT_WRAPPERS:
                continue  # the wrapper's own pass-through mint
            if m.qual in registry.METRIC_DYNAMIC_MINTS:
                dynamic_used.add(m.qual)
                continue
            emit(m.relpath, m.line,
                 "dynamically named metric mint — register the enclosing "
                 f"function ({m.qual.split('::')[-1]}) in "
                 "lint/registry.py:METRIC_MINT_WRAPPERS or "
                 "METRIC_DYNAMIC_MINTS with a justification")

    for dq in sorted(registry.METRIC_DYNAMIC_MINTS):
        names, why = registry.METRIC_DYNAMIC_MINTS[dq]
        if dq not in quals:
            emit(REGISTRY_PATH, 1,
                 f"stale METRIC_DYNAMIC_MINTS entry: {dq!r} names no "
                 "function — drop it or fix the qualname")
        elif dq not in dynamic_used:
            emit(REGISTRY_PATH, 1,
                 f"stale METRIC_DYNAMIC_MINTS entry: {dq!r} contains no "
                 "dynamically named mint any more — drop it")
        if not (why or "").strip():
            emit(REGISTRY_PATH, 1,
                 f"METRIC_DYNAMIC_MINTS entry {dq!r} has no "
                 "justification")

    def name_minted(name: str) -> bool:
        return (
            name in minted_full
            or name in dynamic_names
            or any(name.startswith(p) for p in prefix_minted)
        )

    # -- declared-but-never-minted (both directions of the name contract)
    for value, (cname, line) in sorted(declared_full.items()):
        if not name_minted(value):
            emit(met_rel, line,
                 f"declared metric {cname} = {value!r} is never minted "
                 "anywhere — dead declaration or a renamed mint site")
    for value, (cname, line) in sorted(declared_prefix.items()):
        if not any(p.startswith(value) for p in prefix_minted):
            emit(met_rel, line,
                 f"declared metric prefix {cname} = {value!r} has no "
                 "prefix mint site — dead declaration or a renamed "
                 "family")

    # -- fault-substring coverage + ObsSpec name checks, per tier
    all_segments = [s for e in emits for s in e.segments]
    shared_used: Set[str] = set()
    ambiguity_seen: Set[Tuple[str, int, str]] = set()
    for relpath, dict_name, entries in tiers:
        for kind in sorted(entries):
            entry = entries[kind]
            if kind not in taxonomy:
                emit(entry.relpath, entry.line,
                     f"{dict_name} key {kind!r} is not a "
                     f"{tax_rel}:BYZ_* taxonomy kind — stale or "
                     "misspelled")
            if not (entry.fault_any or entry.counters or entry.gauges):
                emit(entry.relpath, entry.line,
                     f"{dict_name}[{kind!r}] declares NO observable — "
                     "an empty ObsSpec makes silent tolerance pass")
            for sub in entry.fault_any:
                if not any(sub in seg for seg in all_segments):
                    emit(entry.relpath, entry.line,
                         f"{dict_name}[{kind!r}] declares fault "
                         f"substring {sub!r} but no statically "
                         "reachable fault-emit string contains it — "
                         "the detection was reworded or removed")
            for name in entry.counters + entry.gauges:
                if not name_declared(name):
                    emit(entry.relpath, entry.line,
                         f"{dict_name}[{kind!r}] references metric "
                         f"{name!r} not declared in {met_rel}")
                elif not name_minted(name):
                    emit(entry.relpath, entry.line,
                         f"{dict_name}[{kind!r}] references metric "
                         f"{name!r} that no reachable site mints — the "
                         "observable can never materialize")
        # exclusive attribution: a literal emit that ties >= 2 kinds at
        # maximal substring length splits _attribute's pick across
        # injection sets — deliberate shares must be declared
        for e in emits:
            if e.full is None:
                continue
            best_len = 0
            best: Dict[str, str] = {}
            for kind in entries:
                for sub in entries[kind].fault_any:
                    if sub in e.full and len(sub) >= best_len:
                        if len(sub) > best_len:
                            best_len = len(sub)
                            best = {}
                        best[kind] = sub
            if len(best) < 2:
                continue
            kinds = tuple(sorted(best))
            dedup = (e.relpath, e.line, ",".join(kinds))
            if dedup in ambiguity_seen:
                continue
            ambiguity_seen.add(dedup)
            excused = False
            for sub, (skinds, why) in registry.CONTRACT_SHARED_SUBSTRINGS.items():
                if (
                    sub in best.values()
                    and tuple(sorted(skinds)) == kinds
                    and (why or "").strip()
                ):
                    shared_used.add(sub)
                    excused = True
                    break
            if not excused:
                emit(e.relpath, e.line,
                     f"fault emit {e.full!r} matches {len(best)} registry "
                     f"families at equal length ({', '.join(kinds)}) — "
                     "attribution is injection-dependent; declare the "
                     "tie in lint/registry.py:CONTRACT_SHARED_SUBSTRINGS "
                     "with a justification, or make the strings "
                     "distinguishable")
    for sub in sorted(registry.CONTRACT_SHARED_SUBSTRINGS):
        if sub not in shared_used:
            emit(REGISTRY_PATH, 1,
                 f"stale CONTRACT_SHARED_SUBSTRINGS entry: {sub!r} "
                 "excuses no ambiguous emit any more — drop it")

    # -- taxonomy closure: injectable, claimed, observable
    claimed: Set[str] = set()
    for _rel, _dn, entries in tiers:
        claimed.update(entries)
    for value in sorted(taxonomy):
        cname, line = taxonomy[value]
        if value not in claimed and tiers:
            emit(tax_rel, line,
                 f"taxonomy kind {cname} = {value!r} appears in no tier "
                 "registry — no observability story, so scenario runs "
                 "cannot verify it")
        if value not in injected:
            emit(tax_rel, line,
                 f"taxonomy kind {cname} = {value!r} has no injection "
                 "site (no InjectionLog.note call or strategy kind= "
                 "binding resolves to it) — dead taxonomy or a renamed "
                 "injector")

    findings.sort(key=lambda f: (f.path, f.line, f.message))
    return findings


def check(sf: SourceFile) -> List[Finding]:
    root = sf.path.parent if sf.relpath == ANCHOR else PACKAGE_ROOT
    return check_root(root, PACKAGE_ROOT.name)
