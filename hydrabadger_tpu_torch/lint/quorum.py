"""Rule ``quorum-arith``: every Byzantine threshold comparison is
declared, classified, and verified against its canonical form (hbquorum).

Every safety property HBBFT gives us bottoms out in ~27 inline
threshold comparisons (``f + 1``, ``2*f + 1``, ``n - f``,
``count_complete() > t``, the shadow-DKG ``> f`` marker) scattered
across ``consensus/``, ``net/`` and ``sim/`` — and every ROADMAP item
that touches thresholds edits them again.  An off-by-one, or an
existence quorum used where an intersection quorum is required, is
silent until an adversarial run happens to hit it.  This pass pins the
class mechanically with the repo's declare-then-check discipline:

  * **sites** — every ``ast.Compare`` of a *count* (``len(...)``,
    ``sum(...)``, ``.qsize()``, a ``count``-named value, a ``self.X``
    counter attribute — an integer attribute of the class whose only
    growth sites are ``+= 1`` and whose plain writes are integer
    constants, like the Subset's ``self._accepted`` — or a local bound
    to one) against an expression in the fault-tolerance
    parameters.  Parameters resolve like hbstate resolves state:
    ``netinfo.num_faulty``/``num_nodes``/``num_correct``/
    ``pk_set.threshold`` attribute suffixes, ``len(node_ids)``-style
    roster sizes, the ``(n - 1) // 3`` derivation, locals bound to any
    of those, ``self.X`` attributes typed from ``__init__`` arithmetic
    (``self.data_shards = n - 2 * f``), and calls into single-return
    helpers (``quorum_exists``/``quorum_intersect``/``dkg_degree`` on
    consensus/types.py) inlined through the call graph.  Param-vs-param
    comparisons (``0 <= f <= (n - 1) // 3``) and index guards
    (``i >= n - f_byz``) are out of scope by construction: one side
    must be a count.

  * **declaration** — each site must appear in
    ``lint/registry.py:QUORUM_SITES`` keyed
    ``"relpath::Qualname::<canonical bound>"`` (one key covers every
    same-bound comparison in that function) with a class:

      - ``existence`` — ``f + 1``-class: at least one honest witness;
      - ``intersection`` — ``2*f + 1`` / ``n - f``-class: any two
        quorums share an honest node;
      - ``dkg_degree`` — ``t + 1``-class: t+1 shares determine a
        degree-t polynomial;
      - ``marker`` — the ``> f`` era-cutover marker quorum
        (arithmetically an existence bound; semantically a distinct
        protocol gate, so it is declared as what it is);
      - ``custom`` — deliberately non-canonical arithmetic (the
        ``n*n`` ack gates, strict-majority votes, transcript
        ceilings): the justification string is MANDATORY and audited
        in review.

  * **verification** — the declared class is checked against the
    actual arithmetic and comparison direction.  The *satisfied-at*
    count is normalized (``> B`` fires at B+1, ``>= B``/``== B`` at B,
    ``<= B`` is the negative guard of B+1) and compared against the
    class's canonical polynomial — symbolically first, then reduced
    under ``n = 3f + 1`` / ``t = f`` (so ``n - 2*f`` verifies as an
    existence bound and a roster-derived ``(n-1)//3 + 1`` as a DKG
    degree).  Off-by-one or wrong-direction guards (``> 2*f + 1``,
    ``>= f``) and misclassified sites are findings.

  * **findings** — an undeclared site; a declared class the arithmetic
    contradicts; a ``custom`` site without a justification; a stale
    registry key (no matching comparison left); an unknown class name.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from . import Finding, PACKAGE_ROOT, SourceFile
from . import registry
from .callgraph import CallGraph, FuncInfo, build as build_graph

RULE = "quorum-arith"

ANCHOR = "__init__.py"  # package pass: runs once, anchored on the root

# files whose comparisons are in scope (consensus cores, both network
# tiers, the sim plane); crypto/ops planes receive structure-validated
# degrees pinned by their callers
SCOPE_PREFIXES = ("consensus/", "net/", "sim/")

CLASSES = ("existence", "intersection", "dkg_degree", "marker", "custom")

# bare names that denote a fault-tolerance parameter when they are a
# function parameter or an unassigned free variable
SYMBOL_NAMES = {
    "f": "f",
    "t": "t",
    "n": "n",
    "f_byz": "f",
    "n_byz": "f",
    "n_byzantine": "f",
    "n_nodes": "n",
    "num_faulty": "f",
    "num_nodes": "n",
    "threshold": "t",
}

# attribute suffixes that denote a parameter wherever the base came from
ATTR_SYMBOLS = {
    "num_faulty": {("f",): 1},
    "num_nodes": {("n",): 1},
    "num_correct": {("n",): 1, ("f",): -1},
    "threshold": {("t",): 1},
}

# roster containers whose len() is the validator-set size
ROSTER_NAMES = frozenset({"node_ids", "new_ids", "pub_keys"})

_OP_DELTA = {"Gt": 1, "GtE": 0, "Eq": 0, "NotEq": 0, "Lt": 0, "LtE": 1}
_OP_FLIP = {"Gt": "Lt", "GtE": "LtE", "Lt": "Gt", "LtE": "GtE",
            "Eq": "Eq", "NotEq": "NotEq"}
_OP_TEXT = {"Gt": ">", "GtE": ">=", "Eq": "==", "NotEq": "!=",
            "Lt": "<", "LtE": "<="}


def applies(relpath: str) -> bool:
    return relpath == ANCHOR


# -- polynomial arithmetic ---------------------------------------------------
#
# A parameter expression is a polynomial over the symbols f/t/n: a dict
# from a sorted symbol tuple (with multiplicity; () = the constant term)
# to an integer coefficient.  {('f',): 2, (): 1} is 2*f + 1.

Poly = Dict[Tuple[str, ...], int]


def _padd(a: Poly, b: Poly, sign: int = 1) -> Poly:
    out = dict(a)
    for mono, coeff in b.items():
        out[mono] = out.get(mono, 0) + sign * coeff
        if out[mono] == 0:
            del out[mono]
    return out


def _pmul(a: Poly, b: Poly) -> Poly:
    out: Poly = {}
    for ma, ca in a.items():
        for mb, cb in b.items():
            mono = tuple(sorted(ma + mb))
            out[mono] = out.get(mono, 0) + ca * cb
            if out[mono] == 0:
                del out[mono]
    return out


def _pconst(v: int) -> Poly:
    return {(): v} if v else {}


def _symbols(p: Poly) -> Set[str]:
    return {s for mono in p for s in mono}


def render(p: Poly) -> str:
    """Canonical text: monomials by degree (desc) then name, constant
    last — ``2*f+1``, ``n-f``, ``n*n``, ``2*n*n+2*n+1``."""
    if not p:
        return "0"
    parts = []
    for mono in sorted(p, key=lambda m: (-len(m), p[m] < 0, m)):
        coeff = p[mono]
        body = "*".join(mono)
        if not mono:
            term = str(abs(coeff))
        elif abs(coeff) == 1:
            term = body
        else:
            term = f"{abs(coeff)}*{body}"
        sign = "-" if coeff < 0 else "+"
        parts.append((sign, term))
    first_sign, first = parts[0]
    out = ("-" if first_sign == "-" else "") + first
    for sign, term in parts[1:]:
        out += sign + term
    return out


# canonical satisfied-at forms per class, symbolically
_CANON: Dict[str, Tuple[Poly, ...]] = {
    "existence": ({("f",): 1, (): 1},),
    "marker": ({("f",): 1, (): 1},),
    "intersection": ({("f",): 2, (): 1}, {("n",): 1, ("f",): -1}),
    "dkg_degree": ({("t",): 1, (): 1},),
}

# n = 3f + 1, t = f
_REDUCE = {"n": {("f",): 3, (): 1}, "t": {("f",): 1}, "f": {("f",): 1}}


def reduce_poly(p: Poly) -> Poly:
    out: Poly = {}
    for mono, coeff in p.items():
        term = _pconst(1) if mono else _pconst(coeff)
        if mono:
            term = {(): coeff}
            for sym in mono:
                term = _pmul(term, _REDUCE[sym])
        out = _padd(out, term)
    return out


def class_matches(cls: str, satisfied_at: Poly) -> bool:
    forms = _CANON[cls]
    if any(satisfied_at == f for f in forms):
        return True
    red = reduce_poly(satisfied_at)
    return any(red == reduce_poly(f) for f in forms)


# -- parameter-expression evaluation -----------------------------------------


class _Evaluator:
    """Evaluate AST expressions to parameter polynomials, resolving
    locals, attribute suffixes, roster lens, ``(n-1)//3``, ``__init__``-
    typed ``self.X`` attributes, and single-return helper calls."""

    MAX_DEPTH = 4

    def __init__(self, graph: CallGraph):
        self.graph = graph
        # (class qualname, attr) -> Poly, harvested lazily from __init__
        self._attr_cache: Dict[Tuple[str, str], Optional[Poly]] = {}

    # env: name -> Poly for locals; killed: names assigned to non-param
    # values (they must never fall back to the bare-symbol heuristic)
    def function_env(self, fi: FuncInfo) -> Tuple[Dict[str, Poly], Set[str]]:
        env: Dict[str, Poly] = {}
        killed: Set[str] = set()

        def bind(name: str, value: ast.expr) -> None:
            p = self.eval(value, env, killed, fi)
            if p is not None and _symbols(p):
                env[name] = p
                killed.discard(name)
            else:
                killed.add(name)
                env.pop(name, None)

        def visit(stmt: ast.stmt) -> None:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                return
            if isinstance(stmt, ast.Assign):
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Name):
                        bind(tgt.id, stmt.value)
                    elif isinstance(tgt, ast.Tuple) and isinstance(
                        stmt.value, ast.Tuple
                    ) and len(tgt.elts) == len(stmt.value.elts):
                        for te, ve in zip(tgt.elts, stmt.value.elts):
                            if isinstance(te, ast.Name):
                                bind(te.id, ve)
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                if isinstance(stmt.target, ast.Name):
                    bind(stmt.target.id, stmt.value)
            for sub in ast.iter_child_nodes(stmt):
                if isinstance(sub, ast.stmt):
                    visit(sub)
                elif isinstance(sub, ast.excepthandler):
                    for inner in sub.body:
                        visit(inner)

        for stmt in getattr(fi.node, "body", []):
            visit(stmt)
        return env, killed

    def attr_poly(self, fi: FuncInfo, attr: str) -> Optional[Poly]:
        """Poly for ``self.<attr>``, typed from ``self.<attr> = <expr>``
        assignments anywhere in the enclosing class (``self.data_shards
        = n - 2 * f`` in ``__init__``, ``self.n = len(pub_keys)`` in
        ``start``).  Constant initializers (``self.n = 0``) are ignored;
        two DIFFERENT parameter polynomials make the attribute ambiguous
        and untyped."""
        if fi.cls is None:
            return None
        key = (f"{fi.relpath}::{fi.cls}", attr)
        if key in self._attr_cache:
            return self._attr_cache[key]
        self._attr_cache[key] = None  # recursion guard
        ci = self.graph.classes.get(key[0])
        found: List[Poly] = []
        for meth in (ci.methods.values() if ci is not None else ()):
            env = killed = None
            for node in ast.walk(meth.node):
                if not isinstance(node, ast.Assign):
                    continue
                for tgt in node.targets:
                    if (
                        isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                        and tgt.attr == attr
                    ):
                        if env is None:
                            env, killed = self.function_env(meth)
                        p = self.eval(node.value, env, killed, meth)
                        if p is not None and _symbols(p):
                            found.append(p)
        if found and all(p == found[0] for p in found):
            self._attr_cache[key] = found[0]
        return self._attr_cache[key]

    def eval(
        self,
        expr: ast.expr,
        env: Dict[str, Poly],
        killed: Set[str],
        fi: Optional[FuncInfo],
        depth: int = 0,
    ) -> Optional[Poly]:
        if depth > self.MAX_DEPTH:
            return None
        if isinstance(expr, ast.Constant):
            if isinstance(expr.value, bool) or not isinstance(expr.value, int):
                return None
            return _pconst(expr.value)
        if isinstance(expr, ast.Name):
            if expr.id in env:
                return env[expr.id]
            if expr.id in killed:
                return None
            sym = SYMBOL_NAMES.get(expr.id)
            return {(sym,): 1} if sym else None
        if isinstance(expr, ast.Attribute):
            if expr.attr in ATTR_SYMBOLS:
                return dict(ATTR_SYMBOLS[expr.attr])
            if (
                isinstance(expr.value, ast.Name)
                and expr.value.id == "self"
                and fi is not None
            ):
                return self.attr_poly(fi, expr.attr)
            return None
        if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.USub):
            p = self.eval(expr.operand, env, killed, fi, depth)
            return None if p is None else {m: -c for m, c in p.items()}
        if isinstance(expr, ast.BinOp):
            if isinstance(expr.op, ast.FloorDiv):
                # the canonical derivation (n - 1) // 3 -> f; nothing
                # else floor-divides soundly in poly space
                num = self.eval(expr.left, env, killed, fi, depth + 1)
                den = self.eval(expr.right, env, killed, fi, depth + 1)
                if (
                    num == {("n",): 1, (): -1}
                    and den == _pconst(3)
                ):
                    return {("f",): 1}
                return None
            left = self.eval(expr.left, env, killed, fi, depth + 1)
            right = self.eval(expr.right, env, killed, fi, depth + 1)
            if left is None or right is None:
                return None
            if isinstance(expr.op, ast.Add):
                return _padd(left, right)
            if isinstance(expr.op, ast.Sub):
                return _padd(left, right, -1)
            if isinstance(expr.op, ast.Mult):
                return _pmul(left, right)
            return None
        if isinstance(expr, ast.Call):
            fn = expr.func
            if isinstance(fn, ast.Name) and fn.id == "len" and expr.args:
                arg = expr.args[0]
                last = (
                    arg.attr if isinstance(arg, ast.Attribute)
                    else arg.id if isinstance(arg, ast.Name) else None
                )
                if last in ROSTER_NAMES:
                    return {("n",): 1}
                return None
            return self._inline_call(expr, env, killed, fi, depth)
        return None

    def _inline_call(
        self,
        call: ast.Call,
        env: Dict[str, Poly],
        killed: Set[str],
        fi: Optional[FuncInfo],
        depth: int,
    ) -> Optional[Poly]:
        """Resolve ``quorum_exists(n, f)``-style calls: a call-graph
        target whose body is a single ``return <expr>`` evaluates with
        its parameters bound to the (poly-evaluated) arguments."""
        if call.keywords:
            return None
        caller = fi.qualname if fi is not None else ""
        target: Optional[FuncInfo] = None
        for site in self.graph.calls_by_caller.get(caller, []):
            if site.node is call and site.via == "typed" and site.targets:
                target = self.graph.functions.get(site.targets[0])
                break
        if target is None:
            return None
        body = getattr(target.node, "body", [])
        stmts = [s for s in body if not isinstance(s, ast.Expr)]  # skip doc
        if len(stmts) != 1 or not isinstance(stmts[0], ast.Return):
            return None
        ret = stmts[0].value
        if ret is None:
            return None
        params = [p for p in target.params if p != "self"]
        if len(params) != len(call.args):
            return None
        inner_env: Dict[str, Poly] = {}
        for name, arg in zip(params, call.args):
            p = self.eval(arg, env, killed, fi, depth + 1)
            if p is None:
                return None
            inner_env[name] = p
        return self.eval(ret, inner_env, set(), target, depth + 1)


# -- count-side recognition --------------------------------------------------


def _countish(
    expr: ast.expr, cenv: Set[str], cattrs: frozenset = frozenset()
) -> Optional[int]:
    """Scale when this side measures a count (1 for a plain count,
    c for ``count * c``), else None.  ``cattrs`` are the enclosing
    class's counter attributes (:func:`_counter_attrs`)."""
    if isinstance(expr, ast.Call):
        fn = expr.func
        if isinstance(fn, ast.Name) and fn.id in ("len", "sum"):
            return 1
        bare = fn.attr if isinstance(fn, ast.Attribute) else getattr(
            fn, "id", ""
        )
        if bare == "qsize" or "count" in (bare or ""):
            return 1
        return None
    if isinstance(expr, ast.Name):
        if expr.id in cenv or "count" in expr.id:
            return 1
        return None
    if isinstance(expr, ast.Attribute):
        if "count" in expr.attr:
            return 1
        if (
            isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and expr.attr in cattrs
        ):
            return 1
        return None
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Mult):
        for a, b in ((expr.left, expr.right), (expr.right, expr.left)):
            if isinstance(a, ast.Constant) and isinstance(a.value, int):
                s = _countish(b, cenv, cattrs)
                if s is not None:
                    return s * a.value
        return None
    return None


def _self_target(node: ast.expr) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _int_const(node: Optional[ast.expr]) -> bool:
    return (
        isinstance(node, ast.Constant)
        and isinstance(node.value, int)
        and not isinstance(node.value, bool)
    )


def _counter_attrs(graph: CallGraph, ci) -> frozenset:
    """``self.X`` attributes of class ``ci`` that only ever count: at
    least one ``self.X += 1``, no other augmented write, and every plain
    write an integer constant (the initial value or a reset)."""
    incs: Set[str] = set()
    other: Set[str] = set()
    for meth in ci.methods.values():
        for node in ast.walk(meth.node):
            if isinstance(node, ast.AugAssign):
                attr = _self_target(node.target)
                if attr is None:
                    continue
                if isinstance(node.op, ast.Add) and _int_const(node.value) \
                        and node.value.value == 1:
                    incs.add(attr)
                else:
                    other.add(attr)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (
                    node.targets if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for tgt in targets:
                    elts = tgt.elts if isinstance(tgt, ast.Tuple) else [tgt]
                    for elt in elts:
                        attr = _self_target(elt)
                        if attr is not None and not (
                            elt is tgt and _int_const(node.value)
                        ):
                            other.add(attr)
    return frozenset(incs - other)


def _count_locals(fi: FuncInfo, cattrs: frozenset = frozenset()) -> Set[str]:
    """Locals bound to a count expression (``count = len(...)``)."""
    out: Set[str] = set()
    for node in ast.walk(fi.node):
        if isinstance(node, ast.Assign):
            if _countish(node.value, out, cattrs) is not None:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        out.add(tgt.id)
    return out


# -- site discovery ----------------------------------------------------------


class Site:
    def __init__(self, relpath: str, qual: str, line: int, key_bound: str,
                 satisfied_at: Optional[Poly], op_text: str, scale: int):
        self.relpath = relpath
        self.qual = qual  # "Class.method" | "fn"
        self.line = line
        self.key = f"{relpath}::{qual}::{key_bound}"
        self.satisfied_at = satisfied_at  # None for scaled sites
        self.op_text = op_text
        self.scale = scale


def _own_compares(fi: FuncInfo) -> List[ast.Compare]:
    """Compare nodes in this function, excluding nested defs (they have
    their own FuncInfo)."""
    out: List[ast.Compare] = []

    def walk(node: ast.AST, top: bool) -> None:
        for sub in ast.iter_child_nodes(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(sub, ast.Compare):
                out.append(sub)
            walk(sub, False)

    walk(fi.node, True)
    return out


def collect_sites(graph: CallGraph) -> List[Site]:
    ev = _Evaluator(graph)
    sites: List[Site] = []
    counters: Dict[str, frozenset] = {}
    for fi in graph.functions.values():
        if not fi.relpath.startswith(SCOPE_PREFIXES):
            continue
        compares = _own_compares(fi)
        if not compares:
            continue
        env, killed = ev.function_env(fi)
        cls_key = f"{fi.relpath}::{fi.cls}"
        ci = graph.classes.get(cls_key) if fi.cls is not None else None
        if ci is None:
            cattrs = frozenset()
        else:
            if cls_key not in counters:
                counters[cls_key] = _counter_attrs(graph, ci)
            cattrs = counters[cls_key]
        cenv = _count_locals(fi, cattrs)
        qual = f"{fi.cls}.{fi.name}" if fi.cls else (
            fi.qualname.split("::", 1)[1]
        )
        for cmp in compares:
            operands = [cmp.left] + list(cmp.comparators)
            for i, op in enumerate(cmp.ops):
                left, right = operands[i], operands[i + 1]
                op_name = type(op).__name__
                if op_name not in _OP_DELTA:
                    continue
                for count_side, bound_side, flipped in (
                    (left, right, False), (right, left, True)
                ):
                    bound = ev.eval(bound_side, env, killed, fi)
                    if bound is None or not _symbols(bound):
                        continue
                    if ev.eval(count_side, env, killed, fi) is not None:
                        continue  # param-vs-param, not a counted quorum
                    scale = _countish(count_side, cenv, cattrs)
                    if scale is None:
                        continue
                    norm_op = _OP_FLIP[op_name] if flipped else op_name
                    if scale == 1:
                        satisfied = _padd(
                            bound, _pconst(_OP_DELTA[norm_op])
                        )
                        key_bound = render(satisfied)
                    else:
                        satisfied = None
                        key_bound = (
                            f"{scale}*count{_OP_TEXT[norm_op]}{render(bound)}"
                        )
                    sites.append(Site(
                        fi.relpath, qual, cmp.lineno, key_bound,
                        satisfied, _OP_TEXT[norm_op], scale,
                    ))
                    break
    return sites


# -- the check ---------------------------------------------------------------


def check_root(root: Path, shown_prefix: str) -> List[Finding]:
    graph = build_graph(root)
    findings: List[Finding] = []

    def emit(relpath: str, line: int, message: str) -> None:
        findings.append(Finding(
            rule=RULE,
            path=f"{shown_prefix}/{relpath}",
            line=line,
            message=message,
        ))

    sites = collect_sites(graph)
    declared = registry.QUORUM_SITES
    seen_keys: Set[str] = set()
    reported: Set[Tuple[str, int]] = set()
    for site in sites:
        seen_keys.add(site.key)
        decl = declared.get(site.key)
        if decl is None:
            if (site.key, site.line) in reported:
                continue
            reported.add((site.key, site.line))
            emit(
                site.relpath, site.line,
                f"undeclared quorum comparison: {site.qual} compares a "
                f"count against a fault-tolerance bound "
                f"(satisfied at {site.key.rsplit('::', 1)[1]}) — declare "
                f"{site.key!r} in lint/registry.py:QUORUM_SITES as "
                "existence / intersection / dkg_degree / marker, or "
                "custom with a justification",
            )
            continue
        cls, justification = decl
        if cls not in CLASSES:
            emit(
                site.relpath, site.line,
                f"unknown quorum class {cls!r} declared for {site.key!r} "
                f"— one of {', '.join(CLASSES)}",
            )
            continue
        if cls == "custom":
            if not justification or not str(justification).strip():
                emit(
                    site.relpath, site.line,
                    f"custom quorum site {site.key!r} has no "
                    "justification — deliberately non-canonical "
                    "arithmetic must say why",
                )
            continue
        if site.satisfied_at is None:
            emit(
                site.relpath, site.line,
                f"quorum site {site.key!r} scales its count "
                f"({site.key.rsplit('::', 1)[1]}) — canonical class "
                f"{cls!r} cannot verify it; declare it custom with a "
                "justification",
            )
            continue
        if not class_matches(cls, site.satisfied_at):
            canon = " or ".join(render(p) for p in _CANON[cls])
            emit(
                site.relpath, site.line,
                f"quorum arithmetic contradicts its declared class: "
                f"{site.key!r} is declared {cls!r} (canonical "
                f"satisfied-at {canon}) but the comparison "
                f"({site.op_text}) is satisfied at "
                f"{render(site.satisfied_at)} — off-by-one, wrong "
                "direction, or misclassified",
            )
    for key in sorted(declared):
        if key not in seen_keys:
            emit(
                "lint/registry.py", 1,
                f"stale QUORUM_SITES entry: {key!r} matches no "
                "comparison in the code any more — drop it",
            )
    findings.sort(key=lambda f: (f.path, f.line))
    return findings


def check(sf: SourceFile) -> List[Finding]:
    root = sf.path.parent if sf.relpath == ANCHOR else PACKAGE_ROOT
    return check_root(root, PACKAGE_ROOT.name)
