"""Def-use chains + policy-driven abstract interpretation for the passes.

One walker serves three analyses.  A *policy* supplies the lattice
semantics; the walker supplies the mechanics every pass shares:

  * forward walk of a function body in source order, binding assignment
    targets (tuples, loop targets, comprehension generators, ``self.x``
    pseudo-slots) to abstract states;
  * expression evaluation over the bound environment (calls, attribute
    chains, subscripts, f-strings, comprehensions);
  * per-statement environment snapshots, so a pass can ask "was this
    expression attacker-tainted *at this sink*";
  * guard recognition: ``if <compare involving v or len(v)>:`` whose
    body aborts (return / raise / continue / break) sanitizes ``v`` for
    the rest of the function — the structural form of every entry cap,
    length check and frame-size clamp in the codebase;
  * an interprocedural fixpoint (`InterEngine`): taint entering a
    function's parameters at any call site propagates through that
    function's returns to its callers, over the lint/callgraph edges,
    until stable.  States only grow, so termination is structural.

States are small ints, ``join = max``; 0 is always "clean/static" and
``policy.TOP`` the fully-adversarial top.  The walker is lint-grade by
design: field-insensitive on attributes (``self.x`` is one slot), loop
bodies are walked twice instead of running a full fixpoint per
function, and branch environments merge by sequential over-write —
precise enough for the package's own idioms, conservative elsewhere.
"""
from __future__ import annotations

import ast
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import dotted_name
from .callgraph import CallGraph, CallSite, FuncInfo

CLEAN = 0

# container-mutating methods: an argument flowing in taints the receiver
_MUTATORS = frozenset(
    {
        "append",
        "appendleft",
        "extend",
        "extendleft",
        "add",
        "insert",
        "update",
        "setdefault",
        "put",
        "put_nowait",
    }
)


class Policy:
    """Lattice + semantics hooks; subclasses define a pass's meaning."""

    TOP = 2
    guard_sanitizes = False  # len()/cap guards clear taint
    slice_bounds_sanitize = False  # x[:CONST] yields a clean value

    def param_state(self, fi: FuncInfo, param: str) -> int:
        """Initial abstract state of a parameter (before engine facts)."""
        return CLEAN

    def unknown_name_state(self, name: str) -> int:
        """State of a free name (module global / builtin)."""
        return CLEAN

    def name_floor(self, name: str) -> int:
        """Minimum state of any identifier with this name (the secrets
        policy floors ``sk``-named bindings at TOP regardless of what
        was assigned to them)."""
        return CLEAN

    def attr_state(self, attr: str, base_state: int, node: ast.Attribute) -> int:
        return base_state

    def call_state(
        self,
        walker: "FunctionAnalysis",
        node: ast.Call,
        dotted: Optional[str],
        site: Optional[CallSite],
        base_state: int,
        arg_states: List[int],
    ) -> int:
        """Abstract state of a call's return value."""
        return max([base_state] + arg_states, default=CLEAN)


class FunctionAnalysis:
    """One function, walked once under a policy + parameter facts."""

    def __init__(
        self,
        graph: Optional[CallGraph],
        fi: FuncInfo,
        policy: Policy,
        param_facts: Optional[Dict[str, int]] = None,
        engine: Optional["InterEngine"] = None,
    ):
        self.graph = graph
        self.fi = fi
        self.policy = policy
        self.engine = engine
        self.env: Dict[str, int] = {}
        self.snapshots: Dict[int, Dict[str, int]] = {}  # id(stmt) -> env
        self.guarded: Dict[str, int] = {}  # var -> line of sanitizing guard
        self.return_state = CLEAN
        self.tuple_return: Optional[List[int]] = None
        self.site_args: Dict[int, List[int]] = {}  # id(call) -> arg states
        self.site_base: Dict[int, int] = {}
        self._sites: Dict[int, CallSite] = {}
        if graph is not None:
            for site in graph.calls_by_caller.get(fi.qualname, []):
                self._sites[id(site.node)] = site
        facts = param_facts or {}
        for p in fi.params:
            self.env[p] = max(policy.param_state(fi, p), facts.get(p, CLEAN))
        body = getattr(fi.node, "body", [])
        # two passes: the second stabilises loop-carried bindings and is
        # the one whose snapshots the passes read
        self._walk_body(body, record=False)
        self._walk_body(body, record=True)

    # -- statements ---------------------------------------------------------

    def _walk_body(self, body: Sequence[ast.stmt], record: bool) -> None:
        for stmt in body:
            self._walk_stmt(stmt, record)

    def _walk_stmt(self, stmt: ast.stmt, record: bool) -> None:
        if record:
            self.snapshots[id(stmt)] = dict(self.env)
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # nested defs are separate FuncInfos
        if isinstance(stmt, ast.Assign):
            val = self.eval(stmt.value)
            # element-wise tuple precision never overrides the policy's
            # verdict on the call itself (a sealed call stays clean)
            elems = self._tuple_states(stmt.value) if val > CLEAN else None
            for t in stmt.targets:
                self._bind(t, val, elems)
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._bind(stmt.target, self.eval(stmt.value), None)
        elif isinstance(stmt, ast.AugAssign):
            cur = self._read_target(stmt.target)
            self._bind(stmt.target, max(cur, self.eval(stmt.value)), None)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            it = self.eval(stmt.iter)
            self._bind(stmt.target, it, None)
            self._walk_body(stmt.body, record)
            self._walk_body(stmt.body, record=False)  # loop-carried defs
            self._walk_body(stmt.orelse, record)
        elif isinstance(stmt, ast.While):
            self.eval(stmt.test)
            self._walk_body(stmt.body, record)
            self._walk_body(stmt.body, record=False)
            self._walk_body(stmt.orelse, record)
        elif isinstance(stmt, ast.If):
            self.eval(stmt.test)
            self._walk_body(stmt.body, record)
            self._walk_body(stmt.orelse, record)
            if self.policy.guard_sanitizes and self._aborts(stmt.body):
                for var in self._test_vars(stmt.test):
                    if self.env.get(var, CLEAN) != CLEAN:
                        self.env[var] = CLEAN
                        self.guarded[var] = stmt.lineno
        elif isinstance(stmt, ast.Try):
            self._walk_body(stmt.body, record)
            for h in stmt.handlers:
                if h.name:
                    # exception objects are diagnostics, not data flow
                    self.env[h.name] = CLEAN
                self._walk_body(h.body, record)
            self._walk_body(stmt.orelse, record)
            self._walk_body(stmt.finalbody, record)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                v = self.eval(item.context_expr)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, v, None)
            self._walk_body(stmt.body, record)
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None:
                st = self.eval(stmt.value)
                self.return_state = max(self.return_state, st)
                elems = self._tuple_states(stmt.value)
                if elems is not None:
                    if self.tuple_return is None:
                        self.tuple_return = elems
                    elif len(self.tuple_return) == len(elems):
                        self.tuple_return = [
                            max(a, b)
                            for a, b in zip(self.tuple_return, elems)
                        ]
                    else:
                        self.tuple_return = None
        elif isinstance(stmt, (ast.Expr, ast.Raise, ast.Assert, ast.Delete)):
            for sub in ast.iter_child_nodes(stmt):
                if isinstance(sub, ast.expr):
                    self.eval(sub)

    @staticmethod
    def _aborts(body: Sequence[ast.stmt]) -> bool:
        return any(
            isinstance(s, (ast.Return, ast.Raise, ast.Continue, ast.Break))
            for s in body
        )

    @staticmethod
    def _test_vars(test: ast.expr) -> Set[str]:
        """Names an abort-guard's comparison BOUNDS (direction-aware).

        ``if A > B: abort`` means the fall-through path has A <= B, so
        only A's names are clamped — in ``if pos + n > len(buf): raise``
        that clamps ``n``/``pos``, never ``buf`` (the measuring stick);
        in ``if len(entries) > cap: return`` it clamps ``entries``.
        ``<``/``<=`` mirror; ``==``/``!=``/``in`` pin both sides; an
        ``is (not) None`` existence check clamps nothing.
        """
        out: Set[str] = set()

        def side_names(side: ast.expr) -> Set[str]:
            # bare names plus the bases of len(...) on the bounded side
            names: Set[str] = set()
            for sub in ast.walk(side):
                if isinstance(sub, ast.Name):
                    names.add(sub.id)
            return names

        for node in ast.walk(test):
            if not isinstance(node, ast.Compare):
                continue
            sides = [node.left] + list(node.comparators)
            for op, left, right in zip(node.ops, sides, sides[1:]):
                if isinstance(op, (ast.Is, ast.IsNot)):
                    continue
                if isinstance(op, (ast.Gt, ast.GtE)):
                    out |= side_names(left)
                elif isinstance(op, (ast.Lt, ast.LtE)):
                    out |= side_names(right)
                else:  # ==, !=, in, not in: both sides pinned
                    out |= side_names(left) | side_names(right)
        return out

    # -- binding ------------------------------------------------------------

    def _bind(self, target: ast.expr, state: int, elems: Optional[List[int]]) -> None:
        if isinstance(target, ast.Name):
            self.env[target.id] = state
        elif isinstance(target, ast.Starred):
            self._bind(target.value, state, None)
        elif isinstance(target, (ast.Tuple, ast.List)):
            if elems is not None and len(elems) == len(target.elts):
                for t, s in zip(target.elts, elems):
                    self._bind(t, s, None)
            else:
                for t in target.elts:
                    self._bind(t, state, None)
        elif isinstance(target, ast.Attribute):
            base = dotted_name(target.value)
            if base is not None:
                self.env[f"{base}.{target.attr}"] = state
        elif isinstance(target, ast.Subscript):
            base = dotted_name(target.value)
            if base is not None:
                # storing into a slot taints the whole container
                cur = self.env.get(base, CLEAN)
                self.env[base] = max(cur, state)

    def _read_target(self, target: ast.expr) -> int:
        if isinstance(target, ast.Name):
            return self.env.get(target.id, CLEAN)
        return self.eval(target)

    def _tuple_states(self, value: ast.expr) -> Optional[List[int]]:
        """Element-wise states for a literal tuple or a call with a
        tuple-return summary (enables ``a, b = f(x)`` precision)."""
        if isinstance(value, (ast.Tuple, ast.List)):
            return [self.eval(e) for e in value.elts]
        if isinstance(value, ast.Call) and self.engine is not None:
            site = self._sites.get(id(value))
            if site and site.targets:
                summaries = [
                    self.engine.tuple_returns.get(t) for t in site.targets
                ]
                if summaries and all(
                    s is not None and len(s) == len(summaries[0])
                    for s in summaries
                ):
                    return [max(col) for col in zip(*summaries)]
        return None

    # -- expressions --------------------------------------------------------

    def eval(self, node: ast.expr, env: Optional[Dict[str, int]] = None) -> int:
        """Abstract state of an expression (against ``env`` or the
        walker's current environment)."""
        e = self.env if env is None else env
        return self._eval(node, e)

    def _eval(self, node: ast.expr, env: Dict[str, int]) -> int:
        p = self.policy
        if isinstance(node, ast.Constant):
            return CLEAN
        if isinstance(node, ast.Name):
            st = env.get(node.id, p.unknown_name_state(node.id))
            return max(st, p.name_floor(node.id))
        if isinstance(node, ast.Attribute):
            base = dotted_name(node.value)
            slot = f"{base}.{node.attr}" if base else None
            if slot and slot in env:
                return env[slot]
            return p.attr_state(node.attr, self._eval(node.value, env), node)
        if isinstance(node, ast.Subscript):
            if (
                p.slice_bounds_sanitize
                and isinstance(node.slice, ast.Slice)
                and node.slice.upper is not None
                and self._eval(node.slice.upper, env) == CLEAN
                and (
                    node.slice.lower is None
                    or self._eval(node.slice.lower, env) == CLEAN
                )
            ):
                # x[:CAP] bounds the SIZE — the property the attacker-
                # taint sinks measure (content may remain adversarial)
                return CLEAN
            return max(
                self._eval(node.value, env), self._eval(node.slice, env)
            )
        if isinstance(node, ast.Call):
            base_state = CLEAN
            if isinstance(node.func, ast.Attribute):
                base_state = self._eval(node.func.value, env)
            args = [self._eval(a, env) for a in node.args] + [
                self._eval(kw.value, env) for kw in node.keywords
            ]
            site = self._sites.get(id(node))
            self.site_args[id(node)] = args
            self.site_base[id(node)] = base_state
            # container mutation taints the receiver: step.messages
            # .append(tainted) must make `step` itself tainted, or the
            # taint dies at the next `return step`
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _MUTATORS
                and args
            ):
                worst = max(args)
                if worst > CLEAN:
                    base_dn = dotted_name(node.func.value)
                    if base_dn is not None and env is self.env:
                        root = base_dn.split(".")[0]
                        # never taint `self` itself — one mutated slot
                        # must not poison every other attribute read
                        if root not in ("self", "cls") and root in env:
                            env[root] = max(env[root], worst)
                        env[base_dn] = max(env.get(base_dn, CLEAN), worst)
            return p.call_state(
                self, node, dotted_name(node.func), site, base_state, args
            )
        if isinstance(node, (ast.BinOp,)):
            return max(self._eval(node.left, env), self._eval(node.right, env))
        if isinstance(node, ast.UnaryOp):
            return self._eval(node.operand, env)
        if isinstance(node, ast.BoolOp):
            return max((self._eval(v, env) for v in node.values), default=CLEAN)
        if isinstance(node, ast.Compare):
            return CLEAN  # a bool: bounded whatever its inputs
        if isinstance(node, ast.IfExp):
            return max(self._eval(node.body, env), self._eval(node.orelse, env))
        if isinstance(node, ast.JoinedStr):
            return max(
                (self._eval(v, env) for v in node.values), default=CLEAN
            )
        if isinstance(node, ast.FormattedValue):
            return self._eval(node.value, env)
        if isinstance(node, (ast.List, ast.Tuple, ast.Set)):
            return max((self._eval(v, env) for v in node.elts), default=CLEAN)
        if isinstance(node, ast.Dict):
            parts = [self._eval(v, env) for v in node.values if v is not None]
            parts += [self._eval(k, env) for k in node.keys if k is not None]
            return max(parts, default=CLEAN)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)):
            local = dict(env)
            state = CLEAN
            for gen in node.generators:
                it = self._eval(gen.iter, local)
                saved_env = self.env
                self.env = local
                try:
                    self._bind(gen.target, it, None)
                finally:
                    self.env = saved_env
                for cond in gen.ifs:
                    self._eval(cond, local)
            if isinstance(node, ast.DictComp):
                state = max(
                    self._eval(node.key, local), self._eval(node.value, local)
                )
            else:
                state = self._eval(node.elt, local)
            return state
        if isinstance(node, ast.Starred):
            return self._eval(node.value, env)
        if isinstance(node, ast.Await):
            return self._eval(node.value, env)
        if isinstance(node, ast.Lambda):
            return CLEAN
        if isinstance(node, ast.Slice):
            parts = [
                self._eval(x, env)
                for x in (node.lower, node.upper, node.step)
                if x is not None
            ]
            return max(parts, default=CLEAN)
        if isinstance(node, ast.NamedExpr):
            val = self._eval(node.value, env)
            saved_env = self.env
            self.env = env
            try:
                self._bind(node.target, val, None)
            finally:
                self.env = saved_env
            return val
        return CLEAN

    def env_at(self, stmt: ast.stmt) -> Dict[str, int]:
        return self.snapshots.get(id(stmt), self.env)


class InterEngine:
    """Interprocedural fixpoint: parameter/return facts over the graph."""

    def __init__(self, graph: CallGraph, policy: Policy):
        self.graph = graph
        self.policy = policy
        self.param_facts: Dict[str, Dict[str, int]] = defaultdict(dict)
        self.returns: Dict[str, int] = defaultdict(int)
        self.tuple_returns: Dict[str, Optional[List[int]]] = {}
        self.analyses: Dict[str, FunctionAnalysis] = {}

    def run(self) -> None:
        graph = self.graph
        worklist = list(graph.functions)
        in_list = set(worklist)
        rounds = 0
        while worklist:
            rounds += 1
            if rounds > 20 * max(len(graph.functions), 1):
                break  # safety valve; states are monotone so unreachable
            qual = worklist.pop()
            in_list.discard(qual)
            fi = graph.functions[qual]
            fa = FunctionAnalysis(
                graph, fi, self.policy, self.param_facts[qual], engine=self
            )
            self.analyses[qual] = fa
            if fa.return_state > self.returns[qual] or (
                fa.tuple_return != self.tuple_returns.get(qual)
            ):
                self.returns[qual] = max(self.returns[qual], fa.return_state)
                old = self.tuple_returns.get(qual)
                if old is not None and fa.tuple_return is not None and len(
                    old
                ) == len(fa.tuple_return):
                    self.tuple_returns[qual] = [
                        max(a, b) for a, b in zip(old, fa.tuple_return)
                    ]
                else:
                    self.tuple_returns[qual] = fa.tuple_return
                for site in graph.callers_of.get(qual, []):
                    if site.caller and site.caller not in in_list:
                        worklist.append(site.caller)
                        in_list.add(site.caller)
            # propagate arg states into callee parameter facts
            for site in graph.calls_by_caller.get(qual, []):
                args = fa.site_args.get(id(site.node))
                if not args or not site.targets:
                    continue
                pos_args = args[: len(site.node.args)]
                kw_names = [kw.arg for kw in site.node.keywords]
                kw_states = args[len(site.node.args):]
                for tgt in site.targets:
                    tfi = graph.functions.get(tgt)
                    if tfi is None:
                        continue
                    params = list(tfi.params)
                    offset = 0
                    if params and params[0] in ("self", "cls"):
                        dn = site.dotted or ""
                        if "." in dn and not dn.split(".")[0][:1].isupper():
                            offset = 1
                        elif site.kind == "ctor":
                            offset = 1
                    changed = False
                    facts = self.param_facts[tgt]
                    for i, st in enumerate(pos_args):
                        pi = i + offset
                        if pi < len(params) and st > facts.get(params[pi], 0):
                            facts[params[pi]] = st
                            changed = True
                    for name, st in zip(kw_names, kw_states):
                        if name in params and st > facts.get(name, 0):
                            facts[name] = st
                            changed = True
                    if changed and tgt not in in_list:
                        worklist.append(tgt)
                        in_list.add(tgt)

    def final_analysis(self, qual: str) -> Optional[FunctionAnalysis]:
        """Re-walk under the converged facts, snapshots recorded."""
        fi = self.graph.functions.get(qual)
        if fi is None:
            return None
        return FunctionAnalysis(
            self.graph, fi, self.policy, self.param_facts[qual], engine=self
        )
