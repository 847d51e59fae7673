"""Rule ``clock-domain``: four clocks, no silent mixing.

The codebase runs on four coexisting time domains (declared in
``lint/registry.py:CLOCK_SOURCE_DOMAINS`` and friends):

  * **wall** — host ``time.time()``; the honest ``t_host`` feed field;
  * **mono** — host ``perf_counter()``/``monotonic()``/``loop.time()``;
    resets at process start, meaningless across restarts;
  * **skewed-mono** — ``Hydrabadger._now()``: host monotonic plus the
    chaos-injected offset/drift; every NODE timer must read this so
    injected skew genuinely reaches it;
  * **skewed-wall** — ``Hydrabadger.wall_now()`` and the ``t`` field of
    every node-stamped feed row: what the cluster aggregator corrects.

Cross-domain arithmetic is never meaningful — a skewed stamp minus a
host stamp measures the skew, not the interval — and such mixes have
recurred (a supervisor's freshness check on skewed feed stamps, the
recovery-pin races), so the pass flags:

1. **mixed-domain arithmetic** — ``a - b`` / comparisons where the two
   sides carry different declared domains (same-domain subtraction
   yields a duration, which then composes freely);
2. **skewed freshness** — a ``skewed-*`` value feeding a declared
   supervisor freshness/health decision (``CLOCK_FRESHNESS_FUNCS``): a
   skewed-fast node's feed would look eternally fresh;
3. **persisted monotonic** — a ``mono``/``skewed-mono`` value placed in
   a declared persistence payload (``CLOCK_PERSIST_FUNCS`` — flight
   dumps, checkpoints): it decodes as garbage after a restart;
4. **seam bypass** — a raw OS-clock call inside ``net/`` + ``obs/``
   outside the declared injection points (``CLOCK_INJECTION_POINTS``)
   and host-observer modules (``HOST_CLOCK_MODULES``): a timer that
   reads the host clock directly is a timer the injected-skew contract
   (``HYDRABADGER_CLOCK_SKEW_S`` / ``HYDRABADGER_CLOCK_RATE``) silently
   does not cover.

Inference is per-function and lint-grade: domains propagate through
locals, ``self.`` slots assigned in the same body, registry-declared
attrs (``born``) and feed fields; anything unknown stays silent.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional

from . import Finding, PACKAGE_ROOT, SourceFile, dotted_name
from . import registry
from .asyncflow import own_nodes
from .callgraph import FuncInfo, build as build_graph

RULE = "clock-domain"

ANCHOR = "__init__.py"  # package pass: runs once, anchored on the root

MIXED = "#mixed"  # join of two incompatible domains (e.g. dict.get
# with a fallback from another domain): any arithmetic on it mixes

_TIME_ALIASES = frozenset({"time", "_time", "_t"})
_LOOP_FACTORIES = frozenset({"get_event_loop", "get_running_loop"})

_BYPASS_SCOPE = ("net/", "obs/")


def applies(relpath: str) -> bool:
    return relpath == ANCHOR


def _source_domain(call: ast.Call) -> Optional[str]:
    """Declared domain of a direct clock call, alias-tolerant."""
    dn = dotted_name(call.func)
    if dn is None:
        # loop.time(): asyncio's monotonic ruler —
        # asyncio.get_event_loop().time()
        fn = call.func
        if (
            isinstance(fn, ast.Attribute)
            and fn.attr == "time"
            and isinstance(fn.value, ast.Call)
        ):
            inner = dotted_name(fn.value.func) or ""
            if inner.split(".")[-1] in _LOOP_FACTORIES:
                return "mono"
        return None
    parts = dn.split(".")
    if len(parts) == 2 and parts[0] in _TIME_ALIASES:
        return registry.CLOCK_SOURCE_DOMAINS.get(f"time.{parts[1]}")
    if len(parts) == 2 and parts[1] == "time":
        # loop.time() through a named loop binding
        if parts[0] in ("loop", "_loop", "event_loop"):
            return "mono"
    return None


def _is_raw_clock(call: ast.Call) -> bool:
    """Any call _source_domain recognizes IS a raw OS-clock read: the
    time.* table, chained ``get_event_loop().time()``, and the named
    ``loop = get_running_loop(); loop.time()`` binding — the form the
    transcript-serve cooldown regression actually used, so the bypass
    scan must see it too."""
    return _source_domain(call) is not None


class _FnScan:
    """One function: forward domain inference + sink checks."""

    def __init__(self, fi: FuncInfo, emit, relpath: str):
        self.fi = fi
        self.emit = emit
        self.relpath = relpath
        self.env: Dict[str, str] = {}  # name / "self.x" -> domain
        self.qual = (
            f"{relpath}::{(fi.cls + '.') if fi.cls else ''}{fi.name}"
        )
        self.is_persist = self.qual in registry.CLOCK_PERSIST_FUNCS
        self.is_freshness = self.qual in registry.CLOCK_FRESHNESS_FUNCS
        self.feed_fields = (
            registry.CLOCK_FEED_FIELD_DOMAINS
            if relpath in registry.CLOCK_FEED_CONSUMERS
            else {}
        )

    # -- domain inference ----------------------------------------------------

    def _slot(self, node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Name):
            return node.id
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            return f"self.{node.attr}"
        return None

    def domain(self, node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Call):
            src = _source_domain(node)
            if src is not None:
                return src
            dn = dotted_name(node.func) or ""
            bare = dn.split(".")[-1]
            decl = registry.CLOCK_METHOD_DOMAINS.get(bare)
            if decl is not None:
                return decl
            if bare in ("min", "max") and node.args:
                doms = {self.domain(a) for a in node.args}
                doms.discard(None)
                if len(doms) == 1:
                    return doms.pop()
                if len(doms) > 1:
                    return MIXED
            if bare == "get" and isinstance(node.func, ast.Attribute):
                # feed.get("t_host", fallback): join the declared field
                # domain with the fallback's
                if (
                    node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                ):
                    field = self.feed_fields.get(node.args[0].value)
                    if field is not None:
                        if len(node.args) > 1:
                            fb = self.domain(node.args[1])
                            if fb is not None and fb != field:
                                return MIXED
                        return field
            return None
        if isinstance(node, ast.Subscript):
            if (
                isinstance(node.slice, ast.Constant)
                and isinstance(node.slice.value, str)
            ):
                field = self.feed_fields.get(node.slice.value)
                if field is not None:
                    return field
            return None
        if isinstance(node, ast.Attribute):
            slot = self._slot(node)
            if slot is not None and slot in self.env:
                return self.env[slot]
            decl = registry.CLOCK_ATTR_DOMAINS.get(node.attr)
            if decl is not None:
                return decl
            return None
        if isinstance(node, ast.Name):
            return self.env.get(node.id)
        if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.Add, ast.Sub)
        ):
            lhs, rhs = self.domain(node.left), self.domain(node.right)
            if isinstance(node.op, ast.Sub):
                if lhs is not None and rhs is not None and lhs == rhs:
                    return None  # same-domain delta: a plain duration
                return lhs if rhs is None else None
            # ts + duration keeps the timestamp's domain
            return lhs if lhs is not None else rhs
        if isinstance(node, ast.IfExp):
            a, b = self.domain(node.body), self.domain(node.orelse)
            if a is not None and b is not None and a != b:
                return MIXED
            return a if a is not None else b
        return None

    # -- sinks ---------------------------------------------------------------

    def _check_mix(self, node: ast.AST, left: ast.AST, right: ast.AST,
                   what: str) -> None:
        lhs, rhs = self.domain(left), self.domain(right)
        if MIXED in (lhs, rhs):
            bad = left if lhs == MIXED else right
            self.emit(
                self.fi,
                node,
                f"{what} on a value joining two clock domains in "
                f"{self.fi.name!r} (a fallback/branch mixes domains "
                "upstream) — pick one domain before doing arithmetic",
            )
            return
        if lhs is None or rhs is None or lhs == rhs:
            return
        if self.is_freshness and ("skewed" in lhs or "skewed" in rhs):
            skewed = lhs if "skewed" in lhs else rhs
            self.emit(
                self.fi,
                node,
                f"skewed node time ({skewed}) feeds the freshness/"
                f"health decision in {self.fi.name!r} — a skewed-fast "
                "node's feed looks eternally fresh; compare on the "
                "honest host clock (t_host)",
            )
            return
        self.emit(
            self.fi,
            node,
            f"{what} mixes clock domains {lhs!r} and {rhs!r} in "
            f"{self.fi.name!r} — the result measures the skew between "
            "the clocks, not an interval; read both sides from one "
            "declared domain (lint/registry.py clock tables)",
        )

    def scan(self) -> None:
        # pass 1 — flow-insensitive env to a small fixpoint: every
        # assignment binds its target's domain (two assignments from
        # different domains join to MIXED, the conservative verdict);
        # re-running covers alias chains (``b = a``) independent of
        # AST visit order.  States only grow, so 4 rounds is plenty.
        for _ in range(4):
            changed = False
            for node in own_nodes(self.fi.node):
                if not isinstance(node, ast.Assign):
                    continue
                dom = self.domain(node.value)
                if dom is None:
                    continue
                for tgt in node.targets:
                    slot = self._slot(tgt)
                    if slot is None:
                        continue
                    prev = self.env.get(slot)
                    new = dom if prev in (None, dom) else MIXED
                    if new != prev:
                        self.env[slot] = new
                        changed = True
            if not changed:
                break
        # pass 2 — sinks
        for node in own_nodes(self.fi.node):
            if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.Sub, ast.Add)
            ):
                op = (
                    "subtraction"
                    if isinstance(node.op, ast.Sub)
                    else "addition"
                )
                self._check_mix(node, node.left, node.right, op)
            elif isinstance(node, ast.Compare) and len(node.ops) == 1:
                self._check_mix(
                    node, node.left, node.comparators[0], "comparison"
                )
            elif self.is_persist and isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    dom = self.domain(v)
                    if dom in ("mono", "skewed-mono"):
                        key = (
                            k.value
                            if isinstance(k, ast.Constant)
                            else "<key>"
                        )
                        self.emit(
                            self.fi,
                            v,
                            f"monotonic timestamp ({dom}) persisted under "
                            f"{key!r} in {self.fi.name!r} — monotonic "
                            "clocks reset at process start, the value is "
                            "garbage after a restart; stamp wall time "
                            "(the injected wall clock) instead",
                        )


def check_root(root: Path, shown_prefix: str) -> List[Finding]:
    graph = build_graph(root)
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

    # stale registry declarations: validated against the real package
    # graph; a fixture root only validates entries naming its own files
    real_root = root.resolve() == PACKAGE_ROOT.resolve()
    for table in ("CLOCK_INJECTION_POINTS", "CLOCK_PERSIST_FUNCS",
                  "CLOCK_FRESHNESS_FUNCS"):
        for key in getattr(registry, table):
            if not real_root and key.split("::")[0] not in graph.sources:
                continue
            if key not in graph.functions:
                findings.append(
                    Finding(
                        rule=RULE,
                        path=f"{shown_prefix}/lint/registry.py",
                        line=1,
                        message=(
                            f"{table} entry {key!r} names a function that "
                            "no longer exists — remove the stale "
                            "declaration"
                        ),
                    )
                )

    # per-function inference + sinks (package-wide)
    for fi in graph.functions.values():
        _FnScan(fi, emit, fi.relpath).scan()

    # seam bypass: raw OS clocks in net/ + obs/
    for fi in graph.functions.values():
        if not fi.relpath.startswith(_BYPASS_SCOPE):
            continue
        if fi.relpath in registry.HOST_CLOCK_MODULES:
            continue
        qual = f"{fi.relpath}::{(fi.cls + '.') if fi.cls else ''}{fi.name}"
        if qual in registry.CLOCK_INJECTION_POINTS:
            continue
        for node in own_nodes(fi.node):
            if isinstance(node, ast.Call) and _is_raw_clock(node):
                dn = dotted_name(node.func) or "loop.time"
                findings.append(
                    Finding(
                        rule=RULE,
                        path=f"{shown_prefix}/{fi.relpath}",
                        line=node.lineno,
                        message=(
                            f"raw {dn}() read in {fi.name!r} bypasses the "
                            "node clock seams — injected skew/drift never "
                            "reaches this timer; route through "
                            "self._now()/wall_now() or declare the seam "
                            "in lint/registry.py:CLOCK_INJECTION_POINTS"
                        ),
                    )
                )
    # module-level raw reads in scope (constants, default factories
    # evaluated at import) are deliberate: only function bodies count.
    findings.sort(key=lambda f: (f.path, f.line))
    return findings


def check(sf: SourceFile) -> List[Finding]:
    root = sf.path.parent if sf.relpath == ANCHOR else PACKAGE_ROOT
    return check_root(root, PACKAGE_ROOT.name)
