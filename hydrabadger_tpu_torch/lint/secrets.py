"""Rule ``secret-taint``: key material never leaves the process legible.

DKG shares, channel keys, identity secret keys and decryption shares
live in the same address space as logging, exception rendering and the
wire plane.  One ``log.warning("bad share %s", share)`` or an
f-string in a ``raise`` turns a 2^-128 security level into a grep.
This pass tracks key material interprocedurally and reports it
reaching:

  * a **logging call** (any call on a ``log``/``logger`` binding) or an
    **obs emission** (any call on an ``obs``/``recorder`` binding —
    trace events are exported to disk, so secrets can never enter one;
    ``registry.OBS_EMIT_NAMES``);
  * an **exception message** (a secret-tainted argument to a ``raise``d
    constructor, including f-string interpolation);
  * ``repr()`` / ``str()`` / ``print()``;
  * **serialization toward the wire or disk** (``codec.encode``)
    outside the sealing primitives.

Sources: identifiers carrying a secret token (``sk``, ``secret``,
``seckey`` as an underscore-token; ``chan_key`` etc. as substrings —
``lint/registry.py:SECRET_NAME_TOKENS``/``SECRET_NAMES``) and instances
of the registered secret classes (``SecretKey``, ``SecretKeyShare``,
``SecretKeySet``).  Sanitizers: the sealing/KDF/signing primitives in
``registry.SECRET_SEAL_FUNCS`` — a secret disappearing into a hash or a
group exponentiation is the intended use.  ``to_bytes()`` on a secret
stays secret (it is the raw scalar).

Class hygiene: every registered secret class must define a redacting
``__repr__`` — the default dataclass repr prints the scalar into any
``%s`` that touches the object.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional

from . import Finding, PACKAGE_ROOT, SourceFile
from . import registry
from .callgraph import CallGraph, FuncInfo, build as build_graph
from .dataflow import CLEAN, InterEngine, Policy

RULE = "secret-taint"

ANCHOR = "__init__.py"  # package pass, anchored on the root


def applies(relpath: str) -> bool:
    return relpath == ANCHOR


def _secret_ident(name: str) -> bool:
    tokens = [t for t in name.lower().split("_") if t]
    if any(t in registry.SECRET_NAME_TOKENS for t in tokens):
        return True
    low = name.lower()
    return any(s in low for s in registry.SECRET_NAMES)


class SecretPolicy(Policy):
    TOP = 2
    guard_sanitizes = False

    def param_state(self, fi: FuncInfo, param: str) -> int:
        return self.TOP if _secret_ident(param) else CLEAN

    def unknown_name_state(self, name: str) -> int:
        return self.TOP if _secret_ident(name) else CLEAN

    def name_floor(self, name: str) -> int:
        return self.TOP if _secret_ident(name) else CLEAN

    def attr_state(self, attr: str, base_state: int, node) -> int:
        if _secret_ident(attr):
            return self.TOP
        if attr in registry.SECRET_SAFE_ATTRS:
            return CLEAN  # size/type metadata of a secret is not secret
        return base_state

    def call_state(self, walker, node, dotted, site, base_state, arg_states):
        dn = dotted or ""
        parts = dn.split(".")
        bare = parts[-1]
        if bare in registry.SECRET_SAFE_CALLS:
            return CLEAN  # len()/type() of a secret is not secret
        if bare in registry.SECRET_SEAL_FUNCS:
            return CLEAN  # sealed/hashed/exponentiated: the intended use
        if any(p in registry.SECRET_CLASSES for p in parts):
            return self.TOP  # SecretKey(...), SecretKey.from_bytes(...)
        if _secret_ident(bare):
            return self.TOP  # _chan_key(...), warm_channel_keys-style
        if site is not None and site.targets and walker.engine is not None:
            if site.kind == "ctor":
                ctor_secret = any(
                    self._target_class(walker, t) in registry.SECRET_CLASSES
                    for t in site.targets
                )
                if ctor_secret:
                    return self.TOP
                return max(arg_states, default=CLEAN)
            return max(
                (walker.engine.returns.get(t, CLEAN) for t in site.targets),
                default=CLEAN,
            )
        return max([base_state] + arg_states, default=CLEAN)

    @staticmethod
    def _target_class(walker, qual: str) -> Optional[str]:
        fi = walker.graph.functions.get(qual) if walker.graph else None
        return fi.cls if fi is not None else qual.rsplit("::", 1)[-1]


def _obs_binding(name: str) -> bool:
    """Is ``name`` an obs emitter binding?  Exact registry names plus
    the ``*obs`` suffix idiom (``obs``, ``eobs``, ``epoch_obs``…)."""
    return name in registry.OBS_EMIT_NAMES or name.endswith(
        registry.OBS_EMIT_SUFFIX
    )


# -- sink scanning -----------------------------------------------------------


class _SecretScanner:
    def __init__(self, graph: CallGraph, engine: InterEngine, shown_prefix: str):
        self.graph = graph
        self.engine = engine
        self.shown_prefix = shown_prefix
        self.findings: List[Finding] = []

    def _emit(self, relpath: str, node, message: str) -> None:
        self.findings.append(
            Finding(
                rule=RULE,
                path=f"{self.shown_prefix}/{relpath}",
                line=getattr(node, "lineno", 1),
                message=message,
            )
        )

    def scan_function(self, fi: FuncInfo) -> None:
        fa = self.engine.final_analysis(fi.qualname)
        if fa is None:
            return

        def secret(expr: ast.expr, stmt: ast.stmt) -> bool:
            return fa.eval(expr, fa.env_at(stmt)) == SecretPolicy.TOP

        def visit(stmt: ast.stmt) -> None:
            if isinstance(
                stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                return
            in_raise = isinstance(stmt, ast.Raise)
            for node in ast.iter_child_nodes(stmt):
                if isinstance(node, ast.expr):
                    self._scan_expr(fi, stmt, node, secret, in_raise)
                elif isinstance(node, ast.stmt):
                    visit(node)
                elif isinstance(node, ast.excepthandler):
                    for inner in node.body:
                        visit(inner)

        for stmt in getattr(fi.node, "body", []):
            visit(stmt)

    def _scan_expr(self, fi, stmt, expr, secret, in_raise) -> None:
        from . import dotted_name

        for sub in ast.walk(expr):
            if not isinstance(sub, ast.Call):
                continue
            # full dotted resolution so attribute-chained sinks are seen
            # too: ``self.obs.emit(...)`` is [self, obs, emit]
            dn = dotted_name(sub.func)
            dn_parts = dn.split(".") if dn else []
            if dn_parts and (
                dn_parts[-1] in registry.SECRET_SAFE_CALLS
                or dn_parts[-1] in registry.SECRET_SEAL_FUNCS
            ):
                continue  # len(secret) inside a raise is fine
            args = list(sub.args) + [kw.value for kw in sub.keywords]
            # 1. logging + obs emission (trace events are exported —
            # registry.OBS_EMIT_NAMES/_SUFFIX make an emitter a sink)
            if (
                len(dn_parts) >= 2
                and (
                    dn_parts[-2] in registry.LOG_NAMES
                    or _obs_binding(dn_parts[-2])
                )
                and any(secret(a, stmt) for a in args)
            ):
                self._emit(
                    fi.relpath,
                    sub,
                    f"key material reaches logging/obs emission in "
                    f"{fi.name!r} — log a digest or redact; never the "
                    "share/key itself",
                )
            # 2. exception messages (constructor args inside a raise)
            elif in_raise and any(secret(a, stmt) for a in args):
                self._emit(
                    fi.relpath,
                    sub,
                    f"key material interpolated into an exception in "
                    f"{fi.name!r} — exceptions end up in logs and crash "
                    "reports; describe the failure without the value",
                )
            # 3. repr/str/print
            elif (
                len(dn_parts) == 1
                and dn_parts[0] in ("repr", "str", "print", "format")
                and any(secret(a, stmt) for a in args)
            ):
                self._emit(
                    fi.relpath,
                    sub,
                    f"{dn_parts[0]}() renders key material in {fi.name!r}",
                )
            # 4. serialization toward wire/disk
            elif (
                len(dn_parts) >= 2
                and dn_parts[-1] == "encode"
                and dn_parts[-2] in ("codec",)
                and any(secret(a, stmt) for a in args)
            ):
                self._emit(
                    fi.relpath,
                    sub,
                    f"key material serialized unsealed in {fi.name!r} "
                    "(codec.encode) — seal it (dkg._seal) or keep it out "
                    "of serialized payloads",
                )

    def scan_class_hygiene(self) -> None:
        """Registered secret classes must define a redacting __repr__."""
        for name in sorted(registry.SECRET_CLASSES):
            for ci in self.graph.class_named(name):
                mi = self.graph.mro_method(ci, "__repr__")
                if mi is None:
                    self._emit(
                        ci.relpath,
                        ci.node,
                        f"secret class {name} has no redacting __repr__ — "
                        "the default (dataclass) repr prints the scalar "
                        "into any '%s' that touches the object",
                    )


# -- the rule ----------------------------------------------------------------


def check_root(root: Path, shown_prefix: str) -> List[Finding]:
    graph = build_graph(root)
    engine = InterEngine(graph, SecretPolicy())
    engine.run()
    scanner = _SecretScanner(graph, engine, shown_prefix)
    for fi in graph.functions.values():
        scanner.scan_function(fi)
    scanner.scan_class_hygiene()
    scanner.findings.sort(key=lambda f: (f.path, f.line))
    return scanner.findings


def check(sf: SourceFile) -> List[Finding]:
    root = sf.path.parent if sf.relpath == ANCHOR else PACKAGE_ROOT
    return check_root(root, PACKAGE_ROOT.name)
