"""Rule ``blocking-in-async``: no OS-thread block on the event loop.

One asyncio loop drives every wire pump, handler loop and liveness tick
of a node — on the in-process tiers it drives EVERY node.  A blocking
call anywhere under an ``async def`` therefore stalls the whole plane
for its duration: a ``time.sleep`` is a dead network, an inline fsync
on the commit path inflates the very commit-gap metric the chaos tiers
measure (the reason checkpoint writes go to the executor), and an eager
``CryptoFuture.result()`` re-synchronizes the device dispatch the
hbasync plane exists to overlap.

The pass computes which functions are reachable from ``async def``
roots over the lint/callgraph (``create_task``/``gather`` spawns
resolve like any call; low-confidence fallback edges are ignored) and
flags, inside every reachable function:

* calls matching ``lint/registry.py:BLOCKING_CALLS`` (``time.sleep``,
  fsync/fdatasync, ``subprocess`` waits, bare ``open``);
* ``X.result()`` — or ``np.asarray(X)`` / ``list(X)`` / ``tuple(X)`` —
  where ``X`` is bound from a ``submit_*``/``*_submit`` call, outside
  the registered fetch boundaries (``registry.ASYNC_FETCH_POINTS``).

Reachability does not descend through declared executor-offload
boundaries (``registry.EXECUTOR_OFFLOAD_BOUNDARIES``) — functions that
name blocking work but ship it off the loop.  Callables handed to
``loop.run_in_executor`` never create call edges, so offloaded work is
exempt by construction.  A stale boundary entry is itself a finding.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional

from . import Finding, PACKAGE_ROOT, SourceFile, dotted_name
from . import registry
from .asyncflow import (
    is_submit_call,
    own_nodes,
    reachable_map,
    submit_bound_names,
)
from .callgraph import FuncInfo, build as build_graph

RULE = "blocking-in-async"

ANCHOR = "__init__.py"  # package pass: runs once, anchored on the root

_COERCIONS = frozenset({"list", "tuple"})
_COERCION_DOTTED = frozenset(
    {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
)

# stdlib module aliases tolerated in dotted matching (`import time as
# _time` is the package idiom for the sans-io plane)
_ALIAS = {"_time": "time", "_t": "time", "_os": "os", "_subprocess": "subprocess"}


def applies(relpath: str) -> bool:
    return relpath == ANCHOR


def _canonical(dn: str) -> str:
    parts = dn.split(".")
    parts[0] = _ALIAS.get(parts[0], parts[0])
    return ".".join(parts)


def _blocking_reason(call: ast.Call) -> Optional[str]:
    dn = dotted_name(call.func)
    if dn is None:
        return None
    dn = _canonical(dn)
    hit = registry.BLOCKING_CALLS.get(dn)
    if hit is not None:
        return hit
    for suffix, reason in registry.BLOCKING_CALLS.items():
        if "." in suffix and dn.endswith("." + suffix):
            return reason
    return None


def check_root(root: Path, shown_prefix: str) -> List[Finding]:
    graph = build_graph(root)
    findings: List[Finding] = []

    # stale boundary declarations: validated against the real package
    # graph; a fixture root only validates entries naming its own files
    real_root = root.resolve() == PACKAGE_ROOT.resolve()
    for key in registry.EXECUTOR_OFFLOAD_BOUNDARIES:
        if not real_root and key.split("::")[0] not in graph.sources:
            continue
        if key not in graph.functions:
            findings.append(
                Finding(
                    rule=RULE,
                    path=f"{shown_prefix}/lint/registry.py",
                    line=1,
                    message=(
                        f"EXECUTOR_OFFLOAD_BOUNDARIES entry {key!r} names "
                        "a function that no longer exists — remove the "
                        "stale declaration"
                    ),
                )
            )

    reach = reachable_map(
        graph, boundaries=tuple(registry.EXECUTOR_OFFLOAD_BOUNDARIES)
    )
    fetch_points = set(registry.ASYNC_FETCH_POINTS)

    def emit(fi: FuncInfo, node, message: str) -> None:
        findings.append(
            Finding(
                rule=RULE,
                path=f"{shown_prefix}/{fi.relpath}",
                line=getattr(node, "lineno", fi.lineno),
                message=message,
            )
        )

    for qual, roots in sorted(reach.items()):
        fi = graph.functions.get(qual)
        if fi is None:
            continue
        if qual in registry.EXECUTOR_OFFLOAD_BOUNDARIES and not isinstance(
            fi.node, ast.AsyncFunctionDef
        ):
            continue  # the declared boundary body is the offload site
        root_name = sorted(roots)[0].split("::", 1)[-1]
        fetch_ok = f"{fi.relpath}::{fi.name}" in fetch_points
        submit_names = submit_bound_names(fi.node)
        for node in own_nodes(fi.node):
            if not isinstance(node, ast.Call):
                continue
            reason = _blocking_reason(node)
            if reason is not None:
                emit(
                    fi,
                    node,
                    f"{_canonical(dotted_name(node.func) or '?')}() "
                    f"({reason}) in {fi.name!r} runs on the event loop "
                    f"(reachable from coroutine {root_name!r}) — offload "
                    "via run_in_executor or declare the boundary in "
                    "lint/registry.py:EXECUTOR_OFFLOAD_BOUNDARIES",
                )
                continue
            if fetch_ok:
                continue

            def is_future(expr: ast.AST) -> bool:
                return is_submit_call(expr) or (
                    isinstance(expr, ast.Name) and expr.id in submit_names
                )

            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "result"
                and is_future(node.func.value)
            ):
                emit(
                    fi,
                    node,
                    f".result() on a submit_* future in {fi.name!r} "
                    f"blocks the event loop (reachable from coroutine "
                    f"{root_name!r}) until the device settles — hold the "
                    "future across host work and settle at a registered "
                    "fetch point (registry.ASYNC_FETCH_POINTS)",
                )
                continue
            dn = dotted_name(node.func)
            if (
                (dn in _COERCIONS or dn in _COERCION_DOTTED)
                and node.args
                and is_future(node.args[0])
            ):
                emit(
                    fi,
                    node,
                    f"{dn}() materializes a submit_* future in "
                    f"{fi.name!r} on the event loop (reachable from "
                    f"coroutine {root_name!r}) — a future is not data; "
                    "settle at a registered fetch point",
                )
    findings.sort(key=lambda f: (f.path, f.line))
    return findings


def check(sf: SourceFile) -> List[Finding]:
    root = sf.path.parent if sf.relpath == ANCHOR else PACKAGE_ROOT
    return check_root(root, PACKAGE_ROOT.name)
