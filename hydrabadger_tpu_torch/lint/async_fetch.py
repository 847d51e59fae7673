"""Rule ``eager-fetch``: submit_* results materialize only at
registered fetch points.

The hbasync plane (crypto/futures) works because consumers hold a
submitted batch's CryptoFuture across host work and fetch it at a
designed settle boundary.  Eagerly materializing the result at the
submission site — ``fut.result()`` inline, or forcing the future
object through ``np.asarray``/``list()``/``tuple()``/``.item()`` —
re-synchronizes the dispatch: the code still *reads* async but the
overlap is silently gone (or worse, the coercion treats the future
object itself as data).  One such regression undoes the architecture
every scaling PR builds on, so the boundary is machine-checked.

Scope: ``crypto/dkg.py``, ``crypto/threshold.py`` and ``consensus/``
— the protocol planes that consume engine results.  (The plane's own
implementation, crypto/futures.py and crypto/engine.py, is out of
scope by construction: it IS the fetch machinery.)

Flags, per function:

* ``X.result()`` where ``X`` is a name bound from a ``*_submit(...)``
  / ``submit_*(...)`` call — or that call expression directly — inside
  any function NOT registered in
  ``lint/registry.py:ASYNC_FETCH_POINTS`` ("relpath::function");
* ``np.asarray(X)`` / ``np.array(X)`` / ``list(X)`` / ``tuple(X)`` /
  ``X.item()`` on such a name anywhere in scope — a future is not
  data; materialize through ``result()`` at a fetch point instead.

Suppressions need a justification naming why the inline fetch cannot
overlap anything (``# hblint: disable=eager-fetch -- <why>``).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set

from . import Finding, SourceFile, dotted_name
from . import registry

RULE = "eager-fetch"

_COERCIONS = frozenset({"list", "tuple"})
_COERCION_DOTTED = frozenset(
    {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
)


def applies(relpath: str) -> bool:
    return relpath in ("crypto/dkg.py", "crypto/threshold.py") or (
        relpath.startswith("consensus/")
    )


def _is_submit_call(node: ast.AST) -> bool:
    """A call whose target name marks a future-returning entry point:
    the last dotted component ends with ``_submit`` or starts with
    ``submit_`` (``engine.submit_g1_msm_batch``, ``handle_parts_submit``,
    ``g1_msm_batch_submit``...)."""
    if not isinstance(node, ast.Call):
        return False
    dn = dotted_name(node.func)
    if dn is None:
        return False
    last = dn.rsplit(".", 1)[-1]
    return last.endswith("_submit") or last.startswith("submit_")


def _functions(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def check(sf: SourceFile) -> List[Finding]:
    out: List[Finding] = []
    fetch_points: Set[str] = set()
    for key in registry.ASYNC_FETCH_POINTS:
        relpath, _, fn = key.partition("::")
        if relpath == sf.relpath:
            fetch_points.add(fn)

    # map every node to its INNERMOST enclosing function (closures like
    # the settle() fetch boundaries must be judged by their own name,
    # not the submitter that defines them)
    owner: Dict[int, str] = {}

    def paint(fn_node, name: str) -> None:
        for child in ast.walk(fn_node):
            owner[id(child)] = name

    for fn_node in _functions(sf.tree):
        paint(fn_node, fn_node.name)  # inner defs repaint their bodies

    # future-tainted names, per enclosing function: x = ..._submit(...)
    tainted: Set[tuple] = set()  # (function name, variable name)
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Assign) and _is_submit_call(node.value):
            fn = owner.get(id(node), "<module>")
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    tainted.add((fn, tgt.id))

    def is_future_expr(node: ast.AST, fn: str) -> bool:
        if _is_submit_call(node):
            return True
        return isinstance(node, ast.Name) and (fn, node.id) in tainted

    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = owner.get(id(node), "<module>")
        # X.result() outside a registered fetch point
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "result"
            and is_future_expr(node.func.value, fn)
            and fn not in fetch_points
        ):
            out.append(
                sf.finding(
                    RULE,
                    node,
                    f".result() in {fn!r} is not a registered fetch "
                    "point — materializing at the submission site "
                    "re-synchronizes the dispatch (register in "
                    "lint/registry.py:ASYNC_FETCH_POINTS or settle at "
                    "a designed boundary)",
                )
            )
            continue
        # coercing the future object itself: np.asarray / list / tuple
        dn = dotted_name(node.func)
        if (
            (dn in _COERCIONS or dn in _COERCION_DOTTED)
            and node.args
            and is_future_expr(node.args[0], fn)
        ):
            out.append(
                sf.finding(
                    RULE,
                    node,
                    f"{dn}() on a submit_* result in {fn!r} — a "
                    "CryptoFuture is not data; fetch through .result() "
                    "at a registered fetch point",
                )
            )
        elif (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "item"
            and is_future_expr(node.func.value, fn)
        ):
            out.append(
                sf.finding(
                    RULE,
                    node,
                    f".item() on a submit_* result in {fn!r} — a "
                    "CryptoFuture is not data; fetch through .result() "
                    "at a registered fetch point",
                )
            )
    return out
