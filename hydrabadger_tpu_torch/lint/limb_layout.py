"""Rule ``limb-layout``: int32 ``[12, B]`` words, named constants only.

Contract (ops/limbs.py): a field element is an int32 word array — 12
little-endian words of 32 bits (``N_LIMBS`` / ``LIMB_BITS``) — and
every kernel plane stays integer end to end.  A float dtype anywhere in
a field plane silently rounds 381-bit arithmetic; a magic
``0xFFFFFFFF`` or ``<< 32`` that drifts from the named constants
corrupts every word it touches if the layout is ever retuned.

Flags, in ``ops/`` modules that reference the limb constants (the
"field planes"):

  * float dtypes (``torch.float32`` & friends, ``np.float64``,
    ``astype(float)``, ``dtype=float``) anywhere in a field plane;
  * the literal ``0xFFFFFFFF`` — derive the word mask from
    ``LIMB_BITS``;
  * shifts by the literal ``32`` — use ``LIMB_BITS``.

The defining assignments in ``ops/limbs.py`` are exempt, and so are
the JAX package's layout constants (``JAX_LIMB_BITS`` /
``JAX_N_LIMBS``), which describe the other package's 12-bit limbs.
The JAX rule's ``ShapeDtypeStruct`` check has no counterpart: the port
declares no kernel outputs through JAX.
"""
from __future__ import annotations

import ast
from typing import List

from . import Finding, SourceFile, dotted_name

RULE = "limb-layout"

_LIMB_CONSTS = ("N_LIMBS", "LIMB_BITS", "LIMB_MASK")
_EXEMPT_NAMES = _LIMB_CONSTS + ("JAX_LIMB_BITS", "JAX_N_LIMBS")
_FLOAT_ATTRS = frozenset({"float32", "float64", "float16", "bfloat16"})
_MASK_VALUE = 0xFFFFFFFF
_BITS_VALUE = 32


def applies(relpath: str) -> bool:
    return relpath.startswith("ops/") and relpath != "ops/__init__.py"


def _is_field_plane(sf: SourceFile) -> bool:
    return any(c in sf.text for c in _LIMB_CONSTS)


def _const_def_lines(sf: SourceFile) -> set:
    """Module-level lines defining the layout constants (exempt)."""
    lines = set()
    for node in sf.tree.body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id in _EXEMPT_NAMES
            for t in node.targets
        ):
            lines.add(node.lineno)
    return lines


def check(sf: SourceFile) -> List[Finding]:
    out: List[Finding] = []
    if not _is_field_plane(sf):
        return out
    exempt = _const_def_lines(sf)
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Attribute):
            if node.attr in _FLOAT_ATTRS and dotted_name(node.value) in (
                "torch", "np", "numpy"
            ):
                out.append(
                    sf.finding(
                        RULE,
                        node,
                        f"float dtype .{node.attr} in a field plane — limb "
                        "arithmetic is int32 end to end",
                    )
                )
        elif isinstance(node, ast.Constant):
            if (
                node.value == _MASK_VALUE
                and not isinstance(node.value, bool)
                and node.lineno not in exempt
            ):
                out.append(
                    sf.finding(
                        RULE,
                        node,
                        "literal 0xFFFFFFFF — derive the word mask from "
                        "LIMB_BITS so the limb width has one source of truth",
                    )
                )
        elif isinstance(node, ast.BinOp):
            if isinstance(node.op, (ast.LShift, ast.RShift)) and (
                isinstance(node.right, ast.Constant)
                and node.right.value == _BITS_VALUE
                and node.lineno not in exempt
            ):
                out.append(
                    sf.finding(
                        RULE,
                        node,
                        "shift by literal 32 — use LIMB_BITS so the limb "
                        "width has one source of truth",
                    )
                )
        elif isinstance(node, ast.Call):
            dn = dotted_name(node.func) or ""
            if dn.rsplit(".", 1)[-1] == "astype":
                for arg in node.args:
                    if isinstance(arg, ast.Name) and arg.id == "float":
                        out.append(
                            sf.finding(
                                RULE,
                                node,
                                "astype(float) in a field plane — limb "
                                "arithmetic is int32 end to end",
                            )
                        )
            for kw in node.keywords:
                if (
                    kw.arg == "dtype"
                    and isinstance(kw.value, ast.Name)
                    and kw.value.id == "float"
                ):
                    out.append(
                        sf.finding(
                            RULE,
                            node,
                            "dtype=float in a field plane — limb "
                            "arithmetic is int32 end to end",
                        )
                    )
    return out
