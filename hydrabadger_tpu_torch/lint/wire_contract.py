"""Rule ``wire-exhaustive``: every wire kind declared, built, dispatched.

Contract (net/wire.py module docstring): the wire surface is the closed
set ``KINDS``.  A kind that is declared but never constructed is dead
protocol surface; a kind that is constructed but not dispatched in
``net/node.py`` / ``net/peer.py`` is a frame every peer silently drops
— in an HBBFT deployment that is indistinguishable from a Byzantine
link and can stall an epoch forever.

Static checks (cross-file, anchored on ``net/wire.py``):

  * every ``WireMessage("<kind>", ...)`` construction in the network
    plane uses a declared kind;
  * every declared kind is constructed somewhere in ``net/``;
  * every declared kind has a dispatch arm (an ``elif kind == ...`` /
    membership test) in ``net/node.py`` or ``net/peer.py``;
  * ``VERIFIED_KINDS`` is a subset of ``KINDS``.

The decode side is generic (utils/codec.py is self-describing), so
decode-arm coverage is pinned at runtime instead: the paired property
test (tests/test_torch_lint.py) round-trips one representative message per
kind from :func:`sample_messages`, which re-extracts ``KINDS`` through
this module — the rule and the test cannot drift apart.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, FrozenSet, List, Optional, Tuple

from . import Finding, PACKAGE_ROOT, SourceFile, dotted_name

RULE = "wire-exhaustive"

WIRE_RELPATH = "net/wire.py"


def applies(relpath: str) -> bool:
    return relpath == WIRE_RELPATH


# -- extraction helpers ------------------------------------------------------


def _set_literal(name: str, tree: ast.AST) -> FrozenSet[str]:
    """Extract ``NAME = frozenset({"a", ...})`` string members."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        if not any(
            isinstance(t, ast.Name) and t.id == name for t in node.targets
        ):
            continue
        kinds = set()
        for sub in ast.walk(node.value):
            if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                kinds.add(sub.value)
        return frozenset(kinds)
    return frozenset()


def constructed_kinds(net_dir: Optional[Path] = None) -> Dict[str, List[Tuple[str, int]]]:
    """kind -> [(file, line)] for every ``WireMessage("<kind>", ...)``."""
    net = net_dir or (PACKAGE_ROOT / "net")
    sites: Dict[str, List[Tuple[str, int]]] = {}
    for path in sorted(net.glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = dotted_name(node.func) or ""
            if fn.rsplit(".", 1)[-1] != "WireMessage":
                continue
            if node.args and isinstance(node.args[0], ast.Constant) and (
                isinstance(node.args[0].value, str)
            ):
                sites.setdefault(node.args[0].value, []).append(
                    (path.name, node.lineno)
                )
    return sites


def dispatched_kinds(net_dir: Optional[Path] = None) -> FrozenSet[str]:
    """String constants compared against a ``kind`` value in node/peer.

    Scoped to functions that actually read a ``.kind`` attribute (the
    wire-dispatch handlers): the node's internal-queue dispatcher also
    compares a variable named ``kind``, and counting its arms would let
    a wire kind that collides with an internal queue tag pass without a
    real dispatch arm.
    """
    net = net_dir or (PACKAGE_ROOT / "net")
    kinds = set()
    for name in ("node.py", "peer.py"):
        path = net / name
        if not path.exists():
            continue
        tree = ast.parse(path.read_text())
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not any(
                isinstance(sub, ast.Attribute) and sub.attr == "kind"
                for sub in ast.walk(fn)
            ):
                continue  # never touches a wire message's .kind
            for node in ast.walk(fn):
                if not isinstance(node, ast.Compare):
                    continue
                sides = [node.left] + list(node.comparators)
                if not any(
                    (isinstance(s, ast.Name) and s.id == "kind")
                    or (isinstance(s, ast.Attribute) and s.attr == "kind")
                    for s in sides
                ):
                    continue
                for s in sides:
                    for sub in ast.walk(s):
                        if isinstance(sub, ast.Constant) and isinstance(
                            sub.value, str
                        ):
                            kinds.add(sub.value)
    return frozenset(kinds)


def sample_messages(wire_module=None):
    """One representative, codec-round-trippable message per kind.

    Used by tests/test_torch_lint.py; raises if the samples and the declared
    ``KINDS`` drift apart, so a new wire kind cannot ship without a
    round-trip pin.
    """
    if wire_module is None:
        from ..net import wire as wire_module
    uid = b"\x42" * 16
    pk = b"\x03" * 48
    net_state = ("awaiting_more_peers", ((uid, "127.0.0.1", 1, pk),))
    samples = {
        "hello_request_change_add": (uid, "127.0.0.1", 24680, pk),
        "welcome_received_change_add": (uid, "127.0.0.1", 24680, pk, net_state),
        "hello_from_validator": (uid, "::1", 24681, pk, net_state),
        "goodbye": (uid,),
        "message": (uid, ("hb", 0, ("cs", 1, ("bc_echo", b"proof")))),
        "key_gen": (uid, ("builtin",), ("part", b"commit", (b"row0", b"row1"))),
        "join_plan": (3, 17, (uid,), {uid: pk}, b"pkset", b"session"),
        "era_transcript_request": 3,
        "era_transcript": (3, 2, ((uid, ("part", b"c", (b"r",))),)),
        "net_state_request": None,
        "net_state": net_state,
        "transaction": b"\x00txn-bytes\xff",
        "ping": None,
        "pong": None,
    }
    declared = frozenset(wire_module.KINDS)
    missing = declared - samples.keys()
    extra = samples.keys() - declared
    if missing or extra:
        raise AssertionError(
            f"wire samples drifted: missing={sorted(missing)} "
            f"extra={sorted(extra)} — update lint/wire_contract.py"
        )
    out = [wire_module.WireMessage(k, samples[k]) for k in sorted(declared)]
    # RBC leaf variants ride INSIDE the "message" kind, so kind-level
    # coverage alone would never round-trip their payload shapes; one
    # enveloped sample per leaf keeps every broadcast dialect (Merkle
    # bracha AND the low-comm variant) in the decode pin and
    # the malformed-truncation corpus below
    out.extend(rbc_leaf_samples(wire_module))
    return out


def rbc_leaf_samples(wire_module=None):
    """One codec-round-trippable ``"message"`` envelope per RBC leaf
    kind (consensus/broadcast.py), both variants.  Raises on drift from
    the broadcast module's declared kinds, mirroring sample_messages'
    contract with wire.KINDS."""
    if wire_module is None:
        from ..net import wire as wire_module
    from ..consensus import broadcast as bc

    uid = b"\x42" * 16
    proof_wire = (b"shard-bytes", 1, (b"\x01" * 32, b"\x02" * 32), b"\x03" * 32)
    leaves = {
        bc.MSG_VALUE: proof_wire,
        bc.MSG_ECHO: proof_wire,
        bc.MSG_READY: b"\x03" * 32,
        bc.MSG_VALUE_LC: (b"\x04" * 32, b"\x05" * 32, b"shard-bytes"),
        bc.MSG_ECHO_LC: (b"\x06" * 32, b"shard-bytes"),
        bc.MSG_READY_LC: b"\x06" * 32,
    }
    declared = {
        v
        for k, v in vars(bc).items()
        if k.startswith("MSG_") and isinstance(v, str)
    }
    if declared != set(leaves):
        raise AssertionError(
            f"RBC leaf samples drifted: missing={sorted(declared - set(leaves))} "
            f"extra={sorted(set(leaves) - declared)} — update "
            "lint/wire_contract.rbc_leaf_samples"
        )
    return [
        wire_module.WireMessage(
            "message", (uid, ("hb", 0, ("cs", 1, (kind, leaves[kind]))))
        )
        for kind in sorted(leaves)
    ]


def _uvarint(n: int) -> bytes:
    # thin wrapper over the REAL wire encoder so forged counts can never
    # drift from the encoding decode actually parses
    from ..utils.codec import _write_uvarint

    out = bytearray()
    _write_uvarint(out, n)
    return bytes(out)


def malformed_samples(wire_module=None):
    """The adversarial twin of :func:`sample_messages`: a corpus of
    malformed frame bodies, every one of which ``WireMessage.decode``
    must reject with ValueError — never any other exception type
    (the read loops' fault path catches exactly that; anything else
    escapes and kills the task, a remote-triggered crash).

    Derived from the honest corpus so it tracks KINDS automatically:
    truncations of every variant, forged list/dict element counts
    (including a count spliced over a real frame's), unknown and
    non-string kinds, wrong-arity and non-sequence bodies, and a
    nesting bomb.  Returns ``[(label, raw_bytes), ...]``."""
    from ..utils import codec

    samples = sample_messages(wire_module)
    out = []
    for msg in samples:
        raw = msg.encode()
        # truncated payloads: the frame cut at the tag boundary, a
        # quarter of the way in, one byte short, and mid-varint
        for cut in sorted({1, 2, len(raw) // 4, len(raw) // 2, len(raw) - 1}):
            if 0 < cut < len(raw):
                out.append((f"{msg.kind}:cut@{cut}", raw[:cut]))
        # trailing garbage after a complete frame
        out.append((f"{msg.kind}:trailing", raw + b"\x00"))
    # forged collection counts: headers claiming more elements than the
    # remaining bytes could hold, bare and spliced over a real frame
    real = samples[0].encode()
    out += [
        ("forged:list_2^60", b"L" + _uvarint(1 << 60)),
        ("forged:dict_2^60", b"D" + _uvarint(1 << 60)),
        ("forged:list_2^60_with_elems", b"L" + _uvarint(1 << 60) + b"N" * 64),
        ("forged:count_over_frame", b"L" + _uvarint(1 << 32) + real[2:]),
        ("forged:pair_count", b"L" + _uvarint(200) + real[2:]),
    ]
    # RBC-leaf-targeted forgeries: counts spliced over the
    # low-comm echo/value envelopes — the bare-shard bodies are the new
    # hot decode surface — plus a tuple-arity lie inside the leaf
    for msg in rbc_leaf_samples(wire_module):
        raw = msg.encode()
        out += [
            ("rbc:forged_count", b"L" + _uvarint(1 << 40) + raw[2:]),
            ("rbc:count_over_frame", b"L" + _uvarint(240) + raw[2:]),
        ]
    # kind-level malformations
    out += [
        ("kind:unknown", codec.encode(("no_such_kind", None))),
        ("kind:nonstring", codec.encode((42, None))),
        ("kind:bytes", codec.encode((b"message", None))),
        ("body:not_a_pair", codec.encode(None)),
        ("body:int", codec.encode(7)),
        ("body:1tuple", codec.encode(("message",))),
        ("body:3tuple", codec.encode(("message", None, None))),
        ("body:empty", b""),
        ("body:unknown_tag", b"Z"),
        ("body:nesting_bomb", b"L\x01" * 600 + b"N"),
    ]
    return out


# -- the static rule ---------------------------------------------------------


def check(sf: SourceFile) -> List[Finding]:
    out: List[Finding] = []
    net_dir = sf.path.parent
    declared = _set_literal("KINDS", sf.tree)
    verified = _set_literal("VERIFIED_KINDS", sf.tree)
    kinds_line = next(
        (
            n.lineno
            for n in ast.walk(sf.tree)
            if isinstance(n, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == "KINDS"
                for t in n.targets
            )
        ),
        1,
    )
    if not declared:
        out.append(sf.finding(RULE, 1, "no KINDS frozenset declared"))
        return out
    constructed = constructed_kinds(net_dir)
    dispatched = dispatched_kinds(net_dir)
    net_rel = sf.finding(RULE, 1, "").path.rsplit("/", 1)[0]
    for kind, sites in sorted(constructed.items()):
        if kind not in declared:
            fname, line = sites[0]
            out.append(
                Finding(
                    rule=RULE,
                    path=f"{net_rel}/{fname}",
                    line=line,
                    message=f"WireMessage kind {kind!r} is not declared in "
                    "wire.KINDS",
                )
            )
    for kind in sorted(declared - constructed.keys()):
        out.append(
            sf.finding(
                RULE,
                kinds_line,
                f"kind {kind!r} is declared but never constructed in net/ — "
                "dead protocol surface or a missing sender",
            )
        )
    for kind in sorted(declared - dispatched):
        out.append(
            sf.finding(
                RULE,
                kinds_line,
                f"kind {kind!r} has no dispatch arm in net/node.py or "
                "net/peer.py — peers silently drop it",
            )
        )
    for kind in sorted(verified - declared):
        out.append(
            sf.finding(
                RULE,
                kinds_line,
                f"VERIFIED_KINDS entry {kind!r} is not in KINDS",
            )
        )
    return out
