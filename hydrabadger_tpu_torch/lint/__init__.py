"""hblint for the port — repo-native static analysis of the contracts
hydrabadger_tpu_torch/ shares with the JAX package.

The port's copy of hydrabadger_tpu/lint, run over hydrabadger_tpu_torch/
with a registry of its own (``lint/registry.py``).  The port's code runs
on contracts that exist only as prose, and one silent violation
corrupts consensus safety or the field arithmetic:

  * **sans-io** — consensus cores never touch sockets, clocks or ambient
    randomness (consensus/types.py module docstring); all effects flow
    through Steps and explicit rng arguments.
  * **limb layout** — field elements are int32 ``[12, B]`` word arrays;
    the named constants ``N_LIMBS`` / ``LIMB_BITS`` are used instead of
    magic literals, and no float dtype enters a field plane unaudited.
  * **wire exhaustiveness** — every wire message kind is declared in
    ``net/wire.py:KINDS``, constructed somewhere in the network plane,
    and dispatched in ``net/node.py`` / ``net/peer.py``.  (The decode
    side is generic — ``utils/codec.py`` is self-describing — so decode
    coverage is pinned by a runtime round-trip test of
    :func:`lint.wire_contract.sample_messages`.)
  * **eager-fetch**, **env-flag**, **dead-code** — no inline
    materialization of a ``submit_*`` future outside a registered fetch
    point, no unregistered ``HYDRABADGER_*`` flag, no unused import.

On top of the per-file rules, two INTERPROCEDURAL dataflow passes share
a package-wide call graph (``lint/callgraph.py``) and a policy-driven
abstract interpreter (``lint/dataflow.py``):

  * **attacker-taint** — wire-decoded/router-delivered data must pass a
    registered sanitizer (cap guard, clamp, bounded slice) before
    driving loop bounds or container growth (``lint/taint.py``);
  * **secret-taint** — key material (DKG shares, channel keys, identity
    scalars) must never reach logging, exception strings, ``repr``,
    or serialization unsealed (``lint/secrets.py``).

The hbrace passes: **await-interference** (a read-modify-write of shared
node state straddling a suspension point), **blocking-in-async**
(declared blocking sinks reachable from an ``async def`` outside a
declared executor-offload boundary), **clock-domain** (cross-domain
timestamp arithmetic, skewed time in freshness checks, monotonic stamps
in persisted payloads, raw OS-clock reads bypassing the node seams) and
**task-retention** (no fire-and-forget ``asyncio.create_task``).

The hbstate pass, **state-lifecycle**: every growing container attribute
on a node-lifetime class (``registry.STATE_SCOPE_CLASSES``) carries a
declared lifecycle in ``registry.STATE_LIFECYCLE`` (``per_epoch``,
``per_era``, ``bounded`` or ``process_lifetime``), verified over the
call graph.  Its runtime twin is ``obs/census.py``, which reads the same
table.

The hbquorum passes: **quorum-arith** (every comparison of a count
against a fault-tolerance expression in ``consensus/``/``net/``/``sim/``
is declared in ``registry.QUORUM_SITES`` with a class the arithmetic is
verified against) and **contract-drift** (the fault-observability tiers
``FAULT_OBSERVABLES`` → ``WIRE_`` → ``PROC_`` re-evaluated statically
against the reachable fault emits, every minted metric name declared in
``obs/metrics.py`` and vice versa, every ``BYZ_*`` kind injected and
observed).

Not ported: the JAX package's ``mosaic``, ``jit-hygiene`` and
``retrace-budget`` rules and their runtime twin ``obs/retrace.py``.
They check Pallas/Mosaic lowering constraints, host round-trips inside
``@jax.jit`` regions and jit signature budgets; the port has no Pallas
kernels, no jit regions and no jit entry points.

Run with ``python -m hydrabadger_tpu_torch.lint``; exits nonzero on any
unsuppressed finding and prints ``file:line: rule: message``
diagnostics.  ``--json`` emits a machine-readable report; the port's
checked-in baseline, ``hydrabadger_tpu_torch/lint/baseline.json``,
makes CI fail on NEW findings/suppressions while grandfathered ones stay
auditable (``--write-baseline`` updates it); ``--changed`` is the
git-diff-scoped fast path.

Suppression syntax (per line, justification MANDATORY)::

    expr  # hblint: disable=<rule> -- <why this is sound>

A suppression comment may also stand alone on the line directly above
the flagged statement.  A ``disable=`` without a justification is itself
reported (rule ``suppression``).
"""
from __future__ import annotations

import ast
import re
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PACKAGE_ROOT = Path(__file__).resolve().parents[1]

_SUPPRESS_RE = re.compile(
    r"#\s*hblint:\s*disable=([\w][\w,\s-]*?)\s*(?:--\s*(.*\S))?\s*$"
)


@dataclass(frozen=True)
class Finding:
    """One diagnostic: a contract violation at a specific line."""

    rule: str
    path: str  # repo-relative posix path
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.message}"


class SourceFile:
    """A parsed module plus the path metadata rules scope on."""

    def __init__(self, path: Path, relpath: str, text: str):
        self.path = path
        self.relpath = relpath  # posix path relative to the package root
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=str(path))

    @classmethod
    def load(cls, path: Path, root: Path = PACKAGE_ROOT) -> "SourceFile":
        relpath = path.resolve().relative_to(root.resolve()).as_posix()
        return cls(path, relpath, path.read_text())

    def finding(self, rule: str, node_or_line, message: str) -> Finding:
        line = getattr(node_or_line, "lineno", node_or_line)
        # render paths package-qualified so diagnostics are clickable
        # from the repo root
        shown = (Path(PACKAGE_ROOT.name) / self.relpath).as_posix()
        return Finding(rule=rule, path=shown, line=line, message=message)


def _suppressions(sf: SourceFile) -> Tuple[Dict[int, Dict[str, str]], List[Finding]]:
    """Map line -> {rule: justification}; malformed pragmas are findings."""
    by_line: Dict[int, Dict[str, str]] = {}
    bad: List[Finding] = []
    for i, raw in enumerate(sf.lines, start=1):
        if "hblint" not in raw:
            continue
        m = _SUPPRESS_RE.search(raw)
        if m is None:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        justification = m.group(2)
        if not justification:
            bad.append(
                Finding(
                    rule="suppression",
                    path=(Path(PACKAGE_ROOT.name) / sf.relpath).as_posix(),
                    line=i,
                    message=(
                        "suppression without a justification — write "
                        "`# hblint: disable=<rule> -- <why this is sound>`"
                    ),
                )
            )
            continue
        target = i + 1 if raw.lstrip().startswith("#") else i
        slot = by_line.setdefault(target, {})
        for r in rules:
            slot[r] = justification
    return by_line, bad


def all_rules():
    """The rule registry, in report order."""
    from . import async_fetch, await_interference, blocking_async
    from . import clock_domain, contract_drift, deadcode, env_flags
    from . import limb_layout, quorum
    from . import sansio, secrets, state_lifecycle
    from . import taint, task_retention, wire_contract

    return [
        sansio,
        limb_layout,
        wire_contract,
        async_fetch,
        env_flags,
        taint,
        secrets,
        await_interference,
        blocking_async,
        clock_domain,
        task_retention,
        state_lifecycle,
        quorum,
        contract_drift,
        deadcode,
    ]


def iter_sources(root: Path = PACKAGE_ROOT) -> Iterable[SourceFile]:
    for path in sorted(root.rglob("*.py")):
        yield SourceFile.load(path, root)


def run_full(
    root: Path = PACKAGE_ROOT,
    rules: Optional[Sequence] = None,
    files: Optional[Sequence[Path]] = None,
    timings: Optional[Dict[str, float]] = None,
) -> Tuple[List[Finding], List[Tuple[Finding, str]]]:
    """Run ``rules`` over ``root`` (or explicit ``files``).

    Returns ``(unsuppressed findings, [(suppressed finding,
    justification)])``.  Suppressions are matched package-wide by
    (shown path, line): the dataflow passes emit findings for files
    other than the one they anchor on, and the pragma lives next to the
    flagged statement, wherever that is.

    ``timings``, when given, accumulates per-rule wall seconds (keyed
    by ``RULE``) across all files — the ``--timing`` report source.
    """
    selected = list(rules) if rules is not None else all_rules()
    sources = (
        [SourceFile.load(Path(f), root) for f in files]
        if files is not None
        else list(iter_sources(root))
    )
    findings: List[Finding] = []
    suppressed: List[Tuple[Finding, str]] = []
    # package-wide suppression index keyed by the shown (display) path
    # (always PACKAGE_ROOT.name-prefixed, matching SourceFile.finding)
    index: Dict[str, Dict[int, Dict[str, str]]] = {}
    scan = sources if files is None else list(iter_sources(root))
    selected_paths = {sf.relpath for sf in sources}
    for sf in scan:
        by_line, bad = _suppressions(sf)
        shown = (Path(PACKAGE_ROOT.name) / sf.relpath).as_posix()
        index[shown] = by_line
        if sf.relpath in selected_paths:
            findings.extend(bad)
    raw: List[Finding] = []
    for sf in sources:
        for rule in selected:
            applies = getattr(rule, "applies", None)
            if applies is not None and not applies(sf.relpath):
                continue
            t0 = time.perf_counter()
            raw.extend(rule.check(sf))
            if timings is not None:
                timings[rule.RULE] = (
                    timings.get(rule.RULE, 0.0)
                    + time.perf_counter()
                    - t0
                )
    for f in raw:
        just = index.get(f.path, {}).get(f.line, {}).get(f.rule)
        if just is not None:
            suppressed.append((f, just))
        else:
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    suppressed.sort(key=lambda fj: (fj[0].path, fj[0].line, fj[0].rule))
    return findings, suppressed


def run(
    root: Path = PACKAGE_ROOT,
    rules: Optional[Sequence] = None,
    files: Optional[Sequence[Path]] = None,
) -> Tuple[List[Finding], int]:
    """Compatibility wrapper: ``(findings, suppressed count)``."""
    findings, suppressed = run_full(root, rules, files)
    return findings, len(suppressed)


# -- shared AST helpers ------------------------------------------------------


def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None
