"""CLI runner: ``python -m hydrabadger_tpu_torch.lint [options] [files...]``.

Exits 0 when every finding is suppressed-with-justification or absent;
nonzero otherwise.  Diagnostics are ``file:line: rule: message``.

Baseline workflow (CI): when the port's baseline,
``hydrabadger_tpu_torch/lint/baseline.json``, exists (or ``--baseline
PATH`` is given) the run fails on findings or
suppressions that are NOT in the baseline — new findings must be fixed
and new suppressions must be consciously audited into the baseline via
``--write-baseline``.  Grandfathered entries are reported but pass, so
the debt stays visible without blocking unrelated work.

``--changed`` is the fast pre-commit path: per-file rules run only on
the files ``git diff`` reports (the whole-package dataflow passes run
only if the diff touches the package root or ``lint/`` itself); CI and
``scripts/test-all`` run the full analyzer.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from . import PACKAGE_ROOT, all_rules, run_full

# the port's own baseline; the root lint-baseline.json is the JAX package's
DEFAULT_BASELINE = PACKAGE_ROOT / "lint" / "baseline.json"


def _finding_key(f) -> tuple:
    # line-free so ordinary edits above a grandfathered site don't
    # invalidate the baseline
    return (f.rule, f.path, f.message)


def _suppression_key(f, justification: str) -> tuple:
    return (f.rule, f.path, justification)


def _snapshot(findings, suppressed) -> dict:
    return {
        "findings": [
            {"rule": f.rule, "path": f.path, "message": f.message}
            for f in findings
        ],
        "suppressed": [
            {
                "rule": f.rule,
                "path": f.path,
                "justification": j,
                "message": f.message,
            }
            for f, j in suppressed
        ],
    }


def _changed_files() -> list:
    """Package .py files the git diff (incl. untracked) touches.

    When ANY package file changed, the ``__init__.py`` anchor is added
    so the whole-package dataflow passes (attacker/secret taint,
    await-interference, blocking-in-async, clock-domain,
    state-lifecycle, quorum-arith, contract-drift) run too: they are interprocedural, so an edit
    anywhere can change their verdicts, and they cost seconds.  The
    fast path saved is the per-file rules over the unchanged files."""
    root = PACKAGE_ROOT.parent
    out = set()
    for cmd in (
        ["git", "diff", "--name-only", "HEAD"],
        ["git", "ls-files", "--others", "--exclude-standard"],
    ):
        try:
            res = subprocess.run(
                cmd, capture_output=True, text=True, cwd=root, check=False
            )
        except OSError:
            continue
        for line in res.stdout.splitlines():
            p = root / line.strip()
            if (
                line.strip().startswith(f"{PACKAGE_ROOT.name}/")
                and p.suffix == ".py"
                and p.exists()
            ):
                out.add(p)
    if out:
        out.add(PACKAGE_ROOT / "__init__.py")
    return sorted(out)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m hydrabadger_tpu_torch.lint",
        description="repo-native static analysis of the port: the "
        "per-file contract rules (sans-io, limb-layout, "
        "wire-exhaustiveness, eager-fetch, env-flag, dead-code) plus the "
        "interprocedural dataflow passes (attacker-taint, secret-taint, "
        "hbrace, state-lifecycle, quorum-arith, contract-drift)",
    )
    parser.add_argument(
        "files",
        nargs="*",
        help="specific files to lint (default: the whole package)",
    )
    parser.add_argument(
        "--rule",
        action="append",
        help="run only this rule (repeatable); see --list-rules",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="list rules and exit"
    )
    parser.add_argument(
        "--json",
        action="store_true",
        help="emit findings + suppressions as JSON on stdout",
    )
    parser.add_argument(
        "--baseline",
        metavar="PATH",
        help="compare against a baseline snapshot (default: the port's "
        "hydrabadger_tpu_torch/lint/baseline.json, when present)",
    )
    parser.add_argument(
        "--no-baseline",
        action="store_true",
        help="ignore any baseline file (report raw findings only)",
    )
    parser.add_argument(
        "--write-baseline",
        nargs="?",
        const=str(DEFAULT_BASELINE),
        metavar="PATH",
        help="write the current findings+suppressions as the new "
        "baseline and exit 0",
    )
    parser.add_argument(
        "--changed",
        action="store_true",
        help="fast path: lint only git-changed package files",
    )
    parser.add_argument(
        "--github",
        action="store_true",
        help="emit failing findings as GitHub workflow annotations "
        "(::error file=...,line=...::message) alongside the plain "
        "diagnostics",
    )
    parser.add_argument(
        "--timing",
        action="store_true",
        help="report per-pass wall time and fail if the total exceeds "
        "the CI budget (registry.LINT_TIME_BUDGET_S)",
    )
    parser.add_argument(
        "-q", "--quiet", action="store_true", help="suppress the summary line"
    )
    args = parser.parse_args(argv)

    rules = all_rules()
    if args.list_rules:
        for rule in rules:
            doc = (rule.__doc__ or "").strip().splitlines()[0]
            print(f"{rule.RULE:18s} {doc}")
        return 0
    if args.rule:
        known = {r.RULE: r for r in rules}
        unknown = [r for r in args.rule if r not in known]
        if unknown:
            print(f"unknown rule(s): {', '.join(unknown)}", file=sys.stderr)
            return 2
        rules = [known[r] for r in args.rule]

    files = [Path(f) for f in args.files] or None
    if args.changed and files is None:
        files = _changed_files()
        if not files:
            if not args.quiet:
                print("hblint: no changed package files")
            return 0

    timings = {} if args.timing else None
    findings, suppressed = run_full(rules=rules, files=files, timings=timings)

    if args.write_baseline is not None:
        if files is not None:
            # a file-scoped run sees only a slice of the findings; writing
            # it would silently drop every other file's grandfathered
            # entries and break the next full CI run
            print(
                "hblint: refusing to write a baseline from a file-scoped "
                "run — drop --changed / file arguments first",
                file=sys.stderr,
            )
            return 2
        snap = _snapshot(findings, suppressed)
        Path(args.write_baseline).write_text(
            json.dumps(snap, indent=2, sort_keys=True) + "\n"
        )
        if not args.quiet:
            print(
                f"hblint: baseline written to {args.write_baseline} "
                f"({len(findings)} findings, {len(suppressed)} suppressions)"
            )
        return 0

    baseline = None
    baseline_path = args.baseline or (
        DEFAULT_BASELINE if DEFAULT_BASELINE.exists() else None
    )
    # applied in every mode (incl. --changed / explicit files):
    # matching is (rule, path, message)-keyed, so a file-scoped run
    # grandfathers exactly what full CI grandfathers
    if baseline_path is not None and not args.no_baseline:
        try:
            baseline = json.loads(Path(baseline_path).read_text())
        except (OSError, ValueError) as e:
            print(f"hblint: unreadable baseline {baseline_path}: {e}",
                  file=sys.stderr)
            return 2

    new_suppressions = []
    grandfathered = []
    fail_findings = findings
    if baseline is not None:
        known_f = {
            (e["rule"], e["path"], e["message"])
            for e in baseline.get("findings", [])
        }
        known_s = {
            (e["rule"], e["path"], e["justification"])
            for e in baseline.get("suppressed", [])
        }
        grandfathered = [f for f in findings if _finding_key(f) in known_f]
        fail_findings = [f for f in findings if _finding_key(f) not in known_f]
        new_suppressions = [
            (f, j)
            for f, j in suppressed
            if _suppression_key(f, j) not in known_s
        ]

    if args.json:
        snap = _snapshot(fail_findings, suppressed)
        snap["grandfathered"] = [
            {"rule": f.rule, "path": f.path, "message": f.message}
            for f in grandfathered
        ]
        snap["new_suppressions"] = [
            {"rule": f.rule, "path": f.path, "justification": j}
            for f, j in new_suppressions
        ]
        print(json.dumps(snap, indent=2, sort_keys=True))
    else:
        for f in fail_findings:
            print(f.render())
            if args.github:
                # workflow-annotation format: one ::error per failing
                # finding; GitHub renders it inline on the PR diff
                msg = f"{f.rule}: {f.message}".replace("\n", " ")
                print(
                    f"::error file={f.path},line={f.line},"
                    f"title=hblint {f.rule}::{msg}"
                )
        for f in grandfathered:
            print(f"{f.render()}  [grandfathered]")
        for f, j in new_suppressions:
            print(
                f"{f.path}:{f.line}: {f.rule}: NEW suppression "
                f"({j!r}) — audit it, then `--write-baseline`"
            )
            if args.github:
                print(
                    f"::error file={f.path},line={f.line},"
                    f"title=hblint new suppression::{f.rule}: "
                    f"unaudited suppression ({j})"
                )
    if not args.quiet and not args.json:
        noun = "finding" if len(fail_findings) == 1 else "findings"
        extra = (
            f", {len(grandfathered)} grandfathered" if grandfathered else ""
        )
        print(
            f"hblint: {len(fail_findings)} {noun} "
            f"({len(suppressed)} suppressed with justification{extra}) "
            f"across {len(rules)} rule(s) in {PACKAGE_ROOT.name}/"
        )
    over_budget = False
    if timings is not None:
        from . import registry

        total = sum(timings.values())
        budget = registry.LINT_TIME_BUDGET_S
        out = sys.stdout if not args.json else sys.stderr
        print("hblint --timing: per-pass wall time", file=out)
        for rule_name, secs in sorted(
            timings.items(), key=lambda kv: -kv[1]
        ):
            print(f"  {rule_name:20s} {secs:7.2f}s", file=out)
        print(
            f"  {'TOTAL':20s} {total:7.2f}s  (budget {budget:.0f}s)",
            file=out,
        )
        if total > budget:
            over_budget = True
            print(
                f"hblint: TIME BUDGET EXCEEDED — {total:.1f}s > "
                f"{budget:.0f}s (registry.LINT_TIME_BUDGET_S); profile "
                "the slowest pass above before raising the budget",
                file=sys.stderr,
            )
    return 1 if (fail_findings or new_suppressions or over_budget) else 0


if __name__ == "__main__":
    raise SystemExit(main())
