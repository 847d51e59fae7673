"""The port's static contract analyzer (hydrabadger_tpu_torch/lint) against
the JAX package's (hydrabadger_tpu/lint): tests/test_lint.py's cases for the
15 ported rules, on the port.

  * the port's package is clean: zero unsuppressed findings in process, and
    the CLI exits 0 against the port's own baseline (the full analyzer runs
    once per module, in the `full_run` fixture);
  * every known-bad fixture of tests/test_lint.py for a ported rule fires in
    the port's analyzer, and each shared fixture, written to tmp_path, gives
    the same (rule, relpath, line, message) through the JAX rule and the
    port's rule, with both registries monkeypatched alike;
  * mutations of copies of the port's own modules (the Subset's n-f gate,
    LatencySketch.merge's cap, a declared metric, a wire dispatch arm) fire
    quorum-arith, state-lifecycle, contract-drift and wire-exhaustive;
  * the port's registry keeps every JAX entry whose code the port has, and
    its sample_messages() round-trip through the port's codec with bytes
    equal to JAX's.
"""
import ast
import importlib
import shutil
import textwrap
from pathlib import Path

import pytest

import hydrabadger_tpu.lint as jlint
from hydrabadger_tpu.lint import registry as jregistry
from hydrabadger_tpu_torch import lint
from hydrabadger_tpu_torch.lint import (
    PACKAGE_ROOT,
    SourceFile,
    async_fetch,
    await_interference,
    blocking_async,
    callgraph,
    clock_domain,
    contract_drift,
    deadcode,
    env_flags,
    limb_layout,
    quorum,
    registry,
    sansio,
    secrets,
    state_lifecycle,
    taint,
    task_retention,
    wire_contract,
)
from hydrabadger_tpu_torch.lint.asyncflow import reachable_map

PORTED_RULES = (
    "sans-io", "limb-layout", "wire-exhaustive", "eager-fetch", "env-flag",
    "attacker-taint", "secret-taint", "await-interference",
    "blocking-in-async", "clock-domain", "task-retention", "state-lifecycle",
    "quorum-arith", "contract-drift", "dead-code",
)


@pytest.fixture(scope="module")
def full_run():
    """One run of the whole analyzer over the port's package, shared by every
    test of this module that reads the real tree."""
    return lint.run_full()


def _strip(path: str) -> str:
    for prefix in ("hydrabadger_tpu_torch/", "hydrabadger_tpu/"):
        if path.startswith(prefix):
            return path[len(prefix):]
    return path


def _norm(findings) -> list:
    return sorted((f.rule, _strip(f.path), f.line, f.message) for f in findings)


# -- the repo-wide gate ------------------------------------------------------


def test_package_has_zero_findings(full_run):
    findings, suppressed = full_run
    assert not findings, "hblint findings:\n" + "\n".join(f.render() for f in findings)
    assert all(f.path.startswith("hydrabadger_tpu_torch/") for f, _ in suppressed)
    assert all(j.strip() for _, j in suppressed)


def test_cli_exits_zero_on_clean_repo(full_run, monkeypatch, capsys):
    """The CLI over the port's baseline: every suppression is audited in
    hydrabadger_tpu_torch/lint/baseline.json, so the exit is 0.  The analysis
    itself is the module's one full run."""
    from hydrabadger_tpu_torch.lint import __main__ as cli

    assert cli.DEFAULT_BASELINE == PACKAGE_ROOT / "lint" / "baseline.json"
    assert cli.DEFAULT_BASELINE.exists()
    monkeypatch.setattr(cli, "run_full", lambda **kw: full_run)
    assert cli.main(["-q"]) == 0
    assert cli.main(["--json"]) == 0
    assert "NEW suppression" not in capsys.readouterr().out


def test_baseline_lists_every_suppression_with_jax_audits(full_run):
    """The port's baseline holds exactly this run's suppressions, among them
    the JAX package's six audited ones with JAX's justification text."""
    import json

    findings, suppressed = full_run
    base = json.loads((PACKAGE_ROOT / "lint" / "baseline.json").read_text())
    assert base["findings"] == []
    ours = {(e["rule"], e["path"], e["justification"]) for e in base["suppressed"]}
    assert ours == {(f.rule, f.path, j) for f, j in suppressed}
    theirs = json.loads((PACKAGE_ROOT.parent / "lint-baseline.json").read_text())
    assert len(theirs["suppressed"]) == 6
    for e in theirs["suppressed"]:
        assert (e["rule"], "hydrabadger_tpu_torch/" + _strip(e["path"]),
                e["justification"]) in ours, e


def test_lint_package_imports_only_the_standard_library():
    """The port's analyzer keeps its own copies: no module of it imports the
    JAX package (not even its JAX-free lint modules), jax, torch or numpy."""
    banned = ("hydrabadger_tpu", "jax", "torch", "numpy", "triton")
    for path in sorted((PACKAGE_ROOT / "lint").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(roots) & set(banned), (path.name, roots)
    rules = {r.RULE for r in lint.all_rules()}
    assert rules == set(PORTED_RULES)
    assert lint.PACKAGE_ROOT.name == "hydrabadger_tpu_torch"


# -- shared fixtures: each through the JAX rule and the port's rule ----------
#
# A case is tests/test_lint.py's fixture for one rule: the files it writes
# (one file at `relpath` in the make_sf style, or a package in the make_pkg
# style, handed to the rule through its `anchor` file) and its steps, each a set of registry patches applied alike to both
# registries and a check of the port's findings.  `jax_only` marks findings
# of the JAX rule that belong to a part the port does not have (the jit-entry
# sink of attacker-taint); they are left out of the parity comparison.


class Case:
    def __init__(self, rule, files, steps, relpath=None, anchor="__init__.py", jax_only=None):
        self.rule = rule
        self.files = files
        self.steps = steps
        self.relpath = relpath
        self.anchor = anchor  # the package file the rule is handed
        self.jax_only = jax_only or (lambda f: False)


def _write(case, root: Path, pkg):
    """The fixture's SourceFile for `pkg` (either lint package)."""
    if case.relpath is not None:
        text = textwrap.dedent(case.files)
        path = root / Path(case.relpath).name
        path.write_text(text)
        return pkg.SourceFile(path, case.relpath, text)
    for relpath, code in case.files.items():
        p = root / relpath
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(code))
    init = root / "__init__.py"
    if not init.exists():
        init.write_text("")
    return pkg.SourceFile.load(root / case.anchor, root)


def _msgs(findings):
    return [f.message for f in findings]


def _renders(findings):
    return [f.render() for f in findings]


def _check_sansio(fs):
    messages = _msgs(fs)
    assert any("'time'" in m for m in messages)
    assert any("'random'" in m for m in messages)
    assert any("__setattr__" in m for m in messages)
    assert any("NumPy RNG" in m for m in messages)
    assert any("open()" in m for m in messages)


def _check_wire(fs):
    messages = _msgs(fs)
    assert any("'undeclared'" in m and "not declared" in m for m in messages)
    assert any("'bye'" in m and "never constructed" in m for m in messages)
    assert any("'bye'" in m and "no dispatch arm" in m for m in messages)
    assert any("'ghost'" in m for m in messages)
    assert not any("'hello'" in m for m in messages)


def _check_deadcode(fs):
    messages = _msgs(fs)
    assert any("'hashlib'" in m for m in messages)
    assert not any("'sys'" in m for m in messages)


def _check_eager(fs):
    messages = _msgs(fs)
    assert sum("not a registered fetch point" in m for m in messages) == 2
    assert any("np.asarray" in m for m in messages)
    assert any("list()" in m for m in messages)
    assert any(".item()" in m for m in messages)


def _check_one_eager(fs):
    assert [f.rule for f in fs] == ["eager-fetch"], _renders(fs)


def _check_env(fs):
    assert {f.message.split("'")[1] for f in fs} == {
        "HYDRABADGER_BOGUS_FLAG", "HYDRABADGER_ANOTHER_ROGUE", "HYDRABADGER_SUBSCRIPT_ROGUE",
    }


def _check_taint_bad(fs):
    messages = _renders(fs)
    assert any("unbounded growth of self.frames" in m for m in messages)
    assert any("tainted loop bound" in m for m in messages)
    assert any("tainted repetition count" in m for m in messages)
    assert not any("jit entrypoint" in m for m in messages)  # no jit sink in the port


def _check_secret_bad(fs):
    messages = _renders(fs)
    assert any("reaches logging" in m for m in messages)
    assert any("print() renders key material" in m for m in messages)
    assert any("interpolated into an exception" in m for m in messages)
    assert any("no redacting __repr__" in m for m in messages)


def _clean(fs):
    assert _renders(fs) == []


def _one_guard_flag(fs):
    assert len([m for m in _renders(fs) if "tainted loop bound" in m]) == 1, _renders(fs)


def _check_scenario_taint(fs):
    messages = _renders(fs)
    assert any("unbounded growth of self.seen" in m for m in messages)
    assert any("tainted loop bound" in m for m in messages)
    assert any("unbounded growth of self.history" in m for m in messages)


def _check_await_bad(fs):
    messages = _renders(fs)
    assert len(messages) == 1, messages
    assert "read-modify-write of self.frontier" in messages[0]
    assert "on_frame" in messages[0]


def _any(*subs):
    def check(fs):
        messages = _renders(fs)
        for sub in subs:
            assert any(all(s in m for s in (sub if isinstance(sub, tuple) else (sub,)))
                       for m in messages), (sub, messages)
    return check


def _check_blocking_bad(fs):
    messages = _renders(fs)
    assert any("time.sleep()" in m and "'slow_helper'" in m for m in messages), messages
    assert any("open()" in m and "'snapshot'" in m for m in messages)
    assert any(".result() on a submit_* future" in m for m in messages)


def _check_clock_mixed(fs):
    messages = _renders(fs)
    assert len(messages) == 1, messages
    assert "mixes clock domains 'wall' and 'mono'" in messages[0]


def _check_clock_bypass(fs):
    messages = _renders(fs)
    assert len(messages) == 2, messages
    assert all("net/badclock.py" in m for m in messages)
    assert all("bypasses the node clock seams" in m for m in messages)
    assert any("loop.time" in m for m in messages)


def _check_tasks(fs):
    messages = _msgs(fs)
    assert len(messages) == 2, messages
    assert any("fire-and-forget create_task" in m for m in messages)
    assert any("task handle 't'" in m for m in messages)
    assert not any("'kept'" in m for m in messages)


def _state_tables(scope=(), lifecycle=None, era_anchors=(), epoch_anchors=()):
    return {
        "STATE_SCOPE_CLASSES": tuple(scope),
        "STATE_LIFECYCLE": dict(lifecycle or {}),
        "ERA_FLIP_ANCHORS": tuple(era_anchors),
        "EPOCH_COMMIT_ANCHORS": tuple(epoch_anchors),
    }


_ERA_CORE = """\
    class Core:
        def __init__(self):
            self.votes = {}

        def handle_vote(self, sender, v):
            self.votes[sender] = v

        def _switch_era(self):
            %s
    """

_CAP_NODE = """\
    class Node:
        def __init__(self):
            self.log = %s

        def note(self, %s):
            %s
    """


def _check_misclassified(fs):
    _any(("contradicts its declared class", "'intersection'"))(fs)
    assert not any("commit_ready" in m for m in _msgs(fs)), _msgs(fs)


def _quorum(sites):
    return {"QUORUM_SITES": dict(sites)}


_DRIFT_FILES = {
    "taxonomy.py": """\
        BYZ_SILENCE = "silence"
        """,
    "metrics.py": """\
        FAULTS_SEEN = "faults_seen"
        QUEUE_DEPTH = "queue_depth"
        """,
}

_DRIFT_GREEN = """\
    from .metrics import FAULTS_SEEN, QUEUE_DEPTH
    from .taxonomy import BYZ_SILENCE

    class SilenceAttack:
        kind = BYZ_SILENCE

    def run(recorder, metrics):
        recorder.fault("node0", "silence: peer went quiet")
        metrics.counter(FAULTS_SEEN).inc()
        metrics.gauge(QUEUE_DEPTH).track(0)

    FAULT_OBSERVABLES = {
        BYZ_SILENCE: ObsSpec(
            fault_any=("silence: peer went quiet",),
            counters=(FAULTS_SEEN,),
        ),
    }
    """

_DRIFT_TABLES = {
    "CONTRACT_TIERS": (("scenario.py", "FAULT_OBSERVABLES"),),
    "CONTRACT_METRICS_MODULE": "metrics.py",
    "CONTRACT_TAXONOMY_MODULE": "taxonomy.py",
    "CONTRACT_SHARED_SUBSTRINGS": {},
    "METRIC_MINT_WRAPPERS": {},
    "METRIC_DYNAMIC_MINTS": {},
}


def _drift(scenario):
    return dict(_DRIFT_FILES, **{"scenario.py": scenario})


CASES = {
    # -- per-file rules
    "sansio_known_bad": Case("sansio", """\
        import time
        from random import random
        import numpy as np

        def tick(self):
            object.__setattr__(self.msg, "round", 1)
            return np.random.rand(), open("/tmp/x")
        """, [({}, _check_sansio)], relpath="consensus/bad.py"),
    "limb_layout_float_dtype_args": Case("limb_layout", """\
        from .limbs import N_LIMBS

        def f(x):
            a = x.astype(float)
            b = zeros((N_LIMBS, 4), dtype=float)
            return a, b
        """, [({}, _any("astype(float)", "dtype=float"))], relpath="ops/bad_plane.py"),
    "limb_layout_exempts_defining_assignments": Case("limb_layout", """\
        LIMB_BITS = 12
        N_LIMBS = 32
        LIMB_MASK = 4095
        """, [({}, _clean)], relpath="ops/consts.py"),
    "wire_exhaustive_known_bad": Case("wire_contract", {
        "net/wire.py": """\
            KINDS = frozenset({"hello", "data", "bye"})
            VERIFIED_KINDS = frozenset({"ghost"})
            """,
        "net/node.py": """\
            def handle(msg, peer):
                kind = msg.kind
                if kind == "hello":
                    peer.send(WireMessage("hello", None))
                elif kind == "data":
                    peer.send(WireMessage("undeclared", None))

            def internal_dispatch(item, peer):
                kind = item[0]
                if kind == "bye":
                    pass  # internal queue tag, NOT a wire dispatch arm
            """,
    }, [({}, _check_wire)], anchor="net/wire.py"),
    "deadcode_known_bad": Case("deadcode", """\
        import sys
        import hashlib

        def main():
            return sys.argv
        """, [({}, _check_deadcode)], relpath="utils/bad.py"),
    "eager_fetch_known_bad": Case("async_fetch", """\
        import numpy as np

        def flush(self, engine, jobs):
            fut = engine.submit_g1_msm_batch(jobs)
            points = fut.result()  # inline fetch: overlap thrown away
            arr = np.asarray(fut)
            items = list(fut)
            one = fut.item()
            direct = g1_msm_batch_submit(jobs).result()
            return points, arr, items, one, direct
        """, [({}, _check_eager)], relpath="consensus/bad_async.py"),
    "eager_fetch_registered_points": Case("async_fetch", """\
        def g1_msm_batch(jobs):
            return g1_msm_batch_submit(jobs).result()

        def handle_parts_submit(self, items):
            fut = g1_msm_batch_submit(items)

            def settle():
                return fut.result()

            return settle
        """, [({}, _clean)], relpath="crypto/dkg.py"),
    "eager_fetch_unregistered_closure": Case("async_fetch", """\
        def combine(self, items):
            fut = g1_msm_batch_submit(items)
            return fut.result()
        """, [({}, _check_one_eager)], relpath="crypto/threshold.py"),
    "env_flag_known_bad": Case("env_flags", """\
        import os

        def gate():
            a = os.environ.get("HYDRABADGER_BOGUS_FLAG", "")
            b = os.getenv("HYDRABADGER_ANOTHER_ROGUE")
            c = os.environ["HYDRABADGER_SUBSCRIPT_ROGUE"]
            ok = os.environ.get("HYDRABADGER_NTT", "1")  # registered
            var = "HYDRABADGER_DYNAMIC"
            d = os.environ.get(var)  # variable name: out of scope
            return a, b, c, ok, d
        """, [({}, _check_env)], relpath="crypto/bad_env.py"),
    "task_retention_known_bad": Case("task_retention", """\
        import asyncio

        def spawn_and_forget(self, coro, coro2, coro3):
            asyncio.create_task(coro)
            t = asyncio.create_task(coro2)
            kept = asyncio.create_task(coro3)
            self._tasks.append(kept)
            return None
        """, [({}, _check_tasks)], relpath="net/bad_tasks.py"),
    # -- attacker-taint / secret-taint
    "attacker_taint_known_bad": Case("taint", {
        "net/bad.py": """\
            from ..utils import codec


            class Handler:
                def __init__(self):
                    self.frames = []

                def on_frame(self, raw):
                    items = codec.decode(raw)
                    for it in items:
                        self.frames.append(it)
                    n = len(items)
                    for _i in range(n):
                        pass
                    return [0] * n
            """,
        "ops/bad.py": """\
            import jax

            from ..utils import codec


            @jax.jit
            def kern(x):
                return x


            def launch(raw):
                items = codec.decode(raw)
                return kern(items)
            """,
    }, [({}, _check_taint_bad)], jax_only=lambda f: "reaches jit entrypoint" in f.message),
    "attacker_taint_sanitizers": Case("taint", {
        "net/ok.py": """\
            from collections import deque

            from ..utils import codec

            CAP = 64


            class Handler:
                def __init__(self):
                    self.frames = []
                    self.ring = deque(maxlen=128)

                def on_frame(self, raw):
                    items = codec.decode(raw)
                    if len(items) > CAP:
                        return
                    for it in items:
                        self.frames.append(it)

                def on_other(self, raw):
                    items = codec.decode(raw)
                    for it in items:
                        self.ring.append(it)

                def capped(self, raw):
                    item = codec.decode(raw)
                    if len(self.frames) < CAP:
                        self.frames.append(item)
            """,
    }, [({}, _clean)]),
    "attacker_taint_guard_direction": Case("taint", {
        "utils/bad.py": """\
            from ..utils import codec


            def parse(raw):
                buf = codec.decode(raw)
                n = buf[0]
                if 2 + n > len(buf):
                    raise ValueError("truncated")
                for _i in range(n):
                    pass
                m = buf[1]
                for _j in range(m):
                    pass
            """,
    }, [({}, _one_guard_flag)]),
    "attacker_taint_scenario_sources": Case("taint", {
        "sim/scenario.py": """\
            class Adversary:
                def __init__(self):
                    self.seen = []

                def inject(self, sender, recipient, message):
                    for part in message:
                        self.seen.append(part)
                    return None
            """,
        "sim/byzantine.py": """\
            class ByzantineNode:
                def __init__(self):
                    self.history = []

                def handle_message(self, sender, message):
                    n = len(message)
                    for _ in range(n):
                        pass

                def on_receive(self, node, sender, message):
                    self.history.append(message)
            """,
    }, [({}, _check_scenario_taint)]),
    "secret_taint_known_bad": Case("secrets", {
        "crypto/bad.py": """\
            import logging

            log = logging.getLogger("bad")


            class SecretKey:
                def __init__(self, scalar):
                    self.scalar = scalar


            def leak(sk):
                log.info("the key is %s", sk)
                print(sk)
                if sk:
                    raise ValueError(f"bad key {sk}")
            """,
    }, [({}, _check_secret_bad)]),
    "secret_taint_sealing_and_lengths": Case("secrets", {
        "crypto/ok.py": """\
            import hashlib
            import logging

            log = logging.getLogger("ok")


            def fine(sk, shares):
                digest = hashlib.sha256(sk).hexdigest()
                log.info("key digest %s", digest)
                if len(shares) < 3:
                    raise ValueError(f"need 3 shares, got {len(shares)}")
            """,
    }, [({}, _clean)]),
    # -- hbrace
    "await_interference_known_bad": Case("await_interference", {
        "net/bad.py": """\
            class Handler:
                def __init__(self):
                    self.frontier = 0

                async def on_frame(self, engine, msg):
                    snap = self.frontier
                    fut = engine.submit_verify(msg)
                    await fut
                    self.frontier = snap + 1

                async def revalidated(self, engine, msg):
                    snap = self.frontier
                    await engine.submit_verify(msg)
                    if self.frontier != snap:
                        return
                    self.frontier = snap + 1

                async def rhs_rereads(self, sleeper):
                    snap = self.frontier
                    await sleeper()
                    self.frontier = self.frontier + (snap and 1)

                async def other_loop(self, sleeper):
                    while True:
                        self.frontier += 1
                        await sleeper()
            """,
    }, [({}, _check_await_bad)]),
    "await_interference_single_coroutine": Case("await_interference", {
        "net/solo.py": """\
            class Solo:
                def __init__(self):
                    self.cursor = 0

                async def only_user(self, sleeper):
                    snap = self.cursor
                    await sleeper()
                    self.cursor = snap + 1
            """,
    }, [({}, _clean)]),
    "await_interference_registry_guard": Case("await_interference", {
        "net/bad.py": """\
            class Handler:
                def __init__(self):
                    self.frontier = 0

                async def on_frame(self, engine, msg):
                    snap = self.frontier
                    await engine.submit_verify(msg)
                    self.frontier = snap + 1

                async def other_loop(self, sleeper):
                    while True:
                        self.frontier += 1
                        await sleeper()
            """,
    }, [
        ({"AWAIT_RMW_GUARDS": {"net/bad.py::Handler.on_frame::frontier":
                               "single writer: other_loop is gated off while on_frame runs"}},
         _clean),
        ({"AWAIT_RMW_GUARDS": {"net/bad.py::Handler.on_frame::frontier":
                               "single writer: other_loop is gated off while on_frame runs",
                               "net/bad.py::Handler.vanished::attr": "stale"}},
         _any("no longer exists")),
    ]),
    "blocking_in_async_known_bad": Case("blocking_async", {
        "net/bad.py": """\
            import time


            def slow_helper():
                time.sleep(1.0)


            async def tick():
                slow_helper()


            async def snapshot(path):
                with open(path) as fh:
                    return fh.read()


            async def fetch(engine, jobs):
                fut = engine.submit_msm(jobs)
                return fut.result()
            """,
    }, [({}, _check_blocking_bad)]),
    "blocking_in_async_run_in_executor": Case("blocking_async", {
        "net/ok.py": """\
            import asyncio
            import time


            def slow_helper():
                time.sleep(1.0)


            async def tick():
                loop = asyncio.get_running_loop()
                await loop.run_in_executor(None, slow_helper)
            """,
    }, [({}, _clean)]),
    "blocking_in_async_declared_boundary": Case("blocking_async", {
        "net/bound.py": """\
            import os


            def persist(path, blob):
                fd = os.open(path, 0)
                os.fsync(fd)


            class Node:
                def _persist(self, path, blob):
                    persist(path, blob)

                async def on_commit(self, path, blob):
                    self._persist(path, blob)
            """,
    }, [
        ({}, _any("os.fsync")),
        ({"EXECUTOR_OFFLOAD_BOUNDARIES": {
            "net/bound.py::Node._persist": "test boundary: ships the fsync to the executor"}},
         _clean),
        ({"EXECUTOR_OFFLOAD_BOUNDARIES": {
            "net/bound.py::Node._persist": "test boundary: ships the fsync to the executor",
            "net/bound.py::Node.vanished": "stale"}},
         _any("no longer exists")),
    ]),
    "reachability_gather_fanout": Case("blocking_async", {
        "net/fan.py": """\
            import asyncio
            import time


            async def work_a():
                time.sleep(0.1)


            async def work_b():
                pass


            async def main():
                await asyncio.gather(work_a(), work_b())
            """,
    }, [({}, _any(("time.sleep()", "'work_a'")))]),
    "clock_domain_mixed_subtraction": Case("clock_domain", {
        "sim/bad.py": """\
            import time


            def mixed():
                t0 = time.perf_counter()
                t1 = time.time()
                return t1 - t0


            def clean():
                t0 = time.perf_counter()
                return time.perf_counter() - t0
            """,
    }, [({}, _check_clock_mixed)]),
    "clock_domain_skewed_freshness": Case("clock_domain", {
        "sup.py": """\
            import time


            def health(row):
                now = time.time()
                return now - row["t"]


            def age_with_fallback(row):
                now = time.time()
                return now - row.get("t_host", row["t"])
            """,
    }, [({"CLOCK_FEED_CONSUMERS": ("sup.py",),
          "CLOCK_FRESHNESS_FUNCS": {"sup.py::health": "test freshness decider"}},
         _any("skewed node time (skewed-wall) feeds the freshness",
              "joining two clock domains"))]),
    "clock_domain_persisted_monotonic": Case("clock_domain", {
        "persist.py": """\
            import time


            def black_box():
                return {"t_mono": time.monotonic(), "n": 3}
            """,
    }, [({"CLOCK_PERSIST_FUNCS": {"persist.py::black_box": "test persistence payload"}},
         _any("monotonic timestamp (mono) persisted under 't_mono'"))]),
    "clock_domain_bypass_net_scope": Case("clock_domain", {
        "net/badclock.py": """\
            import asyncio
            import time


            def tick(self):
                return time.monotonic()


            async def tock(self):
                loop = asyncio.get_running_loop()
                return loop.time()
            """,
        "bench_like.py": """\
            import time


            def tick():
                return time.monotonic()
            """,
    }, [({}, _check_clock_bypass)]),
    "clock_domain_stale_registry": Case("clock_domain", {"mod.py": "X = 1\n"}, [
        ({"CLOCK_INJECTION_POINTS": {"mod.py::vanished": "stale"}}, _any("no longer exists")),
    ]),
    # -- hbstate
    "state_lifecycle_undeclared_growth": Case("state_lifecycle", {
        "consensus/bad.py": """\
            class Core:
                def __init__(self):
                    self.ledger = []

                def handle(self, msg):
                    self.ledger.append(msg)
            """,
    }, [
        (_state_tables(("consensus/bad.py::Core",)), _any("undeclared state growth: Core.ledger")),
        (_state_tables(("consensus/bad.py::Core",), {
            "consensus/bad.py::Core.ledger": ("process_lifetime", "fixture: audited unbounded")}),
         _clean),
    ]),
    "state_lifecycle_per_era_bad": Case("state_lifecycle", {
        "consensus/core.py": _ERA_CORE % "pass",
    }, [(_state_tables(("consensus/core.py::Core",),
                       {"consensus/core.py::Core.votes": ("per_era", None)},
                       era_anchors=("consensus/core.py::Core._switch_era",)),
         _any("per_era state Core.votes is never"))]),
    "state_lifecycle_per_era_good": Case("state_lifecycle", {
        "consensus/core.py": _ERA_CORE % "self._rollover()\n\n        def _rollover(self):\n"
                                          "            self.votes = {}",
    }, [(_state_tables(("consensus/core.py::Core",),
                       {"consensus/core.py::Core.votes": ("per_era", None)},
                       era_anchors=("consensus/core.py::Core._switch_era",)),
         _clean)]),
    "state_lifecycle_per_epoch_eviction": Case("state_lifecycle", {
        "consensus/hb.py": """\
            class Badger:
                def __init__(self):
                    self.epochs = {}

                def handle(self, e, msg):
                    self.epochs[e] = msg

                def _on_commit(self, e):
                    self.epochs.pop(e, None)

                def _unrelated(self):
                    pass
            """,
    }, [
        (_state_tables(("consensus/hb.py::Badger",),
                       {"consensus/hb.py::Badger.epochs": ("per_epoch", None)},
                       epoch_anchors=("consensus/hb.py::Badger._on_commit",)), _clean),
        (_state_tables(("consensus/hb.py::Badger",),
                       {"consensus/hb.py::Badger.epochs": ("per_epoch", None)},
                       epoch_anchors=("consensus/hb.py::Badger._unrelated",)),
         _any("per_epoch state Badger.epochs is never")),
    ]),
    "state_lifecycle_fake_cap": Case("state_lifecycle", {
        "net/node.py": _CAP_NODE % ("[]", "item", "if len(self.log) > 16:\n"
                                    "                self.log.append(item)"),
    }, [(_state_tables(("net/node.py::Node",), {"net/node.py::Node.log": ("bounded", "16")}),
         _any(("declared bounded(16)", "no recognized cap guard")))]),
    "state_lifecycle_admission_cap": Case("state_lifecycle", {
        "net/node.py": _CAP_NODE % ("[]", "item", "if len(self.log) < 16:\n"
                                    "                self.log.append(item)"),
    }, [(_state_tables(("net/node.py::Node",), {"net/node.py::Node.log": ("bounded", "16")}),
         _clean)]),
    "state_lifecycle_trim_cap": Case("state_lifecycle", {
        "net/node.py": _CAP_NODE % ("{}", "key, item", "self.log[key] = item\n"
                                    "            while len(self.log) > 16:\n"
                                    "                self.log.pop(next(iter(self.log)))"),
    }, [(_state_tables(("net/node.py::Node",), {"net/node.py::Node.log": ("bounded", "16")}),
         _clean)]),
    "state_lifecycle_stale_entries": Case("state_lifecycle", {
        "consensus/core.py": """\
            class Core:
                def __init__(self):
                    self.kept = []
            """,
    }, [(_state_tables(("consensus/core.py::Core", "consensus/gone.py::Vanished"),
                       {"consensus/core.py::Core.dropped": ("per_epoch", None)}),
         _any("stale STATE_LIFECYCLE entry: Core.dropped",
              ("stale STATE_SCOPE_CLASSES entry", "Vanished")))]),
    "state_lifecycle_process_lifetime_justification": Case("state_lifecycle", {
        "net/node.py": """\
            class Node:
                def __init__(self):
                    self.batches = {}

                def commit(self, e, b):
                    self.batches[e] = b
            """,
    }, [(_state_tables(("net/node.py::Node",),
                       {"net/node.py::Node.batches": ("process_lifetime", "")}),
         _any("no justification"))]),
    "state_lifecycle_drain_swap": Case("state_lifecycle", {
        "net/node.py": """\
            class Node:
                def __init__(self):
                    self.q = []

                def tick(self):
                    pending, self.q = self.q, []
                    for item in pending:
                        if not self._send(item):
                            self.q.append(item)

                def _send(self, item):
                    return True
            """,
    }, [(_state_tables(("net/node.py::Node",),
                       {"net/node.py::Node.q": ("bounded", "drain-requeue")}), _clean)]),
    # -- hbquorum
    "quorum_undeclared_comparison": Case("quorum", {
        "consensus/bad.py": """\
            class Core:
                def have_quorum(self, shares, f):
                    return len(shares) >= f + 1
            """,
    }, [
        (_quorum({}), _any("undeclared quorum comparison")),
        (_quorum({"consensus/bad.py::Core.have_quorum::f+1": ("existence", None)}), _clean),
    ]),
    "quorum_wrong_direction_bad": Case("quorum", {
        "consensus/td.py": """\
            class Core:
                def decrypt_ready(self, shares, f):
                    return len(shares) > f + 1
            """,
    }, [(_quorum({"consensus/td.py::Core.decrypt_ready::f+2": ("existence", None)}),
         _any(("contradicts its declared class", "satisfied at f+2")))]),
    "quorum_wrong_direction_good": Case("quorum", {
        "consensus/td.py": """\
            class Core:
                def decrypt_ready(self, shares, f):
                    return len(shares) >= f + 1
            """,
    }, [(_quorum({"consensus/td.py::Core.decrypt_ready::f+1": ("existence", None)}), _clean)]),
    "quorum_misclassified": Case("quorum", {
        "consensus/ba.py": """\
            class Agreement:
                def relay_ready(self, votes, f):
                    return len(votes) > f

                def commit_ready(self, votes, n, f):
                    return len(votes) >= n - f
            """,
    }, [
        (_quorum({"consensus/ba.py::Agreement.relay_ready::f+1": ("intersection", None),
                  "consensus/ba.py::Agreement.commit_ready::n-f": ("intersection", None)}),
         _check_misclassified),
        (_quorum({"consensus/ba.py::Agreement.relay_ready::f+1": ("existence", None),
                  "consensus/ba.py::Agreement.commit_ready::n-f": ("intersection", None)}),
         _clean),
    ]),
    "quorum_stale_site_and_custom": Case("quorum", {
        "consensus/dkg.py": """\
            class KeyGen:
                def part_ready(self, acks, t):
                    return len(acks) >= 2 * t + 2
            """,
    }, [
        (_quorum({"consensus/dkg.py::KeyGen.part_ready::2*t+2": ("custom", ""),
                  "consensus/gone.py::Vanished.check::f+1": ("existence", None)}),
         _any(("custom quorum site", "no justification"),
              ("stale QUORUM_SITES entry", "Vanished"))),
        (_quorum({"consensus/dkg.py::KeyGen.part_ready::2*t+2": (
            "custom", "fixture: deliberate extra-slack bound")}), _clean),
    ]),
    # -- contract drift
    "contract_drift_green": Case("contract_drift", _drift(_DRIFT_GREEN),
                                 [(_DRIFT_TABLES, _clean)]),
    "contract_drift_stale_substring": Case("contract_drift", _drift(_DRIFT_GREEN.replace(
        'fault_any=("silence: peer went quiet",)', 'fault_any=("vanished: renamed emit",)')),
        [(_DRIFT_TABLES, _any("declares fault substring 'vanished: renamed emit'"))]),
    "contract_drift_unminted_gauge": Case("contract_drift", _drift(_DRIFT_GREEN.replace(
        "    metrics.gauge(QUEUE_DEPTH).track(0)\n", "")),
        [(_DRIFT_TABLES, _any("declared metric QUEUE_DEPTH = 'queue_depth' is never minted"))]),
    "contract_drift_undeclared_mint_uninjected_kind": Case("contract_drift", _drift(
        _DRIFT_GREEN.replace("metrics.counter(FAULTS_SEEN).inc()",
                             'metrics.counter("faults_seen_typo").inc()')
        .replace("    kind = BYZ_SILENCE\n", "    pass\n")),
        [(_DRIFT_TABLES, _any("'faults_seen_typo' is minted here but not declared",
                              ("inject", "'silence'")))]),
}

_MARKS = {
    "taint": "lint", "secrets": "lint", "await_interference": "hbrace",
    "blocking_async": "hbrace", "clock_domain": "hbrace", "task_retention": "hbrace",
    "state_lifecycle": "hbstate", "quorum": "hbquorum", "contract_drift": "hbquorum",
}


def _params():
    return [pytest.param(name, marks=getattr(pytest.mark, _MARKS[c.rule]), id=name)
            if c.rule in _MARKS else pytest.param(name, id=name)
            for name, c in CASES.items()]


def _patch(monkeypatch, reg, patches):
    for attr, value in patches.items():
        monkeypatch.setattr(reg, attr, value.copy() if isinstance(value, dict) else value)


def _run(case, root, pkg, reg, patches, monkeypatch):
    sf = _write(case, root, pkg)
    _patch(monkeypatch, reg, patches)
    return importlib.import_module(f"{pkg.__name__}.{case.rule}").check(sf)


@pytest.mark.parametrize("name", _params())
def test_port_rule_fires_on_fixture(name, tmp_path, monkeypatch):
    """tests/test_lint.py's fixture through the port's rule, with its checks."""
    case = CASES[name]
    for i, (patches, check) in enumerate(case.steps):
        root = tmp_path / f"step{i}"
        root.mkdir()
        check(_run(case, root, lint, registry, patches, monkeypatch))


@pytest.mark.parametrize("name", _params())
def test_parity_with_the_jax_rule(name, tmp_path, monkeypatch):
    """The same fixture through the JAX rule and the port's rule, registries
    patched alike: the same (rule, relpath, line, message), prefix stripped."""
    case = CASES[name]
    for i, (patches, _check) in enumerate(case.steps):
        results = []
        for tag, pkg, reg in (("port", lint, registry), ("jax", jlint, jregistry)):
            root = tmp_path / f"{tag}{i}"
            root.mkdir()
            results.append(_run(case, root, pkg, reg, patches, monkeypatch))
        ours, theirs = results
        assert _norm(ours) == _norm([f for f in theirs if not case.jax_only(f)])


# -- port-only fixtures ------------------------------------------------------


def test_limb_layout_fires_on_the_ports_layout(tmp_path):
    """The port's field planes: 12 words of 32 bits.  A torch float dtype, a
    magic word mask and a literal 32 shift fire; the JAX package's 12-bit
    constants (4095, >> 12) are the other package's layout and stay silent."""
    sf = SourceFile(tmp_path / "bad.py", "ops/bad.py", textwrap.dedent("""\
        import torch
        from .limbs import LIMB_BITS, N_LIMBS

        def f(x):
            y = x & 0xFFFFFFFF
            z = x >> 32
            w = x << 32
            v = torch.zeros((N_LIMBS, 4), dtype=torch.float32)
            u = x.to(torch.bfloat16)
            ok = (x >> LIMB_BITS) & 4095, x >> 12
            return y, z, w, v, u, ok
        """))
    messages = [f.message for f in limb_layout.check(sf)]
    assert sum("literal 0xFFFFFFFF" in m for m in messages) == 1
    assert sum("shift by literal 32" in m for m in messages) == 2
    assert any("float dtype .float32" in m for m in messages)
    assert any("float dtype .bfloat16" in m for m in messages)
    assert len(messages) == 5, messages
    assert limb_layout.applies("ops/fq_torch.py")
    assert not limb_layout.applies("crypto/engine.py")
    # the defining assignments of the port's layout are exempt, JAX's too
    consts = SourceFile(tmp_path / "limbs.py", "ops/limbs.py", textwrap.dedent("""\
        LIMB_BITS = 32
        N_LIMBS = 12
        LIMB_MASK = 0xFFFFFFFF
        JAX_LIMB_BITS = 12
        JAX_N_LIMBS = 32
        """))
    assert limb_layout.check(consts) == []
    # a module that never names the layout is not a field plane
    other = SourceFile(tmp_path / "gf.py", "ops/gf.py", "import torch\nx = torch.float32\n")
    assert limb_layout.check(other) == []


@pytest.mark.hbquorum
def test_quorum_counter_attribute_is_a_count(tmp_path, monkeypatch):
    """An integer attribute grown only by `+= 1` is a count (the Subset's
    `self._accepted` gate): undeclared, it fires; declared intersection, it
    verifies; a wrong-direction rendering contradicts the class.  An
    attribute with any other write is not a count."""
    code = """\
        class Gate:
            def __init__(self, netinfo):
                self.netinfo = netinfo
                self._accepted = 0
                self._weight = 0

            def accept(self, w):
                self._accepted += 1
                self._weight += w

            def check(self):
                a = self._accepted %s self.netinfo.num_correct
                b = self._weight >= self.netinfo.num_correct
                return a, b
        """
    key = "consensus/gate.py::Gate.check::n-f"
    for op, sites, expect in (
        (">=", {}, "undeclared quorum comparison"),
        (">=", {key: ("intersection", None)}, None),
        (">", {key: ("intersection", None)}, "stale QUORUM_SITES entry"),
        (">=", {key: ("existence", None)}, "contradicts its declared class"),
    ):
        pkg = tmp_path / f"gate{len(list(tmp_path.iterdir()))}"
        (pkg / "consensus").mkdir(parents=True)
        (pkg / "consensus" / "gate.py").write_text(textwrap.dedent(code % op))
        (pkg / "__init__.py").write_text("")
        monkeypatch.setattr(registry, "QUORUM_SITES", dict(sites))
        messages = [f.message for f in quorum.check(SourceFile.load(pkg / "__init__.py", pkg))]
        if expect is None:
            assert messages == []
        else:
            assert any(expect in m for m in messages), (op, messages)
        assert not any("_weight" in m for m in messages)


@pytest.mark.lint
def test_secret_taint_device_is_metadata(tmp_path):
    """A tensor's device, like its shape and dtype, is metadata: naming it in
    an exception is clean; naming the tensor is not."""
    root = tmp_path
    (root / "ops").mkdir()
    (root / "ops" / "wrap.py").write_text(textwrap.dedent("""\
        def launch(sk):
            if sk.device.type != "cuda":
                raise ValueError(f"runs on cuda, not {sk.device} {tuple(sk.shape)}")
            raise ValueError(f"bad operand {sk}")
        """))
    (root / "__init__.py").write_text("")
    fs = secrets.check(SourceFile.load(root / "__init__.py", root))
    assert [f.line for f in fs if "interpolated into an exception" in f.message] == [4]


# -- the suppression pragma --------------------------------------------------


@pytest.mark.parametrize("text,n_suppressed,rules", [
    ("import time  # hblint: disable=sans-io -- fixture uses a frozen clock\ntime.time()\n",
     1, set()),
    ("# hblint: disable=sans-io -- fixture uses a frozen clock\nimport time\ntime.time()\n",
     1, set()),
    ("import socket  # hblint: disable=sans-io\n", 0, {"suppression", "sans-io"}),
], ids=["with_justification", "comment_above", "without_justification"])
def test_suppression_pragma(tmp_path, text, n_suppressed, rules):
    cons = tmp_path / "consensus"
    cons.mkdir()
    (cons / "bad.py").write_text(text)
    findings, suppressed = lint.run(root=tmp_path, rules=[sansio])
    assert suppressed == n_suppressed
    assert {f.rule for f in findings} == rules
    if n_suppressed:
        assert not [f for f in findings if f.rule == "sans-io"]


# -- the real tree -----------------------------------------------------------


def test_rule_scopes():
    assert sansio.applies("consensus/broadcast.py")
    assert not sansio.applies("net/node.py")
    assert not deadcode.applies("utils/__init__.py")
    assert async_fetch.applies("crypto/dkg.py")
    assert async_fetch.applies("consensus/dynamic_honey_badger.py")
    assert not async_fetch.applies("crypto/futures.py")
    assert not async_fetch.applies("crypto/engine.py")


def test_env_flag_registry_is_live():
    """Every ENV_FLAGS entry is read, literally, somewhere in the port; and
    every literal HYDRABADGER_* read is registered (the rule)."""
    read = set()
    for sf in lint.iter_sources():
        if sf.relpath.startswith("lint/"):
            continue
        for node in ast.walk(sf.tree):
            name = env_flags._env_name(node)
            if name:
                read.add(name)
    assert sorted(set(registry.ENV_FLAGS) - read) == []
    assert {n for n in read if n.startswith("HYDRABADGER")} == set(registry.ENV_FLAGS)
    for flag in ("HYDRABADGER_GPU_DKG", "HYDRABADGER_DECRYPT_T", "HYDRABADGER_WIN_CIRCUIT",
                 "HYDRABADGER_NTT_MIN_SHARDS", "HYDRABADGER_NO_NATIVE_ACS"):
        assert flag in read


@pytest.mark.lint
def test_callgraph_resolves_methods_and_engine_dispatch(full_run):
    g = callgraph.build(PACKAGE_ROOT)
    sites = g.calls_by_caller["net/node.py::Hydrabadger._on_net_state"]
    tgt = [s for s in sites if s.dotted == "self._discover"]
    assert tgt and tgt[0].targets == ["net/node.py::Hydrabadger._discover"]
    sites = g.calls_by_caller["net/node.py::Hydrabadger._on_peer_msg"]
    tgt = [s for s in sites if s.dotted == "peer.send"]
    assert tgt and "net/peer.py::Peer.send" in tgt[0].targets
    # the factory registry: get_engine -> CpuEngine | GpuEngine
    assert callgraph.FACTORY_RETURNS["get_engine"] == ("CpuEngine", "GpuEngine")
    sites = g.calls_by_caller["net/node.py::Hydrabadger._preverify_batch"]
    tgt = [s for s in sites if s.dotted == "self.engine.verify_batch"]
    assert tgt and "crypto/engine.py::CpuEngine.verify_batch" in tgt[0].targets
    sites = g.calls_by_caller["net/wire.py::WireStream._assemble"]
    # codec.encode resolves to the codec's own function (the port defines it
    # with def, where the JAX codec binds an alias, which stays unresolved)
    # and never to a same-named method elsewhere (ReedSolomon.encode)
    tgt = [s for s in sites if s.dotted == "codec.encode"]
    assert tgt and tgt[0].targets == ["utils/codec.py::encode"]
    # inheritance: GpuEngine inherits verify_batch from CpuEngine
    ci = g.class_named("GpuEngine")[0]
    assert (g.mro_method(ci, "verify_batch").qualname
            == "crypto/engine.py::CpuEngine.verify_batch")


@pytest.mark.hbrace
def test_task_retention_repo_idioms_are_clean():
    findings = []
    for sf in lint.iter_sources():
        findings.extend(task_retention.check(sf))
    assert findings == [], [f.render() for f in findings]


@pytest.mark.hbrace
def test_reachability_resolves_create_task_and_dhb_hook(full_run):
    g = callgraph.build(PACKAGE_ROOT)
    reach = reachable_map(g, boundaries=tuple(registry.EXECUTOR_OFFLOAD_BOUNDARIES))
    cull = reach["net/node.py::Hydrabadger._cull_stalled_handshakes"]
    assert "net/node.py::Hydrabadger._wire_retry_loop" in cull
    handle = reach["consensus/dynamic_honey_badger.py::DynamicHoneyBadger.handle_message"]
    assert "net/node.py::Hydrabadger._handler_loop" in handle
    assert "obs/flight.py::FlightRecorder.dump" in reach
    assert "obs/flight.py::FlightRecorder._write" not in reach
    assert "checkpoint.py::CheckpointStore.save" not in reach


@pytest.mark.hbquorum
def test_quorum_repo_registry_is_live(full_run):
    """Every QUORUM_SITES key matches a comparison of the port, the Subset's
    n-f gate on its `_accepted` counter among them, checked as intersection."""
    sites = quorum.collect_sites(callgraph.build(PACKAGE_ROOT))
    live = {s.key for s in sites}
    for key, (cls, note) in registry.QUORUM_SITES.items():
        assert cls in quorum.CLASSES, (key, cls)
        assert key in live, f"stale QUORUM_SITES key: {key}"
        if cls == "custom":
            assert note and str(note).strip()
    subset = [s for s in sites if s.key == "consensus/subset.py::Subset._global_transitions::n-f"]
    assert subset and all(s.op_text == ">=" for s in subset)
    assert registry.QUORUM_SITES[subset[0].key][0] == "intersection"
    assert all(quorum.class_matches("intersection", s.satisfied_at) for s in subset)


@pytest.mark.hbstate
def test_state_lifecycle_repo_registry_is_live():
    scoped = set(registry.STATE_SCOPE_CLASSES)
    assert scoped
    for full, (lifecycle, arg) in registry.STATE_LIFECYCLE.items():
        assert full.rsplit(".", 1)[0] in scoped, full
        assert lifecycle in state_lifecycle.LIFECYCLES, full
        if lifecycle in ("bounded", "process_lifetime"):
            assert arg and str(arg).strip(), full
    assert registry.LINT_TIME_BUDGET_S == 60.0


def test_registry_keeps_every_jax_entry():
    """The port keeps the JAX file layout, so every table entry of JAX's
    registry names code the port has: the tables are equal, apart from the
    tables of the unported rules, ENV_FLAGS (each package reads its own
    flags) and SECRET_SAFE_ATTRS (plus a tensor's device)."""
    unported = {"SHAPE_BUCKET_FUNCS", "BUCKET_CAPACITY", "SANITIZING_FUNCS",
                "CONFIG_BOUNDED_JIT"}
    own = {"ENV_FLAGS", "SECRET_SAFE_ATTRS"}
    names = {n for n in vars(jregistry) if n.isupper()}
    assert names - {n for n in vars(registry) if n.isupper()} == unported
    for name in sorted(names - unported - own):
        assert getattr(registry, name) == getattr(jregistry, name), name
    assert registry.SECRET_SAFE_ATTRS == jregistry.SECRET_SAFE_ATTRS | {"device"}
    assert "HYDRABADGER_GPU_DKG" in registry.ENV_FLAGS
    assert "HYDRABADGER_TPU_DKG" not in registry.ENV_FLAGS


def test_metric_names_match_the_jax_constants():
    """Every metric constant the port declares has JAX's identifier and
    string where JAX has the name; JAX's retrace and mul-batch families have
    no counterpart, and the verify-batch counters and the verified
    threshold-decrypt epoch's are the port's own."""
    from hydrabadger_tpu.obs import metrics as jm
    from hydrabadger_tpu_torch.obs import metrics as pm

    def consts(mod):
        return {k: v for k, v in vars(mod).items() if k.isupper() and isinstance(v, str)}

    ours, theirs = consts(pm), consts(jm)
    for name in set(ours) & set(theirs):
        assert ours[name] == theirs[name], name
    assert set(theirs) - set(ours) == {"MUL_BATCH_LANES", "MUL_BATCH_PAD_LANES",
                                       "MUL_BATCH_REAL_LANES", "RETRACE_SIGS_PREFIX"}
    assert set(ours) - set(theirs) == {"VERIFY_DEVICE_BATCHES", "VERIFY_DEVICE_LANES",
                                       "VERIFY_TO_POINTS_MS", "TDEC_SHARES_REJECTED",
                                       "VERIFY_ISSUE_S"}
    assert pm.EPOCH_REPLAYS == "epoch_replays"


def test_sample_messages_roundtrip_with_jax_bytes():
    """The port's sample_messages(), from the port's net/wire, round-trip
    through the port's codec, encode to JAX's bytes, and every malformed
    frame is refused with ValueError alone."""
    from hydrabadger_tpu.lint import wire_contract as jwc
    from hydrabadger_tpu_torch.net import wire

    ours = wire_contract.sample_messages()
    theirs = jwc.sample_messages()
    assert {m.kind for m in ours} == set(wire.KINDS)
    assert all(isinstance(m, wire.WireMessage) for m in ours)
    assert [m.encode() for m in ours] == [m.encode() for m in theirs]
    for msg in ours:
        raw = msg.encode()
        assert wire.WireMessage.decode(raw) == msg, msg.kind
        assert wire.WireMessage.decode(raw).encode() == raw
    corpus = wire_contract.malformed_samples()
    assert [r for _, r in corpus] == [r for _, r in jwc.malformed_samples()]
    for label, raw in corpus:
        with pytest.raises(ValueError):
            wire.WireMessage.decode(raw)


# -- mutations of the port's own modules -------------------------------------


def _copy(tmp_path, relpaths=None, name="pkg") -> Path:
    """The port's package (or the named modules of it) under tmp_path/name.
    A mutated copy gets a directory of its own: call graphs are cached by
    package root."""
    root = tmp_path / name
    if relpaths is None:
        shutil.copytree(PACKAGE_ROOT, root,
                        ignore=lambda d, names: [n for n in names if n == "__pycache__" or (
                            not n.endswith(".py") and not (Path(d) / n).is_dir())])
    else:
        for rel in relpaths:
            (root / rel).parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(PACKAGE_ROOT / rel, root / rel)
    (root / "__init__.py").touch()
    return root


def _mutate(root: Path, rel: str, old: str, new: str) -> None:
    p = root / rel
    text = p.read_text()
    assert text.count(old) == 1, (rel, old)
    p.write_text(text.replace(old, new))


_SUBSET_GATE = "if self._accepted >= self.netinfo.num_correct and not self._voted_zero:"


@pytest.mark.hbquorum
@pytest.mark.parametrize("new,expect", [
    (_SUBSET_GATE.replace(">=", ">"), "Subset._global_transitions"),
    (_SUBSET_GATE.replace("num_correct", "num_correct - 1"), "Subset._global_transitions"),
], ids=["gt", "off_by_one"])
def test_quorum_fires_on_a_mutated_subset_gate(tmp_path, monkeypatch, new, expect):
    """The Subset's n-f gate (consensus/subset.py), copied: clean as it is,
    and a finding once `>=` is broken."""
    rel = "consensus/subset.py"
    monkeypatch.setattr(registry, "QUORUM_SITES", {
        k: v for k, v in registry.QUORUM_SITES.items() if k.startswith(rel + "::")})
    assert quorum.check_root(_copy(tmp_path, [rel], "clean"), "hydrabadger_tpu_torch") == []
    root = _copy(tmp_path, [rel])
    _mutate(root, rel, _SUBSET_GATE, new)
    messages = [f.message for f in quorum.check_root(root, "hydrabadger_tpu_torch")]
    assert any(expect in m for m in messages), messages


@pytest.mark.hbquorum
def test_quorum_sees_the_subset_counter_only_while_it_counts(tmp_path, monkeypatch):
    """`self._accepted += 1` is what makes the gate a count: grown by any
    other step, the attribute is no count, and the declared site goes stale."""
    rel = "consensus/subset.py"
    root = _copy(tmp_path, [rel])
    monkeypatch.setattr(registry, "QUORUM_SITES", {
        k: v for k, v in registry.QUORUM_SITES.items() if k.startswith(rel + "::")})
    _mutate(root, rel, "self._accepted += 1", "self._accepted += 2")
    messages = [f.message for f in quorum.check_root(root, "hydrabadger_tpu_torch")]
    assert any("stale QUORUM_SITES entry" in m and "::n-f" in m for m in messages), messages


@pytest.mark.hbstate
def test_state_lifecycle_fires_on_a_mutated_latency_merge(tmp_path, monkeypatch):
    """obs/latency.py, copied: clean as it is; with merge()'s trim loop
    replaced by a call to a helper (the shape the port first had) the
    declared bounded LatencySketch.buckets has no cap at the merge growth
    site."""
    rel = "obs/latency.py"
    root = _copy(tmp_path, [rel])
    scope = tuple(c for c in registry.STATE_SCOPE_CLASSES if c.startswith(rel + "::"))
    monkeypatch.setattr(registry, "STATE_SCOPE_CLASSES", scope)
    monkeypatch.setattr(registry, "STATE_LIFECYCLE", {
        k: v for k, v in registry.STATE_LIFECYCLE.items() if k.startswith(rel + "::")})
    assert len(scope) == 3
    assert state_lifecycle.check_root(_copy(tmp_path, [rel], "clean"),
                                      "hydrabadger_tpu_torch") == []
    _mutate(root, rel, "        self._lo = None\n        while len(self.buckets) > self.max_buckets:\n"
            "            spill = self.buckets.pop(self._lowest())\n"
            "            self._lo = nxt = min(self.buckets)\n"
            "            self.buckets[nxt] += spill\n\n    def scale",
            "        self._lo = None\n        self._trim()\n\n    def scale")
    messages = [f.message for f in state_lifecycle.check_root(root, "hydrabadger_tpu_torch")]
    assert any("LatencySketch.buckets is declared bounded" in m and "'merge'" in m
               for m in messages), messages


@pytest.mark.hbquorum
def test_contract_drift_fires_on_a_dropped_metric_constant(tmp_path, full_run):
    """The port's package, copied, with EPOCH_REPLAYS dropped from
    obs/metrics.py (the drift this analyzer found): the wire tier's
    observable and the node's mint site both fire."""
    root = _copy(tmp_path)
    _mutate(root, "obs/metrics.py", 'EPOCH_REPLAYS = "epoch_replays"\n', "")
    messages = [f.message for f in contract_drift.check_root(root, "hydrabadger_tpu_torch")]
    assert any("WIRE_FAULT_OBSERVABLES" in m and "'epoch_replays' not declared" in m
               for m in messages), messages
    assert any("'epoch_replays' is minted here but not declared" in m for m in messages)
    assert not [f for f in full_run[0] if f.rule == "contract-drift"]


@pytest.mark.parametrize("old,new,expect", [
    ('elif kind == "goodbye":', 'elif kind == "goodby":',
     "kind 'goodbye' has no dispatch arm"),
    ('WireMessage("era_transcript_request", int(era))',
     'WireMessage("era_transcript_req", int(era))',
     "WireMessage kind 'era_transcript_req' is not declared"),
], ids=["dispatch_arm", "constructed_kind"])
def test_wire_exhaustive_fires_on_a_mutated_node(tmp_path, old, new, expect):
    """The port's net/ package, copied: clean as it is; a dropped dispatch
    arm or an undeclared kind in node.py fires."""
    rels = [p.relative_to(PACKAGE_ROOT).as_posix() for p in (PACKAGE_ROOT / "net").glob("*.py")]

    def run(root):
        sf = SourceFile.load(root / "net" / "wire.py", root)
        return [f.message for f in wire_contract.check(sf)]

    assert run(_copy(tmp_path, rels, "clean")) == []
    root = _copy(tmp_path, rels)
    _mutate(root, "net/node.py", old, new)
    assert any(expect in m for m in run(root)), run(root)
