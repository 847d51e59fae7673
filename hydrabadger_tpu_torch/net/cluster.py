"""Process-tier chaos harness: real OS processes, real SIGKILL.

The port's copy of hydrabadger_tpu/net/cluster.py.  Every other chaos
plane runs inside ONE Python process: ``Hydrabadger.crash()`` *emulates*
SIGKILL (net/chaos.py) and checkpoints live as in-memory objects.  This
supervisor crosses the OS process boundary: each validator is a real
``python -m hydrabadger_tpu_torch`` child whose lifecycle the supervisor owns
— spawn, health watchdog, ``SIGTERM`` graceful stop (drain + final
durable checkpoint + exit 0), ``SIGKILL`` hard kill (the process dies
mid-syscall, sockets mid-write, queued frames and all), restart from
the on-disk generational checkpoint store, restart policies, and
declarative kill schedules (staggered rolling kills included).  It also
injects the one fault class no in-process plane can model: per-node
wall-clock skew, pushed into each child's environment
(``HYDRABADGER_CLOCK_SKEW_S`` offset / ``HYDRABADGER_CLOCK_RATE``
drift) and honored by the node's replay/backoff timers.

Each child runs the crypto engine the supervisor was given (``engine``,
default "gpu": the card, on ``device``; or "cpu"), passed as the node
CLI's ``--engine``/``--device``.  A child that cannot reach the card
exits nonzero and the harness reports it; nothing retries on the CPU.
With the gpu engine the supervisor builds the node's kernels (and the
native host library) once before it spawns, so children started
together load them instead of each running the compiler.

Three child-side feeds make the tier observable without shared memory:

  * ``--metrics node.jsonl --metrics-interval S`` — periodic
    machine-readable fault/metrics summaries (counters, gauge
    high-waters, fault-ring kinds, pid), the lines a SIGKILL cannot
    retract;
  * ``--batch-log batches.jsonl`` — one line per committed batch
    (epoch, era, contribution digest, pk_set digest): the cross-process
    agreement and catch-up feed;
  * ``--checkpoint node.ckpt`` — the durable generational store
    (checkpoint.CheckpointStore) restarts resume from.

The port's summary lines also carry the process registry's counters
(``verify_batch_device_batches`` / ``_lanes``: the wire-signature checks
on kernel B2) and each incarnation's kernel ``launches``:
:meth:`ClusterSupervisor.device_work` reads them per incarnation.

The **fault-observability contract** is the wire tier's, ported up one
level: :data:`PROC_FAULT_OBSERVABLES` extends
:data:`~hydrabadger_tpu_torch.net.chaos.WIRE_FAULT_OBSERVABLES` with the
process-only clock-skew kind, and :func:`verify_process_scenario` folds
every incarnation's summary lines into the sim verifier — a SIGKILL
with no corresponding recovery trace (welcome-back replay, f+1 frontier
fast-forward, or observer re-adoption) fails the run.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..consensus import types as T
from ..obs.logging import get_logger
from ..obs.metrics import (
    BYZ_FAULTS_PREFIX,
    VERIFY_DEVICE_BATCHES,
    VERIFY_DEVICE_LANES,
    MetricsRegistry,
)
from ..sim.scenario import (
    InjectionLog,
    ObsSpec,
    fold_fault_counters,
    verify_observability,
)
from .chaos import WIRE_FAULT_OBSERVABLES
from .node import WireFault

log = get_logger("hydrabadger_tpu_torch.net.cluster")

# -- the process-tier observability registry ---------------------------------
#
# Everything the wire tier declares, plus the kind only a supervisor
# that owns each validator's PROCESS ENVIRONMENT can inject.  Clock
# skew is pure timing and the protocol is asynchronous (it makes no
# timing assumptions to violate), so the declared observable is the
# injection counter — the sim's stance for withheld shares and link
# loss (scenario.SELF_COUNTING_KINDS).
PROC_FAULT_OBSERVABLES: Dict[str, ObsSpec] = dict(WIRE_FAULT_OBSERVABLES)
PROC_FAULT_OBSERVABLES[T.BYZ_CLOCK_SKEW] = ObsSpec(
    counters=(BYZ_FAULTS_PREFIX + T.BYZ_CLOCK_SKEW,)
)

# SIGTERM escalation budget: a graceful stop that outlives this is
# treated as wedged and hard-killed (the rc!=0 then fails the caller's
# graceful-exit assertion instead of hanging the harness)
GRACEFUL_STOP_TIMEOUT_S = 30.0


# -- declarative schedule pieces ----------------------------------------------


@dataclass(frozen=True)
class KillSpec:
    """One scheduled kill: ``at_s`` seconds after the schedule arms,
    send ``sig`` to node ``node``; with ``restart_after_s`` set, respawn
    it from its on-disk checkpoint that many seconds later.  Grammar
    (CLI / docs): ``AT:NODE[:SIG[:RESTART_AFTER]]`` with SIG ``kill``
    (SIGKILL, the default) or ``term`` (SIGTERM) — e.g. ``5:1:kill:3``
    = at +5 s SIGKILL node 1, restart it 3 s later; ``8:2:term`` = at
    +8 s gracefully stop node 2 and leave it down."""

    at_s: float
    node: int
    sig: str = "kill"  # "kill" | "term"
    restart_after_s: Optional[float] = None


def parse_kill_spec(text: str) -> KillSpec:
    parts = text.split(":")
    if not 2 <= len(parts) <= 4:
        raise ValueError(f"bad kill spec {text!r} (want AT:NODE[:SIG[:RESTART]])")
    at_s, node = float(parts[0]), int(parts[1])
    sig = parts[2] if len(parts) > 2 else "kill"
    if sig not in ("kill", "term"):
        raise ValueError(f"bad kill signal {sig!r} (want kill|term)")
    restart = float(parts[3]) if len(parts) > 3 else None
    return KillSpec(at_s=at_s, node=node, sig=sig, restart_after_s=restart)


def rolling_kills(
    n: int, start_s: float, stagger_s: float, down_s: float,
    sig: str = "kill",
) -> Tuple[KillSpec, ...]:
    """A staggered rolling-kill schedule: node 0..n-1 each killed
    ``stagger_s`` apart and restarted ``down_s`` later.  With
    ``stagger_s > down_s`` at most one node is down at a time — the
    rolling-restart shape an operator's deploy actually produces."""
    return tuple(
        KillSpec(
            at_s=start_s + i * stagger_s, node=i, sig=sig,
            restart_after_s=down_s,
        )
        for i in range(n)
    )


@dataclass(frozen=True)
class RestartPolicy:
    """What the health watchdog does when a child dies OUTSIDE the kill
    schedule.  ``never`` records the death; ``on_failure`` respawns on a
    nonzero exit; ``always`` respawns regardless — each from the child's
    on-disk checkpoint, at most ``max_restarts`` times per node with
    ``backoff_s`` between attempts."""

    mode: str = "on_failure"  # never | on_failure | always
    max_restarts: int = 3
    backoff_s: float = 0.5

    def should_restart(self, returncode: Optional[int], restarts: int) -> bool:
        if restarts >= self.max_restarts:
            return False
        if self.mode == "never":
            return False
        if self.mode == "always":
            return True
        return returncode is not None and returncode != 0


class _JsonlFeed:
    """Incremental tolerant JSONL reader for one child feed file.

    The supervisor's wait loops poll feeds every ~0.2 s; re-reading and
    re-parsing the whole growing file each tick would make total
    supervisor work quadratic in run length.  This reader remembers its
    byte offset and parses only appended COMPLETE lines (a SIGKILL can
    tear the final line mid-write; the torn tail stays buffered and is
    skipped if it never becomes parseable).  ``max_epoch`` tracks the
    committed-batch frontier incrementally for the same reason."""

    def __init__(self, path: str):
        self.path = path
        self.rows: List[dict] = []
        self.max_epoch = -1
        self._pos = 0
        self._buf = ""

    def poll(self) -> List[dict]:
        try:
            with open(self.path) as fh:
                fh.seek(self._pos)
                chunk = fh.read()
                self._pos = fh.tell()
        except FileNotFoundError:
            return self.rows
        if chunk:
            self._buf += chunk
            *lines, self._buf = self._buf.split("\n")
            for line in lines:
                try:
                    row = json.loads(line)
                except ValueError:
                    continue
                self.rows.append(row)
                ep = row.get("epoch")
                if isinstance(ep, int) and ep > self.max_epoch:
                    self.max_epoch = ep
        return self.rows


@dataclass
class ChildNode:
    """One validator slot: its ports, artifact paths, and the live
    process (None while down).  ``restarts`` counts respawns of this
    slot across the run — every incarnation appends to the same
    metrics/batch-log files, tagged by pid."""

    index: int
    port: int
    ckpt_path: str
    metrics_path: str
    batch_log_path: str
    stdout_path: str
    trace_path: str = ""
    flight_prefix: str = ""
    env_extra: Dict[str, str] = field(default_factory=dict)
    proc: Optional[subprocess.Popen] = None
    restarts: int = 0
    last_exit: Optional[int] = None
    last_spawn_t: float = 0.0
    killed_pids: List[int] = field(default_factory=list)

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


class ClusterSupervisor:
    """Own the lifecycle of an n-validator process-per-node cluster.

    Synchronous by design: the children are real processes, so the
    supervisor needs no event loop — it polls child liveness and the
    JSONL feeds on the wall clock, which is exactly what an external
    operator/orchestrator can do too."""

    def __init__(
        self,
        n: int = 4,
        base_port: int = 3970,
        workdir: str = ".",
        fast_crypto: bool = True,
        txn_interval_ms: int = 150,
        checkpoint_every: int = 1,
        metrics_interval_s: float = 0.5,
        seed: int = 0,
        clock_skew: Optional[Dict[int, Tuple[float, float]]] = None,
        restart_policy: Optional[RestartPolicy] = None,
        python: str = sys.executable,
        engine: str = "gpu",
        device: str = "cuda",
    ):
        if engine not in ("gpu", "cpu"):
            raise ValueError(f"unknown engine {engine!r} (want gpu|cpu)")
        self.n = n
        self.engine = engine
        self.device = device
        self.base_port = base_port
        self.workdir = workdir
        self.fast_crypto = fast_crypto
        self.txn_interval_ms = txn_interval_ms
        self.checkpoint_every = checkpoint_every
        self.metrics_interval_s = metrics_interval_s
        self.seed = seed
        self.restart_policy = restart_policy or RestartPolicy()
        self.python = python
        self.metrics = MetricsRegistry()
        self.log = InjectionLog(self.metrics)
        self.children: List[ChildNode] = []
        self._feeds: Dict[str, _JsonlFeed] = {}
        os.makedirs(workdir, exist_ok=True)
        clock_skew = clock_skew or {}
        # kept for the latency-sketch merge: a drifting node's durations
        # are scaled by its rate, and the fold must undo that (offsets
        # cancel in durations, rates don't)
        self.clock_skew: Dict[int, Tuple[float, float]] = dict(clock_skew)
        for i in range(n):
            env_extra: Dict[str, str] = {}
            if i in clock_skew:
                offset, rate = clock_skew[i]
                env_extra["HYDRABADGER_CLOCK_SKEW_S"] = repr(float(offset))
                env_extra["HYDRABADGER_CLOCK_RATE"] = repr(float(rate))
            self.children.append(
                ChildNode(
                    index=i,
                    port=base_port + i,
                    ckpt_path=os.path.join(workdir, f"node{i}.ckpt"),
                    metrics_path=os.path.join(workdir, f"node{i}.metrics.jsonl"),
                    batch_log_path=os.path.join(workdir, f"node{i}.batches.jsonl"),
                    stdout_path=os.path.join(workdir, f"node{i}.log"),
                    # cluster-timeline feeds: span trace
                    # dumped at exit, flight black boxes (pid-tagged)
                    # dumped throughout — the SIGKILL-surviving half
                    trace_path=os.path.join(workdir, f"node{i}.trace.jsonl"),
                    flight_prefix=os.path.join(workdir, f"node{i}.flight"),
                    env_extra=env_extra,
                )
            )

    # -- lifecycle -----------------------------------------------------------

    def _command(self, child: ChildNode) -> List[str]:
        cmd = [
            self.python, "-m", "hydrabadger_tpu_torch",
            "-b", f"127.0.0.1:{child.port}",
            "--keygen-node-count", str(self.n),
            "--txn-gen-interval", str(self.txn_interval_ms),
            "--seed", str(self.seed * 1000 + child.index),
            "--checkpoint", child.ckpt_path,
            "--checkpoint-every", str(self.checkpoint_every),
            "--metrics", child.metrics_path,
            "--metrics-interval", str(self.metrics_interval_s),
            "--batch-log", child.batch_log_path,
            "--trace", child.trace_path,
            "--flight", child.flight_prefix,
        ]
        for other in self.children:
            if other.index != child.index:
                cmd += ["-r", f"127.0.0.1:{other.port}"]
        if self.fast_crypto:
            cmd.append("--fast-crypto")
        return cmd + ["--engine", self.engine, "--device", self.device]

    def prepare(self) -> None:
        """Build what every child loads, once, before any spawns: the host
        libraries (native BLS, the GF(2^8) library, the ACS core, the codec
        twin) and, with the gpu engine on a card, the node's kernels (B2 for
        the signature batches and the DKG plane, B1 for the sketches).
        Children started together then each load the built files.  A gpu
        engine on the CPU runs the plain versions: no kernel to build."""
        from ..utils import host_native

        t0 = time.monotonic()
        host_native.build_all()
        if self.engine == "gpu" and self.device.split(":")[0] == "cuda":
            from ..ops import _kernels

            _kernels.build(["fq_point", "gf256_matmul"])
        log.info("child libraries ready in %.1fs", time.monotonic() - t0)

    def spawn(self, i: int) -> None:
        child = self.children[i]
        if child.alive:
            raise RuntimeError(f"node {i} is already running")
        env = dict(os.environ)
        env.update(child.env_extra)
        out = open(child.stdout_path, "ab")
        try:
            # own session/process group: a SIGKILL to the child must
            # never leak to the supervisor, and vice versa
            child.proc = subprocess.Popen(
                self._command(child),
                stdout=out, stderr=subprocess.STDOUT,
                env=env, start_new_session=True,
            )
        finally:
            out.close()
        child.last_spawn_t = time.monotonic()
        self.metrics.counter("proc_spawns").inc()
        log.info("spawned node %d (pid %d)", i, child.proc.pid)

    def start_all(self) -> None:
        self.prepare()
        for i in range(self.n):
            self.spawn(i)

    def kill(self, i: int) -> None:
        """Real SIGKILL: the child dies mid-whatever-it-was-doing —
        no drain, no final summary line, no final checkpoint.  Noted as
        a BYZ_CRASH injection: the contract then DEMANDS a recovery
        trace from the cluster."""
        child = self.children[i]
        if not child.alive:
            raise RuntimeError(f"node {i} is not running")
        self.log.note(T.BYZ_CRASH)
        self.metrics.counter("proc_sigkills").inc()
        # remember the killed incarnation's pid: its flight dump
        # (<prefix>.<pid>.json) is the only record the kill didn't
        # retract, and the black-box assertion looks it up by pid
        child.killed_pids.append(child.proc.pid)
        os.kill(child.proc.pid, signal.SIGKILL)
        child.last_exit = child.proc.wait()
        child.proc = None
        log.info("SIGKILLed node %d", i)

    def terminate(self, i: int, timeout_s: float = GRACEFUL_STOP_TIMEOUT_S) -> int:
        """Graceful stop: SIGTERM, wait for exit.  Returns the exit
        code — 0 is the child's graceful-shutdown contract (drain async
        futures, persist a final checkpoint); anything else means the
        handler broke and the caller should fail its run."""
        child = self.children[i]
        if not child.alive:
            raise RuntimeError(f"node {i} is not running")
        self.metrics.counter("proc_sigterms").inc()
        os.kill(child.proc.pid, signal.SIGTERM)
        try:
            rc = child.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            log.warning("node %d ignored SIGTERM for %.0fs; escalating",
                        i, timeout_s)
            os.kill(child.proc.pid, signal.SIGKILL)
            rc = child.proc.wait()
        child.last_exit = rc
        child.proc = None
        log.info("node %d stopped (rc=%d)", i, rc)
        return rc

    def restart(self, i: int) -> None:
        """Respawn a down node; it resumes from its on-disk checkpoint
        store (stale by up to checkpoint_every epochs + whatever
        committed while it was down — the recovery flows' job)."""
        child = self.children[i]
        if child.alive:
            raise RuntimeError(f"node {i} is still running")
        child.restarts += 1
        self.metrics.counter("proc_restarts").inc()
        self.spawn(i)

    def stop_all(self, timeout_s: float = GRACEFUL_STOP_TIMEOUT_S) -> Dict[int, int]:
        """SIGTERM every live child (concurrently — sequential waits
        would stack timeouts), collect exit codes."""
        live = [c for c in self.children if c.alive]
        for c in live:
            self.metrics.counter("proc_sigterms").inc()
            os.kill(c.proc.pid, signal.SIGTERM)
        rcs: Dict[int, int] = {}
        deadline = time.monotonic() + timeout_s
        for c in live:
            left = max(0.1, deadline - time.monotonic())
            try:
                rc = c.proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                os.kill(c.proc.pid, signal.SIGKILL)
                rc = c.proc.wait()
            c.last_exit = rc
            c.proc = None
            rcs[c.index] = rc
        return rcs

    # -- health watchdog ------------------------------------------------------

    def poll(self) -> List[int]:
        """Reap unexpected child deaths and apply the restart policy.
        Returns the indexes that died since the last poll (scheduled
        kills never appear here: kill()/terminate() reap inline)."""
        died: List[int] = []
        for child in self.children:
            if child.proc is None or child.proc.poll() is None:
                continue
            child.last_exit = child.proc.returncode
            child.proc = None
            died.append(child.index)
            self.metrics.counter("proc_unexpected_exits").inc()
            log.warning(
                "node %d exited unexpectedly (rc=%s)",
                child.index, child.last_exit,
            )
            if self.restart_policy.should_restart(
                child.last_exit, child.restarts
            ):
                time.sleep(self.restart_policy.backoff_s)
                self.restart(child.index)
        return died

    # -- the JSONL feeds ------------------------------------------------------

    def _feed(self, path: str) -> _JsonlFeed:
        feed = self._feeds.get(path)
        if feed is None:
            feed = self._feeds[path] = _JsonlFeed(path)
        return feed

    def summaries(self, i: int) -> List[dict]:
        """Every parseable summary line node ``i``'s incarnations wrote
        (incrementally read; see _JsonlFeed)."""
        return self._feed(self.children[i].metrics_path).poll()

    def last_summary(self, i: int) -> Optional[dict]:
        lines = self.summaries(i)
        return lines[-1] if lines else None

    def _last_per_pid(self, i: int) -> List[dict]:
        """The final summary line of each incarnation of node ``i`` —
        counters reset at restart, so consumers SUM these, never take
        the file's overall last line."""
        per_pid: Dict[int, dict] = {}
        for line in self.summaries(i):
            per_pid[line.get("pid", 0)] = line
        return list(per_pid.values())

    def batches(self, i: int) -> List[dict]:
        """Committed-batch rows across every incarnation of node ``i``
        (same append-mode file, so the feed survives restarts)."""
        return self._feed(self.children[i].batch_log_path).poll()

    def frontier(self, i: int) -> int:
        """Highest committed epoch node ``i`` ever logged (-1 = none)."""
        feed = self._feed(self.children[i].batch_log_path)
        feed.poll()
        return feed.max_epoch

    def health(self) -> List[dict]:
        now = time.time()
        report = []
        for child in self.children:
            s = self.last_summary(child.index)
            # feed freshness compares against the HONEST host clock
            # (t_host) — the skewed node clock in `t` is the
            # aggregator's anchor, and measuring staleness with it
            # would make a skewed-fast node's feed look eternally
            # fresh.  A pre-r14 feed without t_host reports None
            # (honestly unknown) rather than falling back to the
            # skewed `t`: wall minus skewed-wall measures the injected
            # skew, not the age (lint clock-domain).
            report.append(
                {
                    "node": child.index,
                    "alive": child.alive,
                    "restarts": child.restarts,
                    "last_exit": child.last_exit,
                    "state": s.get("state") if s else None,
                    "summary_age_s": (
                        round(now - s["t_host"], 2)
                        if s and "t_host" in s else None
                    ),
                    "frontier": self.frontier(child.index),
                }
            )
        return report

    # -- flight black boxes ----------------------------------------------------

    def flight_dumps(self, i: int):
        """Every loadable flight dump node ``i``'s incarnations left
        (pid-tagged paths; torn/corrupt generations rejected with
        fallback to ``.1``).  Returns (payloads, rejected_paths)."""
        import glob as _glob

        from ..obs.flight import load_flight_with_fallback

        payloads, rejected = [], []
        for path in sorted(
            _glob.glob(self.children[i].flight_prefix + ".*.json")
        ):
            payload, rej = load_flight_with_fallback(path)
            rejected.extend(rej)
            if payload is not None:
                payloads.append(payload)
        return payloads, rejected

    def killed_flight_dump(self, i: int):
        """The black box of node ``i``'s most recently SIGKILLed
        incarnation (None if the kill outran every dump — a contract
        violation the harness asserts against)."""
        pids = set(self.children[i].killed_pids)
        payloads, _rej = self.flight_dumps(i)
        for payload in payloads:
            if payload.get("pid") in pids:
                return payload
        return None

    # -- device work ------------------------------------------------------------

    def device_work(self, i: int) -> List[dict]:
        """Per incarnation of node ``i`` (its last summary line): the pid,
        the wire-signature batches and lanes on the card, and the kernel
        launches it made."""
        return [
            {
                "pid": line.get("pid", 0),
                "verify_batches": line.get("counters", {}).get(VERIFY_DEVICE_BATCHES, 0),
                "verify_lanes": line.get("counters", {}).get(VERIFY_DEVICE_LANES, 0),
                "launches": dict(line.get("launches", {})),
            }
            for line in self._last_per_pid(i)
        ]

    # -- the contract ----------------------------------------------------------

    def arm_skew(self) -> None:
        """Record the configured clock skews as injections (once, when
        the harness arms): the contract row then carries what timing
        chaos actually ran."""
        for child in self.children:
            if child.env_extra:
                self.log.note(T.BYZ_CLOCK_SKEW)

    def merged_metrics(self) -> MetricsRegistry:
        """Fold every incarnation's LAST summary into one registry.
        Counters reset at restart, so lines are grouped by pid and each
        incarnation's final line summed; gauges keep the worst
        high-water.  The supervisor's own counters (kills, restarts,
        injections) fold in last."""
        merged = MetricsRegistry()
        for i in range(self.n):
            for line in self._last_per_pid(i):
                for name, v in line.get("counters", {}).items():
                    merged.counter(name).inc(v)
                for name, hw in line.get("gauges", {}).items():
                    merged.gauge(name).track(hw)
        snap = self.metrics.snapshot()
        for name, v in snap.get("counters", {}).items():
            merged.counter(name).inc(v)
        return merged

    def merged_sketches(self):
        """Fold every incarnation's latency sketches into one
        ``{span: LatencySketch}`` map.  Same grouping discipline as
        merged_metrics — sketches reset at restart, so each pid's LAST
        feed is merged, which is exactly what makes the distribution
        complete across a SIGKILL: the killed incarnation's final
        summary still carries everything it measured.  A drift-rate
        node's durations are divided back by its rate before merging
        (offsets cancel inside durations; rates don't)."""
        from ..obs.latency import merge_sketch_dicts

        feeds, rates = [], {}
        for i in range(self.n):
            _offset, rate = self.clock_skew.get(i, (0.0, 1.0))
            rates[str(i)] = rate
            for line in self._last_per_pid(i):
                sketches = line.get("sketches")
                if sketches:
                    feeds.append(dict(sketches, node=str(i)))
        return merge_sketch_dicts(feeds, rates)

    def fault_entries(self) -> List[tuple]:
        """Every child fault-ring kind, shaped for the sim verifier
        ((node, fault-with-.kind) tuples).  The ring rides the summary
        lines whole, so the latest line per incarnation carries that
        incarnation's full (bounded) ring."""
        out: List[tuple] = []
        for i in range(self.n):
            for line in self._last_per_pid(i):
                for kind in line.get("faults", []):
                    out.append((line.get("node", str(i)), WireFault(kind)))
        return out

    def verify(self) -> List[str]:
        """The process-tier fault-observability contract: every kind
        the supervisor injected (SIGKILLs, clock skew) must have
        surfaced in the children's summaries — for BYZ_CRASH that means
        a recovery trace (welcome-back replay, f+1 frontier
        fast-forward, or observer re-adoption); a kill the cluster
        silently absorbed-without-recovering fails.  Returns
        violations; empty means the contract holds."""
        merged = self.merged_metrics()
        faults = self.fault_entries()
        fold_fault_counters(
            faults, merged,
            injected=set(self.log.counts),
            registry=PROC_FAULT_OBSERVABLES,
        )
        return verify_observability(
            self.log, faults, merged, registry=PROC_FAULT_OBSERVABLES
        )


def verify_process_scenario(sup: ClusterSupervisor) -> List[str]:
    return sup.verify()


def assert_process_scenario(sup: ClusterSupervisor) -> None:
    violations = sup.verify()
    if violations:
        raise AssertionError(
            "process-tier observability contract violated:\n  "
            + "\n  ".join(violations)
        )


# -- the canonical harness -----------------------------------------------------


def _log_tail(path: str, nbytes: int = 2000) -> str:
    try:
        with open(path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            fh.seek(max(0, fh.tell() - nbytes))
            return fh.read().decode(errors="replace")
    except OSError:
        return ""


def _wait(pred, what: str, timeout_s: float, sup: ClusterSupervisor,
          poll_s: float = 0.2):
    """Poll `pred` with the watchdog riding every tick.  A child that died
    and stays down (its restart policy declined) fails the wait at once,
    with its exit code and the tail of its log: a child that could not
    reach the card is reported, not waited out."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        down = [i for i in sup.poll() if not sup.children[i].alive]
        if down:
            c = sup.children[down[0]]
            raise AssertionError(
                f"node {c.index} exited rc={c.last_exit} while waiting for {what} "
                f"(engine {sup.engine}, device {sup.device}); its log ends:\n"
                f"{_log_tail(c.stdout_path)}"
            )
        if pred():
            return
        time.sleep(poll_s)
    raise AssertionError(
        f"timed out waiting for {what} after {timeout_s:.0f}s "
        f"(health: {sup.health()})"
    )


def run_process_chaos(
    n: int = 4,
    epochs: int = 6,
    base_port: int = 3970,
    workdir: Optional[str] = None,
    fast_crypto: bool = True,
    txn_interval_ms: int = 150,
    checkpoint_every: int = 1,
    kills: Optional[Tuple[KillSpec, ...]] = None,
    clock_skew: Optional[Dict[int, Tuple[float, float]]] = None,
    seed: int = 0,
    deadline_s: float = 420.0,
    engine: str = "gpu",
    device: str = "cuda",
) -> dict:
    """The acceptance scenario, end to end at the PROCESS tier: an
    ``n``-process cluster bootstraps its DKG over real sockets, the kill
    schedule SIGKILLs a validator mid-era and restarts it from its
    on-disk checkpoint, honest-quorum liveness and cross-process batch
    agreement are asserted, every child is stopped gracefully (exit 0 =
    the SIGTERM contract), and the process-tier observability contract
    is verified.  By default one untouched node also runs with skewed
    timers (+30 s offset, 1.25x drift) so every canonical capture
    proves the replay/backoff plane holds under clock chaos — pass
    ``clock_skew={}`` for an all-honest-clock run.  Returns the report
    row (bench config 13 / the soak process tier).  Every child runs
    ``engine`` on ``device``; the row's ``device_work`` lists, per node and
    incarnation, the wire-signature batches and lanes on the card and the
    kernel launches the children made."""
    import tempfile

    from ..sim.soak import rss_mb

    if workdir is None:
        workdir = tempfile.mkdtemp(prefix="hbtpu-proc-chaos-")
    else:
        # a reused workdir (CI gate scratch) must not leak a previous
        # run's checkpoints/feeds into this one: a stale checkpoint
        # would resume node 0 mid-history and every assertion after it
        # would be measuring the wrong scenario
        os.makedirs(workdir, exist_ok=True)
        for name in os.listdir(workdir):
            if name.startswith("node"):
                try:
                    os.unlink(os.path.join(workdir, name))
                except OSError:
                    pass
    if kills is None:
        # one mid-era SIGKILL of node 1, restarted 3 s later from disk
        kills = (KillSpec(at_s=2.0, node=1, sig="kill", restart_after_s=3.0),)
    if clock_skew is None and n > 2:
        clock_skew = {2: (30.0, 1.25)}
    sup = ClusterSupervisor(
        n=n, base_port=base_port, workdir=workdir,
        fast_crypto=fast_crypto, txn_interval_ms=txn_interval_ms,
        checkpoint_every=checkpoint_every, seed=seed,
        clock_skew=clock_skew,
        # scheduled kills own their restarts; anything else dying is a
        # bug we want VISIBLE, not papered over
        restart_policy=RestartPolicy(mode="never"),
        engine=engine, device=device,
    )
    rss0 = rss_mb()
    t_start = time.monotonic()

    def deadline_left() -> float:
        left = deadline_s - (time.monotonic() - t_start)
        if left <= 0:
            raise AssertionError("process chaos harness exceeded its deadline")
        return left

    # The children live in their own sessions, so a SIGTERM to THIS
    # process (a CI `timeout` expiring) would by default kill the
    # harness without its finally — orphaning n consensus processes
    # that spin forever and squat the ports.  Convert SIGTERM into
    # SystemExit so the cleanup below always runs; restored on exit.
    prev_term = None

    def _on_term(_sig, _frame):
        raise SystemExit(143)

    try:
        prev_term = signal.signal(signal.SIGTERM, _on_term)
    except ValueError:
        pass  # non-main thread: caller owns signal handling

    try:
        sup.start_all()
        _wait(
            lambda: all(
                (sup.last_summary(i) or {}).get("state") == "validator"
                for i in range(n)
            ),
            "bootstrap DKG across processes", min(180.0, deadline_left()), sup,
        )
        _wait(
            lambda: all(sup.frontier(i) >= 1 for i in range(n)),
            "first committed batches", min(120.0, deadline_left()), sup,
        )
        sup.arm_skew()
        armed_t = time.monotonic()
        killed_nodes = {k.node for k in kills}
        alive_idx = [i for i in range(n) if i not in killed_nodes]
        watch = alive_idx[0] if alive_idx else 0
        base_frontier = {i: sup.frontier(i) for i in range(n)}

        # -- run the kill schedule -------------------------------------------
        # key= keeps ties orderable: two kills at the same instant would
        # otherwise fall through tuple comparison into KillSpec < KillSpec
        events = sorted(
            [(k.at_s, "kill", k) for k in kills]
            + [
                (k.at_s + k.restart_after_s, "restart", k)
                for k in kills
                if k.restart_after_s is not None
            ],
            key=lambda e: (e[0], e[1], e[2].node),
        )
        recovery: Dict[int, dict] = {}
        for at_s, action, k in events:
            _wait(
                lambda: time.monotonic() - armed_t >= at_s,
                f"schedule point +{at_s:.1f}s", deadline_left(), sup,
                poll_s=0.05,
            )
            if action == "kill":
                if k.sig == "term":
                    rc = sup.terminate(k.node)
                    assert rc == 0, (
                        f"graceful stop of node {k.node} exited rc={rc}"
                    )
                else:
                    recovery[k.node] = {"killed_at_frontier": sup.frontier(k.node)}
                    sup.kill(k.node)
            else:
                sup.restart(k.node)
                if k.node in recovery:
                    recovery[k.node]["restarted_t"] = time.monotonic()

        # -- recovery: every SIGKILLed+restarted node catches up -------------
        # (checked after the whole schedule has run, so in a ROLLING
        # schedule an early node's catch-up stamp is an upper bound —
        # it may have caught up while later kills were still firing;
        # the single-kill canonical scenario measures exactly)
        for node_i, info in recovery.items():
            if "restarted_t" not in info:
                continue

            def caught_up(node_i=node_i, info=info) -> bool:
                target = max(
                    sup.frontier(j) for j in range(n)
                    if j != node_i and sup.children[j].alive
                )
                mine = sup.frontier(node_i)
                return mine > info["killed_at_frontier"] and mine >= target - 1

            _wait(
                caught_up, f"node {node_i} crash-recovery catch-up",
                min(240.0, deadline_left()), sup,
            )
            info["catchup_s"] = time.monotonic() - info["restarted_t"]

        # -- liveness target under fault --------------------------------------
        _wait(
            lambda: all(
                sup.frontier(i) - base_frontier[i] >= epochs
                for i in alive_idx
            ),
            f"{epochs} committed epochs under fault",
            deadline_left(), sup,
        )
        wall_s = time.monotonic() - armed_t

        # -- graceful stop: the SIGTERM contract ------------------------------
        rcs = sup.stop_all()
        bad = {i: rc for i, rc in rcs.items() if rc != 0}
        assert not bad, f"graceful stops exited nonzero: {bad}"
        # every stopped validator left a loadable durable checkpoint
        from ..checkpoint import CheckpointStore

        for i in range(n):
            ck = CheckpointStore(sup.children[i].ckpt_path).load()
            assert ck is not None, f"node {i} left no loadable checkpoint"

        # -- cross-process agreement ------------------------------------------
        by_epoch: Dict[int, str] = {}
        pk_by_era: Dict[int, str] = {}
        agreement_ok = True
        for i in range(n):
            for row in sup.batches(i):
                d = by_epoch.setdefault(row["epoch"], row["digest"])
                if d != row["digest"]:
                    agreement_ok = False
                # pk_era, not the batch's era: around a cutover a node
                # logs a previous-era batch with the NEXT era's pk_set
                # already installed
                pk_era = row.get("pk_era", row["era"])
                pk = pk_by_era.setdefault(pk_era, row["pk_set"])
                if pk != row["pk_set"]:
                    agreement_ok = False
        assert agreement_ok, (
            "processes committed diverging batches or pk_sets"
        )

        # -- commit-gap under fault (the watch node's batch timestamps) -------
        # host-clock stamps (t_host): a skewed watch node's drift rate
        # must not inflate/deflate the headline gap metric
        times = sorted(
            row.get("t_host", row["t"]) for row in sup.batches(watch)
            if row["epoch"] > base_frontier[watch]
        )
        gaps = [b - a for a, b in zip(times, times[1:])]
        commit_gap_max_s = max(gaps) if gaps else None

        # -- the cluster timeline -----------------------------------------------
        # merge every feed the run left — trace dumps, flight black
        # boxes, batch logs — into one skew-corrected timeline; the
        # killed node's dump and >= 1 attributed critical path are part
        # of the acceptance contract
        from ..obs.aggregate import aggregate_dir

        timeline = aggregate_dir(workdir)
        for node_i in {k.node for k in kills if k.sig == "kill"}:
            assert sup.killed_flight_dump(node_i) is not None, (
                f"SIGKILLed node {node_i} left no loadable flight dump "
                "(black-box contract)"
            )
        attributed = [
            r for r in timeline["epochs"] if r["critical_stage"] != "unknown"
        ]
        assert attributed, (
            "cluster timeline attributed no epoch's critical path"
        )

        # -- the latency plane: cross-node, cross-incarnation merge -----------
        # each pid's LAST summary line carries that incarnation's full
        # sketch, so the fold below is complete across the SIGKILL: the
        # killed incarnation's measurements survive in its final
        # periodic feed, and the merged distribution must account for
        # every sample any incarnation ever reported
        feed_counts: List[int] = []
        killed_incarnations = 0
        for i in range(n):
            lines = sup._last_per_pid(i)
            if i in {k.node for k in kills if k.sig == "kill"}:
                killed_incarnations = max(killed_incarnations, len(lines))
            for line in lines:
                e2e_feed = (line.get("sketches") or {}).get("e2e") or {}
                feed_counts.append(int(e2e_feed.get("count", 0)))
        lat = sup.merged_sketches()
        e2e_sketch = lat.get("e2e")
        assert e2e_sketch is not None and e2e_sketch.count > 0, (
            "process tier measured no submit->commit latency"
        )
        assert e2e_sketch.count == sum(feed_counts), (
            f"cross-incarnation sketch merge dropped samples: merged "
            f"{e2e_sketch.count} vs {sum(feed_counts)} across feeds"
        )
        if any(
            k.sig == "kill" and k.restart_after_s is not None for k in kills
        ):
            assert killed_incarnations >= 2, (
                "SIGKILLed+restarted node left fewer than two "
                "incarnation feeds — the latency merge cannot be "
                "cross-incarnation"
            )

        # -- the contract ------------------------------------------------------
        assert_process_scenario(sup)
        rss1 = rss_mb()
        merged = sup.merged_metrics().snapshot()["counters"]
        committed = min(
            sup.frontier(i) - base_frontier[i] for i in alive_idx
        )
        return {
            "tier": f"process_chaos_{n}node"
            + ("_fast" if fast_crypto else "_full_crypto"),
            "n_nodes": n,
            "epochs": committed,
            "wall_s": round(wall_s, 2),
            "epochs_per_sec": (
                round(committed / wall_s, 3) if wall_s else None
            ),
            "commit_gap_max_s": (
                round(commit_gap_max_s, 2)
                if commit_gap_max_s is not None else None
            ),
            "kills": [
                {
                    "node": k.node, "sig": k.sig, "at_s": k.at_s,
                    "restart_after_s": k.restart_after_s,
                }
                for k in kills
            ],
            "recovery_catchup_s": (
                round(
                    max(
                        info["catchup_s"] for info in recovery.values()
                        if "catchup_s" in info
                    ),
                    2,
                )
                if any("catchup_s" in v for v in recovery.values())
                else None
            ),
            "clock_skew": {
                str(i): list(v) for i, v in (clock_skew or {}).items()
            },
            "supervisor_rss_start_mb": round(rss0, 1),
            "supervisor_rss_end_mb": round(rss1, 1),
            "supervisor_rss_growth_mb": round(rss1 - rss0, 1),
            "byz_injected": dict(sup.log.counts),
            # cluster-timeline headline fields (obs/aggregate.py):
            # which node's which stage gated the committed epochs, with
            # the skew-corrected clock fits and the black-box census
            "epoch_critical_stage": timeline["epoch_critical_stage"],
            "straggler_node": timeline["straggler_node"],
            "msg_latency_p50_s": timeline["msg_latency_p50_s"],
            "msg_latency_p99_s": timeline["msg_latency_p99_s"],
            "commit_spread_max_s": timeline["commit_spread_max_s"],
            "epochs_attributed": len(attributed),
            "clock_alignment": timeline["clock"]["alignment"],
            "flight_dumps_found": len(timeline["flight"]["found"]),
            "flight_dumps_rejected": len(timeline["flight"]["rejected"]),
            "detections": {
                k: merged.get(k, 0)
                for k in (
                    "welcome_back_replays", "node_fast_forwards",
                    "observer_adoptions", "epoch_replays",
                    "checkpoints_persisted", "peer_disconnects",
                )
            },
            "agreement_ok": True,
            "contract_ok": True,
            "engine": engine,
            "device": device,
            "killed_pids": {
                str(k.node): list(sup.children[k.node].killed_pids)
                for k in kills if k.sig == "kill"
            },
            "device_work": {str(i): sup.device_work(i) for i in range(n)},
            # submit->commit latency, merged across nodes AND across the
            # killed node's incarnations (drift-rate corrected)
            "txn_latency": {
                "count": e2e_sketch.count,
                "p50_s": round(e2e_sketch.quantile(0.5), 6),
                "p99_s": round(e2e_sketch.quantile(0.99), 6),
                "incarnation_feeds": len(feed_counts),
                "killed_node_incarnations": killed_incarnations,
            },
        }
    finally:
        try:
            sup.stop_all(timeout_s=10.0)
        except Exception:
            pass
        if prev_term is not None:
            try:
                signal.signal(signal.SIGTERM, prev_term)
            except ValueError:
                pass


def main(argv=None) -> int:
    """Bounded process-chaos gate / manual runner: spawn the cluster,
    run the kill schedule, print the row, exit nonzero on any
    assertion."""
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--nodes", type=int, default=4)
    p.add_argument("--epochs", type=int, default=6)
    p.add_argument("--base-port", type=int, default=3970)
    p.add_argument("--workdir", default=None)
    p.add_argument(
        "--kill", action="append", default=[], metavar="AT:NODE[:SIG[:RESTART]]",
        help="schedule entry (repeatable); SIG kill|term; e.g. 2:1:kill:3 "
        "= at +2s SIGKILL node 1, restart from disk 3s later.  Default: "
        "one SIGKILL of node 1 at +2s, restart at +5s",
    )
    p.add_argument(
        "--rolling", type=int, default=None, metavar="K",
        help="staggered rolling kills of nodes 0..K-1 (4s apart, 2.5s "
        "down each) instead of --kill entries",
    )
    p.add_argument(
        "--skew", action="append", default=[], metavar="NODE:OFFSET[:RATE]",
        help="per-node clock skew (seconds offset, optional drift rate) "
        "injected via the child environment",
    )
    p.add_argument("--full-crypto", action="store_true")
    p.add_argument("--deadline", type=float, default=420.0)
    p.add_argument("--engine", choices=["gpu", "cpu"], default="gpu",
                   help="every child's crypto engine (gpu: the card, a child "
                   "without one exits nonzero)")
    p.add_argument("--device", default="cuda", help="the gpu engine's torch device")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    kills = tuple(parse_kill_spec(t) for t in args.kill) or None
    if args.rolling:
        kills = rolling_kills(
            min(args.rolling, args.nodes - 1), start_s=2.0,
            stagger_s=4.0, down_s=2.5,
        )
    skew: Dict[int, Tuple[float, float]] = {}
    for t in args.skew:
        parts = t.split(":")
        skew[int(parts[0])] = (
            float(parts[1]),
            float(parts[2]) if len(parts) > 2 else 1.0,
        )
    row = run_process_chaos(
        n=args.nodes, epochs=args.epochs, base_port=args.base_port,
        workdir=args.workdir, fast_crypto=not args.full_crypto,
        kills=kills, clock_skew=skew or None, deadline_s=args.deadline,
        engine=args.engine, device=args.device,
    )
    print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump([row], fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
