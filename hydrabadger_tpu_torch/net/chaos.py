"""Wire-tier chaos plane: link faults, adversarial TCP peers, recovery.

The port's copy of hydrabadger_tpu/net/chaos.py: the robustness twin of the
sim scenario plane (sim/scenario.py) at the layer that actually ships
packets.  Three planes, one observability contract:

  * **Link faults** — :class:`ChaosPlane` + :class:`ChaosWireStream`
    apply the sim's ``LinkPolicy``/``PartitionWindow`` taxonomy at the
    real socket boundary: frame drops, duplicates, delayed (reordered)
    deliveries, head-of-line stalls, connection resets and
    partition+heal on wall-clock windows.  The injector wraps the same
    asyncio streams ``net/peer.py``'s pump and ``net/node.py``'s read
    loops already use — one ``write()`` per frame keeps concurrent
    delayed releases frame-atomic.

  * **Adversarial peers** — :class:`ByzantineHydrabadger` runs a REAL
    ``net/`` node whose consensus core is wrapped in the sim's
    :class:`~hydrabadger_tpu_torch.sim.byzantine.ByzantineNode` strategy
    pipeline, so the attack catalog (garbage/withheld shares, replay
    floods, DKG corruption, equivocation) travels real sockets and
    drives the signature-verify, ``_resolve_duplicate``, ``_wire_retry``
    and replay-backoff paths the sim router bypasses.  Signature
    corruption (``LinkChaos.sig_corrupt``) is wire-only: the sim has no
    signatures to corrupt.

  * **Crash/restart** — ``Hydrabadger.crash()`` (SIGKILL emulation)
    plus ``Hydrabadger.from_checkpoint`` restart; recovery rides the
    existing join/observer flow (welcome-back epoch replay, the
    certified-frontier fast-forward, era-transcript share recovery).
    The port's ``crash()`` raises a device error its settle met, so a
    failing device call fails the run instead of passing as a fault.

The **fault-observability contract** is the sim's:
:data:`WIRE_FAULT_OBSERVABLES` maps every wire-injectable kind to the
observable that proves the system noticed or absorbed it — a node
``fault_log`` ring entry, a detection counter, or the injection counter
for kinds undetectable by design — and :func:`verify_wire_scenario`
re-uses the sim verifier's exclusive attribution.

:func:`chaos_cluster` takes the crypto engine (``engine``, default "gpu":
the card, which raises where there is none; ``device`` names the card) for
every node it builds.  The random draws are the JAX module's, in its
order, so one spec and seed make the same fault decisions.
"""
from __future__ import annotations

import asyncio
import random
import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..consensus import types as T
from ..crypto.engine import named_engine
from ..obs.logging import get_logger
from ..obs.metrics import (
    BYTES_RX_TOTAL,
    BYTES_TX_TOTAL,
    BYZ_FAULTS_PREFIX,
    MetricsRegistry,
)
from ..sim.scenario import (
    FAULT_OBSERVABLES,
    InjectionLog,
    LinkPolicy,
    ObsSpec,
    PartitionWindow,
    ScenarioSpec,
    verify_observability,
    fold_fault_counters,
)
from .node import Config, Hydrabadger
from .wire import VERIFIED_KINDS, WireError, WireMessage, WireStream

log = get_logger("hydrabadger_tpu_torch.net.chaos")


# -- the wire-tier observability registry ------------------------------------
#
# Protocol-detectable kinds inherit the sim's fault_log substring
# families (the cores emit the same kind strings on both planes; the
# node mirrors them into its fault ring).  Wire-only kinds declare the
# detection counters net/node.py stamps.  Link-fault kinds keep the
# sim's stance — injection-counted (an asynchronous system cannot
# distinguish a dropped frame from a late one) — but additionally list
# the healing machinery's counters so a report shows WHICH net caught
# them.
WIRE_FAULT_OBSERVABLES: Dict[str, ObsSpec] = dict(FAULT_OBSERVABLES)
WIRE_FAULT_OBSERVABLES.update(
    {
        T.BYZ_LINK_DROP: ObsSpec(
            counters=(
                BYZ_FAULTS_PREFIX + T.BYZ_LINK_DROP,
                "epoch_replays",
                "wire_retry_abandoned",
            )
        ),
        T.BYZ_PARTITION: ObsSpec(
            counters=(
                BYZ_FAULTS_PREFIX + T.BYZ_PARTITION,
                "epoch_replays",
            )
        ),
        T.BYZ_LINK_RESET: ObsSpec(counters=("peer_disconnects",)),
        T.BYZ_SIG_CORRUPT: ObsSpec(
            fault_any=("wire: bad signature",),
            counters=("wire_sig_rejected",),
        ),
        T.BYZ_CRASH: ObsSpec(
            # three recovery flows, by staleness: a barely-behind node
            # catches the in-flight epoch from its peers' welcome-back
            # replay; a wedged-behind node re-adopts the certified
            # frontier (fast-forward); a node the network voted out and
            # re-added recovers through observer adoption
            fault_any=("wire: fast-forward",),
            counters=(
                "node_fast_forwards",
                "observer_adoptions",
                "welcome_back_replays",
            ),
        ),
    }
)


# -- the declarative wire spec ------------------------------------------------


@dataclass(frozen=True)
class LinkChaos:
    """Per-link wire fault rates — the sim's ``LinkPolicy`` taxonomy
    re-expressed on the wall clock, plus the faults only a real socket
    can suffer.  ``delay`` holds a fraction of frames for a uniform
    0..``delay_s`` sleep on their own task (reordering, since later
    frames overtake); ``stall_s`` sleeps IN the pump (head-of-line
    stall, ordering preserved); ``reset`` tears the connection down
    mid-stream; ``sig_corrupt`` bit-flips the BLS signature of a
    verified-kind frame in flight."""

    drop: float = 0.0
    duplicate: float = 0.0
    delay: float = 0.0
    delay_s: float = 0.05
    stall: float = 0.0
    stall_s: float = 0.02
    reset: float = 0.0
    sig_corrupt: float = 0.0


@dataclass(frozen=True)
class WirePartition:
    """Hold all traffic crossing group boundaries between ``start_s``
    and ``heal_s`` seconds after the plane is armed.  Held frames are
    released at heal when their connection still lives; frames whose
    socket died meanwhile are lost (counted) — at the wire tier the
    retry/replay planes own loss healing, that is the point."""

    groups: Tuple[Tuple[int, ...], ...]
    start_s: float = 0.0
    heal_s: float = 1.0


@dataclass(frozen=True)
class WireChaosSpec:
    """One declarative wire-tier chaos scenario.  Link policies address
    nodes by INDEX (the harness's registration order, ``None`` = any),
    first match wins — the same routing contract as ScenarioSpec."""

    name: str = "wire_chaos"
    seed: int = 0
    default_link: LinkChaos = field(default_factory=LinkChaos)
    links: Tuple[Tuple[Optional[int], Optional[int], LinkChaos], ...] = ()
    partitions: Tuple[WirePartition, ...] = ()


def wire_spec_from_scenario(
    spec: ScenarioSpec, tick_s: float = 0.01
) -> WireChaosSpec:
    """Port a sim :class:`ScenarioSpec`'s link plane onto the wall
    clock: a delay of ``delay_max`` router deliveries becomes a hold of
    up to ``delay_max * tick_s`` seconds, and a partition window of
    enqueue counts becomes one of seconds at the same scale.  Byzantine
    node assignments do not port here — mount them by constructing
    :class:`ByzantineHydrabadger` nodes for the spec's indexes."""

    def link(pol: LinkPolicy) -> LinkChaos:
        return LinkChaos(
            drop=pol.drop,
            duplicate=pol.duplicate,
            delay=pol.delay,
            delay_s=max(tick_s, pol.delay_max * tick_s),
        )

    return WireChaosSpec(
        name=spec.name + "_wire",
        seed=spec.seed,
        default_link=link(spec.default_link),
        links=tuple((s, d, link(p)) for s, d, p in spec.links),
        partitions=tuple(
            WirePartition(
                groups=w.groups,
                start_s=w.start * tick_s,
                heal_s=(
                    w.start * tick_s + 1.0
                    if w.heal is None
                    else w.heal * tick_s
                ),
            )
            for w in spec.partitions
        ),
    )


# -- the plane ----------------------------------------------------------------


class ChaosPlane:
    """The shared fault injector of one wire-tier scenario.

    One plane serves every node of a (localhost, in-process) cluster:
    nodes register their uid -> index mapping, pass ``chaos=plane`` to
    ``Hydrabadger``, and every stream they open is wrapped in a
    :class:`ChaosWireStream` that consults this plane per frame.  The
    plane stays INERT until :meth:`arm` — bootstrap (discovery + DKG)
    runs clean, which mirrors the sim scenarios attacking a converged
    network, and partition windows are relative to the arm instant."""

    def __init__(self, spec: WireChaosSpec, metrics: Optional[MetricsRegistry] = None):
        self.spec = spec
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.rng = random.Random(spec.seed ^ 0x31C405)
        self.log = InjectionLog(self.metrics)
        self._index: Dict[bytes, int] = {}
        self.armed_at: Optional[float] = None
        self._tasks: set = set()

    # -- identity ------------------------------------------------------------

    def register(self, uid_bytes: bytes, index: int) -> None:
        self._index[bytes(uid_bytes)] = int(index)

    def index_of(self, uid_bytes: Optional[bytes]) -> int:
        if uid_bytes is None:
            return -1
        return self._index.get(bytes(uid_bytes), -1)

    # -- lifecycle -----------------------------------------------------------

    def arm(self) -> None:
        """Start injecting: policies activate, partition clocks start."""
        self.armed_at = _time.monotonic()

    def disarm(self) -> None:
        self.armed_at = None

    @property
    def armed(self) -> bool:
        return self.armed_at is not None

    async def drain(self) -> None:
        """Await every in-flight delayed/held delivery task (tests and
        harness teardown: no injection outlives the run)."""
        tasks = list(self._tasks)
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)

    def _spawn(self, coro) -> None:
        t = asyncio.create_task(coro)
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)

    # -- policy resolution ----------------------------------------------------

    def policy(self, s_idx: int, r_idx: int) -> LinkChaos:
        for src, dst, pol in self.spec.links:
            if (src is None or src == s_idx) and (dst is None or dst == r_idx):
                return pol
        return self.spec.default_link

    def partition_heal_at(self, s_idx: int, r_idx: int) -> Optional[float]:
        """Monotonic deadline when the partition severing this link
        heals, or None when the link is not currently severed."""
        if self.armed_at is None:
            return None
        now = _time.monotonic() - self.armed_at
        for win in self.spec.partitions:
            if not (win.start_s <= now < win.heal_s):
                continue
            s_grp = r_grp = None
            for g, members in enumerate(win.groups):
                if s_idx in members:
                    s_grp = g
                if r_idx in members:
                    r_grp = g
            if s_grp is not None and r_grp is not None and s_grp != r_grp:
                return self.armed_at + win.heal_s
        return None

    # -- stream wrapping -------------------------------------------------------

    def wrap_stream(
        self, reader, writer, secret_key, sign_frames: bool, local_uid: bytes
    ) -> "ChaosWireStream":
        return ChaosWireStream(
            reader, writer, secret_key, sign_frames,
            plane=self, local_uid=bytes(local_uid),
        )


class ChaosWireStream(WireStream):
    """A :class:`WireStream` whose ``send`` runs the link-fault
    pipeline.  Faults are applied on the SENDER side of each endpoint's
    own stream — both directions of a connection are covered because
    each end wraps its own half — and only to frames whose (sender,
    receiver) link the plane's policies address.  Before the peer
    authenticates (``peer_uid`` unset) the destination index is -1,
    matched only by ``None`` wildcards, so handshakes survive targeted
    policies by default."""

    def __init__(self, reader, writer, secret_key, sign_frames, *, plane, local_uid):
        super().__init__(reader, writer, secret_key, sign_frames)
        self.plane = plane
        self.local_uid = local_uid

    def _count_tx(self, frame: bytes) -> None:
        """Bandwidth accounting for the fault paths that bypass
        WireStream.send (delayed releases, corrupted frames,
        duplicates): injected traffic is wire traffic too."""
        if self.metrics is not None:
            self.metrics.counter(BYTES_TX_TOTAL).inc(len(frame))

    async def _send_after(self, delay_s: float, frame: bytes, lost_kind: str) -> None:
        try:
            await asyncio.sleep(delay_s)
            self._count_tx(frame)
            self.writer.write(frame)
            await self.writer.drain()
        except (ConnectionError, OSError, RuntimeError):
            # the connection died while we held the frame: at the wire
            # tier a hold CAN become a loss — the retry/replay planes
            # own healing it, the counter keeps it observable
            self.plane.metrics.counter(lost_kind).inc()

    async def send(self, msg: WireMessage) -> None:
        plane = self.plane
        if not plane.armed:
            await super().send(msg)
            return
        s_idx = plane.index_of(self.local_uid)
        r_idx = plane.index_of(self.peer_uid)
        pol = plane.policy(s_idx, r_idx)
        rng = plane.rng
        # signature corruption first: it changes the frame bytes
        if (
            pol.sig_corrupt
            and self.sign_frames
            and msg.kind in VERIFIED_KINDS
            and rng.random() < pol.sig_corrupt
        ):
            body = msg.encode()
            sig = bytearray(self.secret_key.sign(body).to_bytes())
            sig[rng.randrange(len(sig))] ^= 1 << rng.randrange(8)
            frame = self._assemble(body, bytes(sig))
            plane.log.note(T.BYZ_SIG_CORRUPT)
        else:
            frame = self._frame(msg)
        heal_at = plane.partition_heal_at(s_idx, r_idx)
        if heal_at is not None:
            plane.log.note(T.BYZ_PARTITION)
            plane._spawn(
                self._send_after(
                    max(0.0, heal_at - _time.monotonic()),
                    frame,
                    "chaos_partition_lost",
                )
            )
            return
        if pol.reset and rng.random() < pol.reset:
            plane.log.note(T.BYZ_LINK_RESET)
            self.close()
            raise WireError("chaos: connection reset")
        if pol.drop and rng.random() < pol.drop:
            plane.log.note(T.BYZ_LINK_DROP)
            return
        if pol.delay and rng.random() < pol.delay:
            plane.log.note(T.BYZ_LINK_DELAY)
            plane._spawn(
                self._send_after(
                    rng.uniform(0.0, pol.delay_s), frame, "chaos_delay_lost"
                )
            )
            return
        if pol.stall and rng.random() < pol.stall:
            # head-of-line stall: the PUMP sleeps, every queued frame
            # behind this one waits — a congested/choked link, not
            # reordering (that is what delay models)
            await asyncio.sleep(pol.stall_s)
        self._count_tx(frame)
        self.writer.write(frame)
        await self.writer.drain()
        if pol.duplicate and rng.random() < pol.duplicate:
            plane.log.note(T.BYZ_LINK_DUP)
            self._count_tx(frame)
            self.writer.write(frame)
            await self.writer.drain()


# -- the adversarial TCP peer --------------------------------------------------

# the default catalog mounted over real sockets.  ``equivocate`` is
# deliberately NOT here: splitting our own RBC coding is only
# liveness-safe while all n validators are up (the split instance can
# still be voted 0 once n-f OTHERS terminate); combined with a
# concurrent crash the two unterminated instances stall the subset at
# n=4.  Scenarios without a crash mount it explicitly.
DEFAULT_WIRE_STRATEGIES = (
    "withhold_shares",
    "garbage_shares",
    "replay_flood",
    "dkg_corrupt",
)


class ByzantineHydrabadger(Hydrabadger):
    """A real ``net/`` node that attacks: its consensus core is wrapped
    in the sim's ByzantineNode pipeline the moment it exists (bootstrap
    DKG completion, observer join, checkpoint restore), so every
    outgoing Step is corrupted BEFORE the wire plane signs it — a
    correctly-authenticated validator emitting Byzantine traffic,
    exactly the power model the signature plane cannot help against and
    the consensus cores must absorb."""

    def __init__(
        self,
        bind,
        config: Optional[Config] = None,
        strategies: Tuple[str, ...] = DEFAULT_WIRE_STRATEGIES,
        injection_log: Optional[InjectionLog] = None,
        byz_seed: int = 0,
        **kw,
    ):
        super().__init__(bind, config, **kw)
        self._byz_names = tuple(strategies)
        self.injection_log = (
            injection_log
            if injection_log is not None
            else InjectionLog(self.metrics)
        )
        self._byz_rng = random.Random(byz_seed * 7919 + 13)

    def _wrap_dhb(self, dhb):
        from ..sim import byzantine as byz

        return byz.ByzantineNode(
            dhb,
            byz.build_strategies(
                self._byz_names, self._byz_rng, self.injection_log
            ),
            log=self.injection_log,
        )


# -- the contract, ported ------------------------------------------------------


def merge_node_metrics(nodes, extra: Optional[MetricsRegistry] = None) -> MetricsRegistry:
    """Fold every node's registry (plus the plane's) into one: counters
    sum, gauges keep the worst high-water — the single registry the
    contract verifier reads."""
    merged = MetricsRegistry()
    registries = [n.metrics for n in nodes]
    if extra is not None:
        registries.append(extra)
    for reg in registries:
        snap = reg.snapshot()
        for name, v in snap.get("counters", {}).items():
            merged.counter(name).inc(v)
        for name, g in snap.get("gauges", {}).items():
            merged.gauge(name).track(g["high_water"])
    return merged


def verify_wire_scenario(plane: ChaosPlane, nodes) -> List[str]:
    """The fault-observability contract at the wire tier.

    ``nodes`` are the run's live Hydrabadger instances (include the
    restarted incarnation of a crashed node, and its pre-crash
    incarnation if its metrics should count).  Every fault kind the
    plane (or a Byzantine peer sharing its InjectionLog) injected must
    have surfaced: a fault-ring entry attributed by the sim verifier's
    exclusive rules, a detection counter, or the declared injection
    counter.  Returns violations; empty means the contract holds."""
    merged = merge_node_metrics(nodes, plane.metrics)
    faults: List[tuple] = []
    for n in nodes:
        faults.extend(n.fault_log)
    fold_fault_counters(
        faults,
        merged,
        injected=set(plane.log.counts),
        registry=WIRE_FAULT_OBSERVABLES,
    )
    return verify_observability(
        plane.log, faults, merged, registry=WIRE_FAULT_OBSERVABLES
    )


def assert_wire_scenario(plane: ChaosPlane, nodes) -> None:
    violations = verify_wire_scenario(plane, nodes)
    if violations:
        raise AssertionError(
            "wire-tier observability contract violated:\n  "
            + "\n  ".join(violations)
        )


# -- the canonical chaos cluster ----------------------------------------------


def default_wire_spec(
    n: int, byz_idx: Optional[int], wire_sign: bool, seed: int = 0
) -> WireChaosSpec:
    """The canonical 4-node scenario's link plane: mild drop/dup/delay
    everywhere, occasional resets, a 2 s half/half partition early in
    the armed window, and (when frames are signed) in-flight signature
    corruption on everything the Byzantine peer sends."""
    links: List[tuple] = []
    if byz_idx is not None and wire_sign:
        links.append(
            (byz_idx, None, LinkChaos(
                drop=0.01, duplicate=0.03, delay=0.08, delay_s=0.05,
                reset=0.002, sig_corrupt=0.25,
            ))
        )
    half = tuple(range(n // 2))
    rest = tuple(range(n // 2, n))
    return WireChaosSpec(
        name=f"wire_chaos_{n}n",
        seed=seed,
        default_link=LinkChaos(
            drop=0.01, duplicate=0.03, delay=0.08, delay_s=0.05,
            reset=0.002,
        ),
        links=tuple(links),
        partitions=(WirePartition(groups=(half, rest), start_s=1.0, heal_s=3.0),),
    )


def _batch_key(batch) -> tuple:
    items = []
    for p, v in sorted(batch.contributions.items()):
        items.append((bytes(p), bytes(v)))
    return (batch.epoch, tuple(items))


async def chaos_cluster(
    n: int = 4,
    f_byz: int = 1,
    epochs: int = 10,
    base_port: int = 3900,
    encrypt: bool = True,
    verify_shares: bool = True,
    coin_mode: str = "threshold",
    wire_sign: bool = True,
    strategies: Tuple[str, ...] = DEFAULT_WIRE_STRATEGIES,
    spec: Optional[WireChaosSpec] = None,
    crash: bool = True,
    crash_down_s: float = 4.0,
    seed: int = 0,
    deadline_s: float = 600.0,
    trace: bool = True,
    engine: str = "gpu",
    device: str = "cuda",
) -> dict:
    """The acceptance scenario, end to end: an ``n``-node localhost
    cluster with the last ``f_byz`` nodes Byzantine, link faults armed
    after bootstrap, one honest validator crash/restart'ed from a stale
    checkpoint, committed-epoch liveness + agreement + byte-identical
    recovery asserted, and the wire observability contract verified.
    Returns the report row (bench config 12 / the soak wire tier).
    Every node runs on ``engine`` ("gpu" on ``device``, or "cpu")."""
    t_start = _time.monotonic()

    def deadline_left() -> float:
        left = deadline_s - (_time.monotonic() - t_start)
        if left <= 0:
            raise AssertionError("chaos cluster exceeded its deadline")
        return left

    async def wait_for(pred, what: str, timeout: Optional[float] = None):
        budget = min(timeout or deadline_left(), deadline_left())
        t0 = _time.monotonic()
        while _time.monotonic() - t0 < budget:
            if pred():
                return
            await asyncio.sleep(0.05)
        raise AssertionError(f"timed out waiting for {what}")

    cfg = Config(
        txn_gen_interval_ms=150,
        keygen_peer_count=n - 1,
        encrypt=encrypt,
        coin_mode=coin_mode,
        verify_shares=verify_shares,
        wire_sign=wire_sign,
        engine=named_engine(engine, device),
    )
    byz_idx = n - 1 if f_byz else None
    if spec is None:
        spec = default_wire_spec(n, byz_idx, wire_sign, seed)
    plane = ChaosPlane(spec)
    from ..obs.recorder import Recorder
    from ..utils.ids import InAddr, OutAddr

    # one shared recorder (this harness is one process, one wall
    # clock), bound per node by each Hydrabadger: the row's cluster-
    # timeline fields (straggler node, gating stage, msg latency) come
    # from aggregating it.  trace=False measures without the per-frame
    # digest/stamp cost (the timeline fields then read None).
    rec = Recorder(clock_domain="wall") if trace else None
    gen = lambda count, size: [b"%02dx" % i * size for i in range(count)]  # noqa: E731
    nodes: List[Hydrabadger] = []
    for i in range(n):
        bind = InAddr("127.0.0.1", base_port + i)
        if f_byz and i >= n - f_byz:
            node = ByzantineHydrabadger(
                bind, cfg, strategies=strategies,
                injection_log=plane.log, byz_seed=seed + i,
                seed=seed * 1000 + i, chaos=plane, recorder=rec,
            )
        else:
            node = Hydrabadger(
                bind, cfg, seed=seed * 1000 + i, chaos=plane, recorder=rec
            )
        plane.register(node.uid.bytes, i)
        nodes.append(node)
    honest_idx = [i for i in range(n) if not (f_byz and i >= n - f_byz)]
    incarnations: List[Hydrabadger] = list(nodes)  # every node ever live

    try:
        for i, node in enumerate(nodes):
            remotes = [
                OutAddr("127.0.0.1", base_port + j)
                for j in range(n)
                if j != i
            ]
            await node.start(remotes, gen)
        await wait_for(
            lambda: all(m.is_validator() for m in nodes),
            "bootstrap DKG", timeout=120,
        )
        await wait_for(
            lambda: all(len(m.batches) >= 1 for m in nodes),
            "first committed batch", timeout=60,
        )

        # -- faults on ------------------------------------------------------
        plane.arm()
        armed_at = _time.monotonic()
        victim_i = honest_idx[1] if len(honest_idx) > 1 else honest_idx[0]
        # liveness is judged over honest nodes that are never crashed:
        # the victim's own count resets at restart by design
        alive_idx = [i for i in honest_idx if not crash or i != victim_i]
        base_committed = {i: len(nodes[i].batches) for i in alive_idx}
        watch = nodes[alive_idx[0]]  # always-alive honest observer
        commit_times: List[float] = []
        last_seen = len(watch.batches)

        def sample_commits() -> None:
            nonlocal last_seen
            now_len = len(watch.batches)
            if now_len > last_seen:
                commit_times.extend([_time.monotonic()] * (now_len - last_seen))
                last_seen = now_len

        def committed_since_arm() -> int:
            return min(
                len(nodes[i].batches) - base_committed[i] for i in alive_idx
            )

        ckpt = None
        restarted: Optional[Hydrabadger] = None
        crash_at_epoch = None
        restart_t = None
        recovery_catchup_s = None

        # phase 1: ride the partition window + link faults for a few commits
        async def commits(target: int, what: str, timeout=None):
            t0 = _time.monotonic()
            budget = min(timeout or deadline_left(), deadline_left())
            while _time.monotonic() - t0 < budget:
                sample_commits()
                if committed_since_arm() >= target:
                    return
                await asyncio.sleep(0.05)
            raise AssertionError(f"timed out waiting for {what}")

        await commits(2, "commits through the partition window", timeout=180)

        if crash:
            victim = nodes[victim_i]
            # checkpoint NOW, keep committing, crash LATER: the restart
            # resumes from a deliberately stale epoch so the certified-
            # frontier fast-forward (or removal + re-add) must do real
            # work — a checkpoint from the crash instant would hide the
            # whole recovery plane behind a lucky small gap.  (The
            # harness restarts from the captured object; the disk round
            # trip is checkpoint.py's.)
            ckpt = victim.checkpoint()
            await commits(4, "post-checkpoint commits", timeout=120)
            crash_at_epoch = max(
                (b.epoch for b in victim.batches), default=None
            )
            plane.log.note(T.BYZ_CRASH)
            await victim.crash()
            nodes[victim_i] = None  # type: ignore[call-overload]
            # keep sampling while the victim is down: the commit-gap
            # metric must time REAL stalls, not bunch every downtime
            # commit onto the first post-restart sample
            t_down = _time.monotonic()
            while _time.monotonic() - t_down < crash_down_s:
                sample_commits()
                await asyncio.sleep(0.05)
            restarted = Hydrabadger.from_checkpoint(
                InAddr("127.0.0.1", base_port + victim_i),
                ckpt,
                cfg,
                seed=seed * 1000 + victim_i + 500,
                chaos=plane,
                recorder=rec,
            )
            incarnations.append(restarted)
            nodes[victim_i] = restarted
            restart_t = _time.monotonic()
            await restarted.start(
                [
                    OutAddr("127.0.0.1", base_port + j)
                    for j in range(n)
                    if j != victim_i
                ],
                gen,
            )

            def caught_up() -> bool:
                sample_commits()
                if not restarted.batches:
                    return False
                frontier = max(
                    max((b.epoch for b in nodes[i].batches), default=0)
                    for i in honest_idx
                    if i != victim_i
                )
                return restarted.batches[-1].epoch >= frontier - 1

            await wait_for(caught_up, "crash recovery catch-up", timeout=240)
            recovery_catchup_s = _time.monotonic() - restart_t

        await commits(epochs, f"{epochs} committed epochs under fault", timeout=300)
        wall_s = _time.monotonic() - armed_at
        plane.disarm()

        # -- liveness + agreement -------------------------------------------
        sample_commits()
        gaps = [
            b - a for a, b in zip(commit_times, commit_times[1:])
        ]
        if commit_times:
            gaps.append(commit_times[0] - armed_at)
        commit_gap_max_s = max(gaps) if gaps else None
        # byte-identical agreement over every epoch two honest nodes
        # both committed — including the crashed incarnation's history
        # and the recovered node's post-restart batches
        by_epoch: Dict[int, tuple] = {}
        agreement_ok = True
        for m in incarnations:
            if m is None or isinstance(m, ByzantineHydrabadger):
                continue
            for b in m.batches:
                key = _batch_key(b)
                if b.epoch in by_epoch and by_epoch[b.epoch] != key:
                    agreement_ok = False
                by_epoch[b.epoch] = key
        assert agreement_ok, "honest nodes committed diverging batches"
        if restarted is not None:
            assert restarted.batches, "recovered node never committed"

        committed = committed_since_arm()
        # settle window: an injection made moments before the commit
        # target (dkg_corrupt stuffed into a just-started era switch,
        # a garbage share still in flight) needs its protocol round
        # trip to be DETECTED — keep the cluster alive until the
        # contract is satisfied or the bounded grace expires, then
        # assert.  The contract stays strict: faults must surface, the
        # harness just must not shut the system down mid-detection.
        live = [m for m in incarnations if m is not None]
        t_settle = _time.monotonic()
        while (
            verify_wire_scenario(plane, live)
            and _time.monotonic() - t_settle < 45.0
        ):
            sample_commits()  # keep commit timestamps honest here too
            await asyncio.sleep(0.5)
        sample_commits()
        for m in nodes:
            if m is not None:
                await m.stop()
        await plane.drain()

        # -- the cluster timeline ---------------------------------------------
        # one shared recorder, one clock: no alignment pass — straight
        # to critical-path + message-latency attribution
        from ..obs.aggregate import aggregate_events

        timeline = (
            aggregate_events(list(rec.events)) if rec is not None else {}
        )

        # -- the contract ----------------------------------------------------
        assert_wire_scenario(plane, live)
        merged = merge_node_metrics(live, plane.metrics)
        fold_fault_counters(
            [f for m in live for f in m.fault_log],
            merged,
            injected=set(plane.log.counts),
            registry=WIRE_FAULT_OBSERVABLES,
        )
        snap = merged.snapshot()["counters"]
        return {
            "tier": f"tcp_wire_chaos_{n}node" + ("_full_crypto" if encrypt else "_fast"),
            "n_nodes": n,
            "n_byzantine": f_byz,
            "epochs": committed,
            "wall_s": round(wall_s, 2),
            "epochs_per_sec": round(committed / wall_s, 3) if wall_s else None,
            "commit_gap_max_s": (
                round(commit_gap_max_s, 2) if commit_gap_max_s else None
            ),
            "crash": bool(crash),
            "crash_at_epoch": crash_at_epoch,
            "crash_down_s": crash_down_s if crash else None,
            "recovery_catchup_s": (
                round(recovery_catchup_s, 2)
                if recovery_catchup_s is not None
                else None
            ),
            # bandwidth: framed bytes across every
            # incarnation's WireStreams, and per committed epoch — the
            # real-socket sibling of the sim's metered-router figure
            "bytes_tx_total": snap.get(BYTES_TX_TOTAL, 0),
            "bytes_rx_total": snap.get(BYTES_RX_TOTAL, 0),
            "bytes_per_epoch": (
                round(snap.get(BYTES_TX_TOTAL, 0) / committed)
                if committed
                else None
            ),
            "byz_injected": dict(plane.log.counts),
            # cluster-timeline headline fields (obs/aggregate.py):
            # which node's which stage gated the epochs committed under
            # fault, and the wire-event message latency tail the chaos
            # plane's delays/stalls actually produced (None on
            # trace=False runs)
            "timeline_traced": bool(trace),
            "epoch_critical_stage": timeline.get("epoch_critical_stage"),
            "straggler_node": timeline.get("straggler_node"),
            "msg_latency_p50_s": timeline.get("msg_latency_p50_s"),
            "msg_latency_p99_s": timeline.get("msg_latency_p99_s"),
            "commit_spread_max_s": timeline.get("commit_spread_max_s"),
            "epochs_attributed": timeline.get("epochs_attributed"),
            "byz_faults": {
                k: v for k, v in sorted(snap.items())
                if k.startswith(BYZ_FAULTS_PREFIX)
            },
            "detections": {
                k: snap.get(k, 0)
                for k in (
                    "wire_sig_rejected", "peer_disconnects",
                    "node_fast_forwards", "observer_adoptions",
                    "welcome_back_replays", "epoch_replays",
                    "wire_retry_abandoned", "consensus_faults",
                )
            },
            "agreement_ok": True,
            "contract_ok": True,
        }
    finally:
        for m in nodes:
            if m is not None and not m._stopped.is_set():
                try:
                    await m.stop()
                except Exception:
                    pass
        await plane.drain()


def run_chaos_cluster(**kw) -> dict:
    """Sync wrapper: one event loop per run (bench/soak/CLI entry)."""
    return asyncio.run(chaos_cluster(**kw))


def main(argv=None) -> int:
    """Bounded wire-chaos gate: run the canonical scenario, print the row,
    exit nonzero on any assertion."""
    import argparse
    import json

    p = argparse.ArgumentParser(
        prog="python -m hydrabadger_tpu_torch.net.chaos", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--nodes", type=int, default=4)
    p.add_argument("--base-port", type=int, default=3900)
    p.add_argument("--no-crash", action="store_true")
    p.add_argument(
        "--no-trace", action="store_true",
        help="skip the cluster-timeline recorder (no per-frame digest "
        "and stamp cost; timeline row fields read None)",
    )
    p.add_argument("--engine", choices=["gpu", "cpu"], default="gpu",
                   help="every node's crypto engine (gpu raises without a card)")
    p.add_argument("--device", default="cuda", help="the gpu engine's torch device")
    p.add_argument("--fast", action="store_true",
                   help="fast crypto tier (no encryption/threshold coin); "
                   "drops the share-forging strategies that need the "
                   "verify plane")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    kw: dict = dict(
        n=args.nodes, epochs=args.epochs, base_port=args.base_port,
        crash=not args.no_crash, trace=not args.no_trace,
        engine=args.engine, device=args.device,
    )
    if args.fast:
        kw.update(
            encrypt=False, verify_shares=False, coin_mode="hash",
            strategies=("replay_flood",),
        )
    row = run_chaos_cluster(**kw)
    print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump([row], fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
