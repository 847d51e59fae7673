"""The port's wire chaos plane (net/chaos.py) against the JAX package's.

The non-slow cases of JAX tests/test_wire_chaos.py on the port's node and
plane, on the host engine: the plane's policy and partition resolution, a
sim spec ported to the wall clock, link faults on a real localhost socket
(every wait bounded, the client closed before the server waits), the wire
observability contract, bounded wire retry, the certified-frontier
fast-forward, a crash and restart from a checkpoint, the chaos cluster at
the fast tier, an equivocating peer over TCP in both broadcast variants,
and the stalled-handshake cull.  Across the packages: the same spec, seed
and keys over a scripted frame sequence make the same drop, duplicate,
delay, reset, signature-corruption and partition decisions, and
WIRE_FAULT_OBSERVABLES is equal.  Localhost ports 15600-15699.
"""
import asyncio
import random

import pytest
import torch

from hydrabadger_tpu.crypto import threshold as jth
from hydrabadger_tpu.net import chaos as jchaos
from hydrabadger_tpu.net import wire as jwire
from hydrabadger_tpu_torch.consensus import types as T
from hydrabadger_tpu_torch.crypto import threshold as th
from hydrabadger_tpu_torch.net import chaos
from hydrabadger_tpu_torch.net import wire as twire
from hydrabadger_tpu_torch.net.chaos import (
    ChaosPlane,
    LinkChaos,
    WireChaosSpec,
    WirePartition,
    verify_wire_scenario,
    wire_spec_from_scenario,
)
from hydrabadger_tpu_torch.net.node import WIRE_RETRY_CAP, Config, Hydrabadger, WireFault
from hydrabadger_tpu_torch.net.wire import WireError, WireMessage
from hydrabadger_tpu_torch.obs.metrics import MetricsRegistry
from hydrabadger_tpu_torch.sim.scenario import LinkPolicy, ScenarioSpec
from hydrabadger_tpu_torch.utils.ids import InAddr, OutAddr, Uid

BASE_PORT = 15600
WAIT_S = 5.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def fast_config(**kw):
    defaults = dict(txn_gen_interval_ms=120, keygen_peer_count=3, encrypt=False, coin_mode="hash",
                    verify_shares=False, wire_sign=False, engine="cpu")
    defaults.update(kw)
    return Config(**defaults)


def gen_txns(count, nbytes):
    rng = random.Random()
    return [bytes(rng.getrandbits(8) for _ in range(max(nbytes, 1))) for _ in range(count)]


async def wait_for(pred, timeout=30.0, interval=0.05):
    loop = asyncio.get_event_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        if pred():
            return True
        await asyncio.sleep(interval)
    return False


# -- plane mechanics ----------------------------------------------------------


def test_policy_resolution_first_match_wins():
    spec = WireChaosSpec(
        links=((0, 1, LinkChaos(drop=0.5)), (0, None, LinkChaos(duplicate=0.5)),
               (None, None, LinkChaos(delay=0.5))),
        default_link=LinkChaos(),
    )
    plane = ChaosPlane(spec)
    assert plane.policy(0, 1).drop == 0.5
    assert plane.policy(0, 2).duplicate == 0.5
    assert plane.policy(3, 0).delay == 0.5
    assert plane.policy(0, -1).duplicate == 0.5  # unauthenticated: wildcards only


def test_partition_window_on_wall_clock():
    plane = ChaosPlane(WireChaosSpec(
        partitions=(WirePartition(groups=((0, 1), (2, 3)), start_s=0.0, heal_s=60.0),)))
    assert plane.partition_heal_at(0, 2) is None  # inert until armed
    plane.arm()
    assert plane.partition_heal_at(0, 2) is not None  # cross-group severed
    assert plane.partition_heal_at(0, 1) is None  # same side
    assert plane.partition_heal_at(0, 9) is None  # outside the groups
    plane.disarm()
    assert plane.partition_heal_at(0, 2) is None


def test_wire_spec_from_scenario_ports_link_taxonomy():
    sim_spec = ScenarioSpec(name="s", default_link=LinkPolicy(drop=0.1, duplicate=0.2, delay=0.3,
                                                              delay_max=50),
                            links=((0, 1, LinkPolicy(drop=0.9)),), partitions=())
    wire = wire_spec_from_scenario(sim_spec, tick_s=0.01)
    assert wire.default_link.drop == 0.1
    assert wire.default_link.duplicate == 0.2
    assert wire.default_link.delay == 0.3
    assert wire.default_link.delay_s == pytest.approx(0.5)
    assert wire.links[0][2].drop == 0.9


async def _frame_server():
    """A localhost server that collects raw frames until the client closes;
    returns (server, port, received frames, handler-done event)."""
    received = []
    ended = asyncio.Event()

    async def on_conn(reader, writer):
        try:
            while True:
                hdr = await reader.readexactly(4)
                received.append(await reader.readexactly(int.from_bytes(hdr, "big")))
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()
            ended.set()

    server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
    return server, server.sockets[0].getsockname()[1], received, ended


async def _close(server, writer, ended):
    """The client's end first, then the server: the handler returns on
    EOF, so wait_closed has no connection left to wait for."""
    writer.close()
    await asyncio.wait_for(ended.wait(), WAIT_S)
    server.close()
    await asyncio.wait_for(server.wait_closed(), WAIT_S)


async def test_chaos_stream_drop_dup_reset_counted():
    """Drops vanish, duplicates arrive twice, a reset kills the connection
    loudly, and every injection lands in the plane's log."""
    sk = th.SecretKey.random(random.Random(1))
    server, port, received, ended = await _frame_server()
    reader, writer = await asyncio.wait_for(asyncio.open_connection("127.0.0.1", port), WAIT_S)
    try:
        plane = ChaosPlane(WireChaosSpec(default_link=LinkChaos(duplicate=1.0)))
        stream = plane.wrap_stream(reader, writer, sk, False, b"me")
        await asyncio.wait_for(stream.send(WireMessage("ping", None)), WAIT_S)  # disarmed
        plane.arm()
        await asyncio.wait_for(stream.send(WireMessage("ping", None)), WAIT_S)  # one send, two frames
        assert await wait_for(lambda: len(received) >= 3, timeout=WAIT_S)
        assert len(received) == 3
        assert plane.log.counts == {T.BYZ_LINK_DUP: 1}
        plane.spec = WireChaosSpec(default_link=LinkChaos(drop=1.0))
        await asyncio.wait_for(stream.send(WireMessage("ping", None)), WAIT_S)
        assert plane.log.counts[T.BYZ_LINK_DROP] == 1
        plane.spec = WireChaosSpec(default_link=LinkChaos(reset=1.0))
        with pytest.raises(WireError):
            await asyncio.wait_for(stream.send(WireMessage("ping", None)), WAIT_S)
        assert plane.log.counts[T.BYZ_LINK_RESET] == 1
        assert len(received) == 3
    finally:
        await _close(server, writer, ended)


async def test_chaos_stream_delay_reorders_not_loses():
    """A delayed frame is released by its own task: later frames overtake
    it, nothing is lost."""
    sk = th.SecretKey.random(random.Random(2))
    server, port, received, ended = await _frame_server()
    reader, writer = await asyncio.wait_for(asyncio.open_connection("127.0.0.1", port), WAIT_S)
    try:
        plane = ChaosPlane(WireChaosSpec(default_link=LinkChaos(delay=1.0, delay_s=0.05)))
        stream = plane.wrap_stream(reader, writer, sk, False, b"me")
        plane.arm()
        await asyncio.wait_for(stream.send(WireMessage("ping", None)), WAIT_S)  # held
        plane.disarm()
        await asyncio.wait_for(stream.send(WireMessage("pong", None)), WAIT_S)  # direct
        await asyncio.wait_for(plane.drain(), WAIT_S)
        assert await wait_for(lambda: len(received) == 2, timeout=WAIT_S)
        assert plane.log.counts[T.BYZ_LINK_DELAY] == 1
    finally:
        await _close(server, writer, ended)


# -- the contract ---------------------------------------------------------------


class _FakeNode:
    def __init__(self):
        self.metrics = MetricsRegistry()
        self.fault_log = []


def test_wire_contract_unobserved_injection_fails():
    plane = ChaosPlane(WireChaosSpec())
    plane.log.note(T.BYZ_SIG_CORRUPT)
    node = _FakeNode()
    violations = verify_wire_scenario(plane, [node])
    assert violations and "sig_corrupt" in violations[0]
    node.metrics.counter("wire_sig_rejected").inc()  # a detection counter satisfies it
    assert verify_wire_scenario(plane, [node]) == []
    ring_only = _FakeNode()  # and so does a fault-ring entry alone
    ring_only.fault_log.append(("ab", WireFault("wire: bad signature")))
    assert verify_wire_scenario(plane, [ring_only]) == []


def test_wire_contract_unregistered_kind_is_violation():
    plane = ChaosPlane(WireChaosSpec())
    plane.log.counts["novel_attack"] = 3
    violations = verify_wire_scenario(plane, [_FakeNode()])
    assert violations and "novel_attack" in violations[0]


def test_wire_contract_crash_kind_accepts_recovery_observables():
    plane = ChaosPlane(WireChaosSpec())
    plane.log.note(T.BYZ_CRASH)
    node = _FakeNode()
    assert verify_wire_scenario(plane, [node])  # nothing observed: fails
    node.metrics.counter("node_fast_forwards").inc()
    assert verify_wire_scenario(plane, [node]) == []


# -- bounded wire retry -------------------------------------------------------


async def test_wire_retry_abandons_after_cumulative_cap():
    node = Hydrabadger(InAddr("127.0.0.1", BASE_PORT + 90), fast_config())
    uid = Uid()
    msg = WireMessage("message", (uid.bytes, ("noop",)))
    node._queue_wire_retry(uid, msg)
    for _ in range(WIRE_RETRY_CAP + 2):
        node._wire_retry_tick()
    assert not node._wire_retry
    assert node.metrics.counter("wire_retry_abandoned").value == 1
    assert any(f.kind == "wire: retry abandoned" for _n, f in node.fault_log)


async def test_wire_retry_attempts_survive_salvage_cycles():
    node = Hydrabadger(InAddr("127.0.0.1", BASE_PORT + 91), fast_config())
    uid = Uid()
    msg = WireMessage("message", (uid.bytes, ("noop",)))
    for _ in range(WIRE_RETRY_CAP):
        node._queue_wire_retry(uid, msg)
        node._wire_retry_tick()
        node._wire_retry.clear()
    node._queue_wire_retry(uid, msg)  # the next re-park hits the spent budget
    assert node.metrics.counter("wire_retry_abandoned").value >= 1
    assert not node._wire_retry


# -- certified-frontier fast-forward ------------------------------------------


def _validator_node(port: int, n: int = 4):
    """A Hydrabadger with a validator DynamicHoneyBadger installed (dealer
    keys), its peers' ids and identity keys; no sockets."""
    from hydrabadger_tpu_torch.consensus.dynamic_honey_badger import DynamicHoneyBadger
    from hydrabadger_tpu_torch.consensus.types import NetworkInfo

    node = Hydrabadger(InAddr("127.0.0.1", port), fast_config(), seed=7)
    rng = random.Random(13)
    ids = sorted([node.uid.bytes] + [Uid().bytes for _ in range(n - 1)])
    sks = th.SecretKeySet.random((n - 1) // 3, rng)
    netinfo = NetworkInfo(node.uid.bytes, ids, sks.public_keys(),
                          sks.secret_key_share(ids.index(node.uid.bytes)))
    id_sks = {nid: th.SecretKey.random(rng) for nid in ids}
    id_sks[node.uid.bytes] = node.secret_key
    pub_keys = {nid: sk.public_key() for nid, sk in id_sks.items()}
    node.dhb = DynamicHoneyBadger(node.uid.bytes, node.secret_key, netinfo, pub_keys, encrypt=False,
                                  coin_mode="hash", verify_shares=False, rng=random.Random(5),
                                  session_id=b"net", engine="cpu")
    node.state = "validator"
    return node, [nid for nid in ids if nid != node.uid.bytes], id_sks


def test_fast_forward_requires_f_plus_one_claims():
    node, peers, _ = _validator_node(BASE_PORT + 92)
    assert node.dhb.epoch == 0
    node._ff_claims[peers[0]] = (0, 1000, None)
    node._maybe_fast_forward()
    assert node.dhb.epoch == 0  # one claim certifies nothing at n = 4
    assert node.metrics.counter("node_fast_forwards").value == 0
    node._ff_claims[peers[1]] = (0, 40, None)
    node._maybe_fast_forward()
    assert node.dhb.epoch == 40  # the honest-backed frontier, not 1000
    assert node.dhb.is_validator
    assert node.state == "validator"
    assert node.metrics.counter("node_fast_forwards").value == 1
    assert any(f.kind == "wire: fast-forward" for _n, f in node.fault_log)


def test_fast_forward_ignores_small_gaps():
    node, peers, _ = _validator_node(BASE_PORT + 93)
    node._ff_claims[peers[0]] = (0, 2, None)
    node._ff_claims[peers[1]] = (0, 2, None)
    node._maybe_fast_forward()
    assert node.dhb.epoch == 0  # +2 is pipelining, not wedging
    assert node.metrics.counter("node_fast_forwards").value == 0


def test_frontier_claims_only_from_validators():
    node, _peers, _ = _validator_node(BASE_PORT + 94)

    class P:
        uid = Uid()  # not in the validator set

    node._note_frontier_claim(("active", 0, 99), P())
    assert node._ff_claims == {}


def test_frontier_claims_require_validator_signature():
    node, peers, id_sks = _validator_node(BASE_PORT + 95)
    claimant = peers[0]
    plan = node.dhb.join_plan()
    roster = tuple(plan.node_ids)
    validator_pks = tuple((n, plan.pub_keys[n]) for n in roster)
    claimed_epoch = 40

    def claim(sig_bytes):
        return ("active", plan.era, claimed_epoch, roster, dict(plan.pub_keys), plan.pk_set_bytes,
                plan.session_id, (), sig_bytes)

    class P:
        uid = Uid(claimant)
        out_addr = OutAddr("127.0.0.1", 1)

    wrong = Hydrabadger(InAddr("127.0.0.1", BASE_PORT + 99), fast_config(), seed=77)
    doc = node._frontier_doc(plan.era, claimed_epoch, roster, validator_pks, plan.pk_set_bytes,
                             plan.session_id)
    node._note_frontier_claim(claim(wrong.secret_key.sign(doc).to_bytes()), P())
    assert node._ff_claims == {}
    assert node.metrics.counter("wire_frontier_rejected").value == 1
    assert any(f.kind == "wire: frontier claim rejected" for _n, f in node.fault_log)
    node._note_frontier_claim(claim(b"not-a-signature"), P())
    assert node._ff_claims == {}
    node._note_frontier_claim(claim(id_sks[claimant].sign(doc).to_bytes()), P())
    assert node._ff_claims[claimant][:2] == (plan.era, claimed_epoch)


def test_era_ahead_adoption_needs_f_plus_one_matching_payloads():
    node, peers, _ = _validator_node(BASE_PORT + 96)
    honest_fp = (1, ("a", "b"), (("a", b"pk"),), b"pkset", b"s")
    forged_fp = (1, ("a", "b"), (("a", b"pk"),), b"FORGED", b"s")
    node._ff_claims[peers[0]] = (1, 50, honest_fp)
    node._ff_claims[peers[1]] = (1, 50, forged_fp)
    assert node._certified_frontier() is None
    node._ff_claims[peers[2]] = (1, 60, honest_fp)
    assert node._certified_frontier() == (1, 50, honest_fp)


# -- cluster integration ------------------------------------------------------


async def test_crash_restart_fast_forward_recovery():
    """A validator crashes, the network advances past HB's future-epoch
    window, and the restarted node recovers through fast-forward (or
    observer re-adoption) and commits byte-identical batches again."""
    from hydrabadger_tpu_torch.consensus.honey_badger import MAX_FUTURE_EPOCHS

    cfg = fast_config()
    base = BASE_PORT
    nodes = [Hydrabadger(InAddr("127.0.0.1", base + i), cfg, seed=300 + i) for i in range(4)]
    try:
        for i, node in enumerate(nodes):
            await node.start([OutAddr("127.0.0.1", base + j) for j in range(4) if j != i], gen_txns)
        assert await wait_for(lambda: all(n.is_validator() for n in nodes))
        assert await wait_for(lambda: min(len(n.batches) for n in nodes) >= 2)
        victim = nodes[1]
        ckpt = victim.checkpoint()
        survivors = [n for n in nodes if n is not victim]
        await victim.crash()
        target = max(n.current_epoch for n in survivors) + MAX_FUTURE_EPOCHS + 2
        assert await wait_for(lambda: min(n.current_epoch for n in survivors) >= target, timeout=45), \
            "survivors stalled while the victim was down"
        restarted = Hydrabadger.from_checkpoint(InAddr("127.0.0.1", base + 1), ckpt, cfg, seed=999)
        nodes[1] = restarted
        await restarted.start([OutAddr("127.0.0.1", base + j) for j in range(4) if j != 1], gen_txns)
        assert await wait_for(lambda: len(restarted.batches) >= 2, timeout=45), \
            "recovered node never caught up"
        snap = restarted.metrics.snapshot()["counters"]
        assert snap.get("node_fast_forwards", 0) + snap.get("observer_adoptions", 0) >= 1
        by_epoch = {b.epoch: chaos._batch_key(b) for b in survivors[0].batches}
        overlap = [b for b in restarted.batches if b.epoch in by_epoch]
        assert overlap, "no overlapping epochs to compare"
        for b in overlap:
            assert chaos._batch_key(b) == by_epoch[b.epoch]
    finally:
        for n in nodes:
            try:
                await asyncio.wait_for(n.stop(), 30)
            except Exception:
                pass


async def test_chaos_cluster_fast_smoke():
    """The harness end to end at the fast tier on the host engine: link
    faults, a replay-flooding Byzantine peer and a crash/restart, the
    contract verified inside the harness."""
    row = await chaos.chaos_cluster(
        n=4, f_byz=1, epochs=5, base_port=BASE_PORT + 20, encrypt=False, verify_shares=False,
        coin_mode="hash", wire_sign=False, strategies=("replay_flood",), crash=True,
        crash_down_s=1.5, deadline_s=180, engine="cpu")
    assert row["agreement_ok"] and row["contract_ok"]
    assert row["epochs"] >= 5
    assert row["byz_injected"].get("replay_flood", 0) > 0
    assert row["recovery_catchup_s"] is not None
    assert row["timeline_traced"] and row["epochs_attributed"] > 0


@pytest.mark.byz
@pytest.mark.parametrize("variant,port", [("bracha", 40), ("lowcomm", 80)])
async def test_equivocating_peer_detected_over_tcp(monkeypatch, variant, port):
    """The split-coding equivocator over real sockets (no crash): honest
    nodes flag the mixed roots and keep committing, in both broadcast
    dialects, through the same contract."""
    monkeypatch.setenv("HYDRABADGER_RBC", variant)
    row = await chaos.chaos_cluster(
        n=4, f_byz=1, epochs=4, base_port=BASE_PORT + port, encrypt=False, verify_shares=False,
        coin_mode="hash", wire_sign=False, strategies=("equivocate",),
        spec=WireChaosSpec(name="clean"), crash=False, deadline_s=180, engine="cpu")
    assert row["agreement_ok"] and row["contract_ok"]
    assert row["byz_injected"].get("equivocation", 0) > 0
    assert row["byz_faults"].get("byz_faults_equivocation", 0) > 0


async def test_stalled_handshake_culled():
    """A connection whose hello never came is aborted after the handshake
    timeout, crossed on the node's injected monotonic ruler."""
    from conftest import FakeMono
    from hydrabadger_tpu_torch.net.node import HANDSHAKE_TIMEOUT_S

    node = Hydrabadger(InAddr("127.0.0.1", BASE_PORT + 97), fast_config())
    fake = FakeMono(t0=500.0)
    node._mono_base = fake
    await node.start([], gen_txns)
    writer = None
    try:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection("127.0.0.1", BASE_PORT + 97), WAIT_S)
        assert await wait_for(lambda: len(node.peers.by_addr) >= 1, timeout=WAIT_S)
        fake.advance(HANDSHAKE_TIMEOUT_S - 0.1)
        node._cull_stalled_handshakes()
        assert node.metrics.counter("handshake_timeouts").value == 0
        fake.advance(0.2)
        assert await wait_for(lambda: node.metrics.counter("handshake_timeouts").value >= 1,
                              timeout=10), "the wire-retry tick never swept the stalled handshake"
        assert await wait_for(lambda: reader.at_eof(), timeout=WAIT_S)
    finally:
        if writer is not None:
            writer.close()
        await asyncio.wait_for(node.stop(), 30)


# -- parity with the JAX package ---------------------------------------------


def test_wire_registry_and_spec_port_equal_the_jax_ones():
    def plain(reg):
        return {k: (v.fault_any, v.counters, v.gauges) for k, v in reg.items()}

    from hydrabadger_tpu.sim import scenario as jscen

    assert plain(chaos.WIRE_FAULT_OBSERVABLES) == plain(jchaos.WIRE_FAULT_OBSERVABLES)
    for wire_sign in (False, True):
        ours = chaos.default_wire_spec(4, 3, wire_sign, seed=5)
        theirs = jchaos.default_wire_spec(4, 3, wire_sign, seed=5)
        assert repr(ours).replace("hydrabadger_tpu_torch", "hydrabadger_tpu") == repr(theirs)
    spec = (LinkPolicy(drop=0.1, delay=0.2, delay_max=7), jscen.LinkPolicy(drop=0.1, delay=0.2,
                                                                         delay_max=7))
    ours = wire_spec_from_scenario(ScenarioSpec(name="x", default_link=spec[0]), tick_s=0.02)
    theirs = jchaos.wire_spec_from_scenario(jscen.ScenarioSpec(name="x", default_link=spec[1]),
                                            tick_s=0.02)
    assert repr(ours) == repr(theirs)


class _Writer:
    """A stream writer that records frames instead of sending them."""

    def __init__(self, out):
        self.out = out

    def write(self, frame):
        self.out.append(bytes(frame))

    async def drain(self):
        pass

    def close(self):
        pass

    def is_closing(self):
        return False

    def get_extra_info(self, name, default=None):
        return default


def _script(mod, wire_mod, th_mod):
    """One spec and seed over 400 scripted frames from node 0 to nodes 1-3
    (a reset opens a fresh stream on the same plane).  Holds (delays and
    the partition) outlast the script, so what is written is the immediate
    frames in order; the held frames are read off the holding tasks, which
    are then cancelled.  Returns (written frames, held frames sorted,
    injection counts, indices of the resets, the plane's final rng state)."""
    spec = mod.WireChaosSpec(
        seed=11,
        default_link=mod.LinkChaos(drop=0.1, duplicate=0.1, delay=0.15, delay_s=60.0, stall=0.05,
                                   stall_s=0.0, reset=0.02, sig_corrupt=0.2),
        links=((0, 2, mod.LinkChaos(drop=0.4, duplicate=0.3, delay_s=60.0)),),
        partitions=(mod.WirePartition(groups=((0,), (3,)), start_s=0.0, heal_s=600.0),),
    )
    sk = th_mod.SecretKey.random(random.Random(4))
    uids = [bytes([i + 1]) * 16 for i in range(4)]

    async def run():
        plane = mod.ChaosPlane(spec)
        for i, u in enumerate(uids):
            plane.register(u, i)
        plane.arm()
        written, resets, streams = [], [], {}

        def stream(dst):
            if dst not in streams:
                s = plane.wrap_stream(None, _Writer(written), sk, True, uids[0])
                s.peer_uid = uids[dst]
                streams[dst] = s
            return streams[dst]

        for k in range(400):
            dst = 1 + k % 3
            msg = (wire_mod.WireMessage("transaction", b"frame-%d" % k) if k % 2 else
                   wire_mod.WireMessage("message", (uids[0], ("noop", k))))
            try:
                await asyncio.wait_for(stream(dst).send(msg), WAIT_S)
            except wire_mod.WireError:
                resets.append(k)
                streams.pop(dst)
        await asyncio.sleep(0)  # every hold's task reaches its sleep
        tasks = list(plane._tasks)
        held = sorted(t.get_coro().cr_frame.f_locals["frame"] for t in tasks)
        for t in tasks:
            t.cancel()
        await asyncio.wait_for(asyncio.gather(*tasks, return_exceptions=True), WAIT_S)
        return written, held, dict(plane.log.counts), resets, plane.rng.getstate()

    return asyncio.run(run())


def counts_held(counts):
    return counts.get(T.BYZ_LINK_DELAY, 0) + counts.get(T.BYZ_PARTITION, 0)


def test_scripted_frames_make_the_jax_planes_decisions():
    ours = _script(chaos, twire, th)
    theirs = _script(jchaos, jwire, jth)
    assert ours[2] == theirs[2]  # injection counts by kind
    assert ours[3] == theirs[3]  # the same frames reset the connection
    assert ours[4] == theirs[4]  # the same draws, in the same order
    assert ours[0] == theirs[0]  # the same bytes on the wire, in order
    assert ours[1] == theirs[1]  # the same frames held
    assert len(ours[1]) == counts_held(ours[2])
    counts = ours[2]
    for kind in (T.BYZ_LINK_DROP, T.BYZ_LINK_DUP, T.BYZ_LINK_DELAY, T.BYZ_LINK_RESET,
                 T.BYZ_SIG_CORRUPT, T.BYZ_PARTITION):
        assert counts.get(kind, 0) > 0, kind
