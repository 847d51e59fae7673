"""The port's cluster-timeline aggregator (obs/aggregate.py) and the trace
readers of obs/export.py against the JAX package's.

The cases of JAX tests/test_aggregate.py that tests/test_torch_flight.py
does not hold already, on the port: clock-domain headers and the
mixed-domain refusal, committed-batch clock alignment (injected skew and
drift recovered), per-epoch critical paths, wire tx/rx pairing on the sim
and on a socket, a torn flight dump reported by `aggregate_dir`, the per-kind
byte ledger, the dkg_settle span and the CLI gate.  Every socket wait is
bounded and the client is closed before the server waits for its handler.
Across the packages: `aggregate_dir` over the same synthetic cluster and
`timeline_report` over the same traced events give equal reports, and the
two packages' traced 4-node sims give equal event and pair counts.
"""
import asyncio
import json
import os
import random

import pytest
import torch

from hydrabadger_tpu.obs import aggregate as jag
from hydrabadger_tpu.obs import export as jexport
from hydrabadger_tpu.obs import recorder as jrecorder
from hydrabadger_tpu.sim import network as jnet
from hydrabadger_tpu_torch.obs import aggregate as ag
from hydrabadger_tpu_torch.obs import export as obs_export
from hydrabadger_tpu_torch.obs import flight as obs_flight
from hydrabadger_tpu_torch.obs.export import ClockDomainMismatch
from hydrabadger_tpu_torch.obs.recorder import Recorder
from hydrabadger_tpu_torch.sim.network import SimConfig, SimNetwork

pytestmark = pytest.mark.obs

WAIT_S = 5.0  # every socket wait; a fault fails the case in seconds


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- clock-domain headers -----------------------------------------------------


def test_trace_meta_header_roundtrip(tmp_path):
    rec = Recorder(clock_domain="wall")
    rec.bind(node="n0").instant("epoch_commit", era=0, epoch=1)
    rec.stamp(5.0)
    path = str(tmp_path / "t.trace.jsonl")
    n = obs_export.write_jsonl(rec.events, path, meta={"clock_domain": "wall", "node": "n0"})
    meta, events = obs_export.read_feed(path)
    assert meta["clock_domain"] == "wall"
    assert meta["node"] == "n0"
    assert len(events) == n == 1
    assert len(obs_export.read_jsonl(path)) == 1  # the meta line is not an event
    assert jexport.read_feed(path)[0] == meta  # and the JAX reader reads it the same


def test_require_uniform_domain_refuses_mix():
    assert obs_export.require_uniform_domain(["wall", "wall"]) == "wall"
    with pytest.raises(ClockDomainMismatch):
        obs_export.require_uniform_domain(["wall", "perf_counter"])


def _write_feed(tmp_path, name, node, domain, events):
    rec = Recorder(clock_domain=domain)
    bound = rec.bind(node=node)
    for ev_name, t, attrs in events:
        bound.emit_stamped(ev_name, t, **attrs)
    obs_export.write_jsonl(rec.events, str(tmp_path / f"{name}.trace.jsonl"),
                           meta={"clock_domain": domain, "node": node})


def test_aggregate_dir_refuses_unanchored_domain_mix(tmp_path):
    _write_feed(tmp_path, "node0", "a", "wall", [("epoch", 100.0, {"ph_": 0})])
    _write_feed(tmp_path, "node1", "b", "perf_counter", [("epoch", 3.0, {"ph_": 0})])
    with pytest.raises(ClockDomainMismatch):
        ag.aggregate_dir(str(tmp_path))


# -- alignment + critical path over synthetic feeds ---------------------------


def _span(rec, name, t0, t1, **attrs):
    rec.emit_stamped(name, t0, phase="B", **attrs)
    rec.emit_stamped(name, t1, phase="E", **attrs)


# node c straggles on these epochs (of 0..11), by a lateness that varies
# per epoch: alignment absorbs a constant lateness into c's clock offset
_EPOCHS = 12
_LATE_EPOCHS = {4, 7}
_LATE_S = 0.5


def _synthetic_cluster(tmp_path, skew_offset=30.0, skew_rate=1.25):
    """Two honest-clock nodes and one skewed node 'c' that straggles by
    0.5 s on two mid-run epochs, gated by tdec."""
    for node, warp in (("a", None), ("b", None), ("c", (skew_offset, skew_rate))):
        rec = Recorder(clock_domain="wall")
        bound = rec.bind(node=node)

        def w(t):
            return t if warp is None else warp[1] * t + warp[0]

        for epoch in range(_EPOCHS):
            base = 1000.0 + epoch * 1.0
            late = _LATE_S if (node == "c" and epoch in _LATE_EPOCHS) else 0.0
            _span(bound, "rbc", w(base), w(base + 0.1 + late), era=0, epoch=epoch, instance=1)
            _span(bound, "tdec", w(base + 0.1), w(base + 0.3 + late), era=0, epoch=epoch)
            _span(bound, "epoch", w(base), w(base + 0.35 + late), era=0, epoch=epoch)
            bound.emit_stamped("epoch_commit", w(base + 0.35 + late), era=0, epoch=epoch + 1)
        obs_export.write_jsonl(rec.events, str(tmp_path / f"node{node}.trace.jsonl"),
                               meta={"clock_domain": "wall", "node": node})


def test_alignment_recovers_injected_skew_and_drift(tmp_path):
    _synthetic_cluster(tmp_path, skew_offset=30.0, skew_rate=1.25)
    report = ag.aggregate_dir(str(tmp_path))
    fit = report["clock"]["alignment"]["c"]
    assert fit["rate"] == pytest.approx(1.0 / 1.25, rel=0.02)
    assert fit["anchors"] >= 2
    assert report["epoch_critical_stage"] == "tdec"
    rows = {r["epoch"]: r for r in report["epochs"]}
    for epoch in _LATE_EPOCHS:
        assert rows[epoch]["straggler_node"] == "c"
        assert rows[epoch]["critical_stage"] == "tdec"
        assert 0.3 < rows[epoch]["commit_spread_s"] < _LATE_S
    for epoch in set(range(_EPOCHS)) - _LATE_EPOCHS:
        assert rows[epoch]["commit_spread_s"] < 0.15


def _batch_log_cluster(tmp_path):
    for node, off in (("a", 0.0), ("b", 40.0)):
        rec = Recorder(clock_domain="wall")
        bound = rec.bind(node=node)
        for epoch in range(3):
            base = 100.0 + epoch + off
            _span(bound, "ba", base, base + 0.1, era=0, epoch=epoch, instance=0)
            _span(bound, "epoch", base, base + 0.2, era=0, epoch=epoch)
        obs_export.write_jsonl(rec.events, str(tmp_path / f"node{node}.trace.jsonl"),
                               meta={"clock_domain": "wall", "node": node})
        with open(tmp_path / f"node{node}.batches.jsonl", "w") as fh:
            for epoch in range(3):
                fh.write(json.dumps({"t": 100.25 + epoch + off, "epoch": epoch + 1, "era": 0,
                                     "digest": "d"}) + "\n")
            fh.write('{"t": 103.25, "epo')  # a torn tail: skipped and counted


def test_batch_log_rows_anchor_alignment(tmp_path):
    _batch_log_cluster(tmp_path)
    report = ag.aggregate_dir(str(tmp_path))
    assert report["clock"]["alignment"]["b"]["offset_s"] == pytest.approx(-40.0, abs=0.01)
    assert report["torn_tail_lines_skipped"] >= 2
    assert report["epochs_attributed"] >= 3


# -- wire events + message latency -------------------------------------------


def test_sim_trace_carries_wire_events_and_latency():
    net = SimNetwork(SimConfig(engine="cpu", n_nodes=4, protocol="qhb", epochs=2, seed=3, trace=True))
    m = net.run()
    assert m.agreement_ok
    names = {e.name for e in net.recorder.events}
    assert "wire_tx" in names and "wire_rx" in names
    report = net.timeline_report()
    net.shutdown()
    assert report["pairs"] > 0
    assert report["msg_latency_p99_s"] is not None
    assert report["msg_latency_p99_s"] >= report["msg_latency_p50_s"] >= 0
    assert report["epochs_attributed"] >= 2
    assert any(r["critical_stage"] != "unknown" for r in report["epochs"])
    tx = next(e for e in net.recorder.events if e.name == "wire_tx")
    assert {"node", "dst", "kind", "mid"} <= set(tx.attrs)
    assert SimNetwork(SimConfig(engine="cpu", n_nodes=4, epochs=1)).timeline_report() is None


def test_consensus_tags_walks_nested_shapes():
    msg = ("dhb", 2, ("hb", 7, ("cs", ("cs", 3, ("bc_echo", b"x")))))
    assert ag.consensus_tags(msg) == {"era": 2, "epoch": 7, "instance": 3, "ckind": "bc_echo"}
    assert ag.consensus_tags(("hb", 1, ("td", 2, ("td_share", b"s")))) == {
        "epoch": 1, "instance": 2, "ckind": "td_share"}
    assert ag.consensus_tags(b"opaque") == {}
    assert ag.consensus_tags(msg) == jag.consensus_tags(msg)


async def _two_frames(on_stream, send):
    """A localhost server whose handler reads two frames through a port
    WireStream (`on_stream` configures it); the client sends through `send`,
    then closes before the server waits for its handler: every wait bounded."""
    from hydrabadger_tpu_torch.crypto.threshold import SecretKey
    from hydrabadger_tpu_torch.net import wire

    done = asyncio.Event()

    async def on_conn(reader, writer):
        s = wire.WireStream(reader, writer, SecretKey.random(random.Random(2)), sign_frames=False)
        on_stream(s)
        await s.recv()
        await s.recv()
        done.set()
        s.close()

    server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
    try:
        port = server.sockets[0].getsockname()[1]
        reader, writer = await asyncio.wait_for(asyncio.open_connection("127.0.0.1", port), WAIT_S)
        tx = wire.WireStream(reader, writer, SecretKey.random(random.Random(1)), sign_frames=False)
        await asyncio.wait_for(send(tx, wire), WAIT_S)
        await asyncio.wait_for(done.wait(), WAIT_S)
        tx.close()
        await asyncio.wait_for(writer.wait_closed(), WAIT_S)
    finally:
        server.close()
        await asyncio.wait_for(server.wait_closed(), WAIT_S)


def test_tcp_wire_stream_stamps_tx_rx():
    """tx stamped at frame build, rx at frame read, digest-paired: exact
    even when frames repeat."""
    tx_uid, rx_uid = b"\x01" * 16, b"\x02" * 16
    rec = Recorder(clock_domain="wall")

    def on_stream(s):
        s.peer_uid = tx_uid
        s.obs = rec.bind(node=rx_uid.hex()[:8])

    async def send(tx, wire):
        tx.peer_uid = rx_uid
        tx.obs = rec.bind(node=tx_uid.hex()[:8])
        await tx.send(wire.ping())
        await tx.send(wire.ping())  # an identical frame: the digest repeats, FIFO pairs

    asyncio.run(_two_frames(on_stream, send))
    txs = [e for e in rec.events if e.name == "wire_tx"]
    rxs = [e for e in rec.events if e.name == "wire_rx"]
    assert len(txs) == 2 and len(rxs) == 2
    assert txs[0].attrs["mid"] == rxs[0].attrs["mid"]
    assert txs[0].attrs["kind"] == "ping"
    assert txs[0].attrs["dst"] == rx_uid.hex()[:8]
    assert rxs[0].attrs["src"] == tx_uid.hex()[:8]
    lat = ag.message_latency(list(rec.events))
    assert lat["pairs"] == 2
    assert lat["msg_latency_p99_s"] >= 0


def test_wire_stream_bytes_rx_by_kind_bounded_names():
    from hydrabadger_tpu_torch.net.wire import KINDS
    from hydrabadger_tpu_torch.obs.metrics import BYTES_RX_BY_KIND_PREFIX, MetricsRegistry

    reg = MetricsRegistry()

    def on_stream(s):
        s.metrics = reg

    async def send(tx, wire):
        await tx.send(wire.ping())
        await tx.send(wire.transaction(b"abc"))

    asyncio.run(_two_frames(on_stream, send))
    counters = reg.snapshot()["counters"]
    kinds = {k[len(BYTES_RX_BY_KIND_PREFIX):] for k in counters if k.startswith(BYTES_RX_BY_KIND_PREFIX)}
    assert kinds == {"ping", "transaction"}
    assert kinds <= KINDS


# -- flight dumps through the aggregator --------------------------------------


def _make_flight(tmp_path, node="n0"):
    from collections import deque

    from hydrabadger_tpu_torch.net.node import WireFault

    rec = Recorder(clock_domain="wall")
    rec.bind(node=node).emit_stamped("epoch_commit", 1.0, era=0, epoch=1)
    ring = deque([(node, WireFault("wire: bad signature"))])
    return obs_flight.FlightRecorder(str(tmp_path / f"{node}.flight"), node=node, recorder=rec,
                                     fault_ring=ring, min_interval_s=0.0)


def test_aggregate_dir_surfaces_flight_rejection(tmp_path):
    """A torn newest generation is reported while the fallback
    generation's events still merge."""
    _synthetic_cluster(tmp_path)
    fr = _make_flight(tmp_path, node="a")
    path = fr.dump("first")
    fr.dump("second")
    raw = open(path).read()
    with open(path, "w") as fh:
        fh.write(raw[: len(raw) // 2])
    report = ag.aggregate_dir(str(tmp_path))
    assert len(report["flight"]["found"]) == 1
    assert report["flight"]["found"][0]["used_fallback"] is True
    assert report["flight"]["rejected"] == [os.path.basename(path)]


# -- per-kind byte attribution and the dkg_settle span ------------------------


def test_bytes_rx_by_kind_ledger():
    def leg(variant):
        net = SimNetwork(SimConfig(engine="cpu", n_nodes=4, protocol="qhb", epochs=2, seed=29,
                                   rbc_variant=variant, meter_bytes=True))
        m = net.run()
        net.shutdown()
        assert m.agreement_ok
        return m

    bracha, lc = leg("bracha"), leg("lowcomm")
    assert sum(bracha.bytes_rx_by_kind.values()) == bracha.bytes_rx_total
    assert sum(lc.bytes_rx_by_kind.values()) == lc.bytes_rx_total
    assert "bc_echo" in bracha.bytes_rx_by_kind
    assert "bc_echo_lc" in lc.bytes_rx_by_kind
    assert lc.bytes_rx_by_kind["bc_echo_lc"] < bracha.bytes_rx_by_kind["bc_echo"]


def test_dkg_settle_span_rides_era_switch():
    net = SimNetwork(SimConfig(engine="cpu", n_nodes=4, protocol="dhb", seed=5, trace=True,
                               txns_per_node_per_epoch=1))
    net.run(1)
    victim = net.ids[-1]
    for nid in net.ids:
        if nid != victim:
            net.router.dispatch_step(nid, net.nodes[nid].vote_to_remove(victim))
    switched = False
    for _ in range(8):
        assert net.run(1).agreement_ok
        if all(net.nodes[n].era > 0 for n in net.ids if n != victim):
            switched = True
            break
    net.shutdown()
    assert switched, "era never switched"
    settles = [e for e in net.recorder.events if e.name == "dkg_settle"]
    assert settles, "no dkg_settle spans recorded across an era switch"
    assert {e.phase for e in settles} == {"B", "E"}
    b = next(e for e in settles if e.phase == "B")
    assert {"era", "epoch", "node"} <= set(b.attrs)
    report = net.timeline_report()
    assert report["epochs_attributed"] >= 1


# -- CLI ----------------------------------------------------------------------


def test_aggregate_cli_gate(tmp_path, capsys):
    _synthetic_cluster(tmp_path)
    _make_flight(tmp_path, node="a").dump("fault:test")
    rc = ag.main([str(tmp_path), "--report-out", str(tmp_path / "report.json"),
                  "--require-flight", "--require-critical-path"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "straggler c" in out
    assert "gated by tdec" in out
    report = json.load(open(tmp_path / "report.json"))
    assert report["epoch_critical_stage"] == "tdec"
    assert json.load(open(tmp_path / "cluster_timeline.json"))["traceEvents"]
    for f in os.listdir(tmp_path):
        if ".flight." in f:
            os.unlink(tmp_path / f)
    assert ag.main([str(tmp_path), "--require-flight"]) == 1


# -- parity with the JAX package ---------------------------------------------


def _jsonable(report):
    return json.loads(json.dumps(report, sort_keys=True, default=repr))


@pytest.mark.parametrize("cluster", ["skewed", "batch_logs", "flight_fallback"])
def test_aggregate_dir_equals_the_jax_report(tmp_path, cluster):
    if cluster == "batch_logs":
        _batch_log_cluster(tmp_path)
    else:
        _synthetic_cluster(tmp_path)
    if cluster == "flight_fallback":
        fr = _make_flight(tmp_path, node="a")
        path = fr.dump("first")
        fr.dump("second")
        raw = open(path).read()
        with open(path, "w") as fh:
            fh.write(raw[: len(raw) // 2])
    ours, merged = ag.aggregate_dir(str(tmp_path), return_events=True)
    theirs, jmerged = jag.aggregate_dir(str(tmp_path), return_events=True)
    assert _jsonable(ours) == _jsonable(theirs)
    assert [(e.name, e.phase, e.t, e.attrs) for e in merged] == [
        (e.name, e.phase, e.t, e.attrs) for e in jmerged]
    assert ag.report_text(ours) == jag.report_text(theirs)


def test_timeline_report_equals_the_jax_report_on_the_same_events():
    """The port's traced 4-node sim: its events through both aggregators
    (aligned and not) give equal reports; the JAX sim's own trace of the
    same config gives the same event, wire and pair counts."""
    kw = dict(n_nodes=4, protocol="qhb", epochs=2, seed=3, trace=True)
    net = SimNetwork(SimConfig(engine="cpu", native_acs=False, **kw))
    net.run()
    events = list(net.recorder.events)
    jevents = [jrecorder.Event(e.name, e.phase, dict(e.attrs), e.t) for e in events]
    assert _jsonable(net.timeline_report()) == _jsonable(jag.aggregate_events(jevents))
    assert _jsonable(ag.aggregate_events(events, align=True)) == _jsonable(
        jag.aggregate_events(jevents, align=True))
    jsim = jnet.SimNetwork(jnet.SimConfig(engine="cpu", native_acs=False, **kw))
    jsim.run()
    ours, theirs = net.timeline_report(), jsim.timeline_report()
    for key in ("nodes", "events", "pairs", "wire_tx_events", "wire_rx_events"):
        assert ours[key] == theirs[key], key
    assert [(r["era"], r["epoch"], r["nodes_committed"]) for r in ours["epochs"]] == [
        (r["era"], r["epoch"], r["nodes_committed"]) for r in theirs["epochs"]]
    net.shutdown()
