"""The port's flight recorder (hydrabadger_tpu_torch/obs/flight.py) on the CPU.

The JAX package's flight cases of tests/test_aggregate.py, case for case, on
the port's recorder and fault ring: a dump's round trip and rotation, the
debounce on the injected monotonic seam, the executor write under a running
loop, a torn or forged dump rejected with the generation fallback, and the
kill switch.  (The aggregator's case waits for the port's `obs/aggregate`.)
Across the packages: the same ring and faults give the same `black_box`
keys and digest rule, and each package loads the other's dump.  On a node:
a fault-ring entry and a graceful stop each leave a dump.
"""
import asyncio
import json
import os
from collections import deque

import pytest

from hydrabadger_tpu.net import node as jnode
from hydrabadger_tpu.obs import flight as jflight
from hydrabadger_tpu.obs import recorder as jrecorder
from hydrabadger_tpu_torch.net import node as tnode
from hydrabadger_tpu_torch.obs import flight as obs_flight
from hydrabadger_tpu_torch.obs.recorder import DOMAIN_WALL, Recorder
from hydrabadger_tpu_torch.utils import ids as tids


class FakeMono:
    """A hand-advanced monotonic clock for the recorder's ``mono`` seam."""

    def __init__(self, t0: float = 1000.0):
        self.t = t0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _make_flight(tmp_path, node="n0", flight=obs_flight, recorder_cls=Recorder,
                 fault=tnode.WireFault):
    rec = recorder_cls(clock_domain="wall")
    rec.bind(node=node).emit_stamped("epoch_commit", 1.0, era=0, epoch=1)
    ring = deque([(node, fault("wire: bad signature"))])
    return flight.FlightRecorder(str(tmp_path / f"{node}.flight"), node=node, recorder=rec,
                                 fault_ring=ring, min_interval_s=0.0)


def test_flight_dump_roundtrip_and_rotation(tmp_path):
    fr = _make_flight(tmp_path)
    path = fr.dump("fault:test")
    assert path and os.path.exists(path)
    payload = obs_flight.load_flight(path)
    assert payload["node"] == "n0"
    assert payload["reason"] == "fault:test"
    assert payload["faults"] == ["wire: bad signature"]
    assert payload["events"] and payload["events"][0]["name"] == "epoch_commit"
    assert payload["clock_domain"] == DOMAIN_WALL
    fr.dump("stop")  # the second dump rotates the first to .1
    assert os.path.exists(path + ".1")
    assert obs_flight.load_flight(path)["reason"] == "stop"
    assert obs_flight.load_flight(path + ".1")["reason"] == "fault:test"


def test_flight_debounce_rides_injected_mono_seam(tmp_path):
    """The dump debounce reads the injectable ``mono`` seam (the node
    passes ``_now``): no wall sleeps needed."""
    fake = FakeMono(t0=100.0)
    ring = deque([("n0", tnode.WireFault("wire: x"))])
    fr = obs_flight.FlightRecorder(str(tmp_path / "n0.flight"), node="n0", fault_ring=ring,
                                   min_interval_s=1.0, mono=fake)
    assert fr.maybe_dump("fault:x") is True
    assert fr.maybe_dump("fault:x") is False  # debounced on the seam
    fake.advance(0.5)
    assert fr.maybe_dump("fault:x") is False  # still inside the window
    fake.advance(0.6)
    assert fr.maybe_dump("fault:x") is True  # window elapsed (fake time)
    assert fr.dumps == 2
    # a clock-behind node holds its skewed clock below zero: the FIRST
    # dump must still fire
    fr2 = obs_flight.FlightRecorder(str(tmp_path / "neg.flight"), node="n1", fault_ring=ring,
                                    min_interval_s=1.0, mono=FakeMono(t0=-400000.0))
    assert fr2.maybe_dump("fault:x") is True
    assert fr2.dumps == 1


def test_flight_dump_offloads_write_under_a_running_loop(tmp_path):
    """Under a running loop the fsync half runs on the default executor;
    the payload is captured synchronously and the terminal ``sync=True``
    path writes inline."""
    fr = _make_flight(tmp_path)

    async def drive():
        assert fr.dump("fault:offloaded") == fr.path
        assert fr._write_inflight is not None
        await fr._write_inflight
        assert fr.dump("stop", sync=True) == fr.path

    asyncio.run(drive())
    assert obs_flight.load_flight(fr.path)["reason"] == "stop"
    assert obs_flight.load_flight(fr.path + ".1")["reason"] == "fault:offloaded"


def test_torn_flight_dump_rejected_with_generation_fallback(tmp_path):
    """A dump cut mid-write is rejected LOUDLY and the reader falls back
    to the previous generation; a forged payload fails the digest."""
    fr = _make_flight(tmp_path)
    path = fr.dump("first")
    fr.dump("second")
    raw = open(path).read()
    with open(path, "w") as fh:
        fh.write(raw[: len(raw) // 2])
    with pytest.raises(obs_flight.FlightCorrupt):
        obs_flight.load_flight(path)
    payload, rejected = obs_flight.load_flight_with_fallback(path)
    assert payload is not None and payload["reason"] == "first"
    assert rejected == [path]
    fr2 = _make_flight(tmp_path, node="n1")
    p2 = fr2.dump("only")
    doc = json.load(open(p2))
    doc["flight"]["reason"] = "forged"
    json.dump(doc, open(p2, "w"))
    with pytest.raises(obs_flight.FlightCorrupt):
        obs_flight.load_flight(p2)
    payload, rejected = obs_flight.load_flight_with_fallback(p2)
    assert payload is None and rejected == [p2]


def test_flight_kill_switch(tmp_path, monkeypatch):
    monkeypatch.setenv("HYDRABADGER_FLIGHT", "0")
    fr = _make_flight(tmp_path)
    assert fr.dump("fault:test") is None
    assert not os.listdir(tmp_path)


def test_black_box_and_digest_equal_the_jax_recorders(tmp_path):
    """The same ring and faults: the same payload keys and values (but the
    dump's own wall time), the same digest rule, and each package loads the
    other's file."""
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    ours = _make_flight(tmp_path / "port")
    theirs = _make_flight(tmp_path / "jax", flight=jflight, recorder_cls=jrecorder.Recorder,
                          fault=jnode.WireFault)
    ours.clock = theirs.clock = lambda: 1234.5
    a, b = ours.black_box("stop"), theirs.black_box("stop")
    assert a == b and sorted(a) == ["clock_domain", "counters", "events", "faults", "node", "pid",
                                    "reason", "t_wall"]
    assert obs_flight._payload_digest(a) == jflight._payload_digest(b)
    p_ours, p_theirs = ours.dump("stop"), theirs.dump("stop")
    assert jflight.load_flight(p_ours) == obs_flight.load_flight(p_theirs)


async def test_a_node_dumps_on_a_fault_and_on_stop(tmp_path):
    cfg = tnode.Config(encrypt=False, coin_mode="hash", verify_shares=False, wire_sign=False,
                       engine="cpu")
    node = tnode.Hydrabadger(tids.InAddr("127.0.0.1", 15590), cfg, seed=1)
    node.flight = obs_flight.FlightRecorder(str(tmp_path / "n.flight"), node="n",
                                            metrics=node.metrics, fault_ring=node.fault_log,
                                            min_interval_s=0.0, mono=node._now)
    node._note_fault("wire: bad signature", "wire_sig_rejected")
    await node.flight._write_inflight  # the fault's dump went to the executor
    first = obs_flight.load_flight(node.flight.path)
    assert first["reason"] == "fault:wire: bad signature"
    assert first["faults"] == ["wire: bad signature"]
    assert first["counters"]["wire_sig_rejected"] == 1
    await node.stop()
    assert obs_flight.load_flight(node.flight.path)["reason"] == "stop"
    assert obs_flight.load_flight(node.flight.path + ".1") == first
