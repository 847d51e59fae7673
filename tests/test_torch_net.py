"""The port's TCP node tier (hydrabadger_tpu_torch/net/, __main__.py) on the CPU.

Port nodes run `engine="cpu"`, the host engine; localhost ports 15200-15299.
The process tier's node features (a chaos plane, `set_slo`, checkpoints)
are ported: an impossible SLO on a 4-node testnet rings a fault on every
node.
The equivalence test of the wire tier is a mixed cluster: two port nodes
and two JAX nodes form one 4-node TCP cluster, bootstrap through the DKG
and commit agreed batches, at the fast tier and with every frame BLS-signed
(frames the port signed verified by the JAX `verify_batch`, and the other
way).  Which contributions an epoch commits depends on socket timing, so
two TCP runs are not compared byte for byte; agreement on the common
prefix is.  Every TCP test has its own deadline (asyncio.wait_for).
"""
import asyncio
import random

import pytest
import torch

from hydrabadger_tpu import __main__ as jmain
from hydrabadger_tpu.net import node as jnode
from hydrabadger_tpu.utils import ids as jids
from hydrabadger_tpu_torch import __main__ as tmain
from hydrabadger_tpu_torch.crypto import engine as teng
from hydrabadger_tpu_torch.net import node as tnode
from hydrabadger_tpu_torch.utils import ids as tids

BASE_PORT = 15200


def fast_config(pkg, **kw):
    """The fast tier: no encryption, the hash coin, no share checks and no
    frame signatures, on the host engine."""
    defaults = dict(txn_gen_interval_ms=150, keygen_peer_count=2, encrypt=False,
                    coin_mode="hash", verify_shares=False, wire_sign=False, engine="cpu")
    defaults.update(kw)
    return pkg.Config(**defaults)


def gen_txns(count, nbytes):
    rng = random.Random()
    return [bytes(rng.getrandbits(8) for _ in range(max(nbytes, 1))) for _ in range(count)]


def make_node(pkg, ids, port, cfg, i):
    return pkg.Hydrabadger(ids.InAddr("127.0.0.1", port), cfg, seed=1000 + i)


async def start(nodes_ids, base_port):
    """Start nodes (each with its package's ids module); node i dials the
    ones before it."""
    nodes = []
    for i, (node, ids) in enumerate(nodes_ids):
        remotes = [ids.OutAddr("127.0.0.1", base_port + j) for j in range(i)]
        await node.start(remotes, gen_txns)
        nodes.append(node)
        await asyncio.sleep(0.05)
    return nodes


async def wait_for(pred, interval=0.05):
    while not pred():
        await asyncio.sleep(interval)


def batch_key(batch):
    return (batch.epoch, tuple(sorted((bytes(k), bytes(v)) for k, v in batch.contributions.items())))


def assert_agreement(nodes, depth):
    for e in range(depth):
        keys = {batch_key(n.batches[e]) for n in nodes}
        assert len(keys) == 1, f"divergence at batch {e}"


async def run_cluster(nodes_ids, base_port, batches, deadline_s):
    nodes = await start(nodes_ids, base_port)
    try:
        await asyncio.wait_for(wait_for(lambda: all(len(n.batches) >= batches for n in nodes)),
                               deadline_s)
        assert_agreement(nodes, min(len(n.batches) for n in nodes))
    finally:
        for n in nodes:
            await n.stop()
    return nodes


async def test_three_port_nodes_bootstrap_commit_and_take_a_user_contribution():
    cfg = fast_config(tnode)
    nodes = [make_node(tnode, tids, BASE_PORT + i, cfg, i) for i in range(3)]
    started = await start([(n, tids) for n in nodes], BASE_PORT)
    try:
        await asyncio.wait_for(wait_for(lambda: all(n.is_validator() for n in started)), 30)
        listener = started[0].register_epoch_listener()
        payload = b"user-contribution-\x00\x01"
        assert started[1].propose_user_contribution(payload)
        await asyncio.wait_for(wait_for(lambda: any(
            payload in bytes(v) for b in started[0].batches for v in b.contributions.values())), 30)
        await asyncio.wait_for(wait_for(lambda: all(len(n.batches) >= 2 for n in started)), 30)
        assert_agreement(started, min(len(n.batches) for n in started))
        assert listener.qsize() >= 1
        assert all(n.state == "validator" for n in started)
    finally:
        for n in started:
            await n.stop()


@pytest.mark.parametrize("tier", ["fast", "signed"])
async def test_mixed_cluster_of_port_and_jax_nodes_commits_agreed_batches(tier):
    """Nodes 0 and 2 are the port's, 1 and 3 the JAX package's: every
    handshake, DKG Part/Ack and consensus frame crosses between the
    packages.  "signed": every frame BLS-signed and batch-verified."""
    port = BASE_PORT + (10 if tier == "fast" else 20)
    sign = tier == "signed"
    nodes_ids = []
    for i in range(4):
        pkg, ids = (tnode, tids) if i % 2 == 0 else (jnode, jids)
        cfg = fast_config(pkg, keygen_peer_count=3, wire_sign=sign)
        nodes_ids.append((make_node(pkg, ids, port + i, cfg, i), ids))
    nodes = await run_cluster(nodes_ids, port, 2, 60)
    assert {type(n).__module__ for n in nodes} == {tnode.__name__, jnode.__name__}
    # the DKG formed one key set across the packages
    assert len({n.dhb.netinfo.pk_set.to_bytes() for n in nodes}) == 1
    if sign:
        for n in nodes:
            assert n.metrics.counter("wire_sig_rejected").value == 0
            assert n.metrics.counter("wire_rx_key_gen").value > 0


class _FailingEngine(teng.CpuEngine):
    """verify_batch raises, as a failed launch on the card would."""

    def verify_batch(self, items):
        raise RuntimeError("verify_batch failed")


async def test_a_failing_verify_batch_fails_the_handler_and_stop_raises():
    teng.register_engine("failing-verify", _FailingEngine)
    port = BASE_PORT + 30
    cfg = fast_config(tnode, wire_sign=True, engine="failing-verify")
    nodes = [make_node(tnode, tids, port + i, cfg, i) for i in range(3)]
    await start([(n, tids) for n in nodes], port)
    handlers = [n._tasks[0] for n in nodes]  # _handler_loop is the first task
    try:
        await asyncio.wait_for(wait_for(lambda: any(t.done() for t in handlers)), 30)
        failed = [t for t in handlers if t.done()]
        assert all(isinstance(t.exception(), RuntimeError) for t in failed)
        # the per-frame path never ran: no node became a validator
        assert not any(n.is_validator() for n in nodes)
    finally:
        errors = []
        for n in nodes:
            try:
                await n.stop()
            except RuntimeError as exc:
                errors.append(exc)
    assert errors and all("verify_batch failed" in str(e) for e in errors)


def test_config_engine_selection():
    assert tnode.Config().engine == "gpu"
    node = make_node(tnode, tids, BASE_PORT + 40, fast_config(tnode), 0)
    assert node.engine is teng.get_engine("cpu") and str(node.plane_device) == "cpu"
    with pytest.raises(ValueError):
        make_node(tnode, tids, BASE_PORT + 41, fast_config(tnode, engine="no-such-backend"), 0)


def test_config_default_engine_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delitem(teng._INSTANCES, "gpu", raising=False)
    with pytest.raises(RuntimeError, match="cuda"):
        make_node(tnode, tids, BASE_PORT + 42, tnode.Config(), 0)


def _restorable_checkpoint():
    """A validator's NodeCheckpoint from a 4-node port DHB sim, its ids
    mapped to 16-byte uids (order kept, so every key index holds)."""
    import dataclasses

    from hydrabadger_tpu_torch import checkpoint
    from hydrabadger_tpu_torch.sim.network import SimConfig, SimNetwork

    sim = SimNetwork(SimConfig(n_nodes=4, protocol="dhb", encrypt=False, coin_mode="hash",
                               seed=7, engine="cpu"))
    sim.run(1)
    nid = sim.ids[0]
    cp = checkpoint.NodeCheckpoint.capture(sim.id_sks[nid], sim.nodes[nid])
    uid = {n: n.encode().rjust(16, b"\0") for n in sim.ids}
    return dataclasses.replace(cp, uid=uid[nid], node_ids=tuple(uid[n] for n in cp.node_ids),
                               pub_keys={uid[n]: pk for n, pk in cp.pub_keys.items()})


def test_process_tier_features_raise_not_implemented(tmp_path):
    """The process tier's node features are ported and none raises: a
    chaos plane is attached (a stream the node builds is the plane's fault
    injector), `set_slo` installs and removes a tracker, and durable
    checkpoints work: a checkpoint path builds the node's store,
    `from_checkpoint` restores a validator at the saved cursor,
    `checkpoint()` captures it back, and the final persist writes it."""
    from hydrabadger_tpu_torch.checkpoint import CheckpointStore
    from hydrabadger_tpu_torch.net.chaos import ChaosPlane, ChaosWireStream, WireChaosSpec
    from hydrabadger_tpu_torch.obs.latency import SloSpec, SloTracker

    addr = tids.InAddr("127.0.0.1", BASE_PORT + 43)
    plane = ChaosPlane(WireChaosSpec())
    chaotic = tnode.Hydrabadger(addr, fast_config(tnode), seed=1, chaos=plane)
    assert chaotic.chaos is plane
    assert isinstance(chaotic._new_stream(None, None), ChaosWireStream)
    node = tnode.Hydrabadger(addr, fast_config(tnode), seed=1)
    node.set_slo(SloSpec(threshold_s=1.0))
    assert isinstance(node._slo_tracker, SloTracker)
    node.set_slo(None)
    assert node._slo_tracker is None
    with pytest.raises(RuntimeError, match="not active"):
        node.checkpoint()  # no consensus core yet
    path = str(tmp_path / "node.ckpt")
    cp = _restorable_checkpoint()
    node = tnode.Hydrabadger.from_checkpoint(addr, cp, fast_config(tnode, checkpoint_path=path),
                                             seed=1)
    assert node.is_validator() and node.state == "validator"
    assert node.our_id == cp.uid and node.current_epoch == cp.epoch == node.dhb.epoch
    assert node.checkpoint() == cp
    assert node._ckpt_store is not None and node._ckpt_store.load() is None
    asyncio.run(node.stop())  # the graceful stop's final persist
    assert CheckpointStore(path).load() == cp
    assert node.metrics.counter("checkpoints_persisted").value == 1


async def test_an_impossible_slo_on_a_testnet_is_a_fault():
    """`set_slo` on a 4-node fast-tier testnet with a threshold no commit
    can meet: every node counts slo_violations and rings the fault."""
    from hydrabadger_tpu_torch.obs.latency import SloSpec

    cfg = fast_config(tnode, keygen_peer_count=3)
    nodes = [make_node(tnode, tids, BASE_PORT + 50 + i, cfg, i) for i in range(4)]
    for n in nodes:
        n.set_slo(SloSpec(percentile=0.5, threshold_s=1e-9, window=64, min_samples=2))
    started = await start([(n, tids) for n in nodes], BASE_PORT + 50)
    try:
        await asyncio.wait_for(wait_for(lambda: all(
            n.metrics.counter("slo_violations").value > 0 for n in started)), 60)
        for n in started:
            assert any(f.kind.startswith("slo violation:") for _nid, f in n.fault_log)
            assert n._slo_tracker.violations == n.metrics.counter("slo_violations").value
        assert_agreement(started, min(len(n.batches) for n in started))
    finally:
        for n in started:
            await asyncio.wait_for(n.stop(), 30)


def test_cli_help_and_parse_match_the_jax_cli(capsys):
    with pytest.raises(SystemExit) as exc:
        tmain.make_parser().parse_args(["--help"])
    assert exc.value.code == 0
    out = capsys.readouterr().out
    assert "--engine {gpu,cpu}" in out and "--device" in out
    argv = ["-b", "127.0.0.1:3000", "-r", "127.0.0.1:3001", "-r", "10.0.0.2:3002",
            "--txn-gen-count", "7", "--txn-gen-interval", "300", "--txn-gen-bytes", "4",
            "--keygen-node-count", "4", "--rbc", "lowcomm", "--fast-crypto", "--seed", "9",
            "--batch-log", "b.jsonl", "--engine", "cpu"]
    for extra in ([], ["--checkpoint", "n.ckpt", "--checkpoint-every", "3", "--flight"],
                  ["--checkpoint=c", "--flight", "obs/n0"]):
        mine = vars(tmain.make_parser().parse_args(argv + extra))
        theirs = vars(jmain.make_parser().parse_args(argv + extra))
        assert mine.pop("device") == "cuda"
        assert mine == theirs
    assert mine["checkpoint"] == "c" and mine["flight"] == "obs/n0"
    assert vars(tmain.make_parser().parse_args(["--flight"]))["flight"] == tmain.FLIGHT_DEFAULT_DIR
    assert tmain.make_parser().parse_args([]).engine == "gpu"
