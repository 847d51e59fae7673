"""The port's checkpoints (hydrabadger_tpu_torch/checkpoint.py) on the CPU.

The JAX package's tests/test_checkpoint.py, case for case, on the port's
host engine (`engine="cpu"`): node checkpoints' codec round trip and
integrity, a restart of every node from its checkpoint, the generational
store's rotation and loud fallbacks, sim resume (interrupted ==
uninterrupted, also with the era switch's DKG in flight), the sim CLI's
flags and the HMAC container.  `TestCrossProcessRecovery` waits for
`net/cluster` (a later slice of the port).

Across the packages: a `NodeCheckpoint` of the same DHB state has the same
bytes in both, each package reads the other's; the port's resumed sim
commits the uninterrupted JAX sim's batches; a JAX sim file is refused, and
so is a sim that holds a tensor; and three JAX TCP nodes, stopped and saved
with the JAX `save_node`, come back as port nodes through the port's
`load_node` / `from_checkpoint` and commit agreed batches.  On the port's
own TCP nodes: a generation persisted at every committed epoch, and
`crash()` raising the device error it settles (localhost ports
15500-15599).
"""
import asyncio
import dataclasses
import random

import pytest
import torch

from hydrabadger_tpu import checkpoint as jckpt
from hydrabadger_tpu.net import node as jnode
from hydrabadger_tpu.sim import network as jnet
from hydrabadger_tpu.utils import ids as jids
from hydrabadger_tpu_torch import checkpoint as ckpt
from hydrabadger_tpu_torch.crypto import threshold as th
from hydrabadger_tpu_torch.net import node as tnode
from hydrabadger_tpu_torch.obs.metrics import MetricsRegistry
from hydrabadger_tpu_torch.sim.__main__ import main as sim_main
from hydrabadger_tpu_torch.sim.network import SimConfig, SimNetwork, drop_adversary
from hydrabadger_tpu_torch.sim.router import Router
from hydrabadger_tpu_torch.utils import ids as tids

BASE_PORT = 15500


@pytest.fixture(autouse=True)
def no_mac_key(monkeypatch):
    """Plain SHA-256 containers unless a test sets the key itself."""
    monkeypatch.delenv("HYDRABADGER_CKPT_KEY", raising=False)


def _dhb_sim(n=4, epochs=1, seed=7, net_mod=None):
    cfg = dict(n_nodes=n, protocol="dhb", epochs=epochs, encrypt=False, coin_mode="hash",
               seed=seed, engine="cpu")
    if net_mod is jnet:
        net = jnet.SimNetwork(jnet.SimConfig(native_acs=False, **cfg))
    else:
        net = SimNetwork(SimConfig(native_acs=False, **cfg))
    net.run(epochs)
    return net


def _batch_keys(node):
    out = []
    for b in node.batches:
        items = []
        for p, v in sorted(b.contributions.items()):
            if isinstance(v, (list, tuple)):
                items.append((p, tuple(bytes(x) for x in v)))
            else:
                items.append((p, bytes(v)))
        out.append(tuple(items))
    return out


def _all_keys(sim):
    return {n: _batch_keys(sim.nodes[n]) for n in sim.ids}


class TestNodeCheckpoint:
    def test_roundtrip(self):
        net = _dhb_sim()
        nid = net.ids[0]
        dhb = net.nodes[nid]
        cp = ckpt.NodeCheckpoint.capture(net.id_sks[nid], dhb)
        again = ckpt.NodeCheckpoint.from_bytes(cp.to_bytes())
        assert again == cp
        assert again.era == dhb.era and again.epoch == dhb.epoch
        assert again.sk_share  # captured as validator

    def test_integrity_and_kind_checks(self):
        net = _dhb_sim()
        nid = net.ids[0]
        raw = bytearray(ckpt.NodeCheckpoint.capture(net.id_sks[nid], net.nodes[nid]).to_bytes())
        raw[-1] ^= 0xFF
        with pytest.raises(ckpt.CheckpointError):
            ckpt.NodeCheckpoint.from_bytes(bytes(raw))
        with pytest.raises(ckpt.CheckpointError):
            ckpt.NodeCheckpoint.from_bytes(b"garbage")
        with pytest.raises(ckpt.CheckpointError):
            ckpt.sim_from_bytes(bytes(raw))  # node ckpt is not a sim ckpt

    def test_restored_network_keeps_committing(self):
        """Restore EVERY node from its checkpoint and run another epoch:
        the rebuilt cores must agree — the restart-the-world scenario."""
        net = _dhb_sim(n=4, epochs=2)
        epoch0 = net.nodes[net.ids[0]].epoch
        cps = {nid: ckpt.NodeCheckpoint.capture(net.id_sks[nid], net.nodes[nid]) for nid in net.ids}
        nodes = {
            nid: ckpt.NodeCheckpoint.from_bytes(cp.to_bytes()).restore_dhb(
                encrypt=False, coin_mode="hash", rng=random.Random(100 + i), engine="cpu")
            for i, (nid, cp) in enumerate(sorted(cps.items()))
        }
        router = Router(list(nodes), lambda me, s, m: nodes[me].handle_message(s, m),
                        seed=1, shuffle=True)
        rng = random.Random(42)
        for nid, dhb in nodes.items():
            assert dhb.is_validator
            assert dhb.epoch == epoch0
            router.dispatch_step(nid, dhb.propose(b"post-restore-" + nid.encode(), rng))
        router.run()
        batches = {nid: dhb.batches for nid, dhb in nodes.items()}
        assert all(len(b) == 1 for b in batches.values())
        first = [sorted(b[0].contributions.items()) for b in batches.values()]
        assert all(f == first[0] for f in first)
        assert all(b[0].epoch == epoch0 for b in batches.values())


class TestCheckpointStore:
    """The generational store: atomic writes, rotation, and the loud
    corrupt-file fallback."""

    @pytest.fixture(scope="class")
    def cp(self):
        net = _dhb_sim()
        nid = net.ids[0]
        return ckpt.NodeCheckpoint.capture(net.id_sks[nid], net.nodes[nid])

    def _store(self, tmp_path, metrics=None, faults=None):
        return ckpt.CheckpointStore(
            str(tmp_path / "node.ckpt"), metrics=metrics,
            fault=(lambda kind: faults.append(kind)) if faults is not None else None)

    def _two(self, store, cp):
        store.save(cp)
        cp2 = ckpt.NodeCheckpoint(**{**cp.__dict__, "epoch": cp.epoch + 5})
        store.save(cp2)
        return cp2

    def test_save_rotates_and_load_prefers_newest(self, tmp_path, cp):
        store = self._store(tmp_path)
        store.save(cp)
        assert store.load() == cp
        cp2 = ckpt.NodeCheckpoint(**{**cp.__dict__, "epoch": cp.epoch + 5})
        store.save(cp2)
        paths = store.generation_paths()
        assert all(ckpt.load_node(p) is not None for p in paths)
        assert store.load() == cp2
        assert ckpt.load_node(paths[1]) == cp

    def test_truncated_newest_falls_back_loudly(self, tmp_path, cp):
        metrics, faults = MetricsRegistry(), []
        store = self._store(tmp_path, metrics, faults)
        self._two(store, cp)
        raw = open(store.path, "rb").read()
        open(store.path, "wb").write(raw[: len(raw) // 2])  # SIGKILL mid-write
        assert store.load() == cp  # the PREVIOUS generation, not garbage
        assert metrics.counter("checkpoint_corrupt_rejected").value == 1
        assert metrics.counter("checkpoint_generation_fallbacks").value == 1
        assert faults == ["checkpoint: corrupt generation rejected"]

    def test_bitflipped_newest_falls_back_loudly(self, tmp_path, cp):
        metrics, faults = MetricsRegistry(), []
        store = self._store(tmp_path, metrics, faults)
        self._two(store, cp)
        raw = bytearray(open(store.path, "rb").read())
        raw[len(raw) // 2] ^= 0x40  # one flipped bit in the payload
        open(store.path, "wb").write(bytes(raw))
        assert store.load() == cp
        assert metrics.counter("checkpoint_corrupt_rejected").value == 1
        assert faults, "corruption must hit the fault hook"

    def test_every_generation_bad_returns_none(self, tmp_path, cp):
        metrics = MetricsRegistry()
        store = self._store(tmp_path, metrics)
        store.save(cp)
        store.save(cp)
        for p in store.generation_paths():
            open(p, "wb").write(b"not a checkpoint at all")
        assert store.load() is None  # boot fresh, never resume garbage
        assert metrics.counter("checkpoint_corrupt_rejected").value == 2

    def test_missing_files_load_none_quietly(self, tmp_path):
        metrics = MetricsRegistry()
        assert self._store(tmp_path, metrics).load() is None
        # absent files are a fresh boot, not corruption
        assert metrics.counter("checkpoint_corrupt_rejected").value == 0


class TestSimCheckpoint:
    def test_resume_bit_identical(self):
        cfg = dict(n_nodes=4, protocol="qhb", seed=3, engine="cpu")
        straight = SimNetwork(SimConfig(**cfg))
        straight.run(6)
        interrupted = SimNetwork(SimConfig(**cfg))
        interrupted.run(3)
        resumed = ckpt.sim_from_bytes(ckpt.sim_to_bytes(interrupted))
        resumed.run(3)
        a, b = _all_keys(straight), _all_keys(resumed)
        assert a == b
        assert len(a[straight.ids[0]]) == 6

    def test_save_does_not_disturb_live_sim(self):
        adv = drop_adversary(0.05, seed=9)
        net = SimNetwork(SimConfig(n_nodes=4, seed=5, adversary=adv, engine="cpu"))
        net.run(1)
        ckpt.sim_to_bytes(net)
        assert net.cfg.adversary is adv  # re-attached after save
        assert net.router.adversary is adv
        net.run(1)  # still functional

    def test_adversary_required_on_resume(self):
        net = SimNetwork(SimConfig(n_nodes=4, seed=5, adversary=drop_adversary(0.05, seed=9),
                                   engine="cpu"))
        net.run(1)
        blob = ckpt.sim_to_bytes(net)
        with pytest.raises(ckpt.CheckpointError, match="adversary"):
            ckpt.sim_from_bytes(blob)
        resumed = ckpt.sim_from_bytes(blob, adversary=drop_adversary(0.05, 9))
        resumed.run(1)


def _voted_sim(seed=19, net_mod=None):
    """A 4-node dhb sim where every node votes to add a joiner: the
    era-switch DKG starts mid-run and stays in flight for a few epochs
    (parts/acks ride committed contributions)."""
    cfg = dict(n_nodes=4, protocol="dhb", encrypt=False, coin_mode="hash", seed=seed,
               engine="cpu")
    if net_mod is jnet:
        from hydrabadger_tpu.crypto import threshold as jth

        net = jnet.SimNetwork(jnet.SimConfig(native_acs=False, **cfg))
        joiner_pk = jth.SecretKey.random(random.Random(77)).public_key()
    else:
        net = SimNetwork(SimConfig(native_acs=False, **cfg))
        joiner_pk = th.SecretKey.random(random.Random(77)).public_key()
    net.run(1)
    for nid in net.ids:
        net.nodes[nid].vote_to_add("n900", joiner_pk)
    return net


def _eras(sim):
    return {(d.era, d.netinfo.pk_set.to_bytes()) for d in sim.nodes.values()}


class TestMidEraCrash:
    def test_snapshot_with_dkg_in_flight_resumes_identically(self):
        """Checkpoint a sim mid-era-switch — DKG machines live, pending
        parts/acks queued, in-flight work settled first — restore it, and
        the resumed run commits byte-identical batches to an uninterrupted
        twin, through the era switch and beyond."""
        straight = _voted_sim()
        straight.run(6)
        assert any(d.era > 0 for d in straight.nodes.values()), "era never switched"
        interrupted = _voted_sim()
        interrupted.run(2)
        in_flight = [nid for nid in interrupted.ids if interrupted.nodes[nid].key_gen is not None]
        assert in_flight, "no node had a live era-switch DKG at snapshot"
        assert any(interrupted.nodes[nid].key_gen.key_gen.parts or interrupted.nodes[nid].pending_kg
                   for nid in in_flight), "DKG had no pending parts/acks at snapshot"
        interrupted._drain_async()
        resumed = ckpt.sim_from_bytes(ckpt.sim_to_bytes(interrupted))
        resumed.run(4)
        assert _all_keys(straight) == _all_keys(resumed)
        assert any(d.era > 0 for d in resumed.nodes.values())
        assert _eras(straight) == _eras(resumed)

    def test_snapshot_between_seal_and_cutover_resumes_identically(self):
        """Checkpoint in the narrowest cutover window — the shadow DKG is
        complete (transcript sealed, keys pre-generated) but the cutover
        batch has not committed — and the resumed run commits the same
        batches and new-era pk_set as an uninterrupted twin."""
        total = 8
        straight = _voted_sim(seed=31)
        straight.run(total)
        assert any(d.era > 0 for d in straight.nodes.values()), "era never switched"
        interrupted = _voted_sim(seed=31)
        done, sealed = 0, []
        while done < total:
            interrupted.run(1)
            done += 1
            sealed = [nid for nid in interrupted.ids if interrupted.nodes[nid].key_gen is not None
                      and interrupted.nodes[nid].key_gen.sealed]
            if sealed and all(d.era == 0 for d in interrupted.nodes.values()):
                break
        assert sealed, "sealed-but-uncommitted cutover window never seen"
        assert any(interrupted.nodes[nid].key_gen.gen_cache is not None for nid in sealed)
        interrupted._drain_async()
        resumed = ckpt.sim_from_bytes(ckpt.sim_to_bytes(interrupted))
        resumed.run(total - done)
        assert _all_keys(straight) == _all_keys(resumed)
        assert any(d.era > 0 for d in resumed.nodes.values())
        assert _eras(straight) == _eras(resumed)


class TestCli:
    def test_checkpoint_and_resume_flags(self, tmp_path, capsys):
        import json

        path = tmp_path / "sim.ckpt"
        rc = sim_main(["--engine", "cpu", "--nodes", "4", "--epochs", "2", "--json",
                       "--checkpoint", str(path), "--checkpoint-every", "1"])
        assert rc == 0 and path.exists()
        rc = sim_main(["--resume", str(path), "--epochs", "2", "--json"])
        assert rc == 0
        lines = capsys.readouterr().out.strip().splitlines()
        assert json.loads(lines[-1])["epochs_done"] == 4


def test_authenticated_checkpoint_hmac(monkeypatch):
    """HYDRABADGER_CKPT_KEY turns the container digest into an HMAC: key
    mismatches and key/no-key crossings fail loudly and honestly."""
    payload = b"payload-bytes"
    monkeypatch.setenv("HYDRABADGER_CKPT_KEY", "sekrit")
    boxed = ckpt._pack(ckpt._KIND_SIM, payload)
    assert ckpt._unpack(boxed, ckpt._KIND_SIM) == payload
    assert boxed == jckpt._pack(jckpt._KIND_SIM, payload)  # the JAX container, byte for byte
    monkeypatch.setenv("HYDRABADGER_CKPT_KEY", "other")
    with pytest.raises(ckpt.CheckpointError, match="wrong key"):
        ckpt._unpack(boxed, ckpt._KIND_SIM)
    monkeypatch.delenv("HYDRABADGER_CKPT_KEY")
    with pytest.raises(ckpt.CheckpointError, match="set HYDRABADGER_CKPT_KEY"):
        ckpt._unpack(boxed, ckpt._KIND_SIM)
    plain = ckpt._pack(ckpt._KIND_SIM, payload)
    assert ckpt._unpack(plain, ckpt._KIND_SIM) == payload
    monkeypatch.setenv("HYDRABADGER_CKPT_KEY", "sekrit")
    with pytest.raises(ckpt.CheckpointError, match="unauthenticated"):
        ckpt._unpack(plain, ckpt._KIND_SIM)


# -- across the packages --------------------------------------------------------


def test_node_checkpoints_have_the_jax_bytes_and_cross_load():
    """A port and a JAX DHB sim at the same seed and epochs hold the same
    state: every node's checkpoint has the same bytes in both packages,
    and each package reads the other's."""
    ours, theirs = _dhb_sim(epochs=2), _dhb_sim(epochs=2, net_mod=jnet)
    for nid in ours.ids:
        mine = ckpt.NodeCheckpoint.capture(ours.id_sks[nid], ours.nodes[nid])
        jax = jckpt.NodeCheckpoint.capture(theirs.id_sks[nid], theirs.nodes[nid])
        assert mine.to_bytes() == jax.to_bytes()
        assert ckpt.NodeCheckpoint.from_bytes(jax.to_bytes()) == mine
        assert jckpt.NodeCheckpoint.from_bytes(mine.to_bytes()) == jax
        assert mine.epoch == 2 and mine.sk_share


@pytest.mark.parametrize("case", ["qhb", "dhb-mid-era"])
def test_resumed_port_sim_commits_the_uninterrupted_jax_sims_bytes(case):
    if case == "qhb":
        cfg = dict(n_nodes=4, protocol="qhb", seed=3, engine="cpu")
        straight = jnet.SimNetwork(jnet.SimConfig(native_acs=False, **cfg))
        straight.run(6)
        interrupted = SimNetwork(SimConfig(native_acs=False, **cfg))
        interrupted.run(3)
        rest = 3
    else:
        straight = _voted_sim(net_mod=jnet)
        straight.run(6)
        interrupted = _voted_sim()
        interrupted.run(2)
        assert any(d.key_gen is not None for d in interrupted.nodes.values())
        rest = 4
    resumed = ckpt.sim_from_bytes(ckpt.sim_to_bytes(interrupted))
    resumed.run(rest)
    assert _all_keys(resumed) == _all_keys(straight)
    if case != "qhb":
        assert _eras(resumed) == _eras(straight)
        assert any(d.era > 0 for d in resumed.nodes.values())


def test_a_jax_sim_file_and_a_sim_holding_a_tensor_are_refused():
    net = jnet.SimNetwork(jnet.SimConfig(n_nodes=4, seed=3, engine="cpu", native_acs=False))
    net.run(1)
    with pytest.raises(ckpt.CheckpointError, match="JAX package"):
        ckpt.sim_from_bytes(jckpt.sim_to_bytes(net))
    ours = SimNetwork(SimConfig(n_nodes=4, seed=3, engine="cpu", native_acs=False))
    ours.run(1)
    ours.nodes[ours.ids[1]].stash = {"limbs": torch.zeros(3, dtype=torch.int32)}
    with pytest.raises(ckpt.CheckpointError, match=r"sim\.nodes\['n001'\]\.stash\['limbs'\]"):
        ckpt.sim_to_bytes(ours)


def _fast(pkg, **kw):
    return pkg.Config(txn_gen_interval_ms=150, keygen_peer_count=2, encrypt=False,
                      coin_mode="hash", verify_shares=False, wire_sign=False, engine="cpu", **kw)


def _gen_txns(count, nbytes):
    rng = random.Random()
    return [bytes(rng.getrandbits(8) for _ in range(max(nbytes, 1))) for _ in range(count)]


async def _until(pred, deadline_s):
    async def poll():
        while not pred():
            await asyncio.sleep(0.05)

    await asyncio.wait_for(poll(), deadline_s)


async def test_jax_nodes_restart_from_their_checkpoints_as_port_nodes(tmp_path):
    """Three JAX nodes commit, stop, and are saved with the JAX
    `save_node`; each comes back as a port node through the port's
    `load_node` and `from_checkpoint` (epochs aligned to the newest, the
    restart recipe of the JAX tests/test_net.py), reconnects over TCP and
    commits agreed batches from the newest epoch on."""
    base = BASE_PORT
    nodes = []
    try:
        for i in range(3):
            node = jnode.Hydrabadger(jids.InAddr("127.0.0.1", base + i), _fast(jnode), seed=1000 + i)
            await node.start([jids.OutAddr("127.0.0.1", base + j) for j in range(i)], _gen_txns)
            nodes.append(node)
            await asyncio.sleep(0.05)
        await _until(lambda: min(len(n.batches) for n in nodes) >= 2, 60)
    finally:
        for n in nodes:
            await n.stop()
    for i, n in enumerate(nodes):
        jckpt.save_node(str(tmp_path / f"node{i}.ckpt"), n.checkpoint())
    cps = [ckpt.load_node(str(tmp_path / f"node{i}.ckpt")) for i in range(3)]
    top = max(c.epoch for c in cps)
    cps = [dataclasses.replace(c, epoch=top) for c in cps]
    restored = []
    for i, cp in enumerate(cps):
        node = tnode.Hydrabadger.from_checkpoint(tids.InAddr("127.0.0.1", base + 10 + i), cp,
                                                 _fast(tnode), seed=2000 + i)
        assert node.is_validator() and node.our_id == nodes[i].our_id
        restored.append(node)
    try:
        for i, node in enumerate(restored):
            await node.start([tids.OutAddr("127.0.0.1", base + 10 + j) for j in range(3) if j != i],
                             _gen_txns)
        await _until(lambda: min(len(n.batches) for n in restored) >= 2, 60)
    finally:
        for n in restored:
            await n.stop()
    depth = min(len(n.batches) for n in restored)
    for e in range(depth):
        assert len({tuple(sorted(n.batches[e].contributions.items())) for n in restored}) == 1
    assert all(n.batches[0].epoch >= top for n in restored)
    assert {n.dhb.netinfo.pk_set.to_bytes() for n in restored} == {
        n.dhb.netinfo.pk_set.to_bytes() for n in nodes}


async def test_port_nodes_persist_every_epoch_and_crash_raises_a_device_error(tmp_path):
    """Three port nodes with a store each persist a generation at every
    committed epoch (the executor write).  `crash()` writes no final
    checkpoint, closes its server and sockets, and raises the error of the
    device work it settles instead of discarding it; its store still
    holds the cadence's newest generation."""
    base = BASE_PORT + 20
    nodes = [tnode.Hydrabadger(tids.InAddr("127.0.0.1", base + i),
                               _fast(tnode, checkpoint_path=str(tmp_path / f"n{i}.ckpt")),
                               seed=3000 + i) for i in range(3)]
    try:
        for i, node in enumerate(nodes):
            await node.start([tids.OutAddr("127.0.0.1", base + j) for j in range(i)], _gen_txns)
            await asyncio.sleep(0.05)
        await _until(lambda: min(len(n.batches) for n in nodes) >= 2, 60)
        await _until(lambda: all(n.metrics.counter("checkpoints_persisted").value >= 2
                                 for n in nodes), 30)
        victim = nodes[0]
        persisted = victim.metrics.counter("checkpoints_persisted").value

        def lost():
            raise RuntimeError("device lost")

        victim.dhb.drain_async = lost
        with pytest.raises(RuntimeError, match="device lost"):
            await victim.crash()
        assert not victim._server.is_serving() and all(t.done() for t in victim._tasks)
        assert victim.metrics.counter("checkpoints_persisted").value == persisted
        saved = ckpt.CheckpointStore(str(tmp_path / "n0.ckpt")).load()
        assert saved is not None and saved.uid == victim.our_id and saved.sk_share
        assert 1 <= saved.epoch <= victim.current_epoch
    finally:
        for n in nodes[1:]:
            await n.stop()
