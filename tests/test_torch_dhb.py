"""The port's DynamicHoneyBadger simulator against the JAX package's.

`SimNetwork(protocol="dhb", engine="cpu")` in the port and the JAX
package's `SimNetwork(protocol="dhb", engine="cpu", native_acs=False)`,
4 nodes: a bootstrap epoch, a removal vote for the last node, epochs until
every survivor is in the new era (a full DKG among the 3 survivors, the
removed node following the transcript as an observer), then one steady
epoch.  Every node's batches are equal byte for byte, with the same eras,
`PublicKeySet`s, change reports, message count and faults.  The port's own
run gives the same bytes with the DKG's device plane on (`tpu_dkg=True`:
the plain versions of kernel B2 on the CPU) and with the futures' deferral
off.  At the core level over the port's router, an added node joins from
the committed `JoinPlan` as an observer and tracks the validators' batches.
"""
import random

import pytest
import torch

from hydrabadger_tpu.sim import network as jnet
from hydrabadger_tpu_torch.consensus.dynamic_honey_badger import DynamicHoneyBadger
from hydrabadger_tpu_torch.consensus.types import NetworkInfo
from hydrabadger_tpu_torch.crypto import dkg
from hydrabadger_tpu_torch.crypto import threshold as th
from hydrabadger_tpu_torch.ops import msm_torch
from hydrabadger_tpu_torch.sim import __main__ as cli
from hydrabadger_tpu_torch.sim import network
from hydrabadger_tpu_torch.sim.router import Router


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run many tiny ops: one thread each, and no
    autograd bookkeeping (inference mode: the same values, less overhead
    per op)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.inference_mode():
        yield
    torch.set_num_threads(before)


CFG = dict(n_nodes=4, protocol="dhb", txns_per_node_per_epoch=4, txn_bytes=2, seed=7)


def era_switch(net_mod, **kw):
    """Bootstrap, a removal vote for the last node, epochs until every
    survivor switched era, then one steady epoch."""
    sim = net_mod.SimNetwork(net_mod.SimConfig(engine="cpu", native_acs=False, **CFG, **kw))
    sim.run(1)
    victim = sim.ids[-1]
    for nid in sim.ids[:-1]:
        sim.router.dispatch_step(nid, sim.nodes[nid].vote_to_remove(victim))
    for _ in range(8):
        sim.run(1)
        if all(sim.nodes[nid].era > 0 for nid in sim.ids[:-1]):
            break
    return sim, sim.run(1)


def record(sim, m):
    def batches(nid):
        return [(b.epoch, b.era, b.change, tuple((p, bytes(v)) for p, v in sorted(b.contributions.items())),
                 None if b.join_plan is None else b.join_plan.wire())
                for b in sim.nodes[nid].batches]

    return {
        "batches": {nid: batches(nid) for nid in sim.ids},
        "eras": {nid: sim.nodes[nid].era for nid in sim.ids},
        "pk_set": {nid: sim.nodes[nid].netinfo.pk_set.to_bytes() for nid in sim.ids},
        "validators": {nid: tuple(sim.nodes[nid].netinfo.node_ids) for nid in sim.ids},
        "counts": (m.epochs_done, m.messages_delivered, m.bytes_committed, m.faults, m.agreement_ok),
        "faults": [(s, f.node_id, f.kind) for s, f in sim.router.faults],
    }


@pytest.fixture(scope="module")
def jax_record():
    return record(*era_switch(jnet))


@pytest.fixture(scope="module")
def port_record():
    dkg.clear_caches()
    return record(*era_switch(network, tpu_dkg=False))


def test_era_switch_commits_the_jax_batches(jax_record, port_record):
    assert port_record == jax_record
    victim = "n003"
    eras = port_record["eras"]
    assert all(eras[nid] > 0 for nid in eras) and len(set(eras.values())) == 1
    survivors = [nid for nid in eras if nid != victim]
    assert all(port_record["validators"][nid] == tuple(survivors) for nid in eras)
    done = [b for b in port_record["batches"]["n000"] if b[2] and b[2][0] == "complete"]
    assert done and done[0][2][1] == ("remove", victim) and done[0][4] is not None
    epochs, _msgs, _bytes, faults, agreed = port_record["counts"]
    assert agreed and epochs == len(port_record["batches"]["n000"])
    # the only faults: the removed node's last messages, reaching the new era
    assert faults == len(port_record["faults"]) > 0
    assert {(who, kind) for _s, who, kind in port_record["faults"]} == {
        (victim, "hb: message from non-validator")}


def test_device_plane_and_deferral_give_the_same_bytes(port_record):
    """tpu_dkg=True runs the era switch's MSMs, folds and channel keys
    through ops/msm_torch, ops/vandermonde_torch and ops/bls_torch on the
    CPU; async_dispatch=False settles every keygen flush where it is
    submitted.  Both commit the host run's bytes."""
    lanes = msm_torch.M.default_registry().counter(msm_torch.M.MSM_REAL_LANES)
    flushes = msm_torch.M.default_registry().counter(msm_torch.M.MSM_COALESCE_FLUSHES)
    before = (lanes.value, flushes.value)
    dkg.clear_caches()
    assert record(*era_switch(network, tpu_dkg=True)) == port_record
    assert lanes.value > before[0] and flushes.value > before[1]
    dkg.clear_caches()
    assert record(*era_switch(network, tpu_dkg=False, async_dispatch=False)) == port_record


def test_era_gap_snapshot_after_the_switch():
    sim, m = era_switch(network, tpu_dkg=False)
    snap = sim.era_gap_snapshot()
    assert snap["era_commit_gap_s"] > 0 and snap["shadow_dkg"] is True
    assert snap["shadow_dkg_stall_epochs"] == 0 and snap["device_backend"] == "none"
    assert sim.metrics.gauge("era_commit_gap_s").high_water == snap["era_commit_gap_s"]


def make_cluster(n, seed=0):
    """n validators with dealer keys and node identity keys (the JAX
    package's tests/test_dynamic_honey_badger.py cluster)."""
    rng = random.Random(seed)
    ids = [f"n{i}" for i in range(n)]
    t = (n - 1) // 3
    sks = th.SecretKeySet.random(t, rng)
    pk_set = sks.public_keys()
    id_sks = {i: th.SecretKey.random(rng) for i in ids}
    pub_keys = {i: id_sks[i].public_key() for i in ids}
    dhbs = {i: DynamicHoneyBadger(i, id_sks[i], NetworkInfo(i, ids, pk_set, sks.secret_key_share(idx)),
                                  pub_keys, encrypt=False, coin_mode="hash",
                                  rng=random.Random(seed + 100 + idx), engine="cpu")
            for idx, i in enumerate(ids)}
    return ids, dhbs


def test_add_validator_via_join_plan():
    """The JAX package's test_add_validator_via_join_plan over the port's
    cores and router: an add vote completes with a JoinPlan naming the
    joiner, which comes up as an observer of the new era from it and
    commits the validators' batches."""
    ids, dhbs = make_cluster(4)
    rng = random.Random(3)
    joiner = "n9"
    joiner_sk = th.SecretKey.random(rng)
    observer = {}

    def handle(me, sender, msg):
        if me == joiner:
            return observer[joiner].handle_message(sender, msg) if observer else None
        return dhbs[me].handle_message(sender, msg)

    router = Router(ids + [joiner], handle)
    for i in ids:
        dhbs[i].vote_to_add(joiner, joiner_sk.public_key())
    done = []
    for _ in range(10):
        for i in ids:
            if dhbs[i].is_validator:
                router.dispatch_step(i, dhbs[i].propose(f"c-{i}-{dhbs[i].epoch}".encode(), rng))
        router.run()
        done = [b for b in dhbs[ids[0]].batches if b.change and b.change[0] == "complete" and b.join_plan]
        if done:
            break
    assert done, "add change never completed"
    plan = done[0].join_plan
    assert joiner in plan.node_ids
    observer[joiner] = DynamicHoneyBadger.from_join_plan(joiner, joiner_sk, plan, encrypt=False,
                                                         coin_mode="hash", rng=random.Random(99),
                                                         engine="cpu")
    assert not observer[joiner].is_validator and observer[joiner].era == plan.era
    for _ in range(2):
        for i in ids:
            if dhbs[i].is_validator:
                router.dispatch_step(i, dhbs[i].propose(f"c-{i}-{dhbs[i].epoch}".encode(), rng))
        router.run()
    obs_batches = observer[joiner].batches
    assert obs_batches, "observer saw no batches"
    v_batches = {b.epoch: b for b in dhbs[ids[0]].batches}
    for b in obs_batches:
        assert sorted(b.contributions.items()) == sorted(v_batches[b.epoch].contributions.items())


def test_cli_runs_dhb_on_the_host_engine(capsys):
    assert cli.main(["--protocol", "dhb", "--engine", "cpu", "--nodes", "4", "--epochs", "2",
                     "--json"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"agreement_ok": true' in line and '"epochs_done": 2' in line
