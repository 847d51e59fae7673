"""parallel/mesh.py on the port against the JAX package's mesh.

The port runs the mesh as SPMD ranks under torch.distributed: here world
size 2 over gloo on the CPU, started once for the module by
`mesh.run_ranks` (spawned children that run tests/_torch_mesh_legs.py,
which imports the port only: never this module, so never JAX), plus world
size 1 in this process, as chip_smoke runs it on the card.  The JAX functions run on the 8-device CPU mesh of
tests/conftest.py.  The rounds and encodes compare byte for byte (the
ranks' shards assembled), the full-crypto epochs limb for limb against the
port's unsharded sims, the pairing inputs point for point against JAX's.
"""
import contextlib
import random
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

from hydrabadger_tpu.crypto import bls12_381 as jbls
from hydrabadger_tpu.crypto.rs import ReedSolomon as JaxReedSolomon
from hydrabadger_tpu.parallel import mesh as jmesh
from hydrabadger_tpu_torch.crypto import bls12_381 as bls
from hydrabadger_tpu_torch.crypto.rs import ReedSolomon
from hydrabadger_tpu_torch.ops import bls_torch
from hydrabadger_tpu_torch.parallel import mesh as pmesh
from hydrabadger_tpu_torch.sim import tensor as ts

from _torch_mesh_legs import BAD, ENCODE, ROUND, ROUND64, VERDICTS, every_leg

WORLD = 2


def _references() -> dict:
    """What the ranks are held against, computed while they run."""
    jm = jmesh.make_mesh(8)
    received, decoded = jmesh.broadcast_round_sharded(ROUND, 6, 2, jm)
    out = {"jax_round": (np.asarray(received), np.asarray(decoded)),
           "jax_encode": np.asarray(jmesh.instances_sharded_encode(ENCODE, 4, 2, jm))}
    sim = ts.FullCryptoTensorSim(ts.FullCryptoConfig(n_nodes=4, instances=2, share_chunks=1),
                                 device="cpu")
    assert sim.run(1)
    out["instance_sim"] = sim
    cfg = ts.FullCryptoConfig(n_nodes=4, instances=1, share_chunks=1)
    sks, master, u0 = ts.seeded_start(cfg)
    lam = sim._lam  # the same key set and quorum: seed 0, t = 1
    windows = [torch.from_numpy(bls_torch.glv_windows(k)) for k in (sks, lam, [master + 1])]
    U_next, ok = ts.build_full_crypto_epoch(1, 4, cfg.threshold, 1, "cpu")(
        torch.from_numpy(u0), *windows)
    assert bool(ok)
    out["node_epoch"] = U_next
    return out


@pytest.fixture(scope="module")
def legs():
    """Every leg on 2 gloo ranks (one start), beside the references."""
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(pmesh.run_ranks, every_leg, WORLD, "cpu")
        refs = _references()
        per_rank = ranks.result()
    return {name: [res[name] for res in per_rank] for name in per_rank[0]}, refs


@contextlib.contextmanager
def world_one(tmp_path):
    with pmesh.process_group(str(tmp_path / "store"), 0, 1, "cpu") as mesh:
        yield mesh
    assert not dist.is_initialized()


def test_round_equals_the_jax_mesh_byte_for_byte(legs):
    got, refs = legs
    received = torch.cat([r[0] for r in got["round"]], dim=1).numpy()
    decoded = torch.cat([r[1] for r in got["round"]], dim=0).numpy()
    assert received.shape == (8, 8, 64) and decoded.shape == (8, 6, 64)
    assert np.array_equal(received, refs["jax_round"][0])
    assert np.array_equal(decoded, refs["jax_round"][1])
    assert np.array_equal(decoded, ROUND)
    rs = JaxReedSolomon(6, 2)
    for i in range(8):
        assert np.array_equal(received[i], rs.encode(ROUND[i]))


def test_instances_encode_equals_the_jax_mesh_byte_for_byte(legs):
    got, refs = legs
    out = torch.cat(got["encode"], dim=0).numpy()
    assert out.shape == (16, 6, 32) and got["encode"][0].shape == (8, 6, 32)
    assert np.array_equal(out, refs["jax_encode"])
    rs = JaxReedSolomon(4, 2)
    for b in range(16):
        assert np.array_equal(out[b], rs.encode(ENCODE[b]))


@pytest.mark.parametrize("case", list(BAD))
def test_round_rejects_bad_geometry_on_every_rank(legs, case):
    got, _ = legs
    assert all(msg is not None for msg in got[case]), got[case]
    with pytest.raises(ValueError):  # JAX rejects the same geometry
        jmesh.broadcast_round_sharded(*BAD[case], jmesh.make_mesh(8))


def test_64_node_round_against_the_host_rs(legs):
    got, _ = legs
    received = torch.cat([r[0] for r in got["round64"]], dim=1).numpy()
    decoded = torch.cat([r[1] for r in got["round64"]], dim=0).numpy()
    assert np.array_equal(decoded, ROUND64)
    rs = ReedSolomon(22, 42)
    for i in (0, 31, 32, 63):
        assert np.array_equal(received[i], rs.encode(ROUND64[i]))


def test_instance_sharded_epoch_equals_the_unsharded_sim(legs):
    got, refs = legs
    assert all(ok for ok, _ in got["instance_epoch"])
    assert [u.shape[-1] for _, u in got["instance_epoch"]] == [4, 4]
    U_next = torch.cat([u for _, u in got["instance_epoch"]], dim=-1)
    sim = refs["instance_sim"]
    assert torch.equal(U_next, sim._U)
    sim._U = U_next  # the ranks' lanes through the host oracle
    assert sim.oracle_check([0, 3, 4, 7])


def test_node_sharded_epoch_equals_the_unsharded_generic_epoch(legs):
    got, refs = legs
    assert all(ok for ok, _ in got["node_epoch"])
    U_next = torch.cat([u for _, u in got["node_epoch"]], dim=-1)
    assert U_next.shape == (3, 12, 4)
    assert torch.equal(U_next, refs["node_epoch"])


def test_pairing_checks_sharded_on_the_jax_inputs(legs):
    got, _ = legs
    assert got["pairing"] == [True, True]
    rng = random.Random(0xB1)
    want = []
    for _ in range(WORLD):
        x, y = rng.getrandbits(64), rng.getrandbits(64)
        want.append((jbls.g1_to_bytes(jbls.mul_sub(jbls.G1, x)),
                     jbls.g2_to_bytes(jbls.mul_sub(jbls.G2, y)),
                     jbls.g1_to_bytes(jbls.mul_sub(jbls.G1, x * y % jbls.R)),
                     jbls.g2_to_bytes(jbls.G2)))
    a, b, c, d = pmesh.pairing_inputs(WORLD)
    assert [(bls.g1_to_bytes(p), bls.g2_to_bytes(q), bls.g1_to_bytes(r), bls.g2_to_bytes(s))
            for p, q, r, s in zip(a, b, c, d)] == want
    assert [len(x) for x in pmesh.pairing_inputs(WORLD, 1, 2)] == [1] * 4


@pytest.mark.parametrize("case", list(VERDICTS))
def test_verdict_reduces_over_every_rank(legs, case):
    got, _ = legs
    want = case == "all good"
    assert got[case] == [want, want]


def test_ranks_import_neither_jax_nor_the_jax_package(legs):
    got, _ = legs
    assert [(r["rank"], r["world"], r["device"]) for r in got["report"]] == [
        (0, 2, "cpu"), (1, 2, "cpu")]
    for r in got["report"]:
        assert "torch" in r["packages"] and "hydrabadger_tpu_torch" in r["packages"]
        assert not {"jax", "jaxlib", "hydrabadger_tpu"} & set(r["packages"])


def test_make_mesh_rejects_a_wrong_world_and_a_missing_card(tmp_path):
    with pytest.raises(RuntimeError, match="process group"):
        pmesh.make_mesh(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            pmesh.make_mesh()
        with pytest.raises(RuntimeError, match="cuda"):
            pmesh.run_ranks(every_leg, 1)
    with world_one(tmp_path) as mesh:
        assert mesh.size() == 1 and mesh.mesh_dim_names == ("nodes",)
        for n in (2, 8):
            with pytest.raises(ValueError, match="one rank per device"):
                pmesh.make_mesh(n_devices=n, device="cpu")


def test_world_one_in_process_equals_the_jax_mesh(tmp_path):
    """World size 1 in the caller's process, as chip_smoke runs the mesh on
    the card: the whole round and encode on one rank."""
    jm = jmesh.make_mesh(8)
    with world_one(tmp_path) as mesh:
        received, decoded = pmesh.broadcast_round_sharded(torch.from_numpy(ROUND), 6, 2, mesh)
        encoded = pmesh.instances_sharded_encode(ENCODE, 4, 2, mesh)
        assert pmesh.all_ok(mesh, [True]) and not pmesh.all_ok(mesh, [False, True])
    j_received, j_decoded = jmesh.broadcast_round_sharded(ROUND, 6, 2, jm)
    assert np.array_equal(received.numpy(), np.asarray(j_received))
    assert np.array_equal(decoded.numpy(), np.asarray(j_decoded))
    assert np.array_equal(encoded.numpy(),
                          np.asarray(jmesh.instances_sharded_encode(ENCODE, 4, 2, jm)))


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(RuntimeError, match=r"rank \d of 2 failed:[\s\S]*ValueError"):
        pmesh.run_ranks(pmesh.full_crypto_epoch_node_sharded, WORLD, "cpu", 3)
