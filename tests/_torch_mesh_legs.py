"""What tests/test_torch_mesh.py runs on each gloo rank.

A spawned rank imports this module by name to find `every_leg`, so it
imports numpy and the port only: never JAX, never a test module.
"""
import sys

import numpy as np

from hydrabadger_tpu_torch.parallel import mesh as pmesh


def rand(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


ROUND = rand((8, 6, 64), 42)  # (k, p) = (6, 2), tests/test_mesh.py's round
ENCODE = rand((16, 4, 32), 7)  # (4, 2), B = 16
ROUND64 = np.random.default_rng(7).integers(0, 256, (64, 22, 32)).astype(np.uint8)
BAD = {"N=7 on 2 ranks": (rand((7, 5, 8), 0), 5, 2), "N != k+p": (rand((8, 5, 8), 0), 5, 2)}
VERDICTS = {"all good": ([True], [True, True]), "rank 1 bad": ([True], [True, False])}


def _rejection(mesh, proposals, k: int, p: int):
    """The round's ValueError text, or None.  The geometry checks come
    before any collective and agree on every rank, so the ranks stay in
    step after one."""
    try:
        pmesh.broadcast_round_sharded(proposals, k, p, mesh)
    except ValueError as exc:
        return str(exc)
    return None


def every_leg(mesh) -> dict:
    """Every leg of the test module on this rank, in one start of the ranks."""
    r = mesh.get_local_rank()
    out = {
        "report": {"rank": r, "world": mesh.size(), "device": mesh.device_type,
                   "packages": sorted({name.split(".")[0] for name in sys.modules})},
        "round": pmesh.broadcast_round_sharded(ROUND, 6, 2, mesh),
        "encode": pmesh.instances_sharded_encode(ENCODE, 4, 2, mesh),
        "round64": pmesh.broadcast_round_sharded(ROUND64, 22, 42, mesh),
        "instance_epoch": pmesh._instance_epoch(mesh, n_nodes=4, instances=2),
        "node_epoch": pmesh._node_epoch(mesh, n_nodes=4),
        "pairing": pmesh.pairing_checks_sharded(mesh, checks_per_device=1),
    }
    out.update({case: _rejection(mesh, *args) for case, args in BAD.items()})
    out.update({case: pmesh.all_ok(mesh, oks[r]) for case, oks in VERDICTS.items()})
    return out
