"""Multi-device scale-out: the simulator's tensor planes on a device mesh.

Counterpart of hydrabadger_tpu/parallel/mesh.py.  JAX runs one program
over a `jax.sharding.Mesh` with `shard_map`; here every device is a rank
of a torch.distributed process group (NCCL on cards, rank r on cuda:r;
gloo on the CPU), and each rank runs the same function on its own shard.
When a simulation spans devices, message passing stops being sockets and
becomes collectives.  The mapping for Reliable Broadcast dissemination is
JAX's:

  - the *nodes* axis of the simulated network shards across ranks;
  - RS-encoding every local proposer's payload is one launch of kernel B1;
  - "send shard j of proposal i to node j" — the reference's N^2 Value
    messages — is one `all_to_all_single` over the node axis;
  - every rank gathers the first k shard columns (`all_gather`) and
    decodes every proposal: one more B1 launch.

Instances (independent consensus universes) are a second, purely
data-parallel axis: the instance-sharded encode and full-crypto epoch need
no collective but the verdict's.

Every function takes the global inputs, as every JAX caller passes the
global array, keeps the rank's shard, and returns the rank's shard of
JAX's outputs on the rank's device, or the verdict reduced over the mesh
(`all_ok`: one all_reduce of an int32 count of bad lanes).  Kernels launch
through the port's wrappers: B1 (`gf256_torch`), B2 (`fq_torch`) and B3
(`circuit_torch`), or their plain versions on CPU tensors.

`run_ranks` starts one process per rank (spawn start method), each with
its group initialised from a FileStore in a temporary directory, so no TCP
port is chosen; `process_group` joins the caller's own process as one rank.
JAX's `_shard_map` (API glue) has no counterpart.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import random
import tempfile
from datetime import timedelta
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..crypto import bls12_381 as bls
from ..crypto import threshold as th
from ..device import resolve_device
from ..ops import bls_torch, gf256_torch, pairing_torch, rs_torch
from ..sim.tensor import (
    FullCryptoConfig,
    FullCryptoTensorSim,
    build_full_crypto_epoch,
    seeded_start,
)

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}
_GROUP_TIMEOUT = timedelta(seconds=300)


def make_mesh(n_devices: Optional[int] = None, axis: str = "nodes", device="cuda"):
    """A one-dimensional DeviceMesh named `axis` over the process group the
    caller initialised: NCCL for "cuda" (rank r works on cuda:r), gloo for
    "cpu".  `n_devices` None takes the world size; any other value must
    equal it (one rank per device).  Raises without a card for "cuda",
    without a group, and where the world outgrows the cards."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group, or run_ranks)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a mesh of {n} devices over a world of {world} ranks: "
                         "one rank per device")
    backend = str(dist.get_backend())
    if _BACKEND[dev.type] not in backend:
        raise ValueError(f"a {dev.type} mesh runs on {_BACKEND[dev.type]}, "
                         f"the group on {backend}")
    if dev.type == "cuda":
        if world > torch.cuda.device_count():
            raise ValueError(f"{world} ranks, {torch.cuda.device_count()} cards: "
                             "NCCL takes one rank per card")
        torch.cuda.set_device(dist.get_rank())
    return init_device_mesh(dev.type, (n,), mesh_dim_names=(axis,))


def _rank_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _dim(mesh, axis: str) -> int:
    if axis not in mesh.mesh_dim_names:
        raise ValueError(f"no axis {axis!r} in the mesh {mesh.mesh_dim_names}")
    return mesh.mesh_dim_names.index(axis)


def _shard(mesh, total: int, what: str, axis: str) -> tuple[int, int]:
    """[lo, hi): this rank's share of `total` items along `axis`."""
    dim = _dim(mesh, axis)
    n = mesh.size(dim)
    if total % n:
        raise ValueError(f"{what} ({total}) must divide the mesh ({n} devices)")
    per = total // n
    r = mesh.get_local_rank(dim)
    return r * per, (r + 1) * per


def _local(x, lo: int, hi: int, dev: torch.device) -> torch.Tensor:
    """Rows [lo, hi) of a global uint8 array or tensor, on `dev`."""
    part = x[lo:hi]
    if not isinstance(part, torch.Tensor):
        part = torch.from_numpy(np.ascontiguousarray(part, dtype=np.uint8))
    if part.dtype != torch.uint8:
        raise TypeError(f"expected uint8 data, got {part.dtype}")
    return part.to(dev)


def all_ok(mesh, ok) -> bool:
    """The global verdict: True iff no rank has a bad lane.  `ok` is the
    rank's bool verdict (per lane, or one); the int32 count of its False
    lanes is summed over the mesh in one all_reduce, as JAX's psum."""
    ok = torch.as_tensor(ok, dtype=torch.bool)
    bad = (~ok).sum(dtype=torch.int32).reshape(1).to(_rank_device(mesh))
    dist.all_reduce(bad, op=dist.ReduceOp.SUM, group=mesh.get_group())
    return int(bad.item()) == 0


def broadcast_round_sharded(proposals, data_shards: int, parity_shards: int, mesh,
                            axis: str = "nodes"):
    """One tensorized RBC dissemination round over the mesh.

    proposals: [N, k, L] uint8 (array or tensor, the same on every rank) —
    node i's payload, pre-split into k data rows.  N must equal
    data_shards + parity_shards (one shard per node) and be divisible by
    the mesh size.  Rank r owns nodes [r N/n, (r+1) N/n).

    Returns the rank's shards of JAX's (received, decoded):
      received: [N, N/n, L] — every proposer's shards at the rank's shard
        columns, the post-"network" state (JAX's [N, N, L] columns
        [r N/n, (r+1) N/n));
      decoded: [N/n, k, L] — the rank's proposals rebuilt from the first
        k shard columns gathered over the mesh (every rank decodes all N,
        verifying totality, and keeps its own).
    Collectives: all_to_all_single (dissemination), all_gather (quorum)."""
    k, p = data_shards, parity_shards
    N, kk, L = proposals.shape
    if N != k + p:
        raise ValueError("one shard per node: N must equal k + parity")
    if kk != k:
        raise ValueError(f"expected [N, {k}, L] proposals, got {tuple(proposals.shape)}")
    lo, hi = _shard(mesh, N, "node count", axis)
    n_dev, nl = mesh.size(_dim(mesh, axis)), hi - lo
    group = mesh.get_group(_dim(mesh, axis))
    dev = _rank_device(mesh)
    local = _local(proposals, lo, hi, dev)  # [N/n, k, L]
    full = torch.empty((nl, N, L), dtype=torch.uint8, device=dev)
    full[:, :k] = local
    gf256_torch.gf_matmul(rs_torch._parity_operand(k, p, dev), local, out=full[:, k:])
    # dissemination: JAX splits the shard axis over devices and gathers the
    # proposer axis; all_to_all_single splits and joins dim 0, so send
    # [shard, proposer, L] and put the proposer axis back in front
    send = full.transpose(0, 1).contiguous()  # [N, N/n, L]: chunk j -> rank j
    recv = torch.empty_like(send)  # [n (source), N/n (my shards), N/n (its proposers), L]
    dist.all_to_all_single(recv, send, group=group)
    received = recv.reshape(n_dev, nl, nl, L).transpose(1, 2).reshape(N, nl, L).contiguous()
    # decode quorum: the first k shard columns of every proposal (any k
    # suffice; k columns = k "echoing nodes")
    parts = [torch.empty_like(received) for _ in range(n_dev)]
    dist.all_gather(parts, received, group=group)
    all_shards = torch.cat(parts, dim=1)  # [N, N, L]
    decoded = gf256_torch.gf_matmul(rs_torch._decode_operand(k, p, tuple(range(k)), dev),
                                    all_shards[:, :k])
    return received, decoded[lo:hi]


def instances_sharded_encode(data, data_shards: int, parity_shards: int, mesh,
                             axis: str = "nodes") -> torch.Tensor:
    """[B, k, L] batch encode with the instance axis sharded over the mesh
    (no collectives): the rank's [B/n, k+p, L] codewords, one B1 launch."""
    lo, hi = _shard(mesh, data.shape[0], "instance count", axis)
    return rs_torch.rs_encode_batch(_local(data, lo, hi, _rank_device(mesh)),
                                    data_shards, parity_shards)


def _instance_epoch(mesh, n_nodes: int = 4, instances: Optional[int] = None):
    """`full_crypto_epoch_sharded`'s epoch -> (global verdict, the rank's
    U_next [3, 12, B/n * N] int32, lane (b - r B/n) * N + i)."""
    B = instances if instances is not None else 2 * mesh.size()
    lo, hi = _shard(mesh, B, "instances", mesh.mesh_dim_names[0])
    cfg = FullCryptoConfig(n_nodes=n_nodes, instances=B, share_chunks=1)
    sim = FullCryptoTensorSim.instance_slice(cfg, lo, hi, device=_rank_device(mesh))
    return all_ok(mesh, sim.run(1)), sim._U


def full_crypto_epoch_sharded(mesh, n_nodes: int = 4, instances: Optional[int] = None) -> bool:
    """One FULL-CRYPTO epoch (share ladders, Lagrange combines and the
    combine == U*master check, sim/tensor.FullCryptoTensorSim) with the
    INSTANCE axis sharded across the mesh; returns the global verdict.

    Rank r runs instances [r B/n, (r+1) B/n) of the sim `FullCryptoConfig(
    n_nodes, B, share_chunks=1)` seeds (B = 2 n by default), from that
    sim's own initial U, on the engine `FullCryptoTensorSim` selects for
    its B/n * N lanes (the decrypt engine on B2 and B3 unless
    HYDRABADGER_DECRYPT_T=0)."""
    return _instance_epoch(mesh, n_nodes, instances)[0]


def _node_epoch(mesh, n_nodes: int = 64):
    """`full_crypto_epoch_node_sharded`'s epoch -> (global verdict, the
    rank's U_next [3, 12, N/n] int32: ciphertexts [r N/n, (r+1) N/n))."""
    lo, hi = _shard(mesh, n_nodes, "node count", mesh.mesh_dim_names[0])
    cfg = FullCryptoConfig(n_nodes=n_nodes, instances=1, share_chunks=1)
    t = cfg.threshold
    sks, master, u0 = seeded_start(cfg)
    dev = _rank_device(mesh)
    # the quorum's windows are replicated (the quorum is global); U's
    # columns are sharded, never the windows
    lam = th.lagrange_coeffs_at_zero(list(range(1, t + 2)))
    windows = [torch.from_numpy(bls_torch.glv_windows(k)).to(dev)
               for k in (sks, lam, [(master + 1) % bls.R])]
    body = build_full_crypto_epoch(1, hi - lo, t, 1, dev)
    U = torch.from_numpy(np.ascontiguousarray(u0[:, :, lo:hi])).to(dev)
    U_next, ok = body(U, *windows)
    return all_ok(mesh, ok), U_next


def full_crypto_epoch_node_sharded(mesh, n_nodes: int = 64) -> bool:
    """One FULL-CRYPTO epoch with the NODE axis sharded across the mesh.

    The 64-node benchmark geometry (threshold 21, quorum 22) at ONE
    instance: each rank owns n_nodes/n ciphertext columns and runs their
    share ladders and Lagrange combines locally on the generic epoch
    (`build_full_crypto_epoch(1, n_nodes/n, t, 1)`: B2's `glv_ladder`,
    `add`, `mul`); the key, Lagrange and master+1 windows are replicated,
    so nothing crosses ranks until the verdict's all_reduce."""
    return _node_epoch(mesh, n_nodes)[0]


def pairing_inputs(n_checks: int, lo: int = 0, hi: Optional[int] = None):
    """Checks [lo, hi) of JAX's `pairing_checks_sharded` inputs:
    `random.Random(0xB1)` draws x, y (64 bits) per check in order, and
    e(x G1, y G2) == e(xy G1, G2).  -> (a, b, c, d) point lists."""
    hi = n_checks if hi is None else hi
    rng = random.Random(0xB1)
    draws = [(rng.getrandbits(64), rng.getrandbits(64)) for _ in range(n_checks)][lo:hi]
    a = [bls.mul_sub(bls.G1, x) for x, _ in draws]
    b = [bls.mul_sub(bls.G2, y) for _, y in draws]
    c = [bls.mul_sub(bls.G1, x * y % bls.R) for x, y in draws]
    return a, b, c, [bls.G2] * len(draws)


def pairing_checks_sharded(mesh, checks_per_device: int = 1) -> bool:
    """Batched pairing verifications with the LANE axis sharded across the
    mesh: every rank runs its checks_per_device checks of JAX's inputs
    (`pairing_inputs`) through `pairing_torch.pairing_eq_kernel` (B3), and
    the verdict reduces over the mesh."""
    n_checks = mesh.size() * checks_per_device
    lo, hi = _shard(mesh, n_checks, "checks", mesh.mesh_dim_names[0])
    args = pairing_torch.operands(*pairing_inputs(n_checks, lo, hi), _rank_device(mesh))
    return all_ok(mesh, pairing_torch.pairing_eq_kernel(*args))


# ---------------------------------------------------------------------------
# The rank launcher
# ---------------------------------------------------------------------------


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    if isinstance(x, dict):
        return {key: _to_host(v) for key, v in x.items()}
    return x


@contextlib.contextmanager
def process_group(store_path: str, rank: int, world_size: int, device="cuda"):
    """Join this process to a group of `world_size` as `rank` (NCCL for
    "cuda", on cuda:rank from `make_mesh`; gloo for "cpu"), its rendezvous a FileStore at
    `store_path`, and yield the mesh over it; the group is destroyed on
    leaving, whatever happened, so nothing later in the process finds it."""
    dev = resolve_device(device)
    dist.init_process_group(_BACKEND[dev.type], store=dist.FileStore(store_path, world_size),
                            rank=rank, world_size=world_size, timeout=_GROUP_TIMEOUT)
    try:
        yield make_mesh(world_size, device=dev.type)
    finally:
        dist.destroy_process_group()


def _rank_main(rank: int, world_size: int, device: str, tmp: str, fn: Callable,
               args: tuple) -> None:
    """A rank's process: fn(mesh, *args) in its group, its result (tensors
    moved to the host) pickled to the temporary directory for the parent."""
    torch.set_num_threads(1)
    with process_group(os.path.join(tmp, "store"), rank, world_size, device) as mesh:
        value = _to_host(fn(mesh, *args))
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(value, f)


def run_ranks(fn: Callable, world_size: int, device="cuda", *args) -> list:
    """Run fn(mesh, *args) on `world_size` ranks, one spawned process each
    (gloo for "cpu", NCCL for "cuda" with rank r on cuda:r), and return
    their results in rank order.  `fn` must be a module-level function that
    a child can import by name without the caller's module.  Each rank
    takes one CPU thread and initialises the group from a FileStore in a
    temporary directory.  A rank that raises or dies fails the call
    (RuntimeError, with its traceback) and ends its peers; a rank stuck in
    a collective raises after the group's timeout."""
    dev = resolve_device(device)
    if world_size < 1:
        raise ValueError("world_size must be at least 1")
    if dev.type == "cuda" and world_size > torch.cuda.device_count():
        raise ValueError(f"{world_size} ranks, {torch.cuda.device_count()} cards: "
                         "NCCL takes one rank per card")
    with tempfile.TemporaryDirectory(prefix="hb_mesh_") as tmp:
        try:
            torch.multiprocessing.start_processes(
                _rank_main, (world_size, dev.type, tmp, fn, args), nprocs=world_size,
                daemon=True, start_method="spawn")
        except (torch.multiprocessing.ProcessRaisedException,
                torch.multiprocessing.ProcessExitedException) as exc:
            raise RuntimeError(f"rank {exc.error_index} of {world_size} failed:\n{exc}") from None
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
