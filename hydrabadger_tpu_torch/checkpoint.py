"""Checkpoint / resume: the port's copy of hydrabadger_tpu/checkpoint.py.

The reference keeps all state in memory and regenerates keys on every
boot (src/hydrabadger/hydrabadger.rs:131); its only
resume affordances are `Config.start_epoch` threading into DHB's era
(hydrabadger.rs:58,69, state.rs:298) and the `JoinPlan` that lets a
fresh node adopt the network's current epoch (handler.rs:256-264).
This module provides:

  * **Node checkpoints** — a versioned, integrity-checked snapshot of a
    node's durable consensus identity: uid, identity key, era/epoch
    cursor, validator set, master `PublicKeySet`, and this node's
    `SecretKeyShare`.  Restoring rebuilds a validator
    `DynamicHoneyBadger` at the saved era with the in-era epoch
    fast-forwarded — the same trick `from_join_plan` uses
    (`hb.epoch = plan.epoch - plan.era`) but with key material, so the
    node comes back as a *validator*, not an observer.  Serialized with
    the deterministic wire codec rather than pickle so *loading* an
    untrusted or corrupted file can never execute code — but the payload
    contains the node's identity secret key and threshold key share IN
    PLAINTEXT: a checkpoint is as secret as the keys themselves and must
    never leave the operator's trust domain.  The bytes are the JAX
    package's: the same state gives the same file in both packages, and
    either loads the other's.

  * **Simulator checkpoints** — full-state snapshots of a `SimNetwork`
    (every core's protocol state, router queue, RNGs), so a long run can
    stop and resume bit-identically.  Pickle-based: sim checkpoints stay
    inside one trust domain, and the cores are plain Python objects.
    Adversary callables (closures) are stripped on save and re-attached
    on load.  A checkpoint is host state: pickling refuses any
    `torch.Tensor` it reaches, naming where it sits (device work in
    flight is settled before a snapshot, never carried in one), and
    loading refuses any class of the JAX package (`hydrabadger_tpu`), so
    a JAX sim file never resumes as a JAX `SimNetwork` inside the port.

Both formats share a container: MAGIC | kind | auth flag | digest |
payload, so truncated or corrupted files fail loudly instead of
resuming a consensus node from garbage.
"""
from __future__ import annotations

import hashlib
import hmac as hmac_mod
import io
import logging
import os
import pickle
from collections import deque
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch

from .consensus.dynamic_honey_badger import DynamicHoneyBadger
from .consensus.types import NetworkInfo
from .crypto.threshold import PublicKey, PublicKeySet, SecretKey, SecretKeyShare
from .obs.metrics import (
    CHECKPOINT_CORRUPT_REJECTED,
    CHECKPOINT_GENERATION_FALLBACKS,
    CHECKPOINTS_PERSISTED,
)
from .utils import codec

_MAGIC = b"HBTPUCKP"
_NODE_VERSION = 1
_SIM_VERSION = 1

log = logging.getLogger("hydrabadger_tpu_torch.checkpoint")


class CheckpointError(ValueError):
    pass


def _mac_key() -> Optional[bytes]:
    """Optional authentication key from HYDRABADGER_CKPT_KEY.

    The container's SHA-256 is integrity only; sim checkpoints restore
    via pickle, so loading a file from outside the operator's trust
    domain is arbitrary code execution.  When this env var is set, the
    digest slot holds HMAC-SHA256(key, payload) instead, so checkpoints
    that cross a machine boundary can be *authenticated*: a file written
    without the key (or with a different one) refuses to load.
    """
    val = os.environ.get("HYDRABADGER_CKPT_KEY")
    return val.encode() if val else None


def _digest(payload: bytes, key: Optional[bytes]) -> bytes:
    if key:
        return hmac_mod.new(key, payload, hashlib.sha256).digest()
    return hashlib.sha256(payload).digest()


def _pack(kind: int, payload: bytes, key: Optional[bytes] = None) -> bytes:
    if key is None:
        key = _mac_key()
    # container: MAGIC | kind | auth-flag | digest | payload — the flag
    # records whether the digest slot is plain SHA-256 (0) or
    # HMAC-SHA256 (1), so a key mismatch reports itself instead of
    # masquerading as file corruption.
    return _MAGIC + bytes([kind, 1 if key else 0]) + _digest(payload, key) + payload


def _unpack(raw: bytes, kind: int, key: Optional[bytes] = None) -> bytes:
    if key is None:
        key = _mac_key()
    m = len(_MAGIC)
    if len(raw) < m + 2 + 32 or raw[:m] != _MAGIC:
        raise CheckpointError("not a hydrabadger_tpu checkpoint")
    if raw[m] != kind:
        raise CheckpointError(
            f"checkpoint kind mismatch: got {raw[m]}, want {kind}"
        )
    authed = raw[m + 1]
    if authed not in (0, 1):
        raise CheckpointError("unknown checkpoint auth flag")
    digest = raw[m + 2 : m + 34]
    payload = raw[m + 34 :]
    if authed and not key:
        raise CheckpointError(
            "checkpoint is authenticated; set HYDRABADGER_CKPT_KEY to load it"
        )
    if key and not authed:
        raise CheckpointError(
            "HYDRABADGER_CKPT_KEY is set but this checkpoint is "
            "unauthenticated (plain sha256); unset the key to accept it"
        )
    if not hmac_mod.compare_digest(_digest(payload, key if authed else None), digest):
        raise CheckpointError(
            "checkpoint integrity check failed"
            + (" (authenticated checkpoint: wrong key?)" if authed else "")
        )
    return payload


# ---------------------------------------------------------------------------
# Node checkpoints (deterministic codec; no pickle)
# ---------------------------------------------------------------------------

_KIND_NODE = 1
_KIND_SIM = 2


@dataclass(frozen=True)
class NodeCheckpoint:
    """Durable consensus identity of one node at an epoch boundary."""

    uid: object  # node id, verbatim (bytes in the net runtime)
    secret_key: bytes  # node identity key (BLS scalar)
    era: int
    epoch: int  # absolute epoch cursor (next epoch to decide)
    node_ids: Sequence  # current validator set, sorted (ids verbatim)
    pub_keys: Dict  # node id -> identity PublicKey bytes
    pk_set: bytes  # era's master PublicKeySet
    sk_share: bytes  # this node's SecretKeyShare ('' for observers)
    session_id: bytes = b"dhb"  # coin/session binding; must match peers

    def to_bytes(self) -> bytes:
        # The checkpoint IS the durable key store: a checkpoint is as
        # secret as the keys themselves and must never leave the
        # operator's trust domain (optionally HMAC'd via
        # HYDRABADGER_CKPT_KEY).
        # hblint: disable=secret-taint -- checkpoint is the intended durable key store; file-level protection is the operator's contract (module docstring)
        payload = codec.encode(
            (
                _NODE_VERSION,
                self.uid,
                self.secret_key,
                self.era,
                self.epoch,
                tuple(self.node_ids),
                tuple(sorted(self.pub_keys.items())),
                self.pk_set,
                self.sk_share,
                self.session_id,
            )
        )
        return _pack(_KIND_NODE, payload)

    @classmethod
    def from_bytes(cls, raw: bytes) -> "NodeCheckpoint":
        fields = codec.decode(_unpack(raw, _KIND_NODE))
        version = fields[0]
        if version != _NODE_VERSION:
            raise CheckpointError(f"unsupported node checkpoint v{version}")
        (_v, uid, sk, era, epoch, node_ids, pub_items, pk_set, share,
         session_id) = fields
        return cls(
            uid=uid,
            secret_key=bytes(sk),
            era=int(era),
            epoch=int(epoch),
            node_ids=tuple(node_ids),
            pub_keys={k: bytes(v) for k, v in pub_items},
            pk_set=bytes(pk_set),
            sk_share=bytes(share),
            session_id=bytes(session_id),
        )

    # -- capture / restore ---------------------------------------------------

    @classmethod
    def capture(cls, secret_key: SecretKey,
                dhb: DynamicHoneyBadger) -> "NodeCheckpoint":
        """Snapshot a running DynamicHoneyBadger's durable state.  A
        wrapped core (one with `unwrap()`) is unwrapped first: the
        checkpoint holds the honest consensus identity."""
        if hasattr(dhb, "unwrap"):
            dhb = dhb.unwrap()
        ni = dhb.netinfo
        share = ni.sk_share.to_bytes() if ni.sk_share is not None else b""
        return cls(
            uid=dhb.our_id,
            secret_key=secret_key.to_bytes(),
            era=dhb.era,
            epoch=dhb.epoch,
            node_ids=tuple(ni.node_ids),
            pub_keys={
                n: pk.to_bytes() for n, pk in dhb.pub_keys.items()
            },
            pk_set=ni.pk_set.to_bytes(),
            sk_share=share,
            session_id=dhb.session_id,
        )

    def restore_dhb(
        self,
        encrypt: bool = True,
        coin_mode: str = "threshold",
        verify_shares: bool = True,
        rng=None,
        engine=None,
        recorder=None,
        rbc_variant=None,
    ) -> DynamicHoneyBadger:
        """Rebuild the consensus core at the saved era/epoch.

        Validator iff the checkpoint carries a key share; in-era epochs
        already decided are skipped exactly as `from_join_plan` does."""
        share = (
            SecretKeyShare.from_bytes(self.sk_share) if self.sk_share else None
        )
        netinfo = NetworkInfo(
            self.uid,
            list(self.node_ids),
            PublicKeySet.from_bytes(self.pk_set),
            share,
        )
        dhb = DynamicHoneyBadger(
            self.uid,
            SecretKey.from_bytes(self.secret_key),
            netinfo,
            {n: PublicKey.from_bytes(pk) for n, pk in self.pub_keys.items()},
            era=self.era,
            epoch=self.epoch,
            session_id=self.session_id,
            encrypt=encrypt,
            coin_mode=coin_mode,
            verify_shares=verify_shares,
            rng=rng,
            engine=engine,
            recorder=recorder,
            rbc_variant=rbc_variant,
        )
        dhb.hb.epoch = self.epoch - self.era
        return dhb


def _atomic_write(path: str, blob: bytes) -> None:
    """Write via temp file + fsync + rename so an interrupted save never
    destroys the previous good checkpoint.  The directory entry is
    fsync'd too: after a SIGKILL or a power cut the rename itself must be
    durable, not just the file contents."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dirname = os.path.dirname(os.path.abspath(path))
    try:
        dfd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return  # exotic filesystem: contents are still fsync'd
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def save_node(path: str, ckpt: NodeCheckpoint) -> None:
    _atomic_write(path, ckpt.to_bytes())


def load_node(path: str) -> NodeCheckpoint:
    with open(path, "rb") as f:
        return NodeCheckpoint.from_bytes(f.read())


# ---------------------------------------------------------------------------
# Durable generational store
# ---------------------------------------------------------------------------

# generations retained on disk: the live file plus its predecessor.  Two
# is the floor that makes corruption survivable — a crash mid-rotation
# (or a bad sector under the newest file) falls back to the previous
# generation instead of re-running the DKG from scratch.
CKPT_GENERATIONS = 2


class CheckpointStore:
    """Era/epoch-stamped on-disk node checkpoints with rotation and a
    LOUD corrupt-file fallback.

    ``save`` rotates the current file to ``<path>.1`` and atomically
    writes the new generation (write-tmp + fsync + rename + dir fsync),
    so a process killed at ANY instant — including mid-save — leaves at
    least one loadable generation on disk.  ``load`` walks newest to
    oldest: a truncated or bit-flipped file is rejected by the container
    digest, reported through the ``fault`` hook and the
    ``checkpoint_corrupt_rejected`` / ``checkpoint_generation_fallbacks``
    counters, and the previous generation is tried.  Only when EVERY
    generation is unreadable does ``load`` return None (boot fresh)."""

    def __init__(self, path: str, keep: int = CKPT_GENERATIONS,
                 metrics=None, fault=None):
        self.path = path
        self.keep = max(1, int(keep))
        self.metrics = metrics  # obs MetricsRegistry (optional)
        self.fault = fault  # callable(kind: str) -> None (optional)

    def generation_paths(self) -> list:
        """Newest-first paths of every retained generation."""
        return [self.path] + [
            f"{self.path}.{i}" for i in range(1, self.keep)
        ]

    def _count(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.counter(name).inc()

    def save(self, ckpt: NodeCheckpoint) -> None:
        blob = ckpt.to_bytes()
        paths = self.generation_paths()
        # rotate oldest-first so generation k becomes k+1; the newest
        # slot is then replaced atomically — a kill between the rotate
        # and the write leaves .1 as the (intact) latest generation,
        # exactly what load() falls back to
        for i in range(self.keep - 1, 0, -1):
            if os.path.exists(paths[i - 1]):
                os.replace(paths[i - 1], paths[i])
        _atomic_write(self.path, blob)
        self._count(CHECKPOINTS_PERSISTED)

    def load(self) -> Optional[NodeCheckpoint]:
        for gen, path in enumerate(self.generation_paths()):
            try:
                ckpt = load_node(path)
            except FileNotFoundError:
                continue
            except (CheckpointError, OSError, ValueError) as e:
                # loud rejection: ring + counter, never a silent resume
                # from garbage — and never a silent *skip* either
                self._count(CHECKPOINT_CORRUPT_REJECTED)
                if self.fault is not None:
                    self.fault("checkpoint: corrupt generation rejected")
                log.error("checkpoint generation %d (%s) rejected: %s", gen, path, e)
                continue
            if gen > 0:
                self._count(CHECKPOINT_GENERATION_FALLBACKS)
            return ckpt
        return None


# ---------------------------------------------------------------------------
# Simulator checkpoints (full state; single trust domain)
# ---------------------------------------------------------------------------


class _DeviceState(Exception):
    """A tensor reached while pickling a sim (caught in sim_to_bytes)."""


def _is_device_state(obj) -> bool:
    return isinstance(obj, (torch.Tensor, torch.UntypedStorage, torch.TypedStorage))


class _HostPickler(pickle.Pickler):
    """Pickles host state only: a tensor or storage is refused."""

    def persistent_id(self, obj):
        if _is_device_state(obj):
            raise _DeviceState()
        return None


def _children(obj):
    """(label, child) pairs of the containers and instances a pickle
    walks: mapping items, sequence items, and instance attributes."""
    if isinstance(obj, dict):
        return [(f"[{k!r}]", v) for k, v in obj.items()]
    if isinstance(obj, (list, tuple, deque)):
        return [(f"[{i}]", v) for i, v in enumerate(obj)]
    if isinstance(obj, (set, frozenset)):
        return [("{..}", v) for v in obj]
    out = []
    state = getattr(obj, "__dict__", None)
    if isinstance(state, dict):
        out += [(f".{k}", v) for k, v in state.items()]
    for cls in type(obj).__mro__:
        for name in getattr(cls, "__slots__", ()):
            if hasattr(obj, name):
                out.append((f".{name}", getattr(obj, name)))
    return out


def _device_state_path(root, name: str = "sim") -> str:
    """Where a tensor sits under `root`, as an attribute path (breadth
    first, so the shortest path is named)."""
    seen = {id(root)}
    frontier = deque([(name, root)])
    while frontier:
        path, obj = frontier.popleft()
        if _is_device_state(obj):
            return path
        if isinstance(obj, (str, bytes, bytearray, int, float, complex, type)):
            continue
        for label, child in _children(obj):
            if id(child) not in seen:
                seen.add(id(child))
                frontier.append((path + label, child))
    return f"{name} (a tensor reached through a custom __reduce__)"


def sim_to_bytes(sim) -> bytes:
    """Serialize a SimNetwork with adversary callables stripped.  Raises
    CheckpointError, naming the attribute, where the sim holds a tensor."""
    if getattr(sim.cfg, "scenario", None) is not None:
        # A scenario run keeps cfg.adversary None and holds the compiled
        # adversary on the router, so the had_adversary flag below would
        # record False and a resume would silently strip it.
        raise CheckpointError(
            "cannot checkpoint a sim running a ScenarioSpec; scenario "
            "runs compile node wrappers at construction time and cannot "
            "be resumed coherently"
        )
    cfg_adv, router_adv = sim.cfg.adversary, sim.router.adversary
    sim.cfg.adversary = sim.router.adversary = None
    try:
        buf = io.BytesIO()
        try:
            _HostPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(
                (_SIM_VERSION, cfg_adv is not None, sim)
            )
        except _DeviceState:
            raise CheckpointError(
                f"a sim checkpoint holds host state only, but "
                f"{_device_state_path(sim)} is a tensor: settle the device "
                "work in flight before the snapshot"
            ) from None
        return _pack(_KIND_SIM, buf.getvalue())
    finally:
        sim.cfg.adversary, sim.router.adversary = cfg_adv, router_adv


class _PortUnpickler(pickle.Unpickler):
    """Refuses every class of the JAX package: a JAX sim file would
    otherwise import it and resume as its SimNetwork."""

    def find_class(self, module, name):
        if module == "hydrabadger_tpu" or module.startswith("hydrabadger_tpu."):
            raise CheckpointError(
                f"this sim checkpoint was written by the JAX package ({module}.{name}); "
                "the port resumes only its own sim checkpoints"
            )
        return super().find_class(module, name)


def sim_from_bytes(raw: bytes, adversary=None):
    """Restore a SimNetwork; re-attach `adversary` if one was stripped.

    Note: an adversary's internal RNG restarts from its own seed, so a
    resumed adversarial run is deterministic but not identical to the
    uninterrupted one; adversary-free runs resume bit-identically."""
    payload = _unpack(raw, _KIND_SIM)
    version, had_adversary, sim = _PortUnpickler(io.BytesIO(payload)).load()
    if version != _SIM_VERSION:
        raise CheckpointError(f"unsupported sim checkpoint v{version}")
    if had_adversary and adversary is None:
        raise CheckpointError(
            "checkpointed sim ran with an adversary; pass adversary= to "
            "resume (callables are not serialized)"
        )
    sim.cfg.adversary = sim.router.adversary = adversary
    return sim


def save_sim(path: str, sim) -> None:
    _atomic_write(path, sim_to_bytes(sim))


def load_sim(path: str, adversary=None):
    with open(path, "rb") as f:
        return sim_from_bytes(f.read(), adversary=adversary)
