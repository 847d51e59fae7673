"""Synchronous distributed key generation (Pedersen-style, trustless).

The port's copy of hydrabadger_tpu/crypto/dkg.py: hbbft's `sync_key_gen`
surface, `SyncKeyGen` with `Part` / `Ack` messages and `PartOutcome` /
`AckOutcome` results, ending in `generate() -> (PublicKeySet,
SecretKeyShare)`.  The same message bytes, channel seals, random draws
and outcomes as the JAX module's.

Protocol (symmetric bivariate polynomial secret sharing):
  - Every proposer s samples a random *symmetric* bivariate polynomial
    f_s(x, y) of degree t in each variable and publishes a commitment
    matrix C_s[j][k] = g1 * c_jk, plus, for each node m, the row
    f_s(m+1, y) sealed to m over their pairwise channel.
  - Node m verifies its row against C_s and replies with an Ack carrying
    f_s(m+1, j+1) sealed to each node j.
  - Node i verifies each acked value against C_s, and once t+1 values for
    proposal s arrive, can interpolate the column poly f_s(·, i+1) at 0.
  - generate(): over all complete proposals,
        sk_share_i = Σ_s f_s(0, i+1),
        pk_set commitment = Σ_s C_s row at x=0.
    The master secret Σ_s f_s(0, 0) is never materialised anywhere.

Node indices are dense 0..n-1 over the sorted node-id list; polynomial
evaluation points are index+1 (0 is the master).

The device plane.  Three parts of an era switch run on kernel B2 when the
plane is on: the batched RLC MSMs of the row and ack-value checks
(ops/msm_torch, through crypto/futures' per-tick coalescer where the sim
scopes it on), the commitment folds of every node's column
(ops/vandermonde_torch, `BivarCommitment.warm_folds`) and the pairwise
channel keys (ops/bls_torch's GLV ladder, `warm_channel_keys`).  The gate
is the port's own (`_accel_mode`): "forced" by HYDRABADGER_GPU_DKG=1
(the sim's `tpu_dkg` scopes it per epoch), off by =0, and "auto" only
where this process already holds a CUDA context, so a key-gen message
never initialises the card; "auto" also wants the JAX module's sizes (256
multiplies per MSM batch, t >= 16 for the folds).  The plane's device is
`plane_device`'s scope (the sim's engine device; "cpu" runs the plain
versions) or "cuda".  The device plane takes precedence where it is on.
The host routes are the JAX module's: the native library's Pippenger MSM,
short-Horner folds and GLV multiplies (crypto/native_bls), or, where
HYDRABADGER_NO_NATIVE_BLS=1 selects the pure path, the plain sums and
Horner folds; every route gives the same points.  A failure on the device
or in the native library raises; the structural ValueError (points and
scalars of different lengths) is raised on every route.
"""
from __future__ import annotations

import hashlib
import hmac as hmac_mod
import os
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, Generic, Hashable, List, Mapping, Optional, Tuple, TypeVar

import torch

from ..device import resolve_device
from ..utils import codec
from ..utils.lru import DigestLRU
from . import native_bls
from .bls12_381 import FQ, G1, R, add, eq, g1_from_bytes, g1_to_bytes, infinity, mul_sub
from .threshold import (
    PublicKey,
    PublicKeySet,
    SecretKey,
    SecretKeyShare,
    fr_random,
    poly_eval,
    poly_interpolate_at_zero,
)

N = TypeVar("N", bound=Hashable)

GPU_DKG_ENV = "HYDRABADGER_GPU_DKG"

# the channel-key batches the device plane ran, by lane count (chip_smoke
# replays them)
channel_key_calls: Counter = Counter()


def _small_fold(point_matrix, base: int, axis: int, raw96=None):
    """The native Horner fold by powers of a small base, where the library
    is selected; None otherwise.  A native failure raises."""
    if native_bls.available() and 0 < base < (1 << 16):
        return native_bls.g1_fold_pow(point_matrix, base, axis, raw96=raw96)
    return None


def g1_poly_eval(points, x: int):
    """Evaluate a G1-point polynomial (coefficients low-to-high) at x:
    Σ_j points[j] * x^j, the accumulation of commitment folding and ack
    verification (mirrored by threshold.PublicKeySet.public_key_share).
    Small x (node indices) takes the native short-Horner fold."""
    fast = _small_fold([list(points)], x, 1)
    if fast is not None:
        return fast[0]
    acc = infinity(FQ)
    xj = 1
    for pt in points:
        acc = add(acc, mul_sub(pt, xj))
        xj = xj * x % R
    return acc


# ---------------------------------------------------------------------------
# Pairwise authenticated channels (DKG transport)
#
# Rows and ack values are point-to-point secrets.  One static-DH key per
# ordered pair is derived once (pk_b * sk_a == the same point both ways),
# and values are sealed with an XOR keystream + HMAC tag bound to (kind,
# proposer, sender, recipient), so a value costs two SHA-256 calls.  Static
# keys, no forward secrecy, as threshold.PublicKey.encrypt.
# ---------------------------------------------------------------------------


def _rlc_scalars(seed: bytes, n: int) -> List[int]:
    """Deterministic random 64-bit odd scalars for RLC checks.

    SOUNDNESS CONTRACT: `seed` must bind EVERY byte of the data being
    verified (Fiat-Shamir) — commitments AND the claimed values — or an
    adversary who can predict the scalars solves one linear equation
    and forges a passing combination.  Callers hash the full transcript
    of what they are about to check."""
    out = []
    for i in range(n):
        h = hashlib.sha256(seed + i.to_bytes(4, "big")).digest()
        out.append(int.from_bytes(h[:8], "big") | 1)
    return out


def rlc_scalars(seed: bytes, n: int) -> List[int]:
    """Public alias (shared with consensus-layer batch verifications)."""
    return _rlc_scalars(seed, n)


def g1_msm_or_fallback(points, scalars):
    """The host MSM Σ scalars[i] * points[i]: the native Pippenger MSM
    where the library is selected, else the plain sum; the oracle the device
    plane (ops/msm_torch) is pinned to."""
    if len(points) != len(scalars):
        # loud on every route: the native path sizes its scalar buffer from
        # len(points), the plain path would silently zip-truncate
        raise ValueError("points/scalars length mismatch")
    if native_bls.available():
        return native_bls.g1_msm(points, scalars)
    acc = infinity(FQ)
    for pt, s in zip(points, scalars):
        acc = add(acc, mul_sub(pt, s))
    return acc


# ---------------------------------------------------------------------------
# The device plane's gate and device
# ---------------------------------------------------------------------------

_plane: List = []  # the scoped devices, innermost last


@contextmanager
def plane_device(device):
    """Scope the device plane's device (the sim scopes its engine's device
    around each epoch; "cpu" runs the plain versions)."""
    _plane.append(device)
    try:
        yield
    finally:
        _plane.pop()


def _plane_device() -> torch.device:
    """The plane's device: the innermost scope's, else the card (raises
    where there is none)."""
    return resolve_device(_plane[-1] if _plane else "cuda")


def _accel_mode() -> str:
    """The one gate of the device plane: "" (off), "forced"
    (HYDRABADGER_GPU_DKG=1: the sim and the tests own the trade-off), or
    "auto" (this process already holds a CUDA context).  Never initialises
    the card: a key-gen message must not start a CUDA context as a side
    effect.  Callers layer their own size criterion on "auto"
    (_gpu_dkg_mode: matrix degree; _gpu_msm_enabled: batch multiplies)."""
    env = os.environ.get("HYDRABADGER_GPU_DKG", "")
    if env == "1":
        return "forced"
    if env == "0":
        return ""
    return "auto" if torch.cuda.is_initialized() and torch.cuda.is_available() else ""


def _gpu_msm_enabled(n_muls: int) -> bool:
    """Route a batch of MSM jobs to the device plane (ops/msm_torch)?
    "auto" also wants enough independent multiplies to pay a launch."""
    mode = _accel_mode()
    return mode == "forced" or (mode == "auto" and n_muls >= 256)


def g1_msm_batch_submit(jobs):
    """Submit MANY independent MSMs and return a CryptoFuture of the
    per-job combined points (crypto/futures).

    With the device plane on and more than one job: one batched MSM on the
    device (ops/msm_torch), launched now with the host conversion deferred
    into the future, or queued into the per-tick coalescer where that is
    scoped on (all in-process nodes' jobs then flush as one launch at the
    first settle).  Otherwise an immediate future over the host sum."""
    from ..ops import msm_torch
    from .futures import immediate, msm_coalescer, submit

    jobs = list(jobs)
    if len(jobs) > 1 and _gpu_msm_enabled(sum(len(p) for p, _s in jobs)):
        co = msm_coalescer()
        if co is not None:
            return co.submit(jobs, _plane_device(), label="dkg-msm")
        return submit(msm_torch.g1_msm_batch_submit(jobs, _plane_device()), "dkg-msm")
    return immediate([g1_msm_or_fallback(p, s) for p, s in jobs], "dkg-msm")


def g1_msm_batch(jobs):
    """Synchronous spelling of g1_msm_batch_submit: dispatch + fetch."""
    return g1_msm_batch_submit(jobs).result()


# ---------------------------------------------------------------------------
# Fr multipoint evaluation / interpolation: above a size threshold the
# consecutive node indices route through ops/fr_poly's Newton-basis
# convolution (identical residues).  HYDRABADGER_NTT_MIN_N overrides the
# 384-point floor and HYDRABADGER_NTT=0 pins Horner everywhere.
# ---------------------------------------------------------------------------


def _ntt_route(n_points: int, degree: int) -> bool:
    if os.environ.get("HYDRABADGER_NTT", "1") == "0":
        return False
    env = os.environ.get("HYDRABADGER_NTT_MIN_N", "")
    floor = int(env) if env else 384
    return n_points >= floor and degree >= 8


def fr_eval_points_batch(rows, xs) -> List[List[int]]:
    """Evaluate each coefficient row at every x in xs: one batched plane
    call for the whole poll above the threshold, Horner below it."""
    rows = [list(r) for r in rows]
    xs = [int(x) for x in xs]
    if rows and _ntt_route(len(xs), max(len(r) for r in rows) - 1):
        from ..ops import fr_poly

        return fr_poly.eval_many(rows, xs)
    return [[poly_eval(row, x) for x in xs] for row in rows]


def fr_interpolate_at_zero(points) -> int:
    """f(0) from t+1 (x, y) samples; from 64 points (unless
    HYDRABADGER_NTT=0) the factorial Lagrange weights of ops/fr_poly,
    identical residues."""
    if len(points) >= 64 and os.environ.get("HYDRABADGER_NTT", "1") != "0":
        from ..ops import fr_poly

        return fr_poly.interpolate_at_zero(dict(points))
    return poly_interpolate_at_zero(points)


# ---------------------------------------------------------------------------
# Shadow-DKG scheduling gates.  They live here, not in the consensus core:
# env reads are I/O and the consensus tier is sans-io.
# ---------------------------------------------------------------------------


def shadow_scheduling() -> bool:
    """Is shadow-DKG scheduling on?  ``HYDRABADGER_SHADOW_DKG=0`` runs the
    next era's row crypto inline at the committing batch instead of the
    budgeted per-epoch shadow drain.  The cutover-marker protocol itself
    is unconditional: it is committed protocol state."""
    return os.environ.get("HYDRABADGER_SHADOW_DKG", "1") != "0"


def shadow_budget() -> int:
    """Committed parts whose row settlement runs per committed batch
    (``HYDRABADGER_SHADOW_DKG_BUDGET``, default 16)."""
    try:
        return max(1, int(os.environ.get("HYDRABADGER_SHADOW_DKG_BUDGET", "16")))
    except ValueError:
        return 16


def shadow_stall_after() -> int:
    """Epochs without committed DKG progress before the shadow-DKG
    stall turns loud (``HYDRABADGER_SHADOW_STALL_EPOCHS``, default 8)."""
    try:
        return max(1, int(os.environ.get("HYDRABADGER_SHADOW_STALL_EPOCHS", "8")))
    except ValueError:
        return 8


def _keystream_xor(key: bytes, ctx: bytes, data: bytes) -> bytes:
    """XOR with the SHA-256 counter keystream (one int-wide XOR — the
    byte-wise generator was measurable at era-switch volume)."""
    parts = []
    ctr = 0
    prefix = key + b"|enc|" + ctx
    while 32 * ctr < len(data):
        parts.append(hashlib.sha256(prefix + ctr.to_bytes(4, "big")).digest())
        ctr += 1
    ks = b"".join(parts)[: len(data)]
    return (
        int.from_bytes(data, "big") ^ int.from_bytes(ks, "big")
    ).to_bytes(len(data), "big")


def _seal(key: bytes, ctx: bytes, msg: bytes) -> bytes:
    ct = _keystream_xor(key, ctx, msg)
    # one-shot C hmac path: ~3x the hmac.new object dance at the
    # 2M-call volume of a 128-node era switch
    tag = hmac_mod.digest(key, b"|mac|" + ctx + ct, "sha256")[:16]
    return ct + tag


def _open(key: bytes, ctx: bytes, blob: bytes) -> Optional[bytes]:
    if len(blob) < 16:
        return None
    ct, tag = blob[:-16], blob[-16:]
    want = hmac_mod.digest(key, b"|mac|" + ctx + ct, "sha256")[:16]
    if not hmac_mod.compare_digest(want, tag):
        return None
    return _keystream_xor(key, ctx, ct)


def _seal_batch(items) -> List[bytes]:
    """Seal a batch of (key, ctx, msg) channel values in one pass —
    bit-identical to _seal per item.  A 128-node era switch seals ~2M
    values (n ack values per part, n parts, at every node); two
    hoists carry the win at that volume:

    * per-KEY digest contexts — the keystream prefix hash
      ``sha256(key + b"|enc|")`` and the HMAC key schedule
      ``hmac(key, b"|mac|")`` are both key-only; a poll seals to the
      same n recipients for every part, so each key's setup (two
      compression-function runs for the HMAC pads alone) runs once and
      every later item pays a cheap ``copy()``;
    * the single-block keystream inline (ack values are 32 bytes), as
      before."""
    sha = hashlib.sha256
    enc_pre: Dict[bytes, object] = {}  # key -> sha256(key + b"|enc|")
    mac_pre: Dict[bytes, object] = {}  # key -> hmac(key, b"|mac|")
    out = []
    for key, ctx, msg in items:
        n = len(msg)
        e = enc_pre.get(key)
        if e is None:
            e = enc_pre[key] = sha(key + b"|enc|")
        if n <= 32:
            h = e.copy()
            h.update(ctx + b"\x00\x00\x00\x00")
            ks = h.digest()[:n]
        else:
            parts = []
            for ctr in range((n + 31) // 32):
                h = e.copy()
                h.update(ctx + ctr.to_bytes(4, "big"))
                parts.append(h.digest())
            ks = b"".join(parts)[:n]
        ct = (
            int.from_bytes(msg, "big") ^ int.from_bytes(ks, "big")
        ).to_bytes(n, "big")
        m = mac_pre.get(key)
        if m is None:
            m = mac_pre[key] = hmac_mod.new(key, b"|mac|", "sha256")
        t = m.copy()
        t.update(ctx + ct)
        out.append(ct + t.digest()[:16])
    return out


# Process-wide channel-key cache: the static-DH key of a node pair is
# symmetric (pk_b·sk_a == pk_a·sk_b), so in-process multi-node runtimes
# (the sim) would derive every pairwise key twice.  Keyed by the unordered
# pair of public keys.  `clear_caches` empties it with the decoded
# commitments (and their fold caches).
_CHAN_KEY_CACHE: "DigestLRU[bytes]" = DigestLRU(16384)


def _pair_digest(pk_a: bytes, pk_b: bytes) -> bytes:
    lo, hi = (pk_a, pk_b) if pk_a <= pk_b else (pk_b, pk_a)
    return hashlib.sha256(b"HBTPU-DKG-pair" + lo + hi).digest()


def clear_caches() -> None:
    """Empty the process-wide caches: the channel keys and the decoded
    commitments with their folds.  Two runs from one seed in one process
    make the same commitments and keys, so a second run finds them all
    cached; clearing between runs makes it derive (and launch) them anew."""
    _CHAN_KEY_CACHE.clear()
    _commitment_cached.cache_clear()


# ---------------------------------------------------------------------------
# Bivariate polynomials and commitments
# ---------------------------------------------------------------------------


class BivarPoly:
    """Symmetric bivariate polynomial over Fr, degree t in each variable."""

    def __init__(self, coeffs: List[List[int]]):
        self.t = len(coeffs) - 1
        self.coeffs = coeffs  # coeffs[j][k], symmetric

    @classmethod
    def random(cls, t: int, rng) -> "BivarPoly":
        coeffs = [[0] * (t + 1) for _ in range(t + 1)]
        for j in range(t + 1):
            for k in range(j, t + 1):
                v = fr_random(rng)
                coeffs[j][k] = v
                coeffs[k][j] = v
        return cls(coeffs)

    def evaluate(self, x: int, y: int) -> int:
        acc = 0
        xj = 1
        for j in range(self.t + 1):
            acc = (acc + xj * poly_eval(self.coeffs[j], y)) % R
            xj = xj * x % R
        return acc

    def row(self, x: int) -> List[int]:
        """Univariate poly in y: coefficients of f(x, ·)."""
        xs = [pow(x, j, R) for j in range(self.t + 1)]
        return [
            sum(xs[j] * self.coeffs[j][k] for j in range(self.t + 1)) % R
            for k in range(self.t + 1)
        ]

    def rows_batch(self, xs) -> List[List[int]]:
        """Rows f(x, ·) for EVERY x in xs as one multipoint-plane
        call: the t+1 column polynomials (coefficient index j) each
        evaluate at all xs — O(t n log n) routed vs the per-recipient
        row() loop's O(n t^2); residues identical either way."""
        t1 = self.t + 1
        cols = [
            [self.coeffs[j][k] for j in range(t1)] for k in range(t1)
        ]
        vals = fr_eval_points_batch(cols, xs)
        return [
            [vals[k][i] for k in range(t1)] for i in range(len(vals[0]))
        ]

    def commitment(self) -> "BivarCommitment":
        return BivarCommitment(
            [[mul_sub(G1, c) for c in row] for row in self.coeffs]
        )


def _gpu_dkg_mode(t: int) -> str:
    """Batch the per-node commitment folds on the device?  "forced" (the
    in-process sim shares one decoded commitment across all nodes, so
    warming every column pays) or "auto" with a matrix big enough to pay a
    launch (t >= 16): a real validator consumes only its own column."""
    mode = _accel_mode()
    if mode == "auto" and t < 16:
        return ""
    return mode


class BivarCommitment:
    """g1-commitment matrix to a bivariate polynomial."""

    def __init__(self, points: List[List[tuple]]):
        self.t = len(points) - 1
        self.points = points
        # (kind, index) -> folded commitment row/column, filled by
        # warm_folds: the decoded commitment object is SHARED by every
        # in-process node (_commitment_cached), so one batched device
        # fold serves all n checks
        self._fold_cache: dict = {}

    def warm_folds(self, indices, kinds=("col",)) -> None:
        """Fold the commitment at all `indices` in one batch on the device
        plane (ops/vandermonde_torch on the plane's device) and cache the
        folds, affine-normalised on the host: the same points as the host
        folds below.  Columns by default: they are what generate()'s
        ack-value checks consume all at once."""
        from ..ops import limbs
        from ..ops import vandermonde_torch as vt

        indices = [int(i) for i in indices]
        t1 = self.t + 1
        C = None
        for kind in kinds:
            todo = [i for i in indices if (kind, i) not in self._fold_cache]
            if not todo:
                continue
            if C is None:
                flat = [p for row in self.points for p in row]
                C = torch.from_numpy(limbs.points_to_limbs(flat)).to(_plane_device())
                C = C.reshape(3, limbs.N_LIMBS, t1, t1)  # [3, 12, j, k]
            mat = C if kind == "row" else C.transpose(2, 3).contiguous()
            out = vt.fold_points_batch(mat, todo)  # [3, 12, M, t1]
            pts = limbs.limbs_to_points(out.cpu().numpy())
            for mi, idx in enumerate(todo):
                self._fold_cache[(kind, idx)] = pts[mi * t1:(mi + 1) * t1]

    def evaluate(self, x: int, y: int) -> tuple:
        acc = infinity(FQ)
        xj = 1
        for j in range(self.t + 1):
            yk = 1
            for k in range(self.t + 1):
                acc = add(acc, mul_sub(self.points[j][k], xj * yk % R))
                yk = yk * y % R
            xj = xj * x % R
        return acc

    def row_commitment(self, x: int) -> List[tuple]:
        """Commitment to the univariate row poly f(x, ·); x = 0 is simply
        the first coefficient row."""
        if x == 0:
            return list(self.points[0])
        cached = self._fold_cache.get(("row", x))
        if cached is not None:
            return list(cached)
        fast = _small_fold(self.points, x, 0,
                           raw96=self.raw96() if native_bls.available() else None)
        if fast is not None:
            return fast
        xs = [pow(x, j, R) for j in range(self.t + 1)]
        out = []
        for k in range(self.t + 1):
            acc = infinity(FQ)
            for j in range(self.t + 1):
                acc = add(acc, mul_sub(self.points[j][k], xs[j]))
            out.append(acc)
        return out

    def column_commitment(self, y: int) -> List[tuple]:
        """Commitment to the column poly f(·, y): col[j] = Σ_k P[j][k] y^k.

        Folding the y variable once turns every later evaluate(x, y)
        into t+1 scalar muls instead of (t+1)^2."""
        cached = self._fold_cache.get(("col", y))
        if cached is not None:
            return list(cached)
        fast = _small_fold(self.points, y, 1,
                           raw96=self.raw96() if native_bls.available() else None)
        if fast is not None:
            return fast
        ys = [pow(y, k, R) for k in range(self.t + 1)]
        out = []
        for j in range(self.t + 1):
            acc = infinity(FQ)
            for k in range(self.t + 1):
                acc = add(acc, mul_sub(self.points[j][k], ys[k]))
            out.append(acc)
        return out

    def to_bytes(self) -> bytes:
        return codec.encode(
            [[g1_to_bytes(p) for p in row] for row in self.points]
        )

    def raw96(self) -> bytes:
        """Concatenated 96-byte affine encodings (the native fold's input),
        built once and cached: commitments are immutable."""
        raw = getattr(self, "_raw96", None)
        if raw is None:
            raw = b"".join(native_bls._g1_to_raw(p) for row in self.points for p in row)
            self._raw96 = raw
        return raw

    @classmethod
    def from_bytes(cls, raw: bytes) -> "BivarCommitment":
        rows = codec.decode(raw)
        return cls([[g1_from_bytes(p) for p in row] for row in rows])


@lru_cache(maxsize=256)
def _commitment_cached(raw: bytes) -> "BivarCommitment":
    """Decode-once cache: a committed Part's commitment is decoded by
    every node that processes it ((t+1)^2 point decompressions — the
    top cost of an era switch's intake); commitments are immutable, so all
    SyncKeyGen instances share the decoded object."""
    return BivarCommitment.from_bytes(raw)


# ---------------------------------------------------------------------------
# Messages
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Part:
    """Proposal: commitment + per-node encrypted rows (index-ordered)."""

    commit_bytes: bytes
    enc_rows: Tuple[bytes, ...]

    def commitment(self) -> BivarCommitment:
        return _commitment_cached(bytes(self.commit_bytes))


@dataclass(frozen=True)
class Ack:
    """Acknowledgement of proposer's part: per-node encrypted values."""

    proposer_idx: int
    enc_values: Tuple[bytes, ...]


@dataclass
class PartOutcome:
    valid: bool
    ack: Optional[Ack] = None
    fault: Optional[str] = None
    # the part was recorded despite a node-local (own-row) fault: the
    # proposal set stays objective while the proposer is still faulted
    recorded: bool = False


@dataclass
class AckOutcome:
    valid: bool
    fault: Optional[str] = None


@dataclass
class _ProposalState:
    commitment: BivarCommitment
    row: Optional[List[int]] = None  # our decrypted row f_s(i+1, y)
    values: Dict[int, int] = field(default_factory=dict)  # acker idx+1 -> val
    acks: set = field(default_factory=set)
    # lazily-folded column commitment at y = our_idx+1 (ack verification)
    our_column: Optional[List[tuple]] = None
    # ack values verify lazily in batch (SyncKeyGen._verify_values)
    values_verified: bool = True
    # shadow DKG: recorded structurally, own-row settlement
    # (decrypt + RLC verify + ack generation) still owed to
    # SyncKeyGen.settle_parts_submit
    row_pending: bool = False

    def is_complete(self, threshold: int) -> bool:
        """OBJECTIVE completion: counts structurally-valid acks, which are
        identical on every node processing the same committed transcript
        (node-local decryption results must never influence this, or a
        Byzantine acker could split the era-switch gate across honest
        nodes — different nodes would switch eras at different epochs, a
        permanent fork).  2t+1 acks guarantee >= t+1 honest ackers whose
        values verify for EVERY recipient, so each node can derive its
        share (hbbft sync_key_gen's node_ready threshold)."""
        return len(self.acks) > 2 * threshold


# ---------------------------------------------------------------------------
# SyncKeyGen
# ---------------------------------------------------------------------------


class SyncKeyGen(Generic[N]):
    """One node's view of a synchronous DKG session.

    `pub_keys` maps node id -> BLS PublicKey for row/value transport
    encryption; indices are positions in the sorted id list.
    """

    def __init__(
        self,
        our_id: N,
        our_sk: SecretKey,
        pub_keys: Mapping[N, PublicKey],
        threshold: int,
        rng,
        session: bytes = b"",
    ):
        self.our_id = our_id
        self.our_sk = our_sk
        self.node_ids = sorted(pub_keys.keys())
        self.pub_keys = dict(pub_keys)
        self.threshold = threshold
        self.rng = rng
        # Channel-context nonce: the XOR keystream is deterministic from
        # (static-DH key, ctx), so every DKG INSTANCE between the same
        # long-lived node keys MUST use a distinct session tag or two
        # eras' ciphertexts XOR to the XOR of two secret rows (two-time
        # pad).  Callers pass the era/instance id; all participants in
        # one DKG must agree on it.
        self.session = bytes(session)
        if our_id not in self.pub_keys:
            raise ValueError("our_id must be among pub_keys")
        if len(self.node_ids) <= threshold:
            raise ValueError("need more than `threshold` nodes")
        self._index = {nid: i for i, nid in enumerate(self.node_ids)}
        self.our_idx = self._index[our_id]
        self.parts: Dict[int, _ProposalState] = {}
        self._chan_keys: Dict[int, bytes] = {}
        self._our_pk_bytes = self.pub_keys[our_id].to_bytes()
        # hoisted 2-byte index encodings: the channel-context builders
        # run ~n^2 times per poll and n^3 times per era — re-encoding
        # the same small ints each time was measurable at n=128
        self._idx2 = [
            m.to_bytes(2, "big") for m in range(len(self.node_ids))
        ]

    # -- pairwise channels --------------------------------------------------

    def _chan_key(self, idx: int) -> bytes:
        """Static-DH channel key with node `idx` (symmetric both ways).

        Consults the process-wide pair cache first: in-process
        multi-node runtimes derive each pairwise key once instead of
        once per side."""
        key = self._chan_keys.get(idx)
        if key is None:
            peer_pk = self.pub_keys[self.node_ids[idx]]
            pair = _pair_digest(self._our_pk_bytes, peer_pk.to_bytes())
            key = _CHAN_KEY_CACHE.get(pair)
            if key is None:
                dh = mul_sub(peer_pk.point, self.our_sk.scalar)
                key = hashlib.sha256(
                    b"HBTPU-DKG-CH" + g1_to_bytes(dh)
                ).digest()
                _CHAN_KEY_CACHE.put(pair, key)
            self._chan_keys[idx] = key
        return key

    def warm_channel_keys(self) -> None:
        """Derive every missing pairwise channel key for this DKG
        instance in ONE batched scalar-mul call — the era's outgoing
        ack/row sealing then never pays a lazy host ladder per peer
        mid-poll.  Pair-cache hits (the other side of an in-process
        node already derived the key) are drained first; the true
        misses batch through the device plane (ops/bls_torch's GLV
        ladder on kernel B2) when it is on, else the native host batch (or
        the pure multiplies)."""
        from ..ops import bls_torch

        todo = []
        for m in range(len(self.node_ids)):
            if m in self._chan_keys:
                continue
            peer_pk = self.pub_keys[self.node_ids[m]]
            pair = _pair_digest(self._our_pk_bytes, peer_pk.to_bytes())
            cached = _CHAN_KEY_CACHE.get(pair)
            if cached is not None:
                self._chan_keys[m] = cached
                continue
            todo.append((m, pair, peer_pk.point))
        if not todo:
            return
        pts = [p for _m, _d, p in todo]
        if len(pts) > 1 and _gpu_msm_enabled(4 * len(pts)):
            channel_key_calls[len(pts)] += 1
            dhs = bls_torch.g1_scalar_mul_batch(
                pts, [self.our_sk.scalar] * len(pts), device=_plane_device()
            )
        elif native_bls.available():
            dhs = native_bls.g1_mul_batch(pts, [self.our_sk.scalar] * len(pts))
        else:
            dhs = [mul_sub(p, self.our_sk.scalar) for p in pts]
        for (m, pair, _p), dh in zip(todo, dhs):
            key = hashlib.sha256(b"HBTPU-DKG-CH" + g1_to_bytes(dh)).digest()
            _CHAN_KEY_CACHE.put(pair, key)
            self._chan_keys[m] = key

    def _row_ctx(self, proposer: int, recipient: int) -> bytes:
        return (
            b"R"
            + self.session
            + b"|"
            + proposer.to_bytes(2, "big")
            + recipient.to_bytes(2, "big")
        )

    def _val_ctx_prefix(self, proposer: int, sender: int) -> bytes:
        """The recipient-independent prefix of _val_ctx: hoisted out of
        the per-recipient inner seal loops (one bytes build per part
        instead of n)."""
        return (
            b"V"
            + self.session
            + b"|"
            + proposer.to_bytes(2, "big")
            + sender.to_bytes(2, "big")
        )

    def _val_ctx(self, proposer: int, sender: int, recipient: int) -> bytes:
        return self._val_ctx_prefix(proposer, sender) + recipient.to_bytes(
            2, "big"
        )

    # -- proposing ----------------------------------------------------------

    def propose(self) -> Part:
        poly = BivarPoly.random(self.threshold, self.rng)
        commit = poly.commitment()
        self.warm_channel_keys()  # one batched derivation for the era
        row_prefix = b"R" + self.session + b"|" + self._idx2[self.our_idx]
        # all recipients' rows through the multipoint plane at once
        # (fr_eval_points_batch routes; small n = the same per-row math)
        rows = poly.rows_batch(range(1, len(self.node_ids) + 1))
        enc_rows = _seal_batch(
            [
                (
                    self._chan_key(m),
                    row_prefix + self._idx2[m],
                    codec.encode(rows[m]),
                )
                for m in range(len(self.node_ids))
            ]
        )
        return Part(commit.to_bytes(), tuple(enc_rows))

    # -- handling -----------------------------------------------------------

    def node_index(self, node_id: N) -> int:
        idx = self._index.get(node_id)
        if idx is None:
            raise ValueError(f"unknown node id {node_id!r}")
        return idx

    def handle_part(self, sender_id: N, part: Part) -> PartOutcome:
        """Record one proposal — see handle_parts for the check split."""
        return self.handle_parts([(sender_id, part)])[0]

    def handle_parts(
        self, items: List[Tuple[N, Part]]
    ) -> List[PartOutcome]:
        """Synchronous spelling of handle_parts_submit: submit + settle."""
        return self.handle_parts_submit(items)()

    def handle_parts_submit(self, items: List[Tuple[N, Part]]):
        """Record a POLL'S WORTH of proposals with batched crypto.

        Checks split into two classes with different consequences:
        STRUCTURAL checks (decodable commitment, degree, row count,
        first-commit-wins conflicts) depend only on the committed bytes
        — every honest node rejects identically, so a structurally bad
        part is never recorded anywhere.  OWN-ROW checks (our encrypted
        row decrypts and matches the commitment) are node-local: a
        Byzantine proposer can make them fail for a targeted subset of
        nodes, so their failure must NOT change the recorded proposal
        set — the part is recorded (completion stays objective), the
        proposer is faulted, and we simply do not ack.  A victim still
        derives its share from t+1 honest ackers' values.

        Batching: the structural phase and row decryption run
        sequentially in poll order (duplicate/conflict semantics exactly
        match the one-at-a-time path), but every decrypted row's
        RLC/commitment right-hand side settles as ONE batched MSM call
        on the 16-window short-scalar tier (the LHS stays a host
        base-point ladder — see the inline note), and the outgoing ack
        values for every acked part seal through the batched channel
        plane instead of n host calls per part.

        Async: returns a zero-arg SETTLE closure.
        The MSM is SUBMITTED before the closure is built; everything
        the sync path ran after the MSM that does not depend on its
        verdicts — the LHS base-point ladders, channel-key warming,
        the per-recipient ack-value evaluation and sealing — runs
        between submit and settle, in the device's shadow.  settle()
        fetches the verdicts, drops the (rare, Byzantine-only) failed
        rows' pre-sealed acks, and returns the outcome list —
        bit-identical to the synchronous path in every recorded state
        and emitted ack.  Callers may hold the closure across further
        host work (the dhb double-buffer) but MUST invoke it before
        the outcomes' effects are due.

        Shadow split: the structural phase and the row-crypto
        settlement are independently callable — :meth:`record_parts` /
        :meth:`settle_parts_submit` — so the dhb shadow-DKG scheduler
        can commit the structural state inline (the objective proposal
        set the era-switch gate counts) and spread the settlement
        across the steady-state epoch cadence.  This method composes
        the two: record everything, settle everything."""
        outcomes, deferred = self.record_parts(items)
        if not deferred:
            return lambda: outcomes  # type: ignore[return-value]
        settle_rows = self.settle_parts_submit(
            [(sid, part) for _i, sid, part in deferred]
        )

        def settle() -> List[PartOutcome]:
            for (i, _sid, _part), oc in zip(deferred, settle_rows()):
                outcomes[i] = oc
            return outcomes  # type: ignore[return-value]

        return settle

    def record_parts(self, items: List[Tuple[N, Part]]):
        """STRUCTURAL intake of a batch of proposals — the commit-path
        half of the shadow split.

        Runs only the checks that depend on the committed bytes alone
        (member sender, duplicate/conflict, decodable commitment,
        degree, row count) and records accepted proposals with their
        row crypto still OWED: the proposal set — and with it the
        objective era-switch gate — settles at commit time for a few
        decode-and-compare operations per part, while the expensive
        settlement (row decryption, the RLC/commitment MSM, ack-value
        evaluation + sealing) is deferred to
        :meth:`settle_parts_submit`, schedulable by the caller across
        later epochs.

        Returns ``(outcomes, deferred)``: ``outcomes[i]`` is a terminal
        :class:`PartOutcome` (structural reject, or duplicate — whose
        ack the ORIGINAL entry's settlement owns) or ``None`` for a
        recorded proposal, and ``deferred`` lists ``(i, sender_id,
        part)`` for every ``None`` slot."""
        outcomes: List[Optional[PartOutcome]] = [None] * len(items)
        deferred: List[tuple] = []
        for i, (sender_id, part) in enumerate(items):
            try:
                s = self.node_index(sender_id)
            except ValueError:
                outcomes[i] = PartOutcome(
                    False, fault="part from non-member"
                )
                continue
            if s in self.parts:
                existing = self.parts[s]
                if existing.commitment.to_bytes() != part.commit_bytes:
                    outcomes[i] = PartOutcome(
                        False, fault="conflicting part"
                    )
                else:  # duplicate; ack already sent (or owed by the
                    # original entry's pending settlement)
                    outcomes[i] = PartOutcome(True)
                continue
            try:
                commit = part.commitment()
            except (ValueError, TypeError):
                outcomes[i] = PartOutcome(
                    False, fault="undecodable commitment"
                )
                continue
            if commit.t != self.threshold:
                outcomes[i] = PartOutcome(False, fault="wrong degree")
                continue
            if len(part.enc_rows) != len(self.node_ids):
                outcomes[i] = PartOutcome(False, fault="wrong row count")
                continue
            self.parts[s] = _ProposalState(
                commit, row=None, row_pending=True
            )
            deferred.append((i, sender_id, part))
        return outcomes, deferred

    def settle_parts_submit(self, items: List[Tuple[N, Part]]):
        """Row-crypto settlement for proposals ALREADY recorded by
        :meth:`record_parts`: decrypt our row, verify every pending row
        against its commitment (all RLC right-hand sides as ONE batched
        MSM), and evaluate + seal the outgoing ack values — everything
        the legacy inline path ran after the structural checks.

        ``items`` is ``[(sender_id, part)]`` of plain committed data,
        so a caller may hold entries across epochs — and checkpoints:
        the dhb shadow queue pickles them and resumes the drain.
        Returns a zero-arg settle closure -> ``[PartOutcome]`` aligned
        with ``items``; an entry whose settlement already ran (a
        duplicate queued twice) yields a benign ``PartOutcome(True)``."""
        outcomes: List[Optional[PartOutcome]] = [None] * len(items)
        pending = []  # (slot, proposer idx, state, row, raw, part)
        mode = _gpu_dkg_mode(self.threshold)
        for i, (sender_id, part) in enumerate(items):
            try:
                s = self.node_index(sender_id)
            except ValueError:
                outcomes[i] = PartOutcome(
                    False, fault="part from non-member"
                )
                continue
            state = self.parts.get(s)
            if state is None or not getattr(state, "row_pending", False):
                outcomes[i] = PartOutcome(True)  # settled already
                continue
            state.row_pending = False
            if mode == "forced":
                # one batched device fold of ALL nodes' COLUMN
                # commitments, cached on the shared decoded commitment —
                # the first in-process handler pays, and generate()'s
                # per-proposal ack-verification folds become lookups.
                # Forced mode only: the all-columns warm pays off when the
                # decoded commitment is SHARED by every in-process node
                # (the sim).
                state.commitment.warm_folds(range(1, len(self.node_ids) + 1))
            elif mode == "auto":
                # a real (TCP) validator consumes only ITS OWN column:
                # warming all n is n x wasted synchronous device work on
                # the key-gen message path
                state.commitment.warm_folds([self.our_idx + 1])
            row: Optional[List[int]] = None
            fault = None
            raw = _open(
                self._chan_key(s),
                self._row_ctx(s, self.our_idx),
                bytes(part.enc_rows[self.our_idx]),
            )
            if raw is None:
                fault = "undecryptable row"
            else:
                try:
                    row = [int(c) % R for c in codec.decode(raw)]
                except (ValueError, TypeError):
                    fault = "undecryptable row"
            if row is not None and len(row) != self.threshold + 1:
                row, fault = None, "wrong row degree"
            if row is None:
                outcomes[i] = PartOutcome(False, fault=fault, recorded=True)
                continue
            state.row = row
            pending.append((i, s, state, row, raw, part))
        if not pending:
            return lambda: outcomes  # type: ignore[return-value]
        # one RLC check per row instead of t+1 point equalities: with
        # random 64-bit r_k, sum r_k row[k] * G == sum r_k expected[k]
        # — a forged row passes with probability 2^-64.  All pending
        # rows' right-hand sides verify as ONE batched MSM.  The LHS
        # stays a HOST base-point mul on purpose: folding (-lhs)·G1
        # into the job would smuggle one ~255-bit scalar into an
        # otherwise 64-bit batch and push the whole MSM onto the
        # 33-window GLV tier (2x the window work of the 16-window tier
        # the RLC scalars qualify for); one host G1 ladder per part
        # is noise next to the t+1-point MSM it gates.
        jobs = []
        rs_list = []
        for _i, _s, state, row, raw, part in pending:
            expected = state.commitment.row_commitment(self.our_idx + 1)
            # Fiat-Shamir: the seed hashes the FULL commitment and FULL
            # row — a proposer fixing any prefix and solving for a later
            # coefficient faces fresh scalars
            seed = hashlib.sha256(
                b"HBTPU-DKG-row"
                + hashlib.sha256(part.commit_bytes).digest()
                + hashlib.sha256(bytes(raw)).digest()
            ).digest()
            rs = _rlc_scalars(seed, len(row))
            jobs.append((list(expected), rs))
            rs_list.append(rs)
        fut = g1_msm_batch_submit(jobs)
        # ---- host work in the device's shadow ----------------------------
        # Everything below ran AFTER the MSM on the sync path and depends
        # only on data known at submit time: the LHS ladders, channel-key
        # warming, and the optimistic per-recipient ack evaluation+seal
        # (discarded for the Byzantine-only rows the verdicts reject).
        lhs_points = [
            mul_sub(G1, sum(r * c for r, c in zip(rs, row)) % R)
            for rs, (_i, _s, _st, row, _raw, _p) in zip(rs_list, pending)
        ]
        self.warm_channel_keys()  # batch any keys still underived
        n_nodes = len(self.node_ids)
        keys = [self._chan_key(m) for m in range(n_nodes)]
        idx2 = self._idx2
        # every pending row evaluates at ALL n node indices through the
        # multipoint plane (ONE batched call for the poll — a
        # per-recipient Horner loop was n^2 t per poll); values include
        # our own consistent f_s(our_idx+1, our_idx+1) at m = our_idx
        all_vals = fr_eval_points_batch(
            [row for _i, _s, _st, row, _raw, _p in pending],
            range(1, n_nodes + 1),
        )
        pre_acks = []
        for (_i, s, _state, _row, _raw, _part), vals in zip(
            pending, all_vals
        ):
            prefix = self._val_ctx_prefix(s, self.our_idx)
            pre_acks.append(
                _seal_batch(
                    [
                        (
                            keys[m],
                            prefix + idx2[m],
                            vals[m].to_bytes(32, "big"),
                        )
                        for m in range(n_nodes)
                    ]
                )
            )

        def settle() -> List[PartOutcome]:
            results = fut.result()
            for (i, s, state, _row, _raw, _part), res, lhs_pt, enc in zip(
                pending, results, lhs_points, pre_acks
            ):
                if eq(res, lhs_pt):
                    outcomes[i] = PartOutcome(True, ack=Ack(s, tuple(enc)))
                else:
                    state.row = None
                    outcomes[i] = PartOutcome(
                        False, fault="row/commitment mismatch", recorded=True
                    )
            return outcomes  # type: ignore[return-value]

        return settle

    def handle_ack(self, sender_id: N, ack: Ack) -> AckOutcome:
        """Count an ack.  STRUCTURAL checks (known part, value count,
        duplicates) are objective and gate the count; OWN-SLOT checks
        (our encrypted value decrypts and matches the commitment) are
        node-local and must not — the ack still counts toward the
        era-switch gate (see _ProposalState.is_complete), the sender is
        faulted, and the bad value is simply not stored.

        Round 3: the value/commitment check is DEFERRED and batched —
        values are stored unverified and _verify_values() settles a
        whole proposal's worth with one RLC equation over the folded
        column when the values are consumed (generate()).  A mismatch
        surfaces there as the value being dropped (the honest fast path
        never re-evaluates per ack)."""
        m = self.node_index(sender_id)
        if ack.proposer_idx not in self.parts:
            return AckOutcome(False, fault="ack for unknown part")
        state = self.parts[ack.proposer_idx]
        if m in state.acks:
            return AckOutcome(True)  # duplicate
        if len(ack.enc_values) != len(self.node_ids):
            return AckOutcome(False, fault="wrong value count")
        state.acks.add(m)
        raw = _open(
            self._chan_key(m),
            self._val_ctx(ack.proposer_idx, m, self.our_idx),
            bytes(ack.enc_values[self.our_idx]),
        )
        if raw is None or len(raw) != 32:
            return AckOutcome(False, fault="undecryptable value")
        # first store wins (the acks-set dedup above already blocks a
        # second ack from the same sender; this guards the invariant
        # even if a future refactor reorders the checks)
        state.values.setdefault(m + 1, int.from_bytes(raw, "big") % R)
        state.values_verified = False
        return AckOutcome(True)

    def _verify_values(self, state: "_ProposalState") -> None:
        """Single-proposal wrapper over _verify_values_batch."""
        self._verify_values_batch([state])

    def _verify_values_batch(self, states) -> None:
        """Synchronous spelling of _verify_values_batch_submit."""
        self._verify_values_batch_submit(states)()

    def _verify_values_batch_submit(self, states):
        """Settle MANY proposals' stored ack values: per proposal one
        RLC check — with random 64-bit r_m,
          (sum_m r_m v_m) * G == sum_j col[j] * (sum_m r_m (m+1)^j)
        over the y = our_idx+1 folded column — verifies every value at
        once (forgery passes with probability 2^-64), and ALL
        proposals' right-hand sides evaluate as ONE batched MSM call
        (each job folds its LHS as an extra (-lhs)·G1 term, so success
        is the identity) instead of n sequential host Pippengers — the
        per-proposal half of the 128-node era-switch wall.  Unlike the
        row checks, folding the LHS here is free: the column weights
        w_j are full-width mod R anyway, so the batch is on the GLV
        tier with or without the fold.  On a job failure, the
        per-value slow path drops exactly the bad entries.

        Returns a zero-arg settle closure (hbasync): the MSM is
        submitted before returning, so the caller — generate()'s
        commitment accumulation is the designed consumer — can run host
        work in the device's shadow and settle when the verified values
        are actually consumed."""
        pending = []  # (state, items, job points, job scalars)
        for state in states:
            if getattr(state, "values_verified", True) or not state.values:
                if not state.values:
                    state.values_verified = True
                continue
            if state.our_column is None:
                state.our_column = state.commitment.column_commitment(
                    self.our_idx + 1
                )
            items = sorted(state.values.items())  # (m+1, val)
            # Fiat-Shamir: bind commitment AND every (index, value) pair
            # — scalars predictable from indices alone would let
            # colluding ackers send cancelling deviations that pass the
            # batch check
            h = hashlib.sha256()
            h.update(b"HBTPU-DKG-ackval")
            h.update(hashlib.sha256(state.commitment.to_bytes()).digest())
            for mp, v in items:
                h.update(mp.to_bytes(4, "big"))
                h.update(int(v).to_bytes(32, "big"))
            rs = _rlc_scalars(h.digest(), len(items))
            lhs = sum(r * v for r, (_mp, v) in zip(rs, items)) % R
            t1 = len(state.our_column)
            # incremental powers (one modmul per step) instead of a
            # bigint pow() per (item, j) — ~30M pow calls per 128-node
            # era switch otherwise
            ws = [0] * t1
            for r, (mp, _v) in zip(rs, items):
                mpj = 1
                for j in range(t1):
                    ws[j] += r * mpj
                    mpj = mpj * mp % R
            pending.append(
                (
                    state,
                    items,
                    list(state.our_column) + [G1],
                    [w % R for w in ws] + [(R - lhs) % R],
                )
            )
        if not pending:
            return lambda: None
        fut = g1_msm_batch_submit(
            [(pts, ks) for _st, _it, pts, ks in pending]
        )

        def settle() -> None:
            results = fut.result()
            for (state, items, _pts, _ks), res in zip(pending, results):
                if eq(res, infinity(FQ)):
                    state.values_verified = True
                    continue
                # slow path: drop exactly the mismatching values
                for mp, val in items:
                    expected = g1_poly_eval(state.our_column, mp)
                    if not eq(mul_sub(G1, val), expected):
                        state.values.pop(mp, None)
                state.values_verified = True

        return settle

    # -- completion ---------------------------------------------------------

    def count_complete(self) -> int:
        return sum(
            1 for s in self.parts.values() if s.is_complete(self.threshold)
        )

    def is_ready(self) -> bool:
        """Every node's proposal is complete (the strict bootstrap gate:
        n parts and n acks each)."""
        return self.count_complete() == len(self.node_ids)

    def generate(self) -> Tuple[PublicKeySet, SecretKeyShare]:
        """Combine all complete proposals into (pk_set, our sk share)."""
        if self.count_complete() == 0:
            raise ValueError("no complete proposals")
        t = self.threshold
        commit_acc = [infinity(FQ) for _ in range(t + 1)]
        sk_val = 0
        complete = [
            state
            for _s, state in sorted(self.parts.items())
            if state.is_complete(t)
        ]
        # settle ALL proposals' lazily-stored ack values with one
        # batched MSM call instead of one host MSM each —
        # SUBMITTED first (hbasync), so the public-key-set accumulation
        # below (t+1 point adds per proposal, pure host work that needs
        # no verdicts) runs in the device's shadow
        settle_values = self._verify_values_batch_submit(complete)
        for state in complete:
            row0 = state.commitment.row_commitment(0)
            commit_acc = [add(a, b) for a, b in zip(commit_acc, row0)]
        settle_values()
        for state in complete:
            # interpolate our share slice from VERIFIED ack values only;
            # 2t+1 structural acks guarantee >= t+1 of them carried
            # values that verify for us (honest ackers)
            if len(state.values) <= t:
                raise ValueError(
                    "complete proposal with insufficient verified values "
                    "(more than t Byzantine ackers?)"
                )
            pts = dict(list(state.values.items())[: t + 1])
            sk_val = (sk_val + fr_interpolate_at_zero(pts)) % R
        return PublicKeySet(commit_acc), SecretKeyShare(sk_val)
