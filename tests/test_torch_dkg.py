"""The port's SyncKeyGen against the JAX package's.

A 4-node key generation (t = 1) on both packages with the same rngs: the
`Part` and `Ack` codec bytes, every `PartOutcome` / `AckOutcome`, and
`generate()`'s `PublicKeySet` bytes and secret shares are equal.  The
port gives the same with its device plane forced on (`device="cpu"`: the
plain versions of kernel B2 run the batched MSMs, the commitment folds
and the channel keys) and off.  A device route that fails raises instead
of falling back to the host.
"""
import random

import pytest
import torch

from hydrabadger_tpu.crypto import dkg as jdkg
from hydrabadger_tpu.crypto import threshold as jth
from hydrabadger_tpu_torch.crypto import dkg, futures
from hydrabadger_tpu_torch.crypto import threshold as th
from hydrabadger_tpu_torch.ops import fq_torch, msm_torch
from hydrabadger_tpu_torch.utils import codec


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


def _outcome(oc):
    ack = None if getattr(oc, "ack", None) is None else (oc.ack.proposer_idx, oc.ack.enc_values)
    return (oc.valid, oc.fault, getattr(oc, "recorded", None), ack)


def key_gen(th_mod, dkg_mod, n=4, t=1, seed=7):
    """One whole key generation; returns everything both packages emit."""
    rng = random.Random(seed)
    ids = [f"node{i}" for i in range(n)]
    sks = {i: th_mod.SecretKey.random(rng) for i in ids}
    pks = {i: sks[i].public_key() for i in ids}
    kgs = {i: dkg_mod.SyncKeyGen(i, sks[i], pks, t, random.Random(seed + 1 + k), session=b"era0")
           for k, i in enumerate(ids)}
    parts = {i: kgs[i].propose() for i in ids}
    rec = {"parts": [(i, p.commit_bytes, p.enc_rows) for i, p in parts.items()],
           "part_outcomes": [], "ack_outcomes": []}
    acks = []
    for receiver in ids:
        # a poll's worth of parts at once: one batched row-check MSM
        outs = kgs[receiver].handle_parts(list(parts.items()))
        rec["part_outcomes"].append([_outcome(o) for o in outs])
        acks += [(receiver, o.ack) for o in outs if o.ack is not None]
    for receiver in ids:
        for acker, ack in acks:
            rec["ack_outcomes"].append(_outcome(kgs[receiver].handle_ack(acker, ack)))
    rec["acks"] = [codec.encode(("ack", a.proposer_idx, tuple(a.enc_values))) for _r, a in acks]
    gens = [kgs[i].generate() for i in ids]
    rec["pk_set"] = [g[0].to_bytes() for g in gens]
    rec["shares"] = [g[1].scalar for g in gens]
    rec["ready"] = [kgs[i].is_ready() for i in ids]
    return rec


@pytest.fixture(scope="module")
def jax_run():
    return key_gen(jth, jdkg)


def test_key_gen_equals_the_jax_key_gen(jax_run, monkeypatch):
    monkeypatch.setenv(dkg.GPU_DKG_ENV, "0")
    dkg.clear_caches()
    ours = key_gen(th, dkg)
    assert ours == jax_run
    assert all(ours["ready"]) and len(set(ours["pk_set"])) == 1
    assert all(oc[0] for row in ours["part_outcomes"] for oc in row)


def test_key_gen_with_the_device_plane_forced_on_the_cpu(jax_run, monkeypatch):
    monkeypatch.setenv(dkg.GPU_DKG_ENV, "1")
    monkeypatch.delenv("HYDRABADGER_COALESCE", raising=False)
    dkg.clear_caches()
    lanes = msm_torch.M.default_registry().counter(msm_torch.M.MSM_REAL_LANES)
    before_lanes, before_kinds = lanes.value, dict(fq_torch.launches_by_kind)
    with dkg.plane_device("cpu"):
        ours = key_gen(th, dkg)
    assert ours == jax_run
    # the MSMs went through ops/msm_torch; on the CPU no kernel launches
    assert lanes.value > before_lanes
    assert fq_torch.launches_by_kind == before_kinds


def test_a_failing_device_route_raises(monkeypatch):
    """The gate forced on a card this process does not have: the first
    device route (the channel keys of propose) raises, nothing falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv(dkg.GPU_DKG_ENV, "1")
    dkg.clear_caches()
    rng = random.Random(3)
    sks = [th.SecretKey.random(rng) for _ in range(4)]
    pks = {i: sks[i].public_key() for i in range(4)}
    kg = dkg.SyncKeyGen(0, sks[0], pks, 1, random.Random(4))
    with dkg.plane_device("cuda"), pytest.raises(RuntimeError, match="cuda"):
        kg.propose()
    # the batched MSM and the folds raise too
    pts = [p.point for p in pks.values()]
    with dkg.plane_device("cuda"):
        with pytest.raises(RuntimeError, match="cuda"):
            dkg.g1_msm_batch([(pts[:2], [3, 5]), (pts[2:], [7, 9])])
        commit = dkg.BivarPoly.random(1, random.Random(5)).commitment()
        with pytest.raises(RuntimeError, match="cuda"):
            commit.warm_folds([1, 2])
        with pytest.raises(RuntimeError, match="cuda"):
            dkg.g1_msm_batch_submit([(pts[:2], [3, 5]), (pts[2:], [7, 9])])
    # a launch that fails inside the per-tick coalescer's flush raises in
    # every submission queued for it
    monkeypatch.setenv("HYDRABADGER_COALESCE", "1")

    def broken(jobs, device="cuda", use_kernel=True):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(msm_torch, "g1_msm_batch_submit", broken)
    with dkg.plane_device("cpu"):
        futs = [dkg.g1_msm_batch_submit([(pts[:2], [3, 5]), (pts[2:], [7, 9])]) for _ in range(2)]
    for fut in futs:
        with pytest.raises(RuntimeError, match="launch failed"):
            fut.result()
    futures.check_dropped()


def test_the_gate_never_starts_the_card(monkeypatch):
    """Unset, the gate is "auto" only where a CUDA context already exists;
    =0 turns it off and =1 forces it."""
    monkeypatch.delenv(dkg.GPU_DKG_ENV, raising=False)
    assert dkg._accel_mode() == ""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert dkg._accel_mode() == "auto"
    assert not dkg._gpu_msm_enabled(255) and dkg._gpu_msm_enabled(256)
    assert dkg._gpu_dkg_mode(15) == "" and dkg._gpu_dkg_mode(16) == "auto"
    monkeypatch.setenv(dkg.GPU_DKG_ENV, "0")
    assert dkg._accel_mode() == ""
    monkeypatch.setenv(dkg.GPU_DKG_ENV, "1")
    assert dkg._accel_mode() == "forced" and dkg._gpu_msm_enabled(1)


def test_coalesced_length_mismatch_is_attributed(monkeypatch):
    """A submission whose points and scalars differ in length gets the
    structural ValueError at its own result(); the others still run."""
    monkeypatch.setenv(dkg.GPU_DKG_ENV, "1")
    monkeypatch.setenv("HYDRABADGER_COALESCE", "1")
    g = th.SecretKey(5).public_key().point
    with dkg.plane_device("cpu"):
        good = dkg.g1_msm_batch_submit([([g], [2]), ([g, g], [1, 1])])
        bad = dkg.g1_msm_batch_submit([([g], [1, 2]), ([g], [3])])
    with pytest.raises(ValueError, match="mismatch"):
        bad.result()
    want = [dkg.g1_msm_or_fallback([g], [2]), dkg.g1_msm_or_fallback([g, g], [1, 1])]
    assert all(dkg.eq(a, b) for a, b in zip(good.result(), want))


def test_futures_settle_in_order_and_the_overlap_accounting():
    """settle_in_order applies effects at ascending submission index
    whichever future materializes first; the overlap accounting counts
    submitted futures and resets; without a card the ratio reads n/a."""
    futures.reset_accounting()
    order = []
    futs = [futures.submit(lambda i=i: order.append(("ran", i)) or i * 10, f"f{i}") for i in range(3)]
    futs[2].result()  # the device finished the last one first
    applied = []
    futures.settle_in_order(futs, lambda i, v: applied.append((i, v)))
    assert applied == [(0, 0), (1, 10), (2, 20)]
    assert order == [("ran", 2), ("ran", 0), ("ran", 1)]
    snap = futures.overlap_snapshot()
    assert snap["device_backend"] == "none" and snap["device_overlap_ratio"] == "n/a (no device)"
    assert snap["futures_dropped"] == 0 and snap["device_overlap_s"] >= 0
    futures.reset_accounting()
    assert futures.overlap_snapshot()["device_overlap_s"] == 0.0
