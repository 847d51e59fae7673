"""The port's engines, futures and coin round on the CPU: GpuEngine(device="cpu")
(the plain versions of kernels B1 and B4) against the JAX package's
CpuEngine — RS byte for byte, sign shares and combined signatures as
points — the futures' fetch-once and loud-drop contract, the registry,
and the no-card failure."""
import gc
import random

import numpy as np
import pytest
import torch

from hydrabadger_tpu.crypto import bls12_381 as jbls
from hydrabadger_tpu.crypto import engine as jengine
from hydrabadger_tpu.crypto import threshold as jth
from hydrabadger_tpu_torch.crypto import bls12_381 as bls
from hydrabadger_tpu_torch.crypto import engine, futures
from hydrabadger_tpu_torch.crypto import threshold as th
from hydrabadger_tpu_torch.ops import limbs
from hydrabadger_tpu_torch.sim import coin


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run thousands of tiny ops: one thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _affine(pt):
    return [c.coeffs for c in bls.normalize(pt)]


def _jaffine(pt):
    return [c.coeffs for c in jbls.normalize(pt)]


def test_gpu_engine_signs_and_combines_as_the_jax_cpu_engine():
    """t = 1, n = 4 (as tests/test_bls_g2_jax.py): the batched shares and
    the combine equal the JAX package's CpuEngine, and the combined
    signature is the master key times H(m)."""
    t, n, msg = 1, 4, b"round-3"
    sk_set = th.SecretKeySet.random(t, random.Random(1))
    jsk_set = jth.SecretKeySet.random(t, random.Random(1))
    gpu, jcpu = engine.GpuEngine(device="cpu"), jengine.CpuEngine()
    limbs_out, pending = gpu.dispatch_sign_share_batch(
        [(sk_set.secret_key_share(i), msg) for i in range(n)])
    shares = pending.result()
    jshares = jcpu.sign_share_batch([(jsk_set.secret_key_share(i), msg) for i in range(n)])
    assert [_affine(s.point) for s in shares] == [_jaffine(s.point) for s in jshares]
    assert limbs_out.shape == (3, 2, 12, n)

    quorum = {i: shares[i] for i in (1, 3, 0)}  # the lowest t + 1 ids combine
    jquorum = {i: jshares[i] for i in (1, 3, 0)}
    pk_set = th.PublicKeySet([bls.G1] * (t + 1))  # the combine reads only t
    (sig,) = gpu.combine_signature_shares_batch([(pk_set, quorum)])
    (jsig,) = jcpu.combine_signature_shares_batch([(jsk_set.public_keys(), jquorum)])
    assert _affine(sig.point) == _jaffine(jsig.point)
    assert sig.to_bytes() == jsig.to_bytes() and sig.parity() == jsig.parity()
    assert sig == th.Signature(bls.mul_sub(bls.hash_to_g2(msg), sk_set.secret_key().scalar))
    host = engine.CpuEngine().combine_signature_shares_batch([(pk_set, quorum)])
    assert host == [sig]
    with pytest.raises(ValueError):
        gpu.combine_signature_shares_batch([(pk_set, {0: shares[0]})])
    assert gpu.sign_share_batch([]) == [] and gpu.combine_signature_shares_batch([]) == []


def test_combine_keeps_every_job_across_quorum_sizes(monkeypatch):
    """Jobs of two quorum sizes take one weighted-sum dispatch each, and
    the device result holds every job's signature in its own column (the
    ladder is replaced by a stand-in that returns a point per size)."""
    by_size = {2: bls.double(bls.G2), 3: bls.add(bls.double(bls.G2), bls.G2)}
    calls = []

    def ladder(points_batch, coeffs_batch, device, use_kernel):
        s = len(points_batch[0])
        calls.append(s)
        return torch.from_numpy(limbs.g2_points_to_limbs([by_size[s]] * len(points_batch)))

    monkeypatch.setattr(engine.bls_g2_torch, "g2_weighted_sum_dispatch", ladder)
    shares = {i: th.SignatureShare(bls.G2) for i in range(4)}
    sizes = [2, 3, 2, 3, 3]
    jobs = [(th.PublicKeySet([bls.G1] * s), shares) for s in sizes]
    out, pending = engine.GpuEngine(device="cpu").dispatch_combine_signature_shares_batch(jobs)
    assert sorted(calls) == [2, 3] and out.shape == (3, 2, 12, len(jobs))
    assert pending.result() == [th.Signature(by_size[s]) for s in sizes]


def test_gpu_engine_rs_entries_equal_the_jax_cpu_engine():
    k, p, B, L = 4, 6, 3, 16
    data = np.random.default_rng(4).integers(0, 256, (B, k, L)).astype(np.uint8)
    gpu, host, jcpu = engine.GpuEngine(device="cpu"), engine.CpuEngine(), jengine.CpuEngine()
    want = jcpu.rs_encode_batch(data, k, p)
    for eng in (gpu, host):
        assert np.array_equal(eng.rs_encode_batch(data, k, p), want)
        fut = eng.submit_rs_encode_batch(data, k, p)
        assert np.array_equal(fut.result(), want)
    rows = [1, 4, 6, 9]
    surviving = want[:, rows]
    jrec = jcpu.rs_reconstruct_batch(surviving, rows, k, p)
    assert np.array_equal(jrec, data)
    for eng in (gpu, host):
        assert np.array_equal(eng.rs_reconstruct_batch(surviving, rows, k, p), jrec)
        assert np.array_equal(eng.submit_rs_reconstruct_batch(surviving, rows, k, p).result(), jrec)


def test_futures_fetch_once_cache_failures_and_warn_on_drop():
    calls = []
    fut = futures.submit(lambda: calls.append(1) or len(calls), "count")
    assert not fut.done
    assert fut.result() == 1 and fut.result() == 1 and calls == [1] and fut.done

    def boom():
        calls.append(2)
        raise KeyError("device")

    bad = futures.submit(boom, "boom")
    for _ in range(2):
        with pytest.raises(KeyError):
            bad.result()
    assert calls == [1, 2]
    assert futures.immediate(5, "now").result() == 5

    with pytest.warns(futures.DroppedFutureWarning, match="dropped"):
        futures.submit(lambda: 0, "dropped-one")
        gc.collect()
    eng = engine.GpuEngine(device="cpu")
    with pytest.warns(futures.DroppedFutureWarning, match="rs_encode_batch"):
        eng.submit_rs_encode_batch(np.zeros((1, 2, 4), np.uint8), 2, 1)
        gc.collect()
    # the drops are remembered for the sim's tick boundary, which raises once
    with pytest.raises(RuntimeError, match="dropped-one.*rs_encode_batch"):
        futures.check_dropped()
    futures.check_dropped()


def test_registry_and_no_card(monkeypatch):
    """The default is the card's engine, which raises without a card; the
    host engine is had only by its name."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delitem(engine._INSTANCES, "gpu", raising=False)
    with pytest.raises(RuntimeError, match="cuda"):
        engine.get_engine()
    with pytest.raises(RuntimeError, match="cuda"):
        engine.get_engine("gpu")
    host = engine.get_engine("cpu")
    assert type(host) is engine.CpuEngine and engine.get_engine("cpu") is host
    gpu = engine.GpuEngine(device="cpu")
    assert engine.get_engine(gpu) is gpu and gpu.name == "gpu"
    with pytest.raises(ValueError):
        engine.get_engine("tpu")
    with pytest.raises(RuntimeError, match="cuda"):
        engine.GpuEngine()
    with pytest.raises(RuntimeError, match="cuda"):
        coin.CoinRound(coin.CoinConfig(n_nodes=4, instances=1))


def test_coin_documents_and_hash_cache():
    assert coin.coin_doc(2, 7, 1) == b"ABA-COIN" + b"hb/2/7" + (1).to_bytes(4, "big")
    eng = engine.CpuEngine()
    h = eng.hash_to_g2(b"x")
    assert eng.hash_to_g2(b"x") is h
    assert _affine(h) == _jaffine(jbls.hash_to_g2(b"x"))
