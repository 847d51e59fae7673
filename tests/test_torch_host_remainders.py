"""The port's host remainders against the JAX package on the CPU: the
crypto futures' process-registry counters (a DKG MSM submit, a submitted
and fetched future, a dropped one), `gf256.div` / `matvec`,
`native_bls.g2_mul_batch` and the engines' immediate
`submit_verify_decryption_shares_batch`."""
import gc
import random

import numpy as np
import pytest

from hydrabadger_tpu.crypto import bls12_381 as jbls
from hydrabadger_tpu.crypto import dkg as jdkg
from hydrabadger_tpu.crypto import engine as jengine
from hydrabadger_tpu.crypto import futures as jfutures
from hydrabadger_tpu.crypto import gf256 as jgf256
from hydrabadger_tpu.crypto import native_bls as jnb
from hydrabadger_tpu.crypto import threshold as jth
from hydrabadger_tpu.obs import metrics as jmetrics
from hydrabadger_tpu_torch.crypto import bls12_381 as bls
from hydrabadger_tpu_torch.crypto import dkg, futures, gf256
from hydrabadger_tpu_torch.crypto import native_bls as nb
from hydrabadger_tpu_torch.crypto import threshold as th
from hydrabadger_tpu_torch.crypto.engine import CpuEngine, GpuEngine
from hydrabadger_tpu_torch.obs import metrics


def _futures_counters(registry) -> dict:
    return {k: v for k, v in registry.snapshot()["counters"].items() if "futures" in k}


def _delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def _in_both(fn_port, fn_jax) -> tuple:
    """Run one step in each package; the change of each process registry's
    `*futures*` counters."""
    out = []
    for fn, reg in ((fn_port, metrics.default_registry()), (fn_jax, jmetrics.default_registry())):
        before = _futures_counters(reg)
        fn()
        gc.collect()
        out.append(_delta(before, _futures_counters(reg)))
    return tuple(out)


# -- the futures' process-registry counters ---------------------------------


def test_a_dkg_msm_submit_counts_as_in_jax(monkeypatch):
    monkeypatch.delenv("HYDRABADGER_GPU_DKG", raising=False)
    got = {}

    def port():
        got["port"] = dkg.g1_msm_batch_submit([([bls.G1, bls.G1], [3, 5])]).result()

    def jax():
        got["jax"] = jdkg.g1_msm_batch_submit([([jbls.G1, jbls.G1], [3, 5])]).result()

    mine, theirs = _in_both(port, jax)
    assert mine == theirs == {"crypto_futures_submitted": 1, "crypto_futures_fetched": 1}
    assert bls.g1_to_bytes(got["port"][0]) == jbls.g1_to_bytes(got["jax"][0])
    assert bls.eq(got["port"][0], bls.multiply(bls.G1, 8))


def test_a_submitted_future_counts_at_its_fetch_as_in_jax():
    state = {}

    def port():
        state["port"] = futures.submit(lambda: 5, "t")
        state["port_mid"] = _futures_counters(metrics.default_registry())
        assert state["port"].result() == 5

    def jax():
        state["jax"] = jfutures.submit(lambda: 5, "t")
        assert state["jax"].result() == 5

    mine, theirs = _in_both(port, jax)
    assert mine == theirs == {"crypto_futures_submitted": 1, "crypto_futures_fetched": 1}
    # fetched only once result() has run
    assert state["port_mid"].get("crypto_futures_fetched", 0) + 1 == \
        _futures_counters(metrics.default_registry())["crypto_futures_fetched"]
    reg = metrics.default_registry().snapshot()["gauges"]
    assert metrics.DEVICE_OVERLAP_RATIO in reg and metrics.DEVICE_IDLE_S in reg


def test_a_dropped_future_counts_as_in_jax():
    def port():
        with pytest.warns(futures.DroppedFutureWarning):
            futures.submit(lambda: 1, "dropped")
            gc.collect()

    def jax():
        jfutures.submit(lambda: 1, "dropped")

    mine, theirs = _in_both(port, jax)
    assert mine == theirs == {"crypto_futures_submitted": 1, "crypto_futures_dropped": 1}
    for mod in (futures, jfutures):
        with pytest.raises(RuntimeError, match="dropped"):
            mod.check_dropped()


# -- gf256.div / matvec ------------------------------------------------------


def test_gf256_div_and_matvec_equal_jax():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, 300).astype(np.uint8)
    b = rng.integers(1, 256, 300).astype(np.uint8)
    q = gf256.div(a, b)
    assert np.array_equal(q, jgf256.div(a, b))
    assert np.array_equal(gf256.mul(q, b), a)
    assert int(gf256.div(7, 7)) == 1 and int(gf256.div(0, 9)) == 0
    for mod in (gf256, jgf256):
        with pytest.raises(ZeroDivisionError):
            mod.div(3, 0)
    m = rng.integers(0, 256, (7, 11)).astype(np.uint8)
    v = rng.integers(0, 256, 11).astype(np.uint8)
    got = gf256.matvec(m, v)
    assert got.shape == (7,) and np.array_equal(got, jgf256.matvec(m, v))
    assert np.array_equal(got, gf256.matmul(m, v[:, None])[:, 0])


# -- native_bls.g2_mul_batch -------------------------------------------------


def test_g2_mul_batch_equals_the_oracle_and_jax():
    rng = random.Random(31)
    pts = [bls._py_hash_to_g2(b"g2-batch-%d" % i) for i in range(2)]
    ks = [rng.randrange(bls.R), 0, 1, bls.R - 1]
    pts = pts + pts
    got = nb.g2_mul_batch(pts, ks)
    assert len(got) == 4
    jpts = [jbls.g2_from_bytes(bls.g2_to_bytes(p)) for p in pts]
    want = jnb.g2_mul_batch(jpts, ks) if jnb.available() else [
        jbls.multiply(p, k) for p, k in zip(jpts, ks)]
    for g, p, k, w in zip(got, pts, ks, want):
        assert bls.eq(g, bls._py_multiply(p, k))
        assert bls.g2_to_bytes(g) == jbls.g2_to_bytes(w)
    assert nb.g2_mul_batch([], []) == []


# -- submit_verify_decryption_shares_batch ----------------------------------


def test_submit_verify_decryption_shares_batch_equals_jax():
    """Three same-ciphertext shares, one forged, in both packages (the same
    key set and ciphertext from the same seeds): the immediate futures'
    verdicts equal JAX CpuEngine's."""
    sks, jsks = th.SecretKeySet.random(1, random.Random(4)), jth.SecretKeySet.random(
        1, random.Random(4))
    ct = sks.public_keys().public_key().encrypt(b"remainder", random.Random(6))
    jct = jsks.public_keys().public_key().encrypt(b"remainder", random.Random(6))
    assert ct.to_bytes() == jct.to_bytes()
    pks = [sks.public_keys().public_key_share(i) for i in range(3)]
    jpks = [jsks.public_keys().public_key_share(i) for i in range(3)]
    shares = [sks.secret_key_share(i).decrypt_share(ct) for i in range(3)]
    jshares = [jsks.secret_key_share(i).decrypt_share(jct) for i in range(3)]
    shares[2], jshares[2] = shares[1], jshares[1]  # node 2 sends node 1's share
    jfut = jengine.get_engine("cpu").submit_verify_decryption_shares_batch(jpks, jshares, jct)
    assert jfut.result() == [True, True, False]
    for eng in (CpuEngine(), GpuEngine(device="cpu")):
        fut = eng.submit_verify_decryption_shares_batch(pks, shares, ct)
        assert fut.done and fut.label == "verify_dec_shares"
        assert fut.result() == jfut.result()
        assert eng.submit_verify_decryption_shares_batch(pks[:2], shares[:2], ct).result() == \
            [True, True]
