"""The port's transform plane (ops/ntt_torch, ops/afft_torch, ops/rs_fft)
and the FFT route of RS (crypto/rs, crypto/engine) on the CPU, case for
case after tests/test_ntt.py and held against the JAX package: the Cantor
basis, the torch AFFT against JAX's afft_T and both packages' numpy twins
for m = 1..8, rs_fft's bytes against the matrix route at every tier-1
geometry, the routing thresholds on the host codec and on
GpuEngine(device="cpu"), the engine's Fr multipoint entries and the lane
counters."""
import random

import numpy as np
import pytest
import torch

from hydrabadger_tpu.crypto import engine as jengine
from hydrabadger_tpu.ops import afft_T, ntt_T
from hydrabadger_tpu.ops import rs_fft as jrs_fft
from hydrabadger_tpu_torch.crypto import _native, gf256
from hydrabadger_tpu_torch.crypto.bls12_381 import R
from hydrabadger_tpu_torch.crypto.engine import CpuEngine, GpuEngine
from hydrabadger_tpu_torch.crypto.rs import ReedSolomon, encode_matrix
from hydrabadger_tpu_torch.crypto.threshold import poly_eval
from hydrabadger_tpu_torch.obs.metrics import default_registry
from hydrabadger_tpu_torch.ops import afft_torch, fr_poly, ntt_torch, rs_fft

# every (data, parity) geometry exercised elsewhere in tier 1
TIER1_SHAPES = [
    (1, 1), (2, 1), (3, 2), (4, 2), (4, 3),
    (16, 8), (22, 42), (42, 21), (170, 85),
]
CPU = torch.device("cpu")


# -- the Fr names ------------------------------------------------------------


def test_fr_names_are_fr_poly_s_and_jax_s():
    assert (ntt_torch.FR_TWO_ADICITY, ntt_torch.FR_GENERATOR, ntt_torch.FR_ROOT_OF_UNITY) == (
        ntt_T.FR_TWO_ADICITY, ntt_T.FR_GENERATOR, ntt_T.FR_ROOT_OF_UNITY)
    rnd = random.Random(1)
    v = [rnd.randrange(R) for _ in range(16)]
    assert ntt_torch.fr_ntt(v) == ntt_T.fr_ntt(v) == fr_poly.fr_ntt(v)
    assert ntt_torch.fr_intt(ntt_torch.fr_ntt(v)) == v
    a, b = v[:5], v[5:12]
    assert ntt_torch.fr_poly_mul(a, b) == ntt_T.fr_poly_mul(a, b)


# -- GF(256) additive (Cantor) FFT -------------------------------------------


def test_cantor_basis_well_formed_and_jax_s():
    basis, pts, pt2, slot = ntt_torch._cantor_plan()
    jbasis, jpts, jpt2, jslot = ntt_T._cantor_plan()
    assert basis == jbasis and basis[0] == 1
    for lo, hi in zip(basis, basis[1:]):
        assert int(gf256.mul(hi, hi)) ^ hi == lo  # v_{i+1}^2 + v_{i+1} = v_i
    assert len(set(int(p) for p in ntt_torch.afft_points())) == 256
    for mine, theirs in ((pts, jpts), (pt2, jpt2), (slot, jslot)):
        assert np.array_equal(mine, theirs)
    assert np.array_equal(ntt_torch.afft_points()[ntt_torch.afft_slot_of()], np.arange(256))


def test_afft_roundtrip_and_naive_eval():
    rng = np.random.default_rng(0)
    pts = ntt_torch.afft_points()
    for m in (0, 1, 3, 5, 8):
        n = 1 << m
        c = rng.integers(0, 256, (n, 3)).astype(np.uint8)
        ev = ntt_torch.gf_afft(c, m)
        assert np.array_equal(ntt_torch.gf_iafft(ev, m), c)
        for j in (0, n // 2, n - 1):
            x = int(pts[j])
            acc = np.zeros(3, np.uint8)
            xp = 1
            for i in range(n):
                acc ^= gf256.mul(c[i], xp)
                xp = int(gf256.MUL_TABLE[xp, x])
            assert np.array_equal(acc, ev[j]), (m, j)


@pytest.mark.parametrize("m", range(1, 9))
def test_torch_afft_equals_jax_afft_T_and_both_numpy_twins(m):
    rng = np.random.default_rng(m)
    n = 1 << m
    c = rng.integers(0, 256, (n, 2, 5)).astype(np.uint8)
    fwd = ntt_torch.gf_afft(c, m)
    assert np.array_equal(fwd, ntt_T.gf_afft(c, m))
    assert np.array_equal(np.asarray(afft_T._afft_fwd_T(c, m)), fwd)
    got = afft_torch.afft_fwd(torch.from_numpy(c), m)
    assert got.dtype == torch.uint8 and got.shape == c.shape
    assert np.array_equal(got.numpy(), fwd)
    inv = afft_torch.afft_inv(torch.from_numpy(fwd), m).numpy()
    assert np.array_equal(inv, c)
    assert np.array_equal(np.asarray(afft_T._afft_inv_T(fwd, m)), c)
    assert np.array_equal(ntt_torch.gf_iafft(fwd, m), ntt_T.gf_iafft(fwd, m))


def test_afft_rejects_bad_shapes():
    with pytest.raises(ValueError):
        ntt_torch.gf_afft(np.zeros((3, 2), np.uint8), 2)
    with pytest.raises(ValueError):
        afft_torch.afft_fwd(torch.zeros((4, 2), dtype=torch.int32), 2)
    with pytest.raises(ValueError):
        afft_torch.afft_inv(torch.zeros((8,), dtype=torch.uint8), 2)


# -- RS via the FFT plane: byte identity with the matrix route ---------------


@pytest.mark.parametrize("k,p", TIER1_SHAPES)
def test_rs_fft_encode_identical_to_matrix(k, p):
    rng = np.random.default_rng(k * 1000 + p)
    data = rng.integers(0, 256, (k, 9)).astype(np.uint8)
    want = gf256.matmul(np.asarray(encode_matrix(k, p))[k:], data)
    assert np.array_equal(rs_fft.encode_parity(data, k, p), want)
    assert np.array_equal(jrs_fft.encode_parity(data, k, p), want)
    assert np.array_equal(rs_fft.encode_parity(data, k, p, CPU), want)


@pytest.mark.parametrize("k,p", [(4, 2), (16, 8), (42, 21), (170, 85)])
def test_rs_fft_reconstruct_identical_to_matrix(k, p):
    rng = np.random.default_rng(k)
    n = k + p
    data = rng.integers(0, 256, (k, 5)).astype(np.uint8)
    full = np.concatenate([data, gf256.matmul(np.asarray(encode_matrix(k, p))[k:], data)])
    killed = sorted(int(x) for x in rng.choice(n, size=min(p, 3), replace=False))
    present = [i for i in range(n) if i not in killed][:k]
    rec = rs_fft.reconstruct_rows(full[present], present, killed, k, p)
    assert np.array_equal(rec, full[killed])
    assert np.array_equal(rs_fft.reconstruct_rows(full[present], present, killed, k, p, CPU),
                          full[killed])
    with pytest.raises(ValueError):
        rs_fft.reconstruct_rows(full[present[:-1]], present[:-1], killed, k, p)


def test_rs_fft_batch_encode():
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, (4, 16, 12)).astype(np.uint8)
    out = rs_fft.encode_batch(data, 16, 8)
    assert np.array_equal(out, jrs_fft.encode_batch(data, 16, 8))
    assert np.array_equal(rs_fft.encode_batch(data, 16, 8, CPU), out)
    rs = ReedSolomon(16, 8)
    for b in range(4):
        assert np.array_equal(out[b], rs.encode(data[b]))
    with pytest.raises(ValueError):
        rs_fft.encode_batch(data[:, :15], 16, 8)


# -- routing: the host codec -------------------------------------------------


def _roundtrip(rs: ReedSolomon, payload: bytes) -> list:
    shards = rs.encode_bytes(payload)
    holes = [s if i not in (0, rs.total_shards - 1) else None for i, s in enumerate(shards)]
    assert rs.reconstruct_data(holes) == payload
    return shards


def test_rs_routing_crossover_identical(monkeypatch):
    """Both routes emit identical shards at the switch point, and the kill
    switch pins the matrix route at any n."""
    payload = b"crossover pinning payload " * 5
    monkeypatch.setenv("HYDRABADGER_NTT_MIN_SHARDS", "6")
    assert ReedSolomon(4, 2)._route_ntt()
    fft_shards = _roundtrip(ReedSolomon(4, 2), payload)
    monkeypatch.setenv("HYDRABADGER_NTT_MIN_SHARDS", "7")
    assert not ReedSolomon(4, 2)._route_ntt()
    matrix_shards = _roundtrip(ReedSolomon(4, 2), payload)
    assert fft_shards == matrix_shards
    monkeypatch.setenv("HYDRABADGER_NTT_MIN_SHARDS", "6")
    monkeypatch.setenv("HYDRABADGER_NTT", "0")
    assert not ReedSolomon(4, 2)._route_ntt()
    assert _roundtrip(ReedSolomon(4, 2), payload) == matrix_shards


def test_rs_default_threshold_is_keyed_on_the_host_library(monkeypatch):
    """As in JAX: where the host GF library is built the route never
    fires by default; without it, from 128 shards."""
    monkeypatch.delenv("HYDRABADGER_NTT_MIN_SHARDS", raising=False)
    monkeypatch.delenv("HYDRABADGER_NTT", raising=False)
    assert _native.native_available()
    assert not ReedSolomon(170, 85)._route_ntt()
    monkeypatch.setattr(_native, "native_available", lambda: False)
    assert ReedSolomon(86, 42)._route_ntt() and not ReedSolomon(84, 42)._route_ntt()
    assert not ReedSolomon(128, 0)._route_ntt()  # no parity: nothing to route


def test_rs_routed_verify_and_parity_reconstruct(monkeypatch):
    monkeypatch.setenv("HYDRABADGER_NTT_MIN_SHARDS", "5")
    rs = ReedSolomon(3, 2)
    data = np.arange(30, dtype=np.uint8).reshape(3, 10)
    full = rs.encode(data)
    assert rs.verify(list(full))
    holes = [full[i] if i not in (1, 4) else None for i in range(5)]
    restored = rs.reconstruct(holes)
    for i in range(5):
        assert np.array_equal(restored[i], full[i])
    corrupted = [np.array(s) for s in full]
    corrupted[4][0] ^= 1
    assert not rs.verify(corrupted)


def test_host_route_never_reaches_the_device_transform(monkeypatch):
    """The host codec's FFT route runs the numpy twin: the torch transform
    is never called on it."""
    def refuse(*_a, **_k):
        raise AssertionError("the host RS route called ops/afft_torch")

    monkeypatch.setattr(afft_torch, "afft_fwd", refuse)
    monkeypatch.setenv("HYDRABADGER_NTT_MIN_SHARDS", "6")
    _roundtrip(ReedSolomon(4, 2), b"host only" * 7)
    assert CpuEngine().rs_encode_batch(np.zeros((2, 4, 3), np.uint8), 4, 2).shape == (2, 6, 3)


# -- routing: GpuEngine(device="cpu") ------------------------------------------


def test_gpu_engine_rs_batch_routes_identically(monkeypatch):
    eng = GpuEngine(device="cpu")
    rng = np.random.default_rng(10)
    data = rng.integers(0, 256, (3, 4, 8)).astype(np.uint8)
    calls = []
    real = afft_torch.afft_fwd
    monkeypatch.setattr(afft_torch, "afft_fwd", lambda x, m: calls.append(x.device) or real(x, m))
    monkeypatch.setenv("HYDRABADGER_NTT_MIN_SHARDS", "6")
    assert eng._rs_route_ntt(4, 2) and not eng._rs_route_ntt(4, 1)
    routed = eng.rs_encode_batch(data, 4, 2)
    assert calls == [CPU]  # the forward transform on the engine's device
    monkeypatch.setenv("HYDRABADGER_NTT", "0")
    assert not eng._rs_route_ntt(4, 2)
    baseline = eng.rs_encode_batch(data, 4, 2)  # B1's plain version
    assert np.array_equal(routed, baseline)
    monkeypatch.delenv("HYDRABADGER_NTT")
    rec = eng.rs_reconstruct_batch(routed[:, [0, 2, 4, 5]], [0, 2, 4, 5], 4, 2)
    assert np.array_equal(rec, data)
    fut = eng.submit_rs_encode_batch(data, 4, 2)
    assert fut.done and np.array_equal(fut.result(), baseline)
    fut = eng.submit_rs_reconstruct_batch(routed[:, 2:], [2, 3, 4, 5], 4, 2)
    assert fut.done and np.array_equal(fut.result(), data)
    jeng = jengine.get_engine("cpu")
    assert np.array_equal(jeng.rs_encode_batch(data, 4, 2), routed)


def test_gpu_engine_route_is_opt_in_only(monkeypatch):
    """Unset, the engine keeps B1 at any geometry, whatever the host
    codec's default threshold."""
    monkeypatch.delenv("HYDRABADGER_NTT_MIN_SHARDS", raising=False)
    monkeypatch.setattr(_native, "native_available", lambda: False)
    assert ReedSolomon(170, 85)._route_ntt()
    assert not GpuEngine._rs_route_ntt(170, 85)


# -- engine entry points -----------------------------------------------------


def test_engine_fr_poly_eval_batch_and_submit():
    rnd = random.Random(9)
    rows = [[rnd.randrange(R) for _ in range(4)] for _ in range(2)]
    xs = [1, 2, 3, 4, 5]
    want = [[poly_eval(r, x) for x in xs] for r in rows]
    assert jengine.get_engine("cpu").fr_poly_eval_batch(rows, xs) == want
    for eng in (CpuEngine(), GpuEngine(device="cpu")):
        assert eng.fr_poly_eval_batch(rows, xs) == want
        fut = eng.submit_fr_poly_eval_batch(rows, xs)
        assert fut.done and fut.label == "fr_poly_eval_batch" and fut.result() == want


# -- lane counters -----------------------------------------------------------


def test_ntt_lane_counters_stamped():
    reg = default_registry()
    before_real = reg.counter("ntt_real_lanes").value
    before_pad = reg.counter("ntt_pad_lanes").value
    rng = np.random.default_rng(11)
    rs_fft.encode_parity(rng.integers(0, 256, (42, 4)).astype(np.uint8), 42, 21)
    # one dispatch of 256 rows x 4 lanes, the interpolant's 42 rows real
    assert reg.counter("ntt_real_lanes").value - before_real == 42 * 4
    assert reg.counter("ntt_pad_lanes").value - before_pad == (256 - 42) * 4
    assert reg.gauge("ntt_batch_lanes").value == 256 * 4
    assert reg.gauge("ntt_batch_lanes").high_water >= 256 * 4
