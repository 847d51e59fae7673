"""The port's Reed-Solomon layer (hydrabadger_tpu_torch) against the JAX
package: encode/decode matrices, the host codec and the host GF(2^8) library
it runs on (crypto/_native, a build of native/gf256_rs.cpp), and the batched
device encode/reconstruct against rs_jax on both its paths (Pallas in
interpret mode, and XLA).  Every comparison is exact byte equality."""
import dataclasses

import numpy as np
import pytest
import torch

from hydrabadger_tpu.crypto import _native as jnative
from hydrabadger_tpu.crypto import rs as jrs
from hydrabadger_tpu.ops import rs_jax
from hydrabadger_tpu_torch.crypto import _native, gf256, rs
from hydrabadger_tpu_torch.ops import rs_torch
from hydrabadger_tpu_torch.utils import host_native


def rand(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("k,p", [(1, 0), (4, 2), (10, 5), (22, 42)])
def test_encode_matrix_equals_jax_package(k, p):
    assert np.array_equal(rs.encode_matrix(k, p), jrs.encode_matrix(k, p))


def test_decode_matrix_equals_rs_jax():
    for rows in ((2, 3, 4, 5), (0, 2, 4, 5)):
        assert np.array_equal(rs.decode_matrix(4, 2, rows), rs_jax._decode_mat(4, 2, rows))
    rows = tuple(range(42, 64))
    assert np.array_equal(rs.decode_matrix(22, 42, rows), rs_jax._decode_mat(22, 42, rows))


def test_codec_matches_jax_codec():
    k, p, L = 5, 4, 33
    mine, theirs = rs.ReedSolomon(k, p), jrs.ReedSolomon(k, p)
    data = rand((k, L), 9)
    full = mine.encode(data)
    assert np.array_equal(full, theirs.encode(data))
    assert mine.verify(list(full)) and theirs.verify(list(full))
    bad = full.copy()
    bad[k, 0] ^= 1
    assert not mine.verify(list(bad))
    rng = np.random.default_rng(3)
    for _ in range(4):
        lost = set(rng.choice(k + p, size=p, replace=False).tolist())
        slots = [None if i in lost else full[i] for i in range(k + p)]
        for data_only in (False, True):
            got = mine.reconstruct(slots, data_only=data_only)
            want = theirs.reconstruct(slots, data_only=data_only)
            assert len(got) == len(want)
            assert all(np.array_equal(g, w) for g, w in zip(got, want))
    with pytest.raises(rs.ReedSolomonError):
        mine.reconstruct([None] * (k + p))
    with pytest.raises(ValueError):
        mine.encode(rand((k + 1, L), 1))


@pytest.mark.parametrize("k,p,B,L", [(4, 2, 3, 32), (22, 42, 8, 12)])
def test_batch_encode_matches_rs_jax(k, p, B, L):
    data = rand((B, k, L), B + L)
    got = rs_torch.rs_encode_batch(torch.from_numpy(data), k, p)
    plain = rs_torch.rs_encode_batch(torch.from_numpy(data), k, p, use_kernel=False)
    assert got.shape == (B, k + p, L) and torch.equal(got, plain)
    for use_pallas in (True, False):
        want = np.asarray(rs_jax.rs_encode_batch(data, k, p, use_pallas=use_pallas))
        assert np.array_equal(got.numpy(), want), use_pallas


def _survivor_sets(k, p, count, seed):
    rng = np.random.default_rng(seed)
    return [tuple(sorted(rng.choice(k + p, size=k, replace=False).tolist()))
            for _ in range(count)]


@pytest.mark.parametrize(
    "k,p,B,L,pallas_sets",
    [(4, 2, 6, 48, 2), (22, 42, 4, 12, 1)],
)
def test_batch_reconstruct_matches_rs_jax(k, p, B, L, pallas_sets):
    rsj = jrs.ReedSolomon(k, p)
    data = rand((B, k, L), k + B)
    full = np.stack([rsj.encode(data[b]) for b in range(B)])
    row_sets = [tuple(range(p, k + p))] + _survivor_sets(k, p, 3, k)
    for n_set, rows in enumerate(row_sets):
        surviving = full[:, list(rows), :]
        got = rs_torch.rs_reconstruct_batch(torch.from_numpy(surviving), rows, k, p)
        assert np.array_equal(got.numpy(), data), rows
        want = np.asarray(rs_jax.rs_reconstruct_batch(surviving, rows, k, p, use_pallas=False))
        assert np.array_equal(got.numpy(), want), rows
        if n_set < pallas_sets:
            want = rs_jax.rs_reconstruct_batch(surviving, rows, k, p, use_pallas=True)
            assert np.array_equal(got.numpy(), np.asarray(want)), rows


def test_reconstruct_reads_a_strided_quorum_view():
    k, p, B, L = 4, 2, 5, 16
    data = torch.from_numpy(rand((B, k, L), 2))
    encoded = rs_torch.rs_encode_batch(data, k, p)
    view = encoded[:, p:]  # non-contiguous [B, k, L]
    got = rs_torch.rs_reconstruct_batch(view, range(p, k + p), k, p)
    assert torch.equal(got, data)


def test_argument_errors_match_rs_jax():
    bad_rows = (np.zeros((1, 3, 8), np.uint8), (0, 1, 2), 4, 2)
    with pytest.raises(ValueError):
        rs_jax.rs_reconstruct_batch(*bad_rows)
    with pytest.raises(ValueError):
        rs_torch.rs_reconstruct_batch(torch.from_numpy(bad_rows[0]), *bad_rows[1:])
    bad_shape = np.zeros((2, 3, 8), np.uint8)
    with pytest.raises(ValueError):
        rs_jax.rs_encode_batch(bad_shape, 4, 2)
    with pytest.raises(ValueError):
        rs_torch.rs_encode_batch(torch.from_numpy(bad_shape), 4, 2)
    with pytest.raises(TypeError):
        rs_torch.rs_encode_batch(bad_shape, 3, 2)


@pytest.mark.parametrize("m,k,n", [(3, 5, 7), (1, 1, 1), (4, 0, 9), (0, 3, 5), (2, 6, 0),
                                   (42, 22, 12), (8, 300, 64), (17, 33, 10_001)])
def test_host_gf_library_equals_gf256_and_the_jax_library(m, k, n):
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    a = rng.integers(0, 256, (m, k), dtype=np.uint8)
    b = rng.integers(0, 256, (k, n), dtype=np.uint8)
    got = _native.gf_matmul(a, b)
    assert got.shape == (m, n) and got.dtype == np.uint8
    assert np.array_equal(got, gf256.matmul(a, b))
    assert np.array_equal(got, jnative.gf_matmul(a, b))
    # strided operands are read through contiguous copies
    assert np.array_equal(_native.gf_matmul(np.asfortranarray(a), b[:, ::-1]),
                          gf256.matmul(a, b[:, ::-1]))


def test_host_gf_library_shape_errors_and_a_failing_build(monkeypatch, tmp_path):
    with pytest.raises(ValueError):
        _native.gf_matmul(np.zeros((2, 3), np.uint8), np.zeros((4, 5), np.uint8))
    with pytest.raises(ValueError):
        _native.gf_matmul(np.zeros(3, np.uint8), np.zeros((3, 5), np.uint8))
    assert _native._load() is not None and host_native.GF.dest.parent == host_native.OUT_DIR
    monkeypatch.setenv("CXX", "false")
    broken = dataclasses.replace(host_native.GF, dest=tmp_path / "libgf256_rs.so")
    monkeypatch.setattr(host_native, "GF", broken)
    monkeypatch.setattr(_native, "_LIB", None)
    with pytest.raises(RuntimeError, match="host GF.* build failed"):
        _native.gf_matmul(np.zeros((2, 3), np.uint8), np.zeros((3, 5), np.uint8))


@pytest.mark.parametrize("k,p,L", [(1, 0, 5), (4, 2, 33), (10, 5, 1), (22, 42, 12)])
def test_host_codec_encode_and_reconstruct_equal_the_jax_codec(k, p, L):
    mine, theirs = rs.ReedSolomon(k, p), jrs.ReedSolomon(k, p)
    data = rand((k, L), k + p + L)
    full = mine.encode(data)
    assert np.array_equal(full, theirs.encode(data))
    rng = np.random.default_rng(k + p)
    for _ in range(3):
        lost = set(rng.choice(k + p, size=p, replace=False).tolist())
        slots = [None if i in lost else full[i] for i in range(k + p)]
        for data_only in (False, True):
            got = mine.reconstruct(slots, data_only=data_only)
            want = theirs.reconstruct(slots, data_only=data_only)
            assert all(np.array_equal(g, w) for g, w in zip(got, want)) and len(got) == len(want)
    payload = bytes(rng.integers(0, 256, 3 * L + 1, dtype=np.uint8))
    shards = mine.encode_bytes(payload)
    assert shards == theirs.encode_bytes(payload)
    quorum = [None] * p + shards[p:]
    assert mine.reconstruct_data(quorum) == theirs.reconstruct_data(quorum) == payload
