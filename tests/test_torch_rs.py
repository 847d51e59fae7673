"""The port's Reed-Solomon layer (hydrabadger_tpu_torch) against the JAX
package: encode/decode matrices, the numpy codec, and the batched device
encode/reconstruct against rs_jax on both its paths (Pallas in interpret
mode, and XLA).  Every comparison is exact byte equality."""
import numpy as np
import pytest
import torch

from hydrabadger_tpu.crypto import rs as jrs
from hydrabadger_tpu.ops import rs_jax
from hydrabadger_tpu_torch.crypto import rs
from hydrabadger_tpu_torch.ops import rs_torch


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
