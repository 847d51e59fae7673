"""The low-comm broadcast's shard sketches in the port against the JAX
package: the host twin `crypto/homhash.sketch_batch_np` and
`ops/homhash_torch.sketch_batch` on a CPU tensor (kernel B1's plain
version) byte-equal to the JAX `homhash.sketch_batch_np` at every (B, L)
of the sweep and to the JAX device twin `homhash_jax.sketch_batch` (one
small jit); the counter-mode matrix's strict-extension property; and the
GPU engine's `homhash_batch` on the CPU."""
import numpy as np
import pytest
import torch

from hydrabadger_tpu.crypto import homhash as jhomhash
from hydrabadger_tpu_torch.consensus import broadcast
from hydrabadger_tpu_torch.crypto import engine, homhash
from hydrabadger_tpu_torch.ops import homhash_torch

SEEDS = (b"", b"\x00" * 32, bytes(range(32)))


def shards(b, length, seed):
    return np.random.default_rng(1000 * b + length + len(seed)).integers(
        0, 256, (b, length), dtype=np.uint8)


@pytest.mark.parametrize("length", [0, 1, 7, 300])
@pytest.mark.parametrize("b", [0, 1, 16, 64])
def test_sketches_equal_the_jax_host_twin(b, length):
    for seed in SEEDS:
        x = shards(b, length, seed)
        want = jhomhash.sketch_batch_np(x, seed)
        assert want.shape == (b, homhash.SKETCH_BYTES)
        assert np.array_equal(homhash.sketch_batch_np(x, seed), want)
        before = sum(homhash_torch.calls.values())
        got = homhash_torch.sketch_batch(x, seed, device="cpu")
        assert got.dtype == np.uint8 and np.array_equal(got, want)
        # B = 0 or L = 0: zeros, and no product
        assert sum(homhash_torch.calls.values()) == before + (b * length > 0)


def test_sketches_equal_the_jax_device_twin():
    from hydrabadger_tpu.ops import homhash_jax

    x = shards(16, 7, b"jit")
    want = homhash_jax.sketch_batch(x, b"jit")
    assert np.array_equal(homhash_torch.sketch_batch(x, b"jit", device="cpu"), want)
    assert np.array_equal(homhash.sketch_batch_np(x, b"jit"), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_matrix_is_a_strict_extension_and_equals_the_jax_matrix(seed):
    long = homhash.matrix_T(seed, 301)
    assert np.array_equal(long, jhomhash.matrix_T(seed, 301))
    assert not long.flags.writeable
    for length in (1, 3, 4, 5, 97, 300):
        assert np.array_equal(homhash.matrix_T(seed, length), long[:, :length])
    # zero bytes appended to the shards leave every sketch unchanged
    x = shards(5, 13, seed)
    padded = np.concatenate([x, np.zeros((5, 19), np.uint8)], axis=1)
    assert np.array_equal(homhash.sketch_batch_np(padded, seed), homhash.sketch_batch_np(x, seed))


def test_sketches_are_gf256_linear():
    from hydrabadger_tpu_torch.crypto import gf256

    x = shards(2, 37, b"lin")
    c = np.uint8(0x53)
    combo = gf256.add(x[0], gf256.mul(np.full(37, c, np.uint8), x[1]))
    s = homhash.sketch_batch_np(np.stack([x[0], x[1], combo]), b"lin")
    assert np.array_equal(s[2], gf256.add(s[0], gf256.mul(np.full(8, c, np.uint8), s[1])))


def test_engines_sketch_as_the_jax_cpu_engine():
    from hydrabadger_tpu.crypto import engine as jengine

    rows = [bytes(r) for r in shards(16, 7, b"eng")]
    want = jengine.CpuEngine().homhash_batch(rows, b"eng")
    gpu = engine.GpuEngine(device="cpu")
    assert engine.get_engine("cpu").homhash_batch(rows, b"eng") == want
    assert gpu.homhash_batch(rows, b"eng") == want
    assert gpu.submit_homhash_batch(rows, b"eng").result() == want
    assert gpu.homhash_batch([], b"eng") == []
    assert broadcast.SKETCH_BYTES == homhash.SKETCH_BYTES == jhomhash.SKETCH_BYTES


def test_a_sketch_on_a_card_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        homhash_torch.sketch_batch(shards(2, 3, b""), b"", device="cuda")
