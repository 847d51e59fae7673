"""The port's GF(2^8) layer (hydrabadger_tpu_torch) against the JAX package.

Every comparison is exact byte equality.  On the CPU, `gf_matmul` runs the
kernel's plain version; the kernel itself is held against it on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""
import re

import numpy as np
import pytest
import torch

from hydrabadger_tpu.crypto import gf256 as jgf
from hydrabadger_tpu.ops import gf256_jax
from hydrabadger_tpu_torch.crypto import gf256
from hydrabadger_tpu_torch.ops import _kernels, gf256_torch


def rand(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def test_tables_and_field_ops_equal_the_jax_package():
    assert gf256.POLY == jgf.POLY and gf256.GENERATOR == jgf.GENERATOR
    for name in ("EXP_TABLE", "LOG_TABLE", "MUL_TABLE"):
        mine, theirs = getattr(gf256, name), getattr(jgf, name)
        assert mine.dtype == theirs.dtype and np.array_equal(mine, theirs), name
    nz = np.arange(1, 256, dtype=np.uint8)
    assert np.array_equal(gf256.inv(nz), jgf.inv(nz))
    a, b = rand(500, 1), rand(500, 2)
    assert np.array_equal(gf256.mul(a, b), jgf.mul(a, b))
    assert np.array_equal(gf256.vandermonde(64, 22), jgf.vandermonde(64, 22))
    for c in range(256):
        assert np.array_equal(gf256.bit_matrix_of_const(c), jgf.bit_matrix_of_const(c))
    for shape, seed in (((42, 22), 3), ((3, 5), 4)):
        m = rand(shape, seed)
        assert np.array_equal(gf256.expand_to_bit_matrix(m), jgf.expand_to_bit_matrix(m))
        d = rand((shape[1], 17), seed + 10)
        assert np.array_equal(gf256.matmul(m, d), jgf.matmul(m, d))
    sq = jgf.vandermonde(22, 22)
    assert np.array_equal(gf256.mat_inv(sq), jgf.mat_inv(sq))


def test_bits_roundtrip_matches_jax_layout():
    x = rand((2, 5, 40), 0)
    bits = gf256_torch.bytes_to_bits(torch.from_numpy(x))
    want = np.asarray(gf256_jax.bytes_to_bits(x))
    assert np.array_equal(bits.numpy().astype(np.int8), want)
    assert np.array_equal(gf256_torch.bits_to_bytes(bits).numpy(), x)


def test_gf_mul_and_gather_match_jax():
    a, b = rand(1000, 1), rand(1000, 2)
    got = gf256_torch.gf_mul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert np.array_equal(got, np.asarray(gf256_jax.gf_mul(a, b)))
    m, d = rand((8, 11), 5), rand((11, 100), 6)
    got = gf256_torch.gf_matmul_gather(torch.from_numpy(m), torch.from_numpy(d))
    assert np.array_equal(got.numpy(), np.asarray(gf256_jax.gf_matmul_gather(m, d)))


@pytest.mark.parametrize("L", [1, 13, 300])
@pytest.mark.parametrize("m,k", [(42, 22), (22, 22), (3, 5)])
def test_gf_matmul_matches_pallas_interpret(m, k, L):
    a = rand((m, k), m * 7 + k)
    d = rand((k, L), L + 100)
    want = np.asarray(gf256_jax.gf_matmul_pallas(a, d, tile_l=256))
    got = gf256_torch.gf_matmul(a, torch.from_numpy(d))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    assert np.array_equal(want, gf256.matmul(a, d))


def _emulate_kernel(table, tile_m, m, data):
    """numpy replay of csrc/gf256_matmul.cu's arithmetic on its table:
    four byte columns per 32-bit word, a 0x00/0xFF byte mask per data
    bit, AND with the replicated constant, XOR-accumulate, row tiles."""
    k, L = data.shape
    pad = (-L) % 4
    cols = np.pad(data, ((0, 0), (0, pad)))
    words = cols.reshape(k, -1, 4).astype(np.uint32)
    w = words[..., 0] | words[..., 1] << 8 | words[..., 2] << 16 | words[..., 3] << 24
    out = np.zeros((m, w.shape[1]), dtype=np.uint32)
    for tile in range(table.shape[0] // tile_m):
        for ii in range(tile_m):
            i = tile * tile_m + ii
            acc = np.zeros(w.shape[1], dtype=np.uint32)
            for j in range(k):
                for bit in range(8):
                    mask = ((w[j] >> np.uint32(bit)) & np.uint32(0x01010101)) * np.uint32(0xFF)
                    acc ^= mask & table[i, j, bit]
            if i < m:
                out[i] = acc
    as_bytes = out.view(np.uint8).reshape(m, -1)
    return as_bytes[:, :L]


@pytest.mark.parametrize("m,k,L", [(42, 22, 37), (22, 22, 12), (3, 5, 13)])
def test_kernel_table_replays_to_the_gf_product(m, k, L):
    a, d = rand((m, k), 11 + m), rand((k, L), 12 + L)
    table, tile_m = gf256_torch.kernel_consts(a)
    assert table.shape == (-(-m // tile_m) * tile_m, k, 8) and table.dtype == np.uint32
    assert not table[m:].any()
    assert np.array_equal(_emulate_kernel(table, tile_m, m, d), gf256.matmul(a, d))


def test_tile_choice_matches_the_kernel_instantiations():
    src = (_kernels.CSRC_DIR / "gf256_matmul.cu").read_text()
    cases = {int(c) for c in re.findall(r"case (\d+):", src)}
    assert cases == set(gf256_torch.TILE_M)
    assert gf256_torch.choose_tile_m(42) == 22 and gf256_torch.choose_tile_m(22) == 22
    for m in range(1, 256):
        t = gf256_torch.choose_tile_m(m)
        assert t in gf256_torch.TILE_M and -(-m // t) * t - m < t


def test_batched_strided_out_and_no_launch_on_cpu():
    a = rand((42, 22), 1)
    d = torch.from_numpy(rand((4, 22, 12), 2))
    out = torch.zeros((4, 64, 12), dtype=torch.uint8)
    before = gf256_torch.launches
    gf256_torch.gf_matmul(a, d, out=out[:, 22:])
    assert gf256_torch.launches == before  # the CPU runs the plain version
    for b in range(4):
        assert np.array_equal(out[b, 22:].numpy(), gf256.matmul(a, d[b].numpy()))
    assert not out[:, :22].any()
    plain = gf256_torch.gf_matmul_bits_plain(a, d.transpose(1, 2).contiguous().transpose(1, 2))
    assert torch.equal(plain, out[:, 22:])


def test_wrapper_rejects_what_it_cannot_run():
    a = rand((3, 5), 1)
    with pytest.raises(TypeError):
        gf256_torch.gf_matmul(a, torch.zeros((5, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        gf256_torch.gf_matmul(a, torch.zeros((4, 8), dtype=torch.uint8))
    with pytest.raises(ValueError):
        gf256_torch.gf_matmul(a, torch.zeros((5, 8), dtype=torch.uint8, device="meta"))


def test_kernel_build_is_keyed_by_its_sources_and_flags(monkeypatch):
    path = _kernels.library_path("gf256_matmul")
    assert path.parent == _kernels.BUILD_DIR and path.suffix == ".so"
    assert path == _kernels.library_path("gf256_matmul")
    assert "arch=compute_90a,code=sm_90a" in _kernels.NVCC_FLAGS
    monkeypatch.setattr(_kernels, "NVCC_FLAGS", _kernels.NVCC_FLAGS + ("-lineinfo",))
    assert _kernels.library_path("gf256_matmul") != path

