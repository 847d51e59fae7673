"""The port's GF(2^8) layer (hydrabadger_tpu_torch) against the JAX package.

Every comparison is exact byte equality.  On the CPU, `gf_matmul` runs the
kernel's plain version; the kernel itself is held against it on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""
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


# The PTX ISA's fragment layouts of mma.sync.m16n8k32 .s8 for lane 4g + t
# (wgmma m64nNk32 .s8 gives each warp of its warpgroup the same A and D
# fragments for its 16 rows, D repeating per 8 columns):
# A (16 x 32, row): reg r, byte b -> row g + 8 (r % 2), K 16 (r // 2) + 4t + b;
# B (32 x 8, col): byte u -> K 4t + u (u < 4) or 16 + 4t + u - 4, column g;
# D (16 x 8, s32): reg r -> row g + 8 (r // 2), column 2t + r % 2.
_ROW, _KK = np.meshgrid(np.arange(16), np.arange(32), indexing="ij")
_A_LANE, _A_REG, _A_BYTE = 4 * (_ROW % 8) + (_KK % 16) // 4, _ROW // 8 + 2 * (_KK // 16), _KK % 4
_KB, _NB = np.meshgrid(np.arange(32), np.arange(8), indexing="ij")
_B_LANE, _B_BYTE = 4 * _NB + (_KB % 16) // 4, _KB % 4 + 4 * (_KB // 16)
_LANE, _REG = np.meshgrid(np.arange(32), np.arange(4), indexing="ij")
_D_ROW, _D_COL = _LANE // 4 + 8 * (_REG // 2), 2 * (_LANE % 4) + _REG % 2
_LBO, _SBO = 128, 256  # csrc/gf256_matmul.cu's b_desc


def _b_tiles(bop, form):
    """[nt, kt, K, n] B tiles as the kernel reads them from the operand:
    form 0 through each lane's two 4-byte fragment loads, forms 1 and 2
    through wgmma's descriptor of each pass's instruction (N = 32 or 64
    columns from N tile 4 G0, core matrices LBO = 128 and SBO = 256 apart)."""
    kt_n, nt_n = bop.shape[:2]
    flat = bop.reshape(-1).view(np.int8).astype(np.int64)
    if form == 0:
        nt, kt, lane, u = np.ix_(np.arange(nt_n), np.arange(kt_n), np.arange(32), np.arange(8))
        frag = flat[(kt * nt_n + nt) * 256 + 128 * (u // 4) + 16 * (lane // 4)
                    + 4 * (lane % 4) + u % 4]
        return frag[:, :, _B_LANE, _B_BYTE]
    tiles = np.zeros((nt_n, kt_n, 32, 8), dtype=np.int64)
    step = form  # groups of 4 output bytes per pass
    kk, nf = np.meshgrid(np.arange(32), np.arange(32 * step), indexing="ij")
    for kt in range(kt_n):
        for g0 in range(0, nt_n // 4, step):
            cols = 32 * min(step, nt_n // 4 - g0)
            n_, k_ = nf[:, :cols], kk[:, :cols]
            start = (kt * nt_n + 4 * g0) * 256
            b = flat[start + _SBO * (n_ // 8) + _LBO * (k_ // 16) + 16 * (n_ % 8) + k_ % 16]
            for c in range(cols // 8):
                tiles[4 * g0 + c, kt] = b[:, 8 * c:8 * c + 8]
    return tiles


def _replay_launch(bop, data, m, form, mt):
    """numpy replay of one launch of csrc/gf256_matmul.cu over [k, L] data,
    warp by warp: each lane's A fragments expanded from the bytes of its
    2*mt consecutive columns, the products over the host-built B operand
    read as the form reads it (K tiles summed in int32), and each lane's
    epilogue."""
    k, L = data.shape
    kt, nt = bop.shape[:2]
    cols = 16 * mt  # one warp's columns
    warps = -(-L // cols)
    tile = np.zeros((4 * kt, warps * cols), dtype=np.uint8)
    tile[:k, :L] = data
    # a[w, mt_, kt, lane, reg, byte]: data byte 4kt + 2(reg // 2) + t // 2 of
    # column 2*mt*g + 2*mt_ + reg % 2, bit 4(t % 2) + byte
    w_, m_, k_, ln, reg, byte = np.ix_(np.arange(warps), np.arange(mt), np.arange(kt),
                                       np.arange(32), np.arange(4), np.arange(4))
    col = w_ * cols + 2 * mt * (ln // 4) + 2 * m_ + reg % 2
    j = 4 * k_ + 2 * (reg // 2) + (ln % 4) // 2
    bit = 4 * (ln % 2) + byte
    a = ((tile[j, col] >> bit) & 1).astype(np.int64)
    a_mat = a[..., _A_LANE, _A_REG, _A_BYTE]  # [w, mt, kt, 16, 32]
    d = np.einsum("wmkrK,nkKc->wmnrc", a_mat, _b_tiles(bop, form))  # K tiles summed
    assert np.abs(d).max() < 2**31  # the kernel's int32 sums
    acc = d[..., _D_ROW, _D_COL].astype(np.int32)  # [w, mt, nt, lane, reg]
    out = np.zeros((nt, warps * cols), dtype=np.uint8)
    g, t = np.arange(32) // 4, np.arange(32) % 4
    for grp in range(nt // 4):
        for m_i in range(mt):
            for h in range(2):
                r = np.zeros((warps, 32), dtype=np.int32)
                for q in range(4):
                    for e in range(2):
                        r |= acc[:, m_i, 4 * grp + q, :, 2 * h + e] & (1 << (2 * q + e))
                c = np.arange(warps)[:, None] * cols + 2 * mt * g + 2 * m_i + h
                out[4 * grp + t, c] = r
    return out[:m, :L]


@pytest.mark.parametrize("m,k", [
    (42, 22), (22, 22),  # the epoch's encode and reconstruct
    (3, 5),  # 8k = 40, not a multiple of 32
    (1, 9),  # one output row
    (127, 128),  # m + k = 255
    (32, 223),  # many K tiles: A fragments re-expanded per chunk of 6
    (233, 22),  # several launches over row chunks
    (16, 600),  # K past K_CHUNK_MAX: launches XOR into the output
])
@pytest.mark.parametrize("form,mt", [(0, 4), (1, 4), (2, 2)])
def test_warp_replay_of_the_kernel_equals_the_gf_product(m, k, form, mt):
    a, d = rand((m, k), 11 + m), rand((k, 37), 12 + k)
    out = np.zeros((m, 37), dtype=np.uint8)
    for c in gf256_torch.chunks(m, k):
        mc, kc = c.m1 - c.m0, c.k1 - c.k0
        bop = gf256_torch.b_operand(a[c.m0:c.m1, c.k0:c.k1])
        assert bop.shape == (-(-kc // 4), -(-mc // 4) * 4, 2, 8, 16)
        out[c.m0:c.m1] ^= _replay_launch(bop, d[c.k0:c.k1], mc, form, mt)
    assert np.array_equal(out, gf256.matmul(a, d))


def test_every_rs_shape_fits_one_block():
    """Every [m, k] with m + k <= 255, and a long sketch K, launches in
    chunks whose operand and data ring fit one block's shared memory."""
    worst = 0
    for m in range(1, 255):
        for k in range(1, 256 - m):
            cs = gf256_torch.chunks(m, k)
            assert len({c.k0 for c in cs}) == 1  # no K split for an RS shape
            assert [(c.m0, c.m1) for c in cs] == sorted((c.m0, c.m1) for c in cs)
            assert cs[0].m0 == 0 and cs[-1].m1 == m
            for c in cs:
                shape = gf256_torch.launch_shape(c.m1 - c.m0, c.k1 - c.k0)
                assert 2 <= shape.stages <= gf256_torch.STAGES
                worst = max(worst, shape.smem)
    assert worst <= gf256_torch.SMEM_MAX
    enc = gf256_torch.launch_shape(42, 22)
    assert enc.stages == gf256_torch.STAGES and 64 * 44 * 24 < enc.smem < 2 * 64 * 44 * 24
    for c in gf256_torch.chunks(32, 4096):
        assert gf256_torch.launch_shape(c.m1 - c.m0, c.k1 - c.k0).smem <= gf256_torch.SMEM_MAX
    with pytest.raises(ValueError):
        gf256_torch.launch_shape(4, 256, form=0, warps=8, m_tiles=4, stages=2)
    with pytest.raises(ValueError):
        gf256_torch.launch_shape(42, 22, form=2, warps=6)  # not whole warpgroups


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

