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


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm over uint32 arrays: byte n of the result is byte
    (sel >> 4n) & 7 of the 8 bytes y:x."""
    z = np.asarray(x, np.uint64) | (np.asarray(y, np.uint64) << np.uint64(32))
    sel = np.asarray(sel, np.uint64)
    r = np.zeros(np.broadcast(z, sel).shape, np.uint64)
    for n in range(4):
        nib = (sel >> np.uint64(4 * n)) & np.uint64(7)
        r |= ((z >> (np.uint64(8) * nib)) & np.uint64(0xFF)) << np.uint64(8 * n)
    return r.astype(np.uint32)


def _words(b):
    """[..., 4n] uint8 -> [..., n] little-endian uint32."""
    return np.ascontiguousarray(b).view("<u4")


def _replay_rows(mat, mem, d_off, d_strides, omem, o_off, o_strides, B, L, warps=4, mt=4,
                 accumulate=False, seed=0):
    """numpy replay of one row-path launch of csrc/gf256_matmul.cu (LAYOUT
    ROWS) over byte arrays that stand for device memory (index = address, 0
    aligned): the tiles of C columns of one shard row, each data row's run
    fetched as the aligned 16-byte words that cover it (zeros for words past
    it) into a stage whose other bytes hold garbage, each lane's 2*mt bytes
    realigned from the 4-byte words around them, the product staged as the
    tile's output rows, and `store_rows`: each output row's aligned 16-byte
    words shifted out of the stage, stored whole inside the run, else by
    4-byte parts, whole or masked.  Writes `omem` in place; returns how often
    each of its bytes was stored."""
    m, k = mat.shape
    sb, sk, _ = d_strides
    ob, om, _ = o_strides
    C, W, row, kp = 16 * warps * mt, 2 * mt, 16 * mt * (warps + 1), -(-k // 4) * 4
    tpr = -(-L // C)
    tile = np.arange(B * tpr)
    b, l0 = tile // tpr, tile % tpr * C
    n = np.minimum(C, L - l0)
    j = np.arange(k)
    # -- load: [T, k, C / 16 + 1] words of 16 bytes
    run = d_off + b[:, None] * sb + j * sk + l0[:, None]
    a0 = run & ~15
    word = a0[..., None] + 16 * np.arange(C // 16 + 1)
    ok = word < (run + n[:, None])[..., None]
    assert ((word + 16 > run[..., None]) | ~ok).all()  # a word read holds a byte of the run
    rng = np.random.default_rng(seed)
    stage = rng.integers(0, 256, (len(tile), kp, row), dtype=np.uint8)  # stale bytes
    stage[:, k:] = 0
    got = np.where(ok[..., None], mem[np.where(ok, word, 0)[..., None] + np.arange(16)], 0)
    stage[:, :k, :C + 16] = got.reshape(len(tile), k, C + 16)
    # -- expand: lane (warp, g) reads row j's bytes at wcol + the row's shift
    wcol = (16 * mt * np.arange(warps)[:, None] + W * np.arange(8)).reshape(-1)  # [lanes]
    shift = (d_off + b[:, None] * sb + j * sk) & 15  # [T, k]: l0 is a multiple of 16
    o = wcol + shift[..., None]  # [T, k, lanes]
    x = _words(stage[np.arange(len(tile))[:, None, None, None], j[None, :, None, None],
                     (o & ~3)[..., None] + np.arange(4 * (mt // 2 + 1))])
    sel = 0x3210 + 0x1111 * (o & 3)
    lane_bytes = np.stack([_byte_perm(x[..., u], x[..., u + 1], sel) for u in range(mt // 2)], -1)
    data = np.zeros((len(tile), k, C), np.uint8)
    data[..., wcol[:, None] + np.arange(W)] = lane_bytes.view(np.uint8).reshape(*o.shape, W)
    col = np.arange(C)
    live = col < n[:, None]
    want = np.where(live[:, None], mem[np.where(live[:, None], run[..., None] + col, 0)], 0)
    assert np.array_equal(np.where(live[:, None], data, 0), want)
    # -- the product of every tile's columns, staged as m rows of C + ROW_PAD
    # bytes behind 64 stale bytes (the ring's end, read before row 0)
    prod = gf256.matmul(mat, data.transpose(1, 0, 2).reshape(k, -1))
    prod = prod.reshape(m, len(tile), C).transpose(1, 0, 2)  # [T, m, C]
    orow, lead = C + gf256_torch.ROW_PAD, 64
    staged = rng.integers(0, 256, (len(tile), lead + m * orow), dtype=np.uint8)
    staged[:, lead:].reshape(len(tile), m, orow)[..., :C] = prod
    # -- store_rows: word w of output row i holds run bytes lo .. lo + 15
    p = o_off + (b * ob + l0)[:, None] + om * np.arange(m)  # [T, m]
    lo = 16 * np.arange(C // 16 + 1) - (p & 15)[..., None]  # [T, m, words]
    at = lead + orow * np.arange(m)[:, None] + (lo & ~3)
    x = _words(staged[np.arange(len(tile))[:, None, None, None], at[..., None] + np.arange(20)])
    v = np.stack([_byte_perm(x[..., q], x[..., q + 1], 0x3210 + 0x1111 * (lo & 3))
                  for q in range(4)], -1)  # [T, m, words, 4]
    nn = n[:, None, None, None]
    e = np.arange(16)
    a = lo[..., None] + 4 * (e // 4)  # the run offset of each byte's 4-byte part
    whole = ((lo >= 0) & (lo + 16 <= n[:, None, None]))[..., None]
    part_whole = (a >= 0) & (a + 4 <= nn)
    part_skip = (a + 4 <= 0) | (a >= nn)
    inside = (lo[..., None] + e >= 0) & (lo[..., None] + e < nn)
    stored = (lo < n[:, None, None])[..., None] & (
        whole | (~part_skip & (part_whole | inside)))
    addr = (p[..., None] + lo)[..., None] + e
    byte = v.view(np.uint8).reshape(*lo.shape, 16)
    writes = np.zeros(omem.shape, np.int64)
    np.add.at(writes, addr[stored], 1)
    omem[addr[stored]] = byte[stored] ^ omem[addr[stored]] if accumulate else byte[stored]
    return writes


_BATCH64K_L = 11_637  # ceil((1,024 * 250 + 4) / 22): rs64-batch64k's shard length


_TILES = (gf256_torch.WARPS, gf256_torch.M_TILES)  # the wrapper's geometry, both paths
_OTHER = (8, 2)  # 8 warps x 2 M tiles: the same 256 columns a tile, in other lanes


@pytest.mark.parametrize("view,L,tiles", [
    ("encode", _BATCH64K_L, _TILES), ("reconstruct", _BATCH64K_L, _TILES),  # batch64k
    ("encode", 257, _TILES), ("reconstruct", 1013, _TILES),  # L % 4 == 1
    ("encode", 4097, _OTHER),
    ("reconstruct", 11_638, _TILES), ("encode", 11_639, _TILES),  # L % 4 == 2, 3
    ("accumulate", 1013, _TILES),  # a K chunk XORed into out
    ("encode", 1041, _OTHER), ("encode", 1033, _TILES),  # short last tiles
    ("odd", 1042, _OTHER), ("odd", 1034, _TILES),  # the output one byte into its buffer
])
def test_row_path_replay_equals_the_gf_product(view, L, tiles):
    """The row path's addressing over the codeword's views, as the fast-path
    epoch launches it (sim/tensor.epoch): the encode from [B, k, L] into
    rows k.. of the [B, n, L] codeword, the reconstruct from the parity
    quorum that starts p*L bytes into each codeword row."""
    k, p, B = 22, 42, 3
    n = k + p
    mat = rand((p, k) if view == "encode" else (k, k), L)
    pad = 64  # the allocation's end, rounded up to whole 16-byte words
    codeword = np.zeros(B * n * L + pad, np.uint8)
    codeword[:B * n * L] = rand(B * n * L, L + 1)
    plain = np.zeros(B * k * L + pad, np.uint8)
    plain[:B * k * L] = rand(B * k * L, L + 2)
    cw_strides, plain_strides = (n * L, L, 1), (k * L, L, 1)
    if view == "reconstruct":
        args = (codeword, p * L, cw_strides, plain, 0, plain_strides)
    else:
        args = (plain, 0, plain_strides, codeword, k * L + (view == "odd"), cw_strides)
    mem, d_off, d_str, omem, o_off, o_str = args
    before = omem.copy()
    m = mat.shape[0]
    warps, mt = tiles
    assert gf256_torch.launch_path(L, d_off, d_str, o_off, o_str, 16 * warps * mt) == "rows"
    writes = _replay_rows(mat, mem, d_off, d_str, omem, o_off, o_str, B, L, warps, mt,
                          accumulate=view == "accumulate")
    view_of = lambda buf, off, st, rows: np.lib.stride_tricks.as_strided(
        buf[off:], (B, rows, L), st)
    inside = np.zeros(omem.shape, bool)
    view_of(inside, o_off, o_str, m)[...] = True
    assert (writes[inside] == 1).all() and (writes[~inside] == 0).all()
    assert np.array_equal(omem[~inside], before[~inside])
    x, y = view_of(mem, d_off, d_str, k), view_of(omem, o_off, o_str, m)
    for bb in range(B):
        want = gf256.matmul(mat, x[bb])
        if view == "accumulate":
            want ^= view_of(before, o_off, o_str, m)[bb]
        assert np.array_equal(y[bb], want)


@pytest.mark.parametrize("shape,L,want", [
    ("inst1024", 12, "words"),  # 1,024 networks x 264 B a node
    ("batch64k", _BATCH64K_L, "rows"),  # one network, 65,536 txns of 250 B
    ("short", 13, "bytes"),  # a ragged row shorter than a tile
    ("under_a_third", 85, "bytes"),  # the threshold: a third of a 256-column tile
    ("a_third", 86, "rows"),
])
def test_launch_path_of_the_epoch_views(shape, L, want):
    """The wrapper's choice for the fast-path epoch's two launches, from the
    pointers and strides `_launch` passes: the encode from the proposals
    into the codeword's parity rows, the reconstruct from the quorum view."""
    k, p, B = 22, 42, 2
    n = k + p
    proposals = torch.zeros((B, k, L), dtype=torch.uint8)
    codeword = torch.zeros((B, n, L), dtype=torch.uint8)
    tile = 16 * gf256_torch.WARPS * gf256_torch.M_TILES
    quorum = codeword.view(B, 1, n, L).transpose(1, 2)[:, p:n].transpose(1, 2).reshape(B, k, L)
    assert quorum.data_ptr() == codeword.data_ptr() + p * L
    for x, y in ((proposals, codeword[:, k:]), (quorum, torch.empty_like(proposals))):
        got = gf256_torch.launch_path(L, x.data_ptr(), x.stride(), y.data_ptr(), y.stride(), tile)
        assert got == want
    # transposed views (a sketch's shards) and unit strides always allow bytes
    t = torch.zeros((L, k), dtype=torch.uint8).T
    assert gf256_torch.launch_path(L, t.data_ptr(), (0, *t.stride()), 0, (0, L, 1), tile) == "bytes"


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
                rows = gf256_torch.launch_shape(c.m1 - c.m0, c.k1 - c.k0, rows=True)
                assert 2 <= rows.stages <= gf256_torch.STAGES
                assert rows.row >= 16 * rows.warps * rows.m_tiles + 16  # a shifted run's words
                worst = max(worst, shape.smem, rows.smem)
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

