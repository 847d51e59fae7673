"""The port's kernels on the card: each against its plain PyTorch version.

Every test here needs an NVIDIA card and nvcc, decides so inside the test,
and skips elsewhere.  The file imports only the port (no jax), so it runs
on a host that has a CUDA build of torch and no JAX:

    python -m pytest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from hydrabadger_tpu_torch.crypto import bls12_381 as bls
from hydrabadger_tpu_torch.crypto import gf256
from hydrabadger_tpu_torch.ops import circuit_torch, decrypt_torch, fq_torch, gf256_torch, limbs, rs_torch
from hydrabadger_tpu_torch.ops import bls_g2_torch as g2, fq2_torch
from hydrabadger_tpu_torch.ops import bls_torch, fp_probe_torch
from hydrabadger_tpu_torch.sim import coin, decrypt
from hydrabadger_tpu_torch.sim import tensor as ts

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels have no CPU mode)")
    return torch.device("cuda", 0)


def rand(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("m,k,B,L", [
    (42, 22, 4096, 12), (22, 22, 4096, 12), (3, 5, 3, 1013), (2, 2, 4096, 64),
    (233, 22, 64, 12), (32, 223, 64, 12), (16, 600, 8, 12),  # row chunks, K tiles, K chunks
])
def test_gf_kernel_matches_plain(card, m, k, B, L):
    a = rand((m, k), m)
    d = torch.from_numpy(rand((B, k, L), L)).to(card)
    before = gf256_torch.launches
    got = gf256_torch.gf_matmul(a, d)
    assert gf256_torch.launches == before + len(gf256_torch.chunks(m, k))
    assert torch.equal(got, gf256_torch.gf_matmul_bits_plain(a, d))
    assert np.array_equal(got[0].cpu().numpy(), gf256.matmul(a, d[0].cpu().numpy()))


def _by_path():
    return dict(gf256_torch.launches_by_path)


_BATCH64K_L = 11_637  # rs64-batch64k's shard length: ceil((1,024 * 250 + 4) / 22)


@pytest.mark.parametrize("view,m,k,B,L,path", [
    ("encode", 42, 22, 64, _BATCH64K_L, "rows"),  # batch64k's encode into the parity rows
    ("reconstruct", 22, 22, 64, _BATCH64K_L, "rows"),  # its quorum, 42 * L bytes in
    ("encode", 42, 22, 8, 257, "rows"),
    ("reconstruct", 22, 22, 8, 1013, "rows"),
    ("encode", 42, 22, 8, 4097, "rows"),  # L % 4 == 1
    ("reconstruct", 22, 22, 8, 11_638, "rows"),  # L % 4 == 2
    ("encode", 42, 22, 8, 11_639, "rows"),  # L % 4 == 3
    ("apart", 16, 600, 8, 1013, "rows"),  # three K chunks, XORed into out
    ("encode", 42, 22, 64, 13, "bytes"),  # a ragged row shorter than a tile
])
def test_gf_kernel_on_ragged_rows(card, view, m, k, B, L, path):
    """B1 over shard rows whose length is no multiple of 4, through the
    views the fast-path epoch gives it (the [B, 64, L] codeword's parity
    rows and parity quorum), exact against the plain version, each launch
    on the path the wrapper picks for it."""
    a = rand((m, k), L + m)
    n = 64
    if view == "reconstruct":
        codeword = torch.from_numpy(rand((B, n, L), L)).to(card)
        x, y = codeword[:, n - k:], torch.empty((B, m, L), dtype=torch.uint8, device=card)
    else:
        x = torch.from_numpy(rand((B, k, L), L)).to(card)
        codeword = torch.zeros((B, n, L), dtype=torch.uint8, device=card)
        y = codeword[:, n - m:] if view == "encode" else torch.empty((B, m, L), dtype=torch.uint8,
                                                                   device=card)
    before, paths = gf256_torch.launches, _by_path()
    got = gf256_torch.gf_matmul(a, x, out=y)
    launched = len(gf256_torch.chunks(m, k))
    assert gf256_torch.launches == before + launched
    assert _by_path() == {**paths, path: paths[path] + launched}
    assert torch.equal(got, gf256_torch.gf_matmul_bits_plain(a, x))
    if view == "encode":
        assert not codeword[:, :n - m].any()  # nothing stored outside the view
    for b in (0, B - 1):
        assert np.array_equal(got[b].cpu().numpy(), gf256.matmul(a, x[b].cpu().numpy()))


@pytest.mark.parametrize("shard_len,path", [(_BATCH64K_L, "rows"), (12, "words")])
def test_tensor_sim_epoch_launches_by_path(card, shard_len, path):
    """Two B1 launches an epoch, on the row path at rs64-batch64k's one
    network of 11,637-byte shards and on the word path at 12-byte shards."""
    cfg = ts.TensorSimConfig(n_nodes=64, instances=1 if path == "rows" else 64,
                             shard_len=shard_len)
    sim = ts.TensorSim(cfg, device="cuda")
    paths = _by_path()
    assert sim.run(3)
    assert _by_path() == {**paths, path: paths[path] + 6}
    plain = ts.TensorSim(cfg, device="cuda", use_kernel=False)
    assert plain.run(3) and np.array_equal(sim.state(), plain.state())


def test_rs_batch_on_the_card_matches_the_cpu(card):
    k, p, B, L = 22, 42, 64, 12
    data = torch.from_numpy(rand((B, k, L), 1))
    enc = rs_torch.rs_encode_batch(data.to(card), k, p)
    assert torch.equal(enc.cpu(), rs_torch.rs_encode_batch(data, k, p))
    rows = range(p, k + p)
    rec = rs_torch.rs_reconstruct_batch(enc[:, p:], rows, k, p)
    assert torch.equal(rec.cpu(), data)


def test_tensor_sim_on_the_card_equals_plain_and_cpu(card):
    cfg = ts.TensorSimConfig(n_nodes=64, instances=8, shard_len=12)
    sim = ts.TensorSim(cfg, device="cuda")
    plain = ts.TensorSim(cfg, device="cuda", use_kernel=False)
    before = gf256_torch.launches
    assert sim.run(3) and plain.run(3)
    assert gf256_torch.launches == before + 6
    assert np.array_equal(sim.state(), plain.state())
    cpu = ts.TensorSim(cfg, device="cpu")
    assert cpu.run(3) and np.array_equal(sim.state(), cpu.state())


def test_mesh_round_and_encode_on_a_world_one_nccl_group(card, tmp_path):
    from hydrabadger_tpu_torch.parallel import mesh as pmesh

    k, p, L = 22, 42, 32
    props = torch.from_numpy(rand((k + p, k, L), 5)).to(card)
    data = torch.from_numpy(rand((16, k, L), 6)).to(card)
    with pmesh.process_group(str(tmp_path / "store"), 0, 1, "cuda") as mesh:
        before = gf256_torch.launches
        received, decoded = pmesh.broadcast_round_sharded(props, k, p, mesh)
        encoded = pmesh.instances_sharded_encode(data, k, p, mesh)
        assert gf256_torch.launches == before + 3
        assert pmesh.all_ok(mesh, [True]) and not pmesh.all_ok(mesh, [True, False])
        with pytest.raises(ValueError):
            pmesh.make_mesh(n_devices=2)
    assert torch.equal(decoded, props)
    assert torch.equal(received, rs_torch.rs_encode_batch(props, k, p, use_kernel=False))
    assert torch.equal(encoded, rs_torch.rs_encode_batch(data, k, p, use_kernel=False))


def _points(card, n=301):
    """Two [3, 12, n] point batches on the card with P + P, P + infinity,
    infinity + Q and P + (-P) lanes."""
    rng = np.random.default_rng(n)
    base = limbs.points_to_limbs([bls.multiply(bls.G1, int(k)) for k in rng.integers(1, 2**20, 16)])
    a = torch.from_numpy(np.ascontiguousarray(base[:, :, rng.integers(0, 16, n)])).to(card)
    b = fq_torch.jac_double_plain(a).roll(1, -1).contiguous()
    inf = fq_torch.jac_infinity(1, card)[:, :, 0]
    b[:, :, 0] = a[:, :, 0]
    b[:, :, 1] = inf
    a[:, :, 2] = inf
    b[:, :, 3] = a[:, :, 3]
    b[1, :, 3:4] = fq_torch.fq_sub(torch.zeros_like(a[1, :, 3:4]), a[1, :, 3:4])
    return a, b


@pytest.mark.parametrize("entry", ["mul", "mul_const", "dbl", "add", "ladd", "dblk4", "win6"])
def test_fq_point_kernel_matches_plain(card, entry):
    a, b = _points(card)
    args = {
        "mul": (a[0], b[1]), "mul_const": (a[0], b[1][:, 5:6]), "dbl": (a,), "add": (a, b),
        "ladd": (a, b), "dblk4": (a, 4), "win6": (a, b, a, 6),
    }[entry]
    kernel, plain = fq_torch.ENTRIES[{"mul_const": "mul"}.get(entry, entry.rstrip("46"))]
    before = fq_torch.launches
    got = kernel(*args)
    assert fq_torch.launches == before + 1
    assert torch.equal(got, plain(*args))


@pytest.mark.parametrize("lanes", [515, 32, 1])
@pytest.mark.parametrize("k", [6, 0, 4])
def test_circuit_kernel_matches_plain(card, k, lanes):
    circ = decrypt_torch._dblk_add_circuit(k) if k else decrypt_torch._add_circuit()
    a, b = _points(card, 515)
    x = torch.cat([a, b])[..., :lanes].contiguous()
    before = circuit_torch.launches
    got = circ(x)
    assert circuit_torch.launches == before + 1
    assert torch.equal(got, circ.plain(x))


def test_circuit_kernel_at_extreme_field_values(card):
    """Inputs that put every mix at the top of its range: p - 1, p - 2, 0
    and 1 beside random elements (the circuits are field arithmetic, the
    inputs need not be points)."""
    rng = np.random.default_rng(9)
    vals = [limbs.P - 1, limbs.P - 2, 0, 1]
    vals += [int.from_bytes(rng.bytes(48), "little") % limbs.P for _ in range(28)]
    pick = rng.integers(0, len(vals), (6, 301))
    pick[:, :8] = 0  # every input p - 1
    x = np.stack([limbs.ints_to_limbs_batch([vals[i] for i in row]).T for row in pick])
    x = torch.from_numpy(np.ascontiguousarray(x)).to(card)
    for circ in (decrypt_torch._dblk_add_circuit(6), decrypt_torch._add_circuit(),
                 decrypt_torch._dblk_add_circuit(4)):
        assert torch.equal(circ(x), circ.plain(x))


def _const_circuit(k1, k2):
    from hydrabadger_tpu_torch.ops.fp12_circuit import CircuitBuilder

    b = CircuitBuilder(3)
    i0, i1, i2 = (b.input(i) for i in range(3))
    k1, k2 = b.const(k1), b.const(k2)
    y = (i0 + k1) * (i1 - k2)
    z = y * y - i2 * k1
    w = (z + k2) * (y.dbl() - i0)
    return circuit_torch.CircuitExec(b.compile([w, z - k1, y + w, -k2]), "consts")


def test_circuit_kernel_with_constants_matches_plain(card):
    circ = _const_circuit(7, limbs.P - 5)
    a, b = _points(card, 301)
    assert torch.equal(circ(a), circ.plain(a))
    # two circuits with different constants in one chain
    chain = circuit_torch.CircuitChain(
        [circ, _const_circuit(11, 3)], [(0, 1, 0), (1, 2, 3), (1, 0, 2), (0, 2, 1)], 1, "consts")
    table = torch.stack([a[1:], b[:2], b[1:]], 2)  # [2, 12, 3 entries, 301]
    assert torch.equal(chain(a[:1].contiguous(), table), chain.plain(a[:1], table))


def test_circuit_chain_with_an_entry_wider_than_its_layers(card):
    """A chain of one-product layers over 4-element entries runs 4 warps
    (warp e fetches entry element e) and equals its plain loop."""
    from hydrabadger_tpu_torch.ops.fp12_circuit import CircuitBuilder

    cb = CircuitBuilder(5)
    x = [cb.input(i) for i in range(5)]
    y = ((x[0] * x[1]) * x[2] + x[3]) * x[4]
    narrow = circuit_torch.CircuitExec(cb.compile([y, x[0] - y]), "narrow")
    chain = circuit_torch.CircuitChain([narrow], [(0, 1, 0), (0, 0, 1), (0, 1, 0)], 1, "narrow")
    assert (narrow.slots.warps, chain.warps) == (1, 4)
    a, b = _points(card, 301)
    table = torch.stack([torch.cat([a[1:], b[:2]]), torch.cat([b, a[:1]])], 2)  # [4, 12, 2, 301]
    got = chain(a[:1].contiguous(), table)
    assert torch.equal(got, chain.plain(a[:1], table))
    assert not torch.equal(got, a[:1])


@pytest.mark.parametrize("lanes", [515, 33])
def test_circuit_chain_matches_plain(card, lanes):
    """A chain with entry steps, both output groups and both circuits
    against its plain loop, on ragged lanes."""
    a, b = _points(card, lanes)
    tab = decrypt_torch._build_table(torch.cat([a, b], -1), 16, decrypt_torch._Ops(False))
    tab = tab.reshape(3, 12, 32, lanes)
    rng = np.random.default_rng(4)
    steps = [(None, 3, circuit_torch.SEL)]
    for _ in range(5):
        steps += [(0, int(rng.integers(1, 32)), int(rng.integers(0, 2))),
                  (1, int(rng.integers(1, 32)), 0)]
    steps += [(None, 17, circuit_torch.SEL), (1, 5, 0)]
    chain = circuit_torch.CircuitChain(
        [decrypt_torch._dblk_add_circuit(4), decrypt_torch._add_circuit()], steps, 3, "test")
    acc = fq_torch.jac_infinity(lanes, card)
    acc[:, :, 1] = b[:, :, 1]
    before = circuit_torch.launches
    got = chain(acc, tab)
    assert circuit_torch.launches == before + 1
    assert torch.equal(got, chain.plain(acc, tab))


def test_full_crypto_sim_on_the_card_equals_the_cpu(card):
    cfg = ts.FullCryptoConfig(n_nodes=4, instances=2, seed=1)
    sim = ts.FullCryptoTensorSim(cfg, device="cuda")
    before = (fq_torch.launches, circuit_torch.launches)
    assert sim.run(1)
    counts = sim.epoch.launch_counts()
    assert fq_torch.launches - before[0] == sum(counts["fq_point"].values())
    assert circuit_torch.launches - before[1] == sum(counts["circuit"].values())
    cpu = ts.FullCryptoTensorSim(cfg, device="cpu")
    assert cpu.run(1)
    assert np.array_equal(sim.state(), cpu.state())
    assert sim.oracle_check([0, 7])


@pytest.mark.parametrize("env", [{"HYDRABADGER_DECRYPT_T": "0"},
                                 {"HYDRABADGER_WIN_CIRCUIT": "0"}])
def test_generic_and_win_circuit_0_epochs_on_the_card_equal_the_cpu(card, env, monkeypatch):
    """The generic epoch (B2's glv_ladder, add, mul) and the decrypt
    engine's WIN_CIRCUIT=0 path (win6, dblk4, ladd): launches as the
    engine counts them, no B3 launch, state equal to the CPU's."""
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    cfg = ts.FullCryptoConfig(n_nodes=4, instances=2, seed=1, share_chunks=2)
    sim = ts.FullCryptoTensorSim(cfg, device="cuda")
    before = (fq_torch.launches, circuit_torch.launches)
    assert sim.run(1)
    counts = sim.epoch.launch_counts()
    assert counts["circuit"] == {}
    assert fq_torch.launches - before[0] == sum(counts["fq_point"].values())
    assert circuit_torch.launches == before[1]
    cpu = ts.FullCryptoTensorSim(cfg, device="cpu")
    assert cpu.run(1)
    assert np.array_equal(sim.state(), cpu.state())
    assert sim.oracle_check([0, 7])


def test_afft_on_the_card_equals_the_numpy_twins(card):
    from hydrabadger_tpu_torch.ops import afft_torch, ntt_torch

    for m in range(1, 9):
        c = rand((1 << m, 3, 17), m)
        fwd = afft_torch.afft_fwd(torch.from_numpy(c).to(card), m)
        assert np.array_equal(fwd.cpu().numpy(), ntt_torch.gf_afft(c, m))
        assert np.array_equal(afft_torch.afft_inv(fwd, m).cpu().numpy(), c)


def _g2_points(card, n=301):
    """Two [3, 2, 12, n] G2 batches on the card with infinity + Q,
    P + infinity, P + P and P + (-P) lanes, and digits with 0s."""
    rng = np.random.default_rng(n)
    base = limbs.g2_points_to_limbs([bls.hash_to_g2(b"card-%d" % i) for i in range(4)])
    a = torch.from_numpy(np.ascontiguousarray(base[..., rng.integers(0, 4, n)])).to(card)
    a = fq2_torch.g2_double_plain(a)
    b = fq2_torch.g2_double_plain(a).roll(1, -1).contiguous()
    inf = fq2_torch.g2_infinity(1, card)[..., 0]
    a[..., 0] = inf
    b[..., 1] = inf
    b[..., 2] = a[..., 2]
    b[..., 3] = fq2_torch.g2_neg(a[..., 3:4])[..., 0]
    digits = torch.from_numpy(rng.integers(0, 16, n).astype(np.int32)).to(card)
    digits[:3] = 0
    return a, b, digits


@pytest.mark.parametrize("entry", ["table", "step", "add"])
def test_fq2_point_kernel_matches_plain(card, entry):
    a, b, digits = _g2_points(card)
    args = {"table": (a,), "step": (b, fq2_torch.g2_table_plain(a), digits), "add": (a, b)}[entry]
    kernel, plain = fq2_torch.ENTRIES[entry]
    before = fq2_torch.launches
    got = kernel(*args)
    assert fq2_torch.launches == before + 1
    assert torch.equal(got, plain(*args))


def test_g2_batch_entry_points_on_the_card_equal_the_host(card):
    h = bls.hash_to_g2(b"card")
    pts, ks = [h, bls.double(h), h, bls.G2], [0, 1, bls.R - 1, 0xC0FFEE << 200]
    got = g2.g2_scalar_mul_batch(pts, ks, device="cuda")
    assert all(bls.eq(o, bls.mul_sub(p, k)) for o, p, k in zip(got, pts, ks))
    sums = g2.g2_weighted_sum_batch([pts[:2], pts[2:]], [ks[:2], ks[2:]], device="cuda")
    assert bls.eq(sums[0], bls.double(h))
    assert bls.eq(sums[1], bls.add(bls.neg(h), bls.mul_sub(bls.G2, ks[3])))


def test_coin_round_on_the_card_equals_the_cpu(card):
    cfg = coin.CoinConfig(n_nodes=4, instances=4)
    gpu = coin.CoinRound(cfg, device="cuda", seed=5)
    before = fq2_torch.launches
    _, bits = gpu.run()
    assert gpu.last_launches == {"sign": 1, "combine": 2}  # t + 1 = 2: one tree level
    assert gpu.last_launches == {part: len(rows) for part, rows in gpu.plan().items()}
    assert fq2_torch.launches == before + 3
    cpu = coin.CoinRound(cfg, device="cpu", seed=5)
    _, cpu_bits = cpu.run()
    assert torch.equal(gpu.shares_limbs.cpu(), cpu.shares_limbs)
    assert torch.equal(gpu.signatures_limbs.cpu(), cpu.signatures_limbs)
    assert bits == cpu_bits and gpu.oracle_check([0, 5, 15])


def _fp(card, n, seed):
    """[12, n] canonical Fp elements on the card, with 0, 1 and p - 1 lanes."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(48), "little") % limbs.P for _ in range(n)]
    vals[:3] = [0, 1, limbs.P - 1]
    return torch.from_numpy(limbs.ints_to_limbs_batch(vals).T.copy()).to(card)


@pytest.mark.parametrize("entry", ["mul", "full", "fdigit", "product", "carry", "mul_layer", "noop"])
def test_fp_probe_kernel_matches_plain(card, entry):
    n = 1013
    a, b = _fp(card, n, 1), _fp(card, n, 2)
    before = fp_probe_torch.launches
    if entry == "mul":
        got, want = fp_probe_torch.fp_mul(a, b, 96), fp_probe_torch.fp_mul_plain(a, b)
    elif entry == "mul_layer":
        x = torch.cat([a, b], 1)
        got, want = fp_probe_torch.fp_mul_layer(x, 64), fp_probe_torch.fp_mul_layer_plain(x)
    elif entry == "noop":
        got, want = fp_probe_torch.noop(a, 100), fp_probe_torch.noop_plain(a, 100)
    else:
        got = fp_probe_torch.fp_chain(a, b, entry, 7)
        want = fp_probe_torch.fp_chain_plain(a, b, entry, 7)
    assert fp_probe_torch.launches == before + 1
    assert torch.equal(got, want)


def test_g1_ladders_on_the_card_equal_plain_and_host(card):
    pts = [bls.multiply(bls.G1, k) for k in (3, 5, 7, 11, 13)]
    ks = [0, 1, bls.R - 1, 12345, 0xC0FFEE << 200]  # 12345 < lambda: its k2 is 0
    p, d = bls_torch.scalar_mul_operands(pts, ks, card)
    before = fq_torch.launches
    got = bls_torch.g1_scalar_mul_glv(p, d)
    assert fq_torch.launches == before + len(bls_torch.glv_plan(d.cpu().numpy()))
    assert torch.equal(got, bls_torch.g1_scalar_mul_glv(p, d, use_kernel=False))
    assert all(bls.eq(o, bls.mul_sub(q, k)) for o, q, k in zip(bls_torch.to_host(got), pts, ks))
    cp, cw, s = bls_torch.weighted_sum_operands([pts[:3], pts[2:]], [ks[:3], ks[2:]], card)
    got = bls_torch.g1_weighted_sum_windowed(cp, cw, s)
    assert torch.equal(got, bls_torch.g1_weighted_sum_windowed(cp, cw, s, use_kernel=False))
    want = [bls.add(bls.add(bls.mul_sub(pts[0], 0), pts[1]), bls.mul_sub(pts[2], bls.R - 1)),
            bls.add(bls.add(bls.mul_sub(pts[2], bls.R - 1), bls.mul_sub(pts[3], 12345)),
                    bls.mul_sub(pts[4], ks[4]))]
    assert all(bls.eq(o, w) for o, w in zip(bls_torch.to_host(got), want))


def test_decrypt_round_on_the_card_equals_the_cpu(card):
    cfg = decrypt.DecryptConfig(n_nodes=4)
    gpu = decrypt.DecryptRound(cfg, device="cuda", seed=5)
    plan = gpu.plan()
    assert gpu.run() == gpu.contributions
    assert gpu.last_launches == {part: len(rows) for part, rows in plan.items()}
    cpu = decrypt.DecryptRound(cfg, device="cpu", seed=5)
    cpu.run()
    assert torch.equal(gpu.shares_limbs.cpu(), cpu.shares_limbs)
    assert torch.equal(gpu.combined_limbs.cpu(), cpu.combined_limbs)
    assert gpu.oracle_check([0, 5, 15])


def _ladder_operands(card, entry, n):
    """Points and digits for one ladder entry over n lanes: lanes 0 and
    n // 2 have scalar 0, lane 1 scalar 1, lane 2 scalar r - 1."""
    rng = np.random.default_rng(n)
    ks = [int.from_bytes(rng.bytes(32), "little") % bls.R for _ in range(n)]
    for i, k in ((0, 0), (n // 2, 0), (1, 1), (2, bls.R - 1)):
        if i < n:
            ks[i] = k
    if entry == "ladder":
        h = [bls.hash_to_g2(b"ladder%d" % i) for i in range(4)]
        pts = fq2_torch.g2_table_plain(torch.from_numpy(limbs.g2_points_to_limbs(h)))[1:]
        pool = pts.permute(1, 2, 3, 0, 4).reshape(3, 2, limbs.N_LIMBS, -1)
        digits = g2.scalars_to_windows(ks)
    else:
        base = [bls.multiply(bls.G1, int(k)) for k in rng.integers(2, 2**20, 16)]
        pool = fq_torch.jac_double_plain(torch.from_numpy(limbs.points_to_limbs(base)))
        digits = bls_torch.glv_windows(ks) if entry == "glv_ladder" else g2.scalars_to_windows(ks)
    points = pool[..., rng.integers(0, pool.shape[-1], n)].contiguous()
    return points.to(card), torch.from_numpy(digits).to(card)


@pytest.mark.parametrize("lanes", [1, 33, 1013, 1408])
@pytest.mark.parametrize("entry", ["ladder", "glv_ladder", "windowed_ladder"])
def test_ladder_entries_match_plain(card, entry, lanes):
    points, digits = _ladder_operands(card, entry, lanes)
    module = fq2_torch if entry == "ladder" else fq_torch
    kernel, plain = module.ENTRIES[entry]
    before = module.launches
    got = kernel(points, digits)
    assert module.launches == before + 1
    assert torch.equal(got, plain(points, digits))


@pytest.mark.parametrize("entry", ["g2 add", "g2 step", "g1 add"])
def test_doubling_arm_matches_plain(card, entry):
    """Whole blocks of lanes through the complete add's doubling arm
    (P + P, and a step whose doubled accumulator equals its entry), beside
    lanes that take the general formula and infinity."""
    n = 301
    if entry.startswith("g1"):
        a, _ = _points(card, n)
        b = fq_torch.jac_double_plain(a).roll(1, -1).contiguous()
        b[..., 32:96] = a[..., 32:96]
        got, want = fq_torch.jac_add(a, b), fq_torch.jac_add_plain(a, b)
    else:
        a, b, digits = _g2_points(card, n)
        if entry == "g2 add":
            b[..., 32:96] = a[..., 32:96]
            got, want = fq2_torch.g2_add(a, b), fq2_torch.g2_add_plain(a, b)
        else:
            acc16 = b
            for _ in range(fq2_torch.DOUBLINGS):
                acc16 = fq2_torch.g2_double_plain(acc16)
            base = a.clone()
            base[..., 32:96] = acc16[..., 32:96]  # table[1] == 16 acc
            digits[32:96] = 1
            table = fq2_torch.g2_table_plain(base)
            got = fq2_torch.g2_window_step(b, table, digits)
            want = fq2_torch.g2_window_step_plain(b, table, digits)
    assert torch.equal(got, want)


@pytest.mark.parametrize("cols", [1, 4, 9, 13, 16, 64])
@pytest.mark.parametrize("k", [1, 5, 6, 97, 257, 300])
def test_gf_kernel_at_the_sketch_shapes(card, k, cols):
    """m = 8 rows of a sketch matrix over K shard bytes and 1-64 shard
    columns (config 2's sketches: K = 6, 1 or 9-16 columns), from a contiguous [K, cols] copy (the word path where
    cols % 4 == 0) and from the transposed view of [cols, K] shards (the
    byte path)."""
    from hydrabadger_tpu_torch.crypto import homhash

    mat = homhash.matrix_T(b"sketch-%d" % k, k)
    shards = torch.from_numpy(rand((cols, k), k + cols)).to(card)
    for data in (shards.T.contiguous(), shards.T):
        before = gf256_torch.launches
        got = gf256_torch.gf_matmul(mat, data)
        assert gf256_torch.launches == before + len(gf256_torch.chunks(8, k))
        assert torch.equal(got, gf256_torch.gf_matmul_bits_plain(mat, data))
        assert np.array_equal(got.cpu().numpy().T, homhash.sketch_batch_np(shards.cpu().numpy(), b"sketch-%d" % k))


def test_gf_kernel_with_k_zero_writes_zeros(card):
    out = torch.full((8, 5), 0xAB, dtype=torch.uint8, device=card)
    before = gf256_torch.launches
    got = gf256_torch.gf_matmul(np.zeros((8, 0), np.uint8), torch.zeros((0, 5), dtype=torch.uint8, device=card), out=out)
    assert gf256_torch.launches == before
    assert got.data_ptr() == out.data_ptr() and not bool(out.any())
    assert torch.equal(got, gf256_torch.gf_matmul_bits_plain(np.zeros((8, 0), np.uint8), torch.zeros((0, 5), dtype=torch.uint8, device=card)))


def test_lowcomm_sim_on_the_card_equals_the_cpu(card):
    from hydrabadger_tpu_torch.crypto import engine
    from hydrabadger_tpu_torch.sim import network

    kw = dict(n_nodes=4, epochs=3, seed=0, rbc_variant="lowcomm", native_acs=False)
    host = network.SimNetwork(network.SimConfig(engine="cpu", **kw))
    host.run()
    before = gf256_torch.launches
    gpu = network.SimNetwork(network.SimConfig(engine=engine.GpuEngine(device=card), **kw))
    m = gpu.run()
    assert m.agreement_ok and m.epochs_done == 3
    assert gf256_torch.launches > before
    for nid in gpu.ids:
        assert gpu.batch_bytes(nid) == host.batch_bytes(nid)
    assert gpu.router.delivered == host.router.delivered


def _msm_jobs(b, s, bits, seed, identity=False):
    """b jobs of s distinct G1 points with `bits`-bit scalars; with
    `identity`, infinity points, zero scalars and an empty job among them."""
    rng = np.random.default_rng(seed)
    pool = [bls.mul_sub(bls.G1, int(k) | 1) for k in rng.integers(1, 2**62, 32)]
    jobs = [([pool[(i * s + k) % 32] for k in range(s)],
             [int.from_bytes(rng.bytes(32), "little") % (1 << bits) % bls.R for _ in range(s)])
            for i in range(b)]
    if identity:
        inf = bls.infinity(bls.FQ)
        jobs[0] = ([inf] + jobs[0][0][1:], [5] + jobs[0][1][1:])
        jobs[1] = (jobs[1][0], [0] * s)
        jobs[2] = ([], [])
    return jobs


@pytest.mark.parametrize("b,s,bits", [(15, 6, 64), (225, 5, 64), (15, 6, 255), (1, 6, 64)])
def test_msm_plane_matches_plain_and_host(card, b, s, bits):
    """ops/msm_torch at the 16-node era switch's shapes (t + 1 = 6 terms,
    64-bit RLC scalars; the full-width ack-value checks on the GLV ladder),
    identity lanes included: the kernel against the plain versions, exact,
    and sampled jobs against the host sum."""
    from hydrabadger_tpu_torch.crypto import dkg
    from hydrabadger_tpu_torch.ops import msm_torch

    jobs = _msm_jobs(b, s, bits, b * s + bits, identity=b >= 3)
    pts, digits, b_, s_ = msm_torch.operands(jobs, card)
    before = fq_torch.launches
    got = msm_torch.msm(pts, digits, b_, s_)
    assert fq_torch.launches - before == msm_torch.launches(b_, s_)
    assert torch.equal(got, msm_torch.msm(pts, digits, b_, s_, use_kernel=False))
    host = limbs.limbs_to_points(got.cpu().numpy())
    for i in sorted({0, 1, 2, b - 1} & set(range(b))):
        assert bls.eq(host[i], dkg.g1_msm_or_fallback(*jobs[i]))


@pytest.mark.parametrize("J,M", [(6, 16), (5, 15)])
def test_vandermonde_fold_matches_plain_and_host(card, J, M):
    """ops/vandermonde_torch at (J, K, M, nbits) = (6, 6, 16, 5) and the
    16-node switch's (5, 5, 15, 4), with infinity entries: the kernel
    against the plain versions, exact, and two nodes' folds against the
    host fold."""
    from hydrabadger_tpu_torch.crypto import dkg
    from hydrabadger_tpu_torch.ops import vandermonde_torch as vt

    rng = np.random.default_rng(J * M)
    m = [[bls.mul_sub(bls.G1, int(k) | 1) for k in rng.integers(1, 2**62, J)] for _ in range(J)]
    m[0][0] = m[J - 1][1] = bls.infinity(bls.FQ)
    C = torch.from_numpy(limbs.points_to_limbs([p for row in m for p in row])).to(card)
    C = C.reshape(3, limbs.N_LIMBS, J, J)
    xs = list(range(1, M + 1))
    before = fq_torch.launches
    got = vt.fold_points_batch(C, xs)
    assert fq_torch.launches - before == vt.launches(J, xs)
    assert torch.equal(got, vt.fold_points_batch(C, xs, use_kernel=False))
    host = limbs.limbs_to_points(got.cpu().numpy())
    commit = dkg.BivarCommitment(m)
    for i in (0, M - 1):
        assert all(bls.eq(a, b) for a, b in zip(host[i * J:(i + 1) * J], commit.row_commitment(xs[i])))


def test_dhb_era_switch_on_the_card_equals_the_cpu(card):
    """A 4-node removal era switch with the DKG's device plane forced on
    the card commits the host engine's bytes and launches kernel B2."""
    from hydrabadger_tpu_torch.crypto import dkg, engine
    from hydrabadger_tpu_torch.sim import network

    def run(spec, flag):
        dkg.clear_caches()
        sim = network.SimNetwork(network.SimConfig(n_nodes=4, protocol="dhb", seed=7, engine=spec,
                                                   tpu_dkg=flag, native_acs=False))
        sim.run(1)
        for nid in sim.ids[:-1]:
            sim.router.dispatch_step(nid, sim.nodes[nid].vote_to_remove(sim.ids[-1]))
        for _ in range(8):
            sim.run(1)
            if all(sim.nodes[nid].era > 0 for nid in sim.ids):
                break
        m = sim.run(1)
        return sim, m

    host, hm = run("cpu", False)
    before = fq_torch.launches
    gpu, gm = run(engine.GpuEngine(device=card), True)
    assert fq_torch.launches > before
    assert gm.agreement_ok and (gm.messages_delivered, gm.faults) == (hm.messages_delivered, hm.faults)
    for nid in gpu.ids:
        assert gpu.batch_bytes(nid) == host.batch_bytes(nid)
        assert gpu.nodes[nid].era == host.nodes[nid].era > 0
        assert gpu.nodes[nid].netinfo.pk_set.to_bytes() == host.nodes[nid].netinfo.pk_set.to_bytes()


def test_native_core_era_switch_on_the_card_equals_the_cpu(card):
    """Config 5's leg at 16 nodes on the native ACS core: a removal era
    switch with the DKG's device plane forced on the card commits the host
    engine's batches, eras, key sets, messages and faults, and launches
    kernel B2 and no other kernel."""
    from hydrabadger_tpu_torch.crypto import dkg, engine
    from hydrabadger_tpu_torch.sim import network

    def run(spec, flag):
        dkg.clear_caches()
        sim = network.SimNetwork(network.SimConfig(
            n_nodes=16, protocol="dhb", txns_per_node_per_epoch=4, txn_bytes=2, seed=7,
            engine=spec, tpu_dkg=flag, native_acs=True))
        sim.run(1)
        for nid in sim.ids[:-1]:
            sim.router.dispatch_step(nid, sim.nodes[nid].vote_to_remove(sim.ids[-1]))
        for _ in range(8):
            sim.run(1)
            if all(sim.nodes[nid].era > 0 for nid in sim.ids[:-1]):
                break
        return sim, sim.run(2)

    host, hm = run("cpu", False)
    before = (fq_torch.launches, gf256_torch.launches, circuit_torch.launches, fq2_torch.launches)
    gpu, gm = run(engine.GpuEngine(device=card), True)
    torch.cuda.synchronize()
    assert fq_torch.launches > before[0]
    assert (gf256_torch.launches, circuit_torch.launches, fq2_torch.launches) == before[1:]
    assert gm.agreement_ok and (gm.epochs_done, gm.messages_delivered, gm.faults) == (
        hm.epochs_done, hm.messages_delivered, hm.faults)
    assert [(s, f.node_id, f.kind) for s, f in gpu.router.faults] == [
        (s, f.node_id, f.kind) for s, f in host.router.faults]
    for nid in gpu.ids:
        assert gpu.batch_bytes(nid) == host.batch_bytes(nid)
        assert gpu.nodes[nid].era == host.nodes[nid].era > 0
        assert gpu.nodes[nid].netinfo.pk_set.to_bytes() == host.nodes[nid].netinfo.pk_set.to_bytes()


def test_dhb_era_switch_resumed_on_the_card_equals_the_uninterrupted_run(card, tmp_path):
    """A 4-node removal era switch on the card, snapshotted with save_sim
    while the DKG is live (the caches then cleared, as in a fresh process),
    resumes to the uninterrupted run's bytes and launches kernel B2."""
    from hydrabadger_tpu_torch import checkpoint
    from hydrabadger_tpu_torch.crypto import dkg, engine
    from hydrabadger_tpu_torch.sim import network

    def voted():
        dkg.clear_caches()
        sim = network.SimNetwork(network.SimConfig(n_nodes=4, protocol="dhb", seed=7, tpu_dkg=True,
                                                   native_acs=False,
                                                   engine=engine.GpuEngine(device=card)))
        sim.run(1)
        for nid in sim.ids[:-1]:
            sim.router.dispatch_step(nid, sim.nodes[nid].vote_to_remove(sim.ids[-1]))
        return sim

    straight = voted()
    straight.run(5)
    assert all(straight.nodes[nid].era > 0 for nid in straight.ids)
    sim = voted()
    sim.run(1)
    assert any(d.key_gen is not None for d in sim.nodes.values())
    path = str(tmp_path / "sim.ckpt")
    checkpoint.save_sim(path, sim)
    dkg.clear_caches()
    resumed = checkpoint.load_sim(path)
    before = fq_torch.launches
    m = resumed.run(4)
    assert fq_torch.launches > before and m.agreement_ok
    for nid in straight.ids:
        assert resumed.batch_bytes(nid) == straight.batch_bytes(nid)
        assert resumed.nodes[nid].netinfo.pk_set.to_bytes() == straight.nodes[nid].netinfo.pk_set.to_bytes()


@pytest.mark.parametrize("lanes", [1, 2, 50, 1013])
def test_verify_batch_scalar_muls_on_the_card_equal_the_native_host(card, lanes):
    """The TCP tier's r_i * pk_i terms (GpuEngine._g1_scalar_muls: one B2
    GLV ladder launch) against the native host ladder."""
    from hydrabadger_tpu_torch.crypto import engine, native_bls

    rng = np.random.default_rng(lanes)
    pool = [bls.mul_sub(bls.G1, int(k) | 1) for k in rng.integers(1, 2**62, 64)]
    pts = [pool[i % 64] for i in range(lanes)]
    rs = [int.from_bytes(rng.bytes(16), "little") | 1 for _ in range(lanes)]
    before = fq_torch.launches_by_kind.get("glv_ladder", 0)
    got = engine.GpuEngine(device=card)._g1_scalar_muls(pts, rs)
    assert fq_torch.launches_by_kind.get("glv_ladder", 0) == before + 1
    want = native_bls.g1_mul_batch(pts, rs)
    assert [bls.g1_to_bytes(p) for p in got] == [bls.g1_to_bytes(p) for p in want]


def test_verify_batch_on_the_card_equals_the_host_engine(card):
    from hydrabadger_tpu_torch.crypto import engine
    from hydrabadger_tpu_torch.crypto import threshold as th

    rng = np.random.default_rng(9)
    sks = [th.SecretKey(int.from_bytes(rng.bytes(31), "little") | 1) for _ in range(8)]
    items = [(sk.public_key(), sk.sign(b"frame %d" % i), b"frame %d" % i) for i, sk in enumerate(sks)]
    items[5] = (items[5][0], sks[0].sign(b"frame 5"), b"frame 5")  # forged
    engine._VERIFIED_FRAMES.clear()
    want = engine.CpuEngine().verify_batch(items)
    engine._VERIFIED_FRAMES.clear()
    assert engine.GpuEngine(device=card).verify_batch(items) == want == [i != 5 for i in range(8)]


async def test_lowcomm_tcp_cluster_on_the_card(card):
    """A 4-node fast-tier TCP testnet with the low-comm broadcast on
    GpuEngine: agreed batches, and the shard sketches launched B1."""
    import asyncio

    from hydrabadger_tpu_torch.net.node import Config, Hydrabadger
    from hydrabadger_tpu_torch.utils.ids import InAddr, OutAddr

    base = 15280
    cfg = Config(txn_gen_interval_ms=150, keygen_peer_count=3, encrypt=False, coin_mode="hash",
                 verify_shares=False, wire_sign=False, engine="gpu", rbc_variant="lowcomm")
    before = gf256_torch.launches
    nodes = [Hydrabadger(InAddr("127.0.0.1", base + i), cfg, seed=1000 + i) for i in range(4)]
    gen = lambda count, size: [b"%02dx" % i * size for i in range(count)]  # noqa: E731
    for i, node in enumerate(nodes):
        await node.start([OutAddr("127.0.0.1", base + j) for j in range(i)], gen)

    async def committed():
        while min(len(n.batches) for n in nodes) < 2:
            await asyncio.sleep(0.05)
    try:
        await asyncio.wait_for(committed(), 120)
    finally:
        for n in nodes:
            await n.stop()
    for e in range(2):
        assert len({tuple(sorted(n.batches[e].contributions.items())) for n in nodes}) == 1
    assert gf256_torch.launches > before


@pytest.mark.parametrize("lanes", [1, 33, 1013])
def test_pairing_circuits_on_the_card_equal_plain(card, lanes):
    """Every circuit of the pairing batch, B3 against its plain version on
    random canonical words, one launch each."""
    from hydrabadger_tpu_torch.ops import pairing_torch as pt

    rng = np.random.default_rng(lanes)
    for name, circ in pt.circuits().items():
        ints = [int.from_bytes(rng.bytes(48), "little") % bls.P
                for _ in range(circ.n_inputs * lanes)]
        w = limbs.ints_to_limbs_batch(ints).reshape(circ.n_inputs, lanes, 12).transpose(0, 2, 1)
        x = torch.from_numpy(np.ascontiguousarray(w)).to(card)
        before = circuit_torch.launches_by_circuit.get(name, 0)
        got = circ(x)
        assert circuit_torch.launches_by_circuit[name] == before + 1
        assert torch.equal(got, circ.plain(x)), name


def test_pairing_eq_batch_on_the_card_equals_the_host(card):
    """True, forged and infinity lanes: the host oracle's verdicts, and B3's
    launches by circuit equal to `pairing_torch.schedule`."""
    from hydrabadger_tpu_torch.ops import pairing_torch as pt

    g1, g2 = bls.G1, bls.G2
    lanes = [(bls.multiply(g1, 3), bls.multiply(g2, 11), bls.multiply(g1, 33), g2),
             (bls.multiply(g1, 5), bls.multiply(g2, 13), bls.multiply(g1, 66), g2),
             (bls.infinity(bls.FQ), g2, g1, g2),
             (bls.multiply(g1, 7), g2, g1, bls.multiply(g2, 7))]
    before = dict(circuit_torch.launches_by_circuit)
    got = pt.pairing_eq_batch(*zip(*lanes), device=card)
    torch.cuda.synchronize()
    delta = {k: v - before.get(k, 0) for k, v in circuit_torch.launches_by_circuit.items()
             if v != before.get(k, 0)}
    assert got.tolist() == [bls.pairing_check_eq(*lane) for lane in lanes] == [True, False, False, True]
    assert delta == pt.schedule(3)


def test_attacked_lowcomm_sim_on_the_card_equals_the_cpu(card):
    """config 11's attack at 4 nodes with the low-comm broadcast on
    GpuEngine: the honest batches, injections and faults of the host
    engine's run, the contract held, B1 launched (the forged coding's
    sketches included) and no other kernel."""
    from hydrabadger_tpu_torch.crypto import engine
    from hydrabadger_tpu_torch.sim import network
    from hydrabadger_tpu_torch.sim.scenario import attack_spec

    def run(spec):
        sim = network.SimNetwork(network.SimConfig(
            n_nodes=4, epochs=2, seed=23, encrypt=True, verify_shares=True, coin_mode="threshold",
            rbc_variant="lowcomm", engine=spec, scenario=attack_spec(4, seed=23)))
        return sim, sim.run()

    host, hm = run("cpu")
    before = (gf256_torch.launches, fq_torch.launches, circuit_torch.launches)
    gpu, gm = run(engine.GpuEngine(device=card))
    torch.cuda.synchronize()
    assert gf256_torch.launches > before[0]
    assert (fq_torch.launches, circuit_torch.launches) == before[1:]
    assert gm.agreement_ok and gm.epochs_done == 2
    assert gpu.scenario_log.counts == host.scenario_log.counts
    assert [(s, f.kind) for s, f in gpu.router.faults] == [(s, f.kind) for s, f in host.router.faults]
    for nid in gpu.honest_ids:
        assert gpu.batch_bytes(nid) == host.batch_bytes(nid)
    gpu.verify_scenario()
    gpu.shutdown()


def test_attacked_era_switch_on_the_card_equals_the_cpu(card):
    """The 4-node dhb era switch voting out an equivocating, keygen-
    corrupting, replay-flooding node (seed 9), the DKG's device plane forced
    on the card: the host engine's batches and eras, and B2 launched."""
    from hydrabadger_tpu_torch.crypto import dkg, engine
    from hydrabadger_tpu_torch.sim import network
    from hydrabadger_tpu_torch.sim.scenario import ScenarioSpec

    def run(spec, flag):
        dkg.clear_caches()
        scen = ScenarioSpec(name="era", seed=9,
                            byzantine=((3, ("equivocate", "dkg_corrupt", "replay_flood")),))
        sim = network.SimNetwork(network.SimConfig(n_nodes=4, protocol="dhb", epochs=4, seed=9,
                                                   engine=spec, tpu_dkg=flag, scenario=scen))
        for nid in sim.honest_ids:
            sim.router.dispatch_step(nid, sim.nodes[nid].vote_to_remove(sim.ids[3]))
        return sim, sim.run()

    host, hm = run("cpu", False)
    before = fq_torch.launches
    gpu, gm = run(engine.GpuEngine(device=card), True)
    torch.cuda.synchronize()
    assert fq_torch.launches > before
    assert gm.agreement_ok and gm.epochs_done == hm.epochs_done == 4
    for nid in gpu.honest_ids:
        assert gpu.batch_bytes(nid) == host.batch_bytes(nid)
        assert gpu.nodes[nid].era == host.nodes[nid].era > 0
    gpu.verify_scenario()
    gpu.shutdown()


async def test_chaos_cluster_on_the_card(card):
    """config 12's harness at the fast tier on GpuEngine with the low-comm
    broadcast: link faults, a replay-flooding peer and a crash/restart, the
    contract held inside the harness, and B1 launched."""
    import os

    from hydrabadger_tpu_torch.net import chaos

    before = gf256_torch.launches
    os.environ["HYDRABADGER_RBC"] = "lowcomm"
    try:
        row = await chaos.chaos_cluster(
            n=4, f_byz=1, epochs=4, base_port=15270, encrypt=False, verify_shares=False,
            coin_mode="hash", wire_sign=False, strategies=("replay_flood",), crash=True,
            crash_down_s=1.5, deadline_s=240, engine="gpu", device=str(card))
    finally:
        os.environ.pop("HYDRABADGER_RBC", None)
    assert row["agreement_ok"] and row["contract_ok"] and row["epochs"] >= 4
    assert row["recovery_catchup_s"] is not None
    assert gf256_torch.launches > before


def test_process_cluster_on_the_card(card, tmp_path):
    """config 13's harness: four `python -m hydrabadger_tpu_torch --engine gpu`
    processes at full crypto, node 1 SIGKILLed and restarted from its store;
    agreement and the process-tier contract held inside the harness, and
    every node's incarnations (the restarted one included) ran wire-signature
    batches on kernel B2, read from the children's feeds."""
    from hydrabadger_tpu_torch.net import cluster

    row = cluster.run_process_chaos(n=4, epochs=2, base_port=15850, workdir=str(tmp_path),
                                    fast_crypto=False, deadline_s=300.0, engine="gpu",
                                    device=str(card) if card.index else "cuda")
    assert row["agreement_ok"] and row["contract_ok"] and row["epochs"] >= 2
    assert row["recovery_catchup_s"] is not None
    killed = set(row["killed_pids"]["1"])
    for node, incarnations in row["device_work"].items():
        assert sum(inc["verify_batches"] for inc in incarnations) > 0, node
        assert sum(inc["launches"]["fq_point"] for inc in incarnations) > 0, node
    restarted = [inc for inc in row["device_work"]["1"] if inc["pid"] not in killed]
    assert restarted and restarted[0]["verify_batches"] > 0
    assert restarted[0]["launches"]["fq_point"] >= restarted[0]["verify_batches"]
