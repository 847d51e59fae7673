"""The port's kernels on the card: each against its plain PyTorch version.

Every test here needs an NVIDIA card and nvcc, decides so inside the test,
and skips elsewhere.  The file imports only the port (no jax), so it runs
on a host that has a CUDA build of torch and no JAX:

    python -m pytest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from hydrabadger_tpu_torch.crypto import gf256
from hydrabadger_tpu_torch.ops import gf256_torch, rs_torch
from hydrabadger_tpu_torch.sim import tensor as ts

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels have no CPU mode)")
    return torch.device("cuda", 0)


def rand(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("m,k,B,L", [(42, 22, 4096, 12), (22, 22, 4096, 12), (3, 5, 3, 1013)])
def test_gf_kernel_matches_plain(card, m, k, B, L):
    a = rand((m, k), m)
    d = torch.from_numpy(rand((B, k, L), L)).to(card)
    before = gf256_torch.launches
    got = gf256_torch.gf_matmul(a, d)
    assert gf256_torch.launches == before + 1
    assert torch.equal(got, gf256_torch.gf_matmul_bits_plain(a, d))
    assert np.array_equal(got[0].cpu().numpy(), gf256.matmul(a, d[0].cpu().numpy()))


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
