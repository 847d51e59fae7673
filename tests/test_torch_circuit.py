"""The port's circuit recorder and B3 plain executor against the JAX
package: the three decrypt circuits record the same matrices as
ops/fp12_circuit, and ops/circuit_torch's plain executor equals
circuit_T.CircuitT limb for limb at B = 4, plus the round-3 signed-mix
regression vector of tests/test_circuit_T.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hydrabadger_tpu.ops import decrypt_T as jdt
from hydrabadger_tpu_torch.crypto import bls12_381 as bls
from hydrabadger_tpu_torch.ops import decrypt_torch as dt
from hydrabadger_tpu_torch.ops import fq_torch as fq
from hydrabadger_tpu_torch.ops import limbs
from hydrabadger_tpu_torch.ops.circuit_torch import CircuitExec
from hydrabadger_tpu_torch.ops.fp12_circuit import CircuitBuilder

P = bls.P

CIRCUITS = {
    "dblk6_add": (lambda: dt._dblk_add_circuit(6), lambda: jdt._dblk_add_circuit(6)),
    "add": (dt._add_circuit, jdt._add_circuit),
    "dblk4_add": (lambda: dt._dblk_add_circuit(4), lambda: jdt._dblk_add_circuit(4)),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_recorder_copy_gives_the_same_matrices(name):
    mine, theirs = (f().circ for f in CIRCUITS[name])
    assert mine.n_inputs == theirs.n_inputs and mine.n_outputs == theirs.n_outputs
    assert mine.n_lanes == theirs.n_lanes
    assert len(mine.mats) == len(theirs.mats)
    for (ml, mr), (tl, tr) in zip(mine.mats, theirs.mats):
        assert np.array_equal(ml, tl) and np.array_equal(mr, tr)
    assert np.array_equal(mine.T, theirs.T)
    assert mine.const_vals.shape[0] == theirs.const_vals.shape[0] == 0


def _inputs(b=4):
    """[6, 12, b]: two non-normalised point batches, lane 1 equal points."""
    a = [bls.multiply(bls.G1, k) for k in range(31, 31 + b)]
    c = [bls.multiply(bls.G1, k) for k in range(71, 71 + b)]
    c[1] = a[1]
    x = torch.from_numpy(np.concatenate([limbs.points_to_limbs(a), limbs.points_to_limbs(c)]))
    return torch.cat([fq.jac_double_plain(x[:3]), fq.jac_double_plain(x[3:])])


@pytest.mark.parametrize("name", ["add", "dblk4_add"])
def test_plain_executor_equals_circuit_T(name):
    mine, theirs = (f() for f in CIRCUITS[name])
    x = _inputs()
    got = mine(x)  # a CPU tensor: the plain executor
    b = x.shape[-1]
    xj = limbs.jax_limbs_from_words(x.numpy().transpose(0, 2, 1))  # [6, b, 32]
    xj = np.ascontiguousarray(xj.transpose(0, 2, 1).reshape(6 * 32, b))
    want = np.asarray(theirs(jnp.asarray(xj))).reshape(mine.n_outputs, 32, b)
    want = limbs.words_from_jax_limbs(want.transpose(0, 2, 1)).transpose(0, 2, 1)
    assert np.array_equal(got.numpy(), want)


def test_signed_mix_regression_vector():
    """tests/test_circuit_T.py's crafted -1-deficit vector, through the
    port's mix (one output row [1, -3], no layers), and a row mix with a
    constant, a negative select and a zero row."""
    mask = 4095
    kp = [(4 * P >> (12 * i)) & mask for i in range(35)]
    t = np.zeros(32, np.int64)
    t[2] = -4096 - kp[2]
    t[3], t[4], t[5] = -kp[3], -kp[4], -kp[5]
    x0 = np.zeros(32, np.int64)
    x1 = np.zeros(32, np.int64)
    for j in range(32):
        tj = int(t[j])
        x0[j] = (3 - (-tj) % 3) % 3
        x1[j] = (x0[j] - tj) // 3
    v0 = sum(int(x0[i]) << (12 * i) for i in range(32))
    v1 = sum(int(x1[i]) << (12 * i) for i in range(32))
    b = CircuitBuilder(2)
    i0, i1 = b.input(0), b.input(1)
    k = b.const(12345)
    circ = CircuitExec(b.compile([i0 - i1 - i1 - i1, -i1, i0 * k - i1 * i1, b.zero()]), "mix")
    assert np.array_equal(circ.circ.T[0, :2], [1, -3])
    x = torch.from_numpy(limbs.ints_to_limbs_batch([v0, v1]))[:, :, None]
    got = limbs.limbs_to_ints_batch(circ(x)[:, :, 0].numpy())
    rinv = pow(limbs.R_MONT, -1, P)
    assert got == [(v0 - 3 * v1) % P, (-v1) % P, (v0 * 12345 - v1 * v1) * rinv % P, 0]
