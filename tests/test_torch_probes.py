"""The Fp probes' plain versions against the JAX bodies the Pallas prototypes
E1-E4 ran: ops/fp_probe_torch on the CPU (the kernel csrc/fp_probe.cu is
held against these on the card by chip_smoke and tests/test_torch_cuda.py)
against hydrabadger_tpu/ops/fq_T's `_mul_rows`, `_carry_ks_rows` and
`_mul_rows_lazy` jitted at 64 lanes, Python integers and numpy.  Operands
are canonical Fp elements (below p) from a numpy seed; every comparison is
exact, limb for limb after regrouping 12-bit limbs into 32-bit words."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hydrabadger_tpu.ops import fq_T
from hydrabadger_tpu_torch.ops import fp_probe_torch as fp
from hydrabadger_tpu_torch.ops import limbs

LANES = 64
P, R = limbs.P, limbs.R_MONT


@pytest.fixture(scope="module")
def operands():
    """Two [12, 64] canonical operand batches with 0, 1 and p - 1 lanes, and
    the same values as Python ints."""
    rng = np.random.default_rng(4)
    a = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(LANES)]
    b = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(LANES)]
    a[:3], b[:3] = [0, 1, P - 1], [P - 1, P - 1, P - 1]
    words = [torch.from_numpy(limbs.ints_to_limbs_batch(v).T.copy()) for v in (a, b)]
    return words[0], words[1], a, b


def _jax(words: torch.Tensor) -> jnp.ndarray:
    """Port [12, n] words -> fq_T's [32, n] 12-bit limbs (the same bits)."""
    return jnp.asarray(limbs.jax_limbs_from_words(words.numpy().T).T)


def _words(rows) -> torch.Tensor:
    """fq_T's [32, n] limbs -> port [12, n] words."""
    return torch.from_numpy(limbs.words_from_jax_limbs(np.asarray(rows).T).T.copy())


def _ints(words: torch.Tensor) -> list:
    return limbs.limbs_to_ints_batch(words.numpy().T)


@pytest.fixture(scope="module")
def jax_mul():
    return jax.jit(lambda x, y: fq_T._mul_rows(x, y, fq_T._const_args()))


def test_e1_mul_equals_fq_T_mul_rows(operands, jax_mul):
    a, b, ai, bi = operands
    got = fp.fp_mul(a, b, threads=256)
    assert torch.equal(got, _words(jax_mul(_jax(a), _jax(b))))
    assert _ints(got) == [x * y * limbs.R_INV % P for x, y in zip(ai, bi)]


@pytest.mark.parametrize("body", ["full", "fdigit"])
def test_e2_product_bodies_equal_chained_mul_rows(operands, jax_mul, body):
    """`full` and `fdigit` (the FP64-schoolbook form on the card) have one
    plain version: the chained Montgomery product, as _mul_rows chains."""
    a, b, _, _ = operands
    x, y = _jax(a), _jax(b)
    for _ in range(3):
        x = jax_mul(x, y)
    assert torch.equal(fp.fp_chain(a, b, body, 3), _words(x))


def test_e2_carry_equals_carry_ks_rows_of_the_sum(operands):
    """_carry_ks_rows(a + b) drops the carry out of the top limb: it IS
    (a + b) mod 2^384, the port's `carry` body."""
    a, b, ai, bi = operands
    want = jax.jit(lambda x, y: fq_T._carry_ks_rows(x + y))(_jax(a), _jax(b))
    got = fp.fp_chain(a, b, "carry", 1)
    assert torch.equal(got, _words(want))
    assert _ints(got) == [(x + y) % R for x, y in zip(ai, bi)]
    chained = [x for x in ai]
    for _ in range(5):
        chained = [(x + y) % R for x, y in zip(chained, bi)]
    assert _ints(fp.fp_chain(a, b, "carry", 5)) == chained


def test_e2_product_is_the_schoolbook_mod_2_384(operands):
    a, b, ai, bi = operands
    want = list(ai)
    for _ in range(3):
        want = [x * y % R for x, y in zip(want, bi)]
    assert _ints(fp.fp_chain(a, b, "product", 3)) == want


def test_e3_mul_layer_equals_lazy_mul_rows_reduced(operands):
    """E3 multiplied the halves of a stacked operand with the lazy product
    (< 1.5p); the port's layer is canonical: the same value mod p."""
    a, b, _, _ = operands
    x = torch.cat([a, b], 1)
    lazy = jax.jit(lambda u, v: fq_T._mul_rows_lazy(u, v, fq_T._const_args()))(_jax(a), _jax(b))
    got = fp.fp_mul_layer(x, threads=64)
    assert _ints(got) == [v % P for v in _ints(_words(lazy))]
    assert torch.equal(got, fp.fp_mul(a, b))


@pytest.mark.parametrize("inner", [1, 100])
def test_e4_noop_equals_numpy(inner):
    x = np.random.default_rng(inner).integers(-2**20, 2**20, (32, 1024)).astype(np.int32)
    got = torch.from_numpy(x)
    for _ in range(3):
        got = fp.noop(got, inner)
    assert np.array_equal(got.numpy(), x + 3 * inner)


def test_probe_wrappers_check_their_operands(operands):
    a, b, _, _ = operands
    with pytest.raises(TypeError):
        fp.fp_mul(a.to(torch.int64), b)
    with pytest.raises(ValueError):
        fp.fp_mul(a[:11], b[:11])
    with pytest.raises(ValueError):
        fp.fp_chain(a, b, "conv", 1)
    with pytest.raises(ValueError):
        fp.fp_mul_layer(a[:, :5])
    with pytest.raises(ValueError):
        fp.noop(a, -1)
