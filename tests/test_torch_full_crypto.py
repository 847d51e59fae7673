"""The port's threshold-decrypt epoch (ops/decrypt_torch, sim/tensor
FullCryptoTensorSim) on the CPU at 4 nodes x 1 instance: the verdict,
every lane against the host oracle, a wrong check scalar caught, the
launch counts the digits imply, resuming from the JAX sim, and (slow)
limb-for-limb equality with the JAX decrypt_T epoch."""
import numpy as np
import pytest
import torch

from hydrabadger_tpu.sim import tensor as jts
from hydrabadger_tpu_torch.crypto import bls12_381 as bls
from hydrabadger_tpu_torch.ops import decrypt_torch as dt
from hydrabadger_tpu_torch.sim import tensor as ts

CFG = ts.FullCryptoConfig(n_nodes=4, instances=1, seed=3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class _Counting:
    """Wraps an engine's ops and counts what one epoch calls."""

    def __init__(self, ops):
        self.inner, self.fq, self.circ = ops, {}, {}
        for name in ("mul", "dbl", "add", "ladd"):
            setattr(self, name, self._count(name, getattr(ops, name)))

    def _count(self, name, fn):
        def call(*args):
            self.fq[name] = self.fq.get(name, 0) + 1
            return fn(*args)

        return call

    def circuit(self, circ, x):
        self.circ[circ.name] = self.circ.get(circ.name, 0) + 1
        return self.inner.circuit(circ, x)

    def chain(self, chain, acc, table):
        self.circ[chain.name] = self.circ.get(chain.name, 0) + 1
        return self.inner.chain(chain, acc, table)


@pytest.fixture(scope="module")
def one_epoch():
    """A 4 x 1 sim and its state before and after one counted epoch."""
    sim = ts.FullCryptoTensorSim(CFG, device="cpu")
    before = sim.state()
    counting = _Counting(sim.epoch.ops)
    sim.epoch.ops = counting
    ok = sim.run(1)
    sim.epoch.ops = counting.inner
    return sim, before, ok, counting


def test_epoch_verdict_and_every_lane_equal_the_host_oracle(one_epoch):
    sim, before, ok, _ = one_epoch
    assert ok is True
    assert sim._U.shape == (3, 12, 4) and sim.state().shape == (1, 4, 3, 32)
    assert not np.array_equal(sim.state(), before)
    assert sim.oracle_check(range(CFG.instances * CFG.n_nodes))


def test_launch_counts_are_the_ones_the_digits_imply(one_epoch):
    sim, _, _, counting = one_epoch
    want = sim.epoch.launch_counts()
    assert counting.fq == want["fq_point"]
    assert counting.circ == want["circuit"]
    q = CFG.threshold + 1
    assert want["fq_point"] == {"dbl": 2, "ladd": 61 + 13, "mul": 4, "add": 1}
    # every GLV window launches at most its two circuits; the Straus combine
    # is one chain launch whose steps are the digits' circuit calls
    assert set(want["circuit"]) == {"dblk6_add", "add", "straus"}
    assert want["circuit"]["dblk6_add"] <= 22 and want["circuit"]["add"] <= 22
    assert want["circuit"]["straus"] == 1
    chain = sim.epoch.straus
    calls = [c for c in chain.step_words[::3].tolist() if c >= 0]
    assert calls.count(0) <= 64 and calls.count(1) <= 64 * (q - 1)
    assert chain.products == 44 * calls.count(0) + 16 * calls.count(1)


def test_a_wrong_check_scalar_is_caught(one_epoch):
    sim, _, _, _ = one_epoch
    quorum_sks = [sim._sks[i] for i in sim._quorum]
    bad = dt.build_epoch(4, quorum_sks, sim._lam, (sim._mp1 + 1) % bls.R, device="cpu")
    _, ok = bad(sim._U_prev)
    assert not bool(ok)


def test_from_jax_resumes_identically(one_epoch):
    sim, before, _, _ = one_epoch
    jsim = jts.FullCryptoTensorSim(
        jts.FullCryptoConfig(n_nodes=4, instances=1, seed=3, share_chunks=1)
    )
    assert np.array_equal(np.asarray(jsim._U), before)  # same key set and U stream
    assert (jsim._sks, jsim._master, jsim._quorum) == (sim._sks, sim._master, sim._quorum)
    resumed = ts.FullCryptoTensorSim.from_jax(
        np.asarray(jsim._U), jsim._sks, jsim._master, jsim._quorum, device="cpu"
    )
    assert resumed._lam == sim._lam and resumed._mp1 == sim._mp1
    assert resumed.run(1) is True
    assert np.array_equal(resumed.state(), sim.state())
    with pytest.raises(ValueError):
        ts.FullCryptoTensorSim.from_jax(np.zeros((1, 4, 3, 31), np.int32), jsim._sks,
                                        jsim._master, jsim._quorum, device="cpu")


def test_full_crypto_sim_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ts.FullCryptoTensorSim(CFG)
    with pytest.raises(RuntimeError, match="oracle_check"):
        ts.FullCryptoTensorSim(CFG, device="cpu").oracle_check([0])


@pytest.mark.slow
def test_epoch_equals_the_jax_decrypt_T_epoch_limb_for_limb(one_epoch):
    """The whole slice against JAX: one decrypt_T epoch (its XLA:CPU
    compile takes about a minute) from the same state, key set and
    quorum."""
    import jax.numpy as jnp

    from hydrabadger_tpu.ops import decrypt_T

    sim, before, _, _ = one_epoch
    fn = decrypt_T.build_epoch(4, [sim._sks[i] for i in sim._quorum], list(sim._lam), sim._mp1)
    U_next, ok = fn(jnp.asarray(before.reshape(4, 3, 32)))
    assert bool(ok)
    assert np.array_equal(np.asarray(U_next).reshape(1, 4, 3, 32), sim.state())
