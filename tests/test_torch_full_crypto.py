"""The port's threshold-decrypt epoch (ops/decrypt_torch, sim/tensor
FullCryptoTensorSim) on the CPU at 4 nodes x 1 instance: the verdict,
every lane against the host oracle, a wrong check scalar caught, the
launch counts the digits imply, resuming from the JAX sim, and (slow)
limb-for-limb equality with the JAX decrypt_T epoch.  Then the engine's
HYDRABADGER_WIN_CIRCUIT=0 path against the circuit path, and the generic
epoch (HYDRABADGER_DECRYPT_T=0) at 4 nodes x 2 instances, 2 chunks, resumed
from a JAX sim: against the decrypt engine and the host oracle, its launch
counts, the share_chunks rule, and (slow) against JAX's generic epoch."""
import numpy as np
import pytest
import torch

from hydrabadger_tpu.sim import tensor as jts
from hydrabadger_tpu_torch.crypto import bls12_381 as bls
from hydrabadger_tpu_torch.ops import decrypt_torch as dt
from hydrabadger_tpu_torch.ops import limbs
from hydrabadger_tpu_torch.sim import tensor as ts

CFG = ts.FullCryptoConfig(n_nodes=4, instances=1, seed=3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class _Counting:
    """Wraps an engine's ops and counts what one epoch calls, by B2 launch
    label (`dblk4`, `win6`) and circuit name."""

    def __init__(self, ops):
        self.inner, self.fq, self.circ = ops, {}, {}
        for name in ("mul", "dbl", "add", "ladd", "glv_ladder"):
            setattr(self, name, self._count(lambda *a, name=name: name, getattr(ops, name)))
        self.dblk = self._count(lambda pt, k: f"dblk{k}", ops.dblk)
        self.win = self._count(lambda *a: f"win{a[-1]}", ops.win)

    def _count(self, label, fn):
        def call(*args):
            key = label(*args)
            self.fq[key] = self.fq.get(key, 0) + 1
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


def _projectively_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    pa, pb = limbs.limbs_to_points(a.cpu().numpy()), limbs.limbs_to_points(b.cpu().numpy())
    return len(pa) == len(pb) and all(bls.eq(x, y) for x, y in zip(pa, pb))


def test_win_circuit_0_path_equals_the_circuit_path(one_epoch, monkeypatch):
    """decrypt_T's HYDRABADGER_WIN_CIRCUIT=0 path: B2's `win6` per GLV
    window and `dblk4` + q `ladd` per Straus window, no circuit; U_next
    projectively equal to the circuit path's (JAX's contract), from the
    same state."""
    sim, _, _, _ = one_epoch
    monkeypatch.setenv("HYDRABADGER_WIN_CIRCUIT", "0")
    quorum_sks = [sim._sks[i] for i in sim._quorum]
    eng = dt.build_epoch(4, quorum_sks, sim._lam, sim._mp1, device="cpu")
    assert not eng.win_circuit and eng.straus is None
    counting = _Counting(eng.ops)
    eng.ops = counting
    U_next, ok = eng(sim._U_prev)
    assert bool(ok)
    assert _projectively_equal(U_next, sim._U)
    q = CFG.threshold + 1
    want = eng.launch_counts()
    assert counting.fq == want["fq_point"] and counting.circ == {} == want["circuit"]
    assert want["fq_point"] == {"dbl": 2, "ladd": 61 + 13 + 64 * q, "mul": 4, "add": 1,
                                "win6": 22, "dblk4": 64}


GCFG = ts.FullCryptoConfig(n_nodes=4, instances=2, seed=3, share_chunks=2)


@pytest.fixture(scope="module")
def generic_epoch():
    """A JAX sim at 4 x 2, resumed into the port's generic epoch and into
    its decrypt engine; one counted generic epoch and one decrypt epoch."""
    jsim = jts.FullCryptoTensorSim(
        jts.FullCryptoConfig(n_nodes=4, instances=2, seed=3, share_chunks=2))
    args = (np.asarray(jsim._U), jsim._sks, jsim._master, jsim._quorum)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYDRABADGER_DECRYPT_T", "0")
        gen = ts.FullCryptoTensorSim.from_jax(*args, device="cpu", share_chunks=2)
    dec = ts.FullCryptoTensorSim.from_jax(*args, device="cpu")
    before = gen.state()
    counting = _Counting(gen.epoch.ops)
    gen.epoch.ops = counting
    ok = gen.run(1)
    gen.epoch.ops = counting.inner
    return jsim, gen, dec, before, ok, counting, dec.run(1)


def test_generic_epoch_equals_the_decrypt_engine_and_the_oracle(generic_epoch):
    _, gen, dec, before, ok, _, ok_dec = generic_epoch
    assert gen.generic and "glv_ladder" in gen.epoch.launch_counts()["fq_point"]
    assert not dec.generic and isinstance(dec.epoch, dt.DecryptEpoch)
    assert ok is True and ok_dec is True
    assert not np.array_equal(gen.state(), before)
    assert _projectively_equal(gen._U, dec._U)
    assert gen.oracle_check(range(GCFG.instances * GCFG.n_nodes))


def test_generic_epoch_launch_counts(generic_epoch):
    _, gen, _, _, _, counting, _ = generic_epoch
    want = gen.epoch.launch_counts()
    q = GCFG.threshold + 1
    assert want == {"fq_point": {"glv_ladder": 2 * GCFG.share_chunks, "add": q, "mul": 3},
                    "circuit": {}}
    assert counting.fq == want["fq_point"]
    lanes = {r.name: r.lanes for r in gen.epoch.launch_shapes()}
    assert lanes["glv_ladder"] == GCFG.instances * GCFG.n_nodes * (q + 1) // GCFG.share_chunks


def test_from_jax_into_the_generic_engine_starts_as_the_port_sim(generic_epoch, monkeypatch):
    """The resumed sim holds the JAX sim's state and the same key digits a
    port sim built from the same config holds."""
    jsim, gen, _, before, _, _, _ = generic_epoch
    monkeypatch.setenv("HYDRABADGER_DECRYPT_T", "0")
    native = ts.FullCryptoTensorSim(GCFG, device="cpu")
    assert native.generic and np.array_equal(native.state(), before)
    assert np.array_equal(before, np.asarray(jsim._U))
    assert all(torch.equal(a, b) for a, b in zip(native._windows, gen._windows))
    assert native.epoch.launch_counts() == gen.epoch.launch_counts()


def test_share_chunks_must_divide_the_lanes(monkeypatch):
    assert ts.FullCryptoConfig().share_chunks == 32
    monkeypatch.setenv("HYDRABADGER_DECRYPT_T", "0")
    with pytest.raises(ValueError, match="share_chunks"):
        ts.FullCryptoTensorSim(ts.FullCryptoConfig(n_nodes=4, instances=2, share_chunks=5),
                               device="cpu")
    with pytest.raises(ValueError, match="share_chunks"):
        ts.build_full_crypto_epoch(64, 64, 21, 15, device="cpu")
    assert ts.build_full_crypto_epoch(64, 64, 21, 16, device="cpu").launch_counts()[
        "fq_point"] == {"glv_ladder": 32, "add": 22, "mul": 3}
    # "1" and unset select the decrypt engine
    monkeypatch.setenv("HYDRABADGER_DECRYPT_T", "1")
    assert not ts.FullCryptoTensorSim(CFG, device="cpu").generic


@pytest.mark.slow
def test_generic_epoch_equals_the_jax_generic_epoch(generic_epoch, monkeypatch):
    """The whole generic slice against JAX's build_full_crypto_epoch (its
    XLA:CPU compile takes minutes), from the same state and keys."""
    jsim, gen, _, _, _, _, _ = generic_epoch
    monkeypatch.setenv("HYDRABADGER_DECRYPT_T", "0")
    jgen = jts.FullCryptoTensorSim(
        jts.FullCryptoConfig(n_nodes=4, instances=2, seed=3, share_chunks=2))
    assert jgen.run(1)
    got = limbs.limbs_from_jax(np.asarray(jgen._U))
    assert _projectively_equal(torch.from_numpy(got), gen._U)
