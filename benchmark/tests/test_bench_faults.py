"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run (inputs, window, collection, the
comparison) on the CPU at a tiny size, skipping only the look for a card:
the program's plain versions run in place of its kernels.  The faults: a
step that returns its state unchanged; half of the batch left out; an
answer altered where it is produced.  One chip per cell, so no exchange
between chips can be left out.  The control, the reference with one
guarantee broken, comes out not correct too.
"""
import torch

from benchmark.run import load_module, run_cell


def _run(root, cell, system=None, epochs=2):
    return run_cell(cell, 2**33 + 17, 1e9, False, device="cpu", root=root,
                    max_epochs=epochs, system=system)


def _program(driver):
    driver.build_system()
    return driver.sim


def test_sound_runs_are_correct(tiny_root):
    for cell in ("rs-tiny", "tpke-tiny"):
        r = _run(tiny_root, cell, epochs=1)
        assert r["correct"], r["checks"]
        assert r["attempted"] == 1 and r["failed"] == 0


# -- rs ----------------------------------------------------------------------


def _rs_with_epoch(fn):
    """The program with sim/tensor.epoch replaced by fn(real_epoch, ...)."""
    from hydrabadger_tpu_torch.sim import tensor

    def build(driver):
        sim = _program(driver)
        real = tensor.epoch
        original_run = sim.run

        def run(epochs):
            tensor.epoch = lambda *a, **k: fn(real, *a, **k)
            try:
                return original_run(epochs)
            finally:
                tensor.epoch = real

        sim.run = run
        return sim
    return build


def test_rs_state_unchanged(tiny_root):
    def unchanged(driver):
        sim = _program(driver)
        sim.run = lambda epochs: True
        return sim
    r = _run(tiny_root, "rs-tiny", unchanged)
    assert not r["correct"]
    assert r["checks"]["shard_bytes_wrong"]["value"] > 0


def test_rs_half_the_batch_left_out(tiny_root):
    def half(real, proposals, k, p, use_kernel=True):
        B = proposals.shape[0] // 2
        decoded, ok = real(proposals[:B], k, p, use_kernel)
        return torch.cat([decoded, proposals[B:]]), torch.cat([ok, ok])
    r = _run(tiny_root, "rs-tiny", _rs_with_epoch(half))
    assert not r["correct"] and r["checks"]["shard_bytes_wrong"]["value"] > 0


def test_rs_decoded_byte_altered(tiny_root):
    def altered(real, *a, **k):
        decoded, ok = real(*a, **k)
        decoded = decoded.clone()
        decoded[1, 7, 3, 0] ^= 0x40
        return decoded, ok
    r = _run(tiny_root, "rs-tiny", _rs_with_epoch(altered))
    assert not r["correct"] and r["checks"]["state_bytes_wrong"]["value"] > 0


def test_rs_parity_byte_altered(tiny_root):
    from hydrabadger_tpu_torch.ops import rs_torch

    def altered(real, *a, **k):
        encode = rs_torch.rs_encode_batch

        def bad_encode(*ea, **ek):
            out = encode(*ea, **ek)
            out[5, 30, 1] ^= 1  # a parity row the quorum does not read
            return out
        rs_torch.rs_encode_batch = bad_encode
        try:
            return real(*a, **k)
        finally:
            rs_torch.rs_encode_batch = encode
    r = _run(tiny_root, "rs-tiny", _rs_with_epoch(altered))
    assert not r["correct"]
    assert r["checks"]["shard_bytes_wrong"]["value"] == 1
    assert r["checks"]["state_bytes_wrong"]["value"] == 0


def test_rs_control(tiny_root):
    control = load_module("drivers", "rs", tiny_root).Control
    r = _run(tiny_root, "rs-tiny", control)
    assert not r["correct"]
    assert r["checks"]["shard_bytes_wrong"]["value"] > 0
    assert r["checks"]["state_bytes_wrong"]["value"] == 0


# -- tpke --------------------------------------------------------------------


def _tpke_with_epoch(fn):
    def build(driver):
        sim = _program(driver)
        real = sim.epoch
        sim.epoch = lambda U, *w: fn(driver, real, U, *w)
        return sim
    return build


def test_tpke_state_unchanged(tiny_root):
    r = _run(tiny_root, "tpke-tiny", _tpke_with_epoch(lambda d, real, U: (U, real(U)[1])), 1)
    assert not r["correct"] and r["checks"]["lanes_wrong"]["value"] == 8


def test_tpke_half_the_batch_left_out(tiny_root):
    from hydrabadger_tpu_torch.ops import decrypt_torch

    halves = {}

    def half(driver, real, U):
        n = U.shape[-1] // 2
        if "epoch" not in halves:
            sim = driver.sim
            halves["epoch"] = decrypt_torch.build_epoch(
                n, [sim._sks[i] for i in sim._quorum], sim._lam, sim._mp1, device="cpu")
        U_half, ok = halves["epoch"](U[..., :n].contiguous())
        return torch.cat([U_half, U[..., n:]], -1), ok
    r = _run(tiny_root, "tpke-tiny", _tpke_with_epoch(half), 1)
    assert not r["correct"] and r["checks"]["lanes_wrong"]["value"] == 4


def test_tpke_lane_altered(tiny_root):
    def altered(driver, real, U):
        U_next, ok = real(U)
        U_next = U_next.clone()
        U_next[..., 3] = U_next[..., 2]
        return U_next, ok
    r = _run(tiny_root, "tpke-tiny", _tpke_with_epoch(altered), 1)
    assert not r["correct"] and r["checks"]["lanes_wrong"]["value"] == 1


def test_tpke_control(tiny_root):
    control = load_module("drivers", "tpke", tiny_root).Control
    r = _run(tiny_root, "tpke-tiny", control, 3)
    assert not r["correct"] and r["checks"]["lanes_wrong"]["value"] == 8
