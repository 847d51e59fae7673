"""Driver `rs`: the fault-free fast-path epoch, `sim/tensor.TensorSim.run`.

B independent N-node networks side by side.  Every node proposes
`txns_per_node` transactions of `txn_bytes` behind the 4-byte length
prefix of hbbft's broadcast, split into k = N - 2f shards of L bytes; an
epoch RS-encodes every proposal, disseminates the shards, rebuilds every
proposal from the parity-heavy quorum and checks totality.  One `run(1)`
is one committed epoch: it returns when the verdict reaches the host.

What is compared after the window, against `reference/gf256`:
  - the committed state after all E epochs, byte for byte, against the
    reference chain from the seed's proposals (the reconstruct of every
    epoch folds into it);
  - every shard of the last epoch's encode (data rows and parity), byte
    for byte, read at the op wrapper `ops/rs_torch.rs_encode_batch`'s
    return, against the reference encode of the state before it;
  - the epoch's own totality verdict, which must hold in every epoch.

The shards are read by replacing the module attribute
`rs_torch.rs_encode_batch` for the whole window, so this freezes the
encode's call site: `sim/tensor` has to call the encode through that
attribute once an epoch.  A program that fuses encode and reconstruct,
or calls its encoder another way, reads every shard byte wrong here
until the program hands out the last epoch's shards itself.
"""
from __future__ import annotations

import numpy as np

from ..reference import gf256
from ..yardstick import work_rs

WARMUP_EPOCHS = 3


class Driver:
    libraries = ("gf256_matmul",)

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        s = work_rs.shapes(config, traffic)
        self.k, self.p, self.L = s["k"], s["p"], s["shard_len"]
        self.B, self.N = traffic["instances"], config["n_nodes"]
        if self.k + self.p != self.N or self.p != 2 * config["f"]:
            raise ValueError("the configuration's shards are not (N - 2f, 2f)")
        self.contributions_per_epoch = self.B * self.N
        self.epochs = 0  # epochs run so far, warm-up included
        self.verdicts_failed = 0
        self.sim = None
        self._shards = None  # (epoch, [B*N, n, L] tensor) of the last encode

    # -- inputs and the system ------------------------------------------

    def make_inputs(self) -> None:
        rng = np.random.default_rng(self.seed % 2**64)
        self.state0 = rng.integers(0, 256, (self.B, self.N, self.k, self.L), dtype=np.uint8)

    def build_system(self) -> None:
        from hydrabadger_tpu_torch.ops import rs_torch
        from hydrabadger_tpu_torch.sim import tensor

        cfg = tensor.TensorSimConfig(n_nodes=self.N, instances=self.B, shard_len=self.L)
        if (cfg.data_shards, cfg.parity_shards) != (self.k, self.p):
            raise ValueError("the program's shard counts differ from the configuration's")
        self.sim = tensor.TensorSim.from_jax_state(self.state0, cfg, device=self.device)
        self._rs_torch, self._encode = rs_torch, rs_torch.rs_encode_batch

        def encode_and_keep(*args, **kwargs):
            out = self._encode(*args, **kwargs)
            self.keep_shards(out)
            return out

        rs_torch.rs_encode_batch = encode_and_keep

    def keep_shards(self, shards) -> None:
        self._shards = (self.epochs, shards)

    def setup(self) -> None:
        self.make_inputs()
        self.build_system()
        for _ in range(WARMUP_EPOCHS):
            self.step()

    # -- the timed path ---------------------------------------------------

    def step(self) -> bool:
        self.epochs += 1
        ok = self.sim.run(1)
        self.verdicts_failed += not ok
        return ok

    # -- after the window -------------------------------------------------

    def collect(self) -> None:
        self.state = np.asarray(self.sim.state())
        epoch, shards = self._shards if self._shards else (None, None)
        self.shards_epoch = epoch
        self.shards = shards if shards is None or isinstance(shards, np.ndarray) else shards.cpu().numpy()
        if self.sim is not None and hasattr(self, "_encode"):
            self._rs_torch.rs_encode_batch = self._encode
        self.sim = self._shards = None

    def check(self):
        E, k, p = self.epochs, self.k, self.p
        want_state = gf256.state_after(self.state0, E)
        state_wrong = _bytes_differing(self.state, want_state)
        want_shards = gf256.encode(gf256.state_after(self.state0, E - 1), k, p)
        if self.shards is None or self.shards_epoch != E:
            shards_wrong = want_shards.size  # the last epoch encoded nothing we saw
        else:
            got = self.shards
            if got.size == want_shards.size:  # the program's [B*N, n, L]
                got = got.reshape(want_shards.shape)
            shards_wrong = _bytes_differing(got, want_shards)
        return [
            ("state_bytes_wrong", state_wrong, 0),
            ("shard_bytes_wrong", shards_wrong, 0),
            ("epochs_not_total", self.verdicts_failed, 0),
        ]


def _bytes_differing(got: np.ndarray, want: np.ndarray) -> int:
    if got.shape != want.shape:
        return int(want.size)
    return int(np.count_nonzero(got != want))


class Control:
    """The reference in the program's place, with one guarantee broken:
    the encode computes only the parity rows the fast path's quorum reads
    (the last k of the p), and leaves the other p - k parity shards zero.
    The committed state is right; the code is no longer an (N - 2f, N)
    erasure code, since those shards no longer reconstruct anything."""

    def __init__(self, driver: Driver):
        self.d = driver
        self.s = driver.state0.copy()

    def run(self, epochs: int) -> bool:
        d = self.d
        for _ in range(epochs):
            shards, decoded, total, self.s = gf256.fast_path_epoch(self.s, d.k, d.p)
            shards[:, :, d.k:d.p] = 0  # the parity rows the quorum does not read
            d.keep_shards(shards.reshape(d.B * d.N, d.N, d.L))
        return total

    def state(self) -> np.ndarray:
        return self.s

