"""Driver `tpke`: threshold decryption in the epoch, `sim/tensor.FullCryptoTensorSim.run`.

B networks of N nodes, one ciphertext U per proposer: B * N ciphertexts
an epoch.  In every epoch each of the q = t + 1 quorum members emits its
decryption share U * sk_i of every ciphertext, the shares combine by
Lagrange at zero to U * master, and the next epoch's ciphertext is
U + U * master, so no epoch can be skipped; the program also checks every
lane against U * (master + 1) on the device.  One `run(1)` is one
committed epoch: it returns when that verdict reaches the host.  The
program's default decrypt engine runs (no engine is selected).

Inputs, from the seed: a random polynomial of degree t over Fr (its value
at 0 the master key, at i + 1 node i's key share) and the ciphertexts
U_j = (a + j b) G for lane j = instance * N + proposer, made by one chain
of point additions from a G and b G.

What is compared after the window, against `reference/g1`: every lane of
the state after all E epochs, which must be (a + j b) (master + 1)^E G;
and the program's own check, which must hold in every epoch.  The state
cannot tell a path that computes every share from one that computes
U * (master + 1) alone: PERF.md says so.
"""
from __future__ import annotations

import random

from ..reference import g1

WARMUP_EPOCHS = 2


class Driver:
    libraries = ("fq_point", "circuit")

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.B, self.N, self.t = traffic["instances"], config["n_nodes"], config["threshold"]
        self.quorum = list(range(self.t + 1))
        self.contributions_per_epoch = self.B * self.N
        self.epochs = 0
        self.verdicts_failed = 0
        self.sim = None

    def make_inputs(self) -> None:
        rng = random.Random(self.seed)
        n_ct = self.B * self.N
        while True:
            coeffs = [rng.getrandbits(256) % g1.R for _ in range(self.t + 1)]
            a, b = rng.getrandbits(256) % g1.R, rng.getrandbits(256) % g1.R
            # a nonzero master + 1, and no ciphertext at infinity
            if (coeffs[0] + 1) % g1.R and b and all((a + j * b) % g1.R for j in range(n_ct)):
                break
        self.coeffs, self.a, self.b = coeffs, a, b
        self.master = coeffs[0]
        self.sks = [g1.poly_eval(coeffs, i + 1) for i in range(self.N)]
        lanes = g1.to_affine(g1.chain(g1.mul(g1.G, a), g1.mul(g1.G, b), n_ct))
        self.u0 = g1.points_to_layout(lanes).reshape(self.B, self.N, 3, g1.N_LIMBS)

    def build_system(self) -> None:
        from hydrabadger_tpu_torch.sim import tensor

        self.sim = tensor.FullCryptoTensorSim.from_jax(
            self.u0, self.sks, self.master, self.quorum, device=self.device)

    def setup(self) -> None:
        self.make_inputs()
        self.build_system()
        for _ in range(WARMUP_EPOCHS):
            self.step()

    def step(self) -> bool:
        self.epochs += 1
        ok = self.sim.run(1)
        self.verdicts_failed += not ok
        return ok

    def collect(self) -> None:
        self.state = self.sim.state()
        self.sim = None

    def expected(self, factor: int):
        """The affine lanes of (a + j b) * factor * G."""
        start = g1.mul(g1.G, self.a * factor)
        step = g1.mul(g1.G, self.b * factor)
        return g1.to_affine(g1.chain(start, step, self.B * self.N))

    def check(self):
        want = self.expected(g1.state_scalar(self.master, self.epochs))
        got = g1.layout_points(self.state) if self.state.size == len(want) * 3 * g1.N_LIMBS else []
        return [
            ("lanes_wrong", g1.lanes_differing(got, want), 0),
            ("epochs_check_failed", self.verdicts_failed, 0),
        ]


class Control:
    """The reference in the program's place, with one guarantee broken:
    the combine takes t shares where the threshold needs t + 1 (Lagrange
    over quorum members 0 .. t - 1), so every epoch multiplies U by
    1 + s', s' the degree-(t - 1) interpolation of t key shares at 0,
    where master + 1 is due.  Every lane is A + j B and stays so under a
    common factor, so the stand-in keeps (A, B) and multiplies both."""

    def __init__(self, driver: Driver):
        d = self.d = driver
        lam = g1.lagrange_at_zero([i + 1 for i in range(d.t)])
        s_short = sum(li * d.sks[i] for i, li in enumerate(lam)) % g1.R
        self.factor = (1 + s_short) % g1.R
        self.scale = 1

    def run(self, epochs: int) -> bool:
        self.scale = self.scale * pow(self.factor, epochs, g1.R) % g1.R
        return True

    def state(self):
        lanes = self.d.expected(self.scale)
        return g1.points_to_layout(lanes).reshape(self.d.B, self.d.N, 3, g1.N_LIMBS)
