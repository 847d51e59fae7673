"""Driver `tpke_byz`: threshold decryption with every share and ciphertext
verified, f validators forging, in `sim/tensor.FullCryptoTensorSim.run`.

B networks of N nodes, one ciphertext (U, W) per proposer: B * N
ciphertexts an epoch, each with its hash point H.  Every epoch the q =
t + 1 quorum nodes' shares U sk_i and the f faulty nodes' forged shares
(node N - f + k sends quorum node k's share plus U) are each checked,
e(S_i, H) == e(pk_i, W), and every ciphertext, e(G1, W) == e(U, H), by
pairings on the device; the quorum's shares combine to U master, and the
next ciphertext is (U, W) (master + 1), so no epoch can be skipped.  The
program's epoch fails where a quorum share or a ciphertext fails its
check or a forged share passes.  One `run(1)` is one committed epoch.

Inputs, from the seed: the key polynomial of degree t over Fr (as
drivers/tpke), the ciphertexts U_j = (a + j b) G1 and hash points
H_j = (c + j d) G2 for lane j = instance * N + proposer, and
W_j = (a + j b) H_j, made by chains of point additions.  H stands for
H_G2(U_0, V), a random oracle's point of G2: the closed form draws it
as a seeded multiple of the generator.

What is compared after the window, each with limit 0, against
`reference/`:

- `lanes_wrong`: every lane of U after all E epochs, which must be
  (a + j b) (master + 1)^E G1 (`reference/g1`);
- `w_lanes_wrong`: every lane of W, which must be
  (master + 1)^E (a + j b)(c + j d) G2 (`reference/g2`'s chain);
- `verdicts_wrong`: every verdict of the last epoch against the closed
  form, each quorum share and each ciphertext valid and each forged share
  not: (q + f + 1) B N of them (benchmark/tests hold the closed form
  equal to the reference pairing on a tiny cell);
- `rejections_not_total`: the program's count of failed share checks
  over all E epochs, counted on the device, against E f B N;
- `epochs_check_failed`: epochs whose own verdict failed.
"""
from __future__ import annotations

import random

import numpy as np

from ..reference import g1, g2

WARMUP_EPOCHS = 2


def _program():
    """The program's sim module; exits at once where the program has no
    verified epoch (an older program, which cannot run this cell)."""
    from hydrabadger_tpu_torch.sim import tensor

    if "verify" not in getattr(tensor.FullCryptoConfig, "__dataclass_fields__", {}):
        raise SystemExit("tpke_byz: the program has no verified threshold-decrypt epoch")
    return tensor


class Driver:
    libraries = ("fq_point", "circuit", "fq2_point")

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.B, self.N, self.t = traffic["instances"], config["n_nodes"], config["threshold"]
        self.quorum = list(range(self.t + 1))
        self.faulty = list(config["faulty"])
        if self.faulty != list(range(self.N - len(self.faulty), self.N)):
            raise ValueError("the program's faulty nodes are the last f")
        self.contributions_per_epoch = self.B * self.N
        self.epochs = 0
        self.verdicts_failed = 0
        self.sim = None

    def make_inputs(self) -> None:
        rng = random.Random(self.seed)
        n_ct = self.B * self.N
        while True:
            coeffs = [rng.getrandbits(256) % g1.R for _ in range(self.t + 1)]
            a, b, c, d = (rng.getrandbits(256) % g1.R for _ in range(4))
            sks = [g1.poly_eval(coeffs, i + 1) for i in range(self.N)]
            # a nonzero master + 1; no U or H at infinity; no forged share
            # at infinity or equal to its sender's valid share
            if ((coeffs[0] + 1) % g1.R and b and d
                    and all((a + j * b) % g1.R and (c + j * d) % g1.R for j in range(n_ct))
                    and all((sks[k] + 1 - sks[i]) % g1.R and (sks[k] + 1) % g1.R
                            for k, i in enumerate(self.faulty))):
                break
        self.coeffs, self.a, self.b, self.c, self.d = coeffs, a, b, c, d
        self.master, self.sks = coeffs[0], sks
        shape = (self.B, self.N)
        u = g1.to_affine(g1.chain(g1.mul(g1.G, a), g1.mul(g1.G, b), n_ct))
        h = g2.to_affine(g2.chain(g2.mul(g2.G, c), g2.mul(g2.G, d), n_ct))
        self.u0 = g1.points_to_layout(u).reshape(*shape, 3, g1.N_LIMBS)
        self.h = g2.points_to_layout(h).reshape(*shape, 3, 2, g1.N_LIMBS)
        self.w0 = g2.points_to_layout(self.expected_w(1)).reshape(*shape, 3, 2, g1.N_LIMBS)

    def build_system(self) -> None:
        tensor = _program()
        self.sim = tensor.FullCryptoTensorSim.from_jax(
            self.u0, self.sks, self.master, self.quorum, device=self.device,
            W=self.w0, H=self.h, faulty=len(self.faulty))

    def setup(self) -> None:
        self.make_inputs()
        self.build_system()
        for _ in range(WARMUP_EPOCHS):
            self.step()
        from hydrabadger_tpu_torch.obs import metrics

        metrics.default_registry().reset()  # the program's counters count the window's epochs

    def step(self) -> bool:
        self.epochs += 1
        ok = self.sim.run(1)
        self.verdicts_failed += not ok
        return ok

    def collect(self) -> None:
        self.state = self.sim.state()
        self.w_state = self.sim.w_state()
        self.verdicts = self.sim.last_verdicts()
        self.rejected = self.sim.rejected_total
        self.sim = None

    def expected_u(self, factor: int):
        """The affine lanes of (a + j b) * factor * G1."""
        start = g1.mul(g1.G, self.a * factor)
        step = g1.mul(g1.G, self.b * factor)
        return g1.to_affine(g1.chain(start, step, self.B * self.N))

    def expected_w(self, factor: int):
        """The affine lanes of factor (a + j b)(c + j d) G2."""
        a, b, c, d = self.a, self.b, self.c, self.d
        return g2.to_affine(g2.quadratic_chain(
            factor * a * c % g1.R, factor * (a * d + b * c) % g1.R, factor * b * d % g1.R,
            self.B * self.N))

    def expected_verdicts(self) -> dict:
        shape = (self.B, self.N)
        return {"forged": np.zeros((len(self.faulty), *shape), bool),
                "quorum": np.ones((len(self.quorum), *shape), bool),
                "ciphertext": np.ones(shape, bool)}

    def check(self):
        factor = g1.state_scalar(self.master, self.epochs)
        want_u, want_w = self.expected_u(factor), self.expected_w(factor)
        n_limbs = len(want_u) * g1.N_LIMBS
        got_u = g1.layout_points(self.state) if self.state.size == 3 * n_limbs else []
        got_w = g2.layout_points(self.w_state) if self.w_state.size == 6 * n_limbs else []
        verdicts_wrong = 0
        for kind, want in self.expected_verdicts().items():
            got = np.asarray(self.verdicts.get(kind, ()))
            verdicts_wrong += int((got != want).sum()) if got.shape == want.shape else want.size
        total = self.epochs * len(self.faulty) * self.B * self.N
        return [
            ("lanes_wrong", g1.lanes_differing(got_u, want_u), 0),
            ("w_lanes_wrong", g2.lanes_differing(got_w, want_w), 0),
            ("verdicts_wrong", verdicts_wrong, 0),
            ("rejections_not_total", abs(self.rejected - total), 0),
            ("epochs_check_failed", self.verdicts_failed, 0),
        ]


class Control:
    """The reference in the program's place, with one guarantee broken:
    shares are taken unchecked, so every forged share is accepted (every
    verdict reads valid) and none is rejected.  The rest is the
    reference's: U and W advance by master + 1 an epoch."""

    def __init__(self, driver: Driver):
        self.d = driver
        self.scale = 1
        self.rejected_total = 0

    def run(self, epochs: int) -> bool:
        self.scale = self.scale * pow((self.d.master + 1) % g1.R, epochs, g1.R) % g1.R
        return True

    def state(self):
        d = self.d
        return g1.points_to_layout(d.expected_u(self.scale)).reshape(d.B, d.N, 3, g1.N_LIMBS)

    def w_state(self):
        d = self.d
        return g2.points_to_layout(d.expected_w(self.scale)).reshape(d.B, d.N, 3, 2, g1.N_LIMBS)

    def last_verdicts(self) -> dict:
        return {k: np.ones_like(v) for k, v in self.d.expected_verdicts().items()}


_program()  # an older program exits here, on import, before any kernel is built
