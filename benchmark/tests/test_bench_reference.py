"""The plain references: GF(2^8) and RS, BLS12-381 G1, the decrypt epoch."""
import numpy as np
import pytest

from benchmark.reference import g1, gf256


def test_rs_against_a_hand_made_vector():
    # RS(k=2, p=2): V = [[1, 1], [1, 2], [1, 4], [1, 8]], the top inverted:
    # parity rows [2, 3] and [6, 7].  2*0x12 ^ 3*0xab = 0x24 ^ 0xe0 = 0xc4.
    assert gf256.encode_matrix(2, 2).tolist() == [[1, 0], [0, 1], [2, 3], [6, 7]]
    data = np.array([[[0x12, 0x34, 0x56], [0xAB, 0xCD, 0xEF]]], np.uint8)
    shards = gf256.encode(data, 2, 2)
    assert shards[0, 2:].tolist() == [[0xC4, 0x22, 0x80], [0x1A, 0xE1, 0x5E]]
    assert (gf256.reconstruct(shards[:, 2:], [2, 3], 2, 2) == data).all()


def test_field_tables():
    assert gf256.MUL[2, 0x80] == 0x1D and gf256.MUL[3, 0xAB] == 0xE0
    for a in range(1, 256):
        assert gf256.MUL[a, gf256.inv(a)] == 1


@pytest.mark.parametrize("rows", [range(42, 64), [0, 5, *range(44, 64)]])
def test_any_k_shards_rebuild(rows):
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (3, 22, 5), dtype=np.uint8)
    shards = gf256.encode(data, 22, 42)
    assert (gf256.reconstruct(shards[:, list(rows)], rows, 22, 42) == data).all()


def test_same_code_as_the_program():
    from hydrabadger_tpu_torch.crypto import rs

    assert (gf256.encode_matrix(22, 42) == rs.encode_matrix(22, 42)).all()


def test_state_after_is_the_epoch_iterated():
    rng = np.random.default_rng(5)
    s0 = rng.integers(0, 256, (2, 64, 22, 4), dtype=np.uint8)
    s = s0
    for e in range(1, 6):
        shards, decoded, total, s = gf256.fast_path_epoch(s, 22, 42)
        assert total and (gf256.state_after(s0, e) == s).all()


def test_g1_scalar_multiplication_is_repeated_addition():
    acc = g1.INF
    for k in range(1, 40):
        acc = g1.add(acc, g1.G)
        assert g1.to_affine([acc]) == g1.to_affine([g1.mul(g1.G, k)])
        assert g1.on_curve(acc)
    assert g1.mul(g1.G, g1.R)[2] % g1.P == 0
    assert g1.add(g1.G, g1.mul(g1.G, g1.R - 1))[2] == 0


def test_layout_round_trip_and_the_programs_layout():
    from hydrabadger_tpu_torch.crypto import bls12_381 as bls
    from hydrabadger_tpu_torch.ops import limbs

    ks = [3, 7, 2**200 + 11]
    mine = g1.points_to_layout(g1.to_affine([g1.mul(g1.G, k) for k in ks]))
    theirs = limbs.limbs_to_jax(limbs.points_to_limbs([bls.mul_sub(bls.G1, k) for k in ks]), (3,))
    assert (mine == theirs).all()
    pts = g1.layout_points(mine)
    assert g1.lanes_differing(pts, g1.to_affine([g1.mul(g1.G, k) for k in ks])) == 0
    assert g1.lanes_differing(pts, g1.to_affine([g1.mul(g1.G, k + 1) for k in ks])) == 3


def test_decrypt_epochs_on_a_tiny_instance():
    # n = 7, t = 2: U * (master + 1)^E after E epochs of shares and combines
    coeffs = [123456789, 987654321, 555]
    sks = [g1.poly_eval(coeffs, i + 1) for i in range(7)]
    for quorum in ([0, 1, 2], [2, 4, 6]):
        us = [g1.mul(g1.G, 11), g1.mul(g1.G, 2**130 + 5)]
        for _ in range(3):
            us = [g1.decrypt_epoch(u, sks, quorum) for u in us]
        want = [g1.mul(g1.G, 11 * g1.state_scalar(coeffs[0], 3)),
                g1.mul(g1.G, (2**130 + 5) * g1.state_scalar(coeffs[0], 3))]
        assert g1.to_affine(us) == g1.to_affine(want)
    # t shares are not enough
    short = g1.decrypt_epoch(g1.G, sks, [0, 1])
    assert g1.to_affine([short]) != g1.to_affine([g1.mul(g1.G, coeffs[0] + 1)])
