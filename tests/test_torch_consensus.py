"""The port's host crypto and consensus cores against the JAX package's.

The codec byte for byte on hypothesis-drawn values; the extended
bls12_381 (pairing checks, final exponentiation, hash_to_fr, subgroup
checks, from_bytes) against the JAX pure-Python functions; threshold keys,
signatures and ciphertexts across the packages; `trusted_setup` byte for
byte; the cores (Broadcast in both variants with a corrupted shard,
BinaryAgreement on the hash coin, ThresholdDecrypt with a bad share) giving
the same outgoing messages (codec bytes), outputs and faults as the JAX
cores on the same inputs and delivery order; and the host engine's
per-item entries against the JAX CpuEngine's.
"""
import random

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from hydrabadger_tpu.consensus import binary_agreement as jba
from hydrabadger_tpu.consensus import broadcast as jbc
from hydrabadger_tpu.consensus import threshold_decrypt as jtd
from hydrabadger_tpu.crypto import bls12_381 as jbls
from hydrabadger_tpu.crypto import engine as jengine
from hydrabadger_tpu.crypto import threshold as jth
from hydrabadger_tpu.sim import network as jnet
from hydrabadger_tpu.sim import router as jrouter
from hydrabadger_tpu.utils import codec as jcodec
from hydrabadger_tpu_torch.consensus import binary_agreement as ba
from hydrabadger_tpu_torch.consensus import broadcast as bc
from hydrabadger_tpu_torch.consensus import threshold_decrypt as td
from hydrabadger_tpu_torch.crypto import bls12_381 as bls
from hydrabadger_tpu_torch.crypto import engine
from hydrabadger_tpu_torch.crypto import threshold as th
from hydrabadger_tpu_torch.sim import network, router
from hydrabadger_tpu_torch.utils import codec

PORT = dict(bc=bc, ba=ba, td=td, router=router, net=network, eng="cpu")
JAX = dict(bc=jbc, ba=jba, td=jtd, router=jrouter, net=jnet, eng="cpu")


def affine(pt):
    aff = bls.normalize(pt)
    return None if aff is None else [getattr(c, "coeffs", getattr(c, "n", None)) for c in aff]


def jaffine(pt):
    aff = jbls.normalize(pt)
    return None if aff is None else [getattr(c, "coeffs", getattr(c, "n", None)) for c in aff]


# -- the codec ---------------------------------------------------------------

leaves = st.one_of(st.none(), st.booleans(), st.integers(min_value=-(2**400), max_value=2**400),
                   st.binary(max_size=40), st.text(max_size=20))
values = st.recursive(leaves, lambda inner: st.one_of(
    st.lists(inner, max_size=5), st.tuples(inner, inner),
    st.dictionaries(st.one_of(st.integers(-9, 9), st.binary(max_size=4), st.text(max_size=4)),
                    inner, max_size=4)), max_leaves=25)


def _tuples(v):
    if isinstance(v, (list, tuple)):
        return tuple(_tuples(x) for x in v)
    if isinstance(v, dict):
        return {k: _tuples(x) for k, x in v.items()}
    return v


@settings(max_examples=60, deadline=None)
@given(values)
def test_codec_equals_the_jax_codec_and_round_trips(value):
    raw = codec.encode(value)
    assert raw == jcodec._py_encode(value) == jcodec.encode(value)
    assert codec.decode(raw) == _tuples(value)


@pytest.mark.parametrize("raw", [b"", b"L\x05I\x00", b"B\x09ab", b"X", b"I\x00I\x00",
                                 b"L" + b"\xff" * 10, b"D\x02I\x00"])
def test_codec_rejects_what_the_jax_codec_rejects(raw):
    with pytest.raises(ValueError):
        jcodec._py_decode(raw)
    with pytest.raises(ValueError):
        codec.decode(raw)


# -- BLS12-381 ---------------------------------------------------------------


def test_pairing_checks_equal_the_jax_pure_python_checks():
    """The port's pure oracles (`_py_*`) against the JAX package's, and the
    dispatched (native) checks against both."""
    a, b_ = 35, 11
    p1, q1 = bls._py_multiply(bls.G1, a), bls._py_multiply(bls.G2, b_)
    jp1, jq1 = jbls._py_multiply(jbls.G1, a), jbls._py_multiply(jbls.G2, b_)
    for k in (a * b_, a * b_ + 1):
        p2, jp2 = bls._py_multiply(bls.G1, k), jbls._py_multiply(jbls.G1, k)
        got = bls._py_pairing_check_eq(p1, q1, p2, bls.G2)
        assert got == jbls._py_pairing_check_eq(jp1, jq1, jp2, jbls.G2) == (k == a * b_)
        assert bls.pairing_check_eq(p1, q1, p2, bls.G2) == got
    pairs = [(bls.neg(bls._py_multiply(bls.G1, 6)), bls.G2),
             (bls._py_multiply(bls.G1, 2), bls._py_multiply(bls.G2, 3))]
    jpairs = [(jbls.neg(jbls._py_multiply(jbls.G1, 6)), jbls.G2),
              (jbls._py_multiply(jbls.G1, 2), jbls._py_multiply(jbls.G2, 3))]
    assert bls._py_pairing_product_check(pairs) and jbls._py_pairing_product_check(jpairs)
    assert bls.pairing_product_check(pairs)
    pairs[1] = (bls._py_multiply(bls.G1, 3), bls._py_multiply(bls.G2, 3))
    assert not bls._py_pairing_product_check(pairs) and not bls.pairing_product_check(pairs)


@pytest.mark.parametrize("field", ["FQ2", "FQ12"])
def test_square_and_power_equal_the_jax_products(field):
    rng = random.Random(field)
    cls, jcls = getattr(bls, field), getattr(jbls, field)
    for zeros in (0, 1, cls.degree - 1):
        c = [rng.randrange(bls.P) for _ in range(cls.degree)]
        for i in rng.sample(range(cls.degree), zeros):
            c[i] = 0
        e = rng.randrange(-2**80, 2**80)
        assert cls(c).square().coeffs == (jcls(c) * jcls(c)).coeffs
        assert (cls(c) ** e).coeffs == (jcls(c) ** e).coeffs


def test_final_exponentiation_equals_the_jax_one_and_its_cube_shortcut():
    f = bls.miller_loop(bls.twist(bls._py_multiply(bls.G2, 7)), bls.cast_g1_to_fq12(bls._py_multiply(bls.G1, 5)))
    jf = jbls.miller_loop(jbls.twist(jbls._py_multiply(jbls.G2, 7)),
                          jbls.cast_g1_to_fq12(jbls._py_multiply(jbls.G1, 5)))
    assert f.coeffs == jf.coeffs
    e = bls.final_exponentiation(f)
    assert e.coeffs == jbls.final_exponentiation(jf).coeffs
    assert bls.final_exponentiation(f * f * f) == e * e * e


def test_hashes_and_subgroup_checks_equal_the_jax_ones():
    for msg in (b"", b"abc", bytes(range(100))):
        assert bls.hash_to_fr(msg) == jbls.hash_to_fr(msg)
        assert bls.hash_to_fr(msg, b"D") == jbls.hash_to_fr(msg, b"D")
    h = bls.hash_to_g2(b"coin")
    assert bls.hash_to_g2(b"coin") is h  # the digest cache
    assert affine(h) == jaffine(jbls._py_hash_to_g2(b"coin"))
    assert affine(bls._py_hash_to_g2(b"coin")) == affine(h)
    assert bls.in_g1_subgroup(bls.multiply(bls.G1, 9)) and bls.in_g2_subgroup(h)
    # an on-curve G1 point of the cofactor part: x = 0 is not in the subgroup
    y = (bls.FQ(0) * bls.FQ(0) * bls.FQ(0) + bls.B1).sqrt()
    off = (bls.FQ(0), y, bls.FQ(1))
    assert bls.is_on_curve(off, bls.B1)
    assert bls.in_g1_subgroup(off) is False
    assert jbls.in_g1_subgroup((jbls.FQ(0), jbls.FQ(y.n), jbls.FQ(1))) is False
    with pytest.raises(ValueError, match="subgroup"):
        bls.g1_from_bytes(bls.g1_to_bytes(off))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_mul_sub_equals_the_plain_ladder(group):
    """The subgroup ladder against the JAX package's pure-Python ladder, at
    the edge scalars and random ones, reduced mod r and negative."""
    rng = random.Random(7)
    base = bls.multiply(bls.G1, 99) if group == "g1" else bls.hash_to_g2(b"mul_sub")
    jbase = jbls._py_multiply(jbls.G1, 99) if group == "g1" else jbls._py_hash_to_g2(b"mul_sub")
    scalars = [0, 1, 2, bls.R - 1, bls.R, bls.R + 5, -3, 2**128, 2**64 - 1, 2**192 + 1]
    for k in scalars + [rng.randrange(bls.R) for _ in range(3)]:
        assert affine(bls.mul_sub(base, k)) == jaffine(jbls._py_multiply(jbase, k)), k
    assert bls.is_inf(bls.mul_sub(bls.infinity(type(base[0])), 5))


def test_deserialization_equals_the_jax_one():
    rng = random.Random(5)
    for _ in range(3):
        k = rng.randrange(1, bls.R)
        g1 = jbls.g1_to_bytes(jbls._py_multiply(jbls.G1, k))
        g2 = jbls.g2_to_bytes(jbls._py_multiply(jbls.G2, k))
        assert affine(bls.g1_from_bytes(g1)) == jaffine(jbls.g1_from_bytes(g1))
        assert affine(bls.g2_from_bytes(g2)) == jaffine(jbls.g2_from_bytes(g2))
        assert bls.g1_to_bytes(bls.g1_from_bytes(g1)) == g1
        assert bls.g2_to_bytes(bls.g2_from_bytes(g2)) == g2
    assert bls.is_inf(bls.g1_from_bytes(bytes([0xC0]) + bytes(47)))
    assert bls.is_inf(bls.g2_from_bytes(bytes([0xC0]) + bytes(95)))
    for raw in (b"\x00" * 47, b"\x80" + b"\xff" * 47):
        with pytest.raises(ValueError):
            jbls.g1_from_bytes(raw)
        with pytest.raises(ValueError):
            bls.g1_from_bytes(raw)


# -- threshold keys across the packages -------------------------------------


def test_trusted_setup_equals_the_jax_one_byte_for_byte():
    ids, nets, id_sks = network.trusted_setup(7, 3)
    jids, jnets, jid_sks = jnet.trusted_setup(7, 3)
    assert ids == jids
    assert nets[ids[0]].pk_set.to_bytes() == jnets[ids[0]].pk_set.to_bytes()
    for nid in ids:
        assert nets[nid].sk_share.scalar == jnets[nid].sk_share.scalar
        assert nets[nid].node_ids == jnets[nid].node_ids
        assert id_sks[nid].to_bytes() == jid_sks[nid].to_bytes()
    assert th.PublicKeySet.from_bytes(jnets[ids[0]].pk_set.to_bytes()) == nets[ids[0]].pk_set


def test_jax_keys_ciphertexts_and_shares_are_accepted_by_the_port():
    jsks = jth.SecretKeySet.random(1, random.Random(9))
    pk_set = th.PublicKeySet.from_bytes(jsks.public_keys().to_bytes())
    sks = th.SecretKeySet(jsks.coeffs)
    assert pk_set == sks.public_keys()
    jct = jsks.public_keys().public_key().encrypt(b"across the packages", random.Random(1))
    ct = th.Ciphertext.from_bytes(jct.to_bytes())
    assert ct.verify() and ct.to_bytes() == jct.to_bytes()
    # the same rng gives the same ciphertext
    assert pk_set.public_key().encrypt(b"across the packages", random.Random(1)) == ct
    shares = {i: th.DecryptionShare.from_bytes(jsks.secret_key_share(i).decrypt_share(jct).to_bytes())
              for i in (0, 2)}
    for i, s in shares.items():
        assert pk_set.public_key_share(i).verify_decryption_share(s, ct)
    assert not pk_set.public_key_share(1).verify_decryption_share(shares[0], ct)
    assert pk_set.decrypt(shares, ct) == b"across the packages"
    assert sks.secret_key().decrypt(ct) == b"across the packages"
    sig_shares = {i: th.SignatureShare.from_bytes(jsks.secret_key_share(i).sign_share(b"doc").to_bytes())
                  for i in (1, 3)}
    assert pk_set.verify_signature_share(1, sig_shares[1], b"doc")
    assert not pk_set.verify_signature_share(3, sig_shares[1], b"doc")
    sig = pk_set.combine_signatures(sig_shares)
    assert sig.to_bytes() == jsks.secret_key().sign(b"doc").to_bytes()
    assert pk_set.public_key().verify(sig, b"doc") and not pk_set.public_key().verify(sig, b"dog")
    assert sig.parity() == jth.Signature.from_bytes(sig.to_bytes()).parity()
    sk = th.SecretKey.from_bytes(jth.SecretKey.random(random.Random(4)).to_bytes())
    assert sk.sign(b"m").to_bytes() == jth.SecretKey(sk.scalar).sign(b"m").to_bytes()
    assert th.PublicKey.from_bytes(sk.public_key().to_bytes()) == sk.public_key()
    pts = {x: th.poly_eval(sks.coeffs, x) for x in (2, 5)}
    assert th.poly_interpolate_at_zero(pts) == jth.poly_interpolate_at_zero(pts) == sks.coeffs[0]
    assert "redacted" in repr(sk) and "redacted" in repr(sks)


# -- the cores, message for message -----------------------------------------


def _enc_step(step):
    return ([(tm.target.kind, sorted(tm.target.nodes), codec.encode(tm.message)) for tm in step.messages],
            [(f.node_id, f.kind) for f in step.fault_log])


def drive(pkg, ids, instances, starts, adversary, seed):
    """Run the cores over the package's own router (shuffled, seeded);
    return the trace of every delivery and every output."""
    trace = []

    def handle(me, sender, msg):
        step = instances[me].handle_message(sender, msg)
        trace.append((me, sender, codec.encode(msg), _enc_step(step), codec.encode(list(step.output))))
        return step

    rt = pkg["router"].Router(ids, handle, adversary=adversary, seed=seed, shuffle=True)
    for nid, step in starts:
        trace.append((nid, "start", _enc_step(step), codec.encode(list(step.output))))
        rt.dispatch_step(nid, step)
    rt.run()
    return trace, [(s, f.kind) for s, f in rt.faults]


def _netinfos(pkg, n, seed=0):
    ids, nets, _ = pkg["net"].trusted_setup(n, seed)
    return ids, nets


def corrupt_one_echo(kind, sender):
    """An adversary flipping the shard of `sender`'s echoes of `kind`."""
    def adv(s, r, m):
        inner = m
        if s == sender and isinstance(inner, tuple) and inner[0] == kind:
            payload = list(inner[1])
            slot = 0 if kind == "bc_echo" else 1
            shard = bytearray(payload[slot])
            shard[0] ^= 0x5A
            payload[slot] = bytes(shard)
            return [(s, r, (kind, tuple(payload)))]
        return None
    return adv


@pytest.mark.parametrize("variant,kind", [("bracha", "bc_echo"), ("lowcomm", "bc_echo_lc")])
@pytest.mark.parametrize("seed", [0, 5])
def test_broadcast_with_a_corrupted_shard_equals_the_jax_core(variant, kind, seed):
    payload = bytes(range(200)) * 2
    out = []
    for pkg in (JAX, PORT):
        ids, nets = _netinfos(pkg, 7)
        inst = {i: pkg["bc"].Broadcast(nets[i], ids[1], engine=pkg["eng"], variant=variant) for i in ids}
        trace, faults = drive(pkg, ids, inst, [(ids[1], inst[ids[1]].broadcast(payload))],
                              corrupt_one_echo(kind, ids[4]), seed)
        assert all(inst[i].payload == payload for i in ids)
        out.append((trace, faults))
    assert out[0] == out[1]
    assert any("broadcast: invalid" in k for _s, k in out[1][1])


@pytest.mark.parametrize("seed", [0, 3])
def test_binary_agreement_on_the_hash_coin_equals_the_jax_core(seed):
    out = []
    for pkg in (JAX, PORT):
        ids, nets = _netinfos(pkg, 4)
        inst = {i: pkg["ba"].BinaryAgreement(nets[i], b"ba-test", coin_mode="hash", engine=pkg["eng"])
                for i in ids}
        starts = [(i, inst[i].propose(bool(k % 2))) for k, i in enumerate(ids)]
        trace, faults = drive(pkg, ids, inst, starts, None, seed)
        out.append((trace, faults, [inst[i].decision for i in ids]))
    assert out[0] == out[1]
    assert len(set(out[1][2])) == 1 and out[1][2][0] is not None


def test_threshold_decrypt_with_a_bad_share_equals_the_jax_core():
    out = []
    for pkg, thm, blsm in ((JAX, jth, jbls), (PORT, th, bls)):
        ids, nets = _netinfos(pkg, 4, seed=2)
        ct = nets[ids[0]].pk_set.public_key().encrypt(b"decrypt me", random.Random(8))
        bad = blsm.g1_to_bytes(blsm.multiply(blsm.G1, 12345))

        def adv(s, r, m):
            if s == ids[3] and m[0] == "td_share":
                return [(s, r, ("td_share", bad))]
            return None

        inst = {i: pkg["td"].ThresholdDecrypt(nets[i], verify_shares=True, engine=pkg["eng"]) for i in ids}
        starts = [(i, inst[i].set_ciphertext(thm.Ciphertext.from_bytes(ct.to_bytes()))) for i in ids]
        trace, faults = drive(pkg, ids, inst, starts, adv, 1)
        out.append((trace, faults, [inst[i].plaintext for i in ids]))
    assert out[0] == out[1]
    assert ("threshold_decrypt: invalid share" in [k for _s, k in out[1][1]])
    assert out[1][2] == [b"decrypt me"] * 4


# -- the host engine's per-item entries -------------------------------------


def test_cpu_engine_entries_equal_the_jax_cpu_engine():
    host, jhost = engine.get_engine("cpu"), jengine.CpuEngine()
    payload = bytes(range(251)) * 3
    shards = host.rs_encode_bytes(payload, 3, 4)
    assert shards == jhost.rs_encode_bytes(payload, 3, 4)
    slots = [None, shards[1], None, shards[3], None, None, shards[6]]
    assert host.rs_reconstruct_data(slots, 3, 4) == jhost.rs_reconstruct_data(slots, 3, 4) == payload
    with pytest.raises(ValueError):
        host.rs_reconstruct_data([None] * 5 + shards[5:], 3, 4)
    assert host.homhash_batch(shards, b"s") == jhost.homhash_batch(shards, b"s")

    jsks = jth.SecretKeySet.random(2, random.Random(6))
    jpks = jsks.public_keys()
    pks = th.PublicKeySet.from_bytes(jpks.to_bytes())
    sks = th.SecretKeySet(jsks.coeffs)
    ct = host.encrypt(pks.public_key(), b"engine", random.Random(2))
    assert ct.to_bytes() == jhost.encrypt(jpks.public_key(), b"engine", random.Random(2)).to_bytes()
    jct = jth.Ciphertext.from_bytes(ct.to_bytes())
    idx = [0, 1, 2, 3]
    dshares = [host.decrypt_share(sks.secret_key_share(i), ct) for i in idx]
    jdshares = [jhost.decrypt_share(jsks.secret_key_share(i), jct) for i in idx]
    assert [s.to_bytes() for s in dshares] == [s.to_bytes() for s in jdshares]
    pk_shares = [pks.public_key_share(i) for i in idx]
    jpk_shares = [jpks.public_key_share(i) for i in idx]
    assert host.verify_decryption_share(pk_shares[1], dshares[1], ct)
    dshares[2] = th.DecryptionShare(bls.multiply(bls.G1, 77))
    jdshares[2] = jth.DecryptionShare.from_bytes(dshares[2].to_bytes())
    want = jhost.verify_decryption_shares_batch(jpk_shares, jdshares, jct)
    assert host.verify_decryption_shares_batch(pk_shares, dshares, ct) == want == [True, True, False, True]
    assert host.combine_decryption_shares(pks, {0: dshares[0], 1: dshares[1], 3: dshares[3]}, ct) == b"engine"
    parts = [b"a", b"bc", b"def"]
    assert host._rlc_coeffs(parts, 3) == jhost._rlc_coeffs(parts, 3)

    doc = b"engine-doc"
    sshares = [host.sign_share(sks.secret_key_share(i), doc) for i in idx]
    jsshares = [jhost.sign_share(jsks.secret_key_share(i), doc) for i in idx]
    assert [s.to_bytes() for s in sshares] == [s.to_bytes() for s in jsshares]
    assert host.verify_signature_share(pks, 0, sshares[0], doc)
    sshares[1] = jsshares[1] = None
    sshares[1] = th.SignatureShare(bls.multiply(bls.G2, 5))
    jsshares[1] = jth.SignatureShare.from_bytes(sshares[1].to_bytes())
    want = jhost.verify_signature_shares_batch(jpks, idx, jsshares, doc)
    assert host.verify_signature_shares_batch(pks, idx, sshares, doc) == want == [True, False, True, True]
    sig = host.combine_signature_shares(pks, {0: sshares[0], 2: sshares[2], 3: sshares[3]})
    assert sig.to_bytes() == jsks.secret_key().sign(doc).to_bytes()
    sk = th.SecretKey(sks.coeffs[0])
    assert host.sign(sk, doc) == sig
    assert host.verify(pks.public_key(), sig, doc) and host.verify(pks.public_key(), sig, doc)
    assert not host.verify(pks.public_key(), sig, b"other")
    assert host.verify_signature_shares_batch(pks, [], [], doc) == []
    assert host.verify_decryption_shares_batch([], [], ct) == []
