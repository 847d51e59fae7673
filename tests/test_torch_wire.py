"""The port's wire tier against the JAX package's, on the CPU.

Frames byte for byte against hydrabadger_tpu.net.wire for every
`WireMessage` kind, signed and unsigned, each package decoding the other's;
`verify_batch` verdicts and Fiat-Shamir coefficients of the port's
`CpuEngine` and `GpuEngine(device="cpu")` (kernel B2's plain GLV ladder for
the r_i * pk_i terms) equal to the JAX `CpuEngine`'s on a batch with a
forged signature, a duplicate and a cache hit; `_g1_scalar_muls` against
the JAX host engine's; and `CryptoBridge` batches equal to the direct
engine calls."""
import asyncio
import random

import pytest

from hydrabadger_tpu.crypto import bls12_381 as jbls
from hydrabadger_tpu.crypto import engine as jeng
from hydrabadger_tpu.crypto import threshold as jth
from hydrabadger_tpu.net import wire as jwire
from hydrabadger_tpu.utils import ids as jids
from hydrabadger_tpu_torch.crypto import bls12_381 as bls
from hydrabadger_tpu_torch.crypto import engine as teng
from hydrabadger_tpu_torch.crypto import threshold as th
from hydrabadger_tpu_torch.net import wire
from hydrabadger_tpu_torch.net.bridge import CryptoBridge
from hydrabadger_tpu_torch.obs import metrics as M
from hydrabadger_tpu_torch.utils import ids

SK = 0x1234_5678_9ABC_DEF0_1111_2222_3333_4444


def messages(w, th_mod, ids_mod):
    """One message of every wire kind, built with one package's helpers."""
    uid = ids_mod.Uid(bytes(range(16)))
    pk = th_mod.SecretKey(SK).public_key()
    peers = ((bytes(range(16, 32)), "127.0.0.1", 3001, pk.to_bytes()),)
    state = ("awaiting_more_peers", peers)
    return [
        w.hello_request_change_add(uid, "127.0.0.1", 3000, pk),
        w.welcome_received_change_add(uid, "127.0.0.1", 3000, pk, state),
        w.hello_from_validator(uid, "127.0.0.1", 3000, pk, ("generating_keys", peers)),
        w.goodbye(uid),
        w.consensus_message(uid, ("hb", 0, ("bcast", 2, ("echo", b"root", (b"a", b"b"), 7)))),
        w.key_gen_message(uid, ("builtin",), ("part", b"commit", (b"row0", b"row1"))),
        w.WireMessage("join_plan", (1, 4, (b"n0", b"n1"), {b"n0": b"pk"}, b"pkset", b"sess")),
        w.WireMessage("era_transcript_request", 3),
        w.WireMessage("era_transcript", (3, 2, (b"entry",))),
        w.WireMessage("net_state_request", None),
        w.WireMessage("net_state", state),
        w.transaction(b"\x00txn\xff"),
        w.ping(),
        w.pong(),
    ]


def test_every_kind_is_covered_and_the_kinds_agree():
    assert wire.KINDS == jwire.KINDS and wire.VERIFIED_KINDS == jwire.VERIFIED_KINDS
    assert {m.kind for m in messages(wire, th, ids)} == wire.KINDS


async def _recv(w, frame, sk, sign):
    reader = asyncio.StreamReader()
    reader.feed_data(frame)
    reader.feed_eof()
    stream = w.WireStream(reader, None, sk, sign)
    return stream, await stream.recv()


@pytest.mark.parametrize("sign", [False, True], ids=["unsigned", "signed"])
async def test_frames_are_byte_identical_and_cross_decode(sign):
    mine = wire.WireStream(None, None, th.SecretKey(SK), sign)
    theirs = jwire.WireStream(None, None, jth.SecretKey(SK), sign)
    for tm, jm in zip(messages(wire, th, ids), messages(jwire, jth, jids)):
        frame = mine._frame(tm)
        assert frame == theirs._frame(jm), tm.kind
        assert tm.encode() == jm.encode()
        # each package decodes (and verifies) the other's frame
        for w, sk, raw, pk in ((jwire, jth.SecretKey(1), frame, jth.SecretKey(SK).public_key()),
                               (wire, th.SecretKey(1), theirs._frame(jm), th.SecretKey(SK).public_key())):
            stream, (msg, body, sig) = await _recv(w, raw, sk, sign)
            assert msg.kind == tm.kind and w.WireMessage(msg.kind, msg.payload).encode() == tm.encode()
            stream.peer_pk = pk
            assert stream.verify(body, sig) is sign
    with pytest.raises(ValueError):
        wire.WireMessage.decode(jwire.WireMessage("ping", None).encode()[:-1] + b"\x07")


def batch_items(pkg_th):
    """Five keys, five frames; item 2 forged (signed by the wrong key), item 5
    a duplicate of item 0."""
    rng = random.Random(99)
    sks = [pkg_th.SecretKey(rng.randrange(1, bls.R)) for _ in range(5)]
    msgs = [b"frame-%d" % i * (i + 1) for i in range(5)]
    items = [(sk.public_key(), sk.sign(m), m) for sk, m in zip(sks, msgs)]
    items[2] = (items[2][0], sks[3].sign(msgs[2]), msgs[2])
    return items + [items[0]]


def test_verify_batch_and_coefficients_equal_the_jax_engine(monkeypatch):
    want = [True, True, False, True, True, True]
    jitems, titems = batch_items(jth), batch_items(th)
    jeng._VERIFIED_FRAMES.clear()
    seen = {}

    def spy(name, cls):
        orig = cls._g1_scalar_muls

        def wrapped(self, points, scalars):
            out = orig(self, points, scalars)
            seen[name] = (list(scalars), [bls.g1_to_bytes(p) if isinstance(p[0], bls.FQ)
                                          else jbls.g1_to_bytes(p) for p in out])
            return out
        monkeypatch.setattr(cls, "_g1_scalar_muls", wrapped)

    spy("jax", jeng.CpuEngine)
    spy("cpu", teng.CpuEngine)
    spy("gpu", teng.GpuEngine)
    assert jeng.CpuEngine().verify_batch(jitems) == want
    reg = M.default_registry()
    batches = reg.counter(M.VERIFY_DEVICE_BATCHES).value
    lanes = reg.counter(M.VERIFY_DEVICE_LANES).value
    for name, eng in (("cpu", teng.CpuEngine()), ("gpu", teng.GpuEngine(device="cpu"))):
        teng._VERIFIED_FRAMES.clear()
        assert eng.verify_batch(titems) == want, name
        assert seen[name] == seen["jax"], name  # the same r_i, the same r_i * pk_i
        # a cache hit: every verdict from the verified-frame cache, no new batch
        del seen[name]
        assert eng.verify_batch(titems) == want and name not in seen
    assert reg.counter(M.VERIFY_DEVICE_BATCHES).value == batches + 1
    assert reg.counter(M.VERIFY_DEVICE_LANES).value == lanes + len(seen["jax"][0])
    parts = [pk.to_bytes() + sig.to_bytes() for pk, sig, _m in titems]
    assert teng.CpuEngine._rlc_coeffs(parts, 6) == jeng.CpuEngine._rlc_coeffs(parts, 6)
    # one item left after the cache: the plain single verify, no batch
    teng._VERIFIED_FRAMES.clear()
    assert teng.CpuEngine().verify_batch(titems[2:3]) == [False]


def test_gpu_engine_scalar_muls_equal_the_jax_host_engine():
    rng = random.Random(5)
    ks = [rng.randrange(1, bls.R) for _ in range(3)]
    pts = [bls.mul_sub(bls.G1, k) for k in ks]
    rs = [rng.getrandbits(128) | 1 for _ in ks] + [0]
    pts.append(bls.infinity(bls.FQ))
    got = teng.GpuEngine(device="cpu")._g1_scalar_muls(pts, rs)
    jpts = [jbls.g1_from_bytes(bls.g1_to_bytes(p)) for p in pts]
    want = jeng.CpuEngine()._g1_scalar_muls(jpts, rs)
    assert [bls.g1_to_bytes(p) for p in got] == [jbls.g1_to_bytes(p) for p in want]
    assert [bls.g1_to_bytes(p) for p in teng.CpuEngine()._g1_scalar_muls(pts, rs)] == \
        [jbls.g1_to_bytes(p) for p in want]


async def test_crypto_bridge_batches_equal_the_direct_engine_calls():
    items = batch_items(th)
    rng = random.Random(3)
    sk_share = th.SecretKeyShare(rng.randrange(1, bls.R))
    cts = [th.SecretKey(7).public_key().encrypt(b"ct-%d" % i, rng) for i in range(3)]
    engine = teng.get_engine("cpu")
    teng._VERIFIED_FRAMES.clear()
    want_v = engine.verify_batch(items)
    want_d = [s.to_bytes() for s in engine.decrypt_share_batch([(sk_share, ct) for ct in cts])]
    teng._VERIFIED_FRAMES.clear()
    metrics = M.MetricsRegistry()
    bridge = CryptoBridge("cpu", max_delay_ms=5.0, metrics=metrics)
    try:
        got = await asyncio.wait_for(asyncio.gather(
            *[bridge.verify(pk, sig, m) for pk, sig, m in items],
            *[bridge.decrypt_share(sk_share, ct) for ct in cts]), 30)
    finally:
        await bridge.stop()
    assert got[:len(items)] == want_v
    assert [s.to_bytes() for s in got[len(items):]] == want_d
    # one collector pass: one batch per kind
    assert bridge.batches_dispatched == 2 and bridge.requests_served == len(items) + len(cts)
    assert metrics.counter("bridge_requests_served").value == len(items) + len(cts)
    with pytest.raises(RuntimeError, match="stopped"):
        await bridge.verify(*items[0])
