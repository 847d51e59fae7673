"""The port's codec twins (hydrabadger_tpu_torch/utils/codec.py) against the
JAX package's.

The port's C twin (native/hb_codec.c, built into build/host_native/ against
this interpreter's headers) writes the JAX Python twin's bytes on
randomized values and edge integers, decodes to the same values and types,
rejects what it rejects with the same error types, and holds the same depth
limit; it also equals the JAX package's C twin where that is built (JAX
`tests/test_codec.py:104-205`, on the port).  HB_NATIVE_CODEC=0 binds the
Python twin; a twin that fails its build or its self-check raises.
"""
import dataclasses
import random

import pytest

from hydrabadger_tpu.utils import codec as jcodec
from hydrabadger_tpu_torch.utils import codec, host_native


@pytest.fixture(scope="module")
def twin():
    return codec.load_native()


def _randomized_values(seed, n):
    rng = random.Random(seed)

    def rnd(depth=0):
        t = rng.randrange(0, 9 if depth < 4 else 6)
        if t == 0:
            return None
        if t == 1:
            return rng.random() < 0.5
        if t == 2:
            return rng.randrange(-(10**6), 10**6)
        if t == 3:
            sign = 1 if rng.random() < 0.5 else -1
            return sign * rng.getrandbits(rng.randrange(60, 600))
        if t == 4:
            return bytes(rng.randrange(256) for _ in range(rng.randrange(40)))
        if t == 5:
            return "".join(chr(rng.randrange(32, 0x2000)) for _ in range(rng.randrange(20)))
        if t == 6:
            return tuple(rnd(depth + 1) for _ in range(rng.randrange(6)))
        if t == 7:
            return [rnd(depth + 1) for _ in range(rng.randrange(6))]
        return {rng.getrandbits(32): rnd(depth + 1) for _ in range(rng.randrange(5))}

    return [rnd() for _ in range(n)]


EDGE_INTS = [
    0, 1, -1, 63, 64, -64, -65, 2**62 - 1, 2**62, -(2**62), 2**63 - 1, -(2**63), 2**63,
    2**64 - 1, 2**64, -(2**64), 2**100, -(2**100), 2**381 - 1, 2**381, -(2**381), 2**448 - 1,
    2**511,
]
CASES = [None, True, False, b"", "", (), {}, b"\x00" * 300, "é☃", (1, (2, (3, ()))),
         {b"k": [1, 2], "s": {3: None}}]


@pytest.mark.parametrize("seed", [1234, 7])
def test_twin_is_bit_exact_on_randomized_values(twin, seed):
    jtwin = jcodec._native
    for v in _randomized_values(seed, 300) + EDGE_INTS + CASES:
        want = jcodec._py_encode(v)
        assert twin.encode(v) == codec._py_encode(v) == want, v
        assert twin.decode(want) == codec._py_decode(want) == jcodec._py_decode(want)
        if jtwin is not None:
            assert jtwin.encode(v) == want


def test_twin_decode_type_fidelity(twin):
    v = (1, [2, 3], {b"k": "s"}, None, True, b"\x00")
    nd = twin.decode(jcodec._py_encode(v))
    pd = jcodec._py_decode(jcodec._py_encode(v))
    assert nd == pd == codec._py_decode(codec._py_encode(v))
    assert type(nd) is type(pd)
    assert type(nd[1]) is tuple  # lists decode as tuples in both
    assert type(nd[5]) is type(pd[5]) is bytes


@pytest.mark.parametrize("buf", [
    b"", b"Z", b"I", b"B\x05ab", b"L\x02N", b"I\x02\x00",
    b"B\xff\xff\xff\xff\xff\xff\xff\xff\xff\x7f",
])
def test_twin_error_parity(twin, buf):
    for decode in (twin.decode, codec._py_decode, jcodec._py_decode):
        with pytest.raises(ValueError):
            decode(buf)


def test_twin_encode_type_errors(twin):
    for v in [1.5, object(), {1: object()}]:
        for encode in (twin.encode, codec._py_encode, jcodec._py_encode):
            with pytest.raises(TypeError):
                encode(v)


def test_depth_guard_parity(twin):
    deep = b"L\x01" * 600 + b"N"
    for decode in (twin.decode, codec._py_decode, jcodec._py_decode):
        with pytest.raises(ValueError):
            decode(deep)
    ok = b"L\x01" * 400 + b"N"
    assert twin.decode(ok) == codec._py_decode(ok) == jcodec._py_decode(ok)
    nested = None
    for _ in range(600):
        nested = (nested,)
    for encode in (twin.encode, codec._py_encode, jcodec._py_encode):
        with pytest.raises(ValueError):
            encode(nested)


def test_the_bound_twin_and_the_env_switch(monkeypatch):
    try:
        monkeypatch.setenv("HB_NATIVE_CODEC", "1")
        codec._bind()
        assert codec.native_active()
        assert codec.encode((1, b"x")) == jcodec._py_encode((1, b"x"))
        assert codec.encode.__module__ != codec.__name__  # the C twin's builtin
        monkeypatch.setenv("HB_NATIVE_CODEC", "0")
        codec._bind()
        assert not codec.native_active()
        assert codec.encode is codec._py_encode and codec.decode is codec._py_decode
    finally:
        monkeypatch.undo()
        codec._bind()
    assert codec.native_active()
    assert host_native.CODEC.dest.parent == host_native.OUT_DIR


def test_a_failing_build_or_self_check_raises(monkeypatch, tmp_path):
    broken = dataclasses.replace(host_native.CODEC, dest=tmp_path / host_native.CODEC.dest.name)
    monkeypatch.setattr(host_native, "CODEC", broken)
    monkeypatch.setenv("CC", "false")
    with pytest.raises(RuntimeError, match="codec C twin build failed"):
        codec.load_native()
    assert not broken.dest.exists()
    monkeypatch.undo()
    monkeypatch.setattr(codec, "_py_encode", lambda value: b"not the twin's bytes")
    with pytest.raises(RuntimeError, match="self-check"):
        codec.load_native()
