"""Deterministic binary codec for consensus messages and signing.

The port's copy of hydrabadger_tpu/utils/codec.py: every message is
serialised to a canonical byte string, so two engines produce identical
bytes for identical values.  Two twins write the same bytes: the pure
Python below (`_py_encode` / `_py_decode`, the oracle) and the C twin,
native/hb_codec.c, a CPython extension that utils/host_native builds
against this interpreter's headers into build/host_native/.  `encode` and
`decode` bind at their first call: the C twin, after a self-check against
the Python twin, or the Python twin where HB_NATIVE_CODEC is set to
anything but "1".  A twin that does not build, load or pass the check
raises; the JAX package drops it quietly instead.

Self-describing tagged format, canonical by construction:
  N            -> None
  T / F        -> True / False
  I <zigzag>   -> int (arbitrary precision, zigzag + LEB128)
  B <len> ...  -> bytes
  S <len> ...  -> str (UTF-8)
  L <n> items  -> list / tuple (decoded as tuple)
  D <n> k v..  -> dict, entries sorted by encoded key bytes
"""
from __future__ import annotations

import os
from typing import Any

from . import host_native

# both packages reject the same adversarial nesting with the same error
_MAX_DEPTH = 500


def _write_uvarint(out: bytearray, n: int) -> None:
    if n < 0:
        raise ValueError("uvarint must be non-negative")
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_uvarint(buf: bytes, pos: int) -> tuple[int, int]:
    shift = 0
    result = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _encode_into(out: bytearray, value: Any, depth: int = 0) -> None:
    if depth > _MAX_DEPTH:
        raise ValueError("codec nesting too deep")
    if value is None:
        out.append(ord("N"))
    elif value is True:
        out.append(ord("T"))
    elif value is False:
        out.append(ord("F"))
    elif isinstance(value, int):
        out.append(ord("I"))
        _write_uvarint(out, (value << 1) if value >= 0 else ((-value << 1) - 1))
    elif isinstance(value, (bytes, bytearray, memoryview)):
        raw = bytes(value)
        out.append(ord("B"))
        _write_uvarint(out, len(raw))
        out += raw
    elif isinstance(value, str):
        raw = value.encode("utf-8")
        out.append(ord("S"))
        _write_uvarint(out, len(raw))
        out += raw
    elif isinstance(value, (list, tuple)):
        out.append(ord("L"))
        _write_uvarint(out, len(value))
        for item in value:
            _encode_into(out, item, depth + 1)
    elif isinstance(value, dict):
        out.append(ord("D"))
        _write_uvarint(out, len(value))
        entries = []
        for k, v in value.items():
            kb = bytearray()
            _encode_into(kb, k, depth + 1)
            vb = bytearray()
            _encode_into(vb, v, depth + 1)
            entries.append((bytes(kb), bytes(vb)))
        entries.sort(key=lambda e: e[0])
        for kb, vb in entries:
            out += kb
            out += vb
    else:
        raise TypeError(f"codec cannot encode {type(value).__name__}")


def _py_encode(value: Any) -> bytes:
    out = bytearray()
    _encode_into(out, value)
    return bytes(out)


def _decode_at(buf: bytes, pos: int, depth: int = 0) -> tuple[Any, int]:
    if depth > _MAX_DEPTH:
        raise ValueError("codec nesting too deep")
    if pos >= len(buf):
        raise ValueError("truncated value")
    tag = buf[pos]
    pos += 1
    if tag == ord("N"):
        return None, pos
    if tag == ord("T"):
        return True, pos
    if tag == ord("F"):
        return False, pos
    if tag == ord("I"):
        zz, pos = _read_uvarint(buf, pos)
        return (zz >> 1) if not zz & 1 else -((zz + 1) >> 1), pos
    if tag == ord("B"):
        n, pos = _read_uvarint(buf, pos)
        if pos + n > len(buf):
            raise ValueError("truncated bytes")
        return buf[pos : pos + n], pos + n
    if tag == ord("S"):
        n, pos = _read_uvarint(buf, pos)
        if pos + n > len(buf):
            raise ValueError("truncated str")
        return buf[pos : pos + n].decode("utf-8"), pos + n
    if tag == ord("L"):
        n, pos = _read_uvarint(buf, pos)
        # every element costs >= 1 byte: a count beyond the buffer is
        # malformed, rejected before the loop runs
        if n > len(buf) - pos:
            raise ValueError("truncated list")
        items = []
        for _ in range(n):
            item, pos = _decode_at(buf, pos, depth + 1)
            items.append(item)
        return tuple(items), pos
    if tag == ord("D"):
        n, pos = _read_uvarint(buf, pos)
        if 2 * n > len(buf) - pos:  # >= 2 bytes per entry
            raise ValueError("truncated dict")
        out = {}
        for _ in range(n):
            k, pos = _decode_at(buf, pos, depth + 1)
            v, pos = _decode_at(buf, pos, depth + 1)
            out[k] = v
        return out, pos
    raise ValueError(f"unknown tag byte {tag!r}")


def _py_decode(buf: bytes) -> Any:
    value, pos = _decode_at(bytes(buf), 0)
    if pos != len(buf):
        raise ValueError(f"{len(buf) - pos} trailing bytes")
    return value


_native = None  # the loaded C twin, once bound to it
_bound = False


def load_native():
    """The C twin's module, built and loaded, after the JAX package's
    self-check against the Python twin; raises if any step fails."""
    import importlib.util

    path = host_native.CODEC.build()
    spec = importlib.util.spec_from_file_location("hb_codec", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    probe = (1, -(2**381), b"x", "s", {3: (None, True)}, 2**64)
    if mod.encode(probe) != _py_encode(probe) or mod.decode(mod.encode(probe)) != probe:
        raise RuntimeError(f"codec C twin {path} failed its self-check against the Python twin")
    return mod


def _bind() -> None:
    """Point `encode` / `decode` at the selected twin."""
    global _native, _bound, encode, decode
    _native = load_native() if os.environ.get("HB_NATIVE_CODEC", "1") == "1" else None
    encode, decode = (_native.encode, _native.decode) if _native else (_py_encode, _py_decode)
    _bound = True


def encode(value: Any) -> bytes:
    if not _bound:
        _bind()
    return encode(value)


def decode(buf: bytes) -> Any:
    if not _bound:
        _bind()
    return decode(buf)


def native_active() -> bool:
    """True when `encode` / `decode` are the C twin's (binding them first)."""
    if not _bound:
        _bind()
    return _native is not None
