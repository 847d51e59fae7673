"""Node identifiers and address newtypes.

Mirrors the reference's `Uid` (UUIDv4 node id, lib.rs:148-180) and the
`InAddr`/`OutAddr` newtypes (lib.rs:187-218) with idiomatic Python types.
"""
from __future__ import annotations

import uuid
from dataclasses import dataclass
from functools import total_ordering


@total_ordering
class Uid:
    """128-bit random node identifier (UUIDv4), ordered and hashable."""

    __slots__ = ("bytes",)

    def __init__(self, raw: bytes | None = None):
        if raw is None:
            raw = uuid.uuid4().bytes
        if len(raw) != 16:
            raise ValueError("Uid requires 16 bytes")
        object.__setattr__(self, "bytes", bytes(raw))

    @classmethod
    def from_hex(cls, s: str) -> "Uid":
        return cls(bytes.fromhex(s.replace("-", "")))

    def hex(self) -> str:
        return self.bytes.hex()

    def __repr__(self) -> str:
        return f"Uid({str(uuid.UUID(bytes=self.bytes))})"

    def __str__(self) -> str:
        return str(uuid.UUID(bytes=self.bytes))

    def __eq__(self, other) -> bool:
        return isinstance(other, Uid) and self.bytes == other.bytes

    def __lt__(self, other) -> bool:
        if not isinstance(other, Uid):
            return NotImplemented
        return self.bytes < other.bytes

    def __hash__(self) -> int:
        return hash(self.bytes)


@dataclass(frozen=True, order=True)
class InAddr:
    """The address a node listens on (bind address)."""

    host: str
    port: int

    def __str__(self) -> str:
        return f"{self.host}:{self.port}"


@dataclass(frozen=True, order=True)
class OutAddr:
    """The remote address of an accepted/dialled socket."""

    host: str
    port: int

    def __str__(self) -> str:
        return f"{self.host}:{self.port}"


def parse_addr(s: str, cls=InAddr):
    host, _, port = s.rpartition(":")
    return cls(host or "127.0.0.1", int(port))
