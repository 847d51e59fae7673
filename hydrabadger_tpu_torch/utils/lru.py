"""Bounded digest-keyed LRU for the crypto caches (the hash onto G2, the
verified-frame verdicts).  Keys are small digests, never message bodies,
so memory stays bounded at `maxsize` entries."""
from __future__ import annotations

from collections import OrderedDict
from typing import Generic, Optional, TypeVar

V = TypeVar("V")


class DigestLRU(Generic[V]):
    __slots__ = ("_d", "maxsize")

    def __init__(self, maxsize: int):
        self._d: "OrderedDict[bytes, V]" = OrderedDict()
        self.maxsize = maxsize

    def get(self, key: bytes) -> Optional[V]:
        v = self._d.get(key)
        if v is not None:
            self._d.move_to_end(key)
        return v

    def put(self, key: bytes, value: V) -> None:
        self._d[key] = value
        if len(self._d) > self.maxsize:
            self._d.popitem(last=False)

    def clear(self) -> None:
        self._d.clear()

    def __len__(self) -> int:
        return len(self._d)
