"""SHA-256 Merkle trees over Reed-Solomon shards (Broadcast's proofs).

The port's copy of hydrabadger_tpu/consensus/merkle.py.  hbbft's
Broadcast ships each RS shard with a Merkle branch so receivers can bind
shards to a single root before echoing.  Host SHA-256 via hashlib.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Sequence, Tuple


def _h(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def _leaf_hash(data: bytes) -> bytes:
    return _h(b"\x00" + data)


def _node_hash(left: bytes, right: bytes) -> bytes:
    return _h(b"\x01" + left + right)


@dataclass(frozen=True)
class Proof:
    """A shard plus its authentication path."""

    value: bytes
    index: int
    path: Tuple[bytes, ...]  # sibling hashes, leaf level first
    root: bytes

    def validate(self, n_leaves: int) -> bool:
        if not 0 <= self.index < n_leaves:
            return False
        acc = _leaf_hash(self.value)
        idx = self.index
        for sib in self.path:
            if idx % 2 == 0:
                acc = _node_hash(acc, sib)
            else:
                acc = _node_hash(sib, acc)
            idx //= 2
        return acc == self.root

    def wire(self) -> tuple:
        return (self.value, self.index, tuple(self.path), self.root)

    @classmethod
    def from_wire(cls, w) -> "Proof":
        value, index, path, root = w
        return cls(bytes(value), int(index), tuple(bytes(p) for p in path), bytes(root))


class MerkleTree:
    """Balanced binary tree; odd levels duplicate the last hash."""

    def __init__(self, leaves: Sequence[bytes]):
        if not leaves:
            raise ValueError("MerkleTree needs at least one leaf")
        self.leaves = [bytes(l) for l in leaves]
        self.levels: List[List[bytes]] = [[_leaf_hash(l) for l in self.leaves]]
        while len(self.levels[-1]) > 1:
            cur = self.levels[-1]
            nxt = []
            for i in range(0, len(cur), 2):
                left = cur[i]
                right = cur[i + 1] if i + 1 < len(cur) else cur[i]
                nxt.append(_node_hash(left, right))
            self.levels.append(nxt)

    @property
    def root(self) -> bytes:
        return self.levels[-1][0]

    def proof(self, index: int) -> Proof:
        if not 0 <= index < len(self.leaves):
            raise IndexError(index)
        path = []
        idx = index
        for level in self.levels[:-1]:
            sib = idx + 1 if idx % 2 == 0 else idx - 1
            if sib >= len(level):
                sib = idx  # duplicated odd node
            path.append(level[sib])
            idx //= 2
        return Proof(self.leaves[index], index, tuple(path), self.root)
