"""Toy SHA-256 proof-of-work blockchain — API-parity sidecar.

The reference ships a vestigial PoW chain (src/blockchain.rs:12-14,
42-70, 90-193) exported from its crate root (lib.rs:93) but never wired
into consensus; only a dead `mine()` demo (peer_node.rs:81-92) and one
(broken) test use it.  We keep the same surface — `Block`, `Blockchain`,
`MiningError` — with a working test, and the same knobs: difficulty =
4 leading zero hex digits, nonce capped at 1e6 attempts.
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import Iterator, List, Optional

DIFFICULTY_HEX_ZEROS = 4  # blockchain.rs:12
MAX_NONCE = 1_000_000  # blockchain.rs:14


class MiningError(Exception):
    """Raised when no nonce under MAX_NONCE satisfies the difficulty
    (blockchain.rs MiningError::Iteration) or a block is malformed."""


@dataclass
class Block:
    index: int
    timestamp: float
    prev_hash: str
    data: bytes
    nonce: int = 0
    hash: str = ""

    def calculate_hash(self, nonce: Optional[int] = None) -> str:
        """blockchain.rs:42-53: hash over (index, timestamp, prev, data, nonce)."""
        n = self.nonce if nonce is None else nonce
        h = hashlib.sha256()
        h.update(str(self.index).encode())
        h.update(repr(self.timestamp).encode())
        h.update(self.prev_hash.encode())
        h.update(bytes(self.data))
        h.update(str(n).encode())
        return h.hexdigest()

    def mine(self) -> "Block":
        """blockchain.rs:56-70: scan nonces until the difficulty is met."""
        target = "0" * DIFFICULTY_HEX_ZEROS
        for nonce in range(MAX_NONCE):
            digest = self.calculate_hash(nonce)
            if digest.startswith(target):
                self.nonce = nonce
                self.hash = digest
                return self
        raise MiningError(f"no nonce under {MAX_NONCE} met difficulty")

    @classmethod
    def genesis(cls) -> "Block":
        """blockchain.rs:90-101: fixed-content first block."""
        block = cls(0, 0.0, "0" * 64, b"genesis")
        return block.mine()

    def is_valid_successor(self, prev: "Block") -> bool:
        return (
            self.index == prev.index + 1
            and self.prev_hash == prev.hash
            and self.hash == self.calculate_hash()
            and self.hash.startswith("0" * DIFFICULTY_HEX_ZEROS)
        )


class Blockchain:
    """blockchain.rs:104-193: an in-memory chain with PoW append."""

    def __init__(self):
        self.blocks: List[Block] = [Block.genesis()]

    def add_block(self, data: bytes) -> Block:
        prev = self.blocks[-1]
        block = Block(prev.index + 1, time.time(), prev.hash, bytes(data))
        block.mine()
        self.blocks.append(block)
        return block

    def traverse(self) -> Iterator[Block]:
        """blockchain.rs traverse(): newest to oldest, validating links."""
        for i in range(len(self.blocks) - 1, -1, -1):
            block = self.blocks[i]
            if i > 0 and not block.is_valid_successor(self.blocks[i - 1]):
                raise MiningError(f"invalid link at height {i}")
            yield block

    @property
    def height(self) -> int:
        return len(self.blocks)


def mine(n_blocks: int = 3) -> Blockchain:
    """The reference's dead demo (peer_node.rs:81-92), kept runnable."""
    chain = Blockchain()
    for i in range(n_blocks):
        chain.add_block(f"block {i + 1}".encode())
    list(chain.traverse())
    return chain
