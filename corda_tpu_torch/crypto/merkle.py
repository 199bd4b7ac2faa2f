"""Merkle trees, host side (copy of ``MerkleTree`` in
corda_tpu/crypto/merkle.py).

Capability parity with the reference's ``MerkleTree`` (core/.../crypto/
MerkleTree.kt:15-60): leaf lists are zero-hash padded to a power of two and
parents are SHA-256(left || right). Partial (tear-off) trees come with the
slice that first reads a filtered transaction.

The batched tree hash on the card (every level of a cohort's trees in one
kernel launch, the trees reducing together) is ``ops/txid.py`` over kernel
D; this module is the host reference it is tested against.
"""

from __future__ import annotations

import dataclasses

from .hashing import SecureHash, ZERO_HASH, sha256


class MerkleTreeError(Exception):
    pass


def _pad_to_pow2(leaves: list[SecureHash]) -> list[SecureHash]:
    if not leaves:
        raise MerkleTreeError("cannot build a Merkle tree with no leaves")
    n = 1
    while n < len(leaves):
        n <<= 1
    return list(leaves) + [ZERO_HASH] * (n - len(leaves))


@dataclasses.dataclass(frozen=True)
class MerkleTree:
    """A full Merkle tree; ``levels[0]`` is the padded leaf row, ``levels[-1]``
    the single-root row."""

    levels: tuple

    @property
    def root(self) -> SecureHash:
        return self.levels[-1][0]

    @property
    def leaves(self) -> tuple:
        return self.levels[0]

    @staticmethod
    def build(leaves: list[SecureHash]) -> "MerkleTree":
        row = _pad_to_pow2(leaves)
        levels = [tuple(row)]
        while len(row) > 1:
            row = [row[i].hash_concat(row[i + 1]) for i in range(0, len(row), 2)]
            levels.append(tuple(row))
        return MerkleTree(tuple(levels))


__all__ = [
    "MerkleTree",
    "MerkleTreeError",
    "sha256",
    "SecureHash",
]
