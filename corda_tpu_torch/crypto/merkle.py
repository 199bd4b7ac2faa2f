"""Merkle trees and partial (tear-off) trees, host side (copy of
corda_tpu/crypto/merkle.py).

Capability parity with the reference's ``MerkleTree`` (core/.../crypto/
MerkleTree.kt:15-60): leaf lists are zero-hash padded to a power of two and
parents are SHA-256(left || right). A ``PartialMerkleTree`` proves a subset
of leaves against the root (the reference's PartialMerkleTree.kt), for
``ledger/filtered.py``'s tear-offs.

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


@dataclasses.dataclass(frozen=True)
class PartialMerkleTree:
    """A Merkle proof for a subset of leaf positions.

    ``included`` maps leaf index -> leaf hash; ``branch_hashes`` lists the
    interior/leaf hashes for the pruned subtrees in deterministic
    (level-major, left-to-right) order; ``leaf_count`` is the padded width.
    """

    leaf_count: int
    included: tuple            # tuple of (index, SecureHash)
    branch_hashes: tuple       # tuple of SecureHash

    @staticmethod
    def build(tree: MerkleTree, include_indices: list[int]) -> "PartialMerkleTree":
        width = len(tree.leaves)
        inc = sorted(set(include_indices))
        for i in inc:
            if not (0 <= i < width):
                raise MerkleTreeError(f"leaf index {i} out of range 0..{width - 1}")
        if not inc:
            raise MerkleTreeError("partial tree must include at least one leaf")
        # Walk levels bottom-up; at each level record sibling hashes of the
        # frontier that are not themselves derivable from included leaves.
        needed: list[SecureHash] = []
        frontier = set(inc)
        for level in range(len(tree.levels) - 1):
            row = tree.levels[level]
            next_frontier = set()
            for i in sorted(frontier):
                sib = i ^ 1
                if sib not in frontier:
                    needed.append(row[sib])
                next_frontier.add(i // 2)
            frontier = next_frontier
        return PartialMerkleTree(
            leaf_count=width,
            included=tuple((i, tree.leaves[i]) for i in inc),
            branch_hashes=tuple(needed),
        )

    def compute_root(self) -> SecureHash:
        """Recompute the root from included leaves + branch hashes.

        Raises MerkleTreeError if the proof shape is inconsistent.
        """
        if self.leaf_count < 1 or (self.leaf_count & (self.leaf_count - 1)):
            raise MerkleTreeError("leaf_count must be a power of two")
        if not self.included:
            raise MerkleTreeError("no included leaves")
        known: dict[int, SecureHash] = {}
        for i, h in self.included:
            # Adversarial proofs arrive from the wire: a duplicate index could
            # smuggle an unattested leaf hash past verification (last-wins
            # dict), and out-of-range indices must fail, not crash.
            if not isinstance(i, int) or not (0 <= i < self.leaf_count):
                raise MerkleTreeError(f"leaf index {i} out of range")
            if i in known:
                raise MerkleTreeError(f"duplicate leaf index {i}")
            if not isinstance(h, SecureHash):
                raise MerkleTreeError("included leaf is not a SecureHash")
            known[i] = h
        branch = list(self.branch_hashes)
        for h in branch:
            if not isinstance(h, SecureHash):
                raise MerkleTreeError("branch hash is not a SecureHash")
        width = self.leaf_count
        frontier = sorted(known)
        while width > 1:
            next_known: dict[int, SecureHash] = {}
            next_frontier = []
            for i in frontier:
                if i // 2 in next_known:
                    continue
                sib = i ^ 1
                if sib in known:
                    left = known[min(i, sib)]
                    right = known[max(i, sib)]
                else:
                    if not branch:
                        raise MerkleTreeError("proof exhausted: missing branch hash")
                    sib_hash = branch.pop(0)
                    left, right = (known[i], sib_hash) if i % 2 == 0 else (sib_hash, known[i])
                next_known[i // 2] = left.hash_concat(right)
                next_frontier.append(i // 2)
            known = next_known
            frontier = next_frontier
            width //= 2
        if branch:
            raise MerkleTreeError(f"{len(branch)} unused branch hashes")
        return known[0]

    def verify(self, expected_root: SecureHash) -> bool:
        try:
            return self.compute_root() == expected_root
        except MerkleTreeError:
            return False

    def leaf_hashes(self) -> list[SecureHash]:
        return [h for _, h in self.included]


from ..serialization import register_custom  # noqa: E402

register_custom(
    PartialMerkleTree,
    "crypto.PartialMerkleTree",
    to_fields=lambda t: {
        "leaf_count": t.leaf_count,
        "included": [[i, h] for i, h in t.included],
        "branch_hashes": list(t.branch_hashes),
    },
    from_fields=lambda d: PartialMerkleTree(
        d["leaf_count"],
        tuple((i, h) for i, h in d["included"]),
        tuple(d["branch_hashes"]),
    ),
)


def merkle_root_host(leaves: list[SecureHash]) -> SecureHash:
    """Convenience: root without materialising all levels."""
    return MerkleTree.build(leaves).root


__all__ = [
    "MerkleTree",
    "PartialMerkleTree",
    "MerkleTreeError",
    "merkle_root_host",
    "sha256",
    "SecureHash",
]
