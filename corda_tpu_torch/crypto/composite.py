"""Composite keys: weighted threshold trees of public keys (copy of
corda_tpu/crypto/composite.py).

Capability parity with the reference's ``CompositeKey`` (core/.../crypto/
CompositeKey.kt:31-102) and ``CompositeSignature``: a tree whose leaves are
ordinary public keys and whose interior nodes demand that the summed weight
of satisfied children meet a threshold. ``AND(a, b)`` = threshold 2 with unit
weights, ``OR(a, b)`` = threshold 1.

A composite key travels as an ordinary :class:`PublicKey` with scheme id 6
whose ``encoded`` bytes are the CBE encoding of the tree — so vault/identity
code treats it uniformly.
"""

from __future__ import annotations

import dataclasses

from ..serialization import decode, encode

from .keys import PublicKey
from .schemes import COMPOSITE_KEY, CryptoError, is_valid


@dataclasses.dataclass(frozen=True)
class CompositeKeyNode:
    weight: int
    key: "PublicKey | CompositeKey"


@dataclasses.dataclass(frozen=True)
class CompositeKey:
    threshold: int
    children: tuple  # tuple[CompositeKeyNode, ...]

    # -- validation (reference: CompositeKey.checkValidity, :68-102) ---
    def validate(self) -> None:
        if not self.children:
            raise CryptoError("composite key must have children")
        total = 0
        seen = set()
        for node in self.children:
            if node.weight <= 0:
                raise CryptoError("composite key weights must be positive")
            total += node.weight
            # Structural (dataclass) equality: catches duplicate plain keys
            # AND structurally identical composite subtrees, which would let
            # one signer double-count its weight.
            if node.key in seen:
                raise CryptoError("duplicate child key in composite node")
            seen.add(node.key)
            if isinstance(node.key, CompositeKey):
                node.key.validate()
        if not (1 <= self.threshold <= total):
            raise CryptoError(
                f"threshold {self.threshold} outside 1..{total}"
            )

    # -- satisfaction (reference: CompositeKey.isFulfilledBy) ----------
    def is_fulfilled_by(self, signers: set[PublicKey]) -> bool:
        acquired = 0
        for node in self.children:
            child = node.key
            ok = (
                child.is_fulfilled_by(signers)
                if isinstance(child, CompositeKey)
                else child in signers
            )
            if ok:
                acquired += node.weight
                if acquired >= self.threshold:
                    return True
        return False

    def leaf_keys(self) -> set[PublicKey]:
        out: set[PublicKey] = set()
        for node in self.children:
            if isinstance(node.key, CompositeKey):
                out |= node.key.leaf_keys()
            else:
                out.add(node.key)
        return out

    # -- wire form ----------------------------------------------------
    def _to_obj(self):
        return {
            "threshold": self.threshold,
            "children": [
                {
                    "weight": n.weight,
                    "composite": isinstance(n.key, CompositeKey),
                    "key": n.key._to_obj()
                    if isinstance(n.key, CompositeKey)
                    else {"scheme_id": n.key.scheme_id, "encoded": n.key.encoded},
                }
                for n in self.children
            ],
        }

    @staticmethod
    def _from_obj(obj) -> "CompositeKey":
        children = []
        for c in obj["children"]:
            if c["composite"]:
                key = CompositeKey._from_obj(c["key"])
            else:
                key = PublicKey(c["key"]["scheme_id"], c["key"]["encoded"])
            children.append(CompositeKeyNode(c["weight"], key))
        return CompositeKey(obj["threshold"], tuple(children))

    def to_public_key(self) -> PublicKey:
        return PublicKey(COMPOSITE_KEY, encode(self._to_obj()))

    @staticmethod
    def from_public_key(key: PublicKey) -> "CompositeKey":
        """Parse + validate; raises CryptoError on ANY malformed input.

        Composite keys arrive from the wire as ordinary PublicKeys, so the
        decode path must not leak SerializationError/KeyError/TypeError to
        callers expecting CryptoError semantics.
        """
        if key.scheme_id != COMPOSITE_KEY:
            raise CryptoError("not a composite key")
        try:
            ck = CompositeKey._from_obj(decode(key.encoded))
        except CryptoError:
            raise
        except Exception as e:
            raise CryptoError(f"malformed composite key encoding: {e}") from e
        ck.validate()
        return ck


class CompositeKeyBuilder:
    def __init__(self):
        self._children: list[CompositeKeyNode] = []

    def add(self, key: "PublicKey | CompositeKey", weight: int = 1) -> "CompositeKeyBuilder":
        self._children.append(CompositeKeyNode(weight, key))
        return self

    def build(self, threshold: int | None = None) -> CompositeKey:
        if threshold is None:
            threshold = sum(n.weight for n in self._children)  # default: AND
        ck = CompositeKey(threshold, tuple(self._children))
        ck.validate()
        return ck


def expand_signers(key: PublicKey) -> set[PublicKey]:
    """Leaf keys a given (possibly composite) key could be satisfied by."""
    if key.scheme_id == COMPOSITE_KEY:
        return CompositeKey.from_public_key(key).leaf_keys()
    return {key}


def is_fulfilled_by(key: PublicKey, signers: set[PublicKey]) -> bool:
    """Uniform satisfaction check over plain and composite keys
    (reference: CryptoUtils.isFulfilledBy). A malformed composite key is
    simply unfulfillable (False), never a crash."""
    if key.scheme_id == COMPOSITE_KEY:
        try:
            return CompositeKey.from_public_key(key).is_fulfilled_by(signers)
        except CryptoError:
            return False
    return key in signers



def verify_composite(
    key: PublicKey, sigs: list[tuple[PublicKey, bytes]], data: bytes
) -> bool:
    """Verify a signature set against a (possibly composite) key: every
    individual signature must verify AND the verified signers must fulfil the
    tree (reference: CompositeSignaturesWithKeys + CompositeSignature)."""
    verified: set[PublicKey] = set()
    for signer, sig in sigs:
        try:
            if not is_valid(signer, sig, data):
                return False
        except CryptoError:
            # e.g. an adversarial set listing a composite key as an
            # *individual* signer — unverifiable, not a crash.
            return False
        verified.add(signer)
    return is_fulfilled_by(key, verified)
