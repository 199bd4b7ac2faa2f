"""Secure hashes, host side (copy of corda_tpu/crypto/hashing.py).

Capability parity with the reference's ``SecureHash`` (core/.../crypto/
SecureHash.kt:14-50): SHA-256 content addresses, double-SHA-256, the
zero/all-ones sentinel hashes used for Merkle padding and privacy nonces.
Batched SHA-256 on the card lives in ``ops/sha256.py``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import secrets

from ..serialization import register_custom


@dataclasses.dataclass(frozen=True, order=True)
class SecureHash:
    """A SHA-256 content address (32 bytes)."""

    bytes: bytes

    def __post_init__(self):
        if not isinstance(self.bytes, bytes) or len(self.bytes) != 32:
            raise ValueError("SecureHash requires exactly 32 bytes")

    # -- constructors ------------------------------------------------
    @staticmethod
    def parse(hex_str: str) -> "SecureHash":
        b = bytes.fromhex(hex_str)
        return SecureHash(b)

    @staticmethod
    def random() -> "SecureHash":
        return SecureHash(secrets.token_bytes(32))

    def __str__(self) -> str:
        return self.bytes.hex().upper()

    def __repr__(self) -> str:
        return f"SecureHash({self.bytes.hex()[:16]}…)"

    # -- operations --------------------------------------------------
    def hash_concat(self, other: "SecureHash") -> "SecureHash":
        return sha256(self.bytes + other.bytes)

    def prefix_chars(self, n: int = 6) -> str:
        return str(self)[:n]


def sha256(data: bytes) -> SecureHash:
    return SecureHash(hashlib.sha256(data).digest())


def sha256_twice(data: bytes) -> SecureHash:
    """Double SHA-256 (reference: SecureHash.sha256Twice, SecureHash.kt:41)."""
    return SecureHash(hashlib.sha256(hashlib.sha256(data).digest()).digest())


def sha512(data: bytes) -> bytes:
    return hashlib.sha512(data).digest()


ZERO_HASH = SecureHash(b"\x00" * 32)
ALL_ONES_HASH = SecureHash(b"\xff" * 32)

register_custom(
    SecureHash,
    "crypto.SecureHash",
    to_fields=lambda h: {"bytes": h.bytes},
    from_fields=lambda d: SecureHash(d["bytes"]),
)
