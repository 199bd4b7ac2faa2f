"""Scheme ids and the scheme-tagged keys (copy of corda_tpu/crypto/keys.py
and the ids of corda_tpu/crypto/schemes.py).

A key is (scheme_id, canonical encoded bytes); an ed25519 public key is its
raw 32-byte compressed point, which is what the verify kernels consume, and
an ed25519 private key is its 32-byte seed. An ECDSA public key is its SEC1
point, compressed (33 bytes) or uncompressed (65), and its private key
the 32-byte big-endian scalar d."""

from __future__ import annotations

import dataclasses
import hashlib

from ..serialization import register_custom

RSA_SHA256 = 1
ECDSA_SECP256K1_SHA256 = 2
ECDSA_SECP256R1_SHA256 = 3
EDDSA_ED25519_SHA512 = 4
SPHINCS256_SHA256 = 5
COMPOSITE_KEY = 6
BLS_BLS12381 = 7


@dataclasses.dataclass(frozen=True, order=True)
class PublicKey:
    scheme_id: int
    encoded: bytes

    def __repr__(self):
        return f"PublicKey(scheme={self.scheme_id}, {self.encoded.hex()[:16]}…)"

    def to_string_short(self) -> str:
        return hashlib.sha256(bytes([self.scheme_id]) + self.encoded).hexdigest()[:16].upper()


@dataclasses.dataclass(frozen=True)
class PrivateKey:
    scheme_id: int
    encoded: bytes

    def __repr__(self):
        return f"PrivateKey(scheme={self.scheme_id}, ****)"


@dataclasses.dataclass(frozen=True)
class KeyPair:
    public: PublicKey
    private: PrivateKey


register_custom(
    PublicKey,
    "crypto.PublicKey",
    to_fields=lambda k: {"scheme_id": k.scheme_id, "encoded": k.encoded},
    from_fields=lambda d: PublicKey(d["scheme_id"], d["encoded"]),
)
register_custom(
    PrivateKey,
    "crypto.PrivateKey",
    to_fields=lambda k: {"scheme_id": k.scheme_id, "encoded": k.encoded},
    from_fields=lambda d: PrivateKey(d["scheme_id"], d["encoded"]),
)
