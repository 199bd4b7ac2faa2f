"""Scheme ids and the scheme-tagged public key (copy of
corda_tpu/crypto/keys.py:27 and the ids of corda_tpu/crypto/schemes.py).

A key is (scheme_id, canonical encoded bytes); an ed25519 key is its raw
32-byte compressed point, which is what the verify kernels consume."""

from __future__ import annotations

import dataclasses

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
