"""Keys, scheme ids and the pure-Python ed25519 host oracle."""

from .keys import (
    BLS_BLS12381,
    COMPOSITE_KEY,
    ECDSA_SECP256K1_SHA256,
    ECDSA_SECP256R1_SHA256,
    EDDSA_ED25519_SHA512,
    RSA_SHA256,
    SPHINCS256_SHA256,
    PublicKey,
)

__all__ = [
    "BLS_BLS12381",
    "COMPOSITE_KEY",
    "ECDSA_SECP256K1_SHA256",
    "ECDSA_SECP256R1_SHA256",
    "EDDSA_ED25519_SHA512",
    "RSA_SHA256",
    "SPHINCS256_SHA256",
    "PublicKey",
]
