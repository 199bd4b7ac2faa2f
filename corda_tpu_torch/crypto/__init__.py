"""Keys, hashes, Merkle trees and their partial (tear-off) trees, composite
keys, transaction signatures, the scheme registry (ed25519, ECDSA, RSA,
SPHINCS and BLS; composite keys verify signature sets) and the pure-Python
host engines (``ed25519_host``, ``ecdsa_host``, ``rsa``, ``sphincs``; BLS
in ``batchverify/bls.py``)."""

from .hashing import ALL_ONES_HASH, ZERO_HASH, SecureHash, sha256, sha256_twice, sha512
from .keys import (
    BLS_BLS12381,
    COMPOSITE_KEY,
    ECDSA_SECP256K1_SHA256,
    ECDSA_SECP256R1_SHA256,
    EDDSA_ED25519_SHA512,
    RSA_SHA256,
    SPHINCS256_SHA256,
    KeyPair,
    PrivateKey,
    PublicKey,
)
from .merkle import MerkleTree, MerkleTreeError, PartialMerkleTree, merkle_root_host
from .schemes import (
    DEFAULT_SIGNATURE_SCHEME,
    SCHEMES,
    CryptoError,
    SignatureScheme,
    derive_keypair,
    derive_keypair_from_entropy,
    find_scheme,
    generate_keypair,
    is_valid,
    public_key_on_curve,
    sign,
    verify,
)
from .composite import (
    CompositeKey,
    CompositeKeyBuilder,
    CompositeKeyNode,
    expand_signers,
    is_fulfilled_by,
    verify_composite,
)
from .signatures import (
    CURRENT_PLATFORM_VERSION,
    SignableData,
    SignatureMetadata,
    TransactionSignature,
    sign_tx_id,
)

__all__ = [
    "ALL_ONES_HASH", "ZERO_HASH", "SecureHash", "sha256", "sha256_twice", "sha512",
    "KeyPair", "PrivateKey", "PublicKey",
    "MerkleTree", "MerkleTreeError", "PartialMerkleTree", "merkle_root_host",
    "BLS_BLS12381", "COMPOSITE_KEY", "DEFAULT_SIGNATURE_SCHEME", "ECDSA_SECP256K1_SHA256",
    "ECDSA_SECP256R1_SHA256", "EDDSA_ED25519_SHA512", "RSA_SHA256", "SCHEMES",
    "SPHINCS256_SHA256", "CryptoError", "SignatureScheme", "derive_keypair",
    "derive_keypair_from_entropy", "find_scheme", "generate_keypair", "is_valid",
    "public_key_on_curve", "sign", "verify",
    "CompositeKey", "CompositeKeyBuilder", "CompositeKeyNode", "expand_signers",
    "is_fulfilled_by", "verify_composite",
    "CURRENT_PLATFORM_VERSION", "SignableData", "SignatureMetadata",
    "TransactionSignature", "sign_tx_id",
]
