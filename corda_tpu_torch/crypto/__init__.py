"""Keys, hashes, Merkle trees, composite keys, transaction signatures, the
scheme registry (ed25519, ECDSA, RSA and SPHINCS) and the pure-Python host
engines (``ed25519_host``, ``ecdsa_host``, ``rsa``, ``sphincs``)."""

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
from .merkle import MerkleTree, MerkleTreeError
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
from .composite import CompositeKey, CompositeKeyNode, is_fulfilled_by
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
    "MerkleTree", "MerkleTreeError",
    "BLS_BLS12381", "COMPOSITE_KEY", "DEFAULT_SIGNATURE_SCHEME", "ECDSA_SECP256K1_SHA256",
    "ECDSA_SECP256R1_SHA256", "EDDSA_ED25519_SHA512", "RSA_SHA256", "SCHEMES",
    "SPHINCS256_SHA256", "CryptoError", "SignatureScheme", "derive_keypair",
    "derive_keypair_from_entropy", "find_scheme", "generate_keypair", "is_valid",
    "public_key_on_curve", "sign", "verify",
    "CompositeKey", "CompositeKeyNode", "is_fulfilled_by",
    "CURRENT_PLATFORM_VERSION", "SignableData", "SignatureMetadata",
    "TransactionSignature", "sign_tx_id",
]
