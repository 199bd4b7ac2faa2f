"""Signature scheme registry, host side (counterpart of corda_tpu/crypto/schemes.py).

The same ids, code names and entry points as the reference, each scheme
on a pure-Python engine of the port: the machine with the card need not
have the ``cryptography`` package the reference signs with.

- ed25519 (scheme 4): ``ed25519_host.py``, RFC 8032;
- ECDSA over secp256k1 and secp256r1 (schemes 2, 3): ``ecdsa_host.py``;
- RSA over SHA-256, PKCS#1 v1.5 (scheme 1): ``rsa.py``, not derivable
  from entropy, as in the reference;
- the hash-based scheme (5): ``sphincs.py``, the reference's copy.

Deterministic signatures (ed25519, RSA, SPHINCS) are the reference's bytes.
Composite keys and BLS (6, 7) raise ``NotImplementedError`` naming the
ROADMAP.md item that ports them. Batched verification on the card is
``verifier/batch.py``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import secrets

from . import ecdsa_host, ed25519_host, rsa, sphincs
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


@dataclasses.dataclass(frozen=True)
class SignatureScheme:
    scheme_id: int
    code_name: str
    algorithm: str
    key_size: int | None = None


SCHEMES: dict[int, SignatureScheme] = {
    RSA_SHA256: SignatureScheme(RSA_SHA256, "RSA_SHA256", "SHA256withRSA", 2048),
    ECDSA_SECP256K1_SHA256: SignatureScheme(
        ECDSA_SECP256K1_SHA256, "ECDSA_SECP256K1_SHA256", "SHA256withECDSA"
    ),
    ECDSA_SECP256R1_SHA256: SignatureScheme(
        ECDSA_SECP256R1_SHA256, "ECDSA_SECP256R1_SHA256", "SHA256withECDSA"
    ),
    EDDSA_ED25519_SHA512: SignatureScheme(
        EDDSA_ED25519_SHA512, "EDDSA_ED25519_SHA512", "EdDSA.SHA512"
    ),
    SPHINCS256_SHA256: SignatureScheme(
        SPHINCS256_SHA256, "SPHINCS-256_SHA256", "SHA256withSPHINCS256"
    ),
    COMPOSITE_KEY: SignatureScheme(COMPOSITE_KEY, "COMPOSITE", "COMPOSITE"),
    BLS_BLS12381: SignatureScheme(BLS_BLS12381, "BLS_BLS12381", "BLSwithBLS12381"),
}

DEFAULT_SIGNATURE_SCHEME = EDDSA_ED25519_SHA512

# where ROADMAP.md schedules the port of each other scheme
NOT_PORTED = {
    COMPOSITE_KEY: "ROADMAP.md Queue 1 item 13 (device-free layers)",
    BLS_BLS12381: "ROADMAP.md Queue 1 item 12 (batchverify)",
}


# the curve behind each ECDSA scheme id
ECDSA_CURVES = {
    ECDSA_SECP256K1_SHA256: ecdsa_host.SECP256K1,
    ECDSA_SECP256R1_SHA256: ecdsa_host.SECP256R1,
}


class CryptoError(Exception):
    pass


def not_ported(scheme_id: int, what: str) -> NotImplementedError:
    where = NOT_PORTED.get(scheme_id, "no ROADMAP.md item")
    return NotImplementedError(
        f"{what} for scheme {scheme_id} is not ported to the PyTorch package "
        f"yet: {where}"
    )


def find_scheme(scheme_id: int) -> SignatureScheme:
    try:
        return SCHEMES[scheme_id]
    except KeyError:
        raise CryptoError(f"unsupported signature scheme id {scheme_id}") from None


def generate_keypair(scheme_id: int = DEFAULT_SIGNATURE_SCHEME) -> KeyPair:
    find_scheme(scheme_id)
    if scheme_id == RSA_SHA256:
        pub, priv = rsa.generate(secrets.SystemRandom())
        return KeyPair(PublicKey(scheme_id, pub), PrivateKey(scheme_id, priv))
    return derive_keypair_from_entropy(scheme_id, secrets.token_bytes(32))


def derive_keypair_from_entropy(scheme_id: int, entropy: bytes) -> KeyPair:
    """Deterministic keypair from entropy, derived as the reference derives
    it (the same entropy gives the same key in both packages)."""
    find_scheme(scheme_id)
    if scheme_id == EDDSA_ED25519_SHA512:
        seed = hashlib.sha512(b"ctpu.ed25519" + entropy).digest()[:32]
        pub = ed25519_host.public_from_seed(seed)
        return KeyPair(PublicKey(scheme_id, pub), PrivateKey(scheme_id, seed))
    if scheme_id in ECDSA_CURVES:
        cv = ECDSA_CURVES[scheme_id]
        d = ecdsa_host.private_from_entropy(cv, entropy)
        return KeyPair(PublicKey(scheme_id, ecdsa_host.public_from_private(cv, d)),
                       PrivateKey(scheme_id, d.to_bytes(32, "big")))
    if scheme_id == SPHINCS256_SHA256:
        pub, priv = sphincs.generate(hashlib.sha256(b"ctpu.sphincs" + entropy).digest())
        return KeyPair(PublicKey(scheme_id, pub), PrivateKey(scheme_id, priv))
    if scheme_id == RSA_SHA256:
        raise CryptoError(f"cannot derive key pairs for scheme {scheme_id}")
    raise not_ported(scheme_id, "key derivation")


def derive_keypair(private: PrivateKey, seed: bytes) -> KeyPair:
    """Child-key derivation from an existing private key and a seed."""
    return derive_keypair_from_entropy(
        private.scheme_id, hashlib.sha512(private.encoded + seed).digest()
    )


def sign(private: PrivateKey, data: bytes) -> bytes:
    """Sign raw bytes: ed25519 gives the 64-byte RFC 8032 signature, ECDSA
    the 64-byte r || s with a deterministic nonce, normalised to low S,
    RSA the PKCS#1 v1.5 signature over SHA-256, SPHINCS the packed
    FORS and hypertree opening."""
    if private.scheme_id == EDDSA_ED25519_SHA512:
        return ed25519_host.sign(private.encoded, data)
    if private.scheme_id in ECDSA_CURVES:
        return ecdsa_host.sign(ECDSA_CURVES[private.scheme_id],
                               int.from_bytes(private.encoded, "big"), data)
    if private.scheme_id == RSA_SHA256:
        return rsa.sign(private.encoded, data)
    if private.scheme_id == SPHINCS256_SHA256:
        return sphincs.sign(private.encoded, data)
    find_scheme(private.scheme_id)
    raise not_ported(private.scheme_id, "signing")


def verify(public: PublicKey, signature: bytes, data: bytes) -> None:
    """Verify or raise ``CryptoError``."""
    if not is_valid(public, signature, data):
        raise CryptoError(f"signature verification failed (scheme {public.scheme_id})")


def is_valid(public: PublicKey, signature: bytes, data: bytes) -> bool:
    """Verify without throwing: the host oracle."""
    sid = public.scheme_id
    if sid == EDDSA_ED25519_SHA512:
        return ed25519_host.verify(public.encoded, signature, data)
    if sid in ECDSA_CURVES:
        return ecdsa_host.verify(ECDSA_CURVES[sid], public.encoded, signature, data)
    if sid == RSA_SHA256:
        return rsa.verify(public.encoded, signature, data)
    if sid == SPHINCS256_SHA256:
        return sphincs.verify(public.encoded, signature, data)
    if sid == COMPOSITE_KEY:
        raise CryptoError(
            "composite keys verify signature *sets*, not one signature"
        )
    find_scheme(sid)
    raise not_ported(sid, "verification")


def public_key_on_curve(public: PublicKey) -> bool:
    if public.scheme_id == EDDSA_ED25519_SHA512:
        # the reference's OpenSSL branch: any 32 bytes load as a key
        return len(public.encoded) == 32
    if public.scheme_id in ECDSA_CURVES:
        return ecdsa_host.decode_point(ECDSA_CURVES[public.scheme_id],
                                       bytes(public.encoded)) is not None
    if public.scheme_id == RSA_SHA256:
        return rsa.public_key_valid(public.encoded)
    if public.scheme_id == SPHINCS256_SHA256:
        return len(public.encoded) == 33
    find_scheme(public.scheme_id)
    raise not_ported(public.scheme_id, "key validation")
