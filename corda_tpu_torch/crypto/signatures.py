"""Transaction signatures over transaction ids (copy of
corda_tpu/crypto/signatures.py).

Parity with the reference's ``TransactionSignature`` / ``SignableData`` /
``SignatureMetadata`` (core/.../crypto/TransactionSignature.kt:14,
SignableData.kt): a signature binds (transaction id, platform version,
scheme id) so a signature cannot be replayed under a different scheme or
platform.

The signable payload is a **fixed 44-byte layout** rather than a generic
serialized object:

    b"CTSG" | tx_id (32) | platform_version u32 LE | scheme_id u32 LE

Fixed width is a deliberate TPU-first choice: the ed25519 verify kernel hashes
R||A||M where M is this payload, and 32+32+44 = 108 bytes ≤ 111 keeps the
whole SHA-512 input in a *single* compression block — one fused kernel, no
variable-length bucketing on the hot path.
"""

from __future__ import annotations

import dataclasses
import struct

from ..serialization import register_custom

from .hashing import SecureHash
from .keys import PrivateKey, PublicKey
from .schemes import CryptoError, is_valid, sign

CURRENT_PLATFORM_VERSION = 1
SIGNABLE_MAGIC = b"CTSG"
SIGNABLE_LEN = 44


@dataclasses.dataclass(frozen=True)
class SignatureMetadata:
    platform_version: int = CURRENT_PLATFORM_VERSION
    scheme_id: int = 0  # scheme actually used to sign


@dataclasses.dataclass(frozen=True)
class SignableData:
    tx_id: SecureHash
    metadata: SignatureMetadata

    def to_bytes(self) -> bytes:
        out = (
            SIGNABLE_MAGIC
            + self.tx_id.bytes
            + struct.pack("<II", self.metadata.platform_version, self.metadata.scheme_id)
        )
        assert len(out) == SIGNABLE_LEN
        return out


@dataclasses.dataclass(frozen=True)
class TransactionSignature:
    signature: bytes
    by: PublicKey
    metadata: SignatureMetadata

    def signable_for(self, tx_id: SecureHash) -> bytes:
        return SignableData(tx_id, self.metadata).to_bytes()

    def is_valid_for(self, tx_id: SecureHash) -> bool:
        return is_valid(self.by, self.signature, self.signable_for(tx_id))

    def verify(self, tx_id: SecureHash) -> None:
        """Reference parity: TransactionSignature.verify(txId)."""
        if not self.is_valid_for(tx_id):
            raise CryptoError(f"invalid transaction signature by {self.by!r}")


def sign_tx_id(
    private: PrivateKey, public: PublicKey, tx_id: SecureHash
) -> TransactionSignature:
    meta = SignatureMetadata(CURRENT_PLATFORM_VERSION, private.scheme_id)
    payload = SignableData(tx_id, meta).to_bytes()
    return TransactionSignature(sign(private, payload), public, meta)


register_custom(
    SignatureMetadata,
    "crypto.SignatureMetadata",
    to_fields=lambda m: {"platform_version": m.platform_version, "scheme_id": m.scheme_id},
    from_fields=lambda d: SignatureMetadata(d["platform_version"], d["scheme_id"]),
)
register_custom(
    TransactionSignature,
    "crypto.TransactionSignature",
    to_fields=lambda s: {"signature": s.signature, "by": s.by, "metadata": s.metadata},
    from_fields=lambda d: TransactionSignature(d["signature"], d["by"], d["metadata"]),
)
