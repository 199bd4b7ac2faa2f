"""Quorum certificates: one BLS aggregate signature per consensus round
(copy of corda_tpu/batchverify/qc.py).

A ``QuorumCertificate`` is what the BFT notary puts on the wire instead
of f+1 separate ed25519 attestations: the committed outcome bytes, ONE
96-byte BLS12-381 aggregate signature over them, and a bitmap naming
which cluster members contributed shares. Verification recomputes the
aggregate public key from the bitmap and runs a single
``bls.fast_aggregate_verify`` — so the certificate is self-contained
given the cluster's (ordered, PoP-registered) BLS membership list.

Wire format (version 2, the first QC version):

    b"CQC" | u8 version | u8 n | bitmap ceil(n/8) LE | u32 msglen BE
           | message | 96-byte aggregate

``decode_attestation`` versions the format downward: blobs without the
``CQC`` magic fall through to the legacy serializer, so per-signer
attestations produced before this subsystem existed still decode.

The reference's ``qc_enabled`` (its ``CORDA_TPU_BLS_QC`` switch, read by
the BFT notary) is not copied: the port reads no environment switch, and
the BFT notary that would read it comes with the rest of the notary.
"""

from __future__ import annotations

import dataclasses

_MAGIC = b"CQC"
_VERSION = 2
_AGG_BYTES = 96


class QCError(ValueError):
    """Malformed quorum-certificate encoding."""


@dataclasses.dataclass(frozen=True)
class QuorumCertificate:
    """message = committed outcome bytes; bitmap bit i = member i of the
    cluster's canonical member ordering (the replica-name list the
    cluster was built with) contributed a share."""

    message: bytes
    agg_sig: bytes
    bitmap: int
    n: int
    version: int = _VERSION

    def __post_init__(self):
        if len(self.agg_sig) != _AGG_BYTES:
            raise QCError("aggregate signature must be 96 bytes")
        if not 0 < self.n <= 255:
            raise QCError("member count out of range")
        if self.bitmap <= 0 or self.bitmap >> self.n:
            raise QCError("signer bitmap inconsistent with member count")

    def signers(self) -> list:
        return [i for i in range(self.n) if (self.bitmap >> i) & 1]

    def signer_count(self) -> int:
        return len(self.signers())

    def verify(self, member_keys) -> bool:
        """``member_keys`` = the cluster's 48-byte BLS public keys in
        canonical order; the bitmap selects the aggregation subset."""
        from . import bls

        if len(member_keys) != self.n:
            return False
        pks = [member_keys[i] for i in self.signers()]
        return bls.fast_aggregate_verify(pks, self.message, self.agg_sig)

    def encode(self) -> bytes:
        bm = self.bitmap.to_bytes((self.n + 7) // 8, "little")
        return (
            _MAGIC
            + bytes([self.version, self.n])
            + bm
            + len(self.message).to_bytes(4, "big")
            + self.message
            + self.agg_sig
        )

    @classmethod
    def decode(cls, blob: bytes) -> "QuorumCertificate":
        if blob[:3] != _MAGIC:
            raise QCError("missing CQC magic")
        if len(blob) < 5:
            raise QCError("truncated quorum certificate")
        version, n = blob[3], blob[4]
        if version != _VERSION:
            raise QCError(f"unsupported quorum-certificate version {version}")
        off = 5
        bmlen = (n + 7) // 8
        bitmap = int.from_bytes(blob[off : off + bmlen], "little")
        off += bmlen
        msglen = int.from_bytes(blob[off : off + 4], "big")
        off += 4
        message = blob[off : off + msglen]
        off += msglen
        agg = blob[off:]
        if len(message) != msglen or len(agg) != _AGG_BYTES:
            raise QCError("truncated quorum certificate")
        return cls(
            message=message, agg_sig=agg, bitmap=bitmap, n=n, version=version
        )


def decode_attestation(blob: bytes):
    """Versioned decode: ``QuorumCertificate`` for CQC blobs, the legacy
    per-signer attestation dict otherwise (old wire data keeps working)."""
    if blob[:3] == _MAGIC:
        return QuorumCertificate.decode(blob)
    from ..serialization import deserialize

    return deserialize(blob)

