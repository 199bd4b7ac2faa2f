"""Batch verification (counterpart of corda_tpu/batchverify/): the
cofactored ed25519 rule of the reference's batch route, the port's oracle
for full buckets (``rlc``); min-pk BLS12-381 aggregate signatures with
proof-of-possession registration (``bls``, pure Python, settled on the
host as in the reference); and the quorum-certificate wire format over
them (``qc``)."""

from . import bls
from .qc import QCError, QuorumCertificate, decode_attestation
from .rlc import small_order_encodings, verify_rows, verify_single

__all__ = ["QCError", "QuorumCertificate", "bls", "decode_attestation",
           "small_order_encodings", "verify_rows", "verify_single"]
