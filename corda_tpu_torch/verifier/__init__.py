"""Batched signature verification over the port's kernels, the transaction
layer over it, and the verifier services (``service.py``)."""

from .batch import (
    BatchVerifyReport,
    InvalidSignatureError,
    PendingRows,
    PendingTxCheck,
    check_transactions,
    dispatch_signature_rows,
    dispatch_transactions,
    flatten_signature_rows,
    tx_report_from_mask,
    verify_signature_rows,
)
from .service import (
    BatchedVerifierService,
    InMemoryVerifierService,
    TransactionVerifierService,
    VerificationError,
)

__all__ = [
    "BatchVerifyReport",
    "BatchedVerifierService",
    "InMemoryVerifierService",
    "InvalidSignatureError",
    "PendingRows",
    "PendingTxCheck",
    "TransactionVerifierService",
    "VerificationError",
    "check_transactions",
    "dispatch_signature_rows",
    "dispatch_transactions",
    "flatten_signature_rows",
    "tx_report_from_mask",
    "verify_signature_rows",
]
