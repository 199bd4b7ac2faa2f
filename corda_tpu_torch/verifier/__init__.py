"""Batched signature verification over the port's kernels, and the
transaction layer over it."""

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

__all__ = [
    "BatchVerifyReport",
    "InvalidSignatureError",
    "PendingRows",
    "PendingTxCheck",
    "check_transactions",
    "dispatch_signature_rows",
    "dispatch_transactions",
    "flatten_signature_rows",
    "tx_report_from_mask",
    "verify_signature_rows",
]
