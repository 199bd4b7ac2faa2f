"""Batched signature verification over the port's kernels."""

from .batch import PendingRows, dispatch_signature_rows, verify_signature_rows

__all__ = ["PendingRows", "dispatch_signature_rows", "verify_signature_rows"]
