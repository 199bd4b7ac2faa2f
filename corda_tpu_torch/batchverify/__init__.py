"""The cofactored ed25519 rule of the reference's batch route
(corda_tpu/batchverify/): the port's oracle for full buckets."""

from .rlc import small_order_encodings, verify_rows, verify_single

__all__ = ["small_order_encodings", "verify_rows", "verify_single"]
