"""Wavefront verification of transaction DAGs (counterpart of the
reference's corda_tpu/parallel; its device mesh is not ported yet)."""

from .wavefront import (
    DagVerificationError,
    DagVerifyResult,
    DoubleSpendInDagError,
    UnresolvedStateError,
    topological_levels,
    verify_transaction_dag,
)

__all__ = [
    "DagVerificationError", "DagVerifyResult", "DoubleSpendInDagError",
    "UnresolvedStateError", "topological_levels", "verify_transaction_dag",
]
