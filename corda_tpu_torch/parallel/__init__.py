"""Device-mesh parallelism (counterpart of corda_tpu/parallel): signature
batches split over the visible ordinals (``mesh``), spent-state rows
all-gathered onto each, and the wavefront verification of transaction
DAGs (``wavefront``)."""

from .mesh import (
    ChunkedMask,
    Mesh,
    MeshVerifier,
    device_for_ordinal,
    distributed_ecdsa_step,
    distributed_verify_step,
    enable_service_mesh,
    make_mesh,
    service_mesh_active,
    service_mesh_verifier,
    set_logical_devices,
    visible_devices,
)
from .wavefront import (
    DagVerificationError,
    DagVerifyResult,
    DoubleSpendInDagError,
    UnresolvedStateError,
    topological_levels,
    verify_transaction_dag,
)

__all__ = [
    "ChunkedMask", "Mesh", "MeshVerifier", "device_for_ordinal",
    "distributed_ecdsa_step", "distributed_verify_step", "enable_service_mesh",
    "make_mesh", "service_mesh_active", "service_mesh_verifier",
    "set_logical_devices", "visible_devices",
    "DagVerificationError", "DagVerifyResult", "DoubleSpendInDagError",
    "UnresolvedStateError", "topological_levels", "verify_transaction_dag",
]
