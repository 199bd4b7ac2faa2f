"""Notary services and their uniqueness providers (counterpart of
corda_tpu/notary): the sequential simple and validating notaries, the
batched notary on the card with its request window, and the replicated
providers it commits through, a Raft cluster (crash faults) and a BFT
cluster with quorum certificates (Byzantine faults), and the provider
journaled through the durability tier. ``DeviceShardedUniquenessProvider``,
which keeps the consumed set in the card's memory, is re-exported lazily
from ``statestore`` (importing this package builds no table)."""

from .service import (
    TIME_TOLERANCE_MICROS,
    BatchedNotaryService,
    NotaryInternalException,
    NotaryService,
    SimpleNotaryService,
    ValidatingNotaryService,
)
from .uniqueness import (
    ConsumedStateDetails,
    DurableUniquenessProvider,
    InMemoryUniquenessProvider,
    NotaryError,
    PendingCommit,
    PersistentUniquenessProvider,
    UniquenessConflict,
    UniquenessProvider,
)
from .raft import NotLeaderError, RaftNode, RaftUniquenessProvider
from .raft_storage import RaftStorage
from .bft import BFTClusterClient, BFTReplica, BFTUniquenessProvider



def __getattr__(name: str):
    # lazy: the device provider lives in statestore/, off the default path
    if name == "DeviceShardedUniquenessProvider":
        from ..statestore import DeviceShardedUniquenessProvider

        return DeviceShardedUniquenessProvider
    raise AttributeError(name)


__all__ = [
    "TIME_TOLERANCE_MICROS",
    "BatchedNotaryService",
    "BFTClusterClient",
    "BFTReplica",
    "BFTUniquenessProvider",
    "ConsumedStateDetails",
    "DeviceShardedUniquenessProvider",
    "DurableUniquenessProvider",
    "InMemoryUniquenessProvider",
    "NotLeaderError",
    "NotaryError",
    "NotaryInternalException",
    "NotaryService",
    "PendingCommit",
    "PersistentUniquenessProvider",
    "RaftNode",
    "RaftStorage",
    "RaftUniquenessProvider",
    "SimpleNotaryService",
    "UniquenessConflict",
    "UniquenessProvider",
    "ValidatingNotaryService",
]
