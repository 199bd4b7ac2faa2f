"""The batched non-validating notary and its uniqueness providers."""

from .service import TIME_TOLERANCE_MICROS, BatchedNotaryService, NotaryService
from .uniqueness import (
    ConsumedStateDetails,
    InMemoryUniquenessProvider,
    NotaryError,
    PendingCommit,
    PersistentUniquenessProvider,
    UniquenessConflict,
    UniquenessProvider,
)

__all__ = [
    "TIME_TOLERANCE_MICROS",
    "BatchedNotaryService",
    "ConsumedStateDetails",
    "InMemoryUniquenessProvider",
    "NotaryError",
    "NotaryService",
    "PendingCommit",
    "PersistentUniquenessProvider",
    "UniquenessConflict",
    "UniquenessProvider",
]
