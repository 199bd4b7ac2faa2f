"""Notary services and their uniqueness providers (counterpart of
corda_tpu/notary): the sequential simple and validating notaries, and the
batched notary on the card with its request window."""

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
    "NotaryInternalException",
    "NotaryService",
    "PendingCommit",
    "PersistentUniquenessProvider",
    "SimpleNotaryService",
    "UniquenessConflict",
    "UniquenessProvider",
    "ValidatingNotaryService",
]
