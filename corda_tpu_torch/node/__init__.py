"""Node services layer (counterpart of corda_tpu/node).

A ``ServiceHub`` service locator composing vault, identity, key-management,
attachment, network-map, transaction-storage and verifier services, plus a
metrics registry — SQLite-backed persistence, callback feeds instead of Rx
Observables. The hub runs its verifier on the card unless it is given
``device="cpu"``.

Not ported yet (ROADMAP.md, Queue 1): ``config``, ``node``, ``startup``,
``certificates``, ``cordapp`` and the node scheduler (``scheduler.py``),
with step 9.
"""

from .identity import IdentityService, KeyManagementService
from .monitoring import Counter, Gauge, Meter, MetricRegistry, Timer
from .network_map import (
    NetworkMapCache,
    NetworkMapClient,
    NetworkMapServer,
    NodeInfo,
)
from .services import ServiceHub, TransactionResolutionError
from .storage import Attachment, AttachmentStorage, DBTransactionStorage
from .vault import (
    NodeVaultService,
    PageSpecification,
    QueryCriteria,
    Sort,
    SoftLockError,
    StateStatus,
    Vault,
    VaultUpdate,
)

__all__ = [
    "IdentityService", "KeyManagementService",
    "Counter", "Gauge", "Meter", "MetricRegistry", "Timer",
    "NetworkMapCache", "NetworkMapClient", "NetworkMapServer", "NodeInfo",
    "ServiceHub", "TransactionResolutionError",
    "Attachment", "AttachmentStorage", "DBTransactionStorage",
    "NodeVaultService", "PageSpecification", "QueryCriteria", "Sort",
    "SoftLockError", "StateStatus", "Vault", "VaultUpdate",
]
