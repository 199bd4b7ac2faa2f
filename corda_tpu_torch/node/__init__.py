"""Node services layer (counterpart of corda_tpu/node).

A ``ServiceHub`` service locator composing vault, identity, key-management,
attachment, network-map, transaction-storage, scheduler and verifier
services, plus typed configuration, the ``Node`` container and a metrics
registry — SQLite-backed persistence, callback feeds instead of Rx
Observables. The hub, the node and the node's entry point
(``python -m corda_tpu_torch.node.startup``) run on the card unless given
``device="cpu"``.
"""

from .config import (
    NodeConfiguration,
    NotaryConfig,
    RaftConfig,
    BFTConfig,
    VerifierType,
    load_config,
)
from .identity import IdentityService, KeyManagementService
from .monitoring import Counter, Gauge, Meter, MetricRegistry, Timer
from .network_map import (
    NetworkMapCache,
    NetworkMapClient,
    NetworkMapServer,
    NodeInfo,
)
from .scheduler import NodeSchedulerService, ScheduledActivity, SchedulableState
from .node import Node
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
    "NodeConfiguration", "NotaryConfig", "RaftConfig", "BFTConfig",
    "VerifierType", "load_config",
    "IdentityService", "KeyManagementService",
    "Counter", "Gauge", "Meter", "MetricRegistry", "Timer",
    "NetworkMapCache", "NetworkMapClient", "NetworkMapServer", "NodeInfo",
    "NodeSchedulerService", "ScheduledActivity", "SchedulableState",
    "Node",
    "ServiceHub", "TransactionResolutionError",
    "Attachment", "AttachmentStorage", "DBTransactionStorage",
    "NodeVaultService", "PageSpecification", "QueryCriteria", "Sort",
    "SoftLockError", "StateStatus", "Vault", "VaultUpdate",
]
