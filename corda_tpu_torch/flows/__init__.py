"""Flow framework — layer 3 (counterpart of corda_tpu/flows).

Durable app-level protocols by **deterministic replay over an event-sourced
op log**: a flow is ordinary Python in ``FlowLogic.call()``; every effectful
or suspending operation (send, receive, entropy, sleep, subflow boundary) is
numbered and its result recorded in a persisted op log. On restart the flow
re-runs from the top and recorded ops replay instantly until the first
unrecorded op, where execution is live again. Sends use message ids derived
from (flow id, op index) so crash-replayed sends dedupe at the recipient.

Checkpoints live in ``CheckpointStorage`` (SQLite) or, journaled through
the durability tier, in ``WalCheckpointStorage``.
"""

from .api import (
    FlowException,
    FlowLogic,
    FlowSession,
    InitiatedBy,
    ProgressTracker,
    UntrustworthyData,
)
from .checkpoints import CheckpointStorage, WalCheckpointStorage
from .engine import FlowHandle, StateMachineManager
from .overload import (
    FlowAdmissionError,
    OverloadGovernor,
    active_overload,
    configure_overload,
    deadline_scope,
    overload_section,
    remaining_deadline,
)
from .protocols import (
    AbstractStateReplacementFlow,
    BroadcastTransactionFlow,
    CollectSignaturesFlow,
    ContractUpgradeAcceptor,
    ContractUpgradeFlow,
    FetchRequest,
    FinalityFlow,
    NotaryChangeAcceptor,
    NotaryChangeFlow,
    NotaryException,
    NotaryFlowClient,
    NotaryServiceFlow,
    ReceiveBroadcastFlow,
    ReceiveTransactionFlow,
    ResolveTransactionsFlow,
    SendTransactionFlow,
    SignTransactionFlow,
)
from .sessions import (
    SessionConfirm,
    SessionData,
    SessionEnd,
    SessionInit,
    SessionReject,
)

__all__ = [
    "FlowException", "FlowLogic", "FlowSession", "InitiatedBy",
    "ProgressTracker", "UntrustworthyData",
    "CheckpointStorage",
    "WalCheckpointStorage",
    "FlowHandle", "StateMachineManager",
    "FlowAdmissionError", "OverloadGovernor", "active_overload",
    "configure_overload", "deadline_scope", "overload_section",
    "remaining_deadline",
    "AbstractStateReplacementFlow", "BroadcastTransactionFlow",
    "CollectSignaturesFlow", "ContractUpgradeAcceptor", "ContractUpgradeFlow",
    "FetchRequest", "FinalityFlow", "NotaryChangeAcceptor", "NotaryChangeFlow",
    "NotaryException", "NotaryFlowClient", "NotaryServiceFlow",
    "ReceiveBroadcastFlow", "ReceiveTransactionFlow", "ResolveTransactionsFlow",
    "SendTransactionFlow", "SignTransactionFlow",
    "SessionConfirm", "SessionData", "SessionEnd", "SessionInit",
    "SessionReject",
]
