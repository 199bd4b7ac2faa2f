"""Ledger data model (counterpart of corda_tpu/ledger): states, commands,
amounts, identities, the component-group wire transaction with Merkle ids,
the signed form, the builder, and the resolved ``LedgerTransaction`` with
its batched verifier. The filtered (tear-off) form comes with a later slice
(ROADMAP.md Queue 1 item 15)."""

from .identity import (
    AbstractParty,
    AnonymousParty,
    CordaX500Name,
    NameKeyCertificate,
    Party,
    PartyAndCertificate,
)
from .states import (
    AlwaysAcceptAttachmentConstraint,
    Amount,
    AttachmentConstraint,
    Command,
    CommandWithParties,
    ContractState,
    HashAttachmentConstraint,
    Issued,
    NotaryChangeCommand,
    PartyAndReference,
    StateAndRef,
    StateRef,
    TimeWindow,
    TransactionState,
    TransactionVerificationException,
    UniqueIdentifier,
    UpgradeCommand,
    WhitelistedByZoneAttachmentConstraint,
    contract_code_hash,
    register_contract,
    resolve_contract,
)
from .wire import ComponentGroupType, PrivacySalt, WireTransaction
from .ledger_tx import InOutGroup, LedgerTransaction, verify_ledger_batch
from .signed import SignaturesMissingException, SignedTransaction
from .builder import TransactionBuilder

__all__ = [
    "AbstractParty", "AnonymousParty", "CordaX500Name", "NameKeyCertificate",
    "Party", "PartyAndCertificate",
    "AlwaysAcceptAttachmentConstraint", "Amount", "AttachmentConstraint",
    "Command", "CommandWithParties", "ContractState",
    "HashAttachmentConstraint", "Issued", "NotaryChangeCommand",
    "PartyAndReference",
    "StateAndRef", "StateRef",
    "TimeWindow", "TransactionState", "TransactionVerificationException",
    "UniqueIdentifier", "UpgradeCommand",
    "WhitelistedByZoneAttachmentConstraint",
    "contract_code_hash", "register_contract", "resolve_contract",
    "ComponentGroupType", "PrivacySalt", "WireTransaction",
    "InOutGroup", "LedgerTransaction", "verify_ledger_batch",
    "SignaturesMissingException", "SignedTransaction",
    "TransactionBuilder",
]
