"""Ledger data model (counterpart of corda_tpu/ledger): states, commands,
amounts, identities, the component-group wire transaction with Merkle ids,
the signed form and the builder. The resolved ``LedgerTransaction`` and the
filtered (tear-off) form come with later slices (ROADMAP.md Queue 1 items
14 and 15)."""

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
    "SignaturesMissingException", "SignedTransaction",
    "TransactionBuilder",
]
