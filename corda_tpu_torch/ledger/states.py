"""Contract/state data model (copy of corda_tpu/ledger/states.py).

Capability parity with the reference's contracts API (core/.../contracts/ —
``ContractState``, ``TransactionState``, ``Command``, ``Amount``, ``Issued``,
``TimeWindow``, ``UniqueIdentifier``, ``StateRef``, ``StateAndRef``,
``AttachmentConstraint`` hierarchy, ``TransactionVerificationException``;
Structures.kt, TransactionState.kt, Amount.kt, TimeWindow.kt).

States are plain frozen dataclasses registered with CBE; a contract is a
class with ``verify(ltx)``. Contract resolution is by registered class name
(the reference resolves contract class names from attachment JARs via an
AttachmentsClassLoader — here CorDapp modules register their contracts, and
attachments pin the registered code hash instead of a JAR hash).
"""

from __future__ import annotations

import dataclasses
import functools as _functools
import uuid as _uuid
from typing import Any, Protocol, runtime_checkable

from ..crypto import SecureHash, sha256
from ..serialization import register_custom

from .identity import AbstractParty, Party


class TransactionVerificationException(Exception):
    """Base for all verification failures (reference:
    TransactionVerificationException.kt). Carries the tx id."""

    def __init__(self, tx_id, message: str):
        self.tx_id = tx_id
        super().__init__(f"{message} (tx {tx_id})")


@runtime_checkable
class ContractState(Protocol):
    """Anything stored on-ledger: must expose participants
    (reference: ContractState in Structures.kt)."""

    @property
    def participants(self) -> list[AbstractParty]: ...


class Contract(Protocol):
    """Contract code: validates a LedgerTransaction (reference: Contract)."""

    def verify(self, tx: "Any") -> None: ...


# Contract registry: class-name string → contract class. The TPU build's
# equivalent of attachment-JAR contract loading; the "attachment" for a
# contract is the hash of its registered identifier (stable across nodes).
_CONTRACT_REGISTRY: dict[str, type] = {}


def register_contract(name: str):
    def deco(cls):
        _CONTRACT_REGISTRY[name] = cls
        cls.contract_name = name
        return cls

    return deco


def resolve_contract(name: str) -> type:
    try:
        return _CONTRACT_REGISTRY[name]
    except KeyError:
        raise TransactionVerificationException(
            None, f"unknown contract {name!r}"
        ) from None


@_functools.lru_cache(maxsize=1024)
def contract_code_hash(name: str) -> SecureHash:
    """Deterministic stand-in for the reference's attachment JAR hash.
    Cached: the constraint check recomputes it per state on the notary's
    hot path."""
    return sha256(b"CTCONTRACT" + name.encode())


def registered_contract_code_hashes() -> set:
    """Code hashes of every locally-registered contract — the set of
    pseudo-attachments that are satisfied by the contract registry rather
    than by a stored attachment blob."""
    return {contract_code_hash(n) for n in _CONTRACT_REGISTRY}


@dataclasses.dataclass(frozen=True)
class UniqueIdentifier:
    """External id + uuid for linear states (reference: UniqueIdentifier)."""

    external_id: str | None = None
    uuid: str = ""

    @staticmethod
    def fresh(external_id: str | None = None) -> "UniqueIdentifier":
        return UniqueIdentifier(external_id, str(_uuid.uuid4()))

    def __str__(self):
        return f"{self.external_id}_{self.uuid}" if self.external_id else self.uuid


@dataclasses.dataclass(frozen=True)
class StateRef:
    """Pointer to an output of a previous transaction (reference: StateRef)."""

    txhash: SecureHash
    index: int

    def __str__(self):
        return f"{self.txhash}({self.index})"


# ---------------------------------------------------------------- constraints

@dataclasses.dataclass(frozen=True)
class AlwaysAcceptAttachmentConstraint:
    def is_satisfied_by(self, attachment_hash: SecureHash) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class HashAttachmentConstraint:
    """Pins exact contract code (reference: HashAttachmentConstraint)."""

    attachment_hash: SecureHash

    def is_satisfied_by(self, attachment_hash: SecureHash) -> bool:
        return attachment_hash == self.attachment_hash


@dataclasses.dataclass(frozen=True)
class WhitelistedByZoneAttachmentConstraint:
    """Zone-parameter-driven whitelist (reference equivalent); satisfied when
    the network parameters whitelist the code hash for the contract."""

    def is_satisfied_by(self, attachment_hash: SecureHash) -> bool:
        return True  # whitelist check happens with network params in scope


AttachmentConstraint = (
    AlwaysAcceptAttachmentConstraint
    | HashAttachmentConstraint
    | WhitelistedByZoneAttachmentConstraint
)


@dataclasses.dataclass(frozen=True)
class TransactionState:
    """A ContractState plus ledger metadata (reference:
    TransactionState.kt — data, contract, notary, encumbrance, constraint)."""

    data: Any  # ContractState
    contract: str
    notary: Party
    encumbrance: int | None = None
    constraint: Any = dataclasses.field(
        default_factory=AlwaysAcceptAttachmentConstraint
    )


@dataclasses.dataclass(frozen=True)
class StateAndRef:
    state: TransactionState
    ref: StateRef


@dataclasses.dataclass(frozen=True)
class Command:
    """Command data + required signing keys (reference: Command in
    Structures.kt)."""

    value: Any  # CommandData
    signers: tuple  # tuple[PublicKey, ...]

    def __post_init__(self):
        if not self.signers:
            raise ValueError("command must have at least one signer")


@dataclasses.dataclass(frozen=True)
class NotaryChangeCommand:
    """Marks a transaction as a notary-change: inputs are re-pointed at
    ``new_notary`` with state data unchanged. The reference models this as a
    distinct wire-transaction type (NotaryChangeWireTransaction) exempt from
    contract verification; here it is a built-in command that switches
    LedgerTransaction.verify onto a structural equality check instead."""

    new_notary: Party


@dataclasses.dataclass(frozen=True)
class UpgradeCommand:
    """Marks a contract-upgrade transaction (reference: UpgradeCommand in
    ContractUpgradeFlow.kt). The upgraded contract class must declare
    ``legacy_contract`` (the old registered name) and a static
    ``upgrade(old_state) -> new_state``; verification checks every output is
    exactly the upgrade image of its input."""

    upgraded_contract: str


@dataclasses.dataclass(frozen=True)
class CommandWithParties:
    """Resolved command: signers + the parties they map to (reference:
    CommandWithParties in LedgerTransaction)."""

    signers: tuple
    signing_parties: tuple
    value: Any


# ---------------------------------------------------------------- amounts

@dataclasses.dataclass(frozen=True, order=True)
class PartyAndReference:
    """A party plus an opaque issuer reference (reference:
    PartyAndReference in Structures.kt) — disambiguates multiple issuances
    by the same party."""

    party: Any  # Party | AnonymousParty
    reference: bytes

    def __str__(self):
        return f"{self.party}[{self.reference.hex()}]"


@dataclasses.dataclass(frozen=True, order=True)
class Issued:
    """Asset type qualified by issuer reference (reference: Issued<P>)."""

    issuer: Any  # PartyAndReference
    product: Any

    def __str__(self):
        return f"{self.product} issued by {self.issuer}"


@dataclasses.dataclass(frozen=True, order=True)
class Amount:
    """Integer quantity of a token in indivisible units (reference:
    Amount.kt — overflow-safe arithmetic, same-token discipline)."""

    quantity: int
    token: Any

    def __post_init__(self):
        if self.quantity < 0:
            raise ValueError("amounts cannot be negative")

    def __add__(self, other: "Amount") -> "Amount":
        self._check(other)
        return Amount(self.quantity + other.quantity, self.token)

    def __sub__(self, other: "Amount") -> "Amount":
        self._check(other)
        if other.quantity > self.quantity:
            raise ValueError("amount underflow")
        return Amount(self.quantity - other.quantity, self.token)

    def _check(self, other: "Amount"):
        if not isinstance(other, Amount) or other.token != self.token:
            raise ValueError(f"token mismatch: {self.token} vs {getattr(other, 'token', None)}")

    @staticmethod
    def zero(token) -> "Amount":
        return Amount(0, token)

    @staticmethod
    def sum_or_zero(amounts: "list[Amount]", token) -> "Amount":
        total = Amount(0, token)
        for a in amounts:
            total = total + a
        return total


@dataclasses.dataclass(frozen=True)
class TimeWindow:
    """Notary-attested validity window (reference: TimeWindow.kt).
    Times are integer unix micros; either bound may be open."""

    from_time: int | None = None
    until_time: int | None = None

    def __post_init__(self):
        if self.from_time is None and self.until_time is None:
            raise ValueError("time window must have at least one bound")
        if (
            self.from_time is not None
            and self.until_time is not None
            and self.until_time < self.from_time
        ):
            raise ValueError("until < from")

    def contains(self, instant_micros: int) -> bool:
        if self.from_time is not None and instant_micros < self.from_time:
            return False
        if self.until_time is not None and instant_micros >= self.until_time:
            return False
        return True

    @staticmethod
    def between(from_time: int, until_time: int) -> "TimeWindow":
        return TimeWindow(from_time, until_time)

    @staticmethod
    def from_only(from_time: int) -> "TimeWindow":
        return TimeWindow(from_time, None)

    @staticmethod
    def until_only(until_time: int) -> "TimeWindow":
        return TimeWindow(None, until_time)


# ------------------------------------------------------------ registrations

register_custom(
    UniqueIdentifier, "ledger.UniqueIdentifier",
    to_fields=lambda u: {"external_id": u.external_id or "", "uuid": u.uuid},
    from_fields=lambda d: UniqueIdentifier(d["external_id"] or None, d["uuid"]),
)
register_custom(
    StateRef, "ledger.StateRef",
    to_fields=lambda r: {"txhash": r.txhash, "index": r.index},
    from_fields=lambda d: StateRef(d["txhash"], d["index"]),
)
register_custom(
    AlwaysAcceptAttachmentConstraint, "ledger.AlwaysAcceptConstraint",
    to_fields=lambda c: {},
    from_fields=lambda d: AlwaysAcceptAttachmentConstraint(),
)
register_custom(
    HashAttachmentConstraint, "ledger.HashConstraint",
    to_fields=lambda c: {"hash": c.attachment_hash},
    from_fields=lambda d: HashAttachmentConstraint(d["hash"]),
)
register_custom(
    WhitelistedByZoneAttachmentConstraint, "ledger.ZoneConstraint",
    to_fields=lambda c: {},
    from_fields=lambda d: WhitelistedByZoneAttachmentConstraint(),
)
register_custom(
    TransactionState, "ledger.TransactionState",
    to_fields=lambda s: {
        "data": s.data, "contract": s.contract, "notary": s.notary,
        "encumbrance": -1 if s.encumbrance is None else s.encumbrance,
        "constraint": s.constraint,
    },
    from_fields=lambda d: TransactionState(
        d["data"], d["contract"], d["notary"],
        None if d["encumbrance"] == -1 else d["encumbrance"], d["constraint"],
    ),
)
register_custom(
    StateAndRef, "ledger.StateAndRef",
    to_fields=lambda s: {"state": s.state, "ref": s.ref},
    from_fields=lambda d: StateAndRef(d["state"], d["ref"]),
)
register_custom(
    Command, "ledger.Command",
    to_fields=lambda c: {"value": c.value, "signers": list(c.signers)},
    from_fields=lambda d: Command(d["value"], tuple(d["signers"])),
)
register_custom(
    NotaryChangeCommand, "ledger.NotaryChangeCommand",
    to_fields=lambda c: {"new_notary": c.new_notary},
    from_fields=lambda d: NotaryChangeCommand(d["new_notary"]),
)
register_custom(
    UpgradeCommand, "ledger.UpgradeCommand",
    to_fields=lambda c: {"upgraded_contract": c.upgraded_contract},
    from_fields=lambda d: UpgradeCommand(d["upgraded_contract"]),
)
register_custom(
    PartyAndReference, "ledger.PartyAndReference",
    to_fields=lambda p: {"party": p.party, "reference": p.reference},
    from_fields=lambda d: PartyAndReference(d["party"], d["reference"]),
)
register_custom(
    Issued, "ledger.Issued",
    to_fields=lambda i: {"issuer": i.issuer, "product": i.product},
    from_fields=lambda d: Issued(d["issuer"], d["product"]),
)
register_custom(
    Amount, "ledger.Amount",
    to_fields=lambda a: {"quantity": a.quantity, "token": a.token},
    from_fields=lambda d: Amount(d["quantity"], d["token"]),
)
register_custom(
    TimeWindow, "ledger.TimeWindow",
    to_fields=lambda t: {
        "from_time": -1 if t.from_time is None else t.from_time,
        "until_time": -1 if t.until_time is None else t.until_time,
    },
    from_fields=lambda d: TimeWindow(
        None if d["from_time"] == -1 else d["from_time"],
        None if d["until_time"] == -1 else d["until_time"],
    ),
)
