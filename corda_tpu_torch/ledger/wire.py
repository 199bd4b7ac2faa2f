"""Wire transaction: component groups, privacy nonces, Merkle id (copy of
corda_tpu/ledger/wire.py, without ``to_ledger_transaction``, which comes
with the validating notary: ROADMAP.md Queue 1 item 14).

Capability parity with the reference's ``WireTransaction`` /
``TraversableTransaction`` (core/.../transactions/WireTransaction.kt:41-207,
MerkleTransaction.kt): a transaction is a list of typed component groups,
each component individually serialized; the id is the root of a Merkle tree
whose leaves are per-group sub-tree roots; component leaf hashes are salted
with per-component nonces so a FilteredTransaction can reveal single
components without enabling brute-force discovery of the hidden ones.

Hash schedule (ours, CBE-based — not the reference's Kryo bytes):

    nonce(g, i)  = sha256(salt ‖ "CTNONCE" ‖ g u32 ‖ i u32)
    leaf(g, i)   = sha256(nonce(g, i) ‖ component_bytes)
    group_root g = MerkleRoot([leaf(g, 0) … leaf(g, n-1)])   (zero-pad pow2)
    group_root g = ZERO_HASH when the group is empty
    tx id        = MerkleRoot([group_root 0 … group_root N-1])

The leaf rows are fixed-width SHA-256 work at every level: the id
recomputation for a batch of transactions on the card is ``ops/txid.py``
(kernel C for the leaves, kernel D for each Merkle level).
"""

from __future__ import annotations

import dataclasses
import enum
import secrets
import struct

from ..crypto import (
    MerkleTree,
    SecureHash,
    ZERO_HASH,
    sha256,
)
from ..serialization import encode, register_custom

from .identity import Party
from .states import StateRef, TimeWindow, TransactionVerificationException


class ComponentGroupType(enum.IntEnum):
    """Fixed group ordering (reference: ComponentGroupEnum)."""

    INPUTS = 0
    OUTPUTS = 1
    COMMANDS = 2
    ATTACHMENTS = 3
    NOTARY = 4
    TIMEWINDOW = 5
    SIGNERS = 6


NUM_GROUPS = len(ComponentGroupType)


@dataclasses.dataclass(frozen=True)
class PrivacySalt:
    salt: bytes

    def __post_init__(self):
        if len(self.salt) != 32 or self.salt == b"\x00" * 32:
            raise ValueError("privacy salt must be 32 nonzero bytes")

    @staticmethod
    def fresh() -> "PrivacySalt":
        return PrivacySalt(secrets.token_bytes(32))


def component_nonce(salt: PrivacySalt, group: int, index: int) -> SecureHash:
    return sha256(salt.salt + b"CTNONCE" + struct.pack("<II", group, index))


def component_leaf_hash(nonce: SecureHash, component_bytes: bytes) -> SecureHash:
    return sha256(nonce.bytes + component_bytes)


def group_merkle_root(leaf_hashes: list[SecureHash]) -> SecureHash:
    if not leaf_hashes:
        return ZERO_HASH
    return MerkleTree.build(leaf_hashes).root


@dataclasses.dataclass(frozen=True)
class WireTransaction:
    """Immutable signable transaction (reference: WireTransaction.kt:41).

    Components are stored deserialized; ``component_bytes`` re-encodes
    deterministically (CBE is canonical) so hashing is reproducible.
    """

    inputs: tuple          # tuple[StateRef, ...]
    outputs: tuple         # tuple[TransactionState, ...]
    commands: tuple        # tuple[Command, ...]
    attachments: tuple     # tuple[SecureHash, ...]
    notary: Party | None
    time_window: TimeWindow | None
    privacy_salt: PrivacySalt

    def __post_init__(self):
        if not self.inputs and not self.outputs:
            raise TransactionVerificationException(
                None, "transaction must have inputs or outputs"
            )
        if not self.commands:
            raise TransactionVerificationException(
                None, "transaction must have at least one command"
            )
        if self.inputs and self.notary is None:
            raise TransactionVerificationException(
                None, "transactions with inputs must have a notary"
            )
        if self.time_window is not None and self.notary is None:
            raise TransactionVerificationException(
                None, "transactions with a time window must have a notary"
            )

    # ---------------------------------------------------------- components
    def components(self, group: ComponentGroupType) -> tuple:
        return {
            ComponentGroupType.INPUTS: self.inputs,
            ComponentGroupType.OUTPUTS: self.outputs,
            ComponentGroupType.COMMANDS: self.commands,
            ComponentGroupType.ATTACHMENTS: self.attachments,
            ComponentGroupType.NOTARY: (self.notary,) if self.notary else (),
            ComponentGroupType.TIMEWINDOW: (self.time_window,)
            if self.time_window
            else (),
            ComponentGroupType.SIGNERS: self.required_signing_keys_ordered(),
        }[group]

    def component_bytes(self, group: ComponentGroupType) -> list[bytes]:
        """Serialized component rows for one group, memoized per instance:
        the reference's WireTransaction STORES its component groups as
        serialized bytes (ComponentGroup in WireTransaction.kt — the id
        hashes existing bytes), so recomputing the Merkle id, building
        tear-offs, and the notary's receive-path integrity sweep must not
        re-pay CBE encoding per call (it dominated the id sweep's host
        cost in r4 profiling: 0.39 s/1024 txs vs 0.14 s of hashing)."""
        d = object.__getattribute__(self, "__dict__")
        cache = d.get("_component_bytes")
        if cache is None:
            cache = d["_component_bytes"] = {}
        rows = cache.get(group)
        if rows is None:
            rows = cache[group] = [encode(c) for c in self.components(group)]
        return rows

    def required_signing_keys_ordered(self) -> tuple:
        """Deduplicated, deterministic union of command signers (the
        reference stores the SIGNERS group explicitly so tear-offs can
        prove who must sign without revealing commands)."""
        seen, out = set(), []
        for cmd in self.commands:
            for k in cmd.signers:
                if k not in seen:
                    seen.add(k)
                    out.append(k)
        return tuple(out)

    @property
    def required_signing_keys(self) -> set:
        return set(self.required_signing_keys_ordered())

    # ---------------------------------------------------------- merkle id
    def group_leaf_hashes(self, group: ComponentGroupType) -> list[SecureHash]:
        return [
            component_leaf_hash(
                component_nonce(self.privacy_salt, int(group), i), raw
            )
            for i, raw in enumerate(self.component_bytes(group))
        ]

    def group_roots(self) -> list[SecureHash]:
        return [
            group_merkle_root(self.group_leaf_hashes(g))
            for g in ComponentGroupType
        ]

    @property
    def id(self) -> SecureHash:
        """Merkle root over group roots (reference: WireTransaction.kt:63,
        139-195). Cached per instance."""
        cached = object.__getattribute__(self, "__dict__").get("_id")
        if cached is None:
            cached = MerkleTree.build(self.group_roots()).root
            object.__getattribute__(self, "__dict__")["_id"] = cached
        return cached

    def to_ledger_transaction(self, resolve_state) -> "LedgerTransaction":
        """Resolve input StateRefs to their actual states via
        ``resolve_state(StateRef) -> TransactionState`` and produce the
        verifiable form (reference: WireTransaction.toLedgerTransaction,
        WireTransaction.kt:85-124)."""
        from .ledger_tx import LedgerTransaction
        from .states import StateAndRef

        resolved = tuple(
            StateAndRef(resolve_state(ref), ref) for ref in self.inputs
        )
        return LedgerTransaction(
            tx_id=self.id,
            inputs=resolved,
            outputs=self.outputs,
            commands=self.commands,
            attachments=self.attachments,
            notary=self.notary,
            time_window=self.time_window,
        )

    def out_ref(self, index: int):
        """StateAndRef of output ``index`` (same shape as
        LedgerTransaction.out_ref)."""
        from .states import StateAndRef

        if not (0 <= index < len(self.outputs)):
            raise IndexError(f"output index {index} out of range")
        return StateAndRef(self.outputs[index], StateRef(self.id, index))

    def __str__(self):
        return f"WireTransaction({self.id})"


register_custom(
    PrivacySalt, "ledger.PrivacySalt",
    to_fields=lambda s: {"salt": s.salt},
    from_fields=lambda d: PrivacySalt(d["salt"]),
)
register_custom(
    WireTransaction, "ledger.WireTransaction",
    to_fields=lambda t: {
        "inputs": list(t.inputs), "outputs": list(t.outputs),
        "commands": list(t.commands), "attachments": list(t.attachments),
        "notary": t.notary if t.notary else 0,
        "time_window": t.time_window if t.time_window else 0,
        "privacy_salt": t.privacy_salt,
    },
    from_fields=lambda d: WireTransaction(
        tuple(d["inputs"]), tuple(d["outputs"]), tuple(d["commands"]),
        tuple(d["attachments"]),
        d["notary"] if d["notary"] != 0 else None,
        d["time_window"] if d["time_window"] != 0 else None,
        d["privacy_salt"],
    ),
)
