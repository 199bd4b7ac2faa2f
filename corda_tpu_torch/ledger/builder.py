"""TransactionBuilder: mutable builder → WireTransaction / SignedTransaction (copy
of corda_tpu/ledger/builder.py).

Capability parity with the reference's ``TransactionBuilder``
(core/.../transactions/TransactionBuilder.kt): accumulate inputs, outputs,
commands, attachments, notary and time-window, auto-attach contract code
hashes, then ``to_wire_transaction()`` / sign.
"""

from __future__ import annotations

from ..crypto import (
    KeyPair,
    SecureHash,
    sign_tx_id,
)

from .identity import Party
from .signed import SignedTransaction
from .states import (
    Command,
    StateAndRef,
    StateRef,
    TimeWindow,
    TransactionState,
    contract_code_hash,
)
from .wire import PrivacySalt, WireTransaction


class TransactionBuilder:
    def __init__(self, notary: Party | None = None):
        self.notary = notary
        self._inputs: list[StateRef] = []
        self._input_states: list[StateAndRef] = []
        self._outputs: list[TransactionState] = []
        self._commands: list[Command] = []
        self._attachments: list[SecureHash] = []
        self._time_window: TimeWindow | None = None
        self._privacy_salt = PrivacySalt.fresh()

    # ------------------------------------------------------------- adders
    def add_input_state(self, state_and_ref: StateAndRef) -> "TransactionBuilder":
        self._inputs.append(state_and_ref.ref)
        self._input_states.append(state_and_ref)
        self._ensure_attachment(state_and_ref.state.contract)
        return self

    def add_output_state(
        self,
        data,
        contract: str,
        notary: Party | None = None,
        encumbrance: int | None = None,
        constraint=None,
    ) -> "TransactionBuilder":
        notary = notary or self.notary
        if notary is None:
            raise ValueError("output state needs a notary (set builder notary)")
        kwargs = {"encumbrance": encumbrance}
        if constraint is not None:
            kwargs["constraint"] = constraint
        self._outputs.append(TransactionState(data, contract, notary, **kwargs))
        self._ensure_attachment(contract)
        return self

    def add_command(self, value, *signers) -> "TransactionBuilder":
        self._commands.append(Command(value, tuple(signers)))
        return self

    def add_attachment(self, attachment_hash: SecureHash) -> "TransactionBuilder":
        if attachment_hash not in self._attachments:
            self._attachments.append(attachment_hash)
        return self

    def set_time_window(self, tw: TimeWindow) -> "TransactionBuilder":
        self._time_window = tw
        return self

    def set_privacy_salt(self, salt: PrivacySalt) -> "TransactionBuilder":
        self._privacy_salt = salt
        return self

    def _ensure_attachment(self, contract: str):
        h = contract_code_hash(contract)
        if h not in self._attachments:
            self._attachments.append(h)

    # ------------------------------------------------------------- outputs
    def input_states_and_refs(self) -> list[StateAndRef]:
        return list(self._input_states)

    def to_wire_transaction(self) -> WireTransaction:
        return WireTransaction(
            inputs=tuple(self._inputs),
            outputs=tuple(self._outputs),
            commands=tuple(self._commands),
            attachments=tuple(self._attachments),
            notary=self.notary,
            time_window=self._time_window,
            privacy_salt=self._privacy_salt,
        )

    def sign_initial_transaction(self, *keypairs: KeyPair) -> SignedTransaction:
        """Reference: ServiceHub.signInitialTransaction
        (core/.../node/ServiceHub.kt:187-209) — build, then sign with the
        node's key(s)."""
        if not keypairs:
            raise ValueError("need at least one keypair")
        wtx = self.to_wire_transaction()
        sigs = [
            sign_tx_id(kp.private, kp.public, wtx.id) for kp in keypairs
        ]
        return SignedTransaction.create(wtx, sigs)
