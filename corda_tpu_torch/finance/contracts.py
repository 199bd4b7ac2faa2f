"""Cash's state and commands (from corda_tpu/finance/contracts.py).

Only what a non-validating notary's traffic carries: ``CashState``,
``Issue``, ``Move`` and ``CASH_PROGRAM_ID``, under the reference's CBE names
so that their bytes, and the ids of the transactions holding them, are the
reference's. The contract's ``verify`` and the other instruments come with
the validating notary (ROADMAP.md Queue 1 item 14).
"""

from __future__ import annotations

import dataclasses

from ..ledger import Amount
from ..serialization import cbe_serializable

CASH_PROGRAM_ID = "finance.Cash"


@cbe_serializable(name="finance.CashState")
@dataclasses.dataclass(frozen=True)
class CashState:
    """An amount of issued currency owned by a key."""

    amount: Amount  # token = Issued(PartyAndReference, currency: str)
    owner: object   # Party | AnonymousParty

    @property
    def participants(self):
        return [self.owner]

    @property
    def exit_keys(self):
        return {self.owner.owning_key, self.amount.token.issuer.party.owning_key}

    def with_new_owner(self, new_owner) -> "CashState":
        return dataclasses.replace(self, owner=new_owner)


@cbe_serializable(name="finance.Issue")
@dataclasses.dataclass(frozen=True)
class Issue:
    pass


@cbe_serializable(name="finance.Move")
@dataclasses.dataclass(frozen=True)
class Move:
    pass
