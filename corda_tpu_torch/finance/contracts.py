"""Cash: its state, commands and contract (from corda_tpu/finance/contracts.py).

``CashState``, ``Issue``, ``Move``, ``Exit`` and ``CASH_PROGRAM_ID`` under the
reference's CBE names, so that their bytes, and the ids of the transactions
holding them, are the reference's; the shared fungible-asset verifier
(``verify_fungible_asset``, its batch form and ``fungible_move_rows``) and
the registered ``Cash`` contract, which the validating notary runs through
``ledger.verify_ledger_batch``. Commodity, CommercialPaper and Obligation
are not ported yet (ROADMAP.md Queue 1 item 18).
"""

from __future__ import annotations

import dataclasses

from ..ledger import Amount, register_contract
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


@cbe_serializable(name="finance.Exit")
@dataclasses.dataclass(frozen=True)
class Exit:
    """Remove the amount from the ledger (reference: Cash.Commands.Exit)."""

    amount: Amount


# ------------------------------------------------- fungible verification

def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _signers_of(tx, command_cls) -> set:
    keys: set = set()
    for cmd in tx.commands_of_type(command_cls):
        keys.update(cmd.signers)
    return keys


def verify_fungible_asset(tx, state_cls) -> None:
    """Shared issue/move/exit verifier for Cash-like assets (reference:
    Cash.verify, asset/Cash.kt:199-236: groupStates by token, then clause
    dispatch per group). Single source of truth is the batch form —
    per-tx verification is the one-element batch."""
    err = verify_fungible_asset_batch([tx], state_cls)[0]
    if err is not None:
        raise err


def verify_fungible_asset_batch(ltxs, state_cls) -> list:
    """Batched fungible verifier: same acceptance set as
    ``verify_fungible_asset`` over each tx, one fused pass per transaction
    (single state walk, memoised signer sets) instead of the generic
    ``group_states`` machinery — the contract-semantics half of the
    ≥10k-notarised-tx/sec path (SURVEY.md §7 hard part (f)). Returns one
    ``None | Exception`` slot per tx.
    """
    out = []
    for tx in ltxs:
        try:
            issue_signers = _signers_of(tx, Issue)
            move_signers = _signers_of(tx, Move)
            exit_cmds = tx.commands_of_type(Exit)
            exit_signers = _signers_of(tx, Exit) if exit_cmds else set()
            # one walk over inputs+outputs: token -> [in, out, owners, n_in]
            acc: dict = {}
            for s in tx.input_states():
                if isinstance(s, state_cls):
                    row = acc.setdefault(s.amount.token, [0, 0, set(), 0])
                    row[0] += s.amount.quantity
                    row[2].add(s.owner.owning_key)
                    row[3] += 1
            for s in tx.output_states():
                if isinstance(s, state_cls):
                    row = acc.setdefault(s.amount.token, [0, 0, set(), 0])
                    row[1] += s.amount.quantity
            _require(bool(acc), f"no {state_cls.__name__} groups in transaction")
            for token, (in_total, out_total, owner_keys, n_in) in acc.items():
                if n_in == 0:
                    _require(out_total > 0, "cannot issue zero value")
                    _require(
                        token.issuer.party.owning_key in issue_signers,
                        "issuer must sign an issuance",
                    )
                    continue
                exit_amount = sum(
                    c.value.amount.quantity for c in exit_cmds
                    if c.value.amount.token == token
                )
                _require(
                    in_total == out_total + exit_amount,
                    f"value not conserved for {token}: {in_total} -> "
                    f"{out_total} (+{exit_amount} exited)",
                )
                if exit_amount:
                    required = owner_keys | {token.issuer.party.owning_key}
                    _require(
                        required <= exit_signers,
                        "exit requires the owners' and issuer's signatures",
                    )
                if out_total:
                    _require(
                        owner_keys <= move_signers
                        or (exit_amount and owner_keys <= exit_signers),
                        "input owners must sign a move",
                    )
                elif not exit_amount:
                    _require(
                        False,
                        "inputs fully consumed with no outputs and no exit",
                    )
            out.append(None)
        except Exception as e:
            out.append(e)
    return out


def fungible_move_rows(ltxs, state_cls=None):
    """Vectorizable fast path: extract (tx_index, group_key_hash, in_qty,
    out_qty) rows across MANY ledger transactions so conservation checks
    run as one array reduction instead of per-tx Python. Feeds
    verifier.batch alongside the signature rows."""
    import hashlib

    import numpy as np

    state_cls = state_cls or CashState
    tx_idx, key_hash, in_q, out_q = [], [], [], []
    for i, ltx in enumerate(ltxs):
        for group in ltx.group_states(state_cls, lambda s: s.amount.token):
            h = hashlib.sha256(repr(group.grouping_key).encode()).digest()[:8]
            tx_idx.append(i)
            key_hash.append(int.from_bytes(h, "big", signed=False) >> 1)
            in_q.append(sum(s.amount.quantity for s in group.inputs))
            out_q.append(sum(s.amount.quantity for s in group.outputs))
    return (
        np.asarray(tx_idx, dtype=np.int32),
        np.asarray(key_hash, dtype=np.int64),
        np.asarray(in_q, dtype=np.int64),
        np.asarray(out_q, dtype=np.int64),
    )


# ---------------------------------------------------------------- contracts

@register_contract(CASH_PROGRAM_ID)
class Cash:
    """reference: finance/.../asset/Cash.kt:108."""

    def verify(self, tx):
        verify_fungible_asset(tx, CashState)

    def verify_batch(self, ltxs):
        """Batched fast path (ledger_tx.verify_ledger_batch hook)."""
        return verify_fungible_asset_batch(ltxs, CashState)
