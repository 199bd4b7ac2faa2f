"""The finance contracts: states, commands and contracts (from
corda_tpu/finance/contracts.py).

Under the reference's CBE names, so that their bytes, and the ids of the
transactions holding them, are the reference's:

- ``Cash`` (``CashState``; ``Issue``, ``Move``, ``Exit``) and
  ``Commodity`` (``CommodityState``), both on the shared fungible-asset
  verifier (``verify_fungible_asset``, its batch form, which
  ``ledger.verify_ledger_batch`` calls once a cohort, and
  ``fungible_move_rows``);
- ``CommercialPaper`` (``CommercialPaperState``; issue, move, and
  ``Redeem`` against cash paid to the owner);
- ``Obligation`` (``ObligationState``; issue, move, and ``Settle`` with
  cash).

The validating notary and the back-chain resolve run them through
``ledger.verify_ledger_batch``.
"""

from __future__ import annotations

import dataclasses

from ..ledger import Amount, PartyAndReference, register_contract
from ..serialization import cbe_serializable

CASH_PROGRAM_ID = "finance.Cash"
CP_PROGRAM_ID = "finance.CommercialPaper"
OBLIGATION_PROGRAM_ID = "finance.Obligation"
COMMODITY_PROGRAM_ID = "finance.Commodity"


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


@cbe_serializable(name="finance.CommodityState")
@dataclasses.dataclass(frozen=True)
class CommodityState:
    """Issued commodity holdings (reference: CommodityContract.State)."""

    amount: Amount  # token = Issued(PartyAndReference, commodity_code: str)
    owner: object

    @property
    def participants(self):
        return [self.owner]

    @property
    def exit_keys(self):
        return {self.owner.owning_key, self.amount.token.issuer.party.owning_key}

    def with_new_owner(self, new_owner) -> "CommodityState":
        return dataclasses.replace(self, owner=new_owner)


@cbe_serializable(name="finance.CommercialPaperState")
@dataclasses.dataclass(frozen=True)
class CommercialPaperState:
    """A promise by the issuer to pay face value at maturity (reference:
    CommercialPaper.State)."""

    issuance: PartyAndReference
    owner: object
    face_value: Amount          # token = Issued(issuance, currency)
    maturity_date: float        # epoch seconds

    @property
    def participants(self):
        return [self.owner]

    def with_new_owner(self, new_owner) -> "CommercialPaperState":
        return dataclasses.replace(self, owner=new_owner)


@cbe_serializable(name="finance.ObligationState")
@dataclasses.dataclass(frozen=True)
class ObligationState:
    """An IOU: obligor owes the owner an amount, payable before due date
    (reference: Obligation.State, simplified)."""

    obligor: object
    amount: Amount              # token = Issued(PartyAndReference, currency)
    owner: object
    due_before: float           # epoch seconds

    @property
    def participants(self):
        return [self.obligor, self.owner]


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


@cbe_serializable(name="finance.Redeem")
@dataclasses.dataclass(frozen=True)
class Redeem:
    pass


@cbe_serializable(name="finance.Settle")
@dataclasses.dataclass(frozen=True)
class Settle:
    """Settle (part of) an obligation with cash (reference:
    Obligation.Commands.Settle)."""

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


@register_contract(COMMODITY_PROGRAM_ID)
class Commodity:
    """reference: finance/.../asset/CommodityContract.kt."""

    def verify(self, tx):
        verify_fungible_asset(tx, CommodityState)

    def verify_batch(self, ltxs):
        """Batched fast path (ledger_tx.verify_ledger_batch hook)."""
        return verify_fungible_asset_batch(ltxs, CommodityState)


@register_contract(CP_PROGRAM_ID)
class CommercialPaper:
    """reference: finance/.../contracts/CommercialPaper.kt."""

    def verify(self, tx):
        groups = tx.group_states(
            CommercialPaperState,
            lambda s: (s.issuance, s.face_value, s.maturity_date),
        )
        _require(bool(groups), "no commercial paper in transaction")
        issue_signers = _signers_of(tx, Issue)
        move_signers = _signers_of(tx, Move)
        redeem_signers = _signers_of(tx, Redeem)
        tw = tx.time_window
        # redemption cash accounting is GLOBAL across groups: each cash
        # output can pay for one face value only — per-group counting would
        # let N identical papers redeem against a single payment
        owed: dict = {}
        for group in groups:
            ins, outs = group.inputs, group.outputs
            if not ins:
                _require(len(outs) >= 1, "issue must create paper")
                paper = outs[0]
                _require(
                    paper.issuance.party.owning_key in issue_signers,
                    "issuer must sign a paper issuance",
                )
                _require(
                    tw is not None and tw.until_time is not None
                    and tw.until_time / 1_000_000 < paper.maturity_date,
                    "paper must be issued before its maturity (needs a "
                    "time window)",
                )
            elif not outs:
                # clause dispatch is PER GROUP by shape (the reference's
                # grouped clause matching): consumed-without-reissue is a
                # redemption of this group, even if other groups move
                _require(
                    bool(tx.commands_of_type(Redeem)),
                    "paper consumed without a Redeem command",
                )
                _require(
                    tw is not None and tw.from_time is not None
                    and tw.from_time / 1_000_000 >= ins[0].maturity_date,
                    "paper may only be redeemed after maturity",
                )
                for paper in ins:
                    key = (paper.owner.owning_key, paper.face_value.token)
                    owed[key] = owed.get(key, 0) + paper.face_value.quantity
                    _require(
                        paper.owner.owning_key in redeem_signers,
                        "paper owner must sign a redemption",
                    )
            else:
                _require(
                    len(ins) == 1 and len(outs) == 1,
                    "move is one paper in, one paper out",
                )
                _require(
                    outs[0] == ins[0].with_new_owner(outs[0].owner),
                    "move may only change the owner",
                )
                _require(
                    ins[0].owner.owning_key in move_signers,
                    "paper owner must sign a move",
                )
        # settle the global redemption account: cash outputs to each owner
        # must cover the sum of face values of ALL their redeemed papers
        for (owner_key, token), total in owed.items():
            received = sum(
                c.amount.quantity for c in tx.outputs_of_type(CashState)
                if c.owner.owning_key == owner_key and c.amount.token == token
            )
            _require(
                received >= total,
                "redemption must pay the face value to the owner",
            )


@register_contract(OBLIGATION_PROGRAM_ID)
class Obligation:
    """reference: finance/.../asset/Obligation.kt (simplified: issue,
    move, settle-with-cash)."""

    def verify(self, tx):
        groups = tx.group_states(
            ObligationState,
            lambda s: (s.obligor.owning_key, s.amount.token),
        )
        _require(bool(groups), "no obligations in transaction")
        issue_signers = _signers_of(tx, Issue)
        move_signers = _signers_of(tx, Move)
        settle_cmds = tx.commands_of_type(Settle)
        settle_signers = _signers_of(tx, Settle)
        # settlement accounting is GLOBAL: total reduction per token must
        # equal the Settle command totals, and cash to each beneficiary
        # must cover their summed reductions — per-group counting would let
        # one payment settle obligations from several obligors
        settle_totals: dict = {}
        for c in settle_cmds:
            tok = c.value.amount.token
            settle_totals[tok] = settle_totals.get(tok, 0) + c.value.amount.quantity
        reduced_by_token: dict = {}
        owed: dict = {}
        for group in groups:
            ins, outs = group.inputs, group.outputs
            in_total = sum(s.amount.quantity for s in ins)
            out_total = sum(s.amount.quantity for s in outs)
            if not ins:
                _require(out_total > 0, "cannot issue a zero obligation")
                _require(
                    all(s.obligor.owning_key in issue_signers for s in outs),
                    "obligor must sign an obligation issuance",
                )
                continue
            token = ins[0].amount.token
            reduction = in_total - out_total
            if reduction > 0:
                _require(
                    token in settle_totals,
                    "obligation reduced without a Settle command",
                )
                owner_keys = {s.owner.owning_key for s in ins}
                _require(
                    len(owner_keys) == 1,
                    "a settle group must have a single beneficiary",
                )
                owner_key = next(iter(owner_keys))
                reduced_by_token[token] = (
                    reduced_by_token.get(token, 0) + reduction
                )
                key = (owner_key, token)
                owed[key] = owed.get(key, 0) + reduction
                _require(
                    {s.obligor.owning_key for s in ins} <= settle_signers,
                    "obligor must sign a settlement",
                )
            else:
                _require(
                    in_total == out_total,
                    "obligation amount not conserved by a move",
                )
                _require(
                    {s.owner.owning_key for s in ins} <= move_signers,
                    "beneficiary must sign an obligation move",
                )
        for token, total in settle_totals.items():
            _require(
                reduced_by_token.get(token, 0) == total,
                "settled amount must equal the obligation reduction",
            )
        for (owner_key, token), amount in owed.items():
            paid = sum(
                c.amount.quantity for c in tx.outputs_of_type(CashState)
                if c.owner.owning_key == owner_key and c.amount.token == token
            )
            _require(
                paid >= amount,
                "settlement must pay the beneficiary in matching cash",
            )
