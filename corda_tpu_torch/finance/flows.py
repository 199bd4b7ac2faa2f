"""Cash flows: issue, pay, exit (counterpart of corda_tpu/finance/flows.py;
reference: finance/src/main/kotlin/net/corda/finance/flows/CashIssueFlow.kt,
CashPaymentFlow.kt, CashExitFlow.kt, AbstractCashFlow.kt).

Coin selection mirrors the reference's currency-level selection
(CashSelectionH2Impl.kt picks unconsumed cash rows by currency across
issuers): candidates come from the vault query engine, are filtered by
currency, soft-locked under the flow id, then spent with change back to
the sender.
"""

from __future__ import annotations

import dataclasses

from ..flows import FinalityFlow, FlowException, FlowLogic
from ..ledger import (
    Amount,
    Issued,
    Party,
    PartyAndReference,
    TransactionBuilder,
)
from ..node import QueryCriteria, Sort, SoftLockError

from .contracts import CASH_PROGRAM_ID, CashState, Exit, Issue, Move


def select_cash(
    flow: FlowLogic, currency: str, quantity: int, *,
    retry_window_s: float = 15.0,
) -> list:
    """Currency-level coin selection over the vault: unconsumed, UNLOCKED
    CashStates of any issuer in ``currency``, smallest-first, soft-locked
    under the flow id (reference:
    CashSelectionH2Impl.unconsumedCashStatesForSpending).

    Query→pick→reserve races with concurrent spends are RETRIED with a
    fresh query for up to ``retry_window_s`` (reference: the selection's
    retry/sleep loop). The window is TIME-based, not attempt-counted:
    rival flows legitimately hold their locks from selection to finality,
    which can span seconds under load — the loser must outwait a trade,
    not a scheduler blip."""
    import random as _random
    import time as _time

    deadline = _time.monotonic() + retry_window_s
    attempt = 0
    while True:
        try:
            # first attempt: smallest-first (minimal fragmentation);
            # retries: SHUFFLED candidate order — N concurrent spenders all
            # greedily picking the same smallest states would otherwise
            # thunder-herd through the whole window at high concurrency
            return _select_cash_once(
                flow, currency, quantity, shuffle=attempt > 0
            )
        except SoftLockError as e:
            # lost a race between query and reserve: another flow locked
            # one of our picks — back off and re-query (the loser sees the
            # winner's locks excluded, and its change states appear once
            # the winning trade completes)
            if _time.monotonic() >= deadline:
                raise FlowException(
                    f"cash selection conflict persisted for "
                    f"{retry_window_s:.0f}s: {e}"
                ) from e
            attempt += 1
            _time.sleep(
                min(0.5, 0.01 * attempt) * (1 + _random.random())
            )


def _select_cash_once(
    flow: FlowLogic, currency: str, quantity: int, shuffle: bool = False,
) -> list:
    vault = flow.services.vault_service
    page = vault.query_by(
        QueryCriteria(
            contract_state_types=(CashState,),
            include_soft_locked=False,          # concurrent spends must not
            soft_lock_id=flow.flow_id,          # collide on locked refs
        ),
        sort=Sort(by="quantity"),
    )
    candidates = [
        sr for sr in page.states
        if sr.state.data.amount.token.product == currency
    ]
    if shuffle:
        import random as _random

        _random.shuffle(candidates)
    # a transaction's inputs must share one notary — select within the
    # notary bucket that can cover the amount (cross-notary spends need an
    # explicit NotaryChangeFlow first, as in the reference)
    buckets: dict = {}
    for sr in candidates:
        buckets.setdefault(sr.state.notary.owning_key, []).append(sr)
    picked, total = [], 0
    best_total = 0
    for bucket in buckets.values():
        bucket_total = sum(
            sr.state.data.amount.quantity for sr in bucket
        )
        best_total = max(best_total, bucket_total)
        if bucket_total < quantity:
            continue
        picked, total = [], 0
        for sr in bucket:  # already smallest-first from the sorted query
            picked.append(sr)
            total += sr.state.data.amount.quantity
            if total >= quantity:
                break
        break
    if total < quantity:
        raise FlowException(
            f"insufficient spendable cash under a single notary: best "
            f"notary covers {best_total}, need {quantity} {currency}"
        )
    vault.soft_lock_reserve(flow.flow_id, [sr.ref for sr in picked])
    return picked


@dataclasses.dataclass
class CashIssueFlow(FlowLogic):
    """Issue cash to ourselves (reference: CashIssueFlow.kt — the issuer
    node mints against its own identity, then typically pays it away)."""

    quantity: int
    currency: str
    issuer_ref: bytes
    notary: Party

    def call(self):
        me = self.our_identity
        token = Issued(PartyAndReference(me, self.issuer_ref), self.currency)
        builder = TransactionBuilder(notary=self.notary)
        builder.add_output_state(
            CashState(Amount(self.quantity, token), me), CASH_PROGRAM_ID
        )
        builder.add_command(Issue(), me.owning_key)
        stx = self.sign_builder(builder)
        return self.sub_flow(FinalityFlow(stx))


@dataclasses.dataclass
class CashPaymentFlow(FlowLogic):
    """Pay an amount of a currency to a recipient, with change back to us
    (reference: CashPaymentFlow.kt)."""

    quantity: int
    currency: str
    recipient: Party

    def call(self):
        me = self.our_identity
        # record the selected refs (replay-safe: the selection is the
        # nondeterministic step), then re-derive the StateAndRefs. The lock
        # is held from selection until the ENGINE releases it at flow
        # completion (engine._finish — the VaultSoftLockManager role); the
        # replay hook re-reserves the recorded refs when a parked flow
        # resumes.
        refs = self.record(
            lambda: [
                sr.ref
                for sr in select_cash(self, self.currency, self.quantity)
            ],
            replay=lambda recs: self.services.vault_service.soft_lock_reacquire(
                self.flow_id, list(recs)
            ),
        )
        # soft-lock release is engine-managed at flow completion
        # (engine._finish, the VaultSoftLockManager role) — never
        # release in flow code: a park unwinds the stack, and a
        # release here would free the selected states mid-suspension
        selected = [self.services.to_state_and_ref(r) for r in refs]
        notary = selected[0].state.notary
        builder = TransactionBuilder(notary=notary)
        remaining = self.quantity
        signers = set()
        # spend per (issuer) token bucket, paying the recipient up to
        # the requested quantity and returning change per-token
        for sr in selected:
            state = sr.state.data
            builder.add_input_state(sr)
            signers.add(state.owner.owning_key)
            pay = min(remaining, state.amount.quantity)
            remaining -= pay
            if pay > 0:
                builder.add_output_state(
                    CashState(Amount(pay, state.amount.token),
                              self.recipient),
                    CASH_PROGRAM_ID,
                )
            change = state.amount.quantity - pay
            if change > 0:
                builder.add_output_state(
                    CashState(Amount(change, state.amount.token), me),
                    CASH_PROGRAM_ID,
                )
        builder.add_command(Move(), *sorted(
            signers, key=lambda k: (k.scheme_id, k.encoded)
        ))
        stx = self.sign_builder(builder)
        return self.sub_flow(FinalityFlow(stx))


@dataclasses.dataclass
class CashExitFlow(FlowLogic):
    """Withdraw cash we issued from the ledger (reference:
    CashExitFlow.kt — issuer redeems its own liability)."""

    quantity: int
    currency: str
    issuer_ref: bytes

    def call(self):
        me = self.our_identity
        token = Issued(PartyAndReference(me, self.issuer_ref), self.currency)
        vault = self.services.vault_service
        refs = self.record(
            lambda: [
                sr.ref for sr in vault.select_fungible(
                    token, self.quantity, self.flow_id, CashState
                )
            ],
            replay=lambda recs: vault.soft_lock_reacquire(
                self.flow_id, list(recs)
            ),
        )
        # soft-lock release is engine-managed at flow completion
        # (engine._finish, the VaultSoftLockManager role) — never
        # release in flow code: a park unwinds the stack, and a
        # release here would free the selected states mid-suspension
        selected = [self.services.to_state_and_ref(r) for r in refs]
        notary = selected[0].state.notary
        builder = TransactionBuilder(notary=notary)
        total = 0
        signers = {me.owning_key}
        for sr in selected:
            builder.add_input_state(sr)
            total += sr.state.data.amount.quantity
            signers.add(sr.state.data.owner.owning_key)
        if total > self.quantity:
            builder.add_output_state(
                CashState(Amount(total - self.quantity, token), me),
                CASH_PROGRAM_ID,
            )
        builder.add_command(
            Exit(Amount(self.quantity, token)),
            *sorted(signers, key=lambda k: (k.scheme_id, k.encoded)),
        )
        stx = self.sign_builder(builder)
        return self.sub_flow(FinalityFlow(stx))
