"""Trader demo: delivery-versus-payment of commercial paper for cash
(counterpart of corda_tpu/samples/trader_demo.py; BASELINE config #1).

Capability parity with the reference's trader demo
(samples/trader-demo/.../TraderDemo.kt:16, flow/SellerFlow.kt,
flow/BuyerFlow.kt + the underlying TwoPartyTradeFlow): the seller offers a
commercial paper at a price; the buyer assembles the atomic swap
transaction (paper to buyer, cash to seller) spending its own cash with
change; both sign; the buyer notarises and broadcasts. Either everything
moves or nothing does — the DvP atomicity the platform exists for.

``run_demo(device=...)`` runs every node of its mock network on ``device``
(the card unless ``device="cpu"``): the flows' signature checks go through
the shared device scheduler there. Its notary node runs the reference's
host ``ValidatingNotaryService``.
"""

from __future__ import annotations

import dataclasses
import time

from ..finance import (
    CASH_PROGRAM_ID,
    CP_PROGRAM_ID,
    CashIssueFlow,
    CashState,
    CommercialPaperState,
    Issue,
    Move,
)
from ..device import resolve_device
from ..finance.flows import select_cash
from ..flows import (
    CollectSignaturesFlow,
    FinalityFlow,
    FlowException,
    FlowLogic,
    InitiatedBy,
    SignTransactionFlow,
)
from ..ledger import (
    Amount,
    Party,
    PartyAndReference,
    StateAndRef,
    TimeWindow,
    TransactionBuilder,
)
from ..serialization import cbe_serializable


@cbe_serializable(name="samples.SellOffer")
@dataclasses.dataclass(frozen=True)
class SellOffer:
    paper: StateAndRef
    price: int
    currency: str


@dataclasses.dataclass
class SellerFlow(FlowLogic):
    """Offer our commercial paper to a buyer at a price (reference:
    trader-demo SellerFlow + TwoPartyTradeFlow.Seller)."""

    buyer: Party
    paper_ref: StateAndRef
    price: int
    currency: str = "GBP"

    def call(self):
        session = self.initiate_flow(self.buyer)
        session.send(SellOffer(self.paper_ref, self.price, self.currency))
        # vend the paper's defining transaction + chain to the buyer
        from ..flows import SendTransactionFlow

        defining = self.services.validated_transactions.get(
            self.paper_ref.ref.txhash
        )
        self.sub_flow(SendTransactionFlow(session, defining))
        # buyer sends back the draft swap for our signature
        stx = self.sub_flow(_SellerSignFlow(session, self))
        # buyer finalises; broadcast records it here — wait for that
        return self.wait_for_ledger_commit(stx.id)


class _SellerSignFlow(SignTransactionFlow):
    def __init__(self, session, seller: SellerFlow):
        super().__init__(session)
        self._seller = seller

    def check_transaction(self, stx) -> None:
        me = self._seller.our_identity
        paid = sum(
            ts.data.amount.quantity for ts in stx.tx.outputs
            if isinstance(ts.data, CashState)
            and ts.data.owner.owning_key == me.owning_key
            and ts.data.amount.token.product == self._seller.currency
        )
        if paid < self._seller.price:
            raise FlowException(
                f"buyer is paying {paid}, offer was {self._seller.price}"
            )
        if self._seller.paper_ref.ref not in stx.inputs:
            raise FlowException("swap does not consume the offered paper")


@InitiatedBy(SellerFlow)
class BuyerFlow(FlowLogic):
    """Accept an offer: build the swap, pay with our cash, collect the
    seller's signature, finalise (reference: BuyerFlow +
    TwoPartyTradeFlow.Buyer)."""

    MAX_PRICE = 10_000_000

    def __init__(self, session):
        self.session = session

    def call(self):
        from ..flows import ReceiveTransactionFlow

        offer = self.session.receive(SellOffer).unwrap(self._validate)
        self.sub_flow(ReceiveTransactionFlow(self.session, record=True))
        paper = offer.paper.state.data
        me = self.our_identity
        seller = self.session.counterparty

        refs = self.record(
            lambda: [
                sr.ref
                for sr in select_cash(self, offer.currency, offer.price)
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
        builder = TransactionBuilder(notary=offer.paper.state.notary)
        builder.add_input_state(offer.paper)
        builder.add_output_state(
            paper.with_new_owner(me), CP_PROGRAM_ID
        )
        signers = {seller.owning_key}
        remaining = offer.price
        for sr in selected:
            cash = sr.state.data
            builder.add_input_state(sr)
            signers.add(cash.owner.owning_key)
            pay = min(remaining, cash.amount.quantity)
            remaining -= pay
            if pay:
                builder.add_output_state(
                    CashState(Amount(pay, cash.amount.token), seller),
                    CASH_PROGRAM_ID,
                )
            change = cash.amount.quantity - pay
            if change:
                builder.add_output_state(
                    CashState(Amount(change, cash.amount.token), me),
                    CASH_PROGRAM_ID,
                )
        builder.add_command(Move(), *sorted(
            signers, key=lambda k: (k.scheme_id, k.encoded)
        ))
        stx = self.sign_builder(builder)
        stx = self.sub_flow(CollectSignaturesFlow(stx, [self.session]))
        return self.sub_flow(FinalityFlow(stx))

    def _validate(self, offer: SellOffer) -> SellOffer:
        if not isinstance(offer.paper.state.data, CommercialPaperState):
            raise FlowException("offered state is not commercial paper")
        if not (0 < offer.price <= self.MAX_PRICE):
            raise FlowException(f"unacceptable price {offer.price}")
        return offer


# ------------------------------------------------------------- the demo

@dataclasses.dataclass
class _IssuePaper(FlowLogic):
    # module-level (not nested in issue_paper): a PARKED flow is rebuilt
    # from its class path on resume, and a <locals> class has none
    notary: Party
    face: int
    maturity: float

    def call(self):
        me = self.our_identity
        issuance = PartyAndReference(me, b"\x42")
        from ..ledger import Issued

        paper = CommercialPaperState(
            issuance=issuance, owner=me,
            face_value=Amount(self.face, Issued(issuance, "GBP")),
            maturity_date=self.maturity,
        )
        b = TransactionBuilder(notary=self.notary)
        b.add_output_state(paper, CP_PROGRAM_ID)
        b.add_command(Issue(), me.owning_key)
        # a real validity margin — an exactly-now expiry would rest
        # entirely on the notary's 30s tolerance
        b.set_time_window(TimeWindow(
            None, int((time.time() + 3600) * 1_000_000)
        ))
        stx = self.sign_builder(b)
        return self.sub_flow(FinalityFlow(stx))


def issue_paper(node, notary: Party, face: int = 1000,
                maturity_days: float = 30.0, timeout: float = 300.0):
    """Self-issue commercial paper (the role the bank plays in the
    reference demo). Generous timeout: the first notarisation through a
    device notary pays one-time kernel compiles."""
    maturity = time.time() + maturity_days * 86400
    return node.run_flow(_IssuePaper(notary, face, maturity),
                         timeout=timeout)


def run_demo(n_trades: int = 1, verbose: bool = True, device=None) -> dict:
    """Run the full demo on an in-process ensemble on ``device`` (the card
    unless ``device="cpu"``); returns a summary."""
    from ..ledger import StateRef
    from ..testing.mocknet import MockNetworkNodes

    dev = resolve_device(device)
    t0 = time.time()
    with MockNetworkNodes(device=dev) as net:
        bank = net.create_node("Bank A")      # seller
        buyer = net.create_node("Bank B")     # buyer
        notary = net.create_notary_node("Notary", validating=True)

        buyer.run_flow(CashIssueFlow(
            n_trades * 1500, "GBP", b"\x01", notary.party
        ))
        trades = []
        for i in range(n_trades):
            issued = issue_paper(bank, notary.party, face=1000)
            paper_sar = bank.services.to_state_and_ref(
                StateRef(issued.id, 0)
            )
            stx = bank.run_flow(SellerFlow(
                buyer.party, paper_sar, 900, "GBP"
            ))
            trades.append(stx.id)
        # post-conditions: buyer owns papers, bank holds the cash
        papers = buyer.services.vault_service.unconsumed_states(
            CommercialPaperState
        )
        bank_cash = sum(
            sr.state.data.amount.quantity
            for sr in bank.services.vault_service.unconsumed_states(CashState)
        )
        summary = {
            "trades": len(trades),
            "buyer_papers": len(papers),
            "seller_cash": bank_cash,
            "elapsed_s": round(time.time() - t0, 3),
        }
    if verbose:
        print(f"trader-demo: {summary}")
    return summary


if __name__ == "__main__":
    run_demo()
