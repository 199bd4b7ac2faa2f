"""The trader demo (samples/trader-demo, BASELINE config #1), the port's
against the reference's: one trade through ``run_demo`` gives the
reference's summary less its time; ``SellOffer`` travels as the
reference's bytes; and concurrent trades (the shape of the reference's
``tests/test_samples.py`` concurrent test, kept to three trades for the
CPU's cost: a trade through the plain versions takes seconds) settle
exactly once in both packages. The port runs on ``device="cpu"``."""

import time

import pytest
import torch

import corda_tpu.finance  # noqa: F401  (registers the reference's contracts)
from corda_tpu.finance import CashIssueFlow as RefCashIssueFlow
from corda_tpu.finance import CashState as RefCashState
from corda_tpu.finance import CommercialPaperState as RefCPState
from corda_tpu.ledger import StateRef as RefStateRef
from corda_tpu.samples import trader_demo as ref_demo
from corda_tpu.serialization import serialize as ref_serialize
from corda_tpu.serving import shutdown_scheduler as ref_shutdown_scheduler
from corda_tpu.testing import MockNetworkNodes as RefMockNetworkNodes
from corda_tpu_torch.finance import CashIssueFlow, CashState, CommercialPaperState
from corda_tpu_torch.ledger import StateRef
from corda_tpu_torch.samples import trader_demo
from corda_tpu_torch.serialization import deserialize, serialize
from corda_tpu_torch.serving import shutdown_scheduler
from corda_tpu_torch.testing import mocknet as port_mocknet

PKGS = {
    "ref": (ref_demo, RefMockNetworkNodes, RefCashIssueFlow, RefCashState,
            RefCPState, RefStateRef, {}),
    "port": (trader_demo, port_mocknet.MockNetworkNodes, CashIssueFlow, CashState,
             CommercialPaperState, StateRef, {"device": "cpu"}),
}


@pytest.fixture(scope="module", autouse=True)
def cpu_setup():
    """One torch thread (the plain versions only contend with the suite's
    other workers), and the port's nodes park a waiting flow after 30 s,
    not 1 s (the plain versions make its waits long on the CPU; a park
    changes when a flow resumes, not what it computes)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    grace = port_mocknet.MOCK_PARKING_GRACE_S
    port_mocknet.MOCK_PARKING_GRACE_S = 30.0
    yield
    port_mocknet.MOCK_PARKING_GRACE_S = grace
    torch.set_num_threads(before)
    shutdown_scheduler()
    ref_shutdown_scheduler()


def test_one_trade_summary_matches_reference():
    port = trader_demo.run_demo(n_trades=1, verbose=False, device="cpu")
    ref = ref_demo.run_demo(n_trades=1, verbose=False)
    assert set(port) == set(ref)
    drop = lambda d: {k: v for k, v in d.items() if k != "elapsed_s"}  # noqa: E731
    assert drop(port) == drop(ref) == {"trades": 1, "buyer_papers": 1, "seller_cash": 900}


def test_sell_offer_bytes_match_reference():
    """A paper issued in the reference's network, carried to the port, is
    offered with the same fields: the port's ``SellOffer`` (wire name
    ``samples.SellOffer``) encodes to the reference's bytes and back."""
    with RefMockNetworkNodes() as net:
        bank = net.create_node("Bank A")
        notary = net.create_notary_node("Notary", validating=True)
        issued = ref_demo.issue_paper(bank, notary.party, face=1000)
        paper = bank.services.to_state_and_ref(RefStateRef(issued.id, 0))
    want = ref_serialize(ref_demo.SellOffer(paper, 900, "GBP"))
    offer = trader_demo.SellOffer(deserialize(ref_serialize(paper)), 900, "GBP")
    assert serialize(offer) == want
    assert deserialize(want) == offer


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_concurrent_trades_settle_once(pkg):
    """Three offers in flight at once: every seller flow completes, the
    buyer holds the three papers and the seller exactly the price of each
    (the buyer's soft locks keep concurrent selections apart)."""
    demo, Net, Issue, Cash, CP, Ref, net_kw = PKGS[pkg]
    n = 3
    with Net(**net_kw) as net:
        bank = net.create_node("Bank A")
        buyer = net.create_node("Bank B")
        notary = net.create_notary_node("Notary", validating=True)
        papers = []
        for _ in range(n):
            buyer.run_flow(Issue(1500, "GBP", b"\x01", notary.party), timeout=300)
            issued = demo.issue_paper(bank, notary.party)
            papers.append(bank.services.to_state_and_ref(Ref(issued.id, 0)))
        handles = [bank.smm.start_flow(demo.SellerFlow(buyer.party, sar, 900, "GBP"))
                   for sar in papers]
        for h in handles:
            assert h.result.result(timeout=300) is not None
        deadline = time.monotonic() + 10
        while bank.smm.flows_in_progress() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert bank.smm.flows_in_progress() == []
        seller_cash = sum(sr.state.data.amount.quantity
                          for sr in bank.services.vault_service.unconsumed_states(Cash))
        buyer_papers = len(buyer.services.vault_service.unconsumed_states(CP))
    assert (seller_cash, buyer_papers) == (900 * n, n)
