"""Finality, notarisation and state replacement between nodes: both
packages' ``MockNetworkNodes`` run the same script with Cash states.

The scenarios are those of the reference's
``tests/test_protocol_flows.py::TestFinality`` and ``TestStateReplacement``
(which drive a bond contract on a network of their own); here each
package's network holds Alice, Bob and three notary nodes: a validating
and a simple notary (the reference's sequential host services) and a
batched notary (the port's ``BatchedNotaryService`` on ``device="cpu"``,
the reference's on its host tier). The port's hubs run on
``device="cpu"`` (the plain versions of kernels A-E), the reference's on
its host routes. Each scenario uses a currency of its own, so coin
selection never crosses scenarios.

Compared between the packages (tolerance zero; tx ids differ, since a
builder draws a random privacy salt): each flow's result up to its ids
(its signers by name, its inputs' count, its outputs), every node's Cash
balance by currency, each notary's committed count, and each failure's
class: issue and move through each notary, a double spend refused with
``NotaryException``, an issue with no notarisation, a notary change (and
its rule that every participant signs), and a contract upgrade."""

import dataclasses
import types

import pytest
import torch

import corda_tpu.finance as ref_finance
import corda_tpu.flows as ref_flows
import corda_tpu.ledger as ref_ledger
import corda_tpu.notary as ref_notary
from corda_tpu.testing.mocknet import MockNetworkNodes as RefMockNetworkNodes
import corda_tpu_torch.finance as port_finance
import corda_tpu_torch.flows as port_flows
import corda_tpu_torch.ledger as port_ledger
import corda_tpu_torch.notary as port_notary
import corda_tpu_torch.testing.mocknet as port_mocknet
from corda_tpu.serving import shutdown_scheduler as ref_shutdown_scheduler
from corda_tpu_torch.serving import shutdown_scheduler

CURRENCIES = {"batched": "GBP", "simple": "USD", "validating": "EUR"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run many small integer ops: beside the suite's
    other worker processes a torch thread pool only contends."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def upgraded_contract(ledger, finance):
    """A Cash contract version 2 for ``ContractUpgradeFlow``: the same
    state, under a new contract name."""

    @ledger.register_contract("test.tf.CashV2")
    class CashV2:
        legacy_contract = finance.CASH_PROGRAM_ID

        @staticmethod
        def upgrade(old):
            return old

        def verify(self, tx):
            pass

    return CashV2


upgraded_contract(ref_ledger, ref_finance)
upgraded_contract(port_ledger, port_finance)


def package(name):
    if name == "port":
        ledger, finance, flows, notary = port_ledger, port_finance, port_flows, port_notary
    else:
        ledger, finance, flows, notary = ref_ledger, ref_finance, ref_flows, ref_notary
    return types.SimpleNamespace(ledger=ledger, finance=finance, flows=flows, notary=notary)


class Network:
    """One package's network: Alice, Bob and the three notary nodes."""

    def __init__(self, name):
        self.pkg = pkg = package(name)
        if name == "port":
            self.net = port_mocknet.MockNetworkNodes(device="cpu")
            batched = self.net.create_notary_node("BNotary", batched=True, max_batch=8,
                                                  window_s=0.005)
        else:
            self.net = RefMockNetworkNodes()
            batched = self.net.create_node(
                "BNotary", validating_notary=True,
                notary_service_factory=lambda party, kp: pkg.notary.BatchedNotaryService(
                    party, kp, pkg.notary.InMemoryUniquenessProvider(), use_device=False,
                    max_batch=8, window_s=0.005))
        self.alice = self.net.create_node("Alice")
        self.bob = self.net.create_node("Bob")
        self.notaries = {
            "batched": batched,
            "validating": self.net.create_notary_node("VNotary", validating=True),
            "simple": self.net.create_notary_node("SNotary", validating=False),
        }
        self.names = {n.party.owning_key: str(n.party.name.organisation)
                      for n in [self.alice, self.bob, *self.notaries.values()]}

    def issue(self, notary, currency, quantity=1000):
        return self.alice.run_flow(self.pkg.finance.CashIssueFlow(
            quantity, currency, b"\x01", self.notaries[notary].party), timeout=300)

    def pay(self, currency, quantity=300):
        return self.alice.run_flow(self.pkg.finance.CashPaymentFlow(
            quantity, currency, self.bob.party), timeout=300)

    def respend(self, stx, index=0):
        """Alice finalises a second move of an output she already spent."""
        ledger = self.pkg.ledger
        sar = self.alice.services.to_state_and_ref(ledger.StateRef(stx.id, index))
        state = sar.state.data
        b = ledger.TransactionBuilder(notary=sar.state.notary)
        b.add_input_state(sar)
        b.add_output_state(dataclasses.replace(state, owner=self.alice.party),
                           self.pkg.finance.CASH_PROGRAM_ID)
        b.add_command(self.pkg.finance.Move(), self.alice.party.owning_key)
        stx = self.alice.services.sign_initial_transaction(b)
        return failure(lambda: self.alice.run_flow(self.pkg.flows.FinalityFlow(stx),
                                                   timeout=300))

    def summary(self, stx):
        """A flow's result up to its ids."""
        return (sorted(self.names[s.by] for s in stx.sigs), len(stx.inputs),
                [(ts.contract, ts.data.amount.quantity, ts.data.amount.token.product,
                  self.names[ts.data.owner.owning_key], str(ts.notary.name.organisation))
                 for ts in stx.tx.outputs])

    def balances(self):
        out = {}
        for who, node in (("Alice", self.alice), ("Bob", self.bob)):
            for sr in node.services.vault_service.unconsumed_states(
                    self.pkg.finance.CashState):
                amount = sr.state.data.amount
                key = (who, amount.token.product, sr.state.contract)
                out[key] = out.get(key, 0) + amount.quantity
        return out

    def committed(self):
        return {k: n.services.notary_service.uniqueness.committed_txs()
                for k, n in self.notaries.items()}

    def stop(self):
        self.net.stop()


def failure(fn):
    try:
        fn()
    except Exception as e:  # the failure is the outcome compared
        return type(e).__name__
    return None


@pytest.fixture(scope="module")
def nets():
    """Both packages' networks; the port's nodes park a waiting flow after
    30 s here, not 1 s (the plain versions make its waits long on the CPU;
    a park changes when a flow resumes, not what it computes)."""
    grace = port_mocknet.MOCK_PARKING_GRACE_S
    port_mocknet.MOCK_PARKING_GRACE_S = 30.0
    port, ref = Network("port"), Network("ref")
    yield port, ref
    port.stop()
    ref.stop()
    port_mocknet.MOCK_PARKING_GRACE_S = grace
    shutdown_scheduler()
    ref_shutdown_scheduler()


def both(nets, fn):
    port, ref = nets
    got, want = fn(port), fn(ref)
    assert got == want
    return got


def test_issue_needs_no_notarisation(nets):
    """An issue (no inputs, no time window) is signed by Alice alone."""
    got = both(nets, lambda n: (n.summary(n.issue("batched", "SEK", 50)), n.committed()))
    assert got[0][0] == ["Alice"]
    assert got[1] == {"batched": 0, "validating": 0, "simple": 0}


@pytest.mark.parametrize("notary", ["batched", "validating", "simple"])
def test_issue_move_and_double_spend(nets, notary):
    """Alice issues 1,000 and pays Bob 300 (the change back to her),
    notarised by each notary kind (the simple one sees a tear-off); Bob
    records the payment and its back-chain. A second move of the spent
    issue output is refused with NotaryException."""
    currency = CURRENCIES[notary]

    def script(n):
        issue = n.issue(notary, currency)
        moved = n.pay(currency)
        return (n.summary(moved), n.respend(issue), n.balances(), n.committed(),
                n.bob.services.validated_transactions.get(issue.id) is not None)

    summary, respent, balances, committed, bob_has_chain = both(nets, script)
    name = {"batched": "BNotary", "validating": "VNotary", "simple": "SNotary"}[notary]
    assert summary[0] == sorted(["Alice", name])
    assert respent == "NotaryException"
    assert balances[("Alice", currency, port_finance.CASH_PROGRAM_ID)] == 700
    assert balances[("Bob", currency, port_finance.CASH_PROGRAM_ID)] == 300
    assert committed[notary] == 1
    assert bob_has_chain


def test_notary_change(nets):
    """Alice re-points an issued state from the validating to the simple
    notary; the state then moves under the simple notary."""

    def script(n):
        issue = n.issue("validating", "CHF")
        sar = n.alice.services.to_state_and_ref(n.pkg.ledger.StateRef(issue.id, 0))
        new_sar = n.alice.run_flow(
            n.pkg.flows.NotaryChangeFlow(sar, n.notaries["simple"].party), timeout=300)
        same = new_sar.state.data == sar.state.data
        moved = n.pay("CHF")
        return (str(new_sar.state.notary.name.organisation), same, n.summary(moved),
                n.balances(), n.committed())

    notary, same, summary, _balances, _committed = both(nets, script)
    assert notary == "SNotary" and same
    assert summary[0] == ["Alice", "SNotary"]


def test_notary_change_requires_participant_signers(nets):
    """A notary-change transaction whose command omits the participant's
    key is refused by the ledger in both packages."""

    def script(n):
        ledger = n.pkg.ledger
        issue = n.issue("validating", "NOK", 10)
        sar = n.alice.services.to_state_and_ref(ledger.StateRef(issue.id, 0))
        b = ledger.TransactionBuilder(notary=n.notaries["validating"].party)
        b.add_input_state(sar)
        b.add_output_state(sar.state.data, sar.state.contract,
                           notary=n.notaries["simple"].party)
        b.add_command(ledger.NotaryChangeCommand(n.notaries["simple"].party),
                      n.bob.party.owning_key)
        stx = n.bob.services.sign_initial_transaction(b)
        ltx = stx.tx.to_ledger_transaction(n.alice.services.load_state)
        try:
            ltx.verify()
        except ledger.TransactionVerificationException as e:
            return "missing a participant signer" in str(e)
        return False

    assert both(nets, script) is True


def test_contract_upgrade(nets):
    """Alice upgrades an issued Cash state to the test's Cash version 2."""

    def script(n):
        issue = n.issue("validating", "JPY")
        sar = n.alice.services.to_state_and_ref(n.pkg.ledger.StateRef(issue.id, 0))
        new_sar = n.alice.run_flow(
            n.pkg.flows.ContractUpgradeFlow(sar, "test.tf.CashV2"), timeout=300)
        return (new_sar.state.contract, new_sar.state.data == sar.state.data,
                n.balances(), n.committed())

    contract, same, balances, committed = both(nets, script)
    assert contract == "test.tf.CashV2" and same
    assert balances[("Alice", "JPY", "test.tf.CashV2")] == 1000
    assert committed["validating"] >= 2


def test_notary_nodes_run_their_services(nets):
    """Each notary node's hub holds the service its factory built (the
    batched one on the network's device), and the network map advertises
    each as the reference's does (a validating notary is sent the whole
    transaction, which it resolves through the hub's ``load_state``)."""
    port, ref = nets
    kinds = {"batched": "BatchedNotaryService", "validating": "ValidatingNotaryService",
             "simple": "SimpleNotaryService"}
    for n in (port, ref):
        for kind, node in n.notaries.items():
            assert type(node.services.notary_service).__name__ == kinds[kind]
            assert node.services.notary_service.identity == node.party
    assert str(port.notaries["batched"].services.notary_service.device) == "cpu"
    assert [port.net.nmap.is_validating_notary(n.party) for n in port.notaries.values()] == [
        ref.net.nmap.is_validating_notary(n.party) for n in ref.notaries.values()] == [
        True, True, False]
