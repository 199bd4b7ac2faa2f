"""Commodity, CommercialPaper and Obligation, the port's against the
reference's: the same wire transactions, built by the reference and carried
across as CBE bytes, each side resolving inputs over its own copy of one
genesis transaction.

``verify_ledger_batch`` must give the reference's slot for each
transaction, exception class and message included (tolerance zero), in one
batch and alone: valid issues, moves, exits, redemptions and settlements,
and one transaction for each ``_require`` of the three contracts that a
transaction can reach. Then a window of CommercialPaper requests through
both validating notaries on the CPU (the port on ``device="cpu"``, the
reference on its host tier): the same answer per request, signature bytes
included."""

import hashlib

import pytest
import torch

from corda_tpu.crypto import derive_keypair_from_entropy
from corda_tpu.crypto.keys import KeyPair as RefKeyPair
from corda_tpu.crypto.keys import PrivateKey as RefPrivateKey
from corda_tpu.finance import (
    CASH_PROGRAM_ID,
    COMMODITY_PROGRAM_ID,
    CP_PROGRAM_ID,
    OBLIGATION_PROGRAM_ID,
    CashState,
    CommercialPaperState,
    CommodityState,
    Exit,
    Issue,
    Move,
    ObligationState,
    Redeem,
    Settle,
)
from corda_tpu.ledger import (
    Amount,
    CordaX500Name,
    Issued,
    Party,
    PartyAndReference,
    PrivacySalt,
    TimeWindow,
    TransactionBuilder,
)
from corda_tpu.ledger.ledger_tx import verify_ledger_batch as ref_verify_ledger_batch
from corda_tpu.notary import BatchedNotaryService as RefNotary
from corda_tpu.notary import PersistentUniquenessProvider as RefPersistent
from corda_tpu.serialization import deserialize as ref_deserialize
from corda_tpu.serialization import serialize as ref_serialize
from corda_tpu.serving import shutdown_scheduler as ref_shutdown_scheduler
import corda_tpu_torch.finance as port_finance
from corda_tpu_torch import interop
from corda_tpu_torch.crypto import KeyPair, PrivateKey
from corda_tpu_torch.ledger import ledger_tx, verify_ledger_batch
from corda_tpu_torch.notary import BatchedNotaryService, PersistentUniquenessProvider
from corda_tpu_torch.serialization import deserialize
from corda_tpu_torch.serving import shutdown_scheduler
from corda_tpu_torch.testing import state_resolver

NOW = 1_800_000_000.0  # the notaries' clock, unix seconds
FUTURE = NOW + 365 * 86400.0
PAST = NOW - 86400.0
TW_NOW = TimeWindow(from_time=int((NOW - 10) * 1e6), until_time=int((NOW + 10) * 1e6))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _party(tag: bytes):
    kp = derive_keypair_from_entropy(4, hashlib.sha256(tag).digest())
    return Party(CordaX500Name(tag.decode(), "London", "GB"), kp.public), kp


ALICE, AKP = _party(b"Alice Corp")
BOB, BKP = _party(b"Bob Inc")
CAROL, _ = _party(b"Carol Ltd")
NOTARY, NKP = _party(b"Finance Notary")
CASH = Issued(PartyAndReference(ALICE, b"\x01"), "GBP")
GOLD = Issued(PartyAndReference(ALICE, b"\x02"), "GOLD")


def com(q, owner):
    return CommodityState(Amount(q, GOLD), owner)


def paper(owner, maturity, face=1000):
    return CommercialPaperState(CASH.issuer, owner, Amount(face, CASH), maturity)


def ob(q, owner, obligor=ALICE):
    return ObligationState(obligor, Amount(q, CASH), owner, FUTURE)


def cash(q, owner):
    return CashState(Amount(q, CASH), owner)


# the states the cases spend: (data, contract) of each genesis output
GENESIS = {
    "com_alice": (com(100, ALICE), COMMODITY_PROGRAM_ID),
    "com_bob": (com(50, BOB), COMMODITY_PROGRAM_ID),
    "com_zero": (com(0, ALICE), COMMODITY_PROGRAM_ID),
    "cp_alice": (paper(ALICE, FUTURE), CP_PROGRAM_ID),
    "cp_bob_matured": (paper(BOB, PAST), CP_PROGRAM_ID),
    "cp_twin_a": (paper(ALICE, FUTURE, 700), CP_PROGRAM_ID),
    "cp_twin_b": (paper(ALICE, FUTURE, 700), CP_PROGRAM_ID),
    "ob_bob": (ob(100, BOB), OBLIGATION_PROGRAM_ID),
    "ob_carol": (ob(100, CAROL), OBLIGATION_PROGRAM_ID),
    "cash_1000": (cash(1000, ALICE), CASH_PROGRAM_ID),
    "cash_500": (cash(500, ALICE), CASH_PROGRAM_ID),
}


@pytest.fixture(scope="module")
def genesis():
    """One reference transaction holding every state the cases spend; it is
    only resolved against, never verified."""
    b = TransactionBuilder(notary=NOTARY)
    b.set_privacy_salt(PrivacySalt(bytes([7]) * 32))
    for data, contract in GENESIS.values():
        b.add_output_state(data, contract)
    b.add_command(Issue(), ALICE.owning_key)
    return b.sign_initial_transaction(AKP)


def _spend(genesis, name):
    return genesis.tx.out_ref(list(GENESIS).index(name))


def _tx(genesis, k, inputs=(), outputs=(), commands=(), tw=None):
    b = TransactionBuilder(notary=NOTARY)
    b.set_privacy_salt(PrivacySalt(bytes([1 + k % 255]) * 32))
    for name in inputs:
        b.add_input_state(_spend(genesis, name))
    for data, contract in outputs:
        b.add_output_state(data, contract)
    for value, *signers in commands:
        b.add_command(value, *[p.owning_key for p in signers])
    if tw is not None:
        b.set_time_window(tw)
    return b


def _settle(genesis, k, settled=60, to_bob=60, signer=ALICE):
    return _tx(genesis, k, ["ob_bob", "cash_1000"],
               [(ob(100 - 60, BOB), OBLIGATION_PROGRAM_ID), (cash(to_bob, BOB), CASH_PROGRAM_ID),
                (cash(1000 - to_bob, ALICE), CASH_PROGRAM_ID)],
               [(Settle(Amount(settled, CASH)), signer), (Move(), ALICE)])


def _redeem(genesis, k, papers=("cp_bob_matured",), cash_in="cash_1000", paid=1000,
            payee=BOB, signer=BOB, cmd=Redeem, tw=TW_NOW):
    left = GENESIS[cash_in][0].amount.quantity - paid
    outputs = [(cash(paid, payee), CASH_PROGRAM_ID)]
    if left:
        outputs.append((cash(left, ALICE), CASH_PROGRAM_ID))
    return _tx(genesis, k, [*papers, cash_in], outputs, [(cmd(), signer), (Move(), ALICE)],
               tw=tw)


# (name, builder maker, the _require message it must fail with, or None)
CASES = [
    # Commodity
    ("com_issue", lambda g, k: _tx(g, k, [], [(com(100, ALICE), COMMODITY_PROGRAM_ID)],
                                   [(Issue(), ALICE)]), None),
    ("com_move", lambda g, k: _tx(g, k, ["com_alice"], [(com(60, BOB), COMMODITY_PROGRAM_ID),
                                                        (com(40, ALICE), COMMODITY_PROGRAM_ID)],
                                  [(Move(), ALICE)]), None),
    ("com_exit", lambda g, k: _tx(g, k, ["com_alice"], [(com(90, ALICE), COMMODITY_PROGRAM_ID)],
                                  [(Exit(Amount(10, GOLD)), ALICE), (Move(), ALICE)]), None),
    ("com_no_groups", lambda g, k: _tx(g, k, [], [(cash(5, ALICE), COMMODITY_PROGRAM_ID)],
                                       [(Issue(), ALICE)]), "no CommodityState groups"),
    ("com_zero_issue", lambda g, k: _tx(g, k, [], [(com(0, ALICE), COMMODITY_PROGRAM_ID)],
                                        [(Issue(), ALICE)]), "cannot issue zero value"),
    ("com_issue_unsigned", lambda g, k: _tx(g, k, [], [(com(100, ALICE), COMMODITY_PROGRAM_ID)],
                                            [(Issue(), BOB)]), "issuer must sign an issuance"),
    ("com_not_conserved", lambda g, k: _tx(g, k, ["com_alice"],
                                           [(com(101, BOB), COMMODITY_PROGRAM_ID)],
                                           [(Move(), ALICE)]), "value not conserved"),
    ("com_exit_unsigned", lambda g, k: _tx(g, k, ["com_bob"], [(com(40, BOB), COMMODITY_PROGRAM_ID)],
                                           [(Exit(Amount(10, GOLD)), BOB), (Move(), BOB)]),
     "exit requires the owners' and issuer's signatures"),
    ("com_move_unsigned", lambda g, k: _tx(g, k, ["com_alice"],
                                           [(com(100, BOB), COMMODITY_PROGRAM_ID)],
                                           [(Move(), BOB)]), "input owners must sign a move"),
    ("com_consumed", lambda g, k: _tx(g, k, ["com_zero"], [], [(Move(), ALICE)]),
     "inputs fully consumed with no outputs and no exit"),
    # CommercialPaper
    ("cp_issue", lambda g, k: _tx(g, k, [], [(paper(ALICE, FUTURE), CP_PROGRAM_ID)],
                                  [(Issue(), ALICE)], tw=TW_NOW), None),
    ("cp_move", lambda g, k: _tx(g, k, ["cp_alice"], [(paper(BOB, FUTURE), CP_PROGRAM_ID)],
                                 [(Move(), ALICE)]), None),
    ("cp_redeem", _redeem, None),
    ("cp_no_paper", lambda g, k: _tx(g, k, [], [(cash(5, ALICE), CP_PROGRAM_ID)],
                                     [(Issue(), ALICE)], tw=TW_NOW),
     "no commercial paper in transaction"),
    ("cp_issue_unsigned", lambda g, k: _tx(g, k, [], [(paper(ALICE, FUTURE), CP_PROGRAM_ID)],
                                           [(Issue(), BOB)], tw=TW_NOW),
     "issuer must sign a paper issuance"),
    ("cp_issue_no_window", lambda g, k: _tx(g, k, [], [(paper(ALICE, FUTURE), CP_PROGRAM_ID)],
                                            [(Issue(), ALICE)]),
     "paper must be issued before its maturity"),
    ("cp_issue_matured", lambda g, k: _tx(g, k, [], [(paper(ALICE, PAST), CP_PROGRAM_ID)],
                                          [(Issue(), ALICE)], tw=TW_NOW),
     "paper must be issued before its maturity"),
    ("cp_no_redeem", lambda g, k: _redeem(g, k, cmd=Move),
     "paper consumed without a Redeem command"),
    ("cp_redeem_early", lambda g, k: _redeem(g, k, papers=("cp_alice",), payee=ALICE,
                                             signer=ALICE),
     "paper may only be redeemed after maturity"),
    ("cp_redeem_no_window", lambda g, k: _redeem(g, k, tw=TimeWindow(until_time=10**15)),
     "paper may only be redeemed after maturity"),
    ("cp_redeem_unsigned", lambda g, k: _redeem(g, k, signer=ALICE),
     "paper owner must sign a redemption"),
    ("cp_two_in_one_out", lambda g, k: _tx(g, k, ["cp_twin_a", "cp_twin_b"],
                                           [(paper(BOB, FUTURE, 700), CP_PROGRAM_ID)],
                                           [(Move(), ALICE)]),
     "move is one paper in, one paper out"),
    ("cp_move_unsigned", lambda g, k: _tx(g, k, ["cp_alice"], [(paper(BOB, FUTURE), CP_PROGRAM_ID)],
                                          [(Move(), BOB)]), "paper owner must sign a move"),
    ("cp_redeem_underpaid", lambda g, k: _redeem(g, k, cash_in="cash_500", paid=500),
     "redemption must pay the face value to the owner"),
    # Obligation
    ("ob_issue", lambda g, k: _tx(g, k, [], [(ob(100, BOB), OBLIGATION_PROGRAM_ID)],
                                  [(Issue(), ALICE)]), None),
    ("ob_move", lambda g, k: _tx(g, k, ["ob_bob"], [(ob(100, CAROL), OBLIGATION_PROGRAM_ID)],
                                 [(Move(), BOB)]), None),
    ("ob_settle", _settle, None),
    ("ob_none", lambda g, k: _tx(g, k, [], [(cash(5, ALICE), OBLIGATION_PROGRAM_ID)],
                                 [(Issue(), ALICE)]), "no obligations in transaction"),
    ("ob_zero", lambda g, k: _tx(g, k, [], [(ob(0, BOB), OBLIGATION_PROGRAM_ID)],
                                 [(Issue(), ALICE)]), "cannot issue a zero obligation"),
    ("ob_issue_unsigned", lambda g, k: _tx(g, k, [], [(ob(100, BOB), OBLIGATION_PROGRAM_ID)],
                                           [(Issue(), BOB)]),
     "obligor must sign an obligation issuance"),
    ("ob_reduced_no_settle", lambda g, k: _tx(g, k, ["ob_bob"],
                                              [(ob(40, BOB), OBLIGATION_PROGRAM_ID)],
                                              [(Move(), BOB)]),
     "obligation reduced without a Settle command"),
    ("ob_two_beneficiaries", lambda g, k: _tx(g, k, ["ob_bob", "ob_carol"],
                                              [(ob(100, BOB), OBLIGATION_PROGRAM_ID)],
                                              [(Settle(Amount(100, CASH)), ALICE)]),
     "a settle group must have a single beneficiary"),
    ("ob_settle_unsigned", lambda g, k: _settle(g, k, signer=BOB),
     "obligor must sign a settlement"),
    ("ob_move_grows", lambda g, k: _tx(g, k, ["ob_bob"], [(ob(120, BOB), OBLIGATION_PROGRAM_ID)],
                                       [(Move(), BOB)]),
     "obligation amount not conserved by a move"),
    ("ob_move_unsigned", lambda g, k: _tx(g, k, ["ob_bob"], [(ob(100, CAROL), OBLIGATION_PROGRAM_ID)],
                                          [(Move(), CAROL)]),
     "beneficiary must sign an obligation move"),
    ("ob_settle_mismatch", lambda g, k: _settle(g, k, settled=50),
     "settled amount must equal the obligation reduction"),
    ("ob_settle_unpaid", lambda g, k: _settle(g, k, to_bob=30),
     "settlement must pay the beneficiary in matching cash"),
]


@pytest.fixture(scope="module")
def cases(genesis):
    """(name, reference wire transaction, port wire transaction, expected
    message or None)."""
    out = []
    for k, (name, make, want) in enumerate(CASES):
        wtx = make(genesis, k).to_wire_transaction()
        out.append((name, wtx, deserialize(ref_serialize(wtx)), want))
    return out


def shown(errs):
    return [None if e is None else (type(e).__name__, str(e)) for e in errs]


def test_contracts_match_reference(genesis, cases):
    port_genesis = interop.signed_transaction_from_reference(ref_serialize(genesis))
    port_resolve = state_resolver(port_genesis.tx)
    ref_resolve = state_resolver(genesis.tx)
    port_ltxs = [p.to_ledger_transaction(port_resolve) for _n, _r, p, _w in cases]
    ref_ltxs = [r.to_ledger_transaction(ref_resolve) for _n, r, _p, _w in cases]
    assert [t.id.bytes for t in port_ltxs] == [t.id.bytes for t in ref_ltxs]
    got = shown(verify_ledger_batch(port_ltxs))
    assert got == shown(ref_verify_ledger_batch(ref_ltxs))
    for ltx, slot in zip(port_ltxs, got):
        assert shown(verify_ledger_batch([ltx])) == [slot]
    for (name, _r, _p, want), slot in zip(cases, got):
        if want is None:
            assert slot is None, (name, slot)
        else:
            assert slot[0] == "TransactionVerificationException" and want in slot[1], (name, slot)


def test_reference_contracts_left_are_the_samples():
    assert ledger_tx.REFERENCE_CONTRACTS == {
        "samples.DocumentContract", "samples.simm.OGTrade", "samples.simm.PortfolioSwap",
        "samples.InterestRateSwap"}
    assert {port_finance.COMMODITY_PROGRAM_ID, port_finance.CP_PROGRAM_ID,
            port_finance.OBLIGATION_PROGRAM_ID} == {COMMODITY_PROGRAM_ID, CP_PROGRAM_ID,
                                                    OBLIGATION_PROGRAM_ID}


def test_validating_notary_answers_commercial_paper_as_reference(genesis):
    """A paper move, a redemption against cash and a move its owner did not
    sign, through both validating notaries: the same answer per request."""
    signers = {ALICE.owning_key: AKP, BOB.owning_key: BKP}
    requests = []
    for k, name in enumerate(["cp_move", "cp_redeem", "cp_move_unsigned"]):
        make = next(m for n, m, _w in CASES if n == name)
        b = make(genesis, 100 + k)
        keys = {key for c in b._commands for key in c.signers}
        requests.append(b.sign_initial_transaction(*[signers[key] for key in sorted(
            keys, key=lambda key: key.encoded)]))
    port_genesis = interop.signed_transaction_from_reference(ref_serialize(genesis))
    identity = deserialize(ref_serialize(NOTARY))
    port_notary = BatchedNotaryService(
        identity, KeyPair(identity.owning_key, PrivateKey(4, NKP.private.encoded)),
        PersistentUniquenessProvider(), max_batch=8, clock=lambda: NOW, device="cpu")
    ref_notary = RefNotary(NOTARY, RefKeyPair(NOTARY.owning_key, RefPrivateKey(
        4, NKP.private.encoded)), RefPersistent(), use_device=False, validating=True,
        max_batch=8, clock=lambda: NOW)
    try:
        got = port_notary.process_batch([
            (interop.signed_transaction_from_reference(ref_serialize(s)),
             state_resolver(port_genesis.tx), "alice") for s in requests])
        want = ref_notary.process_batch([
            (ref_deserialize(ref_serialize(s)), state_resolver(genesis.tx), "alice")
            for s in requests])
    finally:
        shutdown_scheduler()
        ref_shutdown_scheduler()

    def answer(r):
        if type(r).__name__ == "TransactionSignature":
            return ("signed", r.signature, r.by.encoded)
        return (type(r).__name__, str(r))

    assert [answer(r) for r in got] == [answer(r) for r in want]
    assert [a[0] for a in map(answer, got)][:2] == ["signed", "signed"]
    assert "paper owner must sign a move" in answer(got[2])[1]
