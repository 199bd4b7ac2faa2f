"""The validating notary, the port's against the reference's, over the same
requests: testing.notary_stream with its contract-invalid kinds (value not
conserved, a move its input's owner did not sign, an unresolvable input),
carried across as CBE bytes, each side resolving inputs over its own copy of
the issue transaction.

The port runs ``BatchedNotaryService(validating=True)`` on ``device="cpu"``
(the plain versions of its kernels) on each ed25519 tier, the reference its
host tier (``use_device=False``). Each slot must give the same outcome kind,
error class and message, conflict and signature bytes (tolerance zero).
Also ``verify_ledger_batch`` on single transactions, valid and invalid in
each way the ledger layer checks, against the reference's, a Commodity
issue and move among them; and a contract of the reference's samples,
which the port does not register yet, raises ``NotImplementedError`` in
the port when no attachment carries its code."""

import dataclasses

import pytest
import torch

import corda_tpu.finance  # noqa: F401  (registers the reference's Cash contract)
from corda_tpu.crypto.keys import KeyPair as RefKeyPair
from corda_tpu.crypto.keys import PrivateKey as RefPrivateKey
from corda_tpu.ledger.ledger_tx import verify_ledger_batch as ref_verify_ledger_batch
from corda_tpu.notary import BatchedNotaryService as RefNotary
from corda_tpu.notary import PersistentUniquenessProvider as RefPersistent
from corda_tpu.serialization import deserialize as ref_deserialize
from corda_tpu.serving import shutdown_scheduler as ref_shutdown_scheduler
from corda_tpu_torch.crypto import ed25519_host
from corda_tpu_torch.finance import (
    CASH_PROGRAM_ID,
    COMMODITY_PROGRAM_ID,
    CashState,
    CommodityState,
    Exit,
    Issue,
    Move,
)
from corda_tpu_torch.ledger import (
    Amount,
    Issued,
    PartyAndReference,
    NotaryChangeCommand,
    PrivacySalt,
    TransactionBuilder,
    UpgradeCommand,
    verify_ledger_batch,
)
from corda_tpu_torch.notary import (
    BatchedNotaryService,
    InMemoryUniquenessProvider,
    PersistentUniquenessProvider,
)
from corda_tpu_torch.ops.ed25519 import Ed25519Tier
from corda_tpu_torch.serialization import deserialize, serialize
from corda_tpu_torch.serving import shutdown_scheduler
from corda_tpu_torch.testing import (
    CONTRACT_INVALID_KINDS,
    _party,
    notary_stream,
    outcome_kind,
    state_resolver,
)

NOW = 1_800_000_000.0  # both notaries' clock, in unix seconds
TIERS = [Ed25519Tier(), Ed25519Tier(8192, 4), Ed25519Tier(4096, 8), Ed25519Tier(4096, 4)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run many small integer ops: beside the suite's
    other worker processes a torch thread pool only contends, so these
    tests run torch on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def shared_schedulers():
    """Both packages' process-global schedulers, shut down after the module."""
    yield
    shutdown_scheduler()
    ref_shutdown_scheduler()


@pytest.fixture(scope="module")
def stream():
    """6 moves, the 7 adversarial requests and the 3 contract-invalid ones,
    in 4 windows of 4."""
    return notary_stream(6, 4, seed=5, contract_invalid=True, device="cpu")


def port_windows(stream):
    """Fresh copies, id caches cold, inputs resolved over the issue."""
    resolve = state_resolver(deserialize(serialize(stream.issue)).tx)
    return [[(deserialize(serialize(stx)), resolve, "alice") for stx in w]
            for w in stream.windows]


def ref_windows(stream):
    resolve = state_resolver(ref_deserialize(serialize(stream.issue)).tx)
    return [[(ref_deserialize(serialize(stx)), resolve, "alice") for stx in w]
            for w in stream.windows]


def port_notary(stream, **kw):
    return BatchedNotaryService(
        stream.notary, stream.notary_keypair, PersistentUniquenessProvider(),
        max_batch=16, clock=lambda: NOW, device="cpu", **kw)


def ref_notary(stream):
    identity = ref_deserialize(serialize(stream.notary))
    keypair = RefKeyPair(identity.owning_key, RefPrivateKey(
        4, stream.notary_keypair.private.encoded))
    return RefNotary(identity, keypair, RefPersistent(), use_device=False,
                     validating=True, max_batch=16, clock=lambda: NOW)


def conflict_of(result):
    c = getattr(result, "conflict", None)
    if c is None:
        return None
    return sorted((ref.txhash.bytes, ref.index, d.consuming_tx.bytes, d.input_index,
                   d.requesting_party_name) for ref, d in c.state_history.items())


def assert_same_results(got, want, requests, kinds):
    assert [outcome_kind(r) for r in got] == [outcome_kind(r) for r in want] == kinds
    for g, w, (stx, _r, _c) in zip(got, want, requests):
        assert conflict_of(g) == conflict_of(w)
        if outcome_kind(g) == "signed":
            assert g.signature == w.signature
            assert g.by.encoded == w.by.encoded
            assert ed25519_host.verify(g.by.encoded, g.signature, g.signable_for(stx.id))
        else:
            assert (type(g).__name__, str(g)) == (type(w).__name__, str(w))


def test_stream_places_the_contract_invalid_kinds(stream):
    flat = [k for w in stream.kinds for k in w]
    for _name, kind in CONTRACT_INVALID_KINDS:
        assert flat.count(kind) == 1
    assert [k for w in stream.kinds_nonvalidating for k in w].count("signed") == \
        flat.count("signed") + len(CONTRACT_INVALID_KINDS)


@pytest.mark.parametrize("tier", TIERS, ids=lambda t: f"{t.radix}-{t.fixed_win}")
def test_process_stream_matches_reference(stream, tier):
    port_reqs = port_windows(stream)
    got = port_notary(stream, tier=tier).process_stream(port_reqs, depth=2)
    want = ref_notary(stream).process_stream(ref_windows(stream), depth=2)
    assert len(got) == len(want) == len(stream.windows)
    for g, w, reqs, kinds in zip(got, want, port_reqs, stream.kinds):
        assert_same_results(g, w, reqs, kinds)


@pytest.mark.parametrize("route", ["direct", "host"])
def test_process_batch_matches_reference(stream, route):
    kw = {"direct": {"use_scheduler": False}, "host": {"use_device": False}}[route]
    port_reqs = [r for w in port_windows(stream) for r in w]
    got = port_notary(stream, **kw).process_batch(port_reqs)
    want = ref_notary(stream).process_batch([r for w in ref_windows(stream) for r in w])
    assert_same_results(got, want, port_reqs, [k for w in stream.kinds for k in w])


def test_non_validating_notary_signs_the_contract_invalid_kinds(stream):
    got = port_notary(stream, validating=False).process_stream(port_windows(stream), depth=2)
    assert [[outcome_kind(r) for r in w] for w in got] == stream.kinds_nonvalidating


# ------------------------------------------- single ledger transactions


@pytest.fixture(scope="module")
def ledger_cases(stream):
    """(name, port wire transaction) pairs that exercise each check of
    ``verify_ledger_batch``: built with the port's builder from the
    stream's issue outputs, which both sides resolve."""
    issue = stream.issue.tx
    alice, notary = stream.alice, stream.notary
    bob, _ = _party(b"Bob Inc")
    other, _ = _party(b"Other Notary")
    token = issue.outputs[0].data.amount.token
    spare = len(issue.outputs) - 1  # an issue output no request spends

    def tx(inputs=(), outputs=(), commands=(), on=notary, encumbrance=None):
        b = TransactionBuilder(notary=on)
        b.set_privacy_salt(PrivacySalt(bytes([1]) * 32))
        for i in inputs:
            b.add_input_state(issue.out_ref(i))
        for k, (qty, owner) in enumerate(outputs):
            b.add_output_state(CashState(Amount(qty, token), owner), CASH_PROGRAM_ID,
                               encumbrance=encumbrance if k == 0 else None)
        for value, *signers in commands:
            b.add_command(value, *[p.owning_key for p in signers])
        return b.to_wire_transaction()

    q = issue.outputs[spare].data.amount.quantity
    cases = [
        ("valid_move", tx([spare], [(q, bob)], [(Move(), alice)])),
        ("split_move", tx([spare], [(q - 1, bob), (1, alice)], [(Move(), alice)])),
        ("value_not_conserved", tx([spare], [(q + 1, bob)], [(Move(), alice)])),
        ("owner_not_signed", tx([spare], [(q, bob)], [(Move(), bob)])),
        ("exit_signed", tx([spare], [(q - 5, alice)],
                           [(Exit(Amount(5, token)), alice), (Move(), alice)])),
        ("exit_without_issuer", tx([spare], [(q - 5, bob)],
                                   [(Exit(Amount(5, token)), bob), (Move(), alice)])),
        ("consumed_without_exit", tx([spare], [], [(Move(), alice)])),
        ("issue_unsigned", tx([], [(7, alice)], [(Move(), alice)])),
        ("bad_encumbrance", tx([spare], [(q, bob)], [(Move(), alice)], encumbrance=3)),
        ("input_other_notary", tx([spare], [(q, bob)], [(Move(), alice)], on=other)),
        ("notary_change", None),
        ("notary_change_altered", None),
        ("upgrade_unknown_contract", tx([spare], [(q, alice)],
                                        [(UpgradeCommand("finance.CashV2"), alice)])),
    ]
    # notary change: each input re-pointed verbatim at the new notary
    b = TransactionBuilder(notary=notary)
    b.set_privacy_salt(PrivacySalt(bytes([1]) * 32))
    b.add_input_state(issue.out_ref(spare))
    b.add_output_state(issue.outputs[spare].data, CASH_PROGRAM_ID, notary=other)
    b.add_command(NotaryChangeCommand(other), alice.owning_key)
    changed = b.to_wire_transaction()
    cases[-3] = ("notary_change", changed)
    cases[-2] = ("notary_change_altered", dataclasses.replace(
        changed, outputs=(dataclasses.replace(
            changed.outputs[0], data=CashState(Amount(q + 1, token), alice)),)))
    return cases


def test_verify_ledger_batch_matches_reference(stream, ledger_cases):
    port_resolve = state_resolver(stream.issue.tx)
    ref_resolve = state_resolver(ref_deserialize(serialize(stream.issue)).tx)
    port_ltxs = [w.to_ledger_transaction(port_resolve) for _n, w in ledger_cases]
    ref_ltxs = [ref_deserialize(serialize(w)).to_ledger_transaction(ref_resolve)
                for _n, w in ledger_cases]
    assert [t.id for t in port_ltxs] == [w.id for _n, w in ledger_cases]

    def shown(errs):
        return [None if e is None else (type(e).__name__, str(e)) for e in errs]

    got = shown(verify_ledger_batch(port_ltxs))
    assert got == shown(ref_verify_ledger_batch(ref_ltxs))
    # each transaction alone gives its slot of the batch
    for ltx, slot in zip(port_ltxs, got):
        assert shown(verify_ledger_batch([ltx])) == [slot]
    valid = {n for (n, _w), e in zip(ledger_cases, got) if e is None}
    assert valid == {"valid_move", "split_move", "exit_signed", "notary_change"}


def test_commodity_matches_reference(stream):
    """``finance.Commodity``, which the port now registers: an issue and a
    move its owner did not sign get the reference's slots."""
    alice, bob = stream.alice, _party(b"Bob Inc")[0]
    gold = Amount(100, Issued(PartyAndReference(alice, b"\x02"), "GOLD"))
    b = TransactionBuilder(notary=stream.notary)
    b.set_privacy_salt(PrivacySalt(bytes([3]) * 32))
    b.add_output_state(CommodityState(gold, alice), COMMODITY_PROGRAM_ID)
    b.add_command(Issue(), alice.owning_key)
    issue = b.to_wire_transaction()
    m = TransactionBuilder(notary=stream.notary)
    m.set_privacy_salt(PrivacySalt(bytes([4]) * 32))
    m.add_input_state(issue.out_ref(0))
    m.add_output_state(CommodityState(gold, bob), COMMODITY_PROGRAM_ID)
    m.add_command(Move(), bob.owning_key)
    wtxs = [issue, m.to_wire_transaction()]
    port_ltxs = [w.to_ledger_transaction(state_resolver(issue)) for w in wtxs]
    ref_issue = ref_deserialize(serialize(issue))
    ref_ltxs = [ref_deserialize(serialize(w)).to_ledger_transaction(state_resolver(ref_issue))
                for w in wtxs]

    def shown(errs):
        return [None if e is None else (type(e).__name__, str(e)) for e in errs]

    got = shown(verify_ledger_batch(port_ltxs))
    assert got == shown(ref_verify_ledger_batch(ref_ltxs))
    assert got[0] is None and "input owners must sign a move" in got[1][1]


def test_unregistered_contract_is_not_ported(stream):
    """A contract of the reference's samples, which the port does not
    register yet, raises rather than being rejected when no transaction
    attachment carries it (tests/test_torch_attachments.py holds the
    carried case)."""
    alice = stream.alice
    b = TransactionBuilder(notary=stream.notary)
    b.add_output_state(stream.issue.tx.outputs[0].data, "samples.DocumentContract")
    b.add_command(Move(), alice.owning_key)
    ltx = b.to_wire_transaction().to_ledger_transaction(state_resolver())
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 13"):
        verify_ledger_batch([ltx])
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 13"):
        ltx.verify()


def test_validating_notary_rejects_an_unresolvable_input(stream):
    """Every input of every request unresolvable: all but the requests
    rejected earlier (signatures, notary, time window) come back as
    ``unresolvable_input``, and nothing is committed."""
    provider = InMemoryUniquenessProvider()
    svc = BatchedNotaryService(stream.notary, stream.notary_keypair, provider,
                               max_batch=16, clock=lambda: NOW, device="cpu")
    reqs = [(stx, state_resolver(), c) for stx, _r, c in port_windows(stream)[0]]
    kinds = [outcome_kind(r) for r in svc.process_batch(reqs)]
    assert set(kinds) == {"unresolvable_input"}
    assert provider.committed_txs() == 0


def test_unknown_contract_fails_its_own_slot(stream, monkeypatch):
    """A contract neither package registers, on a transaction that carries
    no attachment beyond the contracts' code stand-ins, is rejected in its
    own slot with the reference's exception and message: by
    ``verify_ledger_batch`` beside valid transactions, and by the notary,
    which answers every other request of the window. The reference runs
    with no attachment store, as the port has none (a node elsewhere in
    the same test process may have left its fetcher installed)."""
    monkeypatch.setattr("corda_tpu.ledger.attachment_code._attachment_fetcher", None)
    alice, akp = _party(b"Alice Corp")
    b = TransactionBuilder(notary=stream.notary)
    b.set_privacy_salt(PrivacySalt(bytes([2]) * 32))
    b.add_output_state(stream.issue.tx.outputs[0].data, "no.such.Contract")
    b.add_command(Move(), alice.owning_key)
    unknown = b.sign_initial_transaction(akp)

    def shown(errs):
        return [None if e is None else (type(e).__name__, str(e)) for e in errs]

    port_resolve = state_resolver(stream.issue.tx)
    ref_resolve = state_resolver(ref_deserialize(serialize(stream.issue)).tx)
    valid = [stx.tx for stx in stream.windows[0]][:2]
    port_ltxs = [w.to_ledger_transaction(port_resolve) for w in (valid[0], unknown.tx, valid[1])]
    ref_ltxs = [ref_deserialize(serialize(w)).to_ledger_transaction(ref_resolve)
                for w in (valid[0], unknown.tx, valid[1])]
    got = shown(verify_ledger_batch(port_ltxs))
    assert got == shown(ref_verify_ledger_batch(ref_ltxs))
    assert got[0] is None and got[2] is None
    assert got[1][0] == "TransactionVerificationException"
    assert "unknown contract 'no.such.Contract': not registered" in got[1][1]

    port_reqs = port_windows(stream)[0] + [
        (deserialize(serialize(unknown)), state_resolver(stream.issue.tx), "alice")]
    ref_reqs = ref_windows(stream)[0] + [
        (ref_deserialize(serialize(unknown)), ref_resolve, "alice")]
    got = port_notary(stream, use_scheduler=False).process_batch(port_reqs)
    want = ref_notary(stream).process_batch(ref_reqs)
    kinds = [outcome_kind(r) for r in want]
    assert kinds[:-1] == stream.kinds[0] and kinds[-1] != "signed"
    assert_same_results(got, want, port_reqs, kinds)
