"""Contract code carried in attachments: the port's
``ledger/attachment_code.py`` and ``LedgerTransaction.contract_code_for``
against the reference's. Every hostile source of the reference's own
tests (tests/test_attachment_code.py), and more probes of the gate, get
the same accept or refuse verdict; the contracts that load export the
same names; transactions built in the port and carried across as CBE
bytes give the same outcome (error class and message) through ``verify``
and ``verify_ledger_batch`` in both packages: a valid attached move,
contract rejections, a broken ``HashAttachmentConstraint``, a hostile or
corrupt attachment, a registered contract shadowing attached code, an
unknown contract. A contract of the reference's samples resolves from an
attachment that carries it, and raises ``NotImplementedError`` without
one."""

import pytest
from test_attachment_code import HOSTILE_SOURCES, IOU_SOURCE

import corda_tpu.finance  # noqa: F401  (registers the reference's Cash contract)
from corda_tpu.ledger import attachment_code as ref_att
from corda_tpu.ledger.ledger_tx import verify_ledger_batch as ref_verify_ledger_batch
from corda_tpu.serialization import deserialize as ref_deserialize
from corda_tpu_torch.crypto import SecureHash, sha256
from corda_tpu_torch.finance import CASH_PROGRAM_ID, CashState, Issue, Move
from corda_tpu_torch.ledger import (
    Amount,
    HashAttachmentConstraint,
    Issued,
    PartyAndReference,
    PrivacySalt,
    TransactionBuilder,
    verify_ledger_batch,
)
from corda_tpu_torch.ledger import attachment_code as att
from corda_tpu_torch.serialization import serialize
from corda_tpu_torch.testing import _party, state_resolver
from corda_tpu_torch.testing.service_stream import (
    ATTACHED_CASH,
    ATTACHED_CASH_SOURCE,
    HOSTILE_SOURCE,
    ROGUE_CASH_SOURCE,
    AttachmentStore,
)

# more probes of the gate: (source, what it tries)
GATE_PROBES = [
    (b"with open('x') as f:\n    pass\nCONTRACTS = {}\n", "with"),
    (b"def f():\n    yield 1\nCONTRACTS = {}\n", "yield"),
    (b"def f():\n    x = 1\n    def g():\n        nonlocal x\nCONTRACTS = {}\n", "nonlocal"),
    (b"x = (y := 3)\nCONTRACTS = {}\n", "walrus"),
    (b"x = print\nCONTRACTS = {}\n", "print"),
    (b"x = type(1)\nCONTRACTS = {}\n", "type"),
    (b"x = vars()\nCONTRACTS = {}\n", "vars"),
    (b"x = _hidden\nCONTRACTS = {}\n", "underscore name"),
    (b"x = dict(_k=1)\nCONTRACTS = {}\n", "underscore keyword"),
    (b"@staticmethod\ndef f():\n    pass\nCONTRACTS = {}\n", "decorator"),
    (b"x = [i async for i in y]\nCONTRACTS = {}\n", "async comprehension"),
    (b"del x\nCONTRACTS = {}\n", "del"),
    (b"x = 1 if True else 2\nCONTRACTS = {}\n", "ternary"),
    (b"x = lambda a: a + 1\nCONTRACTS = {}\n", "lambda"),
    (b"try:\n    x = 1\nexcept ValueError:\n    x = 2\nCONTRACTS = {}\n", "try"),
    (b"x = f'{1 + 1}'\nCONTRACTS = {}\n", "f-string"),
    (b"x = {k: v for k, v in {}.items()}\nCONTRACTS = {}\n", "dict comprehension"),
    (b"x = 1 +\n", "syntax error"),
    (b"\xff\xfe", "not UTF-8"),
    (b"x = 1\n" * 7000, "too many AST nodes"),
    (b"class C:\n    def verify(self, tx):\n        return sorted([3, 1])\n"
     b"CONTRACTS = {'probe.C': C}\n", "a plain contract"),
]


@pytest.fixture()
def store():
    """One attachment store behind both packages' fetchers."""
    s = AttachmentStore()
    att.set_attachment_fetcher(s.get)
    ref_att.set_attachment_fetcher(s.get)
    yield s
    att.set_attachment_fetcher(None)
    ref_att.set_attachment_fetcher(None)


def verdict(fn, src, exc):
    """"refused" by the gate, the class of another error (the reference
    lets ``compile``'s SyntaxError through for an async comprehension),
    else "accepted" or the contract names loaded."""
    try:
        out = fn(src)
    except exc:
        return "refused"
    except Exception as e:
        return type(e).__name__
    return sorted(out) if isinstance(out, dict) else "accepted"


@pytest.mark.parametrize("src", HOSTILE_SOURCES, ids=range(len(HOSTILE_SOURCES)))
def test_hostile_sources_refused_as_in_reference(src):
    for port_fn, ref_fn in ((att.validate_contract_source, ref_att.validate_contract_source),
                            (att.load_attachment_contracts, ref_att.load_attachment_contracts)):
        got = verdict(port_fn, bytes(src), att.ForbiddenContractCode)
        assert got == verdict(ref_fn, bytes(src), ref_att.ForbiddenContractCode) == "refused"


@pytest.mark.parametrize("src,what", GATE_PROBES, ids=[w for _s, w in GATE_PROBES])
def test_gate_probes_match_reference(src, what):
    for port_fn, ref_fn in ((att.validate_contract_source, ref_att.validate_contract_source),
                            (att.load_attachment_contracts, ref_att.load_attachment_contracts)):
        assert verdict(port_fn, src, att.ForbiddenContractCode) == \
            verdict(ref_fn, src, ref_att.ForbiddenContractCode), what


@pytest.mark.parametrize("src", [IOU_SOURCE, ATTACHED_CASH_SOURCE, ROGUE_CASH_SOURCE,
                                 HOSTILE_SOURCE, b"x = 1\n",
                                 b"class C:\n    pass\nCONTRACTS = {'a': C}\n"],
                         ids=["iou", "attached-cash", "rogue", "hostile", "no-contracts",
                              "no-verify"])
def test_loaded_contracts_match_reference(src):
    assert verdict(att.load_attachment_contracts, src, att.ForbiddenContractCode) == \
        verdict(ref_att.load_attachment_contracts, src, ref_att.ForbiddenContractCode)


def test_corrupt_attachment_never_executes():
    """A fetcher whose bytes do not hash to the id asked for is ignored by
    both packages."""
    wrong = sha256(b"something else")
    att.set_attachment_fetcher(lambda h: ATTACHED_CASH_SOURCE)
    ref_att.set_attachment_fetcher(lambda h: ATTACHED_CASH_SOURCE)
    try:
        assert att.resolve_from_attachments(ATTACHED_CASH, (wrong,)) is None
        assert ref_att.resolve_from_attachments(
            ATTACHED_CASH, (ref_deserialize(serialize(wrong)),)) is None
        right = sha256(ATTACHED_CASH_SOURCE)
        cls, h = att.resolve_from_attachments(ATTACHED_CASH, (right,))
        assert h == right and hasattr(cls, "verify")
    finally:
        att.set_attachment_fetcher(None)
        ref_att.set_attachment_fetcher(None)


def ledger_cases(store):
    """(name, LedgerTransaction) built in the port: moves of Cash states
    under attached, registered, hostile and unknown contracts."""
    alice, _akp = _party(b"Attach Alice")
    bob, _bkp = _party(b"Attach Bob")
    notary, _nkp = _party(b"Attach Notary")
    token = Issued(PartyAndReference(alice, b"\x07"), "GBP")
    honest = store.put(ATTACHED_CASH_SOURCE)
    rogue = store.put(ROGUE_CASH_SOURCE)
    hostile = store.put(HOSTILE_SOURCE)
    lax_cash = store.put(b"class C:\n    def verify(self, tx):\n        pass\n"
                         b"CONTRACTS = {'%s': C}\n" % CASH_PROGRAM_ID.encode())
    corrupt = SecureHash(bytes(32))  # an id whose blob is missing from the store
    salt = iter(range(1, 100))

    def builder():
        b = TransactionBuilder(notary=notary)
        b.set_privacy_salt(PrivacySalt(bytes([next(salt)]) * 32))
        return b

    specs = {
        "attached_valid": (ATTACHED_CASH, honest, [honest], 100, alice),
        "attached_not_conserved": (ATTACHED_CASH, honest, [honest], 99, alice),
        "attached_unsigned_owner": (ATTACHED_CASH, honest, [honest], 100, bob),
        "hash_constraint_broken": (ATTACHED_CASH, honest, [rogue], 100, alice),
        "hostile_only": ("attached.Hostile", None, [hostile], 100, alice),
        "corrupt_only": (ATTACHED_CASH, None, [corrupt], 100, alice),
        "registered_shadows": (CASH_PROGRAM_ID, None, [lax_cash], 99, alice),
        "unknown": ("attached.Missing", None, [], 100, alice),
        "sample_carried": ("samples.DocumentContract", None, [honest], 100, alice),
    }
    issue = builder()
    for contract, pin, _carried, _out, _signer in specs.values():
        issue.add_output_state(CashState(Amount(100, token), alice), contract,
                               constraint=None if pin is None else HashAttachmentConstraint(pin))
    issue.add_command(Issue(), alice.owning_key)
    issue = issue.to_wire_transaction()
    resolve = state_resolver(issue)
    out = []
    for i, (name, (contract, pin, carried, amount, signer)) in enumerate(specs.items()):
        if name == "sample_carried":
            carried_src = ATTACHED_CASH_SOURCE.replace(ATTACHED_CASH.encode(),
                                                       b"samples.DocumentContract")
            carried = [store.put(carried_src)]
        mb = builder()
        mb.add_input_state(issue.out_ref(i))
        mb.add_output_state(CashState(Amount(amount, token), bob), contract,
                            constraint=None if pin is None else HashAttachmentConstraint(pin))
        mb.add_command(Move(), signer.owning_key)
        for h in carried:
            mb.add_attachment(h)
        out.append((name, mb.to_wire_transaction().to_ledger_transaction(resolve)))
    return out


def shown(err):
    return None if err is None else (type(err).__name__, str(err))


def test_attached_contracts_verify_as_in_reference(store):
    cases = [(n, ltx) for n, ltx in ledger_cases(store) if n != "sample_carried"]
    ref_ltxs = [ref_deserialize(serialize(ltx)) for _n, ltx in cases]
    got, want = [], []
    for (_name, ltx), ref_ltx in zip(cases, ref_ltxs):
        for verify, sink in ((ltx.verify, got), (ref_ltx.verify, want)):
            try:
                verify()
                sink.append(None)
            except Exception as e:
                sink.append(shown(e))
    assert got == want
    by_name = dict(zip([n for n, _l in cases], got))
    assert by_name["attached_valid"] is None
    assert "value not conserved" in by_name["attached_not_conserved"][1]
    assert "constraint" in by_name["hash_constraint_broken"][1]
    for name in ("hostile_only", "corrupt_only", "unknown"):
        assert "unknown contract" in by_name[name][1], name
    assert by_name["registered_shadows"][0] == "TransactionVerificationException"
    batch = [shown(e) for e in verify_ledger_batch([ltx for _n, ltx in cases])]
    assert batch == [shown(e) for e in ref_verify_ledger_batch(ref_ltxs)]
    assert batch[0] is None and sum(e is None for e in batch) == 1


def test_sample_contract_resolves_from_an_attachment(store):
    """The samples' contract names raise ``NotImplementedError`` only where
    no attachment supplies them (ROADMAP.md Queue 1 item 13)."""
    ltx = dict(ledger_cases(store))["sample_carried"]
    ltx.verify()
    assert verify_ledger_batch([ltx]) == [None]
    stripped = type(ltx)(ltx.tx_id, ltx.inputs, ltx.outputs, ltx.commands, (),
                         ltx.notary, ltx.time_window)
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        stripped.verify()
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        verify_ledger_batch([stripped])
