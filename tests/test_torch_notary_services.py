"""The sequential notary services, the port's against the reference's.

``ValidatingNotaryService.process`` and ``SimpleNotaryService.process``
(the reference's host services, which the port keeps as they are: host
signature checks, ``sign_tx_id`` signing) over the same requests: a seeded
stream of Cash moves with one request of each adversarial kind, built by
``testing.notary_stream(contract_invalid=True)`` and carried to the
reference as CBE bytes. The simple notary is given each request's
tear-off (inputs, time window and notary), built by each package from its
own copy. Each request must give the same signature bytes, or a refusal
of the same class with the same message: a wrong notary, a time window
outside the tolerance, a double spend, an invalid contract, a missing or
invalid signature, and a tear-off that hides its time-window group."""

import pytest

from corda_tpu.crypto.keys import KeyPair as RefKeyPair
from corda_tpu.crypto.keys import PrivateKey as RefPrivateKey
from corda_tpu.ledger import ComponentGroupType as RefGroup
from corda_tpu.ledger import FilteredTransaction as RefFiltered
from corda_tpu.notary import InMemoryUniquenessProvider as RefInMemory
from corda_tpu.notary.service import SimpleNotaryService as RefSimple
from corda_tpu.notary.service import ValidatingNotaryService as RefValidating
from corda_tpu.observability import tracer as ref_tracer
from corda_tpu.serialization import deserialize as ref_deserialize
from corda_tpu.serialization import serialize as ref_serialize
import corda_tpu.finance  # noqa: F401  (registers the reference's Cash contract)
from corda_tpu_torch import interop
from corda_tpu_torch.ledger import ComponentGroupType, FilteredTransaction
from corda_tpu_torch.notary import (
    InMemoryUniquenessProvider,
    SimpleNotaryService,
    ValidatingNotaryService,
)
from corda_tpu_torch.observability import SPAN_NOTARY_ATTEST, tracer
from corda_tpu_torch.serialization import serialize
from corda_tpu_torch.testing import notary_stream, state_resolver

NOW = 1_800_000_000.0
TEAR_OFF = ("INPUTS", "TIMEWINDOW", "NOTARY")


@pytest.fixture(scope="module")
def stream():
    return notary_stream(6, 4, seed=21, contract_invalid=True, device="cpu")


@pytest.fixture(scope="module")
def carried(stream):
    """(the port's transactions, the reference's, each package's resolver)."""
    raws = [serialize(stx) for w in stream.windows for stx in w]
    ref_stxs = [ref_deserialize(raw) for raw in raws]
    port_stxs = [interop.signed_transaction_from_reference(ref_serialize(s))
                 for s in ref_stxs]
    ref_issue = ref_deserialize(serialize(stream.issue))
    port_issue = interop.signed_transaction_from_reference(ref_serialize(ref_issue))
    return port_stxs, ref_stxs, state_resolver(port_issue.tx), state_resolver(ref_issue.tx)


def services(stream, port_cls, ref_cls):
    identity = ref_deserialize(serialize(stream.notary))
    keypair = RefKeyPair(identity.owning_key, RefPrivateKey(
        4, stream.notary_keypair.private.encoded))
    return (port_cls(stream.notary, stream.notary_keypair, InMemoryUniquenessProvider(),
                     clock=lambda: NOW),
            ref_cls(identity, keypair, RefInMemory(), clock=lambda: NOW))


def answer(fn):
    try:
        sig = fn()
    except Exception as e:  # the refusal is the answer
        return ("refused", type(e).__name__, str(e))
    return ("signed", sig.signature, sig.by.encoded)


def refusal_kinds(answers) -> set:
    return {a[2].split(":")[0] for a in answers if a[0] == "refused"}


def tear_off(stx, cls, groups, names=TEAR_OFF):
    keep = {getattr(groups, n) for n in names}
    return cls.build(stx.tx, lambda comp, group: group in keep)


def test_validating_matches_reference(stream, carried):
    port_stxs, ref_stxs, resolve, ref_resolve = carried
    port, ref = services(stream, ValidatingNotaryService, RefValidating)
    got = [answer(lambda s=s: port.process(s, resolve, "alice")) for s in port_stxs]
    want = [answer(lambda s=s: ref.process(s, ref_resolve, "alice")) for s in ref_stxs]
    assert got == want
    kinds = [k for w in stream.kinds for k in w]
    assert [a[0] for a in got] == ["signed" if k == "signed" else "refused" for k in kinds]
    assert len(refusal_kinds(got)) >= 5
    assert port.uniqueness.consumed_digest() == ref.uniqueness.consumed_digest()
    # a resubmission is answered from the cache with the original bytes
    again = [answer(lambda s=s: port.process(s, resolve, "bob")) for s in port_stxs]
    assert [a for a in again if a[0] == "signed"] == [a for a in got if a[0] == "signed"]
    assert port.uniqueness.committed_txs() == ref.uniqueness.committed_txs()


def test_simple_matches_reference(stream, carried):
    """The tear-offs' ids equal the transactions' ids; the simple notary
    signs what its tear-off shows (the contract-invalid kinds too: it does
    not validate), and refuses double spends, the wrong notary and the
    expired time window as the reference does."""
    port_stxs, ref_stxs, _r, _rr = carried
    port, ref = services(stream, SimpleNotaryService, RefSimple)
    ftxs = [tear_off(s, FilteredTransaction, ComponentGroupType) for s in port_stxs]
    ref_ftxs = [tear_off(s, RefFiltered, RefGroup) for s in ref_stxs]
    assert [f.id.bytes for f in ftxs] == [bytes(f.id.bytes) for f in ref_ftxs]
    got = [answer(lambda f=f: port.process(f, "alice")) for f in ftxs]
    want = [answer(lambda f=f: ref.process(f, "alice")) for f in ref_ftxs]
    assert got == want
    kinds = [k for w in stream.kinds_nonvalidating for k in w]
    refused = {"conflict", "wrong_notary", "time_window"}
    assert [a[0] == "refused" for a in got] == [k in refused for k in kinds]
    assert port.uniqueness.consumed_digest() == ref.uniqueness.consumed_digest()


def test_simple_refuses_hidden_time_window(stream, carried):
    """A tear-off of the time-windowed request that hides the time-window
    group is refused by both, before anything is committed."""
    port_stxs, ref_stxs, _r, _rr = carried
    idx = next(i for i, s in enumerate(port_stxs) if s.tx.time_window is not None)
    port, ref = services(stream, SimpleNotaryService, RefSimple)
    hidden = ("INPUTS", "NOTARY")
    got = answer(lambda: port.process(
        tear_off(port_stxs[idx], FilteredTransaction, ComponentGroupType, hidden), "alice"))
    want = answer(lambda: ref.process(
        tear_off(ref_stxs[idx], RefFiltered, RefGroup, hidden), "alice"))
    assert got == want and got[0] == "refused"
    assert port.uniqueness.committed_txs() == ref.uniqueness.committed_txs() == 0


def test_attest_spans(stream, carried):
    """Each process() is one notary.attest span, as the reference's."""
    port_stxs, ref_stxs, resolve, ref_resolve = carried
    port, ref = services(stream, ValidatingNotaryService, RefValidating)
    trc, ref_trc = tracer(), ref_tracer()
    for t in (trc, ref_trc):
        t.clear()
        t.configure(sample_rate=1.0)
    try:
        with trc.activate(trc.root("caller", force=True)), \
                ref_trc.activate(ref_trc.root("caller", force=True)):
            for s, rs in zip(port_stxs[:3], ref_stxs[:3]):
                answer(lambda: port.process(s, resolve, "alice"))
                answer(lambda: ref.process(rs, ref_resolve, "alice"))
    finally:
        for t in (trc, ref_trc):
            t.configure(sample_rate=0.0)
    spans = [(sp["attrs"]["tx.id"], sp["attrs"]["service"], sp["status"])
             for sp in trc.dump() if sp["name"] == SPAN_NOTARY_ATTEST]
    ref_spans = [(sp["attrs"]["tx.id"], sp["attrs"]["service"], sp["status"])
                 for sp in ref_trc.dump() if sp["name"] == SPAN_NOTARY_ATTEST]
    trc.clear()
    ref_trc.clear()
    assert spans == ref_spans and len(spans) == 3
