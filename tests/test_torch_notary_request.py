"""The batched notary's request window, the port's against the reference's.

Both packages' ``BatchedNotaryService.request()`` answer the same requests:
a seeded stream of Cash moves with one request of each adversarial kind
(``testing.notary_stream(contract_invalid=True)``, carried to the
reference as CBE bytes and back through
``interop.signed_transaction_from_reference``), under one notary keypair
and one clock. The port runs on ``device="cpu"`` (its kernels' plain
versions), the reference on its host tier (``use_device=False``). Every
future's signature bytes and conflict, ``committed_txs()`` and
``consumed_digest()`` must be equal (tolerance zero).

Also the window itself: a burst of 3 * ``max_batch`` + 5 requests flushes
as 4 windows and a burst of 16 windows settles whole; a lone request
flushes at ``window_s``; a retry is answered from the cache with the
original bytes and no new commit; the flow deadline is shed at the door
and in the window, counted by both governors alike; ``request()`` after
``shutdown()`` raises; the signed cache evicts its older half; the spans
and meters; a failed dispatch fails its window's futures with its error;
and a notary started from the other package's committed rows refuses the
same double spends."""

import contextlib
import sys
import time

import pytest
import torch

from corda_tpu.crypto import SecureHash as RefSecureHash
from corda_tpu.crypto.keys import KeyPair as RefKeyPair
from corda_tpu.crypto.keys import PrivateKey as RefPrivateKey
from corda_tpu.flows.overload import configure_overload as ref_configure_overload
from corda_tpu.flows.overload import deadline_scope as ref_deadline_scope
from corda_tpu.node.monitoring import MetricRegistry as RefMetrics
from corda_tpu.notary import BatchedNotaryService as RefNotary
from corda_tpu.notary import InMemoryUniquenessProvider as RefInMemory
from corda_tpu.notary import PersistentUniquenessProvider as RefPersistent
from corda_tpu.notary.service import NotaryInternalException as RefInternal
from corda_tpu.observability import tracer as ref_tracer
from corda_tpu.serialization import deserialize as ref_deserialize
from corda_tpu.serialization import serialize as ref_serialize
from corda_tpu.serving import shutdown_scheduler as ref_shutdown_scheduler
import corda_tpu.finance  # noqa: F401  (registers the reference's Cash contract)
from corda_tpu_torch import interop
from corda_tpu_torch.crypto import SecureHash
from corda_tpu_torch.flows import configure_overload, deadline_scope
from corda_tpu_torch.node import MetricRegistry
from corda_tpu_torch.notary import (
    BatchedNotaryService,
    InMemoryUniquenessProvider,
    NotaryInternalException,
    PersistentUniquenessProvider,
)
from corda_tpu_torch.observability import SPAN_NOTARY_SUBMIT, tracer
from corda_tpu_torch.serialization import serialize
from corda_tpu_torch.serving import shutdown_scheduler
from corda_tpu_torch.testing import notary_stream, outcome_kind, state_resolver

NOW = 1_800_000_000.0  # both notaries' clock, in unix seconds


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run many small integer ops: beside the suite's
    other worker processes a torch thread pool only contends."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def shared_schedulers():
    yield
    shutdown_scheduler()
    ref_shutdown_scheduler()


class Carried:
    """One stream in both packages: the reference's transactions decoded
    from the port-built stream's bytes, the port's decoded back from the
    reference's bytes (ids cold in both), each with its state resolver."""

    def __init__(self, stream):
        self.stream = stream
        flat = [stx for w in stream.windows for stx in w]
        self.kinds = [k for w in stream.kinds for k in w]
        self.raw = [serialize(stx) for stx in flat]
        ref_issue = ref_deserialize(serialize(stream.issue))
        self.ref_resolve = state_resolver(ref_issue.tx)
        self.resolve = state_resolver(
            interop.signed_transaction_from_reference(ref_serialize(ref_issue)).tx)

    def ref_stxs(self):
        return [ref_deserialize(raw) for raw in self.raw]

    def port_stxs(self):
        return [interop.signed_transaction_from_reference(ref_serialize(stx))
                for stx in self.ref_stxs()]


@pytest.fixture(scope="module")
def carried():
    """9 moves and the 10 adversarial requests."""
    return Carried(notary_stream(9, 4, seed=14, contract_invalid=True, device="cpu"))


def port_notary(stream, provider=None, max_batch=16, window_s=0.01, **kw):
    return BatchedNotaryService(
        stream.notary, stream.notary_keypair, provider or InMemoryUniquenessProvider(),
        max_batch=max_batch, window_s=window_s, clock=lambda: NOW, device="cpu", **kw)


def ref_notary(stream, provider=None, max_batch=16, window_s=0.01, **kw):
    identity = ref_deserialize(serialize(stream.notary))
    keypair = RefKeyPair(identity.owning_key, RefPrivateKey(
        4, stream.notary_keypair.private.encoded))
    return RefNotary(identity, keypair, provider or RefInMemory(), use_device=False,
                     max_batch=max_batch, window_s=window_s, clock=lambda: NOW, **kw)


def results(futures, timeout=120):
    out = []
    for f in futures:
        try:
            out.append(f.result(timeout=timeout))
        except Exception as e:  # the refusal is the request's answer
            out.append(e)
    return out


def conflict_of(result):
    c = getattr(result, "conflict", None)
    if c is None:
        return None
    return sorted((bytes(ref.txhash.bytes), ref.index, bytes(d.consuming_tx.bytes),
                   d.input_index, d.requesting_party_name)
                  for ref, d in c.state_history.items())


def assert_same(got, want, kinds):
    assert [outcome_kind(r) for r in got] == [outcome_kind(r) for r in want] == kinds
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__
        assert conflict_of(g) == conflict_of(w)
        if outcome_kind(g) == "signed":
            assert g.signature == w.signature
            assert g.by.encoded == w.by.encoded
        else:
            assert str(g) == str(w)


def run_both(carried, port, ref, caller="alice"):
    got = results([port.request(stx, carried.resolve, caller)
                   for stx in carried.port_stxs()])
    want = results([ref.request(stx, carried.ref_resolve, caller)
                    for stx in carried.ref_stxs()])
    return got, want


@contextlib.contextmanager
def burst():
    """Hold the interpreter on the submitting thread while a burst is
    submitted, so the window thread sees every request of it at once."""
    before = sys.getswitchinterval()
    sys.setswitchinterval(5.0)
    try:
        yield
    finally:
        sys.setswitchinterval(before)


def record_windows(svc):
    """The sizes of the windows the service takes, and when."""
    seen = []
    inner = svc._take_window

    def take_window():
        batch, stopped = inner()
        if batch:
            seen.append((len(batch), time.monotonic()))
        return batch, stopped

    svc._take_window = take_window
    return seen


@pytest.mark.parametrize("max_batch", [16, 64])
def test_request_matches_reference(carried, max_batch):
    port = port_notary(carried.stream, max_batch=max_batch)
    ref = ref_notary(carried.stream, max_batch=max_batch)
    try:
        got, want = run_both(carried, port, ref)
    finally:
        port.shutdown()
        ref.shutdown()
    assert_same(got, want, carried.kinds)
    assert port.uniqueness.committed_txs() == ref.uniqueness.committed_txs()
    assert port.uniqueness.consumed_digest() == ref.uniqueness.consumed_digest()


def test_request_on_host_tier_and_direct_route(carried):
    """The port's host tier and its direct dispatch (no scheduler) answer
    the same, with a persistent provider."""
    ref = ref_notary(carried.stream)
    want = results([ref.request(stx, carried.ref_resolve, "alice")
                    for stx in carried.ref_stxs()])
    ref.shutdown()
    for kw in ({"use_device": False}, {"use_scheduler": False}):
        port = port_notary(carried.stream, PersistentUniquenessProvider(), **kw)
        try:
            got = results([port.request(stx, carried.resolve, "alice")
                           for stx in carried.port_stxs()])
        finally:
            port.shutdown()
        assert_same(got, want, carried.kinds)
        assert port.uniqueness.consumed_digest() == ref.uniqueness.consumed_digest()


@pytest.mark.parametrize("max_batch,n_moves,windows,tier", [
    (8, 22, [8, 8, 8, 5], {}),
    (4, 57, [4] * 16, {"use_device": False}),
])
def test_burst_flushes_in_capped_windows(max_batch, n_moves, windows, tier):
    """3 * max_batch + 5 requests flush as 4 windows (through the plain
    versions); 64 requests at a max_batch of 4 as 16 windows in flight at
    once (on the host tier, which times nothing here), every request
    settled as expected."""
    stream = notary_stream(n_moves, 4, seed=15, device="cpu")
    kinds = [k for w in stream.kinds for k in w]
    assert len(kinds) == sum(windows)
    svc = port_notary(stream, max_batch=max_batch, window_s=0.05, validating=False,
                      **tier)
    seen = record_windows(svc)
    try:
        with burst():
            futures = [svc.request(stx, None, "alice") for w in stream.windows for stx in w]
        got = results(futures)
    finally:
        svc.shutdown()
    assert [n for n, _t in seen] == windows
    assert [outcome_kind(r) for r in got] == kinds


def test_lone_request_flushes_at_window_s(carried):
    """A lone request flushes as a window of one within window_s of its
    submission, though the window never filled."""
    window_s = 0.25
    svc = port_notary(carried.stream, max_batch=64, window_s=window_s)
    seen = record_windows(svc)
    stx = carried.port_stxs()[0]
    try:
        t0 = time.monotonic()
        sig = svc.request(stx, carried.resolve, "alice").result(timeout=60)
    finally:
        svc.shutdown()
    assert outcome_kind(sig) == "signed"
    assert [n for n, _t in seen] == [1]
    assert seen[0][1] - t0 <= window_s + 0.15


def test_retry_answered_from_cache(carried):
    """A retried request gets the original bytes with no new commit: the
    same object (its id known) at the door, a fresh copy (its id cold)
    after its window's id sweep; the reference answers both the same."""
    port, ref = port_notary(carried.stream), ref_notary(carried.stream)
    stx, ref_stx = carried.port_stxs()[0], carried.ref_stxs()[0]
    commits = []
    inner = port.uniqueness.commit_batch_async
    port.uniqueness.commit_batch_async = lambda reqs: commits.append(len(reqs)) or inner(reqs)
    try:
        first = port.request(stx, carried.resolve, "alice").result(timeout=60)
        ref_first = ref.request(ref_stx, carried.ref_resolve, "alice").result(timeout=60)
        at_door = port.request(stx, carried.resolve, "alice")
        assert at_door.done()
        fresh = port.request(carried.port_stxs()[0], carried.resolve, "bob").result(timeout=60)
        ref_again = ref.request(carried.ref_stxs()[0], carried.ref_resolve,
                                "bob").result(timeout=60)
    finally:
        port.shutdown()
        ref.shutdown()
    assert first.signature == ref_first.signature == ref_again.signature
    assert at_door.result().signature == fresh.signature == first.signature
    assert commits == [1]
    assert port.uniqueness.committed_txs() == ref.uniqueness.committed_txs() == 1


def test_deadline_shed_at_door_and_in_window(carried):
    """A request under a deadline already past is refused at the door; one
    whose deadline passes while it waits in a window fails from the window.
    Each governor counts both sheds."""
    governor = configure_overload(enabled=True, reset=True)
    ref_governor = ref_configure_overload(enabled=True, reset=True)
    port = port_notary(carried.stream, window_s=0.4)
    ref = ref_notary(carried.stream, window_s=0.4)
    stx, ref_stx = carried.port_stxs()[0], carried.ref_stxs()[0]
    try:
        past = time.time() - 1.0
        with deadline_scope(past), pytest.raises(NotaryInternalException,
                                                 match="deadline exceeded"):
            port.request(stx, carried.resolve, "alice")
        with ref_deadline_scope(past), pytest.raises(RefInternal, match="deadline exceeded"):
            ref.request(ref_stx, carried.ref_resolve, "alice")
        soon = time.time() + 0.05
        with deadline_scope(soon):
            fut = port.request(stx, carried.resolve, "alice")
        with ref_deadline_scope(soon):
            ref_fut = ref.request(ref_stx, carried.ref_resolve, "alice")
        for f, exc in ((fut, NotaryInternalException), (ref_fut, RefInternal)):
            with pytest.raises(exc, match="while batched"):
                f.result(timeout=30)
        assert governor.deadline_shed == ref_governor.deadline_shed == 2
    finally:
        port.shutdown()
        ref.shutdown()
        configure_overload(enabled=False, reset=True)
        ref_configure_overload(enabled=False, reset=True)
    assert port.uniqueness.committed_txs() == ref.uniqueness.committed_txs() == 0


def test_request_after_shutdown_raises(carried):
    port, ref = port_notary(carried.stream), ref_notary(carried.stream)
    port.shutdown()
    ref.shutdown()
    with pytest.raises(NotaryInternalException, match="stopped"):
        port.request(carried.port_stxs()[1], carried.resolve, "alice")
    with pytest.raises(RefInternal, match="stopped"):
        ref.request(carried.ref_stxs()[1], carried.ref_resolve, "alice")


def test_signed_cache_evicts_older_half(carried):
    """Past SIGNED_CACHE_MAX entries both caches drop their older half."""
    port, ref = port_notary(carried.stream), ref_notary(carried.stream)
    port.SIGNED_CACHE_MAX = ref.SIGNED_CACHE_MAX = 6
    ids = [bytes([i]) * 32 for i in range(9)]
    for i, raw in enumerate(ids):
        port.remember_signature(SecureHash(raw), f"sig{i}")
        ref.remember_signature(RefSecureHash(raw), f"sig{i}")
    kept = [raw for raw in ids if port.cached_signature(SecureHash(raw)) is not None]
    ref_kept = [raw for raw in ids if ref.cached_signature(RefSecureHash(raw)) is not None]
    assert kept == ref_kept == ids[3:]
    assert port.cached_signature(SecureHash(ids[-1])) == "sig8"
    port.remember_signature(SecureHash(ids[-1]), "other")  # the first attestation stays
    assert port.cached_signature(SecureHash(ids[-1])) == "sig8"


def test_spans_and_meters(carried):
    """One notary.submit span a request, with its tx id and caller; the
    notary.requests and notary.committed meters count as the reference's."""
    trc, ref_trc = tracer(), ref_tracer()
    metrics, ref_metrics = MetricRegistry(), RefMetrics()
    port = port_notary(carried.stream, metrics=metrics)
    ref = ref_notary(carried.stream, metrics=ref_metrics)
    for t in (trc, ref_trc):
        t.clear()
        t.configure(sample_rate=1.0)
    try:
        # the requests are made under a sampled span on the caller's thread
        with trc.activate(trc.root("caller", force=True)), \
                ref_trc.activate(ref_trc.root("caller", force=True)):
            got, want = run_both(carried, port, ref)
    finally:
        for t in (trc, ref_trc):
            t.configure(sample_rate=0.0)
        port.shutdown()
        ref.shutdown()
    assert_same(got, want, carried.kinds)
    spans = [sp for sp in trc.dump() if sp["name"] == SPAN_NOTARY_SUBMIT]
    ref_spans = [sp for sp in ref_trc.dump() if sp["name"] == SPAN_NOTARY_SUBMIT]
    trc.clear()
    ref_trc.clear()
    assert len(spans) == len(ref_spans) == len(carried.kinds)
    key = lambda sp: (sp["attrs"]["tx.id"], sp["attrs"]["caller"], sp["status"])
    assert sorted(map(key, spans)) == sorted(map(key, ref_spans))
    for name in ("notary.requests", "notary.committed"):
        assert metrics.meter(name).count == ref_metrics.meter(name).count > 0
    assert metrics.meter("notary.committed").count == carried.kinds.count("signed")


def test_failed_dispatch_fails_window():
    """A window whose id sweep or signature check raises fails every one of
    its requests with that error; nothing is settled on the host."""
    stream = notary_stream(5, 3, seed=16, device="cpu")
    stxs = [stx for w in stream.windows for stx in w]
    for stage in ("dispatch_ids", "dispatch_batch"):
        svc = port_notary(stream, max_batch=8, window_s=0.02, validating=False)
        err = RuntimeError(f"the card failed in {stage}")

        def boom(*args, err=err):
            raise err

        setattr(svc, stage, boom)
        try:
            with burst():
                futures = [svc.request(stx, None, "alice") for stx in stxs]
            for f in futures:
                assert f.exception(timeout=30) is err
        finally:
            svc.shutdown()
        assert svc.uniqueness.committed_txs() == 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_batched_notary_needs_the_card_or_cpu():
    stream = notary_stream(5, 3, seed=16, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedNotaryService(stream.notary, stream.notary_keypair,
                             InMemoryUniquenessProvider())


def test_persistent_rows_carry_across(carried):
    """A reference persistent provider that notarised the first half of the
    stream, carried into the port's: both notaries then refuse the same
    double spends in the rest, and end with the same rows."""
    half = len(carried.raw) // 2
    ref_provider = RefPersistent()
    ref = ref_notary(carried.stream, ref_provider)
    results([ref.request(stx, carried.ref_resolve, "alice")
             for stx in carried.ref_stxs()[:half]])
    provider = interop.persistent_uniqueness_from_reference(ref_provider)
    assert provider.committed_txs() == ref_provider.committed_txs() > 0
    port = port_notary(carried.stream, provider)
    try:
        got = results([port.request(stx, carried.resolve, "bob")
                       for stx in carried.port_stxs()])
        want = results([ref.request(stx, carried.ref_resolve, "bob")
                        for stx in carried.ref_stxs()])
    finally:
        port.shutdown()
        ref.shutdown()
    assert_same(got, want, [outcome_kind(r) for r in want])
    assert "conflict" in [outcome_kind(r) for r in got]
    with ref_provider._lock:
        ref_rows = sorted((bytes(k), bytes(t), int(i), str(c)) for k, t, i, c in
                          ref_provider._db.execute("SELECT * FROM notary_commits"))
    assert provider.rows() == ref_rows
