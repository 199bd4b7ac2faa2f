"""The batched non-validating notary, the port's against the reference's,
over the same requests: a seeded stream of Cash moves with one request of
each adversarial kind (testing.notary_stream), carried across as CBE bytes.

The port runs with ``device="cpu"`` through its kernels' plain versions
(id sweep, verification, signing), on the scheduler route and the direct
one, and on its host tier; the reference runs its host tier
(``use_device=False``), which its own tests hold equal to its device tier.
Each slot must give the same outcome kind, the same conflict and the same
signature bytes (tolerance zero). Also: the scheduler's
``submit_transactions`` settles a window like ``check_transactions``, and
a consumed set carries across (``interop.uniqueness_from_reference``)."""

import pytest
import torch

from corda_tpu.crypto.keys import KeyPair as RefKeyPair
from corda_tpu.crypto.keys import PrivateKey as RefPrivateKey
from corda_tpu.notary import BatchedNotaryService as RefNotary
from corda_tpu.notary import InMemoryUniquenessProvider as RefInMemory
from corda_tpu.notary import PersistentUniquenessProvider as RefPersistent
from corda_tpu.serialization import deserialize as ref_deserialize
from corda_tpu.serving import shutdown_scheduler as ref_shutdown_scheduler
from corda_tpu_torch import interop
from corda_tpu_torch.crypto import ed25519_host
from corda_tpu_torch.notary import (
    BatchedNotaryService,
    InMemoryUniquenessProvider,
    PersistentUniquenessProvider,
)
from corda_tpu_torch.serialization import deserialize, serialize
from corda_tpu_torch.serving import DeviceScheduler, shutdown_scheduler
from corda_tpu_torch.testing import notary_stream, outcome_kind
from corda_tpu_torch.verifier import check_transactions

NOW = 1_800_000_000.0  # both notaries' clock, in unix seconds


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
    """9 moves and the 7 adversarial requests, in 4 windows of 4."""
    return notary_stream(9, 4, seed=3, device="cpu")


def port_windows(stream):
    """Fresh copies, id caches cold."""
    return [[(deserialize(serialize(stx)), None, "alice") for stx in w]
            for w in stream.windows]


def ref_windows(stream):
    return [[(ref_deserialize(serialize(stx)), None, "alice") for stx in w]
            for w in stream.windows]


def port_notary(stream, provider=None, max_batch=16, **kw):
    return BatchedNotaryService(
        stream.notary, stream.notary_keypair, provider or PersistentUniquenessProvider(),
        validating=False, max_batch=max_batch, clock=lambda: NOW, device="cpu", **kw)


def ref_notary(stream, provider=None):
    identity = ref_deserialize(serialize(stream.notary))
    keypair = RefKeyPair(identity.owning_key, RefPrivateKey(
        4, stream.notary_keypair.private.encoded))
    return RefNotary(identity, keypair, provider or RefPersistent(), use_device=False,
                     validating=False, max_batch=16, clock=lambda: NOW)


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


@pytest.mark.parametrize("route", ["scheduler", "direct", "host"])
def test_process_batch_matches_reference(stream, route):
    kw = {"scheduler": {}, "direct": {"use_scheduler": False},
          "host": {"use_device": False}}[route]
    port_reqs = [r for w in port_windows(stream) for r in w]
    got = port_notary(stream, **kw).process_batch(port_reqs)
    want = ref_notary(stream).process_batch([r for w in ref_windows(stream) for r in w])
    assert_same_results(got, want, port_reqs, [k for w in stream.kinds for k in w])


def test_process_stream_matches_reference(stream):
    port_reqs = port_windows(stream)
    got = port_notary(stream).process_stream(port_reqs, depth=2)
    want = ref_notary(stream).process_stream(ref_windows(stream), depth=2)
    assert len(got) == len(want) == len(stream.windows)
    for g, w, reqs, kinds in zip(got, want, port_reqs, stream.kinds):
        assert_same_results(g, w, reqs, kinds)


def test_consumed_set_carries_across(stream):
    """Both notaries start from one consumed set: the moves of window 0,
    committed by the reference, make their re-spends conflict in both."""
    ref_provider = RefInMemory()
    ref_notary(stream, ref_provider).process_batch(ref_windows(stream)[0])
    provider = interop.uniqueness_from_reference(ref_provider._map)
    assert provider.consumed_digest() == ref_provider.consumed_digest()
    assert provider.committed_txs() == ref_provider.committed_txs() == 3
    port_reqs = [r for w in port_windows(stream)[:2] for r in w]
    got = port_notary(stream, provider).process_batch(port_reqs)
    want = ref_notary(stream, ref_provider).process_batch(
        [r for w in ref_windows(stream)[:2] for r in w])
    kinds = [outcome_kind(r) for r in want]
    assert kinds[:4] == ["signed", "signed", "conflict", "signed"]  # idempotent re-commit
    assert_same_results(got, want, port_reqs, kinds)
    assert provider.consumed_digest() == ref_provider.consumed_digest()


@pytest.mark.parametrize("use_device", [True, False])
def test_submit_transactions_settles_like_check_transactions(stream, use_device):
    stxs = [stx for stx, _r, _c in port_windows(stream)[1]]
    allowed = [{stream.notary.owning_key}] * len(stxs)
    want = check_transactions(stxs, allowed, use_device=use_device, device="cpu")
    sched = DeviceScheduler(device="cpu")
    try:
        got = sched.submit_transactions(stxs, allowed, use_device=use_device).result(60)
    finally:
        sched.shutdown()
    assert [None if r is None else (type(r), str(r)) for r in got.results] == \
        [None if r is None else (type(r), str(r)) for r in want.results]
    assert (got.n_sigs, got.n_device) == (want.n_sigs, want.n_device)
    assert got.n_device == (len(stxs) if use_device else 0)
    assert got.batch_seq is not None and want.batch_seq is None


def test_validating_notary_is_not_ported(stream):
    """Named when ``validating=True`` raised. The validating notary is ported
    now and is the default, as in the reference: given no state resolver it
    rejects every request of window 0, whose signatures hold, at
    validation, and commits nothing (tests/test_torch_validating.py holds
    it against the reference)."""
    provider = InMemoryUniquenessProvider()
    svc = BatchedNotaryService(stream.notary, stream.notary_keypair, provider,
                               device="cpu", clock=lambda: NOW)
    out = svc.process_batch(port_windows(stream)[0])
    assert all(type(r).__name__ == "NotaryError" and str(r).startswith("validation failed:")
               for r in out)
    assert provider.committed_txs() == 0


def test_window_longer_than_max_batch_is_refused(stream):
    svc = port_notary(stream, max_batch=3)
    with pytest.raises(ValueError, match="max_batch"):
        svc.process_batch(port_windows(stream)[0])


def test_notary_key_must_match_identity(stream):
    with pytest.raises(ValueError):
        BatchedNotaryService(stream.alice, stream.notary_keypair,
                             InMemoryUniquenessProvider(), validating=False, device="cpu")


def test_stream_positions_adversarial_requests(stream):
    """The layout chip_smoke.py relies on: the in-window double spend in
    window 0, the other kinds from window 1 on, every kind once."""
    flat = [k for w in stream.kinds for k in w]
    assert stream.kinds[0].count("conflict") == 1
    assert sorted(k for k in flat if k != "signed") == sorted(
        ["conflict", "conflict", "invalid_signature", "invalid_signature",
         "missing_signature", "wrong_notary", "time_window"])
