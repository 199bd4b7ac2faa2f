"""The verifier service: the port's ``verifier/service.py`` against the
reference's ``BatchedVerifierService(use_device=False)`` on the same
transactions (``testing.service_stream``: ed25519, composite-owned,
secp256k1/r1, SPHINCS and BLS signers, contracts from attachments, and
every adversarial kind, carried across as CBE bytes). On both routes, on
the port's device route (``device="cpu"``: the kernels' plain versions)
and its host route, each transaction's outcome (error class and failing
key set) equals the reference's and the stream's oracle; on the windowed
route both packages are given the same windows, so that the window that
holds a composite key given as an individual signer fails whole in both.
Shutdown completes every future; a bucket whose dispatch or readback
fails raises out of the check and fails the requests it carried, with no
host failover. ``InMemoryVerifierService`` answers as the reference's."""

import pytest
import torch

pytest.importorskip("cryptography")  # the reference's ECDSA oracle is OpenSSL

import corda_tpu.finance  # noqa: F401  (registers the reference's Cash contract)
from corda_tpu.crypto import PublicKey as RefPublicKey
from corda_tpu.ledger import attachment_code as ref_att
from corda_tpu.serialization import deserialize as ref_deserialize
from corda_tpu.verifier import BatchedVerifierService as RefService
from corda_tpu.verifier import InMemoryVerifierService as RefInMemory
from corda_tpu_torch.crypto import BLS_BLS12381
from corda_tpu_torch.ledger import attachment_code as att
from corda_tpu_torch.serialization import serialize
from corda_tpu_torch.serving import shutdown_scheduler
from corda_tpu_torch.testing import state_resolver
from corda_tpu_torch.testing.service_stream import SERVICE_KINDS, future_outcome, service_stream
from corda_tpu_torch.verifier import (
    BatchedVerifierService,
    InMemoryVerifierService,
    VerificationError,
    check_transactions,
    dispatch_signature_rows,
)
from corda_tpu_torch.verifier import batch as port_batch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run many small integer ops: beside the suite's
    other worker processes a torch thread pool only contends, so these
    tests run torch on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def stream():
    st = service_stream(40, seed=9, device="cpu", sphincs=1, bls=1, attachments=2)
    att.set_attachment_fetcher(st.store.get)
    ref_att.set_attachment_fetcher(st.store.get)
    yield st
    att.set_attachment_fetcher(None)
    ref_att.set_attachment_fetcher(None)
    shutdown_scheduler()


@pytest.fixture(scope="module")
def carried(stream):
    """The stream as the reference reads it: transactions, allowed sets and
    a resolver over its own copy of the issue."""
    stxs = [ref_deserialize(serialize(s)) for s in stream.stxs]
    allowed = [{RefPublicKey(k.scheme_id, k.encoded) for k in a} for a in stream.allowed]
    return stxs, allowed, state_resolver(ref_deserialize(serialize(stream.issue)))


def run(svc, stxs, resolve, allowed):
    try:
        futs = [svc.verify_signed(s, resolve, a) for s, a in zip(stxs, allowed)]
        return [future_outcome(f, timeout=300) for f in futs]
    finally:
        svc.shutdown()


@pytest.fixture(scope="module")
def reference(carried):
    """The reference's host route, through its scheduler."""
    stxs, allowed, resolve = carried
    return run(RefService(use_device=False), stxs, resolve, allowed)


@pytest.mark.parametrize("use_device", [True, False], ids=["device", "host"])
def test_scheduler_route_matches_reference(stream, reference, use_device):
    svc = BatchedVerifierService(device="cpu", use_device=use_device)
    got = run(svc, stream.stxs, stream.resolve, stream.allowed)
    assert got == reference == stream.expected
    refused = sum(k == "composite_as_signer" for k in stream.kinds)
    rows = sum(len(s.sigs) for s, k in zip(stream.stxs, stream.kinds)
               if k != "composite_as_signer")
    host_rows = sum(1 for s, k in zip(stream.stxs, stream.kinds)
                    if k != "composite_as_signer" for sig in s.sigs
                    if sig.by.scheme_id == BLS_BLS12381)
    assert svc.stats["txs"] == len(stream.stxs) - refused
    assert svc.stats["sigs"] == rows
    assert svc.stats["device_sigs"] == (rows - host_rows if use_device else 0)
    assert svc.stats["batches"] >= 1


WINDOW = 8


@pytest.mark.parametrize("use_device", [True, False], ids=["device", "host"])
def test_windowed_route_matches_reference(stream, carried, use_device):
    """The windowed flusher, both packages over the same windows (``WINDOW``
    requests each: a full window flushes at once, the long ``window_s``
    flushes nothing early). The window that holds a composite key given
    as an individual signer fails whole with the ``CryptoError``, in both;
    every other outcome is the oracle's."""
    stxs, allowed, resolve = carried
    assert len(stxs) % WINDOW == 0
    bad = stream.kinds.index("composite_as_signer") // WINDOW
    want = [("CryptoError", frozenset()) if i // WINDOW == bad else e
            for i, e in enumerate(stream.expected)]
    ref = RefService(use_device=False, use_scheduler=False, max_batch=WINDOW, window_s=60.0)
    ref_got = run(ref, stxs, resolve, allowed)
    svc = BatchedVerifierService(device="cpu", use_device=use_device, use_scheduler=False,
                                 max_batch=WINDOW, window_s=60.0)
    got = run(svc, stream.stxs, stream.resolve, stream.allowed)
    assert got == ref_got == want
    assert svc.stats["batches"] == ref.stats["batches"] == len(stxs) // WINDOW - 1
    assert svc.stats["txs"] == ref.stats["txs"] == len(stxs) - WINDOW
    assert svc.stats["sigs"] == ref.stats["sigs"]
    assert svc.stats["device_sigs"] == (0 if not use_device else svc.stats["sigs"] - sum(
        1 for i, s in enumerate(stream.stxs) if i // WINDOW != bad
        for sig in s.sigs if sig.by.scheme_id == BLS_BLS12381))


def test_every_adversarial_kind_is_in_the_stream(stream):
    kinds = set(stream.kinds)
    assert {k for k, _e in SERVICE_KINDS} <= kinds
    assert {"composite_and", "composite_2of3", "composite_nested", "secp256k1", "secp256r1",
            "sphincs", "bls", "attachment", "ed25519"} <= kinds
    assert sum(e is not None for e in stream.expected) == len(SERVICE_KINDS)


def test_shutdown_completes_every_future(stream):
    """A long window holds the requests; shutdown flushes them, every future
    completes with its outcome, a second shutdown does nothing, and a new
    request is refused."""
    for use_scheduler in (False, True):
        svc = BatchedVerifierService(device="cpu", use_device=False,
                                     use_scheduler=use_scheduler, window_s=60.0)
        futs = [svc.verify_signed(s, stream.resolve, a)
                for s, a in zip(stream.stxs[:12], stream.allowed[:12])]
        svc.shutdown()
        assert all(f.done() for f in futs)
        assert [future_outcome(f, timeout=0) for f in futs] == stream.expected[:12]
        svc.shutdown()
        with pytest.raises(VerificationError):
            svc.verify_signed(stream.stxs[0], stream.resolve, stream.allowed[0])


def broken_dispatch(scheme_id, monkeypatch):
    """Make the dispatch of one scheme's bucket raise."""
    real = port_batch._dispatch_bucket

    def dispatch(sid, *args):
        if sid == scheme_id:
            raise RuntimeError(f"injected dispatch failure (scheme {sid})")
        return real(sid, *args)

    monkeypatch.setattr(port_batch, "_dispatch_bucket", dispatch)


def broken_readback(scheme_id, monkeypatch):
    """Make the readback of one scheme's bucket raise."""
    real = port_batch._dispatch_bucket
    real_copy = port_batch.start_host_copy
    marked = []

    class Lost:
        event = None

        def wait(self):
            raise RuntimeError("injected readback failure")

    def dispatch(sid, *args):
        mask = real(sid, *args)
        if sid == scheme_id:
            marked.append(mask)
        return mask

    monkeypatch.setattr(port_batch, "_dispatch_bucket", dispatch)
    monkeypatch.setattr(port_batch, "start_host_copy",
                        lambda m: Lost() if any(m is x for x in marked) else real_copy(m))


@pytest.mark.parametrize("stage", ["dispatch", "readback"])
def test_failed_bucket_fails_its_requests(stream, monkeypatch, stage):
    """No host failover: a secp256k1 bucket whose dispatch or readback
    fails raises out of the row and transaction checks, and fails every
    request batched with it on both of the service's routes (on the
    scheduler route at least each request that holds a secp256k1 row,
    the others with the error or their own outcome)."""
    keep = [i for kind in ("secp256k1", "composite_and", "ed25519", "forged_leaf_signature")
            for i in [j for j, k in enumerate(stream.kinds) if k == kind][:2]]
    stxs = [stream.stxs[i] for i in keep]
    allowed = [stream.allowed[i] for i in keep]
    holds_k1 = [any(sig.by.scheme_id == 2 for sig in s.sigs) for s in stxs]
    assert any(holds_k1) and not all(holds_k1)
    (broken_dispatch if stage == "dispatch" else broken_readback)(2, monkeypatch)
    rows = [(sig.by, sig.signature, sig.signable_for(s.id)) for s in stxs for sig in s.sigs]
    with pytest.raises(RuntimeError, match="injected"):
        dispatch_signature_rows(rows, device="cpu").collect()
    with pytest.raises(RuntimeError, match="injected"):
        check_transactions(stxs, allowed, device="cpu")
    lost = ("RuntimeError", frozenset())
    shutdown_scheduler()
    try:
        windowed = BatchedVerifierService(device="cpu", use_scheduler=False,
                                          max_batch=len(stxs), window_s=60.0)
        assert run(windowed, stxs, stream.resolve, allowed) == [lost] * len(stxs)
        outs = run(BatchedVerifierService(device="cpu"), stxs, stream.resolve, allowed)
        assert all(o == lost for o, h in zip(outs, holds_k1) if h)
        assert all(o in (lost, stream.expected[i]) for o, i in zip(outs, keep))
    finally:
        shutdown_scheduler()


def test_in_memory_service_matches_reference(stream, carried):
    """Contract semantics only, on a host pool: the same outcome (class and
    message) as the reference's for every transaction whose inputs
    resolve."""
    stxs, _allowed, resolve = carried
    port, ref = InMemoryVerifierService(), RefInMemory()
    try:
        got = [port.verify(s.tx.to_ledger_transaction(stream.resolve)) for s in stream.stxs]
        want = [ref.verify(s.tx.to_ledger_transaction(resolve)) for s in stxs]
        shown = [[None if f.exception(timeout=60) is None
                  else (type(f.exception()).__name__, str(f.exception())) for f in fs]
                 for fs in (got, want)]
        assert shown[0] == shown[1]
        assert sum(s is not None for s in shown[0]) == 3  # the three contract kinds
    finally:
        port.shutdown()
        ref.shutdown()
    svc = BatchedVerifierService(device="cpu", use_device=False)
    try:
        assert svc.verify(stream.stxs[0].tx.to_ledger_transaction(stream.resolve)).result(
            timeout=60) is None
    finally:
        svc.shutdown()
