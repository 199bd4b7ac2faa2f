"""The port's verifier and device scheduler (corda_tpu_torch/verifier,
corda_tpu_torch/serving) on the CPU: per-request verdicts equal to the
reference's ``verify_signature_rows`` on the same rows, class-mixed
concurrent requests, completion-order settling, admission control,
deadline shedding and shutdown."""

import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from corda_tpu.crypto.keys import PublicKey as RefPublicKey
from corda_tpu.verifier.batch import verify_signature_rows as ref_verify_rows
from corda_tpu_torch.crypto import PublicKey
from corda_tpu_torch.serving import (
    BULK,
    INTERACTIVE,
    SERVICE,
    DeadlineExceededError,
    DeviceScheduler,
    SchedulerClosedError,
    SchedulerSaturatedError,
)
from corda_tpu_torch.serving.scheduler import _InFlight, _Request
from corda_tpu_torch.testing import adversarial_lanes, signed_triples
from corda_tpu_torch.verifier import verify_signature_rows


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run many small integer ops: beside the suite's
    other worker processes a torch thread pool only contends, so these
    tests run torch on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def port_rows(triples):
    return [(PublicKey(4, pk), sig, msg) for pk, sig, msg in triples]


def ref_rows(triples):
    return [(RefPublicKey(4, pk), sig, msg) for pk, sig, msg in triples]


@pytest.fixture(scope="module")
def triples():
    """16 rows: every adversarial lane plus valid ones (44-byte messages)."""
    lanes = [(pk, sig, msg) for _k, pk, sig, msg in adversarial_lanes(0)]
    return lanes + signed_triples(16 - len(lanes), seed=5)


def test_verify_signature_rows_matches_reference(triples):
    got = verify_signature_rows(port_rows(triples), device="cpu")
    ref = ref_verify_rows(ref_rows(triples))
    assert got.tolist() == ref.tolist()
    host = verify_signature_rows(port_rows(triples), use_device=False)
    assert host.tolist() == ref.tolist()


def test_other_schemes_name_their_roadmap_item(triples):
    """Composite keys and BLS (schemes 6, 7) are not ported yet: a row of
    either raises, naming its ROADMAP item."""
    for scheme, item in ((6, "Queue 1 item 13"), (7, "Queue 1 item 12")):
        rows = port_rows(triples[:2]) + [(PublicKey(scheme, b"\x02" * 33), b"s", b"m")]
        with pytest.raises(NotImplementedError, match=item):
            verify_signature_rows(rows, device="cpu")


def test_concurrent_classes_match_reference(triples):
    """Twelve requests from threads across the three classes, coalesced by
    the scheduler: every request's verdicts equal the reference's on the
    same rows, and every row settled on the device."""
    var = signed_triples(4, seed=8, msg_len=(1, 200))
    sizes = [1, 3, 2, 4, 1, 5, 2, 1, 3, 2, 4, 1]
    requests, at = [], 0
    pool = triples + var
    for k, size in enumerate(sizes):
        requests.append(([pool[(at + j) % len(pool)] for j in range(size)],
                         (INTERACTIVE, SERVICE, BULK)[k % 3]))
        at += size
    requests.append((var, SERVICE))  # variable lengths: the host-hash route
    s = DeviceScheduler(device="cpu")
    results: dict = {}
    try:
        s.pause()

        def submit(k, rows, cls):
            results[k] = s.submit_rows(port_rows(rows), priority=cls)

        threads = [threading.Thread(target=submit, args=(k, rows, cls))
                   for k, (rows, cls) in enumerate(requests)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert len(results) == len(requests)
        s.resume()
        got = {k: f.result(timeout=120) for k, f in results.items()}
    finally:
        s.shutdown()
    flat = [row for rows, _cls in requests for row in rows]
    ref = ref_verify_rows(ref_rows(flat))
    at = 0
    for k, (rows, _cls) in enumerate(requests):
        assert got[k].mask.tolist() == ref[at : at + len(rows)].tolist(), k
        assert got[k].n_device == len(rows)
        at += len(rows)
    seqs = [rr.batch_seq for rr in got.values()]
    assert max(seqs.count(q) for q in set(seqs)) > 1  # requests coalesced
    assert s.counters["serving.requests"] == len(requests)
    assert s.counters["serving.rows"] == len(flat)


def test_ready_batch_settles_before_older_inflight():
    s = DeviceScheduler(device="cpu", depth=3)
    settle_order: list = []
    gate = threading.Event()

    def fake_entry(tag, seq, ready=False, block_on=None):
        class FakePending:
            device_mask = np.ones(1, dtype=bool)

            def ready(self):
                return ready

            def collect(self):
                if block_on is not None:
                    assert block_on.wait(timeout=10)
                settle_order.append(tag)
                return np.ones(1, dtype=bool)

        req = _Request([object()], Future(), SERVICE, True, time.monotonic(), None)
        return _InFlight([req], FakePending(), 1, [0], seq, time.monotonic())

    entries = [fake_entry("gate", 101, block_on=gate),
               fake_entry("old-unready", 102, ready=False),
               fake_entry("new-ready", 103, ready=True)]
    try:
        with s._lock:
            s._inflight += len(entries)
        for e in entries:
            s._inflight_q.put(e)
        gate.set()
        for e in entries:
            assert e.requests[0].future.result(timeout=10).mask.tolist() == [True]
        assert settle_order.index("new-ready") < settle_order.index("old-unready")
        assert s.counters["serving.settle_reorder"] >= 1
    finally:
        s.shutdown()


def test_saturated_queue_rejects_at_admission(triples):
    s = DeviceScheduler(device="cpu", max_queue_rows=3)
    try:
        s.pause()
        ok = s.submit_rows(port_rows(triples[-3:]), use_device=False)
        with pytest.raises(SchedulerSaturatedError):
            s.submit_rows(port_rows(triples[-1:]), use_device=False)
        assert s.counters["serving.rejected"] == 1
        s.resume()
        assert ok.result(timeout=30).mask.all()
    finally:
        s.shutdown()


def test_over_deadline_work_is_shed(triples):
    s = DeviceScheduler(device="cpu")
    try:
        s.pause()
        doomed = s.submit_rows(port_rows(triples[-2:]), deadline_s=0.01,
                               use_device=False)
        live = s.submit_rows(port_rows(triples[-1:]), use_device=False)
        time.sleep(0.05)
        s.resume()
        with pytest.raises(DeadlineExceededError):
            doomed.result(timeout=30)
        assert live.result(timeout=30).mask.tolist() == [True]
        assert s.counters["serving.shed"] == 1
    finally:
        s.shutdown()


def test_shutdown_completes_every_queued_future(triples):
    s = DeviceScheduler(device="cpu")
    s.pause()
    futs = [s.submit_rows(port_rows(triples[-1:]), priority=cls)
            for cls in (INTERACTIVE, SERVICE, BULK)]
    s.shutdown()
    for f in futs:
        assert f.result(timeout=5).mask.tolist() == [True]
    assert not s._dispatcher.is_alive() and not s._collector.is_alive()
    with pytest.raises(SchedulerClosedError):
        s.submit_rows(port_rows(triples[-1:]))
    s.shutdown()  # idempotent


def test_other_schemes_are_refused_at_admission(triples):
    """A row of a scheme not ported yet raises at submit, so it never
    fails the requests it would have been batched with."""
    s = DeviceScheduler(device="cpu")
    try:
        s.pause()
        good = s.submit_rows(port_rows(triples[-1:]))
        for scheme, item in ((6, "Queue 1 item 13"), (7, "Queue 1 item 12")):
            with pytest.raises(NotImplementedError, match=item):
                s.submit_rows([(PublicKey(scheme, b"\x02" * 33), b"s", b"m")])
        s.resume()
        assert good.result(timeout=30).mask.tolist() == [True]
        assert s.counters["serving.requests"] == 1
    finally:
        s.shutdown()


def test_dispatch_failure_fails_the_futures(triples, monkeypatch):
    """No host failover: a dispatch that raises fails its requests with
    the error."""
    from corda_tpu_torch.serving import scheduler

    def lost(*_a, **_k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(scheduler, "dispatch_signature_rows", lost)
    s = DeviceScheduler(device="cpu")
    try:
        fut = s.submit_rows(port_rows(triples[-2:]))
        with pytest.raises(RuntimeError, match="device lost"):
            fut.result(timeout=30)
    finally:
        s.shutdown()


def test_process_global_scheduler_is_replaced_and_shut_down(triples):
    from corda_tpu_torch.serving import (
        configure_scheduler,
        device_scheduler,
        shutdown_scheduler,
    )

    first = configure_scheduler(device="cpu")
    try:
        assert device_scheduler() is first
        second = configure_scheduler(device="cpu")
        assert first.closed and device_scheduler() is second
        fut = second.submit_rows(port_rows(triples[-1:]), use_device=False)
        assert fut.result(timeout=30).mask.tolist() == [True]
    finally:
        shutdown_scheduler()
    assert second.closed
