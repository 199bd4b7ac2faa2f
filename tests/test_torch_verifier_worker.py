"""The out-of-process verifier (``verifier/worker.py``), the port's against
the reference's: the cases of the reference's ``tests/test_verifier_worker.py``
(one worker, an invalid transaction, competing workers, a corrupt payload,
a dead letter, no worker, a lost request, a worker's death) run on both
packages over the same transactions (the reference's
``GeneratedLedger(seed=...)`` carried to the port as CBE bytes), each
answer's error class and text equal. The reference's worker checks
signatures on the host; the port's on ``device="cpu"`` (the kernels' plain
versions). Also: the wire bytes of the request, response and dead letter;
``python -m corda_tpu_torch.verifier.worker`` as a process over a broker
file, stopped by an interrupt with rc 0; the fabric mode's refusal."""

import os
import signal
import subprocess
import sys
import time
from concurrent.futures import Future

import pytest
import torch

from corda_tpu.messaging import DurableQueueBroker as RefBroker
from corda_tpu.serialization import deserialize as ref_deserialize
from corda_tpu.serialization import serialize as ref_serialize
from corda_tpu.testing import GeneratedLedger as RefGeneratedLedger
from corda_tpu.verifier import worker as ref_worker
import corda_tpu_torch.testing  # noqa: F401  (registers testing.GenContract)
from corda_tpu_torch.messaging import DurableQueueBroker
from corda_tpu_torch.serialization import deserialize, serialize
from corda_tpu_torch.verifier import worker as port_worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {
    "ref": (ref_worker, RefBroker, ref_deserialize, {}),
    "port": (port_worker, DurableQueueBroker, deserialize,
             {"device": "cpu"}),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run many small integer ops: beside the suite's
    other worker processes a torch thread pool only contends, so these
    tests run torch on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def ledger(seed: int, n: int, notary_sig: bool = True):
    """(reference stxs, port stxs, reference resolver, port resolver): the
    reference's generated DAG, carried to the port as CBE bytes."""
    gen = RefGeneratedLedger(seed=seed)
    ref_txs = list(gen.generate(n, with_notary_sig=notary_sig).values())
    port_txs = [deserialize(ref_serialize(s)) for s in ref_txs]
    ref_outputs = {s.id: s.tx.outputs for s in gen.transactions.values()}
    port_outputs = {
        s.id: s.tx.outputs
        for s in (deserialize(ref_serialize(t)) for t in gen.transactions.values())
    }
    return (ref_txs, port_txs,
            lambda ref: ref_outputs[ref.txhash][ref.index],
            lambda ref: port_outputs[ref.txhash][ref.index])


@pytest.fixture(scope="module")
def txs12():
    return ledger(5, 12)


def answer(fut: Future, timeout: float = 60):
    """A future's outcome: None, or (error class, error text)."""
    try:
        fut.result(timeout=timeout)
        return None
    except Exception as e:  # noqa: BLE001
        return (type(e).__name__, str(e))


class Rig:
    """One package's broker, node-side service and workers."""

    def __init__(self, pkg: str, broker_kw=None, service_kw=None):
        self.pkg = pkg
        (self.mod, broker_cls, self.de, self.worker_kw) = PKGS[pkg]
        self.broker = broker_cls(**(broker_kw or {}))
        self.service = self.mod.OutOfProcessVerifierService(
            self.broker, "test-node", **(service_kw or {}))
        self.workers = []

    def worker(self, **kw):
        w = self.mod.VerifierWorker(self.broker, **{**self.worker_kw, **kw}).start()
        self.workers.append(w)
        return w

    def close(self):
        for w in self.workers:
            w.stop()
        self.service.shutdown()
        self.broker.close()


def both(fn, *args, **rig_kw):
    """``fn(rig, *pkg_args)`` on each package; returns {pkg: result}."""
    out = {}
    for pkg in ("ref", "port"):
        rig = Rig(pkg, **rig_kw)
        try:
            out[pkg] = fn(rig, *(a[pkg] if isinstance(a, dict) else a for a in args))
        finally:
            rig.close()
    return out


def split(data):
    ref_txs, port_txs, ref_res, port_res = data
    return {"ref": ref_txs, "port": port_txs}, {"ref": ref_res, "port": port_res}


def test_single_worker_verifies(txs12):
    txs, res = split(txs12)

    def run(rig, stxs, resolve):
        rig.worker()
        answers = [answer(f) for f in [rig.service.verify_stx(s, resolve) for s in stxs]]
        return answers, rig.service.pending_count()

    got = both(run, txs, res)
    assert got["port"] == got["ref"] == ([None] * 12, 0)


def test_invalid_transaction_rejected(txs12):
    """Every signature but the notary's dropped: the missing signers come
    back as the same verification error in both packages."""
    txs, res = split(txs12)

    def run(rig, stxs, resolve):
        rig.worker()
        stx = stxs[-1]
        bad = stx.__class__(stx.tx_bits, stx.sigs[:1])
        fut = rig.service.verify_stx(bad, resolve)
        with pytest.raises(rig.mod.VerificationFailedError):
            fut.result(timeout=60)
        return answer(fut)

    got = both(run, txs, res)
    assert got["port"] == got["ref"]
    assert got["port"][0] == "VerificationFailedError"
    assert got["port"][1].startswith("SignaturesMissingException")


def test_competing_workers_split_load(txs12):
    txs, res = split(txs12)

    def run(rig, stxs, resolve):
        workers = [rig.worker(worker_name=f"w{i}") for i in range(3)]
        answers = [answer(f) for f in [rig.service.verify_stx(s, resolve) for s in stxs]]
        # workers bump their counters after replying
        deadline = time.monotonic() + 5
        while (sum(w.verified for w in workers) < len(stxs)
               and time.monotonic() < deadline):
            time.sleep(0.02)
        counts = sorted(w.verified for w in workers)
        assert sum(1 for c in counts if c > 0) >= 2, counts
        return answers, sum(counts)

    got = both(run, txs, res)
    assert got["port"] == got["ref"] == ([None] * 12, 12)


def test_corrupt_payload_completes_future():
    """A payload the worker cannot decode is answered through the msg_id's
    routing with the same error text as the reference's."""

    def run(rig):
        fut = Future()
        with rig.service._lock:
            rig.service._pending[7] = rig.mod._PendingRequest(
                fut, b"", time.monotonic() + 30)
        rig.broker.publish(
            rig.mod.VERIFICATION_REQUESTS_QUEUE, b"\xffnot-cbe-at-all",
            msg_id=f"vreq-{rig.service.reply_queue}-7",
        )
        worker = rig.worker()
        got = answer(fut, timeout=10)
        deadline = time.monotonic() + 5
        while worker.malformed < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        return got, worker.malformed

    got = both(run)
    assert got["port"] == got["ref"]
    assert got["port"][1] == 1
    assert got["port"][0][1].startswith("malformed request")


def test_unroutable_garbage_dead_letters():
    """Garbage with no routing lands on the dead-letter queue: the same
    dead letter, byte for byte, in both packages."""

    def run(rig):
        rig.broker.publish(rig.mod.VERIFICATION_REQUESTS_QUEUE, b"\x00junk",
                           msg_id="some-foreign-producer-id")
        rig.worker()
        msg = rig.broker.consume(rig.mod.VERIFICATION_DEAD_LETTER_QUEUE, timeout=10)
        assert msg is not None
        dead = rig.de(msg.payload)
        assert isinstance(dead, rig.mod.DeadLetter)
        rig.broker.ack(msg.msg_id)
        return bytes(msg.payload), (dead.msg_id, dead.error, dead.payload)

    got = both(run)
    assert got["port"] == got["ref"]
    assert got["port"][1][0] == "some-foreign-producer-id"
    assert got["port"][1][2] == b"\x00junk"


def test_no_workers_times_out_future():
    data = ledger(7, 1)
    txs, res = split(data)

    def run(rig, stxs, resolve):
        fut = rig.service.verify_stx(stxs[0], resolve)
        with pytest.raises(rig.mod.VerificationTimeoutError):
            fut.result(timeout=15)
        return (answer(fut), rig.service.pending_count(), rig.service.timeouts,
                rig.service.retries)

    got = both(run, txs, res,
               service_kw={"request_timeout_s": 0.4, "max_retries": 1})
    assert got["port"] == got["ref"]
    assert got["port"][1:] == (0, 1, 1)


def test_retry_recovers_lost_request():
    """A request acked by a worker that died before replying is
    republished at its deadline and answered by a healthy worker. The
    deadline is 5 s (the reference's test: 0.5 s), so that the port's check
    through the plain versions on a loaded CPU answers a republished
    request before its next deadline."""
    data = ledger(8, 1)
    txs, res = split(data)

    def run(rig, stxs, resolve):
        fut = rig.service.verify_stx(stxs[0], resolve)
        leased = rig.broker.consume(rig.mod.VERIFICATION_REQUESTS_QUEUE, timeout=5)
        assert leased is not None
        rig.broker.ack(leased.msg_id)
        rig.worker()
        got = answer(fut, timeout=60)
        return got, rig.service.retries >= 1, rig.service.timeouts

    got = both(run, txs, res,
               service_kw={"request_timeout_s": 5.0, "max_retries": 2})
    assert got["port"] == got["ref"] == (None, True, 0)


def test_worker_death_redistributes():
    """A request leased and never acked redelivers to a healthy worker
    after the visibility timeout: 3 s (the reference's test: 0.5 s). The
    healthy worker's own lease is then made long enough for one check on a
    loaded CPU (beside the suite's other workers the port's check of one
    transaction on the plain versions took longer than the 30 s this test
    used to wait for the answer), so that its lease does not expire too."""
    data = ledger(6, 1, notary_sig=False)
    txs, res = split(data)

    def run(rig, stxs, resolve):
        fut = rig.service.verify_stx(stxs[0], resolve)
        leased = rig.broker.consume(rig.mod.VERIFICATION_REQUESTS_QUEUE, timeout=5)
        assert leased is not None  # ...and never acked
        rig.broker._visibility_s = 600.0  # the healthy worker's lease
        worker = rig.worker()
        got = answer(fut, timeout=300)
        return got, worker.verified

    # the service's own republish backstop (60 s by default) sits above the
    # answer's wait, so only the broker's redelivery can answer
    got = both(run, txs, res, broker_kw={"visibility_s": 3.0},
               service_kw={"request_timeout_s": 600.0})
    assert got["port"] == got["ref"] == (None, 1)


def test_wire_bytes_match_reference(txs12):
    ref_txs, port_txs, ref_res, port_res = txs12
    ref_ltx = ref_txs[3].tx.to_ledger_transaction(ref_res)
    port_ltx = port_txs[3].tx.to_ledger_transaction(port_res)
    assert serialize(port_worker.VerificationRequest(
        11, port_txs[3], port_ltx, "verifier.responses.n")) == ref_serialize(
        ref_worker.VerificationRequest(11, ref_txs[3], ref_ltx, "verifier.responses.n"))
    assert serialize(port_worker.VerificationResponse(11, "E: x")) == ref_serialize(
        ref_worker.VerificationResponse(11, "E: x"))
    assert serialize(port_worker.DeadLetter("m", "e", b"p")) == ref_serialize(
        ref_worker.DeadLetter("m", "e", b"p"))


def test_worker_process_serves_a_broker_file(tmp_path, txs12):
    """``python -m corda_tpu_torch.verifier.worker`` over a broker file
    (here ``--device cpu``, the generated ledger's contract loaded with
    ``--cordapp``) answers the node's requests, and an interrupt stops it
    with rc 0 and no abort."""
    _, port_txs, _, port_res = txs12
    path = str(tmp_path / "broker.db")
    broker = DurableQueueBroker(path)
    service = port_worker.OutOfProcessVerifierService(broker, "proc-node")
    proc = subprocess.Popen(
        [sys.executable, "-m", "corda_tpu_torch.verifier.worker", path,
         "--device", "cpu", "--name", "proc-worker",
         "--cordapp", "corda_tpu_torch.testing"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    try:
        answers = [answer(f, timeout=120)
                   for f in [service.verify_stx(s, port_res) for s in port_txs[:4]]]
        assert answers == [None] * 4
    finally:
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=60)
        service.shutdown()
        broker.close()
    assert proc.returncode == 0, err[-2000:]
    assert "terminate called" not in err


def test_fabric_mode_waits_for_step_9():
    with pytest.raises(NotImplementedError, match="step 9"):
        port_worker.run_worker("unused.db", fabric_address="localhost:1")
