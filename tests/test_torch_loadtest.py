"""The load-test harness, the port's against the reference's.

The scenarios of the reference's ``tests/test_tools.py::TestLoadTest``
run on both packages' ``MockNetworkNodes`` (Alice, Bob and a notary node:
the port's hubs and batched notary on ``device="cpu"``, the reference's
host services): self-issue, the notarisation storm under a stalled
network, a wrong model detected, and the runner's walls. Both packages
draw the same commands from the same seeds, so each run's ``final_state``
must be equal. ``notary_service_storm_test`` drives both packages'
``BatchedNotaryService.request()`` with the same carried requests (a
seeded Cash stream with its adversarial kinds) under a model that counts
the requests expected to commit: the same committed count and the same
``final_state``."""

import dataclasses
import threading

import pytest
import torch

import corda_tpu.finance  # noqa: F401  (registers the reference's Cash contract)
import corda_tpu.tools.loadtest as ref_loadtest
from corda_tpu.crypto.keys import KeyPair as RefKeyPair
from corda_tpu.crypto.keys import PrivateKey as RefPrivateKey
from corda_tpu.notary import BatchedNotaryService as RefNotary
from corda_tpu.notary import PersistentUniquenessProvider as RefPersistent
from corda_tpu.serialization import deserialize as ref_deserialize
from corda_tpu.serialization import serialize as ref_serialize
from corda_tpu.serving import shutdown_scheduler as ref_shutdown_scheduler
from corda_tpu.testing.mocknet import MockNetworkNodes as RefMockNetworkNodes
import corda_tpu_torch.testing.mocknet as port_mocknet
import corda_tpu_torch.tools.loadtest as port_loadtest
from corda_tpu_torch import interop
from corda_tpu_torch.notary import BatchedNotaryService, PersistentUniquenessProvider
from corda_tpu_torch.serialization import serialize
from corda_tpu_torch.serving import shutdown_scheduler
from corda_tpu_torch.testing import notary_stream, state_resolver

NOW = 1_800_000_000.0


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


@pytest.fixture
def nets():
    """(the port's network, the reference's), each with Alice, Bob and a
    notary node: the port's a batched notary on the CPU, the reference's
    its validating host service. The port's nodes park a waiting flow after
    30 s here (the plain versions make its waits long on the CPU)."""
    grace = port_mocknet.MOCK_PARKING_GRACE_S
    port_mocknet.MOCK_PARKING_GRACE_S = 30.0
    port = port_mocknet.MockNetworkNodes(device="cpu")
    ref = RefMockNetworkNodes()
    try:
        for net in (port, ref):
            net.create_node("Alice")
            net.create_node("Bob")
        port.create_notary_node("Notary", batched=True, max_batch=8, window_s=0.005)
        ref.create_notary_node("Notary")
        yield port, ref
    finally:
        port.stop()
        ref.stop()
        port_mocknet.MOCK_PARKING_GRACE_S = grace


def run_both(nets, make, params, disruptions=None):
    """Run the same test on both networks; returns (port's, reference's)
    results."""
    out = []
    for net, lt in zip(nets, (port_loadtest, ref_loadtest)):
        test = make(net, lt)
        dis = disruptions(net, lt) if disruptions else None
        out.append(lt.LoadTestRunner(test, lt.RunParameters(**params),
                                     disruptions=dis).run())
    return out


def test_self_issue(nets):
    def make(net, lt):
        nodes = {"Alice": net.nodes["Alice"], "Bob": net.nodes["Bob"]}
        return lt.self_issue_test(nodes, net.nodes["Notary"].party)

    got, want = run_both(nets, make, dict(parallelism=2, generate_count=2,
                                          execution_frequency_hz=None))
    assert got["executed"] == want["executed"] == 4
    assert got["failed"] == want["failed"] == 0
    assert got["final_state"] == want["final_state"]
    assert sum(got["final_state"].values()) > 0


def test_walls_reported_separately(nets):
    """The runner times generation, execution and gathering apart, and
    computes the rate against the execution wall alone."""
    def make(net, lt):
        return lt.self_issue_test({"Alice": net.nodes["Alice"]}, net.nodes["Notary"].party)

    for result in run_both(nets, make, dict(parallelism=1, generate_count=1,
                                            execution_frequency_hz=None)):
        walls = result["walls"]
        assert set(walls) == {"generate_s", "execute_s", "gather_s", "total_s"}
        assert all(v >= 0 for v in walls.values())
        assert walls["total_s"] == pytest.approx(
            walls["generate_s"] + walls["execute_s"] + walls["gather_s"])
        assert result["executed_per_s"] == pytest.approx(
            result["executed"] / walls["execute_s"])


def test_notarisation_storm_with_disruption(nets):
    """Issue-and-move pairs from random nodes while deliveries stall for
    0.1 s: the notary's committed count reconciles with the model's."""
    def make(net, lt):
        return lt.notarisation_storm_test(dict(net.nodes), net.nodes["Notary"].party)

    def stall(net, lt):
        def strain():
            net.net.stop_pumping()
            threading.Timer(0.1, net.net.start_pumping).start()
            return None

        return [lt.Disruption("stall", strain, at_generation=1)]

    got, want = run_both(nets, make, dict(parallelism=1, generate_count=2,
                                          execution_frequency_hz=None,
                                          gather_frequency=10), stall)
    for result in (got, want):
        assert result["executed"] == 2 and result["failed"] == 0
        assert result["disruptions"] == 1
    assert got["final_state"] == want["final_state"] == 2


@pytest.mark.parametrize("lt", [port_loadtest, ref_loadtest], ids=["port", "ref"])
def test_divergence_detected(lt):
    """A wrong model fails the run."""
    observed: list = []
    test = lt.LoadTest(
        name="broken",
        generate=lambda s, p: [1],
        interpret=lambda s, c: s + 2,   # wrong: execute adds 1
        execute=lambda c: observed.append(1),
        gather=lambda: len(observed),
        initial_state=0,
    )
    with pytest.raises(lt.LoadTestError, match="diverged"):
        lt.LoadTestRunner(test, lt.RunParameters(
            parallelism=1, generate_count=2, gather_frequency=1,
            execution_frequency_hz=None,
        )).run()


class Recorder:
    """A notary seen by the storm: its requests and their futures are kept
    in submission order."""

    def __init__(self, svc):
        self.svc = svc
        self.uniqueness = svc.uniqueness
        self.requests: list = []
        self.futures: list = []

    def request(self, stx, resolve, caller):
        fut = self.svc.request(stx, resolve, caller)
        self.requests.append(stx)
        self.futures.append(fut)
        return fut


def answers(futures) -> list:
    out = []
    for f in futures:
        try:
            sig = f.result(timeout=120)
            out.append(("signed", sig.signature))
        except Exception as e:  # a refusal is the request's answer
            out.append(("refused", type(e).__name__, str(e)))
    return out


def storm_with_refusals(lt, recorder, stxs, resolve, expected, chunk):
    """``notary_service_storm_test`` over a stream that holds requests the
    notary refuses (``expected``: object id -> whether it commits). Its
    model counts the requests submitted; the gather waits for every future
    (a refusal is an answer) and reads the committed count plus the
    refusals expected among the submitted, which reconciles only if
    exactly the expected requests committed."""
    test = lt.notary_service_storm_test(recorder, stxs, resolve, chunk=chunk)

    def gather():
        answers(recorder.futures)
        refused = sum(not expected[id(stx)] for stx in recorder.requests)
        return recorder.uniqueness.committed_txs() + refused

    return dataclasses.replace(test, gather=gather)


def test_notary_service_storm_matches_reference():
    """The storm's final state, each request's answer (the signature bytes,
    or the refusal's class and message) and the committed rows equal the
    reference's."""
    stream = notary_stream(20, 8, seed=17, device="cpu")
    kinds = [k for w in stream.kinds for k in w]
    raws = [serialize(stx) for w in stream.windows for stx in w]
    ref_stxs = [ref_deserialize(raw) for raw in raws]
    port_stxs = [interop.signed_transaction_from_reference(ref_serialize(s))
                 for s in ref_stxs]
    ref_issue = ref_deserialize(serialize(stream.issue))
    identity = ref_deserialize(serialize(stream.notary))
    ref_keypair = RefKeyPair(identity.owning_key, RefPrivateKey(
        4, stream.notary_keypair.private.encoded))
    port = Recorder(BatchedNotaryService(
        stream.notary, stream.notary_keypair, PersistentUniquenessProvider(), max_batch=8,
        window_s=0.005, clock=lambda: NOW, device="cpu"))
    ref = Recorder(RefNotary(identity, ref_keypair, RefPersistent(), use_device=False,
                             max_batch=8, window_s=0.005, clock=lambda: NOW))
    # one injector: the requests reach both notaries in the stream's order,
    # so the same one of each double-spending pair commits
    params = dict(parallelism=1, generate_count=4, execution_frequency_hz=None,
                  gather_frequency=10**9)
    results = []
    try:
        for lt, rec, stxs, issue_tx in (
                (port_loadtest, port, port_stxs, interop.signed_transaction_from_reference(
                    ref_serialize(ref_issue)).tx),
                (ref_loadtest, ref, ref_stxs, ref_issue.tx)):
            expected = {id(s): k == "signed" for s, k in zip(stxs, kinds)}
            test = storm_with_refusals(lt, rec, stxs, state_resolver(issue_tx), expected, 7)
            results.append(lt.LoadTestRunner(test, lt.RunParameters(**params)).run())
    finally:
        port.svc.shutdown()
        ref.svc.shutdown()
    got, want = results
    assert got["executed"] == want["executed"] == 4
    assert got["final_state"] == want["final_state"] == len(kinds)
    assert port.uniqueness.committed_txs() == kinds.count("signed")
    assert answers(port.futures) == answers(ref.futures)
    assert [a[0] for a in answers(port.futures)] == [
        "signed" if k == "signed" else "refused" for k in kinds]
    assert port.uniqueness.rows() == sorted(
        (bytes(k), bytes(t), int(i), str(c))
        for k, t, i, c in ref.uniqueness._db.execute("SELECT * FROM notary_commits"))
