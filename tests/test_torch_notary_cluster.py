"""The batched notary over a notary cluster, the port's against the
reference's.

Both packages' ``BatchedNotaryService(validating=True)`` answer
``testing.notary_stream(contract_invalid=True)`` (its adversarial kinds,
carried between the packages as CBE bytes) through a 3-replica Raft
cluster and a 4-replica BFT cluster with quorum certificates, under one
notary keypair and one clock. The port runs on ``device="cpu"`` (its
kernels' plain versions), the reference on its host tier. Slot for slot,
tolerance zero: kind, error class and message, conflict, signature bytes.
Every replica of both clusters ends with the consumed set of the
reference's; each window with a commit is one Raft log entry or one BFT
slot; the BFT run's ``cached_qc`` verifies for every accepted id.

Also the window over a failed cluster (its requests fail with the error,
nothing is signed) and ``_collect_qc`` (one check a round, a bad
certificate dropped), after the reference's ``TestServiceQCCache``."""

import contextlib

import pytest

from corda_tpu.node.monitoring import MetricRegistry as RefMetrics
from corda_tpu.serving import shutdown_scheduler as ref_shutdown_scheduler
from corda_tpu_torch.node import MetricRegistry
from corda_tpu_torch.serving import shutdown_scheduler
from corda_tpu_torch.testing import notary_stream, outcome_kind
from test_torch_bft import NAMES, bft_cluster, bls_keypair
from test_torch_notary_request import NOW, Carried, assert_same, burst, ref_notary, results
from test_torch_raft import (  # noqa: F401  (fixtures)
    PORT,
    REF,
    no_cluster_thread_left,
    one_torch_thread,
    raft_cluster,
    replica_rows,
    wait_for,
    wait_leader,
)

WINDOW = 8


@pytest.fixture(scope="module", autouse=True)
def shared_schedulers():
    yield
    shutdown_scheduler()
    ref_shutdown_scheduler()


@pytest.fixture(scope="module")
def carried():
    """10 moves and the 10 adversarial requests, windows of 8."""
    return Carried(notary_stream(10, WINDOW, seed=14, contract_invalid=True, device="cpu"))


def notary(pkg, stream, provider, metrics=None):
    if pkg is REF:
        return ref_notary(stream, provider=provider, max_batch=WINDOW, metrics=metrics)
    return PORT.notary.BatchedNotaryService(
        stream.notary, stream.notary_keypair, provider, max_batch=WINDOW, window_s=0.01,
        clock=lambda: NOW, device="cpu", metrics=metrics)


def stxs_of(pkg, carried):
    return carried.port_stxs() if pkg is PORT else carried.ref_stxs()


def resolve_of(pkg, carried):
    return carried.resolve if pkg is PORT else carried.ref_resolve


def count_commits(provider) -> list:
    """Wrap the provider's ``commit_batch_async`` to count the windows that
    commit anything (an empty one makes no round)."""
    rounds = []
    inner = provider.commit_batch_async

    def counted(requests):
        if requests:
            rounds.append(len(requests))
        return inner(requests)

    provider.commit_batch_async = counted
    return rounds


# the stream's cluster runs at chip_smoke.py phase 20's timers: beside the
# suite's other workers, make_cluster's 0.15-0.3 s elections, 50 ms
# heartbeats and 2 s submit window let a late heartbeat start an election
# or a slow round be submitted twice, and either puts an extra entry in
# the log (ROADMAP.md Queue 3, co-located election thrash)
RAFT_ELECTION_S = (1.0, 2.0)
RAFT_HEARTBEAT_S = 0.25
RAFT_SUBMIT_S = 60.0   # one window's round on a loaded CPU


@contextlib.contextmanager
def steady_raft_cluster(pkg, names):
    """A started co-located cluster at phase 20's timers on a pumping
    network; every replica and the pump stopped on the way out."""
    net = pkg.messaging.InMemoryMessagingNetwork()
    net.start_pumping()
    providers = []
    try:
        for name in names:
            providers.append(pkg.notary.RaftUniquenessProvider.make_node_on_endpoint(
                name, names, net.create_node(name), election_timeout_s=RAFT_ELECTION_S,
                heartbeat_s=RAFT_HEARTBEAT_S))
        for p in providers:
            p._retry_s = RAFT_SUBMIT_S
            p.node.start()
        yield net, providers
    finally:
        for p in providers:
            p.close()
        net.stop_pumping()


def over_raft(pkg, carried):
    """The stream through ``process_stream`` at depth 2 over a Raft
    cluster; the answers and every replica's consumed set."""
    with steady_raft_cluster(pkg, ["nr0", "nr1", "nr2"]) as (_net, providers):
        leader = wait_leader(providers, timeout=30.0)
        rounds = count_commits(leader)
        svc = notary(pkg, carried.stream, leader)
        resolve = resolve_of(pkg, carried)
        stxs = stxs_of(pkg, carried)
        windows = [[(s, resolve, "alice") for s in stxs[i:i + WINDOW]]
                   for i in range(0, len(stxs), WINDOW)]
        try:
            got = [r for w in svc.process_stream(windows, depth=2) for r in w]
        finally:
            svc.shutdown()
        assert leader.node.log.last_index() + 1 == len(rounds) > 0
        wait_for(lambda: all(p.node.last_applied == leader.node.commit_index
                             for p in providers), 30.0, "every replica to apply")
        return got, [replica_rows(p) for p in providers]


def test_notary_stream_over_raft_cluster(carried):
    got, port_rows = over_raft(PORT, carried)
    want, ref_rows = over_raft(REF, carried)
    assert_same(got, want, carried.kinds)
    assert port_rows == ref_rows
    assert all(rows == port_rows[0] for rows in port_rows)
    assert len({r[1] for r in port_rows[0]}) == carried.kinds.count("signed")


def over_bft(pkg, carried):
    """The stream through ``request()`` (submitted as one burst, so it
    flushes as full windows) over a BFT cluster with certificates; the
    answers, every replica's consumed set and the cached certificates."""
    with bft_cluster(pkg) as (_net, replicas, make_client):
        provider = make_client("notary-client")
        rounds = count_commits(provider)
        metrics = (MetricRegistry if pkg is PORT else RefMetrics)()
        svc = notary(pkg, carried.stream, provider, metrics=metrics)
        stxs = stxs_of(pkg, carried)
        try:
            with burst():
                futures = [svc.request(s, resolve_of(pkg, carried), "alice") for s in stxs]
            got = results(futures)
        finally:
            svc.shutdown()
        assert len(rounds) == -(-len(stxs) // WINDOW)
        # a lagging replica executes its last slots late beside the suite's
        # other workers (this wait once ran out at 5 s there)
        wait_for(lambda: all(r._next_exec == len(rounds) for r in replicas), 30.0,
                 "one slot a window on every replica")
        qcs = [svc.cached_qc(s.id) for s, r in zip(stxs, got) if outcome_kind(r) == "signed"]
        # one certificate a round, cached beside each id it accepted
        distinct = list({id(q): q for q in qcs}.values())
        assert None not in qcs and len(distinct) == len(rounds)
        assert all(q.verify(provider.bls_member_keys) for q in distinct)
        assert metrics.counter("notary.qc.cached").count == len(rounds)
        rows = [sorted((k, d.consuming_tx.bytes, d.input_index, d.requesting_party_name)
                       for k, d in r.base._map.items()) for r in replicas]
        return got, rows, [q.encode() for q in qcs]


def test_notary_stream_over_bft_cluster_with_qc(carried):
    got, port_rows, port_qcs = over_bft(PORT, carried)
    want, ref_rows, ref_qcs = over_bft(REF, carried)
    assert_same(got, want, carried.kinds)
    assert port_rows == ref_rows and all(rows == port_rows[0] for rows in port_rows)
    # the certified outcome is the same bytes; the signer set is whichever
    # f+1 replicas answered first
    assert ([PORT.qc.QuorumCertificate.decode(b).message for b in port_qcs]
            == [REF.qc.QuorumCertificate.decode(b).message for b in ref_qcs])


def test_batched_notary_service_over_raft_cluster(carried):
    """Both spends of one input in one window: exactly one wins, decided
    by the replicated state machine, in one log entry."""
    window = carried.kinds[:WINDOW]
    assert window.count("conflict") == 1
    out = {}
    for pkg in (PORT, REF):
        with raft_cluster(pkg, ["nb0", "nb1", "nb2"]) as (_net, providers):
            leader = wait_leader(providers)
            svc = notary(pkg, carried.stream, leader)
            stxs = stxs_of(pkg, carried)[:WINDOW]
            try:
                out[pkg.root] = svc.process_batch(
                    [(s, resolve_of(pkg, carried), "client") for s in stxs])
            finally:
                svc.shutdown()
            assert leader.node.log.last_index() == 0
            for s, r in zip(stxs, out[pkg.root]):
                if outcome_kind(r) == "signed":
                    r.verify(s.id)
    assert_same(out["corda_tpu_torch"], out["corda_tpu"], window)


def test_failed_cluster_fails_its_window(carried):
    """A BFT round that never reaches a quorum fails its requests with the
    client's error: nothing is committed, signed or cached."""
    with bft_cluster(PORT, bls_qc=False) as (net, replicas, make_client):
        provider = make_client("lonely-client")
        provider.client._timeout_s = 0.3
        for r in replicas:
            net.stop_node(r.name)
        svc = notary(PORT, carried.stream, provider)
        stxs = carried.port_stxs()[WINDOW:2 * WINDOW]
        try:
            got = results([svc.request(s, carried.resolve, "alice") for s in stxs])
            with pytest.raises(TimeoutError):
                svc.process_batch([(s, carried.resolve, "alice") for s in stxs])
        finally:
            svc.shutdown()
    assert all(isinstance(r, TimeoutError) for r in got)
    assert all(svc.cached_signature(s.id) is None for s in stxs)


def test_collect_qc_verifies_once_and_drops_garbage():
    bls = PORT.bls
    members = [bls_keypair(PORT, name) for name in NAMES]
    outcome = b"svc-outcome"
    qc = PORT.qc.QuorumCertificate(
        message=outcome, agg_sig=bls.aggregate([bls.sign(members[i][1], outcome)
                                                for i in (0, 1)]),
        bitmap=0b0011, n=4)
    bad = PORT.qc.QuorumCertificate(message=b"other", agg_sig=qc.agg_sig, bitmap=0b0011, n=4)

    class Provider(PORT.notary.InMemoryUniquenessProvider):
        def __init__(self, q):
            super().__init__()
            self._q = q
            self.bls_member_keys = [pk for pk, _sk in members]

        def take_qc(self):
            q, self._q = self._q, None
            return q

    stream = notary_stream(5, 3, seed=3, device="cpu")
    for q, want, counter in ((qc, qc, "notary.qc.cached"), (bad, None, "notary.qc.rejected")):
        metrics = MetricRegistry()
        svc = PORT.notary.BatchedNotaryService(
            stream.notary, stream.notary_keypair, Provider(q), use_device=False,
            use_scheduler=False, metrics=metrics, device="cpu")
        try:
            assert svc._collect_qc() is want
            assert svc._collect_qc() is None  # take-once
        finally:
            svc.shutdown()
        assert metrics.counter(counter).count == 1
