"""The Raft notary cluster, the port's against the reference's.

Bytes (tolerance zero): a window's command, each state machine's outcome
for the same commands (the in-memory map and the SQLite one),
``RaftStorage`` after the same operations (``load()``, ``dump_map()``,
``committed_txs()``), and a replica file the reference wrote, opened by
the port (and the other way round), answering its spent states with the
same conflicts.

Behaviour: the reference's own cluster tests (``tests/test_notary.py``'s
``TestRaft``, ``TestRaftDurability``, the Raft half of
``TestReplicatedBatchCommit``; ``tests/test_faultinject.py``'s
``TestNotaryClusterUnderChaos``), run on both packages. Where the outcome
is deterministic (conflict details, the consumed set of every replica,
its ``consumed_digest``) the port's run must equal the reference's.

Every replica, pump and tick thread is stopped in ``finally``; a fixture
checks that no ``raft-*`` or ``bft-timer-*`` thread a test started is left
when it ends. The helpers here serve ``test_torch_bft.py`` and
``test_torch_notary_cluster.py`` too."""

import contextlib
import hashlib
import importlib
import os
import shutil
import threading
import time
import types
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError

import pytest
import torch


def package(root: str):
    """One package's cluster API under common names."""
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        root=root, crypto=mod("crypto"), ledger=mod("ledger"), messaging=mod("messaging"),
        notary=mod("notary"), bft=mod("notary.bft"), ser=mod("serialization"),
        faultinject=mod("faultinject"),
        bls=mod("batchverify.bls"), qc=mod("batchverify.qc"), monitoring=mod("node.monitoring"),
    )


PORT = package("corda_tpu_torch")
REF = package("corda_tpu")
CLUSTER_THREADS = ("raft-", "bft-timer-")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run many small integer ops: beside the suite's
    other worker processes a torch thread pool only contends."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def cluster_threads(exclude=()) -> list:
    return [t for t in threading.enumerate()
            if t.name.startswith(CLUSTER_THREADS) and t.is_alive() and t not in exclude]


@pytest.fixture(autouse=True)
def no_cluster_thread_left():
    """No Raft tick thread or BFT timer that the test started outlives it."""
    before = set(threading.enumerate())
    yield
    deadline = time.monotonic() + 3.0
    while cluster_threads(before) and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not cluster_threads(before), [t.name for t in cluster_threads(before)]


def refs(pkg, *tags):
    return [pkg.ledger.StateRef(pkg.crypto.sha256(t.encode()), 0) for t in tags]


def txh(pkg, tag: str):
    return pkg.crypto.sha256(tag.encode())


def fake_ref(pkg, n: int):
    return pkg.ledger.StateRef(pkg.crypto.SecureHash(bytes([n]) * 32), 0)


def fake_tx_id(pkg, n: int):
    return pkg.crypto.SecureHash(bytes([100 + n]) * 32)


def conflict_rows(conflict):
    """A conflict (or None) as comparable data."""
    if conflict is None:
        return None
    return sorted((bytes(ref.txhash.bytes), ref.index, bytes(d.consuming_tx.bytes),
                   d.input_index, d.requesting_party_name)
                  for ref, d in conflict.state_history.items())


def digest(rows) -> str:
    """``consumed_digest``'s formula over (key, tx, index, caller) rows."""
    h = hashlib.sha256()
    for key, tx, index, caller in sorted(rows):
        h.update(bytes(key))
        h.update(bytes(tx))
        h.update(int(index).to_bytes(4, "big"))
        h.update(caller.encode())
    return h.hexdigest()


def replica_rows(provider) -> list:
    """A Raft replica's consumed set as sorted rows: its SQLite map, or the
    in-memory map its snapshot-install hook closes over."""
    node = provider.node
    if node._storage is not None:
        return sorted((bytes(k), bytes(t), i, c) for k, t, i, c in node._storage.dump_map())
    base = node._install_map_fn.__defaults__[0]
    with base._lock:
        return sorted((k, d.consuming_tx.bytes, d.input_index, d.requesting_party_name)
                      for k, d in base._map.items())


def wait_for(pred, timeout=5.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def wait_leader(providers, timeout=5.0):
    found = []

    def have():
        found[:] = [p for p in providers if p.node.role == "leader"]
        return bool(found)

    wait_for(have, timeout, "a raft leader")
    return found[0]


@contextlib.contextmanager
def raft_cluster(pkg, names, storage_dir=None, compact_every=512, network=None):
    """A started co-located cluster on a pumping network; every replica
    still in the list and the pump are stopped on the way out."""
    if storage_dir is not None:
        os.makedirs(storage_dir, exist_ok=True)
    net = network or pkg.messaging.InMemoryMessagingNetwork()
    net.start_pumping()
    providers = []
    try:
        providers.extend(pkg.notary.RaftUniquenessProvider.make_cluster(
            names, net, storage_dir=storage_dir, compact_every=compact_every))
        yield net, providers
    finally:
        for p in providers:
            p.close()
        net.stop_pumping()


# ----------------------------------------------------------------- bytes

def batch_requests(pkg):
    return [
        (refs(pkg, "ba", "bb"), txh(pkg, "t1"), "alice"),
        (refs(pkg, "bb"), txh(pkg, "t2"), "bob"),          # intra-batch spend
        (refs(pkg, "bc"), txh(pkg, "t3"), "carol"),
        (refs(pkg, "ba", "bb"), txh(pkg, "t1"), "alice"),  # idempotent re-commit
    ]


def commands(pkg) -> list:
    """A sequence of single and batch commands with conflicts, re-commits
    and an intra-batch double spend, as the providers serialize them."""
    ser = pkg.ser.serialize
    return [
        ser((list(refs(pkg, "a", "b")), txh(pkg, "s1"), "alice")),
        ser((list(refs(pkg, "b", "c")), txh(pkg, "s2"), "bob")),   # conflict on b
        ser((list(refs(pkg, "a", "b")), txh(pkg, "s1"), "alice")),  # re-commit
        ser(("batch", [(list(s), t, c) for s, t, c in batch_requests(pkg)])),
        ser(("batch", [(list(refs(pkg, "bc", "d")), txh(pkg, "t4"), "dan"),
                       (list(refs(pkg, "e")), txh(pkg, "t5"), "erin")])),
        ser(("batch", [])),
    ]


class RecordingNode:
    """A Raft node stand-in that records each command submitted and
    answers it with ``answer``."""

    name = "recorder"

    def __init__(self, answer: bytes):
        self.answer = answer
        self.sent = []

    def submit_anywhere(self, command: bytes) -> Future:
        self.sent.append(command)
        fut = Future()
        fut.set_result(self.answer)
        return fut


def test_window_command_bytes():
    """The command a window travels as, one log entry, byte-equal."""
    sent = {}
    for pkg in (PORT, REF):
        node = RecordingNode(pkg.ser.serialize([None] * 4))
        provider = pkg.notary.RaftUniquenessProvider(node)
        assert provider.commit_batch(batch_requests(pkg)) == [None] * 4
        sent[pkg.root] = node.sent
    assert sent["corda_tpu_torch"] == sent["corda_tpu"] == [commands(REF)[3]]


@pytest.mark.parametrize("machine", ["memory", "storage"])
def test_state_machine_outcome_bytes(machine):
    """Each state machine answers the same commands with the same bytes."""
    outs = {}
    for pkg in (PORT, REF):
        RUP = pkg.notary.RaftUniquenessProvider
        storage = None
        if machine == "memory":
            apply, _base = RUP.state_machine()
        else:
            storage = pkg.notary.RaftStorage(":memory:")
            apply = RUP.storage_state_machine(storage)
        outs[pkg.root] = [apply(c, i) for i, c in enumerate(commands(pkg))]
        if storage is not None:
            # replaying an applied index is a no-op on the durable machine
            outs[pkg.root].append(apply(commands(pkg)[1], 1))
            outs[pkg.root].append(sorted(storage.dump_map()))
            storage.close()
    assert outs["corda_tpu_torch"] == outs["corda_tpu"]
    answers = [PORT.ser.deserialize(b) for b in outs["corda_tpu_torch"][:6]]
    assert answers[0] is None and answers[1] is not None and answers[2] is None
    assert [c is None for c in answers[3]] == [True, False, True, True]


def storage_ops(pkg, s, snapshot: bool):
    """One sequence of storage operations; returns what it can be read by."""
    ser = pkg.ser.serialize
    s.save_term_vote(3, "n1")
    for i in range(6):
        s.append(i, 1 + i // 3, ser((list(refs(pkg, f"k{i}")), txh(pkg, f"x{i}"), "alice")))
    s.replace_suffix(4, [(3, b"four"), (3, b"five"), (3, b"six")])
    s.save_term_vote(4, None)
    out = [s.apply_commit(0, list(refs(pkg, "k0", "k1")), txh(pkg, "x0"), "alice"),
           s.apply_commit(1, list(refs(pkg, "k1")), txh(pkg, "x1"), "bob"),
           s.apply_commit(1, list(refs(pkg, "k9")), txh(pkg, "x9"), "late")]  # replay
    out += s.apply_commit_batch(2, batch_requests(pkg))
    out += s.apply_commit_batch(2, batch_requests(pkg))  # replay
    s.compact(2, 1)
    if snapshot:
        s.install_snapshot(s.dump_map()[:3], 9, 4)
    return [conflict_rows(c) for c in out]


@pytest.mark.parametrize("snapshot", [False, True])
def test_storage_same_operations(snapshot):
    got = {}
    for pkg in (PORT, REF):
        s = pkg.notary.RaftStorage(":memory:")
        try:
            answers = storage_ops(pkg, s, snapshot)
            got[pkg.root] = (answers, s.load(), sorted(s.dump_map()), s.committed_txs())
        finally:
            s.close()
    assert got["corda_tpu_torch"] == got["corda_tpu"]
    assert got["corda_tpu"][1]["term"] == 4 and got["corda_tpu"][1]["voted_for"] is None


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)], ids=["ref-db", "port-db"])
def test_opens_other_package_db(tmp_path, writer, reader):
    """A replica file written by one package, opened by the other: the same
    persistent state, and its spent states answered with the same
    conflicts as the writer answers them (on a copy of the file)."""
    path = str(tmp_path / "replica.db")
    s = writer.notary.RaftStorage(path)
    storage_ops(writer, s, snapshot=False)
    s.close()
    shutil.copy(path, str(tmp_path / "copy.db"))
    theirs = writer.notary.RaftStorage(str(tmp_path / "copy.db"))
    ours = reader.notary.RaftStorage(path)
    try:
        assert ours.load() == theirs.load()
        assert sorted(ours.dump_map()) == sorted(theirs.dump_map())
        assert ours.committed_txs() == theirs.committed_txs() == 3
        mine = ours.apply_commit(10, refs(reader, "k0", "bc", "new"),
                                 txh(reader, "mallory-tx"), "mallory")
        want = theirs.apply_commit(10, refs(writer, "k0", "bc", "new"),
                                   txh(writer, "mallory-tx"), "mallory")
        assert conflict_rows(mine) == conflict_rows(want) is not None
        assert reader.ser.serialize(mine) == writer.ser.serialize(want)
        # and the durable state machine resumes from it
        apply = reader.notary.RaftUniquenessProvider.storage_state_machine(ours)
        out = apply(reader.ser.serialize(("batch", [(list(refs(reader, "ba")), txh(reader, "z"),
                                                     "zed")])), 11)
        assert reader.ser.deserialize(out)[0] is not None
    finally:
        ours.close()
        theirs.close()


# ------------------------------------------------------------ behaviour

def cluster_commit_and_conflict(pkg):
    with raft_cluster(pkg, ["r0", "r1", "r2"]) as (_net, providers):
        leader = wait_leader(providers)
        leader.commit(refs(pkg, "a", "b"), txh(pkg, "tx1"), "alice")
        # double spend via a *different* replica (forwarded to the leader)
        follower = next(p for p in providers if p.node.role != "leader")
        with pytest.raises(pkg.notary.NotaryError) as ei:
            follower.commit(refs(pkg, "b"), txh(pkg, "tx2"), "bob")
        wait_for(lambda: all(p.node.last_applied >= 0 for p in providers), 2.0,
                 "every replica to apply")
        return conflict_rows(ei.value.conflict), [digest(replica_rows(p)) for p in providers]


def test_cluster_commit_and_conflict():
    port, ref = cluster_commit_and_conflict(PORT), cluster_commit_and_conflict(REF)
    assert port == ref
    assert port[0] is not None and len(set(port[1])) == 1


def leader_failover(pkg):
    with raft_cluster(pkg, ["f0", "f1", "f2"]) as (net, providers):
        leader = wait_leader(providers)
        leader.commit(refs(pkg, "x"), txh(pkg, "tx1"), "alice")
        # kill the leader: the survivors elect a new one and still serve
        leader.close()
        net.stop_node(leader.node.name)
        providers.remove(leader)
        new_leader = wait_leader(providers)
        with pytest.raises(pkg.notary.NotaryError) as ei:
            new_leader.commit(refs(pkg, "x"), txh(pkg, "tx9"), "mallory")
        new_leader.commit(refs(pkg, "y"), txh(pkg, "tx2"), "bob")
        assert new_leader.node.current_term >= 2
        wait_for(lambda: all(p.node.last_applied >= new_leader.node.commit_index
                             for p in providers), 2.0, "the survivors to apply")
        return conflict_rows(ei.value.conflict), [digest(replica_rows(p)) for p in providers]


def test_leader_failover():
    port, ref = leader_failover(PORT), leader_failover(REF)
    assert port == ref
    assert port[0] is not None and len(set(port[1])) == 1


def full_cluster_restart(pkg, storage_dir):
    names = ["d0", "d1", "d2"]
    net = pkg.messaging.InMemoryMessagingNetwork()
    revived = []
    try:
        with raft_cluster(pkg, names, storage_dir=storage_dir, network=net) as (_n, providers):
            leader = wait_leader(providers)
            leader.commit(refs(pkg, "p", "q"), txh(pkg, "tx1"), "alice")
            leader.commit(refs(pkg, "r"), txh(pkg, "tx2"), "bob")
            # kill EVERY replica (whole-cluster power loss)
            for p in providers:
                p.close()
                net.stop_node(p.node.name)
        net.start_pumping()
        for name in names:
            net._nodes.pop(name, None)
            revived.append(pkg.notary.RaftUniquenessProvider.make_node(
                name, names, net, storage_dir=storage_dir))
        for p in revived:
            p.node.start()
        leader2 = wait_leader(revived)
        with pytest.raises(pkg.notary.NotaryError) as ei:
            leader2.commit(refs(pkg, "q"), txh(pkg, "tx9"), "mallory")
        leader2.commit(refs(pkg, "s"), txh(pkg, "tx3"), "carol")
        wait_for(lambda: len({digest(replica_rows(p)) for p in revived}) == 1, 3.0,
                 "the replicas to converge")
        return conflict_rows(ei.value.conflict), digest(replica_rows(revived[0]))
    finally:
        for p in revived:
            p.close()
        net.stop_pumping()


def test_full_cluster_restart_keeps_consumed_set(tmp_path):
    port = full_cluster_restart(PORT, str(tmp_path / "port"))
    ref = full_cluster_restart(REF, str(tmp_path / "ref"))
    assert port == ref and port[0] is not None


def test_restart_does_not_double_vote(tmp_path):
    """A replica that voted, crashed and restarted refuses to vote for a
    different candidate in the same term (a volatile votedFor would)."""
    from corda_tpu_torch.notary.raft import T_VOTE, T_VOTE_REPLY
    from corda_tpu_torch.serialization import deserialize, serialize

    net = PORT.messaging.InMemoryMessagingNetwork()
    p = PORT.notary.RaftUniquenessProvider.make_node(
        "v0", ["v0", "vA", "vB"], net, storage_dir=str(tmp_path))
    observer = net.create_node("vA")
    replies = []
    observer.add_handler(T_VOTE_REPLY, lambda m, ack=None: replies.append(deserialize(m.payload)))
    observer.send("v0", T_VOTE, serialize({"term": 5, "candidate": "vA",
                                           "last_log_index": -1, "last_log_term": 0}))
    net.run_until_quiescent()
    assert replies and replies[0]["granted"]
    p.close()
    net._nodes.pop("v0", None)
    p2 = PORT.notary.RaftUniquenessProvider.make_node(
        "v0", ["v0", "vA", "vB"], net, storage_dir=str(tmp_path))
    assert p2.node.current_term == 5 and p2.node.voted_for == "vA"
    observer2 = net.create_node("vB")
    replies2 = []
    observer2.add_handler(T_VOTE_REPLY,
                          lambda m, ack=None: replies2.append(deserialize(m.payload)))
    observer2.send("v0", T_VOTE, serialize({"term": 5, "candidate": "vB",
                                            "last_log_index": 10, "last_log_term": 5}))
    net.run_until_quiescent()
    assert replies2 and not replies2[0]["granted"]
    # the reference's file says the same
    ref_storage = REF.notary.RaftStorage(str(tmp_path / "v0.db"))
    try:
        assert ref_storage.load() == p2.node._storage.load()
    finally:
        ref_storage.close()


def compaction_and_snapshot_catchup(pkg, storage_dir):
    names = ["c0", "c1", "c2"]
    with raft_cluster(pkg, names, storage_dir=storage_dir, compact_every=4) as (net, providers):
        leader = wait_leader(providers)
        sleeper = next(p for p in providers if p is not leader)
        net.stop_node(sleeper.node.name)
        sleeper.close()
        providers.remove(sleeper)
        for i in range(12):  # well past compact_every
            leader.commit(refs(pkg, f"k{i}"), txh(pkg, f"tx{i}"), "alice")
        assert leader.node.log.base > 0  # the leader's log compacted
        net._nodes.pop(sleeper.node.name, None)
        revived = pkg.notary.RaftUniquenessProvider.make_node(
            sleeper.node.name, names, net, storage_dir=storage_dir, compact_every=4)
        providers.append(revived)
        revived.node.start()
        wait_for(lambda: revived.node.last_applied >= 11, 5.0, "the snapshot catch-up")
        assert revived.node._storage.committed_txs() == 12
        return [digest(replica_rows(p)) for p in sorted(providers, key=lambda p: p.node.name)]


def test_compaction_and_snapshot_catchup(tmp_path):
    port = compaction_and_snapshot_catchup(PORT, str(tmp_path / "port"))
    ref = compaction_and_snapshot_catchup(REF, str(tmp_path / "ref"))
    assert port == ref and len(set(port)) == 1


def raft_batch_single_log_entry(pkg):
    with raft_cluster(pkg, ["rb0", "rb1", "rb2"]) as (_net, providers):
        leader = wait_leader(providers)
        results = leader.commit_batch([
            (refs(pkg, "ba", "bb"), txh(pkg, "t1"), "alice"),
            (refs(pkg, "bb"), txh(pkg, "t2"), "bob"),      # intra-batch spend
            (refs(pkg, "bc"), txh(pkg, "t3"), "carol"),
        ])
        assert leader.node.log.last_index() == 0  # the WHOLE batch: one entry
        follower = next(p for p in providers if p.node.role != "leader")
        res2 = follower.commit_batch([
            (refs(pkg, "bc"), txh(pkg, "t4"), "dan"),      # cross-batch spend
            (refs(pkg, "bd"), txh(pkg, "t5"), "erin"),
        ])
        assert leader.node.log.last_index() == 1
        wait_for(lambda: all(p.node.last_applied >= 1 for p in providers), 3.0,
                 "every replica to apply")
        return ([conflict_rows(c) for c in results + res2],
                [digest(replica_rows(p)) for p in providers])


def test_raft_batch_single_log_entry():
    port, ref = raft_batch_single_log_entry(PORT), raft_batch_single_log_entry(REF)
    assert port == ref
    assert [c is None for c in port[0]] == [True, False, True, False, True]
    assert len(set(port[1])) == 1


def raft_durable_batch_survives_restart(pkg, storage_dir):
    names = ["db0", "db1", "db2"]
    with raft_cluster(pkg, names, storage_dir=storage_dir) as (_net, providers):
        leader = wait_leader(providers)
        first = leader.commit_batch([(refs(pkg, "da"), txh(pkg, "t1"), "alice"),
                                     (refs(pkg, "db"), txh(pkg, "t2"), "bob")])
    with raft_cluster(pkg, names, storage_dir=storage_dir) as (_net, providers):
        leader2 = wait_leader(providers)
        res = leader2.commit_batch([(refs(pkg, "da"), txh(pkg, "t9"), "mallory"),
                                    (refs(pkg, "dc"), txh(pkg, "t3"), "carol")])
        wait_for(lambda: all(p.node.last_applied >= leader2.node.commit_index
                             for p in providers), 3.0, "every replica to apply")
        return ([conflict_rows(c) for c in first + res],
                [digest(replica_rows(p)) for p in providers])


def test_raft_durable_batch_survives_cluster_restart(tmp_path):
    port = raft_durable_batch_survives_restart(PORT, str(tmp_path / "port"))
    ref = raft_durable_batch_survives_restart(REF, str(tmp_path / "ref"))
    assert port == ref
    assert [c is None for c in port[0]] == [True, True, False, True]


# ------------------------------------------------------------- chaos

def retry_idempotent_under_duplicate_delivery(pkg):
    fi = pkg.faultinject
    inj = fi.FaultInjector(fi.FaultPlan(seed=21, duplicate_p=0.3))
    net = pkg.messaging.InMemoryMessagingNetwork(fault_injector=inj)
    with raft_cluster(pkg, ["r0", "r1", "r2"], network=net) as (_net, providers):
        lead = providers[0]
        rs = [fake_ref(pkg, 1), fake_ref(pkg, 2)]
        lead.commit(rs, fake_tx_id(pkg, 1), "caller")
        lead.commit(rs, fake_tx_id(pkg, 1), "caller")          # original success
        providers[1].commit(rs, fake_tx_id(pkg, 1), "caller")
        with pytest.raises(pkg.notary.NotaryError) as ei:
            lead.commit(rs, fake_tx_id(pkg, 2), "caller")
        return conflict_rows(ei.value.conflict)


def test_retry_idempotent_under_duplicate_delivery():
    port = retry_idempotent_under_duplicate_delivery(PORT)
    assert port == retry_idempotent_under_duplicate_delivery(REF) is not None


def replica_crash_restart(pkg, storage):
    """Drops, delays and one replica crashed mid-stream through a
    ``ChaosOrchestrator`` and rebuilt from its SQLite file: every commit
    lands once and the three durable maps end identical."""
    fi = pkg.faultinject
    plan = fi.FaultPlan(seed=22, drop_p=0.05, delay_p=0.1,
                        crashes=(fi.CrashEvent(at_round=40, node="c1", down_rounds=400),))
    inj = fi.FaultInjector(plan)
    net = pkg.messaging.InMemoryMessagingNetwork(fault_injector=inj)
    orch = fi.ChaosOrchestrator(net, inj)
    names = ["c0", "c1", "c2"]
    RUP = pkg.notary.RaftUniquenessProvider
    providers = {n: RUP.make_node(n, names, net, storage) for n in names}
    for p in providers.values():
        p.node.start()

    def stop_c1():
        providers["c1"].close()
        net.stop_node("c1")

    def restart_c1():
        endpoint = net.restart_node("c1")
        providers["c1"] = RUP.make_node_on_endpoint(
            "c1", names, endpoint, storage_path=f"{storage}/c1.db",
            election_timeout_s=(0.15, 0.3), heartbeat_s=0.05)
        providers["c1"].node.start()

    orch.register("c1", stop_c1, restart_c1)
    net.start_pumping()
    try:
        for i in range(12):
            deadline = time.monotonic() + 30
            while True:
                try:
                    providers["c0"].commit([fake_ref(pkg, i)], fake_tx_id(pkg, i), "soak")
                    break
                except (pkg.notary.NotaryError, TimeoutError, FutureTimeoutError) as e:
                    if "already consumed" in str(e):
                        raise
                    assert time.monotonic() < deadline, e
                    time.sleep(0.1)
            time.sleep(0.05)
        wait_for(lambda: "c1" not in orch.down, 60.0, "c1's restart")
        events = [e.kind for e in inj.trace if e.kind in ("crash", "restart")]
        assert events == ["crash", "restart"]

        def converged():
            rows = [replica_rows(providers[n]) for n in names]
            return len(rows[0]) == 12 and rows[0] == rows[1] == rows[2]

        wait_for(converged, 60.0, "identical durable maps")
        return replica_rows(providers["c0"])
    finally:
        for p in providers.values():
            p.close()
        net.stop_pumping()


def test_replica_crash_restart_converges(tmp_path):
    """The port's chaos run ends with the consumed set the reference's
    durable state machine holds after the same twelve commits."""
    got = replica_crash_restart(PORT, str(tmp_path))
    want = REF.notary.RaftStorage(":memory:")
    try:
        for i in range(12):
            assert want.apply_commit(i, [fake_ref(REF, i)], fake_tx_id(REF, i), "soak") is None
        assert got == sorted(want.dump_map())
    finally:
        want.close()


def test_election_storm_backs_off():
    """A replica cut off from every peer slows its candidacy instead of
    burning terms at the base cadence."""
    fi = PORT.faultinject
    net = PORT.messaging.InMemoryMessagingNetwork(
        fault_injector=fi.FaultInjector(fi.FaultPlan(seed=23, drop_p=1.0)))
    with raft_cluster(PORT, ["e0", "e1", "e2"], network=net) as (_net, providers):
        node = providers[0].node
        wait_for(lambda: node._elections_since_leader >= 3, 10.0, "three elections")
        assert 1.0 < node._election_backoff() <= node.ELECTION_BACKOFF_CAP
