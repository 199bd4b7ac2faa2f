"""The BFT notary cluster with quorum certificates, the port's against the
reference's.

Bytes (tolerance zero): a ``BFTReplica`` built with the same ed25519
keypair and BLS share key answers the same commands with the same reply
bytes (ed25519 signature and BLS share included), and the client's
``QuorumCertificate.encode()`` is the same for the same signer set.

Behaviour: the reference's own BFT tests (``tests/test_notary.py``'s
``TestBFT``, ``TestBFTViewChange``, the BFT half of
``TestReplicatedBatchCommit``; ``tests/test_batchverify.py``'s
``TestBFTQuorumRounds``), on the port, with the deterministic outcomes
(conflict details, the consumed set of every replica) equal to the
reference's run. The reference's ``CORDA_TPU_BLS_QC=0`` is the port's
``make_cluster(..., bls_qc=False)``.

Every replica, pump and timer is stopped in ``finally``
(``no_cluster_thread_left``). The clusters keep the default replica
names, so each package proves the BLS keys' possession once a process."""

import contextlib
import gc
import time

import pytest

from test_torch_raft import (  # noqa: F401  (fixtures)
    PORT,
    REF,
    conflict_rows,
    no_cluster_thread_left,
    one_torch_thread,
    refs,
    txh,
    wait_for,
)

NAMES = [f"bft-replica-{i}" for i in range(4)]


class Capture:
    """A messaging endpoint that records every send and delivers nothing."""

    def __init__(self):
        self.sent = []

    def add_handler(self, _topic, _fn):
        pass

    def send(self, recipient, topic, payload, *, msg_id=None):
        self.sent.append((recipient, topic, payload))
        return ""


def bls_keypair(pkg, name):
    pk, sk = pkg.bls.derive_keypair_from_entropy(name.encode())
    if not pkg.bls.is_registered(pk):
        pkg.bls.register_pop(pk, pkg.bls.prove_possession(sk))
    return pk, sk


@contextlib.contextmanager
def bft_cluster(pkg, **kw):
    """Four co-located replicas on a pumping network and their client
    factory; the replicas and the pump are stopped on the way out."""
    net = pkg.messaging.InMemoryMessagingNetwork()
    net.start_pumping()
    replicas = []
    try:
        made, make_client = pkg.notary.BFTUniquenessProvider.make_cluster(4, net, **kw)
        replicas.extend(made)
        yield net, replicas, make_client
    finally:
        for r in replicas:
            r.stop()
        net.stop_pumping()


def base_digests(replicas, n_exec):
    wait_for(lambda: all(r._next_exec >= n_exec for r in replicas), 5.0,
             f"{len(replicas)} replicas to execute {n_exec} slots")
    return [r.base.consumed_digest() for r in replicas]


# ----------------------------------------------------------------- bytes

def replica_replies(pkg, with_bls: bool) -> list:
    """The reply payloads of one replica executing a single command, a
    batch with an intra-batch spend and a batch that conflicts with both."""
    ser = pkg.ser.serialize
    kp = pkg.crypto.derive_keypair_from_entropy(4, b"bft-bytes-replica")
    msgr = Capture()
    replica = pkg.bft.BFTReplica(NAMES[0], NAMES, msgr, kp,
                                 bls_keypair=bls_keypair(pkg, NAMES[0]) if with_bls else None)
    try:
        cmds = [
            ser((list(refs(pkg, "a", "b")), txh(pkg, "s1"), "alice")),
            ser(("batch", [(list(refs(pkg, "c", "d")), txh(pkg, "t1"), "carol"),
                           (list(refs(pkg, "d")), txh(pkg, "t2"), "dan")])),
            ser(("batch", [(list(refs(pkg, "b")), txh(pkg, "t3"), "mallory"),
                           (list(refs(pkg, "e")), txh(pkg, "t4"), "erin")])),
            ser((list(refs(pkg, "c")), txh(pkg, "s9"), "mallory")),
        ]
        for seq, cmd in enumerate(cmds):
            replica._execute(seq, pkg.bft._digest(cmd), cmd, "client")
    finally:
        replica.stop()
    assert [(to, topic) for to, topic, _p in msgr.sent] == [("client", pkg.bft.T_REPLY)] * 4
    return [payload for _to, _topic, payload in msgr.sent]


@pytest.mark.parametrize("with_bls", [True, False], ids=["bls", "ed25519-only"])
def test_reply_and_share_bytes(with_bls):
    port = replica_replies(PORT, with_bls)
    assert port == replica_replies(REF, with_bls)
    pk = bls_keypair(PORT, NAMES[0])[0]
    for payload in port:
        rep = PORT.ser.deserialize(payload)
        assert PORT.crypto.is_valid(rep["key"], rep["sig"], rep["outcome"])
        assert ("bls_sig" in rep) == with_bls
        if with_bls:
            assert rep["bls_v"] == 2
            assert PORT.bls.verify(pk, rep["outcome"], rep["bls_sig"])
    outcomes = [PORT.ser.deserialize(PORT.ser.deserialize(p)["outcome"]) for p in port]
    assert outcomes[0]["conflict"] is None and outcomes[3]["conflict"] is not None
    assert [c is None for c in outcomes[1]["conflicts"]] == [True, False]
    assert [c is None for c in outcomes[2]["conflicts"]] == [False, True]


@pytest.mark.parametrize("signers", [(1, 2), (0, 2, 3)])
def test_quorum_certificate_bytes(signers):
    """The client's certificate over f+1 (or more) shares, byte-equal."""
    certs = {}
    for pkg in (PORT, REF):
        keys = {name: bls_keypair(pkg, name) for name in NAMES}
        client = pkg.bft.BFTClusterClient(
            "qc-bytes-client", Capture(), NAMES, {},
            bls_keys={name: pk for name, (pk, _sk) in keys.items()})
        outcome = b"qc-bytes-outcome"
        shares = {NAMES[i]: pkg.bls.sign(keys[NAMES[i]][1], outcome) for i in signers}
        cert = client._try_build_qc(outcome, shares)
        assert cert is not None and cert.verify(client.bls_member_keys)
        assert cert.bitmap == sum(1 << i for i in signers) and cert.n == 4
        certs[pkg.root] = cert.encode()
    assert certs["corda_tpu_torch"] == certs["corda_tpu"]
    decoded = PORT.qc.QuorumCertificate.decode(certs["corda_tpu"])
    assert decoded.encode() == certs["corda_tpu"]


# ------------------------------------------------------------ behaviour

def cluster_commit_conflict_and_crash(pkg):
    with bft_cluster(pkg) as (net, replicas, make_client):
        provider = make_client("client-1")
        provider.commit(refs(pkg, "a", "b"), txh(pkg, "tx1"), "alice")
        with pytest.raises(pkg.notary.NotaryError) as ei:
            provider.commit(refs(pkg, "b"), txh(pkg, "tx2"), "bob")
        # crash one non-primary replica (f = 1): the cluster keeps working
        net.stop_node(replicas[3].name)
        provider.commit(refs(pkg, "c"), txh(pkg, "tx3"), "carol")
        return conflict_rows(ei.value.conflict), base_digests(replicas[:3], 3)


def test_cluster_commit_conflict_and_crash():
    port = cluster_commit_conflict_and_crash(PORT)
    assert port == cluster_commit_conflict_and_crash(REF)
    assert port[0] is not None and len(set(port[1])) == 1


def test_pending_state_cleanup_is_lifecycle_tied():
    """The client's per-digest state goes when the quorum resolves the
    future, collected or not, and with a pending abandoned before any
    quorum."""
    with bft_cluster(PORT) as (_net, _replicas, make_client):
        provider = make_client("cleanup-client")
        client = provider.client
        provider.commit(refs(PORT, "p"), txh(PORT, "txP"), "alice")
        assert not client._futures and not client._replies
        pending = client._submit_command_async(
            PORT.ser.serialize((refs(PORT, "q"), txh(PORT, "txQ"), "bob")))
        wait_for(lambda: not client._futures, 10.0, "the quorum to pop the future")
        assert not client._replies
        del pending
    lonely = PORT.bft.BFTClusterClient("lonely", Capture(), NAMES, {})
    abandoned = lonely._submit_command_async(b"never-quorate")
    assert len(lonely._futures) == 1
    del abandoned
    gc.collect()
    assert not lonely._futures and not lonely._replies


def test_equivocating_primary_cannot_split_quorum():
    """Commit votes for a digest that was never pre-prepared do not count
    toward the pre-prepared digest's quorum."""
    net = PORT.messaging.InMemoryMessagingNetwork()
    replicas, _make_client = PORT.notary.BFTUniquenessProvider.make_cluster(4, net)
    try:
        r0 = replicas[0]
        command_a = PORT.ser.serialize((refs(PORT, "a"), txh(PORT, "txA"), "alice"))
        command_b = PORT.ser.serialize((refs(PORT, "a"), txh(PORT, "txB"), "bob"))
        da, db = PORT.bft._digest(command_a), PORT.bft._digest(command_b)
        with r0._lock:
            r0._preprepared[(0, 0)] = da
            r0._commands[da] = command_a
            r0._prepares[(0, 0, da)].add(r0.name)
        for sender in NAMES[1:]:
            r0._commits[(0, 0, db)].add(sender)
        r0._check_committed(0, 0)
        assert r0._next_exec == 0
    finally:
        for r in replicas:
            r.stop()


def primary_kill_then_progress(pkg):
    with bft_cluster(pkg, view_timeout_s=0.3) as (net, replicas, make_client):
        provider = make_client("vc-client")
        provider.commit(refs(pkg, "va"), txh(pkg, "tx1"), "alice")
        net.stop_node(replicas[0].name)
        replicas[0].stop()
        provider.commit(refs(pkg, "vb"), txh(pkg, "tx2"), "bob")
        survivors = replicas[1:]
        assert all(r.view >= 1 for r in survivors)
        assert any(r.is_primary for r in survivors)
        out = []
        for tag, tx in (("va", "tx9"), ("vb", "tx8")):
            with pytest.raises(pkg.notary.NotaryError) as ei:
                provider.commit(refs(pkg, tag), txh(pkg, tx), "mallory")
            out.append(conflict_rows(ei.value.conflict))
        return out, base_digests(survivors, max(r._next_exec for r in survivors))


def test_primary_kill_then_progress():
    port = primary_kill_then_progress(PORT)
    assert port == primary_kill_then_progress(REF)
    assert None not in port[0] and len(set(port[1])) == 1


def test_single_faulty_replica_cannot_force_view_change():
    """One replica demanding a view change does not move the others off
    a live primary (the f+1 join rule)."""
    from corda_tpu_torch.notary.bft import T_VIEWCHANGE

    with bft_cluster(PORT, view_timeout_s=30.0) as (_net, replicas, make_client):
        provider = make_client("fj-client")
        provider.commit(refs(PORT, "fa"), txh(PORT, "tx1"), "alice")
        accuser = replicas[3]
        body = PORT.ser.serialize({"view": 1, "sender": accuser.name,
                                   "last_exec": 0, "certs": []})
        sig = PORT.crypto.sign(accuser._keypair.private, body)
        accuser._multicast(T_VIEWCHANGE, {"body": body, "sig": sig})
        time.sleep(0.3)
        assert all(r.view == 0 for r in replicas[:3])
        provider.commit(refs(PORT, "fb"), txh(PORT, "tx2"), "bob")


def bft_batch_one_total_order_slot(pkg, **kw):
    with bft_cluster(pkg, **kw) as (_net, replicas, make_client):
        provider = make_client("bb-client")
        results = provider.commit_batch([
            (refs(pkg, "xa", "xb"), txh(pkg, "t1"), "alice"),
            (refs(pkg, "xb"), txh(pkg, "t2"), "bob"),
            (refs(pkg, "xc"), txh(pkg, "t3"), "carol"),
        ])
        qc = provider.take_qc()
        wait_for(lambda: all(r._next_exec == 1 for r in replicas), 5.0, "one slot")
        p2 = make_client("bb-client2")
        res2 = p2.commit_batch([(refs(pkg, "xc"), txh(pkg, "t4"), "dan")])
        return ([conflict_rows(c) for c in results + res2], base_digests(replicas, 2),
                None if qc is None else qc.signer_count())


def test_bft_batch_one_total_order_slot():
    port = bft_batch_one_total_order_slot(PORT)
    ref = bft_batch_one_total_order_slot(REF)
    assert port[:2] == ref[:2]
    assert [c is None for c in port[0]] == [True, False, True, False]
    assert len(set(port[1])) == 1
    assert port[2] >= 2 and ref[2] >= 2


def test_bls_qc_off_matches_reference_switch(monkeypatch):
    """The port's ``bls_qc=False`` against the reference's
    ``CORDA_TPU_BLS_QC=0``: the same outcomes, no certificate, replies
    without BLS shares."""
    port = bft_batch_one_total_order_slot(PORT, bls_qc=False)
    monkeypatch.setenv("CORDA_TPU_BLS_QC", "0")
    ref = bft_batch_one_total_order_slot(REF)
    assert port == ref and port[2] is None


# ------------------------------------------------- quorum certificates

def test_round_carries_one_aggregate_qc():
    with bft_cluster(PORT) as (_net, _replicas, make_client):
        provider = make_client("qc-client")
        provider.commit(refs(PORT, "qa", "qb"), txh(PORT, "qc-tx1"), "alice")
        qc = provider.take_qc()
        assert isinstance(qc, PORT.qc.QuorumCertificate)
        assert qc.signer_count() >= 2 and qc.n == 4
        assert qc.verify(provider.bls_member_keys)
        assert provider.take_qc() is None  # take-once
        assert qc.encode().count(qc.agg_sig) == 1


def test_injected_aggregate_fault_degrades_to_legacy():
    fi = PORT.faultinject
    m = PORT.monitoring.node_metrics()
    base_fb = m.counter("notary.qc.fallback").count
    with bft_cluster(PORT) as (_net, _replicas, make_client):
        provider = make_client("qcf-client")
        fi.install(fi.FaultInjector(fi.FaultPlan(seed=7, fail_sites=(("notary.aggregate", 1),))))
        try:
            provider.commit(refs(PORT, "fa"), txh(PORT, "qcf-tx1"), "alice")
        finally:
            fi.clear()
        # the round committed on the ed25519 attestations, no certificate
        assert provider.take_qc() is None
        assert m.counter("notary.qc.fallback").count == base_fb + 1
        provider.commit(refs(PORT, "fb"), txh(PORT, "qcf-tx2"), "bob")
        assert provider.take_qc() is not None
