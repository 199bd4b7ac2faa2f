"""The durability tier (``durability/``) and its owners, the port's against
the reference's, in the shapes of the reference's ``tests/test_durability.py``:

- the write-ahead log's and snapshots' edge cases, each run on both
  packages (empty log, torn tail, CRC-corrupt interior, a defect in an
  older segment, a zero run in a torn record, snapshots with no tail, a
  crash between the snapshot's rename and the reclaim, a crash before the
  rename, the covered LSN, a compacted log with no loadable snapshot,
  double replay, the fsync batch);
- byte compatibility: equal appends give equal segment and snapshot bytes,
  and a log (with a snapshot) written by either package replays in the
  other, a durable notary's consumed set and attestations included;
- the durable notary's recovery and the kill storm over the reference's
  ``KILL_SCHEDULES``, whose acked outcomes and consumed-set digest equal
  the reference's; the batched notary answering a retried acknowledged
  request with its original signature bytes after a crash mid-stream;
- the vault's journal (pages equal to the reference's after a restart),
  the checkpoint resume from disk, the ``durability`` monitoring section,
  off by default (a fresh subprocess), and the chaos soak (``slow``, as in
  the reference; without the reference's lock-order sanitizer, which
  comes with the contention layer)."""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import pytest
import torch

import corda_tpu.durability as ref_dur
import corda_tpu.faultinject as ref_fi
import corda_tpu.notary as ref_notary
import corda_tpu_torch.durability as port_dur
import corda_tpu_torch.faultinject as port_fi
import corda_tpu_torch.notary as port_notary
from corda_tpu.crypto import SecureHash as RefSecureHash
from corda_tpu.crypto import derive_keypair_from_entropy as ref_derive
from corda_tpu.ledger import CordaX500Name as RefName
from corda_tpu.ledger import Party as RefParty
from corda_tpu.ledger import StateRef as RefStateRef
from corda_tpu.serialization import serialize as ref_serialize
from corda_tpu_torch.crypto import SecureHash, derive_keypair_from_entropy
from corda_tpu_torch.flows import (
    FlowException,
    FlowLogic,
    InitiatedBy,
    StateMachineManager,
    WalCheckpointStorage,
)
from corda_tpu_torch.ledger import CordaX500Name, Party, StateRef
from corda_tpu_torch.serialization import deserialize, register_custom
from test_durability import KILL_SCHEDULES
from test_durability import _DurCoin as RefDurCoin
from test_durability import _DurCoinCmd as RefDurCoinCmd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKG = {
    "ref": SimpleNamespace(
        dur=ref_dur, fi=ref_fi, notary=ref_notary, SecureHash=RefSecureHash,
        StateRef=RefStateRef, Party=RefParty, Name=RefName, derive=ref_derive),
    "port": SimpleNamespace(
        dur=port_dur, fi=port_fi, notary=port_notary, SecureHash=SecureHash,
        StateRef=StateRef, Party=Party, Name=CordaX500Name,
        derive=derive_keypair_from_entropy),
}


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    p = PKG[request.param]
    p.fi.clear()
    yield p
    p.fi.clear()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tx(p, i: int):
    return p.SecureHash(hashlib.sha256(b"dur-tx-%d" % i).digest())


def _ref(p, i: int):
    return p.StateRef(p.SecureHash(hashlib.sha256(b"dur-ref-%d" % i).digest()), 0)


def _crash_plan(p, *sites, seed=7):
    return p.fi.install(p.fi.FaultInjector(p.fi.FaultPlan(seed=seed, crash_sites=tuple(sites))))


# ------------------------------------------------------------- WAL edges

def test_empty_log_recovers_to_nothing_and_accepts_appends(tmp_path, pkg):
    store = pkg.dur.DurableStore(str(tmp_path), name="t")
    seen = []
    rep = store.recover(seen.append)
    assert (rep.replayed, rep.torn, rep.snapshot_lsn, seen) == (0, 0, -1, [])
    assert store.append({"a": 1}) == 0
    store.flush()
    store.close()


def test_single_torn_record_discarded_rest_kept(tmp_path, pkg):
    store = pkg.dur.DurableStore(str(tmp_path), name="t")
    for i in range(5):
        store.append({"i": i})
    store.flush()
    store.close()
    assert pkg.fi.truncate_wal_tail(str(tmp_path / "wal"), 3) is not None
    store2 = pkg.dur.DurableStore(str(tmp_path), name="t")
    seen = []
    rep = store2.recover(lambda r: seen.append(r["i"]))
    assert seen == [0, 1, 2, 3] and rep.torn == 1
    store2.append({"i": 99})
    store2.flush()
    store2.close()
    store3 = pkg.dur.DurableStore(str(tmp_path), name="t")
    seen3 = []
    store3.recover(lambda r: seen3.append(r["i"]))
    assert seen3 == [0, 1, 2, 3, 99]
    store3.close()


def test_crc_corrupt_interior_record_is_hard_error(tmp_path, pkg):
    wal = pkg.dur.WriteAheadLog(str(tmp_path))
    for i in range(5):
        wal.append(b"payload-%d" % i)
    wal.flush()
    wal.close()
    seg = tmp_path / sorted(os.listdir(tmp_path))[0]
    data = bytearray(seg.read_bytes())
    data[16 + 8 + len(b"payload-0") + 8 + 2] ^= 0xFF  # the second record
    seg.write_bytes(bytes(data))
    with pytest.raises(pkg.dur.WalCorruptionError, match="interior"):
        pkg.dur.WriteAheadLog(str(tmp_path))


def test_defect_in_non_final_segment_is_hard_error(tmp_path, pkg):
    wal = pkg.dur.WriteAheadLog(str(tmp_path), segment_max_bytes=64)
    for i in range(8):
        wal.append(b"payload-%d" % i)
    wal.flush()
    wal.close()
    segs = sorted(os.listdir(tmp_path))
    assert len(segs) > 2
    first = tmp_path / segs[0]
    data = bytearray(first.read_bytes())
    data[-2] ^= 0xFF
    first.write_bytes(bytes(data))
    with pytest.raises(pkg.dur.WalCorruptionError, match="non-final"):
        pkg.dur.WriteAheadLog(str(tmp_path))


def test_torn_record_with_zero_run_is_still_torn(tmp_path, pkg):
    wal = pkg.dur.WriteAheadLog(str(tmp_path))
    wal.append(b"keep-me")
    wal.append(b"head" + b"\x00" * 16 + b"tail")
    wal.flush()
    wal.close()
    assert pkg.fi.truncate_wal_tail(str(tmp_path), 8) is not None
    wal2 = pkg.dur.WriteAheadLog(str(tmp_path))
    assert [p for _, p in wal2.recovered_records()] == [b"keep-me"]
    assert wal2.torn_discarded == 1
    wal2.close()


def test_empty_payload_rejected(tmp_path, pkg):
    wal = pkg.dur.WriteAheadLog(str(tmp_path))
    with pytest.raises(ValueError, match="non-empty"):
        wal.append(b"")
    wal.close()


def test_corrupt_final_record_of_final_segment_is_torn(tmp_path, pkg):
    wal = pkg.dur.WriteAheadLog(str(tmp_path))
    wal.append(b"first")
    wal.append(b"second")
    wal.flush()
    wal.close()
    seg = tmp_path / sorted(os.listdir(tmp_path))[0]
    data = bytearray(seg.read_bytes())
    data[-1] ^= 0xFF
    seg.write_bytes(bytes(data))
    wal2 = pkg.dur.WriteAheadLog(str(tmp_path))
    assert [p for _, p in wal2.recovered_records()] == [b"first"]
    assert wal2.torn_discarded == 1
    wal2.close()


def test_snapshot_with_zero_wal_tail(tmp_path, pkg):
    store = pkg.dur.DurableStore(str(tmp_path), name="t")
    for i in range(6):
        store.append({"i": i})
    store.snapshot({"upto": 5})
    store.close()
    store2 = pkg.dur.DurableStore(str(tmp_path), name="t")
    seen, base = [], []
    rep = store2.recover(seen.append, base.append)
    assert base == [{"upto": 5}] and seen == []
    assert rep.replayed == 0 and rep.snapshot_lsn == 5
    store2.close()


def test_crash_between_snapshot_rename_and_reclaim(tmp_path, pkg):
    store = pkg.dur.DurableStore(str(tmp_path), name="t", segment_max_bytes=64)
    for i in range(10):
        store.append({"i": i})
    store.flush()
    segs_before = len(os.listdir(tmp_path / "wal"))
    assert segs_before > 2
    _crash_plan(pkg, ("durability.compact", 1))
    with pytest.raises(pkg.fi.InjectedCrash):
        store.snapshot({"n": 10})
    pkg.fi.clear()
    assert len(os.listdir(tmp_path / "snap")) == 1
    assert len(os.listdir(tmp_path / "wal")) == segs_before
    owner: dict = {}
    store2 = pkg.dur.DurableStore(str(tmp_path), name="t", segment_max_bytes=64)
    rep = store2.recover(lambda r: owner.setdefault(r["i"], r["i"]),
                         lambda snap: owner.update({k: k for k in range(snap["n"])}))
    assert sorted(owner) == list(range(10)) and rep.snapshot_lsn == 9
    store2.snapshot({"n": 10})
    assert len(os.listdir(tmp_path / "wal")) < segs_before
    store2.close()


def test_crash_mid_snapshot_rename_keeps_old_base(tmp_path, pkg):
    store = pkg.dur.DurableStore(str(tmp_path), name="t")
    for i in range(4):
        store.append({"i": i})
    store.snapshot({"gen": 1})
    for i in range(4, 8):
        store.append({"i": i})
    _crash_plan(pkg, ("durability.snapshot.rename", 1))
    with pytest.raises(pkg.fi.InjectedCrash):
        store.snapshot({"gen": 2})
    pkg.fi.clear()
    snaps = os.listdir(tmp_path / "snap")
    assert sum(1 for n in snaps if n.endswith(".snap")) == 1
    assert any(n.endswith(".tmp") for n in snaps)
    store2 = pkg.dur.DurableStore(str(tmp_path), name="t")
    seen, base = [], []
    rep = store2.recover(lambda r: seen.append(r["i"]), lambda s: base.append(s["gen"]))
    assert base == [1] and seen == [4, 5, 6, 7] and rep.torn == 0
    store2.snapshot({"gen": 3})
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path / "snap"))
    store2.close()


def test_snapshot_covered_lsn_binds_to_captured_state(tmp_path, pkg):
    store = pkg.dur.DurableStore(str(tmp_path), name="t")
    lsn_a = store.append({"i": "A"})
    store.flush()
    store.append({"i": "B"})
    store.flush()
    store.snapshot({"have": ["A"]}, covered_lsn=lsn_a)
    store.close()
    store2 = pkg.dur.DurableStore(str(tmp_path), name="t")
    seen, base = [], []
    rep = store2.recover(lambda r: seen.append(r["i"]), base.append)
    assert base == [{"have": ["A"]}] and seen == ["B"] and rep.snapshot_lsn == lsn_a
    store2.close()


def test_compacted_wal_without_loadable_snapshot_refuses(tmp_path, pkg):
    store = pkg.dur.DurableStore(str(tmp_path), name="t", segment_max_bytes=64)
    for i in range(10):
        store.append({"i": i})
    store.snapshot({"n": 10})
    store.append({"i": 10})
    store.flush()
    store.close()
    for name in os.listdir(tmp_path / "snap"):
        os.unlink(tmp_path / "snap" / name)
    store2 = pkg.dur.DurableStore(str(tmp_path), name="t", segment_max_bytes=64)
    with pytest.raises(pkg.dur.WalCorruptionError, match="compacted"):
        store2.recover(lambda r: None)
    store2.close()


def test_double_replay_is_idempotent(tmp_path, pkg):
    store = pkg.dur.DurableStore(str(tmp_path), name="t")
    for i in range(6):
        store.append({"i": i})
    store.flush()
    store.close()

    def build():
        st = pkg.dur.DurableStore(str(tmp_path), name="t")
        owner: dict = {}
        st.recover(lambda r: owner.setdefault(r["i"], r["i"]))
        st.close()
        return owner

    assert build() == build() == {i: i for i in range(6)}


def test_fsync_batch_autoflushes(tmp_path, pkg):
    wal = pkg.dur.WriteAheadLog(str(tmp_path), fsync_batch=4)
    for i in range(4):
        wal.append(b"r%d" % i)
    assert wal.durable_lsn == 3
    wal.close()


def test_fsync_batch_switch_autoflushes(tmp_path, pkg, monkeypatch):
    """``CORDA_TPU_FSYNC_BATCH`` sets the batch of a log given none."""
    monkeypatch.setenv("CORDA_TPU_FSYNC_BATCH", "3")
    wal = pkg.dur.WriteAheadLog(str(tmp_path))
    for i in range(5):
        wal.append(b"r%d" % i)
    assert wal.durable_lsn == 2
    wal.append(b"r5")
    assert wal.durable_lsn == 5
    wal.close()


# ------------------------------------------------------ byte compatibility

def _dir_bytes(path) -> dict:
    return {name: (path / name).read_bytes() for name in sorted(os.listdir(path))}


def _write_log(p, path, n=12):
    """Records of both owner shapes and a snapshot in the middle, with
    segments small enough to roll."""
    store = p.dur.DurableStore(str(path), name="t", segment_max_bytes=96)
    for i in range(n):
        store.append({"k": "commit", "tx": _tx(p, i), "refs": [_ref(p, i)], "caller": "c"})
        if i == n // 2:
            store.snapshot({"map": [[b"key-%d" % i, i]], "upto": i})
    store.flush()
    store.close()


def test_equal_appends_give_equal_bytes(tmp_path):
    _write_log(PKG["ref"], tmp_path / "ref")
    _write_log(PKG["port"], tmp_path / "port")
    for sub in ("wal", "snap"):
        ref_files = _dir_bytes(tmp_path / "ref" / sub)
        assert ref_files and _dir_bytes(tmp_path / "port" / sub) == ref_files


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_log_replays_in_the_other_package(tmp_path, writer, reader):
    w, r = PKG[writer], PKG[reader]
    _write_log(w, tmp_path)
    recovered, base = [], []
    store = r.dur.DurableStore(str(tmp_path), name="t", segment_max_bytes=96)
    rep = store.recover(recovered.append, base.append)
    store.close()
    assert base == [{"map": [[b"key-6", 6]], "upto": 6}]
    assert rep.snapshot_lsn == 6 and rep.torn == 0
    assert recovered == [{"k": "commit", "tx": _tx(r, i), "refs": [_ref(r, i)], "caller": "c"}
                         for i in range(7, 12)]


def _notary_party(p):
    kp = p.derive(4, hashlib.sha256(b"DurNotary").digest())
    return p.Party(p.Name("DurNotary", "Zurich", "CH"), kp.public), kp


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_durable_notary_recovers_across_packages(tmp_path, writer, reader):
    """A durable notary's log (commits, attestations, a snapshot) written
    by one package: the other recovers the same consumed set and the
    original signature bytes."""
    w, r = PKG[writer], PKG[reader]
    party, kp = _notary_party(w)
    prov = w.notary.DurableUniquenessProvider(w.dur.DurableStore(str(tmp_path), name="n"))
    svc = w.notary.NotaryService(party, kp, prov)
    sigs = {}
    for i in range(6):
        prov.commit([_ref(w, i)], _tx(w, i), "alice")
        sigs[i] = svc.sign(_tx(w, i))
        svc.remember_signature(_tx(w, i), sigs[i])
        if i == 2:
            prov.snapshot_now()
    prov.commit([_ref(w, 6)], _tx(w, 6), "alice")  # the flush the last sig rides
    digest = prov.consumed_digest()
    prov.close()
    rparty, rkp = _notary_party(r)
    prov2 = r.notary.DurableUniquenessProvider(r.dur.DurableStore(str(tmp_path), name="n"))
    svc2 = r.notary.NotaryService(rparty, rkp, prov2)
    assert prov2.consumed_digest() == digest
    for i, sig in sigs.items():
        got = svc2.cached_signature(_tx(r, i))
        assert got is not None and got.signature == sig.signature
        assert got.by.encoded == sig.by.encoded
    with pytest.raises(r.notary.NotaryError):
        prov2.commit([_ref(r, 1)], _tx(r, 99), "mallory")
    prov2.close()


# ------------------------------------------------- notary owner recovery

def test_acked_commit_survives_and_double_spend_rejected(tmp_path, pkg):
    prov = pkg.notary.DurableUniquenessProvider(pkg.dur.DurableStore(str(tmp_path), name="n"))
    prov.commit([_ref(pkg, 1)], _tx(pkg, 1), "alice")
    digest = prov.consumed_digest()
    prov.close()
    prov2 = pkg.notary.DurableUniquenessProvider(pkg.dur.DurableStore(str(tmp_path), name="n"))
    assert prov2.consumed_digest() == digest
    prov2.commit([_ref(pkg, 1)], _tx(pkg, 1), "alice")
    with pytest.raises(pkg.notary.NotaryError):
        prov2.commit([_ref(pkg, 1)], _tx(pkg, 2), "mallory")
    prov2.close()


def test_signature_cache_recovers_original_attestation(tmp_path):
    """Both packages sign with the same key: the attestation the port
    recovers after a restart is the reference's, byte for byte."""
    out = {}
    for name, p in PKG.items():
        party, kp = _notary_party(p)
        base = str(tmp_path / name)
        prov = p.notary.DurableUniquenessProvider(p.dur.DurableStore(base, name="n"))
        svc = p.notary.NotaryService(party, kp, prov)
        sig = svc.sign(_tx(p, 5))
        svc.remember_signature(_tx(p, 5), sig)
        prov.commit([_ref(p, 5)], _tx(p, 5), "alice")
        prov.close()
        prov2 = p.notary.DurableUniquenessProvider(p.dur.DurableStore(base, name="n"))
        cached = p.notary.NotaryService(party, kp, prov2).cached_signature(_tx(p, 5))
        prov2.close()
        assert cached is not None and cached.signature == sig.signature
        out[name] = (cached.signature, cached.by.encoded)
    assert out["port"] == out["ref"]


# ------------------------------------------------- kill-storm harness

def _workload(p):
    ops = []
    for i in range(30):
        ops.append(("commit", [_ref(p, i)], _tx(p, i), True))
        if i == 9:
            ops.append(("commit", [_ref(p, 3)], _tx(p, 900), False))
        if i == 14:
            ops.append(("snapshot",))
        if i == 15:
            ops.append(("commit", [_ref(p, 10)], _tx(p, 10), True))
        if i == 24:
            ops.append(("snapshot",))
        if i == 25:
            ops.append(("commit", [_ref(p, 20)], _tx(p, 901), False))
    return ops


def _drive(p, base_dir, schedule=(), torn_cut=0, seed=2026):
    """The reference's kill-storm driver for package ``p``: on a crash the
    provider is dropped, the torn tail optionally cut, a new provider
    rebuilt from the directory alone and the same op retried."""

    def build():
        return p.notary.DurableUniquenessProvider(p.dur.DurableStore(
            base_dir, name="ks", segment_max_bytes=256, snapshot_every=1 << 30))

    if schedule:
        _crash_plan(p, *schedule, seed=seed)
    prov = build()
    outcomes, crashes, i = [], 0, 0
    ops = _workload(p)
    while i < len(ops):
        op = ops[i]
        try:
            if op[0] == "snapshot":
                prov.snapshot_now()
                outcomes.append("snap")
            else:
                outcomes.append(prov.commit_batch([(op[1], op[2], "ks")])[0] is None)
            i += 1
        except p.fi.InjectedCrash:
            crashes += 1
            prov = None
            if torn_cut:
                p.fi.truncate_wal_tail(os.path.join(base_dir, "wal"), torn_cut)
            prov = build()
    p.fi.clear()
    return outcomes, prov.consumed_digest(), crashes, prov


@pytest.fixture(scope="module")
def ref_oracle(tmp_path_factory):
    outcomes, digest, crashes, prov = _drive(PKG["ref"], str(tmp_path_factory.mktemp("oracle")))
    prov.close()
    assert crashes == 0
    return outcomes, digest


@pytest.mark.parametrize("schedule,torn_cut", KILL_SCHEDULES)
def test_kill_storm_matches_reference(tmp_path, ref_oracle, schedule, torn_cut):
    """Each crash schedule on the port and on the reference: the same
    crashes fire, and both come back to the never-crashed reference's
    acked outcomes and consumed-set digest."""
    for name in ("ref", "port"):
        p = PKG[name]
        outcomes, digest, crashes, prov = _drive(
            p, str(tmp_path / name), schedule=schedule, torn_cut=torn_cut)
        assert crashes == len(schedule), name
        assert (outcomes, digest) == ref_oracle, name
        with pytest.raises(p.notary.NotaryError):
            prov.commit([_ref(p, 0)], _tx(p, 902), "mallory")
        prov.close()


def test_crash_events_are_traced(tmp_path):
    inj = _crash_plan(PKG["port"], ("durability.wal.pre_fsync", 1), seed=1)
    try:
        store = port_dur.DurableStore(str(tmp_path), name="t")
        store.append({"x": 1})
        with pytest.raises(port_fi.InjectedCrash):
            store.flush()
        assert ("op-crash", "durability.wal.pre_fsync") in [(e.kind, e.site) for e in inj.trace]
    finally:
        port_fi.clear()


def test_monitoring_section_after_recovery(tmp_path):
    """After a recovery the ``durability`` section carries the fsync timer
    and the replay counter, in the reference's layout."""
    from corda_tpu.node.monitoring import monitoring_snapshot as ref_snapshot
    from corda_tpu_torch.node.monitoring import monitoring_snapshot

    for name, p in PKG.items():
        store = p.dur.DurableStore(str(tmp_path / name), name="t")
        store.append({"x": 1})
        store.flush()
        store.close()
        store2 = p.dur.DurableStore(str(tmp_path / name), name="t")
        store2.recover(lambda r: None)
        store2.close()
    port, ref = monitoring_snapshot()["durability"], ref_snapshot()["durability"]
    assert port["enabled"] is True and port["replay"]["records"]["count"] >= 1
    assert port["wal"]["wal_fsync_s"]["count"] >= 1
    assert set(port) == set(ref) and set(port["wal"]) <= set(ref["wal"])


def test_batched_notary_answers_retry_with_original_signature(tmp_path):
    """A validating ``BatchedNotaryService`` over a durable provider on
    ``device="cpu"`` crashes at ``durability.wal.post_fsync`` in its
    second window; a provider and service rebuilt from the directory
    alone answer the resubmitted requests: every answer equals an
    uninterrupted notary's, and the acknowledged requests come back with
    their original signature bytes from the recovered journal."""
    from corda_tpu_torch.crypto import TransactionSignature
    from corda_tpu_torch.notary import BatchedNotaryService, InMemoryUniquenessProvider
    from corda_tpu_torch.testing import notary_stream, outcome_kind

    stream = notary_stream(9, 4, seed=21, device="cpu")
    reqs = stream.requests()
    clock = lambda: 1.7e9  # noqa: E731  (both notaries judge time windows alike)

    def service(provider):
        return BatchedNotaryService(stream.notary, stream.notary_keypair, provider,
                                    validating=True, max_batch=4, device="cpu", clock=clock)

    oracle = service(InMemoryUniquenessProvider()).process_stream(reqs, depth=1)
    base = str(tmp_path / "notary")
    svc = service(port_notary.DurableUniquenessProvider(port_dur.DurableStore(base, name="n")))
    # fsyncs: one a window's commit; the second window's dies after its fsync
    _crash_plan(PKG["port"], ("durability.wal.post_fsync", 2))
    answered = []
    try:
        for w in reqs:
            answered.append(svc.process_batch(w))
    except port_fi.InjectedCrash:
        pass
    finally:
        port_fi.clear()
    assert len(answered) == 1
    recovered = port_notary.DurableUniquenessProvider(port_dur.DurableStore(base, name="n"))
    assert recovered.last_recovery.replayed >= 1
    svc2 = service(recovered)
    again = [svc2.process_batch(w) for w in reqs]
    kinds = lambda out: [[outcome_kind(r) for r in w] for w in out]  # noqa: E731
    assert kinds(again) == kinds(oracle)
    for before, after in zip(answered[0], again[0]):
        if isinstance(before, TransactionSignature):
            assert after.signature == before.signature  # the original bytes
    assert recovered.consumed_digest() == oracle_digest(stream, clock, reqs)
    recovered.close()


def oracle_digest(stream, clock, reqs):
    from corda_tpu_torch.notary import BatchedNotaryService, InMemoryUniquenessProvider

    prov = InMemoryUniquenessProvider()
    BatchedNotaryService(stream.notary, stream.notary_keypair, prov, validating=True,
                         max_batch=4, device="cpu", clock=clock).process_stream(reqs, depth=1)
    return prov.consumed_digest()


# ------------------------------------------------- vault owner recovery

# the reference's test types under the same names (the vault's pages hold
# the state's class name), registered in the port under the same wire names
@dataclasses.dataclass(frozen=True)
class _DurCoin:
    amount: object
    owner: Party

    @property
    def participants(self):
        return [self.owner]


@dataclasses.dataclass(frozen=True)
class _DurCoinCmd:
    op: str = "issue"


def _register_port_types():
    from corda_tpu_torch.ledger import Amount, register_contract
    from corda_tpu_torch.ledger.states import resolve_contract

    register_custom(
        _DurCoin, "test.dur.CoinState",
        to_fields=lambda s: {"amount_q": s.amount.quantity, "token": s.amount.token,
                             "owner": s.owner},
        from_fields=lambda d: _DurCoin(Amount(d["amount_q"], d["token"]), d["owner"]),
    )
    register_custom(_DurCoinCmd, "test.dur.CoinCommand",
                    to_fields=lambda c: {"op": c.op},
                    from_fields=lambda d: _DurCoinCmd(d["op"]))
    try:
        resolve_contract("test.dur.CoinContract")
    except Exception:
        @register_contract("test.dur.CoinContract")
        class _PortDurCoinContract:
            def verify(self, tx):
                pass


_register_port_types()


def test_vault_journal_matches_reference(tmp_path):
    """The reference's transactions, carried as CBE bytes, recorded in
    both packages' journaled vaults: after a snapshot and a restart from
    the journal alone the port's pages equal the reference's, and an
    idempotent re-record changes nothing."""
    from corda_tpu.crypto import generate_keypair as ref_keypair
    from corda_tpu.ledger import Amount, StateAndRef, TransactionBuilder
    from corda_tpu.node import NodeVaultService as RefVault
    from corda_tpu_torch.node import NodeVaultService

    alice_kp, notary_kp = ref_keypair(), ref_keypair()
    alice = RefParty(RefName("DurAlice", "London", "GB"), alice_kp.public)
    notary = RefParty(RefName("DurNotary", "Zurich", "CH"), notary_kp.public)

    def issue():
        b = TransactionBuilder(notary=notary)
        b.add_output_state(RefDurCoin(Amount(100, "GBP"), alice), "test.dur.CoinContract")
        b.add_command(RefDurCoinCmd("issue"), alice.owning_key)
        return b.sign_initial_transaction(notary_kp)

    stx1, stx2 = issue(), issue()
    b = TransactionBuilder(notary=notary)
    b.add_input_state(StateAndRef(stx1.tx.outputs[0], RefStateRef(stx1.id, 0)))
    b.add_output_state(RefDurCoin(Amount(100, "GBP"), alice), "test.dur.CoinContract")
    b.add_command(RefDurCoinCmd("move"), alice.owning_key)
    spend = b.sign_initial_transaction(alice_kp)
    ref_stxs = [stx1, stx2, spend]
    port_stxs = [deserialize(ref_serialize(s)) for s in ref_stxs]

    out = {}
    for name, vault_cls, stxs in (("ref", RefVault, ref_stxs), ("port", NodeVaultService, port_stxs)):
        dur = PKG[name].dur
        path = str(tmp_path / name)
        vault = vault_cls(journal=dur.DurableStore(path, name="vault"), observe_all=True)
        for stx in stxs:
            vault.record_transaction(stx)
        vault.snapshot_now()
        vault.record_transaction(stxs[1])  # replays over the snapshot
        digest = vault.pages_digest()
        unconsumed = vault.query_by().total_states_available
        vault.close()
        vault2 = vault_cls(journal=dur.DurableStore(path, name="vault"), observe_all=True)
        assert vault2.pages_digest() == digest
        assert vault2.query_by().total_states_available == unconsumed == 2
        vault2.record_transaction(stxs[2])
        assert vault2.pages_digest() == digest
        vault2.close()
        out[name] = digest
    assert out["port"] == out["ref"]


# --------------------------------------------- flow-engine owner recovery

_A_KP = derive_keypair_from_entropy(4, hashlib.sha256(b"DurNodeA").digest())
_B_KP = derive_keypair_from_entropy(4, hashlib.sha256(b"DurNodeB").digest())
_A = Party(CordaX500Name("DurNodeA", "City", "GB"), _A_KP.public)
_B = Party(CordaX500Name("DurNodeB", "City", "GB"), _B_KP.public)
_PARTIES = {str(_A.name): _A, str(_B.name): _B}
_GATES: dict = {}


@dataclasses.dataclass
class PingPongFlow(FlowLogic):
    peer_name: str
    rounds: int

    def call(self):
        s = self.initiate_flow(_PARTIES[self.peer_name])
        total = 0
        for _ in range(self.rounds):
            total = s.send_and_receive(int, total + 1).unwrap(lambda x: x)
        return total


@InitiatedBy(PingPongFlow)
class PingPongResponder(FlowLogic):
    def __init__(self, session):
        self.session = session

    def call(self):
        while True:
            try:
                v = self.session.receive(int).unwrap(lambda x: x)
            except FlowException:
                return
            gate = _GATES.get("hold")
            if gate is not None and v > gate["after"]:
                gate["event"].wait(timeout=30)
            self.session.send(v + 1)


def test_wal_checkpoint_crash_and_restore_from_disk(tmp_path):
    """Kill the initiating node mid-protocol; a fresh engine over a fresh
    ``WalCheckpointStorage`` rebuilt from the directory finishes the flow
    with the reference's result."""
    from corda_tpu_torch.messaging import BrokerMessagingClient, DurableQueueBroker

    broker = DurableQueueBroker(visibility_s=1.0)
    ckpt_dir = str(tmp_path / "flows-a")
    _GATES["hold"] = {"after": 4, "event": threading.Event()}
    smm_b = None
    try:
        ckpt_a = WalCheckpointStorage(port_dur.DurableStore(ckpt_dir, name="flows"))
        client_a = BrokerMessagingClient(broker, str(_A.name))
        client_b = BrokerMessagingClient(broker, str(_B.name))
        smm_a = StateMachineManager(client_a, ckpt_a, _A, _PARTIES.get)
        smm_b = StateMachineManager(
            client_b, WalCheckpointStorage(
                port_dur.DurableStore(str(tmp_path / "flows-b"), name="flows")),
            _B, _PARTIES.get)
        h = smm_a.start_flow(PingPongFlow(str(_B.name), 3))
        deadline = time.monotonic() + 20
        while len(ckpt_a.load_oplog(h.flow_id)) < 5:
            assert time.monotonic() < deadline, "flow never made progress"
            time.sleep(0.02)
        smm_a.stop()
        client_a.stop()
        assert ckpt_a.all_flows()
        _GATES["hold"]["event"].set()
        ckpt_a2 = WalCheckpointStorage(port_dur.DurableStore(ckpt_dir, name="flows"))
        assert ckpt_a2.all_flows(), "checkpoint must survive on disk"
        assert ckpt_a2.last_recovery.replayed > 0
        smm_a2 = StateMachineManager(BrokerMessagingClient(broker, str(_A.name)), ckpt_a2,
                                     _A, _PARTIES.get)
        handles = smm_a2.restore()
        assert len(handles) == 1
        assert handles[0].result.result(timeout=30) == 6
        assert not ckpt_a2.all_flows()
        smm_a2.stop()
    finally:
        if smm_b is not None:
            smm_b.stop()
        _GATES.pop("hold", None)
        broker.close()


# ------------------------------------------------- off-by-default pin

def test_zero_overhead_when_off():
    """Durability off (the default): no files, no durability metrics, no
    threads and the ``{"enabled": false}`` section, in a fresh process."""
    code = """
import json, os, tempfile
cwd = tempfile.mkdtemp(); os.chdir(cwd)
from corda_tpu_torch.node.monitoring import monitoring_snapshot, node_metrics
from corda_tpu_torch.flows import CheckpointStorage, StateMachineManager
from corda_tpu_torch.notary import InMemoryUniquenessProvider
from corda_tpu_torch.node import NodeVaultService
v = NodeVaultService(); v.close()
p = InMemoryUniquenessProvider()
snap = monitoring_snapshot()
assert snap["durability"] == {"enabled": False}, snap["durability"]
names = list(node_metrics().snapshot())
assert not any(n.startswith(("durability.", "replay.", "recovery.")) for n in names), names
assert os.listdir(cwd) == [], os.listdir(cwd)
print(json.dumps({"ok": True}))
"""
    env = dict(os.environ)
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env={**env, "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", "")},
        cwd=REPO,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1])["ok"]


# ------------------------------------------------- slow mocknet soak

@pytest.mark.slow
def test_payment_storm_survives_notary_kills(tmp_path):
    """Payments over a durable validating notary and durable checkpoints
    while the chaos orchestrator kills the notary node twice and restarts
    it from its directories alone: every payment completes exactly once,
    and the notary's consumed set admits no double spend."""
    from corda_tpu_torch.faultinject import ChaosOrchestrator, CrashEvent
    from corda_tpu_torch.finance import CashIssueFlow, CashPaymentFlow
    from corda_tpu_torch.notary import ValidatingNotaryService
    from corda_tpu_torch.testing import mocknet

    notary_dir, flows_dir = str(tmp_path / "notary"), str(tmp_path / "notary-flows")

    def notary_factory(party, kp):
        return ValidatingNotaryService(party, kp, port_notary.DurableUniquenessProvider(
            port_dur.DurableStore(notary_dir, name="notary")))

    inj = port_fi.FaultInjector(port_fi.FaultPlan(
        seed=2026, duplicate_p=0.05,
        crashes=(CrashEvent(at_round=400, node="KSNotary", down_rounds=400),
                 CrashEvent(at_round=2500, node="KSNotary", down_rounds=400)),
    ))
    grace = mocknet.MOCK_PARKING_GRACE_S
    mocknet.MOCK_PARKING_GRACE_S = 30.0
    net = mocknet.MockNetworkNodes(pump=False, device="cpu")
    net.net.set_fault_injector(inj)
    orch = ChaosOrchestrator(net.net, inj)
    notary_node = net.create_node(
        "KSNotary", notary_service_factory=notary_factory, validating_notary=True,
        checkpoints=WalCheckpointStorage(port_dur.DurableStore(flows_dir, name="flows")))
    notary_kp = notary_node.keypair
    alice = net.create_node("KSAlice")
    bob = net.create_node("KSBob")

    def stop_notary():
        node = net.nodes["KSNotary"]
        node.services.notary_service.uniqueness.close()
        node.smm.stop()
        net.net.stop_node(str(node.party.name))

    def restart_notary():
        old = net.nodes["KSNotary"]
        endpoint = net.net.restart_node(str(old.party.name))
        net.create_node(
            "KSNotary", notary_service_factory=notary_factory, validating_notary=True,
            keypair=notary_kp, endpoint=endpoint,
            checkpoints=WalCheckpointStorage(port_dur.DurableStore(flows_dir, name="flows")))
        net.nodes["KSNotary"].smm.restore()

    orch.register("KSNotary", stop_notary, restart_notary)
    net.net.start_pumping()
    try:
        alice.smm.start_flow(
            CashIssueFlow(1000, "GBP", b"\x01", notary_node.party)).result.result(timeout=120)
        n_payments = 12
        for _ in range(n_payments):
            deadline = time.monotonic() + 300
            while True:
                h = alice.smm.start_flow(CashPaymentFlow(10, "GBP", bob.party))
                try:
                    h.result.result(timeout=120)
                    break
                except Exception:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.5)
        kinds = [e.kind for e in inj.trace]
        assert kinds.count("crash") >= 1 and kinds.count("restart") >= 1
        bob_total = sum(s.state.data.amount.quantity
                        for s in bob.services.vault_service.query_by().states)
        assert bob_total == 10 * n_payments
        prov = net.nodes["KSNotary"].services.notary_service.uniqueness
        assert prov.committed_txs() == n_payments
    finally:
        net.stop()
        mocknet.MOCK_PARKING_GRACE_S = grace
