"""The device state store (``corda_tpu_torch/statestore``) against the
reference's, class by class after the reference's ``tests/test_statestore.py``.

The port runs on ``device="cpu"``: its tables run kernels I, J and K's
plain versions. The reference's providers, indexes and tables are built on
a one-device mesh (``make_mesh(1)``, through their ``mesh=`` argument) with
the port's geometry, so both place every row in the same slot and spill the
same rows: verdicts, digests and the ``statestore.*`` counters (compared by
name, as deltas) must be equal; the randomised sweep also runs against the
reference's default 8-shard mesh (verdicts and digest). Requests, refs and
transaction ids are made from the same bytes in each package.

- tables: insert, probe, remove, tombstones, window overflow, tag counts;
- the randomised double-spend sweep: verdicts and ``consumed_digest()``
  equal to the port's ``InMemoryUniquenessProvider`` and to the
  reference's ``DeviceShardedUniquenessProvider`` over fresh commits,
  double spends, identical retries, requests of several refs, keys twice
  in one batch (routed to the host) and requests with no refs;
- the spill tier: overflowing rows spill with exact membership, and a
  ``statestore.spill`` fault is a hard error;
- ``statestore.probe`` faults: failover to the shadow with the same
  verdicts, the scale mode raising; a real launch error is no such fault
  and reaches the caller;
- durable recovery over the port's ``DurableStore``: a restart rebuilds the
  table, and the kill storm at the reference's crash schedules (a torn WAL
  tail among them) ends with the never-crashed oracle's digest; either
  package replays the other's WAL;
- the vault index: record and consume, owner counts, coin selection's
  cross-check, the SQL fallback on a probe fault, journal replay, a
  file-backed replay, a snapshot restore, a spilled key never resident
  twice, and a lost table, which raises instead of falling back;
- the monitoring section, which lists live tables only;
- the streamed generators (``testing.generated_ledger``): the reference's
  requests for one seed, flagged double spends conflicting and nothing
  else, bounded memory; the 10^7-state run is ``slow``, as in the
  reference;
- the gate, in fresh subprocesses: off, nothing is built or registered and
  no kernel is built; on, the vault's index is built and the notary
  package re-exports the provider.

The reference's mega-batch membership screen (``set_mega_screen``,
``probe_device_count``, ``test_screen_counts_device_resident_hits``) and the
scheduler's harvest of it (``test_collect_harvests_screen_counters``, over
``_MeshPending``) come with the port's mesh (ROADMAP.md, Queue 1 step 6)."""

import dataclasses
import hashlib
import itertools
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

import corda_tpu.crypto as ref_crypto
import corda_tpu.durability as ref_durability
import corda_tpu.faultinject as ref_faultinject
import corda_tpu.ledger as ref_ledger
import corda_tpu.node as ref_node
import corda_tpu.node.monitoring as ref_monitoring
import corda_tpu.notary as ref_notary
import corda_tpu.serialization as ref_serialization
import corda_tpu.statestore as ref_statestore
import corda_tpu.testing.generated_ledger as ref_generated
import corda_tpu_torch.crypto as port_crypto
import corda_tpu_torch.durability as port_durability
import corda_tpu_torch.faultinject as port_faultinject
import corda_tpu_torch.ledger as port_ledger
import corda_tpu_torch.node as port_node
import corda_tpu_torch.node.monitoring as port_monitoring
import corda_tpu_torch.notary as port_notary
import corda_tpu_torch.serialization as port_serialization
import corda_tpu_torch.statestore as port_statestore
import corda_tpu_torch.testing.generated_ledger as port_generated
from corda_tpu.parallel.mesh import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run many small integer ops: beside the suite's
    other worker processes a torch thread pool only contends."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@dataclasses.dataclass
class Pkg:
    name: str
    crypto: object
    ledger: object
    node: object
    monitoring: object
    notary: object
    statestore: object
    durability: object
    faultinject: object
    serialization: object

    def table_kw(self) -> dict:
        """Where this package's tables live: the reference's on one device
        of its mesh, the port's on the CPU."""
        return {"mesh": make_mesh(1)} if self.name == "ref" else {"device": "cpu"}

    def provider(self, store=None, **kw):
        return self.statestore.DeviceShardedUniquenessProvider(store, **self.table_kw(), **kw)

    def index(self, **kw):
        return self.statestore.DeviceVaultIndex(**self.table_kw(), **kw)

    def counters(self) -> dict:
        return {
            k: v["count"] for k, v in self.monitoring.node_metrics().snapshot().items()
            if k.startswith("statestore.") and v.get("type") == "counter"
        }

    def delta(self, before: dict) -> dict:
        after = self.counters()
        return {k: after.get(k, 0) - before.get(k, 0) for k in set(after) | set(before)
                if after.get(k, 0) != before.get(k, 0)}

    def tx(self, i: int):
        return self.crypto.SecureHash(hashlib.sha256(b"ss-tx-%d" % i).digest())

    def ref(self, i: int, idx: int = 0):
        return self.ledger.StateRef(
            self.crypto.SecureHash(hashlib.sha256(b"ss-ref-%d" % i).digest()), idx)

    def requests(self, spec):
        """Requests from ((ref ints), tx int, caller) triples."""
        return [([self.ref(i) for i in refs], self.tx(t), caller) for refs, t, caller in spec]

    def fault(self, seed, site):
        return self.faultinject.install(self.faultinject.FaultInjector(
            self.faultinject.FaultPlan(seed=seed, fail_sites=((site, 1),))))


REF = Pkg("ref", ref_crypto, ref_ledger, ref_node, ref_monitoring, ref_notary,
          ref_statestore, ref_durability, ref_faultinject, ref_serialization)
PORT = Pkg("port", port_crypto, port_ledger, port_node, port_monitoring, port_notary,
           port_statestore, port_durability, port_faultinject, port_serialization)
BOTH = (REF, PORT)


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    for P in BOTH:
        P.faultinject.clear()
    yield
    for P in BOTH:
        P.faultinject.clear()


def verdicts(out) -> list:
    """Verdicts in package-neutral form: None, or the sorted conflict
    history as bytes."""
    return [None if c is None else sorted(
        (ref.txhash.bytes, ref.index,
         None if d is None else (d.consuming_tx.bytes, d.input_index, d.requesting_party_name))
        for ref, d in c.state_history.items()) for c in out]


def in_both(fn, *args):
    """{pkg name: fn(P, *args)} for the reference and the port."""
    return {P.name: fn(P, *args) for P in BOTH}


# ----------------------------------------------------------- table ops

class TestDeviceTable:
    @staticmethod
    def _insert_probe_remove(P):
        t = P.statestore.DeviceShardedTable(**P.table_kw(), slots_per_shard=64, max_probe=8,
                                            name="t1")
        keys = [b"k-%d" % i for i in range(16)]
        rows = P.statestore.key_rows(keys)
        payloads = P.statestore.payload_rows([hashlib.sha256(k).digest() for k in keys])
        absent = P.statestore.key_rows([b"absent-%d" % i for i in range(8)])
        seen = [t.insert_rows(rows, payloads).tolist(), t.n_live,
                t.probe_rows(rows).tolist(), t.probe_rows(absent).tolist(),
                t.insert_rows(rows, payloads).tolist(), t.n_live,
                t.remove_rows(rows[:8]).tolist(), t.n_live, t.probe_rows(rows).tolist(),
                t.remove_rows(absent).tolist(),
                t.insert_rows(rows[:4], payloads[:4]).tolist(), t.probe_rows(rows[:4]).tolist(),
                t.n_live, {k: v for k, v in t.stats().items() if k != "name"}]
        return seen

    def test_insert_probe_remove_tombstone(self):
        got = in_both(self._insert_probe_remove)
        assert got["port"] == got["ref"]
        port = got["port"]
        assert not any(port[0]) and port[1] == 16 and all(port[2]) and not any(port[3])
        assert port[5] == 16 and all(port[6]) and port[7] == 8
        assert port[8] == [False] * 8 + [True] * 8 and not any(port[9])
        assert all(port[11]) and port[12] == 12 and port[13]["live_rows"] == 12

    def test_probe_window_overflow_reported(self):
        def run(P):
            t = P.statestore.DeviceShardedTable(**P.table_kw(), slots_per_shard=8, max_probe=2,
                                                name="t2")
            keys = [b"ovf-%d" % i for i in range(48)]
            rows = P.statestore.key_rows(keys)
            overflow = t.insert_rows(
                rows, P.statestore.payload_rows([hashlib.sha256(k).digest() for k in keys]))
            return overflow.tolist(), t.probe_rows(rows).tolist(), t.n_live

        got = in_both(run)
        assert got["port"] == got["ref"]
        overflow, bits, n_live = got["port"]
        assert any(overflow) and not all(overflow)
        assert bits == [not o for o in overflow] and n_live == overflow.count(False)

    def test_count_tag(self):
        def run(P):
            t = P.statestore.DeviceShardedTable(**P.table_kw(), slots_per_shard=64, max_probe=8,
                                                name="t3")
            keys = [b"tag-%d" % i for i in range(12)]
            t.insert_rows(P.statestore.key_rows(keys),
                          P.statestore.payload_rows([hashlib.sha256(k).digest() for k in keys]),
                          np.array([0x11] * 5 + [0x33] * 7, np.int32))
            return [t.count_tag(0x11), t.count_tag(0x33), t.count_tag(0x55)]

        got = in_both(run)
        assert got["port"] == got["ref"] == [5, 7, 0]


# -------------------------------------------- randomized oracle parity

def sweep_spec(seed=1707, batches=10):
    """The reference's randomised sweep as ((ref ints), tx int, caller)
    batches."""
    rng = random.Random(seed)
    counter = itertools.count()
    committed = []
    out = []
    oracle = PORT.notary.InMemoryUniquenessProvider()
    for batch_no in range(batches):
        spec = []
        for _ in range(11):
            roll = rng.random()
            if roll < 0.15 and committed:
                spec.append(rng.choice(committed))
            elif roll < 0.35 and committed:
                refs = rng.choice(committed)[0]
                spec.append(((rng.choice(refs),), 10000 + next(counter), "mallory"))
            else:
                spec.append((tuple(next(counter) for _ in range(rng.randint(1, 3))),
                             20000 + next(counter), "party"))
        shared = next(counter)
        spec.append(((shared, next(counter)), 31000 + batch_no, "dup-a"))
        spec.append(((shared,), 32000 + batch_no, "dup-b"))
        spec.append(((), 33000 + batch_no, "empty"))
        for s, v in zip(spec, oracle.commit_batch(PORT.requests(spec))):
            if v is None and s[0] and s not in committed:
                committed.append(s)
        out.append(spec)
    return out


class TestOracleParity:
    def test_randomized_double_spend_sweep(self):
        batches = sweep_spec()

        def run(P, mesh8=False):
            oracle = P.notary.InMemoryUniquenessProvider()
            if mesh8:
                dev = P.statestore.DeviceShardedUniquenessProvider(slots_per_shard=256,
                                                                   max_probe=16)
            else:
                dev = P.provider(slots_per_shard=256, max_probe=16)
            before = P.counters()
            got, want = [], []
            try:
                for spec in batches:
                    reqs = P.requests(spec)
                    want.append(verdicts(oracle.commit_batch(reqs)))
                    got.append(verdicts(dev.commit_batch(reqs)))
                return (got, want, dev.consumed_digest(), oracle.consumed_digest(),
                        dev.device_divergence(), P.delta(before))
            finally:
                dev.close()

        port, ref = run(PORT), run(REF)
        ref8 = run(REF, mesh8=True)
        assert port[0] == port[1] == ref[0] == ref8[0]
        assert port[2] == port[3] == ref[2] == ref8[2]
        assert port[4] == 0
        assert port[5] == ref[5]
        assert port[5].get("statestore.ab_mismatch", 0) == 0
        assert port[5].get("statestore.host_routed", 0) >= 20
        assert port[5].get("statestore.conflicts", 0) >= 10

    def test_same_batch_fresh_commit_and_identical_retry(self):
        def run(P):
            oracle = P.notary.InMemoryUniquenessProvider()
            dev = P.provider(slots_per_shard=64, max_probe=8)
            try:
                reqs = P.requests([((90001,), 90001, "retry-client")] * 2)
                return (verdicts(oracle.commit_batch(reqs)), verdicts(dev.commit_batch(reqs)),
                        dev._table.n_live + dev.spill_count(),
                        dev.consumed_digest() == oracle.consumed_digest())
            finally:
                dev.close()

        got = in_both(run)
        assert got["port"] == got["ref"]
        assert got["port"][0] == got["port"][1] and got["port"][2:] == (1, True)


# ------------------------------------------------------------ spill tier

class TestSpillTier:
    def test_overflow_spills_with_exact_membership(self):
        def run(P):
            oracle = P.notary.InMemoryUniquenessProvider()
            dev = P.provider(slots_per_shard=8, max_probe=2)
            before = P.counters()
            try:
                spec = [((40000 + i,), 40000 + i, "loader") for i in range(48)]
                seen = []
                for lo in range(0, 48, 8):
                    reqs = P.requests(spec[lo:lo + 8])
                    seen.append((verdicts(oracle.commit_batch(reqs)),
                                 verdicts(dev.commit_batch(reqs))))
                spilled = set(dev._spill)
                thieves = [((s[0][0],), 41000 + i, "mallory") for i, s in enumerate(spec)
                           if P.ref(s[0][0]).txhash.bytes + (0).to_bytes(4, "big") in spilled][:4]
                reqs = P.requests(thieves)
                seen.append((verdicts(oracle.commit_batch(reqs)), verdicts(dev.commit_batch(reqs))))
                return (seen, len(thieves), dev.spill_count(), P.delta(before),
                        dev.consumed_digest() == oracle.consumed_digest(),
                        dev.device_divergence(), dev.table_stats()["spill_rows"])
            finally:
                dev.close()

        got = in_both(run)
        assert got["port"] == got["ref"]
        seen, n_thieves, spills, delta, same_digest, divergence, spill_rows = got["port"]
        assert all(w == g for w, g in seen) and n_thieves > 0 and spills > 0
        assert delta.get("statestore.spills", 0) == spills == spill_rows
        assert same_digest and divergence == 0

    def test_spill_fault_is_a_hard_error(self):
        def run(P):
            dev = P.provider(slots_per_shard=8, max_probe=2)
            before = P.counters()
            P.fault(3, "statestore.spill")
            try:
                with pytest.raises(P.statestore.StateStoreSpillError):
                    for lo in range(0, 64, 8):
                        dev.commit_batch(P.requests(
                            [((42000 + lo + i,), 42000 + lo + i, "x") for i in range(8)]))
                return P.delta(before)
            finally:
                P.faultinject.clear()
                dev.close()

        got = in_both(run)
        assert got["port"] == got["ref"]
        assert got["port"].get("statestore.spill_errors", 0) == 1


# ---------------------------------------------------- probe-fault paths

class TestProbeFaultFailover:
    def test_failover_to_shadow_keeps_verdict_parity(self):
        def run(P):
            oracle = P.notary.InMemoryUniquenessProvider()
            dev = P.provider(slots_per_shard=256, max_probe=16)
            before = P.counters()
            try:
                batch1 = P.requests([((50000 + i,), 50000 + i, "p") for i in range(6)])
                P.fault(4, "statestore.probe")
                first = (verdicts(oracle.commit_batch(batch1)), verdicts(dev.commit_batch(batch1)))
                P.faultinject.clear()
                failovers, spills = P.delta(before).get("statestore.probe_failover", 0), \
                    dev.spill_count()
                batch2 = P.requests([((50000 + i,), 51000 + i, "mallory") for i in range(3)]
                                    + [((52000 + i,), 52000 + i, "p") for i in range(3)])
                second = (verdicts(oracle.commit_batch(batch2)),
                          verdicts(dev.commit_batch(batch2)))
                return (first, second, failovers, spills,
                        dev.consumed_digest() == oracle.consumed_digest(),
                        dev.device_divergence(), P.delta(before))
            finally:
                P.faultinject.clear()
                dev.close()

        got = in_both(run)
        assert got["port"] == got["ref"]
        first, second, failovers, spills, same_digest, divergence, _ = got["port"]
        assert first[0] == first[1] and second[0] == second[1]
        assert failovers == 1 and spills == 6 and same_digest and divergence == 0

    def test_scale_mode_probe_fault_raises(self):
        for P in BOTH:
            dev = P.provider(slots_per_shard=64, max_probe=8, shadow=False)
            P.fault(5, "statestore.probe")
            try:
                with pytest.raises(P.notary.NotaryError):
                    dev.commit_batch(P.requests([((53000,), 53000, "p")]))
            finally:
                P.faultinject.clear()
                dev.close()

    def test_real_launch_error_raises_instead_of_failing_over(self, monkeypatch):
        """Only an injected ``statestore.probe`` fault fails over: a commit
        launch that raises reaches the caller, latches the table lost, and
        every later window raises ``DeviceTableLostError``; nothing is
        decided on the shadow or spilled."""
        from corda_tpu_torch.statestore import DeviceTableLostError
        from corda_tpu_torch.statestore import table as port_table

        dev = PORT.provider(slots_per_shard=64, max_probe=8)
        before = PORT.counters()
        try:
            dev.commit_batch(PORT.requests([((54000,), 54000, "p")]))

            def fails(*args, **kw):
                raise RuntimeError("statestore_commit launch failed: cudaError 700")

            monkeypatch.setattr(port_table.ops, "statestore_commit", fails)
            with pytest.raises(RuntimeError, match="cudaError 700"):
                dev.commit_batch(PORT.requests([((54001,), 54001, "p")]))
            monkeypatch.undo()
            with pytest.raises(DeviceTableLostError):
                dev.commit_batch(PORT.requests([((54002,), 54002, "p")]))
            d = PORT.delta(before)
            assert d.get("statestore.table_lost", 0) == 1
            assert d.get("statestore.probe_failover", 0) == 0
            assert dev.spill_count() == 0
        finally:
            dev.close()

    def test_durable_store_requires_shadow(self, tmp_path):
        for P in BOTH:
            with pytest.raises(ValueError):
                P.provider(P.durability.DurableStore(str(tmp_path / P.name), name="x"),
                           shadow=False)


# ------------------------------------------------- durable recovery tier

def workload():
    """The reference's kill-storm workload: double spends and client
    retries between the commits, so every crash schedule crosses them."""
    ops = []
    for i in range(30):
        ops.append(("commit", (60000 + i,), 60000 + i, True))
        if i == 9:
            ops.append(("commit", (60003,), 60900, False))    # double spend
        if i == 14:
            ops.append(("snapshot",))
        if i == 15:
            ops.append(("commit", (60010,), 60010, True))     # client retry
        if i == 24:
            ops.append(("snapshot",))
        if i == 25:
            ops.append(("commit", (60020,), 60901, False))    # double spend
    return ops


def drive_device(P, base_dir, schedule=(), torn_cut=0, seed=2026):
    """The workload against a durable provider under a crash schedule; on a
    crash every in-memory object (the table included) is dropped, the WAL
    tail is optionally torn, and a fresh provider rebuilds from the
    directory alone, then the unacknowledged op is retried."""

    def build():
        return P.provider(
            P.durability.DurableStore(base_dir, name="ss", segment_max_bytes=256,
                                      snapshot_every=1 << 30),
            slots_per_shard=64, max_probe=8)

    if schedule:
        P.faultinject.install(P.faultinject.FaultInjector(
            P.faultinject.FaultPlan(seed=seed, crash_sites=tuple(schedule))))
    prov = build()
    outcomes, crashes, i, ops = [], 0, 0, workload()
    while i < len(ops):
        op = ops[i]
        try:
            if op[0] == "snapshot":
                prov.snapshot_now()
                outcomes.append("snap")
            else:
                conflict = prov.commit_batch(P.requests([(op[1], op[2], "ks")]))[0]
                outcomes.append(conflict is None)
            i += 1
        except P.faultinject.InjectedCrash:
            crashes += 1
            prov = None
            if torn_cut:
                P.faultinject.truncate_wal_tail(os.path.join(base_dir, "wal"), torn_cut)
            prov = build()
    P.faultinject.clear()
    return outcomes, prov.consumed_digest(), crashes, prov


def drive_host_oracle(P):
    prov = P.notary.InMemoryUniquenessProvider()
    outcomes = []
    for op in workload():
        if op[0] == "snapshot":
            outcomes.append("snap")
        else:
            outcomes.append(prov.commit_batch(P.requests([(op[1], op[2], "ks")]))[0] is None)
    return outcomes, prov.consumed_digest()


# the reference's KILL_SCHEDULES (tests/test_statestore.py), site for site
KILL_SCHEDULES = [
    pytest.param((("durability.wal.pre_fsync", 5),), 5, id="pre-fsync-torn-tail"),
    pytest.param((("durability.snapshot.rename", 1),), 0, id="mid-snapshot"),
    pytest.param((("durability.wal.pre_fsync", 4),
                  ("durability.wal.post_fsync", 9),
                  ("durability.snapshot.rename", 2),
                  ("durability.compact", 2)), 0, id="kill-storm-all-sites"),
]


class TestDurableRecovery:
    def test_restart_rebuilds_device_table(self, tmp_path):
        def run(P):
            base = str(tmp_path / P.name)
            store = P.durability.DurableStore(base, name="ss", snapshot_every=1 << 30)
            dev = P.provider(store, slots_per_shard=64, max_probe=8)
            reqs = P.requests([((70000 + 2 * i, 70000 + 2 * i + 1), 70000 + i, "p")
                               for i in range(12)])
            dev.commit_batch(reqs[:6])
            dev.snapshot_now()
            dev.commit_batch(reqs[6:])
            digest = dev.consumed_digest()
            dev.close()
            before = P.counters()
            dev2 = P.provider(P.durability.DurableStore(base, name="ss", snapshot_every=1 << 30),
                              slots_per_shard=64, max_probe=8)
            try:
                seen = [dev2.last_recovery.replayed, P.delta(before),
                        dev2._table.n_live + dev2.spill_count(),
                        dev2.consumed_digest() == digest, dev2.device_divergence()]
                probe_before = P.counters()
                seen.append(verdicts(dev2.commit_batch(P.requests([((70000,), 79999,
                                                                    "mallory")]))))
                seen.append(P.delta(probe_before).get("statestore.probe_rows", 0))
                seen.append(verdicts(dev2.commit_batch(P.requests([((71000,), 71000, "p")]))))
                return seen
            finally:
                dev2.close()

        got = in_both(run)
        assert got["port"] == got["ref"]
        replayed, delta, rows, same, divergence, thief, probed, fresh = got["port"]
        assert replayed >= 6 and delta.get("statestore.rebuild_rows", 0) == 24 and rows == 24
        assert same and divergence == 0 and thief[0] is not None and probed >= 1
        assert fresh == [None]

    @pytest.mark.parametrize("schedule,torn_cut", KILL_SCHEDULES)
    def test_kill_storm_matches_host_oracle(self, tmp_path, schedule, torn_cut):
        oracle_outcomes, oracle_digest = drive_host_oracle(PORT)
        assert drive_host_oracle(REF) == (oracle_outcomes, oracle_digest)
        outcomes, digest, crashes, prov = drive_device(PORT, str(tmp_path), schedule, torn_cut)
        try:
            assert crashes == len(schedule)
            assert outcomes == oracle_outcomes
            assert digest == oracle_digest
            assert prov.device_divergence() == 0
            with pytest.raises(PORT.notary.NotaryError):
                prov.commit(*PORT.requests([((60000,), 60902, "mallory")])[0])
        finally:
            prov.close()

    @pytest.mark.parametrize("writer", ["ref", "port"])
    def test_either_package_replays_the_others_wal(self, tmp_path, writer):
        """The journal's records are the same bytes in both packages: a
        provider of either package recovers the other's directory to the
        same digest and refuses a double spend of a recovered ref."""
        W, R = (REF, PORT) if writer == "ref" else (PORT, REF)
        base = str(tmp_path)
        dev = W.provider(W.durability.DurableStore(base, name="ss", snapshot_every=1 << 30),
                         slots_per_shard=64, max_probe=8)
        dev.commit_batch(W.requests([((72000 + i, 72100 + i), 72000 + i, "p")
                                     for i in range(9)]))
        dev.snapshot_now()
        dev.commit_batch(W.requests([((72200 + i,), 72200 + i, "q") for i in range(5)]))
        digest = dev.consumed_digest()
        dev.close()
        again = R.provider(R.durability.DurableStore(base, name="ss", snapshot_every=1 << 30),
                           slots_per_shard=64, max_probe=8)
        try:
            assert again.consumed_digest() == digest
            assert again.device_divergence() == 0
            assert again.commit_batch(R.requests([((72003,), 72999, "mallory")]))[0] is not None
        finally:
            again.close()


# ------------------------------------------------------ vault index tier

@dataclasses.dataclass(frozen=True)
class TSSCoin:
    amount: object
    owner: object

    @property
    def participants(self):
        return [self.owner]


@dataclasses.dataclass(frozen=True)
class TSSCoinCmd:
    op: str = "issue"


class TSSCoinContract:
    def verify(self, tx):
        pass


for _P in BOTH:
    _amount = _P.ledger.Amount
    _P.serialization.register_custom(
        TSSCoin, "test.tss.Coin",
        to_fields=lambda s: {"q": s.amount.quantity, "t": s.amount.token, "o": s.owner},
        from_fields=lambda d, _amount=_amount: TSSCoin(_amount(d["q"], d["t"]), d["o"]),
    )
    _P.serialization.register_custom(
        TSSCoinCmd, "test.tss.CoinCmd",
        to_fields=lambda c: {"op": c.op}, from_fields=lambda d: TSSCoinCmd(d["op"]),
    )
    _P.ledger.register_contract("test.tss.CoinContract")(TSSCoinContract)


def party(P, name):
    kp = P.crypto.derive_keypair_from_entropy(4, hashlib.sha256(name.encode()).digest())
    return P.ledger.Party(P.ledger.CordaX500Name(name, "London", "GB"), kp.public), kp


def parties(P):
    return party(P, "SS Alice"), party(P, "SS Bob"), party(P, "SS Notary")


def issue(P, owner, notary, notary_kp, n_outputs=1):
    b = P.ledger.TransactionBuilder(notary=notary)
    for _ in range(n_outputs):
        b.add_output_state(TSSCoin(P.ledger.Amount(100, "GBP"), owner), "test.tss.CoinContract")
    b.add_command(TSSCoinCmd("issue"), owner.owning_key)
    return b.sign_initial_transaction(notary_kp)


def spend(P, vault, spender, spender_kp, to, notary):
    b = P.ledger.TransactionBuilder(notary=notary)
    sr = vault.unconsumed_states(TSSCoin)[0]
    b.add_input_state(sr)
    b.add_output_state(TSSCoin(P.ledger.Amount(100, "GBP"), to), "test.tss.CoinContract")
    b.add_command(TSSCoinCmd("move"), spender.owning_key)
    vault.record_transaction(b.sign_initial_transaction(spender_kp))
    return sr.ref


class TestVaultIndex:
    def test_record_consume_membership_and_owner_counts(self):
        def run(P):
            (alice, alice_kp), (bob, _), (notary, notary_kp) = parties(P)
            index = P.index(slots_per_shard=64, max_probe=8)
            vault = P.node.NodeVaultService(observe_all=True, state_index=index)
            before = P.counters()
            vault.record_transaction(issue(P, alice, notary, notary_kp, n_outputs=3))
            refs = [sr.ref for sr in vault.unconsumed_states(TSSCoin)]
            seen = [len(refs), index.contains(refs).tolist(), index.owner_count(alice.owning_key),
                    index.owner_count(bob.owning_key), vault.unconsumed_ref_exists(refs[0]),
                    vault.unconsumed_ref_exists(P.ledger.StateRef(P.tx(80000), 7))]
            spent = spend(P, vault, alice, alice_kp, bob, notary)
            seen += [index.contains([spent]).tolist(), vault.unconsumed_ref_exists(spent),
                     index.owner_count(alice.owning_key), index.owner_count(bob.owning_key),
                     len(vault.select_fungible("GBP", 150, "flow-ss", TSSCoin)), P.delta(before)]
            return seen

        got = in_both(run)
        assert got["port"] == got["ref"]
        (n, contains, n_alice, n_bob, exists, fake, spent, spent_exists, n_alice2, n_bob2, picked,
         delta) = got["port"]
        assert n == 3 and all(contains) and (n_alice, n_bob) == (3, 0) and exists and not fake
        assert spent == [False] and not spent_exists and (n_alice2, n_bob2) == (2, 1)
        assert picked >= 2
        assert delta.get("statestore.vault.select_mismatch", 0) == 0
        assert delta.get("statestore.vault.adds", 0) == 4
        assert delta.get("statestore.vault.removes", 0) == 1

    def test_probe_fault_degrades_to_sql(self):
        def run(P):
            (alice, _), _bob, (notary, notary_kp) = parties(P)
            index = P.index(slots_per_shard=64, max_probe=8)
            vault = P.node.NodeVaultService(observe_all=True, state_index=index)
            vault.record_transaction(issue(P, alice, notary, notary_kp))
            ref = vault.unconsumed_states(TSSCoin)[0].ref
            before = P.counters()
            try:
                P.fault(6, "statestore.probe")
                none = index.contains([ref]) is None
                P.fault(6, "statestore.probe")
                sql = vault.unconsumed_ref_exists(ref)
            finally:
                P.faultinject.clear()
            return none, sql, P.delta(before).get("statestore.vault.probe_failover", 0)

        got = in_both(run)
        assert got["port"] == got["ref"] == (True, True, 2)

    def test_journal_recovery_repopulates_index(self, tmp_path):
        (alice, _), _bob, (notary, notary_kp) = parties(PORT)
        store = PORT.durability.DurableStore(str(tmp_path), name="vault")
        vault = PORT.node.NodeVaultService(observe_all=True, journal=store)
        vault.record_transaction(issue(PORT, alice, notary, notary_kp))
        ref = vault.unconsumed_states(TSSCoin)[0].ref
        store.flush()
        store.close()
        index = PORT.index(slots_per_shard=64, max_probe=8)
        vault2 = PORT.node.NodeVaultService(
            observe_all=True, journal=PORT.durability.DurableStore(str(tmp_path), name="vault"),
            state_index=index)
        assert index.contains([ref])[0]
        assert vault2.unconsumed_ref_exists(ref)

    def test_file_backed_replay_does_not_resurrect_spent_refs(self, tmp_path):
        (alice, alice_kp), (bob, _), (notary, notary_kp) = parties(PORT)
        db = str(tmp_path / "vault.db")
        vault = PORT.node.NodeVaultService(
            db, observe_all=True, journal=PORT.durability.DurableStore(str(tmp_path), name="vault"))
        vault.record_transaction(issue(PORT, alice, notary, notary_kp, n_outputs=2))
        spent = spend(PORT, vault, alice, alice_kp, bob, notary)
        live = [sr.ref for sr in vault.unconsumed_states(TSSCoin)]
        vault.close()
        index = PORT.index(slots_per_shard=64, max_probe=8)
        vault2 = PORT.node.NodeVaultService(
            db, observe_all=True, journal=PORT.durability.DurableStore(str(tmp_path), name="vault"),
            state_index=index)
        assert not index.contains([spent])[0]
        assert not vault2.unconsumed_ref_exists(spent)
        assert index.contains(live).all()
        assert all(vault2.unconsumed_ref_exists(ref) for ref in live)

    def test_snapshot_restore_populates_index(self, tmp_path):
        (alice, _), _bob, (notary, notary_kp) = parties(PORT)
        store = PORT.durability.DurableStore(str(tmp_path), name="vault")
        vault = PORT.node.NodeVaultService(observe_all=True, journal=store)
        vault.record_transaction(issue(PORT, alice, notary, notary_kp, n_outputs=3))
        refs = [sr.ref for sr in vault.unconsumed_states(TSSCoin)]
        vault.snapshot_now()
        vault.close()
        index = PORT.index(slots_per_shard=64, max_probe=8)
        before = PORT.counters()
        vault2 = PORT.node.NodeVaultService(
            observe_all=True, journal=PORT.durability.DurableStore(str(tmp_path), name="vault"),
            state_index=index)
        assert index.contains(refs).all()
        assert all(vault2.unconsumed_ref_exists(ref) for ref in refs)
        vault2.select_fungible("GBP", 150, "flow-snap", TSSCoin)
        assert PORT.delta(before).get("statestore.vault.select_mismatch", 0) == 0

    def test_spilled_key_never_dual_resident(self):
        def run(P):
            key = P.notary.uniqueness._ref_key
            index = P.index(slots_per_shard=8, max_probe=2)
            refs = [P.ref(91000 + i) for i in range(64)]
            index.add_states([(r, None) for r in refs])
            spilled_keys = set(index._spill)
            spilled = [r for r in refs if key(r) in spilled_keys]
            resident = [r for r in refs if key(r) not in spilled_keys]
            index.remove_states(resident[: len(resident) // 2])
            index.add_states([(r, None) for r in refs])
            same = set(index._spill) == spilled_keys
            index.remove_states(spilled)
            return (len(spilled_keys), same, index.contains(spilled).tolist(),
                    index.stats()["spill_rows"])

        got = in_both(run)
        assert got["port"] == got["ref"]
        n_spilled, same, contains, spill_rows = got["port"]
        assert n_spilled > 0 and same and not any(contains) and spill_rows == 0

    def test_lost_table_poisons_and_raises_to_the_vault(self, monkeypatch):
        """A remove launch that fails while it updates the table in place
        latches the table lost (``statestore.table_lost`` once). Every later
        op of the table raises ``DeviceTableLostError``, and so do the
        index and the vault over it: a lost table is not a probe fault, so
        nothing degrades to SQL or spills in silence."""
        from corda_tpu_torch.statestore import DeviceTableLostError
        from corda_tpu_torch.statestore import table as port_table

        (alice, alice_kp), (bob, _), (notary, notary_kp) = parties(PORT)
        index = PORT.index(slots_per_shard=64, max_probe=8)
        vault = PORT.node.NodeVaultService(observe_all=True, state_index=index)
        vault.record_transaction(issue(PORT, alice, notary, notary_kp, n_outputs=2))
        refs = [sr.ref for sr in vault.unconsumed_states(TSSCoin)]
        before = PORT.counters()
        table = index._table

        def fails(*args, **kw):
            raise RuntimeError("statestore_remove launch failed: cudaError 700")

        monkeypatch.setattr(port_table.ops, "statestore_remove", fails)
        with pytest.raises(RuntimeError):
            table.remove_rows(PORT.statestore.key_rows([b"x" * 36]))
        monkeypatch.undo()
        assert table.stats()["poisoned"]
        for op in (lambda: table.probe_rows(PORT.statestore.key_rows([b"x" * 36])),
                   lambda: table.remove_rows(PORT.statestore.key_rows([b"x" * 36])),
                   lambda: table.count_tag(1), table.live_rows,
                   lambda: index.contains(refs),
                   lambda: index.add_states([(PORT.ref(92000), None)]),
                   lambda: index.remove_states(refs[:1]),
                   lambda: vault.unconsumed_ref_exists(refs[0])):
            with pytest.raises(DeviceTableLostError):
                op()
        assert index.stats()["spill_rows"] == 0
        d = PORT.delta(before)
        assert d.get("statestore.table_lost", 0) == 1
        assert d.get("statestore.vault.probe_failover", 0) == 0


# ---------------------------------------------------- monitoring section

class TestMonitoringSection:
    def test_monitoring_section_reports_tables(self):
        dev = PORT.provider(slots_per_shard=64, max_probe=8)
        try:
            dev.commit_batch(PORT.requests([((83000,), 83000, "p")]))
            section = PORT.statestore.statestore_section()
            assert section["enabled"] is True
            assert "uniqueness" in {t["name"] for t in section["tables"]}
            assert set(section["tables"][0]) == set(REF.statestore.DeviceShardedTable(
                mesh=make_mesh(1), slots_per_shard=8, max_probe=2).stats())
            snap = PORT.monitoring.monitoring_snapshot()
            assert snap["statestore"]["enabled"] is True
            assert not any(k.startswith("statestore.") for k in snap["process"])
            assert snap["statestore"]["metrics"]["commits"]["count"] >= 1
        finally:
            dev.close()

    def test_closed_or_dropped_tables_leave_the_section(self):
        """The registry keeps no table alive: a closed provider's table and
        a dropped index's leave the section (and its tensors can be freed);
        with no live table the section is the off marker again."""
        import gc
        import weakref

        def names():
            section = PORT.statestore.statestore_section()
            return [t["name"] for t in section.get("tables", [])]

        gc.collect()
        base = names()
        dev = PORT.provider(slots_per_shard=64, max_probe=8)
        index = PORT.index(slots_per_shard=64, max_probe=8)
        assert names() == base + ["uniqueness", "vault"]
        dev.close()
        assert names() == base + ["vault"]
        gone = weakref.ref(index._table)
        del index
        gc.collect()
        assert gone() is None and names() == base
        if not base:
            assert PORT.statestore.statestore_section() == {"enabled": False}


# -------------------------------- satellite: streamed ledger generators

class TestGeneratedStreams:
    def test_stream_commit_requests_is_the_references(self):
        def take(gen, n):
            return [(tuple((r.txhash.bytes, r.index) for r in req.refs), req.tx_id.bytes,
                     req.caller, req.expect_conflict)
                    for req in itertools.islice(gen.stream_commit_requests(
                        seed=5, n_states=10**9, double_spend_fraction=0.05), n)]

        port = take(port_generated, 400)
        assert port == take(port_generated, 400) == take(ref_generated, 400)
        assert any(r[3] for r in port) and any(len(r[0]) > 1 for r in port)

    def test_flagged_double_spends_conflict_and_nothing_else(self):
        prov = PORT.notary.InMemoryUniquenessProvider()
        dev = PORT.provider(slots_per_shard=4096, max_probe=32, shadow=False)
        n_conflicts, batch = 0, []
        try:
            for req in port_generated.stream_commit_requests(
                    seed=9, n_states=3000, double_spend_fraction=0.05, max_frontier=64):
                verdict = prov.commit_batch([(list(req.refs), req.tx_id, req.caller)])[0]
                assert (verdict is not None) == req.expect_conflict, req
                n_conflicts += req.expect_conflict
                batch.append(req)
            # the same stream through the scale-mode provider, in batches
            for lo in range(0, len(batch), 256):
                part = batch[lo:lo + 256]
                got = dev.commit_batch([(list(r.refs), r.tx_id, r.caller) for r in part])
                assert [g is not None for g in got] == [r.expect_conflict for r in part]
        finally:
            dev.close()
        assert n_conflicts > 10

    def test_generated_ledger_stream_is_memory_bounded(self):
        gen = port_generated.GeneratedLedger(seed=3, device="cpu")
        ids = []
        for stx in gen.stream(12, max_unspent=6):
            assert stx.sigs
            ids.append(stx.id)
        assert len(ids) == 12
        assert not gen.transactions
        assert len(gen.unspent) <= 6
        # same seed, same stream; the reference's shape under shared entropy
        assert ids == [s.id for s in port_generated.GeneratedLedger(
            seed=3, device="cpu").stream(12, max_unspent=6)]
        ref = ref_generated.GeneratedLedger(seed=4)
        port = port_generated.GeneratedLedger(seed=4, device="cpu",
                                              entropy=random.Random(99))

        def shape(stx):
            return (len(stx.tx.inputs), [o.data.value for o in stx.tx.outputs])

        assert [shape(s) for s in port.stream(10, max_unspent=4)] == \
            [shape(s) for s in ref.stream(10, max_unspent=4)]

    @pytest.mark.slow
    def test_ten_million_state_ledger_scale(self):
        """The streamed generator builds a 10^7-state ledger with bounded
        memory while every request's conflict check runs; every flagged
        double spend is refused and no other request conflicts."""
        prov = PORT.notary.InMemoryUniquenessProvider()
        conflicts = 0
        batch = []

        def settle(batch):
            got = prov.commit_batch([(list(r.refs), r.tx_id, r.caller) for r in batch])
            n = 0
            for r, verdict in zip(batch, got):
                assert (verdict is not None) == r.expect_conflict
                n += r.expect_conflict
            return n
        for req in port_generated.stream_commit_requests(
                seed=2026, n_states=10**7, double_spend_fraction=0.002, max_frontier=8192):
            batch.append(req)
            if len(batch) == 4096:
                conflicts += settle(batch)
                batch = []
        if batch:
            conflicts += settle(batch)
        assert conflicts > 1000
        assert prov.committed_txs() > 10**6


# ---------------------------------------------------- off-by-default pin

class TestOffByDefault:
    def test_fresh_subprocess_zero_overhead(self):
        """A fresh process without ``CORDA_TPU_STATESTORE``: the package
        imports no table code, builds no table and no kernel library,
        registers no ``statestore.*`` metric, the vault attaches no index
        and the section is the off marker."""
        code = """
import json, os, sys
os.environ.pop("CORDA_TPU_STATESTORE", None)
import corda_tpu_torch.statestore as ss
assert not ss.statestore_enabled()
assert "corda_tpu_torch.statestore.table" not in sys.modules
assert ss.statestore_section() == {"enabled": False}
assert ss.maybe_vault_index() is None
from corda_tpu_torch.node import NodeVaultService
from corda_tpu_torch.node.monitoring import monitoring_snapshot, node_metrics
from corda_tpu_torch.ops import _build
vault = NodeVaultService(observe_all=True)
assert vault._state_index is None
assert monitoring_snapshot()["statestore"] == {"enabled": False}
assert not any(n.startswith("statestore.") for n in node_metrics().snapshot())
assert "corda_tpu_torch.statestore.table" not in sys.modules
assert _build._lib is None and _build._host_lib is None
print(json.dumps({"ok": True}))
"""
        env = {k: v for k, v in os.environ.items() if k != "CORDA_TPU_STATESTORE"}
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=120, env=env)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"ok": True}

    def test_env_gate_enables_vault_index_and_notary_reexport(self):
        """``CORDA_TPU_STATESTORE=1`` in a fresh process: the gate reads on,
        ``maybe_vault_index`` builds an index on the device it is given
        (and raises with no card for the default one), a vault builds its
        index on its device, the notary package re-exports the provider,
        and the section reports the tables."""
        code = """
import json
import corda_tpu_torch.statestore as ss
assert ss.statestore_enabled()
idx = ss.maybe_vault_index(device="cpu")
from corda_tpu_torch.statestore import DeviceVaultIndex
assert isinstance(idx, DeviceVaultIndex)
assert idx._table.device.type == "cpu" and idx._table.slots_per_shard == 64
import torch
if not torch.cuda.is_available():
    try:
        ss.maybe_vault_index()
    except RuntimeError as e:
        assert "no CUDA device" in str(e)
    else:
        raise AssertionError("an index for the card was built without one")
from corda_tpu_torch.node import NodeVaultService
vault = NodeVaultService(observe_all=True, device="cpu")
assert vault._state_index is not None
from corda_tpu_torch.notary import DeviceShardedUniquenessProvider
from corda_tpu_torch.statestore import provider as _p
assert DeviceShardedUniquenessProvider is _p.DeviceShardedUniquenessProvider
section = ss.statestore_section()
assert section["enabled"] is True
assert [t["name"] for t in section["tables"]] == ["vault", "vault"]
print(json.dumps({"ok": True}))
"""
        env = dict(os.environ)
        env["CORDA_TPU_STATESTORE"] = "1"
        env["CORDA_TPU_STATESTORE_SLOTS"] = "64"
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=180, env=env)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"ok": True}
