"""DurableStore: one state owner's WAL + snapshot pair, plus recovery
(counterpart of corda_tpu/durability/store.py).

The facade the three state owners (notary uniqueness, flow checkpoints,
vault) build on. One directory per owner::

    <base>/<owner>/wal/   — segment files (wal.py)
    <base>/<owner>/snap/  — atomic snapshots (snapshot.py)

Contract (docs/DURABILITY.md):

- ``append(record)`` serializes one CBE record into the WAL;
  ``flush()`` group-commits everything appended so far. The owner must
  flush BEFORE completing any client-visible future/ack for the state
  the record carries (the reference's ``durability-ack-order`` lint pass
  checks this; the port's analysis passes come with ROADMAP.md Queue 1
  step 9).
- ``recover(apply_fn, load_snapshot_fn)`` = newest valid snapshot +
  WAL replay of strictly newer records. Both callbacks must be
  idempotent: a crash during snapshot or compaction leaves records in
  the WAL that the snapshot already covers, and the NEXT recovery
  replays them again on top of the snapshot.
- ``snapshot(state_obj)`` flushes, writes the snapshot at the durable
  high-water mark, then compacts fully-covered WAL segments.
  ``note_appended`` + ``snapshot_due()`` give owners a cheap
  every-N-records trigger.

Metrics land in the process registry (``node/monitoring.py``)
ONLY once a store exists — durability off means zero ``durability.*`` /
``replay.*`` / ``recovery.*`` metrics, zero files, zero threads (the
store never spawns any; group commit runs on the calling thread).
"""

from __future__ import annotations

import os
import threading
import time

from ..serialization import deserialize, serialize

from .snapshot import SnapshotStore
from .wal import WalCorruptionError, WriteAheadLog

SNAPSHOT_EVERY_DEFAULT = 4096

# process-wide "has any store ever been active" latch: monitoring_snapshot
# shows {"enabled": false} — and creates nothing — until the first store
_active_lock = threading.Lock()
_active_stores = 0
_ever_active = False


def _mark_active(delta: int) -> None:
    global _active_stores, _ever_active
    with _active_lock:
        _active_stores += delta
        _ever_active = _ever_active or _active_stores > 0


def durability_section() -> dict:
    """The ``durability`` section of ``monitoring_snapshot()`` and every
    flight dump: ``{"enabled": false}`` until the first DurableStore
    exists in the process (no metrics are created before that), then the
    WAL/replay/recovery registries."""
    with _active_lock:
        if not _ever_active:
            return {"enabled": False}
        open_stores = _active_stores
    from ..node.monitoring import node_metrics

    reg = node_metrics()
    return {
        "enabled": True,
        "open_stores": open_stores,
        "wal": reg.section("durability."),
        "replay": reg.section("replay."),
        "recovery": reg.section("recovery."),
    }


class RecoveryReport:
    """What one ``recover()`` found: replayed/torn record counts, the
    snapshot base it started from, and the wall it took."""

    __slots__ = ("replayed", "torn", "snapshot_lsn", "wall_s")

    def __init__(self, replayed: int, torn: int, snapshot_lsn: int,
                 wall_s: float):
        self.replayed = replayed
        self.torn = torn
        self.snapshot_lsn = snapshot_lsn
        self.wall_s = wall_s

    def __repr__(self):
        return (f"RecoveryReport(replayed={self.replayed}, "
                f"torn={self.torn}, snapshot_lsn={self.snapshot_lsn}, "
                f"wall_s={self.wall_s:.4f})")


class DurableStore:
    """One owner's crash-consistent journal (see module docstring)."""

    def __init__(self, path: str, *, name: str = "store",
                 snapshot_every: int = SNAPSHOT_EVERY_DEFAULT,
                 segment_max_bytes: int | None = None,
                 fsync_batch: int | None = None):
        from ..node.monitoring import node_metrics

        self.path = path
        self.name = name
        self._metrics = node_metrics()
        wal_kwargs = {"fsync_batch": fsync_batch, "metrics": self._metrics}
        if segment_max_bytes is not None:
            wal_kwargs["segment_max_bytes"] = segment_max_bytes
        self.wal = WriteAheadLog(os.path.join(path, "wal"), **wal_kwargs)
        self.snapshots = SnapshotStore(
            os.path.join(path, "snap"), metrics=self._metrics
        )
        # latch the process-global enabled marker only once the store
        # actually exists (a WAL that failed to open must not flip it)
        _mark_active(+1)
        self._snapshot_every = max(int(snapshot_every), 1)
        self._since_snapshot = 0
        # serializes snapshot()+compact(): two concurrent snapshot_due
        # committers must never interleave writes into one tmp file or
        # reap each other's in-flight tmp
        self._snapshot_lock = threading.Lock()
        self._closed = False

    # ------------------------------------------------------------ writing
    def append(self, record) -> int:
        """Serialize + append one record; NOT durable until ``flush()``."""
        # advisory snapshot-cadence counter, deliberately lock-free on
        # the append hot path: a racy lost increment only defers the
        # next snapshot trigger by one record, never correctness
        self._since_snapshot += 1
        return self.wal.append(serialize(record))

    def flush(self) -> None:
        self.wal.flush()

    # ----------------------------------------------------------- recovery
    def recover(self, apply_fn, load_snapshot_fn=None) -> RecoveryReport:
        """Newest valid snapshot (``load_snapshot_fn(state_obj)``) + WAL
        replay of strictly newer records (``apply_fn(record)``). Both
        callbacks must be idempotent; ``apply_fn`` sees records in LSN
        order. Counted in ``replay.records`` / ``replay.torn_records``
        and timed into ``recovery.wall_s``."""
        t0 = time.perf_counter()
        snap_lsn = -1
        snap = self.snapshots.load()
        if snap is not None:
            payload, snap_lsn = snap
            if load_snapshot_fn is not None:
                load_snapshot_fn(deserialize(payload))
        if self.wal.compacted_base > snap_lsn + 1:
            # segments below the oldest survivor were reclaimed under a
            # snapshot this recovery cannot load (deleted/corrupted
            # outside the crash model): starting from partial state
            # would silently forget acked commits — refuse instead
            raise WalCorruptionError(
                f"{self.name}: WAL records below LSN "
                f"{self.wal.compacted_base} were compacted under a "
                f"snapshot that no longer loads (best loadable base: "
                f"{snap_lsn})"
            )
        replayed = 0
        for lsn, payload in self.wal.recovered_records():
            if lsn <= snap_lsn:
                continue  # covered by the snapshot (compaction pending)
            apply_fn(deserialize(payload))
            replayed += 1
        wall = time.perf_counter() - t0
        self._metrics.counter("replay.records").inc(replayed)
        if self.wal.torn_discarded:
            self._metrics.counter("replay.torn_records").inc(
                self.wal.torn_discarded
            )
        self._metrics.timer("recovery.wall_s").update(wall)
        return RecoveryReport(
            replayed, self.wal.torn_discarded, snap_lsn, wall
        )

    # ----------------------------------------------------------- snapshot
    def snapshot_due(self) -> bool:
        return self._since_snapshot >= self._snapshot_every

    def snapshot(self, state_obj, covered_lsn: int | None = None) -> int:
        """Flush, snapshot the owner's state, compact covered segments.
        Returns the covered LSN. Crash-safe at every step: mid-write
        leaves only a tmp file, mid-rename leaves the old snapshot,
        mid-compact leaves stale segments the next recovery replays
        idempotently (and the next compact reclaims).

        ``covered_lsn`` MUST be the LSN of the last record the owner
        knows ``state_obj`` reflects, captured under the same lock that
        guards its appends — a record appended between that capture and
        this call would otherwise be claimed covered-but-absent and then
        compacted away, forgetting an acked commit. Smaller-than-actual
        values are always safe (the extra records replay idempotently
        over the snapshot); ``None`` (the durable high-water mark at
        flush time) is only sound when the caller holds exclusive
        ownership of the store for the whole capture+snapshot."""
        with self._snapshot_lock:
            self.wal.flush()
            covered = (
                self.wal.durable_lsn if covered_lsn is None else covered_lsn
            )
            if covered < 0:
                return -1  # nothing durable to cover yet
            self.snapshots.save(serialize(state_obj), covered)
            self._since_snapshot = 0
            self.wal.compact(covered)
            return covered

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self.wal.close()
            _mark_active(-1)
