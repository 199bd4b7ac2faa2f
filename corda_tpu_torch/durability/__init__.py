"""Crash-consistent durable node state (counterpart of
corda_tpu/durability; docs/DURABILITY.md).

Everything *authoritative* above the serving plane — the notary's
consumed-set, flow checkpoints, the vault's state pages — was an
in-memory (or ``:memory:``-SQLite) map a process crash erased. This
package is the host-side persistent tier behind them (ROADMAP item 4):

- ``wal`` — length-prefixed, CRC-framed, fsync-batched write-ahead log
  (group commit; torn tails discarded on replay, corrupt interior
  records a hard error);
- ``snapshot`` — atomic tmp+rename full-state snapshots carrying the
  WAL high-water mark;
- ``store`` — the per-owner facade (append/flush/recover/snapshot +
  compaction) and the ``durability`` monitoring section.

OFF by default with zero overhead: nothing here is imported on the hot
path until an owner constructs a store, no files are opened, no threads
exist (group commit runs on the calling thread), and no metrics are
created. An owner opts in by being given a ``DurableStore``
(``DurableUniquenessProvider``, ``WalCheckpointStorage``,
``NodeVaultService(journal=…)``). ``CORDA_TPU_FSYNC_BATCH`` bounds the
records one group-commit fsync may cover.

Not ported yet: the reference's process-wide switches
``CORDA_TPU_DURABILITY`` and ``CORDA_TPU_WAL_DIR`` with ``store_for``,
which only the reference's node startup (``node/node.py``) consults; they
come with that container (ROADMAP.md, Queue 1 step 9).
"""

from __future__ import annotations

from .snapshot import SITE_SNAPSHOT_RENAME, SnapshotStore
from .store import DurableStore, RecoveryReport, durability_section
from .wal import (
    SITE_POST_FSYNC,
    SITE_PRE_FSYNC,
    WalCorruptionError,
    WriteAheadLog,
)


__all__ = [
    "DurableStore",
    "RecoveryReport",
    "SITE_POST_FSYNC",
    "SITE_PRE_FSYNC",
    "SITE_SNAPSHOT_RENAME",
    "SnapshotStore",
    "WalCorruptionError",
    "WriteAheadLog",
    "durability_section",
]
