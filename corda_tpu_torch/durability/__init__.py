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
records one group-commit fsync may cover. The node container
(``node/node.py``) opts in process-wide through ``CORDA_TPU_DURABILITY``
and ``CORDA_TPU_WAL_DIR`` with ``store_for``.
"""

from __future__ import annotations

import os

from .snapshot import SITE_SNAPSHOT_RENAME, SnapshotStore
from .store import DurableStore, RecoveryReport, durability_section
from .wal import (
    SITE_POST_FSYNC,
    SITE_PRE_FSYNC,
    WalCorruptionError,
    WriteAheadLog,
)


def durability_enabled() -> bool:
    """The process-wide opt-in: ``CORDA_TPU_DURABILITY=1`` (any value
    but empty/0)."""
    return os.environ.get("CORDA_TPU_DURABILITY", "0") not in ("", "0")


def store_for(owner: str, base_dir: str | None = None) -> DurableStore | None:
    """A DurableStore for one named state owner under the configured
    base directory, or None when durability is off (the default: no
    files, no metrics, nothing constructed). ``base_dir`` overrides
    ``CORDA_TPU_WAL_DIR``; enabling durability without a directory from
    either source is a configuration error worth failing loudly on."""
    if not durability_enabled():
        return None
    base = base_dir or os.environ.get("CORDA_TPU_WAL_DIR", "")
    if not base:
        raise ValueError(
            "CORDA_TPU_DURABILITY is set but no WAL directory is "
            "configured (set CORDA_TPU_WAL_DIR)"
        )
    return DurableStore(os.path.join(base, owner), name=owner)


__all__ = [
    "DurableStore",
    "RecoveryReport",
    "SITE_POST_FSYNC",
    "SITE_PRE_FSYNC",
    "SITE_SNAPSHOT_RENAME",
    "SnapshotStore",
    "WalCorruptionError",
    "WriteAheadLog",
    "durability_enabled",
    "durability_section",
    "store_for",
]
