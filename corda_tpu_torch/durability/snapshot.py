"""Atomic snapshots of an owner's full state + WAL high-water mark
(counterpart of corda_tpu/durability/snapshot.py, the same bytes).

A snapshot file ``snap-<lsn>.snap`` holds one CRC-framed blob::

    [TPUSNAP1][covered_lsn u64 BE][payload_len u32 BE][crc32 u32 BE][payload]

``save()`` is the tmp+rename dance: write ``snap-<lsn>.tmp``, flush +
fsync it, ``os.replace`` onto the final name, fsync the directory, THEN
delete older snapshots. A crash at any point (site
``durability.snapshot.rename`` sits between the fsync and the rename)
leaves either the old snapshot set intact (tmp files are ignored and
reaped at the next save/load) or the new snapshot fully in place —
never a half-written current snapshot.

``load()`` returns the newest snapshot that passes its CRC; a corrupt
newest file falls back to the next older one (it can only be corrupt if
something outside the crash model damaged it — the save path never
exposes a partial file under the ``.snap`` name — so recovery prefers
degrading to an older base over refusing to start; the WAL still holds
every record since that older base until compaction, which keys off the
snapshot actually loadable).
"""

from __future__ import annotations

import os
import struct
import zlib

from ..faultinject import crash_point

from .wal import _fsync_dir

SNAP_MAGIC = b"TPUSNAP1"
_SNAP_HEADER = struct.Struct(">8sQII")   # magic, lsn, payload len, crc

SITE_SNAPSHOT_RENAME = "durability.snapshot.rename"


def _snap_name(lsn: int) -> str:
    return f"snap-{lsn:016d}.snap"


class SnapshotStore:
    """One directory of atomic state snapshots (newest wins)."""

    def __init__(self, path: str, metrics=None):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._metrics = metrics

    def _entries(self) -> list[str]:
        return sorted(
            n for n in os.listdir(self.path)
            if n.startswith("snap-") and n.endswith(".snap")
        )

    def save(self, payload: bytes, covered_lsn: int) -> str:
        """Write the snapshot covering every record with LSN ≤
        ``covered_lsn``; returns the final path. Durable before it is
        visible; older snapshots reclaimed only after the new one is
        fully in place."""
        final = os.path.join(self.path, _snap_name(covered_lsn))
        tmp = final + ".tmp"
        blob = _SNAP_HEADER.pack(
            SNAP_MAGIC, covered_lsn, len(payload), zlib.crc32(payload)
        ) + payload
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        crash_point("durability.snapshot.rename")
        os.replace(tmp, final)
        _fsync_dir(self.path)
        if self._metrics is not None:
            self._metrics.counter("durability.snapshots").inc()
        # reclaim: older snapshots and stray tmps of any age — each was
        # fully superseded the instant the rename above became durable
        for name in self._entries():
            if name != _snap_name(covered_lsn):
                full = os.path.join(self.path, name)
                if int(name[5:-5]) < covered_lsn:
                    os.unlink(full)
        for name in os.listdir(self.path):
            if name.endswith(".tmp") and name != os.path.basename(tmp):
                os.unlink(os.path.join(self.path, name))
        return final

    def load(self) -> tuple[bytes, int] | None:
        """Newest valid ``(payload, covered_lsn)``; None when no usable
        snapshot exists (recovery then replays the WAL from LSN 0)."""
        for name in reversed(self._entries()):
            full = os.path.join(self.path, name)
            try:
                data = open(full, "rb").read()
            except OSError:
                continue
            if len(data) < _SNAP_HEADER.size:
                continue
            magic, lsn, length, crc = _SNAP_HEADER.unpack_from(data, 0)
            payload = data[_SNAP_HEADER.size:]
            if (magic != SNAP_MAGIC or len(payload) != length
                    or zlib.crc32(payload) != crc):
                continue
            return payload, lsn
        return None
