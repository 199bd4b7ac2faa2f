"""The write-ahead log: length-prefixed, CRC-framed, fsync-batched
(counterpart of corda_tpu/durability/wal.py; its log bytes are the
reference's, so either package replays a log the other wrote).

One log = one directory of segment files ``wal-<seq>.seg``. Each segment
opens with a 16-byte header (``TPUWAL01`` magic + base LSN, big-endian)
and then holds records back to back::

    [payload_len u32 BE][crc32(payload) u32 BE][payload bytes]

LSNs (log sequence numbers) are the global record ordinals: record ``k``
of a segment with base ``B`` has LSN ``B + k``. A snapshot stores the
high-water LSN it covers; recovery replays strictly greater LSNs.

**Group commit.** ``append()`` buffers the record into the OS (a
``write(2)``, no fsync) and returns its LSN; ``flush()`` makes every
appended record durable with ONE ``fsync`` shared by however many
appends accumulated — the notary acks a whole window after one flush,
not one fsync per transaction. Concurrent flushers coalesce: a thread
whose records are already covered by an in-flight fsync waits for that
fsync instead of issuing its own. ``fsync_batch`` (env
``CORDA_TPU_FSYNC_BATCH``) additionally auto-flushes once that many
records are waiting, bounding the unflushed window under a caller that
forgets to flush.

**Torn tails vs corruption.** Replay distinguishes the two on purpose
(docs/DURABILITY.md): damage that a crash mid-append can explain — a
partially framed record at the physical end of the NEWEST segment, or a
CRC-bad final record there — is a *torn tail*: those bytes were never
acked (the flush they belonged to never returned), so they are silently
truncated away and counted (``replay.torn_records``). Damage anywhere
else — a CRC-bad record with durable records after it, or any defect in
an older segment — cannot be a crash artifact: something rewrote acked
history, and replay raises ``WalCorruptionError`` instead of silently
skipping (a notary that "recovers" past a corrupt consumed-set record
re-admits spent states).

Crash sites (``faultinject`` plan mode ``crash_sites``): ``flush()``
passes ``durability.wal.pre_fsync`` just before and
``durability.wal.post_fsync`` just after the fsync — the two sides of
the ack boundary the kill-storm harness must prove equivalent-or-safe.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib

from ..faultinject import crash_point
from ..observability.contention import register_wait_site

# the sampler's blocked/running classifier (concurrency observatory): a
# thread sampled inside the group-commit flush is waiting on disk (its
# own fsync, or the in-flight fsync covering its records) — io-wait,
# even though the blocked frame underneath is threading.py's cv.wait
register_wait_site("wal.py", "flush", "io_wait")
register_wait_site("wal.py", "_flush_inner", "io_wait")

MAGIC = b"TPUWAL01"
_HEADER = struct.Struct(">8sQ")       # magic, base LSN
_FRAME = struct.Struct(">II")         # payload len, crc32
SEGMENT_MAX_BYTES_DEFAULT = 4 << 20
FSYNC_BATCH_DEFAULT = 64

SITE_PRE_FSYNC = "durability.wal.pre_fsync"
SITE_POST_FSYNC = "durability.wal.post_fsync"


class WalCorruptionError(Exception):
    """Acked history is damaged (CRC-bad interior record, bad segment
    header, missing segment range) — a hard integrity error, never
    silently skipped."""


def _segment_name(seq: int) -> str:
    return f"wal-{seq:08d}.seg"


def _list_segments(path: str) -> list[str]:
    try:
        names = os.listdir(path)
    except FileNotFoundError:
        return []
    return sorted(
        n for n in names if n.startswith("wal-") and n.endswith(".seg")
    )


def _fsync_dir(path: str) -> None:
    """Make a rename/create/unlink in ``path`` durable (no-op on
    platforms whose directory handles refuse fsync)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class _ScanResult:
    __slots__ = ("records", "next_lsn", "torn", "tail_name",
                 "tail_good_size", "first_base")

    def __init__(self):
        self.records: list[tuple[int, bytes]] = []   # (lsn, payload)
        self.next_lsn = 0
        self.torn = 0                 # torn tail records discarded
        self.tail_name: str | None = None
        self.tail_good_size = 0       # valid byte length of the tail segment
        self.first_base: int | None = None  # base LSN of the oldest segment


def _scan_segment(path: str, name: str, is_last: bool, out: _ScanResult):
    data = open(os.path.join(path, name), "rb").read()
    if len(data) < _HEADER.size:
        if is_last:
            # crash during roll: the new segment's header never landed —
            # nothing in it was ever appended, let alone acked
            out.torn += 1 if data else 0
            out.tail_name, out.tail_good_size = name, 0
            return
        raise WalCorruptionError(f"{name}: truncated segment header")
    magic, base = _HEADER.unpack_from(data, 0)
    if magic != MAGIC:
        raise WalCorruptionError(f"{name}: bad segment magic {magic!r}")
    if out.first_base is None:
        out.first_base = base
    if out.next_lsn and base != out.next_lsn:
        raise WalCorruptionError(
            f"{name}: base LSN {base} does not continue the log at "
            f"{out.next_lsn} (missing or reordered segment)"
        )
    lsn = base
    off = _HEADER.size
    parsed: list[tuple[int, bytes, int]] = []  # (lsn, payload, end_off)
    defect_at: int | None = None
    while off < len(data):
        if off + _FRAME.size > len(data):
            defect_at = off            # partial frame header
            break
        length, crc = _FRAME.unpack_from(data, off)
        if length == 0:
            # append() forbids empty payloads, so a zero frame is damage
            # — an 8-byte zero run would otherwise parse as a "valid"
            # record (crc32(b"") == 0) and mint ghost LSNs from a torn
            # tail the filesystem zero-padded
            defect_at = off
            break
        end = off + _FRAME.size + length
        if end > len(data):
            defect_at = off            # partial payload
            break
        payload = data[off + _FRAME.size:end]
        if zlib.crc32(payload) != crc:
            defect_at = off            # CRC mismatch: torn iff final
            break
        parsed.append((lsn, payload, end))
        lsn += 1
        off = end
    if defect_at is not None:
        if not is_last:
            raise WalCorruptionError(
                f"{name}: defective record at offset {defect_at} in a "
                "non-final segment — acked history is damaged"
            )
        # final segment: the defect is a torn tail only if NOTHING valid
        # follows it (a valid record after a CRC-bad one means interior
        # corruption — the later record proves the log continued past it)
        # look for any validly-framed, CRC-valid record after the defect
        # (scanning every offset — a corrupt LENGTH field must not hide
        # the durable records behind it). Zero-length frames are excluded
        # exactly as in the main parse: crc32(b"") == 0, so any 8-byte
        # zero run inside a torn record would otherwise read as a
        # "durable record after the defect" and turn a legitimate crash
        # artifact into a hard corruption error. Nonempty false hits on
        # garbage remain astronomically unlikely.
        scan = defect_at + 1
        while scan + _FRAME.size <= len(data):
            l2, c2 = _FRAME.unpack_from(data, scan)
            e2 = scan + _FRAME.size + l2
            if (l2 > 0 and e2 <= len(data)
                    and zlib.crc32(data[scan + _FRAME.size:e2]) == c2):
                raise WalCorruptionError(
                    f"{name}: CRC-corrupt interior record at offset "
                    f"{defect_at} with durable records after it"
                )
            scan += 1
        out.torn += 1
    for rec_lsn, payload, _end in parsed:
        out.records.append((rec_lsn, payload))
    out.next_lsn = lsn
    if is_last:
        out.tail_name = name
        out.tail_good_size = parsed[-1][2] if parsed else _HEADER.size


class WriteAheadLog:
    """One crash-consistent record log (see module docstring)."""

    def __init__(self, path: str, *,
                 segment_max_bytes: int = SEGMENT_MAX_BYTES_DEFAULT,
                 fsync_batch: int | None = None, metrics=None):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._segment_max = max(int(segment_max_bytes), _HEADER.size + 1)
        if fsync_batch is None:
            fsync_batch = int(
                os.environ.get("CORDA_TPU_FSYNC_BATCH", FSYNC_BATCH_DEFAULT)
            )
        self._fsync_batch = max(int(fsync_batch), 1)
        self._metrics = metrics
        # ONE condition guards every mutable field (its lock) and carries
        # the group-commit waiter wakeups — a single lock name keeps the
        # discipline checkable
        self._cv = threading.Condition()
        self._fsync_running = False
        self._file = None
        self._file_size = 0
        self._seg_seq = 0
        self._recovered: list[tuple[int, bytes]] = []
        self.torn_discarded = 0
        self.next_lsn = 0           # next LSN append() hands out
        self.durable_lsn = -1       # highest LSN covered by an fsync
        self._written_lsn = -1      # highest LSN written to the OS
        with self._cv:
            self._open_locked()

    # ---------------------------------------------------------------- open
    def _open_locked(self) -> None:
        segs = _list_segments(self.path)
        scan = _ScanResult()
        for i, name in enumerate(segs):
            _scan_segment(self.path, name, i == len(segs) - 1, scan)
        self._recovered = scan.records
        self.torn_discarded = scan.torn
        # base LSN of the oldest surviving segment: > 0 means earlier
        # records were compacted away under a snapshot — recovery must
        # find that snapshot or refuse to start (DurableStore.recover)
        self.compacted_base = scan.first_base or 0
        self.next_lsn = scan.next_lsn
        self.durable_lsn = scan.next_lsn - 1
        self._written_lsn = self.durable_lsn
        if scan.tail_name is not None and scan.tail_good_size >= _HEADER.size:
            # reopen the tail for append, truncating any torn bytes away.
            # buffering=0 everywhere: every append is a real write(2), so
            # an abandoned handle (simulated crash — the object is dropped,
            # never closed) can never flush stale userspace bytes into a
            # log a restarted store is already appending to
            full = os.path.join(self.path, scan.tail_name)
            self._file = open(full, "r+b", buffering=0)
            self._file.truncate(scan.tail_good_size)
            self._file.seek(scan.tail_good_size)
            self._file_size = scan.tail_good_size
            self._seg_seq = int(scan.tail_name[4:-4])
        else:
            if scan.tail_name is not None:
                # headerless torn tail file: a crash mid-roll — remove it
                os.unlink(os.path.join(self.path, scan.tail_name))
                _fsync_dir(self.path)
            self._seg_seq = int(segs[-1][4:-4]) + 1 if segs else 0
            self._start_segment_locked()

    def _start_segment_locked(self) -> None:
        name = _segment_name(self._seg_seq)
        f = open(os.path.join(self.path, name), "xb", buffering=0)
        f.write(_HEADER.pack(MAGIC, self.next_lsn))
        os.fsync(f.fileno())
        _fsync_dir(self.path)
        self._file = f
        self._file_size = _HEADER.size

    def recovered_records(self) -> list[tuple[int, bytes]]:
        """Every durable ``(lsn, payload)`` found at open, in order; the
        owner replays these through its apply function then drops them."""
        out, self._recovered = self._recovered, []
        return out

    # -------------------------------------------------------------- append
    def append(self, payload: bytes) -> int:
        """Buffer one record (OS write, no fsync) and return its LSN. The
        record is NOT durable until a ``flush()`` covering it returns —
        ack nothing before that. Empty payloads are rejected: a
        zero-length frame's CRC is 0, so replay could not tell one from
        a zero-padded torn tail."""
        if not payload:
            raise ValueError("WAL records must be non-empty")
        with self._cv:
            if self._file is None:
                raise ValueError("write-ahead log is closed")
            if self._file_size >= self._segment_max:
                # never roll (close + fsync the old file) while a group
                # commit is mid-fsync on that same file object — and
                # re-check fullness after the wait: a rival appender may
                # have rolled already (an unconditional roll here would
                # fsync+abandon a freshly-created, near-empty segment)
                while self._fsync_running and \
                        self._file_size >= self._segment_max:
                    self._cv.wait()
                if self._file_size >= self._segment_max:
                    self._roll_locked()
            lsn = self.next_lsn
            frame = _FRAME.pack(len(payload), zlib.crc32(payload))
            self._file.write(frame + payload)
            self._file_size += len(frame) + len(payload)
            self.next_lsn = lsn + 1
            self._written_lsn = lsn
            if self._metrics is not None:
                self._metrics.counter("durability.wal_records").inc()
                self._metrics.counter("durability.wal_bytes").inc(
                    len(frame) + len(payload)
                )
            auto = (self._written_lsn - self.durable_lsn) >= self._fsync_batch
        if auto:
            self.flush()
        return lsn

    def _roll_locked(self) -> None:
        f = self._file
        f.flush()
        os.fsync(f.fileno())
        f.close()
        self.durable_lsn = self._written_lsn
        self._seg_seq += 1
        self._start_segment_locked()

    # --------------------------------------------------------------- flush
    def flush(self) -> None:
        """Group commit: make every record appended so far durable. One
        fsync covers all waiters — a thread arriving while an fsync is in
        flight waits for a *subsequent* fsync only if its records were
        appended after that fsync started."""
        from ..observability.flowprof import flowprof_frame

        # io_wait is this frame's declared cause: the wall here is fsync
        # (or waiting on another thread's fsync), so the phase's cause
        # split is exact evidence, not a sampled estimate
        with flowprof_frame("wal_fsync_wait", cause="io_wait"):
            self._flush_inner()

    def _flush_inner(self) -> None:
        with self._cv:
            want = self._written_lsn
            while self.durable_lsn < want:
                if self._fsync_running:
                    self._cv.wait()
                    continue
                self._fsync_running = True
                f = self._file
                covered = self._written_lsn
                try:
                    f.flush()
                    self._cv.release()
                    try:
                        crash_point("durability.wal.pre_fsync")
                        if self._metrics is not None:
                            with self._metrics.timer(
                                "durability.wal_fsync_s"
                            ).time():
                                os.fsync(f.fileno())
                        else:
                            os.fsync(f.fileno())
                        crash_point("durability.wal.post_fsync")
                    finally:
                        self._cv.acquire()
                    self.durable_lsn = max(self.durable_lsn, covered)
                finally:
                    self._fsync_running = False
                    self._cv.notify_all()

    # ------------------------------------------------------------- compact
    def compact(self, upto_lsn: int) -> int:
        """Reclaim whole segments whose every record has LSN ≤ ``upto_lsn``
        (they are covered by a snapshot). The live tail segment is never
        reclaimed. Returns the number of segment files removed. Idempotent
        — a crash mid-reclaim (site ``durability.compact``) leaves some
        stale segments behind; the next compact (or the next open, which
        replays them into already-snapshotted state: apply is idempotent)
        removes them."""
        with self._cv:
            segs = _list_segments(self.path)
            current = _segment_name(self._seg_seq)
            next_lsn = self.next_lsn
        # everything below runs OFF the lock: the victims are sealed
        # segments no append/flush will ever touch again, and concurrent
        # compacts are serialized by the owning store's snapshot lock —
        # header reads, unlinks and the directory fsync must not stall
        # rival committers' group commits
        bases: list[int] = []
        for name in segs:
            try:
                with open(os.path.join(self.path, name), "rb") as f:
                    head = f.read(_HEADER.size)
            except FileNotFoundError:
                head = b""  # reclaimed by an earlier crash-interrupted pass
            bases.append(
                _HEADER.unpack(head)[1] if len(head) == _HEADER.size
                else next_lsn
            )
        removed = 0
        for i, name in enumerate(segs):
            if name == current:
                break
            # a segment is reclaimable when the NEXT segment's base LSN
            # is ≤ upto_lsn + 1 (so every record it holds is ≤ upto_lsn)
            nxt_base = bases[i + 1] if i + 1 < len(bases) else next_lsn
            if nxt_base - 1 > upto_lsn:
                break
            crash_point("durability.compact")
            os.unlink(os.path.join(self.path, name))
            removed += 1
        if removed:
            _fsync_dir(self.path)
            if self._metrics is not None:
                self._metrics.counter("durability.compactions").inc()
        return removed

    def close(self) -> None:
        with self._cv:
            # never close the file under a group commit mid-fsync on it
            while self._fsync_running:
                self._cv.wait()
            if self._file is not None:
                try:
                    self._file.flush()
                    os.fsync(self._file.fileno())
                except OSError:
                    pass
                self._file.close()
                self._file = None
                # a late flush() on a closed log must be a no-op, not an
                # attribute error on the dead handle
                self.durable_lsn = self._written_lsn
