"""Persistence: validated-transaction storage and attachment storage
(counterpart of corda_tpu/node/storage.py, copied whole).

Parity with the reference's node/.../services/persistence/ —
``DBTransactionStorage`` (map of tx id → blob with a first-write-wins
guarantee and an updates feed the vault subscribes to) and
``NodeAttachmentService`` (NodeAttachmentService.kt — content-addressed
jar/zip blobs, hash-checked on open). SQLite WAL instead of H2/Hibernate;
callback feeds instead of Rx Observables.
"""

from __future__ import annotations

import hashlib
import io
import sqlite3
import threading
import zipfile

from ..crypto import SecureHash
from ..ledger import SignedTransaction
from ..serialization import deserialize, serialize


class DBTransactionStorage:
    """Append-only validated-transactions map (reference:
    DBTransactionStorage.kt; AppendOnlyPersistentMap semantics — a second
    add of the same id is a no-op returning False)."""

    def __init__(self, path: str = ":memory:"):
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS transactions ("
            " tx_id BLOB PRIMARY KEY, blob BLOB NOT NULL, ts REAL NOT NULL)"
        )
        self._db.commit()
        self._lock = threading.RLock()
        self._subscribers: list = []

    def add_transaction(self, stx: SignedTransaction) -> bool:
        """Record a validated transaction; returns True if newly stored."""
        blob = serialize(stx)
        with self._lock:
            cur = self._db.execute(
                "INSERT OR IGNORE INTO transactions VALUES (?, ?, julianday('now'))",
                (stx.id.bytes, blob),
            )
            self._db.commit()
            fresh = cur.rowcount == 1
            subs = list(self._subscribers)
        if fresh:
            for cb in subs:
                cb(stx)
        return fresh

    def get(self, tx_id: SecureHash) -> SignedTransaction | None:
        with self._lock:
            row = self._db.execute(
                "SELECT blob FROM transactions WHERE tx_id = ?", (tx_id.bytes,)
            ).fetchone()
        return deserialize(row[0]) if row else None

    def __contains__(self, tx_id: SecureHash) -> bool:
        with self._lock:
            row = self._db.execute(
                "SELECT 1 FROM transactions WHERE tx_id = ?", (tx_id.bytes,)
            ).fetchone()
        return row is not None

    def untrack(self, callback) -> None:
        with self._lock:
            try:
                self._subscribers.remove(callback)
            except ValueError:
                pass

    def track(self, callback) -> list[SignedTransaction]:
        """Subscribe to future additions; returns the current snapshot
        (reference: DataFeed<List<SignedTransaction>, SignedTransaction>)."""
        with self._lock:
            rows = self._db.execute(
                "SELECT blob FROM transactions ORDER BY ts"
            ).fetchall()
            self._subscribers.append(callback)
        return [deserialize(r[0]) for r in rows]

    def count(self) -> int:
        with self._lock:
            return self._db.execute("SELECT COUNT(*) FROM transactions").fetchone()[0]

    def close(self) -> None:
        with self._lock:
            self._db.close()


class Attachment:
    """An opened attachment (reference: core/.../contracts/Attachment —
    id + zip access + signer extraction is out of scope pre-v3)."""

    def __init__(self, attachment_id: SecureHash, data: bytes):
        self.id = attachment_id
        self.data = data

    def open_zip(self) -> zipfile.ZipFile:
        return zipfile.ZipFile(io.BytesIO(self.data))

    def extract_file(self, name: str) -> bytes:
        with self.open_zip() as z:
            return z.read(name)

    @property
    def size(self) -> int:
        return len(self.data)


class AttachmentStorage:
    """Content-addressed attachment store (reference:
    NodeAttachmentService.kt — import computes SHA-256 id, duplicate import
    raises, open re-verifies the hash)."""

    class DuplicateAttachmentError(Exception):
        pass

    class CorruptAttachmentError(Exception):
        pass

    def __init__(self, path: str = ":memory:"):
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS attachments ("
            " att_id BLOB PRIMARY KEY, data BLOB NOT NULL)"
        )
        self._db.commit()
        self._lock = threading.RLock()

    def import_attachment(self, data: bytes) -> SecureHash:
        att_id = SecureHash(hashlib.sha256(data).digest())
        with self._lock:
            cur = self._db.execute(
                "INSERT OR IGNORE INTO attachments VALUES (?, ?)",
                (att_id.bytes, data),
            )
            self._db.commit()
            if cur.rowcount == 0:
                raise AttachmentStorage.DuplicateAttachmentError(str(att_id))
        return att_id

    def import_or_get(self, data: bytes) -> SecureHash:
        try:
            return self.import_attachment(data)
        except AttachmentStorage.DuplicateAttachmentError:
            return SecureHash(hashlib.sha256(data).digest())

    def open_attachment(self, att_id: SecureHash) -> Attachment | None:
        with self._lock:
            row = self._db.execute(
                "SELECT data FROM attachments WHERE att_id = ?", (att_id.bytes,)
            ).fetchone()
        if row is None:
            return None
        if hashlib.sha256(row[0]).digest() != att_id.bytes:
            raise AttachmentStorage.CorruptAttachmentError(str(att_id))
        return Attachment(att_id, row[0])

    def has_attachment(self, att_id: SecureHash) -> bool:
        with self._lock:
            return (
                self._db.execute(
                    "SELECT 1 FROM attachments WHERE att_id = ?", (att_id.bytes,)
                ).fetchone()
                is not None
            )

    def close(self) -> None:
        with self._lock:
            self._db.close()


def make_test_attachment(files: dict[str, bytes]) -> bytes:
    """Build a deterministic zip (fixed timestamps) — the attachment-demo
    fixture shape."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for name in sorted(files):
            info = zipfile.ZipInfo(name, date_time=(2017, 1, 1, 0, 0, 0))
            z.writestr(info, files[name])
    return buf.getvalue()
