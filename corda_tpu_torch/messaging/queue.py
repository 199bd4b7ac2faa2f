"""Durable queues with at-least-once delivery
(counterpart of corda_tpu/messaging/queue.py, copied whole).

The Artemis-role engine (SURVEY.md §2.10): named queues, competing
consumers, explicit ack, visibility-timeout redelivery (un-acked work
returns to the queue — the property that makes verifier workers elastically
replaceable, VerifierTests.kt:75), and publisher-side dedupe by message id
(the processed-message table of NodeMessagingClient.kt:187,429-439).

Persistence is an append-only sqlite journal per broker (`:memory:` for
tests): enqueue/ack are the only write ops, both single-statement
transactions. The same schema is the contract for the C++ engine that can
replace this module under the identical Python interface.
"""

from __future__ import annotations

import dataclasses
import secrets
import sqlite3
import threading
import time


class QueueClosedError(Exception):
    pass


@dataclasses.dataclass(frozen=True)
class Message:
    """An opaque payload with routing + dedupe metadata."""

    queue: str
    payload: bytes
    msg_id: str                 # globally unique; dedupe key
    sender: str = ""
    reply_to: str = ""          # queue name for responses (VerifierApi pattern)
    enqueued_at: float = 0.0
    redelivered: bool = False

    @staticmethod
    def fresh_id() -> str:
        return secrets.token_hex(16)


class DurableQueueBroker:
    """All queues of one host process; thread-safe.

    ``consume(queue)`` leases the oldest available message to the caller for
    ``visibility_s`` seconds; ``ack(msg_id)`` deletes it; an expired lease
    returns the message to the queue flagged ``redelivered`` (at-least-once,
    like Artemis redelivery on consumer death). ``publish`` is idempotent on
    ``msg_id``.
    """

    ACKED_CACHE_MAX = 100_000  # Artemis-style bounded duplicate-ID cache

    def __init__(self, path: str = ":memory:", visibility_s: float = 30.0,
                 fault_injector=None):
        self._visibility_s = visibility_s
        # seeded chaos hooks (faultinject.plan): publish-time loss and
        # forced immediate redelivery; None in production
        self._fault_injector = fault_injector
        self._lock = threading.Condition()
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute(
            """CREATE TABLE IF NOT EXISTS messages (
                 seq INTEGER PRIMARY KEY AUTOINCREMENT,
                 queue TEXT NOT NULL,
                 msg_id TEXT NOT NULL UNIQUE,
                 payload BLOB NOT NULL,
                 sender TEXT NOT NULL,
                 reply_to TEXT NOT NULL,
                 enqueued_at REAL NOT NULL,
                 leased_until REAL,
                 delivery_count INTEGER NOT NULL DEFAULT 0
               )"""
        )
        self._db.execute(
            "CREATE INDEX IF NOT EXISTS idx_queue ON messages(queue, seq)"
        )
        # acked ids persist so a crash-replayed duplicate of an already
        # processed message is dropped even after its row is deleted —
        # BOUNDED like Artemis's circular duplicate-ID cache (rowid FIFO)
        self._db.execute(
            """CREATE TABLE IF NOT EXISTS acked_ids (
                 rid INTEGER PRIMARY KEY AUTOINCREMENT,
                 msg_id TEXT UNIQUE)"""
        )
        self._db.commit()
        self._closed = False
        self._acks_since_trim = 0

    # ------------------------------------------------------------ publish
    def publish(
        self,
        queue: str,
        payload: bytes,
        *,
        msg_id: str | None = None,
        sender: str = "",
        reply_to: str = "",
    ) -> str:
        """Enqueue; duplicate msg_id is a silent no-op (dedupe)."""
        msg_id = msg_id or Message.fresh_id()
        inj = self._fault_injector
        if inj is not None and inj.on_broker_publish(queue, msg_id):
            # injected wire loss before the journal: the caller believes
            # the publish landed — recovery is the publisher's retry (the
            # pinned msg id makes the eventual duplicate a dedupe no-op)
            return msg_id
        with self._lock:
            self._check_open()
            self._db.execute(
                """INSERT OR IGNORE INTO messages
                   (queue, msg_id, payload, sender, reply_to, enqueued_at)
                   SELECT ?,?,?,?,?,?
                   WHERE NOT EXISTS (
                     SELECT 1 FROM acked_ids WHERE msg_id=?
                   )""",
                (queue, msg_id, payload, sender, reply_to, time.time(),
                 msg_id),
            )
            self._db.commit()
            self._lock.notify_all()
        return msg_id

    # ------------------------------------------------------------ consume
    def consume(self, queue: str, timeout: float | None = None) -> Message | None:
        """Lease the next message from ``queue``; None on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                self._check_open()
                row = self._try_lease(queue)
                if row is not None:
                    return row
                wait = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if wait is not None and wait <= 0:
                    return None
                # wake periodically so expired leases are re-offered even
                # with no new publishes
                self._lock.wait(timeout=min(wait or 0.5, 0.5))

    def _try_lease(self, queue: str) -> Message | None:
        now = time.time()
        cur = self._db.execute(
            """SELECT seq, msg_id, payload, sender, reply_to, enqueued_at,
                      delivery_count
               FROM messages
               WHERE queue=? AND (leased_until IS NULL OR leased_until < ?)
               ORDER BY seq LIMIT 1""",
            (queue, now),
        )
        row = cur.fetchone()
        if row is None:
            return None
        seq, msg_id, payload, sender, reply_to, enq, dcount = row
        inj = self._fault_injector
        lease_until = now + self._visibility_s
        if inj is not None and inj.on_broker_deliver(queue, msg_id):
            # injected duplicate: deliver but leave the row leasable, so
            # the next consume redelivers it immediately (a forced
            # visibility-timeout expiry — consumers must be idempotent)
            lease_until = now
        self._db.execute(
            "UPDATE messages SET leased_until=?, delivery_count=? WHERE seq=?",
            (lease_until, dcount + 1, seq),
        )
        self._db.commit()
        return Message(
            queue=queue,
            payload=payload,
            msg_id=msg_id,
            sender=sender,
            reply_to=reply_to,
            enqueued_at=enq,
            redelivered=dcount > 0,
        )

    def ack(self, msg_id: str) -> None:
        with self._lock:
            self._check_open()
            self._db.execute("DELETE FROM messages WHERE msg_id=?", (msg_id,))
            self._db.execute(
                "INSERT OR IGNORE INTO acked_ids (msg_id) VALUES (?)",
                (msg_id,),
            )
            self._acks_since_trim += 1
            if self._acks_since_trim >= 4096:
                self._acks_since_trim = 0
                self._db.execute(
                    """DELETE FROM acked_ids WHERE rid <=
                         (SELECT MAX(rid) FROM acked_ids) - ?""",
                    (self.ACKED_CACHE_MAX,),
                )
            self._db.commit()

    def nack(self, msg_id: str) -> None:
        """Return a leased message to its queue immediately."""
        with self._lock:
            self._check_open()
            self._db.execute(
                "UPDATE messages SET leased_until=NULL WHERE msg_id=?",
                (msg_id,),
            )
            self._db.commit()
            self._lock.notify_all()

    # ------------------------------------------------------------ introspect
    def depth(self, queue: str) -> int:
        with self._lock:
            self._check_open()
            (n,) = self._db.execute(
                "SELECT COUNT(*) FROM messages WHERE queue=?", (queue,)
            ).fetchone()
            return n

    def queues(self) -> list[str]:
        with self._lock:
            self._check_open()
            return [
                q for (q,) in self._db.execute(
                    "SELECT DISTINCT queue FROM messages ORDER BY queue"
                )
            ]

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._db.close()
            self._lock.notify_all()

    def _check_open(self):
        if self._closed:
            raise QueueClosedError("broker is closed")
