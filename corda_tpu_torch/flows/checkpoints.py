"""Checkpoint storage: the persisted op log per flow (counterpart of
corda_tpu/flows/checkpoints.py; ``WalCheckpointStorage`` (:170), its
journaled twin over the durability tier, comes with that tier: ROADMAP.md,
Queue 1 step 4b).

The role of DBCheckpointStorage (node/.../services/persistence/
DBCheckpointStorage.kt:16) — but a checkpoint here is not an opaque
serialized fiber stack: it is (flow class + constructor args) plus the
ordered list of recorded op results. Writing op N's result and making its
effect durable happen in one sqlite transaction — the equivalent of the
reference's checkpoint-commit riding the message-ack DB transaction
(StateMachineManager.kt:548, FlowStateMachineImpl.kt:466-477).
"""

from __future__ import annotations

import sqlite3
import threading
from collections import deque

from ..serialization import deserialize, serialize


class CheckpointStorage:
    def __init__(self, path: str = ":memory:"):
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        self._db.execute(
            """CREATE TABLE IF NOT EXISTS flows (
                 flow_id TEXT PRIMARY KEY,
                 flow_blob BLOB NOT NULL,      -- CBE (class name, args)
                 our_name TEXT NOT NULL,
                 started_at REAL NOT NULL
               )"""
        )
        self._db.execute(
            """CREATE TABLE IF NOT EXISTS oplog (
                 flow_id TEXT NOT NULL,
                 op_index INTEGER NOT NULL,
                 result_blob BLOB NOT NULL,
                 PRIMARY KEY (flow_id, op_index)
               )"""
        )
        # the persisted processed-message table (reference:
        # NodeMessagingClient.kt:187 — dedupe must survive restarts, or a
        # redelivered SessionInit after the responder completed would spawn
        # a second responder). ``rid`` orders entries so the table trims
        # FIFO like the broker's duplicate-ID cache instead of growing for
        # the node's lifetime; pre-existing databases with the older
        # two-column schema keep working (inserts name their columns, the
        # trim no-ops without ``rid``).
        self._db.execute(
            """CREATE TABLE IF NOT EXISTS processed_inits (
                 rid INTEGER PRIMARY KEY AUTOINCREMENT,
                 msg_id TEXT UNIQUE,
                 flow_id TEXT NOT NULL
               )"""
        )
        self._db.commit()
        self._inits_since_trim = 0

    INITS_CACHE_MAX = 100_000

    # ------------------------------------------------------------- flows
    def add_flow(self, flow_id: str, flow_blob: bytes, our_name: str,
                 started_at: float) -> None:
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO flows VALUES (?,?,?,?)",
                (flow_id, flow_blob, our_name, started_at),
            )
            self._db.commit()

    def remove_flow(self, flow_id: str) -> None:
        """Flow finished: checkpoint and op log drop atomically."""
        with self._lock:
            self._db.execute("DELETE FROM flows WHERE flow_id=?", (flow_id,))
            self._db.execute("DELETE FROM oplog WHERE flow_id=?", (flow_id,))
            self._db.commit()

    def all_flows(self) -> list[tuple[str, bytes, str, float]]:
        """Checkpointed flows in deterministic (started_at, flow_id) order
        — restore after a crash replays flows in a stable sequence, so a
        restart under chaos reproduces rather than reshuffles."""
        with self._lock:
            return list(
                self._db.execute(
                    "SELECT flow_id, flow_blob, our_name, started_at "
                    "FROM flows ORDER BY started_at, flow_id"
                )
            )

    def get_flow(self, flow_id: str) -> bytes | None:
        """The flow blob for one checkpointed flow (the park/resume path
        rebuilds a single flow without scanning the table)."""
        with self._lock:
            row = self._db.execute(
                "SELECT flow_blob FROM flows WHERE flow_id=?", (flow_id,)
            ).fetchone()
            return row[0] if row else None

    # ------------------------------------------------------------- op log
    def record_op(self, flow_id: str, op_index: int, result) -> None:
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO oplog VALUES (?,?,?)",
                (flow_id, op_index, serialize(result)),
            )
            self._db.commit()

    def load_oplog(self, flow_id: str) -> list:
        with self._lock:
            rows = self._db.execute(
                "SELECT op_index, result_blob FROM oplog WHERE flow_id=? "
                "ORDER BY op_index",
                (flow_id,),
            ).fetchall()
        # guard against holes (should not happen; fail loudly if they do)
        for expect, (idx, _) in enumerate(rows):
            if idx != expect:
                raise RuntimeError(
                    f"op log hole for flow {flow_id}: expected {expect}, got {idx}"
                )
        return [deserialize(blob) for _, blob in rows]

    # ---------------------------------------------------------- init dedupe
    def mark_init_processed(self, msg_id: str, flow_id: str) -> bool:
        """True if this call claimed the init; False if already processed."""
        with self._lock:
            cur = self._db.execute(
                "INSERT OR IGNORE INTO processed_inits (msg_id, flow_id) "
                "VALUES (?,?)",
                (msg_id, flow_id),
            )
            self._inits_since_trim += 1
            if self._inits_since_trim >= 4096:
                self._inits_since_trim = 0
                try:
                    self._db.execute(
                        """DELETE FROM processed_inits WHERE rid <=
                             (SELECT MAX(rid) FROM processed_inits) - ?""",
                        (self.INITS_CACHE_MAX,),
                    )
                except sqlite3.OperationalError:
                    pass  # legacy schema without rid: unbounded as before
            self._db.commit()
            return cur.rowcount == 1

    def mark_init_rejected(self, msg_id: str, reason: str) -> None:
        """Re-mark a claimed init as rejected (``rejected:<reason>``), so a
        retransmitted init of a rejected open repeats the rejection rather
        than being mistaken for a completed responder."""
        with self._lock:
            self._db.execute(
                "UPDATE processed_inits SET flow_id=? WHERE msg_id=?",
                (f"rejected:{reason}", msg_id),
            )
            self._db.commit()

    def init_flow_id(self, msg_id: str) -> str | None:
        with self._lock:
            row = self._db.execute(
                "SELECT flow_id FROM processed_inits WHERE msg_id=?",
                (msg_id,),
            ).fetchone()
            return row[0] if row else None

    def close(self) -> None:
        with self._lock:
            self._db.close()
