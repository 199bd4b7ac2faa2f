"""Checkpoint storage: the persisted op log per flow (counterpart of
corda_tpu/flows/checkpoints.py): ``CheckpointStorage`` over SQLite and
``WalCheckpointStorage``, its journaled twin over the durability tier
(``durability/``), from which a restarted node resumes its flows.

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

class WalCheckpointStorage:
    """``CheckpointStorage``'s API over the crash-consistent durability
    tier (docs/DURABILITY.md): flow checkpoints, the per-flow op log and
    the processed-inits dedupe table live in memory, journaled through a
    ``DurableStore`` WAL with group-commit fsync. Every mutation is
    durable BEFORE the call returns — ``record_op`` in particular flushes
    before the engine acks the consumed session message, which is exactly
    the reference's checkpoint-commit-rides-the-ack-transaction guarantee
    under a real crash model (the ``durability-ack-order`` lint pins the
    ordering). Recovery = newest snapshot + WAL replay; a restarted
    ``StateMachineManager.restore()`` then replays each flow's op log to
    its live point, so in-flight sessions resume (or deterministically
    abort via the session retry deadline) and SessionAck retransmission
    picks up from the durable sequence."""

    INITS_CACHE_MAX = CheckpointStorage.INITS_CACHE_MAX

    def __init__(self, store):
        self._store = store
        self._lock = threading.Lock()
        self._flows: dict[str, tuple[bytes, str, float]] = {}
        self._oplog: dict[str, dict[int, bytes]] = {}
        self._inits: dict[str, str] = {}
        self._inits_order: deque[str] = deque()
        # LSN of the last record the in-memory state reflects, updated
        # under the same lock as every append: a snapshot claims
        # coverage of exactly what its locked capture saw
        self._last_lsn = -1
        self.last_recovery = store.recover(self._apply, self._load_snapshot)
        self._last_lsn = max(self._last_lsn, store.wal.durable_lsn)

    # ------------------------------------------------------------ recovery
    def _apply(self, rec: dict) -> None:
        with self._lock:
            self._apply_locked(rec)

    def _apply_locked(self, rec: dict) -> None:
        k = rec["k"]
        if k == "flow":
            self._flows[rec["id"]] = (rec["blob"], rec["name"], rec["ts"])
        elif k == "op":
            self._oplog.setdefault(rec["id"], {})[rec["i"]] = rec["blob"]
        elif k == "rm":
            self._flows.pop(rec["id"], None)
            self._oplog.pop(rec["id"], None)
        elif k == "init":
            # first claim wins (INSERT OR IGNORE semantics) — a replayed
            # duplicate claim must not steal the original's flow id
            if rec["m"] not in self._inits:
                self._inits[rec["m"]] = rec["id"]
                self._inits_order.append(rec["m"])
        elif k == "rej":
            self._inits[rec["m"]] = f"rejected:{rec['r']}"
        self._trim_inits_locked()

    def _trim_inits_locked(self) -> None:
        while len(self._inits_order) > self.INITS_CACHE_MAX:
            self._inits.pop(self._inits_order.popleft(), None)

    def _load_snapshot(self, snap: dict) -> None:
        with self._lock:
            for fid, blob, name, ts in snap["flows"]:
                self._flows[fid] = (blob, name, ts)
            for fid, idx, blob in snap["oplog"]:
                self._oplog.setdefault(fid, {})[idx] = blob
            for msg_id, fid in snap["inits"]:
                if msg_id not in self._inits:
                    self._inits[msg_id] = fid
                    self._inits_order.append(msg_id)

    def _snapshot_state_locked(self) -> dict:
        return {
            "flows": [
                (fid, blob, name, ts)
                for fid, (blob, name, ts) in self._flows.items()
            ],
            "oplog": [
                (fid, idx, blob)
                for fid, ops in self._oplog.items()
                for idx, blob in sorted(ops.items())
            ],
            "inits": [(m, self._inits[m]) for m in self._inits_order],
        }

    def _maybe_snapshot(self) -> None:
        if self._store.snapshot_due():
            with self._lock:
                state = self._snapshot_state_locked()
                lsn = self._last_lsn
            self._store.snapshot(state, covered_lsn=lsn)

    # ------------------------------------------------------------- flows
    def add_flow(self, flow_id: str, flow_blob: bytes, our_name: str,
                 started_at: float) -> None:
        with self._lock:
            self._flows[flow_id] = (flow_blob, our_name, started_at)
            self._last_lsn = self._store.append(
                {"k": "flow", "id": flow_id, "blob": flow_blob,
                 "name": our_name, "ts": started_at})
        self._store.flush()
        self._maybe_snapshot()

    def remove_flow(self, flow_id: str) -> None:
        """Flow finished: checkpoint and op log drop atomically (one WAL
        record covers both)."""
        with self._lock:
            self._flows.pop(flow_id, None)
            self._oplog.pop(flow_id, None)
            self._last_lsn = self._store.append({"k": "rm", "id": flow_id})
        self._store.flush()
        self._maybe_snapshot()

    def all_flows(self) -> list[tuple[str, bytes, str, float]]:
        with self._lock:
            rows = [
                (fid, blob, name, ts)
                for fid, (blob, name, ts) in self._flows.items()
            ]
        return sorted(rows, key=lambda r: (r[3], r[0]))

    def get_flow(self, flow_id: str) -> bytes | None:
        with self._lock:
            row = self._flows.get(flow_id)
            return row[0] if row else None

    # ------------------------------------------------------------- op log
    def record_op(self, flow_id: str, op_index: int, result) -> None:
        blob = serialize(result)
        with self._lock:
            self._oplog.setdefault(flow_id, {})[op_index] = blob
            self._last_lsn = self._store.append(
                {"k": "op", "id": flow_id, "i": op_index, "blob": blob})
        # durable before the caller acks the message the op consumed
        self._store.flush()
        self._maybe_snapshot()

    def load_oplog(self, flow_id: str) -> list:
        with self._lock:
            rows = sorted(self._oplog.get(flow_id, {}).items())
        for expect, (idx, _) in enumerate(rows):
            if idx != expect:
                raise RuntimeError(
                    f"op log hole for flow {flow_id}: expected {expect}, got {idx}"
                )
        return [deserialize(blob) for _, blob in rows]

    # ---------------------------------------------------------- init dedupe
    def mark_init_processed(self, msg_id: str, flow_id: str) -> bool:
        with self._lock:
            if msg_id in self._inits:
                return False
            self._inits[msg_id] = flow_id
            self._inits_order.append(msg_id)
            self._trim_inits_locked()
            self._last_lsn = self._store.append(
                {"k": "init", "m": msg_id, "id": flow_id})
        self._store.flush()
        self._maybe_snapshot()
        return True

    def mark_init_rejected(self, msg_id: str, reason: str) -> None:
        with self._lock:
            self._inits[msg_id] = f"rejected:{reason}"
            self._last_lsn = self._store.append(
                {"k": "rej", "m": msg_id, "r": reason})
        self._store.flush()

    def init_flow_id(self, msg_id: str) -> str | None:
        with self._lock:
            return self._inits.get(msg_id)

    def close(self) -> None:
        self._store.flush()
        self._store.close()
