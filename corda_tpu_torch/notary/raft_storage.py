"""Durable storage for the Raft notary cluster (counterpart of
corda_tpu/notary/raft_storage.py, with the same schema and the same CBE
bytes, so either package opens a replica file the other wrote).

A restarted replica rejoins with its term, vote and log intact. ONE SQLite
database per replica holds three tables:

- ``raft_meta``    — current_term, voted_for, snapshot (base, term), applied
- ``raft_log``     — the replicated log, absolute-indexed
- ``notary_commits`` — the state machine itself (the consumed-state map)

Keeping the state machine in the same database as the applied-index makes
``apply`` ATOMIC: a crash between "apply" and "mark applied" cannot happen,
so restart never double-applies or skips an entry. Snapshot/compaction is
then nearly free — the state machine IS the snapshot — so compaction just
deletes log entries at or below the applied index; a follower that lags
behind the compacted prefix receives the map itself (InstallSnapshot).

Raft's persistence contract (Raft paper §5.1, Fig. 2 "persistent state"):
term/vote persist BEFORE any reply that promises them; log entries persist
BEFORE acknowledging an append. Without the vote persistence a restarted
replica could double-vote in one term and elect two leaders.
"""

from __future__ import annotations

import sqlite3
import threading

from ..crypto import SecureHash
from ..ledger import StateRef

from .uniqueness import ConsumedStateDetails, UniquenessConflict


def _ref_key(ref: StateRef) -> bytes:
    return ref.txhash.bytes + ref.index.to_bytes(4, "big")


class RaftStorage:
    """Durable per-replica store; every method is one transaction."""

    def __init__(self, path: str = ":memory:"):
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute("PRAGMA synchronous=NORMAL")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS raft_meta ("
            " key TEXT PRIMARY KEY, value BLOB)"
        )
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS raft_log ("
            " idx INTEGER PRIMARY KEY, term INTEGER NOT NULL,"
            " command BLOB NOT NULL)"
        )
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS notary_commits ("
            " state_key BLOB PRIMARY KEY,"
            " consuming_tx BLOB NOT NULL, input_index INTEGER NOT NULL,"
            " caller TEXT NOT NULL)"
        )
        self._db.commit()
        self._lock = threading.Lock()

    # ------------------------------------------------------------- meta

    def _get_meta(self, key: str, default: int) -> int:
        row = self._db.execute(
            "SELECT value FROM raft_meta WHERE key=?", (key,)
        ).fetchone()
        return int(row[0]) if row is not None else default

    def _set_meta_tx(self, key: str, value: int) -> None:
        self._db.execute(
            "INSERT INTO raft_meta VALUES (?,?) "
            "ON CONFLICT(key) DO UPDATE SET value=excluded.value",
            (key, value),
        )

    def load(self) -> dict:
        """Restore persistent state after a restart."""
        with self._lock:
            term = self._get_meta("term", 0)
            voted_raw = self._db.execute(
                "SELECT value FROM raft_meta WHERE key='voted_for'"
            ).fetchone()
            voted_for = (
                voted_raw[0].decode()
                if voted_raw is not None and voted_raw[0] is not None
                and voted_raw[0] != b""
                else None
            )
            base = self._get_meta("snap_base", 0)
            snap_term = self._get_meta("snap_term", 0)
            applied = self._get_meta("applied", -1)
            entries = [
                (int(t), bytes(c))
                for (t, c) in self._db.execute(
                    "SELECT term, command FROM raft_log ORDER BY idx"
                )
            ]
            return {
                "term": term, "voted_for": voted_for, "base": base,
                "snap_term": snap_term, "applied": applied,
                "entries": entries,
            }

    def save_term_vote(self, term: int, voted_for: str | None) -> None:
        """MUST complete before granting a vote or replying with the term."""
        with self._lock:
            self._set_meta_tx("term", term)
            self._db.execute(
                "INSERT INTO raft_meta VALUES ('voted_for', ?) "
                "ON CONFLICT(key) DO UPDATE SET value=excluded.value",
                (voted_for.encode() if voted_for is not None else b"",),
            )
            self._db.commit()

    # -------------------------------------------------------------- log

    def append(self, abs_idx: int, term: int, command: bytes) -> None:
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO raft_log VALUES (?,?,?)",
                (abs_idx, term, command),
            )
            self._db.commit()

    def replace_suffix(self, start_abs_idx: int, rows: list) -> None:
        """Truncate the log from ``start_abs_idx`` and append ``rows``
        ((term, command) pairs) — one transaction, the follower-side
        conflict-resolution write."""
        with self._lock:
            self._db.execute(
                "DELETE FROM raft_log WHERE idx >= ?", (start_abs_idx,)
            )
            self._db.executemany(
                "INSERT INTO raft_log VALUES (?,?,?)",
                [
                    (start_abs_idx + i, t, c)
                    for i, (t, c) in enumerate(rows)
                ],
            )
            self._db.commit()

    # ----------------------------------------------------- state machine

    def apply_commit(
        self, abs_idx: int, states: list, tx_id: SecureHash, caller: str
    ) -> UniquenessConflict | None:
        """Apply one committed entry atomically with the applied marker.
        Idempotent: re-applying an index at or below ``applied`` (restart
        replay) is a no-op returning None."""
        with self._lock:
            if abs_idx <= self._get_meta("applied", -1):
                return None
            conflict: dict = {}
            for ref in states:
                row = self._db.execute(
                    "SELECT consuming_tx, input_index, caller FROM"
                    " notary_commits WHERE state_key=?", (_ref_key(ref),)
                ).fetchone()
                if row is not None and row[0] != tx_id.bytes:
                    conflict[ref] = ConsumedStateDetails(
                        SecureHash(row[0]), row[1], row[2]
                    )
            if not conflict:
                self._db.executemany(
                    "INSERT OR IGNORE INTO notary_commits VALUES (?,?,?,?)",
                    [
                        (_ref_key(ref), tx_id.bytes, i, caller)
                        for i, ref in enumerate(states)
                    ],
                )
            self._set_meta_tx("applied", abs_idx)
            self._db.commit()
            return UniquenessConflict(conflict) if conflict else None

    def apply_commit_batch(
        self, abs_idx: int, requests: list
    ) -> list[UniquenessConflict | None]:
        """Apply ONE committed log entry carrying N commit requests — one
        transaction, one applied-marker write, one fsync (a whole notary
        window an entry). Requests settle in order, so intra-batch
        double-spends conflict deterministically on every replica.
        Idempotent on replay like ``apply_commit``."""
        with self._lock:
            if abs_idx <= self._get_meta("applied", -1):
                return [None] * len(requests)
            out: list[UniquenessConflict | None] = []
            prior: dict[bytes, tuple] = {}
            to_insert = []
            for states, tx_id, caller in requests:
                conflict: dict = {}
                for ref in states:
                    key = _ref_key(ref)
                    hit = prior.get(key)
                    if hit is None:
                        row = self._db.execute(
                            "SELECT consuming_tx, input_index, caller FROM"
                            " notary_commits WHERE state_key=?", (key,)
                        ).fetchone()
                        if row is not None:
                            hit = (bytes(row[0]), row[1], row[2])
                            prior[key] = hit
                    if hit is not None and hit[0] != tx_id.bytes:
                        conflict[ref] = ConsumedStateDetails(
                            SecureHash(hit[0]), hit[1], hit[2]
                        )
                if conflict:
                    out.append(UniquenessConflict(conflict))
                    continue
                for i, ref in enumerate(states):
                    key = _ref_key(ref)
                    if key not in prior:
                        to_insert.append((key, tx_id.bytes, i, caller))
                        prior[key] = (tx_id.bytes, i, caller)
                out.append(None)
            if to_insert:
                self._db.executemany(
                    "INSERT OR IGNORE INTO notary_commits VALUES (?,?,?,?)",
                    to_insert,
                )
            self._set_meta_tx("applied", abs_idx)
            self._db.commit()
            return out

    def compact(self, upto_abs_idx: int, upto_term: int) -> None:
        """Drop log entries ≤ ``upto_abs_idx`` — the state machine already
        reflects them (it IS the snapshot)."""
        with self._lock:
            self._db.execute(
                "DELETE FROM raft_log WHERE idx <= ?", (upto_abs_idx,)
            )
            self._set_meta_tx("snap_base", upto_abs_idx + 1)
            self._set_meta_tx("snap_term", upto_term)
            self._db.commit()

    # ------------------------------------------------ snapshot transfer

    def dump_map(self) -> list:
        """Serialize the consumed-state map for InstallSnapshot."""
        with self._lock:
            return [
                (bytes(k), bytes(t), i, c)
                for (k, t, i, c) in self._db.execute(
                    "SELECT state_key, consuming_tx, input_index, caller"
                    " FROM notary_commits"
                )
            ]

    def install_snapshot(
        self, rows: list, last_idx: int, last_term: int
    ) -> None:
        """Replace the whole state machine + log with a leader snapshot —
        one transaction, so a crash mid-install leaves the old state."""
        with self._lock:
            self._db.execute("DELETE FROM notary_commits")
            self._db.executemany(
                "INSERT INTO notary_commits VALUES (?,?,?,?)", rows
            )
            self._db.execute("DELETE FROM raft_log")
            self._set_meta_tx("applied", last_idx)
            self._set_meta_tx("snap_base", last_idx + 1)
            self._set_meta_tx("snap_term", last_term)
            self._db.commit()

    # ------------------------------------------------------- inspection

    def committed_txs(self) -> int:
        with self._lock:
            return self._db.execute(
                "SELECT COUNT(DISTINCT consuming_tx) FROM notary_commits"
            ).fetchone()[0]

    def close(self) -> None:
        with self._lock:
            self._db.close()
