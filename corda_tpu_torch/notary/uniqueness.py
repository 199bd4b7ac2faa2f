"""Uniqueness providers: the consumed-state registry (counterpart of
corda_tpu/notary/uniqueness.py).

``commit(states, tx_id, caller)`` raises ``NotaryError`` carrying a
``UniquenessConflict`` that lists which inputs were already consumed and by
what; the commit is atomic, all inputs or none. ``commit_batch`` settles N
requests in order (two requests spending one input: the first wins) in one
storage round trip. Re-committing the same transaction succeeds, so a
client retrying after a lost response gets its signature.

Ported: the base provider with ``commit_batch_async``, the dict-backed
``InMemoryUniquenessProvider`` and the SQLite-backed
``PersistentUniquenessProvider`` (standard-library ``sqlite3``). The
durable-store provider, the Raft and BFT clusters and the device-resident
state store come with later slices (ROADMAP.md Queue 1 items 8 and 15).
"""

from __future__ import annotations

import dataclasses
import hashlib
import sqlite3
import threading

from ..crypto import SecureHash
from ..ledger import StateRef
from ..serialization import cbe_serializable


@cbe_serializable(name="notary.ConsumedStateDetails")
@dataclasses.dataclass(frozen=True)
class ConsumedStateDetails:
    """Who consumed a state: the consuming tx, the input's index in it and
    the requesting party's name."""

    consuming_tx: SecureHash
    input_index: int
    requesting_party_name: str


@cbe_serializable(name="notary.UniquenessConflict")
@dataclasses.dataclass(frozen=True)
class UniquenessConflict:
    """Per input ref, the details of its earlier consumption."""

    state_history: dict  # StateRef -> ConsumedStateDetails


class NotaryError(Exception):
    def __init__(self, message: str, conflict: UniquenessConflict | None = None):
        super().__init__(message)
        self.conflict = conflict


class PendingCommit:
    """A batch commit already settled: ``collect()`` yields the per-request
    conflict list."""

    __slots__ = ("_conflicts",)

    def __init__(self, conflicts):
        self._conflicts = conflicts

    def collect(self):
        return self._conflicts


class UniquenessProvider:
    def commit(self, states: list[StateRef], tx_id: SecureHash,
               caller_name: str) -> None:
        raise NotImplementedError

    def commit_batch(
        self, requests: list[tuple[list[StateRef], SecureHash, str]]
    ) -> list[UniquenessConflict | None]:
        """Settle requests in order; per request None (committed) or the
        conflict. The default loops ``commit``."""
        out: list[UniquenessConflict | None] = []
        for states, tx_id, caller in requests:
            try:
                self.commit(states, tx_id, caller)
                out.append(None)
            except NotaryError as e:
                out.append(e.conflict)
        return out

    def commit_batch_async(self, requests) -> PendingCommit:
        """Enqueue the batch commit. Local providers settle at once (a map
        or SQLite round trip has nothing to overlap); a consensus provider
        would put its replication round in flight here."""
        return PendingCommit(self.commit_batch(requests))


def _ref_key(ref: StateRef) -> bytes:
    return ref.txhash.bytes + ref.index.to_bytes(4, "big")


class InMemoryUniquenessProvider(UniquenessProvider):
    """Dict-backed provider, for tests and mock networks. ``_map`` is
    keyed by ``txhash bytes || big-endian u32 index``."""

    def __init__(self):
        self._map: dict[bytes, ConsumedStateDetails] = {}
        self._lock = threading.Lock()

    def commit(self, states, tx_id, caller_name) -> None:
        conflict = self.commit_batch([(states, tx_id, caller_name)])[0]
        if conflict is not None:
            raise NotaryError(f"input states of {tx_id} already consumed", conflict)

    def commit_batch(self, requests):
        """The whole batch under one lock acquisition, settled in order."""
        out: list[UniquenessConflict | None] = []
        with self._lock:
            for states, tx_id, caller in requests:
                conflict = {}
                for ref in states:
                    prior = self._map.get(_ref_key(ref))
                    if prior is not None and prior.consuming_tx != tx_id:
                        conflict[ref] = prior
                if conflict:
                    out.append(UniquenessConflict(conflict))
                    continue
                for i, ref in enumerate(states):
                    self._map.setdefault(
                        _ref_key(ref), ConsumedStateDetails(tx_id, i, caller)
                    )
                out.append(None)
        return out

    def committed_txs(self) -> int:
        """Distinct transactions committed."""
        with self._lock:
            return len({d.consuming_tx for d in self._map.values()})

    def consumed_digest(self) -> str:
        """One SHA-256 over the consumed set, sorted by key (the
        reference's formula, so two providers compare by one string)."""
        h = hashlib.sha256()
        with self._lock:
            for key in sorted(self._map):
                d = self._map[key]
                h.update(key)
                h.update(d.consuming_tx.bytes)
                h.update(d.input_index.to_bytes(4, "big"))
                h.update(d.requesting_party_name.encode())
        return h.hexdigest()


class PersistentUniquenessProvider(UniquenessProvider):
    """SQLite append-only committed-states map."""

    def __init__(self, path: str = ":memory:"):
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS notary_commits ("
            " state_key BLOB PRIMARY KEY,"
            " consuming_tx BLOB NOT NULL, input_index INTEGER NOT NULL,"
            " caller TEXT NOT NULL)"
        )
        self._db.commit()
        self._lock = threading.Lock()

    def commit(self, states, tx_id, caller_name) -> None:
        conflict = self.commit_batch([(states, tx_id, caller_name)])[0]
        if conflict is not None:
            raise NotaryError(f"input states of {tx_id} already consumed", conflict)

    def commit_batch(self, requests):
        """One batched SELECT over every referenced key, conflicts settled
        in memory in batch order, one executemany INSERT, one commit."""
        out = []
        with self._lock:
            all_keys = sorted({
                _ref_key(ref) for states, _, _ in requests for ref in states
            })
            prior: dict = {}
            chunk_size = 512  # below SQLite's bound-parameter limit
            for i in range(0, len(all_keys), chunk_size):
                chunk = all_keys[i : i + chunk_size]
                marks = ",".join("?" * len(chunk))
                for row in self._db.execute(
                    "SELECT state_key, consuming_tx, input_index, caller"
                    f" FROM notary_commits WHERE state_key IN ({marks})",
                    chunk,
                ):
                    prior[row[0]] = (row[1], row[2], row[3])
            to_insert = []
            for states, tx_id, caller in requests:
                conflict = {}
                for ref in states:
                    hit = prior.get(_ref_key(ref))
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
            self._db.commit()
        return out

    def committed_txs(self) -> int:
        """Distinct transactions committed."""
        with self._lock:
            return self._db.execute(
                "SELECT COUNT(DISTINCT consuming_tx) FROM notary_commits"
            ).fetchone()[0]

    def rows(self) -> list[tuple[bytes, bytes, int, str]]:
        """Every committed (state key, consuming tx, input index, caller),
        sorted by state key."""
        with self._lock:
            return [(bytes(k), bytes(t), int(i), str(c)) for k, t, i, c in self._db.execute(
                "SELECT state_key, consuming_tx, input_index, caller"
                " FROM notary_commits ORDER BY state_key")]

    def consumed_digest(self) -> str:
        """``InMemoryUniquenessProvider.consumed_digest``'s formula over the
        committed rows."""
        h = hashlib.sha256()
        for key, tx, index, caller in self.rows():
            h.update(key)
            h.update(tx)
            h.update(index.to_bytes(4, "big"))
            h.update(caller.encode())
        return h.hexdigest()

    def close(self) -> None:
        with self._lock:
            self._db.close()
