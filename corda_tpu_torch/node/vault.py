"""The vault: the node's view of states it cares about (counterpart of
corda_tpu/node/vault.py).

Parity with the reference's node/.../services/vault/ —
``NodeVaultService`` (tracks unconsumed/consumed states from recorded
transactions, emits ``Vault.Update``s), the query engine
(``HibernateQueryCriteriaParser`` criteria → SQL; here criteria → SQLite
over an indexed state table), and ``VaultSoftLockManager`` (flow-scoped
soft locks so concurrent spenders don't select the same coins).

Schema: one row per output state (tx, index, contract, state class,
notary, participants, consumed flag, soft-lock id, fungible quantity +
token for coin selection), with the state object itself CBE-serialized.

With ``journal=`` (a ``durability.DurableStore``) every recorded
transaction is journaled and fsynced before any subscriber sees its
update, and a restarted vault rebuilds its pages from the journal.

With ``state_index=`` (a ``statestore.DeviceVaultIndex``; built on
``device`` when ``CORDA_TPU_STATESTORE=1`` and none is given) the vault
keeps an index of its unconsumed refs in the card's memory in step with the
SQL pages: recording removes the consumed refs and adds the produced ones,
journal replay and a snapshot restore rebuild it, coin selection
cross-checks its picks against it, and ``unconsumed_ref_exists`` asks it
first (SQL answers when its probe fails).
"""

from __future__ import annotations

import dataclasses
import enum
import sqlite3
import threading

from ..crypto import SecureHash
from ..ledger import SignedTransaction, StateAndRef, StateRef, TransactionState
from ..ledger.states import Amount
from ..serialization import deserialize, register_custom, serialize


class StateStatus(enum.Enum):
    UNCONSUMED = "UNCONSUMED"
    CONSUMED = "CONSUMED"
    ALL = "ALL"


@dataclasses.dataclass(frozen=True)
class PageSpecification:
    """(reference: PageSpecification in vault/QueryCriteria.kt —
    1-based page numbers)."""

    page_number: int = 1
    page_size: int = 200


@dataclasses.dataclass(frozen=True)
class Sort:
    """Sort by a recognised column (reference: Sort/SortAttribute)."""

    by: str = "recorded"  # recorded | contract | quantity
    descending: bool = False

    _COLUMNS = {"recorded": "rowid", "contract": "contract", "quantity": "quantity"}


@dataclasses.dataclass(frozen=True)
class QueryCriteria:
    """Composable vault query criteria (reference: QueryCriteria.kt —
    VaultQueryCriteria + FungibleAssetQueryCriteria folded into one
    dataclass; ``and_``/``or_`` composition is replaced by explicit field
    conjunction, the dominant real-world use)."""

    status: StateStatus = StateStatus.UNCONSUMED
    contract_state_types: tuple[type, ...] | None = None
    state_refs: tuple[StateRef, ...] | None = None
    notary_names: tuple[str, ...] | None = None
    participant_keys: tuple | None = None  # PublicKey
    include_soft_locked: bool = True
    soft_lock_id: str | None = None  # states locked by this flow also visible
    quantity_geq: int | None = None  # fungible: quantity >= (coin selection)
    token_repr: str | None = None  # fungible: exact token match


class SoftLockError(Exception):
    pass


@dataclasses.dataclass(frozen=True)
class VaultUpdate:
    """(reference: Vault.Update — consumed/produced sets per tx)."""

    consumed: tuple[StateAndRef, ...]
    produced: tuple[StateAndRef, ...]

    @property
    def is_empty(self) -> bool:
        return not self.consumed and not self.produced


@dataclasses.dataclass(frozen=True)
class Page:
    """(reference: Vault.Page — results + total count for paging UIs)."""

    states: list[StateAndRef]
    total_states_available: int


class Vault:
    """Namespace mirror of the reference's ``Vault`` container class."""

    StateStatus = StateStatus
    Update = VaultUpdate
    Page = Page


def _token_repr(token) -> str:
    return repr(token)


class NodeVaultService:
    """SQLite-backed vault (reference: NodeVaultService.kt).

    Relevancy: a produced output is recorded iff the node's keys intersect
    its participants (or ``observe_all`` is set — observer-node mode).
    """

    def __init__(self, path: str = ":memory:", my_keys=None, observe_all=False,
                 journal=None, state_index=None, device=None):
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS vault_states ("
            " tx_id BLOB NOT NULL, output_index INTEGER NOT NULL,"
            " contract TEXT NOT NULL, state_class TEXT NOT NULL,"
            " notary_name TEXT NOT NULL, state_blob BLOB NOT NULL,"
            " consumed INTEGER NOT NULL DEFAULT 0,"
            " consumed_by BLOB, lock_id TEXT,"
            " quantity INTEGER, token TEXT,"
            " PRIMARY KEY (tx_id, output_index))"
        )
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS vault_participants ("
            " tx_id BLOB NOT NULL, output_index INTEGER NOT NULL,"
            " participant_key BLOB NOT NULL)"
        )
        self._db.execute(
            "CREATE INDEX IF NOT EXISTS idx_vault_unconsumed"
            " ON vault_states (consumed, contract)"
        )
        self._db.execute(
            "CREATE INDEX IF NOT EXISTS idx_vault_parts"
            " ON vault_participants (participant_key)"
        )
        self._db.commit()
        self._lock = threading.RLock()
        self._my_keys = set(my_keys or [])
        self._observe_all = observe_all
        self._subscribers: list = []
        # crash-consistent journal (docs/DURABILITY.md): every recorded
        # transaction lands in the durability WAL and is group-commit
        # fsynced BEFORE the vault update reaches any subscriber; recovery
        # rebuilds the consumed/unconsumed pages (newest snapshot + stx
        # replay), which feeds the normal query/track snapshot path.
        # Meant for the default ':memory:' backing store; a file-backed
        # SQLite vault is already durable on its own.
        self._journal = journal
        self.last_recovery = None
        # the unconsumed-state index on the card (statestore/): given, or
        # built on `device` iff CORDA_TPU_STATESTORE=1 (maybe_vault_index
        # is None while the gate is off: nothing is allocated). Attached
        # BEFORE journal recovery so replay repopulates it beside the SQL
        # pages.
        if state_index is None:
            from ..statestore import maybe_vault_index

            state_index = maybe_vault_index(device=device)
        self._state_index = state_index
        # LSN of the last journal record whose SQL effect is known
        # applied (appends happen strictly AFTER their _apply_stx, so a
        # snapshot claiming coverage of this LSN can never lack it)
        self._journal_lsn = -1
        if journal is not None:
            self.last_recovery = journal.recover(
                self._apply_journal, self._load_pages
            )
            self._journal_lsn = journal.wal.durable_lsn
        if self._state_index is not None:
            # converge the index with whatever SQL already holds: pages
            # restored from a snapshot (_load_pages writes SQL directly)
            # and the rows of a file-backed vault are invisible to the
            # replay, and without this pass unconsumed_ref_exists would
            # answer a confident False for live states
            self._rebuild_state_index()

    # -- recording ------------------------------------------------------------

    def add_my_key(self, key) -> None:
        with self._lock:
            self._my_keys.add(key)

    def _is_relevant(self, state: TransactionState) -> bool:
        if self._observe_all or not self._my_keys:
            return True
        participants = getattr(state.data, "participants", ())
        for p in participants:
            key = getattr(p, "owning_key", p)
            if key in self._my_keys:
                return True
        return False

    def record_transaction(self, stx: SignedTransaction) -> VaultUpdate:
        """Consume inputs we track, record relevant outputs, emit an update
        (reference: NodeVaultService.notifyAll). With a journal, the WAL
        record is durable before any subscriber sees the update."""
        update, subs, lsn = self._apply_stx(stx, journal=True)
        if self._journal is not None:
            # the group-commit fsync (and the ack it gates — returning,
            # and the subscriber callbacks below) stays OUTSIDE the lock
            self._journal.flush()
            if self._journal.snapshot_due():
                # cover only OUR record: a rival recorder's later append
                # may not be in the dump yet; its record replays
                # idempotently over the snapshot instead
                self._journal.snapshot(self._dump_pages(), covered_lsn=lsn)
        if not update.is_empty:
            for cb in subs:
                cb(update)
        return update

    def _apply_stx(self, stx: SignedTransaction, journal: bool = False):
        """The SQL half of recording one transaction — idempotent (replay
        of an already-recorded stx changes nothing), shared by the live
        path (``journal=True``: the WAL record is appended INSIDE the
        same locked region as the SQL, so WAL order can never invert
        apply order — a spend journaled before its issue would replay
        into an unconsumed spent state) and journal recovery (which must
        not re-append)."""
        wtx = stx.tx
        produced: list[StateAndRef] = []
        consumed: list[StateAndRef] = []
        fresh_adds: list[tuple] = []   # (ref, owner) of newly inserted rows
        with self._lock:
            for ref in wtx.inputs:
                row = self._db.execute(
                    "SELECT state_blob FROM vault_states"
                    " WHERE tx_id=? AND output_index=? AND consumed=0",
                    (ref.txhash.bytes, ref.index),
                ).fetchone()
                if row is not None:
                    self._db.execute(
                        "UPDATE vault_states SET consumed=1, consumed_by=?, lock_id=NULL"
                        " WHERE tx_id=? AND output_index=?",
                        (stx.id.bytes, ref.txhash.bytes, ref.index),
                    )
                    consumed.append(StateAndRef(deserialize(row[0]), ref))
            for idx, tstate in enumerate(wtx.outputs):
                if not self._is_relevant(tstate):
                    continue
                ref = StateRef(stx.id, idx)
                amount = getattr(tstate.data, "amount", None)
                quantity = token = None
                if isinstance(amount, Amount):
                    quantity, token = amount.quantity, _token_repr(amount.token)
                cur = self._db.execute(
                    "INSERT OR IGNORE INTO vault_states"
                    " (tx_id, output_index, contract, state_class, notary_name,"
                    "  state_blob, quantity, token)"
                    " VALUES (?,?,?,?,?,?,?,?)",
                    (
                        stx.id.bytes, idx, tstate.contract,
                        type(tstate.data).__name__, str(tstate.notary.name),
                        serialize(tstate), quantity, token,
                    ),
                )
                if cur.rowcount == 1:
                    # participants only for a NEWLY-inserted state row, so
                    # an idempotent re-record (journal replay, client
                    # retry) cannot duplicate participant rows
                    for p in getattr(tstate.data, "participants", ()):
                        key = getattr(p, "owning_key", p)
                        self._db.execute(
                            "INSERT INTO vault_participants VALUES (?,?,?)",
                            (stx.id.bytes, idx, serialize(key)),
                        )
                    parts = getattr(tstate.data, "participants", ())
                    owner = (
                        getattr(parts[0], "owning_key", parts[0])
                        if parts else None
                    )
                    fresh_adds.append((ref, owner))
                produced.append(StateAndRef(tstate, ref))
            self._db.commit()
            if self._state_index is not None and (wtx.inputs or fresh_adds):
                # keep the index in step with the SQL pages (inside the same
                # lock, so no query sees the two disagree). Removes cover
                # ALL inputs, not only the rows SQL still held unconsumed: a
                # replay over an already-applied file-backed vault finds no
                # unconsumed row, yet the index must still converge to
                # consumed (removing an absent ref does nothing). Adds cover
                # only the rows whose INSERT landed: a re-offered ref may be
                # consumed in SQL already and must not come back.
                self._state_index.remove_states(list(wtx.inputs))
                self._state_index.add_states(fresh_adds)
            lsn = None
            if journal and self._journal is not None:
                lsn = self._journal.append(
                    {"k": "stx", "blob": serialize(stx)}
                )
                self._journal_lsn = max(self._journal_lsn, lsn)
            subs = list(self._subscribers)
        return VaultUpdate(tuple(consumed), tuple(produced)), subs, lsn

    # -- durability journal (docs/DURABILITY.md) -------------------------------

    def _apply_journal(self, rec: dict) -> None:
        if rec["k"] == "stx":
            self._apply_stx(deserialize(rec["blob"]))

    def _dump_pages(self) -> dict:
        """Full-page snapshot payload: raw rows of both vault tables."""
        with self._lock:
            states = self._db.execute(
                "SELECT tx_id, output_index, contract, state_class,"
                " notary_name, state_blob, consumed, consumed_by, lock_id,"
                " quantity, token FROM vault_states ORDER BY tx_id,"
                " output_index"
            ).fetchall()
            parts = self._db.execute(
                "SELECT tx_id, output_index, participant_key"
                " FROM vault_participants ORDER BY tx_id, output_index"
            ).fetchall()
        return {"states": [list(r) for r in states],
                "parts": [list(r) for r in parts]}

    def _load_pages(self, snap: dict) -> None:
        with self._lock:
            fresh: set[tuple] = set()
            for r in snap["states"]:
                cur = self._db.execute(
                    "INSERT OR IGNORE INTO vault_states"
                    " (tx_id, output_index, contract, state_class,"
                    "  notary_name, state_blob, consumed, consumed_by,"
                    "  lock_id, quantity, token)"
                    " VALUES (?,?,?,?,?,?,?,?,?,?,?)",
                    tuple(r),
                )
                if cur.rowcount == 1:
                    fresh.add((bytes(r[0]), r[1]))
            # participants only for state rows this load actually added:
            # a file-backed vault restarting with the journal enabled
            # already holds them, and vault_participants has no unique
            # key to dedupe on — a plain re-insert would duplicate the
            # table on every restart
            self._db.executemany(
                "INSERT INTO vault_participants VALUES (?,?,?)",
                [
                    tuple(r) for r in snap["parts"]
                    if (bytes(r[0]), r[1]) in fresh
                ],
            )
            self._db.commit()

    def _rebuild_state_index(self) -> None:
        """Load every UNCONSUMED SQL row into the index (present rows are
        offered again and skipped)."""
        with self._lock:
            rows = self._db.execute(
                "SELECT tx_id, output_index, state_blob FROM vault_states"
                " WHERE consumed=0"
            ).fetchall()
            if not rows:
                return
            adds = []
            for tx_id, idx, blob in rows:
                tstate = deserialize(blob)
                parts = getattr(tstate.data, "participants", ())
                owner = (
                    getattr(parts[0], "owning_key", parts[0])
                    if parts else None
                )
                adds.append((StateRef(SecureHash(tx_id), idx), owner))
            self._state_index.add_states(adds)

    def pages_digest(self) -> str:
        """One hash over the consumed/unconsumed pages (soft-lock ids
        excluded — they are flow-lifetime scratch, released on restart) —
        the kill-storm harness's bit-identical comparison against a
        never-crashed oracle vault."""
        import hashlib

        h = hashlib.sha256()
        with self._lock:
            for row in self._db.execute(
                "SELECT tx_id, output_index, contract, state_class,"
                " notary_name, state_blob, consumed, consumed_by,"
                " quantity, token FROM vault_states ORDER BY tx_id,"
                " output_index"
            ):
                h.update(repr(row).encode())
        return h.hexdigest()

    def snapshot_now(self) -> None:
        """Force a journal snapshot + WAL compaction (tests/operators)."""
        if self._journal is not None:
            # read the high-water mark BEFORE dumping: any record at or
            # below it was fully applied before its append, so the dump
            # taken after the read must include it
            lsn = self._journal_lsn
            self._journal.snapshot(self._dump_pages(), covered_lsn=lsn)

    # -- querying -------------------------------------------------------------

    def _build_query(self, criteria: QueryCriteria) -> tuple[str, list]:
        clauses, params = [], []
        if criteria.status is StateStatus.UNCONSUMED:
            clauses.append("consumed=0")
        elif criteria.status is StateStatus.CONSUMED:
            clauses.append("consumed=1")
        if criteria.contract_state_types:
            # accept classes or class-name strings — RPC clients send names
            names = [
                t if isinstance(t, str) else t.__name__
                for t in criteria.contract_state_types
            ]
            clauses.append(
                "state_class IN (%s)" % ",".join("?" * len(names))
            )
            params.extend(names)
        if criteria.state_refs:
            refs = criteria.state_refs
            ors = " OR ".join("(tx_id=? AND output_index=?)" for _ in refs)
            clauses.append(f"({ors})")
            for r in refs:
                params.extend((r.txhash.bytes, r.index))
        if criteria.notary_names:
            clauses.append(
                "notary_name IN (%s)" % ",".join("?" * len(criteria.notary_names))
            )
            params.extend(criteria.notary_names)
        if criteria.participant_keys:
            keys = criteria.participant_keys
            clauses.append(
                "EXISTS (SELECT 1 FROM vault_participants p WHERE"
                " p.tx_id=vault_states.tx_id AND p.output_index=vault_states.output_index"
                " AND p.participant_key IN (%s))" % ",".join("?" * len(keys))
            )
            params.extend(serialize(k) for k in keys)
        if not criteria.include_soft_locked:
            if criteria.soft_lock_id is not None:
                clauses.append("(lock_id IS NULL OR lock_id=?)")
                params.append(criteria.soft_lock_id)
            else:
                clauses.append("lock_id IS NULL")
        if criteria.token_repr is not None:
            clauses.append("token=?")
            params.append(criteria.token_repr)
        if criteria.quantity_geq is not None:
            clauses.append("quantity>=?")
            params.append(criteria.quantity_geq)
        where = " AND ".join(clauses) if clauses else "1=1"
        return where, params

    def query_by(
        self,
        criteria: QueryCriteria = QueryCriteria(),
        paging: PageSpecification | None = None,
        sort: Sort = Sort(),
    ) -> Page:
        where, params = self._build_query(criteria)
        col = Sort._COLUMNS[sort.by]
        order = f"{col} {'DESC' if sort.descending else 'ASC'}"
        limit = ""
        if paging is not None:
            limit = " LIMIT %d OFFSET %d" % (
                paging.page_size, (paging.page_number - 1) * paging.page_size,
            )
        with self._lock:
            total = self._db.execute(
                f"SELECT COUNT(*) FROM vault_states WHERE {where}", params
            ).fetchone()[0]
            rows = self._db.execute(
                f"SELECT tx_id, output_index, state_blob FROM vault_states"
                f" WHERE {where} ORDER BY {order}{limit}",
                params,
            ).fetchall()
        states = [
            StateAndRef(deserialize(blob), StateRef(SecureHash(tx_id), idx))
            for tx_id, idx, blob in rows
        ]
        return Page(states, total)

    def unconsumed_states(self, state_type: type | None = None) -> list[StateAndRef]:
        crit = QueryCriteria(
            contract_state_types=(state_type,) if state_type else None
        )
        return self.query_by(crit).states

    def untrack(self, callback) -> None:
        with self._lock:
            try:
                self._subscribers.remove(callback)
            except ValueError:
                pass

    def track(self, callback) -> Page:
        """Snapshot + subscription (reference: vaultTrackBy returning
        DataFeed<Vault.Page, Vault.Update>)."""
        with self._lock:
            snapshot = self.query_by()
            self._subscribers.append(callback)
        return snapshot

    # -- soft locking (reference: VaultSoftLockManager.kt) --------------------

    def soft_lock_reserve(self, lock_id: str, refs: list[StateRef]) -> None:
        """Atomically reserve unconsumed, unlocked states; raises and leaves
        nothing locked if any ref is unavailable."""
        with self._lock:
            for ref in refs:
                row = self._db.execute(
                    "SELECT consumed, lock_id FROM vault_states"
                    " WHERE tx_id=? AND output_index=?",
                    (ref.txhash.bytes, ref.index),
                ).fetchone()
                if (row is None or row[0] != 0
                        or (row[1] is not None and row[1] != lock_id)):
                    self._db.rollback()
                    raise SoftLockError(f"state {ref} unavailable for locking")
            for ref in refs:
                self._db.execute(
                    "UPDATE vault_states SET lock_id=? WHERE tx_id=? AND output_index=?",
                    (lock_id, ref.txhash.bytes, ref.index),
                )
            self._db.commit()

    def soft_lock_reacquire(self, lock_id: str, refs: list[StateRef]) -> int:
        """Best-effort re-reservation for flow REPLAY (crash restore or
        park/resume): re-lock every ref still unconsumed and free (or
        already ours), silently skipping the rest — a state the flow's own
        transaction has consumed since selection no longer needs the lock.
        Returns the number re-locked."""
        n = 0
        with self._lock:
            for ref in refs:
                cur = self._db.execute(
                    "UPDATE vault_states SET lock_id=?"
                    " WHERE tx_id=? AND output_index=? AND consumed=0"
                    " AND (lock_id IS NULL OR lock_id=?)",
                    (lock_id, ref.txhash.bytes, ref.index, lock_id),
                )
                n += cur.rowcount
            self._db.commit()
        return n

    def soft_lock_release(self, lock_id: str, refs: list[StateRef] | None = None) -> None:
        with self._lock:
            if refs is None:
                self._db.execute(
                    "UPDATE vault_states SET lock_id=NULL WHERE lock_id=?", (lock_id,)
                )
            else:
                for ref in refs:
                    self._db.execute(
                        "UPDATE vault_states SET lock_id=NULL"
                        " WHERE tx_id=? AND output_index=? AND lock_id=?",
                        (ref.txhash.bytes, ref.index, lock_id),
                    )
            self._db.commit()

    # -- coin selection (reference: CashSelectionH2Impl.kt shape) -------------

    def select_fungible(
        self, token, required_quantity: int, lock_id: str,
        state_type: type | None = None,
    ) -> list[StateAndRef]:
        """Greedy smallest-first selection of unconsumed fungible states
        totalling ≥ required_quantity; soft-locks the selection."""
        crit = QueryCriteria(
            contract_state_types=(state_type,) if state_type else None,
            include_soft_locked=False,
            soft_lock_id=lock_id,
            token_repr=_token_repr(token),
        )
        page = self.query_by(crit, sort=Sort(by="quantity"))
        picked, total = [], 0
        for sr in page.states:
            picked.append(sr)
            total += sr.state.data.amount.quantity
            if total >= required_quantity:
                break
        if total < required_quantity:
            raise SoftLockError(
                f"insufficient funds: have {total}, need {required_quantity}"
            )
        if self._state_index is not None:
            # the index's check of the SQL selection: every pick must be in
            # the unconsumed index; a miss is counted, never fatal (SQL is
            # authoritative)
            bits = self._state_index.contains([sr.ref for sr in picked])
            if bits is not None and not all(bits):
                from .monitoring import node_metrics

                node_metrics().counter(
                    "statestore.vault.select_mismatch"
                ).inc(int(len(bits) - bits.sum()))
        self.soft_lock_reserve(lock_id, [sr.ref for sr in picked])
        return picked

    def unconsumed_ref_exists(self, ref: StateRef) -> bool:
        """Membership of one ref in the UNCONSUMED page: the index answers
        when one is attached (SQL on an injected ``statestore.probe``
        fault), SQL otherwise."""
        if self._state_index is not None:
            bits = self._state_index.contains([ref])
            if bits is not None:
                return bool(bits[0])
        with self._lock:
            row = self._db.execute(
                "SELECT 1 FROM vault_states"
                " WHERE tx_id=? AND output_index=? AND consumed=0",
                (ref.txhash.bytes, ref.index),
            ).fetchone()
        return row is not None

    def close(self) -> None:
        if self._journal is not None:
            self._journal.flush()
            self._journal.close()
        with self._lock:
            self._db.close()


# -------------------------------------------------- wire registrations
# Query/page types travel over RPC (vault_query_by args and results);
# state types inside criteria are encoded by class NAME (the column the
# vault filters on), so clients need not hold the classes.

register_custom(
    QueryCriteria, "vault.QueryCriteria",
    to_fields=lambda c: {
        "status": c.status.value,
        "types": [
            t if isinstance(t, str) else t.__name__
            for t in (c.contract_state_types or [])
        ] or 0,
        "state_refs": list(c.state_refs) if c.state_refs else 0,
        "notary_names": list(c.notary_names) if c.notary_names else 0,
        "participant_keys": (
            list(c.participant_keys) if c.participant_keys else 0
        ),
        "include_soft_locked": 1 if c.include_soft_locked else 0,
        "soft_lock_id": c.soft_lock_id or "",
        "quantity_geq": -1 if c.quantity_geq is None else c.quantity_geq,
        "token_repr": c.token_repr or "",
    },
    from_fields=lambda d: QueryCriteria(
        status=StateStatus(d["status"]),
        contract_state_types=tuple(d["types"]) if d["types"] != 0 else None,
        state_refs=tuple(d["state_refs"]) if d["state_refs"] != 0 else None,
        notary_names=(
            tuple(d["notary_names"]) if d["notary_names"] != 0 else None
        ),
        participant_keys=(
            tuple(d["participant_keys"])
            if d["participant_keys"] != 0 else None
        ),
        include_soft_locked=bool(d["include_soft_locked"]),
        soft_lock_id=d["soft_lock_id"] or None,
        quantity_geq=None if d["quantity_geq"] == -1 else d["quantity_geq"],
        token_repr=d["token_repr"] or None,
    ),
)
register_custom(
    PageSpecification, "vault.PageSpecification",
    to_fields=lambda p: {"page_number": p.page_number, "page_size": p.page_size},
    from_fields=lambda d: PageSpecification(d["page_number"], d["page_size"]),
)
register_custom(
    Sort, "vault.Sort",
    to_fields=lambda s: {"by": s.by, "descending": 1 if s.descending else 0},
    from_fields=lambda d: Sort(d["by"], bool(d["descending"])),
)
register_custom(
    Page, "vault.Page",
    to_fields=lambda p: {
        "states": list(p.states),
        "total": p.total_states_available,
    },
    from_fields=lambda d: Page(list(d["states"]), d["total"]),
)
register_custom(
    VaultUpdate, "vault.Update",
    to_fields=lambda u: {
        "consumed": list(u.consumed), "produced": list(u.produced),
    },
    from_fields=lambda d: VaultUpdate(
        tuple(d["consumed"]), tuple(d["produced"])
    ),
)
