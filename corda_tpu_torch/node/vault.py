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

Left out, each with the layer that brings it (ROADMAP.md, Queue 1): the
durability journal (``journal=``: :114, :146-155, :167-175, :204-213,
:296-300, ``_apply_journal``/``_dump_pages``/``_load_pages`` :304-352,
``snapshot_now`` :393-402 and the close at :617-619) with step 4b, and the
device-resident state index (``state_index=``: :115, :156-166, :176-182,
:230/:273-279/:281-294, ``_rebuild_state_index`` :354-373, the selection
cross-check :586-597 and the probe at :604-607) with step 7.
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

    def __init__(self, path: str = ":memory:", my_keys=None, observe_all=False):
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
        (reference: NodeVaultService.notifyAll)."""
        update, subs = self._apply_stx(stx)
        if not update.is_empty:
            for cb in subs:
                cb(update)
        return update

    def _apply_stx(self, stx: SignedTransaction):
        """The SQL half of recording one transaction — idempotent (replay
        of an already-recorded stx changes nothing)."""
        wtx = stx.tx
        produced: list[StateAndRef] = []
        consumed: list[StateAndRef] = []
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
                    # an idempotent re-record (a client retry) cannot
                    # duplicate participant rows
                    for p in getattr(tstate.data, "participants", ()):
                        key = getattr(p, "owning_key", p)
                        self._db.execute(
                            "INSERT INTO vault_participants VALUES (?,?,?)",
                            (stx.id.bytes, idx, serialize(key)),
                        )
                produced.append(StateAndRef(tstate, ref))
            self._db.commit()
            subs = list(self._subscribers)
        return VaultUpdate(tuple(consumed), tuple(produced)), subs

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
        self.soft_lock_reserve(lock_id, [sr.ref for sr in picked])
        return picked

    def unconsumed_ref_exists(self, ref: StateRef) -> bool:
        """Membership of one ref in the UNCONSUMED page."""
        with self._lock:
            row = self._db.execute(
                "SELECT 1 FROM vault_states"
                " WHERE tx_id=? AND output_index=? AND consumed=0",
                (ref.txhash.bytes, ref.index),
            ).fetchone()
        return row is not None

    def close(self) -> None:
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
