"""Batched recomputation of WireTransaction Merkle ids on the card.

Counterpart of corda_tpu/ops/txid.py (``_merkle_levels`` :46,
``_tx_id_roots`` :101, ``_tx_id_roots_device`` :152, ``compute_tx_ids`` :91,
``PendingIds`` :211, ``dispatch_prime_ids`` :350, ``prime_ids`` :378). The
hash schedule is ledger/wire.py's:

  1. every component nonce       -> host hashlib (as in the reference, :159:
                                    their digests are needed on the host to
                                    build the leaf messages anyway);
  2. every leaf sha256(nonce || component) -> one launch of kernel C;
  3. every group tree, level by level, every tree of the cohort reducing
     together, then every top tree (7 groups padded to 8, three levels)
                                 -> one launch of kernel D for them all.

The level structure is host bookkeeping known before any hashing, so the
whole sweep is planned first and its digest pool allocated once on the
device: leaves, the zero row, then each level's parents. The reference
runs the sweep as one jitted device program; kernel D takes every level in
one launch, with its child indices in one upload. No level is read back;
``collect()`` pays one readback of the roots.

The recompute-and-check sweep of the back-chain resolve
(``PendingIdCheck`` :467, ``dispatch_check_ids`` :545,
``check_and_prime_ids`` :562) enqueues the same sweep over claimed ids and
checks them at ``collect()``, always on the device the caller names. The
reference's tiering (``ids_tier`` :234, ``_measured_link_rtt_s`` :265,
``device_verify_worthwhile`` :325), which moves the sweep and the
signatures to the host over a link of 5 ms or more, is not ported: a
card on its own host's PCIe link never reaches it (ROADMAP.md, Queue 1
item 16). Nor is the reference's native host id engine
(``native/id_engine.cpp``).

The notary's ``dispatch_prime_ids`` always runs the sweep on the caller's
device; ``device="cpu"`` runs the kernels' plain versions.
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np
import torch

from ..crypto import SecureHash
from ..device import resolve_device
from ..ledger import TransactionVerificationException
from ..ledger.wire import ComponentGroupType
from ._blockpack import start_host_copy
from .sha256 import digest_words_to_bytes, sha256_leaves, sha256_merkle_sweep, upload_messages


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


def _merkle_levels(trees: list[list[int]], base: int):
    """Plan the reduction of many Merkle trees together, level by level.
    ``trees``: per tree, the pool rows of its pow2-padded leaf
    row; pool rows from ``base`` up are free. Returns ``(root_rows,
    levels, next_free_row)`` where each level is ``(first_row, left_rows,
    right_rows)``: its parents go to consecutive rows from ``first_row``."""
    trees = [list(t) for t in trees]
    levels = []
    while any(len(t) > 1 for t in trees):
        left, right = [], []
        first = base
        for t in trees:
            if len(t) == 1:
                continue
            new_t = []
            for i in range(0, len(t), 2):
                left.append(t[i])
                right.append(t[i + 1])
                new_t.append(first + len(left) - 1)
            t[:] = new_t
        levels.append((first, left, right))
        base += len(left)
    return [t[0] for t in trees], levels, base


def _flatten(wtxs: list):
    """Every (tx, group, index) component of the cohort: its nonce message,
    its bytes, and per tx and group the span of its rows."""
    nonce_msgs: list[bytes] = []
    comp_bytes: list[bytes] = []
    spans: list[list[tuple[int, int]]] = []  # per tx, per group: row slice
    cursor = 0
    for wtx in wtxs:
        tx_spans = []
        salt = wtx.privacy_salt.salt
        for g in ComponentGroupType:
            raws = wtx.component_bytes(g)
            for i, raw in enumerate(raws):
                nonce_msgs.append(salt + b"CTNONCE" + struct.pack("<II", int(g), i))
                comp_bytes.append(raw)
            tx_spans.append((cursor, cursor + len(raws)))
            cursor += len(raws)
        spans.append(tx_spans)
    return nonce_msgs, comp_bytes, spans


def _plan(nonce_msgs, comp_bytes, spans):
    """The host half of the sweep: the nonce digests (hashlib), the leaf
    messages nonce || component, and the level plan. Pool rows: the
    leaves, then the ZERO_HASH row (all-zero words), then each level's
    parents. Returns (leaf messages, levels, top roots, pool rows)."""
    nonces = [hashlib.sha256(m).digest() for m in nonce_msgs]
    zero_row = len(comp_bytes)
    trees: list[list[int]] = []
    tree_of: list[list[int | None]] = []  # per tx: group -> tree index | None
    for tx_spans in spans:
        per_tx = []
        for lo, hi in tx_spans:
            n = hi - lo
            if n == 0:
                per_tx.append(None)  # empty group -> ZERO_HASH
                continue
            trees.append(list(range(lo, hi)) + [zero_row] * (_pow2(n) - n))
            per_tx.append(len(trees) - 1)
        tree_of.append(per_tx)
    roots, levels, free = _merkle_levels(trees, zero_row + 1)
    top_trees = []
    for per_tx in tree_of:
        row = [roots[t] if t is not None else zero_row for t in per_tx]
        top_trees.append(row + [zero_row] * (_pow2(len(row)) - len(row)))
    top_roots, top_levels, free = _merkle_levels(top_trees, free)
    leaf_msgs = [n + c for n, c in zip(nonces, comp_bytes)]
    return leaf_msgs, levels + top_levels, top_roots, free


def _tx_id_roots(wtxs: list, device: torch.device):
    """Enqueue the id computation: returns (root rows, device pool)."""
    return _tx_id_roots_device(*_flatten(wtxs), device)


def _tx_id_roots_device(nonce_msgs, comp_bytes, spans, device: torch.device):
    """The device half of the id sweep: kernel C over the leaves and one
    launch of kernel D over every level, into one pool preallocated at the
    plan's size. No level is read back."""
    leaf_msgs, levels, top_roots, rows = _plan(nonce_msgs, comp_bytes, spans)
    n_leaves = len(leaf_msgs)
    pool = torch.empty((rows, 8), dtype=torch.int32, device=device)
    pool[n_leaves].zero_()
    if n_leaves:
        sha256_leaves(*upload_messages(leaf_msgs, device), out=pool[:n_leaves])
    if levels:
        sha256_merkle_sweep(pool, upload_levels(levels, device))
    return top_roots, pool


def upload_levels(levels, device: torch.device) -> list:
    """A level plan's child rows in one upload: (first, left, right) per
    level, left and right slices of that one tensor on ``device``."""
    flat = np.concatenate([np.asarray(side, dtype=np.int32)
                           for _first, left, right in levels for side in (left, right)])
    idx = torch.from_numpy(flat).to(device)
    out, at = [], 0
    for first, left, _right in levels:
        m = len(left)
        out.append((first, idx[at : at + m], idx[at + m : at + 2 * m]))
        at += 2 * m
    return out


def _gather_roots(pool: torch.Tensor, roots: list[int]) -> torch.Tensor:
    return pool.index_select(0, torch.tensor(roots, dtype=torch.int64, device=pool.device))


def _fetch_ids(pool: torch.Tensor, roots: list[int]) -> list[SecureHash]:
    """The one readback: the root digests out of the device pool."""
    id_words = _gather_roots(pool, roots).cpu().numpy()
    return [SecureHash(b) for b in digest_words_to_bytes(id_words)]


def compute_tx_ids(wtxs: list, device=None) -> list[SecureHash]:
    """Recompute every transaction's Merkle id on ``device`` (the card
    unless ``device="cpu"``). Ids in input order, bit-identical to
    ``WireTransaction.id``."""
    if not wtxs:
        return []
    roots, pool = _tx_id_roots(wtxs, resolve_device(device))
    return _fetch_ids(pool, roots)


class PendingIds:
    """An enqueued id sweep: the Merkle reduction, the root gather and the
    roots' copy to the host are queued on the device (only the compact
    (n, 8) rows outlive the pool); ``collect()`` waits for the copy and
    primes the wire transactions' id caches."""

    __slots__ = ("_cold", "_id_words")

    def __init__(self, cold, id_words):
        self._cold = cold
        self._id_words = id_words  # HostCopy of the (n, 8) root words

    def collect(self) -> None:
        if not self._cold:
            return
        id_bytes = digest_words_to_bytes(self._id_words.wait())
        for stx, raw in zip(self._cold, id_bytes):
            object.__getattribute__(stx.tx, "__dict__")["_id"] = SecureHash(raw)
        self._cold = []


def dispatch_prime_ids(stxs: list, device=None) -> PendingIds:
    """Enqueue the id sweep for every SignedTransaction whose wire tx has a
    cold id cache; ``collect()`` primes the caches. This is the notary's
    receive-path integrity work: the id every signature is checked against
    is recomputed from the component bytes here."""
    cold = [stx for stx in stxs
            if "_id" not in object.__getattribute__(stx.tx, "__dict__")]
    if not cold:
        return PendingIds([], None)
    roots, pool = _tx_id_roots([stx.tx for stx in cold], resolve_device(device))
    return PendingIds(cold, start_host_copy(_gather_roots(pool, roots)))


def prime_ids(stxs: list, device=None) -> None:
    """Synchronous wrapper: enqueue and collect in one call."""
    dispatch_prime_ids(stxs, device).collect()


# ------------------------------------------- the recompute-and-check sweep


class PendingIdCheck:
    """An enqueued recompute-and-check sweep over ``(claimed id, signed
    transaction)`` items: the sweep, the root gather and the roots' copy to
    the host are queued with no readback. ``collect()`` primes every wire
    transaction's id cache with its recomputed id, then raises the first
    claimed id that differs."""

    __slots__ = ("_items", "_id_words")

    def __init__(self, items, id_words):
        self._items = items
        self._id_words = id_words  # HostCopy of the (n, 8) root words; None when no items

    def ready(self) -> bool:
        return self._id_words is None or self._id_words.ready()

    def collect(self) -> None:
        items, self._items = self._items, []
        if not items:
            return
        try:
            id_bytes = digest_words_to_bytes(self._id_words.wait())
        except BaseException:
            # nothing was checked: no claimed id may stay cached
            self.drop_unchecked(items)
            raise
        self._id_words = None
        ids = [SecureHash(raw) for raw in id_bytes]
        # prime every recomputed id before raising the first mismatch, so no
        # forged claim stays cached, those past the first mismatch included
        mismatch = None
        for (claimed, stx), computed in zip(items, ids):
            object.__getattribute__(stx.tx, "__dict__")["_id"] = computed
            if mismatch is None and computed != claimed:
                mismatch = (claimed, computed)
        if mismatch is not None:
            claimed, computed = mismatch
            raise TransactionVerificationException(
                claimed,
                f"transaction id mismatch: claimed {claimed}, recomputed {computed}",
            )

    def abort(self) -> None:
        """Roll back without checking: drop the cached id of every item not
        collected (a pipelined caller primes claimed ids at dispatch).
        Idempotent; a no-op after ``collect()``."""
        items, self._items = self._items, []
        self._id_words = None
        self.drop_unchecked(items)

    @staticmethod
    def drop_unchecked(items) -> None:
        for _tid, stx in items:
            object.__getattribute__(stx.tx, "__dict__").pop("_id", None)


def dispatch_check_ids(stxs: dict, device=None) -> PendingIdCheck:
    """Enqueue the recompute-and-check sweep for ``{claimed id: signed
    transaction}`` on ``device`` (the card unless ``device="cpu"``, which
    runs the kernels' plain versions); ``collect()`` raises the first
    mismatch and primes the caches."""
    items = list(stxs.items())
    if not items:
        return PendingIdCheck(items, None)
    roots, pool = _tx_id_roots([stx.tx for _tid, stx in items], resolve_device(device))
    return PendingIdCheck(items, start_host_copy(_gather_roots(pool, roots)))


def check_and_prime_ids(stxs: dict, device=None) -> None:
    """Synchronous ``dispatch_check_ids``: recompute every transaction's
    id, raise on a mismatch (a forged chain link), else prime the caches."""
    dispatch_check_ids(stxs, device).collect()
