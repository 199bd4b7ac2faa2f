"""DeviceVaultIndex: the vault's unconsumed-state index on the card
(counterpart of corda_tpu/statestore/vault_index.py).

A second ``DeviceShardedTable`` tracking the vault's UNCONSUMED page:
recording a transaction inserts the produced refs (tag: an owner-bucket
fold of the first participant's key, so "how many unconsumed states does
this owner hold" is one reduction on the card) and tombstones the consumed
ones; ``contains`` answers batched unconsumed-ref membership, which coin
selection cross-checks. Rows the probe window cannot place spill to a host
dict that every membership answer consults, like the provider's spill
tier.

The SQLite vault stays authoritative: the index is kept in step with it,
and an injected ``statestore.probe`` fault on its launch degrades to the SQL
answer (``statestore.vault.probe_failover``) instead of failing the caller.
A real error of a launch, or of a lost table, reaches the caller.
"""

from __future__ import annotations

import hashlib
import threading

import numpy as np

from ..faultinject import InjectedFault, check_site
from ..notary.uniqueness import _ref_key
from .table import DeviceShardedTable, key_rows


def owner_bucket(owner_key) -> int:
    """30-bit odd positive fold of a serialized owner key — the tag
    value grouping an owner's unconsumed rows for the device-side
    count. Bucket collisions merge counts (approximate by design)."""
    from ..serialization import serialize

    h = hashlib.sha256(serialize(owner_key)).digest()
    raw = int.from_bytes(h[:4], "little") & 0x3FFFFFFF
    return (raw << 1) | 1


class DeviceVaultIndex:
    """The index's table lives on ``device`` (the card unless
    ``device="cpu"``)."""

    def __init__(self, device=None, slots_per_shard: int | None = None,
                 max_probe: int | None = None):
        from ..node.monitoring import node_metrics

        self._table = DeviceShardedTable(
            device=device, slots_per_shard=slots_per_shard,
            max_probe=max_probe, name="vault",
        )
        self._spill: dict[bytes, int] = {}   # ref key -> owner bucket
        self._lock = threading.Lock()
        self._metrics = node_metrics()

    # ---------------------------------------------------------- mutation
    def add_states(self, items) -> None:
        """``items``: (StateRef, owner_key_or_None) produced rows.
        Idempotent — re-recording an stx re-offers present rows and the
        table skips them."""
        if not items:
            return
        with self._lock:
            keys = [_ref_key(ref) for ref, _ in items]
            # a key already in the spill tier IS a member: re-offering
            # it to the device could make it resident in BOTH tiers, and
            # a later remove that tombstones only the device copy would
            # leave a stale spill entry reporting it unconsumed forever
            fresh = [
                (i, key) for i, key in enumerate(keys)
                if key not in self._spill
            ]
            if fresh:
                rows = key_rows([key for _, key in fresh])
                payloads = np.zeros((len(fresh), 8), np.int32)
                tags = np.zeros((len(fresh),), np.int32)
                for j, (i, _key) in enumerate(fresh):
                    ref, owner = items[i]
                    payloads[j] = np.frombuffer(
                        ref.txhash.bytes, dtype="<i4"
                    )
                    tags[j] = owner_bucket(owner) if owner is not None else 1
                overflow = self._table.insert_rows(rows, payloads, tags)
                for j, (_i, key) in enumerate(fresh):
                    if overflow[j]:
                        self._spill[key] = int(tags[j])
                        self._metrics.counter(
                            "statestore.vault.spills"
                        ).inc()
            self._metrics.counter("statestore.vault.adds").inc(len(items))

    def remove_states(self, refs) -> None:
        """Tombstone consumed refs — device AND spill: a consumed key
        must survive in neither tier, whichever holds it."""
        if not refs:
            return
        with self._lock:
            keys = [_ref_key(ref) for ref in refs]
            self._table.remove_rows(key_rows(keys))
            for key in keys:
                self._spill.pop(key, None)
            self._metrics.counter("statestore.vault.removes").inc(
                len(refs)
            )

    # --------------------------------------------------------- membership
    def contains(self, refs) -> np.ndarray | None:
        """Batched unconsumed-ref membership, or None on an injected
        ``statestore.probe`` fault — the caller falls back to its
        authoritative SQL answer."""
        if not refs:
            return np.zeros(0, dtype=bool)
        with self._lock:
            keys = [_ref_key(ref) for ref in refs]
            try:
                check_site("statestore.probe")
            except InjectedFault:
                self._metrics.counter(
                    "statestore.vault.probe_failover"
                ).inc()
                return None
            bits = self._table.probe_rows(key_rows(keys))
            for i, key in enumerate(keys):
                if key in self._spill:
                    bits[i] = True
        return bits

    def owner_count(self, owner_key) -> int:
        """Unconsumed rows in this owner's bucket — one device
        reduction plus the host spill scan."""
        bucket = owner_bucket(owner_key)
        with self._lock:
            n = self._table.count_tag(bucket)
            n += sum(1 for b in self._spill.values() if b == bucket)
        return n

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        stats = self._table.stats()
        stats["spill_rows"] = len(self._spill)
        return stats
