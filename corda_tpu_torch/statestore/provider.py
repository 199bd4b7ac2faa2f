"""DeviceShardedUniquenessProvider: the notary's consumed-state set in the
card's memory (counterpart of corda_tpu/statestore/provider.py).

``commit_batch`` settles a whole window in one device round trip
(``DeviceShardedTable.commit_rows``, kernel J): every (request, ref) row is
probed in parallel, each request's conflict verdict is settled, and the
consumed rows of every request that passed are inserted before the launch
returns; the result comes back in one read.

Around the device table sit three host tiers:

- **shadow** (on by default): the exact host map a
  ``DurableUniquenessProvider`` would keep, updated with the device
  verdicts. It is not authoritative (the device bits are), but it gives
  the conflict details (the table stores hashes, which do not convert back
  to ``StateRef``s), is the A/B oracle (``statestore.ab_mismatch`` counts
  the device verdicts that differ from a single-pass host resolution),
  and is what ``consumed_digest()`` hashes, after checking that the
  downloaded device rows and the spill tier equal it row for row, so the
  digest equals the host-map oracle's only when the device table does too.
- **spill**: rows the table could not place (a full probe window) live on
  the host; every probe consults them, and every spill write passes the
  ``statestore.spill`` fault site, where a fault is a hard error
  (``StateStoreSpillError``): the spill tier never fails silently.
- **DurableStore** (optional): the journal format of
  ``DurableUniquenessProvider``, record for record, so recovery replays
  either provider's log; on restart the device table is rebuilt from the
  snapshot and the replay (``statestore.rebuild_rows``).

Keys that appear more than once in a batch are routed to the host: a
request that touches one is resolved in order on the shadow (first wins),
and its committed rows ride the same launch as force-insert rows, so the
kernel only ever sees keys unique in the batch. The ``statestore.probe``
fault site guards the launch; on an injected fault the whole batch resolves
on the shadow with the same verdicts and the committed rows go to the spill
tier (``statestore.probe_failover``), keeping later device probes exact. A
real error of the launch (a kernel that does not build or launch, a lost
table) is not a fault of that site: it reaches the caller, so a window is
never decided on the host in silence.
"""

from __future__ import annotations

import threading

import numpy as np

from ..crypto import SecureHash
from ..faultinject import InjectedFault, check_site
from ..notary.uniqueness import (
    ConsumedStateDetails,
    NotaryError,
    UniquenessConflict,
    UniquenessProvider,
    _ref_key,
)
from .table import DeviceShardedTable, key_rows


class StateStoreSpillError(RuntimeError):
    """A spill-tier write failed. Deliberately loud: a row that fits
    neither the device table nor the spill dict is a lost consumed
    state, i.e. a double-spend waiting to happen."""


class DeviceShardedUniquenessProvider(UniquenessProvider):
    """See the module docstring. The table lives on ``device`` (the card
    unless ``device="cpu"``), or striped over ``mesh``'s ordinals.
    ``store`` (a durability ``DurableStore``) makes it the durable tier's
    device front; ``shadow=False`` is the scale mode (no host map: conflict
    details degrade to empty histories, no A/B, no durable journal, no
    failover). It registers its mega-batch screen until ``close()``."""

    def __init__(self, store=None, *, device=None,
                 slots_per_shard: int | None = None,
                 max_probe: int | None = None, shadow: bool = True, mesh=None):
        from ..node.monitoring import node_metrics
        from . import set_mega_screen

        if store is not None and not shadow:
            raise ValueError("a durable statestore requires the shadow "
                             "map (snapshots serialize it)")
        self._table = DeviceShardedTable(
            device=device, slots_per_shard=slots_per_shard,
            max_probe=max_probe, name="uniqueness", mesh=mesh,
        )
        self._shadow: dict[bytes, ConsumedStateDetails] | None = (
            {} if shadow else None
        )
        self._spill: dict[bytes, ConsumedStateDetails] = {}
        self._signatures: dict = {}
        self._lock = threading.Lock()
        self._metrics = node_metrics()
        self._store = store
        self._last_lsn = -1
        self.last_recovery = None
        if store is not None:
            self.last_recovery = store.recover(
                self._apply, self._load_snapshot
            )
            self._last_lsn = max(self._last_lsn, store.wal.durable_lsn)
            self._rebuild_device()
        # bound once: close() compares with this very object
        self._registered_screen = self._mega_screen
        set_mega_screen(self._registered_screen)

    def _mega_screen(self, rows_dev, n: int):
        """The screen over a serving mega-batch's consumed rows where they
        lie on the card (kernel I, no host copy): the device scalar count of
        members, harvested by the scheduler at settle. The device table
        alone (the spill set is never read), so an advisory count: the
        commit decides conflicts exactly."""
        return self._table.probe_device_count(rows_dev, n)

    # ------------------------------------------------------------ recovery
    def _apply(self, rec: dict) -> None:
        with self._lock:
            if rec["k"] == "commit":
                tx_id, caller = rec["tx"], rec["caller"]
                for i, ref in enumerate(rec["refs"]):
                    self._shadow.setdefault(
                        _ref_key(ref), ConsumedStateDetails(tx_id, i, caller)
                    )
            elif rec["k"] == "sig":
                self._signatures[rec["tx"]] = rec["sig"]

    def _load_snapshot(self, snap: dict) -> None:
        with self._lock:
            for key, details in snap["map"]:
                self._shadow[bytes(key)] = details
            for tx_id, sig in snap["sigs"]:
                self._signatures[tx_id] = sig

    def _snapshot_state(self) -> tuple[dict, int]:
        with self._lock:
            return {
                "map": list(self._shadow.items()),
                "sigs": list(self._signatures.items()),
            }, self._last_lsn

    def _rebuild_device(self, batch: int = 2048) -> None:
        """Bulk-load the recovered shadow into the device table — the
        restart half of the spill/recovery state machine."""
        with self._lock:
            items = list(self._shadow.items())
        t0 = self._metrics.timer("statestore.rebuild")
        with t0.time():
            for lo in range(0, len(items), batch):
                part = items[lo:lo + batch]
                rows = key_rows([k for k, _ in part])
                payloads = np.zeros((len(part), 8), np.int32)
                for i, (_, d) in enumerate(part):
                    payloads[i] = np.frombuffer(
                        d.consuming_tx.bytes, dtype="<i4"
                    )
                overflow = self._table.insert_rows(rows, payloads)
                for i, (k, d) in enumerate(part):
                    if overflow[i]:
                        self._spill_put(k, d)
        self._metrics.counter("statestore.rebuild_rows").inc(len(items))

    # --------------------------------------------------------- spill tier
    def _spill_put(self, key: bytes, details: ConsumedStateDetails) -> None:
        try:
            check_site("statestore.spill")
        except InjectedFault as e:
            self._metrics.counter("statestore.spill_errors").inc()
            raise StateStoreSpillError(
                f"spill-tier write failed for consumed state: {e}"
            ) from e
        self._spill[key] = details
        self._metrics.counter("statestore.spills").inc()

    # ------------------------------------------------------------- commits
    def commit(self, states, tx_id, caller_name) -> None:
        conflict = self.commit_batch([(states, tx_id, caller_name)])[0]
        if conflict is not None:
            raise NotaryError(
                f"input states of {tx_id} already consumed", conflict
            )

    def commit_batch(self, requests):
        if not requests:
            return []
        out: list[UniquenessConflict | None] = [None] * len(requests)
        appended = False
        with self._lock:
            keysets = [
                [_ref_key(ref) for ref in states]
                for states, _tx, _caller in requests
            ]
            seen: dict[bytes, int] = {}
            for ks in keysets:
                for k in ks:
                    seen[k] = seen.get(k, 0) + 1
            dup = {k for k, c in seen.items() if c > 1}
            # (orig_index, is_force) per combined dispatch slot; force
            # slots are host-resolved commits whose rows must still land
            # on device
            combined: list[tuple[int, bool]] = []
            for i, ks in enumerate(keysets):
                if dup and any(k in dup for k in ks):
                    # host route: exact sequential resolution on the
                    # shadow — these keys never reach the kernel's
                    # conflict check, so batch-unique keys is invariant
                    self._metrics.counter("statestore.host_routed").inc()
                    conflict = self._host_conflict(
                        keysets[i], requests[i][0], requests[i][1]
                    )
                    if conflict is not None:
                        out[i] = conflict
                        self._metrics.counter("statestore.conflicts").inc()
                    else:
                        self._metrics.counter("statestore.commits").inc()
                        self._shadow_apply(i, requests, keysets)
                        if self._shadow is None:
                            # scale mode has no shadow to re-derive the
                            # rows from: they live in the spill tier
                            # (membership via spill stays exact)
                            states_i, tx_i, caller_i = requests[i]
                            for j, key in enumerate(keysets[i]):
                                if key not in self._spill:
                                    self._spill_put(
                                        key,
                                        ConsumedStateDetails(
                                            tx_i, j, caller_i
                                        ),
                                    )
                        else:
                            combined.append((i, True))
                else:
                    combined.append((i, False))

            committed_dev = self._dispatch(requests, keysets, combined, out)
            for i in committed_dev:
                self._shadow_apply(i, requests, keysets)

            if self._store is not None:
                for i in range(len(requests)):
                    if out[i] is None:
                        states, tx_id, caller = requests[i]
                        self._last_lsn = self._store.append({
                            "k": "commit", "tx": tx_id,
                            "refs": list(states), "caller": caller,
                        })
                        appended = True
        if appended:
            # group commit OUTSIDE the map lock (same ack contract as
            # DurableUniquenessProvider)
            self._store.flush()
        if self._store is not None and self._store.snapshot_due():
            state, lsn = self._snapshot_state()
            self._store.snapshot(state, covered_lsn=lsn)
        return out

    def _host_conflict(self, keys, states, tx_id):
        """Exact host conflict resolution for one request (shadow mode;
        spill-only approximation in scale mode)."""
        src = self._shadow if self._shadow is not None else self._spill
        conflict = {}
        for ref, k in zip(states, keys):
            prior = src.get(k)
            if prior is not None and prior.consuming_tx != tx_id:
                conflict[ref] = prior
        if self._shadow is None:
            # scale mode: duplicated keys may also be device-resident;
            # a device hit has no invertible details, so it reports an
            # empty-history conflict (documented degradation)
            unresolved = [
                (ref, k) for ref, k in zip(states, keys)
                if k not in self._spill
            ]
            if unresolved:
                hits = self._table.probe_rows(
                    key_rows([k for _, k in unresolved])
                )
                for (ref, _k), hit in zip(unresolved, hits):
                    if hit:
                        conflict.setdefault(ref, None)
            if any(v is None for v in conflict.values()):
                return UniquenessConflict(
                    {r: v for r, v in conflict.items() if v is not None}
                )
        return UniquenessConflict(conflict) if conflict else None

    def _shadow_apply(self, i, requests, keysets) -> None:
        if self._shadow is None:
            return
        states, tx_id, caller = requests[i]
        for j, k in enumerate(keysets[i]):
            # tpu-lint: allow=lock-discipline callers hold self._lock
            self._shadow.setdefault(
                k, ConsumedStateDetails(tx_id, j, caller)
            )

    def _dispatch(self, requests, keysets, combined, out) -> list[int]:
        """The fused device round-trip for the combined slots. Fills
        ``out`` for device-routed requests, spills overflow rows, and
        returns the device-routed indices that committed (the caller
        applies those to the shadow)."""
        if not combined:
            return []
        r = len(combined)
        k = max(len(keysets[i]) for i, _ in combined)
        k = max(k, 1)
        q = np.zeros((r, k, 8), np.int32)
        qtx = np.zeros((r, 8), np.int32)
        valid = np.zeros((r, k), np.int32)
        pre_conflict = np.zeros((r,), np.int32)
        force = np.zeros((r,), np.int32)
        seen_force: set[bytes] = set()
        for slot, (i, is_force) in enumerate(combined):
            ks = keysets[i]
            tx_id = requests[i][1]
            qtx[slot] = np.frombuffer(tx_id.bytes, dtype="<i4")
            if ks:
                q[slot, :len(ks)] = key_rows(ks)
            force[slot] = 1 if is_force else 0
            for j, key in enumerate(ks):
                prior = self._spill.get(key)
                if prior is not None:
                    # host-resident row: membership (and any conflict)
                    # is decided here; never double-represent it on
                    # device
                    if prior.consuming_tx != tx_id and not is_force:
                        pre_conflict[slot] = 1
                elif key in seen_force:
                    # an identical idempotent retry in the same batch:
                    # the earlier force slot installs (or spills) the
                    # key — a second valid row would insert a duplicate
                    pass
                else:
                    valid[slot, j] = 1
            if is_force:
                seen_force.update(ks)
        self._metrics.counter("statestore.probe_rows").inc(
            int(valid.sum())
        )
        try:
            check_site("statestore.probe")
        except InjectedFault as e:
            return self._failover(requests, keysets, combined, out, e)
        conflict_bits, overflow = self._table.commit_rows(
            q, qtx, valid, pre_conflict, force
        )
        committed = []
        for slot, (i, is_force) in enumerate(combined):
            states, tx_id, caller = requests[i]
            if not is_force:
                if self._shadow is not None:
                    # A/B: single-pass host verdict on the (not yet
                    # updated) shadow vs the device bit
                    host_bit = any(
                        (p := self._shadow.get(key)) is not None
                        and p.consuming_tx != tx_id
                        for key in keysets[i]
                    )
                    if host_bit != bool(conflict_bits[slot]):
                        self._metrics.counter(
                            "statestore.ab_mismatch"
                        ).inc()
                if conflict_bits[slot]:
                    out[i] = self._conflict_details(
                        states, keysets[i], tx_id
                    )
                    self._metrics.counter("statestore.conflicts").inc()
                    continue
                committed.append(i)
                self._metrics.counter("statestore.commits").inc()
            for j, key in enumerate(keysets[i]):
                if overflow[slot, j]:
                    self._spill_put(
                        key, ConsumedStateDetails(tx_id, j, caller)
                    )
        return committed

    def _conflict_details(self, states, keys, tx_id) -> UniquenessConflict:
        """The device verdict is a bit; the ref-level history comes from
        the shadow (or spill in scale mode — possibly empty)."""
        src = self._shadow if self._shadow is not None else self._spill
        conflict = {}
        for ref, key in zip(states, keys):
            prior = src.get(key)
            if prior is not None and prior.consuming_tx != tx_id:
                conflict[ref] = prior
        return UniquenessConflict(conflict)

    def _failover(self, requests, keysets, combined, out, err) -> list:
        """An injected ``statestore.probe`` fault: resolve every
        device-routed slot on the shadow with identical verdicts; committed
        rows (including the already-resolved force slots', which never
        reached the device) land in the spill tier so later device probes
        stay exact."""
        if self._shadow is None:
            raise NotaryError(
                f"statestore device dispatch failed with no host shadow "
                f"to fail over to: {err}"
            ) from err
        self._metrics.counter("statestore.probe_failover").inc()
        committed = []
        for i, is_force in combined:
            states, tx_id, caller = requests[i]
            if not is_force:
                conflict = self._host_conflict(keysets[i], states, tx_id)
                if conflict is not None:
                    out[i] = conflict
                    self._metrics.counter("statestore.conflicts").inc()
                    continue
                committed.append(i)
                self._metrics.counter("statestore.commits").inc()
                self._shadow_apply(i, requests, keysets)
            for j, key in enumerate(keysets[i]):
                if key not in self._spill:
                    self._spill_put(
                        key,
                        self._shadow.get(
                            key, ConsumedStateDetails(tx_id, j, caller)
                        ),
                    )
        # the shadow was already applied here (the caller skips
        # re-applying what it did not commit)
        return []

    # -------------------------------------------------- attestation journal
    def record_signature(self, tx_id: SecureHash, sig) -> None:
        with self._lock:
            self._signatures[tx_id] = sig
            if self._store is not None:
                self._last_lsn = self._store.append(
                    {"k": "sig", "tx": tx_id, "sig": sig}
                )

    def recovered_signatures(self) -> dict:
        with self._lock:
            return dict(self._signatures)

    # ---------------------------------------------------------- inspection
    def committed_txs(self) -> int:
        with self._lock:
            if self._shadow is not None:
                return len({
                    d.consuming_tx for d in self._shadow.values()
                })
            _keys, txs = self._table.live_rows()
            dev = {t.tobytes() for t in txs}
            dev.update(
                d.consuming_tx.bytes for d in self._spill.values()
            )
            return len(dev)

    def _device_row_set(self) -> set[tuple[bytes, bytes]]:
        """(hashed-key bytes, raw consuming-tx bytes) of every row the
        device ∪ spill tiers hold — the audit view."""
        import hashlib

        dev_keys, dev_txs = self._table.live_rows()
        rows = {
            (dev_keys[i].tobytes(), dev_txs[i].tobytes())
            for i in range(dev_keys.shape[0])
        }
        for key, d in self._spill.items():
            rows.add((hashlib.sha256(key).digest(), d.consuming_tx.bytes))
        return rows

    def device_divergence(self) -> int:
        """Rows on which the device ∪ spill tiers and the shadow
        disagree (symmetric difference; 0 = bit-consistent)."""
        import hashlib

        with self._lock:
            if self._shadow is None:
                return 0
            want = {
                (hashlib.sha256(k).digest(), d.consuming_tx.bytes)
                for k, d in self._shadow.items()
            }
            have = self._device_row_set()
        return len(want ^ have)

    def consumed_digest(self) -> str:
        """Bit-identical to ``DurableUniquenessProvider.consumed_digest``
        — PROVIDED the device table agrees with the shadow: the digest
        folds in any device/shadow divergence, so it only matches the
        host-map oracle when the accelerator-resident set does too."""
        import hashlib

        with self._lock:
            if self._shadow is None:
                # scale mode: a self-consistent digest over the device
                # content (restart parity), not oracle-comparable
                rows = sorted(self._device_row_set())
                h = hashlib.sha256()
                for key_h, tx in rows:
                    h.update(key_h)
                    h.update(tx)
                return h.hexdigest()
            want = {
                (hashlib.sha256(k).digest(), d.consuming_tx.bytes)
                for k, d in self._shadow.items()
            }
            have = self._device_row_set()
            divergence = len(want ^ have)
            h = hashlib.sha256()
            for key in sorted(self._shadow):
                d = self._shadow[key]
                h.update(key)
                h.update(d.consuming_tx.bytes)
                h.update(d.input_index.to_bytes(4, "big"))
                h.update(d.requesting_party_name.encode())
        if divergence:
            self._metrics.counter(
                "statestore.digest_audit_mismatch"
            ).inc()
            h.update(b"statestore-device-divergence:")
            h.update(divergence.to_bytes(8, "big"))
        return h.hexdigest()

    def spill_count(self) -> int:
        with self._lock:
            return len(self._spill)

    def table_stats(self) -> dict:
        stats = self._table.stats()
        stats["spill_rows"] = len(self._spill)
        return stats

    def snapshot_now(self) -> None:
        if self._store is None:
            return
        state, lsn = self._snapshot_state()
        self._store.snapshot(state, covered_lsn=lsn)

    def close(self) -> None:
        from . import active_mega_screen, set_mega_screen

        if active_mega_screen() is self._registered_screen:
            set_mega_screen(None)
        self._table.close()
        if self._store is not None:
            self._store.flush()
            self._store.close()
