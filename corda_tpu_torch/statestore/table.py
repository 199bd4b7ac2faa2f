"""The device-resident hash table (counterpart of
corda_tpu/statestore/table.py).

One open-addressing table in the card's memory: ``slots_per_shard`` slots
of

- ``keys``  (S, 8) int32: the SHA-256 of the member key as ``"<i4"`` words;
- ``txs``   (S, 8) int32: the raw 32-byte payload beside it (the
  uniqueness provider keeps the consuming tx id here, so an idempotent
  re-commit compares the full 256-bit id on the card);
- ``tags``  (S,)   int32: 0 empty, odd live (the uniqueness table stores
  ``key_word0 | 1``, the vault index an owner-bucket fold), ``TOMBSTONE``
  a slot freed by a remove, which later probes scan past.

A key's home slot is u32(word 2) mod S and its window the ``max_probe``
slots from there, wrapping; a row whose window has no free slot on insert
is reported as overflowing, and the caller spills it to a host tier.

The reference stripes the table over a device mesh; here it is one shard
on one card (``shards`` 1 in ``stats``), with the owner arithmetic kept in
the kernels. Its three device steps are kernels I, J and K
(``ops/statestore.py``): the probe, the fused conflict check and insert,
and the remove. J and K update the table in place (the reference donates
its arrays to the step): a launch that raises leaves the table in an
unknown state, so the table latches itself lost, counts
``statestore.table_lost`` once and raises ``DeviceTableLostError`` on every
later op; the owners let it reach their callers. The reference pads each
dispatch to a power of two only to bound its compiles; the kernels take
any shape and give the same results.

Building a table is the gate's allocation point: nothing here allocates
until an enabled owner builds one.
"""

from __future__ import annotations

import hashlib
import threading

import numpy as np
import torch

from ..device import resolve_device
from ..ops import statestore as ops

TOMBSTONE = ops.TOMBSTONE


class DeviceTableLostError(RuntimeError):
    """A commit or remove launch failed while it was updating the table in
    place, so the table's contents are unknown. The table latches lost and
    every later op raises this, so the owners' failover paths (the
    uniqueness shadow and spill tier, the vault's SQL) take over for the
    rest of the process. Counted once as ``statestore.table_lost``."""


def key_rows(keys: list[bytes]) -> np.ndarray:
    """(N, 8) int32 rows: the SHA-256 of each member key as little-endian
    int32 words."""
    out = np.zeros((len(keys), 8), dtype=np.int32)
    for i, k in enumerate(keys):
        out[i] = np.frombuffer(hashlib.sha256(k).digest(), dtype="<i4")
    return out


def payload_rows(payloads: list[bytes]) -> np.ndarray:
    """(N, 8) int32 rows of raw 32-byte payloads (consuming tx ids), not
    hashed, so a row converts back to its id."""
    out = np.zeros((len(payloads), 8), dtype=np.int32)
    for i, p in enumerate(payloads):
        if len(p) != 32:
            raise ValueError(f"payload must be 32 bytes, got {len(p)}")
        out[i] = np.frombuffer(p, dtype="<i4")
    return out


class DeviceShardedTable:
    """One open-addressing table on ``device`` (the card unless
    ``device="cpu"``, where the kernels' plain versions run). Thread-safe:
    one lock serialises its ops."""

    def __init__(self, device=None, slots_per_shard: int | None = None,
                 max_probe: int | None = None, name: str = "statestore"):
        from . import _register_table, default_max_probe, default_slots_per_shard

        self.name = name
        self.device = resolve_device(device)
        self.n_shards = ops.N_SHARDS
        self.slots_per_shard = int(slots_per_shard or default_slots_per_shard())
        self.max_probe = int(max_probe or default_max_probe())
        if self.max_probe > self.slots_per_shard:
            self.max_probe = self.slots_per_shard
        self.total_slots = self.n_shards * self.slots_per_shard
        self._lock = threading.Lock()
        self._n_live = 0          # host count of live rows
        self._poisoned = False    # a failed in-place launch lost the table
        self._keys = torch.zeros((self.total_slots, 8), dtype=torch.int32, device=self.device)
        self._txs = torch.zeros((self.total_slots, 8), dtype=torch.int32, device=self.device)
        self._tags = torch.zeros(self.total_slots, dtype=torch.int32, device=self.device)
        self._registry_key = _register_table(self)

    # ----------------------------------------------------------- plumbing
    def _check_usable(self) -> None:
        if self._poisoned:
            raise DeviceTableLostError(
                f"device table '{self.name}' was lost to a failed launch; host"
                " tiers are authoritative"
            )

    def close(self) -> None:
        """Drop the table from the monitoring section (it is dropped there
        too when the last reference to it goes)."""
        from . import _unregister_table

        _unregister_table(self._registry_key)

    def _poison(self) -> None:
        """Latch the table lost (once) after an in-place launch failed."""
        if not self._poisoned:
            self._poisoned = True
            from ..node.monitoring import node_metrics

            node_metrics().counter("statestore.table_lost").inc()

    def _upload(self, *arrays: np.ndarray) -> list[torch.Tensor]:
        """The int32 arrays in one host-to-device copy, as contiguous views
        (each starts at a multiple of 32 bytes: the rows stay aligned)."""
        flat = [np.ascontiguousarray(a, dtype=np.int32).reshape(-1) for a in arrays]
        pad = [(-f.size) % 8 for f in flat]
        buf = np.zeros(sum(f.size + p for f, p in zip(flat, pad)), dtype=np.int32)
        views, at = [], 0
        for a, f, p in zip(arrays, flat, pad):
            buf[at:at + f.size] = f
            views.append((at, f.size, a.shape))
            at += f.size + p
        dev = torch.from_numpy(buf).to(self.device)
        return [dev[o:o + n].view(shape) for o, n, shape in views]

    # --------------------------------------------------------- public ops
    def probe_rows(self, rows: np.ndarray) -> np.ndarray:
        """Membership bits for (N, 8) int32 query rows: one launch of kernel
        I; returns (N,) bool."""
        n = rows.shape[0]
        if n == 0:
            return np.zeros(0, dtype=bool)
        (q,) = self._upload(rows)
        with self._lock:
            self._check_usable()
            found = ops.statestore_probe(self._keys, self._tags, q, self.max_probe)
            return found.cpu().numpy() > 0

    def commit_rows(
        self,
        q: np.ndarray,          # (R, K, 8) int32
        qtx: np.ndarray,        # (R, 8) int32
        valid: np.ndarray,      # (R, K) int32
        pre_conflict: np.ndarray,   # (R,) int32
        force: np.ndarray,      # (R,) int32
        qtag: np.ndarray | None = None,   # (R, K) int32 tag values
    ) -> tuple[np.ndarray, np.ndarray]:
        """One device round trip (kernel J): every request's conflict
        verdict, and the insert of every row of the requests that passed.
        Returns (conflict (R,) bool, overflow (R, K) bool). Keys must be
        unique across the batch (the caller sees to it)."""
        r, k = q.shape[0], q.shape[1]
        if r == 0:
            return np.zeros(0, dtype=bool), np.zeros((0, k), dtype=bool)
        if qtag is None:
            qtag = q[:, :, 0]
        args = self._upload(q, qtx, qtag, valid, pre_conflict, force)
        with self._lock:
            self._check_usable()
            try:
                out = ops.statestore_commit(self._keys, self._txs, self._tags, *args,
                                            self.max_probe).cpu().numpy()
            except Exception:
                self._poison()
                raise
            conflict = out[:r] > 0
            overflow = out[r:r + r * k].reshape(r, k) > 0
            self._n_live += int(out[r + r * k])
        return conflict, overflow

    def insert_rows(self, rows: np.ndarray, payloads: np.ndarray,
                    tags: np.ndarray | None = None) -> np.ndarray:
        """Insert-only bulk load (the recovery rebuild, the vault's adds):
        rows already present are skipped, no conflict check. Returns the
        (N,) bool overflow mask. Keys duplicated within one call must be
        removed by the caller."""
        n = rows.shape[0]
        if n == 0:
            return np.zeros(0, dtype=bool)
        _conflict, overflow = self.commit_rows(
            rows.reshape(n, 1, 8), payloads, np.ones((n, 1), np.int32),
            np.zeros(n, np.int32), np.ones(n, np.int32),
            qtag=None if tags is None else tags.reshape(n, 1),
        )
        return overflow.reshape(n)

    def remove_rows(self, rows: np.ndarray) -> np.ndarray:
        """Tombstone (N, 8) rows (kernel K); returns (N,) bool removed (False:
        the key was not in the table: spilled or absent)."""
        n = rows.shape[0]
        if n == 0:
            return np.zeros(0, dtype=bool)
        q, valid = self._upload(rows, np.ones(n, np.int32))
        with self._lock:
            self._check_usable()
            try:
                out = ops.statestore_remove(self._keys, self._txs, self._tags, q, valid,
                                            self.max_probe).cpu().numpy()
            except Exception:
                self._poison()
                raise
            self._n_live -= int(out[n])
            return out[:n] > 0

    def count_tag(self, tag: int) -> int:
        """Live slots carrying exactly ``tag | 1`` (the vault index's
        owner-bucket count): one reduction on the card."""
        with self._lock:
            self._check_usable()
            return int((self._tags == (tag | 1)).sum())

    def live_rows(self) -> tuple[np.ndarray, np.ndarray]:
        """Audit op (digest checks, tests): (keys (N, 8), payloads (N, 8)) of
        every live row, in slot order, copied to the host."""
        with self._lock:
            self._check_usable()
            mask = (self._tags & 1) != 0
            return self._keys[mask].cpu().numpy(), self._txs[mask].cpu().numpy()

    # -------------------------------------------------------------- stats
    @property
    def n_live(self) -> int:
        return self._n_live

    def occupancy(self) -> float:
        return self._n_live / float(self.total_slots)

    def stats(self) -> dict:
        return {
            "name": self.name,
            "shards": self.n_shards,
            "slots_per_shard": self.slots_per_shard,
            "max_probe": self.max_probe,
            "live_rows": self._n_live,
            "occupancy": round(self.occupancy(), 6),
            "poisoned": self._poisoned,
        }
