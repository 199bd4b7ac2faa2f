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

The reference stripes the table over its device mesh (``NamedSharding``).
Here the table is one shard on ``device`` by default (one card), or, given
a ``parallel.mesh.Mesh``, one shard an ordinal, each on its ordinal's
device: a key's owner shard is u32(word 1) mod the mesh's width and its
home slot u32(word 2) mod ``slots_per_shard`` within that shard, so the
shards laid end to end are the reference's table slot for slot. Its three
device steps are kernels I, J and K (``ops/statestore.py``): the probe,
the fused conflict check and insert, and the remove, each launched on
every shard for the rows it owns; a commit over several shards runs J's
check on every shard first, so each shard inserts under the request's
verdict over all of them. J and K update the table in place (the reference donates
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
    ``device="cpu"``, where the kernels' plain versions run), or striped
    over ``mesh``'s ordinals. Thread-safe: one lock serialises its ops."""

    def __init__(self, device=None, slots_per_shard: int | None = None,
                 max_probe: int | None = None, name: str = "statestore", mesh=None):
        from . import _register_table, default_max_probe, default_slots_per_shard

        self.name = name
        devices = [resolve_device(device)] if mesh is None else list(mesh.devices)
        self.device = devices[0]
        self.n_shards = len(devices)
        self.slots_per_shard = int(slots_per_shard or default_slots_per_shard())
        self.max_probe = int(max_probe or default_max_probe())
        if self.max_probe > self.slots_per_shard:
            self.max_probe = self.slots_per_shard
        self.total_slots = self.n_shards * self.slots_per_shard
        self._lock = threading.Lock()
        self._n_live = 0          # host count of live rows
        self._poisoned = False    # a failed in-place launch lost the table
        # (keys, txs, tags) of each shard, on its ordinal's device
        self._shards = [
            (torch.zeros((self.slots_per_shard, 8), dtype=torch.int32, device=d),
             torch.zeros((self.slots_per_shard, 8), dtype=torch.int32, device=d),
             torch.zeros(self.slots_per_shard, dtype=torch.int32, device=d))
            for d in devices
        ]
        self._registry_key = _register_table(self)

    # the first shard's tensors: the whole table of a one-card table
    @property
    def _keys(self) -> torch.Tensor:
        return self._shards[0][0]

    @property
    def _txs(self) -> torch.Tensor:
        return self._shards[0][1]

    @property
    def _tags(self) -> torch.Tensor:
        return self._shards[0][2]

    def table_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(keys, txs, tags) of the whole table, shards end to end, copied
        to the host (the reference's global layout)."""
        with self._lock:
            return tuple(torch.cat([sh[i].cpu() for sh in self._shards]).numpy()
                         for i in range(3))

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

    def _upload(self, *arrays: np.ndarray, device=None) -> list[torch.Tensor]:
        """The int32 arrays in one host-to-device copy (to ``device``, the
        first shard's when None), as contiguous views (each starts at a
        multiple of 32 bytes: the rows stay aligned)."""
        flat = [np.ascontiguousarray(a, dtype=np.int32).reshape(-1) for a in arrays]
        pad = [(-f.size) % 8 for f in flat]
        buf = np.zeros(sum(f.size + p for f, p in zip(flat, pad)), dtype=np.int32)
        views, at = [], 0
        for a, f, p in zip(arrays, flat, pad):
            buf[at:at + f.size] = f
            views.append((at, f.size, a.shape))
            at += f.size + p
        dev = torch.from_numpy(buf).to(self.device if device is None else device)
        return [dev[o:o + n].view(shape) for o, n, shape in views]

    def _each_shard(self, *arrays: np.ndarray):
        """(shard index, (keys, txs, tags), the arrays uploaded to the
        shard's device) for each shard; one upload a device."""
        uploaded: dict = {}
        for s, tab in enumerate(self._shards):
            dev = tab[2].device
            if dev not in uploaded:
                uploaded[dev] = self._upload(*arrays, device=dev)
            yield s, tab, uploaded[dev]

    # --------------------------------------------------------- public ops
    def probe_rows(self, rows: np.ndarray) -> np.ndarray:
        """Membership bits for (N, 8) int32 query rows: one launch of kernel
        I a shard; returns (N,) bool."""
        n = rows.shape[0]
        if n == 0:
            return np.zeros(0, dtype=bool)
        with self._lock:
            self._check_usable()
            found = np.zeros(n, dtype=bool)
            for s, (keys, _txs, tags), (q,) in self._each_shard(rows):
                found |= ops.statestore_probe(keys, tags, q, self.max_probe, self.n_shards,
                                              s).cpu().numpy() > 0
            return found

    def probe_device_count(self, rows_dev: torch.Tensor, n: int) -> torch.Tensor:
        """The screen over rows already on the card (the serving
        mega-batch's all-gathered consumed rows): kernel I a shard on the
        (B, 8) int32 ``rows_dev`` with no host copy, returning the device
        scalar count of the first ``n`` rows that are members. It reads the
        device table alone (never the caller's spill set), so it is an
        advisory count (``statestore.mega_probe_hits``), never a verdict."""
        with self._lock:
            self._check_usable()
            total = None
            for s, (keys, _txs, tags) in enumerate(self._shards):
                q = rows_dev.to(tags.device, dtype=torch.int32).contiguous()
                c = ops.statestore_probe(keys, tags, q, self.max_probe, self.n_shards,
                                         s)[:n].sum(dtype=torch.int32)
                total = c if total is None else total + c.to(total.device)
            return total

    def commit_rows(
        self,
        q: np.ndarray,          # (R, K, 8) int32
        qtx: np.ndarray,        # (R, 8) int32
        valid: np.ndarray,      # (R, K) int32
        pre_conflict: np.ndarray,   # (R,) int32
        force: np.ndarray,      # (R,) int32
        qtag: np.ndarray | None = None,   # (R, K) int32 tag values
    ) -> tuple[np.ndarray, np.ndarray]:
        """One device round trip (kernel J a shard): every request's
        conflict verdict, and the insert of every row of the requests that
        passed. Returns (conflict (R,) bool, overflow (R, K) bool). Keys must
        be unique across the batch (the caller sees to it)."""
        r, k = q.shape[0], q.shape[1]
        if r == 0:
            return np.zeros(0, dtype=bool), np.zeros((0, k), dtype=bool)
        if qtag is None:
            qtag = q[:, :, 0]
        with self._lock:
            self._check_usable()
            pre = np.asarray(pre_conflict, dtype=np.int32)
            if self.n_shards > 1:
                # every shard's conflicting rows first: a shard inserts only
                # under the request's verdict over all of them
                conf_rows = np.zeros(r * k, dtype=bool)
                for s, (keys, txs, tags), (qd, qtxd, vd) in self._each_shard(q, qtx, valid):
                    flags = ops.statestore_commit_check(keys, txs, tags, qd, qtxd, vd,
                                                        self.max_probe, self.n_shards, s)
                    conf_rows |= flags[r * k:].cpu().numpy() > 0
                pre = ((pre != 0) | conf_rows.reshape(r, k).any(axis=1)).astype(np.int32)
            conflict = overflow = None
            for s, (keys, txs, tags), args in self._each_shard(q, qtx, qtag, valid, pre, force):
                try:
                    out = ops.statestore_commit(keys, txs, tags, *args, self.max_probe,
                                                self.n_shards, s).cpu().numpy()
                except Exception:
                    self._poison()
                    raise
                if conflict is None:
                    conflict = out[:r] > 0
                    overflow = np.zeros((r, k), dtype=bool)
                overflow |= out[r:r + r * k].reshape(r, k) > 0
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
        """Tombstone (N, 8) rows (kernel K a shard); returns (N,) bool
        removed (False: the key was not in the table: spilled or absent)."""
        n = rows.shape[0]
        if n == 0:
            return np.zeros(0, dtype=bool)
        with self._lock:
            self._check_usable()
            removed = np.zeros(n, dtype=bool)
            for s, (keys, txs, tags), (q, valid) in self._each_shard(rows, np.ones(n, np.int32)):
                try:
                    out = ops.statestore_remove(keys, txs, tags, q, valid, self.max_probe,
                                                self.n_shards, s).cpu().numpy()
                except Exception:
                    self._poison()
                    raise
                self._n_live -= int(out[n])
                removed |= out[:n] > 0
            return removed

    def count_tag(self, tag: int) -> int:
        """Live slots carrying exactly ``tag | 1`` (the vault index's
        owner-bucket count): one reduction a shard on the card."""
        with self._lock:
            self._check_usable()
            return sum(int((tags == (tag | 1)).sum()) for _k, _t, tags in self._shards)

    def live_rows(self) -> tuple[np.ndarray, np.ndarray]:
        """Audit op (digest checks, tests): (keys (N, 8), payloads (N, 8)) of
        every live row, in slot order, copied to the host."""
        with self._lock:
            self._check_usable()
            keys, txs = [], []
            for k, t, tags in self._shards:
                mask = (tags & 1) != 0
                keys.append(k[mask].cpu().numpy())
                txs.append(t[mask].cpu().numpy())
            return np.concatenate(keys), np.concatenate(txs)

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
