"""The device state store's kernels I, J and K, and their plain versions.

Counterpart of the three device steps of corda_tpu/statestore/table.py: the
probe (``_probe_step`` :190), the fused conflict check and insert
(``_commit_step`` :225) and the tombstoning remove (``_remove_step`` :317)
of an open-addressing table in device memory. The table is three tensors:
``keys`` (S, 8) int32 (the ``"<i4"`` words of a SHA-256), ``txs`` (S, 8)
int32 (a raw 32-byte payload) and ``tags`` (S,) int32 (0 empty, odd live,
``TOMBSTONE`` freed). A key's owner shard is u32(word 1) mod ``N_SHARDS``
and its home slot u32(word 2) mod S; a probe scans ``max_probe`` slots from
the home slot, wrapping (csrc/statestore.cuh).

- Kernel I, ``statestore_probe``: (n,) membership bits, a warp a row.
- Kernel J, ``statestore_commit``: two launches on one stream. Phase 1
  gives each (request, ref) row ``present`` and ``conflict`` in parallel;
  phase 2 settles each request's verdict, then inserts the rows of the
  requests that passed into the first free slot of their windows, or
  reports them overflowing, with the serial order's result: in rounds of
  rows whose windows overlap no earlier row left, in parallel, then one
  warp walks the rest in row order.
- Kernel K, ``statestore_remove``: tombstones the first live slot of each
  row's window that holds its key, in the same rounds and walk.

A table striped over ``n_shards`` ordinals (the reference's ``NamedSharding``
over its mesh) is one such table a shard: each shard's launch acts on the
rows it owns (``shard``), and a commit across shards first runs J's phase 1
alone on every shard (``statestore_commit_check``) so that each shard's
insert sees the request's verdict over all of them, as the reference's
psum gives it. ``N_SHARDS`` and ``SHARD`` are the one-card table's.

The rounds go on while the last one freed at least ``ROUND_MIN_FREE`` rows,
for at most ``MAX_ROUNDS`` (csrc/statestore.cuh); each launch's scratch (row
states, round counts, two arrays of bucket marks) is allocated by its
wrapper and left clear by the kernel.

J and K update the table in place (the reference donates its arrays to the
step and gets new ones back). The plain versions compute the same: the
probe and phase 1 as vectorised gathers over the windows, phase 2 and the
remove as a loop over the rows in order. Torch's int32 has no unsigned
arithmetic, so the words are reduced through int64 masked to 32 bits. A
wrapper runs its plain version for CPU tensors only; for CUDA tensors it
launches its kernel, or raises.
"""

from __future__ import annotations

import torch

from . import _build

N_SHARDS = 1   # the default: one table on one card
SHARD = 0
TOMBSTONE = 2
M32 = 0xFFFFFFFF
MAX_ROUNDS = 32        # CT_SS_MAX_ROUNDS
COUNTS = MAX_ROUNDS + 2   # rows freed a round, rows to do, rows walked
UNMARKED = 0x7FFFFFFF  # CT_SS_UNMARKED
ROUND_MIN_FREE = 32    # the rounds stop once one frees fewer rows


def _u32(col: torch.Tensor) -> torch.Tensor:
    return col.to(torch.int64) & M32


def windows(q: torch.Tensor, slots: int, max_probe: int) -> torch.Tensor:
    """(n, max_probe) int64 slot indices of each row's probe window."""
    home = _u32(q[:, 2]) % slots
    return (home[:, None] + torch.arange(max_probe, device=q.device)) % slots


def owned(q: torch.Tensor, n_shards: int = N_SHARDS, shard: int = SHARD) -> torch.Tensor:
    """(n,) bool: the rows whose owner shard is ``shard``."""
    return (_u32(q[:, 1]) % n_shards) == shard


def _live_hits(keys, tags, q, win) -> torch.Tensor:
    """(n, W) bool: window slots that are live and hold the row's key."""
    return ((tags[win] & 1) != 0) & (keys[win] == q[:, None, :]).all(dim=-1)


# ---------------------------------------------------- the plain versions


def statestore_probe_plain(keys, tags, q, max_probe: int, n_shards: int = N_SHARDS,
                           shard: int = SHARD) -> torch.Tensor:
    """Plain version of kernel I: (n,) int32 membership bits."""
    win = windows(q, tags.shape[0], max_probe)
    found = _live_hits(keys, tags, q, win).any(dim=-1) & owned(q, n_shards, shard)
    return found.to(torch.int32)


def statestore_commit_check_plain(keys, txs, tags, q, qtx, valid, max_probe: int,
                                  n_shards: int = N_SHARDS, shard: int = SHARD) -> torch.Tensor:
    """Plain version of kernel J's phase 1 alone: (2 r*k,) int32, each row's
    present bit, then its conflict bit (its key live with another tx)."""
    r, k = q.shape[0], q.shape[1]
    rk = r * k
    qf = q.reshape(rk, 8)
    txrep = qtx.repeat_interleave(k, dim=0)
    mine = owned(qf, n_shards, shard) & (valid.reshape(rk) != 0)
    win = windows(qf, tags.shape[0], max_probe)
    hit = _live_hits(keys, tags, qf, win)
    differs = (txs[win] != txrep[:, None, :]).any(dim=-1)
    present = hit.any(dim=-1) & mine
    conf_row = (hit & differs).any(dim=-1) & mine
    return torch.cat([present, conf_row]).to(torch.int32)


def statestore_commit_plain(keys, txs, tags, q, qtx, qtag, valid, pre_conflict, force,
                            max_probe: int, n_shards: int = N_SHARDS,
                            shard: int = SHARD) -> torch.Tensor:
    """Plain version of kernel J, the table updated in place: q (r, k, 8),
    qtx (r, 8), qtag and valid (r, k), pre_conflict and force (r,). Returns
    (r + r*k + 1,) int32: each request's conflict, each row's overflow, and
    the rows inserted."""
    r, k = q.shape[0], q.shape[1]
    rk = r * k
    qf = q.reshape(rk, 8)
    txrep = qtx.repeat_interleave(k, dim=0)
    mine = owned(qf, n_shards, shard) & (valid.reshape(rk) != 0)
    win = windows(qf, tags.shape[0], max_probe)
    hit = _live_hits(keys, tags, qf, win)
    differs = (txs[win] != txrep[:, None, :]).any(dim=-1)
    present = hit.any(dim=-1) & mine
    conf_row = (hit & differs).any(dim=-1) & mine
    conflict = (conf_row.reshape(r, k).sum(dim=1) + pre_conflict) != 0
    conflict = conflict & (force == 0)
    do = mine & ~conflict.repeat_interleave(k) & ~present
    overflow = torch.zeros(rk, dtype=torch.int32, device=q.device)
    tagf = qtag.reshape(rk) | 1
    inserted = 0
    for i in torch.nonzero(do).flatten().tolist():
        w = win[i]
        free = torch.nonzero((tags[w] & 1) == 0)
        if free.numel() == 0:
            overflow[i] = 1
            continue
        pos = w[free[0, 0]]
        keys[pos] = qf[i]
        txs[pos] = txrep[i]
        tags[pos] = tagf[i]
        inserted += 1
    return torch.cat([
        conflict.to(torch.int32), overflow,
        torch.tensor([inserted], dtype=torch.int32, device=q.device),
    ])


def statestore_remove_plain(keys, txs, tags, q, valid, max_probe: int,
                            n_shards: int = N_SHARDS, shard: int = SHARD) -> torch.Tensor:
    """Plain version of kernel K, the table updated in place. Returns (n +
    1,) int32: each row's removed bit, then the rows removed."""
    n = q.shape[0]
    win = windows(q, tags.shape[0], max_probe)
    removed = torch.zeros(n, dtype=torch.int32, device=q.device)
    for i in torch.nonzero(owned(q, n_shards, shard) & (valid != 0)).flatten().tolist():
        w = win[i]
        hit = torch.nonzero(((tags[w] & 1) != 0) & (keys[w] == q[i]).all(dim=-1))
        if hit.numel() == 0:
            continue
        pos = w[hit[0, 0]]
        keys[pos] = 0
        txs[pos] = 0
        tags[pos] = TOMBSTONE
        removed[i] = 1
    return torch.cat([removed, removed.sum().reshape(1).to(torch.int32)])


# -------------------------------------------------------------- wrappers


def _check_rows(t, shape, name, device) -> None:
    if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape) or not t.is_contiguous() \
            or t.device != device:
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} int32 tensor on {device}")


def _check_table(keys, txs, tags) -> int:
    slots = tags.shape[0]
    _check_rows(tags, (slots,), "tags", tags.device)
    _check_rows(keys, (slots, 8), "keys", tags.device)
    if txs is not None:
        _check_rows(txs, (slots, 8), "txs", tags.device)
    return slots


def _check_probe(max_probe: int, slots: int) -> None:
    if not 1 <= max_probe <= slots:
        raise ValueError(f"max_probe must be in [1, {slots}], got {max_probe}")


def buckets(slots: int, max_probe: int) -> int:
    """Buckets of a table (``ct_ss_bucket_count``): rows whose windows
    overlap stand in one bucket or two circular neighbours."""
    return max(1, slots // max_probe)


def _marks(slots: int, max_probe: int, device) -> torch.Tensor:
    return torch.full((2 * buckets(slots, max_probe),), UNMARKED, dtype=torch.int32,
                      device=device)


def _aligned(*ts) -> None:
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("kernels I-K read rows as 16-byte words: the row tensors must be "
                         "16-byte aligned")


def _check_shard(n_shards: int, shard: int) -> None:
    if not 0 <= shard < n_shards:
        raise ValueError(f"shard must be in [0, {n_shards}), got {shard}")


def statestore_probe(keys, tags, q, max_probe: int, n_shards: int = N_SHARDS,
                     shard: int = SHARD) -> torch.Tensor:
    """(n,) int32 membership bits of the (n, 8) int32 rows ``q`` in the
    table (shard ``shard`` of ``n_shards``: rows owned elsewhere read 0).
    Launches kernel I on the current stream for CUDA tensors, runs the
    plain version for CPU tensors."""
    slots = _check_table(keys, None, tags)
    _check_probe(max_probe, slots)
    _check_shard(n_shards, shard)
    _check_rows(q, (q.shape[0], 8), "q", tags.device)
    if tags.device.type == "cpu":
        return statestore_probe_plain(keys, tags, q, max_probe, n_shards, shard)
    _build.require_cuda(tags)
    n = q.shape[0]
    found = torch.empty(n, dtype=torch.int32, device=tags.device)
    if n == 0:
        return found
    _aligned(keys, q)
    lib = _build.kernels()
    with torch.cuda.device(tags.device):
        rc = lib.ct_statestore_probe(
            keys.data_ptr(), tags.data_ptr(), slots, max_probe, n_shards, shard,
            q.data_ptr(), n, found.data_ptr(), _build.stream_of(tags))
    _build.check_launch(rc, "statestore_probe")
    _build.count_launch(statestore_probe)
    return found


statestore_probe.launches = 0


def statestore_commit_check(keys, txs, tags, q, qtx, valid, max_probe: int,
                            n_shards: int = N_SHARDS, shard: int = SHARD) -> torch.Tensor:
    """Kernel J's phase 1 alone over shard ``shard`` of ``n_shards``: q (r,
    k, 8), qtx (r, 8), valid (r, k) int32. Returns (2 r*k,) int32, each
    row's present bit, then its conflict bit; the table is not written. A
    striped commit runs it on every shard before any shard inserts.
    Launches on the current stream for CUDA tensors, runs the plain
    version for CPU tensors."""
    slots = _check_table(keys, txs, tags)
    _check_probe(max_probe, slots)
    _check_shard(n_shards, shard)
    if q.dim() != 3:
        raise ValueError("q must be an (r, k, 8) tensor")
    r, k = q.shape[:2]
    dev = tags.device
    _check_rows(q, (r, k, 8), "q", dev)
    _check_rows(qtx, (r, 8), "qtx", dev)
    _check_rows(valid, (r, k), "valid", dev)
    if dev.type == "cpu":
        return statestore_commit_check_plain(keys, txs, tags, q, qtx, valid, max_probe,
                                             n_shards, shard)
    _build.require_cuda(tags)
    out = torch.empty(2 * r * k, dtype=torch.int32, device=dev)
    if r * k == 0:
        return out
    _aligned(keys, txs, q, qtx)
    lib = _build.kernels()
    with torch.cuda.device(dev):
        rc = lib.ct_statestore_commit_check(
            keys.data_ptr(), txs.data_ptr(), tags.data_ptr(), slots, max_probe, n_shards,
            shard, q.data_ptr(), qtx.data_ptr(), valid.data_ptr(), r, k, out.data_ptr(),
            _build.stream_of(tags))
    _build.check_launch(rc, "statestore_commit_check")
    _build.count_launch(statestore_commit_check)
    return out


statestore_commit_check.launches = 0


def statestore_commit(keys, txs, tags, q, qtx, qtag, valid, pre_conflict, force,
                      max_probe: int, n_shards: int = N_SHARDS,
                      shard: int = SHARD) -> torch.Tensor:
    """The fused conflict check and insert of r requests of k rows over
    shard ``shard`` of ``n_shards``, the table updated in place: q (r, k,
    8), qtx (r, 8), qtag and valid (r, k), pre_conflict and force (r,), all
    int32. Returns (r + r*k + 1,) int32: each request's conflict, each row's
    overflow, the rows inserted. Launches kernel J (both phases) on the
    current stream for CUDA tensors, runs the plain version for CPU
    tensors."""
    slots = _check_table(keys, txs, tags)
    _check_probe(max_probe, slots)
    _check_shard(n_shards, shard)
    if q.dim() != 3:
        raise ValueError("q must be an (r, k, 8) tensor")
    r, k = q.shape[:2]
    dev = tags.device
    _check_rows(q, (r, k, 8), "q", dev)
    _check_rows(qtx, (r, 8), "qtx", dev)
    for name, t in (("qtag", qtag), ("valid", valid)):
        _check_rows(t, (r, k), name, dev)
    for name, t in (("pre_conflict", pre_conflict), ("force", force)):
        _check_rows(t, (r,), name, dev)
    if k < 1:
        raise ValueError("a commit needs at least one row a request")
    if dev.type == "cpu":
        return statestore_commit_plain(keys, txs, tags, q, qtx, qtag, valid, pre_conflict,
                                       force, max_probe, n_shards, shard)
    _build.require_cuda(tags)
    out = _commit_launch(keys, txs, tags, q, qtx, qtag, valid, pre_conflict, force, max_probe,
                         ROUND_MIN_FREE, n_shards, shard)[0]
    if r:
        _build.count_launch(statestore_commit)
    return out


statestore_commit.launches = 0


def _commit_launch(keys, txs, tags, q, qtx, qtag, valid, pre_conflict, force, max_probe: int,
                   min_free: int, n_shards: int = N_SHARDS, shard: int = SHARD):
    """Kernel J's launches on checked CUDA tensors, the rounds going on while
    the last freed at least ``min_free`` rows (more than the rows to do: the
    walk alone). Returns (out, counts, marks): counts (COUNTS,) the rows freed
    in each round, the rows to do, the rows walked."""
    slots = tags.shape[0]
    r, k = q.shape[:2]
    dev = tags.device
    out = torch.empty(r + r * k + 1, dtype=torch.int32, device=dev)
    scratch = torch.zeros(3 * r * k + COUNTS + (r * k + 31) // 32, dtype=torch.int32,
                          device=dev)
    marks = _marks(slots, max_probe, dev)
    if r == 0:
        out.zero_()
        return out, scratch[3 * r * k:3 * r * k + COUNTS], marks
    _aligned(keys, txs, q, qtx)
    lib = _build.kernels()
    with torch.cuda.device(dev):
        rc = lib.ct_statestore_commit(
            keys.data_ptr(), txs.data_ptr(), tags.data_ptr(), slots, max_probe, n_shards,
            shard, q.data_ptr(), qtx.data_ptr(), qtag.data_ptr(), valid.data_ptr(),
            pre_conflict.data_ptr(), force.data_ptr(), r, k, scratch.data_ptr(),
            marks.data_ptr(), min_free, out.data_ptr(), _build.stream_of(tags))
    _build.check_launch(rc, "statestore_commit")
    return out, scratch[3 * r * k:3 * r * k + COUNTS], marks


def statestore_remove(keys, txs, tags, q, valid, max_probe: int, n_shards: int = N_SHARDS,
                      shard: int = SHARD) -> torch.Tensor:
    """Tombstone the (n, 8) int32 rows ``q`` whose ``valid`` is set and that
    shard ``shard`` of ``n_shards`` owns, in order, the table updated in
    place. Returns (n + 1,) int32: each row's removed bit, then the rows
    removed. Launches kernel K on the current stream for CUDA tensors, runs
    the plain version for CPU tensors."""
    slots = _check_table(keys, txs, tags)
    _check_probe(max_probe, slots)
    _check_shard(n_shards, shard)
    n = q.shape[0]
    _check_rows(q, (n, 8), "q", tags.device)
    _check_rows(valid, (n,), "valid", tags.device)
    if tags.device.type == "cpu":
        return statestore_remove_plain(keys, txs, tags, q, valid, max_probe, n_shards, shard)
    _build.require_cuda(tags)
    out = _remove_launch(keys, txs, tags, q, valid, max_probe, ROUND_MIN_FREE, n_shards,
                         shard)[0]
    if n:
        _build.count_launch(statestore_remove)
    return out


statestore_remove.launches = 0


def _remove_launch(keys, txs, tags, q, valid, max_probe: int, min_free: int,
                   n_shards: int = N_SHARDS, shard: int = SHARD):
    """Kernel K's launch on checked CUDA tensors, as ``_commit_launch``.
    Returns (out, counts, marks)."""
    slots = tags.shape[0]
    n = q.shape[0]
    dev = tags.device
    out = torch.empty(n + 1, dtype=torch.int32, device=dev)
    scratch = torch.zeros(n + COUNTS + (n + 31) // 32, dtype=torch.int32, device=dev)
    marks = _marks(slots, max_probe, dev)
    if n == 0:
        out.zero_()
        return out, scratch[n:n + COUNTS], marks
    _aligned(keys, txs, q)
    lib = _build.kernels()
    with torch.cuda.device(dev):
        rc = lib.ct_statestore_remove(
            keys.data_ptr(), txs.data_ptr(), tags.data_ptr(), slots, max_probe, n_shards,
            shard, q.data_ptr(), valid.data_ptr(), n, scratch.data_ptr(), marks.data_ptr(),
            min_free, out.data_ptr(), _build.stream_of(tags))
    _build.check_launch(rc, "statestore_remove")
    return out, scratch[n:n + COUNTS], marks
