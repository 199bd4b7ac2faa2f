"""Kernels I, J and K of the device state store (``ops/statestore.py``) and the
port's ``DeviceShardedTable`` against the reference's table.

The reference's table is built on a one-device mesh (``make_mesh(1)``
through its ``mesh=`` argument), the port's on ``device="cpu"`` (the
kernels' plain versions) with the same ``slots_per_shard`` and
``max_probe``. One seeded sequence of commits (conflicts, identical
retries, requests of several refs, rows not valid, host conflicts, force),
inserts, removes (tombstones, absent keys, a key twice) and probes, over
rows whose words are drawn over the whole int32 range (so the unsigned
reduction matters) and crowded onto few home slots (so windows overflow),
leaves ``keys``, ``txs`` and ``tags`` bit-identical and every returned mask
equal. The same sequence through ``host_check``'s build of the kernels' row
steps (csrc/statestore.cuh) leaves the same table. Against the reference's
default 8-shard mesh, on a table roomy enough that nothing overflows, the
verdicts and the live rows (as sets) are equal."""

import ctypes

import numpy as np
import pytest
import torch

from corda_tpu.parallel.mesh import make_mesh
from corda_tpu.statestore.table import DeviceShardedTable as RefTable
from corda_tpu_torch.ops import _build
from corda_tpu_torch.ops import statestore as ops
from corda_tpu_torch.statestore.table import DeviceShardedTable


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run many small integer ops: beside the suite's
    other worker processes a torch thread pool only contends."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def rows(rng, n, homes=None):
    """(n, 8) int32 rows over the whole int32 range; with ``homes``, word 2
    takes one of that many values (crowded windows)."""
    out = rng.integers(-2**31, 2**31, size=(n, 8), dtype=np.int64).astype(np.int32)
    if homes is not None:
        out[:, 2] = rng.integers(-2**31, 2**31, size=homes, dtype=np.int64).astype(
            np.int32)[rng.integers(0, homes, size=n)]
    return out


def op_sequence(seed, homes):
    """A seeded list of table ops. Keys within one commit are unique (the
    provider's contract); a remove may name a key twice or an absent one."""
    rng = np.random.default_rng(seed)
    pool = rows(rng, 400, homes)
    txpool = rows(rng, 64)
    used = []
    ops_ = []
    nxt = 0
    for step in range(10):
        r, k = (5, 3) if step % 2 else (7, 1)
        take = []
        for _ in range(r * k):
            if used and rng.random() < 0.3:
                take.append(used[rng.integers(len(used))])      # retry or conflict
            else:
                take.append(nxt)
                nxt += 1
        take = list(dict.fromkeys(take))                        # unique in the batch
        while len(take) < r * k:
            take.append(nxt)
            nxt += 1
        q = pool[take].reshape(r, k, 8)
        qtx = txpool[rng.integers(0, 4, size=r)]                # few txs: retries match
        valid = (rng.random((r, k)) < 0.85).astype(np.int32)
        pre = (rng.random(r) < 0.1).astype(np.int32)
        force = (rng.random(r) < 0.15).astype(np.int32)
        qtag = None if step % 3 == 0 else rng.integers(0, 2**20, size=(r, k)).astype(np.int32)
        ops_.append(("commit", q, qtx, valid, pre, force, qtag))
        used.extend(take)
        if step % 3 == 1:
            n = 9
            sel = [used[i] for i in rng.integers(0, len(used), size=n)]
            sel[3] = sel[1]                                     # a key twice
            rm = pool[sel]
            rm[5] = rows(rng, 1)[0]                             # an absent key
            ops_.append(("remove", rm))
        if step % 4 == 2:
            ins = list(range(nxt, nxt + 6))
            nxt += 6
            ops_.append(("insert", pool[ins], txpool[rng.integers(0, 64, size=6)],
                         rng.integers(0, 2**20, size=6).astype(np.int32)))
        ops_.append(("probe", pool[rng.integers(0, nxt + 5, size=13)]))
    return ops_


def run_table(table, seq):
    """Every op's returned masks."""
    out = []
    for op in seq:
        if op[0] == "commit":
            _, q, qtx, valid, pre, force, qtag = op
            c, o = table.commit_rows(q, qtx, valid, pre, force, qtag=qtag)
            out.append(("commit", c.tolist(), o.tolist()))
        elif op[0] == "remove":
            out.append(("remove", table.remove_rows(op[1]).tolist()))
        elif op[0] == "insert":
            out.append(("insert", table.insert_rows(op[1], op[2], op[3]).tolist()))
        else:
            out.append(("probe", table.probe_rows(op[1]).tolist()))
    return out


def ref_arrays(t):
    return np.asarray(t._keys), np.asarray(t._txs), np.asarray(t._tags)


def port_arrays(t):
    return t._keys.numpy(), t._txs.numpy(), t._tags.numpy()


GEOMETRIES = [
    pytest.param(256, 16, None, id="roomy-256x16"),
    pytest.param(64, 4, 12, id="crowded-64x4"),
    pytest.param(96, 40, 3, id="crowded-96x40"),   # a window past one warp's 32 lanes
]


@pytest.mark.parametrize("slots,probe,homes", GEOMETRIES)
def test_table_bit_identical_to_one_device_reference(slots, probe, homes):
    seq = op_sequence(17 + slots, homes)
    ref = RefTable(mesh=make_mesh(1), slots_per_shard=slots, max_probe=probe, name="ref-1dev")
    port = DeviceShardedTable(device="cpu", slots_per_shard=slots, max_probe=probe,
                              name="port-1dev")
    want, got = run_table(ref, seq), run_table(port, seq)
    assert got == want
    for w, g in zip(ref_arrays(ref), port_arrays(port)):
        assert np.array_equal(w, g)
    assert port.n_live == ref.n_live
    assert port.stats() == {**ref.stats(), "name": "port-1dev"}
    if homes is not None:
        # the crowded sequence reaches every branch it claims
        assert any(o for op in want if op[0] == "commit" for row in op[2] for o in row)
        assert 2 in port_arrays(port)[2]
    assert any(any(op[1]) for op in want if op[0] == "remove")
    for tag in (1, 7):
        assert port.count_tag(tag) == ref.count_tag(tag)
    wk, wt = ref.live_rows()
    gk, gt = port.live_rows()
    assert np.array_equal(wk, gk) and np.array_equal(wt, gt)


def test_verdicts_and_live_rows_equal_eight_shard_reference():
    seq = op_sequence(5, None)
    ref = RefTable(slots_per_shard=256, max_probe=16, name="ref-8dev")
    assert ref.n_shards == 8
    port = DeviceShardedTable(device="cpu", slots_per_shard=2048, max_probe=16,
                              name="port-8dev")
    want, got = run_table(ref, seq), run_table(port, seq)
    assert not any(o for op in want if op[0] == "commit" for row in op[2] for o in row)
    assert got == want
    assert port.n_live == ref.n_live

    def as_set(k, t):
        return {(a.tobytes(), b.tobytes()) for a, b in zip(k, t)}

    assert as_set(*port.live_rows()) == as_set(*ref.live_rows())


def hc_run(slots, probe, seq):
    """The op sequence through host_check's build of the row steps."""
    lib = _build.host_check()
    keys = np.zeros((slots, 8), np.int32)
    txs = np.zeros((slots, 8), np.int32)
    tags = np.zeros(slots, np.int32)
    P = ctypes.c_void_p

    def ptr(a):
        return a.ctypes.data_as(P)

    out = []
    for op in seq:
        if op[0] in ("commit", "insert"):
            if op[0] == "commit":
                _, q, qtx, valid, pre, force, qtag = op
            else:
                n = op[1].shape[0]
                q, qtx = op[1].reshape(n, 1, 8), op[2]
                valid, pre, force, qtag = (np.ones((n, 1), np.int32), np.zeros(n, np.int32),
                                           np.ones(n, np.int32), op[3].reshape(n, 1))
            r, k = q.shape[:2]
            if qtag is None:
                qtag = q[:, :, 0]
            args = [np.ascontiguousarray(a, dtype=np.int32)
                    for a in (q, qtx, qtag, valid, pre, force)]
            res = np.zeros(r + r * k + 1, np.int32)
            lib.hc_ss_commit(ptr(keys), ptr(txs), ptr(tags), slots, probe, ops.N_SHARDS,
                             ops.SHARD, *map(ptr, args), r, k, ptr(res))
            if op[0] == "commit":
                out.append(("commit", (res[:r] > 0).tolist(),
                            (res[r:r + r * k].reshape(r, k) > 0).tolist()))
            else:
                out.append(("insert", (res[r:r + r * k] > 0).tolist()))
        elif op[0] == "remove":
            q = np.ascontiguousarray(op[1])
            n = q.shape[0]
            res = np.zeros(n + 1, np.int32)
            valid = np.ones(n, np.int32)
            lib.hc_ss_remove(ptr(keys), ptr(txs), ptr(tags), slots, probe, ops.N_SHARDS,
                             ops.SHARD, ptr(q), ptr(valid), n, ptr(res))
            out.append(("remove", (res[:n] > 0).tolist()))
        else:
            q = np.ascontiguousarray(op[1])
            n = q.shape[0]
            res = np.zeros(n, np.int32)
            lib.hc_ss_probe(ptr(keys), ptr(tags), slots, probe, ops.N_SHARDS, ops.SHARD,
                            ptr(q), n, ptr(res))
            out.append(("probe", (res > 0).tolist()))
    return out, (keys, txs, tags)


@pytest.mark.parametrize("slots,probe,homes", GEOMETRIES)
def test_host_check_row_steps_choose_the_plain_versions_slots(slots, probe, homes):
    seq = op_sequence(17 + slots, homes)
    port = DeviceShardedTable(device="cpu", slots_per_shard=slots, max_probe=probe,
                              name="port-hc")
    want = run_table(port, seq)
    got, arrays = hc_run(slots, probe, seq)
    assert got == want
    for w, g in zip(port_arrays(port), arrays):
        assert np.array_equal(w, g)


def test_wrappers_return_the_kernels_layout():
    """The wrappers on CPU tensors: (r + r*k + 1,) for a commit, (n + 1,)
    for a remove, (n,) for a probe; a wrong shape or type raises."""
    slots, probe = 32, 8
    keys = torch.zeros((slots, 8), dtype=torch.int32)
    txs = torch.zeros((slots, 8), dtype=torch.int32)
    tags = torch.zeros(slots, dtype=torch.int32)
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rows(rng, 6)).reshape(3, 2, 8)
    qtx = torch.from_numpy(rows(rng, 3))
    ones = torch.ones((3, 2), dtype=torch.int32)
    zeros = torch.zeros(3, dtype=torch.int32)
    out = ops.statestore_commit(keys, txs, tags, q, qtx, q[:, :, 0].contiguous(), ones,
                                zeros, zeros, probe)
    assert out.tolist() == [0, 0, 0] + [0] * 6 + [6]
    assert ops.statestore_probe(keys, tags, q.reshape(6, 8), probe).tolist() == [1] * 6
    rm = ops.statestore_remove(keys, txs, tags, q.reshape(6, 8)[:2].contiguous(),
                               torch.ones(2, dtype=torch.int32), probe)
    assert rm.tolist() == [1, 1, 2]
    assert int((tags == ops.TOMBSTONE).sum()) == 2
    with pytest.raises(ValueError):
        ops.statestore_probe(keys, tags, q.to(torch.int64).reshape(6, 8), probe)
    with pytest.raises(ValueError):
        ops.statestore_probe(keys, tags, q.reshape(6, 8), slots + 1)
    # every wrapper starts at zero launches: the plain versions count none
    assert ops.statestore_probe.launches == ops.statestore_commit.launches == \
        ops.statestore_remove.launches == 0
