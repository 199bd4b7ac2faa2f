"""The device state store striped over the mesh, and its mega-batch screen,
in both packages.

- The port's ``DeviceShardedTable`` over eight logical CPU ordinals
  (``mesh=make_mesh(8)``: one shard an ordinal, kernels I, J and K a shard,
  J's check on every shard before any inserts) against the reference's
  table on its default eight-device mesh, through the seeded op sequence
  of ``test_torch_statestore_kernels.py`` (conflicts, retries, several
  refs a request, rows not valid, host conflicts, force, inserts, removes,
  crowded windows): every returned mask equal, and the slot layout, the
  shards laid end to end, bit for bit (``keys``, ``txs``, ``tags``);
- the reference's ``test_statestore.py::TestMegaScreenFusion``:
  ``test_screen_counts_device_resident_hits`` (a provider's screen over
  rows already on the device, the padding tail excluded, unregistered at
  close) and ``test_collect_harvests_screen_counters`` (``_MeshPending``
  harvesting the screen's scalar into ``statestore.mega_probe_*``), on a
  one-card table and on the striped one;
- ``load_shape_table``'s ``CORDA_TPU_SERVING_SHAPES`` override, a corrupt
  file falling through, and the checked-in ladder marked not yet measured
  on the H100."""

import json

import numpy as np
import pytest
import torch

from corda_tpu.parallel.mesh import make_mesh as ref_make_mesh
from corda_tpu.statestore import active_mega_screen as ref_active_screen
from corda_tpu.statestore.provider import DeviceShardedUniquenessProvider as RefProvider
from corda_tpu.statestore.table import DeviceShardedTable as RefTable
from corda_tpu.statestore.table import key_rows as ref_key_rows
from corda_tpu_torch.node.monitoring import node_metrics as port_metrics
from corda_tpu_torch.parallel import mesh as port_mesh
from corda_tpu_torch.serving import shapes as port_shapes
from corda_tpu_torch.serving.scheduler import _MeshPending
from corda_tpu_torch.statestore import active_mega_screen as port_active_screen
from corda_tpu_torch.statestore.provider import DeviceShardedUniquenessProvider
from corda_tpu_torch.statestore.table import DeviceShardedTable
from corda_tpu_torch.statestore.table import key_rows
from test_torch_statestore_kernels import op_sequence, ref_arrays, run_table

N_ORDINALS = 8


@pytest.fixture(scope="module", autouse=True)
def logical_ordinals():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    port_mesh.set_logical_devices([torch.device("cpu", i) for i in range(N_ORDINALS)])
    yield
    port_mesh.set_logical_devices(None)
    torch.set_num_threads(before)


@pytest.mark.parametrize("slots,probe,homes", [
    pytest.param(64, 8, None, id="roomy-8x64x8"),
    pytest.param(16, 4, 12, id="crowded-8x16x4"),
])
def test_striped_table_bit_identical_to_the_reference(slots, probe, homes):
    seq = op_sequence(40 + slots, homes)
    ref = RefTable(mesh=ref_make_mesh(N_ORDINALS), slots_per_shard=slots, max_probe=probe,
                   name="ref-8dev")
    port = DeviceShardedTable(mesh=port_mesh.make_mesh(N_ORDINALS), slots_per_shard=slots,
                              max_probe=probe, name="port-8dev")
    assert port.n_shards == ref.n_shards == N_ORDINALS
    assert port.total_slots == ref.total_slots
    want, got = run_table(ref, seq), run_table(port, seq)
    assert got == want
    for w, g in zip(ref_arrays(ref), port.table_arrays()):
        assert (w == g).all()
    assert port.n_live == ref.n_live
    assert port.stats()["shards"] == N_ORDINALS
    keys, txs = port.live_rows()
    rk, rt = ref.live_rows()
    assert (keys == rk).all() and (txs == rt).all()
    port.close()


def _refs(i0, n):
    """(states, tx, caller) requests of one fresh ref each, and the rows the
    screen probes for them (the provider's key of a state ref)."""
    from corda_tpu.crypto import SecureHash as RefHash
    from corda_tpu.ledger import StateRef as RefStateRef
    from corda_tpu_torch.crypto import SecureHash
    from corda_tpu_torch.ledger import StateRef

    out = {"ref": [], "port": []}
    keys = []
    for i in range(i0, i0 + n):
        txh = bytes([i % 251]) * 31 + bytes([(i // 251) % 256])
        tx = bytes([7]) * 31 + bytes([i % 256])
        out["ref"].append(([RefStateRef(RefHash(txh), 0)], RefHash(tx), "p"))
        out["port"].append(([StateRef(SecureHash(txh), 0)], SecureHash(tx), "p"))
        keys.append(txh + (0).to_bytes(4, "big"))
    return out, keys


@pytest.mark.parametrize("striped", [False, True], ids=["one-card", "striped"])
def test_screen_counts_device_resident_hits(striped):
    reqs, present_keys = _refs(81000, 6)
    absent_keys = [b"ss-not-there-%d" % i for i in range(2)]
    ref = RefProvider(slots_per_shard=64, max_probe=8)
    kw = {"mesh": port_mesh.make_mesh(N_ORDINALS)} if striped else {"device": "cpu"}
    port = DeviceShardedUniquenessProvider(slots_per_shard=64, max_probe=8, **kw)
    out = {}
    try:
        for pkg, prov, active, kr in (("ref", ref, ref_active_screen, ref_key_rows),
                                      ("port", port, port_active_screen, key_rows)):
            assert active() is not None
            prov.commit_batch(reqs[pkg])
            rows = np.concatenate([kr(present_keys), kr(absent_keys)])
            if pkg == "ref":
                import jax.numpy as jnp

                dev_rows = jnp.asarray(rows)
            else:
                dev_rows = torch.from_numpy(rows)
            out[pkg] = (int(active()(dev_rows, rows.shape[0])), int(active()(dev_rows, 3)))
    finally:
        ref.close()
        port.close()
    assert out["port"] == out["ref"] == (6, 3)
    assert ref_active_screen() is None and port_active_screen() is None


def test_collect_harvests_screen_counters():
    from corda_tpu.node.monitoring import node_metrics as ref_metrics
    from corda_tpu.serving.scheduler import _MeshPending as RefMeshPending

    names = ("statestore.mega_probe_rows", "statestore.mega_probe_hits")
    out = {}
    for pkg, cls, metrics in (("ref", RefMeshPending, ref_metrics),
                              ("port", _MeshPending, port_metrics)):
        snap = metrics().snapshot()
        before = {n: snap.get(n, {}).get("count", 0) for n in names}
        if pkg == "ref":
            import jax.numpy as jnp

            pending = cls([(None, None, b"m")] * 3, np.array([True, True, False]), None, 2,
                          bucket=4)
            pending.statestore_hits = jnp.int32(2)
        else:
            pending = cls([(None, None, b"m")] * 3, torch.tensor([True, True, False, False]),
                          None, 2, bucket=4)
            pending.statestore_hits = torch.tensor(2, dtype=torch.int32)
        mask = pending.collect().tolist()
        snap = metrics().snapshot()
        out[pkg] = (mask, {n: snap.get(n, {}).get("count", 0) - before[n] for n in names})
    assert out["port"] == out["ref"]
    assert out["port"] == ([True, True, False], {names[0]: 3, names[1]: 2})


def test_load_shape_table_override(tmp_path, monkeypatch):
    from corda_tpu.serving.shapes import load_shape_table as ref_load

    good = tmp_path / "shapes.json"
    good.write_text(json.dumps({"buckets": [512, 16, 64]}))
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    out = {}
    for name, env in (("override", str(good)), ("corrupt", str(bad)), ("none", "")):
        monkeypatch.setenv("CORDA_TPU_SERVING_SHAPES", env)
        r, p = ref_load(), port_shapes.load_shape_table()
        out[name] = (p.buckets, p.bucket_for(17), p.bucket_for(3, floor=100), p.max_bucket)
        assert out[name] == (r.buckets, r.bucket_for(17), r.bucket_for(3, floor=100),
                             r.max_bucket), name
    assert out["override"] == ([16, 64, 512], 64, 512, 512)
    assert out["corrupt"] == out["none"]
    monkeypatch.delenv("CORDA_TPU_SERVING_SHAPES")
    table = port_shapes.load_shape_table()
    assert "not yet measured on the H100" in table.source
    assert port_shapes.ShapeTable({}).buckets == port_shapes.DEFAULT_SHAPES["buckets"]
