"""Mesh scheduling in both packages: the reference's
``tests/test_serving.py::TestMeshScheduling`` scenarios run on the
reference's scheduler over its eight virtual XLA devices and on the port's
over eight logical CPU ordinals (``parallel.mesh.set_logical_devices``),
the same shape-faithful fake dispatch under both (it records the ordinal
each batch was placed on and gates readiness), except the mega-batch,
which runs the real mesh: the reference's XLA step, the port's plain
versions of kernels A and B a shard.

Held exactly: a saturated stripe covering the mesh with a depth spread of
at most 2 and every reservation released; a quarantined ordinal's share
rerouted to its siblings; a fired hedge re-run on a sibling ordinal first
(the sibling's verdicts win, the stall strikes the original ordinal, the
late readback is discarded); a full ed25519 bucket fused into one
mega-batch with verdicts equal to the per-ordinal path and the oracle, the
consumed-set rows gathered equal to the host's digests, and the state
store's screen (kernel I) counting the gathered rows a preloaded table
holds; an empty stripe routed to the host. Counter deltas equal."""

import threading
import time

import numpy as np
import pytest
import torch

import corda_tpu.serving as ref_serving
import corda_tpu.verifier.batch as ref_batch
import corda_tpu_torch.serving as port_serving
import corda_tpu_torch.serving.scheduler as port_sched
import corda_tpu_torch.verifier.batch as port_batch
from corda_tpu_torch.parallel import mesh as port_mesh
from test_torch_resilience import COUNTERS, counters, delta, make_rows

N_ORDINALS = 8
PKGS = ("ref", "port")
SERVING = {"ref": ref_serving, "port": port_serving}


@pytest.fixture(scope="module", autouse=True)
def logical_ordinals():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    port_mesh.set_logical_devices([torch.device("cpu", i) for i in range(N_ORDINALS)])
    yield
    port_mesh.set_logical_devices(None)
    torch.set_num_threads(before)


class FakePending:
    def __init__(self, n, bucket, gate):
        self.device_rows = n
        self.device_mask = np.ones(n, dtype=bool)
        self.padded_lanes = bucket
        self._n = n
        self._gate = gate

    def ready(self):
        return self._gate is None or self._gate.is_set()

    def collect(self):
        if self._gate is not None:
            assert self._gate.wait(timeout=30)
        return np.ones(self._n, dtype=bool)


def install_fake(monkeypatch, pkg, calls, release=None, stall_first=False):
    """The reference's ``_install_fake_dispatch``: records the pinned
    ordinal of every dispatch; ready when ``release`` is set; with
    ``stall_first`` only the first dispatch waits for it."""

    def fake(rows, *, use_device=True, min_bucket=None, device=None, **_kw):
        first = not calls
        if pkg == "ref":
            calls.append(None if device is None else int(device.id))
        else:
            calls.append(None if device is None else int(device.index))
        gate = release
        if stall_first and not first:
            gate = None
        return FakePending(len(rows), min_bucket or len(rows), gate)

    if pkg == "ref":
        monkeypatch.setattr(ref_batch, "dispatch_signature_rows", fake)
    else:
        monkeypatch.setattr(port_sched, "dispatch_signature_rows", fake)


def scheduler(pkg, buckets, **kw):
    S = SERVING[pkg]
    shapes = S.ShapeTable({"buckets": buckets, "source": "test-mesh"})
    if pkg == "ref":
        return S.DeviceScheduler(use_device_default=True, mesh=True, shapes=shapes, **kw)
    return S.DeviceScheduler(device="cpu", mesh=True, shapes=shapes, **kw)


def _saturated(pkg, monkeypatch):
    calls: list = []
    release = threading.Event()
    install_fake(monkeypatch, pkg, calls, release=release)
    s = scheduler(pkg, [4], depth=8, megabatch_fill=9.9)
    try:
        futs = [s.submit_rows(make_rows(pkg, 4), use_device=True) for _ in range(12)]
        deadline = time.monotonic() + 10
        while len(calls) < 8 and time.monotonic() < deadline:
            time.sleep(0.01)
        saturated = len(calls) >= 8
        release.set()
        masks = [f.result(timeout=30).mask.tolist() for f in futs]
        with s._lock:
            dispatches = dict(s._ord_dispatches)
            inflight = dict(s._ord_inflight)
        return (saturated, masks, len(set(calls)) >= 7, s._mesh_spread_max <= 2,
                sum(dispatches.values()), len(dispatches) >= 7,
                all(v == 0 for v in inflight.values()))
    finally:
        release.set()
        s.shutdown()


def test_saturated_stripe_covers_mesh_with_bounded_spread(monkeypatch):
    out = {pkg: _saturated(pkg, monkeypatch) for pkg in PKGS}
    assert out["port"] == out["ref"]
    assert out["port"] == (True, [[True] * 4] * 12, True, True, 12, True, True)


def _quarantined(pkg, monkeypatch):
    R = SERVING[pkg]
    calls: list = []
    install_fake(monkeypatch, pkg, calls)
    pol = R.ResiliencePolicy(strikes=2, probe_runner=lambda o: False,
                             flight_dump_on_quarantine=False)
    pol.on_dispatch_failure(3)
    pol.on_dispatch_failure(3)
    state = pol.quarantine.state(3)
    s = scheduler(pkg, [4], depth=4, megabatch_fill=9.9, resilience=pol)
    try:
        futs = [s.submit_rows(make_rows(pkg, 4), use_device=True) for _ in range(16)]
        results = [f.result(timeout=30) for f in futs]
    finally:
        s.shutdown()
    return (state, len(results), all(r.mask.tolist() == [True] * 4 for r in results),
            3 in calls, 3 in s._ord_dispatches, sorted(set(calls)))


def test_quarantined_ordinal_reroutes_to_siblings(monkeypatch):
    out = {pkg: _quarantined(pkg, monkeypatch) for pkg in PKGS}
    assert out["port"] == out["ref"]
    assert out["port"] == ("quarantined", 16, True, False, False, [0, 1, 2, 4, 5, 6, 7])


def _hedged(pkg, monkeypatch):
    R = SERVING[pkg]
    before = counters(pkg)
    calls: list = []
    release = threading.Event()
    install_fake(monkeypatch, pkg, calls, release=release, stall_first=True)
    pol = R.ResiliencePolicy(strikes=10, breaker_threshold=10, hedge_min_s=0.05,
                             hedge_max_s=0.2, probe_runner=lambda o: False,
                             flight_dump_on_quarantine=False)
    s = scheduler(pkg, [8], depth=2, megabatch_fill=9.9, resilience=pol)
    rows = make_rows(pkg, 8)
    scheme = getattr(rows[0][0], "scheme_id", None)
    try:
        # the shape warm on every ordinal and the EWMA seeded, as the
        # reference's scenario does
        with s._lock:
            s._warm_keys |= {(scheme, 8, o) for o in range(N_ORDINALS)}
            s._latency_ewma = 0.01
        rr = s.submit_rows(rows, use_device=True).result(timeout=30)
        got = (rr.mask.tolist(), len(calls), calls[1] != calls[0], rr.device == calls[1],
               pol.quarantine.state(calls[0]))
        release.set()
        deadline = time.monotonic() + 10
        while delta(pkg, before)["serving.hedge.discarded"] < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        release.set()
        s.shutdown()
    return got, delta(pkg, before)


def test_fired_hedge_reroutes_to_sibling_chip_first(monkeypatch):
    out = {pkg: _hedged(pkg, monkeypatch) for pkg in PKGS}
    assert out["port"] == out["ref"]
    got, d = out["port"]
    assert got == ([True] * 8, 2, True, True, "suspect")
    assert d["serving.hedge.fired"] == 1 and d["serving.hedge.rerouted"] == 1
    assert d["serving.hedge.won_sibling"] == 1 and d["serving.hedge.won_host"] == 0
    assert d["serving.hedge.discarded"] == 1


def _empty_stripe(pkg, monkeypatch):
    R = SERVING[pkg]
    calls: list = []
    install_fake(monkeypatch, pkg, calls)
    before = counters(pkg)
    pol = R.ResiliencePolicy(strikes=100, breaker_threshold=1,
                             probe_runner=lambda o: False, flight_dump_on_quarantine=False)
    for o in range(N_ORDINALS):
        pol.breaker_for(o).record_failure()
    mesh_state = pol.breaker_state_mesh()
    s = scheduler(pkg, [4], resilience=pol)
    try:
        rr = s.submit_rows(make_rows(pkg, 4, tamper={2}), use_device=True).result(timeout=30)
    finally:
        s.shutdown()
    return (mesh_state, rr.mask.tolist(), rr.n_device, calls,
            delta(pkg, before)["serving.mesh.no_eligible"] >= 1)


def test_empty_stripe_routes_host(monkeypatch):
    out = {pkg: _empty_stripe(pkg, monkeypatch) for pkg in PKGS}
    assert out["port"] == out["ref"]
    assert out["port"] == (1, [True, True, False, True], 0, [], True)


def _mega(pkg, monkeypatch, screen_rows):
    """The reference's mega-batch scenario, then the state store's screen
    over the gathered rows against a table preloaded with some of them."""
    import importlib

    S = SERVING[pkg]
    ss = importlib.import_module(f"{'corda_tpu' if pkg == 'ref' else 'corda_tpu_torch'}"
                                 ".statestore")
    from corda_tpu.serving.scheduler import _consumed_rows

    before = counters(pkg)
    s = scheduler(pkg, [64], megabatch_fill=0.0)
    rows = make_rows(pkg, 64, tamper={5})
    msgs = [m for _k, _s, m in rows]
    digests = _consumed_rows(msgs)
    if pkg == "ref":
        monkeypatch.setenv("CORDA_TPU_BATCH_RLC", "0")
        table_kw = {"mesh": None}
    else:
        table_kw = {"device": "cpu"}
    provider = ss.DeviceShardedUniquenessProvider(slots_per_shard=256, max_probe=8,
                                                  **table_kw)
    hits_before = provider._metrics.snapshot().get("statestore.mega_probe_hits",
                                                   {}).get("count", 0)
    try:
        # preload the table with some of the batch's consumed rows
        provider._table.insert_rows(digests[screen_rows], digests[screen_rows])
        rr = s.submit_rows(rows, use_device=True).result(timeout=600)
        if pkg == "ref":
            single = ref_batch.dispatch_signature_rows(rows, use_device=True,
                                                       min_bucket=64).collect()
        else:
            single = port_batch.dispatch_signature_rows(rows, min_bucket=64, device="cpu",
                                                        batch_rlc=False).collect()
        p = s._dispatch_mega(rows, 64)
        mask = p.collect()[:64].tolist()
        spent = np.asarray(p.spent_all)
        hits = provider._metrics.snapshot()["statestore.mega_probe_hits"]["count"] - hits_before
    finally:
        provider.close()
        s.shutdown()
    d = delta(pkg, before)
    return (rr.mask.tolist(), rr.n_device, single[:64].tolist(), mask,
            bool((spent[:64] == digests).all()), spent.shape, hits,
            d["serving.mesh.megabatch"] >= 1, d["serving.mesh.megabatch_rows"] >= 64,
            d["serving.mesh.megabatch_failover"])


def test_megabatch_parity_consumed_set_and_screen(monkeypatch):
    screen_rows = [0, 3, 5, 17, 40, 63]
    out = {pkg: _mega(pkg, monkeypatch, screen_rows) for pkg in PKGS}
    assert out["port"] == out["ref"]
    expected = [i != 5 for i in range(64)]
    got = out["port"]
    assert got[0] == expected and got[1] == 64 and got[2] == expected and got[3] == expected
    assert got[4] and got[5] == (64, 8)
    # two mega-batches screened (the scheduled one and the direct one)
    assert got[6] == 2 * len(screen_rows)
    assert got[7:] == (True, True, 0)


def test_stripe_width_and_process_stream_depth():
    """``mesh_stripe_width`` is the eligible ordinals (0 with the mesh
    off), in both packages."""
    out = {}
    for pkg in PKGS:
        on = scheduler(pkg, [4])
        off = (ref_serving.DeviceScheduler(use_device_default=True, mesh=False)
               if pkg == "ref" else port_serving.DeviceScheduler(device="cpu", mesh=False))
        try:
            out[pkg] = (on.mesh_stripe_width(), off.mesh_stripe_width())
        finally:
            on.shutdown()
            off.shutdown()
    assert out["port"] == out["ref"] == (N_ORDINALS, 0)
    assert set(COUNTERS) >= {"serving.mesh.striped"}
