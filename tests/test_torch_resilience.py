"""The serving resilience layer of both packages under the same scenarios:
the reference's ``tests/test_serving.py::TestResilience`` run on the
reference's ``ResiliencePolicy``/``DeviceScheduler`` and on the port's
(``corda_tpu_torch/serving/resilience.py``, the scheduler on
``device="cpu"``), the same fake dispatch under both and the same injected
clock where the scenario has one.

The fake dispatch is shape-faithful: it reports every row settled on the
device (its ``device_rows``), pads to ``min_bucket``, and computes its
verdicts with the package's host oracle, so the canary probe's known
answers come out right; the device half of each package is the only thing
it stands in for.

Held exactly (every verdict and every counter delta): the quarantine state
machine (HEALTHY -> SUSPECT -> QUARANTINED -> PROBATION -> HEALTHY, the
probe backoff doubling), an injected stall hedged to the host, an injected
crash re-dispatched while its strike quarantines the ordinal and a canary
readmits it, the breaker tripping open and a half-open canary closing it,
a watchdog eviction writing exactly one flight dump with the resilience
section, and the layer off by default. Then what only the port has: a
real error from a launch or a build raises through
``dispatch_signature_rows`` and the scheduler, with no failover counted,
where an injected fault or a ``ServingError`` fails over."""

import threading
import time

import numpy as np
import pytest

import corda_tpu.faultinject as ref_fi
import corda_tpu.serving as ref_serving
import corda_tpu.serving.resilience as ref_res
import corda_tpu.verifier.batch as ref_batch
import corda_tpu_torch.faultinject as port_fi
import corda_tpu_torch.serving as port_serving
import corda_tpu_torch.serving.resilience as port_res
import corda_tpu_torch.serving.scheduler as port_sched
import corda_tpu_torch.verifier.batch as port_batch
from corda_tpu.crypto import generate_keypair as ref_generate
from corda_tpu.crypto import is_valid as ref_is_valid
from corda_tpu.crypto import sign as ref_sign
from corda_tpu.node.monitoring import monitoring_snapshot as ref_snapshot
from corda_tpu.node.monitoring import node_metrics as ref_metrics
from corda_tpu_torch.crypto import generate_keypair as port_generate
from corda_tpu_torch.crypto import is_valid as port_is_valid
from corda_tpu_torch.crypto import sign as port_sign
from corda_tpu_torch.node.monitoring import monitoring_snapshot as port_snapshot
from corda_tpu_torch.node.monitoring import node_metrics as port_metrics

COUNTERS = (
    "serving.hedge.fired", "serving.hedge.won_host", "serving.hedge.won_device",
    "serving.hedge.discarded", "serving.quarantine.strikes", "serving.quarantine.entered",
    "serving.quarantine.readmitted", "serving.quarantine.probes",
    "serving.quarantine.probe_failures", "serving.quarantine.host_routed",
    "serving.breaker.opened", "serving.breaker.closed", "serving.breaker.host_routed",
    "serving.redispatch", "serving.device_failover", "serving.hedge.rerouted",
    "serving.hedge.won_sibling", "serving.mesh.striped", "serving.mesh.no_eligible",
    "serving.mesh.megabatch", "serving.mesh.megabatch_rows",
    "serving.mesh.megabatch_failover", "verifier.device_failover",
)

PKG = {
    "ref": dict(serving=ref_serving, res=ref_res, fi=ref_fi, metrics=ref_metrics,
                snapshot=ref_snapshot, generate=ref_generate, sign=ref_sign,
                is_valid=ref_is_valid),
    "port": dict(serving=port_serving, res=port_res, fi=port_fi, metrics=port_metrics,
                 snapshot=port_snapshot, generate=port_generate, sign=port_sign,
                 is_valid=port_is_valid),
}


def counters(pkg) -> dict:
    """Read through the snapshot: a counter lookup would create the name."""
    snap = PKG[pkg]["metrics"]().snapshot()
    return {n: snap.get(n, {}).get("count", 0) for n in COUNTERS}


def delta(pkg, before) -> dict:
    after = counters(pkg)
    return {k: after[k] - before[k] for k in before}


def make_rows(pkg, n, tamper=()):
    P = PKG[pkg]
    kp = P["generate"]()
    rows = []
    for i in range(n):
        msg = b"serving-row-%d" % i
        s = P["sign"](kp.private, msg)
        if i in tamper:
            s = b"\0" * len(s)
        rows.append((kp.public, s, msg))
    return rows


class FakePending:
    """What a device dispatch hands back: every row a device row, the
    bucket's lanes, the host oracle's verdicts."""

    def __init__(self, mask, bucket, on_device):
        self._mask = mask
        n = len(mask)
        self.device_rows = n if on_device else 0
        self.device_mask = np.full(n, on_device, dtype=bool)
        self.padded_lanes = bucket if on_device else 0
        self.stall_until = None

    def inject_stall(self, delay_s):
        if delay_s > 0:
            self.stall_until = max(self.stall_until or 0.0, time.monotonic() + delay_s)

    def ready(self):
        return self.stall_until is None or time.monotonic() >= self.stall_until

    def collect(self):
        if self.stall_until is not None:
            wait = self.stall_until - time.monotonic()
            if wait > 0:
                time.sleep(wait)
        return self._mask.copy()


@pytest.fixture
def fake_dispatch(monkeypatch):
    """The same fake device dispatch in both packages (the scheduler's and
    the canary's lookups)."""
    calls = {"ref": 0, "port": 0}

    def make(pkg):
        is_valid = PKG[pkg]["is_valid"]

        def fake(rows, *, use_device=True, min_bucket=None, device=None, **_kw):
            if use_device:
                calls[pkg] += 1
            mask = np.array([is_valid(k, s, m) for k, s, m in rows], dtype=bool)
            return FakePending(mask, max(min_bucket or 0, len(rows)), use_device)

        return fake

    monkeypatch.setattr(ref_batch, "dispatch_signature_rows", make("ref"))
    monkeypatch.setattr(port_batch, "dispatch_signature_rows", make("port"))
    monkeypatch.setattr(port_sched, "dispatch_signature_rows", make("port"))
    return calls


def scheduler(pkg, **kw):
    S = PKG[pkg]["serving"]
    if pkg == "ref":
        return S.DeviceScheduler(use_device_default=True, **kw)
    return S.DeviceScheduler(device="cpu", **kw)


def test_quarantine_state_machine_fake_clock():
    out = {}
    for pkg in PKG:
        R = PKG[pkg]["res"]
        before = counters(pkg)
        now = [100.0]
        seen: list = []
        verdicts = [False, True]
        states: list = []

        def probe_runner(ordinal):
            seen.append((ordinal, pol.quarantine.state(ordinal)))
            return verdicts.pop(0)

        pol = R.ResiliencePolicy(
            strikes=2, probe_backoff_s=1.0, probe_backoff_max_s=8.0,
            probe_runner=probe_runner, clock=lambda: now[0],
            flight_dump_on_quarantine=False,
        )
        q = pol.quarantine
        states.append(q.state(3))
        pol.on_hedge_fired(3)
        states.append(q.state(3))
        pol.on_settle_ok(3)
        states.append(q.state(3))
        pol.on_dispatch_failure(3)
        states.append((q.state(3), pol.admit_device(3)))
        pol.on_dispatch_failure(3)
        states.append((q.state(3), pol.admit_device(3)))
        pol.maybe_probe(sync=True)
        states.append((list(seen), q.state(3)))
        now[0] += 1.1
        pol.maybe_probe(sync=True)
        states.append((list(seen), q.state(3)))
        now[0] += 1.1
        pol.maybe_probe(sync=True)
        states.append(len(seen))
        now[0] += 1.0
        pol.maybe_probe(sync=True)
        states.append((seen[-1], q.state(3), pol.admit_device(3), q.snapshot()))
        out[pkg] = (states, delta(pkg, before))
    assert out["port"] == out["ref"]
    states, d = out["port"]
    assert states[0] == "healthy" and states[4] == ("quarantined", False)
    assert states[-1][:3] == ((3, "probation"), "healthy", True)
    assert d["serving.quarantine.strikes"] == 3 and d["serving.quarantine.entered"] == 1
    assert d["serving.quarantine.probes"] == 2 and d["serving.quarantine.probe_failures"] == 1
    assert d["serving.quarantine.readmitted"] == 1


def _stall_and_crash(pkg):
    P = PKG[pkg]
    S, R, FI = P["serving"], P["res"], P["fi"]
    before = counters(pkg)
    pol = R.ResiliencePolicy(strikes=2, hedge_min_s=0.15, hedge_max_s=0.5,
                             probe_backoff_s=0.1, breaker_threshold=10,
                             flight_dump_on_quarantine=False)
    s = scheduler(pkg, shapes=S.ShapeTable({"buckets": [8, 16, 32], "source": "test"}),
                  resilience=pol)
    rows = make_rows(pkg, 5, tamper={3})
    expected = [i != 3 for i in range(5)]
    got = []
    FI.install(FI.FaultInjector(FI.FaultPlan(
        seed=7, stall_sites=(("serving.dispatch", 2, 2.0),),
        fail_sites=(("serving.dispatch", 3),))))
    try:
        rr = s.submit_rows(rows, use_device=True).result(timeout=60)
        got.append((rr.mask.tolist(), rr.n_device))
        ordinal = rr.device
        t0 = time.monotonic()
        rr2 = s.submit_rows(rows, use_device=True).result(timeout=60)
        got.append((rr2.mask.tolist(), rr2.n_device, time.monotonic() - t0 < 1.8,
                    pol.quarantine.state(ordinal) != "healthy"))
        rr3 = s.submit_rows(rows, use_device=True).result(timeout=60)
        got.append((rr3.mask.tolist(), rr3.n_device))
        FI.clear()
        deadline = time.monotonic() + 60
        while pol.quarantine.state(ordinal) != "healthy" and time.monotonic() < deadline:
            time.sleep(0.05)
        got.append(pol.quarantine.state(ordinal))
        rr4 = s.submit_rows(rows, use_device=True).result(timeout=60)
        got.append((rr4.mask.tolist(), rr4.n_device, rr4.device))
    finally:
        FI.clear()
        s.shutdown()
    d = delta(pkg, before)
    d["serving.quarantine.probes"] = min(d["serving.quarantine.probes"], 1)
    d["serving.quarantine.host_routed"] = min(d["serving.quarantine.host_routed"], 1)
    return got, d, expected


def test_stall_and_crash_full_cycle(fake_dispatch):
    out = {pkg: _stall_and_crash(pkg) for pkg in PKG}
    assert out["port"][:2] == out["ref"][:2]
    got, d, expected = out["port"]
    assert got[0] == (expected, 5)
    assert got[1] == (expected, 0, True, True)   # the host leg won, in time
    assert got[2] == (expected, 0)               # re-dispatched, then host-routed
    assert got[3] == "healthy"
    assert got[4] == (expected, 5, 0)
    assert d["serving.hedge.fired"] == 1 and d["serving.hedge.won_host"] == 1
    assert d["serving.hedge.won_device"] == 0 and d["serving.hedge.discarded"] == 1
    assert d["serving.quarantine.entered"] == 1 and d["serving.quarantine.readmitted"] == 1
    assert d["serving.redispatch"] == 1 and d["serving.device_failover"] == 0


def _breaker(pkg):
    P = PKG[pkg]
    S, R, FI = P["serving"], P["res"], P["fi"]
    before = counters(pkg)
    pol = R.ResiliencePolicy(strikes=50, breaker_threshold=2, breaker_backoff_s=0.3,
                             redispatch_limit=1, probe_runner=lambda o: True,
                             flight_dump_on_quarantine=False)
    s = scheduler(pkg, shapes=S.ShapeTable({"buckets": [8, 16], "source": "test"}),
                  resilience=pol)
    rows = make_rows(pkg, 3)
    got = []
    inj = FI.install(FI.FaultInjector(FI.FaultPlan(seed=3, op_fail_p=1.0)))
    try:
        rr = s.submit_rows(rows, use_device=True).result(timeout=60)
        sites = sum(1 for e in inj.trace if e.site == "serving.dispatch")
        got.append((rr.mask.tolist(), rr.n_device, pol.breaker.state, sites))
        rr2 = s.submit_rows(rows, use_device=True).result(timeout=60)
        got.append((rr2.mask.tolist(), rr2.n_device,
                    sum(1 for e in inj.trace if e.site == "serving.dispatch")))
        FI.clear()
        deadline = time.monotonic() + 30
        while pol.breaker.state != 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        got.append(pol.breaker.state)
        rr3 = s.submit_rows(rows, use_device=True).result(timeout=60)
        got.append((rr3.mask.tolist(), rr3.n_device))
    finally:
        FI.clear()
        s.shutdown()
    d = delta(pkg, before)
    d["serving.breaker.host_routed"] = min(d["serving.breaker.host_routed"], 1)
    return got, d


def test_breaker_trips_open_routes_host_and_recloses(fake_dispatch):
    out = {pkg: _breaker(pkg) for pkg in PKG}
    assert out["port"] == out["ref"]
    got, d = out["port"]
    assert got[0] == ([True] * 3, 0, 1, 2)
    assert got[1] == ([True] * 3, 0, 2)          # open: no device enqueue
    assert got[2] == 0 and got[3] == ([True] * 3, 3)
    assert d["serving.breaker.opened"] == 1 and d["serving.breaker.closed"] == 1
    assert d["serving.redispatch"] == 1 and d["serving.device_failover"] == 1


def test_watchdog_eviction_dumps_flight_record_once(tmp_path, monkeypatch):
    import importlib

    # by importlib: ``observability.devicemon`` as an attribute is a function
    ref_dm, ref_slo, port_dm, port_slo = (
        importlib.import_module(f"{root}.observability.{m}")
        for root in ("corda_tpu", "corda_tpu_torch") for m in ("devicemon", "slo"))

    out = {}
    for pkg, dm, slo in (("ref", ref_dm, ref_slo), ("port", port_dm, port_slo)):
        R = PKG[pkg]["res"]
        d = tmp_path / pkg
        d.mkdir()
        monkeypatch.setenv("CORDA_TPU_FLIGHT_DIR", str(d))
        now = [50.0]
        mon = dm.DeviceMonitor(n_devices=1, enabled=True, clock=lambda: now[0])
        pol = R.ResiliencePolicy(strikes=1, probe_backoff_s=60.0,
                                 probe_runner=lambda o: True, clock=lambda: now[0])
        mon.subscribe(pol.on_device_event)
        R.register_policy(pol)
        try:
            wd = dm.DeviceWatchdog(mon, stall_s=2.0)
            mon.record_dispatch(0, rows=4)
            now[0] += 5.0
            events = [e["kind"] for e in wd.check_once()]
            dumps = sorted(d.glob("corda_tpu_flight_*.jsonl"))
            parsed = slo.read_flight_dump(str(dumps[0]))
            res = parsed["resilience"]
            pol.on_dispatch_failure(0)
            wd.check_once()
            out[pkg] = (events, pol.quarantine.state(0), len(dumps),
                        parsed["header"]["reason"], res["enabled"],
                        res["quarantine"]["ordinals"]["0"]["state"],
                        res["breaker"]["state_name"],
                        len(sorted(d.glob("corda_tpu_flight_*.jsonl"))))
        finally:
            mon.unsubscribe(pol.on_device_event)
            R.unregister_policy(pol)
    assert out["port"] == out["ref"]
    assert out["port"][1:] == ("quarantined", 1, "device-quarantine:0", True,
                               "quarantined", "closed", 1)


def test_resilience_off_by_default():
    out = {}
    for pkg in PKG:
        P = PKG[pkg]
        s = (P["serving"].DeviceScheduler(use_device_default=False) if pkg == "ref"
             else P["serving"].DeviceScheduler(device="cpu"))
        try:
            rr = s.submit_rows(make_rows(pkg, 2), use_device=False).result(timeout=30)
            out[pkg] = (s._resilience, s._hedge, P["serving"].active_policy(),
                        bool(rr.mask.all()), P["snapshot"]()["resilience"])
        finally:
            s.shutdown()
    assert out["port"] == out["ref"] == (None, None, None, True, {"enabled": False})


# ---------------------------------------------------- the port's failover rule


def _port_rows(n):
    return make_rows("port", n)


def test_a_real_launch_error_raises_through_dispatch_and_scheduler(monkeypatch):
    """A torch or CUDA error from a launch (or a kernel build) is not a
    fallback: it raises out of ``dispatch_signature_rows`` and fails the
    scheduler's futures, and no failover is counted."""
    def lost(*_a, **_k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(port_batch, "_dispatch_bucket", lost)
    before = counters("port")
    with pytest.raises(RuntimeError, match="illegal memory access"):
        port_batch.dispatch_signature_rows(_port_rows(3), device="cpu")
    pol = port_res.ResiliencePolicy(flight_dump_on_quarantine=False,
                                    probe_runner=lambda o: True)
    s = port_serving.DeviceScheduler(device="cpu", resilience=pol)
    try:
        fut = s.submit_rows(_port_rows(3))
        with pytest.raises(RuntimeError, match="illegal memory access"):
            fut.result(timeout=30)
    finally:
        s.shutdown()
    d = delta("port", before)
    assert d["verifier.device_failover"] == 0 and d["serving.device_failover"] == 0
    assert d["serving.redispatch"] == 0 and pol.quarantine.state(0) == "healthy"


def test_a_build_failure_raises_through_the_scheduler(monkeypatch):
    """A kernel that fails to build reaches the caller too: the scheduler
    builds every kernel before its first dispatch on the card."""
    from corda_tpu_torch.ops import _build

    def broken():
        raise RuntimeError("nvcc failed: csrc/ed25519_verify.cu")

    monkeypatch.setattr(_build, "kernels", broken)
    s = port_serving.DeviceScheduler(device="cpu")
    s._ensure_devices()
    monkeypatch.setattr(s, "device", __import__("torch").device("cuda", 0))
    try:
        fut = s.submit_rows(_port_rows(2))
        with pytest.raises(RuntimeError, match="nvcc failed"):
            fut.result(timeout=30)
    finally:
        s.shutdown()


@pytest.mark.parametrize("kind", ["injected", "serving"])
def test_an_injected_fault_or_serving_error_fails_over(monkeypatch, kind):
    """The two kinds that fail over: counted, every verdict the host's."""
    real = port_batch._dispatch_bucket
    if kind == "injected":
        inj = port_fi.install(port_fi.FaultInjector(port_fi.FaultPlan(
            seed=1, fail_sites=(("verifier.device", 1),))))
    else:
        inj = None

        def refused(sid, *args):
            raise port_serving.SchedulerSaturatedError("no room")

        monkeypatch.setattr(port_batch, "_dispatch_bucket", refused)
    before = counters("port")
    rows = make_rows("port", 4, tamper={1})
    try:
        pending = port_batch.dispatch_signature_rows(rows, device="cpu")
        mask = pending.collect()
    finally:
        port_fi.clear()
        monkeypatch.setattr(port_batch, "_dispatch_bucket", real)
    assert mask.tolist() == [True, False, True, True]
    assert pending.device_rows == 0 and not pending.device_mask.any()
    assert delta("port", before)["verifier.device_failover"] == 1
    if inj is not None:
        assert any(e.site == "verifier.device" and e.kind == "op-fail" for e in inj.trace)


def test_collect_time_failover_of_a_serving_error(monkeypatch):
    """A readback that fails with a ``ServingError`` settles its bucket on
    the host at ``collect()``; any other readback error raises."""
    real_copy = port_batch.start_host_copy

    class Lost:
        event = None

        def __init__(self, error):
            self._error = error

        def wait(self):
            raise self._error

    for error, fails_over in ((port_serving.ServingError("wedged"), True),
                              (RuntimeError("CUDA error: device lost"), False)):
        monkeypatch.setattr(port_batch, "start_host_copy",
                            lambda m, e=error: Lost(e))
        before = counters("port")
        rows = make_rows("port", 3, tamper={2})
        pending = port_batch.dispatch_signature_rows(rows, device="cpu")
        if fails_over:
            assert pending.collect().tolist() == [True, True, False]
            assert pending.device_rows == 0
            assert delta("port", before)["verifier.device_failover"] == 1
        else:
            with pytest.raises(RuntimeError, match="device lost"):
                pending.collect()
            assert delta("port", before)["verifier.device_failover"] == 0
        monkeypatch.setattr(port_batch, "start_host_copy", real_copy)


def test_hedge_deadline_and_gauges_equal_the_reference():
    out = {}
    for pkg in PKG:
        R = PKG[pkg]["res"]
        pol = R.ResiliencePolicy(hedge_factor=3.0, hedge_min_s=0.1, hedge_max_s=2.0)
        out[pkg] = ([pol.hedge_deadline_s(0, e) for e in (0.0, 0.01, 0.2, 5.0)],
                    pol.snapshot()["hedge"], pol.breaker_state_mesh())
        for o in range(3):
            pol.breaker_for(o).record_failure()
        out[pkg] += (pol.breaker_state_mesh(), sorted(pol.snapshot()["breaker"]["per_ordinal"]))
    assert out["port"] == out["ref"]
    assert out["port"][0] == [None, 0.1, pytest.approx(0.6), 2.0]


def test_concurrent_probe_launches_one_canary():
    """Two probe passes racing one due ordinal launch one canary."""
    for pkg in PKG:
        R = PKG[pkg]["res"]
        now = [0.0]
        gate = threading.Event()
        runs = []

        def runner(o):
            runs.append(o)
            gate.wait(5)
            return True

        pol = R.ResiliencePolicy(strikes=1, probe_backoff_s=0.01, probe_runner=runner,
                                 clock=lambda: now[0], flight_dump_on_quarantine=False)
        pol.on_dispatch_failure(2)
        now[0] += 1.0
        pol.maybe_probe()
        pol.maybe_probe()
        gate.set()
        deadline = time.monotonic() + 5
        while pol.quarantine.state(2) != "healthy" and time.monotonic() < deadline:
            time.sleep(0.01)
        assert runs == [2] and pol.quarantine.state(2) == "healthy", pkg


@pytest.mark.parametrize("kind", ["torch", "serving"])
def test_a_hedged_batch_device_error_is_counted_apart(monkeypatch, kind):
    """A hedged batch whose device leg fails after the host's leg settled
    it: the host's verdicts stand either way, but a plain error from the
    readback (a torch or CUDA error) is counted as
    ``serving.hedge.device_error``, not as a discarded late readback."""
    error = (RuntimeError("CUDA error: unspecified launch failure") if kind == "torch"
             else port_serving.ServingError("a late readback"))
    calls = [0]

    class Failing(FakePending):
        def collect(self):
            mask = super().collect()
            if self.stall_until is not None:
                raise error
            return mask

    def fake(rows, *, use_device=True, min_bucket=None, device=None, **_kw):
        mask = np.array([port_is_valid(k, s, m) for k, s, m in rows], dtype=bool)
        pending = Failing(mask, max(min_bucket or 0, len(rows)), use_device)
        if use_device:
            calls[0] += 1
            if calls[0] == 2:       # the first dispatch warms the shape
                pending.inject_stall(1.0)
        return pending

    monkeypatch.setattr(port_batch, "dispatch_signature_rows", fake)
    monkeypatch.setattr(port_sched, "dispatch_signature_rows", fake)
    names = ("serving.hedge.device_error", "serving.hedge.discarded", "serving.hedge.won_host")

    def read():
        snap = port_metrics().snapshot()
        return [snap.get(n, {}).get("count", 0) for n in names]

    pol = port_res.ResiliencePolicy(strikes=50, hedge_min_s=0.15, hedge_max_s=0.5,
                                    breaker_threshold=50, probe_runner=lambda o: True,
                                    flight_dump_on_quarantine=False)
    s = scheduler("port", shapes=port_serving.ShapeTable({"buckets": [8], "source": "test"}),
                  resilience=pol)
    rows = make_rows("port", 5, tamper={1})
    expected = [i != 1 for i in range(5)]
    try:
        assert s.submit_rows(rows, use_device=True).result(timeout=30).n_device == 5
        before = read()
        rr = s.submit_rows(rows, use_device=True).result(timeout=30)
        deadline = time.monotonic() + 10
        while sum(read()[:2]) == sum(before[:2]) and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        s.shutdown()
    assert rr.mask.tolist() == expected and rr.n_device == 0
    d = dict(zip(names, (a - b for a, b in zip(read(), before))))
    assert d["serving.hedge.won_host"] == 1
    if kind == "torch":
        assert (d["serving.hedge.device_error"], d["serving.hedge.discarded"]) == (1, 0)
    else:
        assert (d["serving.hedge.device_error"], d["serving.hedge.discarded"]) == (0, 1)
