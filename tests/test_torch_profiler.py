"""The kernel profiler of both packages (``observability/profiler.py``):
the reference's ``tests/test_profiler.py`` core, instrumented-dispatch and
pad-waste cases on the reference's profiler and on the port's, exactly.

- core: off by default (no ``profiler.*`` metric created, no span
  attribute written by a profiled entry point), the keyed first-dispatch
  latch counted once under eight racing threads and reset, batch
  efficiency at bucket boundaries, compile/execute split and bytes, span
  stamping, the registry mirror and its exposition;
- instrumented dispatch: the port's entry points (``sha256_batch_words``,
  ``ed25519_verify_dispatch`` with kernel A's ``sha512`` key inside it,
  ``ecdsa_verify_dispatch``, ``ed25519_sign_dispatch``,
  ``compute_tx_ids``) record one compile then executes a key on the CPU,
  timed by the wall clock there (CUDA events on the card). Kernel C pads
  nothing, so the port's ``sha256`` bucket is the message count where the
  reference's is its power of two;
- pad waste: the scheduler's ``serving.batch_pad_waste`` timer and
  ``serving.batch_fill_ratio`` gauge with the profiler off, and
  ``PendingRows.padded_lanes`` as the lanes the kernels ran."""

import threading

import numpy as np
import pytest
import torch

import importlib

import corda_tpu.observability as ref_obs
import corda_tpu_torch.observability as port_obs
from corda_tpu.node.monitoring import node_metrics as ref_metrics
from corda_tpu_torch.node.monitoring import monitoring_snapshot as port_snapshot
from corda_tpu_torch.node.monitoring import node_metrics as port_metrics

# by importlib: ``observability.profiler`` as an attribute is a function
ref_prof = importlib.import_module("corda_tpu.observability.profiler")
port_prof = importlib.import_module("corda_tpu_torch.observability.profiler")
PKG = {"ref": (ref_prof, ref_obs, ref_metrics), "port": (port_prof, port_obs, port_metrics)}


@pytest.fixture(autouse=True)
def profiler_off_after():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    for prof, _obs, _m in PKG.values():
        prof.configure_profiler(enabled=False, reset=True)
    torch.set_num_threads(before)


def _strip_times(kernels: dict) -> dict:
    keep = ("compile_count", "execute_count", "rows", "exec_rows", "padded_lanes",
            "batch_efficiency", "bytes_in", "bytes_out")
    return {k: {**{f: v[f] for f in keep if f in v},
                "buckets": {b: {f: bv[f] for f in keep if f in bv}
                            for b, bv in v["buckets"].items()}}
            for k, v in kernels.items()}


def test_disabled_by_default_and_off_leaves_no_footprint():
    from corda_tpu.ops.sha256 import sha256_batch as ref_sha
    from corda_tpu_torch.ops.sha256 import sha256_batch as port_sha

    out = {}
    for pkg, sha in (("ref", ref_sha), ("port", lambda m: port_sha(m, device="cpu"))):
        prof, obs, metrics = PKG[pkg]
        assert prof.active_profiler() is None
        assert prof.profiler().snapshot()["enabled"] is False
        before = set(metrics().snapshot())
        obs.configure_tracing(sample_rate=1.0)
        obs.tracer().clear()
        try:
            span = obs.tracer().root("flow")
            with prof.stamp_span(span):
                digests = sha([b"a", b"bb", b"ccc"])
            span.finish()
        finally:
            obs.configure_tracing(sample_rate=0.0)
            obs.tracer().clear()
        added = {k for k in set(metrics().snapshot()) - before if k.startswith("profiler.")}
        out[pkg] = (digests, added, [k for k in span.attrs if k.startswith("profiler.")])
    assert out["port"] == out["ref"]
    assert out["port"][1:] == (set(), [])


def test_latch_compile_counted_once_per_key_thread_safe():
    out = {}
    for pkg in PKG:
        prof = PKG[pkg][0].DeviceProfiler(enabled=True)
        barrier = threading.Barrier(8)

        def dispatch():
            barrier.wait(timeout=10)
            prof.profile("test.kernel", lambda: None, rows=4, bucket=8)

        threads = [threading.Thread(target=dispatch) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        snap1 = _strip_times(prof.snapshot()["kernels"])
        prof.profile("test.kernel", lambda: None, rows=10, bucket=16)
        prof.profile("test.kernel", lambda: None, rows=10, bucket=16)
        snap2 = _strip_times(prof.snapshot()["kernels"])
        prof.reset()
        prof.profile("test.kernel", lambda: None, rows=4, bucket=8)
        out[pkg] = (snap1, snap2, _strip_times(prof.snapshot()["kernels"]))
    assert out["port"] == out["ref"]
    b = out["port"][0]["test.kernel"]["buckets"]["8"]
    assert b["compile_count"] == 1 and b["execute_count"] == 7


def test_batch_efficiency_compile_execute_split_and_bytes():
    out = {}
    for pkg in PKG:
        prof = PKG[pkg][0].DeviceProfiler(enabled=True)
        prof.profile("k", lambda: None, rows=8, bucket=8)
        prof.profile("k", lambda: None, rows=9, bucket=16)
        prof.profile("k", lambda: None, rows=16, bucket=4)
        prof.profile("empty", lambda: None, rows=0, bucket=8)
        for _ in range(3):
            prof.profile("k2", lambda: None, rows=2, bucket=4, bytes_in=100, bytes_out=10)
        prof.profile("k3", lambda: [1, 2, 3], rows=3, bucket=lambda r: 4,
                     bytes_out=lambda r: len(r) * 7)
        snap = prof.snapshot()
        b = snap["kernels"]["k2"]["buckets"]["4"]
        timing_ok = (b["compile_s"] >= 0.0
                     and b["execute_total_s"] >= b["execute_max_s"] >= b["execute_min_s"])
        out[pkg] = (_strip_times(snap["kernels"]), snap["enabled"], timing_ok)
    assert out["port"] == out["ref"]
    k = out["port"][0]["k"]
    assert k["batch_efficiency"] == pytest.approx(33 / 40) and "empty" not in out["port"][0]


def test_span_stamping_and_registry_mirror():
    out = {}
    for pkg in PKG:
        prof, obs, metrics = PKG[pkg]
        prof.configure_profiler(enabled=True, reset=True)
        obs.configure_tracing(sample_rate=1.0)
        obs.tracer().clear()
        before = metrics().snapshot()
        try:
            span = obs.tracer().root("serving.batch")
            with prof.stamp_span(span):
                prof.profiler().profile("k", lambda: None, rows=2, bucket=8)
                prof.profiler().profile("k2", lambda: None, rows=2, bucket=4)
            span.finish()
            prof.profiler().profile("k", lambda: None, rows=6, bucket=8)
        finally:
            obs.configure_tracing(sample_rate=0.0)
            obs.tracer().clear()
            prof.configure_profiler(enabled=False)
        snap = metrics().snapshot()
        count = {n: snap[n]["count"] - before.get(n, {}).get("count", 0)
                 for n in ("profiler.dispatches", "profiler.pad_rows")}
        samples = obs.parse_prometheus(obs.metrics_text())
        out[pkg] = ({k: v for k, v in span.attrs.items() if k.startswith("profiler.")}, count,
                    int(samples["cordatpu_profiler_dispatches_total"]) >= 3,
                    any(k.startswith("cordatpu_profiler_execute_s_seconds") for k in samples))
    assert out["port"] == out["ref"]
    assert out["port"][0] == {"profiler.kernel": "k2", "profiler.bucket": 4,
                              "profiler.kernels": ["k/8", "k2/4"]}


def _port_entry_points():
    from corda_tpu_torch.crypto import ecdsa_host
    from corda_tpu_torch.ops.ed25519 import ed25519_verify_dispatch
    from corda_tpu_torch.ops.ed25519_sign import ed25519_sign_dispatch
    from corda_tpu_torch.ops.secp256 import ecdsa_verify_dispatch
    from corda_tpu_torch.ops.sha256 import sha256_batch_words
    from corda_tpu_torch.testing import ecdsa_adversarial_lanes, signed_triples

    triples = signed_triples(5, seed=60)
    pks, sigs, msgs = (list(x) for x in zip(*triples))
    lanes = ecdsa_adversarial_lanes("secp256k1", seed=2)[:3]
    seeds = [bytes([i]) * 32 for i in range(3)]
    assert ecdsa_host.CURVES
    return [
        lambda: sha256_batch_words([b"x%d" % i for i in range(5)], device="cpu"),
        lambda: ed25519_verify_dispatch(pks, sigs, msgs, device="cpu"),
        lambda: ecdsa_verify_dispatch("secp256k1", [x[1] for x in lanes],
                                      [x[2] for x in lanes], [x[3] for x in lanes],
                                      device="cpu"),
        lambda: ed25519_sign_dispatch(seeds, [b"m0", b"m1", b"m2"], device="cpu").collect(),
    ]


def test_port_entry_points_profile_compile_then_execute():
    from corda_tpu.ops.sha256 import sha256_batch_words as ref_words

    # the reference's own instrumented case
    ref_prof.configure_profiler(enabled=True, reset=True)
    try:
        for _ in range(3):
            np.asarray(ref_words([b"x%d" % i for i in range(5)]))
    finally:
        ref_prof.configure_profiler(enabled=False)
    ref_b = ref_prof.profiler().snapshot()["kernels"]["sha256"]["buckets"]["8"]
    port_prof.configure_profiler(enabled=True, reset=True)
    try:
        for _ in range(3):
            for call in _port_entry_points():
                call()
    finally:
        port_prof.configure_profiler(enabled=False)
    kernels = port_prof.profiler().snapshot()["kernels"]
    assert set(kernels) >= {"sha256", "sha512", "ed25519.verify", "ecdsa.verify",
                            "ed25519.sign"}
    for name, k in kernels.items():
        for b in k["buckets"].values():
            assert (b["compile_count"], b["execute_count"]) == (1, 2), name
    sha = kernels["sha256"]["buckets"]["5"]
    assert (sha["compile_count"], sha["execute_count"]) == \
        (ref_b["compile_count"], ref_b["execute_count"])
    assert sha["bytes_out"] == ref_b["bytes_out"] == 3 * 5 * 32
    assert sha["batch_efficiency"] == 1.0 and ref_b["batch_efficiency"] == pytest.approx(5 / 8)
    assert kernels["ed25519.verify"]["buckets"]["8"]["rows"] == 15
    assert kernels["sha512"]["buckets"]["8"]["bytes_out"] == 3 * 5 * 64


def test_compute_tx_ids_profiles_the_sweep():
    from corda_tpu_torch.ops.txid import compute_tx_ids
    from corda_tpu_torch.testing import GeneratedLedger

    wtxs = [stx.tx for stx in GeneratedLedger(seed=4, device="cpu").generate(4).values()]
    port_prof.configure_profiler(enabled=True, reset=True)
    try:
        ids = [compute_tx_ids(wtxs, device="cpu") for _ in range(2)]
    finally:
        port_prof.configure_profiler(enabled=False)
    assert ids[0] == ids[1] == [w.id for w in wtxs]
    k = port_prof.profiler().snapshot()["kernels"]["txid"]
    assert (k["compile_count"], k["execute_count"], k["rows"]) == (1, 1, 8)


def test_pad_waste_timer_and_fill_ratio_gauge(monkeypatch):
    """Scheduler accounting with the profiler off, the device half stubbed
    in both packages: 3 rows padded to the ladder's 128 waste 125 lanes."""
    import corda_tpu.serving as ref_serving
    import corda_tpu.verifier.batch as ref_vbatch
    import corda_tpu_torch.serving as port_serving
    import corda_tpu_torch.serving.scheduler as port_sched

    class FakePending:
        def __init__(self, n, lanes):
            self._n = n
            self.device_rows = n
            self.device_mask = np.ones(n, dtype=bool)
            self.padded_lanes = lanes

        def collect(self):
            return np.ones(self._n, dtype=bool)

    def fake(rows, use_device=True, min_bucket=None, **_kw):
        return FakePending(len(rows), max(min_bucket or 0, 128))

    # the port refuses a row of no known scheme at the door
    monkeypatch.setattr(port_sched, "check_schemes", lambda rows: None)

    monkeypatch.setattr(ref_vbatch, "dispatch_signature_rows", fake)
    monkeypatch.setattr(port_sched, "dispatch_signature_rows", fake)
    out = {}
    for pkg, sched, metrics in (
            ("ref", lambda: ref_serving.device_scheduler(), ref_metrics),
            ("port", lambda: port_serving.device_scheduler("cpu"), port_metrics)):
        s = sched()
        m = metrics()
        waste_before = m.timer("serving.batch_pad_waste").count
        rr = s.submit_rows([(None, b"", b"")] * 3, use_device=True).result(timeout=30)
        waste = m.timer("serving.batch_pad_waste")
        ratio = m.gauge("serving.batch_fill_ratio").value
        out[pkg] = (bool(rr.mask.all()), rr.n_device, waste.count - waste_before,
                    waste.snapshot()["last_s"], 0 < ratio <= 1.0)
    assert out["port"] == out["ref"] == (True, 3, 1, 125.0, True)
    snap = port_snapshot()
    assert "batch_fill_ratio" in snap["serving"] and "profiler" in snap


def test_pending_rows_reports_actual_padded_lanes():
    from corda_tpu.crypto import generate_keypair, sign
    from corda_tpu.verifier.batch import dispatch_signature_rows as ref_dispatch
    from corda_tpu_torch.crypto.keys import PublicKey
    from corda_tpu_torch.verifier.batch import dispatch_signature_rows as port_dispatch

    kp = generate_keypair()
    msgs = [b"pl%d" % i for i in range(5)]
    ref_rows = [(kp.public, sign(kp.private, m), m) for m in msgs]
    port_rows = [(PublicKey(k.scheme_id, k.encoded), s, m) for k, s, m in ref_rows]
    out = {}
    for pkg, dispatch, rows, kw in (("ref", ref_dispatch, ref_rows, {}),
                                    ("port", port_dispatch, port_rows, {"device": "cpu"})):
        dev = dispatch(rows, use_device=True, **kw)
        host = dispatch(rows, use_device=False, **kw)
        out[pkg] = (bool(dev.collect().all()), dev.padded_lanes, bool(host.collect().all()),
                    host.padded_lanes)
    assert out["port"] == out["ref"] == (True, 8, True, 0)


def test_cuda_timed_dispatch_is_read_at_settle(monkeypatch):
    """On a CUDA device the event pair is queued, not waited for: the
    dispatch returns at once, a later dispatch reads the pairs that have
    completed, and ``snapshot()`` waits for the rest, keeping the compile
    latch in dispatch order."""
    done = []

    class Event:
        def __init__(self, enable_timing=False):
            self.t, self.waited = None, False

        def record(self, stream=None):
            self.t = len(done)

        def query(self):
            return self.t in done

        def synchronize(self):
            self.waited = True
            done.append(self.t)

        def elapsed_time(self, end):
            return 1000.0 * (end.t - self.t + 1)

    monkeypatch.setattr(port_prof, "_cuda_device", lambda device: device)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    p = port_prof.DeviceProfiler(enabled=True)
    assert p.profile("k", lambda: "first", rows=4, bucket=8, device="cuda:0") == "first"
    assert p._pending and not p._stats           # queued, nothing waited for
    done.append(0)                               # the first pair completes
    p.profile("k", lambda: None, rows=4, bucket=8, device="cuda:0")
    assert len(p._pending) == 1
    st = p._stats[("k", 8)]
    assert (st.compile_count, st.exec_count) == (1, 0)
    snap = p.snapshot()["kernels"]["k"]["buckets"]["8"]
    assert (snap["compile_count"], snap["execute_count"]) == (1, 1)
    assert not p._pending
