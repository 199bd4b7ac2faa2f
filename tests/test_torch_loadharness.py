"""The open-loop load harness: the port's ``tools/loadharness.py`` against
the reference's (``tests/test_tools.py::TestLoadHarness``).

- the ramp at the reference test's sizes (one 8-qps step of 1 s, seed 7,
  Cash payments over a three-node mock network, the port's on
  ``device="cpu"``): ``offered`` equals the reference's (the arrival clock
  is seeded and never waits), every offered payment completes, the step
  carries the reference's keys, its waterfall sums to its wall within 5%,
  and ``LOADTEST.json`` passes ``tools_perf_gate.py --check-schema``;
- seeded issue ramps: ``offered`` equal to the reference's for each seed;
- ``run_overload`` and ``run_causal`` at small sizes in both packages: the
  storm's offered load by class equal (seeded), the same certificate and
  ledger keys, and the overload section through the schema gate;
- the configurations: the reference's fields and defaults, plus
  ``device`` (the card unless ``"cpu"``), with ``use_device`` on by
  default;
- ``resilience=True``: a short issue ramp in both packages on a
  self-healing shared scheduler, both documents through the schema gate.

The port's payments here take its host route (``use_device=False``, the
reference's default) for the sender's verifier; its other nodes run the
plain versions of the kernels on the CPU, which is what the wall of these
tests is made of (one to two minutes for the payment ramp, whose payments
finish 1-2 minutes after their arrival there). So both packages' ramps are
scored against a p99 objective of 600 s rather than the reference test's
10 s: the schema gate needs a knee."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

import corda_tpu.tools.loadharness as ref_lh
import corda_tpu_torch.testing.mocknet as port_mocknet
import corda_tpu_torch.tools.loadharness as port_lh
from test_torch_layers import (  # noqa: F401  (fixtures)
    REPO,
    clean_layers,
    one_torch_thread,
)

LH = {"ref": ref_lh, "port": port_lh}


def gate(payload: dict, tmp_path, name: str) -> subprocess.CompletedProcess:
    path = port_lh.write_loadtest(payload, str(tmp_path / name))
    return subprocess.run([sys.executable, os.path.join(REPO, "tools_perf_gate.py"),
                           "--result", path, "--check-schema"],
                          capture_output=True, text=True, timeout=60)


@pytest.fixture(scope="module")
def parking_grace():
    grace = port_mocknet.MOCK_PARKING_GRACE_S
    port_mocknet.MOCK_PARKING_GRACE_S = 30.0
    yield
    port_mocknet.MOCK_PARKING_GRACE_S = grace


def _config(pkg, **kw):
    if pkg == "port":
        kw.setdefault("device", "cpu")
        kw.setdefault("use_device", False)
    return LH[pkg].HarnessConfig(**kw)


@pytest.fixture(scope="module")
def ramps(parking_grace):
    kw = dict(qps_steps=(8.0,), step_duration_s=1.0, drain_timeout_s=300.0, p99_slo_s=600.0,
              min_samples=3, seed=7)
    return {pkg: LH[pkg].run_harness(_config(pkg, **kw)) for pkg in ("ref", "port")}


def test_ramp_offered_equals_the_references(ramps):
    (ref,), (port,) = ramps["ref"]["steps"], ramps["port"]["steps"]
    assert port["offered"] == ref["offered"]
    assert 3 <= port["offered"] <= 20
    assert port["drained"] and port["completed"] == port["offered"]
    assert (port["errors"], port["shed"]) == (0, 0)
    assert sorted(port) == sorted(ref)
    assert port["p99_s"] >= port["p50_s"]


def test_ramp_payload_shape_and_waterfall(ramps):
    ref, port = ramps["ref"], ramps["port"]
    assert port["mode"] == ref["mode"] == "open-loop-poisson"
    assert port["schema"] == ref["schema"] == port_lh.LOADTEST_SCHEMA == 1
    assert sorted(port["config"]) == sorted(ref["config"])
    assert port["config"]["use_device"] is False
    wf = port["steps"][0]["waterfall"]
    assert wf["flow_class"].endswith("CashPaymentFlow") and wf["flows"] > 0
    assert abs(sum(wf["phases"].values()) - wf["wall_s"]) <= 0.05 * wf["wall_s"]
    assert wf["phases"]["notary_rtt"] > 0
    assert sorted(wf["phases"]) == sorted(ref["steps"][0]["waterfall"]["phases"])


def test_ramp_payload_passes_the_schema_gate(ramps, tmp_path):
    for pkg, payload in ramps.items():
        out = gate(payload, tmp_path, f"LOADTEST-{pkg}.json")
        assert out.returncode == 0, (pkg, out.stdout + out.stderr)
    with open(tmp_path / "LOADTEST-port.json") as f:
        assert json.load(f)["schema"] == 1


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_issue_ramp_offered_equal(seed, parking_grace):
    kw = dict(qps_steps=(4.0, 12.0), step_duration_s=0.5, drain_timeout_s=60.0, seed=seed,
              workload="issue", min_samples=1)
    out = {pkg: LH[pkg].run_harness(_config(pkg, **kw)) for pkg in ("ref", "port")}
    assert ([s["offered"] for s in out["port"]["steps"]]
            == [s["offered"] for s in out["ref"]["steps"]])
    for s in out["port"]["steps"]:
        assert s["completed"] == s["offered"] and s["drained"]
        assert s["waterfall"]["flow_class"].endswith("CashIssueFlow")


def _overload(pkg):
    cfg = LH[pkg].OverloadConfig(base_qps=4.0, overload_factor=2.0, baseline_s=1.0,
                                 storm_s=1.0, recovery_s=3.0, recovery_window_s=1.0,
                                 deadline_s=6.0, partition_bursts=1, partition_burst_s=0.2,
                                 workload="issue", seed=11)
    if pkg == "port":
        cfg = dataclasses.replace(cfg, device="cpu", use_device=False)
    return LH[pkg].run_overload(cfg)["overload"]


def test_overload_certificate_equal_shape(tmp_path, parking_grace):
    ref, port = _overload("ref"), _overload("port")
    assert sorted(port) == sorted(ref)
    assert sorted(port["config"]) == sorted(ref["config"])
    # the storm's arrivals are seeded and never wait: the same offered load
    assert port["offered_by_class"] == ref["offered_by_class"]
    assert port["schema"] == ref["schema"] == port_lh.OVERLOAD_SCHEMA
    out = gate({"overload": port}, tmp_path, "OVERLOAD-port.json")
    assert out.returncode == 0, out.stdout + out.stderr


def _causal(pkg):
    base = _config(pkg, workload="issue", seed=5, min_samples=1, drain_timeout_s=60.0)
    return LH[pkg].run_causal(base, 4.0, phases=("serialize", "checkpoint"), speedups=(0.5,),
                              probe_duration_s=0.5)


def test_causal_ledger_equal_shape(parking_grace):
    ref, port = _causal("ref"), _causal("port")
    assert sorted(port) == sorted(ref)
    assert [(c["phase"], c["speedup_pct"]) for c in port["cells"]] == \
        [(c["phase"], c["speedup_pct"]) for c in ref["cells"]]
    assert sorted(port["cells"][0]) == sorted(ref["cells"][0])
    assert {e["phase"] for e in port["ledger"]} == {e["phase"] for e in ref["ledger"]}
    assert port["source"] == ref["source"] == "loadharness"


def test_configs_are_the_references_plus_device():
    for name in ("HarnessConfig", "OverloadConfig"):
        ref = {f.name: f.default for f in dataclasses.fields(getattr(ref_lh, name))}
        port = {f.name: f.default for f in dataclasses.fields(getattr(port_lh, name))}
        assert set(port) == set(ref) | {"device"}
        assert port["device"] is None and port["use_device"] is True
        assert {k: v for k, v in port.items() if k not in ("device", "use_device")} == \
            {k: v for k, v in ref.items() if k != "use_device"}


def test_resilience_ramp_matches_the_references(tmp_path, parking_grace):
    """``resilience=True`` in both packages: a short issue ramp runs on a
    self-healing shared scheduler (the port's on the harness's device), both
    ``LOADTEST.json`` documents pass the schema gate and record the flag, the
    seeded offered load is equal, and teardown leaves no shared scheduler."""
    import corda_tpu_torch.serving as port_serving
    import corda_tpu_torch.serving.scheduler as port_sched

    seen = []
    configure = port_serving.configure_scheduler

    def spy(**kw):
        sched = configure(**kw)
        seen.append((sched.device.type, sched._resilience))
        return sched

    kw = dict(qps_steps=(4.0,), step_duration_s=0.5, drain_timeout_s=60.0, seed=3,
              workload="issue", min_samples=1, p99_slo_s=600.0, resilience=True)
    port_serving.configure_scheduler = spy
    try:
        out = {pkg: LH[pkg].run_harness(_config(pkg, **kw)) for pkg in ("ref", "port")}
    finally:
        port_serving.configure_scheduler = configure
    assert [(dev, type(pol).__name__, pol.flight_dump_on_quarantine) for dev, pol in seen] \
        == [("cpu", "ResiliencePolicy", False)]
    assert not port_sched._globals
    assert ([s["offered"] for s in out["port"]["steps"]]
            == [s["offered"] for s in out["ref"]["steps"]])
    for pkg, payload in out.items():
        assert payload["config"]["resilience"] is True
        s, = payload["steps"]
        assert s["completed"] == s["offered"] and s["drained"]
        res = gate(payload, tmp_path, f"LOADTEST-resilience-{pkg}.json")
        assert res.returncode == 0, (pkg, res.stdout + res.stderr)


def test_write_loadtest_is_atomic(tmp_path):
    path = port_lh.write_loadtest({"schema": 1, "x": [1, 2]}, str(tmp_path / "L.json"))
    assert not os.path.exists(path + ".tmp")
    with open(path) as f:
        assert json.load(f) == {"schema": 1, "x": [1, 2]}
