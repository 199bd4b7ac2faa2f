"""The SLO monitor, the flight recorder, the exposition and the per-device
registry: the port's ``observability/slo.py``, ``exposition.py`` and
``devicemon.py`` against the reference's (``tests/test_devicemon.py``,
``tests/test_timeline.py``, ``tests/test_observability.py``).

- ``SLOMonitor`` on the injected clock: the same seeded observations
  (latencies, errors, sheds as errors with no latency) give equal statuses,
  windowed p99s, burn rates, breach and burn latches, handler calls, events
  and byte-equal Prometheus lines;
- ``flight_dump``: the port writes the reference's line kinds in the
  reference's order (times left out), less ``resilience``, which waits for
  the serving resilience layer; a dump round-trips through either
  package's ``read_flight_dump``; the keep-N retention reclaims the same
  files;
- ``render_prometheus`` of one registry snapshot is byte-equal, and
  ``escape_label_value`` and ``parse_prometheus`` agree;
- ``DeviceMonitor`` with faked ordinals: the same dispatches, settles,
  shards and probes give equal snapshots and Prometheus lines, and the
  watchdog flags and clears the same stragglers and stalls; with the
  monitor off, ``devices`` reads ``{"enabled": false}`` and nothing calls
  ``torch.cuda``; with no CUDA device the port lays out one slot, as the
  reference does without a backend."""

import json
import os
import random
import time

import pytest
import torch

from test_torch_layers import (  # noqa: F401  (fixtures)
    LAYERS,
    FakeClock,
    clean_layers,
    one_torch_thread,
    strip_times,
)

PKGS = ("ref", "port")


def _objectives(S):
    return [
        S.SLOObjective("int-p99", priority="interactive", p99_s=0.05, window_s=30.0,
                       min_samples=5),
        S.SLOObjective("svc-err", priority="service", max_error_rate=0.1, window_s=20.0,
                       min_samples=5),
        S.SLOObjective("all", p99_s=0.2, max_error_rate=0.3, window_s=60.0, min_samples=3,
                       burn_fast_s=5.0, burn_slow_s=30.0, burn_threshold=2.0),
        S.SLOObjective("bulk-cold", priority="bulk", p99_s=0.01, min_samples=1000),
    ]


def drive(pkg: str, seed: int) -> dict:
    S = LAYERS[pkg].slo
    rng = random.Random(seed)
    clock = FakeClock()
    fired = []
    mon = S.SLOMonitor(objectives=_objectives(S), clock=clock, breach_handler=fired.append,
                       window_cap=128)
    mon.enable()
    out = {"eval": [], "burn": []}
    for i in range(600):
        prio = rng.choice(("interactive", "service", "bulk"))
        r = rng.random()
        if r < 0.1:
            mon.observe(prio, None, error=True)          # a shed: no latency sample
        elif r < 0.2:
            mon.observe(prio, rng.random() * 0.1, error=True)
        else:
            slow = (i // 100) % 2 == 1
            mon.observe(prio, rng.expovariate(10.0 if slow else 100.0))
        clock.advance(rng.expovariate(20.0))
        if i % 25 == 0:
            out["eval"].append(mon.evaluate())
            out["burn"].append(mon.evaluate_burn())
    out["fired"] = fired
    out["snapshot"] = mon.snapshot()
    out["prometheus"] = "\n".join(mon.prometheus_lines())
    return strip_times(out)


@pytest.mark.parametrize("seed", range(6))
def test_seeded_observations_equal(seed):
    ref, port = drive("ref", seed), drive("port", seed)
    assert port == ref
    assert ref["fired"], "the sequence breaches at least once"
    assert any(st["breached"] for ev in ref["eval"] for st in ev)


def _reference_cases(pkg):
    """The reference tests' windowed p99, latch and burn scenarios."""
    S = LAYERS[pkg].slo
    clk = [100.0]
    fired = []
    m = S.SLOMonitor(objectives=[S.SLOObjective(name="burn", p99_s=0.010, window_s=120.0,
                                                min_samples=5, burn_fast_s=5.0,
                                                burn_slow_s=60.0, burn_threshold=2.0)],
                     clock=lambda: clk[0], breach_handler=fired.append)
    m.enable()
    out = []
    for _ in range(10):
        m.observe("burn", 0.050)
    out += [m.evaluate_burn(), m.evaluate_burn(), m.evaluate()]
    clk[0] += 120.0
    out += [m.evaluate_burn(), m.evaluate()]
    for _ in range(10):
        m.observe("burn", 0.050)
    out += [m.evaluate_burn(), m.snapshot(), list(fired), m.prometheus_lines()]
    return strip_times(out)


def test_reference_latch_and_burn_cases_equal():
    assert _reference_cases("port") == _reference_cases("ref")


def test_section_and_exposition_of_the_process_monitor_equal():
    out = {}
    for pkg in PKGS:
        L = LAYERS[pkg]
        m = L.slo.configure_slo(enabled=True, reset=True, breach_handler=None,
                                objectives=_objectives(L.slo))
        for i in range(40):
            m.observe(("interactive", "service")[i % 2], 0.001 * i, error=i % 7 == 0)
        m.evaluate()
        # the monitor's own labeled families (the registry's ``slo.*``
        # counters depend on what else this process ran), each in
        # metrics_text
        lines = m.prometheus_lines()
        text = L.exposition.metrics_text()
        assert all(line in text.splitlines() for line in lines)
        fams = sorted(L.exposition.parse_prometheus("\n".join(lines) + "\n")["__types__"])
        out[pkg] = (strip_times(L.slo.slo_section()), fams, lines)
    assert out["port"] == out["ref"]
    assert out["ref"][1]


# --------------------------------------------------------- flight recorder

def _dump_kinds(pkg, tmp_path):
    L = LAYERS[pkg]
    L.slo.configure_slo(enabled=True, reset=True, breach_handler=None,
                        objectives=_objectives(L.slo))
    L.devicemon.configure_devicemon(enabled=True, reset=True)
    L.devicemon.devicemon().record_dispatch(0, rows=7, padded_lanes=8)
    L.devicemon.devicemon().record_settle(0, 0.02)
    path = L.slo.flight_dump(str(tmp_path / f"{pkg}.jsonl"), reason="kinds")
    assert not os.path.exists(path + ".tmp")
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    kinds = [ln["kind"] for ln in lines if ln["kind"] not in ("span", "event", "fault")]
    return kinds, lines, path


def test_flight_dump_line_kinds_in_order(tmp_path):
    ref, ref_lines, ref_path = _dump_kinds("ref", tmp_path)
    port, port_lines, port_path = _dump_kinds("port", tmp_path)
    assert port == [k for k in ref if k != "resilience"]
    assert "resilience" in ref
    for kind in ("header", "metrics", "devices", "slo", "timeline", "durability",
                 "flowprof", "sampler", "net", "contention", "causal"):
        assert kind in port
    # the same sections read back, each through the other package's reader
    # (``devices`` apart: the reference lays out JAX's CPU devices, the port
    # one slot with no CUDA device)
    ref_back = LAYERS["port"].slo.read_flight_dump(ref_path)
    port_back = LAYERS["ref"].slo.read_flight_dump(port_path)
    for kind in ("slo", "timeline", "flowprof", "net", "contention", "causal"):
        assert strip_times(port_back[kind]) == strip_times(ref_back[kind]), kind
    assert port_back["header"]["reason"] == "kinds"
    assert port_back["devices"]["devices"]["0"]["rows"] == 7


def test_flight_dump_unknown_kind_round_trips(tmp_path):
    for pkg in PKGS:
        S = LAYERS[pkg].slo
        path = S.flight_dump(str(tmp_path / f"fc-{pkg}.jsonl"), reason="fc")
        alien = {"kind": "hologram", "payload": {"x": [1, 2, 3]}}
        with open(path, "a") as f:
            f.write(json.dumps(alien) + "\n")
        out = S.read_flight_dump(path)
        assert out["extra"] == [alien] and out["header"]["reason"] == "fc"


def test_flight_retention_reclaims_the_same_files(tmp_path, monkeypatch):
    out = {}
    for pkg in PKGS:
        S = LAYERS[pkg].slo
        d = tmp_path / pkg
        d.mkdir()
        (d / "keep_me.jsonl").write_text("{}\n")
        monkeypatch.setenv("CORDA_TPU_FLIGHT_DIR", str(d))
        monkeypatch.setenv("CORDA_TPU_FLIGHT_KEEP", "3")
        paths = []
        for i in range(6):
            time.sleep(0.003)   # dumps are named by the millisecond
            p = S.flight_dump(reason=f"r{i}")
            os.utime(p, (1000 + i, 1000 + i))
            paths.append(os.path.basename(p))
        left = sorted(os.listdir(d))
        out[pkg] = (len(left), "keep_me.jsonl" in left,
                    [paths.index(p) for p in left if p in paths])
    assert out["port"] == out["ref"]
    assert out["ref"][0] == 4


# -------------------------------------------------------------- exposition

def _registry(pkg):
    M = LAYERS[pkg].monitoring
    reg = M.MetricRegistry()
    rng = random.Random(9)
    reg.counter("serving.requests").inc(41)
    reg.counter('weird"name\\x').inc(2)
    for v in (rng.random() for _ in range(300)):
        reg.timer("serving.wait_s").update(v)
    reg.gauge("serving.queue_depth", lambda: 17)
    reg.gauge("serving.label", lambda: "not a number")
    reg.meter("verifier.sigs").mark(64)
    return reg


def test_render_prometheus_byte_equal():
    snap = _registry("ref").snapshot()
    port_snap = _registry("port").snapshot()
    for k in ("serving.requests", "serving.queue_depth", 'weird"name\\x'):
        assert port_snap[k] == snap[k]
    for namespace in ("", "node."):
        ref = LAYERS["ref"].exposition.render_prometheus(snap, namespace=namespace)
        port = LAYERS["port"].exposition.render_prometheus(snap, namespace=namespace)
        assert port.encode() == ref.encode()
        assert (LAYERS["port"].exposition.parse_prometheus(port)
                == LAYERS["ref"].exposition.parse_prometheus(ref))


@pytest.mark.parametrize("value", ['plain', 'a"b', "back\\slash", "new\nline", '\\"\n', ""])
def test_escape_label_value_equal(value):
    assert (LAYERS["port"].exposition.escape_label_value(value)
            == LAYERS["ref"].exposition.escape_label_value(value))


def test_parser_rejects_the_same_lines():
    for bad in ("no_value_here", "x{unterminated 1", "x 1 2 3 4", "{} 1"):
        errs = []
        for pkg in PKGS:
            try:
                LAYERS[pkg].exposition.parse_prometheus(bad + "\n")
                errs.append(None)
            except ValueError:
                errs.append("ValueError")
        assert errs[0] == errs[1], bad


# ---------------------------------------------------------------- devicemon

def _devices(pkg: str, seed: int) -> dict:
    D = LAYERS[pkg].devicemon
    rng = random.Random(seed)
    clock = FakeClock()
    mon = D.DeviceMonitor(n_devices=4, enabled=True, clock=clock)
    for _ in range(200):
        op = rng.random()
        o = rng.randrange(4)
        if op < 0.4:
            mon.record_dispatch(o, rows=rng.randint(1, 100), padded_lanes=rng.choice((0, 128)))
        elif op < 0.7:
            mon.record_settle(o, rng.random() * 0.05, ok=rng.random() > 0.1)
        elif op < 0.85:
            shard = list(range(rng.randint(1, 4)))
            mon.record_sharded_dispatch(shard, rows=rng.randint(1, 99),
                                        padded_lanes=rng.choice((0, 64)))
            mon.record_sharded_settle(shard, rng.random() * 0.01, ok=rng.random() > 0.1)
        else:
            D.DispatchProbe(mon, o, rows=rng.randint(1, 9)).settle(ok=rng.random() > 0.2)
        clock.advance(rng.random() * 0.05)
    wd = D.DeviceWatchdog(mon, interval_s=1.0, straggler_factor=3.0, stall_s=0.5)
    sweeps = [wd.check_once(clock())]
    mon.record_dispatch(3, rows=1)
    for _ in range(8):
        mon.record_dispatch(1, rows=1)
        mon.record_settle(1, 0.5)
    clock.advance(2.0)
    sweeps.append(wd.check_once(clock()))
    for o in range(4):
        mon.record_settle(o, 0.001)
    sweeps.append(wd.check_once(clock()))
    snap = mon.snapshot()
    return strip_times({"snapshot": snap, "sweeps": sweeps,
                        "prometheus": mon.prometheus_lines(), "ordinals": mon.ordinals(),
                        "unhealthy": mon.unhealthy_ordinals()})


@pytest.mark.parametrize("seed", range(4))
def test_faked_ordinals_equal(seed):
    ref, port = _devices("ref", seed), _devices("port", seed)
    assert port == ref
    assert ref["snapshot"]["n_devices"] == 4


def test_off_makes_no_cuda_call(monkeypatch):
    calls = []
    for name in ("is_available", "device_count", "memory_stats", "current_device",
                 "get_device_properties"):
        orig = getattr(torch.cuda, name)
        monkeypatch.setattr(torch.cuda, name,
                            lambda *a, _n=name, _o=orig, **kw: (calls.append(_n), _o(*a, **kw))[1])
    D = LAYERS["port"].devicemon
    assert D.active_devicemon() is None
    assert D.devices_section() == {"enabled": False}
    assert LAYERS["port"].monitoring.monitoring_snapshot()["devices"] == {"enabled": False}
    assert "cordatpu_device_" not in LAYERS["port"].exposition.metrics_text()
    assert calls == []


def test_no_cuda_device_lays_out_one_slot(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    D = LAYERS["port"].devicemon
    mon = D.configure_devicemon(enabled=True, reset=True)
    snap = mon.snapshot()
    assert (snap["n_devices"], snap["platform"], sorted(snap["devices"])) == (1, "", ["0"])
    assert "hbm_bytes_in_use" not in snap["devices"]["0"]


def test_cuda_ordinals_lay_out_one_slot_each(monkeypatch):
    """Three faked ordinals: one slot each, and each slot's memory from
    ``torch.cuda.memory_stats(i)``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda i: {"allocated_bytes.all.current": 1000 * (i + 1)})
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: type("P", (), {"total_memory": 80 * 2 ** 30})())
    D = LAYERS["port"].devicemon
    mon = D.DeviceMonitor(enabled=True)
    mon.record_dispatch(2, rows=5)
    snap = mon.snapshot()
    assert (snap["n_devices"], snap["platform"]) == (3, "cuda")
    assert [snap["devices"][k]["hbm_bytes_in_use"] for k in ("0", "1", "2")] == [1000, 2000, 3000]
    assert snap["devices"]["2"]["dispatches"] == 1
    text = "\n".join(mon.prometheus_lines())
    assert 'cordatpu_device_hbm_bytes_in_use{device="1"} 2000' in text
