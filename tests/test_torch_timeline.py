"""The ring-buffer telemetry timeline: the port's
``observability/timeseries.py`` against the reference's
(``tests/test_timeline.py``).

- the ring: partial fill, wraparound, the minimum width;
- ``TimelineRecorder``: the same seeded counter increments, timer updates,
  SLO observations, device records and marks, ticked at the same instants,
  give equal rings (timestamps, every series' kind and points) and equal
  marks, each package reading its own registry and monitors; ring
  wraparound, a disabled tick and a reset too;
- the process recorder: ``configure_timeline`` round trips and the
  ``timeline`` section.

Exact equality: every tick's time is given (``tick(now=...)``)."""

import random

import pytest

from test_torch_layers import (  # noqa: F401  (fixtures)
    LAYERS,
    clean_layers,
    one_torch_thread,
)

PKGS = ("ref", "port")


@pytest.mark.parametrize("width, n", [(4, 3), (4, 7), (0, 3), (5, 5), (2, 100)])
def test_ring_equal(width, n):
    out = {}
    for pkg in PKGS:
        r = LAYERS[pkg].timeseries._Ring(width)
        for v in range(n):
            r.append(float(v))
        out[pkg] = (len(r), r.values())
    assert out["port"] == out["ref"]


def drive(pkg: str, seed: int, ring_points: int = 16) -> dict:
    L = LAYERS[pkg]
    T = L.timeseries
    rng = random.Random(seed)
    reg = L.monitoring.node_metrics()
    counters = (f"tlport.{seed}.events", f"tlport.{seed}.rows")
    timers = (f"tlport.{seed}.lat_s",)
    L.slo.configure_slo(enabled=True, reset=True, breach_handler=None, objectives=[
        L.slo.SLOObjective(name=f"tl{seed}", p99_s=0.01, min_samples=1)])
    dev = L.devicemon.configure_devicemon(enabled=True, reset=True)
    rec = T.TimelineRecorder(counters=counters, timers=timers, ring_points=ring_points,
                             mark_ring=8)
    rec.tick(now=0.5)          # disabled: a no-op
    rec.mark("never", 1.0)
    rec.enable()
    try:
        for k in range(40):
            for _ in range(rng.randint(0, 3)):
                reg.counter(rng.choice(counters)).inc(rng.randint(1, 9))
            for _ in range(rng.randint(0, 4)):
                reg.timer(timers[0]).update(rng.random())
            for _ in range(rng.randint(0, 3)):
                L.slo.active_slo().observe(f"tl{seed}", rng.random() * 0.02)
            if rng.random() < 0.3:
                dev.record_dispatch(0, rows=rng.randint(1, 50), padded_lanes=64)
                dev.record_settle(0, rng.random() * 0.01)
            if rng.random() < 0.2:
                rec.mark("step", float(k), t=float(k))
            rec.tick(now=float(k + 1))
        snap = rec.snapshot()
    finally:
        rec.disable()
    snap["series"] = {k: v for k, v in snap["series"].items()
                      if not k.startswith("device.")}
    return snap


@pytest.mark.parametrize("seed", range(4))
def test_seeded_ticks_give_equal_rings(seed):
    ref, port = drive("ref", seed), drive("port", seed)
    assert port == ref
    assert ref["ticks"] == 40 and len(ref["timestamps"]) == 16
    assert any(k.startswith("slo.") for k in ref["series"])


def test_device_series_equal_on_one_slot():
    """The device gauges ride the tick per ordinal; with one ordinal laid
    out in each package they are equal."""
    out = {}
    for pkg in PKGS:
        L = LAYERS[pkg]
        dev = L.devicemon.configure_devicemon(enabled=True, reset=True)
        dev._fixed_n = 1
        dev.reset()
        rec = L.timeseries.TimelineRecorder(counters=(), timers=(), ring_points=4)
        rec.enable()
        try:
            for k in range(6):
                dev.record_dispatch(0, rows=k + 1, padded_lanes=8)
                if k % 2:
                    dev.record_settle(0, 0.001 * k)
                rec.tick(now=float(k))
            out[pkg] = rec.snapshot()
        finally:
            rec.disable()
            dev._fixed_n = None
    assert out["port"] == out["ref"]
    assert any(k.startswith("device.") for k in out["ref"]["series"])


def test_reset_and_process_recorder_equal():
    out = {}
    for pkg in PKGS:
        T = LAYERS[pkg].timeseries
        default = T._global
        rec = T.configure_timeline(enabled=True, reset=True, thread=False, ring_points=8,
                                   cadence_s=0.5, counters=("tlproc.c",), timers=())
        LAYERS[pkg].monitoring.node_metrics().counter("tlproc.c").inc(3)
        rec.tick(now=1.0)
        rec.mark("m", 2.0, t=1.0)
        first = T.timeline_section()
        rec.reset()
        after = T.timeline_section()
        T.configure_timeline(enabled=False, reset=True)
        out[pkg] = (first, after, T.timeline_section(), T.active_timeline())
        T._global = default     # the process recorder's default settings back
    assert out["port"] == out["ref"]
    assert out["ref"][2] == {"enabled": False} and out["ref"][3] is None
