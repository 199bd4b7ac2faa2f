"""Critical-path accounting, the stack sampler and the causal profiler: the
port's ``observability/flowprof.py``, ``sampler.py`` and ``causal.py``
against the reference's, fed the same seeded sequences under the reference
tests' injected clock (``tests/test_flowprof.py``, ``tests/test_causal.py``).

- ``FlowProfiler``: seeded sequences of opens, activations, nested frames
  (declared causes among them), park hints, cross-thread adds, transit
  stamps, cause evidence and closes give equal per-flow waterfalls, an
  equal ``snapshot()`` (classes, phases, shares) and equal
  ``causes_snapshot()``; the reference tests' ledger scenarios too;
- the sampler's role mapping, its overhead arithmetic on the injected
  clock, and a sample of a named foreign thread (roles and folded frames);
- the causal profiler: ``_on_phase`` dilations under a fake sleep, the
  session's phase listener, ``run`` over a scripted probe and
  ``build_ledger`` on the same cells;
- the flight dump's ``flowprof``/``sampler`` kinds read back equal.

The phase set and cause set are the reference's. The reference's timing
budgets (``TestSampler::test_real_thread_overhead_under_budget``,
``TestClassifierOverhead``) are measured on the card by ``chip_smoke.py``
phase 25a, not here."""

import random
import threading
import time

import pytest

from test_torch_layers import (  # noqa: F401  (fixtures)
    LAYERS,
    FakeClock,
    clean_layers,
    one_torch_thread,
)

PKGS = ("ref", "port")


def profiler(pkg):
    clock = FakeClock()
    fp = LAYERS[pkg].flowprof.FlowProfiler(clock=clock)
    fp.enable()
    return fp, clock


def test_phase_and_cause_sets_equal():
    for name in ("PHASES", "CAUSES"):
        assert getattr(LAYERS["port"].flowprof, name) == getattr(LAYERS["ref"].flowprof, name)
    assert LAYERS["port"].causal.DELAYABLE_PHASES == LAYERS["ref"].causal.DELAYABLE_PHASES


def drive(pkg: str, seed: int) -> dict:
    """A seeded run of flows over one profiler: every hook the engine and
    its callers use, in a random interleaving."""
    L = LAYERS[pkg].flowprof
    rng = random.Random(seed)
    fp, clock = profiler(pkg)
    phases = [p for p in L.PHASES if p != "engine_other"]
    classes = ["app.PayFlow", "app.IssueFlow", "app.NotaryFlow"]
    live: dict = {}
    closed = []
    for i in range(300):
        op = rng.random()
        if op < 0.12 or not live:
            fid = f"f{i}"
            live[fid] = fp.open(fid, rng.choice(classes))
        elif op < 0.45:
            acct = live[rng.choice(sorted(live))]
            with fp.activate(acct):
                outer = rng.choice(phases)
                cause = rng.choice((None, None, "io_wait", "lock_wait"))
                with fp.frame(outer, cause=cause):
                    clock.advance(rng.random() * 0.1)
                    if rng.random() < 0.5:
                        with fp.frame(rng.choice(phases)):
                            clock.advance(rng.random() * 0.1)
                    clock.advance(rng.random() * 0.05)
        elif op < 0.55:
            acct = live[rng.choice(sorted(live))]
            with fp.activate(acct):
                with fp.hint(rng.choice(("notary_rtt", "queue_wait"))):
                    fp.note_park(acct)
                    clock.advance(rng.random() * 0.2)
                    fp.add(acct, "message_transit", rng.random() * 0.05)
                    fp.note_unpark(acct)
        elif op < 0.65:
            fp.add(live[rng.choice(sorted(live))], rng.choice(phases), rng.random() * 0.1)
        elif op < 0.75:
            fp.note_sent(f"m{i}")
            clock.advance(rng.random() * 0.02)
            fp.take_transit(f"m{i}", live[rng.choice(sorted(live))])
        elif op < 0.8:
            fp.note_cause_seconds(rng.choice(phases), rng.choice(("io_wait", "lock_wait")),
                                  rng.random() * 0.1)
        elif op < 0.85:
            fp.note_cause_sample(rng.choice(phases), rng.choice(("on_cpu", "gil_runnable")),
                                 rng.random() * 3)
        else:
            fid = rng.choice(sorted(live))
            del live[fid]
            clock.advance(rng.random() * 0.1)
            closed.append(fp.close(fid))
        clock.advance(rng.random() * 0.01)
    return {"closed": closed, "snapshot": fp.snapshot(), "causes": fp.causes_snapshot(),
            "waterfalls": {f: fp.waterfall_of(f) for f in sorted(live)}}


@pytest.mark.parametrize("seed", range(8))
def test_seeded_ledger_equal(seed):
    ref, port = drive("ref", seed), drive("port", seed)
    assert port == ref
    assert ref["snapshot"]["flows"] > 0
    for agg in ref["snapshot"]["classes"].values():
        assert sum(agg["phases"].values()) == pytest.approx(agg["wall_s"], rel=1e-9) or \
            sum(agg["phases"].values()) > agg["wall_s"]


def _nesting(pkg):
    fp, clock = profiler(pkg)
    acct = fp.open("f1", "test.Flow")
    with fp.activate(acct):
        with fp.frame("checkpoint"):
            clock.advance(1.0)
            with fp.frame("wal_fsync_wait"):
                clock.advance(3.0)
            clock.advance(1.0)
        with fp.frame("serialize"):
            clock.advance(0.5)
            with fp.frame("serialize"):
                clock.advance(2.0)
    with fp.frame("serialize"):
        clock.advance(1.0)
    return [dict(acct.phases), fp.close("f1")]


def _hints(pkg):
    fp, clock = profiler(pkg)
    acct = fp.open("f1", "test.Flow")
    with fp.activate(acct):
        with fp.hint("notary_rtt"):
            fp.note_park(acct)
            clock.advance(5.0)
            fp.add(acct, "message_transit", 2.0)
            fp.note_unpark(acct)
    hint_after = acct.hint
    other = fp.open("f2", "test.Flow")
    fp.note_park(other)
    clock.advance(4.0)
    fp.note_unpark(other)
    return [dict(acct.phases), hint_after, fp.close("f1"), fp.close("f2")]


def _overattribution_and_cap(pkg):
    fp, clock = profiler(pkg)
    acct = fp.open("f1", "test.Flow")
    fp.add(acct, "device_execute", 99.0)
    clock.advance(1.0)
    out = [fp.close("f1")]
    fp.add(acct, "queue_wait", 3.0)
    out.append(dict(acct.phases))
    for i in range(fp.LIVE_CAP + 5):
        fp.open(f"g{i}", "test.Flow")
    out.append((fp.acct_of("g0") is None, fp.acct_of(f"g{fp.LIVE_CAP + 4}") is not None))
    out.append(fp.snapshot())
    return out


def _causes(pkg):
    fp, clock = profiler(pkg)
    acct = fp.open("f1", "test.Flow")
    with fp.activate(acct):
        with fp.frame("wal_fsync_wait", cause="io_wait"):
            clock.advance(0.2)
        with fp.frame("host_verify"):
            clock.advance(0.6)
        with fp.frame("serialize"):
            clock.advance(0.1)
    fp.close("f1")
    fp.note_cause_seconds("host_verify", "lock_wait", 0.2)
    fp.note_cause_sample("host_verify", "on_cpu", 5.0)
    fp.note_cause_seconds("serialize", "io_wait", 10.0)
    return fp.causes_snapshot()


@pytest.mark.parametrize("scenario", [_nesting, _hints, _overattribution_and_cap, _causes])
def test_reference_scenarios_equal(scenario):
    assert scenario("port") == scenario("ref")


def _timed_rlock(pkg):
    """A contended timed SMM lock books its wait as lock_wait, exact."""
    fp = LAYERS[pkg].flowprof.FlowProfiler()
    fp.enable()
    lock = fp.timed_rlock()
    acct = fp.open("f1", "test.Flow")
    lock.acquire()
    trying = threading.Event()

    def waiter():
        with fp.activate(acct):
            trying.set()
            lock.acquire()
            lock.release()

    t = threading.Thread(target=waiter)
    t.start()
    trying.wait(5)
    time.sleep(0.15)
    lock.release()
    t.join(timeout=5)
    # an uncontended acquire books nothing; a Condition over the lock works
    with fp.activate(acct):
        with lock:
            pass
    cond = threading.Condition(fp.timed_rlock())
    with cond:
        cond.notify_all()
        cond.wait(0.01)
    out = fp.close("f1")
    causes = fp.causes_snapshot()["lock_wait"]
    return out, causes


def test_timed_rlock_books_lock_wait_in_both():
    shapes = {}
    for pkg in PKGS:
        out, causes = _timed_rlock(pkg)
        assert out["phases"]["lock_wait"] >= 0.1
        assert causes["lock_wait"] == pytest.approx(out["phases"]["lock_wait"], rel=0.05)
        shapes[pkg] = (sorted(out), sorted(out["phases"]), sorted(causes))
    assert shapes["port"] == shapes["ref"]


def test_noop_hooks_while_off_in_both():
    for pkg in PKGS:
        L = LAYERS[pkg].flowprof
        assert L.active_flowprof() is None
        assert L.flowprof_frame("serialize") is L.flowprof_frame("checkpoint")
        assert L.flowprof_section() == {"enabled": False}


# ------------------------------------------------------------ the sampler

def test_role_mapping_equal():
    names = ["flow-worker-3", "serving-dispatch", "serving-collect", "serving-hedge",
             "serving-x", "wal-writer", "mock-net-pump", "MainThread", "raft-1",
             "notary-flusher", "", "weird name"]
    assert ([LAYERS["port"].sampler._role_of(n) for n in names]
            == [LAYERS["ref"].sampler._role_of(n) for n in names])


def test_overhead_arithmetic_equal():
    out = {}
    for pkg in PKGS:
        clock = FakeClock()
        s = LAYERS[pkg].sampler.StackSampler(hz=100, clock=clock)
        s.reset()
        clock.advance(10.0)
        s._busy_s = 0.2
        first = s.overhead_ratio()
        s.reset()
        out[pkg] = (first, s.overhead_ratio(), s.hz)
    assert out["port"] == out["ref"]
    assert out["ref"][0] == pytest.approx(0.02)


def _sample_foreign(pkg):
    s = LAYERS[pkg].sampler.StackSampler(hz=100)
    stop, parked = threading.Event(), threading.Event()

    def parked_worker():
        parked.set()
        stop.wait(5)

    t = threading.Thread(target=parked_worker, name="flow-worker-9", daemon=True)
    t.start()
    try:
        parked.wait(5)
        time.sleep(0.05)
        recorded = s.sample_once()
        dump = s.dump()
    finally:
        stop.set()
        t.join(timeout=5)
    # other files' flow-worker threads may still be alive: take this one's stack
    folded, count = next((f, c) for f, c in dump["roles"]["flow_worker"]
                         if "parked_worker" in f)
    frames = folded.split(";")
    at = next(i for i, f in enumerate(frames) if f.endswith("parked_worker"))
    return recorded >= 1, sorted(dump), frames[at:], count


def test_sample_of_a_foreign_thread_equal():
    ref, port = _sample_foreign("ref"), _sample_foreign("port")
    assert port == ref
    assert ref[0] and ref[2][0].endswith("parked_worker")


def test_classifier_follows_contention_in_both():
    out = {}
    for pkg in PKGS:
        L = LAYERS[pkg]
        L.contention.configure_contention(enabled=True, patch=False, reset=True)
        on = L.sampler.configure_sampler(enabled=True, reset=True)._classify
        L.sampler.configure_sampler(enabled=False)
        L.contention.configure_contention(enabled=False, reset=True)
        off = L.sampler.configure_sampler(enabled=True, reset=True)._classify
        L.sampler.configure_sampler(enabled=False)
        out[pkg] = (on, off)
    assert out["port"] == out["ref"] == (True, False)


# ----------------------------------------------------------- the causal profiler

class FakeSleep:
    def __init__(self):
        self.calls = []

    def __call__(self, s):
        self.calls.append(s)


def _causal(pkg):
    C = LAYERS[pkg].causal
    sleep = FakeSleep()
    prof = C.CausalProfiler(sleep=sleep)
    out = []
    prof._on_phase("serialize", 0.1)          # outside an experiment: no-op
    with prof.experiment("host_verify", 0.5) as exp:
        for phase, secs in (("serialize", 0.1), ("host_verify", 0.2), ("checkpoint", 0.04),
                            ("queue_wait", 0.3), ("notary_rtt", 0.5), ("serialize", 9.0)):
            prof._on_phase(phase, secs)
        out.append((exp.delays, round(exp.inserted_s, 9)))
    out.append(list(sleep.calls))
    for bad in ((-0.1,), (1.0,), (1.5,)):
        try:
            with prof.experiment("serialize", *bad):
                pass
        except ValueError as e:
            out.append(type(e).__name__)
    return out


def test_causal_dilations_equal():
    assert _causal("port") == _causal("ref")


def _causal_run(pkg):
    C = LAYERS[pkg].causal
    prof = C.CausalProfiler(sleep=FakeSleep())
    calls = iter([10.0, 12.0, 10.5, 11.0, 10.2, 13.0, 9.0])
    result = prof.run(lambda: next(calls), phases=("serialize", "host_verify"),
                      speedups=(0.25, 0.5))
    try:
        prof.run(lambda: 1.0, phases=("nope",))
    except ValueError as e:
        result["error"] = type(e).__name__
    return result


def test_causal_run_equal():
    assert _causal_run("port") == _causal_run("ref")


@pytest.mark.parametrize("seed", range(4))
def test_build_ledger_equal(seed):
    rng = random.Random(seed)
    cells = [{"phase": rng.choice(("serialize", "host_verify", "checkpoint", "queue_wait")),
              "speedup_pct": rng.choice((25.0, 50.0)),
              "predicted_gain_qps": rng.uniform(-2, 5),
              "predicted_gain_pct": rng.uniform(-20, 50),
              "predicted_qps": rng.uniform(1, 20),
              "baseline_qps": 8.0}
             for _ in range(12)]
    ref = LAYERS["ref"].causal.build_ledger([dict(c) for c in cells])
    port = LAYERS["port"].causal.build_ledger([dict(c) for c in cells])
    assert port == ref and ref


def test_causal_section_round_trip_equal():
    out = {}
    for pkg in PKGS:
        C = LAYERS[pkg].causal
        before = C.causal_section()
        rec = C.record_result({"schema": C.CAUSAL_SCHEMA, "baseline_qps": 8.0,
                               "cells": [], "ledger": [{"phase": "serialize",
                                                        "speedup_pct": 50.0,
                                                        "predicted_gain_qps": 1.0,
                                                        "predicted_gain_pct": 12.5}],
                               "source": "test"})
        out[pkg] = (before, C.causal_section(), rec, C.prometheus_lines())
    assert out["port"] == out["ref"]
    assert out["ref"][0] == {"enabled": False}


# ------------------------------------------------------------- flight dump

def test_flight_dump_flowprof_and_sampler_kinds_equal(tmp_path):
    out = {}
    for pkg in PKGS:
        L = LAYERS[pkg]
        fp = L.flowprof.configure_flowprof(enabled=True, reset=True)
        acct = fp.open("f1", "test.Flow")
        with fp.activate(acct):
            with fp.frame("serialize"):
                pass
        fp.close("f1")
        got = L.slo.read_flight_dump(L.slo.flight_dump(str(tmp_path / f"{pkg}.jsonl")))
        wf = got["flowprof"]
        out[pkg] = (wf["enabled"], wf["flows"], sorted(wf["classes"]),
                    sorted(wf["classes"]["test.Flow"]["phases"]), got["sampler"])
    assert out["port"] == out["ref"]
    assert out["ref"][4] == {"enabled": False}
