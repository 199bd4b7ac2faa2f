"""Open-loop SLO-attainment harness.

(Counterpart of corda_tpu/tools/loadharness.py, copied with its import root
changed.)

The closed-loop harness (``loadtest.py``) measures what N injector
threads can push: each thread waits for its command to finish before
issuing the next, so the moment the system slows down the offered load
*politely backs off* — latency quantiles flatten exactly when they
should explode, and the measured "capacity" is really "capacity at the
concurrency the harness happened to pick" (coordinated omission).

This harness is OPEN-LOOP: arrivals are a seeded Poisson process at a
fixed target rate, and the arrival clock NEVER waits for completions.
A flow's latency is measured from its *scheduled arrival time* — if the
system (or the submitting thread) falls behind, the backlog shows up in
p99 instead of silently stretching the inter-arrival gaps. Offered load
the system cannot absorb accumulates as in-flight backlog until the
``max_inflight`` bound, past which arrivals are SHED and counted (the
open-loop analogue of an admission reject — the arrival still happened).

A run is a stepped qps ramp. Each step is scored through a private
``SLOMonitor`` (the SLO attainment machinery, breach-latch only): the
windowed p99 and the error+shed rate are checked against the configured
objective, and the KNEE is the highest step whose SLO held. Per-step
flowprof waterfalls (``configure_flowprof(reset=True)`` between steps)
say where the wall went as the knee approaches — queue wait and lock
wait grow, device execute does not. Results land in ``LOADTEST.json``
(schema checked by ``tools_perf_gate.py --check-schema``). Knobs and
method: docs/LOAD_HARNESS.md. Metric names (``loadharness.*``):
docs/OBSERVABILITY.md §"Critical-path accounting".

The port's nodes run on ``HarnessConfig.device`` (the card unless
``device="cpu"``, as every entry point of the port) and verify signatures
there: ``use_device`` defaults to True, and ``use_device=False`` is the
reference's host route. The reference's CLI (``tools_loadgen.py``) gets its
counterpart with the node tools (ROADMAP.md, Queue 1 step 9).

Toggles compose with the chaos and durability tiers: a ``FaultPlan`` runs
the ramp under injected message loss, and ``durable=True`` puts every node
on WAL-backed checkpoints (fsync wait appears in the waterfall).
``resilience=True``, a self-healing serving scheduler in the reference,
raises ``NotImplementedError`` until the serving resilience layer is ported
(ROADMAP.md, Queue 1 step 6).
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import tempfile
import threading
import time

LOADTEST_SCHEMA = 1


@dataclasses.dataclass
class HarnessConfig:
    """One ramp's knobs (docs/LOAD_HARNESS.md has the full table)."""

    qps_steps: tuple = (4.0, 8.0, 16.0)
    step_duration_s: float = 5.0
    drain_timeout_s: float = 30.0
    seed: int = 2026
    # the SLO each step is scored against
    p99_slo_s: float = 2.0
    max_error_rate: float = 0.05
    min_samples: int = 5
    # open-loop shed bound: arrivals past this in-flight depth are shed
    max_inflight: int = 256
    # workload: "payment" (issue setup + CashPaymentFlow arrivals, full
    # flow→verify→notary path) or "issue" (CashIssueFlow arrivals only,
    # no notary leg — cheaper, for pure engine saturation)
    workload: str = "payment"
    use_device: bool = True         # device-batched signature verify
    device: object = None           # the nodes' device: the card unless "cpu"
    # toggles
    chaos: object | None = None     # a faultinject.FaultPlan, or None
    durable: bool = False           # WAL-backed checkpoints on every node
    resilience: bool = False        # self-healing serving policy
    flowprof: bool = True           # per-step waterfalls
    sampler: bool = False           # attach folded stacks to the result
    netstats: bool = True           # per-step edge retransmit/transit


def _quantile(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1, int(q * len(sorted_vals)))]


class _StepStats:
    """One step's outcome ledger (thread-safe: completions land from
    flow-worker callback threads while the arrival clock runs)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.latencies: list[float] = []
        self.errors = 0
        self.shed = 0
        self.offered = 0

    def complete(self, latency_s: float, error: bool) -> None:
        with self.lock:
            if error:
                self.errors += 1
            else:
                self.latencies.append(latency_s)


class LoadHarness:
    """Builds the mocknet fixture, runs the ramp, scores the steps."""

    def __init__(self, config: HarnessConfig | None = None):
        self.config = config or HarnessConfig()
        self._rng = random.Random(self.config.seed)
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._idle = threading.Condition(self._inflight_lock)

    # ------------------------------------------------------------ fixture
    def _build(self, stack):
        """Create the 3-node mocknet (+ optional durability/resilience/
        chaos tiers) on ``stack`` (an ExitStack owning teardown)."""
        from corda_tpu_torch.testing.mocknet import MockNetworkNodes
        from corda_tpu_torch.verifier import BatchedVerifierService

        cfg = self.config
        if cfg.resilience:
            raise NotImplementedError(
                "resilience=True needs the serving resilience layer, which "
                "comes with ROADMAP.md Queue 1 step 6"
            )
        chaos_injector = None
        if cfg.chaos is not None:
            from corda_tpu_torch.faultinject import FaultInjector
            from corda_tpu_torch.faultinject import clear as clear_injector
            from corda_tpu_torch.faultinject import install as install_injector

            chaos_injector = FaultInjector(cfg.chaos)
            install_injector(chaos_injector)
            stack.callback(clear_injector)
        net = stack.enter_context(MockNetworkNodes(device=cfg.device))
        if chaos_injector is not None:
            # the global install() above feeds the named fault SITES
            # (check_site); transport drop/delay/partition decisions are
            # made by the NETWORK's own injector reference — without this
            # the chaos plan never touches a delivery
            net.net.set_fault_injector(chaos_injector)
            stack.callback(lambda: net.net.set_fault_injector(None))
        checkpoints = None
        if cfg.durable:
            from corda_tpu_torch.durability import DurableStore
            from corda_tpu_torch.flows.checkpoints import WalCheckpointStorage

            base = stack.enter_context(
                tempfile.TemporaryDirectory(prefix="loadharness-")
            )

            def checkpoints(name):
                return WalCheckpointStorage(
                    DurableStore(os.path.join(base, name), name="flows")
                )
        sender = net.create_node(
            "HarnessA",
            checkpoints=None if checkpoints is None else checkpoints("a"),
        )
        receiver = net.create_node(
            "HarnessB",
            checkpoints=None if checkpoints is None else checkpoints("b"),
        )
        notary = net.create_notary_node("HarnessNotary")
        vsvc = BatchedVerifierService(use_device=cfg.use_device, device=cfg.device)
        sender.services.transaction_verifier_service = vsvc
        stack.callback(vsvc.shutdown)
        return net, sender, receiver, notary

    # ------------------------------------------------------------- arrival
    def _start_request(self, sender, receiver, notary, stats: _StepStats,
                       scheduled_t: float) -> None:
        """Submit one arrival (non-blocking) and wire its completion back
        into ``stats``. Latency runs from the SCHEDULED arrival time."""
        from corda_tpu_torch.finance import CashIssueFlow, CashPaymentFlow

        cfg = self.config
        if cfg.workload == "payment":
            flow = CashPaymentFlow(1, "GBP", receiver.party)
        else:
            flow = CashIssueFlow(1, "GBP", b"\x77", notary.party)
        with self._inflight_lock:
            if self._inflight >= cfg.max_inflight:
                stats.shed += 1
                return
            self._inflight += 1
        try:
            handle = sender.smm.start_flow(flow)
        except Exception:
            with self._inflight_lock:
                self._inflight -= 1
                self._idle.notify_all()
            stats.complete(0.0, error=True)
            return

        def done(fut, _t0=scheduled_t):
            latency = time.monotonic() - _t0
            err = fut.exception() is not None
            stats.complete(latency, error=err)
            with self._inflight_lock:
                self._inflight -= 1
                self._idle.notify_all()

        handle.result.add_done_callback(done)

    def _drain(self, deadline_s: float) -> bool:
        with self._inflight_lock:
            return self._idle.wait_for(
                lambda: self._inflight == 0, timeout=deadline_s
            )

    # ---------------------------------------------------------------- run
    def _run_step(self, qps: float, fixture) -> dict:
        """One open-loop step: Poisson arrivals at ``qps`` for
        ``step_duration_s``, drain, score through a private SLOMonitor."""
        from corda_tpu_torch.node.monitoring import node_metrics
        from corda_tpu_torch.observability.slo import SLOMonitor, SLOObjective

        net, sender, receiver, notary = fixture
        cfg = self.config
        stats = _StepStats()
        monitor = SLOMonitor(
            objectives=(SLOObjective(
                name=f"loadharness@{qps:g}qps", priority="harness",
                p99_s=cfg.p99_slo_s, max_error_rate=cfg.max_error_rate,
                window_s=cfg.step_duration_s + cfg.drain_timeout_s + 60.0,
                min_samples=cfg.min_samples,
            ),),
            breach_handler=None,  # latch only: scoring, not paging
        )
        if cfg.flowprof:
            from corda_tpu_torch.observability.flowprof import configure_flowprof

            configure_flowprof(enabled=True, reset=True)
        if cfg.netstats:
            from corda_tpu_torch.messaging.netstats import configure_netstats

            configure_netstats(enabled=True, reset=True)
        # when the telemetry timeline rides along (tools_loadgen.py
        # --timeline), stamp the ramp's step boundaries into the mark
        # deque so a rendered timeline names which qps each ring segment
        # was recorded under
        from corda_tpu_torch.observability.timeseries import active_timeline

        tl = active_timeline()
        if tl is not None:
            tl.mark("loadharness.step_qps", float(qps))
        t_start = time.monotonic()
        next_arrival = t_start
        end = t_start + cfg.step_duration_s
        offered = 0
        while next_arrival < end:
            now = time.monotonic()
            if next_arrival > now:
                time.sleep(next_arrival - now)
            # the arrival HAPPENS at its scheduled instant even when the
            # clock thread woke late — open-loop latency runs from here
            self._start_request(sender, receiver, notary, stats,
                                next_arrival)
            offered += 1
            next_arrival += self._rng.expovariate(qps)
        stats.offered = offered
        drained = self._drain(cfg.drain_timeout_s)
        step_wall = time.monotonic() - t_start
        if not drained:
            # whatever is still in flight timed out the drain: score each
            # as an error with the drain-bounded latency (open-loop: they
            # were offered, so they count)
            with self._inflight_lock:
                stuck = self._inflight
            for _ in range(stuck):
                stats.complete(step_wall, error=True)
        # feed + evaluate the private SLO monitor
        with stats.lock:
            lats = sorted(stats.latencies)
            errors = stats.errors
            shed = stats.shed
        for lat in lats:
            monitor.observe("harness", lat)
        for _ in range(errors):
            monitor.observe("harness", None, error=True)
        for _ in range(shed):
            monitor.observe("harness", None, error=True)
        statuses = monitor.evaluate()
        slo_ok = bool(statuses) and not any(s["breached"] for s in statuses)
        completed = len(lats)
        denom = completed + errors + shed
        step = {
            "qps": qps,
            "offered": offered,
            "completed": completed,
            "errors": errors,
            "shed": shed,
            "shed_rate": (shed / denom) if denom else 0.0,
            "error_rate": ((errors + shed) / denom) if denom else 0.0,
            "p50_s": _quantile(lats, 0.5),
            "p99_s": _quantile(lats, 0.99),
            "drained": drained,
            "wall_s": step_wall,
            "slo_ok": slo_ok,
            "slo": statuses,
        }
        # network-path telemetry (always numeric — the schema gate
        # requires the keys even when the netstats toggle is off)
        retransmits, net_p99 = 0, 0.0
        if cfg.netstats:
            from corda_tpu_torch.messaging.netstats import active_netstats

            nets = active_netstats()
            if nets is not None:
                retransmits = nets.total_retransmits()
                net_p99 = nets.transit_p99_s()
        step["retransmits"] = retransmits
        step["net_transit_p99_s"] = net_p99
        if cfg.flowprof:
            step["waterfall"] = self._waterfall()
        m = node_metrics()
        m.timer("loadharness.step_p99_s").update(step["p99_s"])
        m.counter("loadharness.offered").inc(offered)
        m.counter("loadharness.shed").inc(shed)
        return step

    def _waterfall(self) -> dict:
        """The step's flowprof aggregate for the workload's flow class:
        phase seconds + each phase's share of the class's total wall
        (phases sum to wall by construction — the schema gate checks)."""
        from corda_tpu_torch.observability.flowprof import flowprof_section

        section = flowprof_section()
        classes = section.get("classes", {})
        want = ("CashPaymentFlow" if self.config.workload == "payment"
                else "CashIssueFlow")
        for cls, agg in classes.items():
            if cls.endswith(want):
                return {
                    "flow_class": cls,
                    "flows": agg["flows"],
                    "wall_s": agg["wall_s"],
                    "phases": agg["phases"],
                    "shares": agg["shares"],
                }
        return {"flow_class": want, "flows": 0, "wall_s": 0.0,
                "phases": {}, "shares": {}}

    def run(self) -> dict:
        """The full ramp. Returns the LOADTEST payload (see
        ``write_loadtest`` for the file half)."""
        import contextlib

        from corda_tpu_torch.finance import CashIssueFlow

        cfg = self.config
        sampler_obj = None
        if cfg.sampler:
            from corda_tpu_torch.observability.sampler import configure_sampler

            sampler_obj = configure_sampler(enabled=True, reset=True)
        try:
            with contextlib.ExitStack() as stack:
                fixture = self._build(stack)
                net, sender, receiver, notary = fixture
                # ---- setup (UNMEASURED): pre-issue one 1-GBP state per
                # expected payment so arrivals never contend on selection
                # and never run out of cash mid-step
                if cfg.workload == "payment":
                    expected = sum(
                        int(q * cfg.step_duration_s * 1.5) + 8
                        for q in cfg.qps_steps
                    )
                    for _ in range(expected):
                        sender.run_flow(
                            CashIssueFlow(1, "GBP", b"\x77", notary.party)
                        )
                steps = [self._run_step(q, fixture) for q in cfg.qps_steps]
        finally:
            if cfg.flowprof:
                from corda_tpu_torch.observability.flowprof import (
                    configure_flowprof,
                )

                configure_flowprof(enabled=False, reset=True)
            if cfg.netstats:
                from corda_tpu_torch.messaging.netstats import configure_netstats

                configure_netstats(enabled=False, reset=True)
            if sampler_obj is not None:
                from corda_tpu_torch.observability.sampler import configure_sampler

                configure_sampler(enabled=False)
        knee = None
        for step in steps:
            if step["slo_ok"]:
                knee = step
        if knee is not None:
            from corda_tpu_torch.observability.timeseries import active_timeline

            tl = active_timeline()
            if tl is not None:
                tl.mark("loadharness.knee_qps", float(knee["qps"]))
        result = {
            "schema": LOADTEST_SCHEMA,
            "mode": "open-loop-poisson",
            "config": {
                "qps_steps": list(cfg.qps_steps),
                "step_duration_s": cfg.step_duration_s,
                "seed": cfg.seed,
                "p99_slo_s": cfg.p99_slo_s,
                "max_error_rate": cfg.max_error_rate,
                "max_inflight": cfg.max_inflight,
                "workload": cfg.workload,
                "use_device": cfg.use_device,
                "chaos": cfg.chaos is not None,
                "durable": cfg.durable,
                "resilience": cfg.resilience,
            },
            "steps": steps,
            # the headline (and the perf gate's knob): the highest step
            # that met the SLO. Absent when NO step did — a knee-less
            # artifact is a failed run, and the schema gate says so.
            **({} if knee is None else {"knee_qps": knee["qps"]}),
            "knee": None if knee is None else {
                "qps": knee["qps"],
                "p50_s": knee["p50_s"],
                "p99_s": knee["p99_s"],
                "shed_rate": knee["shed_rate"],
                "waterfall": knee.get("waterfall", {}),
            },
        }
        if sampler_obj is not None:
            result["sampler"] = sampler_obj.dump(top_n=20)
        return result


def run_harness(config: HarnessConfig | None = None) -> dict:
    return LoadHarness(config).run()


def run_causal(base: HarnessConfig, knee_qps: float, *,
               phases=("host_verify", "serialize", "checkpoint"),
               speedups=(0.5,), probe_duration_s: float = 4.0) -> dict:
    """Virtual-speedup experiments at the knee (``tools_loadgen.py
    --causal`` — docs/OBSERVABILITY.md §Causal profiler): each cell is
    a fresh single-step harness run at the knee's arrival rate with the
    causal profiler dilating every delayable non-target phase by
    ``k−1`` of its booked duration.

    The prediction is latency-corrected rather than the synthetic run's
    pure ``k × measured`` rescale. On this workload the inserted sleeps
    ride each flow's own path (they stretch that flow's wall) but
    release the GIL, so a *saturated* probe's goodput barely moves and
    the naked rescale would report ``k×`` for every phase. Instead each
    probe runs arrival-limited at the knee and the cell recovers the
    predicted per-flow service time from flowprof's own accounting:

        L_pred = L_E − (k−1)·ô − x·p̂

    (``L_E`` mean per-flow wall under the experiment, ``ô`` the
    per-flow booked seconds of delayable non-target phases — what the
    experiment dilated — and ``p̂`` the target phase's own per-flow
    booking), then scales the knee by the service-time ratio:
    ``predicted_qps = knee_qps × L₀ / L_pred``. Returns the recorded
    ``causal`` section (``source: "loadharness"`` — no
    planted-bottleneck validation key, that is the synthetic run's
    contract).

    ``probe_duration_s`` trades runtime for ledger stability: each cell
    is one fresh probe, so run-to-run jitter in mean flow wall (notary
    RTT variance, warmup) lands directly in the predicted gain. Probes
    under ~4s on the mocknet carry tens-of-percent noise; raise the
    duration when the ledger must discriminate small phases."""
    from corda_tpu_torch.observability.causal import (
        CAUSAL_SCHEMA,
        DELAYABLE_PHASES,
        CausalProfiler,
        build_ledger,
        record_result,
    )
    from corda_tpu_torch.observability.flowprof import PHASES

    probe_cfg = dataclasses.replace(
        base,
        qps_steps=(float(knee_qps),),
        step_duration_s=probe_duration_s,
        # the ramp already captured sampler/timeline artifacts
        sampler=False,
    )

    def probe_step() -> dict:
        return LoadHarness(probe_cfg).run()["steps"][0]

    def per_flow(step):
        """(mean flow wall, per-flow phase seconds) from the step's
        waterfall; None when the probe completed nothing."""
        wf = step.get("waterfall") or {}
        flows = wf.get("flows") or 0
        if not flows:
            return None
        return (
            wf["wall_s"] / flows,
            {p: v / flows for p, v in wf.get("phases", {}).items()},
        )

    profiler = CausalProfiler()
    cells: list[dict] = []
    with profiler.session():
        base_step = probe_step()
        pf0 = per_flow(base_step)
        if pf0 is None:
            raise RuntimeError(
                "causal baseline probe completed no flows — cannot "
                "measure per-flow service time"
            )
        flow_wall_0, _ = pf0
        wall0 = base_step["wall_s"]
        goodput0 = (base_step["completed"] / wall0) if wall0 > 0 else 0.0
        for phase in phases:
            if phase not in PHASES:
                raise ValueError(f"unknown flowprof phase {phase!r}")
            for x in speedups:
                k = 1.0 / (1.0 - x)
                with profiler.experiment(phase, x) as exp:
                    step = probe_step()
                wall = step["wall_s"]
                cell = {
                    "phase": phase,
                    "speedup_pct": round(x * 100.0, 3),
                    "experiment_qps": (
                        (step["completed"] / wall) if wall > 0 else 0.0
                    ),
                    "inserted_delays": exp.delays,
                    "inserted_s": round(exp.inserted_s, 6),
                    "baseline_qps": float(knee_qps),
                }
                pf = per_flow(step)
                if pf is None:
                    # the dilated probe starved out: no per-flow
                    # accounting to correct against, so no prediction
                    cell["predicted_qps"] = 0.0
                    cell["predicted_gain_qps"] = -float(knee_qps)
                    cell["predicted_gain_pct"] = -100.0
                    cells.append(cell)
                    continue
                flow_wall_e, phase_s = pf
                dilated = sum(
                    v for p, v in phase_s.items()
                    if p in DELAYABLE_PHASES and p != phase
                )
                target_s = phase_s.get(phase, 0.0)
                flow_wall_pred = max(
                    1e-9,
                    flow_wall_e - (k - 1.0) * dilated - x * target_s,
                )
                predicted = float(knee_qps) * flow_wall_0 / flow_wall_pred
                cell["flow_wall_s"] = flow_wall_e
                cell["flow_wall_pred_s"] = flow_wall_pred
                cell["predicted_qps"] = predicted
                cell["predicted_gain_qps"] = predicted - float(knee_qps)
                cell["predicted_gain_pct"] = (
                    100.0 * cell["predicted_gain_qps"] / float(knee_qps)
                    if knee_qps > 0 else 0.0
                )
                cells.append(cell)
    result = {
        "schema": CAUSAL_SCHEMA,
        "baseline_qps": float(knee_qps),
        "probe_goodput_qps": goodput0,
        "probe_flow_wall_s": flow_wall_0,
        "speedups_pct": [round(x * 100.0, 3) for x in speedups],
        "cells": cells,
        "ledger": build_ledger(cells),
        "source": "loadharness",
        "knee_qps": float(knee_qps),
        "probe_duration_s": probe_duration_s,
    }
    return record_result(result)


# ======================================================================
# Overload / metastability certification (docs/OVERLOAD.md)
# ======================================================================

OVERLOAD_SCHEMA = 1


@dataclasses.dataclass
class OverloadConfig:
    """The metastability scenario's knobs: drive the node 2–5x past its
    knee under a partition/crash storm with the overload governor ON,
    and certify (a) a goodput floor DURING the storm and (b) recovery to
    a fraction of baseline within a bounded wall AFTER it — the two
    properties a metastable system fails (goodput collapses and the
    collapse outlives the trigger)."""

    base_qps: float = 8.0           # at/near the knee found by the ramp
    overload_factor: float = 3.0    # storm offered load = factor × base
    baseline_s: float = 4.0         # unmolested goodput reference window
    storm_s: float = 6.0            # overload + chaos window
    recovery_s: float = 30.0        # max wall to recover after the storm
    recovery_window_s: float = 3.0  # goodput measurement granularity
    goodput_floor: float = 0.5      # storm goodput ≥ floor × baseline
    recovery_floor: float = 0.9     # recovered when ≥ floor × baseline
    # per-flow end-to-end deadline: a few multiples of the SLO (the
    # caller's give-up point, not the p99 target) — tight enough to shed
    # genuinely dead work, loose enough that chaos retransmit backoffs
    # alone don't kill every in-flight flow
    deadline_s: float = 6.0
    # governor knobs for the run (configure_overload)
    limit: float = 32.0             # starting AIMD concurrency limit
    slo_p99_s: float = 1.5
    retry_ratio: float = 0.5
    retry_burst: float = 32.0
    seed: int = 2026
    # arrival class mix: (priority, weight) — brownout order certifies
    # BULK sheds first and INTERACTIVE last against exactly this mix
    mix: tuple = (("interactive", 0.2), ("service", 0.5), ("bulk", 0.3))
    max_inflight: int = 1024        # open-loop backstop (NOT the governor)
    # storm composition (the existing fault fabric)
    drop_p: float = 0.08
    delay_p: float = 0.10
    partition_bursts: int = 2       # full partitions of B / the notary
    partition_burst_s: float = 0.8
    workload: str = "payment"
    durable: bool = False
    use_device: bool = True
    device: object = None


class _PhaseStats:
    """One phase's per-class outcome ledger (thread-safe, same contract
    as _StepStats)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.ok = 0
        self.errors = 0
        self.offered: dict[str, int] = {}
        self.rejected: dict[str, int] = {}
        self.latencies: list[float] = []

    def complete(self, latency_s: float, error: bool) -> None:
        with self.lock:
            if error:
                self.errors += 1
            else:
                self.ok += 1
                self.latencies.append(latency_s)


class OverloadScenario:
    """Runs baseline → storm → recovery against the 3-node mocknet and
    scores the metastability certificate (docs/OVERLOAD.md)."""

    def __init__(self, config: OverloadConfig | None = None):
        self.config = config or OverloadConfig()
        self._rng = random.Random(self.config.seed)
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._idle = threading.Condition(self._inflight_lock)

    # ----------------------------------------------------------- arrivals
    def _pick_class(self) -> str:
        r = self._rng.random()
        acc = 0.0
        for cls, w in self.config.mix:
            acc += w
            if r < acc:
                return cls
        return self.config.mix[-1][0]

    def _start(self, sender, receiver, notary, stats: _PhaseStats,
               scheduled_t: float) -> None:
        from corda_tpu_torch.finance import CashIssueFlow, CashPaymentFlow
        from corda_tpu_torch.flows.overload import FlowAdmissionError

        cfg = self.config
        cls = self._pick_class()
        if cfg.workload == "payment":
            flow = CashPaymentFlow(1, "GBP", receiver.party)
        else:
            flow = CashIssueFlow(1, "GBP", b"\x77", notary.party)
        # the governor's brownout keys on this (BULK → SERVICE →
        # INTERACTIVE); the scenario certifies that order holds
        flow.priority = cls
        with stats.lock:
            stats.offered[cls] = stats.offered.get(cls, 0) + 1
        with self._inflight_lock:
            if self._inflight >= cfg.max_inflight:
                stats.complete(0.0, error=True)
                return
            self._inflight += 1
        try:
            handle = sender.smm.start_flow(flow, deadline_s=cfg.deadline_s)
        except FlowAdmissionError:
            # the graceful-degradation path under certification: a cheap
            # fail-fast reject, NOT an error completion — counted per
            # class so the brownout order is checkable
            with stats.lock:
                stats.rejected[cls] = stats.rejected.get(cls, 0) + 1
            with self._inflight_lock:
                self._inflight -= 1
                self._idle.notify_all()
            return
        except Exception:
            with self._inflight_lock:
                self._inflight -= 1
                self._idle.notify_all()
            stats.complete(0.0, error=True)
            return

        def done(fut, _t0=scheduled_t):
            latency = time.monotonic() - _t0
            err = fut.exception() is not None
            stats.complete(latency, error=err)
            with self._inflight_lock:
                self._inflight -= 1
                self._idle.notify_all()

        handle.result.add_done_callback(done)

    def _phase(self, fixture, qps: float, duration_s: float,
               drain_s: float) -> tuple[_PhaseStats, float]:
        """One open-loop arrival window at ``qps``; returns (stats,
        goodput qps = ok completions / the arrival window)."""
        net, sender, receiver, notary = fixture
        stats = _PhaseStats()
        t0 = time.monotonic()
        next_arrival = t0
        end = t0 + duration_s
        while next_arrival < end:
            now = time.monotonic()
            if next_arrival > now:
                time.sleep(next_arrival - now)
            self._start(sender, receiver, notary, stats, next_arrival)
            next_arrival += self._rng.expovariate(qps)
        with self._inflight_lock:
            self._idle.wait_for(
                lambda: self._inflight == 0, timeout=drain_s
            )
        return stats, stats.ok / duration_s

    # -------------------------------------------------------------- storm
    def _storm_plans(self):
        from corda_tpu_torch.faultinject import FaultPlan, Partition

        cfg = self.config
        sever_forever = (0, 1 << 30)
        chaos = FaultPlan(
            seed=cfg.seed, drop_p=cfg.drop_p, delay_p=cfg.delay_p,
            delay_rounds=(1, 3), duplicate_p=0.02,
        )
        # a one-sided Partition severs the node from EVERYONE — the
        # network-visible shape of both a partition and a crashed node,
        # healed by swapping the plain-chaos plan back in
        bursts = [
            FaultPlan(seed=cfg.seed + 1, drop_p=cfg.drop_p, partitions=(
                Partition(*sever_forever, frozenset({"HarnessB"})),
            )),
            FaultPlan(seed=cfg.seed + 2, drop_p=cfg.drop_p, partitions=(
                Partition(*sever_forever, frozenset({"HarnessNotary"})),
            )),
        ]
        return chaos, bursts

    def _arm_plan(self, net, plan) -> None:
        """Swap the active fault plan: the module-global install feeds
        the named fault SITES (check_site), the network-instance
        reference is what actually drops/delays deliveries — both must
        point at the same injector or the storm is a fiction."""
        from corda_tpu_torch.faultinject import FaultInjector, install

        inj = FaultInjector(plan)
        install(inj)
        net.net.set_fault_injector(inj)

    def _storm_thread(self, net, stop: threading.Event) -> threading.Thread:
        """Drives the chaos timeline for the storm window: baseline drop/
        delay chaos throughout, with full partition/crash bursts of the
        receiver and the notary spread across it. Swapping the armed plan
        is the heal mechanism (the netstats partition detector sees the
        silence and raises ``net.partition_suspect``; the heal must then
        NOT burst)."""
        cfg = self.config
        chaos, bursts = self._storm_plans()

        def run():
            self._arm_plan(net, chaos)
            n = max(0, cfg.partition_bursts)
            if n == 0:
                stop.wait(cfg.storm_s)
                return
            gap = cfg.storm_s / (n + 1)
            for i in range(n):
                if stop.wait(max(0.0, gap - cfg.partition_burst_s / 2)):
                    break
                self._arm_plan(net, bursts[i % len(bursts)])
                if stop.wait(cfg.partition_burst_s):
                    break
                self._arm_plan(net, chaos)  # heal
            stop.wait(None)  # hold plain chaos until the storm window ends

        t = threading.Thread(target=run, daemon=True, name="overload-storm")
        t.start()
        return t

    # ---------------------------------------------------------------- run
    def run(self) -> dict:
        import contextlib

        from corda_tpu_torch.faultinject import clear as clear_injector
        from corda_tpu_torch.finance import CashIssueFlow
        from corda_tpu_torch.flows.overload import (
            configure_overload,
            overload_section,
        )
        from corda_tpu_torch.messaging.netstats import (
            active_netstats,
            configure_netstats,
        )

        cfg = self.config
        harness = LoadHarness(HarnessConfig(
            seed=cfg.seed, workload=cfg.workload, durable=cfg.durable,
            use_device=cfg.use_device, device=cfg.device, chaos=None,
        ))
        try:
            with contextlib.ExitStack() as stack:
                stack.callback(clear_injector)
                fixture = harness._build(stack)
                net, sender, receiver, notary = fixture
                stack.callback(lambda: net.net.set_fault_injector(None))
                # ---- setup (UNMEASURED): pre-issue cash for every phase
                if cfg.workload == "payment":
                    expected = int(cfg.base_qps * (
                        cfg.baseline_s
                        + cfg.overload_factor * cfg.storm_s
                        + cfg.recovery_s
                    ) * 1.5) + 16
                    for _ in range(expected):
                        sender.run_flow(
                            CashIssueFlow(1, "GBP", b"\x77", notary.party)
                        )
                # governor + netstats ON for the certified run (netstats
                # feeds the partition-suspect backoff widening)
                configure_netstats(enabled=True, reset=True)
                configure_overload(
                    enabled=True, reset=True, limit=cfg.limit,
                    slo_p99_s=cfg.slo_p99_s, retry_ratio=cfg.retry_ratio,
                    retry_burst=cfg.retry_burst,
                )
                stack.callback(
                    lambda: configure_overload(enabled=False, reset=True)
                )
                stack.callback(
                    lambda: configure_netstats(enabled=False, reset=True)
                )
                # ---- phase 1: baseline goodput at base_qps, no faults
                base_stats, base_goodput = self._phase(
                    fixture, cfg.base_qps, cfg.baseline_s,
                    drain_s=cfg.deadline_s + 3.0,
                )
                # ---- phase 2: storm — offered load at factor × base
                # under drop/delay chaos + partition/crash bursts
                stop = threading.Event()
                storm = self._storm_thread(net, stop)
                storm_stats, storm_goodput = self._phase(
                    fixture, cfg.base_qps * cfg.overload_factor,
                    cfg.storm_s, drain_s=cfg.deadline_s + 3.0,
                )
                stop.set()
                storm.join(timeout=5.0)
                clear_injector()   # full heal
                net.net.set_fault_injector(None)
                # ---- phase 3: recovery — base_qps windows until goodput
                # clears the floor or the wall expires
                t_rec0 = time.monotonic()
                recovery_goodput = 0.0
                recovery_wall_s = cfg.recovery_s
                recovered = False
                rec_stats_all: list[_PhaseStats] = []
                while time.monotonic() - t_rec0 < cfg.recovery_s:
                    rstats, rgood = self._phase(
                        fixture, cfg.base_qps, cfg.recovery_window_s,
                        drain_s=cfg.deadline_s + 2.0,
                    )
                    rec_stats_all.append(rstats)
                    recovery_goodput = rgood
                    if (base_goodput > 0
                            and rgood >= cfg.recovery_floor * base_goodput):
                        recovery_wall_s = time.monotonic() - t_rec0
                        recovered = True
                        break
                ov_snap = overload_section()
                nets = active_netstats()
                retransmits = (
                    nets.total_retransmits() if nets is not None else 0
                )
        finally:
            clear_injector()
        return self._score(
            base_stats, base_goodput, storm_stats, storm_goodput,
            recovery_goodput, recovery_wall_s, recovered,
            ov_snap, retransmits,
        )

    def _score(self, base_stats, base_goodput, storm_stats, storm_goodput,
               recovery_goodput, recovery_wall_s, recovered,
               ov_snap: dict, retransmits: int) -> dict:
        cfg = self.config
        goodput_ratio = (
            storm_goodput / base_goodput if base_goodput > 0 else 0.0
        )
        recovery_ratio = (
            recovery_goodput / base_goodput if base_goodput > 0 else 0.0
        )
        # brownout order: per-class REJECT RATE must be monotone
        # BULK ≥ SERVICE ≥ INTERACTIVE (rates, not counts — the mix is
        # not uniform). Small epsilon: one stray reject in a small
        # window must not flip the verdict.
        with storm_stats.lock:
            offered = dict(storm_stats.offered)
            rejected = dict(storm_stats.rejected)
        rates = {
            cls: (rejected.get(cls, 0) / offered[cls])
            if offered.get(cls) else 0.0
            for cls, _w in cfg.mix
        }
        eps = 0.02
        brownout_order_ok = (
            rates.get("interactive", 0.0) <= rates.get("service", 0.0) + eps
            and rates.get("service", 0.0) <= rates.get("bulk", 0.0) + eps
        )
        # retry-budget reconcile: granted never exceeds earned (the
        # governor's own invariant), and wire-observed retransmits stay
        # within granted + granted headroom — every untracked responder
        # echo (Confirm/Reject re-sent under a ``~`` wire id) is caused
        # 1:1 by a budget-granted initiator retransmit
        granted = int(ov_snap.get("retry_granted", 0))
        denied = int(ov_snap.get("retry_denied", 0))
        earned = float(ov_snap.get("budget_earned", 0.0))
        retry_budget_ok = granted <= earned and retransmits <= 2 * granted + 16
        goodput_floor_ok = goodput_ratio >= cfg.goodput_floor
        recovery_ok = recovered and recovery_ratio >= cfg.recovery_floor
        section = {
            "schema": OVERLOAD_SCHEMA,
            "base_qps": cfg.base_qps,
            "overload_qps": cfg.base_qps * cfg.overload_factor,
            "deadline_s": cfg.deadline_s,
            "baseline_goodput_qps": base_goodput,
            "storm_goodput_qps": storm_goodput,
            "goodput_ratio": goodput_ratio,
            "goodput_floor": cfg.goodput_floor,
            "goodput_floor_ok": int(goodput_floor_ok),
            "recovery_goodput_qps": recovery_goodput,
            "recovery_ratio": recovery_ratio,
            "recovery_floor": cfg.recovery_floor,
            "recovery_wall_s": recovery_wall_s,
            "recovery_wall_limit_s": cfg.recovery_s,
            "recovery_ok": int(recovery_ok),
            "offered_by_class": offered,
            "rejected_by_class": rejected,
            "reject_rate_by_class": rates,
            "brownout_order_ok": int(brownout_order_ok),
            "admission_rejected": sum(rejected.values()),
            "deadline_shed": int(ov_snap.get("deadline_shed", 0)),
            "retransmits": int(retransmits),
            "retry_budget_granted": granted,
            "retry_budget_denied": denied,
            "retry_budget_earned": earned,
            "retry_budget_ok": int(retry_budget_ok),
            "config": {
                "overload_factor": cfg.overload_factor,
                "baseline_s": cfg.baseline_s,
                "storm_s": cfg.storm_s,
                "limit": cfg.limit,
                "slo_p99_s": cfg.slo_p99_s,
                "retry_ratio": cfg.retry_ratio,
                "mix": [list(m) for m in cfg.mix],
                "drop_p": cfg.drop_p,
                "partition_bursts": cfg.partition_bursts,
                "seed": cfg.seed,
                "workload": cfg.workload,
                "durable": cfg.durable,
            },
        }
        return {"overload": section}


def run_overload(config: OverloadConfig | None = None) -> dict:
    """Run the metastability certification; returns ``{"overload": ...}``
    ready to merge into a LOADTEST/bench payload (schema checked by
    ``tools_perf_gate.py --check-schema``)."""
    return OverloadScenario(config).run()


def write_loadtest(result: dict, path: str = "LOADTEST.json") -> str:
    """Atomic write of the LOADTEST payload (tmp+rename, the BASELINE/
    BENCH idiom) — ``tools_perf_gate.py --check-schema`` reads this."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(result, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path
