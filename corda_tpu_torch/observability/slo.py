"""SLO monitor + black-box flight recorder.

(Counterpart of corda_tpu/observability/slo.py, copied with its import root
changed.)

ROADMAP item 5 asks for SLO attainment — p99 latency at fixed qps — as a
first-class signal, not a number a human derives from a bench JSON after
the fact. The quantile stack can already say what p99 *has been
over the process lifetime*; an SLO is a statement about NOW, so this
module evaluates objectives over a SLIDING WINDOW of observations (the
lifetime reservoirs deliberately never forget — a breach that ended an
hour ago would keep a lifetime p99 red all day).

Three pieces:

- ``SLOObjective`` / ``SLOMonitor`` — configurable objectives per
  serving priority class (p99 latency bound and/or max error+shed rate
  over ``window_s``), fed per-request from the scheduler's settle, shed
  and admission-reject paths. ``evaluate()`` is edge-triggered: a
  breach fires the breach handler ONCE (``slo.breach`` counted), and
  recovery clears the latch. Off by default; every feed point pays two
  attribute reads (``active_slo()`` returning None).

- **Flight recorder** — the breach handler's payload, and an operator
  tool in its own right: ``flight_dump()`` writes one JSONL file
  (tmp+rename, atomic) containing the tracer's recent span ring, the
  full ``monitoring_snapshot()``, per-device telemetry + health events
  (``devicemon.py``), current SLO status, and any injected fault
  events — the black box an operator reads AFTER the incident the
  metrics only alarmed on. ``read_flight_dump`` is the parsing half of
  the round-trip the tests pin. RPC-triggerable via
  ``CordaRPCOps.flight_dump()``.

- ``install_crash_dump()`` — opt-in atexit/signal hook: a dying process
  leaves one last flight dump behind. Never installed by default.

Metric names live in docs/OBSERVABILITY.md §"SLO monitor".
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import threading
import time
from collections import deque


@dataclasses.dataclass(frozen=True)
class SLOObjective:
    """One objective: bound the windowed p99 latency and/or the
    error+shed rate for a priority class (``priority=None`` pools every
    class). ``min_samples`` guards cold windows — two requests do not
    make a p99.

    Burn-rate alerting (the multi-window SRE pattern): an alert fires
    only when BOTH the fast window (``burn_fast_s``) and the slow window
    (``burn_slow_s``) are consuming error budget faster than
    ``burn_threshold``× the sustainable rate — the fast window gives the
    alert its reaction time, the slow window keeps a transient blip from
    paging. Budget is ``max_error_rate`` for error objectives and the 1%
    over-target allowance for p99 objectives."""

    name: str
    priority: str | None = None
    p99_s: float | None = None
    max_error_rate: float | None = None
    window_s: float = 60.0
    min_samples: int = 20
    burn_fast_s: float = 5.0
    burn_slow_s: float = 60.0
    burn_threshold: float = 2.0


class SLOMonitor:
    """Sliding-window SLO evaluation (construct directly only in tests;
    production code shares ``slo_monitor()``)."""

    # breach-handler sentinel: "use the flight-recorder default" —
    # distinct from an explicit None (breach latch with no side effects)
    DEFAULT_HANDLER = "__default__"

    def __init__(self, *, objectives=(), clock=time.monotonic,
                 window_cap: int = 4096, breach_handler=DEFAULT_HANDLER,
                 event_ring: int = 256):
        self._enabled = False
        self._clock = clock
        self._lock = threading.Lock()
        self._objectives: tuple[SLOObjective, ...] = tuple(objectives)
        self._window_cap = max(64, window_cap)
        self._samples: dict[str, deque] = {}
        self._breached: dict[str, dict] = {}  # objective name → last status
        self._burning: dict[str, dict] = {}  # objective name → burn status
        self._breach_handler = breach_handler
        self._breach_count = 0
        self._burn_alerts = 0
        self.events: deque = deque(maxlen=max(16, event_ring))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- config
    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def objectives(self) -> tuple[SLOObjective, ...]:
        return self._objectives

    def set_objectives(self, objectives) -> None:
        with self._lock:
            self._objectives = tuple(objectives)

    def set_breach_handler(self, handler) -> None:
        self._breach_handler = handler

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()
            self._breached.clear()
            self._burning.clear()
            self._breach_count = 0
            self._burn_alerts = 0
            self.events.clear()

    # ------------------------------------------------------------ feeding
    def observe(self, priority: str, latency_s: float | None,
                *, error: bool = False) -> None:
        """One request outcome for ``priority``: its end-to-end latency
        (admission→completion) and whether it failed/was shed.
        ``latency_s=None`` records an outcome with NO latency sample —
        admission rejects count toward the error rate but must not feed
        0.0s samples into the p99 pool (a saturated scheduler rejecting
        everything instantly would otherwise read as a perfect p99).
        Bounded per-class deque — the window math prunes by time, the
        cap merely bounds memory under a flood."""
        now = self._clock()
        with self._lock:
            dq = self._samples.get(priority)
            if dq is None:
                dq = self._samples[priority] = deque(
                    maxlen=self._window_cap
                )
            dq.append((
                now,
                None if latency_s is None else float(latency_s),
                bool(error),
            ))

    # --------------------------------------------------------- evaluation
    def _window_locked(self, obj: SLOObjective, now: float) -> list[tuple]:
        horizon = now - obj.window_s
        if obj.priority is None:
            pools = list(self._samples.values())
        else:
            pools = [self._samples.get(obj.priority, ())]
        return [s for dq in pools for s in dq if s[0] >= horizon]

    @staticmethod
    def _p99(latencies: list[float]) -> float:
        if not latencies:
            return 0.0
        ordered = sorted(latencies)
        return ordered[min(len(ordered) - 1, int(0.99 * len(ordered)))]

    def evaluate(self, now: float | None = None) -> list[dict]:
        """Evaluate every objective over its window; edge-triggered
        breach/recovery events fire here. Returns per-objective status
        dicts (the ``slo`` section / RPC payload)."""
        if now is None:
            now = self._clock()
        fired: list[dict] = []
        statuses: list[dict] = []
        with self._lock:
            for obj in self._objectives:
                window = self._window_locked(obj, now)
                n = len(window)
                errors = sum(1 for s in window if s[2])
                lats = [s[1] for s in window if s[1] is not None]
                p99 = self._p99(lats)
                err_rate = errors / n if n else 0.0
                breached_p99 = (
                    obj.p99_s is not None and len(lats) >= obj.min_samples
                    and p99 > obj.p99_s
                )
                breached_err = (
                    obj.max_error_rate is not None
                    and n >= obj.min_samples
                    and err_rate > obj.max_error_rate
                )
                status = {
                    "objective": obj.name,
                    "priority": obj.priority,
                    "window_s": obj.window_s,
                    "samples": n,
                    "errors": errors,
                    "p99_s": round(p99, 6),
                    "error_rate": round(err_rate, 6),
                    "target_p99_s": obj.p99_s,
                    "max_error_rate": obj.max_error_rate,
                    "breached": bool(breached_p99 or breached_err),
                }
                statuses.append(status)
                was = obj.name in self._breached
                if status["breached"] and not was:
                    self._breached[obj.name] = status
                    self._breach_count += 1
                    event = {
                        "t": now, "kind": "slo.breach",
                        "objective": obj.name,
                        "p99_s": status["p99_s"],
                        "error_rate": status["error_rate"],
                    }
                    self.events.append(event)
                    fired.append(status)
                elif not status["breached"] and was:
                    del self._breached[obj.name]
                    self.events.append({
                        "t": now, "kind": "slo.recovered",
                        "objective": obj.name,
                    })
        if fired:
            from corda_tpu_torch.node.monitoring import node_metrics

            node_metrics().counter("slo.breach").inc(len(fired))
            handler = self._breach_handler
            if handler == self.DEFAULT_HANDLER:
                handler = _default_breach_handler
            if handler is not None:
                for status in fired:
                    try:
                        handler(status)
                    except Exception:
                        pass  # a broken handler must not break evaluation
        return statuses

    def _burn_locked(self, obj: SLOObjective, now: float,
                     window_s: float) -> tuple[float, int]:
        """Burn rate over one window: budget consumed / budget allowed.
        Error objectives burn against ``max_error_rate``; p99 objectives
        burn the 1% over-target allowance (a p99 bound tolerates 1% of
        requests above the target — more than 1% slow is burn > 1).
        Returns ``(burn, samples)``."""
        horizon = now - window_s
        if obj.priority is None:
            pools = list(self._samples.values())
        else:
            pools = [self._samples.get(obj.priority, ())]
        window = [s for dq in pools for s in dq if s[0] >= horizon]
        n = len(window)
        if n == 0:
            return 0.0, 0
        burns = []
        if obj.max_error_rate is not None:
            err_rate = sum(1 for s in window if s[2]) / n
            burns.append(err_rate / max(obj.max_error_rate, 1e-9))
        if obj.p99_s is not None:
            lats = [s[1] for s in window if s[1] is not None]
            if lats:
                slow_frac = sum(1 for v in lats if v > obj.p99_s) / len(lats)
                burns.append(slow_frac / 0.01)
        return (max(burns) if burns else 0.0), n

    def evaluate_burn(self, now: float | None = None) -> list[dict]:
        """Multi-window burn-rate evaluation: for each objective, compute
        the budget burn over the fast and slow windows; an alert fires
        (edge-triggered, exactly once per episode — same latch discipline
        as ``evaluate``) when BOTH exceed ``burn_threshold`` with at
        least ``min_samples`` in the fast window. Counted as
        ``slo.burn_alerts``; the default handler writes a flight dump."""
        if now is None:
            now = self._clock()
        fired: list[dict] = []
        statuses: list[dict] = []
        with self._lock:
            for obj in self._objectives:
                fast, n_fast = self._burn_locked(obj, now, obj.burn_fast_s)
                slow, n_slow = self._burn_locked(obj, now, obj.burn_slow_s)
                burning = (
                    n_fast >= obj.min_samples
                    and fast > obj.burn_threshold
                    and slow > obj.burn_threshold
                )
                status = {
                    "objective": obj.name,
                    "priority": obj.priority,
                    "burn_fast": round(fast, 6),
                    "burn_slow": round(slow, 6),
                    "fast_window_s": obj.burn_fast_s,
                    "slow_window_s": obj.burn_slow_s,
                    "threshold": obj.burn_threshold,
                    "samples_fast": n_fast,
                    "samples_slow": n_slow,
                    "burning": burning,
                }
                statuses.append(status)
                was = obj.name in self._burning
                if burning and not was:
                    self._burning[obj.name] = status
                    self._burn_alerts += 1
                    self.events.append({
                        "t": now, "kind": "slo.burn",
                        "objective": obj.name,
                        "burn_fast": status["burn_fast"],
                        "burn_slow": status["burn_slow"],
                    })
                    fired.append(status)
                elif not burning and was:
                    del self._burning[obj.name]
                    self.events.append({
                        "t": now, "kind": "slo.burn_recovered",
                        "objective": obj.name,
                    })
        if fired:
            from corda_tpu_torch.node.monitoring import node_metrics

            node_metrics().counter("slo.burn_alerts").inc(len(fired))
            handler = self._breach_handler
            if handler == self.DEFAULT_HANDLER:
                handler = _default_burn_handler
            if handler is not None:
                for status in fired:
                    try:
                        handler(status)
                    except Exception:
                        pass  # a broken handler must not break evaluation
        return statuses

    def snapshot(self) -> dict:
        statuses = self.evaluate()
        burn = self.evaluate_burn()
        with self._lock:
            return {
                "enabled": self._enabled,
                "objectives": statuses,
                "breaches": self._breach_count,
                "burn": burn,
                "burn_alerts": self._burn_alerts,
                "events": list(self.events),
            }

    # --------------------------------------------------------- exposition
    def prometheus_lines(self) -> list[str]:
        """``slo.*`` families with objective/priority labels — appended
        to ``metrics_text()`` while the monitor is on."""
        from corda_tpu_torch.observability.exposition import escape_label_value

        snap = self.snapshot()
        lines: list[str] = []

        def labels_of(st: dict) -> str:
            return (
                f'objective="{escape_label_value(st["objective"])}",'
                f'priority="{escape_label_value(st["priority"] or "all")}"'
            )

        gauges = (
            ("slo_p99_seconds", "p99_s"),
            ("slo_error_rate", "error_rate"),
            ("slo_window_samples", "samples"),
        )
        for fam, key in gauges:
            lines.append(f"# TYPE cordatpu_{fam} gauge")
            for st in snap["objectives"]:
                lines.append(f"cordatpu_{fam}{{{labels_of(st)}}} {st[key]}")
        lines.append("# TYPE cordatpu_slo_breached gauge")
        for st in snap["objectives"]:
            flag = 1 if st["breached"] else 0
            lines.append(f"cordatpu_slo_breached{{{labels_of(st)}}} {flag}")
        lines.append("# TYPE cordatpu_slo_breaches counter")
        lines.append(f"cordatpu_slo_breaches_total {snap['breaches']}")
        burn_gauges = (
            ("slo_burn_rate_fast", "burn_fast"),
            ("slo_burn_rate_slow", "burn_slow"),
        )
        for fam, key in burn_gauges:
            lines.append(f"# TYPE cordatpu_{fam} gauge")
            for st in snap["burn"]:
                lines.append(f"cordatpu_{fam}{{{labels_of(st)}}} {st[key]}")
        lines.append("# TYPE cordatpu_slo_burning gauge")
        for st in snap["burn"]:
            flag = 1 if st["burning"] else 0
            lines.append(f"cordatpu_slo_burning{{{labels_of(st)}}} {flag}")
        lines.append("# TYPE cordatpu_slo_burn_alerts counter")
        lines.append(f"cordatpu_slo_burn_alerts_total {snap['burn_alerts']}")
        return lines

    # ----------------------------------------------------------- lifecycle
    def start(self, interval_s: float = 1.0) -> None:
        """Opt-in background evaluation loop (daemon thread) — never
        started by default; ``configure_slo(monitor_interval_s=…)``."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        interval = max(0.05, float(interval_s))

        def loop():
            while not self._stop.wait(interval):
                try:
                    self.evaluate()
                    self.evaluate_burn()
                except Exception:
                    pass  # evaluation must never kill its own thread

        self._thread = threading.Thread(
            target=loop, name="slo-monitor", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None


# ------------------------------------------------- process-global instance

_global = SLOMonitor()


def slo_monitor() -> SLOMonitor:
    return _global


def active_slo() -> SLOMonitor | None:
    """The hot-path check every feed point performs: the process monitor
    when SLO tracking is ON, else None. Two attribute reads."""
    m = _global
    return m if m._enabled else None


def configure_slo(*, enabled: bool | None = None, objectives=None,
                  reset: bool = False, breach_handler="__unset__",
                  monitor_interval_s: float | None = None) -> SLOMonitor:
    """The SLO knob (docs/OBSERVABILITY.md §SLO monitor): set the
    objective list, flip tracking on/off, and optionally start the
    background evaluation thread. The default breach handler writes a
    flight-recorder dump; pass ``breach_handler=None`` explicitly for a
    breach latch with no side effects, or a callable for custom paging."""
    if reset:
        _global.reset()
    if objectives is not None:
        _global.set_objectives(objectives)
    if breach_handler != "__unset__":
        _global.set_breach_handler(breach_handler)
    if enabled is not None:
        if enabled:
            _global.enable()
        else:
            _global.disable()
    if monitor_interval_s is not None:
        _global.start(monitor_interval_s)
    elif enabled is False:
        _global.stop()
    return _global


def slo_section() -> dict:
    """The ``slo`` section of ``monitoring_snapshot()``: evaluated
    objective statuses while on, a bare disabled marker while off."""
    m = _global
    if not m._enabled:
        return {"enabled": False}
    return m.snapshot()


def _default_breach_handler(status: dict) -> None:
    flight_dump(reason=f"slo-breach:{status['objective']}")


def _default_burn_handler(status: dict) -> None:
    flight_dump(reason=f"slo-burn:{status['objective']}")


# ----------------------------------------------------------- flight recorder

FLIGHT_SCHEMA = 1
_flight_lock = threading.Lock()
last_flight_path: str | None = None


def _default_flight_path() -> str:
    base = os.environ.get("CORDA_TPU_FLIGHT_DIR", "") or tempfile.gettempdir()
    return os.path.join(
        base, f"corda_tpu_flight_{os.getpid()}_{int(time.time() * 1e3)}.jsonl"
    )


def flight_dump(path: str | None = None, *, reason: str = "manual",
                span_limit: int = 512) -> str:
    """Write the black-box flight record: recent spans, metric snapshot,
    per-device state + health events, SLO status, and injected fault
    events, one JSON object per line (``kind`` discriminates). The file
    lands atomically (tmp+rename); returns the path written. Counted as
    ``slo.flight_dumps``. Every section the reference writes is written,
    ``resilience`` (the serving policy's breaker and quarantine state)
    included."""
    from corda_tpu_torch.node.monitoring import monitoring_snapshot, node_metrics
    from corda_tpu_torch.observability.devicemon import devicemon, devices_section
    from corda_tpu_torch.observability.trace import tracer

    if path is None:
        path = _default_flight_path()
    lines: list[dict] = [{
        "kind": "header", "schema": FLIGHT_SCHEMA, "reason": reason,
        "t": time.time(), "pid": os.getpid(),
    }]
    for span in tracer().dump(limit=span_limit):
        lines.append({"kind": "span", "span": span})
    lines.append({"kind": "metrics", "snapshot": monitoring_snapshot()})
    lines.append({"kind": "devices", "snapshot": devices_section()})
    lines.append({"kind": "slo", "snapshot": slo_section()})
    try:
        # telemetry timeline (observability/timeseries): the last
        # ring_points sampling intervals per series — the section that
        # answers "what happened in the minute BEFORE the breach", which
        # every other kind can only answer for the instant of the dump.
        # {"enabled": false} while off.
        from corda_tpu_torch.observability.timeseries import timeline_section

        lines.append({"kind": "timeline", "snapshot": timeline_section()})
    except Exception:
        pass  # the dump must land even if the timeline is broken
    try:
        # breaker/quarantine status (serving/resilience.py): the state a
        # device-eviction dump exists to explain — {"enabled": false}
        # when no policy is live
        from corda_tpu_torch.serving.resilience import resilience_section

        lines.append({
            "kind": "resilience", "snapshot": resilience_section(),
        })
    except Exception:
        pass  # the dump must land even if the serving layer is broken
    try:
        # durability tier status (corda_tpu/durability): WAL/replay/
        # recovery registries — {"enabled": false} while off
        from corda_tpu_torch.durability import durability_section

        lines.append({
            "kind": "durability", "snapshot": durability_section(),
        })
    except Exception:
        pass
    try:
        # critical-path waterfall (observability/flowprof): where flow
        # wall went, per phase and flow class — the first thing a
        # latency-breach dump gets read for. {"enabled": false} when off.
        from corda_tpu_torch.observability.flowprof import flowprof_section

        lines.append({
            "kind": "flowprof", "snapshot": flowprof_section(),
        })
    except Exception:
        pass
    try:
        # sampling profiler (observability/sampler): top-N folded stacks
        # per thread role, the "what code was running" companion to the
        # waterfall — {"enabled": false} unless the sampler is on.
        from corda_tpu_torch.observability.sampler import active_sampler

        s = active_sampler()
        lines.append({
            "kind": "sampler",
            "snapshot": s.dump(top_n=20) if s is not None
            else {"enabled": False},
        })
    except Exception:
        pass
    try:
        # network-path telemetry (messaging/netstats): per-edge delivery/
        # transit/retransmit ledgers and partition-suspect state — the
        # section a "why did this hop stall" dump gets read for.
        # {"enabled": false} while off.
        from corda_tpu_torch.messaging.netstats import netstats_section

        lines.append({"kind": "net", "snapshot": netstats_section()})
    except Exception:
        pass
    try:
        # lock-contention observatory (observability/contention): the
        # top-contended table and holder→waiter edges at breach time —
        # the convoy evidence. {"enabled": false} while off.
        from corda_tpu_torch.observability.contention import contention_section

        lines.append({
            "kind": "contention", "snapshot": contention_section(),
        })
    except Exception:
        pass
    try:
        # causal profiler (observability/causal): the last speedup
        # ledger, so a breach dump carries the current best guess at
        # what fixing each phase is worth. {"enabled": false} until run.
        from corda_tpu_torch.observability.causal import causal_section

        lines.append({"kind": "causal", "snapshot": causal_section()})
    except Exception:
        pass
    for event in list(devicemon().events) + list(_global.events):
        lines.append({"kind": "event", "event": event})
    try:
        from corda_tpu_torch.faultinject import active as _active_injector

        inj = _active_injector()
    except Exception:
        inj = None
    if inj is not None:
        for e in list(inj.trace)[-256:]:
            lines.append({"kind": "fault", "event": dataclasses.asdict(e)})
    body = "".join(
        json.dumps(line, default=str) + "\n" for line in lines
    )
    tmp = path + ".tmp"
    with _flight_lock:
        with open(tmp, "w") as f:
            f.write(body)
        os.replace(tmp, path)
        global last_flight_path
        last_flight_path = path
        _reclaim_flight_dir(path)
    node_metrics().counter("slo.flight_dumps").inc()
    return path


def _reclaim_flight_dir(path: str) -> None:
    """Keep-N retention for the dump directory: a flapping SLO or a
    quarantine storm fires the breach handler once per episode, but
    episodes can recur all night — without a cap the flight recorder
    becomes a disk-filler. Oldest-first (mtime) reclaim of files matching
    the standard ``corda_tpu_flight_*.jsonl`` naming ONLY — explicitly
    named dumps are operator artifacts and never touched.
    ``CORDA_TPU_FLIGHT_KEEP`` (default 16); ``0`` disables reclaim
    entirely (the unbounded escape hatch). Counted as
    ``slo.flight_dumps_reclaimed``. Caller holds ``_flight_lock``."""
    raw = os.environ.get("CORDA_TPU_FLIGHT_KEEP", "16")
    try:
        keep = int(raw)
    except ValueError:
        keep = 16
    if keep <= 0:
        return
    d = os.path.dirname(os.path.abspath(path))
    try:
        names = [
            n for n in os.listdir(d)
            if n.startswith("corda_tpu_flight_") and n.endswith(".jsonl")
        ]
    except OSError:
        return
    if len(names) <= keep:
        return
    stamped = []
    for n in names:
        p = os.path.join(d, n)
        try:
            stamped.append((os.path.getmtime(p), p))
        except OSError:
            continue  # raced a concurrent reclaim; skip
    stamped.sort()
    reclaimed = 0
    for _, p in stamped[: max(0, len(stamped) - keep)]:
        try:
            os.remove(p)
            reclaimed += 1
        except OSError:
            pass
    if reclaimed:
        from corda_tpu_torch.node.monitoring import node_metrics

        node_metrics().counter("slo.flight_dumps_reclaimed").inc(reclaimed)


def read_flight_dump(path: str) -> dict:
    """Parse a flight dump back into sections — the round-trip half the
    tests pin: ``spans`` (list of span dicts), ``metrics`` / ``devices``
    / ``slo`` / ``timeline`` / ``resilience`` / ``durability`` /
    ``flowprof`` / ``sampler`` / ``net`` / ``contention`` / ``causal``
    (the snapshots), ``events`` (device + SLO health events),
    ``faults`` (injected chaos events), ``header``.

    Forward-compat: records whose ``kind`` this reader does not know
    (written by a NEWER dumper) round-trip untouched under ``extra``
    instead of being dropped — an old analysis tool must never silently
    eat a section it cannot name."""
    out: dict = {"header": None, "spans": [], "metrics": None,
                 "devices": None, "slo": None, "timeline": None,
                 "resilience": None, "durability": None, "flowprof": None,
                 "sampler": None, "net": None, "contention": None,
                 "causal": None, "events": [], "faults": [],
                 "extra": []}
    with open(path) as f:
        for raw in f:
            raw = raw.strip()
            if not raw:
                continue
            rec = json.loads(raw)
            kind = rec.get("kind")
            if kind == "header":
                out["header"] = rec
            elif kind == "span":
                out["spans"].append(rec["span"])
            elif kind in ("metrics", "devices", "slo", "timeline",
                          "resilience", "durability", "flowprof",
                          "sampler", "net", "contention", "causal"):
                out[kind] = rec["snapshot"]
            elif kind == "event":
                out["events"].append(rec["event"])
            elif kind == "fault":
                out["faults"].append(rec["event"])
            else:
                out["extra"].append(rec)
    return out


# --------------------------------------------------------- crash dumping

_crash_state: dict = {"installed": False, "path": None, "prev": {},
                      "atexit_registered": False}


def _crash_dump(reason: str) -> None:
    if not _crash_state["installed"]:
        return  # uninstalled: the still-registered atexit hook is inert
    try:
        flight_dump(_crash_state.get("path"), reason=reason)
    except Exception:
        pass  # a failing dump must never mask the original crash


def install_crash_dump(path: str | None = None,
                       signals: tuple = ("SIGTERM",)) -> None:
    """OPT-IN last-gasp dump: registers an atexit hook plus handlers for
    ``signals`` that write a flight dump before the previous disposition
    runs. Never installed by default — a normal exit should not leave
    dump files behind unless the operator asked for them."""
    import atexit
    import signal as _signal

    if _crash_state["installed"]:
        _crash_state["path"] = path
        return
    _crash_state["installed"] = True
    _crash_state["path"] = path
    if not _crash_state["atexit_registered"]:
        # registered once EVER: an install→uninstall→install cycle must
        # not stack duplicate hooks (each would write its own dump)
        _crash_state["atexit_registered"] = True
        atexit.register(lambda: _crash_dump("atexit"))
    for name in signals:
        signum = getattr(_signal, name, None)
        if signum is None:
            continue

        def handler(num, frame, _name=name):
            _crash_dump(f"signal:{_name}")
            prev = _crash_state["prev"].get(_name)
            if callable(prev):
                prev(num, frame)
            else:
                _signal.signal(num, _signal.SIG_DFL)
                os.kill(os.getpid(), num)

        try:
            _crash_state["prev"][name] = _signal.signal(signum, handler)
        except (ValueError, OSError):
            pass  # non-main thread / unsupported platform


def uninstall_crash_dump() -> None:
    """Restore previous signal dispositions (tests); the atexit hook
    stays registered but goes inert (``_crash_dump`` checks the
    installed flag)."""
    import signal as _signal

    for name, prev in _crash_state["prev"].items():
        signum = getattr(_signal, name, None)
        if signum is not None and prev is not None:
            try:
                _signal.signal(signum, prev)
            except (ValueError, OSError):
                pass
    _crash_state["prev"] = {}
    _crash_state["installed"] = False
