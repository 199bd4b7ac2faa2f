"""Ring-buffer telemetry timeline.

(Counterpart of corda_tpu/observability/timeseries.py, copied with its import root
changed.)

Every observability surface before this one is point-in-time: a
``monitoring_snapshot()`` is an instant, Timer reservoirs are lifetime,
and a flight dump captures the moment of a breach but not the sixty
seconds that caused it. This module adds the time axis: a process-global
recorder that, at a fixed cadence, samples a configurable allowlist of
registry metrics plus per-ordinal devicemon state and SLO window status
into fixed-width float rings — so rates-over-time exist without a
Prometheus server anywhere near the process.

Per-series semantics:

- **counter deltas** — for each allowlisted counter/meter, the tick
  records ``count - previous count`` (primed to 0 on first sight), so
  each point is "events in this interval", a rate the operator can read
  straight off a sparkline.
- **timer window quantiles** — each allowlisted timer gets a tap
  (``Timer.set_tap``) feeding a bounded intake deque; every tick drains
  it and records the interval's p50/p99 and sample count as three
  series. Zeros on an idle interval mean "no samples", matching the
  exposition layer's empty-reservoir honesty rule.
- **gauges** — per-ordinal devicemon inflight / execute EWMA and
  per-objective SLO p99 / error-rate / burn-rates, sampled when those
  monitors are active.

Memory is bounded by construction: every series is a preallocated
``ring_points``-slot ring (default 512 — at the 1 s default cadence,
8.5 minutes of history), plus one shared timestamp ring and a bounded
mark deque. Off by default (``CORDA_TPU_TIMELINE=1`` /
``configure_timeline``): when off there is NO sampler thread, NO rings,
and NO ``timeline.*`` registry metrics — the monitors' zero-overhead
convention, subprocess-pinned by the tests.

Metric names live in docs/OBSERVABILITY.md §"Telemetry timeline".
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

TIMELINE_SCHEMA = 1

# Default allowlists: the serving plane's request/row/batch flow
# (counters+meters — anything exposing a monotone .count) and its two
# latency timers, plus the contention observatory's acquire counters and
# blocked-wait timer (zero-cost while contention is off: the tick skips
# counters absent from the snapshot, and the timer tap only fires if the
# contention monitor ever updates it).
# configure_timeline(counters=…, timers=…) replaces them.
DEFAULT_COUNTERS = (
    "serving.requests",
    "serving.rows",
    "serving.batches",
    "serving.shed",
    "serving.rejected",
    "contention.acquires",
    "contention.contended",
)
DEFAULT_TIMERS = (
    "serving.wait_s",
    "serving.batch_latency_s",
    "contention.wait_s",
)

# Per-timer intake bound between ticks: at 512 points a flooded timer
# costs ~4KiB; the drain keeps only the interval's quantiles.
_TAP_CAP = 4096


class _Ring:
    """Fixed-width float ring: preallocated, O(1) append, oldest-first
    ``values()``. The preallocation is the memory bound the module
    promises — a series can never grow past ``size`` floats."""

    __slots__ = ("_buf", "_size", "_head", "_count")

    def __init__(self, size: int):
        self._size = max(2, int(size))
        self._buf = [0.0] * self._size
        self._head = 0
        self._count = 0

    def append(self, value: float) -> None:
        self._buf[self._head] = value
        self._head = (self._head + 1) % self._size
        if self._count < self._size:
            self._count += 1

    def __len__(self) -> int:
        return self._count

    def values(self) -> list[float]:
        if self._count < self._size:
            return self._buf[: self._count]
        h = self._head
        return self._buf[h:] + self._buf[:h]


def _p(ordered: list[float], q: float) -> float:
    """Nearest-rank quantile over an already-sorted list."""
    if not ordered:
        return 0.0
    return ordered[min(len(ordered) - 1, int(q * len(ordered)))]


class TimelineRecorder:
    """The process timeline (construct directly only in tests; production
    code shares ``timeline()`` via ``configure_timeline``)."""

    def __init__(self, *, cadence_s: float = 1.0, ring_points: int = 512,
                 counters=DEFAULT_COUNTERS, timers=DEFAULT_TIMERS,
                 clock=time.monotonic, wall=time.time,
                 mark_ring: int = 256):
        self._enabled = False
        self._cadence_s = max(0.05, float(cadence_s))
        self._ring_points = max(2, int(ring_points))
        self._counters = tuple(counters)
        self._timers = tuple(timers)
        self._clock = clock
        self._wall = wall
        self._lock = threading.Lock()
        # all ring/tap state is allocated lazily at enable — a disabled
        # recorder holds nothing but this handful of attributes
        self._rings: dict[str, _Ring] = {}
        self._kinds: dict[str, str] = {}
        self._timestamps: _Ring | None = None
        self._prev: dict[str, float] = {}
        self._intake: dict[str, deque] = {}
        self._marks: deque = deque(maxlen=max(16, int(mark_ring)))
        self._ticks = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- config
    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def cadence_s(self) -> float:
        return self._cadence_s

    @property
    def ring_points(self) -> int:
        return self._ring_points

    def enable(self) -> None:
        """Turn sampling on: install timer taps and register the
        ``timeline.*`` registry metrics. Does NOT start the thread —
        ``start()`` / ``configure_timeline(thread=True)`` does."""
        from corda_tpu_torch.node.monitoring import node_metrics

        if self._enabled:
            return
        with self._lock:
            if self._timestamps is None:
                self._timestamps = _Ring(self._ring_points)
            for name in self._timers:
                dq = self._intake.setdefault(name, deque(maxlen=_TAP_CAP))
                node_metrics().timer(name).set_tap(dq.append)
        m = node_metrics()
        m.counter("timeline.ticks")
        m.counter("timeline.marks")
        m.gauge("timeline.series", lambda: len(self._rings))
        self._enabled = True

    def disable(self) -> None:
        from corda_tpu_torch.node.monitoring import node_metrics

        self._enabled = False
        self.stop()
        with self._lock:
            for name in self._timers:
                node_metrics().timer(name).set_tap(None)

    def reset(self) -> None:
        with self._lock:
            self._rings.clear()
            self._kinds.clear()
            self._timestamps = (
                _Ring(self._ring_points) if self._enabled else None
            )
            self._prev.clear()
            for dq in self._intake.values():
                dq.clear()
            self._marks.clear()
            self._ticks = 0

    # ----------------------------------------------------------- sampling
    def _ring_locked(self, name: str, kind: str) -> _Ring:
        r = self._rings.get(name)
        if r is None:
            r = self._rings[name] = _Ring(self._ring_points)
            self._kinds[name] = kind
        return r

    def tick(self, now: float | None = None) -> None:
        """One sampling step — called by the background thread at the
        cadence, or manually (bench smoke / tests drive it with
        ``thread=False``). Never raises: a broken monitor section skips
        its series, the rest of the tick still lands."""
        from corda_tpu_torch.node.monitoring import node_metrics

        if not self._enabled:
            return
        if now is None:
            now = self._wall()
        # Sample every external monitor BEFORE taking our lock: an SLO
        # evaluation here can fire a breach handler that writes a flight
        # dump, whose monitoring_snapshot() reads timeline_section() —
        # which needs this same (non-reentrant) lock.
        snap = node_metrics().snapshot()
        gauges = self._sample_devices() + self._sample_slo()
        with self._lock:
            if self._timestamps is None:
                self._timestamps = _Ring(self._ring_points)
            self._timestamps.append(float(now))
            self._ticks += 1
            # counters/meters → per-interval deltas
            for name in self._counters:
                s = snap.get(name)
                if not isinstance(s, dict) or "count" not in s:
                    continue
                count = float(s["count"])
                prev = self._prev.get(name)
                self._prev[name] = count
                delta = 0.0 if prev is None else max(0.0, count - prev)
                self._ring_locked(name, "counter_delta").append(delta)
            # timers → windowed quantiles over the interval's tap intake
            for name in self._timers:
                dq = self._intake.get(name)
                if dq is None:
                    continue
                n = len(dq)
                samples = sorted(dq.popleft() for _ in range(n))
                self._ring_locked(name + ".p50_s",
                                  "timer_quantile").append(_p(samples, 0.5))
                self._ring_locked(name + ".p99_s",
                                  "timer_quantile").append(_p(samples, 0.99))
                self._ring_locked(name + ".count",
                                  "timer_quantile").append(float(n))
            for name, value in gauges:
                self._ring_locked(name, "gauge").append(value)
        node_metrics().counter("timeline.ticks").inc()

    def _sample_devices(self) -> list[tuple]:
        try:
            from corda_tpu_torch.observability.devicemon import active_devicemon

            dm = active_devicemon()
            if dm is None:
                return []
            out = []
            for ordinal, d in dm.snapshot().get("devices", {}).items():
                base = f"device.{ordinal}."
                out.append((base + "inflight",
                            float(d.get("inflight", 0))))
                out.append((base + "execute_ewma_s",
                            float(d.get("execute_ewma_s", 0.0))))
            return out
        except Exception:
            return []  # a broken devicemon must not kill the tick

    def _sample_slo(self) -> list[tuple]:
        try:
            from corda_tpu_torch.observability.slo import active_slo

            m = active_slo()
            if m is None:
                return []
            out = []
            for st in m.evaluate():
                base = f"slo.{st['objective']}."
                out.append((base + "p99_s", float(st["p99_s"])))
                out.append((base + "error_rate",
                            float(st["error_rate"])))
            for st in m.evaluate_burn():
                base = f"slo.{st['objective']}."
                out.append((base + "burn_fast", float(st["burn_fast"])))
                out.append((base + "burn_slow", float(st["burn_slow"])))
            return out
        except Exception:
            return []  # SLO evaluation errors must not kill the tick

    def mark(self, name: str, value: float, t: float | None = None) -> None:
        """Drop a point event onto the timeline (load-harness step
        boundaries, deploy markers). Rides its own bounded deque, not a
        ring — marks are sparse and alignment-free."""
        from corda_tpu_torch.node.monitoring import node_metrics

        if not self._enabled:
            return
        with self._lock:
            self._marks.append({
                "t": float(self._wall() if t is None else t),
                "name": str(name),
                "value": float(value),
            })
        node_metrics().counter("timeline.marks").inc()

    # ----------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        """The ``timeline`` section / RPC payload: shared timestamps plus
        every series ring oldest-first. A series that appeared after the
        recorder started simply has fewer points than the timestamp ring;
        its points align with the LAST ``len(points)`` timestamps."""
        with self._lock:
            ts = self._timestamps.values() if self._timestamps else []
            return {
                "enabled": self._enabled,
                "schema": TIMELINE_SCHEMA,
                "cadence_s": self._cadence_s,
                "ring_points": self._ring_points,
                "ticks": self._ticks,
                "timestamps": ts,
                "series": {
                    name: {
                        "kind": self._kinds.get(name, "gauge"),
                        "points": ring.values(),
                    }
                    for name, ring in sorted(self._rings.items())
                },
                "marks": list(self._marks),
            }

    # ---------------------------------------------------------- lifecycle
    def start(self) -> None:
        """Start the daemon sampler thread at the configured cadence.
        Idempotent; ``configure_timeline(thread=False)`` skips it for
        manually-ticked harnesses."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self._cadence_s):
                try:
                    self.tick()
                except Exception:
                    pass  # sampling must never kill its own thread

        self._thread = threading.Thread(
            target=loop, name="timeline-sampler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None


# ------------------------------------------------- process-global instance

_global = TimelineRecorder()


def timeline() -> TimelineRecorder:
    return _global


def active_timeline() -> TimelineRecorder | None:
    """The hot-path check every feed point performs: the process recorder
    when the timeline is ON, else None. Two attribute reads."""
    t = _global
    return t if t._enabled else None


def configure_timeline(*, enabled: bool | None = None,
                       cadence_s: float | None = None,
                       ring_points: int | None = None,
                       counters=None, timers=None,
                       thread: bool = True,
                       reset: bool = False) -> TimelineRecorder:
    """The timeline knob (docs/OBSERVABILITY.md §Telemetry timeline):
    set cadence / ring width / allowlists, flip sampling on or off, and
    (by default) run the background sampler thread. ``thread=False``
    enables without a thread — the bench smoke and the tests drive
    ``tick()`` by hand for determinism."""
    global _global

    if reset:
        _global.reset()
    rebuild = any(v is not None for v in (cadence_s, ring_points,
                                          counters, timers))
    if rebuild:
        was_enabled = _global._enabled
        if was_enabled:
            _global.disable()
        _global = TimelineRecorder(
            cadence_s=(cadence_s if cadence_s is not None
                       else _global._cadence_s),
            ring_points=(ring_points if ring_points is not None
                         else _global._ring_points),
            counters=(counters if counters is not None
                      else _global._counters),
            timers=timers if timers is not None else _global._timers,
        )
        if enabled is None:
            enabled = was_enabled
    if enabled is not None:
        if enabled:
            _global.enable()
            if thread:
                _global.start()
        else:
            _global.disable()
    return _global


def timeline_section() -> dict:
    """The ``timeline`` section of ``monitoring_snapshot()``: the ring
    snapshot while on, a bare disabled marker while off."""
    t = _global
    if not t._enabled:
        return {"enabled": False}
    return t.snapshot()


def _env_opt_in() -> None:
    """The CORDA_TPU_TIMELINE=1 import-time opt-in (CADENCE_S / POINTS
    env knobs ride along). Called from the package ``__init__`` AFTER
    every observability submodule has loaded — enabling here would pull
    ``corda_tpu_torch.node`` (and through it the flow engine, which imports
    this package back) into a half-initialised import cycle."""
    if os.environ.get("CORDA_TPU_TIMELINE", "") in ("", "0"):
        return
    configure_timeline(
        enabled=True,
        cadence_s=float(os.environ.get("CORDA_TPU_TIMELINE_CADENCE_S", "1.0")),
        ring_points=int(os.environ.get("CORDA_TPU_TIMELINE_POINTS", "512")),
    )
