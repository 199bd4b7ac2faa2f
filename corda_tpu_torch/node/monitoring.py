"""Metrics registry (counterpart of corda_tpu/node/monitoring.py).

Parity with the reference's Codahale/Dropwizard ``MonitoringService``
(node/.../services/api/MonitoringService.kt:11) and the verification
metrics seam (OutOfProcessTransactionVerifierService.kt:37-48 —
duration timer, success/failure meters, in-flight gauge). Plain-Python,
thread-safe, snapshot-able for the RPC/shell observability surface.
"""

from __future__ import annotations

import math
import random
import threading
import time


class QuantileReservoir:
    """Fixed-size uniform sample (Vitter's algorithm R) feeding the
    p50/p95/p99 fields of Timer/Meter snapshots. 512 slots bounds memory
    per metric while keeping the p99 estimate useful at the batch counts
    the serving scheduler sees; the RNG is private and seeded so snapshot
    quantiles are reproducible for a deterministic driven sequence.

    NOT thread-safe on its own — the owning metric's lock guards it."""

    __slots__ = ("_size", "_values", "_seen", "_rng", "_exemplars")

    def __init__(self, size: int = 512, seed: int = 0x0B5E):
        self._size = size
        self._values: list[float] = []
        self._seen = 0
        self._rng = random.Random(seed)
        self._exemplars: list[str] = []

    def update(self, value: float, exemplar: str = "") -> None:
        self._seen += 1
        if len(self._values) < self._size:
            self._values.append(value)
            self._exemplars.append(exemplar)
        else:
            j = self._rng.randrange(self._seen)
            if j < self._size:
                self._values[j] = value
                self._exemplars[j] = exemplar

    def quantiles(self, qs=(0.5, 0.95, 0.99)) -> list[float]:
        """Nearest-rank quantiles over the current sample (0.0 each when
        empty — snapshots stay numeric for the exposition layer)."""
        if not self._values:
            return [0.0] * len(qs)
        ordered = sorted(self._values)
        n = len(ordered)
        return [ordered[min(n - 1, int(q * n))] for q in qs]

    def quantiles_with_exemplars(self, qs=(0.5, 0.95, 0.99)) -> list[tuple]:
        """Like ``quantiles`` but each entry is ``(value, exemplar)`` —
        the exemplar stamped on the reservoir sample at the quantile rank
        (empty string when that sample carried none). Exemplars ride the
        sample they arrived with through replacement, so a quantile's
        exemplar is always a trace that really took that long."""
        if not self._values:
            return [(0.0, "")] * len(qs)
        order = sorted(range(len(self._values)),
                       key=lambda i: self._values[i])
        n = len(order)
        out = []
        for q in qs:
            i = order[min(n - 1, int(q * n))]
            out.append((self._values[i], self._exemplars[i]))
        return out


class Counter:
    def __init__(self):
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    def dec(self, n: int = 1) -> None:
        self.inc(-n)

    @property
    def count(self) -> int:
        return self._v

    def snapshot(self) -> dict:
        return {"type": "counter", "count": self._v}


class Gauge:
    """A gauge reads a callable at snapshot time (in-flight style)."""

    def __init__(self, fn):
        self._fn = fn

    @property
    def value(self):
        return self._fn()

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self._fn()}


class Meter:
    """Event rate: total count + exponentially-weighted 1-minute rate,
    plus a reservoir over per-mark sizes (``mark(n)`` records ``n``) —
    p50/p95/p99 of e.g. rows-per-request for the ``serving.rows`` meter.

    Burst accounting: marks arriving with ``dt == 0`` (several requests
    inside one clock tick) fold into ``_pending`` and count toward the
    NEXT nonzero-dt rate sample — previously only the final mark's ``n``
    was treated as the interval's events, understating ``m1_rate`` under
    bursts by up to the burst size."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._count = 0
        self._rate = 0.0
        self._last = clock()
        self._pending = 0
        self._reservoir = QuantileReservoir()

    def mark(self, n: int = 1) -> None:
        with self._lock:
            now = self._clock()
            dt = now - self._last
            self._count += n
            self._pending += n
            self._reservoir.update(float(n))
            if dt > 0:
                alpha = 1.0 - math.exp(-dt / 60.0)
                inst = self._pending / dt
                self._rate += alpha * (inst - self._rate)
                self._last = now
                self._pending = 0

    @property
    def count(self) -> int:
        return self._count

    @property
    def one_minute_rate(self) -> float:
        return self._rate

    def snapshot(self) -> dict:
        with self._lock:
            p50, p95, p99 = self._reservoir.quantiles()
            return {
                "type": "meter", "count": self._count, "m1_rate": self._rate,
                "p50": p50, "p95": p95, "p99": p99,
            }


class Timer:
    """Duration histogram (count / mean / min / max / last) with a
    fixed-size reservoir exposing p50/p95/p99 — the tail-attribution
    fields the serving/verifier/notary timers report (a mean hides
    exactly the queueing effects the cross-layer traces exist to find)."""

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._lock = threading.Lock()
        self._count = 0
        self._total = 0.0
        self._min = math.inf
        self._max = 0.0
        self._last = 0.0
        self._reservoir = QuantileReservoir()
        self._tap = None

    class _Ctx:
        def __init__(self, timer):
            self._timer = timer

        def __enter__(self):
            self._t0 = self._timer._clock()
            return self

        def __exit__(self, *exc):
            self._timer.update(self._timer._clock() - self._t0)
            return False

    def time(self) -> "_Ctx":
        return Timer._Ctx(self)

    def update(self, seconds: float, *, exemplar: str | None = None) -> None:
        with self._lock:
            self._count += 1
            self._total += seconds
            self._min = min(self._min, seconds)
            self._max = max(self._max, seconds)
            self._last = seconds
            self._reservoir.update(seconds, exemplar or "")
        # Tap outside the lock: one attribute read when no tap is set
        # (the off-by-default overhead contract), and a tap callback can
        # never deadlock against a concurrent snapshot.
        tap = self._tap
        if tap is not None:
            tap(seconds)

    def set_tap(self, fn) -> None:
        """Install (or clear, with None) a per-update observer. At most
        one tap — the telemetry timeline owns this seam; it receives the
        raw duration on the updating thread and must be cheap."""
        self._tap = fn

    def quantiles_with_exemplars(self, qs=(0.5, 0.95, 0.99)) -> list[tuple]:
        with self._lock:
            return self._reservoir.quantiles_with_exemplars(qs)

    @property
    def count(self) -> int:
        return self._count

    @property
    def mean(self) -> float:
        return self._total / self._count if self._count else 0.0

    def quantiles(self, qs=(0.5, 0.95, 0.99)) -> list[float]:
        with self._lock:
            return self._reservoir.quantiles(qs)

    def snapshot(self) -> dict:
        with self._lock:
            qe = self._reservoir.quantiles_with_exemplars()
            (p50, e50), (p95, e95), (p99, e99) = qe
            out = {
                "type": "timer",
                "count": self._count,
                "mean_s": (
                    self._total / self._count if self._count else 0.0
                ),
                "min_s": 0.0 if math.isinf(self._min) else self._min,
                "max_s": self._max,
                "last_s": self._last,
                "total_s": self._total,
                "p50_s": p50,
                "p95_s": p95,
                "p99_s": p99,
            }
            # Exemplars appear ONLY when at least one sample carried a
            # trace id — an un-stamped timer's snapshot shape is
            # bit-identical to the pre-exemplar era (tests pin it).
            if e50 or e95 or e99:
                out["exemplars"] = {
                    k: v for k, v in
                    (("p50_s", e50), ("p95_s", e95), ("p99_s", e99)) if v
                }
            return out


class MetricRegistry:
    """Named metric store (reference: com.codahale.metrics.MetricRegistry
    held by MonitoringService)."""

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def meter(self, name: str) -> Meter:
        return self._get(name, Meter)

    def timer(self, name: str) -> Timer:
        return self._get(name, Timer)

    def gauge(self, name: str, fn=None) -> Gauge:
        """Register (``fn`` given) or read a gauge. A read before any
        registration returns a TRANSIENT placeholder gauge reading None —
        never a bare KeyError from registry internals — and the read holds
        the lock like every other accessor (an unlocked dict read raced
        concurrent registrations). The placeholder is deliberately NOT
        stored: registering it would poison the name for a later
        ``counter(name)``/``meter(name)``/``timer(name)`` writer, whose
        ``_get`` would hand back the Gauge and crash the writing thread
        (the serving dispatcher, for one) on ``.inc()``."""
        with self._lock:
            if fn is not None:
                self._metrics[name] = Gauge(fn)
            m = self._metrics.get(name)
            if m is None:
                return Gauge(lambda: None)
            if not isinstance(m, Gauge):
                raise TypeError(
                    f"metric {name!r} is a {type(m).__name__}, not a Gauge"
                )
            return m

    def snapshot(self) -> dict:
        with self._lock:
            return {k: v.snapshot() for k, v in sorted(self._metrics.items())}

    def section(self, prefix: str) -> dict:
        """Snapshot of the metrics under one dotted prefix, keys
        relativized (``section("serving.")`` → ``{"batches": ...}``)."""
        snap = self.snapshot()
        return {
            k[len(prefix):]: v for k, v in snap.items()
            if k.startswith(prefix)
        }


# Process-global registry for cross-cutting health events that happen
# below any service object holding its own registry — in the port, the
# overload governor's counters. (The reference also counts its verifier's
# device→host failover here; the port has no failover, so no such
# counter.) Node services with their own MonitoringService keep using
# per-node registries; this one is the operator's "did anything degrade in
# this process" surface.
_process_registry = MetricRegistry()


def node_metrics() -> MetricRegistry:
    return _process_registry


def monitoring_snapshot() -> dict:
    """The process-wide observability snapshot, sectioned for the RPC/shell
    surface: ``serving`` the process registry's ``serving.*`` names (the
    port's scheduler keeps its own counters on the scheduler,
    ``DeviceScheduler.counters``, so this is empty unless a caller records
    there), ``devices`` the per-device telemetry registry
    (observability/devicemon — ``{"enabled": false}`` while off), ``slo``
    the SLO monitor's evaluated objectives (observability/slo, same
    off-marker contract), ``durability`` the crash-consistent persistence
    tier's WAL/replay/recovery registries (``durability/`` —
    ``{"enabled": false}`` until the first ``DurableStore`` exists in the
    process), ``flowprof`` the per-flow critical-path phase accounting
    waterfall (observability/flowprof — ``{"enabled": false}`` while off),
    ``sampler`` the wall-clock stack sampler's folded-stack dump
    (observability/sampler, same off-marker contract), ``net`` the
    per-edge network-path telemetry ledgers (messaging/netstats —
    delivery/transit/retransmit counts and partition-suspect state,
    ``{"enabled": false}`` while off), ``cluster`` the cross-node hop
    recorder's status (observability/cluster, same off-marker contract),
    ``overload`` the overload governor's admission/retry-budget/
    deadline-shed state (flows/overload — ``{"enabled": false}`` while
    off), ``statestore`` the device state store's tables and
    ``statestore.*`` metrics (statestore/ — ``{"enabled": false}`` until
    the first table exists), ``timeline`` the ring-buffer telemetry
    recorder's sampled series (observability/timeseries —
    ``{"enabled": false}`` while off), ``contention`` the lock-contention
    observatory's per-site wait/hold tables and wait edges
    (observability/contention — ``{"enabled": false}`` while off),
    ``causal`` the causal profiler's last speedup ledger
    (observability/causal — ``{"enabled": false}`` until a run), and
    ``process`` the remaining cross-cutting metrics of the process
    registry.

    Two of the reference's sections come with the serving layer they
    report (ROADMAP.md, Queue 1 step 6): ``profiler`` (the kernel
    profiler's registry mirror) and ``resilience`` (the self-healing
    dispatch policy's quarantine/breaker state)."""
    from ..durability import durability_section
    from ..flows.overload import overload_section
    from ..messaging.netstats import netstats_section
    from ..observability.causal import causal_section
    from ..observability.cluster import cluster_section
    from ..observability.contention import contention_section
    from ..observability.devicemon import devices_section
    from ..observability.flowprof import flowprof_section
    from ..observability.sampler import sampler_section
    from ..observability.slo import slo_section
    from ..observability.timeseries import timeline_section
    from ..statestore import statestore_section

    return {
        "serving": _process_registry.section("serving."),
        "devices": devices_section(),
        "slo": slo_section(),
        "durability": durability_section(),
        "flowprof": flowprof_section(),
        "sampler": sampler_section(),
        "net": netstats_section(),
        "cluster": cluster_section(),
        "overload": overload_section(),
        "statestore": statestore_section(),
        "timeline": timeline_section(),
        "contention": contention_section(),
        "causal": causal_section(),
        "process": {
            k: v for k, v in _process_registry.snapshot().items()
            if not (k.startswith("serving.")
                    or k.startswith("durability.")
                    or k.startswith("replay.")
                    or k.startswith("recovery.")
                    or k.startswith("flowprof.")
                    or k.startswith("sampler.")
                    or k.startswith("net.")
                    or k.startswith("cluster.")
                    or k.startswith("overload.")
                    or k.startswith("retry_budget.")
                    or k.startswith("admission.")
                    or k.startswith("statestore.")
                    or k.startswith("timeline.")
                    or k.startswith("contention.")
                    or k.startswith("causal."))
        },
    }
