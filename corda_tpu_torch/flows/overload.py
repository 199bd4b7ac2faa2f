"""Overload governor: deadline propagation, retry budgets, adaptive admission
(counterpart of corda_tpu/flows/overload.py).

A node past its knee fails in a characteristic, *metastable* way: the
flow engine queues unboundedly, every queued flow still burns full
verify/notary work after its caller has given up, and a partition heal
releases a synchronized retransmit storm with no aggregate bound — load
sheds nothing, goodput collapses to zero, and the collapse outlives the
burst that caused it. This module is the floor under that failure mode
(docs/OVERLOAD.md), three mechanisms sharing one governor:

- **end-to-end deadline propagation** — a wall-clock deadline born at
  ``start_flow(deadline_s=...)`` rides the executor, the ``SessionInit``
  wire message (old payloads decode — the field is omitted when unset,
  so the off path adds zero wire bytes), and a thread-local
  ``deadline_scope`` that downstream stages read: the serving scheduler
  derives its queue-shed deadline from it, the notary front door and
  flush window drop already-dead requests, and the Raft/BFT clients
  bound their submit budgets by it. Dead work is shed at the *earliest*
  stage that notices — goodput, not throughput;

- **retry budgets** — a token bucket per (layer, peer edge): fresh
  sends earn ``retry_ratio`` tokens, retries spend one, so aggregate
  retry volume is capped at a fraction of fresh traffic however many
  individual backoff clocks align. Consumes the network telemetry's
  ``net.partition_suspect`` events to pre-emptively widen session
  retransmit backoff on a suspected edge (a healed edge drains instead
  of storming);

- **adaptive admission** — an AIMD concurrency limit on in-flight
  flows keyed to the measured flow p99 vs the configured SLO:
  breaching windows multiply the limit down, healthy windows add to
  it. Rejection is fail-fast (``FlowAdmissionError`` raised before any
  checkpoint write) and brownout-ordered: per-class headroom shares
  mean BULK is shed first, then SERVICE, INTERACTIVE last — mirroring
  the serving scheduler's priority classes. Rejects observe into the
  SLO window as errors with NO latency sample (as scheduler sheds do), so a
  browned-out node never reads as a perfect p99.

Off by default, as every monitor is: every hook calls
``active_overload()`` (two attribute reads when off after a one-time
``CORDA_TPU_OVERLOAD=1`` env probe), ``configure_overload()`` flips it
programmatically, and while disabled the process registry gains no
``overload.*``/``retry_budget.*``/``admission.*`` names, no threads, and
no wire bytes. Fault sites ``overload.admission`` and
``retry.budget_exhausted`` let the chaos fabric force rejections and
budget exhaustion deterministically (docs/FAULT_INJECTION.md).

Left out until their layers are ported (ROADMAP.md, Queue 1 step 4b): the
SLO monitor's observations of rejects and sheds (:242-244, :289-291) and
``sync_net_events`` (:352-376, with ``_last_net_sync`` :173, :196), which
rebuilds the suspected edges from the netstats event ring, so no edge is
suspected yet.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import OrderedDict, deque

# serving-scheduler priority class names, mirrored as literals so this
# module never imports the serving package (the scheduler imports us)
INTERACTIVE = "interactive"
SERVICE = "service"
BULK = "bulk"

# brownout order: the fraction of the admission limit each class may
# fill. BULK hits its ceiling first (sheds first), INTERACTIVE holds the
# full limit (sheds last) — the same reserved-share idea as the serving
# scheduler's _RESERVED, pointed at admission instead of batch assembly.
_DEFAULT_CLASS_SHARES = {INTERACTIVE: 1.0, SERVICE: 0.85, BULK: 0.6}


class FlowAdmissionError(Exception):
    """Adaptive admission rejected the flow at ``start_flow`` — raised
    BEFORE any checkpoint write or span/profile registration, so a
    rejection costs the caller one exception and the node nothing
    durable. Callers shed, degrade, or retry against their own budget."""


# ------------------------------------------------------- deadline scope
#
# The cross-layer carrier for a propagated deadline: an absolute
# wall-clock (epoch) instant, set for the duration of a flow's execution
# segment by the engine and read by any downstream stage on the same
# thread (serving submit, notary request, consensus client submit).
# Wall-clock on purpose — the deadline crosses nodes in SessionInit, and
# monotonic clocks do not travel.

_tls = threading.local()


@contextlib.contextmanager
def deadline_scope(deadline_t: float | None):
    """Bind ``deadline_t`` (epoch seconds, or None) as the calling
    thread's propagated deadline for the duration of the block."""
    prev = getattr(_tls, "deadline_t", None)
    _tls.deadline_t = deadline_t
    try:
        yield
    finally:
        _tls.deadline_t = prev


def current_deadline_t() -> float | None:
    """The propagated absolute deadline bound to this thread, or None."""
    return getattr(_tls, "deadline_t", None)


def remaining_deadline() -> float | None:
    """Seconds until the propagated deadline (may be <= 0 once expired),
    or None when no deadline is in scope. One thread-local read — cheap
    enough for every submit path to call unconditionally."""
    t = getattr(_tls, "deadline_t", None)
    if t is None:
        return None
    return t - time.time()


# ------------------------------------------------------------- governor


class _Bucket:
    """One (layer, edge) retry token bucket. Guarded by the governor's
    lock."""

    __slots__ = ("tokens", "granted", "denied")

    def __init__(self, initial: float):
        self.tokens = initial
        self.granted = 0
        self.denied = 0


class OverloadGovernor:
    """The process-wide overload policy: admission AIMD + retry token
    buckets + partition-suspect state. All hooks are O(1) under one
    lock; the clock is injectable so AIMD windows are testable without
    sleeping."""

    BUCKET_CAP = 1024   # bounded: a hostile peer set cannot grow memory
    LAT_WINDOW = 512    # recent flow latencies feeding the AIMD signal

    def __init__(self, *, clock=time.monotonic):
        self._lock = threading.Lock()
        self._clock = clock
        self._enabled = False
        self._gauges_registered = False
        # ---- adaptive admission (AIMD on in-flight flows)
        self.slo_p99_s = 1.0          # the latency target the limit chases
        self.min_limit = 4.0
        self.max_limit = 4096.0
        self.limit = 64.0             # current concurrency ceiling
        self.increase = 1.0           # additive raise per healthy window
        self.decrease = 0.7           # multiplicative cut per breach
        self.adapt_interval_s = 0.25
        self.adapt_min_samples = 8
        self.class_shares = dict(_DEFAULT_CLASS_SHARES)
        self._inflight = 0
        self._last_adapt = 0.0
        self._lat_window: deque = deque(maxlen=self.LAT_WINDOW)
        self.admitted = 0
        self.rejected = 0
        self.rejected_by_class: dict[str, int] = {}
        self.deadline_shed = 0
        # ---- retry budgets (token bucket per layer+edge)
        self.retry_ratio = 0.5        # tokens earned per fresh send
        self.retry_burst = 32.0       # bucket cap
        self.retry_initial = 2.0      # allowance before any fresh send
        self._buckets: OrderedDict = OrderedDict()
        self.fresh_sends: dict[str, int] = {}   # per layer
        self.retry_granted = 0
        self.retry_denied = 0
        # ---- partition suspicion (netstats consumption)
        self.suspect_backoff_scale = 4.0
        self._suspect_edges: set[str] = set()

    # ------------------------------------------------------------- lifecycle
    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def reset(self) -> None:
        with self._lock:
            self._inflight = 0
            self._lat_window.clear()
            self._last_adapt = 0.0
            self.admitted = 0
            self.rejected = 0
            self.rejected_by_class = {}
            self.deadline_shed = 0
            self._buckets.clear()
            self.fresh_sends = {}
            self.retry_granted = 0
            self.retry_denied = 0
            self._suspect_edges.clear()

    def _ensure_gauges(self) -> None:
        # registered lazily from the first live hook, never while off —
        # the fresh-subprocess pin holds: overload off means NO names
        if self._gauges_registered:
            return
        self._gauges_registered = True
        from ..node.monitoring import node_metrics

        m = node_metrics()
        m.gauge("admission.inflight", lambda: self._inflight)
        m.gauge("overload.limit", lambda: self.limit)

    # ------------------------------------------------------------- admission
    def try_admit(self, priority: str = SERVICE) -> bool:
        """Admission decision for one flow start. Counts both verdicts;
        a rejection observes into the SLO window as an error with no
        latency sample (as the scheduler's sheds, extended to admission)."""
        self._ensure_gauges()
        forced = False
        from ..faultinject import InjectedFault, check_site

        try:
            check_site("overload.admission")
        except InjectedFault:
            forced = True  # the plan forces this admission to reject
        with self._lock:
            share = self.class_shares.get(
                priority, self.class_shares.get(SERVICE, 0.85)
            )
            if forced or self._inflight >= self.limit * share:
                self.rejected += 1
                self.rejected_by_class[priority] = (
                    self.rejected_by_class.get(priority, 0) + 1
                )
                admitted = False
            else:
                self._inflight += 1
                self.admitted += 1
                admitted = True
        c = _ov_counters()
        if admitted:
            c["admitted"].inc()
            return True
        c["rejected"].inc()
        return False

    def release(self, priority: str, latency_s: float | None,
                *, error: bool = False) -> None:
        """One admitted flow finished (either way): free its slot, feed
        the AIMD latency window, adapt the limit on interval."""
        now = self._clock()
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            if latency_s is not None and not error:
                self._lat_window.append((now, latency_s))
            self._adapt_locked(now)

    def _adapt_locked(self, now: float) -> None:
        if now - self._last_adapt < self.adapt_interval_s:
            return
        self._last_adapt = now
        horizon = now - max(1.0, 8 * self.adapt_interval_s)
        lats = sorted(lat for t, lat in self._lat_window if t >= horizon)
        if len(lats) < self.adapt_min_samples:
            return
        p99 = lats[min(len(lats) - 1, int(0.99 * len(lats)))]
        if p99 > self.slo_p99_s:
            self.limit = max(self.min_limit, self.limit * self.decrease)
        else:
            self.limit = min(self.max_limit, self.limit + self.increase)

    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    # -------------------------------------------------------- deadline sheds
    def note_deadline_shed(self, priority: str = SERVICE,
                           latency_s: float | None = None) -> None:
        """Downstream stage dropped already-dead work. Observes into the
        SLO window as an error (with the elapsed wall when the caller
        knows it) so propagated-deadline sheds never hide from p99."""
        with self._lock:
            self.deadline_shed += 1
        _ov_counters()["deadline_shed"].inc()

    # --------------------------------------------------------- retry budgets
    def note_send(self, layer: str, edge: str) -> None:
        """A FRESH send on (layer, edge) earns ``retry_ratio`` tokens."""
        with self._lock:
            self.fresh_sends[layer] = self.fresh_sends.get(layer, 0) + 1
            b = self._bucket_locked(layer, edge)
            b.tokens = min(self.retry_burst, b.tokens + self.retry_ratio)

    def budget_earned(self) -> float:
        """Total retry budget ever earned (initial allowance per live
        bucket + ratio × fresh sends): ``retry_granted <= budget_earned``
        is the counter-reconciled budget property the metastability gate
        checks."""
        with self._lock:
            return (self.retry_initial * max(1, len(self._buckets))
                    + self.retry_ratio * sum(self.fresh_sends.values()))

    def allow_retry(self, layer: str, edge: str) -> bool:
        """Spend one retry token for (layer, edge). Denied retries are
        counted; the ``retry.budget_exhausted`` fault site lets a chaos
        plan force exhaustion at this exact decision."""
        self._ensure_gauges()
        forced = False
        from ..faultinject import InjectedFault, check_site

        try:
            check_site("retry.budget_exhausted")
        except InjectedFault:
            forced = True
        with self._lock:
            b = self._bucket_locked(layer, edge)
            if forced or b.tokens < 1.0:
                b.denied += 1
                self.retry_denied += 1
                granted = False
            else:
                b.tokens -= 1.0
                b.granted += 1
                self.retry_granted += 1
                granted = True
        c = _ov_counters()
        if granted:
            c["retry_granted"].inc()
        else:
            c["retry_denied"].inc()
        return granted

    def _bucket_locked(self, layer: str, edge: str) -> _Bucket:
        key = (layer, edge)
        b = self._buckets.get(key)
        if b is None:
            if len(self._buckets) >= self.BUCKET_CAP:
                self._buckets.popitem(last=False)
            b = self._buckets[key] = _Bucket(self.retry_initial)
        return b

    # ------------------------------------------------- partition suspicion
    def edge_suspected(self, src: str, dst: str) -> bool:
        with self._lock:
            return f"{src}->{dst}" in self._suspect_edges

    # -------------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        with self._lock:
            buckets = {
                f"{layer}:{edge}": {
                    "tokens": b.tokens, "granted": b.granted,
                    "denied": b.denied,
                }
                for (layer, edge), b in self._buckets.items()
            }
            return {
                "enabled": self._enabled,
                "limit": self.limit,
                "inflight": self._inflight,
                "slo_p99_s": self.slo_p99_s,
                "class_shares": dict(self.class_shares),
                "admitted": self.admitted,
                "rejected": self.rejected,
                "rejected_by_class": dict(self.rejected_by_class),
                "deadline_shed": self.deadline_shed,
                "retry_ratio": self.retry_ratio,
                "retry_initial": self.retry_initial,
                "fresh_sends": dict(self.fresh_sends),
                "budget_earned": (
                    self.retry_initial * max(1, len(self._buckets))
                    + self.retry_ratio * sum(self.fresh_sends.values())
                ),
                "retry_granted": self.retry_granted,
                "retry_denied": self.retry_denied,
                "buckets": buckets,
                "suspect_edges": sorted(self._suspect_edges),
            }


# ------------------------------------------------------- metric registration
#
# Every overload.*/retry_budget.*/admission.* metric name appears here
# (or in _ensure_gauges) as a LITERAL so the metrics-doc lint enumerates
# them and enforces their docs/OBSERVABILITY.md rows. Called only from
# live hooks — while the governor is off the process registry gains no
# overload names at all.

def _ov_counters() -> dict:
    from ..node.monitoring import node_metrics

    m = node_metrics()
    return {
        "admitted": m.counter("overload.admitted"),
        "rejected": m.counter("overload.rejected"),
        "deadline_shed": m.counter("overload.deadline_shed"),
        "retry_granted": m.counter("retry_budget.granted"),
        "retry_denied": m.counter("retry_budget.denied"),
    }


# --------------------------------------------------- process-global registry

_global = OverloadGovernor()
_env_checked = False


def overload_governor() -> OverloadGovernor:
    return _global


def active_overload() -> OverloadGovernor | None:
    """The hot-path check every hook performs: the process governor when
    overload protection is ON, else None. Two attribute reads when off
    (after the one-time env probe)."""
    global _env_checked
    if not _env_checked:
        _env_checked = True
        if os.environ.get("CORDA_TPU_OVERLOAD", "") == "1":
            _global.enable()
    g = _global
    return g if g._enabled else None


def configure_overload(*, enabled: bool | None = None, reset: bool = False,
                       limit: float | None = None,
                       min_limit: float | None = None,
                       max_limit: float | None = None,
                       slo_p99_s: float | None = None,
                       retry_ratio: float | None = None,
                       retry_burst: float | None = None,
                       retry_initial: float | None = None,
                       suspect_backoff_scale: float | None = None,
                       class_shares: dict | None = None,
                       ) -> OverloadGovernor:
    """The overload knob (docs/OVERLOAD.md): flip the governor on/off,
    seed the AIMD limit and SLO target, size the retry buckets.
    ``reset`` drops every counter, bucket, and the latency window. The
    ``CORDA_TPU_OVERLOAD=1`` env knob enables it at first hook touch
    without code changes."""
    global _env_checked
    _env_checked = True  # explicit configuration overrides the env probe
    if reset:
        _global.reset()
    if limit is not None:
        _global.limit = float(limit)
    if min_limit is not None:
        _global.min_limit = float(min_limit)
    if max_limit is not None:
        _global.max_limit = float(max_limit)
    if slo_p99_s is not None:
        _global.slo_p99_s = float(slo_p99_s)
    if retry_ratio is not None:
        _global.retry_ratio = float(retry_ratio)
    if retry_burst is not None:
        _global.retry_burst = float(retry_burst)
    if retry_initial is not None:
        _global.retry_initial = float(retry_initial)
    if suspect_backoff_scale is not None:
        _global.suspect_backoff_scale = float(suspect_backoff_scale)
    if class_shares is not None:
        _global.class_shares = dict(class_shares)
    if enabled is not None:
        if enabled:
            _global.enable()
        else:
            _global.disable()
    return _global


def overload_section() -> dict:
    """The ``overload`` section of monitoring/flight snapshots: the full
    governor snapshot while on, a bare disabled marker while off."""
    g = _global
    if not g._enabled:
        return {"enabled": False}
    return g.snapshot()
