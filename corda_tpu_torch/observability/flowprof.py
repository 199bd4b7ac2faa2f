"""flowprof — per-flow critical-path phase accounting (counterpart of
corda_tpu/observability/flowprof.py).

Spans trace requests, a profiler times kernels, a monitor watches devices —
none of them can answer the question the end-to-end ceiling poses: *for one flow,
where did the wall-clock go?* The device plane verifies 100k+ sigs/sec,
yet flows top out three orders of magnitude lower; the missing
microseconds are host-side (queue wait, lock wait, WAL fsync,
serialization, GIL) and invisible to a span tree whose nodes only cover
the operations someone remembered to wrap.

This module closes the books: every profiled flow accumulates wall-clock
into a CLOSED set of named phases, and the leftover is itself a phase
(``engine_other``), so the phases always sum to the flow's wall time —
conservation is structural, not aspirational. The closed set:

==================  ====================================================
``queue_wait``      serving-scheduler queue (enqueue → dispatch)
``device_execute``  device batch execute, per coalesced request
``host_verify``     host-path verification (fallback / host lanes)
``wal_fsync_wait``  blocked in the durability tier's group-commit flush
``lock_wait``       blocked acquiring the engine's SMM lock (timed-
                    acquire hook, lockwatch-style)
``serialize``       CBE serialize/deserialize on the flow's own thread
``message_transit`` session-message network transit (send → delivery)
``checkpoint``      op-log checkpoint writes
``notary_rtt``      notarisation round-trip (client-side park window)
``engine_other``    the residual — everything unattributed
==================  ====================================================

Accounting model (three feed mechanisms, one ledger):

- **Frames** (``flowprof_frame(phase)``): same-thread timed sections
  with *exclusive* time semantics — a nested frame's wall is subtracted
  from its parent's, so a ``checkpoint`` frame that spends most of its
  time inside a nested ``wal_fsync_wait`` frame books only its own
  exclusive share. Frames are thread-confined to the flow's current
  executor thread (the engine activates the flow's account around the
  flow body, exactly like the tracer's span activation).
- **Cross-thread adds** (``FlowProfiler.add``): the serving scheduler's
  dispatcher/collector threads attribute ``queue_wait`` /
  ``device_execute`` / ``host_verify`` to the submitting flow's account
  captured at ``submit_rows`` time; message delivery attributes
  ``message_transit`` to the receiving flow.
- **Park hints** (``flowprof_hint(phase)``): a park (flow suspended
  awaiting a session message) unwinds the worker thread, so no frame
  can cover it. A hint marks the *reason* for the upcoming park — the
  notary client sets ``notary_rtt`` around its request/response pair —
  and the engine attributes the park's wall to the hinted phase at
  unpark. Cross-thread adds landing *inside* a hinted park window (the
  response's ``message_transit``) are tallied separately and subtracted
  from the hinted attribution, so the park wall is never double-booked.

Cause buckets (the concurrency observatory): each phase's
aggregate wall additionally splits into WHY buckets — ``on_cpu`` /
``lock_wait`` / ``io_wait`` / ``gil_runnable`` / ``unattributed``.
The conservation rule mirrors the phase rule and is structural, not
aspirational: exact declared evidence (the ``lock_wait`` cross-add hint
from a blocked ``TimedRLock`` acquire, cause-declaring frames like the
WAL flush's ``io_wait``) is booked first and clamped to the phase
total; the remainder is distributed proportionally over the stack
sampler's classified sample weights; anything without evidence lands in
``unattributed`` — so per phase the buckets always sum exactly to the
phase total (``snapshot()["causes"]``, test-pinned at ±5% against the
phase walls).

Off by default (``CORDA_TPU_FLOWPROF=1`` or ``configure_flowprof``);
every hook pays two attribute reads (``active_flowprof()`` → None) while
off, and the process registry gains ZERO ``flowprof.*`` metrics until
the first profiled flow closes. Closed flows feed ``flowprof.phase.*``
timers (p50/p99 per phase) plus a per-flow-class waterfall, exposed via
``monitoring_snapshot()["flowprof"]``, ``CordaRPCOps.flowprof_snapshot``,
Prometheus exposition (the timers live in ``node_metrics()``), and
flight-recorder dumps. Metric names live in docs/OBSERVABILITY.md
§"Critical-path accounting".
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict, deque

# The closed phase set. Order is the waterfall's display order.
PHASES = (
    "queue_wait",
    "device_execute",
    "host_verify",
    "wal_fsync_wait",
    "lock_wait",
    "serialize",
    "message_transit",
    "checkpoint",
    "notary_rtt",
    "engine_other",
)

# The closed CAUSE set each phase's wall splits into (the concurrency
# observatory, docs/OBSERVABILITY.md §Concurrency observatory): why the
# wall went, not just where. ``unattributed`` is the residual bucket for
# phases with no classified evidence — conservation to the phase total
# is structural, like ``engine_other`` for the phases themselves.
CAUSES = (
    "on_cpu",
    "lock_wait",
    "io_wait",
    "gil_runnable",
    "unattributed",
)

_phase_listener = None  # causal profiler's phase-boundary hook


def set_phase_listener(fn) -> None:
    """Install (or clear, with None) the phase-boundary observer the
    causal profiler uses to insert virtual-speedup delays: called as
    ``fn(phase, seconds)`` on the booking thread at every frame exit,
    cross-thread add and park attribution. At most one listener; it must
    be cheap and must never raise."""
    global _phase_listener
    _phase_listener = fn


class _FlowAcct:
    """One flow's phase ledger. Frames are confined to the activating
    thread; ``phases`` mutations take the account's lock (cross-thread
    adds race the closing flow)."""

    __slots__ = ("flow_id", "flow_class", "t0", "lock", "phases",
                 "frames", "hint", "hint_cross", "park_t0", "closed",
                 "wall_s")

    def __init__(self, flow_id: str, flow_class: str, now: float):
        self.flow_id = flow_id
        self.flow_class = flow_class
        self.t0 = now
        self.lock = threading.Lock()
        self.phases = {p: 0.0 for p in PHASES}
        # [phase, start, child_seconds] — exclusive-time frame stack
        self.frames: list[list] = []
        self.hint: str | None = None     # park-attribution phase
        self.hint_cross = 0.0            # cross adds inside the hint window
        self.park_t0: float | None = None
        self.closed = False
        self.wall_s = 0.0


class _Frame:
    """``with flowprof_frame("serialize"):`` — exclusive-time section on
    the thread's current account. No active account → pure no-op.

    A frame may declare a *cause* (``io_wait`` for the WAL flush frame):
    its exclusive time then feeds the phase's cause ledger as exact
    evidence instead of waiting for the sampler to guess. While a frame
    is open, the thread→phase map lets the stack sampler's classifier
    attribute wait samples to the right phase."""

    __slots__ = ("_prof", "_phase", "_cause", "_acct", "_prev_phase",
                 "_ident")

    def __init__(self, prof: "FlowProfiler", phase: str,
                 cause: str | None = None):
        self._prof = prof
        self._phase = phase
        self._cause = cause
        self._acct = None
        self._prev_phase = None
        self._ident = 0

    def __enter__(self):
        acct = self._prof.current()
        if acct is not None:
            self._acct = acct
            ident = threading.get_ident()
            self._ident = ident
            tp = self._prof._thread_phase
            self._prev_phase = tp.get(ident)
            tp[ident] = self._phase
            acct.frames.append([self._phase, self._prof._clock(), 0.0])
        return self

    def __exit__(self, *exc):
        acct = self._acct
        if acct is not None:
            phase, start, child = acct.frames.pop()
            elapsed = self._prof._clock() - start
            exclusive = elapsed - child
            if exclusive < 0.0:
                exclusive = 0.0
            with acct.lock:
                if not acct.closed:
                    acct.phases[phase] += exclusive
            if acct.frames:
                acct.frames[-1][2] += elapsed
            tp = self._prof._thread_phase
            if self._prev_phase is None:
                tp.pop(self._ident, None)
            else:
                tp[self._ident] = self._prev_phase
            if self._cause is not None and exclusive > 0.0:
                self._prof.note_cause_seconds(phase, self._cause, exclusive)
            lst = _phase_listener
            if lst is not None:
                lst(phase, exclusive)
        return False


class _Hint:
    """``with flowprof_hint("notary_rtt"):`` — park-attribution scope on
    the thread's current account. The engine reads ``acct.hint`` at
    park/unpark; the scope restores the previous hint on exit so nested
    hints compose. A park unwinds the worker via a BaseException that
    flies through this context manager's ``__exit__`` — that is fine:
    the replayed flow body re-enters the same ``with`` on resume."""

    __slots__ = ("_prof", "_phase", "_acct", "_prev")

    def __init__(self, prof: "FlowProfiler", phase: str):
        self._prof = prof
        self._phase = phase
        self._acct = None
        self._prev = None

    def __enter__(self):
        acct = self._prof.current()
        if acct is not None:
            self._acct = acct
            with acct.lock:
                self._prev = acct.hint
                acct.hint = self._phase
        return self

    def __exit__(self, *exc):
        acct = self._acct
        if acct is not None:
            with acct.lock:
                acct.hint = self._prev
        return False


class FlowProfiler:
    """Process-global phase-accounting ledger (construct directly only in
    tests; production code shares ``flowprof()``)."""

    LIVE_CAP = 4096        # live accounts (leaked flows must stay bounded)
    TRANSIT_CAP = 8192     # in-flight message send timestamps
    RECENT_CAP = 256       # completed waterfalls kept for dumps/tests

    def __init__(self, *, clock=time.monotonic):
        self._enabled = False
        self._clock = clock
        self._lock = threading.Lock()
        self._local = threading.local()
        self._live: OrderedDict[str, _FlowAcct] = OrderedDict()
        self._sent: OrderedDict[str, float] = OrderedDict()
        self._classes: dict[str, dict] = {}
        self._recent: deque = deque(maxlen=self.RECENT_CAP)
        self._closed_count = 0
        # Concurrency observatory: per-phase cause evidence. Exact
        # seconds come from declared feeds (TimedRLock's lock_wait
        # cross-add hint, cause-declaring frames); sample weights come
        # from the stack sampler's classifier. thread→phase is the
        # sampler's attribution map, maintained by open frames.
        self._cause_lock = threading.Lock()
        self._cause_seconds: dict[str, dict[str, float]] = {}
        self._cause_samples: dict[str, dict[str, float]] = {}
        self._thread_phase: dict[int, str] = {}

    # ------------------------------------------------------------- config
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def reset(self) -> None:
        with self._lock:
            self._live.clear()
            self._sent.clear()
            self._classes.clear()
            self._recent.clear()
            self._closed_count = 0
        with self._cause_lock:
            self._cause_seconds.clear()
            self._cause_samples.clear()
        self._thread_phase.clear()

    # ---------------------------------------------------------- lifecycle
    def open(self, flow_id: str, flow_class: str) -> _FlowAcct:
        """Open a flow's account (the engine's flow-span-open hook)."""
        acct = _FlowAcct(flow_id, flow_class, self._clock())
        with self._lock:
            while len(self._live) >= self.LIVE_CAP:
                self._live.popitem(last=False)
            self._live[flow_id] = acct
        return acct

    def acct_of(self, flow_id: str) -> _FlowAcct | None:
        with self._lock:
            return self._live.get(flow_id)

    def close(self, flow_id: str) -> dict | None:
        """Finalize: compute the residual so phases sum EXACTLY to the
        flow wall (unless over-attribution already exceeds it, in which
        case the residual clamps at zero and the conservation tests see
        the overshoot), feed the ``flowprof.*`` timers and the per-class
        waterfall, and drop the live account."""
        with self._lock:
            acct = self._live.pop(flow_id, None)
        if acct is None:
            return None
        now = self._clock()
        with acct.lock:
            acct.closed = True
            wall = now - acct.t0
            acct.wall_s = wall
            attributed = sum(
                v for p, v in acct.phases.items() if p != "engine_other"
            )
            acct.phases["engine_other"] = max(0.0, wall - attributed)
            phases = dict(acct.phases)
        self._record(acct.flow_class, wall, phases, flow_id)
        return {"flow_id": flow_id, "flow_class": acct.flow_class,
                "wall_s": wall, "phases": phases}

    def _record(self, flow_class: str, wall: float, phases: dict,
                flow_id: str = "") -> None:
        timers = _phase_timers()
        for phase, seconds in phases.items():
            timers[phase].update(seconds)
        from corda_tpu_torch.node.monitoring import node_metrics

        m = node_metrics()
        m.timer("flowprof.wall_s").update(wall)
        m.counter("flowprof.flows").inc()
        with self._lock:
            self._closed_count += 1
            agg = self._classes.get(flow_class)
            if agg is None:
                agg = self._classes[flow_class] = {
                    "flows": 0, "wall_s": 0.0,
                    "phases": {p: 0.0 for p in PHASES},
                }
            agg["flows"] += 1
            agg["wall_s"] += wall
            for p, v in phases.items():
                agg["phases"][p] += v
            self._recent.append({
                "flow_id": flow_id, "flow_class": flow_class,
                "wall_s": wall, "phases": phases,
            })

    def waterfall_of(self, flow_id: str) -> dict | None:
        """The most recent closed waterfall for one flow id (the cluster
        TraceAssembler's per-node phase attribution feed), or None when
        it never closed under accounting / aged out of the recent ring."""
        with self._lock:
            for rec in reversed(self._recent):
                if rec.get("flow_id") == flow_id:
                    return {"flow_class": rec["flow_class"],
                            "wall_s": rec["wall_s"],
                            "phases": dict(rec["phases"])}
        return None

    # ----------------------------------------------------------- activation
    def activate(self, acct: _FlowAcct | None) -> "_Activation":
        """``with fp.activate(acct):`` — frames/hints on this thread book
        to ``acct`` (the engine wraps each flow-body segment, mirroring
        ``tracer().activate``)."""
        return _Activation(self, acct)

    def current(self) -> _FlowAcct | None:
        stack = getattr(self._local, "stack", None)
        if not stack:
            return None
        return stack[-1]

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def frame(self, phase: str, cause: str | None = None) -> _Frame:
        return _Frame(self, phase, cause)

    def hint(self, phase: str) -> _Hint:
        return _Hint(self, phase)

    # --------------------------------------------------------- cross-thread
    def add(self, acct: _FlowAcct | None, phase: str, seconds: float,
            cause: str | None = None) -> None:
        """Attribute ``seconds`` of ``phase`` to ``acct`` from a foreign
        thread (scheduler dispatcher/collector, message delivery). Adds
        landing inside a hinted park window are tallied into
        ``hint_cross`` so the park attribution can subtract them.

        ``cause`` is the cross-add *hint* for the cause ledger: feeds
        that know why the time went (a blocked ``TimedRLock`` acquire is
        lock wait by construction) declare it, and the phase's cause
        split becomes exact evidence that reconciles with the phase wall
        instead of a sampled estimate."""
        if acct is None or seconds <= 0.0:
            return
        with acct.lock:
            if acct.closed:
                return
            acct.phases[phase] += seconds
            if acct.hint is not None and phase != acct.hint:
                acct.hint_cross += seconds
        if cause is not None:
            self.note_cause_seconds(phase, cause, seconds)
        lst = _phase_listener
        if lst is not None:
            lst(phase, seconds)

    # ------------------------------------------------------------ park hook
    def note_park(self, acct: _FlowAcct | None) -> None:
        """The engine parked this flow: open the park window (only a
        hinted park is attributed; an unhinted park's wall falls into
        the residual, which is the honest answer for 'waiting on a
        counterparty we cannot see into')."""
        if acct is None:
            return
        with acct.lock:
            if acct.hint is not None and acct.park_t0 is None:
                acct.park_t0 = self._clock()
                acct.hint_cross = 0.0

    def note_unpark(self, acct: _FlowAcct | None) -> None:
        """Close the park window: book ``park wall − cross adds inside
        the window`` to the hinted phase (never negative)."""
        if acct is None:
            return
        booked_phase = None
        booked = 0.0
        with acct.lock:
            if acct.park_t0 is not None and acct.hint is not None:
                dt = self._clock() - acct.park_t0
                booked = max(0.0, dt - acct.hint_cross)
                booked_phase = acct.hint
                acct.phases[booked_phase] += booked
            acct.park_t0 = None
            acct.hint_cross = 0.0
        if booked_phase is not None:
            lst = _phase_listener
            if lst is not None:
                lst(booked_phase, booked)

    # ------------------------------------------------------ message transit
    def note_sent(self, msg_id: str) -> None:
        """Stamp a session message's send time (bounded FIFO map)."""
        now = self._clock()
        with self._lock:
            while len(self._sent) >= self.TRANSIT_CAP:
                self._sent.popitem(last=False)
            self._sent[msg_id] = now

    def take_transit(self, msg_id: str, acct: _FlowAcct | None) -> None:
        """Message delivered to a flow's session: book send→delivery as
        ``message_transit`` on the receiving flow."""
        with self._lock:
            t_sent = self._sent.pop(msg_id, None)
        if t_sent is not None:
            self.add(acct, "message_transit", self._clock() - t_sent)

    # ------------------------------------------------------------ SMM lock
    def timed_rlock(self) -> "TimedRLock":
        return TimedRLock(self)

    # --------------------------------------------------------- cause ledger
    def note_cause_seconds(self, phase: str, cause: str,
                           seconds: float) -> None:
        """Exact cause evidence: ``seconds`` of ``phase`` were ``cause``
        by construction (declared frames, the lock_wait cross-add hint)."""
        if seconds <= 0.0 or cause not in CAUSES:
            return
        with self._cause_lock:
            d = self._cause_seconds.setdefault(phase, {})
            d[cause] = d.get(cause, 0.0) + seconds

    def note_cause_sample(self, phase: str, cause: str,
                          weight: float) -> None:
        """Sampled cause evidence from the stack sampler's classifier:
        one sample (or a fractional GIL share) saw ``phase``'s thread in
        ``cause``."""
        if weight <= 0.0 or cause not in CAUSES:
            return
        with self._cause_lock:
            d = self._cause_samples.setdefault(phase, {})
            d[cause] = d.get(cause, 0.0) + weight

    def thread_phase(self, ident: int) -> str | None:
        """The phase the thread ``ident`` is currently inside (its
        innermost open frame), or None — the sampler's attribution map."""
        return self._thread_phase.get(ident)

    def causes_snapshot(self) -> dict:
        """Split each phase's aggregate wall (across all closed flows)
        into cause buckets. Conservation is STRUCTURAL: exact declared
        seconds are booked first (clamped to the phase total), the
        remainder is distributed over the sampler's cause weights, and
        whatever has no evidence lands in ``unattributed`` — every
        phase's buckets sum exactly to the phase total
        (docs/OBSERVABILITY.md §Concurrency observatory)."""
        with self._lock:
            totals = {p: 0.0 for p in PHASES}
            for agg in self._classes.values():
                for p, v in agg["phases"].items():
                    totals[p] += v
        with self._cause_lock:
            exact = {p: dict(d) for p, d in self._cause_seconds.items()}
            sampled = {p: dict(d) for p, d in self._cause_samples.items()}
        out = {}
        for p in PHASES:
            total = totals[p]
            if total <= 0.0:
                continue
            buckets = {c: 0.0 for c in CAUSES}
            ex = exact.get(p, {})
            ex_sum = sum(ex.values())
            scale = min(1.0, total / ex_sum) if ex_sum > 0 else 0.0
            booked = 0.0
            for c, v in ex.items():
                share = v * scale
                buckets[c] += share
                booked += share
            remainder = max(0.0, total - booked)
            sm = sampled.get(p, {})
            sm_sum = sum(sm.values())
            if remainder > 0.0 and sm_sum > 0.0:
                for c, w in sm.items():
                    buckets[c] += remainder * (w / sm_sum)
            elif remainder > 0.0:
                buckets["unattributed"] += remainder
            out[p] = buckets
        return out

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> dict:
        """The ``flowprof`` section: per-phase timer stats (p50/p99 over
        closed flows), wall stats, and the per-flow-class waterfall with
        each phase's share of that class's total wall."""
        from corda_tpu_torch.node.monitoring import node_metrics

        m = node_metrics()
        with self._lock:
            live = len(self._live)
            closed = self._closed_count
            classes = {
                cls: {
                    "flows": agg["flows"],
                    "wall_s": agg["wall_s"],
                    "phases": dict(agg["phases"]),
                    "shares": {
                        p: (v / agg["wall_s"] if agg["wall_s"] > 0 else 0.0)
                        for p, v in agg["phases"].items()
                    },
                }
                for cls, agg in self._classes.items()
            }
            recent = list(self._recent)
        section = m.section("flowprof.")
        return {
            "enabled": self._enabled,
            "flows": closed,
            "live": live,
            "phases": {
                p: section.get(f"phase.{p}", {}) for p in PHASES
            },
            "wall": section.get("wall_s", {}),
            "classes": classes,
            "causes": self.causes_snapshot(),
            "recent": recent[-16:],
        }


class _Activation:
    __slots__ = ("_prof", "_acct", "_pushed")

    def __init__(self, prof: FlowProfiler, acct: _FlowAcct | None):
        self._prof = prof
        self._acct = acct
        self._pushed = False

    def __enter__(self):
        if self._acct is not None:
            self._prof._stack().append(self._acct)
            self._pushed = True
        return self._acct

    def __exit__(self, *exc):
        if self._pushed:
            stack = self._prof._stack()
            if stack and stack[-1] is self._acct:
                stack.pop()
            elif self._acct in stack:  # defensive: unbalanced exits
                stack.remove(self._acct)
        return False


class TimedRLock:
    """An RLock that books blocked-acquire time as ``lock_wait`` on the
    acquiring thread's current flow account — the lockwatch idea pointed
    at latency instead of ordering. The fast path (uncontended acquire)
    is one extra non-blocking try; ``Condition.wait``'s release/reacquire
    cycle goes through ``_release_save``/``_acquire_restore``, which
    deliberately bypass the timing — a woken waiter reacquiring the
    monitor is scheduling, not contention the flow caused."""

    __slots__ = ("_prof", "_inner")

    def __init__(self, prof: FlowProfiler, _inner=None):
        self._prof = prof
        self._inner = _inner if _inner is not None else threading.RLock()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if self._inner.acquire(False):
            return True
        if not blocking:
            return False
        acct = self._prof.current()
        if acct is None:
            return self._inner.acquire(True, timeout)
        t0 = self._prof._clock()
        got = self._inner.acquire(True, timeout)
        # the lock_wait cross-add hint: blocked acquire is lock wait by
        # construction, so the cause ledger gets exact evidence
        self._prof.add(acct, "lock_wait", self._prof._clock() - t0,
                       cause="lock_wait")
        return got

    def release(self):
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # Condition's duck-typed hooks: delegate untimed (see class docstring)
    def _release_save(self):
        return self._inner._release_save()

    def _acquire_restore(self, state):
        self._inner._acquire_restore(state)

    def _is_owned(self):
        return self._inner._is_owned()

    def _at_fork_reinit(self):
        self._inner._at_fork_reinit()

    def __getattr__(self, name):
        if name in ("_inner", "_prof"):
            raise AttributeError(name)
        return getattr(self._inner, name)


# ------------------------------------------------------- metric registration
#
# Every flowprof metric name appears here as a LITERAL so the metrics-doc
# lint (tools_metrics_lint.py) enumerates them and enforces their
# docs/OBSERVABILITY.md rows. Called only on flow close — while flowprof
# is off the process registry gains no flowprof.* entries at all.

def _phase_timers() -> dict:
    from corda_tpu_torch.node.monitoring import node_metrics

    m = node_metrics()
    return {
        "queue_wait": m.timer("flowprof.phase.queue_wait"),
        "device_execute": m.timer("flowprof.phase.device_execute"),
        "host_verify": m.timer("flowprof.phase.host_verify"),
        "wal_fsync_wait": m.timer("flowprof.phase.wal_fsync_wait"),
        "lock_wait": m.timer("flowprof.phase.lock_wait"),
        "serialize": m.timer("flowprof.phase.serialize"),
        "message_transit": m.timer("flowprof.phase.message_transit"),
        "checkpoint": m.timer("flowprof.phase.checkpoint"),
        "notary_rtt": m.timer("flowprof.phase.notary_rtt"),
        "engine_other": m.timer("flowprof.phase.engine_other"),
    }


# ------------------------------------------------- process-global profiler

_global = FlowProfiler()
_env_checked = False


def flowprof() -> FlowProfiler:
    return _global


def active_flowprof() -> FlowProfiler | None:
    """The hot-path check every hook performs: the process profiler when
    phase accounting is ON, else None. Two attribute reads when off
    (after the one-time env probe)."""
    global _env_checked
    if not _env_checked:
        _env_checked = True
        if os.environ.get("CORDA_TPU_FLOWPROF", "") == "1":
            _global.enable()
    p = _global
    return p if p._enabled else None


def configure_flowprof(*, enabled: bool | None = None,
                       reset: bool = False) -> FlowProfiler:
    """The flowprof knob (docs/OBSERVABILITY.md §Critical-path
    accounting): flip phase accounting on/off; ``reset`` drops live
    accounts and the per-class aggregation (tests, per-step harness
    waterfalls). The ``CORDA_TPU_FLOWPROF=1`` env knob enables it at
    first hook touch without code changes."""
    global _env_checked
    _env_checked = True  # explicit configuration overrides the env probe
    if reset:
        _global.reset()
    if enabled is not None:
        if enabled:
            _global.enable()
        else:
            _global.disable()
    return _global


def flowprof_section() -> dict:
    """The ``flowprof`` section of ``monitoring_snapshot()``: the full
    snapshot while on, a bare disabled marker while off."""
    p = _global
    if not p._enabled:
        return {"enabled": False}
    return p.snapshot()


def flowprof_frame(phase: str, cause: str | None = None) -> _Frame:
    """Module-level frame helper for hook sites: a timed exclusive
    section on the calling thread's current account; no-op when flowprof
    is off or no account is active. ``cause`` declares exact cause
    evidence for the section (the WAL flush frame is ``io_wait`` by
    construction)."""
    p = active_flowprof()
    if p is None:
        return _NOOP_FRAME
    return p.frame(phase, cause)


def flowprof_hint(phase: str) -> _Hint:
    """Module-level park-hint helper (see ``_Hint``); no-op when off."""
    p = active_flowprof()
    if p is None:
        return _NOOP_FRAME
    return p.hint(phase)


class _NoopFrame:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_FRAME = _NoopFrame()
