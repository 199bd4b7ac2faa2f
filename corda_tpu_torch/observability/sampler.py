"""sampler — wall-clock sampling profiler over ``sys._current_frames()``.

(Counterpart of corda_tpu/observability/sampler.py, copied with its import root
changed.)

flowprof (phase accounting) answers *which phase* a flow's wall went to;
this module answers *which code* — the classic host-profiling gap when
the residual (``engine_other``) or ``lock_wait`` dominates and the next
question is "what is the GIL-holding stack right now?". A daemon thread
wakes ~100 times a second, snapshots every thread's Python stack, folds
each into a flamegraph line (``mod.fn;mod.fn;...``, root first) and
counts it per THREAD ROLE — flow workers, the serving dispatcher /
collector / hedge threads, fsync writers — so a dump reads as one
flamegraph per subsystem rather than a soup of ephemeral thread names.

The concurrency observatory adds a per-sample CLASSIFIER: when
lock-contention accounting is on (``CORDA_TPU_CONTENTION=1``) each
sampled thread is classified as ``on_cpu`` / ``lock_wait`` / ``io_wait``
/ ``gil_runnable`` by frame inspection over the registered wait sites
(``contention.classify_frame``). At most one runnable thread can hold
the GIL, so the k runnable threads in a tick split fractionally: each
books 1/k of a sample to ``on_cpu`` and (k-1)/k to ``gil_runnable``.
Classified weights fold per role into the dump's ``causes`` table and
per phase into flowprof's cause ledger via the thread→phase map. With
contention off the classifier never runs and the tick's cost is
unchanged (the <3% budget is re-pinned with the classifier ON).

Off by default: no thread, no metrics, zero cost (the fresh-subprocess
test pins this). Opt in with ``CORDA_TPU_SAMPLER=1`` or
``configure_sampler(enabled=True)``. The sampler measures its OWN duty
cycle (time spent sampling / elapsed) and exposes it as
``sampler.overhead_ratio`` — the <3% overhead budget is test-pinned
against this gauge, and the loop self-throttles by sleeping the
remainder of each period rather than a fixed interval. Dumps are
RPC-reachable (``CordaRPCOps.sampler_dump``) and ride SLO-breach flight
dumps next to the flowprof waterfall. Metric names live in
docs/OBSERVABILITY.md §"Critical-path accounting".
"""

from __future__ import annotations

import os
import sys
import threading
import time

# thread-name prefix → role. First match wins; unknown names pool
# under "other" so the dump stays bounded by role count, not thread
# count. The names come from the threads the subsystems spawn
# (engine flow-worker-*, scheduler serving-*, WAL writers, pumps).
_ROLES = (
    ("flow-worker", "flow_worker"),
    ("serving-dispatch", "dispatcher"),
    ("serving-collect", "collector"),
    ("serving-hedge", "hedge"),
    ("serving-", "serving_aux"),
    ("wal", "fsync"),
    ("durability", "fsync"),
    ("notary-", "notary"),
    ("mock-net-pump", "net_pump"),
    ("MainThread", "main"),
)


def _role_of(name: str) -> str:
    for prefix, role in _ROLES:
        if name.startswith(prefix):
            return role
    return "other"


class StackSampler:
    """The sampling loop + folded-stack store (construct directly only
    in tests; production code shares ``sampler()``)."""

    MAX_STACKS = 4096   # distinct (role, folded-stack) keys kept
    MAX_DEPTH = 48      # frames folded per stack

    def __init__(self, *, hz: float = 100.0, clock=time.monotonic):
        self._hz = max(1.0, min(1000.0, float(hz)))
        self._clock = clock
        self._lock = threading.Lock()
        self._stacks: dict[tuple, int] = {}  # (role, folded) → count
        self._samples = 0
        self._dropped = 0
        self._busy_s = 0.0
        self._started_at: float | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._names: dict[int, str] = {}  # thread ident → name cache
        # blocked/running classification (concurrency observatory):
        # tri-state config — None = auto (on iff contention accounting
        # is active at start), bool = explicit override.
        self._classify_cfg: bool | None = None
        self._classify = False
        self._causes: dict[tuple, float] = {}  # (role, cause) → weight

    # ------------------------------------------------------------- config
    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    @property
    def hz(self) -> float:
        return self._hz

    def start(self) -> None:
        if self.running:
            return
        if self._classify_cfg is not None:
            self._classify = self._classify_cfg
        else:
            try:
                from corda_tpu_torch.observability.contention import (
                    active_contention,
                )

                self._classify = active_contention() is not None
            except Exception:
                self._classify = False
        self._stop.clear()
        with self._lock:
            self._started_at = self._clock()
        self._thread = threading.Thread(
            target=self._loop, name="stack-sampler", daemon=True
        )
        self._thread.start()
        from corda_tpu_torch.node.monitoring import node_metrics

        m = node_metrics()
        m.gauge("sampler.overhead_ratio", self.overhead_ratio)
        m.gauge("sampler.stacks", lambda: len(self._stacks))

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def reset(self) -> None:
        with self._lock:
            self._stacks.clear()
            self._causes.clear()
            self._samples = 0
            self._dropped = 0
            self._busy_s = 0.0
            self._started_at = self._clock()

    # ------------------------------------------------------------ sampling
    def _refresh_names(self) -> None:
        self._names = {
            t.ident: t.name for t in threading.enumerate()
            if t.ident is not None
        }

    @staticmethod
    def _fold(frame, max_depth: int) -> str:
        parts: list[str] = []
        while frame is not None and len(parts) < max_depth:
            code = frame.f_code
            mod = code.co_filename.rsplit("/", 1)[-1]
            if mod.endswith(".py"):
                mod = mod[:-3]
            parts.append(f"{mod}.{code.co_name}")
            frame = frame.f_back
        parts.reverse()  # root first, flamegraph convention
        return ";".join(parts)

    def sample_once(self) -> int:
        """One sampling tick (public for the fake-clock tests): fold
        every foreign thread's stack into the (role, stack) counts.
        With the classifier on, also classify each thread's cause and
        fold the weights per role and per flowprof phase. Returns the
        number of stacks recorded."""
        me = threading.get_ident()
        frames = sys._current_frames()
        classify = self._classify
        cf = fp = None
        if classify:
            from corda_tpu_torch.observability.contention import classify_frame
            from corda_tpu_torch.observability.flowprof import active_flowprof

            cf = classify_frame
            fp = active_flowprof()
        runnable: list[tuple] = []
        recorded = 0
        for ident, frame in frames.items():
            if ident == me:
                continue
            name = self._names.get(ident)
            if name is None:
                self._refresh_names()
                name = self._names.get(ident, f"tid-{ident}")
            role = _role_of(name)
            key = (role, self._fold(frame, self.MAX_DEPTH))
            with self._lock:
                if key in self._stacks:
                    self._stacks[key] += 1
                elif len(self._stacks) < self.MAX_STACKS:
                    self._stacks[key] = 1
                else:
                    self._dropped += 1
            if classify:
                cause = cf(frame)
                if cause is None:
                    runnable.append((role, ident))
                else:
                    self._note_cause(role, ident, cause, 1.0, fp)
            recorded += 1
        if runnable:
            # only one runnable thread can actually hold the GIL: split
            # each runnable sample 1/k on-cpu, (k-1)/k gil-runnable
            k = len(runnable)
            on = 1.0 / k
            gil = 1.0 - on
            for role, ident in runnable:
                self._note_cause(role, ident, "on_cpu", on, fp)
                if gil > 0.0:
                    self._note_cause(role, ident, "gil_runnable", gil, fp)
        with self._lock:
            self._samples += 1
        return recorded

    def _note_cause(self, role: str, ident: int, cause: str,
                    weight: float, fp) -> None:
        with self._lock:
            key = (role, cause)
            self._causes[key] = self._causes.get(key, 0.0) + weight
        if fp is not None:
            phase = fp.thread_phase(ident)
            if phase is not None:
                fp.note_cause_sample(phase, cause, weight)

    def _loop(self) -> None:
        period = 1.0 / self._hz
        while not self._stop.is_set():
            t0 = self._clock()
            try:
                self.sample_once()
            except Exception:
                pass  # a broken tick must not kill the sampler
            busy = self._clock() - t0
            with self._lock:
                self._busy_s += busy
            # self-throttle: sleep the REMAINDER of the period, so a
            # slow tick stretches the interval instead of back-to-back
            # sampling blowing the overhead budget
            self._stop.wait(max(period - busy, period * 0.1))

    # ------------------------------------------------------------- reading
    def overhead_ratio(self) -> float:
        """Time spent inside sampling ticks / wall since start — the
        <3% budget's measured side."""
        with self._lock:
            if self._started_at is None:
                return 0.0
            elapsed = self._clock() - self._started_at
            return (self._busy_s / elapsed) if elapsed > 0 else 0.0

    def dump(self, top_n: int = 50) -> dict:
        """Folded stacks per role, heaviest first — the flamegraph
        payload RPC and flight dumps ship."""
        with self._lock:
            items = sorted(
                self._stacks.items(), key=lambda kv: -kv[1]
            )
            samples = self._samples
            dropped = self._dropped
            cause_items = list(self._causes.items())
        roles: dict[str, list] = {}
        for (role, folded), count in items:
            bucket = roles.setdefault(role, [])
            if len(bucket) < top_n:
                bucket.append([folded, count])
        causes: dict[str, dict] = {}
        for (role, cause), weight in cause_items:
            causes.setdefault(role, {})[cause] = round(weight, 4)
        return {
            "enabled": True,
            "running": self.running,
            "hz": self._hz,
            "samples": samples,
            "dropped_stacks": dropped,
            "overhead_ratio": round(self.overhead_ratio(), 6),
            "classified": self._classify,
            "roles": roles,
            "causes": causes,
        }


# ------------------------------------------------- process-global sampler

_global = StackSampler()
_env_checked = False


def sampler() -> StackSampler:
    return _global


def active_sampler() -> StackSampler | None:
    """The running process sampler, or None. The first call probes the
    ``CORDA_TPU_SAMPLER=1`` env knob (the only implicit start path);
    with the knob unset this is two attribute reads and no thread ever
    exists."""
    global _env_checked
    if not _env_checked:
        _env_checked = True
        if os.environ.get("CORDA_TPU_SAMPLER", "") == "1":
            _global.start()
    s = _global
    return s if s.running else None


def configure_sampler(*, enabled: bool | None = None,
                      hz: float | None = None,
                      classify: bool | None = None,
                      reset: bool = False) -> StackSampler:
    """The sampler knob (docs/OBSERVABILITY.md §Critical-path
    accounting): start/stop the sampling thread, retune the rate
    (applies at next start). ``classify`` overrides the blocked/running
    classifier's auto-detection (default: on iff contention accounting
    is active at start). Explicit configuration overrides the env
    probe."""
    global _env_checked
    _env_checked = True
    if hz is not None:
        _global._hz = max(1.0, min(1000.0, float(hz)))
    if classify is not None:
        _global._classify_cfg = classify
        _global._classify = classify
    if reset:
        _global.reset()
    if enabled is not None:
        if enabled:
            _global.start()
        else:
            _global.stop()
    return _global


def sampler_section() -> dict:
    """Flight-dump / snapshot payload: the dump while running, a bare
    disabled marker otherwise."""
    s = active_sampler()
    if s is None:
        return {"enabled": False}
    return s.dump()
