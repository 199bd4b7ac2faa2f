"""contention — lock-contention timing: the lockwatch idea pointed at cost.

(Counterpart of corda_tpu/observability/contention.py, copied with its import root
changed.)

``lockwatch`` answers *ordering* questions (which lock-class pairs ever
nested, and do the edges cycle); it deliberately records no clocks. This
module is the other half of the concurrency observatory: per
allocation-site **acquire-wait** and **hold-time** reservoirs
(p50/p95/p99), contention counters (acquires, contended acquires, total
wait seconds), a **top-contended table** keyed by the same stable
``file:line`` site names ``cycle_report()`` uses, and a **wait-edges**
view (holder site → waiter site) so "engine lock convoys behind WAL
group-commit" is a queryable fact instead of a hunch.

Instrumentation model (mirrors lockwatch, plus clocks):

- ``install()`` monkeypatches ``threading.Lock``/``RLock``/``Condition``
  so every lock constructed after it is timed, named by allocation site.
- ``timed_lock(name)`` / ``wrap_lock(inner, name)`` construct (or wrap)
  explicitly-named instances — the engine wraps its SMM lock so the
  hottest monitor in the process is always in the table when the
  observatory is on, whatever order install() ran in.
- The uncontended fast path is ONE extra non-blocking try; only a
  blocked acquire pays for clocks and edge bookkeeping.

A wait edge is recorded when an acquire blocks: the **holder** side is
the contended lock's own site (whoever owns it is executing under that
site's monitor), the **waiter** side is the innermost *timed* lock the
blocked thread still holds (or ``thread:<name-prefix>`` when it holds
none) — exactly the "A convoys behind B" arrow an engine-rewrite
review needs.

Off by default (``CORDA_TPU_CONTENTION=1`` / ``configure_contention``):
while off there is NO patched factory, NO thread, and the process
registry gains ZERO ``contention.*`` metrics — the convention of every monitor,
subprocess-pinned by the tests. While on, the registry carries
``contention.acquires`` / ``contention.contended`` counters and the
``contention.wait_s`` / ``contention.hold_s`` timers (timeline-tappable
like any other registry timer); the per-site tables live here and are
exposed via ``monitoring_snapshot()["contention"]``, labeled Prometheus
families, ``CordaRPCOps.contention_snapshot()`` and flight dumps.
Metric names: docs/OBSERVABILITY.md §"Concurrency observatory".

The sampler's blocked/running classifier rides the same knob: when
contention is active, ``StackSampler`` classifies every sampled thread
as on-cpu / lock-wait / io-wait / gil-runnable over the wait sites
registered here (``register_wait_site``) and folds the split into
flowprof's per-phase cause buckets.
"""

from __future__ import annotations

import os
import threading
import time

from .lockwatch import _allocation_site

CONTENTION_SCHEMA = 1

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition

# how many distinct sites the tables may hold (overflow pools under the
# "<overflow>" site so a site-explosion bug stays bounded)
MAX_SITES = 512
OVERFLOW_SITE = "<overflow>"

# acquires slower than this count as "contended" even when the
# non-blocking first try happened to succeed on a retry race
_CONTENDED_FLOOR_S = 1e-6


class _Reservoir:
    """Small fixed-size sampling reservoir (Vitter's algorithm R, the
    monitoring.Timer idiom) — p50/p95/p99 over blocked-acquire waits and
    hold times without unbounded memory."""

    __slots__ = ("_slots", "_buf", "_seen", "_rng")

    def __init__(self, slots: int = 256, seed: int = 2026):
        import random

        self._slots = slots
        self._buf: list[float] = []
        self._seen = 0
        self._rng = random.Random(seed)

    def add(self, value: float) -> None:
        self._seen += 1
        if len(self._buf) < self._slots:
            self._buf.append(value)
            return
        j = self._rng.randrange(self._seen)
        if j < self._slots:
            self._buf[j] = value

    def quantiles(self) -> dict:
        if not self._buf:
            return {"p50": 0.0, "p95": 0.0, "p99": 0.0}
        vals = sorted(self._buf)
        n = len(vals)
        return {
            "p50": vals[min(n - 1, int(0.50 * n))],
            "p95": vals[min(n - 1, int(0.95 * n))],
            "p99": vals[min(n - 1, int(0.99 * n))],
        }


class _SiteStats:
    """One allocation site's ledger. Mutated under the monitor's lock."""

    __slots__ = ("acquires", "contended", "wait_total_s", "wait", "hold")

    def __init__(self):
        self.acquires = 0
        self.contended = 0
        self.wait_total_s = 0.0
        self.wait = _Reservoir()
        self.hold = _Reservoir()


class ContentionMonitor:
    """The process contention ledger (construct directly only in tests;
    production code shares ``contention()`` via ``configure_contention``)."""

    def __init__(self, *, clock=time.perf_counter):
        self._enabled = False
        self._clock = clock
        self._lock = _REAL_LOCK()
        self._sites: dict[str, _SiteStats] = {}
        # (holder_site, waiter_site) → {"count": int, "wait_s": float}
        self._edges: dict[tuple, dict] = {}
        self._held = threading.local()  # per-thread [site, ...] stack
        # Reentrancy guard: while a note_* call is feeding the registry,
        # the registry's OWN locks (patched when created post-install)
        # must not re-enter the monitor — metric.inc() under a timed
        # lock would otherwise recurse into the same metric and
        # self-deadlock on its non-reentrant guard.
        self._noting = threading.local()
        # Cached contention.* metric objects. Note paths MUST NOT look
        # metrics up by name: registry._get takes the registry lock, and
        # registry.snapshot() holds that lock while acquiring every
        # metric's own (timed, post-install) lock — a name lookup from
        # inside note_acquire is a same-thread self-deadlock on the
        # snapshot path and a cross-thread ABBA with any metric writer.
        self._mx = None

    # ------------------------------------------------------------- config
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        """Register the ``contention.*`` registry metrics and mark the
        monitor live. Factory patching is separate (``install()``) so an
        explicitly-wrapped lock can feed a test monitor un-patched."""
        from corda_tpu_torch.node.monitoring import node_metrics

        self._resolve_metrics()
        node_metrics().gauge("contention.sites", lambda: len(self._sites))
        self._enabled = True

    def _resolve_metrics(self):
        """Resolve (once) and cache the contention.* metric objects —
        eager at enable() so the registry lookup never races a
        registry.snapshot(); lazy for bare test monitors."""
        mx = self._mx
        if mx is None:
            from corda_tpu_torch.node.monitoring import node_metrics

            m = node_metrics()
            mx = self._mx = (
                m.counter("contention.acquires"),
                m.counter("contention.contended"),
                m.timer("contention.wait_s"),
                m.timer("contention.hold_s"),
            )
        return mx

    def disable(self) -> None:
        self._enabled = False

    def reset(self) -> None:
        with self._lock:
            self._sites.clear()
            self._edges.clear()

    # ----------------------------------------------------------- feeding
    def _site_locked(self, site: str) -> _SiteStats:
        s = self._sites.get(site)
        if s is None:
            if len(self._sites) >= MAX_SITES:
                site = OVERFLOW_SITE
                s = self._sites.get(site)
                if s is not None:
                    return s
            s = self._sites[site] = _SiteStats()
        return s

    def _held_stack(self) -> list:
        st = getattr(self._held, "stack", None)
        if st is None:
            st = self._held.stack = []
        return st

    def waiter_context(self) -> str:
        """The waiter side of a wait edge: the innermost timed lock this
        thread still holds, else its thread-name prefix."""
        st = getattr(self._held, "stack", None)
        if st:
            return st[-1]
        name = threading.current_thread().name
        return "thread:" + name.rstrip("0123456789-_ ")

    def noting(self) -> bool:
        """True while THIS thread is inside one of the monitor's own
        note_* calls — timed locks bypass instrumentation then."""
        return getattr(self._noting, "on", False)

    def note_acquire(self, site: str, wait_s: float,
                     contended: bool) -> None:
        self._noting.on = True
        try:
            acquires, contended_c, wait_t, _ = self._resolve_metrics()
            acquires.inc()
            if contended:
                contended_c.inc()
                wait_t.update(wait_s)
            with self._lock:
                s = self._site_locked(site)
                s.acquires += 1
                if contended:
                    s.contended += 1
                    s.wait_total_s += wait_s
                    s.wait.add(wait_s)
            self._held_stack().append(site)
        finally:
            self._noting.on = False

    def note_blocked(self, site: str) -> None:
        """The acquire is about to block: record the wait edge NOW (the
        convoy is observable while it exists, not after it resolves)."""
        waiter = self.waiter_context()
        with self._lock:
            e = self._edges.get((site, waiter))
            if e is None:
                if len(self._edges) < MAX_SITES * 4:
                    self._edges[(site, waiter)] = {"count": 1, "wait_s": 0.0}
            else:
                e["count"] += 1

    def note_edge_wait(self, site: str, waiter: str, wait_s: float) -> None:
        with self._lock:
            e = self._edges.get((site, waiter))
            if e is not None:
                e["wait_s"] += wait_s

    def note_release(self, site: str, hold_s: float) -> None:
        self._noting.on = True
        try:
            self._resolve_metrics()[3].update(hold_s)
            with self._lock:
                s = self._sites.get(site)
                if s is not None:
                    s.hold.add(hold_s)
            st = self._held_stack()
            for i in range(len(st) - 1, -1, -1):
                if st[i] == site:
                    del st[i]
                    break
        finally:
            self._noting.on = False

    # ----------------------------------------------------------- reading
    def snapshot(self, top_n: int = 16) -> dict:
        """The ``contention`` section: per-site counters + wait/hold
        quantiles, the top-contended table (by total wait), and the
        holder→waiter edge list."""
        with self._lock:
            sites = {
                site: {
                    "acquires": s.acquires,
                    "contended": s.contended,
                    "wait_total_s": s.wait_total_s,
                    "wait_p50_s": s.wait.quantiles()["p50"],
                    "wait_p95_s": s.wait.quantiles()["p95"],
                    "wait_p99_s": s.wait.quantiles()["p99"],
                    "hold_p50_s": s.hold.quantiles()["p50"],
                    "hold_p95_s": s.hold.quantiles()["p95"],
                    "hold_p99_s": s.hold.quantiles()["p99"],
                }
                for site, s in self._sites.items()
            }
            edges = [
                {"holder": holder, "waiter": waiter,
                 "count": e["count"], "wait_s": e["wait_s"]}
                for (holder, waiter), e in self._edges.items()
            ]
        top = sorted(
            ((site, d) for site, d in sites.items() if d["contended"]),
            key=lambda kv: -kv[1]["wait_total_s"],
        )[:top_n]
        edges.sort(key=lambda e: (-e["wait_s"], -e["count"]))
        return {
            "enabled": self._enabled,
            "schema": CONTENTION_SCHEMA,
            "installed": _installed,
            "sites": sites,
            "top": [
                {"site": site, **d} for site, d in top
            ],
            "edges": edges,
        }


class TimedContentionLock:
    """A Lock/RLock wrapper feeding the contention ledger. Duck-types the
    full surface Condition needs (the lockwatch.WatchedLock contract), so
    it can wrap the engine's TimedRLock under the SMM Condition — both
    instrumentations compose, each seeing the layer below it."""

    def __init__(self, name: str | None = None, *, reentrant: bool = False,
                 _inner=None, _monitor: "ContentionMonitor | None" = None):
        self._inner = _inner if _inner is not None else (
            _REAL_RLOCK() if reentrant else _REAL_LOCK()
        )
        self.name = name or _allocation_site()
        self._mon = _monitor if _monitor is not None else _global
        self._acquired_at = 0.0
        self._depth = 0  # outermost-acquire hold timing under reentrancy

    def acquire(self, blocking: bool = True, timeout: float = -1):
        mon = self._mon
        if mon.noting():
            # the monitor's own bookkeeping (registry metric guards
            # constructed post-install are themselves timed) — raw
            # acquire, no instrumentation, no recursion
            return self._inner.acquire(blocking, timeout)
        clock = mon._clock
        if self._inner.acquire(False):
            self._note_got(clock(), 0.0, contended=False)
            return True
        if not blocking:
            # a failed try IS a contended acquire attempt — count the
            # site, but no wait window exists to time
            mon.note_blocked(self.name)
            return False
        waiter = mon.waiter_context()
        mon.note_blocked(self.name)
        t0 = clock()
        got = self._inner.acquire(True, timeout)
        wait = clock() - t0
        mon.note_edge_wait(self.name, waiter, wait)
        if got:
            self._note_got(clock(), wait, contended=True)
        return got

    def _note_got(self, now: float, wait_s: float, contended: bool) -> None:
        self._depth += 1
        if self._depth == 1:
            self._acquired_at = now
        self._mon.note_acquire(
            self.name, wait_s,
            contended or wait_s >= _CONTENDED_FLOOR_S,
        )

    def release(self):
        if self._mon.noting():
            self._inner.release()
            return
        self._depth -= 1
        if self._depth == 0:
            self._mon.note_release(
                self.name, self._mon._clock() - self._acquired_at
            )
        else:
            self._mon.note_release(self.name, 0.0)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked() if hasattr(self._inner, "locked") \
            else False

    def _at_fork_reinit(self):
        self._inner._at_fork_reinit()
        self._depth = 0

    # Condition's duck-typed hooks: wait() releases via _release_save and
    # reacquires via _acquire_restore. The reacquire after a notify IS a
    # contended window worth timing — a convoyed monitor shows up here.
    def _release_save(self):
        depth, self._depth = self._depth, 0
        self._mon.note_release(
            self.name, self._mon._clock() - self._acquired_at
        )
        if hasattr(self._inner, "_release_save"):
            return (depth, self._inner._release_save())
        self._inner.release()
        return (depth, None)

    def _acquire_restore(self, state):
        depth, inner_state = state
        t0 = self._mon._clock()
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(inner_state)
        else:
            self._inner.acquire()
        now = self._mon._clock()
        wait = now - t0
        self._depth = depth
        self._acquired_at = now
        self._mon.note_acquire(
            self.name, wait, contended=wait >= _CONTENDED_FLOOR_S
        )

    def _is_owned(self):
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __getattr__(self, name):
        if name in ("_inner", "_mon"):
            raise AttributeError(name)
        return getattr(self._inner, name)

    def __repr__(self):
        return f"<TimedContentionLock {self.name!r} " \
               f"wrapping {self._inner!r}>"


def timed_lock(name: str | None = None, *,
               reentrant: bool = False) -> TimedContentionLock:
    """An explicitly-named timed lock (the targeted-test / named-
    subsystem idiom)."""
    return TimedContentionLock(name or _allocation_site(),
                               reentrant=reentrant)


def wrap_lock(inner, name: str) -> TimedContentionLock:
    """Wrap an existing lock-like object (the engine's TimedRLock) so
    both instrumentations compose."""
    return TimedContentionLock(name, _inner=inner)


# ------------------------------------------------------------ install hook

_installed = False


def install() -> None:
    """Monkeypatch the threading lock factories so every lock built after
    this call is timed, named by allocation site. Pair with
    ``uninstall()``; composes with lockwatch (whichever installed last
    wraps the other's product)."""
    global _installed
    if _installed:
        return
    # Fully import the metrics registry BEFORE patching: the first timed
    # acquire imports it lazily, and running that import chain UNDER the
    # patch deadlocks — the chain spawns threads whose patched-lock
    # acquires block on the import lock the importing thread holds.
    from corda_tpu_torch.node.monitoring import node_metrics  # noqa: F401

    # ... and resolve the global monitor's contention.* metrics now, so
    # their own guard locks are REAL locks: a timed guard on the
    # acquires counter would re-note (and re-acquire itself) every time
    # registry.snapshot() touched it.
    _global._resolve_metrics()

    threading.Lock = lambda: TimedContentionLock()          # type: ignore
    threading.RLock = lambda: TimedContentionLock(          # type: ignore
        reentrant=True)

    def condition(lock=None):
        return _REAL_CONDITION(
            lock if lock is not None else TimedContentionLock(reentrant=True)
        )

    threading.Condition = condition                         # type: ignore
    _installed = True


def uninstall() -> None:
    global _installed
    if not _installed:
        return
    threading.Lock = _REAL_LOCK            # type: ignore
    threading.RLock = _REAL_RLOCK          # type: ignore
    threading.Condition = _REAL_CONDITION  # type: ignore
    _installed = False


def installed() -> bool:
    return _installed


# ------------------------------------------------ wait-site registry
#
# The sampler's blocked/running classifier matches sampled frames against
# this table: (filename suffix, function name) → cause. Registration is a
# dict insert — subsystems (WAL flush, scheduler dispatch wait, engine
# park) register their wait sites at import time at zero steady cost.

_WAIT_SITES: dict[tuple, str] = {
    # stdlib waits the classifier knows out of the box. A thread blocked
    # in a C-level lock acquire shows its innermost PYTHON frame — the
    # threading.py caller — which is exactly what these match.
    ("threading.py", "wait"): "lock_wait",
    ("threading.py", "acquire"): "lock_wait",
    ("threading.py", "_wait_for_tstate_lock"): "lock_wait",
    ("threading.py", "join"): "lock_wait",
    ("selectors.py", "select"): "io_wait",
    ("socket.py", "accept"): "io_wait",
    ("socket.py", "recv"): "io_wait",
    ("socket.py", "recv_into"): "io_wait",
    ("socket.py", "sendall"): "io_wait",
    ("ssl.py", "read"): "io_wait",
    ("ssl.py", "write"): "io_wait",
    ("queue.py", "get"): "lock_wait",
    ("queue.py", "put"): "lock_wait",
}


def register_wait_site(file_suffix: str, func: str, cause: str) -> None:
    """Teach the classifier a subsystem wait site: any sampled frame in
    ``file_suffix``'s ``func`` classifies its thread as ``cause``
    (``lock_wait`` / ``io_wait``). Registered sites take precedence over
    the stdlib table — a WAL group-commit Condition wait is io-wait even
    though the blocked frame is threading.py."""
    if cause not in ("lock_wait", "io_wait"):
        raise ValueError(f"unknown wait cause {cause!r}")
    _WAIT_SITES[(file_suffix, func)] = cause


def wait_sites() -> dict:
    """The classifier's site table (read by sampler.classify_frame)."""
    return _WAIT_SITES


def classify_frame(frame, max_depth: int = 16) -> str | None:
    """Walk a sampled stack innermost-first and return the first wait
    cause a registered site matches, or None (the thread is runnable).
    Registered (non-stdlib) sites win over the stdlib table anywhere in
    the top ``max_depth`` frames: the stdlib frame says *that* the
    thread waits, the subsystem frame says *why*."""
    stdlib_hit: str | None = None
    depth = 0
    while frame is not None and depth < max_depth:
        code = frame.f_code
        fn = code.co_filename
        key = (fn.rsplit("/", 1)[-1], code.co_name)
        cause = _WAIT_SITES.get(key)
        if cause is not None:
            if key[0] in ("threading.py", "queue.py", "selectors.py",
                          "socket.py", "ssl.py"):
                if stdlib_hit is None:
                    stdlib_hit = cause
            else:
                return cause
        frame = frame.f_back
        depth += 1
    return stdlib_hit


# ------------------------------------------------- process-global monitor

_global = ContentionMonitor()
_env_checked = False


def contention() -> ContentionMonitor:
    return _global


def active_contention() -> ContentionMonitor | None:
    """The hot-path check: the process monitor when contention timing is
    ON, else None. Two attribute reads when off (after the one-time env
    probe)."""
    global _env_checked
    if not _env_checked:
        _env_checked = True
        if os.environ.get("CORDA_TPU_CONTENTION", "") == "1":
            _global.enable()
            install()
    m = _global
    return m if m._enabled else None


def configure_contention(*, enabled: bool | None = None,
                         patch: bool = True,
                         reset: bool = False) -> ContentionMonitor:
    """The contention knob (docs/OBSERVABILITY.md §Concurrency
    observatory): flip the timing ledger on/off; ``patch=True`` (default)
    also installs/uninstalls the factory patch so new locks are timed.
    Explicit configuration overrides the ``CORDA_TPU_CONTENTION=1`` env
    probe."""
    global _env_checked
    _env_checked = True
    if reset:
        _global.reset()
    if enabled is not None:
        if enabled:
            _global.enable()
            if patch:
                install()
        else:
            _global.disable()
            if patch:
                uninstall()
    return _global


def contention_section(top_n: int = 16) -> dict:
    """The ``contention`` section of ``monitoring_snapshot()``: the full
    table while on, a bare disabled marker while off."""
    m = _global
    if not m._enabled:
        return {"enabled": False}
    return m.snapshot(top_n=top_n)


def prometheus_lines() -> list[str]:
    """Labeled ``cordatpu_contention_*`` families for the exposition
    endpoint (appended by ``metrics_text()`` when the monitor is on)."""
    from .exposition import escape_label_value as esc

    m = active_contention()
    if m is None:
        return []
    snap = m.snapshot(top_n=MAX_SITES)
    lines = [
        "# HELP cordatpu_contention_site_wait_seconds per-site blocked-"
        "acquire wait quantiles",
        "# TYPE cordatpu_contention_site_wait_seconds gauge",
        "# HELP cordatpu_contention_site_acquires_total per-site lock "
        "acquires",
        "# TYPE cordatpu_contention_site_acquires_total counter",
        "# HELP cordatpu_contention_site_contended_total per-site "
        "contended (blocked) acquires",
        "# TYPE cordatpu_contention_site_contended_total counter",
        "# HELP cordatpu_contention_wait_edge_total holder-site to "
        "waiter-site convoy observations",
        "# TYPE cordatpu_contention_wait_edge_total counter",
    ]
    for site, d in sorted(snap["sites"].items()):
        s = esc(site)
        lines.append(
            f'cordatpu_contention_site_acquires_total{{site="{s}"}} '
            f'{d["acquires"]}'
        )
        lines.append(
            f'cordatpu_contention_site_contended_total{{site="{s}"}} '
            f'{d["contended"]}'
        )
        for q in ("0.5", "0.95", "0.99"):
            key = {"0.5": "wait_p50_s", "0.95": "wait_p95_s",
                   "0.99": "wait_p99_s"}[q]
            lines.append(
                f'cordatpu_contention_site_wait_seconds{{site="{s}",'
                f'quantile="{q}"}} {d[key]:.9f}'
            )
    for e in snap["edges"]:
        lines.append(
            "cordatpu_contention_wait_edge_total"
            f'{{holder="{esc(e["holder"])}",waiter="{esc(e["waiter"])}"}} '
            f'{e["count"]}'
        )
    return lines
