"""The continuous-batching device scheduler (counterpart of corda_tpu/serving/scheduler.py).

One queue in front of the verify kernels, shared by every caller:

- requests enqueue with a priority class (``INTERACTIVE``, ``SERVICE``,
  ``BULK``) and an optional ``deadline_s`` (a flow's propagated deadline,
  ``flows.overload.remaining_deadline``, when none is given);
- a dispatcher thread launches a batch whenever the device pipeline has a
  free slot and work is pending (no batching window: coalescing comes from
  whatever arrived while the previous batch was in flight);
- each class has a reserved share of a batch; leftover capacity fills
  oldest-first across classes;
- admission is a bounded queue (``SchedulerSaturatedError``), and work past
  its deadline is shed at assembly and while waiting for a slot
  (``DeadlineExceededError``);
- the batch row cap adapts to arrival rate x device latency (EWMAs);
- device rows pad to the shape buckets of ``shapes.py``; a request may
  carry a ``min_bucket`` floor (the notary's window size), and an ed25519
  bucket that fills it takes the cofactored rule of the reference's RLC
  route unless ``batch_rlc`` is off;
- ed25519 rows run the ladder of the scheduler's ``Ed25519Tier`` (kernel
  B or G); the shared schedulers of ``device_scheduler`` are one a tier
  and ``batch_rlc`` setting;
- up to ``depth`` batches are in flight; a collector thread settles them
  in completion order (``serving.settle_reorder`` counts the reorders);
- host-routed requests (``use_device=False``) settle on a small host pool;
- a request holding a row that no engine verifies one signature of (a
  composite key, an unknown scheme) fails its own future with the
  ``CryptoError`` that ``is_valid`` raises, at once;
- ``submit_transactions`` is the transaction layer over ``submit_rows``,
  and ``FuturePending`` gives its future the two-phase ``collect()``.

Mesh scheduling: with more than one CUDA device (or ``mesh=True``, or
``CORDA_TPU_MESH=1``) batches stripe over the stripe set, every visible
ordinal (``parallel.mesh.device_for_ordinal``) less devicemon's evicted
ones and those the resilience policy blocks, each placed by power of two
choices over (in-flight depth, execute-wall EWMA). A full homogeneous
ed25519 bucket at or above ``megabatch_fill`` fuses into one mega-batch
over every ordinal, its consumed-set rows all-gathered, and the state
store's screen (kernel I) probes the gathered rows on the card.

Resilience (``resilience=`` a ``ResiliencePolicy``, or
``CORDA_TPU_RESILIENCE=1``): the ``serving.dispatch`` fault site sits in
front of every device dispatch (``serving.mesh_dispatch`` in front of a
mega-batch); an injected stall grafts onto the pending batch, which the
hedge thread re-runs on a sibling ordinal, else on the host, first result
winning; an injected fault or a ``ServingError`` strikes the ordinal and
re-queues the batch (the host settles it once the redispatch budget is
spent, counted as ``serving.device_failover``). A torch or CUDA error from
a launch or a build fails the batch's futures with that error: no
fallback hides a kernel. Where the hedge's leg has already settled a
batch, such an error from the device leg's readback is logged and counted
as ``serving.hedge.device_error`` (an injected fault or ``ServingError``
there, like a late readback, as ``serving.hedge.discarded``). Every kernel is built before the first device
dispatch on the card, so no deadline is armed on a batch that waits for
the build.

Counters: ``DeviceScheduler.counters`` keeps the port's per-scheduler
counts; the reference's ``serving.*`` meters, counters, timers and gauges
go to the process registry (``node_metrics()``), with the spans
(``serving.queue``, ``serving.batch``), flowprof, SLO and devicemon hooks
and the profiler's ``serving.batch`` kernel. At interpreter exit one
``atexit`` hook drains, in order, the live flow engines, the notary and
verifier services registered with ``drain_at_exit``, and then the shared
schedulers (``shutdown_scheduler``).
"""

from __future__ import annotations

import atexit
import hashlib
import logging
import math
import os
import queue as _queue
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future, InvalidStateError, ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutTimeout

import numpy as np

from ..crypto import EDDSA_ED25519_SHA512, CryptoError, is_valid
from ..device import resolve_device
from ..observability import NOOP_SPAN, SPAN_SERVING_BATCH, SPAN_SERVING_QUEUE, tracer
from ..observability.contention import register_wait_site
from ..observability.devicemon import active_devicemon
from ..observability.flowprof import active_flowprof
from ..observability.profiler import KERNEL_SERVING_DISPATCH, active_profiler, stamp_span
from ..observability.slo import active_slo
from ..ops.ed25519 import DEFAULT_TIER, Ed25519Tier
from ..verifier.batch import (
    check_schemes,
    dispatch_signature_rows,
    failover_kinds,
    flatten_signature_rows,
    tx_report_from_mask,
)
from .shapes import shape_table

_log = logging.getLogger(__name__)

# the sampler's classifier: dispatcher and hedge threads parked here wait
register_wait_site("scheduler.py", "_dispatch_loop", "lock_wait")
register_wait_site("scheduler.py", "_hedge_loop", "lock_wait")

INTERACTIVE = "interactive"  # flow hot path: singleton / few-row verifies
SERVICE = "service"          # verifier service traffic
BULK = "bulk"                # notary windows / bulk resolve sweeps

_CLASSES = (INTERACTIVE, SERVICE, BULK)
_RESERVED = {INTERACTIVE: 0.25, SERVICE: 0.25, BULK: 0.5}
_MIN_BATCH_ROWS = 256  # the adaptive row cap's floor (its ceiling is the
                       # largest bucket of shapes.json)
_HOST_WORKERS = 4      # threads settling host-routed requests

COUNTER_NAMES = (
    "serving.requests", "serving.rows", "serving.batches", "serving.rejected",
    "serving.shed", "serving.settle_reorder",
    # the reference's fill-ratio gauge inputs (its _real_rows, _padded_rows):
    # rows sent to the device and the lanes their buckets padded to
    "serving.device_rows", "serving.padded_lanes",
)


class ServingError(Exception):
    """Base for scheduler-side request failures."""


class SchedulerClosedError(ServingError):
    pass


class SchedulerSaturatedError(ServingError):
    """Admission control: the bounded queue is full."""


class DeadlineExceededError(ServingError):
    """The request aged past its deadline before a device slot opened."""


class RowResult:
    """A row submission's result: the (N,) bool verdict mask, the rows that
    settled on the device, the sequence number of the batch that served it
    (shared by every request coalesced into that batch), and the ordinal
    the batch ran on (None when host-settled or fused over the mesh)."""

    __slots__ = ("mask", "n_device", "batch_seq", "device")

    def __init__(self, mask: np.ndarray, n_device: int, batch_seq: int,
                 device: int | None = None):
        self.mask = mask
        self.n_device = n_device
        self.batch_seq = batch_seq
        self.device = device


class _Request:
    __slots__ = ("rows", "future", "priority", "use_device", "enqueued_at",
                 "deadline", "min_bucket", "queue_span", "redispatches", "acct")

    def __init__(self, rows, future, priority, use_device, enqueued_at, deadline,
                 min_bucket=None, queue_span=NOOP_SPAN, acct=None):
        self.rows = rows
        self.future = future
        self.priority = priority
        self.use_device = use_device
        self.enqueued_at = enqueued_at
        self.deadline = deadline
        self.min_bucket = min_bucket
        # the open serving.queue span: finished when the request leaves the
        # queue for a batch
        self.queue_span = queue_span
        # times this request re-entered the queue after a failed dispatch
        self.redispatches = 0
        # the submitting flow's flowprof account (None when untracked)
        self.acct = acct


class _InFlight:
    """One dispatched device batch: the pending rows (no readback yet),
    where each request's rows start in the batch (they are contiguous), and
    the hedge state: its ``deadline``, whether the hedge fired, which side
    completed the futures (``winner``, claimed once under the lock) and
    whether its depth slot was released (once)."""

    __slots__ = ("requests", "pending", "n_rows", "starts", "seq", "t0", "span",
                 "device", "compile_keys", "mesh_ordinals", "deadline", "hedged",
                 "winner", "slot_freed")

    def __init__(self, requests, pending, n_rows, starts, seq, t0, span=NOOP_SPAN,
                 device=None, compile_keys=frozenset(), mesh_ordinals=()):
        self.requests = requests
        self.pending = pending
        self.n_rows = n_rows
        self.starts = starts
        self.seq = seq
        self.t0 = t0
        self.span = span               # serving.batch span, finished at settle
        self.device = device           # the ordinal the dispatch ran on
        self.compile_keys = compile_keys  # shapes this dispatch touched
        self.mesh_ordinals = tuple(mesh_ordinals)  # a mega-batch's ordinals
        self.deadline = None           # monotonic hedge deadline (None: unhedged)
        self.hedged = False
        self.winner = None             # None | "device" | "sibling" | "host"
        self.slot_freed = False


def _metrics():
    from ..node.monitoring import node_metrics

    return node_metrics()


def _pending_ready(pending) -> bool:
    """Non-blocking probe of an in-flight batch; a pending without
    ``ready`` reads as not ready (the collector then blocks on it)."""
    probe = getattr(pending, "ready", None)
    return bool(probe()) if probe is not None else False


def _complete(future: Future, result=None, error: Exception | None = None):
    """Complete a future, tolerating one the caller cancelled."""
    try:
        if error is None:
            future.set_result(result)
        else:
            future.set_exception(error)
    except InvalidStateError:
        pass


def _host_mask(rows) -> np.ndarray:
    """The host oracle's verdicts on rows (the reference's host path)."""
    return np.array([is_valid(k, s, m) for k, s, m in rows], dtype=bool)


def _consumed_rows(msgs: list[bytes]) -> np.ndarray:
    """Per-row consumed-state digests for the mega-batch's gather: the (N,
    8) int32 view of each signed payload's SHA-256."""
    out = np.zeros((len(msgs), 8), dtype=np.int32)
    for i, msg in enumerate(msgs):
        out[i] = np.frombuffer(hashlib.sha256(msg).digest(), dtype="<i4")
    return out


class _MeshPending:
    """The pending of one fused mega-batch: the bucket-padded verdict mask,
    the all-gathered consumed-set rows and the psum'd accept count, all on
    the card; every row a device row, in dispatch order. A readback that
    fails with an injected fault or a ``ServingError`` settles on the host
    at ``collect()``. ``statestore_hits`` is the state store's screen (a
    device scalar), harvested at ``collect()``."""

    __slots__ = ("_rows", "_mask", "spent_all", "total_valid", "_n",
                 "device_rows", "device_mask", "padded_lanes", "stall_until",
                 "statestore_hits", "_copy")

    def __init__(self, rows: list, mask, spent_all, total, bucket: int):
        from ..ops._blockpack import start_host_copy

        self._rows = rows
        self._mask = mask
        self.spent_all = spent_all
        self.total_valid = total
        self._n = len(rows)
        self.device_rows = len(rows)
        self.device_mask = np.ones(len(rows), dtype=bool)
        self.padded_lanes = int(bucket)
        self.stall_until = None
        self.statestore_hits = None
        self._copy = start_host_copy(mask)

    def inject_stall(self, delay_s: float) -> None:
        if delay_s <= 0:
            return
        horizon = time.monotonic() + delay_s
        self.stall_until = max(self.stall_until or 0.0, horizon)

    def ready(self) -> bool:
        from ..ops._blockpack import result_ready

        if self.stall_until is not None and time.monotonic() < self.stall_until:
            return False
        return result_ready(self._copy)

    def collect(self) -> np.ndarray:
        if self.stall_until is not None:
            delay = self.stall_until - time.monotonic()
            if delay > 0:
                time.sleep(delay)
        try:
            out = self._copy.wait()[: self._n].astype(bool)
        except Exception as e:
            if not isinstance(e, failover_kinds()):
                raise
            _metrics().counter("serving.mesh.megabatch_failover").inc()
            self.device_rows = 0
            self.device_mask[:] = False
            return _host_mask(self._rows)
        if self.statestore_hits is not None:
            hits = int(self.statestore_hits)
            m = _metrics()
            m.counter("statestore.mega_probe_rows").inc(self._n)
            m.counter("statestore.mega_probe_hits").inc(hits)
        return out


class DeviceScheduler:
    """One continuous-batching loop over the verify kernels on ``device``
    (the card unless ``device="cpu"``), its ed25519 rows on the ladder of
    ``tier`` (``DEFAULT_TIER`` when None), full ed25519 buckets under the
    cofactored rule unless ``batch_rlc`` is off. ``shapes`` overrides the
    pad-bucket table, ``resilience`` attaches a ``ResiliencePolicy`` (None
    reads ``CORDA_TPU_RESILIENCE``, False pins it off), ``mesh`` stripes
    over the visible ordinals (None reads ``CORDA_TPU_MESH``, else on with
    more than one CUDA device) and ``megabatch_fill`` is the bucket fill at
    which a full ed25519 batch fuses over the mesh
    (``CORDA_TPU_MESH_MEGABATCH_FILL``, 0.85). Construct directly for
    tests; production code shares the process-global instance of its tier
    and setting via ``device_scheduler()``."""

    def __init__(
        self,
        *,
        device=None,
        tier: Ed25519Tier | None = None,
        batch_rlc: bool = True,
        max_queue_rows: int = 131072,
        depth: int = 3,
        shapes=None,
        resilience=None,
        mesh: bool | None = None,
        megabatch_fill: float | None = None,
    ):
        self.device = resolve_device(device)
        self.tier = tier or DEFAULT_TIER
        self.batch_rlc = batch_rlc
        self._shapes = shapes or shape_table()
        if resilience is None and os.environ.get(
            "CORDA_TPU_RESILIENCE", ""
        ).strip().lower() in ("1", "true", "on", "yes"):
            from .resilience import ResiliencePolicy

            resilience = ResiliencePolicy()
        self._resilience = resilience or None
        self._max_queue_rows = max_queue_rows
        self._lock = threading.Condition()
        self._queues: dict[str, deque] = {c: deque() for c in _CLASSES}
        self._queued_rows = 0
        self._closed = False
        self._paused = False
        self._seq = 0
        self._depth = max(1, depth)
        self._inflight_q: _queue.Queue = _queue.Queue()
        self._inflight = 0
        self._host_pool = ThreadPoolExecutor(
            max_workers=_HOST_WORKERS, thread_name_prefix="serving-host"
        )
        self._counter_lock = threading.Lock()
        self.counters: dict[str, int] = {name: 0 for name in COUNTER_NAMES}
        # the ordinal of a single-device dispatch
        self._ordinal = self.device.index if self.device.index is not None else 0
        self._built = False             # every kernel built (the card only)
        # ---- mesh striping state, under self._lock ----
        self._mesh = mesh
        if megabatch_fill is None:
            try:
                megabatch_fill = float(os.environ.get("CORDA_TPU_MESH_MEGABATCH_FILL", "0.85"))
            except ValueError:
                megabatch_fill = 0.85
        self._megabatch_fill = max(0.0, megabatch_fill)
        self._devices = None            # ordinal -> torch.device (lazy)
        self._mesh_verifier = None      # the mega-batch's MeshVerifier (lazy)
        self._ord_inflight: dict[int, int] = {}
        self._ord_ewma: dict[int, float] = {}
        self._ord_dispatches: dict[int, int] = {}
        self._place_seq = 0
        self._stripe_width = 0
        self._mesh_spread_max = 0
        self._arrival_rate = 0.0
        self._arrival_last = time.monotonic()
        self._latency_ewma = 0.0
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="serving-dispatch", daemon=True
        )
        self._collector = threading.Thread(
            target=self._collect_loop, name="serving-collect", daemon=True
        )
        self._hedge_entries: list[_InFlight] = []
        self._reapers: list[threading.Thread] = []
        # (scheme, bucket, placement) shapes that settled on a device once:
        # only batches whose every shape is warm get a hedge deadline
        self._warm_keys: set = set()
        self._hedge: threading.Thread | None = None
        _register_process_gauges()
        if self._resilience is not None:
            self._resilience.attach(self)
            self._hedge = threading.Thread(
                target=self._hedge_loop, name="serving-hedge", daemon=True
            )
        self._dispatcher.start()
        self._collector.start()
        if self._hedge is not None:
            self._hedge.start()

    def _bump(self, name: str, n: int = 1) -> None:
        with self._counter_lock:
            self.counters[name] += n

    # ------------------------------------------------------------- submit
    @property
    def closed(self) -> bool:
        return self._closed

    def submit_rows(self, rows: list, *, priority: str = SERVICE,
                    deadline_s: float | None = None,
                    use_device: bool = True, min_bucket: int | None = None,
                    trace=None) -> Future:
        """Enqueue (PublicKey, signature, message) rows; the Future resolves
        to a ``RowResult``. ``min_bucket`` is a floor for the pad bucket of
        the batch that carries them; ``trace`` an explicit parent span for
        a caller on another thread than the traced request's. Raises
        ``SchedulerClosedError`` or ``SchedulerSaturatedError`` at once. A
        request with a row that no engine verifies one signature of fails
        its future with the ``CryptoError`` at once and is never batched."""
        if priority not in _CLASSES:
            raise ValueError(f"unknown priority class {priority!r}")
        if deadline_s is None:
            from ..flows.overload import remaining_deadline

            rem = remaining_deadline()
            if rem is not None:
                deadline_s = max(0.0, rem)
        rows = list(rows)
        try:
            check_schemes(rows)
            refused = None
        except CryptoError as e:
            refused = e
        fut: Future = Future()
        if not rows:
            fut.set_result(RowResult(np.zeros(0, dtype=bool), 0, -1))
            return fut
        trc = tracer()
        queue_span = trc.start(
            SPAN_SERVING_QUEUE, trace if trace is not None else trc.current(),
            attrs={"priority": priority, "rows": len(rows)},
        )
        now = time.monotonic()
        fp = active_flowprof()
        req = _Request(rows, fut, priority, use_device, now,
                       None if deadline_s is None else now + deadline_s, min_bucket,
                       queue_span=queue_span, acct=fp.current() if fp is not None else None)
        with self._lock:
            if self._closed:
                err = SchedulerClosedError("device scheduler is shut down")
                queue_span.set_error(err)
                queue_span.finish()
                raise err
            if self._queued_rows + len(rows) > self._max_queue_rows:
                self._bump("serving.rejected")
                _metrics().counter("serving.rejected").inc()
                slo = active_slo()
                if slo is not None:
                    slo.observe(priority, None, error=True)
                err = SchedulerSaturatedError(
                    f"serving queue full ({self._queued_rows} rows queued, "
                    f"bound {self._max_queue_rows})"
                )
                queue_span.set_error(err)
                queue_span.finish()
                raise err
            if refused is not None:
                queue_span.set_error(refused)
                queue_span.finish()
                fut.set_exception(refused)
                return fut
            self._queues[priority].append(req)
            self._queued_rows += len(rows)
            dt = now - self._arrival_last
            if dt > 0:
                alpha = 1.0 - math.exp(-dt / 5.0)
                self._arrival_rate += alpha * (len(rows) / dt - self._arrival_rate)
                self._arrival_last = now
            self._lock.notify_all()
        self._bump("serving.requests")
        self._bump("serving.rows", len(rows))
        m = _metrics()
        m.meter("serving.requests").mark()
        m.meter("serving.rows").mark(len(rows))
        return fut

    def submit_transactions(self, stxs: list, allowed_missing: list | None = None,
                            *, priority: str = SERVICE,
                            deadline_s: float | None = None,
                            use_device: bool = True,
                            min_bucket: int | None = None, trace=None) -> Future:
        """Enqueue the signature half of a batched transaction check; the
        Future resolves to a ``BatchVerifyReport`` equal to
        ``verifier.check_transactions``' (the same row algebra, shared
        code). Host-routed windows (``use_device=False``) settle on the
        host pool, as ``submit_rows`` does."""
        if allowed_missing is None:
            allowed_missing = [set()] * len(stxs)
        if len(allowed_missing) != len(stxs):
            raise ValueError("allowed_missing length mismatch")
        rows, row_tx, row_sig = flatten_signature_rows(stxs)
        inner = self.submit_rows(rows, priority=priority, deadline_s=deadline_s,
                                 use_device=use_device, min_bucket=min_bucket, trace=trace)
        out: Future = Future()

        def finish(f: Future):
            try:
                rr: RowResult = f.result()
                _complete(out, result=tx_report_from_mask(
                    stxs, allowed_missing, rr.mask, row_tx, row_sig,
                    rr.n_device, batch_seq=rr.batch_seq, device=rr.device,
                ))
            except Exception as e:
                _complete(out, error=e)

        inner.add_done_callback(finish)
        return out

    # ---------------------------------------------------------- test hooks
    def pause(self) -> None:
        """Hold batch assembly (deterministic coalescing in tests)."""
        with self._lock:
            self._paused = True

    def resume(self) -> None:
        with self._lock:
            self._paused = False
            self._lock.notify_all()

    # ------------------------------------------------------------ dispatch
    def _has_work_locked(self) -> bool:
        return any(self._queues[c] for c in _CLASSES)

    def _dispatch_loop(self) -> None:
        while True:
            with self._lock:
                while not self._closed and (self._paused or not self._has_work_locked()):
                    self._lock.wait(timeout=0.5)
                if self._closed and not self._has_work_locked():
                    break
                batch, shed = self._assemble_locked()
            if shed:
                self._fail_shed(shed)
            if not batch:
                continue
            # bounded in-flight pipeline: wait for a free device slot before
            # enqueueing, shedding members whose deadline passes meanwhile;
            # host-only batches skip the wait
            if any(r.use_device for r in batch):
                late: list = []
                with self._lock:
                    while self._inflight >= self._depth:
                        self._lock.wait(timeout=0.5)
                        now = time.monotonic()
                        expired = [r for r in batch
                                   if r.deadline is not None and now > r.deadline]
                        if expired:
                            late += expired
                            batch = [r for r in batch if r not in expired]
                            if not any(r.use_device for r in batch):
                                break
                if late:
                    self._fail_shed(late)
                if not batch:
                    continue
            try:
                entry = self._dispatch(batch)
            except Exception as e:  # never lose futures: fail them with the error
                for r in batch:
                    _complete(r.future, error=e)
                continue
            if entry is None:
                continue
            with self._lock:
                self._inflight += 1
            # armed after the slot accounting: a deadline firing in between
            # would release a slot never counted
            self._arm_hedge(entry)
            self._inflight_q.put(entry)
        self._inflight_q.put(None)

    def _fail_shed(self, requests: list) -> None:
        self._bump("serving.shed", len(requests))
        _metrics().counter("serving.shed").inc(len(requests))
        slo = active_slo()
        fp = active_flowprof()
        now = time.monotonic()
        for r in requests:
            if slo is not None:
                slo.observe(r.priority, now - r.enqueued_at, error=True)
            if fp is not None:
                fp.add(r.acct, "queue_wait", now - r.enqueued_at)
            err = DeadlineExceededError("request shed: deadline passed while queued")
            r.queue_span.set_error(err)
            r.queue_span.finish()
            _complete(r.future, error=err)

    def _requeue_failed(self, dev_reqs: list) -> list:
        """Put failed device requests back at the front of their queues with
        their original arrival times (verification is pure, so re-running
        it is safe; the futures stay pending). Returns the requests whose
        redispatch budget is spent: the caller settles them on the host."""
        pol = self._resilience
        retry = [r for r in dev_reqs if r.redispatches < pol.redispatch_limit]
        rest = [r for r in dev_reqs if r.redispatches >= pol.redispatch_limit]
        if retry:
            _metrics().counter("serving.redispatch").inc(len(retry))
            with self._lock:
                for r in reversed(retry):
                    r.redispatches += 1
                    r.queue_span = NOOP_SPAN  # its wait was recorded at dispatch
                    self._queues[r.priority].appendleft(r)
                    self._queued_rows += len(r.rows)
                self._lock.notify_all()
        return rest

    # ---------------------------------------------------- mesh placement
    def _mesh_on(self) -> bool:
        """The striping switch, resolved once by ``mesh_switch``: the
        constructor's value, else ``CORDA_TPU_MESH``, else on exactly when
        more than one CUDA device is visible and this scheduler runs on the
        card."""
        if self._mesh is None:
            from ..parallel.mesh import mesh_switch

            self._mesh = mesh_switch(None, "CORDA_TPU_MESH", self.device)
        return self._mesh

    def _ensure_devices(self) -> dict:
        if self._devices is None:
            from ..parallel.mesh import device_for_ordinal, visible_devices

            self._devices = {o: device_for_ordinal(o)
                             for o in range(len(visible_devices()))}
        return self._devices

    def _stripe_set(self) -> list[int]:
        """The ordinals a batch may be placed on: every visible one less
        devicemon's unhealthy ones and those the policy blocks. Empty means
        the whole mesh is down: the caller host-routes."""
        ordinals = sorted(self._ensure_devices())
        mon = active_devicemon()
        if mon is not None:
            bad = mon.unhealthy_ordinals()
            ordinals = [o for o in ordinals if o not in bad]
        pol = self._resilience
        if pol is not None:
            ordinals = [o for o in ordinals if pol.admit_ordinal(o)]
        with self._lock:
            self._stripe_width = len(ordinals)
        return ordinals

    def mesh_stripe_width(self) -> int:
        """How many ordinals the scheduler stripes over (0 with mesh
        scheduling off); pipelined callers keep at least one window in
        flight a stripe member."""
        if not self._mesh_on():
            return 0
        return len(self._stripe_set())

    def _place_locked(self, eligible: list[int]) -> int:
        """Power of two choices (lock held): a rotating candidate races the
        least loaded one on (in-flight depth, execute-wall EWMA); reserves
        one depth unit on the pick, released once at settle."""
        self._place_seq += 1

        def score(o):
            return (self._ord_inflight.get(o, 0), self._ord_ewma.get(o, 0.0))

        c1 = eligible[self._place_seq % len(eligible)]
        c2 = min(eligible, key=score)
        pick = c1 if score(c1) <= score(c2) else c2
        self._ord_inflight[pick] = self._ord_inflight.get(pick, 0) + 1
        depths = [self._ord_inflight.get(o, 0) for o in eligible]
        self._mesh_spread_max = max(self._mesh_spread_max, max(depths) - min(depths))
        return pick

    def _ord_release(self, ordinal: int | None) -> None:
        """Return one reserved per-ordinal depth unit."""
        if ordinal is None:
            return
        with self._lock:
            d = self._ord_inflight.get(ordinal, 0)
            if d > 0:
                self._ord_inflight[ordinal] = d - 1

    def _pick_sibling(self, exclude: int) -> int | None:
        """The least loaded eligible ordinal other than the stalled one,
        with a depth unit reserved on it."""
        stripe = [o for o in self._stripe_set() if o != exclude]
        if not stripe:
            return None
        with self._lock:
            pick = min(stripe, key=lambda o: (self._ord_inflight.get(o, 0),
                                              self._ord_ewma.get(o, 0.0)))
            self._ord_inflight[pick] = self._ord_inflight.get(pick, 0) + 1
        return pick

    def _mega_eligible(self, dev_rows, bucket, stripe) -> bool:
        """A mega-batch fuses one high-fill all-ed25519 bucket over the
        whole mesh: one ordinal out of the stripe vetoes it."""
        if len(stripe) < 2 or len(stripe) != len(self._ensure_devices()):
            return False
        if bucket is None or len(dev_rows) < self._megabatch_fill * bucket:
            return False
        return all(getattr(k, "scheme_id", None) == EDDSA_ED25519_SHA512
                   for k, _s, _m in dev_rows)

    def _dispatch_mega(self, dev_rows: list, bucket: int) -> _MeshPending:
        """Fuse one full bucket into a mega-batch over every ordinal: each
        verifies its shard (kernels A and B or G), the consumed-set rows
        come back all-gathered, and the state store's screen (kernel I)
        probes them where they lie. Devicemon's per-ordinal attribution is
        the mesh verifier's."""
        from ..parallel.mesh import MeshVerifier, make_mesh
        from ..statestore import active_mega_screen

        if self._mesh_verifier is None:
            self._mesh_verifier = MeshVerifier(make_mesh(), tier=self.tier)
        keys = [k.encoded for k, _s, _m in dev_rows]
        sigs = [s for _k, s, _m in dev_rows]
        msgs = [m for _k, _s, m in dev_rows]
        mask, spent_all, total = self._mesh_verifier.dispatch_rows(
            keys, sigs, msgs, min_bucket=bucket, spent_hashes=_consumed_rows(msgs),
        )
        pending = _MeshPending(dev_rows, mask, spent_all, total, bucket=int(mask.shape[0]))
        screen = active_mega_screen()
        if screen is not None:
            pending.statestore_hits = screen(spent_all, len(dev_rows))
        return pending

    # ------------------------------------------------------------- hedging
    def _arm_hedge(self, entry: _InFlight) -> None:
        """Give a dispatched batch its in-flight deadline (the policy's) and
        hand it to the hedge thread. No policy, no ordinal, no EWMA yet, or
        a shape not yet settled once leaves it unarmed."""
        pol = self._resilience
        if pol is None or entry.device is None:
            return
        with self._lock:
            ewma = self._latency_ewma
            if not entry.compile_keys <= self._warm_keys:
                return
        deadline_s = pol.hedge_deadline_s(entry.device, ewma)
        if deadline_s is None:
            return
        with self._lock:
            if entry.winner is not None:
                return
            entry.deadline = entry.t0 + deadline_s
            self._hedge_entries.append(entry)
            self._lock.notify_all()

    def _hedge_loop(self) -> None:
        """Wakes for the earliest armed deadline, hedges expired batches,
        and runs any due canary probe."""
        while True:
            due: list[_InFlight] = []
            with self._lock:
                if self._closed and not self._hedge_entries:
                    break
                now = time.monotonic()
                nxt = None
                for e in list(self._hedge_entries):
                    if e.winner is not None:
                        self._hedge_entries.remove(e)
                    elif now >= e.deadline:
                        due.append(e)
                        self._hedge_entries.remove(e)
                    elif nxt is None or e.deadline < nxt:
                        nxt = e.deadline
                if not due:
                    self._lock.wait(timeout=0.2 if nxt is None
                                    else min(max(nxt - now, 0.001), 0.2))
            pol = self._resilience
            if pol is not None:
                pol.maybe_probe()
            for e in due:
                self._fire_hedge(e)

    def _fire_hedge(self, entry: _InFlight) -> None:
        """A batch blew its deadline: release its depth slot and re-run it
        on a sibling ordinal (mesh mode), else on the host; the first
        result wins and the device's late readback is discarded."""
        with self._lock:
            if entry.winner is not None:
                return
            entry.hedged = True
            if not entry.slot_freed:
                entry.slot_freed = True
                self._inflight -= 1
            self._lock.notify_all()
        _metrics().counter("serving.hedge.fired").inc()
        entry.span.set_attr("hedged", True)
        pol = self._resilience
        if pol is not None and entry.device is not None:
            pol.on_hedge_fired(entry.device)
        sibling = None
        if entry.device is not None and self._mesh_on():
            sibling = self._pick_sibling(entry.device)
        try:
            if sibling is not None:
                self._host_pool.submit(self._settle_hedge_sibling, entry, sibling)
            else:
                self._host_pool.submit(self._settle_hedge_host, entry)
        except RuntimeError:  # the pool is shut down: settle inline
            if sibling is not None:
                self._ord_release(sibling)
            self._settle_hedge_host(entry)

    def _settle_hedge_sibling(self, entry: _InFlight, ordinal: int) -> None:
        """The hedge's sibling leg: re-dispatch the stalled batch on
        ``ordinal``. An injected fault or a ``ServingError`` there (a second
        stall past its own deadline is one) falls through to the host leg;
        another error fails the batch's futures unless the original device
        settled first. Every exit releases the reserved depth unit."""
        m = _metrics()
        m.counter("serving.hedge.rerouted").inc()
        mon = active_devicemon()
        dispatched = False
        t0 = time.monotonic()
        try:
            device = self._ensure_devices()[ordinal]
            dev_rows = [row for r in entry.requests for row in r.rows]
            floor = max((r.min_bucket or 0 for r in entry.requests), default=0)
            bucket = self._shapes.bucket_for(len(dev_rows), floor)
            pending = dispatch_signature_rows(
                dev_rows, min_bucket=bucket, device=device, tier=self.tier,
                batch_rlc=self.batch_rlc,
            )
            padded = getattr(pending, "padded_lanes", 0) or len(dev_rows)
            if mon is not None:
                mon.record_dispatch(ordinal, rows=len(dev_rows), padded_lanes=padded)
            dispatched = True
            pol = self._resilience
            deadline_s = (pol.hedge_deadline_s(ordinal, self._latency_ewma)
                          if pol is not None else None)
            deadline = None if deadline_s is None else t0 + deadline_s
            while not _pending_ready(pending):
                if deadline is not None and time.monotonic() >= deadline:
                    raise ServingError(f"sibling ordinal {ordinal} stalled too")
                time.sleep(0.005)
            mask = pending.collect().astype(bool, copy=False)
            wall = time.monotonic() - t0
            if mon is not None:
                mon.record_settle(ordinal, wall)
        except Exception as e:
            if mon is not None and dispatched:
                mon.record_settle(ordinal, time.monotonic() - t0, ok=False, ewma=False)
            self._ord_release(ordinal)
            if isinstance(e, failover_kinds()):
                self._settle_hedge_host(entry)
                return
            with self._lock:
                if entry.winner is not None:
                    return
                entry.winner = "sibling"
            entry.span.set_error(e)
            for r in entry.requests:
                _complete(r.future, error=e)
            return
        self._ord_release(ordinal)
        with self._lock:
            if entry.winner is not None:
                return  # the original device landed first
            entry.winner = "sibling"
        m.counter("serving.hedge.won_sibling").inc()
        entry.span.set_attr("hedge_winner", "sibling")
        pol = self._resilience
        if pol is not None:
            if entry.device is not None:
                pol.on_hedge_won_sibling(entry.device)
            pol.on_settle_ok(ordinal)
        on_device = getattr(pending, "device_mask", None)
        slo = active_slo()
        fp = active_flowprof()
        now = time.monotonic()
        k = 0
        for r in entry.requests:
            n = len(r.rows)
            nd = int(on_device[k:k + n].sum()) if on_device is not None else 0
            if slo is not None:
                slo.observe(r.priority, now - r.enqueued_at)
            if fp is not None:
                fp.add(r.acct, "device_execute", wall)
            _complete(r.future, result=RowResult(mask[k:k + n].copy(), nd, entry.seq,
                                                 device=ordinal))
            k += n

    def _settle_hedge_host(self, entry: _InFlight) -> None:
        """The hedge's host leg: verify every request on the host, then
        claim the win unless the device settled meanwhile."""
        outcomes: list = []  # (mask, error, host wall) a request
        for r in entry.requests:
            t_verify = time.monotonic()
            try:
                outcomes.append((_host_mask(r.rows), None, time.monotonic() - t_verify))
            except Exception as e:
                outcomes.append((None, e, time.monotonic() - t_verify))
        with self._lock:
            if entry.winner is not None:
                return
            entry.winner = "host"
        _metrics().counter("serving.hedge.won_host").inc()
        entry.span.set_attr("hedge_winner", "host")
        pol = self._resilience
        if pol is not None and entry.device is not None:
            pol.on_hedge_won_host(entry.device)
        slo = active_slo()
        fp = active_flowprof()
        now = time.monotonic()
        for r, (mask, err, verify_wall) in zip(entry.requests, outcomes):
            if fp is not None:
                fp.add(r.acct, "host_verify", verify_wall)
            if slo is not None:
                slo.observe(r.priority, now - r.enqueued_at, error=err is not None)
            if err is None:
                _complete(r.future, result=RowResult(mask, 0, entry.seq))
            else:
                _complete(r.future, error=err)

    def _assemble_locked(self) -> tuple[list, list]:
        """Shed over-deadline work, then assemble one batch under the
        adaptive row cap honouring the reserved shares. Requests are never
        split across batches."""
        now = time.monotonic()
        shed: list = []
        for q in self._queues.values():
            expired = [r for r in q if r.deadline is not None and now > r.deadline]
            if expired:
                for r in expired:
                    q.remove(r)
                    self._queued_rows -= len(r.rows)
                shed += expired
        target = self._arrival_rate * max(self._latency_ewma, 1e-4)
        cap = int(min(self._shapes.max_bucket, max(_MIN_BATCH_ROWS, target)))
        batch: list = []
        taken = 0

        def pop_into(cls):
            nonlocal taken
            r = self._queues[cls].popleft()
            self._queued_rows -= len(r.rows)
            batch.append(r)
            taken += len(r.rows)

        # phase 1: each class's reserved share (an oversize first request
        # is admitted whole)
        for cls in _CLASSES:
            share = max(1, int(cap * _RESERVED[cls]))
            used = 0
            q = self._queues[cls]
            while q and taken < cap and (used == 0 or used + len(q[0].rows) <= share):
                used += len(q[0].rows)
                pop_into(cls)
        # phase 2: leftover capacity, oldest first across classes
        while taken < cap:
            live = [c for c in _CLASSES if self._queues[c]]
            if not live:
                break
            cls = min(live, key=lambda c: self._queues[c][0].enqueued_at)
            if batch and taken + len(self._queues[cls][0].rows) > cap:
                break
            pop_into(cls)
        return batch, shed

    def _ensure_built(self) -> None:
        """Build every kernel before the first device dispatch on the card,
        so no batch (and no hedge deadline) waits for the build."""
        if not self._built:
            from ..ops import _build

            _build.kernels()
            self._built = True

    def _dispatch(self, batch: list) -> _InFlight | None:
        """Enqueue one shape-bucketed device dispatch for the device rows
        (no readback) and hand host-routed requests to the host pool.
        Returns the in-flight entry, or None when nothing went to a
        device."""
        from ..faultinject import check_site

        t0 = time.monotonic()
        m = _metrics()
        with self._lock:
            self._seq += 1
            seq = self._seq
        self._bump("serving.batches")
        wait_t = m.timer("serving.wait_s")
        fp = active_flowprof()
        for r in batch:
            wait_t.update(t0 - r.enqueued_at, exemplar=r.queue_span.trace_id or None)
            if fp is not None:
                fp.add(r.acct, "queue_wait", t0 - r.enqueued_at)
        m.meter("serving.batches").mark()
        m.timer("serving.batch_occupancy").update(float(len(batch)))
        # one serving.batch span a batch, parented under the first sampled
        # member's queue span and linked to every sampled member
        batch_span = NOOP_SPAN
        for r in batch:
            qs = r.queue_span
            if qs.sampled:
                qs.set_attr("batch_seq", seq)
                if not batch_span.sampled:
                    batch_span = tracer().start(
                        SPAN_SERVING_BATCH, qs,
                        attrs={"batch_seq": seq, "n_requests": len(batch)},
                    )
                batch_span.add_link(qs)
            qs.finish()
        dev_reqs = [r for r in batch if r.use_device]
        host_reqs = [r for r in batch if not r.use_device]
        pending = None
        dev_rows: list = []
        starts: list = []
        ordinal = None
        placed = False
        mesh_on = False
        mega = False
        stripe: list = []
        compile_keys: frozenset = frozenset()
        mesh_ordinals: tuple = ()
        pol = self._resilience
        if dev_reqs:
            mesh_on = self._mesh_on()
        if dev_reqs and mesh_on:
            stripe = self._stripe_set()
            if not stripe:
                m.counter("serving.mesh.no_eligible").inc()
                batch_span.set_attr("resilience_host_routed", True)
                host_reqs, dev_reqs = host_reqs + dev_reqs, []
        elif dev_reqs and pol is not None:
            # the single-device gate: an open breaker or a quarantined
            # ordinal routes the whole device cohort to the host
            ordinal = self._ordinal
            if not pol.admit_device(ordinal):
                batch_span.set_attr("resilience_host_routed", True)
                host_reqs, dev_reqs = host_reqs + dev_reqs, []
        if dev_reqs:
            for r in dev_reqs:
                starts.append(len(dev_rows))
                dev_rows.extend(r.rows)
            floor = max((r.min_bucket or 0 for r in dev_reqs), default=0)
            bucket = self._shapes.bucket_for(len(dev_rows), floor)
            device = self.device
            if mesh_on:
                mega = self._mega_eligible(dev_rows, bucket, stripe)
                if mega:
                    mesh_ordinals = tuple(sorted(self._ensure_devices()))
                else:
                    with self._lock:
                        ordinal = self._place_locked(stripe)
                    placed = True
                    device = self._ensure_devices()[ordinal]
            elif ordinal is None:
                ordinal = self._ordinal
            # a shape is warm once it settled on its placement
            compile_keys = frozenset(
                (getattr(k, "scheme_id", None), bucket, "mesh" if mega else ordinal)
                for k, _s, _m in dev_rows
            )

            def lanes_of(p):
                return getattr(p, "padded_lanes", 0) or len(dev_rows)

            try:
                targets = self._ensure_devices().values() if mega else (device,)
                if any(d.type == "cuda" for d in targets):
                    self._ensure_built()
                with tracer().activate(batch_span), stamp_span(batch_span):
                    stall_s = check_site("serving.mesh_dispatch" if mega
                                         else "serving.dispatch")
                    prof = active_profiler()

                    def run():
                        if mega:
                            return self._dispatch_mega(dev_rows, bucket)
                        return dispatch_signature_rows(
                            dev_rows, min_bucket=bucket, device=device, tier=self.tier,
                            batch_rlc=self.batch_rlc,
                        )

                    if prof is None:
                        pending = run()
                    else:
                        pending = prof.profile(KERNEL_SERVING_DISPATCH, run,
                                               rows=len(dev_rows), bucket=lanes_of,
                                               device=device)
                if stall_s:
                    injector = getattr(pending, "inject_stall", None)
                    if injector is not None:
                        injector(stall_s)
                padded = lanes_of(pending)
                m.timer("serving.batch_pad_waste").update(float(padded - len(dev_rows)))
                self._bump("serving.device_rows", getattr(pending, "device_rows",
                                                          len(dev_rows)))
                self._bump("serving.padded_lanes", padded)
                if mega:
                    m.counter("serving.mesh.megabatch").inc()
                    m.counter("serving.mesh.megabatch_rows").inc(len(dev_rows))
                    batch_span.set_attr("mesh_megabatch", True)
                else:
                    if mesh_on:
                        m.counter("serving.mesh.striped").inc()
                    batch_span.set_attr("device", ordinal)
                    mon = active_devicemon()
                    if mon is not None:
                        mon.record_dispatch(ordinal, rows=len(dev_rows), padded_lanes=padded)
                    with self._lock:
                        self._ord_dispatches[ordinal] = self._ord_dispatches.get(ordinal, 0) + 1
            except Exception as e:
                if placed:
                    self._ord_release(ordinal)
                mon = active_devicemon()
                if mon is not None and not mega:
                    mon.record_failure(ordinal)
                if not isinstance(e, failover_kinds()):
                    # a real launch or build error reaches the callers
                    batch_span.set_error(e)
                    for r in dev_reqs:
                        _complete(r.future, error=e)
                    dev_reqs, pending = [], None
                    if not host_reqs:
                        batch_span.finish()
                        return None
                else:
                    if mega:
                        # a whole-stripe failure blames no one ordinal: the
                        # cohort settles on the host
                        m.counter("serving.mesh.megabatch_failover").inc()
                        batch_span.set_attr("mesh_megabatch", True)
                    elif pol is not None:
                        # strike the ordinal, then re-dispatch; a request past
                        # its budget settles on the host
                        pol.on_dispatch_failure(ordinal)
                        dev_reqs = self._requeue_failed(dev_reqs)
                    if dev_reqs:
                        m.counter("serving.device_failover").inc()
                        batch_span.set_attr("device_failover", True)
                        host_reqs = host_reqs + dev_reqs
                    dev_reqs, pending = [], None
        device_entry = bool(dev_reqs and pending is not None)
        batch_span.set_attr("routing", "device" if device_entry else "host")
        if host_reqs:
            # a host-only batch's span closes when the host pool settles it
            host_span = batch_span if not device_entry else NOOP_SPAN
            try:
                self._host_pool.submit(self._settle_host, host_reqs, seq, host_span)
            except RuntimeError:
                self._settle_host(host_reqs, seq, host_span)  # pool shut down
        if device_entry:
            return _InFlight(dev_reqs, pending, len(dev_rows), starts, seq, t0,
                             span=batch_span, device=None if mega else ordinal,
                             compile_keys=compile_keys, mesh_ordinals=mesh_ordinals)
        if not host_reqs:
            # the whole batch was re-queued: nobody else finishes this span
            batch_span.set_attr("redispatched", True)
            batch_span.finish()
        return None

    # ------------------------------------------------------------ collect
    @staticmethod
    def _settle_host(requests: list, seq: int, span=NOOP_SPAN) -> None:
        slo = active_slo()
        fp = active_flowprof()
        for r in requests:
            t_verify = time.monotonic()
            try:
                mask = _host_mask(r.rows)
            except Exception as e:
                if slo is not None:
                    slo.observe(r.priority, time.monotonic() - r.enqueued_at, error=True)
                span.set_error(e)
                _complete(r.future, error=e)
                continue
            if fp is not None:
                fp.add(r.acct, "host_verify", time.monotonic() - t_verify)
            if slo is not None:
                slo.observe(r.priority, time.monotonic() - r.enqueued_at)
            _complete(r.future, result=RowResult(mask, 0, seq))
        span.finish()

    def _collect_loop(self) -> None:
        # settle in completion order: the first batch whose device work has
        # landed resolves first; with nothing ready, block on the oldest
        live: list[_InFlight] = []
        draining = False
        while True:
            while not draining:
                try:
                    entry = self._inflight_q.get(block=not live)
                except _queue.Empty:
                    break
                if entry is None:
                    draining = True
                else:
                    live.append(entry)
            if not live:
                if draining:
                    return
                continue
            entry = next((e for e in live if _pending_ready(e.pending)), None)
            if entry is None:
                head = live[0]
                if head.hedged:
                    # never wedge the collector on a hedged batch: its late
                    # readback is reaped on a thread of its own
                    live.remove(head)
                    self._reap_late(head)
                    continue
                if head.deadline is not None:
                    time.sleep(0.005)  # armed: poll, so the hedge can fire
                    continue
                entry = head
            elif entry is not live[0]:
                self._bump("serving.settle_reorder")
                _metrics().counter("serving.settle_reorder").inc()
            live.remove(entry)
            self._settle_entry(entry)

    def _reap_late(self, entry: _InFlight) -> None:
        """Settle a hedged batch off the collector thread (its readback may
        never land); shutdown joins reapers with a bound."""
        t = threading.Thread(target=self._settle_entry, args=(entry,),
                             name="serving-reap", daemon=True)
        with self._lock:
            self._reapers = [r for r in self._reapers if r.is_alive()]
            self._reapers.append(t)
        t.start()

    def _settle_entry(self, entry: _InFlight) -> None:
        try:
            self._settle(entry)
        except Exception as e:
            with self._lock:
                # a hedged batch's device error never claims the win: the
                # hedge's leg completes the futures
                ceded = entry.hedged and entry.winner != "device"
                if entry.winner is None and not entry.hedged:
                    entry.winner = "device"
            mon = active_devicemon()
            if mon is not None:
                if entry.device is not None:
                    mon.record_settle(entry.device, time.monotonic() - entry.t0, ok=False)
                elif entry.mesh_ordinals:
                    mon.record_sharded_settle(entry.mesh_ordinals,
                                              time.monotonic() - entry.t0, ok=False)
            pol = self._resilience
            if pol is not None and entry.device is not None and isinstance(e, failover_kinds()):
                pol.on_dispatch_failure(entry.device)
            entry.span.set_error(e)
            if ceded:
                if isinstance(e, failover_kinds()):
                    _metrics().counter("serving.hedge.discarded").inc()
                else:
                    # the host's verdicts already stand; the kernel's error
                    # is logged and counted apart from a late readback
                    _log.error("a hedged batch's device leg failed after the hedge "
                               "settled it: %r", e)
                    _metrics().counter("serving.hedge.device_error").inc()
                entry.span.set_attr("hedge_winner", "host")
                entry.span.finish()
                return
            slo = active_slo()
            if slo is not None:
                now = time.monotonic()
                for r in entry.requests:
                    slo.observe(r.priority, now - r.enqueued_at, error=True)
            entry.span.finish()
            for r in entry.requests:
                _complete(r.future, error=e)
        finally:
            with self._lock:
                if not entry.slot_freed:
                    entry.slot_freed = True
                    self._inflight -= 1
                if entry.device is not None:
                    d = self._ord_inflight.get(entry.device, 0)
                    if d > 0:
                        self._ord_inflight[entry.device] = d - 1
                try:
                    self._hedge_entries.remove(entry)
                except ValueError:
                    pass
                self._lock.notify_all()

    def _settle(self, entry: _InFlight) -> None:
        dev_mask = entry.pending.collect()
        on_device = getattr(entry.pending, "device_mask",
                            np.zeros(entry.n_rows, dtype=bool))
        latency = time.monotonic() - entry.t0
        m = _metrics()
        with self._lock:
            lost = entry.winner not in (None, "device")
            if entry.winner is None:
                entry.winner = "device"
            self._warm_keys |= entry.compile_keys
        m.timer("serving.batch_latency_s").update(latency,
                                                  exemplar=entry.span.trace_id or None)
        mon = active_devicemon()
        if mon is not None:
            # a lost readback's stall-inflated wall stays out of the EWMA
            if entry.device is not None:
                mon.record_settle(entry.device, latency, ewma=not lost)
            elif entry.mesh_ordinals:
                mon.record_sharded_settle(entry.mesh_ordinals, latency, ewma=not lost)
        if lost:
            # the hedge's winning leg completed every future already
            m.counter("serving.hedge.discarded").inc()
            entry.span.set_attr("hedge_winner", entry.winner)
            entry.span.set_attr("n_rows", entry.n_rows)
            entry.span.finish()
            return
        pol = self._resilience
        if pol is not None:
            for o in ((entry.device,) if entry.device is not None else entry.mesh_ordinals):
                pol.on_settle_ok(o)
        if entry.hedged:
            m.counter("serving.hedge.won_device").inc()
            entry.span.set_attr("hedge_winner", "device")
        slo = active_slo()
        now = time.monotonic()
        fp = active_flowprof()
        for r in entry.requests:
            if slo is not None:
                slo.observe(r.priority, now - r.enqueued_at)
            if fp is not None:
                fp.add(r.acct, "device_execute", latency)
        entry.span.set_attr("n_rows", entry.n_rows)
        entry.span.set_attr("device_rows", int(on_device[:entry.n_rows].sum()))
        entry.span.finish()
        with self._lock:
            self._latency_ewma = (latency if self._latency_ewma == 0.0
                                  else 0.7 * self._latency_ewma + 0.3 * latency)
            if entry.device is not None:
                prev = self._ord_ewma.get(entry.device, 0.0)
                self._ord_ewma[entry.device] = (latency if prev == 0.0
                                                else 0.7 * prev + 0.3 * latency)
        for r, start in zip(entry.requests, entry.starts):
            rows = slice(start, start + len(r.rows))
            _complete(r.future, result=RowResult(
                dev_mask[rows].copy(), int(on_device[rows].sum()), entry.seq, entry.device,
            ))

    # ----------------------------------------------------------- lifecycle
    def shutdown(self, timeout: float = 30.0) -> None:
        """Stop accepting work; queued and in-flight requests all complete
        (with verdicts or with the dispatch error). Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._paused = False
            self._lock.notify_all()
        self._dispatcher.join(timeout=timeout)
        self._host_pool.shutdown(wait=True)
        self._collector.join(timeout=timeout)
        deadline = time.monotonic() + timeout
        with self._lock:
            reapers = list(self._reapers)
        for t in reapers:
            t.join(timeout=max(deadline - time.monotonic(), 0.0))
        if self._hedge is not None:
            self._hedge.join(timeout=timeout)
        if self._resilience is not None:
            self._resilience.detach(self)


class FuturePending:
    """A scheduler Future with the two-phase ``collect()`` of
    ``PendingTxCheck``, for pipelines that enqueue now and block later.
    ``collect`` is bounded: a wedged device surfaces as a ``ServingError``,
    never as a hung caller."""

    __slots__ = ("_future", "_timeout")

    def __init__(self, future: Future, timeout: float = 600.0):
        self._future = future
        self._timeout = timeout

    def collect(self):
        try:
            return self._future.result(timeout=self._timeout)
        except _FutTimeout:
            raise ServingError(
                f"scheduler did not settle the batch within {self._timeout}s"
            ) from None


# ------------------------------------------------- process-global instance

# one shared scheduler a tier and batch_rlc setting: a caller asking for
# another ladder or rule than a live scheduler's must not be served by it
_globals: dict[tuple[Ed25519Tier, bool], DeviceScheduler] = {}
_global_lock = threading.Lock()


def device_scheduler(device=None, tier: Ed25519Tier | None = None,
                     batch_rlc: bool = True) -> DeviceScheduler:
    """The shared scheduler of ``tier`` (``DEFAULT_TIER`` when None) and
    ``batch_rlc``, created at first use on ``device`` (the card unless
    ``device="cpu"``); a shut-down one is replaced. Asking for another
    device than the live scheduler's of that tier and setting raises."""
    key = (tier or DEFAULT_TIER, batch_rlc)
    with _global_lock:
        sched = _globals.get(key)
        if sched is None or sched.closed:
            sched = _globals[key] = DeviceScheduler(device=device, tier=key[0],
                                                    batch_rlc=batch_rlc)
        elif device is not None and resolve_device(device) != sched.device:
            raise ValueError(
                f"the shared scheduler of {key[0]} (batch_rlc={batch_rlc}) runs on "
                f"{sched.device}, not {device}"
            )
        return sched


def configure_scheduler(**kwargs) -> DeviceScheduler:
    """Replace the process-global scheduler of ``kwargs["tier"]`` (the
    default tier when absent) and ``kwargs["batch_rlc"]`` (on when absent),
    shutting down the old one."""
    key = (kwargs.get("tier") or DEFAULT_TIER, kwargs.get("batch_rlc", True))
    with _global_lock:
        old = _globals.pop(key, None)
    if old is not None:
        old.shutdown()
    with _global_lock:
        sched = _globals[key] = DeviceScheduler(**kwargs)
        return sched


def shutdown_scheduler() -> None:
    """Shut down every tier's shared scheduler."""
    with _global_lock:
        scheds = list(_globals.values())
        _globals.clear()
    for sched in scheds:
        sched.shutdown()


# Daemon threads keep running while the interpreter finalizes; one caught
# inside a torch op then aborts the process (``terminate called without an
# active exception``, rc 134). So at exit each live flow engine stops and
# joins its workers, then each service that submits here drains its window,
# and last the dispatchers finish their batches and every queued request
# completes, as ``DeviceScheduler.shutdown`` documents.
_exit_engines: "weakref.WeakSet" = weakref.WeakSet()
_exit_services: "weakref.WeakSet" = weakref.WeakSet()


def drain_at_exit(service, *, engine: bool = False) -> None:
    """Call ``service.shutdown()`` at interpreter exit, before the shared
    schedulers shut down: flow engines (``engine=True``) first, since
    their flows call the services, then the other services. Holds the
    service weakly."""
    (_exit_engines if engine else _exit_services).add(service)


def _shutdown_at_exit() -> None:
    for registry in (_exit_engines, _exit_services):
        for service in list(registry):
            try:
                service.shutdown()
            except Exception:  # noqa: BLE001  (exit goes on for the others)
                pass
    shutdown_scheduler()


atexit.register(_shutdown_at_exit)


def _register_process_gauges() -> None:
    """The reference's ``serving.*`` gauges, read through the shared
    schedulers (summed over the live ones): a replaced or shut-down
    scheduler is never pinned by the registry. Registered with the first
    scheduler (the registry's package imports this one)."""
    global _gauges_registered
    if _gauges_registered:
        return
    _gauges_registered = True
    m = _metrics()

    def live(read):
        def fn():
            with _global_lock:
                scheds = [s for s in _globals.values() if not s.closed]
            return sum(read(s) for s in scheds)
        return fn

    def fill_ratio():
        with _global_lock:
            scheds = [s for s in _globals.values() if not s.closed]
        real = sum(s.counters["serving.device_rows"] for s in scheds)
        padded = sum(s.counters["serving.padded_lanes"] for s in scheds)
        return real / padded if padded else 1.0

    m.gauge("serving.queue_rows", live(lambda s: s._queued_rows))
    m.gauge("serving.queue_depth", live(lambda s: sum(len(q) for q in s._queues.values())))
    m.gauge("serving.inflight", live(lambda s: s._inflight))
    m.gauge("serving.mesh.stripe_width", live(lambda s: s._stripe_width))
    m.gauge("serving.mesh.depth_spread", live(lambda s: s._mesh_spread_max))
    m.gauge("serving.batch_fill_ratio", fill_ratio)


_gauges_registered = False
