"""The continuous-batching device scheduler (counterpart of corda_tpu/serving/scheduler.py).

One queue in front of the verify kernels, shared by every caller:

- requests enqueue with a priority class (``INTERACTIVE``, ``SERVICE``,
  ``BULK``) and an optional ``deadline_s``;
- a dispatcher thread launches a batch whenever the device pipeline has a
  free slot and work is pending (no batching window: coalescing comes from
  whatever arrived while the previous batch was in flight);
- each class has a reserved share of a batch; leftover capacity fills
  oldest-first across classes;
- admission is a bounded queue (``SchedulerSaturatedError``), and work past
  its deadline is shed at assembly and while waiting for a slot
  (``DeadlineExceededError``);
- the batch row cap adapts to arrival rate x device latency (EWMAs);
- device rows pad to the shape buckets of ``shapes.py``;
- a request may carry a ``min_bucket`` floor (the notary's window size);
  a batch pads to the bucket of its rows and of its requests' largest
  floor, and an ed25519 bucket that fills it takes the cofactored rule of
  the reference's RLC route unless ``batch_rlc`` is off;
- ed25519 rows run the ladder of the scheduler's ``Ed25519Tier`` (kernel
  B or G); the shared schedulers of ``device_scheduler`` are one a tier
  and ``batch_rlc`` setting;
- up to ``depth`` batches are in flight; a collector thread settles them
  in completion order (``serving.settle_reorder`` counts the reorders);
- host-routed requests (``use_device=False``) settle on a small host pool;
- a request holding a row that no engine verifies one signature of (a
  composite key, an unknown scheme) fails its own future with the
  ``CryptoError`` that ``is_valid`` raises, at once: the reference admits
  it and, when the batch's dispatch raises, settles each request of the
  batch on the host, where only that request fails;
- ``submit_transactions`` is the transaction layer over ``submit_rows``:
  its future resolves to the ``BatchVerifyReport`` that
  ``verifier.check_transactions`` gives for the same transactions, and
  ``FuturePending`` gives such a future the two-phase ``collect()`` of a
  direct dispatch.

Counters live in ``DeviceScheduler.counters`` under the reference's names,
with the two inputs of its fill-ratio gauge (device rows, padded lanes).
Not ported in this slice (ROADMAP.md lists each): mesh striping and the
mega-batch, resilience (hedges, breaker, re-dispatch), tracing and the
profiler/SLO/devicemon hooks, fault-injection sites, and deadline
propagation from flows. A dispatch or readback failure
fails the batch's futures with the error; nothing falls back to the host.
"""

from __future__ import annotations

import math
import queue as _queue
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError, ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutTimeout

import numpy as np

from ..crypto import CryptoError
from ..device import resolve_device
from ..ops.ed25519 import DEFAULT_TIER, Ed25519Tier
from ..verifier.batch import (
    check_schemes,
    dispatch_signature_rows,
    flatten_signature_rows,
    tx_report_from_mask,
)
from .shapes import shape_table

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
    (shared by every request coalesced into that batch), and the device."""

    __slots__ = ("mask", "n_device", "batch_seq", "device")

    def __init__(self, mask: np.ndarray, n_device: int, batch_seq: int,
                 device: str | None = None):
        self.mask = mask
        self.n_device = n_device
        self.batch_seq = batch_seq
        self.device = device


class _Request:
    __slots__ = ("rows", "future", "priority", "use_device", "enqueued_at",
                 "deadline", "min_bucket")

    def __init__(self, rows, future, priority, use_device, enqueued_at, deadline,
                 min_bucket=None):
        self.rows = rows
        self.future = future
        self.priority = priority
        self.use_device = use_device
        self.enqueued_at = enqueued_at
        self.deadline = deadline
        self.min_bucket = min_bucket


class _InFlight:
    """One dispatched device batch: the pending rows (no readback yet) and
    where each request's rows start in the batch (they are contiguous)."""

    __slots__ = ("requests", "pending", "n_rows", "starts", "seq", "t0")

    def __init__(self, requests, pending, n_rows, starts, seq, t0):
        self.requests = requests
        self.pending = pending
        self.n_rows = n_rows
        self.starts = starts
        self.seq = seq
        self.t0 = t0


def _complete(future: Future, result=None, error: Exception | None = None):
    """Complete a future, tolerating one the caller cancelled."""
    try:
        if error is None:
            future.set_result(result)
        else:
            future.set_exception(error)
    except InvalidStateError:
        pass


class DeviceScheduler:
    """One continuous-batching loop over the verify kernels on ``device``
    (the card unless ``device="cpu"``), its ed25519 rows on the ladder of
    ``tier`` (``DEFAULT_TIER`` when None), full ed25519 buckets under the
    cofactored rule unless ``batch_rlc`` is off. Construct directly for
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
    ):
        self.device = resolve_device(device)
        self.tier = tier or DEFAULT_TIER
        self.batch_rlc = batch_rlc
        self._shapes = shape_table()
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
        self._arrival_rate = 0.0
        self._arrival_last = time.monotonic()
        self._latency_ewma = 0.0
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="serving-dispatch", daemon=True
        )
        self._collector = threading.Thread(
            target=self._collect_loop, name="serving-collect", daemon=True
        )
        self._dispatcher.start()
        self._collector.start()

    def _bump(self, name: str, n: int = 1) -> None:
        with self._counter_lock:
            self.counters[name] += n

    # ------------------------------------------------------------- submit
    @property
    def closed(self) -> bool:
        return self._closed

    def submit_rows(self, rows: list, *, priority: str = SERVICE,
                    deadline_s: float | None = None,
                    use_device: bool = True, min_bucket: int | None = None) -> Future:
        """Enqueue (PublicKey, signature, message) rows; the Future resolves
        to a ``RowResult``. ``min_bucket`` is a floor for the pad bucket of
        the batch that carries them. Raises ``SchedulerClosedError`` or
        ``SchedulerSaturatedError`` at once. A request with a row that no
        engine verifies one signature of fails its future with the
        ``CryptoError`` at once and is never batched, so it never fails the
        requests it would have been batched with."""
        if priority not in _CLASSES:
            raise ValueError(f"unknown priority class {priority!r}")
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
        now = time.monotonic()
        req = _Request(rows, fut, priority, use_device, now,
                       None if deadline_s is None else now + deadline_s, min_bucket)
        with self._lock:
            if self._closed:
                raise SchedulerClosedError("device scheduler is shut down")
            if self._queued_rows + len(rows) > self._max_queue_rows:
                self._bump("serving.rejected")
                raise SchedulerSaturatedError(
                    f"serving queue full ({self._queued_rows} rows queued, "
                    f"bound {self._max_queue_rows})"
                )
            if refused is not None:
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
        return fut

    def submit_transactions(self, stxs: list, allowed_missing: list | None = None,
                            *, priority: str = SERVICE,
                            deadline_s: float | None = None,
                            use_device: bool = True,
                            min_bucket: int | None = None) -> Future:
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
                                 use_device=use_device, min_bucket=min_bucket)
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
            self._inflight_q.put(entry)
        self._inflight_q.put(None)

    def _fail_shed(self, requests: list) -> None:
        self._bump("serving.shed", len(requests))
        for r in requests:
            _complete(r.future, error=DeadlineExceededError(
                "request shed: deadline passed while queued"
            ))

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

    def _dispatch(self, batch: list) -> _InFlight | None:
        """Enqueue one shape-bucketed device dispatch for the device rows
        (no readback) and hand host-routed requests to the host pool."""
        with self._lock:
            self._seq += 1
            seq = self._seq
        self._bump("serving.batches")
        dev_reqs = [r for r in batch if r.use_device]
        host_reqs = [r for r in batch if not r.use_device]
        if host_reqs:
            self._host_pool.submit(self._settle_host, host_reqs, seq)
        if not dev_reqs:
            return None
        dev_rows: list = []
        starts: list = []
        for r in dev_reqs:
            starts.append(len(dev_rows))
            dev_rows.extend(r.rows)
        floor = max((r.min_bucket or 0 for r in dev_reqs), default=0)
        bucket = self._shapes.bucket_for(len(dev_rows), floor)
        t0 = time.monotonic()
        try:
            pending = dispatch_signature_rows(
                dev_rows, min_bucket=bucket, device=self.device, tier=self.tier,
                batch_rlc=self.batch_rlc,
            )
        except Exception as e:
            for r in dev_reqs:
                _complete(r.future, error=e)
            return None
        self._bump("serving.device_rows", pending.device_rows)
        self._bump("serving.padded_lanes", pending.padded_lanes)
        return _InFlight(dev_reqs, pending, len(dev_rows), starts, seq, t0)

    # ------------------------------------------------------------ collect
    @staticmethod
    def _settle_host(requests: list, seq: int) -> None:
        for r in requests:
            try:
                pending = dispatch_signature_rows(r.rows, use_device=False)
                _complete(r.future, result=RowResult(pending.collect(), 0, seq))
            except Exception as e:
                _complete(r.future, error=e)

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
            entry = next((e for e in live if e.pending.ready()), None)
            if entry is None:
                entry = live[0]
            elif entry is not live[0]:
                self._bump("serving.settle_reorder")
            live.remove(entry)
            try:
                self._settle(entry)
            except Exception as e:
                for r in entry.requests:
                    _complete(r.future, error=e)
            finally:
                with self._lock:
                    self._inflight -= 1
                    self._lock.notify_all()

    def _settle(self, entry: _InFlight) -> None:
        dev_mask = entry.pending.collect()
        on_device = entry.pending.device_mask
        latency = time.monotonic() - entry.t0
        with self._lock:
            self._latency_ewma = (
                latency if self._latency_ewma == 0.0
                else 0.7 * self._latency_ewma + 0.3 * latency
            )
        for r, start in zip(entry.requests, entry.starts):
            rows = slice(start, start + len(r.rows))
            _complete(r.future, result=RowResult(
                dev_mask[rows].copy(), int(on_device[rows].sum()), entry.seq,
                str(self.device),
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
