"""Kernel-level device profiler: compile/execute accounting per shape bucket
(counterpart of corda_tpu/observability/profiler.py).

1. **Off by default, near-free when off.** Every instrumented entry point
   calls ``active_profiler()`` (two attribute reads returning None) and
   takes its plain path: no metric is created, no span attribute written,
   no lock touched.
2. **Keyed first-dispatch latch.** The first profiled dispatch of each
   ``kernel x bucket`` key is the COMPILE observation (on the card it
   includes the kernels' ``nvcc`` build when the process is cold); every
   later one an EXECUTE observation.
3. **Timing.** On a CUDA device one ``torch.cuda.Event(enable_timing=True)``
   pair brackets the dispatch on the launch's stream, and the observation
   is the events' elapsed time, read at settle: the pair is queued, and
   read once its end event has completed (polled by each later profiled
   dispatch, waited for by ``flush()``, ``snapshot()`` and the monitoring
   snapshot). Nothing waits inside the dispatch, so profiling does not
   serialise the pipeline (the reference's ``block_until_ready`` did). The
   pair brackets the whole dispatch as the reference's wall clock did:
   host prep that runs between the events, while the card idles, counts,
   as does a first call's host-side build, and an enclosing dispatch
   (``ed25519.verify``) contains the dispatches nested in it (``sha512``).
   Elsewhere (``device="cpu"``, the plain versions) the wall clock
   brackets the call.
4. **Batch efficiency is data.** Each record carries real rows vs padded
   lanes and bytes in/out, per kernel x bucket.
5. **Snapshots join the existing surfaces.** Aggregates mirror into the
   process registry (``profiler.*``), the per-kernel detail is
   ``profiler().snapshot()``, and profiled dispatches stamp their
   kernel/bucket onto the active ``serving.batch`` span (``stamp_span``).

Profiling alters the measured system (two events a dispatch, a poll of
the queue). It is a diagnostic mode.

6. **Roofline join.** Each kernel the op model covers carries
   ``roofline_rows_per_sec``, its H100 data-sheet bound in rows a second
   (``ops/opcount.py::roofline_rows_per_sec``: one row's bytes over
   3.35 TB/s against its 32-bit integer operations over 64 a clock a SM x
   132 SMs x 1,980 MHz, the larger time of the two), and
   ``roofline_frac``, the execute-only rows/s over it. These are bounds
   from the data sheet, not measured peaks (the reference reads measured
   TPU rows/s from ``BASELINE.json``; the port does not use that table).
   The SPHINCS verify, the host loop and the scheduler's batch carry none.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

# Canonical kernel names (the reference's); the port's entry point of each
# is named beside it.
KERNEL_ED25519_VERIFY = "ed25519.verify"    # ops/ed25519.ed25519_verify_dispatch (A, B or G)
KERNEL_ED25519_SIGN = "ed25519.sign"        # ops/ed25519_sign.ed25519_sign_dispatch (E)
KERNEL_ECDSA_VERIFY = "ecdsa.verify"        # ops/secp256.ecdsa_verify_dispatch (F)
KERNEL_SHA256 = "sha256"                    # ops/sha256.sha256_batch_words (C)
KERNEL_SHA512 = "sha512"                    # ops/ed25519's fixed route: ed25519_challenge (A)
KERNEL_TXID = "txid"                        # ops/txid.compute_tx_ids (C, D)
KERNEL_SPHINCS = "sphincs.verify"           # ops/sphincs_batch.sphincs_verify_dispatch (H)
KERNEL_HOST_REF = "host_ref"                # ops/host_ref.verify_loop (the host C loop)
KERNEL_SERVING_DISPATCH = "serving.batch"   # scheduler device dispatch (whole batch)


class _KernelStats:
    """Accumulated observations for one kernel x bucket key. Mutated only
    under the owning profiler's lock."""

    __slots__ = ("compile_count", "compile_s", "exec_count", "exec_total_s",
                 "exec_min_s", "exec_max_s", "rows", "exec_rows", "lanes",
                 "bytes_in", "bytes_out")

    def __init__(self):
        self.compile_count = 0
        self.compile_s = 0.0
        self.exec_count = 0
        self.exec_total_s = 0.0
        self.exec_min_s = float("inf")
        self.exec_max_s = 0.0
        self.rows = 0
        self.exec_rows = 0
        self.lanes = 0
        self.bytes_in = 0
        self.bytes_out = 0


# thread-local stack of spans that profiled dispatches should stamp
_span_stack = threading.local()


class _NoStamp:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_STAMP = _NoStamp()


class _SpanStamp:
    __slots__ = ("_span",)

    def __init__(self, span):
        self._span = span

    def __enter__(self):
        stack = getattr(_span_stack, "stack", None)
        if stack is None:
            stack = _span_stack.stack = []
        stack.append(self._span)
        return self._span

    def __exit__(self, *exc):
        stack = getattr(_span_stack, "stack", None)
        if stack and stack[-1] is self._span:
            stack.pop()
        return False


def stamp_span(span):
    """``with stamp_span(batch_span):`` makes profiled dispatches inside the
    block stamp their kernel/bucket onto ``span``. A shared no-op when the
    profiler is off or the span unsampled."""
    p = _global
    if p is None or not p._enabled or not getattr(span, "sampled", False):
        return _NO_STAMP
    return _SpanStamp(span)


def _cuda_device(device):
    """The CUDA device to bracket with events, or None for the wall clock."""
    if device is None:
        return None
    import torch

    dev = torch.device(device)
    return dev if dev.type == "cuda" else None


class DeviceProfiler:
    """Process-global kernel profiler (construct directly only in tests;
    production code shares ``profiler()``)."""

    def __init__(self, *, enabled: bool | None = None):
        if enabled is None:
            enabled = os.environ.get(
                "CORDA_TPU_PROFILE", ""
            ).strip().lower() in ("1", "true", "on", "yes")
        self._enabled = bool(enabled)
        self._lock = threading.Lock()
        self._stats: dict[tuple[str, int], _KernelStats] = {}
        self._compiled: set[tuple[str, int]] = set()
        # CUDA-timed observations whose events are not read yet, in order
        self._pending: deque = deque()

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def reset(self) -> None:
        """Drop accumulated stats and the compile latch."""
        with self._lock:
            self._stats.clear()
            self._compiled.clear()
            self._pending.clear()

    def flush(self) -> None:
        """Wait for every queued CUDA-timed observation and record it."""
        self._drain(wait=True)

    def _drain(self, wait: bool) -> None:
        """Record the queued observations in order, stopping at the first
        whose end event has not completed unless ``wait``."""
        while True:
            with self._lock:
                if not self._pending:
                    return
                obs = self._pending[0]
                if not wait and not obs[-1].query():
                    return
                self._pending.popleft()
            key, first, rows, bytes_in, bytes_out, start, end = obs
            end.synchronize()
            self._record(key, first, rows, start.elapsed_time(end) / 1e3, bytes_in, bytes_out)

    def profile(self, kernel: str, fn, *, rows: int, bucket, bytes_in: int = 0,
                bytes_out=None, device=None):
        """Run ``fn`` (a zero-argument dispatch) and record one observation
        for ``kernel x bucket``; returns ``fn``'s result. ``bucket`` and
        ``bytes_out`` may be callables over the result. ``device`` is the
        device the dispatch runs on: a CUDA device is timed by a pair of
        CUDA events on its current stream, read at settle (nothing waits
        here); anything else (a plain version, which has finished when it
        returns) by the wall clock. Zero-row dispatches pass through
        unrecorded."""
        if not self._enabled or rows <= 0:
            return fn()
        cuda = _cuda_device(device)
        if cuda is not None:
            import torch

            stream = torch.cuda.current_stream(cuda)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            result = fn()
            end.record(stream)
        else:
            t0 = time.perf_counter()
            result = fn()
            dt = time.perf_counter() - t0
        if callable(bucket):
            bucket = int(bucket(result) or 0)
        bucket = max(int(bucket), int(rows), 1)
        if callable(bytes_out):
            bytes_out = int(bytes_out(result) or 0)
        key = (kernel, bucket)
        with self._lock:
            # the first dispatch of a key is its compile observation,
            # whenever its events are read
            first = key not in self._compiled
            self._compiled.add(key)
            if cuda is not None:
                self._pending.append((key, first, int(rows), int(bytes_in),
                                      int(bytes_out or 0), start, end))
        stack = getattr(_span_stack, "stack", None)
        if stack:
            span = stack[-1]
            span.set_attr("profiler.kernel", kernel)
            span.set_attr("profiler.bucket", bucket)
            span.attrs.setdefault("profiler.kernels", []).append(f"{kernel}/{bucket}")
        if cuda is None:
            self._record(key, first, int(rows), dt, int(bytes_in), int(bytes_out or 0))
        self._drain(wait=False)
        return result

    def _record(self, key: tuple[str, int], first: bool, rows: int, dt: float,
                bytes_in: int, bytes_out: int) -> None:
        bucket = key[1]
        with self._lock:
            st = self._stats.get(key)
            if st is None:
                st = self._stats[key] = _KernelStats()
            if first:
                st.compile_count += 1
                st.compile_s += dt
            else:
                st.exec_count += 1
                st.exec_total_s += dt
                st.exec_min_s = min(st.exec_min_s, dt)
                st.exec_max_s = max(st.exec_max_s, dt)
                st.exec_rows += rows
            st.rows += rows
            st.lanes += bucket
            st.bytes_in += bytes_in
            st.bytes_out += bytes_out
        from ..node.monitoring import node_metrics

        m = node_metrics()
        m.meter("profiler.dispatches").mark()
        m.meter("profiler.rows").mark(rows)
        m.counter("profiler.pad_rows").inc(bucket - rows)
        (m.timer("profiler.compile_s") if first else m.timer("profiler.execute_s")).update(dt)
        if bytes_in:
            m.counter("profiler.bytes_in").inc(bytes_in)
        if bytes_out:
            m.counter("profiler.bytes_out").inc(bytes_out)

    def snapshot(self) -> dict:
        """The per-kernel / per-bucket accounting: compile vs execute wall,
        batch efficiency, bytes and achieved rows/s (execute only), after
        every queued observation is read."""
        self.flush()
        with self._lock:
            items = [(kernel, bucket, st) for (kernel, bucket), st in sorted(self._stats.items())]
        kernels: dict = {}
        for kernel, bucket, st in items:
            agg = kernels.setdefault(kernel, {
                "compile_count": 0, "compile_s": 0.0,
                "execute_count": 0, "execute_total_s": 0.0,
                "rows": 0, "exec_rows": 0, "padded_lanes": 0,
                "bytes_in": 0, "bytes_out": 0, "buckets": {},
            })
            b = {
                "compile_count": st.compile_count,
                "compile_s": round(st.compile_s, 6),
                "execute_count": st.exec_count,
                "execute_total_s": round(st.exec_total_s, 6),
                "execute_mean_s": round(st.exec_total_s / st.exec_count, 6)
                if st.exec_count else 0.0,
                "execute_min_s": 0.0 if st.exec_count == 0 else round(st.exec_min_s, 6),
                "execute_max_s": round(st.exec_max_s, 6),
                "rows": st.rows,
                "padded_lanes": st.lanes,
                "batch_efficiency": round(st.rows / st.lanes, 4),
                "bytes_in": st.bytes_in,
                "bytes_out": st.bytes_out,
            }
            if st.exec_total_s > 0:
                b["rows_per_sec"] = round(st.exec_rows / st.exec_total_s, 1)
            agg["buckets"][str(bucket)] = b
            agg["compile_count"] += st.compile_count
            agg["compile_s"] += st.compile_s
            agg["execute_count"] += st.exec_count
            agg["execute_total_s"] += st.exec_total_s
            agg["rows"] += st.rows
            agg["exec_rows"] += st.exec_rows
            agg["padded_lanes"] += st.lanes
            agg["bytes_in"] += st.bytes_in
            agg["bytes_out"] += st.bytes_out
        from ..ops.opcount import roofline_rows_per_sec

        for kernel, agg in kernels.items():
            raw_exec_total = agg["execute_total_s"]
            agg["compile_s"] = round(agg["compile_s"], 6)
            agg["execute_total_s"] = round(raw_exec_total, 6)
            agg["batch_efficiency"] = round(
                agg["rows"] / agg["padded_lanes"], 4
            ) if agg["padded_lanes"] else 0.0
            if raw_exec_total > 0:
                agg["rows_per_sec"] = round(agg["exec_rows"] / raw_exec_total, 1)
                peak = roofline_rows_per_sec(kernel)
                if peak is not None:
                    agg["roofline_rows_per_sec"] = round(peak, 1)
                    agg["roofline_frac"] = round(agg["rows_per_sec"] / peak, 4)
        return {"enabled": self._enabled, "kernels": kernels}


_global = DeviceProfiler()


def profiler() -> DeviceProfiler:
    return _global


def active_profiler() -> DeviceProfiler | None:
    """The hot-path check of every instrumented dispatch: the process
    profiler when on, else None. Two attribute reads."""
    p = _global
    return p if p._enabled else None


def configure_profiler(*, enabled: bool | None = None,
                       reset: bool = False) -> DeviceProfiler:
    """The on/off and reset knob; also ``CORDA_TPU_PROFILE=1`` at process
    start."""
    if reset:
        _global.reset()
    if enabled is not None:
        if enabled:
            _global.enable()
        else:
            _global.disable()
    return _global
