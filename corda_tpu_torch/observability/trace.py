"""Request tracing: spans, a process-global tracer, wire propagation
(counterpart of corda_tpu/observability/trace.py, copied whole).

The reference's observability surface is a flat Codahale registry
(``MonitoringService`` — mirrored in ``node/monitoring.py``); it can say
*how slow* p99 got, never *where* one slow request spent its time. After
the serving scheduler a single flow's latency spreads across four
layers — flow engine, scheduler queue, device batch, notary round-trip —
and the committee-consensus measurements in PAPERS.md show exactly that
kind of cross-layer queueing dominating tail latency. This module is the
attribution substrate: per-request spans with parent/child links, a trace
id that travels inside session messages so a flow's trace spans nodes,
and batch spans that LINK every coalesced member request (the fan-in a
strict parent tree cannot express).

Design constraints, in order:

1. **Cheap when idle.** Tracing is OFF by default (``sample_rate`` 0.0,
   or the ``CORDA_TPU_TRACE_SAMPLE`` env knob). Every entry point
   returns the shared ``NOOP_SPAN`` after one attribute read when the
   trace is unsampled, so the serving hot path pays a few ``is``/attr
   checks per request — the <5 % bench budget.
2. **Explicit propagation beats ambient magic.** The thread-local
   context stack makes same-thread nesting automatic (flow body →
   verify → scheduler submit), but every cross-thread hop (scheduler
   dispatcher, notary flusher, wire messages) carries its
   ``TraceContext`` explicitly — a span is never parented by whatever
   thread happened to run it.
3. **Bounded memory.** Finished spans land in a ring (default 4096);
   the JSONL sink is opt-in. A tracing leak must not be able to take a
   node down.

Span taxonomy and the metric-name registry live in
``docs/OBSERVABILITY.md``; ``tools_metrics_lint.py`` fails the build if
a span/metric name in code is missing from that table.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import threading
import time
from collections import deque

# Canonical span names. Code creates spans through these constants so the
# metrics lint (tools_metrics_lint.py) can enumerate every span the tree
# may emit and check each against the docs/OBSERVABILITY.md registry.
SPAN_FLOW = "flow"                        # initiator flow lifetime
SPAN_FLOW_RESPONDER = "flow.responder"    # responder flow lifetime
SPAN_FLOW_VERIFY = "flow.verify_stx"      # ServiceHub.verify_stx_signatures
SPAN_SERVING_QUEUE = "serving.queue"      # scheduler queue wait, per request
SPAN_SERVING_BATCH = "serving.batch"      # one device batch dispatch+settle
SPAN_VERIFIER_REQUEST = "verifier.request"  # BatchedVerifierService round-trip
SPAN_WAVEFRONT_WINDOW = "wavefront.window"  # one DAG-resolve window
SPAN_NOTARY_SUBMIT = "notary.submit"      # batched-notary request→response
SPAN_NOTARY_ATTEST = "notary.attest"      # notary attestation processing
SPAN_NET_TRANSIT = "net.transit"          # synthetic per-hop transit span
#                                           (cluster.TraceAssembler output)


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """The propagatable identity of a span: what a child needs to parent
    itself, small enough to ride inside a session message."""

    trace_id: str
    span_id: str

    def to_wire(self) -> str:
        return f"{self.trace_id}:{self.span_id}"

    @staticmethod
    def from_wire(wire: str) -> "TraceContext | None":
        if not wire or ":" not in wire:
            return None
        tid, _, sid = wire.partition(":")
        if not tid or not sid:
            return None
        return TraceContext(tid, sid)


class Span:
    """One timed operation. Spans may start on one thread and finish on
    another (queue-wait spans do); ``finish()`` is idempotent and hands
    the span to the tracer's ring/sink exactly once."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start_s",
                 "duration_s", "attrs", "links", "status", "_tracer",
                 "_t0", "_done")

    sampled = True

    def __init__(self, tracer, name, trace_id, span_id, parent_id,
                 attrs=None):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        # wall time is the display timestamp only; the DURATION is
        # measured on the monotonic clock (an NTP step mid-span must not
        # produce negative latencies in the quantile reports)
        self.start_s = time.time()
        self._t0 = time.monotonic()
        self.duration_s = None
        self.attrs = dict(attrs) if attrs else {}
        self.links: list[TraceContext] = []
        self.status = "ok"
        self._done = False

    @property
    def ctx(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id)

    def set_attr(self, key, value) -> "Span":
        self.attrs[key] = value
        return self

    def add_link(self, ctx: "TraceContext | Span | None") -> None:
        """Link another span (e.g. every request coalesced into a batch)
        without claiming a parent/child relationship."""
        if isinstance(ctx, Span):
            ctx = ctx.ctx
        if ctx is not None:
            self.links.append(ctx)

    def set_error(self, error) -> None:
        self.status = f"error: {type(error).__name__}: {error}"[:200]

    def finish(self) -> None:
        if self._done:
            return
        self._done = True
        self.duration_s = time.monotonic() - self._t0
        self._tracer._record(self)

    def wire(self) -> str:
        return self.ctx.to_wire()

    def to_dict(self) -> dict:
        dur = self.duration_s
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_s": self.start_s,
            "end_s": (self.start_s + dur) if dur is not None else None,
            "duration_s": dur,
            "attrs": dict(self.attrs),
            "links": [c.to_wire() for c in self.links],
            "status": self.status,
        }

    # context-manager sugar: ``with tracer.start(...) as span:``
    def __enter__(self) -> "Span":
        return self

    def __exit__(self, etype, exc, tb):
        if exc is not None:
            self.set_error(exc)
        self.finish()
        return False

    def __repr__(self):
        return f"Span({self.name}, trace={self.trace_id[:8]}…)"


class _NoopSpan:
    """The unsampled span: every mutator is a no-op, ``ctx`` is None so
    children of a no-op are no-ops too. One shared instance — creating it
    per call would defeat the idle-cost contract."""

    __slots__ = ()
    sampled = False
    ctx = None
    trace_id = ""
    span_id = ""

    def set_attr(self, key, value):
        return self

    def add_link(self, ctx):
        pass

    def set_error(self, error):
        pass

    def finish(self):
        pass

    def wire(self) -> str:
        return ""

    def to_dict(self) -> dict:
        return {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Process-global span factory + bounded store.

    ``root(name)`` makes the sampling decision for a NEW trace;
    ``start(name, parent)`` continues an existing one (no-op parent → no-op
    child). ``activate(span)`` pushes the span onto this thread's context
    stack so same-thread descendants parent automatically via
    ``current()``."""

    # sink rotation default: the opt-in JSONL sink must not grow without
    # limit under sampling — at this many bytes the current file rotates
    # to ``<path>.1`` (keep-1: the previous rotation is overwritten) and
    # a fresh file opens. 0 disables rotation (explicitly unbounded).
    SINK_MAX_BYTES_DEFAULT = 64 * 1024 * 1024

    def __init__(self, *, sample_rate: float | None = None,
                 ring_size: int = 4096, jsonl_path: str | None = None,
                 jsonl_max_bytes: int | None = None):
        if sample_rate is None:
            try:
                sample_rate = float(
                    os.environ.get("CORDA_TPU_TRACE_SAMPLE", "0") or 0
                )
            except ValueError:
                sample_rate = 0.0
        self._sample_rate = max(0.0, min(1.0, sample_rate))
        self._ring: deque = deque(maxlen=max(16, ring_size))
        self._lock = threading.Lock()
        self._rng = random.Random()
        self._local = threading.local()
        # sink I/O rides its OWN lock: a slow disk must contend only with
        # other sink writes, never with the ring appends every span-finish
        # on the serving/flow hot paths performs under _lock
        self._sink_lock = threading.Lock()
        self._jsonl_path = jsonl_path
        self._jsonl_file = None
        self._jsonl_max_bytes = (
            self.SINK_MAX_BYTES_DEFAULT if jsonl_max_bytes is None
            else max(0, int(jsonl_max_bytes))
        )
        self._sink_bytes = 0

    # ------------------------------------------------------------- config
    @property
    def enabled(self) -> bool:
        return self._sample_rate > 0.0

    def configure(self, *, sample_rate: float | None = None,
                  ring_size: int | None = None,
                  jsonl_path: str | None | object = "__unset__",
                  jsonl_max_bytes: int | None = None) -> None:
        with self._lock:
            if sample_rate is not None:
                self._sample_rate = max(0.0, min(1.0, sample_rate))
            if ring_size is not None:
                self._ring = deque(self._ring, maxlen=max(16, ring_size))
        if jsonl_max_bytes is not None:
            with self._sink_lock:
                self._jsonl_max_bytes = max(0, int(jsonl_max_bytes))
        if jsonl_path != "__unset__":
            with self._sink_lock:
                if self._jsonl_file is not None:
                    try:
                        self._jsonl_file.close()
                    except Exception:
                        pass
                    self._jsonl_file = None
                self._sink_bytes = 0
                with self._lock:
                    self._jsonl_path = jsonl_path

    # ------------------------------------------------------------ creation
    def _new_id(self, nbits: int = 64) -> str:
        return f"{self._rng.getrandbits(nbits):0{nbits // 4}x}"

    def root(self, name: str, *, attrs=None, force: bool = False):
        """Open a new trace; samples it in with probability
        ``sample_rate`` (``force`` pins it in — the bench's smoke pass)."""
        rate = self._sample_rate
        if not force and (rate <= 0.0 or self._rng.random() >= rate):
            return NOOP_SPAN
        return Span(self, name, self._new_id(96), self._new_id(), None,
                    attrs=attrs)

    def start(self, name: str, parent=None, *, attrs=None):
        """Child span of ``parent`` (a Span, TraceContext, or None).
        Unsampled/absent parent → the shared no-op span."""
        if parent is None or not getattr(parent, "trace_id", ""):
            return NOOP_SPAN
        if isinstance(parent, Span):
            parent = parent.ctx
        return Span(self, name, parent.trace_id, self._new_id(),
                    parent.span_id, attrs=attrs)

    # ------------------------------------------------------------- context
    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current(self) -> TraceContext | None:
        """The innermost activated sampled span's context on THIS thread."""
        stack = getattr(self._local, "stack", None)
        if not stack:
            return None
        return stack[-1]

    def activate(self, span) -> "_Activation":
        """``with tracer.activate(span):`` — descendants created on this
        thread (via ``current()``) parent under ``span``. No-op spans
        activate to nothing (they must not mask an outer real context)."""
        return _Activation(self, span.ctx if span.sampled else None)

    # ------------------------------------------------------------- storage
    def _record(self, span: Span) -> None:
        with self._lock:
            self._ring.append(span)
            sink_on = self._jsonl_path is not None
        if sink_on:
            with self._sink_lock:
                try:
                    if self._jsonl_file is None:
                        if self._jsonl_path is None:
                            return  # sink disabled while we waited
                        self._jsonl_file = open(self._jsonl_path, "a")
                        # append mode: an existing file's size counts
                        # toward this rotation window
                        self._sink_bytes = self._jsonl_file.tell()
                    line = json.dumps(span.to_dict()) + "\n"
                    self._jsonl_file.write(line)
                    self._jsonl_file.flush()
                    self._sink_bytes += len(line)
                    # max-bytes rotation (keep-1): the full file becomes
                    # <path>.1 via an atomic rename (overwriting the
                    # previous rotation) and a fresh file opens on the
                    # next span — the sink can hold at most ~2× the cap.
                    if (self._jsonl_max_bytes
                            and self._sink_bytes >= self._jsonl_max_bytes):
                        path = self._jsonl_path
                        self._jsonl_file.close()
                        self._jsonl_file = None
                        self._sink_bytes = 0
                        os.replace(path, path + ".1")
                except Exception:
                    # a broken sink must never break the traced code path
                    self._jsonl_file = None

    def dump(self, limit: int | None = None) -> list[dict]:
        """Most-recent-last finished spans (bounded by the ring)."""
        with self._lock:
            spans = list(self._ring)
        if limit is not None:
            spans = spans[-limit:]
        return [s.to_dict() for s in spans]

    def trace(self, trace_id: str) -> list[dict]:
        """Every finished span of one trace, start-ordered — including
        spans from OTHER traces that LINK into this one (a serving.batch
        span lives in the first coalesced member's trace but links every
        member, so each member's trace view must still show its
        device-batch stage). Linked foreign spans are identifiable by
        their own ``trace_id`` field differing from the queried one."""
        with self._lock:
            spans = [
                s for s in self._ring
                if s.trace_id == trace_id
                or any(c.trace_id == trace_id for c in s.links)
            ]
        return [s.to_dict() for s in sorted(spans, key=lambda s: s.start_s)]

    def trace_for_attr(self, key: str, value) -> list[dict]:
        """The full trace that contains a span with ``attrs[key] == value``
        — the flow-id → trace join the RPC surface exposes."""
        with self._lock:
            tid = next(
                (s.trace_id for s in self._ring
                 if s.attrs.get(key) == value),
                None,
            )
        return self.trace(tid) if tid is not None else []

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


class _Activation:
    __slots__ = ("_tracer", "_ctx", "_pushed")

    def __init__(self, tracer: Tracer, ctx: TraceContext | None):
        self._tracer = tracer
        self._ctx = ctx
        self._pushed = False

    def __enter__(self):
        if self._ctx is not None:
            self._tracer._stack().append(self._ctx)
            self._pushed = True
        return self._ctx

    def __exit__(self, *exc):
        if self._pushed:
            stack = self._tracer._stack()
            if stack and stack[-1] is self._ctx:
                stack.pop()
            elif self._ctx in stack:  # defensive: unbalanced exits
                stack.remove(self._ctx)
        return False


# ------------------------------------------------- process-global tracer
#
# One tracer per process, like the metric registry: spans from every
# layer (flows, serving, verifier, notary, faultinject) join in one ring
# so a trace assembled across layers reads back whole.

_global = Tracer()


def tracer() -> Tracer:
    return _global


def configure_tracing(*, sample_rate: float | None = None,
                      ring_size: int | None = None,
                      jsonl_path: str | None | object = "__unset__",
                      jsonl_max_bytes: int | None = None) -> Tracer:
    """The sampling/sink knobs (docs/OBSERVABILITY.md): ``sample_rate``
    0.0 disables tracing entirely (the default — production hot paths pay
    one attribute read), 1.0 traces every flow; ``jsonl_path`` enables the
    off-by-default JSONL sink, bounded by ``jsonl_max_bytes`` rotation
    (keep-1: ``<path>.1`` holds the previous window; default 64 MiB,
    0 = unbounded)."""
    _global.configure(sample_rate=sample_rate, ring_size=ring_size,
                      jsonl_path=jsonl_path,
                      jsonl_max_bytes=jsonl_max_bytes)
    return _global


def current_trace_id() -> str:
    """The active trace id on this thread, or "" — the join key the fault
    injector stamps onto injected chaos events."""
    ctx = _global.current()
    return ctx.trace_id if ctx is not None else ""
