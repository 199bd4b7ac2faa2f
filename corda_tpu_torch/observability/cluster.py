"""Cluster observatory: cross-node distributed trace assembly.

(Counterpart of corda_tpu/observability/cluster.py, copied with its import root
changed.)

Per-process tracing (trace.py) sees one node's spans; the latency that
matters — a notarised payment crossing initiator → counterparty →
notary — lives BETWEEN processes, on the session hops. This module
closes that gap in three pieces (docs/OBSERVABILITY.md §Cluster
observatory):

- **ClusterRecorder** — the hop-evidence ledger the flow engine feeds:
  a send stamp (sending node's wall clock) when a tracked session
  message (``init``/``data``) leaves ``StateMachineManager.send_to``,
  and a delivery stamp (receiving node's wall clock) when the message
  enters the receiving engine (``_buffer`` / ``_handle_init``) — the
  exact sites flowprof's ``message_transit`` phase stamps, so assembled
  hop transits reconcile against the waterfall. Retransmits keep the
  first send stamp (wire ids ``<base>~<n>``).

- **EdgeOffsetEstimator** — per-edge clock-skew correction: each hop
  carries timestamps from TWO wall clocks; with traffic in both
  directions the estimator recovers the relative offset from the
  per-direction minimum deltas (the NTP symmetric assumption: the
  fastest hop each way saw roughly the same true transit), and each
  hop's corrected transit subtracts it.

- **TraceAssembler** — pulls span rings from every node in a cluster
  handle (a mocknet registry, a ``{name: rpc_ops}`` map for
  ``trace_dump`` fan-in, or pre-dumped span lists), dedupes and joins
  them by trace id into ONE node-annotated distributed trace, welds a
  synthetic ``net.transit`` span onto every hop, and computes the
  cross-node critical path: the flowprof phase set per flow per node,
  extended with a ``remote`` attribution per hop (the per-flow
  ``message_transit`` phase is replaced by its per-hop breakdown), and
  ranked against the root flow's end-to-end wall — the named answer to
  "which node/hop/phase bounds this trace".

Off by default, as every monitor is: engine hooks go through
``active_cluster()`` (``CORDA_TPU_CLUSTER=1`` env probe, one-time), and
while disabled the process registry gains no ``cluster.*`` names.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict, deque

from corda_tpu_torch.observability.trace import SPAN_NET_TRANSIT

CLUSTER_SCHEMA = 1


class ClusterRecorder:
    """Hop-evidence ledger. All hooks are O(1) under one lock; the wall
    clock is injectable per call so skew scenarios are testable."""

    SENT_CAP = 8192    # un-joined send stamps, FIFO-bounded
    HOPS_CAP = 4096    # completed hops kept for assembly

    def __init__(self):
        self._lock = threading.Lock()
        # logical msg id → (src, dst, kind, trace_id, t_send)
        self._sent: OrderedDict[str, tuple] = OrderedDict()
        self._hops: deque = deque(maxlen=self.HOPS_CAP)
        self._enabled = False

    # ------------------------------------------------------------- lifecycle
    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def reset(self) -> None:
        with self._lock:
            self._sent.clear()
            self._hops.clear()

    # ----------------------------------------------------------------- hooks
    def note_send(self, node: str, peer: str, kind: str, msg_id: str,
                  trace_id: str, now: float | None = None) -> None:
        """Stamp a tracked session send on the SENDING node's wall clock.
        First stamp wins — a retransmit must not rejuvenate the hop."""
        t = time.time() if now is None else now
        with self._lock:
            if msg_id not in self._sent:
                if len(self._sent) >= self.SENT_CAP:
                    self._sent.popitem(last=False)
                self._sent[msg_id] = (node, peer, kind, trace_id, t)

    def note_recv(self, node: str, sender: str, msg_id: str,
                  trace_id: str, now: float | None = None) -> None:
        """Join a delivery (RECEIVING node's wall clock) against its send
        stamp into a completed hop. Deliveries without send evidence
        (aged out, or an untracked kind) are dropped — a hop needs both
        clocks to mean anything."""
        t = time.time() if now is None else now
        with self._lock:
            rec = self._sent.pop(msg_id, None)
            if rec is None:
                return
            src, dst, kind, send_trace, t_send = rec
            self._hops.append({
                "msg_id": msg_id, "kind": kind,
                "src": src, "dst": dst if not node else node,
                "t_send": t_send, "t_recv": t,
                # the receiver knows its trace id authoritatively (a
                # responder joins via the wire context); fall back to the
                # sender's view for unsampled/early deliveries
                "trace_id": trace_id or send_trace,
            })
        _cluster_counters()["hops"].inc()

    # -------------------------------------------------------------- queries
    def hops(self) -> list[dict]:
        with self._lock:
            return [dict(h) for h in self._hops]

    def hops_for(self, trace_id: str) -> list[dict]:
        with self._lock:
            return [dict(h) for h in self._hops if h["trace_id"] == trace_id]

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": self._enabled,
                "hops": len(self._hops),
                "pending_sends": len(self._sent),
            }


class EdgeOffsetEstimator:
    """Per-edge relative clock-offset estimate from completed hops.

    For edge (A, B): ``fwd`` = min over A→B hops of (t_recv − t_send),
    ``rev`` = the same for B→A. With symmetric minimum true transit,
    ``(fwd − rev) / 2`` is the offset of B's clock relative to A's; a
    one-directional edge estimates 0 (no evidence beats a wrong guess).
    """

    def __init__(self, hops: list[dict]):
        self._min: dict[tuple[str, str], float] = {}
        for h in hops:
            d = h["t_recv"] - h["t_send"]
            k = (h["src"], h["dst"])
            if k not in self._min or d < self._min[k]:
                self._min[k] = d

    def offset_s(self, src: str, dst: str) -> float:
        """Estimated offset of ``dst``'s clock relative to ``src``'s."""
        fwd = self._min.get((src, dst))
        rev = self._min.get((dst, src))
        if fwd is None or rev is None:
            return 0.0
        return (fwd - rev) / 2.0

    def corrected_transit_s(self, hop: dict) -> float:
        raw = hop["t_recv"] - hop["t_send"]
        return max(0.0, raw - self.offset_s(hop["src"], hop["dst"]))


class TraceAssembler:
    """Joins every node's span ring + the hop ledger into one distributed
    trace. The handle is any of:

    - a mocknet registry (an object with a ``.nodes`` name→node dict;
      nodes share the process tracer, so one ring read serves all);
    - a ``{name: source}`` map where each source is an RPC-ops-like
      object (``trace_dump(limit=…)`` fan-in), a zero-arg callable
      returning span dicts, or a pre-dumped span list.
    """

    def __init__(self, handle, recorder: "ClusterRecorder | None" = None):
        self._handle = handle
        self._recorder = recorder

    # ------------------------------------------------------------- gathering
    def _node_dumps(self, limit: int) -> dict[str, list]:
        from corda_tpu_torch.observability.trace import tracer

        handle = self._handle
        nodes = getattr(handle, "nodes", None)
        if isinstance(nodes, dict):
            ring = tracer().dump(limit=limit)
            return {name: ring for name in nodes}
        if isinstance(handle, dict):
            out: dict[str, list] = {}
            for name, src in handle.items():
                if hasattr(src, "trace_dump"):
                    out[name] = src.trace_dump(limit=limit)
                elif callable(src):
                    out[name] = src()
                else:
                    out[name] = list(src)
            return out
        raise TypeError(
            "cluster handle must be a mocknet registry (.nodes dict) or a "
            "{name: ops|callable|spans} map, got "
            f"{type(handle).__name__}"
        )

    def _recorder_or_active(self) -> "ClusterRecorder | None":
        if self._recorder is not None:
            return self._recorder
        return active_cluster()

    # -------------------------------------------------------------- assembly
    def assemble(self, trace_id: str | None = None,
                 flow_id: str | None = None, *, limit: int = 4096) -> dict:
        """One distributed trace: node-annotated spans, per-hop synthetic
        ``net.transit`` spans (skew-corrected), transit quantiles, and
        the cross-node critical path. Select by ``trace_id`` or by any
        ``flow_id`` participating in the trace."""
        dumps = self._node_dumps(limit)
        spans: dict[tuple, dict] = {}
        for node, ring in dumps.items():
            for s in ring:
                key = (s.get("trace_id"), s.get("span_id"))
                if key not in spans:
                    spans[key] = dict(s)
        all_spans = list(spans.values())
        if trace_id is None:
            if flow_id is None:
                raise ValueError("assemble() needs a trace_id or a flow_id")
            for s in all_spans:
                if s.get("attrs", {}).get("flow.id") == flow_id:
                    trace_id = s["trace_id"]
                    break
            if trace_id is None:
                return {"schema": CLUSTER_SCHEMA, "trace_id": None,
                        "nodes": [], "spans": [], "hops": [],
                        "transit": _transit_stats([]),
                        "critical_path": None}
        selected = [
            s for s in all_spans
            if s.get("trace_id") == trace_id or any(
                link.split(":", 1)[0] == trace_id
                for link in s.get("links", ())
            )
        ]
        selected.sort(key=lambda s: s.get("start_s", 0.0))
        nodes = sorted({
            s["attrs"]["node"] for s in selected
            if isinstance(s.get("attrs"), dict) and "node" in s["attrs"]
        })
        rec = self._recorder_or_active()
        trace_hops = rec.hops_for(trace_id) if rec is not None else []
        # offsets estimated over ALL hops — every edge sample sharpens
        # the minimum, not just this trace's
        est = EdgeOffsetEstimator(rec.hops() if rec is not None else [])
        hop_spans = [self._hop_span(h, est) for h in trace_hops]
        hop_spans.sort(key=lambda s: s["start_s"])
        transits = [s["duration_s"] for s in hop_spans]
        result = {
            "schema": CLUSTER_SCHEMA,
            "trace_id": trace_id,
            "nodes": nodes,
            "spans": selected,
            "hops": hop_spans,
            "transit": _transit_stats(transits),
            "critical_path": self._critical_path(selected, hop_spans),
        }
        if rec is not None:
            _cluster_counters()["assemblies"].inc()
        return result

    @staticmethod
    def _hop_span(hop: dict, est: EdgeOffsetEstimator) -> dict:
        offset = est.offset_s(hop["src"], hop["dst"])
        raw = hop["t_recv"] - hop["t_send"]
        corrected = max(0.0, raw - offset)
        return {
            "name": SPAN_NET_TRANSIT,
            "trace_id": hop["trace_id"],
            "span_id": f"hop-{hop['msg_id']}",
            "parent_id": None,
            "start_s": hop["t_send"],
            "end_s": hop["t_send"] + corrected,
            "duration_s": corrected,
            "attrs": {
                "src": hop["src"], "dst": hop["dst"],
                "msg.id": hop["msg_id"], "kind": hop["kind"],
                "net.raw_s": raw, "net.offset_s": offset,
            },
            "links": [],
            "status": "ok",
        }

    # --------------------------------------------------------- critical path
    @staticmethod
    def _critical_path(selected: list[dict], hop_spans: list[dict]):
        """Rank where the root flow's end-to-end wall went, across nodes:
        per-(node, phase) seconds from each participating flow's flowprof
        waterfall — with ``message_transit`` replaced by the per-hop
        ``remote`` entries, so a slow EDGE is named, not just "transit
        somewhere" — and ``bound_by`` naming the single largest
        contributor. ``None`` when the trace has no root flow span."""
        from corda_tpu_torch.observability.flowprof import flowprof

        root = None
        for s in selected:
            if not s.get("parent_id"):
                if root is None or s.get("duration_s", 0.0) > \
                        root.get("duration_s", 0.0):
                    root = s
        if root is None:
            return None
        end_to_end = root.get("duration_s", 0.0) or 0.0
        contrib: dict[tuple, float] = {}
        fp = flowprof()
        for s in selected:
            attrs = s.get("attrs") or {}
            fid = attrs.get("flow.id")
            if not fid:
                continue
            wf = fp.waterfall_of(fid)
            node = attrs.get("node", "")
            if wf is None:
                # no waterfall (flowprof off or aged out): the span wall
                # still attributes to its node, unphased
                key = (node, "span", s.get("name", "flow"))
                contrib[key] = contrib.get(key, 0.0) + \
                    (s.get("duration_s", 0.0) or 0.0)
                continue
            for phase, seconds in wf["phases"].items():
                if phase == "message_transit" or seconds <= 0.0:
                    continue  # transit is attributed per hop below
                key = (node, "phase", phase)
                contrib[key] = contrib.get(key, 0.0) + seconds
        for h in hop_spans:
            a = h["attrs"]
            key = (f"{a['src']}->{a['dst']}", "hop", "remote")
            contrib[key] = contrib.get(key, 0.0) + h["duration_s"]
        contributors = [
            {
                "node": node, "kind": kind, "phase": phase,
                "seconds": seconds,
                "share": (seconds / end_to_end) if end_to_end > 0 else 0.0,
            }
            for (node, kind, phase), seconds in contrib.items()
        ]
        contributors.sort(key=lambda c: c["seconds"], reverse=True)
        return {
            "end_to_end_s": end_to_end,
            "root_flow": (root.get("attrs") or {}).get("flow.class", ""),
            "bound_by": contributors[0] if contributors else None,
            "contributors": contributors[:16],
        }


def _transit_stats(transits: list[float]) -> dict:
    ordered = sorted(transits)
    n = len(ordered)

    def q(p: float) -> float:
        if not n:
            return 0.0
        return ordered[min(n - 1, int(p * n))]

    return {
        "count": n,
        "total_s": sum(ordered),
        "p50_s": q(0.5),
        "p99_s": q(0.99),
    }


# ------------------------------------------------------- metric registration
#
# Every cluster.* metric name appears here as a LITERAL so the
# metrics-doc lint (tools_metrics_lint.py) enumerates them and enforces
# their docs/OBSERVABILITY.md rows. Called only from live hooks — while
# the recorder is off the process registry gains no cluster.* entries.

def _cluster_counters() -> dict:
    from corda_tpu_torch.node.monitoring import node_metrics

    m = node_metrics()
    return {
        "hops": m.counter("cluster.hops"),
        "assemblies": m.counter("cluster.assemblies"),
    }


# --------------------------------------------------- process-global recorder

_global = ClusterRecorder()
_env_checked = False


def cluster_recorder() -> ClusterRecorder:
    return _global


def active_cluster() -> ClusterRecorder | None:
    """The hot-path check the engine hooks perform: the process recorder
    when hop recording is ON, else None. Two attribute reads when off
    (after the one-time env probe)."""
    global _env_checked
    if not _env_checked:
        _env_checked = True
        if os.environ.get("CORDA_TPU_CLUSTER", "") == "1":
            _global.enable()
    c = _global
    return c if c._enabled else None


def configure_cluster(*, enabled: bool | None = None,
                      reset: bool = False) -> ClusterRecorder:
    """The cluster-observatory knob (docs/OBSERVABILITY.md §Cluster
    observatory): flip hop recording on/off; ``reset`` drops the hop
    ledger. ``CORDA_TPU_CLUSTER=1`` enables it at first hook touch."""
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


def cluster_section() -> dict:
    """The ``cluster`` section of ``monitoring_snapshot()``: the hop
    ledger's shape while on, a bare disabled marker while off."""
    c = _global
    if not c._enabled:
        return {"enabled": False}
    return c.snapshot()
