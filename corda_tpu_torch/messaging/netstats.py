"""Network-path telemetry: per-edge delivery registries + partition detector.

(Counterpart of corda_tpu/messaging/netstats.py, copied with its import root
changed.)

Every transport the repo has — the deterministic in-memory network
(network.py) and the durable broker client (broker_client.py) — is a
set of directed (sender, recipient) EDGES, and the cross-node latency
gap ROADMAP item 4 chases lives on those edges, not inside any one
process. This module is the edge-level ledger both transports feed:

- per-edge delivery count and transit p50/p99 (send stamp → delivery,
  first-send semantics: a retransmitted message keeps its original
  stamp, so transit honestly includes loss-recovery wall — the same
  contract as flowprof's ``message_transit`` phase);
- retransmits (wire ids ``<base>~<attempt>``, the session layer's
  resend convention) and duplicates dropped by the transport dedupe;
- observed drops/delays attributed by the fault plan's verdict reason
  (``partition``/``drop``/``down``/``spoof``), so a chaos run's LOADTEST
  knee can be blamed on the network leg;
- an edge-triggered PARTITION DETECTOR: an edge with pending sends and
  no delivery for longer than the deadline raises one
  ``net.partition_suspect`` event per episode, cleared (with a
  ``net.partition_healed`` event) by the next delivery on that edge.
  Events land in the section snapshot, which the flight recorder
  (observability/slo.flight_dump) writes as its ``net`` kind.

Off by default, matching every monitor's convention: hooks call
``active_netstats()`` (two attribute reads when off after a one-time
``CORDA_TPU_NETSTATS=1`` env probe), ``configure_netstats()`` flips it
programmatically, and while disabled the process registry gains no
``net.*`` names at all. Metric rows: docs/OBSERVABILITY.md §"Cluster
observatory".
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict, deque


def logical_msg_id(msg_id: str) -> str:
    """Strip the session layer's retransmission suffix (``<base>~<n>``)."""
    return msg_id.split("~", 1)[0]


class _EdgeStats:
    """One directed (src, dst) edge's ledger. Guarded by the owning
    NetTelemetry's lock."""

    __slots__ = (
        "delivered", "retransmits", "duplicates_dropped", "drops",
        "drops_by_reason", "delays", "delay_rounds", "pending",
        "suspected", "suspect_since", "episodes", "reservoir",
        "last_delivery_t",
    )

    PENDING_CAP = 4096   # bounded: a flooding sender cannot grow memory

    def __init__(self):
        from corda_tpu_torch.node.monitoring import QuantileReservoir

        self.delivered = 0
        self.retransmits = 0
        self.duplicates_dropped = 0
        self.drops = 0
        self.drops_by_reason: dict[str, int] = {}
        self.delays = 0
        self.delay_rounds = 0
        # logical id → first-send timestamp; FIFO-bounded
        self.pending: OrderedDict[str, float] = OrderedDict()
        self.suspected = False
        self.suspect_since = 0.0
        self.episodes = 0
        self.reservoir = QuantileReservoir()
        self.last_delivery_t = 0.0


class NetTelemetry:
    """The process-wide edge registry. All hooks are O(1) under one lock;
    the clock is injectable so partition-episode semantics are testable
    without sleeping."""

    EVENTS_CAP = 256

    def __init__(self, *, partition_deadline_s: float = 2.0,
                 clock=time.monotonic):
        self._lock = threading.Lock()
        self._clock = clock
        self._edges: dict[tuple[str, str], _EdgeStats] = {}
        self.partition_deadline_s = partition_deadline_s
        self.events: deque = deque(maxlen=self.EVENTS_CAP)
        self._enabled = False

    # ------------------------------------------------------------- lifecycle
    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def reset(self) -> None:
        with self._lock:
            self._edges.clear()
            self.events.clear()

    # ----------------------------------------------------------------- hooks
    def _edge(self, src: str, dst: str) -> _EdgeStats:
        e = self._edges.get((src, dst))
        if e is None:
            # tpu-lint: allow=lock-discipline callers hold self._lock
            e = self._edges[(src, dst)] = _EdgeStats()
        return e

    def on_send(self, src: str, dst: str, msg_id: str,
                now: float | None = None) -> None:
        """Stamp a send. A retransmit (``~`` wire suffix) counts as such
        and keeps the ORIGINAL pending stamp — transit measures first
        send → delivery, loss recovery included."""
        t = self._clock() if now is None else now
        logical = logical_msg_id(msg_id)
        retx = logical != msg_id
        with self._lock:
            e = self._edge(src, dst)
            if retx:
                e.retransmits += 1
            if logical not in e.pending:
                if len(e.pending) >= e.PENDING_CAP:
                    e.pending.popitem(last=False)
                e.pending[logical] = t
        if retx:
            _net_counters()["retransmits"].inc()

    def on_deliver(self, src: str, dst: str, msg_id: str,
                   now: float | None = None) -> None:
        """A message reached the recipient. Books transit against the
        first-send stamp (when one exists) and heals a suspected edge."""
        t = self._clock() if now is None else now
        logical = logical_msg_id(msg_id)
        healed = None
        transit = None
        with self._lock:
            e = self._edge(src, dst)
            e.delivered += 1
            e.last_delivery_t = t
            t0 = e.pending.pop(logical, None)
            if t0 is not None:
                transit = max(0.0, t - t0)
                e.reservoir.update(transit)
            if e.suspected:
                e.suspected = False
                healed = {
                    "kind": "net.partition_healed", "edge": f"{src}->{dst}",
                    "t": time.time(),
                    "suspected_for_s": t - e.suspect_since,
                }
                self.events.append(healed)
        c = _net_counters()
        c["delivered"].inc()
        if transit is not None:
            _net_transit_timer().update(transit)

    def on_drop(self, src: str, dst: str, reason: str) -> None:
        """The transport (or the fault plan's verdict) dropped a message;
        ``reason`` attributes it (``partition``/``drop``/``down``/…)."""
        with self._lock:
            e = self._edge(src, dst)
            e.drops += 1
            e.drops_by_reason[reason] = e.drops_by_reason.get(reason, 0) + 1
        _net_counters()["dropped"].inc()

    def on_delay(self, src: str, dst: str, rounds: int) -> None:
        with self._lock:
            e = self._edge(src, dst)
            e.delays += 1
            e.delay_rounds += rounds
        _net_counters()["delayed"].inc()

    def on_duplicate(self, src: str, dst: str) -> None:
        with self._lock:
            self._edge(src, dst).duplicates_dropped += 1
        _net_counters()["duplicates_dropped"].inc()

    # ---------------------------------------------------- partition detector
    def check_partitions(self, now: float | None = None) -> list[dict]:
        """Edge-triggered: an edge whose OLDEST pending send has waited
        longer than the deadline without any delivery raises one suspect
        event; the flag (and a healed event) clears on the next delivery.
        Returns the events fired by this check. Called from the mocknet
        pump loop every round and lazily from ``section()``."""
        t = self._clock() if now is None else now
        fired: list[dict] = []
        with self._lock:
            for (src, dst), e in self._edges.items():
                if e.suspected or not e.pending:
                    continue
                oldest = next(iter(e.pending.values()))
                if t - oldest <= self.partition_deadline_s:
                    continue
                e.suspected = True
                e.suspect_since = t
                e.episodes += 1
                ev = {
                    "kind": "net.partition_suspect",
                    "edge": f"{src}->{dst}", "t": time.time(),
                    "pending": len(e.pending),
                    "waited_s": t - oldest,
                }
                self.events.append(ev)
                fired.append(ev)
        for _ in fired:
            _net_counters()["partition_suspects"].inc()
        return fired

    # ------------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        self.check_partitions()
        with self._lock:
            edges = {}
            for (src, dst), e in sorted(self._edges.items()):
                p50, p99 = e.reservoir.quantiles((0.5, 0.99))
                edges[f"{src}->{dst}"] = {
                    "delivered": e.delivered,
                    "transit_p50_s": p50,
                    "transit_p99_s": p99,
                    "retransmits": e.retransmits,
                    "duplicates_dropped": e.duplicates_dropped,
                    "drops": e.drops,
                    "drops_by_reason": dict(e.drops_by_reason),
                    "delays": e.delays,
                    "delay_rounds": e.delay_rounds,
                    "pending": len(e.pending),
                    "partition_suspect": e.suspected,
                    "episodes": e.episodes,
                }
            suspects = [
                f"{src}->{dst}" for (src, dst), e in sorted(self._edges.items())
                if e.suspected
            ]
            events = list(self.events)
        return {
            "enabled": self._enabled,
            "partition_deadline_s": self.partition_deadline_s,
            "edges": edges,
            "suspects": suspects,
            "events": events,
        }

    def transit_p99_s(self) -> float:
        """The worst edge's transit p99 — the loadharness per-step field."""
        with self._lock:
            worst = 0.0
            for e in self._edges.values():
                (p99,) = e.reservoir.quantiles((0.99,))
                worst = max(worst, p99)
            return worst

    def total_retransmits(self) -> int:
        with self._lock:
            return sum(e.retransmits for e in self._edges.values())

    # ------------------------------------------------------------ exposition
    def prometheus_lines(self) -> list[str]:
        """``net.*`` families with an ``edge`` label (Prometheus text
        0.0.4, label values escaped) — appended to ``metrics_text()``
        while the registry is on."""
        from corda_tpu_torch.observability.exposition import escape_label_value

        snap = self.snapshot()
        counters = ("delivered", "retransmits", "duplicates_dropped",
                    "drops", "delays")
        gauges = ("transit_p50_s", "transit_p99_s", "pending")
        lines: list[str] = []
        for key in counters:
            lines.append(f"# TYPE cordatpu_net_edge_{key} counter")
            for edge, e in snap["edges"].items():
                label = escape_label_value(edge)
                lines.append(
                    f'cordatpu_net_edge_{key}_total{{edge="{label}"}} '
                    f"{e[key]}"
                )
        for key in gauges:
            fam = key.replace("_s", "_seconds") if key.endswith("_s") else key
            lines.append(f"# TYPE cordatpu_net_edge_{fam} gauge")
            for edge, e in snap["edges"].items():
                label = escape_label_value(edge)
                lines.append(
                    f'cordatpu_net_edge_{fam}{{edge="{label}"}} {e[key]}'
                )
        lines.append("# TYPE cordatpu_net_edge_partition_suspect gauge")
        for edge, e in snap["edges"].items():
            label = escape_label_value(edge)
            flag = 1 if e["partition_suspect"] else 0
            lines.append(
                f'cordatpu_net_edge_partition_suspect{{edge="{label}"}} '
                f"{flag}"
            )
        return lines


# ------------------------------------------------------- metric registration
#
# Every net.* metric name appears here as a LITERAL so the metrics-doc
# lint (tools_metrics_lint.py) enumerates them and enforces their
# docs/OBSERVABILITY.md rows. Called only from live hooks — while
# netstats is off the process registry gains no net.* entries at all.

def _net_counters() -> dict:
    from corda_tpu_torch.node.monitoring import node_metrics

    m = node_metrics()
    return {
        "delivered": m.counter("net.delivered"),
        "retransmits": m.counter("net.retransmits"),
        "duplicates_dropped": m.counter("net.duplicates_dropped"),
        "dropped": m.counter("net.dropped"),
        "delayed": m.counter("net.delayed"),
        "partition_suspects": m.counter("net.partition_suspects"),
    }


def _net_transit_timer():
    from corda_tpu_torch.node.monitoring import node_metrics

    return node_metrics().timer("net.transit_s")


# --------------------------------------------------- process-global registry

_global = NetTelemetry()
_env_checked = False


def netstats() -> NetTelemetry:
    return _global


def active_netstats() -> NetTelemetry | None:
    """The hot-path check every transport hook performs: the process
    registry when edge telemetry is ON, else None. Two attribute reads
    when off (after the one-time env probe)."""
    global _env_checked
    if not _env_checked:
        _env_checked = True
        if os.environ.get("CORDA_TPU_NETSTATS", "") == "1":
            _global.enable()
    n = _global
    return n if n._enabled else None


def configure_netstats(*, enabled: bool | None = None, reset: bool = False,
                       partition_deadline_s: float | None = None,
                       ) -> NetTelemetry:
    """The netstats knob (docs/OBSERVABILITY.md §Cluster observatory):
    flip edge telemetry on/off; ``reset`` drops every edge ledger and
    the event ring (tests, per-step harness records). The
    ``CORDA_TPU_NETSTATS=1`` env knob enables it at first hook touch
    without code changes."""
    global _env_checked
    _env_checked = True  # explicit configuration overrides the env probe
    if reset:
        _global.reset()
    if partition_deadline_s is not None:
        _global.partition_deadline_s = partition_deadline_s
    if enabled is not None:
        if enabled:
            _global.enable()
        else:
            _global.disable()
    return _global


def netstats_section() -> dict:
    """The ``net`` section of ``monitoring_snapshot()`` (and the flight
    recorder's ``net`` kind): the full per-edge snapshot while on, a
    bare disabled marker while off."""
    n = _global
    if not n._enabled:
        return {"enabled": False}
    return n.snapshot()
