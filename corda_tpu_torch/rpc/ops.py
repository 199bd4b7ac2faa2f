"""The node's remote operations surface (the port's copy of
corda_tpu/rpc/ops.py, import root changed).

Capability parity with ``CordaRPCOps`` (core/.../messaging/CordaRPCOps.kt:54):
flow start (:204 startFlowDynamic), vault query/track (:94/:135), network
map snapshot/feed (:197), state machine feed (:69), transaction feed,
notary identities, node info, attachments, registered flows, time.

This class is transport-free — the RPCServer exposes it remotely; in-process
callers (shell, webserver, tests) can use it directly, like the reference's
``CordaRPCOpsImpl`` (node/.../internal/CordaRPCOpsImpl.kt).
"""

from __future__ import annotations

import time as _time

from corda_tpu_torch.crypto.keys import PublicKey
from corda_tpu_torch.flows import FlowLogic
from corda_tpu_torch.flows.api import load_class
from corda_tpu_torch.ledger import CordaX500Name
from corda_tpu_torch.node.vault import PageSpecification, QueryCriteria, Sort


class PermissionException(Exception):
    """RPC user lacks the permission for an operation (reference:
    net.corda.node.services.messaging.RPCOps permission checks)."""


def start_flow_permission(flow_cls_or_path) -> str:
    """Permission string guarding a flow start (reference:
    startFlowPermission<T>())."""
    if isinstance(flow_cls_or_path, str):
        return f"StartFlow.{flow_cls_or_path}"
    from corda_tpu_torch.flows.api import class_path

    return f"StartFlow.{class_path(flow_cls_or_path)}"


class CordaRPCOps:
    """All operations a client may invoke on the node."""

    MAX_RETAINED_HANDLES = 4096

    def __init__(self, services, smm, registered_flow_names=None):
        self._services = services
        self._smm = smm
        self._registered_flows = list(registered_flow_names or [])
        # RPC-started flow handles are retained (bounded) so flow_result
        # works even after the flow finished and the SMM pruned it
        self._handles: dict = {}

    # ------------------------------------------------------------- flows
    def start_flow_dynamic(self, flow_class_path: str, *args, **kwargs):
        """Start a flow by class path; returns the flow id (reference:
        CordaRPCOps.startFlowDynamic :204). The result is retrieved via
        ``flow_result``/the state machine feed — RPC calls never block on
        flow completion."""
        cls = load_class(flow_class_path)
        if not (isinstance(cls, type) and issubclass(cls, FlowLogic)):
            raise PermissionException(
                f"{flow_class_path} is not a startable flow"
            )
        handle = self._smm.start_flow(cls(*args, **kwargs))
        self._handles[handle.flow_id] = handle
        while len(self._handles) > self.MAX_RETAINED_HANDLES:
            self._handles.pop(next(iter(self._handles)))
        return handle.flow_id

    def flow_result(self, flow_id: str, timeout: float | None = None):
        """Block for a started flow's result (the client-side handle's
        ``returnValue`` future in the reference)."""
        handle = self._handles.get(flow_id) or self._smm.handle_of(flow_id)
        if handle is None:
            raise KeyError(f"unknown flow {flow_id}")
        return handle.result.result(timeout=timeout)

    def state_machines_snapshot(self) -> list[str]:
        return self._smm.flows_in_progress()

    def state_machines_detail(self) -> dict:
        """flow id → "running" | "queued" | "parked@<wake key>" — the
        wedged-flow diagnostic surface (what is each live flow waiting
        on)."""
        return self._smm.flows_detail()

    def registered_flows(self) -> list[str]:
        return list(self._registered_flows)

    def kill_flow(self, flow_id: str) -> bool:
        return self._smm.kill_flow(flow_id)

    # ------------------------------------------------------------- vault
    def vault_query_by(self, criteria: QueryCriteria | None = None,
                       paging: PageSpecification | None = None,
                       sorting: Sort | None = None):
        crit = criteria or QueryCriteria()
        return self._services.vault_service.query_by(
            crit, paging=paging, sort=sorting or Sort()
        )

    def vault_track(self, callback):
        """Current page + future updates pushed to ``callback`` (reference:
        vaultTrackBy :135). Over RPC the server bridges the callback into
        an Observation stream."""
        return self._services.vault_service.track(callback)

    # ------------------------------------------------------- transactions
    def transaction(self, tx_id):
        return self._services.validated_transactions.get(tx_id)

    def transaction_count(self) -> int:
        return self._services.validated_transactions.count()

    def validated_transactions_track(self, callback):
        return self._services.validated_transactions.track(callback)

    # -------------------------------------------------------- network map
    def network_map_snapshot(self) -> list:
        return self._services.network_map_cache.all_nodes()

    def network_map_feed(self, callback) -> list:
        return self._services.network_map_cache.track(callback)

    def notary_identities(self) -> list:
        return self._services.network_map_cache.notary_identities

    def node_info(self):
        return self._services.my_info

    def well_known_party_from_x500_name(self, name: CordaX500Name):
        info = self._services.network_map_cache.get_node_by_legal_name(name)
        return info.legal_identity if info else None

    def party_from_key(self, key: PublicKey):
        """reference: CordaRPCOps.partyFromKey — resolve an owning key to
        its well-known party via the identity service, falling back to the
        network map."""
        party = self._services.identity_service.party_from_key(key)
        if party is not None:
            return party
        for info in self._services.network_map_cache.all_nodes():
            if info.legal_identity.owning_key == key:
                return info.legal_identity
        return None

    # -------------------------------------------------------- attachments
    def attachment_exists(self, attachment_id) -> bool:
        return self._services.attachments.has_attachment(attachment_id)

    def upload_attachment(self, data: bytes):
        return self._services.attachments.import_attachment(data)

    def open_attachment(self, attachment_id) -> bytes | None:
        att = self._services.attachments.open_attachment(attachment_id)
        return att.data if att else None

    def untrack(self, callback) -> None:
        """Detach a feed callback from every trackable service (server-side
        unsubscribe cleanup)."""
        self._services.vault_service.untrack(callback)
        self._services.validated_transactions.untrack(callback)
        self._services.network_map_cache.untrack(callback)

    # -------------------------------------------------------- monitoring
    def monitoring_snapshot(self) -> dict:
        """Process + node metrics, sectioned (reference: the Codahale
        registry MonitoringService exposes over JMX). ``serving`` is the
        device scheduler's queue/batch/shed surface (docs/SERVING.md),
        ``profiler`` the kernel profiler's registry mirror (empty until
        the first profiled dispatch; retains the last profiled run after
        disable — the snapshot's ``enabled`` flag says whether numbers
        are live), ``process`` the remaining process-global counters,
        ``node`` this node's own registry (notary meters etc.)."""
        from corda_tpu_torch.node.monitoring import monitoring_snapshot

        snap = monitoring_snapshot()
        snap["node"] = self._services.metrics.snapshot()
        return snap

    def serving_metrics(self) -> dict:
        """Just the ``serving`` section — the operator's first read on a
        slow hot path (queue depth, wait time, batch occupancy, sheds)."""
        from corda_tpu_torch.node.monitoring import node_metrics

        return node_metrics().section("serving.")

    def profiler_snapshot(self) -> dict:
        """The kernel profiler's per-kernel / per-shape-bucket accounting
        (docs/OBSERVABILITY.md §Profiling): compile vs execute wall split,
        batch-efficiency ratios, bytes in/out, achieved rows/sec and the
        roofline fraction. ``{"enabled": false, "kernels": {}}`` while the
        profiler is off (the default)."""
        from corda_tpu_torch.observability import profiler

        return profiler().snapshot()

    def metrics_text(self) -> str:
        """Prometheus text exposition of the process-global AND node-local
        registries (docs/OBSERVABILITY.md §exposition) — counters as
        ``_total``, timers/meters as summaries with p50/p95/p99
        ``quantile`` labels from the reservoirs, plus the labeled
        ``device.*``/``slo.*`` families while those monitors are on. The
        scrape endpoint body."""
        from corda_tpu_torch.observability import metrics_text

        return metrics_text(self._services.metrics)

    def devicemon_snapshot(self) -> dict:
        """The per-device telemetry registry (docs/OBSERVABILITY.md
        §Device telemetry): one entry per ``torch.cuda`` ordinal with
        in-flight depth, dispatch/settle counts, real vs padded rows,
        execute-wall EWMA, completion-heartbeat age, best-effort HBM
        occupancy, and the watchdog's health flag + recent events.
        ``{"enabled": false}`` while the monitor is off (the default)."""
        from corda_tpu_torch.observability.devicemon import devices_section

        return devices_section()

    def slo_status(self) -> dict:
        """The SLO monitor's evaluated objectives (docs/OBSERVABILITY.md
        §SLO monitor): windowed p99 + error/shed rate per objective,
        breach flags, breach count and recent breach/recovery events.
        ``{"enabled": false}`` while SLO tracking is off (the default)."""
        from corda_tpu_torch.observability.slo import slo_section

        return slo_section()

    def timeline_snapshot(self) -> dict:
        """The telemetry timeline's ring snapshot (docs/OBSERVABILITY.md
        §Telemetry timeline): shared sample timestamps plus every series
        ring oldest-first — counter deltas per interval, windowed timer
        p50/p99, per-ordinal device gauges, SLO burn rates — and the mark
        deque. ``{"enabled": false}`` while the timeline is off (the
        default); ``tools_timeline.py`` renders this live."""
        from corda_tpu_torch.observability.timeseries import timeline_section

        return timeline_section()

    def flowprof_snapshot(self) -> dict:
        """Per-flow critical-path phase accounting (docs/OBSERVABILITY.md
        §Critical-path accounting): p50/p99 per phase over closed flows,
        the per-flow-class waterfall (each phase's share of the class's
        total wall — phases sum to wall by construction), and the most
        recent per-flow breakdowns. ``{"enabled": false}`` while phase
        accounting is off (the default)."""
        from corda_tpu_torch.observability.flowprof import flowprof_section

        return flowprof_section()

    def sampler_dump(self, top_n: int = 50) -> dict:
        """The wall-clock sampling profiler's folded flamegraph stacks
        per thread role (docs/OBSERVABILITY.md §Critical-path
        accounting), heaviest first, plus the sampler's measured duty
        cycle. ``{"enabled": false}`` while the sampler is off (the
        default)."""
        from corda_tpu_torch.observability.sampler import active_sampler

        s = active_sampler()
        if s is None:
            return {"enabled": False}
        return s.dump(top_n=top_n)

    def contention_snapshot(self, top_n: int = 16) -> dict:
        """The lock-contention observatory's tables (docs/OBSERVABILITY.md
        §Concurrency observatory): per-allocation-site acquire/contended
        counters with wait/hold p50/p95/p99, the top-contended table
        ranked by total wait, and the holder→waiter wait-edge view.
        ``{"enabled": false}`` while contention timing is off (the
        default)."""
        from corda_tpu_torch.observability.contention import contention_section

        return contention_section(top_n=top_n)

    def speedup_ledger(self) -> dict:
        """The causal profiler's last speedup ledger
        (docs/OBSERVABILITY.md §Causal profiler): phases ranked by
        predicted knee-qps payoff from virtual-speedup experiments, the
        per-(phase, speedup%) cells behind the ranking, and the
        planted-bottleneck validation verdict when the run carried one.
        ``{"enabled": false}`` until a causal run records a ledger."""
        from corda_tpu_torch.observability.causal import causal_section

        return causal_section()

    def flight_dump(self, path: str | None = None,
                    reason: str = "rpc") -> str:
        """Write a black-box flight-recorder dump (docs/OBSERVABILITY.md
        §Flight recorder): recent spans, the full monitoring snapshot,
        per-device state + health events, SLO status, and injected fault
        events as one JSONL file. Returns the path written (a default
        under ``CORDA_TPU_FLIGHT_DIR``/tmp when none is given)."""
        from corda_tpu_torch.observability.slo import flight_dump

        return flight_dump(path, reason=reason)

    def cluster_snapshot(self) -> dict:
        """The federated cluster document (docs/OBSERVABILITY.md
        §Cluster observatory): every cluster member's monitoring
        snapshot + SLO status with mesh-wide rollups (cluster p99,
        per-node deltas, unhealthy-node list). Federates over the
        handle registered via ``set_cluster_handle``; an unclustered
        node answers with a single-node document built from ITS OWN
        ``monitoring_snapshot()``."""
        from corda_tpu_torch.observability.federation import federated_snapshot

        return federated_snapshot(local_ops=self)

    # ------------------------------------------------------------ tracing
    def trace_dump(self, limit: int = 200) -> list:
        """The most recent finished spans from the process tracer's ring
        (span dicts, oldest first) — the raw feed behind trace tooling."""
        from corda_tpu_torch.observability import tracer

        return tracer().dump(limit=limit)

    def trace_for(self, flow_id: str) -> list:
        """Every span of the trace that contains ``flow_id`` (the
        flow→scheduler→batch→notary chain of one request), start-ordered;
        empty when the flow was unsampled or has aged out of the ring."""
        from corda_tpu_torch.observability import tracer

        return tracer().trace_for_attr("flow.id", flow_id)

    # -------------------------------------------------------------- misc
    def current_node_time(self) -> float:
        return (
            self._services.clock() if callable(self._services.clock)
            else _time.time()
        )

    def ping(self) -> str:
        return "pong"
