"""Observability (counterpart of corda_tpu/observability): end-to-end
request tracing and the host observability layers, each off by default.

- ``trace`` — ``Span``/``Tracer`` with process-unique trace/span ids, a
  thread-local + explicitly-propagated context, wire propagation through
  session messages, a bounded in-memory ring, and an off-by-default JSONL
  sink.
- ``exposition`` — Prometheus-text rendering of the metric registries,
  plus the labeled ``device.*``/``slo.*``/``net.*``/``contention.*``/
  ``causal.*`` families while those monitors are on.
- ``devicemon`` — the per-device telemetry registry (one slot per
  ``torch.cuda`` ordinal) and its straggler/stall watchdog, fed by the
  scheduler, the mesh and the wavefront.
- ``profiler`` — the off-by-default kernel profiler: per kernel x shape
  bucket, the first dispatch's compile observation and the execute
  observations after it, timed by CUDA events on the card.
- ``slo`` — sliding-window SLO objectives over the serving priority
  classes and the black-box flight recorder (``flight_dump``/
  ``read_flight_dump``).
- ``flowprof`` — per-flow critical-path phase accounting: every flow's
  wall decomposed into a CLOSED set of phases that sum to the flow's wall,
  aggregated per flow class into a waterfall.
- ``sampler`` — wall-clock sampling profiler over
  ``sys._current_frames()`` with the blocked/running classifier.
- ``contention`` (with ``lockwatch``) — lock-contention timing per
  allocation site, the top-contended table and the holder→waiter edges.
- ``causal`` — the COZ-style causal profiler over flowprof phases.
- ``cluster`` — cross-node distributed trace assembly: the hop recorder,
  per-edge clock-skew estimates and the ``TraceAssembler``.
- ``timeseries`` — the ring-buffer telemetry timeline.

The reference's ``federation`` comes with the node layer it reports
(ROADMAP.md, Queue 1 step 9).
"""


from .causal import (
    CAUSAL_SCHEMA,
    CausalProfiler,
    SyntheticPipeline,
    causal_section,
    configure_causal,
    run_synthetic,
    validate_planted,
)
from .cluster import (
    CLUSTER_SCHEMA,
    ClusterRecorder,
    EdgeOffsetEstimator,
    TraceAssembler,
    active_cluster,
    cluster_recorder,
    cluster_section,
    configure_cluster,
)
from .devicemon import (
    DeviceMonitor,
    DeviceWatchdog,
    active_devicemon,
    configure_devicemon,
    default_device_ordinal,
    device_watchdog,
    devicemon,
)
from .contention import (
    CONTENTION_SCHEMA,
    ContentionMonitor,
    TimedContentionLock,
    active_contention,
    classify_frame,
    configure_contention,
    contention,
    contention_section,
    register_wait_site,
    timed_lock,
    wrap_lock,
)
from .exposition import (
    escape_label_value,
    metrics_text,
    parse_prometheus,
    render_prometheus,
)
from .flowprof import (
    CAUSES,
    PHASES,
    FlowProfiler,
    TimedRLock,
    active_flowprof,
    configure_flowprof,
    flowprof,
    flowprof_frame,
    flowprof_hint,
    flowprof_section,
    set_phase_listener,
)
from .profiler import (
    DeviceProfiler,
    active_profiler,
    configure_profiler,
    profiler,
    stamp_span,
)
from .sampler import (
    StackSampler,
    active_sampler,
    configure_sampler,
    sampler,
    sampler_section,
)
from .slo import (
    SLOMonitor,
    SLOObjective,
    active_slo,
    configure_slo,
    flight_dump,
    install_crash_dump,
    read_flight_dump,
    slo_monitor,
    uninstall_crash_dump,
)
from .timeseries import (
    TIMELINE_SCHEMA,
    TimelineRecorder,
    active_timeline,
    configure_timeline,
    timeline,
    timeline_section,
)
from .trace import (
    NOOP_SPAN,
    SPAN_FLOW,
    SPAN_FLOW_RESPONDER,
    SPAN_FLOW_VERIFY,
    SPAN_NET_TRANSIT,
    SPAN_NOTARY_ATTEST,
    SPAN_NOTARY_SUBMIT,
    SPAN_SERVING_BATCH,
    SPAN_SERVING_QUEUE,
    SPAN_VERIFIER_REQUEST,
    SPAN_WAVEFRONT_WINDOW,
    Span,
    TraceContext,
    Tracer,
    configure_tracing,
    current_trace_id,
    tracer,
)

__all__ = [
    "CAUSAL_SCHEMA",
    "CAUSES",
    "CLUSTER_SCHEMA",
    "CONTENTION_SCHEMA",
    "CausalProfiler",
    "ClusterRecorder",
    "ContentionMonitor",
    "DeviceMonitor",
    "DeviceProfiler",
    "DeviceWatchdog",
    "EdgeOffsetEstimator",
    "FlowProfiler",
    "NOOP_SPAN",
    "PHASES",
    "SLOMonitor",
    "SLOObjective",
    "SPAN_FLOW",
    "SPAN_FLOW_RESPONDER",
    "SPAN_FLOW_VERIFY",
    "SPAN_NET_TRANSIT",
    "SPAN_NOTARY_ATTEST",
    "SPAN_NOTARY_SUBMIT",
    "SPAN_SERVING_BATCH",
    "SPAN_SERVING_QUEUE",
    "SPAN_VERIFIER_REQUEST",
    "SPAN_WAVEFRONT_WINDOW",
    "Span",
    "StackSampler",
    "SyntheticPipeline",
    "TIMELINE_SCHEMA",
    "TimedContentionLock",
    "TimedRLock",
    "TimelineRecorder",
    "TraceAssembler",
    "TraceContext",
    "Tracer",
    "active_cluster",
    "active_contention",
    "active_devicemon",
    "active_flowprof",
    "active_profiler",
    "active_sampler",
    "active_slo",
    "active_timeline",
    "causal_section",
    "classify_frame",
    "cluster_recorder",
    "cluster_section",
    "configure_causal",
    "configure_cluster",
    "configure_contention",
    "configure_devicemon",
    "configure_flowprof",
    "configure_profiler",
    "configure_sampler",
    "configure_slo",
    "configure_timeline",
    "configure_tracing",
    "contention",
    "contention_section",
    "current_trace_id",
    "default_device_ordinal",
    "device_watchdog",
    "devicemon",
    "escape_label_value",
    "flight_dump",
    "flowprof",
    "flowprof_frame",
    "flowprof_hint",
    "flowprof_section",
    "install_crash_dump",
    "metrics_text",
    "parse_prometheus",
    "read_flight_dump",
    "register_wait_site",
    "render_prometheus",
    "run_synthetic",
    "profiler",
    "sampler",
    "sampler_section",
    "set_phase_listener",
    "slo_monitor",
    "timed_lock",
    "timeline",
    "timeline_section",
    "tracer",
    "uninstall_crash_dump",
    "validate_planted",
    "wrap_lock",
    "stamp_span",
]

# CORDA_TPU_TIMELINE=1 env opt-in, deferred to here: enabling touches
# corda_tpu_torch.node.monitoring, whose package pulls the flow engine, which
# imports THIS package — at timeseries import time that is a circular
# import, but by this line every name above is bound.
from .timeseries import _env_opt_in as _timeline_env_opt_in  # noqa: E402

_timeline_env_opt_in()

# CORDA_TPU_CONTENTION=1 likewise: run the one-time env probe now so a
# process that opts in is timing (and reports an enabled section) from
# import, not from the first active_contention() hot-path check — a
# dump-and-exit tool would otherwise read a disabled marker.
active_contention()
