"""Observability: request tracing (counterpart of corda_tpu/observability).

Only ``trace`` is ported, and this package exports what the ported layers
use. The reference's other monitors (exposition, SLO, flowprof, contention,
cluster, netstats and the rest) come with their layers (ROADMAP.md, Queue 1
step 4b and later steps).
"""

from .trace import (
    NOOP_SPAN,
    SPAN_FLOW,
    SPAN_FLOW_RESPONDER,
    SPAN_FLOW_VERIFY,
    SPAN_NOTARY_ATTEST,
    SPAN_NOTARY_SUBMIT,
    TraceContext,
    tracer,
)

__all__ = [
    "NOOP_SPAN",
    "SPAN_FLOW",
    "SPAN_FLOW_RESPONDER",
    "SPAN_FLOW_VERIFY",
    "SPAN_NOTARY_ATTEST",
    "SPAN_NOTARY_SUBMIT",
    "TraceContext",
    "tracer",
]
