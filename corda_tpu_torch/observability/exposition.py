"""Prometheus-text exposition of the metric registries.

(Counterpart of corda_tpu/observability/exposition.py, copied with its import root
changed.)

The reference exposes its Codahale registry over JMX; the operator-side
capability is "point a scraper at the node and get every metric with one
read". This renders a ``MetricRegistry`` snapshot in the Prometheus text
exposition format (version 0.0.4): ``# TYPE`` headers, ``_total``
suffixes for counters, and timers/meters as summaries with explicit
``quantile`` labels fed by the registry's reservoirs — so the p50/p95/p99
the quantile upgrade added are scrapeable, not just snapshot-able.

Metric names are namespaced ``cordatpu_<name with dots as underscores>``;
the node-local registry (notary meters etc.) renders under
``cordatpu_node_*`` so its names cannot collide with the process-global
``serving.*``/``verifier.*`` families.
"""

from __future__ import annotations

import math
import os

_PREFIX = "cordatpu_"

# ---------------------------------------------------------------- exemplars
# OpenMetrics exemplar suffixes on summary quantile lines: when a timer
# reservoir sample carried a trace id (Timer.update(..., exemplar=tid)),
# the quantile line gains `# {trace_id="…"} <value>` — one hop from a bad
# p99 to the trace that produced it. Off by default: classic Prometheus
# text-format parsers reject the suffix, so an operator opts in with
# CORDA_TPU_EXEMPLARS=1 / configure_exemplars(True) once the scraper
# speaks OpenMetrics.

_exemplars_enabled = os.environ.get(
    "CORDA_TPU_EXEMPLARS", "") not in ("", "0")


def exemplars_enabled() -> bool:
    return _exemplars_enabled


def configure_exemplars(enabled: bool) -> None:
    global _exemplars_enabled
    _exemplars_enabled = bool(enabled)


# ------------------------------------------------------------------- HELP
# Operator-facing one-liners for the core families; rendered as `# HELP`
# ahead of `# TYPE` so a real Prometheus/OpenMetrics scraper ingests
# documentation with the data. Keyed by the raw (pre-sanitize, namespace-
# qualified) registry name — families without an entry render TYPE-only.
_HELP = {
    "serving.requests": "Requests admitted to the serving scheduler.",
    "serving.rows": "Work rows admitted to the serving scheduler.",
    "serving.batches": "Device batches dispatched by the scheduler.",
    "serving.shed": "Requests shed by overload protection.",
    "serving.rejected": "Requests rejected at admission.",
    "serving.wait_s": "Queue wait before dispatch, seconds.",
    "serving.batch_latency_s": "Dispatch-to-settle batch latency, seconds.",
    "serving.batch_occupancy": "Rows per dispatched batch.",
    "serving.batch_pad_waste": "Padding rows wasted per batch.",
    "serving.device_failover": "Batches failed over from device to host.",
    "slo.breach": "Edge-triggered SLO breach episodes.",
    "slo.burn_alerts": "Edge-triggered multi-window burn-rate alerts.",
    "slo.flight_dumps": "Flight-recorder dumps written.",
    "slo.flight_dumps_reclaimed":
        "Old flight dumps deleted by keep-N retention.",
    "timeline.ticks": "Telemetry timeline sampling ticks.",
    "timeline.marks": "Point events dropped onto the timeline.",
    "timeline.series": "Series rings currently held by the timeline.",
    "verifier.device_failover": "Verifier device-to-host failovers.",
    "contention.acquires": "Timed-lock acquires observed.",
    "contention.contended": "Timed-lock acquires that blocked.",
    "contention.wait_s": "Blocked-acquire wait, seconds.",
    "contention.hold_s": "Outermost lock hold, seconds.",
    "contention.sites": "Distinct lock allocation sites tracked.",
    "causal.experiments": "Virtual-speedup experiment cells run.",
    "causal.delays": "Calibrated delays inserted by experiments.",
}


def _sanitize(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if (ch.isalnum() or ch == "_") else "_")
    s = "".join(out)
    if s and s[0].isdigit():
        s = "_" + s
    return s


def escape_label_value(v) -> str:
    """Escape a label VALUE per the Prometheus text format (0.0.4):
    backslash, double-quote and newline — in that order, so the escape
    character itself never double-escapes. Every labeled family
    (``device=``, ``objective=``, ``node=``, ``edge=``) must route its
    values through here: a hostile node name (an X.500 string is
    operator input) with a quote or newline would otherwise corrupt the
    whole scrape body."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(v) -> str:
    if v is None:
        return "NaN"
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, (int,)):
        return str(v)
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "NaN"
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f)


def _head(lines, name, typ, raw=""):
    """Family header: `# HELP` (when the docs dict provides one) then
    `# TYPE` — HELP first per the exposition-format spec."""
    h = _HELP.get(raw)
    if h:
        lines.append(f"# HELP {name} {h}")
    lines.append(f"# TYPE {name} {typ}")


def _render_counter(lines, name, snap, raw=""):
    _head(lines, name, "counter", raw)
    lines.append(f"{name}_total {_fmt(snap.get('count', 0))}")


def _render_gauge(lines, name, snap, raw=""):
    value = snap.get("value")
    if not isinstance(value, (int, float, bool)) or isinstance(value, complex):
        return  # non-numeric gauges are not expositable
    _head(lines, name, "gauge", raw)
    lines.append(f"{name} {_fmt(value)}")


def _render_summary(lines, name, snap, *, quantile_keys, sum_key, unit="",
                    raw=""):
    base = name + unit
    _head(lines, base, "summary", raw)
    exemplars = (
        snap.get("exemplars") if _exemplars_enabled
        and isinstance(snap.get("exemplars"), dict) else None
    )
    # an EMPTY reservoir (no samples yet) has no quantiles: omit the
    # quantile lines entirely — a 0.0 (or NaN) p99 on a never-updated
    # timer would read as "this path is instant", the worst possible lie
    # for a latency surface. `_sum`/`_count` still render (count 0 is the
    # honest signal).
    if snap.get("count", 0):
        for q, key in quantile_keys:
            if key in snap and snap[key] is not None:
                line = f'{base}{{quantile="{q}"}} {_fmt(snap[key])}'
                tid = exemplars.get(key) if exemplars else None
                if tid:
                    line += (
                        f' # {{trace_id="{escape_label_value(tid)}"}}'
                        f" {_fmt(snap[key])}"
                    )
                lines.append(line)
    if sum_key is not None and sum_key in snap:
        lines.append(f"{base}_sum {_fmt(snap[sum_key])}")
    lines.append(f"{base}_count {_fmt(snap.get('count', 0))}")


def _render_meter(lines, name, snap, raw=""):
    _head(lines, name, "counter", raw)
    lines.append(f"{name}_total {_fmt(snap.get('count', 0))}")
    lines.append(f"# TYPE {name}_m1_rate gauge")
    lines.append(f"{name}_m1_rate {_fmt(snap.get('m1_rate', 0.0))}")
    if "p50" in snap:
        _render_summary(
            lines, name, snap, unit="_marks",
            quantile_keys=(("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")),
            sum_key=None,
        )


def _render_timer(lines, name, snap, raw=""):
    _render_summary(
        lines, name, snap, unit="_seconds",
        quantile_keys=(
            ("0.5", "p50_s"), ("0.95", "p95_s"), ("0.99", "p99_s"),
        ),
        sum_key="total_s",
        raw=raw,
    )
    lines.append(f"# TYPE {name}_seconds_max gauge")
    lines.append(f"{name}_seconds_max {_fmt(snap.get('max_s', 0.0))}")


_RENDERERS = {
    "counter": _render_counter,
    "gauge": _render_gauge,
    "meter": _render_meter,
    "timer": _render_timer,
}


def render_prometheus(snapshot: dict, *, namespace: str = "") -> str:
    """One registry snapshot (``MetricRegistry.snapshot()``) → Prometheus
    text. Unknown metric types are skipped rather than corrupting the
    exposition."""
    lines: list[str] = []
    for name in sorted(snapshot):
        snap = snapshot[name]
        if not isinstance(snap, dict):
            continue
        renderer = _RENDERERS.get(snap.get("type"))
        if renderer is None:
            continue
        raw = namespace + name
        renderer(lines, _PREFIX + _sanitize(raw), snap, raw=raw)
    return "\n".join(lines) + ("\n" if lines else "")


def metrics_text(node_registry=None) -> str:
    """The process-global registry (serving/verifier families) plus an
    optional node-local registry (rendered under the ``node_`` namespace)
    as one scrapeable document — the body behind
    ``CordaRPCOps.metrics_text()``. When the per-device telemetry
    registry or the SLO monitor is enabled, their labeled ``device.*`` /
    ``slo.*`` families append here (one attribute-read check each while
    off — the exposition must stay free for idle processes)."""
    from corda_tpu_torch.messaging.netstats import active_netstats
    from corda_tpu_torch.node.monitoring import node_metrics
    from corda_tpu_torch.observability.devicemon import active_devicemon
    from corda_tpu_torch.observability.slo import active_slo

    out = render_prometheus(node_metrics().snapshot())
    devmon = active_devicemon()
    if devmon is not None:
        lines = devmon.prometheus_lines()
        if lines:
            out += "\n".join(lines) + "\n"
    slo = active_slo()
    if slo is not None:
        lines = slo.prometheus_lines()
        if lines:
            out += "\n".join(lines) + "\n"
    nets = active_netstats()
    if nets is not None:
        lines = nets.prometheus_lines()
        if lines:
            out += "\n".join(lines) + "\n"
    from corda_tpu_torch.observability.causal import last_result
    from corda_tpu_torch.observability.causal import (
        prometheus_lines as causal_prometheus_lines,
    )
    from corda_tpu_torch.observability.contention import active_contention
    from corda_tpu_torch.observability.contention import (
        prometheus_lines as contention_prometheus_lines,
    )

    if active_contention() is not None:
        lines = contention_prometheus_lines()
        if lines:
            out += "\n".join(lines) + "\n"
    if last_result() is not None:
        lines = causal_prometheus_lines()
        if lines:
            out += "\n".join(lines) + "\n"
    if node_registry is not None:
        out += render_prometheus(node_registry.snapshot(), namespace="node.")
    return out


def parse_prometheus(text: str) -> dict:
    """Strict-enough parser for the tests: ``{sample_name(+labels): value}``
    plus ``# TYPE`` records under ``"__types__"``, ``# HELP`` text under
    ``"__help__"``, and OpenMetrics exemplar trace ids under
    ``"__exemplars__"``. Raises ``ValueError`` on any line that is
    neither a comment, blank, nor a well-formed sample — the round-trip
    guard the acceptance criteria ask for."""
    samples: dict = {}
    types: dict = {}
    help_text: dict = {}
    exemplars: dict = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            elif len(parts) >= 3 and parts[1] == "HELP":
                help_text[parts[2]] = line.split(None, 3)[3] if (
                    len(parts) >= 4) else ""
            continue
        # OpenMetrics exemplar suffix: `<sample> # {labels} <value>` —
        # split it off, validate its shape, and keep the trace id.
        exemplar_tid = None
        if " # {" in line:
            line, _, ex = line.partition(" # ")
            ex = ex.strip()
            if not (ex.startswith("{") and "} " in ex):
                raise ValueError(
                    f"line {lineno}: malformed exemplar {ex!r}"
                )
            labels_part, _, ex_value = ex.rpartition(" ")
            try:
                float(ex_value)
            except ValueError:
                raise ValueError(
                    f"line {lineno}: non-numeric exemplar value "
                    f"{ex_value!r}"
                ) from None
            pre = 'trace_id="'
            if pre in labels_part:
                exemplar_tid = labels_part.split(pre, 1)[1].rsplit(
                    '"', 1)[0]
        name, sep, value = line.rpartition(" ")
        if not sep or not name:
            raise ValueError(f"line {lineno}: malformed sample {line!r}")
        bare = name.split("{", 1)[0]
        if not bare.replace("_", "").replace(":", "").isalnum():
            raise ValueError(f"line {lineno}: bad metric name {bare!r}")
        if "{" in name and not name.endswith("}"):
            raise ValueError(f"line {lineno}: unterminated labels {name!r}")
        if value not in ("NaN", "+Inf", "-Inf"):
            try:
                float(value)
            except ValueError:
                raise ValueError(
                    f"line {lineno}: non-numeric sample value {value!r}"
                ) from None
        samples[name] = value
        if exemplar_tid is not None:
            exemplars[name] = exemplar_tid
    samples["__types__"] = types
    samples["__help__"] = help_text
    samples["__exemplars__"] = exemplars
    return samples
