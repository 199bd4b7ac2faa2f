"""Metrics federation: one versioned document for the whole cluster (the port's copy of
corda_tpu/observability/federation.py, import root changed).

``monitoring_snapshot()`` answers "how is THIS process"; operators run
3+ nodes and ask "how is the CLUSTER". ``federated_snapshot()`` gathers
every node's monitoring snapshot + SLO status through a cluster handle
(the same handle shapes the TraceAssembler accepts: a mocknet registry,
or a ``{name: rpc_ops}`` fan-in map) into one schema-versioned document
with mesh-wide rollups:

- ``cluster_p99_s`` — the cluster-level p99 merged from the per-node
  SLO windows (sample-count-weighted nearest-rank over the per-node
  windowed p99s: exact when windows are disjoint value ranges, a
  documented approximation otherwise — raw windows never leave their
  node);
- per-node DELTAS against the cluster mean (windowed p99 and closed
  flowprof flows) — the "which node is the outlier" read;
- the unhealthy-node list (any breached SLO objective, or any device
  ordinal the watchdog flagged).

The per-node sections are the EXACT local ``monitoring_snapshot()``
documents (plus the node-local registry under ``node``, matching
``CordaRPCOps.monitoring_snapshot``) — federation adds context around
them, never rewrites them. ``CordaRPCOps.cluster_snapshot()`` serves
the document over RPC (a node registered as cluster member via
``set_cluster_handle``, else a single-node document), and
``render_federated_prometheus`` exposes the rollups with escaped
``node=`` labels. Schema: docs/OBSERVABILITY.md §Cluster observatory.
"""

from __future__ import annotations

import time

FEDERATION_SCHEMA = 1

# the cluster handle a node's RPC surface federates over; None until the
# harness/driver that OWNS the cluster registers it
_handle = None


def set_cluster_handle(handle) -> None:
    """Register (or clear, with None) the cluster handle
    ``CordaRPCOps.cluster_snapshot()`` federates over."""
    global _handle
    _handle = handle


def cluster_handle():
    return _handle


def _node_snapshot(name: str, source) -> tuple[dict, dict]:
    """One node's (monitoring snapshot, slo status) through whatever
    surface the handle offers — RPC ops, a mocknet node, or a callable
    returning the pair. The snapshot must equal what the node's own
    ``CordaRPCOps.monitoring_snapshot()`` returns (reconciliation is
    test-pinned): never recompute sections, only relay them."""
    if hasattr(source, "monitoring_snapshot"):
        snap = source.monitoring_snapshot()
        slo = (source.slo_status() if hasattr(source, "slo_status")
               else snap.get("slo", {"enabled": False}))
        return snap, slo
    if hasattr(source, "services"):  # a mocknet MockNode
        from corda_tpu_torch.node.monitoring import monitoring_snapshot

        snap = monitoring_snapshot()
        snap["node"] = source.services.metrics.snapshot()
        return snap, snap.get("slo", {"enabled": False})
    if callable(source):
        snap = source()
        return snap, snap.get("slo", {"enabled": False})
    raise TypeError(
        f"cluster member {name!r} is not an ops surface, a mocknet node, "
        "or a snapshot callable"
    )


def _members(handle) -> dict:
    nodes = getattr(handle, "nodes", None)
    if isinstance(nodes, dict):
        return dict(nodes)
    if isinstance(handle, dict):
        return dict(handle)
    raise TypeError(
        "cluster handle must be a mocknet registry (.nodes dict) or a "
        f"{{name: ops}} map, got {type(handle).__name__}"
    )


def _node_p99(slo: dict) -> tuple[float, int]:
    """(worst windowed p99, window samples) across a node's evaluated
    objectives; (0.0, 0) while its SLO monitor is off."""
    worst, samples = 0.0, 0
    for st in slo.get("objectives", ()) or ():
        p99 = st.get("p99_s", 0.0)
        if p99 >= worst:
            worst, samples = p99, int(st.get("samples", 0))
    return worst, samples


def _node_flows(snap: dict) -> int:
    fp = snap.get("flowprof") or {}
    return int(fp.get("flows", 0)) if fp.get("enabled") else 0


def _unhealthy(snap: dict, slo: dict) -> bool:
    if any(st.get("breached") for st in slo.get("objectives", ()) or ()):
        return True
    devices = (snap.get("devices") or {}).get("devices") or {}
    return any(e.get("unhealthy") for e in devices.values())


def _merge_p99(pairs: list[tuple[float, int]]) -> float:
    """Sample-count-weighted nearest-rank 0.99 over the per-node windowed
    p99 values (nodes with empty windows carry no weight)."""
    weighted = sorted((p, max(1, n)) for p, n in pairs if n > 0)
    total = sum(n for _, n in weighted)
    if not total:
        return 0.0
    rank = 0.99 * total
    seen = 0
    for p, n in weighted:
        seen += n
        if seen >= rank:
            return p
    return weighted[-1][0]


def federated_snapshot(handle=None, *, local_ops=None) -> dict:
    """The cluster document. ``handle`` falls back to the registered
    cluster handle; with neither, ``local_ops`` (or nothing) yields a
    single-node document — a node outside any cluster still answers."""
    if handle is None:
        handle = _handle
    if handle is None:
        if local_ops is not None:
            name = str(local_ops.node_info().party.name) \
                if hasattr(local_ops, "node_info") else "local"
            handle = {name: local_ops}
        else:
            from corda_tpu_torch.node.monitoring import monitoring_snapshot

            handle = {"local": lambda: monitoring_snapshot()}
    members = _members(handle)
    nodes: dict[str, dict] = {}
    p99_pairs: list[tuple[float, int]] = []
    unhealthy: list[str] = []
    for name in sorted(members):
        snap, slo = _node_snapshot(name, members[name])
        p99, samples = _node_p99(slo)
        nodes[name] = {"snapshot": snap, "slo": slo}
        p99_pairs.append((p99, samples))
        if _unhealthy(snap, slo):
            unhealthy.append(name)
    names = sorted(nodes)
    p99s = {n: p for n, (p, _) in zip(names, p99_pairs)}
    flows = {n: _node_flows(nodes[n]["snapshot"]) for n in names}
    mean_p99 = sum(p99s.values()) / len(names) if names else 0.0
    mean_flows = sum(flows.values()) / len(names) if names else 0.0
    return {
        "schema": FEDERATION_SCHEMA,
        "t": time.time(),
        "nodes": nodes,
        "rollup": {
            "n_nodes": len(names),
            "cluster_p99_s": _merge_p99(p99_pairs),
            "node_p99_min_s": min(p99s.values(), default=0.0),
            "node_p99_max_s": max(p99s.values(), default=0.0),
            "unhealthy_nodes": unhealthy,
            "deltas": {
                n: {
                    "p99_delta_s": p99s[n] - mean_p99,
                    "flows_delta": flows[n] - mean_flows,
                }
                for n in names
            },
        },
    }


def render_federated_prometheus(doc: dict) -> str:
    """The rollup families of one federated document as Prometheus text
    with (escaped) ``node=`` labels — the scrape surface for whoever
    holds the cluster handle."""
    from corda_tpu_torch.observability.exposition import escape_label_value

    rollup = doc.get("rollup", {})
    unhealthy = set(rollup.get("unhealthy_nodes", ()))
    lines = [
        "# TYPE cordatpu_cluster_nodes gauge",
        f"cordatpu_cluster_nodes {rollup.get('n_nodes', 0)}",
        "# TYPE cordatpu_cluster_p99_seconds gauge",
        f"cordatpu_cluster_p99_seconds {rollup.get('cluster_p99_s', 0.0)}",
        "# TYPE cordatpu_cluster_node_p99_seconds gauge",
    ]
    deltas = rollup.get("deltas", {})
    for name in sorted(doc.get("nodes", ())):
        label = escape_label_value(name)
        p99 = _node_p99(doc["nodes"][name].get("slo", {}))[0]
        lines.append(
            f'cordatpu_cluster_node_p99_seconds{{node="{label}"}} {p99}'
        )
    lines.append("# TYPE cordatpu_cluster_node_p99_delta_seconds gauge")
    for name in sorted(deltas):
        label = escape_label_value(name)
        lines.append(
            f'cordatpu_cluster_node_p99_delta_seconds{{node="{label}"}} '
            f"{deltas[name]['p99_delta_s']}"
        )
    lines.append("# TYPE cordatpu_cluster_node_unhealthy gauge")
    for name in sorted(doc.get("nodes", ())):
        label = escape_label_value(name)
        flag = 1 if name in unhealthy else 0
        lines.append(
            f'cordatpu_cluster_node_unhealthy{{node="{label}"}} {flag}'
        )
    return "\n".join(lines) + "\n"
