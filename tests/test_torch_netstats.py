"""Network-path telemetry and the cluster observatory: the port's
``messaging/netstats.py`` and ``observability/cluster.py`` against the
reference's, fed the same seeded sequences under the reference tests'
injected clock (``tests/test_observatory.py``).

- ``NetTelemetry``: the same sends, retransmits, deliveries, drops, delays,
  duplicates and partition checks give an equal ``snapshot()`` (edges,
  suspects, events), equal quantiles and byte-equal ``prometheus_lines()``,
  over seeded random sequences and the reference tests' own scenarios;
- both transports' stamps: the in-memory network under a fault plan and
  the broker client over ``DurableQueueBroker`` give equal edge ledgers;
- ``ClusterRecorder``, ``EdgeOffsetEstimator`` and ``TraceAssembler``: the
  same hops and spans give equal hops, offsets, corrected transits and
  assembled traces (their critical paths included);
- the ``net`` kind of a flight dump reads back equal in both packages.

Exact equality throughout; only wall-clock fields are left out where the
transport stamps with the real clock."""

import random

import pytest

from test_torch_layers import (  # noqa: F401  (fixtures)
    LAYERS,
    FakeClock,
    clean_layers,
    one_torch_thread,
    strip_times,
)

PKGS = ("ref", "port")


def telemetry(pkg: str, deadline: float = 2.0):
    clock = FakeClock()
    t = LAYERS[pkg].netstats.NetTelemetry(partition_deadline_s=deadline, clock=clock)
    t.enable()
    return t, clock


def drive(pkg: str, seed: int, n: int = 400) -> dict:
    """A seeded sequence of every stamp over five nodes, with partition
    checks, through package ``pkg``'s ``NetTelemetry``."""
    rng = random.Random(seed)
    t, clock = telemetry(pkg, deadline=rng.choice((0.5, 2.0)))
    nodes = ["a", "b", "c", 'd"q\\x', "e\nz"]
    sent: list = []
    out = {"checks": []}
    for i in range(n):
        src, dst = rng.sample(nodes, 2)
        op = rng.random()
        if op < 0.3:
            mid = f"m{i}"
            t.on_send(src, dst, mid)
            sent.append((src, dst, mid, 0))
        elif op < 0.4 and sent:
            src, dst, mid, k = sent[rng.randrange(len(sent))]
            t.on_send(src, dst, f"{mid}~{k + 1}")
            sent.append((src, dst, mid, k + 1))
        elif op < 0.65 and sent:
            src, dst, mid, k = sent.pop(rng.randrange(len(sent)))
            t.on_deliver(src, dst, mid if k == 0 else f"{mid}~{k}")
        elif op < 0.72:
            t.on_drop(src, dst, rng.choice(("partition", "down", "drop", "spoof")))
        elif op < 0.78:
            t.on_delay(src, dst, rng.randint(1, 4))
        elif op < 0.82:
            t.on_duplicate(src, dst)
        elif op < 0.9:
            out["checks"].append(t.check_partitions())
        clock.advance(rng.expovariate(20.0))
    out["snapshot"] = strip_times(t.snapshot())
    out["checks"] = strip_times(out["checks"])
    out["p99"] = t.transit_p99_s()
    out["retransmits"] = t.total_retransmits()
    out["prometheus"] = "\n".join(t.prometheus_lines())
    return out


@pytest.mark.parametrize("seed", range(8))
def test_seeded_sequence_equal(seed):
    ref, port = drive("ref", seed), drive("port", seed)
    assert port["snapshot"] == ref["snapshot"]
    assert port["checks"] == ref["checks"]
    assert (port["p99"], port["retransmits"]) == (ref["p99"], ref["retransmits"])
    assert port["prometheus"].encode() == ref["prometheus"].encode()
    assert ref["snapshot"]["edges"]


@pytest.mark.parametrize("seed", range(3))
def test_prometheus_lines_parse_in_both(seed):
    text = drive("port", seed)["prometheus"] + "\n"
    for pkg in PKGS:
        parsed = LAYERS[pkg].exposition.parse_prometheus(text)
        assert any("net_edge_delivered" in k for k in parsed)


def _episodes(pkg):
    """The reference's partition-episode scenario."""
    t, clock = telemetry(pkg)
    out = []
    t.on_send("a", "b", "m1")
    out.append(t.check_partitions())
    clock.advance(3.0)
    out.append(t.check_partitions())
    clock.advance(10.0)
    out.append(t.check_partitions())
    out.append(t.snapshot())
    t.on_deliver("a", "b", "m1")
    out.append(t.snapshot())
    t.on_send("a", "b", "m2")
    clock.advance(3.0)
    out.append(t.check_partitions())
    out.append(t.snapshot())
    return out


def _transit(pkg):
    t, clock = telemetry(pkg)
    t.on_send("a", "b", "m1")
    clock.advance(1.0)
    t.on_send("a", "b", "m1~1")
    clock.advance(0.5)
    t.on_deliver("a", "b", "m1~1")
    t.on_drop("a", "b", "partition")
    t.on_drop("a", "b", "down")
    t.on_delay("a", "b", 3)
    t.on_duplicate("a", "b")
    t.on_send("a", "c", "m2")
    clock.advance(0.4)
    t.on_deliver("a", "c", "m2")
    return [t.snapshot(), t.transit_p99_s(), t.total_retransmits(), t.prometheus_lines()]


@pytest.mark.parametrize("scenario", [_episodes, _transit])
def test_reference_scenarios_equal(scenario):
    # events carry the wall clock's time.time() beside the injected clock
    assert strip_times(scenario("port")) == strip_times(scenario("ref"))


def test_logical_msg_id_equal():
    for mid in ("m1", "m1~3", "m~1~2", "", "~", "a~b~c~"):
        assert (LAYERS["port"].netstats.logical_msg_id(mid)
                == LAYERS["ref"].netstats.logical_msg_id(mid))


def _wire(pkg: str) -> dict:
    """The in-memory network's stamps under a seeded fault plan: drops,
    delays, duplicates and a partition, pumped by hand."""
    import importlib

    root = LAYERS[pkg].root
    fi = importlib.import_module(f"{root}.faultinject")
    network = importlib.import_module(f"{root}.messaging.network")
    plan = fi.FaultPlan(seed=11, drop_p=0.2, delay_p=0.2, delay_rounds=(1, 2),
                        duplicate_p=0.1, partitions=(
                            fi.Partition(4, 6, frozenset({"n1"}), frozenset({"n3"})),))
    net = network.InMemoryMessagingNetwork(fault_injector=fi.FaultInjector(plan))
    names = ["n1", "n2", "n3"]
    nodes = {name: net.create_node(name) for name in names}
    for n in nodes.values():
        n.add_handler("t", lambda m: None)
    LAYERS[pkg].netstats.configure_netstats(enabled=True, reset=True,
                                            partition_deadline_s=60.0)
    rng = random.Random(5)
    for i in range(60):
        src, dst = rng.sample(names, 2)
        nodes[src].send(dst, "t", b"x", msg_id=f"w{i}")
        if i % 3 == 0:
            net.pump()
    for _ in range(8):
        net.pump()
    snap = strip_times(LAYERS[pkg].netstats.netstats().snapshot())
    for e in snap["edges"].values():
        for k in [k for k in e if k.startswith("transit_")]:
            del e[k]
    return snap


def test_in_memory_network_stamps_equal():
    ref, port = _wire("ref"), _wire("port")
    assert port == ref
    assert sum(e["drops"] for e in ref["edges"].values()) > 0
    assert sum(e["delivered"] for e in ref["edges"].values()) > 0


def _broker(pkg: str, tmp_path) -> dict:
    import importlib

    root = LAYERS[pkg].root
    queue = importlib.import_module(f"{root}.messaging.queue")
    bc = importlib.import_module(f"{root}.messaging.broker_client")
    broker = queue.DurableQueueBroker(str(tmp_path / f"{pkg}.db"))
    LAYERS[pkg].netstats.configure_netstats(enabled=True, reset=True)
    got = []
    a = bc.BrokerMessagingClient(broker, "alice")
    b = bc.BrokerMessagingClient(broker, "bob")
    try:
        b.add_handler("t", lambda m, *ack: got.append(m.payload))
        for i in range(5):
            a.send("bob", "t", f"p{i}".encode(), msg_id=f"b{i}")
        import time

        deadline = time.monotonic() + 30
        while len(got) < 5 and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        a.stop()
        b.stop()
        broker.close()
    snap = LAYERS[pkg].netstats.netstats().snapshot()
    edges = {k: {f: v for f, v in e.items() if not f.startswith("transit_")}
             for k, e in snap["edges"].items()}
    return {"got": sorted(got), "edges": edges}


def test_broker_client_stamps_equal(tmp_path):
    ref, port = _broker("ref", tmp_path), _broker("port", tmp_path)
    assert port == ref
    assert ref["edges"]["alice->bob"]["delivered"] == 5


# ----------------------------------------------------------- the cluster

def _recorder(pkg: str, seed: int):
    rng = random.Random(seed)
    rec = LAYERS[pkg].cluster.ClusterRecorder()
    rec.enable()
    nodes = ["A", "B", "C"]
    skew = {"A": 0.0, "B": 5.0, "C": -2.5}
    t = 100.0
    for i in range(120):
        src, dst = rng.sample(nodes, 2)
        kind = rng.choice(("init", "data", "end"))
        tid = rng.choice(("t1", "t2", ""))
        mid = f"h{i}"
        t += rng.random() * 0.1
        rec.note_send(src, dst, kind, mid, tid, now=t + skew[src])
        if rng.random() < 0.3:
            rec.note_send(src, dst, kind, mid, tid, now=t + 0.5 + skew[src])
        if rng.random() < 0.85:
            transit = 0.005 + rng.random() * 0.02
            rec.note_recv(dst, src, mid, rng.choice((tid, "", "other")),
                          now=t + transit + skew[dst])
    rec.note_recv("B", "A", "ghost", "t1", now=1.0)
    hops = rec.hops()
    est = LAYERS[pkg].cluster.EdgeOffsetEstimator(hops)
    return {
        "hops": hops, "t1": rec.hops_for("t1"), "snapshot": rec.snapshot(),
        "offsets": {(a, b): est.offset_s(a, b) for a in nodes for b in nodes if a != b},
        "corrected": [est.corrected_transit_s(h) for h in hops],
    }


@pytest.mark.parametrize("seed", range(4))
def test_recorder_and_offsets_equal(seed):
    ref, port = _recorder("ref", seed), _recorder("port", seed)
    assert port == ref
    assert ref["hops"]


def _spans(seed: int) -> dict:
    """Three nodes' span dumps of one trace (and a linked one)."""
    rng = random.Random(seed)
    dumps = {}
    t = 100.0
    for node in ("A", "B", "C"):
        spans = []
        for j in range(4):
            start = t + rng.random()
            dur = rng.random() * 0.5
            spans.append({"trace_id": "t1" if j < 3 else "t9", "span_id": f"{node}{j}",
                          "parent_id": None if j == 0 else f"{node}0",
                          "name": rng.choice(("flow", "flow.responder", "notary.attest")),
                          "start_s": start, "end_s": start + dur, "duration_s": dur,
                          "attrs": {"node": node, "flow.id": f"f{node}"},
                          "links": [] if j < 3 else ["t1:A0"]})
        dumps[node] = spans
    return dumps


def _assemble(pkg: str, seed: int):
    cl = LAYERS[pkg].cluster
    rec = cl.ClusterRecorder()
    rec.enable()
    rng = random.Random(seed)
    for i in range(12):
        src, dst = rng.sample(["A", "B", "C"], 2)
        t0 = 100.0 + i * 0.05
        rec.note_send(src, dst, rng.choice(("init", "data")), f"x{i}", "t1", now=t0)
        rec.note_recv(dst, src, f"x{i}", "t1", now=t0 + 0.01 + rng.random() * 0.01)
    dumps = _spans(seed)
    out = [cl.TraceAssembler(dumps, recorder=rec).assemble("t1"),
           cl.TraceAssembler({k: (lambda v=v: v) for k, v in dumps.items()},
                             recorder=rec).assemble(flow_id="fB"),
           cl.TraceAssembler({"n1": []}, recorder=rec).assemble(flow_id="nope")]
    for bad in ((lambda: cl.TraceAssembler({}, recorder=rec).assemble()),
                (lambda: cl.TraceAssembler(42).assemble("t1"))):
        try:
            bad()
        except Exception as e:  # the error is part of the answer
            out.append(type(e).__name__)
    return out


@pytest.mark.parametrize("seed", range(3))
def test_trace_assembly_equal(seed):
    ref, port = _assemble("ref", seed), _assemble("port", seed)
    assert port == ref
    assert ref[0]["hops"] and ref[0]["critical_path"] is not None
    assert ref[-2:] == ["ValueError", "TypeError"]


def test_sections_equal_through_the_process_monitors():
    out = {}
    for pkg in PKGS:
        L = LAYERS[pkg]
        n = L.netstats.configure_netstats(enabled=True, reset=True)
        c = L.cluster.configure_cluster(enabled=True, reset=True)
        n.on_send("a", "b", "m1")
        n.on_drop("b", "a", "down")
        c.note_send("a", "b", "data", "m1", "t", now=1.0)
        c.note_recv("b", "a", "m1", "t", now=1.5)
        net = L.netstats.netstats_section()
        for e in net["edges"].values():
            e.pop("oldest_pending_age_s", None)
        out[pkg] = (net, L.cluster.cluster_section(),
                    {k for k in L.monitoring.node_metrics().snapshot()
                     if k.startswith(("net.", "cluster."))})
    assert out["port"][:2] == out["ref"][:2]
    # the reference's registry may hold more: other files of this process
    # drove its layers
    assert out["port"][2] and out["port"][2] <= out["ref"][2]


def test_flight_dump_net_kind_equal(tmp_path):
    out = {}
    for pkg in PKGS:
        L = LAYERS[pkg]
        L.netstats.configure_netstats(enabled=True, reset=True)
        L.netstats.netstats().on_send("a", "b", "m1")
        L.netstats.netstats().on_deliver("a", "b", "m1")
        path = L.slo.flight_dump(str(tmp_path / f"{pkg}.jsonl"), reason="net")
        got = L.slo.read_flight_dump(path)["net"]
        for e in got["edges"].values():
            for k in [k for k in e if k.startswith("transit_")]:
                del e[k]
        out[pkg] = got
        L.netstats.configure_netstats(enabled=False, reset=True)
        off = L.slo.read_flight_dump(L.slo.flight_dump(str(tmp_path / f"{pkg}-off.jsonl")))
        assert off["net"] == {"enabled": False}
    assert out["port"] == out["ref"]
    assert "a->b" in out["ref"]["edges"]
