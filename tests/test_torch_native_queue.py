"""The C++ durable queue engine: the port's ``messaging/native_queue.py``
over its own copy of the engine (``corda_tpu_torch/native/queue_engine.cpp``,
built with g++ into ``build/native/``) against the reference's binding
(``tests/test_native_queue.py``).

- the source is the reference's engine, byte for byte but its one comment
  naming the binding and the ``<stdexcept>`` include ``std::runtime_error``
  needs (the card's machine's GCC 13.3 refuses the source without it);
- the reference tests' ``TestContract`` cases on both packages'
  ``NativeQueueBroker`` (and the port's ``DurableQueueBroker``): FIFO and
  ack, publish dedupe, redelivery of unacked messages, nack, competing
  consumers, crash recovery by journal replay; each case's observable
  answers equal across the packages;
- the journal: after the same publishes, leases, nacks and acks the two
  engines' journal files are byte-equal once each publish record's
  enqueue time (microseconds of the wall clock) is masked, and either
  package replays the other's journal;
- ``make_broker`` picks the same engine for the same arguments;
- a flow round trip over each package's engine through
  ``BrokerMessagingClient``.

The reference's throughput floor (``TestThroughput``) is measured on the
card by ``chip_smoke.py`` phase 25a, not here."""

import dataclasses
import difflib
import struct
import threading

import pytest

from corda_tpu.crypto import generate_keypair as ref_generate_keypair
from corda_tpu.flows import FlowLogic as RefFlowLogic
from corda_tpu.flows import InitiatedBy as RefInitiatedBy
from corda_tpu_torch.crypto import generate_keypair as port_generate_keypair
from corda_tpu_torch.flows import FlowLogic as PortFlowLogic
from corda_tpu_torch.flows import InitiatedBy as PortInitiatedBy
from test_torch_layers import (  # noqa: F401  (fixtures)
    LAYERS,
    REPO,
    clean_layers,
    one_torch_thread,
)

PKGS = ("ref", "port")


def native(pkg):
    return LAYERS[pkg].native_queue


def test_engine_source_is_the_references():
    ref = open(f"{REPO}/native/queue_engine.cpp").read().splitlines()
    port = open(f"{REPO}/corda_tpu_torch/native/queue_engine.cpp").read().splitlines()
    ops = [op for op in difflib.SequenceMatcher(None, ref, port, autojunk=False).get_opcodes()
           if op[0] != "equal"]
    assert [(tag, i2 - i1, j2 - j1) for tag, i1, i2, j1, j2 in ops] == [
        ("replace", 1, 2), ("insert", 0, 1)]
    (_, i1, _, j1, _), (_, _, _, k1, _) = ops
    assert "corda_tpu/messaging/native_queue.py" in ref[i1]
    assert "corda_tpu_torch/messaging/native_queue.py" in port[j1]
    assert port[k1].startswith("#include <stdexcept>")


def test_both_engines_build():
    for pkg in PKGS:
        assert native(pkg).native_engine_available()
    lib = native("port")._load()
    assert "build/native/libqueue_engine_" in lib._name


BROKERS = {
    "ref-native": lambda path=":memory:", vis=30.0: native("ref").NativeQueueBroker(path, vis),
    "port-native": lambda path=":memory:", vis=30.0: native("port").NativeQueueBroker(path, vis),
    "port-sqlite": lambda path=":memory:", vis=30.0: LAYERS["port"].queue.DurableQueueBroker(
        path, vis),
}


def _fifo(b):
    for i in range(5):
        b.publish("q", f"m{i}".encode(), msg_id=f"id{i}")
    got = []
    for _ in range(5):
        msg = b.consume("q", timeout=1)
        got.append((msg.payload, msg.msg_id, msg.redelivered))
        b.ack(msg.msg_id)
    return got, b.consume("q", timeout=0.05), b.depth("q"), b.queues()


def _dedupe(b):
    b.publish("q", b"once", msg_id="dup")
    b.publish("q", b"twice", msg_id="dup")
    msg = b.consume("q", timeout=1)
    b.ack(msg.msg_id)
    return msg.payload, b.consume("q", timeout=0.05)


def _nack(b):
    b.publish("q", b"x", msg_id="n1", sender="s", reply_to="r")
    msg = b.consume("q", timeout=1)
    b.nack(msg.msg_id)
    again = b.consume("q", timeout=1)
    b.ack("n1")
    return (again.msg_id, again.payload, again.sender, again.reply_to, again.redelivered)


def _competing(b):
    n = 40
    for i in range(n):
        b.publish("work", f"{i}".encode(), msg_id=f"c{i}")
    seen: set = set()
    lock = threading.Lock()

    def worker():
        while True:
            msg = b.consume("work", timeout=0.3)
            if msg is None:
                return
            with lock:
                seen.add(msg.payload.decode())
            b.ack(msg.msg_id)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    return sorted(seen, key=int)


@pytest.mark.parametrize("case", [_fifo, _dedupe, _nack, _competing])
def test_contract_cases_equal(case):
    out = {}
    for name, factory in BROKERS.items():
        b = factory()
        try:
            out[name] = case(b)
        finally:
            b.close()
    assert out["port-native"] == out["ref-native"] == out["port-sqlite"]


def test_unacked_redelivers_in_both():
    out = {}
    for name, factory in BROKERS.items():
        b = factory(vis=0.2)
        try:
            b.publish("q", b"work", msg_id="w1")
            first = b.consume("q", timeout=1)
            again = b.consume("q", timeout=2)
            b.ack(again.msg_id)
            out[name] = (first.redelivered, again.msg_id, again.redelivered)
        finally:
            b.close()
    assert out["port-native"] == out["ref-native"] == (False, "w1", True)


def test_crash_recovery_equal(tmp_path):
    out = {}
    for name, factory in BROKERS.items():
        path = str(tmp_path / f"{name}.journal")
        b = factory(path)
        b.publish("q", b"acked", msg_id="a1")
        b.publish("q", b"pending1", msg_id="p1")
        b.publish("q", b"pending2", msg_id="p2")
        msg = b.consume("q", timeout=1)
        b.ack(msg.msg_id)
        b.close()
        b2 = factory(path)
        try:
            got = []
            for _ in range(2):
                m = b2.consume("q", timeout=1)
                got.append((m.payload, m.redelivered))
                b2.ack(m.msg_id)
            b2.publish("q", b"replay", msg_id="a1")
            out[name] = (sorted(got), b2.consume("q", timeout=0.05))
        finally:
            b2.close()
    assert out["port-native"] == out["ref-native"] == out["port-sqlite"]


def _records(path) -> list:
    """The journal's records, each publish's enqueue time zeroed."""
    data = open(path, "rb").read()
    out, pos = [], 0
    while pos < len(data):
        kind = data[pos]
        (n,) = struct.unpack_from("<I", data, pos + 1)
        body = bytearray(data[pos + 5:pos + 5 + n])
        if kind == 1:
            off = 0
            for _ in range(4):              # queue, id, sender, reply_to
                (ln,) = struct.unpack_from("<H", body, off)
                off += 2 + ln
            body[off:off + 8] = bytes(8)    # u64 enqueued_us
        out.append(bytes([kind]) + struct.pack("<I", n) + bytes(body))
        pos += 5 + n
    return out


def _journal_ops(b):
    for i in range(12):
        b.publish(f"q{i % 3}", bytes([i]) * (i * 7), msg_id=f"j{i}", sender=f"s{i % 2}",
                  reply_to="r" if i % 4 == 0 else "")
    b.publish("q0", b"dup", msg_id="j0")
    for q in ("q0", "q1", "q2"):
        m = b.consume(q, timeout=1)
        if q == "q1":
            b.nack(m.msg_id)
        else:
            b.ack(m.msg_id)
    m = b.consume("q1", timeout=1)
    b.ack(m.msg_id)


def test_journals_byte_equal_but_enqueue_times(tmp_path):
    paths = {}
    for pkg in PKGS:
        paths[pkg] = str(tmp_path / f"{pkg}.journal")
        b = native(pkg).NativeQueueBroker(paths[pkg])
        _journal_ops(b)
        b.close()
    ref, port = _records(paths["ref"]), _records(paths["port"])
    assert port == ref
    assert {r[0] for r in ref} == {1, 2, 3}
    assert b"".join(port) == b"".join(ref)
    # either package replays the other's journal to the same pending set
    pending = {}
    for pkg, other in (("ref", "port"), ("port", "ref")):
        b = native(pkg).NativeQueueBroker(paths[other])
        try:
            pending[pkg] = {q: b.depth(q) for q in ("q0", "q1", "q2")}
        finally:
            b.close()
    assert pending["ref"] == pending["port"]


@pytest.mark.parametrize("kw", [{}, {"path": "x.journal"}, {"path": "x.journal", "shared": False},
                                {"prefer_native": False}])
def test_make_broker_picks_the_same_engine(tmp_path, kw):
    kinds = {}
    for pkg in PKGS:
        args = dict(kw)
        if "path" in args:
            args["path"] = str(tmp_path / f"{pkg}-{args['path']}")
        b = native(pkg).make_broker(**args)
        kinds[pkg] = type(b).__name__
        b.close()
    assert kinds["port"] == kinds["ref"]


# -------------------------------------------------------- a flow over it

PARTIES: dict = {}


@dataclasses.dataclass
class RefPing(RefFlowLogic):
    peer_name: str

    def call(self):
        s = self.initiate_flow(PARTIES["ref"][self.peer_name])
        return s.send_and_receive(int, 20).unwrap(lambda x: x)


@RefInitiatedBy(RefPing)
class RefPong(RefFlowLogic):
    def __init__(self, session):
        self.session = session

    def call(self):
        v = self.session.receive(int).unwrap(lambda x: x)
        self.session.send(v + 2)


@dataclasses.dataclass
class PortPing(PortFlowLogic):
    peer_name: str

    def call(self):
        s = self.initiate_flow(PARTIES["port"][self.peer_name])
        return s.send_and_receive(int, 20).unwrap(lambda x: x)


@PortInitiatedBy(PortPing)
class PortPong(PortFlowLogic):
    def __init__(self, session):
        self.session = session

    def call(self):
        v = self.session.receive(int).unwrap(lambda x: x)
        self.session.send(v + 2)


@pytest.mark.parametrize("pkg", PKGS)
def test_flow_round_trip_over_the_native_broker(pkg):
    import importlib

    root = LAYERS[pkg].root
    flows = importlib.import_module(f"{root}.flows")
    ledger = importlib.import_module(f"{root}.ledger")
    messaging = importlib.import_module(f"{root}.messaging")
    keypair = ref_generate_keypair if pkg == "ref" else port_generate_keypair
    a = ledger.Party(ledger.CordaX500Name("NA", "X", "GB"), keypair().public)
    b = ledger.Party(ledger.CordaX500Name("NB", "X", "GB"), keypair().public)
    PARTIES[pkg] = {str(a.name): a, str(b.name): b}
    broker = native(pkg).NativeQueueBroker()
    smm_a = flows.StateMachineManager(messaging.BrokerMessagingClient(broker, str(a.name)),
                                      flows.CheckpointStorage(), a, PARTIES[pkg].get)
    smm_b = flows.StateMachineManager(messaging.BrokerMessagingClient(broker, str(b.name)),
                                      flows.CheckpointStorage(), b, PARTIES[pkg].get)
    try:
        ping = RefPing if pkg == "ref" else PortPing
        assert smm_a.start_flow(ping(str(b.name))).result.result(timeout=60) == 22
    finally:
        smm_a.stop()
        smm_b.stop()
        broker.close()
