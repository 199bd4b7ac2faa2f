"""The flow runtime: the port's engine, sessions, checkpoints and messaging
against the reference's, on the scenarios of tests/test_flows.py.

Every scenario runs once on each package (``pkg`` is ``ref`` or ``port``)
with the same flows, defined below for each package's ``FlowLogic`` at
module level (a parked or restored flow is rebuilt from its class path),
and must give the same result or the same error:

- session rounds (``CounterFlow``), driven by the background pump and by
  manual pumping of the in-memory network;
- a responder's ``FlowException`` propagating to the initiator, and an
  open with no registered responder rejected;
- recorded entropy;
- a flow that parks (grace 0) and resumes by replay, keeping a recorded
  value bit-identical across the replay;
- a crash of the initiating node mid-protocol over ``DurableQueueBroker`` +
  ``BrokerMessagingClient``, restored from its checkpoints;
- a kill, and the op log of a finished exchange;
- the port's mock network's parking grace, and its engine's park count.

The session messages and ``FetchRequest`` encode to the same CBE bytes in
both packages."""

import dataclasses
import secrets
import threading
import time
import types
from concurrent.futures import TimeoutError as FutureTimeout

import pytest
import torch

import corda_tpu.crypto as ref_crypto
import corda_tpu.flows as ref_flows
import corda_tpu.flows.sessions as ref_sessions
import corda_tpu.ledger as ref_ledger
import corda_tpu.messaging as ref_messaging
import corda_tpu.serialization as ref_serialization
import corda_tpu_torch.crypto as port_crypto
import corda_tpu_torch.flows as port_flows
import corda_tpu_torch.flows.sessions as port_sessions
import corda_tpu_torch.ledger as port_ledger
import corda_tpu_torch.messaging as port_messaging
import corda_tpu_torch.serialization as port_serialization


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Beside the suite's other worker processes a torch thread pool only
    contends, so these tests run torch on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pkg(flows, sessions, ledger, messaging, serialization, crypto):
    return types.SimpleNamespace(
        flows=flows, sessions=sessions, ledger=ledger, messaging=messaging,
        serialization=serialization, crypto=crypto, parties={}, gates={},
    )


PKGS = {
    "ref": _pkg(ref_flows, ref_sessions, ref_ledger, ref_messaging,
                ref_serialization, ref_crypto),
    "port": _pkg(port_flows, port_sessions, port_ledger, port_messaging,
                 port_serialization, port_crypto),
}

# fixed keys: both packages' nodes carry the same identities
_SEEDS = {"NodeA": b"\x0a" * 32, "NodeB": b"\x0b" * 32}


def _party(P, name):
    kp = P.crypto.derive_keypair_from_entropy(4, _SEEDS[name])
    return P.ledger.Party(P.ledger.CordaX500Name(name, "City", "GB"), kp.public)


for _P in PKGS.values():
    for _name in _SEEDS:
        _p = _party(_P, _name)
        _P.parties[str(_p.name)] = _p
A_NAME = str(_party(PKGS["ref"], "NodeA").name)
B_NAME = str(_party(PKGS["ref"], "NodeB").name)


def _define(tag, P):
    """This package's test flows, named ``<Tag><Flow>`` at module level."""
    FlowLogic, FlowException = P.flows.FlowLogic, P.flows.FlowException

    @dataclasses.dataclass
    class CounterFlow(FlowLogic):
        peer_name: str
        rounds: int

        def call(self):
            s = self.initiate_flow(P.parties[self.peer_name])
            total = 0
            for _ in range(self.rounds):
                total = s.send_and_receive(int, total + 1).unwrap(lambda x: x)
            return total

    class CounterResponder(FlowLogic):
        def __init__(self, session):
            self.session = session

        def call(self):
            while True:
                try:
                    v = self.session.receive(int).unwrap(lambda x: x)
                except FlowException:
                    return
                gate = P.gates.get("responder_hold")
                if gate is not None and v > gate["after"]:
                    gate["reached"].set()
                    gate["event"].wait(timeout=30)
                self.session.send(v + 1)

    @dataclasses.dataclass
    class FailingFlow(FlowLogic):
        peer_name: str

        def call(self):
            s = self.initiate_flow(P.parties[self.peer_name])
            s.send(1)
            return s.receive(int).unwrap(lambda x: x)

    class FailingResponder(FlowLogic):
        def __init__(self, session):
            self.session = session

        def call(self):
            self.session.receive(int)
            raise FlowException("deal rejected")

    @dataclasses.dataclass
    class EntropyFlow(FlowLogic):
        def call(self):
            a = self.entropy(16)
            b = self.entropy(16)
            return (a.hex(), b.hex())

    @dataclasses.dataclass
    class Unregistered(FlowLogic):
        peer_name: str

        def call(self):
            self.initiate_flow(P.parties[self.peer_name])

    @dataclasses.dataclass
    class BuildThenWait(FlowLogic):
        """Records a salt, then parks on a receive; the replay must see
        the recorded salt again."""

        peer_name: str

        def call(self):
            salt = self.record(lambda: secrets.token_bytes(32))
            P.gates.setdefault("salts", []).append(salt)
            s = self.initiate_flow(P.parties[self.peer_name])
            s.send(1)
            s.receive(int)
            return salt.hex()

    class BuildWaitResponder(FlowLogic):
        def __init__(self, session):
            self.session = session

        def call(self):
            self.session.receive(int)
            P.gates["hold"].wait(timeout=30)
            self.session.send(2)

    @dataclasses.dataclass
    class NapFlow(FlowLogic):
        seconds: float

        def call(self):
            self.sleep(self.seconds)
            return "rested"

    out = {k: v for k, v in locals().items()
           if isinstance(v, type) and v.__qualname__.startswith("_define.")}
    for name, cls in out.items():
        qual = tag.capitalize() + name
        cls.__name__ = cls.__qualname__ = qual
        globals()[qual] = cls
    # registered after the renames: the responder registry keys on the
    # initiator's class path
    for init, resp in (("CounterFlow", "CounterResponder"),
                       ("FailingFlow", "FailingResponder"),
                       ("BuildThenWait", "BuildWaitResponder")):
        P.flows.InitiatedBy(out[init])(out[resp])
    return types.SimpleNamespace(**out)


for _tag, _P in PKGS.items():
    _P.f = _define(_tag, _P)


class Net:
    """Two engines over one in-memory network."""

    def __init__(self, P, pump=True, **smm_kw):
        self.P = P
        self.net = P.messaging.InMemoryMessagingNetwork()
        if pump:
            self.net.start_pumping()
        self.smm = {
            name: P.flows.StateMachineManager(
                self.net.create_node(name), P.flows.CheckpointStorage(),
                P.parties[name], P.parties.get, **smm_kw,
            )
            for name in (A_NAME, B_NAME)
        }
        self.a, self.b = self.smm[A_NAME], self.smm[B_NAME]

    def drive(self, fut, timeout=30.0):
        """Manual mode: pump rounds until ``fut`` settles; between rounds
        that move nothing, wait on the future itself (the flows run on the
        engines' workers)."""
        end = time.monotonic() + timeout
        while not fut.done():
            if not self.net.pump():
                try:
                    fut.exception(timeout=0.002)
                except FutureTimeout:
                    pass
            assert time.monotonic() < end, "flow did not settle"
        return fut.result()

    def stop(self):
        for smm in self.smm.values():
            smm.stop()
        self.net.stop_pumping()


@pytest.fixture(params=["ref", "port"])
def P(request):
    P = PKGS[request.param]
    P.gates.clear()
    yield P
    for gate in list(P.gates.values()):
        if isinstance(gate, dict) and "event" in gate:
            gate["event"].set()
        elif isinstance(gate, threading.Event):
            gate.set()
    P.gates.clear()


def _wait_responders_done(smm, timeout=5.0):
    end = time.monotonic() + timeout
    while smm.flows_in_progress():
        assert time.monotonic() < end, "responder did not finish"
        with smm._lock:
            smm._lock.wait(timeout=0.01)


# ------------------------------------------------------------ scenarios


@pytest.mark.parametrize("rounds,expect", [(1, 2), (4, 8)])
def test_round_trips(P, rounds, expect):
    net = Net(P)
    try:
        h = net.a.start_flow(P.f.CounterFlow(B_NAME, rounds))
        assert h.result.result(timeout=30) == expect
        assert net.a.flows_in_progress() == []
        _wait_responders_done(net.b)
        # a finished flow leaves no checkpoint on either side
        assert net.a.checkpoints.all_flows() == []
    finally:
        net.stop()


def test_round_trips_manual_pump(P):
    net = Net(P, pump=False)
    try:
        h = net.a.start_flow(P.f.CounterFlow(B_NAME, 3))
        assert net.drive(h.result) == 6
        net.net.run_until_quiescent()
    finally:
        net.stop()


def test_flow_exception_propagates(P):
    net = Net(P, pump=False)
    try:
        h = net.a.start_flow(P.f.FailingFlow(B_NAME))
        with pytest.raises(P.flows.FlowException, match="deal rejected") as err:
            net.drive(h.result)
        assert type(err.value).__name__ == "FlowException"
        assert str(err.value) == "deal rejected"
    finally:
        net.stop()


def test_no_responder_rejected(P):
    net = Net(P)
    try:
        h = net.a.start_flow(P.f.Unregistered(B_NAME))
        with pytest.raises(P.flows.FlowException) as err:
            h.result.result(timeout=30)
        name = f"{__name__}:{P.f.Unregistered.__qualname__}"
        assert str(err.value) == f"session rejected: no responder registered for {name}"
    finally:
        net.stop()


def test_expired_deadline_rejected_by_responder(P):
    """A deadline that passes while the SessionInit is undelivered: the
    initiator's retransmit budget is the deadline, so it fails itself;
    the Init, delivered late, is refused by the responder's node, which
    spawns nothing and remembers the refusal."""
    net = Net(P, pump=False)
    try:
        h = net.a.start_flow(P.f.CounterFlow(B_NAME, 1), deadline_s=0.2)
        with pytest.raises(P.flows.FlowException) as err:
            h.result.result(timeout=10)
        assert str(err.value) == "flow deadline exceeded"
        net.net.run_until_quiescent()
        assert net.b.flows_in_progress() == [] and net.b.checkpoints.all_flows() == []
        assert net.b.checkpoints.init_flow_id(f"{h.flow_id}:op0") == (
            "rejected:flow deadline exceeded before responder start")
    finally:
        net.stop()


def test_entropy_recorded(P):
    net = Net(P)
    try:
        a, b = net.a.start_flow(P.f.EntropyFlow()).result.result(timeout=30)
        assert a != b and len(bytes.fromhex(a)) == 16
    finally:
        net.stop()


def test_blocked_flow_parks_and_resumes(P):
    net = Net(P, parking_grace_s=0.0, max_workers=4)
    try:
        P.gates["responder_hold"] = {
            "after": 0, "event": threading.Event(), "reached": threading.Event(),
        }
        h = net.a.start_flow(P.f.CounterFlow(B_NAME, 3))
        assert P.gates["responder_hold"]["reached"].wait(timeout=10)
        end = time.monotonic() + 10
        with net.a._lock:
            # the initiator parks: its executor dropped, its wake key held
            while not (net.a._park_key_of and h.flow_id not in net.a._flows):
                assert time.monotonic() < end, "initiator never parked"
                net.a._lock.wait(timeout=0.01)
            assert net.a.flows_detail()[h.flow_id].startswith("parked@")
        P.gates["responder_hold"]["event"].set()
        assert h.result.result(timeout=30) == 6
        assert net.a.flows_in_progress() == []
    finally:
        net.stop()


def test_parked_replay_keeps_recorded_value(P):
    net = Net(P, parking_grace_s=0.0)
    try:
        P.gates["hold"] = threading.Event()
        h = net.a.start_flow(P.f.BuildThenWait(B_NAME))
        end = time.monotonic() + 10
        with net.a._lock:
            while h.flow_id not in net.a._park_key_of:
                assert time.monotonic() < end, "flow never parked"
                net.a._lock.wait(timeout=0.01)
        P.gates["hold"].set()
        result = h.result.result(timeout=30)
        salts = P.gates["salts"]
        assert len(salts) >= 2, "flow never replayed"
        assert all(s == salts[0] for s in salts)
        assert result == salts[0].hex()
    finally:
        net.stop()


def test_sleeping_flows_park(P):
    net = Net(P, parking_grace_s=0.0, max_workers=2)
    try:
        handles = [net.a.start_flow(P.f.NapFlow(0.2)) for _ in range(8)]
        assert [h.result.result(timeout=30) for h in handles] == ["rested"] * 8
        assert net.a.flows_in_progress() == []
    finally:
        net.stop()


def test_mock_network_grace_and_park_count():
    """The port's engine keeps the reference's 50 ms parking grace; the
    port's mock network gives its nodes ``MOCK_PARKING_GRACE_S`` (1 s);
    ``parks`` counts the flows a manager has parked."""
    import inspect

    from corda_tpu_torch.testing import mocknet

    def default(smm_cls):
        return inspect.signature(smm_cls).parameters["parking_grace_s"].default

    assert default(port_flows.StateMachineManager) == 0.05
    assert default(ref_flows.StateMachineManager) == 0.05
    assert mocknet.MOCK_PARKING_GRACE_S == 1.0
    mock = mocknet.MockNetworkNodes(pump=False, device="cpu")
    try:
        node = mock.create_node("Graced")
        assert node.smm._parking_grace_s == mocknet.MOCK_PARKING_GRACE_S
        assert node.smm.parks == 0
    finally:
        mock.stop()
    P = PKGS["port"]
    net = Net(P, parking_grace_s=0.0, max_workers=2)
    try:
        handles = [net.a.start_flow(P.f.NapFlow(0.1)) for _ in range(4)]
        assert [h.result.result(timeout=30) for h in handles] == ["rested"] * 4
        assert net.a.parks >= 4 and net.b.parks == 0
    finally:
        net.stop()


def test_kill_flow(P):
    net = Net(P)
    try:
        P.gates["responder_hold"] = {
            "after": 0, "event": threading.Event(), "reached": threading.Event(),
        }
        h = net.a.start_flow(P.f.CounterFlow(B_NAME, 3))
        assert P.gates["responder_hold"]["reached"].wait(timeout=10)
        assert net.a.kill_flow(h.flow_id)
        with pytest.raises(P.flows.FlowException, match="flow was killed"):
            h.result.result(timeout=30)
        assert not net.a.checkpoints.all_flows()
        assert not net.a.kill_flow(h.flow_id)
    finally:
        net.stop()


def test_initiator_crash_and_restore(P):
    """Kill the initiating node mid-protocol; a fresh engine over the same
    checkpoint store and durable broker finishes the flow."""
    M, F = P.messaging, P.flows
    broker = M.DurableQueueBroker(visibility_s=0.5)
    ckpt_a = F.CheckpointStorage()
    P.gates["responder_hold"] = {
        "after": 4, "event": threading.Event(), "reached": threading.Event(),
    }
    try:
        client_a = M.BrokerMessagingClient(broker, A_NAME)
        client_b = M.BrokerMessagingClient(broker, B_NAME)
        smm_a = F.StateMachineManager(client_a, ckpt_a, P.parties[A_NAME],
                                      P.parties.get)
        smm_b = F.StateMachineManager(client_b, F.CheckpointStorage(),
                                      P.parties[B_NAME], P.parties.get)
        h = smm_a.start_flow(P.f.CounterFlow(B_NAME, 3))
        # the responder holds on round 3: the initiator's third send is out
        assert P.gates["responder_hold"]["reached"].wait(timeout=20)
        smm_a.stop()
        client_a.stop()
        assert [f[0] for f in ckpt_a.all_flows()] == [h.flow_id]
        # open, then send + receive twice, then the third send (which the
        # crash may have cut before its record)
        assert len(ckpt_a.load_oplog(h.flow_id)) in (5, 6)
        # the reply lands in A's durable queue while A is down
        P.gates["responder_hold"]["event"].set()
        client_a2 = M.BrokerMessagingClient(broker, A_NAME)
        smm_a2 = F.StateMachineManager(client_a2, ckpt_a, P.parties[A_NAME],
                                       P.parties.get)
        handles = smm_a2.restore()
        assert [x.flow_id for x in handles] == [h.flow_id]
        assert handles[0].result.result(timeout=30) == 6
        assert not ckpt_a.all_flows()
        smm_a2.stop()
        smm_b.stop()
    finally:
        P.gates.pop("responder_hold", None)
        broker.close()


def test_oplog_records(P):
    """A parked initiator's op log holds the same records in both
    packages: the session open, then each send and receive."""
    net = Net(P, parking_grace_s=0.0)
    try:
        P.gates["responder_hold"] = {
            "after": 1, "event": threading.Event(), "reached": threading.Event(),
        }
        h = net.a.start_flow(P.f.CounterFlow(B_NAME, 2))
        assert P.gates["responder_hold"]["reached"].wait(timeout=10)
        oplog = net.a.checkpoints.load_oplog(h.flow_id)
        assert set(oplog[0]) == {"sid", "peer_sid"}
        assert oplog[1] == {"i": 1, "seq": 1}
        assert set(oplog[2]) == {"payload", "msg_id", "seq"}
        assert P.serialization.deserialize(oplog[2]["payload"]) == 2
        P.gates["responder_hold"]["event"].set()
        assert h.result.result(timeout=30) == 4
    finally:
        net.stop()


# ---------------------------------------------------------- wire bytes


def _messages(P):
    S, pr = P.sessions, P.flows.FetchRequest
    return [
        S.SessionInit(7, "pkg.mod:Flow", b"", "", 0.0),
        S.SessionInit(2**63 - 1, "a:B", b"first", "ab:cd", 1.7e9),
        S.SessionConfirm(7, 11),
        S.SessionReject(7, "no responder registered for x"),
        S.SessionData(11, b"\x00\x01payload", 0),
        S.SessionData(11, b"", 3),
        S.SessionEnd(11, "", 0),
        S.SessionEnd(11, "FlowException: deal rejected", 4),
        S.SessionAck("flow:op3"),
        pr("end"),
        pr("tx", tuple(P.crypto.SecureHash(bytes([i]) * 32) for i in range(3))),
        pr("attachment", (P.crypto.SecureHash(b"\x09" * 32),)),
    ]


def test_session_messages_byte_equal():
    ref = [ref_serialization.serialize(m) for m in _messages(PKGS["ref"])]
    port = [port_serialization.serialize(m) for m in _messages(PKGS["port"])]
    assert ref == port
    # and each package decodes the other's bytes to a message of the same
    # class that encodes back to them
    for raw, m in zip(ref, _messages(PKGS["port"])):
        got = port_serialization.deserialize(raw)
        assert type(got) is type(m)
        assert port_serialization.serialize(got) == raw


def test_topic_is_the_reference_topic():
    assert port_sessions.SESSION_TOPIC == ref_sessions.SESSION_TOPIC
