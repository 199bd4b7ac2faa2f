"""Overload protection and fault injection: the port's ``OverloadGovernor``
and ``faultinject`` plans against the reference's, under one seed.

- The governor's AIMD admission (per-class shares, the limit cut on a
  breaching p99 window and raised on a healthy one, on an injected clock),
  its retry token buckets and deadline scopes: the same call sequence gives
  the same verdicts and the same snapshot in both packages.
- ``FaultInjector`` decisions are a pure function of the seed: delivery
  verdicts, broker loss and redelivery, op-site failures, stalls and
  crashes, and the trace digest, equal across the packages; an installed
  plan forces the admission reject at ``overload.admission``.
- Through the engine: a governor at its limit rejects ``start_flow`` with
  ``FlowAdmissionError``, an expired deadline sheds the flow, and a flow
  still completes over an in-memory network that drops and duplicates
  messages (the session retransmits)."""

import dataclasses
import threading

import pytest
import torch

import corda_tpu.crypto as ref_crypto
import corda_tpu.faultinject as ref_fi
import corda_tpu.flows as ref_flows
import corda_tpu.flows.overload as ref_overload
import corda_tpu.ledger as ref_ledger
import corda_tpu.messaging as ref_messaging
import corda_tpu_torch.crypto as port_crypto
import corda_tpu_torch.faultinject as port_fi
import corda_tpu_torch.flows as port_flows
import corda_tpu_torch.flows.overload as port_overload
import corda_tpu_torch.ledger as port_ledger
import corda_tpu_torch.messaging as port_messaging


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class Pkg:
    def __init__(self, fi, overload, flows, messaging, crypto, ledger):
        self.fi, self.overload, self.flows = fi, overload, flows
        self.messaging, self.crypto, self.ledger = messaging, crypto, ledger


PKGS = {
    "ref": Pkg(ref_fi, ref_overload, ref_flows, ref_messaging, ref_crypto, ref_ledger),
    "port": Pkg(port_fi, port_overload, port_flows, port_messaging, port_crypto,
                port_ledger),
}


@pytest.fixture(autouse=True)
def clean_globals():
    """The installed plan and the process governor are process-global in
    each package: every test starts and ends with both off."""
    for P in PKGS.values():
        P.fi.clear()
        P.overload.configure_overload(enabled=False, reset=True)
    yield
    for P in PKGS.values():
        P.fi.clear()
        P.overload.configure_overload(enabled=False, reset=True, limit=64.0)


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


# ------------------------------------------------------------- governor


def _admission_run(P):
    clock = Clock()
    g = P.overload.OverloadGovernor(clock=clock)
    g.enable()
    g.limit, g.min_limit, g.adapt_min_samples = 10.0, 2.0, 4
    verdicts = []
    for cls in ["bulk"] * 8 + ["service"] * 3 + ["interactive"] * 3:
        verdicts.append((cls, g.try_admit(cls)))
    # four slow completions: the p99 breaches the SLO, the limit is cut
    for _ in range(4):
        g.release("service", 2.5)
    clock.t += 1.0
    g.release("bulk", 2.5)
    cut = g.limit
    # healthy windows raise it again
    for step in range(6):
        clock.t += 10.0
        for _ in range(5):
            g.release("interactive", 0.01)
        clock.t += 0.3  # past the adapt interval: this release adapts
        g.release("interactive", 0.01)
        verdicts.append(("bulk", g.try_admit("bulk")))
    g.note_deadline_shed("service", 0.3)
    snap = g.snapshot()
    return verdicts, cut, snap


def test_admission_alike():
    ref, port = _admission_run(PKGS["ref"]), _admission_run(PKGS["port"])
    assert ref == port
    verdicts, cut, snap = port
    # bulk fills 60% of the limit, service 85%, interactive all of it
    assert [v for c, v in verdicts[:8]] == [True] * 6 + [False] * 2
    assert [v for c, v in verdicts[8:14]] == [True] * 4 + [False] * 2
    assert all(v for c, v in verdicts[14:])
    assert cut == 7.0 and snap["limit"] == 13.0
    assert snap["rejected_by_class"] == {"bulk": 2, "interactive": 2}
    assert snap["deadline_shed"] == 1


def _retry_run(P):
    g = P.overload.OverloadGovernor(clock=Clock())
    g.enable()
    out = [g.allow_retry("session", "peer-a") for _ in range(3)]
    for _ in range(5):
        g.note_send("session", "peer-a")
    out += [g.allow_retry("session", "peer-a") for _ in range(4)]
    out.append(g.allow_retry("session", "peer-b"))
    out.append(g.edge_suspected("a", "peer-a"))
    return out, g.budget_earned(), g.snapshot()


def test_retry_budgets_alike():
    ref, port = _retry_run(PKGS["ref"]), _retry_run(PKGS["port"])
    assert ref == port
    out, earned, snap = port
    assert out[:3] == [True, True, False]
    assert snap["retry_granted"] <= earned


def test_deadline_scope_alike():
    for P in PKGS.values():
        O = P.overload
        assert O.remaining_deadline() is None
        with O.deadline_scope(1e12):
            assert O.current_deadline_t() == 1e12
            with O.deadline_scope(None):
                assert O.remaining_deadline() is None
            assert O.remaining_deadline() > 0
        assert O.current_deadline_t() is None
        assert O.overload_section() == {"enabled": False}


# ---------------------------------------------------------- fault plans


def _plan(P):
    fi = P.fi
    return fi.FaultPlan(
        seed=20261018, drop_p=0.15, delay_p=0.1, delay_rounds=(1, 3),
        duplicate_p=0.1, reorder_p=0.1,
        broker_publish_drop_p=0.2, broker_redeliver_p=0.3, op_fail_p=0.1,
        fail_sites=(("verifier.dispatch", 3),),
        stall_sites=(("serving.batch", 2, 0.25),),
        crash_sites=(("wal.fsync", 4),),
        partitions=(fi.Partition(5, 9, frozenset({"A"})),),
    )


def _injector_run(P):
    inj = P.fi.FaultInjector(_plan(P))
    out = []
    for rnd in range(12):
        for k in range(6):
            sender, recipient = ("A", "B") if k % 2 else ("B", "C")
            v = inj.on_deliver(sender, recipient, f"m{rnd}.{k}", rnd)
            out.append(dataclasses.astuple(v))
    out += [inj.on_broker_publish("p2p.B", f"pub{i}") for i in range(20)]
    out += [inj.on_broker_deliver("p2p.B", f"pub{i % 7}") for i in range(20)]
    for site in ["verifier.dispatch", "serving.batch"]:
        for _ in range(6):
            try:
                out.append(("delay", inj.check_site(site)))
            except P.fi.InjectedFault as e:
                out.append(("fault", str(e)))
    out += [inj.fail_op("fabric.control") for _ in range(10)]
    for _ in range(5):
        try:
            inj.crash_point("wal.fsync")
            out.append("alive")
        except P.fi.InjectedCrash as e:
            out.append(str(e))
    trace = [(e.kind, e.site, e.key, e.round) for e in inj.trace]
    return out, trace, inj.trace_digest()


def test_fault_plan_decisions_alike():
    ref, port = _injector_run(PKGS["ref"]), _injector_run(PKGS["port"])
    assert ref == port
    _out, trace, _digest = port
    kinds = {k for k, *_ in trace}
    assert {"drop", "delay", "partition", "op-fail", "op-stall", "op-crash"} <= kinds


def test_installed_plan_forces_admission_reject():
    out = {}
    for pkg, P in PKGS.items():
        P.fi.install(P.fi.FaultInjector(P.fi.FaultPlan(
            seed=1, fail_sites=(("overload.admission", 2),))))
        g = P.overload.OverloadGovernor()
        g.enable()
        out[pkg] = [g.try_admit("interactive") for _ in range(3)]
        assert P.fi.check_site("anything") == 0.0
        P.fi.clear()
        assert P.fi.active() is None
    assert out["ref"] == out["port"] == [True, False, True]


# ------------------------------------------------------- through the engine


def _parties(P):
    out = {}
    for name, seed in (("NodeA", b"\x0a"), ("NodeB", b"\x0b")):
        kp = P.crypto.derive_keypair_from_entropy(4, seed * 32)
        p = P.ledger.Party(P.ledger.CordaX500Name(name, "City", "GB"), kp.public)
        out[str(p.name)] = p
    return out


def _define(tag, P):
    FlowLogic, FlowException = P.flows.FlowLogic, P.flows.FlowException
    P.parties = _parties(P)
    P.hold = threading.Event()

    @dataclasses.dataclass
    class Ping(FlowLogic):
        peer: str
        rounds: int

        def call(self):
            s = self.initiate_flow(P.parties[self.peer])
            total = 0
            for _ in range(self.rounds):
                total = s.send_and_receive(int, total + 1).unwrap(lambda x: x)
            return total

    class Pong(FlowLogic):
        def __init__(self, session):
            self.session = session

        def call(self):
            while True:
                try:
                    v = self.session.receive(int).unwrap(lambda x: x)
                except FlowException:
                    return
                self.session.send(v + 1)

    @dataclasses.dataclass
    class Hold(FlowLogic):
        def call(self):
            P.hold.wait(timeout=30)
            return "held"

    for cls in (Ping, Pong, Hold):
        cls.__name__ = cls.__qualname__ = tag + cls.__name__
        globals()[cls.__name__] = cls
    P.flows.InitiatedBy(Ping)(Pong)
    return Ping, Hold


for _tag, _P in PKGS.items():
    _P.Ping, _P.Hold = _define(_tag.capitalize(), _P)


def _engines(P, net, **kw):
    return [P.flows.StateMachineManager(net.create_node(name), P.flows.CheckpointStorage(),
                                        party, P.parties.get, **kw)
            for name, party in P.parties.items()]


def _admission_through_engine(P):
    P.overload.configure_overload(enabled=True, reset=True, limit=2.0)
    net = P.messaging.InMemoryMessagingNetwork()
    a, b = _engines(P, net)
    P.hold.clear()
    try:
        held = [a.start_flow(P.Hold()) for _ in range(2)]
        with pytest.raises(P.overload.FlowAdmissionError, match="node over concurrency limit"):
            a.start_flow(P.Hold())
        # a rejection writes no checkpoint
        assert len(a.checkpoints.all_flows()) == 2
        P.hold.set()
        results = [h.result.result(timeout=30) for h in held]
        shed = a.start_flow(P.Hold(), deadline_s=-1.0)
        with pytest.raises(P.flows.FlowException, match="flow deadline exceeded"):
            shed.result.result(timeout=30)
        snap = P.overload.overload_section()
        return results, snap["admitted"], snap["rejected"], snap["deadline_shed"]
    finally:
        P.hold.set()
        a.stop()
        b.stop()


def test_admission_through_the_engine_alike():
    ref = _admission_through_engine(PKGS["ref"])
    port = _admission_through_engine(PKGS["port"])
    assert ref == port == (["held", "held"], 3, 1, 1)


def test_flow_survives_a_lossy_network():
    out = {}
    for pkg, P in PKGS.items():
        plan = P.fi.FaultPlan(seed=5, drop_p=0.2, duplicate_p=0.2)
        net = P.messaging.InMemoryMessagingNetwork(P.fi.FaultInjector(plan))
        net.start_pumping()
        policy = P.messaging.RetryPolicy(base_s=0.02, max_backoff_s=0.1, deadline_s=20.0)
        a, b = _engines(P, net, retry_policy=policy)
        try:
            out[pkg] = a.start_flow(P.Ping(str(P.parties and list(P.parties)[1]), 5)
                                    ).result.result(timeout=60)
            assert net.dropped, "the plan dropped nothing"
        finally:
            a.stop()
            b.stop()
            net.stop_pumping()
    assert out["ref"] == out["port"] == 10
