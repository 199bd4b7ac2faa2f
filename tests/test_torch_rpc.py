"""The port's RPC surface (``rpc/``: ``CordaRPCOps``, ``RPCServer``,
``CordaRPCClient``, ``json_support``, ``string_calls``) and
``observability/federation.py`` against the reference's.

- The reference's ``tests/test_rpc.py`` cases run against both packages'
  rigs (Alice, Bob and a notary on a mock network, the port's on
  ``device="cpu"``, an RPC server on Alice with the reference test's users
  and permissions) with the same results and errors: auth, hashed users,
  permissions, flow start by class path, vault query, the vault feed, kill,
  a payment while the client blocks in ``flow_result``, the single-notary
  refusal, an unknown method, malformed requests. Error texts are compared
  with each package's root and each test flow's package prefix taken out.
- The reference's ``tests/test_json_support.py`` cases (wire forms, round
  trips, registered types, party resolution, the call parser) give equal
  values in both packages.
- ``StringToMethodCallParser`` on ``flight_dump``'s ``str | None`` path
  fails the same way in both packages (the reference's own
  ``test_devicemon.py::TestRPCSurface::test_string_call_reachable`` fails
  so: shared with the reference, kept as it is).
- ``federated_snapshot``: each node's section equals its own monitoring
  snapshot, and the rollups of the reference test's inputs are equal.

Exact equality throughout."""

import base64
import dataclasses
import importlib
import time

import pytest
import torch

import corda_tpu.flows as ref_flows
import corda_tpu_torch.flows as port_flows

PKGS = ("ref", "port")
ROOT = {"ref": "corda_tpu", "port": "corda_tpu_torch"}


def mod(pkg: str, name: str):
    return importlib.import_module(f"{ROOT[pkg]}.{name}")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@dataclasses.dataclass
class RefEchoFlow(ref_flows.FlowLogic):
    value: int

    def call(self):
        return self.value * 2


@dataclasses.dataclass
class PortEchoFlow(port_flows.FlowLogic):
    value: int

    def call(self):
        return self.value * 2


@dataclasses.dataclass
class RefSleepyFlow(ref_flows.FlowLogic):
    def call(self):
        self.sleep(60)
        return "done"


@dataclasses.dataclass
class PortSleepyFlow(port_flows.FlowLogic):
    def call(self):
        self.sleep(60)
        return "done"


FLOWS = {"ref": (RefEchoFlow, RefSleepyFlow), "port": (PortEchoFlow, PortSleepyFlow)}


def norm(text: str) -> str:
    """An error text with the package root and the test flows' prefixes out."""
    return (text.replace("corda_tpu_torch.", "ROOT.").replace("corda_tpu.", "ROOT.")
            .replace("PortEcho", "Echo").replace("RefEcho", "Echo")
            .replace("PortSleepy", "Sleepy").replace("RefSleepy", "Sleepy"))


class Rig:
    def __init__(self, pkg: str):
        import corda_tpu.finance  # noqa: F401
        import corda_tpu_torch.finance  # noqa: F401

        self.pkg = pkg
        fin = mod(pkg, "finance")
        api = mod(pkg, "flows.api")
        cfg = mod(pkg, "node.config")
        rpc = mod(pkg, "rpc")
        self.RPCException = mod(pkg, "rpc.client").RPCException
        self.fin = fin
        echo, sleepy = FLOWS[pkg]
        self.echo_path, self.sleepy_path = api.class_path(echo), api.class_path(sleepy)
        self.issue_path = api.class_path(fin.CashIssueFlow)
        self.pay_path = api.class_path(fin.CashPaymentFlow)
        perm = mod(pkg, "rpc.ops").start_flow_permission
        self.users = (
            cfg.RpcUser("admin", "admin-pw", ("ALL",)),
            cfg.RpcUser("issuer", "issuer-pw", (
                perm(fin.CashIssueFlow), "InvokeRpc.flow_result", "InvokeRpc.vault_query_by")),
            cfg.RpcUser("nobody", "nobody-pw", ()),
            cfg.RpcUser("hashed", cfg.hash_rpc_password("hash-pw", iterations=1000), ("ALL",)),
        )
        kw = {"device": "cpu"} if pkg == "port" else {}
        self.net = mod(pkg, "testing.mocknet").MockNetworkNodes(**kw)
        self.alice = self.net.create_node("Alice")
        self.bob = self.net.create_node("Bob")
        self.notary = self.net.create_notary_node("Notary")
        self.ops = rpc.CordaRPCOps(self.alice.services, self.alice.smm,
                                   registered_flow_names=[self.echo_path, self.issue_path,
                                                          self.pay_path])
        self.server = rpc.RPCServer(self.ops, self.alice.smm.messaging, rpc_users=self.users)
        self.endpoint = self.net.net.create_node("rpc-client-1")
        self.client = rpc.CordaRPCClient(self.endpoint, str(self.alice.party.name))

    def close(self):
        self.server.stop()
        self.net.__exit__(None, None, None)

    def error(self, fn) -> str:
        with pytest.raises(self.RPCException) as e:
            fn()
        return norm(str(e.value))


def ping_and_node_info(r: Rig):
    conn = r.client.start("admin", "admin-pw")
    info = conn.proxy.node_info()
    out = [conn.proxy.ping(), info.legal_identity == r.alice.party,
           conn.proxy.notary_identities() == [r.notary.party],
           sorted(norm(f) for f in conn.proxy.registered_flows())]
    conn.close()
    return out


def credentials(r: Rig):
    bad = r.client.start("admin", "wrong")
    out = [r.error(bad.proxy.ping)]
    conn = r.client.start("hashed", "hash-pw")
    out.append(conn.proxy.ping())
    conn.close()
    out.append(r.error(r.client.start("hashed", "wrong").proxy.ping))
    out.append(r.error(r.client.start("ghost", "admin-pw").proxy.ping))
    return out


def start_flow_and_permissions(r: Rig):
    conn = r.client.start("admin", "admin-pw")
    out = [conn.proxy.flow_result(conn.proxy.start_flow_dynamic(r.echo_path, 21), 30)]
    issuer = r.client.start("issuer", "issuer-pw")
    fid = issuer.proxy.start_flow_dynamic(r.issue_path, 500, "GBP", b"\x01", r.notary.party)
    out.append(type(issuer.proxy.flow_result(fid, 60)).__name__)
    out.append(r.error(lambda: issuer.proxy.start_flow_dynamic(
        r.pay_path, 100, "GBP", r.bob.party)))
    out.append(r.error(issuer.proxy.transaction_count))
    out.append(issuer.proxy.ping())
    nobody = r.client.start("nobody", "nobody-pw")
    out.append(r.error(lambda: nobody.proxy.start_flow_dynamic(r.echo_path, 1)))
    out.append(r.error(lambda: conn.proxy.start_flow_dynamic("no.such.module:Flow")))
    return out


def vault_query_and_feed(r: Rig):
    conn = r.client.start("admin", "admin-pw")
    obs = conn.proxy.vault_track()
    out = [obs.snapshot.total_states_available]
    fid = conn.proxy.start_flow_dynamic(r.issue_path, 777, "GBP", b"\x02", r.notary.party)
    conn.proxy.flow_result(fid, 60)
    QueryCriteria = mod(r.pkg, "node").QueryCriteria
    page = conn.proxy.vault_query_by(QueryCriteria(contract_state_types=("CashState",)))
    out += [page.total_states_available, page.states[0].state.data.amount.quantity]
    update = obs.poll(timeout=10)
    produced = update.produced if hasattr(update, "produced") else update
    out.append(produced[0].state.data.amount.quantity)
    obs.close()
    fid = conn.proxy.start_flow_dynamic(r.issue_path, 5, "GBP", b"\x04", r.notary.party)
    conn.proxy.flow_result(fid, 60)
    time.sleep(0.2)
    out.append(obs.poll(timeout=0.2))
    out.append(conn.proxy.vault_query_by().total_states_available)
    return out


def unknown_and_malformed(r: Rig):
    conn = r.client.start("admin", "admin-pw")
    out = [r.error(conn.proxy.definitely_not_a_method)]
    try:
        conn.proxy._private()
    except Exception as e:  # noqa: BLE001 - refused by the client's proxy
        out.append((type(e).__name__, str(e)))
    out.append(r.error(lambda: conn.proxy.ping(1, 2, 3)))
    # garbage on the request topic is dropped; the server goes on serving
    server_topic = mod(r.pkg, "rpc.server").RPC_REQUEST_TOPIC
    r.endpoint.send(str(r.alice.party.name), server_topic, b"\x00not cbe", msg_id="junk-1")
    ser = mod(r.pkg, "serialization")
    r.endpoint.send(str(r.alice.party.name), server_topic, ser.serialize((1, 2)), msg_id="junk-2")
    out.append(conn.proxy.ping())
    return out


def kill_flow(r: Rig):
    conn = r.client.start("admin", "admin-pw")
    fid = conn.proxy.start_flow_dynamic(r.sleepy_path)
    time.sleep(0.2)
    out = [conn.proxy.kill_flow(fid)]
    deadline = time.monotonic() + 10
    while fid in conn.proxy.state_machines_snapshot():
        assert time.monotonic() < deadline, "flow did not die"
        time.sleep(0.05)
    out.append(conn.proxy.kill_flow("no-such-flow"))
    return out


def payments(r: Rig):
    """A payment while the client blocks in flow_result, then the
    single-notary refusal (the reference's TestRPCConcurrency and
    TestMixedNotarySelection)."""
    conn = r.client.start("admin", "admin-pw")
    n2 = r.net.create_notary_node("Notary2", validating=True)
    for notary, amt, ref in ((r.notary.party, 300, b"\x05"), (n2.party, 100, b"\x06")):
        conn.proxy.flow_result(
            conn.proxy.start_flow_dynamic(r.issue_path, amt, "GBP", ref, notary), 60)
    # 150 fits only the first notary's bucket; then 200 fits neither
    conn.proxy.flow_result(conn.proxy.start_flow_dynamic(r.pay_path, 150, "GBP", r.bob.party),
                           120)
    bob_cash = r.bob.services.vault_service.unconsumed_states(r.fin.CashState)
    out = [sum(sr.state.data.amount.quantity for sr in bob_cash)]
    out.append(r.error(lambda: conn.proxy.flow_result(
        conn.proxy.start_flow_dynamic(r.pay_path, 200, "GBP", r.bob.party), 120)))
    return out


SCENARIOS = {f.__name__: f for f in (ping_and_node_info, credentials,
                                      start_flow_and_permissions, vault_query_and_feed,
                                      unknown_and_malformed, kill_flow, payments)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_rpc_scenario_equal(name):
    out = {}
    for pkg in PKGS:
        rig = Rig(pkg)
        try:
            out[pkg] = SCENARIOS[name](rig)
        finally:
            rig.close()
    assert out["port"] == out["ref"]


# ------------------------------------------------------------ json_support

def _party(pkg, org, seed):
    import hashlib

    crypto, ledger = mod(pkg, "crypto"), mod(pkg, "ledger")
    kp = crypto.derive_keypair_from_entropy(4, hashlib.sha256(seed).digest())
    return ledger.Party(ledger.CordaX500Name(org, "London", "GB"), kp.public), kp


def _json_values(pkg: str) -> list:
    crypto, ledger, rpc = mod(pkg, "crypto"), mod(pkg, "ledger"), mod(pkg, "rpc")
    m = rpc.JsonMapper()
    h = crypto.sha256(b"x")
    party, kp = _party(pkg, "Bank A", b"a")
    out = [m.to_json_value(h), m.to_json_value(ledger.StateRef(h, 3)),
           m.to_json_value(ledger.Amount(100, "GBP")), m.to_json_value(b"\x01\x02"),
           m.to_json_value(party), m.to_json_value(kp.public)]
    ref = ledger.StateRef(crypto.sha256(b"y"), 7)
    anon = ledger.AnonymousParty(kp.public)
    out += [m.parse(m.to_json_value(ref), ledger.StateRef) == ref,
            m.parse(m.to_json_value(ledger.Amount(250, "USD")), ledger.Amount)
            == ledger.Amount(250, "USD"),
            m.parse(m.to_json_value(kp.public), type(kp.public)) == kp.public,
            m.parse(m.to_json_value(anon), ledger.AnonymousParty) == anon,
            m.parse(m.to_json_value(b"hello"), bytes)]
    token = ledger.Issued(ledger.PartyAndReference(party, b"\x01"), "GBP")
    v = m.to_json_value(ledger.Amount(5, token))
    out.append(norm(str(v)))
    try:
        m.parse("O=Bank A, L=London, C=GB", ledger.Party)
    except rpc.JsonSerializationError as e:
        out.append(norm(str(e)))
    ca = crypto.derive_keypair_from_entropy(4, b"\x09" * 32)
    leaf = ledger.NameKeyCertificate.issue(party.name, kp.public, ca.public, ca.private)
    ids = mod(pkg, "node.identity").IdentityService(trust_root_key=ca.public)
    ids.register_identity(ledger.PartyAndCertificate(party, (leaf,)))
    im = rpc.IdentityJsonMapper(ids)
    out += [im.parse("O=Bank A, L=London, C=GB", ledger.Party) == party,
            im.party_from_key(kp.public) == party]
    return out


def test_json_mapper_equal():
    assert _json_values("port") == _json_values("ref")
    assert _json_values("port")[2:4] == ["100 GBP", base64.b64encode(b"\x01\x02").decode()]


@dataclasses.dataclass(frozen=True)
class _RefThing:
    tag: str
    n: int


@dataclasses.dataclass(frozen=True)
class _PortThing:
    tag: str
    n: int


def test_registered_type_round_trip_equal():
    out = {}
    for pkg, cls in (("ref", _RefThing), ("port", _PortThing)):
        ser = mod(pkg, "serialization")
        registered = ser.cbe_serializable(name=f"test.JsonThing{pkg}")(cls)
        m = mod(pkg, "rpc").JsonMapper()
        v = m.to_json_value(registered("hello", 3))
        out[pkg] = (v["tag"], v["n"], v["@type"].replace(pkg, ""),
                    m.parse(v, registered) == registered("hello", 3))
    assert out["port"] == out["ref"]


class Target:
    def greet(self, who: str, excited: bool = False) -> str:
        return f"hello {who}{'!' if excited else ''}"

    def total(self, values: list) -> int:
        return sum(values)

    def pay(self, amount, ref) -> str:
        return f"{amount.quantity} {amount.token} vs {ref.index}"


def _parser_values(pkg: str) -> list:
    rpc, crypto, ledger = mod(pkg, "rpc"), mod(pkg, "crypto"), mod(pkg, "ledger")

    class Typed(Target):
        def pay(self, amount: ledger.Amount, ref: ledger.StateRef) -> str:
            return super().pay(amount, ref)

    p = rpc.StringToMethodCallParser(Typed())
    h = crypto.sha256(b"w")
    out = [p.invoke("greet who: world"), p.invoke("greet who: world, excited: true"),
           p.invoke(f"pay amount: 100 GBP, ref: \"{h}(2)\""), p.invoke("total values: [1, 2, 3]"),
           sorted(p.available_commands())]
    for bad in ("greet", "greet who: x, nope: 1", "bogus x: 1", "total values: [1, 2"):
        try:
            p.parse(bad)
            out.append(None)
        except rpc.CallParseError as e:
            out.append(str(e))
    return out


def test_string_call_parser_equal():
    assert _parser_values("port") == _parser_values("ref")


def test_string_calls_against_live_ops_equal():
    out = {}
    for pkg in PKGS:
        rig = Rig(pkg)
        try:
            rpc = mod(pkg, "rpc")
            parser = rpc.StringToMethodCallParser(rig.ops, mod(pkg, "rpc.json_support")
                                                  .RpcJsonMapper(rig.ops))
            out[pkg] = ("network_map_snapshot" in parser.available_commands(),
                        parser.invoke("ping"), len(parser.invoke("network_map_snapshot")),
                        str(parser.invoke('well_known_party_from_x500_name '
                                          'name: "O=Bob, L=London, C=GB"').name))
        finally:
            rig.close()
    assert out["port"] == out["ref"] == (True, "pong", 3, "O=Bob, L=London, C=GB")


def test_flight_dump_string_call_shared_with_the_reference(tmp_path):
    """The reference's parser cannot convert a string to ``str | None``;
    the port keeps that behaviour, so both fail the same way."""
    out = {}
    for pkg in PKGS:
        ops = mod(pkg, "rpc.ops").CordaRPCOps(None, None)
        parser = mod(pkg, "rpc.string_calls").StringToMethodCallParser(ops)
        assert parser.invoke("devicemon_snapshot") == {"enabled": False}
        assert parser.invoke("slo_status") == {"enabled": False}
        try:
            parser.invoke(f"flight_dump path: \"{tmp_path / (pkg + '.jsonl')}\", reason: shell")
            out[pkg] = None
        except Exception as e:  # noqa: BLE001 - the error itself is compared
            out[pkg] = (type(e).__name__, str(e).replace(pkg + ".jsonl", "X.jsonl"))
    assert out["port"] == out["ref"]
    assert out["port"] is not None and "str | None" in out["port"][1]


# ------------------------------------------------------------ federation

def _quiesce(pkg: str, timeout_s: float = 30.0):
    snap = mod(pkg, "node.monitoring").monitoring_snapshot
    prev, deadline = None, time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        cur = snap()
        if cur == prev:
            return
        prev = cur
        time.sleep(0.05)
    raise AssertionError("monitoring snapshot never quiesced")


def test_federated_per_node_sections():
    from corda_tpu_torch.finance import CashIssueFlow
    from corda_tpu_torch.node.monitoring import monitoring_snapshot
    from corda_tpu_torch.observability.federation import federated_snapshot
    from corda_tpu_torch.testing.mocknet import MockNetworkNodes

    with MockNetworkNodes(device="cpu") as net:
        alice = net.create_node("FedAlice")
        notary = net.create_notary_node("FedNotary")
        alice.run_flow(CashIssueFlow(100, "GBP", b"\x02", notary.party))
        _quiesce("port")
        doc = federated_snapshot(net)
        assert doc["schema"] == 1 and doc["rollup"]["n_nodes"] == 2
        for name, node in net.nodes.items():
            expect = monitoring_snapshot()
            expect["node"] = node.services.metrics.snapshot()
            assert doc["nodes"][name]["snapshot"] == expect, name


def _rollups(pkg: str) -> list:
    fed = mod(pkg, "observability.federation")

    def mk(p99, samples, flows, breached=False):
        return lambda: {"slo": {"enabled": True, "objectives": [
            {"p99_s": p99, "samples": samples, "breached": breached}]},
            "flowprof": {"enabled": True, "flows": flows}}

    docs = [fed.federated_snapshot({"fast": mk(0.010, 100, 10), "slow": mk(0.100, 100, 30)}),
            fed.federated_snapshot({"sick": mk(9.0, 5, 1, True)}),
            fed.federated_snapshot({'evil"node\\with\nnewline': lambda: {"slo": {"enabled": False}}})]
    out = [d["rollup"] for d in docs] + [fed.render_federated_prometheus(d) for d in docs]
    single = fed.federated_snapshot()
    out.append((single["rollup"]["n_nodes"], sorted(single["nodes"])))
    return out


def test_federation_rollups_equal():
    assert _rollups("port") == _rollups("ref")
