"""The port's node configuration, CorDapp loader and node scheduler against
the reference's (``corda_tpu/node/config.py``, ``cordapp.py``,
``scheduler.py``; the reference's ``tests/test_node_services.py::TestConfig``
and ``TestScheduler`` and ``tests/test_cordapp_loader.py``), each case run
in both packages with exact equality:

- ``load_config`` and ``parse_hocon`` on the same HOCON and JSON texts give
  equal configurations (every field, enums by value), and the same errors;
- ``hash_rpc_password`` entries check the same way in both;
- ``CordappLoader`` scans the same app directory (the app written once a
  package, under its own module name) into equal manifests;
- ``NodeSchedulerService`` fires the same activities under an injected
  clock, from direct scheduling and from vault updates, and the mock
  network's nodes carry it wired to their vaults."""

import dataclasses
import enum
import importlib
import json
import textwrap

import pytest
import torch

from corda_tpu.crypto import sha256 as ref_sha256
from corda_tpu_torch.crypto import sha256 as port_sha256

PKGS = ("ref", "port")
ROOT = {"ref": "corda_tpu", "port": "corda_tpu_torch"}
SHA = {"ref": ref_sha256, "port": port_sha256}


def mod(pkg: str, name: str):
    return importlib.import_module(f"{ROOT[pkg]}.{name}")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def plain(obj):
    """A configuration as plain data: dataclasses as dicts, enums by value."""
    if dataclasses.is_dataclass(obj):
        return {f.name: plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (tuple, list)):
        return [plain(x) for x in obj]
    return obj


HOCON_TEXTS = {
    "reference_test": """
        // node config
        myLegalName = "O=Bank A, L=London, C=GB"
        p2pAddress = "localhost:10002"
        devMode = false
        verifierType = OutOfProcess
        notary {
            validating = true
            raft {
                nodeAddress = "localhost:20001"
                clusterAddresses = ["localhost:20002", "localhost:20003"]
            }
        }
        rpcUsers = [
            { username = admin, password = secret, permissions = ["ALL"] }
        ]
        """,
    "bft_and_everything": """
        # every key the reader knows
        myLegalName : "O=Notary Service, L=Zurich, C=CH"
        baseDirectory = "/var/node"
        p2pAddress = "notary.example:10010"
        rpcAddress = "localhost:10011"
        verifierType = DeviceBatched
        devMode = true
        networkMapAddress = "O=Map, L=London, C=GB"
        messageRedeliveryDelaySeconds = 12.5
        flowTimeoutSeconds = 90
        verificationBatchMax = 2048
        verificationWindowMs = 2.5
        databasePath = "/var/node/db.sqlite"
        cordappPackages = ["corda.finance", "corda.extra"]
        cordappDirectory = "plugins"
        meshFanOut = false
        notary {
            validating = false
            bftSMaRt { replicaId = 2, clusterAddresses = ["a:1", "b:2"], exposeRaces = true }
        }
        rpcUsers = [
            { username = "ops", password = "p w", permissions = ["StartFlow.x.Y", "InvokeRpc.ping"] },
            { username = viewer, password = v, permissions = [] }
        ]
        """,
    "defaults": 'myLegalName = "O=Bob, L=Rome, C=IT"',
    "braced_json_subset": """{
        "myLegalName": "O=Carol, L=Paris, C=FR",
        "notary": {"validating": true},
        "verifierType": "InMemory"
    }""",
}


@pytest.mark.parametrize("name", sorted(HOCON_TEXTS))
def test_load_config_equal(name, tmp_path):
    text = HOCON_TEXTS[name]
    path = tmp_path / "node.conf"
    path.write_text(text)
    out = {pkg: mod(pkg, "node.config").load_config(path) for pkg in PKGS}
    assert plain(out["port"]) == plain(out["ref"])
    assert out["port"].db_path == out["ref"].db_path
    parsed = {pkg: mod(pkg, "node.config").parse_hocon(text) for pkg in PKGS}
    assert parsed["port"] == parsed["ref"]


def test_load_config_json_file(tmp_path):
    d = {"myLegalName": "O=Dan, L=Oslo, C=NO", "notary": {"validating": True},
         "rpcUsers": [{"username": "u", "password": "p", "permissions": ["ALL"]}]}
    path = tmp_path / "node.json"
    path.write_text(json.dumps(d))
    out = {pkg: mod(pkg, "node.config").load_config(path) for pkg in PKGS}
    assert plain(out["port"]) == plain(out["ref"])


@pytest.mark.parametrize("bad", [
    "myLegalName = ",                                    # a config without a name
    'myLegalName = "O=A, L=L, C=GB"\nnotary { raft { nodeAddress = a }, bftSMaRt { replicaId = 1 } }',
    'myLegalName = "O=A, L=L, C=GB"\nrpcUsers = [{ username = u, password = "pbkdf2$oops" }]',
    'myLegalName = "O=A, L=L, C=GB"\nverifierType = Quantum',
    'myLegalName = "O=A, L=L, C=GB"\nnotary { validating = true',
])
def test_config_errors_equal(bad):
    errs = {}
    for pkg in PKGS:
        cfg = mod(pkg, "node.config")
        try:
            cfg.config_from_dict(cfg.parse_hocon(bad))
        except Exception as e:  # noqa: BLE001 - the error itself is compared
            errs[pkg] = (type(e).__name__, str(e))
        else:
            errs[pkg] = None
    assert errs["port"] == errs["ref"]


def test_defaults_and_exclusive_notary():
    for pkg in PKGS:
        cfg = mod(pkg, "node.config")
        c = cfg.NodeConfiguration(my_legal_name="O=X, L=Y, C=GB")
        assert c.verifier_type is cfg.VerifierType.DeviceBatched
        assert c.notary is None and c.db_path.endswith("node.db")
        with pytest.raises(ValueError):
            cfg.NotaryConfig(raft=cfg.RaftConfig("a:1"), bft=cfg.BFTConfig(0))
    ref, port = (mod(pkg, "node.config") for pkg in PKGS)
    assert [v.value for v in port.VerifierType] == [v.value for v in ref.VerifierType]
    assert plain(port.NodeConfiguration(my_legal_name="O=X, L=Y, C=GB")) == \
        plain(ref.NodeConfiguration(my_legal_name="O=X, L=Y, C=GB"))


def test_hashed_rpc_password_equal():
    salt = bytes(range(16))
    ref, port = (mod(pkg, "node.config") for pkg in PKGS)
    e_ref = ref.hash_rpc_password("s3cret", iterations=1000, _salt=salt)
    e_port = port.hash_rpc_password("s3cret", iterations=1000, _salt=salt)
    assert e_port == e_ref and e_port.startswith("pbkdf2$1000$")
    for stored in (e_port, "hunter2", "pbkdf2$bad", f"pbkdf2$1000${'00' * 16}$zz"):
        for candidate in ("s3cret", "S3cret", "", "hunter2", "hunter", "pbkdf2$bad", "pw"):
            assert port.RpcUser("x", stored).check_password(candidate) == \
                ref.RpcUser("x", stored).check_password(candidate), (stored, candidate)
    entry = port.hash_rpc_password("pw", iterations=1000)
    cfg = port.config_from_dict({"myLegalName": "O=Bank A, L=London, C=GB", "rpcUsers": [
        {"username": "admin", "passwordHash": entry, "permissions": ["ALL"]}]})
    assert cfg.rpc_users[0].check_password("pw") and not cfg.rpc_users[0].check_password(entry)


def test_non_localhost_rpc_and_loopback_forms(tmp_path):
    for pkg in PKGS:
        startup = mod(pkg, "node.startup")
        cfg = mod(pkg, "node.config").NodeConfiguration(
            my_legal_name="O=Bank A, L=London, C=GB", base_directory=str(tmp_path / pkg),
            rpc_address="0.0.0.0:10003")
        kw = {"device": "cpu"} if pkg == "port" else {}
        with pytest.raises(ValueError, match="secure fabric"):
            startup.build_node(cfg, ":memory:", **kw)
    ref, port = (mod(pkg, "node.startup") for pkg in PKGS)
    for addr in ("localhost:10003", "127.0.0.1:10003", "[::1]:10003", "::1", "localhost",
                 "10.0.0.5:10003", "0.0.0.0:10003", "[2001:db8::1]:80", "bank.example.com:10003"):
        assert port._is_loopback_address(addr) == ref._is_loopback_address(addr), addr


# ------------------------------------------------------------- the loader

APP_SOURCE = textwrap.dedent(
    """
    import dataclasses

    from ROOT.flows import FlowLogic, InitiatedBy
    from ROOT.ledger import register_contract
    from ROOT.serialization import cbe_serializable


    @register_contract("TAG.Widget")
    class WidgetContract:
        def verify(self, tx):
            pass


    @cbe_serializable(name="TAG.WidgetMsg")
    @dataclasses.dataclass(frozen=True)
    class WidgetMsg:
        text: str


    @dataclasses.dataclass
    class WidgetFlow(FlowLogic):
        def call(self):
            return "widget"


    @InitiatedBy(WidgetFlow)
    class WidgetResponder(FlowLogic):
        def __init__(self, session):
            self.session = session

        def call(self):
            return None
    """
)


def _app(pkg: str, tag: str) -> str:
    return APP_SOURCE.replace("ROOT", ROOT[pkg]).replace("TAG", tag)


def manifest(app, module: str) -> dict:
    """A loaded app's manifest with its module name taken out."""
    d = {f.name: getattr(app, f.name) for f in dataclasses.fields(app)}
    return json.loads(json.dumps(d, default=sorted).replace(module, "MODULE"))


def test_directory_scan_manifests_equal(tmp_path):
    out = {}
    for pkg in PKGS:
        appdir = tmp_path / pkg
        appdir.mkdir()
        (appdir / f"widget_app_{pkg}.py").write_text(_app(pkg, f"cfgapp_{pkg}"))
        (appdir / "_ignored.py").write_text("raise AssertionError")
        (appdir / f"broken_app_{pkg}.py").write_text("raise RuntimeError('boom')")
        loader = mod(pkg, "node.cordapp").CordappLoader()
        apps = loader.load_directory(appdir)
        assert [a.name for a in apps] == [f"widget_app_{pkg}"]
        app = apps[0]
        assert loader.cordapp_for_contract(f"cfgapp_{pkg}.Widget") is app
        assert loader.cordapp_for_contract("nope.Missing") is None
        out[pkg] = (manifest(app, f"widget_app_{pkg}"),
                    loader.contract_attachment_id(f"cfgapp_{pkg}.Widget") is not None)
    assert json.loads(json.dumps(out["port"]).replace("cfgapp_port", "cfgapp")) == \
        json.loads(json.dumps(out["ref"]).replace("cfgapp_ref", "cfgapp"))
    assert out["port"][1] is True


def test_load_package_manifest_equal():
    out = {}
    for pkg in PKGS:
        loader = mod(pkg, "node.cordapp").CordappLoader()
        app = loader.load_package(f"{ROOT[pkg]}.finance")
        out[pkg] = manifest(app, f"{ROOT[pkg]}.finance")
    ref = json.loads(json.dumps(out["ref"]).replace("corda_tpu.", "ROOT."))
    port = json.loads(json.dumps(out["port"]).replace("corda_tpu_torch.", "ROOT."))
    assert port == ref


# ----------------------------------------------------------- the scheduler

def _pump_trace(pkg: str) -> list:
    sched_mod = mod(pkg, "node.scheduler")
    StateRef = mod(pkg, "ledger").StateRef
    fired, now = [], [1000.0]
    sched = sched_mod.NodeSchedulerService(lambda path, args: fired.append((path, args)),
                                           clock=lambda: now[0])
    r1 = StateRef(SHA[pkg](b"t1"), 0)
    r2 = StateRef(SHA[pkg](b"t2"), 0)
    r3 = StateRef(SHA[pkg](b"t3"), 1)
    sched.schedule_state_activity(r1, sched_mod.ScheduledActivity(1001.0, "flows.A", ("x",)))
    sched.schedule_state_activity(r2, sched_mod.ScheduledActivity(2000.0, "flows.B"))
    sched.schedule_state_activity(r3, sched_mod.ScheduledActivity(1200.0, "flows.C", (1, 2)))
    trace = [sched.pump()]
    for t in (1500.0, 1500.0, 1999.0):
        now[0] = t
        trace.append(sched.pump())
    sched.unschedule_state_activity(r2)
    now[0] = 3000.0
    trace.append(sched.pump())
    return trace + fired


def test_scheduler_fires_the_same_activities():
    assert _pump_trace("port") == _pump_trace("ref")
    assert _pump_trace("port")[:5] == [0, 2, 0, 0, 0]


@dataclasses.dataclass(frozen=True)
class RefTimerState:
    at: float

    def next_scheduled_activity(self, ref):
        from corda_tpu.node.scheduler import ScheduledActivity

        return ScheduledActivity(self.at, "flows.Timer", (str(ref),))

    @property
    def participants(self):
        return []


@dataclasses.dataclass(frozen=True)
class PortTimerState(RefTimerState):
    def next_scheduled_activity(self, ref):
        from corda_tpu_torch.node.scheduler import ScheduledActivity

        return ScheduledActivity(self.at, "flows.Timer", (str(ref),))


def _vault_trace(pkg: str) -> list:
    sched_mod = mod(pkg, "node.scheduler")
    ledger = mod(pkg, "ledger")
    VaultUpdate = mod(pkg, "node.vault").VaultUpdate
    notary = ledger.Party(ledger.CordaX500Name("Notary", "Zurich", "CH"),
                          mod(pkg, "crypto").generate_keypair().public)
    fired, now = [], [100.0]
    sched = sched_mod.NodeSchedulerService(lambda path, args: fired.append((path, args)),
                                           clock=lambda: now[0])

    class FakeVault:
        def track(self, cb):
            self.cb = cb

    vault = FakeVault()
    sched.observe_vault(vault)
    timer = RefTimerState if pkg == "ref" else PortTimerState
    refs = [ledger.StateRef(SHA[pkg](b"timer%d" % i), i) for i in range(3)]
    states = [ledger.StateAndRef(ledger.TransactionState(timer(150.0 + 100 * i),
                                                         "test.ns.Coin", notary), r)
              for i, r in enumerate(refs)]
    vault.cb(VaultUpdate((), tuple(states)))
    trace = []
    for t in (120.0, 200.0, 260.0):
        now[0] = t
        trace.append(sched.pump())
    vault.cb(VaultUpdate((states[2],), ()))     # consumed: unscheduled
    now[0] = 500.0
    trace.append(sched.pump())
    return trace + fired


def test_scheduler_vault_observation_equal():
    assert _vault_trace("port") == _vault_trace("ref")
    assert _vault_trace("port")[:4] == [0, 1, 1, 0]


def test_mocknet_nodes_carry_the_scheduler():
    from corda_tpu_torch.node.scheduler import NodeSchedulerService
    from corda_tpu_torch.testing.mocknet import MockNetworkNodes

    now = [10.0]
    with MockNetworkNodes(device="cpu") as net:
        node = net.create_node("Sched", clock=lambda: now[0])
        assert isinstance(node.scheduler, NodeSchedulerService)
        assert node.services.scheduler_service is node.scheduler
        fired = []
        node.scheduler._start_flow = lambda path, args: fired.append(path)
        assert node.scheduler.pump() == 0 and fired == []
