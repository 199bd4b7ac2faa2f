"""The port's node container (``node/node.py``, ``node/startup.py``) against
the reference's, on ``device="cpu"``:

- three ``Node``s each (Alice, Bob and a notary) built from one HOCON text
  through ``load_config`` on an in-memory network, with deterministic keys,
  run the same Cash flows (an issue, a payment, a payment past the
  balance) to the same outcomes: result types, every error's type and
  message, each vault's balance and state count, and the notary's service
  and uniqueness provider. Notary kinds: simple, validating, validating over the device
  state store (its gate on, the port's kernels' plain versions on the
  CPU), validating over the durable WAL (``CORDA_TPU_DURABILITY``) and the
  persistent SQLite provider;
- ``build_node`` over a temporary broker file in each package: a notary
  node that issues to itself and answers over RPC;
- the port's defaults: ``Node`` and ``build_node`` run on the card and raise
  without one, ``python -m corda_tpu_torch.node.startup`` too, and the
  secure fabric raises ``NotImplementedError`` naming its ROADMAP item.

Exact equality throughout."""

import hashlib
import importlib
import os
import subprocess
import sys

import pytest
import torch

PKGS = ("ref", "port")
ROOT = {"ref": "corda_tpu", "port": "corda_tpu_torch"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NAMES = {"alice": "O=Alice, L=London, C=GB", "bob": "O=Bob, L=Rome, C=IT",
         "notary": "O=Notary, L=Zurich, C=CH"}

TEMPLATE = """
myLegalName = "{name}"
baseDirectory = "{base}"
p2pAddress = "localhost:{port}"
verifierType = DeviceBatched
verificationWindowMs = 2
rpcUsers = [
    {{ username = admin, password = admin-pw, permissions = ["ALL"] }}
]
{notary}
"""


def mod(pkg: str, name: str):
    return importlib.import_module(f"{ROOT[pkg]}.{name}")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def finance_registered():
    import corda_tpu.finance  # noqa: F401
    import corda_tpu_torch.finance  # noqa: F401


def keypair(pkg: str, role: str):
    crypto = mod(pkg, "crypto")
    return crypto.derive_keypair_from_entropy(4, hashlib.sha256(b"node " + role.encode()).digest())


def configs(pkg: str, tmp_path, notary_block: str) -> dict:
    load_config = mod(pkg, "node.config").load_config
    out = {}
    for i, (role, name) in enumerate(NAMES.items()):
        path = tmp_path / pkg / f"{role}.conf"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(TEMPLATE.format(name=name, base=tmp_path / pkg / role, port=10002 + i,
                                        notary=notary_block if role == "notary" else ""))
        out[role] = load_config(path)
    return out


def ensemble(pkg: str, tmp_path, notary_block: str, persistent: bool = False) -> dict:
    net = mod(pkg, "messaging").InMemoryMessagingNetwork()
    net.start_pumping()
    cache = mod(pkg, "node.network_map").NetworkMapCache()
    CordaX500Name = mod(pkg, "ledger").CordaX500Name
    Node = mod(pkg, "node.node").Node
    kw = {"device": "cpu"} if pkg == "port" else {}
    nodes = {"_net": net}
    for role, cfg in configs(pkg, tmp_path, notary_block).items():
        endpoint = net.create_node(str(CordaX500Name.parse(cfg.my_legal_name)))
        nodes[role] = Node(cfg, endpoint, network_map=cache, keypair=keypair(pkg, role),
                           persistent=persistent, **kw).start()
    return nodes


def stop(nodes: dict) -> None:
    for role in ("alice", "bob", "notary"):
        if role in nodes:
            nodes[role].stop()
    nodes["_net"].stop_pumping()


def cash_story(pkg: str, nodes: dict) -> dict:
    fin = mod(pkg, "finance")
    alice, bob, notary = nodes["alice"], nodes["bob"], nodes["notary"]
    out = {"results": [], "errors": []}
    for flow in (fin.CashIssueFlow(1000, "GBP", b"\x01", notary.party),
                 fin.CashPaymentFlow(300, "GBP", bob.party),
                 fin.CashPaymentFlow(5000, "GBP", bob.party)):
        try:
            res = alice.run_flow(flow, timeout=300)
            out["results"].append(type(res).__name__)
        except Exception as e:  # noqa: BLE001 - the error itself is compared
            out["errors"].append((type(e).__name__, str(e)))
    for role in ("alice", "bob"):
        states = nodes[role].services.vault_service.unconsumed_states(fin.CashState)
        out[role] = (len(states), sum(sr.state.data.amount.quantity for sr in states))
    out["notary_kind"] = type(notary.services.notary_service).__name__
    out["uniqueness"] = type(notary._notary_uniqueness).__name__
    return out


NOTARY_KINDS = {
    "simple": ("notary { validating = false }", {}),
    "validating": ("notary { validating = true }", {}),
    "statestore": ("notary { validating = true }", {"statestore": True}),
    "durable": ("notary { validating = true }", {"durable": True}),
    "sqlite": ("notary { validating = true }", {"persistent": True}),
}
UNIQUENESS = {"simple": "PersistentUniquenessProvider",
              "validating": "PersistentUniquenessProvider",
              "statestore": "DeviceShardedUniquenessProvider",
              "durable": "DurableUniquenessProvider",
              "sqlite": "PersistentUniquenessProvider"}


@pytest.mark.parametrize("kind", sorted(NOTARY_KINDS))
def test_node_flows_equal(kind, tmp_path, monkeypatch):
    block, opts = NOTARY_KINDS[kind]
    out = {}
    for pkg in PKGS:
        if opts.get("durable"):
            monkeypatch.setenv("CORDA_TPU_DURABILITY", "1")
            monkeypatch.setenv("CORDA_TPU_WAL_DIR", str(tmp_path / f"wal-{pkg}"))
        ss = mod(pkg, "statestore")
        ss.configure_statestore(enabled=bool(opts.get("statestore")))
        nodes = ensemble(pkg, tmp_path / kind, block, persistent=bool(opts.get("persistent")))
        try:
            out[pkg] = cash_story(pkg, nodes)
        finally:
            stop(nodes)
            ss.configure_statestore(enabled=False)
    assert out["port"] == out["ref"]
    assert out["port"]["alice"] == (1, 700) and out["port"]["bob"] == (1, 300)
    assert len(out["port"]["errors"]) == 1
    assert out["port"]["uniqueness"] == UNIQUENESS[kind]
    assert out["port"]["notary_kind"] == ("SimpleNotaryService" if kind == "simple"
                                          else "ValidatingNotaryService")


def test_node_carries_its_device(tmp_path):
    nodes = ensemble("port", tmp_path, "notary { validating = true }")
    try:
        for role in ("alice", "notary"):
            node = nodes[role]
            assert node.device == torch.device("cpu")
            assert node.services.device == torch.device("cpu")
            assert node.services.transaction_verifier_service._device == torch.device("cpu")
            assert node.smm.services is node.services
    finally:
        stop(nodes)


def test_node_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    from corda_tpu_torch.messaging import InMemoryMessagingNetwork
    from corda_tpu_torch.node import Node, NodeConfiguration
    from corda_tpu_torch.node.startup import build_node

    cfg = NodeConfiguration(my_legal_name="O=Card, L=London, C=GB",
                            base_directory=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Node(cfg, InMemoryMessagingNetwork().create_node("O=Card, L=London, C=GB"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_node(cfg, str(tmp_path / "broker.db"))
    for kw in ({"fabric_listen": "127.0.0.1:0"}, {"fabric_address": "127.0.0.1:1"}):
        with pytest.raises(NotImplementedError, match="Queue 1 step 9"):
            build_node(cfg, ":memory:", device="cpu", **kw)


def _build_node_story(pkg: str, tmp_path) -> dict:
    startup = mod(pkg, "node.startup")
    fin = mod(pkg, "finance")
    cfg_text = TEMPLATE.format(name="O=Solo, L=Paris, C=FR", base=tmp_path / pkg / "solo",
                               port=10009, notary="notary { validating = true }")
    path = tmp_path / f"{pkg}.conf"
    path.write_text(cfg_text)
    cfg = mod(pkg, "node.config").load_config(path)
    kw = {"device": "cpu"} if pkg == "port" else {}
    broker = tmp_path / f"{pkg}-broker.db"
    node = startup.build_node(cfg, str(broker), is_network_map=True, **kw)
    try:
        res = node.run_flow(fin.CashIssueFlow(42, "GBP", b"\x07", node.party), timeout=120)
        rpc = mod(pkg, "rpc")
        endpoint = mod(pkg, "messaging").BrokerMessagingClient(
            mod(pkg, "messaging").DurableQueueBroker(str(broker)), "rpc-client")
        try:
            conn = rpc.CordaRPCClient(endpoint, str(node.party.name)).start("admin", "admin-pw")
            ping = conn.proxy.ping()
            page = conn.proxy.vault_query_by()
            conn.close()
        finally:
            endpoint.stop()
        states = node.services.vault_service.unconsumed_states(fin.CashState)
        return {"result": type(res).__name__, "ping": ping,
                "states": page.total_states_available,
                "balance": sum(sr.state.data.amount.quantity for sr in states),
                "notaries": [str(p.name) for p in node.services.network_map_cache.notary_identities]}
    finally:
        node.stop()


def test_build_node_over_a_broker_file(tmp_path):
    out = {pkg: _build_node_story(pkg, tmp_path) for pkg in PKGS}
    assert out["port"] == out["ref"]
    assert out["port"]["balance"] == 42 and out["port"]["ping"] == "pong"


def test_startup_main_runs_on_the_card(tmp_path):
    """``python -m corda_tpu_torch.node.startup`` takes no device flag: it
    runs its node on the card, so with no card it exits with the error."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    conf = tmp_path / "node.conf"
    conf.write_text(TEMPLATE.format(name="O=Proc, L=Oslo, C=NO", base=tmp_path / "proc",
                                    port=10020, notary=""))
    proc = subprocess.run(
        [sys.executable, "-m", "corda_tpu_torch.node.startup", "--config", str(conf),
         "--broker", str(tmp_path / "broker.db"), "--no-banner"],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")})
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    fabric = subprocess.run(
        [sys.executable, "-m", "corda_tpu_torch.node.startup", "--config", str(conf),
         "--broker", str(tmp_path / "broker.db"), "--no-banner", "--fabric", "127.0.0.1:1"],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")})
    assert fabric.returncode != 0
