"""The node's services: the port's transaction and attachment storage,
vault, identity and key management, network map and metrics against the
reference's, fed the same transactions and queried alike.

The transactions are a seeded notarised Cash chain built by the port on
``device="cpu"`` (``testing.back_chain``) and a second issue,
carried to the reference as CBE bytes; every query result is compared as
(tx id, output index, CBE bytes of the state) in each package's own
encoding, which must be byte-equal (tolerance zero). The reference's
storage carried back through ``interop.transaction_storage_from_reference``
holds the same bytes and ids."""

import hashlib

import pytest
import torch

import corda_tpu.finance  # noqa: F401  (registers the reference's Cash contract)
import corda_tpu.crypto as ref_crypto
import corda_tpu.ledger as ref_ledger
import corda_tpu.node as ref_node
import corda_tpu.node.monitoring as ref_monitoring
import corda_tpu.node.storage as ref_storage
import corda_tpu.serialization as ref_serialization
import corda_tpu_torch.finance  # noqa: F401  (registers the port's Cash contract)
import corda_tpu_torch.crypto as port_crypto
import corda_tpu_torch.ledger as port_ledger
import corda_tpu_torch.node as port_node
import corda_tpu_torch.node.monitoring as port_monitoring
import corda_tpu_torch.node.storage as port_storage
import corda_tpu_torch.serialization as port_serialization
from corda_tpu_torch import interop
from corda_tpu_torch.testing import back_chain


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class Pkg:
    def __init__(self, crypto, ledger, node, storage, serialization, monitoring):
        self.crypto, self.ledger, self.node = crypto, ledger, node
        self.storage, self.ser, self.monitoring = storage, serialization, monitoring


PKGS = {
    "ref": Pkg(ref_crypto, ref_ledger, ref_node, ref_storage, ref_serialization,
               ref_monitoring),
    "port": Pkg(port_crypto, port_ledger, port_node, port_storage,
                port_serialization, port_monitoring),
}


def entropy(tag: bytes) -> bytes:
    return hashlib.sha256(tag).digest()


@pytest.fixture(scope="module")
def txs():
    """A 12-hop notarised chain, then a second issue to the same owner: the
    port's objects, and their CBE bytes."""
    chain, _notary = back_chain(12, seed=5, device="cpu", notarised=True)
    other, _ = back_chain(0, seed=6, device="cpu")
    stxs = chain + other
    return stxs, [port_serialization.serialize(s) for s in stxs]


def in_pkg(P, raws):
    return [P.ser.deserialize(r) for r in raws]


def refs(P, page):
    return [(s.ref.txhash.bytes, s.ref.index, P.ser.serialize(s.state)) for s in page]


# ----------------------------------------------------------- storage


def _storage_view(P, raws):
    st = P.node.DBTransactionStorage()
    stxs = in_pkg(P, raws)
    fresh = [st.add_transaction(s) for s in stxs]
    again = st.add_transaction(stxs[0])
    seen = []
    snapshot = st.track(lambda s: seen.append(s.id.bytes))
    extra = stxs[0].plus([])  # same id: not fresh, no update
    st.add_transaction(extra)
    view = (
        fresh, again, st.count(),
        [P.ser.serialize(st.get(s.id)) for s in stxs],
        [s.id in st for s in stxs],
        P.crypto.SecureHash(b"\x01" * 32) in st,
        st.get(P.crypto.SecureHash(b"\x01" * 32)),
        sorted(P.ser.serialize(s) for s in snapshot), seen,
    )
    st.close()
    return view


def test_transaction_storage_alike(txs):
    _stxs, raws = txs
    ref, port = _storage_view(PKGS["ref"], raws), _storage_view(PKGS["port"], raws)
    assert ref == port
    assert port[0] == [True] * len(raws) and port[1] is False
    assert port[3] == raws


@pytest.mark.parametrize("source", ["storage", "objects"])
def test_transaction_storage_from_reference(txs, source):
    stxs, raws = txs
    ref_stxs = in_pkg(PKGS["ref"], raws)
    if source == "storage":
        ref_st = ref_node.DBTransactionStorage()
        for s in ref_stxs:
            ref_st.add_transaction(s)
        carried = interop.transaction_storage_from_reference(ref_st)
    else:
        carried = interop.transaction_storage_from_reference(
            ref_stxs, encode=ref_serialization.serialize)
    assert carried.count() == len(stxs)
    for ref_s, s in zip(ref_stxs, stxs):
        assert ref_s.id.bytes == s.id.bytes
        got = carried.get(s.id)
        assert port_serialization.serialize(got) == ref_serialization.serialize(ref_s)
        assert got.id.bytes == ref_s.id.bytes


def test_transaction_storage_from_reference_needs_an_encoder(txs):
    _stxs, raws = txs
    with pytest.raises(TypeError, match="encode"):
        interop.transaction_storage_from_reference(in_pkg(PKGS["ref"], raws))


def test_attachment_storage_alike():
    out = {}
    for pkg, P in PKGS.items():
        st = P.node.AttachmentStorage()
        blob = P.storage.make_test_attachment({"b.txt": b"two", "a.txt": b"one"})
        att = st.import_attachment(blob)
        with pytest.raises(P.node.AttachmentStorage.DuplicateAttachmentError):
            st.import_attachment(blob)
        opened = st.open_attachment(att)
        out[pkg] = (blob, att.bytes, st.import_or_get(blob).bytes, st.has_attachment(att),
                    opened.extract_file("a.txt"), opened.size,
                    st.open_attachment(P.crypto.SecureHash(b"\x02" * 32)))
        st.close()
    assert out["ref"] == out["port"]


# ------------------------------------------------------------- vault


def _vault_view(P, raws):
    owner = P.crypto.derive_keypair_from_entropy(4, entropy(b"Chain Owner"))
    v = P.node.NodeVaultService(my_keys=[owner.public])
    updates = []
    v.track(lambda u: updates.append(
        ([(s.ref.txhash.bytes, s.ref.index) for s in u.consumed],
         [(s.ref.txhash.bytes, s.ref.index) for s in u.produced])))
    stxs = in_pkg(P, raws)
    for s in stxs:
        v.record_transaction(s)
    v.record_transaction(stxs[3])  # idempotent re-record
    N, Q = P.node, P.node.QueryCriteria
    cash = type(stxs[0].tx.outputs[0].data)
    views = {
        "unconsumed": refs(P, v.unconsumed_states()),
        "cash": refs(P, v.unconsumed_states(cash)),
        "all": refs(P, v.query_by(Q(status=N.StateStatus.ALL)).states),
        "consumed": refs(P, v.query_by(Q(status=N.StateStatus.CONSUMED)).states),
        "by_name": refs(P, v.query_by(Q(contract_state_types=("CashState",),
                                         status=N.StateStatus.ALL)).states),
        "by_key": refs(P, v.query_by(Q(participant_keys=(owner.public,),
                                       status=N.StateStatus.ALL)).states),
        "page2": refs(P, v.query_by(Q(status=N.StateStatus.ALL),
                                    paging=N.PageSpecification(2, 5)).states),
        "total": v.query_by(Q(status=N.StateStatus.ALL),
                            paging=N.PageSpecification(1, 5)).total_states_available,
        "desc": refs(P, v.query_by(Q(status=N.StateStatus.ALL),
                                   sort=N.Sort("recorded", True)).states),
        "exists": [v.unconsumed_ref_exists(P.ledger.StateRef(s.id, 0)) for s in stxs],
        "updates": updates,
    }
    token = stxs[0].tx.outputs[0].data.amount.token
    picked = v.select_fungible(token, 600, "lock-1")
    views["picked"] = refs(P, picked)
    views["locked_out"] = refs(P, v.query_by(Q(include_soft_locked=False)).states)
    views["own_lock"] = refs(P, v.query_by(Q(include_soft_locked=False,
                                             soft_lock_id="lock-1")).states)

    def select(qty, lock_id):
        try:
            return refs(P, v.select_fungible(token, qty, lock_id))
        except P.node.SoftLockError as e:
            return str(e)

    views["rival"] = select(600, "lock-2")
    v.soft_lock_release("lock-1")
    views["released"] = refs(P, v.query_by(Q(include_soft_locked=False)).states)
    views["too_much"] = select(10**6, "lock-3")
    views["digest"] = v.pages_digest()
    v.close()
    return views


def test_vault_alike(txs):
    stxs, raws = txs
    ref, port = _vault_view(PKGS["ref"], raws), _vault_view(PKGS["port"], raws)
    assert ref == port
    # the chain's last state and the second issue live, the chain's others
    # spent; a selection of 600 takes one of the two and locks it, a rival
    # selection the other (still locked when the last selection runs)
    assert sorted(r[:2] for r in port["unconsumed"]) == sorted(
        [(stxs[12].id.bytes, 0), (stxs[13].id.bytes, 0)])
    assert len(port["consumed"]) == 12 and port["total"] == 14
    assert len(port["picked"]) == 1 and port["picked"][0] in port["unconsumed"]
    assert port["locked_out"] == [r for r in port["unconsumed"] if r not in port["picked"]]
    assert port["too_much"] == "insufficient funds: have 1000, need 1000000"


def test_vault_observer_records_everything(txs):
    _stxs, raws = txs
    out = {}
    for pkg, P in PKGS.items():
        v = P.node.NodeVaultService(observe_all=True)
        for s in in_pkg(P, raws):
            v.record_transaction(s)
        out[pkg] = refs(P, v.unconsumed_states())
        v.close()
    assert out["ref"] == out["port"] and len(out["port"]) == 2


# ---------------------------------------------------------- identity


def _identity_view(P, raws):
    stx = in_pkg(P, raws)[4]
    kp = P.crypto.derive_keypair_from_entropy(4, entropy(b"Chain Owner"))
    other = P.crypto.derive_keypair_from_entropy(4, entropy(b"Someone"))
    party = P.ledger.Party(P.ledger.CordaX500Name("Chain Owner", "London", "GB"), kp.public)
    ids = P.node.IdentityService()
    kms = P.node.KeyManagementService([kp], ids)
    ids.register_identity(P.ledger.PartyAndCertificate(party, ()))
    anon = P.ledger.AnonymousParty(other.public)
    ids.register_anonymous_identity(anon, party)
    sig = kms.sign(stx.id, kp.public)
    with pytest.raises(Exception) as err:
        kms.sign(stx.id, other.public)
    return (
        P.ser.serialize(sig), kms.sign_bytes(b"payload", kp.public),
        sorted(k.encoded for k in kms.keys),
        [k.encoded for k in kms.filter_my_keys([other.public, kp.public])],
        P.ser.serialize(ids.party_from_key(kp.public)),
        P.ser.serialize(ids.party_from_name(party.name)),
        ids.party_from_key(other.public),
        P.ser.serialize(ids.well_known_party_from_anonymous(anon)),
        P.ser.serialize(ids.require_well_known(party)),
        len(ids.all_identities()), type(err.value).__name__,
    )


def test_identity_and_keys_alike(txs):
    _stxs, raws = txs
    assert _identity_view(PKGS["ref"], raws) == _identity_view(PKGS["port"], raws)


# ------------------------------------------------------- network map


def _map_view(P):
    def party(name):
        kp = P.crypto.derive_keypair_from_entropy(4, entropy(name.encode()))
        return P.ledger.Party(P.ledger.CordaX500Name(name, "London", "GB"), kp.public)

    alice, notary, simple = party("Alice"), party("Notary"), party("Simple")
    nmap = P.node.NetworkMapCache()
    feed = []
    nmap.track(lambda kind, info: feed.append((kind, str(info.legal_identity.name))))
    infos = [
        P.node.NodeInfo(("mock:Alice",), (alice,)),
        P.node.NodeInfo(("mock:Notary",), (notary,), notary_mode="validating"),
        P.node.NodeInfo(("mock:Simple",), (simple,), 1, 2, "simple"),
    ]
    for info in infos:
        nmap.add_node(info)
    view = [
        [P.ser.serialize(i) for i in infos],
        sorted(str(i.legal_identity.name) for i in nmap.all_nodes()),
        P.ser.serialize(nmap.get_node_by_party(alice)),
        P.ser.serialize(nmap.get_node_by_legal_name(notary.name)),
        sorted(str(p.name) for p in nmap.notary_identities),
        nmap.is_notary(notary), nmap.is_notary(alice),
        nmap.is_validating_notary(notary), nmap.is_validating_notary(simple),
        str(nmap.get_notary(simple.name).name),
    ]
    nmap.remove_node(infos[2])
    view += [sorted(str(p.name) for p in nmap.notary_identities), feed]
    return view


def test_network_map_alike():
    assert _map_view(PKGS["ref"]) == _map_view(PKGS["port"])


# ----------------------------------------------------------- metrics


def _metrics_view(P):
    m = P.monitoring.MetricRegistry()
    m.counter("a.count").inc(3)
    m.counter("a.count").dec()
    m.meter("b.meter").mark(5)
    t = m.timer("c.timer")
    for s in (0.5, 0.1, 0.3):
        t.update(s)
    m.gauge("d.gauge", lambda: 7)
    snap = m.snapshot()
    return (
        snap["a.count"], snap["b.meter"]["count"], snap["c.timer"]["count"],
        m.timer("c.timer").quantiles(), snap["d.gauge"], m.gauge("nothing").value,
        sorted(m.section("a.")),
    )


def test_metric_registry_alike():
    assert _metrics_view(PKGS["ref"]) == _metrics_view(PKGS["port"])


def test_monitoring_snapshot_sections():
    """The port's snapshot holds the reference's sections less ``profiler``
    and ``resilience`` (which come with the serving layer), each as the
    reference builds it while off."""
    port = port_monitoring.monitoring_snapshot()
    ref = ref_monitoring.monitoring_snapshot()
    assert set(port) == set(ref) - {"profiler", "resilience"}
    for name in ("overload", "net", "flowprof", "contention", "cluster", "slo", "devices",
                 "timeline", "sampler", "causal"):
        assert port[name] == {"enabled": False}, name
    # the state store's section is off until the first table of the
    # process, which another test file of this worker may have built
    if port["statestore"]["enabled"]:
        assert set(port["statestore"]) == {"enabled", "tables", "metrics"}
    else:
        assert port["statestore"] == {"enabled": False}
    # the durability section is off until the first DurableStore of the
    # process, which another test file of this worker may have built
    if port["durability"]["enabled"]:
        assert set(port["durability"]) == {
            "enabled", "open_stores", "wal", "replay", "recovery"}
    else:
        assert port["durability"] == {"enabled": False}
