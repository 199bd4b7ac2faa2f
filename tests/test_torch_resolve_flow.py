"""The resolve flow between two nodes: both packages' ``MockNetworkNodes``
resolving the same back-chains through ``ReceiveTransactionFlow`` ->
``ResolveTransactionsFlow`` against the sender's ``SendTransactionFlow``.

The transactions are built once by the port on ``device="cpu"`` (a seeded
32-hop notarised Cash chain, ``testing.back_chain``, and a 128-transaction
``GeneratedLedger`` DAG under a tip that spends every state it left, so the
tip's back-chain is the whole DAG), carried to the reference as CBE bytes,
recorded by the reference's sender and carried back to the port's sender
through ``interop.transaction_storage_from_reference``: both senders vend
the same bytes. The reference resolves on its host route (its default), the
port on ``device="cpu"`` (the plain versions of kernels A-D). Both must give
(tolerance zero):

- the same flow result and the same resolved id list;
- the same recording order on the receiver;
- the same vault (unconsumed and consumed state refs);
- the same failure kind and message for a sender that substitutes a
  transaction, a forged signature deep in the chain, a double spend inside
  the fetched DAG, a vend probe for a transaction outside the chain, and
  ``MAX_RESOLVE_TRANSACTIONS`` exceeded (the module constant monkeypatched
  in both packages).

``CollectSignaturesFlow`` / ``SignTransactionFlow`` run a two-party issue
with a fixed privacy salt in both packages: the signed transactions are
byte-equal. A closed scheduler at the receiver's top-level check sheds to
the host check in both packages: the flow completes and its
``flow.verify_stx`` span reads ``degraded=host-fallback``."""

import dataclasses
import hashlib
import random
import types

import pytest
import torch

import corda_tpu.finance  # noqa: F401  (registers the reference's Cash contract)
import corda_tpu.flows as ref_flows
import corda_tpu.flows.protocols as ref_protocols
import corda_tpu.ledger as ref_ledger
import corda_tpu.node as ref_node
import corda_tpu.testing.generated_ledger  # noqa: F401  (registers testing.GenContract)
from corda_tpu.crypto import SecureHash as RefSecureHash
from corda_tpu.crypto import derive_keypair_from_entropy as ref_derive
from corda_tpu.serialization import deserialize as ref_deserialize
from corda_tpu.serialization import register_custom as ref_register_custom
from corda_tpu.serialization import serialize as ref_serialize
from corda_tpu.testing.mocknet import MockNetworkNodes as RefMockNetworkNodes
import corda_tpu_torch.finance  # noqa: F401  (registers the port's Cash contract)
import corda_tpu_torch.flows as port_flows
import corda_tpu_torch.flows.protocols as port_protocols
import corda_tpu_torch.ledger as port_ledger
import corda_tpu_torch.node as port_node
import corda_tpu_torch.node.services as port_services
from corda_tpu_torch import interop
from corda_tpu_torch.crypto import SecureHash as PortSecureHash
from corda_tpu_torch.crypto import derive_keypair_from_entropy as port_derive
from corda_tpu_torch.crypto import sign_tx_id
from corda_tpu_torch.finance import CASH_PROGRAM_ID, CashState, Move
from corda_tpu_torch.ledger import (
    Amount,
    Issued,
    PartyAndReference,
    PrivacySalt,
    SignedTransaction,
    TransactionBuilder,
)
from corda_tpu_torch.serialization import register_custom as port_register_custom
from corda_tpu_torch.node.monitoring import node_metrics as port_node_metrics
from corda_tpu_torch.serialization import serialize
from corda_tpu_torch.serving import DeviceScheduler
from corda_tpu_torch.testing import GeneratedLedger, back_chain, dag_tip, sign_tx_ids
from corda_tpu_torch.testing import generated_ledger
from corda_tpu_torch.testing.mocknet import MockNetworkNodes as PortMockNetworkNodes


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run many small integer ops: beside the suite's
    other worker processes a torch thread pool only contends."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


PKGS = {
    "ref": types.SimpleNamespace(
        flows=ref_flows, protocols=ref_protocols, ledger=ref_ledger,
        node=ref_node, SecureHash=RefSecureHash, derive=ref_derive,
        register_custom=ref_register_custom,
        net=lambda: RefMockNetworkNodes(), peers={},
    ),
    "port": types.SimpleNamespace(
        flows=port_flows, protocols=port_protocols, ledger=port_ledger,
        node=port_node, SecureHash=PortSecureHash, derive=port_derive,
        register_custom=port_register_custom,
        net=lambda: PortMockNetworkNodes(device="cpu"), peers={},
    ),
}


# ------------------------------------------------------ a two-party contract


def _define_bond(P, tag):
    @dataclasses.dataclass(frozen=True)
    class Bond:
        face: int
        owner: object

        @property
        def participants(self):
            return [self.owner]

    @dataclasses.dataclass(frozen=True)
    class BondCommand:
        op: str = "issue"

    Bond.__qualname__ = Bond.__name__ = f"{tag}Bond"
    BondCommand.__qualname__ = BondCommand.__name__ = f"{tag}BondCommand"
    P.register_custom(
        Bond, "test.trf.Bond",
        to_fields=lambda s: {"face": s.face, "owner": s.owner},
        from_fields=lambda d: Bond(d["face"], d["owner"]),
    )
    P.register_custom(
        BondCommand, "test.trf.BondCommand",
        to_fields=lambda c: {"op": c.op},
        from_fields=lambda d: BondCommand(d["op"]),
    )

    class BondContract:
        def verify(self, tx):
            if not tx.commands_of_type(BondCommand):
                raise ValueError("no BondCommand")

    P.ledger.register_contract("test.trf.BondContract")(BondContract)
    return Bond, BondCommand


# ------------------------------------------------------------ the flows


def _define(tag, P):
    """This package's test flows, named ``<Tag><Flow>`` at module level (a
    parked flow is rebuilt from its class path)."""
    F = P.flows
    FlowLogic, FlowException = F.FlowLogic, F.FlowException
    Bond, BondCommand = _define_bond(P, tag)

    @dataclasses.dataclass
    class FetchTip(FlowLogic):
        """Ask the peer for one transaction and receive it with its
        back-chain, resolved, verified and recorded."""

        peer: str
        tip: bytes

        def call(self):
            s = self.initiate_flow(P.peers[self.peer])
            s.send(P.SecureHash(self.tip))
            stx = self.sub_flow(F.ReceiveTransactionFlow(s, record=True))
            return serialize_any(stx)

    @dataclasses.dataclass
    class ResolveTip(FlowLogic):
        """The resolve alone: its result is the list of fetched ids."""

        peer: str
        tip: bytes

        def call(self):
            s = self.initiate_flow(P.peers[self.peer])
            s.send(P.SecureHash(self.tip))
            stx = s.receive().unwrap(lambda x: x)
            ids = self.sub_flow(F.ResolveTransactionsFlow(stx, s))
            return [h.bytes for h in ids]

    @dataclasses.dataclass
    class ProbeTip(FlowLogic):
        """Receive the tip, then probe the vendor for another id."""

        peer: str
        tip: bytes
        probe: bytes

        def call(self):
            s = self.initiate_flow(P.peers[self.peer])
            s.send(P.SecureHash(self.tip))
            s.receive()
            s.send_and_receive(
                list, P.protocols.FetchRequest("tx", (P.SecureHash(self.probe),))
            )

    class VendTip(FlowLogic):
        def __init__(self, session):
            self.session = session

        def call(self):
            h = self.session.receive().unwrap(lambda x: x)
            stx = self.services.validated_transactions.get(h)
            self.sub_flow(F.SendTransactionFlow(self.session, stx))

    class VendForResolve(VendTip):
        pass

    class VendForProbe(VendTip):
        pass

    @dataclasses.dataclass
    class TwoPartyIssue(FlowLogic):
        other: str
        face: int
        notary: bytes

        def call(self):
            other = P.peers[self.other]
            notary = P.ledger.Party(
                P.ledger.CordaX500Name("Issue Notary", "London", "GB"),
                P.derive(4, self.notary).public,
            )
            b = P.ledger.TransactionBuilder(notary=notary)
            b.set_privacy_salt(P.ledger.PrivacySalt(b"\x05" * 32))
            b.add_output_state(Bond(self.face, other), "test.trf.BondContract")
            b.add_command(BondCommand("issue"), self.our_identity.owning_key,
                          other.owning_key)
            stx = self.services.sign_initial_transaction(b)
            session = self.initiate_flow(other)
            stx = self.sub_flow(F.CollectSignaturesFlow(stx, [session]))
            return serialize_any(stx)

    class TwoPartyResponder(F.SignTransactionFlow):
        def check_transaction(self, stx):
            if any(ts.data.face > 1000 for ts in stx.tx.outputs):
                raise FlowException("face value too large")

    out = {k: v for k, v in locals().items()
           if isinstance(v, type) and v.__qualname__.startswith("_define.")}
    for name, cls in out.items():
        qual = tag + name
        cls.__name__ = cls.__qualname__ = qual
        globals()[qual] = cls
    for init, resp in (("FetchTip", "VendTip"), ("ResolveTip", "VendForResolve"),
                       ("ProbeTip", "VendForProbe"),
                       ("TwoPartyIssue", "TwoPartyResponder")):
        F.InitiatedBy(out[init])(out[resp])
    return types.SimpleNamespace(**out)


def serialize_any(obj):
    """CBE bytes in the object's own package."""
    if type(obj).__module__.startswith("corda_tpu_torch"):
        return serialize(obj)
    return ref_serialize(obj)


for _tag, _P in PKGS.items():
    _P.f = _define(_tag.capitalize(), _P)


# ------------------------------------------------------------- the data


def _keys(tag: bytes):
    return hashlib.sha256(tag).digest()


OWNER_ENTROPY = _keys(b"Chain Owner")
NOTARY_ENTROPY = _keys(b"Chain Notary")


def to_ref(stxs):
    return [ref_deserialize(serialize(s)) for s in stxs]


@pytest.fixture(scope="module")
def chain():
    stxs, _notary = back_chain(32, seed=13, device="cpu", notarised=True)
    return stxs


DAG_SEED = 29


def _host_sign_tx_ids(jobs, device=None):
    """``sign_tx_ids`` on the host, one transaction at a time (ed25519 is
    deterministic: the same bytes as the batched plain comb, which pays a
    call's set-up for every one of the DAG's transactions)."""
    return [sign_tx_id(kp.private, kp.public, tid) for kp, tid in jobs]


@pytest.fixture(scope="module")
def dag():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(generated_ledger, "sign_tx_ids", _host_sign_tx_ids)
        gen = GeneratedLedger(seed=DAG_SEED, n_parties=3, device="cpu")
        txs = list(gen.generate(128).values())
        return txs, dag_tip(gen)


def _double_spend():
    """An issue, two moves of its one state, and a tip spending both."""
    owner = port_derive(4, OWNER_ENTROPY)
    nkp = port_derive(4, NOTARY_ENTROPY)
    alice = port_ledger.Party(port_ledger.CordaX500Name("Chain Owner", "London", "GB"),
                              owner.public)
    notary = port_ledger.Party(port_ledger.CordaX500Name("Chain Notary", "London", "GB"),
                               nkp.public)
    token = Issued(PartyAndReference(alice, b"\x03"), "GBP")
    chain, _ = back_chain(0, seed=3, device="cpu")
    issue = chain[0]

    def move(inputs, salt, amount=1000):
        b = TransactionBuilder(notary=notary)
        b.set_privacy_salt(PrivacySalt(bytes([salt]) * 32))
        for ref in inputs:
            b.add_input_state(ref)
        b.add_output_state(CashState(Amount(amount, token), alice), CASH_PROGRAM_ID)
        b.add_command(Move(), alice.owning_key)
        return b.to_wire_transaction()

    a = move([issue.tx.out_ref(0)], 1)
    b = move([issue.tx.out_ref(0)], 2)
    tip = move([a.out_ref(0), b.out_ref(0)], 3, amount=2000)
    wtxs = [a, b, tip]
    sigs = sign_tx_ids([(kp, w.id) for w in wtxs for kp in (owner, nkp)], "cpu")
    signed = [SignedTransaction.create(w, sigs[2 * i:2 * i + 2]) for i, w in enumerate(wtxs)]
    return [issue] + signed


class Pair:
    """One package's sender (holding ``stxs``) and a fresh receiver."""

    def __init__(self, pkg, stxs, receiver_entropy=OWNER_ENTROPY, raw_rows=None):
        P = PKGS[pkg]
        self.P = P
        self.net = P.net()
        self.sender = self.net.create_node("Sender")
        kp = P.derive(4, receiver_entropy)
        self.receiver = self.net.create_node("Receiver", keypair=kp)
        P.peers.update(self.net.parties)
        ref_sender_storage = ref_node.DBTransactionStorage()
        for s in to_ref(stxs):
            ref_sender_storage.add_transaction(s)
        if pkg == "ref":
            storage = ref_sender_storage
        else:
            storage = interop.transaction_storage_from_reference(ref_sender_storage)
        # a lying sender: these rows hold other bytes than their id's
        for tx_id, raw in (raw_rows or {}).items():
            storage._db.execute(
                "UPDATE transactions SET blob=? WHERE tx_id=?", (raw, tx_id))
        self.sender.services.validated_transactions = storage
        self.recorded = []
        self.receiver.services.validated_transactions.track(
            lambda stx: self.recorded.append(stx.id.bytes))

    def run(self, flow, timeout=120):
        return self.receiver.run_flow(flow, timeout=timeout)

    def vault(self):
        v = self.receiver.services.vault_service
        crit = self.P.node.QueryCriteria(status=self.P.node.StateStatus.CONSUMED)
        return (
            sorted((s.ref.txhash.bytes, s.ref.index) for s in v.unconsumed_states()),
            sorted((s.ref.txhash.bytes, s.ref.index) for s in v.query_by(crit).states),
        )

    def stop(self):
        self.net.stop()


def _outcome(pkg, stxs, flow_of, **kw):
    pair = Pair(pkg, stxs, **kw)
    try:
        try:
            result = ("ok", pair.run(flow_of(pair)))
        except Exception as e:  # the kind and message are the outcome
            result = ("error", type(e).__name__, str(e))
        return result, pair.recorded, pair.vault()
    finally:
        pair.stop()


def _both(stxs, flow_of, **kw):
    return {pkg: _outcome(pkg, stxs, lambda pair, pkg=pkg: flow_of(PKGS[pkg], pair), **kw)
            for pkg in PKGS}


# ---------------------------------------------------------------- chain


def test_chain_resolves_alike(chain):
    tip = chain[-1]
    out = _both(chain, lambda P, pair: P.f.FetchTip(
        str(pair.sender.party.name), tip.id.bytes))
    assert out["ref"] == out["port"]
    result, recorded, (unconsumed, consumed) = out["port"]
    assert result == ("ok", serialize(tip))
    # deps first, then the tip; every output but the tip's spent
    assert recorded == [s.id.bytes for s in chain]
    assert unconsumed == [(tip.id.bytes, 0)]
    assert consumed == sorted((s.id.bytes, 0) for s in chain[:-1])


def test_resolve_result_list(chain):
    tip = chain[-1]
    out = _both(chain, lambda P, pair: P.f.ResolveTip(
        str(pair.sender.party.name), tip.id.bytes))
    assert out["ref"] == out["port"]
    (kind, ids), recorded, _vault = out["port"]
    assert ids == sorted(s.id.bytes for s in chain[:-1])
    assert recorded == [s.id.bytes for s in chain[:-1]]


def test_generated_dag_resolves_alike(dag):
    txs, tip = dag
    # the receiver owns the tip's output: the DAG's first party, whose key
    # is the ledger's first draw from its seeded generator
    owner_entropy = random.Random(DAG_SEED).randbytes(32)
    out = _both(txs + [tip], lambda P, pair: P.f.FetchTip(
        str(pair.sender.party.name), tip.id.bytes), receiver_entropy=owner_entropy)
    assert out["ref"] == out["port"]
    result, recorded, (unconsumed, consumed) = out["port"]
    assert result == ("ok", serialize(tip))
    assert sorted(recorded[:-1]) == sorted(s.id.bytes for s in txs)
    assert recorded[-1] == tip.id.bytes
    assert unconsumed == [(tip.id.bytes, 0)]
    assert consumed  # the first party's spent outputs inside the DAG


# -------------------------------------------------------------- failures


def test_substituted_transaction_fails_alike(chain):
    tip = chain[-1]
    # the sender's row for chain[20] holds chain[19]'s bytes
    rows = {chain[20].id.bytes: serialize(chain[19])}
    out = _both(chain, lambda P, pair: P.f.FetchTip(
        str(pair.sender.party.name), tip.id.bytes), raw_rows=rows)
    assert out["ref"] == out["port"]
    result, recorded, _vault = out["port"]
    assert result == ("error", "FlowException",
                      f"peer sent wrong transaction for {chain[20].id}")
    assert recorded == []


def test_forged_signature_fails_alike(chain):
    tip = chain[-1]
    bad = chain[5]
    sig = bad.sigs[0]
    forged = dataclasses.replace(bad, sigs=(dataclasses.replace(
        sig, signature=sig.signature[:7] + bytes([sig.signature[7] ^ 4])
        + sig.signature[8:]),) + bad.sigs[1:])
    stxs = chain[:5] + [forged] + chain[6:]
    out = _both(stxs, lambda P, pair: P.f.FetchTip(
        str(pair.sender.party.name), tip.id.bytes))
    assert out["ref"] == out["port"]
    result, recorded, _vault = out["port"]
    assert result[0] == "error" and result[1] == "InvalidSignatureError"
    assert str(bad.id) in result[2]
    assert recorded == []


def test_double_spend_in_dag_fails_alike():
    stxs = _double_spend()
    tip = stxs[-1]
    out = _both(stxs, lambda P, pair: P.f.FetchTip(
        str(pair.sender.party.name), tip.id.bytes))
    assert out["ref"] == out["port"]
    result, recorded, _vault = out["port"]
    assert result[:2] == ("error", "DoubleSpendInDagError")
    assert "consumed twice" in result[2]
    assert recorded == []


def test_vend_probe_outside_chain_fails_alike(chain):
    tip = chain[-1]
    probe = hashlib.sha256(b"not in the chain").digest()
    out = _both(chain, lambda P, pair: P.f.ProbeTip(
        str(pair.sender.party.name), tip.id.bytes, probe))
    assert out["ref"] == out["port"]
    result, _recorded, _vault = out["port"]
    assert result == ("error", "FlowException",
                      f"transaction {PortSecureHash(probe)} is not in the back-chain being sent")


def test_max_resolve_transactions_alike(chain, monkeypatch):
    monkeypatch.setattr(ref_protocols, "MAX_RESOLVE_TRANSACTIONS", 8)
    monkeypatch.setattr(port_protocols, "MAX_RESOLVE_TRANSACTIONS", 8)
    tip = chain[-1]
    out = _both(chain, lambda P, pair: P.f.FetchTip(
        str(pair.sender.party.name), tip.id.bytes))
    assert out["ref"] == out["port"]
    assert out["port"][0] == ("error", "FlowException", "back-chain exceeds 8 transactions")


class _ViaScheduler:
    """A hub's verifier service, routed through the scheduler (the
    reference's mock nodes verify on the host without it)."""

    routes_via_scheduler = True
    use_device = False

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)


def test_closed_scheduler_sheds_to_the_host_alike(chain, monkeypatch):
    """The receiver's top-level check meets a closed scheduler and sheds to
    the host check in both packages: the flow completes, recording the
    whole chain, and the check's span reads ``degraded=host-fallback``."""
    import corda_tpu.observability as ref_obs
    import corda_tpu.serving as ref_serving
    import corda_tpu_torch.observability as port_obs

    ref_closed = ref_serving.DeviceScheduler(use_device_default=False)
    ref_closed.shutdown()
    port_closed = DeviceScheduler(device="cpu")
    port_closed.shutdown()
    monkeypatch.setattr(ref_serving, "device_scheduler", lambda *a, **k: ref_closed)
    monkeypatch.setattr(port_services, "device_scheduler", lambda *a, **k: port_closed)
    short = chain[:5]
    out = {}
    shed_before = port_node_metrics().counter("verifier.host_shed").count
    for pkg, obs in (("ref", ref_obs), ("port", port_obs)):
        obs.configure_tracing(sample_rate=1.0)
        obs.tracer().clear()
        pair = Pair(pkg, short)
        try:
            hub = pair.receiver.services
            hub.transaction_verifier_service = _ViaScheduler(hub.transaction_verifier_service)
            result = ("ok", pair.run(PKGS[pkg].f.FetchTip(
                str(pair.sender.party.name), short[-1].id.bytes)))
            spans = [sp for sp in obs.tracer().dump() if sp["name"] == "flow.verify_stx"]
            out[pkg] = (result, pair.recorded, pair.vault(),
                        [sp["attrs"].get("degraded") for sp in spans])
        finally:
            pair.stop()
            obs.configure_tracing(sample_rate=0.0)
            obs.tracer().clear()
    assert out["port"][:3] == out["ref"][:3]
    assert out["port"][0] == ("ok", serialize(short[-1]))
    assert out["port"][1] == [s.id.bytes for s in short]
    for pkg in PKGS:
        assert out[pkg][3] and set(out[pkg][3]) == {"host-fallback"}, (pkg, out[pkg][3])
    shed = port_node_metrics().counter("verifier.host_shed").count - shed_before
    assert shed == len(out["port"][3]), (shed, out["port"][3])


def test_hub_defaults_to_the_card():
    """``ServiceHub()`` asks for the card; without one it raises rather than
    run on the CPU."""
    if torch.cuda.is_available():
        assert port_node.ServiceHub().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_node.ServiceHub()
    hub = port_node.ServiceHub(device="cpu")
    assert hub.device.type == "cpu"
    assert hub.transaction_verifier_service.routes_via_scheduler
    hub.shutdown()


# --------------------------------------------------- collect signatures


@pytest.mark.parametrize("face,expect", [(500, "ok"), (5000, "face value too large")])
def test_collect_signatures_alike(face, expect):
    out = {}
    for pkg, P in PKGS.items():
        net = P.net()
        try:
            alice = net.create_node("Alice", keypair=P.derive(4, _keys(b"Alice")))
            bob = net.create_node("Bob", keypair=P.derive(4, _keys(b"Bob")))
            P.peers.update(net.parties)
            try:
                out[pkg] = ("ok", alice.run_flow(P.f.TwoPartyIssue(
                    str(bob.party.name), face, _keys(b"Issue Notary"))))
            except P.flows.FlowException as e:
                out[pkg] = ("error", type(e).__name__, str(e))
        finally:
            net.stop()
    assert out["ref"] == out["port"]
    if expect == "ok":
        stx = port_ledger.SignedTransaction
        from corda_tpu_torch.serialization import deserialize
        signed = deserialize(out["port"][1])
        assert isinstance(signed, stx)
        assert len(signed.sigs) == 2
        signed.verify_required_signatures()
    else:
        assert out["port"] == ("error", "FlowException", expect)


# ------------------------------------------------------------- broadcast


def test_broadcast_alike(chain):
    """The sender pushes the tip with ``BroadcastTransactionFlow``; the
    recipient's ``ReceiveBroadcastFlow`` resolves, verifies and records it
    and acknowledges: the same recording order and vault in both
    packages."""
    tip = chain[-1]
    out = {}
    for pkg, P in PKGS.items():
        pair = Pair(pkg, chain)
        try:
            recipient = pair.receiver.party
            stx = pair.sender.services.validated_transactions.get(P.SecureHash(tip.id.bytes))
            result = pair.sender.run_flow(P.flows.BroadcastTransactionFlow(recipient, stx),
                                          timeout=120)
            out[pkg] = (result, pair.recorded, pair.vault())
        finally:
            pair.stop()
    assert out["ref"] == out["port"]
    result, recorded, (unconsumed, _consumed) = out["port"]
    assert result is None
    assert recorded == [s.id.bytes for s in chain]
    assert unconsumed == [(tip.id.bytes, 0)]
