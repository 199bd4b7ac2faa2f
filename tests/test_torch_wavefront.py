"""The back-chain resolve, the port's ``verify_transaction_dag`` against the
reference's, on the same transactions: built by the reference and carried
across as CBE bytes (``interop.signed_transaction_from_reference``).

The port runs on ``device="cpu"`` (its kernels' plain versions: the id
sweep on C and D, the signatures on A and B), the reference on its host
route (``use_device=False``) unless a case needs its device route. Each
case must give the same order, levels, signature count and consumed set,
or the same exception class and message (tolerance zero):

- ``topological_levels`` on seeded random DAGs, and a cycle;
- a 40-hop Cash chain at ``window=16, depth=3`` (three windows in flight
  before the first walk), on the scheduler route and the direct one;
- the reference's 60-transaction ``GeneratedLedger(seed=7)`` DAG, and the
  port's own ``GeneratedLedger`` and ``back_chain`` (a seed fixes every
  byte; the reference resolves their DAGs alike);
- the diamond and the external resolution of tests/test_verifier.py, and
  each failure kind: double spend, orphan, a non-conserving move, a
  tampered signature, a missing signature, a forged chain link (the
  reference's device route, its ids on its host; no claimed id left
  cached);
- ``check_and_prime_ids`` against the reference's on JAX's CPU, and the
  abort path;
- a card that fails (none present, the sweep, the readback, the signature
  dispatch, the scheduler) raises out of the resolve with no claimed id
  cached, and nothing moves to the host; a scheduler that refuses hands
  the window to the direct dispatch;
- the rule of full windows: a signature whose verdict differs between the
  cofactored rule and the cofactorless one, in a full window and in the
  ragged last one, on the direct route against the reference's device
  route (its RLC route for full buckets)."""

import dataclasses
import hashlib
import random
import types

import jax
import pytest
import torch

import corda_tpu.finance  # noqa: F401  (registers the reference's Cash contract)
from corda_tpu.crypto import SecureHash as RefSecureHash
from corda_tpu.crypto import SignableData as RefSignableData
from corda_tpu.crypto import TransactionSignature as RefTransactionSignature
from corda_tpu.crypto import derive_keypair_from_entropy
from corda_tpu.crypto.keys import PublicKey as RefPublicKey
from corda_tpu.finance import CashState
from corda_tpu.finance.contracts import CASH_PROGRAM_ID, Issue, Move
from corda_tpu.ledger import (
    Amount,
    CordaX500Name,
    Issued,
    Party,
    PartyAndReference,
    PrivacySalt,
    SignedTransaction,
    StateRef,
    TransactionBuilder,
)
from corda_tpu.ops import txid as ref_txid
from corda_tpu.parallel import wavefront as ref_wavefront
from corda_tpu.serialization import deserialize as ref_deserialize
from corda_tpu.serialization import serialize as ref_serialize
from corda_tpu.serving import shutdown_scheduler as ref_shutdown_scheduler
from corda_tpu.testing.generated_ledger import GeneratedLedger as RefGeneratedLedger
import corda_tpu_torch.finance  # noqa: F401  (registers the port's Cash contract)
from corda_tpu_torch import interop
from corda_tpu_torch.crypto import SecureHash as PortSecureHash
from corda_tpu_torch.crypto.ed25519_host import BASE, compress, point_add, scalar_mul
from corda_tpu_torch.ledger import StateRef as PortStateRef
from corda_tpu_torch.ops import txid as port_txid
from corda_tpu_torch.ops._blockpack import HostCopy
from corda_tpu_torch.parallel import wavefront as port_wavefront
from corda_tpu_torch.serialization import deserialize, serialize
from corda_tpu_torch.serving import shutdown_scheduler
from corda_tpu_torch.testing import _sign_with, back_chain, small_r_signature, torsion_point8
from corda_tpu_torch.testing import GeneratedLedger as PortGeneratedLedger


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run many small integer ops: beside the suite's
    other worker processes a torch thread pool only contends, so these
    tests run torch on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def shared_schedulers():
    """Both packages' process-global schedulers, shut down after the module."""
    yield
    shutdown_scheduler()
    ref_shutdown_scheduler()


# ------------------------------------------------ the reference's transactions


def _party(tag: bytes):
    kp = derive_keypair_from_entropy(4, hashlib.sha256(tag).digest())
    return Party(CordaX500Name(tag.decode(), "London", "GB"), kp.public), kp


ALICE, AKP = _party(b"Chain Owner")
NOTARY, NKP = _party(b"Chain Notary")
TOKEN = Issued(PartyAndReference(ALICE, b"\x03"), "GBP")


class Maker:
    """Reference Cash transactions with seeded privacy salts."""

    def __init__(self, seed: int):
        self.rng = random.Random(seed)

    def builder(self):
        b = TransactionBuilder(notary=NOTARY)
        b.set_privacy_salt(PrivacySalt(self.rng.randbytes(32)))
        return b

    def issue(self, *amounts):
        b = self.builder()
        for q in amounts:
            b.add_output_state(CashState(Amount(q, TOKEN), ALICE), CASH_PROGRAM_ID)
        b.add_command(Issue(), ALICE.owning_key)
        return b.sign_initial_transaction(AKP)

    def move(self, spends, *amounts, notary_sig=True):
        """Spend ``spends`` (StateAndRefs) into outputs of ``amounts``,
        signed by Alice and (``notary_sig``) the notary."""
        b = self.builder()
        for sar in spends:
            b.add_input_state(sar)
        for q in amounts:
            b.add_output_state(CashState(Amount(q, TOKEN), ALICE), CASH_PROGRAM_ID)
        b.add_command(Move(), ALICE.owning_key)
        return b.sign_initial_transaction(*((AKP, NKP) if notary_sig else (AKP,)))

    def chain(self, hops):
        """bench.py's back-chain shape: an issue, then ``hops`` self-moves
        signed by the owner only."""
        out = [self.issue(1000)]
        for _ in range(hops):
            out.append(self.move([out[-1].tx.out_ref(0)], 1000, notary_sig=False))
        return out


def _signed_by_notary_missing(stx):
    return {NOTARY.owning_key}


def to_port(ref_stxs):
    return [interop.signed_transaction_from_reference(ref_serialize(s)) for s in ref_stxs]


def _cold(stxs):
    for stx in stxs:
        object.__getattribute__(stx.tx, "__dict__").pop("_id", None)


def outcome(fn):
    """A resolve's result as comparable data, or its exception's class and
    message."""
    try:
        r = fn()
    except Exception as e:  # noqa: BLE001  (the class is the outcome)
        return ("raised", type(e).__name__, str(e))
    return ("ok", [t.bytes for t in r.order], [[t.bytes for t in lvl] for lvl in r.levels],
            r.n_sigs, sorted((ref.txhash.bytes, ref.index) for ref in r.consumed))


def resolve_both(ref_stxs, *, claimed=None, allowed=True, external=None, port_kw=None,
                 ref_kw=None):
    """(port outcome, reference outcome) over the same transactions, keyed
    by ``claimed`` ids (their own by default), every id cache cold.
    ``external``: reference transactions whose outputs resolve from
    outside the DAG."""
    port_stxs = to_port(ref_stxs)
    claimed = claimed or [s.id.bytes for s in ref_stxs]
    _cold(ref_stxs)
    ref_dag = {RefSecureHash(c): s for c, s in zip(claimed, ref_stxs)}
    port_dag = {PortSecureHash(c): s for c, s in zip(claimed, port_stxs)}
    ref_ext = port_ext = None
    if external:
        ref_states = {StateRef(s.id, i): ts for s in external for i, ts in enumerate(s.tx.outputs)}
        port_states = {PortStateRef(s.id, i): ts for s in to_port(external)
                       for i, ts in enumerate(s.tx.outputs)}
        ref_ext, port_ext = ref_states.get, port_states.get
    notary_key = to_port([ref_stxs[0]])[0].tx.notary.owning_key
    got = outcome(lambda: port_wavefront.verify_transaction_dag(
        port_dag, port_ext, (lambda s: {notary_key}) if allowed else None, device="cpu",
        **(port_kw or {})))
    want = outcome(lambda: ref_wavefront.verify_transaction_dag(
        ref_dag, ref_ext, _signed_by_notary_missing if allowed else None,
        **({"use_device": False} | (ref_kw or {}))))
    return got, want, port_stxs


# ------------------------------------------------------------ the level sort


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topological_levels_match_reference(seed):
    rng = random.Random(seed)
    n = 60
    deps = {i: {rng.randrange(i) for _ in range(rng.randint(0, 3))} if i else set()
            for i in range(n)}
    deps[n] = {n + 100}  # a parent outside the DAG: dropped
    assert port_wavefront.topological_levels(deps) == ref_wavefront.topological_levels(deps)


def test_cycle_raises_as_reference():
    deps = {1: {2}, 2: {3}, 3: {1}, 4: set()}
    with pytest.raises(ref_wavefront.DagVerificationError) as want:
        ref_wavefront.topological_levels(deps)
    with pytest.raises(port_wavefront.DagVerificationError) as got:
        port_wavefront.topological_levels(deps)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------- resolves


@pytest.mark.parametrize("route", ["scheduler", "direct"])
def test_chain_matches_reference(monkeypatch, route):
    """40 hops at window=16, depth=3: three windows (16, 16, 9) dispatched
    before the first walk; every id recomputed, checked and primed."""
    events = []
    dispatch, walk = port_wavefront.dispatch_check_ids, port_wavefront._walk_levels
    monkeypatch.setattr(port_wavefront, "dispatch_check_ids",
                        lambda stxs, device: events.append(("d", len(stxs))) or dispatch(stxs,
                                                                                     device))
    monkeypatch.setattr(port_wavefront, "_walk_levels",
                        lambda wl, *a: events.append(("w", len(wl))) or walk(wl, *a))
    chain = Maker(1).chain(40)
    got, want, port_stxs = resolve_both(
        chain, port_kw={"window": 16, "depth": 3, "use_scheduler": route == "scheduler"})
    assert got == want and got[0] == "ok"
    assert len(got[2]) == 41 and got[3] == 41
    assert events == [("d", 16), ("d", 16), ("d", 9), ("w", 16), ("w", 16), ("w", 9)]
    for stx in port_stxs:
        primed = object.__getattribute__(stx.tx, "__dict__")["_id"]
        assert primed == deserialize(stx.tx_bits).id


@pytest.mark.parametrize("window", [256, 16])
def test_generated_ledger_matches_reference(window):
    """The reference's fuzz DAG: fan-in, fan-out, several signers and the
    notary, every signature present."""
    dag = RefGeneratedLedger(seed=7).generate(60)
    got, want, _ = resolve_both(list(dag.values()), allowed=False,
                                port_kw={"window": window}, ref_kw={"window": window})
    assert got == want and got[0] == "ok"
    assert max(len(lvl) for lvl in got[2]) > 1


def test_port_generators_fix_the_dag_and_resolve_as_reference():
    """The port's ``GeneratedLedger`` and ``back_chain`` (signed by the
    plain comb on ``device="cpu"``): a seed fixes every byte, and both
    packages resolve the port's DAG alike, the reference checking every
    signature with its own host verifier."""
    gen = PortGeneratedLedger(seed=11, n_parties=4, device="cpu").generate(24)
    again = PortGeneratedLedger(seed=11, n_parties=4, device="cpu").generate(24)
    assert [serialize(s) for s in gen.values()] == [serialize(s) for s in again.values()]
    chain, _notary = back_chain(6, seed=2, device="cpu")
    assert [serialize(s) for s in chain] == \
        [serialize(s) for s in back_chain(6, seed=2, device="cpu")[0]]
    assert all("_id" not in object.__getattribute__(s.tx, "__dict__") for s in chain)
    for stxs, allowed in ((list(gen.values()), False), (chain, True)):
        got, want, _ = resolve_both([ref_deserialize(serialize(s)) for s in stxs],
                                    allowed=allowed)
        assert got == want and got[0] == "ok"


def _diamond(m):
    root = m.issue(100)
    split = m.move([root.tx.out_ref(0)], 40, 60)
    a = m.move([split.tx.out_ref(0)], 40)
    b = m.move([split.tx.out_ref(1)], 60)
    return [root, split, a, b]


def _case(name):
    """Reference transactions, outside ones and the expected outcome class
    for each case (the diamond and external resolution of
    tests/test_verifier.py, then each failure kind)."""
    m = Maker(10 + CASES.index(name))
    if name == "diamond":
        return _diamond(m), None, "ok"
    if name == "external":
        root = m.issue(7)
        return [m.move([root.tx.out_ref(0)], 7)], [root], "ok"
    if name == "double_spend":
        root = m.issue(100)
        return ([root, m.move([root.tx.out_ref(0)], 100), m.move([root.tx.out_ref(0)], 60, 40)],
                None, "DoubleSpendInDagError")
    if name == "orphan":
        return [m.move([m.issue(5).tx.out_ref(0)], 5)], None, "UnresolvedStateError"
    if name == "not_conserving":
        root = m.issue(50)
        return [root, m.move([root.tx.out_ref(0)], 49)], None, "TransactionVerificationException"
    if name == "tampered_signature":
        txs = _diamond(m)
        sig = txs[2].sigs[0]
        txs[2] = dataclasses.replace(txs[2], sigs=(dataclasses.replace(
            sig, signature=sig.signature[:5] + bytes([sig.signature[5] ^ 1]) + sig.signature[6:]),
            *txs[2].sigs[1:]))
        return txs, None, "InvalidSignatureError"
    if name == "missing_signature":
        chain = m.chain(3)  # the notary never signs, and here may not be missing
        return chain, None, "SignaturesMissingException"
    raise AssertionError(name)


CASES = ["diamond", "external", "double_spend", "orphan", "not_conserving",
         "tampered_signature", "missing_signature"]


@pytest.mark.parametrize("name", CASES)
def test_case_matches_reference(name):
    txs, external, kind = _case(name)
    got, want, _ = resolve_both(txs, external=external, allowed=name != "missing_signature")
    assert got == want
    assert (got[0] if kind == "ok" else got[1]) == kind
    if name == "diamond":
        assert [len(lvl) for lvl in got[2]] == [1, 1, 2]


def _forged_chain():
    """48 transactions (three full windows of 16), the 21st and the 41st
    (windows 1 and 2) each replaced by a move of the same input to another
    owner, carrying the original's signature and keyed under the original's
    id."""
    m = Maker(3)
    chain = m.chain(47)
    claimed = [s.id.bytes for s in chain]
    for at in (20, 40):
        b = m.builder()
        b.add_input_state(chain[at - 1].tx.out_ref(0))
        b.add_output_state(CashState(Amount(1000, TOKEN), NOTARY), CASH_PROGRAM_ID)
        b.add_command(Move(), ALICE.owning_key)
        chain[at] = SignedTransaction.create(b.to_wire_transaction(), list(chain[at].sigs))
    return chain, claimed


@pytest.mark.parametrize("route", ["scheduler", "direct"])
def test_forged_link_matches_reference(monkeypatch, route):
    """The first forged link raises the reference's mismatch at its own
    window (one window walked before it); afterwards no port transaction
    holds a cached id other than its bytes' id (window 2's claims, the
    second forged one among them, primed at dispatch, are dropped). The
    reference runs its device route (every window full: its RLC route)
    with its ids on its host."""
    monkeypatch.setattr(ref_txid, "_ids_tier_cache", "host")
    walks = []
    walk = port_wavefront._walk_levels
    monkeypatch.setattr(port_wavefront, "_walk_levels",
                        lambda wl, *a: walks.append(len(wl)) or walk(wl, *a))
    chain, claimed = _forged_chain()
    kw = {"window": 16, "depth": 3, "use_scheduler": route == "scheduler"}
    got, want, port_stxs = resolve_both(chain, claimed=claimed, port_kw=kw,
                                        ref_kw={"use_device": True} | kw)
    assert got == want
    assert got[1] == "TransactionVerificationException"
    assert f"transaction id mismatch: claimed {RefSecureHash(claimed[20])}, recomputed " \
        f"{chain[20].id}" in got[2]
    assert walks == [16]
    for stx in port_stxs:
        cached = object.__getattribute__(stx.tx, "__dict__").get("_id")
        assert cached is None or cached == deserialize(stx.tx_bits).id


# ------------------------------------------------------------- the id check


@pytest.mark.parametrize("start", [20, 14, 9], ids=["first", "middle", "last"])
def test_check_and_prime_ids_matches_reference(monkeypatch, start):
    """Equal ids primed, then the same mismatch message, and every cached
    id equal to its bytes' afterwards (those past the mismatch included),
    as the reference's device tier on JAX's CPU gives them; the forged
    transaction is the first, a middle or the last of the 12 checked."""
    monkeypatch.setattr(ref_txid, "_ids_tier_cache", "device")
    chain, claimed = _forged_chain()
    chain = chain[start:start + 12]
    claimed = claimed[start:start + 12]
    good = [s for k, s in enumerate(chain) if k != 20 - start]
    port_good = to_port(good)
    ref_txid.check_and_prime_ids({s.id: s for s in good})
    port_txid.check_and_prime_ids({PortSecureHash(s.id.bytes): s for s in port_good},
                                  device="cpu")
    assert [object.__getattribute__(s.tx, "__dict__")["_id"].bytes for s in port_good] == \
        [s.id.bytes for s in good]

    port_all = to_port(chain)
    _cold(chain)
    with pytest.raises(Exception) as want:
        ref_txid.check_and_prime_ids({RefSecureHash(c): s for c, s in zip(claimed, chain)})
    with pytest.raises(Exception) as got:
        port_txid.check_and_prime_ids(
            {PortSecureHash(c): s for c, s in zip(claimed, port_all)}, device="cpu")
    assert (type(got.value).__name__, str(got.value)) == \
        (type(want.value).__name__, str(want.value))
    assert [object.__getattribute__(s.tx, "__dict__")["_id"] for s in port_all] == \
        [deserialize(s.tx_bits).id for s in port_all]


def test_abort_drops_claimed_ids_and_ready_follows_the_copy():
    """``abort()`` leaves no claimed id cached and is idempotent; a
    ``HostCopy`` (and the check over it) is ready exactly when its event
    has completed, and a CPU result always is."""
    chain = to_port(Maker(4).chain(3))
    claims = {s.tx.id: s for s in chain}
    for stx in chain:
        object.__getattribute__(stx.tx, "__dict__")["_id"] = PortSecureHash(bytes(32))
    pending = port_txid.dispatch_check_ids(claims, device="cpu")
    assert pending.ready()
    pending.abort()
    pending.abort()
    assert all("_id" not in object.__getattribute__(s.tx, "__dict__") for s in chain)
    pending.collect()  # nothing left to check
    done = [False]
    event = types.SimpleNamespace(query=lambda: done[0])
    copy = HostCopy(torch.zeros((1, 8), dtype=torch.int32), event)
    check = port_txid.PendingIdCheck([], copy)
    assert not copy.ready() and not check.ready()
    done[0] = True
    assert copy.ready() and check.ready()
    assert HostCopy(torch.zeros(1), None).ready()


# ------------------------------------------------------- a card that fails


def _card_that_fails(monkeypatch, where):
    """Make the card fail at ``where`` on window 2 of three (16, 16, 9);
    returns the resolve's keyword arguments."""
    kw = {"window": 16, "depth": 3, "use_scheduler": False}
    if where == "no_card":
        # the caller names the card on a machine without one
        return kw | {"device": "cuda"}
    calls = [0]

    def second(fn):
        def wrapper(*a, **k):
            calls[0] += 1
            if calls[0] == 2:
                raise RuntimeError("CUDA error: an illegal memory access was encountered")
            return fn(*a, **k)
        return wrapper

    if where == "sweep":
        monkeypatch.setattr(port_txid, "_tx_id_roots", second(port_txid._tx_id_roots))
    elif where == "readback":
        # the second window's roots fail on their way to the host
        def copy(result):
            got = start(result)
            return types.SimpleNamespace(ready=got.ready, wait=second(got.wait))
        start = port_txid.start_host_copy
        monkeypatch.setattr(port_txid, "start_host_copy", copy)
    elif where == "signatures":
        monkeypatch.setattr(port_wavefront, "dispatch_transactions",
                            second(port_wavefront.dispatch_transactions))
    else:
        sched = types.SimpleNamespace(
            submit_transactions=second(lambda *a, **k: types.SimpleNamespace()))
        monkeypatch.setattr(port_wavefront, "device_scheduler", lambda *a: sched)
        monkeypatch.setattr(port_wavefront, "FuturePending", lambda f: None)
        kw["use_scheduler"] = True
    return kw


@pytest.mark.parametrize("where", ["no_card", "sweep", "readback", "signatures", "scheduler"])
def test_card_that_fails_raises_and_keeps_no_claim(monkeypatch, where):
    """A resolve on a card that fails raises the card's error: no window
    is walked after it, no other route takes over, and no claimed id stays
    cached (those of the windows in flight included). A scheduler's error
    that is not its refusal is not taken for one. Only a failed readback
    comes after a walk: window 1's, collected before window 2's roots."""
    kw = _card_that_fails(monkeypatch, where)
    walks = []
    walk = port_wavefront._walk_levels
    monkeypatch.setattr(port_wavefront, "_walk_levels",
                        lambda wl, *a: walks.append(len(wl)) or walk(wl, *a))
    chain = to_port(Maker(7).chain(40))
    dag = {s.tx.id: s for s in chain}
    _cold(chain)
    notary_key = chain[0].tx.notary.owning_key
    with pytest.raises(RuntimeError, match="CUDA" if where != "no_card" else "no CUDA device"):
        port_wavefront.verify_transaction_dag(dag, None, lambda s: {notary_key},
                                              **({"device": "cpu"} | kw))
    assert walks == ([16] if where == "readback" else [])
    cached = [object.__getattribute__(s.tx, "__dict__").get("_id") for s in chain]
    assert all(c is None or c == deserialize(s.tx_bits).id for c, s in zip(cached, chain))
    assert sum(c is not None for c in cached) == sum(walks)  # the checked ones only


def test_refused_submit_dispatches_directly(monkeypatch):
    """A scheduler that refuses (``ServingError``: saturated or shut down)
    hands every window to the direct dispatch on the same device, with the
    same verdicts."""
    refused = []

    def refuse(*a, **k):
        refused.append(len(a[0]))
        raise port_wavefront.ServingError("saturated")

    monkeypatch.setattr(port_wavefront, "device_scheduler",
                        lambda *a: types.SimpleNamespace(submit_transactions=refuse))
    got, want, _ = resolve_both(Maker(8).chain(40), port_kw={"window": 16, "depth": 3})
    assert got == want and got[0] == "ok"
    assert refused == [16, 16, 9]


# ------------------------------------------------------- the rule of windows


def _extra_signature(stx, kind):
    """``stx`` with one more signature over its id by a key it does not
    require: ``small_r`` (R of small order, ``cofactored_lanes``' kind
    ``small_order_r_accepted_cofactorless``: the cofactorless rule accepts,
    the cofactored one rejects) or ``mixed`` (a mixed-order key with h not
    0 mod 8, ``adversarial_lanes``' ``mixed_order_reject``: the other way
    round)."""
    meta = stx.sigs[0].metadata
    payload = RefSignableData(stx.id, meta).to_bytes()
    if kind == "small_r":
        pub, sig, _m = small_r_signature(bytes([9]) * 32, payload)
    else:
        a = 987654321
        pub = compress(point_add(scalar_mul(a, BASE), torsion_point8()))
        r = 1
        while True:
            sig, h = _sign_with(a, pub, payload, r)
            if h % 8:
                break
            r += 1
    return dataclasses.replace(stx, sigs=stx.sigs + (
        RefTransactionSignature(sig, RefPublicKey(4, pub), meta),))


@pytest.mark.parametrize("kind", ["small_r", "mixed"])
@pytest.mark.parametrize("where", ["full", "ragged"])
def test_window_rule_matches_reference(monkeypatch, kind, where):
    """10 transactions at window=4, dispatched directly: windows of 4, 4
    and 2. The extra signature sits in window 1 (5 rows, the pinned bucket:
    full, the cofactored rule) or in the ragged last window (3 rows: the
    cofactorless rule)."""
    monkeypatch.setattr(ref_txid, "_ids_tier_cache", "host")
    chain = Maker(6).chain(9)
    at = 5 if where == "full" else 9
    chain[at] = _extra_signature(chain[at], kind)
    got, want, _ = resolve_both(chain, port_kw={"window": 4, "use_scheduler": False},
                                ref_kw={"use_device": True, "window": 4,
                                        "use_scheduler": False})
    assert got == want
    rejected = (kind == "small_r") == (where == "full")
    assert got[0] == ("raised" if rejected else "ok")
    if rejected:
        assert got[1] == "InvalidSignatureError"
