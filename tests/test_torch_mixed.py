"""The mixed-scheme slice as a whole on the CPU: ed25519, secp256k1,
secp256r1, SPHINCS and RSA rows in one batch through the port's
``dispatch_signature_rows`` (one device bucket a scheme, each on its plain
version; RSA settled on the host) and its ``DeviceScheduler``
(device="cpu"), against the reference's
``dispatch_signature_rows(rows, use_device=False)`` (its host oracles,
OpenSSL for ECDSA and RSA): a 48-row batch of the ed25519 and ECDSA kinds,
and bench.py's whole ``MIXED_COMPOSITION`` with the adversarial lanes of
every scheme; the reference's padding rule, SPHINCS's capped floor
included; the buckets' settling order; a Cash move signed by SPHINCS and
RSA keys through ``check_transactions`` and a validating notary window;
composite and BLS rows as in the reference (a composite row raises the
``CryptoError`` of ``is_valid``, a BLS row settles on the host)."""

import random

import numpy as np
import pytest
import torch

pytest.importorskip("cryptography")  # the reference's ECDSA oracle is OpenSSL

from corda_tpu.crypto.keys import PublicKey as RefPublicKey
from corda_tpu.ops._blockpack import pow2_at_least as ref_pow2_at_least
from corda_tpu.verifier.batch import dispatch_signature_rows as ref_dispatch
from corda_tpu_torch.crypto import CryptoError, PublicKey, is_valid
from corda_tpu_torch.ops._blockpack import HostCopy
from corda_tpu_torch.serving import BULK, INTERACTIVE, SERVICE, DeviceScheduler
from corda_tpu_torch.testing import (
    MIXED_COMPOSITION,
    adversarial_lanes,
    ecdsa_adversarial_lanes,
    mixed_rows,
    rsa_adversarial_lanes,
    sphincs_adversarial_lanes,
)
from corda_tpu_torch.verifier import dispatch_signature_rows
from corda_tpu_torch.verifier.batch import PendingRows

# the ECDSA kinds of the 48-row batch (8 a curve)
ECDSA_KINDS = ("valid", "valid_uncompressed", "second_candidate", "high_s_twin",
               "flipped_r_bit", "wrong_key", "key_x_ge_p", "other_curve_key")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run many small integer ops: beside the suite's
    other worker processes a torch thread pool only contends, so these
    tests run torch on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def rows():
    """48 rows: 32 ed25519 (every ed25519 adversarial kind, the rest
    valid mixed rows) and 8 a curve of ECDSA adversarial kinds, shuffled."""
    ed = [(PublicKey(4, pk), s, m) for _k, pk, s, m in adversarial_lanes(0)]
    ed += mixed_rows((("eddsa", 32 - len(ed)),), keys_per_scheme=4, device="cpu")
    ecdsa = []
    for sid, name in ((2, "secp256k1"), (3, "secp256r1")):
        lanes = {k: (pk, s, m) for k, pk, s, m in ecdsa_adversarial_lanes(name, seed=21)}
        ecdsa += [(PublicKey(sid, lanes[k][0]), *lanes[k][1:]) for k in ECDSA_KINDS]
    out = ed + ecdsa
    random.Random(7).shuffle(out)
    assert len(out) == 48
    return out


def ref_rows(rows):
    return [(RefPublicKey(k.scheme_id, k.encoded), s, m) for k, s, m in rows]


@pytest.fixture(scope="module")
def reference_mask(rows):
    return ref_dispatch(ref_rows(rows), use_device=False).collect()


def test_dispatch_matches_reference(rows, reference_mask):
    want = reference_mask.tolist()
    for sid in (2, 3, 4):  # every scheme has rows accepted and rejected
        assert {w for (k, _s, _m), w in zip(rows, want) if k.scheme_id == sid} == {True, False}
    pending = dispatch_signature_rows(rows, device="cpu")
    assert pending.collect().tolist() == want
    assert pending.device_rows == 48 and pending.device_mask.all()
    host = dispatch_signature_rows(rows, use_device=False)
    assert host.collect().tolist() == want and host.device_rows == 0
    assert [is_valid(k, s, m) for k, s, m in rows] == want


@pytest.mark.parametrize("min_bucket", [None, 16, 64])
def test_padded_lanes_follow_reference_rule(rows, min_bucket):
    """One bucket a scheme, each padded to pow2_at_least(n, max(min_bucket,
    8)), the reference's rule off its TPU."""
    sub = rows[:40]
    counts = {}
    for key, _s, _m in sub:
        counts[key.scheme_id] = counts.get(key.scheme_id, 0) + 1
    pending = dispatch_signature_rows(sub, min_bucket=min_bucket, device="cpu")
    assert len(pending._deferred) == len(counts) == 3
    assert pending.padded_lanes == sum(
        ref_pow2_at_least(c, max(min_bucket or 0, 8)) for c in counts.values())


def test_scheduler_serves_the_mixed_batch(rows, reference_mask):
    """The 48 rows as requests of 1-12 rows across the three classes,
    coalesced into mixed batches: every request's verdicts equal the
    reference's, all on the device path."""
    sizes = [5, 1, 12, 3, 9, 2, 8, 4, 4]
    assert sum(sizes) == 48
    sched = DeviceScheduler(device="cpu")
    try:
        sched.pause()
        futures, at = [], 0
        for k, size in enumerate(sizes):
            futures.append((at, size, sched.submit_rows(
                rows[at : at + size], priority=(BULK, SERVICE, INTERACTIVE)[k % 3])))
            at += size
        sched.resume()
        for at, size, fut in futures:
            rr = fut.result(timeout=300)
            assert rr.mask.tolist() == reference_mask[at : at + size].tolist()
            assert rr.n_device == size
        assert sched.counters["serving.rows"] == 48
        assert sched.counters["serving.device_rows"] == 48
        assert sched.counters["serving.padded_lanes"] >= 48
    finally:
        sched.shutdown()


class _Event:
    def __init__(self, log, name, ready):
        self.log, self.name, self.ready = log, name, ready

    def query(self):
        return self.ready

    def synchronize(self):
        self.log.append(self.name)


def test_mixed_buckets_settle_in_completion_order():
    """A batch's buckets settle in the order their copies complete: the
    ECDSA buckets that landed first are read before the ed25519 bucket
    that is still on the card."""
    log = []
    pending = PendingRows(6)
    for name, idxs, ready, verdicts in (("ed25519", [0, 3], False, [True, False]),
                                        ("secp256k1", [1, 4], True, [False, True]),
                                        ("secp256r1", [2, 5], True, [True, True])):
        handle = HostCopy(torch.tensor(verdicts + [False] * 6), _Event(log, name, ready))
        pending._deferred.append((idxs, handle))
    assert not pending.ready()
    mask = pending.collect()
    assert log == ["secp256k1", "secp256r1", "ed25519"]
    assert mask.tolist() == [True, False, True, False, True, True]


@pytest.mark.parametrize("scheme,item", [(6, "CryptoError"), (7, None)],
                         ids=["composite", "bls"])
def test_sphincs_and_rsa_rows_still_raise(rows, scheme, item):
    """SPHINCS and RSA rows are served; so are the last two schemes now, as
    in the reference: a composite-key row raises the ``CryptoError`` of
    ``is_valid`` on every route and fails its request at the scheduler (the
    request beside it served), and a BLS row (a key that does not decode)
    settles False on the host on every route."""
    from corda_tpu.crypto import CryptoError as RefCryptoError

    bad = rows[:3] + [(PublicKey(scheme, b"\x01" * 33), b"sig", b"msg")]
    sched = DeviceScheduler(device="cpu")
    try:
        if item == "CryptoError":
            with pytest.raises(CryptoError):
                dispatch_signature_rows(bad, device="cpu")
            with pytest.raises(CryptoError):
                dispatch_signature_rows(bad, use_device=False)
            with pytest.raises(RefCryptoError):
                ref_dispatch(ref_rows(bad), use_device=False)
            refused, served = sched.submit_rows(bad), sched.submit_rows(rows[:3])
            assert isinstance(refused.exception(timeout=60), CryptoError)
            assert served.result(timeout=60).mask.tolist() == \
                ref_dispatch(ref_rows(rows[:3]), use_device=False).collect().tolist()
        else:
            want = ref_dispatch(ref_rows(bad), use_device=False).collect().tolist()
            assert want[-1] is False
            assert dispatch_signature_rows(bad, device="cpu").collect().tolist() == want
            assert dispatch_signature_rows(bad, use_device=False).collect().tolist() == want
            result = sched.submit_rows(bad).result(timeout=60)
            assert result.mask.tolist() == want and result.n_device == 3
    finally:
        sched.shutdown()


def test_mixed_rows_composition():
    """The workload's shape: the composition's counts a scheme, keys
    round robin and capped at the count, messages as in bench.py, shuffled
    with Random(7), tiled; a seed fixes every row, RSA keys included."""
    comp = (("eddsa", 6), ("secp256k1", 3), ("secp256r1", 3), ("sphincs", 1), ("rsa", 2))
    timings = {}
    base = mixed_rows(comp, keys_per_scheme=2, device="cpu", timings=timings)
    tiled = mixed_rows(comp, keys_per_scheme=2, tile=3, device="cpu")
    assert len(base) == 15 and len(tiled) == 45
    assert set(timings) == {name for name, _n in comp}
    by_scheme = {}
    for key, _s, msg in base:
        by_scheme.setdefault(key.scheme_id, set()).add(key)
        assert msg[:4] == b"CTMX" and len(msg) == 36
    assert {k: len(v) for k, v in by_scheme.items()} == {4: 2, 2: 2, 3: 2, 5: 1, 1: 2}
    assert sorted(map(repr, base * 3)) == sorted(map(repr, tiled))
    assert all(is_valid(k, s, m) for k, s, m in base)
    assert MIXED_COMPOSITION == (("eddsa", 2048), ("secp256k1", 512), ("secp256r1", 512),
                                 ("sphincs", 8), ("rsa", 8))
    assert np.array_equal(
        ref_dispatch(ref_rows(base), use_device=False).collect(), np.ones(15, bool))


# ------------------------------------------------ the whole composition


@pytest.fixture(scope="module")
def full_rows():
    """bench.py's whole MIXED_COMPOSITION (3,088 rows) with every SPHINCS,
    RSA and ECDSA adversarial kind inserted at known positions. (The
    ed25519 kinds, on which the cofactored rule of a full bucket differs,
    are the 48-row batch's.)"""
    rows = mixed_rows(MIXED_COMPOSITION, keys_per_scheme=4, seed=3, device="cpu")
    adversarial = [(PublicKey(5, pk), s, m) for _k, pk, s, m in sphincs_adversarial_lanes(2)]
    adversarial += [(PublicKey(1, pk), s, m) for _k, pk, s, m in rsa_adversarial_lanes(2)]
    for sid, name in ((2, "secp256k1"), (3, "secp256r1")):
        adversarial += [(PublicKey(sid, pk), s, m)
                        for _k, pk, s, m in ecdsa_adversarial_lanes(name, seed=22)]
    for k, row in enumerate(adversarial):
        rows.insert((5 + 97 * k) % len(rows), row)
    return rows


@pytest.fixture(scope="module")
def full_reference_mask(full_rows):
    return ref_dispatch(ref_rows(full_rows), use_device=False).collect()


def scheme_counts(rows):
    counts = {}
    for key, _s, _m in rows:
        counts[key.scheme_id] = counts.get(key.scheme_id, 0) + 1
    return counts


@pytest.mark.parametrize("route", ["dispatch", "host", "scheduler"])
def test_full_composition_matches_reference(full_rows, full_reference_mask, route):
    """Every row equals the reference's verdict on each route. RSA rows are
    host rows (out of ``device_rows`` and ``device_mask``); every other
    row settles on the device, each bucket padded by the reference's rule
    (SPHINCS's floor 8, capped at 32)."""
    want = full_reference_mask.tolist()
    counts = scheme_counts(full_rows)
    assert counts[5] == 8 + 17 and counts[1] == 8 + 31
    for sid in (1, 2, 3, 4, 5):
        assert {w for (k, _s, _m), w in zip(full_rows, want) if k.scheme_id == sid} == \
            ({True} if sid == 4 else {True, False})
    on_device = np.array([k.scheme_id != 1 for k, _s, _m in full_rows])
    if route == "dispatch":
        pending = dispatch_signature_rows(full_rows, device="cpu")
        assert len(pending._deferred) == 4
        assert pending.collect().tolist() == want
        assert pending.device_rows == len(full_rows) - counts[1]
        assert np.array_equal(pending.device_mask, on_device)
        assert pending.padded_lanes == sum(
            ref_pow2_at_least(c, 8) for sid, c in counts.items() if sid in (2, 3, 4)) + \
            ref_pow2_at_least(counts[5], ref_pow2_at_least(8))
    elif route == "host":
        pending = dispatch_signature_rows(full_rows, use_device=False)
        assert pending.collect().tolist() == want
        assert pending.device_rows == 0 and not pending.device_mask.any()
    else:
        sizes = [1024, 700, 512, 300, 256, 100, 64, 33, 8, 2, 1]
        sizes.append(len(full_rows) - sum(sizes))
        sched = DeviceScheduler(device="cpu")
        try:
            sched.pause()
            futures, at = [], 0
            for k, size in enumerate(sizes):
                futures.append((at, size, sched.submit_rows(
                    full_rows[at : at + size], priority=(BULK, SERVICE, INTERACTIVE)[k % 3])))
                at += size
            sched.resume()
            for at, size, fut in futures:
                rr = fut.result(timeout=600)
                assert rr.mask.tolist() == want[at : at + size]
                assert rr.n_device == int(on_device[at : at + size].sum())
            assert sched.counters["serving.rows"] == len(full_rows)
            assert sched.counters["serving.device_rows"] == len(full_rows) - counts[1]
            assert sched.counters["serving.padded_lanes"] >= len(full_rows) - counts[1]
        finally:
            sched.shutdown()


@pytest.mark.parametrize("min_bucket", [None, 4, 16, 64, 1024])
def test_sphincs_and_rsa_padding_follow_reference_rule(full_rows, min_bucket):
    """A batch of 20 SPHINCS rows, 3 RSA rows and 9 ed25519 rows: the
    SPHINCS bucket pads to the reference's floor, pow2(min(min_bucket or
    8, 32)); the RSA rows take no lanes."""
    sph = [r for r in full_rows if r[0].scheme_id == 5][:20]
    rsa_rows = [r for r in full_rows if r[0].scheme_id == 1][:3]
    ed = [r for r in full_rows if r[0].scheme_id == 4][:9]
    batch = sph[:10] + rsa_rows + ed + sph[10:]
    pending = dispatch_signature_rows(batch, min_bucket=min_bucket, device="cpu")
    assert len(pending._deferred) == 2 and pending.device_rows == 29
    assert pending.collect().tolist() == [is_valid(*r) for r in batch]
    assert pending.padded_lanes == ref_pow2_at_least(9, max(min_bucket or 0, 8)) + \
        ref_pow2_at_least(20, ref_pow2_at_least(min(min_bucket or 8, 32)))


def test_rsa_bucket_settles_after_device_buckets(full_rows, monkeypatch):
    """RSA rows first in the batch: every device bucket is enqueued before
    the host verifies the first RSA row, so that the host's work overlaps
    the kernels; the verdicts and the device rows are as before."""
    from corda_tpu_torch.verifier import batch as port_batch

    rsa_rows = [r for r in full_rows if r[0].scheme_id == 1][:4]
    rest = [next(r for r in full_rows if r[0].scheme_id == sid) for sid in (5, 4, 2, 3)]
    log = []
    dispatch, verify = port_batch._dispatch_bucket, port_batch.is_valid

    def logged_dispatch(scheme_id, *args):
        log.append(scheme_id)
        return dispatch(scheme_id, *args)

    def logged_verify(key, sig, msg):
        log.append(("host", key.scheme_id))
        return verify(key, sig, msg)

    monkeypatch.setattr(port_batch, "_dispatch_bucket", logged_dispatch)
    monkeypatch.setattr(port_batch, "is_valid", logged_verify)
    batch = rsa_rows + rest
    pending = dispatch_signature_rows(batch, device="cpu")
    assert log == [5, 4, 2, 3] + [("host", 1)] * 4
    assert pending.collect().tolist() == [verify(*r) for r in batch]
    assert pending.device_mask.tolist() == [False] * 4 + [True] * 4


# ----------------------------- a Cash move signed by SPHINCS and RSA keys


@pytest.fixture(scope="module")
def pq_cash():
    """A Cash issue to a party holding a SPHINCS key, two moves of its
    outputs to a party holding an RSA key (signed by both), one of them
    with its SPHINCS signature tampered, and a double spend of the first
    move's input."""
    import dataclasses
    import hashlib

    from corda_tpu_torch.crypto import KeyPair, PrivateKey, derive_keypair_from_entropy
    from corda_tpu_torch.crypto import rsa as port_rsa
    from corda_tpu_torch.finance import CASH_PROGRAM_ID, CashState, Issue, Move
    from corda_tpu_torch.ledger import (
        Amount,
        CordaX500Name,
        Issued,
        Party,
        PartyAndReference,
        PrivacySalt,
        TransactionBuilder,
    )
    from corda_tpu_torch.testing import _party

    skp = derive_keypair_from_entropy(5, hashlib.sha256(b"pq sphincs").digest())
    pub, priv = port_rsa.generate(random.Random(b"pq rsa"))
    rkp = KeyPair(PublicKey(1, pub), PrivateKey(1, priv))
    holder = Party(CordaX500Name("Hash Based Bank", "Zurich", "CH"), skp.public)
    payee = Party(CordaX500Name("Rsa Trust", "London", "GB"), rkp.public)
    notary, nkp = _party(b"Notary Service")
    token = Issued(PartyAndReference(holder, b"\x07"), "CHF")
    rng = random.Random(11)

    def builder():
        b = TransactionBuilder(notary=notary)
        b.set_privacy_salt(PrivacySalt(rng.randbytes(32)))
        return b

    b = builder()
    for i in range(3):
        b.add_output_state(CashState(Amount(100 + i, token), holder), CASH_PROGRAM_ID)
    b.add_command(Issue(), holder.owning_key)
    issue = b.sign_initial_transaction(skp)

    def move(i, owner):
        mb = builder()
        mb.add_input_state(issue.tx.out_ref(i))
        mb.add_output_state(CashState(Amount(100 + i, token), owner), CASH_PROGRAM_ID)
        mb.add_command(Move(), holder.owning_key, payee.owning_key)
        return mb.sign_initial_transaction(skp, rkp)

    valid, tampered, double = move(0, payee), move(1, payee), move(0, holder)
    bad = tampered.sigs[0]
    assert bad.by == skp.public
    bad = dataclasses.replace(bad, signature=bad.signature[:500] + bytes([bad.signature[500] ^ 1])
                              + bad.signature[501:])
    tampered = dataclasses.replace(tampered, sigs=[bad] + list(tampered.sigs[1:]))
    return issue, [valid, tampered, double], notary, nkp


def test_pq_cash_check_transactions_matches_reference(pq_cash):
    from corda_tpu.verifier.batch import check_transactions as ref_check
    from corda_tpu.serialization import deserialize as ref_deserialize
    from corda_tpu_torch.serialization import serialize
    from corda_tpu_torch.verifier import check_transactions

    issue, moves, notary, _nkp = pq_cash
    stxs = [issue] + moves
    allowed = [set()] + [{notary.owning_key}] * 3  # the notary signs after
    ref_allowed = [set()] + [{ref_deserialize(serialize(notary)).owning_key}] * 3
    got = check_transactions(stxs, allowed, device="cpu")
    want = ref_check([ref_deserialize(serialize(s)) for s in stxs], ref_allowed,
                     use_device=False)

    def shown(report):
        return [None if r is None else (type(r).__name__, str(r)) for r in report.results]

    assert shown(got) == shown(want)
    assert [r is None for r in got.results] == [True, True, False, True]
    assert got.n_sigs == want.n_sigs == 7
    assert got.n_device == 4  # the SPHINCS rows; the three RSA rows are host rows
    host = check_transactions(stxs, allowed, use_device=False)
    assert shown(host) == shown(want) and host.n_device == 0


def test_pq_cash_validating_notary_matches_reference(pq_cash):
    """One validating window: the valid move is signed, the tampered one
    rejected for its signature, the double spend of the first move's
    input answered with the conflict; the answers, conflicts and response
    signature bytes equal the reference notary's."""
    import corda_tpu.finance  # noqa: F401  (registers the reference's Cash contract)
    from corda_tpu.crypto.keys import KeyPair as RefKeyPair
    from corda_tpu.crypto.keys import PrivateKey as RefPrivateKey
    from corda_tpu.notary import BatchedNotaryService as RefNotary
    from corda_tpu.notary import PersistentUniquenessProvider as RefPersistent
    from corda_tpu.serialization import deserialize as ref_deserialize
    from corda_tpu_torch.notary import BatchedNotaryService, PersistentUniquenessProvider
    from corda_tpu_torch.serialization import deserialize, serialize
    from corda_tpu_torch.testing import outcome_kind, state_resolver

    now = 1_800_000_000.0
    issue, moves, notary, nkp = pq_cash
    port_resolve = state_resolver(deserialize(serialize(issue)).tx)
    ref_resolve = state_resolver(ref_deserialize(serialize(issue)).tx)
    port_reqs = [(deserialize(serialize(s)), port_resolve, "holder") for s in moves]
    ref_reqs = [(ref_deserialize(serialize(s)), ref_resolve, "holder") for s in moves]
    got = BatchedNotaryService(notary, nkp, PersistentUniquenessProvider(), max_batch=16,
                               clock=lambda: now, device="cpu").process_batch(port_reqs)
    ref_identity = ref_deserialize(serialize(notary))
    ref_kp = RefKeyPair(ref_identity.owning_key, RefPrivateKey(4, nkp.private.encoded))
    want = RefNotary(ref_identity, ref_kp, RefPersistent(), use_device=False, validating=True,
                     max_batch=16, clock=lambda: now).process_batch(ref_reqs)
    kinds = [outcome_kind(r) for r in got]
    assert kinds == [outcome_kind(r) for r in want] == ["signed", "invalid_signature",
                                                        "conflict"]
    assert got[0].signature == want[0].signature and got[0].by.encoded == want[0].by.encoded
    for g, w in zip(got[1:], want[1:]):
        assert (type(g).__name__, str(g)) == (type(w).__name__, str(w))
    gc, wc = got[2].conflict, want[2].conflict
    assert sorted((r.txhash.bytes, r.index, d.consuming_tx.bytes, d.input_index)
                  for r, d in gc.state_history.items()) == \
        sorted((r.txhash.bytes, r.index, d.consuming_tx.bytes, d.input_index)
               for r, d in wc.state_history.items())
