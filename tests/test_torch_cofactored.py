"""Full ed25519 buckets under the reference's cofactored rule, the port's
against the reference's on the same rows (tolerance zero: verdicts are
exact).

The reference settles an ed25519 bucket that fills ``min_bucket`` through
its RLC route (corda_tpu/verifier/batch.py:229-237, batchverify/rlc.py):
cofactored, small-order A and R rejected; ``CORDA_TPU_BATCH_RLC=0`` and
partial buckets keep the cofactorless rule. The port keeps full buckets on
kernels B and G with a cofactored end and takes ``batch_rlc`` where the
reference reads its environment. Held here:

- the 8 small-order encodings: the port's equal the reference's, they are
  the only encodings that decode to a small-order point once y >= p and
  x = 0 with the sign bit are rejected, and the cofactored precheck
  rejects each as A and as R;
- the kernels' cofactored end (``hc_verify_rule``, ``hc_g_verify_rule``:
  the quad ladder's C++ on the host) and both plain versions, for both
  fixed-base shapes, against the reference's ``rlc.verify_single``, and
  their cofactorless end against the oracle;
- ``dispatch_signature_rows`` with the switch on, off and on a partial
  bucket, on every tier and on the host route, against the reference's;
- one notary window of ``max_batch`` requests holding rows on which the
  two rules differ, against the reference notary on its device tier (its
  RLC route; ids and signing on its host).

The rows: every kind of ``testing.adversarial_lanes`` (small_order_a_identity
and mixed_order_reject among them), the 8 small-order encodings as A and
as R, an R of small order that the cofactorless rule accepts, and honest
rows."""

import dataclasses

import numpy as np
import pytest
import torch

from corda_tpu.batchverify import rlc as ref_rlc
from corda_tpu.crypto.keys import KeyPair as RefKeyPair
from corda_tpu.crypto.keys import PrivateKey as RefPrivateKey
from corda_tpu.crypto.keys import PublicKey as RefPublicKey
from corda_tpu.notary import BatchedNotaryService as RefNotary
from corda_tpu.notary import PersistentUniquenessProvider as RefPersistent
from corda_tpu.serialization import deserialize as ref_deserialize
from corda_tpu.serving import shutdown_scheduler as ref_shutdown_scheduler
from corda_tpu.verifier.batch import dispatch_signature_rows as ref_dispatch
from corda_tpu_torch.batchverify import rlc
from corda_tpu_torch.crypto import (
    CURRENT_PLATFORM_VERSION,
    EDDSA_ED25519_SHA512,
    PublicKey,
    SignableData,
    SignatureMetadata,
    TransactionSignature,
    ed25519_host,
)
from corda_tpu_torch.crypto.ed25519_host import BASE, P, compress, point_add, scalar_mul
from corda_tpu_torch.notary import BatchedNotaryService, PersistentUniquenessProvider
from corda_tpu_torch.ops import _build
from corda_tpu_torch.ops import ed25519 as port_ed
from corda_tpu_torch.ops import ed25519_ladder as b
from corda_tpu_torch.ops import ed25519_ladder4096 as g
from corda_tpu_torch.ops.ed25519 import Ed25519Tier
from corda_tpu_torch.ops.scalar25519 import challenge_windows_plain
from corda_tpu_torch.serialization import deserialize, serialize
from corda_tpu_torch.serving import shutdown_scheduler
from corda_tpu_torch.testing import (
    _sign_with,
    adversarial_lanes,
    cofactored_lanes,
    notary_stream,
    outcome_kind,
    signed_triples,
    small_r_signature,
    torsion_point8,
)
from corda_tpu_torch.verifier import dispatch_signature_rows

TIERS = [Ed25519Tier(), Ed25519Tier(8192, 4), Ed25519Tier(4096, 8), Ed25519Tier(4096, 4)]
NOW = 1_800_000_000.0


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
def triples():
    lanes = adversarial_lanes(0) + cofactored_lanes(0)
    return [(pk, s, m) for _k, pk, s, m in lanes] + signed_triples(3, seed=5)


def test_small_order_encodings_are_the_only_ones(triples):
    """The port's 8 encodings equal the reference's; every 32-byte string
    that decodes to one of the 8 points, once y >= p and x = 0 with the
    sign bit are rejected, is one of them; the cofactored precheck rejects
    each as A and as R, the cofactorless one does not look."""
    encs = rlc.small_order_encodings()
    assert encs == ref_rlc.small_order_encodings()
    assert len(set(encs)) == 8
    points = {ed25519_host.decompress(e)[:2] for e in encs}
    assert len(points) == 8
    for x, y in points:
        for y_enc in (y, y + P):
            for sign in (0, 1):
                if y_enc >= 1 << 255:
                    continue
                enc = (y_enc | (sign << 255)).to_bytes(32, "little")
                pt = ed25519_host.decompress(enc)
                if pt is None or y_enc >= P:
                    continue  # rejected: y >= p, or x = 0 with the sign bit
                if pt[:2] == (x, y):
                    assert enc in encs
    pk, sig, _msg = triples[-1]
    pks = [e for e in encs] + [pk] * 8
    sigs = [sig] * 8 + [e + sig[32:] for e in encs]
    pk_arr, sig_arr, ok = port_ed._gather_fixed(pks, sigs, 16)
    assert not port_ed._canonical_precheck(pk_arr, sig_arr, ok, cofactored=True)[3].any()
    assert port_ed._canonical_precheck(pk_arr, sig_arr, ok)[3].all()


def packed_plane(rows, cofactored):
    pks, sigs, msgs = map(list, zip(*rows))
    pk_arr, sig_arr, ok = port_ed._gather_fixed(pks, sigs, len(pks))
    _y, _s, s_arr, pre = port_ed._canonical_precheck(pk_arr, sig_arr, ok, cofactored)
    plane = np.zeros((len(pks), 161), np.uint8)
    port_ed.pack_rows(plane, sig_arr, pk_arr, s_arr, pre, msgs)
    return plane


@pytest.fixture(scope="module")
def oracles(triples):
    cof = [ref_rlc.verify_single(*t) for t in triples]
    assert cof == [rlc.verify_single(*t) for t in triples]
    plain = [ed25519_host.verify(*t) for t in triples]
    differ = [i for i, (c, p) in enumerate(zip(cof, plain)) if c != p]
    assert len(differ) >= 3  # identity A, mixed order, the small R
    return {True: cof, False: plain}


@pytest.mark.parametrize("radix,fixed_win", [(8192, 8), (8192, 4), (4096, 8), (4096, 4)],
                         ids=["B8", "B4", "G8", "G4"])
@pytest.mark.parametrize("cofactored", [True, False], ids=["cofactored", "cofactorless"])
def test_kernel_end_matches_reference(triples, oracles, radix, fixed_win, cofactored):
    """The quad lane (the kernel's own C++) and the plain version: the
    cofactored end equals the reference's ``verify_single`` row by row, the
    cofactorless end the oracle."""
    plane = packed_plane(triples, cofactored)
    packed = torch.from_numpy(plane)
    win = challenge_windows_plain(packed)
    hc = _build.host_check()
    if radix == 8192:
        table, lane, plain = b.build_table(), hc.hc_verify_rule, b.verify_ladder_plain
    else:
        table, lane, plain = g.build_table(), hc.hc_g_verify_rule, g.verify_plain_g
    win_np = win.numpy()
    got = [bool(lane(plane[i].tobytes(), np.ascontiguousarray(win_np[:, i]).ctypes.data,
                     table.ctypes.data, fixed_win, int(cofactored)))
           for i in range(len(triples))]
    assert got == oracles[cofactored]
    got = plain(packed, win, torch.from_numpy(table), fixed_win, cofactored).tolist()
    assert got == oracles[cofactored]


def port_rows(triples):
    return [(PublicKey(4, pk), s, m) for pk, s, m in triples]


def ref_rows(triples):
    return [(RefPublicKey(4, pk), s, m) for pk, s, m in triples]


@pytest.mark.parametrize("tier", TIERS, ids=lambda t: f"{t.radix}-{t.fixed_win}")
@pytest.mark.parametrize("case", ["rlc_on", "rlc_off", "partial"])
def test_dispatch_matches_reference(triples, oracles, monkeypatch, tier, case):
    """A bucket of ``min_bucket`` rows (the switch on and off) and a
    partial one: the port's mask on ``device="cpu"`` (the plain versions)
    and on its host route equals the reference's. The reference's RLC
    route runs on its host whatever ``use_device`` says; its partial and
    switched-off buckets are settled by its host oracle, which its own
    tests hold equal to its device tier."""
    n = len(triples)
    min_bucket = n + 1 if case == "partial" else n
    batch_rlc = case != "rlc_off"
    if not batch_rlc:
        monkeypatch.setenv("CORDA_TPU_BATCH_RLC", "0")
    want = ref_dispatch(ref_rows(triples), use_device=False, min_bucket=min_bucket).collect()
    assert want.tolist() == oracles[case == "rlc_on"]
    rows = port_rows(triples)
    got = dispatch_signature_rows(rows, min_bucket=min_bucket, device="cpu", tier=tier,
                                  batch_rlc=batch_rlc).collect()
    assert got.tolist() == want.tolist()
    if tier == Ed25519Tier():
        host = dispatch_signature_rows(rows, use_device=False, min_bucket=min_bucket,
                                       batch_rlc=batch_rlc).collect()
        assert host.tolist() == want.tolist()


# ------------------------------------------------------------ the notary


def _extra_signature(stx, seed_or_key, kind):
    """``stx`` with one more signature over its id, by a key that is not
    required: ``small_r`` signs with R of small order (the cofactorless rule
    accepts, the cofactored one rejects); ``mixed`` with a mixed-order key
    and h not 0 mod 8 (the cofactored rule accepts, the cofactorless one
    rejects)."""
    meta = SignatureMetadata(CURRENT_PLATFORM_VERSION, EDDSA_ED25519_SHA512)
    payload = SignableData(stx.id, meta).to_bytes()
    if kind == "small_r":
        pub, sig, _m = small_r_signature(seed_or_key, payload)
    else:
        a = seed_or_key
        pub = compress(point_add(scalar_mul(a, BASE), torsion_point8()))
        r = 1
        while True:
            sig, h = _sign_with(a, pub, payload, r)
            if h % 8:
                break
            r += 1
    extra = TransactionSignature(sig, PublicKey(4, pub), meta)
    assert (rlc.verify_single(pub, sig, payload), ed25519_host.verify(pub, sig, payload)) == \
        ((False, True) if kind == "small_r" else (True, False))
    return dataclasses.replace(stx, sigs=stx.sigs + (extra,))


@pytest.fixture(scope="module")
def window():
    """16 requests (the notaries' max_batch): moves signed by Alice and the
    stream's in-window double spend, two of the moves carrying an extra
    signature on which the two rules differ."""
    stream = notary_stream(18, 16, seed=6, device="cpu")
    reqs = list(stream.windows[0])
    assert len(reqs) == 16 and stream.kinds[0][3] == stream.kinds[0][9] == "signed"
    reqs[3] = _extra_signature(reqs[3], bytes([7]) * 32, "small_r")
    reqs[9] = _extra_signature(reqs[9], 123456789, "mixed")
    return stream, reqs


@pytest.mark.parametrize("route", ["direct", "scheduler"])
def test_notary_window_matches_reference(window, monkeypatch, route):
    """A window of max_batch requests gets the reference notary's answers
    on its device tier, signature bytes included. Dispatched directly, the
    signature check pins its pad bucket to max_batch, so the bucket is
    full and takes the RLC rule: the small-R request is rejected, the
    mixed-order one signed. Through the scheduler, max_batch is a floor
    under the scheduler's smallest bucket, which the window does not fill:
    the cofactorless rule, the other way round."""
    monkeypatch.setenv("CORDA_TPU_IDS", "host")
    stream, reqs = window
    resolve = None
    port = BatchedNotaryService(
        stream.notary, stream.notary_keypair, PersistentUniquenessProvider(),
        validating=False, max_batch=16, clock=lambda: NOW, device="cpu",
        use_scheduler=route == "scheduler")
    identity = ref_deserialize(serialize(stream.notary))
    keypair = RefKeyPair(identity.owning_key, RefPrivateKey(
        4, stream.notary_keypair.private.encoded))
    ref = RefNotary(identity, keypair, RefPersistent(), use_device=True,
                    use_scheduler=route == "scheduler", validating=False, max_batch=16,
                    clock=lambda: NOW)
    try:
        got = port.process_batch([(deserialize(serialize(s)), resolve, "alice") for s in reqs])
        want = ref.process_batch([(ref_deserialize(serialize(s)), resolve, "alice")
                                  for s in reqs])
    finally:
        shutdown_scheduler()
        ref_shutdown_scheduler()
    kinds = [outcome_kind(r) for r in want]
    if route == "direct":
        assert kinds[3] == "invalid_signature" and kinds[9] == "signed"
    else:
        # the scheduler pads 18 rows to its smallest bucket, 128: partial
        assert kinds[3] == "signed" and kinds[9] == "invalid_signature"
    assert [outcome_kind(r) for r in got] == kinds
    for gr, wr in zip(got, want):
        if outcome_kind(gr) == "signed":
            assert gr.signature == wr.signature
        else:
            assert (type(gr).__name__, str(gr)) == (type(wr).__name__, str(wr))
