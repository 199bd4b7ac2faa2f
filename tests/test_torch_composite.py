"""Composite keys (scheme 6): the port's ``crypto/composite.py`` and the
scheme's place in the registry, the dispatch, the scheduler and the
transaction check, against the reference's on the same trees and the same
signature sets. Builder output and the wire form are byte-equal; every
validation error, ``expand_signers`` set, ``verify_composite`` and
``is_fulfilled_by`` verdict and every raised exception type is equal,
malformed encodings included."""

import pytest
import torch

pytest.importorskip("cryptography")  # the reference's ECDSA oracle is OpenSSL

import corda_tpu.finance  # noqa: F401  (registers the reference's Cash contract)
from corda_tpu import crypto as ref_crypto
from corda_tpu.crypto import composite as ref_composite
from corda_tpu.serialization import deserialize as ref_deserialize
from corda_tpu.serialization import encode as ref_encode
from corda_tpu.serving import DeviceScheduler as RefScheduler
from corda_tpu.verifier.batch import check_transactions as ref_check
from corda_tpu.verifier.batch import dispatch_signature_rows as ref_dispatch
from corda_tpu_torch import crypto
from corda_tpu_torch.crypto import composite
from corda_tpu_torch.serialization import serialize
from corda_tpu_torch.serving import DeviceScheduler
from corda_tpu_torch.testing.service_stream import service_outcome, service_stream
from corda_tpu_torch.verifier import check_transactions, dispatch_signature_rows


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
def leaves():
    """Five keypairs of the port: three ed25519, two secp256k1."""
    return ([crypto.derive_keypair_from_entropy(4, b"composite-ed%d" % i) for i in range(3)]
            + [crypto.derive_keypair_from_entropy(2, b"composite-k1%d" % i) for i in range(2)])


def ref_key(key):
    return ref_crypto.PublicKey(key.scheme_id, key.encoded)


# each tree: (threshold or None for AND, [(leaf index or subtree, weight)])
TREES = {
    "and": (None, [(0, 1), (3, 1)]),
    "or": (1, [(0, 1), (1, 1)]),
    "two_of_three": (2, [(0, 1), (1, 1), (3, 1)]),
    "weighted": (3, [(0, 2), (1, 1), (4, 1)]),
    "nested": (3, [(2, 2), ((1, [(1, 1), (4, 1)]), 1), (0, 1)]),
}


def build(tree, keys, mod):
    threshold, children = tree
    b = mod.CompositeKeyBuilder()
    for child, weight in children:
        b.add(build(child, keys, mod) if isinstance(child, tuple) else keys[child], weight)
    return b.build(threshold)


@pytest.fixture(scope="module")
def trees(leaves):
    port_keys = [kp.public for kp in leaves]
    ref_keys = [ref_key(k) for k in port_keys]
    return {name: (build(t, port_keys, composite), build(t, ref_keys, ref_composite))
            for name, t in TREES.items()}


def test_builder_and_wire_form_match_reference(trees):
    for name, (port, ref) in trees.items():
        pk, ref_pk = port.to_public_key(), ref.to_public_key()
        assert (pk.scheme_id, pk.encoded) == (ref_pk.scheme_id, ref_pk.encoded), name
        assert port.threshold == ref.threshold
        back = composite.CompositeKey.from_public_key(pk)
        assert back == port
        assert ref_composite.CompositeKey.from_public_key(ref_pk) == ref


def test_expand_signers_matches_reference(trees, leaves):
    for name, (port, ref) in trees.items():
        got = {(k.scheme_id, k.encoded) for k in composite.expand_signers(port.to_public_key())}
        want = {(k.scheme_id, k.encoded)
                for k in ref_composite.expand_signers(ref.to_public_key())}
        assert got == want, name
    plain = leaves[0].public
    assert composite.expand_signers(plain) == {plain}


@pytest.mark.parametrize("children,threshold", [
    ([], None),                                  # no children
    ([(0, 0)], 1),                               # weight 0
    ([(0, 1), (0, 1)], 1),                       # a duplicate leaf
    ([(0, 1), (1, 1)], 3),                       # threshold above the total
    ([(0, 1), (1, 1)], 0),                       # threshold 0
], ids=["empty", "zero-weight", "duplicate", "threshold-high", "threshold-zero"])
def test_invalid_trees_raise_as_in_reference(leaves, children, threshold):
    keys = [kp.public for kp in leaves]
    b, rb = composite.CompositeKeyBuilder(), ref_composite.CompositeKeyBuilder()
    for i, w in children:
        b.add(keys[i], w)
        rb.add(ref_key(keys[i]), w)
    with pytest.raises(crypto.CryptoError):
        b.build(threshold)
    with pytest.raises(ref_crypto.CryptoError):
        rb.build(threshold)


def malformed_encodings(trees):
    good = trees["and"][0].to_public_key().encoded
    return [
        b"",
        b"\x00",
        good[:-3],
        good + b"\x00",
        ref_encode({"threshold": 1}),
        ref_encode({"threshold": 1, "children": [{"weight": 1}]}),
        ref_encode({"threshold": 5, "children": [{"weight": 1, "composite": False,
                                                  "key": {"scheme_id": 4, "encoded": b"k"}}]}),
        ref_encode({"threshold": 1, "children": []}),
        ref_encode([1, 2, 3]),
    ]


def test_malformed_encodings_raise_as_in_reference(trees, leaves):
    signers = {kp.public for kp in leaves}
    for enc in malformed_encodings(trees):
        with pytest.raises(crypto.CryptoError):
            composite.CompositeKey.from_public_key(crypto.PublicKey(6, enc))
        with pytest.raises(ref_crypto.CryptoError):
            ref_composite.CompositeKey.from_public_key(ref_crypto.PublicKey(6, enc))
        assert composite.is_fulfilled_by(crypto.PublicKey(6, enc), signers) is False
        assert ref_composite.is_fulfilled_by(
            ref_crypto.PublicKey(6, enc), {ref_key(k) for k in signers}) is False
    with pytest.raises(crypto.CryptoError):
        composite.CompositeKey.from_public_key(leaves[0].public)
    with pytest.raises(ref_crypto.CryptoError):
        ref_composite.CompositeKey.from_public_key(ref_key(leaves[0].public))


def signature_sets(trees, leaves, data):
    """(tree name, [(signer, signature)]) over every subset of leaves that
    the tests cover, plus a forged signature and a composite key listed as
    an individual signer."""
    sigs = {kp.public: crypto.sign(kp.private, data) for kp in leaves}
    keys = [kp.public for kp in leaves]
    subsets = [[0], [3], [0, 3], [0, 1], [1, 4], [0, 1, 4], [2, 1], [2, 4], [2, 0],
               [0, 1, 2, 3, 4], []]
    out = []
    for name in trees:
        for sub in subsets:
            out.append((name, [(keys[i], sigs[keys[i]]) for i in sub]))
        forged = bytearray(sigs[keys[0]])
        forged[5] ^= 1
        out.append((name, [(keys[0], bytes(forged)), (keys[3], sigs[keys[3]])]))
        out.append((name, [(trees["or"][0].to_public_key(), sigs[keys[0]])]))
    return out


def test_verify_composite_matches_reference(trees, leaves):
    data = b"composite payload"
    for name, sigset in signature_sets(trees, leaves, data):
        port_key = trees[name][0].to_public_key()
        got = composite.verify_composite(port_key, sigset, data)
        want = ref_composite.verify_composite(
            ref_key(port_key), [(ref_key(k), s) for k, s in sigset], data)
        assert got == want, (name, [k.scheme_id for k, _s in sigset])
        signers = {k for k, _s in sigset}
        assert composite.is_fulfilled_by(port_key, signers) == ref_composite.is_fulfilled_by(
            ref_key(port_key), {ref_key(k) for k in signers})


def test_scheme_six_in_the_registry_as_in_reference(trees, leaves):
    """``is_valid`` raises ``CryptoError`` (composite keys verify signature
    sets), key validation answers False, and signing, generating and
    deriving raise, in both packages."""
    pk = trees["and"][0].to_public_key()
    with pytest.raises(crypto.CryptoError, match="signature"):
        crypto.is_valid(pk, b"s", b"m")
    with pytest.raises(ref_crypto.CryptoError, match="signature"):
        ref_crypto.is_valid(ref_key(pk), b"s", b"m")
    assert crypto.public_key_on_curve(pk) is ref_crypto.public_key_on_curve(ref_key(pk)) is False
    for unknown in (crypto.PublicKey(99, b"x"),):
        assert crypto.public_key_on_curve(unknown) is ref_crypto.public_key_on_curve(
            ref_key(unknown)) is False
        with pytest.raises(crypto.CryptoError):
            crypto.is_valid(unknown, b"s", b"m")
        with pytest.raises(ref_crypto.CryptoError):
            ref_crypto.is_valid(ref_key(unknown), b"s", b"m")
    for port_call, ref_call in (
        (lambda: crypto.sign(crypto.PrivateKey(6, b"x"), b"m"),
         lambda: ref_crypto.sign(ref_crypto.PrivateKey(6, b"x"), b"m")),
        (lambda: crypto.generate_keypair(6), lambda: ref_crypto.generate_keypair(6)),
        (lambda: crypto.derive_keypair_from_entropy(6, b"e"),
         lambda: ref_crypto.derive_keypair_from_entropy(6, b"e")),
    ):
        with pytest.raises(crypto.CryptoError):
            port_call()
        with pytest.raises(ref_crypto.CryptoError):
            ref_call()


def test_composite_row_raises_out_of_the_dispatch_as_in_reference(trees, leaves):
    """A composite key as a row: ``dispatch_signature_rows`` raises the
    ``CryptoError`` of ``is_valid`` on each route, as the reference's host
    bucket does; the scheduler fails that request's future with it and
    serves the request beside it, as the reference's does."""
    kp = leaves[0]
    good = [(kp.public, crypto.sign(kp.private, b"m%d" % i), b"m%d" % i) for i in range(3)]
    bad = good + [(trees["and"][0].to_public_key(), b"\x00" * 64, b"m")]
    ref_bad = [(ref_key(k), s, m) for k, s, m in bad]
    for kw in ({"device": "cpu"}, {"use_device": False}):
        with pytest.raises(crypto.CryptoError):
            dispatch_signature_rows(bad, **kw)
    with pytest.raises(ref_crypto.CryptoError):
        ref_dispatch(ref_bad, use_device=False)
    sched = DeviceScheduler(device="cpu")
    ref_sched = RefScheduler()
    try:
        ok, refused = sched.submit_rows(good), sched.submit_rows(bad)
        ref_ok = ref_sched.submit_rows([(ref_key(k), s, m) for k, s, m in good],
                                       use_device=False)
        ref_refused = ref_sched.submit_rows(ref_bad, use_device=False)
        assert type(refused.exception(timeout=60)).__name__ == \
            type(ref_refused.exception(timeout=60)).__name__ == "CryptoError"
        assert ok.result(timeout=60).mask.tolist() == \
            ref_ok.result(timeout=60).mask.tolist() == [True] * 3
    finally:
        sched.shutdown()
        ref_sched.shutdown()


def test_composite_owned_transactions_match_reference():
    """Composite-owned Cash moves (AND, 2-of-3, a nested weighted tree over
    ed25519 and secp256k1 leaves), a threshold short by one and a forged
    leaf, through ``check_transactions`` on the port's device route
    (``device="cpu"``) and host route against the reference's host route:
    the same outcome, error and failing key set, transaction for
    transaction."""
    st = service_stream(24, seed=5, device="cpu", sphincs=0, bls=1, attachments=0)
    keep = [i for i, k in enumerate(st.kinds)
            if k.startswith("composite_") and k != "composite_as_signer"
            or k in ("forged_leaf_signature", "ed25519")]
    stxs = [st.stxs[i] for i in keep]
    allowed = [st.allowed[i] for i in keep]
    ref_stxs = [ref_deserialize(serialize(s)) for s in stxs]
    ref_allowed = [{ref_key(k) for k in a} for a in allowed]
    want = [service_outcome(r) for r in ref_check(ref_stxs, ref_allowed,
                                                  use_device=False).results]
    for kw in ({"device": "cpu"}, {"use_device": False}):
        got = [service_outcome(r) for r in check_transactions(stxs, allowed, **kw).results]
        assert got == want, kw
    assert want == [st.expected[i] for i in keep]
    assert {st.kinds[i] for i in keep} >= {"composite_and", "composite_2of3",
                                           "composite_nested", "composite_threshold_short",
                                           "forged_leaf_signature"}
