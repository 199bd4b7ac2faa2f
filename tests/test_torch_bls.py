"""BLS12-381 (scheme 7) and quorum certificates: the port's
``batchverify/bls.py``, ``batchverify/qc.py`` and ``crypto/schemes.py``
against the reference's on the same inputs. Keys derived from the same
entropy, signatures and aggregates are byte-equal; every verdict
(verify, ``fast_aggregate_verify`` with and without proof-of-possession,
with a rogue key, decompression of garbage, key validation) and every
certificate's encoding, decoding and verdict are equal. A pairing costs
about a quarter of a second here, so a handful of keys is cached for the
module."""

import pytest

from corda_tpu import crypto as ref_crypto
from corda_tpu.batchverify import bls as ref_bls
from corda_tpu.batchverify import qc as ref_qc
from corda_tpu.serialization import serialize as ref_serialize
from corda_tpu_torch import crypto
from corda_tpu_torch.batchverify import QCError, QuorumCertificate, bls, decode_attestation
from corda_tpu_torch.serialization import serialize

MSG = b"quorum-outcome"


@pytest.fixture(scope="module")
def members():
    """Four (public, private) pairs, derived in the port; the reference
    derives the same bytes (test_keys_match_reference)."""
    return [bls.derive_keypair_from_entropy(b"torch-bls-%d" % i) for i in range(4)]


@pytest.fixture(scope="module")
def shares(members):
    return [bls.sign(sk, MSG) for _pk, sk in members]


def test_keys_match_reference(members):
    for i, (pk, sk) in enumerate(members):
        assert (pk, sk) == ref_bls.derive_keypair_from_entropy(b"torch-bls-%d" % i)
        assert bls.public_key(sk) == ref_bls.public_key(sk) == pk
    kp = crypto.derive_keypair_from_entropy(crypto.BLS_BLS12381, b"scheme7")
    ref = ref_crypto.derive_keypair_from_entropy(ref_crypto.BLS_BLS12381, b"scheme7")
    assert (kp.public.encoded, kp.private.encoded) == (ref.public.encoded, ref.private.encoded)
    child = crypto.derive_keypair(kp.private, b"child")
    ref_child = ref_crypto.derive_keypair(ref.private, b"child")
    assert child.public.encoded == ref_child.public.encoded


def test_signatures_match_reference(members, shares):
    for (_pk, sk), sig in zip(members, shares):
        assert sig == ref_bls.sign(sk, MSG)
    _pk, sk = members[0]
    assert bls.sign(sk, b"", dst=bls.DST_POP) == ref_bls.sign(sk, b"", dst=ref_bls.DST_POP)
    kp = crypto.derive_keypair_from_entropy(crypto.BLS_BLS12381, b"scheme7")
    ref = ref_crypto.derive_keypair_from_entropy(ref_crypto.BLS_BLS12381, b"scheme7")
    assert crypto.sign(kp.private, b"payload") == ref_crypto.sign(ref.private, b"payload")
    for bad in (b"\x00" * 32, b"\x01" * 31):
        with pytest.raises(bls.BLSError):
            bls.sign(bad, MSG)
        with pytest.raises(ref_bls.BLSError):
            ref_bls.sign(bad, MSG)


def test_verify_matches_reference(members, shares):
    (pk, _sk), (pk2, _sk2) = members[0], members[1]
    sig = shares[0]
    cases = [
        (pk, MSG, sig),                          # valid
        (pk, b"other", sig),                     # wrong message
        (pk2, MSG, sig),                         # wrong key
        (pk, MSG, b"\x00" * 96),                 # garbage signature
        (pk, MSG, bytes([0xC0]) + bytes(95)),    # the point at infinity
        (bytes([0xC0]) + bytes(47), MSG, sig),   # the identity as a key
        (pk[:47], MSG, sig),                     # truncated key
    ]
    got = [bls.verify(*c) for c in cases]
    assert got == [ref_bls.verify(*c) for c in cases]
    assert got == [True] + [False] * (len(cases) - 1)


def test_scheme_seven_through_the_registry(members, shares):
    """``is_valid``, ``public_key_on_curve`` and the scheme's registry
    entry as the reference's, garbage included."""
    pk, _sk = members[0]
    keys = [pk, b"\x01" * 48, bytes([0xC0]) + bytes(47), pk[:40], b""]
    for enc in keys:
        assert crypto.public_key_on_curve(crypto.PublicKey(7, enc)) == \
            ref_crypto.public_key_on_curve(ref_crypto.PublicKey(7, enc))
    rows = [(pk, shares[0], MSG), (pk, shares[0], b"x"), (pk, b"short", MSG),
            (b"\x01" * 48, shares[0], MSG)]
    got = [crypto.is_valid(crypto.PublicKey(7, k), s, m) for k, s, m in rows]
    assert got == [ref_crypto.is_valid(ref_crypto.PublicKey(7, k), s, m) for k, s, m in rows]
    assert got == [True, False, False, False]
    scheme = crypto.find_scheme(crypto.BLS_BLS12381)
    assert (scheme.code_name, scheme.algorithm) == ("BLS_BLS12381", "BLSwithBLS12381")
    a, b = crypto.generate_keypair(7), crypto.generate_keypair(7)
    assert a.public != b.public and len(a.public.encoded) == 48


def test_compression_round_trips_and_garbage(members, shares):
    pk, _sk = members[0]
    assert bls.g1_compress(bls.g1_decompress(pk)) == pk
    assert bls.g2_compress(bls.g2_decompress(shares[0])) == shares[0]
    garbage_g1 = [bytes([pk[0] & 0x7F]) + pk[1:], pk[:47], b"\xff" * 48,
                  bytes([0xC0]) + bytes(46) + b"\x01"]
    garbage_g2 = [b"\xff" * 96, shares[0][:95], bytes([shares[0][0] & 0x7F]) + shares[0][1:]]
    for port_fn, ref_fn, blobs in ((bls.g1_decompress, ref_bls.g1_decompress, garbage_g1),
                                   (bls.g2_decompress, ref_bls.g2_decompress, garbage_g2)):
        for blob in blobs:
            with pytest.raises(bls.BLSError):
                port_fn(blob)
            with pytest.raises(ref_bls.BLSError):
                ref_fn(blob)


def test_aggregate_and_proof_of_possession_match_reference(members, shares):
    pks = [pk for pk, _sk in members]
    agg = bls.aggregate(shares[:3])
    assert agg == ref_bls.aggregate(shares[:3])
    for pk, sk in members[:3]:
        pop = bls.prove_possession(sk)
        assert pop == ref_bls.prove_possession(sk)
        assert bls.register_pop(pk, pop) and ref_bls.register_pop(pk, pop)
    # the fourth key never proves possession: with the default gate a
    # subset holding it is refused, without the gate it verifies
    agg4 = bls.aggregate(shares)
    cases = [
        (pks[:3], MSG, agg, {}),
        (pks[:2], MSG, agg, {}),
        (pks[:3], b"other", agg, {}),
        (pks, MSG, agg4, {}),
        (pks, MSG, agg4, {"require_pop": False}),
        ([], MSG, agg, {}),
    ]
    got = [bls.fast_aggregate_verify(p, m, s, **kw) for p, m, s, kw in cases]
    assert got == [ref_bls.fast_aggregate_verify(p, m, s, **kw) for p, m, s, kw in cases]
    assert got == [True, False, False, False, True, False]
    # possession proofs do not transfer between keys
    assert not bls.verify_possession(pks[3], bls.prove_possession(members[0][1]))
    with pytest.raises(bls.BLSError):
        bls.aggregate([])


def test_rogue_key_is_refused_as_in_the_reference(members):
    """A rogue key chosen so that the subset's sum is the attacker's own key
    lets the attacker alone forge an aggregate for the subset; the gate
    refuses it unless the caller waives proof of possession."""
    (victim, _sk), (attacker, attacker_sk) = members[0], members[1]
    rogue = bls.g1_compress(bls._jac_add(bls.g1_decompress(attacker),
                                         bls._jac_neg(bls.g1_decompress(victim), bls._F1),
                                         bls._F1))
    forged = bls.sign(attacker_sk, b"rogue-round")
    for kw in ({}, {"require_pop": False}):
        got = bls.fast_aggregate_verify([victim, rogue], b"rogue-round", forged, **kw)
        assert got == ref_bls.fast_aggregate_verify([victim, rogue], b"rogue-round", forged,
                                                    **kw)
        assert got is bool(kw)
    assert not bls.register_pop(rogue, bls.prove_possession(attacker_sk))


def test_quorum_certificate_matches_reference(members, shares):
    pks = [pk for pk, _sk in members]
    agg = bls.aggregate([shares[i] for i in (0, 2, 3)])
    qc = QuorumCertificate(message=MSG, agg_sig=agg, bitmap=0b1101, n=4)
    ref = ref_qc.QuorumCertificate(message=MSG, agg_sig=agg, bitmap=0b1101, n=4)
    blob = qc.encode()
    assert blob == ref.encode()
    back = decode_attestation(blob)
    assert isinstance(back, QuorumCertificate) and back == qc
    assert (back.signers(), back.signer_count()) == (ref.signers(), ref.signer_count())
    for bls_mod in (bls, ref_bls):  # the gate of each package's registry
        for i in (0, 2, 3):
            assert bls_mod.register_pop(pks[i], bls_mod.prove_possession(members[i][1]))
    for keys in (pks, pks[:3], list(reversed(pks))):
        assert back.verify(keys) == ref_qc.decode_attestation(blob).verify(keys)
    assert back.verify(pks)
    legacy = {"replica-0": b"sig-bytes", "replica-1": b"more-bytes"}
    assert serialize(legacy) == ref_serialize(legacy)
    assert decode_attestation(serialize(legacy)) == legacy


@pytest.mark.parametrize("make", [
    lambda b: b"XXX" + b[3:],                  # magic
    lambda b: b[:3] + b"\x09" + b[4:],         # version
    lambda b: b[:-1],                          # truncated
    lambda b: b[:4],                           # no member count
], ids=["magic", "version", "truncated", "short"])
def test_malformed_certificates_reject_as_in_reference(shares, make):
    blob = QuorumCertificate(message=MSG, agg_sig=bls.aggregate(shares[:2]),
                             bitmap=0b11, n=2).encode()
    with pytest.raises(QCError):
        QuorumCertificate.decode(make(blob))
    with pytest.raises(ref_qc.QCError):
        ref_qc.QuorumCertificate.decode(make(blob))


@pytest.mark.parametrize("fields", [
    {"agg_sig": b"\x00" * 96, "bitmap": 0, "n": 4},
    {"agg_sig": b"\x00" * 96, "bitmap": 1 << 4, "n": 4},
    {"agg_sig": b"\x00" * 95, "bitmap": 1, "n": 4},
    {"agg_sig": b"\x00" * 96, "bitmap": 1, "n": 0},
], ids=["empty-bitmap", "bitmap-past-n", "short-aggregate", "no-members"])
def test_inconsistent_certificates_reject_as_in_reference(fields):
    with pytest.raises(QCError):
        QuorumCertificate(message=b"m", **fields)
    with pytest.raises(ref_qc.QCError):
        ref_qc.QuorumCertificate(message=b"m", **fields)
