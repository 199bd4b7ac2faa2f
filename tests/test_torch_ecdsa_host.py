"""The port's pure-Python ECDSA engine (corda_tpu_torch/crypto/ecdsa_host.py)
and its schemes 2 and 3 against the reference's OpenSSL-backed
``corda_tpu.crypto.schemes``: derived keys byte-equal, signatures accepted
both ways (the port's RFC 6979 nonce differs from OpenSSL's random one, so
signatures agree by verdict, not by bytes), low S, determinism, and the
oracle's verdicts on every adversarial kind."""

import hashlib

import pytest

pytest.importorskip("cryptography")  # the reference signs with OpenSSL

from corda_tpu.crypto import schemes as ref
from corda_tpu_torch.crypto import ecdsa_host as eh
from corda_tpu_torch.crypto import schemes as port
from corda_tpu_torch.crypto.keys import PublicKey
from corda_tpu_torch.testing import ecdsa_adversarial_lanes

CURVES = [(2, "secp256k1"), (3, "secp256r1")]
IDS = [name for _sid, name in CURVES]


def entropies(k):
    return [hashlib.sha256(b"entropy %d" % i).digest() for i in range(k)]


@pytest.mark.parametrize("sid,name", CURVES, ids=IDS)
def test_derived_keys_match_reference(sid, name):
    for ent in entropies(6) + [b"", b"\x00" * 64]:
        mine = port.derive_keypair_from_entropy(sid, ent)
        theirs = ref.derive_keypair_from_entropy(sid, ent)
        assert mine.public.encoded == theirs.public.encoded
        assert mine.private.encoded == theirs.private.encoded
        assert len(mine.public.encoded) == 33 and mine.public.encoded[0] in (2, 3)


@pytest.mark.parametrize("sid,name", CURVES, ids=IDS)
def test_signatures_verify_both_ways(sid, name):
    for i, ent in enumerate(entropies(4)):
        kp = port.derive_keypair_from_entropy(sid, ent)
        ref_kp = ref.derive_keypair_from_entropy(sid, ent)
        msg = b"mixed-scheme message %d" % i
        mine = port.sign(kp.private, msg)
        theirs = ref.sign(ref_kp.private, msg)
        assert ref.is_valid(ref_kp.public, mine, msg)
        assert port.is_valid(kp.public, theirs, msg)
        assert not port.is_valid(kp.public, theirs, msg + b"!")
        assert not ref.is_valid(ref_kp.public, mine, msg + b"!")


@pytest.mark.parametrize("sid,name", CURVES, ids=IDS)
def test_low_s_and_deterministic(sid, name):
    n = eh.CURVES[name].n
    kp = port.derive_keypair_from_entropy(sid, b"low-s")
    for i in range(24):
        msg = b"m%d" % i
        sig = port.sign(kp.private, msg)
        assert len(sig) == 64 and sig == port.sign(kp.private, msg)
        assert 1 <= int.from_bytes(sig[32:], "big") <= n // 2


def test_rfc6979_p256_sha256_vector():
    """RFC 6979 A.2.5, P-256 with SHA-256, message "sample": the same k,
    so the same r, and s normalised to low S."""
    cv = eh.SECP256R1
    d = 0xC9AFA9D845BA75166B5C215767B1D6934E50C3DB36E89B127B8A622B120F6721
    r = 0xEFD48B2AACB6A8FD1140DD9CD45E81D69D2C877B56AAF991C34D0EA84EAF3716
    s = 0xF7CB1C942D657C41D436C7A1B6E29F65F3E900DBB9AFF4064DC4AB2F843ACDA8
    sig = eh.sign(cv, d, b"sample")
    assert sig == r.to_bytes(32, "big") + min(s, cv.n - s).to_bytes(32, "big")
    assert eh.verify(cv, eh.public_from_private(cv, d), sig, b"sample")


@pytest.mark.parametrize("sid,name", CURVES, ids=IDS)
def test_oracle_matches_reference_on_adversarial_lanes(sid, name):
    lanes = ecdsa_adversarial_lanes(name, seed=3)
    kinds = {k for k, *_ in lanes}
    assert {"second_candidate", "high_s_twin", "other_curve_key", "key_x_ge_p"} <= kinds
    for kind, pk, sig, msg in lanes:
        want = ref.is_valid(ref.PublicKey(sid, pk), sig, msg)
        assert port.is_valid(PublicKey(sid, pk), sig, msg) == want, kind
        assert want == (kind in ("valid", "valid_uncompressed", "second_candidate")), kind
        assert port.public_key_on_curve(PublicKey(sid, pk)) == \
            ref.public_key_on_curve(ref.PublicKey(sid, pk)), kind


@pytest.mark.parametrize("sid,name", CURVES, ids=IDS)
def test_generated_keys_sign_and_verify(sid, name):
    kp = port.generate_keypair(sid)
    sig = port.sign(kp.private, b"fresh")
    assert port.is_valid(kp.public, sig, b"fresh")
    assert ref.is_valid(ref.PublicKey(sid, kp.public.encoded), sig, b"fresh")
