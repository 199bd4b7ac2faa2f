"""RSA (scheme 1) in the port, a pure-Python PKCS#1 v1.5 engine over
SHA-256 (``crypto/rsa.py``), against the reference's OpenSSL route (the
``cryptography`` package, which only the tests import):

- the port's verify equals the reference's ``is_valid`` on keys made by
  ``cryptography`` and by the port, on valid signatures and on every edge
  case of ``testing.rsa_adversarial_lanes`` (wrong lengths, s >= n, bad
  padding, a DigestInfo without NULL or of another hash, malformed keys,
  keys at and past OpenSSL's limits on the modulus and the exponent, and
  keys OpenSSL loads unchecked: e = 0, 1, 2, n - 1 and n + 2, an even
  modulus, n = 1);
- the port's signatures are byte-equal to OpenSSL's for the same key;
- the port's generated keys load in ``cryptography`` and encode as it does;
- the registry: generation, no derivation from entropy, key validation.

Every comparison is exact."""

import hashlib
import random

import pytest

pytest.importorskip("cryptography")

from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import padding
from cryptography.hazmat.primitives.asymmetric import rsa as openssl_rsa

from corda_tpu.crypto import schemes as ref_schemes
from corda_tpu.crypto.keys import PublicKey as RefPublicKey
from corda_tpu_torch.crypto import CryptoError, PublicKey, rsa, schemes
from corda_tpu_torch.testing import rsa_adversarial_lanes

KINDS = ["valid", "altered_msg", "flipped_sig_bit", "wrong_key", "sig_short", "sig_long",
         "sig_zero", "sig_eq_n", "sig_gt_n", "block_type_02", "digestinfo_without_null",
         "other_hash_oid", "short_ff_run", "broken_ff_run", "trailing_byte", "key_truncated",
         "key_trailing_byte", "key_without_null", "ec_key", "modulus_at_limit",
         "modulus_too_large", "exponent_large_small_modulus", "exponent_too_large_for_modulus",
         "exponent_at_limit", "exponent_one", "exponent_two", "exponent_zero",
         "exponent_n_minus_1", "exponent_above_n", "even_modulus", "modulus_one"]
# kinds the reference accepts: every other is refused
ACCEPTED = ("valid", "key_without_null", "modulus_at_limit", "exponent_large_small_modulus",
            "exponent_at_limit", "exponent_one", "exponent_two")


def der_pair(key) -> tuple[bytes, bytes]:
    return (key.public_key().public_bytes(serialization.Encoding.DER,
                                          serialization.PublicFormat.SubjectPublicKeyInfo),
            key.private_bytes(serialization.Encoding.DER, serialization.PrivateFormat.PKCS8,
                              serialization.NoEncryption()))


@pytest.fixture(scope="module")
def openssl_keys():
    return [openssl_rsa.generate_private_key(public_exponent=65537, key_size=2048)
            for _ in range(2)]


@pytest.fixture(scope="module")
def lanes(openssl_keys):
    return {"openssl": rsa_adversarial_lanes(3, keys=[der_pair(k) for k in openssl_keys]),
            "port": rsa_adversarial_lanes(4)}


@pytest.mark.parametrize("source", ["openssl", "port"])
@pytest.mark.parametrize("kind", KINDS)
def test_verify_matches_reference(lanes, source, kind):
    assert [k for k, *_ in lanes[source]] == KINDS
    _k, pk, sig, msg = lanes[source][KINDS.index(kind)]
    want = ref_schemes.is_valid(RefPublicKey(1, pk), sig, msg)
    assert rsa.verify(pk, sig, msg) == want
    assert schemes.is_valid(PublicKey(1, pk), sig, msg) == want
    assert want == (kind in ACCEPTED)


@pytest.mark.parametrize("message", [b"", b"m", bytes(range(256)) * 5])
def test_signatures_equal_openssl(openssl_keys, message):
    key = openssl_keys[0]
    _pub, priv = der_pair(key)
    assert rsa.sign(priv, message) == key.sign(message, padding.PKCS1v15(), hashes.SHA256())


@pytest.mark.parametrize("seed", [0, 1])
def test_generated_keys_load_in_openssl(seed):
    pub, priv = rsa.generate(random.Random(seed))
    assert rsa.generate(random.Random(seed)) == (pub, priv)  # a seed fixes the key
    key = serialization.load_der_private_key(priv, password=None)
    assert key.key_size == 2048 and key.public_key().public_numbers().e == 65537
    assert der_pair(key) == (pub, priv)
    msg = b"generated %d" % seed
    sig = rsa.sign(priv, msg)
    assert sig == key.sign(msg, padding.PKCS1v15(), hashes.SHA256())
    key.public_key().verify(sig, msg, padding.PKCS1v15(), hashes.SHA256())
    assert ref_schemes.is_valid(RefPublicKey(1, pub), sig, msg)


def test_registry_generates_signs_and_refuses_derivation():
    kp = schemes.generate_keypair(1)
    sig = schemes.sign(kp.private, b"registry")
    assert schemes.is_valid(kp.public, sig, b"registry")
    assert ref_schemes.is_valid(RefPublicKey(1, kp.public.encoded), sig, b"registry")
    with pytest.raises(CryptoError, match="cannot derive key pairs for scheme 1"):
        schemes.derive_keypair_from_entropy(1, hashlib.sha256(b"e").digest())
    with pytest.raises(ref_schemes.CryptoError, match="cannot derive key pairs for scheme 1"):
        ref_schemes.derive_keypair_from_entropy(1, hashlib.sha256(b"e").digest())


@pytest.mark.parametrize("kind", ["valid", "key_truncated", "key_trailing_byte",
                                  "key_without_null", "modulus_too_large",
                                  "exponent_too_large_for_modulus", "exponent_one",
                                  "exponent_two", "exponent_zero", "exponent_n_minus_1",
                                  "exponent_above_n", "even_modulus", "modulus_one"])
def test_public_key_validation_matches_reference(lanes, kind):
    pk = lanes["openssl"][KINDS.index(kind)][1]
    assert schemes.public_key_on_curve(PublicKey(1, pk)) == \
        ref_schemes.public_key_on_curve(RefPublicKey(1, pk))
