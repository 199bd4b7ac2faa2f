"""RSA over SHA-256 with PKCS#1 v1.5 padding, scheme id 1, in pure Python.

The reference signs and verifies scheme 1 through OpenSSL (the
``cryptography`` package; corda_tpu/crypto/schemes.py:300-304, 186-198),
on the host on every backend: RSA is its cold path (verifier/batch.py:18).
The machine with the card need not have that package, so the port keeps
its own engine:

- keys are the reference's bytes: the public key a DER SubjectPublicKeyInfo
  (rsaEncryption, NULL parameters, RSAPublicKey n, e), the private key a
  DER PKCS#8 PrivateKeyInfo around an RSAPrivateKey;
- ``verify`` computes ``pow(s, e, n)`` and compares the encoded message
  with ``0x00 0x01 FF.. 0x00 || DigestInfo(SHA-256) || H(m)`` byte for
  byte (RFC 8017 §8.2.2, the encoding compared whole), after OpenSSL's
  checks: a modulus of at most 16,384 bits, n > e, a public exponent of
  at most 64 bits where the modulus is over 3,072 bits
  (``rsa_ossl_public_decrypt``; so no key makes ``pow`` dearer than that),
  an odd modulus (its Montgomery context), a signature as long as the
  modulus, s < n. Nothing else of n and e is refused: a key with e = 1 or
  e = 2 verifies, as it does in OpenSSL;
- ``sign`` is deterministic, so its bytes equal OpenSSL's for the same key;
- ``generate(rng)`` makes a 2,048-bit key with e = 65537 (Miller-Rabin),
  encoded as ``cryptography`` encodes one.

Every failure to parse or to verify is False, never an exception.
"""

from __future__ import annotations

import functools
import hashlib
import math

RSA_OID = bytes.fromhex("2a864886f70d010101")  # 1.2.840.113549.1.1.1
ALG_ID = bytes.fromhex("300d06092a864886f70d0101010500")  # rsaEncryption, NULL
# DigestInfo's DER prefix for SHA-256 (RFC 8017 §9.2, note 1)
SHA256_DIGEST_INFO = bytes.fromhex("3031300d060960864801650304020105000420")
KEY_BITS = 2048
PUBLIC_EXPONENT = 65537
# OpenSSL's limits on a key it verifies with (include/openssl/rsa.h):
MAX_MODULUS_BITS = 16384  # OPENSSL_RSA_MAX_MODULUS_BITS
SMALL_MODULUS_BITS = 3072  # OPENSSL_RSA_SMALL_MODULUS_BITS: above it,
MAX_PUBEXP_BITS = 64  # OPENSSL_RSA_MAX_PUBEXP_BITS bounds e


class DerError(ValueError):
    pass


# ---------------------------------------------------------------- DER


def _read_tlv(buf: bytes, at: int) -> tuple[int, bytes, int]:
    """(tag, contents, next offset) of the DER element at ``at``: one tag
    byte, a definite minimal length."""
    if at + 2 > len(buf):
        raise DerError("truncated element")
    tag, first = buf[at], buf[at + 1]
    at += 2
    if first < 0x80:
        length = first
    else:
        n = first & 0x7F
        if n == 0 or n > 4 or at + n > len(buf) or buf[at] == 0:
            raise DerError("bad length")
        length = int.from_bytes(buf[at:at + n], "big")
        if length < 0x80:
            raise DerError("non-minimal length")
        at += n
    if at + length > len(buf):
        raise DerError("truncated contents")
    return tag, buf[at:at + length], at + length


def _children(contents: bytes) -> list[tuple[int, bytes]]:
    out, at = [], 0
    while at < len(contents):
        tag, body, at = _read_tlv(contents, at)
        out.append((tag, body))
    return out


def _one(buf: bytes, tag: int) -> bytes:
    """The contents of ``buf``, which must be exactly one element of ``tag``."""
    got, body, end = _read_tlv(buf, 0)
    if got != tag or end != len(buf):
        raise DerError(f"expected one element of tag {tag:#x}")
    return body


def _uint(body: bytes) -> int:
    """A DER INTEGER's contents as a non-negative int (minimal, positive)."""
    if not body or body[0] & 0x80 or (len(body) > 1 and body[0] == 0 and not body[1] & 0x80):
        raise DerError("bad INTEGER")
    return int.from_bytes(body, "big")


def _tlv(tag: int, body: bytes) -> bytes:
    n = len(body)
    if n < 0x80:
        return bytes([tag, n]) + body
    size = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([tag, 0x80 | len(size)]) + size + body


def _int(v: int) -> bytes:
    return _tlv(0x02, v.to_bytes(v.bit_length() // 8 + 1, "big"))


def _seq(*parts: bytes) -> bytes:
    return _tlv(0x30, b"".join(parts))


# ---------------------------------------------------------------- keys


@functools.lru_cache(maxsize=1024)
def parse_public(spki: bytes) -> tuple[int, int]:
    """(n, e) of a DER SubjectPublicKeyInfo of an RSA key; raises DerError.
    Only the DER is checked, as OpenSSL's load checks it: any n and e parse
    (``verify`` applies OpenSSL's refusals)."""
    parts = _children(_one(bytes(spki), 0x30))
    if len(parts) != 2 or parts[0][0] != 0x30 or parts[1][0] != 0x03:
        raise DerError("not a SubjectPublicKeyInfo")
    alg = _children(parts[0][1])
    if not alg or alg[0] != (0x06, RSA_OID) or alg[1:] not in ([], [(0x05, b"")]):
        raise DerError("not an rsaEncryption key")
    bits = parts[1][1]
    if not bits or bits[0] != 0:
        raise DerError("bad BIT STRING")
    fields = _children(_one(bits[1:], 0x30))
    if len(fields) != 2 or any(tag != 0x02 for tag, _b in fields):
        raise DerError("not an RSAPublicKey")
    n, e = (_uint(body) for _t, body in fields)
    return n, e


@functools.lru_cache(maxsize=256)
def parse_private(pkcs8: bytes) -> tuple[int, ...]:
    """(n, e, d, p, q, dp, dq, qinv) of a DER PKCS#8 RSA private key."""
    parts = _children(_one(bytes(pkcs8), 0x30))
    if len(parts) < 3 or parts[0] != (0x02, b"\x00") or parts[2][0] != 0x04:
        raise DerError("not a PKCS#8 PrivateKeyInfo")
    alg = _children(parts[1][1])
    if not alg or alg[0] != (0x06, RSA_OID):
        raise DerError("not an rsaEncryption key")
    fields = _children(_one(parts[2][1], 0x30))
    if len(fields) != 9 or fields[0] != (0x02, b"\x00") or any(t != 0x02 for t, _b in fields):
        raise DerError("not a two-prime RSAPrivateKey")
    return tuple(_uint(body) for _t, body in fields[1:])


def encode_public(n: int, e: int) -> bytes:
    """DER SubjectPublicKeyInfo of (n, e), as ``cryptography`` writes it."""
    return _seq(ALG_ID, _tlv(0x03, b"\x00" + _seq(_int(n), _int(e))))


def encode_private(n, e, d, p, q, dp, dq, qinv) -> bytes:
    """DER PKCS#8 PrivateKeyInfo of a two-prime key, unencrypted."""
    key = _seq(*(_int(v) for v in (0, n, e, d, p, q, dp, dq, qinv)))
    return _seq(_int(0), ALG_ID, _tlv(0x04, key))


# ----------------------------------------------------------- generation

_SMALL_PRIMES = [p for p in range(3, 2000) if all(p % q for q in range(2, math.isqrt(p) + 1))]


def _probable_prime(c: int, rng, rounds: int = 40) -> bool:
    """Miller-Rabin with ``rounds`` random bases (after trial division)."""
    for sp in _SMALL_PRIMES:
        if c % sp == 0:
            return c == sp
    d, s = c - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for _ in range(rounds):
        x = pow(2 + rng.getrandbits(c.bit_length()) % (c - 3), d, c)
        if x in (1, c - 1):
            continue
        for _r in range(s - 1):
            x = x * x % c
            if x == c - 1:
                break
        else:
            return False
    return True


def _prime(bits: int, e: int, rng) -> int:
    """A random prime of exactly ``bits`` bits, its top two bits set (so
    two of them make a modulus of 2 * bits), with gcd(e, p - 1) = 1."""
    while True:
        c = rng.getrandbits(bits) | (3 << (bits - 2)) | 1
        if math.gcd(e, c - 1) == 1 and _probable_prime(c, rng):
            return c


def generate(rng) -> tuple[bytes, bytes]:
    """(SPKI DER, PKCS#8 DER) of a new 2,048-bit key with e = 65537 from
    ``rng`` (a ``random.Random`` or ``secrets.SystemRandom``): a seeded rng
    gives the same key."""
    e = PUBLIC_EXPONENT
    while True:
        p = _prime(KEY_BITS // 2, e, rng)
        q = _prime(KEY_BITS // 2, e, rng)
        if p == q:
            continue
        if p < q:
            p, q = q, p
        n = p * q
        lam = (p - 1) * (q - 1) // math.gcd(p - 1, q - 1)
        d = pow(e, -1, lam)
        return (encode_public(n, e),
                encode_private(n, e, d, p, q, d % (p - 1), d % (q - 1), pow(q, -1, p)))


# -------------------------------------------------------- sign / verify


def _encoded_message(message: bytes, k: int) -> bytes:
    """EMSA-PKCS1-v1_5 of SHA-256(message) for a modulus of ``k`` bytes."""
    t = SHA256_DIGEST_INFO + hashlib.sha256(message).digest()
    if k < len(t) + 11:
        raise DerError("modulus too short for SHA-256")
    return b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t


def sign(private_der: bytes, message: bytes) -> bytes:
    """PKCS#1 v1.5 signature over SHA-256, as long as the modulus."""
    n, _e, _d, p, q, dp, dq, qinv = parse_private(bytes(private_der))
    k = (n.bit_length() + 7) // 8
    m = int.from_bytes(_encoded_message(message, k), "big")
    m1, m2 = pow(m, dp, p), pow(m, dq, q)
    s = m2 + (qinv * (m1 - m2) % p) * q
    return s.to_bytes(k, "big")


def verify(public_der: bytes, signature: bytes, message: bytes) -> bool:
    """Whether ``signature`` is a PKCS#1 v1.5 SHA-256 signature of
    ``message`` under the SPKI key; False on any malformed input."""
    try:
        n, e = parse_public(bytes(public_der))
        if n.bit_length() > MAX_MODULUS_BITS or n <= e or (
                n.bit_length() > SMALL_MODULUS_BITS and e.bit_length() > MAX_PUBEXP_BITS):
            return False
        if n % 2 == 0:  # OpenSSL's Montgomery context takes no even modulus
            return False
        k = (n.bit_length() + 7) // 8
        if len(signature) != k:
            return False
        s = int.from_bytes(signature, "big")
        if s >= n:
            return False
        return pow(s, e, n).to_bytes(k, "big") == _encoded_message(message, k)
    except (ValueError, TypeError):  # DerError is a ValueError
        return False


def public_key_valid(public_der: bytes) -> bool:
    try:
        parse_public(bytes(public_der))
        return True
    except (DerError, TypeError):
        return False
