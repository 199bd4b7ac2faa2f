"""Seeded signature batches, adversarial lanes and notary streams for the
tests and chip_smoke.py.

Signature rows are signed with the port's pure-Python signer
(``crypto/ed25519_host.py``) from a seed, so a batch is the same wherever
it is made. ``adversarial_lanes`` returns one lane of each kind a verifier
must settle exactly like the reference; the oracle decides what "exactly"
means (``ed25519_host.verify``).

``ecdsa_adversarial_lanes`` does the same for one ECDSA curve (the oracle
is ``ecdsa_host.verify``), ``sphincs_adversarial_lanes`` and
``rsa_adversarial_lanes`` for the hash-based scheme and RSA (``sphincs.verify``
and ``rsa.verify``), and ``mixed_rows`` builds the mixed-scheme workload of
``bench.py``'s ``MIXED_COMPOSITION`` from a seed.

``back_chain`` builds BASELINE config #4's resolve shape, a Cash
back-chain of self-moves, and ``generated_ledger.GeneratedLedger`` random
valid DAGs with fan-in, fan-out and several signers.

``notary_stream`` builds the notary's traffic (one Cash issue fanning out
to independent moves signed by Alice, cut into windows) with one request
of each adversarial kind at a known position, and with
``contract_invalid=True`` one request of each kind only a validating
notary rejects; ``state_resolver`` resolves the inputs of such a stream;
``outcome_kind`` names what a notary answered, so two notaries compare slot
by slot.

``service_stream.service_stream`` builds the verifier service's traffic
(Cash moves owned by ed25519, composite, ECDSA, SPHINCS and BLS keys, and
moves whose contract an attachment carries), with one transaction of
each of its adversarial kinds at a known position and the outcome each
must come to.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import random
import struct
import time

from ..crypto.ed25519_host import (
    BASE,
    NEUTRAL,
    L,
    P,
    _clamp,
    compress,
    decompress,
    point_add,
    public_from_seed,
    scalar_mul,
    sign,
)
from .generated_ledger import GeneratedLedger, sign_tx_ids  # noqa: F401  (registers testing.GenContract)

FIXED_MSG_LEN = 44  # the signable payload of a transaction signature


def signed_triples(n: int, seed: int = 0, msg_len=FIXED_MSG_LEN) -> list:
    """n valid (pubkey, signature, message) byte triples; ``msg_len`` is
    an int or an inclusive (lo, hi) range."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        key_seed = hashlib.sha256(b"port-key %d %d" % (seed, i)).digest()
        length = msg_len if isinstance(msg_len, int) else rng.randint(*msg_len)
        msg = rng.randbytes(length)
        out.append((public_from_seed(key_seed), sign(key_seed, msg), msg))
    return out


def _is_identity(pt) -> bool:
    return compress(pt) == compress(NEUTRAL)


def torsion_point8():
    """A point of order 8 (in the small-order subgroup)."""
    for y in range(2, 1000):
        pt = decompress(y.to_bytes(32, "little"))
        if pt is None:
            continue
        t = scalar_mul(L, pt)
        if not _is_identity(scalar_mul(4, t)):
            return t
    raise AssertionError("no order-8 point found")


def _sign_with(a: int, pub: bytes, msg: bytes, r: int) -> tuple[bytes, int]:
    """Signature with secret scalar ``a`` under ``pub`` and nonce ``r``;
    also returns h mod L."""
    rb = compress(scalar_mul(r, BASE))
    h = int.from_bytes(hashlib.sha512(rb + pub + msg).digest(), "little") % L
    return rb + ((r + h * a) % L).to_bytes(32, "little"), h


def adversarial_lanes(seed: int = 0) -> list[tuple[str, bytes, bytes, bytes]]:
    """(kind, pubkey, signature, message) for every adversarial kind, with
    44-byte messages so the fixed-length route sees them too."""
    rng = random.Random(seed)
    base = signed_triples(8, seed=seed + 1000)
    lanes = []

    pk, sig, msg = base[0]
    lanes.append(("flipped_r_byte", pk, bytes([sig[0] ^ 1]) + sig[1:], msg))
    pk, sig, msg = base[1]
    lanes.append(("flipped_msg_bit", pk, sig, msg[:-1] + bytes([msg[-1] ^ 0x80])))
    pk, sig, msg = base[2]
    s = int.from_bytes(sig[32:], "little")
    lanes.append(("s_plus_l", pk, sig[:32] + (s + L).to_bytes(32, "little"), msg))
    pk, sig, msg = base[3]
    lanes.append(("truncated_pubkey", pk[:31], sig, msg))
    pk, sig, msg = base[4]
    lanes.append(("noncanonical_y", (P + 1).to_bytes(32, "little"), sig, msg))
    lanes.append(("off_curve_a", (2).to_bytes(32, "little"), sig, msg))
    lanes.append(("x0_sign1", (1 | (1 << 255)).to_bytes(32, "little"), sig, msg))
    lanes.append(("all_zero_sig", pk, bytes(64), msg))
    pk, sig, msg = base[5]
    lanes.append(("r_y_ge_p", pk, (P + 1).to_bytes(32, "little") + sig[32:], msg))

    # small-order A: the identity accepts R = [s]B for any message (the
    # cofactorless rule); an order-8 A with an honest-looking signature
    msg = rng.randbytes(FIXED_MSG_LEN)
    s_small = rng.randrange(L)
    ident = compress(NEUTRAL)
    lanes.append(("small_order_a_identity", ident,
                  compress(scalar_mul(s_small, BASE)) + s_small.to_bytes(32, "little"), msg))
    t8 = torsion_point8()
    lanes.append(("small_order_a_order8", compress(t8), base[6][1], msg))

    # mixed-order A = aB + T8: [s]B - [h]A = R - [h]T8, so the verdict
    # depends on h mod L (mod 8) — the h-reduced-mod-L rule
    a = rng.randrange(1, L)
    pub = compress(point_add(scalar_mul(a, BASE), t8))
    want = {"mixed_order_accept": True, "mixed_order_reject": False}
    for kind, accept in want.items():
        msg = rng.randbytes(FIXED_MSG_LEN)
        while True:
            sig, h = _sign_with(a, pub, msg, rng.randrange(1, L))
            if (h % 8 == 0) == accept:
                break
        lanes.append((kind, pub, sig, msg))
    return lanes


def small_r_signature(seed: bytes, msg: bytes) -> tuple[bytes, bytes, bytes]:
    """(pubkey, signature, message) under the key of ``seed`` with R the
    identity's encoding and s = h a: [s]B - [h]A is the identity, so the
    cofactorless rule accepts, and R is of small order, so the cofactored
    rule of full buckets rejects."""
    a = _clamp(hashlib.sha512(seed).digest()[:32]) % L
    pub = public_from_seed(seed)
    r_enc = compress(NEUTRAL)
    h = int.from_bytes(hashlib.sha512(r_enc + pub + msg).digest(), "little") % L
    return pub, r_enc + (h * a % L).to_bytes(32, "little"), msg


def cofactored_lanes(seed: int = 0) -> list[tuple[str, bytes, bytes, bytes]]:
    """(kind, pubkey, signature, message) for the kinds only the cofactored
    rule of full buckets (the reference's batchverify/rlc.py) looks at:
    each of the 8 small-order encodings as A and as R, and an R of small
    order that the cofactorless rule accepts. ``adversarial_lanes`` has the
    mixed-order kinds."""
    from ..batchverify import small_order_encodings

    pk, sig, msg = signed_triples(1, seed=seed + 2000)[0]
    lanes = []
    for k, enc in enumerate(small_order_encodings()):
        lanes.append((f"small_order_a_{k}", enc, sig, msg))
        lanes.append((f"small_order_r_{k}", pk, enc + sig[32:], msg))
    lanes.append(("small_order_r_accepted_cofactorless",
                  *small_r_signature(hashlib.sha256(b"small r %d" % seed).digest(), msg)))
    return lanes


# ------------------------------------------------------------ ECDSA lanes


def _ecdsa_keypair(curve_name: str, tag: bytes):
    from ..crypto import derive_keypair_from_entropy
    from ..crypto.schemes import ECDSA_CURVES

    sid = next(k for k, cv in ECDSA_CURVES.items() if cv.name == curve_name)
    return derive_keypair_from_entropy(sid, hashlib.sha256(tag).digest())


def _second_candidate_lane(curve_name: str, rng: random.Random):
    """(pubkey, signature, message) whose R = u1*G + u2*Q has n <= x(R) < p,
    so it verifies only through the second accept candidate r + n: pick R
    with such an x, set r = x(R) - n, a message and a low s, and recover
    Q = r^-1 (s*R - e*G), which makes u1*G + u2*Q = R."""
    from ..crypto import ecdsa_host as eh

    cv = eh.CURVES[curve_name]
    while True:
        x = cv.n + rng.randrange(1, cv.p - cv.n)
        rhs = (pow(x, 3, cv.p) + cv.a * x + cv.b) % cv.p
        y = pow(rhs, (cv.p + 1) // 4, cv.p)
        if y * y % cv.p == rhs:
            break
    r = x - cv.n
    s = rng.randrange(1, cv.n // 2 + 1)
    msg = rng.randbytes(FIXED_MSG_LEN)
    e = int.from_bytes(hashlib.sha256(msg).digest(), "big")
    sr = eh.scalar_mult(cv, s, (x, y))
    q = eh.scalar_mult(cv, pow(r, cv.n - 2, cv.n),
                       eh.point_add(cv, sr, eh.point_neg(cv, eh.base_mult(cv, e))))
    return eh.encode_point(q), r.to_bytes(32, "big") + s.to_bytes(32, "big"), msg


def ecdsa_adversarial_lanes(curve_name: str, seed: int = 0) -> list:
    """(kind, pubkey, signature, message) for every kind an ECDSA verifier
    must settle exactly like the reference, on ``curve_name``: valid rows
    (compressed and 65-byte uncompressed keys, and one that verifies only
    through the second candidate x(R) = r + n), flipped r and s bits, an
    altered message, a wrong key, the high-S twin, r = s = 0, r = n, a
    non-twin s > n/2, a 63-byte signature, keys with x >= p, off the curve
    or with a bad prefix byte, and the other curve's key under this
    curve's scheme."""
    from ..crypto import ecdsa_host as eh
    from ..crypto import sign

    cv = eh.CURVES[curve_name]
    other = "secp256r1" if curve_name == "secp256k1" else "secp256k1"
    rng = random.Random(seed)
    base = []
    for i in range(9):
        kp = _ecdsa_keypair(curve_name, b"ecdsa lane %s %d %d" % (curve_name.encode(), seed, i))
        msg = rng.randbytes(FIXED_MSG_LEN)
        base.append((kp.public.encoded, sign(kp.private, msg), msg))

    def with_r(sig, r):
        return r.to_bytes(32, "big") + sig[32:]

    def with_s(sig, s):
        return sig[:32] + s.to_bytes(32, "big")

    lanes = [("valid", *base[0])]
    pk, sig, msg = base[1]
    lanes.append(("valid_uncompressed", eh.encode_point(eh.decode_point(cv, pk), False),
                  sig, msg))
    lanes.append(("second_candidate", *_second_candidate_lane(curve_name, rng)))
    pk, sig, msg = base[2]
    lanes.append(("flipped_r_bit", pk, bytes([sig[0] ^ 1]) + sig[1:], msg))
    lanes.append(("flipped_s_bit", pk, sig[:40] + bytes([sig[40] ^ 8]) + sig[41:], msg))
    lanes.append(("altered_msg", pk, sig, msg + b"x"))
    lanes.append(("wrong_key", base[3][0], sig, msg))
    s = int.from_bytes(sig[32:], "big")
    lanes.append(("high_s_twin", pk, with_s(sig, cv.n - s), msg))
    lanes.append(("r_s_zero", pk, bytes(64), msg))
    lanes.append(("r_eq_n", pk, with_r(sig, cv.n), msg))
    lanes.append(("s_gt_half", pk, with_s(sig, cv.n // 2 + 1), msg))
    lanes.append(("truncated_sig", pk, sig[:63], msg))
    pk, sig, msg = base[4]
    lanes.append(("key_x_ge_p", b"\x02" + cv.p.to_bytes(32, "big"), sig, msg))
    x, y = eh.decode_point(cv, pk)
    off = b"\x04" + x.to_bytes(32, "big") + ((y + 1) % cv.p).to_bytes(32, "big")
    lanes.append(("key_off_curve", off, sig, msg))
    lanes.append(("bad_prefix", b"\x05" + pk[1:], sig, msg))
    okp = _ecdsa_keypair(other, b"ecdsa other %d" % seed)
    msg = rng.randbytes(FIXED_MSG_LEN)
    lanes.append(("other_curve_key", okp.public.encoded, sign(okp.private, msg), msg))
    return lanes


# ------------------------------------------------------------ mixed schemes

# bench.py's MIXED_COMPOSITION (:347-350), BASELINE config #3's shape
MIXED_COMPOSITION = (("eddsa", 2048), ("secp256k1", 512), ("secp256r1", 512),
                     ("sphincs", 8), ("rsa", 8))
MIXED_SCHEMES = {"eddsa": 4, "secp256k1": 2, "secp256r1": 3, "sphincs": 5, "rsa": 1}


def _mixed_keys(name: str, n: int, seed: int) -> list:
    """``n`` keys of one scheme of the mixed workload, fixed by the seed:
    derived from entropy, or for RSA (not derivable) generated over a
    seeded ``random.Random``."""
    from ..crypto import KeyPair, PrivateKey, PublicKey, derive_keypair_from_entropy
    from ..crypto import rsa

    sid = MIXED_SCHEMES[name]
    if name == "rsa":
        rng = random.Random(b"mixed rsa %d" % seed)
        return [KeyPair(PublicKey(sid, pub), PrivateKey(sid, priv))
                for pub, priv in (rsa.generate(rng) for _ in range(n))]
    return [derive_keypair_from_entropy(
        sid, hashlib.sha256(b"mixed %s %d %d" % (name.encode(), seed, k)).digest())
        for k in range(n)]


def mixed_rows(composition=MIXED_COMPOSITION, *, keys_per_scheme: int = 16,
               tile: int = 1, seed: int = 0, device=None, timings: dict | None = None) -> list:
    """(PublicKey, signature, message) rows of the mixed-scheme workload:
    ``count`` rows a scheme with ``min(keys_per_scheme, count)`` keys each
    assigned round robin, messages as in bench.py's ``make_mixed_rows``
    ("CTMX" || SHA-256(name || i)), the whole repeated ``tile`` times and
    shuffled with ``random.Random(7)``. The ed25519 rows are signed in one
    ``ed25519_sign_batch`` on ``device`` (the card unless ``device="cpu"``),
    the others by the host signers (pure Python: a SPHINCS key takes about
    0.1 s and a signature 0.2 s, an RSA key about 0.5 s). ``timings``, when
    given, gets each scheme's seconds to build."""
    from ..crypto import sign
    from ..ops.ed25519_sign import ed25519_sign_batch

    rows = []
    for name, count in composition:
        t0 = time.perf_counter()
        sid = MIXED_SCHEMES[name]
        keys = _mixed_keys(name, min(keys_per_scheme, count), seed)
        msgs = [b"CTMX" + hashlib.sha256(name.encode() + i.to_bytes(8, "little")).digest()
                for i in range(count)]
        kps = [keys[i % len(keys)] for i in range(count)]
        if sid == 4:
            sigs = ed25519_sign_batch([kp.private.encoded for kp in kps], msgs, device=device)
        else:
            sigs = [sign(kp.private, m) for kp, m in zip(kps, msgs)]
        rows += [(kp.public, s, m) for kp, s, m in zip(kps, sigs, msgs)]
        if timings is not None:
            timings[name] = time.perf_counter() - t0
    rows = rows * tile
    random.Random(7).shuffle(rows)
    return rows


def _flip(b: bytes, at: int, bit: int = 1) -> bytes:
    return b[:at] + bytes([b[at] ^ bit]) + b[at + 1:]


def sphincs_adversarial_lanes(seed: int = 0) -> list[tuple[str, bytes, bytes, bytes]]:
    """(kind, pubkey, signature, message) for every kind a SPHINCS verifier
    must settle exactly like the reference (the oracle is ``sphincs.verify``):
    a valid lane, the tampered offsets of the reference's tests (the
    randomizer, the index, a FORS secret, a FORS sibling, the claimed root,
    the public seed) and one in a FORS tree's last sibling, a WOTS chain
    value and an XMSS sibling, a wrong message, an index steered to the
    next instance, another key, a key of the wrong tag, a short and a long
    signature, and garbage."""
    from ..crypto import derive_keypair_from_entropy, sign
    from ..crypto.sphincs import H, N
    from ..ops.sphincs_batch import FORS_OFF, FORS_TREE, LAYER_BYTES, LAYER_OFF

    kps = [derive_keypair_from_entropy(5, hashlib.sha256(b"sphincs lanes %d %d" % (seed, k))
                                       .digest()) for k in range(2)]
    msg = b"sphincs adversarial %d" % seed
    pk, sig = kps[0].public.encoded, sign(kps[0].private, msg)
    lanes = [("valid", pk, sig, msg)]
    for kind, off in (("tampered_randomizer", 0), ("tampered_index", N),
                      ("tampered_fors_secret", N + 9), ("tampered_fors_sibling", N + 8 + N + 2),
                      ("tampered_root", len(sig) - 1), ("tampered_pub_seed", len(sig) - N - 1),
                      ("tampered_last_fors_sibling", FORS_OFF + 13 * FORS_TREE + FORS_TREE - 1),
                      ("tampered_wots_chain", LAYER_OFF + 2 * LAYER_BYTES + N * 40 + 5),
                      ("tampered_xmss_sibling", LAYER_OFF + 3 * LAYER_BYTES + N * 70 + 7)):
        lanes.append((kind, pk, _flip(sig, off), msg))
    lanes.append(("wrong_message", pk, sig, b"different message"))
    (idx,) = struct.unpack(">Q", sig[N:N + 8])
    lanes.append(("steered_index", pk,
                  sig[:N] + struct.pack(">Q", (idx + 1) % (1 << H)) + sig[N + 8:], msg))
    lanes.append(("wrong_key", kps[1].public.encoded, sig, msg))
    lanes.append(("wrong_tag", b"\x03" + pk[1:], sig, msg))
    lanes.append(("short_signature", pk, sig[:-1], msg))
    lanes.append(("long_signature", pk, sig + b"\x00", msg))
    lanes.append(("garbage", b"\x00", b"junk", msg))
    return lanes


def _rsa_raw_sign(private_der: bytes, em: bytes) -> bytes:
    """The RSA signature primitive over an encoded message of our making."""
    from ..crypto import rsa

    n, _e, d, *_ = rsa.parse_private(private_der)
    k = (n.bit_length() + 7) // 8
    return pow(int.from_bytes(em, "big"), d, n).to_bytes(k, "big")


def _rsa_multi_prime(rng, primes: list[int], bits: int, e: int) -> list[int]:
    """``primes`` (about 512 bits each) and one more prime, chosen so that
    their product is a modulus of exactly ``bits`` bits. OpenSSL's verify
    reads n and e only, so a product of many small primes stands in for a
    key of that size at a fraction of its keygen."""
    from ..crypto import rsa

    base = math.prod(primes)
    while True:
        last = rsa._prime(bits - base.bit_length(), e, rng)
        if (base * last).bit_length() == bits:
            return primes + [last]


def _rsa_crt_sign(n: int, d: int, primes: list[int], em: bytes) -> bytes:
    """em^d mod n, one exponentiation a prime, joined by the CRT."""
    m, s = int.from_bytes(em, "big"), 0
    for p in primes:
        rest = n // p
        s += pow(m, d % (p - 1), p) * rest * pow(rest, -1, p)
    return (s % n).to_bytes((n.bit_length() + 7) // 8, "big")


def _rsa_size_lanes(seed: int, msg: bytes) -> list[tuple[str, bytes, bytes, bytes]]:
    """Valid signatures under keys at and just past OpenSSL's limits: a
    modulus of 16,384 bits (accepted) and of 16,385 (refused); a 65-bit
    public exponent with a 3,072-bit modulus (accepted) and a 3,073-bit one
    (refused); a 64-bit exponent with that 3,073-bit modulus (accepted)."""
    from ..crypto import rsa

    rng = random.Random(b"rsa size lanes %d" % seed)
    e64, e65 = (1 << 64) - 1, (1 << 64) + 1
    coprime = rsa.PUBLIC_EXPONENT * e64 * e65  # gcd(e, p - 1) = 1 for all three
    small = [rsa._prime(512, coprime, rng) for _ in range(31)]
    out = []
    for kind, count, bits, e in (("modulus_at_limit", 31, 16384, rsa.PUBLIC_EXPONENT),
                                 ("modulus_too_large", 31, 16385, rsa.PUBLIC_EXPONENT),
                                 ("exponent_large_small_modulus", 5, 3072, e65),
                                 ("exponent_too_large_for_modulus", 5, 3073, e65),
                                 ("exponent_at_limit", 5, 3073, e64)):
        ps = _rsa_multi_prime(rng, small[:count], bits, coprime)
        n, d = math.prod(ps), pow(e, -1, math.prod(p - 1 for p in ps))
        em = rsa._encoded_message(msg, (bits + 7) // 8)
        out.append((kind, rsa.encode_public(n, e), _rsa_crt_sign(n, d, ps, em), msg))
    return out


def _sqrt_mod_prime(a: int, p: int) -> int | None:
    """A square root of ``a`` modulo the odd prime ``p`` (Tonelli-Shanks),
    or None where ``a`` is no square."""
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    q, s = p - 1, 0
    while q % 2 == 0:
        q, s = q // 2, s + 1
    z = next(z for z in range(2, p) if pow(z, (p - 1) // 2, p) == p - 1)
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2, i = t2 * t2 % p, i + 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c, t, r = i, b * b % p, t * b * b % p, r * b % p
    return r


def _rsa_exponent_lanes(pub: bytes, priv: bytes, sig: bytes,
                        msg: bytes) -> list[tuple[str, bytes, bytes, bytes]]:
    """Keys whose n and e OpenSSL loads without a check: valid signatures
    under e = 1 (s = EM) and e = 2 (s a square root of EM mod n, from the
    key's primes, on the first message whose EM is a square), accepted; e =
    0, n - 1 and n + 2 under the key's signature, an even modulus with e =
    1 and s = EM, and n = 1, refused."""
    from ..crypto import rsa

    n, _e, _d, p, q, *_ = rsa.parse_private(priv)
    k = (n.bit_length() + 7) // 8
    em = rsa._encoded_message(msg, k)
    for i in range(1000):
        msg2 = msg + b" e2 %d" % i
        m = int.from_bytes(rsa._encoded_message(msg2, k), "big")
        rp, rq = _sqrt_mod_prime(m, p), _sqrt_mod_prime(m, q)
        if rp is not None and rq is not None:
            break
    s2 = (rq + q * ((rp - rq) * pow(q, -1, p) % p)) % n  # the CRT
    return [("exponent_one", rsa.encode_public(n, 1), em, msg),
            ("exponent_two", rsa.encode_public(n, 2), s2.to_bytes(k, "big"), msg2),
            ("exponent_zero", rsa.encode_public(n, 0), sig, msg),
            ("exponent_n_minus_1", rsa.encode_public(n, n - 1), sig, msg),
            ("exponent_above_n", rsa.encode_public(n, n + 2), sig, msg),
            ("even_modulus", rsa.encode_public(n + 1, 1), em, msg),
            ("modulus_one", rsa.encode_public(1, rsa.PUBLIC_EXPONENT), sig, msg)]


def rsa_adversarial_lanes(seed: int = 0, keys=None) -> list[tuple[str, bytes, bytes, bytes]]:
    """(kind, SPKI key, signature, message) for every kind an RSA verifier
    must settle exactly like the reference's OpenSSL (the oracle is
    ``rsa.verify``): a valid lane, an altered message, a flipped signature
    bit, another key; signatures one byte short, one zero byte long, zero,
    equal to n and above it; encoded messages that are well signed but
    wrongly padded (block type 02, a DigestInfo without its NULL, SHA-512's
    DigestInfo, an FF run one byte short, a broken FF run, a trailing
    byte); keys that are truncated DER, DER with a trailing byte, an
    rsaEncryption key without its NULL parameters, and an EC key; and valid
    signatures under keys at and past OpenSSL's size limits
    (``_rsa_size_lanes``), and keys of odd exponents and moduli that
    OpenSSL loads unchecked (``_rsa_exponent_lanes``). ``keys``
    are two (SPKI, PKCS#8) pairs to build them on, by default two made from
    the seed."""
    from ..crypto import ecdsa_host, rsa

    rng = random.Random(b"rsa lanes %d" % seed)
    (pub, priv), (other, _) = keys or (rsa.generate(rng), rsa.generate(rng))
    n, e = rsa.parse_public(pub)
    k = (n.bit_length() + 7) // 8
    msg = b"rsa adversarial %d" % seed
    sig = rsa.sign(priv, msg)
    h = hashlib.sha256(msg).digest()
    t = rsa.SHA256_DIGEST_INFO + h
    ff = k - len(t) - 3
    no_null = bytes.fromhex("302f300b0609608648016503040201") + bytes([0x04, 0x20]) + h
    sha512 = bytes.fromhex("3051300d060960864801650304020305000440") + \
        hashlib.sha512(msg).digest()
    ems = {
        "block_type_02": b"\x00\x02" + b"\xff" * ff + b"\x00" + t,
        "digestinfo_without_null": b"\x00\x01" + b"\xff" * (k - len(no_null) - 3) + b"\x00"
        + no_null,
        "other_hash_oid": b"\x00\x01" + b"\xff" * (k - len(sha512) - 3) + b"\x00" + sha512,
        "short_ff_run": b"\x00\x01" + b"\xff" * (ff - 1) + b"\x00\x00" + t,
        "broken_ff_run": b"\x00\x01" + b"\xff" * 20 + b"\xfe" + b"\xff" * (ff - 21) + b"\x00"
        + t,
        "trailing_byte": b"\x00\x01" + b"\xff" * (ff - 1) + b"\x00" + t + b"\x00",
    }
    lanes = [("valid", pub, sig, msg), ("altered_msg", pub, sig, msg + b"x"),
             ("flipped_sig_bit", pub, _flip(sig, 100), msg), ("wrong_key", other, sig, msg),
             ("sig_short", pub, sig[1:], msg), ("sig_long", pub, b"\x00" + sig, msg),
             ("sig_zero", pub, bytes(k), msg), ("sig_eq_n", pub, n.to_bytes(k, "big"), msg),
             ("sig_gt_n", pub, (n + 2).to_bytes(k, "big"), msg)]
    lanes += [(kind, pub, _rsa_raw_sign(priv, em), msg) for kind, em in ems.items()]
    no_params = rsa._seq(rsa._seq(rsa._tlv(0x06, rsa.RSA_OID)),
                         rsa._tlv(0x03, b"\x00" + rsa._seq(rsa._int(n), rsa._int(e))))
    cv = ecdsa_host.SECP256R1
    point = ecdsa_host.encode_point(ecdsa_host.base_mult(cv, 7), False)
    ec_key = rsa._seq(rsa._seq(rsa._tlv(0x06, bytes.fromhex("2a8648ce3d0201")),
                               rsa._tlv(0x06, bytes.fromhex("2a8648ce3d030107"))),
                      rsa._tlv(0x03, b"\x00" + point))
    lanes += [("key_truncated", pub[:-1], sig, msg), ("key_trailing_byte", pub + b"\x00", sig, msg),
              ("key_without_null", no_params, sig, msg), ("ec_key", ec_key, sig, msg)]
    return lanes + _rsa_size_lanes(seed, msg) + _rsa_exponent_lanes(pub, priv, sig, msg)


# ------------------------------------------------------------ notary traffic

# a time window that closed long before any run (2020-01-01, unix micros)
EXPIRED_UNTIL_MICROS = 1_577_836_800 * 1_000_000

# outcome kinds, in the order notary_stream places its adversarial requests
ADVERSARIAL_KINDS = (
    ("double_spend_in_window", "conflict"),
    ("double_spend_across_windows", "conflict"),
    ("tampered_signature", "invalid_signature"),
    ("output_changed_after_signing", "invalid_signature"),
    ("missing_signature", "missing_signature"),
    ("other_notary", "wrong_notary"),
    ("expired_time_window", "time_window"),
)
# and the kinds that only a validating notary rejects (a non-validating one
# signs them), placed after those with ``contract_invalid=True``
CONTRACT_INVALID_KINDS = (
    ("value_not_conserved", "value_not_conserved"),
    ("move_without_owner_signature", "unsigned_owner"),
    ("unresolvable_input", "unresolvable_input"),
)


def outcome_kind(result) -> str:
    """What a notary answered for one request: ``signed`` for a signature,
    else the kind of rejection. Read from the type's name and message, so
    the reference's answers classify the same way."""
    if type(result).__name__ == "TransactionSignature":
        return "signed"
    msg = str(result)
    if getattr(result, "conflict", None) is not None:
        return "conflict"
    if msg.startswith("signature check failed: invalid signature"):
        return "invalid_signature"
    if msg.startswith("signature check failed: missing signatures"):
        return "missing_signature"
    if msg.startswith("validation failed:"):
        if "value not conserved" in msg:
            return "value_not_conserved"
        if "input owners must sign a move" in msg:
            return "unsigned_owner"
        if "cannot be resolved" in msg:
            return "unresolvable_input"
    if "names a different notary" in msg:
        return "wrong_notary"
    if "time window" in msg:
        return "time_window"
    return f"other: {type(result).__name__}: {msg}"


def state_resolver(*wtxs):
    """``resolve(StateRef) -> TransactionState`` over the outputs of the
    given wire transactions (either package's: it reads only ``outputs``
    and ``out_ref``); an unknown ref raises ``LookupError``."""
    states = {}
    for wtx in wtxs:
        for i in range(len(wtx.outputs)):
            sr = wtx.out_ref(i)
            states[sr.ref] = sr.state

    def resolve(ref):
        try:
            return states[ref]
        except KeyError:
            raise LookupError(f"input state {ref} cannot be resolved") from None

    return resolve


@dataclasses.dataclass
class NotaryStream:
    """Windows of signed transactions for a notary, the kind each request
    must come back as (``kinds`` for a validating notary; a non-validating
    one signs the contract-invalid kinds, ``kinds_nonvalidating``), the
    identities behind them and the issue whose outputs the moves spend."""

    notary: object          # Party
    notary_keypair: object  # KeyPair
    alice: object           # Party
    issue: object           # SignedTransaction
    windows: list           # list[list[SignedTransaction]]
    kinds: list             # list[list[str]], outcome kinds per slot

    @property
    def kinds_nonvalidating(self) -> list:
        invalid = {kind for _name, kind in CONTRACT_INVALID_KINDS}
        return [["signed" if k in invalid else k for k in w] for w in self.kinds]

    def requests(self, caller: str = "alice") -> list:
        """The windows as ``process_stream`` takes them: (stx, state
        resolver, caller) triples, the resolver over the issue's outputs."""
        resolve = state_resolver(self.issue.tx)
        return [[(stx, resolve, caller) for stx in w] for w in self.windows]


def _party(tag: bytes):
    from ..crypto import derive_keypair_from_entropy
    from ..ledger import CordaX500Name, Party

    kp = derive_keypair_from_entropy(4, hashlib.sha256(tag).digest())
    return Party(CordaX500Name(tag.decode(), "London", "GB"), kp.public), kp


def notary_stream(n_moves: int, window: int, *, seed: int = 0,
                  contract_invalid: bool = False, device=None) -> NotaryStream:
    """``n_moves`` independent Cash moves (the shape of bench.py's
    ``make_notary_stream``) plus one request of each adversarial kind,
    cut into windows of ``window`` requests; with ``contract_invalid``
    also one request of each ``CONTRACT_INVALID_KINDS`` kind. Every
    request but those is a valid Cash transaction (the double spends move
    their input's whole value). The moves are signed in one
    ``ed25519_sign_batch`` on ``device`` (the card unless ``device="cpu"``)
    over ids computed by ``compute_tx_ids`` there; every id cache is left
    cold. The adversarial requests sit at known positions: the in-window
    double spend in window 0, the others from window 1 on."""
    from ..crypto import SecureHash
    from ..finance import CASH_PROGRAM_ID, CashState, Issue, Move
    from ..ledger import (
        Amount,
        Issued,
        PartyAndReference,
        PrivacySalt,
        SignedTransaction,
        StateAndRef,
        StateRef,
        TimeWindow,
        TransactionBuilder,
    )
    from ..ops.txid import compute_tx_ids

    if n_moves < window + 2 or window < 3:
        raise ValueError("need window >= 3 and n_moves >= window + 2")
    rng = random.Random(seed)
    alice, akp = _party(b"Alice Corp")
    bob, bkp = _party(b"Bob Inc")
    notary, nkp = _party(b"Notary Service")
    other, _ = _party(b"Other Notary")
    token = Issued(PartyAndReference(alice, b"\x01"), "GBP")
    n_spare = 6 if contract_invalid else 4  # outputs spent only by adversarial requests

    def builder(on=notary):
        b = TransactionBuilder(notary=on)
        b.set_privacy_salt(PrivacySalt(rng.randbytes(32)))
        return b

    b = builder()
    for i in range(n_moves + n_spare):
        b.add_output_state(CashState(Amount(100 + i, token), alice), CASH_PROGRAM_ID)
    b.add_command(Issue(), alice.owning_key)
    issue = b.sign_initial_transaction(akp)

    def move(i, owner=bob, amount=None, signers=(alice,), tw=None, on=notary,
             spend=None):
        mb = builder(on)
        if spend is not None:
            mb.add_input_state(spend)
        elif i is not None:
            mb.add_input_state(issue.tx.out_ref(i))
        mb.add_output_state(CashState(Amount(100 + i if amount is None else amount, token),
                                      owner), CASH_PROGRAM_ID)
        mb.add_command(Issue() if i is None and spend is None else Move(),
                       *[p.owning_key for p in signers])
        if tw is not None:
            mb.set_time_window(tw)
        return mb.to_wire_transaction()

    wtxs = [move(i) for i in range(n_moves)]
    adversarial = [
        move(0, owner=alice),                              # spends move 0's input
        move(1, owner=alice),                              # spends move 1's input
        move(n_moves),                                     # its signature is tampered
        move(n_moves + 1),                                 # its output changes after signing
        move(n_moves + 2, signers=(alice, bob)),           # Bob never signs
        move(None, amount=3, on=other),                    # an issue naming another notary
        move(n_moves + 3, tw=TimeWindow(until_time=EXPIRED_UNTIL_MICROS)),
    ]
    kinds = ADVERSARIAL_KINDS
    signer_of = {}  # adversarial index -> the keypair that signs it (else Alice)
    if contract_invalid:
        kinds = ADVERSARIAL_KINDS + CONTRACT_INVALID_KINDS
        signer_of[len(adversarial) + 1] = (bob, bkp)
        ghost = StateAndRef(issue.tx.outputs[0], StateRef(SecureHash(rng.randbytes(32)), 0))
        adversarial += [
            move(n_moves + 4, amount=100 + n_moves + 4 + 1),  # creates value
            move(n_moves + 5, signers=(bob,)),                 # Alice's input, Bob signs
            move(None, amount=100, spend=ghost),               # no such input state
        ]
    all_wtxs = wtxs + adversarial
    signers = [signer_of.get(k - n_moves, (alice, akp)) for k in range(len(all_wtxs))]
    ids = compute_tx_ids(all_wtxs, device=device)
    sigs = sign_tx_ids([(kp, i) for (_p, kp), i in zip(signers, ids)], device)
    stxs = [SignedTransaction.create(w, [s]) for w, s in zip(all_wtxs, sigs)]
    tampered = stxs[n_moves + 2]
    sig = tampered.sigs[0]
    stxs[n_moves + 2] = dataclasses.replace(tampered, sigs=(dataclasses.replace(
        sig, signature=sig.signature[:40] + bytes([sig.signature[40] ^ 1]) + sig.signature[41:]),))
    stxs[n_moves + 3] = SignedTransaction.create(
        move(n_moves + 1, amount=7), list(stxs[n_moves + 3].sigs))

    flat = list(zip(stxs[:n_moves], ["signed"] * n_moves))
    positions = [window // 2] + [window + 1 + k for k in range(len(adversarial) - 1)]
    for pos, stx, (_name, kind) in zip(positions, stxs[n_moves:], kinds):
        flat.insert(pos, (stx, kind))
    windows = [flat[i : i + window] for i in range(0, len(flat), window)]
    return NotaryStream(
        notary=notary, notary_keypair=nkp, alice=alice, issue=issue,
        windows=[[stx for stx, _k in w] for w in windows],
        kinds=[[k for _stx, k in w] for w in windows],
    )


# ------------------------------------------------------------ back-chains


def back_chain(hops: int, seed: int = 0, device=None, notarised: bool = False):
    """BASELINE config #4's back-chain, the shape of bench.py's
    ``make_back_chain``: one Cash issue, then ``hops`` self-moves, each
    spending the last one's output and signed by its owner only (the
    notary's signature is missing: a resolve allows it). With
    ``notarised`` every move also carries the notary's signature, as a
    chain a node received through finality does: the resolve flow, which
    allows no key to be missing, takes such a chain. The privacy
    salts come from ``seed``; the signatures are made in one
    ``ed25519_sign_batch`` on ``device`` (the card unless
    ``device="cpu"``). Returns (the chain in order, the notary); every id
    cache is left cold."""
    from ..finance import CASH_PROGRAM_ID, CashState, Issue, Move
    from ..ledger import (
        Amount,
        Issued,
        PartyAndReference,
        PrivacySalt,
        SignedTransaction,
        TransactionBuilder,
    )

    rng = random.Random(seed)
    alice, akp = _party(b"Chain Owner")
    notary, nkp = _party(b"Chain Notary")
    token = Issued(PartyAndReference(alice, b"\x03"), "GBP")

    def builder():
        b = TransactionBuilder(notary=notary)
        b.set_privacy_salt(PrivacySalt(rng.randbytes(32)))
        return b

    b = builder()
    b.add_output_state(CashState(Amount(1000, token), alice), CASH_PROGRAM_ID)
    b.add_command(Issue(), alice.owning_key)
    wtxs = [b.to_wire_transaction()]
    for _ in range(hops):
        mb = builder()
        mb.add_input_state(wtxs[-1].out_ref(0))
        mb.add_output_state(CashState(Amount(1000, token), alice), CASH_PROGRAM_ID)
        mb.add_command(Move(), alice.owning_key)
        wtxs.append(mb.to_wire_transaction())
    signers = [(akp,)] + [(akp, nkp) if notarised else (akp,)] * hops
    sigs = iter(sign_tx_ids(
        [(kp, wtx.id) for wtx, kps in zip(wtxs, signers) for kp in kps], device))
    # each SignedTransaction decodes its own copy of the wire transaction:
    # its id cache starts cold
    return [SignedTransaction.create(w, [next(sigs) for _ in kps])
            for w, kps in zip(wtxs, signers)], notary


def dag_tip(gen):
    """One move of a ``GeneratedLedger`` that spends every state it left
    unspent, signed by their owners and its notary: every transaction the
    ledger generated is in the tip's back-chain, so resolving the tip
    fetches the whole DAG. The ledger is left with no unspent state."""
    from .generated_ledger import GEN_CONTRACT_ID, GenAsset, GenCommand

    picked, gen.unspent = gen.unspent, []
    b = gen._builder()
    signer_keys = []
    for sar, owner in picked:
        b.add_input_state(sar)
        if owner.owning_key not in signer_keys:
            signer_keys.append(owner.owning_key)
    total = sum(sar.state.data.value for sar, _ in picked)
    b.add_output_state(GenAsset(total, gen.parties[0]), GEN_CONTRACT_ID)
    b.add_command(GenCommand("move"), *signer_keys)
    return gen._sign(b, signer_keys, with_notary=True)
