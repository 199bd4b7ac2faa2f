"""Seeded signature batches and adversarial lanes for the tests and chip_smoke.py.

Everything is signed with the port's pure-Python signer
(``crypto/ed25519_host.py``) from a seed, so a batch is the same wherever
it is made. ``adversarial_lanes`` returns one lane of each kind a verifier
must settle exactly like the reference; the oracle decides what "exactly"
means (``ed25519_host.verify``).
"""

from __future__ import annotations

import hashlib
import random

from .crypto.ed25519_host import (
    BASE,
    NEUTRAL,
    L,
    P,
    compress,
    decompress,
    point_add,
    public_from_seed,
    scalar_mul,
    sign,
)

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
