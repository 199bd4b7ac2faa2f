"""Pure-Python RFC 8032 ed25519 (copy of corda_tpu/crypto/_ed25519_fallback.py).

The port's host oracle and signer: key generation, signing and
verification over Python integers. It is slow, but needs nothing beyond
the standard library, so it also signs the batches that chip_smoke.py
drives through the kernels. Verification is
cofactorless with the challenge reduced mod L, the same rule as the
kernels.
"""

from __future__ import annotations

import hashlib

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)


def recover_x(y: int, sign: int) -> int | None:
    if y >= P:
        return None
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * SQRT_M1 % P
    if (x * x - x2) % P != 0:
        return None
    if (x & 1) != sign:
        x = P - x
    return x


# extended coordinates (X, Y, Z, T) with x = X/Z, y = Y/Z, T = XY/Z
NEUTRAL = (0, 1, 1, 0)


def point_add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * t1 * t2 * D % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def scalar_mul(s: int, p):
    q = NEUTRAL
    while s > 0:
        if s & 1:
            q = point_add(q, p)
        p = point_add(p, p)
        s >>= 1
    return q


BY = 4 * pow(5, P - 2, P) % P
BX = recover_x(BY, 0)
BASE = (BX, BY, 1, BX * BY % P)


def compress(p) -> bytes:
    x, y, z, _t = p
    zi = pow(z, P - 2, P)
    x, y = x * zi % P, y * zi % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def decompress(b: bytes):
    if len(b) != 32:
        return None
    enc = int.from_bytes(b, "little")
    y = enc & ((1 << 255) - 1)
    x = recover_x(y, enc >> 255)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def _clamp(h32: bytes) -> int:
    a = int.from_bytes(h32, "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a


def public_from_seed(seed: bytes) -> bytes:
    a = _clamp(hashlib.sha512(seed).digest()[:32])
    return compress(scalar_mul(a, BASE))


def sign(seed: bytes, msg: bytes) -> bytes:
    h = hashlib.sha512(seed).digest()
    a = _clamp(h[:32])
    pub = compress(scalar_mul(a, BASE))
    r = int.from_bytes(hashlib.sha512(h[32:] + msg).digest(), "little") % L
    rb = compress(scalar_mul(r, BASE))
    k = int.from_bytes(hashlib.sha512(rb + pub + msg).digest(), "little") % L
    s = (r + k * a) % L
    return rb + s.to_bytes(32, "little")


def verify(pub: bytes, sig: bytes, msg: bytes) -> bool:
    if len(sig) != 64:
        return False
    a = decompress(pub)
    rp = decompress(sig[:32])
    if a is None or rp is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    k = int.from_bytes(hashlib.sha512(sig[:32] + pub + msg).digest(), "little") % L
    lhs = scalar_mul(s, BASE)
    rhs = point_add(rp, scalar_mul(k, a))
    # compare projectively: X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1
    return (
        (lhs[0] * rhs[2] - rhs[0] * lhs[2]) % P == 0
        and (lhs[1] * rhs[2] - rhs[1] * lhs[2]) % P == 0
    )
