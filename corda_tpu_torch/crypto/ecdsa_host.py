"""Pure-Python ECDSA over secp256k1 and secp256r1.

Takes the place of the reference's OpenSSL calls for schemes 2 and 3
(corda_tpu/crypto/schemes.py:197-206 key derivation, :239-248 signing,
:283-298 verification): the machine with the card need not have the
``cryptography`` package, so the port's signer and host oracle need
nothing beyond the standard library.

- Key derivation is the reference's: d = SHA-512("ctpu.ecdsa" || entropy)
  mod (n - 1) + 1, the public key the X9.62 compressed point; the same
  entropy gives the same bytes in both packages.
- Signing uses the RFC 6979 section 3.2 deterministic nonce (HMAC-SHA-256)
  and is normalised to low S, so a seed reproduces every signature. The
  reference signs with OpenSSL's random nonce: the two give different
  bytes for one message, and each verifies under the other.
- ``verify`` is the host oracle, with the reference's canonical-form rule:
  64-byte r || s, 1 <= r < n, 1 <= s <= n // 2.

Points are affine (x, y) tuples, ``None`` the point at infinity; the
scalar multiplications run in Jacobian coordinates with 4-bit windows, and
the fixed base G through a table of 64 x 15 affine multiples.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import hmac


@dataclasses.dataclass(frozen=True)
class Curve:
    name: str
    p: int
    a: int
    b: int
    n: int
    gx: int
    gy: int


SECP256K1 = Curve(
    "secp256k1",
    p=2**256 - 2**32 - 977,
    a=0,
    b=7,
    n=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
    gx=0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    gy=0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
)

SECP256R1 = Curve(
    "secp256r1",
    p=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
    a=-3,
    b=0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,
    n=0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551,
    gx=0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
    gy=0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
)

CURVES = {c.name: c for c in (SECP256K1, SECP256R1)}


# ------------------------------------------------------ point arithmetic
# Jacobian (X, Y, Z): x = X / Z^2, y = Y / Z^3; Z = 0 is infinity.

_INF = (1, 1, 0)


def _jac_double(cv: Curve, pt):
    x, y, z = pt
    p = cv.p
    if z == 0 or y == 0:
        return _INF
    yy = y * y % p
    s = 4 * x * yy % p
    m = 3 * x * x
    if cv.a:
        m += cv.a * pow(z, 4, p)
    m %= p
    x3 = (m * m - 2 * s) % p
    y3 = (m * (s - x3) - 8 * yy * yy) % p
    return (x3, y3, 2 * y * z % p)


def _jac_add(cv: Curve, p1, p2):
    if p1[2] == 0:
        return p2
    if p2[2] == 0:
        return p1
    p = cv.p
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    z1z1, z2z2 = z1 * z1 % p, z2 * z2 % p
    u1, u2 = x1 * z2z2 % p, x2 * z1z1 % p
    s1, s2 = y1 * z2 * z2z2 % p, y2 * z1 * z1z1 % p
    if u1 == u2:
        return _jac_double(cv, p1) if s1 == s2 else _INF
    h, r = (u2 - u1) % p, (s2 - s1) % p
    hh = h * h % p
    hhh = h * hh % p
    v = u1 * hh % p
    x3 = (r * r - hhh - 2 * v) % p
    y3 = (r * (v - x3) - s1 * hhh) % p
    return (x3, y3, h * z1 * z2 % p)


def _to_affine(cv: Curve, pt):
    x, y, z = pt
    if z == 0:
        return None
    zi = pow(z, cv.p - 2, cv.p)
    zi2 = zi * zi % cv.p
    return (x * zi2 % cv.p, y * zi2 * zi % cv.p)


def _batch_affine(cv: Curve, pts):
    """Jacobian points with Z != 0 -> affine, with one inversion."""
    p = cv.p
    prefix, acc = [], 1
    for pt in pts:
        acc = acc * pt[2] % p
        prefix.append(acc)
    inv = pow(acc, p - 2, p)
    out = [None] * len(pts)
    for i in range(len(pts) - 1, -1, -1):
        zi = inv * prefix[i - 1] % p if i else inv
        inv = inv * pts[i][2] % p
        zi2 = zi * zi % p
        out[i] = (pts[i][0] * zi2 % p, pts[i][1] * zi2 * zi % p)
    return out


def point_add(cv: Curve, p1, p2):
    """Affine addition (``None`` is infinity)."""
    j1 = _INF if p1 is None else (p1[0], p1[1], 1)
    j2 = _INF if p2 is None else (p2[0], p2[1], 1)
    return _to_affine(cv, _jac_add(cv, j1, j2))


def point_neg(cv: Curve, pt):
    return None if pt is None else (pt[0], (-pt[1]) % cv.p)


def _window_table(cv: Curve, pt):
    """[1..15] * pt in Jacobian coordinates (index 0 unused)."""
    base = (pt[0], pt[1], 1)
    tbl = [_INF, base]
    for _ in range(14):
        tbl.append(_jac_add(cv, tbl[-1], base))
    return tbl


def _mul_jac(cv: Curve, k: int, pt):
    if pt is None or k % cv.n == 0:
        return _INF
    k %= cv.n
    tbl = _window_table(cv, pt)
    acc = _INF
    for i in range(63, -1, -1):
        for _ in range(4):
            acc = _jac_double(cv, acc)
        d = (k >> (4 * i)) & 15
        if d:
            acc = _jac_add(cv, acc, tbl[d])
    return acc


def scalar_mult(cv: Curve, k: int, pt):
    """k * pt for an affine point on the curve."""
    return _to_affine(cv, _mul_jac(cv, k, pt))


@functools.lru_cache(maxsize=2)
def _g_windows(name: str):
    """(16^i * j) * G for i = 0..63, j = 1..15, affine: 64 lists of 15."""
    cv = CURVES[name]
    rows = []
    base = (cv.gx, cv.gy, 1)
    for _i in range(64):
        row = [base]
        for _ in range(14):
            row.append(_jac_add(cv, row[-1], base))
        rows.append(row)
        base = _jac_add(cv, row[-1], base)  # 16 * base
    flat = _batch_affine(cv, [pt for row in rows for pt in row])
    return tuple(tuple(flat[15 * i : 15 * i + 15]) for i in range(64))


def _base_jac(cv: Curve, k: int):
    k %= cv.n
    rows = _g_windows(cv.name)
    acc = _INF
    for i in range(64):
        d = (k >> (4 * i)) & 15
        if d:
            x, y = rows[i][d - 1]
            acc = _jac_add(cv, acc, (x, y, 1))
    return acc


def base_mult(cv: Curve, k: int):
    """k * G."""
    return _to_affine(cv, _base_jac(cv, k))


# -------------------------------------------------------------- encodings


def encode_point(pt, compressed: bool = True) -> bytes:
    x, y = pt
    if compressed:
        return bytes([2 | (y & 1)]) + x.to_bytes(32, "big")
    return b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")


def decode_point(cv: Curve, encoded: bytes):
    """SEC1 compressed (33 bytes, prefix 2/3) or uncompressed (65 bytes,
    prefix 4) -> affine (x, y) on the curve, else ``None``; the rule of
    corda_tpu/ops/secp256.py:477-507."""
    p = cv.p
    if len(encoded) == 33 and encoded[0] in (2, 3):
        x = int.from_bytes(encoded[1:], "big")
        if x >= p:
            return None
        rhs = (pow(x, 3, p) + cv.a * x + cv.b) % p
        y = pow(rhs, (p + 1) // 4, p)  # both primes are 3 mod 4
        if y * y % p != rhs:
            return None
        if y & 1 != encoded[0] & 1:
            y = p - y
        return (x, y)
    if len(encoded) == 65 and encoded[0] == 4:
        x = int.from_bytes(encoded[1:33], "big")
        y = int.from_bytes(encoded[33:], "big")
        if x >= p or y >= p:
            return None
        if (y * y - pow(x, 3, p) - cv.a * x - cv.b) % p != 0:
            return None
        return (x, y)
    return None


# --------------------------------------------------------- keys and signing


def private_from_entropy(cv: Curve, entropy: bytes) -> int:
    """The reference's derivation: SHA-512("ctpu.ecdsa" || entropy) read
    big-endian, mod (n - 1), plus 1."""
    digest = hashlib.sha512(b"ctpu.ecdsa" + entropy).digest()
    return int.from_bytes(digest, "big") % (cv.n - 1) + 1


def public_from_private(cv: Curve, d: int) -> bytes:
    """The X9.62 compressed public key of d."""
    return encode_point(base_mult(cv, d))


def _rfc6979_nonces(cv: Curve, d: int, h1: bytes):
    """RFC 6979 section 3.2 candidates k for HMAC-SHA-256 (qlen = 256)."""
    x = d.to_bytes(32, "big")
    h1o = (int.from_bytes(h1, "big") % cv.n).to_bytes(32, "big")
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + x + h1o, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h1o, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < cv.n:
            yield cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def sign(cv: Curve, d: int, msg: bytes) -> bytes:
    """64-byte r || s (big-endian), deterministic nonce, low S."""
    h1 = hashlib.sha256(msg).digest()
    e = int.from_bytes(h1, "big")
    for k in _rfc6979_nonces(cv, d, h1):
        r = base_mult(cv, k)[0] % cv.n
        if r == 0:
            continue
        s = pow(k, cv.n - 2, cv.n) * (e + r * d) % cv.n
        if s == 0:
            continue
        if s > cv.n // 2:
            s = cv.n - s
        return r.to_bytes(32, "big") + s.to_bytes(32, "big")
    raise AssertionError("unreachable")


def verify(cv: Curve, pub: bytes, sig: bytes, msg: bytes) -> bool:
    """The host oracle: canonical form, then x(u1 G + u2 Q) mod n == r."""
    if len(sig) != 64:
        return False
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:], "big")
    if not (1 <= r < cv.n and 1 <= s <= cv.n // 2):
        return False
    q = decode_point(cv, bytes(pub))
    if q is None:
        return False
    e = int.from_bytes(hashlib.sha256(msg).digest(), "big")
    w = pow(s, cv.n - 2, cv.n)
    acc = _jac_add(cv, _base_jac(cv, e * w), _mul_jac(cv, r * w, q))
    pt = _to_affine(cv, acc)
    return pt is not None and pt[0] % cv.n == r
