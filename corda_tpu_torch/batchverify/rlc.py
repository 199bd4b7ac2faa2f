"""The cofactored single-signature ed25519 rule of the reference's RLC route
(copy of corda_tpu/batchverify/rlc.py: ``_prepare``'s checks,
``_finish_decompress``, ``_verify_item``, ``verify_single`` and
``small_order_encodings``, with its point algebra).

The reference settles every ed25519 bucket that fills its ``min_bucket``
through one random-linear-combination check (``verify_batch_rlc``), and
falls back to bisection down to this per-signature rule; its verdicts equal
``verify_single`` row by row (rlc.py:28-34). The rule:

- lengths 32 and 64, s < L, y < p for A and for R;
- A and R decompress, the x = 0 encoding with the sign bit set rejected;
- A and R of small order (the 8 points of E[8]) rejected;
- accept iff 8 (sB - R - hA) is the identity, h = SHA-512(R || A || M)
  mod L.

The port runs full buckets on kernels B and G with this end (the
``cofactored`` launch) and holds them against this module; its host route
(``use_device=False``) settles full buckets here. The multi-scalar
multiplication and the bisection are not copied: they give the same
verdicts.
"""

from __future__ import annotations

import functools
import hashlib

from ..crypto.ed25519_host import BASE, D, L, P, SQRT_M1, recover_x
from ..ops.addchain import batch_modinv, pow_p_minus_5_over_8

_NEUTRAL = (0, 1, 1, 0)
_MASK255 = (1 << 255) - 1


# ------------------------------------------------------------ point algebra

def _add(p, q):
    """Complete extended-coordinate Edwards add."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * t1 * t2 * D % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _dbl(p):
    """Extended doubling (dbl-2008-hwcd)."""
    x, y, z, _t = p
    a = x * x % P
    b = y * y % P
    c = 2 * z * z % P
    e = ((x + y) * (x + y) - a - b) % P
    g = (b - a) % P
    f = (g - c) % P
    h = (-a - b) % P
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _neg(p):
    x, y, z, t = p
    return ((-x) % P, y, z, (-t) % P)


def _is_identity(p) -> bool:
    return p[0] % P == 0 and (p[1] - p[2]) % P == 0


def _mul_ext(k: int, p):
    q = _NEUTRAL
    while k > 0:
        if k & 1:
            q = _add(q, p)
        p = _dbl(p)
        k >>= 1
    return q


def _to_affine(p) -> tuple[int, int]:
    zi = pow(p[2], P - 2, P)
    return (p[0] * zi % P, p[1] * zi % P)


@functools.lru_cache(maxsize=1)
def _small_order_affine() -> frozenset:
    """The 8-torsion subgroup E[8] as affine pairs, derived: L times a
    curve point lands in the torsion, and the first of exact order 8
    generates all 8 points."""
    gen = None
    y = 2
    while gen is None:
        for sign in (0, 1):
            x = recover_x(y, sign)
            if x is None:
                continue
            q = _mul_ext(L, (x, y, 1, x * y % P))
            if not _is_identity(_dbl(_dbl(q))):
                gen = q
                break
        y += 1
    pts, cur = [], gen
    for _ in range(8):
        pts.append(_to_affine(cur))
        cur = _add(cur, gen)
    return frozenset(pts)


def small_order_encodings() -> list[bytes]:
    """The canonical compressed encodings of the 8 torsion points. With
    y >= p and x = 0 with the sign bit set rejected, they are the only
    encodings that decode to a small-order point."""
    return [
        (y | ((x & 1) << 255)).to_bytes(32, "little")
        for x, y in sorted(_small_order_affine())
    ]


# ------------------------------------------------------------ decompression

def _finish_decompress(y: int, sign: int, v_inv: int):
    """Decompression given 1/v for v = d y^2 + 1 (batched by the caller):
    the extended point, or None (not on the curve, or the x = 0 encoding
    with the sign bit set)."""
    u = (y * y - 1) % P
    x2 = u * v_inv % P
    if x2 == 0:
        return None if sign else (0, y, 1, 0)
    x = x2 * pow_p_minus_5_over_8(x2, lambda a: a * a % P, lambda a, b: a * b % P) % P
    if (x * x - x2) % P:
        x = x * SQRT_M1 % P
    if (x * x - x2) % P:
        return None
    if (x & 1) != sign:
        x = P - x
    return (x, y, 1, x * y % P)


def _prepare(entries):
    """The checks of the reference's ``_prepare``: (verdicts template,
    items), items = (row index, A, R, h, s) for the rows that pass."""
    verdicts = [False] * len(entries)
    cand = []
    for i, (pub, sig, msg) in enumerate(entries):
        if len(pub) != 32 or len(sig) != 64:
            continue
        enc_a = int.from_bytes(pub, "little")
        enc_r = int.from_bytes(sig[:32], "little")
        y_a, sign_a = enc_a & _MASK255, enc_a >> 255
        y_r, sign_r = enc_r & _MASK255, enc_r >> 255
        s = int.from_bytes(sig[32:], "little")
        if s >= L or y_a >= P or y_r >= P:
            continue
        h = int.from_bytes(hashlib.sha512(sig[:32] + pub + msg).digest(), "little") % L
        cand.append((i, y_a, sign_a, y_r, sign_r, s, h))
    vs = []
    for _i, y_a, _sa, y_r, _sr, _s, _h in cand:
        vs.append((D * y_a % P * y_a + 1) % P)
        vs.append((D * y_r % P * y_r + 1) % P)
    invs = batch_modinv(vs, P)
    small = _small_order_affine()
    items = []
    for k, (i, y_a, sign_a, y_r, sign_r, s, h) in enumerate(cand):
        a_pt = _finish_decompress(y_a, sign_a, invs[2 * k])
        r_pt = _finish_decompress(y_r, sign_r, invs[2 * k + 1])
        if a_pt is None or r_pt is None:
            continue
        if (a_pt[0], a_pt[1]) in small or (r_pt[0], r_pt[1]) in small:
            continue
        items.append((i, a_pt, r_pt, h, s))
    return verdicts, items


def _verify_item(item) -> bool:
    """8 (sB - R - hA) == identity, on decompressed points."""
    _i, a_pt, r_pt, h, s = item
    p = _add(_mul_ext(s, BASE), _add(_neg(r_pt), _neg(_mul_ext(h, a_pt))))
    return _is_identity(_dbl(_dbl(_dbl(p))))


def verify_rows(entries) -> list[bool]:
    """(pub32, sig64, msg) rows -> the cofactored rule's verdict a row (the
    verdicts of the reference's ``verify_batch_rlc``)."""
    verdicts, items = _prepare(entries)
    for item in items:
        verdicts[item[0]] = _verify_item(item)
    return verdicts


def verify_single(pub: bytes, sig: bytes, msg: bytes) -> bool:
    """The cofactored single-signature rule."""
    return verify_rows([(pub, sig, msg)])[0]
