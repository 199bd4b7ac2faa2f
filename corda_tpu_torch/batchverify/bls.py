"""Host-side min-pk BLS12-381 aggregate signatures (copy of
corda_tpu/batchverify/bls.py: the same keys, signatures and verdicts).

Pure Python-int arithmetic end to end — no jax, no OpenSSL — so the
scheme loads on the same minimal containers as the ed25519 fallback
tier. A device pairing kernel is explicitly out of scope for this PR;
the notary needs the *aggregation* property (one 96-byte signature per
quorum round instead of f+1 ed25519 attestations), not pairing
throughput, and every consensus round performs exactly ONE
aggregate-verify.

Layout (min-pk, the Ethereum/draft-irtf-cfrg-bls-signature convention):
public keys live in G1 (48-byte compressed), signatures in G2 (96-byte
compressed). Verification is the two-pairing product check

    e(-g1, sig) · e(pk, H(m)) == 1         (single)
    e(-g1, agg) · e(Σ pk_i, H(m)) == 1     (fast aggregate, same message)

Rogue-key attacks against aggregation are closed by
proof-of-possession: ``register_pop`` verifies a self-signature over the
public key under a separate domain tag and records the key in a
process-wide registry; ``fast_aggregate_verify`` refuses unregistered
keys by default.

Tower construction (standard): Fp2 = Fp[i]/(i²+1), Fp6 = Fp2[v]/(v³-ξ)
with ξ = 1+i, Fp12 = Fp6[w]/(w²-v). The pairing is an affine ate Miller
loop run entirely in Fp12 after untwisting the G2 point (M-type twist:
(x', y') → (x'/w², y'/w³)), with a single shared final exponentiation
for pairing products. The hard part of the final exponentiation is a
generic square-and-multiply by (p⁴-p²+1)/r — slower than the
cyclotomic-optimized ladder, irrelevant at one check per quorum round.

``hash_to_g2`` is domain-separated try-and-increment with cofactor
clearing by the exact BLS12 G2 cofactor polynomial — NOT the RFC 9380
simplified-SWU encoding. It is used only for this subsystem's own
attestations (both signer and verifier run this module), never for
interop with external BLS stacks; the r·H(m) == O subgroup pin lives in
the test suite.
"""

from __future__ import annotations

import functools
import hashlib
import secrets

# ------------------------------------------------------------- parameters

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
_X = -0xD201000000010000  # the (negative) BLS12 curve parameter

_G1X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
_G1Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1
_G2X = (
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
_G2Y = (
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)

# the exact G2 cofactor, from the BLS12 family polynomial evaluated at x
_H2 = (
    _X**8 - 4 * _X**7 + 5 * _X**6 - 4 * _X**4 + 6 * _X**3 - 4 * _X**2 - 4 * _X + 13
) // 9

DST_MSG = b"ctpu-bls-sig-v1:"
DST_POP = b"ctpu-bls-pop-v1:"

PUBLIC_KEY_BYTES = 48
SIGNATURE_BYTES = 96

_INV2 = pow(2, P - 2, P)
_HALF = (P - 1) // 2


class BLSError(ValueError):
    """Malformed encoding or group-membership failure."""


# ------------------------------------------------------------------- Fp2
# elements are (a0, a1) for a0 + a1·i, i² = -1

_FP2_ZERO = (0, 0)
_FP2_ONE = (1, 0)


def _fp2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def _fp2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def _fp2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def _fp2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = a0 * b0
    t1 = a1 * b1
    return ((t0 - t1) % P, ((a0 + a1) * (b0 + b1) - t0 - t1) % P)


def _fp2_sqr(a):
    a0, a1 = a
    return ((a0 + a1) * (a0 - a1) % P, 2 * a0 * a1 % P)


def _fp2_scale(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


def _fp2_inv(a):
    """Conjugate/norm inversion: one Fp exponentiation per call."""
    a0, a1 = a
    ninv = pow(a0 * a0 + a1 * a1, P - 2, P)
    return (a0 * ninv % P, (-a1) * ninv % P)


def _fp2_pow(a, e: int):
    out = _FP2_ONE
    while e > 0:
        if e & 1:
            out = _fp2_mul(out, a)
        a = _fp2_sqr(a)
        e >>= 1
    return out


def _fp2_mul_xi(a):
    """Multiply by the Fp6 non-residue ξ = 1 + i."""
    a0, a1 = a
    return ((a0 - a1) % P, (a0 + a1) % P)


def _fp2_sqrt(a):
    """Square root in Fp2 via the complex method (p ≡ 3 mod 4), or None.
    The result is verified by squaring, so a wrong branch can never leak
    a bogus root."""
    a0, a1 = a
    if a1 == 0:
        s = pow(a0, (P + 1) // 4, P)
        if s * s % P == a0:
            return (s, 0)
        s = pow((-a0) % P, (P + 1) // 4, P)
        if s * s % P == (-a0) % P:
            return (0, s)
        return None
    n = (a0 * a0 + a1 * a1) % P
    s = pow(n, (P + 1) // 4, P)
    if s * s % P != n:
        return None
    for t in ((a0 + s) * _INV2 % P, (a0 - s) * _INV2 % P):
        x = pow(t, (P + 1) // 4, P)
        if x * x % P == t and x != 0:
            y = a1 * pow(2 * x, P - 2, P) % P
            if _fp2_sqr((x, y)) == (a0 % P, a1 % P):
                return (x, y)
    return None


# ------------------------------------------------------------------- Fp6
# elements are (c0, c1, c2) over Fp2 for c0 + c1·v + c2·v², v³ = ξ

_FP6_ZERO = (_FP2_ZERO, _FP2_ZERO, _FP2_ZERO)
_FP6_ONE = (_FP2_ONE, _FP2_ZERO, _FP2_ZERO)


def _fp6_add(a, b):
    return tuple(_fp2_add(x, y) for x, y in zip(a, b))


def _fp6_sub(a, b):
    return tuple(_fp2_sub(x, y) for x, y in zip(a, b))


def _fp6_neg(a):
    return tuple(_fp2_neg(x) for x in a)


def _fp6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = _fp2_mul(a0, b0)
    t1 = _fp2_mul(a1, b1)
    t2 = _fp2_mul(a2, b2)
    c0 = _fp2_add(
        t0,
        _fp2_mul_xi(
            _fp2_sub(
                _fp2_sub(_fp2_mul(_fp2_add(a1, a2), _fp2_add(b1, b2)), t1), t2
            )
        ),
    )
    c1 = _fp2_add(
        _fp2_sub(
            _fp2_sub(_fp2_mul(_fp2_add(a0, a1), _fp2_add(b0, b1)), t0), t1
        ),
        _fp2_mul_xi(t2),
    )
    c2 = _fp2_add(
        _fp2_sub(
            _fp2_sub(_fp2_mul(_fp2_add(a0, a2), _fp2_add(b0, b2)), t0), t2
        ),
        t1,
    )
    return (c0, c1, c2)


def _fp6_mul_v(a):
    """Multiply by v: (c0, c1, c2) → (ξ·c2, c0, c1)."""
    return (_fp2_mul_xi(a[2]), a[0], a[1])


def _fp6_inv(a):
    a0, a1, a2 = a
    c0 = _fp2_sub(_fp2_sqr(a0), _fp2_mul_xi(_fp2_mul(a1, a2)))
    c1 = _fp2_sub(_fp2_mul_xi(_fp2_sqr(a2)), _fp2_mul(a0, a1))
    c2 = _fp2_sub(_fp2_sqr(a1), _fp2_mul(a0, a2))
    t = _fp2_add(
        _fp2_mul(a0, c0),
        _fp2_mul_xi(_fp2_add(_fp2_mul(a2, c1), _fp2_mul(a1, c2))),
    )
    tinv = _fp2_inv(t)
    return (_fp2_mul(c0, tinv), _fp2_mul(c1, tinv), _fp2_mul(c2, tinv))


# ------------------------------------------------------------------ Fp12
# elements are (d0, d1) over Fp6 for d0 + d1·w, w² = v

_FP12_ZERO = (_FP6_ZERO, _FP6_ZERO)
FP12_ONE = (_FP6_ONE, _FP6_ZERO)


def _fp12_add(a, b):
    return (_fp6_add(a[0], b[0]), _fp6_add(a[1], b[1]))


def _fp12_sub(a, b):
    return (_fp6_sub(a[0], b[0]), _fp6_sub(a[1], b[1]))


def _fp12_neg(a):
    return (_fp6_neg(a[0]), _fp6_neg(a[1]))


def _fp12_mul(a, b):
    t0 = _fp6_mul(a[0], b[0])
    t1 = _fp6_mul(a[1], b[1])
    c1 = _fp6_sub(
        _fp6_sub(_fp6_mul(_fp6_add(a[0], a[1]), _fp6_add(b[0], b[1])), t0),
        t1,
    )
    return (_fp6_add(t0, _fp6_mul_v(t1)), c1)


def _fp12_conj(a):
    """Conjugation over Fp6 = the p⁶-power Frobenius."""
    return (a[0], _fp6_neg(a[1]))


def _fp12_inv(a):
    t = _fp6_sub(_fp6_mul(a[0], a[0]), _fp6_mul_v(_fp6_mul(a[1], a[1])))
    tinv = _fp6_inv(t)
    return (_fp6_mul(a[0], tinv), _fp6_neg(_fp6_mul(a[1], tinv)))


def _fp12_pow(a, e: int):
    out = FP12_ONE
    while e > 0:
        if e & 1:
            out = _fp12_mul(out, a)
        a = _fp12_mul(a, a)
        e >>= 1
    return out


# p²-power Frobenius: in the w-basis the coefficient of w^k picks up
# δ^k with δ = ξ^((p²-1)/6) (an Fp2 constant, computed once at import)
_DELTA = _fp2_pow(_fp2_mul_xi(_FP2_ONE), (P * P - 1) // 6)
_DELTA_POWS = [_FP2_ONE]
for _k in range(5):
    _DELTA_POWS.append(_fp2_mul(_DELTA_POWS[-1], _DELTA))


def _fp12_frob_p2(a):
    (a0, a1, a2), (b0, b1, b2) = a
    d = _DELTA_POWS
    return (
        (a0, _fp2_mul(a1, d[2]), _fp2_mul(a2, d[4])),
        (
            _fp2_mul(b0, d[1]),
            _fp2_mul(b1, d[3]),
            _fp2_mul(b2, d[5]),
        ),
    )


# ------------------------------------------------- generic Jacobian groups

class _Field:
    """Tiny field-op bundle so ONE Jacobian implementation serves both
    G1 (Fp ints) and G2 (Fp2 pairs)."""

    __slots__ = ("add", "sub", "mul", "sqr", "neg", "inv", "zero", "one")

    def __init__(self, add, sub, mul, sqr, neg, inv, zero, one):
        self.add, self.sub, self.mul, self.sqr = add, sub, mul, sqr
        self.neg, self.inv, self.zero, self.one = neg, inv, zero, one


_F1 = _Field(
    add=lambda a, b: (a + b) % P,
    sub=lambda a, b: (a - b) % P,
    mul=lambda a, b: a * b % P,
    sqr=lambda a: a * a % P,
    neg=lambda a: (-a) % P,
    inv=lambda a: pow(a, P - 2, P),
    zero=0,
    one=1,
)
_F2 = _Field(
    add=_fp2_add,
    sub=_fp2_sub,
    mul=_fp2_mul,
    sqr=_fp2_sqr,
    neg=_fp2_neg,
    inv=_fp2_inv,
    zero=_FP2_ZERO,
    one=_FP2_ONE,
)

# curve constants b (G1: y² = x³ + 4) and b' = 4ξ (G2, M-type twist)
_B1 = 4
_B2 = (4, 4)


def _jac_is_inf(pt, f):
    return pt[2] == f.zero


def _jac_dbl(pt, f):
    if _jac_is_inf(pt, f):
        return pt
    x, y, z = pt
    a = f.sqr(x)
    b = f.sqr(y)
    c = f.sqr(b)
    d = f.sub(f.sub(f.sqr(f.add(x, b)), a), c)
    d = f.add(d, d)
    e = f.add(f.add(a, a), a)
    g = f.sqr(e)
    x3 = f.sub(g, f.add(d, d))
    c8 = f.add(c, c)
    c8 = f.add(c8, c8)
    c8 = f.add(c8, c8)
    y3 = f.sub(f.mul(e, f.sub(d, x3)), c8)
    z3 = f.mul(f.add(y, y), z)
    return (x3, y3, z3)


def _jac_add(p1, p2, f):
    if _jac_is_inf(p1, f):
        return p2
    if _jac_is_inf(p2, f):
        return p1
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    z1z1 = f.sqr(z1)
    z2z2 = f.sqr(z2)
    u1 = f.mul(x1, z2z2)
    u2 = f.mul(x2, z1z1)
    s1 = f.mul(f.mul(y1, z2), z2z2)
    s2 = f.mul(f.mul(y2, z1), z1z1)
    if u1 == u2:
        if s1 == s2:
            return _jac_dbl(p1, f)
        return (f.one, f.one, f.zero)
    h = f.sub(u2, u1)
    i = f.sqr(f.add(h, h))
    j = f.mul(h, i)
    rr = f.sub(s2, s1)
    rr = f.add(rr, rr)
    v = f.mul(u1, i)
    x3 = f.sub(f.sub(f.sqr(rr), j), f.add(v, v))
    s1j = f.mul(s1, j)
    y3 = f.sub(f.mul(rr, f.sub(v, x3)), f.add(s1j, s1j))
    z3 = f.mul(f.sub(f.sub(f.sqr(f.add(z1, z2)), z1z1), z2z2), h)
    return (x3, y3, z3)


def _jac_neg(pt, f):
    return (pt[0], f.neg(pt[1]), pt[2])


def _jac_mul(pt, k: int, f):
    if k < 0:
        return _jac_mul(_jac_neg(pt, f), -k, f)
    out = (f.one, f.one, f.zero)
    for i in range(k.bit_length() - 1, -1, -1):
        out = _jac_dbl(out, f)
        if (k >> i) & 1:
            out = _jac_add(out, pt, f)
    return out


def _jac_to_affine(pt, f):
    """→ (x, y) or None for infinity."""
    if _jac_is_inf(pt, f):
        return None
    zi = f.inv(pt[2])
    zi2 = f.sqr(zi)
    return (f.mul(pt[0], zi2), f.mul(f.mul(pt[1], zi2), zi))


def _on_curve(aff, f, b) -> bool:
    if aff is None:
        return True
    x, y = aff
    return f.sqr(y) == f.add(f.mul(f.sqr(x), x), b)


_G1_GEN = (_G1X, _G1Y, 1)
_G2_GEN = (_G2X, _G2Y, _FP2_ONE)
assert _on_curve((_G1X, _G1Y), _F1, _B1)
assert _on_curve((_G2X, _G2Y), _F2, _B2)


# ----------------------------------------------------------------- pairing

def _fp12_from_fp(a: int):
    return (((a % P, 0), _FP2_ZERO, _FP2_ZERO), _FP6_ZERO)


def _fp12_from_fp2(a):
    return ((a, _FP2_ZERO, _FP2_ZERO), _FP6_ZERO)


# w as an Fp12 element, and the untwist factors 1/w², 1/w³
_W = (_FP6_ZERO, _FP6_ONE)
_W2_INV = _fp12_inv(_fp12_mul(_W, _W))
_W3_INV = _fp12_inv(_fp12_mul(_fp12_mul(_W, _W), _W))


def _untwist(aff2):
    """E'(Fp2) → E(Fp12) for the M-type twist: (x', y') → (x'/w², y'/w³)."""
    if aff2 is None:
        return None
    x, y = aff2
    return (
        _fp12_mul(_fp12_from_fp2(x), _W2_INV),
        _fp12_mul(_fp12_from_fp2(y), _W3_INV),
    )


def _line_dbl(r, p_at):
    """Tangent line at R evaluated at P, plus 2R (affine Fp12)."""
    xr, yr = r
    xp, yp = p_at
    xr2 = _fp12_mul(xr, xr)
    m = _fp12_mul(
        _fp12_add(_fp12_add(xr2, xr2), xr2), _fp12_inv(_fp12_add(yr, yr))
    )
    line = _fp12_sub(_fp12_mul(m, _fp12_sub(xp, xr)), _fp12_sub(yp, yr))
    x2 = _fp12_sub(_fp12_mul(m, m), _fp12_add(xr, xr))
    y2 = _fp12_sub(_fp12_mul(m, _fp12_sub(xr, x2)), yr)
    return line, (x2, y2)


def _line_add(r, q, p_at):
    """Chord through R and Q evaluated at P, plus R+Q (affine Fp12).
    The Miller loop below never meets R = ±Q mid-loop (the loop count is
    far below the group order), so the vertical-line case cannot occur."""
    xr, yr = r
    xq, yq = q
    xp, yp = p_at
    m = _fp12_mul(_fp12_sub(yq, yr), _fp12_inv(_fp12_sub(xq, xr)))
    line = _fp12_sub(_fp12_mul(m, _fp12_sub(xp, xr)), _fp12_sub(yp, yr))
    x3 = _fp12_sub(_fp12_sub(_fp12_mul(m, m), xr), xq)
    y3 = _fp12_sub(_fp12_mul(m, _fp12_sub(xr, x3)), yr)
    return line, (x3, y3)


def _miller_loop(q12, p12):
    """Affine ate Miller loop over |x|; the caller conjugates for x < 0."""
    if q12 is None or p12 is None:
        return FP12_ONE
    t = abs(_X)
    f = FP12_ONE
    r = q12
    for i in range(t.bit_length() - 2, -1, -1):
        line, r = _line_dbl(r, p12)
        f = _fp12_mul(_fp12_mul(f, f), line)
        if (t >> i) & 1:
            line, r = _line_add(r, q12, p12)
            f = _fp12_mul(f, line)
    return _fp12_conj(f)  # x < 0


_HARD_EXP = (P**4 - P**2 + 1) // R


def _final_exponentiate(f):
    """(p¹²-1)/r = (p⁶-1)·(p²+1)·((p⁴-p²+1)/r): cheap Frobenius easy
    part, generic square-and-multiply hard part."""
    f = _fp12_mul(_fp12_conj(f), _fp12_inv(f))
    f = _fp12_mul(_fp12_frob_p2(f), f)
    return _fp12_pow(f, _HARD_EXP)


def _pairing_product_is_one(pairs) -> bool:
    """Π e(P_i, Q_i) == 1 with one shared final exponentiation.
    ``pairs`` holds (G1 jacobian, G2 jacobian); identity members
    contribute a factor of 1 and are skipped."""
    f = FP12_ONE
    for g1pt, g2pt in pairs:
        a1 = _jac_to_affine(g1pt, _F1)
        a2 = _jac_to_affine(g2pt, _F2)
        if a1 is None or a2 is None:
            continue
        p12 = (_fp12_from_fp(a1[0]), _fp12_from_fp(a1[1]))
        f = _fp12_mul(f, _miller_loop(_untwist(a2), p12))
    return _final_exponentiate(f) == FP12_ONE


# ------------------------------------------------------------ serialization
# ZCash-style compressed flags: 0x80 = compressed (always set),
# 0x40 = infinity, 0x20 = y lexicographically "large"

def _fp2_sgn(y) -> int:
    y0, y1 = y
    if y1 != 0:
        return 1 if y1 > _HALF else 0
    return 1 if y0 > _HALF else 0


def g1_compress(pt) -> bytes:
    aff = _jac_to_affine(pt, _F1)
    if aff is None:
        return bytes([0xC0]) + bytes(47)
    x, y = aff
    flags = 0x80 | (0x20 if y > _HALF else 0)
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= flags
    return bytes(out)


def g1_decompress(blob: bytes):
    if len(blob) != PUBLIC_KEY_BYTES:
        raise BLSError("G1 point must be 48 bytes")
    flags = blob[0] & 0xE0
    if not flags & 0x80:
        raise BLSError("uncompressed G1 encoding not supported")
    if flags & 0x40:
        if any(blob[1:]) or blob[0] != 0xC0:
            raise BLSError("malformed G1 infinity encoding")
        return (1, 1, 0)
    x = int.from_bytes(bytes([blob[0] & 0x1F]) + blob[1:], "big")
    if x >= P:
        raise BLSError("G1 x coordinate out of range")
    y2 = (x * x % P * x + _B1) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        raise BLSError("G1 x is not on the curve")
    if (y > _HALF) != bool(flags & 0x20):
        y = P - y
    return (x, y, 1)


def g2_compress(pt) -> bytes:
    aff = _jac_to_affine(pt, _F2)
    if aff is None:
        return bytes([0xC0]) + bytes(95)
    (x0, x1), y = aff
    flags = 0x80 | (0x20 if _fp2_sgn(y) else 0)
    out = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    out[0] |= flags
    return bytes(out)


def g2_decompress(blob: bytes):
    if len(blob) != SIGNATURE_BYTES:
        raise BLSError("G2 point must be 96 bytes")
    flags = blob[0] & 0xE0
    if not flags & 0x80:
        raise BLSError("uncompressed G2 encoding not supported")
    if flags & 0x40:
        if any(blob[1:]) or blob[0] != 0xC0:
            raise BLSError("malformed G2 infinity encoding")
        return (_FP2_ONE, _FP2_ONE, _FP2_ZERO)
    x1 = int.from_bytes(bytes([blob[0] & 0x1F]) + blob[1:48], "big")
    x0 = int.from_bytes(blob[48:], "big")
    if x0 >= P or x1 >= P:
        raise BLSError("G2 x coordinate out of range")
    x = (x0, x1)
    y2 = _fp2_add(_fp2_mul(_fp2_sqr(x), x), _B2)
    y = _fp2_sqrt(y2)
    if y is None:
        raise BLSError("G2 x is not on the curve")
    if _fp2_sgn(y) != (1 if flags & 0x20 else 0):
        y = _fp2_neg(y)
    return (x, y, _FP2_ONE)


# --------------------------------------------------------------- hash to G2

@functools.lru_cache(maxsize=512)
def hash_to_g2(msg: bytes, dst: bytes = DST_MSG):
    """Domain-separated try-and-increment onto G2, cofactor-cleared by
    the exact BLS12 cofactor polynomial so the output lands in the
    r-order subgroup (test-pinned: r·H(m) == O). Cached: one quorum
    round hashes the same outcome bytes on every replica AND the
    aggregating client."""
    ctr = 0
    while True:
        seed = dst + len(msg).to_bytes(8, "big") + msg + ctr.to_bytes(4, "big")
        h0 = int.from_bytes(hashlib.sha512(seed + b"\x00").digest(), "big") % P
        h1 = int.from_bytes(hashlib.sha512(seed + b"\x01").digest(), "big") % P
        x = (h0, h1)
        y = _fp2_sqrt(_fp2_add(_fp2_mul(_fp2_sqr(x), x), _B2))
        if y is not None:
            pt = _jac_mul((x, y, _FP2_ONE), _H2, _F2)
            if not _jac_is_inf(pt, _F2):
                return pt
        ctr += 1


# ---------------------------------------------------------------- key mgmt

def derive_keypair_from_entropy(entropy: bytes) -> tuple[bytes, bytes]:
    """→ (public 48B, private 32B). Deterministic: the BFT test clusters
    derive per-replica keys from replica names so the proof-of-possession
    registry memoizes across in-process clusters."""
    sk = int.from_bytes(
        hashlib.sha512(b"ctpu.bls.sk" + entropy).digest(), "big"
    ) % R
    if sk == 0:
        sk = 1
    pk = g1_compress(_jac_mul(_G1_GEN, sk, _F1))
    return pk, sk.to_bytes(32, "big")


def generate_keypair() -> tuple[bytes, bytes]:
    return derive_keypair_from_entropy(secrets.token_bytes(32))


def _sk_int(private: bytes) -> int:
    if len(private) != 32:
        raise BLSError("BLS private key must be 32 bytes")
    sk = int.from_bytes(private, "big")
    if not 0 < sk < R:
        raise BLSError("BLS private scalar out of range")
    return sk


def public_key(private: bytes) -> bytes:
    return g1_compress(_jac_mul(_G1_GEN, _sk_int(private), _F1))


def public_key_on_curve(public: bytes) -> bool:
    """Decompression doubles as the on-curve check; the r-order subgroup
    membership is additionally enforced (cheap relative to a pairing,
    and it makes every accepted key a valid aggregation summand)."""
    try:
        pt = g1_decompress(public)
    except BLSError:
        return False
    if _jac_is_inf(pt, _F1):
        return False
    return _jac_is_inf(_jac_mul(pt, R, _F1), _F1)


# ------------------------------------------------------------------ signing

def sign(private: bytes, message: bytes, dst: bytes = DST_MSG) -> bytes:
    return g2_compress(_jac_mul(hash_to_g2(message, dst), _sk_int(private), _F2))


def verify(public: bytes, message: bytes, signature: bytes,
           dst: bytes = DST_MSG) -> bool:
    """Single-signature check e(-g1, sig)·e(pk, H(m)) == 1."""
    try:
        pk = g1_decompress(public)
        sig = g2_decompress(signature)
    except BLSError:
        return False
    if _jac_is_inf(pk, _F1) or _jac_is_inf(sig, _F2):
        return False
    return _pairing_product_is_one(
        [(_jac_neg(_G1_GEN, _F1), sig), (pk, hash_to_g2(message, dst))]
    )


def aggregate(signatures) -> bytes:
    """Sum of G2 signature points → one 96-byte aggregate."""
    if not signatures:
        raise BLSError("cannot aggregate zero signatures")
    acc = (_FP2_ONE, _FP2_ONE, _FP2_ZERO)
    for sig in signatures:
        acc = _jac_add(acc, g2_decompress(sig), _F2)
    return g2_compress(acc)


def fast_aggregate_verify(publics, message: bytes, signature: bytes, *,
                          require_pop: bool = True) -> bool:
    """Same-message aggregate check e(-g1, agg)·e(Σ pk_i, H(m)) == 1.
    With ``require_pop`` (the default) every key must have passed
    proof-of-possession registration — the defense that makes the
    Σ pk_i shortcut safe against rogue-key aggregation."""
    if not publics:
        return False
    if require_pop and any(pk not in _POP_REGISTRY for pk in publics):
        return False
    try:
        sig = g2_decompress(signature)
        apk = (1, 1, 0)
        for pk in publics:
            apk = _jac_add(apk, g1_decompress(pk), _F1)
    except BLSError:
        return False
    if _jac_is_inf(apk, _F1) or _jac_is_inf(sig, _F2):
        return False
    return _pairing_product_is_one(
        [(_jac_neg(_G1_GEN, _F1), sig), (apk, hash_to_g2(message, DST_MSG))]
    )


# ------------------------------------------------------- proof of possession

_POP_REGISTRY: set = set()


def prove_possession(private: bytes) -> bytes:
    """Self-signature over the public key under the PoP domain tag."""
    return sign(private, public_key(private), dst=DST_POP)


def verify_possession(public: bytes, pop: bytes) -> bool:
    return verify(public, public, pop, dst=DST_POP)


def register_pop(public: bytes, pop: bytes) -> bool:
    """Verify a proof of possession and admit the key to the
    process-wide registry consulted by ``fast_aggregate_verify``.
    Idempotent; a registered key skips the (pairing-priced) re-check."""
    if public in _POP_REGISTRY:
        return True
    if not public_key_on_curve(public) or not verify_possession(public, pop):
        return False
    _POP_REGISTRY.add(public)
    return True


def is_registered(public: bytes) -> bool:
    return public in _POP_REGISTRY
