"""Addition chains and batched inversion (copy of corda_tpu/ops/addchain.py).

The ref10 curve25519 chains for the two fixed exponents of p = 2^255 - 19:
a^(p-2) (inversion, 254 S + 11 M) and a^((p-5)/8) (the decompression
square root, 251 S + 11 M), over caller-supplied ``sq``/``mul`` hooks so
the plain torch field and host integers share one schedule. The CUDA
kernels run the same schedule (csrc/fe25519.cuh::ct_chain_core).
``batch_modinv`` is Montgomery's trick for the comb-table build.
"""

from __future__ import annotations

P25519 = 2**255 - 19

# (squarings, multiplies) of each chain
INV_CHAIN_OPS = (254, 11)
SQRT_CHAIN_OPS = (251, 11)


def _sq_loop(a, n, sq):
    for _ in range(n):
        a = sq(a)
    return a


def chain_25519_core(z, sq, mul, sq_n):
    """z -> (z^11, z^(2^250 - 1))."""
    z2 = sq(z)
    z8 = sq_n(z2, 2)
    z9 = mul(z, z8)
    z11 = mul(z2, z9)
    z22 = sq(z11)
    z_5 = mul(z9, z22)
    z_10 = mul(sq_n(z_5, 5), z_5)
    z_20 = mul(sq_n(z_10, 10), z_10)
    z_40 = mul(sq_n(z_20, 20), z_20)
    z_50 = mul(sq_n(z_40, 10), z_10)
    z_100 = mul(sq_n(z_50, 50), z_50)
    z_200 = mul(sq_n(z_100, 100), z_100)
    z_250 = mul(sq_n(z_200, 50), z_50)
    return z11, z_250


def pow_p_minus_2(z, sq, mul, sq_n=None):
    """z^(p-2): p - 2 = (2^250 - 1) * 2^5 + 11."""
    sq_n = sq_n or (lambda a, n: _sq_loop(a, n, sq))
    z11, z_250 = chain_25519_core(z, sq, mul, sq_n)
    return mul(sq_n(z_250, 5), z11)


def pow_p_minus_5_over_8(z, sq, mul, sq_n=None):
    """z^((p-5)/8): (p - 5)/8 = (2^250 - 1) * 2^2 + 1."""
    sq_n = sq_n or (lambda a, n: _sq_loop(a, n, sq))
    _z11, z_250 = chain_25519_core(z, sq, mul, sq_n)
    return mul(sq_n(z_250, 2), z)


def batch_modinv(values: list[int], m: int) -> list[int]:
    """Inverses of nonzero ``values`` mod ``m``: one exponentiation plus
    3(k - 1) multiplications."""
    k = len(values)
    if k == 0:
        return []
    prefix = [0] * k
    acc = 1
    for i, v in enumerate(values):
        acc = acc * v % m
        prefix[i] = acc
    inv_all = pow(acc, m - 2, m)
    out = [0] * k
    for i in range(k - 1, 0, -1):
        out[i] = inv_all * prefix[i - 1] % m
        inv_all = inv_all * values[i] % m
    out[0] = inv_all
    return out
