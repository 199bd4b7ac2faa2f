"""Plain single-block SHA-512 in PyTorch (counterpart of corda_tpu/ops/sha512.py:94,148).

The plain half of kernel A (csrc/sha512_modl.cuh): one compression of a
padded 128-byte block from the standard initial state. Words travel as
big-endian 32-bit (hi, lo) pairs like the reference's W64, each half held
in int64 and masked to 32 bits: torch's uint32 has no shifts or adds on the
CPU, and int64 keeps every intermediate exact.
"""

from __future__ import annotations

import torch

# fmt: off
K64 = [
    0x428a2f98d728ae22, 0x7137449123ef65cd, 0xb5c0fbcfec4d3b2f, 0xe9b5dba58189dbbc,
    0x3956c25bf348b538, 0x59f111f1b605d019, 0x923f82a4af194f9b, 0xab1c5ed5da6d8118,
    0xd807aa98a3030242, 0x12835b0145706fbe, 0x243185be4ee4b28c, 0x550c7dc3d5ffb4e2,
    0x72be5d74f27b896f, 0x80deb1fe3b1696b1, 0x9bdc06a725c71235, 0xc19bf174cf692694,
    0xe49b69c19ef14ad2, 0xefbe4786384f25e3, 0x0fc19dc68b8cd5b5, 0x240ca1cc77ac9c65,
    0x2de92c6f592b0275, 0x4a7484aa6ea6e483, 0x5cb0a9dcbd41fbd4, 0x76f988da831153b5,
    0x983e5152ee66dfab, 0xa831c66d2db43210, 0xb00327c898fb213f, 0xbf597fc7beef0ee4,
    0xc6e00bf33da88fc2, 0xd5a79147930aa725, 0x06ca6351e003826f, 0x142929670a0e6e70,
    0x27b70a8546d22ffc, 0x2e1b21385c26c926, 0x4d2c6dfc5ac42aed, 0x53380d139d95b3df,
    0x650a73548baf63de, 0x766a0abb3c77b2a8, 0x81c2c92e47edaee6, 0x92722c851482353b,
    0xa2bfe8a14cf10364, 0xa81a664bbc423001, 0xc24b8b70d0f89791, 0xc76c51a30654be30,
    0xd192e819d6ef5218, 0xd69906245565a910, 0xf40e35855771202a, 0x106aa07032bbd1b8,
    0x19a4c116b8d2d0c8, 0x1e376c085141ab53, 0x2748774cdf8eeb99, 0x34b0bcb5e19b48a8,
    0x391c0cb3c5c95a63, 0x4ed8aa4ae3418acb, 0x5b9cca4f7763e373, 0x682e6ff3d6b2b8a3,
    0x748f82ee5defb2fc, 0x78a5636f43172f60, 0x84c87814a1f0ab72, 0x8cc702081a6439ec,
    0x90befffa23631e28, 0xa4506cebde82bde9, 0xbef9a3f7b2c67915, 0xc67178f2e372532b,
    0xca273eceea26619c, 0xd186b8c721c0c207, 0xeada7dd6cde0eb1e, 0xf57d4f7fee6ed178,
    0x06f067aa72176fba, 0x0a637dc5a2c898a6, 0x113f9804bef90dae, 0x1b710b35131c471b,
    0x28db77f523047d84, 0x32caab7b40c72493, 0x3c9ebe0a15c9bebc, 0x431d67c49c100d4c,
    0x4cc5d4becb3e42b6, 0x597f299cfc657e2a, 0x5fcb6fab3ad6faec, 0x6c44198c4a475817,
]
H0_64 = [
    0x6a09e667f3bcc908, 0xbb67ae8584caa73b, 0x3c6ef372fe94f82b, 0xa54ff53a5f1d36f1,
    0x510e527fade682d1, 0x9b05688c2b3e6c1f, 0x1f83d9abfb41bd6b, 0x5be0cd19137e2179,
]
# fmt: on

M32 = 0xFFFFFFFF


def block_words(packed: torch.Tensor) -> torch.Tensor:
    """(B, >=128) uint8 rows -> (B, 32) int64 big-endian 32-bit words of
    the first 128 bytes."""
    blk = packed[:, :128].to(torch.int64)
    return (blk[:, 0::4] << 24) | (blk[:, 1::4] << 16) | (blk[:, 2::4] << 8) | blk[:, 3::4]


def _add(a, b):
    lo = a[1] + b[1]
    return ((a[0] + b[0] + (lo >> 32)) & M32, lo & M32)


def _xor(a, b):
    return (a[0] ^ b[0], a[1] ^ b[1])


def _rotr(a, n: int):
    hi, lo = a
    if n == 32:
        return (lo, hi)
    if n > 32:
        hi, lo, n = lo, hi, n - 32
    return (((hi >> n) | (lo << (32 - n))) & M32, ((lo >> n) | (hi << (32 - n))) & M32)


def _shr(a, n: int):
    hi, lo = a
    return (hi >> n, ((lo >> n) | (hi << (32 - n))) & M32)


def _const(v: int, like: torch.Tensor):
    return (torch.full_like(like, v >> 32), torch.full_like(like, v & M32))


def sha512_block(words: torch.Tensor) -> torch.Tensor:
    """(B, 32) int64 block words -> (B, 16) int64 digest words (8
    big-endian 64-bit words as hi, lo pairs, each in [0, 2^32))."""
    ref = words[:, 0]
    w = [(words[:, 2 * i], words[:, 2 * i + 1]) for i in range(16)]
    for t in range(16, 80):
        x, y = w[t - 15], w[t - 2]
        s0 = _xor(_xor(_rotr(x, 1), _rotr(x, 8)), _shr(x, 7))
        s1 = _xor(_xor(_rotr(y, 19), _rotr(y, 61)), _shr(y, 6))
        w.append(_add(_add(w[t - 16], s0), _add(w[t - 7], s1)))
    state = [_const(h, ref) for h in H0_64]
    a, b, c, d, e, f, g, h = state
    for t in range(80):
        s1 = _xor(_xor(_rotr(e, 14), _rotr(e, 18)), _rotr(e, 41))
        ch = _xor((e[0] & f[0], e[1] & f[1]), (~e[0] & M32 & g[0], ~e[1] & M32 & g[1]))
        t1 = _add(_add(_add(h, s1), _add(ch, _const(K64[t], ref))), w[t])
        s0 = _xor(_xor(_rotr(a, 28), _rotr(a, 34)), _rotr(a, 39))
        maj = _xor(_xor((a[0] & b[0], a[1] & b[1]), (a[0] & c[0], a[1] & c[1])),
                   (b[0] & c[0], b[1] & c[1]))
        t2 = _add(s0, maj)
        a, b, c, d, e, f, g, h = _add(t1, t2), a, b, c, _add(d, t1), e, f, g
    out = []
    for s, v in zip(state, (a, b, c, d, e, f, g, h)):
        out.extend(_add(s, v))
    return torch.stack(out, dim=1)
