"""h = SHA-512(R || A || M) mod L as ladder windows: kernel A and its plain version.

Counterpart of corda_tpu/ops/scalar25519.py:81-131 plus the prologue of
corda_tpu/ops/ed25519.py::_tpu_verify_fixedlen (:355-362). The plain version
mirrors the reference step for step: the digest as 43 radix-4096 limbs,
Barrett with m = floor(2^516 / L), the 64 little-endian 4-bit windows.
``ed25519_challenge`` is the wrapper: on a CUDA tensor it launches kernel A
(csrc/ed25519_challenge.cu), on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import torch

from . import _build
from .sha512 import block_words, sha512_block

L = 2**252 + 27742317777372353535851937790883648493
RADIX = 12
MASK = (1 << RADIX) - 1
_L_LIMBS = [(L >> (RADIX * i)) & MASK for i in range(22)]
_M516 = (1 << 516) // L
_M_LIMBS = [(_M516 >> (RADIX * i)) & MASK for i in range(22)]

PACKED_ROW = 161   # bytes per lane of the packed plane
WINDOWS = 64


def digest_words_to_limbs(digest: torch.Tensor) -> torch.Tensor:
    """(B, 16) digest words (hi, lo pairs) -> (43, B) radix-4096 limbs of
    the digest read as a little-endian 512-bit integer."""
    by = []
    for i in range(8):
        hi, lo = digest[:, 2 * i], digest[:, 2 * i + 1]
        for k in range(8):
            src = hi if k < 4 else lo
            by.append((src >> (24 - 8 * (k % 4))) & 0xFF)
    rows = []
    for k in range(43):
        if k == 42:
            rows.append(by[63])
        elif k % 2 == 0:
            j = 3 * k // 2
            rows.append(by[j] | ((by[j + 1] & 0xF) << 8))
        else:
            j = (3 * k - 1) // 2
            rows.append((by[j] >> 4) | (by[j + 1] << 4))
    return torch.stack(rows, dim=0)


def _exact_limbs(cols: torch.Tensor, out_rows: int) -> torch.Tensor:
    """(n, B) column sums -> (out_rows, B) exact radix-4096 limbs."""
    carry = torch.zeros_like(cols[0])
    rows = []
    for k in range(out_rows):
        v = (cols[k] if k < cols.shape[0] else 0) + carry
        rows.append(v & MASK)
        carry = v >> RADIX
    return torch.stack(rows, dim=0)


def _mp_mul_const(a: torch.Tensor, const_limbs: list[int], out_rows: int):
    na, nc = a.shape[0], len(const_limbs)
    cols = torch.zeros((na + nc, a.shape[1]), dtype=a.dtype, device=a.device)
    for i, c in enumerate(const_limbs):
        if c:
            cols[i : i + na] += c * a
    return _exact_limbs(cols, out_rows)


def _mp_sub(a: torch.Tensor, b: torch.Tensor):
    """(n, B) - (n, B) with a borrow chain -> (limbs, final borrow)."""
    borrow = torch.zeros_like(a[0])
    rows = []
    for x, y in zip(a, b):
        d = x - y - borrow
        borrow = (d < 0).to(a.dtype)
        rows.append(d & MASK)
    return torch.stack(rows, dim=0), borrow


def mod_l(h_limbs: torch.Tensor) -> torch.Tensor:
    """(43, B) limbs of a 512-bit value -> (22, B) limbs of value mod L."""
    b = h_limbs.shape[1]
    q_hat = _mp_mul_const(h_limbs, _M_LIMBS, 66)[43:65]
    ql = _mp_mul_const(q_hat, _L_LIMBS, 45)
    h45 = torch.cat([h_limbs, torch.zeros_like(h_limbs[:2])], dim=0)
    r, _ = _mp_sub(h45, ql)
    r = r[:22]
    l_col = torch.tensor(_L_LIMBS, dtype=r.dtype, device=r.device)[:, None].expand(22, b)
    for _ in range(2):
        diff, borrow = _mp_sub(r, l_col)
        r = torch.where(borrow == 0, diff, r)
    return r


def limbs_to_windows(r: torch.Tensor) -> torch.Tensor:
    """(22, B) reduced limbs -> (64, B) 4-bit windows, window k = bits
    4k..4k+3."""
    w = torch.stack([r & 0xF, (r >> 4) & 0xF, r >> 8], dim=1)
    return w.reshape(66, r.shape[1])[:WINDOWS]


def challenge_windows_plain(packed: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel A: (B, 161) uint8 -> (64, B) int32."""
    digest = sha512_block(block_words(packed))
    return limbs_to_windows(mod_l(digest_words_to_limbs(digest))).to(torch.int32)


def check_packed(packed: torch.Tensor) -> None:
    if packed.dtype != torch.uint8 or packed.dim() != 2 or \
            packed.shape[1] != PACKED_ROW or not packed.is_contiguous():
        raise ValueError(
            f"packed plane must be a contiguous (B, {PACKED_ROW}) uint8 "
            f"tensor, got {tuple(packed.shape)} {packed.dtype}"
        )


def ed25519_challenge(packed: torch.Tensor) -> torch.Tensor:
    """Windows of h mod L for every lane of the packed plane, (64, B) int32.

    Launches kernel A on the current stream for a CUDA tensor, runs the
    plain version for a CPU tensor."""
    check_packed(packed)
    if packed.device.type == "cpu":
        return challenge_windows_plain(packed)
    _build.require_cuda(packed)
    n = packed.shape[0]
    out = torch.empty((WINDOWS, n), dtype=torch.int32, device=packed.device)
    if n == 0:
        return out
    if packed.data_ptr() % 16:
        raise ValueError("kernel A stages rows in 16-byte copies: the plane must be "
                         "16-byte aligned")
    lib = _build.kernels()
    with torch.cuda.device(packed.device):
        rc = lib.ct_ed25519_challenge(
            packed.data_ptr(), out.data_ptr(), n, _build.stream_of(packed)
        )
    _build.check_launch(rc, "ed25519_challenge")
    _build.count_launch(ed25519_challenge)
    return out


ed25519_challenge.launches = 0
