"""Batched ed25519 signing: kernel E (the fixed-base comb) and the host glue.

Counterpart of corda_tpu/ops/ed25519_sign.py. A notary signs thousands of
transaction ids with one key; the one expensive step of RFC 8032 signing is
R = [r]B, which kernel E (csrc/ed25519_comb.cu) runs over the whole batch:
B is fixed, so every 4-bit window k of r has its own 16-entry table
[j * 16^k]B, and [r]B is 64 mixed adds with no doublings, one inversion and
the encoding. With no doublings the adds split freely: the kernel runs
sixteen threads a signature, four quads each summing 16 windows, then
combines the four partial sums and inverts once.

- The nonce r = SHA-512(prefix || M) mod L and the response
  S = (r + h * a) mod L stay on the host; the private scalar never leaves
  it. Signatures are RFC 8032 deterministic: byte-equal to
  ``crypto/ed25519_host.sign``.
- ``comb_table`` is the kernel's table in its own limb layout (ref10's ten
  26/25-bit limbs, as kernel B): 64 x 16 entries of (y - x, y + x, 2dxy),
  rows ordered window, entry, element.
- The plain version runs the plain ladder's 20 x 13-bit field and its
  ``add_b_entry``. Like the kernel, it selects each window's entry by
  masking all 16 in, never by indexing with a digit of r.
- ``ed25519_comb`` is the wrapper: kernel E for CUDA tensors, the plain
  version for CPU tensors. The kernel takes any lane count, so a batch is
  not padded to a bucket.
"""

from __future__ import annotations

import functools
import hashlib
import threading

import numpy as np
import torch

from ..crypto.ed25519_host import BX, BY, D, L, P
from ..device import resolve_device
from ..observability.profiler import KERNEL_ED25519_SIGN, active_profiler
from . import _build
from ._blockpack import start_host_copy
from .addchain import batch_modinv
from .ed25519_ladder import (
    K2,
    LIMBS,
    RADIX,
    Env,
    add_b_entry,
    fe10_to_int,
    fe_canonical,
    fe_inv_chain,
    fe_mul,
    identity_point,
    int_to_fe10,
    int_to_limbs13,
)

WINDOWS = 64  # 4-bit windows covering scalars < 2^256
ENTRIES = 16
COMB_ROWS = 3 * ENTRIES * WINDOWS  # (3072, 10) int32: 122,880 bytes


# ------------------------------------------------------------ comb table


def _ext_add(p, q):
    """Extended-coordinate unified add over Python ints (add-2008-hwcd-3)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * D * t1 % P * t2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


@functools.lru_cache(maxsize=1)
def comb_entries_host() -> tuple:
    """(y - x, y + x, 2dxy) mod p of [j * 16^k]B, for k = 0..63 and
    j = 0..15 in that order (j = 0 is the identity), normalised with one
    batched inversion."""
    pts = []
    g = (BX, BY, 1, BX * BY % P)  # 16^k B
    for k in range(WINDOWS):
        pt = (0, 1, 1, 0)
        for j in range(ENTRIES):
            pts.append(pt)
            pt = _ext_add(pt, g)
        for _ in range(4):
            g = _ext_add(g, g)
    out = []
    for (px, py, _pz, _pt), zi in zip(pts, batch_modinv([pt[2] for pt in pts], P)):
        x, y = px * zi % P, py * zi % P
        out.append(((y - x) % P, (y + x) % P, 2 * D * x % P * y % P))
    return tuple(out)


@functools.lru_cache(maxsize=1)
def _table_host() -> np.ndarray:
    rows = [int_to_fe10(c) for entry in comb_entries_host() for c in entry]
    table = np.array(rows, dtype=np.int32)
    table.setflags(write=False)
    return table


def build_comb_table() -> np.ndarray:
    """Kernel E's (3072, 10) int32 table: row 3 * (16k + j) + c is element
    c of entry j of window k."""
    return _table_host().copy()


_tables: dict = {}
_tables_lock = threading.Lock()


def comb_table(device) -> torch.Tensor:
    """The comb table on ``device`` (built once per device)."""
    key = str(device)
    with _tables_lock:
        t = _tables.get(key)
        if t is None:
            t = torch.from_numpy(build_comb_table()).to(device)
            _tables[key] = t
        return t


# -------------------------------------------------------- the plain version


def _limbs13_to_bytes(y: torch.Tensor) -> torch.Tensor:
    """(20, B) canonical radix-8192 limbs -> (B, 32) uint8 little-endian."""
    cols = []
    for j in range(32):
        lo, off = divmod(8 * j, RADIX)
        v = y[lo] >> off
        if RADIX - off < 8 and lo + 1 < LIMBS:
            v = v | (y[lo + 1] << (RADIX - off))
        cols.append(v & 0xFF)
    return torch.stack(cols, dim=1).to(torch.uint8)


def windows_of_bytes(r_bytes: torch.Tensor) -> torch.Tensor:
    """(B, 32) uint8 little-endian scalars -> (64, B) int32 4-bit windows,
    window k = bits 4k..4k+3."""
    r = r_bytes.to(torch.int32)
    return torch.stack([r & 15, r >> 4], dim=2).reshape(r.shape[0], WINDOWS).T.contiguous()


def comb_plain(r_bytes: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel E: (B, 32) uint8 scalars + the comb table ->
    (B, 32) uint8 encodings of [r]B."""
    dev = r_bytes.device
    p13 = int_to_limbs13(P)[:, None]
    env = Env(k2=torch.from_numpy(K2[:, None].copy()).to(dev),
              p_limbs=torch.from_numpy(p13).to(dev),
              d=None, d2=None, sqrt_m1=None, comb=None)
    limbs = np.stack([int_to_limbs13(fe10_to_int(row)) for row in table.cpu().numpy()])
    entries = torch.from_numpy(limbs.reshape(WINDOWS, ENTRIES, 3, LIMBS)).to(dev)
    win = windows_of_bytes(r_bytes)
    lanes = r_bytes.shape[0]
    j = torch.arange(ENTRIES, dtype=torch.int32, device=dev)
    acc = identity_point(lanes, r_bytes)
    for k in range(WINDOWS):
        # mask all 16 entries in: (16, 1, 1, B) x (16, 3, 20, 1)
        mask = (win[k][None, :] == j[:, None]).to(torch.int32)[:, None, None, :]
        sel = (mask * entries[k][:, :, :, None]).sum(0, dtype=torch.int32)
        acc = add_b_entry(env, acc, (sel[0], sel[1], sel[2]))
    px, py, pz, _ = acc
    zinv = fe_inv_chain(pz)
    x = fe_canonical(env, fe_mul(px, zinv))
    y = fe_canonical(env, fe_mul(py, zinv))
    enc = _limbs13_to_bytes(y)
    enc[:, 31] |= ((x[0] & 1) << 7).to(torch.uint8)
    return enc


def ed25519_comb(r_bytes: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(B, 32) uint8 encodings of [r]B. Launches kernel E on the current
    stream for CUDA tensors, runs the plain version for CPU tensors."""
    n = r_bytes.shape[0]
    if r_bytes.dtype != torch.uint8 or tuple(r_bytes.shape) != (n, 32) or \
            not r_bytes.is_contiguous():
        raise ValueError("scalars must be a contiguous (B, 32) uint8 tensor")
    if table.dtype != torch.int32 or tuple(table.shape) != (COMB_ROWS, 10) or \
            not table.is_contiguous():
        raise ValueError(f"table must be a contiguous ({COMB_ROWS}, 10) int32 tensor")
    if r_bytes.device != table.device:
        raise ValueError("scalars and table must share a device")
    if r_bytes.device.type == "cpu":
        return comb_plain(r_bytes, table)
    _build.require_cuda(r_bytes)
    if table.data_ptr() % 8:
        raise ValueError("kernel E reads the table in 8-byte words: it must be 8-byte aligned")
    out = torch.empty((n, 32), dtype=torch.uint8, device=r_bytes.device)
    if n == 0:
        return out
    lib = _build.kernels()
    with torch.cuda.device(r_bytes.device):
        rc = lib.ct_ed25519_comb(r_bytes.data_ptr(), table.data_ptr(),
                                 out.data_ptr(), n, _build.stream_of(r_bytes))
    _build.check_launch(rc, "ed25519_comb")
    _build.count_launch(ed25519_comb)
    return out


ed25519_comb.launches = 0


# --------------------------------------------------------------- host glue


def _scalar_mul_host(k: int) -> tuple[int, int]:
    """Host [k]B in extended coordinates with one final inversion -> the
    affine (x, y)."""
    acc = (0, 1, 1, 0)
    add = (BX, BY, 1, BX * BY % P)
    while k:
        if k & 1:
            acc = _ext_add(acc, add)
        add = _ext_add(add, add)
        k >>= 1
    x, y, z, _ = acc
    zinv = pow(z, P - 2, P)
    return x * zinv % P, y * zinv % P


@functools.lru_cache(maxsize=1024)
def _expand_seed(seed: bytes) -> tuple[int, bytes, bytes]:
    """RFC 8032 5.1.5 key expansion -> (clamped scalar a, prefix, A bytes)."""
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    x, y = _scalar_mul_host(a)
    return a, h[32:], (y | ((x & 1) << 255)).to_bytes(32, "little")


def _scalar_bytes(rs: list[int]) -> np.ndarray:
    """Scalars -> (n, 32) uint8 little-endian."""
    return np.frombuffer(
        b"".join(r.to_bytes(32, "little") for r in rs), np.uint8
    ).reshape(len(rs), 32).copy()


class PendingSignatures:
    """In-flight batch signing: R = [r]B enqueued on the device with its
    copy to the host started; ``collect()`` finishes S on the host."""

    __slots__ = ("_rs", "_scalars", "_pubs", "_msgs", "_r_enc", "_n")

    def __init__(self, rs, scalars, pubs, msgs, r_enc, n):
        self._rs = rs
        self._scalars = scalars
        self._pubs = pubs
        self._msgs = msgs
        self._r_enc = r_enc
        self._n = n

    def collect(self) -> list[bytes]:
        if self._n == 0:
            return []
        r_bytes = self._r_enc.wait()
        sigs = []
        for i in range(self._n):
            enc_r = r_bytes[i].tobytes()
            h = int.from_bytes(
                hashlib.sha512(enc_r + self._pubs[i] + self._msgs[i]).digest(), "little"
            ) % L
            s = (self._rs[i] + h * self._scalars[i]) % L
            sigs.append(enc_r + s.to_bytes(32, "little"))
        return sigs


def ed25519_sign_dispatch(seeds: list[bytes], messages: list[bytes], *,
                          device=None) -> PendingSignatures:
    """Enqueue a signing batch on ``device`` (the card unless
    ``device="cpu"``): the host computes the deterministic nonces, the
    device the R points, ``collect()`` assembles the signatures."""
    if len(messages) != len(seeds):
        raise ValueError("batch length mismatch")
    device = resolve_device(device)
    prof = active_profiler()
    if prof is None or not seeds:
        return _sign_enqueue(seeds, messages, device)
    n = len(seeds)
    return prof.profile(
        KERNEL_ED25519_SIGN, lambda: _sign_enqueue(seeds, messages, device), rows=n,
        bucket=n, bytes_in=sum(len(s) + len(m) for s, m in zip(seeds, messages)),
        bytes_out=n * 64, device=device)


def _sign_enqueue(seeds, messages, device: torch.device) -> PendingSignatures:
    n = len(seeds)
    if n == 0:
        return PendingSignatures([], [], [], [], None, 0)
    rs: list[int] = []
    scalars: list[int] = []
    pubs: list[bytes] = []
    for seed, msg in zip(seeds, messages):
        a, prefix, a_bytes = _expand_seed(seed)
        rs.append(int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % L)
        scalars.append(a)
        pubs.append(a_bytes)
    r_dev = torch.from_numpy(_scalar_bytes(rs)).to(device)
    r_enc = start_host_copy(ed25519_comb(r_dev, comb_table(device)))
    return PendingSignatures(rs, scalars, pubs, list(messages), r_enc, n)


def ed25519_sign_batch(seeds: list[bytes], messages: list[bytes], *,
                       device=None) -> list[bytes]:
    """Synchronous batch signing -> 64-byte RFC 8032 signatures."""
    return ed25519_sign_dispatch(seeds, messages, device=device).collect()
