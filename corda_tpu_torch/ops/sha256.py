"""Batched SHA-256: kernels C and D, their plain versions, and the padding.

Counterpart of corda_tpu/ops/sha256.py. Digests travel as (N, 8) int32
tensors holding the big-endian 32-bit words' bits (torch has no usable
uint32 arithmetic); ``digest_words_to_bytes`` writes them out as ">u4".

- Kernel C, ``sha256_leaves`` (csrc/sha256.cu): one ragged launch over
  messages padded into 64-byte blocks laid end to end, with each message's
  block offset and count (``pack_messages``). Each block of the launch
  orders its own messages longest first, so that a warp's messages have
  nearly equal block counts. The reference pads the batch and the block
  count to powers of two (``bucket_batch``) only to bound XLA's
  recompiles; the digests are the same.
- Kernel D, ``sha256_merkle_sweep``: every Merkle level of a sweep in one
  launch. It reads both children from a device-resident pool by index and
  writes the parents into the pool's next rows, level after level, with a
  grid-wide barrier between levels and no readback.
- The plain versions keep each word in int64, masked to 32 bits (torch's
  uint32 has no shifts or adds on the CPU). A wrapper runs its plain
  version for CPU tensors only; for CUDA tensors it launches its kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..observability.profiler import KERNEL_SHA256, active_profiler
from . import _build
from ._blockpack import words_to_bytes

# fmt: off
K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
]
H0 = [
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
]
# fmt: on

M32 = 0xFFFFFFFF
BLOCK_BYTES = 64
_PAD_BLOCK = [0x80000000] + [0] * 14 + [512]  # the second block of a pair

# --------------------------------------------------------------- padding


def pack_messages(messages: list[bytes]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Kernel C's ragged layout, the port's one SHA-256 padder: every
    message padded (0x80, zeros, 64-bit big-endian bit length) to its own
    final block as the reference's ``pad_sha256`` (corda_tpu/ops/sha256.py:180)
    pads it, and the blocks laid end to end. Returns the (64 * blocks,)
    uint8 buffer and each message's (n,) int32 block offset and count."""
    n = len(messages)
    lens = np.fromiter(map(len, messages), dtype=np.int64, count=n)
    counts = (lens + 9 + BLOCK_BYTES - 1) // BLOCK_BYTES
    offsets = np.zeros(n, dtype=np.int64)
    if n:
        np.cumsum(counts[:-1], out=offsets[1:])
    buf = np.zeros(int(counts.sum()) * BLOCK_BYTES, dtype=np.uint8)
    starts = offsets * BLOCK_BYTES
    data = np.frombuffer(b"".join(messages), dtype=np.uint8)
    if data.size:
        src = np.zeros(n, dtype=np.int64)
        np.cumsum(lens[:-1], out=src[1:])
        buf[np.repeat(starts - src, lens) + np.arange(data.size)] = data
    buf[starts + lens] = 0x80
    ends = (offsets + counts) * BLOCK_BYTES
    bit_len = (lens * 8).astype(">u8").view(np.uint8).reshape(n, 8)
    buf[(ends - 8)[:, None] + np.arange(8)] = bit_len
    return buf, offsets.astype(np.int32), counts.astype(np.int32)


def digest_words_to_bytes(digest) -> list[bytes]:
    """(B, 8) big-endian words (int32 or uint32 bits) -> 32-byte digests."""
    return words_to_bytes(np.asarray(digest), 32)


def bytes_to_digest_words(digests: list[bytes]) -> np.ndarray:
    """32-byte digests -> (B, 8) uint32 big-endian words."""
    arr = np.frombuffer(b"".join(digests), dtype=">u4").reshape(len(digests), 8)
    return arr.astype(np.uint32)


# ---------------------------------------------------- the plain versions


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & M32


def _compress(state: list, w: list) -> list:
    """One compression over lanes: 8 state and 16 block words, each an
    int64 tensor of lanes in [0, 2^32)."""
    w = list(w)
    for t in range(16, 64):
        x, y = w[t - 15], w[t - 2]
        s0 = _rotr(x, 7) ^ _rotr(x, 18) ^ (x >> 3)
        s1 = _rotr(y, 17) ^ _rotr(y, 19) ^ (y >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & M32 & g)
        t1 = h + s1 + ch + K[t] + w[t]
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        a, b, c, d, e, f, g, h = (
            (t1 + s0 + maj) & M32, a, b, c, (d + t1) & M32, e, f, g,
        )
    return [(s + v) & M32 for s, v in zip(state, (a, b, c, d, e, f, g, h))]


def _initial_state(like: torch.Tensor) -> list:
    return [torch.full_like(like, v) for v in H0]


def _to_int32(words: list) -> torch.Tensor:
    """8 int64 word tensors in [0, 2^32) -> (lanes, 8) int32 of the same bits."""
    x = torch.stack(words, dim=1)
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def sha256_leaves_plain(blocks: torch.Tensor, offsets: torch.Tensor,
                        counts: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel C: the (n, 8) int32 digests of the messages
    of ``pack_messages``' layout."""
    n = offsets.shape[0]
    if n == 0:
        return torch.zeros((0, 8), dtype=torch.int32, device=blocks.device)
    b = blocks.view(-1, BLOCK_BYTES).to(torch.int64)
    words = (b[:, 0::4] << 24) | (b[:, 1::4] << 16) | (b[:, 2::4] << 8) | b[:, 3::4]
    offs = offsets.to(torch.int64)
    cnt = counts.to(torch.int64)
    state = _initial_state(offs)
    for j in range(int(cnt.max())):
        w = words[offs + torch.minimum(cnt - 1, torch.full_like(cnt, j))]
        new = _compress(state, [w[:, i] for i in range(16)])
        live = j < cnt
        state = [torch.where(live, nv, sv) for nv, sv in zip(new, state)]
    return _to_int32(state)


def sha256_pair_plain(pool: torch.Tensor, left: torch.Tensor,
                      right: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel D: (m, 8) int32 SHA-256 of pool[left[i]] ||
    pool[right[i]]."""
    words = pool.to(torch.int64) & M32
    lw, rw = words[left.long()], words[right.long()]
    state = _initial_state(lw[:, 0])
    state = _compress(state, [lw[:, i] for i in range(8)] + [rw[:, i] for i in range(8)])
    state = _compress(state, [torch.full_like(lw[:, 0], v) for v in _PAD_BLOCK])
    return _to_int32(state)


# ------------------------------------------------------------ the wrappers


def _check_index(t: torch.Tensor, n: int, name: str, device) -> None:
    if t.dtype != torch.int32 or tuple(t.shape) != (n,) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({n},) int32 tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def sha256_leaves(blocks: torch.Tensor, offsets: torch.Tensor,
                  counts: torch.Tensor, out: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """(n, 8) int32 digests of padded messages (``pack_messages``), in
    message order, written into ``out`` when given. Launches kernel C on
    the current stream for CUDA tensors, runs the plain version for CPU
    tensors."""
    n = offsets.shape[0]
    if blocks.dtype != torch.uint8 or blocks.dim() != 1 or not blocks.is_contiguous() \
            or blocks.numel() % BLOCK_BYTES:
        raise ValueError("blocks must be a contiguous 1-D uint8 tensor of whole blocks")
    _check_index(offsets, n, "offsets", blocks.device)
    _check_index(counts, n, "counts", blocks.device)
    if out is None:
        out = torch.empty((n, 8), dtype=torch.int32, device=blocks.device)
    elif out.dtype != torch.int32 or tuple(out.shape) != (n, 8) or \
            not out.is_contiguous() or out.device != blocks.device:
        raise ValueError(f"out must be a contiguous ({n}, 8) int32 tensor on {blocks.device}")
    if blocks.device.type == "cpu":
        out.copy_(sha256_leaves_plain(blocks, offsets, counts))
        return out
    _build.require_cuda(blocks)
    if n == 0:
        return out
    if blocks.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("kernel C moves 16-byte words: blocks and out must be 16-byte aligned")
    lib = _build.kernels()
    with torch.cuda.device(blocks.device):
        rc = lib.ct_sha256_leaves(
            blocks.data_ptr(), offsets.data_ptr(), counts.data_ptr(),
            out.data_ptr(), n, _build.stream_of(blocks),
        )
    _build.check_launch(rc, "sha256_leaves")
    _build.count_launch(sha256_leaves)
    return out


sha256_leaves.launches = 0


MAX_SWEEP_LEVELS = 64  # the levels one launch of kernel D takes


def sha256_sweep_plain(pool: torch.Tensor, levels) -> None:
    """Plain version of kernel D: each level of ``levels`` in turn through
    ``sha256_pair_plain``, its parents written into ``pool``."""
    for first, left, right in levels:
        pool[first : first + left.shape[0]] = sha256_pair_plain(pool, left, right)


def sha256_merkle_sweep(pool: torch.Tensor, levels) -> None:
    """Merkle levels in place, in order. ``levels`` holds (first, left,
    right) per level: pool rows ``first .. first + m - 1`` become
    SHA-256(pool[left[i]] || pool[right[i]]), and every index of a level
    must be below its first row (a level reads only rows written before
    it). Launches kernel D once for a CUDA pool, every level in that one
    launch; runs the plain version for a CPU one."""
    if pool.dtype != torch.int32 or pool.dim() != 2 or pool.shape[1] != 8 or \
            not pool.is_contiguous():
        raise ValueError("pool must be a contiguous (rows, 8) int32 tensor")
    for first, left, right in levels:
        m = left.shape[0]
        if not 0 <= first <= pool.shape[0] - m:
            raise ValueError(f"level rows {first}..{first + m} outside the pool")
        _check_index(left, m, "left", pool.device)
        _check_index(right, m, "right", pool.device)
    levels = [lv for lv in levels if lv[1].shape[0]]
    if not levels:
        return
    if len(levels) > MAX_SWEEP_LEVELS:
        raise ValueError(f"{len(levels)} levels: kernel D takes at most {MAX_SWEEP_LEVELS}")
    if pool.device.type == "cpu":
        sha256_sweep_plain(pool, levels)
        return
    _build.require_cuda(pool)
    if pool.data_ptr() % 16:
        raise ValueError("kernel D moves 16-byte words: the pool must be 16-byte aligned")
    lefts = np.array([left.data_ptr() for _f, left, _r in levels], dtype=np.int64)
    rights = np.array([right.data_ptr() for _f, _l, right in levels], dtype=np.int64)
    firsts = np.array([first for first, _l, _r in levels], dtype=np.int32)
    counts = np.array([left.shape[0] for _f, left, _r in levels], dtype=np.int32)
    lib = _build.kernels()
    with torch.cuda.device(pool.device):
        rc = lib.ct_sha256_merkle_sweep(
            pool.data_ptr(), lefts.ctypes.data, rights.ctypes.data, firsts.ctypes.data,
            counts.ctypes.data, len(levels), _build.stream_of(pool),
        )
    _build.check_launch(rc, "sha256_merkle_sweep")
    _build.count_launch(sha256_merkle_sweep)


sha256_merkle_sweep.launches = 0


# ------------------------------------------------------------- batch APIs


def upload_messages(messages: list[bytes], device: torch.device):
    """``pack_messages`` on ``device``: (blocks, offsets, counts) tensors."""
    buf, offsets, counts = pack_messages(messages)
    return tuple(torch.from_numpy(a).to(device) for a in (buf, offsets, counts))


def sha256_batch_words(messages: list[bytes], device=None) -> torch.Tensor:
    """The (N, 8) int32 digest words of ``messages`` on ``device`` (the
    card unless ``device="cpu"``), with no readback: for consumers that
    hash the digests further on the device. Kernel C pads nothing: the
    profiler's bucket is the message count."""
    device = resolve_device(device)

    def run():
        return sha256_leaves(*upload_messages(messages, device))

    prof = active_profiler()
    if prof is None or not messages:
        return run()
    n = len(messages)
    return prof.profile(KERNEL_SHA256, run, rows=n, bucket=n,
                        bytes_in=sum(len(m) for m in messages), bytes_out=n * 32,
                        device=device)


def sha256_batch(messages: list[bytes], device=None) -> list[bytes]:
    """Batch-hash arbitrary messages -> 32-byte digests."""
    if not messages:
        return []
    return digest_words_to_bytes(sha256_batch_words(messages, device).cpu().numpy())


def sha256_pair(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """SHA-256 of each 64-byte left || right: (B, 8) int32 words of two
    digests each -> (B, 8), on their device (the Merkle interior node), as
    a one-level sweep."""
    b = left.shape[0]
    pool = torch.cat([left, right, torch.empty_like(left)]).contiguous()
    idx = torch.arange(2 * b, dtype=torch.int32, device=left.device)
    sha256_merkle_sweep(pool, [(2 * b, idx[:b], idx[b:])])
    return pool[2 * b :]
