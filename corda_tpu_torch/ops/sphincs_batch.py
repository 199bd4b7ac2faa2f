"""Batched verification of the hash-based scheme (scheme 5): the host
prep, kernel H and its plain version.

Counterpart of corda_tpu/ops/sphincs_batch.py: ``sphincs_verify_batch``
(:89), ``sphincs_verify_dispatch`` (:103) and the device half,
``_sphincs_pipeline`` (:279), which the reference runs as one jitted
program on its accelerator.

- The host prep keeps the reference's precheck (:152-179): a 33-byte key
  tagged 0x02, a signature of ``SIG_LEN`` bytes, an index below 2^H, the
  key's commitment SHA-256(pub_seed || root), and the index the message
  digest selects. A lane that fails keeps a zero row and precheck 0.
- It keeps the reference's pad rule (:141-145): a floor of
  ``pow2_at_least(min(min_bucket or 8, 32))`` lanes, the batch padded to a
  power of two above it; pad lanes fail the precheck.
- Where the reference packs 13 planes of prefixes, siblings and parities
  on the host (:181-276), kernel H (``sphincs_verify``, csrc/sphincs.cu)
  takes four compact planes and computes every prefix, address and
  digit itself: the signature rows (B, 13,480) uint8, the FORS digests
  (B, 32) uint8, the hypertree indices (B,) int64 and the precheck (B,)
  bool. They are packed into one pinned plane and uploaded in one copy.
- ``sphincs_verify_plain`` is the same function in batched torch ops over
  the plain SHA-256 of ``ops/sha256.py``: every chain runs all W - 1 steps
  and keeps step k where k >= its digit, as the reference's masked loop
  does (:310-316). The wrapper runs it for CPU tensors only.
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np
import torch

from ..crypto.sphincs import (
    A,
    D,
    FORS_LAYER,
    H,
    HT,
    K,
    LEN,
    LEN2,
    N,
    SIG_LEN,
    W,
    _msg_digest,
)
from ..device import resolve_device
from . import _build
from ._blockpack import pow2_at_least, staged_dispatch
from .sha256 import M32, _compress, _initial_state

FORS_OFF = N + 8                          # randomizer, idx
FORS_TREE = N * (1 + A)                   # sk and A siblings
LAYER_OFF = FORS_OFF + K * FORS_TREE
LAYER_BYTES = N * (LEN + HT)              # LEN chain values, HT siblings
SEED_OFF = SIG_LEN - 2 * N
ROW_BYTES = SIG_LEN + N + 8 + 1           # one lane's share of the packed plane


def _blocks(length: int) -> int:
    """SHA-256 blocks of a ``length``-byte message."""
    return (length + 9 + 63) // 64


def pad_floor(min_bucket: int | None) -> int:
    """The reference's pad floor: SPHINCS is the cold scheme, so a pinned
    notary-sized ``min_bucket`` is capped at 32 lanes."""
    return pow2_at_least(min(min_bucket or 8, 32))


# ---------------------------------------------------------------- host prep


def precheck(pk: bytes, sig: bytes, msg: bytes):
    """The reference's host precheck of one lane: (FORS digest, idx) when it
    passes, else None."""
    if len(pk) != 33 or pk[0] != 0x02 or len(sig) != SIG_LEN:
        return None
    (idx,) = struct.unpack(">Q", sig[N:N + 8])
    if idx >= 1 << H:
        return None
    pub_seed, root = sig[-2 * N:-N], sig[-N:]
    if hashlib.sha256(pub_seed + root).digest() != pk[1:]:
        return None
    fors_dg, expect_idx = _msg_digest(sig[:N], pub_seed, root, msg)
    if idx != expect_idx:
        return None
    return fors_dg, idx


def pack_plane(plane: np.ndarray, pubkeys, signatures, messages) -> None:
    """Fill a zeroed (b * ROW_BYTES,) uint8 plane: the b signature rows,
    then the b FORS digests, the b little-endian int64 indices and the b
    precheck flags; lanes past the batch and lanes that fail stay zero."""
    b = plane.shape[0] // ROW_BYTES
    sigs = plane[: b * SIG_LEN].reshape(b, SIG_LEN)
    dgs = plane[b * SIG_LEN : b * (SIG_LEN + N)].reshape(b, N)
    idxs = plane[b * (SIG_LEN + N) : b * (SIG_LEN + N + 8)].view("<i8")
    pre = plane[b * (SIG_LEN + N + 8) :]
    for i, (pk, sig, msg) in enumerate(zip(pubkeys, signatures, messages)):
        got = precheck(bytes(pk), bytes(sig), bytes(msg))
        if got is None:
            continue
        sigs[i] = np.frombuffer(sig, np.uint8)
        dgs[i] = np.frombuffer(got[0], np.uint8)
        idxs[i] = got[1]
        pre[i] = 1


def split_plane(plane: torch.Tensor):
    """The packed plane's four views: (sigs, FORS digests, idx, pre)."""
    b = plane.shape[0] // ROW_BYTES
    return (plane[: b * SIG_LEN].view(b, SIG_LEN),
            plane[b * SIG_LEN : b * (SIG_LEN + N)].view(b, N),
            plane[b * (SIG_LEN + N) : b * (SIG_LEN + N + 8)].view(torch.int64),
            plane[b * (SIG_LEN + N + 8) :].view(torch.bool))


# ------------------------------------------------------- the plain version


def _be(v, nbytes: int, rows: int, device) -> torch.Tensor:
    """(rows, nbytes) big-endian bytes of an int or an (rows,) int64 tensor."""
    if not isinstance(v, torch.Tensor):
        v = torch.full((rows,), int(v), dtype=torch.int64, device=device)
    shifts = torch.arange(8 * (nbytes - 1), -1, -8, device=device)
    return ((v[:, None] >> shifts) & 0xFF).to(torch.uint8)


def _addr(rows: int, device, layer, tree, leaf, j) -> torch.Tensor:
    """(rows, 20) bytes of the ``>IQII`` address."""
    return torch.cat([_be(layer, 4, rows, device), _be(tree, 8, rows, device),
                      _be(leaf, 4, rows, device), _be(j, 4, rows, device)], dim=1)


def _const(tag: bytes, rows: int, device) -> torch.Tensor:
    return torch.tensor(list(tag), dtype=torch.uint8, device=device).expand(rows, len(tag))


def sha256_rows(msg: torch.Tensor) -> torch.Tensor:
    """(R, L) uint8 messages of one length -> (R, 32) uint8 digests, by the
    plain compression of ``ops/sha256.py``."""
    r, length = msg.shape
    nblk = _blocks(length)
    buf = torch.zeros((r, 64 * nblk), dtype=torch.uint8, device=msg.device)
    buf[:, :length] = msg
    buf[:, length] = 0x80
    buf[:, -8:] = _be(length * 8, 8, r, msg.device)
    b = buf.view(r, 16 * nblk, 4).to(torch.int64)
    words = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    state = _initial_state(words[:, 0])
    for k in range(nblk):
        state = _compress(state, [words[:, 16 * k + i] for i in range(16)])
    st = torch.stack(state, dim=1) & M32
    shifts = torch.tensor([24, 16, 8, 0], device=msg.device)
    return ((st[:, :, None] >> shifts) & 0xFF).to(torch.uint8).reshape(r, 32)


def digits_plain(digest: torch.Tensor) -> torch.Tensor:
    """(B, 32) uint8 -> (B, LEN) int64 Winternitz digits: 64 nibbles, high
    first, then the checksum's 3 nibbles, least significant first."""
    d = digest.to(torch.int64)
    nib = torch.stack([d >> 4, d & 0xF], dim=2).reshape(d.shape[0], 64)
    csum = ((W - 1) - nib).sum(dim=1)
    checks = [(csum >> (4 * i)) & 0xF for i in range(LEN2)]
    return torch.cat([nib, torch.stack(checks, dim=1)], dim=1)


def _auth_step(tag: bytes, seed, addr, pos, node, sib) -> torch.Tensor:
    even = (pos % 2 == 0)[:, None]
    first = torch.where(even, node, sib)
    second = torch.where(even, sib, node)
    return sha256_rows(torch.cat([_const(tag, node.shape[0], node.device), seed, addr,
                                  first, second], dim=1))


def sphincs_stages_plain(sigs: torch.Tensor, fors_dg: torch.Tensor,
                         idx: torch.Tensor) -> list[torch.Tensor]:
    """The digests of each stage, (B, 32) uint8 each: the FORS pk, then the
    root of each of the D layers (the last is the claimed top root)."""
    b, dev = sigs.shape[0], sigs.device
    idx = idx.to(torch.int64)
    seed = sigs[:, SEED_OFF : SEED_OFF + N]

    # FORS: K trees a lane, B * K rows
    trees = sigs[:, FORS_OFF:LAYER_OFF].reshape(b, K, 1 + A, N)
    t = torch.arange(K, device=dev).repeat(b)
    pos = fors_dg[:, 31 - torch.arange(K, device=dev)].to(torch.int64).reshape(b * K)
    seed_k = seed.repeat_interleave(K, dim=0)
    idx_k = idx.repeat_interleave(K)
    rk = b * K
    node = sha256_rows(torch.cat([_const(b"forsleaf", rk, dev), seed_k,
                                  _addr(rk, dev, FORS_LAYER, idx_k, t, pos),
                                  trees[:, :, 0].reshape(rk, N)], dim=1))
    for lvl in range(A):
        addr = _addr(rk, dev, FORS_LAYER, idx_k, (t << 8) | (lvl + 1), pos >> 1)
        node = _auth_step(b"forsnode", seed_k, addr, pos, node,
                          trees[:, :, 1 + lvl].reshape(rk, N))
        pos = pos >> 1
    digest = sha256_rows(torch.cat([_const(b"forspk", b, dev), seed,
                                    _addr(b, dev, FORS_LAYER, idx, 0, 0),
                                    node.reshape(b, K * N)], dim=1))
    stages = [digest]

    j = torch.arange(LEN, device=dev).repeat(b)
    seed_j = seed.repeat_interleave(LEN, dim=0)
    rj = b * LEN
    for layer in range(D):
        tree = idx >> (HT * (layer + 1))
        leaf = (idx >> (HT * layer)) & ((1 << HT) - 1)
        off = LAYER_OFF + layer * LAYER_BYTES
        digs = digits_plain(digest).reshape(rj)
        x = sigs[:, off : off + LEN * N].reshape(rj, N)
        tree_j, leaf_j = tree.repeat_interleave(LEN), leaf.repeat_interleave(LEN)
        for k in range(W - 1):
            stepped = sha256_rows(torch.cat([
                _const(b"ch", rj, dev), seed_j,
                _addr(rj, dev, layer, tree_j, leaf_j, (j << 8) | k), x], dim=1))
            x = torch.where((k >= digs)[:, None], stepped, x)
        node = sha256_rows(torch.cat([_const(b"wotspk", b, dev), seed,
                                      _addr(b, dev, layer, tree, leaf, 0),
                                      x.reshape(b, LEN * N)], dim=1))
        pos = leaf
        auth = sigs[:, off + LEN * N : off + LAYER_BYTES].reshape(b, HT, N)
        for lvl in range(1, HT + 1):
            node = _auth_step(b"node", seed, _addr(b, dev, layer, tree, lvl, pos >> 1), pos,
                              node, auth[:, lvl - 1])
            pos = pos >> 1
        digest = node
        stages.append(digest)
    return stages


def sphincs_verify_plain(sigs: torch.Tensor, fors_dg: torch.Tensor, idx: torch.Tensor,
                         pre: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel H: (B,) bool verdicts."""
    if sigs.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.bool, device=sigs.device)
    root = sphincs_stages_plain(sigs, fors_dg, idx)[-1]
    return (root == sigs[:, SIG_LEN - N :]).all(dim=1) & pre.to(torch.bool)


# ---------------------------------------------------------- the wrapper


def _check_plane(t: torch.Tensor, shape, dtype, name: str, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {shape} {dtype} tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def sphincs_verify(sigs: torch.Tensor, fors_dg: torch.Tensor, idx: torch.Tensor,
                   pre: torch.Tensor) -> torch.Tensor:
    """(B,) bool verdicts of B prechecked lanes: signature rows (B, 13480)
    uint8, FORS digests (B, 32) uint8, hypertree indices (B,) int64,
    precheck (B,) bool. Launches kernel H on the current stream for CUDA
    tensors, one block a lane; runs the plain version for CPU tensors."""
    b = sigs.shape[0]
    _check_plane(sigs, (b, SIG_LEN), torch.uint8, "sigs", sigs.device)
    _check_plane(fors_dg, (b, N), torch.uint8, "fors_dg", sigs.device)
    _check_plane(idx, (b,), torch.int64, "idx", sigs.device)
    _check_plane(pre, (b,), torch.bool, "pre", sigs.device)
    if sigs.device.type == "cpu":
        return sphincs_verify_plain(sigs, fors_dg, idx, pre)
    _build.require_cuda(sigs)
    out = torch.empty((b,), dtype=torch.bool, device=sigs.device)
    if b == 0:
        return out
    lib = _build.kernels()
    with torch.cuda.device(sigs.device):
        rc = lib.ct_sphincs_verify(sigs.data_ptr(), fors_dg.data_ptr(), idx.data_ptr(),
                                   pre.data_ptr(), out.data_ptr(), b,
                                   _build.stream_of(sigs))
    _build.check_launch(rc, "sphincs_verify")
    _build.count_launch(sphincs_verify)
    return out


sphincs_verify.launches = 0


# ------------------------------------------------------------ batch APIs


def sphincs_verify_dispatch(pubkeys, signatures, messages, min_bucket: int | None = None,
                            device=None) -> torch.Tensor:
    """Prep and enqueue a verify batch without waiting for it: returns the
    bucket-padded (B,) bool mask on ``device`` (the card unless
    ``device="cpu"``); slice ``[:n]`` after the copy back."""
    device = resolve_device(device)
    n_real = len(pubkeys)
    if not (len(signatures) == len(messages) == n_real):
        raise ValueError("batch length mismatch")
    b = pow2_at_least(max(n_real, 1), pad_floor(min_bucket))
    return staged_dispatch(
        device, ("sphincs", b), (b * ROW_BYTES,),
        lambda plane: pack_plane(plane, pubkeys, signatures, messages),
        lambda plane: sphincs_verify(*split_plane(plane)),
    )


def sphincs_verify_batch(pubkeys, signatures, messages, *, device=None) -> np.ndarray:
    """Verify scheme-5 signatures on ``device`` (the card unless
    ``device="cpu"``) -> (n,) bool."""
    n = len(pubkeys)
    if n == 0:
        if len(signatures) or len(messages):
            raise ValueError("batch length mismatch")
        return np.zeros(0, dtype=bool)
    return sphincs_verify_dispatch(pubkeys, signatures, messages,
                                   device=device).cpu().numpy()[:n]
