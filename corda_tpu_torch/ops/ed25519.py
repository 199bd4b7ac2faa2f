"""Batched ed25519 verification: host prep and the device dispatch.

Counterpart of corda_tpu/ops/ed25519.py:299-641. RFC 8032 verification
without the cofactor: s >= L and y >= p are rejected on the host, h =
SHA-512(R || A || M) is reduced mod L, and a lane is accepted iff
encode([s]B + [h](-A)) == R. Reducing h mod L is the single canonical rule
of every verify path, the reference's included. A ``cofactored`` batch
takes the rule the reference gives full buckets (batchverify/rlc.py):
R's y < p and the small-order encodings of A and R are rejected on the
host, and the ladder accepts iff 8 ([s]B + [h](-A) - R) is the identity.

Each batch pads to a power-of-two bucket and is packed into one (B, 161)
uint8 plane: the SHA-512 block carrying R || A || M, then s, then the
precheck flag. Two routes, as in the reference:

- fixed length (every message the same length, at most 47 bytes, so
  R || A || M fits one block): kernel A hashes and reduces on the card,
  kernel B runs the ladder;
- variable length: hashlib on the host, the windows of h uploaded, then
  kernel B.

The ladder is picked by an ``Ed25519Tier`` argument, the port's counterpart
of the reference's two environment switches (``_use_radix_8192`` :640,
``_fixed_base_win`` :654 of corda_tpu/ops/ed25519_pallas.py): radix 8192
runs kernel B, radix 4096 kernel G, with the 8-bit comb or the 16-entry
window. Both read the same packed plane and windows of h, so the staging
pool's buckets do not depend on the tier.

On the card the plane is staged in pinned host memory taken from a
per-bucket pool (``_blockpack.staged_dispatch``); a buffer is handed out
again only after the CUDA event recorded behind the dispatch that read it
has completed. A dispatch failure raises: there is no host failover in
this port.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools

import numpy as np
import torch

from ..batchverify.rlc import small_order_encodings
from ..device import resolve_device
from . import ed25519_ladder4096
from ._blockpack import bucket_floor, pow2_at_least, staged_dispatch
from .ed25519_ladder import VERIFY_B, ladder_table
from .scalar25519 import L, PACKED_ROW, WINDOWS, ed25519_challenge

P = 2**255 - 19
_L_BE = np.frombuffer(L.to_bytes(32, "big"), dtype=np.uint8).astype(np.int16)
MAX_FIXED_MSG = 47  # 64 + 47 + 1 + 16 = 128: R || A || M and padding in one block
# the 8 small-order encodings as four little-endian 64-bit words each
_SMALL_ORDER_WORDS = np.frombuffer(b"".join(small_order_encodings()), "<u8").reshape(8, 4)


@dataclasses.dataclass(frozen=True)
class Ed25519Tier:
    """Which verify ladder runs: ``radix`` 8192 (kernel B, the reference's
    production default) or 4096 (kernel G), and the fixed base's shape,
    ``fixed_win`` 8 (the 256-entry comb, the default) or 4 (the 16-entry
    window)."""

    radix: int = 8192
    fixed_win: int = 8

    def __post_init__(self):
        if self.radix not in (8192, 4096):
            raise ValueError(f"radix must be 8192 or 4096, not {self.radix}")
        if self.fixed_win not in (8, 4):
            raise ValueError(f"fixed_win must be 8 or 4, not {self.fixed_win}")

    def ladder(self, packed: torch.Tensor, h_win: torch.Tensor,
               cofactored: bool = False) -> torch.Tensor:
        """Run this tier's ladder (its wrapper, so its launch counter) on a
        packed plane and its windows of h, with the table of the plane's
        device, under the cofactored rule when ``cofactored``."""
        if self.radix == 8192:
            return VERIFY_B[self.fixed_win](packed, h_win, ladder_table(packed.device),
                                            cofactored)
        return ed25519_ladder4096.VERIFY_G[self.fixed_win](
            packed, h_win, ed25519_ladder4096.ladder_table(packed.device), cofactored)


DEFAULT_TIER = Ed25519Tier()


def _gather_fixed(pubkeys, signatures, b):
    """(b, 32) pubkey bytes, (b, 64) signature bytes, (b,) length-ok mask:
    the length mask first, then one join over the well-formed rows."""
    n = len(pubkeys)
    pk = np.zeros((b, 32), np.uint8)
    sg = np.zeros((b, 64), np.uint8)
    ok = np.zeros(b, dtype=bool)
    good = (np.fromiter(map(len, pubkeys), np.int64, n) == 32) & \
        (np.fromiter(map(len, signatures), np.int64, n) == 64)
    ok[:n] = good
    if not good.all():
        keep = good.tolist()
        pubkeys = list(itertools.compress(pubkeys, keep))
        signatures = list(itertools.compress(signatures, keep))
    pk[:n][good] = np.frombuffer(b"".join(pubkeys), np.uint8).reshape(-1, 32)
    sg[:n][good] = np.frombuffer(b"".join(signatures), np.uint8).reshape(-1, 64)
    return pk, sg, ok


def _y_ge_p(enc):
    """(B,) y >= p for (B, 32) encodings (bit 255, the sign, ignored)."""
    return (
        ((enc[:, 31] & 0x7F) == 0x7F)
        & (enc[:, 1:31] == 0xFF).all(axis=1)
        & (enc[:, 0] >= 0xED)
    )


def _small_order(enc):
    """(B,) the encoding is one of the 8 small-order ones."""
    words = np.ascontiguousarray(enc).view("<u8")
    return (words[:, None, :] == _SMALL_ORDER_WORDS[None]).all(axis=2).any(axis=1)


def _canonical_precheck(pk_arr, sig_arr, len_ok, cofactored: bool = False):
    """y < p, s < L and the sign split: (y_bytes, sign, s, precheck). The
    cofactored rule of full buckets also holds R's y < p and rejects the
    small-order encodings as A or R (the reference's ``_prepare``)."""
    y_bytes = pk_arr.copy()
    y_bytes[:, 31] &= 0x7F
    sign = (pk_arr[:, 31] >> 7).astype(np.int32)
    s_arr = sig_arr[:, 32:]
    diff = s_arr[:, ::-1].astype(np.int16) - _L_BE
    first_nz = (diff != 0).argmax(axis=1)
    s_lt_l = np.take_along_axis(diff, first_nz[:, None], 1)[:, 0] < 0
    precheck = len_ok & ~_y_ge_p(pk_arr) & s_lt_l
    if cofactored:
        r_arr = sig_arr[:, :32]
        precheck &= ~_y_ge_p(r_arr) & ~_small_order(pk_arr) & ~_small_order(r_arr)
    return y_bytes, sign, s_arr, precheck


def _challenge_bytes(pubkeys, signatures, messages, precheck, b) -> np.ndarray:
    """h = SHA-512(R || A || M) mod L on the host, (b, 32) little-endian."""
    h_bytes = np.zeros((b, 32), dtype=np.uint8)
    for i in np.nonzero(precheck[: len(pubkeys)])[0]:
        sig = signatures[i]
        h = int.from_bytes(
            hashlib.sha512(sig[:32] + pubkeys[i] + messages[i]).digest(), "little"
        ) % L
        h_bytes[i] = np.frombuffer(h.to_bytes(32, "little"), dtype=np.uint8)
    return h_bytes


def bytes_to_windows(x_bytes: np.ndarray) -> np.ndarray:
    """(B, 32) uint8 scalars -> (64, B) int32 4-bit windows, window k =
    bits 4k..4k+3."""
    inter = np.stack([x_bytes & 0xF, x_bytes >> 4], axis=2).reshape(x_bytes.shape[0], WINDOWS)
    return np.ascontiguousarray(inter.T.astype(np.int32))


def pack_rows(packed: np.ndarray, sig_arr, pk_arr, s_arr, precheck,
              messages=None) -> None:
    """Fill a zeroed (b, 161) plane: R, A, s and precheck for every route,
    plus M and the SHA-512 padding for the fixed-length route."""
    n = len(messages) if messages is not None else packed.shape[0]
    packed[:, :32] = sig_arr[:, :32]
    packed[:, 32:64] = pk_arr
    packed[:, 128:160] = s_arr
    packed[:, 160] = precheck
    if messages is None:
        return
    mlen = len(messages[0])
    if mlen:
        packed[:n, 64 : 64 + mlen] = np.frombuffer(b"".join(messages), np.uint8).reshape(n, mlen)
    total = 64 + mlen
    packed[:, total] = 0x80
    packed[:, 126] = ((total * 8) >> 8) & 0xFF
    packed[:, 127] = (total * 8) & 0xFF


def _verify_prep_enqueue(pubkeys, signatures, messages, *, device: torch.device,
                         min_bucket: int | None = None,
                         tier: Ed25519Tier = DEFAULT_TIER,
                         cofactored: bool = False) -> torch.Tensor:
    n_real = len(pubkeys)
    if not (len(signatures) == len(messages) == n_real):
        raise ValueError("batch length mismatch")
    if n_real == 0:
        return torch.zeros((0,), dtype=torch.bool, device=device)
    on_cuda = device.type == "cuda"
    b = pow2_at_least(n_real, bucket_floor(min_bucket, on_cuda))

    pk_arr, sig_arr, len_ok = _gather_fixed(pubkeys, signatures, b)
    _y_bytes, _sign, s_arr, precheck = _canonical_precheck(pk_arr, sig_arr, len_ok,
                                                           cofactored)
    mlen = len(messages[0])
    fixed = mlen <= MAX_FIXED_MSG and all(len(m) == mlen for m in messages)

    def fill(plane):
        pack_rows(plane, sig_arr, pk_arr, s_arr, precheck, messages if fixed else None)

    def launch(packed):
        if fixed:
            h_win = ed25519_challenge(packed)
        else:
            h_bytes = _challenge_bytes(pubkeys, signatures, messages, precheck, b)
            h_win = torch.from_numpy(bytes_to_windows(h_bytes)).to(device)
        return tier.ladder(packed, h_win, cofactored)

    return staged_dispatch(device, ("ed25519", b), (b, PACKED_ROW), fill, launch)


def ed25519_verify_dispatch(pubkeys, signatures, messages, *,
                            min_bucket: int | None = None,
                            device=None, tier: Ed25519Tier | None = None,
                            cofactored: bool = False) -> torch.Tensor:
    """Prep and enqueue a verify batch without waiting for it: returns the
    bucket-padded (B,) bool mask on ``device`` (slice ``[:n]`` after the
    copy back). ``min_bucket`` pins the pad bucket's floor; ``tier`` picks
    the ladder (``DEFAULT_TIER`` when None); ``cofactored`` applies the
    cofactored rule of the reference's full buckets."""
    return _verify_prep_enqueue(
        pubkeys, signatures, messages, device=resolve_device(device),
        min_bucket=min_bucket, tier=tier or DEFAULT_TIER, cofactored=cofactored,
    )


def ed25519_verify_batch(pubkeys, signatures, messages, *, device=None,
                         tier: Ed25519Tier | None = None) -> np.ndarray:
    """Verify a batch on ``device`` (the card unless ``device="cpu"``) with
    the ladder of ``tier``, returning a (n,) bool array. Malformed rows
    (lengths, s >= L, y >= p) fail through the precheck flag; the batch
    still runs full-size."""
    n_real = len(pubkeys)
    if n_real == 0:
        if len(signatures) or len(messages):
            raise ValueError("batch length mismatch")
        return np.zeros(0, dtype=bool)
    mask = ed25519_verify_dispatch(pubkeys, signatures, messages, device=device,
                                   tier=tier)
    return mask.cpu().numpy()[:n_real]
