"""Batched ECDSA verification (secp256k1, secp256r1): host prep and the
device dispatch.

Counterpart of corda_tpu/ops/secp256.py:294-677: the curve constants
(``CurveCtx`` :294-328, here the plain ints of ``crypto/ecdsa_host.py``),
the SEC1 point parse with its cache (``_decompress_point`` :477), the
byte planes (``_prep_byte_planes`` :526; its batched inversion,
``_batch_invert`` :513, is ``addchain.batch_modinv``),
``ecdsa_verify_dispatch`` (:610) and ``ecdsa_verify_batch`` (:663).

Host prep, per lane: a 64-byte r || s with 1 <= r < n and 1 <= s <= n // 2
(the canonical low-S rule of the host oracle), a public key that parses
onto the curve, e = SHA-256(message), w = s^-1 mod n (one batched
inversion for the whole bucket), u1 = e w and u2 = r w mod n, and the
second candidate r + n when it is below p. A lane that fails any check
keeps all-zero planes and precheck 0. The eight planes go into one
(B, 194) uint8 row a lane (``secp256_ladder.ECDSA_ROW``), staged in a
pinned buffer of the (curve, bucket) pool and uploaded in one copy; kernel
F (``ecdsa_verify_k1`` / ``ecdsa_verify_r1``) runs the ladder.

A batch pads to the reference's bucket (:626-630), ``pow2_at_least(n,
max(min_bucket, floor))``, with the port's floor of 128 lanes (the
kernels' block) on the card and the reference's 8 off it. A dispatch
failure raises here; only the verifier's dispatch fails over, and only on
an injected fault or a ``ServingError``.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from ..crypto.ecdsa_host import CURVES, decode_point
from ..device import resolve_device
from ..observability.profiler import KERNEL_ECDSA_VERIFY, active_profiler
from ._blockpack import KERNEL_BLOCK_LANES, pow2_at_least, staged_dispatch
from .addchain import batch_modinv
from .secp256_ladder import (
    COL_PRE,
    COL_QX,
    COL_RB_OK,
    ECDSA_ROW,
    VERIFY,
    ecdsa_table,
)

PLANES = ("qx", "qy", "u1", "u2", "ra", "rb")


@functools.lru_cache(maxsize=8192)
def _decompress_point(curve_name: str, encoded: bytes):
    """SEC1 point parse (compressed 33 bytes, uncompressed 65) -> (x, y)
    ints on the curve, else None. Cached: a node verifies thousands of
    signatures from a handful of keys."""
    return decode_point(CURVES[curve_name], encoded)


def _prep_byte_planes(curve_name: str, pubkeys, signatures, messages, b: int):
    """Per-lane canonical-form checks, point parse and scalar math as
    little-endian uint8 planes: (qx, qy, u1, u2, ra, rb) each (b, 32),
    rb_ok and precheck each (b,) bool. Byte-equal to the reference's."""
    cv = CURVES[curve_name]
    n = cv.n
    lanes = []  # (i, r, s, point)
    for i in range(len(pubkeys)):
        sig = signatures[i]
        if len(sig) != 64:
            continue
        r = int.from_bytes(sig[:32], "big")
        s = int.from_bytes(sig[32:], "big")
        if not (1 <= r < n and 1 <= s <= n // 2):
            continue
        pt = _decompress_point(curve_name, bytes(pubkeys[i]))
        if pt is None:
            continue
        lanes.append((i, r, s, pt))

    bufs = {name: bytearray(32 * b) for name in PLANES}
    rb_ok = np.zeros(b, bool)
    pre = np.zeros(b, bool)
    for (i, r, s, pt), w in zip(lanes, batch_modinv([s for _i, _r, s, _pt in lanes], n)):
        e = int.from_bytes(hashlib.sha256(messages[i]).digest(), "big")
        at = slice(32 * i, 32 * i + 32)
        bufs["qx"][at] = pt[0].to_bytes(32, "little")
        bufs["qy"][at] = pt[1].to_bytes(32, "little")
        bufs["u1"][at] = (e * w % n).to_bytes(32, "little")
        bufs["u2"][at] = (r * w % n).to_bytes(32, "little")
        bufs["ra"][at] = r.to_bytes(32, "little")
        if r + n < cv.p:
            bufs["rb"][at] = (r + n).to_bytes(32, "little")
            rb_ok[i] = True
        pre[i] = True
    planes = tuple(np.frombuffer(bufs[name], np.uint8).reshape(b, 32) for name in PLANES)
    return planes + (rb_ok, pre)


def pack_planes(packed: np.ndarray, planes) -> None:
    """Fill a (b, 194) row plane from ``_prep_byte_planes``' output."""
    for k, plane in enumerate(planes[:6]):
        packed[:, COL_QX + 32 * k : COL_QX + 32 * k + 32] = plane
    packed[:, COL_RB_OK] = planes[6]
    packed[:, COL_PRE] = planes[7]


def ecdsa_verify_dispatch(curve_name: str, pubkeys, signatures, messages, *,
                          min_bucket: int | None = None, device=None) -> torch.Tensor:
    """Prep and enqueue a verify batch without waiting for it: returns the
    bucket-padded (B,) bool mask on ``device`` (the card unless
    ``device="cpu"``); slice ``[:n]`` after the copy back."""
    device = resolve_device(device)
    verify = VERIFY[curve_name]
    n_real = len(pubkeys)
    if not (len(signatures) == len(messages) == n_real):
        raise ValueError("batch length mismatch")
    if n_real == 0:
        return torch.zeros((0,), dtype=torch.bool, device=device)
    floor = KERNEL_BLOCK_LANES if device.type == "cuda" else 8
    b = pow2_at_least(n_real, max(min_bucket or 0, floor))

    def run():
        planes = _prep_byte_planes(curve_name, pubkeys, signatures, messages, b)
        return staged_dispatch(
            device, (curve_name, b), (b, ECDSA_ROW), lambda plane: pack_planes(plane, planes),
            lambda packed: verify(packed, ecdsa_table(curve_name, device)),
        )

    prof = active_profiler()
    if prof is None:
        return run()
    return prof.profile(
        KERNEL_ECDSA_VERIFY, run, rows=n_real, bucket=b,
        bytes_in=sum(len(x) for seq in (pubkeys, signatures, messages) for x in seq),
        bytes_out=b, device=device,
    )


def ecdsa_verify_batch(curve_name: str, pubkeys, signatures, messages, *,
                       device=None) -> np.ndarray:
    """Verify 64-byte r || s ECDSA signatures (low-S canonical form) on
    ``device`` (the card unless ``device="cpu"``) -> (n,) bool."""
    n_real = len(pubkeys)
    if n_real == 0:
        if len(signatures) or len(messages):
            raise ValueError("batch length mismatch")
        return np.zeros(0, dtype=bool)
    mask = ecdsa_verify_dispatch(curve_name, pubkeys, signatures, messages, device=device)
    return mask.cpu().numpy()[:n_real]
