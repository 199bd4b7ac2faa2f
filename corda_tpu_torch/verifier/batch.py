"""Scheme-bucketed batch signature verification (ed25519 rows).

Counterpart of corda_tpu/verifier/batch.py:93-411. Rows are
(PublicKey, signature, message) triples; the ed25519 bucket (scheme 4) goes
to the device kernels in one dispatch, and the host oracle serves it when
the caller asks for the host (``use_device=False``).

Left out of this slice, each listed in ROADMAP.md:
- the RLC batch route of the reference (verifier/batch.py:229-237,
  batchverify/rlc.py). Every ed25519 bucket goes to the kernels, as in the
  reference with ``CORDA_TPU_BATCH_RLC=0``;
- the device-to-host failover (verifier/batch.py:239-251 and
  ``PendingRows.collect`` :179-185): a dispatch or readback failure
  raises;
- every other scheme: its rows raise ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np

from ..crypto import ed25519_host
from ..crypto.keys import (
    BLS_BLS12381,
    COMPOSITE_KEY,
    ECDSA_SECP256K1_SHA256,
    ECDSA_SECP256R1_SHA256,
    EDDSA_ED25519_SHA512,
    RSA_SHA256,
    SPHINCS256_SHA256,
)
from ..device import resolve_device
from ..ops._blockpack import result_ready, start_host_copy
from ..ops.ed25519 import ed25519_verify_dispatch

# where ROADMAP.md schedules the port of each other scheme
_NOT_PORTED = {
    ECDSA_SECP256K1_SHA256: "ROADMAP.md Queue 1 item 9 (ECDSA)",
    ECDSA_SECP256R1_SHA256: "ROADMAP.md Queue 1 item 9 (ECDSA)",
    SPHINCS256_SHA256: "ROADMAP.md Queue 1 item 10 (SPHINCS)",
    RSA_SHA256: "ROADMAP.md Queue 1 item 13 (device-free layers)",
    COMPOSITE_KEY: "ROADMAP.md Queue 1 item 13 (device-free layers)",
    BLS_BLS12381: "ROADMAP.md Queue 1 item 12 (batchverify)",
}


class PendingRows:
    """An in-flight row verification: the device buckets are enqueued with
    their device-to-host copies started; ``ready()`` polls their CUDA
    events and ``collect()`` materialises the (N,) mask, settling buckets
    in completion order."""

    __slots__ = ("_n", "_deferred", "_out", "device_rows", "device_mask",
                 "padded_lanes")

    def __init__(self, n: int):
        self._n = n
        self._deferred: list = []  # (row indices, HostCopy)
        self._out = np.zeros(n, dtype=bool)
        self.device_rows = 0
        self.device_mask = np.zeros(n, dtype=bool)
        self.padded_lanes = 0

    def ready(self) -> bool:
        return all(result_ready(h) for _idxs, h in self._deferred)

    def collect(self) -> np.ndarray:
        deferred, self._deferred = self._deferred, []
        while deferred:
            entry = next((e for e in deferred if result_ready(e[1])), deferred[0])
            deferred.remove(entry)
            idxs, handle = entry
            self._out[idxs] = handle.wait()[: len(idxs)]
        return self._out


def check_schemes(rows) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item of the first
    row whose scheme is not ported yet."""
    for key, _sig, _msg in rows:
        if key.scheme_id != EDDSA_ED25519_SHA512:
            where = _NOT_PORTED.get(key.scheme_id, "no ROADMAP.md item")
            raise NotImplementedError(
                f"scheme {key.scheme_id} is not ported to the PyTorch "
                f"package yet: {where}"
            )


def dispatch_signature_rows(rows: list, *, use_device: bool = True,
                            min_bucket: int | None = None,
                            device=None) -> PendingRows:
    """Enqueue verification of (PublicKey, signature, message) rows.

    The ed25519 rows go to the kernels on ``device`` (the card unless
    ``device="cpu"``) in one dispatch, with ``min_bucket`` pinning the pad
    bucket's floor; with ``use_device=False`` the host oracle settles them
    at once. Row order is preserved in the collected mask."""
    n = len(rows)
    pending = PendingRows(n)
    if n == 0:
        return pending
    check_schemes(rows)
    idxs = list(range(n))
    if not use_device:
        for i, (key, sig, msg) in enumerate(rows):
            pending._out[i] = ed25519_host.verify(key.encoded, sig, msg)
        return pending
    mask = ed25519_verify_dispatch(
        [k.encoded for k, _s, _m in rows], [s for _k, s, _m in rows],
        [m for _k, _s, m in rows], min_bucket=min_bucket,
        device=resolve_device(device),
    )
    pending._deferred.append((idxs, start_host_copy(mask)))
    pending.device_rows += n
    pending.device_mask[idxs] = True
    pending.padded_lanes += int(mask.shape[0])
    return pending


def verify_signature_rows(rows: list, *, use_device: bool = True,
                          device=None) -> np.ndarray:
    """Verify (PublicKey, signature, message) rows -> (N,) bool mask."""
    return dispatch_signature_rows(rows, use_device=use_device, device=device).collect()
