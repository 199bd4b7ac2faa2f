"""Scheme-bucketed batch signature verification, and the transaction
layer over it.

Counterpart of corda_tpu/verifier/batch.py:93-560. Rows are
(PublicKey, signature, message) triples, bucketed by scheme in row order
as the reference's ``dispatch_signature_rows`` (:221-248) does; each device
bucket is one dispatch:
- ed25519 (scheme 4) to ``ed25519_verify_dispatch`` (kernel A, then kernel
  B or G as the ``tier`` argument, an ``Ed25519Tier``, picks);
- ECDSA over secp256k1 (scheme 2) and secp256r1 (scheme 3) to
  ``ecdsa_verify_dispatch`` for its curve (kernel F);
- SPHINCS (scheme 5) to ``sphincs_verify_dispatch`` (kernel H), the route
  the reference takes on its accelerator (``_effective_device_schemes``
  :51-80), padded by the reference's rule for the cold scheme.
RSA (scheme 1) is the reference's cold path on every backend (:18,
:252-259), and BLS (scheme 7) has no kernel there either: their buckets
are settled on the host (the port's pure-Python PKCS#1 v1.5 verify and
its copy of the reference's BLS12-381 engine), in every mode, and their
rows stay out of ``device_rows``. On the device route they are settled
after every device bucket is enqueued, so that the host's work overlaps
the kernels. A composite key (scheme 6) verifies signature *sets*, not
rows: a row of one, or of an unknown scheme, raises the ``CryptoError``
that ``is_valid`` raises, out of ``dispatch_signature_rows`` as the
reference's host bucket (:257) lets it, before any bucket is enqueued.

An ed25519 bucket that fills ``min_bucket`` takes the rule of the
reference's RLC route (verifier/batch.py:229-237, 263-273;
batchverify/rlc.py): cofactored, small-order A and R rejected. It stays on
the card, as a ``cofactored`` launch of kernel B or G; the ``batch_rlc``
argument, on by default, stands for the reference's ``CORDA_TPU_BATCH_RLC``
switch. Partial buckets, and every bucket with the switch off, keep the
cofactorless rule. The port reads no environment switch: neither that one
nor ``CORDA_TPU_SPHINCS``.

With ``use_device=False`` every row goes to the host: full ed25519 buckets
to the port's copy of the cofactored rule (``batchverify.verify_rows``),
the rest to the oracle (``schemes.is_valid``). The transaction layer
(``dispatch_transactions``, ``check_transactions``) flattens many
transactions' signatures into one such dispatch and runs the per-tx
signer-set algebra on the verdict mask.

Mesh route: with no pinned ``device`` and the service mesh active
(``parallel.mesh.service_mesh_active``: more than one CUDA device, or
forced), each device bucket goes through the ``MeshVerifier``, split over
every ordinal (ed25519 on kernels A and B or G under the reference mesh's
per-signature rule, ECDSA on kernel F, SPHINCS on kernel H a chunk). A full
ed25519 bucket keeps the cofactored rule on one device, as the reference
sends it to its RLC route before the mesh. A pinned ``device`` means the
scheduler has already placed the bucket: no second fan-out.

Failover. The ``verifier.device`` fault site sits in front of every device
bucket. A bucket whose dispatch, or whose readback at ``collect()``, fails
with the fault plan's ``InjectedFault`` or a ``ServingError`` is settled on
the host under the same rule, counted as ``verifier.device_failover`` and
``verifier.device_failover_rows`` in the process registry. Nothing else
fails over: a torch or CUDA error, or a kernel that fails to build, raises
into the caller, so no fallback hides a kernel. (The reference catches
every exception.)

Left out, listed in ROADMAP.md: the RLC multi-scalar multiplication
itself; its verdicts equal the per-signature cofactored rule the kernels
run.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np

from ..batchverify import verify_rows
from ..crypto import CryptoError, SecureHash, TransactionSignature, is_fulfilled_by, is_valid
from ..crypto.keys import BLS_BLS12381, EDDSA_ED25519_SHA512, RSA_SHA256, SPHINCS256_SHA256
from ..crypto.schemes import ECDSA_CURVES
from ..device import resolve_device
from ..ledger import SignaturesMissingException, SignedTransaction
from ..ops._blockpack import result_ready, start_host_copy
from ..ops.ed25519 import Ed25519Tier, ed25519_verify_dispatch
from ..ops.secp256 import ecdsa_verify_dispatch
from ..ops.sphincs_batch import sphincs_verify_dispatch

# the schemes with a device path, each bucket one dispatch
DEVICE_SCHEMES = (EDDSA_ED25519_SHA512, *ECDSA_CURVES, SPHINCS256_SHA256)
# the schemes the host settles in every mode, as the reference does
HOST_SCHEMES = (RSA_SHA256, BLS_BLS12381)


class PendingRows:
    """An in-flight row verification: the device buckets are enqueued with
    their device-to-host copies started; ``ready()`` polls their CUDA
    events and ``collect()`` materialises the (N,) mask, settling buckets
    in completion order. A bucket whose readback fails with an injected
    fault or a ``ServingError`` settles on the host instead (counted);
    ``device_rows`` and ``device_mask`` say where rows really settled."""

    __slots__ = ("_n", "_deferred", "_out", "device_rows", "device_mask",
                 "padded_lanes", "stall_until", "_rows", "_full")

    def __init__(self, n: int, rows=None):
        self._n = n
        self._deferred: list = []  # (row indices, host copy)
        self._out = np.zeros(n, dtype=bool)
        self._rows = rows          # what a failed-over bucket settles on the host
        self._full: set = set()    # first index of each bucket under the cofactored rule
        self.device_rows = 0
        self.device_mask = np.zeros(n, dtype=bool)
        self.padded_lanes = 0
        # injected-stall horizon (the fault plan's stall sites): until this
        # monotonic time the batch reads not ready and collect() waits
        self.stall_until: float | None = None

    def inject_stall(self, delay_s: float) -> None:
        """Graft an injected stall onto this dispatch: it stays in flight
        and not ready for ``delay_s``; stalls compound to the furthest."""
        if delay_s <= 0:
            return
        horizon = time.monotonic() + delay_s
        self.stall_until = max(self.stall_until or 0.0, horizon)

    def ready(self) -> bool:
        if self.stall_until is not None and time.monotonic() < self.stall_until:
            return False
        return all(result_ready(h) for _idxs, h in self._deferred)

    def collect(self) -> np.ndarray:
        if self.stall_until is not None:
            wait = self.stall_until - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            self.stall_until = None
        deferred, self._deferred = self._deferred, []
        while deferred:
            entry = next((e for e in deferred if result_ready(e[1])), deferred[0])
            deferred.remove(entry)
            idxs, handle = entry
            try:
                self._out[idxs] = handle.wait()[: len(idxs)]
            except Exception as e:
                if not isinstance(e, failover_kinds()):
                    raise
                _note_device_failover(len(idxs), "collect")
                self.device_rows -= len(idxs)
                self.device_mask[idxs] = False
                _host_bucket(self, self._rows, idxs, idxs[0] in self._full)
        return self._out


def failover_kinds() -> tuple:
    """The errors a device bucket fails over to the host on: the fault
    plan's ``InjectedFault`` and the serving layer's ``ServingError``."""
    from ..faultinject import InjectedFault
    from ..serving.scheduler import ServingError

    return (InjectedFault, ServingError)


def _note_device_failover(n_rows: int, stage: str) -> None:
    """Count a device-to-host failover in the process registry."""
    from ..node.monitoring import node_metrics

    node_metrics().counter("verifier.device_failover").inc()
    node_metrics().counter("verifier.device_failover_rows").inc(n_rows)
    logging.getLogger(__name__).warning(
        "device verification failed at %s; %d rows fell back to the host", stage, n_rows,
    )


def check_schemes(rows) -> None:
    """Raise the ``CryptoError`` that ``is_valid`` raises for the first row
    no engine verifies one signature of: a composite key (it verifies
    signature sets) or an unknown scheme id, as the reference's host
    bucket raises it."""
    for key, sig, msg in rows:
        if key.scheme_id not in DEVICE_SCHEMES and key.scheme_id not in HOST_SCHEMES:
            is_valid(key, sig, msg)


def _dispatch_bucket(scheme_id: int, keys, sigs, msgs, min_bucket, device, tier,
                     cofactored, on_mesh: bool = False):
    if on_mesh and not cofactored:
        from ..parallel.mesh import service_mesh_verifier

        mesh_v = service_mesh_verifier()
        if scheme_id == EDDSA_ED25519_SHA512:
            return mesh_v.dispatch_rows(keys, sigs, msgs, min_bucket=min_bucket)[0]
        if scheme_id == SPHINCS256_SHA256:
            return mesh_v.dispatch_sphincs_rows(keys, sigs, msgs, min_bucket=min_bucket)
        return mesh_v.dispatch_ecdsa_rows(ECDSA_CURVES[scheme_id].name, keys, sigs, msgs,
                                          min_bucket=min_bucket)
    if scheme_id == EDDSA_ED25519_SHA512:
        return ed25519_verify_dispatch(keys, sigs, msgs, min_bucket=min_bucket,
                                       device=device, tier=tier, cofactored=cofactored)
    if scheme_id == SPHINCS256_SHA256:
        return sphincs_verify_dispatch(keys, sigs, msgs, min_bucket=min_bucket, device=device)
    return ecdsa_verify_dispatch(ECDSA_CURVES[scheme_id].name, keys, sigs, msgs,
                                 min_bucket=min_bucket, device=device)


def full_bucket(scheme_id: int, n_rows: int, min_bucket: int | None,
                batch_rlc: bool) -> bool:
    """Whether a bucket takes the reference's RLC rule (its
    ``_rlc_bucket_eligible``): an ed25519 bucket of at least ``min_bucket``
    rows, with the switch on."""
    return (scheme_id == EDDSA_ED25519_SHA512 and batch_rlc and min_bucket is not None
            and n_rows >= min_bucket)


def _host_bucket(pending: PendingRows, rows, idxs, full: bool) -> None:
    """Settle one bucket on the host under its rule: the cofactored rule
    for a full ed25519 bucket, the oracle for the rest."""
    if full:
        pending._out[idxs] = verify_rows(
            [(rows[i][0].encoded, rows[i][1], rows[i][2]) for i in idxs])
    else:
        pending._out[idxs] = [is_valid(*rows[i]) for i in idxs]


def dispatch_signature_rows(rows: list, *, use_device: bool = True,
                            min_bucket: int | None = None,
                            device=None, tier: Ed25519Tier | None = None,
                            batch_rlc: bool = True) -> PendingRows:
    """Enqueue verification of (PublicKey, signature, message) rows.

    One dispatch per scheme bucket on ``device`` (the card unless
    ``device="cpu"``), in the order each scheme first appears, with
    ``min_bucket`` pinning every bucket's pad floor (SPHINCS's capped at 32)
    and ``tier`` picking the ed25519 ladder (the default tier when None);
    an ed25519 bucket of at least ``min_bucket`` rows takes the cofactored
    rule unless ``batch_rlc`` is off. With no pinned ``device`` and the
    service mesh active, the buckets are split over the mesh's ordinals.
    RSA and BLS rows are settled on the host once every device bucket is
    enqueued. With ``use_device=False`` the host settles every row at once,
    under the same rules. Row order is preserved in the collected mask."""
    from ..faultinject import check_site
    from ..parallel.mesh import ChunkedMask, service_mesh_active

    n = len(rows)
    pending = PendingRows(n, rows)
    if n == 0:
        return pending
    check_schemes(rows)
    buckets: dict[int, list[int]] = {}
    for i, (key, _sig, _msg) in enumerate(rows):
        buckets.setdefault(key.scheme_id, []).append(i)
    if not use_device:
        for scheme_id, idxs in buckets.items():
            _host_bucket(pending, rows, idxs,
                         full_bucket(scheme_id, len(idxs), min_bucket, batch_rlc))
        return pending
    on_mesh = device is None and service_mesh_active()
    if on_mesh:
        from ..parallel.mesh import device_for_ordinal

        # what stays on one device (a full bucket's cofactored rule) runs
        # on the mesh's first ordinal
        device = device_for_ordinal(0)
    device = resolve_device(device)
    for scheme_id, idxs in buckets.items():
        if scheme_id in HOST_SCHEMES:
            continue
        full = full_bucket(scheme_id, len(idxs), min_bucket, batch_rlc)
        try:
            stall_s = check_site("verifier.device")
            mask = _dispatch_bucket(
                scheme_id, [rows[i][0].encoded for i in idxs], [rows[i][1] for i in idxs],
                [rows[i][2] for i in idxs], min_bucket, device, tier, full, on_mesh,
            )
        except Exception as e:
            if not isinstance(e, failover_kinds()):
                raise
            _note_device_failover(len(idxs), "dispatch")
            _host_bucket(pending, rows, idxs, full)
            continue
        handle = mask.host_copy() if isinstance(mask, ChunkedMask) else start_host_copy(mask)
        pending._deferred.append((idxs, handle))
        if full:
            pending._full.add(idxs[0])
        pending.device_rows += len(idxs)
        pending.device_mask[idxs] = True
        pending.padded_lanes += int(mask.shape[0])
        if stall_s:
            pending.inject_stall(stall_s)
    # the host buckets last, so that their work overlaps the kernels
    for scheme_id, idxs in buckets.items():
        if scheme_id in HOST_SCHEMES:
            pending._out[idxs] = [is_valid(*rows[i]) for i in idxs]
    return pending


def verify_signature_rows(rows: list, *, use_device: bool = True,
                          min_bucket: int | None = None, device=None,
                          tier: Ed25519Tier | None = None,
                          batch_rlc: bool = True) -> np.ndarray:
    """Verify (PublicKey, signature, message) rows -> (N,) bool mask."""
    return dispatch_signature_rows(rows, use_device=use_device, min_bucket=min_bucket,
                                   device=device, tier=tier,
                                   batch_rlc=batch_rlc).collect()


# ------------------------------------------------------ transaction layer


@dataclasses.dataclass
class BatchVerifyReport:
    """Per-transaction outcome of a batched signature check."""

    results: list  # Exception | None per transaction (None = ok)
    n_sigs: int
    n_device: int
    # the scheduler batch that served the check (requests coalesced into
    # one device batch share it); None on the direct dispatch path
    batch_seq: int | None = None
    # the ordinal the scheduler batch ran on; None when host-settled, fused
    # over the mesh, or on the direct dispatch path
    device: int | None = None

    @property
    def ok(self) -> bool:
        return all(r is None for r in self.results)

    def raise_first(self) -> None:
        for r in self.results:
            if r is not None:
                raise r


class InvalidSignatureError(CryptoError):
    """A signature failed batch verification (a ``CryptoError``, as the
    per-signature ``TransactionSignature.verify`` raises)."""

    def __init__(self, tx_id: SecureHash, sig: TransactionSignature):
        self.tx_id = tx_id
        self.sig = sig
        super().__init__(f"invalid signature by {sig.by!r} on tx {tx_id}")


class PendingTxCheck:
    """An in-flight ``check_transactions``: the signature rows are enqueued,
    the per-tx signer-set algebra runs at ``collect()``."""

    __slots__ = ("_stxs", "_allowed", "_pending", "_row_tx", "_row_sig")

    def __init__(self, stxs, allowed, pending, row_tx, row_sig):
        self._stxs = stxs
        self._allowed = allowed
        self._pending = pending
        self._row_tx = row_tx
        self._row_sig = row_sig

    def collect(self) -> BatchVerifyReport:
        mask = self._pending.collect()
        return tx_report_from_mask(
            self._stxs, self._allowed, mask, self._row_tx, self._row_sig,
            self._pending.device_rows,
        )


def flatten_signature_rows(stxs: list[SignedTransaction]):
    """Many transactions' signature triples as one row list, plus the
    row -> (tx, signature) back-maps."""
    rows: list[tuple] = []
    row_tx: list[int] = []
    row_sig: list[int] = []
    for t, stx in enumerate(stxs):
        for j, (key, sig, msg) in enumerate(stx.signature_triples()):
            rows.append((key, sig, msg))
            row_tx.append(t)
            row_sig.append(j)
    return rows, row_tx, row_sig


def tx_report_from_mask(stxs, allowed, mask, row_tx, row_sig, n_device,
                        batch_seq=None, device=None) -> BatchVerifyReport:
    """The per-transaction signer-set algebra over a row verdict mask,
    shared by the direct path and the scheduler: the first invalid
    signature of a transaction fails it, then every required key not
    fulfilled by its signers (and not allowed missing) does."""
    results: list = [None] * len(stxs)
    for i, valid in enumerate(mask):
        t = row_tx[i]
        if not valid and results[t] is None:
            results[t] = InvalidSignatureError(stxs[t].id, stxs[t].sigs[row_sig[i]])
    for t, stx in enumerate(stxs):
        if results[t] is not None:
            continue
        signed_by = {s.by for s in stx.sigs}
        missing = {
            k for k in stx.required_signing_keys if not is_fulfilled_by(k, signed_by)
        } - set(allowed[t])
        if missing:
            results[t] = SignaturesMissingException(missing, stx.id)
    return BatchVerifyReport(results, n_sigs=len(row_tx), n_device=n_device,
                             batch_seq=batch_seq, device=device)


def dispatch_transactions(stxs: list[SignedTransaction],
                          allowed_missing: list[set] | None = None, *,
                          use_device: bool = True, min_bucket: int | None = None,
                          device=None, tier: Ed25519Tier | None = None,
                          batch_rlc: bool = True) -> PendingTxCheck:
    """Enqueue the signature half of a batched transaction check; see
    ``check_transactions``."""
    if allowed_missing is None:
        allowed_missing = [set()] * len(stxs)
    if len(allowed_missing) != len(stxs):
        raise ValueError("allowed_missing length mismatch")
    rows, row_tx, row_sig = flatten_signature_rows(stxs)
    pending = dispatch_signature_rows(rows, use_device=use_device, min_bucket=min_bucket,
                                      device=device, tier=tier, batch_rlc=batch_rlc)
    return PendingTxCheck(stxs, allowed_missing, pending, row_tx, row_sig)


def check_transactions(stxs: list[SignedTransaction],
                       allowed_missing: list[set] | None = None, *,
                       use_device: bool = True, device=None,
                       tier: Ed25519Tier | None = None) -> BatchVerifyReport:
    """Batched ``stx.verify_signatures_except(allowed)`` over many
    transactions: every signature row in one dispatch on ``device`` (the
    card unless ``device="cpu"``) with the ed25519 ladder of ``tier``, then
    the per-tx signer-set algebra."""
    return dispatch_transactions(
        stxs, allowed_missing, use_device=use_device, device=device, tier=tier
    ).collect()
