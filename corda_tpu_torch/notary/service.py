"""The batched notary on the card (counterpart of corda_tpu/notary/service.py).

``BatchedNotaryService`` notarises windows of signed transactions,
validating by default as the reference does. Each window:

1. recomputes every transaction's Merkle id from its component bytes
   (``ops/txid.py``: kernels C and D), so a signer is held to the id its
   content hashes to;
2. verifies every signature in one batch (``verifier.check_transactions``
   through the shared ``DeviceScheduler`` of the service's
   ``Ed25519Tier``: kernel A, then kernel B or G);
3. checks the notary and the time window and, when validating, resolves
   every input through the request's state resolver and runs the
   contracts (``ledger.verify_ledger_batch``, one cohort a contract class,
   on the host); then commits the inputs to the uniqueness provider in one
   ``commit_batch``;
4. signs every accepted id (``ops/ed25519_sign.py``: kernel E).

``process_batch`` runs one window; ``process_stream`` keeps up to
``depth`` windows in flight, so a window's device work overlaps the host
work of its neighbours. The service's ``device`` (the card unless
``device="cpu"``) runs the id sweep, the scheduler and the signing;
``use_device=False`` is the host tier: hashlib ids, the oracle's verdicts
and host signing, with the same results.

Left out of this slice (ROADMAP.md lists each): ``SimpleNotaryService``
and ``ValidatingNotaryService``, the ``request()`` window with its flush
threads, the cache of issued signatures that answers a retried request
(nothing on the batch path reads it), tracing spans, metrics meters, BFT
quorum certificates and the durable attestation journal.
"""

from __future__ import annotations

import time
from collections import deque

from ..crypto import (
    CURRENT_PLATFORM_VERSION,
    EDDSA_ED25519_SHA512,
    KeyPair,
    SecureHash,
    SignableData,
    SignatureMetadata,
    TransactionSignature,
    sign_tx_id,
)
from ..device import resolve_device
from ..ledger import Party, SignedTransaction, TimeWindow, verify_ledger_batch
from ..ops.ed25519 import Ed25519Tier
from ..ops.ed25519_sign import ed25519_sign_dispatch
from ..ops.txid import dispatch_prime_ids
from ..serving import BULK, FuturePending, ServingError, device_scheduler
from ..verifier import dispatch_transactions
from .uniqueness import NotaryError, UniquenessProvider

TIME_TOLERANCE_MICROS = 30 * 1_000_000  # 30 s either side of the notary's clock


class NotaryService:
    """Identity, uniqueness, signing and the time-window policy."""

    def __init__(self, identity: Party, keypair: KeyPair,
                 uniqueness: UniquenessProvider, clock=time.time):
        if keypair.public != identity.owning_key:
            raise ValueError("notary keypair must match identity key")
        self.identity = identity
        self._keypair = keypair
        self.uniqueness = uniqueness
        self._clock = clock

    def sign(self, tx_id: SecureHash) -> TransactionSignature:
        return sign_tx_id(self._keypair.private, self._keypair.public, tx_id)

    def check_time_window(self, tw: TimeWindow | None) -> None:
        """Reject when the notary's now (give or take the tolerance) is
        outside the window."""
        if tw is None:
            return
        now = int(self._clock() * 1_000_000)
        ok = (
            tw.from_time is None or now + TIME_TOLERANCE_MICROS >= tw.from_time
        ) and (
            tw.until_time is None or now - TIME_TOLERANCE_MICROS < tw.until_time
        )
        if not ok:
            raise NotaryError(f"time window {tw} outside current time")

    def _check_notary(self, notary: Party | None, tx_id) -> None:
        if notary is None or notary.owning_key != self.identity.owning_key:
            raise NotaryError(
                f"transaction {tx_id} names a different notary than this service"
            )


class _Signatures:
    """Response signatures of a window: ``collect()`` waits for the device
    half of a batched signing, or returns the host's at once."""

    __slots__ = ("_pending", "_public", "_meta", "_sigs")

    def __init__(self, pending=None, public=None, meta=None, sigs=None):
        self._pending = pending
        self._public = public
        self._meta = meta
        self._sigs = sigs

    def collect(self) -> list[TransactionSignature]:
        if self._pending is None:
            return self._sigs
        return [TransactionSignature(raw, self._public, self._meta)
                for raw in self._pending.collect()]


class BatchedNotaryService(NotaryService):
    """The batched notary; see the module docstring. ``max_batch`` bounds
    a window: callers cut their request streams to it, and a longer window
    is refused. ``tier`` picks the ed25519 verify ladder (the default tier
    when None); on the device tier every window's signature check pins
    its pad bucket to ``max_batch``, as the reference's does, so an ed25519
    bucket that fills it takes the cofactored rule unless ``batch_rlc`` is
    off. Requests are (signed transaction, state resolver, caller) triples;
    a validating notary resolves each input with
    ``resolver(StateRef) -> TransactionState``."""

    def __init__(self, identity, keypair, uniqueness, *, max_batch: int = 1024,
                 use_device: bool = True, validating: bool = True,
                 use_scheduler: bool = True, device=None,
                 tier: Ed25519Tier | None = None, batch_rlc: bool = True,
                 clock=time.time):
        super().__init__(identity, keypair, uniqueness, clock)
        self._max_batch = max_batch
        self._use_device = use_device
        self._use_scheduler = use_scheduler
        self._validating = validating
        self.device = resolve_device(device)
        self.tier = tier
        self.batch_rlc = batch_rlc

    # ---------------------------------------------------------- sync core

    def dispatch_ids(self, requests):
        """Enqueue the window's Merkle-id sweep on the device; the pending's
        ``collect()`` primes the id caches (None on the host tier, whose ids
        are computed with hashlib when first read)."""
        if len(requests) > self._max_batch:
            raise ValueError(f"a window of {len(requests)} requests is longer than "
                             f"max_batch={self._max_batch}")
        if not self._use_device:
            return None
        return dispatch_prime_ids([r[0] for r in requests], device=self.device)

    def dispatch_batch(self, requests, pending_ids=None):
        """Enqueue the window's signature check; it settles in
        ``settle_batch``. ``pending_ids`` is an id sweep enqueued earlier;
        without one the sweep runs here."""
        if pending_ids is None:
            pending_ids = self.dispatch_ids(requests)
        if pending_ids is not None:
            pending_ids.collect()
        stxs = [r[0] for r in requests]
        allowed = [{self.identity.owning_key}] * len(requests)
        # one pad bucket across ragged windows, as the reference pins it
        min_bucket = self._max_batch if self._use_device else None
        if self._use_scheduler:
            # the shared scheduler coalesces this window with other
            # verifier traffic and keeps its pipeline depth in flight
            try:
                sched = device_scheduler(self.device, self.tier, self.batch_rlc)
                return FuturePending(sched.submit_transactions(
                    stxs, allowed, priority=BULK, use_device=self._use_device,
                    min_bucket=min_bucket,
                ))
            except ServingError:
                pass  # saturated or closed: dispatch directly
        return dispatch_transactions(stxs, allowed, use_device=self._use_device,
                                     min_bucket=min_bucket, device=self.device,
                                     tier=self.tier, batch_rlc=self.batch_rlc)

    def process_batch(
        self, requests: list[tuple[SignedTransaction, object, str]]
    ) -> list[TransactionSignature | Exception]:
        """Verify, commit and sign one window; one result per request."""
        return self.settle_batch(requests, self.dispatch_batch(requests))

    def process_stream(self, batches, *, depth: int = 3
                       ) -> list[list[TransactionSignature | Exception]]:
        """Pipelined notarisation over an iterable of windows: up to
        ``depth`` windows wait in each stage (id sweep, signature check,
        commit, signing) while the host settles earlier ones."""
        priming: deque = deque()     # (batch, pending id sweep)
        verifying: deque = deque()   # (batch, pending signature check)
        committing: deque = deque()  # (batch, staged commit)
        signing: deque = deque()     # (results, accepted, pending signatures)
        out: list = []

        def advance(drain: bool = False):
            if len(priming) >= (1 if drain else depth):
                b, ids = priming.popleft()
                verifying.append((b, self.dispatch_batch(b, ids)))
            if len(verifying) >= (1 if drain else depth):
                b, pending = verifying.popleft()
                committing.append((b, self.settle_validate(b, pending)))
            if len(committing) >= (1 if drain else depth):
                b, staged = committing.popleft()
                signing.append(self.settle_sign(b, *staged))
            if len(signing) >= (1 if drain else depth):
                out.append(self.finalize_batch(*signing.popleft()))

        for batch in batches:
            priming.append((batch, self.dispatch_ids(batch)))
            advance()
        while priming or verifying or committing or signing:
            advance(drain=True)
        return out

    def settle_batch(self, requests, pending) -> list[TransactionSignature | Exception]:
        """Collect the verdicts, then validate, commit and sign."""
        return self.finalize_batch(*self.settle_commit(requests, pending))

    def settle_commit(self, requests, pending):
        """Collect the verdicts, validate, commit, and enqueue the signing."""
        return self.settle_sign(requests, *self.settle_validate(requests, pending))

    def settle_validate(self, requests, pending):
        """Collect the verdicts, validate, and enqueue the uniqueness commit;
        returns what ``settle_sign`` takes."""
        results: list = [None] * len(requests)
        report = pending.collect()
        live: list[int] = []
        for i, err in enumerate(report.results):
            if err is not None:
                results[i] = NotaryError(f"signature check failed: {err}")
            else:
                live.append(i)
        live = self.validate(requests, live, results)
        pending_commit = self.uniqueness.commit_batch_async([
            (list(requests[i][0].tx.inputs), requests[i][0].id, requests[i][2])
            for i in live
        ])
        return results, live, pending_commit, report.n_device > 0

    def validate(self, requests, live: list[int], results: list) -> list[int]:
        """The checks after the signatures: the notary and the time window,
        and when validating each input resolved and every contract run
        (``verify_ledger_batch``: one cohort a contract class across the
        window). Writes each rejection into ``results``; returns the indices
        still live."""
        still_live: list[int] = []
        if not self._validating:
            for i in live:
                stx = requests[i][0]
                try:
                    self._check_notary(stx.tx.notary, stx.id)
                    self.check_time_window(stx.tx.time_window)
                    still_live.append(i)
                except Exception as e:
                    results[i] = e
            return still_live
        resolved: list[int] = []
        ltxs = []
        for i in live:
            stx, resolve_state, _caller = requests[i]
            try:
                self._check_notary(stx.tx.notary, stx.id)
                self.check_time_window(stx.tx.time_window)
                ltxs.append(stx.tx.to_ledger_transaction(resolve_state))
                resolved.append(i)
            except Exception as e:
                results[i] = NotaryError(f"validation failed: {e}")
        for i, err in zip(resolved, verify_ledger_batch(ltxs)):
            if err is None:
                still_live.append(i)
            else:
                results[i] = NotaryError(f"validation failed: {err}")
        return still_live

    def settle_sign(self, requests, results, live, pending_commit, on_device):
        """Resolve the uniqueness commit and enqueue the response signing;
        ``finalize_batch`` fills in the signatures."""
        conflicts = pending_commit.collect()
        accepted: list[int] = []
        for i, conflict in zip(live, conflicts):
            if conflict is not None:
                results[i] = NotaryError(
                    f"input states of {requests[i][0].id} already consumed", conflict,
                )
            else:
                accepted.append(i)
        pending_sigs = self._dispatch_sign([requests[i][0].id for i in accepted],
                                           on_device=on_device)
        return results, accepted, pending_sigs

    def finalize_batch(self, results, accepted, pending_sigs
                       ) -> list[TransactionSignature | Exception]:
        """Fill in the response signatures."""
        for i, sig in zip(accepted, pending_sigs.collect()):
            results[i] = sig
        return results

    def _dispatch_sign(self, tx_ids: list[SecureHash], on_device: bool = True):
        """Enqueue the response signing: one kernel E batch when the notary
        key is ed25519 and the window's verification ran on the device,
        else the host loop. RFC 8032 signing is deterministic, so the bytes
        are the same either way."""
        if (self._use_device and on_device and tx_ids
                and self._keypair.private.scheme_id == EDDSA_ED25519_SHA512):
            meta = SignatureMetadata(CURRENT_PLATFORM_VERSION, EDDSA_ED25519_SHA512)
            payloads = [SignableData(t, meta).to_bytes() for t in tx_ids]
            pending = ed25519_sign_dispatch(
                [self._keypair.private.encoded] * len(tx_ids), payloads,
                device=self.device,
            )
            return _Signatures(pending=pending, public=self._keypair.public, meta=meta)
        return _Signatures(sigs=[self.sign(t) for t in tx_ids])
