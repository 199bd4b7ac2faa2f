"""Notary services (counterpart of corda_tpu/notary/service.py).

- ``SimpleNotaryService``: non-validating. It takes a tear-off (a
  ``FilteredTransaction`` showing only the inputs, the time window and the
  notary), checks its Merkle proofs, commits and signs
  (SimpleNotaryService.kt:18 + NonValidatingNotaryFlow).
- ``ValidatingNotaryService``: resolves and verifies the whole
  transaction (its signatures but the notary's, and its contracts) before
  it commits (ValidatingNotaryService.kt:11 + ValidatingNotaryFlow.kt:17-51).

  Both are the reference's sequential host services: they check
  signatures and sign on the host, one transaction a call. They are the
  baseline the batched notary is measured against.
- ``BatchedNotaryService``: the batched notary on the card, validating by
  default as the reference's is. Each window:

  1. recomputes every transaction's Merkle id from its component bytes
     (``ops/txid.py``: kernels C and D), so a signer is held to the id its
     content hashes to;
  2. verifies every signature in one batch (``verifier.check_transactions``
     through the shared ``DeviceScheduler`` of the service's
     ``Ed25519Tier``: kernel A, then kernel B or G);
  3. checks the notary and the time window and, when validating, resolves
     every input through the request's state resolver and runs the
     contracts (``ledger.verify_ledger_batch``, one cohort a contract
     class, on the host); then commits the inputs to the uniqueness
     provider in one ``commit_batch``;
  4. signs every accepted id (``ops/ed25519_sign.py``: kernel E).

  ``request()`` answers one transaction through a window: requests gather
  until ``max_batch`` are pending or ``window_s`` passes, and a pipeline of
  four threads (the flusher, then the commit, signing and finalize
  stages on queues of 4) keeps consecutive windows in flight.
  ``process_batch`` runs one window; ``process_stream`` keeps up to
  ``depth`` windows in flight from one thread. The service's ``device``
  (the card unless ``device="cpu"``) runs the id sweep, the scheduler and
  the signing; ``use_device=False`` is the host tier: hashlib ids, the
  oracle's verdicts and host signing, with the same results.

Every attestation is remembered in a bounded cache keyed by the tx id, so
a client that retries after a lost response gets the original signature
back without a second verification or commit. One difference from the
reference: ``request()`` reads a transaction's id only if it is already
known (the id cache of its wire transaction is warm). A request whose id
is cold is answered from the cache after its window's id sweep has
recomputed the id on the card, not at the door: reading the id at the
door would hash it on the caller's thread and leave the card's sweep with
nothing to do.

A window committed through a BFT cluster with BLS keys
(``BFTUniquenessProvider``) carries the round's quorum certificate: the
service verifies it once a window (``_collect_qc``) and caches it beside
each accepted id's attestation (``cached_qc``).

Over a ``DurableUniquenessProvider`` the cache is journaled: every
remembered attestation rides the provider's write-ahead log
(``record_signature``), and a service built over a recovered provider
preloads the cache from ``recovered_signatures``, so a request retried
after a restart gets its original signature bytes back.

Left out: the reference's link gate for a lightly loaded window (the probe
of the link's round trip and ``device_verify_worthwhile``; ROADMAP.md,
Queue 1 item 16's remainder): every window rides the device.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future

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
from ..flows.overload import active_overload, remaining_deadline
from ..ledger import (
    ComponentGroupType,
    FilteredTransaction,
    Party,
    SignedTransaction,
    TimeWindow,
    verify_ledger_batch,
)
from ..observability import SPAN_NOTARY_ATTEST, SPAN_NOTARY_SUBMIT, tracer
from ..ops.ed25519 import Ed25519Tier
from ..ops.ed25519_sign import ed25519_sign_dispatch
from ..ops.txid import dispatch_prime_ids
from ..serving import BULK, FuturePending, ServingError, device_scheduler
from ..serving.scheduler import drain_at_exit
from ..verifier import dispatch_transactions
from .uniqueness import NotaryError, UniquenessProvider

TIME_TOLERANCE_MICROS = 30 * 1_000_000  # 30 s either side of the notary's clock
STAGE_QUEUE = 4  # windows waiting between two stages of the request pipeline


class NotaryInternalException(Exception):
    pass


class NotaryService:
    """Identity, uniqueness, signing and the time-window policy, with the
    bounded cache of issued attestations (keyed by tx id): a client that
    retries after a lost response gets the ORIGINAL signature back, with
    no second verification or commit (the uniqueness providers are
    idempotent per tx id for the same reason; the cache is the fast path
    over that guarantee). Past ``SIGNED_CACHE_MAX`` entries the older half
    is evicted."""

    SIGNED_CACHE_MAX = 8192

    def __init__(self, identity: Party, keypair: KeyPair,
                 uniqueness: UniquenessProvider, clock=time.time):
        if keypair.public != identity.owning_key:
            raise ValueError("notary keypair must match identity key")
        self.identity = identity
        self._keypair = keypair
        self.uniqueness = uniqueness
        self._clock = clock
        self._signed_cache: dict = {}
        # tx id -> the quorum certificate of the consensus round that
        # committed it (a BFT cluster's), riding the signed cache's lock,
        # order and eviction
        self._qc_cache: dict = {}
        self._signed_order: list = []
        self._signed_lock = threading.Lock()
        # a durable provider's attestation journal (DurableUniquenessProvider)
        # preloads the cache across restarts: a recovering notary answers a
        # pre-crash retry with the ORIGINAL attestation, never a second one
        self._sig_journal = getattr(uniqueness, "record_signature", None)
        recovered = getattr(uniqueness, "recovered_signatures", None)
        if recovered is not None:
            for tx_id, sig in recovered().items():
                self._signed_cache[tx_id] = sig
                self._signed_order.append(tx_id)

    def sign(self, tx_id: SecureHash) -> TransactionSignature:
        return sign_tx_id(self._keypair.private, self._keypair.public, tx_id)

    def cached_signature(self, tx_id: SecureHash) -> TransactionSignature | None:
        """The original attestation of an already notarised tx, if it is
        still in the cache (a miss only means the idempotent full path
        runs again)."""
        with self._signed_lock:
            return self._signed_cache.get(tx_id)

    def cached_qc(self, tx_id: SecureHash):
        """The quorum certificate cached beside an attestation, if any."""
        with self._signed_lock:
            return self._qc_cache.get(tx_id)

    def remember_signature(self, tx_id: SecureHash, sig: TransactionSignature,
                           qc=None) -> None:
        with self._signed_lock:
            if tx_id in self._signed_cache:
                if qc is not None:
                    self._qc_cache.setdefault(tx_id, qc)
                return
            self._signed_cache[tx_id] = sig
            if qc is not None:
                self._qc_cache[tx_id] = qc
            self._signed_order.append(tx_id)
            if len(self._signed_order) > self.SIGNED_CACHE_MAX:
                half = len(self._signed_order) // 2
                evict = self._signed_order[:half]
                del self._signed_order[:half]
                for t in evict:
                    self._signed_cache.pop(t, None)
                    self._qc_cache.pop(t, None)
        if self._sig_journal is not None:
            # outside the cache lock: the journal append takes the
            # provider's own lock and rides its next group-commit flush
            self._sig_journal(tx_id, sig)

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


class SimpleNotaryService(NotaryService):
    """Non-validating: trusts the requester about everything but
    uniqueness, and sees only the tear-off."""

    def process(self, ftx: FilteredTransaction, caller_name: str) -> TransactionSignature:
        trc = tracer()
        with trc.start(SPAN_NOTARY_ATTEST, trc.current(),
                       attrs={"tx.id": str(ftx.id), "service": "simple"}):
            return self._process_inner(ftx, caller_name)

    def _process_inner(self, ftx, caller_name):
        cached = self.cached_signature(ftx.id)
        if cached is not None:
            return cached  # a resubmission: the original attestation
        ftx.verify()  # every proof must chain to ftx.id
        # the inputs, the time window and the notary must be wholly
        # visible: a requester hiding the time-window group would skip
        # the expiry check
        ftx.check_all_components_visible(ComponentGroupType.INPUTS)
        ftx.check_all_components_visible(ComponentGroupType.TIMEWINDOW)
        ftx.check_all_components_visible(ComponentGroupType.NOTARY)
        inputs = ftx.components_of(ComponentGroupType.INPUTS)
        tws = ftx.components_of(ComponentGroupType.TIMEWINDOW)
        notaries = ftx.components_of(ComponentGroupType.NOTARY)
        self._check_notary(notaries[0] if notaries else None, ftx.id)
        self.check_time_window(tws[0] if tws else None)
        self.uniqueness.commit(list(inputs), ftx.id, caller_name)
        sig = self.sign(ftx.id)
        self.remember_signature(ftx.id, sig)
        return sig


class ValidatingNotaryService(NotaryService):
    """Validating: the signatures and the contracts are verified before
    the commit (ValidatingNotaryFlow.kt:23-51)."""

    def process(self, stx: SignedTransaction, resolve_state,
                caller_name: str) -> TransactionSignature:
        trc = tracer()
        with trc.start(SPAN_NOTARY_ATTEST, trc.current(),
                       attrs={"tx.id": str(stx.id), "service": "validating"}):
            return self._process_inner(stx, resolve_state, caller_name)

    def _process_inner(self, stx, resolve_state, caller_name):
        cached = self.cached_signature(stx.id)
        if cached is not None:
            return cached  # a resubmission: the original attestation
        stx.verify_signatures_except({self.identity.owning_key})
        wtx = stx.tx
        self._check_notary(wtx.notary, stx.id)
        ltx = wtx.to_ledger_transaction(resolve_state)
        ltx.verify()
        self.check_time_window(wtx.time_window)
        self.uniqueness.commit(list(wtx.inputs), stx.id, caller_name)
        sig = self.sign(stx.id)
        self.remember_signature(stx.id, sig)
        return sig


class _PendingRequest:
    """One ``request()`` waiting in a window: its triple, its future, its
    ``notary.submit`` span and its flow's deadline (an absolute epoch, or
    None), both taken on the caller's thread."""

    __slots__ = ("stx", "resolve_state", "caller", "future", "span", "deadline_t")

    def __init__(self, stx, resolve_state, caller, span):
        self.stx = stx
        self.resolve_state = resolve_state
        self.caller = caller
        self.future: Future = Future()
        self.span = span
        self.deadline_t: float | None = None

    @property
    def triple(self) -> tuple:
        return self.stx, self.resolve_state, self.caller


def _settle(future: Future, result) -> None:
    """Resolve a request's future with a signature or an error; a future
    its caller cancelled is left so."""
    try:
        if isinstance(result, BaseException):
            future.set_exception(result)
        else:
            future.set_result(result)
    except Exception:
        pass


def _warm_id(stx) -> SecureHash | None:
    """The transaction's id if its wire transaction already knows it."""
    return object.__getattribute__(stx.tx, "__dict__").get("_id")


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
    ``resolver(StateRef) -> TransactionState``. ``request()`` flushes a
    window when ``max_batch`` requests are pending or ``window_s`` has
    passed; ``metrics`` (a ``MetricRegistry``) gets the
    ``notary.requests`` and ``notary.committed`` meters."""

    def __init__(self, identity, keypair, uniqueness, *, max_batch: int = 1024,
                 window_s: float = 0.005, use_device: bool = True,
                 validating: bool = True, use_scheduler: bool = True,
                 metrics=None, device=None, tier: Ed25519Tier | None = None,
                 batch_rlc: bool = True, clock=time.time):
        super().__init__(identity, keypair, uniqueness, clock)
        self._max_batch = max_batch
        self._window_s = window_s
        self._use_device = use_device
        self._use_scheduler = use_scheduler
        self._validating = validating
        self._metrics = metrics
        self.device = resolve_device(device)
        self.tier = tier
        self.batch_rlc = batch_rlc
        self._pending: list[_PendingRequest] = []
        self._lock = threading.Lock()
        self._flusher: threading.Thread | None = None
        self._wake = threading.Event()
        self._stopped = False

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

    def process_stream(self, batches, *, depth: int | None = None
                       ) -> list[list[TransactionSignature | Exception]]:
        """Pipelined notarisation over an iterable of windows: up to
        ``depth`` windows wait in each stage (id sweep, signature check,
        commit, signing) while the host settles earlier ones. ``depth``
        defaults to 3, and on the scheduler route to at least the shared
        scheduler's stripe width (a window in flight a stripe member)."""
        if depth is None:
            depth = 3
            if self._use_scheduler and self.device.type == "cuda":
                depth = max(depth, device_scheduler(
                    self.device, self.tier, self.batch_rlc).mesh_stripe_width())
        priming: deque = deque()     # (batch, pending id sweep)
        verifying: deque = deque()   # (batch, pending signature check)
        committing: deque = deque()  # (batch, staged commit)
        signing: deque = deque()     # (results, accepted, pending signatures, ids, qc)
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
        """Resolve the uniqueness commit (and the round's verified quorum
        certificate, if any) and enqueue the response signing;
        ``finalize_batch`` fills in the signatures."""
        conflicts = pending_commit.collect()
        qc = self._collect_qc()
        accepted: list[int] = []
        for i, conflict in zip(live, conflicts):
            if conflict is not None:
                results[i] = NotaryError(
                    f"input states of {requests[i][0].id} already consumed", conflict,
                )
            else:
                accepted.append(i)
        accepted_ids = [requests[i][0].id for i in accepted]
        pending_sigs = self._dispatch_sign(accepted_ids, on_device=on_device)
        return results, accepted, pending_sigs, accepted_ids, qc

    def _collect_qc(self):
        """The quorum certificate of the round just collected, verified
        here (one aggregate pairing check a window, not a transaction), or
        None. Only a BFT provider with BLS membership offers one; a
        certificate that fails the check is dropped (the round's ed25519
        attestations already carry correctness)."""
        take = getattr(self.uniqueness, "take_qc", None)
        qc = take() if take is not None else None
        if qc is None:
            return None
        keys = getattr(self.uniqueness, "bls_member_keys", None) or []
        if not qc.verify(keys):
            if self._metrics is not None:
                self._metrics.counter("notary.qc.rejected").inc()
            return None
        if self._metrics is not None:
            self._metrics.counter("notary.qc.cached").inc()
        return qc

    def finalize_batch(self, results, accepted, pending_sigs, accepted_ids, qc=None
                       ) -> list[TransactionSignature | Exception]:
        """Fill in the response signatures and remember each one (with the
        round's quorum certificate), so a retried request is answered from
        the cache."""
        for i, tx_id, sig in zip(accepted, accepted_ids, pending_sigs.collect()):
            results[i] = sig
            self.remember_signature(tx_id, sig, qc=qc)
        if self._metrics is not None:
            self._metrics.meter("notary.requests").mark(len(results))
            self._metrics.meter("notary.committed").mark(
                sum(1 for r in results if isinstance(r, TransactionSignature))
            )
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

    # --------------------------------------------------------- async path

    def request(self, stx: SignedTransaction, resolve_state, caller: str) -> Future:
        """Notarise one transaction through a window: a Future of its
        ``TransactionSignature`` (or of the ``NotaryError`` that refused
        it). A request whose flow's deadline (``flows.deadline_scope``) has
        passed is shed here, before it takes a window's slot."""
        tx_id = _warm_id(stx)
        cached = None if tx_id is None else self.cached_signature(tx_id)
        if cached is not None:
            # a resubmission: the original attestation, with no window slot
            fut: Future = Future()
            fut.set_result(cached)
            return fut
        rem = remaining_deadline()
        if rem is not None and rem <= 0.0:
            ov = active_overload()
            if ov is not None:
                ov.note_deadline_shed()
            raise NotaryInternalException("notary request shed: flow deadline exceeded")
        trc = tracer()
        attrs = {"caller": caller}
        if tx_id is not None:
            attrs["tx.id"] = str(tx_id)
        span = trc.start(SPAN_NOTARY_SUBMIT, trc.current(), attrs=attrs)
        req = _PendingRequest(stx, resolve_state, caller, span)
        if rem is not None:
            req.deadline_t = time.time() + rem
        if span.sampled:
            def close_span(f: Future):
                err = f.exception() if not f.cancelled() else None
                if err is not None:
                    span.set_error(err)
                span.finish()

            req.future.add_done_callback(close_span)
        with self._lock:
            if self._stopped:
                err = NotaryInternalException("notary service stopped")
                span.set_error(err)
                span.finish()
                raise err
            self._pending.append(req)
            if self._flusher is None:
                self._flusher = threading.Thread(
                    target=self._flush_loop, daemon=True, name="notary-batcher")
                self._flusher.start()
                drain_at_exit(self)
            if len(self._pending) >= self._max_batch:
                self._wake.set()
        return req.future

    def _take_window(self) -> tuple[list, bool]:
        """The next window (at most ``max_batch`` pending requests, oldest
        first) less the requests whose deadline passed while they waited,
        which fail here; and whether the service is stopping."""
        with self._lock:
            batch = self._pending[: self._max_batch]
            self._pending = self._pending[self._max_batch :]
            stopped = self._stopped
        now = time.time()
        live = []
        for r in batch:
            if r.deadline_t is not None and now >= r.deadline_t:
                ov = active_overload()
                if ov is not None:
                    ov.note_deadline_shed()
                _settle(r.future, NotaryInternalException(
                    "notary request shed: flow deadline exceeded while batched"))
            else:
                live.append(r)
        return live, stopped

    def _answer_cached(self, batch: list) -> list:
        """After the window's id sweep has primed every id: answer the
        requests already attested from the cache; returns the others."""
        rest = []
        for r in batch:
            tx_id = r.stx.id
            if r.span.sampled:
                r.span.set_attr("tx.id", str(tx_id))
            cached = self.cached_signature(tx_id)
            if cached is None:
                rest.append(r)
            else:
                _settle(r.future, cached)
        return rest

    def _flush_loop(self) -> None:
        """Stage 1 of the request pipeline: cut the pending requests into
        windows, enqueue each window's id sweep one window ahead (window
        k+1's sweep is queued before window k's is collected), then its
        signature check. The commit stage (collect the verdicts, validate,
        commit), the signing stage (collect the commit, enqueue kernel E)
        and the finalize stage (collect the signatures, settle the
        futures) run on threads of their own, so consecutive windows
        overlap their device work, as ``process_stream``'s do. A window
        whose dispatch or settlement raises fails its requests with that
        error: nothing is settled on the host instead."""
        commit_q: queue.Queue = queue.Queue(maxsize=STAGE_QUEUE)
        sign_q: queue.Queue = queue.Queue(maxsize=STAGE_QUEUE)
        final_q: queue.Queue = queue.Queue(maxsize=STAGE_QUEUE)

        def commit_loop():
            while True:
                item = commit_q.get()
                if item is None:
                    sign_q.put(None)
                    return
                batch, pending = item
                reqs = [r.triple for r in batch]
                try:
                    sign_q.put((batch, reqs, self.settle_validate(reqs, pending), None))
                except Exception as e:
                    sign_q.put((batch, None, None, e))

        def sign_loop():
            while True:
                item = sign_q.get()
                if item is None:
                    final_q.put(None)
                    return
                batch, reqs, staged, err = item
                if err is None:
                    try:
                        staged = self.settle_sign(reqs, *staged)
                    except Exception as e:
                        err = e
                final_q.put((batch, staged, err))

        def finalize_loop():
            while True:
                item = final_q.get()
                if item is None:
                    return
                batch, staged, err = item
                if err is None:
                    try:
                        results = self.finalize_batch(*staged)
                    except Exception as e:
                        results = [e] * len(batch)
                else:
                    results = [err] * len(batch)
                for req, res in zip(batch, results):
                    _settle(req.future, res)

        stages = [threading.Thread(target=fn, daemon=True, name=f"notary-{name}")
                  for fn, name in ((commit_loop, "committer"), (sign_loop, "signer"),
                                   (finalize_loop, "finalizer"))]
        for t in stages:
            t.start()

        def fail(batch, err):
            for req in batch:
                _settle(req.future, err)

        try:
            while True:
                self._wake.wait(timeout=self._window_s)
                self._wake.clear()
                ahead = None  # (batch, pending id sweep)
                while True:
                    batch, stopped = self._take_window()
                    nxt = None
                    if batch:
                        try:
                            nxt = (batch, self.dispatch_ids([r.triple for r in batch]))
                        except Exception as e:
                            fail(batch, e)
                    if ahead is not None:
                        a_batch, a_ids = ahead
                        try:
                            if a_ids is not None:
                                a_ids.collect()
                            a_batch = self._answer_cached(a_batch)
                            if a_batch:
                                # every id is primed now: the sweep that
                                # dispatch_batch starts finds none cold
                                commit_q.put((a_batch, self.dispatch_batch(
                                    [r.triple for r in a_batch])))
                        except Exception as e:
                            fail(a_batch, e)
                    ahead = nxt
                    if ahead is None:
                        break
                if stopped:
                    return
        finally:
            commit_q.put(None)
            for t in stages:
                t.join(timeout=5)

    def shutdown(self) -> None:
        """Stop taking requests; the pending ones are flushed first."""
        with self._lock:
            self._stopped = True
        self._wake.set()
        if self._flusher is not None:
            self._flusher.join(timeout=15)
