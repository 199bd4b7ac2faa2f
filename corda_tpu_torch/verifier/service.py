"""Transaction verifier services (counterpart of corda_tpu/verifier/service.py).

Parity with the reference's two ``TransactionVerifierService`` impls
(node/.../services/transactions/InMemoryTransactionVerifierService.kt:11-14,
OutOfProcessTransactionVerifierService.kt:20-71) plus the batching third
tier: a service that accumulates concurrent verification requests and
settles their signatures as device batches, their contract semantics on a
host thread pool.

``BatchedVerifierService`` has the reference's two routes:

- ``use_scheduler=True`` (the default): every ``verify_signed`` submits
  into the shared device scheduler of the service's ed25519 tier
  (``serving/scheduler.py``, the SERVICE class), which coalesces it with
  every other client's rows;
- ``use_scheduler=False``: the windowed flusher, which settles one
  ``check_transactions`` a window of at most ``max_batch`` requests, the
  window owed from the oldest pending request's arrival.

The service runs on the card unless ``device="cpu"``; ``use_device=False``
settles every signature on the host, as the reference's switch does.
``tier`` picks the ed25519 ladder. A failed dispatch or readback fails
the requests it carried with the error, on both routes.

A request whose rows no engine verifies one signature of (a composite key
given as an individual signer) raises ``CryptoError`` as in the
reference: on the scheduler route it fails that request alone, on the
windowed route it fails the whole window's ``check_transactions``, and
so every request of the window.

Not ported with this module, and listed in ROADMAP.md: the
``verifier.request`` span and the ``verifier.request_s`` timer of the
scheduler route (reference :174, :243), which come with tracing and the
node's metrics (Queue 1 step 4 and item 6).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor

from ..ledger import LedgerTransaction, SignedTransaction
from ..ops.ed25519 import Ed25519Tier
from .batch import check_transactions


class VerificationError(Exception):
    pass


def _complete(future: Future, error: Exception | None = None) -> None:
    """Complete a future, tolerating caller-side cancellation (a cancelled
    future raising InvalidStateError must not abort completion of the rest
    of a batch)."""
    try:
        if error is None:
            future.set_result(None)
        else:
            future.set_exception(error)
    except Exception:
        pass


class TransactionVerifierService:
    """verify() returns a Future completing when verification finishes
    (reference: TransactionVerifierService.kt:10 returning CordaFuture)."""

    def verify(self, ltx: LedgerTransaction) -> Future:
        raise NotImplementedError

    def shutdown(self) -> None:
        pass


class InMemoryVerifierService(TransactionVerifierService):
    """Host thread-pool verification: the reference's default 4-thread
    in-process service (contract semantics only)."""

    def __init__(self, workers: int = 4):
        self._pool = ThreadPoolExecutor(max_workers=workers)

    def verify(self, ltx: LedgerTransaction) -> Future:
        return self._pool.submit(ltx.verify)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False)


class _Pending:
    __slots__ = ("stx", "resolve_state", "allowed_missing", "future",
                 "arrived")

    def __init__(self, stx, resolve_state, allowed_missing, future):
        self.stx = stx
        self.resolve_state = resolve_state
        self.allowed_missing = allowed_missing
        self.future = future
        # first-arrival timestamp: the flush window is owed from HERE even
        # when the item is sliced off beyond max_batch and carried into a
        # later flush decision
        self.arrived = time.monotonic()


class BatchedVerifierService(TransactionVerifierService):
    """The batching tier (the reference's :83). ``verify_signed`` is the
    full-tx entry (signatures in a device batch, then the contract run on
    this service's pool); ``verify`` keeps the reference's
    LedgerTransaction-only contract (semantics only, host pool).

    ``stats`` counts the device batches this service's requests landed in
    (a bounded window of batch sequence numbers dedupes them on the
    scheduler route; one a flush on the windowed route), the transactions,
    their signature rows, and the rows that settled on the device."""

    def __init__(
        self,
        *,
        max_batch: int = 4096,
        window_s: float = 0.005,
        workers: int = 8,
        use_device: bool = True,
        use_scheduler: bool = True,
        device=None,
        tier: Ed25519Tier | None = None,
    ):
        self._max_batch = max_batch
        self._window_s = window_s
        self._use_device = use_device
        self._use_scheduler = use_scheduler
        self._device = device
        self._tier = tier
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._lock = threading.Condition()
        self._queue: list[_Pending] = []
        self._closed = False
        self._outstanding: set[Future] = set()   # scheduler-routed futures
        self._batch_seqs: set[int] = set()
        self._batch_seq_order: "deque[int]" = deque(maxlen=4096)
        self._flusher: threading.Thread | None = None
        if not use_scheduler:
            self._flusher = threading.Thread(
                target=self._flush_loop, name="verifier-flusher", daemon=True
            )
            self._flusher.start()
        # the scheduler imports this package
        from ..serving.scheduler import drain_at_exit

        drain_at_exit(self)
        self.stats = {"batches": 0, "txs": 0, "sigs": 0, "device_sigs": 0}

    @property
    def use_device(self) -> bool:
        return self._use_device

    @property
    def routes_via_scheduler(self) -> bool:
        return self._use_scheduler

    # ------------------------------------------------------------- entries
    def verify(self, ltx: LedgerTransaction) -> Future:
        return self._pool.submit(ltx.verify)

    def verify_signed(
        self,
        stx: SignedTransaction,
        resolve_state=None,
        allowed_missing: set | None = None,
    ) -> Future:
        """Queue a full verification (device signature batch + host contract
        run when ``resolve_state`` is given). Completes with None or fails
        with the verification error. The scheduler's admission errors
        (closed, saturated) raise here."""
        if self._use_scheduler:
            return self._submit_via_scheduler(
                stx, resolve_state, allowed_missing or set()
            )
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise VerificationError("verifier service is shut down")
            self._queue.append(
                _Pending(stx, resolve_state, allowed_missing or set(), fut)
            )
            self._lock.notify()
        return fut

    # -------------------------------------------------- scheduler routing
    def _scheduler(self):
        from ..serving import device_scheduler

        device = self._device
        if device is None and not self._use_device:
            # host-routed requests never reach the device: a machine
            # without a card runs them on a scheduler of the CPU
            import torch

            if not torch.cuda.is_available():
                device = "cpu"
        return device_scheduler(device, self._tier)

    def _count(self, report) -> None:
        """Add one report to ``stats``; the caller holds the lock."""
        self.stats["txs"] += len(report.results)
        self.stats["sigs"] += report.n_sigs
        self.stats["device_sigs"] += report.n_device

    def _submit_via_scheduler(self, stx, resolve_state, allowed) -> Future:
        from ..serving import SERVICE

        with self._lock:
            if self._closed:
                raise VerificationError("verifier service is shut down")
            fut: Future = Future()
            self._outstanding.add(fut)
        try:
            inner = self._scheduler().submit_transactions(
                [stx], [allowed], priority=SERVICE, use_device=self._use_device,
            )
        except Exception:
            with self._lock:
                self._outstanding.discard(fut)
            raise

        def settle(f: Future):
            try:
                report = f.result()
                with self._lock:
                    self._count(report)
                    if report.batch_seq is not None and \
                            report.batch_seq not in self._batch_seqs:
                        # distinct device batches this service's requests
                        # landed in, over a bounded window of sequence numbers
                        if len(self._batch_seq_order) == self._batch_seq_order.maxlen:
                            self._batch_seqs.discard(self._batch_seq_order[0])
                        self._batch_seq_order.append(report.batch_seq)
                        self._batch_seqs.add(report.batch_seq)
                        self.stats["batches"] += 1
                err = report.results[0]
            except Exception as e:
                err = e

            def finish():
                try:
                    if err is not None:
                        _complete(fut, error=err)
                    elif resolve_state is not None:
                        stx.tx.to_ledger_transaction(resolve_state).verify()
                        _complete(fut)
                    else:
                        _complete(fut)
                except Exception as e:
                    _complete(fut, error=e)
                finally:
                    with self._lock:
                        self._outstanding.discard(fut)

            try:
                self._pool.submit(finish)
            except RuntimeError:
                finish()  # pool already shut down: finish inline

        inner.add_done_callback(settle)
        return fut

    # ------------------------------------------------------------- flusher
    def _flush_loop(self) -> None:
        while True:
            with self._lock:
                while not self._queue and not self._closed:
                    self._lock.wait()
                if self._closed and not self._queue:
                    return
                # the window is owed from the OLDEST pending item's arrival
                # (which may predate this loop iteration when leftovers were
                # sliced off a full batch)
                deadline = self._queue[0].arrived + self._window_s
                while len(self._queue) < self._max_batch and not self._closed:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._lock.wait(timeout=remaining)
                batch = self._queue[: self._max_batch]
                self._queue = self._queue[self._max_batch :]
            if batch:
                self._flush(batch)

    def _flush(self, batch: list[_Pending]) -> None:
        try:
            report = check_transactions(
                [p.stx for p in batch], [p.allowed_missing for p in batch],
                use_device=self._use_device, device=self._device, tier=self._tier,
            )
        except Exception as e:
            for p in batch:
                _complete(p.future, error=e)
            return
        # the same lock as the scheduler route's settle: stats is one
        # surface whichever route served the batch
        with self._lock:
            self.stats["batches"] += 1
            self._count(report)

        def finish(p: _Pending, sig_err):
            if sig_err is not None:
                _complete(p.future, error=sig_err)
                return
            try:
                if p.resolve_state is not None:
                    p.stx.tx.to_ledger_transaction(p.resolve_state).verify()
                _complete(p.future)
            except Exception as e:
                _complete(p.future, error=e)

        for p, err in zip(batch, report.results):
            try:
                self._pool.submit(finish, p, err)
            except RuntimeError:
                # pool already shut down (service closing): finish inline so
                # no caller blocks on an unresolved future
                finish(p, err)

    def shutdown(self) -> None:
        """Stop accepting work; every queued and in-flight future completes
        (result or error) before this returns. Idempotent: a second
        shutdown does nothing."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            outstanding = list(self._outstanding)
            self._lock.notify_all()
        if self._flusher is not None:
            self._flusher.join()
        if outstanding:
            import concurrent.futures as _cf

            _cf.wait(outstanding, timeout=60)
        self._pool.shutdown(wait=True)
