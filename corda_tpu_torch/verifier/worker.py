"""Out-of-process verification worker + the node-side service that feeds it
(counterpart of corda_tpu/verifier/worker.py).

Capability parity with the reference's verifier module (verifier/src/main/
kotlin/net/corda/verifier/Verifier.kt:49-94) and the node side
(node/.../transactions/OutOfProcessTransactionVerifierService.kt:20-71,
wire contract node-api/.../VerifierApi.kt:10-59):

- stateless workers consume ``verifier.requests`` from the durable broker,
  verify the carried transaction, reply to the request's reply queue, ack;
- N workers are competing consumers on one queue — the broker's
  visibility-timeout redelivery re-assigns un-acked work when a worker
  dies (the elasticity property VerifierTests.kt:55-113 proves);
- the node publishes requests tagged with a nonce and completes the
  matching future when the response arrives; responses are idempotent.

A worker verifies the full semantic package: every signature present and
required (minus the notary's during assembly) and the contract semantics
via ``LedgerTransaction.verify`` — signature math goes through
``check_transactions`` on the worker's ``device`` (the card unless
``device="cpu"``) and ed25519 ``tier``; ``use_device=False`` asks for the
reference's pure host check instead. ``python -m corda_tpu_torch.verifier.worker
<broker.db> --cordapp corda_tpu_torch.finance`` serves a
``DurableQueueBroker`` file on the card; each ``--cordapp`` module is
imported first, which registers its contracts (a worker runs only the
contract code its process has registered or that a transaction's
attachments carry, as a node does).

Not ported yet: the worker as a certified peer of a node's secure fabric
(``run_worker(fabric_address=...)``, ``--fabric``), which needs
``SecureFabricClient`` and ``node/certificates.py`` (ROADMAP.md, Queue 1
step 9); it raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import logging
import random as _rand
import re
import threading
import time
from concurrent.futures import Future

from ..ledger import LedgerTransaction, SignedTransaction
from ..ops.ed25519 import Ed25519Tier
from ..serialization import cbe_serializable, deserialize, serialize

logger = logging.getLogger(__name__)

VERIFICATION_REQUESTS_QUEUE = "verifier.requests"
VERIFICATION_RESPONSES_QUEUE_PREFIX = "verifier.responses."
# requests whose payload can't even name a reply queue land here for ops
# (the reference surfaces these only in the worker log; a queue lets the
# node count them — see DeadLetter)
VERIFICATION_DEAD_LETTER_QUEUE = "verifier.dead-letter"

# request msg_ids are "vreq-<reply_queue>-<nonce>[xattempt]"; the routing is
# recoverable from the id alone, so a worker can reply a structured error
# even when the payload is garbage (a CBE version skew between node and
# worker must degrade to an error reply, not a hung future)
_REQ_MSG_ID = re.compile(
    r"^vreq-(?P<reply>" + re.escape(VERIFICATION_RESPONSES_QUEUE_PREFIX)
    + r".+)-(?P<nonce>\d+)(?:x\d+)?$"
)


@cbe_serializable(name="verifier.Request")
@dataclasses.dataclass(frozen=True)
class VerificationRequest:
    """reference: VerifierApi.VerificationRequest (:17-38) — nonce, the
    transaction to verify, and where to reply. The signed form travels too
    so workers check signatures, not just contracts."""

    nonce: int
    stx: SignedTransaction
    ltx: LedgerTransaction
    reply_to: str


@cbe_serializable(name="verifier.Response")
@dataclasses.dataclass(frozen=True)
class VerificationResponse:
    """reference: VerifierApi.VerificationResponse (:40-58)."""

    nonce: int
    error: str = ""   # empty = verified


@cbe_serializable(name="verifier.DeadLetter")
@dataclasses.dataclass(frozen=True)
class DeadLetter:
    """A request the worker could neither process nor answer (payload
    undecodable AND msg_id unparseable): parked on the dead-letter queue
    with enough context for an operator to diagnose."""

    msg_id: str
    error: str
    payload: bytes


class VerifierWorker:
    """One stateless worker process/thread (reference: Verifier.main loop
    :66-84). It checks signatures on ``device``, the card unless
    ``device="cpu"``; ``use_device=False``, the reference's default, is the
    host check."""

    def __init__(self, broker, use_device: bool = True,
                 worker_name: str = "verifier-worker", device=None,
                 tier: Ed25519Tier | None = None):
        self._broker = broker
        self._use_device = use_device
        self._device = device
        self._tier = tier
        self.name = worker_name
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.verified = 0
        self.failed = 0
        self.malformed = 0

    # ------------------------------------------------------------ serving
    def serve_one(self, timeout: float = 0.5) -> bool:
        """Consume and process one request; returns False on timeout."""
        msg = self._broker.consume(VERIFICATION_REQUESTS_QUEUE, timeout=timeout)
        if msg is None:
            return False
        try:
            req = deserialize(msg.payload)
            if not isinstance(req, VerificationRequest):
                raise TypeError(
                    f"expected VerificationRequest, got {type(req).__name__}"
                )
            error = self._verify(req)
        except Exception as e:
            # malformed request (e.g. node↔worker CBE version skew): the
            # node-side future must not hang. Routing is recoverable from
            # the msg_id even when the payload isn't — reply a structured
            # error; otherwise dead-letter for ops.
            logger.exception("malformed verification request")
            self.malformed += 1
            self._answer_malformed(msg, e)
            self._broker.ack(msg.msg_id)
            return True
        response = VerificationResponse(req.nonce, error)
        # reply THEN ack: a crash in between redelivers the request and the
        # node dedupes the duplicate response by nonce (at-least-once)
        self._broker.publish(
            req.reply_to, serialize(response),
            msg_id=f"vresp-{req.nonce}", sender=self.name,
        )
        self._broker.ack(msg.msg_id)
        if error:
            self.failed += 1
        else:
            self.verified += 1
        return True

    def _answer_malformed(self, msg, exc: Exception) -> None:
        m = _REQ_MSG_ID.match(msg.msg_id or "")
        if m is not None:
            self._broker.publish(
                m.group("reply"),
                serialize(VerificationResponse(
                    int(m.group("nonce")),
                    f"malformed request: {type(exc).__name__}: {exc}",
                )),
                msg_id=f"vresp-{m.group('nonce')}", sender=self.name,
            )
            return
        self._broker.publish(
            VERIFICATION_DEAD_LETTER_QUEUE,
            serialize(DeadLetter(
                msg.msg_id or "", f"{type(exc).__name__}: {exc}",
                bytes(msg.payload),
            )),
            msg_id=f"vdead-{msg.msg_id}", sender=self.name,
        )

    def _verify(self, req: VerificationRequest) -> str:
        try:
            # contract-only requests carry stx=None (CBE encodes None
            # natively); `0` is accepted for wire skew with pre-r5 writers
            # that punned the absent field as an int
            if req.stx is not None and req.stx != 0:
                from .batch import check_transactions

                report = check_transactions(
                    [req.stx],
                    [({req.ltx.notary.owning_key}
                      if req.ltx.notary is not None else set())],
                    use_device=self._use_device, device=self._device,
                    tier=self._tier,
                )
                report.raise_first()
            req.ltx.verify()
            return ""
        except Exception as e:
            return f"{type(e).__name__}: {e}"

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "VerifierWorker":
        self._thread = threading.Thread(
            target=self._loop, name=self.name, daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        from ..messaging.queue import QueueClosedError

        while not self._stop.is_set():
            try:
                self.serve_one()
            except (QueueClosedError, ConnectionError):
                return
            except Exception:
                logger.exception("verifier worker iteration failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


@dataclasses.dataclass
class _PendingRequest:
    future: Future
    payload: bytes           # the serialized request, for retry republish
    deadline: float
    attempts: int = 0        # republish count so far


class OutOfProcessVerifierService:
    """Node-side TransactionVerifierService publishing to the worker queue
    (reference: OutOfProcessTransactionVerifierService.kt — nonce→future
    map :32, response consumer :44-60, sendRequest :64-71).

    Every pending future carries a deadline: if no worker answers within
    ``request_timeout_s`` the request is republished under a fresh msg_id
    (up to ``max_retries`` times — covering a response lost to a worker
    crash after ack), then completed exceptionally. The broker's
    visibility-timeout redelivery handles workers that die mid-request, so
    the timeout should sit above the redelivery delay; this deadline is the
    backstop for everything redelivery can't see (no workers online for too
    long, poisoned responses, skew-dropped replies)."""

    def __init__(self, broker, node_name: str = "node",
                 request_timeout_s: float = 60.0, max_retries: int = 1):
        self._broker = broker
        self.reply_queue = VERIFICATION_RESPONSES_QUEUE_PREFIX + node_name
        self._request_timeout_s = request_timeout_s
        self._max_retries = max_retries
        self._lock = threading.Lock()
        self._pending: dict[int, _PendingRequest] = {}
        # run-unique nonce base: the broker's dedupe (msg_id → persistent
        # acked_ids) would silently drop a "vreq-...-1" republished by a
        # restarted node whose counter reset, spuriously timing out every
        # request up to the prior run's high-water mark
        self._nonce = (int(time.time() * 1e6) << 16) | _rand.getrandbits(16)
        self._sweep_interval_s = min(0.5, request_timeout_s / 4)
        self._last_sweep = 0.0
        self.timeouts = 0
        self.retries = 0
        self._stop = threading.Event()
        self._consumer = threading.Thread(
            target=self._consume_responses, name="verifier-responses",
            daemon=True,
        )
        self._consumer.start()

    def verify_stx(self, stx: SignedTransaction, resolve_state) -> Future:
        ltx = stx.tx.to_ledger_transaction(resolve_state)
        return self._submit(stx, ltx)

    def verify(self, ltx: LedgerTransaction) -> Future:
        """TransactionVerifierService face (contracts only, like the
        reference's LedgerTransaction-carrying requests)."""
        return self._submit(None, ltx)

    def _submit(self, stx, ltx) -> Future:
        fut: Future = Future()
        with self._lock:
            self._nonce += 1
            nonce = self._nonce
        payload = serialize(VerificationRequest(
            nonce, stx, ltx, self.reply_queue
        ))
        with self._lock:
            self._pending[nonce] = _PendingRequest(
                fut, payload, time.monotonic() + self._request_timeout_s
            )
        self._broker.publish(
            VERIFICATION_REQUESTS_QUEUE, payload,
            msg_id=f"vreq-{self.reply_queue}-{nonce}",
        )
        return fut

    def _consume_responses(self) -> None:
        from ..messaging.queue import QueueClosedError

        while not self._stop.is_set():
            try:
                msg = self._broker.consume(self.reply_queue, timeout=0.5)
            except (QueueClosedError, ConnectionError):
                return
            # handle the response in hand BEFORE sweeping: a verdict that
            # arrives at deadline+ε must win over its own timeout
            if msg is not None:
                try:
                    resp = deserialize(msg.payload)
                    # validate before popping — a nonce-bearing poisoned
                    # reply must not orphan the future past the sweep
                    if not isinstance(resp, VerificationResponse):
                        raise TypeError(
                            f"expected VerificationResponse, "
                            f"got {type(resp).__name__}"
                        )
                    with self._lock:
                        entry = self._pending.pop(resp.nonce, None)
                    fut = entry.future if entry is not None else None
                    if fut is not None and not fut.done():
                        if resp.error:
                            fut.set_exception(
                                VerificationFailedError(resp.error)
                            )
                        else:
                            fut.set_result(None)
                except Exception:
                    logger.exception("bad verification response dropped")
                self._broker.ack(msg.msg_id)
            self._sweep_expired()

    def _sweep_expired(self) -> None:
        now = time.monotonic()
        if now - self._last_sweep < self._sweep_interval_s:
            return       # O(pending) locked scan; don't pay it per message
        self._last_sweep = now
        retry, fail = [], []
        with self._lock:
            for nonce, entry in self._pending.items():
                if now < entry.deadline:
                    continue
                if entry.attempts < self._max_retries:
                    entry.attempts += 1
                    entry.deadline = now + self._request_timeout_s
                    self.retries += 1
                    retry.append((nonce, entry))
                else:
                    fail.append(nonce)
            failed = [self._pending.pop(n) for n in fail]
            self.timeouts += len(fail)
        for nonce, entry in retry:
            # fresh msg_id (the x-suffix) so broker dedupe doesn't drop
            # the republish; responses stay idempotent by nonce
            self._broker.publish(
                VERIFICATION_REQUESTS_QUEUE, entry.payload,
                msg_id=f"vreq-{self.reply_queue}-{nonce}x{entry.attempts}",
            )
        for entry in failed:
            if not entry.future.done():
                entry.future.set_exception(VerificationTimeoutError(
                    f"no verification response within "
                    f"{self._request_timeout_s:g}s "
                    f"(after {self._max_retries} retries)"
                ))

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def shutdown(self) -> None:
        self._stop.set()
        # the sweep stops with the consumer thread: complete anything still
        # pending so no caller stays blocked in fut.result() past shutdown
        with self._lock:
            remaining = list(self._pending.values())
            self._pending.clear()
        for entry in remaining:
            if not entry.future.done():
                entry.future.set_exception(VerificationTimeoutError(
                    "verifier service shut down with the request pending"
                ))


class VerificationFailedError(Exception):
    pass


class VerificationTimeoutError(VerificationFailedError):
    """The out-of-process tier never answered: workers offline past the
    deadline, or the reply was lost/undeliverable (reference contract:
    VerifierApi.kt:40-58 — a response always carries the outcome; this
    is the node-side backstop when none arrives)."""


def kernel_launches() -> dict:
    """This process's launches of each verify kernel a worker's check can
    reach (the wrappers' ``launches`` counts), by wrapper name."""
    from ..ops.ed25519_ladder import ed25519_verify_ladder, ed25519_verify_ladder_w4
    from ..ops.ed25519_ladder4096 import ed25519_verify_g4, ed25519_verify_g8
    from ..ops.scalar25519 import ed25519_challenge
    from ..ops.secp256_ladder import ecdsa_verify_k1, ecdsa_verify_r1
    from ..ops.sphincs_batch import sphincs_verify

    return {k.__name__: k.launches for k in (
        ed25519_challenge, ed25519_verify_ladder, ed25519_verify_ladder_w4,
        ed25519_verify_g8, ed25519_verify_g4, ecdsa_verify_k1, ecdsa_verify_r1,
        sphincs_verify)}


def run_worker(
    broker_path: str = "broker.db", use_device: bool = True,
    fabric_address: str | None = None, certs_dir: str | None = None,
    worker_name: str = "verifier-worker", device=None,
    tier: Ed25519Tier | None = None, report: str | None = None,
) -> None:
    """Process entry (reference: Verifier.main, Verifier.kt:49-87 — load
    config, open a connection TO THE NODE'S BROKER, consume
    verifier.requests) over the ``DurableQueueBroker`` file at
    ``broker_path``, verifying on ``device`` (the card unless
    ``device="cpu"``) with the ed25519 ``tier``. Serves until interrupted;
    then, with ``report``, writes a JSON summary there: the requests
    verified, failed and malformed, and ``kernel_launches()``. The fabric
    mode (``fabric_address``, ``certs_dir``: a certified peer of
    a node's secure broker) waits for ROADMAP.md Queue 1 step 9."""
    if fabric_address or certs_dir:
        raise NotImplementedError(
            "the verifier worker's fabric mode needs SecureFabricClient and "
            "node/certificates.py, which come with ROADMAP.md Queue 1 step 9; "
            "serve a DurableQueueBroker file instead"
        )
    from ..device import resolve_device
    from ..messaging import DurableQueueBroker

    if use_device:
        device = resolve_device(device)
    broker = DurableQueueBroker(broker_path)
    worker = VerifierWorker(broker, use_device=use_device,
                            worker_name=worker_name, device=device, tier=tier)
    logger.info("verifier worker serving %s", VERIFICATION_REQUESTS_QUEUE)
    try:
        while True:
            worker.serve_one(timeout=1.0)
    except (KeyboardInterrupt, ConnectionError):
        pass
    if report:
        import json

        with open(report, "w") as f:
            json.dump({"verified": worker.verified, "failed": worker.failed,
                       "malformed": worker.malformed, "launches": kernel_launches()}, f)


if __name__ == "__main__":
    import argparse

    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(prog="corda-tpu-torch-verifier")
    ap.add_argument("broker", nargs="?", default="broker.db",
                    help="shared sqlite broker file (non-fabric mode)")
    ap.add_argument("--fabric", default=None, metavar="HOST:PORT",
                    help="connect to a node's secure broker as a "
                         "certified peer (not ported yet)")
    ap.add_argument("--certs-dir", default=None,
                    help="identity.cbe/truststore.cbe directory "
                         "(fabric mode, not ported yet)")
    ap.add_argument("--name", default="verifier-worker")
    ap.add_argument("--no-device", action="store_true",
                    help="verify signatures with the host check")
    ap.add_argument("--device", default=None,
                    help="torch device of the check (default: the card)")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="write a JSON summary (counts, kernel launches) at exit")
    ap.add_argument("--cordapp", action="append", default=[], metavar="MODULE",
                    help="import MODULE first, registering its contracts "
                         "(repeatable)")
    a = ap.parse_args()
    import importlib

    for module in a.cordapp:
        importlib.import_module(module)
    run_worker(a.broker, use_device=not a.no_device,
               fabric_address=a.fabric, certs_dir=a.certs_dir,
               worker_name=a.name, device=a.device, report=a.report)
