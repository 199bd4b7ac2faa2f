"""The flow state machine engine (counterpart of corda_tpu/flows/engine.py).

Role parity with StateMachineManager + FlowStateMachineImpl
(node/.../services/statemachine/StateMachineManager.kt:76-565,
FlowStateMachineImpl.kt:40-510), mechanism re-designed for deterministic
replay (package docstring):

- flows execute ``FlowLogic.call()`` from the top on a BOUNDED worker
  pool (reference: the single scheduler thread multiplexing thousands of
  Quasar fibers, StateMachineManager.kt:76-83) — never one OS thread per
  flow;
- each effectful op is numbered; its result is recorded via
  ``CheckpointStorage.record_op`` the moment it completes;
- on restore, recorded ops replay instantly (re-registering sessions,
  re-sending messages under their original deterministic ids — recipients
  dedupe), and execution turns live at the first unrecorded op;
- inbound session messages are acked only once consumed into the op log, so
  an at-least-once transport (messaging.queue) yields exactly-once effects —
  the guarantee the reference gets from checkpoint-commit riding the ack
  transaction (StateMachineManager.kt:548).

**Parking = the fiber mechanism.** Where Quasar captures a fiber's stack,
this engine PARKS a blocked flow: if a wait (receive, session confirm,
sleep, ledger commit) isn't satisfied within a short grace window, the
flow abandons its worker thread and registers a wake key; when the key
fires (message arrival, commit, deadline) the flow is re-queued and
REPLAYED from its op log to the wait point — an in-process crash+restore,
which the op-log design makes exact and cheap (each recorded op replays in
microseconds). A parked flow costs a dict entry, not a thread, so tens of
thousands of concurrent flows run on a fixed-size pool.

Session ids are derived ``sha256(flow_id ‖ op_index)`` so a crash-replayed
open reuses the same id.

Copied whole with the reference's hooks into the host observability
layers, each off by default: the flowprof phase accounting
(``active_flowprof``/``flowprof_frame``), the cluster hop recorder
(``active_cluster``), the contention wait sites and the SMM monitor's timed
lock (``register_wait_site``, ``timed_lock``/``wrap_lock``) and the
overload governor's netstats walk in the retransmit timer
(``sync_net_events``).

Two additions: ``StateMachineManager.parks`` counts the flows the manager
has parked (the reference counts parks only in its flowprof layer), and
``shutdown()`` stops the manager and joins its workers, which the exit
drain (``serving.scheduler.drain_at_exit``) runs for every live manager,
so that no worker is inside a torch op while the interpreter finalizes.
"""

from __future__ import annotations

import hashlib
import random
import secrets
import threading
import time
from collections import deque
from concurrent.futures import Future

from ..ledger import Party
from ..messaging.queue import Message
from ..messaging.retry import RetryPolicy
from ..observability import (
    NOOP_SPAN,
    SPAN_FLOW,
    SPAN_FLOW_RESPONDER,
    TraceContext,
    tracer,
)
from ..observability.cluster import active_cluster
from ..observability.contention import register_wait_site
from ..observability.flowprof import active_flowprof, flowprof_frame
from ..observability.trace import current_trace_id
from ..serialization import deserialize, serialize

# the sampler's blocked/running classifier (concurrency observatory):
# a thread sampled inside these functions is waiting on the SMM monitor
# — an idle worker, a flow blocked in wait_or_killed, the retransmit
# timer between scans — not burning CPU
register_wait_site("engine.py", "_worker_loop", "lock_wait")
register_wait_site("engine.py", "wait_or_killed", "lock_wait")

from .api import (
    FlowException,
    FlowLogic,
    FlowSession,
    class_path,
    load_class,
    rehydrate_flow_exception,
    responder_for,
)
from .checkpoints import CheckpointStorage
from .overload import (
    FlowAdmissionError,
    active_overload,
    deadline_scope,
)
from .sessions import (
    SESSION_TOPIC,
    SessionAck,
    SessionConfirm,
    SessionData,
    SessionEnd,
    SessionInit,
    SessionReject,
)


def _logical_id(msg_id: str) -> str:
    """Strip a retransmission suffix: retransmits travel under
    ``<base>~<attempt>`` so transport-level dedupe (which is per wire id)
    lets them through, while ALL protocol-level dedupe — the consumed set,
    responder-init claims, session acks — keys on the stable base id."""
    return msg_id.split("~", 1)[0]


class FlowKilledException(Exception):
    pass


class _FlowParked(BaseException):
    """Internal: the flow released its worker thread; it resumes by replay
    when its registered wake key fires.

    A BaseException so a flow's ``except Exception`` can never swallow the
    park signal. NOTE the unwind contract: parking raises THROUGH the flow
    body, so ``finally`` blocks run at park time and the try body re-runs
    on replay — "crash at the suspension point" semantics. Cleanup that
    must span a suspension (e.g. vault soft locks) therefore needs a
    replay hook re-establishing it (``FlowLogic.record(fn, replay=...)``)."""


_DEFAULT_RETRY_POLICY = RetryPolicy(
    base_s=0.25, multiplier=2.0, max_backoff_s=2.0, jitter=0.25,
    deadline_s=60.0,
)

# how long shutdown() waits for the workers' running flow steps
SHUTDOWN_JOIN_S = 30.0


class FlowHandle:
    def __init__(self, flow_id: str, result: Future):
        self.flow_id = flow_id
        self.result = result

    def __repr__(self):
        return f"FlowHandle({self.flow_id})"


def _sid_for(flow_id: str, op_index: int) -> int:
    h = hashlib.sha256(f"{flow_id}:{op_index}".encode()).digest()
    return int.from_bytes(h[:8], "big") | 1  # nonzero


class _SessionState:
    __slots__ = ("local_sid", "peer", "peer_sid", "inbound", "executor",
                 "rejected", "seq_out", "seq_enqueued", "seq_pending",
                 "gap_since", "gap_timer_armed")

    def __init__(self, local_sid: int, peer: Party, executor):
        self.local_sid = local_sid
        self.peer = peer
        self.peer_sid: int | None = None
        # ("data"|"end", payload/error, msg_id, ack, seq)
        self.inbound: deque = deque()
        self.executor = executor
        self.rejected: str | None = None
        # per-session ordered delivery (see SessionData.seq): outbound
        # messages are stamped 1, 2, ... from seq_out; inbound sequenced
        # messages move pending → inbound only in seq order, so a
        # delayed Data can never be overtaken by a later Data or the
        # End — the gap parks in seq_pending until the retransmit fills
        # it. Counters are restored from the oplog on crash replay
        # (op_send / op_receive records carry the seq). gap_since /
        # gap_timer_armed drive the liveness backstop: a gap older than
        # the session retry deadline can never fill (the sender gave
        # up), so _gap_check force-drains it rather than park the
        # receiving flow forever.
        self.seq_out: int = 0
        self.seq_enqueued: int = 0
        self.seq_pending: dict[int, tuple] = {}
        self.gap_since: float | None = None
        self.gap_timer_armed: bool = False


class _Retrans:
    """One unacknowledged outbound session message: retransmitted with
    exponential backoff + jitter until its SessionAck (or, for Init, the
    Confirm/Reject) arrives or the deadline expires — the flow-session
    half of at-least-once delivery over a transport that may drop."""

    __slots__ = ("base_id", "party_name", "payload", "kind", "sid",
                 "attempt", "backoff_s", "next_at", "deadline")

    def __init__(self, base_id: str, party_name: str, payload: bytes,
                 kind: str, sid: int, policy: RetryPolicy, rng,
                 deadline_s: float):
        self.base_id = base_id
        self.party_name = party_name
        self.payload = payload
        self.kind = kind            # "init" | "data"
        self.sid = sid              # LOCAL sid of the sending session
        self.attempt = 0
        self.backoff_s = policy.backoff_s(0, rng)
        self.next_at = time.monotonic() + self.backoff_s
        self.deadline = time.monotonic() + deadline_s


class _FlowExecutor:
    def __init__(self, smm: "StateMachineManager", flow_id: str,
                 oplog: list, flow: FlowLogic | None,
                 responder_cls: type | None = None,
                 init_info: dict | None = None,
                 result: Future | None = None):
        self.smm = smm
        self.flow_id = flow_id
        self.oplog = oplog
        self.flow = flow                      # None for responders until built
        self.responder_cls = responder_cls
        self.init_info = init_info            # live responder spawn only
        self.op_counter = 0
        # the result future OUTLIVES this executor: a parked flow resumes
        # on a fresh executor that resolves the same future
        self.result: Future = result if result is not None else Future()
        self.sessions: list[int] = []         # local sids owned
        self.killed = False                   # set by SMM.kill_flow
        # the flow's trace span (or NOOP when unsampled): spans the whole
        # flow lifetime across park/replay — a resumed flow's fresh
        # executor rebinds the SAME span from the SMM's span table
        self.trace_span = smm.span_of(flow_id)
        # the flow's phase-accounting ledger (flowprof), same lifetime
        # contract as the span: opened at flow start, rebound across
        # park/replay, closed in flow_finished
        fp = active_flowprof()
        self.prof_acct = fp.acct_of(flow_id) if fp is not None else None
        # propagated end-to-end deadline (docs/OVERLOAD.md): absolute
        # wall-clock epoch by which the caller stops caring, or None.
        # Set by start_flow (initiator), _handle_init (responder, off the
        # SessionInit wire field) and _rebuild (from checkpoint meta, so
        # the deadline survives park/replay and crash restore); bound as
        # the thread's deadline scope for every execution segment
        self.deadline_t: float | None = None

    # ------------------------------------------------------------ op core
    def _do_op(self, effect, replay=None):
        idx = self.op_counter
        self.op_counter += 1
        if idx < len(self.oplog):
            rec = self.oplog[idx]
            if replay is not None:
                replay(idx, rec)
            return rec
        rec = effect(idx)
        with flowprof_frame("checkpoint"):
            self.smm.checkpoints.record_op(self.flow_id, idx, rec)
        return rec

    # ------------------------------------------------------------ ops
    def op_entropy(self, n: int) -> bytes:
        return self._do_op(lambda idx: secrets.token_bytes(n))

    def op_record(self, fn, replay_fn=None):
        """Record fn()'s result; on replay, optionally run
        ``replay_fn(recorded)`` to re-establish host-side state the
        original call created (locks, registrations) — state that a park's
        unwind or a crash may have dropped."""
        replay = (
            (lambda idx, rec: replay_fn(rec)) if replay_fn is not None else None
        )
        return self._do_op(lambda idx: fn(), replay)

    def op_commit_pin(self) -> None:
        """Recorded op marking the flow's point of no return
        (FlowLogic.commit_pin): from here the propagated deadline stops
        shedding this flow (resume-time shed and retransmit-entry kill
        both check the pin). Recorded so crash restore re-establishes
        the pin from the oplog before any replay decision."""
        def effect(idx):
            self.smm._commit_pinned.add(self.flow_id)
            return {"commit_pin": True}

        self._do_op(
            effect,
            replay=lambda idx, rec: self.smm._commit_pinned.add(self.flow_id),
        )

    def _pinned(self) -> bool:
        return self.flow_id in self.smm._commit_pinned

    def op_sleep(self, seconds: float) -> None:
        rec = self._do_op(lambda idx: {"deadline": time.time() + seconds})
        remaining = rec["deadline"] - time.time()
        if remaining > 0:
            self.smm.wait_or_killed(
                lambda: False, timeout=remaining, executor=self,
                sleep_deadline=rec["deadline"],
            )

    def op_send(self, local_sid: int, obj) -> None:
        with flowprof_frame("serialize"):
            payload = serialize(obj)

        def effect(idx):
            # publish-then-record: a crash in between replays this op live
            # and re-publishes under the same deterministic msg id, which
            # the recipient's consumed-set dedupes. A *recorded* send was
            # durably enqueued, so replay never re-sends.
            seq = self._send_data(local_sid, payload, idx)
            return {"i": idx, "seq": seq}

        def replay(idx, rec):
            # replay never re-sends, so the session's outbound sequence
            # counter must be restored from the record — the next LIVE
            # send (and the finish-time End) continue the numbering the
            # peer has already seen
            seq = rec.get("seq", 0)
            if seq:
                sess = self.smm.session(local_sid)
                if seq > sess.seq_out:
                    sess.seq_out = seq

        self._do_op(effect, replay)

    def _retry_deadline_s(self) -> float | None:
        """Deadline propagation: a flow declaring ``retry_deadline_s``
        bounds every retransmit window it opens (sessions inherit the
        flow's budget); otherwise the SMM policy default applies. An
        end-to-end deadline tightens either further — retransmitting a
        message whose flow is already dead is pure storm fuel."""
        rem = None
        if self.deadline_t is not None and not self._pinned():
            # floor keeps the entry alive long enough for the deadline
            # pop to fail the session cleanly rather than instantly
            rem = max(0.05, self.deadline_t - time.time())
        flow_budget = getattr(self.flow, "retry_deadline_s", None)
        if flow_budget is None or self.smm._retry_policy is None:
            return rem
        out = min(flow_budget, self.smm._retry_policy.deadline_s)
        return out if rem is None else min(out, rem)

    def _send_data(self, local_sid: int, payload: bytes, idx: int) -> int:
        sess = self.smm.session(local_sid)
        if sess.peer_sid is None:
            raise FlowException("session not confirmed")
        sess.seq_out += 1
        self.smm.send_to(
            sess.peer, SessionData(sess.peer_sid, payload, sess.seq_out),
            msg_id=f"{self.flow_id}:op{idx}",
            track_kind="data", track_sid=local_sid,
            deadline_s=self._retry_deadline_s(),
        )
        return sess.seq_out

    def op_receive(self, local_sid: int):
        def effect(idx):
            sess = self.smm.session(local_sid)
            # deadline-aware wait: an unpinned flow whose end-to-end
            # deadline expires while it waits must shed, not hang — with
            # ordered delivery a permanently-lost message parks the
            # session (the End waits behind the gap too), so the wake
            # can no longer rely on SOMETHING eventually arriving. The
            # park path wakes via the sleeper timer and replays through
            # _run_body's shed; the on-thread path returns None here.
            dl = (self.deadline_t
                  if self.deadline_t is not None and not self._pinned()
                  else None)
            got = self.smm.wait_or_killed(
                lambda: sess.inbound[0] if sess.inbound else None,
                timeout=(None if dl is None
                         else max(0.0, dl - time.time())),
                executor=self, park_key=("sid", local_sid),
                sleep_deadline=dl,
            )
            if got is None:
                ov = active_overload()
                if ov is not None:
                    ov.note_deadline_shed(
                        str(getattr(self.flow, "priority", "service"))
                        if self.flow is not None else "service"
                    )
                raise FlowException("flow deadline exceeded")
            # pop + mark-consumed atomically: a retransmit landing between
            # the two would pass both dedupe checks (not buffered, not yet
            # consumed) and be re-buffered — a later receive would then
            # consume the stale duplicate as its own message
            kind, body, msg_id, ack, seq = self.smm.consume_inbound(sess)
            if kind == "end":
                rec = {"end": body if body else "peer ended session"}
            else:
                rec = {"payload": body, "msg_id": msg_id}
            if seq:
                # persisted so crash replay can restore the session's
                # delivery cursor (seq omitted when 0 — pre-sequencing
                # checkpoints keep their exact record shape)
                rec["seq"] = seq
            # record BEFORE ack: consumed-and-durable, then delete from queue
            with flowprof_frame("checkpoint"):
                self.smm.checkpoints.record_op(self.flow_id, idx, rec)
            if msg_id:
                # session-level ack: the peer's retransmit buffer settles;
                # a lost ack just means one more (deduped) retransmit
                self.smm.ack_session_msg(sess.peer, msg_id)
            if ack:
                ack()
            return rec

        idx = self.op_counter
        self.op_counter += 1
        if idx < len(self.oplog):
            rec = self.oplog[idx]
            seq = rec.get("seq", 0)
            if seq:
                # replayed receive: advance the delivery cursor so a NEW
                # message arriving post-restore (seq = cursor + 1) drains
                # instead of parking behind seqs consumed pre-crash
                sess = self.smm.session(local_sid)
                if seq > sess.seq_enqueued:
                    sess.seq_enqueued = seq
        else:
            rec = effect(idx)
            # effect already recorded (pre-ack); skip double record
        if "end" in rec:
            raise rehydrate_flow_exception(rec["end"])
        with flowprof_frame("serialize"):
            return deserialize(rec["payload"])

    def open_session(self, flow: FlowLogic, party: Party) -> FlowSession:
        def effect(idx):
            sid = _sid_for(self.flow_id, idx)
            sess = self.smm.register_session(sid, party, self)
            self.smm.send_to(
                party,
                SessionInit(sid, class_path(type(flow)), b"",
                            trace=self.trace_span.wire(),
                            deadline=self.deadline_t or 0.0),
                msg_id=f"{self.flow_id}:op{idx}",
                track_kind="init", track_sid=sid,
                deadline_s=self._retry_deadline_s(),
            )
            self.smm.wait_or_killed(
                lambda: sess.peer_sid is not None or sess.rejected is not None,
                executor=self, park_key=("sid", sid),
            )
            if sess.rejected is not None:
                raise FlowException(f"session rejected: {sess.rejected}")
            return {"sid": sid, "peer_sid": sess.peer_sid}

        def replay(idx, rec):
            sess = self.smm.register_session(rec["sid"], party, self)
            sess.peer_sid = rec["peer_sid"]

        rec = self._do_op(effect, replay)
        self.sessions.append(rec["sid"])
        return FlowSession(self, rec["sid"], party)

    def op_accept_session(self) -> FlowSession:
        """Responder op 0: bind the initiator's session."""

        def effect(idx):
            info = self.init_info
            sid = _sid_for(self.flow_id, idx)
            sess = self.smm.register_session(sid, info["peer"], self)
            sess.peer_sid = info["peer_sid"]
            self.smm.send_to(
                info["peer"],
                SessionConfirm(info["peer_sid"], sid),
                msg_id=f"{self.flow_id}:confirm",
            )
            return {"sid": sid, "peer_sid": info["peer_sid"],
                    "peer": info["peer"]}

        def replay(idx, rec):
            sess = self.smm.register_session(rec["sid"], rec["peer"], self)
            sess.peer_sid = rec["peer_sid"]
            self.smm.send_to(
                rec["peer"], SessionConfirm(rec["peer_sid"], rec["sid"]),
                msg_id=f"{self.flow_id}:confirm",
            )

        rec = self._do_op(effect, replay)
        self.sessions.append(rec["sid"])
        return FlowSession(self, rec["sid"], rec["peer"])

    def op_end_session(self, local_sid: int, error: str) -> None:
        def effect(idx):
            sess = self.smm.session(local_sid)
            seq = 0
            if sess.peer_sid is not None:
                sess.seq_out += 1
                seq = sess.seq_out
                self.smm.send_to(
                    sess.peer, SessionEnd(sess.peer_sid, error, seq),
                    msg_id=f"{self.flow_id}:op{idx}",
                    track_kind="data", track_sid=local_sid,
                    deadline_s=self._retry_deadline_s(),
                )
            return {"i": idx, "seq": seq}

        def replay(idx, rec):
            seq = rec.get("seq", 0)
            if seq:
                sess = self.smm.session(local_sid)
                if seq > sess.seq_out:
                    sess.seq_out = seq

        self._do_op(effect, replay)

    def op_wait_ledger_commit(self, tx_id):
        def effect(idx):
            stx = self.smm.wait_or_killed(
                lambda: self.smm.lookup_committed(tx_id),
                executor=self, park_key=("tx", tx_id),
            )
            return {"stx": stx}

        rec = self._do_op(effect)
        return rec["stx"]

    # ------------------------------------------------------------ lifecycle
    def run_once(self) -> str:
        """Execute on the calling worker thread until the flow finishes,
        parks, or dies → "finished" | "parked"."""
        if self.deadline_t is not None:
            # bind the propagated deadline for this execution segment so
            # every downstream submit on this thread (serving scheduler,
            # notary request, consensus client) sheds already-dead work
            with deadline_scope(self.deadline_t):
                return self._run_acct()
        return self._run_acct()

    def _run_acct(self) -> str:
        acct = self.prof_acct
        if acct is not None:
            fp = active_flowprof()
            if fp is not None:
                # activate the phase account for this execution segment:
                # frames/hints the flow body opens on this thread (and the
                # scheduler's submit-time capture) book to this flow
                with fp.activate(acct):
                    return self._run_traced()
        return self._run_traced()

    def _run_traced(self) -> str:
        span = self.trace_span
        if not span.sampled:
            return self._run_body()
        # activate for the duration of this execution segment: every span
        # the flow body opens on this thread (verify, scheduler submit,
        # notary attest) parents under the flow span via tracer.current()
        with tracer().activate(span):
            return self._run_body()

    def _run_body(self) -> str:
        try:
            if (self.deadline_t is not None
                    and time.time() >= self.deadline_t
                    and not self._pinned()):
                # the caller already gave up: fail here, before any
                # verify/notary work — goodput, not throughput. The
                # deadline itself (not the governor) is the opt-in, so a
                # propagated deadline sheds even with overload off; the
                # governor only adds counting + SLO observation.
                ov = active_overload()
                if ov is not None:
                    ov.note_deadline_shed(
                        str(getattr(self.flow, "priority", "service"))
                        if self.flow is not None else "service"
                    )
                raise FlowException("flow deadline exceeded")
            if self.responder_cls is not None:
                session = self.op_accept_session()
                self.flow = self.responder_cls(session)
            self.flow._executor = self
            self.flow.services = self.smm.services
            self.flow.our_identity = self.smm.our_identity
            result = self.flow.call()
            self._finish(result, None)
        except _FlowParked:
            return "parked"
        except FlowKilledException:
            if self.killed:
                # explicit kill: tell counterparties (SessionEnd), surface
                # a failed result, drop checkpoint + session state — all
                # via the normal finish path. An SMM *shutdown* instead
                # cancels quietly and preserves checkpoints for restore.
                self._finish(None, FlowException("flow was killed"))
            else:
                try:
                    self.result.cancel()
                except Exception:
                    pass
        except Exception as e:  # flow failure → future + peers
            self._finish(None, e)
        return "finished"

    def _finish(self, result, error):
        error_msg = "" if error is None else f"{type(error).__name__}: {error}"
        if error is not None and not isinstance(error, FlowException):
            # non-FlowException internals are not leaked to peers, matching
            # the reference's error propagation rules
            error_msg = "counterparty flow failed"
        for sid in self.sessions:
            try:
                sess = self.smm.session(sid)
                if sess.peer_sid is not None:
                    # sequenced AFTER every data this flow sent on the
                    # session: the peer defers the End until the data
                    # has arrived (retransmits fill any gap), so an End
                    # racing a delayed payload can no longer kill the
                    # peer's receive. Deterministic across crash-replay:
                    # seq_out is restored from the replayed send records.
                    self.smm.send_to(
                        sess.peer,
                        SessionEnd(sess.peer_sid, error_msg,
                                   sess.seq_out + 1),
                        msg_id=f"{self.flow_id}:end{sid}",
                        track_kind="data", track_sid=sid,
                        deadline_s=self._retry_deadline_s(),
                    )
            except Exception:
                pass
        # engine-managed soft-lock release (reference: VaultSoftLockManager
        # hooks flow completion). Flows must NOT release in their own
        # try/finally: a park unwinds the Python stack through finally
        # blocks, so a flow-managed release would free its selected states
        # mid-suspension — a rival spends them, and the replayed flow
        # double-spends at the notary.
        try:
            vault = getattr(self.smm.services, "vault_service", None)
            if vault is not None:
                vault.soft_lock_release(self.flow_id)
        except Exception:
            pass
        self.smm.flow_finished(self)
        try:
            if error is None:
                self.result.set_result(result)
            else:
                self.result.set_exception(error)
        except Exception:
            pass  # future already cancelled (shutdown race)


class StateMachineManager:
    """Owns all running flows of one node; dispatches session messages;
    restores persisted flows at startup (reference:
    StateMachineManager.kt:238-265 restoreFibersFromCheckpoints)."""

    def __init__(
        self,
        messaging,
        checkpoints: CheckpointStorage,
        our_identity: Party,
        party_resolver=None,
        services=None,
        max_workers: int = 16,
        parking_grace_s: float = 0.05,
        retry_policy: "RetryPolicy | None" = _DEFAULT_RETRY_POLICY,
    ):
        self.messaging = messaging
        self.checkpoints = checkpoints
        self.our_identity = our_identity
        # per-session retransmission of unacked Init/Data/End messages
        # (exponential backoff, jitter, hard deadline — see _Retrans).
        # The default policy keeps first retransmits past the grace of an
        # in-order transport; chaos tests tighten it. Pass None to disable
        # retransmission (a transport with its own delivery guarantees).
        self._retry_policy = retry_policy
        self._retx_rng = random.Random(f"retx:{our_identity.name}")
        self._unacked: dict[str, _Retrans] = {}
        self._retx_timer: threading.Thread | None = None
        # sids of FINISHED flows (bounded FIFO): distinguishes an End for
        # a completed-and-pruned session (safe to ack away) from one for
        # a session a crash-replayed flow has not re-registered YET
        # (must stay unacked so the broker redelivers it post-replay)
        self._finished_sids: set[int] = set()
        self._finished_sids_order: deque[int] = deque(maxlen=4096)
        self.services = services
        if services is not None and hasattr(services, "add_commit_listener"):
            # a PARKED wait_for_ledger_commit only resumes via its wake
            # key; recording must push the wake (polling covers only the
            # pre-park grace window — without this hook, any flow that
            # parked waiting on a commit slept forever)
            services.add_commit_listener(self.notify_ledger_commit)
        self._party_resolver = party_resolver or (lambda name: None)
        # with flowprof on at construction, the SMM monitor sits over a
        # timed-acquire RLock so blocked acquisition books to lock_wait
        # (enabling flowprof later leaves an existing SMM untimed — the
        # hook costs a lock-construction decision, never a per-acquire
        # check while off); with contention timing also on, the
        # contention wrapper sits over THAT, so the hottest monitor in
        # the process is always in the top-contended table under its
        # stable "engine.smm" site name, whatever order install() ran in
        from ..observability.contention import (
            active_contention,
            timed_lock,
            wrap_lock,
        )

        _fp = active_flowprof()
        _smm_inner = _fp.timed_rlock() if _fp is not None else None
        if active_contention() is not None:
            if _smm_inner is None:
                _smm_inner = timed_lock("engine.smm", reentrant=True)
            else:
                _smm_inner = wrap_lock(_smm_inner, "engine.smm")
        self._lock = threading.Condition(_smm_inner)
        self._sessions: dict[int, _SessionState] = {}
        self._flows: dict[str, _FlowExecutor] = {}
        self._consumed_msg_ids: set[str] = set()
        self._committed = {}  # tx_id -> SignedTransaction (ledger hook)
        self._closed = False
        # ----- scheduler state (bounded pool + parked flows)
        self._max_workers = max_workers
        self._parking_grace_s = parking_grace_s
        self.parks = 0                        # flows parked, ever
        self._runq: deque[str] = deque()
        self._queued: set[str] = set()
        self._running: set[str] = set()
        self._parked: dict = {}               # wake key -> set[flow_id]
        self._park_key_of: dict[str, object] = {}
        self._rewake: set[str] = set()        # woken while still running
        self._sleepers: dict[str, float] = {} # flow_id -> deadline
        self._results: dict[str, Future] = {} # persistent per-flow futures
        # flow id -> open trace span (sampled flows only): outlives the
        # executor across park/replay like the result future does; finished
        # (and pruned) in flow_finished / _fail_unrunnable
        self._flow_spans: dict[str, object] = {}
        self._killed_ids: set[str] = set()
        # flows past their point of no return (FlowLogic.commit_pin) —
        # exempt from deadline sheds; survives park/replay in memory and
        # crash restore via the oplog marker (pruned with the flow)
        self._commit_pinned: set[str] = set()
        self._workers: list[threading.Thread] = []
        self._timer: threading.Thread | None = None
        messaging.add_handler(SESSION_TOPIC, self._on_message)
        # the scheduler's package imports the flows package
        from ..serving.scheduler import drain_at_exit

        drain_at_exit(self, engine=True)

    # ------------------------------------------------------------ tracing
    def span_of(self, flow_id: str):
        """The flow's open trace span, or the shared no-op."""
        with self._lock:
            return self._flow_spans.get(flow_id, NOOP_SPAN)

    def _open_flow_span(self, flow_id: str, flow_cls: str, *,
                        responder: bool = False,
                        parent_wire: str = "") -> None:
        """Root (initiator) or wire-parented (responder) flow span; only
        sampled spans enter the table — unsampled flows cost one lookup
        miss. A responder NEVER roots its own trace: the sampling
        decision is the initiator's, carried (or withheld) on the wire —
        an empty parent context means "not sampled", not "re-roll"
        (re-rolling would leak orphan fragment traces at the configured
        rate per responder and overshoot the sampling knob)."""
        trc = tracer()
        if responder:
            span = trc.start(
                SPAN_FLOW_RESPONDER, TraceContext.from_wire(parent_wire),
                attrs={"flow.id": flow_id, "flow.class": flow_cls,
                       "node": str(self.our_identity.name)},
            )
        else:
            span = trc.root(
                SPAN_FLOW,
                attrs={"flow.id": flow_id, "flow.class": flow_cls,
                       "node": str(self.our_identity.name)},
            )
        if span.sampled:
            with self._lock:
                self._flow_spans[flow_id] = span

    def _close_flow_span(self, flow_id: str, error=None) -> None:
        with self._lock:
            span = self._flow_spans.pop(flow_id, None)
        if span is not None:
            if error is not None:
                span.set_error(error)
            span.finish()

    # ------------------------------------------------------------ public
    def start_flow(self, flow: FlowLogic, flow_id: str | None = None,
                   deadline_s: float | None = None) -> FlowHandle:
        # adaptive admission (docs/OVERLOAD.md) gates FIRST: a rejection
        # must cost the caller one exception — no span, no flowprof
        # account, and above all no checkpoint write
        priority = str(getattr(flow, "priority", "service"))
        ov = active_overload()
        if ov is not None:
            if not ov.try_admit(priority):
                raise FlowAdmissionError(
                    f"flow admission rejected ({priority}): node over "
                    "concurrency limit"
                )
        deadline_t = time.time() + deadline_s if deadline_s is not None else None
        flow_id = flow_id or secrets.token_hex(16)
        self._open_flow_span(flow_id, class_path(type(flow)))
        fp = active_flowprof()
        if fp is not None:
            fp.open(flow_id, class_path(type(flow)))
        blob = serialize({
            "cls": class_path(type(flow)),
            "fields": flow.flow_fields(),
            "responder": False,
            # omitted when unset: checkpoints of deadline-less flows (and
            # all pre-overload checkpoints) keep their exact byte shape
            **({"deadline": deadline_t} if deadline_t else {}),
        })
        self.checkpoints.add_flow(flow_id, blob, str(self.our_identity.name),
                                  time.time())
        fut: Future = Future()
        if ov is not None:
            t0 = time.monotonic()

            def _release(f, _ov=ov, _p=priority, _t0=t0):
                try:
                    err = f.exception() is not None
                except Exception:
                    err = True  # cancelled future (shutdown)
                _ov.release(_p, time.monotonic() - _t0, error=err)

            # the future outlives this executor across park/replay, so
            # one done-callback frees the admission slot exactly once
            # however many executors the flow burns through
            fut.add_done_callback(_release)
        ex = _FlowExecutor(self, flow_id, [], flow, result=fut)
        ex.deadline_t = deadline_t
        with self._lock:
            self._flows[flow_id] = ex
            self._results[flow_id] = fut
        self._enqueue(flow_id)
        return FlowHandle(flow_id, fut)

    def restore(self) -> list[FlowHandle]:
        """Re-spawn every checkpointed flow; replay brings each to its live
        point."""
        handles = []
        for flow_id, blob, _our, _ts in self.checkpoints.all_flows():
            with self._lock:
                if flow_id in self._flows:
                    continue
            ex = self._rebuild(flow_id, blob)
            if ex is None:
                continue
            self._enqueue(flow_id)
            handles.append(FlowHandle(flow_id, ex.result))
        return handles

    def _rebuild(self, flow_id: str, blob: bytes) -> "_FlowExecutor | None":
        """Reconstruct an executor from its checkpoint (both the restart
        restore path and the park/resume path)."""
        meta = deserialize(blob)
        oplog = self.checkpoints.load_oplog(flow_id)
        # reconstruct consumed-message dedupe set from receive records —
        # under the lock: _rebuild also runs on the park/resume path while
        # worker threads consume ids concurrently (consume_inbound)
        with self._lock:
            for rec in oplog:
                if isinstance(rec, dict) and "msg_id" in rec:
                    self._consumed_msg_ids.add(rec["msg_id"])
                # re-establish the point-of-no-return pin BEFORE any
                # resume-time deadline decision (crash restore loses the
                # in-memory set; the shed check runs ahead of replay)
                if isinstance(rec, dict) and rec.get("commit_pin"):
                    self._commit_pinned.add(flow_id)
        cls = load_class(meta["cls"])
        with self._lock:
            fut = self._results.setdefault(flow_id, Future())
        if meta["responder"]:
            ex = _FlowExecutor(self, flow_id, oplog, None,
                               responder_cls=cls, result=fut)
        else:
            flow = cls.from_flow_fields(meta["fields"])
            ex = _FlowExecutor(self, flow_id, oplog, flow, result=fut)
        # .get: pre-overload checkpoints carry no deadline and decode fine
        ex.deadline_t = meta.get("deadline")
        with self._lock:
            ex.killed = flow_id in self._killed_ids
            self._flows[flow_id] = ex
        return ex

    # ------------------------------------------------------- scheduler
    def _enqueue(self, flow_id: str) -> None:
        with self._lock:
            if self._closed or flow_id in self._queued:
                return
            self._queued.add(flow_id)
            self._runq.append(flow_id)
            self._spawn_workers_locked()
            self._lock.notify_all()

    def _spawn_workers_locked(self) -> None:
        live = [t for t in self._workers if t.is_alive()]
        self._workers = live
        want = min(self._max_workers, len(self._runq) + len(self._running))
        for i in range(len(live), want):
            t = threading.Thread(
                target=self._worker_loop, daemon=True,
                name=f"flow-worker-{i}",
            )
            self._workers.append(t)
            t.start()

    def _worker_loop(self) -> None:
        while True:
            with self._lock:
                while not self._runq and not self._closed:
                    timeout = self._wake_due_sleepers_locked()
                    self._lock.wait(timeout=timeout)
                if self._closed and not self._runq:
                    return
                flow_id = self._runq.popleft()
                self._queued.discard(flow_id)
                if flow_id in self._running:
                    # executing elsewhere: flag so the running worker
                    # re-queues on exit (the wake that queued this pop must
                    # not be lost if that run parks after our check)
                    self._rewake.add(flow_id)
                    continue
                self._running.add(flow_id)
                ex = self._flows.get(flow_id)
            try:
                if ex is None:
                    blob = self.checkpoints.get_flow(flow_id)
                    if blob is None:
                        continue  # finished while queued
                    try:
                        ex = self._rebuild(flow_id, blob)
                    except Exception as e:
                        # an unreconstructible flow must FAIL loudly, not
                        # vanish: resolve its future and drop the state
                        self._fail_unrunnable(flow_id, e)
                        continue
                    if ex is None:
                        continue
                ex.run_once()
            except Exception:
                pass  # executor-level failures resolve the flow future
            finally:
                with self._lock:
                    self._running.discard(flow_id)
                    # parked-with-pending-wake race: a wake fired while we
                    # were marked running; it couldn't re-queue then, so
                    # honour it now (only if the flow actually parked —
                    # a finished flow has no park state left)
                    if flow_id in self._rewake:
                        self._rewake.discard(flow_id)
                        if flow_id in self._park_key_of:
                            self._unpark_locked(flow_id)

    def _fail_unrunnable(self, flow_id: str, error: Exception) -> None:
        self._close_flow_span(flow_id, error=error)
        fp = active_flowprof()
        if fp is not None:
            fp.close(flow_id)
        with self._lock:
            fut = self._results.pop(flow_id, None)
            self._flows.pop(flow_id, None)
            self._park_key_of.pop(flow_id, None)
            self._sleepers.pop(flow_id, None)
            self._killed_ids.discard(flow_id)
            self._commit_pinned.discard(flow_id)
        if fut is not None and not fut.done():
            try:
                fut.set_exception(
                    FlowException(f"flow cannot be rebuilt for resume: {error}")
                )
            except Exception:
                pass

    def _wake_due_sleepers_locked(self) -> float:
        """Move sleepers past their deadline onto the run queue; return the
        wait timeout until the next deadline (capped)."""
        now = time.time()
        due = [f for f, dl in self._sleepers.items() if dl <= now]
        for f in due:
            self._sleepers.pop(f, None)
            self._unpark_locked(f)
        nxt = min(self._sleepers.values()) - now if self._sleepers else 0.5
        return max(0.01, min(nxt, 0.5))

    def _start_timer_locked(self) -> None:
        """Dedicated sleeper timer: due deadlines must fire even when every
        worker is busy (the idle-loop check alone starves under sustained
        load)."""
        if self._timer is not None and self._timer.is_alive():
            return

        def loop():
            while True:
                with self._lock:
                    if self._closed:
                        return
                    if not self._sleepers:
                        self._timer = None
                        return
                    timeout = self._wake_due_sleepers_locked()
                time.sleep(min(timeout, 0.05))

        self._timer = threading.Thread(
            target=loop, daemon=True, name="flow-sleep-timer"
        )
        self._timer.start()

    def _park_locked(self, flow_id: str, key, deadline: float | None) -> None:
        """Caller holds the lock and has just re-checked the condition."""
        self.parks += 1
        self._park_key_of[flow_id] = key
        if key is not None:
            self._parked.setdefault(key, set()).add(flow_id)
        if deadline is not None:
            self._sleepers[flow_id] = deadline
            self._start_timer_locked()
        # drop the executor: the flow's state IS its checkpoint now; the
        # resume path rebuilds and replays (sessions stay registered and
        # keep buffering inbound messages while parked)
        self._flows.pop(flow_id, None)

    def _unpark_locked(self, flow_id: str) -> None:
        if flow_id in self._running:
            # raced with the parking worker: flag for re-queue on its exit
            self._rewake.add(flow_id)
            return
        key = self._park_key_of.pop(flow_id, "absent")
        if key == "absent":
            return
        fp = active_flowprof()
        if fp is not None:
            # close the hinted-wait window (opened at wait_or_killed
            # entry): the park wall books to the hinted phase
            fp.note_unpark(fp.acct_of(flow_id))
        if key is not None:
            group = self._parked.get(key)
            if group is not None:
                group.discard(flow_id)
                if not group:
                    self._parked.pop(key, None)
        self._sleepers.pop(flow_id, None)
        if not self._closed and flow_id not in self._queued:
            self._queued.add(flow_id)
            self._runq.append(flow_id)
        self._lock.notify_all()

    def _wake_key_locked(self, key) -> None:
        for flow_id in list(self._parked.get(key, ())):
            self._unpark_locked(flow_id)

    def flows_in_progress(self) -> list[str]:
        with self._lock:
            live = set(self._flows) | set(self._park_key_of) | self._queued
            return list(live)

    def flows_detail(self) -> dict[str, str]:
        """flow id → what it is doing ("running", "queued", or
        "parked@<wake key>") — the operator's first question about a
        wedged flow is what it is waiting on. Kept separate from
        ``flows_in_progress`` so id-membership consumers stay stable."""
        with self._lock:
            out: dict[str, str] = {}
            for fid in set(self._flows) | set(self._park_key_of) | self._queued:
                if fid in self._park_key_of:
                    out[fid] = f"parked@{self._park_key_of[fid]}"
                elif fid in self._queued:
                    out[fid] = "queued"
                else:
                    out[fid] = "running"
            return out

    def handle_of(self, flow_id: str) -> FlowHandle | None:
        """Handle for a running flow (None once finished and pruned)."""
        with self._lock:
            fut = self._results.get(flow_id)
        return FlowHandle(flow_id, fut) if fut is not None else None

    def kill_flow(self, flow_id: str) -> bool:
        """Terminate one running flow (reference: CordaRPCOps.killFlow).
        The flow's next suspension point raises; its checkpoint is
        removed. A parked flow is woken so it can observe the kill."""
        with self._lock:
            known = (
                flow_id in self._flows
                or flow_id in self._park_key_of
                or flow_id in self._queued
            )
            if not known:
                return False
            self._killed_ids.add(flow_id)
            ex = self._flows.get(flow_id)
            if ex is not None:
                ex.killed = True
            self._unpark_locked(flow_id)
            self._lock.notify_all()
        return True

    def consume_inbound(self, sess: _SessionState):
        """Pop the head of a session's inbound queue AND mark its logical
        id consumed in one locked step (see op_receive for the retransmit
        race this closes). The id is marked in-memory only — durability
        still rides the op-log record; on a crash before the record, the
        set is gone with the process and the peer's retransmit re-offers
        the message to the replayed flow."""
        with self._lock:
            item = sess.inbound.popleft()
            if item[2]:
                self._consumed_msg_ids.add(item[2])
            return item

    def notify_ledger_commit(self, stx) -> None:
        with self._lock:
            if self.services is None:
                # no storage backing lookup_committed: keep the in-memory
                # feed. With services, storing here would duplicate the
                # whole validated-transactions store for the node's
                # lifetime — the wake alone suffices.
                self._committed[stx.id] = stx
            self._wake_key_locked(("tx", stx.id))
            self._lock.notify_all()

    def lookup_committed(self, tx_id):
        # storage-backed lookup first (survives restarts), then the
        # in-memory feed
        if self.services is not None:
            stored = self.services.validated_transactions.get(tx_id)
            if stored is not None:
                return stored
        return self._committed.get(tx_id)

    def stop(self) -> None:
        with self._lock:
            self._closed = True
            self._runq.clear()
            self._queued.clear()
            self._lock.notify_all()
        self.messaging.stop()

    def shutdown(self) -> None:
        """``stop()``, then wait up to ``SHUTDOWN_JOIN_S`` for the workers
        to finish the flow steps they are running (the exit drain of
        ``serving.scheduler.drain_at_exit``: a worker may be inside a torch
        op)."""
        self.stop()
        deadline = time.monotonic() + SHUTDOWN_JOIN_S
        with self._lock:
            workers = list(self._workers)
        for t in workers:
            if t is not threading.current_thread():
                t.join(max(0.0, deadline - time.monotonic()))

    # ------------------------------------------------------------ internals
    def session(self, sid: int) -> _SessionState:
        with self._lock:
            sess = self._sessions.get(sid)
        if sess is None:
            raise FlowException(f"unknown session {sid}")
        return sess

    def register_session(self, sid: int, peer: Party, executor) -> _SessionState:
        with self._lock:
            sess = self._sessions.get(sid)
            if sess is None:
                sess = _SessionState(sid, peer, executor)
                self._sessions[sid] = sess
            else:
                # a resumed (parked or restored) flow re-registers its own
                # sid on a FRESH executor: rebind but keep the buffered
                # inbound and the confirmed peer_sid — messages that
                # arrived while parked must not be lost
                sess.executor = executor
            return sess

    def send_to(self, party: Party, obj, *, msg_id: str,
                track_kind: str | None = None, track_sid: int = 0,
                deadline_s: float | None = None) -> None:
        with flowprof_frame("serialize"):
            payload = serialize(obj)
        if track_kind == "data":
            # transit accounting (flowprof): stamp Data/End sends by their
            # LOGICAL id — _buffer on the receiving SMM books send→delivery
            # as message_transit for the consuming flow. Retransmits reuse
            # the first send's stamp, so transit honestly includes the
            # loss-recovery wall.
            fp = active_flowprof()
            if fp is not None:
                fp.note_sent(_logical_id(msg_id))
        if track_kind is not None:
            # hop evidence (cluster observatory): wall-clock send stamp on
            # THIS node, joined by the receiving engine into a per-hop
            # net.transit span. Same first-stamp-wins semantics as above.
            cl = active_cluster()
            if cl is not None:
                cl.note_send(
                    str(self.our_identity.name), str(party.name),
                    track_kind, _logical_id(msg_id),
                    current_trace_id() or "",
                )
        # register BEFORE transmitting: a fast peer's reply (Confirm/Ack)
        # can be processed in the window after send — it must find the
        # entry to settle, not race past an empty map and leave a zombie
        # retransmitting to its deadline
        if track_kind is not None and self._retry_policy is not None:
            self._track_unacked(str(party.name), payload, msg_id,
                                track_kind, track_sid, deadline_s)
        self.messaging.send(str(party.name), SESSION_TOPIC, payload,
                            msg_id=msg_id)

    # ----------------------------------------------- session retransmission
    def _track_unacked(self, party_name: str, payload: bytes, base_id: str,
                       kind: str, sid: int, deadline_s: float | None) -> None:
        policy = self._retry_policy
        ov = active_overload()
        if ov is not None:
            # a FRESH tracked send earns retry-budget tokens for this
            # peer edge (outside the SMM lock — the governor locks itself)
            ov.note_send("session", party_name)
        entry = _Retrans(
            base_id, party_name, payload, kind, sid, policy, self._retx_rng,
            deadline_s if deadline_s is not None else policy.deadline_s,
        )
        with self._lock:
            if self._closed or base_id in self._unacked:
                return
            self._unacked[base_id] = entry
            self._start_retx_timer_locked()

    def _start_retx_timer_locked(self) -> None:
        if self._retx_timer is not None and self._retx_timer.is_alive():
            return

        def loop():
            while True:
                # governor prep OUTSIDE the SMM lock: sync_net_events
                # walks the netstats event ring under netstats' own lock
                ov = active_overload()
                if ov is not None:
                    ov.sync_net_events()
                our = str(self.our_identity.name)
                with self._lock:
                    if self._closed or not self._unacked:
                        self._retx_timer = None
                        return
                    now = time.monotonic()
                    resend: list[tuple[str, bytes, str]] = []
                    for e in list(self._unacked.values()):
                        if now >= e.deadline:
                            # budget exhausted: the SENDING flow learns —
                            # a session that cannot deliver is failed
                            # locally rather than hanging forever
                            self._unacked.pop(e.base_id, None)
                            self._fail_session_locked(
                                e.sid, e.kind,
                                "session retry deadline exceeded "
                                f"(peer {e.party_name} unreachable)",
                            )
                            continue
                        if e.next_at <= now:
                            if ov is not None and not ov.allow_retry(
                                    "session", e.party_name):
                                # retry budget exhausted for this edge:
                                # hold one backoff without sending — the
                                # entry's hard deadline still bounds the
                                # total wait, and fresh sends refill
                                e.next_at = now + e.backoff_s
                                continue
                            e.attempt += 1
                            backoff = self._retry_policy.backoff_s(
                                e.attempt, self._retx_rng
                            )
                            if ov is not None and ov.edge_suspected(
                                    our, e.party_name):
                                # partition suspected on this edge (the
                                # net.partition_suspect event): widen
                                # pre-emptively so the heal meets a
                                # drained backoff, not a storm
                                backoff *= ov.suspect_backoff_scale
                            e.backoff_s = backoff
                            if e.attempt >= 2:
                                # FULL jitter over the whole backoff, not
                                # the policy's ±fraction: after a long
                                # outage every parked entry reaches
                                # next_at in the same tick, and fractional
                                # jitter re-releases them as one N-wide
                                # burst. Attempt 1 keeps the policy
                                # cadence (first-retransmit latency).
                                e.next_at = now + self._retx_rng.uniform(
                                    0.0, backoff
                                )
                            else:
                                e.next_at = now + backoff
                            resend.append((
                                e.party_name, e.payload,
                                f"{e.base_id}~{e.attempt}",
                            ))
                for name, payload, wire_id in resend:
                    try:
                        self.messaging.send(
                            name, SESSION_TOPIC, payload, msg_id=wire_id
                        )
                    except Exception:
                        pass  # transport down: the next tick retries
                # sleep until the soonest retransmit/deadline instead of a
                # fixed high-rate poll — an idle buffer with a 2s backoff
                # must not contend the SMM lock 50 times a second. The
                # condition wakes early on any SMM notify (new entries
                # notify via _track_unacked's lock exit), and the wait
                # re-evaluates from scratch either way.
                with self._lock:
                    if self._closed:
                        self._retx_timer = None
                        return
                    now = time.monotonic()
                    nxt = min(
                        (min(e.next_at, e.deadline)
                         for e in self._unacked.values()),
                        default=now + 0.5,
                    )
                    self._lock.wait(timeout=max(0.005, min(nxt - now, 0.5)))

        self._retx_timer = threading.Thread(
            target=loop, daemon=True, name="flow-session-retx"
        )
        self._retx_timer.start()

    def _fail_session_locked(self, sid: int, kind: str, error: str) -> None:
        sess = self._sessions.get(sid)
        if sess is None:
            return  # flow already finished; nothing is waiting
        if kind == "init":
            sess.rejected = error   # open_session waits on rejected/confirm
        else:
            sess.inbound.append(("end", error, "", None, 0))
        self._wake_key_locked(("sid", sid))
        self._lock.notify_all()

    def ack_session_msg(self, party: Party, logical_id: str) -> None:
        """Receiver side: acknowledge a consumed Data/End message (fresh
        wire id per ack so transport dedupe never swallows a re-ack)."""
        try:
            self.messaging.send(
                str(party.name), SESSION_TOPIC,
                serialize(SessionAck(logical_id)),
            )
        except Exception:
            pass  # sender will retransmit; we re-ack the duplicate

    def _drop_unacked_for_sid(self, sid: int, kind: str | None = None) -> None:
        """Confirm/Reject arrival settles the Init retransmit for a sid."""
        with self._lock:
            for bid in [
                b for b, e in self._unacked.items()
                if e.sid == sid and (kind is None or e.kind == kind)
            ]:
                self._unacked.pop(bid, None)

    def wait_or_killed(self, predicate, timeout: float | None = None,
                       executor=None, park_key=None, sleep_deadline=None):
        """Block until predicate() returns non-None/True; FlowKilled on
        shutdown or when this flow was explicitly killed. Runs under the
        SMM lock.

        With a ``park_key`` (or ``sleep_deadline``), a wait that outlives
        the parking grace PARKS the flow instead of holding its worker
        thread: the flow's state collapses to its checkpoint, the key is
        registered, and ``_FlowParked`` unwinds the worker. The wake
        (message arrival / commit / deadline) re-queues the flow, which
        replays to this exact wait and re-checks."""
        parkable = executor is not None and (
            park_key is not None or sleep_deadline is not None
        )
        deadline = None if timeout is None else time.monotonic() + timeout
        grace = (
            time.monotonic() + self._parking_grace_s if parkable else None
        )
        # hinted-wait window (flowprof): with a park hint set on the
        # calling flow (the notary client's notary_rtt scope), the wall
        # from here to satisfaction — whether the wait stays on-thread or
        # parks — books to the hinted phase; cross-thread attributions
        # landing inside the window (the response's message_transit) are
        # subtracted by note_unpark so the window is never double-booked.
        # The park path leaves the window OPEN: _unpark_locked closes it.
        fp = active_flowprof()
        acct = fp.current() if fp is not None else None
        if acct is not None:
            fp.note_park(acct)
        with self._lock:
            while True:
                if self._closed or (executor is not None and executor.killed):
                    raise FlowKilledException()
                val = predicate()
                if val not in (None, False):
                    if acct is not None:
                        fp.note_unpark(acct)
                    return val
                now = time.monotonic()
                if deadline is not None and now >= deadline:
                    if acct is not None:
                        fp.note_unpark(acct)
                    return None
                if grace is not None and now >= grace:
                    self._park_locked(
                        executor.flow_id, park_key, sleep_deadline
                    )
                    raise _FlowParked()
                waits = [0.5]
                if deadline is not None:
                    waits.append(deadline - now)
                if grace is not None:
                    waits.append(grace - now)
                self._lock.wait(timeout=max(0.001, min(waits)))

    def flow_finished(self, ex: _FlowExecutor) -> None:
        self._close_flow_span(ex.flow_id)
        fp = active_flowprof()
        if fp is not None:
            fp.close(ex.flow_id)
        self.checkpoints.remove_flow(ex.flow_id)
        with self._lock:
            self._flows.pop(ex.flow_id, None)
            self._results.pop(ex.flow_id, None)
            self._killed_ids.discard(ex.flow_id)
            self._commit_pinned.discard(ex.flow_id)
            self._park_key_of.pop(ex.flow_id, None)
            self._sleepers.pop(ex.flow_id, None)
            for sid in ex.sessions:
                self._sessions.pop(sid, None)
                if sid not in self._finished_sids:
                    if (len(self._finished_sids_order)
                            == self._finished_sids_order.maxlen):
                        self._finished_sids.discard(
                            self._finished_sids_order[0]
                        )
                    self._finished_sids_order.append(sid)
                    self._finished_sids.add(sid)

    # ------------------------------------------------------------ dispatch
    def _on_message(self, msg, ack=None) -> None:
        logical = _logical_id(msg.msg_id)
        obj = deserialize(msg.payload)
        if isinstance(obj, SessionAck):
            with self._lock:
                self._unacked.pop(obj.msg_id, None)
            if ack:
                ack()
            return
        with self._lock:
            consumed = logical in self._consumed_msg_ids
        if consumed:
            # duplicate of an already-consumed message (retransmit whose
            # ack was lost, or broker redelivery): re-ack so the sender's
            # retransmit buffer settles, then drop
            if isinstance(obj, (SessionData, SessionEnd)):
                peer = self._party_resolver(msg.sender)
                if peer is not None:
                    self.ack_session_msg(peer, logical)
            if ack:
                ack()
            return
        if isinstance(obj, SessionInit):
            self._handle_init(msg, obj, ack)
        elif isinstance(obj, SessionConfirm):
            with self._lock:
                sess = self._sessions.get(obj.initiator_session_id)
                if sess is not None:
                    sess.peer_sid = obj.responder_session_id
                    self._wake_key_locked(("sid", obj.initiator_session_id))
                    self._lock.notify_all()
            self._drop_unacked_for_sid(obj.initiator_session_id, "init")
            if ack:
                ack()
        elif isinstance(obj, SessionReject):
            with self._lock:
                sess = self._sessions.get(obj.initiator_session_id)
                if sess is not None:
                    sess.rejected = obj.error
                    self._wake_key_locked(("sid", obj.initiator_session_id))
                    self._lock.notify_all()
            self._drop_unacked_for_sid(obj.initiator_session_id, "init")
            if ack:
                ack()
        elif isinstance(obj, SessionData):
            self._buffer(obj.recipient_session_id, "data", obj.payload,
                         logical, ack, msg.sender, obj.seq)
        elif isinstance(obj, SessionEnd):
            self._buffer(obj.recipient_session_id, "end", obj.error,
                         logical, ack, msg.sender, obj.seq)

    def _buffer(self, sid: int, kind: str, body, msg_id: str, ack,
                sender: str = "", seq: int = 0) -> None:
        ack_peer = None
        transport_ack = False
        with self._lock:
            sess = self._sessions.get(sid)
            if sess is None:
                # session may not be re-registered yet during replay: park
                # by leaving the transport unacked (broker redelivers) or
                # rely on the peer's session-level retransmit on mock. An
                # END to a session a FINISHED flow pruned instead settles
                # BOTH acks — an unacked End would otherwise retransmit to
                # its full deadline (and redeliver every broker visibility
                # window) after every completed flow. The finished-sids
                # check is what distinguishes that case from the replay
                # window, where acking away the End would strand the
                # replayed flow's receive.
                if (kind == "end" and msg_id and sender
                        and sid in self._finished_sids):
                    ack_peer = self._party_resolver(sender)
                    transport_ack = True
            elif msg_id and msg_id in self._consumed_msg_ids:
                # RE-CHECK consumed under the append lock: the dispatch-
                # entry check ran before this message waited on the lock,
                # and the original may have been consumed in between — a
                # stale append here would be replayed as a LATER message
                ack_peer = sess.peer
                transport_ack = True
                sess = None  # handled: fall through to the ack block
            elif any(q[2] == msg_id for q in sess.inbound if q[2]) or any(
                    q[2] == msg_id
                    for q in sess.seq_pending.values() if q[2]):
                # retransmit already buffered but not yet consumed: settle
                # this duplicate's transport lease (the buffered original's
                # own ack + session retransmit carry the delivery guarantee)
                transport_ack = True
                sess = None
            elif seq and seq <= sess.seq_enqueued:
                # a sequence position already delivered under another wire
                # id: nothing left to deliver, settle the transport lease
                # (the sender's own retransmit/deadline settles its entry)
                transport_ack = True
                sess = None
            else:
                if msg_id:
                    # transit telemetry at ARRIVAL — a message parked in
                    # seq_pending has finished its network leg even though
                    # delivery to the flow waits for the gap to fill
                    fp = active_flowprof()
                    if fp is not None:
                        ex = sess.executor
                        fp.take_transit(
                            msg_id,
                            fp.acct_of(ex.flow_id) if ex is not None
                            else None,
                        )
                    cl = active_cluster()
                    if cl is not None and sender:
                        ex = sess.executor
                        span = (self._flow_spans.get(ex.flow_id)
                                if ex is not None else None)
                        cl.note_recv(
                            str(self.our_identity.name), sender, msg_id,
                            span.trace_id if span is not None else "",
                        )
                entry = (kind, body, msg_id, ack, seq)
                if seq and seq > sess.seq_enqueued + 1:
                    # out of order: a lower-seq message is still in flight
                    # (dropped → retransmitting, or delayed). Park until
                    # the gap fills — delivering now would let this
                    # message (or the End) overtake the one the flow's
                    # next receive actually needs.
                    sess.seq_pending[seq] = entry
                    if sess.gap_since is None:
                        sess.gap_since = time.monotonic()
                    if not sess.gap_timer_armed:
                        # liveness backstop: if the gap never fills (the
                        # sender hit its retry deadline and gave up), a
                        # timer force-drains rather than park the
                        # receiving flow forever. Transient thread, only
                        # when reordering actually occurred — clean runs
                        # create no threads (the off-by-default pin).
                        sess.gap_timer_armed = True
                        t = threading.Timer(
                            self._gap_limit_s(), self._gap_check,
                            args=(sid,))
                        t.daemon = True
                        t.name = f"flow-session-gap-{sid}"
                        t.start()
                else:
                    sess.inbound.append(entry)
                    if seq:
                        sess.seq_enqueued = seq
                    # drain consecutive parked successors
                    nxt = sess.seq_enqueued + 1
                    while nxt in sess.seq_pending:
                        sess.inbound.append(sess.seq_pending.pop(nxt))
                        sess.seq_enqueued = nxt
                        nxt += 1
                    # the front gap just moved: clear the backstop clock,
                    # or restart it for the next gap in line
                    sess.gap_since = (None if not sess.seq_pending
                                      else time.monotonic())
                self._wake_key_locked(("sid", sid))
                self._lock.notify_all()
                return
        if ack_peer is not None and msg_id:
            self.ack_session_msg(ack_peer, msg_id)
        if transport_ack and ack:
            ack()

    def _gap_limit_s(self) -> float:
        """How long a sequence gap may park deliveries before the
        backstop concludes the missing message is never coming: the
        session retry deadline — past it the sender has failed the
        session on its side, so no retransmit can still be in flight."""
        if self._retry_policy is not None:
            return self._retry_policy.deadline_s
        return 60.0

    def _gap_check(self, sid: int) -> None:
        """Timer body for the sequencing liveness backstop (armed in
        _buffer when a message parks behind a gap). If the front gap is
        older than _gap_limit_s, force-drain seq_pending in sequence
        order: the flow then observes the loss as a protocol error /
        peer-end instead of parking forever — exactly the
        pre-sequencing failure mode, minus the reorder window. A late
        retransmit of the gap seq then lands `seq <= seq_enqueued` and
        is settled as a stale position."""
        rearm: float | None = None
        with self._lock:
            sess = self._sessions.get(sid)
            if sess is None or self._closed:
                return
            if not sess.seq_pending:
                sess.gap_timer_armed = False
                sess.gap_since = None
                return
            now = time.monotonic()
            started = sess.gap_since if sess.gap_since is not None else now
            if now - started >= self._gap_limit_s() - 0.05:
                for s in sorted(sess.seq_pending):
                    sess.inbound.append(sess.seq_pending.pop(s))
                    sess.seq_enqueued = max(sess.seq_enqueued, s)
                sess.gap_since = None
                sess.gap_timer_armed = False
                self._wake_key_locked(("sid", sid))
                self._lock.notify_all()
            else:
                # gap moved (partial drain) since the timer was armed:
                # check again when the current front gap would expire
                rearm = max(0.1, self._gap_limit_s() - (now - started))
        if rearm is not None:
            t = threading.Timer(rearm, self._gap_check, args=(sid,))
            t.daemon = True
            t.name = f"flow-session-gap-{sid}"
            t.start()

    def _handle_init(self, msg, init: SessionInit, ack) -> None:
        logical = _logical_id(msg.msg_id)
        flow_id = f"resp-{logical}"
        if not self.checkpoints.mark_init_processed(logical, flow_id):
            # duplicate Init (crash-replayed or retransmitted by the
            # initiator): our Confirm may have been lost — re-send it
            # (dedupe makes it harmless). Session ids derive determini-
            # stically from (flow id, op 0), so the Confirm can be
            # reconstructed even after the responder finished and its
            # session state was pruned.
            with self._lock:
                ex = self._flows.get(flow_id)
                resend = None
                if ex is not None:
                    for sid in ex.sessions:
                        sess = self._sessions.get(sid)
                        if sess is not None and sess.peer_sid == init.initiator_session_id:
                            resend = (sess.peer, SessionConfirm(sess.peer_sid, sid),
                                      f"{flow_id}:confirm")
            if resend is None:
                peer = self._party_resolver(msg.sender)
                claimed = self.checkpoints.init_flow_id(logical)
                if claimed is not None and claimed.startswith("rejected:"):
                    # the original open was REJECTED: repeat the verdict,
                    # never fabricate a Confirm for a responder that was
                    # never spawned
                    self.messaging.send(
                        msg.sender, SESSION_TOPIC,
                        serialize(SessionReject(
                            init.initiator_session_id,
                            claimed[len("rejected:"):],
                        )),
                        msg_id=f"reject-{msg.msg_id}",
                    )
                elif peer is not None and claimed is not None:
                    resend = (
                        peer,
                        SessionConfirm(
                            init.initiator_session_id, _sid_for(claimed, 0)
                        ),
                        f"{claimed}:confirm",
                    )
            if resend is not None:
                # fresh wire id per resend: the ORIGINAL Confirm may have
                # been delivered (and its id remembered by the transport's
                # dedupe) even though the initiator never processed it —
                # a fixed id would be silently swallowed on every retry
                self.send_to(
                    resend[0], resend[1],
                    msg_id=f"{resend[2]}~{Message.fresh_id()[:8]}",
                )
            if ack:
                ack()
            return
        responder = responder_for(init.flow_name)
        peer = self._party_resolver(msg.sender)
        if responder is None or peer is None:
            reason = (
                f"no responder registered for {init.flow_name}"
                if responder is None else f"unknown peer {msg.sender}"
            )
            # overwrite the claim so a RETRANSMITTED init of a rejected
            # open re-sends the rejection — without this marker the
            # duplicate branch would reconstruct a Confirm for a
            # responder that never existed and the initiator would hang
            self.checkpoints.mark_init_rejected(logical, reason)
            self.messaging.send(
                msg.sender, SESSION_TOPIC,
                serialize(SessionReject(init.initiator_session_id, reason)),
                msg_id=f"reject-{msg.msg_id}",
            )
            if ack:
                ack()
            return
        if init.deadline and time.time() >= init.deadline:
            # the initiator's caller already gave up: reject before
            # spawning a responder that would burn verify/notary work on
            # a dead flow (docs/OVERLOAD.md). Marked like any rejection
            # so a retransmitted Init repeats the verdict.
            reason = "flow deadline exceeded before responder start"
            self.checkpoints.mark_init_rejected(logical, reason)
            ov = active_overload()
            if ov is not None:
                ov.note_deadline_shed()
            self.messaging.send(
                msg.sender, SESSION_TOPIC,
                serialize(SessionReject(init.initiator_session_id, reason)),
                msg_id=f"reject-{msg.msg_id}",
            )
            if ack:
                ack()
            return
        self._open_flow_span(flow_id, class_path(responder),
                             responder=True, parent_wire=init.trace)
        cl = active_cluster()
        if cl is not None:
            # the Init hop's delivery stamp: trace id straight off the
            # wire context (authoritative even when unsampled locally)
            cl.note_recv(
                str(self.our_identity.name), msg.sender, logical,
                init.trace.split(":", 1)[0] if init.trace else "",
            )
        fp = active_flowprof()
        if fp is not None:
            fp.open(flow_id, class_path(responder))
        blob = serialize({
            "cls": class_path(responder),
            "fields": {},
            "responder": True,
            # the propagated deadline survives responder park/replay and
            # crash restore exactly like the initiator's (omitted when
            # unset — pre-overload checkpoint shape unchanged)
            **({"deadline": init.deadline} if init.deadline else {}),
        })
        self.checkpoints.add_flow(flow_id, blob, str(self.our_identity.name),
                                  time.time())
        fut: Future = Future()
        ex = _FlowExecutor(
            self, flow_id, [], None, responder_cls=responder,
            init_info={"peer": peer, "peer_sid": init.initiator_session_id,
                       "first": init.first_payload},
            result=fut,
        )
        ex.deadline_t = init.deadline or None
        with self._lock:
            self._flows[flow_id] = ex
            self._results[flow_id] = fut
        if ack:
            ack()  # responder is durable; Init is consumed
        self._enqueue(flow_id)
