"""Seeded, deterministic fault plans + the injector that executes them
(counterpart of corda_tpu/faultinject/plan.py, copied whole).

The chaos engine of the robustness tier (reference inspiration:
InternalMockNetwork's message-altering hooks and Disruption.kt's
kill-the-node loadtest disruptions — here unified behind ONE seeded plan):
a ``FaultPlan`` declares *what* may go wrong (message drop / delay /
duplicate / reorder probabilities, link partitions, replica crash
schedules, broker-level loss and redelivery, injected device-op
failures); a ``FaultInjector`` executes it and records every injected
event in a trace.

Determinism contract: every decision is a pure function of
``(seed, decision kind, site key, attempt count)`` — derived by hashing,
NOT by consuming a shared RNG stream — so the same logical message
stream receives the same faults regardless of thread interleaving, and a
replay of an identical driven scenario produces a bit-identical trace
(``trace_digest``). Probabilities only shape *which* keys fail; the
mapping from key to outcome is fixed by the seed.

Hook points live in ``messaging/network.py`` (delivery faults),
``messaging/queue.py`` (broker publish loss + forced redelivery),
``messaging/fabric.py`` (connection-drop injection on control ops),
``verifier/batch.py`` (device-op failures via the module-level
``check_site``), ``batchverify/rlc.py`` (the RLC batch MSM at
``batchverify.msm``), and ``notary/bft.py`` (quorum-certificate
aggregation at ``notary.aggregate``). Crash schedules are driven by
``faultinject.chaos.ChaosOrchestrator``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import defaultdict


class InjectedFault(Exception):
    """Raised by ``check_site`` when the active plan injects a failure at
    that site. Hardened code paths treat it like any other backend/device
    error — the injection proves the degradation path, it does not get a
    special-cased rescue."""


class InjectedCrash(BaseException):
    """Raised by ``crash_point`` when the plan schedules a process death at
    a durability crash site (pre-fsync, post-fsync-pre-ack, mid-snapshot-
    rename, mid-compaction). A BaseException on purpose: nothing on the
    dying "process"'s stack may catch and recover it — the kill-storm
    harness catches it at the very top, discards every in-memory object
    (that IS the crash) and rebuilds the component from its durability
    directory alone."""


@dataclasses.dataclass(frozen=True)
class CrashEvent:
    """Scheduled crash of one named node at a pump round; the chaos
    orchestrator restarts it ``down_rounds`` later (0 = never)."""

    at_round: int
    node: str
    down_rounds: int = 50


@dataclasses.dataclass(frozen=True)
class Partition:
    """A link partition active for rounds [from_round, until_round):
    messages between ``side_a`` and ``side_b`` drop both ways. An empty
    ``side_b`` means "everyone not in side_a"."""

    from_round: int
    until_round: int
    side_a: frozenset
    side_b: frozenset = frozenset()

    def severs(self, a: str, b: str, rnd: int) -> bool:
        if not (self.from_round <= rnd < self.until_round):
            return False
        in_a, in_b = a in self.side_a, b in self.side_a
        if in_a == in_b:
            return False  # same side
        other = b if in_a else a
        return not self.side_b or other in self.side_b


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Everything the injector may do, declared up front. Immutable so a
    plan can be shared, logged, and re-run verbatim."""

    seed: int
    # ---- transport-level message faults (in-memory network)
    drop_p: float = 0.0
    delay_p: float = 0.0
    delay_rounds: tuple = (1, 4)       # inclusive range of pump rounds
    duplicate_p: float = 0.0
    reorder_p: float = 0.0
    # ---- broker-level faults (durable queue)
    broker_publish_drop_p: float = 0.0
    broker_redeliver_p: float = 0.0
    # ---- named-site op failures (device dispatch, fabric control ops)
    op_fail_p: float = 0.0
    fail_sites: tuple = ()             # ((site, nth_call), ...) — explicit
    # ---- named-site op STALLS: the op succeeds but only after an
    # injected delay — a sick device that computes without failing. The
    # delay is returned by check_site and applied by the site's owner at
    # its stall point (the serving scheduler / verifier bucket inject it
    # into the pending's readiness, so the batch is genuinely in flight
    # and not-ready for the whole delay — the shape the hedge path must
    # survive). ((site, nth_call, delay_s), ...).
    stall_sites: tuple = ()
    # ---- named-site process CRASHES: the nth call of a durability crash
    # site raises InjectedCrash — simulated process death at exactly that
    # instruction (the durability layer guards its fsync/rename/reclaim
    # boundaries with crash_point). ((site, nth_call), ...).
    crash_sites: tuple = ()
    # ---- topology faults
    partitions: tuple = ()             # Partition entries
    crashes: tuple = ()                # CrashEvent entries


@dataclasses.dataclass(frozen=True)
class InjectedEvent:
    kind: str      # drop|delay|duplicate|reorder|partition|publish-drop|...
    site: str      # "sender->recipient" edge, queue name, or op site
    key: str       # msg id / call ordinal the decision was keyed on
    round: int     # pump round (or -1 where rounds don't apply)
    # the trace active on the injecting thread ("" when untraced): joins a
    # chaos event against the request traces it disturbed
    # (docs/OBSERVABILITY.md). Excluded from trace_digest — trace ids are
    # random per run, and the digest's bit-for-bit replay contract is over
    # the plan's own deterministic decisions.
    trace_id: str = ""


@dataclasses.dataclass
class DeliveryVerdict:
    drop: bool = False
    reason: str = ""
    delay_rounds: int = 0
    duplicate: bool = False
    reorder: bool = False


class FaultInjector:
    """Executes one FaultPlan; thread-safe; owns the event trace."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._delivery_counts: dict = defaultdict(int)
        self._site_counts: dict = defaultdict(int)
        self.trace: list[InjectedEvent] = []

    # ------------------------------------------------------------ decisions
    def _u(self, *parts) -> float:
        """Uniform [0,1) derived by hashing — stable across interleavings."""
        h = hashlib.sha256(
            ("%d|" % self.plan.seed + "|".join(str(p) for p in parts)).encode()
        ).digest()
        return int.from_bytes(h[:8], "big") / 2.0**64

    def _record(self, kind: str, site: str, key: str, rnd: int = -1) -> None:
        from ..observability.trace import current_trace_id

        event = InjectedEvent(kind, site, key, rnd, current_trace_id())
        with self._lock:
            self.trace.append(event)

    def trace_digest(self) -> str:
        """One hash over the whole trace — the bit-for-bit reproducibility
        check (same seed + same driven scenario → same digest)."""
        with self._lock:
            body = "\n".join(
                f"{e.kind}|{e.site}|{e.key}|{e.round}" for e in self.trace
            )
        return hashlib.sha256(body.encode()).hexdigest()

    # ------------------------------------------------- transport delivery
    def on_deliver(
        self, sender: str, recipient: str, msg_id: str, rnd: int
    ) -> DeliveryVerdict:
        p = self.plan
        edge = f"{sender}->{recipient}"
        with self._lock:
            nth = self._delivery_counts[(edge, msg_id)]
            self._delivery_counts[(edge, msg_id)] += 1
        key = f"{msg_id}#{nth}"
        for part in p.partitions:
            if part.severs(sender, recipient, rnd):
                self._record("partition", edge, key, rnd)
                return DeliveryVerdict(drop=True, reason="partition")
        if p.drop_p and self._u("drop", edge, key) < p.drop_p:
            self._record("drop", edge, key, rnd)
            return DeliveryVerdict(drop=True, reason="drop")
        v = DeliveryVerdict()
        if p.delay_p and self._u("delay", edge, key) < p.delay_p:
            lo, hi = p.delay_rounds
            v.delay_rounds = lo + int(
                self._u("delay-n", edge, key) * (hi - lo + 1)
            )
            self._record("delay", edge, key, rnd)
            return v
        if p.duplicate_p and self._u("dup", edge, key) < p.duplicate_p:
            v.duplicate = True
            self._record("duplicate", edge, key, rnd)
        if p.reorder_p and self._u("reorder", edge, key) < p.reorder_p:
            v.reorder = True
            self._record("reorder", edge, key, rnd)
        return v

    # ------------------------------------------------------------- broker
    def on_broker_publish(self, queue: str, msg_id: str) -> bool:
        """True → the publish is silently lost (wire loss before the
        journal; exercises client retry / at-least-once recovery)."""
        p = self.plan
        if p.broker_publish_drop_p and self._u(
            "pub-drop", queue, msg_id
        ) < p.broker_publish_drop_p:
            self._record("publish-drop", queue, msg_id)
            return True
        return False

    def on_broker_deliver(self, queue: str, msg_id: str) -> bool:
        """True → leave the message leasable so it redelivers immediately
        (a forced visibility-timeout duplicate; exercises consumer-side
        idempotency)."""
        p = self.plan
        if not p.broker_redeliver_p:
            return False
        with self._lock:
            nth = self._site_counts[("redeliver", queue, msg_id)]
            self._site_counts[("redeliver", queue, msg_id)] += 1
        if nth == 0 and self._u("redeliver", queue, msg_id) < p.broker_redeliver_p:
            self._record("redeliver", queue, msg_id)
            return True
        return False

    # ---------------------------------------------------------- op sites
    def _next_call(self, site: str) -> int:
        """One shared per-site call counter: fail and stall schedules
        address the same nth-call ordinal whichever mode fires."""
        with self._lock:
            nth = self._site_counts[site] = self._site_counts[site] + 1
        return nth

    def _fail_decision(self, site: str, nth: int) -> bool:
        for want_site, want_nth in self.plan.fail_sites:
            if want_site == site and want_nth == nth:
                return True
        return bool(
            self.plan.op_fail_p
            and self._u("op", site, nth) < self.plan.op_fail_p
        )

    def _stall_decision(self, site: str, nth: int) -> float:
        for want_site, want_nth, delay_s in self.plan.stall_sites:
            if want_site == site and want_nth == nth:
                return max(float(delay_s), 0.0)
        return 0.0

    def fail_op(self, site: str) -> bool:
        """Probabilistic / scheduled failure for a named op site; the
        caller turns True into its own error type (the fabric raises
        ConnectionError to drive its reconnect path)."""
        nth = self._next_call(site)
        if self._fail_decision(site, nth):
            self._record("op-fail", site, str(nth))
            return True
        return False

    def check_site(self, site: str) -> float:
        """Raise InjectedFault when the plan fails this site's nth call;
        otherwise return the injected STALL delay for it (0.0 when none).
        The caller owns the stall semantics: the serving/verifier sites
        graft the delay onto the dispatched pending's readiness so the
        batch stalls in flight rather than blocking its dispatcher."""
        nth = self._next_call(site)
        delay = self._stall_decision(site, nth)
        if delay > 0:
            self._record("op-stall", site, str(nth))
        if self._fail_decision(site, nth):
            self._record("op-fail", site, str(nth))
            raise InjectedFault(f"injected fault at {site}")
        return delay

    def crash_point(self, site: str) -> None:
        """Raise InjectedCrash when the plan schedules a crash at this
        site's nth call. Recorded as an ``op-crash`` event carrying the
        active trace id like every other injected fault, so a crash joins
        against the request traces it killed."""
        nth = self._next_call(site)
        for want_site, want_nth in self.plan.crash_sites:
            if want_site == site and want_nth == nth:
                self._record("op-crash", site, str(nth))
                raise InjectedCrash(f"injected crash at {site}#{nth}")


# -------------------------------------------------- module-level install
# The device-op hook point (verifier/batch.py) sits below every call
# signature that could thread an injector through, so the active injector
# installs process-globally — exactly one at a time, tests install/clear
# around each scenario.

_active: FaultInjector | None = None
_install_lock = threading.Lock()


def install(injector: FaultInjector) -> FaultInjector:
    global _active
    with _install_lock:
        _active = injector
    return injector


def clear() -> None:
    global _active
    with _install_lock:
        _active = None


def active() -> FaultInjector | None:
    return _active


def check_site(site: str) -> float:
    """No-op unless a plan is installed — the production-path cost of the
    hook is one global read. Returns the injected stall delay (0.0 when
    no plan, or the plan leaves this call alone)."""
    inj = _active
    if inj is not None:
        return inj.check_site(site)
    return 0.0


def crash_point(site: str) -> None:
    """No-op unless a plan is installed (one global read on the production
    path). Raises InjectedCrash when the active plan schedules a crash at
    this site's nth call — the durability layer's fsync/rename/reclaim
    boundaries are guarded with exactly this."""
    inj = _active
    if inj is not None:
        inj.crash_point(site)


def truncate_wal_tail(wal_dir, nbytes: int) -> str | None:
    """The torn-write injector: chop ``nbytes`` off the end of the newest
    WAL segment under ``wal_dir`` — the on-disk shape a power cut leaves
    when the kernel tore the final append mid-sector. Returns the path
    truncated (None when the directory holds no segment, or the cut would
    empty a file below its header). Recovery must discard exactly the torn
    tail record and keep every record before it."""
    import os

    segs = sorted(
        f for f in os.listdir(wal_dir)
        if f.startswith("wal-") and f.endswith(".seg")
    )
    if not segs:
        return None
    path = os.path.join(wal_dir, segs[-1])
    size = os.path.getsize(path)
    # never cut into the 16-byte segment header: a headerless segment
    # reads as a crash-mid-roll artifact and is discarded WHOLE on
    # recovery — a shape a torn append cannot physically produce, which
    # would fake "lost acked commits" the real crash model never loses
    if nbytes <= 0 or size - nbytes < 16:
        return None
    with open(path, "r+b") as f:
        f.truncate(size - nbytes)
    return path
