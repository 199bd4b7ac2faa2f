"""Self-healing dispatch policy: quarantine, hedging, circuit breaking
(counterpart of corda_tpu/serving/resilience.py).

The policy layer the ``DeviceScheduler`` consults on every dispatch and
settle, one state machine per device ordinal. Four mechanisms:

1. **Quarantine state machine** per ordinal::

       HEALTHY ──strike──▶ SUSPECT ──K strikes──▶ QUARANTINED
          ▲                   │                        │ backoff
          │  probe verdicts   │ clean settle           ▼ elapsed
          └─────────────── PROBATION ◀── canary probe dispatched

   Strikes come from dispatch failures (injected faults and
   ``ServingError``: a real launch error raises into the caller instead),
   fired hedges (stall evidence) and devicemon's ``device.unhealthy``
   events. A quarantined ordinal gets no scheduler traffic; it is
   readmitted only by exponential-backoff **canary probes**: a known-answer
   batch (valid rows and one tampered) verified on that ordinal's device
   (``parallel.mesh.device_for_ordinal``), whose verdicts must match and
   must have settled on the device. Quarantine entry writes one flight
   dump an episode.
2. **Hedged dispatch deadlines**: execute-wall EWMA (devicemon's when on,
   else the scheduler's) x ``CORDA_TPU_HEDGE_FACTOR``, clamped; the
   scheduler's hedge thread fires them.
3. **Circuit breaker** an ordinal: K consecutive failures or hedge losses
   trip it OPEN, a backoff HALF_OPEN canary closes it.
4. **Deterministic re-dispatch** (scheduler side): a failed batch re-enters
   the queue with its original arrival times, up to ``redispatch_limit``.

Off by default: pass a ``ResiliencePolicy`` to
``DeviceScheduler(resilience=...)``, or set ``CORDA_TPU_RESILIENCE=1``.
The reference's switches keep their names (``CORDA_TPU_RESILIENCE``,
``CORDA_TPU_HEDGE_FACTOR``, ``CORDA_TPU_QUARANTINE_STRIKES``). Counters
live under ``serving.quarantine.*`` / ``serving.hedge.*`` /
``serving.breaker.*`` in the process registry; the state is the
``resilience`` section of ``monitoring_snapshot()`` and of every flight
dump.
"""

from __future__ import annotations

import os
import threading
import time

# ------------------------------------------------------- quarantine states

HEALTHY = "healthy"
SUSPECT = "suspect"            # struck, still serving traffic
QUARANTINED = "quarantined"    # evicted; waiting out the probe backoff
PROBATION = "probation"        # canary probe in flight

# ----------------------------------------------------------- breaker states

BREAKER_CLOSED = 0
BREAKER_OPEN = 1
BREAKER_HALF_OPEN = 2


def _metrics():
    from ..node.monitoring import node_metrics

    return node_metrics()


def _env_float(name: str, default: float) -> float:
    try:
        raw = os.environ.get(name, "").strip()
        return float(raw) if raw else default
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        raw = os.environ.get(name, "").strip()
        return int(raw) if raw else default
    except ValueError:
        return default


class _OrdinalHealth:
    """Per-ordinal quarantine bookkeeping. Mutated only under the owning
    DeviceQuarantine's lock."""

    __slots__ = ("ordinal", "state", "strikes", "last_reason",
                 "probe_backoff_s", "next_probe_t", "episodes", "dumped")

    def __init__(self, ordinal: int, probe_backoff_s: float):
        self.ordinal = ordinal
        self.state = HEALTHY
        self.strikes = 0
        self.last_reason = ""
        self.probe_backoff_s = probe_backoff_s
        self.next_probe_t: float | None = None
        self.episodes = 0          # quarantine entries over the lifetime
        self.dumped = False        # flight dump written for this episode


class DeviceQuarantine:
    """The per-ordinal HEALTHY → SUSPECT → QUARANTINED → PROBATION state
    machine. Pure bookkeeping under one lock plus a fake-able clock, so
    tests drive the full cycle deterministically; the probe *execution*
    lives on the owning policy."""

    def __init__(self, *, strikes: int | None = None,
                 probe_backoff_s: float = 0.5,
                 probe_backoff_max_s: float = 30.0,
                 clock=time.monotonic):
        # env knob first (docs/SERVING.md §Self-healing dispatch), then
        # the constructor default: K strikes evict the ordinal
        self.strikes_limit = max(1, strikes if strikes is not None
                                 else _env_int("CORDA_TPU_QUARANTINE_STRIKES", 3))
        self.probe_backoff_s = max(1e-3, float(probe_backoff_s))
        self.probe_backoff_max_s = max(self.probe_backoff_s,
                                       float(probe_backoff_max_s))
        self._clock = clock
        self._lock = threading.Lock()
        self._ordinals: dict[int, _OrdinalHealth] = {}

    def _slot_locked(self, ordinal: int) -> _OrdinalHealth:
        slot = self._ordinals.get(ordinal)
        if slot is None:
            slot = self._ordinals[ordinal] = _OrdinalHealth(
                ordinal, self.probe_backoff_s
            )
        return slot

    # ------------------------------------------------------------- reads
    def state(self, ordinal: int) -> str:
        with self._lock:
            return self._slot_locked(ordinal).state

    def blocked(self, ordinal: int) -> bool:
        """True while the ordinal must receive no scheduler traffic."""
        with self._lock:
            return self._slot_locked(ordinal).state in (
                QUARANTINED, PROBATION
            )

    def active_count(self) -> int:
        with self._lock:
            return sum(
                1 for s in self._ordinals.values()
                if s.state in (QUARANTINED, PROBATION)
            )

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "strikes_limit": self.strikes_limit,
                "ordinals": {
                    str(o): {
                        "state": s.state,
                        "strikes": s.strikes,
                        "last_reason": s.last_reason,
                        "episodes": s.episodes,
                        "probe_backoff_s": round(s.probe_backoff_s, 6),
                    }
                    for o, s in sorted(self._ordinals.items())
                },
            }

    # ------------------------------------------------------- transitions
    #
    # Counter increments happen OUTSIDE the state lock throughout this
    # module: the registered gauges (serving.quarantine.active /
    # serving.breaker.state) read these state machines from UNDER the
    # metric registry's lock at snapshot time, so taking the registry
    # lock (counter lookup) while holding a state lock would be exactly
    # the A→B/B→A inversion the lockwatch soak exists to catch.

    def strike(self, ordinal: int, reason: str) -> bool:
        """One strike against the ordinal (dispatch failure, fired hedge,
        watchdog eviction). Returns True exactly when this strike ENTERS
        quarantine — the caller owes the once-per-episode flight dump."""
        now = self._clock()
        entered = False
        counted = False
        with self._lock:
            slot = self._slot_locked(ordinal)
            if slot.state not in (QUARANTINED, PROBATION):
                # an already-evicted ordinal takes no further strikes;
                # probes own its readmission
                counted = True
                slot.strikes += 1
                slot.last_reason = reason
                if slot.strikes < self.strikes_limit:
                    slot.state = SUSPECT
                else:
                    slot.state = QUARANTINED
                    slot.episodes += 1
                    slot.dumped = False
                    slot.probe_backoff_s = self.probe_backoff_s
                    slot.next_probe_t = now + slot.probe_backoff_s
                    entered = True
        if counted:
            _metrics().counter("serving.quarantine.strikes").inc()
        if entered:
            _metrics().counter("serving.quarantine.entered").inc()
        return entered

    def healthy_settle(self, ordinal: int) -> None:
        """A clean device settle heals a SUSPECT back to HEALTHY (strikes
        only accumulate across consecutive trouble, not over a lifetime
        of good service). Quarantined/probation ordinals are untouched —
        only a canary verdict readmits them."""
        with self._lock:
            slot = self._slot_locked(ordinal)
            if slot.state == SUSPECT:
                slot.state = HEALTHY
                slot.strikes = 0
                slot.last_reason = ""

    def due_probe(self, now: float | None = None) -> int | None:
        """The next quarantined ordinal whose probe backoff elapsed —
        transitioned to PROBATION here so no second probe can race in
        before the verdict lands."""
        if now is None:
            now = self._clock()
        with self._lock:
            for o in sorted(self._ordinals):
                slot = self._ordinals[o]
                if (slot.state == QUARANTINED
                        and slot.next_probe_t is not None
                        and now >= slot.next_probe_t):
                    slot.state = PROBATION
                    return o
        return None

    def probe_result(self, ordinal: int, ok: bool) -> None:
        """The canary verdict: readmit (HEALTHY, strikes cleared, backoff
        reset) or return to QUARANTINED with the backoff doubled."""
        now = self._clock()
        counted = None
        with self._lock:
            slot = self._slot_locked(ordinal)
            if slot.state != PROBATION:
                return  # stale verdict (reset raced the probe)
            if ok:
                slot.state = HEALTHY
                slot.strikes = 0
                slot.last_reason = ""
                slot.next_probe_t = None
                slot.probe_backoff_s = self.probe_backoff_s
                slot.dumped = False
                counted = "serving.quarantine.readmitted"
            else:
                slot.state = QUARANTINED
                slot.probe_backoff_s = min(
                    slot.probe_backoff_s * 2.0, self.probe_backoff_max_s
                )
                slot.next_probe_t = now + slot.probe_backoff_s
                counted = "serving.quarantine.probe_failures"
        if counted:
            _metrics().counter(counted).inc()

    def claim_episode_dump(self, ordinal: int) -> bool:
        """True exactly once per quarantine episode — the flight-dump
        latch (a second strike or snapshot in the same episode must not
        write a second dump)."""
        with self._lock:
            slot = self._slot_locked(ordinal)
            if slot.state not in (QUARANTINED, PROBATION) or slot.dumped:
                return False
            slot.dumped = True
            return True


class CircuitBreaker:
    """One ordinal's breaker: K consecutive device failures or hedge
    losses trip it OPEN (the scheduler drops the ordinal from the stripe
    set; with every ordinal open the whole tier host-routes), an
    exponential-backoff HALF_OPEN canary closes it. The policy keeps one
    instance per ordinal (``breaker_for``); the mesh rollup is the
    ``serving.breaker.state`` gauge (0 closed / 1 open / 2 half-open)."""

    def __init__(self, *, threshold: int = 3, backoff_s: float = 1.0,
                 backoff_max_s: float = 60.0, clock=time.monotonic):
        self.threshold = max(1, int(threshold))
        self.backoff_s = max(1e-3, float(backoff_s))
        self.backoff_max_s = max(self.backoff_s, float(backoff_max_s))
        self._clock = clock
        self._lock = threading.Lock()
        self._state = BREAKER_CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._cur_backoff = self.backoff_s

    @property
    def state(self) -> int:
        return self._state

    def allow_device(self) -> bool:
        """False while the device tier is evicted (open or probing) —
        scheduler batches host-route; only canary probes touch the
        device."""
        return self._state == BREAKER_CLOSED

    def record_failure(self) -> bool:
        """One device failure / hedge loss; returns True when this one
        TRIPS the breaker open. (Counters bump outside the state lock —
        the serving.breaker.state gauge reads it from under the registry
        lock.)"""
        tripped = False
        with self._lock:
            self._consecutive += 1
            if (self._state == BREAKER_CLOSED
                    and self._consecutive >= self.threshold):
                self._state = BREAKER_OPEN
                self._opened_at = self._clock()
                self._cur_backoff = self.backoff_s
                tripped = True
        if tripped:
            _metrics().counter("serving.breaker.opened").inc()
        return tripped

    def record_success(self) -> None:
        """A clean device settle breaks the failure streak (only reached
        while CLOSED — open/half-open tiers serve no scheduler
        traffic)."""
        with self._lock:
            self._consecutive = 0

    def probe_due(self, now: float | None = None) -> bool:
        """True when the open breaker's backoff elapsed — transitions to
        HALF_OPEN here, so exactly one canary owns the verdict."""
        if now is None:
            now = self._clock()
        with self._lock:
            if (self._state == BREAKER_OPEN
                    and now >= self._opened_at + self._cur_backoff):
                self._state = BREAKER_HALF_OPEN
                return True
        return False

    def probe_result(self, ok: bool) -> None:
        counted = None
        with self._lock:
            if self._state != BREAKER_HALF_OPEN:
                return
            if ok:
                self._state = BREAKER_CLOSED
                self._consecutive = 0
                self._cur_backoff = self.backoff_s
                counted = "serving.breaker.closed"
            else:
                self._state = BREAKER_OPEN
                self._opened_at = self._clock()
                self._cur_backoff = min(
                    self._cur_backoff * 2.0, self.backoff_max_s
                )
                counted = "serving.breaker.opened"
        if counted:
            _metrics().counter(counted).inc()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "state_name": {
                    BREAKER_CLOSED: "closed", BREAKER_OPEN: "open",
                    BREAKER_HALF_OPEN: "half-open",
                }[self._state],
                "consecutive_failures": self._consecutive,
                "threshold": self.threshold,
                "backoff_s": round(self._cur_backoff, 6),
            }


class ResiliencePolicy:
    """The facade the scheduler consults. One instance per scheduler
    (the process-global scheduler's policy is also the process-global
    ``active_policy()`` the flight recorder snapshots).

    ``probe_runner`` overrides the canary execution for tests — a
    callable ``(ordinal) -> bool``; the default dispatches the
    known-answer batch through ``dispatch_signature_rows`` and demands
    device settlement plus exact verdicts."""

    def __init__(self, *, strikes: int | None = None,
                 hedge_factor: float | None = None,
                 hedge_min_s: float = 0.05, hedge_max_s: float = 30.0,
                 probe_backoff_s: float = 0.5,
                 probe_backoff_max_s: float = 30.0,
                 breaker_threshold: int = 3,
                 breaker_backoff_s: float = 1.0,
                 breaker_backoff_max_s: float = 60.0,
                 redispatch_limit: int = 2,
                 flight_dump_on_quarantine: bool = True,
                 probe_timeout_s: float = 600.0,
                 probe_runner=None, clock=time.monotonic):
        self.hedge_factor = (
            hedge_factor if hedge_factor is not None
            else _env_float("CORDA_TPU_HEDGE_FACTOR", 4.0)
        )
        self.hedge_min_s = float(hedge_min_s)
        self.hedge_max_s = max(self.hedge_min_s, float(hedge_max_s))
        self.redispatch_limit = max(0, int(redispatch_limit))
        self.flight_dump_on_quarantine = bool(flight_dump_on_quarantine)
        # canary readback bound: generous enough for a cold kernel build
        # (about a minute of nvcc on the card), but finite: an unbounded
        # collect on a wedged readback would park the probe thread with
        # its _probing key held and strand the ordinal in PROBATION
        # forever, killing readmission for the rest of the process
        self.probe_timeout_s = max(1e-3, float(probe_timeout_s))
        self.quarantine = DeviceQuarantine(
            strikes=strikes, probe_backoff_s=probe_backoff_s,
            probe_backoff_max_s=probe_backoff_max_s, clock=clock,
        )
        # one breaker per ordinal, created on first contact: one sick
        # device must not evict the others from the stripe set
        self._breaker_kwargs = dict(
            threshold=breaker_threshold, backoff_s=breaker_backoff_s,
            backoff_max_s=breaker_backoff_max_s, clock=clock,
        )
        self._breakers: dict[int, CircuitBreaker] = {}
        self._clock = clock
        self._probe_runner = probe_runner
        self._lock = threading.Lock()
        self._probing: set = set()     # probe keys with a runner in flight
        self._canary = None            # lazily built known-answer rows
        self._shapes = None            # ShapeTable from the attached scheduler
        self._device = None            # the attached scheduler's device and tier
        self._tier = None
        self._monitor = None           # the devicemon we subscribed to
        _register_gauges()

    # ---------------------------------------------------------- breakers
    def breaker_for(self, ordinal: int) -> CircuitBreaker:
        """The given ordinal's breaker, created on first use."""
        o = int(ordinal)
        with self._lock:
            br = self._breakers.get(o)
            if br is None:
                br = self._breakers[o] = CircuitBreaker(
                    **self._breaker_kwargs
                )
            return br

    @property
    def breaker(self) -> CircuitBreaker:
        """The default ordinal's breaker (callers of one device read
        ``policy.breaker.state``; on one card the default ordinal is the
        device tier)."""
        from ..observability.devicemon import default_device_ordinal

        return self.breaker_for(default_device_ordinal())

    def breaker_state_mesh(self) -> int:
        """Whole-mesh breaker rollup: OPEN only when EVERY known
        ordinal's breaker is open (the stripe set is empty — the tier is
        down), HALF_OPEN while any ordinal is probing, else CLOSED.
        Reads existing breakers only (no creation side effect — the
        gauge calls this from under the registry lock)."""
        with self._lock:
            breakers = list(self._breakers.values())
        if not breakers:
            return BREAKER_CLOSED
        states = [br.state for br in breakers]
        if all(s == BREAKER_OPEN for s in states):
            return BREAKER_OPEN
        if any(s == BREAKER_HALF_OPEN for s in states):
            return BREAKER_HALF_OPEN
        return BREAKER_CLOSED

    # --------------------------------------------------------- lifecycle
    def attach(self, scheduler) -> None:
        """Bind to the scheduler that consults this policy: pick up its
        shape table (canary pad bucket), subscribe to devicemon health
        events (watchdog evictions become strikes), and become the
        process-visible policy for snapshots/flight dumps."""
        from ..observability.devicemon import devicemon

        self._shapes = getattr(scheduler, "_shapes", None)
        self._device = getattr(scheduler, "device", None)
        self._tier = getattr(scheduler, "tier", None)
        mon = devicemon()
        mon.subscribe(self.on_device_event)
        self._monitor = mon
        register_policy(self)

    def detach(self, scheduler) -> None:
        mon = self._monitor
        if mon is not None:
            mon.unsubscribe(self.on_device_event)
            self._monitor = None
        unregister_policy(self)

    # ----------------------------------------------------------- routing
    def admit_device(self, ordinal: int) -> bool:
        """The per-dispatch gate: False routes the whole batch to host.
        The ordinal's breaker first, then its quarantine."""
        if not self.breaker_for(ordinal).allow_device():
            _metrics().counter("serving.breaker.host_routed").inc()
            return False
        if self.quarantine.blocked(ordinal):
            _metrics().counter("serving.quarantine.host_routed").inc()
            return False
        return True

    def admit_ordinal(self, ordinal: int) -> bool:
        """Counter-free eligibility read for stripe-set membership:
        True while the ordinal's breaker is closed and it is not
        quarantined. ``admit_device`` remains the per-dispatch gate
        that counts host-routes; this one is consulted once per
        placement decision for EVERY ordinal, so it must not inflate
        those counters."""
        return (self.breaker_for(ordinal).allow_device()
                and not self.quarantine.blocked(ordinal))

    def hedge_deadline_s(self, ordinal: int,
                         fallback_ewma_s: float) -> float | None:
        """The in-flight deadline for one dispatched batch: execute-wall
        EWMA × hedge factor, clamped to [hedge_min_s, hedge_max_s].
        Devicemon's per-ordinal EWMA when it is on and has samples, else
        the scheduler's own latency EWMA. None (no hedging) before any
        settle has seeded an EWMA — a cold first dispatch may legally be
        a multi-minute compile, and hedging it would fight the compile
        cache."""
        from ..observability.devicemon import active_devicemon

        ewma = 0.0
        mon = active_devicemon()
        if mon is not None:
            ewma = mon.execute_ewma(ordinal)
        if ewma <= 0.0:
            ewma = max(float(fallback_ewma_s), 0.0)
        if ewma <= 0.0:
            return None
        return min(max(ewma * self.hedge_factor, self.hedge_min_s),
                   self.hedge_max_s)

    # ------------------------------------------------------ feed points
    def on_dispatch_failure(self, ordinal: int) -> None:
        """A device dispatch raised (real or injected): one strike, one
        breaker failure — both against the ordinal the batch was placed
        on."""
        self._strike(ordinal, "dispatch-failure")
        self.breaker_for(ordinal).record_failure()

    def on_hedge_fired(self, ordinal: int) -> None:
        """A batch blew its in-flight deadline: stall evidence — a
        strike, but not yet a breaker failure (the device may still win
        the race; the loss is counted when the host does)."""
        self._strike(ordinal, "hedge-stall")

    def on_hedge_won_host(self, ordinal: int) -> None:
        """The hedge completed on host before the device: a loss toward
        the stalled ordinal's breaker."""
        self.breaker_for(ordinal).record_failure()

    def on_hedge_won_sibling(self, ordinal: int) -> None:
        """A SIBLING chip finished the hedged batch before the original
        device: same per-ordinal evidence as a host win — the loss lands
        on the ORIGINAL ordinal's breaker, while the sibling's own
        clean settle speaks for itself."""
        self.breaker_for(ordinal).record_failure()

    def on_settle_ok(self, ordinal: int) -> None:
        self.quarantine.healthy_settle(ordinal)
        self.breaker_for(ordinal).record_success()

    def on_device_event(self, event: dict) -> None:
        """The devicemon subscription hook: a watchdog ``device.unhealthy``
        eviction is a strike against the flagged ordinal."""
        if event.get("kind") != "device.unhealthy":
            return
        ordinal = event.get("device")
        if isinstance(ordinal, int):
            self._strike(ordinal, f"watchdog:{event.get('reason', '')}")

    def _strike(self, ordinal: int, reason: str) -> None:
        entered = self.quarantine.strike(ordinal, reason)
        if entered and self.flight_dump_on_quarantine:
            self._quarantine_dump(ordinal)

    def _quarantine_dump(self, ordinal: int) -> None:
        """One flight-recorder dump per quarantine episode — the black
        box for the eviction, readable via ``read_flight_dump``. The
        latch lives on the episode, so watchdog re-flags cannot spam
        dumps; a failing dump must never break the strike path."""
        if not self.quarantine.claim_episode_dump(ordinal):
            return
        from ..observability.slo import flight_dump

        try:
            flight_dump(reason=f"device-quarantine:{ordinal}")
        except OSError:
            pass

    # ------------------------------------------------------------ probes
    def maybe_probe(self, now: float | None = None, *,
                    sync: bool = False) -> None:
        """Launch any due canary probe (quarantine readmission and/or
        breaker half-open). Called from the scheduler's hedge thread on
        every wake-up; ``sync=True`` runs the probe inline (tests, and
        fake-clock drives)."""
        if now is None:
            now = self._clock()
        ordinal = self.quarantine.due_probe(now)
        if ordinal is not None:
            self._launch_probe(("quarantine", ordinal), sync)
        with self._lock:
            breakers = list(self._breakers.items())
        for o, br in breakers:
            if br.probe_due(now):
                self._launch_probe(("breaker", o), sync)

    def _launch_probe(self, key: tuple, sync: bool) -> None:
        with self._lock:
            if key in self._probing:
                return
            self._probing.add(key)
        kind, ordinal = key
        if kind == "quarantine":
            _metrics().counter("serving.quarantine.probes").inc()
        else:
            _metrics().counter("serving.breaker.probes").inc()
        if sync:
            self._probe(key)
        else:
            threading.Thread(
                target=self._probe, args=(key,),
                name="serving-canary", daemon=True,
            ).start()

    def _probe(self, key: tuple) -> None:
        kind, ordinal = key
        try:
            ok = self._run_canary(0 if ordinal is None else ordinal)
        except Exception:  # noqa: BLE001  (a canary that raises keeps the
            ok = False     # ordinal out; it settles no caller's rows)
        finally:
            with self._lock:
                self._probing.discard(key)
        if kind == "quarantine":
            self.quarantine.probe_result(ordinal, ok)
        else:
            self.breaker_for(
                0 if ordinal is None else ordinal
            ).probe_result(ok)

    def _canary_rows(self):
        """The known-answer batch: valid signatures plus one tampered —
        a device echoing garbage all-True verdicts must fail the probe,
        not pass it."""
        if self._canary is None:
            from ..crypto import generate_keypair, sign

            kp = generate_keypair()
            rows, expected = [], []
            for i in range(3):
                msg = b"resilience-canary-%d" % i
                rows.append((kp.public, sign(kp.private, msg), msg))
                expected.append(True)
            key, sig, msg = rows[-1]
            rows[-1] = (key, b"\x00" * len(sig), msg)
            expected[-1] = False
            self._canary = (rows, expected)
        return self._canary

    def _run_canary(self, ordinal: int) -> bool:
        runner = self._probe_runner
        if runner is not None:
            return bool(runner(ordinal))
        import contextlib

        import torch

        from ..parallel.mesh import device_for_ordinal
        from ..verifier.batch import dispatch_signature_rows

        rows, expected = self._canary_rows()
        bucket = (
            self._shapes.bucket_for(len(rows))
            if self._shapes is not None else None
        )
        # the canary exercises the ordinal it readmits; an ordinal no mesh
        # names is the attached scheduler's own device
        try:
            device = device_for_ordinal(ordinal)
        except KeyError:
            device = self._device
        pin = (torch.cuda.device(device)
               if device is not None and torch.device(device).type == "cuda"
               else contextlib.nullcontext())
        kw = {} if self._tier is None else {"tier": self._tier}
        with pin:
            pending = dispatch_signature_rows(
                rows, use_device=True, min_bucket=bucket, device=device, **kw,
            )
        # bounded wait on the readback: a probe against a wedged device
        # fails (the backoff doubles) instead of blocking forever
        deadline = time.monotonic() + self.probe_timeout_s
        while not pending.ready():
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.01)
        mask = pending.collect()
        if pending.device_rows != len(rows):
            # rows that failed over to the host prove nothing of the device
            return False
        return [bool(v) for v in mask] == expected

    # ----------------------------------------------------------- surface
    def snapshot(self) -> dict:
        return {
            "enabled": True,
            "hedge": {
                "factor": self.hedge_factor,
                "min_s": self.hedge_min_s,
                "max_s": self.hedge_max_s,
            },
            "quarantine": self.quarantine.snapshot(),
            "breaker": self._breaker_snapshot(),
        }

    def _breaker_snapshot(self) -> dict:
        """Mesh rollup plus per-ordinal detail, with ``state``,
        ``state_name`` and ``threshold`` at the top level as a single
        breaker's snapshot has them, so flight-dump consumers keep
        parsing."""
        with self._lock:
            items = sorted(self._breakers.items())
        state = self.breaker_state_mesh()
        return {
            "state": state,
            "state_name": {
                BREAKER_CLOSED: "closed", BREAKER_OPEN: "open",
                BREAKER_HALF_OPEN: "half-open",
            }[state],
            "threshold": max(1, int(self._breaker_kwargs["threshold"])),
            "per_ordinal": {
                str(o): br.snapshot() for o, br in items
            },
        }


# ------------------------------------------------- process-global surface
#
# The policy attached to the live scheduler is the one snapshots and the
# flight recorder report; gauges read THROUGH this slot (the devicemon /
# serving-gauge pattern) so a shut-down scheduler's policy is never
# pinned by the metric registry.

_active_policy: ResiliencePolicy | None = None
_policy_lock = threading.Lock()


def register_policy(policy: ResiliencePolicy) -> None:
    global _active_policy
    with _policy_lock:
        _active_policy = policy


def unregister_policy(policy: ResiliencePolicy) -> None:
    global _active_policy
    with _policy_lock:
        if _active_policy is policy:
            _active_policy = None


def active_policy() -> ResiliencePolicy | None:
    return _active_policy


def resilience_section() -> dict:
    """The ``resilience`` section of ``monitoring_snapshot()`` and the
    flight recorder: the live policy's state machine view, or a bare
    disabled marker."""
    policy = _active_policy
    if policy is None:
        return {"enabled": False}
    return policy.snapshot()


_gauges_registered = False


def _register_gauges() -> None:
    """``serving.breaker.state`` and ``serving.quarantine.active``, read
    through the active policy; registered with the first policy (the
    registry's package imports the serving layer)."""
    global _gauges_registered
    if _gauges_registered:
        return
    _gauges_registered = True
    m = _metrics()

    def breaker_state():
        # mesh rollup, and deliberately NOT the `breaker` property: a
        # gauge read must not create breaker slots as a side effect
        p = _active_policy
        return p.breaker_state_mesh() if p is not None else 0

    def quarantine_active():
        p = _active_policy
        return p.quarantine.active_count() if p is not None else 0

    m.gauge("serving.breaker.state", breaker_state)
    m.gauge("serving.quarantine.active", quarantine_active)
