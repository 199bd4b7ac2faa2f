"""Scheduler: time-triggered state activities (the port's copy of
corda_tpu/node/scheduler.py, import root changed).

Parity with the reference's node/.../services/events/
``NodeSchedulerService`` (NodeSchedulerService.kt:55-170 — earliest-due
scheduled state wins; rescheduled on vault changes) and
``ScheduledActivityObserver`` (watches vault updates for
``SchedulableState`` outputs). Virtual-clock friendly: inject a clock and
call ``pump()`` for deterministic tests (the reference's TestClock idiom).
"""

from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from typing import Protocol, runtime_checkable

from corda_tpu_torch.ledger import StateRef


@runtime_checkable
class SchedulableState(Protocol):
    """(reference: core SchedulableState.nextScheduledActivity)."""

    def next_scheduled_activity(self, ref: StateRef) -> "ScheduledActivity | None":
        ...


@dataclasses.dataclass(frozen=True, order=True)
class ScheduledActivity:
    """A flow to launch at a time (reference: ScheduledActivity — here the
    flow is named by class path + args so it survives restarts)."""

    scheduled_at: float  # unix seconds
    flow_class_path: str = dataclasses.field(compare=False)
    flow_args: tuple = dataclasses.field(default=(), compare=False)


def make_scheduled_flow_starter(smm, party_name):
    """The start-callable a scheduler drives: load the flow class, start
    it, and LOG failures — nothing awaits a scheduler-started flow's
    future, so without the callback an error would vanish silently.
    Shared by the production node container and the mocknet tier."""
    import logging

    from corda_tpu_torch.flows.api import load_class

    logger = logging.getLogger(__name__)

    def start(flow_class_path: str, args):
        handle = smm.start_flow(load_class(flow_class_path)(*args))

        def _report(fut):
            if fut.cancelled():
                return  # node shutdown cancels in-flight flows
            exc = fut.exception()
            if exc is not None:
                logger.error(
                    "%s: scheduled flow %s%r failed: %r",
                    party_name, flow_class_path, tuple(args), exc,
                )

        handle.result.add_done_callback(_report)
        return handle

    return start


class NodeSchedulerService:
    """Earliest-deadline scheduler over SchedulableState outputs."""

    def __init__(self, start_flow, clock=time.time):
        self._start_flow = start_flow  # callable(flow_class_path, args)
        self._clock = clock
        self._lock = threading.Lock()
        self._heap: list[tuple[float, str, ScheduledActivity, StateRef]] = []
        # pending-entry count per key; a cancel only registers when the
        # key still has live heap entries (else the tombstone would leak
        # one set entry per consumed state for the node's lifetime)
        self._pending: dict[str, int] = {}
        self._cancelled: set[str] = set()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    def schedule_state_activity(self, ref: StateRef, activity: ScheduledActivity) -> None:
        with self._lock:
            key = str(ref)
            self._cancelled.discard(key)
            self._pending[key] = self._pending.get(key, 0) + 1
            heapq.heappush(self._heap, (activity.scheduled_at, key, activity, ref))

    def unschedule_state_activity(self, ref: StateRef) -> None:
        with self._lock:
            key = str(ref)
            if self._pending.get(key):
                self._cancelled.add(key)

    def observe_vault(self, vault) -> None:
        """Wire to a vault update feed (reference:
        ScheduledActivityObserver): produced SchedulableStates get
        scheduled; consumed ones unscheduled. The subscription snapshot
        re-derives schedules for states already in the vault — a restarted
        node must fire activities its previous life recorded (reference:
        NodeSchedulerService.start's relaxed re-scan on boot)."""

        def on_update(update):
            for sr in update.consumed:
                self.unschedule_state_activity(sr.ref)
            for sr in update.produced:
                self._maybe_schedule(sr)

        snapshot = vault.track(on_update)
        for sr in getattr(snapshot, "states", ()):
            self._maybe_schedule(sr)

    def _maybe_schedule(self, sr) -> None:
        data = sr.state.data
        if isinstance(data, SchedulableState):
            activity = data.next_scheduled_activity(sr.ref)
            if activity is not None:
                self.schedule_state_activity(sr.ref, activity)

    def pump(self) -> int:
        """Run every activity due now; returns how many fired (deterministic
        test path — production uses start())."""
        fired = 0
        now = self._clock()
        while True:
            with self._lock:
                if not self._heap or self._heap[0][0] > now:
                    return fired
                _, key, activity, ref = heapq.heappop(self._heap)
                n = self._pending.get(key, 1) - 1
                if n > 0:
                    self._pending[key] = n
                else:
                    self._pending.pop(key, None)
                if key in self._cancelled:
                    if n <= 0:
                        self._cancelled.discard(key)
                    continue
            try:
                self._start_flow(activity.flow_class_path, activity.flow_args)
                fired += 1
            except Exception:
                # a bad flow path / mismatched args (cordapp bug, version
                # skew) must cost ONE activity, not the scheduler thread —
                # an escaped exception here would kill the loop and
                # silently stop every future activity on the node. Failed
                # starts do NOT count toward `fired` (callers pump until
                # n activities fire — overcounting would end them early
                # while the activity was actually lost).
                import logging

                logging.getLogger(__name__).exception(
                    "failed to start scheduled flow %s%r",
                    activity.flow_class_path, tuple(activity.flow_args),
                )

    def start(self, poll_s: float = 0.05) -> None:
        def loop():
            while not self._stop.wait(poll_s):
                self.pump()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="scheduler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
