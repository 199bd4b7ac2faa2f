"""Crash/restart orchestration for seeded chaos runs (counterpart of
corda_tpu/faultinject/chaos.py, copied whole).

Executes a plan's ``CrashEvent`` schedule against an
``InMemoryMessagingNetwork``: registered restartable components (a notary
replica, a verifier worker, a whole SMM) are stopped at their scheduled
pump round and restarted ``down_rounds`` later. The orchestrator hooks the
network's pump loop, so the schedule is deterministic under manual
pumping and round-approximate under a background pump thread.

A component registers as ``(stop_fn, restart_fn)``; ``restart_fn`` must
rebuild the component *from its durable state* (that is the property the
chaos soak asserts — a restarted replica rejoins from disk, not from a
warm copy)."""

from __future__ import annotations

import logging
import threading

from .plan import FaultInjector

logger = logging.getLogger(__name__)


class ChaosOrchestrator:
    """Drives a plan's crash schedule off the network's pump rounds."""

    def __init__(self, network, injector: FaultInjector):
        self._injector = injector
        self._lock = threading.Lock()
        self._restartable: dict[str, tuple] = {}   # name -> (stop, restart)
        self._pending_restart: dict[int, list[str]] = {}
        self._fired: set[int] = set()
        self.down: set[str] = set()
        network.add_pump_hook(self.on_round)

    def register(self, name: str, stop_fn, restart_fn=None) -> None:
        with self._lock:
            self._restartable[name] = (stop_fn, restart_fn)

    def on_round(self, rnd: int) -> None:
        crashes = []
        restarts = []
        with self._lock:
            for i, ev in enumerate(self._injector.plan.crashes):
                if ev.at_round <= rnd and i not in self._fired:
                    if ev.node not in self._restartable:
                        # not registered yet (component still starting):
                        # leave the event pending so it fires on a later
                        # round instead of being silently consumed
                        continue
                    self._fired.add(i)
                    crashes.append(ev)
            for due in [r for r in self._pending_restart if r <= rnd]:
                restarts.extend(self._pending_restart.pop(due))
        for ev in crashes:
            stop_fn, restart_fn = self._restartable[ev.node]
            try:
                stop_fn()
            except Exception:
                logger.exception("chaos: stopping %s failed", ev.node)
            self._injector._record("crash", ev.node, "", rnd)
            with self._lock:
                self.down.add(ev.node)
                if ev.down_rounds > 0 and restart_fn is not None:
                    self._pending_restart.setdefault(
                        rnd + ev.down_rounds, []
                    ).append(ev.node)
        for name in restarts:
            _stop, restart_fn = self._restartable[name]
            try:
                restart_fn()
            except Exception:
                logger.exception("chaos: restarting %s failed", name)
                continue
            self._injector._record("restart", name, "", rnd)
            with self._lock:
                self.down.discard(name)
