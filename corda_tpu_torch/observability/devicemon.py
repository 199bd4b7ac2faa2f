"""Per-device telemetry registry + straggler/stall watchdog (counterpart of
corda_tpu/observability/devicemon.py: the module only).

Every process-global telemetry layer (request tracing, the serving
scheduler's counters) is implicitly device-0-centric. A scheduler that
stripes work over several cards needs per-ordinal in-flight depth, health
and throughput attribution. This module is that substrate: one slot per
``torch.cuda`` ordinal, fed through ``record_dispatch`` /
``record_settle`` / ``record_sharded`` and ``DispatchProbe``.

The feeds (the scheduler's dispatch/settle path, the wavefront's id sweeps,
the mesh's sharded dispatches) and the watchdog's consumer, the serving
resilience policy, come with ROADMAP.md Queue 1 step 6: until then nothing
of the port records into the monitor, and it reports what a caller feeds it.

Design contract, in order:

1. **Off by default, near-free when off.** Every feed point calls
   ``active_devicemon()`` — two attribute reads returning None — and
   skips all accounting. No metric is created, no thread is started and
   nothing calls ``torch.cuda`` (so no CUDA context is created) while the
   monitor is off.
2. **Deviceless fallback.** Slot count comes from ``torch.cuda`` at
   enable time, one slot per visible ordinal; with no CUDA backend (or a
   broken one) it degrades to one slot (ordinal 0) instead of raising —
   telemetry must never take down the path it observes. Memory occupancy
   rides best-effort ``torch.cuda.memory_stats(i)`` (absent without a
   card: omitted, never 0).
3. **Attribution is ground truth.** A feed records the rows and padded
   lanes of each dispatch against the ordinal that ran it; a sharded batch
   splits its lanes per device in contiguous equal shards. Per-ordinal sums
   therefore reconcile exactly against the feeder's global counters.

The **watchdog** (``DeviceWatchdog``) turns the slots into health: a
device whose execute-wall EWMA deviates from the mesh median by more
than ``straggler_factor`` is a *straggler*; a device with in-flight work
and no completion heartbeat for ``stall_s`` is *stalled*. Transitions
are edge-triggered ``device.unhealthy`` / ``device.recovered`` events
(flagged exactly once, cleared on recovery) in a bounded ring the flight
recorder (``slo.py``) consults; ``node_metrics()`` counts transitions as
``device.unhealthy_events``.

Surfaces: a ``devices`` section in ``monitoring_snapshot()`` and
Prometheus ``device.*`` families with a ``device`` label appended to
``metrics_text()``.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque


class _DeviceSlot:
    """Accumulated telemetry for one device ordinal. Mutated only under
    the owning monitor's lock."""

    __slots__ = ("ordinal", "inflight", "dispatches", "settles", "rows",
                 "padded_rows", "failures", "exec_ewma_s",
                 "last_dispatch_t", "last_settle_t", "unhealthy")

    def __init__(self, ordinal: int):
        self.ordinal = ordinal
        self.inflight = 0         # tracked batches dispatched, not settled
        self.dispatches = 0       # device dispatches attributed here
        self.settles = 0          # completions (ok or failed)
        self.rows = 0             # real rows attributed to this ordinal
        self.padded_rows = 0      # padded lanes the device actually ran
        self.failures = 0         # failed dispatches/settles
        self.exec_ewma_s = 0.0    # execute-wall EWMA (dispatch→settle)
        self.last_dispatch_t: float | None = None
        self.last_settle_t: float | None = None   # the completion heartbeat
        self.unhealthy = ""       # "" = healthy, else the watchdog's reason


class DispatchProbe:
    """Pairs one ``record_dispatch`` with exactly one settle — the
    in-flight bookkeeping handle for feed points whose dispatch and
    collect live in different scopes (the wavefront pipeline's id
    sweeps). ``settle()`` is idempotent; an aborted window settles
    ``ok=False`` so the in-flight depth can never leak."""

    __slots__ = ("_monitor", "_ordinal", "_t0", "_done")

    def __init__(self, monitor: "DeviceMonitor", ordinal: int, rows: int,
                 padded_lanes: int = 0):
        self._monitor = monitor
        self._ordinal = ordinal
        self._t0 = monitor._clock()
        self._done = False
        monitor.record_dispatch(ordinal, rows=rows,
                                padded_lanes=padded_lanes)

    def settle(self, ok: bool = True) -> None:
        if self._done:
            return
        self._done = True
        self._monitor.record_settle(
            self._ordinal, self._monitor._clock() - self._t0, ok=ok
        )


class DeviceMonitor:
    """Process-global per-device telemetry registry (construct directly
    only in tests; production code shares ``devicemon()``)."""

    def __init__(self, *, n_devices: int | None = None,
                 enabled: bool | None = None, clock=time.monotonic,
                 event_ring: int = 256):
        if enabled is None:
            enabled = os.environ.get(
                "CORDA_TPU_DEVICEMON", ""
            ).strip().lower() in ("1", "true", "on", "yes")
        self._enabled = bool(enabled)
        self._clock = clock
        self._lock = threading.Lock()
        self._fixed_n = n_devices
        self._slots: dict[int, _DeviceSlot] = {}
        self._sized = False
        self._platform = ""
        self._cuda_ordinals: set[int] = set()
        self.events: deque = deque(maxlen=max(16, event_ring))
        # health-event subscribers (the serving resilience policy turns
        # device.unhealthy into quarantine strikes); notified OUTSIDE the
        # lock, exceptions swallowed — a listener must never break the
        # watchdog sweep that fed it
        self._listeners: list = []

    # ------------------------------------------------------------- config
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def reset(self) -> None:
        """Drop all accumulated slots and events (slot layout re-derives
        on the next record/snapshot)."""
        with self._lock:
            self._slots.clear()
            self._sized = False
            self._cuda_ordinals = set()
            self.events.clear()

    # --------------------------------------------------------- slot layout
    def _ensure_sized_locked(self) -> None:
        """Lay out one slot per device ordinal. ``torch.cuda`` is the
        source of truth when a card is reachable; the deviceless fallback
        is ONE slot (ordinal 0) — telemetry must work, degraded, on a box
        with no working accelerator stack at all."""
        if self._sized:
            return
        self._sized = True
        ordinals: list[int] = []
        if self._fixed_n is not None:
            ordinals = list(range(self._fixed_n))
        else:
            try:
                import torch

                n = torch.cuda.device_count() if torch.cuda.is_available() else 0
                if n < 1:
                    raise RuntimeError("no CUDA device")
                self._platform = "cuda"
                ordinals = list(range(n))
                self._cuda_ordinals = set(ordinals)
            except Exception:
                ordinals = [0]
        for o in ordinals:
            self._slots.setdefault(o, _DeviceSlot(o))

    def _slot_locked(self, ordinal: int) -> _DeviceSlot:
        self._ensure_sized_locked()
        slot = self._slots.get(ordinal)
        if slot is None:  # defensive: an ordinal outside the layout
            slot = self._slots[ordinal] = _DeviceSlot(ordinal)
        return slot

    @property
    def n_devices(self) -> int:
        with self._lock:
            self._ensure_sized_locked()
            return len(self._slots)

    def ordinals(self) -> list[int]:
        with self._lock:
            self._ensure_sized_locked()
            return sorted(self._slots)

    # ------------------------------------------------------------ feeding
    def record_dispatch(self, ordinal: int, *, rows: int,
                        padded_lanes: int = 0,
                        track_inflight: bool = True) -> None:
        """One device dispatch attributed to ``ordinal``: ``rows`` real
        rows over ``padded_lanes`` padded kernel lanes. With
        ``track_inflight`` (the scheduler/wavefront shape) the batch
        counts toward the ordinal's in-flight depth until its
        ``record_settle``; sharded mesh dispatches (no per-device settle
        hook) pass False — dispatch-only counting."""
        now = self._clock()
        with self._lock:
            slot = self._slot_locked(ordinal)
            slot.dispatches += 1
            slot.rows += max(int(rows), 0)
            slot.padded_rows += max(int(padded_lanes), int(rows), 0)
            slot.last_dispatch_t = now
            if track_inflight:
                slot.inflight += 1

    def record_sharded_dispatch(self, ordinals: list[int], *, rows: int,
                                padded_lanes: int) -> None:
        """Attribute one batch sharded over ``ordinals`` (the mesh
        verifier's ``NamedSharding`` layout: contiguous lane shards,
        real rows occupying the leading lanes). The LAST ordinal takes
        any non-divisible remainder so per-ordinal sums always equal the
        caller's totals — attribution must reconcile exactly."""
        if not ordinals:
            return
        n_ord = len(ordinals)
        rows = max(int(rows), 0)
        padded = max(int(padded_lanes), rows, 1)
        base = padded // n_ord
        for i, o in enumerate(ordinals):
            lanes = base if i < n_ord - 1 else padded - base * (n_ord - 1)
            real = min(max(rows - i * base, 0), lanes)
            self.record_dispatch(
                o, rows=real, padded_lanes=lanes, track_inflight=False
            )

    def record_settle(self, ordinal: int, wall_s: float,
                      *, ok: bool = True, ewma: bool = True,
                      track_inflight: bool = True) -> None:
        """One tracked batch completed on ``ordinal`` after ``wall_s``
        (dispatch→settle wall): updates the execute EWMA, the completion
        heartbeat, and releases the in-flight count. ``ewma=False``
        records the heartbeat/in-flight release WITHOUT folding the wall
        into the EWMA — a hedge-lost late readback's stall-inflated wall
        would otherwise grow the very hedge deadline (EWMA × factor)
        that exists to catch this device's stalls.
        ``track_inflight=False`` pairs with an untracked dispatch (the
        sharded-attribution path): the settle must not release an
        in-flight slot some OTHER tracked batch on this ordinal owns."""
        now = self._clock()
        with self._lock:
            slot = self._slot_locked(ordinal)
            slot.settles += 1
            if track_inflight:
                slot.inflight = max(0, slot.inflight - 1)
            slot.last_settle_t = now
            if not ok:
                slot.failures += 1
            elif ewma:
                w = max(float(wall_s), 0.0)
                slot.exec_ewma_s = (
                    w if slot.exec_ewma_s == 0.0
                    else 0.7 * slot.exec_ewma_s + 0.3 * w
                )

    def record_sharded_settle(self, ordinals: list[int], wall_s: float,
                              *, ok: bool = True,
                              ewma: bool = True) -> None:
        """Settle counterpart of :meth:`record_sharded_dispatch`: one
        mega-batch that was sharded over ``ordinals`` completed after
        ``wall_s``. Every shard shares the batch's wall (the collective
        synchronizes the mesh, so per-shard walls are indistinguishable
        from the host) and none touches the in-flight count — the
        sharded dispatch never incremented it. Keeps per-ordinal
        dispatches == settles reconciling exactly under mega-batching."""
        for o in ordinals:
            self.record_settle(
                int(o), wall_s, ok=ok, ewma=ewma, track_inflight=False
            )

    def record_failure(self, ordinal: int) -> None:
        """A dispatch that never reached the device (failover before
        enqueue) — counted against the ordinal it was destined for."""
        with self._lock:
            self._slot_locked(ordinal).failures += 1

    def probe(self, ordinal: int, rows: int,
              padded_lanes: int = 0) -> DispatchProbe:
        return DispatchProbe(self, ordinal, rows, padded_lanes)

    # ----------------------------------------------------- event listeners
    def subscribe(self, fn) -> None:
        """Register a health-event listener: called once per edge-
        triggered ``device.unhealthy`` / ``device.recovered`` event dict,
        outside the monitor lock, on the thread that ran the watchdog
        sweep. Idempotent per callable."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def unsubscribe(self, fn) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def _notify(self, events: list) -> None:
        """Fan events out to subscribers — lock NOT held (a listener may
        take its own locks, dispatch probes, or write a flight dump)."""
        for fn in list(self._listeners):
            for event in events:
                try:
                    fn(event)
                except Exception:
                    pass

    # ------------------------------------------------------------- health
    def execute_ewma(self, ordinal: int) -> float:
        """The ordinal's dispatch→settle wall EWMA (0.0 before any ok
        settle) — the resilience policy's hedge-deadline input."""
        with self._lock:
            slot = self._slots.get(ordinal)
            return slot.exec_ewma_s if slot is not None else 0.0

    def unhealthy_ordinals(self) -> list[int]:
        """The ordinals currently flagged by the watchdog — the read the
        future mesh scheduler consults before striping a batch."""
        with self._lock:
            return sorted(
                o for o, s in self._slots.items() if s.unhealthy
            )

    def _mark_locked(self, slot: _DeviceSlot, reason: str,
                     now: float) -> list[dict]:
        """Edge-triggered health transition; returns events to emit
        (appended under the lock, counted outside it)."""
        emitted: list[dict] = []
        if reason and not slot.unhealthy:
            slot.unhealthy = reason
            emitted.append({
                "t": now, "device": slot.ordinal,
                "kind": "device.unhealthy", "reason": reason,
            })
        elif not reason and slot.unhealthy:
            slot.unhealthy = ""
            emitted.append({
                "t": now, "device": slot.ordinal,
                "kind": "device.recovered", "reason": "",
            })
        for e in emitted:
            self.events.append(e)
        return emitted

    # ----------------------------------------------------------- snapshot
    def _hbm_stats(self, ordinal: int) -> dict:
        """Best-effort ``torch.cuda.memory_stats(ordinal)``: present on a
        card (bytes PyTorch's allocator holds for tensors, and the card's
        total memory), absent without one — then the keys are OMITTED,
        never reported as 0."""
        if ordinal not in self._cuda_ordinals:
            return {}
        try:
            import torch

            raw = torch.cuda.memory_stats(ordinal)
            stats = {
                "bytes_in_use": raw.get("allocated_bytes.all.current", 0),
                "bytes_limit": torch.cuda.get_device_properties(ordinal).total_memory,
            }
        except Exception:
            return {}
        if not isinstance(stats, dict):
            return {}
        out = {}
        if isinstance(stats.get("bytes_in_use"), (int, float)):
            out["hbm_bytes_in_use"] = int(stats["bytes_in_use"])
        if isinstance(stats.get("bytes_limit"), (int, float)):
            out["hbm_bytes_limit"] = int(stats["bytes_limit"])
        return out

    def snapshot(self) -> dict:
        """The full per-ordinal accounting, JSON-shaped — the ``devices``
        section of ``monitoring_snapshot()`` and the flight recorder's
        device-state line."""
        now = self._clock()
        with self._lock:
            self._ensure_sized_locked()
            slots = [
                (o, s, {k: getattr(s, k) for k in _DeviceSlot.__slots__})
                for o, s in sorted(self._slots.items())
            ]
            events = list(self.events)
        devices: dict = {}
        for ordinal, _slot, vals in slots:
            entry = {
                "ordinal": ordinal,
                "inflight": vals["inflight"],
                "dispatches": vals["dispatches"],
                "settles": vals["settles"],
                "rows": vals["rows"],
                "padded_rows": vals["padded_rows"],
                "failures": vals["failures"],
                "execute_ewma_s": round(vals["exec_ewma_s"], 6),
                "fill_ratio": round(
                    vals["rows"] / vals["padded_rows"], 4
                ) if vals["padded_rows"] else 1.0,
                "unhealthy": vals["unhealthy"],
            }
            if vals["last_settle_t"] is not None:
                entry["heartbeat_age_s"] = round(
                    max(now - vals["last_settle_t"], 0.0), 6
                )
            if vals["last_dispatch_t"] is not None:
                entry["last_dispatch_age_s"] = round(
                    max(now - vals["last_dispatch_t"], 0.0), 6
                )
            entry.update(self._hbm_stats(ordinal))
            devices[str(ordinal)] = entry
        return {
            "enabled": self._enabled,
            "n_devices": len(devices),
            "platform": self._platform,
            "devices": devices,
            "unhealthy": sorted(
                o for o, s, v in slots if v["unhealthy"]
            ),
            "events": events,
        }

    # --------------------------------------------------------- exposition
    def prometheus_lines(self) -> list[str]:
        """``device.*`` families with a ``device`` label, Prometheus text
        0.0.4 — appended to ``metrics_text()`` while the monitor is on."""
        from corda_tpu_torch.observability.exposition import escape_label_value

        snap = self.snapshot()
        counters = ("dispatches", "settles", "rows", "padded_rows",
                    "failures")
        gauges = ("inflight", "execute_ewma_s", "fill_ratio",
                  "heartbeat_age_s", "hbm_bytes_in_use",
                  "hbm_bytes_limit")
        lines: list[str] = []
        for key in counters:
            lines.append(f"# TYPE cordatpu_device_{key} counter")
            for o, e in sorted(snap["devices"].items()):
                dev = escape_label_value(o)
                lines.append(
                    f'cordatpu_device_{key}_total{{device="{dev}"}} {e[key]}'
                )
        for key in gauges:
            rows = [
                (o, e[key]) for o, e in sorted(snap["devices"].items())
                if key in e
            ]
            if not rows:
                continue
            lines.append(f"# TYPE cordatpu_device_{key} gauge")
            for o, v in rows:
                lines.append(
                    f'cordatpu_device_{key}'
                    f'{{device="{escape_label_value(o)}"}} {v}'
                )
        lines.append("# TYPE cordatpu_device_unhealthy gauge")
        for o, e in sorted(snap["devices"].items()):
            flag = 1 if e["unhealthy"] else 0
            lines.append(
                f'cordatpu_device_unhealthy'
                f'{{device="{escape_label_value(o)}"}} {flag}'
            )
        return lines


class DeviceWatchdog:
    """Periodic health evaluation over a DeviceMonitor's slots.

    Two edge-triggered rules, both computed from the slots alone so a
    test can drive them with a fake clock and ``check_once``:

    - **straggler**: among ordinals with ≥ ``min_settles`` completions,
      an execute-wall EWMA above ``straggler_factor`` × the mesh median
      (needs ≥ 2 participating ordinals — a 1-device mesh has no peers
      to deviate from);
    - **stall**: in-flight work but no activity (dispatch or settle
      heartbeat) for ``stall_s``.

    A flagged device raises ONE ``device.unhealthy`` event (and one
    ``device.unhealthy_events`` count); recovery clears the flag with a
    ``device.recovered`` event. ``start()`` runs the evaluation on a
    daemon thread — created only on explicit opt-in, never by default.
    """

    def __init__(self, monitor: DeviceMonitor, *, interval_s: float = 1.0,
                 straggler_factor: float = 3.0, min_settles: int = 3,
                 stall_s: float = 5.0):
        self.monitor = monitor
        self.interval_s = max(0.05, float(interval_s))
        self.straggler_factor = float(straggler_factor)
        self.min_settles = int(min_settles)
        self.stall_s = float(stall_s)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def check_once(self, now: float | None = None) -> list[dict]:
        """One evaluation sweep; returns the health-transition events it
        emitted (empty when nothing changed state)."""
        mon = self.monitor
        if now is None:
            now = mon._clock()
        emitted: list[dict] = []
        with mon._lock:
            mon._ensure_sized_locked()
            slots = list(mon._slots.values())
            ewmas = sorted(
                s.exec_ewma_s for s in slots
                if s.settles >= self.min_settles and s.exec_ewma_s > 0
            )
            # LOWER-middle median: with 2 participants the upper middle
            # IS the straggler's own EWMA (nothing can exceed factor ×
            # itself — detection would be dead on a 2-chip mesh), and on
            # an even mesh where half straggle the upper middle hides
            # them; biasing low keeps the comparison against the healthy
            # pack
            median = (
                ewmas[(len(ewmas) - 1) // 2] if len(ewmas) >= 2 else None
            )
            for s in slots:
                reason = ""
                last = max(
                    (t for t in (s.last_dispatch_t, s.last_settle_t)
                     if t is not None),
                    default=None,
                )
                if (s.inflight > 0 and last is not None
                        and now - last > self.stall_s):
                    reason = (
                        f"stalled: {s.inflight} in flight, no heartbeat "
                        f"for {now - last:.3f}s"
                    )
                elif (median is not None and median > 0
                        and s.settles >= self.min_settles
                        and s.exec_ewma_s
                        > self.straggler_factor * median):
                    reason = (
                        f"straggler: execute EWMA {s.exec_ewma_s:.6f}s vs "
                        f"mesh median {median:.6f}s"
                    )
                emitted.extend(mon._mark_locked(s, reason, now))
        if emitted:
            from corda_tpu_torch.node.monitoring import node_metrics

            unhealthy = sum(
                1 for e in emitted if e["kind"] == "device.unhealthy"
            )
            if unhealthy:
                node_metrics().counter(
                    "device.unhealthy_events"
                ).inc(unhealthy)
            # subscription hook (outside the monitor lock): the serving
            # resilience policy turns evictions into quarantine strikes
            mon._notify(emitted)
        return emitted

    # ----------------------------------------------------------- lifecycle
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="devicemon-watchdog", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.check_once()
            except Exception:
                pass  # the watchdog must never kill itself on a bad read

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None


# ------------------------------------------------- process-global instance

_global = DeviceMonitor()
_watchdog: DeviceWatchdog | None = None
_watchdog_lock = threading.Lock()


def devicemon() -> DeviceMonitor:
    return _global


def active_devicemon() -> DeviceMonitor | None:
    """The hot-path check every feed point performs: the process monitor
    when telemetry is ON, else None. Two attribute reads — the
    disabled-by-default overhead contract."""
    m = _global
    return m if m._enabled else None


def configure_devicemon(*, enabled: bool | None = None, reset: bool = False,
                        watchdog: bool | None = None,
                        **watchdog_kwargs) -> DeviceMonitor:
    """The on/off + reset knob (docs/OBSERVABILITY.md §Device telemetry);
    also settable at process start via ``CORDA_TPU_DEVICEMON=1``.
    ``watchdog=True`` starts the background health thread (stopped and
    discarded with ``watchdog=False``); ``watchdog_kwargs`` forward to
    ``DeviceWatchdog`` (interval_s, straggler_factor, stall_s, …)."""
    global _watchdog
    if reset:
        _global.reset()
    if enabled is not None:
        if enabled:
            _global.enable()
        else:
            _global.disable()
    if watchdog is not None:
        with _watchdog_lock:
            if _watchdog is not None:
                _watchdog.stop()
                _watchdog = None
            if watchdog:
                _watchdog = DeviceWatchdog(_global, **watchdog_kwargs)
                _watchdog.start()
    return _global


def device_watchdog() -> DeviceWatchdog | None:
    return _watchdog


def devices_section() -> dict:
    """The ``devices`` section of ``monitoring_snapshot()``: the full
    per-ordinal snapshot while the monitor is on, a bare disabled marker
    (no slots laid out, no ``torch.cuda`` call) while it is off."""
    m = _global
    if not m._enabled:
        return {"enabled": False}
    return m.snapshot()


_default_ordinal: int | None = None


def default_device_ordinal() -> int:
    """The ordinal single-card dispatch paths run on — PyTorch's current
    CUDA device, cached once (0 on any failure). Callers invoke this only
    AFTER a device dispatch, so it never initializes a CUDA context that
    plain host routing would have left untouched."""
    global _default_ordinal
    if _default_ordinal is None:
        try:
            import torch

            _default_ordinal = int(torch.cuda.current_device())
        except Exception:
            _default_ordinal = 0
    return _default_ordinal
