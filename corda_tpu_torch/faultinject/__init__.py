"""Deterministic fault injection (see plan.py for the design contract).

The reference's chaos orchestrator (``faultinject/chaos.py``) is not ported
yet: it drives crash schedules over durable nodes (ROADMAP.md, Queue 1
step 4b)."""

from .plan import (
    CrashEvent,
    DeliveryVerdict,
    FaultInjector,
    FaultPlan,
    InjectedCrash,
    InjectedEvent,
    InjectedFault,
    Partition,
    active,
    check_site,
    clear,
    crash_point,
    install,
    truncate_wal_tail,
)

__all__ = [
    "CrashEvent",
    "DeliveryVerdict",
    "FaultInjector",
    "FaultPlan",
    "InjectedCrash",
    "InjectedEvent",
    "InjectedFault",
    "Partition",
    "active",
    "check_site",
    "clear",
    "crash_point",
    "install",
    "truncate_wal_tail",
]
