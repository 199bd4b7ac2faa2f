"""Deterministic fault injection (see plan.py for the design contract;
chaos.py drives a plan's crash schedule over the in-memory network's pump
rounds, e.g. a Raft replica stopped and rebuilt from its SQLite file)."""

from .chaos import ChaosOrchestrator
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
    "ChaosOrchestrator",
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
