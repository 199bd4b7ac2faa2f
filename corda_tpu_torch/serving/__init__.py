"""The device scheduler in front of the verify kernels."""

from .scheduler import (
    BULK,
    INTERACTIVE,
    SERVICE,
    DeadlineExceededError,
    DeviceScheduler,
    FuturePending,
    RowResult,
    SchedulerClosedError,
    SchedulerSaturatedError,
    ServingError,
    configure_scheduler,
    device_scheduler,
    shutdown_scheduler,
)
from .shapes import ShapeTable, shape_table

__all__ = [
    "BULK",
    "INTERACTIVE",
    "SERVICE",
    "DeadlineExceededError",
    "DeviceScheduler",
    "FuturePending",
    "RowResult",
    "SchedulerClosedError",
    "SchedulerSaturatedError",
    "ServingError",
    "ShapeTable",
    "configure_scheduler",
    "device_scheduler",
    "shape_table",
    "shutdown_scheduler",
]
