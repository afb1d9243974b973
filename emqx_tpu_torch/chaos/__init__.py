"""Chaos seams of the port: the device fault injector (faults.py) that
plugs into the `fault_injector` seam of the Router and its device
table, driving the dispatch engine's failover and circuit breaker, and
the disk fault injector that plugs into the durable tier's ds/diskio
seam, driving a DS shard's fail-stop and recovery.

The reference's scenario engine and its replica-drift injector are not
ported (they need the cluster layer the port does not have)."""

from .faults import (  # noqa: F401
    CRASH_POINTS,
    DISK_LEGS,
    LEGS,
    SHARD_PROBE_LEG,
    DeviceDeadlineExceeded,
    DeviceFaultInjector,
    DeviceLinkError,
    DeviceLostError,
    DiskFaultError,
    DiskFaultInjector,
    DiskFullError,
    DiskIOError,
    FsyncFailedError,
    SimulatedCrash,
    TransientDeviceError,
    is_device_fault,
)
