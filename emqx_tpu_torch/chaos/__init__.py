"""Chaos seams of the port: the device fault injector (faults.py) that
plugs into the `fault_injector` seam of the Router and its device
table, driving the dispatch engine's failover and circuit breaker.

The reference's scenario engine, its replica-drift and disk-fault
injectors are not ported (they need the cluster and durable-storage
layers the port does not have)."""

from .faults import (  # noqa: F401
    LEGS,
    SHARD_PROBE_LEG,
    DeviceDeadlineExceeded,
    DeviceFaultInjector,
    DeviceLinkError,
    DeviceLostError,
    TransientDeviceError,
    is_device_fault,
)
