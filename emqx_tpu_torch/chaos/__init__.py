"""Chaos layer of the port: the scenario engine and its fault seams.

  * engine.py: the session fleet, the Zipf storm and `ChaosEngine`,
    which runs the catalog under a live storm while the sentinel,
    alarms and flight recorder judge the outcome; `run_soak` and
    `python -m emqx_tpu_torch.chaos` drive it on the card, and
    `ChaosEngine.standalone(mesh=...)` on a sharded table;
  * scenarios.py: the catalog (storm baseline, row and slot
    corruption, device loss and flap, chip loss and flap and reshard
    churn on a mesh, torn WAL, disk full, fsync failure, broker
    restart, disconnect/takeover), each with its contract;
  * faults.py: the device fault injector that plugs into the
    `fault_injector` seam of the Router and its device table, driving
    the dispatch engine's failover, circuit breaker and shard breaker,
    and the disk fault injector that plugs into the durable tier's
    ds/diskio seam;
  * boxcal.py: the box-throughput scale of the scenarios' deadlines.

The cluster catalog and the replica-drift injector need the cluster
layer (ROADMAP Queue 1 item 8b) and are not ported."""

from .engine import (  # noqa: F401
    ChaosEngine,
    ContractViolation,
    SessionFleet,
    ZipfTopics,
    run_soak,
)
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
from .scenarios import (  # noqa: F401
    CATALOG,
    Check,
    Scenario,
    ScenarioResult,
    scenario_catalog,
)
