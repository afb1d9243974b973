"""Device fault seam — the injectable error/latency layer at the card's
boundary (counterpart of the device half of emqx_tpu/chaos/faults.py).

Everything the broker asks of the card funnels through five legs:
`Router.match_filters_begin` (encode + kernel launch),
`match_filters_finish` (device->host fetch), `resolve_fanout_begin` /
`resolve_fanout_finish` (the dedup/max-QoS plan kernel, K5), and the
device-table `sync` (the fused delta sync or the full upload, on
`DeviceTable` and `ShardedDeviceTable` alike). Each leg carries a
`fault_injector` None-seam (one attribute read when absent), and this
module is the thing that plugs into it: a controllable fault source
that can

  * raise a bounded burst of **transient** failures (the flaky-link /
    failed-launch mode the dispatch engine's failover must absorb
    invisibly);
  * declare **sticky device loss** — every device leg fails until
    `heal()` — the mode that must trip the engine's circuit breaker
    into host-degraded service;
  * **stall** a bounded number of legs for a fixed wall-clock delay
    WITHOUT failing them (the slow-link mode): results stay correct,
    but the batch blows the engine's per-batch deadline, which counts
    toward the breaker exactly like a failure;
  * arm a **seeded probabilistic schedule** (`fail_random`) — every
    matching check faults with probability p drawn from the injector's
    own `random.Random(seed)`, so a chaos run replays bit-identically
    from its seed.

Faults can be scoped to **shards** (`shards=...` on every programming
call): the sub-axis columns of a `ShardedDeviceTable` mesh. A
shard-scoped fault fires on the mesh-wide legs only while at least one
target shard is still in the mesh (a table's `lost_shards`, when it
has them), and the raised error carries a `shard` attribute. The
`shard_probe` leg is the direct probe of one chip: it keeps failing
until `heal()` whatever the table holds. The dispatch engine's shard
breaker reads the `shard` to count the failure in that shard's ledger
instead of forfeiting the whole mesh, and evacuating the shard puts it
in `lost_shards`, which silences its fault on the mesh-wide legs.

A real device fault surfaces in PyTorch as a `torch.AcceleratorError`
(a bare `RuntimeError` whose message starts "CUDA error" in older
torch); CUDA errors are asynchronous, so a faulting kernel is reported by
a later synchronising call. `is_device_fault` tells those and the
injected `DeviceLinkError` family apart from every other exception: a
kernel that fails to build or launch, or a bug of the port's own code,
is not the card's fault, and the failure domain lets it propagate.

The disk seam (`DiskFaultInjector`, the port's copy of the disk half of
emqx_tpu/chaos/faults.py) plugs into the durable tier's ds/diskio
None-seam. Its errors are `OSError`s (and `SimulatedCrash`), never
device faults: a disk fault fail-stops a DS shard, and the device
breaker does not hear of it."""

from __future__ import annotations

import errno
import random
import time
from typing import Any, Dict, FrozenSet, Optional, Sequence, Tuple

import torch

from ..ds import diskio
from ..ds.diskio import (  # noqa: F401  re-exported with the disk seam
    DiskFaultError,
    DiskFullError,
    DiskIOError,
    FsyncFailedError,
    SimulatedCrash,
)
from ..ds.metrics import DS_METRICS

# the legs check() is called with — one name per seam at the card
LEGS = (
    "match_begin",
    "match_finish",
    "fanout_begin",
    "fanout_finish",
    "sync",
)

# the per-shard recovery probe: not a broker dispatch leg, so it is NOT
# part of LEGS — an un-scoped fault still covers it (all-legs faults
# fail the probe until heal()), and it ignores lost_shards: probing an
# evacuated chip is its whole job
SHARD_PROBE_LEG = "shard_probe"


class DeviceLinkError(RuntimeError):
    """Base of the injected device failures. `shard` is the sub-axis
    column a shard-scoped fault was attributed to (None for
    whole-device faults)."""

    shard: Optional[int] = None


class TransientDeviceError(DeviceLinkError):
    """A one-off device fault: retry/fallback should absorb it."""


class DeviceLostError(DeviceLinkError):
    """Sticky device loss: every device leg fails until heal()."""


class DeviceDeadlineExceeded(DeviceLinkError):
    """A transfer abandoned past its deadline (wedged link)."""


def is_device_fault(exc: BaseException) -> bool:
    """Whether `exc` came from the card, so that the failure domain may
    re-serve its batch from the host and count it toward the breaker:
    the injected `DeviceLinkError` family and CUDA runtime errors
    raised by torch. Anything else propagates."""
    if isinstance(exc, DeviceLinkError):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    return type(exc) is RuntimeError and str(exc).startswith(
        ("CUDA error", "CUDA driver error")
    )


# sentinel: the programmed fault does not apply to this check
_SKIP = object()


class DeviceFaultInjector:
    """One injector per Router; installed on the router AND its device
    table so route-churn syncs outside the publish path are injectable
    too. `check(leg)` is the hot-path entry: when healthy it is one
    falsy test. `seed` fixes the probabilistic schedule (`fail_random`)
    AND `pick_shard`, so a chaos run replays from its seed."""

    def __init__(self, seed: int = 0) -> None:
        self.seed = int(seed)
        self.rng = random.Random(self.seed)
        self._sticky = False
        self._transient_left = 0
        self._stall_left = 0
        self._stall_s = 0.0
        self._stall_fail = False
        self._random_p = 0.0
        self._legs: Optional[Tuple[str, ...]] = None
        self._shards: Optional[FrozenSet[int]] = None
        self.checks_total = 0
        self.faults_raised = 0
        self.stalls_injected = 0
        # per-(leg, shard) injected-fault ledger; mirrored on the
        # telemetry as fault_injected_total{leg,shard}
        self.injected: Dict[Tuple[str, str], int] = {}
        self.telemetry: Any = None
        self._router: Any = None

    # --- wiring -----------------------------------------------------------

    def install(self, router: Any) -> "DeviceFaultInjector":
        """Attach to every seam of one Router (idempotent)."""
        router.fault_injector = self
        router.device_table.fault_injector = self
        self.telemetry = router.telemetry
        self._router = router
        return self

    def uninstall(self) -> None:
        r = self._router
        if r is not None:
            if r.fault_injector is self:
                r.fault_injector = None
            if r.device_table.fault_injector is self:
                r.device_table.fault_injector = None
        self._router = None

    # --- fault programming ------------------------------------------------

    def fail_transient(
        self,
        n: int = 1,
        legs: Optional[Sequence[str]] = None,
        shards: Optional[Sequence[int]] = None,
    ) -> None:
        """The next `n` device-leg checks (optionally scoped to `legs`
        and/or `shards`) raise TransientDeviceError, then the link is
        healthy again."""
        self._transient_left = int(n)
        self._legs = tuple(legs) if legs else None
        self._shards = frozenset(shards) if shards is not None else None

    def fail_sticky(
        self,
        legs: Optional[Sequence[str]] = None,
        shards: Optional[Sequence[int]] = None,
    ) -> None:
        """Device loss: every check fails until heal(). With `shards`,
        only the targeted sub-axis columns are lost."""
        self._sticky = True
        self._legs = tuple(legs) if legs else None
        self._shards = frozenset(shards) if shards is not None else None

    def stall(
        self,
        seconds: float,
        n: int = 1,
        fail: bool = False,
        legs: Optional[Sequence[str]] = None,
        shards: Optional[Sequence[int]] = None,
    ) -> None:
        """Stall the next `n` checks for `seconds` of wall clock. With
        `fail=False` (default) the leg then SUCCEEDS — the
        slow-but-correct mode that must blow the engine's per-batch
        deadline; `fail=True` additionally abandons the transfer
        (DeviceDeadlineExceeded), the wedged-link mode."""
        self._stall_left = int(n)
        self._stall_s = float(seconds)
        self._stall_fail = bool(fail)
        self._legs = tuple(legs) if legs else None
        self._shards = frozenset(shards) if shards is not None else None

    def fail_random(
        self,
        p: float,
        legs: Optional[Sequence[str]] = None,
        shards: Optional[Sequence[int]] = None,
    ) -> None:
        """Arm the seeded probabilistic schedule: every matching check
        raises TransientDeviceError with probability `p`, drawn from
        the injector's `random.Random(seed)` — deterministic given the
        seed and the check sequence."""
        self._random_p = float(p)
        self._legs = tuple(legs) if legs else None
        self._shards = frozenset(shards) if shards is not None else None

    def heal(self) -> None:
        """Clear every programmed fault: the link is healthy."""
        self._sticky = False
        self._transient_left = 0
        self._stall_left = 0
        self._stall_s = 0.0
        self._stall_fail = False
        self._random_p = 0.0
        self._legs = None
        self._shards = None

    @property
    def healthy(self) -> bool:
        return not (
            self._sticky
            or self._transient_left > 0
            or self._stall_left > 0
            or self._random_p > 0.0
        )

    def pick_shard(self, n_shards: int) -> int:
        """Seeded victim-shard draw for scenario scripts."""
        return self.rng.randrange(int(n_shards))

    # --- the seam entry ---------------------------------------------------

    def _lost_shards(self) -> FrozenSet[int]:
        r = self._router
        if r is None:
            return frozenset()
        lost = getattr(r.device_table, "lost_shards", None)
        return frozenset(lost) if lost else frozenset()

    def _target_shard(self, leg: str, shard: Optional[int]) -> Any:
        """Resolve shard scoping for one check: `_SKIP` (fault does not
        apply here), None (untargeted whole-device fault), or the int
        shard the raised error is attributed to."""
        targets = self._shards
        if targets is None:
            return None
        if shard is not None:
            # shard-scoped call site (the probe of ONE chip)
            return shard if shard in targets else _SKIP
        if leg == SHARD_PROBE_LEG:
            live = targets
        else:
            # mesh-wide device leg: an evacuated chip is out of the
            # mesh, so device dispatches no longer touch it
            live = targets - self._lost_shards()
        if not live:
            return _SKIP
        return min(live)

    def _record_injected(self, leg: str, shard: Optional[int]) -> str:
        label = "all" if shard is None else str(shard)
        key = (leg, label)
        self.injected[key] = self.injected.get(key, 0) + 1
        tel = self.telemetry
        if tel is not None and getattr(tel, "enabled", False):
            tel.count_labeled(
                "fault_injected_total", {"leg": leg, "shard": label}
            )
        return label

    def check(self, leg: str, shard: Optional[int] = None) -> None:
        """Called by every leg at the card. Healthy: one falsy test.
        Faulty: count, then stall and/or raise per the programmed
        mode. `shard` names the single chip a shard-scoped call site
        touches; mesh-wide legs pass None and the injector attributes
        the fault to one live target shard."""
        if self.healthy:
            return
        if self._legs is not None and leg not in self._legs:
            return
        tshard = self._target_shard(leg, shard)
        if tshard is _SKIP:
            return
        self.checks_total += 1
        tel = self.telemetry
        if self._stall_left > 0:
            self._stall_left -= 1
            self.stalls_injected += 1
            self._record_injected(leg, tshard)
            if tel is not None and tel.enabled:
                tel.count("chaos_device_stalls_total")
            time.sleep(self._stall_s)
            if not self._stall_fail:
                return
            self.faults_raised += 1
            if tel is not None and tel.enabled:
                tel.count("chaos_device_faults_total")
            err: DeviceLinkError = DeviceDeadlineExceeded(
                f"injected transfer stall abandoned at {leg} "
                f"({self._stall_s * 1e3:.0f}ms)"
            )
            err.shard = tshard
            raise err
        if self._random_p > 0.0 and not (
            self._sticky or self._transient_left > 0
        ):
            if self.rng.random() >= self._random_p:
                return
        self.faults_raised += 1
        self._record_injected(leg, tshard)
        if tel is not None and tel.enabled:
            tel.count("chaos_device_faults_total")
        if self._sticky:
            where = leg if tshard is None else f"{leg} shard {tshard}"
            err = DeviceLostError(f"injected device loss at {where}")
            err.shard = tshard
            raise err
        if self._transient_left > 0:
            self._transient_left -= 1
        err = TransientDeviceError(f"injected transient device fault at {leg}")
        err.shard = tshard
        raise err

    def status(self) -> dict:
        return {
            "healthy": self.healthy,
            "sticky": self._sticky,
            "transient_left": self._transient_left,
            "stall_left": self._stall_left,
            "random_p": self._random_p,
            "legs": list(self._legs) if self._legs else None,
            "shards": sorted(self._shards) if self._shards else None,
            "seed": self.seed,
            "checks_total": self.checks_total,
            "faults_raised": self.faults_raised,
            "stalls_injected": self.stalls_injected,
            "injected": {
                f"{leg}/{shard}": n
                for (leg, shard), n in sorted(self.injected.items())
            },
        }


# --- the disk seam --------------------------------------------------------

# the legs DiskFaultInjector.check() is called with — one name per
# durable-tier I/O seam (ds/diskio.py)
DISK_LEGS = (
    "open",
    "append",
    "fsync",
    "dir_fsync",
    "rename",
)

# named places the process can die during compaction choreography —
# each one is a distinct on-disk state the reopen must recover from
CRASH_POINTS = (
    "compact_before_tmp_fsync",
    "compact_after_tmp_fsync",
    "compact_before_rename",
    "compact_after_rename",
)

_DISK_ERRORS: Dict[str, Any] = {
    "enospc": (DiskFullError, errno.ENOSPC, "injected ENOSPC"),
    "eio": (DiskIOError, errno.EIO, "injected EIO"),
    "fsync": (FsyncFailedError, errno.EIO, "injected fsync failure"),
}


class DiskFaultInjector:
    """The durable tier's fault source — installs into the
    `ds/diskio` None-seam so every WAL append, fsync, rename and
    directory fsync in the process becomes injectable (the disk analog
    of DeviceFaultInjector's XLA seam). Modes:

      * **transient / sticky errno faults** (`fail_transient`,
        `fail_sticky`): ENOSPC (full disk), EIO (media error) or
        fsync failure, optionally scoped to `legs` and/or `paths`
        (substring match — one shard's file vs. the whole tier). A
        failed fsync must FAIL-STOP the shard: the storage layer
        never retries it, because the kernel may already have dropped
        the dirty pages (the fsyncgate loss mode).
      * **torn write** (`torn_write`): the next matching append puts
        only the first N bytes in the file and then 'the process
        dies' (SimulatedCrash) — the classic crash-mid-record state
        WAL v2's CRC framing exists to detect.
      * **crash points** (`crash_at`): die at a named step of the
        compaction swap — before/after tmp-fsync, before/after
        rename — each leaving a distinct on-disk state the reopen
        replay must recover to a consistent store.
      * **bit flip** (`corrupt_at`): flip bits at a byte offset of a
        closed WAL file, the silent-media-corruption mode replay's
        CRC check must refuse to deserialize.
      * seeded probabilistic schedule (`fail_random`), replayable
        from `seed` like the device injector's.

    Healthy cost: one falsy module-global read per I/O op."""

    def __init__(self, seed: int = 0) -> None:
        self.seed = int(seed)
        self.rng = random.Random(self.seed)
        self._sticky: Optional[str] = None  # error kind, or None
        self._transient_left = 0
        self._transient_kind = "eio"
        self._random_p = 0.0
        self._random_kind = "eio"
        self._torn: Optional[int] = None
        self._crash: Optional[str] = None
        self._legs: Optional[Tuple[str, ...]] = None
        self._paths: Optional[Tuple[str, ...]] = None
        self.checks_total = 0
        self.faults_raised = 0
        self.crashes_injected = 0
        self.injected: Dict[str, int] = {}

    # --- wiring -----------------------------------------------------------

    def install(self) -> "DiskFaultInjector":
        """Attach to the process-wide ds/diskio seam (idempotent)."""
        diskio.install_injector(self)
        return self

    def uninstall(self) -> None:
        diskio.uninstall_injector(self)

    # --- fault programming ------------------------------------------------

    def fail_transient(
        self,
        n: int = 1,
        kind: str = "eio",
        legs: Optional[Sequence[str]] = None,
        paths: Optional[Sequence[str]] = None,
    ) -> None:
        """The next `n` matching disk ops fail with `kind`
        (enospc/eio/fsync), then the disk is healthy again."""
        self._transient_left = int(n)
        self._transient_kind = kind
        self._legs = tuple(legs) if legs else None
        self._paths = tuple(paths) if paths else None

    def fail_sticky(
        self,
        kind: str = "eio",
        legs: Optional[Sequence[str]] = None,
        paths: Optional[Sequence[str]] = None,
    ) -> None:
        """Every matching disk op fails with `kind` until heal() —
        the full-disk / dead-media mode the shard breaker must
        fail-stop around."""
        self._sticky = kind
        self._legs = tuple(legs) if legs else None
        self._paths = tuple(paths) if paths else None

    def torn_write(
        self, nbytes: int, paths: Optional[Sequence[str]] = None
    ) -> None:
        """The next matching append writes only its first `nbytes`
        and then the process dies (SimulatedCrash). nbytes may exceed
        the record — it is clamped, so 0 = crash before any byte."""
        self._torn = max(0, int(nbytes))
        self._paths = tuple(paths) if paths else None

    def crash_at(
        self, point: str, paths: Optional[Sequence[str]] = None
    ) -> None:
        """Die at a named compaction crash point (CRASH_POINTS)."""
        if point not in CRASH_POINTS:
            raise ValueError(f"unknown crash point: {point}")
        self._crash = point
        self._paths = tuple(paths) if paths else None

    def fail_random(
        self,
        p: float,
        kind: str = "eio",
        legs: Optional[Sequence[str]] = None,
        paths: Optional[Sequence[str]] = None,
    ) -> None:
        """Seeded probabilistic schedule: every matching op fails with
        probability `p` — deterministic given seed + op sequence."""
        self._random_p = float(p)
        self._random_kind = kind
        self._legs = tuple(legs) if legs else None
        self._paths = tuple(paths) if paths else None

    def heal(self) -> None:
        """Clear every programmed fault: the disk is healthy."""
        self._sticky = None
        self._transient_left = 0
        self._random_p = 0.0
        self._torn = None
        self._crash = None
        self._legs = None
        self._paths = None

    @property
    def healthy(self) -> bool:
        return not (
            self._sticky is not None
            or self._transient_left > 0
            or self._random_p > 0.0
            or self._torn is not None
            or self._crash is not None
        )

    # --- direct media corruption -----------------------------------------

    @staticmethod
    def tear_tail(path: str, garbage: bytes = b"\x7f" * 7) -> None:
        """Append a partial record to a (closed) WAL file — the
        on-disk state a crash mid-append leaves behind, engine-
        independent (the live `torn_write` seam can only tear the
        Python engine's writes; the native engine writes from C)."""
        with open(path, "ab") as f:
            f.write(garbage)

    @staticmethod
    def corrupt_at(path: str, offset: int, xor: int = 0xFF) -> None:
        """Flip bits at `offset` of a (closed) file — silent media
        corruption; replay's CRC verification must refuse the record.
        Negative offsets index from the end."""
        with open(path, "r+b") as f:
            if offset < 0:
                f.seek(offset, 2)
            else:
                f.seek(offset)
            pos = f.tell()
            b = f.read(1)
            if not b:
                raise ValueError(f"offset {offset} past EOF of {path}")
            f.seek(pos)
            f.write(bytes([b[0] ^ (xor & 0xFF)]))

    # --- the seam entries (called by ds/diskio) ---------------------------

    def _match_path(self, path: str) -> bool:
        targets = self._paths
        if targets is None:
            return True
        return any(t in path for t in targets)

    def _record_injected(self, leg: str) -> None:
        self.injected[leg] = self.injected.get(leg, 0) + 1
        DS_METRICS.count_injected(leg)

    def _raise(self, kind: str, leg: str, path: str) -> None:
        cls, eno, msg = _DISK_ERRORS[kind]
        self.faults_raised += 1
        self._record_injected(leg)
        err = cls(f"{msg} at {leg}: {path}", path)
        err.errno = eno
        raise err

    def torn_len(self, path: str, n: int) -> Optional[int]:
        """Consulted by the append seam BEFORE the errno gate: when a
        torn write is armed for this path, returns how many bytes to
        land before the crash; the arm is one-shot."""
        if self._torn is None or not self._match_path(path):
            return None
        torn, self._torn = self._torn, None
        self.crashes_injected += 1
        self._record_injected("torn_write")
        return min(torn, n)

    def check(self, leg: str, path: str) -> None:
        """Called by every diskio seam entry. Healthy: one falsy test
        (done by the caller reading the module slot); here the
        programmed mode decides."""
        if self._legs is not None and leg not in self._legs:
            return
        if not self._match_path(path):
            return
        self.checks_total += 1
        if self._sticky is not None:
            self._raise(self._sticky, leg, path)
        if self._transient_left > 0:
            self._transient_left -= 1
            self._raise(self._transient_kind, leg, path)
        if self._random_p > 0.0 and self.rng.random() < self._random_p:
            self._raise(self._random_kind, leg, path)

    def crash_check(self, point: str, path: str) -> None:
        """Consulted at every named crash point; fires (one-shot) when
        exactly this point is armed."""
        if self._crash != point or not self._match_path(path):
            return
        self._crash = None
        self.crashes_injected += 1
        self._record_injected(point)
        raise SimulatedCrash(f"injected crash at {point}: {path}", path)

    def status(self) -> dict:
        return {
            "healthy": self.healthy,
            "sticky": self._sticky,
            "transient_left": self._transient_left,
            "random_p": self._random_p,
            "torn": self._torn,
            "crash": self._crash,
            "legs": list(self._legs) if self._legs else None,
            "paths": list(self._paths) if self._paths else None,
            "seed": self.seed,
            "checks_total": self.checks_total,
            "faults_raised": self.faults_raised,
            "crashes_injected": self.crashes_injected,
            "injected": dict(sorted(self.injected.items())),
        }
