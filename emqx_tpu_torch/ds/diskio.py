"""Disk-IO seam for the durable tier — every byte the DS layer puts on
(or pulls off) disk goes through these helpers (the port's own copy of
emqx_tpu/ds/diskio.py).

Same None-seam discipline as the device boundary's `fault_injector`
attribute: a module-global injector slot read once per operation, so a
healthy process pays one falsy test and a chaos run can program
ENOSPC/EIO/fsync-failure/torn-write/crash-point faults without
monkeypatching (`chaos/faults.DiskFaultInjector` installs here). No
bare `open` / `os.fsync` / `os.replace` call sites exist under
`emqx_tpu_torch/ds/` outside this file, so disk I/O stays
chaos-testable by construction (the native engine does its own I/O
from C; `ds/kvstore.py` gates its legs at the Python boundary).

Error taxonomy (all `OSError` so production handlers catch the
injected and the real failure through one clause) — except
`SimulatedCrash`, which models *process death mid-operation* (torn
write, compaction crash point): it deliberately does NOT derive from
`OSError`, because no error handler may observe a crash — the store
object is dead and only a reopen-and-replay may follow.
"""

from __future__ import annotations

import os
from typing import Any, BinaryIO, Optional


class DiskFaultError(OSError):
    """Base of the injected disk failures; `path` names the file the
    faulted operation targeted."""

    def __init__(self, msg: str, path: str = "") -> None:
        super().__init__(msg)
        self.path = path


class DiskFullError(DiskFaultError):
    """Injected ENOSPC on append."""


class DiskIOError(DiskFaultError):
    """Injected EIO (media error) on append/open."""


class FsyncFailedError(DiskFaultError):
    """Injected fsync failure — the one error that MUST fail-stop the
    shard: after a failed fsync the kernel may have dropped the dirty
    pages, so retry-and-continue silently loses acknowledged data
    (the classic fsyncgate mode)."""


class SimulatedCrash(RuntimeError):
    """The process died here. Raised by torn-write injection and named
    compaction crash points; the only valid continuation is abandoning
    the store object and reopening from the data dir."""

    def __init__(self, msg: str, path: str = "") -> None:
        super().__init__(msg)
        self.path = path


# the installed DiskFaultInjector (chaos/faults.py), or None
_INJECTOR: Optional[Any] = None


def install_injector(inj: Any) -> None:
    global _INJECTOR
    _INJECTOR = inj


def uninstall_injector(inj: Any) -> None:
    global _INJECTOR
    if _INJECTOR is inj:
        _INJECTOR = None


def injector() -> Optional[Any]:
    return _INJECTOR


# --- the seam entries -----------------------------------------------------


def file_open(path: str, mode: str) -> BinaryIO:
    inj = _INJECTOR
    if inj is not None:
        inj.check("open", path)
    return open(path, mode)  # noqa: DS-seam — this IS the seam


def file_write(f: BinaryIO, data: bytes, path: str) -> None:
    """One WAL append. Torn-write injection lands the programmed
    prefix in the file (flushed to the OS so a reopen sees it) and
    then 'kills the process'."""
    inj = _INJECTOR
    if inj is not None:
        torn = inj.torn_len(path, len(data))
        if torn is not None:
            f.write(data[:torn])
            try:
                f.flush()
            except OSError:
                pass
            raise SimulatedCrash(
                f"torn write: {torn}/{len(data)} bytes then crash", path
            )
        inj.check("append", path)
    f.write(data)


def file_fsync(f: BinaryIO, path: str) -> None:
    """Flush userspace buffers and fsync — the durability boundary."""
    inj = _INJECTOR
    if inj is not None:
        inj.check("fsync", path)
    f.flush()
    os.fsync(f.fileno())


def dir_fsync(path: str) -> None:
    """fsync a DIRECTORY so a just-renamed entry survives power loss —
    rename durability needs the parent's pages down too."""
    inj = _INJECTOR
    if inj is not None:
        inj.check("dir_fsync", path)
    fd = os.open(path or ".", os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def file_replace(src: str, dst: str) -> None:
    inj = _INJECTOR
    if inj is not None:
        inj.check("rename", dst)
    os.replace(src, dst)


def file_remove(path: str) -> None:
    os.remove(path)


def crash_point(name: str, path: str) -> None:
    """A named place the process can die (compaction choreography).
    No-op unless the injector armed exactly this point."""
    inj = _INJECTOR
    if inj is not None:
        inj.crash_check(name, path)
