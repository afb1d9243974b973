"""Ordered KV store binding — native C++ engine and its Python twin
(the port's own copy of emqx_tpu/ds/kvstore.py).

The durable-storage layer's bottom tier, standing where the reference
keeps rocksdb behind a NIF (emqx_ds_storage_layer.erl:140,252,282-294
→ erlang-rocksdb dep). The engine is the port's
emqx_tpu_torch/native/kvlog.cc (WAL + ordered memtable), built by g++
at first use (`native.load_library("libemqx_torch_kv")`) and loaded
via ctypes; a failed build raises `NativeBuildError`. `PyKv` is the
pure-Python twin (same on-disk bytes, parity-tested), which runs only
when the caller selects it (`open_kv(prefer_native=False)`): nothing
falls back to it without a word.

WAL format v2 (both engines): the file opens with an 8-byte magic
(``EKVWAL2\\n``) and every record is CRC-framed —

    [u32 crc][u32 klen][u32 vlen][key bytes][val bytes]

crc is CRC-32 (zlib polynomial) over ``klen||vlen||key||val``;
``vlen == 0xFFFFFFFF`` marks a tombstone (no val bytes). Replay stops
at the last *verified* record: a short/oversized header or a CRC
mismatch truncates the tail (counted as `emqx_ds_wal_torn_records_total`
/ `emqx_ds_wal_crc_failures_total`) — a crash that leaves a
length-plausible header followed by garbage can no longer replay as
committed data, which is exactly rocksdb's WAL checksum contract.
Header lengths are bounds-checked against the remaining file size
before any read, so a garbage ``klen`` cannot allocate gigabytes.
Headerless files replay under the v1 rules (length-framed records)
and are rewritten to v2 by an immediate compaction, so every store is
uniformly one format after open.

API (both impls): put/get/delete bytes keys/values, ordered range
scan(start, end, limit), flush (fsync boundary), compact, close
(fsyncs first), kill (simulated SIGKILL: no fsync boundary).
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib
from typing import Dict, Iterator, Optional, Tuple

from .. import native
from . import diskio
from .metrics import DS_METRICS

KV_LIBRARY = "libemqx_torch_kv"

_TOMBSTONE = 0xFFFFFFFF

# v2 file magic: headerless files are v1 (length-framed, un-checksummed)
WAL_MAGIC = b"EKVWAL2\n"


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """The engine, built and bound at first use (never at import);
    raises NativeBuildError when it cannot be built or loaded."""
    global _LIB
    if _LIB is None:
        _LIB = _bind(native.load_library(KV_LIBRARY))
    return _LIB


_P, _I, _U32, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint64
_S, _PS, _PU64 = ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_uint64)

# kvlog.cc's C ABI: entry -> (restype, argtypes)
_SIGNATURES = {
    "kv_open": (_P, [_S]),
    "kv_put": (_I, [_P, _S, _U32, _S, _U32]),
    "kv_delete": (_I, [_P, _S, _U32]),
    "kv_get": (ctypes.c_int64, [_P, _S, _U32, _PS]),
    "kv_count": (_U64, [_P]),
    "kv_scan": (_P, [_P, _S, _U32, _S, _U32, _U64]),
    "kv_iter_next": (_I, [_P, _PS, _PU64, _PS, _PU64]),
    "kv_iter_free": (None, [_P]),
    "kv_flush": (_I, [_P]),
    "kv_compact": (_I, [_P]),
    "kv_wal_records": (_U64, [_P]),
    "kv_torn_records": (_U64, [_P]),
    "kv_crc_failures": (_U64, [_P]),
    "kv_upgraded": (_U64, [_P]),
    "kv_reopen": (_I, [_P]),
    "kv_close": (None, [_P]),
    "kv_kill": (None, [_P]),
}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


class KvError(IOError):
    pass


class NativeKv:
    """ctypes wrapper over the port's native/kvlog.cc, built at first
    use; a failed build raises NativeBuildError."""

    def __init__(self, path: str):
        self._lib = _lib()
        # the native engine does its own raw I/O, so the Python seam
        # can only gate the open leg — the crash matrix exercises its
        # replay by crafting on-disk states through PyKv (same bytes)
        inj = diskio.injector()
        if inj is not None:
            inj.check("open", path)
        self._h = self._lib.kv_open(path.encode())
        if not self._h:
            raise KvError(f"kv_open failed: {path}")
        self.path = path
        # fold the replay verdict into the process-global DS ledger
        self.torn_records = int(self._lib.kv_torn_records(self._h))
        self.crc_failures = int(self._lib.kv_crc_failures(self._h))
        DS_METRICS.count("wal_torn_records_total", self.torn_records)
        DS_METRICS.count("wal_crc_failures_total", self.crc_failures)
        DS_METRICS.count("wal_replayed_records_total", self.count())
        DS_METRICS.count(
            "wal_upgraded_files_total", int(self._lib.kv_upgraded(self._h))
        )

    def put(self, key: bytes, val: bytes) -> None:
        inj = diskio.injector()
        if inj is not None:
            inj.check("append", self.path)
        if self._lib.kv_put(self._h, key, len(key), val, len(val)) != 0:
            raise KvError("kv_put failed")

    def get(self, key: bytes) -> Optional[bytes]:
        out = ctypes.c_char_p()
        n = self._lib.kv_get(self._h, key, len(key), ctypes.byref(out))
        if n < 0:
            return None
        return ctypes.string_at(out, n)

    def delete(self, key: bytes) -> None:
        inj = diskio.injector()
        if inj is not None:
            inj.check("append", self.path)
        if self._lib.kv_delete(self._h, key, len(key)) != 0:
            raise KvError("kv_delete failed")

    def scan(
        self, start: bytes = b"", end: bytes = b"", limit: int = 0
    ) -> Iterator[Tuple[bytes, bytes]]:
        it = self._lib.kv_scan(self._h, start, len(start), end, len(end), limit)
        try:
            k = ctypes.c_char_p()
            kl = ctypes.c_uint64()
            v = ctypes.c_char_p()
            vl = ctypes.c_uint64()
            while (
                self._lib.kv_iter_next(
                    it, ctypes.byref(k), ctypes.byref(kl), ctypes.byref(v), ctypes.byref(vl)
                )
                == 0
            ):
                yield ctypes.string_at(k, kl.value), ctypes.string_at(v, vl.value)
        finally:
            self._lib.kv_iter_free(it)

    def count(self) -> int:
        return self._lib.kv_count(self._h)

    def wal_records(self) -> int:
        return self._lib.kv_wal_records(self._h)

    def flush(self) -> None:
        inj = diskio.injector()
        if inj is not None:
            inj.check("fsync", self.path)
        if self._lib.kv_flush(self._h) != 0:
            raise KvError("kv_flush failed")

    def compact(self) -> None:
        if self._lib.kv_compact(self._h) != 0:
            raise KvError("kv_compact failed")

    def reopen(self) -> None:
        """Recovery-path reopen: rebuild the memtable from disk exactly
        as a fresh process would (replay + CRC verification + torn-tail
        truncation), keeping the same handle."""
        inj = diskio.injector()
        if inj is not None:
            inj.check("open", self.path)
        if self._lib.kv_reopen(self._h) != 0:
            raise KvError(f"kv_reopen failed: {self.path}")
        self.torn_records = int(self._lib.kv_torn_records(self._h))
        self.crc_failures = int(self._lib.kv_crc_failures(self._h))
        DS_METRICS.count("wal_torn_records_total", self.torn_records)
        DS_METRICS.count("wal_crc_failures_total", self.crc_failures)
        DS_METRICS.count("wal_replayed_records_total", self.count())
        DS_METRICS.count(
            "wal_upgraded_files_total", int(self._lib.kv_upgraded(self._h))
        )

    def close(self) -> None:
        if self._h:
            self._lib.kv_close(self._h)
            self._h = None

    def kill(self) -> None:
        """Simulated SIGKILL: release the store WITHOUT the fsync
        boundary close() provides."""
        if self._h:
            self._lib.kv_kill(self._h)
            self._h = None


class PyKv:
    """Pure-Python engine, same WAL format as kvlog.cc."""

    def __init__(self, path: str):
        self.path = path
        self._table: Dict[bytes, bytes] = {}
        self._lock = threading.Lock()
        self._wal_records = 0
        self.torn_records = 0
        self.crc_failures = 0
        # a stray compaction tmp means the process died before the
        # rename — the swap never happened, so the tmp is dead weight
        if os.path.exists(path + ".compact"):
            diskio.file_remove(path + ".compact")
        upgrade = self._replay()
        self._wal = diskio.file_open(path, "ab")
        if self._wal.tell() == 0:
            # fresh (or fully-truncated) file: stamp the v2 magic
            diskio.file_write(self._wal, WAL_MAGIC, path)
        DS_METRICS.count("wal_torn_records_total", self.torn_records)
        DS_METRICS.count("wal_crc_failures_total", self.crc_failures)
        DS_METRICS.count("wal_replayed_records_total", self._wal_records)
        if upgrade:
            # v1 file: rewrite through compaction so the store is
            # uniformly v2 — and future replays are CRC-verified
            self.compact()
            DS_METRICS.count("wal_upgraded_files_total")

    @staticmethod
    def _crc(klen: int, vlen: int, key: bytes, val: bytes) -> int:
        return zlib.crc32(struct.pack("<II", klen, vlen) + key + val)

    def _replay(self) -> bool:
        """Rebuild the memtable from the WAL; returns True when the
        file was v1 (length-framed) and needs the upgrade rewrite."""
        if not os.path.exists(self.path):
            return False
        size = os.path.getsize(self.path)
        if size == 0:
            return False
        good = 0  # offset after the last verified record
        v1 = False
        with diskio.file_open(self.path, "rb") as f:
            if size >= 8 and f.read(8) == WAL_MAGIC:
                good = 8
                good = self._replay_v2(f, size, good)
            else:
                v1 = True
                f.seek(0)
                good = self._replay_v1(f, size)
        if good < size:
            with diskio.file_open(self.path, "r+b") as f:
                f.truncate(good)
        # a v1 file whose every record was torn away is just empty
        return v1 and good > 0

    def _replay_v2(self, f, size: int, good: int) -> int:
        while True:
            hdr = f.read(12)
            if len(hdr) < 12:
                if hdr:
                    self.torn_records += 1
                return good
            crc, klen, vlen = struct.unpack("<III", hdr)
            vreal = 0 if vlen == _TOMBSTONE else vlen
            # bounded header validation: a garbage length must fail
            # HERE, not inside a multi-GB read()
            if klen + vreal > size - f.tell():
                self.torn_records += 1
                return good
            key = f.read(klen)
            val = f.read(vreal)
            if self._crc(klen, vlen, key, val) != crc:
                # never deserialize an unverified record — and nothing
                # after it either: the frame boundary itself is
                # untrusted once one CRC fails
                self.crc_failures += 1
                return good
            if vlen == _TOMBSTONE:
                self._table.pop(key, None)
            else:
                self._table[key] = val
            self._wal_records += 1
            good = f.tell()

    def _replay_v1(self, f, size: int) -> int:
        """Legacy length-framed replay (no CRC): best-effort torn-tail
        cut, kept only so pre-v2 data dirs open."""
        good = 0
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                if hdr:
                    self.torn_records += 1
                return good
            klen, vlen = struct.unpack("<II", hdr)
            vreal = 0 if vlen == _TOMBSTONE else vlen
            if klen + vreal > size - f.tell():
                self.torn_records += 1
                return good
            key = f.read(klen)
            if vlen == _TOMBSTONE:
                self._table.pop(key, None)
            else:
                self._table[key] = f.read(vreal)
            self._wal_records += 1
            good = f.tell()

    def _record(self, key: bytes, vlen: int, val: bytes) -> bytes:
        return (
            struct.pack("<III", self._crc(len(key), vlen, key, val),
                        len(key), vlen)
            + key + val
        )

    def put(self, key: bytes, val: bytes) -> None:
        with self._lock:
            diskio.file_write(self._wal, self._record(key, len(val), val),
                              self.path)
            self._table[key] = val
            self._wal_records += 1

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._table.get(key)

    def delete(self, key: bytes) -> None:
        with self._lock:
            diskio.file_write(self._wal, self._record(key, _TOMBSTONE, b""),
                              self.path)
            self._table.pop(key, None)
            self._wal_records += 1

    def scan(
        self, start: bytes = b"", end: bytes = b"", limit: int = 0
    ) -> Iterator[Tuple[bytes, bytes]]:
        with self._lock:
            keys = sorted(
                k for k in self._table if k >= start and (not end or k < end)
            )
            if limit:
                keys = keys[:limit]
            items = [(k, self._table[k]) for k in keys]
        yield from items

    def count(self) -> int:
        return len(self._table)

    def wal_records(self) -> int:
        return self._wal_records

    def flush(self) -> None:
        with self._lock:
            diskio.file_fsync(self._wal, self.path)

    def reopen(self) -> None:
        """Recovery-path reopen: drop the (possibly poisoned) handle
        and the in-memory table, then rebuild from the file exactly as
        a fresh process would — replay, CRC verification, torn-tail
        truncation. Per-store torn/crc counters reflect the LAST
        replay's verdict; the process-global ledger accumulates."""
        with self._lock:
            if not self._wal.closed:
                # drain buffered appends so replay sees them; the
                # handle may be past a failed fsync, so best-effort
                try:
                    self._wal.close()
                except OSError:
                    pass
            if os.path.exists(self.path + ".compact"):
                diskio.file_remove(self.path + ".compact")
            self._table = {}
            self._wal_records = 0
            self.torn_records = 0
            self.crc_failures = 0
            upgrade = self._replay()
            self._wal = diskio.file_open(self.path, "ab")
            if self._wal.tell() == 0:
                diskio.file_write(self._wal, WAL_MAGIC, self.path)
            DS_METRICS.count("wal_torn_records_total", self.torn_records)
            DS_METRICS.count("wal_crc_failures_total", self.crc_failures)
            DS_METRICS.count("wal_replayed_records_total", self._wal_records)
            if upgrade:
                self._compact_locked()
                DS_METRICS.count("wal_upgraded_files_total")

    def compact(self) -> None:
        with self._lock:
            self._compact_locked()

    def _compact_locked(self) -> None:
        tmp = self.path + ".compact"
        with diskio.file_open(tmp, "wb") as f:
            diskio.file_write(f, WAL_MAGIC, tmp)
            for k in sorted(self._table):
                v = self._table[k]
                diskio.file_write(f, self._record(k, len(v), v), tmp)
            diskio.crash_point("compact_before_tmp_fsync", self.path)
            diskio.file_fsync(f, tmp)
            diskio.crash_point("compact_after_tmp_fsync", self.path)
        self._wal.close()
        diskio.crash_point("compact_before_rename", self.path)
        diskio.file_replace(tmp, self.path)
        diskio.crash_point("compact_after_rename", self.path)
        # rename durability: the parent dir's pages must go down
        # too, or power loss resurrects the pre-compaction file
        diskio.dir_fsync(os.path.dirname(self.path))
        self._wal = diskio.file_open(self.path, "ab")
        self._wal_records = len(self._table)

    def close(self) -> None:
        with self._lock:
            if not self._wal.closed:
                # graceful shutdown IS a durability boundary: buffered
                # appends must be on disk before the handle goes away
                try:
                    diskio.file_fsync(self._wal, self.path)
                finally:
                    self._wal.close()

    def kill(self) -> None:
        """Simulated SIGKILL: drop the handle with NO fsync boundary.
        (In-process, userspace buffers drain on close either way; the
        mid-record crash modes belong to the injector's torn-write
        leg.)"""
        with self._lock:
            if not self._wal.closed:
                self._wal.close()


def open_kv(path: str, prefer_native: bool = True):
    """Open an ordered KV store at `path`: the native engine (built at
    first use; a failed build raises NativeBuildError), or the Python
    twin when the caller selects it with prefer_native=False."""
    if prefer_native:
        return NativeKv(path)
    return PyKv(path)
