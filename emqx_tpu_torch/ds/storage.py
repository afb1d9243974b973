"""Durable-storage layer: shards × generations over the KV engine (the
port's own copy of emqx_tpu/ds/storage.py).

The emqx_ds_storage_layer analog: messages land in per-shard KV stores
(shard = hash(publisher clientid), the reference's shard-by-publisher),
keyed so one ordered range scan replays a (generation, static_key)
stream in time order — the skipstream/bitfield-LTS idea
(emqx_ds_storage_skipstream_lts.erl:81-109) with the LTS trie
providing static keys and varying words.

Key layout (big-endian so byte order == scan order):
    [gen u16][static u32][ts_ms u64][seq u16]
Value = binary message record (emqx_ds_msg_serializer analog).

Generations time-slice the store (emqx_ds.erl:298-305): new writes go
to the current generation; dropping an old generation is one range
delete — O(expired data), never a full scan.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from ..broker.message import Message
from ..ops import topic as topic_mod
from .kvstore import KvError, open_kv
from .lts import LtsTrie, varying_match
from .metrics import DS_METRICS

_META_PREFIX = b"\xff\xffmeta/"  # sorts after all message keys


class ShardFailedError(IOError):
    """Raised on writes to a fail-stopped shard. The shard saw a disk
    failure it must not paper over (the canonical case: a failed fsync,
    after which the kernel may have DROPPED the dirty pages — retrying
    the fsync would report success while acknowledged data is gone,
    the fsyncgate failure mode). Reads keep serving from the memtable;
    writes are refused until `recover()` re-verifies the disk."""


def serialize_message(msg: Message, varying: Sequence[str]) -> bytes:
    """Compact record: varying words restore the full topic from the
    static spec; props/headers ride JSON."""
    head = json.dumps(
        {
            "v": list(varying),
            "q": msg.qos,
            "r": int(msg.retain),
            "f": msg.from_client,
            "i": msg.id,
            "t": msg.timestamp,
            "p": msg.props or None,
            "topic": msg.topic,
        },
        separators=(",", ":"),
    ).encode()
    return struct.pack("<I", len(head)) + head + msg.payload


def deserialize_message(blob: bytes) -> Tuple[Message, List[str]]:
    (hlen,) = struct.unpack_from("<I", blob)
    head = json.loads(blob[4 : 4 + hlen])
    payload = blob[4 + hlen :]
    msg = Message(
        topic=head["topic"],
        payload=payload,
        qos=head["q"],
        retain=bool(head["r"]),
        from_client=head["f"],
        id=head["i"],
        timestamp=head["t"],
        props=head["p"] or {},
    )
    return msg, head["v"]


@dataclass(frozen=True)
class Stream:
    shard: int
    generation: int
    static_key: int
    constraints: Tuple[str, ...]  # varying-level constraints from the filter


@dataclass(frozen=True)
class DsIterator:
    stream: Stream
    filter: str
    after_key: bytes  # resume position (exclusive)


class Shard:
    """One shard: a KV store + its LTS trie + generation set.

    Failure discipline (the device breaker's close analog, on disk):
    any `OSError` out of the write path FAIL-STOPS the shard — writes
    refused, reads still served from the memtable — rather than
    retry-and-continue, because after a failed fsync the kernel may
    already have dropped the dirty pages. `recover()` is the one way
    back: reopen-from-disk (replay + CRC verify) plus a probe write
    that must round-trip through a real fsync."""

    def __init__(
        self,
        path: str,
        lts_threshold: int = 20,
        prefer_native: bool = True,
        shard_id: int = 0,
    ):
        self.path = path
        self.shard_id = shard_id
        self.kv = open_kv(path, prefer_native=prefer_native)
        self._lock = threading.Lock()
        self._seq = 0
        self._lts_threshold = lts_threshold
        # fail-stop state: None = healthy, else the failure cause
        self.failed: Optional[str] = None
        # StorageLayer installs this; called OUTSIDE the shard lock
        self.on_fail: Optional[Callable[[int, BaseException], None]] = None
        # fail-stops begun (counted before `failed` is visible) and
        # their fan-outs returned: a reader that sees `failed` waits for
        # the two to meet before it reads the alarm and flight trigger
        self.failstops = 0
        self.failstops_notified = 0
        self._load_meta()

    def _load_meta(self) -> None:
        blob = self.kv.get(_META_PREFIX + b"lts")
        self.lts = LtsTrie.load(blob) if blob else LtsTrie(
            threshold=self._lts_threshold
        )
        gens = self.kv.get(_META_PREFIX + b"gens")
        self.generations: List[int] = json.loads(gens) if gens else [0]

    @property
    def current_gen(self) -> int:
        return self.generations[-1]

    # --- fail-stop ------------------------------------------------------

    def _check_writable(self) -> None:
        # caller holds self._lock
        if self.failed is not None:
            raise ShardFailedError(
                f"shard {self.shard_id} fail-stopped: {self.failed}"
            )

    def _fail_stop_locked(self, exc: BaseException) -> None:
        # caller holds self._lock; returns with the shard read-only
        self.failstops += 1
        self.failed = f"{type(exc).__name__}: {exc}"
        DS_METRICS.count("shard_failures_total")

    def _notify_failed(self, exc: BaseException) -> None:
        # OUTSIDE the lock: the callback fans out to alarms / the
        # flight recorder, which may publish $SYS and re-enter storage
        cb = self.on_fail
        try:
            if cb is not None:
                cb(self.shard_id, exc)
        except Exception:
            pass
        finally:
            # under the lock, as `failstops` is: two fail-stops racing on
            # two threads must not lose an increment
            with self._lock:
                self.failstops_notified += 1

    def recover(self) -> bool:
        """One recovery attempt: reopen from disk (WAL replay + CRC
        verification), then VERIFY the disk is writable again with a
        probe record that must round-trip through a real fsync. Only
        a verified probe clears the fail-stop. Returns True when the
        shard is healthy again."""
        with self._lock:
            if self.failed is None:
                return True
            probe = _META_PREFIX + b"probe"
            try:
                self.kv.reopen()
                self.kv.put(probe, b"ok")
                self.kv.flush()
                if self.kv.get(probe) != b"ok":
                    raise KvError("probe read-back mismatch")
                self.kv.delete(probe)
                self.kv.flush()
            except OSError:
                return False
            # adopt the replayed state (the in-memory trie/generations
            # may be ahead of what survived on disk)
            self._load_meta()
            self.failed = None
            DS_METRICS.count("shard_recoveries_total")
            return True

    def store_batch(self, msgs: Sequence[Message], sync: bool = True) -> None:
        fail_exc: Optional[BaseException] = None
        with self._lock:
            self._check_writable()
            try:
                lts_before = self.lts._next_static
                for msg in msgs:
                    words = topic_mod.words(msg.topic)
                    static, varying = self.lts.topic_key(words)
                    ts_ms = int(msg.timestamp * 1000)
                    self._seq = (self._seq + 1) & 0xFFFF
                    key = struct.pack(
                        ">HIQH", self.current_gen, static, ts_ms, self._seq
                    )
                    self.kv.put(key, serialize_message(msg, varying))
                if self.lts._next_static != lts_before:
                    self.kv.put(_META_PREFIX + b"lts", self.lts.dump())
                if sync:
                    self.kv.flush()
            except OSError as exc:
                fail_exc = exc
                self._fail_stop_locked(exc)
        if fail_exc is not None:
            self._notify_failed(fail_exc)
            raise ShardFailedError(
                f"shard {self.shard_id} fail-stopped: {fail_exc}"
            ) from fail_exc

    # --- generations ----------------------------------------------------

    def add_generation(self) -> int:
        fail_exc: Optional[BaseException] = None
        with self._lock:
            self._check_writable()
            try:
                g = self.current_gen + 1
                self.generations.append(g)
                self.kv.put(
                    _META_PREFIX + b"gens",
                    json.dumps(self.generations).encode(),
                )
                self.kv.flush()
                return g
            except OSError as exc:
                fail_exc = exc
                self._fail_stop_locked(exc)
        assert fail_exc is not None
        self._notify_failed(fail_exc)
        raise ShardFailedError(
            f"shard {self.shard_id} fail-stopped: {fail_exc}"
        ) from fail_exc

    def drop_generation(self, gen: int) -> int:
        """Range-delete a generation; returns records dropped."""
        fail_exc: Optional[BaseException] = None
        with self._lock:
            self._check_writable()
            try:
                lo = struct.pack(">H", gen)
                hi = struct.pack(">H", gen + 1)
                doomed = [k for k, _ in self.kv.scan(lo, hi)]
                for k in doomed:
                    self.kv.delete(k)
                if gen in self.generations and len(self.generations) > 1:
                    self.generations.remove(gen)
                self.kv.put(
                    _META_PREFIX + b"gens",
                    json.dumps(self.generations).encode(),
                )
                self.kv.flush()
                return len(doomed)
            except OSError as exc:
                fail_exc = exc
                self._fail_stop_locked(exc)
        assert fail_exc is not None
        self._notify_failed(fail_exc)
        raise ShardFailedError(
            f"shard {self.shard_id} fail-stopped: {fail_exc}"
        ) from fail_exc

    # --- streams / iterators --------------------------------------------

    def get_streams(self, shard_id: int, topic_filter: str) -> List[Stream]:
        fw = topic_mod.words(topic_filter)
        out = []
        for gen in self.generations:
            for static, constraints in self.lts.match_filter(fw):
                out.append(Stream(shard_id, gen, static, tuple(constraints)))
        return out

    def scan_stream(
        self,
        stream: Stream,
        topic_filter: str,
        after_key: bytes,
        start_time_ms: int,
        batch_size: int,
    ) -> Tuple[List[Tuple[bytes, Message]], bytes]:
        """Batch of (key, message) after `after_key`, plus resume key."""
        prefix = struct.pack(">HI", stream.generation, stream.static_key)
        if after_key:
            lo = after_key + b"\x00"
        else:
            lo = prefix + struct.pack(">Q", start_time_ms)
        hi = struct.pack(">HI", stream.generation, stream.static_key + 1)
        out: List[Tuple[bytes, Message]] = []
        last = after_key
        fw = topic_mod.words(topic_filter)
        for k, v in self.kv.scan(lo, hi):
            last = k
            msg, varying = deserialize_message(v)
            if not varying_match(varying, stream.constraints):
                continue
            # final authority: the pure matcher (oracle semantics)
            if not topic_mod.match(topic_mod.words(msg.topic), fw):
                continue
            out.append((k, msg))
            if len(out) >= batch_size:
                break
        return out, last

    def maybe_compact(self, ratio: float = 4.0, min_records: int = 1024) -> bool:
        """Compact when the WAL has bloated past `ratio`× the live key
        count — this is what BOUNDS recovery wall-time: replay cost is
        O(WAL records), so a broker that compacts on this schedule
        never faces an unboundedly long reboot replay. Returns True
        when a compaction ran."""
        with self._lock:
            if self.failed is not None:
                return False
            records = self.kv.wal_records()
            if records < min_records:
                return False
            if records <= ratio * max(1, self.kv.count()):
                return False
            self.kv.compact()
            return True

    def close(self) -> None:
        self.kv.close()

    def kill(self) -> None:
        """Simulated SIGKILL: drop the KV handle with no fsync
        boundary (data dir stays; graceful-close durability skipped)."""
        self.kv.kill()


class StorageLayer:
    """A named DS database: N shards on disk."""

    def __init__(
        self,
        name: str,
        data_dir: str,
        n_shards: int = 4,
        lts_threshold: int = 20,
        prefer_native: bool = True,
    ):
        self.name = name
        self.n_shards = n_shards
        self.dir = os.path.join(data_dir, name)
        os.makedirs(self.dir, exist_ok=True)
        # boot-side recovery ledger: how long the replay-on-open took —
        # the recovery_ms the restart scenario asserts a bound on
        t0 = time.monotonic()
        self.shards = [
            Shard(
                os.path.join(self.dir, f"shard_{i}.kv"),
                lts_threshold=lts_threshold,
                prefer_native=prefer_native,
                shard_id=i,
            )
            for i in range(n_shards)
        ]
        self.open_ms = (time.monotonic() - t0) * 1000.0
        # fan-in seam for shard fail-stops (alarm + flight wiring lives
        # with whoever owns the node: its boot, or a chaos run)
        self.on_shard_failed: Optional[Callable[[int, BaseException], None]] = None
        for s in self.shards:
            s.on_fail = self._shard_failed
        # a reboot re-derives read-only state: every shard that opened
        # is writable, so a stale pre-crash gauge must not survive it
        DS_METRICS.gauge("shard_read_only", len(self.failed_shards()))

    def _shard_failed(self, shard_id: int, exc: BaseException) -> None:
        DS_METRICS.gauge("shard_read_only", len(self.failed_shards()))
        cb = self.on_shard_failed
        if cb is not None:
            cb(shard_id, exc)

    def failed_shards(self) -> List[int]:
        return [s.shard_id for s in self.shards if s.failed is not None]

    def failstop_pending(self) -> List[int]:
        """The shards whose fail-stop fan-out (on_shard_failed) has not
        returned yet; it may run on the DS buffer's flush thread."""
        return [s.shard_id for s in self.shards
                if s.failstops_notified < s.failstops]

    def recover_shard(self, shard_id: int) -> bool:
        """One probe/reopen/replay/verify attempt; updates the
        read-only gauge and recovery timing on success."""
        t0 = time.monotonic()
        ok = self.shards[shard_id].recover()
        if ok:
            DS_METRICS.gauge("shard_read_only", len(self.failed_shards()))
            DS_METRICS.gauge(
                "recovery_last_ms", (time.monotonic() - t0) * 1000.0
            )
        return ok

    def maybe_compact(self, ratio: float = 4.0, min_records: int = 1024) -> List[int]:
        """Run the WAL-bloat compaction check on every healthy shard;
        returns the shard ids that compacted."""
        return [
            s.shard_id for s in self.shards if s.maybe_compact(ratio, min_records)
        ]

    def shard_of(self, msg: Message) -> int:
        # shard by publisher (the reference's emqx_ds clientid
        # sharding); crc32 = stable across restarts and across the two
        # packages, unlike hash()
        return zlib.crc32(msg.from_client.encode()) % self.n_shards

    def close(self) -> None:
        for s in self.shards:
            s.close()

    def kill(self) -> None:
        for s in self.shards:
            s.kill()
