"""The DS behaviour — emqx_ds analog (the port's own copy of
emqx_tpu/ds/api.py).

Mirrors apps/emqx_durable_storage/src/emqx_ds.erl:294-328: open_db /
store_batch / get_streams / make_iterator / next / poll, plus
add_generation / drop_generation for retention. Backends register like
the reference's emqx_ds_backends app; `builtin_local` is the
single-node backend (emqx_ds_builtin_local analog) over the native KV;
a replicated backend plugs in at the same seam (`Db.interceptor`),
which the port keeps although its replication plane is not ported yet.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..broker.message import Message
from .buffer import DsBuffer
from .storage import DsIterator, StorageLayer, Stream


class Db:
    """One opened DS database (builtin_local backend)."""

    def __init__(
        self,
        name: str,
        data_dir: str = "data/ds",
        n_shards: int = 4,
        lts_threshold: int = 20,
        prefer_native: bool = True,
        buffer_flush_ms: int = 10,
        buffer_max: int = 500,
    ):
        self.storage = StorageLayer(
            name, data_dir, n_shards, lts_threshold, prefer_native
        )
        self.buffer = DsBuffer(
            n_shards=n_shards,
            flush=self._flush_shard,
            flush_interval_ms=buffer_flush_ms,
            max_items=buffer_max,
        )
        self._watchers: List[Callable[[], None]] = []
        # replication seam: when set, write batches route through it
        # (shard_id, msgs) instead of the local storage — the
        # replication layer sits exactly here in the reference stack
        # (emqx_ds_buffer -> emqx_ds_replication_layer -> storage)
        self.interceptor: Optional[Callable[[int, List[Message]], None]] = None

    # --- write path -----------------------------------------------------

    def store_batch(self, msgs: Sequence[Message], sync: bool = True) -> None:
        """Direct (synchronous) batch store, grouped by shard."""
        by_shard: Dict[int, List[Message]] = {}
        for m in msgs:
            by_shard.setdefault(self.storage.shard_of(m), []).append(m)
        for sid, batch in by_shard.items():
            if self.interceptor is not None:
                self.interceptor(sid, batch)
            else:
                self.storage.shards[sid].store_batch(batch, sync=sync)
        if self.interceptor is None:
            self._notify()

    def store_async(self, msg: Message) -> None:
        """Buffered store through the per-shard batching buffer
        (emqx_ds_buffer analog)."""
        self.buffer.push(self.storage.shard_of(msg), msg)

    def _flush_shard(self, shard_id: int, msgs: List[Message]) -> None:
        if self.interceptor is not None:
            self.interceptor(shard_id, msgs)
            return
        self.storage.shards[shard_id].store_batch(msgs, sync=True)
        self._notify()

    def apply_local(self, shard_id: int, msgs: Sequence[Message]) -> None:
        """Replication-layer apply: write straight to local storage,
        bypassing the interceptor (the replica side of the log)."""
        self.storage.shards[shard_id].store_batch(list(msgs), sync=True)
        self._notify()

    # --- read path ------------------------------------------------------

    def get_streams(self, topic_filter: str, start_time_ms: int = 0) -> List[Stream]:
        out: List[Stream] = []
        for sid, shard in enumerate(self.storage.shards):
            out.extend(shard.get_streams(sid, topic_filter))
        return out

    def make_iterator(
        self, stream: Stream, topic_filter: str, start_time_ms: int = 0
    ) -> DsIterator:
        return DsIterator(stream=stream, filter=topic_filter, after_key=b"")

    def next(
        self, it: DsIterator, batch_size: int = 100, start_time_ms: int = 0
    ) -> Tuple[DsIterator, List[Message]]:
        shard = self.storage.shards[it.stream.shard]
        rows, last = shard.scan_stream(
            it.stream, it.filter, it.after_key, start_time_ms, batch_size
        )
        new_it = DsIterator(stream=it.stream, filter=it.filter, after_key=last)
        return new_it, [m for _k, m in rows]

    def poll(self, watcher: Callable[[], None]) -> None:
        """Register a new-data callback (the beamformer-lite seam:
        emqx_ds_beamformer groups poll requests; here consumers get a
        wakeup per flushed batch and drain via next())."""
        self._watchers.append(watcher)

    def unpoll(self, watcher: Callable[[], None]) -> None:
        if watcher in self._watchers:
            self._watchers.remove(watcher)

    def _notify(self) -> None:
        for w, watcher in enumerate(list(self._watchers)):
            try:
                watcher()
            except Exception:
                pass

    # --- retention ------------------------------------------------------

    def add_generation(self) -> None:
        for s in self.storage.shards:
            s.add_generation()

    def drop_generation(self, gen: int) -> int:
        return sum(s.drop_generation(gen) for s in self.storage.shards)

    def generations(self) -> List[int]:
        return list(self.storage.shards[0].generations)

    # --- crash consistency ----------------------------------------------

    def failed_shards(self) -> List[int]:
        return self.storage.failed_shards()

    def failstop_pending(self) -> List[int]:
        return self.storage.failstop_pending()

    def recover_shard(self, shard_id: int) -> bool:
        return self.storage.recover_shard(shard_id)

    def maybe_compact(
        self, ratio: float = 4.0, min_records: int = 1024
    ) -> List[int]:
        """WAL-bloat compaction sweep — the knob that bounds replay
        (and therefore restart-recovery) wall-time."""
        return self.storage.maybe_compact(ratio, min_records)

    def recovery_report(self) -> Dict[str, object]:
        """What the WAL replay found at open (plus current health) —
        surfaced by the node's boot after a restart and asserted by the
        broker_restart scenario."""
        shards = []
        for s in self.storage.shards:
            shards.append(
                {
                    "shard": s.shard_id,
                    "replayed_records": int(s.kv.wal_records()),
                    "live_keys": int(s.kv.count()),
                    "torn_records": int(s.kv.torn_records),
                    "crc_failures": int(s.kv.crc_failures),
                    "failed": s.failed,
                }
            )
        return {"open_ms": round(self.storage.open_ms, 3), "shards": shards}

    def close(self) -> None:
        self.buffer.close()
        self.storage.close()

    def kill(self) -> None:
        """Simulated SIGKILL teardown: drop in-memory state (pending
        buffer items included), keep the data dir, skip every graceful
        close — the state a real crash leaves behind."""
        self.buffer.kill()
        self.storage.kill()


_DBS: Dict[str, Db] = {}
_LOCK = threading.Lock()


def open_db(name: str, **opts) -> Db:
    """Process-wide DB registry (emqx_ds:open_db)."""
    with _LOCK:
        db = _DBS.get(name)
        if db is None:
            db = Db(name, **opts)
            _DBS[name] = db
        return db


def close_db(name: str) -> None:
    with _LOCK:
        db = _DBS.pop(name, None)
    if db is not None:
        db.close()


def kill_db(name: str) -> None:
    """Simulated-SIGKILL variant of close_db: the DB leaves the
    registry with no fsync boundary and no buffer flush."""
    with _LOCK:
        db = _DBS.pop(name, None)
    if db is not None:
        db.kill()
