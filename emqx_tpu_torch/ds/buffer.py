"""Per-shard write batching — emqx_ds_buffer analog (the port's own
copy of emqx_tpu/ds/buffer.py).

Accumulates messages per shard and flushes on size or age, from a
single background thread (the reference runs one buffer process per
shard; one thread suffices here since flush fans out per shard).

Unlike the reference's copy, the buffer counts the flushes a shard
refused (`refused`, per shard) on whichever thread flushed them, and
the flushes in flight (`flushing`): a refused write taken by the
background thread is then as visible as one taken by a direct
`flush_now()` caller. `park()`/`unpark()` stop and restart the
background thread.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional

log = logging.getLogger("emqx_tpu_torch.ds.buffer")


class DsBuffer:
    def __init__(
        self,
        n_shards: int,
        flush: Callable[[int, List], None],
        flush_interval_ms: int = 10,
        max_items: int = 500,
    ):
        self.flush_cb = flush
        self.flush_interval = flush_interval_ms / 1000.0
        self.max_items = max_items
        self._pending: Dict[int, List] = {i: [] for i in range(n_shards)}
        # flushes each shard refused (the flush callback raised), on
        # every thread that flushed; flushes with a batch in hand
        self.refused: Dict[int, int] = {i: 0 for i in range(n_shards)}
        self.flushing = 0
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def push(self, shard: int, item) -> None:
        kick = False
        with self._lock:
            q = self._pending[shard]
            q.append(item)
            if len(q) >= self.max_items:
                kick = True
        if kick:
            self._wake.set()

    def flush_now(self) -> None:
        with self._lock:
            batches = {s: q for s, q in self._pending.items() if q}
            for s in batches:
                self._pending[s] = []
            if not batches:
                return
            self.flushing += 1
        # one shard's fail-stop must not starve the healthy shards'
        # flushes; the first error still surfaces to a direct caller
        # (the storage layer already fail-stopped the shard itself)
        first: Optional[BaseException] = None
        try:
            for s, q in batches.items():
                try:
                    self.flush_cb(s, q)
                except Exception as exc:
                    with self._lock:
                        self.refused[s] += 1
                    if first is None:
                        first = exc
        finally:
            with self._lock:
                self.flushing -= 1
        if first is not None:
            raise first

    def _run(self) -> None:
        while not self._stop:
            self._wake.wait(self.flush_interval)
            self._wake.clear()
            if self._stop:
                break
            try:
                self.flush_now()
            except Exception:
                # the background thread must survive a fail-stopped
                # shard (its writes are refused until recover())
                log.exception("background flush failed")

    def park(self) -> None:
        """Stop the background thread (its flush in hand finishes
        first); pushes then wait for `flush_now()` or `unpark()`."""
        self._stop = True
        self._wake.set()
        self._thread.join()

    def unpark(self) -> None:
        """Restart the background thread after `park()`."""
        if self._thread.is_alive():
            return
        self._stop = False
        self._wake.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=2)
        self.flush_now()

    def kill(self) -> None:
        """Simulated SIGKILL: stop the flush thread and DROP pending
        items — unflushed buffer contents were never acknowledged as
        durable, so a crash is allowed to lose exactly these."""
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=2)
        with self._lock:
            for s in self._pending:
                self._pending[s] = []
