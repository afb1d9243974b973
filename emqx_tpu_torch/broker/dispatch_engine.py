"""Pipelined async dispatch engine for the publish hot path
(counterpart of emqx_tpu/broker/dispatch_engine.py for the port).

The host-side dispatch discipline that keeps the card fed, the
emqx_broker pool-worker batching analog re-shaped for an accelerator
link:

  * **Micro-batching queue** — concurrent publishes coalesce into one
    kernel launch. The batch closes adaptively: flush when
    `queue_depth` publishes are waiting OR when the oldest enqueued
    publish has waited `DEADLINE_S`, whichever comes first.

  * **Pipelining** — a flush only LAUNCHES the batch
    (Router.match_filters_begin: cache probe, encode, host-to-device
    copy, kernel launch); the device-to-host fetch + fanout
    (match_filters_finish) happens on a later event-loop turn, or when
    the in-flight window exceeds `pipeline_depth`. CUDA launches are
    asynchronous and the device tables update in place on the same
    stream, so while batch N runs on the card the host encodes batch
    N+1 and drains the results of batch N-1.

  * **Generation-stamped match cache** — in front of the queue,
    Router's GenMatchCache resolves hot topics with one dict probe and
    no kernel at all; route mutations bump the router generation and
    stale entries lazily rebuild.

  * **Fanout-resolve overlap** — topics the match cache answers at
    begin time have known filter sets before the kernel fetch: their
    stale/missing fanout plans launch `Router.resolve_fanout_begin`
    (kernel K5) in the same flush, so the deduped plan materializes on
    the card while the match fetch for the uncached remainder is still
    in flight; plans install stamped with the begin-time clock
    (stale-on-arrival if a mutation landed mid-flight).

  * **Admission control** — the dispatch queue is bounded
    (`queue_max_depth` outstanding publishes). Overload either SHEDS
    (fail fast with `QueueOverloadError`) or BLOCKS (publishers park on
    a waiter list drained as capacity frees, failing with
    `QueueDeadlineExceeded` past `queue_deadline_ms`) per
    `queue_policy`.

Exactness contract: every result comes from the same begin/finish code
path `Broker.publish_batch` composes, and delivery runs through the
same `Broker._pre_publish`/`Broker.dispatch_window`.

Left out of the port for now: the device circuit breaker, its canary
probe and the shard breaker (they need the host re-serve legs the port
does not have yet), the publish sentinel and the rule batcher. A device
fault fails the futures of the publishes it touched with the fault
itself; nothing is served from the host in its place.

Telemetry: queue-wait histogram family `pipeline_queue_wait_seconds`,
gauges `pipeline_depth` / `pipeline_coalesce` / `queue_depth`, counters
`fanout_resolves_overlapped_total`, `publish_failures_total`,
`queue_shed_total`, `queue_blocked_total`,
`queue_deadline_expired_total`, and the ring's launch->land spans
(`ring_slot_span_seconds`, `ring_gap_seconds`,
`ring_occupancy_ratio`).
"""

from __future__ import annotations

import asyncio
import gc
from collections import deque
from typing import Deque, Dict, List, Optional

from ..obs.profiler import STAGE_MARK
from .message import Message

# a batch below queue_depth flushes once its oldest publish waited this
DEADLINE_S = 0.0005
# entries of the router's generation-stamped topic -> filters cache
MATCH_CACHE_SIZE = 8192

class EngineStopped(RuntimeError):
    """The dispatch engine stopped; a publish submitted after stop()
    fails at once instead of hanging."""


class QueueOverloadError(RuntimeError):
    """Admission control shed this publish (queue at high watermark
    under the `shed` policy) — fail fast, counted."""


class QueueDeadlineExceeded(RuntimeError):
    """A blocked publish waited past `queue_deadline_ms` for queue
    capacity — the engine fails it rather than hanging the publisher."""


class _AggregateCount:
    """Future-compatible shim folding N per-publish delivery counts
    into ONE awaitable — the storm surface (submit_many) enqueues a
    whole chunk against a single future."""

    __slots__ = ("_fut", "_left", "_total")

    def __init__(self, fut: "asyncio.Future", n: int) -> None:
        self._fut = fut
        self._left = n
        self._total = 0

    def done(self) -> bool:
        return self._fut.done()

    def set_result(self, n: int) -> None:
        self._total += n
        self._left -= 1
        if self._left <= 0 and not self._fut.done():
            self._fut.set_result(self._total)

    def set_exception(self, exc: BaseException) -> None:
        self._left -= 1
        if not self._fut.done():
            self._fut.set_exception(exc)

    def add_many(self, total: int, k: int) -> None:
        """Fold k publishes' combined count in ONE call."""
        self._total += total
        self._left -= k
        if self._left <= 0 and not self._fut.done():
            self._fut.set_result(self._total)


class DispatchEngine:
    """One engine per Broker. All entry points must run on the
    broker's event loop; the engine holds no locks — ordering comes
    from the loop plus the FIFO in-flight window (begin/finish pairs
    complete strictly in begin order, the Router contract)."""

    def __init__(
        self,
        broker,
        queue_depth: int = 64,
        pipeline_depth: int = 2,
        queue_max_depth: int = 8192,
        queue_policy: str = "shed",
        queue_deadline_ms: float = 1000.0,
        transfer_chunk_kb: float = 0.0,
    ) -> None:
        self.broker = broker
        self.router = broker.router
        self.router.enable_match_cache(MATCH_CACHE_SIZE)
        self.telemetry = self.router.telemetry
        self.queue_depth = max(1, queue_depth)
        self.pipeline_depth = max(1, pipeline_depth)
        # --- admission control knobs
        self.queue_max_depth = max(1, queue_max_depth)
        if queue_policy not in ("shed", "block"):
            raise ValueError(f"queue_policy must be shed or block, not {queue_policy!r}")
        self.queue_policy = queue_policy
        self.queue_deadline_s = max(0.001, queue_deadline_ms) / 1e3
        # blocked publishers resume once outstanding work falls here
        self.queue_low_watermark = max(1, self.queue_max_depth // 2)
        # --- transfer pipeline knobs (ops/transfer.py)
        # chunk_kb: bound on a ring slot's compacted-result buffer;
        # 0 = auto-size from the link probe at warmup (BDP).
        self.transfer_chunk_kb = float(transfer_chunk_kb)
        self.warmed = False
        self._queue: List[tuple] = []  # (msg, future, enqueue clock)
        # launched-but-uncollected batches:
        # (pending match, entries, overlapped resolves, launch clock)
        self._inflight: Deque[tuple] = deque()
        self._inflight_pubs = 0  # publishes inside _inflight entries
        self._waiters: Deque[tuple] = deque()  # block-policy parked items
        self._timer = None
        self._waiter_timer = None
        self._drain_scheduled = False
        self._pumping = False
        self._overloaded = False
        self.batches_total = 0
        self.publishes_total = 0
        self.closed = False
        # device-occupancy timeline: launch->land spans per ring slot,
        # the busy-time integral over empty->nonempty transitions of
        # _inflight, and the idle gaps between lands
        self._ring_track_since: Optional[float] = None
        self._ring_busy_since: Optional[float] = None
        self._ring_last_land: Optional[float] = None
        self._ring_busy_accum = 0.0
        self._ring_slots_total = 0
        tel = self.telemetry
        if tel.enabled:
            tel.set_gauge("queue_depth", 0)
            tel.set_gauge("queue_waiters", 0)
            tel.set_gauge("queue_overloaded", 0)

    # --- warmup: chunk sizing + shape warm-up + GC discipline ------------

    def warmup(self) -> dict:
        """One-time serve-readiness pass (idempotent):

          1. size the transfer chunk — `transfer_chunk_kb` as given, or
             auto from a link probe (RTT floor x fetch bandwidth, the
             BDP, kernel K12) — and push it into the device table;
          2. run every launch-shape bucket the engine can dispatch
             (pow2 batch ladder up to queue_depth through the REAL
             begin/finish halves);
          3. freeze the now-steady object graph out of the cyclic
             collector (gc.freeze) so gen-2 passes never scan the
             table/session bulk from inside a launch.

        A device fault in any step raises. Returns a summary dict."""
        from ..ops import transfer as transfer_ops

        router = self.router
        info: dict = {}
        chunk_kb = self.transfer_chunk_kb
        if not chunk_kb:
            rtt_s, bw = transfer_ops.probe_link(router.device)
            chunk_kb = transfer_ops.auto_chunk_kb(rtt_s, bw)
            info["link_rtt_ms"] = round(rtt_s * 1e3, 3)
            info["link_mb_per_s"] = round(bw / 1e6, 1)
        router.set_transfer_chunk(chunk_kb)
        self.transfer_chunk_kb = chunk_kb
        info["transfer_chunk_kb"] = chunk_kb
        info["aot_shapes"] = router.warmup_shapes(self.queue_depth)
        if router.mesh is not None:
            # the mesh's serve state at readiness: its shard count
            info["mesh_shards"] = router.device_table.n_shards
        if not self.warmed:
            gc.collect()
            gc.freeze()
        self.warmed = True
        return info

    def _gc_pause(self) -> bool:
        """Suspend the cyclic collector for a launch/collect critical
        section; returns whether it was running (restore token)."""
        was = gc.isenabled()
        if was:
            gc.disable()
        return was

    @staticmethod
    def _gc_resume(was: bool) -> None:
        if was:
            gc.enable()

    # --- async publish surface -------------------------------------------

    async def publish(self, msg: Message) -> int:
        """Enqueue one publish and await its delivery count. The
        pipelined analog of Broker.publish — identical hooks, identical
        match results, identical dispatch."""
        return await self.submit(msg)

    def _check_open(self) -> None:
        if self.closed:
            raise EngineStopped("dispatch engine stopped")

    def submit(self, msg: Message) -> "asyncio.Future":
        """Enqueue without awaiting; returns the delivery-count future.
        Flushes immediately at queue_depth, else arms the deadline
        timer for the batch the first enqueue opened."""
        self._check_open()
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        if self._admit((msg, fut, self.telemetry.clock()), loop):
            if len(self._queue) >= self.queue_depth:
                self._flush()
            elif self._timer is None:
                self._timer = loop.call_later(
                    DEADLINE_S, self._on_deadline
                )
        return fut

    def submit_many(self, msgs) -> "asyncio.Future":
        """Storm surface: enqueue a chunk of publishes as one unit and
        return ONE future resolving to the summed delivery count. Same
        hooks and match path as submit(); admission control applies per
        message: a shed message fails the aggregate."""
        self._check_open()
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        if not msgs:
            fut.set_result(0)
            return fut
        agg = _AggregateCount(fut, len(msgs))
        clock = self.telemetry.clock
        for msg in msgs:
            # _flush REPLACES self._queue with a fresh list — re-read
            # it each append rather than holding a stale binding
            if self._admit((msg, agg, clock()), loop):
                if len(self._queue) >= self.queue_depth:
                    self._flush()
        if self._queue and self._timer is None:
            self._timer = loop.call_later(DEADLINE_S, self._on_deadline)
        return fut

    # --- admission control (the emqx_olp analog) --------------------------

    def outstanding(self) -> int:
        """Publishes the engine currently owns: batched + in flight.
        Blocked waiters are excluded — they ARE the backpressure."""
        return len(self._queue) + self._inflight_pubs

    def _admit(self, item: tuple, loop) -> bool:
        """True when the item entered the batch queue; False when it
        was shed (future failed) or parked on the waiter list."""
        tel = self.telemetry
        if self.outstanding() < self.queue_max_depth:
            self._queue.append(item)
            return True
        self._overload(tel)
        if self.queue_policy == "block":
            tel.count("queue_blocked_total")
            self._waiters.append(item)
            tel.set_gauge("queue_waiters", len(self._waiters))
            if self._waiter_timer is None:
                self._waiter_timer = loop.call_later(
                    self.queue_deadline_s / 2, self._expire_waiters
                )
            return False
        tel.count("queue_shed_total")
        _msg, fut, _t = item
        if not fut.done():
            fut.set_exception(
                QueueOverloadError(
                    f"dispatch queue overloaded "
                    f"({self.outstanding()}/{self.queue_max_depth} "
                    f"outstanding, policy=shed)"
                )
            )
        return False

    def _overload(self, tel) -> None:
        if self._overloaded:
            return
        self._overloaded = True
        tel.set_gauge("queue_overloaded", 1)

    def _maybe_clear_overload(self) -> None:
        if not self._overloaded:
            return
        if self.outstanding() > self.queue_low_watermark or self._waiters:
            return
        self._overloaded = False
        self.telemetry.set_gauge("queue_overloaded", 0)

    def _deadline_error(self, waited: float) -> QueueDeadlineExceeded:
        return QueueDeadlineExceeded(
            f"waited {waited:.3f}s for queue capacity "
            f"(deadline {self.queue_deadline_s:.3f}s)"
        )

    def _pump_waiters(self) -> None:
        """Admit parked publishers as capacity frees (block policy).
        Re-entrancy guarded: pumping flushes, flushes collect, and a
        collect completion calls back in here."""
        if self._pumping or not self._waiters:
            return
        self._pumping = True
        tel = self.telemetry
        now = tel.clock()
        try:
            while self._waiters and (
                self.outstanding() < self.queue_max_depth
            ):
                item = self._waiters.popleft()
                _msg, fut, t_in = item
                if fut.done():
                    continue
                if now - t_in > self.queue_deadline_s:
                    tel.count("queue_deadline_expired_total")
                    fut.set_exception(self._deadline_error(now - t_in))
                    continue
                self._queue.append(item)
                if len(self._queue) >= self.queue_depth:
                    self._flush()
        finally:
            self._pumping = False
            tel.set_gauge("queue_waiters", len(self._waiters))
        self._maybe_clear_overload()

    def _expire_waiters(self) -> None:
        """Waiter-deadline sweep: a blocked publisher past its queue
        deadline fails deterministically — a wedged device can slow
        the broker, never hang its publishers."""
        self._waiter_timer = None
        tel = self.telemetry
        now = tel.clock()
        keep: Deque[tuple] = deque()
        expired = 0
        while self._waiters:
            item = self._waiters.popleft()
            _msg, fut, t_in = item
            if fut.done():
                continue
            if now - t_in > self.queue_deadline_s:
                expired += 1
                fut.set_exception(self._deadline_error(now - t_in))
            else:
                keep.append(item)
        self._waiters = keep
        if expired:
            tel.count("queue_deadline_expired_total", expired)
        tel.set_gauge("queue_waiters", len(self._waiters))
        if self._waiters and not self.closed:
            self._waiter_timer = asyncio.get_running_loop().call_later(
                self.queue_deadline_s / 2, self._expire_waiters
            )
        else:
            self._maybe_clear_overload()

    def _on_deadline(self) -> None:
        self._timer = None
        if self._queue:
            self._flush()

    # --- batch close + pipeline ------------------------------------------

    def _fail_batch(self, entries, exc: BaseException) -> None:
        """A device fault on this batch's path: every publisher in it
        sees the fault itself (counted); nothing is served in its
        place."""
        self.telemetry.count("publish_failures_total", len(entries))
        for _live, fut in entries:
            if not fut.done():
                fut.set_exception(exc)

    def _flush(self) -> None:
        """Close the current batch: run the publish hooks, LAUNCH the
        match kernels (no device->host fetch) and the overlapped plan
        resolves, and push the pending batch onto the in-flight window.
        Collection happens on a later loop turn (_drain) or immediately
        for whatever exceeds the pipeline depth."""
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        batch, self._queue = self._queue, []
        # collector pauses must not land inside the launch window; the
        # pause spans launch + any forced over-depth collects and
        # restores on exit, so collection happens BETWEEN batches
        gc_tok = self._gc_pause()
        try:
            tel = self.telemetry
            broker = self.broker
            router = self.router
            now = tel.clock()
            entries = []
            topics = []
            STAGE_MARK.stage = "coalesce"
            for msg, fut, t_in in batch:
                tel.observe_family("pipeline_queue_wait_seconds", now - t_in)
                live = broker._pre_publish(msg)
                entries.append((live, fut))
                if live is not None:
                    topics.append(live.topic)
            STAGE_MARK.stage = ""
            self.batches_total += 1
            self.publishes_total += len(batch)
            STAGE_MARK.stage = "match_launch"
            try:
                pending = router.match_filters_begin(topics)
                # device-resolved fanout overlap: topics the match cache
                # answered at begin time have known filter sets NOW —
                # launch their plan resolves immediately so the deduped
                # plan materializes on the card while the match fetch
                # for the uncached remainder is still in flight
                STAGE_MARK.stage = "plan_resolve"
                fanout_pending = self._begin_overlapped(pending)
            except Exception as e:
                STAGE_MARK.stage = ""
                self._fail_batch(entries, e)
                self._batch_failed()
                return
            STAGE_MARK.stage = ""
            t_launch = tel.clock()
            if self._ring_track_since is None:
                self._ring_track_since = t_launch
            if self._ring_busy_since is None:
                # empty->nonempty transition: the gap since the last
                # land is device idle time
                self._ring_busy_since = t_launch
                if self._ring_last_land is not None:
                    tel.observe_family(
                        "ring_gap_seconds", t_launch - self._ring_last_land
                    )
            self._inflight.append((pending, entries, fanout_pending, t_launch))
            self._inflight_pubs += len(entries)
            tel.set_gauge("pipeline_depth", len(self._inflight))
            tel.set_gauge("pipeline_coalesce", len(batch))
            tel.set_gauge("queue_depth", self.outstanding())
            while len(self._inflight) > self.pipeline_depth:
                self._collect_one()
        finally:
            self._gc_resume(gc_tok)
        if self._inflight and not self._drain_scheduled:
            self._drain_scheduled = True
            asyncio.get_running_loop().call_soon(self._drain)

    def _begin_overlapped(self, pending):
        """Launch K5 for every distinct cached filter set of a begun
        batch whose plan is missing or stale; [(key, clock, handle)]
        or None."""
        if pending.full_out is None:
            return None
        broker = self.broker
        router = self.router
        out = None
        seen = set()
        tel = self.telemetry
        for flts in pending.full_out:
            if flts is None:
                continue
            fkey = tuple(flts)
            if fkey in seen:
                continue
            seen.add(fkey)
            if broker._plan_fresh(fkey):
                continue
            h = router.resolve_fanout_begin(
                fkey, min_fan=broker._fanout_min_fan
            )
            if h is not None:
                if tel.enabled:
                    tel.count("fanout_resolves_overlapped_total")
                if out is None:
                    out = []
                out.append((fkey, broker._fanout_clock, h))
        return out

    # seconds between readiness re-probes while the ring head's
    # transfer is still in flight (the loop is yielded, not blocked)
    _RING_POLL_S = 0.0002

    def _head_ready(self) -> bool:
        """True when collecting the ring head will not block: the
        match legs' AND any overlapped fanout resolves' transfer
        tickets have all landed host-side."""
        pending, _entries, fanout_pending, _t = self._inflight[0]
        if not self.router.match_finish_ready(pending):
            return False
        if fanout_pending is not None:
            for _fkey, _clock, h in fanout_pending:
                if not h[0].ready():
                    return False
        return True

    def _drain(self) -> None:
        """Collect ring slots without ever blocking the event loop on a
        transfer still in flight: delivery order stays strictly begin
        order (the Router's finish contract), but a head whose transfer
        has not landed yields the loop and re-probes. Over-depth slots
        still force-collect (the ring is the backpressure bound)."""
        self._drain_scheduled = False
        while self._inflight:
            if (
                len(self._inflight) > self.pipeline_depth
                or self._head_ready()
            ):
                self._collect_one()
                continue
            self._drain_scheduled = True
            asyncio.get_running_loop().call_later(
                self._RING_POLL_S, self._drain
            )
            return
        self.telemetry.set_gauge("pipeline_depth", 0)

    def _collect_one(self) -> None:
        """Fetch + deliver the OLDEST in-flight batch (begin order)."""
        pending, entries, fanout_pending, t_launch = self._inflight.popleft()
        broker = self.broker
        router = self.router
        tel = self.telemetry
        tclock = tel.clock
        gc_tok = self._gc_pause()
        try:
            STAGE_MARK.stage = "match_fetch"
            try:
                filter_lists = router.match_filters_finish(pending)
                if fanout_pending is not None:
                    # install the overlapped plans before delivering:
                    # stamped with the clock captured at begin, so a
                    # mutation that landed mid-flight leaves them
                    # stale-on-arrival and the dispatch below rebuilds
                    STAGE_MARK.stage = "plan_resolve"
                    for fkey, clock, h in fanout_pending:
                        broker._store_plan(
                            fkey, clock, router.resolve_fanout_finish(h)
                        )
            except Exception as e:
                STAGE_MARK.stage = ""
                self._ring_land(tclock(), t_launch, "failed", len(entries))
                self._fail_batch(entries, e)
                self._batch_done(len(entries))
                return
            STAGE_MARK.stage = ""
            self._ring_land(tclock(), t_launch, pending.mode, len(entries))
            # the vectorized delivery half: ONE window dispatch for the
            # whole collected batch (plan resolution per unique filter
            # set, session-grouped writes)
            results, _meta = broker.dispatch_window(
                [e[0] for e in entries], filter_lists, capture_errors=True
            )
            # aggregate completion: consecutive publishes sharing a
            # submit_many aggregate fold into one add_many
            pend_fut = None
            pend_total = 0
            pend_k = 0

            def _flush_agg() -> None:
                nonlocal pend_fut, pend_total, pend_k
                if pend_fut is None:
                    return
                if type(pend_fut) is _AggregateCount:
                    pend_fut.add_many(pend_total, pend_k)
                elif not pend_fut.done():
                    pend_fut.set_result(pend_total)
                pend_fut = None
                pend_total = 0
                pend_k = 0

            for idx, (_live, fut) in enumerate(entries):
                n = results[idx]
                if isinstance(n, BaseException):
                    # the publisher sees its failure (counted)
                    _flush_agg()
                    tel.count("publish_failures_total")
                    if not fut.done():
                        fut.set_exception(n)
                    continue
                if fut is pend_fut:
                    pend_total += n
                    pend_k += 1
                else:
                    _flush_agg()
                    pend_fut = fut
                    pend_total = n
                    pend_k = 1
            _flush_agg()
            self._batch_done(len(entries))
        finally:
            self._gc_resume(gc_tok)

    def _batch_failed(self) -> None:
        if self._waiters:
            self._pump_waiters()
        else:
            self._maybe_clear_overload()

    def _batch_done(self, n_pubs: int) -> None:
        self._inflight_pubs -= n_pubs
        self._batch_failed()

    # --- device-occupancy timeline ---------------------------------------

    def _ring_land(
        self, t_land: float, t_launch: float, mode: str, n_pubs: int
    ) -> None:
        """One ring slot landed: record its launch->land span and close
        the busy segment when the ring just went empty."""
        tel = self.telemetry
        self._ring_slots_total += 1
        self._ring_last_land = t_land
        tel.observe_family("ring_slot_span_seconds", t_land - t_launch)
        if not self._inflight and self._ring_busy_since is not None:
            self._ring_busy_accum += t_land - self._ring_busy_since
            self._ring_busy_since = None
            tel.set_gauge("ring_occupancy_ratio", self._ring_occupancy())

    def _ring_occupancy(self) -> float:
        """Busy-time fraction of the ring (some batch in flight) since
        tracking began, on the host clock."""
        since = self._ring_track_since
        if since is None:
            return 0.0
        now = self.telemetry.clock()
        busy = self._ring_busy_accum
        if self._ring_busy_since is not None:
            busy += now - self._ring_busy_since
        elapsed = now - since
        return min(1.0, busy / elapsed) if elapsed > 0 else 0.0

    def ring_status(self) -> Dict:
        return {
            "slots_total": self._ring_slots_total,
            "occupancy_ratio": round(self._ring_occupancy(), 6),
            "busy_seconds": round(self._ring_busy_accum, 6),
        }

    # --- lifecycle --------------------------------------------------------

    async def drain(self) -> None:
        """Flush the open batch, admit + serve every blocked waiter,
        and collect everything in flight."""
        while self._queue or self._inflight or self._waiters:
            if self._waiters:
                self._pump_waiters()
            if self._queue:
                self._flush()
            while self._inflight:
                self._collect_one()
            if not (self._queue or self._waiters):
                break
        await asyncio.sleep(0)  # let resolved futures' awaiters run

    async def stop(self) -> None:
        """Stop the engine: complete everything queued and in flight,
        then refuse new publishes (EngineStopped)."""
        if self.closed:
            return
        await self.drain()
        self.closed = True
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if self._waiter_timer is not None:
            self._waiter_timer.cancel()
            self._waiter_timer = None
        if self.warmed:
            # hand the frozen steady state back to the collector — a
            # stopped engine's broker graph must stay reclaimable
            gc.unfreeze()
        await asyncio.sleep(0)
