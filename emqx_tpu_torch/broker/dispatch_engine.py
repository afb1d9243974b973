"""Pipelined async dispatch engine for the publish hot path
(counterpart of emqx_tpu/broker/dispatch_engine.py for the port).

The host-side dispatch discipline that keeps the card fed, the
emqx_broker pool-worker batching analog re-shaped for an accelerator
link:

  * **Micro-batching queue** — concurrent publishes coalesce into one
    kernel launch. The batch closes adaptively: flush when
    `queue_depth` publishes are waiting OR when the oldest enqueued
    publish has waited `deadline_ms`, whichever comes first.

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

**Device failure domain** (the emqx_olp analog for the card):

  * **Failover** — a device batch whose leg raises (a CUDA error,
    injected or real, at launch, at the fetch, at a plan resolve, or
    when its transfer's readiness is polled) or that blows the
    per-batch `breaker_deadline_ms` is re-served through the host
    match walk (`Router.match_filters_host`, identical answers by the
    oracle contract), so publishers never see a transient device
    fault. Only a device fault (`chaos.faults.is_device_fault`: the
    injected DeviceLinkError family or a CUDA runtime error) is
    re-served. A kernel that fails to build or launch, or any other
    exception of the port's own code, fails the publishes it touched
    with itself, and raises out of `warmup`. Nothing else is served
    from the host: a batch whose device legs succeed is the card's
    answer.

  * **Circuit breaker** — `breaker_threshold` CONSECUTIVE device
    failures trip the breaker: `Router.suspend_device()` routes ALL
    match and fanout traffic host-side (degraded but correct), the
    `xla_device_breaker` alarm raises (the reference's name, kept), and
    the flight recorder records a `breaker.trip` event and freezes a
    `device_breaker_trip` bundle.

  * **Shard breaker** — on a mesh, a failure whose exception carries
    a `shard` (a fault of one chip of a ShardedDeviceTable) counts in
    that shard's own ledger and never toward the whole-device breaker.
    `breaker_threshold` of them trip the shard: `Router.suspend_shard`
    answers its slice from host truth, the same alarm and flight
    trigger fire, and `Router.evacuate_shard` re-shards the table over
    the surviving chips and re-uploads it in full, so the mesh serves
    the whole table at N-1. A per-shard probe (`probe_shard_once`)
    probes the chip, rebalances it back, re-uploads and verifies a
    canary against the host oracle; a divergent canary evacuates the
    chip again. An evacuation that fails with a device fault leaves
    the slice host-overlaid (counted); any other error raises.

  * **Recovery** — a background canary probe with bounded exponential
    backoff (`probe_once`, also callable directly) re-dispatches recent
    topics through the real kernels; on success it re-uploads FULL
    device state from host truth (`Router.device_resync`) and verifies
    a second canary against the host oracle before closing the breaker
    and clearing the alarm. A sticky CUDA context error (an illegal
    address, an ECC fault) poisons the process's context: every probe
    then fails, the breaker stays open and the host serves until the
    process restarts. The close records `breaker.close` in the flight
    recorder's ring.

**Publish sentinel** (obs/sentinel.py, when attached as
`broker.sentinel`): `submit`/`submit_many` give 1/sample_n publishes a
StageSpan (every other publish pays one attribute read and one counter
tick); `_flush` splits its `queue` wait into `submit_wait` and
`coalesce` and hands the batch's span to `match_filters_begin`
(encode/kernel); `_collect_one` adds transfer/fetch through finish and
`resolve` for the overlapped plans, finishes each sampled span and
queues the shadow-oracle audit of exactly what served, stamped with the
batch's begin generation.

**Rule batcher**: when a rule engine with `batch_where_enabled` is
installed (`broker.rule_batcher`), `_flush` opens its batched-WHERE
window around the coalesce loop; the window drains at its close, under
the `coalesce` stage mark, before the match launch.

Telemetry: queue-wait histogram family `pipeline_queue_wait_seconds`,
gauges `pipeline_depth` / `pipeline_coalesce` / `queue_depth` /
`breaker_state` / `breaker_consecutive_failures` /
`breaker_open_shards`, counters
`fanout_resolves_overlapped_total`, `publish_failures_total`,
`queue_shed_total`, `queue_blocked_total`,
`queue_deadline_expired_total`, the breaker's `breaker_*` family
(device failures, begin failures, fallbacks, deadline expiries, trips,
probes, probe failures, recoveries, and the shard breaker's trips,
evacuations, evacuation failures and recoveries), `fanout_host_fallback_total`, and
the ring's launch->land spans (`ring_slot_span_seconds`,
`ring_gap_seconds`, `ring_occupancy_ratio`).
"""

from __future__ import annotations

import asyncio
import contextlib
import gc
import logging
from collections import deque
from typing import Deque, Dict, List, Optional, Set

from ..chaos.faults import DeviceLinkError, is_device_fault
from ..obs.profiler import STAGE_MARK
from .message import Message

log = logging.getLogger("emqx_tpu_torch.broker.dispatch_engine")

# a batch below queue_depth flushes once its oldest publish waited this
DEADLINE_S = 0.0005
# entries of the router's generation-stamped topic -> filters cache
MATCH_CACHE_SIZE = 8192

ALARM_BREAKER = "xla_device_breaker"

# breaker_state gauge encoding
_STATE_GAUGE = {"closed": 0, "open": 1, "half_open": 2}

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
        deadline_ms: float = DEADLINE_S * 1e3,
        pipeline_depth: int = 2,
        match_cache_size: int = MATCH_CACHE_SIZE,
        queue_max_depth: int = 8192,
        queue_policy: str = "shed",
        queue_deadline_ms: float = 1000.0,
        queue_low_watermark: int = 0,
        transfer_chunk_kb: float = 0.0,
        aot_warm: bool = True,
        gc_guard: bool = True,
        breaker_enable: bool = True,
        breaker_threshold: int = 4,
        breaker_deadline_ms: float = 250.0,
        probe_backoff_ms: float = 100.0,
        probe_backoff_max_ms: float = 5000.0,
        alarms=None,
        flight=None,
    ) -> None:
        self.broker = broker
        self.router = broker.router
        if match_cache_size:
            self.router.enable_match_cache(match_cache_size)
        self.telemetry = self.router.telemetry
        self.queue_depth = max(1, queue_depth)
        self.deadline_s = max(0.0, deadline_ms) / 1e3
        self.pipeline_depth = max(1, pipeline_depth)
        # --- device failure domain (breaker) knobs; with the breaker
        # off a device failure is counted and re-served, never tripped
        self.breaker_enabled = bool(breaker_enable)
        self.breaker_threshold = max(1, breaker_threshold)
        self.breaker_deadline_s = max(0.0, breaker_deadline_ms) / 1e3
        self.probe_backoff_s = max(0.001, probe_backoff_ms) / 1e3
        self.probe_backoff_max_s = max(
            self.probe_backoff_s, probe_backoff_max_ms / 1e3
        )
        # obs/alarm.Alarms and obs/flight_recorder.FlightControl: explicit
        # wiring wins; otherwise resolved lazily through the attached
        # sentinel (an Observability bundle attached before or after the
        # engine must reach both)
        self.alarms = alarms
        self.flight = flight
        # --- admission control knobs
        self.queue_max_depth = max(1, queue_max_depth)
        if queue_policy not in ("shed", "block"):
            raise ValueError(f"queue_policy must be shed or block, not {queue_policy!r}")
        self.queue_policy = queue_policy
        self.queue_deadline_s = max(0.001, queue_deadline_ms) / 1e3
        # blocked publishers resume once outstanding work falls here
        # (0: half the queue's depth)
        self.queue_low_watermark = (
            queue_low_watermark
            if queue_low_watermark
            else max(1, self.queue_max_depth // 2)
        )
        # --- transfer pipeline knobs (ops/transfer.py)
        # chunk_kb: bound on a ring slot's compacted-result buffer;
        # 0 = auto-size from the link probe at warmup (BDP). aot_warm:
        # run every launch-shape bucket at warmup. gc_guard: keep
        # collector pauses out of launch/collect critical sections
        # (gc.freeze of steady state at warmup + per-flush pause).
        self.transfer_chunk_kb = float(transfer_chunk_kb)
        self.aot_warm = bool(aot_warm)
        self.gc_guard = bool(gc_guard)
        self.warmed = False
        self._queue: List[tuple] = []  # (msg, future, enqueue clock, span)
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
        # --- breaker state machine: closed -> open -> half_open -> closed
        self.breaker_state = "closed"
        self._consecutive_failures = 0
        self._probe_task: Optional[asyncio.Task] = None
        # --- shard breaker (ShardedDeviceTable chip loss): failures
        # whose exception carries a `shard` count here PER SHARD and
        # never feed _consecutive_failures, so one sick chip does not
        # forfeit the whole mesh
        self._shard_failures: Dict[int, int] = {}
        self._shard_open: Set[int] = set()
        self._shard_probe_tasks: Dict[int, asyncio.Task] = {}
        self.last_device_error: Optional[str] = None
        # canary topics: the most recent distinct batch heads, so the
        # recovery probe dispatches realistic traffic, not synthetics
        self._recent_topics: Deque[str] = deque(maxlen=8)
        # a readiness poll of the ring head that raised (a CUDA error
        # surfaces at the first synchronising call, here an event
        # query): the next collect re-serves that head from the host
        self._head_fault: Optional[BaseException] = None
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
            tel.set_gauge("breaker_state", 0)
            tel.set_gauge("breaker_consecutive_failures", 0)
            tel.set_gauge("queue_depth", 0)
            tel.set_gauge("queue_waiters", 0)
            tel.set_gauge("queue_overloaded", 0)

    # --- obs wiring -------------------------------------------------------

    def _get_alarms(self):
        if self.alarms is not None:
            return self.alarms
        st = self.broker.sentinel
        return st.alarms if st is not None else None

    def _get_flight(self):
        if self.flight is not None:
            return self.flight
        st = self.broker.sentinel
        return st.flight if st is not None else None

    # --- warmup: chunk sizing + shape warm-up + GC discipline ------------

    def warmup(self) -> dict:
        """One-time serve-readiness pass (idempotent):

          1. size the transfer chunk — `transfer_chunk_kb` as given, or
             auto from a link probe (RTT floor x fetch bandwidth, the
             BDP, kernel K12) — and push it into the device table;
          2. run every launch-shape bucket the engine can dispatch
             (pow2 batch ladder up to queue_depth through the REAL
             begin/finish halves), then flip the telemetry to serving:
             a later new shape bucket counts as
             `recompiles_at_serve_total`;
          3. freeze the now-steady object graph out of the cyclic
             collector (gc.freeze) so gen-2 passes never scan the
             table/session bulk from inside a launch.

        A device that fails the link probe leaves the chunk unbounded
        (counted); one that fails the shape warm-up counts toward the
        breaker — the broker comes up degraded, never dead. Any other
        exception (a kernel that fails to build) raises. Returns a
        summary dict."""
        from ..ops import transfer as transfer_ops

        router = self.router
        tel = self.telemetry
        info: dict = {}
        chunk_kb = self.transfer_chunk_kb
        if not chunk_kb:
            try:
                rtt_s, bw = transfer_ops.probe_link(router.device)
                chunk_kb = transfer_ops.auto_chunk_kb(rtt_s, bw)
                info["link_rtt_ms"] = round(rtt_s * 1e3, 3)
                info["link_mb_per_s"] = round(bw / 1e6, 1)
            except Exception as e:
                if not is_device_fault(e):
                    raise
                # a dead link at boot is the breaker's business, not
                # warmup's — leave the chunk unbounded, note it
                tel.count("warmup_probe_failures_total")
                log.warning("link probe failed during warmup: %r", e)
                chunk_kb = 0
        if chunk_kb:
            router.set_transfer_chunk(chunk_kb)
        self.transfer_chunk_kb = chunk_kb
        info["transfer_chunk_kb"] = chunk_kb
        try:
            if self.aot_warm:
                info["aot_shapes"] = router.warmup_shapes(self.queue_depth)
        except Exception as e:
            if not is_device_fault(e):
                raise
            tel.count("warmup_failures_total")
            log.warning("shape warm-up failed: %r", e)
            self.note_device_failure(e)
        if router.mesh is not None:
            # the mesh's serve state at readiness: its shard count
            info["mesh_shards"] = router.device_table.n_shards
        tel.mark_serving()
        if self.gc_guard and not self.warmed:
            gc.collect()
            gc.freeze()
        self.warmed = True
        return info

    def _gc_pause(self) -> bool:
        """Suspend the cyclic collector for a launch/collect critical
        section; returns whether it was running (restore token)."""
        if not self.gc_guard:
            return False
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
        # publish sentinel (obs/sentinel.py): a 1/sample_n publish gets
        # a stage span + a deferred shadow-oracle audit; every other
        # publish pays one attribute read + one counter increment
        st = self.broker.sentinel
        span = st.maybe_span(msg) if st is not None else None
        if self._admit((msg, fut, self.telemetry.clock(), span), loop):
            if len(self._queue) >= self.queue_depth:
                self._flush()
            elif self._timer is None:
                self._timer = loop.call_later(
                    self.deadline_s, self._on_deadline
                )
        return fut

    def submit_many(self, msgs) -> "asyncio.Future":
        """Storm surface: enqueue a chunk of publishes as one unit and
        return ONE future resolving to the summed delivery count. Same
        hooks, match path and sentinel sampling per message as submit();
        admission control applies per message: a shed message fails the
        aggregate."""
        self._check_open()
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        if not msgs:
            fut.set_result(0)
            return fut
        agg = _AggregateCount(fut, len(msgs))
        clock = self.telemetry.clock
        st = self.broker.sentinel
        for msg in msgs:
            span = st.maybe_span(msg) if st is not None else None
            # _flush REPLACES self._queue with a fresh list — re-read
            # it each append rather than holding a stale binding
            if self._admit((msg, agg, clock(), span), loop):
                if len(self._queue) >= self.queue_depth:
                    self._flush()
        if self._queue and self._timer is None:
            self._timer = loop.call_later(self.deadline_s, self._on_deadline)
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
        _msg, fut, _t, _span = item
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
                _msg, fut, t_in, _span = item
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
            _msg, fut, t_in, _span = item
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

    def _flush(self) -> None:
        """Close the current batch: run the publish hooks, LAUNCH the
        match kernels (no device->host fetch) and the overlapped plan
        resolves, and push the pending batch onto the in-flight window.
        Collection happens on a later loop turn (_drain) or immediately
        for whatever exceeds the pipeline depth. A device fault at
        launch fails over to a host-mode batch — publishers never see
        it; any other exception fails the batch's publishers with
        itself."""
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
            st = broker.sentinel
            now = tel.clock()
            entries = []
            topics = []
            bspan = None
            # batched-WHERE window: rule predicates hit inside the
            # publish-hook fold defer into one columnar drain when the
            # window closes — the whole coalesced batch shares one
            # column extraction per referenced path
            rb = getattr(broker, "rule_batcher", None)
            win = (
                rb.batch_window()
                if rb is not None and rb.batch_where_enabled
                else contextlib.nullcontext()
            )
            STAGE_MARK.stage = "coalesce"
            with win:
                for msg, fut, t_in, span in batch:
                    tel.observe_family(
                        "pipeline_queue_wait_seconds", now - t_in
                    )
                    if span is not None and bspan is None and st is not None:
                        bspan = st.batch_span()
                    live = broker._pre_publish(msg)
                    if span is not None:
                        # queue sub-decomposition: submit_wait is
                        # submit()->flush fire; coalesce is this
                        # publish's wait inside the flush fold (its own
                        # hook walk included). submit_wait + coalesce
                        # == queue exactly, by construction — the
                        # sum-to-wall contract starts here.
                        t_end = tel.clock()
                        span.add("queue", t_end - t_in)
                        span.add_sub("submit_wait", now - t_in)
                        span.add_sub("coalesce", t_end - now)
                    entries.append((live, fut, span))
                    if live is not None:
                        topics.append(live.topic)
            STAGE_MARK.stage = ""
            self.batches_total += 1
            self.publishes_total += len(batch)
            if topics:
                self._recent_topics.append(topics[0])
            STAGE_MARK.stage = "match_launch"
            try:
                try:
                    pending = router.match_filters_begin(topics, span=bspan)
                except Exception as e:
                    if not is_device_fault(e):
                        raise
                    # launch-side device fault (encode/sync/kernel
                    # launch): re-begin in host mode — the cache probe
                    # re-runs (cheap, correct) and finish serves from
                    # host truth
                    tel.count("breaker_begin_failures_total")
                    self.note_device_failure(e)
                    pending = self._host_begin(topics, bspan)
                # device-resolved fanout overlap: topics the match cache
                # answered at begin time have known filter sets NOW —
                # launch their plan resolves immediately so the deduped
                # plan materializes on the card while the match fetch
                # for the uncached remainder is still in flight
                STAGE_MARK.stage = "plan_resolve"
                fanout_pending = (
                    None if router.device_suspended
                    else self._begin_overlapped(pending)
                )
            except Exception as e:
                # not the card's fault: the publishers see it
                STAGE_MARK.stage = ""
                self._fail_batch(entries, e)
                self._batch_done(len(entries))
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
            self._inflight.append(
                (pending, entries, fanout_pending, bspan, t_launch)
            )
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

    def _host_begin(self, topics, bspan=None):
        """Begin a batch with the device forced out of the loop (the
        failover path when match_filters_begin itself raised)."""
        router = self.router
        prev = router.device_suspended
        router.device_suspended = True
        try:
            return router.match_filters_begin(topics, span=bspan)
        finally:
            router.device_suspended = prev

    def _begin_overlapped(self, pending):
        """Launch K5 for every distinct cached filter set of a begun
        batch whose plan is missing or stale; [(key, clock, handle)]
        or None. A device fault at launch stops the overlap (the
        dispatch path rebuilds those plans) and counts toward the
        breaker; any other exception raises."""
        broker = self.broker
        if pending.full_out is None or not broker._fanout_device:
            return None
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
            try:
                h = router.resolve_fanout_begin(
                    fkey, min_fan=broker._fanout_min_fan
                )
            except Exception as e:
                if not is_device_fault(e):
                    raise
                tel.count("fanout_host_fallback_total")
                self.note_device_failure(e)
                break
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
        tickets have all landed host-side. A poll that raises (the
        first synchronising call after a faulting kernel) marks the
        head for re-serve and reports it ready, so the fault takes the
        failed-fetch path instead of escaping the loop callback and
        stranding the batch's publishers."""
        pending, _entries, fanout_pending, _bspan, _t = self._inflight[0]
        try:
            if not self.router.match_finish_ready(pending):
                return False
            if fanout_pending is not None:
                for _fkey, _clock, h in fanout_pending:
                    if not h[0].ready():
                        return False
        except Exception as e:
            self._head_fault = e
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
        """Fetch + deliver the OLDEST in-flight batch (begin order).
        A device fault here re-serves the whole batch through the host
        walk; a slow-but-successful device batch past the breaker
        deadline counts toward the breaker without being re-served
        (its results are already correct). Any other exception fails
        the batch's publishers with itself. A dropped batch's transfer
        tickets free their pinned host buffers through PyTorch's
        caching host allocator, which holds a buffer until the copy
        recorded on it has completed."""
        pending, entries, fanout_pending, bspan, t_launch = (
            self._inflight.popleft()
        )
        head_fault, self._head_fault = self._head_fault, None
        broker = self.broker
        router = self.router
        tel = self.telemetry
        tclock = tel.clock
        st = broker.sentinel
        device_batch = pending.mode not in ("cached", "host")
        gc_tok = self._gc_pause()
        try:
            STAGE_MARK.stage = "match_fetch"
            t0 = tclock()
            try:
                if head_fault is not None:
                    raise head_fault
                filter_lists = router.match_filters_finish(pending)
            except Exception as e:
                if not is_device_fault(e):
                    self._drop_batch(entries, t_launch, e)
                    return
                # device fault: re-serve the WHOLE batch from host truth
                # (identical by the oracle contract, so publishers never
                # see it); the failure still counts toward the breaker
                tel.count("breaker_fallback_total", len(entries))
                self.note_device_failure(e)
                fanout_pending = None  # overlapped resolves died with it
                try:
                    filter_lists = router.match_filters_host(pending)
                except Exception as e2:  # host truth failed: nothing left
                    self._drop_batch(entries, t_launch, e2)
                    return
            else:
                if device_batch:
                    if (
                        self.breaker_deadline_s
                        and tclock() - t0 > self.breaker_deadline_s
                    ):
                        # slow is a fault even when it is not wrong: the
                        # results serve, the breaker still hears about it
                        tel.count("breaker_deadline_exceeded_total")
                        self.note_device_failure(None)
                    else:
                        self.note_device_success()
            STAGE_MARK.stage = ""
            if fanout_pending is not None:
                # install the overlapped plans before delivering:
                # stamped with the clock captured at begin, so a
                # mutation that landed mid-flight leaves them
                # stale-on-arrival and the dispatch below rebuilds
                STAGE_MARK.stage = "plan_resolve"
                t_res = tclock() if bspan is not None else 0.0
                for fkey, clock, h in fanout_pending:
                    try:
                        plan = router.resolve_fanout_finish(h)
                    except Exception as e:
                        if not is_device_fault(e):
                            self._drop_batch(entries, t_launch, e)
                            return
                        # the dispatch path rebuilds this plan; counted
                        # so a dying link can't fail resolves silently
                        tel.count("fanout_host_fallback_total")
                        self.note_device_failure(e)
                        continue
                    broker._store_plan(fkey, clock, plan)
                if bspan is not None:
                    bspan.add("resolve", tclock() - t_res)
                STAGE_MARK.stage = ""
            self._ring_land(tclock(), t_launch, pending.mode, len(entries))
            # the vectorized delivery half: ONE window dispatch for the
            # whole collected batch (plan resolution per unique filter
            # set, session-grouped writes)
            results, meta = broker.dispatch_window(
                [e[0] for e in entries],
                filter_lists,
                spans=[e[2] for e in entries],
                capture_errors=True,
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

            for idx, (live, fut, span) in enumerate(entries):
                n = results[idx]
                if isinstance(n, BaseException):
                    # a delivery-side failure is the publisher's to see
                    # (a host bug, not a device fault): counted
                    _flush_agg()
                    tel.count("publish_failures_total")
                    if not fut.done():
                        fut.set_exception(n)
                    continue
                if live is not None and span is not None and st is not None:
                    if bspan is not None:
                        span.merge(bspan)
                    st.finish_span(span)
                    # shadow-oracle audit of exactly what was served:
                    # the matched filter set + the (filter, dests)
                    # pairs, stamped with the begin generation so churn
                    # mid-flight skips rather than false-positives
                    key, pairs = meta[idx]
                    st.capture_audit(
                        live.topic, key, pairs, pending.gen, span.trace_id,
                    )
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

    def _drop_batch(self, entries, t_launch: float, exc: BaseException) -> None:
        """Land a collected batch that cannot be served: every
        publisher in it sees `exc`."""
        STAGE_MARK.stage = ""
        self._ring_land(self.telemetry.clock(), t_launch, "failed", len(entries))
        self._fail_batch(entries, exc)
        self._batch_done(len(entries))

    def _fail_batch(self, entries, exc: BaseException) -> None:
        """The batch cannot be served (a fault that is not the card's,
        or host truth itself failed): every publisher in it sees that
        failure (counted)."""
        self.telemetry.count("publish_failures_total", len(entries))
        for _live, fut, _span in entries:
            if not fut.done():
                fut.set_exception(exc)

    def _batch_done(self, n_pubs: int) -> None:
        self._inflight_pubs -= n_pubs
        if self._waiters:
            self._pump_waiters()
        else:
            self._maybe_clear_overload()

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

    # --- circuit breaker (trip -> degrade -> probe -> resync -> close) ----

    def note_device_failure(self, exc: Optional[BaseException]) -> None:
        """One device failure (None: a batch past the deadline), from
        the engine's own batches or the broker's synchronous match and
        plan legs. A failure that carries a `shard` counts in that
        shard's ledger and trips only the shard breaker."""
        tel = self.telemetry
        tel.count("breaker_device_failures_total")
        if exc is not None:
            self.last_device_error = repr(exc)
        if not self.breaker_enabled:
            return
        shard = getattr(exc, "shard", None)
        if shard is not None:
            # a fault of one chip: its own ledger, the whole-device
            # breaker untouched (the other shards are fine)
            n = self._shard_failures.get(shard, 0) + 1
            self._shard_failures[shard] = n
            if shard not in self._shard_open and n >= self.breaker_threshold:
                self._trip_shard(int(shard))
            return
        self._consecutive_failures += 1
        tel.set_gauge("breaker_consecutive_failures", self._consecutive_failures)
        if (
            self.breaker_state == "closed"
            and self._consecutive_failures >= self.breaker_threshold
        ):
            self._trip_breaker()

    def note_device_success(self) -> None:
        """A successful device leg resets the consecutive-failure
        count, so sparse transient faults spread over hours never
        accumulate into a spurious trip."""
        if self._consecutive_failures:
            self._consecutive_failures = 0
            self.telemetry.set_gauge("breaker_consecutive_failures", 0)
        # a clean dispatch clears the ledgers of shards that have NOT
        # tripped; an open shard stays open until its probe closes it
        if self._shard_failures:
            for s in list(self._shard_failures):
                if s not in self._shard_open:
                    del self._shard_failures[s]

    def _set_state(self, state: str) -> None:
        self.breaker_state = state
        self.telemetry.set_gauge("breaker_state", _STATE_GAUGE[state])

    def _trip_breaker(self) -> None:
        """closed -> open: all traffic host-side (degraded but
        correct), alarm raised, probe armed."""
        tel = self.telemetry
        self._set_state("open")
        self.router.suspend_device()
        tel.count("breaker_trips_total")
        details = {
            "consecutive_failures": self._consecutive_failures,
            "threshold": self.breaker_threshold,
            "last_error": self.last_device_error,
        }
        log.error(
            "device breaker TRIPPED after %d consecutive failures "
            "(last: %s) — all publish traffic degraded to the host "
            "walk; canary probe armed",
            self._consecutive_failures, self.last_device_error,
        )
        alarms = self._get_alarms()
        if alarms is not None:
            try:
                alarms.ensure(
                    ALARM_BREAKER,
                    details=details,
                    message="XLA device breaker open: publish path "
                            "degraded to host walk",
                )
            except Exception:
                tel.count("breaker_alarm_failures_total")
                log.exception("breaker alarm failed")
        fl = self._get_flight()
        if fl is not None:
            fl.recorder.record("breaker.trip", "", details)
            fl.maybe_trigger("device_breaker_trip", details)
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            # no loop (a synchronous caller): recovery happens on the
            # next probe_once() the caller drives
            return
        t = loop.create_task(self._probe_loop())
        self._probe_task = t
        t.add_done_callback(self._probe_done)

    def _probe_done(self, task: "asyncio.Task") -> None:
        if self._probe_task is task:
            self._probe_task = None
        if not task.cancelled() and task.exception() is not None:
            self.telemetry.count("breaker_probe_crashes_total")
            log.error("breaker probe loop died", exc_info=task.exception())

    async def _probe_loop(self) -> None:
        """Bounded-exponential-backoff canary: probe_once until the
        breaker closes (or the engine stops)."""
        backoff = self.probe_backoff_s
        while not self.closed and self.breaker_state == "open":
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2.0, self.probe_backoff_max_s)
            if self.closed or self.breaker_state != "open":
                return
            if self.probe_once():
                return

    def probe_once(self) -> bool:
        """One canary attempt: link canary -> full state re-upload ->
        oracle-verified canary -> close. Returns True when the breaker
        closed; a fault that is not the card's raises, the breaker left
        open."""
        tel = self.telemetry
        router = self.router
        tel.count("breaker_probe_total")
        self._set_state("half_open")
        topics = list(self._recent_topics) or ["$breaker/canary"]
        try:
            # step 1: does the link dispatch at all? (stale state OK)
            router.canary_match(topics)
            # step 2: the outage dropped the delta stream — re-upload
            # FULL device state from host truth, then verify that the
            # card answers as the host oracle does
            router.device_resync()
            served = router.canary_match(topics)
            oracle = [sorted(router.match_filters(t)) for t in topics]
            if [sorted(x) for x in served] != oracle:
                raise DeviceLinkError("post-resync canary diverged from host oracle")
        except Exception as e:
            tel.count("breaker_probe_failures_total")
            self.last_device_error = repr(e)
            self._set_state("open")
            if not is_device_fault(e):
                raise
            return False
        self._close_breaker(topics)
        return True

    def _close_breaker(self, canary_topics) -> None:
        tel = self.telemetry
        self._consecutive_failures = 0
        tel.set_gauge("breaker_consecutive_failures", 0)
        self._set_state("closed")
        self.router.resume_device()
        tel.count("breaker_recoveries_total")
        log.warning(
            "device breaker CLOSED: full state re-uploaded, canary "
            "verified against host oracle on %d topics",
            len(canary_topics),
        )
        alarms = self._get_alarms()
        if alarms is not None:
            alarms.ensure_deactivated(ALARM_BREAKER)
        fl = self._get_flight()
        if fl is not None:
            fl.recorder.record(
                "breaker.close", "", {"canary_topics": len(canary_topics)}
            )

    # --- shard breaker (chip-granular failure domain) ---------------------

    @property
    def open_shards(self) -> Set[int]:
        return set(self._shard_open)

    def _trip_shard(self, shard: int) -> None:
        """One chip crossed the threshold: suspend ONLY its slice (host
        overlay), evacuate its rows and buckets onto the survivor mesh,
        so service returns to the device at N-1, and arm a per-shard
        probe. The whole-device breaker stays closed."""
        tel = self.telemetry
        self._shard_open.add(shard)
        tel.count("breaker_shard_trips_total")
        tel.set_gauge("breaker_open_shards", len(self._shard_open))
        self.router.suspend_shard(shard)
        details = {
            "shard": shard,
            "failures": self._shard_failures.get(shard, 0),
            "threshold": self.breaker_threshold,
            "last_error": self.last_device_error,
        }
        log.error(
            "shard breaker TRIPPED for shard %d (last: %s) — slice "
            "host-overlaid, evacuating onto survivor mesh",
            shard, self.last_device_error,
        )
        alarms = self._get_alarms()
        if alarms is not None:
            try:
                alarms.ensure(
                    ALARM_BREAKER,
                    details=details,
                    message=f"XLA shard breaker open: shard {shard} "
                            "slice degraded, evacuating",
                )
            except Exception:
                tel.count("breaker_alarm_failures_total")
                log.exception("shard breaker alarm failed")
        fl = self._get_flight()
        if fl is not None:
            fl.recorder.record("breaker.shard_trip", "", details)
            fl.maybe_trigger("device_breaker_trip", details)
        try:
            # live evacuation: re-shard over the survivors + full
            # re-upload from host truth, then build the survivor
            # layout's launch shapes off the serving path
            if self.router.evacuate_shard(shard):
                tel.count("breaker_shard_evacuations_total")
                self.router.warmup_shapes(max_batch=64)
        except Exception as e:
            if not is_device_fault(e):
                raise
            # the host overlay stays, degraded but correct, until the
            # probe heals the shard
            tel.count("breaker_shard_evacuation_failures_total")
            log.exception("shard %d evacuation failed; slice stays host-overlaid", shard)
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # a synchronous caller drives probe_shard_once()
        t = loop.create_task(self._shard_probe_loop(shard))
        self._shard_probe_tasks[shard] = t
        t.add_done_callback(lambda task, s=shard: self._shard_probe_done(s, task))

    def _shard_probe_done(self, shard: int, task: "asyncio.Task") -> None:
        if self._shard_probe_tasks.get(shard) is task:
            del self._shard_probe_tasks[shard]
        if not task.cancelled() and task.exception() is not None:
            self.telemetry.count("breaker_probe_crashes_total")
            log.error("shard %d probe loop died", shard, exc_info=task.exception())

    async def _shard_probe_loop(self, shard: int) -> None:
        backoff = self.probe_backoff_s
        while not self.closed and shard in self._shard_open:
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2.0, self.probe_backoff_max_s)
            if self.closed or shard not in self._shard_open:
                return
            if self.probe_shard_once(shard):
                return

    def probe_shard_once(self, shard: int) -> bool:
        """One recovery attempt for an evacuated chip: direct probe ->
        rebalance back to the full mesh (full re-upload) -> canary
        verified against the host oracle -> close. On a divergent
        canary the chip is evacuated again: it re-earns trust. Returns
        True when the shard closed; a fault that is not the card's
        raises, the shard left open."""
        tel = self.telemetry
        router = self.router
        tel.count("breaker_probe_total")
        topics = list(self._recent_topics) or ["$breaker/canary"]
        try:
            # step 1: is the chip back? (raises while its fault is live)
            router.probe_shard(shard)
            # step 2: rebalance back and verify against the oracle
            router.rebalance_shard(shard)
            served = router.canary_match(topics)
            oracle = [sorted(router.match_filters(t)) for t in topics]
            if [sorted(x) for x in served] != oracle:
                raise DeviceLinkError(f"post-rebalance canary diverged on shard {shard}")
        except Exception as e:
            tel.count("breaker_probe_failures_total")
            self.last_device_error = repr(e)
            if shard not in getattr(router.device_table, "lost_shards", ()):
                # the rebalance half-landed or the canary diverged:
                # evacuate again, so the verified survivor mesh serves
                try:
                    router.evacuate_shard(shard)
                except Exception as e2:
                    if not is_device_fault(e2):
                        raise
            if not is_device_fault(e):
                raise
            return False
        self._close_shard(shard, topics)
        return True

    def _close_shard(self, shard: int, canary_topics) -> None:
        tel = self.telemetry
        self._shard_open.discard(shard)
        self._shard_failures.pop(shard, None)
        tel.set_gauge("breaker_open_shards", len(self._shard_open))
        tel.count("breaker_shard_recoveries_total")
        log.warning(
            "shard breaker CLOSED for shard %d: rebalanced back to the "
            "full mesh, canary verified on %d topics",
            shard, len(canary_topics),
        )
        if not self._shard_open and self.breaker_state == "closed":
            alarms = self._get_alarms()
            if alarms is not None:
                alarms.ensure_deactivated(ALARM_BREAKER)
        fl = self._get_flight()
        if fl is not None:
            fl.recorder.record(
                "breaker.shard_close", "",
                {"shard": shard, "canary_topics": len(canary_topics)},
            )

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
        cancel the breaker's probe and every shard probe, then refuse
        new publishes (EngineStopped)."""
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
        if self._probe_task is not None:
            self._probe_task.cancel()
            with contextlib.suppress(Exception, asyncio.CancelledError):
                await self._probe_task
            self._probe_task = None
        for t in list(self._shard_probe_tasks.values()):
            t.cancel()
            with contextlib.suppress(Exception, asyncio.CancelledError):
                await t
        self._shard_probe_tasks.clear()
        if self.warmed:
            # hand the frozen steady state back to the collector — a
            # stopped engine's broker graph must stay reclaimable
            gc.unfreeze()
        await asyncio.sleep(0)

    def status(self) -> dict:
        cache = self.router.match_cache
        counters = self.telemetry.counters
        return {
            "queue_depth": self.queue_depth,
            "deadline_ms": self.deadline_s * 1e3,
            "pipeline_depth": self.pipeline_depth,
            "queued": len(self._queue),
            "inflight": len(self._inflight),
            "batches_total": self.batches_total,
            "publishes_total": self.publishes_total,
            "coalesce_factor": round(
                self.publishes_total / self.batches_total, 3
            ) if self.batches_total else 0.0,
            "breaker": {
                "enabled": self.breaker_enabled,
                "state": self.breaker_state,
                "threshold": self.breaker_threshold,
                "consecutive_failures": self._consecutive_failures,
                "deadline_ms": self.breaker_deadline_s * 1e3,
                "trips": counters.get("breaker_trips_total", 0),
                "recoveries": counters.get("breaker_recoveries_total", 0),
                "fallback_publishes": counters.get("breaker_fallback_total", 0),
                "degraded_batches": counters.get(
                    "breaker_degraded_batches_total", 0
                ),
                "probes": counters.get("breaker_probe_total", 0),
                "probe_failures": counters.get("breaker_probe_failures_total", 0),
                "last_device_error": self.last_device_error,
            },
            "shard_breaker": {
                "open_shards": sorted(self._shard_open),
                "failures": dict(sorted(self._shard_failures.items())),
                "lost_shards": sorted(getattr(self.router.device_table, "lost_shards", ())),
                "shard_gen": getattr(self.router.device_table, "shard_gen", 0),
                "trips": counters.get("breaker_shard_trips_total", 0),
                "evacuations": counters.get("breaker_shard_evacuations_total", 0),
                "recoveries": counters.get("breaker_shard_recoveries_total", 0),
            },
            "admission": {
                "max_depth": self.queue_max_depth,
                "low_watermark": self.queue_low_watermark,
                "policy": self.queue_policy,
                "queue_deadline_ms": self.queue_deadline_s * 1e3,
                "outstanding": self.outstanding(),
                "waiters": len(self._waiters),
                "overloaded": self._overloaded,
                "shed": counters.get("queue_shed_total", 0),
                "blocked": counters.get("queue_blocked_total", 0),
                "deadline_expired": counters.get(
                    "queue_deadline_expired_total", 0
                ),
            },
            "match_cache": None if cache is None else {
                "capacity": cache.capacity,
                "entries": len(cache),
                "hits": cache.hits,
                "misses": cache.misses,
                "evictions": cache.evictions,
                "hit_ratio": round(cache.hit_ratio(), 6),
            },
            "ring": self.ring_status(),
        }
