"""Chaos engine core of the port (the port's copy of
emqx_tpu/chaos/engine.py, single device): the session fleet, the Zipf
storm generator, and the scenario driver that runs the catalog while
the sentinel judges the outcome.

Scale notes (why the fleet looks like this):
  * sessions are REAL `broker.Session` objects opened through
    `Broker.open_session` -- the same registry, route writes, fanout
    plans, and delivery loops production traffic exercises -- but they
    share ONE SessionConfig and one no-op sink, so a million of them
    fit in a few GB;
  * queued-while-disconnected QoS0 is disabled in the shared config
    (`mqueue_store_qos0=False`): a disconnect wave under a live storm
    must not turn into a million growing mqueues;
  * publishes ride `DispatchEngine.submit_many` -- one future per storm
    chunk instead of one per publish -- so a single driver task can
    saturate the pipelined device path;
  * topic skew is Zipf over subscription groups (the head of the
    distribution stays hot enough to live in the match cache, the tail
    keeps the kernels honest).

The engine runs on the broker's device: `ChaosEngine.standalone()` and
`run_soak()` build a `Broker(device=...)` on the CUDA card unless the
caller passes device="cpu"; `standalone(mesh=...)` sub-shards its table
across a mesh, and only then does a catalog run drive the mesh
scenarios (chip_loss, chip_flap, reshard_churn), which it skips
otherwise. The soak row's provenance names torch, its CUDA version, the
platform, the card and its power limit. The cluster engine (a victim
node, `victim_sessions > 0`) needs ROADMAP Queue 1 item 8b and raises
`NotImplementedError`.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..broker.message import Message
from ..broker.packet import SubOpts
from ..broker.session import SessionConfig
from ..obs.profiler import STAGE_MARK

log = logging.getLogger("emqx_tpu_torch.chaos")

NOT_PORTED = (
    "needs the cluster layer of ROADMAP Queue 1 item 8b, which the port "
    "does not have yet"
)


class ContractViolation(AssertionError):
    """A scenario's expected-response contract did not hold."""


def _noop_sink(pkts) -> None:
    return None


class SessionFleet:
    """N lightweight-but-real sessions on one broker. Session i
    subscribes the wildcard filter `<prefix>/<i % groups>/+`, so the
    fleet materializes `groups` distinct device rows with a bounded
    per-filter fan (sessions/groups) — a million sessions is a million
    Session objects and ~groups cuckoo slots, not a million copies of
    one filter."""

    def __init__(
        self,
        broker,
        prefix: str = "s",
        sessions: int = 10_000,
        groups: Optional[int] = None,
        session_expiry_s: float = 3600.0,
    ) -> None:
        self.broker = broker
        self.prefix = prefix
        self.n = int(sessions)
        self.groups = int(groups) if groups else max(1, self.n // 5)
        # ONE config + ONE sink shared fleet-wide (see module notes)
        self.cfg = SessionConfig(
            session_expiry_interval=session_expiry_s,
            max_mqueue_len=16,
            mqueue_store_qos0=False,
            # the storm fleet stays in the live router even when the
            # durable tier is attached: a million DS sessions is a
            # different experiment than a million live ones
            durable=False,
        )
        self.sink = _noop_sink
        self.clients: List[str] = []

    def filter_of(self, group: int) -> str:
        return f"{self.prefix}/{group}/+"

    def topic_of(self, group: int, suffix) -> str:
        return f"{self.prefix}/{group}/{suffix}"

    async def build(
        self,
        batch: int = 4096,
        progress: Optional[Callable[[str], None]] = None,
    ) -> None:
        b = self.broker
        opts = SubOpts(qos=0)
        append = self.clients.append
        for i in range(self.n):
            cid = f"{self.prefix}c{i}"
            s, _present = b.open_session(cid, clean_start=True, cfg=self.cfg)
            s.outgoing_sink = self.sink
            b.subscribe(s, self.filter_of(i % self.groups), opts)
            append(cid)
            if (i + 1) % batch == 0:
                # yield: the cluster syncer, heartbeats, and the storm
                # (when already running) get their loop turns
                await asyncio.sleep(0)
                if progress is not None and (i + 1) % (batch * 32) == 0:
                    progress(f"fleet {self.prefix}: {i + 1}/{self.n}")

    def fan(self) -> int:
        """Subscribers per group filter (the delivery fan of one
        storm topic)."""
        return max(1, self.n // self.groups)


class ZipfTopics:
    """Zipf-skewed topic generator over a fleet's groups. Rank→group is
    a fixed permutation so the hot head isn't the first groups by id;
    draws are O(chunk · log groups) via searchsorted over the cached
    CDF. A `victim_share` slice of traffic targets the victim fleet's
    groups so the cluster forward leg stays continuously exercised."""

    def __init__(
        self,
        fleet: SessionFleet,
        s: float = 1.2,
        seed: int = 7,
        hot_suffixes: int = 16,
        victim: Optional[SessionFleet] = None,
        victim_share: float = 0.05,
    ) -> None:
        self.fleet = fleet
        self.victim = victim
        self.victim_share = victim_share if victim is not None else 0.0
        self.rng = np.random.default_rng(seed)
        self.hot_suffixes = hot_suffixes
        w = 1.0 / np.arange(1, fleet.groups + 1, dtype=np.float64) ** s
        self._cdf = np.cumsum(w / w.sum())
        self._perm = self.rng.permutation(fleet.groups)
        if victim is not None:
            wv = 1.0 / np.arange(1, victim.groups + 1, dtype=np.float64) ** s
            self._vcdf = np.cumsum(wv / wv.sum())
            self._vperm = self.rng.permutation(victim.groups)

    def draw(self, n: int) -> List[str]:
        rng = self.rng
        nv = int(n * self.victim_share)
        nm = n - nv
        groups = self._perm[
            np.searchsorted(self._cdf, rng.random(nm), side="right").clip(
                0, len(self._perm) - 1
            )
        ]
        sufs = rng.integers(0, self.hot_suffixes, size=n)
        pref = self.fleet.prefix
        out = [
            f"{pref}/{g}/{s_}" for g, s_ in zip(groups.tolist(), sufs.tolist())
        ]
        if nv:
            vg = self._vperm[
                np.searchsorted(
                    self._vcdf, rng.random(nv), side="right"
                ).clip(0, len(self._vperm) - 1)
            ]
            vp = self.victim.prefix
            out.extend(
                f"{vp}/{g}/{s_}"
                for g, s_ in zip(vg.tolist(), sufs[nm:].tolist())
            )
        return out


class ChaosEngine:
    """Drives the soak: owns the fleets, the background storm task, the
    fault-injection bookkeeping, and the scenario contract plumbing.
    One engine per soak run; scenarios receive it as their context."""

    CHAOS_PREFIX = "chaos"

    def __init__(
        self,
        broker,
        obs,
        *,
        sessions: int = 10_000,
        victim_sessions: int = 0,
        groups: Optional[int] = None,
        zipf_s: float = 1.2,
        seed: int = 7,
        storm_chunk: int = 256,
        sample_n: int = 64,
        chaos_filters: int = 4,
        chaos_fan: int = 5,
        detect_rounds: int = 12,
        detect_burst: int = 256,
        settle_timeout: float = 10.0,
        breaker_threshold: int = 3,
        probe_backoff_ms: float = 50.0,
        durable_sessions: int = 8,
        data_dir: Optional[str] = None,
        progress: Optional[Callable[[str], None]] = None,
    ) -> None:
        if victim_sessions > 0:
            raise NotImplementedError(f"victim_sessions {NOT_PORTED}")
        self.broker = broker
        self.obs = obs
        self.sessions = sessions
        self.victim_sessions = victim_sessions
        self.zipf_s = zipf_s
        self.seed = seed
        self.storm_chunk = storm_chunk
        self.sample_n = sample_n
        self.n_chaos_filters = chaos_filters
        self.chaos_fan = chaos_fan
        self.detect_rounds = detect_rounds
        self.detect_burst = detect_burst
        self.settle_timeout = settle_timeout
        self.breaker_threshold = breaker_threshold
        self.probe_backoff_ms = probe_backoff_ms
        # device-link fault seam (chaos/faults.py), installed at setup
        self.injector = None
        # durable tier (emqx_tpu/ds): a small QoS1 fleet persisted
        # through the WAL-backed store, plus the disk fault seam the
        # crash-consistency scenarios drive. Opened at setup when a
        # data_dir exists; survives ds_kill()/ds_reboot() cycles.
        self.durable_sessions = durable_sessions
        self.data_dir = data_dir
        self.durable_db = None
        self.durable_mgr = None
        self.disk_injector = None
        self.ds_recovery: Dict[str, Any] = {}
        self.ds_shard_failures: List[tuple] = []  # (ts, shard, errname)
        self.dur_published = 0
        self.dur_delivered = 0
        self._dur_reboots = 0
        self.progress = progress or (lambda msg: log.info("%s", msg))

        self.fleet = SessionFleet(broker, "s", sessions, groups=groups)
        self.topics: Optional[ZipfTopics] = None
        self.chaos_filters: List[str] = []
        self._chaos_seq = 0
        self._payload = b"soak"

        # soak accounting
        self.published = 0
        self.delivered = 0
        self.storm_errors = 0
        self._storm_elapsed = 0.0
        self._storm_task: Optional[asyncio.Task] = None
        self._storm_stop = True
        self.setup_seconds = 0.0
        self.faults_injected = 0
        self.faults_detected = 0
        self.fault_kinds: Dict[str, int] = {}
        self.detections: List[tuple] = []  # (monotonic ts, summary)
        self.scenario_results: List[Any] = []
        # wall-clock submit→delivered latency per storm CHUNK: the
        # end-to-end proxy the sentinel's stage spans don't cover
        # (spans sum attributed stage time; the wall clock also eats
        # loop scheduling + pipeline residency)
        from ..obs.kernel_telemetry import StreamingHistogram

        self.chunk_hist = StreamingHistogram()

    # --- wiring -----------------------------------------------------------

    @property
    def router(self):
        return self.broker.router

    @property
    def sentinel(self):
        return self.obs.sentinel

    @property
    def alarms(self):
        return self.obs.alarms

    @property
    def flight(self):
        return self.obs.flight

    def counters(self) -> Dict[str, int]:
        return dict(self.router.telemetry.counters)

    # --- setup ------------------------------------------------------------

    async def setup(self) -> None:
        from .faults import DeviceFaultInjector, DiskFaultInjector

        t0 = time.monotonic()
        if self.broker.engine is None:
            self.broker.enable_dispatch_engine()
        # breaker tuned to soak cadence: trip within a couple of storm
        # chunks, probe fast enough that recovery fits a scenario
        # window (production defaults are seconds-scale)
        de = self.broker.engine
        de.breaker_threshold = self.breaker_threshold
        de.probe_backoff_s = self.probe_backoff_ms / 1e3
        de.probe_backoff_max_s = max(
            de.probe_backoff_s * 8, de.probe_backoff_s
        )
        # the XLA-boundary fault seam the device scenarios drive;
        # healthy cost is one falsy test per device leg
        self.injector = DeviceFaultInjector().install(self.router)
        # the disk-IO fault seam (ds/diskio.py) the durable-tier
        # scenarios drive; healthy cost is one falsy module read per op
        self.disk_injector = DiskFaultInjector(seed=self.seed).install()
        if self.data_dir is not None and self.durable_sessions > 0:
            self._open_durable(first=True)
        st = self.sentinel
        st.sample_n = self.sample_n
        st.on_divergence.append(
            lambda summary: self.detections.append(
                (time.monotonic(), summary)
            )
        )
        self.progress(f"building fleet: {self.sessions} sessions")
        await self.fleet.build(progress=self.progress)
        # dedicated chaos-target filters: corruption scenarios corrupt
        # THESE device rows, so the main fleet's groups keep serving
        # clean while the fault is live (scoped blast radius)
        opts = SubOpts(qos=0)
        for k in range(self.n_chaos_filters):
            flt = f"{self.CHAOS_PREFIX}/{k}/+"
            for j in range(self.chaos_fan):
                s, _ = self.broker.open_session(
                    f"{self.CHAOS_PREFIX}-{k}-{j}",
                    clean_start=True,
                    cfg=self.fleet.cfg,
                )
                s.outgoing_sink = self.fleet.sink
                self.broker.subscribe(s, flt, opts)
            self.chaos_filters.append(flt)
        self.topics = ZipfTopics(self.fleet, s=self.zipf_s, seed=self.seed)
        # warm the device path: compile the kernels, drain the first
        # sync, and serve one burst through every chaos filter so their
        # rows exist device-side before any corruption lands
        await self.burst(self.topics.draw(max(64, self.storm_chunk)))
        await self.burst([self.fresh_topic(f) for f in self.chaos_filters])
        self.setup_seconds = time.monotonic() - t0
        self.progress(
            f"setup done in {self.setup_seconds:.1f}s: "
            f"{len(self.broker.sessions)} sessions on main broker"
        )

    # --- storm ------------------------------------------------------------

    def storm_start(self) -> None:
        if self._storm_task is not None:
            return
        self._storm_stop = False
        self._storm_t0 = time.monotonic()
        # retained handle + supervised finish (see _storm_done): a
        # chaos-injected failure in the generator must surface
        self._storm_task = asyncio.get_running_loop().create_task(
            self._storm_loop()
        )
        self._storm_task.add_done_callback(self._storm_done)

    def _storm_done(self, task: asyncio.Task) -> None:
        if not task.cancelled() and task.exception() is not None:
            log.error("storm generator died", exc_info=task.exception())

    async def storm_stop(self) -> None:
        if self._storm_task is None:
            return
        self._storm_stop = True
        try:
            await self._storm_task
        finally:
            self._storm_task = None
            self._storm_elapsed += time.monotonic() - self._storm_t0

    async def _storm_loop(self) -> None:
        eng = self.broker.engine
        draw = self.topics.draw
        chunk = self.storm_chunk
        payload = self._payload
        # one chunk in flight while the next is drawn/encoded: the
        # await lands on the PREVIOUS chunk's future, so the pipeline
        # never idles between chunks
        pending = None
        while not self._storm_stop:
            # explicit yield: when a chunk flushes+collects inline its
            # future is already done, and awaiting a done future does
            # NOT suspend — without this the storm busy-spins and
            # starves timers, audits, and the scenarios themselves
            await asyncio.sleep(0)
            # storm_gen mark: topic draw + Message construction is the
            # generator's own cost, not the broker's — bucket it so the
            # profiler's `other` bin stops absorbing the storm itself
            STAGE_MARK.stage = "storm_gen"
            msgs = [Message(topic=t, payload=payload) for t in draw(chunk)]
            STAGE_MARK.stage = ""
            fut = eng.submit_many(msgs)
            n_sent = len(msgs)
            t_sub = time.monotonic()
            if pending is not None:
                try:
                    self.delivered += await pending[0]
                    self.published += pending[1]
                    self.chunk_hist.observe(
                        time.monotonic() - pending[2]
                    )
                except Exception:
                    self.storm_errors += 1
                    log.exception("storm chunk failed")
                    await asyncio.sleep(0.01)
            pending = (fut, n_sent, t_sub)
        if pending is not None:
            try:
                self.delivered += await pending[0]
                self.published += pending[1]
                self.chunk_hist.observe(time.monotonic() - pending[2])
            except Exception:
                self.storm_errors += 1

    def storm_elapsed(self) -> float:
        live = (
            time.monotonic() - self._storm_t0
            if self._storm_task is not None
            else 0.0
        )
        return self._storm_elapsed + live

    # --- scenario plumbing ------------------------------------------------

    def fresh_topic(self, flt: str) -> str:
        """A never-seen topic matching `flt` (…/+): cache-miss by
        construction, so the device kernel — not the match cache —
        serves it."""
        self._chaos_seq += 1
        return flt[:-1] + f"w{self._chaos_seq}"

    async def burst(self, topics: Sequence[str]) -> int:
        """Publish a targeted burst through the pipelined engine, then
        drain the sentinel's deferred audit turn. Returns deliveries."""
        n = await self.broker.engine.submit_many(
            [Message(topic=t, payload=self._payload) for t in topics]
        )
        await asyncio.sleep(0)
        self.sentinel.run_audits()
        self.published += len(topics)
        self.delivered += n
        return n

    async def route_churn(self, n: int = 64) -> int:
        """Live route churn: `n` add legs (fresh temp-session
        subscriptions on never-seen filters) followed by `n` delete
        legs (their unsubscribes), with a device sync and a served burst
        in between: the subscribe/unsubscribe traffic a degraded mesh
        must keep absorbing. Returns routes churned."""
        b = self.broker
        self._chaos_seq += 1
        seq = self._chaos_seq
        s, _ = b.open_session(f"churn{seq}", True)
        s.outgoing_sink = _noop_sink
        flts = [f"churn/{seq}/{i}/+" for i in range(n)]
        for flt in flts:
            b.subscribe(s, flt, SubOpts(qos=0))
        self.router.device_table.sync()
        await self.burst([flts[0][:-1] + "x", flts[-1][:-1] + "x"])
        for flt in flts:
            b.unsubscribe(s, flt)
        b.close_session(s, discard=True)
        self.router.device_table.sync()
        return 2 * n  # add legs + delete legs

    def reset_flight_cooldown(self, rule: str) -> None:
        """Clear one trigger rule's cooldown latch. Scenario contracts
        demand a bundle PER scenario; the production cooldown would
        (correctly) coalesce two faults 30s apart into one bundle."""
        fl = self.flight
        if fl is not None:
            fl._last_fired.pop(rule, None)

    def record_fault(self, kind: str, detail: Dict[str, Any]) -> None:
        """Every injection is stamped into the flight ring AND freezes
        a bundle (chaos_fault rule): the forensic record of a chaos
        window carries the inject next to the detections it provoked."""
        self.faults_injected += 1
        self.fault_kinds[kind] = self.fault_kinds.get(kind, 0) + 1
        fl = self.flight
        if fl is not None:
            fl.recorder.record("chaos.inject", "", {"kind": kind, **detail})
            fl.maybe_trigger("chaos_fault", {"kind": kind, **detail})

    def scaled_timeout(self, base: float) -> float:
        """Box-scaled deadline: `base` tuned-wall seconds stretched by
        the measured box-throughput ratio (chaos/boxcal.py). The
        SOAK_r19 `takeover_imported` fix: a wall-clock-fixed 10s settle
        window red-flags a 1-core box that finishes the same work in
        11.4s — the budget must scale with the box, the way the
        replica_drift repair budget already scales with pair count."""
        from .boxcal import scaled

        return scaled(base)

    async def wait_for(
        self,
        pred: Callable[[], bool],
        timeout: float = 5.0,
        poll: float = 0.02,
    ) -> Optional[float]:
        """Poll `pred` until true; returns elapsed seconds or None on
        timeout. The background storm keeps running underneath."""
        t0 = time.monotonic()
        while True:
            if pred():
                return time.monotonic() - t0
            if time.monotonic() - t0 > timeout:
                return None
            await asyncio.sleep(poll)

    async def drive_until(
        self,
        pred: Callable[[], bool],
        flt: Optional[str] = None,
        timeout: float = 10.0,
    ) -> Optional[float]:
        """Like wait_for, but each poll round ALSO pushes a small fresh
        burst through the engine — recovery legs (table re-sync,
        auto-unquarantine) only advance when matches are served."""
        t0 = time.monotonic()
        while True:
            if pred():
                return time.monotonic() - t0
            if time.monotonic() - t0 > timeout:
                return None
            topics = (
                [self.fresh_topic(flt)]
                if flt is not None
                else self.topics.draw(16)
            )
            await self.burst(topics)
            await asyncio.sleep(0.01)

    # --- verification -----------------------------------------------------

    async def audit_sweep(self, per_groups: int = 512) -> Dict[str, Any]:
        """Full-truth verification pass: serve a batch through the
        device path and compare EVERY answer against the host oracle.
        This is the 'zero silent divergence' leg — anything the
        sampled audit missed shows up here."""
        r = self.router
        rng = np.random.default_rng(self.seed + 1)
        n_groups = min(per_groups, self.fleet.groups)
        picks = rng.choice(self.fleet.groups, size=n_groups, replace=False)
        topics = [
            self.fleet.topic_of(int(g), f"sweep{self._chaos_seq}")
            for g in picks
        ]
        topics += [self.fresh_topic(f) for f in self.chaos_filters]
        served = r.match_filters_finish(r.match_filters_begin(topics))
        silent = []
        for t, s_ in zip(topics, served):
            if sorted(s_) != sorted(r.match_filters(t)):
                silent.append(t)
        return {
            "topics_swept": len(topics),
            "silent_divergences": len(silent),
            "diverging_topics": silent[:8],
        }

    async def drain_clean_streak(self) -> None:
        """Serve enough clean sampled publishes to clear the divergence
        alarm (CLEAN_STREAK_TO_CLEAR consecutive clean audits)."""
        from ..obs.sentinel import CLEAN_STREAK_TO_CLEAR

        need = (CLEAN_STREAK_TO_CLEAR + 4) * max(1, self.sentinel.sample_n)
        step = max(64, self.storm_chunk)
        for _ in range(0, need, step):
            await self.burst(self.topics.draw(step))
            if not self.alarms.is_active("xla_audit_divergence"):
                break

    # --- durable tier -----------------------------------------------------

    def _open_durable(self, first: bool) -> None:
        """Open (or re-open after ds_kill) the durable tier from
        `data_dir`: the WAL-backed message DB, the durable session
        manager with its persist gate, the fail-stop wiring, and the
        QoS1 mini-fleet on `dur/<k>/+`. On reboot (`first=False`) this
        IS the boot-side recovery path: shard WALs replay CRC-verified,
        sessions resume at their committed positions (at-least-once),
        and the ps-routes rebuild from their subscriptions."""
        from ..ds.api import Db
        from ..ds.session_ds import DurableSessionManager

        ds_dir = os.path.join(self.data_dir, "ds")
        t0 = time.monotonic()
        self.durable_db = Db(
            "chaos-messages", data_dir=ds_dir, n_shards=2,
            buffer_flush_ms=5,
        )
        self.durable_db.storage.on_shard_failed = self._on_shard_failed
        self.durable_mgr = DurableSessionManager(
            self.durable_db, state_dir=ds_dir
        )
        self.broker.enable_durable(self.durable_mgr)
        # recovery wall-time is bounded by replay cost: compact any
        # shard whose WAL bloated past the ratio while we were down
        compacted = self.durable_db.maybe_compact()
        cfg = SessionConfig(
            session_expiry_interval=3600.0, max_mqueue_len=512
        )
        for k in range(self.durable_sessions):
            s, _present = self.broker.open_session(
                f"dur-{k}", clean_start=first, cfg=cfg
            )
            self.broker.subscribe(s, f"dur/{k}/+", SubOpts(qos=1))
        self.ds_recovery = {
            "open_ms": round((time.monotonic() - t0) * 1e3, 2),
            "db": self.durable_db.recovery_report(),
            "sessions": self.durable_mgr.recovery_report(),
            "compacted_shards": compacted,
            "reboots": self._dur_reboots,
        }

    def _on_shard_failed(self, shard_id: int, exc: BaseException) -> None:
        """Fail-stop fan-out (called OUTSIDE the shard lock, possibly
        from the buffer flush thread): page + freeze forensics."""
        self.ds_shard_failures.append(
            (time.monotonic(), shard_id, type(exc).__name__)
        )
        self.alarms.ensure(
            f"ds_shard_failed_{shard_id}",
            details={"shard": shard_id, "error": str(exc)},
            message=f"durable shard {shard_id} fail-stopped: {exc}",
        )
        fl = self.flight
        if fl is not None:
            fl.maybe_trigger(
                "ds_shard_failed",
                {"shard": shard_id, "error": str(exc)},
            )

    async def durable_publish(self, n: int = 8) -> List[bytes]:
        """Publish `n` QoS1 messages into the durable tier through the
        broker publish path (the persist gate stores them), then flush
        the DS buffer so the batch reaches the WAL fsynced — i.e.
        acked-durable. Returns the unique payloads (the loss-accounting
        ledger). The flush raises ShardFailedError when the target
        shard fail-stops under an injected disk fault."""
        payloads: List[bytes] = []
        groups = max(1, self.durable_sessions)
        base = self.dur_published
        for i in range(n):
            self._chaos_seq += 1
            p = f"dur{self._chaos_seq}".encode()
            self.broker.publish(
                Message(
                    topic=f"dur/{(base + i) % groups}/m{self._chaos_seq}",
                    payload=p,
                    qos=1,
                )
            )
            payloads.append(p)
        self.dur_published += n
        self.durable_db.buffer.flush_now()
        await asyncio.sleep(0)
        return payloads

    async def ds_failstop_settled(self) -> Optional[float]:
        """Wait until every shard fail-stop's fan-out (`_on_shard_failed`:
        the alarm, then the flight trigger) has returned, bounded by
        `settle_timeout`. The fan-out runs on whichever thread hit the
        fault, the DS buffer's flush thread too, so a scenario that sees
        `failed_shards()` may otherwise read its checks between the
        alarm and the trigger. Returns the seconds waited, or None."""
        return await self.wait_for(
            lambda: not self.durable_db.failstop_pending(),
            timeout=self.settle_timeout,
        )

    async def ds_refused_since(self, before: Dict[int, int]):
        """(failed shards, flushes the DS buffer refused on them since
        `before`, a copy of `buffer.refused`), read once a shard reads
        failed, a refusal on it is counted and no flush is in hand,
        bounded by `settle_timeout`. The flush that hit the fault may
        run on the buffer's flush thread, not the scenario's: the buffer
        counts a refusal on every thread, so the scenario reads it
        whoever flushed."""
        db = self.durable_db
        buf = db.buffer

        def refused() -> int:
            return sum(buf.refused[s] - before.get(s, 0) for s in db.failed_shards())

        await self.wait_for(
            lambda: buf.flushing == 0 and refused() >= 1,
            timeout=self.settle_timeout,
        )
        return list(db.failed_shards()), refused()

    async def durable_drain(self, rounds: int = 64) -> List[bytes]:
        """Pump every durable session and puback everything delivered,
        committing stream positions (the consumed ledger). Returns the
        delivered payloads."""
        got: List[bytes] = []
        mgr = self.durable_mgr
        for _ in range(rounds):
            new = 0
            for s in list(mgr.sessions.values()):
                if not s.client_id.startswith("dur-"):
                    continue
                s.connected = True
                for pkt in mgr.pump(s):
                    got.append(bytes(pkt.payload))
                    if pkt.packet_id:
                        s.on_puback(pkt.packet_id)
                    new += 1
            if new == 0:
                break
            await asyncio.sleep(0)
        self.dur_delivered += len(got)
        return got

    async def ds_recover(self) -> List[int]:
        """Probe-verified recovery of every fail-stopped shard: reopen
        + replay + write/fsync/read-back probe; a shard's alarm clears
        only when its probe passes."""
        ok: List[int] = []
        for sid in list(self.durable_db.failed_shards()):
            if self.durable_db.recover_shard(sid):
                ok.append(sid)
                self.alarms.ensure_deactivated(f"ds_shard_failed_{sid}")
        return ok

    def ds_kill(self) -> None:
        """Simulated SIGKILL of the durable tier: unflushed buffer
        dropped (it was never acked durable), no fsync boundary on the
        WALs, persist gate detached, session objects lost with the
        process. The data dir survives for ds_reboot()."""
        mgr, db = self.durable_mgr, self.durable_db
        if mgr is None:
            return
        self.broker.hooks.delete("message.publish", mgr._persist_gate)
        self.broker.durable = None
        mgr.kill()
        db.kill()
        for cid in [
            c for c in self.broker.sessions if c.startswith("dur-")
        ]:
            self.broker.sessions.pop(cid, None)
            self.broker.router.dest_store.note_session(cid, None)
        self.durable_mgr = None
        self.durable_db = None

    async def ds_reboot(self) -> float:
        """Boot-side crash recovery from the surviving data dir: WAL
        replay (CRC-verified, torn tail truncated), durable sessions
        resumed at committed positions, ps-routes rebuilt. Returns
        recovery wall-time ms."""
        from ..ds.metrics import DS_METRICS

        t0 = time.monotonic()
        self._dur_reboots += 1
        self._open_durable(first=False)
        ms = (time.monotonic() - t0) * 1e3
        self.ds_recovery["recovery_ms"] = round(ms, 2)
        DS_METRICS.gauge("recovery_last_ms", ms)
        await asyncio.sleep(0)
        return ms

    # --- the soak ---------------------------------------------------------

    async def run(
        self,
        scenarios: Optional[Sequence] = None,
        baseline_s: float = 10.0,
    ) -> Dict[str, Any]:
        """Run the catalog under a continuous storm; returns the soak
        row. Contract violations are collected per scenario and raised
        as ONE ContractViolation after the row is assembled — the row
        itself records exactly which check failed."""
        from .scenarios import scenario_catalog

        if not self.fleet.clients:
            await self.setup()
        cat = list(scenarios if scenarios is not None else scenario_catalog())
        t_run0 = time.monotonic()
        self.storm_start()
        results = []
        try:
            if baseline_s > 0:
                await asyncio.sleep(baseline_s)
            for sc in cat:
                if sc.needs_cluster:
                    raise NotImplementedError(
                        f"scenario {sc.name!r} {NOT_PORTED}"
                    )
                if sc.needs_mesh and self.router.mesh is None:
                    continue
                if getattr(sc, "needs_durable", False) and (
                    self.durable_db is None
                ):
                    continue
                self.progress(f"scenario: {sc.name}")
                res = await sc.run(self)
                results.append(res)
                self.scenario_results.append(res)
        finally:
            await self.storm_stop()
        # end-state verification: recover the clean streak, then the
        # full-truth sweep
        await self.drain_clean_streak()
        sweep = await self.audit_sweep()
        row = self.soak_row(results, sweep, time.monotonic() - t_run0)
        bad = [
            f"{res.name}: {chk.name} ({chk.detail})"
            for res in results
            for chk in res.checks
            if not chk.ok
        ]
        if sweep["silent_divergences"]:
            bad.append(f"final sweep: {sweep['silent_divergences']} silent")
        row["contracts_ok"] = not bad
        row["violations"] = bad
        return row

    def soak_row(
        self, results, sweep: Dict[str, Any], run_seconds: float
    ) -> Dict[str, Any]:
        st = self.sentinel
        counters = self.counters()
        elapsed = max(self.storm_elapsed(), 1e-9)
        sessions_total = len(self.broker.sessions)
        alarms_fired = self.alarms.fired_since(0.0)
        row = {
            "sessions": sessions_total,
            "connected": self.broker.connected_count(),
            "subscriptions": len(self.broker.suboptions),
            "groups": self.fleet.groups,
            "zipf_s": self.zipf_s,
            "setup_seconds": round(self.setup_seconds, 2),
            "run_seconds": round(run_seconds, 2),
            "storm": {
                "published": self.published,
                "delivered": self.delivered,
                "storm_seconds": round(elapsed, 2),
                "sustained_pub_per_sec": round(self.published / elapsed, 1),
                "delivered_per_sec": round(self.delivered / elapsed, 1),
                "errors": self.storm_errors,
                # wall-clock submit→delivered per storm chunk of
                # `storm_chunk` publishes: e2e including loop
                # scheduling + pipeline residency, so chaos-window
                # stalls (purges, rejoins) land here in full
                "chunk_size": self.storm_chunk,
                "e2e_chunk_p50_ms": round(
                    self.chunk_hist.percentile(50) * 1e3, 2
                ),
                "e2e_chunk_p99_ms": round(
                    self.chunk_hist.percentile(99) * 1e3, 2
                ),
            },
            "publish_p50_ms_incl_chaos": round(
                st.total_hist.percentile(50) * 1e3, 4
            ),
            "publish_p99_ms_incl_chaos": round(
                st.total_hist.percentile(99) * 1e3, 4
            ),
            "stage_p99_ms": {
                s_: round(h.percentile(99) * 1e3, 4)
                for s_, h in sorted(st.stage_hist.items())
            },
            "divergences_injected": self.faults_injected,
            "divergences_detected": self.faults_detected,
            # corruption faults are detected by the shadow audit (and
            # counted in audit.divergence_total); wire faults
            # (partition) by the membership layer
            "faults_by_kind": dict(sorted(self.fault_kinds.items())),
            "silent_divergences": sweep["silent_divergences"],
            "final_sweep": sweep,
            "audit": {
                "total": counters.get("audit_total", 0),
                "clean": counters.get("audit_clean_total", 0),
                "divergence_total": counters.get(
                    "audit_divergence_total", 0
                ),
                "skipped_stale": counters.get(
                    "audit_skipped_stale_total", 0
                ),
                "quarantined": counters.get("audit_quarantine_total", 0),
                "unquarantined": counters.get(
                    "audit_unquarantine_total", 0
                ),
            },
            "rpc": {
                "retries": counters.get("rpc_retry_total", 0),
                "unreachable": counters.get("rpc_unreachable_total", 0),
            },
            # device failure domain: the breaker's whole trip →
            # degrade → probe → resync → close ledger, plus admission
            "breaker": {
                "state_at_end": self.broker.engine.breaker_state,
                "trips": counters.get("breaker_trips_total", 0),
                "recoveries": counters.get("breaker_recoveries_total", 0),
                "device_failures": counters.get(
                    "breaker_device_failures_total", 0
                ),
                "fallback_publishes": counters.get(
                    "breaker_fallback_total", 0
                ),
                "degraded_batches": counters.get(
                    "breaker_degraded_batches_total", 0
                ),
                "probes": counters.get("breaker_probe_total", 0),
                "probe_failures": counters.get(
                    "breaker_probe_failures_total", 0
                ),
                "device_resyncs": counters.get("device_resyncs_total", 0),
                # shard failure domain (chip-granular breaker)
                "shard_trips": counters.get(
                    "breaker_shard_trips_total", 0
                ),
                "shard_evacuations": counters.get(
                    "breaker_shard_evacuations_total", 0
                ),
                "shard_recoveries": counters.get(
                    "breaker_shard_recoveries_total", 0
                ),
                "shard_overlays": counters.get("shard_overlay_total", 0),
                "queue_shed": counters.get("queue_shed_total", 0),
                "queue_blocked": counters.get("queue_blocked_total", 0),
                "queue_deadline_expired": counters.get(
                    "queue_deadline_expired_total", 0
                ),
            },
            "slo": {
                name: obj.evaluate() for name, obj in st.slo.items()
            },
            "alarms_fired": alarms_fired,
            "alarms_active_at_end": sorted(
                a["name"] for a in self.alarms.get_alarms("activated")
            ),
            "flight_bundles": (
                len(self.flight.store.list())
                if self.flight is not None
                else 0
            ),
            "quarantined_at_end": self.router.quarantined_filters(),
            "scenarios": {r.name: r.as_dict() for r in results},
            "knobs": {
                "sample_n": self.sample_n,
                "storm_chunk": self.storm_chunk,
                "chaos_filters": self.n_chaos_filters,
                "chaos_fan": self.chaos_fan,
                "victim_sessions": self.victim_sessions,
            },
            "provenance": provenance(self.router.device),
        }
        if self.durable_db is not None:
            from ..ds.metrics import DS_METRICS

            dsnap = DS_METRICS.snapshot()
            row["ds"] = {
                # crash-consistency ledger: the kill→reboot→recover
                # walk plus the process-global WAL/shard counters
                "recovery": self.ds_recovery,
                "reboots": self._dur_reboots,
                "durable_published": self.dur_published,
                "durable_delivered": self.dur_delivered,
                "shard_failures": len(self.ds_shard_failures),
                "failed_at_end": self.durable_db.failed_shards(),
                "wal_replayed_records": dsnap.get(
                    "wal_replayed_records_total", 0
                ),
                "wal_torn_records": dsnap.get("wal_torn_records_total", 0),
                "wal_crc_failures": dsnap.get("wal_crc_failures_total", 0),
                "wal_upgraded_files": dsnap.get(
                    "wal_upgraded_files_total", 0
                ),
                "shard_fail_stops": dsnap.get("shard_failures_total", 0),
                "shard_recoveries": dsnap.get("shard_recoveries_total", 0),
                "recovery_last_ms": dsnap.get("recovery_last_ms", 0.0),
                "disk_faults_injected": (
                    dict(sorted(self.disk_injector.injected.items()))
                    if self.disk_injector is not None
                    else {}
                ),
            }
        return row

    # --- builders / teardown ----------------------------------------------

    @classmethod
    async def standalone(
        cls,
        *,
        sessions: int = 10_000,
        data_dir: Optional[str] = None,
        device=None,
        mesh=None,
        **kw,
    ) -> "ChaosEngine":
        """An engine over a fresh Broker on `device` (None: the CUDA
        card, raising when none is present; "cpu": the plain versions)
        with its own Observability under `data_dir`. With `mesh`
        (parallel.mesh.make_mesh) the router's table is sub-sharded
        across it, which the mesh scenarios need."""
        import tempfile

        from ..broker.pubsub import Broker
        from ..obs import Observability

        base = data_dir or tempfile.mkdtemp(prefix="chaos_")
        broker = Broker(device=device, mesh=mesh)
        obs = Observability(
            broker,
            node_name="chaos@local",
            trace_dir=f"{base}/trace",
            flight_dir=f"{base}/flight",
        )
        return cls(broker, obs, sessions=sessions, data_dir=base, **kw)

    @classmethod
    async def cluster(cls, **kw) -> "ChaosEngine":
        raise NotImplementedError(f"the cluster chaos engine {NOT_PORTED}")

    async def close(self) -> None:
        await self.storm_stop()
        eng = self.broker.engine
        if eng is not None and not eng.closed:
            await eng.stop()
        if self.disk_injector is not None:
            self.disk_injector.heal()
            self.disk_injector.uninstall()
        if self.durable_mgr is not None:
            try:
                self.durable_mgr.close()
            except Exception:
                log.exception("durable manager close failed")
            self.durable_mgr = None
        if self.durable_db is not None:
            try:
                self.durable_db.close()
            except Exception:
                log.exception("durable db close failed")
            self.durable_db = None
        if self.obs is not None:
            self.obs.stop()


async def run_soak(
    *,
    sessions: int = 1_000_000,
    victim_sessions: int = 0,
    groups: Optional[int] = None,
    zipf_s: float = 1.2,
    sample_n: int = 64,
    baseline_s: float = 20.0,
    scenarios: Optional[Sequence[str]] = None,
    report_path: Optional[str] = None,
    data_dir: Optional[str] = None,
    progress: Optional[Callable[[str], None]] = None,
    strict: bool = True,
    device=None,
    **engine_kw,
) -> Dict[str, Any]:
    """Build the engine on `device`, run the single-device scenario
    catalog under the storm, write the soak row to `report_path` when
    one is given, and assert the contracts. The entry
    `python -m emqx_tpu_torch.chaos` calls. The broker has no mesh, so
    the catalog's mesh scenarios are skipped. `victim_sessions > 0`
    (the clustered soak) raises NotImplementedError, as does a cluster
    scenario asked for by name."""
    from .scenarios import scenarios_by_name

    if victim_sessions > 0:
        raise NotImplementedError(f"victim_sessions {NOT_PORTED}")
    cat = scenarios_by_name(scenarios) if scenarios is not None else None
    eng = await ChaosEngine.standalone(
        sessions=sessions,
        groups=groups,
        zipf_s=zipf_s,
        sample_n=sample_n,
        data_dir=data_dir,
        progress=progress,
        device=device,
        **engine_kw,
    )
    try:
        await eng.setup()
        row = await eng.run(cat, baseline_s=baseline_s)
    finally:
        await eng.close()
    if report_path:
        with open(report_path, "w") as f:
            json.dump(row, f, indent=1, default=str)
        (progress or log.info)(f"soak row written: {report_path}")
    if strict and not row["contracts_ok"]:
        raise ContractViolation("; ".join(row["violations"]))
    return row


def provenance(device) -> Dict[str, Any]:
    """Where a soak row was measured: python, torch and its CUDA
    version, the platform ("gpu" or "cpu"), and on the card its name
    and power limit as nvidia-smi reports them."""
    import platform
    import subprocess

    import torch

    dev = torch.device(device)
    out: Dict[str, Any] = {
        "python": platform.python_version(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "devices": torch.cuda.device_count() if dev.type == "cuda" else 1,
        "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    if dev.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(dev)
        try:
            out["card"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"],
                capture_output=True, text=True, timeout=30, check=True,
            ).stdout.strip()
        except (OSError, subprocess.SubprocessError) as e:
            out["card"] = f"nvidia-smi failed: {e!r}"
    return out
