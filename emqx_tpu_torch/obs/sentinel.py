"""Publish-path sentinel — continuous correctness + latency watchdog
(the port's own copy of emqx_tpu/obs/sentinel.py).

The port's publish path is held equal to the host oracle in tests and
on the card by chip_smoke.py; this module keeps that check running
against the SERVED path, sampled, with three continuous checks:

  * **Shadow-oracle audit** — for 1/N served publishes (the
    `broker.perf.tpu_audit_sample_n` knob) the dispatch engine captures
    the device match result and the fanout plan that actually served,
    and the sentinel re-runs the host oracle (`Router.match_filters` +
    `Broker._build_fanout_plan`) on a deferred event-loop turn. It
    reads only what finish already fetched: no device tensor is read
    again. A mismatch is a divergence: it bumps
    `emqx_xla_audit_divergence_total`, freezes a flight-recorder
    bundle through the `audit_divergence` trigger rule, raises the
    `xla_audit_divergence` alarm, and — behind `tpu_audit_quarantine`
    — quarantines the diverging filters to the host-walk fallback
    (Router.quarantine_filters) until the next clean table sync
    rewrites their device rows (auto-unquarantine, counted). Audits of
    state that mutated since serve are skipped (counted), never
    reported as divergence. (The metric and alarm names are the
    reference's, kept so the two scrapes compare one to one.)

  * **Per-publish stage attribution** — a sampled publish carries a
    StageSpan through the pipeline: queue (engine wait), encode (topic
    dictionary-encode), kernel (the host's launch: CUDA launches are
    asynchronous, so this is enqueue time, not device time), transfer
    (the blocked device->host wait in finish), fetch (the rest of
    finish: verify/unpack), resolve (fanout-plan install), deliver
    (dispatch fan-out). Stages land in
    `emqx_xla_publish_stage_seconds{stage=..}` streaming histograms
    (the kernel-telemetry bucket ladder, so p99s are
    runtime-queryable) plus a bounded exemplar ring of (topic, trace
    id, per-stage ms) — a p99 breach names its stage. Unsampled
    publishes pay one attribute read + one counter increment.

  * **SLO tracker** — publish-latency and audit-cleanliness objectives
    with fast/slow burn-rate windows (the multiwindow multi-burn-rate
    alerting shape): error budget = 1 - target, burn = observed error
    rate / budget, and the alarm raises only when BOTH windows burn
    above threshold (fast reacts, slow confirms), clearing when either
    recovers. Burn rates surface on the Prometheus scrape
    (`emqx_xla_slo_*`) and in `status()`/`summary()`. The reference's
    cluster rollup over the RPC plane comes with the cluster layer.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from .kernel_telemetry import (
    CountHistogram,
    StreamingHistogram,
    render_histogram_lines,
)
from .profiler import DELIVERY_STAGES

log = logging.getLogger("emqx_tpu_torch.obs.sentinel")

# pipeline stages in pipeline order — the label values of
# emqx_xla_publish_stage_seconds. `transfer` is the residual
# device->host wait the finish half actually blocked for (the eager
# copy_to_host_async overlap makes it ~zero on a healthy ring);
# `fetch` is the rest of what finish forces (escalation, verify/
# unpack, deep-trie fold).
STAGES = (
    "queue", "encode", "kernel", "transfer", "fetch", "resolve", "deliver"
)

# fan-size histogram bounds: powers of two up to 1M subscribers — the
# kernel-telemetry seconds ladder tops out at ~8.9 so counts need
# their own scale
FAN_BOUNDS = tuple(2.0 ** i for i in range(21))

# the decomposition contract: per sampled span, sum(sub-stages) must
# land within this fraction of the measured queue+deliver wall, or the
# span counts as out-of-band (the self-check that keeps the
# sub-decomposition from silently lying)
DECOMP_TOLERANCE = 0.10

ALARM_DIVERGENCE = "xla_audit_divergence"

# consecutive clean audits (with no active quarantine) that clear the
# divergence alarm — long enough that a flapping corruption can't
# silence itself between samples
CLEAN_STREAK_TO_CLEAR = 16

# SLO evaluation cadence in samples: a breach evaluation scans both
# burn windows, so successes amortize it; a FAILED sample always
# evaluates immediately (a storm must not wait out the cadence)
SLO_EVAL_EVERY = 8


class StageSpan:
    """Per-sampled-publish stage accumulator. `add` is the only hot
    call: one dict write. Batch-level stages (encode/kernel/fetch,
    shared by every publish coalesced into one dispatch) merge in at
    collect time — standard exemplar semantics: the sampled publish
    carries its batch's device legs."""

    __slots__ = ("topic", "trace_id", "stages", "subs", "fan")

    def __init__(self, topic: str = "", trace_id: str = ""):
        self.topic = topic
        self.trace_id = trace_id
        self.stages: Dict[str, float] = {}
        # delivery sub-stages (DELIVERY_STAGES) — the decomposition of
        # the queue+deliver wall, kept separate so span.total() stays
        # the wall total and never double-counts
        self.subs: Dict[str, float] = {}
        # per-publish fanout plan size, stamped by Broker._fanout
        self.fan = 0

    def add(self, stage: str, seconds: float) -> None:
        self.stages[stage] = self.stages.get(stage, 0.0) + seconds

    def add_sub(self, stage: str, seconds: float) -> None:
        self.subs[stage] = self.subs.get(stage, 0.0) + seconds

    def merge(self, other: "StageSpan") -> None:
        for k, v in other.stages.items():
            self.add(k, v)
        for k, v in other.subs.items():
            self.add_sub(k, v)
        if other.fan:
            self.fan += other.fan

    def total(self) -> float:
        return sum(self.stages.values())

    def sub_total(self) -> float:
        return sum(self.subs.values())


class SloObjective:
    """One objective: a target success ratio and two burn-rate
    windows. Events are (monotonic ts, ok) in a bounded deque — the
    feed is sampled publishes/audits, not raw traffic, so the scan
    cost at record/evaluate time is bounded and off the hot path."""

    def __init__(
        self,
        name: str,
        target: float = 0.999,
        fast_window_s: float = 300.0,
        slow_window_s: float = 3600.0,
        burn_threshold: float = 10.0,
        min_events: int = 8,
        max_events: int = 4096,
    ):
        self.name = name
        self.target = min(max(target, 0.0), 1.0 - 1e-9)
        self.fast_window_s = fast_window_s
        self.slow_window_s = slow_window_s
        self.burn_threshold = burn_threshold
        self.min_events = min_events
        self.events: Deque[Tuple[float, bool]] = deque(maxlen=max_events)
        self.ok_total = 0
        self.bad_total = 0
        self.breached = False

    def record(self, ok: bool, now: Optional[float] = None) -> None:
        self.events.append(
            (time.monotonic() if now is None else now, bool(ok))
        )
        if ok:
            self.ok_total += 1
        else:
            self.bad_total += 1

    def burn_rate(
        self, window_s: float, now: Optional[float] = None
    ) -> Optional[float]:
        """Error-budget burn over the window: error_rate / (1-target).
        1.0 = exactly consuming budget; None below `min_events` (too
        little signal to alert on)."""
        now = time.monotonic() if now is None else now
        cutoff = now - window_s
        total = bad = 0
        for ts, ok in reversed(self.events):
            if ts < cutoff:
                break
            total += 1
            if not ok:
                bad += 1
        if total < self.min_events:
            return None
        return (bad / total) / (1.0 - self.target)

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Multiwindow rule: breach requires BOTH windows over the
        threshold (fast reacts to a new storm, slow keeps a brief blip
        from paging); recovery on either window dropping back."""
        fast = self.burn_rate(self.fast_window_s, now)
        slow = self.burn_rate(self.slow_window_s, now)
        if fast is not None and slow is not None:
            if fast > self.burn_threshold and slow > self.burn_threshold:
                self.breached = True
            elif (
                fast <= self.burn_threshold or slow <= self.burn_threshold
            ):
                self.breached = False
        return {
            "target": self.target,
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "burn_threshold": self.burn_threshold,
            "fast_burn": None if fast is None else round(fast, 4),
            "slow_burn": None if slow is None else round(slow, 4),
            "ok_total": self.ok_total,
            "bad_total": self.bad_total,
            "breached": self.breached,
        }


class _AuditRecord:
    __slots__ = ("topic", "filters", "pairs", "gen", "trace_id")

    def __init__(self, topic, filters, pairs, gen, trace_id):
        self.topic = topic
        self.filters = filters
        self.pairs = pairs
        self.gen = gen
        self.trace_id = trace_id


class PublishSentinel:
    """Attached at boot alongside KernelTelemetry (broker.sentinel is
    the None-seam the dispatch engine probes). All counters land in
    the router's KernelTelemetry collector so `emqx_xla_audit_*`
    families ride the existing scrape; the stage histograms and SLO
    gauges render from prometheus_lines here."""

    def __init__(
        self,
        broker,
        sample_n: int = 1024,
        quarantine: bool = True,
        alarms=None,
        flight=None,
        slo_publish_ms: float = 50.0,
        slo_publish_target: float = 0.999,
        slo_audit_target: float = 0.999,
        slo_fast_window_s: float = 300.0,
        slo_slow_window_s: float = 3600.0,
        slo_burn_threshold: float = 10.0,
        max_pending_audits: int = 64,
        max_exemplars: int = 32,
        warmup_spans: int = 0,
    ):
        self.broker = broker
        self.router = broker.router
        self.telemetry = self.router.telemetry
        self.sample_n = max(0, int(sample_n))
        self.quarantine_enabled = bool(quarantine)
        self.alarms = alarms
        self.flight = flight
        self.slo_publish_ms = slo_publish_ms
        self.stage_hist: Dict[str, StreamingHistogram] = {}
        self.total_hist = StreamingHistogram()
        # delivery sub-stage decomposition: the queue+deliver
        # wall split into DELIVERY_STAGES, plus the fan-size histogram
        # and the sum-to-wall self-check counters
        self.delivery_hist: Dict[str, StreamingHistogram] = {}
        # fan width is a COUNT: the unitless histogram keeps it from
        # ever rendering as milliseconds
        self.fan_hist = CountHistogram(bounds=FAN_BOUNDS)
        # broker.perf.tpu_delivery_stages gate: False parks the
        # sub-stage histograms (spans still carry publish stages)
        self.delivery_stages_enabled = True
        self.decomp_in_band = 0
        self.decomp_out_of_band = 0
        self.decomp_last_ratio = 0.0
        self.forwarded_spans_total = 0
        self.exemplars: Deque[Dict[str, Any]] = deque(maxlen=max_exemplars)
        self.slo = {
            "publish_latency": SloObjective(
                "publish_latency",
                target=slo_publish_target,
                fast_window_s=slo_fast_window_s,
                slow_window_s=slo_slow_window_s,
                burn_threshold=slo_burn_threshold,
            ),
            "audit_clean": SloObjective(
                "audit_clean",
                target=slo_audit_target,
                fast_window_s=slo_fast_window_s,
                slow_window_s=slo_slow_window_s,
                burn_threshold=slo_burn_threshold,
            ),
        }
        # warmup exclusion: the first sampled spans may ride a kernel
        # build or a first launch, not a serve-path stall. The first `warmup_spans` finished spans are counted and
        # exemplar'd but kept OUT of the serve-stage histograms/SLO.
        # 0 (the bare-broker default) disables the exclusion.
        self.warmup_left = max(0, int(warmup_spans))
        self.warmup_skipped = 0
        self._tick = 0
        self._ack_tick = 0
        self._slo_tick = 0
        self._pending: Deque[_AuditRecord] = deque(maxlen=max_pending_audits)
        self._drain_scheduled = False
        self._clean_streak = 0
        self.spans_total = 0
        self.divergences: Deque[Dict[str, Any]] = deque(maxlen=16)
        # divergence listeners (chaos engine / tests): called with the
        # divergence summary the moment an audit confirms one — lets a
        # harness timestamp detection latency without polling counters
        self.on_divergence: List[Any] = []

    # --- sampling (the only per-publish cost) ----------------------------

    def maybe_span(self, msg) -> Optional[StageSpan]:
        """One increment + one modulo per publish; a hit builds the
        span (and pays the trace-id hash) for this publish only."""
        n = self.sample_n
        if n == 0:
            return None
        self._tick += 1
        if self._tick % n:
            return None
        from .otel import trace_id_of

        self.spans_total += 1
        return StageSpan(msg.topic, trace_id_of(msg))

    def batch_span(self) -> StageSpan:
        """Accumulator for batch-level stages (encode/kernel/fetch/
        resolve), merged into each sampled publish's span at collect."""
        return StageSpan()

    def maybe_ack_clock(self):
        """1/sample_n ack sweeps get wall-timed into the `ack_sweep`
        delivery histogram (channel._handle_ack wraps its body with
        the returned clock) — same probe-free discipline as
        maybe_span: one increment + one modulo per ack packet."""
        n = self.sample_n
        if n == 0:
            return None
        self._ack_tick += 1
        if self._ack_tick % n:
            return None
        return self.telemetry.clock

    def forwarded_span(self, msg) -> Optional[StageSpan]:
        """Remote-side span for a cluster-forwarded publish. The
        origin node stamps its sampled span's trace id into the wire
        payload (`sentinel_trace`); here the receiving node forces a
        span carrying that SAME id, so remote-side delivery sub-stage
        samples join the originating trace — the Dapper propagation
        shape over the broker RPC plane. Forwards without the header
        (origin didn't sample them) stay probe-free."""
        if self.sample_n == 0:
            return None
        trace = msg.headers.get("sentinel_trace") if msg.headers else None
        if not trace:
            return None
        self.spans_total += 1
        self.forwarded_spans_total += 1
        return StageSpan(msg.topic, str(trace))

    # --- stage attribution -----------------------------------------------

    def finish_span(self, span: StageSpan) -> None:
        if self.warmup_left > 0:
            # compile-warmup span: visible as an exemplar (honestly
            # flagged), excluded from the serve-stage stats
            self.warmup_left -= 1
            self.warmup_skipped += 1
            total = span.total()
            self.exemplars.append(
                {
                    "topic": span.topic,
                    "trace_id": span.trace_id,
                    "total_ms": round(total * 1e3, 4),
                    "stages_ms": {
                        k: round(v * 1e3, 4)
                        for k, v in span.stages.items()
                    },
                    "subs_ms": {
                        k: round(v * 1e3, 4) for k, v in span.subs.items()
                    },
                    "fan": span.fan,
                    "warmup": True,
                }
            )
            return
        for stage, s in span.stages.items():
            h = self.stage_hist.get(stage)
            if h is None:
                h = self.stage_hist[stage] = StreamingHistogram()
            h.observe(s)
        if self.delivery_stages_enabled:
            for stage, s in span.subs.items():
                self.observe_delivery(stage, s)
            if span.fan:
                self.fan_hist.observe(float(span.fan))
        # decomposition self-check: the sub-stages must sum to within
        # DECOMP_TOLERANCE of the queue+deliver wall they decompose —
        # a drifting ratio means a sub-stage lost its recording site
        if span.subs:
            wall = span.stages.get("queue", 0.0) + span.stages.get(
                "deliver", 0.0
            )
            sub_total = span.sub_total()
            if wall > 1e-9:
                self.decomp_last_ratio = sub_total / wall
                if abs(sub_total - wall) <= DECOMP_TOLERANCE * wall:
                    self.decomp_in_band += 1
                else:
                    self.decomp_out_of_band += 1
        total = span.total()
        self.total_hist.observe(total)
        self.exemplars.append(
            {
                "topic": span.topic,
                "trace_id": span.trace_id,
                "total_ms": round(total * 1e3, 4),
                "stages_ms": {
                    k: round(v * 1e3, 4) for k, v in span.stages.items()
                },
                "subs_ms": {
                    k: round(v * 1e3, 4) for k, v in span.subs.items()
                },
                "fan": span.fan,
            }
        )
        slo = self.slo["publish_latency"]
        slo.record(total * 1e3 <= self.slo_publish_ms)
        # evaluating burns scans both windows; amortize it — the alarm
        # can lag by a few samples, the deque can't lose any
        self._slo_tick += 1
        if self._slo_tick % SLO_EVAL_EVERY == 0 or not slo.events[-1][1]:
            self._slo_alarm("publish_latency", slo.evaluate())

    def observe_delivery(self, stage: str, seconds: float) -> None:
        """Direct sub-stage observation — spans fold through here, and
        ack/retry sweeps that run outside any publish span (the QoS1/2
        timer path) record their `ack_sweep` time here so ack traffic
        stays visible in the decomposition."""
        h = self.delivery_hist.get(stage)
        if h is None:
            h = self.delivery_hist[stage] = StreamingHistogram()
        h.observe(seconds)

    # --- shadow-oracle audit ---------------------------------------------

    def capture_audit(
        self,
        topic: str,
        filters: Tuple[str, ...],
        pairs: list,
        gen: int,
        trace_id: str = "",
    ) -> None:
        """Record one served publish for deferred re-verification. The
        hot path cost is one deque append; the oracle walk runs on a
        later event-loop turn (or inline when no loop is running —
        bench/offline use)."""
        self._pending.append(
            _AuditRecord(topic, filters, pairs, gen, trace_id)
        )
        if self._drain_scheduled:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            self.run_audits()
            return
        self._drain_scheduled = True
        loop.call_soon(self._drain_audits)

    def _drain_audits(self) -> None:
        self._drain_scheduled = False
        self.run_audits()

    def run_audits(self) -> int:
        """Drain and verify every pending capture; returns divergences
        found in this drain."""
        found = 0
        while self._pending:
            if self._audit_one(self._pending.popleft()):
                found += 1
        return found

    def _audit_one(self, rec: _AuditRecord) -> bool:
        tel = self.telemetry
        router = self.router
        if router.generation != rec.gen:
            # routes mutated since serve: the served answer was correct
            # for ITS generation but the oracle would answer for NOW —
            # comparing the two reports churn as corruption
            tel.count("audit_skipped_stale_total")
            return False
        tel.count("audit_total")
        served = sorted(rec.filters)
        oracle = sorted(router.match_filters(rec.topic))
        if served != oracle:
            self._divergence(
                rec,
                kind="match",
                detail={
                    "served": served,
                    "oracle": oracle,
                },
                filters=sorted(set(served).symmetric_difference(oracle)),
            )
            return True
        # fanout-plan leg: audit the plan that is still installed for
        # this filter set (the one the dispatch used), if it is still
        # fresh — a stale entry already rebuilds on next use
        broker = self.broker
        entry = broker._fanout_cache.get(rec.filters)
        if entry is not None and broker._plan_entry_fresh(
            entry, rec.filters
        ):
            oracle_plan = broker._build_fanout_plan(rec.pairs)
            if not _plans_equal(entry[1], oracle_plan):
                self._divergence(
                    rec,
                    kind="fanout",
                    detail={
                        "served_plan": _plan_sig(entry[1]),
                        "oracle_plan": _plan_sig(oracle_plan),
                    },
                    filters=list(rec.filters),
                )
                return True
        tel.count("audit_clean_total")
        slo = self.slo["audit_clean"]
        slo.record(True)
        self._clean_streak += 1
        if (
            self._clean_streak >= CLEAN_STREAK_TO_CLEAR
            and not router.quarantined_filters()
            and self.alarms is not None
        ):
            self.alarms.ensure_deactivated(ALARM_DIVERGENCE)
        return False

    def _divergence(
        self, rec: _AuditRecord, kind: str, detail: Dict, filters: List[str]
    ) -> None:
        tel = self.telemetry
        tel.count("audit_divergence_total")
        self._clean_streak = 0
        slo = self.slo["audit_clean"]
        slo.record(False)
        self._slo_alarm("audit_clean", slo.evaluate())
        summary = {
            "kind": kind,
            "topic": rec.topic,
            "filters": filters,
            "generation": rec.gen,
            **detail,
        }
        self.divergences.append(summary)
        for cb in self.on_divergence:
            try:
                cb(summary)
            except Exception:
                log.exception("divergence listener failed")
        log.error(
            "shadow-oracle divergence (%s) on topic %r: device served a "
            "result the host oracle rejects — %s", kind, rec.topic, detail,
        )
        fl = self.flight
        if fl is not None:
            fl.recorder.record(
                "audit.divergence", rec.trace_id,
                {"kind": kind, "topic": rec.topic},
            )
            fl.maybe_trigger("audit_divergence", summary)
        if self.alarms is not None:
            try:
                self.alarms.ensure(
                    ALARM_DIVERGENCE,
                    details=summary,
                    message=f"device publish path diverged from host oracle "
                            f"({kind}) on {rec.topic}",
                )
            except Exception:
                log.exception("divergence alarm failed")
        if self.quarantine_enabled and filters:
            n = self.router.quarantine_filters(filters)
            if n:
                # plans embedding the quarantined filters must rebuild
                # host-side immediately, not on their next stale probe
                for f in filters:
                    self.broker._mark_fanout(f)

    def _slo_alarm(self, name: str, state: Dict[str, Any]) -> None:
        if self.alarms is None:
            return
        alarm = f"xla_slo_{name}_burn"
        try:
            if state["breached"]:
                self.alarms.ensure(
                    alarm,
                    details=state,
                    message=f"SLO {name} burning error budget "
                            f"{state['fast_burn']}x (fast) / "
                            f"{state['slow_burn']}x (slow)",
                )
            else:
                self.alarms.ensure_deactivated(alarm)
        except Exception:
            log.exception("slo alarm transition failed")

    # --- export -----------------------------------------------------------

    def stage_snapshot(self) -> Dict[str, Any]:
        return {
            "sampled_publishes": self.spans_total,
            "sample_n": self.sample_n,
            "warmup_skipped": self.warmup_skipped,
            "total": self.total_hist.snapshot(),
            "stages": {
                s: self.stage_hist[s].snapshot()
                for s in STAGES
                if s in self.stage_hist
            },
            "delivery": {
                s: self.delivery_hist[s].snapshot()
                for s in DELIVERY_STAGES
                if s in self.delivery_hist
            },
            "fan": self.fan_hist.snapshot(),
            "decomposition": self.decomposition_snapshot(),
            "forwarded_spans": self.forwarded_spans_total,
            "exemplars": list(self.exemplars),
        }

    def decomposition_snapshot(self) -> Dict[str, Any]:
        """The sum-to-wall self-check state: how many sampled spans
        decomposed within DECOMP_TOLERANCE of their queue+deliver
        wall, and the latest sub-sum/wall ratio."""
        checked = self.decomp_in_band + self.decomp_out_of_band
        return {
            "tolerance": DECOMP_TOLERANCE,
            "in_band": self.decomp_in_band,
            "out_of_band": self.decomp_out_of_band,
            "in_band_ratio": (
                round(self.decomp_in_band / checked, 4) if checked else None
            ),
            "last_ratio": round(self.decomp_last_ratio, 4),
        }

    def status(self) -> Dict[str, Any]:
        tel = self.telemetry
        counters = getattr(tel, "counters", {})
        return {
            "enabled": self.sample_n > 0,
            "sample_n": self.sample_n,
            "quarantine_enabled": self.quarantine_enabled,
            "quarantined_filters": self.router.quarantined_filters(),
            "audit": {
                "total": counters.get("audit_total", 0),
                "clean": counters.get("audit_clean_total", 0),
                "divergence": counters.get("audit_divergence_total", 0),
                "skipped_stale": counters.get("audit_skipped_stale_total", 0),
                "quarantined": counters.get("audit_quarantine_total", 0),
                "unquarantined": counters.get(
                    "audit_unquarantine_total", 0
                ),
                "pending": len(self._pending),
                "recent_divergences": list(self.divergences),
            },
            "stages": self.stage_snapshot(),
            "slo": {
                "publish_latency_ms": self.slo_publish_ms,
                **{name: obj.evaluate() for name, obj in self.slo.items()},
            },
        }

    def summary(self) -> Dict[str, Any]:
        """Wire-encodable summary (the reference's cluster rollup leaf):
        verdicts and burn rates, not exemplar payloads."""
        tel = self.telemetry
        counters = getattr(tel, "counters", {})
        slo = {name: obj.evaluate() for name, obj in self.slo.items()}
        return {
            "enabled": self.sample_n > 0,
            "audit_total": counters.get("audit_total", 0),
            "audit_divergence": counters.get("audit_divergence_total", 0),
            "quarantined_filters": len(self.router.quarantined_filters()),
            "publish_p99_ms": round(self.total_hist.percentile(99) * 1e3, 4),
            "slo": {
                name: {
                    "fast_burn": s["fast_burn"],
                    "slow_burn": s["slow_burn"],
                    "breached": s["breached"],
                }
                for name, s in slo.items()
            },
        }

    def monitor_sample(self) -> Dict[str, Any]:
        """Flat-ish fields for the dashboard monitor series."""
        counters = getattr(self.telemetry, "counters", {})
        pub = self.slo["publish_latency"].burn_rate(
            self.slo["publish_latency"].fast_window_s
        )
        aud = self.slo["audit_clean"].burn_rate(
            self.slo["audit_clean"].fast_window_s
        )
        return {
            "xla_publish_p99_ms": round(
                self.total_hist.percentile(99) * 1e3, 4
            ),
            "xla_publish_stage_p99_ms": {
                s: round(h.percentile(99) * 1e3, 4)
                for s, h in sorted(self.stage_hist.items())
            },
            "xla_delivery_stage_p99_ms": {
                s: round(h.percentile(99) * 1e3, 4)
                for s, h in sorted(self.delivery_hist.items())
            },
            "xla_audit_divergence": counters.get(
                "audit_divergence_total", 0
            ),
            "xla_slo_publish_burn": 0.0 if pub is None else round(pub, 4),
            "xla_slo_audit_burn": 0.0 if aud is None else round(aud, 4),
        }

    def prometheus_lines(self, node_name: str = "emqx@127.0.0.1") -> List[str]:
        """`emqx_xla_publish_stage_seconds{stage=..}` histograms +
        `emqx_xla_slo_*` gauges. Audit counters already render from the
        kernel-telemetry collector (emqx_xla_audit_*), so only the
        labeled families live here."""
        node = f'node="{node_name}"'
        lines: List[str] = []
        if self.stage_hist:
            fam = "emqx_xla_publish_stage_seconds"
            lines.append(f"# TYPE {fam} histogram")
            for stage in sorted(self.stage_hist):
                render_histogram_lines(
                    lines, fam, f'{node},stage="{stage}"',
                    self.stage_hist[stage], emit_type=False,
                )
        if self.delivery_hist:
            fam = "emqx_xla_delivery_stage_seconds"
            lines.append(f"# TYPE {fam} histogram")
            for stage in sorted(self.delivery_hist):
                render_histogram_lines(
                    lines, fam, f'{node},stage="{stage}"',
                    self.delivery_hist[stage], emit_type=False,
                )
            render_histogram_lines(
                lines, "emqx_xla_delivery_fan", node, self.fan_hist
            )
            decomp = self.decomposition_snapshot()
            lines.append(
                "# TYPE emqx_xla_delivery_decomp_in_band_total counter"
            )
            lines.append(
                f"emqx_xla_delivery_decomp_in_band_total{{{node}}} "
                f"{decomp['in_band']}"
            )
            lines.append(
                "# TYPE emqx_xla_delivery_decomp_out_of_band_total counter"
            )
            lines.append(
                f"emqx_xla_delivery_decomp_out_of_band_total{{{node}}} "
                f"{decomp['out_of_band']}"
            )
            lines.append(
                "# TYPE emqx_xla_delivery_decomp_last_ratio gauge"
            )
            lines.append(
                f"emqx_xla_delivery_decomp_last_ratio{{{node}}} "
                f"{decomp['last_ratio']}"
            )
        evals = {name: obj.evaluate() for name, obj in self.slo.items()}
        lines.append("# TYPE emqx_xla_slo_burn_rate gauge")
        for name, s in sorted(evals.items()):
            for window in ("fast", "slow"):
                v = s[f"{window}_burn"]
                lines.append(
                    f'emqx_xla_slo_burn_rate{{{node},objective="{name}",'
                    f'window="{window}"}} {0.0 if v is None else v}'
                )
        lines.append("# TYPE emqx_xla_slo_breached gauge")
        for name, s in sorted(evals.items()):
            lines.append(
                f'emqx_xla_slo_breached{{{node},objective="{name}"}} '
                f"{int(s['breached'])}"
            )
        return lines


def _plan_sig(plan: tuple) -> Dict[str, list]:
    mem, other = plan
    return {
        "mem": [(c, o.qos) for c, _s, o in mem],
        "other": [(c, f, o.qos) for c, f, o in other],
    }


def _plans_equal(served: tuple, oracle: tuple) -> bool:
    """Plans are bit-identical by contract: same clients, same winning
    QoS, same order (first-seen dict order). Compare the delivery-
    relevant projection in place (no signature materialization — this
    runs per audit over the full fan, so a 100k-fan audit must not
    build four throwaway lists); session objects are skipped because
    the registry note can lag a resubscribe without changing delivery."""
    smem, sother = served
    omem, oother = oracle
    if len(smem) != len(omem) or len(sother) != len(oother):
        return False
    for (c1, _s1, o1), (c2, _s2, o2) in zip(smem, omem):
        if c1 != c2 or o1.qos != o2.qos:
            return False
    for (c1, f1, o1), (c2, f2, o2) in zip(sother, oother):
        if c1 != c2 or f1 != f2 or o1.qos != o2.qos:
            return False
    return True
