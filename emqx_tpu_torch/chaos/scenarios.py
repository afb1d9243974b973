"""The chaos scenario catalog of the port (the port's copy of
emqx_tpu/chaos/scenarios.py, the scenarios that need no cluster), each
with its expected-response contract. A scenario
injects the fault, drives the system while the fault is live, and
asserts the broker's *response* -- detection, alarming, quarantine,
recovery -- not merely that it survived.

Contract vocabulary (every scenario emits `Check` rows):
  * detection:  the sentinel confirms the fault within one audit
    window (a bounded number of sampled publishes);
  * paging:     the matching alarm fired during the scenario window --
    SLOs hold OR burn-rate alarms fire, never breached-and-silent;
  * forensics:  a flight bundle captured the anomaly;
  * recovery:   quarantine engaged AND auto-cleared on the next clean
    sync; the durable tier recovers what it acknowledged;
  * accounting: `emqx_xla_audit_divergence_total` moved for every
    injected fault -- nothing detected-but-uncounted.

The mesh scenarios (chip_loss, chip_flap, reshard_churn) drive the
shard breaker and run only on an engine whose table is sharded across a
mesh. The cluster scenarios need the cluster layer (ROADMAP Queue 1
item 8b), and asking for one by name raises `NotImplementedError`
naming it.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

DIVERGENCE_ALARM = "xla_audit_divergence"


@dataclass
class Check:
    name: str
    ok: bool
    detail: str = ""


@dataclass
class ScenarioResult:
    name: str
    checks: List[Check] = field(default_factory=list)
    detect_ms: Optional[float] = None
    recovery_ms: Optional[float] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return all(c.ok for c in self.checks)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "ok": self.ok,
            "checks": [
                {"name": c.name, "ok": c.ok, "detail": c.detail}
                for c in self.checks
            ],
            "detect_ms": self.detect_ms,
            "recovery_ms": self.recovery_ms,
            **self.extra,
        }


class Scenario:
    """Base: a named fault + its contract. `run` receives the engine
    and returns a ScenarioResult whose checks the engine asserts."""

    name = "scenario"
    reference = ""  # the reference suite this mirrors (PARITY.md)
    needs_cluster = False
    needs_mesh = False  # requires a ShardedDeviceTable (multi-chip)
    needs_durable = False  # requires the WAL-backed durable tier

    async def run(self, eng) -> ScenarioResult:  # pragma: no cover
        raise NotImplementedError


def _slo_check(eng, t0_wall: float) -> Check:
    """SLOs hold OR burn alarms fire: an objective that burned through
    the window without paging is the one forbidden state."""
    silent = []
    for name, obj in eng.sentinel.slo.items():
        s = obj.evaluate()
        alarm = f"xla_slo_{name}_burn"
        if s["breached"] and not (
            eng.alarms.is_active(alarm)
            or alarm in eng.alarms.fired_since(t0_wall)
        ):
            silent.append(name)
    return Check(
        "slo_holds_or_alarms",
        not silent,
        "breached-and-silent: " + ",".join(silent) if silent else "clean",
    )


def _fires(eng, rule: str) -> int:
    """How many times a flight trigger rule has FIRED (bundle written).
    The rotation-immune count — `store.list()` drops old bundles at
    max_snapshots, which would make a presence check racy."""
    fl = eng.flight
    if fl is None:
        return 0
    return fl.triggers_total.get(rule, 0)


class StormBaseline(Scenario):
    """No fault at all: a pure storm window. The contract is the
    boring one production lives on — deliveries flow, zero divergence,
    SLOs clean or paged."""

    name = "storm_baseline"
    reference = "emqx_broker_SUITE publish storms"

    def __init__(self, seconds: float = 5.0):
        self.seconds = seconds

    async def run(self, eng) -> ScenarioResult:
        res = ScenarioResult(self.name)
        t0w = time.time()
        d0, p0 = eng.delivered, eng.published
        det0 = len(eng.detections)
        await asyncio.sleep(self.seconds)
        res.checks.append(
            Check(
                "deliveries_flow",
                eng.delivered > d0 and eng.published > p0,
                f"+{eng.published - p0} pub / +{eng.delivered - d0} dlv",
            )
        )
        res.checks.append(
            Check(
                "no_divergence",
                len(eng.detections) == det0,
                f"{len(eng.detections) - det0} unexpected",
            )
        )
        res.checks.append(_slo_check(eng, t0w))
        res.extra["window_s"] = self.seconds
        return res


class _CorruptionBase(Scenario):
    """Shared inject→detect→quarantine→auto-clear→verify walk; the
    subclasses differ only in WHAT they corrupt."""

    def _corrupt(self, eng, flt: str) -> int:  # pragma: no cover
        raise NotImplementedError

    async def _one_fault(self, eng, flt: str, res: ScenarioResult) -> None:
        c0 = eng.counters()
        det0 = len(eng.detections)
        # warm: the row must be device-resident and serving clean
        fan0 = await eng.burst([eng.fresh_topic(flt)])
        corrupted = self._corrupt(eng, flt)
        eng.record_fault(self.name, {"filter": flt, "slots": corrupted})
        res.checks.append(
            Check("injectable", corrupted >= 1, f"{flt}: {corrupted} slots")
        )
        if corrupted < 1:
            return
        t_inj = time.monotonic()
        t0w = time.time()
        detected = False
        rounds = 0
        for rounds in range(1, eng.detect_rounds + 1):
            await eng.burst(
                [eng.fresh_topic(flt) for _ in range(eng.detect_burst)]
            )
            if len(eng.detections) > det0:
                detected = True
                break
        window = rounds * eng.detect_burst
        res.checks.append(
            Check(
                "detected_within_window",
                detected,
                f"{window} publishes ({rounds} rounds, "
                f"sample 1/{eng.sentinel.sample_n})",
            )
        )
        if detected:
            eng.faults_detected += 1
            res.detect_ms = round(
                (eng.detections[-1][0] - t_inj) * 1e3, 2
            )
        # recovery: quarantine engaged, then auto-cleared by the next
        # clean table sync (driving fresh matches forces the sync)
        c1 = eng.counters()
        res.checks.append(
            Check(
                "quarantine_engaged",
                c1.get("audit_quarantine_total", 0)
                > c0.get("audit_quarantine_total", 0),
                f"quarantined={eng.router.quarantined_filters()}",
            )
        )
        rec = await eng.drive_until(
            lambda: not eng.router.quarantined_filters()
            and eng.counters().get("audit_unquarantine_total", 0)
            > c0.get("audit_unquarantine_total", 0),
            flt=flt,
            timeout=eng.settle_timeout,
        )
        res.checks.append(
            Check(
                "quarantine_auto_cleared",
                rec is not None,
                f"{round(rec * 1e3, 1)}ms" if rec is not None else "timeout",
            )
        )
        if rec is not None:
            res.recovery_ms = round((time.monotonic() - t_inj) * 1e3, 2)
        # post-recovery: the healed device serves the full fan again
        post = await eng.burst([eng.fresh_topic(flt) for _ in range(4)])
        res.checks.append(
            Check(
                "post_recovery_serving",
                post == 4 * eng.chaos_fan and fan0 == eng.chaos_fan,
                f"fan {post}/4 bursts (want {4 * eng.chaos_fan})",
            )
        )
        c2 = eng.counters()
        res.checks.append(
            Check(
                "divergence_accounted",
                c2.get("audit_divergence_total", 0)
                > c0.get("audit_divergence_total", 0),
                f"+{c2.get('audit_divergence_total', 0) - c0.get('audit_divergence_total', 0)}",
            )
        )
        res.checks.append(
            Check(
                "alarm_raised",
                DIVERGENCE_ALARM in eng.alarms.fired_since(t0w)
                or eng.alarms.is_active(DIVERGENCE_ALARM),
                DIVERGENCE_ALARM,
            )
        )


class RowCorruption(_CorruptionBase):
    """Scoped device-row decay: one filter's cuckoo slot emptied on
    device while every other row keeps serving — detection must come
    from the sampled shadow audit, not from gross failure."""

    name = "row_corruption"
    reference = (
        "route-consistency checks (emqx_router_SUITE) against "
        "single-row device memory decay"
    )

    def __init__(self, faults: int = 2):
        self.faults = faults

    async def run(self, eng) -> ScenarioResult:
        res = ScenarioResult(self.name)
        fires0 = _fires(eng, "audit_divergence")
        eng.reset_flight_cooldown("audit_divergence")
        for i in range(self.faults):
            flt = eng.chaos_filters[i % len(eng.chaos_filters)]
            await self._one_fault(eng, flt, res)
        # scenario-level: ≥1 bundle froze for this window (the rule's
        # cooldown intentionally coalesces faults inside one window)
        res.checks.append(
            Check(
                "flight_bundle_captured",
                _fires(eng, "audit_divergence") > fires0,
                "audit_divergence trigger fired",
            )
        )
        res.extra["faults"] = self.faults
        return res

    def _corrupt(self, eng, flt: str) -> int:
        return eng.router.chaos_corrupt_rows([flt])


class SlotDecay(_CorruptionBase):
    """Whole-table decay: every device cuckoo slot empties at once (the
    gross-failure mode). The first detected divergence quarantines and
    flags a FULL index re-upload, so ONE quarantine cycle must heal
    the entire table."""

    name = "slot_decay"
    reference = "whole-table memory decay vs emqx route rebuild"

    async def run(self, eng) -> ScenarioResult:
        res = ScenarioResult(self.name)
        fires0 = _fires(eng, "audit_divergence")
        eng.reset_flight_cooldown("audit_divergence")
        await self._one_fault(eng, eng.chaos_filters[0], res)
        # the whole table healed, not just the audited filter: every
        # chaos filter must serve its full fan again
        post = await eng.burst(
            [eng.fresh_topic(f) for f in eng.chaos_filters]
        )
        res.checks.append(
            Check(
                "whole_table_healed",
                post == len(eng.chaos_filters) * eng.chaos_fan,
                f"{post} deliveries from {len(eng.chaos_filters)} filters",
            )
        )
        res.checks.append(
            Check(
                "flight_bundle_captured",
                _fires(eng, "audit_divergence") > fires0,
                "audit_divergence trigger fired",
            )
        )
        return res

    def _corrupt(self, eng, flt: str) -> int:
        return eng.router.chaos_corrupt_slots()


class DeviceLoss(Scenario):
    """Device-link failure walked end to end under the live storm:
    (1) a transient fault burst is absorbed INVISIBLY by the host
    failover (zero publisher errors, fallback counted, breaker stays
    closed); (2) sticky device loss trips the breaker within its
    failure budget — host-degraded service stays correct and
    audit-clean, the `xla_device_breaker` alarm pages, a
    `device_breaker_trip` flight bundle freezes; (3) healing the link
    lets the canary probe resync full device state and close the
    breaker, verified divergence-free by a full-truth sweep."""

    name = "device_loss"
    reference = (
        "emqx_olp load-control backoff (SURVEY.md:96) applied to the "
        "device link; breaker trip/recover around XLA faults"
    )

    async def run(self, eng) -> ScenarioResult:
        res = ScenarioResult(self.name)
        de = eng.broker.engine
        inj = eng.injector
        c = eng.counters
        t0w = time.time()
        err0 = eng.storm_errors
        c0 = c()
        det0 = len(eng.detections)
        fires0 = _fires(eng, "device_breaker_trip")
        eng.reset_flight_cooldown("device_breaker_trip")
        # --- phase 1: transient blip — failover absorbs, breaker holds
        inj.fail_transient(2)
        await eng.burst(
            [eng.fresh_topic(eng.chaos_filters[0]) for _ in range(8)]
        )
        while not inj.healthy:  # storm may not have hit the seam yet
            await eng.burst([eng.fresh_topic(eng.chaos_filters[0])])
        c1 = c()
        res.checks.append(
            Check(
                "transient_absorbed",
                de.breaker_state == "closed"
                and c1.get("breaker_device_failures_total", 0)
                > c0.get("breaker_device_failures_total", 0)
                and eng.storm_errors == err0,
                f"+{c1.get('breaker_device_failures_total', 0) - c0.get('breaker_device_failures_total', 0)}"
                " faults, 0 publisher errors, breaker closed",
            )
        )
        # --- phase 2: sticky loss — trip within the failure budget
        inj.fail_sticky()
        eng.record_fault(self.name, {"mode": "sticky"})
        t_inj = time.monotonic()
        # failure budget: threshold batches + slack for in-flight ones
        budget = de.breaker_threshold + 4
        tripped = None
        for _ in range(budget):
            await eng.burst([eng.fresh_topic(eng.chaos_filters[0])])
            if de.breaker_state == "open":
                tripped = time.monotonic() - t_inj
                break
        res.checks.append(
            Check(
                "breaker_tripped_within_budget",
                tripped is not None,
                f"{tripped * 1e3:.0f}ms, budget {budget} batches"
                if tripped is not None
                else f"not within {budget} batches",
            )
        )
        if tripped is not None:
            eng.faults_detected += 1
            res.detect_ms = round(tripped * 1e3, 2)
        # --- degraded-but-correct: full fan from the host walk, zero
        # publisher-visible errors, zero audit divergence
        fan = await eng.burst(
            [eng.fresh_topic(eng.chaos_filters[0]) for _ in range(4)]
        )
        res.checks.append(
            Check(
                "degraded_serving_correct",
                fan == 4 * eng.chaos_fan,
                f"fan {fan}/{4 * eng.chaos_fan} host-side",
            )
        )
        res.checks.append(
            Check(
                "alarm_raised",
                eng.alarms.is_active("xla_device_breaker")
                or "xla_device_breaker" in eng.alarms.fired_since(t0w),
                "xla_device_breaker",
            )
        )
        res.checks.append(
            Check(
                "flight_bundle_captured",
                _fires(eng, "device_breaker_trip") > fires0,
                "device_breaker_trip trigger fired",
            )
        )
        res.checks.append(
            Check(
                "no_divergence_while_degraded",
                len(eng.detections) == det0,
                f"{len(eng.detections) - det0} unexpected",
            )
        )
        # --- phase 3: heal -> probe -> resync -> close
        inj.heal()
        rec = await eng.wait_for(
            lambda: de.breaker_state == "closed",
            timeout=eng.settle_timeout + de.probe_backoff_max_s * 4,
        )
        res.checks.append(
            Check(
                "breaker_recovered",
                rec is not None,
                f"{rec * 1e3:.0f}ms after heal" if rec is not None
                else "probe never closed the breaker",
            )
        )
        if rec is not None:
            res.recovery_ms = round((time.monotonic() - t_inj) * 1e3, 2)
        c2 = c()
        res.checks.append(
            Check(
                "recovery_resynced_device",
                c2.get("device_resyncs_total", 0)
                > c0.get("device_resyncs_total", 0)
                and c2.get("breaker_recoveries_total", 0)
                > c0.get("breaker_recoveries_total", 0),
                f"resyncs +{c2.get('device_resyncs_total', 0) - c0.get('device_resyncs_total', 0)}",
            )
        )
        res.checks.append(
            Check(
                "alarm_cleared",
                not eng.alarms.is_active("xla_device_breaker"),
                "xla_device_breaker deactivated",
            )
        )
        # post-close: device-served again, full fan, zero divergence
        # (the sentinel's shadow audit samples these bursts; the sweep
        # compares EVERY answer to the oracle)
        post = await eng.burst(
            [eng.fresh_topic(f) for f in eng.chaos_filters]
        )
        res.checks.append(
            Check(
                "post_recovery_full_fan",
                post == len(eng.chaos_filters) * eng.chaos_fan,
                f"{post} deliveries device-side",
            )
        )
        sweep = await eng.audit_sweep(per_groups=128)
        res.checks.append(
            Check(
                "divergence_free_after_close",
                sweep["silent_divergences"] == 0,
                f"{sweep['topics_swept']} topics swept",
            )
        )
        res.checks.append(
            Check(
                "zero_publisher_errors",
                eng.storm_errors == err0,
                f"{eng.storm_errors - err0} storm chunks failed",
            )
        )
        res.checks.append(_slo_check(eng, t0w))
        res.extra["trip_after_failures"] = de.breaker_threshold
        return res


class DeviceFlap(Scenario):
    """Repeated loss/heal cycles (a flapping accelerator link): each
    cycle must trip and fully recover — no wedged half-open state, no
    publisher-visible errors, no leftover alarm — and the breaker's
    counters must account for every cycle."""

    name = "device_flap"
    reference = (
        "emqx_limiter token-bucket refill (SURVEY.md:376) analog: "
        "repeated overload/recover cycles must stay bounded"
    )

    def __init__(self, cycles: int = 3):
        self.cycles = cycles

    async def run(self, eng) -> ScenarioResult:
        res = ScenarioResult(self.name)
        de = eng.broker.engine
        inj = eng.injector
        t0w = time.time()
        err0 = eng.storm_errors
        c0 = eng.counters()
        recovered = 0
        t_first = None
        for cycle in range(self.cycles):
            inj.fail_sticky()
            eng.record_fault(self.name, {"cycle": cycle})
            if t_first is None:
                t_first = time.monotonic()
            tripped = None
            for _ in range(de.breaker_threshold + 4):
                await eng.burst([eng.fresh_topic(eng.chaos_filters[0])])
                if de.breaker_state == "open":
                    tripped = True
                    break
            if tripped:
                eng.faults_detected += 1
            inj.heal()
            rec = await eng.wait_for(
                lambda: de.breaker_state == "closed",
                timeout=eng.settle_timeout + de.probe_backoff_max_s * 4,
            )
            if tripped and rec is not None:
                recovered += 1
        res.checks.append(
            Check(
                "every_cycle_recovered",
                recovered == self.cycles,
                f"{recovered}/{self.cycles} trip+recover cycles",
            )
        )
        c1 = eng.counters()
        res.checks.append(
            Check(
                "flaps_accounted",
                c1.get("breaker_trips_total", 0)
                - c0.get("breaker_trips_total", 0) == self.cycles
                and c1.get("breaker_recoveries_total", 0)
                - c0.get("breaker_recoveries_total", 0) == self.cycles,
                f"trips +{c1.get('breaker_trips_total', 0) - c0.get('breaker_trips_total', 0)}, "
                f"recoveries +{c1.get('breaker_recoveries_total', 0) - c0.get('breaker_recoveries_total', 0)}",
            )
        )
        if t_first is not None:
            res.detect_ms = round((time.monotonic() - t_first) * 1e3, 2)
            res.recovery_ms = res.detect_ms
        res.checks.append(
            Check(
                "breaker_closed_at_end",
                de.breaker_state == "closed"
                and not eng.alarms.is_active("xla_device_breaker"),
                f"state={de.breaker_state}",
            )
        )
        res.checks.append(
            Check(
                "zero_publisher_errors",
                eng.storm_errors == err0,
                f"{eng.storm_errors - err0} storm chunks failed",
            )
        )
        sweep = await eng.audit_sweep(per_groups=64)
        res.checks.append(
            Check(
                "audit_clean_after_flaps",
                sweep["silent_divergences"] == 0,
                f"{sweep['topics_swept']} topics swept",
            )
        )
        res.checks.append(_slo_check(eng, t0w))
        res.extra["cycles"] = self.cycles
        return res



class ChipLoss(Scenario):
    """One chip of the mesh dies under the live storm: the shard
    breaker must keep the failure domain chip-granular. Contract:
    (1) sticky loss scoped to ONE shard trips the SHARD breaker within
    its failure budget while the whole-device breaker stays closed and
    the table is never suspended; (2) the lost shard's slice is
    evacuated onto the survivor mesh (N-1 chips serve the whole table
    on device) with the alarm paged and a flight bundle frozen;
    (3) route churn keeps landing while degraded; (4) healing the chip
    lets the per-shard probe rebalance back to the full mesh with a
    verified canary, the alarm clears, and a full-truth sweep finds
    zero silent divergence."""

    name = "chip_loss"
    reference = (
        "emqx_node_rebalance evacuation SUITE (SURVEY L2) applied to "
        "the mesh sub-axis: lose a member, evacuate live state, keep "
        "serving, rebalance back"
    )
    needs_mesh = True

    def __init__(self, shard: Optional[int] = None):
        self.shard = shard

    async def run(self, eng) -> ScenarioResult:
        res = ScenarioResult(self.name)
        de = eng.broker.engine
        inj = eng.injector
        dt = eng.router.device_table
        c = eng.counters
        t0w = time.time()
        err0 = eng.storm_errors
        c0 = c()
        n0 = dt.n_shards
        victim = (
            self.shard if self.shard is not None
            else inj.pick_shard(n0)
        )
        res.extra["victim_shard"] = victim
        fires0 = _fires(eng, "device_breaker_trip")
        eng.reset_flight_cooldown("device_breaker_trip")
        # --- sticky loss scoped to ONE chip
        inj.fail_sticky(shards=[victim])
        eng.record_fault(self.name, {"shard": victim})
        t_inj = time.monotonic()
        budget = de.breaker_threshold + 4
        tripped = None
        for _ in range(budget):
            await eng.burst(
                [eng.fresh_topic(eng.chaos_filters[0]) for _ in range(2)]
            )
            if victim in de.open_shards or not dt.lost_shards == set():
                tripped = time.monotonic() - t_inj
                break
        res.checks.append(
            Check(
                "shard_tripped_within_budget",
                tripped is not None,
                f"{tripped * 1e3:.0f}ms, budget {budget} batches"
                if tripped is not None
                else f"not within {budget} batches",
            )
        )
        if tripped is not None:
            eng.faults_detected += 1
            res.detect_ms = round(tripped * 1e3, 2)
        # --- failure domain stayed chip-granular: whole breaker closed,
        # table never suspended
        res.checks.append(
            Check(
                "whole_table_never_suspended",
                de.breaker_state == "closed"
                and not eng.router.device_suspended,
                f"breaker={de.breaker_state}, "
                f"suspended={eng.router.device_suspended}",
            )
        )
        # --- evacuated onto the survivor mesh: N-1 device service
        res.checks.append(
            Check(
                "evacuated_to_survivors",
                dt.lost_shards == {victim} and dt.n_shards == n0 - 1,
                f"lost={sorted(dt.lost_shards)}, mesh {dt.n_shards}/{n0}",
            )
        )
        fan = await eng.burst(
            [eng.fresh_topic(eng.chaos_filters[0]) for _ in range(4)]
        )
        res.checks.append(
            Check(
                "degraded_serving_correct",
                fan == 4 * eng.chaos_fan,
                f"fan {fan}/{4 * eng.chaos_fan} on N-1 mesh",
            )
        )
        res.checks.append(
            Check(
                "alarm_raised",
                eng.alarms.is_active("xla_device_breaker")
                or "xla_device_breaker" in eng.alarms.fired_since(t0w),
                "xla_device_breaker",
            )
        )
        res.checks.append(
            Check(
                "flight_bundle_captured",
                _fires(eng, "device_breaker_trip") > fires0,
                "device_breaker_trip trigger fired",
            )
        )
        # --- route churn while degraded: subscribe/unsubscribe legs
        # keep landing on the survivor mesh
        churned = await eng.route_churn(32)
        res.checks.append(
            Check(
                "churn_lands_while_degraded",
                churned == 64 and eng.storm_errors == err0,
                f"{churned} add+delete legs on N-1 mesh",
            )
        )
        # --- heal -> probe -> rebalance back to N -> verified close
        inj.heal()
        rec = await eng.wait_for(
            lambda: victim not in de.open_shards and not dt.lost_shards,
            timeout=eng.settle_timeout + de.probe_backoff_max_s * 4,
        )
        res.checks.append(
            Check(
                "rebalanced_back_to_full_mesh",
                rec is not None and dt.n_shards == n0,
                f"{rec * 1e3:.0f}ms after heal, mesh {dt.n_shards}/{n0}"
                if rec is not None
                else "probe never rebalanced the shard back",
            )
        )
        if rec is not None:
            res.recovery_ms = round((time.monotonic() - t_inj) * 1e3, 2)
        c2 = c()
        res.checks.append(
            Check(
                "shard_cycle_accounted",
                c2.get("breaker_shard_trips_total", 0)
                > c0.get("breaker_shard_trips_total", 0)
                and c2.get("breaker_shard_evacuations_total", 0)
                > c0.get("breaker_shard_evacuations_total", 0)
                and c2.get("breaker_shard_recoveries_total", 0)
                > c0.get("breaker_shard_recoveries_total", 0),
                "trip+evacuation+recovery counted",
            )
        )
        res.checks.append(
            Check(
                "alarm_cleared",
                not eng.alarms.is_active("xla_device_breaker"),
                "xla_device_breaker deactivated",
            )
        )
        post = await eng.burst(
            [eng.fresh_topic(f) for f in eng.chaos_filters]
        )
        res.checks.append(
            Check(
                "post_recovery_full_fan",
                post == len(eng.chaos_filters) * eng.chaos_fan,
                f"{post} deliveries on restored mesh",
            )
        )
        sweep = await eng.audit_sweep(per_groups=128)
        res.checks.append(
            Check(
                "divergence_free_after_rebalance",
                sweep["silent_divergences"] == 0,
                f"{sweep['topics_swept']} topics swept",
            )
        )
        res.checks.append(
            Check(
                "zero_publisher_errors",
                eng.storm_errors == err0,
                f"{eng.storm_errors - err0} storm chunks failed",
            )
        )
        res.checks.append(_slo_check(eng, t0w))
        res.extra["mesh_shards"] = n0
        return res


class ChipFlap(Scenario):
    """Repeated chip loss/heal cycles: every cycle must evacuate to
    N-1 and rebalance back to N — no wedged degraded mesh, no leaked
    lost shards, exact trip/recovery accounting, zero publisher
    errors."""

    name = "chip_flap"
    reference = (
        "emqx_node_rebalance repeated evacuate/rejoin cycles on one "
        "member; flapping-link discipline at shard granularity"
    )
    needs_mesh = True

    def __init__(self, cycles: int = 2, shard: Optional[int] = None):
        self.cycles = cycles
        self.shard = shard

    async def run(self, eng) -> ScenarioResult:
        res = ScenarioResult(self.name)
        de = eng.broker.engine
        inj = eng.injector
        dt = eng.router.device_table
        t0w = time.time()
        err0 = eng.storm_errors
        c0 = eng.counters()
        n0 = dt.n_shards
        victim = (
            self.shard if self.shard is not None
            else inj.pick_shard(n0)
        )
        res.extra["victim_shard"] = victim
        recovered = 0
        t_first = None
        for cycle in range(self.cycles):
            inj.fail_sticky(shards=[victim])
            eng.record_fault(self.name, {"cycle": cycle, "shard": victim})
            if t_first is None:
                t_first = time.monotonic()
            tripped = False
            for _ in range(de.breaker_threshold + 4):
                await eng.burst(
                    [eng.fresh_topic(eng.chaos_filters[0])
                     for _ in range(2)]
                )
                if victim in de.open_shards or dt.lost_shards:
                    tripped = True
                    break
            if tripped:
                eng.faults_detected += 1
            inj.heal()
            rec = await eng.wait_for(
                lambda: victim not in de.open_shards
                and not dt.lost_shards,
                timeout=eng.settle_timeout + de.probe_backoff_max_s * 4,
            )
            if tripped and rec is not None:
                recovered += 1
        res.checks.append(
            Check(
                "every_cycle_recovered",
                recovered == self.cycles,
                f"{recovered}/{self.cycles} evacuate+rebalance cycles",
            )
        )
        c1 = eng.counters()
        res.checks.append(
            Check(
                "flaps_accounted",
                c1.get("breaker_shard_trips_total", 0)
                - c0.get("breaker_shard_trips_total", 0) == self.cycles
                and c1.get("breaker_shard_recoveries_total", 0)
                - c0.get("breaker_shard_recoveries_total", 0)
                == self.cycles,
                f"shard trips +{c1.get('breaker_shard_trips_total', 0) - c0.get('breaker_shard_trips_total', 0)}, "
                f"recoveries +{c1.get('breaker_shard_recoveries_total', 0) - c0.get('breaker_shard_recoveries_total', 0)}",
            )
        )
        if t_first is not None:
            res.detect_ms = round((time.monotonic() - t_first) * 1e3, 2)
            res.recovery_ms = res.detect_ms
        res.checks.append(
            Check(
                "full_mesh_at_end",
                dt.n_shards == n0 and not dt.lost_shards
                and not de.open_shards
                and not eng.alarms.is_active("xla_device_breaker"),
                f"mesh {dt.n_shards}/{n0}, lost={sorted(dt.lost_shards)}",
            )
        )
        res.checks.append(
            Check(
                "zero_publisher_errors",
                eng.storm_errors == err0,
                f"{eng.storm_errors - err0} storm chunks failed",
            )
        )
        sweep = await eng.audit_sweep(per_groups=64)
        res.checks.append(
            Check(
                "audit_clean_after_flaps",
                sweep["silent_divergences"] == 0,
                f"{sweep['topics_swept']} topics swept",
            )
        )
        res.checks.append(_slo_check(eng, t0w))
        res.extra["cycles"] = self.cycles
        return res


class ReshardChurn(Scenario):
    """Administrative re-shard cycles under the storm (no fault at
    all): evacuate a shard and rebalance it back, repeatedly, while
    publishes and route churn keep flowing — the emqx_node_rebalance
    admin-rebalance analog. Every cycle must advance the shard-map
    generation, and the storm must see zero errors and zero
    divergence; this is the proof the re-shard machinery itself is
    production-safe, independent of any breaker."""

    name = "reshard_churn"
    reference = (
        "emqx_node_rebalance admin API: operator-driven rebalance "
        "under load, no member failure involved"
    )
    needs_mesh = True

    def __init__(self, cycles: int = 2):
        self.cycles = cycles

    async def run(self, eng) -> ScenarioResult:
        res = ScenarioResult(self.name)
        dt = eng.router.device_table
        t0w = time.time()
        err0 = eng.storm_errors
        det0 = len(eng.detections)
        n0 = dt.n_shards
        gen0 = dt.shard_gen
        t0 = time.monotonic()
        cycles_ok = 0
        for cycle in range(self.cycles):
            victim = cycle % n0
            eng.record_fault(self.name, {"cycle": cycle, "shard": victim})
            if not eng.router.evacuate_shard(victim):
                break
            fan = await eng.burst(
                [eng.fresh_topic(eng.chaos_filters[0]) for _ in range(2)]
            )
            await eng.route_churn(16)
            ok_deg = (
                dt.n_shards == n0 - 1 and fan == 2 * eng.chaos_fan
            )
            if not eng.router.rebalance_shard(victim):
                break
            fan = await eng.burst(
                [eng.fresh_topic(eng.chaos_filters[0]) for _ in range(2)]
            )
            if ok_deg and dt.n_shards == n0 and fan == 2 * eng.chaos_fan:
                cycles_ok += 1
                # the reshard was observed end-to-end (N-1 service,
                # generation bump, N restored): count the detection
                # that matches this cycle's recorded fault
                eng.faults_detected += 1
        res.checks.append(
            Check(
                "every_cycle_reserved_correctly",
                cycles_ok == self.cycles,
                f"{cycles_ok}/{self.cycles} evacuate+rebalance cycles "
                "served full fan at N-1 and N",
            )
        )
        res.checks.append(
            Check(
                "shard_map_generation_advanced",
                dt.shard_gen >= gen0 + 2 * self.cycles,
                f"gen {gen0} -> {dt.shard_gen}",
            )
        )
        res.checks.append(
            Check(
                "full_mesh_at_end",
                dt.n_shards == n0 and not dt.lost_shards,
                f"mesh {dt.n_shards}/{n0}",
            )
        )
        res.checks.append(
            Check(
                "no_divergence",
                len(eng.detections) == det0,
                f"{len(eng.detections) - det0} unexpected",
            )
        )
        res.checks.append(
            Check(
                "zero_publisher_errors",
                eng.storm_errors == err0,
                f"{eng.storm_errors - err0} storm chunks failed",
            )
        )
        sweep = await eng.audit_sweep(per_groups=64)
        res.checks.append(
            Check(
                "audit_clean_after_reshard",
                sweep["silent_divergences"] == 0,
                f"{sweep['topics_swept']} topics swept",
            )
        )
        res.checks.append(_slo_check(eng, t0w))
        res.recovery_ms = round((time.monotonic() - t0) * 1e3, 2)
        res.extra["cycles"] = self.cycles
        return res


class DisconnectTakeover(Scenario):
    """Mass-disconnect + same-node session takeover: a wave of the
    fleet drops (eviction agent), the storm keeps running, the wave
    reconnects with clean_start=False and must resume its sessions —
    routes intact, no divergence, deliveries restored."""

    name = "disconnect_takeover"
    reference = (
        "emqx_cm takeover + emqx_eviction_agent_SUITE "
        "(connection eviction, session preservation)"
    )

    def __init__(self, wave: Optional[int] = None):
        self.wave = wave

    async def run(self, eng) -> ScenarioResult:
        from ..cluster.rebalance import EvictionAgent

        res = ScenarioResult(self.name)
        t0w = time.time()
        det0 = len(eng.detections)
        fleet = eng.fleet
        wave = self.wave or max(100, fleet.n // 20)
        wave = min(wave, len(fleet.clients))
        pre_connected = eng.broker.connected_count()
        agent = EvictionAgent(eng.broker)
        t_wave = time.monotonic()
        evicted = agent.evict_connections(wave)
        res.checks.append(
            Check("wave_evicted", evicted == wave, f"{evicted}/{wave}")
        )
        # the fleet builds first, so eviction order == fleet order
        wave_cids = [
            cid
            for cid in fleet.clients[: wave * 2]
            if not eng.broker.sessions[cid].connected
        ]
        res.checks.append(
            Check(
                "wave_identified",
                len(wave_cids) == evicted,
                f"{len(wave_cids)} disconnected",
            )
        )
        d0 = eng.delivered
        await asyncio.sleep(0.2)  # storm runs against the degraded fleet
        # takeover: reconnect with clean_start=False -> session resumed
        resumed = 0
        b = eng.broker
        for i, cid in enumerate(wave_cids):
            s, present = b.open_session(
                cid, clean_start=False, cfg=fleet.cfg
            )
            s.outgoing_sink = fleet.sink
            resumed += bool(present)
            if (i + 1) % 2048 == 0:
                await asyncio.sleep(0)
        res.recovery_ms = round((time.monotonic() - t_wave) * 1e3, 2)
        res.checks.append(
            Check(
                "sessions_resumed",
                resumed == len(wave_cids),
                f"{resumed}/{len(wave_cids)} session_present",
            )
        )
        subs_ok = all(
            len(b.sessions[cid].subscriptions) == 1
            for cid in wave_cids[:32]
        )
        res.checks.append(
            Check("subscriptions_survived", subs_ok, "sampled 32")
        )
        res.checks.append(
            Check(
                "connected_restored",
                eng.broker.connected_count() == pre_connected,
                f"{eng.broker.connected_count()}/{pre_connected}",
            )
        )
        res.checks.append(
            Check(
                "no_divergence",
                len(eng.detections) == det0,
                f"{len(eng.detections) - det0} unexpected",
            )
        )
        res.checks.append(
            Check(
                "deliveries_flow", eng.delivered > d0,
                f"+{eng.delivered - d0}",
            )
        )
        res.checks.append(_slo_check(eng, t0w))
        res.extra["wave"] = wave
        return res



class TornWal(Scenario):
    """Power cut mid-append: the WAL's last record is half-written
    (torn). Reboot recovery must truncate at the last CRC-verified
    record — counting the torn frame — serve every previously
    acked-durable message, and never surface the half record as
    data."""

    name = "torn_wal"
    reference = (
        "RocksDB WAL kPointInTimeRecovery truncation; ra log CRC "
        "checked replay"
    )
    needs_durable = True

    async def run(self, eng) -> ScenarioResult:
        import os

        from ..ds.metrics import DS_METRICS
        from .faults import DiskFaultInjector

        res = ScenarioResult(self.name)
        t0w = time.time()
        err0 = eng.storm_errors
        # acked-durable baseline: in the WAL, fsynced, unconsumed
        pre = await eng.durable_publish(10)
        snap0 = DS_METRICS.snapshot()
        n_shards = eng.durable_db.storage.n_shards
        eng.record_fault(self.name, {"torn_bytes": 7, "shards": n_shards})
        t_inj = time.monotonic()
        # the process dies mid-append: kill, then plant the torn tail
        # (7 bytes of a 12-byte record header) on every shard WAL —
        # the on-disk state replay must truncate, engine-independent
        eng.ds_kill()
        for i in range(n_shards):
            DiskFaultInjector.tear_tail(
                os.path.join(
                    eng.data_dir, "ds", "chaos-messages", f"shard_{i}.kv"
                )
            )
        ms = await eng.ds_reboot()
        res.detect_ms = round((time.monotonic() - t_inj) * 1e3, 2)
        res.recovery_ms = round(ms, 2)
        snap1 = DS_METRICS.snapshot()
        torn = int(
            snap1["wal_torn_records_total"] - snap0["wal_torn_records_total"]
        )
        if torn >= n_shards:
            # replay counted every planted torn tail: the injection
            # was detected, not silently served as data
            eng.faults_detected += 1
        res.checks.append(
            Check(
                "torn_tail_detected",
                torn >= n_shards,
                f"+{torn} torn records counted at replay "
                f"(one per shard WAL)",
            )
        )
        res.checks.append(
            Check(
                "crc_clean",
                snap1["wal_crc_failures_total"]
                == snap0["wal_crc_failures_total"],
                "a torn tail is torn, not a checksum failure",
            )
        )
        res.checks.append(
            Check(
                "no_shard_failed",
                not eng.durable_db.failed_shards(),
                "replay recovered without fail-stop",
            )
        )
        after = await eng.durable_drain()
        lost = [p for p in pre if p not in after]
        res.checks.append(
            Check(
                "zero_acked_loss",
                not lost,
                f"{len(lost)}/{len(pre)} acked-durable messages lost",
            )
        )
        post = await eng.durable_publish(4)
        served = await eng.durable_drain()
        res.checks.append(
            Check(
                "post_recovery_serving",
                set(post) <= set(served),
                f"{len(served)} delivered after reboot",
            )
        )
        res.checks.append(
            Check(
                "zero_publisher_errors",
                eng.storm_errors == err0,
                f"{eng.storm_errors - err0} storm chunks failed",
            )
        )
        res.checks.append(_slo_check(eng, t0w))
        res.extra["acked_before_crash"] = len(pre)
        return res


class DiskFull(Scenario):
    """The disk fills (sticky ENOSPC on WAL appends) under the live
    storm: the touched shard must FAIL-STOP — alarm paged, flight
    bundle frozen, writes refused — while reads keep serving the
    committed data. Healing the disk, probe-verified recovery reopens
    the shard and writes flow again."""

    name = "disk_full"
    reference = (
        "RocksDB ENOSPC fail-stop (no silent retry); emqx alarm "
        "`disk_full` discipline"
    )
    needs_durable = True

    async def run(self, eng) -> ScenarioResult:
        from ..ds.metrics import DS_METRICS

        res = ScenarioResult(self.name)
        t0w = time.time()
        err0 = eng.storm_errors
        dinj = eng.disk_injector
        fires0 = _fires(eng, "ds_shard_failed")
        eng.reset_flight_cooldown("ds_shard_failed")
        pre = await eng.durable_publish(8)  # acked before the disk fills
        r0 = DS_METRICS.snapshot()["shard_recoveries_total"]
        refused0 = dict(eng.durable_db.buffer.refused)
        dinj.fail_sticky(
            "enospc", legs=("append",), paths=("chaos-messages",)
        )
        eng.record_fault(self.name, {"kind": "enospc"})
        t_inj = time.monotonic()
        for _ in range(8):
            try:
                await eng.durable_publish(4)
            except OSError:
                pass
            if eng.durable_db.failed_shards():
                break
        # the refused flushes are counted at the DS buffer on whichever
        # thread took them: the scenario's, or the buffer's flush thread
        failed, blocked = await eng.ds_refused_since(refused0)
        res.checks.append(
            Check(
                "fail_stop_engaged",
                bool(failed) and blocked >= 1,
                f"shards {failed} read-only, {blocked} flushes refused",
            )
        )
        if failed:
            eng.faults_detected += 1
            res.detect_ms = round((time.monotonic() - t_inj) * 1e3, 2)
        # the fail-stop's fan-out may still be between its alarm and
        # its flight trigger on the DS buffer's flush thread
        await eng.ds_failstop_settled()
        alarm = f"ds_shard_failed_{failed[0]}" if failed else ""
        res.checks.append(
            Check(
                "alarm_raised",
                bool(failed)
                and (
                    eng.alarms.is_active(alarm)
                    or alarm in eng.alarms.fired_since(t0w)
                ),
                alarm,
            )
        )
        res.checks.append(
            Check(
                "flight_bundle_captured",
                _fires(eng, "ds_shard_failed") > fires0,
                "ds_shard_failed trigger fired",
            )
        )
        # read-only degraded service: committed data still pumps
        served = await eng.durable_drain()
        res.checks.append(
            Check(
                "reads_serve_while_failed",
                set(pre) <= set(served),
                f"{len(served)} committed messages delivered read-only",
            )
        )
        # heal -> probe-verified recovery -> alarm clears
        dinj.heal()
        recovered = await eng.ds_recover()
        res.checks.append(
            Check(
                "probe_verified_recovery",
                sorted(recovered) == sorted(failed)
                and not eng.durable_db.failed_shards(),
                f"recovered {recovered}",
            )
        )
        if recovered:
            res.recovery_ms = round((time.monotonic() - t_inj) * 1e3, 2)
        res.checks.append(
            Check(
                "alarm_cleared",
                not any(
                    eng.alarms.is_active(f"ds_shard_failed_{s}")
                    for s in range(eng.durable_db.storage.n_shards)
                ),
                "all ds_shard_failed alarms deactivated",
            )
        )
        r1 = DS_METRICS.snapshot()["shard_recoveries_total"]
        res.checks.append(
            Check(
                "recovery_accounted",
                r1 - r0 >= len(recovered) and len(recovered) >= 1,
                f"shard_recoveries_total +{int(r1 - r0)}",
            )
        )
        post = await eng.durable_publish(6)
        served = await eng.durable_drain()
        res.checks.append(
            Check(
                "post_recovery_serving",
                set(post) <= set(served),
                f"{len(served)} delivered after recovery",
            )
        )
        res.checks.append(
            Check(
                "zero_publisher_errors",
                eng.storm_errors == err0,
                f"{eng.storm_errors - err0} storm chunks failed",
            )
        )
        res.checks.append(_slo_check(eng, t0w))
        return res


class FsyncFail(Scenario):
    """ONE transient fsync failure: the fsyncgate loss mode. The
    kernel may already have dropped the dirty pages, so the shard must
    fail-stop on the FIRST failed fsync and refuse writes even though
    the disk is healthy again one op later — never retry-and-continue.
    Recovery is only via the probe-verified reopen+replay path."""

    name = "fsync_fail"
    reference = (
        "fsyncgate (PostgreSQL 2018): a failed fsync cannot be "
        "retried; reopen-and-replay is the only safe continuation"
    )
    needs_durable = True

    async def run(self, eng) -> ScenarioResult:
        res = ScenarioResult(self.name)
        t0w = time.time()
        err0 = eng.storm_errors
        dinj = eng.disk_injector
        fires0 = _fires(eng, "ds_shard_failed")
        eng.reset_flight_cooldown("ds_shard_failed")
        pre = await eng.durable_publish(8)
        buf = eng.durable_db.buffer
        refused0 = dict(buf.refused)
        # exactly ONE fsync fails; the disk is healthy afterwards
        dinj.fail_transient(
            1, kind="fsync", legs=("fsync",), paths=("chaos-messages",)
        )
        eng.record_fault(self.name, {"kind": "fsync", "transient": 1})
        t_inj = time.monotonic()
        try:
            await eng.durable_publish(4)
        except OSError:
            pass
        # the refused flush is counted at the DS buffer on whichever
        # thread took it: the scenario's, or the buffer's flush thread
        failed, raised = await eng.ds_refused_since(refused0)
        res.checks.append(
            Check(
                "fail_stop_on_first_fsync_failure",
                raised >= 1 and bool(failed),
                f"shards {failed} fail-stopped on one transient fsync",
            )
        )
        if failed:
            eng.faults_detected += 1
            res.detect_ms = round((time.monotonic() - t_inj) * 1e3, 2)
        # the forbidden continuation: disk is healthy NOW, but the
        # shard must still refuse writes until probe-verified recovery
        # (no flush is in hand here, so a refusal counted from now on
        # is of a write made after the fail-stop)
        refused1 = dict(buf.refused)
        try:
            await eng.durable_publish(2)
        except OSError:
            pass
        _failed, blocked = await eng.ds_refused_since(refused1)
        res.checks.append(
            Check(
                "no_retry_and_continue",
                blocked >= 1 and dinj.healthy,
                "writes refused on healthy disk until recover()",
            )
        )
        # the fail-stop's fan-out may still be between its alarm and
        # its flight trigger on the DS buffer's flush thread
        await eng.ds_failstop_settled()
        alarm = f"ds_shard_failed_{failed[0]}" if failed else ""
        res.checks.append(
            Check(
                "alarm_raised",
                bool(failed)
                and (
                    eng.alarms.is_active(alarm)
                    or alarm in eng.alarms.fired_since(t0w)
                ),
                alarm,
            )
        )
        res.checks.append(
            Check(
                "flight_bundle_captured",
                _fires(eng, "ds_shard_failed") > fires0,
                "ds_shard_failed trigger fired",
            )
        )
        recovered = await eng.ds_recover()
        res.checks.append(
            Check(
                "probe_verified_recovery",
                sorted(recovered) == sorted(failed)
                and not eng.durable_db.failed_shards(),
                f"recovered {recovered} via reopen+replay+probe",
            )
        )
        if recovered:
            res.recovery_ms = round((time.monotonic() - t_inj) * 1e3, 2)
        after = await eng.durable_drain()
        lost = [p for p in pre if p not in after]
        res.checks.append(
            Check(
                "zero_acked_loss",
                not lost,
                f"{len(lost)}/{len(pre)} acked-durable messages lost",
            )
        )
        post = await eng.durable_publish(4)
        served = await eng.durable_drain()
        res.checks.append(
            Check(
                "post_recovery_serving",
                set(post) <= set(served),
                f"{len(served)} delivered after recovery",
            )
        )
        res.checks.append(
            Check(
                "zero_publisher_errors",
                eng.storm_errors == err0,
                f"{eng.storm_errors - err0} storm chunks failed",
            )
        )
        res.checks.append(_slo_check(eng, t0w))
        return res


class BrokerRestart(Scenario):
    """SIGKILL → reboot → recover of the durable tier under the live
    storm. Contract: acked-durable-but-unconsumed messages all survive
    (zero acked loss), already-consumed messages are NOT redelivered
    (sessions resume at committed positions), the session fleet and
    its ps-routes rebuild, and recovery wall-time stays bounded."""

    name = "broker_restart"
    reference = (
        "emqx_durable_storage restart recovery: ra log replay / "
        "RocksDB WAL recovery into emqx_persistent_session_ds resume"
    )
    needs_durable = True

    async def run(self, eng) -> ScenarioResult:
        res = ScenarioResult(self.name)
        t0w = time.time()
        err0 = eng.storm_errors
        # batch A: acked-durable, delivered AND pubacked — the
        # committed-position ledger the reboot must respect
        batch_a = await eng.durable_publish(10)
        consumed = await eng.durable_drain()
        res.checks.append(
            Check(
                "pre_crash_delivery",
                set(batch_a) <= set(consumed),
                f"{len(consumed)} delivered+acked before the crash",
            )
        )
        # batch B: acked-durable (WAL-fsynced) but never consumed —
        # exactly the set a crash must not lose
        batch_b = await eng.durable_publish(10)
        eng.record_fault(self.name, {"acked_unconsumed": len(batch_b)})
        t_inj = time.monotonic()
        eng.ds_kill()
        ms = await eng.ds_reboot()
        res.detect_ms = round((time.monotonic() - t_inj) * 1e3, 2)
        res.recovery_ms = round(ms, 2)
        rec = eng.ds_recovery
        res.checks.append(
            Check(
                "recovery_bounded",
                ms < 30_000,
                f"reboot replay+resume in {ms:.0f}ms",
            )
        )
        shards = rec["db"]["shards"]
        replayed_clean = sum(
            s["replayed_records"] for s in shards
        ) > 0 and not any(s["failed"] for s in shards)
        if replayed_clean:
            # reboot replay found and recovered the killed WAL state:
            # the crash injection was detected by the recovery path
            eng.faults_detected += 1
        res.checks.append(
            Check(
                "wal_replayed_clean",
                replayed_clean,
                f"{sum(s['replayed_records'] for s in shards)} records "
                f"replayed across {len(shards)} shards",
            )
        )
        res.checks.append(
            Check(
                "sessions_resumed",
                rec["sessions"]["sessions"] >= eng.durable_sessions
                and rec["sessions"]["ps_routes"] >= eng.durable_sessions,
                f"{rec['sessions']['sessions']} sessions, "
                f"{rec['sessions']['ps_routes']} ps-routes rebuilt",
            )
        )
        after = await eng.durable_drain()
        lost = [p for p in batch_b if p not in after]
        res.checks.append(
            Check(
                "zero_acked_loss",
                not lost,
                f"{len(lost)}/{len(batch_b)} acked-durable messages lost",
            )
        )
        redelivered = [p for p in batch_a if p in after]
        res.checks.append(
            Check(
                "resumed_at_committed_positions",
                not redelivered,
                f"{len(redelivered)} consumed messages redelivered",
            )
        )
        batch_c = await eng.durable_publish(6)
        served = await eng.durable_drain()
        res.checks.append(
            Check(
                "post_recovery_serving",
                set(batch_c) <= set(served),
                f"{len(served)} delivered after reboot",
            )
        )
        res.checks.append(
            Check(
                "no_failed_shards",
                not eng.durable_db.failed_shards(),
                "all shards writable after reboot",
            )
        )
        res.checks.append(
            Check(
                "zero_publisher_errors",
                eng.storm_errors == err0,
                f"{eng.storm_errors - err0} storm chunks failed",
            )
        )
        res.checks.append(_slo_check(eng, t0w))
        res.extra["acked_unconsumed"] = len(batch_b)
        return res

# the reference's catalog entries that need a mesh (run only by an
# engine whose table is sharded: ChaosEngine.standalone(mesh=...)) and
# those that wait for the cluster layer (ROADMAP Queue 1 item 8b)
MESH_SCENARIOS = (ChipLoss.name, ChipFlap.name, ReshardChurn.name)
CLUSTER_SCENARIOS = (
    "partition_nodedown",
    "replica_drift",
    "asymmetric_partition",
    "split_brain",
    "heal_storm",
    "node_evacuation",
    "node_purge",
)
NOT_PORTED = (
    "needs the cluster layer of ROADMAP Queue 1 item 8b, which the port "
    "does not have yet"
)


def scenario_catalog(cluster: bool = False) -> List[Scenario]:
    """The ordered soak catalog: the reference's, without the cluster
    scenarios, in its order. Corruption runs early while the fleet is
    pristine so fan expectations are exact; an engine without a mesh
    skips the mesh scenarios."""
    if cluster:
        raise NotImplementedError(f"the cluster catalog {NOT_PORTED}")
    return [
        StormBaseline(),
        RowCorruption(faults=2),
        DeviceLoss(),
        DeviceFlap(),
        ChipLoss(),
        ChipFlap(),
        ReshardChurn(),
        TornWal(),
        DiskFull(),
        FsyncFail(),
        BrokerRestart(),
        DisconnectTakeover(),
        SlotDecay(),
    ]


def scenarios_by_name(names) -> List[Scenario]:
    """Catalog entries by name, in the order given. A cluster scenario
    of the reference raises NotImplementedError naming item 8b; an
    unknown name raises KeyError."""
    by_name = {s.name: s for s in scenario_catalog()}
    out = []
    for n in names:
        if n in CLUSTER_SCENARIOS:
            raise NotImplementedError(f"scenario {n!r} {NOT_PORTED}")
        out.append(by_name[n])
    return out


CATALOG = [s.name for s in scenario_catalog()]
