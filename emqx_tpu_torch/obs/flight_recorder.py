"""Flight recorder — anomaly-triggered black-box diagnostics (the
port's own copy of emqx_tpu/obs/flight_recorder.py).

The kernel telemetry answers "what is the dispatch p99 *now*";
this module answers the question every production incident actually
asks: "what were the last N events before it went wrong". The design
is the black-box recorder of serious serving stacks (and the moral
analog of the reference's sys_mon/busy-port event log plus the
emqx_mgmt trace download): an always-on preallocated ring of
structured events fed by cheap taps, a trigger engine of declarative
anomaly rules, and a bounded rotated snapshot directory the frozen
ring dumps into when a rule fires.

Event sources (each a None-seam costing one attribute read when the
recorder is off, same contract as `broker.tracer`):

  * broker hookpoints — `Hooks.observer` times every non-empty
    run/run_fold chain per hookpoint and reports here; durations
    accumulate into per-hookpoint StreamingHistograms exported as
    `emqx_hook_duration_seconds`, and each run lands in the ring with
    the message's trace id (obs/otel.trace_id_of) so one publish
    correlates across otel spans, hook samples, and ring events;
  * the device match path — KernelTelemetry.record_dispatch forwards
    each leg sample as an `xla.<leg>` event (hash/dense/fallback/
    encode/unpack/sync: the SAME stage names as the telemetry
    histograms; the reference's `xla.` prefix is kept so bundles
    compare one to one), for both DeviceTable and ShardedDeviceTable since both
    report through the one collector seam;
  * deep call sites without a handle on the bundle — the reference's
    bridge pumps emit bridge.retry / bridge.failed / ... through the
    module-global seam (`set_global`/`emit`); the port has no bridges
    yet, the seam is kept for them;
  * alarm transitions — an Alarms listener records activate/deactivate
    and fires the `alarm` trigger rule immediately.

Trigger rules are declarative (name, check, cooldown): dispatch p99
over threshold in a sliding window, recompile-count delta (shape
churn), cuckoo slot load factor, bridge fallback burst, slow-subs
breach, alarm raised. A firing rule freezes the ring (writers drop,
counted), persists a snapshot bundle — ring events + kernel-telemetry
dump + hook-duration histograms + monitor series tail + slow-subs
top-k + active alarms + a config/topology fingerprint — then thaws.
Per-rule cooldowns stop a storm from snapshot-spamming; the store
rotates oldest-first above `max_snapshots` so the directory is
bounded no matter what.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional

from .kernel_telemetry import StreamingHistogram, render_histogram_lines

log = logging.getLogger("emqx_tpu_torch.obs.flight_recorder")

DEFAULT_CAPACITY = 2048

# device legs whose samples feed the sliding-window p99 rule (the
# "match p99" legs of kernel_telemetry.dispatch_percentile)
_DISPATCH_KINDS = ("xla.hash", "xla.dense", "xla.fallback")

# hookpoints NOT timed: these fire once per DELIVERY, so even a
# ~100ns observer probe would dominate the wide-fanout hot loop and
# bust the <2% enabled-path budget; per-delivery latency already has
# its own surface (obs/slow_subs)
UNTIMED_HOOKPOINTS = frozenset(
    {"message.delivered", "message.acked", "message.puback"}
)


class FlightRecorder:
    """Preallocated ring of (ns timestamp, kind, trace_id, attrs)
    events. `record` is the always-on hot-path cost: one time_ns, one
    tuple, two integer ops — no allocation beyond the event itself.
    Freezing makes the ring read-only so a snapshot captures the
    moments *before* the anomaly, not the dump traffic after it."""

    __slots__ = (
        "capacity", "_ring", "_pos", "frozen",
        "events_total", "dropped_while_frozen",
    )

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = capacity
        self._ring: List[Optional[tuple]] = [None] * capacity
        self._pos = 0
        self.frozen = False
        self.events_total = 0
        self.dropped_while_frozen = 0

    def record(
        self, kind: str, trace_id: str = "", attrs: Optional[Dict] = None
    ) -> None:
        if self.frozen:
            self.dropped_while_frozen += 1
            return
        pos = self._pos
        self._ring[pos] = (time.time_ns(), kind, trace_id, attrs)
        self._pos = 0 if pos + 1 == self.capacity else pos + 1
        self.events_total += 1

    def freeze(self) -> None:
        self.frozen = True

    def unfreeze(self) -> None:
        self.frozen = False

    def events(self, limit: Optional[int] = None) -> List[tuple]:
        """Raw events, oldest first (bounded by `limit` newest)."""
        ring, pos = self._ring, self._pos
        out = [e for e in ring[pos:] if e is not None]
        out.extend(e for e in ring[:pos] if e is not None)
        if limit is not None and limit < len(out):
            out = out[-limit:]
        return out

    def iter_newest(self, limit: int):
        """Yield up to `limit` events newest-first WITHOUT building the
        full ring list — the trigger rules' poll-cadence scan."""
        ring, pos, cap = self._ring, self._pos, self.capacity
        for k in range(1, min(limit, cap) + 1):
            e = ring[pos - k]  # negative index wraps, matching the ring
            if e is None:
                return
            yield e

    def recent(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """JSON-able view, oldest first. Hook events are stored in
        their cheap hot-path shape (`hook:<point>` kind, raw message
        id, bare seconds float) and normalized — including the id →
        trace-id derivation the hot path deferred — here."""
        from .otel import trace_id_of_str

        out = []
        for ts, kind, tid, attrs in self.events(limit):
            if kind.startswith("hook:"):
                out.append({
                    "ts_ns": ts,
                    "kind": "hook",
                    "trace_id": trace_id_of_str(tid) if tid else "",
                    "attrs": {"hook": kind[5:], "ms": round(attrs * 1e3, 6)},
                })
            else:
                out.append(
                    {"ts_ns": ts, "kind": kind, "trace_id": tid,
                     "attrs": attrs}
                )
        return out


class TriggerRule:
    """One declarative anomaly rule. `check(control)` returns a
    details dict when the anomaly holds (→ snapshot) or None. The
    per-rule cooldown is enforced by the control, so a sustained
    breach yields one bundle per cooldown window, not per poll."""

    __slots__ = ("name", "check", "cooldown")

    def __init__(
        self,
        name: str,
        check: Callable[["FlightControl"], Optional[Dict]],
        cooldown: float = 30.0,
    ):
        self.name = name
        self.check = check
        self.cooldown = cooldown


def default_rules(
    p99_ms: float = 5.0,
    p99_window_s: float = 60.0,
    p99_min_samples: int = 8,
    recompile_delta: int = 8,
    load_factor: float = 0.85,
    fallback_burst: int = 10,
    burst_window_s: float = 60.0,
    slow_subs_n: int = 1,
    cooldown: float = 30.0,
    cache_collapse_ratio: float = 0.5,
    cache_min_lookups: int = 64,
    cache_cooldown: float = 60.0,
    fanout_rebuild_rate: int = 64,
    fanout_cooldown: float = 60.0,
    breaker_cooldown: float = 60.0,
) -> List[TriggerRule]:
    """The stock rule set; every threshold is a constructor knob so
    config/tests can tighten or disable individual rules."""

    def dispatch_p99(ctl: "FlightControl") -> Optional[Dict]:
        samples = ctl.recent_dispatch_samples(p99_window_s)
        if len(samples) < p99_min_samples:
            return None
        samples.sort()
        p99 = samples[min(len(samples) - 1, int(0.99 * len(samples)))]
        if p99 * 1e3 > p99_ms:
            return {
                "p99_ms": round(p99 * 1e3, 4),
                "threshold_ms": p99_ms,
                "samples": len(samples),
            }
        return None

    # recompile-count delta is stateful: compare against the value at
    # the previous poll, so the rule sees churn RATE, not lifetime sum
    recompile_state = {"last": None}

    def recompile_storm(ctl: "FlightControl") -> Optional[Dict]:
        tel = ctl.telemetry
        if tel is None:
            return None
        cur = tel.counters.get("recompiles_total", 0)
        last, recompile_state["last"] = recompile_state["last"], cur
        if last is not None and cur - last >= recompile_delta:
            return {"recompiles_delta": cur - last, "total": cur}
        return None

    def cuckoo_load(ctl: "FlightControl") -> Optional[Dict]:
        tel = ctl.telemetry
        if tel is None:
            return None
        lf = tel.gauges.get("slot_load_factor", 0.0)
        if lf > load_factor:
            return {"slot_load_factor": lf, "threshold": load_factor}
        return None

    def bridge_burst(ctl: "FlightControl") -> Optional[Dict]:
        cutoff = time.time_ns() - int(burst_window_s * 1e9)
        n = 0
        for ts, kind, _tid, _attrs in ctl.recorder.iter_newest(256):
            if ts < cutoff:
                break
            if kind.startswith("bridge."):
                n += 1
        if n >= fallback_burst:
            return {"bridge_events": n, "window_s": burst_window_s}
        return None

    # match-cache hit-ratio collapse is delta-based like the recompile
    # rule: compare hit/miss counters against the previous poll so the
    # rule sees the ratio of THIS window — a route-churn storm that
    # suddenly orphans the hot set fires it even when the lifetime
    # ratio still looks healthy
    cache_state = {"hits": None, "misses": None}

    def cache_hit_collapse(ctl: "FlightControl") -> Optional[Dict]:
        tel = ctl.telemetry
        if tel is None:
            return None
        hits = tel.counters.get("match_cache_hits", 0)
        misses = tel.counters.get("match_cache_misses", 0)
        ph, pm = cache_state["hits"], cache_state["misses"]
        cache_state["hits"], cache_state["misses"] = hits, misses
        if ph is None:
            return None
        dh, dm = hits - ph, misses - pm
        n = dh + dm
        if n < cache_min_lookups:
            return None
        ratio = dh / n
        if ratio < cache_collapse_ratio:
            return {
                "hit_ratio": round(ratio, 4),
                "lookups": n,
                "threshold": cache_collapse_ratio,
            }
        return None

    # fanout-plan rebuild storm: delta-based like the cache-collapse
    # rule — a churn wave that keeps re-staling plans (misses + stale
    # discards) fires on the rebuild RATE of this poll window, not the
    # lifetime sum; per-filter stamps should make this rare, so a
    # breach usually means something is thrashing one hot filter set
    fanout_state = {"last": None}

    def fanout_plan_storm(ctl: "FlightControl") -> Optional[Dict]:
        tel = ctl.telemetry
        if tel is None:
            return None
        cur = tel.counters.get("fanout_plan_misses", 0) + tel.counters.get(
            "fanout_plan_stale", 0
        )
        last, fanout_state["last"] = fanout_state["last"], cur
        if last is not None and cur - last >= fanout_rebuild_rate:
            return {
                "plan_rebuilds": cur - last,
                "threshold": fanout_rebuild_rate,
                "total": cur,
            }
        return None

    def slow_subs_breach(ctl: "FlightControl") -> Optional[Dict]:
        ss = ctl.slow_subs
        if ss is None:
            return None
        top = ss.topk()
        if len(top) >= slow_subs_n:
            return {"tracked": len(top), "worst": top[0]}
        return None

    return [
        TriggerRule("dispatch_p99", dispatch_p99, cooldown),
        TriggerRule("recompile_storm", recompile_storm, cooldown),
        TriggerRule("cuckoo_load", cuckoo_load, cooldown),
        TriggerRule("bridge_fallback_burst", bridge_burst, cooldown),
        # own (longer) cooldown: a churn storm keeps the ratio low for
        # its whole duration — one bundle per window is the record,
        # more is noise
        TriggerRule("cache_hit_collapse", cache_hit_collapse, cache_cooldown),
        # own cooldown for the same reason as cache_hit_collapse: one
        # bundle per rebuild storm is the record, more is noise
        TriggerRule("fanout_plan_storm", fanout_plan_storm, fanout_cooldown),
        TriggerRule("slow_subs_breach", slow_subs_breach, cooldown),
        # event-driven (fired by the Alarms listener, never polled);
        # registered so its cooldown is declared alongside the rest
        TriggerRule("alarm", lambda ctl: None, cooldown),
        # event-driven: the publish sentinel's shadow-oracle audit
        # fires this the moment a served result diverges from the host
        # oracle (obs/sentinel.py) — the one anomaly where the ring's
        # pre-breach events ARE the forensic record of the bad serve
        TriggerRule("audit_divergence", lambda ctl: None, cooldown),
        # event-driven: the dispatch engine fires this the moment its
        # device circuit breaker trips (broker/dispatch_engine.py) —
        # the ring then holds the exact device-leg samples and failed
        # batches that consumed the failure budget. Own (longer)
        # cooldown: an outage is one incident, a flapping device must
        # not snapshot-spam its way through the store rotation.
        TriggerRule(
            "device_breaker_trip", lambda ctl: None, breaker_cooldown
        ),
        # event-driven: a chaos scenario engine stamps every injected
        # fault with a bundle, so the forensic
        # record of a chaos window carries the injection alongside the
        # detections it provoked — inject and detect correlate by ring
        # order, not by guesswork
        TriggerRule("chaos_fault", lambda ctl: None, cooldown),
        # event-driven: a durable-tier shard FAIL-STOPPED (failed
        # fsync / ENOSPC / EIO — ds/storage.py) — the bundle pins the
        # traffic the broker was serving when the disk went bad, which
        # is exactly what the post-incident "what did we lose?" audit
        # replays against the WAL
        TriggerRule("ds_shard_failed", lambda ctl: None, cooldown),
    ]


class SnapshotStore:
    """Bounded, rotated snapshot directory: flight-<seq>-<rule>.json
    bundles, oldest unlinked above `max_snapshots` — a trigger storm
    can grow the directory to the bound and no further."""

    def __init__(self, directory: str, max_snapshots: int = 8):
        self.directory = directory
        self.max_snapshots = max_snapshots
        self._seq = 0

    def _files(self) -> List[str]:
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(n for n in names if n.startswith("flight-"))

    def persist(self, rule: str, bundle: Dict[str, Any]) -> str:
        os.makedirs(self.directory, exist_ok=True)
        self._seq += 1
        safe_rule = "".join(
            c if c.isalnum() or c in "-_" else "_" for c in rule
        )
        name = f"flight-{int(time.time() * 1000):013d}-{self._seq:04d}-{safe_rule}.json"
        path = os.path.join(self.directory, name)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(bundle, f, default=str)
        os.replace(tmp, path)  # readers never see a partial bundle
        files = self._files()
        while len(files) > self.max_snapshots:
            try:
                os.unlink(os.path.join(self.directory, files.pop(0)))
            except OSError:
                break
        return path

    def list(self) -> List[Dict[str, Any]]:
        out = []
        for name in self._files():
            path = os.path.join(self.directory, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            out.append(
                {"name": name, "size": st.st_size, "mtime": st.st_mtime}
            )
        return out

    def read(self, name: str) -> Dict[str, Any]:
        if (
            "/" in name or "\\" in name or not name.startswith("flight-")
            or not name.endswith(".json")
        ):
            raise KeyError(name)
        path = os.path.join(self.directory, name)
        if not os.path.isfile(path):
            raise KeyError(name)
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)


class FlightControl:
    """Wires the ring, the trigger engine, and the snapshot store to
    the live subsystems. Sources are optional — bench runs attach only
    the kernel-telemetry collector; a booted node attaches everything."""

    def __init__(
        self,
        snapshot_dir: str,
        broker=None,
        telemetry=None,
        monitor=None,
        slow_subs=None,
        alarms=None,
        config=None,
        node_name: str = "emqx@127.0.0.1",
        capacity: int = DEFAULT_CAPACITY,
        max_snapshots: int = 8,
        eval_interval: float = 0.5,
        rules: Optional[List[TriggerRule]] = None,
    ):
        self.recorder = FlightRecorder(capacity)
        self.store = SnapshotStore(snapshot_dir, max_snapshots)
        self.broker = broker
        self.telemetry = telemetry
        self.monitor = monitor
        self.slow_subs = slow_subs
        self.alarms = alarms
        self.config = config
        self.node_name = node_name
        self.eval_interval = eval_interval
        self.rules = default_rules() if rules is None else rules
        self.hook_hist: Dict[str, StreamingHistogram] = {}
        # optional sampling profiler (obs/profiler.py): a snapshot
        # auto-arms it for profile_arm_s so every anomaly bundle ships
        # with the stacks that caused it, and the bundle attaches the
        # profiler's stage-bucketed top stacks
        self.profiler = None
        self.profile_arm_s = 10.0
        self.snapshots_total = 0
        self.triggers_total: Dict[str, int] = {}
        self._last_fired: Dict[str, float] = {}
        self._next_eval = 0.0
        self._installed = False

    # --- wiring -----------------------------------------------------------

    def install(self) -> None:
        """Attach every available seam. Idempotent."""
        if self._installed:
            return
        self._installed = True
        if self.broker is not None:
            from ..broker.hooks import HOOKPOINTS

            observers = self.broker.hooks.observers
            for point in HOOKPOINTS:
                if point not in UNTIMED_HOOKPOINTS:
                    observers[point] = self.on_hook
            if self.telemetry is None:
                self.telemetry = getattr(
                    self.broker.router, "telemetry", None
                )
        tel = self.telemetry
        if tel is not None and getattr(tel, "enabled", False):
            tel.flight = self.recorder
        if self.alarms is not None:
            self.alarms.listeners.append(self.on_alarm)
        set_global(self.recorder)

    def uninstall(self) -> None:
        if not self._installed:
            return
        self._installed = False
        if self.broker is not None:
            observers = self.broker.hooks.observers
            for point in [
                p for p, cb in observers.items() if cb == self.on_hook
            ]:
                del observers[point]
        tel = self.telemetry
        if tel is not None and getattr(tel, "flight", None) is self.recorder:
            tel.flight = None
        if self.alarms is not None and self.on_alarm in self.alarms.listeners:
            self.alarms.listeners.remove(self.on_alarm)
        if _GLOBAL is self.recorder:
            set_global(None)

    # --- taps -------------------------------------------------------------

    def on_hook(self, name: str, seconds: float, subject) -> None:
        """Hooks.observer sink: per-hookpoint duration histogram + a
        ring event. The hot path stores the RAW message id and bare
        seconds — recent() derives the trace id (the correlation key
        that makes otel spans, hook samples, and ring events one
        chain) and the display shape at read time, keeping this tap to
        a histogram bisect + one tuple."""
        h = self.hook_hist.get(name)
        if h is None:
            h = self.hook_hist[name] = StreamingHistogram()
        h.observe(seconds)
        mid = getattr(subject, "id", None) if subject is not None else None
        self.recorder.record("hook:" + name, mid or "", seconds)
        self.poll()

    def on_alarm(self, kind: str, rec: Dict[str, Any]) -> None:
        """Alarms listener: record the transition; an activation IS an
        anomaly, so it triggers immediately (through the rule cooldown
        rather than the poll loop)."""
        self.recorder.record(
            f"alarm.{kind}", "", {"name": rec.get("name", "")}
        )
        if kind == "activate":
            self.maybe_trigger(
                "alarm", {"name": rec.get("name", ""), "message": rec.get("message", "")}
            )

    def recent_dispatch_samples(
        self, window_s: float, scan_limit: int = 512
    ) -> List[float]:
        """Device-leg latency samples (seconds) within the sliding
        window — the data the dispatch_p99 rule evaluates. Bounded by
        `scan_limit` newest events and only walked at poll cadence."""
        cutoff = time.time_ns() - int(window_s * 1e9)
        out: List[float] = []
        for ts, kind, _tid, attrs in self.recorder.iter_newest(scan_limit):
            if ts < cutoff:
                break
            if kind in _DISPATCH_KINDS and attrs is not None:
                s = attrs.get("s")
                if s is not None:
                    out.append(s)
        return out

    # --- trigger engine ---------------------------------------------------

    def poll(self) -> None:
        """Cheap per-event entry: a time read and one compare until
        the eval interval elapses, then one pass over the rules."""
        now = time.monotonic()
        if now < self._next_eval:
            return
        self._next_eval = now + self.eval_interval
        self.evaluate()

    def evaluate(self) -> List[str]:
        """Run every rule once; returns the snapshot paths written."""
        if self.recorder.frozen:
            return []
        paths = []
        for rule in self.rules:
            if self._cooling(rule.name, rule.cooldown):
                continue
            try:
                details = rule.check(self)
            except Exception:
                log.exception("flight rule %s check failed", rule.name)
                continue
            if details:
                p = self._fire(rule.name, details)
                if p:
                    paths.append(p)
        return paths

    def _cooling(self, name: str, cooldown: float) -> bool:
        last = self._last_fired.get(name)
        return last is not None and time.monotonic() - last < cooldown

    def maybe_trigger(self, name: str, details: Dict) -> Optional[str]:
        """Event-driven trigger path (alarms): same cooldown contract
        as polled rules."""
        cooldown = next(
            (r.cooldown for r in self.rules if r.name == name), 30.0
        )
        if self._cooling(name, cooldown):
            return None
        return self._fire(name, details)

    def _fire(self, name: str, details: Dict) -> Optional[str]:
        self._last_fired[name] = time.monotonic()
        self.triggers_total[name] = self.triggers_total.get(name, 0) + 1
        try:
            path = self.snapshot(reason=name, details=details)
        except Exception:
            log.exception("flight snapshot for rule %s failed", name)
            return None
        log.warning(
            "flight recorder triggered by %s (%s) -> %s", name, details, path
        )
        return path

    # --- snapshot bundles -------------------------------------------------

    def fingerprint(self) -> Dict[str, Any]:
        """Config/topology fingerprint: enough to tell two bundles
        apart ("same node, same table shape, different config?")
        without shipping the whole config."""
        fp: Dict[str, Any] = {"node": self.node_name}
        if self.broker is not None:
            fp["router"] = self.broker.router.stats()
            # the card (or "cpu") the router's tables live on
            fp["device"] = str(self.broker.router.device)
            fp["sessions"] = len(self.broker.sessions)
            fp["subscriptions"] = len(self.broker.suboptions)
        if self.config is not None:
            try:
                blob = json.dumps(
                    self.config.to_dict(), sort_keys=True, default=str
                )
                fp["config_sha256"] = hashlib.sha256(
                    blob.encode()
                ).hexdigest()
            except Exception:
                fp["config_sha256"] = None
        tel = self.telemetry
        if tel is not None and getattr(tel, "enabled", False):
            fp["shape_buckets"] = tel.shape_buckets()
        return fp

    def bundle(
        self, reason: str, details: Optional[Dict] = None
    ) -> Dict[str, Any]:
        tel = self.telemetry
        return {
            "reason": reason,
            "details": details or {},
            "captured_at": time.time(),
            "fingerprint": self.fingerprint(),
            "ring": {
                "capacity": self.recorder.capacity,
                "events_total": self.recorder.events_total,
                "dropped_while_frozen": self.recorder.dropped_while_frozen,
            },
            "events": self.recorder.recent(),
            "hook_durations": {
                name: h.snapshot()
                for name, h in sorted(self.hook_hist.items())
            },
            "kernel_telemetry": (
                tel.snapshot()
                if tel is not None and getattr(tel, "enabled", False)
                else None
            ),
            "monitor_tail": (
                self.monitor.window(64) if self.monitor is not None else []
            ),
            "slow_subs": (
                self.slow_subs.topk() if self.slow_subs is not None else []
            ),
            "alarms": (
                self.alarms.get_alarms("activated")
                if self.alarms is not None
                else []
            ),
            "profile": (
                self.profiler.snapshot()
                if self.profiler is not None
                else None
            ),
        }

    def snapshot(
        self, reason: str = "manual", details: Optional[Dict] = None
    ) -> str:
        """Freeze, bundle, persist, thaw. The freeze keeps concurrent
        writers (hook taps on other coroutines, bridge pumps) from
        rotating the pre-anomaly events out from under the dump."""
        if self.profiler is not None:
            # arm the sampler for the post-anomaly window: this bundle
            # carries whatever stacks were already aggregated; the NEXT
            # bundle (or GET /api/v5/xla/profile) sees the anomaly's
            # aftermath sampled at full rate
            try:
                self.profiler.arm_for(self.profile_arm_s)
            except Exception:
                log.exception("profiler auto-arm failed")
        self.recorder.freeze()
        try:
            path = self.store.persist(reason, self.bundle(reason, details))
        finally:
            self.recorder.unfreeze()
        self.snapshots_total += 1
        self.recorder.record("flight.snapshot", "", {"reason": reason})
        return path

    # --- export surfaces --------------------------------------------------

    def status(self) -> Dict[str, Any]:
        """JSON status for GET /api/v5/xla/flight + the ctl command."""
        return {
            "enabled": True,
            "frozen": self.recorder.frozen,
            "capacity": self.recorder.capacity,
            "events_total": self.recorder.events_total,
            "dropped_while_frozen": self.recorder.dropped_while_frozen,
            "snapshots_total": self.snapshots_total,
            "snapshot_dir": self.store.directory,
            "max_snapshots": self.store.max_snapshots,
            "triggers": dict(sorted(self.triggers_total.items())),
            "rules": [
                {"name": r.name, "cooldown_s": r.cooldown}
                for r in self.rules
            ],
            "hookpoints_timed": sorted(self.hook_hist),
        }

    def prometheus_lines(self, node_name: str = "emqx@127.0.0.1") -> List[str]:
        """`emqx_flight_*` + `emqx_hook_duration_seconds` families,
        appended to the broker scrape by obs/prometheus.py."""
        node = f'node="{node_name}"'
        rec = self.recorder
        lines = [
            "# TYPE emqx_flight_events_total counter",
            f"emqx_flight_events_total{{{node}}} {rec.events_total}",
            "# TYPE emqx_flight_dropped_while_frozen_total counter",
            f"emqx_flight_dropped_while_frozen_total{{{node}}} "
            f"{rec.dropped_while_frozen}",
            "# TYPE emqx_flight_snapshots_total counter",
            f"emqx_flight_snapshots_total{{{node}}} {self.snapshots_total}",
            "# TYPE emqx_flight_frozen gauge",
            f"emqx_flight_frozen{{{node}}} {int(rec.frozen)}",
        ]
        if self.triggers_total:
            lines.append("# TYPE emqx_flight_triggers_total counter")
            for rule in sorted(self.triggers_total):
                lines.append(
                    f'emqx_flight_triggers_total{{{node},rule="{rule}"}} '
                    f"{self.triggers_total[rule]}"
                )
        if self.hook_hist:
            fam = "emqx_hook_duration_seconds"
            lines.append(f"# TYPE {fam} histogram")
            for hook in sorted(self.hook_hist):
                render_histogram_lines(
                    lines, fam, f'{node},hook="{hook}"',
                    self.hook_hist[hook], emit_type=False,
                )
        return lines


# --- module-global seam for deep call sites (bridge pumps) ----------------
#
# BufferWorkers are constructed layers below anything that knows about
# the obs bundle; threading a recorder through every bridge constructor
# would touch dozens of signatures for one diagnostic tap. Instead the
# FlightControl installs the process-wide recorder here and call sites
# emit through it — `emit` is a no-op (one global read + branch) when
# no recorder is installed, the same disabled-path discipline as the
# None tracer seam.

_GLOBAL: Optional[FlightRecorder] = None


def set_global(recorder: Optional[FlightRecorder]) -> None:
    global _GLOBAL
    _GLOBAL = recorder


def emit(kind: str, trace_id: str = "", attrs: Optional[Dict] = None) -> None:
    fr = _GLOBAL
    if fr is not None:
        fr.record(kind, trace_id, attrs)
