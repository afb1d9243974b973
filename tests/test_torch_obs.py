"""The port's publish-path observability (emqx_tpu_torch/obs: the
publish sentinel with its quarantine, the flight recorder with the
breaker's hooks, stage spans, OTel, traces and the Prometheus scrape)
held against emqx_tpu's on the CPU.

Each case builds the reference's Broker + Observability (JAX on the
CPU; the 8 virtual devices of tests/conftest.py for the mesh) and the
port's (device="cpu", every kernel wrapper on its plain version; the
mesh `make_mesh(2, 4, devices=["cpu"] * 8)`), feeds both the same
sessions, filters, topics and corruptions, and compares exactly what
they report: delivery counts, the `audit_*` counters, the quarantined
filters, the active alarms, the flight bundles' reason, details.kind
and details.filters, SLO burn rates, fired trigger rules, span trees,
trace files and the scrape's families. No time is compared; the one
timing contract checked is the sentinel's own sum-to-wall self-check
within DECOMP_TOLERANCE. The cases mirror tests/test_sentinel.py,
tests/test_flight_recorder.py, tests/test_delivery_stages.py,
tests/test_otel.py and tests/test_obs.py.
"""

import asyncio
import json

import pytest
import torch

from emqx_tpu.broker import hooks as JH
from emqx_tpu.broker import message as JM
from emqx_tpu.broker import packet as JP
from emqx_tpu.broker import pubsub as JB
from emqx_tpu.chaos import faults as JF
from emqx_tpu import obs as JO
from emqx_tpu.obs import flight_recorder as JFR
from emqx_tpu.obs import kernel_telemetry as JKT
from emqx_tpu.obs import otel as JOT
from emqx_tpu.obs import sentinel as JS
from emqx_tpu.parallel import mesh as JMesh
from emqx_tpu_torch.broker import hooks as TH
from emqx_tpu_torch.broker import message as TM
from emqx_tpu_torch.broker import packet as TP
from emqx_tpu_torch.broker import pubsub as TB
from emqx_tpu_torch.chaos import faults as TF
from emqx_tpu_torch import obs as TO
from emqx_tpu_torch.obs import flight_recorder as TFR
from emqx_tpu_torch.obs import kernel_telemetry as TKT
from emqx_tpu_torch.obs import otel as TOT
from emqx_tpu_torch.obs import sentinel as TS
from emqx_tpu_torch.parallel import mesh as TMesh

# the reference's families of layers the port does not have yet
NOT_PORTED = ("emqx_ds_", "emqx_cluster_", "emqx_xla_mesh_", "emqx_json_")
# flight bundles whose firing is event-driven (never a timed poll), so
# both sides must freeze the same ones
EVENT_RULES = ("audit_divergence", "alarm", "device_breaker_trip")
# the probe loop never wakes inside a test: recovery is probe_once()
PROBE_PARKED_MS = 600_000.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tier-1 runs test files side by side in worker processes; keep
    torch's CPU ops to one core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Side:
    """One implementation's modules, named alike."""

    def __init__(self, port: bool):
        self.port = port
        self.Message = TM.Message if port else JM.Message
        self.SubOpts = TP.SubOpts if port else JP.SubOpts
        self.O = TO if port else JO
        self.S = TS if port else JS
        self.FR = TFR if port else JFR
        self.KT = TKT if port else JKT
        self.OT = TOT if port else JOT
        self.F = TF if port else JF
        self.H = TH if port else JH

    def broker(self, mesh=None):
        return TB.Broker(device="cpu", mesh=mesh) if self.port else JB.Broker(mesh=mesh)

    def engine(self, b, **kw):
        if not self.port:
            kw.setdefault("deadline_ms", 0.5)  # the port's DEADLINE_S
        return b.enable_dispatch_engine(**kw)

    def mesh(self, layout):
        if layout == "single":
            return None
        if self.port:
            return TMesh.make_mesh(2, 4, devices=["cpu"] * 8)
        return JMesh.make_mesh(n_dp=2, n_sub=4)


SIDES = (Side(False), Side(True))


def make(S, tmp_path, mesh=None, **obs_kw):
    b = S.broker(mesh)
    d = tmp_path / ("port" if S.port else "ref")
    obs = S.O.Observability(
        b, node_name="n1@host", trace_dir=str(d / "trace"),
        flight_dir=str(d / "flight"), **obs_kw,
    )
    st = obs.sentinel
    if st is not None:
        st.sample_n = 1  # every served publish audited
        st.warmup_left = 0  # attribution from span one
        # timing-free comparisons: no sampled publish breaches the SLO
        st.slo_publish_ms = 1e9
    b._fanout_min_fan = 0
    return b, obs


def subscribe_fan(S, b, flt="a/+/c", n=6, prefix="c"):
    for i in range(n):
        s, _ = b.open_session(f"{prefix}{i}", clean_start=True)
        s.outgoing_sink = lambda pkts: None
        b.subscribe(s, flt, S.SubOpts(qos=i % 3))


async def drive(S, b, eng, topics):
    ns = await asyncio.gather(
        *[eng.publish(S.Message(topic=t, payload=b"x")) for t in topics]
    )
    await asyncio.sleep(0)  # let the deferred audit turn run
    b.sentinel.run_audits()
    return ns


def bundles(obs):
    """(reason, details.kind, details.filters, details.name) of every
    event-driven bundle the flight store holds, sorted."""
    st = obs.flight.store
    out = []
    for s in st.list():
        bd = st.read(s["name"])
        if bd["reason"] in EVENT_RULES:
            d = bd["details"]
            out.append((
                bd["reason"], d.get("kind"), tuple(sorted(d.get("filters", ()))),
                d.get("name"),
            ))
    return sorted(out)


def state(b, obs):
    c = b.router.telemetry.counters
    return {
        "counters": {
            k: v for k, v in sorted(c.items())
            if k.startswith(("audit_", "chaos_corrupt"))
        },
        "quarantined": b.router.quarantined_filters(),
        "alarms": sorted(a["name"] for a in obs.alarms.get_alarms("activated")),
        "bundles": bundles(obs),
    }


async def both(fn, *args):
    """Run `fn(side, *args)` for the reference, then the port; each
    side returns its log of what the two must agree on."""
    ref = await fn(SIDES[0], *args)
    port = await fn(SIDES[1], *args)
    assert port == ref
    return port


# --- the sentinel chain: detect -> quarantine -> alarm -> bundle -> heal ----


async def _chain(S, tmp_path, layout, corrupt):
    b, obs = make(S, tmp_path, S.mesh(layout))
    try:
        eng = S.engine(b, queue_depth=4)
        subscribe_fan(S, b)
        subscribe_fan(S, b, "b/+", n=2, prefix="d")
        r = b.router
        log = [("warm", await drive(S, b, eng, [f"a/{i}/c" for i in range(4)] + ["b/1"]),
                state(b, obs))]
        if corrupt == "rows":
            k = r.chaos_corrupt_rows(["a/+/c"])
        else:
            k = r.chaos_corrupt_slots()
        log.append(("corrupt", k))
        (n,) = await drive(S, b, eng, ["a/zz/c"])  # fresh topic: cache miss
        st = state(b, obs)
        log.append(("diverged", n, st))
        # the corrupt device really mis-served, and ONE sampling window
        # produced the whole chain
        assert n == 0
        assert st["counters"]["audit_divergence_total"] == 1
        assert st["quarantined"] == ["a/+/c"]
        assert "xla_audit_divergence" in st["alarms"]
        assert ("audit_divergence", "match", ("a/+/c",), None) in st["bundles"]
        # clean-sync recovery: the next batched match re-uploads the
        # index and the dirtied rows and ends the quarantine (counted)
        out = r.match_filters_finish(r.match_filters_begin(["a/q/c"]))
        st = state(b, obs)
        log.append(("healed", out, st))
        assert out == [["a/+/c"]]
        assert st["quarantined"] == []
        assert st["counters"]["audit_unquarantine_total"] == 1
        ns = await drive(S, b, eng, ["a/yy/c", "b/2"])
        st = state(b, obs)
        log.append(("served", ns, st))
        assert ns == [6, 2]
        assert st["counters"]["audit_divergence_total"] == 1  # no re-fire
        await eng.stop()
        return log
    finally:
        obs.stop()


@pytest.mark.parametrize("layout", ["single", "mesh"])
@pytest.mark.parametrize("corrupt", ["rows", "slots"])
async def test_corruption_chain_equals_reference(tmp_path, layout, corrupt):
    await both(_chain, tmp_path, layout, corrupt)


async def _plan_chain(S, tmp_path):
    # the dest-segment failure mode: the plan that serves is not the
    # plan the oracle would build (a client dropped from the fan)
    b, obs = make(S, tmp_path)
    try:
        eng = S.engine(b, queue_depth=2)
        subscribe_fan(S, b, n=8)
        r = b.router
        log = [("warm", await drive(S, b, eng, ["a/1/c"]))]
        key = ("a/+/c",)
        entry = b._fanout_cache[key]
        mem, other = entry[1]
        assert len(mem) == 8
        b._fanout_cache[key] = (entry[0], (mem[:-1], other))  # drop a client
        (n,) = await drive(S, b, eng, ["a/1/c"])
        st = state(b, obs)
        log.append(("diverged", n, st, b.sentinel.divergences[-1]["kind"]))
        assert n == 7  # the corrupt plan really served short
        assert b.sentinel.divergences[-1]["kind"] == "fanout"
        assert st["quarantined"] == ["a/+/c"]
        # while quarantined the plan kernel refuses the filter (counted)
        # and the host walk builds the full plan: a synchronous publish
        # (host-trie match, no table sync) serves all eight
        n = b.publish(S.Message(topic="a/2/c", payload=b"x"))
        b.sentinel.run_audits()
        st = state(b, obs)
        log.append(("refused", n, st))
        assert n == 8
        assert st["counters"]["audit_quarantine_resolve_refusals_total"] == 1
        assert r.resolve_fanout_begin(key, min_fan=0) is None
        out = r.match_filters_finish(r.match_filters_begin(["a/2/c"]))
        log.append(("healed", out, state(b, obs)))
        assert out == [["a/+/c"]]
        assert r.quarantined_filters() == []
        log.append(("served", await drive(S, b, eng, ["a/3/c"]), state(b, obs)))
        await eng.stop()
        return log
    finally:
        obs.stop()


async def test_plan_divergence_and_resolve_refusal_equal_reference(tmp_path):
    log = await both(_plan_chain, tmp_path)
    assert log[-1][1] == [8]


async def _overlay(S, tmp_path):
    # a batch LAUNCHED against the corrupt table before the audit
    # quarantined it still finishes with host-true results
    b, obs = make(S, tmp_path)
    try:
        subscribe_fan(S, b)
        r = b.router
        r.match_filters_batch(["a/w/c"])  # warm + sync
        r.chaos_corrupt_slots()
        p = r.match_filters_begin(["a/x/c"])  # launched while corrupt
        q = r.quarantine_filters(["a/+/c"])
        out = r.match_filters_finish(p)
        return [q, out, state(b, obs)]
    finally:
        obs.stop()


async def test_overlay_corrects_inflight_batch(tmp_path):
    log = await both(_overlay, tmp_path)
    assert log[0] == 1 and log[1] == [["a/+/c"]]
    assert log[2]["counters"]["audit_quarantine_overlay_total"] >= 1


async def _stale(S, tmp_path):
    # a route mutation between serve and audit is SKIPPED, not reported
    b, obs = make(S, tmp_path)
    try:
        eng = S.engine(b, queue_depth=2)
        subscribe_fan(S, b)
        b.sentinel._drain_scheduled = True  # hold the deferred drain
        ns = await asyncio.gather(eng.publish(S.Message(topic="a/1/c", payload=b"x")))
        s, _ = b.open_session("late", clean_start=True)
        s.outgoing_sink = lambda pkts: None
        b.subscribe(s, "a/#", S.SubOpts(qos=0))
        b.sentinel._drain_scheduled = False
        b.sentinel.run_audits()
        await eng.stop()
        return [ns, state(b, obs)]
    finally:
        obs.stop()


async def test_audit_skips_stale_generation(tmp_path):
    log = await both(_stale, tmp_path)
    assert log[0] == [6]
    assert log[1]["counters"]["audit_skipped_stale_total"] >= 1
    assert "audit_divergence_total" not in log[1]["counters"]


async def _unsampled(S, tmp_path):
    b, obs = make(S, tmp_path)
    try:
        st = obs.sentinel
        st.sample_n = 10**9  # never sample
        eng = S.engine(b, queue_depth=4)
        subscribe_fan(S, b)
        ns = await drive(S, b, eng, [f"a/{i}/c" for i in range(8)])
        await eng.stop()
        return [ns, st.spans_total, st._tick, st.stage_hist, list(st.exemplars),
                state(b, obs)]
    finally:
        obs.stop()


async def test_unsampled_path_is_probe_free(tmp_path):
    ns, spans, ticks, hist, ex, st = await both(_unsampled, tmp_path)
    assert ns == [6] * 8 and spans == 0 and ticks == 8
    assert hist == {} and ex == [] and st["counters"] == {}


async def _stages(S, tmp_path, layout):
    b, obs = make(S, tmp_path, S.mesh(layout))
    try:
        eng = S.engine(b, queue_depth=4)
        subscribe_fan(S, b)
        for w in range(3):
            await drive(S, b, eng, [f"a/{i}/c" for i in range(6)])
        await eng.stop()
        st = obs.sentinel
        snap = st.decomposition_snapshot()
        # the sentinel's own sum-to-wall self-check, per span
        assert snap["in_band"] + snap["out_of_band"] == st.spans_total
        sub_sum = sum(h.sum for h in st.delivery_hist.values())
        wall = st.stage_hist["queue"].sum + st.stage_hist["deliver"].sum
        assert abs(sub_sum - wall) <= S.S.DECOMP_TOLERANCE * wall
        ex = st.exemplars[-1]
        assert len(ex["trace_id"]) == 32
        return [
            st.spans_total, sorted(st.stage_hist), sorted(st.delivery_hist),
            {k: h.total for k, h in sorted(st.stage_hist.items())},
            st.fan_hist.total, st.fan_hist.sum, ex["topic"], ex["fan"],
            st.stage_snapshot()["total"]["count"], state(b, obs),
        ]
    finally:
        obs.stop()


@pytest.mark.parametrize("layout", ["single", "mesh"])
async def test_stage_attribution_equals_reference(tmp_path, layout):
    log = await both(_stages, tmp_path, layout)
    assert log[0] == 18
    assert set(log[1]) <= set(TS.STAGES)
    for stage in ("queue", "encode", "kernel", "fetch", "deliver"):
        assert stage in log[1]
    assert log[2] == sorted(TO.DELIVERY_STAGES)


@pytest.mark.parametrize("seq", [
    "bad8",            # 100% errors: 100x burn in both windows
    "bad8_good400",    # recovery drops the fast window under threshold
    "mixed",           # a periodic error rate
    "few",             # below min_events: no burn reported
])
def test_slo_burn_rates_equal_reference(seq):
    def run(S):
        o = S.S.SloObjective("x", target=0.99, fast_window_s=10.0,
                             slow_window_s=100.0, burn_threshold=5.0,
                             min_events=4)
        now = 1000.0
        if seq == "few":
            events = [(now, False), (now + 1, False)]
        elif seq == "mixed":
            events = [(now + i * 0.5, i % 7 != 0) for i in range(120)]
        else:
            events = [(now + i, False) for i in range(8)]
            if seq == "bad8_good400":
                events += [(now + 20 + i * 0.01, True) for i in range(400)]
        out = []
        for i, (ts, ok) in enumerate(events):
            o.record(ok, now=ts)
            if i % 5 == 4 or i == len(events) - 1:
                out.append(o.evaluate(now=ts + 0.5))
        return out

    ref, port = run(SIDES[0]), run(SIDES[1])
    assert port == ref
    if seq == "bad8":
        assert port[-1]["fast_burn"] == 100.0 and port[-1]["breached"]
    if seq == "bad8_good400":
        assert not port[-1]["breached"]


async def _slo_alarm(S, tmp_path):
    b, obs = make(S, tmp_path)
    try:
        st = obs.sentinel
        st.slo_publish_ms = 0.0  # every sampled publish violates
        slo = st.slo["publish_latency"]
        slo.min_events = 4
        eng = S.engine(b, queue_depth=4)
        subscribe_fan(S, b)
        await drive(S, b, eng, [f"a/{i}/c" for i in range(8)])
        log = [slo.evaluate()["breached"], state(b, obs)["alarms"]]
        st.slo_publish_ms = 1e9
        slo.target = 0.5
        await drive(S, b, eng, [f"a/r{i}/c" for i in range(64)])
        log += [slo.evaluate()["breached"], state(b, obs)["alarms"],
                slo.ok_total, slo.bad_total]
        await eng.stop()
        return log
    finally:
        obs.stop()


async def test_slo_breach_raises_and_clears_alarm(tmp_path):
    log = await both(_slo_alarm, tmp_path)
    assert log[0] and "xla_slo_publish_latency_burn" in log[1]
    assert not log[2] and "xla_slo_publish_latency_burn" not in log[3]


# --- the flight recorder ---------------------------------------------------


def _rule_feed(S, tel, fl, rule):
    """Feed one telemetry sequence and evaluate after each step; returns
    the rules fired per step."""
    fired = []

    def step():
        fired.append(sorted(p.rsplit("-", 1)[-1][:-5] for p in fl.evaluate()))

    step()  # seed the delta bases
    if rule == "recompile_storm":
        for i in range(10):
            tel.record_shape("k", (i,))
        step()
    elif rule == "cache_hit_collapse":
        for hits, misses in ((200, 10), (10, 190), (0, 500)):
            tel.count("match_cache_hits", hits)
            tel.count("match_cache_misses", misses)
            step()
    elif rule == "fanout_plan_storm":
        tel.count("fanout_plan_hits", 500)
        tel.count("fanout_plan_misses", 5)
        step()
        tel.count("fanout_plan_stale", 40)
        tel.count("fanout_plan_misses", 40)
        step()
        tel.count("fanout_plan_stale", 200)
        step()
    elif rule == "dispatch_p99":
        for _ in range(10):
            tel.record_dispatch("hash", 0.020)
        step()
        for _ in range(10):
            tel.record_dispatch("hash", 0.050)
        step()  # cooling down
    return fired


@pytest.mark.parametrize("rule", [
    "recompile_storm", "cache_hit_collapse", "fanout_plan_storm", "dispatch_p99",
])
def test_flight_rules_fire_equal_reference(tmp_path, rule):
    out = []
    for S in SIDES:
        tel = S.KT.KernelTelemetry()
        fl = S.FR.FlightControl(str(tmp_path / f"{S.port}"), telemetry=tel)
        fl.install()
        try:
            fired = _rule_feed(S, tel, fl, rule)
            bd = [fl.store.read(s["name"]) for s in fl.store.list()]
            out.append((fired, dict(fl.triggers_total),
                        [(x["reason"], sorted(x["details"])) for x in bd],
                        sorted({e["kind"] for x in bd for e in x["events"]})))
        finally:
            fl.uninstall()
    assert out[1] == out[0]
    assert out[1][1] == {rule: 1}


def test_ring_wrap_freeze_and_rotation_equal_reference(tmp_path):
    out = []
    for S in SIDES:
        r = S.FR.FlightRecorder(capacity=4)
        for i in range(6):
            r.record("k", "", {"i": i})
        wrap = ([e["attrs"]["i"] for e in r.recent()],
                [e["attrs"]["i"] for e in r.recent(2)], r.events_total)
        r.freeze()
        r.record("b")
        r.unfreeze()
        r.record("c")
        frozen = ([e["kind"] for e in r.recent()], r.dropped_while_frozen)
        fl = S.FR.FlightControl(str(tmp_path / f"rot{S.port}"), max_snapshots=3)
        for i in range(12):
            fl.snapshot(reason=f"storm{i}")
        kept = sorted(fl.store.read(s["name"])["reason"] for s in fl.store.list())
        out.append((wrap, frozen, kept, fl.snapshots_total))
    assert out[1] == out[0]
    assert out[1][0][0] == [2, 3, 4, 5] and out[1][2] == ["storm10", "storm11", "storm9"]


def test_timed_hooks_exclude_untimed_points_equal_reference(tmp_path):
    out = []
    for S in SIDES:
        b, obs = make(S, tmp_path)
        try:
            tr = S.OT.MemoryTracer()
            b.tracer = tr
            s, _ = b.open_session("c1", True)
            s.outgoing_sink = lambda pkts: None
            b.subscribe(s, "t/#", S.SubOpts(qos=0))
            msg = S.Message(topic="t/1", payload=b"x", from_client="pub", id="ab" * 16)
            n = b.publish(msg)
            fl = obs.flight
            timed = {k: h.total for k, h in sorted(fl.hook_hist.items())}
            assert S.FR.UNTIMED_HOOKPOINTS & set(timed) == set()
            tid = S.OT.trace_id_of(msg)
            hook_ev = [e for e in fl.recorder.recent() if e["kind"] == "hook"
                       and e["attrs"]["hook"] == "message.publish"]
            root = next(sp for sp in tr.spans if sp.name == "mqtt.publish")
            observed = sorted(b.hooks.observers)
            obs.stop()
            out.append((n, timed, hook_ev[-1]["trace_id"] == tid == root.trace_id,
                        observed, b.hooks.observers == {}))
        finally:
            obs.stop()
    assert out[1] == out[0]
    assert out[1][2] and out[1][4]


async def _breaker(S, tmp_path):
    b, obs = make(S, tmp_path)
    try:
        subscribe_fan(S, b, "room/+", n=4)
        eng = S.engine(b, queue_depth=4, breaker_threshold=2,
                       probe_backoff_ms=PROBE_PARKED_MS,
                       probe_backoff_max_ms=PROBE_PARKED_MS)
        inj = S.F.DeviceFaultInjector(seed=0).install(b.router)
        log = [await drive(S, b, eng, ["room/1"])]
        inj.fail_sticky()
        for i in range(3):
            log.append(await drive(S, b, eng, [f"room/x{i}"]))
        log.append((eng.breaker_state, state(b, obs)))
        inj.heal()
        log.append(eng.probe_once())
        log.append(await drive(S, b, eng, ["room/2"]))
        kinds = [e["kind"] for e in obs.flight.recorder.recent()
                 if e["kind"].startswith("breaker.")]
        trip = [e["attrs"] for e in obs.flight.recorder.recent()
                if e["kind"] == "breaker.trip"]
        log.append((eng.breaker_state, kinds, sorted(trip[0]), state(b, obs)))
        await eng.stop()
        return log
    finally:
        obs.stop()


async def test_breaker_flight_hooks_equal_reference(tmp_path):
    log = await both(_breaker, tmp_path)
    opened, st = log[4]
    assert opened == "open" and "xla_device_breaker" in st["alarms"]
    assert ("device_breaker_trip", None, (), None) in st["bundles"]
    closed, kinds, _trip_keys, st = log[-1]
    assert closed == "closed" and kinds == ["breaker.trip", "breaker.close"]
    assert "xla_device_breaker" not in st["alarms"]


# --- OTel, traces and the scrape -------------------------------------------


def _tree(tr):
    by_id = {sp.span_id: sp for sp in tr.spans}
    out = []
    for sp in tr.spans:
        parent = by_id[sp.parent_id].name if sp.parent_id else None
        assert sp.end_ns >= sp.start_ns and len(sp.trace_id) == 32
        if sp.parent_id:
            assert sp.trace_id == by_id[sp.parent_id].trace_id
        out.append((sp.name, parent, sp.trace_id, sorted(sp.attrs.items())))
    return out


def test_otel_span_trees_equal_reference():
    out = []
    for S in SIDES:
        b = S.broker()
        tr = S.OT.MemoryTracer()
        b.tracer = tr
        for i, flt in enumerate(("t/#", "t/+", "u/1")):
            s, _ = b.open_session(f"c{i}", True)
            s.outgoing_sink = lambda pkts: None
            b.subscribe(s, flt, S.SubOpts(qos=i % 2))
        ns = [b.publish(S.Message(topic=t, payload=b"x", qos=q, from_client=fc,
                                  id=f"{k:032x}"))
              for k, (t, q, fc) in enumerate((("t/1", 0, "pub"), ("u/1", 1, ""),
                                              ("t/2/3", 0, "pub"), ("v", 0, "x")))]
        b.hooks.add("message.publish", lambda acc: (S.H.STOP, None), priority=900)
        ns.append(b.publish(S.Message(topic="t/9", payload=b"y", id="f" * 32)))
        out.append((ns, _tree(tr)))
    assert out[1] == out[0]
    assert out[1][0] == [2, 1, 1, 0, 0]
    assert out[1][1][-1][0] == "mqtt.publish" and ("mqtt.dropped", True) in out[1][1][-1][3]


async def test_otlp_export_shape_equal_reference():
    received = []

    async def collector(reader, writer):
        data = b""
        while b"\r\n\r\n" not in data:
            data += await reader.read(4096)
        head, _, body = data.partition(b"\r\n\r\n")
        clen = int([ln for ln in head.split(b"\r\n")
                    if b"content-length" in ln.lower()][0].split(b":")[1])
        while len(body) < clen:
            body += await reader.read(4096)
        received.append(json.loads(body))
        writer.write(b"HTTP/1.1 200 OK\r\ncontent-length: 0\r\n\r\n")
        await writer.drain()
        writer.close()

    srv = await asyncio.start_server(collector, "127.0.0.1", 0)
    port = srv.sockets[0].getsockname()[1]
    shapes = []
    for S in SIDES:
        b = S.broker()
        tr = S.OT.OtelTracer(endpoint=f"http://127.0.0.1:{port}/v1/traces",
                             service_name="test-broker")
        b.tracer = tr
        s, _ = b.open_session("c1", True)
        s.outgoing_sink = lambda pkts: None
        b.subscribe(s, "m/+", S.SubOpts(qos=0))
        b.publish(S.Message(topic="m/1", payload=b"p", id="c" * 32))
        await asyncio.get_running_loop().run_in_executor(None, tr.flush)
        rs = received[-1]["resourceSpans"][0]
        scope = rs["scopeSpans"][0]
        spans = scope["spans"]
        ids = {sp["spanId"]: sp["name"] for sp in spans}
        shapes.append((
            tr.exported, rs["resource"], sorted(rs), sorted(scope),
            sorted((sp["name"], ids.get(sp.get("parentSpanId")), sp["traceId"],
                    sorted(sp), sp["kind"],
                    sorted((a["key"], sorted(a["value"].items())) for a in sp["attributes"]))
                   for sp in spans),
        ))
    srv.close()
    await srv.wait_closed()
    assert shapes[1] == shapes[0]
    assert shapes[1][0] == 3


def test_trace_files_equal_reference(tmp_path):
    out = []
    for S in SIDES:
        b = S.broker()
        obs = S.O.Observability(b, trace_dir=str(tmp_path / f"tr{S.port}"),
                                flight=False, sentinel=False)
        try:
            tm = obs.traces
            tm.create("by_client", "clientid", "c1")
            tm.create("by_topic", "topic", "t/#", formatter="json")
            tm.create("by_ip", "ip_address", "10.0.0.5")
            b.hooks.run("client.connected", "c1", 5, "10.0.0.5:52001")
            b.hooks.run("client.connected", "c2", 5, "10.9.9.9:52002")
            s, _ = b.open_session("c1", True)
            s.outgoing_sink = lambda pkts: None
            b.subscribe(s, "t/#", S.SubOpts(qos=1))
            b.publish(S.Message(topic="t/1", payload=b"\x01\x02", from_client="c1"))
            b.publish(S.Message(topic="u/1", payload=b"z", from_client="c2"))
            logs = {}
            for name in ("by_client", "by_topic", "by_ip"):
                lines = tm.read_log(name).splitlines()
                if name == "by_topic":
                    lines = [{k: v for k, v in json.loads(ln).items() if k != "time"}
                             for ln in lines]
                else:
                    lines = [ln.split(" ", 1)[1] for ln in lines]  # drop the time
                logs[name] = lines
            out.append((logs, [(t["name"], t["type"]) for t in tm.list()]))
        finally:
            obs.stop()
    assert out[1] == out[0]
    assert len(out[1][0]["by_client"]) == 3 and len(out[1][0]["by_topic"]) == 2


def _families(text):
    fams = [ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE ")]
    assert len(fams) == len(set(fams)), "a family is rendered twice"
    series = [ln.rsplit(" ", 1)[0] for ln in text.splitlines()
              if ln and not ln.startswith("#")]
    assert len(series) == len(set(series)), "a series is rendered twice"
    return set(fams)


async def _scrape(S, tmp_path):
    b, obs = make(S, tmp_path)
    try:
        b.tracer = S.OT.OtelTracer(endpoint="http://127.0.0.1:1/v1/traces")
        obs.topic_metrics.register("a/1/c")
        obs.slow_subs.track("c0", "a/1/c", 900.0)
        eng = S.engine(b, queue_depth=4)
        subscribe_fan(S, b)
        await drive(S, b, eng, [f"a/{i}/c" for i in range(4)])
        b.router.chaos_corrupt_rows(["a/+/c"])
        await drive(S, b, eng, ["a/z/c"])
        await eng.stop()
        obs.loop_lag.hist.observe(0.001)
        text = obs.prometheus_text()
        fams = _families(text)
        # the collector's emqx_xla_<counter|gauge> families follow each
        # implementation's own telemetry; every other family is the
        # scrape's structure and must be the reference's
        tel = _families("\n".join(b.router.telemetry.prometheus_lines("n1@host")))
        assert 'emqx_xla_audit_divergence_total{node="n1@host"} 1' in text
        return fams, tel
    finally:
        obs.stop()


async def test_scrape_families_equal_reference_minus_unported(tmp_path):
    ref, ref_tel = await _scrape(SIDES[0], tmp_path)
    port, port_tel = await _scrape(SIDES[1], tmp_path)
    ref_kept = {f for f in ref if not f.startswith(NOT_PORTED)}
    assert port - port_tel == ref_kept - ref_tel
    assert not any(f.startswith(NOT_PORTED) for f in port)
    for fam in ("emqx_xla_audit_total", "emqx_xla_audit_clean_total",
                "emqx_xla_audit_divergence_total", "emqx_xla_audit_quarantine_total",
                "emqx_xla_audit_quarantined_filters",
                "emqx_xla_publish_stage_seconds", "emqx_xla_delivery_stage_seconds",
                "emqx_xla_slo_burn_rate", "emqx_xla_slo_breached",
                "emqx_flight_events_total", "emqx_flight_triggers_total",
                "emqx_hook_duration_seconds", "emqx_otel_spans_dropped",
                "emqx_frame_native_encodes_total", "emqx_delivery_native_enabled",
                "emqx_retainer_entries", "emqx_xla_loop_lag_seconds"):
        assert fam in port and fam in ref, fam


# --- delivery identity of the timed walk ------------------------------------


def test_timed_plan_matches_plain_plan_output():
    """The instrumented walk is delivery-identical to the hot loop, and
    both equal the reference's: same deliveries, same sink output, same
    inflight state — across the bcast / rest / other legs, QoS0 fast
    paths, QoS1 bookkeeping and a disconnected session."""
    results = []
    for S in SIDES:
        for spanned in (False, True):
            b = S.broker()
            b._fanout_min_fan = 0
            sinks = {}
            for i in range(6):
                s, _ = b.open_session(f"p{i}", clean_start=True)
                out = sinks[f"p{i}"] = []
                s.outgoing_sink = out.append
                b.subscribe(s, "tp/+/v", S.SubOpts(qos=0 if i < 3 else 1))
                if i == 5:
                    s.connected = False
            msg = S.Message(topic="tp/1/v", payload=b"payload", qos=1)
            pairs = b.router.match_pairs(msg.topic)
            key = tuple(flt for flt, _ in pairs)
            span = S.S.StageSpan("tp/1/v", "t-identity") if spanned else None
            n = b._dispatch_direct(msg, pairs, key, span)
            flat = {cid: [bytes(p.payload) for batch in out for p in batch]
                    for cid, out in sinks.items()}
            inflight = {cid: len(b.sessions[cid].inflight) for cid in sinks}
            results.append((n, flat, inflight))
            if spanned:
                assert set(span.subs) >= {"dispatch_loop", "session_write"}
                assert span.fan == n
    assert results[0] == results[1] == results[2] == results[3]


def test_sync_publish_path_is_sampled_equal_reference(tmp_path):
    out = []
    for S in SIDES:
        b, obs = make(S, tmp_path)
        try:
            subscribe_fan(S, b)
            n1 = b.publish(S.Message(topic="a/1/c", payload=b"x"))
            b.sentinel.run_audits()
            st1 = state(b, obs)
            key = ("a/+/c",)
            entry = b._fanout_cache[key]
            mem, other = entry[1]
            b._fanout_cache[key] = (entry[0], (mem[:-1], other))
            n2 = b.publish(S.Message(topic="a/1/c", payload=b"x"))
            b.sentinel.run_audits()
            out.append((n1, st1, n2, state(b, obs), b.sentinel.divergences[-1]["kind"],
                        "deliver" in b.sentinel.stage_hist))
        finally:
            obs.stop()
    assert out[1] == out[0]
    assert out[1][0] == 6 and out[1][2] == 5 and out[1][4] == "fanout"


def test_sampled_ack_clock_gating_equal_reference():
    out = []
    for S in SIDES:
        st = S.S.PublishSentinel(S.broker(), sample_n=2)
        got = [st.maybe_ack_clock() is not None for _ in range(4)]
        st.sample_n = 0
        got.append(st.maybe_ack_clock() is None)
        st.observe_delivery("ack_sweep", 0.001)
        out.append((got, st.delivery_hist["ack_sweep"].total))
    assert out[1] == out[0] == ([False, True, False, True, True], 1)
