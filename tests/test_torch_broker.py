"""The port's broker publish path (emqx_tpu_torch.broker) held against
emqx_tpu.broker on the same seeded subscriptions, churn and publishes:
device-resolved fanout plans (K5's plain version on the CPU) against
both the port's own host oracle and the JAX Broker's plans, compared by
client id, options and order; delivery counts; a storm through both
DispatchEngines, compared per (session, topic); and the port's
no-fallback device rules.
"""

import asyncio
import random
from collections import Counter

import pytest
import torch

from emqx_tpu.broker import message as JM
from emqx_tpu.broker import packet as JP
from emqx_tpu.broker import pubsub as JB
from emqx_tpu.broker import session as JS
from emqx_tpu_torch import device as device_mod
from emqx_tpu_torch.broker import message as TM
from emqx_tpu_torch.broker import packet as TP
from emqx_tpu_torch.broker import pubsub as TB
from emqx_tpu_torch.broker import session as TS


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tier-1 runs test files side by side in worker processes; keep
    torch's CPU ops to one core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Side:
    """One implementation's broker plus its own classes, driven by the
    scenarios below; `log` collects what the two sides must agree on."""

    def __init__(self, port: bool, min_fan: int = 0, **kw):
        # a deterministic shared-group election, so both sides elect
        # the same member
        kw.setdefault("shared_strategy", "round_robin")
        self.port = port
        self.Message = TM.Message if port else JM.Message
        self.SubOpts = TP.SubOpts if port else JP.SubOpts
        self.Session = TS.Session if port else JS.Session
        if port:
            self.b = TB.Broker(device="cpu", **kw)
        else:
            self.b = JB.Broker(**kw)
        self.b._fanout_min_fan = min_fan  # device path even for tiny fans
        self.log = []
        self.sink = Counter()

    def sub(self, cid, flt, qos=0, **opts):
        b = self.b
        s = b.sessions.get(cid)
        if s is None:
            s, _ = b.open_session(cid, True)
            s.outgoing_sink = lambda pkts, c=cid: self.sink.update(
                (c, p.topic) for p in pkts
            )
        b.subscribe(s, flt, self.SubOpts(qos=qos, **opts))
        return s

    def plans(self, topic):
        b = self.b
        pairs = b.router.match_pairs(topic)
        key = tuple(f for f, _ in pairs)
        h = b.router.resolve_fanout_begin(key, min_fan=0)
        assert h is not None, f"device path refused {key}"
        return b.router.resolve_fanout_finish(h), b._build_fanout_plan(pairs)

    def check(self, topic):
        """Device plan == host oracle on this side (same session and
        SubOpts objects), logged by value for the cross-side check."""
        dev, orc = self.plans(topic)
        assert dev == orc, f"{topic}: device {dev} != oracle {orc}"
        for (dc, ds, do), (oc, os_, oo) in zip(dev[0], orc[0]):
            assert dc == oc and ds is os_ and do is oo
        self.log.append(("plan", topic, _norm(dev)))
        return dev

    def publish(self, topic, **kw):
        n = self.b.publish(self.Message(topic=topic, payload=b"x", **kw))
        self.log.append(("publish", topic, n))
        return n


def _opts(o):
    return (o.qos, o.no_local, o.retain_as_published, o.retain_handling)


def _norm(plan):
    mem, other = plan
    return (
        [(c, _opts(o)) for c, _s, o in mem],
        [(c, f, _opts(o)) for c, f, o in other],
    )


# --- the reference's plan cases (tests/test_fanout_device.py) --------------


def s_bit_identical(x):
    for i in range(24):
        x.sub(f"c{i}", "room/+/t", qos=i % 3)
    for i in range(12):
        x.sub(f"c{i}", "room/#", qos=(i + 1) % 3)
    x.check("room/7/t")


def s_max_qos_tie_break(x):
    s = x.sub("c1", "a/+", qos=1)
    x.b.subscribe(s, "a/#", x.SubOpts(qos=1))
    dev = x.check("a/b")
    assert len(dev[0]) == 1 and dev[0][0][2] is x.b.suboptions[("a/+", "c1")]
    x.b.subscribe(s, "a/#", x.SubOpts(qos=2))
    dev = x.check("a/b")
    assert dev[0][0][2] is x.b.suboptions[("a/#", "c1")]


def s_shared_legs(x):
    for i in range(8):
        x.sub(f"d{i}", "s/+/x")
    x.sub("g1", "$share/grp/s/+/x")
    x.sub("g2", "$share/grp/s/+/x")
    dev = x.check("s/1/x")
    assert {c for c, _s, _o in dev[0]} == {f"d{i}" for i in range(8)}
    assert x.publish("s/1/x") == 9


def s_exotic_sessions(x):
    class Exotic(x.Session):
        pass

    for i in range(4):
        x.sub(f"m{i}", "t/+")
    e = Exotic("x1")
    e.outgoing_sink = lambda pkts: None
    x.b.sessions["x1"] = e
    x.b.subscribe(e, "t/+", x.SubOpts(qos=1))
    dev = x.check("t/5")
    assert [c for c, _f, _o in dev[1]] == ["x1"] and dev[1][0][1] == "t/+"


def s_absent_sessions(x):
    for i in range(6):
        x.sub(f"c{i}", "gone/+")
    x.check("gone/1")
    x.b.close_session(x.b.sessions["c1"])
    x.b.close_session(x.b.sessions["c4"], discard=True)
    dev = x.check("gone/1")
    assert {c for c, _s, _o in dev[0]} == {"c0", "c2", "c3", "c5"}


def s_churn_oracle(x):
    for i in range(12):
        x.sub(f"c{i}", "fan/+/q", qos=i % 3)
    extras = []
    topics = ["fan/1/q", "fan/2/q"]
    for step in range(6):
        if step % 3 == 0:
            for i in range(4):
                extras.append(x.sub(f"e{step}-{i}", "fan/#", qos=i % 3))
        elif step % 3 == 1:
            x.sub(f"e{step}", "fan/+/q", qos=2)
            if extras:
                x.b.unsubscribe(extras.pop(0), "fan/#")
        else:
            for s in extras[:2]:
                x.b.unsubscribe(s, "fan/#")
            del extras[:2]
        for t in topics:
            x.check(t)
        for t in topics:
            want = x.b._build_fanout_plan(x.b.router.match_pairs(t))
            assert x.publish(t) == len(want[0]) + len(want[1])
    assert x.b.router.telemetry.counters["fanout_device_plans_total"] > 0


def s_row_recycle(x):
    s = [x.sub(f"c{i}", "old/+", qos=1) for i in range(5)]
    x.check("old/1")
    for sess in s:
        x.b.unsubscribe(sess, "old/+")
    for i in range(3):
        x.sub(f"n{i}", "new/+")
    dev = x.check("new/1")
    assert {c for c, _s, _o in dev[0]} == {"n0", "n1", "n2"}


def s_min_fan_and_deep(x):
    x.b._fanout_min_fan = 1024
    x.sub("c1", "tiny/+")
    r = x.b.router
    key = tuple(f for f, _ in r.match_pairs("tiny/1"))
    assert r.resolve_fanout_begin(key, min_fan=1024) is None
    deep = "/".join(["x"] * 20) + "/#"
    x.sub("c2", deep)
    key = tuple(f for f, _ in r.match_pairs("/".join(["x"] * 21)))
    assert r.resolve_fanout_begin(key, min_fan=0) is None
    assert r.telemetry.counters["fanout_host_fallback_total"] >= 1
    assert x.publish("tiny/1") == 1


def s_disjoint_churn_keeps_plans(x):
    b = x.b
    for i in range(6):
        x.sub(f"a{i}", "alpha/+")
    for i in range(6):
        x.sub(f"b{i}", "beta/+")
    x.publish("alpha/1")
    key_a = ("alpha/+",)
    assert b._plan_fresh(key_a)
    tel = b.router.telemetry
    hits0 = tel.counters.get("fanout_plan_hits", 0)
    x.sub("b9", "beta/+")
    b.unsubscribe(b.sessions["b0"], "beta/+")
    assert b._plan_fresh(key_a)
    x.publish("alpha/2")
    assert tel.counters.get("fanout_plan_hits", 0) == hits0 + 1
    x.sub("a9", "alpha/+")
    assert not b._plan_fresh(key_a)


def s_shared_leg_stamps(x):
    b = x.b
    for i in range(4):
        x.sub(f"c{i}", "sh/+")
    x.sub("g1", "$share/g/sh/+")
    x.publish("sh/1")
    skey = ("$shared", ("sh/+",))
    entry = b._fanout_cache[skey]
    x.sub("zz", "unrelated/+")
    assert b._plan_entry_fresh(entry, ("sh/+",))
    x.sub("g2", "$share/g/sh/+")
    assert not b._plan_entry_fresh(b._fanout_cache[skey], ("sh/+",))


def s_options_and_exact_rows(x):
    """no_local / retain_as_published edges, an exact-topic row, and a
    storm-path (add_routes) row rebuilt lazily at resolve time."""
    for i in range(10):
        x.sub(f"o{i}", "opt/+", qos=i % 3, no_local=i % 2 == 0,
              retain_as_published=i % 3 == 0)
    x.sub("o3", "opt/k", qos=2)
    x.b.router.add_routes([("opt/+", "node@a"), ("opt/#", "node@b")])
    x.check("opt/k")
    x.publish("opt/k", from_client="o0")
    x.publish("opt/k", from_client="o1", retain=True)


SCENARIOS = [
    s_bit_identical, s_max_qos_tie_break, s_shared_legs, s_exotic_sessions,
    s_absent_sessions, s_churn_oracle, s_row_recycle, s_min_fan_and_deep,
    s_disjoint_churn_keeps_plans, s_shared_leg_stamps,
    s_options_and_exact_rows,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[2:])
def test_plans_equal_reference(scenario):
    jx = Side(port=False)
    tx = Side(port=True)
    scenario(jx)
    scenario(tx)
    assert tx.log == jx.log
    assert tx.sink == jx.sink


def test_dest_store_after_broker_churn_equals_reference():
    """The same subscribe / unsubscribe / resubscribe / close sequence
    through both Brokers leaves both CSR stores identical: segment
    relocation, tombstones, compaction, row frees and the client
    registry. Both run their native churn cores (the default), whose
    lazy pending marks the stores must share too."""
    sides = [Side(port=False), Side(port=True)]
    for x in sides:
        rng = random.Random(5)
        for i in range(120):
            x.sub(f"c{i}", "hot/+", qos=i % 3)
            if i % 3 == 0:
                x.sub(f"c{i}", f"room/{i % 4}/#", qos=2)
        x.sub("g1", "$share/grp/hot/+")
        for i in rng.sample(range(120), 90):  # tombstones -> compaction
            x.b.unsubscribe(x.b.sessions[f"c{i}"], "hot/+")
        for i in range(0, 120, 7):
            x.sub(f"c{i}", "hot/+", qos=(i + 1) % 3)  # re-add / QoS change
        for i in range(0, 120, 11):
            x.b.close_session(x.b.sessions[f"c{i}"])
        for i in range(4):  # frees room/{i}/# rows, then reuses them
            for j in range(0, 120, 3):
                s = x.b.sessions.get(f"c{j}")
                if s is not None and f"room/{i}/#" in s.subscriptions:
                    x.b.unsubscribe(s, f"room/{i}/#")
        x.sub("z1", "fresh/+", qos=1)
        x.check("hot/5")
    js, ts = (x.b.router.dest_store for x in sides)
    assert ts.seg_len.sum() < 150  # the hot segment compacted
    for name in ("seg_off", "seg_len", "seg_cap", "seg_live", "edge_client",
                 "edge_opts", "client_alive", "client_mem"):
        assert (getattr(ts, name) == getattr(js, name)).all(), name
    assert ts.edge_dest == js.edge_dest and ts.edge_flt == js.edge_flt
    assert ts.client_row == js.client_row
    assert ts._free_segs == js._free_segs and ts.pending_rows == js.pending_rows
    assert sides[0].log == sides[1].log


# --- a storm through both dispatch engines --------------------------------------


def _storm_setup(x, rng):
    for i in range(60):
        k = rng.randrange(6)
        roll = rng.random()
        if roll < 0.4:
            x.sub(f"p{i}", "s/+/x", qos=rng.randrange(3))
        elif roll < 0.6:
            x.sub(f"p{i}", "s/#", qos=rng.randrange(3), no_local=rng.random() < 0.3)
        elif roll < 0.85:
            x.sub(f"p{i}", f"s/{k}/x", qos=rng.randrange(3))
        else:
            x.sub(f"p{i}", "$share/g/s/+/x", qos=rng.randrange(3))
        if rng.random() < 0.3:
            x.sub(f"p{i}", f"s/{k}/+", qos=rng.randrange(3))


def _storm_churn(x, rng):
    b = x.b
    for _ in range(6):
        cid = f"p{rng.randrange(60)}"
        s = b.sessions.get(cid)
        if s is None or not s.subscriptions or rng.random() < 0.5:
            x.sub(cid, f"s/{rng.randrange(6)}/x", qos=rng.randrange(3))
        else:
            b.unsubscribe(s, sorted(s.subscriptions)[0])
    cid = f"p{rng.randrange(60)}"
    if cid in b.sessions:
        b.close_session(b.sessions[cid])
    x.sub(cid, "s/#", qos=1)


async def _storm(x, seed):
    rng = random.Random(seed)
    _storm_setup(x, rng)
    eng = x.b.enable_dispatch_engine(queue_depth=16, pipeline_depth=2)
    eng.warmup()
    assert x.b.router.device_table.transfer_chunk_hits is not None
    counts = []
    for wave in range(4):
        msgs = [
            x.Message(
                topic=f"s/{rng.randrange(6)}/{rng.choice('xy')}",
                payload=b"m%d" % j,
                qos=rng.randrange(3),
                from_client=f"p{rng.randrange(60)}",
            )
            for j in range(48)
        ]
        futs = [eng.submit_many(msgs[i:i + 16]) for i in range(0, 48, 16)]
        counts.append(await asyncio.gather(*futs))
        await eng.drain()
        _storm_churn(x, rng)
    await eng.stop()
    return counts


@pytest.mark.parametrize("seed", [0, 1])
def test_engine_storm_equals_reference(seed):
    jx = Side(port=False)
    tx = Side(port=True)
    jc = asyncio.run(_storm(jx, seed))
    tc = asyncio.run(_storm(tx, seed))
    assert tc == jc
    assert tx.sink == jx.sink and sum(tx.sink.values()) > 0
    tel = tx.b.router.telemetry.counters
    assert tel.get("fanout_device_plans_total", 0) > 0
    assert tel.get("fanout_resolves_overlapped_total", 0) > 0


def test_plan_changed_in_flight_is_rebuilt():
    """An overlapped resolve launched at begin, then a subscribe to its
    filter before the batch lands: the plan installs stamped with the
    begin clock, arrives stale, and the dispatch rebuilds it — the late
    subscriber gets the message, on both engines."""

    async def drive(x):
        for i in range(6):
            x.sub(f"c{i}", "f/+", qos=i % 3)
        eng = x.b.enable_dispatch_engine(queue_depth=2, pipeline_depth=4)

        def two():
            return [x.Message(topic=f"f/{i}", payload=b"m") for i in (1, 2)]

        first = await eng.submit_many(two())  # warms the match cache
        await eng.drain()
        x.sub("c0", "f/+", qos=2)  # stales the plan, not the match cache
        fut = eng.submit_many(two())  # flushes: overlapped resolve in flight
        x.sub("late", "f/+", qos=1)  # lands while it is in flight
        second = await fut
        await eng.drain()
        await eng.stop()
        return first, second

    jx, tx = Side(port=False), Side(port=True)
    want = asyncio.run(drive(jx))
    got = asyncio.run(drive(tx))
    assert got == want == (12, 14)
    assert tx.sink == jx.sink and tx.sink[("late", "f/1")] == 1
    c = tx.b.router.telemetry.counters
    assert c["fanout_resolves_overlapped_total"] >= 1
    assert c["fanout_plan_stale"] >= 1


@pytest.mark.parametrize("policy", ["shed", "block"])
def test_engine_admission_equals_reference(policy):
    """A burst past queue_max_depth: the shed policy fails the excess
    with QueueOverloadError, the block policy parks it and serves it as
    capacity frees — the same outcome per publish on both engines."""

    async def burst(x):
        for i in range(4):
            x.sub(f"c{i}", "a/+", qos=i % 3)
        eng = x.b.enable_dispatch_engine(
            queue_depth=4, queue_max_depth=6, queue_policy=policy,
            queue_deadline_ms=60_000,
        )
        futs = [eng.submit(x.Message(topic=f"a/{i}", payload=b"x"))
                for i in range(14)]
        await eng.drain()
        out = []
        for f in futs:
            try:
                out.append(await f)
            except Exception as e:  # the publisher's outcome, compared
                out.append(type(e).__name__)
        c = x.b.router.telemetry.counters
        await eng.stop()
        return out, c.get("queue_shed_total", 0), c.get("queue_blocked_total", 0)

    jx, tx = Side(port=False), Side(port=True)
    want = asyncio.run(burst(jx))
    got = asyncio.run(burst(tx))
    assert got == want
    assert (got[1] if policy == "shed" else got[2]) > 0
    assert tx.sink == jx.sink


# --- device rules -----------------------------------------------------------


def test_cuda_default_broker_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(device_mod.NoCudaDevice):
        TB.Broker()
    assert TB.Broker(device="cpu").router.device == torch.device("cpu")


def test_device_fault_reaches_the_publisher(monkeypatch):
    """A fault in the device resolve that is not the card's (here an
    exception of the resolve's own code) raises to the caller; the
    engine fails the futures it touched with the fault itself — nothing
    is served from the host in its place. A device fault is re-served
    from the host instead (tests/test_torch_breaker.py)."""
    x = Side(port=True)
    for i in range(8):
        x.sub(f"c{i}", "f/+")

    class Fault(RuntimeError):
        pass

    def boom(*_a, **_k):
        raise Fault("device fault")

    monkeypatch.setattr(x.b.router.device_table.fanout, "resolve_begin", boom)
    with pytest.raises(Fault):
        x.b.publish(x.Message(topic="f/1", payload=b"x"))
    with pytest.raises(Fault):
        x.b.publish_batch([x.Message(topic="f/2", payload=b"x")])

    async def run():
        eng = x.b.enable_dispatch_engine(queue_depth=4)
        fut = eng.submit_many([x.Message(topic="f/3", payload=b"x")] * 4)
        await eng.drain()
        with pytest.raises(Fault):
            await fut
        await eng.stop()

    asyncio.run(run())
    assert sum(x.sink.values()) == 0
    tel = x.b.router.telemetry.counters
    assert tel.get("publish_failures_total", 0) == 4
    assert tel.get("fanout_host_fallback_total", 0) == 0
