"""The port's device failure domain (emqx_tpu_torch: chaos/faults.py,
the Router's fault seam, host re-serve, canary and full resync, the
Broker's re-serve branches and the DispatchEngine's circuit breaker)
held against emqx_tpu's on the CPU.

Each scenario builds the reference Broker + DispatchEngine +
DeviceFaultInjector (JAX on the CPU) and the port's (device="cpu",
every kernel wrapper on its plain version) from the same seeded
subscriptions, programs both injectors alike and publishes the same
sequence, then compares exactly: every publish's delivery count, the
breaker state after each wave, the breaker and fallback counters and
the `xla_device_breaker` alarm. The cases mirror
tests/test_device_breaker.py. Recovery is driven by calling
`probe_once()` directly (the probe loop's backoff is set past any
test's length), each side runs under its own `asyncio.wait_for` limit,
and no wall time is compared except the slow-batch case's deadline,
which the injected stall exceeds fivefold.
"""

import asyncio
import random
from collections import Counter

import pytest
import torch

from emqx_tpu.broker import message as JM
from emqx_tpu.broker import packet as JP
from emqx_tpu.broker import pubsub as JB
from emqx_tpu.chaos import faults as JF
from emqx_tpu.models import router as JR
from emqx_tpu.obs import alarm as JA
from emqx_tpu.parallel import mesh as JMesh
from emqx_tpu_torch.broker import message as TM
from emqx_tpu_torch.broker import packet as TP
from emqx_tpu_torch.broker import pubsub as TB
from emqx_tpu_torch.chaos import faults as TF
from emqx_tpu_torch.models import router as TR
from emqx_tpu_torch.obs import alarm as TA
from emqx_tpu_torch.obs.kernel_telemetry import LEG_DENSE
from emqx_tpu_torch.ops import _build
from emqx_tpu_torch.ops import fanout as fanout_ops
from emqx_tpu_torch.ops import hash_index as hash_ops
from emqx_tpu_torch.ops import transfer as transfer_ops
from emqx_tpu_torch.parallel import mesh as TMesh

# each side of a scenario runs under this limit (seconds)
SIDE_LIMIT_S = 10.0
# the probe loop never wakes inside a test: recovery is probe_once()
PROBE_PARKED_MS = 600_000.0
THRESHOLD = 3
# what the two sides must agree on after every wave
COUNTERS = (
    "breaker_trips_total",
    "breaker_recoveries_total",
    "breaker_fallback_total",
    "breaker_degraded_batches_total",
    "breaker_deadline_exceeded_total",
    "host_fallback_total",
    "fanout_host_fallback_total",
    "device_resyncs_total",
    "breaker_device_failures_total",
    "breaker_begin_failures_total",
    "breaker_probe_total",
    "breaker_probe_failures_total",
)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tier-1 runs test files side by side in worker processes; keep
    torch's CPU ops to one core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes(kind):
    if kind == "single":
        return None, None
    if kind == "mesh14":
        import jax

        return (JMesh.make_mesh(n_dp=1, n_sub=4, devices=jax.devices()[:4]),
                TMesh.make_mesh(1, 4, devices=["cpu"] * 4))
    return (JMesh.make_mesh(n_dp=2, n_sub=4),
            TMesh.make_mesh(2, 4, devices=["cpu"] * 8))


class Rig:
    """One implementation's broker, engine, injector and alarms, with
    `n` sessions on `room/{i % 4}/+`; `log` collects what the two sides
    must agree on."""

    def __init__(self, port: bool, mesh=None, n=12, class_budget=None,
                 min_fan=None, seed=0, **kw):
        self.port = port
        self.Message = TM.Message if port else JM.Message
        self.SubOpts = TP.SubOpts if port else JP.SubOpts
        self.b = TB.Broker(device="cpu", mesh=mesh) if port else JB.Broker(mesh=mesh)
        if min_fan is not None:
            self.b._fanout_min_fan = min_fan
        ix = self.b.router.index
        if class_budget is not None:
            ix.class_budget = class_budget
            ix._class_free = list(range(class_budget - 1, -1, -1))
        self.sink = Counter()
        for i in range(n):
            self.sub(f"c{i}", f"room/{i % 4}/+")
        kw.setdefault("queue_depth", 8)
        kw.setdefault("breaker_threshold", THRESHOLD)
        kw.setdefault("probe_backoff_ms", PROBE_PARKED_MS)
        kw.setdefault("probe_backoff_max_ms", PROBE_PARKED_MS)
        if not port:
            kw.setdefault("deadline_ms", 0.5)  # the port's DEADLINE_S
        self.eng = self.b.enable_dispatch_engine(**kw)
        self.alarms = (TA if port else JA).Alarms(self.b)
        self.eng.alarms = self.alarms
        self.inj = (TF if port else JF).DeviceFaultInjector(seed=seed).install(self.b.router)
        self.log = []

    def sub(self, cid, flt, qos=0):
        b = self.b
        s = b.sessions.get(cid)
        if s is None:
            s, _ = b.open_session(cid, True)
            s.outgoing_sink = lambda pkts, c=cid: self.sink.update(
                (c, p.topic) for p in pkts
            )
        b.subscribe(s, flt, self.SubOpts(qos=qos))
        return s

    @property
    def tel(self):
        return self.b.router.telemetry.counters

    def snap(self, tag):
        """The state both sides must agree on, logged under `tag`."""
        c = self.tel
        self.log.append((
            tag, self.eng.breaker_state, self.b.router.device_suspended,
            tuple(c.get(k, 0) for k in COUNTERS),
            self.alarms.is_active("xla_device_breaker"),
        ))

    async def wave(self, topics, tag):
        counts = await asyncio.gather(
            *[self.eng.publish(self.Message(topic=t, payload=b"x")) for t in topics]
        )
        self.log.append((tag, "counts", list(counts)))
        self.snap(tag)
        return counts

    def oracle(self, topics):
        """Each topic's delivery count on the host path (no device)."""
        return [self.b.publish(self.Message(topic=t, payload=b"y")) for t in topics]


def both(scenario, kind="single", limit_s=SIDE_LIMIT_S, **kw):
    """Run `scenario(rig)` on the reference and on the port (each on its
    own (2, 4) mesh for kind "mesh", (1, 4) for "mesh14"), each under its own time limit;
    return the two rigs after their logs matched."""
    meshes = _meshes(kind)
    rigs = []
    for port in (False, True):
        r = Rig(port, mesh=meshes[port], **kw)

        async def go(r=r):
            try:
                await scenario(r)
            finally:
                await r.eng.stop()

        asyncio.run(asyncio.wait_for(go(), limit_s))
        rigs.append(r)
    ref, got = rigs
    assert got.log == ref.log
    assert got.sink == ref.sink
    assert got.inj.injected == ref.inj.injected
    return ref, got


# --- transient failover: publishers never see the fault -------------------


@pytest.mark.parametrize("leg", TF.LEGS)
def test_transient_fault_per_leg_equals_reference(leg):
    async def scenario(r):
        topics = [f"room/{i % 4}/t{i}" for i in range(8)]
        r.inj.fail_transient(1, legs=(leg,))
        counts = await r.wave(topics, "faulted")
        assert counts == [3] * 8
        assert r.inj.faults_raised == 1 and r.inj.healthy
        await r.wave([f"{t}b" for t in topics], "healthy")

    _ref, got = both(scenario, min_fan=0)
    c = got.tel
    assert c["breaker_device_failures_total"] >= 1
    assert got.eng.breaker_state == "closed"
    assert not got.alarms.is_active("xla_device_breaker")
    moved = {
        "match_finish": "breaker_fallback_total",
        "match_begin": "breaker_begin_failures_total",
        "sync": "breaker_begin_failures_total",
        "fanout_begin": "fanout_host_fallback_total",
        "fanout_finish": "fanout_host_fallback_total",
    }[leg]
    assert c[moved] >= 1


def test_transient_fanout_leg_falls_back_equals_reference():
    # fanout-resolve faults degrade the PLAN to the host walk without
    # failing the publish or staling the match results
    async def scenario(r):
        topics = [f"room/{i % 4}/f{i}" for i in range(8)]
        warm = await r.wave(topics, "warm")  # plans resolved on the device
        r.inj.fail_transient(4, legs=("fanout_begin", "fanout_finish"))
        for i in range(4):
            r.b._mark_fanout(f"room/{i}/+")  # every plan re-resolves
        assert await r.wave(topics, "faulted") == warm
        assert r.inj.faults_raised >= 1

    _ref, got = both(scenario, min_fan=0)
    assert got.tel["fanout_host_fallback_total"] >= 1


# --- sticky loss: trip -> degrade -> probe -> resync -> close -------------


@pytest.mark.parametrize("kind", ["single", "mesh"])
def test_sticky_loss_trips_and_recovers_equals_reference(kind):
    async def scenario(r):
        topics = [f"room/{i % 4}/s{i}" for i in range(8)]
        sync = r.oracle(topics)
        r.inj.fail_sticky()
        for wave in range(r.eng.breaker_threshold + 2):
            counts = await r.wave([f"{t}w{wave}" for t in topics], f"sticky {wave}")
            assert counts == [3] * 8
            if r.eng.breaker_state == "open":
                break
        assert r.eng.breaker_state == "open" and r.b.router.device_suspended
        assert r.alarms.is_active("xla_device_breaker")
        # degraded service: host answers, nothing reaches the device
        batches = r.tel.get("dispatch_batches_total", 0)
        assert await r.wave(topics, "degraded") == sync
        assert r.tel.get("dispatch_batches_total", 0) == batches
        # a probe fails while the link is down, and the breaker stays open
        assert not r.eng.probe_once()
        r.snap("probe while lost")
        assert r.eng.breaker_state == "open"
        r.inj.heal()
        assert r.eng.probe_once()
        r.snap("probe after heal")
        assert not r.b.router.device_suspended
        assert await r.wave(topics, "recovered") == sync
        assert r.tel.get("dispatch_batches_total", 0) > batches

    _ref, got = both(scenario, kind)
    if kind == "mesh":
        assert got.b.router.device_table.n_shards == 4
    c = got.tel
    assert c["breaker_trips_total"] == 1 and c["breaker_recoveries_total"] == 1
    assert c["device_resyncs_total"] == 1
    assert not got.alarms.is_active("xla_device_breaker")


def test_slow_batches_count_toward_breaker_equals_reference():
    # a stalled fetch that still SUCCEEDS past the deadline: results
    # serve (correct), but the breaker hears about every slow batch.
    # The stall is 5x the deadline; an unstalled CPU batch takes a few ms
    deadline_ms = 100.0

    async def scenario(r):
        topics = [f"room/{i % 4}/sl{i}" for i in range(4)]
        sync = r.oracle(topics)
        assert await r.wave([f"{t}warm" for t in topics], "warm") == [3] * 4
        r.inj.stall(5 * deadline_ms / 1e3, n=THRESHOLD, legs=("match_finish",))
        for wave in range(THRESHOLD):
            assert await r.wave([f"{t}w{wave}" for t in topics], f"slow {wave}") == sync
        assert r.eng.breaker_state == "open"
        r.inj.heal()

    _ref, got = both(scenario, queue_depth=4, breaker_deadline_ms=deadline_ms)
    assert got.tel["breaker_deadline_exceeded_total"] == THRESHOLD
    assert got.tel["breaker_trips_total"] == 1
    assert got.inj.stalls_injected == THRESHOLD


# --- recovery re-uploads what changed during the outage -------------------

# with a two-class budget, `room/{i}/+` takes one class and the first of
# these the other; the rest are residual rows (the dense leg's)
RESIDUAL = ["a/+/b/#", "+/x", "q/#", "+/+/+/z"]


def test_recovery_resync_heals_routes_and_residual_rows():
    async def scenario(r):
        for k, f in enumerate(RESIDUAL):
            r.sub(f"r{k}", f)
        ix = r.b.router.index
        assert len(ix.residual_rows) == len(RESIDUAL) - 1
        probe = ["a/1/b/c", "z/x", "q/1", "1/2/3/z", "room/1/p", "fresh/1", "n/1/2/3/k"]
        assert await r.wave(probe, "before") == r.oracle(probe)
        r.inj.fail_sticky()
        for wave in range(THRESHOLD):
            await r.wave([f"room/1/o{wave}"], f"trip {wave}")
        assert r.eng.breaker_state == "open"
        # mid-outage: a brand-new filter, a new residual filter, a
        # residual filter gone (its mask bit cleared) and another's
        # row handed to a new filter of the same skeleton
        r.sub("late", "fresh/+")
        r.sub("late2", "n/+/+/+/k")
        r.b.unsubscribe(r.b.sessions["r1"], "+/x")
        r.b.unsubscribe(r.b.sessions["r2"], "q/#")
        r.sub("r2", "w/#")
        assert await r.wave(probe + ["w/1"], "degraded") == r.oracle(probe + ["w/1"])
        r.inj.heal()
        assert r.eng.probe_once()
        r.snap("recovered")
        batches = r.tel.get("dispatch_batches_total", 0)
        after = [f"{t}/e" if t.endswith("#") else t for t in probe] + ["w/1", "w/2/3"]
        assert await r.wave(after, "served on the device") == r.oracle(after)
        assert r.tel.get("dispatch_batches_total", 0) > batches

    _ref, got = both(scenario, class_budget=2)
    router = got.b.router
    dt = router.device_table
    mask = torch.nonzero(dt._dev_residual).flatten().tolist()
    assert mask == sorted(router.index.residual_rows)
    assert router.telemetry.histogram(LEG_DENSE).total > 0


# --- the synchronous publish surface --------------------------------------


def test_publish_batch_degrades_and_recovers_equals_reference():
    logs = []
    for port in (False, True):
        r = Rig(port, min_fan=0)
        topics = [f"room/{i % 4}/pb{i}" for i in range(6)]
        msgs = [r.Message(topic=t, payload=b"x") for t in topics]
        r.inj.fail_sticky()
        for k in range(THRESHOLD):
            assert r.b.publish_batch(msgs) == [3] * 6
            r.snap(f"sticky {k}")
        assert r.eng.breaker_state == "open"
        # the single-publish path resolves plans host-side while open
        r.b._mark_fanout("room/2/+")
        assert r.b.publish(r.Message(topic="room/2/q", payload=b"x")) == 3
        r.snap("sync publish while open")
        r.inj.heal()
        assert r.eng.probe_once()
        assert r.b.publish_batch(msgs) == [3] * 6
        r.snap("recovered")
        logs.append((r.log, r.sink))
    assert logs[1] == logs[0]


# --- the injector itself ---------------------------------------------------


def _raised(inj, leg, shard=None):
    try:
        inj.check(leg, shard=shard)
    except RuntimeError as e:
        return type(e).__name__, getattr(e, "shard", None)
    return None


def test_injector_modes_and_scoping_equal_reference():
    out = []
    for F, R in ((JF, JR.Router), (TF, TR.Router)):
        r = R() if F is JF else R(device="cpu")
        r.add_route("room/1/+", "c1")
        inj = F.DeviceFaultInjector(seed=7).install(r)
        assert r.fault_injector is inj and r.device_table.fault_injector is inj
        seq = [_raised(inj, leg) for leg in ("match_begin", "match_finish", "sync")]
        inj.fail_transient(1, legs=("sync",))
        seq += [_raised(inj, "match_begin"), _raised(inj, "sync"), inj.healthy]
        inj.fail_sticky()
        seq += [_raised(inj, "match_finish"), _raised(inj, "fanout_begin")]
        inj.heal()
        seq.append(_raised(inj, "match_finish"))
        # shard scoping: the fault names its shard; the direct probe of
        # a non-target chip passes, of the target fails
        inj.fail_sticky(shards=[2])
        seq += [_raised(inj, "match_begin"), _raised(inj, F.SHARD_PROBE_LEG, 1),
                _raised(inj, F.SHARD_PROBE_LEG, 2)]
        inj.heal()
        st = inj.status()
        inj.uninstall()
        assert r.fault_injector is None and r.device_table.fault_injector is None
        # the seeded schedule replays: same seed, same draws
        a = F.DeviceFaultInjector(seed=3)
        a.fail_random(0.5)
        draws = [_raised(a, "match_begin") for _ in range(64)]
        out.append((seq, st, draws, a.injected, a.pick_shard(8)))
    assert out[1] == out[0]
    seq, st, draws, _inj, _pick = out[1]
    assert seq[:3] == [None] * 3
    assert seq[9] == ("DeviceLostError", 2)
    assert st["faults_raised"] == 5 and st["injected"]
    assert sum(d is not None for d in draws) > 0


@pytest.mark.parametrize("seed", [5, 11])
def test_seeded_random_schedule_equals_reference(seed):
    """fail_random through the whole publish path: both injectors draw
    from the same seed at the same checks, so their per-leg ledgers,
    the served counts and the breaker's moves are equal."""

    async def scenario(r):
        rng = random.Random(seed)
        r.inj.fail_random(0.3)
        for wave in range(6):
            topics = [f"room/{rng.randrange(4)}/x{wave}{j}" for j in range(8)]
            assert await r.wave(topics, f"random {wave}") == [3] * 8
            for i in range(4):
                r.b._mark_fanout(f"room/{i}/+")
        r.inj.heal()
        if r.eng.breaker_state == "open":
            assert r.eng.probe_once()
        await r.wave(["room/0/done"], "healed")

    ref, got = both(scenario, min_fan=0, seed=seed,
                    breaker_threshold=8)
    assert got.inj.checks_total == ref.inj.checks_total > 0
    assert got.inj.faults_raised == ref.inj.faults_raised > 0


def test_router_suspend_resume_and_host_serve_equal_reference():
    out = []
    for port in (False, True):
        r = Rig(port)
        router = r.b.router
        topics = [f"room/{i % 4}/hs{i}" for i in range(6)]
        want = [sorted(router.match_filters(t)) for t in topics]
        got = [sorted(x) for x in router.match_filters_batch(topics)]
        assert router.suspend_device() and not router.suspend_device()
        host = router.match_filters_batch([f"{t}b" for t in topics])
        canary = [sorted(x) for x in router.canary_match(topics)]
        router.device_resync()
        router.resume_device()
        again = [sorted(x) for x in router.match_filters_batch(topics)]
        c = router.telemetry.counters
        out.append((want, got, host, canary, again,
                    c.get("breaker_degraded_batches_total", 0),
                    c.get("device_resyncs_total", 0)))
    assert out[1] == out[0]
    want, got, host, canary, again, degraded, resyncs = out[1]
    assert got == canary == again == want and degraded == 1 and resyncs == 1


# --- a fault that surfaces at a readiness poll (port only) -----------------


def test_ready_poll_fault_reserves_from_host(monkeypatch):
    """A CUDA error surfaces at the first synchronising call, which in
    the engine is the ring head's readiness poll inside the _drain loop
    callback. A ticket whose ready() raises must take the failed-fetch
    path: the batch re-served from host truth, the failure counted, no
    publisher stranded."""

    # what torch raises for an asynchronous CUDA error
    PollFault = getattr(torch, "AcceleratorError", RuntimeError)

    class FaultyTicket(transfer_ops.FetchTicket):
        raised = 0

        def ready(self):
            if not FaultyTicket.raised:
                FaultyTicket.raised += 1
                raise PollFault("CUDA error: an illegal memory access was encountered")
            return super().ready()

    r = Rig(True, queue_depth=8)
    topics = [f"room/{i % 4}/rd{i}" for i in range(8)]
    sync = r.oracle(topics)
    monkeypatch.setattr(transfer_ops, "start_fetch",
                        lambda tensors, telemetry=None: FaultyTicket(tensors, telemetry))

    async def go():
        try:
            return await r.wave(topics, "poll fault")
        finally:
            await r.eng.stop()

    counts = asyncio.run(asyncio.wait_for(go(), SIDE_LIMIT_S))
    assert counts == sync == [3] * 8
    c = r.tel
    assert FaultyTicket.raised == 1
    assert c["breaker_fallback_total"] == 8
    assert c["breaker_device_failures_total"] == 1
    assert c.get("publish_failures_total", 0) == 0
    assert PollFault.__name__ in r.eng.last_device_error
    assert r.eng.breaker_state == "closed"


# --- a device fault in the plan resolve, on every publish surface ---------


def test_device_fault_in_resolve_reserves_equal_reference(monkeypatch):
    """A device fault in the plan resolve reaches each publisher as the
    host walk's answer, never as the fault: the synchronous publish,
    the batch publish and the engine all serve the plan from host truth
    (counted), on both brokers alike."""

    async def engine_side(r):
        try:
            fut = r.eng.submit_many([r.Message(topic="room/3/c", payload=b"x")] * 4)
            await r.eng.drain()
            return await fut
        finally:
            await r.eng.stop()

    out = []
    for port in (False, True):
        r = Rig(port, min_fan=0)
        err = (TF if port else JF).TransientDeviceError

        def boom(*_a, err=err, **_k):
            raise err("device fault")

        monkeypatch.setattr(r.b.router.device_table.fanout, "resolve_begin", boom)
        got = (
            r.b.publish(r.Message(topic="room/1/a", payload=b"x")),
            r.b.publish_batch([r.Message(topic="room/2/b", payload=b"x")]),
            asyncio.run(asyncio.wait_for(engine_side(r), SIDE_LIMIT_S)),
        )
        r.snap("resolve fault")
        out.append((got, r.tel.get("publish_failures_total", 0), r.log, r.sink))
    assert out[1] == out[0]
    got, failures, log, sink = out[1]
    assert got == (3, [3], 12)
    assert failures == 0
    assert log[-1][3][COUNTERS.index("fanout_host_fallback_total")] > 0
    assert sum(sink.values()) == 3 * 6


# --- a fault that is not the card's is never served from the host ---------


def _kernel_not_built(*_a, **_k):
    raise _build.KernelBuildError("emqx_match_hash: no sm_90a image")


@pytest.mark.parametrize("leg", ["warmup", "match", "resolve"])
def test_kernel_build_error_reaches_the_publisher(monkeypatch, leg):
    """A kernel that fails to build is a fault of the program, not of
    the card: warm-up raises it, an engine batch fails its publishers
    with it and `publish_batch` raises it. Nothing is re-served from
    the host, and the breaker does not hear of it."""
    r = Rig(True, min_fan=0)
    if leg == "resolve":
        monkeypatch.setattr(fanout_ops, "resolve_fanout", _kernel_not_built)
    else:
        monkeypatch.setattr(hash_ops, "match_ids_hash", _kernel_not_built)
    topics = [f"room/{i % 4}/k{i}" for i in range(8)]

    async def go():
        try:
            if leg == "warmup":
                with pytest.raises(_build.KernelBuildError):
                    r.eng.warmup()
                return
            futs = [r.eng.submit(r.Message(topic=t, payload=b"x")) for t in topics]
            await r.eng.drain()
            for f in futs:
                with pytest.raises(_build.KernelBuildError):
                    await f
        finally:
            await r.eng.stop()

    asyncio.run(asyncio.wait_for(go(), SIDE_LIMIT_S))
    if leg != "warmup":
        with pytest.raises(_build.KernelBuildError):
            r.b.publish_batch([r.Message(topic="room/1/k", payload=b"x")])
        assert r.tel.get("publish_failures_total", 0) == 8
    c = r.tel
    for k in ("breaker_device_failures_total", "breaker_fallback_total",
              "breaker_begin_failures_total", "host_fallback_total",
              "fanout_host_fallback_total", "warmup_failures_total"):
        assert c.get(k, 0) == 0, k
    assert r.eng.breaker_state == "closed" and not r.b.router.device_suspended
    assert sum(r.sink.values()) == 0


# --- shard breaker: chip loss -> evacuate -> N-1 -> rebalance back ---------

SHARD_COUNTERS = (
    "breaker_shard_trips_total",
    "breaker_shard_evacuations_total",
    "breaker_shard_evacuation_failures_total",
    "breaker_shard_recoveries_total",
    "breaker_trips_total",
    "breaker_probe_total",
    "breaker_probe_failures_total",
    "shard_suspends_total",
    "shard_resumes_total",
    "shard_evacuations_total",
    "shard_rebalances_total",
)


def _shard_snap(r, tag):
    """The shard domain's state both sides must agree on."""
    dt = r.b.router.device_table
    c = r.tel
    r.log.append((
        tag, sorted(r.eng.open_shards), sorted(dt.lost_shards), dt.n_shards,
        tuple(c.get(k, 0) for k in SHARD_COUNTERS),
        r.alarms.is_active("xla_device_breaker"), r.eng.status()["shard_breaker"],
    ))


def test_shard_trip_evacuates_and_recovers_equals_reference():
    """tests/test_device_breaker.py's shard trip on a (1, 4) mesh, both
    probe loops parked and `probe_shard_once()` driven: sticky loss of
    one shard trips the shard breaker (the whole breaker closed, the
    table never suspended), the slice evacuates onto 3 shards that
    serve every publish as the oracle does, a probe fails while the
    fault is live, and after heal() the probe rebalances back to 4 with
    a verified canary. Both sides agree after every wave. The
    reference's evacuation warms its survivor layout's launch shapes
    (`warmup_shapes`, every pow2 batch to 64): on the CPU that is ~15 s
    of XLA compiles, so its warm-up is left out here; the port warms
    as it does on the card (results are not touched by a warm-up)."""
    victim = 2

    async def scenario(r):
        if not r.port:
            r.b.router.warmup_shapes = lambda max_batch=64: 0
        dt = r.b.router.device_table
        topics = [f"room/{i % 4}/s{i}" for i in range(8)]
        sync = r.oracle(topics)
        r.inj.fail_sticky(shards=[victim])
        for wave in range(r.eng.breaker_threshold + 4):
            counts = await r.wave([f"{t}w{wave}" for t in topics], f"sticky {wave}")
            assert counts == [3] * 8
            _shard_snap(r, f"sticky {wave}")
            if victim in r.eng.open_shards:
                break
        assert victim in r.eng.open_shards
        assert r.eng.breaker_state == "closed" and not r.b.router.device_suspended
        assert dt.lost_shards == {victim} and dt.n_shards == 3
        assert r.alarms.is_active("xla_device_breaker")
        # N-1 service on the device, answers equal to the oracle
        batches = r.tel.get("dispatch_batches_total", 0)
        assert await r.wave(topics, "N-1") == sync
        assert r.tel.get("dispatch_batches_total", 0) > batches
        _shard_snap(r, "N-1")
        # the probe fails while the chip's fault is live
        assert not r.eng.probe_shard_once(victim)
        _shard_snap(r, "probe while lost")
        assert victim in r.eng.open_shards and dt.lost_shards == {victim}
        r.inj.heal()
        assert r.eng.probe_shard_once(victim)
        _shard_snap(r, "probe after heal")
        assert dt.lost_shards == set() and dt.n_shards == 4
        assert not r.alarms.is_active("xla_device_breaker")
        assert await r.wave(topics, "restored") == sync
        _shard_snap(r, "restored")

    # the reference side compiles its (1, 3) and (1, 4) kernels inside
    # the scenario (~3 s alone here): a guard against a hang, not a time
    _ref, got = both(scenario, "mesh14", limit_s=3 * SIDE_LIMIT_S)
    c = got.tel
    assert c["breaker_shard_trips_total"] == c["breaker_shard_evacuations_total"] == 1
    assert c["breaker_shard_recoveries_total"] == 1
    assert c.get("breaker_trips_total", 0) == 0
    st = got.eng.status()["shard_breaker"]
    assert st["open_shards"] == [] and st["lost_shards"] == [] and st["shard_gen"] == 2


def _scrape_drive(port: bool):
    """tests/test_prometheus_lint.py's shard-family drive on one side:
    shard-scoped injected faults, a suspend/overlay/resume cycle and an
    evacuate -> N-1 serve -> rebalance cycle on a (1, 4) mesh."""
    from emqx_tpu.obs import prometheus_text as j_text
    from emqx_tpu_torch.obs import prometheus_text as t_text

    jmesh, tmesh = _meshes("mesh14")
    b = TB.Broker(device="cpu", mesh=tmesh) if port else JB.Broker(mesh=jmesh)
    SubOpts = TP.SubOpts if port else JP.SubOpts
    for i in range(4):
        s, _ = b.open_session(f"c{i}", clean_start=True)
        s.outgoing_sink = lambda pkts: None
        b.subscribe(s, f"q/{i}/+", SubOpts(qos=0))
    r = b.router
    F = TF if port else JF
    topics = [f"q/{i}/v" for i in range(4)]
    answers = [[sorted(x) for x in r.match_filters_batch(topics)]]
    inj = F.DeviceFaultInjector(seed=11).install(r)
    inj.fail_transient(2, legs=("match_begin",), shards=[1])
    for _ in range(2):
        try:
            inj.check("match_begin")
        except F.DeviceLinkError:
            pass
    inj.fail_sticky(shards=[2])
    try:
        inj.check("sync")
    except F.DeviceLinkError:
        pass
    inj.heal()
    assert r.suspend_shard(0)
    answers.append([sorted(x) for x in r.match_filters_batch(topics)])
    r.resume_shard(0)
    assert r.evacuate_shard(1)
    answers.append([sorted(x) for x in r.match_filters_batch(topics)])
    assert r.rebalance_shard(1)
    answers.append([sorted(x) for x in r.match_filters_batch(topics)])
    return (t_text if port else j_text)(b, "n1@host"), answers


SHARD_FAMILIES = {
    "emqx_xla_fault_injected_total": "counter",
    "emqx_xla_chaos_device_faults_total": "counter",
    "emqx_xla_shard_suspends_total": "counter",
    "emqx_xla_shard_resumes_total": "counter",
    "emqx_xla_shard_overlay_total": "counter",
    "emqx_xla_shard_evacuations_total": "counter",
    "emqx_xla_shard_rebalances_total": "counter",
    "emqx_xla_shards_suspended": "gauge",
    "emqx_xla_shards_lost": "gauge",
    "emqx_xla_mesh_shards": "gauge",
}


def test_shard_scrape_families_equal_reference():
    """The scrape after the drive renders the reference's shard families
    with the same types and the same samples (the labeled
    fault_injected_total{leg,shard} ones included), and lints."""
    from test_prometheus_lint import _lint

    out = []
    for port in (False, True):
        text, answers = _scrape_drive(port)
        types = _lint(text)
        fams = {f: types.get(f) for f in SHARD_FAMILIES}
        samples = sorted(ln for ln in text.splitlines()
                         if ln.split("{", 1)[0] in SHARD_FAMILIES)
        out.append((fams, samples, answers))
    assert out[1] == out[0]
    fams, samples, answers = out[1]
    assert fams == SHARD_FAMILIES
    assert 'emqx_xla_fault_injected_total{node="n1@host",leg="match_begin",shard="1"} 2' \
        in samples
    assert 'emqx_xla_mesh_shards{node="n1@host"} 4' in samples
    assert 'emqx_xla_shards_lost{node="n1@host"} 0' in samples
    assert answers == [[[f"q/{i}/+"] for i in range(4)]] * 4


def test_kernel_build_error_in_the_evacuation_reaches_the_publisher(monkeypatch):
    """A kernel that fails to build while the shard breaker evacuates
    (the survivor layout's warm-up) or rebalances (the canary) is a
    fault of the program: the publishers of the batch that tripped the
    shard fail with it, no evacuation failure is counted as the card's,
    and probe_shard_once raises it."""
    from emqx_tpu_torch.parallel import sharded_match as TS

    r = Rig(True, mesh=_meshes("mesh14")[1])
    dt = r.b.router.device_table
    real = TS._tiles_hash

    def tiles_hash(mesh, *a, **k):
        if dt.lost_shards or dt.shard_gen:
            raise _build.KernelBuildError("emqx_mesh_match_ids_hash: no sm_90a image")
        return real(mesh, *a, **k)

    monkeypatch.setattr(TS, "_tiles_hash", tiles_hash)
    topics = [f"room/{i % 4}/kb{i}" for i in range(8)]

    async def go():
        try:
            r.inj.fail_sticky(shards=[2])
            failed = 0
            for wave in range(r.eng.breaker_threshold + 4):
                futs = [r.eng.submit(r.Message(topic=f"{t}w{wave}", payload=b"x"))
                        for t in topics]
                await r.eng.drain()
                for f in futs:
                    try:
                        await f
                    except _build.KernelBuildError:
                        failed += 1
                if 2 in r.eng.open_shards:
                    break
            r.inj.heal()
            with pytest.raises(_build.KernelBuildError):
                r.eng.probe_shard_once(2)
            return failed
        finally:
            await r.eng.stop()

    failed = asyncio.run(asyncio.wait_for(go(), SIDE_LIMIT_S))
    assert failed >= 1
    c = r.tel
    assert c["breaker_shard_trips_total"] == 1
    assert c.get("breaker_shard_evacuation_failures_total", 0) == 0
    assert r.eng.breaker_state == "closed" and not r.b.router.device_suspended
    assert 2 in r.eng.open_shards and dt.lost_shards == {2}
    assert not r.eng._shard_probe_tasks
