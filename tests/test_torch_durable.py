"""The broker side of the port's durable tier held against the
reference's on the CPU: the persist gate on every publish path, durable
sessions, shared queues, the persistent retainer (and its reads through
the retained device index after a reopen), cross-opens of one package's
data directory by the other in both directions, and offline delivery and
restart survival through the port's Server over real sockets; and
chip_smoke.py phase 13's deployment at a small size, its card paths
against its oracle's.

Every scenario runs on both sides with the same inputs and returns a
trace; the port's must equal the reference's. The DS buffers are given a
flush interval that never fires, so every flush (and the pump it
triggers) happens where the scenario calls `flush_now()`."""

import asyncio
import json
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from emqx_tpu.broker import frame as JFR
from emqx_tpu.broker import message as JM
from emqx_tpu.broker import packet as JP
from emqx_tpu.broker import pubsub as JB
from emqx_tpu.broker import server as JSV
from emqx_tpu.broker import session as JSE
from emqx_tpu.chaos import faults as JF
from emqx_tpu.ds import api as JA
from emqx_tpu.ds import metrics as JDM
from emqx_tpu.ds import session_ds as JD
from emqx_tpu.ds import shared_queue as JQ
from emqx_tpu.models import retainer as JR
from emqx_tpu_torch.broker import frame as TFR
from emqx_tpu_torch.broker import message as TM
from emqx_tpu_torch.broker import packet as TP
from emqx_tpu_torch.broker import pubsub as TB
from emqx_tpu_torch.broker import server as TSV
from emqx_tpu_torch.broker import session as TSE
from emqx_tpu_torch.chaos import faults as TF
from emqx_tpu_torch.ds import api as TA
from emqx_tpu_torch.ds import metrics as TDM
from emqx_tpu_torch.ds import session_ds as TD
from emqx_tpu_torch.ds import shared_queue as TQ
from emqx_tpu_torch.models import retainer as TR
from emqx_tpu_torch.obs.prometheus import prometheus_text

import chip_smoke as cs

NEVER_MS = 3_600_000  # a DS buffer flush interval that never fires in a test


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tier-1 runs test files side by side in worker processes; keep
    torch's CPU ops to one core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Side:
    """One package's classes, named alike."""

    def __init__(self, port: bool):
        self.port = port
        self.Message = TM.Message if port else JM.Message
        self.SubOpts = TP.SubOpts if port else JP.SubOpts
        self.P = TP if port else JP
        self.FR = TFR if port else JFR
        self.Cfg = TSE.SessionConfig if port else JSE.SessionConfig
        self.A = TA if port else JA
        self.D = TD if port else JD
        self.Q = TQ if port else JQ
        self.R = TR if port else JR
        self.F = TF if port else JF
        self.SV = TSV if port else JSV
        self.DM = TDM if port else JDM
        self.tick = 0

    def msg(self, topic, payload=b"", **kw):
        """A Message whose default timestamp is the side's next tick (DS
        keys carry it, so positions must not depend on the clock)."""
        self.tick += 1
        kw.setdefault("timestamp", 1.7e9 + self.tick * 1e-3)
        return self.Message(topic=topic, payload=payload, **kw)

    def broker(self):
        return TB.Broker(device="cpu") if self.port else JB.Broker()

    def db(self, d, n_shards=2, **kw):
        return self.A.Db("messages", data_dir=str(d), n_shards=n_shards,
                         buffer_flush_ms=NEVER_MS, buffer_max=1 << 30, **kw)

    def durable(self, d, n_shards=2):
        db = self.db(d, n_shards)
        mgr = self.D.DurableSessionManager(db, state_dir=str(d))
        b = self.broker()
        b.enable_durable(mgr)
        return b, mgr, db

    def retainer(self, path, device=False):
        if self.port:
            return self.R.PersistentRetainer(str(path), device="cpu")
        return self.R.PersistentRetainer(str(path))


SIDES = (Side(False), Side(True))


def reset_ledgers():
    for m in (JDM.DS_METRICS, TDM.DS_METRICS):
        with m._lock:
            for k in m.counters:
                m.counters[k] = 0
            for k in m.gauges:
                m.gauges[k] = 0.0
            m.injected.clear()


def both(fn, tmp_path, *args):
    """fn(side, directory, *args) on each side; returns (ref, port)."""
    out = []
    for S in SIDES:
        reset_ledgers()
        S.tick = 0
        d = tmp_path / ("port" if S.port else "ref")
        d.mkdir()
        out.append(fn(S, d, *args))
    return out


def pk(p):
    return (p.topic, bytes(p.payload), p.qos, p.packet_id)


def drain(mgr, s, ack=False):
    out = []
    for _ in range(50):
        got = mgr.pump(s)
        if not got:
            break
        out.extend(got)
        if ack:
            for p in got:
                if p.packet_id is not None:
                    s.on_puback(p.packet_id)
    return [pk(p) for p in out]


def committed(s):
    return sorted((sid, st.committed.hex(), st.inflight_pos.hex() if st.inflight_pos else None)
                  for sid, st in s._streams.items())


# --- the persist gate -----------------------------------------------------------------


def gate_run(S, d, path):
    b, mgr, db = S.durable(d, n_shards=4)
    q1 = S.SubOpts(qos=1)
    dur = S.Cfg(session_expiry_interval=3600)
    sinks = {}
    dropped = []
    b.hooks.add("message.dropped", lambda m, *r: dropped.append((m.topic, r)))

    def sess(cid, cfg=None):
        s, _ = b.open_session(cid, True, cfg)
        sinks[cid] = []
        s.outgoing_sink = sinks[cid].extend
        return s

    for i in range(4):
        b.subscribe(sess(f"d{i}", dur), f"fleet/{i}/+/state", q1)
    b.subscribe(b.sessions["d0"], "$share/g/fleet/+/+/alarm", q1)
    b.subscribe(sess("live", None), "fleet/1/#", q1)
    for i in (2, 3):
        b.sessions[f"d{i}"].on_disconnect()
    msgs = [S.msg(t, payload=b"p%d" % k, qos=1, from_client=f"pub{k % 5}",
                      id=f"m{k}", timestamp=1.7e9 + k)
            for k, t in enumerate(
                [f"fleet/{k % 5}/{k % 3}/state" for k in range(20)]
                + [f"fleet/{k}/0/alarm" for k in range(3)] + ["other/x", "fleet/9/1/state"])]
    if path == "publish":
        counts = sum(b.publish(m) for m in msgs)
    elif path == "publish_batch":
        counts = sum(b.publish_batch(msgs))
    else:
        async def run():
            eng = b.enable_dispatch_engine(queue_depth=len(msgs), queue_max_depth=2 * len(msgs))
            out = await eng.submit_many(msgs)
            await eng.stop()
            return out
        counts = asyncio.run(run())
    stored_before = sum(len(q) for q in db.buffer._pending.values())
    db.buffer.flush_now()
    for i in (2, 3):
        s, present = b.open_session(f"d{i}", False, dur)
        assert present
        sinks[f"d{i}"].extend(s.on_reconnect())
    m = b.metrics
    return {
        "counts": counts,
        "stored": stored_before,
        "metrics": {k: m.val(k) for k in ("messages.received", "messages.delivered",
                                           "messages.dropped",
                                           "messages.dropped.no_subscribers")},
        "dropped": dropped,
        "deliveries": {c: sorted(pk(p)[:3] for p in v) for c, v in sinks.items()},
        "persist": [mgr.needs_persist(t) for t in ("fleet/0/1/state", "fleet/0/1/alarm",
                                                    "other/x")],
        "report": mgr.recovery_report(),
    }


@pytest.mark.parametrize("path", ["publish", "publish_batch", "engine"])
def test_persist_gate_on_every_publish_path(path, tmp_path):
    """Only topics with a ps-route are stored; a durable-only audience
    is not a drop (fleet/{2,3}/... with its subscribers offline) while
    fleet/4/..., other/x and fleet/9/... (no subscriber at all) are;
    the port's path (publish, publish_batch or the dispatch engine)
    against the reference's Broker.publish."""
    ref = gate_run(SIDES[0], tmp_path / "ref", "publish")
    port = gate_run(SIDES[1], tmp_path / "port", path)
    assert port == ref
    assert port["metrics"]["messages.dropped.no_subscribers"] == 6
    assert port["persist"] == [True, False, False]
    assert port["stored"] == 16  # fleet/{0..3}/*/state
    assert port["deliveries"]["d2"] and port["deliveries"]["d3"]


# --- durable sessions -----------------------------------------------------------------


def sc_offline_replay(S, d):
    db = S.db(d)
    mgr = S.D.DurableSessionManager(db, state_dir=str(d))
    s, _ = mgr.open_session("d1", True, S.Cfg(session_expiry_interval=300))
    mgr.subscribe(s, "keep/#", S.SubOpts(qos=1))
    s.on_disconnect()
    db.store_batch([S.msg("keep/a", payload=b"m%d" % i, qos=1, from_client="p",
                              timestamp=1.7e9 + i) for i in range(5)])
    s2, present = mgr.open_session("d1", False)
    return present, s2 is s, drain(mgr, s2), committed(s2)


def sc_skip_history(S, d):
    db = S.db(d)
    mgr = S.D.DurableSessionManager(db, state_dir=str(d))
    db.store_batch([S.msg("h/t", payload=b"old", from_client="p")])
    s, _ = mgr.open_session("d1", True)
    mgr.subscribe(s, "h/#", S.SubOpts(qos=0))
    first = drain(mgr, s)
    db.store_batch([S.msg("h/t", payload=b"new", from_client="p")])
    return first, drain(mgr, s), committed(s)


def sc_commit_on_ack(S, d):
    db = S.db(d)
    mgr = S.D.DurableSessionManager(db, state_dir=str(d))
    s, _ = mgr.open_session("d1", True)
    mgr.subscribe(s, "q/#", S.SubOpts(qos=2))
    db.store_batch([S.msg("q/t", payload=b"a", qos=1, from_client="p"),
                    S.msg("q/t", payload=b"b", qos=2, from_client="p")])
    got = drain(mgr, s)
    trace = [got, committed(s), drain(mgr, s)]
    s.on_puback(got[0][3])
    trace.append(committed(s))
    s.on_pubrec(got[1][3])
    s.on_pubcomp(got[1][3])
    trace.append(committed(s))
    db.store_batch([S.msg("q/t", payload=b"c", qos=1, from_client="p")])
    trace.append(drain(mgr, s))
    return trace


def sc_replay_after_kill(S, d):
    db = S.db(d, n_shards=1)
    mgr = S.D.DurableSessionManager(db, state_dir=str(d))
    s, _ = mgr.open_session("d1", True, S.Cfg(session_expiry_interval=300))
    mgr.subscribe(s, "r/#", S.SubOpts(qos=1))
    db.store_batch([S.msg("r/t", payload=b"x%d" % i, qos=1, from_client="p")
                    for i in range(3)])
    first = drain(mgr, s)
    s.on_puback(first[0][3])  # one of three acked: the batch stays open
    mgr.kill()
    db.kill()
    db2 = S.db(d, n_shards=1)
    mgr2 = S.D.DurableSessionManager(db2, state_dir=str(d))
    s2, present = mgr2.open_session("d1", False)
    report = db2.recovery_report()
    report.pop("open_ms")
    return first, present, committed(s2), drain(mgr2, s2), mgr2.recovery_report(), report


def sc_restart_keeps_subs(S, d):
    db = S.db(d, n_shards=1)
    mgr = S.D.DurableSessionManager(db, state_dir=str(d))
    s, _ = mgr.open_session("d1", True, S.Cfg(session_expiry_interval=300))
    mgr.subscribe(s, "keep/#", S.SubOpts(qos=1))
    mgr.subscribe(s, "also/+/x", S.SubOpts(qos=0))
    mgr.close()
    mgr2 = S.D.DurableSessionManager(db, state_dir=str(d))
    s2, present = mgr2.open_session("d1", False)
    return (mgr2.needs_persist("keep/x"), mgr2.needs_persist("also/1/x"),
            mgr2.needs_persist("nope"), present, sorted(s2.subscriptions),
            mgr2.recovery_report())


def sc_clean_start(S, d):
    db = S.db(d)
    mgr = S.D.DurableSessionManager(db, state_dir=str(d))
    s, _ = mgr.open_session("d1", True)
    mgr.subscribe(s, "a/#", S.SubOpts(qos=0))
    s2, present = mgr.open_session("d1", True)
    docs = [(k, {f: v for f, v in json.loads(v).items() if f != "created_at"})
            for k, v in mgr.kv.scan()]
    return present, dict(s2.subscriptions), mgr.needs_persist("a/x"), docs


def sc_gc(S, d):
    db = S.db(d)
    mgr = S.D.DurableSessionManager(db, state_dir=str(d))
    s, _ = mgr.open_session("d1", True, S.Cfg(session_expiry_interval=0.01))
    mgr.subscribe(s, "g/#", S.SubOpts(qos=0))
    k, _ = mgr.open_session("d2", True, S.Cfg(session_expiry_interval=300))
    mgr.subscribe(k, "g/#", S.SubOpts(qos=0))
    s.on_disconnect()
    k.on_disconnect()
    time.sleep(0.05)
    return mgr.gc(), sorted(mgr.sessions), mgr.needs_persist("g/x"), mgr.recovery_report()


def sc_takeover_no_leak(S, d):
    b, mgr, db = S.durable(d)
    live, _ = b.open_session("c1", True, S.Cfg())
    b.subscribe(live, "t/1", S.SubOpts(qos=0))
    before = sorted(map(str, b.router.match_routes("t/1")))
    dur, present = b.open_session("c1", True, S.Cfg(session_expiry_interval=300))
    b.subscribe(dur, "t/1", S.SubOpts(qos=1))
    return (before, present, type(dur).__name__, sorted(map(str, b.router.match_routes("t/1"))),
            mgr.needs_persist("t/1"), b.publish(S.msg("t/1", payload=b"x")),
            b.metrics.val("messages.dropped.no_subscribers"))


def sc_shared_cleanup(S, d):
    b, mgr, db = S.durable(d)
    s, _ = b.open_session("c1", True, S.Cfg(session_expiry_interval=300))
    b.subscribe(s, "$share/g/jobs", S.SubOpts(qos=0))
    trace = [sorted(map(str, b.router.match_routes("jobs"))), mgr.needs_persist("jobs")]
    trace.append(b.unsubscribe(s, "$share/g/jobs"))
    trace.append(sorted(map(str, b.router.match_routes("jobs"))))
    b.subscribe(s, "$share/g/jobs", S.SubOpts(qos=0))
    b.subscribe(s, "direct/#", S.SubOpts(qos=0))
    b.close_session(s, discard=True)
    trace += [sorted(map(str, b.router.match_routes("jobs"))), mgr.needs_persist("direct/x"),
              sorted(b.suboptions), sorted(b.sessions)]
    return trace


def sc_restart_drops_shared(S, d):
    """A fault of the reference that the port keeps: a session resumed
    from its document puts its $share filter into the ps-router as plain
    words and never back into the live router, so its group is left
    without it; and it keeps the document's config (receive_maximum
    back at the default), not the reconnecting client's."""
    b, mgr, db = S.durable(d, n_shards=1)
    cfg = S.Cfg(session_expiry_interval=300, receive_maximum=1000)
    s, _ = b.open_session("c1", True, cfg)
    b.subscribe(s, "$share/g/jobs", S.SubOpts(qos=1))
    b.subscribe(s, "dur/#", S.SubOpts(qos=1))
    before = sorted(map(str, b.router.match_routes("jobs")))
    mgr.kill()
    db.kill()
    b2, mgr2, _db2 = S.durable(d, n_shards=1)
    s2, present = b2.open_session("c1", False, cfg)
    return (before, present, sorted(s2.subscriptions),
            sorted(map(str, b2.router.match_routes("jobs"))),
            b2.publish(S.msg("jobs", payload=b"j", qos=1)), s2.cfg.receive_maximum,
            mgr2.needs_persist("dur/x"))


SESSION_SCENARIOS = {f.__name__[3:]: f for f in (
    sc_offline_replay, sc_skip_history, sc_commit_on_ack, sc_replay_after_kill,
    sc_restart_keeps_subs, sc_clean_start, sc_gc, sc_takeover_no_leak, sc_shared_cleanup,
    sc_restart_drops_shared)}


@pytest.mark.parametrize("name", sorted(SESSION_SCENARIOS))
def test_durable_session_scenario_equals_reference(name, tmp_path):
    ref, port = both(SESSION_SCENARIOS[name], tmp_path)
    assert port == ref
    if name == "offline_replay":
        assert [p[1] for p in port[2]] == [b"m%d" % i for i in range(5)]
    if name == "replay_after_kill":
        assert [p[1] for p in port[3]] == [b"x0", b"x1", b"x2"]  # at-least-once
    if name == "takeover_no_leak":
        assert port[3] == []
    if name == "restart_drops_shared":
        # pinned on both sides: the group had the session before the
        # restart and has nothing after it; the config is the default's
        assert port[0] and port[1] is True and "$share/g/jobs" in port[2]
        assert port[3] == [] and port[4] == 0 and port[5] == 32 and port[6] is True


# --- shared queues --------------------------------------------------------------------


def _member(b, cid):
    s, _ = b.open_session(cid, True)
    out = []
    s.outgoing_sink = out.extend
    return s, out


def _ack_all(b, s, out, start=0):
    for p in out[start:]:
        if p.packet_id is not None:
            s.on_puback(p.packet_id)
            b.hooks.run("message.acked", s.client_id, p.packet_id)


def _queues(S, d):
    b, mgr, db = S.durable(d, n_shards=1)
    sq = S.Q.SharedQueues(mgr, batch_size=4)
    sq.install(b.hooks)
    return b, mgr, db, sq


def sq_balance(S, d):
    b, mgr, db, sq = _queues(S, d)
    s1, out1 = _member(b, "m1")
    s2, out2 = _member(b, "m2")
    sq.join("g", "jobs/#", s1)
    sq.join("g", "jobs/#", s2)
    db.store_batch([S.msg("jobs/task", payload=str(i).encode(), qos=1,
                              from_client="p") for i in range(8)])
    q = sq.queues["g/jobs/#"]
    sq.pump(q)
    trace = [[pk(p) for p in out1], [pk(p) for p in out2]]
    n1, n2 = len(out1), len(out2)
    _ack_all(b, s1, out1)
    _ack_all(b, s2, out2)
    _ack_all(b, s1, out1, n1)
    _ack_all(b, s2, out2, n2)
    return trace + [[pk(p) for p in out1], [pk(p) for p in out2], sq.list()]


def sq_member_down(S, d):
    b, mgr, db, sq = _queues(S, d)
    s1, out1 = _member(b, "m1")
    s2, out2 = _member(b, "m2")
    sq.join("g", "w/#", s1)
    sq.join("g", "w/#", s2)
    for i in range(4):
        db.store_batch([S.msg(f"w/{i}", payload=b"x%d" % i, qos=1, from_client="p")])
    q = sq.queues["g/w/#"]
    sq.pump(q)
    s1.connected = False
    b.hooks.run("client.disconnected", "m1", "closed")
    _ack_all(b, s2, out2)
    st = sorted((k, v.committed.hex(), len(v.pending)) for k, v in q.streams.items())
    return [pk(p) for p in out1], [pk(p) for p in out2], q.redispatched, st


def sq_restart(S, d):
    b, mgr, db, sq = _queues(S, d)
    s1, out1 = _member(b, "m1")
    sq.join("g", "r/#", s1)
    db.store_batch([S.msg("r/1", payload=b"one", qos=1, from_client="p")])
    sq.pump(sq.queues["g/r/#"])
    _ack_all(b, s1, out1)
    mgr.close()
    db.close()
    b2, mgr2, db2, sq2 = _queues(S, d)
    s2, out2 = _member(b2, "m9")
    sq2.join("g", "r/#", s2)
    db2.store_batch([S.msg("r/2", payload=b"two", qos=1, from_client="p")])
    sq2.pump(sq2.queues["g/r/#"])
    return [pk(p) for p in out1], [pk(p) for p in out2], sorted(sq2.queues)


def sq_gate(S, d):
    b, mgr, db, sq = _queues(S, d)
    s1, out1 = _member(b, "m1")
    sq.join("grp", "tele/#", s1)
    n = b.publish(S.msg("tele/1", payload=b"v", qos=1, from_client="sensor"))
    db.buffer.flush_now()
    return n, [pk(p) for p in out1], b.metrics.val("messages.dropped.no_subscribers")


def sq_qos0(S, d):
    b, mgr, db, sq = _queues(S, d)
    s1, out1 = _member(b, "m1")
    sq.join("g", "mix/#", s1)
    db.store_batch([S.msg("mix/t", payload=b"q0", qos=0, from_client="p"),
                    S.msg("mix/t", payload=b"q1", qos=1, from_client="p")])
    q = sq.queues["g/mix/#"]
    sq.pump(q)
    _ack_all(b, s1, out1)
    sq.pump(q)
    return [pk(p) for p in out1], [(v.committed.hex(), len(v.pending))
                                   for v in q.streams.values()]


QUEUE_SCENARIOS = {f.__name__[3:]: f for f in (sq_balance, sq_member_down, sq_restart,
                                                 sq_gate, sq_qos0)}


@pytest.mark.parametrize("name", sorted(QUEUE_SCENARIOS))
def test_shared_queue_scenario_equals_reference(name, tmp_path):
    ref, port = both(QUEUE_SCENARIOS[name], tmp_path)
    assert port == ref
    if name == "balance":
        assert sorted(p[1] for p in port[2] + port[3]) == sorted(b"%d" % i for i in range(8))
    if name == "member_down":
        assert port[2] == len(port[0]) > 0
    if name == "restart":
        assert [p[1] for p in port[1]] == [b"two"]


# --- the persistent retainer ----------------------------------------------------------


def ret_msgs(S, n=40, seed=3, expiring=True):
    """n retained messages; with `expiring`, every ninth carries a 5 s
    message expiry from its 1.7e9 timestamp."""
    rng = np.random.default_rng(seed)
    return [S.msg(f"dev/{i % 5}/{i}/state", payload=b"r%d" % i,
                      qos=int(rng.integers(0, 3)), retain=True, from_client=f"c{i % 3}",
                      timestamp=1.7e9 + i,
                      props={"message_expiry_interval": 5} if expiring and i % 9 == 0 else {})
            for i in range(n)]


RET_FILTERS = ("dev/+/+/state", "dev/1/#", "dev/+/7/state", "dev/3/13/state", "#", "nope/+")


def ret_answers(r, now):
    return [sorted((m.topic, m.payload, m.qos) for m in r.read(f, now=now))
            for f in RET_FILTERS]


def rt_survival(S, d):
    p = d / "retained.kv"
    r = S.retainer(p)
    for m in ret_msgs(S):
        r.retain(m)
    r.retain(S.msg("dev/0/5/state", payload=b"", retain=True))  # a delete
    r.close()
    r2 = S.retainer(p)
    return len(r2), ret_answers(r2, 1.7e9 + 1)


def rt_expiry_on_reload(S, d):
    p = d / "retained.kv"
    r = S.retainer(p)
    for m in ret_msgs(S):
        r.retain(m)
    r.close()
    r2 = S.retainer(p)  # reload now: the 5 s expiries are long past
    n = len(r2)
    r2.close()
    r3 = S.retainer(p)
    return n, len(r3), ret_answers(r3, time.time())


def rt_clean(S, d):
    p = d / "retained.kv"
    r = S.retainer(p)
    for m in ret_msgs(S):
        r.retain(m)
    n = r.clean(now=1.7e9 + 100)
    r.close()
    r2 = S.retainer(p)
    return n, len(r2), ret_answers(r2, 1.7e9 + 100)


def rt_torn_record(S, d):
    """A corrupt value (a record whose term does not decode) is skipped
    at reload; the rest load."""
    p = d / "retained.kv"
    r = S.retainer(p)
    for m in ret_msgs(S, 10):
        r.retain(m)
    r._kv.put(b"dev/9/9/state", b"\x99not a term")
    r.close()
    r2 = S.retainer(p)
    return len(r2), ret_answers(r2, 1.7e9 + 1)


RET_SCENARIOS = {f.__name__[3:]: f for f in (rt_survival, rt_expiry_on_reload, rt_clean,
                                               rt_torn_record)}


@pytest.mark.parametrize("name", sorted(RET_SCENARIOS))
def test_persistent_retainer_scenario_equals_reference(name, tmp_path):
    ref, port = both(RET_SCENARIOS[name], tmp_path)
    assert port == ref


@pytest.mark.parametrize("order", ["reload_then_device", "device_then_reload"])
def test_reopened_retainer_reads_through_the_device_index(order, tmp_path):
    """A reopened PersistentRetainer(device="cpu") serves its reloaded
    names through the retained device index (K8's plain version here),
    whichever of reload and enable_device comes first; every answer
    equals the reference's host read of its own reopened store."""
    S = SIDES[1]
    p = tmp_path / "port.kv"
    r = S.retainer(p)
    for m in ret_msgs(S, 200, expiring=False):
        r.retain(m)
    r.close()
    if order == "reload_then_device":
        r2 = TR.PersistentRetainer(str(p), device="cpu")
        r2.enable_device()
    else:
        r2 = TR.PersistentRetainer(str(p), device="cpu", load=False)
        r2.enable_device()
        assert len(r2) == 0
        assert r2.reload() == 200
    assert len(r2) == len(r2._index) == 200
    names = []
    real = r2._index.read_finish

    def spy(ticket):
        out = real(ticket)
        names.append(out)
        return out

    r2._index.read_finish = spy
    begun = r2.retained_read_begin(list(RET_FILTERS), now=1.7e9 + 1)
    got = [sorted((m.topic, m.payload, m.qos) for m in ms)
           for ms in r2.retained_read_finish(begun)]
    assert names and all(n is not None for n in names[0])  # no escalation to the host walk
    ref = JR.PersistentRetainer(str(p))  # the reference opens the port's file
    assert got == ret_answers(ref, 1.7e9 + 1)
    assert got == ret_answers(r2, 1.7e9 + 1)


# --- cross-open in both directions ----------------------------------------------------


def write_tier(S, d, rng_seed=5):
    """A durable deployment in miniature: a Db of 4 shards, 12 durable
    sessions on fleet/{i % 4}/+/state (3 of them also on alarm/#), a
    persistent retainer; traffic while half are offline, partial acks,
    then a kill."""
    b, mgr, db = S.durable(d, n_shards=4)
    r = S.retainer(d / "retained.kv")
    b.retainer = r
    rng = np.random.default_rng(rng_seed)
    dur = S.Cfg(session_expiry_interval=3600)
    sess = []
    for i in range(12):
        s, _ = b.open_session(f"d{i}", True, dur)
        b.subscribe(s, f"fleet/{i % 4}/+/state", S.SubOpts(qos=1))
        if i % 4 == 0:
            b.subscribe(s, "alarm/#", S.SubOpts(qos=1))
        sess.append(s)
    for s in sess[::2]:
        s.on_disconnect()
    for w in range(3):
        msgs = [S.msg((f"fleet/{int(t) % 4}/{int(t)}/state" if k % 5 else
                                 f"alarm/{int(t)}"),
                          payload=b"w%dk%d" % (w, k), qos=1, retain=k % 7 == 0,
                          from_client=f"pub{int(rng.integers(0, 32))}",
                          timestamp=1.7e9 + w * 100 + k)
                for k, t in enumerate(rng.integers(0, 64, 40))]
        for m in msgs:
            b.publish(m)
        db.buffer.flush_now()
        for s in sess[1::2]:
            got = mgr.pump(s)
            for p in got[:-1]:  # all but the last of the batch: it stays open
                s.on_puback(p.packet_id)
    mgr.kill()
    db.kill()
    r._kv.kill()


def open_tier(S, d):
    """Reopen a deployment's directory: resume every session, pump, and
    read the retained store; returns what a client would see."""
    b, mgr, db = S.durable(d, n_shards=4)
    r = S.retainer(d / "retained.kv")
    trace = {"positions": {}, "delivered": {}}
    report = db.recovery_report()
    report.pop("open_ms")
    trace["report"] = (report, mgr.recovery_report())
    for cid in sorted(mgr.sessions):
        trace["positions"][cid] = committed(mgr.sessions[cid])
    for cid in sorted(mgr.sessions):
        s, present = b.open_session(cid, False, S.Cfg(session_expiry_interval=3600))
        assert present
        got = [pk(p) for p in s.on_reconnect()]
        trace["delivered"][cid] = got + drain(mgr, s, ack=True)
    trace["retained"] = ret_answers(r, 1.7e9 + 1)
    return trace


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_cross_open_resumes_alike(direction, tmp_path):
    """A directory written by one package's Db, DurableSessionManager
    and PersistentRetainer, killed, is opened by the other: it resumes
    the same sessions at the same committed positions and delivers the
    same messages as the writer's own package does on a copy."""
    writer, reader = (SIDES[0], SIDES[1]) if direction == "ref_to_port" else (SIDES[1], SIDES[0])
    d = tmp_path / "w"
    d.mkdir()
    reset_ledgers()
    write_tier(writer, d)
    shutil.copytree(d, tmp_path / "same")
    shutil.copytree(d, tmp_path / "other")
    reset_ledgers()
    want = open_tier(writer, tmp_path / "same")
    reset_ledgers()
    got = open_tier(reader, tmp_path / "other")
    assert got == want
    assert sum(len(v) for v in got["delivered"].values()) > 0
    assert any(p for p in got["positions"].values())


# --- the disk seam under a broker -----------------------------------------------------


def disk_leg(S, d):
    """A sticky fsync fault on shard 2 while a live subscriber and the
    durable ones are served: shard 2 fail-stops, its reads still serve,
    the others keep writing, live deliveries never see it; heal and
    recover."""
    b, mgr, db = S.durable(d, n_shards=4)
    live, _ = b.open_session("live", True)
    out = []
    live.outgoing_sink = out.extend
    b.subscribe(live, "fleet/#", S.SubOpts(qos=0))
    s, _ = b.open_session("d0", True, S.Cfg(session_expiry_interval=3600))
    b.subscribe(s, "fleet/+/+/state", S.SubOpts(qos=1))
    pubs = [f"pub{k}" for k in range(16)]
    shard_of = [db.storage.shard_of(S.msg("x", payload=b"", from_client=p))
                for p in pubs]
    pre = [S.msg(f"fleet/{k}/0/state", payload=b"pre%d" % k, qos=1,
                     from_client=pubs[k], timestamp=1.7e9 + k) for k in range(16)]
    for m in pre:
        b.publish(m)
    db.buffer.flush_now()
    pre_got = drain(mgr, s, ack=True)
    inj = S.F.DiskFaultInjector(seed=9).install()
    trace = [shard_of, len(pre_got)]
    try:
        inj.fail_sticky("fsync", paths=["shard_2"])
        for w in range(2):
            for k in range(16):
                b.publish(S.msg(f"fleet/{k}/{w + 1}/state", payload=b"w%dk%d" % (w, k),
                                    qos=1, from_client=pubs[k], timestamp=1.7e9 + 50 + w * 16 + k))
            try:
                db.buffer.flush_now()
                trace.append("ok")
            except Exception as exc:
                trace.append(type(exc).__name__)
            trace.append(db.failed_shards())
        shard2_reads = sorted(m.payload for st in db.get_streams("fleet/+/+/state")
                              if st.shard == 2
                              for m in db.next(db.make_iterator(st, "fleet/+/+/state"), 1000)[1])
        trace.append(shard2_reads)
        trace.append(drain(mgr, s, ack=True))
        trace.append(inj.status())
        inj.heal()
        trace.append(db.recover_shard(2))
        trace.append(db.failed_shards())
    finally:
        inj.heal()
        inj.uninstall()
    snap = dict(S.DM.DS_METRICS.snapshot())
    snap.pop("recovery_last_ms")
    scrape = [ln for ln in prometheus_text(b).splitlines() if ln.startswith("emqx_ds_")
              and not ln.startswith("emqx_ds_recovery_last_ms")] if S.port else None
    return trace, sorted(pk(p)[:3] for p in out), snap, dict(S.DM.DS_METRICS.injected), scrape


def test_disk_fault_fail_stops_one_shard_not_the_broker(tmp_path):
    ref, port = both(disk_leg, tmp_path)
    assert port[:4] == ref[:4]
    trace, live, snap = port[0], port[1], port[2]
    assert trace[3] == [2] and trace[-1] == [] and trace[-2] is True
    assert len(live) == 16 * 3  # every live delivery, fault or not
    assert snap["shard_failures_total"] == 1 and snap["shard_recoveries_total"] == 1
    lines = port[4]
    assert "emqx_ds_shard_failures_total{node=\"emqx@127.0.0.1\"} 1" in lines
    # fail_sticky("fsync") with no legs fails every leg on shard 2's
    # file: its first op, a WAL append, is the one injected
    assert 'emqx_ds_fault_injected_total{node="emqx@127.0.0.1",leg="append"} 1' in lines


# --- end to end through the Server ----------------------------------------------------


async def _client(addr, S, cid, clean_start=True, expiry=None):
    reader, writer = await asyncio.open_connection(*addr)
    parser = S.FR.Parser(proto_ver=5)
    got = []

    def send(pkt):
        writer.write(S.FR.serialize(pkt, 5))

    async def recv(n):
        while len(got) < n:
            data = await asyncio.wait_for(reader.read(65536), 30.0)
            assert data, "server closed the connection"
            got.extend(parser.feed(data))
        out = got[:n]
        del got[:n]
        return out

    props = {"session_expiry_interval": expiry} if expiry else {}
    send(S.P.Connect(proto_ver=5, client_id=cid, keepalive=0, clean_start=clean_start,
                     props=props))
    (ack,) = await recv(1)
    return send, recv, writer, ack


async def _server(S, d):
    db = S.A.Db("messages", data_dir=str(d), n_shards=2, buffer_flush_ms=5)
    mgr = S.D.DurableSessionManager(db, state_dir=str(d))
    b = S.broker()
    b.enable_durable(mgr)
    srv = S.SV.Server(b, host="127.0.0.1", port=0)
    await srv.start()
    return b, mgr, db, srv


async def _e2e(S, d, threads):
    """Offline delivery, a live delivery pumped from the DS flush thread
    onto the server's loop, then a broker restart over the same data
    directory."""
    b, mgr, db, srv = await _server(S, d)
    addr = srv.listen_addr
    trace = []
    ssend, srecv, sw, ack = await _client(addr, S, "dur1", expiry=300)
    ssend(S.P.Subscribe(1, [("iot/#", S.SubOpts(qos=1))]))
    await srecv(1)
    trace.append(b.sessions["dur1"].event_loop is asyncio.get_running_loop()
                 if S.port else True)
    psend, precv, pw, _ = await _client(addr, S, "pub")
    psend(S.P.Publish(topic="iot/live", payload=b"now", qos=1, packet_id=1))
    await precv(1)
    (m,) = await srecv(1)  # pumped by the flush thread, written on the loop
    trace.append((m.topic, m.payload, m.qos))
    ssend(S.P.Puback(type=S.P.Type.PUBACK, packet_id=m.packet_id))
    sw.close()
    await asyncio.sleep(0.05)
    psend(S.P.Publish(topic="iot/x", payload=b"while-away", qos=1, packet_id=2))
    await precv(1)
    await asyncio.sleep(0.1)  # the DS buffer's flush
    ssend, srecv, sw, ack = await _client(addr, S, "dur1", clean_start=False, expiry=300)
    (m,) = await srecv(1)
    trace.append((ack.session_present, m.topic, m.payload, m.qos))
    sw.close()
    await asyncio.sleep(0.05)
    psend(S.P.Publish(topic="iot/y", payload=b"precrash", qos=1, packet_id=3))
    await precv(1)
    await asyncio.sleep(0.1)
    pw.close()
    await srv.stop()
    mgr.close()
    db.close()
    b2, mgr2, db2, srv2 = await _server(S, d)
    ssend, srecv, sw, ack = await _client(srv2.listen_addr, S, "dur1", clean_start=False,
                                          expiry=300)
    got = await srecv(2)  # the unacked while-away and the pre-crash
    trace.append((ack.session_present, sorted((p.topic, p.payload) for p in got)))
    sw.close()
    await srv2.stop()
    mgr2.close()
    db2.close()
    return trace


def test_server_offline_delivery_and_restart_equal_reference(tmp_path, monkeypatch):
    threads = []
    real = TSV.Connection._send_packets

    def record(self, pkts):
        threads.append(threading.get_ident())
        return real(self, pkts)

    monkeypatch.setattr(TSV.Connection, "_send_packets", record)
    ref, port = both(lambda S, d: asyncio.run(_e2e(S, d, threads)), tmp_path)
    assert port == ref
    assert port[0] is True and port[1] == ("iot/live", b"now", 1)
    assert port[2] == (True, "iot/x", b"while-away", 1)
    assert port[3][0] is True and (("iot/y", b"precrash") in port[3][1])
    # every port write ran on the event loop's thread (the test's main
    # thread), never on the DS flush thread
    assert threads and set(threads) == {threading.get_ident()}


# --- chip_smoke.py phase 13 at a small size -------------------------------------------

P13_SMALL = {"routes": 1024, "live": 80, "wide": 16, "durable": 32, "filters": 24,
             "shared": 8, "windows": 3, "window": 256, "offline": 1, "fault_windows": 1,
             "ret": 1024, "ret_wave": 128, "ret_waves": 1, "level_d": 2}


def test_phase13_paths_equal_the_oracle_on_the_cpu(tmp_path):
    """Phase 13's steps (windows with half the sessions offline, the
    kill, the reopen with its retained reads, the disk fault on shard 2)
    through publish_batch and the dispatch engine with retained reads
    through the device index, against Broker.publish with host reads:
    every state the phase compares is equal."""
    card, card_stats = cs.durable_run("cpu", lambda w: "engine" if w % 2 == 0 else "batch",
                                      str(tmp_path / "card"), 3, P13_SMALL, True)
    oracle, _ = cs.durable_run("cpu", lambda w: "single", str(tmp_path / "oracle"), 3,
                               P13_SMALL, False)
    assert cs.jsonable(card) == cs.jsonable(oracle)
    legs = [x for x in card["fault"] if isinstance(x[0], tuple)]
    assert legs and all(failed == (2,) for failed, _grew in legs)
    assert card["fault"][-1] == ("recovered", True, ())
    assert all(n == want for n, want in card_stats["audience"])
    assert {k.split("|")[0] for k in cs.jsonable(card["deliveries"])} == {"a", "c", "d"}
    # 24 filters pass the LTS's threshold of 20 words: sessions read the
    # learned '+' streams and commit positions in them
    assert min(card["wild"]) > 0
    assert [x for x in card["fault"] if isinstance(x, str)] == ["ShardFailedError"]
