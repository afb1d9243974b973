"""The port's SUBSCRIBE-side retained reads and its MQTT server held
against emqx_tpu on the same seeded inputs: K8's plain version against
the JAX `_probe_kernel` (exact), the port's RetainedIndex against
the JAX one across churn waves (name
lists, escalation positions and telemetry counters), every escalation
path of the exactness contract on the port, the port's Channel and
Server against the JAX ones packet by packet, and the port's
no-fallback device rules.
"""

import asyncio
import dataclasses
import random
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emqx_tpu.broker import channel as JC
from emqx_tpu.broker import frame as JF
from emqx_tpu.broker import message as JM
from emqx_tpu.broker import packet as JP
from emqx_tpu.broker import pubsub as JB
from emqx_tpu.broker import server as JSV
from emqx_tpu.models import retainer as JR
from emqx_tpu.obs import kernel_telemetry as JK
from emqx_tpu.ops import retained as JRI
from emqx_tpu_torch import convert
from emqx_tpu_torch import device as device_mod
from emqx_tpu_torch.broker import channel as TC
from emqx_tpu_torch.broker import frame as TF
from emqx_tpu_torch.broker import message as TM
from emqx_tpu_torch.broker import packet as TP
from emqx_tpu_torch.broker import pubsub as TB
from emqx_tpu_torch.broker import server as TSV
from emqx_tpu_torch.models import retainer as TR
from emqx_tpu_torch.obs import kernel_telemetry as TK
from emqx_tpu_torch.ops import _build
from emqx_tpu_torch.ops import hash_index as TH
from emqx_tpu_torch.ops import retained as TRI
from emqx_tpu_torch.ops import topic as topic_mod

CPU = torch.device("cpu")

# the reference's own filter set (tests/test_retained_device.py)
FILTERS = [
    "#", "+", "+/#", "a/#", "a/+", "a/+/c", "a/b/c", "a/b/#", "+/b/+",
    "$sys/#", "$sys/+", "zz/none/#", "+/+/+/+",
]
_WORDS = ["a", "b", "c", "d", "$sys", "x", "yy", ""]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tier-1 runs test files side by side in worker processes; keep
    torch's CPU ops to one core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_names(rng, n):
    out = set()
    while len(out) < n:
        depth = rng.randint(1, 4)
        out.add("/".join(rng.choice(_WORDS) for _ in range(depth)))
    return sorted(out)


def _norm(res):
    return None if res is None else sorted(res)


# --- K8: the plain version against the JAX kernel ---------------------------------


def _jax_index(seed, n_names=300):
    """A JAX RetainedIndex over seeded names, every FILTERS class built."""
    ret = JR.Retainer()
    idx = ret.enable_device()
    for name in _rand_names(random.Random(seed), n_names):
        ret.retain(JM.Message(topic=name, payload=b"v"))
    idx.read_finish(idx.read_begin(FILTERS))
    return idx


def _both(slots, qh1, qfp, qvalid):
    """K8's plain version and the JAX kernel on the same numpy inputs."""
    st = convert.retained_state_from_numpy(slots.probe, slots.fp, slots.bucket, device="cpu")
    got = TRI.probe_retained(
        *st,
        torch.from_numpy(qh1.view(np.int32)).view(torch.uint32),
        torch.from_numpy(qfp.view(np.int32)).view(torch.uint32),
        torch.from_numpy(qvalid),
    )
    want = JRI._probe_kernel(
        jnp.asarray(slots.probe), jnp.asarray(slots.fp), jnp.asarray(slots.bucket),
        jnp.asarray(qh1), jnp.asarray(qfp), jnp.asarray(qvalid),
    )
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    return (got[0].numpy(), got[1].numpy()), (np.asarray(want[0]), np.asarray(want[1]))


def _crafted(idx, rng):
    """A copy of the index's table with hand-made lanes: a key stored
    twice (two verified lanes) and a key whose probe byte fills two
    more lanes under other fingerprints (more than two byte matches).
    Returns (slots, [(h1, fp, case)])."""
    s = idx._slots
    slots = TH.SlotArrays(s.fp.copy(), s.bucket.copy(), s.probe.copy())
    nb = slots.probe.shape[0]
    mask = nb - 1
    live = [b for b in range(len(idx._bid_key)) if idx._bid_key[b] is not None]
    rng.shuffle(live)
    cases = []

    def seat(bkt, lane, fp, bid):
        slots.fp[bkt * 4 + lane] = fp
        slots.bucket[bkt * 4 + lane] = bid

    # two verified lanes: the same fp again in the key's other bucket
    b = live[0]
    h1, fp = idx._bid_h1[b], idx._bid_fp[b]
    b1 = h1 & mask
    b2 = TH._alt_bucket(b1, fp, mask)
    seat(b2, 3, fp, live[1])
    seat(b1, 3, fp, b)
    cases.append((h1, fp, "two_verified"))
    # three byte matches: two more lanes share the probe byte
    b = live[2]
    h1, fp = idx._bid_h1[b], idx._bid_fp[b]
    b1 = h1 & mask
    b2 = TH._alt_bucket(b1, fp, mask)
    seat(b1, 2, fp ^ 0x10, live[3])
    seat(b2, 2, fp ^ 0x20, live[4])
    seat(b2, 1, fp ^ 0x40, live[5])
    cases.append((h1, fp, "three_bytes"))
    TH._pack_probe(slots)
    return slots, cases


def _queries(idx, rng, extra=()):
    live = [b for b in range(len(idx._bid_key)) if idx._bid_key[b] is not None]
    qs = [(idx._bid_h1[b], idx._bid_fp[b], "hit") for b in live]
    qs += [(rng.getrandbits(32), rng.getrandbits(32), "miss") for _ in range(len(live))]
    for b in live:
        fp = idx._bid_fp[b]
        if fp >> 24 >= 2:
            # right probe byte and bucket pair, wrong full fingerprint
            qs.append((idx._bid_h1[b], fp ^ 1, "collision"))
    qs += list(extra)
    return qs


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("b", TRI.BATCH_LADDER)
def test_probe_retained_equals_reference(seed, b):
    rng = random.Random(seed * 10 + b)
    idx = _jax_index(seed)
    crafted, cases = _crafted(idx, rng)
    for slots, extra in ((idx._slots, ()), (crafted, cases)):
        qs = _queries(idx, rng, extra)
        rng.shuffle(qs)
        kinds = Counter()
        for base in range(0, max(len(qs), 1), b):
            chunk = qs[base:base + b]
            qh1 = np.array([rng.getrandbits(32) for _ in range(b)], np.uint32)
            qfp = np.array([rng.getrandbits(32) for _ in range(b)], np.uint32)
            qvalid = np.zeros(b, bool)
            for j, (h1, fp, kind) in enumerate(chunk):
                qh1[j], qfp[j] = h1, fp
                # every fifth lane is padding over a real key
                qvalid[j] = j % 5 != 4
                kinds[kind if qvalid[j] else "padding"] += 1
            got, want = _both(slots, qh1, qfp, qvalid)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            assert not got[1][~qvalid].any() and (got[0][~qvalid] == -1).all()
        assert kinds["hit"] and kinds["miss"] and kinds["padding"]
        assert kinds["collision"]
    # the crafted lanes hit both amb rules
    for h1, fp, _kind in cases:
        q = np.zeros(8, np.uint32)
        qh1, qfp = q.copy(), q.copy()
        qh1[0], qfp[0] = h1, fp
        got, want = _both(crafted, qh1, qfp, np.eye(8, dtype=bool)[0])
        assert got[1][0] and want[1][0]


def _port_queries(slots, qh1, qfp, qvalid):
    st = convert.retained_state_from_numpy(slots.probe, slots.fp, slots.bucket, device="cpu")
    q = (torch.from_numpy(qh1.view(np.int32)).view(torch.uint32),
         torch.from_numpy(qfp.view(np.int32)).view(torch.uint32), torch.from_numpy(qvalid))
    return st, q


def test_probe_retained_writes_one_result_buffer():
    """Both outputs are views of one 5·B-byte buffer (`out` when given):
    the bucket ids' bytes, then the flags'; the values are the plain
    version's."""
    rng = random.Random(5)
    idx = _jax_index(0)
    qs = _queries(idx, rng)[:64]
    b = 64
    qh1 = np.array([q[0] for q in qs], np.uint32)
    qfp = np.array([q[1] for q in qs], np.uint32)
    qvalid = np.arange(b) % 5 != 4
    st, q = _port_queries(idx._slots, qh1, qfp, qvalid)
    want = TRI.probe_retained_ref(*st, *q)
    buf = torch.full((5 * b,), 7, dtype=torch.uint8)
    bid, amb = TRI.probe_retained(*st, *q, buf)
    assert bid.data_ptr() == buf.data_ptr() and amb.data_ptr() == buf.data_ptr() + 4 * b
    for got in ((bid, amb), TRI.result_views(buf), TRI.probe_retained(*st, *q)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    host = TRI.host_result(buf.numpy())
    assert np.array_equal(host[0], want[0].numpy()) and np.array_equal(host[1], want[1].numpy())


@pytest.mark.parametrize("b", (1, 9, 257) + TRI.BATCH_LADDER)
def test_stage_queries_one_buffer_equals_three_arrays(b):
    """One 9·B-byte host buffer, one copy: (qh1, qfp, qvalid) equal the
    three arrays, padding in the middle and at the tail (zeros), and K8
    reads them as it reads three separate tensors."""
    rng = np.random.default_rng(b)
    n = max(1, b - b // 4)
    h1 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    fp = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    valid = rng.random(n) < 0.8
    valid[n // 2] = False
    qh1, qfp, qvalid = TRI.stage_queries(h1, fp, valid, b, CPU)
    want = [np.zeros(b, np.uint32), np.zeros(b, np.uint32), np.zeros(b, bool)]
    for w, x in zip(want, (h1, fp, valid)):
        w[:n] = x
    assert (qh1.dtype, qfp.dtype, qvalid.dtype) == (torch.uint32, torch.uint32, torch.bool)
    assert qfp.data_ptr() == qh1.data_ptr() + 4 * b
    assert qvalid.data_ptr() == qh1.data_ptr() + 8 * b
    assert np.array_equal(qh1.view(torch.int32).numpy().view(np.uint32), want[0])
    assert np.array_equal(qfp.view(torch.int32).numpy().view(np.uint32), want[1])
    assert np.array_equal(qvalid.numpy(), want[2])
    idx = _jax_index(1)
    st, q = _port_queries(idx._slots, *want)
    got = TRI.probe_retained(*st, qh1, qfp, qvalid)
    ref = TRI.probe_retained_ref(*st, *q)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def _chunk_outputs(jax_ticket, port_ticket):
    """Per chunk: (rung, the JAX (bid, amb), the port's), the port's
    through its one fetched buffer."""
    out = []
    assert len(jax_ticket.chunks) == len(port_ticket.chunks)
    for (fj, nj, mj), (ft, nt, mt) in zip(jax_ticket.chunks, port_ticket.chunks):
        assert nj == nt and [m[:4] for m in mj] == [m[:4] for m in mt]
        host = ft.wait()
        assert len(host) == 1  # one copy carried both outputs
        want = [np.asarray(x) for x in fj.wait()]
        out.append((host[0].shape[0] // 5, want, TRI.host_result(host[0]), nj))
    return out


@pytest.mark.parametrize("n", [1, 9, 65, 513, TRI.MAX_BATCH + 37])
def test_read_through_staging_equals_reference(n):
    """A wave of n filters (every rung, and a storm past the top rung)
    through the port's staging and one-buffer fetch: each chunk's rung,
    every query's bucket id and amb flag, and the answers equal the
    reference's read_begin/read_finish."""
    rng = random.Random(n)
    sides = [Side(True), Side(False)]
    for name in _rand_names(rng, 250):
        for s in sides:
            s.put(name)
    filters = [rng.choice(FILTERS + ["d/+/x", "x/#", "yy/+"]) for _ in range(n)]
    tt, tj = (s.idx.read_begin(filters) for s in sides)
    rungs = []
    for b, want, got, nv in _chunk_outputs(tj, tt):
        rungs.append(b)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        assert (got[0][nv:] == -1).all() and not got[1][nv:].any()
    n_dev = sum(p[0] == "dev" for p in tt.plans)
    assert n_dev > 0
    assert rungs == [next(r for r in TRI.BATCH_LADDER if min(n_dev - k, TRI.MAX_BATCH) <= r)
                     for k in range(0, n_dev, TRI.MAX_BATCH)]
    got, want = ([_norm(r) for r in s.idx.read_finish(t)] for s, t in zip(sides, (tt, tj)))
    assert got == want
    assert sides[0].counters() == sides[1].counters()


# phase 8's store and wave mix (chip_smoke.py) cut from 10,000 x 100
# names + 1,024 $SYS to 320 x 100 + 33, which keeps its slot load
# (~0.49 at full size, ~0.51 here)
PHASE8_CUT = (320, 100, 33)


def phase8_reads_equal(g, k, n_sys, waves):
    """Phase 8's names (`chip_smoke.retained_names(g, k, n_sys)`) in the
    reference's and the port's RetainedIndex, then `waves` waves of
    4,096 filters of phase 8's mix through both: every query's probe
    key, bucket id and amb flag, read for read, every answer and the
    slot arrays must be equal. Returns (reads, ambiguous reads, the
    distinct ambiguous filters, the port's slot load). At full size:
    `phase8_reads_equal(10_000, 100, 1024, 12)`."""
    import chip_smoke

    j, t = JRI.RetainedIndex(), TRI.RetainedIndex(device="cpu")
    for name in chip_smoke.retained_names(g, k, n_sys):
        j.add(name)
        t.add(name)
    rng = np.random.default_rng(2)
    reads, amb, amb_filters = 0, 0, set()
    for _ in range(waves):
        filters = [chip_smoke.ret_filter(c, rng, g, k)
                   for c in chip_smoke.draw_classes(chip_smoke.WAVE_MIX, TRI.MAX_BATCH, rng)]
        tj, tt = j.read_begin(filters), t.read_begin(filters)
        for (_b, want, got, nv), (_f, _n, metas) in zip(_chunk_outputs(tj, tt), tt.chunks):
            assert np.array_equal(got[0][:nv], want[0][:nv])
            assert np.array_equal(got[1][:nv], want[1][:nv])
            reads += nv
            amb += int(got[1][:nv].sum())
            amb_filters |= {filters[m[4]] for m, a in zip(metas, got[1]) if a}
        assert [_norm(r) for r in t.read_finish(tt)] == [_norm(r) for r in j.read_finish(tj)]
    assert np.array_equal(t._slots.fp, j._slots.fp)
    assert np.array_equal(t._slots.bucket, j._slots.bucket)
    return reads, amb, sorted(amb_filters), len(t._key_bid) / (TH.BUCKET_W * t._n_buckets)


def test_phase8_mix_amb_flags_equal_reference_read_for_read():
    """The K8 `amb` suspect (20 ambiguous probes in 46,984 wave reads on
    the card): phase 8's seeded names and filter mix through the
    reference's and the port's index agree read for read, so the port's
    rate is the reference's own."""
    reads, _amb, _filters, load = phase8_reads_equal(*PHASE8_CUT, waves=3)
    assert reads > 10_000
    assert 0.45 < load < 0.55




# --- RetainedIndex against the JAX one -----------------------------------------------


class Side:
    """One implementation's Retainer with the device leg on."""

    def __init__(self, port: bool, **kw):
        self.port = port
        self.Message = TM.Message if port else JM.Message
        self.tel = TK.KernelTelemetry() if port else JK.KernelTelemetry()
        self.ret = TR.Retainer(device="cpu") if port else JR.Retainer()
        self.idx = self.ret.enable_device(telemetry=self.tel, **kw)

    def put(self, name, payload=b"v"):
        self.ret.retain(self.Message(topic=name, payload=payload))

    def read(self, filters):
        return [_norm(r) for r in self.idx.read_finish(self.idx.read_begin(filters))]

    def counters(self):
        c = self.tel.counters
        return [c.get(k, 0) for k in ("retained_device_reads_total",
                                      "retained_host_fallback_total",
                                      "retained_index_builds_total")]


@pytest.mark.parametrize("seed", [1, 3])
def test_index_churn_equals_reference(seed):
    rng = random.Random(140 + seed)
    sides = [Side(True), Side(False)]
    live = []
    long_wave = [rng.choice(FILTERS + ["d/+/x", "x/#", "yy/+"])
                 for _ in range(TRI.MAX_BATCH + 37)]
    for wave in range(6):
        for name in _rand_names(rng, 40):
            if name not in live:
                live.append(name)
            for s in sides:
                s.put(name)
        rng.shuffle(live)
        for name in live[: len(live) // 3]:
            for s in sides:
                s.put(name, b"")
        del live[: len(live) // 3]
        waves = [FILTERS] + ([long_wave] if wave in (2, 5) else [])
        for filters in waves:
            got, want = (s.read(filters) for s in sides)
            assert got == want, wave
            oracle = [sorted(sides[0].ret._match_names(topic_mod.words(f)))
                      for f in filters]
            for g, o in zip(got, oracle):
                assert g is None or g == o
        assert sides[0].counters() == sides[1].counters()
    assert sides[0].counters()[0] > 0


def test_retainer_read_halves_equal_reference():
    sides = [Side(True), Side(False)]
    for s in sides:
        for t, p in (("a/b", b"1"), ("a/c", b"2"), ("x", b"3"), ("$sys/a", b"4")):
            s.put(t, p)
    wave = ["a/b", "a/+", "q/#", "#", "x", "+/a"]
    got, want = (
        [sorted((m.topic, m.payload) for m in ms)
         for ms in s.ret.retained_read_finish(s.ret.retained_read_begin(wave))]
        for s in sides
    )
    assert got == want
    assert got[0] == [("a/b", b"1")] and got[2] == []


def test_stale_ticket_escalates_to_host():
    s = Side(True)
    s.put("a/b")
    s.read(["a/#"])  # create the class
    t = s.idx.read_begin(["a/#"])
    s.put("a/c")  # mutate under it
    assert s.idx.read_finish(t) == [None]
    assert s.read(["a/#"]) == [["a/b", "a/c"]]
    assert s.counters()[1] == 1


def test_deep_names_force_host_plans():
    s = Side(True, max_levels=4)
    deep = "/".join("w" for _ in range(6))
    s.put(deep)
    s.put("a/b")
    assert s.read(["a/#", "#"]) == [None, None]
    assert sorted(m.topic for m in s.ret.read("#")) == sorted([deep, "a/b"])
    s.put(deep, b"")
    assert s.read(["a/#"]) == [["a/b"]]


def test_oov_literal_is_provably_empty_without_a_launch(monkeypatch):
    s = Side(True)
    s.put("a/b")
    s.read(["a/+"])  # the class exists
    calls = []
    real = TRI.probe_retained
    monkeypatch.setattr(TRI, "probe_retained", lambda *a: calls.append(1) or real(*a))
    assert s.read(["nope/+"]) == [[]]
    assert calls == []
    assert s.read(["a/+"]) == [["a/b"]] and calls == [1]


def test_class_budget_overflow_goes_to_host():
    sides = [Side(True, class_budget=2), Side(False, class_budget=2)]
    for s in sides:
        for n in ("a/b", "a/c", "b/c/d"):
            s.put(n)
    got, want = (s.read(["a/+", "+/c/d", "a/#", "+/+"]) for s in sides)
    assert got == want == [["a/b", "a/c"], ["b/c/d"], None, None]
    assert sides[0].counters()[:2] == [2, 2]


def test_forced_ambiguity_escalates_never_answers_wrong(monkeypatch):
    s = Side(True)
    for n in ("a/b", "a/c"):
        s.put(n)
    s.read(["a/+"])
    real = TRI.probe_retained

    def amb_kernel(*a):
        bid, amb = real(*a)
        amb.fill_(True)  # in place: the read fetches K8's one result buffer
        return bid, amb

    monkeypatch.setattr(TRI, "probe_retained", amb_kernel)
    assert s.read(["a/+"]) == [None]
    out = s.ret.retained_read_finish(s.ret.retained_read_begin(["a/+"]))
    assert sorted(m.topic for m in out[0]) == ["a/b", "a/c"]


def test_read_repair_purges_every_structure():
    sides = [Side(True), Side(False)]
    for s in sides:
        s.ret.retain(s.Message(topic="a/b", payload=b"v", timestamp=100.0,
                               props={"message_expiry_interval": 10}))
        s.put("a/c")
    for s in sides:
        out = s.ret.retained_read_finish(s.ret.retained_read_begin(["a/+"], now=200.0))
        assert [m.topic for m in out[0]] == ["a/c"]
        assert s.ret.expired_total == 1 and len(s.ret) == 1 and len(s.idx) == 1
        assert s.read(["a/#"]) == [["a/c"]]


def test_read_storms_add_no_shape_keys_after_warmup():
    rng = random.Random(9)
    s = Side(True)
    for name in _rand_names(rng, 200):
        s.put(name)
    # enable_device launched the ladder at attach
    assert len(s.tel._shape_keys[TRI._KERNEL]) == len(TRI.BATCH_LADDER)
    s.read(FILTERS)  # every class the storm uses, then the ladder
    keys = set(s.tel._shape_keys[TRI._KERNEL])
    assert {(b, s.idx._n_buckets) for b in TRI.BATCH_LADDER} <= keys
    builds = s.tel.counters.get("recompiles_total", 0)
    for _ in range(4):
        s.read([rng.choice(FILTERS) for _ in range(700)])  # > a rung
    assert s.tel._shape_keys[TRI._KERNEL] == keys
    assert s.tel.counters.get("recompiles_total", 0) == builds


# --- the Channel against the JAX Channel ----------------------------------------------


def _pkt(p):
    """A packet as comparable plain data (enums as ints)."""
    def conv(v):
        if isinstance(v, dict):
            return tuple(sorted((k, conv(x)) for k, x in v.items()))
        if isinstance(v, (list, tuple)):
            return tuple(conv(x) for x in v)
        if isinstance(v, int):
            return int(v)
        return v
    return (type(p).__name__, conv(dataclasses.asdict(p)))


def _split(out):
    """Outgoing packets of one step: the leading non-PUBLISH packets as
    they are, the PUBLISHes after a SUBACK as a multiset without their
    packet ids, and those ids sorted."""
    head, pubs, pids = [], Counter(), []
    seen_suback = False
    for p in out:
        if type(p).__name__ == "Suback":
            seen_suback = True
        if seen_suback and type(p).__name__ == "Publish":
            d = dict(_pkt(p)[1])
            pids.append(d.pop("packet_id"))
            pubs[tuple(sorted(d.items()))] += 1
        else:
            head.append(_pkt(p))
    return head, pubs, sorted(pids, key=lambda x: -1 if x is None else x)


class ChanSide:
    """One implementation's broker (retained leg on) and its Channels."""

    def __init__(self, port: bool):
        self.P = TP if port else JP
        self.Message = TM.Message if port else JM.Message
        self.b = TB.Broker(device="cpu") if port else JB.Broker()
        self.b.caps.exclusive_subscription = True
        self.tel = TK.KernelTelemetry() if port else JK.KernelTelemetry()
        self.b.retainer.enable_device(telemetry=self.tel)
        self.Channel = TC.Channel if port else JC.Channel
        self.chans = {}
        self.sink = {}

    def step(self, cid, build):
        ch = self.chans.get(cid)
        if ch is None:
            ch = self.chans[cid] = self.Channel(self.b, peer=f"{cid}:1")
        pkt = build(self.P)
        out = ch.handle_packet(pkt)
        if ch.session is not None and ch.session.outgoing_sink is None:
            box = self.sink.setdefault(cid, [])
            ch.session.outgoing_sink = box.extend
        return out

    def close(self, cid):
        self.chans.pop(cid).on_close()

    def inflight(self, cid):
        s = self.chans[cid].session
        return sorted((pid, e.phase) for pid, e in s.inflight.items())


def _connect(cid, ver=4, clean=True, will=None, **props):
    def build(P):
        w = None if will is None else P.Will(topic=will[0], payload=will[1],
                                             qos=will[2], retain=will[3])
        return P.Connect(proto_ver=ver, clean_start=clean, keepalive=0,
                         client_id=cid, will=w, props=dict(props))
    return build


def _sub(pid, *filters):
    def build(P):
        return P.Subscribe(pid, [(f, P.SubOpts(qos=q, retain_handling=rh))
                                 for f, q, rh in filters])
    return build


def _pub(topic, payload, qos=0, retain=False, pid=None):
    return lambda P: P.Publish(topic=topic, payload=payload, qos=qos,
                               retain=retain, packet_id=pid)


def _ack(kind, pid):
    return lambda P: P.Puback(getattr(P.Type, kind), pid)


def test_channel_equals_reference():
    sides = [ChanSide(True), ChanSide(False)]

    def run(cid, build):
        got, want = (_split(s.step(cid, build)) for s in sides)
        assert got == want, (cid, got, want)
        return got

    def ack_all(cid):
        """The client side of every outbound QoS 1/2 flow in flight."""
        pids = [s.inflight(cid) for s in sides]
        assert pids[0] == pids[1]
        for pid, phase in pids[0]:
            if phase == "puback":
                run(cid, _ack("PUBACK", pid))
            else:
                run(cid, _ack("PUBREC", pid))  # -> PUBREL
                run(cid, _ack("PUBCOMP", pid))
        assert sides[0].inflight(cid) == []

    run("pub", _connect("pub", ver=5))
    names = [f"a/{i}/c" for i in range(6)] + ["a/x", "a/b/d", "x/y/z", "$sys/up", "b/b/b"]
    for i, n in enumerate(names):
        q = i % 3
        run("pub", _pub(n, f"v{i}".encode(), qos=q, retain=True,
                        pid=None if q == 0 else 100 + i))
        if q == 2:
            run("pub", _ack("PUBREL", 100 + i))
    # v3.1.1 client with a will; multi-filter SUBSCRIBE: wildcard, exact,
    # shared, $exclusive, invalid, retain_handling 0/1/2
    run("c1", _connect("c1", ver=4, will=("will/c1", b"bye", 1, True)))
    got = run("c1", _sub(1, ("a/+/c", 1, 0), ("a/#", 0, 0), ("+/b/+", 2, 0),
                         ("$share/g/a/#", 1, 0), ("$exclusive/x/#", 1, 0),
                         ("bad/#/x", 0, 0), ("a/x", 1, 0), ("+/+/+", 0, 2),
                         ("$sys/#", 0, 1), ("x/+/z", 2, 0)))
    assert sum(got[1].values()) > 10
    assert any(dict(k)["qos"] == 2 for k in got[1])
    ack_all("c1")
    # single filter (the B=1 path), then retain_handling 1 on it again
    run("c1", _sub(2, ("x/#", 1, 0)))
    run("c1", _sub(3, ("x/#", 1, 1)))
    ack_all("c1")
    # a v5 client with a persistent session and its own will
    run("c2", _connect("c2", ver=5, clean=False,
                       will=("will/c2", b"gone", 0, False),
                       session_expiry_interval=60))
    run("c2", _sub(1, ("will/#", 1, 0), ("a/#", 1, 0)))
    ack_all("c2")
    # retained set, replace and delete; a QoS 2 flow; then re-reads
    run("pub", _pub("a/new", b"n", qos=1, retain=True, pid=7))
    run("pub", _pub("a/1/c", b"replaced", qos=0, retain=True))
    run("pub", _pub("a/2/c", b"", qos=0, retain=True))
    run("pub", _pub("a/q2", b"two", qos=2, pid=9))
    run("pub", _ack("PUBREL", 9))
    run("c1", _sub(4, ("a/+/c", 0, 0), ("a/+", 1, 0), ("#", 0, 0)))
    ack_all("c1")
    ack_all("c2")
    run("c1", lambda P: P.Unsubscribe(5, ["a/#", "nope/#"]))
    run("c1", lambda P: P.Pingreq())
    # c2 drops (session kept), c1's socket dies (will fires), c2 resumes
    for s in sides:
        s.close("c2")
        s.close("c1")
    head = run("c2", _connect("c2", ver=5, clean=False, session_expiry_interval=60))[0]
    assert head[0][0] == "Connack" and dict(head[0][1])["session_present"]
    # c1's will was queued for the offline session
    assert [dict(p[1])["topic"] for p in head[1:]] == ["will/c1"]
    ack_all("c2")
    # a clean DISCONNECT discards the will
    run("c3", _connect("c3", ver=5, will=("will/c3", b"never", 0, False)))
    run("c3", lambda P: P.Disconnect(0))
    for s in sides:
        s.close("c3")
    wills = run("c2", _sub(2, ("will/#", 0, 0)))[1]
    assert [dict(k)["topic"] for k in wills] == ["will/c1"]
    got, want = ({c: [_pkt(p) for p in box] for c, box in s.sink.items()} for s in sides)
    assert got == want
    assert got["c2"] and not any(dict(p[1])["topic"] == "will/c3" for p in got["c2"])
    assert sides[0].b.metrics.all() == sides[1].b.metrics.all()
    # the same reads took the device leg (one batch per multi-filter
    # SUBSCRIBE, B=1 for a single filter) on both sides
    counters = [Side.counters(s) for s in sides]
    assert counters[0] == counters[1] and counters[0][0] > 10
    assert all(s.session.dropped == 0 for s in sides[0].chans.values())


# --- the Server end to end ------------------------------------------------------------


async def _client(addr, frame_mod, P, ver, cid):
    reader, writer = await asyncio.open_connection(*addr)
    parser = frame_mod.Parser(proto_ver=ver)
    got = []

    def send(pkt):
        writer.write(frame_mod.serialize(pkt, ver))

    async def recv(n):
        while len(got) < n:
            data = await asyncio.wait_for(reader.read(65536), 30.0)
            assert data, "server closed the connection"
            got.extend(parser.feed(data))
        out = got[:n]
        del got[:n]
        return out

    send(P.Connect(proto_ver=ver, client_id=cid, keepalive=0))
    await recv(1)
    return send, recv, writer


async def _server_script(port: bool):
    """Retained reads on SUBSCRIBE (multi-filter and single-filter), a
    publish/deliver round trip; returns what the subscriber received."""
    frame_mod = TF if port else JF
    P = TP if port else JP
    if port:
        broker = TB.Broker(device="cpu")
        broker.retainer.enable_device()
        srv = TSV.Server(broker, host="127.0.0.1", port=0)
    else:
        broker = JB.Broker()
        broker.retainer.enable_device()
        srv = JSV.Server(broker, host="127.0.0.1", port=0)
    await srv.start()
    assert broker.servers == [srv]
    addr = srv.listen_addr
    seen = []
    try:
        psend, precv, pw = await _client(addr, frame_mod, P, 4, "pub")
        for i in range(12):
            q = i % 2
            psend(P.Publish(topic=f"dev/{i % 3}/{i}/state", payload=b"s%d" % i,
                            qos=q, retain=True, packet_id=i + 1 if q else None))
        await precv(6)  # the PUBACKs
        ssend, srecv, sw = await _client(addr, frame_mod, P, 5, "sub")
        ssend(P.Subscribe(1, [("dev/0/+/state", P.SubOpts(qos=1)),
                              ("dev/+/5/state", P.SubOpts(qos=0)),
                              ("dev/1/#", P.SubOpts(qos=1))]))
        seen.append(await srecv(1 + 4 + 1 + 4))
        ssend(P.Subscribe(2, [("dev/+/+/state", P.SubOpts(qos=0))]))
        seen.append(await srecv(1 + 12))
        psend(P.Publish(topic="dev/2/99/state", payload=b"live", qos=0))
        seen.append(await srecv(1))  # via dev/+/+/state only
        for w in (pw, sw):
            w.close()
    finally:
        await srv.stop()
    assert broker.servers == []
    return seen


def test_server_end_to_end_equals_reference():
    got = asyncio.run(_server_script(True))
    want = asyncio.run(_server_script(False))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert _split(g) == _split(w)
    suback, pubs, _pids = _split(got[0])
    assert suback[0][0] == "Suback" and dict(suback[0][1])["codes"] == (1, 0, 1)
    assert sum(pubs.values()) == 9
    assert all(dict(k)["retain"] for k in pubs)


def test_server_main_serves_on_the_cpu_when_asked():
    """`python -m emqx_tpu_torch.broker.server --device cpu` serves a
    retained read to a raw-socket client."""
    import os
    import socket
    import subprocess
    import sys
    import time

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "emqx_tpu_torch.broker.server", "--host", "127.0.0.1",
         "--port", str(port), "--device", "cpu"],
        cwd=repo, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
    )
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                sock = socket.create_connection(("127.0.0.1", port), timeout=5)
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read().decode()
                assert time.monotonic() < deadline, "the server never listened"
                time.sleep(0.2)
        with sock:
            sock.settimeout(30)
            parser = TF.Parser(proto_ver=4)

            def send(pkt):
                sock.sendall(TF.serialize(pkt, 4))

            def recv(n):
                got = []
                while len(got) < n:
                    data = sock.recv(65536)
                    assert data, "the server closed the connection"
                    got.extend(parser.feed(data))
                return got

            send(TP.Connect(proto_ver=4, client_id="cli", keepalive=0))
            assert isinstance(recv(1)[0], TP.Connack)
            for t in ("s/1/v", "s/2/v"):
                send(TP.Publish(topic=t, payload=b"x", retain=True))
            send(TP.Subscribe(1, [("s/+/v", TP.SubOpts()), ("s/#", TP.SubOpts())]))
            got = recv(5)
            assert isinstance(got[0], TP.Suback) and got[0].codes == [0, 0]
            assert sorted(p.topic for p in got[1:]) == ["s/1/v", "s/1/v", "s/2/v", "s/2/v"]
    finally:
        proc.terminate()
        proc.wait(timeout=30)


# --- the device rules ---------------------------------------------------------------


def test_cuda_default_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(device_mod.NoCudaDevice):
        TR.Retainer().enable_device()
    with pytest.raises(device_mod.NoCudaDevice):
        TRI.RetainedIndex()
    with pytest.raises(device_mod.NoCudaDevice):
        TSV.Server()
    with pytest.raises(device_mod.NoCudaDevice):
        TSV.main(["--port", "0"])
    assert TRI.RetainedIndex(device="cpu").device == CPU
    # the broker decides the retained index's device with the router's
    assert TB.Broker(device="cpu").retainer.enable_device().device == CPU


def test_failed_k8_build_raises_without_plain_fallback(monkeypatch, tmp_path):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 1\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    # meta tensors stand in for CUDA ones, with a stand-in stream
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda _d=None: type("S", (), {"cuda_stream": 0})(),
    )
    k = _build.KERNELS["retained_probe"]
    monkeypatch.setattr(k, "_fn", None)

    def _never(*_a, **_k):
        raise AssertionError("plain version ran in place of the kernel")

    monkeypatch.setattr(TRI, "probe_retained_ref", _never)
    meta = torch.device("meta")

    def z(n, dtype=torch.uint32):
        return torch.zeros(n, dtype=dtype, device=meta)

    with pytest.raises(_build.KernelBuildError, match="no sm_90a"):
        TRI.probe_retained(z(16), z(64), z(64, torch.int32), z(8), z(8),
                           z(8, torch.bool))
    assert k.launches == 0
