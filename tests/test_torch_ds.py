"""The port's durable storage tiers (emqx_tpu_torch/ds/) held against
the reference's (emqx_tpu/ds/) on the CPU, on the same inputs made from
a seed with numpy:

  * the WAL: one put/delete sequence gives byte-identical files from the
    reference's engines and the port's PyKv and NativeKv (the port's
    own native/kvlog.cc, built by g++ at first use);
  * WAL damage and upgrades (torn tails, a bit flip the CRC catches, a
    garbage length header, v1 files, the four compaction crash points)
    replay alike, with the same `emqx_ds_*` counters;
  * the LTS's static keys, filter matches and dump/load;
  * storage streams, iterator positions as bytes, replayed messages;
    Db store, poll and generations;
  * one seeded DiskFaultInjector program fail-stops the same shards on
    both sides and leaves equal ledgers;
  * a failed native build raises NativeBuildError and never selects the
    Python twin.

Each comparison resets both process-global DS_METRICS ledgers first."""

import os
import shutil
import struct
import zlib

import numpy as np
import pytest

from emqx_tpu.broker import message as JM
from emqx_tpu.chaos import faults as JF
from emqx_tpu.cluster import wire as JW
from emqx_tpu.ds import api as JA
from emqx_tpu.ds import kvstore as JK
from emqx_tpu.ds import lts as JL
from emqx_tpu.ds import metrics as JDM
from emqx_tpu.ds import storage as JS
from emqx_tpu_torch import native
from emqx_tpu_torch.broker import message as TM
from emqx_tpu_torch.chaos import faults as TF
from emqx_tpu_torch.cluster import wire as TW
from emqx_tpu_torch.ds import api as TA
from emqx_tpu_torch.ds import kvstore as TK
from emqx_tpu_torch.ds import lts as TL
from emqx_tpu_torch.ds import metrics as TDM
from emqx_tpu_torch.ds import storage as TS

assert JK._LIB is not None, "the reference's native engine is not loadable"

SIDES = ("ref", "port")
MODS = {
    "ref": dict(M=JM, F=JF, A=JA, K=JK, L=JL, DM=JDM, S=JS),
    "port": dict(M=TM, F=TF, A=TA, K=TK, L=TL, DM=TDM, S=TS),
}
ENGINES = ("py", "native")


def reset_ledgers():
    for m in (JDM.DS_METRICS, TDM.DS_METRICS):
        with m._lock:
            for k in m.counters:
                m.counters[k] = 0
            for k in m.gauges:
                m.gauges[k] = 0.0
            m.injected.clear()


def ledger(side):
    m = MODS[side]["DM"].DS_METRICS
    return m.snapshot(), dict(m.injected), m.prometheus_lines()


def kv_class(side, engine):
    K = MODS[side]["K"]
    return K.PyKv if engine == "py" else K.NativeKv


def kv_ops(seed, n=160):
    rng = np.random.default_rng(seed)
    keys = [b"k%03d" % i for i in range(32)] + [b"", b"\xff\x00bin", b"meta/lts"]
    ops = []
    for _ in range(n):
        k = keys[int(rng.integers(len(keys)))]
        if rng.random() < 0.25:
            ops.append(("del", k, None))
        else:
            ops.append(("put", k, rng.integers(0, 256, int(rng.integers(0, 300)),
                                               dtype=np.uint8).tobytes()))
    # a last record with a long value, for the bit flip to land in
    ops.append(("put", b"tail", bytes(range(64))))
    return ops


def apply_ops(kv, ops):
    for op, k, v in ops:
        if op == "put":
            kv.put(k, v)
        else:
            kv.delete(k)


def read(path):
    with open(path, "rb") as f:
        return f.read()


def kv_state(kv):
    return (list(kv.scan()), kv.count(), kv.wal_records(), kv.torn_records,
            kv.crc_failures)


# --- the WAL ----------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wal_bytes_identical_across_packages_and_engines(seed, tmp_path):
    """The same put/delete sequence gives the same WAL bytes from the
    reference's PyKv and NativeKv and the port's PyKv and NativeKv, the
    same table, and again after a compaction."""
    ops = kv_ops(seed)
    blobs, states, compacted = {}, {}, {}
    for side in SIDES:
        for engine in ENGINES:
            p = str(tmp_path / f"{side}_{engine}.kv")
            kv = kv_class(side, engine)(p)
            apply_ops(kv, ops)
            kv.flush()
            states[side, engine] = kv_state(kv)
            blobs[side, engine] = read(p)
            kv.compact()
            kv.close()
            compacted[side, engine] = read(p)
    want = blobs["ref", "py"]
    assert want.startswith(b"EKVWAL2\n") and TK.WAL_MAGIC == JK.WAL_MAGIC
    for key in blobs:
        assert blobs[key] == want, key
        assert states[key] == states["ref", "py"], key
        assert compacted[key] == compacted["ref", "py"], key


def _v2_record(key, val, vlen=None):
    vlen = len(val) if vlen is None else vlen
    crc = zlib.crc32(struct.pack("<II", len(key), vlen) + key + val)
    return struct.pack("<III", crc, len(key), vlen) + key + val


def _v1_file(ops):
    out = bytearray()
    for op, k, v in ops:
        if op == "put":
            out += struct.pack("<II", len(k), len(v)) + k + v
        else:
            out += struct.pack("<II", len(k), 0xFFFFFFFF) + k
    return bytes(out)


def damaged_wal(kind, tmp_path):
    """The bytes of a damaged or legacy WAL file: a clean v2 file from
    seed 3's ops, then the damage."""
    ops = kv_ops(3, 60)
    p = str(tmp_path / "base.kv")
    kv = TK.PyKv(p)
    apply_ops(kv, ops)
    kv.close()
    base = read(p)
    if kind == "torn_tail":
        return base + b"\x7f" * 7
    if kind == "short_header":
        return base + b"\x01\x02\x03\x04\x05"
    if kind == "bit_flip_last":
        b = bytearray(base)
        b[-5] ^= 0xFF
        return bytes(b)
    if kind == "bit_flip_middle":
        b = bytearray(base)
        b[len(b) // 2] ^= 0x5A
        return bytes(b) + _v2_record(b"after", b"never")
    if kind == "garbage_length":
        return base + struct.pack("<III", 0x12345678, 0xFFFFFF00, 5) + b"abc"
    if kind == "v1":
        return _v1_file(ops)
    if kind == "v1_torn":
        return _v1_file(ops) + b"\x03\x00\x00"
    raise ValueError(kind)


DAMAGE = ("torn_tail", "short_header", "bit_flip_last", "bit_flip_middle",
          "garbage_length", "v1", "v1_torn")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kind", DAMAGE)
def test_wal_damage_replays_alike(kind, engine, tmp_path):
    """A damaged or legacy file opens to the same table, counters, file
    bytes and DS_METRICS on both sides (and on the port's other engine);
    a reopen after the repair replays cleanly."""
    blob = damaged_wal(kind, tmp_path)
    got = {}
    for side in SIDES:
        reset_ledgers()
        p = str(tmp_path / f"{side}.kv")
        with open(p, "wb") as f:
            f.write(blob)
        kv = kv_class(side, engine)(p)
        state = kv_state(kv)
        kv.close()
        kv2 = kv_class(side, engine)(p)
        got[side] = (state, read(p), ledger(side), kv_state(kv2))
        kv2.close()
    assert got["port"] == got["ref"]
    state, after, (snap, _inj, _lines), reopened = got["port"]
    if kind.startswith("v1"):
        assert snap["wal_upgraded_files_total"] == 1 and after.startswith(TK.WAL_MAGIC)
    if kind in ("torn_tail", "short_header", "garbage_length", "v1_torn"):
        assert state[3] == 1 and snap["wal_torn_records_total"] == 1
    if kind.startswith("bit_flip"):
        assert state[4] == 1 and snap["wal_crc_failures_total"] == 1
    assert reopened[3:] == (0, 0)
    # the port's other engine agrees with its own
    other = "native" if engine == "py" else "py"
    p = str(tmp_path / "other.kv")
    with open(p, "wb") as f:
        f.write(blob)
    kv = kv_class("port", other)(p)
    assert kv_state(kv) == state
    kv.close()


@pytest.mark.parametrize("point", JF.CRASH_POINTS)
def test_compaction_crash_point_recovers_alike(point, tmp_path):
    """Each compaction crash point, armed by each package's own
    injector on its own PyKv, leaves the same on-disk state; reopening
    it with either engine of either side gives the same table and
    counters."""
    assert TF.CRASH_POINTS == JF.CRASH_POINTS
    ops = kv_ops(4, 80)
    files = {}
    for side in SIDES:
        reset_ledgers()
        m = MODS[side]
        d = tmp_path / side
        d.mkdir()
        p = str(d / "t.kv")
        kv = m["K"].PyKv(p)
        apply_ops(kv, ops)
        kv.flush()
        inj = m["F"].DiskFaultInjector(seed=7).install()
        try:
            inj.crash_at(point, paths=("t.kv",))
            with pytest.raises(m["F"].SimulatedCrash):
                kv.compact()
        finally:
            inj.heal()
            inj.uninstall()
        files[side] = (read(p), os.path.exists(p + ".compact"),
                       read(p + ".compact") if os.path.exists(p + ".compact") else b"",
                       ledger(side)[1], inj.status())
    assert files["port"] == files["ref"]
    reopened = {}
    for side in SIDES:
        for engine in ENGINES:
            reset_ledgers()
            d = tmp_path / f"{side}_{engine}"
            shutil.copytree(tmp_path / side, d)
            kv = kv_class(side, engine)(str(d / "t.kv"))
            reopened[side, engine] = (kv_state(kv), os.path.exists(str(d / "t.kv.compact")),
                                      ledger(side)[0])
            kv.compact()
            assert kv.wal_records() == kv.count()
            kv.close()
    for engine in ENGINES:
        assert reopened["port", engine] == reopened["ref", engine], engine
        # the engines agree on the table; the native one counts live keys
        # as its replayed records, on both sides
        assert reopened["port", engine][0] == reopened["ref", "py"][0], engine
    assert not reopened["port", "py"][1]


def test_live_torn_write_seam_alike(tmp_path):
    """The live torn-write seam: an append lands a prefix and 'the
    process dies'; the reopen truncates the partial record, on both
    sides with the same counters."""
    got = {}
    for side in SIDES:
        reset_ledgers()
        m = MODS[side]
        p = str(tmp_path / f"{side}.kv")
        kv = m["K"].PyKv(p)
        kv.put(b"committed", b"yes")
        kv.flush()
        inj = m["F"].DiskFaultInjector(seed=1).install()
        try:
            inj.torn_write(5, paths=(f"{side}.kv",))
            with pytest.raises(m["F"].SimulatedCrash):
                kv.put(b"torn", b"never-acked")
        finally:
            inj.heal()
            inj.uninstall()
        kv.kill()
        kv2 = m["K"].NativeKv(p)
        got[side] = (kv_state(kv2), read(p), ledger(side))
        kv2.close()
    assert got["port"] == got["ref"]
    assert got["port"][0][3] == 1


# --- the LTS ----------------------------------------------------------------------


def lts_topics(seed, n=600):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = rng.random()
        if k < 0.5:
            out.append(f"sensor/{int(rng.integers(0, 80))}/temp")
        elif k < 0.8:
            out.append(f"fleet/{int(rng.integers(0, 40))}/{int(rng.integers(0, 9))}/state")
        else:
            out.append("/".join(f"w{int(x)}" for x in rng.integers(0, 6, int(rng.integers(1, 5)))))
    return out


LTS_FILTERS = ("sensor/+/temp", "sensor/#", "fleet/3/+/state", "fleet/+/+/state", "#",
               "+/+", "w1/#", "sensor/7/temp", "nothing/here", "fleet/+/2/#")


@pytest.mark.parametrize("threshold", [2, 5, 20])
def test_lts_static_keys_matches_and_dump_equal(threshold):
    tries = {s: MODS[s]["L"].LtsTrie(threshold=threshold) for s in SIDES}
    for t in lts_topics(threshold):
        words = t.split("/")
        keys = {s: tries[s].topic_key(words) for s in SIDES}
        assert keys["port"] == keys["ref"], t
    for flt in LTS_FILTERS:
        fw = flt.split("/")
        assert tries["port"].match_filter(fw) == tries["ref"].match_filter(fw), flt
    dump = tries["ref"].dump()
    assert tries["port"].dump() == dump
    loaded = TL.LtsTrie.load(dump)
    assert loaded.dump() == dump and JL.LtsTrie.load(tries["port"].dump()).dump() == dump
    for flt in LTS_FILTERS:
        fw = flt.split("/")
        assert loaded.match_filter(fw) == tries["ref"].match_filter(fw)
    for vary, cons in ((["a", "b"], ["+", "b"]), (["a"], ["a", "+"]), (["x"], ["y"]), ([], [])):
        assert TL.varying_match(vary, cons) == JL.varying_match(vary, cons)


# --- storage, Db --------------------------------------------------------------------


def messages(side, seed, n=300, t0=1.7e9):
    """n seeded messages of one package's Message class, with seconds
    apart timestamps so key order is arrival order."""
    M = MODS[side]["M"].Message
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = lts_topics(seed * 1000 + i, 1)[0]
        out.append(M(topic=t, payload=rng.integers(0, 256, int(rng.integers(0, 40)),
                                                   dtype=np.uint8).tobytes(),
                     qos=int(rng.integers(0, 3)), retain=bool(rng.random() < 0.1),
                     from_client=f"pub{int(rng.integers(0, 64))}", id=f"m{seed}_{i}",
                     timestamp=t0 + i * 0.001, props={"k": i} if i % 7 == 0 else {}))
    return out


def msg_tuple(m):
    return (m.topic, m.payload, m.qos, m.retain, m.from_client, m.id, m.timestamp,
            m.props)


def test_serialize_message_and_shard_of_equal(tmp_path):
    ref, port = messages("ref", 5, 64), messages("port", 5, 64)
    layers = {s: MODS[s]["S"].StorageLayer("m", str(tmp_path / s), n_shards=4)
              for s in SIDES}
    for a, b in zip(ref, port):
        blob = JS.serialize_message(a, ["v1", "v2"])
        assert TS.serialize_message(b, ["v1", "v2"]) == blob
        got, vary = TS.deserialize_message(blob)
        assert msg_tuple(got) == msg_tuple(a) and vary == ["v1", "v2"]
        assert layers["port"].shard_of(b) == layers["ref"].shard_of(a)
        assert layers["port"].shard_of(b) == zlib.crc32(b.from_client.encode()) % 4
    for s in SIDES:
        layers[s].close()


@pytest.mark.parametrize("engine", ENGINES)
def test_storage_streams_positions_and_replay_equal(engine, tmp_path):
    """Streams for a set of filters, every iterator position as bytes
    and every replayed message, page by page, across two generations;
    the shard files are byte-identical."""
    got = {}
    for side in SIDES:
        reset_ledgers()
        S = MODS[side]["S"]
        layer = S.StorageLayer("messages", str(tmp_path / side), n_shards=2,
                               lts_threshold=5, prefer_native=engine == "native")
        msgs = messages(side, 6)
        by = {}
        for m in msgs[:200]:
            by.setdefault(layer.shard_of(m), []).append(m)
        for sid, batch in sorted(by.items()):
            layer.shards[sid].store_batch(batch)
        gens = [sh.add_generation() for sh in layer.shards]
        for m in msgs[200:]:
            layer.shards[layer.shard_of(m)].store_batch([m])
        trace = [gens]
        for flt in LTS_FILTERS:
            for sid, sh in enumerate(layer.shards):
                streams = sh.get_streams(sid, flt)
                trace.append(("streams", flt, sid, streams and [
                    (st.shard, st.generation, st.static_key, st.constraints)
                    for st in streams]))
                for st in streams:
                    pos = b""
                    while True:
                        rows, pos2 = sh.scan_stream(st, flt, pos, 0, 7)
                        trace.append((pos2, [(k, msg_tuple(m)) for k, m in rows]))
                        if not rows:
                            break
                        pos = pos2
        dropped = layer.shards[0].drop_generation(0)
        trace.append(("dropped", dropped, layer.shards[0].generations))
        layer.close()
        got[side] = (trace, [read(str(tmp_path / side / "messages" / f"shard_{i}.kv"))
                             for i in range(2)], ledger(side))
    assert got["port"] == got["ref"]
    assert got["port"][0][-1][1] > 0


def test_db_store_poll_next_and_generations_equal(tmp_path):
    got = {}
    for side in SIDES:
        reset_ledgers()
        A = MODS[side]["A"]
        db = A.Db("messages", data_dir=str(tmp_path / side), n_shards=4,
                  buffer_flush_ms=3_600_000)
        polls = []
        db.poll(lambda: polls.append(1))
        msgs = messages(side, 8, 120)
        db.store_batch(msgs[:60])
        for m in msgs[60:]:
            db.store_async(m)
        db.buffer.flush_now()
        trace = [len(polls)]
        for flt in ("fleet/+/+/state", "sensor/#", "#"):
            for stream in db.get_streams(flt):
                it = db.make_iterator(stream, flt)
                while True:
                    it, page = db.next(it, batch_size=9)
                    trace.append((it.after_key, [msg_tuple(m) for m in page]))
                    if not page:
                        break
        db.add_generation()
        trace.append(db.generations())
        db.store_batch(msgs[:5])
        trace.append(db.drop_generation(0))
        trace.append(db.generations())
        report = db.recovery_report()
        report.pop("open_ms")
        trace.append(report)
        db.close()
        got[side] = (trace, ledger(side))
    assert got["port"] == got["ref"]


def test_db_kill_and_reopen_alike(tmp_path):
    """Flushed batches survive a kill; buffered ones are lost, on both
    sides; the reopen's recovery report is the same."""
    got = {}
    for side in SIDES:
        A = MODS[side]["A"]
        d = str(tmp_path / side)
        db = A.Db("messages", data_dir=d, n_shards=4, buffer_flush_ms=3_600_000)
        msgs = messages(side, 9, 80)
        db.store_batch(msgs[:40])
        for m in msgs[40:]:
            db.store_async(m)
        db.kill()
        reset_ledgers()
        db2 = A.Db("messages", data_dir=d, n_shards=4)
        report = db2.recovery_report()
        report.pop("open_ms")
        rows = []
        for stream in db2.get_streams("#"):
            _it, page = db2.next(db2.make_iterator(stream, "#"), batch_size=1000)
            rows.extend(msg_tuple(m) for m in page)
        db2.close()
        got[side] = (report, sorted(rows), ledger(side))
    assert got["port"] == got["ref"]
    assert len(got["port"][1]) == 40


def test_open_db_registry_alike(tmp_path):
    for side in SIDES:
        A = MODS[side]["A"]
        name = f"reg_{side}"
        db = A.open_db(name, data_dir=str(tmp_path / side), n_shards=2)
        assert A.open_db(name) is db
        A.close_db(name)
        db2 = A.open_db(name, data_dir=str(tmp_path / side), n_shards=2)
        assert db2 is not db
        A.kill_db(name)
        assert name not in A._DBS


def test_wire_codec_bytes_equal():
    rng = np.random.default_rng(11)
    terms = [None, True, False, 0, -1, 1 << 70, -(1 << 64), 1.5, "näme", b"\x00\xff",
             (1, "a", [2, b"b"]), {"topic": "a/b", "payload": b"x", "qos": 1,
                                   "props": {"k": [1, 2]}}, [], {}, ()]
    terms += [{"i": int(x), "f": float(x) / 7, "s": str(x)} for x in rng.integers(-9999, 9999, 20)]
    for t in terms:
        blob = JW.encode(t)
        assert TW.encode(t) == blob
        assert TW.decode(blob) == JW.decode(blob)
    for bad in (b"", b"s\x00\x00\x00\x09ab", b"Z", JW.encode([1, 2]) + b"x"):
        with pytest.raises(JW.WireError):
            JW.decode(bad)
        with pytest.raises(TW.WireError):
            TW.decode(bad)


def test_maybe_compact_equal(tmp_path):
    got = {}
    for side in SIDES:
        A = MODS[side]["A"]
        db = A.Db("messages", data_dir=str(tmp_path / side), n_shards=2)
        M = MODS[side]["M"].Message
        for i in range(300):
            db.store_batch([M(topic="hot/t", payload=b"%d" % i, from_client="p",
                              timestamp=1.7e9 + i)])
        first = db.maybe_compact(ratio=4.0, min_records=64)
        db.add_generation()
        db.drop_generation(0)
        second = db.maybe_compact(ratio=1.5, min_records=64)
        recs = [int(s.kv.wal_records()) for s in db.storage.shards]
        db.close()
        got[side] = (first, second, recs)
    assert got["port"] == got["ref"]
    assert got["port"][1]


# --- disk faults --------------------------------------------------------------------


def fault_program(side, kind, tmp_path, engine):
    """One seeded disk-fault program on one side's Db: arm the fault,
    store windows (catching each shard's fail-stop), heal, recover."""
    m = MODS[side]
    reset_ledgers()
    db = m["A"].Db("messages", data_dir=str(tmp_path / f"{side}_{kind}_{engine}"),
                   n_shards=4, buffer_flush_ms=3_600_000,
                   prefer_native=engine == "native")
    failed_seen = []
    db.storage.on_shard_failed = lambda sid, exc: failed_seen.append((sid, type(exc).__name__))
    inj = m["F"].DiskFaultInjector(seed=42).install()
    trace = []
    try:
        if kind == "sticky_fsync_shard2":
            inj.fail_sticky("fsync", paths=["shard_2"])
        elif kind == "transient_eio":
            inj.fail_transient(3, kind="eio", legs=["append"])
        elif kind == "random_enospc":
            inj.fail_random(0.2, kind="enospc", legs=["append", "fsync"])
        elif kind == "sticky_enospc_all":
            inj.fail_sticky("enospc", legs=["append"])
        msgs = messages(side, 12, 160)
        for w in range(8):
            for mm in msgs[w * 20:(w + 1) * 20]:
                db.store_async(mm)
            try:
                db.buffer.flush_now()
                trace.append((w, "ok"))
            except Exception as exc:
                trace.append((w, type(exc).__name__, str(exc).split(":")[0]))
            trace.append(tuple(db.failed_shards()))
        trace.append(("injector", inj.status()))
        inj.heal()
        trace.append(("recover", [db.recover_shard(s) for s in range(4)]))
        trace.append(tuple(db.failed_shards()))
        report = db.recovery_report()
        report.pop("open_ms")
        trace.append(report)
    finally:
        inj.heal()
        inj.uninstall()
        db.close()
    snap, injected, lines = ledger(side)
    snap.pop("recovery_last_ms")
    lines = [ln for ln in lines if not ln.startswith("emqx_ds_recovery_last_ms")]
    return trace, failed_seen, snap, injected, lines


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kind", ["sticky_fsync_shard2", "transient_eio", "random_enospc",
                                  "sticky_enospc_all"])
def test_disk_fault_program_fail_stops_alike(kind, engine, tmp_path):
    ref = fault_program("ref", kind, tmp_path, engine)
    port = fault_program("port", kind, tmp_path, engine)
    assert port == ref
    trace, failed_seen, snap = port[0], port[1], port[2]
    assert failed_seen and snap["shard_failures_total"] >= 1
    assert snap["shard_recoveries_total"] == snap["shard_failures_total"]
    if kind == "sticky_fsync_shard2":
        assert {sid for sid, _ in failed_seen} == {2}
    assert trace[-2] == ()


def test_disk_faults_are_not_device_faults():
    for exc in (TF.DiskFullError("x"), TF.DiskIOError("x"), TF.FsyncFailedError("x"),
                TF.SimulatedCrash("x"), TS.ShardFailedError("x")):
        assert not TF.is_device_fault(exc)
    assert TF.is_device_fault(TF.DeviceLostError("x"))
    assert TF.DISK_LEGS == JF.DISK_LEGS


# --- the native build -------------------------------------------------------------------


@pytest.fixture
def fresh_kv(monkeypatch, tmp_path):
    """An empty build directory and no engine loaded yet, for this test
    only."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(TK, "_LIB", None)
    return tmp_path


def test_failed_kv_build_raises_and_never_selects_pykv(fresh_kv, monkeypatch):
    monkeypatch.setattr(native, "CXX", str(fresh_kv / "no-such-g++"))
    p = str(fresh_kv / "t.kv")
    with pytest.raises(native.NativeBuildError):
        TK.open_kv(p)
    with pytest.raises(native.NativeBuildError):
        TK.NativeKv(p)
    with pytest.raises(native.NativeBuildError):
        TA.Db("messages", data_dir=str(fresh_kv / "d"), n_shards=2)
    kv = TK.open_kv(p, prefer_native=False)  # the caller's choice: the twin
    assert isinstance(kv, TK.PyKv)
    kv.close()


def test_failed_kv_compile_raises_with_the_compiler_log(fresh_kv, monkeypatch):
    src = fresh_kv / "src"
    src.mkdir()
    (src / "kvlog.cc").write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SRC", src)
    with pytest.raises(native.NativeBuildError, match="g\\+\\+ failed"):
        TK.open_kv(str(fresh_kv / "t.kv"))
    assert not list((fresh_kv / "build").glob("*.tmp"))


def test_kv_library_builds_without_python_header(fresh_kv, monkeypatch):
    """The engine is a plain C ABI library: it builds where Python.h is
    missing (an extension would not), keyed by its source's hash, and
    the reference's committed library is never loaded."""
    monkeypatch.setattr(native.sysconfig, "get_paths",
                        lambda *a, **k: {"include": str(fresh_kv)})
    kv = TK.open_kv(str(fresh_kv / "t.kv"))
    kv.put(b"a", b"1")
    kv.close()
    built = [p.name for p in (fresh_kv / "build").glob("*.so")]
    assert len(built) == 1 and built[0].startswith("libemqx_torch_kv-")
    assert str(native.library_path("libemqx_torch_kv")).startswith(str(native.BUILD_DIR))
    assert "libemqxkv" not in TK._lib()._name
