"""The port's single-device chaos engine held against the reference's on
the CPU: the fleet's filters and topics and the Zipf draws for one
seed; the corruption, takeover and crash-consistency scenarios at the
reference tests' small engine (tests/test_chaos.py), each under a live
storm with every contract holding; the soak row's shape (the
reference's keys, with torch/CUDA provenance in place of jax); the
mesh scenarios (chip loss, chip flap, reshard churn) on a (1, 8) CPU
mesh, on the port alone; and the cluster parts, which raise
NotImplementedError naming ROADMAP Queue 1 item 8b, while a mesh
scenario is skipped on an engine without a mesh. Deadlines are the
reference's, box-scaled; the tests hold the engine to its contracts,
not to timings."""

import contextlib
import json
import threading
import time

import pytest
import torch

from emqx_tpu.broker.pubsub import Broker as RBroker
from emqx_tpu.chaos import SessionFleet as RFleet
from emqx_tpu.chaos import ZipfTopics as RZipf
from emqx_tpu.chaos import run_soak as r_run_soak
from emqx_tpu_torch.broker.pubsub import Broker as TBroker
from emqx_tpu_torch.chaos import ChaosEngine, SessionFleet, ZipfTopics, run_soak
from emqx_tpu_torch.chaos import __main__ as chaos_main
from emqx_tpu_torch.parallel.mesh import make_mesh
from emqx_tpu_torch.chaos.scenarios import (
    CATALOG,
    BrokerRestart,
    ChipFlap,
    ChipLoss,
    DisconnectTakeover,
    DiskFull,
    FsyncFail,
    ReshardChurn,
    RowCorruption,
    SlotDecay,
    TornWal,
    scenario_catalog,
    scenarios_by_name,
)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_engine_kw():
    """tests/test_chaos.py's small engine."""
    return dict(
        groups=50,
        sample_n=1,
        storm_chunk=48,
        detect_rounds=6,
        detect_burst=16,
        chaos_filters=2,
        chaos_fan=4,
        settle_timeout=8.0,
    )


async def _engine(tmp_path, sessions):
    return await ChaosEngine.standalone(
        sessions=sessions, data_dir=str(tmp_path), device="cpu", **small_engine_kw())


@pytest.mark.parametrize("s,seed,victim", [(1.2, 7, False), (1.3, 3, False), (1.1, 5, True)])
def test_fleet_and_zipf_draws_equal_the_reference(s, seed, victim):
    rf = RFleet(RBroker(), "z", sessions=400, groups=37)
    tf = SessionFleet(TBroker(device="cpu"), "z", sessions=400, groups=37)
    assert (tf.groups, tf.fan()) == (rf.groups, rf.fan())
    assert [tf.filter_of(g) for g in range(37)] == [rf.filter_of(g) for g in range(37)]
    assert [tf.topic_of(g, f"x{g}") for g in range(37)] == \
        [rf.topic_of(g, f"x{g}") for g in range(37)]
    rv = RFleet(RBroker(), "v", sessions=50) if victim else None
    tv = SessionFleet(TBroker(device="cpu"), "v", sessions=50) if victim else None
    rz = RZipf(rf, s=s, seed=seed, victim=rv)
    tz = ZipfTopics(tf, s=s, seed=seed, victim=tv)
    for n in (1, 48, 256, 1000):
        assert tz.draw(n) == rz.draw(n)


async def test_row_corruption_chain_under_load(tmp_path):
    eng = await _engine(tmp_path, 250)
    try:
        await eng.setup()
        eng.storm_start()
        res = await RowCorruption(faults=1).run(eng)
        assert res.ok, json.dumps(res.as_dict(), indent=1)
        assert res.detect_ms is not None and res.recovery_ms is not None
        assert eng.faults_detected == eng.faults_injected == 1
        assert eng.published > 0 and eng.delivered > 0
        await eng.storm_stop()
        await eng.drain_clean_streak()
        assert not eng.alarms.is_active("xla_audit_divergence")
        sweep = await eng.audit_sweep()
        assert sweep["silent_divergences"] == 0
        assert eng.router.quarantined_filters() == []
    finally:
        await eng.close()


async def test_slot_decay_whole_table_heals(tmp_path):
    eng = await _engine(tmp_path, 200)
    try:
        await eng.setup()
        eng.storm_start()
        res = await SlotDecay().run(eng)
        assert res.ok, json.dumps(res.as_dict(), indent=1)
        await eng.storm_stop()
        assert (await eng.audit_sweep())["silent_divergences"] == 0
    finally:
        await eng.close()


async def test_disconnect_takeover_wave(tmp_path):
    eng = await _engine(tmp_path, 300)
    try:
        await eng.setup()
        eng.storm_start()
        res = await DisconnectTakeover(wave=60).run(eng)
        assert res.ok, json.dumps(res.as_dict(), indent=1)
        await eng.storm_stop()
    finally:
        await eng.close()


async def test_crash_consistency_chain_under_storm(tmp_path):
    eng = await _engine(tmp_path, 250)
    try:
        await eng.setup()
        assert eng.durable_db is not None
        eng.storm_start()
        for sc in (TornWal(), DiskFull(), FsyncFail(), BrokerRestart()):
            res = await sc.run(eng)
            assert res.ok, json.dumps(res.as_dict(), indent=1)
            assert res.recovery_ms is not None
        await eng.storm_stop()
        assert eng.storm_errors == 0
        assert eng.durable_db.failed_shards() == []
        assert all(not s.client_id.startswith("s") or type(s).__name__ != "DurableSession"
                   for s in eng.broker.sessions.values())
        row = eng.soak_row([], await eng.audit_sweep(), 1.0)
        assert row["ds"]["reboots"] >= 2
        assert row["ds"]["failed_at_end"] == []
        assert row["ds"]["wal_torn_records"] >= 2
        assert row["ds"]["shard_fail_stops"] >= 2
    finally:
        await eng.close()


@contextlib.contextmanager
def _fault_on_a_helper_thread(eng, main):
    """Force the interleaving of the tier-1 runs' disk_full and
    fsync_fail failures: another thread than the scenario's (a helper
    here, the DS buffer's flush thread in a run) takes every write the
    scenario pushed, so the write that hits the fault and every refusal
    happen there and the scenario's own flush finds nothing; and that
    thread's fail-stop fan-out stops 0.3 s between its alarm and its
    flight trigger. The buffer's own flush thread is parked for the
    block and restarted after it, so the helper is the only other thread
    that flushes. The scenario goes on once the helper holds the writes
    and the shard reads failed."""
    buf = eng.durable_db.buffer
    buf.park()
    real_flush, real_trigger = buf.flush_now, eng.flight.maybe_trigger

    def flush_now():
        if threading.current_thread() is main and any(buf._pending.values()):
            t = threading.Thread(target=helper_flush)
            t.start()
            while t.is_alive() and (any(buf._pending.values())
                                    or not eng.durable_db.failed_shards()):
                time.sleep(0.001)
        real_flush()

    def helper_flush():
        try:
            real_flush()
        except OSError:
            pass

    def maybe_trigger(name, details):
        if name == "ds_shard_failed" and threading.current_thread() is not main:
            time.sleep(0.3)
        return real_trigger(name, details)

    buf.flush_now = flush_now
    eng.flight.maybe_trigger = maybe_trigger
    try:
        yield
    finally:
        del buf.flush_now
        del eng.flight.maybe_trigger
        buf.unpark()


@pytest.mark.parametrize("scenario", [DiskFull, FsyncFail])
async def test_disk_scenarios_read_checks_after_the_failstop_fanout(scenario, tmp_path):
    eng = await _engine(tmp_path, 120)
    try:
        await eng.setup()
        with _fault_on_a_helper_thread(eng, threading.current_thread()):
            res = await scenario().run(eng)
        assert res.ok, json.dumps(res.as_dict(), indent=1)
        assert eng.durable_db.failstop_pending() == []
        assert eng.durable_db.buffer._thread.is_alive()
    finally:
        await eng.close()


# --- the mesh scenarios: chip loss, chip flap, reshard churn ---------------


def _mesh_engine_kw():
    """tests/test_device_breaker.py's shard-scenario engine (its (1, 8)
    mesh on one device, here the CPU)."""
    return dict(sessions=200, groups=40, sample_n=1, storm_chunk=32, detect_rounds=6,
                detect_burst=16, chaos_filters=2, chaos_fan=4, settle_timeout=8.0)


@pytest.mark.parametrize("make", [lambda: ChipLoss(), lambda: ChipFlap(cycles=1),
                                  lambda: ReshardChurn()],
                         ids=["chip_loss", "chip_flap", "reshard_churn"])
async def test_mesh_scenarios_under_storm(make, tmp_path):
    """Each mesh scenario on a (1, 8) CPU mesh under a live storm, every
    contract holding: single-shard loss evacuates without suspending the
    table and rebalances back, a flap recovers its cycle, planned
    reshard cycles stay divergence-free."""
    eng = await ChaosEngine.standalone(
        data_dir=str(tmp_path), device="cpu",
        mesh=make_mesh(n_dp=1, n_sub=8, devices=["cpu"] * 8), **_mesh_engine_kw())
    try:
        await eng.setup()
        eng.storm_start()
        sc = make()
        res = await sc.run(eng)
        assert res.ok, json.dumps(res.as_dict(), indent=1)
        await eng.storm_stop()
        assert eng.storm_errors == 0
        assert (await eng.audit_sweep())["silent_divergences"] == 0
        dt = eng.router.device_table
        assert dt.n_shards == 8 and not dt.lost_shards and dt.shard_gen >= 2
        assert not eng.broker.engine._shard_probe_tasks
    finally:
        await eng.close()
    assert not eng.broker.engine._shard_probe_tasks


SOAK_KW = dict(sessions=150, victim_sessions=0, groups=30, sample_n=2, baseline_s=0.3,
               scenarios=["storm_baseline", "row_corruption"], strict=True, storm_chunk=32,
               detect_rounds=6, detect_burst=16, chaos_filters=2, chaos_fan=4,
               settle_timeout=8.0)
# the sub-dicts of a soak row whose keys do not depend on the run's data
FIXED_SHAPE = ("storm", "final_sweep", "audit", "rpc", "breaker", "knobs", "ds")


async def test_soak_row_has_the_reference_keys(tmp_path):
    rows = []
    for fn, sub, kw in ((r_run_soak, "ref", {}), (run_soak, "port", {"device": "cpu"})):
        out = tmp_path / f"{sub}.json"
        row = await fn(report_path=str(out), data_dir=str(tmp_path / sub), **SOAK_KW, **kw)
        assert row["contracts_ok"] and not row["violations"]
        assert json.loads(out.read_text())["contracts_ok"]
        rows.append(row)
    ref, port = rows
    assert set(port) == set(ref)
    for k in FIXED_SHAPE:
        assert set(port[k]) == set(ref[k]), k
    assert set(port["scenarios"]) == set(ref["scenarios"]) == {"storm_baseline",
                                                               "row_corruption"}
    for name in ref["scenarios"]:
        assert set(port["scenarios"][name]) == set(ref["scenarios"][name])
        assert [c["name"] for c in port["scenarios"][name]["checks"]] == \
            [c["name"] for c in ref["scenarios"][name]["checks"]]
    assert port["divergences_detected"] == port["divergences_injected"] >= 1
    assert port["silent_divergences"] == 0
    prov, rprov = port["provenance"], ref["provenance"]
    assert set(rprov) - set(prov) == {"jax"}
    assert set(prov) - set(rprov) == {"torch", "cuda"}
    assert prov["platform"] == "cpu" and prov["torch"] == torch.__version__
    assert "jax" not in json.dumps(port, default=str).lower()


def test_catalog_is_the_single_device_one_in_the_reference_order():
    """The catalog is the reference's without the cluster scenarios, in
    the reference's order; the mesh scenarios are in it."""
    from emqx_tpu.chaos.scenarios import CATALOG as RCATALOG

    mesh = {"chip_loss", "chip_flap", "reshard_churn"}
    cluster = {"partition_nodedown", "replica_drift", "asymmetric_partition",
               "split_brain", "heal_storm", "node_evacuation", "node_purge"}
    assert CATALOG == [n for n in RCATALOG if n not in cluster]
    assert [s.name for s in scenario_catalog()] == CATALOG
    assert {s.name for s in scenario_catalog() if s.needs_mesh} == mesh
    assert not any(s.needs_cluster for s in scenario_catalog())
    assert [s.name for s in scenarios_by_name(["storm_baseline", "chip_loss"])] == \
        ["storm_baseline", "chip_loss"]


class _Ran:
    """A scenario that records that it ran."""

    def __init__(self, name, needs_mesh):
        self.name, self.needs_mesh, self.needs_cluster = name, needs_mesh, False
        self.ran = False

    async def run(self, eng):
        from emqx_tpu_torch.chaos.scenarios import ScenarioResult

        self.ran = True
        return ScenarioResult(self.name)


@pytest.mark.parametrize("call", ["victim_sessions", "cluster_engine", "mesh_scenario",
                                  "cluster_scenario", "cluster_catalog", "engine_victim"])
async def test_cluster_and_mesh_parts_raise_naming_item_8(call, tmp_path):
    if call == "mesh_scenario":
        # a mesh scenario is skipped on an engine whose table has no mesh
        eng = await _engine(tmp_path, 30)
        try:
            await eng.setup()
            mesh_sc, plain = _Ran("chip_loss", True), _Ran("storm_baseline", False)
            row = await eng.run([mesh_sc, plain], baseline_s=0)
            assert not mesh_sc.ran and plain.ran
            assert set(row["scenarios"]) == {"storm_baseline"}
        finally:
            await eng.close()
        return
    with pytest.raises(NotImplementedError, match="item 8"):
        if call == "victim_sessions":
            await run_soak(sessions=10, victim_sessions=1, device="cpu",
                           data_dir=str(tmp_path))
        elif call == "cluster_engine":
            await ChaosEngine.cluster(sessions=10)
        elif call == "cluster_scenario":
            await run_soak(sessions=10, device="cpu", scenarios=["split_brain"],
                           data_dir=str(tmp_path))
        elif call == "cluster_catalog":
            scenario_catalog(cluster=True)
        else:
            ChaosEngine(TBroker(device="cpu"), None, sessions=10, victim_sessions=5)


def test_cli_refuses_the_clustered_soak_and_writes_nothing_by_default(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert chaos_main.main(["--sessions", "10", "--victim-sessions", "5",
                            "--device", "cpu"]) == 2
    assert chaos_main.main(["--sessions", "10", "--scenario", "chip_flap",
                            "--device", "cpu"]) == 2
    assert list(tmp_path.iterdir()) == []
