"""The port's native host cores (emqx_tpu_torch/native: the route-churn
core and the delivery ledger in speedups.cc, the frame codec in
frame.cc) held against their Python twins and against the reference,
on the same seeded inputs:

  * the churn core: chip_smoke.py's native storm (exact, deep and $SYS
    filters, single and batched adds and deletes, refcounted
    duplicates, skeleton swaps, a capacity bump), and an exhausted
    eviction walk that makes the core ask for an index rebuild; port
    native, port twin and emqx_tpu's Router, with DeviceTable and a
    CPU ShardedDeviceTable: generations, staged deltas, each device
    table against a full upload, `chip_smoke.churn_state` and answers;
  * the delivery ledger: the seeded fuzz, port native against port twin
    against the reference's two;
  * the frame codec: bytes, parses and FrameErrors against the port's
    Python codec and emqx_tpu.framec;
  * the loader: the extensions import beside the reference's, a failed
    build or a missing Python.h raises NativeBuildError with nothing
    falling back, only the setters select a twin, and the sources and
    the build module name neither the repo's native/ nor emqx_tpu.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import chip_smoke as cs
from emqx_tpu import framec as JFC
from emqx_tpu.broker import delivery as JD
from emqx_tpu.broker import frame as JF
from emqx_tpu.broker import packet as JP
from emqx_tpu.models import router as JR
from emqx_tpu_torch import framec as TFC
from emqx_tpu_torch import jsonc as TJ
from emqx_tpu_torch import native
from emqx_tpu_torch.broker import delivery as TD
from emqx_tpu_torch.broker import frame as TF
from emqx_tpu_torch.broker import packet as TP
from emqx_tpu_torch.models import router as TR
from emqx_tpu_torch.ops import speedups as TS
from emqx_tpu_torch.parallel import mesh as TMesh

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the churn core ---------------------------------------------------------------

# (routes of the slice's pattern, skeletons): within the class budget
# (every class compared) and past it (phase 3's 600 skeletons: the class
# assignment follows arrival order and is left out)
STORMS = {"within_budget": (1024, 40), "past_budget": (512, 300)}


def _storm(n_routes, n_skel, seed=0):
    rng = np.random.default_rng(seed)
    skel = cs.skeleton_filters(rng, n_skel)
    return cs.native_route_ops(rng, n_routes, skel)


@pytest.mark.parametrize("storm", sorted(STORMS))
@pytest.mark.parametrize("layout", ["single", "mesh"])
def test_churn_core_equals_twin(storm, layout):
    """Port native against port twin through the storm, with the device
    tables (a DeviceTable, or a ShardedDeviceTable on a CPU (2, 4)
    mesh) synced after every round: equal generation moves, staged
    deltas, states after every round and answers; each device table
    equal to a full upload after each delta sync; the table capacity
    grows past its first 1,024 rows."""
    n_routes, n_skel = STORMS[storm]
    mesh = TMesh.make_mesh(2, 4, devices=["cpu"] * 8) if layout == "mesh" else None
    out = cs.native_twin_routers(n_routes=n_routes, n_skeletons=n_skel, mesh=mesh,
                                 every_round=True)
    assert out["strict_classes"] == (storm == "within_budget")
    assert out["deltas"] >= 1 and out["delta_rows"] > 0
    assert min(out["capacity"]) > 1024
    if storm == "past_budget":
        assert min(out["residual_rows"]) > 0


@pytest.mark.parametrize("storm", sorted(STORMS))
def test_churn_core_equals_reference(storm):
    """The port's Router with its churn core and emqx_tpu's Router (its
    default, its own native core) through the same storm: equal
    generation moves call for call, equal `churn_state` after every
    round and equal answers (the port's plain kernels on the CPU, the
    reference's JAX ones)."""
    n_routes, n_skel = STORMS[storm]
    setup, rounds, topics = _storm(n_routes, n_skel)
    strict = storm == "within_budget"
    runs = []
    for r in (TR.Router(max_levels=16, device="cpu"), JR.Router(max_levels=16)):
        moved = cs.run_calls(r, setup)
        states, answers = [], []
        for calls in rounds:
            moved += cs.run_calls(r, calls)
            states.append(cs.churn_state(r, strict))
            answers.append(([sorted(x) for x in r.match_filters_batch(topics)],
                            [sorted(r.match_filters(t)) for t in topics]))
        runs.append((moved, states, answers))
    (tm, ts, ta), (jm, js, ja) = runs
    assert tm == jm
    for x, y in zip(ts, js):
        for key in x:
            assert x[key] == y[key], key
    assert ta == ja


def _exhausting(router):
    """A router whose class index starts at 8 buckets (32 slots) and
    whose reserve never grows them: the churn core's eviction walk
    exhausts and asks for a rebuild (flag 2, need_rebuild), which the
    router runs before it rebuilds its churn handle. Returns the
    rebuilds' bucket counts."""
    ix = router.index
    ix._min_buckets = 8
    ix._rebuild(8)
    assert ix.n_buckets == 8
    ix.reserve = lambda n_new, cap: (ix.ensure_row_capacity(cap),
                                     ix._grow_bucket_arrays(len(ix._bkt_ws) + n_new))
    rebuilds = []
    real = ix._rebuild

    def rebuild(n):
        rebuilds.append(n)
        real(n)

    ix._rebuild = rebuild
    return rebuilds


def test_exhausted_eviction_walk_rebuilds_the_index_and_the_handle():
    """Single and batched adds into a full cuckoo table: the core returns
    need_rebuild, the router rebuilds the index (the slot arrays are
    replaced) and the churn handle, and every later write lands in the
    new arrays: state, answers and the device table's delta syncs equal
    the twin's and the reference's."""
    flts = [f"x/{k}/+/y{k % 3}" for k in range(40)] + [f"q/{k}" for k in range(30)]
    topics = [f"x/{k}/v/y{k % 3}" for k in range(40)] + [f"q/{k}" for k in range(30)]
    TS.set_native_enabled(False)
    try:
        twin = TR.Router(max_levels=16, device="cpu")
    finally:
        TS.set_native_enabled(True)
    nat = TR.Router(max_levels=16, device="cpu")
    ref = JR.Router(max_levels=16)
    rebuilds = _exhausting(nat)
    nat.device_table.sync()
    handles = []
    for r in (nat, twin, ref):
        for f in flts[:40]:  # 40 buckets into 32 slots: the single-pair leg
            r.add_route(f, "a")
            if r is nat:
                handles.append(nat._churn_handle)
        if r is nat:
            single = len(rebuilds)
        r.add_routes([(f, "b") for f in flts[40:]])  # 70 into 64: the batched leg
        r.delete_routes([(f, "a") for f in flts[:10]])
        r.add_routes([(f, "c") for f in flts[:10]])
    assert single >= 1 and len(rebuilds) > single and nat.index.n_buckets > 16
    assert len({id(h) for h in handles}) > 1  # a new handle after the rebuild
    cap = cs.DeltaCapture()
    cap.router = nat
    with cap:
        nat.device_table.sync()
    cs.delta_equals_full_upload(nat)
    states = [cs.churn_state(r) for r in (nat, twin, ref)]
    for key in states[0]:
        assert states[0][key] == states[1][key] == states[2][key], key
    answers = [[sorted(x) for x in r.match_filters_batch(topics)] for r in (nat, twin, ref)]
    assert answers[0] == answers[1] == answers[2]
    assert all(answers[0])


def test_dest_store_after_churn_equals_reference_twin(monkeypatch):
    """The Python twins of both packages through the broker's subscribe /
    unsubscribe / close churn leave both CSR stores identical (the
    native cores' run is test_torch_broker.py's)."""
    from emqx_tpu.ops import speedups as JS
    from test_torch_broker import Side

    # the reference's loaders cache what they saw: restored after the test
    monkeypatch.setattr(JS, "load", lambda build=True: None)
    monkeypatch.setattr(JD, "_mod", JD._mod)
    monkeypatch.setattr(JD, "_tried", JD._tried)
    TS.set_native_enabled(False)
    try:
        sides = [Side(port=False), Side(port=True)]
        for x in sides:
            for i in range(60):
                x.sub(f"c{i}", "hot/+", qos=i % 3)
                if i % 3 == 0:
                    x.sub(f"c{i}", f"room/{i % 4}/#", qos=2)
            for i in range(0, 60, 4):
                x.b.unsubscribe(x.b.sessions[f"c{i}"], "hot/+")
            for i in range(0, 60, 11):
                x.b.close_session(x.b.sessions[f"c{i}"])
            x.check("hot/5")
    finally:
        TS.set_native_enabled(True)
    js, ts = (x.b.router.dest_store for x in sides)
    assert sides[1].b.router._sp is None
    for name in ("seg_off", "seg_len", "seg_cap", "seg_live", "edge_client", "edge_opts"):
        assert (getattr(ts, name) == getattr(js, name)).all(), name
    assert ts.pending_rows == js.pending_rows
    assert sides[0].log == sides[1].log


# --- the delivery ledger ---------------------------------------------------------


def test_ledger_fuzz_equals_twin_and_reference():
    """The seeded fuzz over the whole ledger surface (reserve_many too):
    the port's native ledger, its twin and the reference's native ledger
    and twin answer op for op and dump for dump."""
    ledgers = [TD.NativeDeliveryLedger(TD._load()), TD.PyDeliveryLedger(),
               JD.NativeDeliveryLedger(JD._load()), JD.PyDeliveryLedger()]
    assert cs.ledger_fuzz(ledgers, 6000) == 6000


def test_sessions_bind_the_native_ledger_unless_the_setter_picks_the_twin():
    from emqx_tpu_torch.broker.session import Session

    m = TD.DELIVERY_METRICS
    n0, p0 = m.sessions_native, m.sessions_python
    s = Session("a")
    assert s._ledger.is_native and m.sessions_native == n0 + 1
    TD.set_native_enabled(False)
    try:
        s2 = Session("b")
    finally:
        TD.set_native_enabled(True)
    assert not s2._ledger.is_native and m.sessions_python == p0 + 1
    assert TD.native_enabled() and m.snapshot()["native_enabled"] == 1


# --- the frame codec ---------------------------------------------------------------


def test_frame_codec_equals_python_codec_and_reference():
    """Bytes, chunked and cut-short parses and malformed input's
    FrameError (message and reason code) through the port's native
    codec equal the port's Python codec's and emqx_tpu.framec's; the
    hot surface went native, a PUBLISH with properties and the
    malformed frames went to the Python codec, counted."""
    m = TFC.FRAME_METRICS
    before = m.snapshot()
    got = cs.frame_results(TFC, TF, TP)
    after = m.snapshot()
    assert got == cs.frame_results(TF, TF, TP) == cs.frame_results(JFC, JF, JP)
    assert after["native_encodes"] > before["native_encodes"]
    assert after["native_decodes"] > before["native_decodes"]
    assert after["fallback_encodes"] - before["fallback_encodes"] == 2  # the props PUBLISH, v4 and v5
    assert after["fallback_decodes"] > before["fallback_decodes"]
    assert sum(isinstance(x, tuple) and x[0] == "error" for x in got) >= 8


def test_frame_setter_selects_the_python_codec():
    m = TFC.FRAME_METRICS
    pkt = TP.Publish(topic="k", payload=b"x")
    TFC.set_native_enabled(False)
    try:
        n0, f0 = m.native_encodes, m.fallback_encodes
        assert TFC.serialize(pkt, TP.MQTT_V4) == TF._serialize_uncached(pkt, TP.MQTT_V4)
        assert (m.native_encodes, m.fallback_encodes) == (n0, f0 + 1)
        assert not TFC.native_enabled()
    finally:
        TFC.set_native_enabled(True)
    n0 = m.native_encodes
    TFC.serialize(TP.Publish(topic="k", payload=b"x"), TP.MQTT_V4)
    assert m.native_encodes == n0 + 1


# --- the loader ----------------------------------------------------------------------


def test_extensions_load_beside_the_reference():
    """The port's two extensions and the reference's load into one
    process as four modules; a churn handle or ledger of one package is
    refused by the other's legs (their capsule names differ)."""
    from emqx_tpu.ops import speedups as JS

    ts, tf = native.load("_emqx_torch_speedups"), native.load("_emqx_torch_frame")
    js, jf = JS.load(), JFC.load()
    assert js is not None and jf is not None
    assert [m.__name__ for m in (ts, tf, js, jf)] == [
        "_emqx_torch_speedups", "_emqx_torch_frame", "_emqx_speedups", "_emqx_frame"]
    assert TS.load() is ts and ts.wild_flags([("a/#", 0)]) == [True]
    h = ts.delivery_make_handle()
    with pytest.raises(ValueError):
        js.delivery_open(h)
    r = TR.Router(max_levels=8, device="cpu")
    r.add_route("a/+", "x")
    with pytest.raises(ValueError):
        js.add_route_core(r._churn_handle, "b/+", "y")
    assert r._churn_handle is not None and r.match_filters("a/1") == ["a/+"]


@pytest.fixture
def fresh_native(monkeypatch, tmp_path):
    """An empty build directory and no module loaded yet, for this test
    only."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(TS, "_probed", False)
    monkeypatch.setattr(TD, "_mod", None)
    monkeypatch.setattr(TD, "_native_ledger", None)
    monkeypatch.setattr(TFC, "_mod", None)
    monkeypatch.setattr(TJ, "_mod", None)
    return tmp_path


def _nothing_falls_back():
    with pytest.raises(native.NativeBuildError):
        TS.load()
    with pytest.raises(native.NativeBuildError):
        TR.Router(max_levels=8, device="cpu")
    with pytest.raises(native.NativeBuildError):
        TD.make_ledger()
    with pytest.raises(native.NativeBuildError):
        TFC.serialize(TP.Publish(topic="t", payload=b""), TP.MQTT_V4)
    with pytest.raises(native.NativeBuildError):
        TFC.Parser(proto_ver=TP.MQTT_V4).feed(b"\x30\x03\x00\x01t")
    with pytest.raises(native.NativeBuildError):
        TJ.loads(b"{}")
    with pytest.raises(native.NativeBuildError):
        TJ.dumps({})


def test_missing_compiler_raises_and_nothing_falls_back(fresh_native, monkeypatch):
    monkeypatch.setattr(native, "CXX", str(fresh_native / "no-such-g++"))
    _nothing_falls_back()
    assert not (fresh_native / "build").exists() or not any((fresh_native / "build").glob("*.so"))


def test_missing_python_header_raises(fresh_native, monkeypatch):
    monkeypatch.setattr(native.sysconfig, "get_paths",
                        lambda *a, **k: {"include": str(fresh_native)})
    _nothing_falls_back()


def test_failed_compile_raises_with_the_compiler_log(fresh_native, monkeypatch):
    src = fresh_native / "src"
    src.mkdir()
    for name in native.SOURCES.values():
        (src / name).write_text("#include <Python.h>\nthis is not C++;\n")
    monkeypatch.setattr(native, "SRC", src)
    with pytest.raises(native.NativeBuildError, match="g\\+\\+ failed"):
        native.load("_emqx_torch_speedups")
    _nothing_falls_back()
    assert not list((fresh_native / "build").glob("*.tmp"))


def test_build_is_keyed_by_source_and_reused(fresh_native):
    """A first load builds into the build directory (one file a source,
    named by its hash, no temporary left); a second process-level load
    reuses the file; an edited source builds a new one."""
    native.build(sorted(native.SOURCES))
    built = sorted(p.name for p in (fresh_native / "build").glob("*.so"))
    assert len(built) == len(native.SOURCES) and all(re.search(r"-[0-9a-f]{16}\.", n) for n in built)
    t0 = {p.name: p.stat().st_mtime_ns for p in (fresh_native / "build").glob("*.so")}
    native.build(sorted(native.SOURCES))
    assert {p.name: p.stat().st_mtime_ns for p in (fresh_native / "build").glob("*.so")} == t0
    assert TS.load().wild_flags([("a", 0)]) == [False]


def test_only_the_setters_select_the_twins(monkeypatch):
    """No environment variable turns a native core off: the reference's
    switches are not read; the routers, sessions and codec built with
    them set are native."""
    for var in ("EMQX_TPU_NO_SPEEDUPS", "EMQX_TPU_NO_FRAMEC", "EMQX_TPU_NO_JSONC"):
        monkeypatch.setenv(var, "1")
    assert TR.Router(max_levels=8, device="cpu")._sp is not None
    assert TD.make_ledger().is_native
    n0 = TFC.FRAME_METRICS.native_encodes
    TFC.serialize(TP.Publish(topic="t", payload=b""), TP.MQTT_V4)
    assert TFC.FRAME_METRICS.native_encodes == n0 + 1
    n0 = TJ.JSON_METRICS.native_dumps
    TJ.dumps({"a": 1})
    assert TJ.JSON_METRICS.native_dumps == n0 + 1
    TS.set_native_enabled(False)
    try:
        assert TS.load() is None and TR.Router(max_levels=8, device="cpu")._sp is None
    finally:
        TS.set_native_enabled(True)
    assert TS.native_enabled()


# the reference's package and the repo's native/ directory, as named in text
_FOREIGN = re.compile(
    r"\bemqx_tpu\b|(?<![\w/])native/|_emqx_speedups|_emqx_frame\b|_emqx_json\b|libemqxkv")


def test_native_sources_and_build_module_name_neither_native_dir_nor_reference():
    """The port's four C++ sources and its build module name neither the
    repo's native/ (its sources, its Makefile, its committed .so files)
    nor emqx_tpu, nor the reference's module and library names; the
    build module imports neither jax nor emqx_tpu."""
    from test_torch_router import _imports

    files = sorted((REPO / "emqx_tpu_torch" / "native").glob("*.cc"))
    files.append(REPO / "emqx_tpu_torch" / "native" / "__init__.py")
    assert [p.name for p in files] == ["frame.cc", "json.cc", "kvlog.cc", "speedups.cc",
                                       "__init__.py"]
    bad = [f"{p.name}:{k + 1}: {line.strip()}"
           for p in files for k, line in enumerate(p.read_text().splitlines())
           if _FOREIGN.search(line)]
    assert not bad, bad
    mods = list(_imports(files[-1]))
    assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "emqx_tpu")], mods
    assert native.SRC == REPO / "emqx_tpu_torch" / "native"
