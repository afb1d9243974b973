"""The port's Router and DeviceTable (emqx_tpu_torch.models.router) held
against emqx_tpu's on the same seeded routes, churn and topics; the
delta scatters K3/K4 (plain versions) against `_scatter_rows` /
`_scatter_slots`; device selection; and the port's import hygiene.
"""

import ast
import pathlib
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emqx_tpu.models import router as JR
from emqx_tpu.ops import hash_index as JH
from emqx_tpu.ops.table import FilterTable as JFilterTable
from emqx_tpu.ops.table import pad_pow2_batches
from emqx_tpu_torch import device as device_mod
from emqx_tpu_torch.device import to_device
from emqx_tpu_torch.models import router as TR
from emqx_tpu_torch.ops.hash_index import SlotArrays
from emqx_tpu_torch.ops.table import EncodedFilters

from test_match import random_filter, random_topic

CPU = torch.device("cpu")
REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tier-1 runs test files side by side in worker processes; torch's
    CPU ops would otherwise take every core from the timing-sensitive
    tests next door."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return to_device(np.asarray(a), CPU)


# --- (i) K3/K4 plain versions vs the JAX scatters ----------------------------


@pytest.mark.parametrize("seed,n_dirty", [(0, 5), (1, 1500)])
def test_scatter_rows_equals_reference(seed, n_dirty):
    rng = random.Random(seed)
    table = JFilterTable(max_levels=6, capacity=2048)
    for _ in range(1800):
        table.add(random_filter(rng))
    before = [np.array(a) for a in table.snapshot()]
    table.drain_dirty()
    live = list(table.rows())
    for r in rng.sample(live, n_dirty // 2):
        table.remove(r)
    while len(table.dirty) < n_dirty:
        table.add(random_filter(rng))
    rows = pad_pow2_batches(table.drain_dirty(), 1024)
    cols = [table.words[rows], table.prefix_len[rows], table.has_hash[rows],
            table.root_wild[rows], table.active[rows]]
    want = JR._scatter_rows(
        JR.EncodedFilters(*(jnp.asarray(a) for a in before)),
        jnp.asarray(rows), *(jnp.asarray(c) for c in cols),
    )
    dev = EncodedFilters(*(_t(a) for a in before))
    TR.scatter_rows(dev, _t(rows), *(_t(c) for c in cols))
    for w, g, h in zip(want, dev, table.snapshot()):
        assert np.array_equal(np.asarray(w), g.numpy())
        assert np.array_equal(h, g.numpy())  # == host truth


@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_slots_equals_reference(seed):
    rng = random.Random(seed)
    table = JFilterTable(max_levels=6, capacity=4096)
    ix = JH.ClassIndex(6, min_slots=4096)
    for _ in range(1200):
        ix.add_row(table.add(random_filter(rng)), table)
    before = [np.array(a) for a in ix.slots]
    ix.dirty_slots.clear()
    ix.rebuilt = False
    live = list(table.rows())
    for r in rng.sample(live, 300):
        ix.remove_row(r)
        table.remove(r)
    for _ in range(300):
        ix.add_row(table.add(random_filter(rng)), table)
    assert not ix.rebuilt  # incremental placement: no full re-upload
    dirty = np.unique(np.asarray(ix.dirty_slots, np.int32))
    idx = pad_pow2_batches(dirty, 256)
    cols = [ix.slots.fp[idx], ix.slots.bucket[idx], ix.slots.probe[idx // JH.BUCKET_W]]
    want = JR._scatter_slots(
        JH.SlotArrays(*(jnp.asarray(a) for a in before)),
        jnp.asarray(idx), *(jnp.asarray(c) for c in cols),
    )
    slots = SlotArrays(*(_t(a) for a in before))
    TR.scatter_slots(slots, _t(idx), *(_t(c) for c in cols))
    for w, g, h in zip(want, slots, ix.slots):
        assert np.array_equal(np.asarray(w), g.numpy())
        assert np.array_equal(h, g.numpy())  # == host truth


# --- (ii) port Router vs reference Router ------------------------------------


def _route_stream(rng, n):
    """Seeded routes: random filters incl. $-rooted ones, deep ones
    (past the hash index's 32-level class limit) and too-deep ones
    (past max_levels), plus exact topics."""
    out = []
    for i in range(n):
        k = rng.random()
        if k < 0.03:
            f = "/".join(["a"] * 34) + "/+"          # deep: residual
        elif k < 0.06:
            f = "/".join(["z"] * 45) + "/#"          # too deep: host trie
        elif k < 0.08:
            f = "/".join(["q"] * 41)                  # too-deep exact topic
        else:
            f = random_filter(rng)
        out.append((f, f"n{rng.randint(0, 6)}"))
    return out


def _topics(rng, n):
    extra = ["/".join(["a"] * 35), "/".join(["z"] * 50), "/".join(["q"] * 41),
             "$SYS/a", "$x/b/c"]
    return [random_topic(rng) for _ in range(n)] + extra


# (seed, use_hash_index, class_budget)
ROUTER_CASES = [(0, True, 256), (1, True, 6), (2, False, 256)]


@pytest.mark.parametrize("seed,use_hash_index,class_budget", ROUTER_CASES)
def test_router_match_batch_equals_reference(seed, use_hash_index, class_budget):
    rng = random.Random(seed)
    jr = JR.Router(max_levels=40, use_hash_index=use_hash_index)
    tr = TR.Router(max_levels=40, device="cpu", use_hash_index=use_hash_index)
    if use_hash_index:
        for r in (jr, tr):
            r.index.class_budget = class_budget
            r.index._class_free = list(range(class_budget - 1, -1, -1))
    routes = _route_stream(rng, 400)
    jr.add_routes(routes[:200])
    tr.add_routes(routes[:200])
    for f, d in routes[200:]:
        jr.add_route(f, d)
        tr.add_route(f, d)
    live = list(routes)
    for step in range(3):
        topics = _topics(rng, 60)
        want = jr.match_batch(topics)
        assert tr.match_batch(topics) == want
        assert [tr.match_routes(t) for t in topics] == want
        # churn: drop and add routes between batches
        for _ in range(60):
            f, d = live.pop(rng.randrange(len(live)))
            jr.delete_route(f, d)
            tr.delete_route(f, d)
        fresh = _route_stream(rng, 60)
        jr.add_routes(fresh)
        tr.add_routes(fresh)
        live.extend(fresh)
    assert tr.stats() == jr.stats()


def test_router_route_surface_equals_reference():
    """The host-side route surface (batched deletes, lookups, listings
    and dest pairs) answers as the reference's does."""
    rng = random.Random(11)
    jr = JR.Router(max_levels=40)
    tr = TR.Router(max_levels=40, device="cpu")
    routes = _route_stream(rng, 300) + [("dup/+", "n1"), ("dup/+", "n1")]
    for r in (jr, tr):
        r.add_routes(routes)
        r.delete_routes(routes[::4] + [("absent/#", "n0")])
    assert tr.topic_count() == jr.topic_count()
    assert tr.topics() == jr.topics()
    assert sorted(map(str, tr.routes())) == sorted(map(str, jr.routes()))
    for f, d in routes[:80]:
        assert tr.has_route(f, d) == jr.has_route(f, d)
        assert sorted(tr.dests(f)) == sorted(jr.dests(f))
    topics = _topics(rng, 40)
    want = [sorted((f, sorted(ds.items())) for f, ds in pairs)
            for pairs in jr.match_pairs_batch(topics)]
    got = [sorted((f, sorted(ds.items())) for f, ds in pairs)
           for pairs in tr.match_pairs_batch(topics)]
    assert got == want


def test_router_pipelined_begin_finish_and_cache():
    """Two batches in flight, then the match cache: answers equal the
    synchronous path and the host oracle."""
    rng = random.Random(7)
    tr = TR.Router(max_levels=8, device="cpu")
    for f, d in _route_stream(rng, 300):
        tr.add_route(f, d)
    t1, t2 = _topics(rng, 40), _topics(rng, 33)
    p1 = tr.match_filters_begin(t1)
    p2 = tr.match_filters_begin(t2)
    assert tr.match_finish_ready(p1)
    for topics, p in ((t1, p1), (t2, p2)):
        got = tr.match_filters_finish(p)
        assert [sorted(g) for g in got] == [sorted(tr.match_filters(t)) for t in topics]
    tr.enable_match_cache(64)
    first = tr.match_filters_batch(t1)
    again = tr.match_filters_batch(t1)
    assert [sorted(a) for a in again] == [sorted(f) for f in first]
    assert tr.telemetry.counters["match_cache_hits"] >= len(set(t1)) - 64
    tr.suspend_device()
    assert [sorted(g) for g in tr.match_filters_batch(t2)] == [
        sorted(tr.match_filters(t)) for t in t2
    ]
    assert tr.warmup_shapes(8) == 0
    tr.resume_device()
    assert tr.warmup_shapes(8) == 4


@pytest.mark.parametrize(
    "class_budget,counter",
    [(256, "hash_overflow_retries_total"), (1, "escalations_total")],
)
def test_router_overflow_escalation_equals_reference(class_budget, counter):
    """More matches than the first max_hits bound (on the hash leg, or
    with a one-class budget on the residual dense leg): the exact-total
    retry returns the full result."""
    jr = JR.Router(max_levels=4)
    tr = TR.Router(max_levels=4, device="cpu")
    for r in (jr, tr):
        r.index.class_budget = class_budget
        r.index._class_free = list(range(class_budget - 1, -1, -1))
    pairs = [(f"w/{i}/+", f"m{i}") for i in range(2000)]
    # seven more skeletons that every w/i/q topic matches
    pairs += [(f, f"s{k}") for k, f in enumerate(
        ["w/+/q", "+/+/q", "+/+/+", "w/#", "+/#", "#", "w/+/#"])]
    jr.add_routes(pairs)
    tr.add_routes(pairs)
    topics = [f"w/{i}/q" for i in range(1500)]
    assert tr.match_batch(topics) == jr.match_batch(topics)
    assert tr.telemetry.counters.get(counter, 0) == 1


def test_escalation_after_a_sync_keeps_every_match():
    """A batch that overflows escalates at finish, after the NEXT
    batch's begin has synced new routes: the re-run sees more flagged
    pairs than the first run counted, and must be sliced by its own
    total (slicing it by the first total dropped the last topics'
    matches). Nothing true at begin is lost; nothing false at finish
    is surfaced."""
    tr = TR.Router(max_levels=4, device="cpu")
    pairs = [(f"w/{i}/+", f"m{i}") for i in range(1500)]
    pairs += [(f, f"s{k}") for k, f in enumerate(
        ["w/+/q", "+/+/q", "+/+/+", "w/#", "+/#", "#", "w/+/#"])]
    tr.add_routes(pairs)
    topics = [f"w/{i}/q" for i in range(1500)]
    before = [set(tr.match_filters(t)) for t in topics]
    p = tr.match_filters_begin(topics)
    tr.add_routes([("w/+/+/#", "late")])  # one more class, every topic
    p2 = tr.match_filters_begin(["w/1/q"])  # syncs the new route
    got = tr.match_filters_finish(p)
    tr.match_filters_finish(p2)
    after = [set(tr.match_filters(t)) for t in topics]
    assert tr.telemetry.counters["hash_overflow_retries_total"] >= 1
    for b, g, a in zip(before, got, after):
        assert b <= set(g) <= a


# (use_hash_index, class_budget): the dense-only leg, the residual dense
# leg (the one class goes to "a/+/x", so the swapped filters are
# residual), and the hash leg
IN_FLIGHT_CASES = [(False, 256), (True, 1), (True, 256)]


@pytest.mark.parametrize("use_hash_index,class_budget", IN_FLIGHT_CASES)
def test_routes_changed_in_flight_are_never_misnamed(use_hash_index, class_budget):
    """Delete routes and add different ones while a batch is in flight:
    the free lists hand the deleted filters' rows and buckets to the new
    filters, and the next begin's sync rewrites them on the device. The
    batch must report every filter routed from its begin to its finish,
    and only filters that match the topic and were routed at its begin
    or at its finish."""
    tr = TR.Router(max_levels=6, device="cpu", use_hash_index=use_hash_index)
    if use_hash_index:
        tr.index.class_budget = class_budget
        tr.index._class_free = list(range(class_budget - 1, -1, -1))
    tr.add_route("a/+/x", "keep")
    old = [f"a/{i}/+" for i in range(40)]
    tr.add_routes([(f, "n") for f in old])
    if use_hash_index and class_budget == 1:
        assert len(tr.index.residual_rows) == len(old)
    topics = [f"a/{i}/x" for i in range(40)]
    before = [set(tr.match_filters(t)) for t in topics]
    p = tr.match_filters_begin(topics)
    for i, f in enumerate(old):
        tr.delete_route(f, "n")
        if i % 2 == 0:  # half the freed ids are taken by other filters
            tr.add_route(f"b/{i}/+", "n")
    p2 = tr.match_filters_begin(topics)  # syncs the changes in place
    got = tr.match_filters_finish(p)
    after = [set(tr.match_filters(t)) for t in topics]
    for b, g, a in zip(before, got, after):
        assert len(g) == len(set(g))
        assert b & a <= set(g) <= b | a
    assert [set(g) for g in tr.match_filters_finish(p2)] == after


@pytest.mark.parametrize("rtt_s,bytes_per_s", [(1e-5, 1e9), (2e-4, 2.5e10), (5e-3, 1e12)])
def test_transfer_chunk_helpers_equal_reference(rtt_s, bytes_per_s):
    from emqx_tpu.ops import transfer as JT
    from emqx_tpu_torch.ops import transfer as TT

    kb = TT.auto_chunk_kb(rtt_s, bytes_per_s)
    assert kb == JT.auto_chunk_kb(rtt_s, bytes_per_s)
    assert TT.chunk_hits(kb) == JT.chunk_hits(kb)
    assert TT.chunk_hits(0) is None and JT.chunk_hits(0) is None


# --- (iii) device selection ---------------------------------------------------


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(device_mod.NoCudaDevice):
        TR.Router()
    with pytest.raises(device_mod.NoCudaDevice):
        TR.DeviceTable(TR.FilterTable())
    with pytest.raises(device_mod.NoCudaDevice):
        device_mod.resolve("cuda")
    assert device_mod.resolve("cpu") == CPU
    assert TR.Router(device="cpu").device == CPU


def test_missing_nvcc_raises_and_nothing_falls_back(monkeypatch, tmp_path):
    from emqx_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda _p: False)
    k = _build.KERNELS["match_ids"]
    monkeypatch.setattr(k, "_fn", None)
    with pytest.raises(_build.KernelBuildError):
        k(0)
    assert k.launches == 0


# --- import hygiene and the kernels' C ABI ---------------------------------------


def _c_params(source, symbol):
    """ctypes types of an `extern "C"` entry point's parameters."""
    import ctypes
    import re

    text = (REPO / "emqx_tpu_torch" / "ops" / "csrc" / source).read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\s*\(([^)]*)\)", text)
    assert m, f"{symbol} not found in {source}"
    out = []
    for p in m.group(1).split(","):
        p = " ".join(p.split())
        if "*" in p or "cudaStream_t" in p:
            out.append(ctypes.c_void_p)
        elif p.startswith(("long long", "const long long")):
            out.append(ctypes.c_longlong)
        else:
            assert p.startswith(("int ", "const int ")), p
            out.append(ctypes.c_int)
    return out


def test_kernel_argtypes_match_the_c_entry_points():
    from emqx_tpu_torch.ops import _build

    assert sorted(_build.KERNELS) == [
        "match_ids", "match_ids_hash", "scatter_rows", "scatter_slots"]
    for k in _build.KERNELS.values():
        assert list(k.argtypes) == _c_params(k.source, k.symbol), k.name


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = sorted((REPO / "emqx_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [
        f"{p.relative_to(REPO)}: {m}"
        for p in files
        for m in _imports(p)
        if m.split(".")[0] in ("jax", "jaxlib", "emqx_tpu")
    ]
    assert not bad, bad
