"""The port's Router and DeviceTable (emqx_tpu_torch.models.router) held
against emqx_tpu's on the same seeded routes, churn and topics; the
fused K3/K4 table sync (plain version, from one staged buffer) and the
reference-shaped wrappers against `_scatter_rows` / `_scatter_slots`;
device selection; and the port's gates: import hygiene,
byte-compilation, the kernels' C ABI and the fetch discipline.
"""

import ast
import pathlib
import py_compile
import random
import re

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


# --- (i) the K3/K4 table sync's plain versions vs the JAX scatters ------------


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


# (n_rows, n_slots, residual column, ids past the tables): rows only,
# slots only, both sides with and without the residual column; one entry
# a side, one batch, one past a batch, three batches; ids past both
# tables, which the reference drops
TABLE_SYNC_CASES = [
    (40, 0, True, 0), (0, 40, False, 0), (30, 50, True, 0), (30, 50, False, 0),
    (1, 1, True, 0), (1024, 1024, True, 0), (1025, 1025, False, 0),
    (3000, 3000, True, 0), (20, 30, True, 2),
]


@pytest.mark.parametrize("n_rows,n_slots,with_residual,past", TABLE_SYNC_CASES)
def test_table_sync_ref_equals_reference(n_rows, n_slots, with_residual, past):
    """The fused sync's plain version, from one unpadded staged buffer,
    against the reference's `_scatter_rows` then `_scatter_slots` on the
    same ids padded by pad_pow2_batches, as DeviceTable.sync stages them;
    the residual mask against the reference mask with the rows' bytes
    written."""
    rng = np.random.default_rng(n_rows * 7 + n_slots + past + with_residual)
    n_cap, levels, s_cap = 4096, 6, 8192
    # host truth, with room past the device tables for the ids past them
    host = TR.EncodedFilters(
        rng.integers(0, 1 << 20, (n_cap + 16, levels)).astype(np.int32),
        rng.integers(0, levels + 1, n_cap + 16).astype(np.int32),
        rng.random(n_cap + 16) < 0.5, rng.random(n_cap + 16) < 0.5,
        rng.random(n_cap + 16) < 0.5)
    hslots = SlotArrays(
        rng.integers(0, 1 << 32, s_cap + 64, dtype=np.uint64).astype(np.uint32),
        rng.integers(-1, 1 << 20, s_cap + 64).astype(np.int32),
        rng.integers(0, 1 << 32, (s_cap + 64) // 4, dtype=np.uint64).astype(np.uint32))
    host_res = rng.random(n_cap + 16) < 0.3
    dev0 = [rng.integers(0, 1 << 20, (n_cap, levels)).astype(np.int32),
            rng.integers(0, levels + 1, n_cap).astype(np.int32),
            rng.random(n_cap) < 0.5, rng.random(n_cap) < 0.5, rng.random(n_cap) < 0.5]
    slots0 = [rng.integers(0, 1 << 32, s_cap, dtype=np.uint64).astype(np.uint32),
              rng.integers(-1, 1 << 20, s_cap).astype(np.int32),
              rng.integers(0, 1 << 32, s_cap // 4, dtype=np.uint64).astype(np.uint32)]
    res0 = rng.random(n_cap) < 0.3

    def ids(n, cap, room):
        got = rng.choice(cap, n - past if n else 0, replace=False)
        extra = cap + rng.choice(room, past if n else 0, replace=False)
        return np.sort(np.concatenate([got, extra])).astype(np.int32)

    rows, sids = ids(n_rows, n_cap, 16), ids(n_slots, s_cap, 64)
    want = JR.EncodedFilters(*(jnp.asarray(a) for a in dev0))
    if len(rows):
        idx = pad_pow2_batches(rows, TR.SYNC_BATCH_SIZE)
        want = JR._scatter_rows(want, jnp.asarray(idx), *(jnp.asarray(c[idx]) for c in host))
    want_slots = JH.SlotArrays(*(jnp.asarray(a) for a in slots0))
    if len(sids):
        idx = pad_pow2_batches(sids, TR.SYNC_BATCH_SIZE)
        want_slots = JR._scatter_slots(
            want_slots, jnp.asarray(idx), jnp.asarray(hslots.fp[idx]),
            jnp.asarray(hslots.bucket[idx]), jnp.asarray(hslots.probe[idx // JH.BUCKET_W]))
    want_res = res0.copy()
    inside = rows[rows < n_cap]
    want_res[inside] = host_res[inside]
    residual_rows = {int(r) for r in np.flatnonzero(host_res)}
    staged = TR.stage_table_delta(host, rows, hslots, sids, residual_rows, CPU)
    assert staged.shape == (TR.table_delta_layout(len(rows), levels, len(sids))[2],)
    for fn in (TR.table_sync_ref, TR.table_sync):
        dev = EncodedFilters(*(_t(a) for a in dev0))
        slots = SlotArrays(*(_t(a) for a in slots0))
        res = _t(res0) if with_residual else None
        fn(dev, slots, res, staged, len(rows), len(sids))
        for g, w in zip(dev, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for g, w in zip(slots, want_slots):
            np.testing.assert_array_equal(g.view(torch.int32).numpy(),
                                          np.asarray(w).view(np.int32))
        if with_residual:
            np.testing.assert_array_equal(res.numpy(), want_res)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_table_sync_refuses_negative_counts(device):
    """A negative count would point the slot columns before the staged
    buffer; the wrapper refuses it on either path."""
    d = torch.device(device)
    dev = EncodedFilters(torch.zeros((8, 4), dtype=torch.int32, device=d),
                         torch.zeros(8, dtype=torch.int32, device=d),
                         *(torch.zeros(8, dtype=torch.bool, device=d) for _ in range(3)))
    slots = SlotArrays(torch.zeros(16, dtype=torch.uint32, device=d),
                       torch.zeros(16, dtype=torch.int32, device=d),
                       torch.zeros(4, dtype=torch.uint32, device=d))
    staged = torch.zeros(64, dtype=torch.uint8, device=d)
    with pytest.raises(ValueError, match="negative"):
        TR.table_sync(dev, slots, None, staged, -1, 4)
    with pytest.raises(ValueError, match="no slot arrays"):
        TR.table_sync(dev, None, None, staged, 0, 4)


@pytest.mark.parametrize("which", ["table_sync", "scatter_rows", "scatter_slots"])
def test_failed_table_sync_build_raises_without_plain_fallback(which, monkeypatch, tmp_path):
    """The table sync and both reference-shaped wrappers reach the one
    fused kernel; when it fails to build they raise, and no plain
    version runs in its place."""
    from emqx_tpu_torch.ops import _build

    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 1\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    # meta tensors stand in for CUDA ones, with a stand-in stream
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda _d=None: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", None, raising=False)
    k = _build.KERNELS["table_sync"]
    monkeypatch.setattr(k, "_fn", None)

    def _never(*_a, **_k):
        raise AssertionError("plain version ran in place of the kernel")

    for name in ("table_sync_ref", "scatter_rows_ref", "scatter_slots_ref"):
        monkeypatch.setattr(TR, name, _never)
    meta = torch.device("meta")

    def z(shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=meta)

    dev = EncodedFilters(z((8, 4)), z(8), z(8, torch.bool), z(8, torch.bool), z(8, torch.bool))
    slots = SlotArrays(z(16, torch.uint32), z(16), z(4, torch.uint32))
    with pytest.raises(_build.KernelBuildError, match="no sm_90a"):
        if which == "table_sync":
            n_bytes = TR.table_delta_layout(2, 4, 3)[2]
            TR.table_sync(dev, slots, z(8, torch.bool), z(n_bytes, torch.uint8), 2, 3)
        elif which == "scatter_rows":
            b = z((1, 4), torch.bool)
            TR.scatter_rows(dev, z((1, 4)), z((1, 4, 4)), z((1, 4)), b, b, b)
        else:
            TR.scatter_slots(slots, z((1, 4)), z((1, 4), torch.uint32), z((1, 4)),
                             z((1, 4), torch.uint32))
    assert k.launches == 0


def _churn_tables(jt, jix, tt, tix, rng, n_add, n_del, words):
    """The same seeded churn on the reference's and the port's table and
    class index: n_del live rows removed, n_add filters added (many past
    the class budget, so residual rows come and go)."""
    live = [r for r in range(tt.capacity) if tt.active[r]]
    for r in sorted(rng.sample(live, min(n_del, len(live)))):
        for t, ix in ((jt, jix), (tt, tix)):
            ix.remove_row(r)
            t.remove(r)
    for _ in range(n_add):
        f = random_filter(rng, vocab=words)
        rows = [t.add(f) for t in (jt, tt)]
        assert rows[0] == rows[1]
        jix.add_row(rows[0], jt)
        tix.add_row(rows[1], tt)


def test_device_table_syncs_equal_reference(monkeypatch):
    """A port DeviceTable on the CPU beside the reference DeviceTable over
    seeded churn that adds and removes residual rows (a class budget of
    6): after every sync the rows, the class metadata, the slot arrays
    and the residual mask equal the reference's, and the shape buckets
    of both telemetries are the same. A delta sync with no growth or
    rebuild is one host->device copy and one table_sync call (plus the
    metadata's five columns when they changed) and leaves the mask
    tensor in place; a sync with only dirty slots is one of each too;
    growth re-uploads; nothing dirty copies and calls nothing."""
    from emqx_tpu.obs.kernel_telemetry import KernelTelemetry as JTel
    from emqx_tpu.ops.hash_index import ClassIndex as JClassIndex
    from emqx_tpu_torch.obs.kernel_telemetry import KernelTelemetry as TTel
    from emqx_tpu_torch.ops.hash_index import ClassIndex as TClassIndex
    from emqx_tpu_torch.ops.table import FilterTable as TFilterTable

    copies, calls = [], []
    real_put, real_sync = TR.to_device, TR.table_sync

    def put(a, device):
        copies.append(np.asarray(a).nbytes)
        return real_put(a, device)

    def sync(*a):
        calls.append(a[-2:])
        real_sync(*a)

    monkeypatch.setattr(TR, "to_device", put)
    monkeypatch.setattr(TR, "table_sync", sync)
    rng = random.Random(3)
    words = tuple(f"w{k}" for k in range(40)) + ("",)
    jt, tt = JFilterTable(max_levels=6, capacity=256), TFilterTable(max_levels=6, capacity=256)
    jix, tix = JClassIndex(6, class_budget=6, min_slots=512), TClassIndex(6, class_budget=6, min_slots=512)
    jtel, ttel = JTel(), TTel()
    jdt = JR.DeviceTable(jt, index=jix, telemetry=jtel)
    tdt = TR.DeviceTable(tt, device="cpu", index=tix, telemetry=ttel)

    def held():
        for g, w, h in zip(tdt.filters(), jdt.filters(), tt.snapshot()):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            np.testing.assert_array_equal(g.numpy(), h)
        for tpart, jpart in zip(tdt.hash_state(), jdt.hash_state()):
            for g, w in zip(tpart, jpart):
                np.testing.assert_array_equal(g.numpy().view(np.int32) if g.dtype == torch.uint32
                                              else g.numpy(),
                                              np.asarray(w).view(np.int32)
                                              if np.asarray(w).dtype == np.uint32 else np.asarray(w))
        mask = np.zeros(tt.capacity, bool)
        mask[list(tix.residual_rows)] = True
        np.testing.assert_array_equal(tdt._dev_residual.numpy(), np.asarray(jdt._dev_residual))
        np.testing.assert_array_equal(tdt._dev_residual.numpy(), mask)
        j_keys = {k.lstrip("_"): v for k, v in jtel._shape_keys.items()}
        assert ttel._shape_keys == j_keys
        assert ttel.counters.get("recompiles_total") == jtel.counters.get("recompiles_total")

    _churn_tables(jt, jix, tt, tix, rng, 150, 0, words)
    assert tdt.sync() == jdt.sync()  # the first sync is a full upload
    assert calls == [] and tix.residual_rows
    held()
    deltas = flips = 0
    for k, (n_add, n_del) in enumerate([(40, 30), (30, 40), (1, 0), (60, 60), (200, 20),
                                        (0, 50), (45, 45)]):
        _churn_tables(jt, jix, tt, tix, rng, n_add, n_del, words)
        grew, rebuilt, meta = tt.grew, tix.rebuilt, tix.meta_dirty
        n_r, n_s = len(set(tt.dirty)), len(set(tix.dirty_slots))
        mask_before = tdt._dev_residual
        was = mask_before.clone()
        del copies[:], calls[:]
        assert tdt.sync() == jdt.sync()
        held()
        if grew:  # a growth sync: rows and mask whole, the slots' delta launched
            assert tdt._dev_residual is not mask_before and 5 + 1 <= len(copies)
            continue
        deltas += not rebuilt
        flips += not np.array_equal(was.numpy(), tdt._dev_residual.numpy())
        assert tdt._dev_residual is mask_before  # updated in place
        assert calls == [(n_r, 0 if rebuilt else n_s)]
        assert len(copies) == 1 + 5 * meta + 3 * rebuilt, (k, copies)
    assert deltas >= 4 and flips >= 3
    # dirty slots and no dirty rows (a cuckoo kick alone): one of each
    live = np.flatnonzero(tix.slots.bucket >= 0)[:7].tolist()
    for ix in (jix, tix):
        ix.dirty_slots.extend(live)
    del copies[:], calls[:]
    assert tdt.sync() == jdt.sync() == 0
    assert calls == [(0, len(live))] and len(copies) == 1
    held()
    # nothing dirty: no copy, no launch
    del copies[:], calls[:]
    assert tdt.sync() == jdt.sync() == 0
    assert calls == [] and copies == []
    held()


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


def test_sticky_hash_bound_escalates_once_across_batches():
    """An overflow raises the hash leg's first bound for later batches
    (the mesh's sticky floor): a second batch of the same shape runs at
    the escalated bound and does not re-launch. Both batches equal the
    reference router's answers."""
    jr = JR.Router(max_levels=4)
    tr = TR.Router(max_levels=4, device="cpu")
    pairs = [(f"w/{i}/+", f"m{i}") for i in range(2000)]
    pairs += [(f, f"s{k}") for k, f in enumerate(
        ["w/+/q", "+/+/q", "+/+/+", "w/#", "+/#", "#", "w/+/#"])]
    jr.add_routes(pairs)
    tr.add_routes(pairs)
    first = [f"w/{i}/q" for i in range(1500)]
    assert tr.match_batch(first) == jr.match_batch(first)
    c = tr.telemetry.counters
    assert c["hash_overflow_retries_total"] == 1
    floor = tr.device_table._hash_mh_floor
    assert floor > 1024 * 2 and floor & (floor - 1) == 0
    second = [f"w/{i}/q" for i in range(500, 2000)]
    assert tr.match_batch(second) == jr.match_batch(second)
    assert c["hash_overflow_retries_total"] == 1
    assert tr.device_table._hash_mh_floor == floor


def test_pipelined_batches_escalate_once_from_a_landed_overflow():
    """Two batches in flight from a cold floor: the second begins after
    the first one's overflowing count has landed, so it launches at the
    bound the first needed; only the first escalates (at its finish).
    Both equal the reference router's answers."""
    jr = JR.Router(max_levels=4)
    tr = TR.Router(max_levels=4, device="cpu")
    pairs = [(f"w/{i}/+", f"m{i}") for i in range(2000)]
    pairs += [(f, f"s{k}") for k, f in enumerate(
        ["w/+/q", "+/+/q", "+/+/+", "w/#", "+/#", "#", "w/+/#"])]
    jr.add_routes(pairs)
    tr.add_routes(pairs)
    batches = [[f"w/{i}/q" for i in range(k, k + 1500)] for k in (0, 300, 600)]
    pending = [tr.match_filters_begin(batches[0]), tr.match_filters_begin(batches[1])]
    assert tr.device_table._hash_mh_floor > 4096  # from batch 0's landed count
    got = [tr.match_filters_finish(pending.pop(0))]
    pending.append(tr.match_filters_begin(batches[2]))
    got += [tr.match_filters_finish(p) for p in pending]
    for topics, g in zip(batches, got):
        assert [sorted(x) for x in g] == [sorted(x) for x in jr.match_filters_batch(topics)]
    assert tr.telemetry.counters["hash_overflow_retries_total"] == 1


def test_amb_host_fallbacks_under_churn_equal_reference(monkeypatch):
    """Phase 5's churn in small: batches pipelined two deep, with
    skeleton filters swapped for a twin (which takes the freed row and
    bucket) while the previous batch is in flight. The amb host
    fallbacks — pairs with more than two byte-matching lanes, or two
    verified ones — come from the data, not the port: both routers
    count the same ones, batch for batch, and give the same answers
    wherever no route of the topic changed in flight (elsewhere the
    port's answer lies between the host truth at begin and at finish).
    Both run their Python twins of the native route core, which
    interns words in another order (other word ids give other byte
    coincidences): the reference's through its loader, the port's
    through its setter."""
    from emqx_tpu.ops import speedups as JS
    from emqx_tpu_torch.ops import speedups as TS

    monkeypatch.setattr(JS, "load", lambda build=True: None)
    TS.set_native_enabled(False)
    try:
        _amb_host_fallbacks_under_churn()
    finally:
        TS.set_native_enabled(True)


def _amb_host_fallbacks_under_churn():
    rng = random.Random(0)
    n = 5800
    routes = []
    for i in range(n):
        routes += [(f"s/{i}/+", "a"), (f"s/+/{i}", "b"), (f"s/{i}/#", "c"),
                   (f"+/{i}/{i % 7}", "d")]
    skel = [f"k{j}/+/x{j % 5}/+" for j in range(60)] + [f"k{j}/+/#" for j in range(60)]
    routes += [(f, "s") for f in skel]
    jr = JR.Router(max_levels=6)
    tr = TR.Router(max_levels=6, device="cpu")
    jr.add_routes(routes)
    tr.add_routes(routes)
    assert np.array_equal(jr.table.words, tr.table.words)

    def twin(f):
        ws = f.split("/")
        ws[max(k for k, w in enumerate(ws) if w not in ("+", "#"))] += "z"
        return "/".join(ws)

    pending = []
    falls = []

    def finish():
        topics, before, jp, tp = pending.pop(0)
        got = tr.match_filters_finish(tp)
        want = jr.match_filters_finish(jp)
        for t, g, w, b in zip(topics, got, want, before):
            a = set(tr.match_filters(t))
            assert b & a <= set(g) <= b | a
            if a == b:  # no route of the topic changed in flight
                assert sorted(g) == sorted(w)
        falls.append(tuple(r.telemetry.counters.get("host_fallback_total", 0)
                           for r in (jr, tr)))

    for _ in range(24):
        topics = [f"s/{rng.randrange(n)}/{rng.randrange(n)}" for _ in range(250)]
        topics += [f"k{rng.randrange(60)}/v/x{rng.randrange(5)}/w" for _ in range(20)]
        before = [set(tr.match_filters(t)) for t in topics]
        pending.append((topics, before, jr.match_filters_begin(topics),
                        tr.match_filters_begin(topics)))
        for j in rng.sample(range(len(skel)), 10):
            f = skel[j]
            old, new = (f, twin(f)) if tr.has_route(f, "s") else (twin(f), f)
            for r in (jr, tr):
                r.delete_route(old, "s")
                r.add_route(new, "s")
        if len(pending) == 2:
            finish()
    while pending:
        finish()
    assert all(a == b for a, b in falls), falls
    assert falls[-1][1] > 0  # the sequence reaches the fallback
    for r in (jr, tr):
        c = r.telemetry.counters
        assert c["ambiguous_batches_total"] == c["host_fallback_total"] == falls[-1][1]
        assert c.get("hash_overflow_retries_total", 0) == 0


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

    import emqx_tpu_torch.broker.pubsub  # noqa: F401  (every kernel module)

    assert sorted(_build.KERNELS) == [
        "combine_pairs", "combine_probe", "fanout_sync", "match_counts",
        "match_dense", "match_ids", "match_ids_hash", "match_packed",
        "mesh_match_counts", "mesh_match_ids", "mesh_match_ids_hash",
        "mesh_match_packed", "mesh_table_sync", "probe_add_one",
        "resolve_fanout", "retained_probe", "table_sync"]
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
    names = {str(p.relative_to(REPO)) for p in files}
    for mod in ("ops/fanout.py", "broker/pubsub.py", "broker/dispatch_engine.py",
                "broker/session.py", "models/retainer.py", "ops/retained.py",
                "broker/channel.py", "broker/server.py", "parallel/mesh.py",
                "parallel/sharded_match.py", "convert.py"):
        assert f"emqx_tpu_torch/{mod}" in names, mod
    bad = [
        f"{p.relative_to(REPO)}: {m}"
        for p in files
        for m in _imports(p)
        if m.split(".")[0] in ("jax", "jaxlib", "emqx_tpu")
    ]
    assert not bad, bad


def test_every_port_module_byte_compiles(tmp_path):
    files = sorted((REPO / "emqx_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for i, p in enumerate(files):
        py_compile.compile(str(p), cfile=str(tmp_path / f"{i}.pyc"), doraise=True)


# --- the fetch discipline (tests/test_static_gate.py legs 7 and 7b) -----------------
# The reference's allowlist of the functions that may force a device->host
# transfer, applied to the port's modules of the same names. Besides the
# reference's fetch kinds, the torch ones: .cpu(), .item(), .numpy() and
# .synchronize(). (.tolist() is not one: the host bookkeeping calls it on
# numpy arrays throughout.)

_TORCH_FETCHES = ("cpu", "item", "numpy", "synchronize")


def _fetch_gate():
    from test_static_gate import (
        _BEGIN_RE,
        FETCH_SITE_ALLOWLIST,
        _contains_shape_attr,
        _fetch_kind,
    )

    return FETCH_SITE_ALLOWLIST, _BEGIN_RE, _contains_shape_attr, _fetch_kind


def test_no_blocking_host_fetch_outside_finish_sites():
    allowlist, begin_re, shape_attr, fetch_kind = _fetch_gate()
    port = REPO / "emqx_tpu_torch"
    present = {rel: a for rel, a in allowlist.items() if (port / rel).exists()}
    assert "ops/retained.py" in present and "ops/fanout.py" in present
    assert "parallel/sharded_match.py" in present and "parallel/mesh.py" in present
    offenders = []
    for rel, allowed in present.items():
        stack = []

        def visit(node):
            is_fn = isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            if is_fn:
                stack.append(node.name)
            if isinstance(node, ast.Call):
                fn = stack[-1] if stack else "<module>"
                f = node.func
                kind = fetch_kind(node)
                if kind is None and isinstance(f, ast.Attribute) and f.attr in _TORCH_FETCHES:
                    kind = f".{f.attr}()"
                if kind and fn not in allowed:
                    offenders.append(f"{rel}:{node.lineno} {kind} in {fn}()")
                if (
                    any(begin_re.search(x) for x in stack)
                    and isinstance(f, ast.Name)
                    and f.id in ("int", "float")
                    and node.args
                    and not shape_attr(node.args[0])
                ):
                    offenders.append(f"{rel}:{node.lineno} {f.id}() inside launch half {fn}()")
            for child in ast.iter_child_nodes(node):
                visit(child)
            if is_fn:
                stack.pop()

        visit(ast.parse((port / rel).read_text()))
    assert not offenders, "\n  ".join(["blocking host fetch:"] + offenders)


def test_begin_halves_start_their_transfer():
    """Every kernel-level begin half launches its kernel and starts the
    device->host copy (ops/transfer.start_fetch) in the same function."""
    halves = (
        ("models/router.py", None, r"match_(ids|hash)_begin"),
        ("parallel/sharded_match.py", None, r"match_(ids|hash)_begin"),
        ("ops/fanout.py", "FanoutDeviceState", r"resolve_begin"),
        ("ops/retained.py", "RetainedIndex", r"read_begin"),
    )
    found, offenders = [], []
    for rel, cls, name_re in halves:
        tree = ast.parse((REPO / "emqx_tpu_torch" / rel).read_text())
        scopes = [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef) and n.name == cls] \
            if cls else [tree]
        for scope in scopes:
            for node in ast.walk(scope):
                if not (isinstance(node, ast.FunctionDef) and re.fullmatch(name_re, node.name)):
                    continue
                found.append(f"{rel}:{node.name}")
                calls = {
                    n.func.attr if isinstance(n.func, ast.Attribute) else getattr(n.func, "id", "")
                    for n in ast.walk(node) if isinstance(n, ast.Call)
                }
                if "start_fetch" not in calls:
                    offenders.append(f"{rel}:{node.lineno} {node.name}()")
    assert len(found) == 6, found
    assert not offenders, offenders
