"""The port's sub-sharded mesh routing path (emqx_tpu_torch.parallel) held
against emqx_tpu.parallel on the same seeded tables, churn and topics.

The JAX side runs on the 8 virtual CPU devices tests/conftest.py gives
it; the port's side on a CPU mesh of the same shape, where every kernel
wrapper takes its plain PyTorch version: `make_mesh(2, 4, devices=
["cpu"] * 8)` (every shard on one device, as on one card), and the same
mesh over the two device keys "cpu" and "cpu:0" alternating along sub
(two devices, each holding every other sub shard: the gathers copy and
results move to the first device). Every output is an integer or bool
array and compares exactly: the plain versions of K13-K18, the sharded
layout (per-shard arrays), Router(mesh=...) and Broker(mesh=...).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from emqx_tpu.broker import message as JMsg
from emqx_tpu.broker import packet as JPkt
from emqx_tpu.broker import pubsub as JB
from emqx_tpu.models.router import Router as JRouter
from emqx_tpu.ops import hash_index as JH
from emqx_tpu.ops import match as JM
from emqx_tpu.ops.table import FilterTable as JFilterTable
from emqx_tpu.parallel import mesh as JMesh
from emqx_tpu.parallel import sharded_match as JS
from emqx_tpu_torch import convert
from emqx_tpu_torch import device as device_mod
from emqx_tpu_torch.device import to_device
from emqx_tpu_torch.broker import message as TMsg
from emqx_tpu_torch.broker import packet as TPkt
from emqx_tpu_torch.broker import pubsub as TB
from emqx_tpu_torch.models.router import Router as TRouter
from emqx_tpu_torch.ops import hash_index as TH
from emqx_tpu_torch.ops import topic as TT
from emqx_tpu_torch.ops.table import FilterTable, pad_pow2_batches
from emqx_tpu_torch.parallel import mesh as TMesh
from emqx_tpu_torch.parallel import sharded_match as TS

from test_match import random_filter, random_topic

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tier-1 runs test files side by side in worker processes; keep
    torch's CPU ops to one core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the port mesh's devices, cycled along the mesh (row-major)
DEVICE_SETS = {"one_device": ["cpu"], "two_devices": ["cpu", "cpu:0"]}


def _port_mesh(n_dp, n_sub, which):
    devs = DEVICE_SETS[which]
    return TMesh.make_mesh(n_dp, n_sub, devices=[devs[k % len(devs)]
                                                 for k in range(n_dp * n_sub)])


@pytest.fixture(scope="module", params=sorted(DEVICE_SETS))
def mesh8(request):
    """(JAX mesh, port mesh), dp=2 x sub=4."""
    assert len(jax.devices()) == 8, "conftest must fake 8 CPU devices"
    return JMesh.make_mesh(n_dp=2, n_sub=4), _port_mesh(2, 4, request.param)


@pytest.fixture(scope="module", params=sorted(DEVICE_SETS))
def mesh3(request):
    """(JAX mesh, port mesh), dp=1 x sub=3: a layout that pads."""
    return (JMesh.make_mesh(n_dp=1, n_sub=3, devices=jax.devices()[:3]),
            _port_mesh(1, 3, request.param))


def _meshes(shape, devs):
    """(JAX mesh, port mesh) of a (dp, sub) shape."""
    n_dp, n_sub = shape
    jmesh = JMesh.make_mesh(n_dp=n_dp, n_sub=n_sub, devices=jax.devices()[:n_dp * n_sub])
    return jmesh, _port_mesh(n_dp, n_sub, devs)


SHAPES = {"mesh8": (2, 4), "mesh3": (1, 3)}


def _group_rows(tmesh, tiles_first):
    """Per-group parts of a per-tile array ([n_dp * n_sub, ...], tiles
    row-major), in each group's tile order."""
    n_sub = tmesh.shape["sub"]
    return [tiles_first[[i * n_sub + j for i, j in g.tiles]] for g in tmesh.groups]


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    return t.numpy()


def _eq(jax_arrays, port_tensors):
    for j, t in zip(jax_arrays, port_tensors):
        j = np.asarray(j)
        assert j.shape == tuple(t.shape), (j.shape, tuple(t.shape))
        assert np.array_equal(j, _np(t))


def _twin_tables(seed, n_filters, capacity=1024, max_levels=6):
    rng = random.Random(seed)
    jt = JFilterTable(max_levels=max_levels, capacity=capacity)
    tt = FilterTable(max_levels=max_levels, capacity=capacity)
    for _ in range(n_filters):
        f = random_filter(rng)
        assert jt.add(f) == tt.add(f)
    for f in ("a/#", "$SYS/#", "+/+/+", "#"):
        jt.add(f)
        tt.add(f)
    topics = [random_topic(rng) for _ in range(45)] + ["$SYS/y", "a", "b"]
    return jt, tt, topics


def _twin_indexed(seed, n_filters, capacity=1024, max_levels=6, class_budget=256):
    """Twin tables with twin class indexes, fed the same adds."""
    rng = random.Random(seed)
    jt = JFilterTable(max_levels=max_levels, capacity=capacity)
    tt = FilterTable(max_levels=max_levels, capacity=capacity)
    jix = JH.ClassIndex(max_levels, class_budget=class_budget)
    tix = TH.ClassIndex(max_levels, class_budget=class_budget)
    filters = sorted({random_filter(rng) for _ in range(n_filters)})
    for f in filters:
        jr, tr = jt.add(f), tt.add(f)
        assert jr == tr
        jix.add_row(jr, jt)
        tix.add_row(tr, tt)
    topics = [random_topic(rng) for _ in range(45)] + ["$SYS/y", "a", "b"]
    return jt, tt, jix, tix, topics


def _jshards(arr, jmesh):
    """(dp, sub) -> numpy shard of a JAX array on the mesh."""
    pos = {d.id: ij for ij, d in np.ndenumerate(np.asarray(jmesh.devices))}
    return {pos[s.device.id]: np.asarray(s.data) for s in arr.addressable_shards}


def _port_shard(parts, tmesh, dp_i, sub_i):
    return _np(TMesh.shard(parts, tmesh, dp_i, sub_i))


def _assert_layout(jdt, tdt, jmesh, tmesh):
    """Every (dp, sub) shard of the JAX ShardedDeviceTable's filters,
    slots and residual mask, and the replicated class meta, equal the
    port table's."""
    n_dp, n_sub = tmesh.shape["dp"], tmesh.shape["sub"]
    pairs = list(zip(jdt._dev, zip(*tdt._dev)))
    if jdt._dev_slots is not None:
        pairs += list(zip(jdt._dev_slots, zip(*tdt._dev_slots)))
        pairs.append((jdt._dev_residual, tdt._dev_residual))
    for jarr, tparts in pairs:
        js = _jshards(jarr, jmesh)
        for i in range(n_dp):
            for j in range(n_sub):
                assert np.array_equal(js[(i, j)], _port_shard(tparts, tmesh, i, j))
    if jdt._dev_meta is not None:
        for jarr, tparts in zip(jdt._dev_meta, zip(*tdt._dev_meta)):
            for t in tparts:
                assert np.array_equal(np.asarray(jarr), _np(t))


# --- the mesh -------------------------------------------------------------------


def test_make_mesh_defaults_and_layout(monkeypatch):
    m = TMesh.make_mesh(devices=["cpu"] * 8)
    assert m.shape == {"dp": 1, "sub": 8}  # default: shard the table
    assert TMesh.make_mesh(n_sub=2, devices=["cpu"] * 8).shape == {"dp": 4, "sub": 2}
    assert TMesh.make_mesh(n_dp=2, devices=["cpu"] * 8).shape == {"dp": 2, "sub": 4}
    with pytest.raises(ValueError):
        TMesh.make_mesh(n_sub=3, devices=["cpu"] * 8)
    m3 = TMesh.make_mesh(1, 3, devices=["cpu"] * 3)
    assert TMesh.shard_rows(512, m3) == 171 == JMesh.shard_rows(
        512, JMesh.make_mesh(1, 3, devices=jax.devices()[:3]))
    # eight shards on one device: one group, every tile, row-major
    (g,) = TMesh.make_mesh(2, 4, devices=["cpu"] * 8).groups
    assert g.tiles == tuple((i, j) for i in range(2) for j in range(4))
    assert TMesh.primary_device(m) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(device_mod.NoCudaDevice):
        TMesh.make_mesh()
    with pytest.raises(device_mod.NoCudaDevice):
        TMesh.make_mesh(2, 4, devices=["cuda:0"] * 8)


def test_topic_padding(mesh8):
    jmesh, tmesh = mesh8
    jt, tt, _ = _twin_tables(0, 8)
    topics = ["a/1/x", "a/2/x", "a/3/x"]  # 3 does not divide dp=2
    enc = JM.encode_topics(jt.vocab, topics, jt.max_levels)
    t_dev = TMesh.put_topics(enc, tmesh)
    assert t_dev[0].ids.shape[0] == 4 and bool(t_dev[0].dollar[3])
    jc, _, _ = JS.make_sharded_kernels(jmesh)
    tc, _, _ = TS.make_sharded_kernels(tmesh)
    want = np.asarray(jc(JMesh.put_filters(jt.snapshot(), jmesh), JMesh.put_topics(enc, jmesh)))
    got = tc(TMesh.put_filters(tt.snapshot(), tmesh), t_dev)
    assert np.array_equal(want, got.numpy())
    assert int(got[3]) == 0  # the pad row matches nothing


# --- K13: counts, packed, apply_delta -----------------------------------------------


@pytest.mark.parametrize("seed", [1, 2])
def test_sharded_counts_and_packed_equal_reference(mesh8, seed):
    jmesh, tmesh = mesh8
    jt, tt, topics = _twin_tables(seed, 300)
    enc = JM.encode_topics(jt.vocab, topics, jt.max_levels)
    jc, jp, _ = JS.make_sharded_kernels(jmesh)
    tc, tp, _ = TS.make_sharded_kernels(tmesh)
    fj, tj = JMesh.put_filters(jt.snapshot(), jmesh), JMesh.put_topics(enc, jmesh)
    ft, t_t = TMesh.put_filters(tt.snapshot(), tmesh), TMesh.put_topics(enc, tmesh)
    _eq([jc(fj, tj), jp(fj, tj)], [tc(ft, t_t), tp(ft, t_t)])
    counts = tc(ft, t_t).numpy()[: len(topics)]
    packed = _np(tp(ft, t_t))[: len(topics)]
    for i, rows in enumerate(JM.oracle_match_rows(jt, topics)):
        assert counts[i] == len(rows)
        assert np.array_equal(JM.unpack_indices(packed[i]), rows)


@pytest.mark.parametrize("n_churn", [2, 1500])
def test_sharded_apply_delta_equals_reference(mesh8, n_churn):
    """Deltas padded with repeats of the last dirty id (one batch of 16,
    or two of 1024 over every shard) land as the reference's do."""
    jmesh, tmesh = mesh8
    jt, tt, topics = _twin_tables(3, 200, capacity=2048)
    _, _, japply = JS.make_sharded_kernels(jmesh)
    tc, _, tapply = TS.make_sharded_kernels(tmesh)
    fj = JMesh.put_filters(jt.snapshot(), jmesh)
    ft = TMesh.put_filters(tt.snapshot(), tmesh)
    jt.drain_dirty()
    tt.drain_dirty()
    rng = random.Random(n_churn)
    live = list(jt.rows())
    for r in rng.sample(live, min(len(live) // 2, n_churn // 2 + 1)):
        jt.remove(r)
        tt.remove(r)
    while len(jt.dirty) < n_churn:
        f = random_filter(rng)
        assert jt.add(f) == tt.add(f)
    dirty = jt.drain_dirty()
    assert np.array_equal(dirty, tt.drain_dirty())
    idx = pad_pow2_batches(dirty, 16 if n_churn < 16 else 1024)
    assert idx[-1, -1] == dirty[-1]  # padded with repeats
    cols = [idx, jt.words[idx], jt.prefix_len[idx], jt.has_hash[idx],
            jt.root_wild[idx], jt.active[idx]]
    fj = japply(fj, *(jnp.asarray(c) for c in cols))
    ft = tapply(ft, *cols)
    for jarr, tparts, h in zip(fj, zip(*ft), jt.snapshot()):
        assert np.array_equal(np.asarray(jarr), h)  # == host truth
        for (i, j), a in _jshards(jarr, jmesh).items():
            assert np.array_equal(a, _port_shard(tparts, tmesh, i, j))
    enc = JM.encode_topics(jt.vocab, topics, jt.max_levels)
    counts = tc(ft, TMesh.put_topics(enc, tmesh)).numpy()[: len(topics)]
    assert list(counts) == [len(e) for e in JM.oracle_match_rows(jt, topics)]


# --- K14 / K15: the combine --------------------------------------------------------


def _jax_combine(jmesh, a, b, cnt, mh):
    """The reference's `_combine_pairs` and psum'd total, inside
    shard_map over per-tile buffers a, b [n_dp, n_sub * mh], cnt
    [n_dp, n_sub]."""

    def local(a, b, c):
        ca, cb = JS._combine_pairs(a.reshape(-1), b.reshape(-1), lambda t: t >= 0, mh)
        tot = jax.lax.psum(c.reshape(()), "sub")
        return ca[None, :], cb[None, :], tot.reshape(1, 1)

    f = jax.jit(JS._shard_map_unchecked(
        local, mesh=jmesh, in_specs=(JP("dp", "sub"),) * 3,
        out_specs=(JP("dp", None),) * 3,
    ))
    return f(jnp.asarray(a), jnp.asarray(b), jnp.asarray(cnt))


# (seed, mh, fill): fill = share of each tile's buffer that is valid
COMBINE_CASES = [(0, 16, 0.3), (1, 16, 0.9), (2, 64, 0.05), (3, 8, 0.0)]


@pytest.mark.parametrize("seed,mh,fill", COMBINE_CASES)
def test_combine_pairs_equals_reference(mesh8, seed, mh, fill):
    """Valid entries with holes; with fill 0.9 the four shards' valid
    entries exceed mh (the result truncates in sub-major order)."""
    jmesh, tmesh = mesh8
    rng = np.random.default_rng(seed)
    n_dp, n_sub = 2, 4
    valid = rng.random((n_dp, n_sub, mh)) < fill
    a = np.where(valid, rng.integers(0, 1000, valid.shape), -1).astype(np.int32)
    b = np.where(valid, rng.integers(0, 1 << 20, valid.shape), -1).astype(np.int32)
    cnt = (valid.sum(-1) + rng.integers(0, 3, (n_dp, n_sub))).astype(np.int32)
    want = _jax_combine(jmesh, a.reshape(n_dp, -1), b.reshape(n_dp, -1), cnt, mh)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    parts = zip(*(_group_rows(tmesh, t(x)) for x in (
        a.reshape(-1, mh), b.reshape(-1, mh), cnt.reshape(-1))))
    got = TS._combine_pairs(tmesh, [tuple(x.to(g.device) for x in p)
                                    for p, g in zip(parts, tmesh.groups)], mh)
    _eq(want, got)
    if fill > 0.5:
        assert int(valid[0].sum()) > mh


# K14's edges: (case, layout, mh); each case builds its own valid mask
COMBINE_EDGES = [
    ("mh1", "mesh8", 1),  # one slot a block: the first valid entry only
    ("last_shard", "mesh8", 16),  # every valid entry in the last sub shard
    ("counts_above", "mesh8", 16),  # counts above the valid entries (exact totals)
    ("all_invalid", "mesh8", 16),  # nothing valid: all -1, totals still summed
    ("scattered", "mesh8", 64),  # valid entries spread, not a compacted prefix
    ("cut", "mesh8", 16),  # more valid entries than mh: cut in sub-major order
    ("padded13", "mesh3", 16),  # the padded (1, 3) layout, n_dp = 1
]


@pytest.mark.parametrize("devs", sorted(DEVICE_SETS))
@pytest.mark.parametrize("case,layout,mh", COMBINE_EDGES)
def test_combine_pairs_edges_equal_reference(case, layout, mh, devs):
    jmesh, tmesh = _meshes(SHAPES[layout], devs)
    n_dp, n_sub = SHAPES[layout]
    rng = np.random.default_rng(len(case) * 7 + mh)
    shape = (n_dp, n_sub, mh)
    valid = rng.random(shape) < {"cut": 0.9, "scattered": 0.1}.get(case, 0.5)
    if case == "last_shard":
        valid[:, :-1] = False
    elif case == "all_invalid":
        valid[:] = False
    a = np.where(valid, rng.integers(0, 1000, shape), -1).astype(np.int32)
    b = np.where(valid, rng.integers(0, 1 << 20, shape), -1).astype(np.int32)
    cnt = valid.sum(-1).astype(np.int32)
    if case == "counts_above":
        cnt += rng.integers(1, 4, cnt.shape).astype(np.int32)
    want = _jax_combine(jmesh, a.reshape(n_dp, -1), b.reshape(n_dp, -1), cnt, mh)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    parts = zip(*(_group_rows(tmesh, t(x)) for x in (
        a.reshape(-1, mh), b.reshape(-1, mh), cnt.reshape(-1))))
    got = TS._combine_pairs(tmesh, [tuple(x.to(g.device) for x in p)
                                    for p, g in zip(parts, tmesh.groups)], mh)
    _eq(want, got)
    per_block = valid.reshape(n_dp, -1).sum(1)
    if case == "cut":
        assert (per_block > mh).all()
    if case == "scattered":
        # not a prefix: some shard has a hole before a valid entry
        assert any(not v[:v.sum()].all() for v in valid.reshape(-1, mh))
    if case == "all_invalid":
        assert (np.asarray(want[0]) == -1).all()


@pytest.mark.parametrize("salt", [0, 7, -2, 1_500_000_000])
def test_combine_probe_equals_reference(mesh8, salt):
    """-2 makes sub 0's entry -1 (invalid); 1.5e9 wraps salt * 2 + 1."""
    jmesh, tmesh = mesh8
    mh = 32
    want = JS.make_combine_probe_kernel(jmesh, mh)(jnp.int32(salt))
    got = TS.make_combine_probe_kernel(tmesh, mh)(salt)
    _eq(want, got)


# --- K16: the sharded dense compaction ---------------------------------------------


# (seed, mh, residual, mesh): mesh3 pads 1024 rows to 3 x 342
IDS_CASES = [(4, 4096, False, "mesh8"), (5, 16, False, "mesh8"), (6, 4096, True, "mesh8"),
             (7, 8, True, "mesh8"), (14, 4096, False, "mesh3"), (15, 8, True, "mesh3")]


@pytest.mark.parametrize("devs", sorted(DEVICE_SETS))
@pytest.mark.parametrize("seed,mh,residual,which", IDS_CASES)
def test_match_ids_kernel_equals_reference(seed, mh, residual, which, devs):
    jmesh, tmesh = _meshes(SHAPES[which], devs)
    jt, tt, topics = _twin_tables(seed, 400)
    snap = jt.snapshot()
    if residual:
        mask = snap.active & (np.random.default_rng(seed).random(len(snap.active)) < 0.5)
        snap = snap._replace(active=mask)
    enc = JM.encode_topics(jt.vocab, topics, jt.max_levels)
    want = JS.make_match_ids_kernel(jmesh, mh)(
        JMesh.put_filters(snap, jmesh), JMesh.put_topics(enc, jmesh))
    got = TS.make_match_ids_kernel(tmesh, mh)(
        TMesh.put_filters(snap, tmesh), TMesh.put_topics(enc, tmesh))
    _eq(want, got)
    if mh < 64:
        assert int(got[2].max()) > mh  # the overflow case really overflows


# --- K17: the sharded hash probe -------------------------------------------------


def _synced(jt, tt, jix, tix, jmesh, tmesh):
    jdt = JS.ShardedDeviceTable(jt, jmesh, index=jix)
    tdt = TS.ShardedDeviceTable(tt, tmesh, index=tix)
    jdt.sync()
    tdt.sync()
    return jdt, tdt


# (seed, mh, mesh)
HASH_CASES = [(8, 4096, "mesh8"), (9, 8, "mesh8"), (10, 4096, "mesh3"), (11, 16, "mesh3")]


@pytest.mark.parametrize("devs", sorted(DEVICE_SETS))
@pytest.mark.parametrize("seed,mh,which", HASH_CASES)
def test_sharded_hash_kernel_equals_reference(seed, mh, which, devs):
    jmesh, tmesh = _meshes(SHAPES[which], devs)
    jt, tt, jix, tix, topics = _twin_indexed(seed, 500)
    jdt, tdt = _synced(jt, tt, jix, tix, jmesh, tmesh)
    nb = jix.n_buckets
    enc = JM.encode_topics(jt.vocab, topics, jt.max_levels)
    want = JS.make_sharded_hash_kernel(jmesh, mh, n_buckets=nb)(
        jdt._dev_meta, jdt._dev_slots, JMesh.put_topics(enc, jmesh))
    t_t = TMesh.put_topics(enc, tmesh)
    got = TS.make_sharded_hash_kernel(tmesh, mh, n_buckets=nb)(
        tdt._dev_meta, tdt._dev_slots, t_t)
    _eq(want, got)
    n_sub = tmesh.shape["sub"]
    # pairs whose two candidate buckets sit on two shards are covered
    elig, h1, fp = TH.class_hash_ref(tdt._dev_meta[0], t_t[0])
    b1 = h1 & (nb - 1)
    b2 = b1 ^ ((((fp | 1) * TH._ALT_MUL) & TH.M32) & (nb - 1))
    nb_loc = -(-nb // n_sub)
    assert int((elig & (b1 // nb_loc != b2 // nb_loc)).sum()) > 0
    if mh < 64:
        assert int(got[2].max()) > mh
        return
    # the combined pairs are the single-device K1's, as a set
    cpu = lambda arrays, cls: cls(*(to_device(np.asarray(a), CPU) for a in arrays))  # noqa: E731
    ti1, bi1, _total, _amb = TH.match_ids_hash_ref(
        cpu(tix.packed_meta(), TH.ClassMeta), cpu(tix.slots, TH.SlotArrays),
        cpu(enc, TH.EncodedTopics), max_hits=4096)
    single = {(t, b) for t, b in zip(ti1.tolist(), bi1.tolist()) if b >= 0}
    ti, bi = got[0].numpy().reshape(-1), got[1].numpy().reshape(-1)
    mesh_pairs = [(t, b) for t, b in zip(ti.tolist(), bi.tolist()) if t >= 0]
    assert len(mesh_pairs) == len(set(mesh_pairs))  # never twice
    assert set(mesh_pairs) == single


# --- K18: slot delta and the fused sync -------------------------------------------


@pytest.mark.parametrize("devs", sorted(DEVICE_SETS))
@pytest.mark.parametrize("which", ["mesh8", "mesh3"])
def test_slot_delta_and_mesh_sync_equal_reference(which, devs):
    jmesh, tmesh = _meshes(SHAPES[which], devs)
    jt, tt, jix, tix, _topics = _twin_indexed(12, 400)
    jdt, tdt = _synced(jt, tt, jix, tix, jmesh, tmesh)
    rng = random.Random(12)
    for r in rng.sample(list(jt.rows()), 60):
        jix.remove_row(r)
        jt.remove(r)
        tix.remove_row(r)
        tt.remove(r)
    for _ in range(40):
        f = random_filter(rng)
        jr, tr = jt.add(f), tt.add(f)
        jix.add_row(jr, jt)
        tix.add_row(tr, tt)
    assert not jix.rebuilt and jix.dirty_slots
    sdirty = np.unique(np.asarray(jix.dirty_slots, np.int32))
    assert np.array_equal(sdirty, np.unique(np.asarray(tix.dirty_slots, np.int32)))
    rdirty = jt.drain_dirty()
    tt.drain_dirty()
    sidx = pad_pow2_batches(sdirty, 256)  # repeats of the last id pad it
    ridx = pad_pow2_batches(rdirty, 64)
    scols = [sidx, jix.slots.fp[sidx], jix.slots.bucket[sidx],
             jix.slots.probe[sidx // JH.BUCKET_W]]
    rcols = [ridx, jt.words[ridx], jt.prefix_len[ridx], jt.has_hash[ridx],
             jt.root_wild[ridx], jt.active[ridx]]
    # the slot delta alone, on copies of the synced state
    js = [jnp.array(a) for a in jdt._dev_slots]
    ts = [tuple(t.clone() for t in col) for col in TS._slot_cols(tdt._dev_slots)]
    want = JS.make_slot_delta_kernel(jmesh)(*js, *(jnp.asarray(c) for c in scols))
    got = TS.make_slot_delta_kernel(tmesh)(*ts, *scols)
    for jarr, tparts in zip(want, got):
        js_ = _jshards(jarr, jmesh)
        for (i, j), a in js_.items():
            assert np.array_equal(a, _port_shard(tparts, tmesh, i, j))
    # the fused row + slot sync
    jdev = JS.EncodedFilters(*(jnp.array(a) for a in jdt._dev))
    want = JS.make_mesh_sync_kernel(jmesh)(
        jdev, *(jnp.array(a) for a in jdt._dev_slots),
        *(jnp.asarray(c) for c in rcols), *(jnp.asarray(c) for c in scols))
    got = TS.make_mesh_sync_kernel(tmesh)(
        tdt._dev, *TS._slot_cols(tdt._dev_slots), *rcols, *scols)
    jflat = list(want[0]) + list(want[1:])
    tflat = list(zip(*got[0])) + list(got[1:])
    for jarr, tparts in zip(jflat, tflat):
        for (i, j), a in _jshards(jarr, jmesh).items():
            assert np.array_equal(a, _port_shard(tparts, tmesh, i, j))


# --- the layout ---------------------------------------------------------------------


@pytest.mark.parametrize("devs", sorted(DEVICE_SETS))
@pytest.mark.parametrize("which", ["mesh8", "mesh3"])
def test_layout_equals_reference_shards(which, devs):
    """convert.mesh_state_from_numpy over the reference's host arrays,
    and both ShardedDeviceTables after the same churn (fused sync), hold
    the same per-shard arrays."""
    jmesh, tmesh = _meshes(SHAPES[which], devs)
    jt, tt, jix, tix, _topics = _twin_indexed(13, 300, class_budget=8)
    assert jix.residual_rows  # the class budget overflows: a residual mask
    jdt, tdt = _synced(jt, tt, jix, tix, jmesh, tmesh)
    mask = np.zeros(jt.capacity, bool)
    mask[list(jix.residual_rows)] = True
    state = convert.mesh_state_from_numpy(
        jt.snapshot(), jix.packed_meta(), jix.slots, mask, tmesh)
    conv = TS.ShardedDeviceTable(tt, tmesh, index=tix)
    conv._dev, conv._dev_meta, conv._dev_slots, conv._dev_residual = state
    _assert_layout(jdt, conv, jmesh, tmesh)
    _assert_layout(jdt, tdt, jmesh, tmesh)
    rng = random.Random(13)
    for r in rng.sample(list(jt.rows()), 50):
        jix.remove_row(r)
        jt.remove(r)
        tix.remove_row(r)
        tt.remove(r)
    for _ in range(60):
        f = random_filter(rng)
        jr, tr = jt.add(f), tt.add(f)
        jix.add_row(jr, jt)
        tix.add_row(tr, tt)
    jdt.sync()
    tdt.sync()
    _assert_layout(jdt, tdt, jmesh, tmesh)


# --- Router(mesh=...) -----------------------------------------------------------------


def test_mesh_router_matches_oracle(mesh8):
    jmesh, tmesh = mesh8
    jr = JRouter(max_levels=4, mesh=jmesh)
    tr = TRouter(max_levels=4, mesh=tmesh)
    for r in (jr, tr):
        for i in range(40):
            r.add_route(f"a/{i}/+", f"c{i}")
        r.add_route("a/#", "call")
        r.add_route("b/exact", "cex")
    topics = [f"a/{i}/x" for i in range(10)] + ["b/exact", "zzz"]
    got = tr.match_batch(topics)
    assert got == jr.match_batch(topics) == [tr.match_routes(t) for t in topics]
    for r in (jr, tr):
        r.delete_route("a/0/+", "c0")
        r.add_route("new/+", "cn")
    assert tr.match_batch(["a/0/x", "new/y"]) == [{"call"}, {"cn"}]
    assert tr.telemetry.counters["sync_rows_total"] > 0


def test_mesh_router_escalates_on_overflow(mesh8):
    jmesh, tmesh = mesh8
    jr = JRouter(max_levels=4, mesh=jmesh)
    tr = TRouter(max_levels=4, mesh=tmesh)
    for r in (jr, tr):
        r.device_table.default_mh = 4  # force per-block overflow
        for i in range(200):
            r.add_route(f"w/{i}/#", f"c{i}")
    assert tr.match_batch(["w/5/x"]) == [{"c5"}]
    wide = [f"w/{i}/t" for i in range(64)]
    assert tr.match_batch(wide) == jr.match_batch(wide)
    assert all(g == {f"c{i}"} for i, g in enumerate(tr.match_batch(wide)))
    assert tr.device_table._mh_floor == jr.device_table._mh_floor > 4
    c = tr.telemetry.counters
    assert c.get("hash_overflow_retries_total", 0) >= 1


def test_mesh_hash_kernel_matches_oracle_with_churn(mesh8):
    """Router(mesh=...) runs the sharded hash probe, stays oracle-exact
    and equal to the reference through add/delete churn (the fused
    row+slot sync), and keeps the dense kernel for residual rows."""
    jmesh, tmesh = mesh8
    rng = random.Random(31)
    jr = JRouter(max_levels=6, mesh=jmesh)
    tr = TRouter(max_levels=6, mesh=tmesh)
    assert tr.index is not None
    live = {}
    for i in range(300):
        f = rng.choice([f"s/{i}/+", f"s/{i}/#", f"+/x/{i}", f"s/{i}/t/{i % 7}", "#"])
        for r in (jr, tr):
            r.add_route(f, f"d{i}")
        live.setdefault(f, set()).add(f"d{i}")
    topics = [f"s/{rng.randrange(320)}/t/{rng.randrange(9)}" for _ in range(40)]
    topics += [f"q/x/{rng.randrange(320)}" for _ in range(10)]
    topics += ["$SYS/broker", "s/5/t"]

    def check():
        got = tr.match_batch(topics)
        assert got == jr.match_batch(topics)
        routes = tr.routes()
        for t, g in zip(topics, got):
            tw = TT.words(t)
            assert g == {d for (f, d) in routes if TT.match(tw, TT.words(f))}, t

    check()
    for f in rng.sample(sorted(live), len(live) // 3):
        for d in sorted(live.pop(f)):
            for r in (jr, tr):
                r.delete_route(f, d)
    for i in range(40):
        for r in (jr, tr):
            r.add_route(f"n/{i}/+", f"nd{i}")
    topics.extend(f"n/{i}/z" for i in range(0, 40, 7))
    check()
    assert len(tr.index) > 0 and not tr.index.residual_rows
    assert tr.telemetry.gauges["mesh_sync_batch_rows"] > 0
    assert tr.telemetry.gauges["mesh_shards"] == 4
    dt, cap = tr.device_table, tr.table.capacity
    assert (dt.shard_of_row(0), dt.shard_of_row(cap - 1)) == (0, 3)
    nb = tr.index.n_buckets
    assert [dt.shard_of_slot(s) for s in (0, nb * 4 // 4, nb * 4 - 1)] == [0, 1, 3]
    assert tr.telemetry.labeled_counters["mesh_shard_transfer_rows_total"]


def test_non_divisible_mesh_serves_pow2_capacity(mesh3):
    """A 3-way sub split serves a pow2 table (512 rows, 1024 buckets do
    not divide by 3) with trailing inert pad rows and slots, through
    churn on the padded layout."""
    jmesh, tmesh = mesh3
    jr, tr = JRouter(mesh=jmesh), TRouter(mesh=tmesh)
    pairs = [(f"a/{i}/+", f"s{i}") for i in range(300)]
    pairs += [("b/#", "sb"), ("exact/topic/x", "sx"), ("c/+/d", "scd")]
    topics = [f"a/{i}/z" for i in range(0, 300, 7)] + [
        "b/q/w", "exact/topic/x", "c/9/d", "no/match/here"]

    def check(r, ts):
        got = r.match_filters_finish(r.match_filters_begin(ts))
        for t, g in zip(ts, got):
            assert sorted(g) == sorted(r.match_filters(t)), t
        return got

    for r in (jr, tr):
        r.add_routes(pairs)
        r.device_table.sync()
    assert TMesh.shard_rows(tr.table.capacity, tmesh) * 3 > tr.table.capacity
    assert tr.index.n_buckets % 3
    assert check(tr, topics) == check(jr, topics)
    for r in (jr, tr):
        r.delete_routes([(f"a/{i}/+", f"s{i}") for i in range(7)])
        r.add_routes([(f"p/{i}/+", f"p{i}") for i in range(23)])
        r.device_table.sync()
    more = topics + [f"p/{i}/q" for i in range(23)]
    assert check(tr, more) == check(jr, more)


# (use_hash_index, class_budget): the dense-only leg, the residual
# dense leg and the hash leg, as in tests/test_torch_router.py
@pytest.mark.parametrize("use_hash_index,class_budget", [(False, 256), (True, 1), (True, 256)])
def test_mesh_routes_changed_in_flight_are_never_misnamed(mesh8, use_hash_index, class_budget):
    """Routes deleted and re-added with different filters while a mesh
    batch is in flight: the batch reports every filter routed from its
    begin to its finish, and only matching filters routed at one of
    them (the generation check guards the mesh results too)."""
    _jmesh, tmesh = mesh8
    tr = TRouter(max_levels=6, use_hash_index=use_hash_index, mesh=tmesh)
    if use_hash_index:
        tr.index.class_budget = class_budget
        tr.index._class_free = list(range(class_budget - 1, -1, -1))
    tr.add_route("a/+/x", "keep")
    old = [f"a/{i}/+" for i in range(40)]
    tr.add_routes([(f, "n") for f in old])
    topics = [f"a/{i}/x" for i in range(40)]
    before = [set(tr.match_filters(t)) for t in topics]
    p = tr.match_filters_begin(topics)
    for i, f in enumerate(old):
        tr.delete_route(f, "n")
        if i % 2 == 0:
            tr.add_route(f"b/{i}/+", "n")
    p2 = tr.match_filters_begin(topics)  # syncs the changes in place
    got = tr.match_filters_finish(p)
    after = [set(tr.match_filters(t)) for t in topics]
    for b, g, a in zip(before, got, after):
        assert len(g) == len(set(g))
        assert b & a <= set(g) <= b | a
    assert [set(g) for g in tr.match_filters_finish(p2)] == after


def test_mesh_router_dense_leg_escalates_on_overflow(mesh8):
    """The dense-only mesh (K16 + K14) past a forced per-block capacity:
    the finish half escalates until every dp block's total fits, the
    floor sticks, and the answers stay the reference's."""
    jmesh, tmesh = mesh8
    jr = JRouter(max_levels=4, use_hash_index=False, mesh=jmesh)
    tr = TRouter(max_levels=4, use_hash_index=False, mesh=tmesh)
    for r in (jr, tr):
        r.device_table.default_mh = 4
        r.add_routes([(f"w/{i}/#", f"c{i}") for i in range(120)] + [("w/#", "all")])
    wide = [f"w/{i}/t" for i in range(48)]
    got = tr.match_batch(wide)
    assert got == jr.match_batch(wide)
    assert all(g == {f"c{i}", "all"} for i, g in enumerate(got))
    assert tr.device_table._mh_floor == jr.device_table._mh_floor > 4
    assert tr.telemetry.counters["escalations_total"] >= 1
    assert tr.match_batch(["w/3/t"]) == [{"c3", "all"}]


def test_mesh_router_warmup_shapes(mesh8):
    _jmesh, tmesh = mesh8
    tr = TRouter(max_levels=4, mesh=tmesh)
    tr.index.class_budget = 1
    tr.index._class_free = [0]
    tr.add_routes([(f"w/{i}/+", "a") for i in range(50)] + [("x/#", "b")])
    assert tr.index.residual_rows
    # 4 batch shapes, each with its escalation step for both kernels,
    # then the row / slot / fused delta kernels at 1 and 2 batches
    assert tr.warmup_shapes(8) == 4 * 3 + 6
    keys = tr.telemetry._shape_keys
    assert {"mesh_match_ids", "mesh_match_ids_hash", "apply_delta",
            "mesh_slot_delta", "mesh_sync"} <= set(keys)


# --- Broker(mesh=...) -----------------------------------------------------------------


def _rooms(b, msg_cls, opts_cls, n_rooms=24):
    """The dry run's rooms: a subscriber per room and a watcher on
    room/#; returns the per-client delivery lists."""
    delivered = {}
    for i in range(n_rooms):
        s, _ = b.open_session(f"c{i}", True)
        b.subscribe(s, f"room/{i}/+", opts_cls(qos=0))
        delivered[f"c{i}"] = []
        s.outgoing_sink = delivered[f"c{i}"].extend
    s_all, _ = b.open_session("watch", True)
    b.subscribe(s_all, "room/#", opts_cls(qos=1))
    delivered["watch"] = []
    s_all.outgoing_sink = delivered["watch"].extend
    batch = [msg_cls(topic=f"room/{i}/t", payload=b"x", qos=1) for i in range(n_rooms)]
    return b.publish_batch(batch), delivered


def test_mesh_broker_publish_batch_equals_reference(mesh8):
    jmesh, tmesh = mesh8
    jb = JB.Broker(max_levels=6, mesh=jmesh)
    tb = TB.Broker(max_levels=6, mesh=tmesh)
    jc, jd = _rooms(jb, JMsg.Message, JPkt.SubOpts)
    tc, td = _rooms(tb, TMsg.Message, TPkt.SubOpts)
    assert tc == jc == [2] * 24
    assert {k: [(p.topic, p.qos) for p in v] for k, v in td.items()} == {
        k: [(p.topic, p.qos) for p in v] for k, v in jd.items()}
    rt = tb.router
    assert rt.index is not None and len(rt.index) > 0
    assert rt.device_table._dev_slots is not None and not rt.index.residual_rows
    assert tb.retainer.device == TMesh.primary_device(tmesh)


def test_dispatch_engine_warmup_reports_the_mesh(mesh8):
    _jmesh, tmesh = mesh8
    tb = TB.Broker(max_levels=6, mesh=tmesh)
    _rooms(tb, TMsg.Message, TPkt.SubOpts, n_rooms=4)
    info = tb.enable_dispatch_engine(queue_depth=8).warmup()
    assert info["mesh_shards"] == 4


# --- no fallback ------------------------------------------------------------------------


MESH_KERNELS = ["mesh_match_counts", "mesh_match_packed", "mesh_apply_delta",
                "combine_pairs", "combine_probe", "mesh_match_ids",
                "mesh_match_ids_hash", "mesh_slot_delta", "mesh_sync",
                "match_dense", "match_packed", "match_counts"]


@pytest.mark.parametrize("name", MESH_KERNELS)
def test_new_kernels_raise_on_a_failed_build(monkeypatch, tmp_path, name):
    """No nvcc: the kernel raises at its first launch and counts none;
    nothing falls back to the plain version."""
    from emqx_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda _p: False)
    k = _build.KERNELS[name]
    monkeypatch.setattr(k, "_fn", None)
    with pytest.raises(_build.KernelBuildError):
        k(0)
    assert k.launches == 0
