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
from emqx_tpu_torch.ops import delta as TD
from emqx_tpu_torch.ops import hash_index as TH
from emqx_tpu_torch.ops import topic as TT
from emqx_tpu_torch.ops.table import FilterTable, pad_pow2_batches
from emqx_tpu_torch.parallel import mesh as TMesh
from emqx_tpu_torch.parallel import sharded_match as TS

import chip_smoke

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


# (seed, edge, mesh): edge None takes `_twin_tables`' table; a name takes
# chip_smoke.FORM_EDGES' table of that name (the cases the packed kernel
# treats apart), cut to FORM_EDGE_ROWS rows on mesh8 (288 a shard: a
# whole 256-row block and a partial one) and to one row fewer on mesh3,
# which pads it to 3 x 384 rows (shard rows a multiple of 32, as the
# packed form needs). One device holds every tile; two devices hold half
# each, and each tile's block is read from the group that computed it.
# (seed, edge, which, n_rows): n_rows None keeps FORM_EDGE_ROWS (one row
# fewer on mesh3, whose shards then pad); the counts' own edge,
# COUNTS_EDGE_ROWS, gives shards whose rows are not a multiple of 32
# (counts only: the bitmap refuses them)
FORMS_MESH_CASES = [pytest.param(1, None, "mesh8", None, id="1"),
                    pytest.param(2, None, "mesh8", None, id="2")]
FORMS_MESH_CASES += [pytest.param(0, e, "mesh8", None, id=e) for e in chip_smoke.FORM_EDGES
                     if e not in ("topics37_pad64", "topics1000")]
FORMS_MESH_CASES += [pytest.param(0, e, "mesh3", None, id=f"{e}-mesh3")
                     for e in ("dead_words", "sys")]
FORMS_MESH_CASES += [
    pytest.param(0, chip_smoke.COUNTS_EDGE, which, chip_smoke.COUNTS_EDGE_ROWS,
                 id=f"{chip_smoke.COUNTS_EDGE}-rows{chip_smoke.COUNTS_EDGE_ROWS}-{which}")
    for which in ("mesh8", "mesh3")]


@pytest.mark.parametrize("seed,edge,which,n_rows", FORMS_MESH_CASES)
@pytest.mark.parametrize("devs", sorted(DEVICE_SETS))
def test_sharded_counts_and_packed_equal_reference(devs, seed, edge, which, n_rows):
    jmesh, tmesh = _meshes(SHAPES[which], devs)
    counts_only = n_rows is not None
    if edge is None:
        jt, tt, topics = _twin_tables(seed, 300)
        snap, pad_to = jt.snapshot(), 0
    else:
        (jt, tt), topics, pad_to = chip_smoke.form_edge_case(edge, JFilterTable, FilterTable)
        snap = jt.snapshot()
        if n_rows is None:
            n_rows = chip_smoke.FORM_EDGE_ROWS - (which == "mesh3")
        snap = type(snap)(*(a[:n_rows] for a in snap))
    enc = JM.encode_topics(jt.vocab, topics, jt.max_levels, pad_to=pad_to)
    jc, jp, _ = JS.make_sharded_kernels(jmesh)
    tc, tp, _ = TS.make_sharded_kernels(tmesh)
    fj, tj = JMesh.put_filters(snap, jmesh), JMesh.put_topics(enc, jmesh)
    ft, t_t = TMesh.put_filters(snap, tmesh), TMesh.put_topics(enc, tmesh)
    shard_rows = ft[0].words.shape[0] // len(tmesh.groups[0].subs)
    assert bool(shard_rows % 32) == counts_only
    n = len(snap.active)
    oracle = [rows[rows < n] for rows in JM.oracle_match_rows(jt, topics)]
    if counts_only:
        _eq([jc(fj, tj)], [tc(ft, t_t)])
        assert [int(c) for c in tc(ft, t_t)[: len(topics)]] == [len(r) for r in oracle]
        with pytest.raises(ValueError, match="multiple of 32"):
            tp(ft, t_t)
        return
    _eq([jc(fj, tj), jp(fj, tj)], [tc(ft, t_t), tp(ft, t_t)])
    counts = tc(ft, t_t).numpy()[: len(topics)]
    packed = _np(tp(ft, t_t))
    for i, rows in enumerate(oracle):
        assert counts[i] == len(rows)
        assert np.array_equal(JM.unpack_indices(packed[i]), rows)
    assert not packed[len(topics):].any()  # pad topics match nothing


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


# K15's cases: (salt, mh, layout). -2 makes sub 0's entry -1 (invalid);
# 1.5e9 wraps salt * 2 + 1; 2,147,483,646 wraps sub 1's entry negative.
# mh 1 is one slot a block, mh 7 allows no 16-byte row access; mesh3 is
# the padded (1, 3) layout. The card runs the same cases (chip_smoke.py
# phase 9, `probe_checks`).
PROBE_SALTS = (12345, -2, 1_500_000_000, 2_147_483_646)
PROBE_CASES = (
    [pytest.param(salt, 32, "mesh8", id=str(salt)) for salt in (0, 7, -2, 1_500_000_000)]
    + [pytest.param(salt, 32, "mesh8", id=f"{salt}-mh32") for salt in (12345, 2_147_483_646)]
    + [pytest.param(salt, mh, "mesh8", id=f"{salt}-mh{mh}")
       for mh in (1, 7) for salt in PROBE_SALTS]
    + [pytest.param(salt, mh, "mesh3", id=f"{salt}-mh{mh}-mesh3")
       for mh in (32, 7, 1) for salt in (12345, 2_147_483_646)]
)


@pytest.mark.parametrize("salt,mh,layout", PROBE_CASES)
def test_combine_probe_equals_reference(mesh8, salt, mh, layout, request):
    jmesh, tmesh = mesh8
    if layout != "mesh8":
        jmesh, tmesh = _meshes(SHAPES[layout], request.node.callspec.params["mesh8"])
    want = JS.make_combine_probe_kernel(jmesh, mh)(jnp.int32(salt))
    got = TS.make_combine_probe_kernel(tmesh, mh)(salt)
    _eq(want, got)
    n_dp, n_sub = SHAPES[layout]
    valid = [(salt + s + 1 + (1 << 31)) % (1 << 32) >= (1 << 31) for s in range(n_sub)]
    assert [int(t) for t in got[2].reshape(-1)] == [sum(valid)] * n_dp


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


# --- K13 apply_delta + K18: the one mesh table sync --------------------------------


# (n_rows, n_slots, residual column, ids past the tables): rows only,
# slots only, both sides with and without the residual column; one entry
# a side, one batch, one past a batch, three batches; `past` ids past the
# shards' padded tables and as many negative ids a side, which the
# reference drops
MESH_SYNC_CASES = [
    (40, 0, True, 0), (0, 40, False, 0), (30, 50, True, 0), (30, 50, False, 0),
    (1, 1, True, 0), (1024, 1024, True, 0), (1025, 1025, False, 0),
    (3000, 3000, True, 0), (20, 30, True, 2),
]
_JAX_SYNC_KERNELS: dict = {}


def _jax_sync_kernels(jmesh):
    """The reference's K13 apply_delta, K18 slot delta and fused sync on
    a JAX mesh, built once a layout (so each batch shape compiles once)."""
    key = tuple(np.asarray(jmesh.devices).shape)
    if key not in _JAX_SYNC_KERNELS:
        _JAX_SYNC_KERNELS[key] = (JS.make_sharded_kernels(jmesh)[2],
                                  JS.make_slot_delta_kernel(jmesh),
                                  JS.make_mesh_sync_kernel(jmesh))
    return _JAX_SYNC_KERNELS[key]


@pytest.mark.parametrize("devs", sorted(DEVICE_SETS))
@pytest.mark.parametrize("which", ["mesh8", "mesh3"])
@pytest.mark.parametrize("n_rows,n_slots,with_residual,past", MESH_SYNC_CASES)
def test_mesh_table_sync_equals_reference(n_rows, n_slots, with_residual, past, which, devs):
    """The fused mesh sync's plain version and its wrapper, from one
    unpadded staged buffer a group, against the reference's apply_delta
    (rows only), slot delta (slots only) or fused sync (both) on the same
    ids padded by pad_pow2_batches, as its ShardedDeviceTable pads them,
    shard by shard; the residual mask against the stale mask with the
    rows' bytes written."""
    jmesh, tmesh = _meshes(SHAPES[which], devs)
    n_sub = tmesh.shape["sub"]
    rng = np.random.default_rng(n_rows * 7 + n_slots + past + with_residual + 100 * n_sub)
    levels, room = 6, 64
    n_pad = TMesh.shard_rows(4096, tmesh) * n_sub  # mesh3 pads 4,096 rows
    s_pad = -(-2048 // n_sub) * n_sub * TH.BUCKET_W  # and 2,048 buckets
    local = n_pad // n_sub

    def ints(n, hi, shape=()):
        return rng.integers(0, hi, (n,) + shape).astype(np.int32)

    def u32s(n):
        return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)

    # host truth, with room past the tables for the ids past them
    host = TS.EncodedFilters(ints(n_pad + room, 1 << 20, (levels,)),
                             ints(n_pad + room, levels + 1), rng.random(n_pad + room) < 0.5,
                             rng.random(n_pad + room) < 0.5, rng.random(n_pad + room) < 0.5)
    hslots = TH.SlotArrays(u32s(s_pad + room), ints(s_pad + room, 1 << 20) - 1,
                           u32s((s_pad + room) // 4))
    host_res = rng.random(n_pad + room) < 0.3
    dev0 = TS.EncodedFilters(ints(n_pad, 1 << 20, (levels,)), ints(n_pad, levels + 1),
                             rng.random(n_pad) < 0.5, rng.random(n_pad) < 0.5,
                             rng.random(n_pad) < 0.5)
    slots0 = [u32s(s_pad), ints(s_pad, 1 << 20) - 1, u32s(s_pad // 4)]
    res0 = rng.random(n_pad) < 0.3

    def ids(n, cap):
        if not n:
            return np.zeros(0, np.int32)
        got = rng.choice(cap, n - 2 * past, replace=False)
        extra = cap + rng.choice(room, past, replace=False)
        neg = -1 - rng.choice(16, past, replace=False)
        return np.sort(np.concatenate([got, extra, neg])).astype(np.int32)

    rows, sids = ids(n_rows, n_pad), ids(n_slots, s_pad)
    if past:
        assert rows[0] < 0 and rows[-1] >= n_pad and sids[0] < 0 and sids[-1] >= s_pad
    japply, jslots, jsync = _jax_sync_kernels(jmesh)
    jf = JMesh.put_filters(dev0, jmesh)
    js = [jax.device_put(a, jax.sharding.NamedSharding(jmesh, JP("sub"))) for a in slots0]
    ridx = pad_pow2_batches(rows, TS.ShardedDeviceTable.DELTA_BATCH) if len(rows) else None
    sidx = pad_pow2_batches(sids, TS.ShardedDeviceTable.DELTA_BATCH) if len(sids) else None
    rcols = None if ridx is None else [jnp.asarray(c) for c in (
        ridx, *(a[ridx] for a in host))]
    scols = None if sidx is None else [jnp.asarray(c) for c in (
        sidx, hslots.fp[sidx], hslots.bucket[sidx], hslots.probe[sidx // TH.BUCKET_W])]
    if rcols and scols:
        out = jsync(jf, *js, *rcols, *scols)
        jf, js = out[0], list(out[1:])
    elif rcols:
        jf = japply(jf, *rcols)
    else:
        js = list(jslots(*js, *scols))
    want_res = res0.copy()
    inside = rows[(rows >= 0) & (rows < n_pad)]
    want_res[inside] = host_res[inside]
    residual_rows = {int(r) for r in np.flatnonzero(host_res)}
    buf = TD.pack_table_delta(host, rows, hslots, sids, residual_rows)
    assert buf.shape == (TD.table_delta_layout(len(rows), levels, len(sids))[2],)
    staged = TMesh.put_repl(buf, tmesh)
    for use_wrapper in (False, True):
        tdev = TMesh.put_filters(dev0, tmesh)
        tsl = tuple(TH.SlotArrays(*c) for c in zip(*(TMesh.put_sub(a, tmesh) for a in slots0)))
        tres = TMesh.put_sub(res0, tmesh) if with_residual else None
        if use_wrapper:
            TS.mesh_table_sync(tmesh, tdev, tsl, tres, staged, len(rows), len(sids))
        else:
            for gi, g in enumerate(tmesh.groups):
                TS.mesh_table_sync_ref(g.subs, n_sub, tdev[gi], tsl[gi],
                                       None if tres is None else tres[gi], staged[gi],
                                       len(rows), len(sids))
        for jarr, tparts in zip(list(jf) + list(js), list(zip(*tdev)) + list(zip(*tsl))):
            for (i, j), a in _jshards(jarr, jmesh).items():
                assert np.array_equal(a, _port_shard(tparts, tmesh, i, j)), (i, j)
        if with_residual:
            for i in range(tmesh.shape["dp"]):
                for j in range(n_sub):
                    assert np.array_equal(_port_shard(tres, tmesh, i, j),
                                          want_res[j * local:(j + 1) * local])


def test_mesh_table_sync_refuses_negative_counts(mesh8):
    """A negative count would point the slot columns before the staged
    buffer; the wrapper refuses it, and slot entries with no slot
    arrays."""
    _jmesh, tmesh = mesh8
    dev = TMesh.put_filters(TS.EncodedFilters(
        np.zeros((64, 4), np.int32), np.zeros(64, np.int32),
        *(np.zeros(64, bool) for _ in range(3))), tmesh)
    staged = TMesh.put_repl(np.zeros(64, np.uint8), tmesh)
    with pytest.raises(ValueError, match="negative"):
        TS.mesh_table_sync(tmesh, dev, None, None, staged, -1, 0)
    with pytest.raises(ValueError, match="no slot arrays"):
        TS.mesh_table_sync(tmesh, dev, None, None, staged, 0, 4)


@pytest.mark.parametrize("which", ["mesh_table_sync", "apply_delta", "slot_delta",
                                   "mesh_sync"])
def test_failed_mesh_sync_build_raises_without_plain_fallback(which, monkeypatch, tmp_path):
    """The staged sync and the three reference-shaped wrappers reach the
    one fused kernel; when it fails to build they raise, and no plain
    version runs in its place."""
    from emqx_tpu_torch.ops import _build

    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 1\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    # meta tensors stand in for CUDA ones, with a stand-in stream
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda _d=None: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", None, raising=False)
    k = _build.KERNELS["mesh_table_sync"]
    monkeypatch.setattr(k, "_fn", None)

    def _never(*_a, **_k):
        raise AssertionError("plain version ran in place of the kernel")

    for name in ("mesh_table_sync_ref", "scatter_owned_rows_ref", "scatter_owned_slots_ref"):
        monkeypatch.setattr(TS, name, _never)
    meta = torch.device("meta")
    arr = np.empty(8, dtype=object)
    arr[:] = [meta] * 8
    mesh = TMesh.Mesh(arr.reshape(2, 4))

    def z(shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=meta)

    dev = (TS.EncodedFilters(z((8, 4)), z(8), z(8, torch.bool), z(8, torch.bool),
                             z(8, torch.bool)),)
    sfp, sbkt, probe = (z(16, torch.uint32),), (z(16),), (z(4, torch.uint32),)
    b = (z((1, 4), torch.bool),)
    rcols = [(z((1, 4)),), (z((1, 4, 4)),), (z((1, 4)),), b, b, b]
    scols = [(z((1, 4)),), (z((1, 4), torch.uint32),), (z((1, 4)),),
             (z((1, 4), torch.uint32),)]
    with pytest.raises(_build.KernelBuildError, match="no sm_90a"):
        if which == "mesh_table_sync":
            n_bytes = TD.table_delta_layout(2, 4, 3)[2]
            TS.mesh_table_sync(mesh, dev, (TS.SlotArrays(sfp[0], sbkt[0], probe[0]),),
                               (z(8, torch.bool),), (z(n_bytes, torch.uint8),), 2, 3)
        elif which == "apply_delta":
            TS.make_sharded_kernels(mesh)[2](dev, *rcols)
        elif which == "slot_delta":
            TS.make_slot_delta_kernel(mesh)(sfp, sbkt, probe, *scols)
        else:
            TS.make_mesh_sync_kernel(mesh)(dev, sfp, sbkt, probe, *rcols, *scols)
    assert k.launches == 0


def _churn_indexed(jt, jix, tt, tix, rng, n_add, n_del, words):
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


@pytest.mark.parametrize("devs", sorted(DEVICE_SETS))
@pytest.mark.parametrize("which", ["mesh8", "mesh3"])
def test_sharded_device_table_syncs_equal_reference(which, devs, monkeypatch):
    """A port ShardedDeviceTable on a CPU mesh beside the reference's over
    seeded churn that adds and removes residual rows (a class budget of
    6): after every sync the rows, slots, residual mask (shard by shard)
    and class metadata equal the reference's, the mask equals the host's
    residual set, and both telemetries hold the same shape buckets. A
    delta sync with no growth or rebuild is one host->device copy a
    device group and one mesh_table_sync call (plus the metadata's five
    columns a group when they changed), and writes the mask in place; a
    sync with only dirty slots is one of each too; growth re-uploads;
    nothing dirty copies and calls nothing."""
    from emqx_tpu.obs.kernel_telemetry import KernelTelemetry as JTel
    from emqx_tpu_torch.obs.kernel_telemetry import KernelTelemetry as TTel

    jmesh, tmesh = _meshes(SHAPES[which], devs)
    n_groups, n_sub = len(tmesh.groups), tmesh.shape["sub"]
    copies, calls = [], []
    real_put, real_sync = TMesh.to_device, TS.mesh_table_sync

    def put(a, device):
        copies.append(np.asarray(a).nbytes)
        return real_put(a, device)

    def sync(*a):
        calls.append(a[-2:])
        real_sync(*a)

    monkeypatch.setattr(TMesh, "to_device", put)
    monkeypatch.setattr(TS, "mesh_table_sync", sync)
    rng = random.Random(5)
    words = tuple(f"w{k}" for k in range(40)) + ("",)
    jt, tt = JFilterTable(max_levels=6, capacity=256), FilterTable(max_levels=6, capacity=256)
    jix = JH.ClassIndex(6, class_budget=6, min_slots=512)
    tix = TH.ClassIndex(6, class_budget=6, min_slots=512)
    jtel, ttel = JTel(), TTel()
    jdt = JS.ShardedDeviceTable(jt, jmesh, index=jix, telemetry=jtel)
    tdt = TS.ShardedDeviceTable(tt, tmesh, index=tix, telemetry=ttel)

    def held():
        _assert_layout(jdt, tdt, jmesh, tmesh)
        mask = TMesh.pad_rows(np.zeros(tt.capacity, bool), n_sub)
        mask[list(tix.residual_rows)] = True
        local = mask.shape[0] // n_sub
        for i in range(tmesh.shape["dp"]):
            for j in range(n_sub):
                assert np.array_equal(_port_shard(tdt._dev_residual, tmesh, i, j),
                                      mask[j * local:(j + 1) * local])
        j_keys = {k.lstrip("_"): v for k, v in jtel._shape_keys.items()}
        assert ttel._shape_keys == j_keys
        assert ttel.counters.get("recompiles_total") == jtel.counters.get("recompiles_total")

    _churn_indexed(jt, jix, tt, tix, rng, 150, 0, words)
    assert tdt.sync() == jdt.sync()  # the first sync is a full upload
    assert calls == [] and tix.residual_rows
    held()
    deltas = flips = grown = 0
    for k, (n_add, n_del) in enumerate([(40, 30), (30, 40), (1, 0), (60, 60), (200, 20),
                                        (0, 50), (45, 45)]):
        _churn_indexed(jt, jix, tt, tix, rng, n_add, n_del, words)
        grew, rebuilt, meta = tt.grew, tix.rebuilt, tix.meta_dirty
        n_r, n_s = len(set(tt.dirty)), len(set(tix.dirty_slots))
        mask_before = tdt._dev_residual
        was = [m.clone() for m in mask_before]
        del copies[:], calls[:]
        assert tdt.sync() == jdt.sync()
        held()
        if grew:  # a growth sync: rows and mask whole, the slots' delta launched
            grown += 1
            assert tdt._dev_residual is not mask_before
            assert n_groups * (5 + 1) <= len(copies)
            continue
        deltas += not rebuilt
        flips += any(not torch.equal(w, m) for w, m in zip(was, tdt._dev_residual))
        assert tdt._dev_residual is mask_before  # written in place
        assert calls == [(n_r, 0 if rebuilt else n_s)]
        assert len(copies) == n_groups * (1 + 5 * meta + 3 * rebuilt), (k, copies)
    assert grown and deltas >= 4 and flips >= 3
    # dirty slots and no dirty rows (a cuckoo kick alone): one of each
    live = np.flatnonzero(tix.slots.bucket >= 0)[:7].tolist()
    for ix in (jix, tix):
        ix.dirty_slots.extend(live)
    del copies[:], calls[:]
    assert tdt.sync() == jdt.sync() == 0
    assert calls == [(0, len(live))] and len(copies) == n_groups
    held()
    # nothing dirty: no copy, no launch
    del copies[:], calls[:]
    assert tdt.sync() == jdt.sync() == 0
    assert calls == [] and copies == []
    held()


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


MESH_KERNELS = ["mesh_match_counts", "mesh_match_packed", "mesh_table_sync",
                "combine_pairs", "combine_probe", "mesh_match_ids",
                "mesh_match_ids_hash", "match_dense", "match_packed", "match_counts"]


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


# --- the shard failure domain: suspend, evacuate, rebalance -------------------------


def _shard_routers(shape, seed=41, n=300):
    """A reference and a port Router on (dp, sub) meshes of `shape` with
    the same seeded routes (classed, residual and exact), synced."""
    jmesh, tmesh = _meshes(shape, "one_device")
    jr, tr = JRouter(max_levels=6, mesh=jmesh), TRouter(max_levels=6, mesh=tmesh)
    rng = random.Random(seed)
    pairs = []
    for i in range(n):
        f = rng.choice([f"s/{i}/+", f"s/{i}/#", f"+/x/{i}", f"s/{i}/t/{i % 7}", "#",
                        f"e/{i}/t"])
        pairs.append((f, f"d{i}"))
    for r in (jr, tr):
        r.add_routes(pairs)
        r.device_table.sync()
    topics = [f"s/{rng.randrange(n)}/t/{rng.randrange(9)}" for _ in range(40)]
    topics += [f"q/x/{rng.randrange(n)}" for _ in range(10)] + [f"e/{i}/t" for i in range(9)]
    return jr, tr, topics


def _owners(r):
    """Every row's and every slot's serving shard under the current mesh."""
    dt = r.device_table
    return ([dt.shard_of_row(i) for i in range(r.table.capacity)],
            [dt.shard_of_slot(i) for i in range(r.index.n_buckets * 4)])


@pytest.mark.parametrize("n_dp", [1, 2])
def test_shard_owners_equal_reference_across_evacuation(n_dp):
    """shard_of_row / shard_of_slot equal the reference's for every row
    and slot on (dp, 4), on the survivor (dp, 3) after evacuating a
    shard, and on (dp, 4) again after the rebalance; the table's layout
    on the survivor mesh is the reference's."""
    jr, tr, _topics = _shard_routers((n_dp, 4))
    seen = []
    for step in ("full", "evacuated", "rebalanced"):
        if step == "evacuated":
            assert jr.evacuate_shard(2) and tr.evacuate_shard(2)
        elif step == "rebalanced":
            assert jr.rebalance_shard(2) and tr.rebalance_shard(2)
        jdt, tdt = jr.device_table, tr.device_table
        assert tdt.n_shards == jdt.n_shards == (3 if step == "evacuated" else 4)
        assert tdt.mesh.shape == {"dp": n_dp, "sub": tdt.n_shards}
        assert _owners(tr) == _owners(jr)
        _assert_layout(jdt, tdt, jdt.mesh, tdt.mesh)
        seen.append(_owners(tr))
    assert seen[0] == seen[2] != seen[1]


def _answers(r, topics):
    return [sorted(x) for x in r.match_filters_batch(topics)]


@pytest.mark.parametrize("shape", [(1, 4), (2, 4)])
def test_shard_suspend_evacuate_rebalance_answers_equal_reference(shape):
    """suspend -> overlay -> resume -> evacuate -> churn on N-1 ->
    rebalance on seeded routes: the batched answers equal the
    reference's and the host walk's at every step, the overlay counts,
    and the shard-map generation and gauges move alike."""
    jr, tr, topics = _shard_routers(shape)
    oracle = [sorted(tr.match_filters(t)) for t in topics]
    topics = list(topics)
    steps = []

    def step(tag):
        got = _answers(tr, topics)
        assert got == _answers(jr, topics) == [sorted(tr.match_filters(t)) for t in topics], tag
        # (the port also sets mesh_shards when its table is built, the
        # reference first at a re-shard)
        got_st, want_st = (
            (r.device_table.shard_gen, sorted(r.device_table.lost_shards),
             r.telemetry.gauges.get("shards_suspended"), r.telemetry.gauges.get("shards_lost"),
             r.telemetry.gauges.get("mesh_shards", 0) if jr.telemetry.gauges.get("mesh_shards")
             else None)
            for r in (tr, jr))
        assert got_st == want_st, tag
        steps.append((tag,) + got_st)

    step("full")
    for r in (jr, tr):
        assert r.suspend_shard(1) and not r.suspend_shard(1)
    step("suspended")
    assert tr.telemetry.counters["shard_overlay_total"] > 0
    for r in (jr, tr):
        r.resume_shard(1)
        assert r.evacuate_shard(1) and not r.evacuate_shard(1)
    step("evacuated")
    for r in (jr, tr):
        r.add_routes([(f"n/{i}/+", f"nd{i}") for i in range(30)])
        r.delete_routes([(f"e/{i}/t", f"d{i}") for i in range(300) if i % 3 == 0])
    topics += [f"n/{i}/z" for i in range(0, 30, 4)]
    step("churned on N-1")
    for r in (jr, tr):
        assert r.rebalance_shard(1) and not r.rebalance_shard(1)
    step("rebalanced")
    assert [s[1] for s in steps] == [0, 0, 1, 1, 2]
    assert [s[-1] for s in steps] == [None, None, 3, 3, 4]
    assert _answers(tr, topics[:len(oracle)]) != oracle  # the churn moved answers
    c, jc = tr.telemetry.counters, jr.telemetry.counters
    for k in ("shard_suspends_total", "shard_resumes_total", "shard_evacuations_total",
              "shard_rebalances_total"):
        assert c[k] == jc[k] >= 1, k


@pytest.mark.parametrize("port", [False, True])
def test_evacuation_keeps_a_survivor_and_bumps_the_generation(port):
    """Evacuating down to one shard works, one more raises the reference's
    "no survivor" RuntimeError, and two evacuate/rebalance cycles move
    the shard-map generation by four."""
    jr, tr, topics = _shard_routers((1, 4), n=60)
    r = tr if port else jr
    dt = r.device_table
    for cycle in range(2):
        assert r.evacuate_shard(3) and r.rebalance_shard(3)
    assert dt.shard_gen == 4 and dt.n_shards == 4
    for s in (0, 1, 2):
        assert r.evacuate_shard(s)
    assert dt.n_shards == 1 and dt.lost_shards == {0, 1, 2}
    assert _answers(r, topics) == [sorted(r.match_filters(t)) for t in topics]
    with pytest.raises(RuntimeError, match="no survivor"):
        r.evacuate_shard(3)
    assert not r.evacuate_shard(0) and not r.evacuate_shard(9)
    for s in (2, 0, 1):
        assert r.rebalance_shard(s)
    assert dt.n_shards == 4 and dt.mesh is dt._mesh0 and dt.shard_gen == 10


@pytest.mark.parametrize("use_hash_index,class_budget", [(False, 256), (True, 1), (True, 256)])
def test_match_begun_before_evacuation_finishes_on_its_layout(use_hash_index, class_budget):
    """A batch begun on (2, 4) and finished after evacuate_shard (and a
    second begun on (2, 3) and finished after the rebalance) answers as
    the host walk does; with the block capacity forced down, each
    escalates on the layout it was launched against."""
    _jmesh, tmesh = _meshes((2, 4), "one_device")
    tr = TRouter(max_levels=6, use_hash_index=use_hash_index, mesh=tmesh)
    if use_hash_index:
        tr.index.class_budget = class_budget
        tr.index._class_free = list(range(class_budget - 1, -1, -1))
    tr.add_routes([(f"w/{i}/#", f"c{i}") for i in range(120)] + [("w/+/t", "all")])
    tr.device_table.default_mh = 4  # force per-block overflow
    topics = [f"w/{i}/t" for i in range(0, 120, 3)]
    want = [sorted(tr.match_filters(t)) for t in topics]
    p = tr.match_filters_begin(topics)
    assert tr.evacuate_shard(1)
    p2 = tr.match_filters_begin(topics)
    assert [sorted(x) for x in tr.match_filters_finish(p)] == want
    assert tr.rebalance_shard(1)
    assert [sorted(x) for x in tr.match_filters_finish(p2)] == want
    assert _answers(tr, topics) == want
    c = tr.telemetry.counters
    assert c.get("hash_overflow_retries_total", 0) + c.get("escalations_total", 0) >= 1
