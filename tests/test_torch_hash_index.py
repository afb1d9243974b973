"""The port's pattern-class hash index (emqx_tpu_torch.ops.hash_index:
the copied host ClassIndex and kernel K1's plain version) held against
emqx_tpu.ops.hash_index on identical state, carried across by
emqx_tpu_torch.convert.device_state_from_numpy.

All comparisons are exact: every output is an integer array.
"""

import random

import numpy as np
import pytest
import torch

from emqx_tpu.models.router import Router as JRouter
from emqx_tpu.ops import hash_index as JH
from emqx_tpu.ops import match as JM
from emqx_tpu.ops.table import FilterTable as JFilterTable
from emqx_tpu_torch.convert import device_state_from_numpy
from emqx_tpu_torch.device import to_device
from emqx_tpu_torch.models.router import Router
from emqx_tpu_torch.ops import hash_index as TH
from emqx_tpu_torch.ops import match as TM
from emqx_tpu_torch.ops.table import FilterTable

from test_match import random_filter, random_topic

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tier-1 runs test files side by side in worker processes; torch's
    CPU ops would otherwise take every core from the timing-sensitive
    tests next door."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _residual_mask(ix, capacity):
    mask = np.zeros(capacity, bool)
    if ix.residual_rows:
        mask[list(ix.residual_rows)] = True
    return mask


def _reference_state(seed, n_filters, class_budget=256, bulk=True):
    """A reference table + class index from a seeded filter stream."""
    rng = random.Random(seed)
    table = JFilterTable(max_levels=6, capacity=1024)
    ix = JH.ClassIndex(table.max_levels, class_budget=class_budget, min_slots=64)
    filters = [random_filter(rng) for _ in range(n_filters)]
    if bulk:
        rows = table.add_bulk(filters)
        ix.add_rows(rows, table, filters)
    else:
        rows = [table.add(f) for f in filters]
        for r in rows:
            ix.add_row(r, table)
    for r in rows[: n_filters // 5]:
        ix.remove_row(r)
        table.remove(r)
    topics = [random_topic(rng) for _ in range(64)]
    return table, ix, topics


def _run_both(table, ix, topics, max_hits, pad_to=0):
    meta = ix.packed_meta()
    enc = JM.encode_topics(table.vocab, topics, table.max_levels, pad_to=pad_to)
    want = JH.match_ids_hash(
        JH.ClassMeta(*(np.array(a) for a in meta)),
        JH.SlotArrays(*(np.array(a) for a in ix.slots)),
        enc, max_hits=max_hits,
    )
    state = device_state_from_numpy(
        table.snapshot(), meta, ix.slots, _residual_mask(ix, table.capacity), "cpu"
    )
    tenc = TM.EncodedTopics(*(to_device(a, CPU) for a in enc))
    got = TH.match_ids_hash(state.meta, state.slots, tenc, max_hits=max_hits)
    return want, got


def _assert_equal(want, got):
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())


# (seed, n_filters, class_budget, max_hits, pad_to, bulk)
CASES = [
    (0, 200, 256, 4096, 0, True),
    (1, 400, 256, 4096, 128, False),
    (2, 400, 8, 4096, 0, True),      # budget overflow: residual rows
    (3, 600, 256, 16, 0, True),      # max_hits < total: exact total
    (4, 300, 256, 1, 64, False),
]


@pytest.mark.parametrize("seed,n_filters,class_budget,max_hits,pad_to,bulk", CASES)
def test_match_ids_hash_equals_reference(seed, n_filters, class_budget, max_hits, pad_to, bulk):
    table, ix, topics = _reference_state(seed, n_filters, class_budget, bulk)
    want, got = _run_both(table, ix, topics, max_hits, pad_to)
    if max_hits < 64:
        assert int(got[2]) > max_hits  # the overflow case really overflows
    _assert_equal(want, got)


@pytest.mark.parametrize("bulk", [True, False])
def test_port_class_index_equals_reference(bulk):
    """The port's copied host index, fed the same adds/removes, holds
    the same slots, meta and residual rows as the reference."""
    rng = random.Random(21)
    jt = JFilterTable(max_levels=6, capacity=1024)
    tt = FilterTable(max_levels=6, capacity=1024)
    jix = JH.ClassIndex(6, class_budget=12, min_slots=64)
    tix = TH.ClassIndex(6, class_budget=12, min_slots=64)
    filters = list(dict.fromkeys(random_filter(rng) for _ in range(500)))
    if bulk:
        jr = jt.add_bulk(filters)
        tr = tt.add_bulk(filters)
        jix.add_rows(jr, jt, filters)
        tix.add_rows(tr, tt, filters)
    else:
        jr = [jt.add(f) for f in filters]
        tr = [tt.add(f) for f in filters]
        for a, b in zip(jr, tr):
            jix.add_row(a, jt)
            tix.add_row(b, tt)
    for a, b in list(zip(jr, tr))[::3]:
        jix.remove_row(a)
        jt.remove(a)
        tix.remove_row(b)
        tt.remove(b)
    for j, t in zip(jix.slots, tix.slots):
        assert np.array_equal(j, t)
    for j, t in zip(jix.packed_meta(), tix.packed_meta()):
        assert np.array_equal(j, t)
    assert jix.residual_rows == tix.residual_rows


def test_hash_host_batch_bit_identical():
    """The port's vectorized host hash equals the reference's bit for
    bit, on inputs with the high bit set, and equals the scalar mix."""
    rng = np.random.default_rng(5)
    cids = rng.integers(0, 2**32, size=257, dtype=np.uint64).astype(np.uint32)
    xs = rng.integers(0, 2**32, size=(257, 9), dtype=np.uint64).astype(np.uint32)
    xs[:, 0] |= np.uint32(0x80000000)
    cids[:8] |= np.uint32(0x80000000)
    jh1, jfp = JH._hash_host_batch(cids, xs)
    th1, tfp = TH._hash_host_batch(cids, xs)
    assert np.array_equal(jh1, th1) and np.array_equal(jfp, tfp)
    lit = [(i, int(x) - 1) for i, x in enumerate(xs[3].tolist()) if x]
    assert TH._hash_host(int(cids[3]), lit, 9) == (int(th1[3]), int(tfp[3]))


def test_hash_host_device_agreement():
    """Both (h1, fp) pairs the host placed are found by the port's probe."""
    table = FilterTable(max_levels=6, capacity=1024)
    ix = TH.ClassIndex(6, min_slots=64)
    for f in ["dev/+/room/#", "dev/a/room/#"]:
        ix.add_row(table.add(f), table)
    enc = TM.encode_topics(table.vocab, ["dev/a/room/1"], 6)
    state = device_state_from_numpy(
        table.snapshot(), ix.packed_meta(), ix.slots,
        _residual_mask(ix, table.capacity), "cpu",
    )
    tenc = TM.EncodedTopics(*(to_device(a, CPU) for a in enc))
    _ti, _bi, total, amb = TH.match_ids_hash(state.meta, state.slots, tenc, max_hits=64)
    assert int(total) == 2 and int(amb) == 0


def _forge_collision(r):
    """Make bucket B collide with bucket A on all hash bits, re-placed."""
    ix = r.index
    bid_a = ix._row_bucket[r._filter_row["col/+/x"]]
    bid_b = ix._row_bucket[r._filter_row["col/+/y"]]
    ix._bkt_h1[bid_b] = ix._bkt_h1[bid_a]
    ix._bkt_fp[bid_b] = ix._bkt_fp[bid_a]
    ix._rebuild(ix.n_buckets)


def test_amb_collision_equals_reference_and_falls_back():
    """Two distinct filters forged into a full 32+32-bit fingerprint
    collision: K1's plain version reports the same amb as the JAX
    kernel on identical state, and the port Router re-matches the batch
    on its host trie, staying oracle-exact."""
    routes = [("col/+/x", "nodeA"), ("col/+/y", "nodeB"), ("other/t", "nodeC")]
    jr = JRouter(max_levels=8)
    tr = Router(max_levels=8, device="cpu")
    for f, d in routes:
        jr.add_route(f, d)
        tr.add_route(f, d)
    _forge_collision(jr)
    _forge_collision(tr)
    topics = ["col/9/x", "col/9/y", "other/t", "col/9/z", "miss/x"]
    want, got = _run_both(jr.table, jr.index, topics, 64)
    _assert_equal(want, got)
    assert int(got[3]) > 0
    assert [sorted(o) for o in tr.match_filters_batch(topics)] == [
        ["col/+/x"], ["col/+/y"], ["other/t"], [], [],
    ]
    assert tr.telemetry.counters.get("ambiguous_batches_total") == 1
    assert tr.match_routes("col/9/x") == {"nodeA"}
