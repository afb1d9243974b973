"""The port's dense match (emqx_tpu_torch.ops.match, kernel K2's plain
version) held against emqx_tpu.ops.match.match_ids on the same seeded
inputs, plus the copied host halves (table, vocab, topic encoding).

All comparisons are exact: every output is an integer array.
"""

import random

import numpy as np
import pytest
import torch

from emqx_tpu.ops import match as JM
from emqx_tpu.ops.table import FilterTable as JFilterTable
from emqx_tpu_torch.device import to_device
from emqx_tpu_torch.ops import match as TM
from emqx_tpu_torch.ops import topic as TT
from emqx_tpu_torch.ops.table import EncodedFilters, FilterTable, pad_pow2_batches

import chip_smoke

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


def _twin_tables(seed, n_filters, max_levels=6, capacity=1024):
    """The reference table and the port's table built by the same
    seeded add/remove sequence (numpy's generator picks the removals)."""
    rng = random.Random(seed)
    nrng = np.random.default_rng(seed)
    jt = JFilterTable(max_levels=max_levels, capacity=capacity)
    tt = FilterTable(max_levels=max_levels, capacity=capacity)
    filters = [random_filter(rng) for _ in range(n_filters)]
    rows = [(jt.add(f), tt.add(f)) for f in filters]
    for k in nrng.choice(len(rows), size=len(rows) // 3, replace=False):
        jr, tr = rows[int(k)]
        jt.remove(jr)
        tt.remove(tr)
    bulk = [random_filter(rng) for _ in range(n_filters // 4)]
    assert jt.add_bulk(bulk) == tt.add_bulk(bulk)
    topics = [random_topic(rng) for _ in range(48)]
    return jt, tt, topics


def _torch(arrays, cls):
    return cls(*(to_device(np.asarray(a), CPU) for a in arrays))


def _equal(jax_out, port_out):
    return all(
        np.array_equal(np.asarray(j), t.numpy()) for j, t in zip(jax_out, port_out)
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_table_and_encoding_match_reference(seed):
    jt, tt, topics = _twin_tables(seed, 300)
    for j, t in zip(jt.snapshot(), tt.snapshot()):
        assert np.array_equal(j, t)
    assert jt.vocab._ids == tt.vocab._ids
    je = JM.encode_topics(jt.vocab, topics, jt.max_levels, pad_to=64)
    te = TM.encode_topics(tt.vocab, topics, tt.max_levels, pad_to=64)
    for j, t in zip(je, te):
        assert np.array_equal(j, t)
    assert np.array_equal(
        pad_pow2_batches(np.arange(2500, dtype=np.int32), 1024)[-1, -3:],
        [2499, 2499, 2499],
    )


# (seed, n_filters, pad_to, max_hits, chunk, residual): residual False
# keeps the table's own active mask, True takes a residual subset of it,
# and a name edits the table as `_edit_table` says
CASES = [
    (3, 300, 0, 4096, 65536, False),    # one chunk covers the table
    (4, 300, 0, 4096, 256, False),      # chunk < N: (chunk, topic, row) order
    (5, 500, 0, 64, 256, False),        # max_hits < total: exact total kept
    (6, 300, 64, 4096, 512, False),     # pow2-padded topics match nothing
    (7, 600, 64, 32, 128, True),        # residual active mask + overflow
    (8, 800, 0, 4096, 1024, True),      # residual mask, larger table
    (14, 300, 0, 4096, 256, "last_chunk"),   # live rows only in the last chunk
    (15, 300, 0, 4096, 256, "all_dead"),     # no live row at all
    (16, 300, 0, 4096, 2048, "hash_rows"),   # one segment past a block's hit list
    (17, 300, 200, 4096, 512, False),   # B = 200: not a multiple of the topic tile
]


def _edit_table(snap, how, chunk):
    """The K2 edge cases, on the reference table's numpy snapshot:
    'last_chunk' copies the first chunk's rows into the last chunk and
    kills every other row; 'all_dead' kills every row; 'hash_rows' grows
    the table to 2,048 rows and makes DENSE_HCAP + 100 dead rows live
    '#' filters, so one (chunk, topic) segment holds more hits than one
    match block records."""
    f = {k: np.array(v) for k, v in snap._asdict().items()}
    n = len(f["active"])
    if how == "last_chunk":
        for v in f.values():
            v[n - chunk:] = v[:chunk]
        f["active"][:n - chunk] = False
    elif how == "all_dead":
        f["active"][:] = False
    else:
        grow = 2048 - n
        for k, v in f.items():
            f[k] = np.concatenate([v, np.zeros((grow,) + v.shape[1:], v.dtype)])
        rows = np.flatnonzero(~f["active"])[:TM.DENSE_HCAP + 100]
        f["words"][rows] = 0
        f["prefix_len"][rows] = 0
        f["has_hash"][rows] = True
        f["root_wild"][rows] = True
        f["active"][rows] = True
    return type(snap)(**f)


@pytest.mark.parametrize("seed,n_filters,pad_to,max_hits,chunk,residual", CASES)
def test_match_ids_equals_reference(seed, n_filters, pad_to, max_hits, chunk, residual):
    jt, tt, topics = _twin_tables(seed, n_filters)
    snap = jt.snapshot()
    if residual is True:
        # the router's residual leg: the same table with `active`
        # replaced by a mask over a subset of the live rows
        mask = snap.active & (np.random.default_rng(seed).random(len(snap.active)) < 0.5)
        snap = snap._replace(active=mask)
    elif residual:
        snap = _edit_table(snap, residual, chunk)
    enc = JM.encode_topics(jt.vocab, topics, jt.max_levels, pad_to=pad_to)
    want = JM.match_ids(snap, enc, max_hits=max_hits, chunk=chunk)
    got = TM.match_ids(
        _torch(snap, EncodedFilters), _torch(enc, TM.EncodedTopics),
        max_hits=max_hits, chunk=chunk,
    )
    assert int(got[2]) == int(want[2])
    if residual is False and max_hits < 4096:
        assert int(got[2]) > max_hits  # the overflow case really overflows
    if residual == "all_dead":
        assert int(got[2]) == 0 and (got[0].numpy() == -1).all()
    if residual == "last_chunk":
        assert int(got[2]) > 0 and (got[1][:int(got[2])].numpy() >= len(snap.active) - chunk).all()
    if residual == "hash_rows":
        # some (chunk, topic) segment really holds more than one block records
        non_dollar = int((~enc.dollar[:len(topics)]).sum())
        assert int(got[2]) >= non_dollar * (TM.DENSE_HCAP + 100) > 4096
    assert _equal(want, got)
    if pad_to:
        ti = got[0].numpy()
        assert not (ti >= len(topics)).any()


# (n_chunks, B, live): the geometry at N = chunk and N = 32 chunks, B up
# to 2,048, with no row and with every row live
GEOMETRY_CASES = [
    (n_chunks, b, live) for n_chunks in (1, 32) for b in (1, 1023, 2048)
    for live in ("none", "all")
]


@pytest.mark.parametrize("n_chunks,b,live", GEOMETRY_CASES)
def test_dense_geometry_covers_every_segment(n_chunks, b, live):
    """K2's launch geometry: the compaction blocks cover the rows, the
    live list holds every live row, the match blocks (items, in the
    kernel's (chunk, part, topic tile) order) own each part of each
    (chunk, topic) segment exactly once, the scratch holds every region;
    the plain version's total at the same shape is what the live rows
    give (every live row a '#' filter: it matches every non-$ topic)."""
    chunk = 128
    n = n_chunks * chunk
    geo = TM.dense_geometry(n, n, b, chunk)
    assert geo.n_chunks == n_chunks and geo.hcap == TM.DENSE_HCAP
    assert (geo.n_ranges - 1) * TM.LIST_ROWS < n <= geo.n_ranges * TM.LIST_ROWS
    n_live = n if live == "all" else 0
    assert n_live <= geo.list_cap == n
    n_tt = -(-b // TM.DENSE_TB)
    parts = TM.DENSE_PARTS
    assert geo.n_items == n_chunks * parts * n_tt and geo.n_seg == n_chunks * b
    owned = []
    for item in range(geo.n_items):
        tt, part, c = item % n_tt, item // n_tt % parts, item // (n_tt * parts) % n_chunks
        owned += [(c * b + t) * parts + part
                  for t in range(tt * TM.DENSE_TB, min(b, (tt + 1) * TM.DENSE_TB))]
    assert sorted(owned) == list(range(geo.n_seg * parts))
    n_stiles = -(-geo.n_seg // TM.SEG_TILE)
    regions = [geo.n_ranges, geo.n_ranges, n, n_chunks + 1, geo.n_seg * parts, geo.n_seg,
               n_stiles, n_stiles, 1,
               geo.n_items, 4 * geo.n_items * geo.hcap,
               geo.n_items * TM.DENSE_WARPS * TM.DENSE_TB]
    assert geo.scratch == sum(-(-r // 4) * 4 for r in regions) >= sum(regions)
    # the K16 form: 4 shards of n rows, 8 tiles
    mesh = TM.dense_geometry(4 * n, n, b, chunk, n_tiles=8)
    assert mesh.n_items == 8 * geo.n_items and mesh.n_seg == 8 * geo.n_seg
    assert mesh.scratch > geo.scratch
    f = EncodedFilters(
        torch.zeros((n, 4), dtype=torch.int32), torch.zeros(n, dtype=torch.int32),
        torch.ones(n, dtype=torch.bool), torch.ones(n, dtype=torch.bool),
        torch.full((n,), live == "all"),
    )
    rng = np.random.default_rng(b)
    t = TM.EncodedTopics(
        torch.from_numpy(rng.integers(2, 9, (b, 4), dtype=np.int32)),
        torch.from_numpy(rng.integers(0, 6, b, dtype=np.int32)),
        torch.from_numpy(rng.random(b) < 0.1),
    )
    _ti, _ri, total = TM.match_ids(f, t, max_hits=64, chunk=chunk)
    assert int(total) == n_live * int((~t.dollar).sum())


def test_match_ids_ref_is_the_oracle():
    """The plain version's pairs are exactly the oracle's matches."""
    _jt, tt, topics = _twin_tables(9, 300)
    enc = TM.encode_topics(tt.vocab, topics, tt.max_levels)
    ti, ri, total = TM.match_ids(
        _torch(tt.snapshot(), EncodedFilters), _torch(enc, TM.EncodedTopics)
    )
    total = int(total)
    pairs = sorted(zip(ti[:total].tolist(), ri[:total].tolist()))
    want = sorted(
        (i, int(r)) for i, rows in enumerate(TM.oracle_match_rows(tt, topics))
        for r in rows
    )
    assert pairs == want


def test_topic_oracle_and_share_parsing():
    assert TT.match("a/b/c", "a/+/#")
    assert TT.match("sport", "sport/#")
    assert not TT.match("$SYS/x", "+/x")
    assert not TT.match("$SYS/x", "#")
    assert TT.match("$SYS/x", "$SYS/#")
    assert TT.words("a//b") == ("a", "", "b")
    assert TT.parse_share("$share/g/a/+") == ("g", "a/+")
    assert TT.parse_share("a/+") == (None, "a/+")
    with pytest.raises(ValueError):
        TT.parse_share("$share/g")


def test_gen_match_cache_is_generation_stamped():
    c = TM.GenMatchCache(capacity=2)
    c.put("a", 1, ("x",))
    assert c.get("a", 1) == ("x",)
    assert c.get("a", 2) is None  # stale: discarded
    c.put("b", 2, ())
    c.put("c", 2, ())
    c.put("d", 2, ())
    assert c.evictions == 1 and len(c) == 2


# --- K9-K11: the dense forms ---------------------------------------------------

# (seed, n_filters, capacity, pad_to, chunk, edge, n_rows): edge None takes
# `_twin_tables`' table and 48 topics; a name takes chip_smoke.FORM_EDGES'
# table of that name (the cases the packed kernel treats apart, which
# phase 9 of chip_smoke.py also runs on the card), its topics and pad_to,
# the snapshot cut to n_rows rows: FORM_EDGE_ROWS (4.5 of the kernel's
# 256-row blocks), or the counts' own edge, COUNTS_EDGE_ROWS (not a
# multiple of 32: the counts and the matrix only)
FORM_CASES = [
    pytest.param(10, 300, 1024, 0, 65536, None, None, id="10-300-1024-0-65536"),  # one chunk
    pytest.param(11, 500, 1024, 64, 256, None, None, id="11-500-1024-64-256"),  # chunked, padded
    pytest.param(12, 900, 2048, 0, 512, None, None, id="12-900-2048-0-512"),  # a larger table
] + [pytest.param(0, 0, 2048, 0, 128, edge, chip_smoke.FORM_EDGE_ROWS, id=edge)
     for edge in chip_smoke.FORM_EDGES] + [
    pytest.param(0, 0, 2048, 0, None, chip_smoke.COUNTS_EDGE, chip_smoke.COUNTS_EDGE_ROWS,
                 id=f"{chip_smoke.COUNTS_EDGE}-rows{chip_smoke.COUNTS_EDGE_ROWS}"),
]


def _form_tables(seed, n_filters, capacity, pad_to, edge, n_rows):
    """(reference table, port table, topics, reference snapshot, pad_to)."""
    if edge is None:
        jt, tt, topics = _twin_tables(seed, n_filters, capacity=capacity)
        return jt, tt, topics, jt.snapshot(), pad_to
    (jt, tt), topics, pad_to = chip_smoke.form_edge_case(edge, JFilterTable, FilterTable)
    full = jt.snapshot()
    snap = type(full)(*(a[:n_rows] for a in full))
    _assert_edge(edge, snap, topics)
    if n_rows % 32:  # the cut leaves live rows out
        assert full.active[n_rows:].any()
    return jt, tt, topics, snap, pad_to


def _assert_edge(edge, snap, topics):
    """The edge case holds what it is named for."""
    act = np.pad(snap.active, (0, -len(snap.active) % 32))
    live = act.reshape(-1, 32).sum(axis=1)
    if edge == "dead_words":
        assert not snap.active[512:768].any()  # a whole dead block
        assert (live == 0).sum() > 8 and (live == 1).sum() >= 3  # dead words, lone rows
        assert len(snap.active) % 256 and snap.active[1024:].any()  # a live partial block
    elif edge == "deep":
        assert snap.prefix_len.max() > 16 and snap.prefix_len[snap.active].min() <= 16
    elif edge == "sys":
        assert (snap.active & snap.has_hash & (snap.prefix_len == 0)).sum() >= 16  # '#' rows
        assert sum(t.startswith("$SYS/") for t in topics) >= 24
    elif edge == "levels7":
        assert snap.words.shape[1] % 4  # no 16-byte row loads
    else:
        assert len(topics) % 16  # a partial topic group and tile


@pytest.mark.parametrize("seed,n_filters,capacity,pad_to,chunk,edge,n_rows", FORM_CASES)
def test_dense_forms_equal_reference(seed, n_filters, capacity, pad_to, chunk, edge, n_rows):
    jt, tt, topics, snap, pad_to = _form_tables(seed, n_filters, capacity, pad_to, edge,
                                                n_rows)
    enc = JM.encode_topics(jt.vocab, topics, jt.max_levels, pad_to=pad_to)
    f = _torch(snap, EncodedFilters)
    t = _torch(enc, TM.EncodedTopics)
    dense = TM.match_dense(f, t)
    assert dense.dtype == torch.bool
    assert np.array_equal(np.asarray(JM.match_dense(snap, enc)), dense.numpy())
    counts = TM.match_counts(f, t)
    assert np.array_equal(np.asarray(JM.match_counts(snap, enc)), counts.numpy())
    n = len(snap.active)
    oracle = [rows[rows < n] for rows in TM.oracle_match_rows(tt, topics)]
    assert [int(c) for c in counts[:len(topics)]] == [len(rows) for rows in oracle]
    if n % 32:  # counts only: the bitmap refuses such a table, as the reference does
        assert not counts[len(topics):].any()
        return
    packed = TM.match_packed(f, t, chunk=chunk)
    want = np.asarray(JM.match_packed(snap, enc, chunk=chunk))
    assert packed.dtype == torch.uint32
    assert np.array_equal(want, packed.view(torch.int32).numpy().view(np.uint32))
    # the host unpack of the port's bitmap is the oracle's row set
    host = packed.view(torch.int32).numpy().view(np.uint32)
    for i, rows in enumerate(oracle):
        assert np.array_equal(TM.unpack_indices(host[i]), JM.unpack_indices(want[i]))
        assert np.array_equal(TM.unpack_all(host)[i], rows)
        assert int(counts[i]) == len(rows)
    if pad_to:
        assert not host[len(topics):].any()  # the pad topics match nothing
    if edge == "deep":  # rows past 16 levels match
        assert any((snap.prefix_len[rows] > 16).any() for rows in oracle)


def test_match_packed_refuses_what_the_reference_refuses():
    jt, _tt, topics = _twin_tables(13, 100)
    enc = JM.encode_topics(jt.vocab, topics, jt.max_levels)
    f = _torch(jt.snapshot(), EncodedFilters)
    t = _torch(enc, TM.EncodedTopics)
    with pytest.raises(ValueError, match="chunk"):
        TM.match_packed(f, t, chunk=768)  # 1024 rows: not a multiple
    with pytest.raises(AssertionError):
        JM.match_packed(jt.snapshot(), enc, chunk=768)
    # 32 rows short of a word boundary
    short = EncodedFilters(*(a[:1000] for a in f))
    with pytest.raises(ValueError, match="multiple of 32"):
        TM.match_packed(short, t, chunk=1000)
