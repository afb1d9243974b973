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


# (seed, n_filters, pad_to, max_hits, chunk, residual)
CASES = [
    (3, 300, 0, 4096, 65536, False),    # one chunk covers the table
    (4, 300, 0, 4096, 256, False),      # chunk < N: (chunk, topic, row) order
    (5, 500, 0, 64, 256, False),        # max_hits < total: exact total kept
    (6, 300, 64, 4096, 512, False),     # pow2-padded topics match nothing
    (7, 600, 64, 32, 128, True),        # residual active mask + overflow
    (8, 800, 0, 4096, 1024, True),      # residual mask, larger table
]


@pytest.mark.parametrize("seed,n_filters,pad_to,max_hits,chunk,residual", CASES)
def test_match_ids_equals_reference(seed, n_filters, pad_to, max_hits, chunk, residual):
    jt, tt, topics = _twin_tables(seed, n_filters)
    snap = jt.snapshot()
    if residual:
        # the router's residual leg: the same table with `active`
        # replaced by a mask over a subset of the live rows
        mask = snap.active & (np.random.default_rng(seed).random(len(snap.active)) < 0.5)
        snap = snap._replace(active=mask)
    enc = JM.encode_topics(jt.vocab, topics, jt.max_levels, pad_to=pad_to)
    want = JM.match_ids(snap, enc, max_hits=max_hits, chunk=chunk)
    got = TM.match_ids(
        _torch(snap, EncodedFilters), _torch(enc, TM.EncodedTopics),
        max_hits=max_hits, chunk=chunk,
    )
    assert int(got[2]) == int(want[2])
    if not residual and max_hits < 4096:
        assert int(got[2]) > max_hits  # the overflow case really overflows
    assert _equal(want, got)
    if pad_to:
        ti = got[0].numpy()
        assert not (ti >= len(topics)).any()


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

# (seed, n_filters, capacity, pad_to, chunk)
FORM_CASES = [
    (10, 300, 1024, 0, 65536),   # one chunk covers the table
    (11, 500, 1024, 64, 256),    # chunked, pow2-padded topics
    (12, 900, 2048, 0, 512),     # a larger table, chunked
]


@pytest.mark.parametrize("seed,n_filters,capacity,pad_to,chunk", FORM_CASES)
def test_dense_forms_equal_reference(seed, n_filters, capacity, pad_to, chunk):
    jt, tt, topics = _twin_tables(seed, n_filters, capacity=capacity)
    enc = JM.encode_topics(jt.vocab, topics, jt.max_levels, pad_to=pad_to)
    f = _torch(jt.snapshot(), EncodedFilters)
    t = _torch(enc, TM.EncodedTopics)
    dense = TM.match_dense(f, t)
    assert dense.dtype == torch.bool
    assert np.array_equal(np.asarray(JM.match_dense(jt.snapshot(), enc)), dense.numpy())
    packed = TM.match_packed(f, t, chunk=chunk)
    want = np.asarray(JM.match_packed(jt.snapshot(), enc, chunk=chunk))
    assert packed.dtype == torch.uint32
    assert np.array_equal(want, packed.view(torch.int32).numpy().view(np.uint32))
    counts = TM.match_counts(f, t)
    assert np.array_equal(np.asarray(JM.match_counts(jt.snapshot(), enc)), counts.numpy())
    # the host unpack of the port's bitmap is the oracle's row set
    oracle = TM.oracle_match_rows(tt, topics)
    host = packed.view(torch.int32).numpy().view(np.uint32)
    for i, rows in enumerate(oracle):
        assert np.array_equal(TM.unpack_indices(host[i]), JM.unpack_indices(want[i]))
        assert np.array_equal(TM.unpack_all(host)[i], rows)
        assert int(counts[i]) == len(rows)


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
