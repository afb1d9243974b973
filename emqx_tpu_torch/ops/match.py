"""The dense batched wildcard match (counterpart of emqx_tpu/ops/match.py).

Host half: `encode_topics` (dictionary-encode a publish batch, with
inert pow2 padding), `GenMatchCache` (generation-stamped topic →
filters cache) and `oracle_match_rows` (the pure-Python ground truth).

Device half: kernel K2 `match_ids` (ops/csrc/dense_match.cu) and the
dense forms K9 `match_dense`, K10 `match_packed` and K11
`match_counts` (ops/csrc/packed_match.cu, three forms of one kernel),
each beside its plain PyTorch version (`*_ref`). All evaluate one
predicate (csrc/dense_pred.cuh)

    match[b, n] = active[n]
                & ~(dollar[b] & root_wild[n])              # $-root rule
                & (tlen[b] == plen[n]  if not has_hash[n]
                   else tlen[b] >= plen[n])                # level count
                & all_{i < plen[n]} (W[n,i] == '+' or W[n,i] == t[b,i])

K2 returns the first `max_hits` matching (topic, row) pairs in
(chunk, topic, row) order plus the exact total; K9 the bool [B, N]
matrix, K10 the same packed into uint32 [B, N/32] (bit k of word j is
row 32j + k), K11 the int32 [B] counts. `unpack_indices`/`unpack_all`
turn packed rows back into row ids on the host.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import topic as topic_mod
from ._build import I, LL, P, CudaKernel, raw_stream
from .table import EncodedFilters
from .vocab import PLUS, Vocab

# the CUDA kernels hold a tile of topics' words in shared memory;
# deeper tables are refused on the CUDA path
MAX_KERNEL_LEVELS = 128


class EncodedTopics(NamedTuple):
    """A batch of inbound topic names, dictionary-encoded (numpy arrays
    on the host, torch tensors on the device)."""

    ids: np.ndarray  # int32 [B, L]  (first L levels; OOV beyond vocab)
    lens: np.ndarray  # int32 [B]    (TRUE level count, may exceed L)
    dollar: np.ndarray  # bool [B]   (first level starts with '$')


def encode_topics(
    vocab: Vocab,
    topics: Sequence[str],
    max_levels: int,
    pad_to: int = 0,
) -> EncodedTopics:
    """Encode topic names for the kernels. Topics deeper than
    max_levels are still matched correctly against any representable
    filter: only the first `plen <= max_levels` levels are ever
    compared, and the true length is kept for the exact/'#' length
    checks.

    `pad_to` (when > len(topics)) grows the batch axis with INERT
    rows — zero levels, $-rooted — that match no representable filter
    (a 0-level topic only satisfies the length rule against a bare
    '#', which the $-root rule then rejects). Kernel shapes stay
    pow2-bounded; callers drop result rows with topic index >=
    len(topics)."""
    b = max(len(topics), pad_to)
    ids = np.zeros((b, max_levels), np.int32)
    lens = np.zeros(b, np.int32)
    dollar = np.zeros(b, bool)
    if pad_to > len(topics):
        dollar[len(topics):] = True
    lk = vocab.lookup
    for i, t in enumerate(topics):
        ws = t.split("/")
        lens[i] = len(ws)
        dollar[i] = ws[0].startswith("$")
        for j, w in enumerate(ws[:max_levels]):
            ids[i, j] = lk(w)
    return EncodedTopics(ids, lens, dollar)


# --- K2: the plain PyTorch version ---------------------------------------


def _match_block_ref(t_ids, t_len, t_dollar, words, plen, has_hash, root_wild, active):
    """bool [B, n] predicate over one block of rows."""
    tl = t_len[:, None]
    pl = plen[None, :]
    len_ok = torch.where(has_hash[None, :], tl >= pl, tl == pl)
    ok = len_ok & active[None, :] & ~(t_dollar[:, None] & root_wild[None, :])
    for i in range(t_ids.shape[1]):
        w = words[:, i][None, :]
        t = t_ids[:, i][:, None]
        ok &= (pl <= i) | (w == PLUS) | (w == t)
    return ok


def match_ids_ref(
    filters: EncodedFilters,
    topics: EncodedTopics,
    max_hits: int = 4096,
    chunk: int = 65536,
):
    """Plain PyTorch version of K2, on any device: (ti int32 [max_hits],
    ri int32 [max_hits], total int32 scalar)."""
    n = filters.words.shape[0]
    chunk = min(chunk, n)
    if n % chunk:
        raise ValueError(f"table rows {n} not a multiple of chunk {chunk}")
    dev = filters.words.device
    ti = torch.full((max_hits,), -1, dtype=torch.int32, device=dev)
    ri = torch.full((max_hits,), -1, dtype=torch.int32, device=dev)
    pos = 0
    for off in range(0, n, chunk):
        sl = slice(off, off + chunk)
        ok = _match_block_ref(
            topics.ids, topics.lens, topics.dollar,
            filters.words[sl], filters.prefix_len[sl], filters.has_hash[sl],
            filters.root_wild[sl], filters.active[sl],
        )
        idx = torch.nonzero(ok.reshape(-1)).squeeze(1)  # ascending flat
        take = max(0, min(idx.numel(), max_hits - pos))
        if take:
            ti[pos:pos + take] = (idx[:take] // chunk).to(torch.int32)
            ri[pos:pos + take] = (idx[:take] % chunk + off).to(torch.int32)
        pos += idx.numel()
    return ti, ri, torch.tensor(pos, dtype=torch.int32, device=dev)


# --- K2: the CUDA kernel --------------------------------------------------

_MATCH_IDS = CudaKernel(
    "match_ids", "dense_match.cu", "emqx_match_ids",
    [P, P, P, P, P, I, I, P, P, P, I, I, I, P, P, P, P, LL, P],
)

# dense_match.cu's launch geometry (its constants of the same names)
LIST_ROWS = 4096  # rows of the active mask one compaction block reads
DENSE_TB = 128  # topics of one match block
DENSE_WARPS = 16  # warps of one match block
DENSE_HCAP = 1024  # hits one match block records before it must walk again
DENSE_PARTS = 4  # parts of a chunk's live list, a match block each
SEG_TILE = 4096  # segments one block of the segment scan covers


class DenseGeometry(NamedTuple):
    """The launch of K2/K16 over `n_rows` rows (shards of n_loc) and
    `n_tiles` tiles of b_loc topics: its compaction blocks, live-list
    capacity, chunks a shard, match blocks (items: tile, chunk, part of
    the chunk's live list, topic tile), (tile, topic, chunk) segments,
    the hits one block records, and the int32 scratch it needs in all
    (the layout dense_match.cu carves: each region rounded up to 4
    ints)."""

    n_ranges: int
    list_cap: int
    n_chunks: int
    n_items: int
    n_seg: int
    hcap: int
    scratch: int


def dense_geometry(n_rows: int, n_loc: int, b_loc: int, chunk: int,
                   n_tiles: int = 1) -> DenseGeometry:
    if n_rows % n_loc:
        raise ValueError(f"{n_rows} rows are not whole shards of {n_loc}")
    n_ranges = -(-n_rows // LIST_ROWS)
    n_chunks = -(-n_loc // chunk)
    n_items = n_tiles * n_chunks * DENSE_PARTS * -(-b_loc // DENSE_TB)
    n_seg = n_tiles * b_loc * n_chunks
    regions = (
        n_ranges, n_ranges,  # live rows per compaction block, their offsets
        n_rows,  # the live list
        n_rows // n_loc * n_chunks + 1,  # list offset of each chunk, and the end
        n_seg * DENSE_PARTS, n_seg,  # counts of each part of a segment, offsets
        -(-n_seg // SEG_TILE), -(-n_seg // SEG_TILE), 1,  # tile sums, their prefixes, total
        n_items,  # hits per item
        4 * n_items * DENSE_HCAP,  # recorded hits (topic, rank in the part, ti, ri)
        n_items * DENSE_WARPS * DENSE_TB,  # warp offsets of overflowed items
    )
    return DenseGeometry(n_ranges, n_rows, n_chunks, n_items, n_seg, DENSE_HCAP,
                         sum(-(-r // 4) * 4 for r in regions))


def check_tensor(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def check_topics(topics: EncodedTopics, levels: int, device) -> int:
    b = topics.ids.shape[0]
    if b < 1:
        raise ValueError("empty topic batch")
    check_tensor("topics.ids", topics.ids, torch.int32, (b, levels), device)
    check_tensor("topics.lens", topics.lens, torch.int32, (b,), device)
    check_tensor("topics.dollar", topics.dollar, torch.bool, (b,), device)
    return b


def match_ids(
    filters: EncodedFilters,
    topics: EncodedTopics,
    max_hits: int = 4096,
    chunk: int = 65536,
):
    """Device-side dense match with compaction: returns (topic_idx
    int32 [max_hits], row_idx int32 [max_hits], total int32 scalar) on
    the tables' device. Slots beyond the true hit count are -1; when
    total > max_hits the caller re-runs with a larger bound.

    CUDA tensors launch kernel K2; CPU tensors take the plain version."""
    dev = filters.words.device
    if dev.type == "cpu":
        return match_ids_ref(filters, topics, max_hits, chunk)
    n, levels = check_filters(filters, dev)
    chunk = min(chunk, n)
    if n % chunk:
        raise ValueError(f"table rows {n} not a multiple of chunk {chunk}")
    b = check_topics(topics, levels, dev)
    ti = torch.empty(max_hits, dtype=torch.int32, device=dev)
    ri = torch.empty(max_hits, dtype=torch.int32, device=dev)
    total = torch.empty((), dtype=torch.int32, device=dev)
    geo = dense_geometry(n, n, b, chunk)
    scratch = torch.empty(geo.scratch, dtype=torch.int32, device=dev)
    _MATCH_IDS(
        filters.words.data_ptr(), filters.prefix_len.data_ptr(),
        filters.has_hash.data_ptr(), filters.root_wild.data_ptr(),
        filters.active.data_ptr(), n, levels,
        topics.ids.data_ptr(), topics.lens.data_ptr(), topics.dollar.data_ptr(),
        b, chunk, max_hits, ti.data_ptr(), ri.data_ptr(), total.data_ptr(),
        scratch.data_ptr(), geo.scratch,
        raw_stream(dev),
    )
    return ti, ri, total


# --- K9-K11: the plain PyTorch versions ----------------------------------


def match_dense_ref(filters: EncodedFilters, topics: EncodedTopics) -> torch.Tensor:
    """Plain version of K9: the bool [B, N] match matrix."""
    return _match_block_ref(topics.ids, topics.lens, topics.dollar, *filters)


def _pack_bits_ref(ok: torch.Tensor) -> torch.Tensor:
    """bool [B, N] -> uint32 [B, N//32], bit k of word j = row j*32+k
    (built in int32, whose shifts wrap as uint32's do)."""
    b, n = ok.shape
    grouped = ok.reshape(b, n // 32, 32).to(torch.int32)
    word = torch.zeros((b, n // 32), dtype=torch.int32, device=ok.device)
    for k in range(32):
        word |= grouped[:, :, k] << k
    return word.view(torch.uint32)


def _check_chunk(n: int, chunk: int) -> int:
    chunk = min(chunk, n)
    if n % chunk:
        raise ValueError(f"table rows {n} not a multiple of chunk {chunk}")
    if n % 32:
        raise ValueError(f"table rows {n} not a multiple of 32")
    return chunk


def match_packed_ref(
    filters: EncodedFilters, topics: EncodedTopics, chunk: int = 65536
) -> torch.Tensor:
    """Plain version of K10, chunk by chunk over the rows (the chunk
    bounds memory and changes nothing in the result)."""
    n = filters.words.shape[0]
    chunk = _check_chunk(n, chunk)
    return torch.cat([
        _pack_bits_ref(match_dense_ref(
            EncodedFilters(*(a[off:off + chunk] for a in filters)), topics))
        for off in range(0, n, chunk)
    ], dim=1)


def match_counts_ref(filters: EncodedFilters, topics: EncodedTopics) -> torch.Tensor:
    """Plain version of K11: int32 [B] matches per topic."""
    return match_dense_ref(filters, topics).sum(dim=1, dtype=torch.int32)


# --- K9-K11: the CUDA kernels ---------------------------------------------
# K9, the matrix, K10, the bitmap, and K11, the counts, are three forms
# of one kernel (packed_match.cu), each with its entry point. The bitmap
# and the counts take one argument list (with the mesh's tiles: K13
# launches them too); the matrix takes the same without the tiles and
# the output's width. FORM_PACKED and FORM_COUNTS name the mesh's two
# forms.

FORM_PACKED, FORM_COUNTS = 1, 2
_PACKED_ARGTYPES = [P, P, P, P, P, I, I, P, P, P, I, P, I, P, LL, P]
_DENSE_ARGTYPES = [P, P, P, P, P, I, I, P, P, P, I, P, P]
_MATCH_DENSE = CudaKernel("match_dense", "packed_match.cu", "emqx_match_dense",
                          _DENSE_ARGTYPES)
_MATCH_PACKED = CudaKernel("match_packed", "packed_match.cu", "emqx_match_packed",
                           _PACKED_ARGTYPES)
_MATCH_COUNTS = CudaKernel("match_counts", "packed_match.cu", "emqx_match_counts",
                           _PACKED_ARGTYPES)


def check_filters(filters: EncodedFilters, device) -> tuple:
    """(rows, levels) of a device filter table, checked for the kernels."""
    n, levels = filters.words.shape
    if not 1 <= levels <= MAX_KERNEL_LEVELS:
        raise ValueError(f"max_levels {levels} outside 1..{MAX_KERNEL_LEVELS}")
    check_tensor("words", filters.words, torch.int32, (n, levels), device)
    check_tensor("prefix_len", filters.prefix_len, torch.int32, (n,), device)
    for name in ("has_hash", "root_wild", "active"):
        check_tensor(name, getattr(filters, name), torch.bool, (n,), device)
    return n, levels


def _forms_args(
    filters: EncodedFilters, topics: EncodedTopics, n_loc: int, b_loc: int
) -> tuple:
    """The table and topic arguments every packed_match.cu entry takes
    first, checked."""
    dev = filters.words.device
    check_filters(filters, dev)
    check_topics(topics, filters.words.shape[1], dev)
    return (
        filters.words.data_ptr(), filters.prefix_len.data_ptr(),
        filters.has_hash.data_ptr(), filters.root_wild.data_ptr(),
        filters.active.data_ptr(), n_loc, filters.words.shape[1],
        topics.ids.data_ptr(), topics.lens.data_ptr(), topics.dollar.data_ptr(),
        b_loc,
    )


def launch_packed(
    kernel: CudaKernel, filters: EncodedFilters, topics: EncodedTopics,
    n_loc: int, b_loc: int, tiles: Optional[torch.Tensor], n_tiles: int,
    out: torch.Tensor, out_w: int,
) -> None:
    """Launch packed_match.cu over `n_tiles` tiles of n_loc rows and
    b_loc topics (tiles None: the one tile (0, 0, 0, 0)). Its bitmap
    entry (K10, the mesh's K13 packed) writes the uint32 `out` [B,
    out_w]; its counts entry (K11, the mesh's K13 counts) zeroes the
    int32 `out` [B] (out_w = B) and adds each tile's counts into it, so
    `out` may be uninitialised."""
    kernel(*_forms_args(filters, topics, n_loc, b_loc),
           None if tiles is None else tiles.data_ptr(), n_tiles, out.data_ptr(), out_w,
           raw_stream(filters.words.device))


def match_dense(filters: EncodedFilters, topics: EncodedTopics) -> torch.Tensor:
    """bool [B, N] match matrix (tests and small tables: B*N bytes).
    CUDA tensors launch kernel K9; CPU tensors take the plain version."""
    dev = filters.words.device
    if dev.type == "cpu":
        return match_dense_ref(filters, topics)
    n = filters.words.shape[0]
    b = topics.ids.shape[0]
    out = torch.empty((b, n), dtype=torch.bool, device=dev)
    _MATCH_DENSE(*_forms_args(filters, topics, n, b), out.data_ptr(), raw_stream(dev))
    return out


def match_packed(
    filters: EncodedFilters, topics: EncodedTopics, chunk: int = 65536
) -> torch.Tensor:
    """uint32 [B, N//32] packed match bitmap. `chunk` must divide the
    row count, as the reference asserts; it changes nothing in the
    result. CUDA tensors launch kernel K10; CPU tensors take the plain
    version."""
    dev = filters.words.device
    if dev.type == "cpu":
        return match_packed_ref(filters, topics, chunk)
    n = filters.words.shape[0]
    _check_chunk(n, chunk)
    b = topics.ids.shape[0]
    out = torch.empty((b, n // 32), dtype=torch.uint32, device=dev)
    launch_packed(_MATCH_PACKED, filters, topics, n, b, None, 1, out, n // 32)
    return out


def match_counts(filters: EncodedFilters, topics: EncodedTopics) -> torch.Tensor:
    """int32 [B] matches per topic. CUDA tensors launch kernel K11; CPU
    tensors take the plain version."""
    dev = filters.words.device
    if dev.type == "cpu":
        return match_counts_ref(filters, topics)
    n = filters.words.shape[0]
    b = topics.ids.shape[0]
    out = torch.empty(b, dtype=torch.int32, device=dev)  # zeroed by the kernel's entry
    launch_packed(_MATCH_COUNTS, filters, topics, n, b, None, 1, out, b)
    return out


def unpack_indices(packed_row: np.ndarray) -> np.ndarray:
    """uint32 [N//32] -> int64 row ids of set bits (host, numpy)."""
    bits = np.unpackbits(
        np.ascontiguousarray(packed_row, dtype=np.uint32).view(np.uint8),
        bitorder="little",
    )
    return np.flatnonzero(bits)


def unpack_all(packed: np.ndarray) -> List[np.ndarray]:
    """uint32 [B, N//32] -> per-topic arrays of matched row ids."""
    return [unpack_indices(packed[i]) for i in range(packed.shape[0])]


# --- host helpers -----------------------------------------------------------


class GenMatchCache:
    """Generation-stamped topic -> matched-filters cache.

    The front line of the publish hot path: hot topics resolve to
    their full match result (a tuple of filter strings) with one dict
    probe and skip the kernel entirely. Every route mutation bumps the
    owning Router's generation; entries carry the generation they were
    computed at and are lazily discarded on mismatch — churn costs one
    stale probe per re-touched topic, never an O(n) wholesale clear.
    Eviction at capacity is O(1) FIFO (oldest-inserted key).
    """

    __slots__ = ("capacity", "data", "hits", "misses", "evictions")

    def __init__(self, capacity: int = 8192):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self.data: dict = {}  # topic -> (generation, filters tuple)
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self.data)

    def get(self, topic: str, generation: int):
        """Filters tuple on a current-generation hit, else None."""
        e = self.data.get(topic)
        if e is not None:
            if e[0] == generation:
                self.hits += 1
                return e[1]
            # lazy discard: the slot frees now, the entry re-fills from
            # the kernel result at this topic's next publish
            del self.data[topic]
        self.misses += 1
        return None

    def put(self, topic: str, generation: int, filters) -> None:
        data = self.data
        if topic not in data and len(data) >= self.capacity:
            del data[next(iter(data))]
            self.evictions += 1
        data[topic] = (generation, filters)

    def hit_ratio(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0


def oracle_match_rows(table, topics: Sequence[str]) -> List[np.ndarray]:
    """Reference result via the pure-Python oracle (emqx_topic.erl:80-116
    semantics) — the ground truth the kernels are tested against."""
    out = []
    live = [(row, table.filter_words(row)) for row in table.rows()]
    for t in topics:
        tw = topic_mod.words(t)
        out.append(
            np.array(
                [row for row, fw in live if topic_mod.match(tw, fw)], np.int64
            )
        )
    return out
