"""The dense batched wildcard match (counterpart of emqx_tpu/ops/match.py).

Host half: `encode_topics` (dictionary-encode a publish batch, with
inert pow2 padding), `GenMatchCache` (generation-stamped topic →
filters cache) and `oracle_match_rows` (the pure-Python ground truth).

Device half: kernel K2 `match_ids` (ops/csrc/dense_match.cu) and its
plain PyTorch version `match_ids_ref`, which evaluate

    match[b, n] = active[n]
                & ~(dollar[b] & root_wild[n])              # $-root rule
                & (tlen[b] == plen[n]  if not has_hash[n]
                   else tlen[b] >= plen[n])                # level count
                & all_{i < plen[n]} (W[n,i] == '+' or W[n,i] == t[b,i])

and return the first `max_hits` matching (topic, row) pairs in
(chunk, topic, row) order plus the exact total.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from . import topic as topic_mod
from ._build import I, P, CudaKernel
from .table import EncodedFilters
from .vocab import PLUS, Vocab

# the CUDA kernels stage row words per warp in shared memory; deeper
# tables are refused on the CUDA path
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
    [P, P, P, P, P, I, I, P, P, P, I, I, I, P, P, P, P, P],
)


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
    n, levels = filters.words.shape
    if not 1 <= levels <= MAX_KERNEL_LEVELS:
        raise ValueError(f"max_levels {levels} outside 1..{MAX_KERNEL_LEVELS}")
    chunk = min(chunk, n)
    if n % chunk:
        raise ValueError(f"table rows {n} not a multiple of chunk {chunk}")
    check_tensor("words", filters.words, torch.int32, (n, levels), dev)
    check_tensor("prefix_len", filters.prefix_len, torch.int32, (n,), dev)
    for name in ("has_hash", "root_wild", "active"):
        check_tensor(name, getattr(filters, name), torch.bool, (n,), dev)
    b = check_topics(topics, levels, dev)
    ti = torch.empty(max_hits, dtype=torch.int32, device=dev)
    ri = torch.empty(max_hits, dtype=torch.int32, device=dev)
    total = torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.empty(2 * (n // chunk) * b, dtype=torch.int32, device=dev)
    _MATCH_IDS(
        filters.words.data_ptr(), filters.prefix_len.data_ptr(),
        filters.has_hash.data_ptr(), filters.root_wild.data_ptr(),
        filters.active.data_ptr(), n, levels,
        topics.ids.data_ptr(), topics.lens.data_ptr(), topics.dollar.data_ptr(),
        b, chunk, max_hits, ti.data_ptr(), ri.data_ptr(), total.data_ptr(),
        scratch.data_ptr(), ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    return ti, ri, total


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
