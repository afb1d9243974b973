"""Flattened wildcard-filter table — the host source of truth for the
device-resident match kernels (the port's own copy of
emqx_tpu/ops/table.py; `add_bulk`'s split/intern pass runs in the native
churn core, `encode_filters`, unless its twin is selected).

Instead of the reference's ordered-set filter index
(apps/emqx/src/emqx_router.erl:133-162 ?ROUTE_TAB_FILTERS +
emqx_topic_index keys), every filter becomes one row of fixed-width
arrays sized for a single batched kernel launch:

  words      int32 [C, L]   word ids; PLUS(1) marks '+'; 0-padded
  prefix_len int32 [C]      levels before '#' (== level count if none)
  has_hash   bool  [C]      filter ends in '#'
  root_wild  bool  [C]      first level is '+' or '#' ($-topic rule)
  active     bool  [C]      live row (False == tombstone)

Rows are identified by index; deletion tombstones the row and recycles
it for the next add (so device buffers update in place without
compaction). Capacity grows in powers of two; a capacity bump is the
only event that re-uploads the whole table.

Filters deeper than L levels cannot be represented and raise
FilterTooDeep — the router keeps those on a host-side fallback path
(mirrors the v2 split where exact topics stay in plain ets,
emqx_router.erl:511-516).
"""

from __future__ import annotations

from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from . import speedups as _speedups
from . import topic as topic_mod
from .vocab import OOV, PLUS, Vocab

DEFAULT_MAX_LEVELS = 16
MIN_CAPACITY = 1024


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    return 1 << max(0, n - 1).bit_length()


def pad_pow2_batches(dirty: np.ndarray, k: int) -> np.ndarray:
    """Shape a drained dirty-index array for the batched scatter sync:
    [n_batches, k] int32 with idempotent padding (the last real index
    repeats, so padding rewrites one row it already wrote) and
    n_batches rounded up to a power of two, keeping recompiles
    log-bounded across workload sizes. The one shape discipline every
    device mirror (filter rows, cuckoo slots, fanout segments/edges)
    shares."""
    total = len(dirty)
    n_batches = next_pow2(-(-total // k))
    idx = np.full(n_batches * k, dirty[-1], np.int32)
    idx[:total] = dirty
    return idx.reshape(n_batches, k)


class FilterTooDeep(ValueError):
    """Filter has more non-'#' levels than the table's max_levels."""


class EncodedFilters(NamedTuple):
    """The array-of-struct view handed to match kernels (numpy arrays on
    the host, torch tensors on the device)."""

    words: np.ndarray  # int32 [C, L]
    prefix_len: np.ndarray  # int32 [C]
    has_hash: np.ndarray  # bool  [C]
    root_wild: np.ndarray  # bool  [C]
    active: np.ndarray  # bool  [C]


class FilterTable:
    """Incrementally-updated flattened filter table (host numpy)."""

    def __init__(
        self,
        max_levels: int = DEFAULT_MAX_LEVELS,
        capacity: int = MIN_CAPACITY,
        vocab: Optional[Vocab] = None,
    ) -> None:
        assert capacity >= 32 and capacity & (capacity - 1) == 0
        self.max_levels = max_levels
        self.vocab = vocab if vocab is not None else Vocab()
        self.capacity = capacity
        self.words = np.zeros((capacity, max_levels), np.int32)
        self.prefix_len = np.zeros(capacity, np.int32)
        self.has_hash = np.zeros(capacity, bool)
        self.root_wild = np.zeros(capacity, bool)
        self.active = np.zeros(capacity, bool)
        self._filters: List[Optional[Tuple[str, ...]]] = [None] * capacity
        # canonical filter string per row (== '/'.join(_filters[row])):
        # the class index keys its dedup map by string, and a stored
        # reference beats a join per insert on the churn path
        self._fstr: List[Optional[str]] = [None] * capacity
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        self._count = 0
        # rows touched since the last drain; consumed by the device
        # sync.  A LIST (duplicates deduped at drain): appends are the
        # churn hot path
        self.dirty: List[int] = []
        self.grew = False  # capacity changed since last drain → full upload
        # table generation: bumped on every mutation that changes the
        # FILTER SET (the same events that dirty rows). Match caches
        # stamp entries with the generation they were computed at and
        # lazily discard on mismatch — route churn never triggers an
        # O(n) wholesale clear. Survives drain_dirty: validity is a
        # host-truth question, not a device-sync one.
        self.generation = 0

    def __len__(self) -> int:
        return self._count

    def add(self, flt: str) -> int:
        """Insert a filter, returning its row id. The same filter string
        may be inserted under multiple rows (the router dedups per dest,
        like the bag semantics of ?ROUTE_TAB_FILTERS)."""
        ws = topic_mod.words(flt)
        hh = ws[-1] == "#"
        prefix = ws[:-1] if hh else ws
        if len(prefix) > self.max_levels:
            raise FilterTooDeep(flt)
        if not self._free:
            self._grow()
        row = self._free.pop()
        ids = [self.vocab.intern(w) for w in prefix]
        self.words[row, : len(ids)] = ids
        self.words[row, len(ids) :] = OOV
        self.prefix_len[row] = len(prefix)
        self.has_hash[row] = hh
        self.root_wild[row] = (hh and len(prefix) == 0) or (
            len(prefix) > 0 and prefix[0] == "+"
        )
        self.active[row] = True
        self._filters[row] = ws
        self._fstr[row] = flt
        self._count += 1
        self.dirty.append(row)
        self.generation += 1
        return row

    def add_bulk(
        self,
        filters: Sequence[str],
        parts: Optional[Sequence[List[str]]] = None,
    ) -> List[int]:
        """Batch add: one vectorized scatter for the whole burst
        instead of ~5 numpy scalar writes per row, with interning
        refcounts batched through one Counter.update. Returns one row
        id per filter, -1 where the filter is too deep (the caller's
        FilterTooDeep degradation, kept in-band so one bad filter
        doesn't abort the batch). `parts` (when given) carries the
        filters pre-split so storm callers split each string once."""
        sp = _speedups.load()
        if sp is not None:
            return self._add_bulk_native(sp, filters)
        L = self.max_levels
        pad = [OOV] * L
        rows: List[int] = []
        padded: List[List[int]] = []
        plen_b: List[int] = []
        hh_b: List[bool] = []
        rw_b: List[bool] = []
        kept_rows: List[int] = []
        vocab = self.vocab
        vocab.ensure_refs(vocab._next + len(filters) * (L + 1))
        get_id = vocab._ids.get
        create = vocab._create
        all_ids: List[int] = []
        ai_extend = all_ids.extend
        filters_store = self._filters
        fstr_store = self._fstr
        free = self._free
        for j, flt in enumerate(filters):
            ws = parts[j] if parts is not None else flt.split("/")
            hh = ws[-1] == "#"
            prefix = ws[:-1] if hh else ws
            np_ = len(prefix)
            if np_ > L:
                rows.append(-1)
                continue
            while not free:
                self._grow()
                free = self._free
            row = free.pop()
            # real ids are >=1, so `or` only fires on a miss (None)
            ids = [
                get_id(w) or (PLUS if w == "+" else create(w))
                for w in prefix
            ]
            ai_extend(ids)
            padded.append(ids + pad[np_:])
            plen_b.append(np_)
            hh_b.append(hh)
            rw_b.append((hh and not prefix) or (np_ > 0 and prefix[0] == "+"))
            filters_store[row] = tuple(ws)
            fstr_store[row] = flt
            rows.append(row)
            kept_rows.append(row)
        if all_ids:
            vocab.bump_many(all_ids)
        if kept_rows:
            rr = np.asarray(kept_rows, np.int64)
            self.words[rr] = np.asarray(padded, np.int32)
            self.prefix_len[rr] = plen_b
            self.has_hash[rr] = hh_b
            self.root_wild[rr] = rw_b
            self.active[rr] = True
            self._count += len(kept_rows)
            self.dirty.extend(kept_rows)
            self.generation += 1
        return rows

    def _add_bulk_native(self, sp, filters: Sequence[str]) -> List[int]:
        """add_bulk with the split/intern/encode pass in C
        (the churn core's encode_filters): the C side mutates the
        vocab's own dicts, so state is identical to the python path."""
        L = self.max_levels
        v = self.vocab
        v.ensure_refs(v._next + len(filters) * (L + 1))
        # the C side reads and writes v._next itself so a partial batch
        # can never leave created words ahead of a stale counter
        ws_l, ids_b, plen_b, hh_b, rw_b = sp.encode_filters(filters, v, L)
        plen = np.frombuffer(plen_b, np.int32)
        keep_l = (plen >= 0).tolist()
        rows: List[int] = []
        kept_rows: List[int] = []
        free = self._free
        filters_store = self._filters
        fstr_store = self._fstr
        for j, flt in enumerate(filters):
            if not keep_l[j]:
                rows.append(-1)
                continue
            while not free:
                self._grow()
                free = self._free
            row = free.pop()
            filters_store[row] = ws_l[j]
            fstr_store[row] = flt
            rows.append(row)
            kept_rows.append(row)
        if kept_rows:
            rr = np.asarray(kept_rows, np.int64)
            sel = np.flatnonzero(plen >= 0)
            ids = np.frombuffer(ids_b, np.int32).reshape(-1, L)
            # C memsets padding to 0 == OOV, matching the python path
            self.words[rr] = ids[sel]
            self.prefix_len[rr] = plen[sel]
            self.has_hash[rr] = np.frombuffer(hh_b, np.uint8)[sel].astype(bool)
            self.root_wild[rr] = np.frombuffer(rw_b, np.uint8)[sel].astype(bool)
            self.active[rr] = True
            self._count += len(kept_rows)
            self.dirty.extend(kept_rows)
            self.generation += 1
        return rows

    def remove(self, row: int) -> None:
        fs = self._fstr[row]
        assert fs is not None and self.active[row], f"row {row} not live"
        ws = fs.split("/")
        hh = ws[-1] == "#"
        for w in ws[:-1] if hh else ws:
            self.vocab.release(w)
        self.active[row] = False
        self.words[row, :] = OOV
        self.prefix_len[row] = 0
        self.has_hash[row] = False
        self.root_wild[row] = False
        self._filters[row] = None
        self._fstr[row] = None
        self._free.append(row)
        self._count -= 1
        self.dirty.append(row)
        self.generation += 1

    def filter_words(self, row: int) -> Tuple[str, ...]:
        ws = self._filters[row]
        if ws is None:
            # the churn core stores only the string; materialize (and
            # cache) the words tuple on first host-side use
            fs = self._fstr[row]
            assert fs is not None, f"row {row} not live"
            ws = tuple(fs.split("/"))
            self._filters[row] = ws
        return ws

    def filter_str(self, row: int) -> str:
        fs = self._fstr[row]
        assert fs is not None, f"row {row} not live"
        return fs

    def rows(self) -> Iterator[int]:
        """Iterate live row ids."""
        return (i for i in range(self.capacity) if self.active[i])

    def snapshot(self) -> EncodedFilters:
        """Zero-copy numpy view of the current table state."""
        return EncodedFilters(
            self.words, self.prefix_len, self.has_hash, self.root_wild, self.active
        )

    def drain_dirty(self) -> np.ndarray:
        """Return-and-clear the dirty row ids (sorted int32 array)."""
        rows = np.unique(np.asarray(self.dirty, np.int32))
        self.dirty.clear()
        self.grew = False
        return rows

    def _grow(self) -> None:
        old = self.capacity
        new = old * 2
        self.words = np.vstack(
            [self.words, np.zeros((old, self.max_levels), np.int32)]
        )
        self.prefix_len = np.concatenate([self.prefix_len, np.zeros(old, np.int32)])
        self.has_hash = np.concatenate([self.has_hash, np.zeros(old, bool)])
        self.root_wild = np.concatenate([self.root_wild, np.zeros(old, bool)])
        self.active = np.concatenate([self.active, np.zeros(old, bool)])
        self._filters.extend([None] * old)
        self._fstr.extend([None] * old)
        self._free.extend(range(new - 1, old - 1, -1))
        self.capacity = new
        self.grew = True
