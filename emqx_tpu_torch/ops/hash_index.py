"""Pattern-class hash index (counterpart of emqx_tpu/ops/hash_index.py:
the host `ClassIndex`, whose batched dedup runs in the native churn
core's `index_dedup` unless its twin is selected, and kernel K1).

The dense kernel (ops/match.py) streams every filter row per topic:
B×N×L compares.
This module exploits the structure of real subscription tables: they
contain FEW distinct wildcard *skeletons* (the positions of '+'/'#'
and the prefix length — the reference observes the same regularity in
its learned-topic-structure trie, apps/emqx_durable_storage/src/
emqx_ds_lts.erl:20-45, and in the retainer's reordered word
projections, apps/emqx_retainer/src/emqx_retainer_index.erl:17-50).

Grouping filters by skeleton ("class"), all filters of one class agree
on which level positions are literals. Matching one topic against an
entire class is then ONE hash probe: project the topic's words at the
class's literal positions, hash, and look up the table. Per batch the
kernel does B×C hash mixes + B×C×2 bucket gathers instead of B×N×L
compares — for C≈32 classes that is ~1000× less work than the dense
kernel at N=1M.

Table layout — bucketized cuckoo, not linear probing:

* The table is `n_buckets` (pow2) buckets of BUCKET_W=4 slots each,
  stored flat ([n_buckets*4] fp/bucket arrays). A key hashes to TWO
  candidate buckets: b1 = h1 & mask and b2 = b1 XOR spread(fp). The
  XOR derivation is involutive (either bucket recovers the other from
  the stored fingerprint alone) and spread(fp) is always odd, so
  b1 ≠ b2. d=2 choices × 4-wide buckets sustain ≥75% load (theory
  threshold ~0.98).
* Inserts take any empty lane in b1/b2, else a bounded random-walk
  eviction (cuckoo kicks) displaces residents to their alternate
  buckets.
* A slot holds (fingerprint u32, bucket id i32); each bucket
  additionally packs its four lanes' probe BYTES (max(fp>>24,1), 0 =
  empty) into one u32 **probe word**. A **bucket id** names one
  distinct filter string; all routes for that filter (1 or 100k
  dests) share it, so wide fanout costs one slot and one device hit.
* TWO-PHASE probe: the dense phase gathers exactly TWO u32 probe
  words per (topic, class); lane hits fall out of a zero-byte bit
  trick on the probe words. The u32 fingerprint +
  bucket-id arrays are touched ONLY at candidate positions (sparse),
  so per-batch device-memory traffic stays O(B·C·4B + matches), not
  O(N).
* Deletion just empties the slot — cuckoo lookups probe a fixed pair
  of buckets, so there are no probe chains to preserve (no
  tombstones, unlike a linear-probe table).
* Exactness: equal projections hash equal (no false negatives); hash
  collisions are possible but the host verifies each candidate
  (topic, bucket) pair against the pure oracle before expanding it to
  destinations — the "false-positive verify on host" scheme SURVEY.md
  §7 prescribes for unbounded vocabularies.
* Skeleton budget: at most C classes (static shape). Tables with
  adversarially many skeletons overflow into a *residual* row set that
  the caller matches with the dense kernel — graceful degradation, not
  a cliff.

The kernel returns compacted (topic_idx, bucket_id) pairs with an
exact total, so an undersized result buffer escalates to
next_pow2(total) and never falls back to full bitmaps.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from . import speedups as _speedups
from ._build import LL, I, P, CudaKernel, raw_stream
from .match import MAX_KERNEL_LEVELS, EncodedTopics, check_tensor, check_topics
from .table import FilterTable
from .vocab import PLUS

DEFAULT_CLASS_BUDGET = 256
BUCKET_W = 4  # slots per bucket: one u32 probe word per bucket
MAX_KICKS = 512  # eviction-walk bound before a rebuild
MIN_SLOTS = 1024
MAX_LOAD_NUM, MAX_LOAD_DEN = 3, 4  # rebuild past 75% fill
# the BULK path grows earlier: at 75% fill ~10% of burst keys hit full
# candidate buckets and pay a ~30us python eviction walk each; at 2/3
# it's ~3%. Final table sizes are identical (pow2 growth) — only the
# growth POINT moves, so read-path memory is unchanged.
BULK_LOAD_NUM, BULK_LOAD_DEN = 2, 3

M32 = 0xFFFFFFFF
_H1_SEED, _H1_CLS, _H1_MUL = 0x811C9DC5, 0x9E3779B1, 16777619
_FP_SEED, _FP_CLS, _FP_XOR, _FP_MUL = 0x2545F491, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F
_ALT_MUL = 0x9E3779B9  # odd: (fp|1)*_ALT_MUL is odd, so alt-bucket != bucket


def _hash_host(class_id: int, lit_words: List[Tuple[int, int]], max_levels: int):
    """Host mirror of the device hash. lit_words = [(position, word_id)]
    for the literal positions only; all other positions contribute 0.
    Must stay bit-identical to the mixing loop in match_ids_hash."""
    xs = [0] * max_levels
    for pos, wid in lit_words:
        xs[pos] = (wid + 1) & M32
    h1 = (_H1_SEED ^ ((class_id * _H1_CLS) & M32)) & M32
    fp = (_FP_SEED + ((class_id * _FP_CLS) & M32)) & M32
    for x in xs:
        h1 = ((h1 ^ x) * _H1_MUL) & M32
        fp = ((fp ^ ((x * _FP_XOR) & M32)) * _FP_MUL) & M32
    return h1, fp


def _alt_bucket(b: int, fp: int, mask: int) -> int:
    """The other candidate bucket. Involutive in b, and never b itself
    (the spread is odd so at least bit 0 flips)."""
    return b ^ ((((fp | 1) * _ALT_MUL) & M32) & mask)


def _hash_host_batch(
    cids: np.ndarray, xs: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized _hash_host: cids [B], xs uint32 [B, max_levels] with
    literal positions holding word_id+1 and everything else 0. Must
    stay bit-identical to the scalar loop (and the device kernel)."""
    cids = np.ascontiguousarray(cids, np.uint32)
    xs = np.ascontiguousarray(xs, np.uint32)
    with np.errstate(over="ignore"):
        h1 = np.uint32(_H1_SEED) ^ (cids * np.uint32(_H1_CLS))
        fp = np.uint32(_FP_SEED) + (cids * np.uint32(_FP_CLS))
        for lvl in range(xs.shape[1]):
            x = xs[:, lvl]
            h1 = (h1 ^ x) * np.uint32(_H1_MUL)
            fp = (fp ^ (x * np.uint32(_FP_XOR))) * np.uint32(_FP_MUL)
    return h1, fp


class ClassMeta(NamedTuple):
    """Per-class metadata arrays, [C] each (device or host numpy)."""

    plen: np.ndarray  # int32 — levels before '#'
    has_hash: np.ndarray  # bool — skeleton ends in '#'
    root_wild: np.ndarray  # bool — first level is '+'/'#' ($-topic rule)
    plus: np.ndarray  # uint32 — bitmask of '+' positions (< plen)
    active: np.ndarray  # bool — class id in use


class SlotArrays(NamedTuple):
    """The cuckoo table. fp/bucket are flat [n_buckets*BUCKET_W];
    bucket: -1 empty, >=0 live bucket id (fingerprint only valid when
    >=0). probe is [n_buckets]: lane l's byte (bits 8l..8l+7) holds
    max(fp >> 24, 1) for a live slot, 0 for empty — the phase-1
    filter never sees a live slot as empty."""

    fp: np.ndarray  # uint32 [n_buckets*W]
    bucket: np.ndarray  # int32 [n_buckets*W]
    probe: np.ndarray  # uint32 [n_buckets]


def _fp8_of(fp):
    """Probe byte of a full fingerprint (host int or numpy array)."""
    if isinstance(fp, int):
        return max(fp >> 24, 1)
    return np.maximum(fp >> 24, 1).astype(np.uint32)


def _pack_probe(slots: SlotArrays) -> None:
    """Recompute the whole probe array from fp/bucket (vectorized)."""
    lanes = np.where(
        slots.bucket >= 0, _fp8_of(slots.fp), np.uint32(0)
    ).reshape(-1, BUCKET_W)
    w = lanes[:, 0]
    for l in range(1, BUCKET_W):
        w = w | (lanes[:, l] << np.uint32(8 * l))
    slots.probe[:] = w


def _refresh_probe_many(slots: SlotArrays, buckets: np.ndarray) -> None:
    """Vectorized probe-word recompute for a set of bucket indices."""
    sub_b = slots.bucket.reshape(-1, BUCKET_W)[buckets]
    sub_f = slots.fp.reshape(-1, BUCKET_W)[buckets]
    lanes = np.where(
        sub_b >= 0,
        np.maximum(sub_f >> np.uint32(24), np.uint32(1)),
        np.uint32(0),
    ).astype(np.uint32)
    w = lanes[:, 0].copy()
    for l in range(1, BUCKET_W):
        w |= lanes[:, l] << np.uint32(8 * l)
    slots.probe[buckets] = w


def _refresh_probe(slots: SlotArrays, b: int) -> None:
    """Recompute one bucket's probe word after slot writes."""
    base = b * BUCKET_W
    bkt = slots.bucket[base : base + BUCKET_W].tolist()
    fps = slots.fp[base : base + BUCKET_W].tolist()
    w = 0
    for l in range(BUCKET_W):
        if bkt[l] >= 0:
            w |= max(fps[l] >> 24, 1) << (8 * l)
    slots.probe[b] = w


class _NeedRebuild(Exception):
    pass


def build_slots(
    h1: np.ndarray,
    fp: np.ndarray,
    ids: np.ndarray,
    min_buckets: int = MIN_SLOTS // BUCKET_W,
    dirty: Optional[Set[int]] = None,
) -> Tuple[SlotArrays, np.ndarray, int]:
    """Vectorized bulk cuckoo placement: place every (h1[i], fp[i]) key
    with payload ids[i], growing until all fit. Returns
    (slots, pos int64[n] — the flat slot index per key, n_buckets).

    Greedy rounds place each pending key in the less-loaded of its two
    candidate buckets (ties and overfull lanes resolved by a stable
    sort-and-rank sweep, all numpy); the handful of stragglers that a
    greedy pass can't seat at ≤75% load finish through the same
    eviction walk single inserts use. `dirty` (when given) collects
    every written slot index — the incremental-sync path for in-place
    loads.
    """
    n = len(h1)
    h1 = np.ascontiguousarray(h1, np.uint32)
    fp = np.ascontiguousarray(fp, np.uint32)
    ids = np.ascontiguousarray(ids, np.int32)
    need = -(-n * MAX_LOAD_DEN // (BUCKET_W * MAX_LOAD_NUM)) if n else 0
    n_buckets = max(min_buckets, 1)
    while n_buckets < need:
        n_buckets *= 2
    assert n_buckets & (n_buckets - 1) == 0
    while True:
        mask = np.uint32(n_buckets - 1)
        slots = SlotArrays(
            np.zeros(n_buckets * BUCKET_W, np.uint32),
            np.full(n_buckets * BUCKET_W, -1, np.int32),
            np.zeros(n_buckets, np.uint32),
        )
        pos = np.full(n, -1, np.int64)
        occ = np.zeros(n_buckets, np.int32)
        with np.errstate(over="ignore"):
            b1 = (h1 & mask).astype(np.int64)
            b2 = b1 ^ (((fp | np.uint32(1)) * np.uint32(_ALT_MUL)) & mask).astype(
                np.int64
            )
        pending = np.arange(n)
        for _round in range(24):
            if not len(pending):
                break
            t1, t2 = b1[pending], b2[pending]
            tgt = np.where(occ[t1] <= occ[t2], t1, t2)
            order = np.argsort(tgt, kind="stable")
            st = tgt[order]
            first = np.ones(len(st), bool)
            first[1:] = st[1:] != st[:-1]
            idxs = np.arange(len(st))
            start = np.maximum.accumulate(np.where(first, idxs, 0))
            lane = occ[st] + (idxs - start)
            acc = lane < BUCKET_W
            rows = pending[order[acc]]
            sl = st[acc] * BUCKET_W + lane[acc]
            slots.fp[sl] = fp[rows]
            slots.bucket[sl] = ids[rows]
            pos[rows] = sl
            occ += np.bincount(st[acc], minlength=n_buckets).astype(np.int32)
            pending = pending[order[~acc]]
        ok = True
        for i in pending:  # stragglers: eviction walk (expected ~none)
            if not _evict_insert(
                slots, n_buckets, int(b1[i]), int(fp[i]), int(ids[i])
            ):
                ok = False
                break
        if ok:
            if len(pending):
                # eviction kicks relocate earlier keys: recompute every
                # position from the table (ids are unique)
                sl = np.flatnonzero(slots.bucket >= 0)
                bid_at = slots.bucket[sl].astype(np.int64)
                inv = np.full(int(ids.max()) + 1, -1, np.int64)
                inv[ids.astype(np.int64)] = np.arange(n)
                pos[inv[bid_at]] = sl
            _pack_probe(slots)
            if dirty is not None and n:
                dirty.update(int(p) for p in pos)
            return slots, pos, n_buckets
        n_buckets *= 2


def _evict_insert(
    slots: SlotArrays,
    n_buckets: int,
    b1: int,
    fp: int,
    bid: int,
    dirty: Optional[Set[int]] = None,
) -> bool:
    """Insert (fp, bid) starting at bucket b1, kicking residents along
    their alternate buckets (which may relocate ANY resident,
    including the new key itself). Returns False when MAX_KICKS walks
    found no empty lane. Callers recover final positions from `dirty`
    (incremental: _repatch_slots) or by rescanning the table (bulk
    build) — the walk does not report where keys landed."""
    mask = n_buckets - 1
    b2 = _alt_bucket(b1, fp, mask)
    for b in (b1, b2):
        base = b * BUCKET_W
        lanes = slots.bucket[base : base + BUCKET_W].tolist()
        for lane in range(BUCKET_W):
            if lanes[lane] < 0:
                slots.fp[base + lane] = fp
                slots.bucket[base + lane] = bid
                if dirty is not None:
                    dirty.add(base + lane)
                return True
    # both full: place in b1 by evicting, then walk the victim chain
    seed = (b1 * 0x9E3779B1 + fp) & M32
    cur = b1
    for _ in range(MAX_KICKS):
        seed = (seed * 1103515245 + 12345) & M32
        lane = (seed >> 16) % BUCKET_W
        s = cur * BUCKET_W + lane
        vfp, vbid = int(slots.fp[s]), int(slots.bucket[s])
        slots.fp[s] = fp
        slots.bucket[s] = bid
        if dirty is not None:
            dirty.add(s)
        # victim becomes the carried key, headed for its alternate
        fp, bid = vfp, vbid
        cur = _alt_bucket(cur, fp, mask)
        base = cur * BUCKET_W
        for lane in range(BUCKET_W):
            if slots.bucket[base + lane] < 0:
                slots.fp[base + lane] = fp
                slots.bucket[base + lane] = bid
                if dirty is not None:
                    dirty.add(base + lane)
                return True
    return False


class ClassIndex:
    """Host source of truth for the pattern-class cuckoo table.

    The owner (Router/DeviceTable) calls add_row/remove_row alongside
    FilterTable add/remove; this module keeps skeleton classes, filter
    buckets, and the slot array coherent, tracking dirty slots for
    incremental device sync."""

    def __init__(
        self,
        max_levels: int,
        class_budget: int = DEFAULT_CLASS_BUDGET,
        min_slots: int = MIN_SLOTS,
    ) -> None:
        assert min_slots >= 32 and min_slots & (min_slots - 1) == 0
        self.max_levels = max_levels
        self.class_budget = class_budget
        self._min_buckets = max(4, min_slots // BUCKET_W)
        self._skel_class: Dict[Tuple[int, bool, int], int] = {}
        # packed mirror of _skel_class keyed by plen | hh<<6 | plus<<7
        # (one int probe per row for the churn core's write path)
        self._skel_packed: Dict[int, int] = {}
        self._class_free: List[int] = list(range(class_budget - 1, -1, -1))
        self._class_buckets = np.zeros(class_budget, np.int64)
        self.meta = ClassMeta(
            np.zeros(class_budget, np.int32),
            np.zeros(class_budget, bool),
            np.zeros(class_budget, bool),
            np.zeros(class_budget, np.uint32),
            np.zeros(class_budget, bool),
        )
        self.n_buckets = self._min_buckets
        self.slots = SlotArrays(
            np.zeros(self.n_buckets * BUCKET_W, np.uint32),
            np.full(self.n_buckets * BUCKET_W, -1, np.int32),
            np.zeros(self.n_buckets, np.uint32),
        )
        self._live = 0  # live slots
        # bucket records live in PARALLEL arrays, not python objects:
        # the churn write path touches every field of every new bucket.
        # _bkt_ws is the only object column (the words tuple the match
        # path verifies candidates against); _bucket_of keys by the
        # canonical '/'-joined filter STRING because str hashes are
        # cached by CPython where tuple hashes re-combine every probe.
        self._bkt_ws: List[Optional[Tuple[str, ...]]] = []
        self._bkt_cid = np.zeros(0, np.int32)
        self._bkt_h1 = np.zeros(0, np.uint32)
        self._bkt_fp = np.zeros(0, np.uint32)
        self._bkt_slot = np.zeros(0, np.int64)
        self._bucket_free: List[int] = []
        self._bucket_of: Dict[str, int] = {}
        # bucket -> member rows: a bare int for the common 1-row
        # bucket (no set allocation on the churn path), promoted to a
        # set when a second row shares the filter
        self._bucket_rows: List[object] = []
        # row -> bucket id, indexed by table row (-1 = not indexed);
        # a flat array because rows are dense ints and the churn core
        # writes it raw
        self._row_bucket = np.full(1024, -1, np.int64)
        # rows that could not get a class (skeleton budget exhausted):
        # matched by the dense kernel over a residual mask instead
        self.residual_rows: Set[int] = set()
        self.residual_dirty = False
        self.dirty_slots: List[int] = []
        self.meta_dirty = True
        self.rebuilt = True  # device must re-upload slot arrays

    @property
    def n_slots(self) -> int:
        return self.n_buckets * BUCKET_W

    def __len__(self) -> int:
        return self._live

    def active_hi(self) -> int:
        """One past the highest active class id. Class ids allocate
        lowest-first and the device kernel's per-batch work is
        B x C hash mixes and probes, so callers upload/match over meta
        sliced to next_pow2(active_hi) instead of the full budget."""
        act = np.flatnonzero(self.meta.active)
        return int(act[-1]) + 1 if len(act) else 0

    def packed_meta(self) -> "ClassMeta":
        """Meta arrays sliced to a pow2 >= active_hi (>=1)."""
        hi = 1 << max(0, self.active_hi() - 1).bit_length()
        hi = max(1, min(hi, self.class_budget))
        return ClassMeta(*(np.ascontiguousarray(a[:hi]) for a in self.meta))

    # --- write path ----------------------------------------------------

    def ensure_row_capacity(self, need: int) -> None:
        """Guarantee the row->bucket array covers rows < `need`."""
        cap = len(self._row_bucket)
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        self._row_bucket = np.concatenate(
            [
                self._row_bucket,
                np.full(cap - len(self._row_bucket), -1, np.int64),
            ]
        )

    def _grow_bucket_arrays(self, need: int) -> None:
        cap = len(self._bkt_cid)
        if need <= cap:
            return
        new = max(64, cap)
        while new < need:
            new *= 2
        pad = new - cap
        self._bkt_cid = np.concatenate([self._bkt_cid, np.zeros(pad, np.int32)])
        self._bkt_h1 = np.concatenate([self._bkt_h1, np.zeros(pad, np.uint32)])
        self._bkt_fp = np.concatenate([self._bkt_fp, np.zeros(pad, np.uint32)])
        self._bkt_slot = np.concatenate(
            [self._bkt_slot, np.full(pad, -1, np.int64)]
        )

    def reserve(self, n_new: int, row_capacity: int) -> None:
        """Pre-grow every structure a burst of up to `n_new` fresh rows
        could touch, so the churn core can hold raw buffer pointers for
        the whole batch (no growth mid-call). Growth points move at most
        one batch earlier than the incremental path's; final sizes are
        identical (pow2)."""
        self.ensure_row_capacity(row_capacity)
        self._grow_bucket_arrays(len(self._bkt_ws) + n_new)
        need = self.n_buckets
        while (
            (self._live + n_new) * BULK_LOAD_DEN
            > need * BUCKET_W * BULK_LOAD_NUM
        ):
            need *= 2
        if need != self.n_buckets:
            self._rebuild(need)

    def add_row(self, row: int, table: FilterTable) -> None:
        """Index row `row` of `table` (call right after table.add)."""
        ws = table.filter_words(row)
        plen = int(table.prefix_len[row])
        if plen > 32:
            # the '+'-position bitmask is uint32 and the device kernel
            # shifts it by the level index — skeletons deeper than 32
            # levels can't be classed; they degrade to the dense
            # residual path (same contract as budget overflow)
            self.residual_rows.add(row)
            self.residual_dirty = True
            return
        has_hash = bool(table.has_hash[row])
        plus_mask = 0
        lit_words: List[Tuple[int, int]] = []
        # one bulk conversion instead of plen numpy scalar reads (the
        # route-churn hot path is pure Python overhead)
        wids = table.words[row, :plen].tolist()
        for i, wid in enumerate(wids):
            if wid == PLUS:
                plus_mask |= 1 << i
            else:
                lit_words.append((i, wid))
        self.ensure_row_capacity(row + 1)
        f = table.filter_str(row)
        bid = self._bucket_of.get(f)
        if bid is not None:
            rs = self._bucket_rows[bid]
            if isinstance(rs, set):
                rs.add(row)
            elif rs != row:
                self._bucket_rows[bid] = {rs, row}
            self._row_bucket[row] = bid
            return
        cid = self._class_of(plen, has_hash, bool(table.root_wild[row]), plus_mask)
        if cid is None:
            self.residual_rows.add(row)
            self.residual_dirty = True
            return
        h1, fp = _hash_host(cid, lit_words, self.max_levels)
        if self._bucket_free:
            bid = self._bucket_free.pop()
        else:
            bid = len(self._bkt_ws)
            self._bkt_ws.append(None)
            self._bucket_rows.append(None)
            self._grow_bucket_arrays(bid + 1)
        self._bkt_ws[bid] = ws
        self._bkt_cid[bid] = cid
        self._bkt_h1[bid] = h1
        self._bkt_fp[bid] = fp
        self._bkt_slot[bid] = -1
        self._bucket_rows[bid] = {row}
        self._bucket_of[f] = bid
        self._row_bucket[row] = bid
        self._class_buckets[cid] += 1
        self._live += 1
        if self._live * MAX_LOAD_DEN > self.n_slots * MAX_LOAD_NUM:
            self._rebuild(self.n_buckets * 2)
            return
        try:
            self._place(h1, fp, bid)
        except _NeedRebuild:
            self._rebuild(self.n_buckets * 2)

    def add_rows(
        self,
        rows: Sequence[int],
        table: FilterTable,
        flts: Optional[Sequence[str]] = None,
    ) -> None:
        """Batch add_row — same visible state, but everything that can
        be array work IS array work: skeleton classing runs once per
        DISTINCT skeleton in the burst (np.unique over packed int64
        keys), hashes and bucket-record fields write via one fancy
        index each, and the per-row python loop is down to the dict
        bookkeeping no array can hold. This is the write path for
        router-syncer-style batches (the reference flushes route writes
        in <=1000-op batches, emqx_router_syncer.erl:57); subscribe
        storms hit it. `flts` (when given) carries the rows' canonical
        filter strings so the dedup probe skips a '/'-join per row."""
        if not rows:
            return
        if len(rows) == 1:
            self.add_row(rows[0], table)
            return
        rr = np.asarray(rows, np.int64)
        plen = table.prefix_len[rr].astype(np.int64)
        wids = table.words[rr].astype(np.int64)  # [B, L]
        lvl = np.arange(wids.shape[1])
        in_prefix = lvl[None, :] < plen[:, None]
        isplus = in_prefix & (wids == PLUS)
        xs = np.where(in_prefix & (wids != PLUS), wids + 1, 0).astype(np.uint32)
        plus_mask = (
            isplus.astype(np.uint64) << lvl.astype(np.uint64)[None, :]
        ).sum(1).astype(np.int64)
        # one packed int64 skeleton key per row: plen (6 bits) |
        # has_hash (1) | plus_mask (32); -1 marks too-deep rows. Class
        # resolution then costs one dict probe per DISTINCT skeleton.
        hh = table.has_hash[rr]
        skel = plen | (hh.astype(np.int64) << 6) | (plus_mask << 7)
        skel[plen > 32] = -1
        uskel, inv = np.unique(skel, return_inverse=True)
        ucid = np.empty(len(uskel), np.int64)
        for k, s in enumerate(uskel.tolist()):
            if s < 0:
                ucid[k] = -1
                continue
            p, h, pm = s & 63, bool((s >> 6) & 1), s >> 7
            cid = self._skel_class.get((p, h, pm))
            if cid is None:
                rw = (h and p == 0) or bool(pm & 1)
                cid = self._class_of(p, h, rw, pm)
            ucid[k] = -1 if cid is None else cid
        cids = ucid[inv]
        if flts is None:
            filt_l = table._fstr
            flt_l = [filt_l[r] for r in rows]
        else:
            flt_l = flts if isinstance(flts, list) else list(flts)
        nb0 = len(self._bkt_ws)
        rows_l = rows if isinstance(rows, list) else list(rows)
        self.ensure_row_capacity(max(rows_l) + 1)
        sp = _speedups.load()
        if sp is not None:
            new_idx, new_bids, nb, any_residual = sp.index_dedup(
                flt_l, cids, rows_l, self._bucket_of, self._bucket_rows,
                self._row_bucket, self._bucket_free, self.residual_rows,
                nb0,
            )
        else:
            cid_l = cids.tolist()
            new_bids = []
            new_idx = []
            # hot loop: locals bound once; only dict bookkeeping here
            bucket_of = self._bucket_of
            bucket_rows = self._bucket_rows
            row_bucket = self._row_bucket
            bucket_free = self._bucket_free
            residual_add = self.residual_rows.add
            nb = nb0
            any_residual = False
            for i, row in enumerate(rows_l):
                if cid_l[i] < 0:
                    residual_add(row)
                    any_residual = True
                    continue
                f = flt_l[i]
                bid = bucket_of.get(f)
                if bid is not None:
                    rs = bucket_rows[bid]
                    if isinstance(rs, set):
                        rs.add(row)
                    elif rs != row:
                        bucket_rows[bid] = {rs, row}
                    row_bucket[row] = bid
                    continue
                if bucket_free:
                    bid = bucket_free.pop()
                    bucket_rows[bid] = row
                else:
                    bid = nb
                    nb += 1
                    bucket_rows.append(row)
                bucket_of[f] = bid
                row_bucket[row] = bid
                new_bids.append(bid)
                new_idx.append(i)
        if any_residual:
            self.residual_dirty = True
        if not new_bids:
            return
        if nb > nb0:
            self._bkt_ws.extend([None] * (nb - nb0))
            self._grow_bucket_arrays(nb)
        bkt_ws = self._bkt_ws
        for i, bid in zip(new_idx, new_bids):
            # store the string; bucket_filter materializes the words
            # tuple lazily on first match-side use
            bkt_ws[bid] = flt_l[i]
        sel = np.asarray(new_idx, np.int64)
        bb = np.asarray(new_bids, np.int64)
        ncids = cids[sel]
        h1s, fps = _hash_host_batch(ncids.astype(np.uint32), xs[sel])
        self._bkt_cid[bb] = ncids
        self._bkt_h1[bb] = h1s
        self._bkt_fp[bb] = fps
        self._bkt_slot[bb] = -1
        np.add.at(self._class_buckets, ncids, 1)
        self._live += len(new_bids)
        if self._live * BULK_LOAD_DEN > self.n_slots * BULK_LOAD_NUM:
            # grow once for the whole burst — the new buckets are
            # already registered, so the rebuild seats them too
            need = self.n_buckets * 2
            while self._live * BULK_LOAD_DEN > need * BUCKET_W * BULK_LOAD_NUM:
                need *= 2
            self._rebuild(need)
            return
        self._place_bulk(h1s, fps, bb.astype(np.int32))

    def _place_bulk(
        self, h1: np.ndarray, fp: np.ndarray, bids: np.ndarray
    ) -> None:
        """Greedy vectorized placement of a key burst into the LIVE
        table (holes and all): per round, each pending key targets its
        less-loaded candidate bucket, one key per bucket per round
        lands in that bucket's first free lane. Stragglers (both
        buckets full) finish through the single-key eviction walk."""
        slots, n_buckets = self.slots, self.n_buckets
        mask = np.uint32(n_buckets - 1)
        occ = (slots.bucket.reshape(-1, BUCKET_W) >= 0).sum(1).astype(np.int32)
        with np.errstate(over="ignore"):
            b1 = (h1 & mask).astype(np.int64)
            b2 = b1 ^ (
                ((fp | np.uint32(1)) * np.uint32(_ALT_MUL)) & mask
            ).astype(np.int64)
        n = len(h1)
        pos = np.full(n, -1, np.int64)
        pending = np.arange(n)
        stragglers: List[int] = []
        touched: List[np.ndarray] = []
        while len(pending):
            t1, t2 = b1[pending], b2[pending]
            # keys whose BOTH candidate buckets are full can only land
            # via eviction kicks — route them to the walk below (occ is
            # an exact live count, so occ < W guarantees a free lane)
            both_full = (occ[t1] >= BUCKET_W) & (occ[t2] >= BUCKET_W)
            if both_full.any():
                stragglers.extend(pending[both_full].tolist())
                pending = pending[~both_full]
                continue
            tgt = np.where(occ[t1] <= occ[t2], t1, t2)
            order = np.argsort(tgt, kind="stable")
            st = tgt[order]
            first = np.ones(len(st), bool)
            first[1:] = st[1:] != st[:-1]
            sel = order[first]  # one key per distinct target bucket
            tb = tgt[sel]
            sub = slots.bucket.reshape(-1, BUCKET_W)[tb]
            lane = np.argmax(sub < 0, 1)
            rows = pending[sel]
            sl = tb * BUCKET_W + lane
            slots.fp[sl] = fp[rows]
            slots.bucket[sl] = bids[rows]
            pos[rows] = sl
            occ[tb] += 1
            touched.append(sl)
            keep = np.ones(len(pending), bool)
            keep[sel] = False
            pending = pending[keep]
        seated = pos >= 0
        self._bkt_slot[bids[seated].astype(np.int64)] = pos[seated]
        if touched:
            allsl = np.concatenate(touched)
            _refresh_probe_many(slots, np.unique(allsl // BUCKET_W))
            self.dirty_slots.extend(allsl.tolist())
        if stragglers:
            # batched eviction walks: share one dirty set, then ONE
            # probe-refresh + repatch pass (per-key _place paid ~30us
            # in bookkeeping each; ~10% of keys land here at 75% load)
            dirty: Set[int] = set()
            for i in stragglers:
                if not _evict_insert(
                    slots, n_buckets, int(b1[i]), int(fp[i]), int(bids[i]),
                    dirty=dirty,
                ):
                    self.dirty_slots.extend(dirty)
                    self._rebuild(self.n_buckets * 2)
                    return
            _refresh_probe_many(
                slots,
                np.unique(
                    np.fromiter(dirty, np.int64, len(dirty)) // BUCKET_W
                ),
            )
            self.dirty_slots.extend(dirty)
            self._repatch_slots(dirty)

    def remove_row(self, row: int) -> None:
        """Un-index a row (safe before or after table.remove)."""
        if row in self.residual_rows:
            self.residual_rows.discard(row)
            self.residual_dirty = True
            return
        bid = int(self._row_bucket[row])
        assert bid >= 0, f"row {row} not indexed"
        self._row_bucket[row] = -1
        rows = self._bucket_rows[bid]
        if isinstance(rows, set):
            rows.discard(row)
            if rows:
                if len(rows) == 1:  # demote back to the bare-int form
                    self._bucket_rows[bid] = next(iter(rows))
                return
        elif rows != row:
            return  # stale/foreign row: bucket still owned by another
        ws = self._bkt_ws[bid]
        assert ws is not None
        key = ws if type(ws) is str else "/".join(ws)
        slot = int(self._bkt_slot[bid])
        if slot >= 0:
            self.slots.bucket[slot] = -1  # cuckoo: plain delete
            # zero the fingerprint too: phase 2 trusts fp matches and
            # fetches the bucket id only for the winning lane, so a
            # stale fp in a vacated slot could outrank the true lane
            self.slots.fp[slot] = 0
            _refresh_probe(self.slots, slot // BUCKET_W)
            self.dirty_slots.append(slot)
        self._live -= 1
        del self._bucket_of[key]
        self._bkt_ws[bid] = None
        self._bucket_free.append(bid)
        cid = int(self._bkt_cid[bid])
        self._class_buckets[cid] -= 1
        if self._class_buckets[cid] == 0:
            self._retire_class(cid)

    # --- read path (host) ----------------------------------------------

    def bucket_live(self, bid: int) -> bool:
        """False once the bucket's last row was removed (until a new
        key takes the id)."""
        return self._bkt_ws[bid] is not None

    def bucket_filter(self, bid: int) -> Tuple[str, ...]:
        ws = self._bkt_ws[bid]
        assert ws is not None, f"bucket {bid} not live"
        if type(ws) is not tuple:
            # bulk writers store the filter string; materialize the
            # words tuple on first match-side use (cached thereafter)
            ws = tuple(ws.split("/"))
            self._bkt_ws[bid] = ws
        return ws

    def bucket_rows(self, bid: int):
        """Member rows of a bucket — an iterable (tuple for the common
        single-row bucket, set when shared). Use .update()/iteration,
        not set operators."""
        rs = self._bucket_rows[bid]
        return rs if isinstance(rs, set) else (rs,)

    # --- internals ------------------------------------------------------

    def _class_of(
        self, plen: int, has_hash: bool, root_wild: bool, plus_mask: int
    ) -> Optional[int]:
        skel = (plen, has_hash, plus_mask)
        cid = self._skel_class.get(skel)
        if cid is not None:
            return cid
        if not self._class_free:
            return None
        cid = self._class_free.pop()
        self._skel_class[skel] = cid
        self._skel_packed[plen | (int(has_hash) << 6) | (plus_mask << 7)] = cid
        self.meta.plen[cid] = plen
        self.meta.has_hash[cid] = has_hash
        self.meta.root_wild[cid] = root_wild
        self.meta.plus[cid] = plus_mask
        self.meta.active[cid] = True
        self.meta_dirty = True
        return cid

    def _retire_class(self, cid: int) -> None:
        skel = (
            int(self.meta.plen[cid]),
            bool(self.meta.has_hash[cid]),
            int(self.meta.plus[cid]),
        )
        del self._skel_class[skel]
        del self._skel_packed[skel[0] | (int(skel[1]) << 6) | (skel[2] << 7)]
        self.meta.active[cid] = False
        self.meta_dirty = True
        self._class_free.append(cid)

    def _place(self, h1: int, fp: int, bid: int) -> None:
        """Seat bucket `bid`; eviction kicks may relocate other live
        buckets (including `bid` itself), so every bucket slot record
        is re-aligned from the walk's dirty set afterwards."""
        dirty: Set[int] = set()
        ok = _evict_insert(
            self.slots, self.n_buckets, h1 & (self.n_buckets - 1), fp, bid,
            dirty=dirty,
        )
        for b in {s // BUCKET_W for s in dirty}:
            _refresh_probe(self.slots, b)
        self.dirty_slots.extend(dirty)  # partial kicks still synced
        self._repatch_slots(dirty)
        if not ok:
            raise _NeedRebuild

    def _repatch_slots(self, touched: Set[int]) -> None:
        """After eviction kicks, realign bucket slot records with the
        array (vectorized — each live bid occupies exactly one slot)."""
        if not touched:
            return
        ts = np.fromiter(touched, np.int64, len(touched))
        cur = self.slots.bucket[ts].astype(np.int64)
        m = cur >= 0
        self._bkt_slot[cur[m]] = ts[m]

    def _rebuild(self, n_buckets: int) -> None:
        """Vectorized global re-place into >= n_buckets buckets."""
        bids = np.fromiter(
            self._bucket_of.values(), np.int64, len(self._bucket_of)
        )
        slots, pos, n_buckets = build_slots(
            self._bkt_h1[bids],
            self._bkt_fp[bids],
            bids.astype(np.int32),
            min_buckets=max(n_buckets, self._min_buckets),
        )
        self._bkt_slot[bids] = pos
        self.n_buckets = n_buckets
        self.slots = slots
        self.dirty_slots.clear()
        self.rebuilt = True




# --- K1: the plain PyTorch version ---------------------------------------
# uint32 arithmetic in int64 masked to 32 bits: torch on the CPU has no
# uint32 shift or subtract, and an int64 product of two 32-bit values
# keeps the correct low 32 bits even where it wraps.


def _u32(t: torch.Tensor) -> torch.Tensor:
    """uint32 tensor -> int64 holding the same unsigned values."""
    return t.view(torch.int32).to(torch.int64) & M32


def class_hash_ref(meta: ClassMeta, topics: EncodedTopics):
    """The eligibility and the h1/fp mix of every (topic, class) pair:
    (elig bool [B, C], h1, fp int64 [B, C] holding uint32 values)."""
    dev = topics.ids.device
    ids = topics.ids.to(torch.int64)
    b, max_levels = ids.shape
    c = meta.plen.shape[0]
    plen = meta.plen.to(torch.int64)
    tl = topics.lens[:, None]
    pl = meta.plen[None, :]
    len_ok = torch.where(meta.has_hash[None, :], tl >= pl, tl == pl)
    elig = len_ok & meta.active[None, :] & ~(
        topics.dollar[:, None] & meta.root_wild[None, :]
    )
    cids = torch.arange(c, dtype=torch.int64, device=dev)
    h1 = (_H1_SEED ^ ((cids * _H1_CLS) & M32)).expand(b, c)
    fp = ((_FP_SEED + cids * _FP_CLS) & M32).expand(b, c)
    plus = _u32(meta.plus)
    for i in range(max_levels):
        is_plus = ((plus >> i) & 1) == 1 if i < 32 else torch.zeros_like(plus, dtype=torch.bool)
        lit = (plen > i) & ~is_plus
        x = torch.where(lit[None, :], ids[:, i:i + 1] + 1, 0)
        h1 = ((h1 ^ x) * _H1_MUL) & M32
        fp = ((fp ^ ((x * _FP_XOR) & M32)) * _FP_MUL) & M32
    return elig, h1, fp


def has_byte_ref(w: torch.Tensor, rep: torch.Tensor) -> torch.Tensor:
    """Whether any byte of each probe word w equals its probe byte
    (rep = the byte repeated four times; int64 holding uint32)."""
    x = w ^ rep
    return (((x - 0x01010101) & M32) & (~x & M32) & 0x80808080) != 0


def verify_lanes_ref(pb1, pb2, pfp, pw1, pw2, slot_fp, slot_bucket):
    """Phase 2 of the cuckoo probe over flagged pairs (csrc/cuckoo.cuh
    `verify_lanes`): the lane-byte screen of both probe words, the full
    fingerprint of the first and second byte-matching lanes (lane 0 when
    absent, argmax's rule), the winner's bucket id. pb1/pb2 are the
    buckets' positions in slot_fp/slot_bucket (clamped into range: a
    lane is read only when it byte-matched). Returns (ok, bucket id,
    amb) per pair."""
    pp8 = torch.clamp_min(pfp >> 24, 1)
    lid = torch.arange(2 * BUCKET_W, dtype=torch.int64, device=pfp.device)
    shift = 8 * (lid & 3)
    lane_byte = torch.where(
        lid[None, :] < BUCKET_W, pw1[:, None] >> shift, pw2[:, None] >> shift
    ) & 0xFF
    bm = lane_byte == pp8[:, None]
    nbm = bm.sum(1)
    l1 = torch.argmax(bm.to(torch.int32), 1)  # first byte-matching lane
    bm2 = bm & (lid[None, :] != l1[:, None])
    l2 = torch.argmax(bm2.to(torch.int32), 1)  # second (0 when absent)
    last = slot_fp.shape[0] - 1

    def slot_of(ln):
        s = torch.where(ln < BUCKET_W, pb1, pb2) * BUCKET_W + (ln & 3)
        return s.clamp(0, last)

    s1 = slot_of(l1)
    s2 = slot_of(l2)
    fps = _u32(slot_fp)
    ok1 = (nbm >= 1) & (fps[s1] == pfp)
    ok2 = (nbm >= 2) & (fps[s2] == pfp)
    nmatch = ok1.to(torch.int32) + ok2.to(torch.int32)
    g = slot_bucket[torch.where(ok1, s1, s2)].to(torch.int64)
    return (nmatch > 0) & (g >= 0), g, (nmatch > 1) | (nbm > 2)


def match_ids_hash_ref(
    meta: ClassMeta,
    slots: SlotArrays,
    topics: EncodedTopics,
    max_hits: int = 4096,
):
    """Plain version of K1, on any device: (ti int32 [max_hits],
    bi int32 [max_hits], total int32 scalar, amb int32 scalar)."""
    dev = topics.ids.device
    c = meta.plen.shape[0]
    elig, h1, fp = class_hash_ref(meta, topics)
    mask = slots.probe.shape[0] - 1
    b1 = h1 & mask
    b2 = b1 ^ ((((fp | 1) * _ALT_MUL) & M32) & mask)
    p8 = torch.clamp_min(fp >> 24, 1)
    rep = p8 * 0x01010101
    probe = _u32(slots.probe)
    w1 = probe[b1]
    w2 = probe[b2]
    pairhit = elig & (has_byte_ref(w1, rep) | has_byte_ref(w2, rep))
    total = int(pairhit.sum())
    pflat = torch.nonzero(pairhit.reshape(-1)).squeeze(1)[:max_hits]
    h = pflat.numel()
    ti = torch.full((max_hits,), -1, dtype=torch.int32, device=dev)
    bi = torch.full((max_hits,), -1, dtype=torch.int32, device=dev)
    amb = 0
    if h:
        ok, g, amb_flag = verify_lanes_ref(
            b1.reshape(-1)[pflat], b2.reshape(-1)[pflat], fp.reshape(-1)[pflat],
            w1.reshape(-1)[pflat], w2.reshape(-1)[pflat], slots.fp, slots.bucket,
        )
        ti[:h] = torch.where(ok, pflat // c, -1).to(torch.int32)
        bi[:h] = torch.where(ok, g, -1).to(torch.int32)
        amb = int(amb_flag.sum())
    scalar = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    return ti, bi, scalar(total), scalar(amb)


# --- K1: the CUDA kernel --------------------------------------------------

HASH_PAIRS = 256  # (topic, class) pairs a block of K1/K17 owns (csrc/hash_match.cu HT)


class HashGeometry(NamedTuple):
    n_blk: int  # blocks a tile: ceil(b_loc * C / HASH_PAIRS)
    n_status: int  # status words: one a block of every tile
    scratch: int  # int32 scratch: the ticket, amb, then the 64-bit status words


def hash_geometry(b_loc: int, c: int, n_tiles: int = 1) -> HashGeometry:
    """The launch geometry of K1 (one tile) and K17 (n_tiles tiles of
    b_loc topics): block t of the grid takes ticket t, which names tile
    t // n_blk and its pairs [blk * HASH_PAIRS, (blk + 1) * HASH_PAIRS)
    in flat (topic, class) order, blk = t % n_blk. The C side refuses a
    shorter scratch."""
    n_blk = -(-(b_loc * c) // HASH_PAIRS)
    n_status = n_tiles * n_blk
    return HashGeometry(n_blk, n_status, 2 + 2 * n_status)


_MATCH_IDS_HASH = CudaKernel(
    "match_ids_hash", "hash_match.cu", "emqx_match_ids_hash",
    [P, P, P, P, P, I, P, P, P, I, P, P, P, I, I, I, P, P, P, P, LL, P],
)


def match_ids_hash(
    meta: ClassMeta,
    slots: SlotArrays,
    topics: EncodedTopics,
    max_hits: int = 4096,
):
    """Probe every (topic, class) pair's two cuckoo buckets in one
    pass: returns (topic_idx int32 [max_hits], bucket_id int32
    [max_hits], total int32 scalar, amb int32 scalar) on the tables'
    device.

    A (topic, class) pair can have AT MOST ONE truly matching filter:
    the class fixes which positions are literals, so every filter of
    the class that matches the topic has the same literal projection.
    `total` is the EXACT flagged-pair count, so on overflow the caller
    re-runs once with max_hits = next_pow2(total). Within the first
    `total` entries, pairs whose full-fingerprint check rejected every
    lane carry -1/-1. Survivors may still (rarely) be full-fingerprint
    collisions — the caller verifies each pair on the host. `amb`
    counts pairs where more than one lane passed the full-fingerprint
    check (or more than two lanes byte-matched); the caller then
    re-matches the batch on a host path.

    CUDA tensors launch kernel K1; CPU tensors take the plain version."""
    dev = topics.ids.device
    if dev.type == "cpu":
        return match_ids_hash_ref(meta, slots, topics, max_hits)
    levels = topics.ids.shape[1]
    if not 1 <= levels <= MAX_KERNEL_LEVELS:
        raise ValueError(f"max_levels {levels} outside 1..{MAX_KERNEL_LEVELS}")
    b = check_topics(topics, levels, dev)
    c = meta.plen.shape[0]
    check_tensor("meta.plen", meta.plen, torch.int32, (c,), dev)
    check_tensor("meta.plus", meta.plus, torch.uint32, (c,), dev)
    for name in ("has_hash", "root_wild", "active"):
        check_tensor(f"meta.{name}", getattr(meta, name), torch.bool, (c,), dev)
    s = slots.probe.shape[0]
    if s < 1 or s & (s - 1):
        raise ValueError(f"bucket count {s} is not a power of two")
    check_tensor("slots.probe", slots.probe, torch.uint32, (s,), dev)
    check_tensor("slots.fp", slots.fp, torch.uint32, (s * BUCKET_W,), dev)
    check_tensor("slots.bucket", slots.bucket, torch.int32, (s * BUCKET_W,), dev)
    if max_hits < 1:
        raise ValueError(f"max_hits {max_hits} < 1")
    ti = torch.empty(max_hits, dtype=torch.int32, device=dev)
    bi = torch.empty(max_hits, dtype=torch.int32, device=dev)
    total = torch.empty((), dtype=torch.int32, device=dev)
    # the kernel zeroes its scratch; element 1 is the amb count
    scratch = torch.empty(hash_geometry(b, c).scratch, dtype=torch.int32, device=dev)
    _MATCH_IDS_HASH(
        meta.plen.data_ptr(), meta.has_hash.data_ptr(), meta.root_wild.data_ptr(),
        meta.plus.data_ptr(), meta.active.data_ptr(), c,
        slots.fp.data_ptr(), slots.bucket.data_ptr(), slots.probe.data_ptr(), s,
        topics.ids.data_ptr(), topics.lens.data_ptr(), topics.dollar.data_ptr(),
        b, levels, max_hits, ti.data_ptr(), bi.data_ptr(), total.data_ptr(),
        scratch.data_ptr(), scratch.numel(),
        raw_stream(dev),
    )
    return ti, bi, total, scratch[1]
