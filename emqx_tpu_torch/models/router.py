"""The route table: Topic/Filter -> destinations, with a device-resident
wildcard matcher kept coherent by batched incremental sync
(counterpart of emqx_tpu/models/router.py, single device).

Reproduces the reference v2 routing split (apps/emqx/src/emqx_router.erl):
  * exact-topic routes in a plain host hash table (?ROUTE_TAB), which
    also ride the device hash table as wildcard-free classes;
  * wildcard routes in BOTH a host trie (ops/host_index.py — the
    single-publish cut-through path) and the flattened device table
    (ops/table.py + the match kernels — the batched scale path);
  * a (filter, dest) pair is one logical route; duplicates refcount
    (bag semantics of mria route tables).

Device coherence mirrors emqx_router_syncer (apps/emqx/src/
emqx_router_syncer.erl:57 ?MAX_BATCH_SIZE 1000): dirty rows drain in
fixed-size [n_batches, K] scatter batches through kernels K3/K4, which
update the device tensors in place; only capacity growth re-uploads.

Routes are answered from the host destination dicts; the device
fanout resolve, the mesh, quarantine, chaos seams and the native churn
core of the reference are not part of this port yet.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Hashable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve, to_device
from ..obs.kernel_telemetry import (
    LEG_DENSE,
    LEG_ENCODE,
    LEG_FALLBACK,
    LEG_HASH,
    LEG_UNPACK,
    KernelTelemetry,
)
from ..obs.kernel_telemetry import NULL as _NULL_TEL
from ..obs.profiler import STAGE_MARK
from ..ops import hash_index as hash_ops
from ..ops import match as match_ops
from ..ops import topic as topic_mod
from ..ops import transfer as transfer_ops
from ..ops._build import I, P, CudaKernel
from ..ops.hash_index import BUCKET_W, ClassIndex, ClassMeta, SlotArrays
from ..ops.host_index import TopicTrie
from ..ops.match import check_tensor
from ..ops.table import (
    EncodedFilters,
    FilterTable,
    FilterTooDeep,
    next_pow2,
    pad_pow2_batches,
)

Dest = Hashable

SYNC_BATCH_SIZE = 1024  # rows per scatter batch (ref: ?MAX_BATCH_SIZE 1000)


# --- K3/K4: the plain PyTorch versions -------------------------------------


def scatter_rows_ref(
    dev: EncodedFilters,
    rows: torch.Tensor,  # int32 [n_batches, K]
    words: torch.Tensor,  # int32 [n_batches, K, L]
    prefix_len: torch.Tensor,  # int32 [n_batches, K]
    has_hash: torch.Tensor,  # bool [n_batches, K]
    root_wild: torch.Tensor,  # bool [n_batches, K]
    active: torch.Tensor,  # bool [n_batches, K]
) -> None:
    """Plain version of K3: write every delta batch into `dev` in
    place, batch by batch (the reference's scan order)."""
    for j in range(rows.shape[0]):
        r = rows[j].to(torch.int64)
        dev.words[r] = words[j]
        dev.prefix_len[r] = prefix_len[j]
        dev.has_hash[r] = has_hash[j]
        dev.root_wild[r] = root_wild[j]
        dev.active[r] = active[j]


def scatter_slots_ref(
    slots: SlotArrays,
    idx: torch.Tensor,  # int32 [n_batches, K] — flat slot indices
    fp: torch.Tensor,  # uint32 [n_batches, K]
    bucket: torch.Tensor,  # int32 [n_batches, K]
    probe: torch.Tensor,  # uint32 [n_batches, K] — merged probe WORDS
) -> None:
    """Plain version of K4: write fp/bucket at the slot ids and the
    merged probe words at slot // BUCKET_W, in place. uint32 columns
    are written through their int32 view (same bits; the CPU has no
    uint32 index_put)."""
    fp_dev = slots.fp.view(torch.int32)
    probe_dev = slots.probe.view(torch.int32)
    for j in range(idx.shape[0]):
        i = idx[j].to(torch.int64)
        fp_dev[i] = fp[j].view(torch.int32)
        slots.bucket[i] = bucket[j]
        probe_dev[i // BUCKET_W] = probe[j].view(torch.int32)


# --- K3/K4: the CUDA kernels -------------------------------------------------

_SCATTER_ROWS = CudaKernel(
    "scatter_rows", "scatter.cu", "emqx_scatter_rows",
    [P, P, P, P, P, I, I, P, P, P, P, P, P, ctypes.c_longlong, P],
)
_SCATTER_SLOTS = CudaKernel(
    "scatter_slots", "scatter.cu", "emqx_scatter_slots",
    [P, P, P, I, P, P, P, P, ctypes.c_longlong, P],
)


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def scatter_rows(
    dev: EncodedFilters, rows, words, prefix_len, has_hash, root_wild, active
) -> None:
    """In-place batched write of the five filter columns at padded row
    ids (replaces the donated `_scatter_rows` of the reference). CUDA
    tensors launch kernel K3; CPU tensors take the plain version."""
    d = dev.words.device
    if d.type == "cpu":
        scatter_rows_ref(dev, rows, words, prefix_len, has_hash, root_wild, active)
        return
    n, levels = dev.words.shape
    check_tensor("dev.words", dev.words, torch.int32, (n, levels), d)
    check_tensor("dev.prefix_len", dev.prefix_len, torch.int32, (n,), d)
    for name in ("has_hash", "root_wild", "active"):
        check_tensor(f"dev.{name}", getattr(dev, name), torch.bool, (n,), d)
    shape = tuple(rows.shape)
    check_tensor("rows", rows, torch.int32, shape, d)
    check_tensor("words", words, torch.int32, shape + (levels,), d)
    check_tensor("prefix_len", prefix_len, torch.int32, shape, d)
    for name, t in (("has_hash", has_hash), ("root_wild", root_wild), ("active", active)):
        check_tensor(name, t, torch.bool, shape, d)
    _SCATTER_ROWS(
        dev.words.data_ptr(), dev.prefix_len.data_ptr(), dev.has_hash.data_ptr(),
        dev.root_wild.data_ptr(), dev.active.data_ptr(), n, levels,
        rows.data_ptr(), words.data_ptr(), prefix_len.data_ptr(),
        has_hash.data_ptr(), root_wild.data_ptr(), active.data_ptr(),
        rows.numel(), _stream(d),
    )


def scatter_slots(slots: SlotArrays, idx, fp, bucket, probe) -> None:
    """In-place batched write of the cuckoo slot arrays (replaces the
    donated `_scatter_slots` of the reference). CUDA tensors launch
    kernel K4; CPU tensors take the plain version."""
    d = slots.fp.device
    if d.type == "cpu":
        scatter_slots_ref(slots, idx, fp, bucket, probe)
        return
    n_slots = slots.fp.shape[0]
    check_tensor("slots.fp", slots.fp, torch.uint32, (n_slots,), d)
    check_tensor("slots.bucket", slots.bucket, torch.int32, (n_slots,), d)
    check_tensor("slots.probe", slots.probe, torch.uint32, (n_slots // BUCKET_W,), d)
    shape = tuple(idx.shape)
    check_tensor("idx", idx, torch.int32, shape, d)
    check_tensor("fp", fp, torch.uint32, shape, d)
    check_tensor("bucket", bucket, torch.int32, shape, d)
    check_tensor("probe", probe, torch.uint32, shape, d)
    _SCATTER_SLOTS(
        slots.fp.data_ptr(), slots.bucket.data_ptr(), slots.probe.data_ptr(),
        n_slots, idx.data_ptr(), fp.data_ptr(), bucket.data_ptr(),
        probe.data_ptr(), idx.numel(), _stream(d),
    )


class DeviceTable:
    """Device-resident mirror of a FilterTable (and optionally its
    pattern-class hash index), synced by batched in-place scatters."""

    def __init__(
        self,
        table: FilterTable,
        device: DeviceLike = None,
        index: Optional[ClassIndex] = None,
        telemetry=None,
    ) -> None:
        self.table = table
        self.device = resolve(device)
        self.index = index
        self.telemetry = telemetry if telemetry is not None else _NULL_TEL
        self._dev: Optional[EncodedFilters] = None
        self._synced_capacity = 0
        self._dev_meta: Optional[ClassMeta] = None
        self._dev_slots: Optional[SlotArrays] = None
        self._dev_residual: Optional[torch.Tensor] = None

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return to_device(a, self.device)

    def _upload_full(self) -> None:
        snap = self.table.snapshot()
        self._dev = EncodedFilters(*(self._put(a) for a in snap))
        self._synced_capacity = self.table.capacity

    def _sync_index(self) -> None:
        ix = self.index
        assert ix is not None
        if ix.meta_dirty or self._dev_meta is None:
            # upload only the pow2-packed active-class prefix: kernel
            # work is B x C probes, so C tracks the live class count
            self._dev_meta = ClassMeta(*(self._put(a) for a in ix.packed_meta()))
            ix.meta_dirty = False
        if ix.rebuilt or self._dev_slots is None:
            ix.dirty_slots.clear()
            self._dev_slots = SlotArrays(*(self._put(a) for a in ix.slots))
            ix.rebuilt = False
        elif ix.dirty_slots:
            dirty = np.unique(np.asarray(ix.dirty_slots, np.int32))
            ix.dirty_slots.clear()
            idx = pad_pow2_batches(dirty, SYNC_BATCH_SIZE)
            self.telemetry.record_shape(
                "scatter_slots", (idx.shape[0], len(ix.slots.fp))
            )
            put = self._put
            scatter_slots(
                self._dev_slots,
                put(idx),
                put(ix.slots.fp[idx]),
                put(ix.slots.bucket[idx]),
                put(ix.slots.probe[idx // BUCKET_W]),
            )
        if ix.residual_dirty or self._dev_residual is None or (
            self._dev_residual.shape[0] != self.table.capacity
        ):
            mask = np.zeros(self.table.capacity, bool)
            if ix.residual_rows:
                mask[list(ix.residual_rows)] = True
            self._dev_residual = self._put(mask)
            ix.residual_dirty = False

    def hash_state(self) -> Tuple[ClassMeta, SlotArrays]:
        assert self._dev_meta is not None and self._dev_slots is not None
        return self._dev_meta, self._dev_slots

    def residual_filters(self) -> EncodedFilters:
        """EncodedFilters view whose active mask covers only residual
        (budget-overflow) rows — input to the dense kernel."""
        assert self._dev is not None and self._dev_residual is not None
        return self._dev._replace(active=self._dev_residual)

    def sync(self) -> int:
        """Bring device state up to date; returns rows written."""
        tel = self.telemetry
        t0 = tel.clock()
        pending = len(self.table.dirty)
        n, full = self._sync_impl()
        if tel.enabled and (n or full):
            tel.record_sync(
                rows=n, seconds=tel.clock() - t0, pending=pending, full=full
            )
            tel.observe_device_table(self)
        return n

    def _sync_impl(self) -> Tuple[int, bool]:
        """(rows written, was a full re-upload)."""
        t = self.table
        if self._dev is None or t.grew or t.capacity != self._synced_capacity:
            n = len(t.dirty)
            t.drain_dirty()
            self._upload_full()
            if self.index is not None:
                self._sync_index()
            return n, True
        dirty = t.drain_dirty()
        total = len(dirty)
        if total == 0:
            if self.index is not None:
                self._sync_index()
            return 0, False
        # pad to [n_batches, K] via the shared sync shape discipline
        # (ops.table.pad_pow2_batches: idempotent padding)
        rows = pad_pow2_batches(dirty, SYNC_BATCH_SIZE)
        self.telemetry.record_shape(
            "scatter_rows", (rows.shape[0], t.capacity, t.max_levels)
        )
        put = self._put
        scatter_rows(
            self._dev,
            put(rows),
            put(t.words[rows]),
            put(t.prefix_len[rows]),
            put(t.has_hash[rows]),
            put(t.root_wild[rows]),
            put(t.active[rows]),
        )
        if self.index is not None:
            self._sync_index()
        return total, False

    def filters(self) -> EncodedFilters:
        assert self._dev is not None, "sync() before matching"
        return self._dev

    # --- batched-match surface ---------------------------------------
    # Every begin LAUNCHES its kernel and immediately starts the
    # device->host copy of the compacted result buffers
    # (ops/transfer.FetchTicket), so batch N's transfer rides under
    # batch N+1's encode+launch; the finish half pays only the residual
    # wait. Handles carry the ticket as their LAST element.

    def _topics(self, enc: match_ops.EncodedTopics) -> match_ops.EncodedTopics:
        return match_ops.EncodedTopics(*(self._put(a) for a in enc))

    def match_hash_begin(self, enc: match_ops.EncodedTopics):
        """Launch the pattern-class hash kernel + begin the result
        transfer; no host wait is forced. Returns an opaque handle for
        match_hash_finish (ticket last)."""
        meta, slots = self.hash_state()
        b = int(enc.ids.shape[0])
        mh = max(1024, next_pow2(2 * b))
        shape = (b, int(meta.plen.shape[0]), int(slots.fp.shape[0]))
        self.telemetry.record_shape("match_ids_hash", shape + (mh,))
        denc = self._topics(enc)
        dev = hash_ops.match_ids_hash(meta, slots, denc, max_hits=mh)
        STAGE_MARK.stage = "ticket_start"
        return (denc, mh, shape, transfer_ops.start_fetch(dev, self.telemetry))

    def match_hash_finish(self, pending):
        """Force a begun hash match, re-launching at next_pow2(total)
        while the compacted buffer overflows. Returns (ti, bi, amb):
        candidate arrays sliced to the true hit count — entries with
        bi < 0 (phase-2 rejects) or ti beyond the live batch (pow2
        padding) are the caller's to skip."""
        denc, mh, shape, ticket = pending
        ti, bi, total, amb = ticket.wait()
        total = int(total)
        while total > mh:
            # the re-launch sees the device state as of NOW: a sync
            # that ran since begin (the next batch's) can change the
            # flagged-pair count, so the re-run's own total slices it
            tel = self.telemetry
            tel.count("hash_overflow_retries_total")
            mh = next_pow2(total)
            tel.record_shape("match_ids_hash", shape + (mh,))
            meta, slots = self.hash_state()
            ti, bi, total, amb = transfer_ops.start_fetch(
                hash_ops.match_ids_hash(meta, slots, denc, max_hits=mh),
                self.telemetry,
            ).wait()
            total = int(total)
        return ti[:total], bi[:total], int(amb)

    def match_ids_begin(self, enc: match_ops.EncodedTopics, residual: bool = False):
        """Launch the dense compaction kernel (full table, or the
        residual unclassed rows) + begin the result transfer. Same
        handle contract as match_hash_begin."""
        filters = self.residual_filters() if residual else self.filters()
        b = int(enc.ids.shape[0])
        if residual:
            mh = max(1024, next_pow2(2 * b))
        else:
            mh = max(4096, next_pow2(4 * b))
        shape = (b, int(filters.words.shape[0]))
        self.telemetry.record_shape("match_ids", shape + (mh,))
        denc = self._topics(enc)
        dev = match_ops.match_ids(filters, denc, max_hits=mh)
        STAGE_MARK.stage = "ticket_start"
        return (denc, filters, mh, shape, transfer_ops.start_fetch(dev, self.telemetry))

    def match_ids_finish(self, pending):
        """Force a begun dense match, re-launching at next_pow2(total)
        while the compacted buffer overflows. Returns (ti, ri)
        valid-pair arrays — ti may include pow2 batch-padding topic
        indices the caller drops."""
        denc, filters, mh, shape, ticket = pending
        ti, ri, total = ticket.wait()
        total = int(total)
        while total > mh:
            # as in match_hash_finish: the re-run's own total slices it
            tel = self.telemetry
            tel.count("escalations_total")
            mh = next_pow2(total)
            tel.record_shape("match_ids", shape + (mh,))
            ti, ri, total = transfer_ops.start_fetch(
                match_ops.match_ids(filters, denc, max_hits=mh),
                self.telemetry,
            ).wait()
            total = int(total)
        return ti[:total], ri[:total]


class _PendingMatch:
    """An in-flight batched match: kernels LAUNCHED, results not yet
    fetched. Produced by Router.match_filters_begin, consumed exactly
    once (in begin order) by Router.match_filters_finish. CUDA launches
    are asynchronous, so the host can encode and launch the next batch
    while this one runs."""

    __slots__ = (
        "topics",       # the sub-batch actually sent to the kernels
        "enc",          # EncodedTopics of `topics` (pow2-padded)
        "out",          # per-sub-topic result lists (exact-deep prefilled)
        "root",         # telemetry root span (or None)
        "mode",         # cached | host | hash | dense
        "gen",          # router generation captured before the kernels
        "full_out",     # full-batch skeleton when the match cache fronted it
        "sub_idx",      # index of each sub-topic within the original batch
        "span",         # per-stage latency span (or None)
        # begin handles; each carries its FetchTicket as the last
        # element, so readiness is a handle[-1].ready() probe
        "hash_pending",      # match_hash_begin handle
        "hash_elapsed",      # host seconds spent launching the hash leg
        "residual_pending",  # match_ids_begin(residual=True) handle
        "residual_elapsed",
        "dense_pending",     # match_ids_begin handle (no-index path)
        "dense_elapsed",
    )

    def __init__(self) -> None:
        for s in self.__slots__:
            setattr(self, s, None)


class Router:
    """Topic/filter -> dests with exact/wildcard split and device
    offload for batched wildcard matching."""

    def __init__(
        self,
        max_levels: int = 16,
        device: DeviceLike = None,
        use_hash_index: bool = True,
        telemetry=None,
    ) -> None:
        """`device` None means CUDA (raising when no card is present);
        pass "cpu" to run the kernels' plain versions on the host."""
        self.max_levels = max_levels
        # exact topics: dest store (host hash for the single-publish
        # cut-through) + device rows for the batched path
        self._exact: Dict[str, Dict[Dest, int]] = {}
        self._exact_row: Dict[str, int] = {}
        self._exact_deep: Set[str] = set()
        # wildcard filters: ONE device row per DISTINCT filter; the
        # dest fan lives host-side per filter (the reference's
        # ?ROUTE_TAB / ?SUBSCRIBER split)
        self.table = FilterTable(max_levels=max_levels)
        self._trie = TopicTrie()  # host cut-through; ids are table rows
        # trie writes from batched route adds are DEFERRED and drained
        # before the next host-path read (the device path never reads
        # the host trie); parallel lists (filter words-or-string, row)
        self._trie_pending_f: List[object] = []
        self._trie_pending_r: List[int] = []
        self._wild: Dict[str, Dict[Dest, int]] = {}
        self._filter_row: Dict[str, int] = {}
        # row -> filter string, indexed by table row (None = free)
        self._row_filter: List[Optional[str]] = [None] * self.table.capacity
        # filters too deep for the flattened table: host-only, in their
        # own depth-unlimited trie (ids are filter strings)
        self._deep: Dict[str, Dict[Dest, int]] = {}
        self._deep_trie = TopicTrie()
        # route-set generation: FilterTable.generation covers every
        # table-resident mutation; this aux counter covers the host-only
        # stores (deep filters, too-deep exact topics)
        self._aux_gen = 0
        # generation-stamped topic -> filters cache fronting the device
        # path (enable_match_cache); None keeps the kernel path bare
        self.match_cache: Optional[match_ops.GenMatchCache] = None
        self.telemetry = (
            telemetry if telemetry is not None else KernelTelemetry()
        )
        self.index = ClassIndex(max_levels) if use_hash_index else None
        self.device_table = DeviceTable(
            self.table, device=device, index=self.index,
            telemetry=self.telemetry,
        )
        # open-breaker mode: every batched match answers from host
        # truth (degraded capacity, identical answers)
        self.device_suspended = False

    @property
    def device(self) -> torch.device:
        return self.device_table.device

    @property
    def generation(self) -> int:
        """Monotonic route-set generation: bumps on every mutation that
        can change which filters match a topic (the GenMatchCache
        validity stamp)."""
        return self.table.generation + self._aux_gen

    def enable_match_cache(
        self, capacity: int = 8192
    ) -> match_ops.GenMatchCache:
        """Attach (or resize) the generation-stamped topic->filters
        cache in front of the batched match path."""
        if self.match_cache is None or self.match_cache.capacity != capacity:
            self.match_cache = match_ops.GenMatchCache(capacity)
        return self.match_cache

    # --- device failure domain -------------------------------------------

    def suspend_device(self) -> bool:
        """Open-breaker mode: every batched match answers from host
        truth until resume_device(). Returns True on the closed->open
        transition."""
        if self.device_suspended:
            return False
        self.device_suspended = True
        tel = self.telemetry
        if tel.enabled:
            tel.count("device_suspends_total")
            tel.set_gauge("device_suspended", 1)
        return True

    def resume_device(self) -> None:
        if not self.device_suspended:
            return
        self.device_suspended = False
        tel = self.telemetry
        if tel.enabled:
            tel.count("device_resumes_total")
            tel.set_gauge("device_suspended", 0)

    # --- write path (emqx_router:do_add_route / do_delete_route) -------

    def _ensure_row_filter(self) -> None:
        """Keep the row->filter list sized to the table capacity."""
        rf = self._row_filter
        cap = self.table.capacity
        if len(rf) < cap:
            rf.extend([None] * (cap - len(rf)))

    def add_route(self, flt: str, dest: Dest) -> None:
        if not topic_mod.is_wildcard(flt):
            fresh_topic = flt not in self._exact
            dests = self._exact.setdefault(flt, {})
            dests[dest] = dests.get(dest, 0) + 1
            if fresh_topic:
                # exact topics ride the SAME device hash table as
                # wildcard-free classes: one literal-only skeleton per
                # depth. Too-deep topics stay host-only.
                try:
                    row = self.table.add(flt)
                except FilterTooDeep:
                    self._exact_deep.add(flt)
                    self._aux_gen += 1
                else:
                    self._exact_row[flt] = row
                    self._ensure_row_filter()
                    self._row_filter[row] = flt
                    if self.index is not None:
                        self.index.add_row(row, self.table)
            return
        dests = self._wild.get(flt)
        if dests is None and flt in self._deep:
            dests = self._deep[flt]
        if dests is None:
            try:
                row = self.table.add(flt)
            except FilterTooDeep:
                dests = self._deep.setdefault(flt, {})
                self._deep_trie.insert(topic_mod.words(flt), flt)
                self._aux_gen += 1
            else:
                dests = self._wild.setdefault(flt, {})
                self._filter_row[flt] = row
                self._ensure_row_filter()
                self._row_filter[row] = flt
                self._trie_pending_f.append(self.table.filter_words(row))
                self._trie_pending_r.append(row)
                if self.index is not None:
                    self.index.add_row(row, self.table)
        dests[dest] = dests.get(dest, 0) + 1

    def add_routes(self, pairs: Sequence[Tuple[str, Dest]]) -> None:
        """Batched add_route — the router-syncer write path. Dest/dict
        bookkeeping stays per-pair, but NEW filters go through the
        vectorized table scatter + class-index bulk placement, which is
        what subscribe storms hit. Each filter is split once and its
        parts ride into add_bulk."""
        new_exact: List[str] = []
        new_exact_parts: List[List[str]] = []
        new_wild: List[str] = []
        new_wild_parts: List[List[str]] = []
        exact_t = self._exact
        wild_t = self._wild
        deep_t = self._deep
        parts_all = [flt.split("/") for flt, _d in pairs]
        wildness = [("+" in ws or "#" in ws) for ws in parts_all]
        for (flt, _dest), ws, wild in zip(pairs, parts_all, wildness):
            if wild:
                if flt not in wild_t and flt not in deep_t:
                    wild_t[flt] = {}
                    new_wild.append(flt)
                    new_wild_parts.append(ws)
            elif flt not in exact_t:
                exact_t[flt] = {}
                new_exact.append(flt)
                new_exact_parts.append(ws)
        idx_rows: List[int] = []
        idx_flts: List[str] = []
        if new_exact:
            rows = self.table.add_bulk(new_exact, new_exact_parts)
            self._ensure_row_filter()  # add_bulk may have grown capacity
            row_filter = self._row_filter
            for flt, row in zip(new_exact, rows):
                if row < 0:
                    self._exact_deep.add(flt)
                    self._aux_gen += 1
                else:
                    self._exact_row[flt] = row
                    row_filter[row] = flt
                    idx_rows.append(row)
                    idx_flts.append(flt)
        if new_wild:
            rows = self.table.add_bulk(new_wild, new_wild_parts)
            self._ensure_row_filter()
            row_filter = self._row_filter
            for flt, row in zip(new_wild, rows):
                if row < 0:
                    # too deep for the flattened table: migrate the
                    # just-registered dest dict to the deep-trie store
                    deep_t[flt] = wild_t.pop(flt)
                    self._deep_trie.insert(topic_mod.words(flt), flt)
                    self._aux_gen += 1
                else:
                    self._filter_row[flt] = row
                    row_filter[row] = flt
                    self._trie_pending_f.append(flt)
                    self._trie_pending_r.append(row)
                    idx_rows.append(row)
                    idx_flts.append(flt)
        if idx_rows and self.index is not None:
            self.index.add_rows(idx_rows, self.table, idx_flts)
        # dest bookkeeping per pair (duplicates in the batch included)
        for (flt, dest), wild in zip(pairs, wildness):
            if not wild:
                dests = exact_t[flt]
            else:
                dests = wild_t.get(flt)
                if dests is None:
                    dests = deep_t[flt]
            dests[dest] = dests.get(dest, 0) + 1

    def delete_routes(self, pairs: Sequence[Tuple[str, Dest]]) -> None:
        """Batched delete_route (the syncer's delete leg)."""
        for flt, dest in pairs:
            self.delete_route(flt, dest)

    def delete_route(self, flt: str, dest: Dest) -> None:
        if not topic_mod.is_wildcard(flt):
            dests = self._exact.get(flt)
            if not dests or dest not in dests:
                return
            dests[dest] -= 1
            if dests[dest] == 0:
                del dests[dest]
                if not dests:
                    del self._exact[flt]
                    row = self._exact_row.pop(flt, None)
                    if row is not None:
                        self._row_filter[row] = None
                        if self.index is not None:
                            self.index.remove_row(row)
                        self.table.remove(row)
                    else:
                        self._exact_deep.discard(flt)
                        self._aux_gen += 1
            return
        deep = False
        dests = self._wild.get(flt)
        if dests is None:
            dests = self._deep.get(flt)
            deep = True
        if dests is None or dest not in dests:
            return
        dests[dest] -= 1
        if dests[dest]:
            return
        del dests[dest]
        if not dests:
            if deep:
                del self._deep[flt]
                self._deep_trie.remove(topic_mod.words(flt), flt)
                self._aux_gen += 1
            else:
                del self._wild[flt]
                row = self._filter_row.pop(flt)
                self._row_filter[row] = None
                self._host_trie().remove(topic_mod.words(flt), row)
                if self.index is not None:
                    self.index.remove_row(row)
                self.table.remove(row)

    def has_route(self, flt: str, dest: Dest) -> bool:
        if not topic_mod.is_wildcard(flt):
            return dest in self._exact.get(flt, ())
        return dest in self._wild.get(flt, ()) or dest in self._deep.get(flt, ())

    def topic_count(self) -> int:
        """O(1) routed-topic count (the stores are disjoint)."""
        return len(self._exact) + len(self._wild) + len(self._deep)

    def topics(self) -> List[str]:
        """All routed topics/filters (emqx_router:topics/0)."""
        out = list(self._exact)
        out.extend(self._wild)
        out.extend(self._deep)
        return sorted(set(out))

    def dests(self, flt: str) -> List[Dest]:
        """All destinations routed for one topic/filter
        (emqx_router:lookup_routes/1)."""
        if not topic_mod.is_wildcard(flt):
            return list(self._exact.get(flt, ()))
        return list(self._wild.get(flt, ())) + list(self._deep.get(flt, ()))

    def routes(self) -> List[Tuple[str, Dest]]:
        """Every (filter, dest) pair (emqx_router:stream/1)."""
        out: List[Tuple[str, Dest]] = []
        for table in (self._exact, self._wild, self._deep):
            for flt, dests in table.items():
                out.extend((flt, d) for d in dests)
        return out

    def stats(self) -> Dict[str, int]:
        return {
            "exact_topics": len(self._exact),
            "wildcard_filters": len(self._wild),
            "wildcard_routes": sum(len(d) for d in self._wild.values()),
            "deep_routes": sum(len(d) for d in self._deep.values()),
            "table_rows": len(self.table),
            "table_capacity": self.table.capacity,
        }

    # --- read path (emqx_router:match_routes) ---------------------------

    def _host_trie(self) -> TopicTrie:
        """The host trie with any deferred storm writes drained (a host
        read observes every mutation that preceded it, exactly once).
        Pending entries carry words tuples (single add) or raw filter
        strings (bulk add)."""
        pf = self._trie_pending_f
        if pf:
            ins = self._trie.insert
            for ws, row in zip(pf, self._trie_pending_r):
                ins(tuple(ws.split("/")) if type(ws) is str else ws, row)
            pf.clear()
            self._trie_pending_r.clear()
        return self._trie

    def match_filters(self, topic: str) -> List[str]:
        """All routed filters matching one topic (exact key included):
        the host path and the oracle of the batched device path."""
        tw = topic_mod.words(topic)
        out: List[str] = []
        if topic in self._exact:
            out.append(topic)
        for row in self._host_trie().match(tw):
            out.append(self._row_filter[row])
        if self._deep:
            out.extend(self._deep_trie.match(tw))
        return out

    def filter_dests(self, flt: str) -> Dict[Dest, int]:
        """Dest refcount map for a matched filter (read-only view)."""
        if not topic_mod.is_wildcard(flt):
            return self._exact.get(flt, {})
        d = self._wild.get(flt)
        return d if d is not None else self._deep.get(flt, {})

    def match_routes(self, topic: str) -> Set[Dest]:
        """Single-topic host path: exact hash + trie walk."""
        dests: Set[Dest] = set()
        for f in self.match_filters(topic):
            dests.update(self.filter_dests(f))
        return dests

    def match_filters_begin(
        self, topics: Sequence[str], span=None
    ) -> _PendingMatch:
        """Phase 1 of the pipelined batched match: probe the
        generation-stamped match cache, sync the device table, encode
        the uncached remainder, and LAUNCH the match kernels without
        waiting for any device->host transfer. Every begin() must be
        finished exactly once, in begin order, by match_filters_finish;
        match_filters_batch composes the two for the synchronous path.

        `span` (optional) receives encode/kernel/transfer/fetch
        seconds through `span.add(stage, seconds)`."""
        tel = self.telemetry
        clock = tel.clock
        p = _PendingMatch()
        p.span = span
        p.gen = self.generation
        cache = self.match_cache
        if cache is not None and topics:
            full: List[Optional[List[str]]] = []
            sub_idx: List[int] = []
            for i, t in enumerate(topics):
                f = cache.get(t, p.gen)
                if f is None:
                    sub_idx.append(i)
                    full.append(None)
                else:
                    # a fresh list per hit: callers may extend/consume
                    full.append(list(f))
            if tel.enabled:
                nh = len(topics) - len(sub_idx)
                if nh:
                    tel.count("match_cache_hits", nh)
                if sub_idx:
                    tel.count("match_cache_misses", len(sub_idx))
                tel.set_gauge(
                    "match_cache_hit_ratio", round(cache.hit_ratio(), 6)
                )
                tel.set_gauge("match_cache_entries", len(cache))
            p.full_out = full
            p.sub_idx = sub_idx
            sub = [topics[i] for i in sub_idx]
        else:
            sub = list(topics)
        p.topics = sub
        if not sub:
            p.mode = "cached"
            return p
        if self.device_suspended:
            # breaker open: the whole uncached remainder serves from
            # host truth at finish — no encode, no sync, no kernels.
            # The dirty backlog is dropped once it outgrows the table.
            p.mode = "host"
            t = self.table
            if len(t.dirty) > t.capacity:
                t.drain_dirty()
            if tel.enabled:
                tel.count("breaker_degraded_batches_total")
            return p
        tel.count("dispatch_batches_total")
        root = tel.span("device.match_batch")
        if root is not None:
            root.set("batch", len(sub))
        p.root = root
        self.device_table.sync()
        mark = STAGE_MARK
        prev_stage = mark.stage
        mark.stage = "encode"
        sp = tel.span("device.encode", root)
        t0 = clock()
        # the batch axis pads to the next pow2 with inert topics (zero
        # levels, $-rooted: match NOTHING by the length + $-root rules)
        # so launch shapes stay log-bounded; finish drops ti >= len(sub)
        p.enc = enc = match_ops.encode_topics(
            self.table.vocab, sub, self.max_levels,
            pad_to=next_pow2(len(sub)),
        )
        enc_dt = clock() - t0
        tel.record_dispatch(LEG_ENCODE, enc_dt)
        if span is not None:
            span.add("encode", enc_dt)
        tel.end_span(sp)
        # exact topics are device rows (wildcard-free classes), so the
        # kernel surfaces them; only too-deep exacts need the host dict
        if self._exact_deep:
            p.out = [[t] if t in self._exact_deep else [] for t in sub]
        else:
            p.out = [[] for _ in sub]
        mark.stage = "launch"
        ix = self.index
        if ix is not None:
            p.mode = "hash"
            if len(ix):
                t0 = clock()
                p.hash_pending = self.device_table.match_hash_begin(enc)
                p.hash_elapsed = clock() - t0
            if ix.residual_rows:
                # launch the residual-dense leg NOW so it overlaps the
                # hash fetch; the (~never) amb host-fallback in finish
                # simply discards it
                t0 = clock()
                p.residual_pending = self.device_table.match_ids_begin(
                    enc, residual=True
                )
                p.residual_elapsed = clock() - t0
            mark.stage = prev_stage
            if span is not None and p.hash_elapsed is not None:
                span.add("kernel", p.hash_elapsed)
            return p
        p.mode = "dense"
        t0 = clock()
        p.dense_pending = self.device_table.match_ids_begin(enc)
        p.dense_elapsed = clock() - t0
        mark.stage = prev_stage
        if span is not None:
            span.add("kernel", p.dense_elapsed)
        return p

    def _add_row_pairs(self, out, ti, ri, topics, moved: bool) -> None:
        """Name the filter of each (topic, row) pair the dense kernel
        found. When routes changed since the batch's begin (`moved`), a
        row may since have been freed, or taken by another filter off
        the free list, so each pair is checked against the filter the
        row holds now: a route deleted in flight is not reported, and a
        filter that does not match the topic never is."""
        row_filter = self._row_filter
        b = len(topics)
        if not moved:
            for t_idx, row in zip(ti.tolist(), ri.tolist()):
                if t_idx < b:  # drop pow2 padding rows
                    out[t_idx].append(row_filter[row])
            return
        twords: Dict[int, Tuple[str, ...]] = {}
        for t_idx, row in zip(ti.tolist(), ri.tolist()):
            if t_idx >= b:
                continue
            f = row_filter[row]
            if f is None:
                continue
            tw = twords.get(t_idx)
            if tw is None:
                tw = twords[t_idx] = topic_mod.words(topics[t_idx])
            if topic_mod.match(tw, f):
                out[t_idx].append(f)

    def match_filters_finish(self, p: _PendingMatch) -> List[List[str]]:
        """Phase 2 of the pipelined batched match: wait for the
        device->host transfers of a begun batch, escalate on compaction
        overflow, verify the hash candidates on the host, fold in
        deep-trie matches, populate the match cache, and return
        per-topic filter lists — identical to the synchronous result."""
        tel = self.telemetry
        clock = tel.clock
        out = p.out
        topics = p.topics
        span = p.span
        # routes changed while the kernels were in flight: row and
        # bucket ids may have been freed or reused since begin
        moved = p.gen != self.generation
        t_fetch = clock() if span is not None else 0.0
        if p.mode == "host":
            # breaker-open batch: serve every sub-topic from host truth
            t0 = clock()
            out = p.out = [self.match_filters(t) for t in topics]
            tel.record_dispatch(LEG_FALLBACK, clock() - t0)
        if p.mode == "hash":
            root = p.root
            ix = self.index
            host_fallback = False
            if p.hash_pending is not None:
                sp = tel.span("device.dispatch", root)
                t0 = clock()
                ti, bi, amb = self.device_table.match_hash_finish(
                    p.hash_pending
                )
                tel.record_dispatch(LEG_HASH, p.hash_elapsed + clock() - t0)
                tel.end_span(sp)
                if amb:
                    # >1 lane of one pair passed the full-fingerprint
                    # check: distinct filters colliding on all 32 bits.
                    # The kernel kept one, so re-match the batch on the
                    # host trie — exact, and covers residual rows too.
                    tel.count("ambiguous_batches_total")
                    host_fallback = True
                else:
                    sp = tel.span("device.unpack", root)
                    t0 = clock()
                    twords: List = [None] * len(topics)
                    row_filter = self._row_filter
                    for t_idx, bid in zip(ti.tolist(), bi.tolist()):
                        if bid < 0 or t_idx >= len(topics):
                            # phase-2 reject / pow2-padding topic
                            continue
                        if moved and not ix.bucket_live(bid):
                            continue  # its routes were deleted in flight
                        if twords[t_idx] is None:
                            twords[t_idx] = topic_mod.words(topics[t_idx])
                        if topic_mod.match(twords[t_idx], ix.bucket_filter(bid)):
                            for row in ix.bucket_rows(bid):
                                out[t_idx].append(row_filter[row])
                    tel.record_dispatch(LEG_UNPACK, clock() - t0)
                    tel.end_span(sp)
            if host_fallback:
                tel.count("host_fallback_total")
                sp = tel.span("device.host_fallback", root)
                t0 = clock()
                for i, t in enumerate(topics):
                    # indexed exact topics are NOT in the trie — the
                    # dest dict is their host source of truth
                    if t in self._exact_row:
                        out[i].append(t)
                    for row in self._host_trie().match(topic_mod.words(t)):
                        out[i].append(self._row_filter[row])
                tel.record_dispatch(LEG_FALLBACK, clock() - t0)
                tel.end_span(sp)
            elif p.residual_pending is not None:
                sp = tel.span("device.dispatch", root)
                t0 = clock()
                ti, ri = self.device_table.match_ids_finish(p.residual_pending)
                self._add_row_pairs(out, ti, ri, topics, moved)
                tel.record_dispatch(LEG_DENSE, p.residual_elapsed + clock() - t0)
                tel.end_span(sp)
        elif p.mode == "dense":
            sp = tel.span("device.dispatch", p.root)
            t0 = clock()
            ti, ri = self.device_table.match_ids_finish(p.dense_pending)
            self._add_row_pairs(out, ti, ri, topics, moved)
            tel.record_dispatch(LEG_DENSE, p.dense_elapsed + clock() - t0)
            tel.end_span(sp)
        if p.mode not in ("cached", "host"):
            # (host mode already folded deep matches via match_filters)
            if self._deep:
                for i, t in enumerate(topics):
                    out[i].extend(self._deep_trie.match(topic_mod.words(t)))
            tel.end_span(p.root)
        if span is not None:
            # transfer = residual device->host wait the tickets
            # actually blocked for; fetch = everything else finish
            # forces (overflow escalation, verify, deep-trie fold)
            waited = 0.0
            for h in (p.hash_pending, p.residual_pending, p.dense_pending):
                if h is not None:
                    waited += h[-1].waited
            if waited:
                span.add("transfer", waited)
            span.add("fetch", clock() - t_fetch - waited)
        if p.full_out is None:
            return out if out is not None else []
        # merge the kernel results into the cached prefix and stamp the
        # cache with the generation captured at begin: a mutation that
        # landed mid-flight leaves these entries stale-on-arrival
        full = p.full_out
        cache = self.match_cache
        if out:
            ev0 = cache.evictions
            for j, i in enumerate(p.sub_idx):
                flts = out[j]
                full[i] = flts
                cache.put(topics[j], p.gen, tuple(flts))
            ev = cache.evictions - ev0
            if ev and tel.enabled:
                tel.count("match_cache_evictions", ev)
        return full

    def match_finish_ready(self, p: _PendingMatch) -> bool:
        """True when finishing `p` will not block on a device->host
        transfer; cached and host-mode batches are always ready."""
        for h in (p.hash_pending, p.residual_pending, p.dense_pending):
            if h is not None and not h[-1].ready():
                return False
        return True

    def warmup_shapes(self, max_batch: int = 64) -> int:
        """Run the REAL begin/finish halves over all-padding batches
        (zero live topics — inert by the length + $-root rules) for
        each pow2 batch size up to `max_batch`, so every launch shape a
        production batch can hit has been built, allocated and run
        once before serving. Returns shape buckets warmed; counted as
        `aot_warmups_total`."""
        if self.device_suspended:
            return 0
        dt = self.device_table
        dt.sync()
        warmed = 0
        b = 1
        cap = next_pow2(max(1, max_batch))
        ix = self.index
        while b <= cap:
            enc = match_ops.encode_topics(
                self.table.vocab, (), self.max_levels, pad_to=b
            )
            if ix is not None:
                if len(ix):
                    dt.match_hash_finish(dt.match_hash_begin(enc))
                if ix.residual_rows:
                    dt.match_ids_finish(dt.match_ids_begin(enc, residual=True))
            else:
                dt.match_ids_finish(dt.match_ids_begin(enc))
            warmed += 1
            b *= 2
        tel = self.telemetry
        if tel.enabled and warmed:
            tel.count("aot_warmups_total", warmed)
        return warmed

    def match_filters_batch(self, topics: Sequence[str]) -> List[List[str]]:
        """Batched device path: one kernel launch per leg for the whole
        batch. With the pattern-class index (default) the wildcard leg
        is the B×C hash-probe kernel returning (topic, bucket)
        candidates that the host verifies against the oracle; rows the
        index couldn't class fall back to the dense kernel over a
        residual mask. Composed from the begin/finish halves, so the
        synchronous and pipelined paths are one code path."""
        if not topics:
            return []
        return self.match_filters_finish(self.match_filters_begin(topics))

    def match_pairs_batch(
        self, topics: Sequence[str]
    ) -> List[List[Tuple[str, Dict[Dest, int]]]]:
        return [
            [(f, self.filter_dests(f)) for f in flts]
            for flts in self.match_filters_batch(topics)
        ]

    def match_batch(self, topics: Sequence[str]) -> List[Set[Dest]]:
        out: List[Set[Dest]] = []
        for flts in self.match_filters_batch(topics):
            dests: Set[Dest] = set()
            for f in flts:
                dests.update(self.filter_dests(f))
            out.append(dests)
        return out
