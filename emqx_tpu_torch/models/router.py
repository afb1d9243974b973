"""The route table: Topic/Filter -> destinations, with a device-resident
wildcard matcher kept coherent by batched incremental sync
(counterpart of emqx_tpu/models/router.py).

Reproduces the reference v2 routing split (apps/emqx/src/emqx_router.erl):
  * exact-topic routes in a plain host hash table (?ROUTE_TAB), which
    also ride the device hash table as wildcard-free classes;
  * wildcard routes in BOTH a host trie (ops/host_index.py — the
    single-publish cut-through path) and the flattened device table
    (ops/table.py + the match kernels — the batched scale path);
  * a (filter, dest) pair is one logical route; duplicates refcount
    (bag semantics of mria route tables).

Device coherence mirrors emqx_router_syncer (apps/emqx/src/
emqx_router_syncer.erl:57 ?MAX_BATCH_SIZE 1000): dirty rows and cuckoo
slots drain into one staged buffer, which one launch of the fused K3/K4
kernel (`table_sync`) applies to the device tensors in place; only
capacity growth re-uploads.

Destinations live twice: in the host dest dicts (the oracle and the
single-publish path) and in a CSR destination store fed by the same
route transitions (ops/fanout.py DestStore), mirrored on the card so a
matched filter set resolves to its deduped delivery plan through kernel
K5 (`resolve_fanout_begin/finish`). With a mesh
(`Router(mesh=...)`, parallel/mesh.py) the table is sub-sharded across
it (parallel/sharded_match.py ShardedDeviceTable) behind the same
surface. The device failure domain's router half is here: the
`fault_injector` seam at every leg (chaos/faults.py), the open-breaker
host mode (`suspend_device`), the host re-serve of a failed batch
(`match_filters_host`), the breaker's canary (`canary_match`) and its
full re-upload (`device_resync`). The shadow-audit quarantine is here
too: the publish sentinel (obs/sentinel.py) moves filters whose served
answer diverged from host truth to the host walk
(`quarantine_filters`; the overlay in `match_filters_finish`, the
refusal in `resolve_fanout_begin`) until the next table sync re-uploads
the index and their rows, which ends it (`_maybe_unquarantine`). The
chaos corrupters (`chaos_corrupt_rows`, `chaos_corrupt_slots`) decay
the device slot table in place, on one device and on the mesh, so that
chain can be driven. The shard failure domain's router half is here
too: `suspend_shard` answers one sub shard's slice from host truth (the
overlay in `match_filters_finish`, scoped by ownership), `probe_shard`
is the direct probe of one chip, and `evacuate_shard` /
`rebalance_shard` re-shard the mesh table and re-upload it in full. A
batch begun before a re-shard finishes on the tensors it was launched
against, and the bumped generation has its pairs re-checked.

Route writes run through the native churn core by default
(ops/speedups.py over the port's speedups.cc): `add_route`,
`add_routes`, `delete_route` and `delete_routes` hand their pairs to one
C pass that mutates the SAME dicts, lists and numpy arrays the Python
legs do, bumps the table generation, marks dest-store rows pending and
appends dirty rows and slots for the device syncs. The Python legs stay
as the twin, selected only by `speedups.set_native_enabled(False)`
before the Router is built.
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
from ..ops import fanout as fanout_ops
from ..ops import hash_index as hash_ops
from ..ops import match as match_ops
from ..ops import speedups as _speedups
from ..ops import topic as topic_mod
from ..ops import transfer as transfer_ops
from ..ops._build import I, P, CudaKernel, raw_stream
from ..ops.hash_index import BUCKET_W, ClassIndex, ClassMeta, SlotArrays
from ..ops.host_index import TopicTrie
from ..ops.delta import pack_table_delta, staged_columns, table_delta_layout
from ..ops.match import check_tensor
from ..ops.table import (
    EncodedFilters,
    FilterTable,
    FilterTooDeep,
    next_pow2,
)
from ..parallel.sharded_match import ShardedDeviceTable

Dest = Hashable

SYNC_BATCH_SIZE = 1024  # rows per scatter batch (ref: ?MAX_BATCH_SIZE 1000)


# --- K3/K4: the plain PyTorch versions -------------------------------------


def scatter_rows_ref(
    dev: EncodedFilters,
    rows: torch.Tensor,  # int32 row ids, any shape ([n_batches, K] or flat)
    words: torch.Tensor,  # int32, rows' shape + [L]
    prefix_len: torch.Tensor,  # int32, rows' shape
    has_hash: torch.Tensor,  # bool, rows' shape
    root_wild: torch.Tensor,  # bool, rows' shape
    active: torch.Tensor,  # bool, rows' shape
    residual: Optional[torch.Tensor] = None,  # bool [N], updated in place
    res: Optional[torch.Tensor] = None,  # bool, rows' shape
) -> None:
    """Plain version of the table sync's row side (K3): write the five
    filter columns, and the residual-mask bytes where `residual` is
    given, into `dev` in place. Ids outside the table are dropped, as
    JAX drops out-of-range scatter updates; a repeated id (the
    reference's padding) carries the same values every time."""
    n, levels = dev.words.shape
    r = rows.reshape(-1).to(torch.int64)
    keep = (r >= 0) & (r < n)
    r = r[keep]
    dev.words[r] = words.reshape(-1, levels)[keep]
    dev.prefix_len[r] = prefix_len.reshape(-1)[keep]
    dev.has_hash[r] = has_hash.reshape(-1)[keep]
    dev.root_wild[r] = root_wild.reshape(-1)[keep]
    dev.active[r] = active.reshape(-1)[keep]
    if residual is not None:
        residual[r] = res.reshape(-1)[keep]


def scatter_slots_ref(
    slots: SlotArrays,
    idx: torch.Tensor,  # int32 flat slot ids, any shape
    fp: torch.Tensor,  # uint32, idx's shape
    bucket: torch.Tensor,  # int32, idx's shape
    probe: torch.Tensor,  # uint32, idx's shape — merged probe WORDS
) -> None:
    """Plain version of the table sync's slot side (K4): write fp/bucket
    at the slot ids and the merged probe words at slot // BUCKET_W, in
    place; slot ids outside the table are dropped with their probe
    word. uint32 columns are written through their int32 view (same
    bits; the CPU has no uint32 index_put)."""
    i = idx.reshape(-1).to(torch.int64)
    keep = (i >= 0) & (i < slots.fp.shape[0])
    i = i[keep]
    slots.fp.view(torch.int32)[i] = fp.reshape(-1).view(torch.int32)[keep]
    slots.bucket[i] = bucket.reshape(-1)[keep]
    slots.probe.view(torch.int32)[i // BUCKET_W] = probe.reshape(-1).view(torch.int32)[keep]


def table_sync_ref(
    dev: EncodedFilters,
    slots: Optional[SlotArrays],
    residual: Optional[torch.Tensor],
    staged: torch.Tensor,
    n_r: int,
    n_s: int,
) -> None:
    """Plain version of the fused K3/K4 table sync: apply a staged delta
    (`stage_table_delta`) to the filter columns, the residual mask
    (where given) and the slot arrays, in place."""
    rows, sl = staged_columns(staged, n_r, dev.words.shape[1], n_s)
    *cols, res = rows
    scatter_rows_ref(dev, *cols, residual=residual, res=res)
    if n_s:
        scatter_slots_ref(slots, *sl)


# --- K3/K4: the fused CUDA kernel --------------------------------------------

_TABLE_SYNC = CudaKernel(
    "table_sync", "scatter.cu", "emqx_table_sync",
    [P, P, P, P, P, P, I, I, P, P, P, I,
     P, P, P, P, P, P, P, ctypes.c_longlong,
     P, P, P, P, ctypes.c_longlong, P],
)
# an empty side of a launch: the row tables (five columns, the mask, N,
# L), the slot tables (three arrays, n_slots), or either side's columns
# with their count
_NO_ROWS = (0, 0, 0, 0, 0, 0, 0, 1)
_NO_SLOTS = (0, 0, 0, 0)
_NO_ROW_COLS = (0, 0, 0, 0, 0, 0, 0, 0)
_NO_SLOT_COLS = (0, 0, 0, 0, 0)


def _row_tables(dev: EncodedFilters, residual: Optional[torch.Tensor], d):
    """The launch's row-table arguments, each table checked: the five
    columns, the residual mask (0 = none), N and L."""
    n, levels = dev.words.shape
    check_tensor("dev.words", dev.words, torch.int32, (n, levels), d)
    check_tensor("dev.prefix_len", dev.prefix_len, torch.int32, (n,), d)
    for name in ("has_hash", "root_wild", "active"):
        check_tensor(f"dev.{name}", getattr(dev, name), torch.bool, (n,), d)
    if residual is not None:
        check_tensor("residual", residual, torch.bool, (n,), d)
    return (dev.words.data_ptr(), dev.prefix_len.data_ptr(), dev.has_hash.data_ptr(),
            dev.root_wild.data_ptr(), dev.active.data_ptr(),
            0 if residual is None else residual.data_ptr(), n, levels)


def _slot_tables(slots: SlotArrays, d):
    """The launch's slot-table arguments, each array checked."""
    n_slots = slots.fp.shape[0]
    check_tensor("slots.fp", slots.fp, torch.uint32, (n_slots,), d)
    check_tensor("slots.bucket", slots.bucket, torch.int32, (n_slots,), d)
    check_tensor("slots.probe", slots.probe, torch.uint32, (n_slots // BUCKET_W,), d)
    return slots.fp.data_ptr(), slots.bucket.data_ptr(), slots.probe.data_ptr(), n_slots


def stage_table_delta(
    host: EncodedFilters,
    rows: np.ndarray,
    slots: Optional[SlotArrays],
    sids: np.ndarray,
    residual_rows: Optional[Set[int]],
    device: torch.device,
) -> torch.Tensor:
    """`pack_table_delta`'s buffer moved to `device` in one copy: the
    `staged` argument of table_sync."""
    return to_device(pack_table_delta(host, rows, slots, sids, residual_rows), device)


def table_sync(
    dev: EncodedFilters,
    slots: Optional[SlotArrays],
    residual: Optional[torch.Tensor],
    staged: torch.Tensor,
    n_r: int,
    n_s: int,
) -> None:
    """A DeviceTable's delta sync in place (the reference's
    `_scatter_rows`, `_scatter_slots` and residual-mask upload), from one
    staged buffer (`stage_table_delta`'s layout, no padding). `residual`
    None leaves the mask alone; `slots` may be None when n_s is 0. CUDA
    tensors launch the fused K3/K4 kernel once, or not at all when both
    sides are empty; CPU tensors take the plain version."""
    if n_r < 0 or n_s < 0:
        raise ValueError(f"table_sync: negative entry counts ({n_r}, {n_s})")
    if n_s and slots is None:
        raise ValueError("table_sync: slot entries but no slot arrays")
    d = dev.words.device
    if d.type == "cpu":
        table_sync_ref(dev, slots, residual, staged, n_r, n_s)
        return
    rt = _row_tables(dev, residual, d)
    st = _NO_SLOTS if slots is None else _slot_tables(slots, d)
    w_off, s_off, total = table_delta_layout(n_r, rt[-1], n_s)
    check_tensor("staged", staged, torch.uint8, (total,), d)
    if n_r + n_s == 0:
        return
    p = staged.data_ptr()
    s = p + s_off
    _TABLE_SYNC(
        *rt, *st, p, p + w_off, p + 4 * n_r, p + 8 * n_r, p + 9 * n_r,
        p + 10 * n_r, 0 if residual is None else p + 11 * n_r, n_r,
        s, s + 4 * n_s, s + 8 * n_s, s + 12 * n_s, n_s, raw_stream(d),
    )


def scatter_rows(
    dev: EncodedFilters, rows, words, prefix_len, has_hash, root_wild, active
) -> None:
    """In-place batched write of the five filter columns at the reference
    `_scatter_rows`'s [n_batches, K] padded row ids: the fused K3/K4
    kernel with no slots and no residual column (CUDA), or its plain
    version (CPU)."""
    d = dev.words.device
    if d.type == "cpu":
        scatter_rows_ref(dev, rows, words, prefix_len, has_hash, root_wild, active)
        return
    rt = _row_tables(dev, None, d)
    shape = tuple(rows.shape)
    check_tensor("rows", rows, torch.int32, shape, d)
    check_tensor("words", words, torch.int32, shape + (rt[-1],), d)
    check_tensor("prefix_len", prefix_len, torch.int32, shape, d)
    for name, t in (("has_hash", has_hash), ("root_wild", root_wild), ("active", active)):
        check_tensor(name, t, torch.bool, shape, d)
    n = rows.numel()
    if n == 0:
        return
    _TABLE_SYNC(
        *rt, *_NO_SLOTS, rows.data_ptr(), words.data_ptr(), prefix_len.data_ptr(),
        has_hash.data_ptr(), root_wild.data_ptr(), active.data_ptr(), 0, n,
        *_NO_SLOT_COLS, raw_stream(d),
    )


def scatter_slots(slots: SlotArrays, idx, fp, bucket, probe) -> None:
    """In-place batched write of the cuckoo slot arrays at the reference
    `_scatter_slots`'s [n_batches, K] padded slot ids: the fused K3/K4
    kernel with no rows (CUDA), or its plain version (CPU)."""
    d = slots.fp.device
    if d.type == "cpu":
        scatter_slots_ref(slots, idx, fp, bucket, probe)
        return
    st = _slot_tables(slots, d)
    shape = tuple(idx.shape)
    check_tensor("idx", idx, torch.int32, shape, d)
    check_tensor("fp", fp, torch.uint32, shape, d)
    check_tensor("bucket", bucket, torch.int32, shape, d)
    check_tensor("probe", probe, torch.uint32, shape, d)
    n = idx.numel()
    if n == 0:
        return
    _TABLE_SYNC(
        *_NO_ROWS, *st, *_NO_ROW_COLS,
        idx.data_ptr(), fp.data_ptr(), bucket.data_ptr(), probe.data_ptr(), n,
        raw_stream(d),
    )


def _n_batches(n: int) -> int:
    """The reference's pow2 batch count for n sync entries
    (ops.table.pad_pow2_batches), its telemetry's shape bucket."""
    return next_pow2(-(-n // SYNC_BATCH_SIZE))


_NO_IDS = np.zeros(0, np.int32)


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
        self.fanout: Optional[fanout_ops.FanoutDeviceState] = None
        # chaos fault seam (chaos/faults.py): one attribute read per
        # sync when absent
        self.fault_injector = None
        # transfer chunk cap (ops/transfer.chunk_hits): bounds the
        # compacted-pair result buffers to what the link streams in
        # one RTT; None = unbounded (the exact-size escalation retry
        # keeps correctness either way)
        self.transfer_chunk_hits: Optional[int] = None
        # the hash leg's sticky floor: the largest next_pow2(total) an
        # overflow has needed, so a steady stream of batches whose
        # flagged pairs pass the first bound escalates once, not every
        # batch (the mesh's _mh_floor); and the last begun hash launch
        # (bound, ticket), whose overflow raises the floor as soon as its
        # count has landed
        self._hash_mh_floor = 0
        self._last_hash: Optional[Tuple[int, transfer_ops.FetchTicket]] = None

    def attach_fanout(self, store: fanout_ops.DestStore) -> None:
        """Mirror a CSR destination store on this device — the
        resolve-side counterpart of the filter mirror, same sync
        discipline (ops/fanout.FanoutDeviceState)."""
        self.fanout = fanout_ops.FanoutDeviceState(
            store, device=self.device, telemetry=self.telemetry
        )

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return to_device(a, self.device)

    def _upload_full(self) -> None:
        snap = self.table.snapshot()
        self._dev = EncodedFilters(*(self._put(a) for a in snap))
        self._synced_capacity = self.table.capacity

    def _sync_index(self, full: bool) -> np.ndarray:
        """The index's whole-array uploads: the class metadata when it
        changed, the slot arrays after a rebuild, the residual mask on a
        full sync. Returns the dirty slot ids (sorted, distinct) that the
        delta's launch writes."""
        ix = self.index
        assert ix is not None
        if ix.meta_dirty or self._dev_meta is None:
            # upload only the pow2-packed active-class prefix: kernel
            # work is B x C probes, so C tracks the live class count
            self._dev_meta = ClassMeta(*(self._put(a) for a in ix.packed_meta()))
            ix.meta_dirty = False
        sids = _NO_IDS
        if ix.rebuilt or self._dev_slots is None:
            ix.dirty_slots.clear()
            self._dev_slots = SlotArrays(*(self._put(a) for a in ix.slots))
            ix.rebuilt = False
        elif ix.dirty_slots:
            sids = np.unique(np.asarray(ix.dirty_slots, np.int32))
            ix.dirty_slots.clear()
        if full or self._dev_residual is None:
            mask = np.zeros(self.table.capacity, bool)
            if ix.residual_rows:
                mask[list(ix.residual_rows)] = True
            self._dev_residual = self._put(mask)
        # otherwise the delta's row side carries the mask's changes: a
        # row's residual flag changes only when the row is added or
        # removed, and such a row is always in the table's dirty list
        ix.residual_dirty = False
        return sids

    def hash_state(self) -> Tuple[ClassMeta, SlotArrays]:
        assert self._dev_meta is not None and self._dev_slots is not None
        return self._dev_meta, self._dev_slots

    def residual_filters(self) -> EncodedFilters:
        """EncodedFilters view whose active mask covers only residual
        (budget-overflow) rows — input to the dense kernel. A delta sync
        rewrites the mask in place, as it does the rows: a begun batch's
        K2 launch precedes the next sync's launch on the same stream, so
        it reads the mask and rows it was launched against."""
        assert self._dev is not None and self._dev_residual is not None
        return self._dev._replace(active=self._dev_residual)

    def sync(self) -> int:
        """Bring device state up to date; returns rows written."""
        fi = self.fault_injector
        if fi is not None:
            fi.check("sync")
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
        """(rows written, was a full re-upload). A delta sync stages its
        dirty rows (with their residual bytes) and dirty slots in one
        buffer and applies it with one copy and one launch of the fused
        K3/K4 kernel, or none when nothing is dirty; growth re-uploads
        the rows and the mask whole, a rebuild the slots."""
        t = self.table
        ix = self.index
        full = self._dev is None or t.grew or t.capacity != self._synced_capacity
        if full:
            n = len(t.dirty)
            t.drain_dirty()
            self._upload_full()
            rows = _NO_IDS
        else:
            rows = t.drain_dirty()
            n = len(rows)
        sids = _NO_IDS if ix is None else self._sync_index(full)
        n_r, n_s = len(rows), len(sids)
        if n_r + n_s == 0:
            return n, full
        # the reference's shape buckets, so the telemetry reads the same
        tel = self.telemetry
        if n_r:
            tel.record_shape("scatter_rows", (_n_batches(n_r), t.capacity, t.max_levels))
        if n_s:
            tel.record_shape("scatter_slots", (_n_batches(n_s), len(ix.slots.fp)))
        staged = stage_table_delta(
            t.snapshot(), rows, None if ix is None else ix.slots, sids,
            None if ix is None else ix.residual_rows, self.device,
        )
        table_sync(self._dev, self._dev_slots if n_s else None, self._dev_residual,
                   staged, n_r, n_s)
        return n, full

    def filters(self) -> EncodedFilters:
        assert self._dev is not None, "sync() before matching"
        return self._dev

    # --- batched-match surface ---------------------------------------
    # Every begin LAUNCHES its kernel and immediately starts the
    # device->host copy of the compacted result buffers
    # (ops/transfer.FetchTicket), so batch N's transfer rides under
    # batch N+1's encode+launch; the finish half pays only the residual
    # wait. Handles carry the ticket as their LAST element.

    def _cap_hits(self, mh: int) -> int:
        cap = self.transfer_chunk_hits
        if cap is not None and mh > cap >= 1024:
            # floor-pow2 of the chunk budget: shapes stay log-bounded
            mh = 1 << (cap.bit_length() - 1)
        return mh

    def _topics(self, enc: match_ops.EncodedTopics) -> match_ops.EncodedTopics:
        return match_ops.EncodedTopics(*(self._put(a) for a in enc))

    def _landed_overflow(self) -> int:
        """next_pow2 of the last begun hash launch's total when that
        launch overflowed its bound and its count has already landed on
        the host, else 0. Never blocks: it reads the fetch only once
        ready() says it has landed. So the second batch of a two-deep
        pipeline launches at the bound the first one needed, and only
        the first escalates."""
        last = self._last_hash
        if last is None or not last[1].ready():
            return 0
        mh, ticket = last
        total = int(ticket.wait()[2])
        return next_pow2(total) if total > mh else 0

    def match_hash_begin(self, enc: match_ops.EncodedTopics):
        """Launch the pattern-class hash kernel + begin the result
        transfer; no host wait is forced. The bound is the first one
        raised to the sticky floor. Returns an opaque handle for
        match_hash_finish (ticket last)."""
        meta, slots = self.hash_state()
        b = int(enc.ids.shape[0])
        self._hash_mh_floor = max(self._hash_mh_floor, self._landed_overflow())
        mh = max(self._cap_hits(max(1024, next_pow2(2 * b))), self._hash_mh_floor)
        shape = (b, int(meta.plen.shape[0]), int(slots.fp.shape[0]))
        self.telemetry.record_shape("match_ids_hash", shape + (mh,))
        denc = self._topics(enc)
        dev = hash_ops.match_ids_hash(meta, slots, denc, max_hits=mh)
        STAGE_MARK.stage = "ticket_start"
        ticket = transfer_ops.start_fetch(dev, self.telemetry)
        self._last_hash = (mh, ticket)
        return (denc, mh, shape, ticket)

    def match_hash_finish(self, pending):
        """Force a begun hash match, re-launching at next_pow2(total)
        while the compacted buffer overflows; that bound becomes the
        floor of later begins. Returns (ti, bi, amb):
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
            self._hash_mh_floor = max(self._hash_mh_floor, mh)
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
            mh = self._cap_hits(max(1024, next_pow2(2 * b)))
        else:
            mh = self._cap_hits(max(4096, next_pow2(4 * b)))
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
        mesh=None,
    ) -> None:
        """`device` None means CUDA (raising when no card is present);
        pass "cpu" to run the kernels' plain versions on the host.

        With `mesh` (parallel/mesh.py Mesh) the wildcard table lives
        SUB-SHARDED across the mesh (ShardedDeviceTable): the hash leg
        runs with the cuckoo buckets split over sub, the dense kernel
        serves only residual rows, as on one device, and `device` is
        not read."""
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
        # True when the pending op list was DROPPED (write-only storms
        # outgrew it — see _trie_gc): the next host read rebuilds the
        # trie from live state instead of replaying. The counter
        # amortizes the single-row delete path's backlog check.
        self._trie_stale = False
        self._trie_gc_tick = 0
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
        self.mesh = mesh
        if mesh is not None:
            self.device_table = ShardedDeviceTable(
                self.table, mesh, index=self.index, telemetry=self.telemetry,
            )
        else:
            self.device_table = DeviceTable(
                self.table, device=device, index=self.index,
                telemetry=self.telemetry,
            )
        # CSR destination store — the resolve half of the publish path
        # (ops/fanout.py): one segment of (client, packed subopts)
        # edges per table-resident filter row, fed by the same route
        # transitions that maintain the dest dicts so segment order ==
        # dict insertion order (the oracle's iteration order). Filters
        # without a row (deep-trie / too-deep exacts) stay host-only and
        # resolve_fanout_begin refuses them.
        self.dest_store = fanout_ops.DestStore(
            row_capacity=self.table.capacity
        )
        self.device_table.attach_fanout(self.dest_store)
        # live-suboption seam for lazy segment rebuilds: the Broker
        # installs `(flt, dest) -> (SubOpts, session) | None`; None
        # (standalone routers) stores every client edge as SKIP, which
        # matches the oracle (no suboption -> not in the plan)
        self.fanout_opts_lookup = None
        # device failure domain (broker/dispatch_engine.py breaker +
        # chaos/faults.py): `fault_injector` is the chaos seam at the
        # card (None costs one attribute read per leg);
        # `device_suspended` routes every batched match and fanout
        # resolve through the host walk — degraded-but-correct service
        # while the circuit breaker is open.
        self.fault_injector = None
        self.device_suspended = False
        # shard failure domain (ShardedDeviceTable only): sub columns
        # whose slice the host overlay in match_filters_finish answers
        # while their chip is sick; the OTHER shards keep serving on the
        # device (device_suspended forfeits the whole mesh)
        self._suspended_shards: Set[int] = set()
        # shadow-audit quarantine (obs/sentinel.py): filters whose
        # device rows diverged from the host oracle. While quarantined
        # a filter is answered by the host walk (overlay in
        # match_filters_finish, refusal in resolve_fanout_begin); its
        # row is re-marked dirty so the next table sync rewrites device
        # state from host truth, which auto-unquarantines (counted).
        self._quarantined: Dict[str, Optional[int]] = {}
        # native churn core state: the handle caches the C side's
        # entire attribute/buffer fetch so a ONE-pair add/delete rides
        # the same core as a 1000-row storm with ~zero per-call setup.
        # headroom counts how many fresh rows the last _reserve_native
        # pre-grew for; reserve (and the post-rebuild path) recreate
        # the handle because growth REPLACES the numpy arrays the
        # handle's buffers pin. _churn_reserve is the pre-grow chunk
        # for single-row adds. `_sp` is None when the twin was selected
        # (speedups.set_native_enabled(False)) before construction.
        self._churn_reserve = 512
        self._native_headroom = 0
        self._churn_handle = None
        sp = self._sp = _speedups.load()
        self._add_core = sp.add_route_core if sp is not None else None
        self._del_core = sp.del_route_core if sp is not None else None

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

    # --- shadow-audit quarantine (obs/sentinel.py) ----------------------

    def quarantine_filters(self, filters: Sequence[str]) -> int:
        """Move `filters` to the host-walk fallback: the batched match
        path overlays their answers from the host state and the fanout
        kernel refuses their rows, until the next table sync rewrites
        the rows from host truth. Returns newly quarantined count."""
        tel = self.telemetry
        added = 0
        for f in filters:
            if f in self._quarantined:
                continue
            row = self._fanout_row(f)
            self._quarantined[f] = row
            if row is not None:
                # force a device rewrite of this row at the next sync —
                # content is unchanged host-side, so no generation bump
                # from the table itself
                self.table.dirty.append(row)
                # dest segment rebuilds from the dest dict at the next
                # resolve (post-unquarantine), through the live
                # suboption seam — same lazy path as the storm feed
                self.dest_store.pending_rows.add(row)
            added += 1
        if added:
            # cached match results were populated from the now-suspect
            # device output: stale them all via the aux generation
            self._aux_gen += 1
            # the divergence localizes to filters, not to WHICH device
            # array decayed — re-upload the whole hash-index device
            # state at the next sync, not just the rows: the class
            # metadata and the slot arrays (the index's flags) and the
            # residual mask (dropped here, so _sync_index re-uploads it
            # whole on DeviceTable and ShardedDeviceTable alike)
            ix = self.index
            if ix is not None:
                ix.meta_dirty = True
                ix.rebuilt = True
                ix.residual_dirty = True
                self.device_table._dev_residual = None
            if tel.enabled:
                tel.count("audit_quarantine_total", added)
                tel.set_gauge(
                    "audit_quarantined_filters", len(self._quarantined)
                )
        return added

    def quarantined_filters(self) -> List[str]:
        return sorted(self._quarantined)

    def _quarantine_overlay(
        self, topics: Sequence[str], out: List[List[str]]
    ) -> None:
        """Rewrite kernel answers for quarantined filters from host
        truth: a filter the device wrongly dropped is re-added, one it
        wrongly surfaced is removed. Runs only while the quarantine set
        is non-empty — the steady-state cost is one falsy test in
        match_filters_finish. Covers batches LAUNCHED against the
        corrupt table that finish after the audit quarantined it (the
        pipeline's in-flight window)."""
        q = []
        for f in self._quarantined:
            routed = (
                f in self._wild or f in self._deep or f in self._exact
            )
            q.append((f, topic_mod.words(f), routed))
        served = 0
        for i, t in enumerate(topics):
            tw = topic_mod.words(t)
            lst = out[i]
            for f, fw, routed in q:
                hit = routed and topic_mod.match(tw, fw)
                if hit and f not in lst:
                    lst.append(f)
                elif not hit and f in lst:
                    lst.remove(f)
            served += 1
        tel = self.telemetry
        if tel.enabled and served:
            tel.count("audit_quarantine_overlay_total", served)

    def _maybe_unquarantine(self) -> None:
        """Called after a device sync: once the dirtied rows drained,
        the device rows were rewritten from host truth — the clean
        table sync that ends the quarantine."""
        if self.table.dirty:
            return  # quarantined rows not yet synced (mid-storm)
        n = len(self._quarantined)
        self._quarantined.clear()
        self._aux_gen += 1
        tel = self.telemetry
        if tel.enabled:
            tel.count("audit_unquarantine_total", n)
            tel.set_gauge("audit_quarantined_filters", 0)

    # --- chaos corruption seam --------------------------------------------

    def chaos_corrupt_rows(self, filters: Sequence[str]) -> int:
        """Fault injection: empty the DEVICE copy of the given filters'
        cuckoo slots while host truth stays pristine. The hash kernel
        stops surfacing exactly these filters, so a served publish on a
        matching topic diverges from the host oracle and the sentinel's
        detect -> quarantine -> clean-sync chain must engage. Scoped:
        every other filter keeps serving correctly. The write is one
        in-place store per device tensor, in stream order before the
        next launch (no host round trip of the table); on a mesh each
        slot is written in the bucket tensor of every device group
        holding its shard. Returns slots corrupted (0 when a filter is
        host-resident or unclassed, or the device state is not built
        yet — callers warm the table first). The quarantine's recovery
        sync re-uploads the index state, which heals this."""
        ix = self.index
        if ix is None or getattr(self.device_table, "_dev_slots", None) is None:
            return 0
        slots = []
        for f in filters:
            row = self._fanout_row(f)
            if row is None or row >= len(ix._row_bucket):
                continue
            b = int(ix._row_bucket[row])
            if b < 0:
                continue  # residual/unclassed: dense leg, not slotted
            slots.append(int(ix._bkt_slot[b]))
        if not slots:
            return 0
        self._corrupt_slot_ids(np.asarray(slots, np.int64))
        if self.telemetry.enabled:
            self.telemetry.count("chaos_corrupt_slots_total", len(slots))
        return len(slots)

    def chaos_corrupt_slots(self) -> int:
        """Fault injection: full device slot-table decay — every bucket
        id becomes -1, so the hash kernel stops surfacing every classed
        filter. Returns slots decayed (the device table's slot count,
        a mesh's trailing pad slots included, as the reference counts)."""
        dt = self.device_table
        if self.index is None or getattr(dt, "_dev_slots", None) is None:
            return 0
        n = self._corrupt_slot_ids(None)
        if self.telemetry.enabled:
            self.telemetry.count("chaos_corrupt_slots_total", n)
        return n

    def _corrupt_slot_ids(self, slots: Optional[np.ndarray]) -> int:
        """Write bucket id -1 at global slot ids `slots` (every slot when
        None) of the device slot table; returns the table's global slot
        count. DeviceTable holds one SlotArrays; ShardedDeviceTable one
        per device group, each the bucket-aligned slices of the shards
        that group holds, back to back in sub order (parallel/mesh.py)."""
        dt = self.device_table
        if self.mesh is None:
            bucket = dt._dev_slots.bucket
            if slots is None:
                bucket.fill_(-1)
            else:
                idx = torch.from_numpy(slots).to(bucket.device, non_blocking=True)
                bucket.index_fill_(0, idx, -1)
            return int(bucket.shape[0])
        n_sub = dt.n_shards
        local = 0
        for g, sl in zip(self.mesh.groups, dt._dev_slots):
            bucket = sl.bucket
            local = int(bucket.shape[0]) // len(g.subs)
            if slots is None:
                bucket.fill_(-1)
                continue
            shard = slots // local
            keep = np.isin(shard, g.subs)
            if not keep.any():
                continue
            pos_of = np.full(n_sub, -1, np.int64)
            pos_of[list(g.subs)] = np.arange(len(g.subs))
            pos = pos_of[shard[keep]] * local + slots[keep] % local
            idx = torch.from_numpy(pos).to(bucket.device, non_blocking=True)
            bucket.index_fill_(0, idx, -1)
        return local * n_sub

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
        """Close-breaker transition. Callers resume only after
        device_resync() and a verified canary: stale device state would
        serve what the suspension existed to avoid."""
        if not self.device_suspended:
            return
        self.device_suspended = False
        tel = self.telemetry
        if tel.enabled:
            tel.count("device_resumes_total")
            tel.set_gauge("device_suspended", 0)

    def device_resync(self) -> None:
        """Re-upload FULL device state from host truth, for breaker
        recovery, where an outage dropped the delta stream and no delta
        replay can be trusted: the next table sync takes its full
        branch (rows, the index's meta and slots, the residual mask
        whole — on DeviceTable and ShardedDeviceTable alike), and the
        fanout CSR mirror is re-uploaded here, so its copy lands in the
        recovery probe's time and not in the first served resolve's.
        The match cache is staled: entries filled host-side during the
        outage re-earn their place through the device."""
        dt = self.device_table
        dt._dev = None  # _sync_impl's full-upload branch (both tables)
        ix = self.index
        if ix is not None:
            ix.meta_dirty = True
            ix.rebuilt = True
        fan = dt.fanout
        if fan is not None:
            fan._seg_off = None  # FanoutDeviceState's full-upload branch
            fan.sync()
        self._aux_gen += 1
        if self.telemetry.enabled:
            self.telemetry.count("device_resyncs_total")

    def canary_match(self, topics: Sequence[str]) -> List[List[str]]:
        """Device-path probe for the breaker's recovery: run the
        batched kernels for `topics` IGNORING suspension and the match
        cache (the probe must exercise the link and the kernels, not a
        dict). Raises on any device fault; returns per-topic filter
        lists for the caller to compare against match_filters."""
        prev = self.device_suspended
        cache = self.match_cache
        self.device_suspended = False
        self.match_cache = None
        try:
            return self.match_filters_finish(self.match_filters_begin(topics))
        finally:
            self.device_suspended = prev
            self.match_cache = cache

    def match_filters_host(self, p: "_PendingMatch") -> List[List[str]]:
        """Host re-serve of a begun batch whose device leg failed:
        answer every sub-topic from host truth (the oracle the device
        path equals by contract) and merge into the cached prefix, so
        the dispatch engine's failover hands publishers exactly what a
        healthy card would have. The match cache is not filled."""
        out = [self.match_filters(t) for t in p.topics]
        tel = self.telemetry
        if tel.enabled and p.topics:
            tel.count("host_fallback_total")
        if p.full_out is None:
            return out
        full = p.full_out
        for j, i in enumerate(p.sub_idx):
            full[i] = out[j]
        return full

    # --- shard failure domain (ShardedDeviceTable chip loss) -------------

    def suspend_shard(self, shard: int) -> bool:
        """Open the breaker for ONE sub column: topics keep going
        through the kernels, but answers owned by the sick shard's row
        and bucket slice are corrected from host truth by the overlay in
        match_filters_finish (the quarantine's discipline, scoped by
        ownership). Falls back to whole-device suspension when the
        table has no mesh. Returns True on the closed->open
        transition."""
        if self.mesh is None:
            return self.suspend_device()
        if shard in self._suspended_shards:
            return False
        self._suspended_shards.add(shard)
        # match-cache entries may hold the sick shard's answers
        self._aux_gen += 1
        tel = self.telemetry
        if tel.enabled:
            tel.count("shard_suspends_total")
            tel.set_gauge("shards_suspended", len(self._suspended_shards))
        return True

    def resume_shard(self, shard: int) -> None:
        if shard not in self._suspended_shards:
            return
        self._suspended_shards.discard(shard)
        self._aux_gen += 1
        tel = self.telemetry
        if tel.enabled:
            tel.count("shard_resumes_total")
            tel.set_gauge("shards_suspended", len(self._suspended_shards))

    def _shard_owners(self, flt: str) -> Set[int]:
        """The sub columns whose device state can answer (or wrongly
        drop) `flt` under the CURRENT mesh: the shard holding its table
        row (the dense and residual legs) and, for a classed filter, the
        shard holding its bucket's cuckoo slot."""
        dt = self.device_table
        owners: Set[int] = set()
        row = self._fanout_row(flt)
        if row is None:
            return owners  # deep / host-resident: the card never answers it
        owners.add(dt.shard_of_row(row))
        ix = self.index
        if ix is not None and row < len(ix._row_bucket):
            bid = int(ix._row_bucket[row])
            if bid >= 0:
                slot = int(ix._bkt_slot[bid])
                if slot >= 0:
                    owners.add(dt.shard_of_slot(slot))
        return owners

    def _shard_overlay(self, topics: Sequence[str], out: List[List[str]]) -> None:
        """Rewrite kernel answers owned by suspended shards from host
        truth: drop every surfaced filter a sick shard served, then add
        from the host walk exactly the matches a sick shard owns.
        O(answer + host match) a topic, never a walk of the slice."""
        sus = self._suspended_shards
        owners = self._shard_owners
        served = 0
        for i, t in enumerate(topics):
            lst = out[i]
            keep = [f for f in lst if not (owners(f) & sus)]
            truth = [f for f in self.match_filters(t) if owners(f) & sus]
            if truth or len(keep) != len(lst):
                out[i] = keep + truth
            served += 1
        tel = self.telemetry
        if tel.enabled and served:
            tel.count("shard_overlay_total", served)

    def probe_shard(self, shard: int) -> None:
        """Direct probe of one (possibly evacuated) chip for the shard
        breaker's recovery: raises while the chip's fault is live. The
        injector's shard_probe leg ignores lost_shards: probing the
        evacuated chip is the point."""
        fi = self.fault_injector
        if fi is not None:
            # literal = chaos.faults.SHARD_PROBE_LEG (importing chaos
            # here would cycle through broker -> models)
            fi.check("shard_probe", shard=shard)

    def evacuate_shard(self, shard: int) -> bool:
        """Live evacuation: remap the lost shard's row and bucket slices
        onto the surviving chips (a new shard-map generation), re-upload
        from host truth in full and lift the host overlay: N-1 chips
        serve the whole table on the device (the node evacuation of
        emqx_eviction_agent, at shard granularity)."""
        dt = self.device_table
        if self.mesh is None or not dt.evacuate_shard(shard):
            return False
        self._aux_gen += 1
        tel = self.telemetry
        if tel.enabled:
            tel.count("shard_evacuations_total")
            tel.set_gauge("shards_lost", len(dt.lost_shards))
        dt.sync()  # full re-upload onto the survivor mesh
        self.resume_shard(shard)
        return True

    def rebalance_shard(self, shard: int) -> bool:
        """Rebalance back: re-admit a recovered chip (the full layout)
        and re-upload from host truth. Callers verify the chip first
        (probe + canary), as emqx_node_rebalance does."""
        dt = self.device_table
        if self.mesh is None or not dt.restore_shard(shard):
            return False
        self._aux_gen += 1
        tel = self.telemetry
        if tel.enabled:
            tel.count("shard_rebalances_total")
            tel.set_gauge("shards_lost", len(dt.lost_shards))
        dt.sync()
        return True

    # --- CSR dest-store feed (the device ?SUBSCRIBER mirror) ------------

    def _fanout_row(self, flt: str) -> Optional[int]:
        row = self._filter_row.get(flt)
        if row is None:
            row = self._exact_row.get(flt)
        return row

    def _fanout_added(self, flt: str, dest: Dest) -> None:
        """First-appear route transition -> CSR edge append, in dest
        dict order. Tuple dests (shared groups, cluster composites) are
        stored client-less with the shared bit; str dests start SKIP
        until the broker's fanout_note_opts upgrade arrives."""
        row = self._fanout_row(flt)
        if row is None:
            return  # deep/host-resident filter: resolve falls back
        ds = self.dest_store
        ds.ensure_rows(self.table.capacity)
        if isinstance(dest, str):
            ds.add(row, dest, fanout_ops.SKIP_BIT, flt)
        else:
            ds.add(row, dest, fanout_ops.SHARED_BIT, flt)

    def _fanout_add_batch(self, pairs_iter) -> None:
        """Storm-path feed: first-appear pairs only MARK their rows
        pending; _fanout_flush rebuilds a pending row from its dest
        dict the first time a resolve needs it."""
        fr = self._filter_row
        xr = self._exact_row
        pending_add = self.dest_store.pending_rows.add
        for flt, _dest in pairs_iter:
            row = fr.get(flt)
            if row is None:
                row = xr.get(flt)
                if row is None:
                    continue  # deep/host-resident: host walk covers
            pending_add(row)

    def _fanout_flush(self, rows) -> None:
        """Rebuild any pending segments among `rows` from their dest
        dicts (dict order == oracle order) through the broker's live
        suboption seam — the lazy half of the storm feed."""
        ds = self.dest_store
        pending = ds.pending_rows
        if not pending:
            return
        lookup = self.fanout_opts_lookup
        rf = self._row_filter
        for row in rows:
            if row in pending:
                flt = rf[row]
                ds.set_row(row, flt, self.filter_dests(flt), lookup)
                pending.discard(row)

    def _fanout_removed(self, flt: str, dest: Dest) -> None:
        row = self._fanout_row(flt)
        if row is not None:
            self.dest_store.remove(row, dest)

    def fanout_note_opts(self, flt: str, client: str, opts, session) -> None:
        """Complete a subscribe on the CSR store: stamp the edge with
        its live suboption word/object and track the session object for
        the vectorized plan build. No-op for host-resident filters and
        for routes the broker never subscribed (node dests)."""
        row = self._fanout_row(flt)
        if row is not None:
            self.dest_store.set_opts(row, client, opts, session)

    # --- device-resolved fanout (the aggre/1 kernel, K5) ----------------

    def resolve_fanout_begin(self, filters: Sequence[str], min_fan: int = 0):
        """Launch the dedup/max-QoS plan kernel for one matched filter
        set (in pairs order), or None when the set resolves host-side:
        a host-resident filter in the set, a fan below `min_fan` (the
        host walk is cheaper), an empty fan, or a fan beyond the
        kernel's packing cap. Each refusal is an answer, not a fault,
        and is counted. While the breaker is open (`device_suspended`)
        every set resolves host-side until the recovery canary has
        verified the re-uploaded state."""
        if not filters:
            return None
        tel = self.telemetry
        if self.device_suspended:
            if tel.enabled:
                tel.count("fanout_host_fallback_total")
            return None
        if self._quarantined:
            # a quarantined filter's dest segment is suspect: the whole
            # set resolves host-side until the clean sync clears it
            for f in filters:
                if f in self._quarantined:
                    if tel.enabled:
                        tel.count("fanout_host_fallback_total")
                        tel.count("audit_quarantine_resolve_refusals_total")
                    return None
        rows = []
        for f in filters:
            row = self._fanout_row(f)
            if row is None:
                if tel.enabled:
                    tel.count("fanout_host_fallback_total")
                return None
            rows.append(row)
        # rebuild pending storm rows BEFORE the sync inside resolve_begin
        self._fanout_flush(rows)
        fan = self.dest_store.fan_of(rows)
        if fan < max(min_fan, 1):
            if tel.enabled:
                tel.count("fanout_small_fan_total")
            return None
        if fan > fanout_ops.MAX_FAN:
            if tel.enabled:
                tel.count("fanout_over_cap_total")
            return None
        fi = self.fault_injector
        if fi is not None:
            fi.check("fanout_begin")
        return self.device_table.fanout.resolve_begin(rows, fan)

    def resolve_fanout_finish(self, handle):
        """Finish a begun resolve: fetch the winner edges, record the
        dedup ratio, and materialize the oracle-ordered (mem, other)
        plan — identical to Broker._build_fanout_plan over the same
        host state."""
        fi = self.fault_injector
        if fi is not None:
            fi.check("fanout_finish")
        win, fan = self.device_table.fanout.resolve_finish(handle)
        tel = self.telemetry
        if tel.enabled:
            tel.count("fanout_device_plans_total")
            tel.set_gauge(
                "fanout_dedup_ratio", round(fan / max(1, len(win)), 6)
            )
        return self.dest_store.build_plan(win)

    def set_transfer_chunk(self, chunk_kb: float) -> None:
        """Bound per-dispatch compacted-result buffers to a transfer
        chunk (KB) sized to the link (ops/transfer.chunk_hits); 0
        lifts the bound."""
        self.device_table.transfer_chunk_hits = transfer_ops.chunk_hits(
            chunk_kb
        )

    # --- write path (emqx_router:do_add_route / do_delete_route) -------

    def _ensure_row_filter(self) -> None:
        """Keep the row->filter list sized to the table capacity."""
        rf = self._row_filter
        cap = self.table.capacity
        if len(rf) < cap:
            rf.extend([None] * (cap - len(rf)))

    def _reserve_native(self, n: int) -> None:
        """Pre-grow every structure up to `n` fresh rows could touch —
        table free rows, vocab refcount array, row->filter list, class
        index — so the C core can hold raw buffers for the whole call
        (no growth mid-call), then rebuild the churn handle over the
        (possibly replaced) arrays. Growth points move at most one
        reserve chunk earlier than the twin's; final sizes are
        identical (pow2)."""
        t = self.table
        while len(t._free) < n:
            t._grow()
        v = t.vocab
        v.ensure_refs(v._next + n * (t.max_levels + 1))
        self._ensure_row_filter()
        if self.index is not None:
            self.index.reserve(n, t.capacity)
        self._native_headroom = n
        self._churn_handle = self._sp.make_churn_handle(self)
        self._trie_gc()  # amortized backlog bound for single-row adds

    def _handle(self):
        """The churn-core capsule; built on demand (deletes need no
        reserve — they only append to the free lists)."""
        h = self._churn_handle
        if h is None:
            h = self._churn_handle = self._sp.make_churn_handle(self)
        return h

    def _drop_native_state(self) -> None:
        """Twin mutations bypass the headroom accounting and may replace
        arrays the handle pins — drop both."""
        self._native_headroom = 0
        self._churn_handle = None

    def add_route(self, flt: str, dest: Dest) -> None:
        core = self._add_core
        if core is not None:
            # allocation-free single-pair C entry (the broker's
            # per-subscribe hot path), with ZERO per-call setup: the
            # reserve pre-pass runs once per _churn_reserve adds and
            # the churn handle carries the C side's whole
            # attribute/buffer fetch between calls; the generation
            # bump and the dest-store pending mark happen IN the core.
            # Flags: 1 fresh, 2 need_rebuild, 8 deep changed.
            if self._native_headroom < 1:
                self._reserve_native(self._churn_reserve)
            self._native_headroom -= 1
            flags = core(self._churn_handle, flt, dest)
            if flags & 8:
                self._aux_gen += 1
            if flags & 2:
                self.index._rebuild(self.index.n_buckets * 2)
                self._churn_handle = self._sp.make_churn_handle(self)
            return
        self._drop_native_state()
        if not topic_mod.is_wildcard(flt):
            fresh_topic = flt not in self._exact
            dests = self._exact.setdefault(flt, {})
            fresh = dest not in dests
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
            if fresh:
                self._fanout_added(flt, dest)
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
        fresh = dest not in dests
        dests[dest] = dests.get(dest, 0) + 1
        if fresh:
            self._fanout_added(flt, dest)

    def add_routes(self, pairs: Sequence[Tuple[str, Dest]]) -> None:
        """Batched add_route — the router-syncer write path. Dest/dict
        bookkeeping stays per-pair, but NEW filters go through the
        vectorized table scatter + class-index bulk placement, which is
        what subscribe storms hit. Each filter is split once and its
        parts ride into add_bulk."""
        sp = self._sp
        if sp is not None:
            # native one-pass path: reserve headroom for the batch (a
            # no-op when a prior reserve already covers it — the C core
            # holds raw buffer pointers, so nothing may grow mid-call),
            # then hand the whole batch to add_routes_core. Generation
            # bumps and dest-store pending marks happen in the core; the
            # aux generation (host-only deep stores) stays a len-delta
            B = len(pairs)
            if self._native_headroom < B:
                self._reserve_native(max(B, self._churn_reserve))
            self._native_headroom -= B
            deep0 = len(self._deep) + len(self._exact_deep)
            _fresh, need_rebuild = sp.add_routes_core(
                self._churn_handle,
                pairs if isinstance(pairs, list) else list(pairs),
            )
            if len(self._deep) + len(self._exact_deep) != deep0:
                self._aux_gen += 1
            if need_rebuild:
                self.index._rebuild(self.index.n_buckets * 2)
                self._churn_handle = sp.make_churn_handle(self)
            return
        self._drop_native_state()
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
        # dest bookkeeping per pair (duplicates in the batch included);
        # first-appear pairs mark their dest-store rows pending
        fresh_pairs: List[Tuple[str, Dest]] = []
        for (flt, dest), wild in zip(pairs, wildness):
            if not wild:
                dests = exact_t[flt]
            else:
                dests = wild_t.get(flt)
                if dests is None:
                    dests = deep_t[flt]
            v = dests.get(dest)
            if v is None:
                dests[dest] = 1
                fresh_pairs.append((flt, dest))
            else:
                dests[dest] = v + 1
        if fresh_pairs:
            self._fanout_add_batch(fresh_pairs)

    def delete_routes(self, pairs: Sequence[Tuple[str, Dest]]) -> None:
        """Batched delete_route (the syncer's delete leg). With the
        native core this is ONE C pass over the pairs: dest refcounts,
        index un-indexing, table tombstones and deferred host-trie
        removals all land in C; generation bumps and surviving-filter
        pending marks happen in the core, and the vanished rows'
        dest-store segments free in one vectorized pass here."""
        sp = self._sp
        if sp is None:
            self._drop_native_state()
            for flt, dest in pairs:
                self._delete_route_py(flt, dest)
            return
        deep0 = len(self._deep) + len(self._exact_deep)
        _vanished, removed_rows = sp.del_routes_core(
            self._handle(),
            pairs if isinstance(pairs, list) else list(pairs),
        )
        if len(self._deep) + len(self._exact_deep) != deep0:
            self._aux_gen += 1
        if removed_rows:
            self.dest_store.free_rows(removed_rows)
            self._trie_gc()

    def _trie_gc(self) -> None:
        """Bound the deferred host-trie op list: a write-only workload
        (pure storms, purge cycles with no host-path reads in between)
        never drains it, so when the replay backlog outweighs the live
        filter set, DROP it and mark the trie stale — the next host
        read rebuilds from live state (_host_trie), which subsumes
        every dropped op by construction."""
        pf = self._trie_pending_f
        if self._trie_stale:
            if pf:
                # still stale (no read since): keep memory flat
                pf.clear()
                self._trie_pending_r.clear()
            return
        if len(pf) > 4 * len(self._filter_row) + 1024:
            self._trie_stale = True
            pf.clear()
            self._trie_pending_r.clear()

    def delete_route(self, flt: str, dest: Dest) -> None:
        core = self._del_core
        if core is not None:
            # allocation-free single-pair delete (unsubscribe hot path;
            # deletes need no reserve pre-pass; the generation bump and
            # surviving-filter pending mark happen IN the core). Packed
            # flags: 1 vanished, 2 row freed (id in bits 8+), 8 deep
            # changed.
            flags = core(self._handle(), flt, dest)
            if flags & 8:
                self._aux_gen += 1
            if flags & 2:
                self.dest_store.free_row(flags >> 8)
                tick = self._trie_gc_tick + 1
                if tick >= 1024:
                    self._trie_gc_tick = 0
                    self._trie_gc()
                else:
                    self._trie_gc_tick = tick
            return
        self._drop_native_state()
        self._delete_route_py(flt, dest)

    def _delete_route_py(self, flt: str, dest: Dest) -> None:
        """The twin's delete leg (the oracle the C core is held
        against)."""
        if not topic_mod.is_wildcard(flt):
            dests = self._exact.get(flt)
            if not dests or dest not in dests:
                return
            dests[dest] -= 1
            if dests[dest] == 0:
                del dests[dest]
                self._fanout_removed(flt, dest)
                if not dests:
                    del self._exact[flt]
                    row = self._exact_row.pop(flt, None)
                    if row is not None:
                        self.dest_store.free_row(row)
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
        self._fanout_removed(flt, dest)
        if not dests:
            if deep:
                del self._deep[flt]
                self._deep_trie.remove(topic_mod.words(flt), flt)
                self._aux_gen += 1
            else:
                del self._wild[flt]
                row = self._filter_row.pop(flt)
                self.dest_store.free_row(row)
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
        strings (bulk add, the churn core). The churn core's delete legs
        defer their trie removals into the same ordered list with the
        row encoded as -(row+1), so interleaved add/delete storms replay
        in arrival order."""
        if self._trie_stale:
            # the op backlog was dropped mid-storm (_trie_gc): rebuild
            # from live state, which reflects every mutation up to NOW
            # — any ops still pending are subsumed, so they drop too
            t = TopicTrie()
            ins = t.insert
            words = self.table.filter_words
            for _flt, row in self._filter_row.items():
                ins(words(row), row)
            self._trie = t
            self._trie_pending_f.clear()
            self._trie_pending_r.clear()
            self._trie_stale = False
            return t
        pf = self._trie_pending_f
        if pf:
            trie = self._trie
            ins = trie.insert
            rem = trie.remove
            for ws, row in zip(pf, self._trie_pending_r):
                w = tuple(ws.split("/")) if type(ws) is str else ws
                if row >= 0:
                    ins(w, row)
                else:
                    rem(w, -row - 1)
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

    def match_pairs(self, topic: str) -> List[Tuple[str, Dict[Dest, int]]]:
        """(filter, dests) pairs for one topic — the broker's
        single-publish path dispatches on the filter for the direct
        suboption lookup instead of re-matching."""
        return [(f, self.filter_dests(f)) for f in self.match_filters(topic)]

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
        fi = self.fault_injector
        if fi is not None:
            fi.check("match_begin")
        tel.count("dispatch_batches_total")
        root = tel.span("device.match_batch")
        if root is not None:
            root.set("batch", len(sub))
        p.root = root
        self.device_table.sync()
        if self._quarantined:
            self._maybe_unquarantine()
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
        elif p.mode != "cached":
            fi = self.fault_injector
            if fi is not None:
                fi.check("match_finish")
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
            # (host mode already folded deep matches via match_filters
            # and needs no quarantine overlay: it IS host truth)
            if self._deep:
                for i, t in enumerate(topics):
                    out[i].extend(self._deep_trie.match(topic_mod.words(t)))
            if self._quarantined and out:
                self._quarantine_overlay(topics, out)
            if self._suspended_shards and out:
                self._shard_overlay(topics, out)
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
        mesh = self.mesh is not None
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
            if mesh:
                # the first escalation step (2x capacity) per batch shape
                warmed += dt.warmup_escalated(enc)
            warmed += 1
            b *= 2
        if mesh:
            # the churn syncs' row / slot / fused scatters
            warmed += dt.warmup_deltas()
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
