"""Device-resolved fanout: CSR destination store + dedup/max-QoS kernel
(counterpart of emqx_tpu/ops/fanout.py, single device).

The match path says which filters a topic hits; this module says who
receives it — the ?SUBSCRIBER bag read + `aggre/1` dedup of
emqx_broker.erl:408-424, 726-760. The destination fan lives on the card
as a CSR table parallel to the filter table:

  seg_off     int32 [C]   first edge of filter-row r's segment
  seg_len     int32 [C]   edges in the segment (tombstones included)
  edge_client int32 [E]   dense client-registry row; -1 = tombstone or
                          shared-group leg (never in the direct plan)
  edge_opts   int32 [E]   packed subopts word: qos(0-1) nl(2) rap(3)
                          rh(4-5) shared-group(6) skip(7)

Segments hold dests in *insertion order* — the Router's per-filter
dest dict order — so the plan kernel reproduces
`Broker._build_fanout_plan` exactly: same dedup winner (max granted
QoS, first-seen wins ties), same plan order (first occurrence of each
client across the matched filters).

Kernels, each a plain PyTorch version beside a CUDA wrapper (CPU
tensors take the plain version; CUDA tensors launch the kernel, with no
fallback):

  K5 `resolve_fanout` (csrc/fanout.cu) — the dedup/max-QoS plan;
  K6 `_scatter_segs` and K7 `_scatter_edges`, fused: `fanout_sync`
     (csrc/scatter.cu, one kernel registered once) — the delta sync of
     the segment and edge arrays in one launch; `scatter_segs` and
     `scatter_edges` launch it with one side empty at the reference's
     [n_b, K] batches.

Coherence follows ops/table.py discipline: host arrays are the source
of truth, mutations append dirty row/edge ids, the device mirror drains
them (sorted, distinct) into one staged buffer with no padding, moved
in one copy and applied by one launch, and only pool growth
re-uploads.
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve, to_device
from ..obs.kernel_telemetry import NULL as _NULL_TEL
from ..parallel.mesh import primary_device
from . import transfer as transfer_ops
from ._build import LL, I, P, CudaKernel, raw_stream
from .match import check_tensor
from .table import next_pow2

# packed subopts word layout
QOS_MASK = 0x3
NL_BIT = 1 << 2
RAP_BIT = 1 << 3
RH_SHIFT = 4
SHARED_BIT = 1 << 6  # shared-group leg: host group election owns it
SKIP_BIT = 1 << 7  # dest without a known suboption (node ids, etc.)

# fan cap per resolve: the winner key packs (qos << 24 | 2^24-1 - pos),
# so a single plan may gather at most 2^24 edges; resolve_fanout_begin
# refuses larger fans (host walk — they do not occur in practice)
MAX_FAN = 1 << 22

# the reference's rows/edges per scatter batch (router-syncer batch): the
# sync's telemetry shape buckets and scatter_segs/scatter_edges' [n_b, K]
SYNC_BATCH = 1024

_POS_MASK = (1 << 24) - 1


def fan_bucket(n: int) -> int:
    """Smallest of {2^k, 3*2^(k-1)} >= n: two launch-shape buckets per
    octave instead of one. The resolve kernel's work is linear in
    max_fan, so the tighter ladder saves up to 25% per launch."""
    p = next_pow2(n)
    if n <= 3 * (p // 4):
        return 3 * (p // 4)
    return p


def pack_subopts(opts, shared: bool = False) -> int:
    """SubOpts -> packed word (the ?SUBOPTION compression)."""
    w = (
        (opts.qos & QOS_MASK)
        | (NL_BIT if opts.no_local else 0)
        | (RAP_BIT if opts.retain_as_published else 0)
        | ((opts.retain_handling & 0x3) << RH_SHIFT)
    )
    if shared:
        w |= SHARED_BIT
    return w


# --- K6/K7: the fused delta sync ---------------------------------------------


def scatter_cols_ref(
    a: torch.Tensor,  # int32 [N], updated in place
    b: torch.Tensor,  # int32 [N], updated in place
    idx: torch.Tensor,  # int32 ids, any shape
    va: torch.Tensor,  # int32, idx's shape
    vb: torch.Tensor,  # int32, idx's shape
) -> None:
    """One side of the sync's plain version: a[idx] = va, b[idx] = vb
    in the reference's scan order (row-major over [n_b, K] batches); ids
    outside [0, N) are dropped, as JAX drops out-of-range scatter
    updates."""
    i = idx.reshape(-1).to(torch.int64)
    keep = (i >= 0) & (i < a.shape[0])
    a[i[keep]] = va.reshape(-1)[keep]
    b[i[keep]] = vb.reshape(-1)[keep]


def fanout_sync_ref(seg_off, seg_len, edge_client, edge_opts, staged, n_r, n_e) -> None:
    """Plain version of the fused K6/K7 sync: `staged` int32 [3 * (n_r +
    n_e)] laid out [ridx | roff | rlen | eidx | ecl | eop]; the rows'
    ids and values go to seg_off/seg_len, the edges' to edge_client/
    edge_opts, in place."""
    rows = staged[: 3 * n_r].view(3, n_r)
    edges = staged[3 * n_r :].view(3, n_e)
    scatter_cols_ref(seg_off, seg_len, *rows)
    scatter_cols_ref(edge_client, edge_opts, *edges)


_FANOUT_SYNC = CudaKernel(
    "fanout_sync", "scatter.cu", "emqx_fanout_sync",
    [P, P, I, P, P, I, P, P, P, LL, P, P, P, LL, P],
)


def _side(name, a, b, d):
    """(a, b, len) of one side's tables for the launch, each checked."""
    n = a.shape[0]
    check_tensor(f"{name}[0]", a, torch.int32, (n,), d)
    check_tensor(f"{name}[1]", b, torch.int32, (n,), d)
    return a.data_ptr(), b.data_ptr(), n


def stage_delta(rows, edges, seg_off, seg_len, edge_client, edge_opts, device):
    """One int32 buffer [rows | seg_off[rows] | seg_len[rows] | edges |
    edge_client[edges] | edge_opts[edges]] on `device`, packed on the
    host and moved in one copy, with no padding: the `staged` argument
    of fanout_sync."""
    n_r, n_e = len(rows), len(edges)
    buf = np.empty(3 * (n_r + n_e), np.int32)
    r = buf[: 3 * n_r].reshape(3, n_r)
    e = buf[3 * n_r :].reshape(3, n_e)
    r[0] = rows
    np.take(seg_off, rows, out=r[1])
    np.take(seg_len, rows, out=r[2])
    e[0] = edges
    np.take(edge_client, edges, out=e[1])
    np.take(edge_opts, edges, out=e[2])
    return to_device(buf, device)


def fanout_sync(seg_off, seg_len, edge_client, edge_opts, staged, n_r: int, n_e: int) -> None:
    """A fanout mirror's delta sync in place (the reference's
    `_scatter_segs` then `_scatter_edges`), from one staged buffer
    (`stage_delta`'s layout, no padding). CUDA tensors launch the fused
    K6/K7 kernel once, or not at all when both sides are empty; CPU
    tensors take the plain version."""
    if n_r < 0 or n_e < 0:
        raise ValueError(f"fanout_sync: negative entry counts ({n_r}, {n_e})")
    d = seg_off.device
    if d.type == "cpu":
        fanout_sync_ref(seg_off, seg_len, edge_client, edge_opts, staged, n_r, n_e)
        return
    rows = _side("segs", seg_off, seg_len, d)
    edges = _side("edges", edge_client, edge_opts, d)
    check_tensor("staged", staged, torch.int32, (3 * (n_r + n_e),), d)
    if n_r + n_e == 0:
        return
    p = staged.data_ptr()
    e = p + 12 * n_r
    _FANOUT_SYNC(
        *rows, *edges, p, p + 4 * n_r, p + 8 * n_r, n_r,
        e, e + 4 * n_e, e + 8 * n_e, n_e, raw_stream(d),
    )


def _scatter_side(a, b, idx, va, vb, segs: bool) -> None:
    """One side of the fused kernel at the reference's [n_b, K] batches,
    the other side empty."""
    d = a.device
    if d.type == "cpu":
        scatter_cols_ref(a, b, idx, va, vb)
        return
    side = _side("segs" if segs else "edges", a, b, d)
    shape = tuple(idx.shape)
    check_tensor("idx", idx, torch.int32, shape, d)
    check_tensor("va", va, torch.int32, shape, d)
    check_tensor("vb", vb, torch.int32, shape, d)
    n = idx.numel()
    if n == 0:
        return
    cols = (idx.data_ptr(), va.data_ptr(), vb.data_ptr(), n)
    none = (0, 0, 0, 0)
    if segs:
        _FANOUT_SYNC(*side, 0, 0, 0, *cols, *none, raw_stream(d))
    else:
        _FANOUT_SYNC(0, 0, 0, *side, *none, *cols, raw_stream(d))


def scatter_segs(seg_off, seg_len, idx, off, ln) -> None:
    """In-place batched write of the per-row segment arrays at the
    reference `_scatter_segs`'s [n_b, K] batches: the fused K6/K7
    kernel with no edges (CUDA), or its plain version (CPU)."""
    _scatter_side(seg_off, seg_len, idx, off, ln, segs=True)


def scatter_edges(edge_client, edge_opts, idx, cl, op) -> None:
    """In-place batched write of the edge arrays at the reference
    `_scatter_edges`'s [n_b, K] batches: the fused K6/K7 kernel with no
    rows (CUDA), or its plain version (CPU)."""
    _scatter_side(edge_client, edge_opts, idx, cl, op, segs=False)


# --- K5: the dedup/max-QoS plan kernel ---------------------------------------

# K5's persistent keys are 64 bits, tagged with the call's epoch
# (csrc/fanout.cu): epochs run 1..EPOCH_LIMIT, so every key stays below
# 2^63 and an int64 tensor holds the kernel's unsigned keys bit for bit
EPOCH_LIMIT = (1 << 31) - 1
FIRST_EMPTY = (1 << 63) - 1  # a cleared first-position entry: above any key


class FanoutScratch:
    """K5's winner and first-position keys of each client (`keys` int64
    [capacity, 2]: tw, tf), kept across calls so that no call sweeps the
    client registry. Each call takes the next epoch; keys of older
    epochs lose every race, so the keys are cleared only when fresh and
    after the last epoch. Calls that share one scratch must run in order
    (one stream)."""

    def __init__(self, capacity: int, device: torch.device) -> None:
        self.capacity = capacity
        self.keys = torch.empty((capacity, 2), dtype=torch.int64, device=device)
        self.epoch = 0  # the last call's epoch; 0: the keys need a clear

    def next_epoch(self) -> Tuple[int, bool]:
        """(this call's epoch, whether the keys are cleared first);
        committed by `self.epoch = epoch` once the call has launched."""
        if self.epoch == 0 or self.epoch >= EPOCH_LIMIT:
            return 1, True
        return self.epoch + 1, False


def _check_scratch(scratch: FanoutScratch, n_clients: int, dev: torch.device) -> None:
    if n_clients > scratch.capacity:
        raise ValueError(
            f"resolve_fanout: n_clients={n_clients} exceeds the scratch's "
            f"{scratch.capacity} client rows"
        )
    check_tensor("scratch.keys", scratch.keys, torch.int64, (scratch.capacity, 2), dev)


def resolve_fanout_ref(
    seg_off: torch.Tensor,  # int32 [C]
    seg_len: torch.Tensor,  # int32 [C]
    edge_client: torch.Tensor,  # int32 [E]
    edge_opts: torch.Tensor,  # int32 [E]
    rows: torch.Tensor,  # int32 [M] matched filter rows, -1 padded
    n_clients: int,
    max_fan: int,
    scratch: Optional[FanoutScratch] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K5, step for step the kernel's launches on the
    same epoch-tagged keys (a fresh scratch when none is given).
    Returns (slots int32 [max_fan], n_winners int32 [], total int32
    []): slots[p] is the winning global edge index for the client whose
    first occurrence in the gathered fan was position p, or -1 — the
    reference program's outputs."""
    m = rows.shape[0]
    dev = rows.device
    i32, i64 = torch.int32, torch.int64
    if scratch is None:
        scratch = FanoutScratch(n_clients, dev)
    _check_scratch(scratch, n_clients, dev)
    epoch, clear = scratch.next_epoch()
    keys = scratch.keys.view(-1)  # tw of client c at 2c, tf at 2c + 1
    if clear:
        scratch.keys[:, 0] = 0
        scratch.keys[:, 1] = FIRST_EMPTY
    # the gather: masked lengths and starts of the matched rows, their scan
    valid_row = rows >= 0
    rr = torch.where(valid_row, rows.clamp(max=seg_off.shape[0] - 1), 0).long()
    lens = torch.where(valid_row, seg_len[rr], 0)
    start = seg_off[rr]
    incl = torch.cumsum(lens, 0, dtype=i32)
    total = incl[-1]
    e = torch.arange(max_fan, dtype=i32, device=dev)
    fi = torch.searchsorted(incl, e, right=True).clamp(max=m - 1)
    prev = torch.where(fi > 0, incl[(fi - 1).clamp(min=0)], 0)
    src = torch.where(
        e < torch.clamp(total, max=max_fan), start[fi] + (e - prev), 0
    ).to(i32)
    s = src.clamp(0, edge_client.shape[0] - 1).long()
    cl = edge_client[s]
    op = edge_opts[s]
    # tombstones and shared legs carry client -1; skip-bit edges have a
    # client row but no suboption (the oracle's subopts.get miss)
    ok = (e < total) & (cl >= 0) & (cl < n_clients) & ((op & SKIP_BIT) == 0)
    cl_at = torch.where(ok, cl, -1)
    first_key = ((EPOCH_LIMIT - epoch) << 32) | e.to(i64)
    win_key = (epoch << 32) | (((op & QOS_MASK) << 24) | (_POS_MASK - e)).to(i64)
    idx = 2 * cl_at[ok].long()
    keys.scatter_reduce_(0, idx, win_key[ok], "amax")
    keys.scatter_reduce_(0, idx + 1, first_key[ok], "amin")
    # the winner pass: a position is its client's first occurrence when
    # its own key won the first-position race
    c = 2 * cl_at.clamp(min=0).long()
    first = (cl_at >= 0) & (keys[c + 1] == first_key)
    p_win = _POS_MASK - (keys[c] & _POS_MASK)
    out = torch.where(first, src[p_win.clamp(0, max_fan - 1)], -1).to(i32)
    scratch.epoch = epoch
    return out, first.sum(dtype=i32), total


_RESOLVE_FANOUT = CudaKernel(
    "resolve_fanout", "fanout.cu", "emqx_resolve_fanout",
    [P, P, I, P, P, I, P, I, I, I, P, P, P, P, LL, P, I, I, I, P],
)


def resolve_fanout(
    seg_off, seg_len, edge_client, edge_opts, rows,
    n_clients: int, max_fan: int, scratch: Optional[FanoutScratch] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dedup/max-QoS plan (replaces the jitted `resolve_fanout` of
    the reference). CUDA tensors launch kernel K5; CPU tensors take the
    plain version. Same outputs as resolve_fanout_ref. `scratch` holds
    the winner keys across calls (FanoutDeviceState passes its own);
    without one, a fresh scratch is made and cleared for this call."""
    d = seg_off.device
    if d.type == "cpu":
        return resolve_fanout_ref(
            seg_off, seg_len, edge_client, edge_opts, rows, n_clients, max_fan,
            scratch,
        )
    c = seg_off.shape[0]
    e = edge_client.shape[0]
    m = rows.shape[0]
    if m < 1 or n_clients < 1 or not 1 <= max_fan <= MAX_FAN:
        raise ValueError(
            f"resolve_fanout: bad shape (M={m}, n_clients={n_clients}, "
            f"max_fan={max_fan})"
        )
    check_tensor("seg_off", seg_off, torch.int32, (c,), d)
    check_tensor("seg_len", seg_len, torch.int32, (c,), d)
    check_tensor("edge_client", edge_client, torch.int32, (e,), d)
    check_tensor("edge_opts", edge_opts, torch.int32, (e,), d)
    check_tensor("rows", rows, torch.int32, (m,), d)
    if scratch is None:
        scratch = FanoutScratch(n_clients, d)
    _check_scratch(scratch, n_clients, d)
    epoch, clear = scratch.next_epoch()
    i32 = torch.int32
    out = torch.empty(max_fan, dtype=i32, device=d)
    n_win = torch.empty((), dtype=i32, device=d)
    total = torch.empty((), dtype=i32, device=d)
    # per call: the rows' inclusive scan and starts [M], the gathered
    # sources and the lanes' clients [max_fan]
    work = torch.empty(2 * m + 2 * max_fan, dtype=i32, device=d)
    _RESOLVE_FANOUT(
        seg_off.data_ptr(), seg_len.data_ptr(), c,
        edge_client.data_ptr(), edge_opts.data_ptr(), e,
        rows.data_ptr(), m, n_clients, max_fan,
        out.data_ptr(), n_win.data_ptr(), total.data_ptr(),
        work.data_ptr(), work.numel(), scratch.keys.data_ptr(),
        scratch.capacity, epoch, int(clear), raw_stream(d),
    )
    scratch.epoch = epoch
    return out, n_win, total


class DestStore:
    """Host source of truth for the CSR destination table.

    One segment per live filter row, allocated from a flat edge pool by
    pow2 size class (free lists + bump pointer; pool capacity doubles
    like FilterTable rows). Removal tombstones in place so surviving
    dests keep their insertion order — the Router dest-dict order the
    oracle iterates — and segments compact when tombstones dominate.

    A dense client registry (client_id -> int row, plus object arrays
    of names / live session objects / mem-session flags) backs the
    kernel's scatter tables AND the vectorized plan materialization:
    `build_plan` turns winner edges into the oracle's (mem, other)
    lists with numpy fancy-indexing instead of a per-entry dict walk.
    """

    MIN_SEG = 4

    def __init__(
        self,
        edge_capacity: int = 1024,
        row_capacity: int = 1024,
        client_capacity: int = 1024,
    ) -> None:
        self.edge_capacity = edge_capacity
        self.row_capacity = row_capacity
        self.seg_off = np.zeros(row_capacity, np.int32)
        self.seg_len = np.zeros(row_capacity, np.int32)
        self.seg_cap = np.zeros(row_capacity, np.int32)
        self.seg_live = np.zeros(row_capacity, np.int32)
        self.edge_client = np.full(edge_capacity, -1, np.int32)
        self.edge_opts = np.zeros(edge_capacity, np.int32)
        # host-only parallels for plan materialization
        self.edge_dest: List[Optional[Hashable]] = [None] * edge_capacity
        self.edge_flt: List[Optional[str]] = [None] * edge_capacity
        self.edge_opts_obj = np.empty(edge_capacity, object)
        # per-row dest -> slot-within-segment (absolute = off + slot)
        self._slots: List[Optional[Dict]] = [None] * row_capacity
        self._free_segs: Dict[int, List[int]] = {}
        self._end = 0  # bump pointer into the edge pool
        # client registry (rows are never recycled; sessions detach by
        # nulling the object, mirroring broker.sessions.get(c) is None)
        self.client_capacity = client_capacity
        self.client_row: Dict[str, int] = {}
        self.client_name = np.empty(client_capacity, object)
        self.client_sess = np.empty(client_capacity, object)
        self.client_mem = np.zeros(client_capacity, bool)
        # alive kept as a parallel BOOL array: build_plan's liveness
        # test is then a pure bool gather instead of an elementwise
        # object != None scan
        self.client_alive = np.zeros(client_capacity, bool)
        # the session class eligible for the broker's shared-packet
        # QoS0 fast loop (the oracle's `session.__class__ is Session`
        # partition)
        from ..broker.session import Session as _mem

        self.mem_class: Optional[type] = _mem
        # sync state (drained by FanoutDeviceState)
        self.dirty_rows: List[int] = []
        self.dirty_edges: List[int] = []
        self.grew = True  # first sync is a full upload
        # rows whose segments are STALE pending a rebuild from the
        # router's dest dict. The storm path (add_routes) only marks
        # rows here instead of paying eager segment bookkeeping per
        # route; Router._fanout_flush rebuilds a pending row, in dict order,
        # the first time a resolve actually needs it. Eager single-route
        # ops skip rows parked here (the rebuild supersedes them).
        self.pending_rows: set = set()

    # --- client registry --------------------------------------------------

    def _client(self, cid: str) -> int:
        row = self.client_row.get(cid)
        if row is None:
            row = len(self.client_row)
            if row >= self.client_capacity:
                new = self.client_capacity * 2
                self.client_name = np.concatenate(
                    [self.client_name, np.empty(self.client_capacity, object)]
                )
                self.client_sess = np.concatenate(
                    [self.client_sess, np.empty(self.client_capacity, object)]
                )
                self.client_mem = np.concatenate(
                    [self.client_mem, np.zeros(self.client_capacity, bool)]
                )
                self.client_alive = np.concatenate(
                    [self.client_alive, np.zeros(self.client_capacity, bool)]
                )
                self.client_capacity = new
            self.client_row[cid] = row
            self.client_name[row] = cid
        return row

    def note_session(self, cid: str, session) -> None:
        """Track the live session object (or None on close) for a
        registered client — the vectorized `sessions.get` of
        build_plan. Unregistered clients (no edges yet) are skipped;
        their session arrives with the first note_opts."""
        row = self.client_row.get(cid)
        if row is not None:
            self.client_sess[row] = session
            self.client_alive[row] = session is not None
            self.client_mem[row] = (
                session is not None and session.__class__ is self.mem_class
            )

    # --- segment allocation ----------------------------------------------

    def ensure_rows(self, cap: int) -> None:
        cap = next_pow2(cap)
        if cap <= self.row_capacity:
            return
        old = self.row_capacity
        grow = cap - old
        self.seg_off = np.concatenate([self.seg_off, np.zeros(grow, np.int32)])
        self.seg_len = np.concatenate([self.seg_len, np.zeros(grow, np.int32)])
        self.seg_cap = np.concatenate([self.seg_cap, np.zeros(grow, np.int32)])
        self.seg_live = np.concatenate(
            [self.seg_live, np.zeros(grow, np.int32)]
        )
        self._slots.extend([None] * grow)
        self.row_capacity = cap
        self.grew = True

    def _grow_edges(self, need: int) -> None:
        new = self.edge_capacity
        while new < need:
            new *= 2
        grow = new - self.edge_capacity
        self.edge_client = np.concatenate(
            [self.edge_client, np.full(grow, -1, np.int32)]
        )
        self.edge_opts = np.concatenate(
            [self.edge_opts, np.zeros(grow, np.int32)]
        )
        self.edge_dest.extend([None] * grow)
        self.edge_flt.extend([None] * grow)
        self.edge_opts_obj = np.concatenate(
            [self.edge_opts_obj, np.empty(grow, object)]
        )
        self.edge_capacity = new
        self.grew = True

    def _alloc(self, cap: int) -> Tuple[int, int]:
        """Carve a pow2-capacity block from the edge pool; (off, cap)."""
        cap = next_pow2(max(cap, self.MIN_SEG))
        cls = cap.bit_length() - 1
        free = self._free_segs.get(cls)
        if free:
            return free.pop(), cap
        off = self._end
        if off + cap > self.edge_capacity:
            self._grow_edges(off + cap)
        self._end = off + cap
        return off, cap

    def _free_seg(self, off: int, cap: int) -> None:
        if cap:
            self._free_segs.setdefault(cap.bit_length() - 1, []).append(off)

    def _write_edge(
        self, idx: int, client: int, word: int, dest, flt, opts_obj
    ) -> None:
        self.edge_client[idx] = client
        self.edge_opts[idx] = word
        self.edge_dest[idx] = dest
        self.edge_flt[idx] = flt
        self.edge_opts_obj[idx] = opts_obj
        self.dirty_edges.append(idx)

    def _relocate(self, row: int, need: int) -> None:
        """Move row's segment to a block holding `need` edges; insertion
        order (slots) is offset-relative so only the offset changes."""
        old_off = int(self.seg_off[row])
        old_cap = int(self.seg_cap[row])
        ln = int(self.seg_len[row])
        new_off, new_cap = self._alloc(need)
        if ln:
            self.edge_client[new_off : new_off + ln] = self.edge_client[
                old_off : old_off + ln
            ]
            self.edge_opts[new_off : new_off + ln] = self.edge_opts[
                old_off : old_off + ln
            ]
            self.edge_dest[new_off : new_off + ln] = self.edge_dest[
                old_off : old_off + ln
            ]
            self.edge_flt[new_off : new_off + ln] = self.edge_flt[
                old_off : old_off + ln
            ]
            self.edge_opts_obj[new_off : new_off + ln] = self.edge_opts_obj[
                old_off : old_off + ln
            ]
            self.dirty_edges.extend(range(new_off, new_off + ln))
        self._free_seg(old_off, old_cap)
        self.seg_off[row] = new_off
        self.seg_cap[row] = new_cap
        self.dirty_rows.append(row)

    # --- mutation surface (fed by the Router) ----------------------------

    def add(self, row: int, dest: Hashable, word: int, flt: str) -> None:
        """Append one destination to row's segment (first-appear route
        transition, incremental path). Client dests start SKIP until
        note_opts upgrades them; shared-group tuples stay client-less
        forever. Rows parked for a storm rebuild are skipped — the
        rebuild re-derives the whole segment from the dest dict."""
        if row in self.pending_rows:
            return
        self.ensure_rows(row + 1)
        slots = self._slots[row]
        if slots is None:
            slots = self._slots[row] = {}
        if dest in slots:
            return  # refcounted duplicate — dict order unchanged
        ln = int(self.seg_len[row])
        if ln + 1 > int(self.seg_cap[row]):
            self._relocate(row, ln + 1)
        client = self._client(dest) if isinstance(dest, str) else -1
        idx = int(self.seg_off[row]) + ln
        self._write_edge(idx, client, word, dest, flt, None)
        slots[dest] = ln
        self.seg_len[row] = ln + 1
        self.seg_live[row] += 1
        self.dirty_rows.append(row)

    def set_row(self, row: int, flt: str, dests, lookup) -> None:
        """Rebuild one row's segment wholesale from its dest dict (in
        dict order — the oracle's iteration order): the flush half of
        the lazy storm path. `lookup(flt, dest) -> (opts, session) |
        None` is the broker's live-suboption seam; misses store SKIP
        (exactly the oracle's subopts.get miss)."""
        self.ensure_rows(row + 1)
        self._free_seg(int(self.seg_off[row]), int(self.seg_cap[row]))
        n = len(dests)
        slots: Dict = {}
        self._slots[row] = slots
        if n == 0:
            self.seg_off[row] = 0
            self.seg_len[row] = 0
            self.seg_cap[row] = 0
            self.seg_live[row] = 0
            self.dirty_rows.append(row)
            return
        off, cap = self._alloc(n)
        cls: List[int] = []
        words: List[int] = []
        objs: List = []
        reg_rows: List[int] = []
        reg_sess: List = []
        client_of = self._client
        slot = 0
        for dest in dests:
            if isinstance(dest, str):
                c = client_of(dest)
                got = lookup(flt, dest) if lookup is not None else None
                if got is None:
                    words.append(SKIP_BIT)
                    objs.append(None)
                else:
                    opts, sess = got
                    words.append(pack_subopts(opts))
                    objs.append(opts)
                    reg_rows.append(c)
                    reg_sess.append(sess)
                cls.append(c)
            else:
                cls.append(-1)
                words.append(SHARED_BIT)
                objs.append(None)
            slots[dest] = slot
            slot += 1
        end = off + n
        self.edge_client[off:end] = cls
        self.edge_opts[off:end] = words
        self.edge_opts_obj[off:end] = objs
        self.edge_dest[off:end] = list(dests)
        self.edge_flt[off:end] = [flt] * n
        self.dirty_edges.extend(range(off, end))
        self.seg_off[row] = off
        self.seg_len[row] = n
        self.seg_cap[row] = cap
        self.seg_live[row] = n
        self.dirty_rows.append(row)
        if reg_rows:
            ra = np.asarray(reg_rows, np.int64)
            self.client_sess[ra] = reg_sess
            alive = np.asarray([s is not None for s in reg_sess], bool)
            self.client_alive[ra] = alive
            mc = self.mem_class
            self.client_mem[ra] = np.asarray(
                [s is not None and s.__class__ is mc for s in reg_sess],
                bool,
            )

    def set_opts(self, row: int, dest: Hashable, opts, session) -> None:
        """Upgrade an edge with its live suboption (and session): the
        broker's subscribe-side completion of a route add, also covering
        resubscribe-with-new-QoS (no route transition). Rows parked for
        a storm rebuild only take the session note — the rebuild reads
        the live suboption itself."""
        if isinstance(dest, str):
            row_c = self._client(dest)
            self.client_sess[row_c] = session
            self.client_alive[row_c] = session is not None
            self.client_mem[row_c] = (
                session is not None and session.__class__ is self.mem_class
            )
        if row >= self.row_capacity or row in self.pending_rows:
            return
        slots = self._slots[row]
        if slots is None:
            return
        slot = slots.get(dest)
        if slot is None:
            return
        idx = int(self.seg_off[row]) + slot
        self.edge_opts[idx] = pack_subopts(opts)
        self.edge_opts_obj[idx] = opts
        self.dirty_edges.append(idx)

    def remove(self, row: int, dest: Hashable) -> None:
        """Tombstone one destination (last-ref route removal); compacts
        the segment when tombstones dominate. Rows parked for a storm
        rebuild are skipped (the rebuild re-derives the segment)."""
        if row >= self.row_capacity or row in self.pending_rows:
            return
        slots = self._slots[row]
        if slots is None:
            return
        slot = slots.pop(dest, None)
        if slot is None:
            return
        idx = int(self.seg_off[row]) + slot
        self._write_edge(idx, -1, 0, None, None, None)
        self.seg_live[row] -= 1
        live = int(self.seg_live[row])
        if int(self.seg_len[row]) - live > max(live, 32):
            self._compact(row)

    def _compact(self, row: int) -> None:
        """Squeeze tombstones out, preserving insertion order."""
        off = int(self.seg_off[row])
        ln = int(self.seg_len[row])
        w = off
        slots = self._slots[row]
        for r in range(off, off + ln):
            if self.edge_client[r] < 0 and self.edge_dest[r] is None:
                continue
            if r != w:
                self._write_edge(
                    w,
                    int(self.edge_client[r]),
                    int(self.edge_opts[r]),
                    self.edge_dest[r],
                    self.edge_flt[r],
                    self.edge_opts_obj[r],
                )
            slots[self.edge_dest[w]] = w - off
            w += 1
        self.seg_len[row] = w - off
        self.seg_live[row] = w - off
        self.dirty_rows.append(row)

    def free_row(self, row: int) -> None:
        """Release a filter row's segment (the filter left the table);
        the row id is about to be recycled for an unrelated filter. The
        churn core may have marked a row past the store's capacity
        pending; the mark goes with the row."""
        self.pending_rows.discard(row)
        if row >= self.row_capacity:
            return
        self._free_seg(int(self.seg_off[row]), int(self.seg_cap[row]))
        self.seg_off[row] = 0
        self.seg_len[row] = 0
        self.seg_cap[row] = 0
        self.seg_live[row] = 0
        self._slots[row] = None
        self.dirty_rows.append(row)

    def free_rows(self, rows) -> None:
        """Batched free_row — the delete/purge-storm path (the churn
        core's del_routes_core hands the whole vanished-row list at
        once): one vectorized zeroing of the segment arrays instead of
        ~6 numpy scalar writes per row."""
        pend = self.pending_rows
        pend.difference_update(rows)
        cap = self.row_capacity
        live = [r for r in rows if r < cap]
        if not live:
            return
        slots = self._slots
        free_seg = self._free_seg
        so, sc = self.seg_off, self.seg_cap
        for r in live:
            free_seg(int(so[r]), int(sc[r]))
            slots[r] = None
        rr = np.asarray(live, np.int64)
        so[rr] = 0
        self.seg_len[rr] = 0
        sc[rr] = 0
        self.seg_live[rr] = 0
        self.dirty_rows.extend(live)

    # --- resolve-side reads ----------------------------------------------

    def fan_of(self, rows) -> int:
        """Gathered fan (tombstones included — an upper bound, used
        only to size max_fan) for a matched row set."""
        return int(self.seg_len[np.asarray(rows, np.int64)].sum())

    def client_pow2(self) -> int:
        return self.client_capacity

    def build_plan(self, win: np.ndarray) -> Tuple[list, list]:
        """Winner edges (plan order) -> the oracle's (mem, other)
        lists. All gathers are numpy fancy-indexing over the object
        arrays; the only per-entry Python is the final zip."""
        if len(win) == 0:
            return [], []
        crow = self.edge_client[win]
        alive = self.client_alive[crow]
        mem_m = self.client_mem[crow] & alive
        oth_m = alive & ~mem_m
        names = self.client_name
        opts = self.edge_opts_obj
        mrow = crow[mem_m]
        mem = list(
            zip(
                names[mrow].tolist(),
                self.client_sess[mrow].tolist(),
                opts[win[mem_m]].tolist(),
            )
        )
        if not oth_m.any():
            return mem, []
        oth_win = win[oth_m]
        other = list(
            zip(
                names[crow[oth_m]].tolist(),
                [self.edge_flt[i] for i in oth_win.tolist()],
                opts[oth_win].tolist(),
            )
        )
        return mem, other

    def stats(self) -> Dict[str, int]:
        return {
            "edge_capacity": self.edge_capacity,
            "edges_live": int(self.seg_live.sum()),
            "edges_used": int(self.seg_len.sum()),
            "clients": len(self.client_row),
            "pending_dirty": len(self.dirty_rows) + len(self.dirty_edges),
        }


class FanoutDeviceState:
    """Device mirror of a DestStore, behind the same sync()/begin/
    finish discipline as the match tables: full upload on pool growth,
    otherwise the dirty rows and edges staged in one unpadded buffer, one
    copy, and applied in place by one launch (K6/K7 fused), and the plan
    kernel (K5) launched in begin() with its device->host copy started
    at once, so the pipelined dispatch overlaps the resolve with the
    match fetch; K5's winner keys (FanoutScratch) persist across
    resolves and grow with the client registry. With `mesh` it serves a
    ShardedDeviceTable: the mirror lives on the mesh's primary device,
    where K5 runs (no other device reads it)."""

    def __init__(
        self, store: DestStore, device: DeviceLike = None, mesh=None, telemetry=None
    ):
        self.store = store
        if mesh is not None:
            device = primary_device(mesh)
        self.device = resolve(device)
        self.telemetry = telemetry if telemetry is not None else _NULL_TEL
        self._seg_off: Optional[torch.Tensor] = None
        self._seg_len: Optional[torch.Tensor] = None
        self._edge_client: Optional[torch.Tensor] = None
        self._edge_opts: Optional[torch.Tensor] = None
        # K5's winner keys, kept across resolves and grown with the
        # client registry (every resolve runs on the one current stream)
        self._scratch: Optional[FanoutScratch] = None

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return to_device(a, self.device)

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        """(seg_off, seg_len, edge_client, edge_opts) as synced."""
        return (self._seg_off, self._seg_len, self._edge_client, self._edge_opts)

    def sync(self) -> int:
        """Bring the device CSR mirror up to date; returns entries
        written (rows + edges). Growth replaces the tensors; an
        in-flight resolve keeps the old ones alive through its handle."""
        s = self.store
        if s.grew or self._seg_off is None:
            n = len(s.dirty_rows) + len(s.dirty_edges)
            s.dirty_rows.clear()
            s.dirty_edges.clear()
            s.grew = False
            self._seg_off = self._put(s.seg_off)
            self._seg_len = self._put(s.seg_len)
            self._edge_client = self._put(s.edge_client)
            self._edge_opts = self._put(s.edge_opts)
            return n
        # the dirty ids, sorted and distinct
        rows = np.unique(np.asarray(s.dirty_rows, np.int32))
        edges = np.unique(np.asarray(s.dirty_edges, np.int32))
        s.dirty_rows.clear()
        s.dirty_edges.clear()
        n_r, n_e = len(rows), len(edges)
        if n_r + n_e == 0:
            return 0
        # the reference's shape buckets, so the telemetry reads the same
        for name, n, cap in (("scatter_segs", n_r, s.row_capacity),
                             ("scatter_edges", n_e, s.edge_capacity)):
            if n:
                self.telemetry.record_shape(name, (next_pow2(-(-n // SYNC_BATCH)), cap))
        staged = stage_delta(rows, edges, s.seg_off, s.seg_len, s.edge_client,
                             s.edge_opts, self.device)
        fanout_sync(*self.tensors(), staged, n_r, n_e)
        return n_r + n_e

    def resolve_begin(self, rows, fan: int):
        """Sync + LAUNCH the plan kernel for one matched row set and
        start the winner-slot copy to the host; nothing waits. The
        handle is (ticket, fan, host seconds, device tensors read)."""
        tel = self.telemetry
        t0 = tel.clock()
        self.sync()
        max_fan = fan_bucket(max(fan, 64))
        rows_arr = np.full(next_pow2(max(len(rows), 4)), -1, np.int32)
        rows_arr[: len(rows)] = rows
        nc = self.store.client_pow2()
        tel.record_shape(
            "resolve_fanout",
            (len(rows_arr), max_fan, nc, self.store.edge_capacity),
        )
        state = self.tensors()
        if self._scratch is None or self._scratch.capacity < nc:
            self._scratch = FanoutScratch(nc, self.device)
        dev = resolve_fanout(
            *state, self._put(rows_arr), n_clients=nc, max_fan=max_fan,
            scratch=self._scratch,
        )
        ticket = transfer_ops.start_fetch(dev, tel)
        return (ticket, fan, tel.clock() - t0, state)

    def resolve_finish(self, handle) -> Tuple[np.ndarray, int]:
        """Force the transfer for a begun resolve. Returns (winner edge
        ids in plan order, gathered fan)."""
        ticket, _fan, elapsed, _state = handle
        tel = self.telemetry
        t0 = tel.clock()
        out, _n, total = ticket.wait()
        win = out[out >= 0]
        tel.observe_family("fanout_resolve_seconds", elapsed + tel.clock() - t0)
        return win, int(total)
