"""Match and table update over a (dp, sub) mesh (the port's counterpart of
emqx_tpu/parallel/sharded_match.py).

Filter rows and cuckoo buckets are split over the sub axis, topic
batches over dp (parallel/mesh.py). Per (dp, sub) tile the per-shard
programs run on the tile's own slices and emit global ids; their
compacted results are then combined across the sub axis on the device
(K14), so a dispatch fetches one [n_dp, mh] buffer whatever the shard
count. Route churn reaches each device group as one staged buffer of
global ids (ops/delta.py), and one thread an entry writes it at its
owner shard's position: the rows, slots and probe words each shard owns.

Kernels (each a hand-written CUDA kernel beside its plain PyTorch
version, which CPU tensors take):

  K13  `make_sharded_kernels`: per-tile counts and packed bitmap (K11's
       and K10's kernel, csrc/packed_match.cu, in its two modes) and
       `apply_delta`, the owned-row scatter (`mesh_table_sync` with no
       slots)
  K14  `_combine_pairs`: the order-preserving recompaction over sub plus
       the summed counts (csrc/combine.cu)
  K15  `make_combine_probe_kernel`: K14's walk on salted one-entry
       buffers, built and combined in one launch on one device
       (csrc/combine.cu)
  K16  `make_match_ids_kernel`: per-tile dense compaction
       (csrc/dense_match.cu) + K14
  K17  `make_sharded_hash_kernel`: per-tile cuckoo probe over the owned
       buckets (csrc/hash_match.cu) + K14
  K18  `make_slot_delta_kernel`, `make_mesh_sync_kernel`: the owned
       slot scatter, alone and fused with the row scatter
  K13 `apply_delta` and K18 are one kernel, `mesh_table_sync`
       (csrc/scatter.cu): a group's whole delta sync in one launch, from
       ShardedDeviceTable.sync's staged buffer or from the reference's
       [n_b, K] batches, the residual mask carried in the row side

One launch per distinct device covers the tiles it holds. The
all_gather over sub is a view where a device holds a dp block's every
shard back to back (always, on one device), a copy otherwise; the psum
is a sum inside K14.

`ShardedDeviceTable` is the mesh mirror of a FilterTable and its class
index behind DeviceTable's sync/begin/finish surface, with the
reference's escalation (a sticky per-block floor) and its shard failure
domain: `evacuate_shard` drops one sub column of the full layout
(`_mesh0`) into `lost_shards` and re-shards the table over the
survivors, `restore_shard` takes it back; each swap drops every device
tensor, so the next sync is a full re-upload from host truth (the delta
syncs after it run K13+K18 on the new layout), and bumps `shard_gen`. On one card the mesh repeats the card, so a lost "chip" is
a sub column that the layout leaves out. The reference's admission knob
(degrading small tables to one device) is not part of this port yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs.kernel_telemetry import NULL as _NULL_TEL
from ..obs.profiler import STAGE_MARK
from ..ops import match as match_ops
from ..ops import transfer as transfer_ops
from ..ops._build import I, LL, P, CudaKernel, raw_stream
from ..ops.delta import pack_table_delta, staged_columns, table_delta_layout
from ..ops.fanout import FanoutDeviceState
from ..ops.hash_index import (
    _ALT_MUL,
    BUCKET_W,
    M32,
    ClassMeta,
    SlotArrays,
    _u32,
    class_hash_ref,
    has_byte_ref,
    hash_geometry,
    verify_lanes_ref,
)
from ..ops.match import EncodedTopics, _match_block_ref, check_tensor
from ..ops.table import EncodedFilters, next_pow2
from . import mesh as mesh_mod
from .mesh import DP_AXIS, SUB_AXIS, Mesh

# --- the kernels' C entry points ----------------------------------------------

_MESH_COUNTS = CudaKernel(
    "mesh_match_counts", "packed_match.cu", "emqx_match_counts", match_ops._PACKED_ARGTYPES
)
_MESH_PACKED = CudaKernel(
    "mesh_match_packed", "packed_match.cu", "emqx_match_packed", match_ops._PACKED_ARGTYPES
)
_MESH_TABLE_SYNC = CudaKernel(
    "mesh_table_sync", "scatter.cu", "emqx_mesh_table_sync",
    [P, P, P, P, P, P, I, I, P, P, P, I, P, I,
     P, P, P, P, P, P, P, LL, P, P, P, P, LL, P],
)
_COMBINE = CudaKernel(
    "combine_pairs", "combine.cu", "emqx_combine_pairs",
    [P, P, P, I, I, I, P, P, P, P],
)
_PROBE = CudaKernel(
    "combine_probe", "combine.cu", "emqx_combine_probe", [I, P, I, I, I, P, P, P, P, P, P, P]
)
_MESH_IDS = CudaKernel(
    "mesh_match_ids", "dense_match.cu", "emqx_mesh_match_ids",
    [P, P, P, P, P, I, I, I, P, P, P, I, I, P, I, I, P, P, P, P, LL, P],
)
_MESH_HASH = CudaKernel(
    "mesh_match_ids_hash", "hash_match.cu", "emqx_mesh_match_ids_hash",
    [P, P, P, P, P, I, P, P, P, I, I, P, P, P, I, I, P, I, I, P, P, P, P, LL, P],
)

_NO_IDS = np.zeros(0, np.int32)

DENSE_CHUNK = 65536  # rows of a chunk of K16's segments (ops/match.py's chunk)


def _launch(kernel: CudaKernel, dev: torch.device, *args) -> None:
    """Launch on `dev`'s current stream with `dev` current: a multi-card
    mesh launches each device's kernel in that device's context, and the
    context is entered only when `dev` is not current already."""
    if dev.index == torch.cuda.current_device():
        kernel(*args, raw_stream(dev))
        return
    with torch.cuda.device(dev):
        kernel(*args, raw_stream(dev))


def _tiles(mesh: Mesh, gi: int):
    """Python rows (dp_i, sub_i, dp_pos, sub_pos) of group gi's tiles."""
    g = mesh.groups[gi]
    return [(i, j, g.dps.index(i), g.subs.index(j)) for i, j in g.tiles]


def _wrap32(x: int) -> int:
    return ((x + (1 << 31)) % (1 << 32)) - (1 << 31)


# --- plain PyTorch versions (one group's tiles) ------------------------------------


def match_ids_tiles_ref(f: EncodedFilters, t: EncodedTopics, tiles, n_loc: int,
                        b_loc: int, mh: int):
    """Plain version of K16's per-tile leg: (ti, ri int32 [n_tiles, mh]
    global ids in the tile's (topic, row) order, cnt int32 [n_tiles])."""
    dev = f.words.device
    n_tiles = len(tiles)
    ti = torch.full((n_tiles, mh), -1, dtype=torch.int32, device=dev)
    ri = torch.full((n_tiles, mh), -1, dtype=torch.int32, device=dev)
    cnt = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    for k, (dp_i, sub_i, dp_pos, sub_pos) in enumerate(tiles):
        rs = slice(sub_pos * n_loc, (sub_pos + 1) * n_loc)
        ts = slice(dp_pos * b_loc, (dp_pos + 1) * b_loc)
        ok = _match_block_ref(t.ids[ts], t.lens[ts], t.dollar[ts], *(a[rs] for a in f))
        idx = torch.nonzero(ok.reshape(-1)).squeeze(1)
        cnt[k] = idx.numel()
        idx = idx[:mh]
        h = idx.numel()
        ti[k, :h] = (idx // n_loc + dp_i * b_loc).to(torch.int32)
        ri[k, :h] = (idx % n_loc + sub_i * n_loc).to(torch.int32)
    return ti, ri, cnt


def hash_tiles_ref(meta: ClassMeta, slots: SlotArrays, t: EncodedTopics, tiles,
                   nb_loc: int, n_buckets: int, b_loc: int, mh: int):
    """Plain version of K17's per-tile leg: (ti, bi int32 [n_tiles, mh],
    cnt int32 [n_tiles] flagged pairs, amb int32 scalar over the tiles).
    Buckets use the logical mask n_buckets - 1; a tile probes only the
    buckets [sub_i * nb_loc, (sub_i + 1) * nb_loc) its shard owns."""
    dev = t.ids.device
    n_tiles = len(tiles)
    c = meta.plen.shape[0]
    ti = torch.full((n_tiles, mh), -1, dtype=torch.int32, device=dev)
    bi = torch.full((n_tiles, mh), -1, dtype=torch.int32, device=dev)
    cnt = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    amb = 0
    mask = n_buckets - 1
    for k, (dp_i, sub_i, dp_pos, sub_pos) in enumerate(tiles):
        ts = slice(dp_pos * b_loc, (dp_pos + 1) * b_loc)
        elig, h1, fp = class_hash_ref(meta, EncodedTopics(*(a[ts] for a in t)))
        probe = _u32(slots.probe[sub_pos * nb_loc:(sub_pos + 1) * nb_loc])
        s_fp = slots.fp[sub_pos * nb_loc * BUCKET_W:(sub_pos + 1) * nb_loc * BUCKET_W]
        s_bkt = slots.bucket[sub_pos * nb_loc * BUCKET_W:(sub_pos + 1) * nb_loc * BUCKET_W]
        rep = torch.clamp_min(fp >> 24, 1) * 0x01010101
        b1 = h1 & mask
        b2 = b1 ^ ((((fp | 1) * _ALT_MUL) & M32) & mask)
        off = sub_i * nb_loc

        def owned(bkt):
            lb = bkt - off
            inside = (lb >= 0) & (lb < nb_loc)
            lb = lb.clamp(0, nb_loc - 1)
            # a bucket the shard does not own reads as the word 0: no
            # lane of it byte-matches (probe bytes are >= 1)
            return lb, torch.where(inside, probe[lb], 0)

        l1, w1 = owned(b1)
        l2, w2 = owned(b2)
        pairhit = elig & (has_byte_ref(w1, rep) | has_byte_ref(w2, rep))
        cnt[k] = int(pairhit.sum())
        pflat = torch.nonzero(pairhit.reshape(-1)).squeeze(1)[:mh]
        h = pflat.numel()
        if not h:
            continue
        ok, g, amb_flag = verify_lanes_ref(
            l1.reshape(-1)[pflat], l2.reshape(-1)[pflat], fp.reshape(-1)[pflat],
            w1.reshape(-1)[pflat], w2.reshape(-1)[pflat], s_fp, s_bkt,
        )
        ti[k, :h] = torch.where(ok, pflat // c + dp_i * b_loc, -1).to(torch.int32)
        bi[k, :h] = torch.where(ok, g, -1).to(torch.int32)
        amb += int(amb_flag.sum())
    return ti, bi, cnt, torch.tensor(amb, dtype=torch.int32, device=dev)


def combine_pairs_ref(a_all: torch.Tensor, b_all: torch.Tensor, cnt: torch.Tensor,
                      mh: int):
    """Plain version of K14 over dp blocks gathered on one device:
    a_all, b_all [n, n_sub * mh], cnt [n, n_sub] -> (ca, cb int32 [n, mh],
    totals int32 [n]): the valid (a >= 0) entries in sub-major order,
    truncated to mh, -1 past them; totals the summed counts."""
    n = a_all.shape[0]
    ca = torch.full((n, mh), -1, dtype=torch.int32, device=a_all.device)
    cb = torch.full((n, mh), -1, dtype=torch.int32, device=a_all.device)
    for j in range(n):
        pos = torch.nonzero(a_all[j] >= 0).squeeze(1)[:mh]
        ca[j, :pos.numel()] = a_all[j][pos]
        cb[j, :pos.numel()] = b_all[j][pos]
    return ca, cb, cnt.sum(dim=1, dtype=torch.int32)


def combine_probe_ref(salt: int, tiles, mh: int, device):
    """Plain version of K15's buffers: per tile one entry a = salt +
    sub_i + 1, b = salt * 2 + 1 (int32, wrapping) at position 0, -1
    elsewhere; cnt 1 where a >= 0."""
    n_tiles = len(tiles)
    a = torch.full((n_tiles, mh), -1, dtype=torch.int32, device=device)
    b = torch.full((n_tiles, mh), -1, dtype=torch.int32, device=device)
    cnt = torch.zeros(n_tiles, dtype=torch.int32, device=device)
    for k, (_dp_i, sub_i, _dp_pos, _sub_pos) in enumerate(tiles):
        va = _wrap32(salt + sub_i + 1)
        a[k, 0] = va
        b[k, 0] = _wrap32(salt * 2 + 1)
        cnt[k] = int(va >= 0)
    return a, b, cnt


def dense_tiles_ref(mode: int, f: EncodedFilters, t: EncodedTopics, tiles,
                    n_loc: int, b_loc: int, out: torch.Tensor) -> None:
    """Plain version of K13's counts (mode FORM_COUNTS: add into int32
    [B]) and packed bitmap (FORM_PACKED: write the tile's block of the
    [B, N/32] bitmap, given as its int32 view) over one group's tiles."""
    for dp_i, sub_i, dp_pos, sub_pos in tiles:
        rs = slice(sub_pos * n_loc, (sub_pos + 1) * n_loc)
        ts = slice(dp_pos * b_loc, (dp_pos + 1) * b_loc)
        ok = _match_block_ref(t.ids[ts], t.lens[ts], t.dollar[ts], *(a[rs] for a in f))
        to = slice(dp_i * b_loc, (dp_i + 1) * b_loc)
        if mode == match_ops.FORM_COUNTS:
            out[to] += ok.sum(dim=1, dtype=torch.int32)
        else:
            w = n_loc // 32
            out[to, sub_i * w:(sub_i + 1) * w] = match_ops._pack_bits_ref(ok).view(torch.int32)


def _owned(ids: torch.Tensor, local: int, n_sub: int, subs: Sequence[int]):
    """Global ids -> (keep, dst): which ids a group owns under the owner
    map (id // local is the owner shard, held at position k of `subs`)
    and where they land in its tensors, k * local + id % local. Ids below
    0, past the n_sub shards or of shards not held are not kept."""
    i = ids.reshape(-1).to(torch.int64)
    pos = torch.full((n_sub,), -1, dtype=torch.int64, device=i.device)
    pos[list(subs)] = torch.arange(len(subs), dtype=torch.int64, device=i.device)
    s = torch.div(i, local, rounding_mode="floor")
    k = pos[s.clamp(0, n_sub - 1)]
    keep = (i >= 0) & (s < n_sub) & (k >= 0)
    return keep, (k * local + i - s * local)[keep]


def scatter_owned_rows_ref(dev: EncodedFilters, subs: Sequence[int], n_sub: int, rows,
                           words, plen, hh, rw, act, residual=None, res=None) -> None:
    """Plain version of the mesh sync's row side (K13's `apply_delta`) on
    one group's tensors, in place: each global row id (any shape; the
    reference's [n_b, K] batches or a staged column) its owner shard
    holds writes the five filter columns, and its residual-mask byte
    where `residual` is given."""
    levels = dev.words.shape[1]
    keep, dst = _owned(rows, dev.words.shape[0] // len(subs), n_sub, subs)
    dev.words[dst] = words.reshape(-1, levels)[keep]
    dev.prefix_len[dst] = plen.reshape(-1)[keep]
    dev.has_hash[dst] = hh.reshape(-1)[keep]
    dev.root_wild[dst] = rw.reshape(-1)[keep]
    dev.active[dst] = act.reshape(-1)[keep]
    if residual is not None:
        residual[dst] = res.reshape(-1)[keep]


def _slot_shard(slots: SlotArrays, n_held: int) -> int:
    """Slots a shard of a group's slot arrays; raises unless the shards
    are bucket-aligned (a slot's probe word lies in the slot's shard)."""
    n_loc = slots.fp.shape[0] // n_held
    nb_loc = slots.probe.shape[0] // n_held
    if n_loc != nb_loc * BUCKET_W:
        raise ValueError(f"slot shards ({n_loc}) are not bucket-aligned ({nb_loc})")
    return n_loc


def scatter_owned_slots_ref(slots: SlotArrays, subs: Sequence[int], n_sub: int, idx, fp,
                            bucket, probe) -> None:
    """Plain version of the mesh sync's slot side (K18's slot scatter) on
    one group's tensors, in place: each global slot id its owner shard
    holds writes fp, bucket and its probe word (the word of the slot's
    bucket, in the same shard). uint32 columns go through their int32
    view (same bits)."""
    keep, dst = _owned(idx, _slot_shard(slots, len(subs)), n_sub, subs)
    slots.fp.view(torch.int32)[dst] = fp.reshape(-1).view(torch.int32)[keep]
    slots.bucket[dst] = bucket.reshape(-1)[keep]
    slots.probe.view(torch.int32)[dst // BUCKET_W] = probe.reshape(-1).view(torch.int32)[keep]


def mesh_table_sync_ref(subs: Sequence[int], n_sub: int, dev: EncodedFilters,
                        slots: Optional[SlotArrays], residual: Optional[torch.Tensor],
                        staged: torch.Tensor, n_r: int, n_s: int) -> None:
    """Plain version of the fused K13/K18 mesh sync on one group's
    tensors (the shards `subs` of n_sub), in place: a staged delta
    (ops/delta.py) applied through the owner map, the residual mask
    where given."""
    rows, sl = staged_columns(staged, n_r, dev.words.shape[1], n_s)
    *cols, res = rows
    if n_r:
        scatter_owned_rows_ref(dev, subs, n_sub, *cols, residual=residual, res=res)
    if n_s:
        scatter_owned_slots_ref(slots, subs, n_sub, *sl)


# --- per-group launches: kernel on CUDA tensors, plain version on the CPU ---------


def _tiles_match_ids(mesh: Mesh, gi: int, f: EncodedFilters, t: EncodedTopics, mh: int):
    g = mesh.groups[gi]
    n_loc = f.words.shape[0] // len(g.subs)
    b_loc = t.ids.shape[0] // len(g.dps)
    dev = f.words.device
    if dev.type == "cpu":
        return match_ids_tiles_ref(f, t, _tiles(mesh, gi), n_loc, b_loc, mh)
    _n, levels = match_ops.check_filters(f, dev)
    match_ops.check_topics(t, levels, dev)
    n_tiles = len(g.tiles)
    chunk = min(DENSE_CHUNK, n_loc)
    n_rows = f.words.shape[0]
    geo = match_ops.dense_geometry(n_rows, n_loc, b_loc, chunk, n_tiles)
    ti = torch.empty((n_tiles, mh), dtype=torch.int32, device=dev)
    ri = torch.empty((n_tiles, mh), dtype=torch.int32, device=dev)
    cnt = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    scratch = torch.empty(geo.scratch, dtype=torch.int32, device=dev)
    _launch(
        _MESH_IDS, dev,
        f.words.data_ptr(), f.prefix_len.data_ptr(), f.has_hash.data_ptr(),
        f.root_wild.data_ptr(), f.active.data_ptr(), n_rows, n_loc, levels,
        t.ids.data_ptr(), t.lens.data_ptr(), t.dollar.data_ptr(), b_loc, chunk,
        mesh.tile_table(gi).data_ptr(), n_tiles, mh,
        ti.data_ptr(), ri.data_ptr(), cnt.data_ptr(), scratch.data_ptr(), geo.scratch,
    )
    return ti, ri, cnt


def _tiles_hash(mesh: Mesh, gi: int, meta: ClassMeta, slots: SlotArrays,
                t: EncodedTopics, n_buckets: int, mh: int):
    g = mesh.groups[gi]
    nb_loc = slots.probe.shape[0] // len(g.subs)
    b_loc = t.ids.shape[0] // len(g.dps)
    dev = t.ids.device
    if dev.type == "cpu":
        return hash_tiles_ref(meta, slots, t, _tiles(mesh, gi), nb_loc, n_buckets,
                              b_loc, mh)
    levels = t.ids.shape[1]
    if not 1 <= levels <= match_ops.MAX_KERNEL_LEVELS:
        raise ValueError(f"max_levels {levels} outside 1..{match_ops.MAX_KERNEL_LEVELS}")
    match_ops.check_topics(t, levels, dev)
    c = meta.plen.shape[0]
    check_tensor("meta.plen", meta.plen, torch.int32, (c,), dev)
    check_tensor("meta.plus", meta.plus, torch.uint32, (c,), dev)
    for name in ("has_hash", "root_wild", "active"):
        check_tensor(f"meta.{name}", getattr(meta, name), torch.bool, (c,), dev)
    if n_buckets < 1 or n_buckets & (n_buckets - 1):
        raise ValueError(f"bucket count {n_buckets} is not a power of two")
    n_sub_here = len(g.subs)
    check_tensor("slots.probe", slots.probe, torch.uint32, (n_sub_here * nb_loc,), dev)
    n_slots = n_sub_here * nb_loc * BUCKET_W
    check_tensor("slots.fp", slots.fp, torch.uint32, (n_slots,), dev)
    check_tensor("slots.bucket", slots.bucket, torch.int32, (n_slots,), dev)
    n_tiles = len(g.tiles)
    ti = torch.empty((n_tiles, mh), dtype=torch.int32, device=dev)
    bi = torch.empty((n_tiles, mh), dtype=torch.int32, device=dev)
    cnt = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    # the kernel zeroes its scratch; element 1 is the amb count
    scratch = torch.empty(hash_geometry(b_loc, c, n_tiles).scratch, dtype=torch.int32,
                          device=dev)
    _launch(
        _MESH_HASH, dev,
        meta.plen.data_ptr(), meta.has_hash.data_ptr(), meta.root_wild.data_ptr(),
        meta.plus.data_ptr(), meta.active.data_ptr(), c,
        slots.fp.data_ptr(), slots.bucket.data_ptr(), slots.probe.data_ptr(),
        nb_loc, n_buckets, t.ids.data_ptr(), t.lens.data_ptr(), t.dollar.data_ptr(),
        b_loc, levels, mesh.tile_table(gi).data_ptr(), n_tiles, mh,
        ti.data_ptr(), bi.data_ptr(), cnt.data_ptr(), scratch.data_ptr(), scratch.numel(),
    )
    return ti, bi, cnt, scratch[1]


def _combine_launch(a_all: torch.Tensor, b_all: torch.Tensor, cnt: torch.Tensor, mh: int):
    dev = a_all.device
    if dev.type == "cpu":
        return combine_pairs_ref(a_all, b_all, cnt, mh)
    n, width = a_all.shape
    n_sub = cnt.shape[1]
    if width != n_sub * mh:
        raise ValueError(f"gathered width {width} is not n_sub * mh = {n_sub * mh}")
    check_tensor("a_all", a_all, torch.int32, (n, width), dev)
    check_tensor("b_all", b_all, torch.int32, (n, width), dev)
    check_tensor("cnt", cnt, torch.int32, (n, n_sub), dev)
    ca = torch.empty((n, mh), dtype=torch.int32, device=dev)
    cb = torch.empty((n, mh), dtype=torch.int32, device=dev)
    tot = torch.empty(n, dtype=torch.int32, device=dev)
    _launch(
        _COMBINE, dev, a_all.data_ptr(), b_all.data_ptr(), cnt.data_ptr(), n, n_sub, mh,
        ca.data_ptr(), cb.data_ptr(), tot.data_ptr(),
    )
    return ca, cb, tot


# --- the collectives ---------------------------------------------------------------


def _gather_sub(mesh: Mesh, parts: Sequence[torch.Tensor]):
    """all_gather over sub: per-group per-tile rows ([n_tiles_g, w])
    -> [(device, dp blocks, [len(dp blocks), n_sub * w])], each dp
    block's n_sub rows side by side on the block's first device. A view
    when one device holds every tile (row-major); copies otherwise."""
    n_dp, n_sub = mesh.shape[DP_AXIS], mesh.shape[SUB_AXIS]
    if len(mesh.groups) == 1:
        return [(mesh.groups[0].device, list(range(n_dp)), parts[0].reshape(n_dp, -1))]
    by_dev: dict = {}
    for j in range(n_dp):
        d = mesh.devices[j, 0]
        rows = []
        for s in range(n_sub):
            gi, k = mesh.locate(j, s)
            rows.append(parts[gi][k].reshape(-1).to(d))
        by_dev.setdefault(d, []).append((j, torch.cat(rows)))
    return [(d, [j for j, _ in items], torch.stack([v for _, v in items]))
            for d, items in by_dev.items()]


def _to_primary(mesh: Mesh, pieces) -> torch.Tensor:
    """[(dp blocks, tensor [len, ...])] -> one [n_dp, ...] tensor on the
    primary device, in dp order (the piece itself when it already is)."""
    if len(pieces) == 1 and pieces[0][0] == list(range(mesh.shape[DP_AXIS])):
        return pieces[0][1]
    prim = mesh_mod.primary_device(mesh)
    order = sorted((j, t[k]) for dps, t in pieces for k, j in enumerate(dps))
    return torch.stack([t.to(prim) for _j, t in order])


def _combine_pairs(mesh: Mesh, parts, mh: int):
    """K14 over a per-tile result: parts holds one (a [n_tiles_g, mh],
    b, cnt [n_tiles_g]) per group. Returns (ca, cb [n_dp, mh], totals
    [n_dp, 1]) on the primary device."""
    ga = _gather_sub(mesh, [p[0] for p in parts])
    gb = _gather_sub(mesh, [p[1] for p in parts])
    gc = _gather_sub(mesh, [p[2] for p in parts])
    outs = [_combine_launch(a, b, c, mh) for (_d, _j, a), (_, _, b), (_, _, c)
            in zip(ga, gb, gc)]
    dps = [j for _d, j, _a in ga]
    ca = _to_primary(mesh, [(j, o[0]) for j, o in zip(dps, outs)])
    cb = _to_primary(mesh, [(j, o[1]) for j, o in zip(dps, outs)])
    tot = _to_primary(mesh, [(j, o[2]) for j, o in zip(dps, outs)])
    return ca, cb, tot.reshape(-1, 1)


def _sum_to_primary(mesh: Mesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """psum of per-group partials onto the primary device."""
    if len(parts) == 1:
        return parts[0]
    prim = mesh_mod.primary_device(mesh)
    acc = parts[0].to(prim, copy=True)
    for p in parts[1:]:
        acc += p.to(prim)
    return acc


def _repl(mesh: Mesh, a) -> Tuple[torch.Tensor, ...]:
    """A delta array for every device: numpy is placed once per device,
    an already placed per-group tuple passes through."""
    if isinstance(a, np.ndarray):
        return mesh_mod.put_repl(a, mesh)
    return tuple(a)


# --- the programs ---------------------------------------------------------------------


# an empty side of a launch: the row tables (five columns, the mask,
# rows a shard, L), the slot tables (three arrays, probe words a shard),
# or either side's delta columns with their count
_NO_ROWS = (0, 0, 0, 0, 0, 0, 1, 1)
_NO_SLOTS = (0, 0, 0, 1)
_NO_ROW_COLS = (0, 0, 0, 0, 0, 0, 0, 0)
_NO_SLOT_COLS = (0, 0, 0, 0, 0)


def _row_tables(d: EncodedFilters, residual: Optional[torch.Tensor], n_held: int, dev):
    """The launch's row-table arguments on one group, each table checked:
    the five columns, the residual mask (0 = none), rows a shard, L."""
    n, levels = match_ops.check_filters(d, dev)
    if residual is not None:
        check_tensor("residual", residual, torch.bool, (n,), dev)
    return (d.words.data_ptr(), d.prefix_len.data_ptr(), d.has_hash.data_ptr(),
            d.root_wild.data_ptr(), d.active.data_ptr(),
            0 if residual is None else residual.data_ptr(), n // n_held, levels)


def _slot_tables(slots: SlotArrays, n_held: int, dev):
    """The launch's slot-table arguments on one group, each array
    checked: fp, bucket, probe and probe words a shard."""
    n_loc = _slot_shard(slots, n_held)
    check_tensor("slots.fp", slots.fp, torch.uint32, (n_loc * n_held,), dev)
    check_tensor("slots.bucket", slots.bucket, torch.int32, (n_loc * n_held,), dev)
    check_tensor("slots.probe", slots.probe, torch.uint32, (n_loc // BUCKET_W * n_held,), dev)
    return slots.fp.data_ptr(), slots.bucket.data_ptr(), slots.probe.data_ptr(), n_loc // BUCKET_W


def _row_batch(levels: int, dev, r, w, p, h, rw, a):
    """The checked delta columns of a reference-shaped row batch (no
    residual column) and its entry count."""
    shape = tuple(r.shape)
    check_tensor("rows", r, torch.int32, shape, dev)
    check_tensor("words", w, torch.int32, shape + (levels,), dev)
    check_tensor("prefix_len", p, torch.int32, shape, dev)
    for name, x in (("has_hash", h), ("root_wild", rw), ("active", a)):
        check_tensor(name, x, torch.bool, shape, dev)
    return (r.data_ptr(), w.data_ptr(), p.data_ptr(), h.data_ptr(), rw.data_ptr(),
            a.data_ptr(), 0, r.numel())


def _slot_batch(dev, idx, fpv, bktv, pwv):
    """The checked delta columns of a reference-shaped slot batch and its
    entry count."""
    shape = tuple(idx.shape)
    check_tensor("idx", idx, torch.int32, shape, dev)
    check_tensor("fp", fpv, torch.uint32, shape, dev)
    check_tensor("bucket", bktv, torch.int32, shape, dev)
    check_tensor("probe", pwv, torch.uint32, shape, dev)
    return idx.data_ptr(), fpv.data_ptr(), bktv.data_ptr(), pwv.data_ptr(), idx.numel()


# the mesh table sync's launches by the sides they carry, kept where the
# kernel is launched: "rows" (K13 apply_delta's work), "slots" (the K18
# slot delta's), "both" (the fused K18's); their sum is the kernel's count
SYNC_LAUNCH_KINDS = {"rows": 0, "slots": 0, "both": 0}


def _sync_launch(mesh: Mesh, gi: int, rows, slots, row_cols, slot_cols) -> None:
    """One launch of the mesh table sync on group gi (none when both
    sides are empty)."""
    n_r, n_s = row_cols[-1], slot_cols[-1]
    if n_r + n_s == 0:
        return
    _launch(_MESH_TABLE_SYNC, mesh.groups[gi].device, *rows, *slots,
            mesh.sub_pos(gi).data_ptr(), mesh.shape[SUB_AXIS], *row_cols, *slot_cols)
    SYNC_LAUNCH_KINDS["both" if n_r and n_s else "rows" if n_r else "slots"] += 1


def mesh_table_sync(mesh: Mesh, dev, slots, residual, staged, n_r: int, n_s: int) -> None:
    """A ShardedDeviceTable's delta sync in place (the reference's
    `apply_delta`, slot delta or fused sync, and its residual-mask
    upload), from one staged buffer per group (ops/delta.py's layout, no
    padding): dev, slots, residual and staged are per-group tuples;
    `residual` None leaves the mask alone, `slots` may be None when n_s
    is 0. Each CUDA group's tables are checked and the fused K13/K18
    kernel launched once (not at all when both sides are empty); CPU
    groups take the plain version."""
    if n_r < 0 or n_s < 0:
        raise ValueError(f"mesh_table_sync: negative entry counts ({n_r}, {n_s})")
    if n_s and slots is None:
        raise ValueError("mesh_table_sync: slot entries but no slot arrays")
    for gi in range(len(mesh.groups)):
        group_table_sync(mesh, gi, dev[gi], None if slots is None else slots[gi],
                         None if residual is None else residual[gi], staged[gi], n_r, n_s)


def group_table_sync(mesh: Mesh, gi: int, dev: EncodedFilters, slots: Optional[SlotArrays],
                     residual: Optional[torch.Tensor], staged: torch.Tensor, n_r: int,
                     n_s: int) -> None:
    """mesh_table_sync on group gi's own tensors (counts checked by the
    caller)."""
    g = mesh.groups[gi]
    if g.device.type == "cpu":
        mesh_table_sync_ref(g.subs, mesh.shape[SUB_AXIS], dev, slots, residual, staged,
                            n_r, n_s)
        return
    rt = _row_tables(dev, residual, len(g.subs), g.device)
    st = _NO_SLOTS if slots is None else _slot_tables(slots, len(g.subs), g.device)
    w_off, s_off, total = table_delta_layout(n_r, rt[-1], n_s)
    check_tensor("staged", staged, torch.uint8, (total,), g.device)
    p = staged.data_ptr()
    s = p + s_off
    _sync_launch(
        mesh, gi, rt, st,
        (p, p + w_off, p + 4 * n_r, p + 8 * n_r, p + 9 * n_r, p + 10 * n_r,
         0 if residual is None else p + 11 * n_r, n_r),
        (s, s + 4 * n_s, s + 8 * n_s, s + 12 * n_s, n_s),
    )


def make_sharded_kernels(mesh: Mesh):
    """The mesh-partitioned dense kernels (K13). Returns (match_counts,
    match_packed, apply_delta):

      match_counts(filters, topics) -> int32 [B] (counts summed over sub;
          any shard row count)
      match_packed(filters, topics) -> uint32 [B, N/32] (tiled over
          (dp, sub); each shard's row count a multiple of 32)
      apply_delta(dev, rows, words, plen, hh, rw, act) -> dev, written
          in place: [n_b, K] global row ids and their columns, each
          shard writing the rows it owns

    filters/dev and topics are put_filters / put_topics values; the
    delta columns numpy arrays (or per-group tuples already placed)."""
    n_sub = mesh.shape[SUB_AXIS]

    def _forms(kernel, mode, filters, topics):
        outs = []
        for gi, g in enumerate(mesh.groups):
            f, t = filters[gi], topics[gi]
            n_loc = f.words.shape[0] // len(g.subs)
            b_loc = t.ids.shape[0] // len(g.dps)
            b = b_loc * mesh.shape[DP_AXIS]
            cpu = g.device.type == "cpu"
            if mode == match_ops.FORM_COUNTS:
                # the plain version adds into zeros; the kernel's entry
                # zeroes its output itself
                w = b
                out = (torch.zeros if cpu else torch.empty)(b, dtype=torch.int32,
                                                           device=g.device)
            else:
                if n_loc % 32:
                    raise ValueError(f"shard rows {n_loc} not a multiple of 32")
                w = n_loc * n_sub // 32
                # each tile's block is copied out only from the group
                # that computed it, so no word outside them is read
                out = torch.empty((b, w), dtype=torch.uint32, device=g.device)
            if cpu:
                dense_tiles_ref(mode, f, t, _tiles(mesh, gi), n_loc, b_loc,
                                out if mode == match_ops.FORM_COUNTS
                                else out.view(torch.int32))
            else:
                with torch.cuda.device(g.device):
                    match_ops.launch_packed(kernel, f, t, n_loc, b_loc, mesh.tile_table(gi),
                                            len(g.tiles), out, w)
            outs.append(out)
        return outs, b_loc, n_loc

    def match_counts(filters, topics):
        outs, _b, _n = _forms(_MESH_COUNTS, match_ops.FORM_COUNTS, filters, topics)
        return _sum_to_primary(mesh, outs)

    def match_packed(filters, topics):
        outs, b_loc, n_loc = _forms(_MESH_PACKED, match_ops.FORM_PACKED, filters, topics)
        if len(outs) == 1:
            return outs[0]
        # every tile's block from the device that computed it
        prim = mesh_mod.primary_device(mesh)
        out = outs[0].to(prim, copy=True)
        w = n_loc // 32
        for gi, g in enumerate(mesh.groups):
            for i, j in g.tiles:
                blk = (slice(i * b_loc, (i + 1) * b_loc), slice(j * w, (j + 1) * w))
                out[blk] = outs[gi][blk].to(prim)
        return out

    def apply_delta(dev, rows, words, plen, hh, rw, act):
        cols = [_repl(mesh, a) for a in (rows, words, plen, hh, rw, act)]
        for gi, g in enumerate(mesh.groups):
            d = dev[gi]
            batch = [c[gi] for c in cols]
            if g.device.type == "cpu":
                scatter_owned_rows_ref(d, g.subs, n_sub, *batch)
                continue
            rt = _row_tables(d, None, len(g.subs), g.device)
            _sync_launch(mesh, gi, rt, _NO_SLOTS, _row_batch(rt[-1], g.device, *batch),
                         _NO_SLOT_COLS)
        return dev

    return match_counts, match_packed, apply_delta


def make_combine_probe_kernel(mesh: Mesh, mh: int):
    """K15, the combine-only probe of the reference's mesh microscope:
    probe(salt) builds one salted entry per shard on the device and
    runs exactly the match kernels' cross-shard reduction (K14's walk)
    over them. On a mesh whose one device holds every tile, one launch
    builds the buffers in the gathered layout and combines them; on
    several devices each builds its tiles, then they are gathered and
    K14 combines. Returns (ca, cb [n_dp, mh], total [n_dp, 1])."""
    n_dp, n_sub = mesh.shape[DP_AXIS], mesh.shape[SUB_AXIS]

    def buffers(g):
        n_tiles = len(g.tiles)
        return tuple(torch.empty(shape, dtype=torch.int32, device=g.device)
                     for shape in ((n_tiles, mh), (n_tiles, mh), (n_tiles,)))

    def probe(salt: int):
        g = mesh.groups[0]
        if len(mesh.groups) == 1 and g.device.type != "cpu":
            # the gathered rows are the tiles' buffers (_gather_sub's view)
            a, b, cnt = buffers(g)
            out = tuple(torch.empty(shape, dtype=torch.int32, device=g.device)
                        for shape in ((n_dp, mh), (n_dp, mh), (n_dp,)))
            _launch(_PROBE, g.device, _wrap32(salt), mesh.tile_table(0).data_ptr(),
                    len(g.tiles), n_sub, mh, *(x.data_ptr() for x in (a, b, cnt, *out)))
            return out[0], out[1], out[2].reshape(-1, 1)
        parts = []
        for gi, g in enumerate(mesh.groups):
            if g.device.type == "cpu":
                parts.append(combine_probe_ref(salt, _tiles(mesh, gi), mh, g.device))
                continue
            a, b, cnt = buffers(g)
            _launch(_PROBE, g.device, _wrap32(salt), mesh.tile_table(gi).data_ptr(),
                    len(g.tiles), n_sub, mh, a.data_ptr(), b.data_ptr(), cnt.data_ptr(),
                    None, None, None)
            parts.append((a, b, cnt))
        return _combine_pairs(mesh, parts, mh)

    return probe


def make_match_ids_kernel(mesh: Mesh, max_hits_per_block: int):
    """K16 + K14: every (dp, sub) tile matches its local [B/dp, N/sub]
    plane and compacts its hits to (topic, row) pairs with global ids;
    the shards then combine over sub on the device. match_ids(filters,
    topics) returns (ti [dp, mh], ri [dp, mh], totals [dp, 1]); slots
    are -1 past each dp block's count, and a block whose total exceeds
    max_hits_per_block overflowed (the caller escalates)."""
    mh = max_hits_per_block

    def match_ids(filters, topics):
        parts = [_tiles_match_ids(mesh, gi, filters[gi], topics[gi], mh)
                 for gi in range(len(mesh.groups))]
        return _combine_pairs(mesh, parts, mh)

    return match_ids


def make_sharded_hash_kernel(mesh: Mesh, max_hits_per_block: int,
                             n_buckets: Optional[int] = None):
    """K17 + K14: the pattern-class cuckoo probe with buckets split over
    sub. kernel(meta, slots, topics) -> (ti [dp, mh], bi [dp, mh],
    totals [dp, 1], amb [1, 1]): candidates combined over sub on the
    device, totals the summed flagged-pair counts (escalation), amb the
    mesh-wide ambiguity. `n_buckets` is the LOGICAL (power-of-two)
    bucket count, needed when the shards carry trailing pad buckets;
    None means n_sub times the shard width."""
    mh = max_hits_per_block
    n_sub = mesh.shape[SUB_AXIS]

    def kernel(meta, slots, topics):
        parts, ambs = [], []
        for gi, g in enumerate(mesh.groups):
            nb = n_buckets
            if nb is None:
                nb = slots[gi].probe.shape[0] // len(g.subs) * n_sub
            ti, bi, cnt, amb = _tiles_hash(mesh, gi, meta[gi], slots[gi], topics[gi], nb, mh)
            parts.append((ti, bi, cnt))
            ambs.append(amb)
        ca, cb, tot = _combine_pairs(mesh, parts, mh)
        return ca, cb, tot, _sum_to_primary(mesh, ambs).reshape(1, 1)

    return kernel


def make_slot_delta_kernel(mesh: Mesh):
    """K18's incremental cuckoo-slot sync: apply(sfp, sbkt, probe, idx,
    fpv, bktv, pwv) writes, in place, the slots and probe words each
    shard owns from [n_b, K] global slot ids; returns (sfp, sbkt,
    probe). The device arrays are per-group tuples (put_sub), the delta
    numpy arrays or placed per-group tuples. The fused mesh sync kernel
    with no rows."""
    n_sub = mesh.shape[SUB_AXIS]

    def apply(sfp, sbkt, probe, idx, fpv, bktv, pwv):
        cols = [_repl(mesh, a) for a in (idx, fpv, bktv, pwv)]
        for gi, g in enumerate(mesh.groups):
            sl = SlotArrays(sfp[gi], sbkt[gi], probe[gi])
            batch = [c[gi] for c in cols]
            if g.device.type == "cpu":
                scatter_owned_slots_ref(sl, g.subs, n_sub, *batch)
                continue
            _sync_launch(mesh, gi, _NO_ROWS, _slot_tables(sl, len(g.subs), g.device),
                         _NO_ROW_COLS, _slot_batch(g.device, *batch))
        return sfp, sbkt, probe

    return apply


def make_mesh_sync_kernel(mesh: Mesh):
    """K18's fused churn sync: a filter-row delta batch and a cuckoo-slot
    delta batch in ONE launch per device, each shard writing what it
    owns, in place. apply(dev, sfp, sbkt, probe, rows, words, plen, hh,
    rw, act, sidx, sfpv, sbktv, spwv) -> (dev, sfp, sbkt, probe)."""
    n_sub = mesh.shape[SUB_AXIS]

    def apply(dev, sfp, sbkt, probe, rows, words, plen, hh, rw, act,
              sidx, sfpv, sbktv, spwv):
        rcols = [_repl(mesh, a) for a in (rows, words, plen, hh, rw, act)]
        scols = [_repl(mesh, a) for a in (sidx, sfpv, sbktv, spwv)]
        for gi, g in enumerate(mesh.groups):
            sl = SlotArrays(sfp[gi], sbkt[gi], probe[gi])
            rb, sb = [c[gi] for c in rcols], [c[gi] for c in scols]
            if g.device.type == "cpu":
                scatter_owned_rows_ref(dev[gi], g.subs, n_sub, *rb)
                scatter_owned_slots_ref(sl, g.subs, n_sub, *sb)
                continue
            rt = _row_tables(dev[gi], None, len(g.subs), g.device)
            _sync_launch(mesh, gi, rt, _slot_tables(sl, len(g.subs), g.device),
                         _row_batch(rt[-1], g.device, *rb), _slot_batch(g.device, *sb))
        return dev, sfp, sbkt, probe

    return apply


# --- the mesh mirror of a FilterTable ------------------------------------------------


def _slot_cols(sa) -> Tuple[tuple, tuple, tuple]:
    """Per-group SlotArrays -> (fps, buckets, probes) per-group tuples."""
    return tuple(s.fp for s in sa), tuple(s.bucket for s in sa), tuple(s.probe for s in sa)


class ShardedDeviceTable:
    """Mesh-resident mirror of a FilterTable: rows sub-sharded across
    the mesh, topics dp-sharded, each delta sync one staged copy and one
    launch of the owned table sync a device group — DeviceTable's
    sync()/match surface over a mesh. With
    `index`, the pattern-class cuckoo table is ALSO mesh-resident
    (buckets sub-sharded) and match_hash runs K17; the dense kernel
    (K16) then serves only residual (unclassed) rows."""

    DELTA_BATCH = 1024  # rows per delta batch (syncer batch size)

    def __init__(
        self,
        table,
        mesh: Mesh,
        max_hits_per_block: int = 2048,
        index=None,
        telemetry=None,
    ) -> None:
        self.table = table
        self.mesh = mesh
        self.index = index
        self.telemetry = telemetry if telemetry is not None else _NULL_TEL
        self.device = mesh_mod.primary_device(mesh)
        # shard failure domain: `_mesh0` is the full layout; `lost_shards`
        # holds ORIGINAL sub columns evacuated off the mesh; `shard_gen`
        # bumps on every re-shard, so a handle begun on an older layout
        # can tell
        self._mesh0 = mesh
        self.lost_shards: set = set()
        self.shard_gen = 0
        self._dev: Optional[Tuple[EncodedFilters, ...]] = None
        self._synced_capacity = 0
        _mc, _mp, self._apply_delta = make_sharded_kernels(mesh)
        self._match_ids_cache: dict = {}
        self._hash_cache: dict = {}
        self.default_mh = max_hits_per_block
        # sticky escalation floor: the combined buffer budgets the SUM
        # of per-shard hits, so once a batch overflows every later batch
        # of the workload would too; the floor lasts as long as the layout
        self._mh_floor = 0
        self._dev_meta: Optional[Tuple[ClassMeta, ...]] = None
        self._dev_slots: Optional[Tuple[SlotArrays, ...]] = None
        self._dev_residual: Optional[Tuple[torch.Tensor, ...]] = None
        self._apply_slot_delta = make_slot_delta_kernel(mesh) if index is not None else None
        self._mesh_sync = make_mesh_sync_kernel(mesh) if index is not None else None
        self.fanout = None
        # chaos fault seam (chaos/faults.py), as DeviceTable's
        self.fault_injector = None
        # transfer chunk cap (ops/transfer.chunk_hits), as DeviceTable's
        self.transfer_chunk_hits: Optional[int] = None
        if self.telemetry.enabled:
            self.telemetry.set_gauge("mesh_shards", self.n_shards)

    def attach_fanout(self, store) -> None:
        """Mirror a CSR destination store for the resolve kernel (K5),
        which runs on the primary device: the only device that reads it."""
        self.fanout = FanoutDeviceState(store, mesh=self.mesh, telemetry=self.telemetry)

    @property
    def n_shards(self) -> int:
        return self.mesh.shape[SUB_AXIS]

    def shard_of_row(self, row: int) -> int:
        """The sub shard serving a table row (ceil-padded slices)."""
        return row // mesh_mod.shard_rows(self.table.capacity, self.mesh)

    def shard_of_slot(self, slot: int) -> int:
        """The sub shard serving a cuckoo slot (bucket-aligned slices)."""
        nb_loc = -(-self.index.n_buckets // self.n_shards)
        return slot // (nb_loc * BUCKET_W)

    # --- shard failure domain (chip loss / evacuation / rebalance) --------------

    def _survivor_mesh(self) -> Mesh:
        arr = self._mesh0.devices  # [n_dp, n_sub0]
        keep = [i for i in range(arr.shape[1]) if i not in self.lost_shards]
        return mesh_mod.make_mesh(
            n_dp=arr.shape[0], n_sub=len(keep), devices=arr[:, keep].reshape(-1).tolist())

    def evacuate_shard(self, shard: int) -> bool:
        """Drop one ORIGINAL sub column from the mesh and re-shard the
        table over the survivors (N-1 serving). The caller owns the
        follow-up `sync()`, a full re-upload from host truth. Returns True
        when the mesh changed. The shard joins `lost_shards` BEFORE the
        rebuild: the fault injector reads it, so the evacuation's resync
        already runs without touching the lost chip while its fault is
        live."""
        n_sub0 = self._mesh0.shape[SUB_AXIS]
        if shard < 0 or shard >= n_sub0 or shard in self.lost_shards:
            return False
        if len(self.lost_shards) + 1 >= n_sub0:
            raise RuntimeError(f"cannot evacuate shard {shard}: no survivor would remain")
        self.lost_shards.add(shard)
        self._rebuild_mesh(self._survivor_mesh())
        return True

    def restore_shard(self, shard: int) -> bool:
        """Rebalance a recovered chip back in: the full layout, or the
        wider survivor layout while other chips are still lost. The
        caller owns the follow-up full `sync()`."""
        if shard not in self.lost_shards:
            return False
        self.lost_shards.discard(shard)
        self._rebuild_mesh(self._mesh0 if not self.lost_shards else self._survivor_mesh())
        return True

    def _rebuild_mesh(self, mesh: Mesh) -> None:
        """Swap the serving mesh: drop every device tensor and every
        kernel closure of the old layout (a handle begun on it keeps
        what it launched against alive until it is finished), so the
        next sync() is a full re-upload from host truth, and re-mirror
        the fanout store. The old tensors go before anything of the new
        layout is allocated."""
        self._dev = None
        self._dev_meta = None
        self._dev_slots = None
        self._dev_residual = None
        self._synced_capacity = 0
        self._match_ids_cache.clear()
        self._hash_cache.clear()
        store = self.fanout.store if self.fanout is not None else None
        self.fanout = None
        self.mesh = mesh
        self.device = mesh_mod.primary_device(mesh)
        _mc, _mp, self._apply_delta = make_sharded_kernels(mesh)
        self._apply_slot_delta = make_slot_delta_kernel(mesh) if self.index is not None else None
        self._mesh_sync = make_mesh_sync_kernel(mesh) if self.index is not None else None
        if store is not None:
            self.attach_fanout(store)
        self.shard_gen += 1
        tel = self.telemetry
        if tel.enabled:
            tel.set_gauge("mesh_shards", self.n_shards)
            tel.set_gauge("shards_lost", len(self.lost_shards))

    # --- kernels by shape -------------------------------------------------------

    def _match_kernel(self, mh: int):
        k = self._match_ids_cache.get(mh)
        if k is None:
            k = self._match_ids_cache[mh] = make_match_ids_kernel(self.mesh, mh)
        return k

    def _hash_kernel(self, mh: int):
        # keyed on (mh, logical bucket count): growth changes the mask,
        # and on a padded layout it cannot be read off the shard width
        nb = self.index.n_buckets
        k = self._hash_cache.get((mh, nb))
        if k is None:
            k = self._hash_cache[(mh, nb)] = make_sharded_hash_kernel(self.mesh, mh, nb)
        return k

    # --- sync -------------------------------------------------------------------------

    def _put_sub(self, a: np.ndarray, pad_value=0) -> Tuple[torch.Tensor, ...]:
        n_sub = self.n_shards
        parts = mesh_mod.put_sub(a, self.mesh, pad_value)
        self._count_shard_rows(np.full(n_sub, -(-a.shape[0] // n_sub), np.int64))
        return parts

    def _count_shard_rows(self, per_shard) -> None:
        """Per-shard host->device rows
        (`mesh_shard_transfer_rows_total{shard=...}`): the combined fetch
        does not depend on the shard count, so upload skew shows here."""
        tel = self.telemetry
        if not tel.enabled:
            return
        for s, n in enumerate(per_shard.tolist()):
            if n:
                tel.count_labeled("mesh_shard_transfer_rows_total", {"shard": str(s)}, n)

    def _stage(self, a: np.ndarray) -> Tuple[torch.Tensor, ...]:
        return mesh_mod.put_repl(a, self.mesh)

    def _sync_index(self, full: bool) -> np.ndarray:
        """The index's whole-array uploads: the class metadata when it
        changed, the slot arrays after a rebuild, the residual mask on a
        full sync. Returns the dirty slot ids (sorted, distinct) that the
        delta's launch writes."""
        ix = self.index
        n_sub = self.n_shards
        # buckets per shard: ceil(n_buckets / n_sub); the trailing pad
        # buckets are inert (mesh.pad_slots) and the logical mask never
        # probes them
        if ix.meta_dirty or self._dev_meta is None:
            cols = [mesh_mod.put_repl(np.array(a), self.mesh) for a in ix.packed_meta()]
            self._dev_meta = tuple(ClassMeta(*c) for c in zip(*cols))
            ix.meta_dirty = False
        sids = _NO_IDS
        if ix.rebuilt or self._dev_slots is None:
            ix.dirty_slots.clear()
            fp, bkt = mesh_mod.pad_slots(np.array(ix.slots.fp), np.array(ix.slots.bucket), n_sub)
            cols = (self._put_sub(fp), self._put_sub(bkt), self._put_sub(np.array(ix.slots.probe)))
            self._dev_slots = tuple(SlotArrays(*c) for c in zip(*cols))
            ix.rebuilt = False
        elif ix.dirty_slots:
            sids = np.unique(np.asarray(ix.dirty_slots, np.int32))
            ix.dirty_slots.clear()
        if full or self._dev_residual is None:
            mask = np.zeros(self.table.capacity, bool)
            if ix.residual_rows:
                mask[list(ix.residual_rows)] = True
            self._dev_residual = self._put_sub(mask)
        # otherwise the delta's row side carries the mask's changes: a
        # row's residual flag changes only when the row is added or
        # removed, and such a row is always in the table's dirty list
        ix.residual_dirty = False
        return sids

    def sync(self) -> int:
        """Bring the mesh up to date; returns rows written."""
        fi = self.fault_injector
        if fi is not None:
            fi.check("sync")
        tel = self.telemetry
        t0 = tel.clock()
        pending = len(self.table.dirty)
        n, full = self._sync_impl()
        if tel.enabled and (n or full):
            tel.record_sync(rows=n, seconds=tel.clock() - t0, pending=pending, full=full)
            tel.observe_device_table(self)
        return n

    def _sync_impl(self) -> Tuple[int, bool]:
        """(rows written, was a full re-upload). A delta sync stages its
        dirty rows (with their residual bytes) and dirty slots in one
        buffer and applies it with one copy and one launch of the fused
        K13/K18 kernel per device group, or none when nothing is dirty;
        growth re-uploads the rows and the mask whole, a rebuild the
        slots."""
        t = self.table
        ix = self.index
        full = self._dev is None or t.grew or t.capacity != self._synced_capacity
        if full:
            n = len(t.dirty)
            t.drain_dirty()
            self._dev = mesh_mod.put_filters(t.snapshot(), self.mesh)
            self._synced_capacity = t.capacity
            rows = _NO_IDS
        else:
            rows = t.drain_dirty()
            n = len(rows)
        sids = _NO_IDS if ix is None else self._sync_index(full)
        n_r, n_s = len(rows), len(sids)
        if n_r + n_s == 0:
            return n, full
        # the reference's kernels and shape buckets (its pow2 batch
        # counts), so the telemetry reads the same
        tel = self.telemetry
        if n_r and n_s:
            tel.record_shape("mesh_sync", (self._n_batches(n_r), self._n_batches(n_s),
                                           t.capacity, t.max_levels, len(ix.slots.fp)))
        elif n_r:
            tel.record_shape("apply_delta", (self._n_batches(n_r), t.capacity, t.max_levels))
        else:
            tel.record_shape("mesh_slot_delta", (self._n_batches(n_s), len(ix.slots.fp)))
        if tel.enabled and n_r:
            tel.set_gauge("mesh_sync_batch_rows", n_r + n_s)
            n_sub = self.n_shards
            rs = mesh_mod.shard_rows(t.capacity, self.mesh)
            self._count_shard_rows(
                np.bincount(np.clip(rows // rs, 0, n_sub - 1), minlength=n_sub))
        staged = self._stage(pack_table_delta(
            t.snapshot(), rows, None if ix is None else ix.slots, sids,
            None if ix is None else ix.residual_rows,
        ))
        mesh_table_sync(self.mesh, self._dev, self._dev_slots if n_s else None,
                        self._dev_residual, staged, n_r, n_s)
        return n, full

    def _n_batches(self, n: int) -> int:
        """The reference's pow2 batch count for n sync entries."""
        return next_pow2(-(-n // self.DELTA_BATCH))

    # --- batched match: begin launches and starts the fetch, finish waits ----------

    def _block_mh(self) -> int:
        """Per-block hit capacity: the transfer chunk's floor power of
        two when one is set below the default, raised to the sticky
        escalation floor."""
        mh = self.default_mh
        cap = self.transfer_chunk_hits
        if cap is not None and mh > cap >= 1024:
            mh = 1 << (cap.bit_length() - 1)
        return max(mh, self._mh_floor)

    def _padded_batch(self, enc: EncodedTopics) -> int:
        b = int(enc.ids.shape[0])
        return b + (-b) % self.mesh.shape[DP_AXIS]

    @staticmethod
    def _batch_of(t_dev, mesh: Mesh) -> int:
        """The padded batch size of topics placed on `mesh`."""
        g = mesh.groups[0]
        return t_dev[0].ids.shape[0] // len(g.dps) * mesh.shape[DP_AXIS]

    def _filters(self, residual: bool) -> Tuple[EncodedFilters, ...]:
        """The filter tables, or views whose active mask covers only the
        residual (budget-overflow) rows. A delta sync rewrites the mask in
        place, as it does the rows: a begun batch's K16 launch precedes
        the next sync's launch on the group device's stream, so it reads
        the mask and rows it was launched against."""
        if not residual:
            return self._dev
        return tuple(d._replace(active=r) for d, r in zip(self._dev, self._dev_residual))

    def match_ids_begin(self, enc: EncodedTopics, residual: bool = False):
        """Launch the sharded dense compaction (K16 + K14) over the full
        table or the residual rows and begin the result copy. Returns a
        handle for match_ids_finish (ticket last)."""
        if self._dev is None:
            raise RuntimeError("sync() before matching")
        dev = self._filters(residual)
        t_dev = mesh_mod.put_topics(enc, self.mesh)
        mh = self._block_mh()
        self.telemetry.record_shape("mesh_match_ids", (self._padded_batch(enc), mh))
        out = self._match_kernel(mh)(dev, t_dev)
        STAGE_MARK.stage = "ticket_start"
        return (dev, t_dev, self.mesh, mh, transfer_ops.start_fetch(out, self.telemetry))

    def match_ids_finish(self, pending):
        """Wait for a begun dense match, escalating the per-block
        capacity while a dp block's total overflows it (sticky: the new
        capacity becomes the floor). Returns (ti, ri) host arrays of the
        valid pairs; ti may hold dp-padding topic indices."""
        dev, t_dev, mesh, mh, ticket = pending
        tel = self.telemetry
        t0 = tel.clock()
        ti, ri, totals = ticket.wait()
        while int(totals.max(initial=0)) > mh:
            tel.count("escalations_total")
            mh = max(mh * 2, 1 << int(totals.max()).bit_length())
            tel.record_shape("mesh_match_ids", (self._batch_of(t_dev, mesh), mh))
            self._mh_floor = max(self._mh_floor, mh)
            # a handle begun before a re-shard escalates on its own layout
            kernel = (self._match_kernel(mh) if mesh is self.mesh
                      else make_match_ids_kernel(mesh, mh))
            ti, ri, totals = transfer_ops.start_fetch(kernel(dev, t_dev), tel).wait()
        ti = ti.reshape(-1)
        ri = ri.reshape(-1)
        keep = ti >= 0
        if tel.enabled:
            tel.observe_family("mesh_combine_seconds", tel.clock() - t0)
        return ti[keep], ri[keep]

    def match_ids(self, enc: EncodedTopics, residual: bool = False):
        """(ti, ri) of every (topic, row) hit through the dense kernels."""
        return self.match_ids_finish(self.match_ids_begin(enc, residual))

    def match_hash_begin(self, enc: EncodedTopics):
        """Launch the sharded hash kernel (K17 + K14) and begin the
        result copy. Returns a handle for match_hash_finish (ticket
        last)."""
        if self._dev_slots is None:
            raise RuntimeError("sync() before matching")
        t_dev = mesh_mod.put_topics(enc, self.mesh)
        mh = self._block_mh()
        self.telemetry.record_shape("mesh_match_ids_hash", (self._padded_batch(enc), mh))
        meta, slots = self._dev_meta, self._dev_slots
        out = self._hash_kernel(mh)(meta, slots, t_dev)
        STAGE_MARK.stage = "ticket_start"
        return (meta, slots, t_dev, self.mesh, self.index.n_buckets, mh,
                transfer_ops.start_fetch(out, self.telemetry))

    def match_hash_finish(self, pending):
        """Wait for a begun hash match, escalating as match_ids_finish
        does. Returns (ti, bi, amb): the valid (topic, bucket id)
        candidates (ti may hold dp-padding topics) and the mesh-wide
        ambiguity count (amb > 0: the caller re-matches on the host)."""
        meta, slots, t_dev, mesh, nb, mh, ticket = pending
        tel = self.telemetry
        t0 = tel.clock()
        ti, bi, totals, amb = ticket.wait()
        while int(totals.max(initial=0)) > mh:
            tel.count("hash_overflow_retries_total")
            mh = max(mh * 2, 1 << int(totals.max()).bit_length())
            tel.record_shape("mesh_match_ids_hash", (self._batch_of(t_dev, mesh), mh))
            self._mh_floor = max(self._mh_floor, mh)
            # a handle begun before a re-shard or a growth escalates on
            # the layout and bucket count it was launched against
            kernel = (self._hash_kernel(mh)
                      if mesh is self.mesh and nb == self.index.n_buckets
                      else make_sharded_hash_kernel(mesh, mh, nb))
            ti, bi, totals, amb = transfer_ops.start_fetch(
                kernel(meta, slots, t_dev), tel).wait()
        ti = ti.reshape(-1)
        bi = bi.reshape(-1)
        keep = ti >= 0
        if tel.enabled:
            tel.observe_family("mesh_combine_seconds", tel.clock() - t0)
        return ti[keep], bi[keep], int(amb.reshape(-1)[0])

    def match_hash(self, enc: EncodedTopics):
        """(ti, bi, amb) through the sharded hash kernel."""
        return self.match_hash_finish(self.match_hash_begin(enc))

    # --- warm-up -------------------------------------------------------------------

    def warmup_deltas(self) -> int:
        """Run the reference-shaped churn sync wrappers (row delta, slot
        delta, fused: each a launch of the one mesh table sync kernel) at
        their small batch shapes (1 and 2 batches) once, so the first
        serve-time churn finds the kernel built and the reference's shape
        keys recorded.
        Re-applies row/slot 0's current host truth: every launch is a
        no-op on the data. Needs a completed full sync; returns the
        launches made."""
        if self._dev is None:
            return 0
        t = self.table
        k = self.DELTA_BATCH
        tel = self.telemetry
        stage = self._stage
        warmed = 0
        for n_b in (1, 2):
            idx = np.zeros((n_b, k), np.int32)
            row_args = (
                stage(idx), stage(t.words[idx]), stage(t.prefix_len[idx]),
                stage(t.has_hash[idx]), stage(t.root_wild[idx]), stage(t.active[idx]),
            )
            tel.record_shape("apply_delta", (n_b, t.capacity, t.max_levels))
            self._apply_delta(self._dev, *row_args)
            warmed += 1
            ix = self.index
            if ix is None or self._dev_slots is None:
                continue
            slot_args = (
                stage(idx), stage(ix.slots.fp[idx]), stage(ix.slots.bucket[idx]),
                stage(ix.slots.probe[idx // BUCKET_W]),
            )
            tel.record_shape("mesh_slot_delta", (n_b, len(ix.slots.fp)))
            self._apply_slot_delta(*_slot_cols(self._dev_slots), *slot_args)
            warmed += 1
            tel.record_shape(
                "mesh_sync", (n_b, n_b, t.capacity, t.max_levels, len(ix.slots.fp))
            )
            self._mesh_sync(self._dev, *_slot_cols(self._dev_slots), *row_args, *slot_args)
            warmed += 1
        return warmed

    def warmup_escalated(self, enc: EncodedTopics) -> int:
        """Launch both match kernels once at twice the current block
        capacity for this batch shape, so a serve-time overflow finds the
        first escalation step's shape key recorded. Results are dropped
        unfetched."""
        if self._dev is None:
            return 0
        t_dev = mesh_mod.put_topics(enc, self.mesh)
        b = self._padded_batch(enc)
        mh2 = self._block_mh() * 2
        self.telemetry.record_shape("mesh_match_ids", (b, mh2))
        self._match_kernel(mh2)(self._dev, t_dev)
        warmed = 1
        if self._dev_slots is not None:
            self.telemetry.record_shape("mesh_match_ids_hash", (b, mh2))
            self._hash_kernel(mh2)(self._dev_meta, self._dev_slots, t_dev)
            warmed += 1
        return warmed
