"""The staged table delta: one buffer that carries a filter table's and a
cuckoo index's whole delta sync to the card in one copy.

Both mirrors of a FilterTable stage their churn with it: the single-device
`models.router.DeviceTable` (the fused K3/K4 kernel, `table_sync`) and the
mesh's `parallel.sharded_match.ShardedDeviceTable` (the fused K13/K18
kernel, `mesh_table_sync`). The packing here is host numpy only; the
caller places the buffer, once per device it syncs.

Layout (`table_delta_layout`), n_r row entries and n_s slot entries, no
padding of either side:

    rows i32 [n_r] | prefix_len i32 [n_r] | has_hash, root_wild, active,
    residual (bytes, [n_r] each) | pad to 16 B | words i32 [n_r, L] |
    slots i32 [n_s] | fp u32 [n_s] | bucket i32 [n_s] | probe u32 [n_s]

The residual byte is `row in residual_rows`: a row's residual flag
changes only when the row is added or removed, and such a row is always
in the delta, so the byte keeps the device's residual mask exact. The
words start on a 16-byte boundary of the buffer.
"""

from __future__ import annotations

from typing import Optional, Set, Tuple

import numpy as np
import torch

from .table import EncodedFilters


def table_delta_layout(n_r: int, levels: int, n_s: int) -> Tuple[int, int, int]:
    """Byte offsets of a staged table delta: (words, slots, total)."""
    w_off = -(-12 * n_r // 16) * 16
    s_off = w_off + 4 * n_r * levels
    return w_off, s_off, s_off + 16 * n_s


def staged_columns(staged: torch.Tensor, n_r: int, levels: int, n_s: int):
    """The row side's eight columns (rows, words, prefix_len, has_hash,
    root_wild, active, residual) and the slot side's four (slots, fp,
    bucket, probe), as views of a staged delta."""
    w_off, s_off, total = table_delta_layout(n_r, levels, n_s)
    i32 = staged[: 8 * n_r].view(torch.int32).view(2, n_r)
    flags = staged[8 * n_r : 12 * n_r].view(torch.bool).view(4, n_r)
    words = staged[w_off:s_off].view(torch.int32).view(n_r, levels)
    sl = staged[s_off:total].view(torch.int32).view(4, n_s)
    rows = (i32[0], words, i32[1], flags[0], flags[1], flags[2], flags[3])
    return rows, (sl[0], sl[1].view(torch.uint32), sl[2], sl[3].view(torch.uint32))


def pack_table_delta(
    host: EncodedFilters,
    rows: np.ndarray,
    slots,
    sids: np.ndarray,
    residual_rows: Optional[Set[int]],
) -> np.ndarray:
    """One uint8 host buffer in the staged layout: the host table's
    columns at `rows` and the slot arrays (`SlotArrays` of numpy) at
    `sids` (both sorted and distinct), and each row's residual byte
    (0 without an index)."""
    n_r, n_s = len(rows), len(sids)
    levels = host.words.shape[1]
    w_off, s_off, total = table_delta_layout(n_r, levels, n_s)
    buf = np.empty(total, np.uint8)
    i32 = buf[: 8 * n_r].view(np.int32).reshape(2, n_r)
    i32[0] = rows
    np.take(host.prefix_len, rows, out=i32[1])
    flags = buf[8 * n_r : 12 * n_r].view(np.bool_).reshape(4, n_r)
    np.take(host.has_hash, rows, out=flags[0])
    np.take(host.root_wild, rows, out=flags[1])
    np.take(host.active, rows, out=flags[2])
    flags[3] = False
    if residual_rows and n_r:
        hit = residual_rows.intersection(rows.tolist())
        if hit:
            flags[3][np.searchsorted(rows, np.fromiter(hit, np.int64, len(hit)))] = True
    buf[12 * n_r : w_off] = 0
    np.take(host.words, rows, axis=0,
            out=buf[w_off:s_off].view(np.int32).reshape(n_r, levels))
    sl = buf[s_off:].view(np.int32).reshape(4, n_s)
    if n_s:
        sl[0] = sids
        np.take(slots.fp, sids, out=sl[1].view(np.uint32))
        np.take(slots.bucket, sids, out=sl[2])
        np.take(slots.probe, sids >> 2, out=sl[3].view(np.uint32))
    return buf
