"""Device mesh and shard layout for the sub-sharded routing path (the
port's counterpart of emqx_tpu/parallel/mesh.py).

A mesh is a [n_dp, n_sub] grid of torch devices driven by ONE process,
as JAX's mesh is single-controller:

    dp   — topic-batch data parallelism (the publish batch is split)
    sub  — subscription-table model parallelism (filter rows and cuckoo
           buckets are split)

A device may appear more than once: several shards then share it (the
tests build a CPU mesh from `devices=["cpu"] * 8`; one card can hold all
eight shards of a (2, 4) mesh).

Layout, for the shards each distinct device holds (a `Group`):

  * a SUB-SHARDED array is the global array, trailing-padded to a
    multiple of n_sub, split into n_sub equal contiguous slices; shard
    s holds global positions [s * local, (s + 1) * local). A device
    keeps the slices of the sub shards it holds in ONE tensor, back to
    back in sub order — on a device that holds every shard, the padded
    global array itself;
  * a DP-SHARDED topic batch is padded to a multiple of n_dp with inert
    rows and split the same way over dp; a device keeps its dp blocks
    back to back in dp order;
  * a REPLICATED array is kept once per distinct device.

Each sharded value is a tuple with one entry per group, in
`Mesh.groups` order. A per-shard program launches once per group over
that group's tiles: tile (dp_i, sub_i) reads its slices at
(dp_pos, sub_pos), their positions in the group's tensors
(`Mesh.tile_table`), and computes global ids from (dp_i, sub_i) as the
shard_map bodies compute them (`axis_index * local size`).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, NoCudaDevice, resolve, to_device
from ..ops.match import EncodedTopics
from ..ops.table import EncodedFilters

DP_AXIS = "dp"
SUB_AXIS = "sub"


class Group(NamedTuple):
    """The shards one distinct device holds."""

    device: torch.device
    tiles: Tuple[Tuple[int, int], ...]  # (dp_i, sub_i), row-major
    dps: Tuple[int, ...]  # dp blocks held, ascending
    subs: Tuple[int, ...]  # sub shards held, ascending


class Mesh:
    """A [n_dp, n_sub] grid of torch devices (`devices`, an object
    array) with the reference's `shape` dict keyed "dp" and "sub"."""

    def __init__(self, devices: np.ndarray) -> None:
        n_dp, n_sub = devices.shape
        self.devices = devices
        self.shape: Dict[str, int] = {DP_AXIS: n_dp, SUB_AXIS: n_sub}
        order = []
        for d in devices.reshape(-1):
            if d not in order:
                order.append(d)
        groups = []
        for d in order:
            tiles = tuple(
                (i, j) for i in range(n_dp) for j in range(n_sub)
                if devices[i, j] == d
            )
            groups.append(Group(
                d, tiles,
                tuple(sorted({i for i, _ in tiles})),
                tuple(sorted({j for _, j in tiles})),
            ))
        self.groups: Tuple[Group, ...] = tuple(groups)
        self._tile_tables: Dict[int, torch.Tensor] = {}
        self._sub_pos: Dict[int, torch.Tensor] = {}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(g.device) for g in self.groups]})"

    def tile_table(self, gi: int) -> torch.Tensor:
        """int32 [n_tiles, 4] on group gi's device: per tile (dp_i,
        sub_i, dp_pos, sub_pos). Built once."""
        t = self._tile_tables.get(gi)
        if t is None:
            g = self.groups[gi]
            rows = [(i, j, g.dps.index(i), g.subs.index(j)) for i, j in g.tiles]
            t = to_device(np.array(rows, np.int32).reshape(-1, 4), g.device)
            self._tile_tables[gi] = t
        return t

    def sub_pos(self, gi: int) -> torch.Tensor:
        """int32 [n_sub] on group gi's device: each sub shard's position
        in the group's tensors, -1 for a shard it does not hold (the
        owner map of the delta sync; the identity for a group that holds
        every shard in order). Built once."""
        t = self._sub_pos.get(gi)
        if t is None:
            g = self.groups[gi]
            n_sub = self.shape[SUB_AXIS]
            pos = np.full(n_sub, -1, np.int32)
            pos[list(g.subs)] = np.arange(len(g.subs), dtype=np.int32)
            t = to_device(pos, g.device)
            self._sub_pos[gi] = t
        return t

    def locate(self, dp_i: int, sub_i: int) -> Tuple[int, int]:
        """(group index, tile position in that group) of a tile."""
        d = self.devices[dp_i, sub_i]
        for gi, g in enumerate(self.groups):
            if g.device == d:
                return gi, g.tiles.index((dp_i, sub_i))
        raise KeyError((dp_i, sub_i))


def make_mesh(
    n_dp: Optional[int] = None,
    n_sub: Optional[int] = None,
    devices: Optional[Sequence[DeviceLike]] = None,
) -> Mesh:
    """Build a (dp, sub) mesh over the given (default: every visible
    CUDA) devices. With neither count given, shards the subscription
    axis (n_dp=1), as the reference does: table memory is the reason
    to spread at all. A device may repeat. Raises NoCudaDevice when no
    devices are given and no CUDA device is visible."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise NoCudaDevice(
                "no CUDA device is available; pass devices=['cpu'] * n to "
                "build a mesh on the host"
            )
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [resolve(d) for d in devices]
    n = len(devs)
    if n_dp is None and n_sub is None:
        n_dp, n_sub = 1, n
    elif n_dp is None:
        if n % n_sub:
            raise ValueError(f"{n} devices do not split into n_sub={n_sub}")
        n_dp = n // n_sub
    elif n_sub is None:
        if n % n_dp:
            raise ValueError(f"{n} devices do not split into n_dp={n_dp}")
        n_sub = n // n_dp
    if n_dp * n_sub != n:
        raise ValueError(f"mesh ({n_dp}, {n_sub}) needs {n_dp * n_sub} devices, got {n}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(np.asarray(arr).reshape(n_dp, n_sub))


def primary_device(mesh: Mesh) -> torch.device:
    """The mesh's first device: where the fanout resolve (K5) runs and
    where combined results land."""
    return np.asarray(mesh.devices).reshape(-1)[0]


def shard_rows(n: int, mesh: Mesh) -> int:
    """Rows per sub shard of an n-row table: ceil(n / n_sub). The
    trailing `shard_rows * n_sub - n` positions are inert padding, so a
    padded-global position equals the logical id of every real row."""
    return -(-n // mesh.shape[SUB_AXIS])


def pad_rows(a: np.ndarray, n_sub: int, pad_value=0) -> np.ndarray:
    """Trailing-pad the leading axis to a multiple of n_sub."""
    pad = (-a.shape[0]) % n_sub
    if not pad:
        return a
    width = ((0, pad),) + ((0, 0),) * (a.ndim - 1)
    return np.pad(a, width, constant_values=pad_value)


def pad_slots(fp: np.ndarray, bucket: np.ndarray, n_sub: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad flat cuckoo slot arrays ([n_buckets * 4]) so they split into
    n_sub bucket-aligned shards of ceil(n_buckets / n_sub) buckets: the
    pad slots are inert (fp 0 never byte-matches, bucket -1 is empty).
    The probe words need no help: put_sub's plain pad gives the same
    bucket count."""
    n_buckets = fp.shape[0] // 4
    pad = ((-n_buckets) % n_sub) * 4
    if pad:
        fp = np.pad(fp, (0, pad))
        bucket = np.pad(bucket, (0, pad), constant_values=-1)
    return fp, bucket


def put_sub(a: np.ndarray, mesh: Mesh, pad_value=0) -> Tuple[torch.Tensor, ...]:
    """Sub-shard a host array (trailing pad with `pad_value`): one
    tensor per group holding its sub shards back to back."""
    n_sub = mesh.shape[SUB_AXIS]
    a = pad_rows(a, n_sub, pad_value)
    local = a.shape[0] // n_sub
    out = []
    for g in mesh.groups:
        if g.subs == tuple(range(n_sub)):
            part = a
        else:
            part = np.concatenate([a[s * local:(s + 1) * local] for s in g.subs])
        out.append(to_device(part, g.device))
    return tuple(out)


def put_repl(a: np.ndarray, mesh: Mesh) -> Tuple[torch.Tensor, ...]:
    """One copy of a host array on every distinct device."""
    return tuple(to_device(a, g.device) for g in mesh.groups)


def put_filters(filters: EncodedFilters, mesh: Mesh) -> Tuple[EncodedFilters, ...]:
    """Place a host filter-table snapshot on the mesh, rows split over
    sub. Row counts that n_sub does not divide get trailing inert pad
    rows (zeros, active=False: they never match)."""
    cols = [put_sub(a, mesh) for a in filters]
    return tuple(EncodedFilters(*c) for c in zip(*cols))


def pad_topics(enc: EncodedTopics, mesh: Mesh) -> EncodedTopics:
    """Host half of `put_topics`: pad the batch to a multiple of n_dp.
    Pad rows are $-rooted with zero levels, so they match nothing and
    burn no hit slots against '#' filters; a padded batch passes
    through unchanged."""
    n_dp = mesh.shape[DP_AXIS]
    pad = (-enc.ids.shape[0]) % n_dp
    if pad:
        enc = EncodedTopics(
            np.pad(enc.ids, ((0, pad), (0, 0))),
            np.pad(enc.lens, (0, pad)),
            np.pad(enc.dollar, (0, pad), constant_values=True),
        )
    return enc


def put_topics(enc: EncodedTopics, mesh: Mesh) -> Tuple[EncodedTopics, ...]:
    """Place an encoded topic batch on the mesh, batch split over dp
    (padded first): one EncodedTopics per group holding its dp blocks
    back to back."""
    enc = pad_topics(enc, mesh)
    n_dp = mesh.shape[DP_AXIS]
    b_loc = enc.ids.shape[0] // n_dp
    out = []
    for g in mesh.groups:
        if g.dps == tuple(range(n_dp)):
            cols = enc
        else:
            cols = [np.concatenate([a[i * b_loc:(i + 1) * b_loc] for i in g.dps])
                    for a in enc]
        out.append(EncodedTopics(*(to_device(a, g.device) for a in cols)))
    return tuple(out)


def shard(parts: Sequence[torch.Tensor], mesh: Mesh, dp_i: int, sub_i: int) -> torch.Tensor:
    """The slice of sub shard sub_i that tile (dp_i, sub_i)'s device
    holds, as a view of a sub-sharded value's group tensor."""
    gi, _ = mesh.locate(dp_i, sub_i)
    g = mesh.groups[gi]
    t = parts[gi]
    local = t.shape[0] // len(g.subs)
    k = g.subs.index(sub_i)
    return t[k * local:(k + 1) * local]
