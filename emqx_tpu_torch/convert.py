"""Carry host state across to the port's device tensors.

This system has no model weights; its counterpart of weight conversion
is the route table. `device_state_from_numpy` takes the host arrays
that emqx_tpu's (or the port's own) host side keeps — the filter table
snapshot (`FilterTable.snapshot()`), the packed class meta
(`ClassIndex.packed_meta()`), the cuckoo slots (`ClassIndex.slots`) and
the residual-row mask — and returns the tensors the port's kernels
read, so both implementations can compute on identical state.
`fanout_state_from_numpy` does the same for the CSR destination table
(`DestStore.seg_off/seg_len/edge_client/edge_opts`) that the fanout
kernels read, and `retained_state_from_numpy` for a retained index's
cuckoo table (`RetainedIndex._slots`) that K8 reads.
`mesh_state_from_numpy` lays the same route-table arrays onto a port
mesh (parallel/mesh.py) with the reference ShardedDeviceTable's padding:
trailing inert rows, bucket-aligned inert slots.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve, to_device
from .ops.hash_index import ClassMeta, SlotArrays
from .ops.table import EncodedFilters
from .parallel import mesh as mesh_mod


class DeviceState(NamedTuple):
    filters: EncodedFilters
    meta: ClassMeta
    slots: SlotArrays
    residual: torch.Tensor  # bool [capacity]


def device_state_from_numpy(
    filters, class_meta, slots, residual_mask, device: DeviceLike = None
) -> DeviceState:
    """Host arrays (any sequence-of-arrays in the field order of
    EncodedFilters / ClassMeta / SlotArrays) -> device tensors. Copies:
    the host arrays stay the host's to mutate."""
    dev = resolve(device)

    def put(a):
        return to_device(np.asarray(a), dev)

    return DeviceState(
        EncodedFilters(*(put(a) for a in filters)),
        ClassMeta(*(put(a) for a in class_meta)),
        SlotArrays(*(put(a) for a in slots)),
        put(np.asarray(residual_mask, bool)),
    )


class FanoutState(NamedTuple):
    seg_off: torch.Tensor  # int32 [C]
    seg_len: torch.Tensor  # int32 [C]
    edge_client: torch.Tensor  # int32 [E]
    edge_opts: torch.Tensor  # int32 [E]


def fanout_state_from_numpy(
    seg_off, seg_len, edge_client, edge_opts, device: DeviceLike = None
) -> FanoutState:
    """A DestStore's host CSR arrays -> int32 device tensors (copies),
    the inputs of resolve_fanout and fanout_sync."""
    dev = resolve(device)

    def put(a):
        return to_device(np.asarray(a, np.int32), dev)

    return FanoutState(put(seg_off), put(seg_len), put(edge_client), put(edge_opts))


class RetainedState(NamedTuple):
    probe: torch.Tensor  # uint32 [n_buckets]
    fp: torch.Tensor  # uint32 [n_buckets*4]
    bucket: torch.Tensor  # int32 [n_buckets*4]


def retained_state_from_numpy(probe, fp, bucket, device: DeviceLike = None) -> RetainedState:
    """A RetainedIndex's host SlotArrays (the JAX package's or the
    port's) -> the (probe, fp, bucket) device tensors, in the argument
    order of `ops.retained.probe_retained`. Copies."""
    dev = resolve(device)
    return RetainedState(
        to_device(np.asarray(probe, np.uint32), dev),
        to_device(np.asarray(fp, np.uint32), dev),
        to_device(np.asarray(bucket, np.int32), dev),
    )


class MeshState(NamedTuple):
    """Device state of a mesh table, one entry per mesh group (the
    distinct devices, parallel/mesh.py): sub-sharded filters, slots and
    residual mask; replicated class meta."""

    filters: Tuple[EncodedFilters, ...]
    meta: Tuple[ClassMeta, ...]
    slots: Tuple[SlotArrays, ...]
    residual: Tuple[torch.Tensor, ...]


def mesh_state_from_numpy(filters, class_meta, slots, residual_mask, mesh) -> MeshState:
    """Host arrays (as for device_state_from_numpy; the slots' fp and
    bucket flat over all buckets) -> a MeshState on `mesh`, padded as
    the reference's ShardedDeviceTable pads: filter rows and the
    residual mask trail-padded to a multiple of n_sub with inert zeros,
    slots padded to whole buckets per shard (fp 0, bucket -1). Copies."""
    n_sub = mesh.shape[mesh_mod.SUB_AXIS]
    fp, bucket, probe = (np.asarray(a) for a in slots)
    fp, bucket = mesh_mod.pad_slots(fp.astype(np.uint32), bucket.astype(np.int32), n_sub)
    slot_cols = (mesh_mod.put_sub(fp, mesh), mesh_mod.put_sub(bucket, mesh),
                 mesh_mod.put_sub(probe.astype(np.uint32), mesh))
    meta_cols = [mesh_mod.put_repl(np.asarray(a), mesh) for a in class_meta]
    return MeshState(
        mesh_mod.put_filters(EncodedFilters(*(np.asarray(a) for a in filters)), mesh),
        tuple(ClassMeta(*c) for c in zip(*meta_cols)),
        tuple(SlotArrays(*c) for c in zip(*slot_cols)),
        mesh_mod.put_sub(np.asarray(residual_mask, bool), mesh),
    )
