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
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .device import DeviceLike, resolve, to_device
from .ops.hash_index import ClassMeta, SlotArrays
from .ops.table import EncodedFilters


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
    the inputs of resolve_fanout / scatter_segs / scatter_edges."""
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
