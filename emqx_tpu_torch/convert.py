"""Carry host state across to the port's device tensors.

This system has no model weights; its counterpart of weight conversion
is the route table. `device_state_from_numpy` takes the host arrays
that emqx_tpu's (or the port's own) host side keeps — the filter table
snapshot (`FilterTable.snapshot()`), the packed class meta
(`ClassIndex.packed_meta()`), the cuckoo slots (`ClassIndex.slots`) and
the residual-row mask — and returns the tensors the port's kernels
read, so both implementations can compute on identical state.
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
