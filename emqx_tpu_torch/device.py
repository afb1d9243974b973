"""Device selection: CUDA by default, the CPU only when asked for."""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[None, str, torch.device]


class NoCudaDevice(RuntimeError):
    """The caller asked for (or defaulted to) CUDA and none is present."""


def resolve(device: DeviceLike = None) -> torch.device:
    """`None` means the current CUDA device. A CUDA request raises
    NoCudaDevice when no card is visible; there is no silent CPU
    fallback. `"cpu"` is honoured as given (tests, host-only runs)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoCudaDevice(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy -> a contiguous COPY on `device` (never a view of the host
    array, also on the CPU), dtype kept; uint32 moves as its int32 bit
    pattern, which every copy path supports. Non-blocking: the host
    array is staged at once, so the caller may mutate it afterwards."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        t = torch.from_numpy(a.view(np.int32))
        return t.to(device, non_blocking=True, copy=True).view(torch.uint32)
    return torch.from_numpy(a).to(device, non_blocking=True, copy=True)
