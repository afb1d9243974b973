"""Device→host transfer discipline for the port (counterpart of
emqx_tpu/ops/transfer.py `FetchTicket`/`start_fetch`/`chunk_hits`).

  * `FetchTicket` — issued at LAUNCH time (the `begin` halves): copies
    each CUDA result tensor into a pinned host tensor with
    `non_blocking=True` on the current stream and records a
    `torch.cuda.Event` behind the copies, so the device→host DMA is in
    flight while the host encodes the next batch. `ready()` is
    `event.query()` (never blocks); `wait()` is `event.synchronize()`
    and then pays only the *residual* transfer time. CPU tensors pass
    straight through.

  * `auto_chunk_kb` / `chunk_hits` — turn a link's bandwidth-delay
    product into a cap on the compacted-pair result buffers, so one
    fetch is never sized past what the link streams in one RTT;
    oversize results escalate through the exact-size retry. Nothing
    in the port sets such a cap yet: the link probe that measures the
    RTT and bandwidth is not ported.

Telemetry (through the router's collector): `transfer_seconds`
(family: residual wait paid at finish), `transfer_bytes` (counter),
`transfer_inflight` (gauge: tickets issued but not yet collected).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs.kernel_telemetry import NULL as _NULL_TEL

# chunk clamp (KB): the auto-sizer never goes below one sync batch of
# compacted pairs nor above what a single ring slot should pin in
# host memory
MIN_CHUNK_KB = 64
MAX_CHUNK_KB = 4096

# bytes per compacted hit: two int32 result lanes (topic idx, row/bkt)
_BYTES_PER_HIT = 8


class FetchTicket:
    """One begun device→host fetch: the async copies are issued at
    construction (launch time), `wait()` returns the host numpy arrays
    exactly once (idempotent afterwards)."""

    __slots__ = (
        "host", "event", "nbytes", "telemetry", "waited", "_out",
        "land_clock", "landed_at",
    )

    def __init__(self, tensors: Sequence[torch.Tensor], telemetry=None) -> None:
        tel = telemetry if telemetry is not None else _NULL_TEL
        self.telemetry = tel
        # residual wall seconds the wait() actually blocked
        self.waited = 0.0
        # land hook: when a clock is installed at launch, the first
        # ready()==True observation (or the forced wait) stamps the
        # land time
        self.land_clock = None
        self.landed_at: Optional[float] = None
        self._out: Optional[Tuple[np.ndarray, ...]] = None
        self.event = None
        host = []
        nb = 0
        for t in tensors:
            if t.device.type == "cuda":
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                host.append(h)
            else:
                host.append(t)
            nb += t.nbytes
        if any(t.device.type == "cuda" for t in tensors):
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream())
        self.host = tuple(host)
        self.nbytes = nb
        if tel.enabled:
            tel.count("transfer_bytes", nb)
            tel.add_gauge("transfer_inflight", 1)

    def ready(self) -> bool:
        """True when every buffer has landed host-side (wait() will
        not block)."""
        if self._out is not None:
            return True
        if self.event is not None and not self.event.query():
            return False
        if self.land_clock is not None and self.landed_at is None:
            self.landed_at = self.land_clock()
        return True

    def wait(self) -> Tuple[np.ndarray, ...]:
        """Force the transfer (idempotent). The observed duration is
        the RESIDUAL wait — with healthy overlap it approaches zero."""
        out = self._out
        if out is not None:
            return out
        tel = self.telemetry
        t0 = tel.clock()
        if self.event is not None:
            self.event.synchronize()
        out = self._out = tuple(h.numpy() for h in self.host)
        self.waited = tel.clock() - t0
        if self.land_clock is not None and self.landed_at is None:
            self.landed_at = self.land_clock()
        if tel.enabled:
            tel.observe_family("transfer_seconds", self.waited)
            tel.add_gauge("transfer_inflight", -1)
        return out


def start_fetch(tensors: Sequence[torch.Tensor], telemetry=None) -> FetchTicket:
    """Begin-half entry: enqueue the device→host copies for a just-
    launched kernel's result tensors and hand back the ticket the
    finish half waits on."""
    return FetchTicket(tensors, telemetry)


def auto_chunk_kb(rtt_s: float, bytes_per_s: float) -> int:
    """Bandwidth-delay product, clamped: the largest transfer that
    still fits inside one link RTT."""
    bdp = rtt_s * bytes_per_s
    return int(min(MAX_CHUNK_KB, max(MIN_CHUNK_KB, bdp / 1024.0)))


def chunk_hits(chunk_kb: float) -> Optional[int]:
    """Translate a chunk budget into a max_hits cap for the compacted
    (topic, row) result buffers (two int32 lanes per hit). None / 0
    means uncapped."""
    if not chunk_kb:
        return None
    return max(1024, int(chunk_kb * 1024) // _BYTES_PER_HIT)
