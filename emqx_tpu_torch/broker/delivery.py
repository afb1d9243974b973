"""Delivery-ledger seam: native QoS bookkeeping with a Python twin
(the port's copy of emqx_tpu/broker/delivery.py).

The per-session numeric state of `broker/session.py` — the inflight
window (packet id, ack phase, dup, sent_at), the wraparound packet-id
allocator, the QoS1/2 retry sweep and the priority-aware mqueue
overflow decision — is pure integer bookkeeping the Python interpreter
pays object-model tax on for every delivered message. This seam moves
it behind one process-global ledger with two interchangeable
implementations:

  * `NativeDeliveryLedger` — the `delivery_*` legs of the port's
    speedups.cc (`_emqx_torch_speedups`, built by emqx_tpu_torch/native),
    slot arrays behind a capsule handle with the same discipline as the
    route-churn core; the default, and a failed build or probe raises;
  * `PyDeliveryLedger` — the bit-exact Python twin, selected only by
    `set_native_enabled(False)`.

Sessions keep owning the *messages* (`Session.inflight` stays the
pid -> entry mapping, `Session.mqueue` stays the real deque); the
ledger owns only the numbers, and config scalars ride each call so
`SessionConfig` stays authoritative. `DELIVERY_METRICS` counts the
sessions bound to each implementation.

Inflight phases are encoded 0 = awaiting PUBACK, 1 = awaiting PUBREC,
2 = awaiting PUBCOMP; ack kinds use the same codes.  `enqueue` returns
a packed decision over the (priority, qos) shadow queue:

  bits 0..1   action: 0 drop the incoming message, 1 admit,
              2 admit after evicting the victim
  bits 2..31  insert index (post-eviction queue coordinates)
  bits 32+    victim index (action 2 only, pre-eviction coordinates)
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from .. import native
from ..native import NativeBuildError

PHASE_PUBACK = 0
PHASE_PUBREC = 1
PHASE_PUBCOMP = 2

PHASE_NAMES = ("puback", "pubrec", "pubcomp")

_mod = None
_enabled = True


class DeliveryMetrics:
    """Process-global delivery-ledger counters: the sessions bound to
    each implementation. Plain unlocked ints under the GIL; tests and
    chip_smoke.py assert deltas."""

    def __init__(self) -> None:
        self.sessions_native = 0
        self.sessions_python = 0
        # rendered as the reference renders it; no path of either
        # package increments it
        self.batch_reserves = 0

    def snapshot(self) -> dict:
        return {
            "sessions_native": self.sessions_native,
            "sessions_python": self.sessions_python,
            "native_enabled": 1 if (_mod is not None and _enabled) else 0,
        }

    def prometheus_lines(self, node_name: str = "emqx@127.0.0.1") -> List[str]:
        node = f'node="{node_name}"'
        enabled = 1 if (_mod is not None and _enabled) else 0
        return [
            "# TYPE emqx_delivery_native_enabled gauge",
            f"emqx_delivery_native_enabled{{{node}}} {enabled}",
            "# TYPE emqx_delivery_sessions_native_total counter",
            f"emqx_delivery_sessions_native_total{{{node}}} "
            f"{self.sessions_native}",
            "# TYPE emqx_delivery_sessions_python_total counter",
            f"emqx_delivery_sessions_python_total{{{node}}} "
            f"{self.sessions_python}",
            "# TYPE emqx_delivery_batch_reserves_total counter",
            f"emqx_delivery_batch_reserves_total{{{node}}} "
            f"{self.batch_reserves}",
        ]


DELIVERY_METRICS = DeliveryMetrics()


def set_native_enabled(flag: bool) -> None:
    """Select the native ledger (True, the default) or its Python twin
    (False) for sessions opened from now on."""
    global _enabled
    _enabled = bool(flag)


def native_enabled() -> bool:
    return _enabled


def _probe(mod) -> bool:
    """Mini parity probe: one slot through reserve / ack / enqueue /
    dump against hand-computed expectations, so a miscompiled build
    raises instead of lying."""
    try:
        h = mod.delivery_make_handle()
        slot = mod.delivery_open(h)
        if mod.delivery_reserve(h, slot, 1, 1.5, 2) != 1:
            return False
        if mod.delivery_reserve(h, slot, 2, 2.5, 2) != 2:
            return False
        if mod.delivery_reserve(h, slot, 1, 3.5, 2) != 0:  # window full
            return False
        if mod.delivery_ack(h, slot, 2, PHASE_PUBACK) != 0:  # wrong phase
            return False
        if mod.delivery_ack(h, slot, 2, PHASE_PUBREC) != 1:
            return False
        if mod.delivery_ack(h, slot, 1, PHASE_PUBACK) != 1:
            return False
        # overflow: QoS0 victim at index 0, insert at tail of 1-queue
        if mod.delivery_enqueue(h, slot, 1, 0, 2, 0) != 1:
            return False
        if mod.delivery_enqueue(h, slot, 1, 1, 2, 0) != (1 | (1 << 2)):
            return False
        # overflow evicts the QoS0 entry at index 0; the higher-
        # priority incoming message then inserts at the head
        packed = mod.delivery_enqueue(h, slot, 2, 1, 2, 1)
        if packed != (2 | (0 << 2) | (0 << 32)):
            return False
        if mod.delivery_dump(h, slot) != (
            3,
            [(2, PHASE_PUBCOMP, 0, 2.5)],
            [(2, 1), (1, 1)],
        ):
            return False
        mod.delivery_close(h, slot)
        return True
    except Exception:
        return False


def _load():
    """The extension with the delivery legs, built and probed once;
    raises NativeBuildError when either fails."""
    global _mod
    if _mod is None:
        mod = native.load("_emqx_torch_speedups")
        if not _probe(mod):
            raise NativeBuildError("_emqx_torch_speedups failed its delivery-ledger probe")
        _mod = mod
    return _mod


class PyDeliveryLedger:
    """Bit-exact Python twin of the native delivery legs.

    Slots hold `[next_pid, infl, queue]` where `infl` is a list of
    `[pid, phase, dup, sent_at]` in insertion order and `queue` a list
    of `(prio, qos)` shadow entries; every method mirrors one
    `delivery_*` leg, result-for-result."""

    is_native = False


    def __init__(self) -> None:
        self._slots: List[Optional[list]] = []
        self._free: List[int] = []

    def open(self) -> int:
        if self._free:
            slot = self._free.pop()
        else:
            slot = len(self._slots)
            self._slots.append(None)
        self._slots[slot] = [1, [], []]
        return slot

    def close(self, slot: int) -> None:
        if 0 <= slot < len(self._slots) and self._slots[slot] is not None:
            self._slots[slot] = None
            self._free.append(slot)

    def _slot(self, slot: int) -> list:
        if not (0 <= slot < len(self._slots)) or self._slots[slot] is None:
            raise ValueError("bad delivery slot")
        return self._slots[slot]

    def _alloc_pid(self, s: list) -> int:
        taken = {e[0] for e in s[1]}
        for _ in range(0xFFFF):
            pid = s[0]
            s[0] = pid % 0xFFFF + 1
            if pid not in taken:
                return pid
        return -1

    def _reserve_one(self, s: list, qos: int, now: float, recv_max: int) -> int:
        if len(s[1]) >= recv_max:
            return 0
        pid = self._alloc_pid(s)
        if pid < 0:
            raise RuntimeError("no free packet id")
        s[1].append([pid, PHASE_PUBACK if qos == 1 else PHASE_PUBREC, 0, now])
        return pid

    def reserve(self, slot: int, qos: int, now: float, recv_max: int) -> int:
        return self._reserve_one(self._slot(slot), qos, now, recv_max)

    def reserve_many(
        self,
        slots: Sequence[int],
        qoses: Sequence[int],
        now: float,
        recv_maxes: Sequence[int],
    ) -> List[int]:
        return [
            self._reserve_one(self._slot(slot), qos, now, rmax)
            for slot, qos, rmax in zip(slots, qoses, recv_maxes)
        ]

    def ack(self, slot: int, pid: int, kind: int) -> int:
        s = self._slot(slot)
        for i, e in enumerate(s[1]):
            if e[0] != pid:
                continue
            if e[1] != kind:
                return 0
            if kind == PHASE_PUBREC:
                e[1] = PHASE_PUBCOMP
            else:
                del s[1][i]
            return 1
        return 0

    def forget(self, slot: int, pid: int) -> int:
        s = self._slot(slot)
        for i, e in enumerate(s[1]):
            if e[0] == pid:
                del s[1][i]
                return 1
        return 0

    def retry_due(
        self, slot: int, now: float, interval: float
    ) -> List[Tuple[int, int]]:
        out = []
        for e in self._slot(slot)[1]:
            if now - e[3] < interval:
                continue
            e[3] = now
            e[2] = 1
            out.append((e[0], e[1]))
        return out

    def touch_all(self, slot: int, now: float) -> List[Tuple[int, int]]:
        out = []
        for e in self._slot(slot)[1]:
            e[3] = now
            out.append((e[0], e[1]))
        return out

    def enqueue(
        self,
        slot: int,
        prio: int,
        qos: int,
        max_len: int,
        has_prios: int,
    ) -> int:
        q = self._slot(slot)[2]
        prio &= 0x3FFF
        qos &= 0x3
        action, victim = 1, -1
        if len(q) >= max_len:
            for i in range(len(q) - 1, -1, -1):
                if q[i][1] == 0 and q[i][0] <= prio:
                    victim = i
                    break
            if victim < 0 and q and q[-1][0] < prio:
                victim = len(q) - 1
            if victim < 0:
                return 0
            del q[victim]
            action = 2
        idx = len(q)
        if has_prios and q:
            while idx > 0 and q[idx - 1][0] < prio:
                idx -= 1
        q.insert(idx, (prio, qos))
        packed = action | (idx << 2)
        if action == 2:
            packed |= victim << 32
        return packed

    def popleft(self, slot: int) -> int:
        q = self._slot(slot)[2]
        if not q:
            return 0
        del q[0]
        return 1

    def window_len(self, slot: int) -> int:
        return len(self._slot(slot)[1])

    def dump(self, slot: int) -> tuple:
        s = self._slot(slot)
        return (
            s[0],
            [tuple(e) for e in s[1]],
            list(s[2]),
        )


class NativeDeliveryLedger:
    """Capsule-handle wrapper over the `delivery_*` native legs, same
    method surface as the twin."""

    is_native = True

    def __init__(self, mod) -> None:
        self._mod = mod
        self._h = mod.delivery_make_handle()

    def open(self) -> int:
        return self._mod.delivery_open(self._h)

    def close(self, slot: int) -> None:
        self._mod.delivery_close(self._h, slot)

    def reserve(self, slot: int, qos: int, now: float, recv_max: int) -> int:
        return self._mod.delivery_reserve(self._h, slot, qos, now, recv_max)

    def reserve_many(self, slots, qoses, now, recv_maxes) -> List[int]:
        return self._mod.delivery_reserve_many(
            self._h, slots, qoses, now, recv_maxes
        )

    def ack(self, slot: int, pid: int, kind: int) -> int:
        return self._mod.delivery_ack(self._h, slot, pid, kind)

    def forget(self, slot: int, pid: int) -> int:
        return self._mod.delivery_forget(self._h, slot, pid)

    def retry_due(self, slot: int, now: float, interval: float):
        return self._mod.delivery_retry_due(self._h, slot, now, interval)

    def touch_all(self, slot: int, now: float):
        return self._mod.delivery_touch_all(self._h, slot, now)

    def enqueue(self, slot, prio, qos, max_len, has_prios) -> int:
        return self._mod.delivery_enqueue(
            self._h, slot, prio, qos, max_len, has_prios
        )

    def popleft(self, slot: int) -> int:
        return self._mod.delivery_popleft(self._h, slot)

    def window_len(self, slot: int) -> int:
        return self._mod.delivery_window_len(self._h, slot)

    def dump(self, slot: int) -> tuple:
        return self._mod.delivery_dump(self._h, slot)


_native_ledger: Optional[NativeDeliveryLedger] = None
_py_ledger: Optional[PyDeliveryLedger] = None


def make_ledger():
    """The process-global ledger a new Session binds to: native unless
    the twin is selected, counted either way."""
    global _native_ledger, _py_ledger
    if _enabled:
        if _native_ledger is None:
            _native_ledger = NativeDeliveryLedger(_load())
        DELIVERY_METRICS.sessions_native += 1
        return _native_ledger
    if _py_ledger is None:
        _py_ledger = PyDeliveryLedger()
    DELIVERY_METRICS.sessions_python += 1
    return _py_ledger
