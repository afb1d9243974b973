"""Delivery-ledger seam: QoS bookkeeping for sessions (the port's own
copy of emqx_tpu/broker/delivery.py's Python twin; the native
`delivery_*` legs are not part of the port).

The per-session numeric state of `broker/session.py` — the inflight
window (packet id, ack phase, dup, sent_at), the wraparound packet-id
allocator, the QoS1/2 retry sweep and the priority-aware mqueue
overflow decision — lives behind one process-global ledger. Sessions
keep owning the *messages* (`Session.inflight` stays the pid -> entry
mapping, `Session.mqueue` stays the real deque); the ledger owns only
the numbers, and config scalars ride each call so `SessionConfig`
stays authoritative.

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

PHASE_PUBACK = 0
PHASE_PUBREC = 1
PHASE_PUBCOMP = 2

PHASE_NAMES = ("puback", "pubrec", "pubcomp")


class PyDeliveryLedger:
    """The delivery ledger (the reference's bit-exact Python twin of
    its native `delivery_*` legs).

    Slots hold `[next_pid, infl, queue]` where `infl` is a list of
    `[pid, phase, dup, sent_at]` in insertion order and `queue` a list
    of `(prio, qos)` shadow entries; every method mirrors one
    `delivery_*` leg of the reference, result-for-result."""


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


_py_ledger: Optional[PyDeliveryLedger] = None


def make_ledger() -> PyDeliveryLedger:
    """The process-global ledger a new Session binds to."""
    global _py_ledger
    if _py_ledger is None:
        _py_ledger = PyDeliveryLedger()
    return _py_ledger
