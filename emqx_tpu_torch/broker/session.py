"""Session state: subscriptions, message queue, in-flight windows.

The in-memory session of the reference (apps/emqx/src/emqx_session_mem.erl
mqueue+inflight, emqx_mqueue.erl bounded priority queue, emqx_inflight.erl
receive-maximum window, and the QoS2 awaiting_rel set of
emqx_channel.erl:705-746) collapsed into one transport-agnostic object.
The channel drives it with packets; it emits outgoing packets.

The NUMERIC side of that state — packet-id allocation, window
occupancy, ack phases, retry stamps, and the priority-aware mqueue
overflow decision — lives in the process-global delivery ledger
(broker/delivery.py: the native `delivery_*` legs of the port's
speedups.cc by default, or the bit-exact Python twin when
`delivery.set_native_enabled(False)` selects it).  This object keeps owning the messages:
`inflight` stays the pid → entry mapping and `mqueue` the real deque;
entry phase/dup/sent_at fields are observability mirrors of the
ledger's authoritative copies.

The port's own copy of emqx_tpu/broker/session.py.
"""

from __future__ import annotations

import time
import weakref
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

from ..obs.profiler import STAGE_MARK
from . import delivery as _delivery
from .message import Message
from .packet import Publish, SubOpts


@dataclass
class SessionConfig:
    max_mqueue_len: int = 1000
    receive_maximum: int = 32  # outgoing inflight window
    max_awaiting_rel: int = 100  # incoming QoS2 window
    await_rel_timeout: float = 300.0
    retry_interval: float = 30.0
    session_expiry_interval: float = 0.0  # 0 = ends with connection
    upgrade_qos: bool = False
    # durable-session routing override (the per-zone
    # `durable_sessions.enable` analog): None = auto (nonzero expiry
    # becomes durable when a DS manager is attached), False = stay a
    # live in-memory session regardless of expiry
    durable: Optional[bool] = None
    # mqueue priorities (emqx_mqueue.erl): exact topic -> 1..255,
    # higher drains first; store_qos0=False drops queued QoS0 while
    # the client is disconnected
    mqueue_priorities: Dict[str, int] = field(default_factory=dict)
    mqueue_default_priority: int = 0
    mqueue_store_qos0: bool = True


@dataclass
class _InflightEntry:
    msg: Message
    phase: str  # 'puback' | 'pubrec' | 'pubcomp'
    sent_at: float
    dup: bool = False


class Session:
    """One client's session (mem-session semantics)."""

    def __init__(self, client_id: str, cfg: Optional[SessionConfig] = None):
        self.client_id = client_id
        self.cfg = cfg or SessionConfig()
        self.created_at = time.time()
        self.subscriptions: Dict[str, SubOpts] = {}  # full filter (incl $share)
        # (priority, msg, subopts); highest priority at the head
        self.mqueue: Deque[Tuple[int, Message, SubOpts]] = deque()
        self.inflight: "OrderedDict[int, _InflightEntry]" = OrderedDict()
        self.awaiting_rel: Dict[int, float] = {}  # incoming QoS2 pids
        self.connected = True
        self.disconnected_at: Optional[float] = None
        # counters surfaced in stats/info
        self.dropped = 0
        # transport seams set by the connection layer: packet sink and
        # socket closer (used by admin kick / takeover)
        self.outgoing_sink = None
        # wide-fanout bytes fast path: a mountpoint-free connection
        # accepts the shared pre-serialized QoS0 PUBLISH directly
        # (set together with outgoing_sink by the transport)
        self.outgoing_sink_bytes = None
        self.sink_proto_ver = 4
        self.closer = None
        # delivery ledger binding: all pid/window/phase/queue-overflow
        # arithmetic runs in the shared ledger slot; the finalizer
        # returns the slot when the broker drops this session
        self._ledger = _delivery.make_ledger()
        self._dslot = self._ledger.open()
        self._dslot_finalizer = weakref.finalize(
            self, self._ledger.close, self._dslot
        )

    # --- outgoing delivery ---------------------------------------------

    def deliver(self, msg: Message, subopts: SubOpts) -> List[Publish]:
        """Route one matched message into this session; returns the
        PUBLISH packets to send now (emqx_session:deliver/3)."""
        qos = min(msg.qos, subopts.qos) if not self.cfg.upgrade_qos else max(
            msg.qos, subopts.qos
        )
        if subopts.no_local and msg.from_client == self.client_id:
            return []
        eff = Message(**{**msg.__dict__})
        eff.qos = qos
        if not subopts.retain_as_published:
            eff.retain = False
        if not self.connected:
            self._enqueue(eff, subopts)
            return []
        if qos == 0:
            return [self._to_publish(eff, None)]
        now = time.time()
        pid = self._ledger.reserve(
            self._dslot, qos, now, self.cfg.receive_maximum
        )
        if pid == 0:  # window full
            self._enqueue(eff, subopts)
            return []
        self.inflight[pid] = _InflightEntry(
            eff, "puback" if qos == 1 else "pubrec", now
        )
        return [self._to_publish(eff, pid)]

    def deliver_many(self, items: List[Tuple[Message, SubOpts]]) -> List[Publish]:
        """Window-batched deliver: semantically a `deliver()` per item
        in order — same option walk, same packets, same queue behavior
        — but every inflight reservation for the window rides ONE
        batched ledger call (`reserve_many`) instead of a per-message
        leg.
        The broker's window dispatch calls this once per (session,
        dispatch window)."""
        if len(items) == 1:
            return self.deliver(items[0][0], items[0][1])
        out: List[Optional[Publish]] = []
        resv: List[Tuple[int, Message, SubOpts]] = []  # (out idx, eff, opts)
        upgrade = self.cfg.upgrade_qos
        for msg, subopts in items:
            qos = (
                max(msg.qos, subopts.qos)
                if upgrade
                else min(msg.qos, subopts.qos)
            )
            if subopts.no_local and msg.from_client == self.client_id:
                continue
            eff = Message(**{**msg.__dict__})
            eff.qos = qos
            if not subopts.retain_as_published:
                eff.retain = False
            if not self.connected:
                # connected is constant across the window, so enqueue
                # order stays item order (nothing reserves below)
                self._enqueue(eff, subopts)
                continue
            if qos == 0:
                out.append(self._to_publish(eff, None))
                continue
            out.append(None)  # placeholder keeps packet order exact
            resv.append((len(out) - 1, eff, subopts))
        if resv:
            now = time.time()
            slot = self._dslot
            pids = self._ledger.reserve_many(
                [slot] * len(resv),
                [e.qos for _i, e, _o in resv],
                now,
                [self.cfg.receive_maximum] * len(resv),
            )
            for (pos, eff, subopts), pid in zip(resv, pids):
                if pid == 0:  # window full at this item's turn
                    self._enqueue(eff, subopts)
                    continue
                self.inflight[pid] = _InflightEntry(
                    eff, "puback" if eff.qos == 1 else "pubrec", now
                )
                out[pos] = self._to_publish(eff, pid)
        return [p for p in out if p is not None]

    def _queue_priority(self, msg: Message) -> int:
        return self.cfg.mqueue_priorities.get(
            msg.topic, self.cfg.mqueue_default_priority
        )

    def _enqueue(self, msg: Message, subopts: SubOpts) -> None:
        if (
            msg.qos == 0
            and not self.connected
            and not self.cfg.mqueue_store_qos0
        ):
            # emqx_mqueue store_qos0=false: QoS0 is not worth holding
            # for an absent client
            self.dropped += 1
            return
        prio = self._queue_priority(msg)
        # emqx_mqueue admission, priority-aware: the ledger's shadow
        # queue decides — shed from the LOWEST priority class, never
        # to admit something lower (QoS0 victims first, then a
        # strictly-lower-priority tail entry, else drop the incoming) —
        # and hands back where the real deque mutates
        packed = self._ledger.enqueue(
            self._dslot,
            prio,
            msg.qos,
            self.cfg.max_mqueue_len,
            1 if self.cfg.mqueue_priorities else 0,
        )
        action = packed & 0x3
        if action == 0:
            self.dropped += 1
            return
        if action == 2:
            del self.mqueue[packed >> 32]
            self.dropped += 1
        idx = (packed >> 2) & 0x3FFFFFFF
        if idx == len(self.mqueue):
            self.mqueue.append((prio, msg, subopts))
        else:
            # priority queue (emqx_pqueue analog): non-increasing
            # priority order, FIFO within a priority class
            self.mqueue.insert(idx, (prio, msg, subopts))

    def _to_publish(self, msg: Message, pid: Optional[int]) -> Publish:
        props = dict(msg.props)
        return Publish(
            topic=msg.topic,
            payload=msg.payload,
            qos=msg.qos,
            retain=msg.retain,
            packet_id=pid,
            props=props,
        )

    def drain(self) -> List[Publish]:
        """Move queued messages into the inflight window (after acks
        free slots, or on reconnect)."""
        # ack_sweep stage mark: the sampler buckets stacks caught in
        # this window-advance walk under the ack sweep sub-stage (the
        # wall time is measured by the channel's sampled ack clock)
        STAGE_MARK.stage = "ack_sweep"
        out: List[Publish] = []
        led, slot = self._ledger, self._dslot
        while self.mqueue:
            _prio, msg, subopts = self.mqueue[0]
            if msg.expired():
                self.mqueue.popleft()
                led.popleft(slot)
                self.dropped += 1
                continue
            if msg.qos == 0:
                self.mqueue.popleft()
                led.popleft(slot)
                out.append(self._to_publish(msg, None))
                continue
            now = time.time()
            pid = led.reserve(slot, msg.qos, now, self.cfg.receive_maximum)
            if pid == 0:  # window full
                break
            self.mqueue.popleft()
            led.popleft(slot)
            self.inflight[pid] = _InflightEntry(
                msg, "puback" if msg.qos == 1 else "pubrec", now
            )
            out.append(self._to_publish(msg, pid))
        STAGE_MARK.stage = ""
        return out

    # --- outgoing acks --------------------------------------------------

    def on_puback(self, pid: int) -> bool:
        if not self._ledger.ack(self._dslot, pid, _delivery.PHASE_PUBACK):
            return False
        self.inflight.pop(pid, None)
        return True

    def on_pubrec(self, pid: int) -> bool:
        if not self._ledger.ack(self._dslot, pid, _delivery.PHASE_PUBREC):
            return False
        e = self.inflight.get(pid)
        if e is not None:
            e.phase = "pubcomp"
            e.msg = Message(topic=e.msg.topic)  # payload released (rel marker)
        return True

    def on_pubcomp(self, pid: int) -> bool:
        if not self._ledger.ack(self._dslot, pid, _delivery.PHASE_PUBCOMP):
            return False
        self.inflight.pop(pid, None)
        return True

    def forget_inflight(self, pid: int) -> bool:
        """Release an inflight slot unconditionally — the transport's
        drop-too-large path: the client never received the packet, so
        no ack will ever free the window entry."""
        self._ledger.forget(self._dslot, pid)
        return self.inflight.pop(pid, None) is not None

    def retry(self, now: Optional[float] = None) -> List[Publish]:
        """Re-send unacked QoS1/2 after retry_interval (dup=1)."""
        STAGE_MARK.stage = "ack_sweep"
        now = now if now is not None else time.time()
        out = []
        for pid, phase in self._ledger.retry_due(
            self._dslot, now, self.cfg.retry_interval
        ):
            e = self.inflight.get(pid)
            if e is None:
                continue
            e.sent_at = now
            e.dup = True
            if phase != _delivery.PHASE_PUBCOMP:
                p = self._to_publish(e.msg, pid)
                p.dup = True
                out.append(p)
            # phase 'pubcomp': PUBREL retransmit handled by channel
        STAGE_MARK.stage = ""
        return out

    # --- incoming QoS2 --------------------------------------------------

    def await_rel(self, pid: int) -> bool:
        """Register an incoming QoS2 publish; False if window full or
        duplicate (duplicate is not an error: dup redelivery)."""
        if pid in self.awaiting_rel:
            return False
        if len(self.awaiting_rel) >= self.cfg.max_awaiting_rel:
            raise OverflowError("RECEIVE_MAXIMUM_EXCEEDED")
        self.awaiting_rel[pid] = time.time()
        return True

    def release_rel(self, pid: int) -> bool:
        return self.awaiting_rel.pop(pid, None) is not None

    # --- lifecycle -------------------------------------------------------

    def on_disconnect(self) -> None:
        self.connected = False
        self.disconnected_at = time.time()

    def on_reconnect(self) -> List[Publish]:
        """Resume: re-send inflight (dup) then drain the queue
        (emqx_session_mem:replay)."""
        self.connected = True
        self.disconnected_at = None
        out = []
        now = time.time()
        for pid, phase in self._ledger.touch_all(self._dslot, now):
            e = self.inflight.get(pid)
            if e is None:
                continue
            e.sent_at = now
            if phase != _delivery.PHASE_PUBCOMP:
                p = self._to_publish(e.msg, pid)
                p.dup = True
                out.append(p)
        out.extend(self.drain())
        return out

    def expired(self, now: Optional[float] = None) -> bool:
        if self.connected or self.disconnected_at is None:
            return False
        now = now if now is not None else time.time()
        return now - self.disconnected_at >= self.cfg.session_expiry_interval
