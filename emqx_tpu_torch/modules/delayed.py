"""Delayed publish: `$delayed/{Secs}/{Topic}` holds a message for Secs
seconds, then publishes it to Topic.

Parity with apps/emqx_modules/src/emqx_delayed.erl: a 'message.publish'
hook intercepts `$delayed/...` topics, stores the message, and stops
normal dispatch; a timer republishes at the due instant. Bounded store
(max_delayed_messages) rejects excess instead of growing unbounded.
"""

from __future__ import annotations

import asyncio
import heapq
import itertools
import time
from typing import List, Optional, Tuple

from ..broker.hooks import STOP
from ..broker.message import Message

PREFIX = "$delayed/"
MAX_INTERVAL = 42949670  # seconds (reference cap, ~497 days)


def parse_delayed(topic: str) -> Optional[Tuple[int, str]]:
    """'$delayed/5/a/b' -> (5, 'a/b'); None if not a delayed topic.
    Raises ValueError on a malformed interval (bad publish)."""
    if not topic.startswith(PREFIX):
        return None
    rest = topic[len(PREFIX):]
    if "/" not in rest:
        raise ValueError("delayed topic without payload topic")
    secs_s, real = rest.split("/", 1)
    secs = int(secs_s)  # ValueError on garbage
    if not 0 <= secs <= MAX_INTERVAL or not real:
        raise ValueError("delayed interval out of range")
    return secs, real


class DelayedPublish:
    def __init__(self, broker, max_delayed_messages: int = 0):
        self.broker = broker
        self.max = max_delayed_messages  # 0 = unlimited
        self._heap: List[Tuple[float, int, Message]] = []
        self._seq = itertools.count()
        self._timer: Optional[asyncio.TimerHandle] = None
        self._enabled = False
        self.dropped = 0

    # --- lifecycle ------------------------------------------------------

    def enable(self) -> None:
        if not self._enabled:
            self.broker.hooks.add("message.publish", self._on_publish, priority=900)
            self._enabled = True
            if self._heap:
                self._schedule()  # re-enable must re-arm held messages

    def disable(self) -> None:
        if self._enabled:
            self.broker.hooks.delete("message.publish", self._on_publish)
            self._enabled = False
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def __len__(self) -> int:
        return len(self._heap)

    # --- hook -----------------------------------------------------------

    def _on_publish(self, msg: Message):
        try:
            parsed = parse_delayed(msg.topic)
        except ValueError:
            # malformed $delayed topic: swallow the message (the
            # reference drops it with a warning)
            self.dropped += 1
            held = Message(**{**msg.__dict__})
            held.headers = dict(msg.headers, allow_publish=False)
            return (STOP, held)
        if parsed is None:
            return None
        secs, real = parsed
        if self.max and len(self._heap) >= self.max:
            # the STOP return below already routes through the broker's
            # drop accounting — no extra metrics here or it counts twice
            self.dropped += 1
        else:
            held = Message(**{**msg.__dict__})
            held.topic = real
            heapq.heappush(
                self._heap, (time.time() + secs, next(self._seq), held)
            )
            self._schedule()
            stored = Message(**{**msg.__dict__})
            stored.headers = dict(
                msg.headers, allow_publish=False, intercepted="delayed"
            )
            return (STOP, stored)
        stopped = Message(**{**msg.__dict__})
        stopped.headers = dict(msg.headers, allow_publish=False)
        return (STOP, stopped)

    # --- timers ---------------------------------------------------------

    def _schedule(self) -> None:
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # no loop (sync tests drive via tick())
        if self._timer is not None:
            self._timer.cancel()
        if self._heap:
            delay = max(0.0, self._heap[0][0] - time.time())
            self._timer = loop.call_later(delay, self._fire)

    def _fire(self) -> None:
        self._timer = None
        self.tick()
        self._schedule()

    def tick(self, now: Optional[float] = None) -> int:
        """Publish everything due; returns count (also the manual pump
        for loop-less callers)."""
        now = now if now is not None else time.time()
        n = 0
        while self._heap and self._heap[0][0] <= now:
            _due, _seq, msg = heapq.heappop(self._heap)
            self.broker.publish(msg)
            n += 1
        return n
