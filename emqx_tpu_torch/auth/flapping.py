"""Flapping detection — emqx_flapping analog (the port's own copy of
emqx_tpu/auth/flapping.py).

Counts disconnects per clientid in a sliding window; exceeding
max_count within window_time bans the client for ban_time via the
Banned table (apps/emqx/src/emqx_flapping.erl behavior: detect on
'client.disconnected', ban by clientid).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict

from .banned import Banned


class FlappingDetector:
    def __init__(
        self,
        banned: Banned,
        max_count: int = 15,
        window_time_s: float = 60.0,
        ban_time_s: float = 300.0,
        enable: bool = True,
    ):
        self.banned = banned
        self.max_count = max_count
        self.window_time_s = window_time_s
        self.ban_time_s = ban_time_s
        self.enable = enable
        self._events: Dict[str, Deque[float]] = {}

    def on_disconnect(self, client_id: str, peerhost: str = "") -> bool:
        """Record a disconnect; returns True if this tripped a ban."""
        if not self.enable:
            return False
        now = time.monotonic()
        q = self._events.setdefault(client_id, deque())
        q.append(now)
        while q and now - q[0] > self.window_time_s:
            q.popleft()
        if len(q) > self.max_count:
            self.banned.create(
                "clientid",
                client_id,
                by="flapping_detector",
                reason=f"flapping: {len(q)} disconnects in {self.window_time_s}s",
                duration_s=self.ban_time_s,
            )
            del self._events[client_id]
            return True
        return False

    def gc(self) -> None:
        now = time.monotonic()
        for cid in list(self._events):
            q = self._events[cid]
            while q and now - q[0] > self.window_time_s:
                q.popleft()
            if not q:
                del self._events[cid]
