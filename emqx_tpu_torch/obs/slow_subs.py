"""Slow-subscriber top-k latency tracker (apps/emqx_slow_subs; the
port's own copy of emqx_tpu/obs/slow_subs.py).

The reference hooks 'message.delivered'/'delivery.completed', computes
per-(clientid, topic) delivery latency, and keeps a bounded top-k
table with expiry. Here `install()` hooks the broker's
'message.delivered' point; latency = deliver time − msg.timestamp
(the reference's `whole` stats_type).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Tuple


class SlowSubs:
    def __init__(
        self,
        threshold_ms: float = 500.0,
        top_k: int = 10,
        expire_interval: float = 300.0,
    ):
        self.threshold_ms = threshold_ms
        self.top_k = top_k
        self.expire_interval = expire_interval
        # (clientid, topic) -> {timespan, last_update_time}
        self._tab: Dict[Tuple[str, str], Dict[str, Any]] = {}

    def install(self, hooks) -> None:
        self._hooks = hooks
        hooks.add("message.delivered", self._on_delivered, priority=-100)

    def uninstall(self) -> None:
        hooks = getattr(self, "_hooks", None)
        if hooks is not None:
            hooks.delete("message.delivered", self._on_delivered)
            self._hooks = None

    def _on_delivered(self, client_id: str, msg, *_acc) -> None:
        lat_ms = (time.time() - msg.timestamp) * 1000.0
        self.track(client_id, msg.topic, lat_ms)

    def track(self, client_id: str, topic: str, latency_ms: float) -> None:
        if latency_ms < self.threshold_ms:
            return
        key = (client_id, topic)
        rec = self._tab.get(key)
        now = time.time()
        if rec is None or latency_ms > rec["timespan"]:
            self._tab[key] = {"timespan": latency_ms, "last_update_time": now}
        else:
            rec["last_update_time"] = now
        self._shrink()

    def _shrink(self) -> None:
        self.expire()
        if len(self._tab) > self.top_k:
            # evict the smallest timespans, keeping k (top-k semantics)
            ranked = sorted(
                self._tab.items(), key=lambda kv: -kv[1]["timespan"]
            )
            self._tab = dict(ranked[: self.top_k])

    def expire(self) -> None:
        cutoff = time.time() - self.expire_interval
        self._tab = {
            k: v for k, v in self._tab.items() if v["last_update_time"] >= cutoff
        }

    def topk(self) -> List[Dict[str, Any]]:
        self.expire()
        out = []
        for (cid, topic), rec in sorted(
            self._tab.items(), key=lambda kv: -kv[1]["timespan"]
        ):
            out.append(
                {
                    "clientid": cid,
                    "topic": topic,
                    "timespan": rec["timespan"],
                    "last_update_time": rec["last_update_time"],
                }
            )
        return out

    def clear(self) -> None:
        self._tab.clear()
