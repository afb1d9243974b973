"""Per-topic message counters — emqx_topic_metrics analog (the port's
own copy of emqx_tpu/obs/topic_metrics.py).

Reference: apps/emqx_modules/src/emqx_topic_metrics.erl — an explicit
registry of EXACT topic names (max 512; wildcards rejected) counting
messages.{in,out,dropped} and the per-QoS in/out splits through the
message.publish / message.delivered / message.dropped hooks. Rates are
the caller's derivative; the reference samples them the same way.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ..ops import topic as topic_mod

MAX_TOPICS = 512

_COUNTERS = (
    "messages.in", "messages.out", "messages.dropped",
    "messages.qos0.in", "messages.qos0.out",
    "messages.qos1.in", "messages.qos1.out",
    "messages.qos2.in", "messages.qos2.out",
)


class TopicMetrics:
    def __init__(self, broker) -> None:
        self.broker = broker
        self._topics: Dict[str, Dict[str, int]] = {}
        self._created: Dict[str, float] = {}
        self._installed = False

    # --- registry --------------------------------------------------------

    def register(self, topic: str) -> None:
        if topic_mod.is_wildcard(topic):
            raise ValueError("topic metrics take exact topics, not filters")
        topic_mod.validate_name(topic)
        if topic in self._topics:
            raise ValueError(f"topic {topic!r} already registered")
        if len(self._topics) >= MAX_TOPICS:
            raise OverflowError(f"topic metrics limit {MAX_TOPICS} reached")
        self._topics[topic] = {c: 0 for c in _COUNTERS}
        self._created[topic] = time.time()
        self.install()

    def deregister(self, topic: str) -> bool:
        self._created.pop(topic, None)
        return self._topics.pop(topic, None) is not None

    def deregister_all(self) -> None:
        self._topics.clear()
        self._created.clear()

    def metrics(self, topic: str) -> Optional[dict]:
        c = self._topics.get(topic)
        if c is None:
            return None
        return {
            "topic": topic,
            "create_time": self._created[topic],
            "metrics": dict(c),
        }

    def list(self) -> List[dict]:
        return [self.metrics(t) for t in sorted(self._topics)]

    def reset(self, topic: Optional[str] = None) -> None:
        for t, c in self._topics.items():
            if topic is None or t == topic:
                for k in c:
                    c[k] = 0

    # --- hooks -----------------------------------------------------------

    def install(self) -> None:
        if self._installed:
            return
        self.broker.hooks.add("message.publish", self._on_publish, priority=5)
        self.broker.hooks.add("message.delivered", self._on_delivered)
        self.broker.hooks.add("message.dropped", self._on_dropped)
        self._installed = True

    def _on_publish(self, msg, acc=None):
        m = acc if acc is not None else msg
        c = self._topics.get(getattr(m, "topic", None))
        if c is not None:
            c["messages.in"] += 1
            c[f"messages.qos{min(m.qos, 2)}.in"] += 1
        return None  # fold passthrough

    def _on_delivered(self, client_id, msg):
        c = self._topics.get(msg.topic)
        if c is not None:
            c["messages.out"] += 1
            c[f"messages.qos{min(msg.qos, 2)}.out"] += 1

    def _on_dropped(self, msg, reason):
        c = self._topics.get(msg.topic)
        if c is not None:
            c["messages.dropped"] += 1
