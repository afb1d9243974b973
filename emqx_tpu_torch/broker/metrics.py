"""Broker metrics & stats — counters and gauges.

Counter names mirror the reference's fixed metric set
(apps/emqx/src/emqx_metrics.erl bytes/packets/messages/delivery
domains); stats gauges mirror emqx_stats.erl (current/max pairs).

The port's own copy of emqx_tpu/broker/metrics.py.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict


class Metrics:
    def __init__(self) -> None:
        self._c: Dict[str, int] = defaultdict(int)

    def inc(self, name: str, n: int = 1) -> None:
        self._c[name] += n

    def val(self, name: str) -> int:
        return self._c.get(name, 0)

    def all(self) -> Dict[str, int]:
        return dict(self._c)


class Stats:
    """current/max gauges (emqx_stats.erl:setstat current+max pairs)."""

    def __init__(self) -> None:
        self._cur: Dict[str, int] = defaultdict(int)
        self._max: Dict[str, int] = defaultdict(int)

    def set(self, name: str, v: int) -> None:
        self._cur[name] = v
        if v > self._max[name]:
            self._max[name] = v

    def incr(self, name: str, n: int = 1) -> None:
        self.set(name, self._cur[name] + n)

    def decr(self, name: str, n: int = 1) -> None:
        self._cur[name] = max(0, self._cur[name] - n)

    def val(self, name: str) -> int:
        return self._cur.get(name, 0)

    def max(self, name: str) -> int:
        return self._max.get(name, 0)

    def all(self) -> Dict[str, int]:
        out = dict(self._cur)
        out.update({k + ".max": v for k, v in self._max.items()})
        return out
