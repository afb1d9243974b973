"""Rate limiting + overload protection.

The reference enforces hierarchical token-bucket limits at two choke
points — connection accept (esockd limiter + `max_conn_rate`) and the
channel publish path (`emqx_channel.erl:751-768` `ensure_quota` /
?LIMITER_ROUTING, buckets from apps/emqx/src/emqx_limiter/src/
emqx_htb_limiter.erl) — and sheds load under scheduler pressure via
emqx_olp.erl (lc runq flagman backing off new connections).

The asyncio-era design here:

* `TokenBucket` — pure, monotonic-time token bucket.  `rate` is
  tokens/second, `burst` extra capacity on top of one second's worth
  (matching the reference's `rate`/`burst` bucket schema fields).
* `Limiter` — a chain of buckets consumed atomically (client tier →
  listener tier → node tier, the htb hierarchy flattened: a consume
  succeeds only if every tier grants, else reports the longest wait).
  Failed consumes do NOT debit any tier (no partial takes).
* Connections `await limiter.acquire(...)` before processing inbound
  PUBLISH frames — backpressure pauses the socket read loop, which is
  exactly the reference semantics of a rate-limited connection process
  hibernating (emqx_connection.erl activeN/rate-limit).
* `LoadShedder` — event-loop-lag flagman.  A sampler task measures
  scheduling drift; while the EWMA exceeds the threshold, new
  connections are refused at accept (emqx_olp's new-conn backoff) —
  never established flows, which keeps existing service degradation
  graceful.
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, List, Optional, Sequence

INF = float("inf")


def _rate(v) -> float:
    """Schema value -> tokens/s ('infinity' | number)."""
    if v in (None, "infinity"):
        return INF
    return float(v)


class TokenBucket:
    """Monotonic-clock token bucket: capacity = rate*1s + burst."""

    __slots__ = ("rate", "capacity", "tokens", "_last")

    def __init__(self, rate: float, burst: float = 0.0) -> None:
        self.rate = rate
        self.capacity = INF if rate == INF else rate + (burst or 0.0)
        self.tokens = self.capacity
        self._last = time.monotonic()

    def _refill(self, now: float) -> None:
        if self.rate == INF:
            return
        self.tokens = min(self.capacity, self.tokens + (now - self._last) * self.rate)
        self._last = now

    def peek(self, n: float, now: Optional[float] = None) -> float:
        """0.0 if n tokens are available now, else seconds to wait."""
        if self.rate == INF:
            return 0.0
        self._refill(now if now is not None else time.monotonic())
        if self.tokens >= n:
            return 0.0
        if self.rate <= 0:
            return INF
        return (n - self.tokens) / self.rate

    def take(self, n: float) -> None:
        """Debit unconditionally (caller peeked first)."""
        if self.rate != INF:
            self.tokens -= n


class Limiter:
    """An atomically-consumed chain of buckets (htb tiers flattened)."""

    def __init__(self, buckets: Sequence[TokenBucket]) -> None:
        self.buckets = [b for b in buckets if b.rate != INF]

    def check(self, n: float = 1.0) -> float:
        """0.0 and debit if every tier grants; else the wait in
        seconds with nothing debited.  INF means unsatisfiable: n
        exceeds some tier's capacity, so no amount of waiting helps."""
        if not self.buckets:
            return 0.0
        now = time.monotonic()
        wait = 0.0
        for b in self.buckets:
            if n > b.capacity:
                return INF
            wait = max(wait, b.peek(n, now))
        if wait > 0.0:
            return wait
        for b in self.buckets:
            b.take(n)
        return 0.0

    async def acquire(self, n: float = 1.0, max_wait: float = 60.0) -> bool:
        """Await until n tokens are granted (pausing the caller — the
        socket read loop), or return False immediately for an
        unsatisfiable request / once max_wait is exceeded."""
        waited = 0.0
        while True:
            w = self.check(n)
            if w == 0.0:
                return True
            if w == INF or waited + w > max_wait:
                return False
            await asyncio.sleep(min(w, 1.0))
            waited += min(w, 1.0)


class ListenerLimits:
    """Per-listener enforcement state built from the config's limiter
    section.  Node-wide tiers are caller-provided shared buckets: the
    boot layer builds one {"messages_rate": TokenBucket, ...} dict and
    passes the SAME dict as `node_tier` to every listener's limits so
    the node quota is consumed jointly."""

    def __init__(
        self,
        max_conn_rate=None,
        messages_rate=None,
        bytes_rate=None,
        client: Optional[dict] = None,
        node_tier: Optional[Dict[str, TokenBucket]] = None,
    ) -> None:
        self.conn_bucket = TokenBucket(_rate(max_conn_rate))
        self.msg_bucket = TokenBucket(_rate(messages_rate))
        self.byte_bucket = TokenBucket(_rate(bytes_rate))
        self.client_cfg = client or {}
        self.node_tier = node_tier or {}

    @classmethod
    def from_config(
        cls, cfg: dict, node_tier: Optional[Dict[str, TokenBucket]] = None
    ) -> "ListenerLimits":
        """cfg = the checked `limiter` section of the broker schema;
        node_tier = the node-wide shared buckets (one dict per node)."""
        cfg = cfg or {}
        return cls(
            max_conn_rate=cfg.get("max_conn_rate"),
            messages_rate=cfg.get("messages_rate"),
            bytes_rate=cfg.get("bytes_rate"),
            client=cfg.get("client"),
            node_tier=node_tier,
        )

    def accept_allowed(self) -> bool:
        """Connection-accept gate (esockd max_conn_rate analog)."""
        if self.conn_bucket.peek(1.0) > 0.0:
            return False
        self.conn_bucket.take(1.0)
        return True

    def publish_limiter(self) -> Limiter:
        """Message-count limiter chain for one connection."""
        tiers: List[TokenBucket] = []
        c = self.client_cfg.get("messages_rate")
        if c:
            tiers.append(TokenBucket(_rate(c.get("rate")), c.get("burst") or 0.0))
        tiers.append(self.msg_bucket)
        nb = self.node_tier.get("messages_rate")
        if nb is not None:
            tiers.append(nb)
        return Limiter(tiers)

    def bytes_limiter(self) -> Limiter:
        tiers: List[TokenBucket] = []
        c = self.client_cfg.get("bytes_rate")
        if c:
            tiers.append(TokenBucket(_rate(c.get("rate")), c.get("burst") or 0.0))
        tiers.append(self.byte_bucket)
        nb = self.node_tier.get("bytes_rate")
        if nb is not None:
            tiers.append(nb)
        return Limiter(tiers)


class LoadShedder:
    """Event-loop-lag flagman (emqx_olp analog).

    Samples scheduling drift: asks the loop to wake after `interval`
    and measures how late the wakeup lands.  EWMA above `threshold`
    sets `overloaded`; the server then refuses NEW connections while
    established ones keep full service."""

    def __init__(
        self,
        threshold: float = 0.05,
        interval: float = 0.1,
        alpha: float = 0.3,
    ) -> None:
        self.threshold = threshold
        self.interval = interval
        self.alpha = alpha
        self.lag_ewma = 0.0
        self.shed_count = 0
        self._task: Optional[asyncio.Task] = None
        self._forced: Optional[bool] = None  # tests pin the state

    @property
    def overloaded(self) -> bool:
        if self._forced is not None:
            return self._forced
        return self.lag_ewma > self.threshold

    def force(self, state: Optional[bool]) -> None:
        self._forced = state

    async def _sample(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            t0 = loop.time()
            await asyncio.sleep(self.interval)
            lag = max(0.0, loop.time() - t0 - self.interval)
            self.lag_ewma = self.alpha * lag + (1 - self.alpha) * self.lag_ewma

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._sample())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
