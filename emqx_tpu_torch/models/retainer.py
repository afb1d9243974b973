"""Retained-message store.

Parity with apps/emqx_retainer: store the latest retained message per
topic (empty payload deletes, MQTT spec), and on subscribe return all
retained messages matching a new filter. The read pattern is the
*inverse* of routing (a filter matched against stored topic names), so
the store keeps its own exact-topic dict plus a trie over stored topic
names for wildcard-filter reads — mirroring emqx_retainer_index's
dedicated index tables (emqx_retainer_index.erl:17-50).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Optional

from ..broker.message import Message
from ..ops import topic as topic_mod
from ..ops.host_index import TopicTrie, node_children, node_ids


class Retainer:
    def __init__(self, max_retained: int = 1_000_000):
        self.max_retained = max_retained
        self._store: Dict[str, Message] = {}
        # trie of stored TOPIC NAMES (no wildcards): match(filter_words)
        # cannot use TopicTrie.match directly (it matches topic->filters);
        # instead we walk the trie with the filter. Keep a names trie
        # keyed by exact words.
        self._names = TopicTrie()
        # the device read leg is not ported: reads walk the host trie
        self.device_enabled = False
        # expiry/drop ledger (emqx_retainer_* scrape families): the
        # max_retained drop was previously a silent `return`
        self.expired_total = 0
        self.dropped_full_total = 0
        self._sweep_ring: Deque[str] = deque()

    def __len__(self) -> int:
        return len(self._store)

    def retain(self, msg: Message) -> None:
        """Store/replace/delete (empty payload) the retained message."""
        if not msg.payload:
            old = self._store.pop(msg.topic, None)
            if old is not None:
                self._names.remove(topic_mod.words(msg.topic), msg.topic)
            return
        if msg.topic not in self._store:
            if len(self._store) >= self.max_retained:
                # full: drop (reference behavior is configurable) — but
                # never silently: the scrape carries the ledger
                self.dropped_full_total += 1
                return
            self._names.insert(topic_mod.words(msg.topic), msg.topic)
        self._store[msg.topic] = msg

    def _purge(self, topic: str) -> None:
        """Drop one expired entry from the store and the names trie,
        counting it."""
        if self._store.pop(topic, None) is not None:
            self._names.remove(topic_mod.words(topic), topic)
            self.expired_total += 1

    def read(self, flt: str, now: Optional[float] = None) -> List[Message]:
        """All live retained messages matching the filter. Expired
        entries encountered on the way are purged (read-repair), so a
        hot filter keeps its own matches swept even between periodic
        sweep() ticks."""
        now = now if now is not None else time.time()
        out = []
        if not topic_mod.is_wildcard(flt):
            m = self._store.get(flt)
            if m is not None:
                if m.expired(now):
                    self._purge(flt)
                else:
                    out.append(m)
            return out
        fw = topic_mod.words(flt)
        for name in self._match_names(fw):
            m = self._store.get(name)
            if m is None:
                continue
            if m.expired(now):
                self._purge(name)
            else:
                out.append(m)
        return out

    def sweep(self, now: Optional[float] = None, budget: int = 1000) -> int:
        """Bounded expiry sweep: examine up to `budget` entries from a
        rotating ring over the store (refilled lazily), purging the
        expired ones. O(budget) per tick regardless of store size —
        full coverage accrues across ticks. Returns purged count."""
        now = now if now is not None else time.time()
        if not self._sweep_ring:
            self._sweep_ring.extend(self._store.keys())
        purged = 0
        for _ in range(min(budget, len(self._sweep_ring))):
            topic = self._sweep_ring.popleft()
            m = self._store.get(topic)
            if m is not None and m.expired(now):
                self._purge(topic)
                purged += 1
        return purged

    def prometheus_lines(self, node_name: str = "emqx@127.0.0.1") -> List[str]:
        node = f'node="{node_name}"'
        return [
            "# TYPE emqx_retainer_entries gauge",
            f"emqx_retainer_entries{{{node}}} {len(self._store)}",
            "# TYPE emqx_retainer_expired_total counter",
            f"emqx_retainer_expired_total{{{node}}} {self.expired_total}",
            "# TYPE emqx_retainer_dropped_full_total counter",
            f"emqx_retainer_dropped_full_total{{{node}}} "
            f"{self.dropped_full_total}",
        ]

    def _match_names(self, fw) -> List[str]:
        """Walk the names trie with a wildcard filter (inverse match)."""
        has_hash = fw[-1] == "#"
        prefix = fw[:-1] if has_hash else fw
        results: List[str] = []
        # stack: (node, filter position)
        stack = [(self._names._root, 0)]
        while stack:
            node, i = stack.pop()
            if i == len(prefix):
                if has_hash:
                    if i == 0:
                        # bare '#': root wildcards never cover '$'-topics
                        results.extend(node_ids(node))
                        for cw, child in node_children(node):
                            if not cw.startswith("$"):
                                self._collect_all(child, results)
                    else:
                        self._collect_all(node, results)
                else:
                    results.extend(node_ids(node))
                continue
            w = prefix[i]
            if w == "+":
                for cw, child in node_children(node):
                    if i == 0 and cw.startswith("$"):
                        continue  # '$'-root isolation
                    stack.append((child, i + 1))
            else:
                child = node.get(w)
                if child is not None:
                    stack.append((child, i + 1))
        return results

    def _collect_all(self, node, results: List[str]) -> None:
        stack = [node]
        while stack:
            n = stack.pop()
            results.extend(node_ids(n))
            stack.extend(c for _w, c in node_children(n))

    def clean(self, now: Optional[float] = None) -> int:
        """Drop expired retained messages; returns count removed."""
        now = now if now is not None else time.time()
        dead = [t for t, m in self._store.items() if m.expired(now)]
        for t in dead:
            self._purge(t)
        return len(dead)
