"""Retained-message store.

Parity with apps/emqx_retainer: store the latest retained message per
topic (empty payload deletes, MQTT spec), and on subscribe return all
retained messages matching a new filter. The read pattern is the
*inverse* of routing (a filter matched against stored topic names), so
the store keeps its own exact-topic dict plus a trie over stored topic
names for wildcard-filter reads — mirroring emqx_retainer_index's
dedicated index tables (emqx_retainer_index.erl:17-50).

`enable_device()` attaches the cuckoo-backed index of ops/retained.py
(kernel K8 on the card) and serves wildcard reads through
`retained_read_begin/finish`; the host trie stays the exact oracle and
the escalation path. The durable `PersistentRetainer` is not ported.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Optional

from ..broker.message import Message
from ..device import DeviceLike
from ..ops import topic as topic_mod
from ..ops.host_index import TopicTrie, node_children, node_ids
from ..ops.retained import RetainedIndex


class Retainer:
    def __init__(self, max_retained: int = 1_000_000, device: DeviceLike = None):
        """`device` is where enable_device() puts the index's K8
        mirror: None means the CUDA card (raising when none is
        present), "cpu" runs K8's plain version. A Broker passes its
        own device."""
        self.max_retained = max_retained
        self.device = device
        self._store: Dict[str, Message] = {}
        # trie of stored TOPIC NAMES (no wildcards): match(filter_words)
        # cannot use TopicTrie.match directly (it matches topic->filters);
        # instead we walk the trie with the filter. Keep a names trie
        # keyed by exact words.
        self._names = TopicTrie()
        # device leg (ops/retained.py): None until enable_device(); the
        # host trie stays the bit-exact oracle and escalation path
        self.device_enabled = False
        self._index = None
        # expiry/drop ledger (emqx_retainer_* scrape families): the
        # max_retained drop was previously a silent `return`
        self.expired_total = 0
        self.dropped_full_total = 0
        self._sweep_ring: Deque[str] = deque()

    def __len__(self) -> int:
        return len(self._store)

    def enable_device(
        self,
        telemetry=None,
        min_device: int = 0,
        class_budget: int = 64,
        max_levels: int = 16,
    ):
        """Attach the cuckoo-backed retained index (backfilling the
        current store) on this retainer's device and serve wildcard
        reads through the retained_read_begin/finish halves. The mirror
        is uploaded and K8 launched once here, so the first SUBSCRIBE
        does not pay the kernel's build."""
        idx = RetainedIndex(
            telemetry=telemetry,
            min_device=min_device,
            class_budget=class_budget,
            max_levels=max_levels,
            device=self.device,
        )
        for name in self._store:
            idx.add(name)
        idx.warmup()
        self._index = idx
        self.device_enabled = True
        return idx

    def retain(self, msg: Message) -> None:
        """Store/replace/delete (empty payload) the retained message."""
        if not msg.payload:
            old = self._store.pop(msg.topic, None)
            if old is not None:
                self._names.remove(topic_mod.words(msg.topic), msg.topic)
                if self._index is not None:
                    self._index.remove(msg.topic)
            return
        if msg.topic not in self._store:
            if len(self._store) >= self.max_retained:
                # full: drop (reference behavior is configurable) — but
                # never silently: the scrape carries the ledger
                self.dropped_full_total += 1
                return
            self._names.insert(topic_mod.words(msg.topic), msg.topic)
            if self._index is not None:
                self._index.add(msg.topic)
        self._store[msg.topic] = msg

    def _purge(self, topic: str) -> None:
        """Drop one expired entry from every structure (store, names
        trie, device index), counting it."""
        if self._store.pop(topic, None) is not None:
            self._names.remove(topic_mod.words(topic), topic)
            if self._index is not None:
                self._index.remove(topic)
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

    # --- batched device read (retained_read_begin/finish halves) -------

    def retained_read_begin(self, filters: List[str], now=None):
        """Launch one batched device probe for a wave of filters (a
        SUBSCRIBE packet's worth, a takeover replay, ...). Exact
        filters stay host dict hits; without enable_device() every
        plan degrades to the host walk at finish."""
        now = now if now is not None else time.time()
        wild_idx: List[int] = []
        wild: List[str] = []
        for i, flt in enumerate(filters):
            if topic_mod.is_wildcard(flt):
                wild_idx.append(i)
                wild.append(flt)
        ticket = None
        if self._index is not None and wild:
            ticket = self._index.read_begin(wild)
        return (filters, wild_idx, wild, ticket, now)

    def retained_read_finish(self, begun) -> List[List[Message]]:
        filters, wild_idx, wild, ticket, now = begun
        name_lists: List[Optional[List[str]]] = [None] * len(wild)
        if ticket is not None:
            name_lists = self._index.read_finish(ticket)
        out: List[List[Message]] = [[] for _ in filters]
        wpos = 0
        for i, flt in enumerate(filters):
            if wpos < len(wild_idx) and wild_idx[wpos] == i:
                names = name_lists[wpos]
                wpos += 1
                if names is None:
                    # escalation: the host walk is the exact path
                    out[i] = self.read(flt, now)
                    continue
                msgs = []
                for name in names:
                    m = self._store.get(name)
                    if m is None:
                        continue
                    if m.expired(now):
                        self._purge(name)
                    else:
                        msgs.append(m)
                out[i] = msgs
            else:
                out[i] = self.read(flt, now)  # exact: dict hit
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
