"""Host-side topic trie index — the low-latency / fallback match path
(the port's own copy of emqx_tpu/ops/host_index.py).

The device kernels (ops/match.py, ops/hash_index.py) are *batched*
matchers: they win when many inbound topics amortize one launch. For
single cold publishes, for filters too deep for the flattened table,
and as the default before a device is attached, the broker needs a
host index. This is the
recursive-descent trie of the reference's v1 schema
(apps/emqx/src/emqx_trie.erl:303-352 match_no_compact: try the literal
branch, the '+' branch, and collect '#' leaves, with the '$'-root
exclusion of emqx_trie.erl:286-293) — implemented iteratively over
plain-dict nodes.

Node layout: each node IS a dict mapping child word -> child node,
with two reserved INT keys holding the id sets — topic words are
always str, so the sentinels can never collide with any word a client
sends (including control characters; only U+0000 is spec-forbidden,
MQTT-1.5.4-2). Plain dicts keep the subscribe-storm insert path
allocation-light: a class-based node cost ~15us/route in the
route-churn profile; a dict costs ~50ns.

Complexity O(2^wildcard-branches) worst case like the reference v1;
the device kernel is the scale path.
"""

from __future__ import annotations

from typing import Hashable, List, Sequence, Set, Tuple

IDS = 0  # filters ending exactly at this node
HASH_IDS = 1  # filters ending in '#' at this node


def node_children(node: dict):
    """(word, child) pairs of a trie node, skipping the id buckets."""
    return (
        (w, c) for w, c in node.items() if type(w) is str
    )


def node_ids(node: dict) -> Set[Hashable]:
    return node.get(IDS) or ()


def _node_empty(node: dict) -> bool:
    return not node


class TopicTrie:
    """Wildcard filter trie: insert/remove (filter words, id), match
    topic words -> set of ids. No depth limit."""

    __slots__ = ("_root", "_count")

    def __init__(self) -> None:
        self._root: dict = {}
        self._count = 0

    def __len__(self) -> int:
        return self._count

    def insert(self, filter_words: Sequence[str], fid: Hashable) -> None:
        ws = tuple(filter_words)
        has_hash = bool(ws) and ws[-1] == "#"
        node = self._root
        for w in ws[:-1] if has_hash else ws:
            nxt = node.get(w)
            if nxt is None:
                nxt = node[w] = {}
            node = nxt
        key = HASH_IDS if has_hash else IDS
        bucket = node.get(key)
        if bucket is None:
            bucket = node[key] = set()
        elif fid in bucket:
            raise KeyError(f"duplicate id {fid!r} for {'/'.join(ws)}")
        bucket.add(fid)
        self._count += 1

    def remove(self, filter_words: Sequence[str], fid: Hashable) -> None:
        ws = tuple(filter_words)
        has_hash = bool(ws) and ws[-1] == "#"
        path: List[Tuple[dict, str]] = []
        node = self._root
        for w in ws[:-1] if has_hash else ws:
            child = node.get(w)
            if child is None:
                raise KeyError("/".join(ws))
            path.append((node, w))
            node = child
        key = HASH_IDS if has_hash else IDS
        bucket = node.get(key)
        if not bucket or fid not in bucket:
            raise KeyError(f"id {fid!r} not under {'/'.join(ws)}")
        bucket.remove(fid)
        if not bucket:
            del node[key]
        self._count -= 1
        # prune now-empty nodes bottom-up
        for parent, w in reversed(path):
            if _node_empty(node):
                del parent[w]
                node = parent
            else:
                break

    def match(self, topic_words: Sequence[str]) -> Set[Hashable]:
        """All filter ids matching the topic (emqx_trie.erl match/1
        semantics incl. the '$'-root rule)."""
        tw = tuple(topic_words)
        n = len(tw)
        dollar = bool(tw) and tw[0].startswith("$")
        out: Set[Hashable] = set()
        # stack of (node, next topic level index)
        stack: List[Tuple[dict, int]] = [(self._root, 0)]
        while stack:
            node, i = stack.pop()
            root_restricted = dollar and i == 0
            # '#' at this node matches the (possibly empty) remainder —
            # unless it's a root wildcard over a '$' topic
            if not root_restricted:
                h = node.get(HASH_IDS)
                if h:
                    out |= h
            if i == n:
                e = node.get(IDS)
                if e:
                    out |= e
                continue
            child = node.get(tw[i])
            if child is not None:
                stack.append((child, i + 1))
            if not root_restricted:
                plus = node.get("+")
                if plus is not None:
                    stack.append((plus, i + 1))
        return out
