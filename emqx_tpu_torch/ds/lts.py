"""Learned topic structure (LTS) trie — emqx_ds_lts analog (the port's
own copy of emqx_tpu/ds/lts.py).

Maps topics to compact integer *static keys* by learning which topic
levels are high-cardinality (apps/emqx_durable_storage/src/
emqx_ds_lts.erl:20-45 topic_key/3, match_topics/2; flagged in
SURVEY.md §3.5 as the in-tree precedent for the flattened
level-compressed trie). A node whose distinct children exceed
`threshold` grows a '+' (varying) edge: subsequent new words at that
level all route through '+', and the concrete word is carried in the
message key's varying suffix instead of the trie. Result: millions of
`sensor/<device-id>/temp` topics share ONE static key with device-id
varying — the storage layer gets a bounded stream count.

Persistable: dump()/load() round-trip the learned structure so keys
stay stable across restarts (the reference persists its trie in the
same rocksdb column family).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

PLUS = "+"
HASH = "#"


class _Node:
    __slots__ = ("id", "edges", "terminal_id")

    def __init__(self, nid: int):
        self.id = nid
        self.edges: Dict[str, _Node] = {}
        self.terminal_id: Optional[int] = None  # static key if a topic ends here


class LtsTrie:
    def __init__(self, threshold: int = 20):
        self.threshold = threshold
        self._root = _Node(0)
        self._next_node = 1
        self._next_static = 1
        # static_key -> (node path spec for reconstruction)
        self._static_words: Dict[int, Tuple[str, ...]] = {}

    # --- learn / key ----------------------------------------------------

    def topic_key(self, words: Sequence[str]) -> Tuple[int, List[str]]:
        """(static_key, varying_words). Learns structure on the fly."""
        node = self._root
        varying: List[str] = []
        spec: List[str] = []
        for w in words:
            child = node.edges.get(w)
            if child is not None:
                node = child
                spec.append(w)
                continue
            plus = node.edges.get(PLUS)
            if plus is not None:
                varying.append(w)
                node = plus
                spec.append(PLUS)
                continue
            # distinct non-varying children at threshold → learn '+'
            if len(node.edges) >= self.threshold:
                plus = _Node(self._next_node)
                self._next_node += 1
                node.edges[PLUS] = plus
                varying.append(w)
                node = plus
                spec.append(PLUS)
            else:
                child = _Node(self._next_node)
                self._next_node += 1
                node.edges[w] = child
                node = child
                spec.append(w)
        if node.terminal_id is None:
            node.terminal_id = self._next_static
            self._static_words[node.terminal_id] = tuple(spec)
            self._next_static += 1
        return node.terminal_id, varying

    def static_spec(self, static_key: int) -> Tuple[str, ...]:
        """The (word|'+')* pattern a static key stands for."""
        return self._static_words[static_key]

    # --- filter matching ------------------------------------------------

    def match_filter(self, filter_words: Sequence[str]) -> List[Tuple[int, List[str]]]:
        """All (static_key, varying_constraints) whose topics can match
        the filter. varying_constraints has one entry per '+'-edge on
        the static path: a concrete word the varying level must equal,
        or '+' for unconstrained; a trailing '#' constraint means the
        filter had a multi-level tail (matches deeper static keys too,
        which are returned separately)."""
        out: List[Tuple[int, List[str]]] = []
        fw = list(filter_words)

        def walk(node: _Node, i: int, constraints: List[str]) -> None:
            if i == len(fw):
                if node.terminal_id is not None:
                    out.append((node.terminal_id, constraints))
                return
            w = fw[i]
            if w == HASH:
                # matches here and every descendant
                self._collect(node, constraints, out)
                return
            if w == PLUS:
                for word, child in node.edges.items():
                    walk(child, i + 1, constraints + ([PLUS] if word == PLUS else []))
            else:
                child = node.edges.get(w)
                if child is not None:
                    walk(child, i + 1, constraints)
                plus = node.edges.get(PLUS)
                if plus is not None:
                    walk(plus, i + 1, constraints + [w])

        walk(self._root, 0, [])
        return out

    def _collect(self, node: _Node, constraints: List[str], out) -> None:
        if node.terminal_id is not None:
            out.append((node.terminal_id, list(constraints)))
        for word, child in node.edges.items():
            self._collect(
                child, constraints + ([PLUS] if word == PLUS else []), out
            )

    # --- persistence ----------------------------------------------------

    def dump(self) -> bytes:
        """Serialize the learned structure (static specs rebuild the
        trie deterministically)."""
        return json.dumps(
            {
                "threshold": self.threshold,
                "statics": {str(k): list(v) for k, v in self._static_words.items()},
            }
        ).encode()

    @classmethod
    def load(cls, blob: bytes) -> "LtsTrie":
        doc = json.loads(blob)
        t = cls(threshold=doc["threshold"])
        # rebuild: insert specs in static-key order so node/static ids
        # are reproduced deterministically
        for k in sorted(doc["statics"], key=int):
            spec = doc["statics"][k]
            node = t._root
            for w in spec:
                child = node.edges.get(w)
                if child is None:
                    child = _Node(t._next_node)
                    t._next_node += 1
                    node.edges[w] = child
                node = child
            node.terminal_id = int(k)
            t._static_words[int(k)] = tuple(spec)
            t._next_static = max(t._next_static, int(k) + 1)
        return t


def varying_match(varying: Sequence[str], constraints: Sequence[str]) -> bool:
    """Check a message's varying words against filter constraints
    ('+' = free, concrete word = must equal). Extra varying words
    beyond the constraint list are free (filter had '#')."""
    for i, c in enumerate(constraints):
        if c == PLUS:
            continue
        if i >= len(varying) or varying[i] != c:
            return False
    return True
