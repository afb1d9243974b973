"""Dictionary encoding of topic-level words to dense int32 ids (the
port's own copy of emqx_tpu/ops/vocab.py).

The reference walks binary topic words directly (ets ordered-set keys,
apps/emqx/src/emqx_trie_search.erl:115-128). A device-resident table
needs fixed-width integers instead; we intern every word that appears in any
*filter* into a host-side dictionary. Topic words are encoded by lookup
only — a word never seen in a filter maps to OOV(0), which by
construction equals no filter word id, so matching stays *exact* (no
hash collisions / false positives).

Reserved ids:
  0  OOV / padding  (matches nothing literal)
  1  '+'            (single-level wildcard marker inside filter rows)
Real words intern from 2 upward. Freed ids (refcount 0) are recycled.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

OOV = 0
PLUS = 1
FIRST_ID = 2


class Vocab:
    """Refcounted word ↔ id interning table (host side).

    Refcounts live in a flat int64 array indexed by id: bulk writers
    (np.add.at, or the native churn core bumping the raw buffer) pay
    ~nothing per word where a per-word dict round-trip was the
    route-churn hot path.  PLUS's slot may accumulate counts from
    bulk bumps; it is never recycled, so the count is inert."""

    def __init__(self) -> None:
        self._ids: Dict[str, int] = {}
        self._refs = np.zeros(1024, np.int64)  # indexed by word id
        self._words: Dict[int, str] = {}
        self._free: List[int] = []
        self._next = FIRST_ID

    def __len__(self) -> int:
        return len(self._ids)

    def ensure_refs(self, need: int) -> None:
        """Guarantee the refcount array covers ids < `need` (bulk
        writers pre-grow before handing the buffer to native code)."""
        if need <= len(self._refs):
            return
        cap = len(self._refs)
        while cap < need:
            cap *= 2
        self._refs = np.concatenate(
            [self._refs, np.zeros(cap - len(self._refs), np.int64)]
        )

    def _create(self, word: str) -> int:
        """Assign a fresh id (no refcount bump — callers batch those)."""
        wid = self._free.pop() if self._free else self._next
        if wid == self._next:
            self._next += 1
        self._ids[word] = wid
        self._words[wid] = word
        return wid

    def intern(self, word: str) -> int:
        """Get-or-create an id for a filter word; bumps its refcount."""
        if word == "+":
            return PLUS
        wid = self._ids.get(word)
        if wid is None:
            wid = self._create(word)
            self.ensure_refs(wid + 1)
            self._refs[wid] = 0
        self._refs[wid] += 1
        return wid

    def bump_many(self, ids: List[int]) -> None:
        """Batch refcount bump for a flat id list (PLUS/dup ids fine)."""
        np.add.at(self._refs, ids, 1)

    def release(self, word: str) -> None:
        """Drop one reference; id is recycled at refcount 0."""
        if word == "+":
            return
        wid = self._ids[word]
        c = self._refs[wid] - 1
        self._refs[wid] = c
        if c == 0:
            del self._ids[word]
            del self._words[wid]
            self._free.append(wid)

    def lookup(self, word: str) -> int:
        """Encode a topic word: known filter words get their id, anything
        else OOV. ('+' in a topic *name* is technically invalid MQTT; it
        encodes to PLUS which preserves oracle semantics either way.)"""
        if word == "+":
            return PLUS
        return self._ids.get(word, OOV)

    def word(self, wid: int) -> str:
        return "+" if wid == PLUS else self._words[wid]
