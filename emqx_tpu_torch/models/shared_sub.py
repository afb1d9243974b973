"""Shared subscriptions: `$share/Group/Topic` group membership and
per-publish subscriber election.

Parity with apps/emqx/src/emqx_shared_sub.erl: a group table keyed by
(group, filter) holding member sessions, and a dispatch strategy
choosing exactly ONE member per publish (emqx_shared_sub.erl:79-87):
random | round_robin | round_robin_per_group | sticky | local |
hash_clientid | hash_topic. `local` degrades to random on one node.

The port's own copy of emqx_tpu/models/shared_sub.py.
"""

from __future__ import annotations

import random
from typing import Dict, Hashable, List, Optional, Tuple

STRATEGIES = (
    "random",
    "round_robin",
    "round_robin_per_group",
    "sticky",
    "local",
    "hash_clientid",
    "hash_topic",
)


class SharedSubs:
    def __init__(self, strategy: str = "random", seed: Optional[int] = None):
        assert strategy in STRATEGIES, strategy
        self.strategy = strategy
        self._rng = random.Random(seed)
        # membership-transition callbacks (group, flt, member) — the
        # cluster layer replicates the mria shared-sub bag through these
        self.on_subscribed = None
        self.on_unsubscribed = None
        # (group, filter) -> ordered member list
        self._members: Dict[Tuple[str, str], List[Hashable]] = {}
        self._rr: Dict[Tuple[str, str], int] = {}  # round-robin cursors
        self._sticky: Dict[Tuple[str, str, str], Hashable] = {}  # +topic -> member

    def subscribe(self, group: str, flt: str, member: Hashable) -> bool:
        """Returns True if this is the group's first member (i.e. a
        route add is needed, emqx_shared_sub:subscribe)."""
        key = (group, flt)
        mem = self._members.setdefault(key, [])
        if member not in mem:
            mem.append(member)
            if self.on_subscribed is not None:
                self.on_subscribed(group, flt, member)
        return len(mem) == 1

    def unsubscribe(self, group: str, flt: str, member: Hashable) -> bool:
        """Returns True if the group is now empty (route delete)."""
        key = (group, flt)
        mem = self._members.get(key)
        if not mem:
            return False
        if member in mem:
            mem.remove(member)
            if self.on_unsubscribed is not None:
                self.on_unsubscribed(group, flt, member)
        self._sticky = {
            k: v for k, v in self._sticky.items() if not (k[:2] == key and v == member)
        }
        if not mem:
            del self._members[key]
            self._rr.pop(key, None)
            return True
        return False

    def members(self, group: str, flt: str) -> List[Hashable]:
        return list(self._members.get((group, flt), ()))

    def items(self) -> List[Tuple[Tuple[str, str], List[Hashable]]]:
        """All ((group, filter), members) entries."""
        return [(k, list(v)) for k, v in self._members.items()]

    def pick_among(self, members: List[Hashable], group: str, flt: str,
                   topic: str, from_client: str = "") -> Optional[Hashable]:
        """Elect from an explicit candidate list (the cluster layer's
        local-preference path)."""
        if not members:
            return None
        return self._elect(members, (group, flt), topic, from_client)

    def pick(
        self,
        group: str,
        flt: str,
        topic: str,
        from_client: str = "",
        exclude: Tuple[Hashable, ...] = (),
    ) -> Optional[Hashable]:
        """Elect one member for this publish; `exclude` supports the
        retry-on-failed-subscriber loop (emqx_shared_sub:dispatch/4)."""
        key = (group, flt)
        mem = [m for m in self._members.get(key, ()) if m not in exclude]
        if not mem:
            return None
        return self._elect(mem, key, topic, from_client)

    def _elect(self, mem, key, topic: str, from_client: str):
        group, flt = key
        s = self.strategy
        if s in ("random", "local"):
            return self._rng.choice(mem)
        if s in ("round_robin", "round_robin_per_group"):
            i = self._rr.get(key, 0)
            self._rr[key] = i + 1
            return mem[i % len(mem)]
        if s == "sticky":
            skey = (group, flt, topic)
            cur = self._sticky.get(skey)
            if cur is not None and cur in mem:
                return cur
            choice = self._rng.choice(mem)
            self._sticky[skey] = choice
            return choice
        if s == "hash_clientid":
            return mem[hash(from_client) % len(mem)]
        # hash_topic
        return mem[hash(topic) % len(mem)]
