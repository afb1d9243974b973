"""Banned clients — emqx_banned analog (apps/emqx/src/emqx_banned.erl;
the port's own copy of emqx_tpu/auth/banned.py, whose fields the API,
ctl and the backup archive serialise).

Ban entries keyed by (who_type, who_value) with an expiry; checked at
CONNECT (clientid / username / peerhost) and consulted by flapping
detection. An expired entry is lazily purged on check (the reference
also runs a periodic sweep; `sweep()` is that timer's body).
"""

from __future__ import annotations

import fnmatch
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

WHO_TYPES = ("clientid", "username", "peerhost", "clientid_re", "username_re")


@dataclass
class BanEntry:
    who_type: str
    who: str
    by: str = ""
    reason: str = ""
    at: float = 0.0
    until: Optional[float] = None  # None = forever


class Banned:
    def __init__(self) -> None:
        self._tab: Dict[Tuple[str, str], BanEntry] = {}

    def create(
        self,
        who_type: str,
        who: str,
        by: str = "admin",
        reason: str = "",
        duration_s: Optional[float] = None,
    ) -> BanEntry:
        if who_type not in WHO_TYPES:
            raise ValueError(f"bad who_type {who_type!r}")
        now = time.time()
        e = BanEntry(
            who_type, who, by, reason, now,
            None if duration_s is None else now + duration_s,
        )
        self._tab[(who_type, who)] = e
        return e

    def delete(self, who_type: str, who: str) -> bool:
        return self._tab.pop((who_type, who), None) is not None

    def _live(self, key: Tuple[str, str]) -> Optional[BanEntry]:
        e = self._tab.get(key)
        if e is None:
            return None
        if e.until is not None and time.time() > e.until:
            del self._tab[key]
            return None
        return e

    def check(
        self, client_id: str, username: Optional[str] = None, peerhost: str = ""
    ) -> Optional[BanEntry]:
        """Returns the matching live ban entry, if any."""
        for key in (
            ("clientid", client_id),
            ("username", username or ""),
            ("peerhost", peerhost),
        ):
            e = self._live(key)
            if e is not None:
                return e
        # regex(glob)-style bans
        for (wt, pat), e in list(self._tab.items()):
            if wt == "clientid_re" and fnmatch.fnmatch(client_id, pat):
                if self._live((wt, pat)):
                    return e
            elif wt == "username_re" and fnmatch.fnmatch(username or "", pat):
                if self._live((wt, pat)):
                    return e
        return None

    def list(self) -> List[BanEntry]:
        self.sweep()
        return list(self._tab.values())

    def sweep(self) -> int:
        now = time.time()
        dead = [k for k, e in self._tab.items() if e.until is not None and now > e.until]
        for k in dead:
            del self._tab[k]
        return len(dead)
