"""Audit log of management mutations — the emqx_audit analog (the
port's own copy of emqx_tpu/mgmt/audit.py).

Every mutating API/CLI operation records who did what through which
surface with the outcome (the reference stores these in mnesia and
serves them from the dashboard API); bounded in memory with newest
first.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Any, Deque, List, Optional


class AuditLog:
    def __init__(self, max_entries: int = 5000):
        self._entries: Deque[dict] = deque(maxlen=max_entries)
        self._seq = itertools.count(1)

    def record(
        self,
        actor: str,
        via: str,  # "api" | "cli"
        operation: str,  # e.g. "POST /api/v5/banned" or "cluster join"
        args: Any = None,
        result: str = "ok",
        code: Optional[int] = None,
    ) -> None:
        self._entries.appendleft(
            {
                "seq": next(self._seq),
                "created_at": time.time(),
                "actor": actor,
                "via": via,
                "operation": operation,
                "args": args,
                "result": result,
                "code": code,
            }
        )

    def list(
        self,
        actor: Optional[str] = None,
        via: Optional[str] = None,
        limit: Optional[int] = None,
    ) -> List[dict]:
        """Newest first; limit=None returns everything (pagination is
        the API layer's job — pre-truncating here would make page 2
        unreachable)."""
        out = []
        for e in self._entries:
            if actor is not None and e["actor"] != actor:
                continue
            if via is not None and e["via"] != via:
                continue
            out.append(e)
            if limit is not None and len(out) >= limit:
                break
        return out

    def __len__(self) -> int:
        return len(self._entries)
