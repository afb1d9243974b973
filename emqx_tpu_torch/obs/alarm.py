"""Alarm registry (apps/emqx/src/emqx_alarm.erl:1-492; the port's own
copy of emqx_tpu/obs/alarm.py).

activate/deactivate named alarms; active table + bounded deactivated
history; each transition publishes `$SYS/brokers/<node>/alarms/
activate|deactivate` with a JSON body, exactly the reference's
do_actions publish leg. The 'systems.alarm' hook analog is a plain
callback list (the reference routes through emqx_hooks 'alarm.*' from
plugins; we keep it local to avoid widening the strict hookpoint set).
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional

from ..broker.message import Message


class AlarmError(Exception):
    pass


class Alarms:
    def __init__(
        self,
        broker=None,
        node_name: str = "emqx@127.0.0.1",
        size_limit: int = 1000,
        validity_period: float = 86400.0,
    ):
        self.broker = broker
        self.node_name = node_name
        self.size_limit = size_limit
        self.validity_period = validity_period
        self._active: Dict[str, Dict[str, Any]] = {}
        # append-only, time-ordered (list: equal-timestamp deactivations
        # must not overwrite each other)
        self._history: List[Dict[str, Any]] = []
        self.listeners: List[Callable[[str, Dict[str, Any]], None]] = []

    # --- transitions ----------------------------------------------------

    def activate(
        self, name: str, details: Optional[Dict[str, Any]] = None, message: str = ""
    ) -> None:
        """Raise an alarm; already-active raises (emqx_alarm.erl returns
        {error, already_existed})."""
        if name in self._active:
            raise AlarmError(f"alarm already active: {name}")
        rec = {
            "name": name,
            "details": details or {},
            "message": message or name,
            "activate_at": time.time(),
        }
        self._active[name] = rec
        self._notify("activate", rec)

    def ensure(self, name: str, details=None, message: str = "") -> None:
        """activate if not already active (safe_activate). An already-
        active alarm refreshes its details/message in place — no
        re-notify, no $SYS re-publish — so long-burning alarms (SLO
        burn rates, audit divergence) read current, not stale, state."""
        rec = self._active.get(name)
        if rec is None:
            self.activate(name, details, message)
            return
        if details:
            rec["details"] = details
        if message:
            rec["message"] = message

    def deactivate(self, name: str, details=None, message: str = "") -> None:
        rec = self._active.pop(name, None)
        if rec is None:
            raise AlarmError(f"alarm not active: {name}")
        rec = dict(rec)
        rec["deactivate_at"] = time.time()
        if details:
            rec["details"] = details
        if message:
            rec["message"] = message
        self._gc()
        self._history.append(rec)
        self._notify("deactivate", rec)

    def ensure_deactivated(self, name: str) -> None:
        if name in self._active:
            self.deactivate(name)

    def delete_all_deactivated(self) -> None:
        self._history = []

    # --- views ----------------------------------------------------------

    def get_alarms(self, which: str = "all") -> List[Dict[str, Any]]:
        self._gc()
        if which == "activated":
            return list(self._active.values())
        if which == "deactivated":
            return list(self._history)
        return list(self._active.values()) + list(self._history)

    def is_active(self, name: str) -> bool:
        return name in self._active

    def fired_since(self, ts: float) -> List[str]:
        """Names of alarms whose activation landed at/after `ts`,
        whether still active or already cleared — the chaos scenario
        contract's "did the system page during this window" view."""
        names = {
            r["name"]
            for r in self._active.values()
            if r["activate_at"] >= ts
        }
        names.update(
            r["name"] for r in self._history if r["activate_at"] >= ts
        )
        return sorted(names)

    # --- internals ------------------------------------------------------

    def _gc(self) -> None:
        cutoff = time.time() - self.validity_period
        while self._history and (
            self._history[0]["deactivate_at"] < cutoff
            or len(self._history) >= self.size_limit
        ):
            self._history.pop(0)

    def _notify(self, kind: str, rec: Dict[str, Any]) -> None:
        for cb in self.listeners:
            cb(kind, rec)
        if self.broker is not None:
            topic = f"$SYS/brokers/{self.node_name}/alarms/{kind}"
            self.broker.publish(
                Message(topic=topic, payload=json.dumps(rec).encode())
            )
