"""Alarm registry (apps/emqx/src/emqx_alarm.erl:1-492; counterpart of
emqx_tpu/obs/alarm.py), cut to what the device breaker uses.

activate/deactivate named alarms in an active table; each transition
publishes `$SYS/brokers/<node>/alarms/activate|deactivate` with a JSON
body, exactly the reference's do_actions publish leg. The reference's
deactivated history, its views and its listener list are not ported:
nothing in the port reads them.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, Optional

from ..broker.message import Message


class AlarmError(Exception):
    pass


class Alarms:
    def __init__(self, broker=None, node_name: str = "emqx@127.0.0.1"):
        self.broker = broker
        self.node_name = node_name
        self._active: Dict[str, Dict[str, Any]] = {}

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
        re-notify, no $SYS re-publish."""
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
        self._notify("deactivate", rec)

    def ensure_deactivated(self, name: str) -> None:
        if name in self._active:
            self.deactivate(name)

    def is_active(self, name: str) -> bool:
        return name in self._active

    def _notify(self, kind: str, rec: Dict[str, Any]) -> None:
        if self.broker is not None:
            topic = f"$SYS/brokers/{self.node_name}/alarms/{kind}"
            self.broker.publish(
                Message(topic=topic, payload=json.dumps(rec).encode())
            )
