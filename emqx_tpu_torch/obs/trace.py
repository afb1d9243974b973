"""Client/topic/ip traces to files (apps/emqx/src/emqx_trace/; the port's
own copy of emqx_tpu/obs/trace.py).

The reference's emqx_trace gen_server manages trace records and
installs per-trace logger handlers writing rotating files; broker
publish/subscribe call taps (emqx_trace.erl:82-102). Here each Trace
filters events against its type (clientid | topic | ip_address) and
appends formatted lines (text or json) to its own file; the manager
installs broker hooks once and fans events to all running traces.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..ops import topic as topic_mod


@dataclass
class Trace:
    name: str
    type: str  # clientid | topic | ip_address
    filter: str
    formatter: str = "text"  # text | json
    start_at: float = field(default_factory=time.time)
    end_at: Optional[float] = None
    enabled: bool = True
    path: str = ""

    def expired(self) -> bool:
        return self.end_at is not None and time.time() > self.end_at

    def matches(self, clientid: str, topic: Optional[str], ip: str) -> bool:
        if not self.enabled or self.expired():
            return False
        if self.type == "clientid":
            return clientid == self.filter
        if self.type == "topic":
            return topic is not None and topic_mod.match(
                topic_mod.words(topic), topic_mod.words(self.filter)
            )
        if self.type == "ip_address":
            return ip == self.filter
        return False


class TraceManager:
    # expired traces are reaped at most this often from the event path
    SWEEP_INTERVAL = 5.0

    def __init__(self, trace_dir: Optional[str] = None):
        # default: a folder under the process's temp dir (TMPDIR)
        self.trace_dir = trace_dir or os.path.join(
            tempfile.gettempdir(), "emqx_tpu_torch_trace"
        )
        self._traces: Dict[str, Trace] = {}
        self._files: Dict[str, object] = {}
        # only RUNNING traces are consulted per event: stopped/expired
        # records stay in _traces for list()/read_log but must not be
        # filtered against on every publish
        self._running: Dict[str, Trace] = {}
        self._next_sweep = 0.0

    # --- lifecycle ------------------------------------------------------

    _TAPS = (
        ("message.publish", "_on_publish"),
        ("session.subscribed", "_on_subscribed"),
        ("client.connected", "_on_connected"),
        ("client.disconnected", "_on_disconnected"),
    )

    def install(self, hooks) -> None:
        """Tap the broker events the reference traces (publish,
        subscribe, connect/disconnect)."""
        self._hooks = hooks
        for point, meth in self._TAPS:
            hooks.add(point, getattr(self, meth), priority=1000)

    def uninstall(self) -> None:
        hooks = getattr(self, "_hooks", None)
        if hooks is None:
            return
        for point, meth in self._TAPS:
            hooks.delete(point, getattr(self, meth))
        self._hooks = None

    def create(
        self,
        name: str,
        type: str,
        filter: str,
        formatter: str = "text",
        end_at: Optional[float] = None,
    ) -> Trace:
        if not name or not all(c.isalnum() or c in "-_" for c in name):
            raise ValueError(f"bad trace name: {name!r}")
        if name in self._traces:
            raise ValueError(f"trace exists: {name}")
        if type not in ("clientid", "topic", "ip_address"):
            raise ValueError(f"bad trace type: {type}")
        if end_at is not None and not isinstance(end_at, (int, float)):
            raise ValueError(f"end_at must be a unix timestamp: {end_at!r}")
        os.makedirs(self.trace_dir, exist_ok=True)
        path = os.path.join(self.trace_dir, f"{name}.log")
        t = Trace(
            name=name, type=type, filter=filter, formatter=formatter,
            end_at=end_at, path=path,
        )
        self._traces[name] = t
        self._running[name] = t
        self._files[name] = open(path, "a", encoding="utf-8")
        return t

    def delete(self, name: str) -> None:
        if name not in self._traces:
            raise KeyError(name)
        self._traces.pop(name)
        self._running.pop(name, None)
        f = self._files.pop(name, None)
        if f is not None:
            f.close()

    def stop_trace(self, name: str) -> None:
        if name not in self._traces:
            raise KeyError(name)
        self._traces[name].enabled = False
        self._running.pop(name, None)
        f = self._files.pop(name, None)
        if f is not None:
            f.close()

    def list(self) -> List[Dict]:
        self._reap_expired()
        return [
            {
                "name": t.name,
                "type": t.type,
                t.type: t.filter,
                "status": "running" if t.enabled else "stopped",
                "start_at": t.start_at,
                "end_at": t.end_at,
            }
            for t in self._traces.values()
        ]

    def _reap_expired(self) -> None:
        """Transition past-end_at traces to stopped, release their file
        handles, and drop them from the per-event filter set (the
        reference stops traces at end_at). Without this an expired
        trace kept its file open and kept being matched against on
        every publish until someone happened to call list()."""
        for t in self._traces.values():
            if t.enabled and t.expired():
                t.enabled = False
                self._running.pop(t.name, None)
                f = self._files.pop(t.name, None)
                if f is not None:
                    f.close()

    def sweep(self, now: Optional[float] = None) -> None:
        """Rate-limited expiry sweep, driven from the event path so
        expiry needs no timer task; cost between sweeps is one float
        compare per emitted event."""
        if now is None:
            now = time.time()
        if now < self._next_sweep:
            return
        self._next_sweep = now + self.SWEEP_INTERVAL
        self._reap_expired()

    def read_log(self, name: str) -> str:
        t = self._traces.get(name)
        if t is None:
            raise KeyError(name)
        f = self._files.get(name)
        if f is not None:
            f.flush()
        with open(t.path, "r", encoding="utf-8") as fh:
            return fh.read()

    def close(self) -> None:
        for name in list(self._traces):
            self.delete(name)

    # --- event taps -----------------------------------------------------

    def _emit(self, clientid: str, topic: Optional[str], ip: str, event: str, detail: Dict) -> None:
        if not self._running:
            return
        self.sweep()
        for t in list(self._running.values()):
            if not t.matches(clientid, topic, ip):
                continue
            f = self._files.get(t.name)
            if f is None:
                continue
            ts = time.strftime("%Y-%m-%dT%H:%M:%S")
            if t.formatter == "json":
                rec = {"time": ts, "event": event, "clientid": clientid, **detail}
                f.write(json.dumps(rec) + "\n")
            else:
                kv = " ".join(f"{k}: {v}" for k, v in detail.items())
                f.write(f"{ts} [{event}] clientid: {clientid} {kv}\n")
            f.flush()

    def _on_publish(self, msg, *_acc):
        peer = str((msg.headers or {}).get("peerhost", ""))
        self._emit(
            msg.from_client, msg.topic, peer.rsplit(":", 1)[0],
            "PUBLISH",
            {"topic": msg.topic, "qos": msg.qos, "payload": msg.payload[:128].hex()},
        )

    def _on_subscribed(self, client_id: str, flt: str, opts, *_):
        self._emit(client_id, flt, "", "SUBSCRIBE", {"topic": flt})

    def _on_connected(self, client_id: str, *info):
        # hook args: (client_id, proto_ver, peer) — peer is "ip:port"
        peer = str(info[1]) if len(info) > 1 else ""
        ip = peer.rsplit(":", 1)[0]
        self._emit(client_id, None, ip, "CONNECTED", {"peer": peer})

    def _on_disconnected(self, client_id: str, *info):
        reason = info[0] if info else ""
        self._emit(client_id, None, "", "DISCONNECTED", {"reason": reason})
