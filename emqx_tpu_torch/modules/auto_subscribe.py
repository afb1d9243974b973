"""Auto-subscribe: server-side forced subscriptions applied when a
client connects.

Parity with apps/emqx_auto_subscribe: a topic list with placeholder
substitution (${clientid}, ${username}, ${host}) subscribed on the
'client.connected' hookpoint with per-topic QoS/subopts.
"""

from __future__ import annotations

import asyncio
from typing import List, Optional

from ..broker.packet import SubOpts


class AutoSubscribe:
    def __init__(self, broker, topics: Optional[List[dict]] = None):
        """topics: [{"topic": "c/${clientid}/inbox", "qos": 1,
        "no_local": false, "retain_as_published": false,
        "retain_handling": 0}]"""
        self.broker = broker
        self.topics = topics or []
        self._enabled = False

    def enable(self) -> None:
        if not self._enabled:
            self.broker.hooks.add(
                "client.connected", self._on_connected, priority=100
            )
            self._enabled = True

    def disable(self) -> None:
        if self._enabled:
            self.broker.hooks.delete("client.connected", self._on_connected)
            self._enabled = False

    def _on_connected(self, client_id, _proto_ver=None, peer=None, *extra):
        session = self.broker.sessions.get(client_id)
        if session is None:
            return None
        username = getattr(session, "username", "") or ""
        host = (peer or "").rsplit(":", 1)[0] if peer else ""
        # a mounted listener namespaces its clients: forced subs must
        # land in the SAME namespace or they never match (the channel
        # records its resolved mountpoint on the session at CONNECT)
        mountpoint = getattr(session, "mountpoint", "")
        for t in self.topics:
            flt = mountpoint + (
                t["topic"]
                .replace("${clientid}", client_id)
                .replace("${username}", username)
                .replace("${host}", host)
            )
            if flt in session.subscriptions:
                continue  # client-made subscription wins
            opts = SubOpts(
                qos=t.get("qos", 0),
                no_local=t.get("no_local", False),
                retain_as_published=t.get("retain_as_published", False),
                retain_handling=t.get("retain_handling", 0),
            )
            from ..broker.pubsub import ExclusiveTaken

            try:
                retained = self.broker.subscribe(session, flt, opts)
            except (ValueError, ExclusiveTaken):
                continue  # invalid filter / exclusive collision: skip
            for m in retained:
                pkts = session.deliver(m, opts)
                if not pkts:
                    continue
                sink = getattr(session, "outgoing_sink", None)
                if sink is not None:
                    sink(pkts)
                    continue
                # client.connected fires inside CONNECT handling, before
                # the connection wires the sink — defer one loop turn so
                # retained reads reach the client that just connected
                try:
                    loop = asyncio.get_running_loop()
                except RuntimeError:
                    continue
                loop.call_soon(self._flush_later, session, pkts)
        return None

    @staticmethod
    def _flush_later(session, pkts) -> None:
        sink = getattr(session, "outgoing_sink", None)
        if sink is not None:
            sink(pkts)
