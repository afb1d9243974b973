"""Hookpoint → rule-event bridge — emqx_rule_events analog (the port's
own copy of emqx_tpu/rules/events.py).

The reference turns broker hookpoints into `$events/...` topics that
rules can select FROM (apps/emqx_rule_engine/src/emqx_rule_events.erl:
80,118); a plain topic in FROM means the 'message.publish' stream.
Event field sets mirror the reference's event payloads.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from ..broker.message import Message

EVENT_TOPICS = {
    "$events/message_publish": "message.publish",
    "$events/message_delivered": "message.delivered",
    "$events/message_acked": "message.acked",
    "$events/message_dropped": "message.dropped",
    "$events/client_connected": "client.connected",
    "$events/client_disconnected": "client.disconnected",
    "$events/client_connack": "client.connack",
    "$events/client_check_authz_complete": "client.check_authz_complete",
    "$events/session_subscribed": "session.subscribed",
    "$events/session_unsubscribed": "session.unsubscribed",
    "$events/delivery_dropped": "delivery.dropped",
}


def is_event_topic(t: str) -> bool:
    return t.startswith("$events/")


def message_event(msg: Message, event: str = "$events/message_publish") -> Dict[str, Any]:
    """Build the rule-eval environment for a message event; field names
    follow the reference's columns(message.publish)."""
    ts_ms = int(msg.timestamp * 1000)
    return {
        "event": event.removeprefix("$events/"),
        "id": msg.id,
        "clientid": msg.from_client,
        "username": (msg.headers or {}).get("username", ""),
        "topic": msg.topic,
        "qos": msg.qos,
        "flags": {"retain": msg.retain},
        "retain": msg.retain,
        "payload": msg.payload,
        "peerhost": (msg.headers or {}).get("peerhost", ""),
        "pub_props": dict(msg.props or {}),
        "timestamp": ts_ms,
        "publish_received_at": ts_ms,
        "node": "local",
    }


def client_event(event: str, client_id: str, **extra: Any) -> Dict[str, Any]:
    env = {
        "event": event.removeprefix("$events/"),
        "clientid": client_id,
        "username": extra.pop("username", ""),
        "timestamp": int(time.time() * 1000),
        "node": "local",
    }
    env.update(extra)
    return env
