"""Message transformation: declarative rewrites of matched publishes
(the port's own copy of emqx_tpu/transform/transformation.py).

Parity with apps/emqx_message_transformation: transformations carry a
topic filter list, payload decoder/encoder (json | none), and an
operation list assigning values (literals or ${var} templates over
message fields and payload paths) to targets (payload.<path>, topic,
qos, retain, user_property.<k>); failure action drop | ignore, firing
'message.transformation_failed' on error.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from ..broker.hooks import STOP
from ..broker.message import Message
from ..ops import topic as topic_mod
from ..ops.host_index import TopicTrie


class TransformError(ValueError):
    pass


def _get_path(obj: Any, path: List[str]):
    for p in path:
        if isinstance(obj, dict):
            obj = obj.get(p)
        else:
            return None
    return obj


def _set_path(obj: dict, path: List[str], value: Any) -> None:
    for p in path[:-1]:
        nxt = obj.get(p)
        if not isinstance(nxt, dict):
            nxt = {}
            obj[p] = nxt
        obj = nxt
    obj[path[-1]] = value


def _render(template: Any, msg: Message, payload: Any):
    """A value: literal, or '${...}' reference into the message
    (topic/qos/retain/clientid/username/payload.<path>)."""
    if not (isinstance(template, str) and template.startswith("${")
            and template.endswith("}")):
        return template
    ref = template[2:-1]
    if ref == "topic":
        return msg.topic
    if ref == "qos":
        return msg.qos
    if ref == "retain":
        return msg.retain
    if ref == "clientid":
        return msg.from_client
    if ref == "username":
        return msg.headers.get("username", "")
    if ref == "timestamp":
        return msg.timestamp
    if ref == "payload":
        return payload
    if ref.startswith("payload."):
        return _get_path(payload, ref[len("payload."):].split("."))
    raise TransformError(f"unknown reference {template!r}")


class Transformation:
    def __init__(self, conf: dict):
        self.name = conf["name"]
        self.topics = list(conf["topics"])
        self.payload_decoder = conf.get("payload_decoder", "json")
        self.payload_encoder = conf.get("payload_encoder", self.payload_decoder)
        if self.payload_decoder not in ("json", "none"):
            raise ValueError(f"unknown payload_decoder {self.payload_decoder!r}")
        if self.payload_encoder not in ("json", "none"):
            raise ValueError(f"unknown payload_encoder {self.payload_encoder!r}")
        self.failure_action = conf.get("failure_action", "drop")
        if self.failure_action not in ("drop", "ignore"):
            raise ValueError(f"unknown failure_action {self.failure_action!r}")
        self.operations = list(conf.get("operations", ()))
        # payload ops with a non-json pipeline would be silently
        # discarded at encode time — reject the CONFIG, not the traffic
        if any(op.get("key", "").startswith("payload") for op in self.operations):
            if self.payload_decoder != "json" or self.payload_encoder != "json":
                raise ValueError(
                    "payload operations require payload_decoder and "
                    "payload_encoder to be 'json'"
                )
        self.enabled = conf.get("enabled", True)
        self.matched = 0
        self.failed = 0

    def apply(self, msg: Message) -> Message:
        self.matched += 1
        payload: Any = None
        if self.payload_decoder == "json":
            try:
                payload = json.loads(msg.payload) if msg.payload else {}
            except (ValueError, UnicodeDecodeError) as e:
                raise TransformError(f"payload decode: {e}") from e
        out = Message(**{**msg.__dict__})
        out.props = dict(msg.props)
        out.headers = dict(msg.headers)
        payload_dirty = False
        for op in self.operations:
            key, value = op["key"], _render(op.get("value"), msg, payload)
            if key == "topic":
                if not isinstance(value, str) or not value:
                    raise TransformError("topic must be a non-empty string")
                topic_mod.validate_name(value)
                out.topic = value
            elif key == "qos":
                if value not in (0, 1, 2):
                    raise TransformError(f"bad qos {value!r}")
                out.qos = value
            elif key == "retain":
                out.retain = bool(value)
            elif key.startswith("payload"):
                if self.payload_decoder != "json":
                    raise TransformError("payload ops need the json decoder")
                if key == "payload":
                    payload = value
                else:
                    if not isinstance(payload, dict):
                        payload = {}
                    _set_path(payload, key[len("payload."):].split("."), value)
                payload_dirty = True
            elif key.startswith("user_property."):
                up = dict(out.props.get("user_property") or {})
                up[key[len("user_property."):]] = str(value)
                out.props["user_property"] = up
            else:
                raise TransformError(f"unknown target {key!r}")
        if payload_dirty and self.payload_encoder == "json":
            out.payload = json.dumps(payload, separators=(",", ":")).encode()
        return out


class MessageTransformation:
    def __init__(self, broker):
        self.broker = broker
        self._transforms: Dict[str, Transformation] = {}
        self._order: List[str] = []
        self._index = TopicTrie()
        self._enabled = False

    def put(self, conf: dict) -> Transformation:
        t = Transformation(conf)
        # validate EVERYTHING before touching live state — a bad
        # filter must not leave a half-registered transform active
        for flt in t.topics:
            topic_mod.validate_filter(flt)
        old = self._transforms.get(t.name)
        if old is not None:
            self._drop_index(old)
        else:
            self._order.append(t.name)
        self._transforms[t.name] = t
        for flt in t.topics:
            self._index.insert(topic_mod.words(flt), t.name)
        return t

    def delete(self, name: str) -> bool:
        t = self._transforms.pop(name, None)
        if t is None:
            return False
        self._order.remove(name)
        self._drop_index(t)
        return True

    def _drop_index(self, t: Transformation) -> None:
        for flt in t.topics:
            try:
                self._index.remove(topic_mod.words(flt), t.name)
            except KeyError:
                pass

    def list(self) -> List[dict]:
        return [
            {
                "name": n,
                "topics": self._transforms[n].topics,
                "matched": self._transforms[n].matched,
                "failed": self._transforms[n].failed,
            }
            for n in self._order
        ]

    def enable(self) -> None:
        if not self._enabled:
            # after validation (860): validate the ORIGINAL payload
            self.broker.hooks.add("message.publish", self._on_publish, priority=850)
            self._enabled = True

    def disable(self) -> None:
        if self._enabled:
            self.broker.hooks.delete("message.publish", self._on_publish)
            self._enabled = False

    def _on_publish(self, msg: Message):
        names = set(self._index.match(topic_mod.words(msg.topic)))
        if not names:
            return None
        cur = msg
        changed = False
        for name in self._order:
            if name not in names:
                continue
            t = self._transforms[name]
            if not t.enabled:
                continue
            try:
                cur = t.apply(cur)
                changed = True
            except TransformError:
                t.failed += 1
                self.broker.metrics.inc("message_transformation.failed")
                self.broker.hooks.run("message.transformation_failed", cur, name)
                if t.failure_action == "ignore":
                    continue
                out = Message(**{**cur.__dict__})
                out.headers = dict(cur.headers, allow_publish=False)
                return (STOP, out)
        return cur if changed else None
