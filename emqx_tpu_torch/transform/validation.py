"""Schema validation: per-topic payload gates on the publish path (the
port's own copy of emqx_tpu/transform/validation.py).

Parity with apps/emqx_schema_validation: validations carry a topic
filter list, a check list (schema refs or sql-like predicates), a
strategy (all_pass | any_pass), and a failure action (drop |
disconnect); matched via a topic index, evaluated in order, firing the
'schema.validation_failed' hookpoint and metrics on failure.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Optional

from ..broker.hooks import STOP
from ..broker.message import Message
from ..ops import topic as topic_mod
from ..ops.host_index import TopicTrie
from .registry import (
    SchemaError, SchemaRegistry, check_json_schema, default_registry,
)


class Validation:
    def __init__(self, conf: dict, registry: SchemaRegistry):
        self.name = conf["name"]
        self.topics = list(conf["topics"])
        self.strategy = conf.get("strategy", "all_pass")
        assert self.strategy in ("all_pass", "any_pass")
        self.failure_action = conf.get("failure_action", "drop")
        assert self.failure_action in ("drop", "disconnect", "ignore")
        self.registry = registry
        self.checks: List[dict] = list(conf["checks"])
        self.enabled = conf.get("enabled", True)
        self.matched = 0
        self.succeeded = 0
        self.failed = 0

    def _one(self, check: dict, msg: Message) -> bool:
        ctype = check.get("type", "schema")
        if ctype == "schema":
            try:
                self.registry.check_payload(check["schema"], msg.payload)
                return True
            except SchemaError:
                return False
        if ctype == "json_schema":  # inline schema
            try:
                value = json.loads(msg.payload)
                check_json_schema(check["schema"], value)
                return True
            except (ValueError, SchemaError):
                return False
        if ctype == "predicate":  # callable seam (sql checks analog)
            try:
                return bool(check["fn"](msg))
            except Exception:
                return False
        return False

    def run(self, msg: Message) -> bool:
        self.matched += 1
        results = (self._one(c, msg) for c in self.checks)
        ok = all(results) if self.strategy == "all_pass" else any(results)
        if ok:
            self.succeeded += 1
        else:
            self.failed += 1
        return ok


class SchemaValidation:
    def __init__(self, broker, registry: Optional[SchemaRegistry] = None):
        self.broker = broker
        self.registry = registry or default_registry()
        self._validations: Dict[str, Validation] = {}
        self._order: List[str] = []
        self._index = TopicTrie()
        self._enabled = False

    # --- config ----------------------------------------------------------

    def put(self, conf: dict) -> Validation:
        v = Validation(conf, self.registry)
        # validate EVERYTHING before touching live state — a bad
        # filter must not leave a half-registered validation active
        for flt in v.topics:
            topic_mod.validate_filter(flt)
        old = self._validations.get(v.name)
        if old is not None:
            self._drop_index(old)
        else:
            self._order.append(v.name)
        self._validations[v.name] = v
        for flt in v.topics:
            self._index.insert(topic_mod.words(flt), v.name)
        return v

    def delete(self, name: str) -> bool:
        v = self._validations.pop(name, None)
        if v is None:
            return False
        self._order.remove(name)
        self._drop_index(v)
        return True

    def _drop_index(self, v: Validation) -> None:
        for flt in v.topics:
            try:
                self._index.remove(topic_mod.words(flt), v.name)
            except KeyError:
                pass

    def list(self) -> List[dict]:
        return [
            {
                "name": n,
                "topics": self._validations[n].topics,
                "strategy": self._validations[n].strategy,
                "failure_action": self._validations[n].failure_action,
                "matched": self._validations[n].matched,
                "failed": self._validations[n].failed,
            }
            for n in self._order
        ]

    # --- hook -------------------------------------------------------------

    def enable(self) -> None:
        if not self._enabled:
            # after rewrite (910) / delayed (900), before transformation
            self.broker.hooks.add("message.publish", self._on_publish, priority=860)
            self._enabled = True

    def disable(self) -> None:
        if self._enabled:
            self.broker.hooks.delete("message.publish", self._on_publish)
            self._enabled = False

    def _on_publish(self, msg: Message):
        names = set(self._index.match(topic_mod.words(msg.topic)))
        if not names:
            return None
        for name in self._order:
            if name not in names:
                continue
            v = self._validations[name]
            if not v.enabled or v.run(msg):
                continue
            self.broker.metrics.inc("schema_validation.failed")
            self.broker.hooks.run("schema.validation_failed", msg, name)
            if v.failure_action == "ignore":
                continue
            out = Message(**{**msg.__dict__})
            out.headers = dict(msg.headers, allow_publish=False)
            if v.failure_action == "disconnect":
                out.headers["disconnect"] = True
            return (STOP, out)
        return None
