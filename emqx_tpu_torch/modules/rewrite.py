"""Topic rewrite: regex-driven rewriting of publish topics and
subscribe/unsubscribe filters.

Parity with apps/emqx_modules/src/emqx_rewrite.erl: each rule has an
action (publish | subscribe | all), a source topic FILTER gating which
topics the rule applies to, a regex, and a destination template with
$N backreferences; first matching rule wins per action.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

from ..broker.message import Message
from ..ops import topic as topic_mod


class RewriteRule:
    def __init__(self, action: str, source: str, regex: str, dest: str):
        assert action in ("publish", "subscribe", "all"), action
        self.action = action
        self.source_words = topic_mod.words(source)
        self.re = re.compile(regex)
        # $N backreferences become \g<N> for a SINGLE-pass expand:
        # sequential str.replace would re-substitute inside earlier
        # groups' matched text (topic 'x/$2/b' corrupting) and break
        # on $10+. Group references are validated HERE so a bad rule
        # fails at config time, not on every matching publish.
        refs = [int(n) for n in re.findall(r"\$(\d+)", dest)]
        if refs and max(refs) > self.re.groups:
            raise ValueError(
                f"dest_topic references group ${max(refs)} but the regex "
                f"has {self.re.groups} group(s)"
            )
        # literal backslashes in dest must not read as expand escapes
        self.dest_tpl = re.sub(
            r"\$(\d+)", r"\\g<\1>", dest.replace("\\", "\\\\")
        )

    def apply(self, topic: str) -> Optional[str]:
        if not topic_mod.match(topic_mod.words(topic), self.source_words):
            return None
        m = self.re.search(topic)
        if m is None:
            return None
        return m.expand(self.dest_tpl)


class TopicRewrite:
    def __init__(self, broker, rules: Optional[List[dict]] = None):
        self.broker = broker
        self.rules: List[RewriteRule] = [
            RewriteRule(
                r.get("action", "all"),
                r["source_topic"],
                r.get("re", ".*"),
                r["dest_topic"],
            )
            for r in (rules or [])
        ]
        self._enabled = False

    def enable(self) -> None:
        if self._enabled:
            return
        h = self.broker.hooks
        h.add("message.publish", self._on_publish, priority=910)
        h.add("client.subscribe", self._on_subscribe, priority=910)
        h.add("client.unsubscribe", self._on_unsubscribe, priority=910)
        self._enabled = True

    def disable(self) -> None:
        if not self._enabled:
            return
        h = self.broker.hooks
        h.delete("message.publish", self._on_publish)
        h.delete("client.subscribe", self._on_subscribe)
        h.delete("client.unsubscribe", self._on_unsubscribe)
        self._enabled = False

    def rewrite(self, topic: str, action: str) -> str:
        """First rule whose action covers `action` and whose
        source-filter + regex both match wins (emqx_rewrite:match_rule)."""
        for rule in self.rules:
            if rule.action not in (action, "all"):
                continue
            out = rule.apply(topic)
            if out is not None:
                return out
        return topic

    # --- hooks ----------------------------------------------------------

    def _on_publish(self, msg: Message):
        new = self.rewrite(msg.topic, "publish")
        if new == msg.topic:
            return None
        out = Message(**{**msg.__dict__})
        out.topic = new
        return out

    def _on_subscribe(self, _client_id, filters):
        """client.subscribe fold: filters is [(filter, SubOpts)].
        $share prefixes are preserved; only the real filter rewrites
        (the reference rewrites inside the share record)."""
        out = []
        changed = False
        for flt, opts in filters:
            group, real = topic_mod.parse_share(flt)
            new = self.rewrite(real, "subscribe")
            if new != real:
                changed = True
                flt = f"$share/{group}/{new}" if group is not None else new
            out.append((flt, opts))
        return out if changed else None

    def _on_unsubscribe(self, _client_id, filters):
        """client.unsubscribe fold: bare filter list. Must apply the
        SAME subscribe-direction rewrite, or a client could never
        unsubscribe from a rewritten subscription."""
        out = []
        changed = False
        for flt in filters:
            group, real = topic_mod.parse_share(flt)
            new = self.rewrite(real, "subscribe")
            if new != real:
                changed = True
                flt = f"$share/{group}/{new}" if group is not None else new
            out.append(flt)
        return out if changed else None
