"""MQTT topic algebra — the pure host-side oracle (the port's own copy
of the parts of emqx_tpu/ops/topic.py that the match path needs).

Behavioral parity with the reference broker's topic module
(apps/emqx/src/emqx_topic.erl): words/join parsing, wildcard detection,
the single-pair matcher `match` (emqx_topic.erl:80-116) that every
index implementation is tested against, topic name/filter validation
for the broker's subscribe path, and `$share/Group/Topic` parsing.

Semantics (MQTT 3.1.1 / 5.0):
  * Topics split on '/'; empty levels are legal distinct words
    ("a//b" == ["a", "", "b"], "/a" == ["", "a"]).
  * '+' matches exactly one level (any value, including empty).
  * '#' matches zero or more trailing levels and must be last
    ("sport/#" matches "sport").
  * A topic whose FIRST level starts with '$' is not matched by a filter
    whose first level is '+' or '#' (emqx_topic.erl:83-101); deeper
    levels have no '$' special-casing.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

Words = Tuple[str, ...]

MAX_TOPIC_LEN = 65535  # wire-format limit (2-byte length prefix)


def words(topic: str) -> Words:
    """Split a topic/filter into its levels. '' -> ('',)."""
    return tuple(topic.split("/"))


def join(ws: Iterable[str]) -> str:
    return "/".join(ws)


def is_wildcard(topic_or_words) -> bool:
    """True if the filter contains '+' or '#' (emqx_topic.erl:65-77)."""
    if isinstance(topic_or_words, str):
        # substring pre-screen then list-contains on the split — both
        # C-level scans
        if "+" not in topic_or_words and "#" not in topic_or_words:
            return False
        ws = topic_or_words.split("/")
        return "+" in ws or "#" in ws
    return any(w in ("+", "#") for w in topic_or_words)


def validate_name(topic: str) -> None:
    """Validate a topic NAME (publish target): no wildcards allowed."""
    _validate_common(topic)
    if is_wildcard(topic):
        raise ValueError(f"wildcard not allowed in topic name: {topic!r}")


def validate_filter(topic: str) -> None:
    """Validate a topic FILTER (subscription). '$share/...' filters are
    validated through share parsing (emqx_topic.erl validate_share)."""
    _validate_common(topic)
    if topic.startswith(SHARE_PREFIX + "/"):
        _, topic = parse_share(topic)
    ws = words(topic)
    for i, w in enumerate(ws):
        if w == "#":
            if i != len(ws) - 1:
                raise ValueError(f"'#' must be the last level: {topic!r}")
        elif "#" in w or "+" in w:
            if w not in ("+", "#"):
                raise ValueError(f"wildcard must occupy entire level: {topic!r}")


def _validate_common(topic: str) -> None:
    if topic == "":
        raise ValueError("empty topic")
    if len(topic.encode("utf-8")) > MAX_TOPIC_LEN:
        raise ValueError("topic too long")
    if "\x00" in topic:
        raise ValueError("NUL byte in topic")


def match(name, flt) -> bool:
    """Does topic `name` match filter `flt`? (emqx_topic.erl:80-116).

    Accepts str or word-tuples for either side. This is the reference
    matcher used as the oracle for every index and kernel.
    """
    nw = words(name) if isinstance(name, str) else tuple(name)
    fw = words(flt) if isinstance(flt, str) else tuple(flt)
    if nw and nw[0].startswith("$") and fw and fw[0] in ("+", "#"):
        return False
    return _match_tokens(nw, fw)


def _match_tokens(nw: Words, fw: Words) -> bool:
    for i, f in enumerate(fw):
        if f == "#" and i == len(fw) - 1:
            return True  # matches remainder, including zero levels
        if i >= len(nw):
            return False
        if f != "+" and f != nw[i]:
            return False
    return len(nw) == len(fw)


# --- shared subscriptions ($share/Group/Topic) --------------------------

SHARE_PREFIX = "$share"


def parse_share(flt: str) -> Tuple[Optional[str], str]:
    """Split '$share/Group/Real/Topic' -> ('Group', 'Real/Topic');
    plain filters -> (None, flt). (emqx_topic.erl make_shared_record)."""
    if flt.startswith(SHARE_PREFIX + "/"):
        rest = flt[len(SHARE_PREFIX) + 1 :]
        group, sep, real = rest.partition("/")
        if not sep or group == "" or real == "":
            raise ValueError(f"malformed shared subscription: {flt!r}")
        if "+" in group or "#" in group:
            raise ValueError(f"wildcard in share group: {flt!r}")
        return group, real
    return None, flt


EXCLUSIVE_PREFIX_STR = "$exclusive/"


def mount_filter(mountpoint: str, flt: str) -> str:
    """Apply a listener mountpoint to a subscription filter, keeping
    $share/$exclusive prefixes OUTSIDE the mount (the reference mounts
    inside the share record, emqx_mountpoint.erl)."""
    if not mountpoint:
        return flt
    if flt.startswith(EXCLUSIVE_PREFIX_STR):
        return EXCLUSIVE_PREFIX_STR + mountpoint + flt[len(EXCLUSIVE_PREFIX_STR):]
    group, real = parse_share(flt)
    if group is not None:
        return f"{SHARE_PREFIX}/{group}/{mountpoint}{real}"
    return mountpoint + flt
