"""Runtime config store + update handlers.

Analog of emqx_config.erl / emqx_config_handler.erl (SURVEY.md §5):
init_load parses HOCON files, checks them against the root schema, and
the result is served via `get(path)`; zone-aware reads overlay
`zones.<name>` onto the global mqtt root (emqx_zone_schema); runtime
updates go through registered per-path handlers with pre/post
callbacks, re-validate, and are kept in an override layer that can be
persisted (cluster-override file analog).
"""

from __future__ import annotations

import copy
import json
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import hocon
from .schema import SchemaError, Struct

Path = Sequence[str]


class UpdateError(ValueError):
    pass


def _normalize(path: "str | Path") -> Tuple[str, ...]:
    if isinstance(path, str):
        return tuple(path.split("."))
    return tuple(path)


def _deep_get(d: Any, path: Tuple[str, ...], default: Any = KeyError) -> Any:
    cur = d
    for p in path:
        if isinstance(cur, dict) and p in cur:
            cur = cur[p]
        else:
            if default is KeyError:
                raise KeyError(".".join(path))
            return default
    return cur


def _deep_put(d: Dict, path: Tuple[str, ...], value: Any) -> None:
    for p in path[:-1]:
        d = d.setdefault(p, {})
    d[path[-1]] = value


def _deep_merge(base: Dict, over: Dict) -> Dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


class ConfigHandler:
    """Per-path update handler (emqx_config_handler.erl behaviour):
    pre(conf_new) -> conf_new' may rewrite/reject; post(old, new) runs
    side effects (restart listener, rebuild limiter, ...)."""

    def __init__(
        self,
        pre: Optional[Callable[[Any], Any]] = None,
        post: Optional[Callable[[Any, Any], None]] = None,
    ):
        self.pre = pre
        self.post = post


class Config:
    def __init__(self, schema: Struct, data: Optional[Dict[str, Any]] = None):
        self.schema = schema
        self._lock = threading.RLock()
        self._data: Dict[str, Any] = schema.check("", data or {})
        self._overrides: Dict[str, Any] = {}
        self._handlers: Dict[Tuple[str, ...], ConfigHandler] = {}

    # --- load -----------------------------------------------------------

    @classmethod
    def load(
        cls, schema: Struct, files: Sequence[str] = (), text: str = ""
    ) -> "Config":
        """init_load analog: later files override earlier ones."""
        merged: Dict[str, Any] = {}
        for f in files:
            merged = _deep_merge(merged, hocon.load(f))
        if text:
            merged = _deep_merge(merged, hocon.loads(text))
        return cls(schema, merged)

    # --- reads ----------------------------------------------------------

    def get(self, path: "str | Path", default: Any = KeyError) -> Any:
        with self._lock:
            return _deep_get(self._data, _normalize(path), default)

    def get_zone(self, zone: Optional[str], path: "str | Path", default: Any = KeyError) -> Any:
        """Zone-aware read of an mqtt-root setting: zones.<zone>.<path>
        if set, else the global mqtt.<path> (emqx_zone_schema overlay
        semantics — zones mirror the `mqtt` struct)."""
        p = _normalize(path)
        with self._lock:
            if zone:
                v = _deep_get(self._data, ("zones", zone) + p, _MISS)
                if v is not _MISS and v is not None:
                    return v
            return _deep_get(self._data, ("mqtt",) + p, default)

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            return copy.deepcopy(self._data)

    # --- runtime updates ------------------------------------------------

    def add_handler(self, path: "str | Path", handler: ConfigHandler) -> None:
        self._handlers[_normalize(path)] = handler

    def remove_handler(self, path: "str | Path") -> None:
        self._handlers.pop(_normalize(path), None)

    def _handler_for(self, path: Tuple[str, ...]) -> Optional[ConfigHandler]:
        # longest-prefix handler wins (emqx_config_handler path tree)
        for i in range(len(path), 0, -1):
            h = self._handlers.get(path[:i])
            if h is not None:
                return h
        return self._handlers.get(())

    def update(self, path: "str | Path", value: Any) -> Any:
        """Validated runtime update (emqx_config:update): pre-handler →
        schema check of the whole new doc → swap → post-handler."""
        p = _normalize(path)
        h = self._handler_for(p)
        with self._lock:
            old = _deep_get(self._data, p, None)
            if h is not None and h.pre is not None:
                try:
                    value = h.pre(value)
                except Exception as e:
                    raise UpdateError(f"pre_config_update rejected: {e}") from e
            candidate = copy.deepcopy(self._data)
            _deep_put(candidate, p, value)
            try:
                checked = self.schema.check("", candidate)
            except SchemaError as e:
                raise UpdateError(str(e)) from e
            self._data = checked
            _deep_put(self._overrides, p, value)
            new = _deep_get(self._data, p, None)
        if h is not None and h.post is not None:
            h.post(old, new)
        return new

    def remove(self, path: "str | Path") -> None:
        """Drop a path back to its schema default and clear its
        override so persistence won't resurrect it."""
        p = _normalize(path)
        with self._lock:
            candidate = copy.deepcopy(self._data)
            parent = _deep_get(candidate, p[:-1], None)
            if isinstance(parent, dict):
                parent.pop(p[-1], None)
            self._data = self.schema.check("", candidate)
            over_parent = _deep_get(self._overrides, p[:-1], None)
            if isinstance(over_parent, dict):
                over_parent.pop(p[-1], None)

    # --- override persistence (cluster.hocon analog) --------------------

    def dump_overrides(self) -> str:
        with self._lock:
            return json.dumps(self._overrides, indent=2, sort_keys=True)

    def load_overrides(self, text: str) -> None:
        over = json.loads(text)
        with self._lock:
            self._data = self.schema.check("", _deep_merge(self._data, over))
            self._overrides = _deep_merge(self._overrides, over)


_MISS = object()
