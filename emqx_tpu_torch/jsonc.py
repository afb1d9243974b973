"""JSON codec seam: the native codec with its stdlib replay (the port's
own copy of emqx_tpu/jsonc.py).

Every payload encode/decode of the rule engine goes through here. The
port's json.cc (`_emqx_torch_json`, built by emqx_tpu_torch/native)
handles the supported surface — stdlib-default semantics
(ensure_ascii, NaN/Infinity literals, str-keyed objects) plus the
compact `separators=(",", ":")` and `default=` kwargs — and a call
outside it is replayed on stdlib per call, counted in `fallback_*`,
never silently wrong:

  * kwargs outside the native surface (sort_keys/indent/cls/...) ->
    stdlib;
  * native raising TypeError/ValueError (non-str dict keys, circular
    refs, parse rejects) -> replayed on stdlib so callers see stdlib's
    exact exception types (json.JSONDecodeError, circular-reference
    ValueError) and stdlib's coercions (int dict keys).

That replay is the codec's semantics, not a fallback for a missing
build: the codec is on by default, a failed build, import or
byte-parity probe raises `NativeBuildError`, and only
`set_native_enabled(False)` serves stdlib for the process.

The codec's ledger is process-global: payloads are decoded before any
broker exists, so the `emqx_json_*` families render on every scrape
with zero defaults.
"""

from __future__ import annotations

import json as _stdlib_json
from typing import Any, List

from . import native
from .native import NativeBuildError

_mod = None

# the compact-separator form used by the wire call sites; any other
# separators value is outside the native surface
_COMPACT_SEPARATORS = (",", ":")
_NATIVE_DUMPS_KWARGS = frozenset(("separators", "default"))


class JsonMetrics:
    """Process-global codec ledger (`emqx_json_*` families).

    Plain unlocked ints: increments happen on the per-message hot path
    and stay atomic enough under the GIL; tests assert deltas."""

    def __init__(self) -> None:
        self.native_loads = 0
        self.native_dumps = 0
        self.fallback_loads = 0
        self.fallback_dumps = 0

    def snapshot(self) -> dict:
        return {
            "native_loads": self.native_loads,
            "native_dumps": self.native_dumps,
            "fallback_loads": self.fallback_loads,
            "fallback_dumps": self.fallback_dumps,
            "native_enabled": 1 if (_mod is not None and _enabled) else 0,
        }

    def prometheus_lines(self, node_name: str = "emqx@127.0.0.1") -> List[str]:
        node = f'node="{node_name}"'
        enabled = 1 if (_mod is not None and _enabled) else 0
        lines = [
            "# TYPE emqx_json_native_enabled gauge",
            f"emqx_json_native_enabled{{{node}}} {enabled}",
            "# TYPE emqx_json_native_loads_total counter",
            f"emqx_json_native_loads_total{{{node}}} {self.native_loads}",
            "# TYPE emqx_json_native_dumps_total counter",
            f"emqx_json_native_dumps_total{{{node}}} {self.native_dumps}",
            "# TYPE emqx_json_fallback_loads_total counter",
            f"emqx_json_fallback_loads_total{{{node}}} {self.fallback_loads}",
            "# TYPE emqx_json_fallback_dumps_total counter",
            f"emqx_json_fallback_dumps_total{{{node}}} {self.fallback_dumps}",
        ]
        return lines


JSON_METRICS = JsonMetrics()

_enabled = True


def set_native_enabled(flag: bool) -> None:
    """Select the native codec (True, the default) or stdlib (False)
    for every loads and dumps from now on."""
    global _enabled
    _enabled = bool(flag)


def native_enabled() -> bool:
    return _enabled


def _probe(mod) -> bool:
    """Byte parity with stdlib on a doc covering every token kind: a
    build for a foreign ABI fails the import, a miscompiled codec
    fails here."""
    probe = {
        "k": [1, -2.5, 1e16, "é\t\"x\"", None, True, False],
        "n": {"deep": [[]], "big": 10**40},
    }
    try:
        if mod.dumps(probe, 0, None) != _stdlib_json.dumps(probe):
            return False
        return mod.loads(mod.dumps(probe, 1, None)) == probe
    except (ValueError, TypeError):
        return False


def load():
    """The codec extension, built and probed once; raises
    NativeBuildError when either fails."""
    global _mod
    if _mod is None:
        mod = native.load("_emqx_torch_json")
        if not _probe(mod):
            raise NativeBuildError("_emqx_torch_json failed its byte-parity probe")
        _mod = mod
    return _mod


def loads(s: Any) -> Any:
    """Drop-in for json.loads on the payload path (str/bytes input)."""
    m = JSON_METRICS
    if _enabled:
        mod = _mod if _mod is not None else load()
        try:
            out = mod.loads(s)
        except (ValueError, TypeError):
            # native is (deliberately) at least as strict as stdlib;
            # re-run on stdlib so callers get json.JSONDecodeError with
            # stdlib's message/position — or a success if stdlib is
            # laxer on this input
            m.fallback_loads += 1
            return _stdlib_json.loads(s)
        m.native_loads += 1
        return out
    m.fallback_loads += 1
    return _stdlib_json.loads(s)


def dumps(obj: Any, **kwargs: Any) -> str:
    """Drop-in for json.dumps; native handles the stdlib-default and
    compact-separator surfaces, every other call replays on stdlib."""
    m = JSON_METRICS
    if _enabled:
        mod = _mod if _mod is not None else load()
        if not kwargs:  # the hot wire/console call shape
            try:
                out = mod.dumps(obj, 0, None)
            except (TypeError, ValueError):
                pass
            else:
                m.native_dumps += 1
                return out
        elif not (kwargs.keys() - _NATIVE_DUMPS_KWARGS):
            seps = kwargs.get("separators")
            if seps is None or tuple(seps) == _COMPACT_SEPARATORS:
                try:
                    out = mod.dumps(
                        obj,
                        1 if seps is not None else 0,
                        kwargs.get("default"),
                    )
                except (TypeError, ValueError):
                    # non-str dict keys (stdlib coerces), circular
                    # refs (stdlib raises its own ValueError),
                    # default() failures — replay on stdlib for
                    # exact semantics
                    pass
                else:
                    m.native_dumps += 1
                    return out
    m.fallback_dumps += 1
    return _stdlib_json.dumps(obj, **kwargs)
