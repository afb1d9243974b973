"""Typed config schema — the typerefl/hocon_schema analog.

The reference validates HOCON against typerefl schemas
(apps/emqx/src/emqx_schema.erl, 4,035 LoC; roots at :204). This module
gives the same shape: struct schemas of typed fields with defaults,
converters for the HOCON scalar idioms (durations "15s" → ms,
bytesizes "100MB" → bytes, percents "80%" → float), enums, unions,
maps-of-structs (zones, listeners), and a `check` pass producing a
plain validated dict — unknown keys rejected, defaults filled.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Sequence


class SchemaError(ValueError):
    def __init__(self, path: str, msg: str):
        self.path = path
        super().__init__(f"{path}: {msg}" if path else msg)


class Type:
    def check(self, path: str, v: Any) -> Any:
        raise NotImplementedError


class Bool(Type):
    def check(self, path, v):
        if isinstance(v, bool):
            return v
        if v in ("true", "false"):
            return v == "true"
        raise SchemaError(path, f"expected bool, got {v!r}")


class Int(Type):
    def __init__(self, min: Optional[int] = None, max: Optional[int] = None):
        self.min, self.max = min, max

    def check(self, path, v):
        if isinstance(v, bool) or not isinstance(v, (int, str)):
            raise SchemaError(path, f"expected int, got {v!r}")
        if isinstance(v, str):
            try:
                v = int(v)
            except ValueError:
                raise SchemaError(path, f"expected int, got {v!r}")
        if self.min is not None and v < self.min:
            raise SchemaError(path, f"{v} < min {self.min}")
        if self.max is not None and v > self.max:
            raise SchemaError(path, f"{v} > max {self.max}")
        return v


class Float(Type):
    def check(self, path, v):
        if isinstance(v, bool) or not isinstance(v, (int, float, str)):
            raise SchemaError(path, f"expected number, got {v!r}")
        if isinstance(v, str):
            if v.endswith("%"):  # percent idiom ("80%")
                return float(v[:-1]) / 100.0
            try:
                f = float(v)
            except ValueError:
                raise SchemaError(path, f"expected number, got {v!r}")
            # "infinity"/"nan" strings are not numbers here — they belong
            # to Enum branches of unions (e.g. rate = infinity)
            if f != f or f in (float("inf"), float("-inf")):
                raise SchemaError(path, f"expected finite number, got {v!r}")
            return f
        return float(v)


class String(Type):
    def __init__(self, pattern: Optional[str] = None):
        self.pattern = re.compile(pattern) if pattern else None

    def check(self, path, v):
        if not isinstance(v, str):
            v = str(v)
        if self.pattern and not self.pattern.match(v):
            raise SchemaError(path, f"{v!r} !~ {self.pattern.pattern}")
        return v


class Enum(Type):
    def __init__(self, *symbols: str):
        self.symbols = symbols

    def check(self, path, v):
        if v in self.symbols:
            return v
        raise SchemaError(path, f"expected one of {self.symbols}, got {v!r}")


_DUR = {
    "d": 86_400_000, "h": 3_600_000, "m": 60_000, "s": 1000, "ms": 1,
}
_DUR_RE = re.compile(r"(\d+(?:\.\d+)?)(d|h|ms|m|s)")


class Duration(Type):
    """'15s' / '1h30m' / bare int (ms) → integer milliseconds."""

    def check(self, path, v):
        if isinstance(v, bool):
            raise SchemaError(path, f"expected duration, got {v!r}")
        if isinstance(v, (int, float)):
            return v if v == float("inf") else int(v)
        if isinstance(v, str):
            if v == "infinity":
                return float("inf")
            pos, total = 0, 0
            for m in _DUR_RE.finditer(v):
                if m.start() != pos:
                    break
                total += float(m.group(1)) * _DUR[m.group(2)]
                pos = m.end()
            if pos == len(v) and pos > 0:
                return int(total)
        raise SchemaError(path, f"expected duration, got {v!r}")


_BYTES = {"kb": 1 << 10, "mb": 1 << 20, "gb": 1 << 30, "b": 1}
_BYTES_RE = re.compile(r"^(\d+(?:\.\d+)?)\s*(kb|mb|gb|b)?$", re.I)


class Bytesize(Type):
    """'100MB' / '512KB' / bare int → integer bytes."""

    def check(self, path, v):
        if isinstance(v, bool):
            raise SchemaError(path, f"expected bytesize, got {v!r}")
        if isinstance(v, (int, float)):
            return v if v == float("inf") else int(v)
        if isinstance(v, str):
            if v == "infinity":
                return float("inf")
            m = _BYTES_RE.match(v)
            if m:
                return int(float(m.group(1)) * _BYTES[(m.group(2) or "b").lower()])
        raise SchemaError(path, f"expected bytesize, got {v!r}")


class Array(Type):
    def __init__(self, elem: "Type | Struct"):
        self.elem = elem

    def check(self, path, v):
        if not isinstance(v, list):
            raise SchemaError(path, f"expected array, got {v!r}")
        return [self.elem.check(f"{path}[{i}]", e) for i, e in enumerate(v)]


class Map(Type):
    """Open map name → value-schema (zones, listeners.tcp.*, ...)."""

    def __init__(self, value: "Type | Struct"):
        self.value = value

    def check(self, path, v):
        if not isinstance(v, dict):
            raise SchemaError(path, f"expected map, got {v!r}")
        return {k: self.value.check(f"{path}.{k}", e) for k, e in v.items()}


class Union(Type):
    def __init__(self, *alts: "Type | Struct"):
        self.alts = alts

    def check(self, path, v):
        errs = []
        for alt in self.alts:
            try:
                return alt.check(path, v)
            except SchemaError as e:
                errs.append(str(e))
        raise SchemaError(path, f"no union branch matched {v!r}: {errs}")


class Field:
    def __init__(
        self,
        type: "Type | Struct",
        default: Any = None,
        required: bool = False,
        validator: Optional[Callable[[Any], Optional[str]]] = None,
        desc: str = "",
    ):
        self.type = type
        self.default = default
        self.required = required
        self.validator = validator
        self.desc = desc


class Struct(Type):
    """A fixed-field object schema; unknown keys are errors (the
    reference rejects unknown roots at load). `sparse` skips default
    filling — used for overlay structs (zones) where absence means
    "inherit from global"."""

    def __init__(
        self, fields: Dict[str, Field], open: bool = False, sparse: bool = False
    ):
        self.fields = fields
        self.open = open
        self.sparse = sparse

    def check(self, path: str, v: Any) -> Dict[str, Any]:
        if v is None:
            v = {}
        if not isinstance(v, dict):
            raise SchemaError(path, f"expected object, got {v!r}")
        out: Dict[str, Any] = {}
        for k, raw in v.items():
            f = self.fields.get(k)
            if f is None:
                if self.open:
                    out[k] = raw
                    continue
                raise SchemaError(path, f"unknown field {k!r}")
            if raw is None and not f.required and not isinstance(f.type, Struct):
                out[k] = None  # explicit unset keeps "no value" semantics
                continue
            val = f.type.check(f"{path}.{k}" if path else k, raw)
            if f.validator is not None:
                err = f.validator(val)
                if err:
                    raise SchemaError(f"{path}.{k}" if path else k, err)
            out[k] = val
        for k, f in self.fields.items():
            if k in out:
                continue
            if f.required:
                raise SchemaError(path, f"missing required field {k!r}")
            if self.sparse:
                continue
            if isinstance(f.type, Struct):
                out[k] = f.type.check(f"{path}.{k}" if path else k, f.default or {})
            else:
                out[k] = f.default
        return out
