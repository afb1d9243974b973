"""Avro binary codec, written from the Avro 1.11 specification (the
port's own copy of emqx_tpu/transform/avro.py).

The reference's schema registry compiles avro schemas through erlavro
(apps/emqx_schema_registry/src/emqx_schema_registry.erl, serde type
`avro`); this is the same wire format from first principles:

    int/long    zigzag varint            float/double  IEEE LE
    bytes/str   long-prefixed            boolean       1 byte
    record      fields in order          enum          int index
    array/map   blocked (count, items, 0 terminator; negative count =
                block byte size follows — accepted on decode)
    union       long index + value      fixed          raw bytes

Schemas are the standard JSON shape (dict / list for unions / name
strings for primitives). Named-type references resolve against the
schema's own definitions (one level of recursion is enough for
self-referential records)."""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

PRIMITIVES = {
    "null", "boolean", "int", "long", "float", "double", "bytes", "string",
}


class AvroError(ValueError):
    pass


def _zz_enc(n: int) -> bytes:
    u = (n << 1) ^ (n >> 63)
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zz_dec(data: bytes, off: int) -> Tuple[int, int]:
    u, shift = 0, 0
    while True:
        if off >= len(data):
            raise AvroError("truncated varint")
        b = data[off]
        off += 1
        u |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return (u >> 1) ^ -(u & 1), off


class AvroSchema:
    """Parsed schema + named-type table; encode/decode entry points."""

    def __init__(self, schema: Any) -> None:
        self.named: Dict[str, Any] = {}
        self.schema = self._index(schema)

    def _index(self, s: Any) -> Any:
        if isinstance(s, dict):
            t = s.get("type")
            if t in ("record", "enum", "fixed"):
                name = s.get("name")
                if not name:
                    raise AvroError(f"{t} needs a name")
                self.named[name] = s
                ns = s.get("namespace")
                if ns:
                    self.named[f"{ns}.{name}"] = s
            if t == "record":
                for f in s.get("fields", []):
                    self._index(f.get("type"))
            elif t == "array":
                self._index(s.get("items"))
            elif t == "map":
                self._index(s.get("values"))
        elif isinstance(s, list):
            for b in s:
                self._index(b)
        return s

    def _resolve(self, s: Any) -> Any:
        if isinstance(s, str) and s not in PRIMITIVES:
            r = self.named.get(s)
            if r is None:
                raise AvroError(f"unknown type {s!r}")
            return r
        if isinstance(s, dict) and isinstance(s.get("type"), str) and (
            s["type"] not in PRIMITIVES
            and s["type"] not in ("record", "enum", "fixed", "array", "map")
        ):
            return self._resolve(s["type"])
        return s

    # --- encode -----------------------------------------------------------

    def encode(self, value: Any) -> bytes:
        return self._enc(self.schema, value)

    def _enc(self, s: Any, v: Any) -> bytes:
        s = self._resolve(s)
        if isinstance(s, list):  # union
            for i, branch in enumerate(s):
                if self._matches(branch, v):
                    return _zz_enc(i) + self._enc(branch, v)
            raise AvroError(f"no union branch for {type(v).__name__}")
        t = s["type"] if isinstance(s, dict) else s
        if t == "null":
            if v is not None:
                raise AvroError("null expects None")
            return b""
        if t == "boolean":
            return b"\x01" if v else b"\x00"
        if t in ("int", "long"):
            return _zz_enc(int(v))
        if t == "float":
            return struct.pack("<f", float(v))
        if t == "double":
            return struct.pack("<d", float(v))
        if t in ("bytes", "string"):
            b = v.encode() if isinstance(v, str) else bytes(v)
            return _zz_enc(len(b)) + b
        if t == "fixed":
            b = bytes(v)
            if len(b) != s["size"]:
                raise AvroError(f"fixed size {s['size']} != {len(b)}")
            return b
        if t == "enum":
            syms = s["symbols"]
            if v not in syms:
                raise AvroError(f"{v!r} not in enum {s.get('name')}")
            return _zz_enc(syms.index(v))
        if t == "array":
            out = b""
            if v:
                out += _zz_enc(len(v))
                for item in v:
                    out += self._enc(s["items"], item)
            return out + _zz_enc(0)
        if t == "map":
            out = b""
            if v:
                out += _zz_enc(len(v))
                for k, item in v.items():
                    out += self._enc("string", k) + self._enc(s["values"], item)
            return out + _zz_enc(0)
        if t == "record":
            out = b""
            for f in s["fields"]:
                name = f["name"]
                if name in v:
                    fv = v[name]
                elif "default" in f:
                    fv = f["default"]
                else:
                    raise AvroError(f"missing record field {name!r}")
                out += self._enc(f["type"], fv)
            return out
        raise AvroError(f"unsupported type {t!r}")

    def _matches(self, s: Any, v: Any) -> bool:
        s = self._resolve(s)
        t = s["type"] if isinstance(s, dict) else s
        if t == "null":
            return v is None
        if t == "boolean":
            return isinstance(v, bool)
        if t in ("int", "long"):
            return isinstance(v, int) and not isinstance(v, bool)
        if t in ("float", "double"):
            return isinstance(v, (int, float)) and not isinstance(v, bool)
        if t == "string":
            return isinstance(v, str)
        if t in ("bytes", "fixed"):
            return isinstance(v, (bytes, bytearray))
        if t == "enum":
            return isinstance(v, str) and v in s.get("symbols", [])
        if t == "array":
            return isinstance(v, list)
        if t in ("map", "record"):
            return isinstance(v, dict)
        return False

    # --- decode -----------------------------------------------------------

    def decode(self, data: bytes) -> Any:
        v, off = self._dec(self.schema, data, 0)
        if off != len(data):
            raise AvroError(f"{len(data) - off} trailing bytes")
        return v

    def _dec(self, s: Any, data: bytes, off: int) -> Tuple[Any, int]:
        s = self._resolve(s)
        if isinstance(s, list):
            idx, off = _zz_dec(data, off)
            if not 0 <= idx < len(s):
                raise AvroError(f"union index {idx} out of range")
            return self._dec(s[idx], data, off)
        t = s["type"] if isinstance(s, dict) else s
        if t == "null":
            return None, off
        if t == "boolean":
            return data[off] != 0, off + 1
        if t in ("int", "long"):
            return _zz_dec(data, off)
        if t == "float":
            return struct.unpack_from("<f", data, off)[0], off + 4
        if t == "double":
            return struct.unpack_from("<d", data, off)[0], off + 8
        if t in ("bytes", "string"):
            n, off = _zz_dec(data, off)
            if n < 0 or off + n > len(data):
                raise AvroError("bad bytes length")
            raw = data[off : off + n]
            off += n
            if t == "string":
                return raw.decode("utf-8"), off
            return bytes(raw), off
        if t == "fixed":
            n = s["size"]
            return bytes(data[off : off + n]), off + n
        if t == "enum":
            idx, off = _zz_dec(data, off)
            syms = s["symbols"]
            if not 0 <= idx < len(syms):
                raise AvroError(f"enum index {idx} out of range")
            return syms[idx], off
        if t == "array":
            out: List[Any] = []
            while True:
                cnt, off = _zz_dec(data, off)
                if cnt == 0:
                    return out, off
                if cnt < 0:  # block size prefix variant
                    cnt = -cnt
                    _sz, off = _zz_dec(data, off)
                for _ in range(cnt):
                    v, off = self._dec(s["items"], data, off)
                    out.append(v)
        if t == "map":
            m: Dict[str, Any] = {}
            while True:
                cnt, off = _zz_dec(data, off)
                if cnt == 0:
                    return m, off
                if cnt < 0:
                    cnt = -cnt
                    _sz, off = _zz_dec(data, off)
                for _ in range(cnt):
                    k, off = self._dec("string", data, off)
                    v, off = self._dec(s["values"], data, off)
                    m[k] = v
        if t == "record":
            rec: Dict[str, Any] = {}
            for f in s["fields"]:
                rec[f["name"]], off = self._dec(f["type"], data, off)
            return rec, off
        raise AvroError(f"unsupported type {t!r}")
