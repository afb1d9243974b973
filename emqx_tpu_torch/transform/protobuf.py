"""Protobuf (proto3 subset): a .proto source parser + wire codec (the
port's own copy of emqx_tpu/transform/protobuf.py).

The reference compiles .proto sources at runtime (gpb behind
apps/emqx_schema_registry, serde type `protobuf`); this module covers
the subset IoT payload schemas actually use — scalar fields, repeated
fields, nested/imported-by-name message types and enums:

    wire types: 0 varint (int32/64, uint, sint zigzag, bool, enum)
                1 64-bit (fixed64, sfixed64, double)
                2 length-delimited (string, bytes, message, packed)
                5 32-bit (fixed32, sfixed32, float)

Unknown fields are skipped on decode (proto3 semantics); missing
fields decode to defaults. oneof/groups/maps/services are not
supported and raise at PARSE time — a schema the codec can't honor is
rejected when it is registered, never mid-traffic.
"""

from __future__ import annotations

import re
import struct
from typing import Any, Dict, List, Optional, Tuple


class ProtobufError(ValueError):
    pass


_SCALARS = {
    "double", "float", "int32", "int64", "uint32", "uint64", "sint32",
    "sint64", "fixed32", "fixed64", "sfixed32", "sfixed64", "bool",
    "string", "bytes",
}
_VARINT = {"int32", "int64", "uint32", "uint64", "sint32", "sint64", "bool"}
_UNSUPPORTED = ("oneof", "group", "map<", "service", "extend")


class Field:
    def __init__(self, name: str, ftype: str, number: int, repeated: bool):
        self.name = name
        self.ftype = ftype
        self.number = number
        self.repeated = repeated


class ProtoFile:
    """Parsed .proto: message name -> fields, enum name -> symbol map."""

    def __init__(self, source: str) -> None:
        self.messages: Dict[str, List[Field]] = {}
        self.enums: Dict[str, Dict[str, int]] = {}
        self._parse(source)

    def _parse(self, src: str) -> None:
        src = re.sub(r"//[^\n]*", "", src)
        src = re.sub(r"/\*.*?\*/", "", src, flags=re.S)
        for kw in _UNSUPPORTED:
            if kw in src:
                raise ProtobufError(f"unsupported proto feature: {kw}")
        # nested blocks flatten into the global namespace (enough for
        # the flat schemas bridges carry; name clashes reject)
        self._parse_block(src, "")

    def _parse_block(self, src: str, prefix: str) -> None:
        pos = 0
        while True:
            m = re.search(r"\b(message|enum)\s+(\w+)\s*\{", src[pos:])
            if m is None:
                break
            kind, name = m.group(1), m.group(2)
            start = pos + m.end()
            depth = 1
            i = start
            while i < len(src) and depth:
                if src[i] == "{":
                    depth += 1
                elif src[i] == "}":
                    depth -= 1
                i += 1
            if depth:
                raise ProtobufError(f"unbalanced braces in {name}")
            body = src[start : i - 1]
            if name in self.messages or name in self.enums:
                raise ProtobufError(f"duplicate type {name}")
            if kind == "enum":
                self._parse_enum(name, body)
            else:
                self._parse_block(body, name)  # nested types first
                self._parse_message(name, body)
            pos = i

    def _parse_enum(self, name: str, body: str) -> None:
        syms: Dict[str, int] = {}
        for sm in re.finditer(r"(\w+)\s*=\s*(-?\d+)\s*;", body):
            syms[sm.group(1)] = int(sm.group(2))
        self.enums[name] = syms

    def _parse_message(self, name: str, body: str) -> None:
        # strip nested blocks already handled
        flat = re.sub(r"\b(message|enum)\s+\w+\s*\{[^{}]*\}", "", body)
        fields: List[Field] = []
        for fm in re.finditer(
            r"(repeated\s+|optional\s+|required\s+)?(\w+)\s+(\w+)\s*=\s*(\d+)",
            flat,
        ):
            label, ftype, fname, num = fm.groups()
            if ftype in ("message", "enum", "syntax", "package", "option"):
                continue
            fields.append(Field(
                fname, ftype, int(num),
                (label or "").strip() == "repeated",
            ))
        self.messages[name] = fields

    def field_type(self, f: Field) -> str:
        if f.ftype in _SCALARS:
            return f.ftype
        if f.ftype in self.enums:
            return "enum"
        if f.ftype in self.messages:
            return "message"
        raise ProtobufError(f"unknown field type {f.ftype!r}")


def _uvarint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_uvarint(data: bytes, off: int) -> Tuple[int, int]:
    u, shift = 0, 0
    while True:
        if off >= len(data):
            raise ProtobufError("truncated varint")
        b = data[off]
        off += 1
        u |= (b & 0x7F) << shift
        if not b & 0x80:
            return u, off
        shift += 7
        if shift > 70:
            raise ProtobufError("varint too long")


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _unzigzag(u: int) -> int:
    return (u >> 1) ^ -(u & 1)


class ProtoCodec:
    def __init__(self, proto: ProtoFile, message_type: str) -> None:
        if message_type not in proto.messages:
            raise ProtobufError(f"message {message_type!r} not defined")
        self.proto = proto
        self.message_type = message_type

    # --- encode ----------------------------------------------------------

    def encode(self, value: Dict[str, Any],
               mtype: Optional[str] = None) -> bytes:
        mtype = mtype or self.message_type
        out = bytearray()
        for f in self.proto.messages[mtype]:
            if f.name not in value or value[f.name] is None:
                continue
            vs = value[f.name] if f.repeated else [value[f.name]]
            for v in vs:
                out += self._enc_field(f, v)
        return bytes(out)

    def _enc_field(self, f: Field, v: Any) -> bytes:
        ft = self.proto.field_type(f)
        num = f.number
        if ft == "message":
            body = self.encode(v, f.ftype)
            return _uvarint((num << 3) | 2) + _uvarint(len(body)) + body
        if ft == "enum":
            syms = self.proto.enums[f.ftype]
            iv = syms[v] if isinstance(v, str) else int(v)
            return _uvarint((num << 3) | 0) + _uvarint(iv & 0xFFFFFFFFFFFFFFFF)
        t = f.ftype
        if t in _VARINT:
            if t in ("sint32", "sint64"):
                u = _zigzag(int(v))
            elif t == "bool":
                u = 1 if v else 0
            else:
                u = int(v) & 0xFFFFFFFFFFFFFFFF
            return _uvarint((num << 3) | 0) + _uvarint(u)
        if t in ("fixed64", "sfixed64", "double"):
            fmt = {"double": "<d", "fixed64": "<Q", "sfixed64": "<q"}[t]
            return _uvarint((num << 3) | 1) + struct.pack(fmt, v)
        if t in ("fixed32", "sfixed32", "float"):
            fmt = {"float": "<f", "fixed32": "<I", "sfixed32": "<i"}[t]
            return _uvarint((num << 3) | 5) + struct.pack(fmt, v)
        if t in ("string", "bytes"):
            b = v.encode() if isinstance(v, str) else bytes(v)
            return _uvarint((num << 3) | 2) + _uvarint(len(b)) + b
        raise ProtobufError(f"cannot encode type {t!r}")

    # --- decode ----------------------------------------------------------

    def decode(self, data: bytes, mtype: Optional[str] = None) -> Dict[str, Any]:
        mtype = mtype or self.message_type
        fields = {f.number: f for f in self.proto.messages[mtype]}
        out: Dict[str, Any] = {
            f.name: [] for f in fields.values() if f.repeated
        }
        off = 0
        n = len(data)
        while off < n:
            tag, off = _read_uvarint(data, off)
            num, wt = tag >> 3, tag & 0x7
            f = fields.get(num)
            if wt == 0:
                u, off = _read_uvarint(data, off)
                raw: Any = u
            elif wt == 1:
                raw = data[off : off + 8]
                off += 8
            elif wt == 2:
                ln, off = _read_uvarint(data, off)
                if off + ln > n:
                    raise ProtobufError("truncated length-delimited field")
                raw = data[off : off + ln]
                off += ln
            elif wt == 5:
                raw = data[off : off + 4]
                off += 4
            else:
                raise ProtobufError(f"unsupported wire type {wt}")
            if f is None:
                continue  # unknown field: proto3 skip
            v = self._coerce(f, wt, raw)
            if f.repeated:
                if isinstance(v, list):
                    out[f.name].extend(v)  # packed
                else:
                    out[f.name].append(v)
            else:
                out[f.name] = v
        return out

    def _coerce(self, f: Field, wt: int, raw: Any) -> Any:
        ft = self.proto.field_type(f)
        if ft == "message":
            return self.decode(bytes(raw), f.ftype)
        if ft == "enum":
            rev = {v: k for k, v in self.proto.enums[f.ftype].items()}
            return rev.get(int(raw), int(raw))
        t = f.ftype
        if t in _VARINT and wt == 0:
            if t in ("sint32", "sint64"):
                return _unzigzag(raw)
            if t == "bool":
                return bool(raw)
            if t in ("int32", "int64") and raw >= 1 << 63:
                return raw - (1 << 64)  # negative two's complement
            return raw
        if wt == 2 and t in _VARINT and f.repeated:
            vals = []  # packed repeated varints
            off = 0
            while off < len(raw):
                u, off = _read_uvarint(raw, off)
                vals.append(
                    _unzigzag(u) if t in ("sint32", "sint64") else u
                )
            return vals
        if t == "double":
            return struct.unpack("<d", raw)[0]
        if t == "float":
            return struct.unpack("<f", raw)[0]
        if t in ("fixed64",):
            return struct.unpack("<Q", raw)[0]
        if t in ("sfixed64",):
            return struct.unpack("<q", raw)[0]
        if t in ("fixed32",):
            return struct.unpack("<I", raw)[0]
        if t in ("sfixed32",):
            return struct.unpack("<i", raw)[0]
        if t == "string":
            return bytes(raw).decode("utf-8")
        if t == "bytes":
            return bytes(raw)
        raise ProtobufError(f"cannot decode {t!r} (wire type {wt})")


def make_codec_cache(proto: "ProtoFile"):
    """Per-proto memoized ProtoCodec lookup: cache = make_codec_cache(p);
    cache("MsgType") -> codec. Shared by the gRPC-speaking modules."""
    codecs: Dict[str, ProtoCodec] = {}

    def get(mtype: str) -> ProtoCodec:
        c = codecs.get(mtype)
        if c is None:
            c = codecs[mtype] = ProtoCodec(proto, mtype)
        return c

    return get
