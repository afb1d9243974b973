"""MQTT wire codec: incremental parser + serializer for 3.1/3.1.1/5.0.

The counterpart of the reference's emqx_frame
(apps/emqx/src/emqx_frame.erl:130-158 incremental parse state machine,
:243-255 per-type dispatch, plus the v5 property codec) — rebuilt over
bytes/memoryview. `Parser.feed()` accepts arbitrary byte chunks and
yields complete packets; `serialize()` is the inverse. Round-trip
property-tested in tests/test_frame.py (the analog of
prop_emqx_frame.erl).

The port's own copy of emqx_tpu/broker/frame.py, the pure-Python
codec: the twin of the native codec in `emqx_tpu_torch/framec.py`,
which the broker and the server call and which hands this module
every packet outside its native surface. `serialize` memoizes on a
packet's `_wire` dict, which is the seam the broker's wide-fanout loop
writes through.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

from .packet import (
    MQTT_V3,
    MQTT_V4,
    MQTT_V5,
    Auth,
    Connack,
    Connect,
    Disconnect,
    Packet,
    Pingreq,
    Pingresp,
    Properties,
    Puback,
    Publish,
    Suback,
    SubOpts,
    Subscribe,
    Type,
    Unsuback,
    Unsubscribe,
    Will,
)

MAX_REMAINING_LEN = 268_435_455  # 4-byte varint max
DEFAULT_MAX_PACKET_SIZE = 1 << 20


class FrameError(Exception):
    def __init__(self, msg: str, code: int = 0x81):  # MALFORMED_PACKET
        super().__init__(msg)
        self.code = code


# --- property codec -----------------------------------------------------

_BYTE, _U16, _U32, _VARINT, _BIN, _UTF8, _PAIR = range(7)

# id -> (name, type); MQTT 5.0 §2.2.2.2
_PROPS = {
    0x01: ("payload_format_indicator", _BYTE),
    0x02: ("message_expiry_interval", _U32),
    0x03: ("content_type", _UTF8),
    0x08: ("response_topic", _UTF8),
    0x09: ("correlation_data", _BIN),
    0x0B: ("subscription_identifier", _VARINT),
    0x11: ("session_expiry_interval", _U32),
    0x12: ("assigned_client_identifier", _UTF8),
    0x13: ("server_keep_alive", _U16),
    0x15: ("authentication_method", _UTF8),
    0x16: ("authentication_data", _BIN),
    0x17: ("request_problem_information", _BYTE),
    0x18: ("will_delay_interval", _U32),
    0x19: ("request_response_information", _BYTE),
    0x1A: ("response_information", _UTF8),
    0x1C: ("server_reference", _UTF8),
    0x1F: ("reason_string", _UTF8),
    0x21: ("receive_maximum", _U16),
    0x22: ("topic_alias_maximum", _U16),
    0x23: ("topic_alias", _U16),
    0x24: ("maximum_qos", _BYTE),
    0x25: ("retain_available", _BYTE),
    0x26: ("user_property", _PAIR),
    0x27: ("maximum_packet_size", _U32),
    0x28: ("wildcard_subscription_available", _BYTE),
    0x29: ("subscription_identifier_available", _BYTE),
    0x2A: ("shared_subscription_available", _BYTE),
}
_PROP_IDS = {name: (pid, typ) for pid, (name, typ) in _PROPS.items()}


class _Reader:
    __slots__ = ("buf", "pos", "end")

    def __init__(self, buf: memoryview, pos: int = 0, end: Optional[int] = None):
        self.buf = buf
        self.pos = pos
        self.end = len(buf) if end is None else end

    def remaining(self) -> int:
        return self.end - self.pos

    def need(self, n: int) -> None:
        if self.end - self.pos < n:
            raise FrameError("truncated packet")

    def u8(self) -> int:
        self.need(1)
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def u16(self) -> int:
        self.need(2)
        v = (self.buf[self.pos] << 8) | self.buf[self.pos + 1]
        self.pos += 2
        return v

    def u32(self) -> int:
        self.need(4)
        (v,) = struct.unpack_from(">I", self.buf, self.pos)
        self.pos += 4
        return v

    def varint(self) -> int:
        mult, val = 1, 0
        for _ in range(4):
            b = self.u8()
            val += (b & 0x7F) * mult
            if not b & 0x80:
                return val
            mult <<= 7
        raise FrameError("varint too long")

    def bin(self) -> bytes:
        n = self.u16()
        self.need(n)
        v = bytes(self.buf[self.pos : self.pos + n])
        self.pos += n
        return v

    def utf8(self) -> str:
        raw = self.bin()
        try:
            s = raw.decode("utf-8")
        except UnicodeDecodeError:
            raise FrameError("invalid UTF-8 string")
        if "\x00" in s:
            raise FrameError("NUL in UTF-8 string")
        return s

    def rest(self) -> bytes:
        v = bytes(self.buf[self.pos : self.end])
        self.pos = self.end
        return v


def _read_props(r: _Reader) -> Properties:
    n = r.varint()
    sub = _Reader(r.buf, r.pos, r.pos + n)
    r.need(n)
    r.pos += n
    props: Properties = {}
    while sub.remaining() > 0:
        pid = sub.varint()
        spec = _PROPS.get(pid)
        if spec is None:
            raise FrameError(f"unknown property id {pid}")
        name, typ = spec
        if typ == _BYTE:
            val = sub.u8()
        elif typ == _U16:
            val = sub.u16()
        elif typ == _U32:
            val = sub.u32()
        elif typ == _VARINT:
            val = sub.varint()
        elif typ == _BIN:
            val = sub.bin()
        elif typ == _UTF8:
            val = sub.utf8()
        else:  # _PAIR
            val = (sub.utf8(), sub.utf8())
        if name == "user_property":
            props.setdefault("user_property", []).append(val)
        elif name == "subscription_identifier" and name in props:
            cur = props[name]
            props[name] = (cur if isinstance(cur, list) else [cur]) + [val]
        elif name in props:
            raise FrameError(f"duplicate property {name}", 0x82)
        else:
            props[name] = val
    return props


def _varint_bytes(n: int) -> bytes:
    if n < 0 or n > MAX_REMAINING_LEN:
        raise FrameError("varint out of range")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _utf8_bytes(s: str) -> bytes:
    raw = s.encode("utf-8")
    if len(raw) > 0xFFFF:
        raise FrameError("string too long")
    return struct.pack(">H", len(raw)) + raw


def _bin_bytes(b: bytes) -> bytes:
    if len(b) > 0xFFFF:
        raise FrameError("binary too long")
    return struct.pack(">H", len(b)) + b


def _props_bytes(props: Optional[Properties]) -> bytes:
    body = bytearray()
    for name, val in (props or {}).items():
        pid, typ = _PROP_IDS[name]
        vals = val if name == "user_property" or (
            name == "subscription_identifier" and isinstance(val, list)
        ) else [val]
        for v in vals:
            body += _varint_bytes(pid)
            if typ == _BYTE:
                body.append(v & 0xFF)
            elif typ == _U16:
                body += struct.pack(">H", v)
            elif typ == _U32:
                body += struct.pack(">I", v)
            elif typ == _VARINT:
                body += _varint_bytes(v)
            elif typ == _BIN:
                body += _bin_bytes(v)
            elif typ == _UTF8:
                body += _utf8_bytes(v)
            else:  # _PAIR
                body += _utf8_bytes(v[0]) + _utf8_bytes(v[1])
    return _varint_bytes(len(body)) + bytes(body)


# --- parser -------------------------------------------------------------

_PROTO_NAMES = {("MQIsdp", 3), ("MQTT", 4), ("MQTT", 5)}


class Parser:
    """Incremental MQTT stream parser (emqx_frame:parse/2 analog).

    feed(chunk) -> list of packets parsed so far. Protocol version is
    latched from the CONNECT packet so later packets decode with the
    right property rules; pass proto_ver to pre-pin (e.g. server side
    of a takeover)."""

    def __init__(
        self,
        max_packet_size: int = DEFAULT_MAX_PACKET_SIZE,
        proto_ver: Optional[int] = None,
    ):
        self.max_packet_size = max_packet_size
        self.proto_ver = proto_ver
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[Packet]:
        self._buf += data
        out = []
        while True:
            pkt, consumed = self._try_parse_one()
            if pkt is None:
                break
            del self._buf[:consumed]
            out.append(pkt)
        return out

    def _try_parse_one(self) -> Tuple[Optional[Packet], int]:
        buf = self._buf
        if len(buf) < 2:
            return None, 0
        # remaining-length varint
        rl, mult, i = 0, 1, 1
        while True:
            if i >= len(buf):
                return None, 0
            b = buf[i]
            rl += (b & 0x7F) * mult
            i += 1
            if not b & 0x80:
                break
            if i > 4:
                raise FrameError("remaining length varint too long")
            mult <<= 7
        if 1 + (i - 1) + rl > self.max_packet_size:
            raise FrameError("packet too large", 0x95)
        if len(buf) < i + rl:
            return None, 0
        header = buf[0]
        ptype, flags = header >> 4, header & 0x0F
        r = _Reader(memoryview(bytes(buf[i : i + rl])))
        pkt = self._parse_body(ptype, flags, r)
        if r.remaining():
            raise FrameError("trailing bytes in packet")
        return pkt, i + rl

    def _v5(self) -> bool:
        return self.proto_ver == MQTT_V5

    def _parse_body(self, ptype: int, flags: int, r: _Reader) -> Packet:
        if ptype == Type.CONNECT:
            return self._parse_connect(r)
        if ptype == Type.CONNACK:
            flags_ = r.u8()
            code = r.u8()
            props = _read_props(r) if self._v5() and r.remaining() else {}
            return Connack(bool(flags_ & 1), code, props)
        if ptype == Type.PUBLISH:
            qos = (flags >> 1) & 0x3
            if qos == 3:
                raise FrameError("invalid QoS 3")
            topic = r.utf8()
            pid = r.u16() if qos else None
            props = _read_props(r) if self._v5() else {}
            return Publish(
                topic=topic,
                payload=r.rest(),
                qos=qos,
                retain=bool(flags & 1),
                dup=bool(flags & 8),
                packet_id=pid,
                props=props,
            )
        if ptype in (Type.PUBACK, Type.PUBREC, Type.PUBREL, Type.PUBCOMP):
            if ptype == Type.PUBREL and flags != 0x2:
                raise FrameError("bad PUBREL flags")
            pid = r.u16()
            code, props = 0, {}
            if self._v5() and r.remaining():
                code = r.u8()
                if r.remaining():
                    props = _read_props(r)
            return Puback(Type(ptype), pid, code, props)
        if ptype == Type.SUBSCRIBE:
            if flags != 0x2:
                raise FrameError("bad SUBSCRIBE flags")
            pid = r.u16()
            props = _read_props(r) if self._v5() else {}
            filters = []
            while r.remaining():
                f = r.utf8()
                o = r.u8()
                opts = SubOpts(
                    qos=o & 0x3,
                    no_local=bool(o & 0x4),
                    retain_as_published=bool(o & 0x8),
                    retain_handling=(o >> 4) & 0x3,
                )
                if opts.qos == 3 or (o >> 6):
                    raise FrameError("bad subscription options")
                filters.append((f, opts))
            if not filters:
                raise FrameError("SUBSCRIBE with no filters", 0x82)
            return Subscribe(pid, filters, props)
        if ptype == Type.SUBACK:
            pid = r.u16()
            props = _read_props(r) if self._v5() else {}
            return Suback(pid, list(r.rest()), props)
        if ptype == Type.UNSUBSCRIBE:
            if flags != 0x2:
                raise FrameError("bad UNSUBSCRIBE flags")
            pid = r.u16()
            props = _read_props(r) if self._v5() else {}
            filters = []
            while r.remaining():
                filters.append(r.utf8())
            if not filters:
                raise FrameError("UNSUBSCRIBE with no filters", 0x82)
            return Unsubscribe(pid, filters, props)
        if ptype == Type.UNSUBACK:
            pid = r.u16()
            props = _read_props(r) if self._v5() else {}
            return Unsuback(pid, list(r.rest()) if self._v5() else [], props)
        if ptype == Type.PINGREQ:
            return Pingreq()
        if ptype == Type.PINGRESP:
            return Pingresp()
        if ptype == Type.DISCONNECT:
            code, props = 0, {}
            if self._v5() and r.remaining():
                code = r.u8()
                if r.remaining():
                    props = _read_props(r)
            return Disconnect(code, props)
        if ptype == Type.AUTH:
            code, props = 0, {}
            if r.remaining():
                code = r.u8()
                if r.remaining():
                    props = _read_props(r)
            return Auth(code, props)
        raise FrameError(f"unknown packet type {ptype}")

    def _parse_connect(self, r: _Reader) -> Connect:
        name = r.utf8()
        ver = r.u8()
        if (name, ver) not in _PROTO_NAMES:
            raise FrameError(f"bad protocol {name!r} v{ver}", 0x84)
        cflags = r.u8()
        if cflags & 0x01:
            raise FrameError("reserved connect flag set")
        keepalive = r.u16()
        self.proto_ver = ver
        props = _read_props(r) if ver == MQTT_V5 else {}
        client_id = r.utf8()
        will = None
        if cflags & 0x04:
            wprops = _read_props(r) if ver == MQTT_V5 else {}
            wtopic = r.utf8()
            wpayload = r.bin()
            will = Will(
                topic=wtopic,
                payload=wpayload,
                qos=(cflags >> 3) & 0x3,
                retain=bool(cflags & 0x20),
                props=wprops,
            )
            if will.qos == 3:
                raise FrameError("bad will QoS")
        elif cflags & 0x38:
            raise FrameError("will flags without will")
        username = r.utf8() if cflags & 0x80 else None
        password = r.bin() if cflags & 0x40 else None
        return Connect(
            proto_name=name,
            proto_ver=ver,
            clean_start=bool(cflags & 0x02),
            keepalive=keepalive,
            client_id=client_id,
            will=will,
            username=username,
            password=password,
            props=props,
        )


# --- serializer ---------------------------------------------------------

def _fixed(ptype: int, flags: int, body: bytes) -> bytes:
    return bytes([(ptype << 4) | flags]) + _varint_bytes(len(body)) + body


def serialize(pkt: Packet, proto_ver: int = MQTT_V4) -> bytes:
    # wide-fanout fast path: a packet carrying a `_wire` dict memoizes
    # its wire form per protocol version, so one shared QoS0 PUBLISH
    # serializes once and every subscriber's sink writes cached bytes
    # (the fanout loop of emqx_broker.erl:726-760 pays serialization
    # per subscriber; we pay it per distinct protocol version)
    cache = getattr(pkt, "_wire", None)
    if cache is not None:
        hit = cache.get(proto_ver)
        if hit is not None:
            return hit
        data = _serialize_uncached(pkt, proto_ver)
        cache[proto_ver] = data
        return data
    return _serialize_uncached(pkt, proto_ver)


def _serialize_uncached(pkt: Packet, proto_ver: int = MQTT_V4) -> bytes:
    v5 = proto_ver == MQTT_V5
    if isinstance(pkt, Connect):
        v5c = pkt.proto_ver == MQTT_V5
        body = bytearray()
        body += _utf8_bytes(pkt.proto_name)
        body.append(pkt.proto_ver)
        cflags = 0
        if pkt.clean_start:
            cflags |= 0x02
        if pkt.will:
            cflags |= 0x04 | (pkt.will.qos << 3) | (0x20 if pkt.will.retain else 0)
        if pkt.username is not None:
            cflags |= 0x80
        if pkt.password is not None:
            cflags |= 0x40
        body.append(cflags)
        body += struct.pack(">H", pkt.keepalive)
        if v5c:
            body += _props_bytes(pkt.props)
        body += _utf8_bytes(pkt.client_id)
        if pkt.will:
            if v5c:
                body += _props_bytes(pkt.will.props)
            body += _utf8_bytes(pkt.will.topic)
            body += _bin_bytes(pkt.will.payload)
        if pkt.username is not None:
            body += _utf8_bytes(pkt.username)
        if pkt.password is not None:
            body += _bin_bytes(pkt.password)
        return _fixed(Type.CONNECT, 0, bytes(body))
    if isinstance(pkt, Connack):
        body = bytes([1 if pkt.session_present else 0, pkt.code])
        if v5:
            body += _props_bytes(pkt.props)
        return _fixed(Type.CONNACK, 0, body)
    if isinstance(pkt, Publish):
        flags = (0x8 if pkt.dup else 0) | (pkt.qos << 1) | (1 if pkt.retain else 0)
        body = bytearray(_utf8_bytes(pkt.topic))
        if pkt.qos:
            if pkt.packet_id is None:
                raise FrameError("qos>0 PUBLISH without packet id")
            body += struct.pack(">H", pkt.packet_id)
        if v5:
            body += _props_bytes(pkt.props)
        body += pkt.payload
        return _fixed(Type.PUBLISH, flags, bytes(body))
    if isinstance(pkt, Puback):
        flags = 0x2 if pkt.type == Type.PUBREL else 0
        body = struct.pack(">H", pkt.packet_id)
        if v5 and (pkt.code or pkt.props):
            body += bytes([pkt.code])
            if pkt.props:
                body += _props_bytes(pkt.props)
        return _fixed(pkt.type, flags, body)
    if isinstance(pkt, Subscribe):
        body = bytearray(struct.pack(">H", pkt.packet_id))
        if v5:
            body += _props_bytes(pkt.props)
        for f, o in pkt.filters:
            body += _utf8_bytes(f)
            body.append(
                o.qos
                | (0x4 if o.no_local else 0)
                | (0x8 if o.retain_as_published else 0)
                | (o.retain_handling << 4)
            )
        return _fixed(Type.SUBSCRIBE, 0x2, bytes(body))
    if isinstance(pkt, Suback):
        body = struct.pack(">H", pkt.packet_id)
        if v5:
            body += _props_bytes(pkt.props)
        body += bytes(pkt.codes)
        return _fixed(Type.SUBACK, 0, body)
    if isinstance(pkt, Unsubscribe):
        body = bytearray(struct.pack(">H", pkt.packet_id))
        if v5:
            body += _props_bytes(pkt.props)
        for f in pkt.filters:
            body += _utf8_bytes(f)
        return _fixed(Type.UNSUBSCRIBE, 0x2, bytes(body))
    if isinstance(pkt, Unsuback):
        body = struct.pack(">H", pkt.packet_id)
        if v5:
            body += _props_bytes(pkt.props)
            body += bytes(pkt.codes)
        return _fixed(Type.UNSUBACK, 0, body)
    if isinstance(pkt, Pingreq):
        return _fixed(Type.PINGREQ, 0, b"")
    if isinstance(pkt, Pingresp):
        return _fixed(Type.PINGRESP, 0, b"")
    if isinstance(pkt, Disconnect):
        if v5 and (pkt.code or pkt.props):
            body = bytes([pkt.code]) + (_props_bytes(pkt.props) if pkt.props else b"")
        else:
            body = b""
        return _fixed(Type.DISCONNECT, 0, body)
    if isinstance(pkt, Auth):
        body = b""
        if pkt.code or pkt.props:
            body = bytes([pkt.code]) + _props_bytes(pkt.props)
        return _fixed(Type.AUTH, 0, body)
    raise FrameError(f"cannot serialize {type(pkt).__name__}")
