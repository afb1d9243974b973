"""MQTT frame codec seam: the native wire codec with its Python twin
(the port's copy of emqx_tpu/framec.py).

The serializer is a per-message cost the delivery path cannot amortize:
every PUBLISH fanned out to a fresh (session, proto_ver) pair pays it
once. The port's frame.cc (`_emqx_torch_frame`, built by
emqx_tpu_torch/native) encodes and decodes exactly the hot surface —
PUBLISH, the PUBACK family (PUBACK/PUBREC/PUBREL/PUBCOMP) and SUBACK,
all property-free (v5 packets get the empty ``\\x00`` property block the
Python codec writes for ``props={}``) — and everything outside it is
handed to `broker/frame.py` per packet, counted in `fallback_*`, never
silently wrong:

  * packets with properties, or any other packet type -> Python codec;
  * native raising ValueError (malformed input, out-of-range fields)
    -> replayed on the Python codec so callers see the exact
    `FrameError` (message + MQTT reason code).

The codec is on by default; a failed build or probe raises
`NativeBuildError`, and only `set_native_enabled(False)` runs the
Python codec for the process.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from . import native
from .broker import frame as _pyframe
from .broker.packet import (
    MQTT_V4,
    MQTT_V5,
    Puback,
    Publish,
    Suback,
    Type,
)
from .native import NativeBuildError

_mod = None

FrameError = _pyframe.FrameError


class FrameMetrics:
    """Process-global wire-codec counters. Plain unlocked ints: the
    increments ride the per-packet hot path and stay atomic enough
    under the GIL; tests and chip_smoke.py assert deltas."""

    def __init__(self) -> None:
        self.native_encodes = 0
        self.native_decodes = 0
        self.fallback_encodes = 0
        self.fallback_decodes = 0

    def snapshot(self) -> dict:
        return {
            "native_encodes": self.native_encodes,
            "native_decodes": self.native_decodes,
            "fallback_encodes": self.fallback_encodes,
            "fallback_decodes": self.fallback_decodes,
            "native_enabled": 1 if (_mod is not None and _enabled) else 0,
        }

    def prometheus_lines(self, node_name: str = "emqx@127.0.0.1") -> List[str]:
        node = f'node="{node_name}"'
        enabled = 1 if (_mod is not None and _enabled) else 0
        return [
            "# TYPE emqx_frame_native_enabled gauge",
            f"emqx_frame_native_enabled{{{node}}} {enabled}",
            "# TYPE emqx_frame_native_encodes_total counter",
            f"emqx_frame_native_encodes_total{{{node}}} {self.native_encodes}",
            "# TYPE emqx_frame_native_decodes_total counter",
            f"emqx_frame_native_decodes_total{{{node}}} {self.native_decodes}",
            "# TYPE emqx_frame_fallback_encodes_total counter",
            f"emqx_frame_fallback_encodes_total{{{node}}} "
            f"{self.fallback_encodes}",
            "# TYPE emqx_frame_fallback_decodes_total counter",
            f"emqx_frame_fallback_decodes_total{{{node}}} "
            f"{self.fallback_decodes}",
        ]


FRAME_METRICS = FrameMetrics()

_enabled = True


def set_native_enabled(flag: bool) -> None:
    """Select the native codec (True, the default) or the Python codec
    (False) for every encode and parse from now on."""
    global _enabled
    _enabled = bool(flag)


def native_enabled() -> bool:
    return _enabled


def _probe(mod) -> bool:
    """Byte-parity probe covering every native leg: a build for a
    foreign ABI fails the import; a miscompiled codec fails here,
    byte-for-byte against the Python serializer."""
    pub = Publish(topic="a/b/é", payload=b"\x00\x01payload", qos=1,
                  retain=True, dup=True, packet_id=77)
    pub0 = Publish(topic="t", payload=b"x", qos=0)
    ack = Puback(Type.PUBREL, 515, 0x92)
    sub = Suback(9, [0, 1, 0x80])
    for ver in (MQTT_V4, MQTT_V5):
        v5 = 1 if ver == MQTT_V5 else 0
        if mod.encode_publish(
            pub.topic, pub.payload, pub.qos, 1, 1, pub.packet_id, v5
        ) != _pyframe._serialize_uncached(pub, ver):
            return False
        if mod.encode_publish(
            pub0.topic, pub0.payload, 0, 0, 0, None, v5
        ) != _pyframe._serialize_uncached(pub0, ver):
            return False
        if mod.encode_puback(
            int(ack.type), ack.packet_id, ack.code, v5
        ) != _pyframe._serialize_uncached(ack, ver):
            return False
        if mod.encode_suback(
            sub.packet_id, bytes(sub.codes), v5
        ) != _pyframe._serialize_uncached(sub, ver):
            return False
        # decode leg: round-trip the wire form it just produced
        wire = _pyframe._serialize_uncached(pub, ver)
        got = mod.decode(wire, v5, 1 << 20)
        if got[:7] != (3, pub.topic, pub.payload, 1, 1, 1, 77):
            return False
        if mod.decode(wire[:3], v5, 1 << 20) is not None:
            return False
    # malformed input must raise, not mis-parse
    try:
        mod.decode(b"\x36\x02\x00\x05", 0, 1 << 20)  # QoS 3
        return False
    except ValueError:
        pass
    return True


def load():
    """The codec extension, built and probed once; raises
    NativeBuildError when either fails."""
    global _mod
    if _mod is None:
        mod = native.load("_emqx_torch_frame")
        if not _probe(mod):
            raise NativeBuildError("_emqx_torch_frame failed its byte-parity probe")
        _mod = mod
    return _mod


def _encode_uncached(pkt: Any, proto_ver: int) -> bytes:
    m = FRAME_METRICS
    if _enabled:
        mod = _mod if _mod is not None else load()
        v5 = 1 if proto_ver == MQTT_V5 else 0
        try:
            if type(pkt) is Publish:
                if not pkt.props:
                    out = mod.encode_publish(
                        pkt.topic,
                        pkt.payload,
                        pkt.qos,
                        1 if pkt.retain else 0,
                        1 if pkt.dup else 0,
                        pkt.packet_id,
                        v5,
                    )
                    m.native_encodes += 1
                    return out
            elif type(pkt) is Puback:
                if not pkt.props:
                    out = mod.encode_puback(
                        int(pkt.type), pkt.packet_id, pkt.code, v5
                    )
                    m.native_encodes += 1
                    return out
            elif type(pkt) is Suback:
                if not pkt.props:
                    out = mod.encode_suback(
                        pkt.packet_id, bytes(pkt.codes), v5
                    )
                    m.native_encodes += 1
                    return out
        except (ValueError, TypeError):
            # out-of-range fields, bad payload types: replay on the
            # Python codec so callers get the exact FrameError
            pass
    m.fallback_encodes += 1
    return _pyframe._serialize_uncached(pkt, proto_ver)


def serialize(pkt: Any, proto_ver: int = MQTT_V4) -> bytes:
    """Drop-in for broker.frame.serialize with the same per-proto-ver
    `_wire` memoization (the wide-fanout shared-PUBLISH fast path)."""
    cache = getattr(pkt, "_wire", None)
    if cache is not None:
        hit = cache.get(proto_ver)
        if hit is not None:
            return hit
        data = _encode_uncached(pkt, proto_ver)
        cache[proto_ver] = data
        return data
    return _encode_uncached(pkt, proto_ver)


class Parser(_pyframe.Parser):
    """broker.frame.Parser with the native first-parse leg: complete
    property-free PUBLISH/ack/SUBACK frames decode in C; anything else
    (other packet types, v5 properties, malformed input) re-parses on
    the Python state machine, counted, with its exact FrameError."""

    def _try_parse_one(self) -> Tuple[Optional[Any], int]:
        if not _enabled:
            return super()._try_parse_one()
        mod = _mod if _mod is not None else load()
        m = FRAME_METRICS
        try:
            got = mod.decode(
                self._buf,
                1 if self.proto_ver == MQTT_V5 else 0,
                self.max_packet_size,
            )
        except ValueError:
            m.fallback_decodes += 1
            return super()._try_parse_one()
        if got is None:
            return None, 0
        if got is False:
            m.fallback_decodes += 1
            return super()._try_parse_one()
        m.native_decodes += 1
        ptype = got[0]
        if ptype == Type.PUBLISH:
            _, topic, payload, qos, retain, dup, pid, consumed = got
            return (
                Publish(
                    topic=topic,
                    payload=payload,
                    qos=qos,
                    retain=bool(retain),
                    dup=bool(dup),
                    packet_id=pid,
                ),
                consumed,
            )
        if ptype == Type.SUBACK:
            _, pid, codes, consumed = got
            return Suback(pid, list(codes)), consumed
        _, pid, code, consumed = got
        return Puback(Type(ptype), pid, code), consumed
