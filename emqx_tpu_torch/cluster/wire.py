"""Compact binary term codec for the cluster planes (the port's own copy
of emqx_tpu/cluster/wire.py).

The reference ships Erlang terms over gen_rpc/dist sockets; the analog
here is a small self-describing binary format covering exactly the
term shapes the protocols use (None/bool/int/float/str/bytes/list/
tuple/dict). Deliberately NOT pickle: decoding untrusted peer bytes
must never execute code.

Frames on the socket are `u32 length || body` (the reference's rpc.py;
the port's `PersistentRetainer` stores one term a KV record).
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

_U32 = struct.Struct(">I")
_I64 = struct.Struct(">q")
_F64 = struct.Struct(">d")


class WireError(Exception):
    pass


def encode(obj: Any) -> bytes:
    out = bytearray()
    _enc(obj, out)
    return bytes(out)


def _enc(o: Any, out: bytearray) -> None:
    if o is None:
        out.append(0x4E)  # 'N'
    elif o is True:
        out.append(0x54)  # 'T'
    elif o is False:
        out.append(0x46)  # 'F'
    elif isinstance(o, int):
        if -(1 << 63) <= o < (1 << 63):
            out.append(0x69)  # 'i'
            out += _I64.pack(o)
        else:  # arbitrary precision fallback
            raw = o.to_bytes((o.bit_length() + 8) // 8, "big", signed=True)
            out.append(0x49)  # 'I'
            out += _U32.pack(len(raw))
            out += raw
    elif isinstance(o, float):
        out.append(0x66)  # 'f'
        out += _F64.pack(o)
    elif isinstance(o, str):
        raw = o.encode("utf-8")
        out.append(0x73)  # 's'
        out += _U32.pack(len(raw))
        out += raw
    elif isinstance(o, (bytes, bytearray, memoryview)):
        raw = bytes(o)
        out.append(0x62)  # 'b'
        out += _U32.pack(len(raw))
        out += raw
    elif isinstance(o, tuple):
        out.append(0x74)  # 't'
        out += _U32.pack(len(o))
        for x in o:
            _enc(x, out)
    elif isinstance(o, (list, set, frozenset)):
        items = list(o)
        out.append(0x6C)  # 'l'
        out += _U32.pack(len(items))
        for x in items:
            _enc(x, out)
    elif isinstance(o, dict):
        out.append(0x64)  # 'd'
        out += _U32.pack(len(o))
        for k, v in o.items():
            _enc(k, out)
            _enc(v, out)
    else:
        raise WireError(f"unencodable type {type(o).__name__}")


MAX_DEPTH = 100  # nesting bound for untrusted input


def decode(buf: bytes) -> Any:
    try:
        obj, off = _dec(buf, 0)
    except WireError:
        raise
    except (struct.error, UnicodeDecodeError, TypeError, OverflowError) as e:
        # untrusted peer bytes must surface as WireError, never as a
        # raw codec exception escaping the rpc server loop
        raise WireError(f"malformed term: {e}") from None
    if off != len(buf):
        raise WireError(f"trailing bytes: {len(buf) - off}")
    return obj


def _take(buf: bytes, off: int, n: int) -> int:
    if off + n > len(buf):
        raise WireError(f"length {n} overruns buffer at {off}")
    return off + n


def _dec(buf: bytes, off: int, depth: int = 0) -> Tuple[Any, int]:
    if depth > MAX_DEPTH:
        raise WireError("nesting too deep")
    try:
        tag = buf[off]
    except IndexError:
        raise WireError("truncated term") from None
    off += 1
    if tag == 0x4E:
        return None, off
    if tag == 0x54:
        return True, off
    if tag == 0x46:
        return False, off
    if tag == 0x69:
        return _I64.unpack_from(buf, off)[0], off + 8
    if tag == 0x49:
        (n,) = _U32.unpack_from(buf, off)
        off = _take(buf, off + 4, n)
        return int.from_bytes(buf[off - n : off], "big", signed=True), off
    if tag == 0x66:
        return _F64.unpack_from(buf, off)[0], off + 8
    if tag == 0x73:
        (n,) = _U32.unpack_from(buf, off)
        off = _take(buf, off + 4, n)
        return buf[off - n : off].decode("utf-8"), off
    if tag == 0x62:
        (n,) = _U32.unpack_from(buf, off)
        off = _take(buf, off + 4, n)
        return bytes(buf[off - n : off]), off
    if tag in (0x74, 0x6C):
        (n,) = _U32.unpack_from(buf, off)
        off += 4
        items = []
        for _ in range(n):
            x, off = _dec(buf, off, depth + 1)
            items.append(x)
        return (tuple(items) if tag == 0x74 else items), off
    if tag == 0x64:
        (n,) = _U32.unpack_from(buf, off)
        off += 4
        d = {}
        for _ in range(n):
            k, off = _dec(buf, off, depth + 1)
            v, off = _dec(buf, off, depth + 1)
            d[k] = v
        return d, off
    raise WireError(f"bad tag 0x{tag:02x} at {off - 1}")
