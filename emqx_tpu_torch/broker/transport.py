"""Transport adapters: plain TCP and WebSocket (RFC 6455) byte streams.

The reference runs MQTT over four transports — tcp/ssl via esockd
(apps/emqx/src/emqx_listeners.erl:444), ws/wss via cowboy websocket
callbacks (apps/emqx/src/emqx_ws_connection.erl:1-1122). Here the
Channel/Parser stack is byte-oriented and transport-agnostic, so each
transport is a thin adapter with the same four operations; WS framing
(handshake, masking, fragmentation, ping/pong/close) lives entirely in
this module. TLS is not an adapter at all: the TCP listener passes an
`ssl.SSLContext` to asyncio and reads the same byte stream.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import struct
from typing import Optional, Tuple

WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

# ws opcodes
OP_CONT = 0x0
OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA

MAX_WS_HEADER = 8192  # upgrade-request size cap
MAX_WS_FRAME = 16 * 1024 * 1024


class TcpTransport:
    """Plain byte stream (also used under TLS — asyncio wraps it)."""

    ws = False

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer

    def peername(self):
        return self.writer.get_extra_info("peername")

    async def read(self) -> bytes:
        return await self.reader.read(65536)

    def write(self, data: bytes) -> None:
        self.writer.write(data)

    async def drain(self) -> None:
        await self.writer.drain()

    def close(self) -> None:
        try:
            self.writer.close()
        except Exception:
            pass


def ws_accept_key(key: str) -> str:
    return base64.b64encode(
        hashlib.sha1((key + WS_GUID).encode()).digest()
    ).decode()


def ws_encode_frame(opcode: int, payload: bytes, mask: Optional[bytes] = None) -> bytes:
    """One ws frame (FIN set). Servers send unmasked; clients pass a
    4-byte mask (RFC 6455 §5.3)."""
    head = bytearray([0x80 | opcode])
    mbit = 0x80 if mask else 0
    n = len(payload)
    if n < 126:
        head.append(mbit | n)
    elif n < 65536:
        head.append(mbit | 126)
        head += struct.pack(">H", n)
    else:
        head.append(mbit | 127)
        head += struct.pack(">Q", n)
    if mask:
        head += mask
        payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    return bytes(head) + payload


class WsError(Exception):
    pass


async def _read_exact(reader: asyncio.StreamReader, n: int) -> bytes:
    data = await reader.readexactly(n)
    return data


async def ws_read_frame(reader: asyncio.StreamReader) -> Tuple[int, bool, bytes]:
    """Read one frame -> (opcode, fin, payload) with unmasking."""
    h = await _read_exact(reader, 2)
    fin = bool(h[0] & 0x80)
    opcode = h[0] & 0x0F
    masked = bool(h[1] & 0x80)
    n = h[1] & 0x7F
    if n == 126:
        n = struct.unpack(">H", await _read_exact(reader, 2))[0]
    elif n == 127:
        n = struct.unpack(">Q", await _read_exact(reader, 8))[0]
    if n > MAX_WS_FRAME:
        raise WsError("frame too large")
    mask = await _read_exact(reader, 4) if masked else None
    payload = await _read_exact(reader, n) if n else b""
    if mask:
        payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    return opcode, fin, payload


class WsTransport:
    """Server side of MQTT-over-WebSocket: binary frames carry the MQTT
    byte stream; fragmentation is reassembled; PING answered inline;
    CLOSE (or EOF) surfaces as an empty read, which the connection loop
    treats as peer disconnect (emqx_ws_connection handles the same
    events via cowboy callbacks)."""

    ws = True

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self._closed = False

    @classmethod
    async def handshake(
        cls, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
        path: str = "/mqtt",
    ) -> Optional["WsTransport"]:
        """HTTP/1.1 upgrade for the MQTT listener. Returns None (after
        writing an error response) if the request is not a well-formed
        ws upgrade for `path`; advertises the `mqtt` subprotocol when
        offered."""
        got = await cls.handshake_ex(
            reader, writer,
            path_ok=lambda p: p == path,
            subprotocols=("mqtt",),
        )
        return got[0] if got else None

    @classmethod
    async def handshake_ex(
        cls, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
        path_ok, subprotocols: tuple = (),
    ):
        """Generalized upgrade (gateways ride this with their own path
        shapes and subprotocols, e.g. OCPP's /ocpp/{clientid} +
        ocpp1.6). Returns (transport, request_path, chosen_subprotocol)
        or None. When the client offers subprotocols, one of
        `subprotocols` must match (RFC 6455 §1.9); offering none is
        accepted with no subprotocol header."""
        try:
            raw = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            return None
        if len(raw) > MAX_WS_HEADER:
            return None
        lines = raw.decode("latin-1").split("\r\n")
        try:
            method, req_path, _ver = lines[0].split(" ", 2)
        except ValueError:
            return None
        headers = {}
        for ln in lines[1:]:
            if ":" in ln:
                k, v = ln.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        key = headers.get("sec-websocket-key")
        bare_path = req_path.split("?")[0]
        if (
            method != "GET"
            or not path_ok(bare_path)
            or "websocket" not in headers.get("upgrade", "").lower()
            or key is None
        ):
            writer.write(b"HTTP/1.1 400 Bad Request\r\ncontent-length: 0\r\n\r\n")
            return None
        proto_hdr = ""
        chosen = None
        offered = [
            p.strip()
            for p in headers.get("sec-websocket-protocol", "").split(",")
            if p.strip()
        ]
        if offered:
            chosen = next((p for p in offered if p in subprotocols), None)
            if chosen is None:
                writer.write(b"HTTP/1.1 400 Bad Request\r\ncontent-length: 0\r\n\r\n")
                return None
            proto_hdr = f"Sec-WebSocket-Protocol: {chosen}\r\n"
        writer.write(
            (
                "HTTP/1.1 101 Switching Protocols\r\n"
                "Upgrade: websocket\r\n"
                "Connection: Upgrade\r\n"
                f"Sec-WebSocket-Accept: {ws_accept_key(key)}\r\n"
                f"{proto_hdr}\r\n"
            ).encode()
        )
        return cls(reader, writer), req_path, chosen

    def peername(self):
        return self.writer.get_extra_info("peername")

    async def read(self) -> bytes:
        """Next chunk of MQTT bytes (reassembled across continuation
        frames); b'' on close/EOF."""
        buf = b""
        while True:
            try:
                opcode, fin, payload = await ws_read_frame(self.reader)
            except (asyncio.IncompleteReadError, ConnectionError, WsError):
                return b""
            if opcode in (OP_BINARY, OP_CONT, OP_TEXT):
                buf += payload
                # cumulative cap: MAX_WS_FRAME bounds the reassembled
                # message too, or an endless fin=0 continuation stream
                # would grow buf without ever reaching the MQTT
                # parser's own packet-size check
                if len(buf) > MAX_WS_FRAME:
                    return b""
                if fin and buf:
                    return buf
                if fin:
                    continue  # empty complete message: keep waiting
            elif opcode == OP_PING:
                try:
                    self.writer.write(ws_encode_frame(OP_PONG, payload))
                    # drain here: a ping flood from a client that never
                    # reads must hit backpressure, not grow the
                    # transmit buffer (the outer loop only drains after
                    # read() returns)
                    await self.writer.drain()
                except Exception:
                    return b""
            elif opcode == OP_CLOSE:
                if not self._closed:
                    try:
                        self.writer.write(ws_encode_frame(OP_CLOSE, payload[:2]))
                    except Exception:
                        pass
                    self._closed = True
                return b""
            # OP_PONG: ignore

    def write(self, data: bytes) -> None:
        self.writer.write(ws_encode_frame(OP_BINARY, data))

    async def drain(self) -> None:
        await self.writer.drain()

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                self.writer.write(ws_encode_frame(OP_CLOSE, b"\x03\xe8"))
            except Exception:
                pass
        try:
            self.writer.close()
        except Exception:
            pass
