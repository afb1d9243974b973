"""Transport adapter: the plain TCP byte stream (the TCP half of
emqx_tpu/broker/transport.py).

The reference runs MQTT over four transports — tcp/ssl via esockd
(apps/emqx/src/emqx_listeners.erl:444), ws/wss via cowboy websocket
callbacks. The Channel/Parser stack is byte-oriented and
transport-agnostic, so a transport is a thin adapter with five
operations. The TLS listener and the WebSocket adapter are not ported
yet.
"""

from __future__ import annotations

import asyncio


class TcpTransport:
    """Plain byte stream."""

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
