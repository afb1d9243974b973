"""Asyncio TCP front end: the esockd/emqx_connection analog (the port's
copy of emqx_tpu/broker/server.py).

One Connection task per client socket (the reference runs one Erlang
process per connection, emqx_connection.erl:315); inbound bytes flow
through the incremental Parser into the Channel; deliveries from other
sessions arrive via the session's outgoing sink.

    python -m emqx_tpu_torch.broker.server --port 1883 [--device cpu]

serves on the CUDA card by default (raising without one), with
wildcard retained reads through the device index (kernel K8). Frames
parse and serialize through `framec`, the native codec seam over the
pure-Python `frame` module. The listener options of the reference (TLS,
mountpoint, zone config, rate limits, load shedding, eviction holds)
and the WebSocket listener are not ported yet.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from .. import framec
from . import frame
from .channel import KEEPALIVE_MULTIPLIER, Channel, ProtocolError
from .packet import Connect, Disconnect, MQTT_V5, Publish, Subscribe
from .pubsub import Broker
from .transport import TcpTransport

log = logging.getLogger("emqx_tpu_torch.server")

# the parser's inbound limit, advertised in CONNACK
MAX_PACKET_SIZE = frame.DEFAULT_MAX_PACKET_SIZE
# seconds a socket may stay open before its CONNECT arrives
CONNECT_TIMEOUT = 10.0


class Connection:
    def __init__(self, server: "Server", transport):
        self.server = server
        self.transport = transport
        peer = transport.peername()
        # normalize to "ip:port" (banned/flapping/trace match on the ip)
        if isinstance(peer, (tuple, list)) and len(peer) >= 2:
            peer = f"{peer[0]}:{peer[1]}"
        self.channel = Channel(
            server.broker, peer=str(peer), max_packet_size=MAX_PACKET_SIZE
        )
        self.parser = framec.Parser(max_packet_size=MAX_PACKET_SIZE)

    def _wire_sink(self) -> None:
        sess = self.channel.session
        if sess is not None:
            sess.outgoing_sink = self._send_packets
            sess.outgoing_sink_bytes = self._send_bytes
            sess.sink_proto_ver = self.channel.proto_ver
            # admin kick severs the socket through this
            sess.closer = self.transport.close

    def _send_bytes(self, data: bytes) -> None:
        """Fanout fast path: one shared QoS0 PUBLISH, serialized once
        per (proto version, retain) by the broker, written verbatim."""
        try:
            limit = self.channel.client_max_packet
            if limit is not None and len(data) > limit:
                self.server.broker.metrics.inc("delivery.dropped.too_large")
                return
            self.transport.write(data)
        except Exception:  # connection already gone
            pass

    def _send_packets(self, pkts) -> None:
        try:
            ver = self.channel.proto_ver
            chunks = []
            limit = self.channel.client_max_packet
            for p in pkts:
                wire = framec.serialize(p, ver)
                # client's maximum_packet_size: drop, don't send
                # (MQTT-5 §3.1.2.11.4; the reference counts
                # 'delivery.dropped.too_large')
                if (
                    limit is not None
                    and len(wire) > limit
                    and isinstance(p, Publish)
                ):
                    self.server.broker.metrics.inc("delivery.dropped.too_large")
                    # release the inflight slot or the window shrinks
                    # permanently — the client will never ack a packet
                    # it never received
                    sess = self.channel.session
                    if p.packet_id is not None and sess is not None:
                        sess.forget_inflight(p.packet_id)
                    continue
                chunks.append(wire)
            self.transport.write(b"".join(chunks))
        except Exception:  # connection already gone; session keeps state
            pass

    async def run(self) -> None:
        try:
            while True:
                timeout = None
                if self.channel.keepalive:
                    timeout = self.channel.keepalive * KEEPALIVE_MULTIPLIER
                elif not self.channel.connected:
                    timeout = CONNECT_TIMEOUT
                try:
                    data = await asyncio.wait_for(
                        self.transport.read(), timeout=timeout
                    )
                except asyncio.TimeoutError:
                    break  # keepalive/connect timeout
                if not data:
                    break
                try:
                    pkts = self.parser.feed(data)
                except frame.FrameError as e:
                    if self.channel.proto_ver == MQTT_V5 and self.channel.connected:
                        self._send_packets([Disconnect(e.code)])
                    break
                for pkt in pkts:
                    if isinstance(pkt, Connect) and not self.channel.connected:
                        hooks = self.server.broker.hooks
                        # 'client.connect' gate (license quota, exhook
                        # OnClientConnect) runs FIRST — a shed CONNECT
                        # must not cost an auth-backend round trip. Run
                        # it off-loop when a slow (out-of-proc) hook is
                        # registered, same posture as authenticate.
                        cinfo = dict(
                            client_id=pkt.client_id,
                            username=pkt.username,
                            proto_ver=pkt.proto_ver,
                            keepalive=pkt.keepalive,
                            clean_start=pkt.clean_start,
                            peer=self.channel.peer,
                        )
                        if hooks.has_slow("client.connect"):
                            cverdict = await (
                                asyncio.get_running_loop().run_in_executor(
                                    None,
                                    lambda: hooks.run_fold(
                                        "client.connect", (cinfo,), True
                                    ),
                                )
                            )
                        elif hooks.has("client.connect"):
                            cverdict = hooks.run_fold(
                                "client.connect", (cinfo,), True
                            )
                        else:
                            cverdict = True
                        self.channel.preconnect = (pkt.client_id, cverdict)
                        if cverdict is not True:
                            # shed before the auth fold runs at all
                            self.channel.preauth = (pkt.client_id, True)
                        else:
                            # run the authenticate fold OFF-loop:
                            # providers doing network IO (HTTP authn)
                            # block for up to their timeout, and that
                            # must stall only THIS connection — never
                            # the whole broker loop
                            info = dict(
                                client_id=pkt.client_id,
                                username=pkt.username,
                                password=pkt.password,
                                peer=self.channel.peer,
                            )
                            verdict = await (
                                asyncio.get_running_loop().run_in_executor(
                                    None,
                                    lambda: hooks.run_fold(
                                        "client.authenticate", (info,), True
                                    ),
                                )
                            )
                            self.channel.preauth = (pkt.client_id, verdict)
                    if self.channel.connected and isinstance(
                        pkt, (Publish, Subscribe)
                    ):
                        # verdicts are scoped to THIS packet: always
                        # reset so nothing stale survives a has_slow
                        # flip or an unconsumed rewrite miss
                        self.channel.preauthz = {}
                        self.channel.presub_filters = None
                    if self.channel.connected and isinstance(
                        pkt, (Publish, Subscribe)
                    ) and self.server.broker.hooks.has_slow("client.authorize"):
                        # a network-backed authz source (or exhook) is
                        # installed: pre-resolve the verdicts OFF-loop so
                        # a backend stall pushes back on this connection
                        # only, never the broker loop (same pattern as
                        # the authenticate fold above)
                        cid = self.channel.client_id
                        hooks = self.server.broker.hooks
                        if isinstance(pkt, Publish):
                            t = pkt.topic or self.channel.topic_aliases.get(
                                pkt.props.get("topic_alias")
                            )
                            if t:
                                self.channel.preauthz = (
                                    await asyncio.get_running_loop().run_in_executor(
                                        None,
                                        lambda: {
                                            ("publish", t): hooks.run_fold(
                                                "client.authorize",
                                                (cid, "publish", t),
                                                True,
                                            )
                                        },
                                    )
                                )
                        else:
                            # run the client.subscribe fold HERE (once,
                            # off-loop) so rewritten filters get their
                            # verdicts pre-resolved too; the channel
                            # consumes the folded list instead of re-
                            # running the chain (presub)
                            def _presub(pkt=pkt):
                                acc = hooks.run_fold(
                                    "client.subscribe", (cid,), pkt.filters
                                )
                                filters = (
                                    acc if acc is not None else pkt.filters
                                )
                                verdicts = {
                                    ("subscribe", f): hooks.run_fold(
                                        "client.authorize",
                                        (cid, "subscribe", f),
                                        True,
                                    )
                                    for f, _o in filters
                                }
                                return filters, verdicts
                            (
                                self.channel.presub_filters,
                                self.channel.preauthz,
                            ) = await asyncio.get_running_loop().run_in_executor(
                                None, _presub
                            )
                    try:
                        out = self.channel.handle_packet(pkt)
                    except ProtocolError as e:
                        if self.channel.proto_ver == MQTT_V5:
                            self._send_packets([Disconnect(e.code)])
                        raise
                    if out:
                        self._send_packets(out)
                    self._wire_sink()
                await self.drain()
        except (ProtocolError, ConnectionError):
            pass
        except Exception:
            log.exception("connection crashed")
        finally:
            sess = self.channel.session
            if sess is not None and getattr(sess, "outgoing_sink", None) is self._send_packets:
                sess.outgoing_sink = None
                sess.outgoing_sink_bytes = None
                sess.closer = None
            self.channel.on_close()
            self.transport.close()

    async def drain(self) -> None:
        try:
            await self.transport.drain()
        except ConnectionError:
            pass


class Server:
    """One TCP listener. Without a `broker` it builds one on the CUDA
    card (raising when none is present)."""

    def __init__(
        self,
        broker: Optional[Broker] = None,
        host: str = "127.0.0.1",
        port: int = 1883,
    ):
        self.broker = broker or Broker()
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()
        self.listen_addr = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._on_client, self.host, self.port
        )
        addr = self._server.sockets[0].getsockname()
        self.listen_addr = addr[:2]
        # live-listener registry (the reference's mgmt listeners view)
        if self not in self.broker.servers:
            self.broker.servers.append(self)
        log.info("listening on %s", addr)

    async def _on_client(self, reader, writer) -> None:
        conn = Connection(self, TcpTransport(reader, writer))
        self._conns.add(conn)
        try:
            await conn.run()
        finally:
            self._conns.discard(conn)

    async def stop(self) -> None:
        if self in self.broker.servers:
            self.broker.servers.remove(self)
        if self._server is not None:
            self._server.close()
            # kick live connections so wait_closed() cannot hang on them
            for conn in list(self._conns):
                try:
                    conn.transport.close()
                except Exception:
                    pass
            await self._server.wait_closed()

    async def serve_forever(self) -> None:
        await self.start()
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="emqx_tpu_torch MQTT broker")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=1883)
    ap.add_argument(
        "--device", default=None,
        help="torch device of the kernels: the CUDA card by default, "
        "'cpu' for the plain PyTorch versions",
    )
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)
    broker = Broker(device=args.device)
    broker.retainer.enable_device(telemetry=broker.router.telemetry)
    asyncio.run(Server(broker, host=args.host, port=args.port).serve_forever())


if __name__ == "__main__":
    main()
