"""Listener lifecycle: start/stop/update the set of configured
listeners (tcp/ssl/ws/wss); the port's copy of
emqx_tpu/broker/listeners.py.

The reference starts each configured listener through one dispatcher --
esockd for tcp/ssl, cowboy for ws/wss -- keyed `{Type, Name}` with
per-listener bind/limits, and supports runtime add/remove/update with
restart-on-bind-change (apps/emqx/src/emqx_listeners.erl:444-455,657).
This manager does the same over broker.server.Server, which folds all
four types into (ssl_context, websocket) flags. TLS uses the standard
library's `ssl` only. A QUIC listener, a listener's CRL check and its
OCSP cache need ROADMAP Queue 1 item 9 and raise `NotPortedError`.

Config shape (config/default_schema.py `listeners` root):
    listeners:
      tcp:  {default: {bind: "0.0.0.0:1883", enabled: true, ...}}
      ssl:  {default: {bind: "0.0.0.0:8883", certfile: ..., keyfile: ...}}
      ws:   {default: {bind: "0.0.0.0:8083", path: "/mqtt"}}
      wss:  {default: {bind: "0.0.0.0:8084", certfile: ..., keyfile: ...}}
"""

from __future__ import annotations

import logging
import ssl as ssl_mod
from typing import Dict, Optional, Tuple

from ..config.unported import NotPortedError
from .limiter import ListenerLimits
from .pubsub import Broker
from .server import Server

log = logging.getLogger("emqx_tpu_torch.listeners")

LISTENER_TYPES = ("tcp", "ssl", "ws", "wss")


def parse_bind(bind) -> Tuple[str, int]:
    """'1883' | ':1883' | 'host:1883' -> (host, port)."""
    if isinstance(bind, int):
        return "0.0.0.0", bind
    s = str(bind)
    if ":" in s:
        host, port = s.rsplit(":", 1)
        return host or "0.0.0.0", int(port)
    return "0.0.0.0", int(s)


def make_ssl_context(conf: Dict) -> ssl_mod.SSLContext:
    # accepts both the schema's ssl_-prefixed keys (listener_struct,
    # config/default_schema.py) and bare certfile/keyfile
    certfile = conf.get("certfile") or conf.get("ssl_certfile")
    keyfile = conf.get("keyfile") or conf.get("ssl_keyfile")
    ctx = ssl_mod.SSLContext(ssl_mod.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certfile, keyfile)
    cacert = conf.get("cacertfile") or conf.get("ssl_cacertfile")
    if cacert:
        ctx.load_verify_locations(cacert)
    if conf.get("verify", conf.get("ssl_verify")) == "verify_peer":
        ctx.verify_mode = ssl_mod.CERT_REQUIRED
    else:
        ctx.verify_mode = ssl_mod.CERT_NONE
    if conf.get("ssl_crl_check") or conf.get("enable_crl_check"):
        raise NotPortedError("listeners.*.ssl_crl_check", 9, "the CRL cache")
    return ctx


MQTT_ZONE_KEYS = (
    "max_mqueue_len", "max_inflight", "max_awaiting_rel",
    "await_rel_timeout", "retry_interval", "upgrade_qos",
    "mqueue_priorities", "mqueue_default_priority", "mqueue_store_qos0",
    "server_keepalive", "keepalive_multiplier", "session_expiry_interval",
)


def zone_mqtt_conf(config, zone: str) -> Dict:
    """Resolve the zone-overlaid `mqtt` section into a flat dict the
    Channel consumes (emqx_config:get_zone_conf analog)."""
    if config is None:
        return {}
    out = {}
    for key in MQTT_ZONE_KEYS:
        try:
            v = config.get_zone(zone, key, None)
        except Exception:
            v = None
        if v is not None:
            out[key] = v
    return out


class Listeners:
    """Named-listener registry over a shared Broker."""

    def __init__(self, broker: Broker, config=None):
        self.broker = broker
        self.config = config  # typed Config for zone-aware session conf
        self._live: Dict[Tuple[str, str], Server] = {}
        self._conf: Dict[Tuple[str, str], Dict] = {}

    def _build(self, ltype: str, name: str, conf: Dict) -> Server:
        if ltype == "quic":
            raise NotPortedError("listeners.quic", 9, "the QUIC listener")
        if ltype not in LISTENER_TYPES:
            raise ValueError(f"unknown listener type {ltype!r}")
        if conf.get("ssl_ocsp_enable"):
            raise NotPortedError(
                "listeners.*.ssl_ocsp_enable", 9, "the OCSP cache"
            )
        host, port = parse_bind(conf.get("bind", 0))
        limits = ListenerLimits(
            max_conn_rate=conf.get("max_conn_rate"),
            messages_rate=conf.get("messages_rate"),
            bytes_rate=conf.get("bytes_rate"),
        )
        ctx = make_ssl_context(conf) if ltype in ("ssl", "wss") else None
        return Server(
            self.broker,
            host=host,
            port=port,
            limits=limits,
            ssl_context=ctx,
            websocket=ltype in ("ws", "wss"),
            ws_path=conf.get("path", "/mqtt"),
            name=f"{ltype}:{name}",
            mountpoint=conf.get("mountpoint", ""),
            mqtt_conf=zone_mqtt_conf(self.config, conf.get("zone", "default")),
            **(
                {"max_packet_size": conf["max_packet_size"]}
                if conf.get("max_packet_size")
                else {}
            ),
        )

    async def start(self, ltype: str, name: str, conf: Dict) -> Server:
        key = (ltype, name)
        if key in self._live:
            raise ValueError(f"listener {ltype}:{name} already running")
        srv = self._build(ltype, name, conf)
        await srv.start()
        self._live[key] = srv
        self._conf[key] = dict(conf)
        return srv

    async def stop(self, ltype: str, name: str) -> bool:
        srv = self._live.pop((ltype, name), None)
        if srv is None:
            return False
        # the CONFIG survives a stop: a later start() without an
        # explicit config restores the listener as it was, instead of
        # rebinding on schema defaults
        await srv.stop()
        return True

    def conf_of(self, ltype: str, name: str) -> Optional[Dict]:
        c = self._conf.get((ltype, name))
        return dict(c) if c is not None else None

    async def update(self, ltype: str, name: str, conf: Dict) -> Server:
        """Restart-on-update (the reference restarts when bind or
        transport options change; we keep the simple uniform rule).
        The new config is validated by construction BEFORE the old
        listener stops, and a failed start rolls back to the previous
        config — a rejected change must not turn into an outage."""
        self._build(ltype, name, conf)  # validate (bind parse, certs)
        old_conf = self._conf.get((ltype, name))
        was_running = (ltype, name) in self._live
        await self.stop(ltype, name)
        try:
            return await self.start(ltype, name, conf)
        except Exception:
            # roll back only what was RUNNING — a failed update must
            # never resurrect a deliberately-stopped listener
            if was_running and old_conf is not None:
                try:
                    await self.start(ltype, name, old_conf)
                except Exception:
                    log.exception(
                        "rollback of listener %s:%s failed", ltype, name
                    )
            raise

    async def stop_all(self) -> None:
        for ltype, name in list(self._live):
            await self.stop(ltype, name)

    def get(self, ltype: str, name: str) -> Optional[Server]:
        return self._live.get((ltype, name))

    def info(self) -> list:
        out = []
        for (ltype, name), srv in sorted(self._live.items()):
            out.append(
                {
                    "id": f"{ltype}:{name}",
                    "type": ltype,
                    "bind": (
                        f"{srv.listen_addr[0]}:{srv.listen_addr[1]}"
                        if srv.listen_addr
                        else None
                    ),
                    "running": srv._server is not None,
                    "current_connections": len(srv._conns),
                }
            )
        return out
