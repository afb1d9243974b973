"""The MQTT protocol state machine, transport-agnostic (the port's
copy of emqx_tpu/broker/channel.py).

Parity with apps/emqx/src/emqx_channel.erl handle_in/2:361-531:
CONNECT (auth, session open/resume, will), PUBLISH QoS0/1/2 (QoS2
parks packet ids in awaiting_rel and publishes on first receipt,
emqx_channel.erl:705-746), SUBSCRIBE (authz + retained dispatch),
UNSUBSCRIBE, PING, DISCONNECT (normal discards the will). The server
feeds packets in; the channel returns packets to write out.

A SUBSCRIBE of two or more filters launches ONE batched retained read
(`_begin_retained_batch` -> Retainer.retained_read_begin, kernel K8 on
the card) before its authz/route loop; a single filter reads at B=1
through Broker._read_retained. With a publish sentinel attached
(`broker.sentinel`), 1/sample_n ack packets wall-time their inflight
bookkeeping into the `ack_sweep` delivery sub-stage. A listener's
`mountpoint` template resolves at CONNECT and applies to publish
topics, filters and the will; its zone's `mqtt` section (`mqtt_conf`)
sets the session windows and the keepalive policy.
"""

from __future__ import annotations

import time
from typing import List, Optional

from ..ops.topic import mount_filter, parse_share, validate_name
from .message import Message
from .packet import (
    MQTT_V5,
    Auth,
    Connack,
    Connect,
    Disconnect,
    Pingreq,
    Pingresp,
    Puback,
    Publish,
    RC,
    Suback,
    Subscribe,
    Type,
    Unsuback,
    Unsubscribe,
    Will,
)
from .caps import CapError
from .pubsub import Broker, EXCLUSIVE_PREFIX, ExclusiveTaken
from .session import Session, SessionConfig


class ProtocolError(Exception):
    def __init__(self, code: int, msg: str = ""):
        super().__init__(msg or hex(code))
        self.code = code


class Channel:
    def __init__(
        self,
        broker: Broker,
        peer: str = "?",
        mountpoint: str = "",
        max_packet_size: Optional[int] = None,
        mqtt_conf: Optional[dict] = None,
    ):
        self.broker = broker
        self.peer = peer
        self.client_id: Optional[str] = None
        self.username: Optional[str] = None
        self.proto_ver: int = 4
        self.session: Optional[Session] = None
        self.will: Optional[Will] = None
        self.keepalive: int = 0
        self.last_rx: float = time.time()
        self.connected = False
        self.clean_disconnect = False
        self.topic_aliases: dict = {}  # v5 inbound alias -> topic
        # per-listener mountpoint template; resolved at CONNECT
        # (emqx_mountpoint: applied to publish topics, filters, and the
        # will; stripped from deliveries in the outgoing path)
        self.mountpoint_tpl = mountpoint
        self.mountpoint = ""
        # the listener's inbound parser limit, advertised in CONNACK so
        # the client is never told a limit the parser will reject
        self.listener_max_packet = max_packet_size
        # the listener zone's checked `mqtt` section: session windows,
        # mqueue behavior, keepalive policy (emqx zone config)
        self.mqtt_conf = mqtt_conf or {}
        self.keepalive_multiplier = float(
            self.mqtt_conf.get("keepalive_multiplier", 1.5)
        )
        # client's advertised maximum packet size: outgoing PUBLISHes
        # exceeding it are dropped, not sent (MQTT-5 §3.1.2.11.4)
        self.client_max_packet: Optional[int] = None
        # (client_id, verdict) pre-computed by the connection layer's
        # off-loop authenticate run; consumed once by _handle_connect
        self.preauth = None
        # (client_id, verdict) of the pre-run 'client.connect' fold
        self.preconnect = None
        # (action, topic) -> verdict pre-computed off-loop by the
        # connection layer when a slow (network-backed) authorize chain
        # is installed; consumed by _handle_publish/_handle_subscribe
        self.preauthz: dict = {}
        # the client.subscribe fold result when the connection layer
        # already ran the chain off-loop (covers filter rewrites);
        # consumed once by _handle_subscribe so the chain runs ONCE
        self.presub_filters = None

    # --- inbound dispatch -------------------------------------------------

    def handle_packet(self, pkt) -> List[object]:
        self.last_rx = time.time()
        if not self.connected:
            if isinstance(pkt, Connect):
                return self._handle_connect(pkt)
            raise ProtocolError(RC.PROTOCOL_ERROR, "packet before CONNECT")
        if isinstance(pkt, Connect):
            raise ProtocolError(RC.PROTOCOL_ERROR, "duplicate CONNECT")
        if isinstance(pkt, Publish):
            return self._handle_publish(pkt)
        if isinstance(pkt, Puback):
            return self._handle_ack(pkt)
        if isinstance(pkt, Subscribe):
            return self._handle_subscribe(pkt)
        if isinstance(pkt, Unsubscribe):
            return self._handle_unsubscribe(pkt)
        if isinstance(pkt, Pingreq):
            return [Pingresp()]
        if isinstance(pkt, Disconnect):
            self.clean_disconnect = pkt.code == 0
            if (
                self.proto_ver == MQTT_V5
                and self.session is not None
                and "session_expiry_interval" in pkt.props
            ):
                self.session.cfg.session_expiry_interval = pkt.props[
                    "session_expiry_interval"
                ]
            return []
        if isinstance(pkt, Auth):
            raise ProtocolError(RC.BAD_AUTHENTICATION_METHOD, "AUTH unsupported")
        raise ProtocolError(RC.PROTOCOL_ERROR, f"unexpected {type(pkt).__name__}")

    # --- connect ----------------------------------------------------------

    def _handle_connect(self, pkt: Connect) -> List[object]:
        self.proto_ver = pkt.proto_ver
        client_id = pkt.client_id
        if not client_id:
            if not pkt.clean_start:
                return [
                    Connack(
                        False,
                        RC.CLIENT_IDENTIFIER_NOT_VALID
                        if self.proto_ver == MQTT_V5
                        else 2,
                    )
                ]
            client_id = f"auto-{id(self):x}-{int(time.time() * 1000) & 0xFFFFFF:x}"
        # 'client.connect' fold runs BEFORE authentication (the
        # reference's hook posture: license/quota gates and exhook
        # OnClientConnect see every CONNECT attempt). Acc True admits;
        # a reason-code accumulator rejects. The TCP server loop
        # pre-runs this fold (off-loop when a slow hook is registered)
        # and parks the verdict in `preconnect`; other transports run
        # it inline here.
        if self.preconnect is not None and self.preconnect[0] == pkt.client_id:
            ok = self.preconnect[1]
            self.preconnect = None
        elif self.broker.hooks.has("client.connect"):
            ok = self.broker.hooks.run_fold(
                "client.connect",
                (
                    dict(
                        client_id=client_id,
                        username=pkt.username,
                        proto_ver=self.proto_ver,
                        keepalive=pkt.keepalive,
                        clean_start=pkt.clean_start,
                        peer=self.peer,
                    ),
                ),
                True,
            )
        else:
            ok = True
        if ok is not True:
            code = (
                ok
                if isinstance(ok, int) and not isinstance(ok, bool)
                else (RC.UNSPECIFIED_ERROR if self.proto_ver == MQTT_V5 else 3)
            )
            if self.proto_ver != MQTT_V5 and code > 5:
                code = 3  # v3 range: map quota/other to server-unavailable
            return [Connack(False, code)]
        if self.preauth is not None and self.preauth[0] == pkt.client_id:
            # the connection layer ran the authenticate fold OFF-loop
            # (blocking providers like HTTP must not stall the broker)
            ok = self.preauth[1]
            self.preauth = None
        else:
            ok = self.broker.hooks.run_fold(
                "client.authenticate",
                (dict(client_id=client_id, username=pkt.username, password=pkt.password, peer=self.peer),),
                True,
            )
        if ok is not True:
            code = (
                ok
                if isinstance(ok, int) and not isinstance(ok, bool)
                else (RC.NOT_AUTHORIZED if self.proto_ver == MQTT_V5 else 5)
            )
            if self.proto_ver != MQTT_V5 and code > 5:
                code = 5  # v3 CONNACK codes are 0-5; map v5 reasons down
            self.broker.metrics.inc("client.auth.failure")
            return [Connack(False, code)]

        if len(client_id) > self.broker.caps.max_clientid_len:
            return [
                Connack(
                    False,
                    RC.CLIENT_IDENTIFIER_NOT_VALID
                    if self.proto_ver == MQTT_V5
                    else 2,
                )
            ]
        self.mountpoint = (
            self.mountpoint_tpl.replace("${clientid}", client_id).replace(
                "${username}", pkt.username or ""
            )
            if self.mountpoint_tpl
            else ""
        )
        mc = self.mqtt_conf

        def _secs(key, default_s):
            v = mc.get(key)
            return default_s if v is None else float(v) / 1000.0

        # schema encodes the default priority as "lowest"/"highest"
        dp = mc.get("mqueue_default_priority", 0)
        if dp == "lowest":
            dp = 0
        elif dp == "highest":
            dp = 255
        cfg = SessionConfig(
            max_mqueue_len=mc.get("max_mqueue_len", 1000),
            receive_maximum=mc.get("max_inflight", 32),
            max_awaiting_rel=mc.get("max_awaiting_rel", 100),
            await_rel_timeout=_secs("await_rel_timeout", 300.0),
            retry_interval=_secs("retry_interval", 30.0),
            upgrade_qos=mc.get("upgrade_qos", False),
            mqueue_priorities={
                k: int(v) for k, v in (mc.get("mqueue_priorities") or {}).items()
            },
            mqueue_default_priority=int(dp),
            mqueue_store_qos0=mc.get("mqueue_store_qos0", True),
        )
        # the zone's session_expiry_interval caps what clients may ask
        zone_expiry = _secs("session_expiry_interval", float("inf"))
        expiry_adjusted = False
        if self.proto_ver == MQTT_V5:
            asked = pkt.props.get("session_expiry_interval", 0)
            cfg.session_expiry_interval = min(float(asked), zone_expiry)
            expiry_adjusted = cfg.session_expiry_interval != float(asked)
            # the zone inflight cap bounds the client's receive_maximum
            # ask — a 65535 request must not defeat the operator limit
            cfg.receive_maximum = min(
                pkt.props.get("receive_maximum", cfg.receive_maximum),
                cfg.receive_maximum,
            )
            self.client_max_packet = pkt.props.get("maximum_packet_size")
        else:
            # v3: clean_start=False persists up to the zone cap
            cfg.session_expiry_interval = 0 if pkt.clean_start else zone_expiry
        session, present = self.broker.open_session(
            client_id, pkt.clean_start, cfg
        )
        session.mountpoint = self.mountpoint  # hooks (auto-subscribe) read it
        self.session = session
        self.client_id = client_id
        self.username = pkt.username
        self.keepalive = pkt.keepalive
        # v5 server keepalive OVERRIDES the client's ask (advertised in
        # CONNACK, emqx zone mqtt.server_keepalive)
        server_ka = mc.get("server_keepalive")
        if server_ka is not None and self.proto_ver == MQTT_V5:
            self.keepalive = int(server_ka)
        self.will = pkt.will
        self.connected = True
        self.broker.metrics.inc("client.connected")
        self.broker.hooks.run(
            "client.connected", client_id, self.proto_ver, self.peer
        )
        props = (
            self.broker.caps.connack_props(
                cfg.max_awaiting_rel, self.listener_max_packet
            )
            if self.proto_ver == MQTT_V5
            else {}
        )
        if server_ka is not None and self.proto_ver == MQTT_V5:
            props["server_keep_alive"] = int(server_ka)
        if expiry_adjusted:
            # MQTT-5 §3.2.2.3.2: a server using a DIFFERENT expiry than
            # the client asked must say so in CONNACK
            props["session_expiry_interval"] = int(cfg.session_expiry_interval)
        out: List[object] = [Connack(present, 0, props=props)]
        if present:
            out.extend(session.on_reconnect())
        return out

    # --- publish (inbound) -------------------------------------------------

    def _resolve_alias(self, pkt: Publish) -> str:
        if self.proto_ver != MQTT_V5:
            return pkt.topic
        alias = pkt.props.get("topic_alias")
        if alias is None:
            return pkt.topic
        if pkt.topic:
            self.topic_aliases[alias] = pkt.topic
            return pkt.topic
        topic = self.topic_aliases.get(alias)
        if topic is None:
            raise ProtocolError(RC.TOPIC_ALIAS_INVALID, "unknown topic alias")
        return topic

    def _handle_publish(self, pkt: Publish) -> List[object]:
        topic = self._resolve_alias(pkt)
        try:
            validate_name(topic)
        except ValueError:
            raise ProtocolError(RC.TOPIC_NAME_INVALID, topic)
        try:
            self.broker.caps.check_pub(pkt.qos, pkt.retain)
        except CapError as e:
            raise ProtocolError(e.code, topic)
        # authorize on the UNMOUNTED topic — ACLs must see the same
        # namespace on publish and subscribe (mount happens after, like
        # the reference's packet_to_message)
        allowed = self.preauthz.get(("publish", topic))
        if allowed is None:
            allowed = self.broker.hooks.run_fold(
                "client.authorize",
                (self.client_id, "publish", topic),
                True,
            )
        if self.mountpoint:
            topic = self.mountpoint + topic
        if allowed is not True:
            self.broker.metrics.inc("packets.publish.auth_error")
            if pkt.qos == 1:
                return [Puback(Type.PUBACK, pkt.packet_id, RC.NOT_AUTHORIZED)]
            if pkt.qos == 2:
                return [Puback(Type.PUBREC, pkt.packet_id, RC.NOT_AUTHORIZED)]
            return []
        msg = Message(
            topic=topic,
            payload=pkt.payload,
            qos=pkt.qos,
            retain=pkt.retain,
            from_client=self.client_id or "",
            props={
                k: v
                for k, v in pkt.props.items()
                if k in ("message_expiry_interval", "content_type",
                         "response_topic", "correlation_data",
                         "payload_format_indicator", "user_property")
            },
            # publisher identity rides broker-internal headers (the
            # reference's #message.headers), never the wire props
            headers={"username": self.username or "", "peerhost": self.peer},
        )
        if pkt.qos == 0:
            self.broker.publish(msg)
            return []
        if pkt.qos == 1:
            n = self.broker.publish(msg)
            code = 0 if n else RC.NO_MATCHING_SUBSCRIBERS
            return [Puback(Type.PUBACK, pkt.packet_id, code if self.proto_ver == MQTT_V5 else 0)]
        # QoS2: publish on first receipt, park until PUBREL
        assert self.session is not None
        try:
            fresh = self.session.await_rel(pkt.packet_id)
        except OverflowError:
            raise ProtocolError(RC.RECEIVE_MAXIMUM_EXCEEDED, "too many inflight QoS2")
        code = 0
        if fresh:
            n = self.broker.publish(msg)
            if not n and self.proto_ver == MQTT_V5:
                code = RC.NO_MATCHING_SUBSCRIBERS
        elif self.proto_ver == MQTT_V5:
            code = RC.PACKET_IDENTIFIER_IN_USE
        return [Puback(Type.PUBREC, pkt.packet_id, code)]

    # --- acks (outbound flow control) --------------------------------------

    def _handle_ack(self, pkt: Puback) -> List[object]:
        # sampled ack-sweep attribution (obs/sentinel): 1/sample_n ack
        # packets wall-time the inflight bookkeeping + drain below into
        # the `ack_sweep` delivery sub-stage — QoS1/2 ack traffic shows
        # up in the decomposition instead of hiding in socket reads
        st = getattr(self.broker, "sentinel", None)
        clock = st.maybe_ack_clock() if st is not None else None
        if clock is None:
            return self._handle_ack_inner(pkt)
        t0 = clock()
        try:
            return self._handle_ack_inner(pkt)
        finally:
            st.observe_delivery("ack_sweep", clock() - t0)

    def _handle_ack_inner(self, pkt: Puback) -> List[object]:
        assert self.session is not None
        s = self.session
        out: List[object] = []
        if pkt.type == Type.PUBACK:
            if s.on_puback(pkt.packet_id):
                self.broker.hooks.run("message.acked", self.client_id, pkt.packet_id)
            out.extend(s.drain())
        elif pkt.type == Type.PUBREC:
            if s.on_pubrec(pkt.packet_id):
                out.append(Puback(Type.PUBREL, pkt.packet_id))
            else:
                out.append(
                    Puback(
                        Type.PUBREL,
                        pkt.packet_id,
                        RC.PACKET_IDENTIFIER_NOT_FOUND
                        if self.proto_ver == MQTT_V5
                        else 0,
                    )
                )
        elif pkt.type == Type.PUBREL:
            found = s.release_rel(pkt.packet_id)
            out.append(
                Puback(
                    Type.PUBCOMP,
                    pkt.packet_id,
                    0
                    if found or self.proto_ver != MQTT_V5
                    else RC.PACKET_IDENTIFIER_NOT_FOUND,
                )
            )
        elif pkt.type == Type.PUBCOMP:
            if s.on_pubcomp(pkt.packet_id):
                self.broker.hooks.run("message.acked", self.client_id, pkt.packet_id)
            out.extend(s.drain())
        return out

    # --- subscribe / unsubscribe -------------------------------------------

    def _handle_subscribe(self, pkt: Subscribe) -> List[object]:
        assert self.session is not None
        codes: List[int] = []
        out: List[object] = []
        if self.presub_filters is not None:
            filters = self.presub_filters
            self.presub_filters = None
        else:
            acc = self.broker.hooks.run_fold(
                "client.subscribe", (self.client_id,), pkt.filters
            )
            filters = acc if acc is not None else pkt.filters
        reader = self._begin_retained_batch(filters)
        for flt, opts in filters:
            # get, not pop: one SUBSCRIBE may list the same filter twice
            # and both occurrences must hit the pre-resolved verdict.
            # A miss (client.subscribe hook rewrote the filter) falls
            # back to the inline fold
            allowed = self.preauthz.get(("subscribe", flt))
            if allowed is None:
                allowed = self.broker.hooks.run_fold(
                    "client.authorize", (self.client_id, "subscribe", flt), True
                )
            if allowed is not True:
                codes.append(RC.NOT_AUTHORIZED if self.proto_ver == MQTT_V5 else 0x80)
                continue
            exclusive = flt.startswith(EXCLUSIVE_PREFIX)
            try:
                self.broker.caps.check_sub(
                    flt[len(EXCLUSIVE_PREFIX):] if exclusive else flt
                )
            except CapError as e:
                codes.append(e.code if self.proto_ver == MQTT_V5 else 0x80)
                continue
            try:
                retained = self.broker.subscribe(
                    self.session, self._mount_filter(flt), opts,
                    retained_reader=reader,
                )
            except ExclusiveTaken:
                codes.append(
                    RC.QUOTA_EXCEEDED if self.proto_ver == MQTT_V5 else 0x80
                )
                continue
            except ValueError:
                codes.append(
                    RC.TOPIC_FILTER_INVALID if self.proto_ver == MQTT_V5 else 0x80
                )
                continue
            codes.append(opts.qos)
            for m in retained:
                rm = Message(**{**m.__dict__})
                rm.retain = True
                ropts = type(opts)(
                    qos=opts.qos,
                    no_local=opts.no_local,
                    retain_as_published=True,  # retained reads keep the flag
                    retain_handling=opts.retain_handling,
                )
                out.extend(self.session.deliver(rm, ropts))
        return [Suback(pkt.packet_id, codes)] + out

    def _begin_retained_batch(self, filters):
        """Launch ONE batched retained lookup for the whole SUBSCRIBE
        packet (broker.retained_read_begin) before the subscribe loop
        runs authz/route work — the device probe and its D2H copy ride
        under that host work. Returns a reader(real) -> messages for
        Broker.subscribe, or None when the device leg is off or a
        single-filter packet makes batching pointless. Over-fetch
        (e.g. a filter later rejected by caps) is harmless: retained
        reads are side-effect-free."""
        retainer = self.broker.retainer
        if not getattr(retainer, "device_enabled", False) or len(filters) < 2:
            return None
        reals = []
        for flt, opts in filters:
            if opts.retain_handling == 2:
                continue
            f = flt[len(EXCLUSIVE_PREFIX):] if flt.startswith(
                EXCLUSIVE_PREFIX
            ) else flt
            try:
                group, real = parse_share(self._mount_filter(f))
            except Exception:
                continue
            if group is None:  # no retained delivery for shared subs
                reals.append(real)
        if not reals:
            return None
        begun = retainer.retained_read_begin(reals)
        cache: dict = {}

        def reader(real):
            if not cache:
                for r, msgs in zip(
                    reals, retainer.retained_read_finish(begun)
                ):
                    cache.setdefault(r, msgs)
                cache.setdefault("", [])  # finished marker
            hit = cache.get(real)
            # a hook-rewritten or duplicate filter outside the batch
            # takes the single-read path
            return hit if hit is not None else retainer.read(real)

        return reader

    def _handle_unsubscribe(self, pkt: Unsubscribe) -> List[object]:
        assert self.session is not None
        # fold first (topic-rewrite etc. must transform filters the
        # same way the subscribe fold did, emqx_channel process_unsubscribe)
        acc = self.broker.hooks.run_fold(
            "client.unsubscribe", (self.client_id,), pkt.filters
        )
        filters = acc if acc is not None else pkt.filters
        codes = []
        for flt in filters:
            ok = self.broker.unsubscribe(self.session, self._mount_filter(flt))
            codes.append(0 if ok else RC.NO_SUBSCRIPTION_EXISTED)
        return [Unsuback(pkt.packet_id, codes)]

    def _mount_filter(self, flt: str) -> str:
        return mount_filter(self.mountpoint, flt)

    # --- lifecycle -----------------------------------------------------------

    def keepalive_expired(self, now: Optional[float] = None) -> bool:
        if not self.keepalive:
            return False
        now = now if now is not None else time.time()
        return now - self.last_rx > self.keepalive * self.keepalive_multiplier

    def on_close(self) -> None:
        """Socket gone: publish the will unless cleanly disconnected,
        keep or drop the session per expiry (emqx_channel terminate)."""
        if not self.connected:
            return
        self.connected = False
        self.broker.metrics.inc("client.disconnected")
        if self.will is not None and not self.clean_disconnect:
            self.broker.publish(
                Message(
                    topic=self.mountpoint + self.will.topic,
                    payload=self.will.payload,
                    qos=self.will.qos,
                    retain=self.will.retain,
                    from_client=self.client_id or "",
                )
            )
        self.will = None
        if self.session is not None:
            if self.session.cfg.session_expiry_interval > 0:
                self.session.on_disconnect()
            else:
                self.broker.close_session(self.session)
        self.broker.hooks.run(
            "client.disconnected", self.client_id, "normal" if self.clean_disconnect else "closed"
        )
