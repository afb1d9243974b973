"""MQTT capability negotiation: broker-side limits advertised in the
v5 CONNACK and enforced on PUBLISH/SUBSCRIBE.

Parity with apps/emqx/src/emqx_mqtt_caps.erl: check_pub (retain
available, max QoS, topic levels, :75-101) and check_sub (levels,
wildcard/shared availability, exclusive claim, :103-146), plus the
CONNACK property advertisement the channel emits.

The port's own copy of emqx_tpu/broker/caps.py.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ops import topic as topic_mod
from .packet import RC


class CapError(Exception):
    def __init__(self, code: int):
        super().__init__(hex(code))
        self.code = code


@dataclass
class MqttCaps:
    # defaults mirror emqx_mqtt_caps ?DEFAULT_CAPS / emqx_schema zone mqtt
    max_packet_size: int = 1024 * 1024
    max_clientid_len: int = 65535
    max_topic_levels: int = 128
    max_qos_allowed: int = 2
    max_topic_alias: int = 65535
    retain_available: bool = True
    wildcard_subscription: bool = True
    subscription_identifiers: bool = True
    shared_subscription: bool = True
    exclusive_subscription: bool = False  # reference default: disabled

    def connack_props(
        self, receive_maximum: int, max_packet_size: "int | None" = None
    ) -> dict:
        props = {
            "receive_maximum": receive_maximum,
            "maximum_packet_size": (
                min(self.max_packet_size, max_packet_size)
                if max_packet_size
                else self.max_packet_size
            ),
            "topic_alias_maximum": self.max_topic_alias,
            "retain_available": 1 if self.retain_available else 0,
            "wildcard_subscription_available": (
                1 if self.wildcard_subscription else 0
            ),
            "shared_subscription_available": 1 if self.shared_subscription else 0,
            "subscription_identifier_available": (
                1 if self.subscription_identifiers else 0
            ),
        }
        # Maximum QoS property is only legal as 0 or 1; absence means
        # QoS 2 supported (MQTT-5 §3.2.2.3.4)
        if self.max_qos_allowed < 2:
            props["maximum_qos"] = self.max_qos_allowed
        return props

    def check_pub(self, qos: int, retain: bool) -> None:
        if qos > self.max_qos_allowed:
            raise CapError(RC.QOS_NOT_SUPPORTED)
        if retain and not self.retain_available:
            raise CapError(RC.RETAIN_NOT_SUPPORTED)

    def check_sub(self, flt: str) -> None:
        """flt is the real filter (share/exclusive prefixes handled by
        the caller; this checks shape limits)."""
        group, real = topic_mod.parse_share(flt)
        if group is not None and not self.shared_subscription:
            raise CapError(RC.SHARED_SUBSCRIPTIONS_NOT_SUPPORTED)
        if len(topic_mod.words(real)) > self.max_topic_levels:
            raise CapError(RC.TOPIC_FILTER_INVALID)
        if topic_mod.is_wildcard(real) and not self.wildcard_subscription:
            raise CapError(RC.WILDCARD_SUBSCRIPTIONS_NOT_SUPPORTED)
