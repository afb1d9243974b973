"""MQTT control-packet model (3.1 / 3.1.1 / 5.0).

The typed mirror of the reference's packet records
(apps/emqx/include/emqx_mqtt.hrl, apps/emqx/src/emqx_packet.erl):
plain dataclasses the codec (broker/frame.py) parses into and
serializes from.

The port's own copy of emqx_tpu/broker/packet.py.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class Type(enum.IntEnum):
    CONNECT = 1
    CONNACK = 2
    PUBLISH = 3
    PUBACK = 4
    PUBREC = 5
    PUBREL = 6
    PUBCOMP = 7
    SUBSCRIBE = 8
    SUBACK = 9
    UNSUBSCRIBE = 10
    UNSUBACK = 11
    PINGREQ = 12
    PINGRESP = 13
    DISCONNECT = 14
    AUTH = 15


# protocol levels
MQTT_V3 = 3  # 3.1    (MQIsdp)
MQTT_V4 = 4  # 3.1.1  (MQTT)
MQTT_V5 = 5  # 5.0


class RC(enum.IntEnum):
    """MQTT 5.0 reason codes (subset used by the broker; v3 SUBACK
    failure is 0x80). Mirrors apps/emqx/src/emqx_reason_codes.erl."""

    SUCCESS = 0x00
    GRANTED_QOS_1 = 0x01
    GRANTED_QOS_2 = 0x02
    DISCONNECT_WITH_WILL = 0x04
    NO_MATCHING_SUBSCRIBERS = 0x10
    NO_SUBSCRIPTION_EXISTED = 0x11
    CONTINUE_AUTHENTICATION = 0x18
    REAUTHENTICATE = 0x19
    UNSPECIFIED_ERROR = 0x80
    MALFORMED_PACKET = 0x81
    PROTOCOL_ERROR = 0x82
    IMPLEMENTATION_SPECIFIC = 0x83
    UNSUPPORTED_PROTOCOL_VERSION = 0x84
    CLIENT_IDENTIFIER_NOT_VALID = 0x85
    BAD_USERNAME_OR_PASSWORD = 0x86
    NOT_AUTHORIZED = 0x87
    SERVER_UNAVAILABLE = 0x88
    SERVER_BUSY = 0x89
    BANNED = 0x8A
    BAD_AUTHENTICATION_METHOD = 0x8C
    KEEPALIVE_TIMEOUT = 0x8D
    SESSION_TAKEN_OVER = 0x8E
    TOPIC_FILTER_INVALID = 0x8F
    TOPIC_NAME_INVALID = 0x90
    PACKET_IDENTIFIER_IN_USE = 0x91
    PACKET_IDENTIFIER_NOT_FOUND = 0x92
    RECEIVE_MAXIMUM_EXCEEDED = 0x93
    TOPIC_ALIAS_INVALID = 0x94
    PACKET_TOO_LARGE = 0x95
    MESSAGE_RATE_TOO_HIGH = 0x96
    QUOTA_EXCEEDED = 0x97
    ADMINISTRATIVE_ACTION = 0x98
    PAYLOAD_FORMAT_INVALID = 0x99
    RETAIN_NOT_SUPPORTED = 0x9A
    QOS_NOT_SUPPORTED = 0x9B
    USE_ANOTHER_SERVER = 0x9C
    SERVER_MOVED = 0x9D
    SHARED_SUBSCRIPTIONS_NOT_SUPPORTED = 0x9E
    CONNECTION_RATE_EXCEEDED = 0x9F
    MAXIMUM_CONNECT_TIME = 0xA0
    SUBSCRIPTION_IDENTIFIERS_NOT_SUPPORTED = 0xA1
    WILDCARD_SUBSCRIPTIONS_NOT_SUPPORTED = 0xA2


Properties = Dict[str, object]  # name -> value ('user_property': list of pairs)


@dataclass
class Will:
    topic: str
    payload: bytes
    qos: int = 0
    retain: bool = False
    props: Properties = field(default_factory=dict)


@dataclass
class Connect:
    proto_name: str = "MQTT"
    proto_ver: int = MQTT_V4
    clean_start: bool = True
    keepalive: int = 60
    client_id: str = ""
    will: Optional[Will] = None
    username: Optional[str] = None
    password: Optional[bytes] = None
    props: Properties = field(default_factory=dict)


@dataclass
class Connack:
    session_present: bool = False
    code: int = 0  # v3 return code or v5 reason code
    props: Properties = field(default_factory=dict)


@dataclass
class Publish:
    topic: str
    payload: bytes = b""
    qos: int = 0
    retain: bool = False
    dup: bool = False
    packet_id: Optional[int] = None  # required for qos > 0
    props: Properties = field(default_factory=dict)


@dataclass
class Puback:  # also PUBREC/PUBREL/PUBCOMP via `type`
    type: Type
    packet_id: int
    code: int = 0
    props: Properties = field(default_factory=dict)


@dataclass
class SubOpts:
    qos: int = 0
    no_local: bool = False
    retain_as_published: bool = False
    retain_handling: int = 0


@dataclass
class Subscribe:
    packet_id: int
    filters: List[Tuple[str, SubOpts]] = field(default_factory=list)
    props: Properties = field(default_factory=dict)


@dataclass
class Suback:
    packet_id: int
    codes: List[int] = field(default_factory=list)
    props: Properties = field(default_factory=dict)


@dataclass
class Unsubscribe:
    packet_id: int
    filters: List[str] = field(default_factory=list)
    props: Properties = field(default_factory=dict)


@dataclass
class Unsuback:
    packet_id: int
    codes: List[int] = field(default_factory=list)  # v5 only on wire
    props: Properties = field(default_factory=dict)


@dataclass
class Pingreq:
    pass


@dataclass
class Pingresp:
    pass


@dataclass
class Disconnect:
    code: int = 0
    props: Properties = field(default_factory=dict)


@dataclass
class Auth:
    code: int = 0
    props: Properties = field(default_factory=dict)


Packet = object  # union of the above
