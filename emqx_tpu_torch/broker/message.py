"""The broker-internal message record (emqx_message.erl analog:
apps/emqx/src/emqx_message.erl #message{} ctor/flags/headers).

The port's own copy of emqx_tpu/broker/message.py.
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class Message:
    topic: str
    payload: bytes = b""
    qos: int = 0
    retain: bool = False
    from_client: str = ""
    id: str = field(default_factory=lambda: uuid.uuid4().hex)
    timestamp: float = field(default_factory=time.time)
    props: Dict[str, object] = field(default_factory=dict)
    headers: Dict[str, object] = field(default_factory=dict)

    def expired(self, now: Optional[float] = None) -> bool:
        exp = self.props.get("message_expiry_interval")
        if exp is None:
            return False
        return (now if now is not None else time.time()) > self.timestamp + exp
