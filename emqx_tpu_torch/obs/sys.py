"""$SYS heartbeat topics (apps/emqx/src/emqx_sys.erl:1-421; the port's
own copy of emqx_tpu/obs/sys.py).

The reference runs two timers: a heartbeat (uptime + datetime) and an
interval tick publishing version/brokers/stats/metrics under
`$SYS/brokers/<node>/...`. Here the publisher is tickable — tests call
`tick()` directly; `start()` drives it from asyncio.

$SYS messages are retained-ish in the reference (flag sys=true); we
publish them as plain QoS0 retained=False messages from the node, and
subscribers use normal `$SYS/#` filters (which the topic algebra
already keeps out of root `+`/`#` matches).
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Optional

from ..broker.message import Message

VERSION = "0.2.0"


class SysHeartbeat:
    def __init__(self, broker, node_name: str = "emqx@127.0.0.1"):
        self.broker = broker
        self.node_name = node_name
        self.started_at = time.time()
        self._task: Optional[asyncio.Task] = None
        self.heartbeat_interval = 30.0

    # --- publishing -----------------------------------------------------

    def _pub(self, suffix: str, payload) -> None:
        if isinstance(payload, (dict, list)):
            body = json.dumps(payload).encode()
        elif isinstance(payload, bytes):
            body = payload
        else:
            body = str(payload).encode()
        topic = f"$SYS/brokers/{self.node_name}/{suffix}"
        self.broker.publish(Message(topic=topic, payload=body, qos=0))

    def uptime(self) -> float:
        return time.time() - self.started_at

    def heartbeat(self) -> None:
        """The fast timer (emqx_sys.erl heartbeat: uptime + datetime)."""
        self._pub("uptime", int(self.uptime() * 1000))
        self._pub(
            "datetime", time.strftime("%Y-%m-%d %H:%M:%S", time.localtime())
        )

    def tick(self) -> None:
        """The slow timer (emqx_sys.erl sys_interval: version, brokers,
        stats/*, metrics/*)."""
        b = self.broker
        self._pub("version", VERSION)
        self.broker.publish(
            Message(topic="$SYS/brokers", payload=self.node_name.encode())
        )
        self._pub("sysdescr", "emqx_tpu_torch broker")
        for name, val in b.stats.all().items():
            self._pub(f"stats/{name}", val)
        for name, val in b.metrics.all().items():
            self._pub(f"metrics/{name}", val)
        self.heartbeat()

    # --- asyncio driver -------------------------------------------------

    def start(self, interval: float = 30.0) -> None:
        self.heartbeat_interval = interval
        self._task = asyncio.get_event_loop().create_task(self._run())

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.heartbeat_interval)
            self.tick()

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
