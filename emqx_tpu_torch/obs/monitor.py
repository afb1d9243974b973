"""Dashboard monitor — time-series samples of broker load (the port's
own copy of emqx_tpu/obs/monitor.py).

Reference: apps/emqx_dashboard/src/emqx_dashboard_monitor.erl —
periodic sampling of connection/subscription/message counters into a
bounded table, served to the dashboard as both instantaneous gauges
(`/monitor_current`) and a window of rate samples (`/monitor`).
Rates derive from counter deltas between consecutive samples."""

from __future__ import annotations

import asyncio
import time
from collections import deque
from typing import Deque, Dict, List, Optional

DEFAULT_INTERVAL = 10.0
RETENTION = 1000  # samples kept (~2.7h at 10s)

# counter -> rate field name (deltas / interval)
_RATES = {
    "messages.received": "received_msg_rate",
    "messages.sent": "sent_msg_rate",
    "messages.dropped": "dropped_msg_rate",
}


class Monitor:
    def __init__(self, broker, interval: float = DEFAULT_INTERVAL):
        self.broker = broker
        self.interval = interval
        self.samples: Deque[Dict] = deque(maxlen=RETENTION)
        self._task: Optional[asyncio.Task] = None
        self._last_counters: Dict[str, int] = {}
        self._last_ts: Optional[float] = None

    # --- sampling ---------------------------------------------------------

    def current(self) -> Dict:
        """Instantaneous gauges (monitor_current)."""
        stats = self.broker.stats.all()
        m = self.broker.metrics
        out = {
            "connections": stats.get("connections.count", 0),
            "sessions": stats.get("sessions.count", 0),
            "subscriptions": stats.get("subscriptions.count", 0),
            "topics": self.broker.router.topic_count(),
            "retained": stats.get("retained.count", 0),
            "received_msg": m.val("messages.received"),
            "sent_msg": m.val("messages.sent"),
            "dropped_msg": m.val("messages.dropped"),
            # device hot-path gauges ride the same sampling loop, so
            # the dashboard time-series carries dispatch p99 and HBM
            # occupancy alongside connection/message rates
            "xla_dispatch_p99_ms": 0.0,
            "xla_hbm_bytes": 0,
            "xla_recompiles": 0,
        }
        tel = getattr(self.broker.router, "telemetry", None)
        if tel is not None and tel.enabled:
            out["xla_dispatch_p99_ms"] = round(
                tel.dispatch_percentile(99) * 1e3, 4
            )
            out["xla_hbm_bytes"] = int(tel.gauges.get("device_table_bytes", 0))
            out["xla_recompiles"] = tel.counters.get("recompiles_total", 0)
        # sentinel series: per-stage publish p99s, audit divergences,
        # SLO burn rates — the dashboard view of the served-path
        # watchdog (obs/sentinel.py)
        st = getattr(self.broker, "sentinel", None)
        if st is not None:
            out.update(st.monitor_sample())
        return out

    def sample(self) -> Dict:
        """Take one sample; rates are deltas since the previous one."""
        now = time.time()
        cur = self.current()
        out = dict(cur)
        out["time_stamp"] = int(now * 1000)
        dt = (now - self._last_ts) if self._last_ts else None
        for counter, rate_field in _RATES.items():
            v = self.broker.metrics.val(counter)
            prev = self._last_counters.get(counter)
            if dt and prev is not None and dt > 0:
                out[rate_field] = round(max(0, v - prev) / dt, 2)
            else:
                out[rate_field] = 0.0
            self._last_counters[counter] = v
        self._last_ts = now
        self.samples.append(out)
        return out

    def window(self, latest: Optional[int] = None) -> List[Dict]:
        out = list(self.samples)
        if latest is not None and latest > 0:
            out = out[-latest:]
        return out

    # --- lifecycle --------------------------------------------------------

    def start(self) -> None:
        if self._task is None:
            self.sample()  # seed the delta base
            self._task = asyncio.ensure_future(self._loop())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _loop(self) -> None:
        while True:
            try:
                await asyncio.sleep(self.interval)
                self.sample()
            except asyncio.CancelledError:
                return
            except Exception:  # pragma: no cover - keep sampling
                pass
