"""Durable-tier metric surface: the `emqx_ds_*` Prometheus families
(the port's own copy of emqx_tpu/ds/metrics.py).

The kernel-telemetry collector owns `emqx_xla_*` and the broker scrape
owns the bare `emqx_*` families; the durable tier gets its own
namespace so the crash-consistency counters (torn WAL tails, CRC
failures, shard fail-stops, recovery timings) survive broker teardown
— a KV store replays its WAL during `open()`, often before any broker
or telemetry object exists, so the ledger must be process-global and
always-on rather than hung off a router.

Every family renders on every scrape with a zero default: the
static gate's driven-scrape leg requires each declared family to emit
at least one sample, and an absent-until-first-fault family would read
as "no exposition code" instead of "no faults yet".

Rendered families (all counters unless noted):

  # TYPE emqx_ds_wal_torn_records_total counter
  # TYPE emqx_ds_wal_crc_failures_total counter
  # TYPE emqx_ds_wal_replayed_records_total counter
  # TYPE emqx_ds_wal_upgraded_files_total counter
  # TYPE emqx_ds_shard_failures_total counter
  # TYPE emqx_ds_shard_recoveries_total counter
  # TYPE emqx_ds_shard_read_only gauge
  # TYPE emqx_ds_recovery_last_ms gauge
  # TYPE emqx_ds_fault_injected_total counter   (labeled {leg})
"""

from __future__ import annotations

import threading
from typing import Dict, List

_COUNTER_FAMILIES = (
    "wal_torn_records_total",
    "wal_crc_failures_total",
    "wal_replayed_records_total",
    "wal_upgraded_files_total",
    "shard_failures_total",
    "shard_recoveries_total",
)

_GAUGE_FAMILIES = (
    "shard_read_only",
    "recovery_last_ms",
)


class DsMetrics:
    """Process-global durable-tier ledger. Counters are monotonic for
    the process lifetime (Prometheus counter semantics); tests assert
    deltas, never absolutes."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {n: 0 for n in _COUNTER_FAMILIES}
        self.gauges: Dict[str, float] = {n: 0.0 for n in _GAUGE_FAMILIES}
        # fault_injected_total{leg} — the disk injector's ledger
        self.injected: Dict[str, int] = {}

    def count(self, name: str, n: int = 1) -> None:
        if n:
            with self._lock:
                self.counters[name] = self.counters.get(name, 0) + int(n)
        return None

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = float(value)

    def count_injected(self, leg: str, n: int = 1) -> None:
        with self._lock:
            self.injected[leg] = self.injected.get(leg, 0) + int(n)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out: Dict[str, float] = dict(self.counters)
            out.update(self.gauges)
            return out

    def prometheus_lines(self, node_name: str = "emqx@127.0.0.1") -> List[str]:
        node = f'node="{node_name}"'
        with self._lock:
            counters = dict(self.counters)
            gauges = dict(self.gauges)
            injected = dict(self.injected)
        lines: List[str] = []
        for name in _COUNTER_FAMILIES:
            fam = f"emqx_ds_{name}"
            lines.append(f"# TYPE {fam} counter")
            lines.append(f"{fam}{{{node}}} {counters.get(name, 0)}")
        for name in _GAUGE_FAMILIES:
            fam = f"emqx_ds_{name}"
            lines.append(f"# TYPE {fam} gauge")
            lines.append(f"{fam}{{{node}}} {gauges.get(name, 0.0)}")
        fam = "emqx_ds_fault_injected_total"
        lines.append(f"# TYPE {fam} counter")
        if injected:
            for leg in sorted(injected):
                lines.append(f'{fam}{{{node},leg="{leg}"}} {injected[leg]}')
        else:
            # zero default keeps the family sampled pre-first-injection
            lines.append(f'{fam}{{{node},leg="none"}} 0')
        return lines


DS_METRICS = DsMetrics()
