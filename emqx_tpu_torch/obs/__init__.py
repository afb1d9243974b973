"""Observability of the port's publish path (the port's own copy of
emqx_tpu/obs/__init__.py and the layer under it):

  * sys        — $SYS heartbeat topics (emqx_sys.erl);
  * alarm      — activate/deactivate alarms with $SYS + listener
                 fan-out (emqx_alarm.erl);
  * slow_subs  — top-k delivery-latency tracker (apps/emqx_slow_subs);
  * trace      — client/topic/ip traces to files with text or json
                 formatting (apps/emqx/src/emqx_trace);
  * otel       — the external tracing seam (`broker.tracer`) and the
                 OTLP/HTTP JSON exporter;
  * prometheus — text exposition of metrics/stats
                 (apps/emqx_prometheus);
  * topic_metrics — per-topic message counters
                 (apps/emqx_modules/emqx_topic_metrics), registered
                 here so the scrape shares one instance;
  * kernel_telemetry — device hot-path collector: dispatch-latency
                 histograms, shape-bucket tracking, device-table gauges,
                 exported as the reference's emqx_xla_* families;
  * profiler   — the delivery-path sampling profiler, its STAGE_MARK
                 seam and the event-loop lag ticker;
  * flight_recorder — anomaly-triggered black-box: always-on event
                 ring over broker hooks + device legs + alarms, trigger
                 rules, rotated snapshot bundles;
  * sentinel   — publish-path watchdog: shadow-oracle audit of served
                 device results, per-stage latency attribution, SLO
                 burn-rate alarms.

`Observability` bundles the per-broker pieces and installs the hook
taps. Default folders (`trace_dir`, `flight_dir`) sit under the
process's temp dir (TMPDIR).
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

from .alarm import AlarmError, Alarms  # noqa: F401
from .flight_recorder import (  # noqa: F401
    FlightControl,
    FlightRecorder,
    SnapshotStore,
    TriggerRule,
    default_rules,
)
from .kernel_telemetry import (  # noqa: F401
    NULL as NULL_TELEMETRY,
    KernelTelemetry,
    NullKernelTelemetry,
    StreamingHistogram,
)
from .prometheus import prometheus_text  # noqa: F401
from .sentinel import PublishSentinel, SloObjective, StageSpan  # noqa: F401
from .slow_subs import SlowSubs  # noqa: F401
from .sys import SysHeartbeat  # noqa: F401
from .topic_metrics import TopicMetrics  # noqa: F401
from .profiler import (  # noqa: F401
    DELIVERY_STAGES,
    STAGE_MARK,
    LoopLagMonitor,
    SamplingProfiler,
)
from .trace import TraceManager  # noqa: F401


class Observability:
    def __init__(
        self,
        broker,
        node_name: str = "emqx@127.0.0.1",
        trace_dir: Optional[str] = None,
        slow_threshold_ms: float = 500.0,
        slow_top_k: int = 10,
        flight: bool = True,
        flight_dir: Optional[str] = None,
        sentinel: bool = True,
        config=None,
    ):
        self.broker = broker
        self.node_name = node_name
        self.sys = SysHeartbeat(broker, node_name)
        self.alarms = Alarms(broker, node_name)
        self.slow_subs = SlowSubs(
            threshold_ms=slow_threshold_ms, top_k=slow_top_k
        )
        self.traces = TraceManager(trace_dir)
        # one TopicMetrics shared by REST + scrape (hooks install on
        # first register, so an unused registry costs nothing)
        self.topic_metrics = TopicMetrics(broker)
        self.slow_subs.install(broker.hooks)
        self.traces.install(broker.hooks)
        self.flight: Optional[FlightControl] = None
        if flight:
            self.flight = FlightControl(
                snapshot_dir=flight_dir or os.path.join(
                    tempfile.gettempdir(), "emqx_tpu_torch_flight"
                ),
                broker=broker,
                slow_subs=self.slow_subs,
                alarms=self.alarms,
                config=config,
                node_name=node_name,
            )
            self.flight.install()
        # publish sentinel: attached alongside the kernel-telemetry
        # collector so every booted node audits its own served path.
        # Knobs ride broker.perf.* when a config is wired (the port's
        # boot comes later); the constructor defaults serve the bare
        # brokers.
        self.sentinel: Optional[PublishSentinel] = None
        if sentinel:
            self.sentinel = PublishSentinel(
                broker,
                sample_n=_cfg(
                    config, "broker.perf.tpu_audit_sample_n", 1024
                ),
                quarantine=_cfg(
                    config, "broker.perf.tpu_audit_quarantine", True
                ),
                alarms=self.alarms,
                flight=self.flight,
                slo_publish_ms=_cfg(
                    config, "broker.perf.tpu_slo_publish_p99_ms", 50.0
                ),
                slo_publish_target=_cfg(
                    config, "broker.perf.tpu_slo_publish_target", 0.999
                ),
                slo_audit_target=_cfg(
                    config, "broker.perf.tpu_slo_audit_target", 0.999
                ),
                slo_fast_window_s=_cfg(
                    config, "broker.perf.tpu_slo_fast_window_s", 300.0
                ),
                slo_slow_window_s=_cfg(
                    config, "broker.perf.tpu_slo_slow_window_s", 3600.0
                ),
                slo_burn_threshold=_cfg(
                    config, "broker.perf.tpu_slo_burn_threshold", 10.0
                ),
                warmup_spans=_cfg(
                    config, "broker.perf.tpu_warmup_sample_skip", 2
                ),
            )
            broker.sentinel = self.sentinel
        # delivery-path microscope (obs/profiler.py): the sampling
        # profiler is constructed whenever delivery-stage attribution
        # is on, but only RUNS continuously when tpu_profiler_enable
        # is set — otherwise it stays parked until a flight bundle
        # auto-arms it or the API/ctl starts it on demand
        self.profiler = SamplingProfiler(
            hz=_cfg(config, "broker.perf.tpu_profiler_hz", 100.0)
        )
        self.profiler_enabled = bool(
            _cfg(config, "broker.perf.tpu_profiler_enable", False)
        )
        self.loop_lag = LoopLagMonitor(
            interval_s=_cfg(
                config, "broker.perf.tpu_loop_lag_interval_ms", 100.0
            ) / 1e3
        )
        if self.flight is not None:
            self.flight.profiler = self.profiler
        if not _cfg(config, "broker.perf.tpu_delivery_stages", True):
            # delivery sub-stage attribution off: spans stop carrying
            # subs by zeroing the sentinel histograms' feed at the
            # engine seam (the spans themselves stay — publish-stage
            # attribution is a separate, older contract)
            if self.sentinel is not None:
                self.sentinel.delivery_stages_enabled = False

    def prometheus_text(self) -> str:
        return prometheus_text(self.broker, self.node_name, obs=self)

    def start(self, sys_interval: float = 30.0) -> None:
        self.sys.start(sys_interval)
        if self.profiler_enabled:
            self.profiler.start()
        # needs a running loop; synchronous callers skip the ticker
        self.loop_lag.start()

    def stop(self) -> None:
        self.sys.stop()
        self.loop_lag.stop()
        self.profiler.stop()
        if self.sentinel is not None and self.broker.sentinel is self.sentinel:
            self.broker.sentinel = None
        if self.flight is not None:
            self.flight.uninstall()
        self.traces.close()
        self.traces.uninstall()
        self.slow_subs.uninstall()


def _cfg(config, key: str, default):
    """Config read tolerant of absent config objects (a bare broker
    constructs Observability without one)."""
    if config is None:
        return default
    try:
        v = config.get(key)
    except Exception:
        return default
    return default if v is None else v
