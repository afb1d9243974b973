"""Prometheus text exposition (apps/emqx_prometheus/src/emqx_prometheus.erl;
the port's own copy of emqx_tpu/obs/prometheus.py).

Renders the broker's counters and gauges into the Prometheus text
format the reference serves at /api/v5/prometheus/stats. Counter
names are mapped `messages.received` → `emqx_messages_received`,
matching the reference's emqx_* metric families; stats `.max`
watermarks map to `emqx_*_max` gauge families.

Kernel-telemetry families (`emqx_xla_*` — dispatch-latency histograms
with `_bucket`/`_sum`/`_count` + `le` labels, recompile counters,
DeviceTable gauges; see obs/kernel_telemetry.py) append to the same
scrape when the broker's Router carries a live collector, so the
device hot path and the broker surface share one exposition endpoint.

When the Observability bundle is passed, the scrape also carries:

  * `emqx_slow_subs_*` — tracked slow-subscription count + worst
    delivery timespan (apps/emqx_slow_subs, previously API-only);
  * `emqx_topic_messages_*` — per-registered-topic counters with a
    `topic` label (emqx_topic_metrics, previously API-only);
  * `emqx_otel_spans_exported`/`emqx_otel_spans_dropped` — exporter
    throughput/backpressure when an OtelTracer is the broker tracer;
  * `emqx_flight_*` + `emqx_hook_duration_seconds` — flight-recorder
    ring/trigger counters and per-hookpoint latency histograms
    (obs/flight_recorder.py).

The process-global ledgers render on every scrape, each family with a
zero default: `emqx_ds_*` (the durable tier's crash-consistency
counters, ds/metrics.py), `emqx_json_*` (jsonc.py), `emqx_frame_*`
(framec.py) and `emqx_delivery_*` (broker/delivery.py).

The reference's families of layers the port does not have yet are not
rendered: `emqx_cluster_*` and the mesh microscope's `emqx_xla_mesh_*`
scope families (the cluster layer and obs/mesh_scope.py).
"""

from __future__ import annotations

from typing import List


def _norm(name: str) -> str:
    return "emqx_" + name.replace(".", "_").replace("-", "_")


def _lab(value: str) -> str:
    """Escape a label value per the exposition format."""
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def prometheus_text(broker, node_name: str = "emqx@127.0.0.1", obs=None) -> str:
    lines: List[str] = []
    label = f'{{node="{node_name}"}}'
    seen = set()

    def emit(name: str, kind: str, value) -> None:
        if name in seen:  # one family per name or the scrape fails
            return
        seen.add(name)
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name}{label} {value}")

    for name, val in sorted(broker.metrics.all().items()):
        emit(_norm(name), "counter", val)
    # broker-level families the reference always exposes (win over the
    # stats-loop variants below, which only appear once traffic starts)
    emit("emqx_sessions_count", "gauge", len(broker.sessions))
    emit("emqx_subscriptions_count", "gauge", len(broker.suboptions))
    for name, val in sorted(broker.stats.all().items()):
        # `.max` watermarks normalize to their own `emqx_*_max` family
        # (distinct names, so the one-family invariant holds)
        emit(_norm(name), "gauge", val)
    rstats = broker.router.stats()
    emit(
        "emqx_topics_count",
        "gauge",
        rstats["exact_topics"] + rstats["wildcard_routes"] + rstats["deep_routes"],
    )
    # kernel telemetry: the emqx_xla_* namespace is disjoint from every
    # broker-derived family, so a plain append preserves uniqueness
    tel = getattr(broker.router, "telemetry", None)
    if tel is not None and tel.enabled:
        lines.extend(tel.prometheus_lines(node_name))
    # publish sentinel: stage-attribution histograms + SLO burn gauges
    # (audit counters already rode the collector's emqx_xla_* render)
    sentinel = getattr(broker, "sentinel", None)
    if sentinel is not None:
        lines.extend(sentinel.prometheus_lines(node_name))
    # otel exporter throughput/backpressure (previously only process-
    # internal attributes: a collector outage dropped spans invisibly)
    tracer = getattr(broker, "tracer", None)
    if tracer is not None and hasattr(tracer, "exported"):
        emit("emqx_otel_spans_exported", "counter", tracer.exported)
        emit("emqx_otel_spans_dropped", "counter", tracer.dropped)
    if obs is not None:
        _emit_obs(lines, obs, node_name)
    # durable-tier crash-consistency ledger (emqx_ds_* namespace —
    # process-global: WAL replay runs at open(), often before any
    # broker or obs object exists, so it renders on EVERY scrape)
    from ..ds.metrics import DS_METRICS

    lines.extend(DS_METRICS.prometheus_lines(node_name))
    # JSON codec seam ledger (emqx_json_* namespace — process-global:
    # payloads are decoded before any broker object exists)
    from ..jsonc import JSON_METRICS

    lines.extend(JSON_METRICS.prometheus_lines(node_name))
    # wire-frame codec seam ledger (emqx_frame_* namespace — process-
    # global: the counted fallback IS the parity story, so it must
    # render even before a broker object exists)
    from ..framec import FRAME_METRICS

    lines.extend(FRAME_METRICS.prometheus_lines(node_name))
    # native delivery-ledger seam (emqx_delivery_* namespace): the
    # native/twin split and per-op fallbacks on every scrape
    from ..broker.delivery import DELIVERY_METRICS

    lines.extend(DELIVERY_METRICS.prometheus_lines(node_name))
    # retainer surface (emqx_retainer_* namespace — the max_retained
    # drop and expiry sweep were previously invisible)
    retainer = getattr(broker, "retainer", None)
    if retainer is not None and hasattr(retainer, "prometheus_lines"):
        lines.extend(retainer.prometheus_lines(node_name))
    return "\n".join(lines) + "\n"


def _emit_obs(lines: List[str], obs, node_name: str) -> None:
    node = f'node="{node_name}"'
    slow = getattr(obs, "slow_subs", None)
    if slow is not None:
        top = slow.topk()
        lines.append("# TYPE emqx_slow_subs_tracked gauge")
        lines.append(f"emqx_slow_subs_tracked{{{node}}} {len(top)}")
        lines.append("# TYPE emqx_slow_subs_max_timespan_ms gauge")
        worst = top[0]["timespan"] if top else 0.0
        lines.append(
            f"emqx_slow_subs_max_timespan_ms{{{node}}} {round(worst, 3)}"
        )
    tm = getattr(obs, "topic_metrics", None)
    if tm is not None:
        rows = tm.list()
        if rows:
            # one family per counter, one labeled sample per topic
            counters = sorted(rows[0]["metrics"])
            for counter in counters:
                fam = "emqx_topic_" + counter.replace(".", "_") + "_total"
                lines.append(f"# TYPE {fam} counter")
                for row in rows:
                    lines.append(
                        f'{fam}{{{node},topic="{_lab(row["topic"])}"}} '
                        f"{row['metrics'][counter]}"
                    )
    flight = getattr(obs, "flight", None)
    if flight is not None:
        lines.extend(flight.prometheus_lines(node_name))
    # delivery-path microscope: sampling-profiler counters/gauges and
    # the event-loop lag histogram (obs/profiler.py) ride the bundle's
    # scrape — both are per-Observability objects, not process-global
    profiler = getattr(obs, "profiler", None)
    if profiler is not None:
        lines.extend(profiler.prometheus_lines(node_name))
    loop_lag = getattr(obs, "loop_lag", None)
    if loop_lag is not None:
        lines.extend(loop_lag.prometheus_lines(node_name))
