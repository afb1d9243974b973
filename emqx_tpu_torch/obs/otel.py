"""External tracing seam + OpenTelemetry exporter (the port's own copy
of emqx_tpu/obs/otel.py).

Reference: apps/emqx/src/emqx_external_trace.erl (provider behaviour
whose callbacks wrap the broker's route/forward/dispatch call sites,
:29-123) registered by apps/emqx_opentelemetry/src/emqx_otel_trace.erl.
Here the seam is `broker.tracer` — None costs one attribute check on
the hot path; a registered tracer gets hierarchical spans:

    mqtt.publish (root, per inbound message)
      ├── broker.route     (match_routes: filters matched)
      └── broker.dispatch  (local fanout: deliveries)

(the reference's `broker.forward` leg comes with the cluster layer).

OtelTracer batches finished spans and exports OTLP/HTTP JSON
(opentelemetry-proto trace service shape) to a collector endpoint; a
drop counter surfaces exporter backpressure instead of unbounded
buffering. Trace ids derive from the message id so one message's
spans correlate across nodes (the reference propagates tracecontext
the same way, emqx_otel_trace.erl)."""

from __future__ import annotations

import asyncio
import json
import logging
import secrets
import time
import urllib.request
from typing import Any, Dict, List, Optional

log = logging.getLogger("emqx_tpu_torch.obs.otel")

MAX_BUFFER = 4096


class Span:
    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "start_ns", "end_ns",
        "attrs",
    )

    def __init__(self, name: str, trace_id: str, parent_id: str = ""):
        self.name = name
        self.trace_id = trace_id
        self.span_id = secrets.token_hex(8)
        self.parent_id = parent_id
        self.start_ns = time.time_ns()
        self.end_ns = 0
        self.attrs: Dict[str, Any] = {}

    def set(self, key: str, value: Any) -> "Span":
        self.attrs[key] = value
        return self

    def end(self) -> None:
        self.end_ns = time.time_ns()


class Tracer:
    """Provider behaviour: subclasses receive finished spans."""

    def start_span(self, name: str, trace_id: str, parent: Optional[Span]) -> Span:
        return Span(name, trace_id, parent.span_id if parent else "")

    def finish(self, span: Span) -> None:
        raise NotImplementedError


def trace_id_of(msg) -> str:
    """Message id -> 16-byte hex trace id (stable across nodes)."""
    h = getattr(msg, "id", "") or secrets.token_hex(8)
    return trace_id_of_str(str(h))


def trace_id_of_str(h: str) -> str:
    """Raw message id -> trace id (the flight recorder stores ids on
    its hot path and derives trace ids only at read/export time)."""
    import hashlib

    return hashlib.md5(h.encode()).hexdigest()


class OtelTracer(Tracer):
    """Batches spans; a background task posts OTLP/HTTP JSON."""

    def __init__(
        self,
        endpoint: str = "http://127.0.0.1:4318/v1/traces",
        service_name: str = "emqx_tpu_torch",
        flush_interval: float = 2.0,
        timeout: float = 5.0,
    ):
        self.endpoint = endpoint
        self.service_name = service_name
        self.flush_interval = flush_interval
        self.timeout = timeout
        self._buf: List[Span] = []
        self.dropped = 0
        self.exported = 0
        self._task: Optional[asyncio.Task] = None

    def finish(self, span: Span) -> None:
        span.end()
        if len(self._buf) >= MAX_BUFFER:
            self.dropped += 1
            return
        self._buf.append(span)

    # --- export ----------------------------------------------------------

    def start(self) -> None:
        self._task = asyncio.ensure_future(self._flush_loop())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _flush_loop(self) -> None:
        # the buffer DETACHES on the event loop (where finish() runs),
        # so the executor only ever serializes a batch no writer holds;
        # swapping inside the executor raced finish() appends against
        # json serialization of the same list
        while True:
            try:
                await asyncio.sleep(self.flush_interval)
                batch = self._swap()
                await asyncio.get_running_loop().run_in_executor(
                    None, self._export, batch
                )
            except asyncio.CancelledError:
                return
            except Exception as e:  # noqa: BLE001
                log.warning("otel export failed: %s", e)

    def _swap(self) -> List[Span]:
        batch = self._buf
        self._buf = []
        return batch

    def flush(self) -> int:
        """Synchronous swap+export (tests, shutdown drain)."""
        return self._export(self._swap())

    def _export(self, batch: List[Span]) -> int:
        if not batch:
            return 0
        body = json.dumps(self._otlp(batch)).encode()
        req = urllib.request.Request(
            self.endpoint, data=body,
            headers={"content-type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout):
                pass
        except Exception:
            # a failed export IS a drop: the batch is already detached
            # and will not be retried — count it so backpressure is
            # visible on the scrape (emqx_otel_spans_dropped), then
            # re-raise for the caller's logging
            self.dropped += len(batch)
            raise
        self.exported += len(batch)
        return len(batch)

    def _otlp(self, spans: List[Span]) -> dict:
        def attr(k, v):
            if isinstance(v, bool):
                val = {"boolValue": v}
            elif isinstance(v, int):
                val = {"intValue": str(v)}
            elif isinstance(v, float):
                val = {"doubleValue": v}
            else:
                val = {"stringValue": str(v)}
            return {"key": k, "value": val}

        return {
            "resourceSpans": [{
                "resource": {
                    "attributes": [attr("service.name", self.service_name)]
                },
                "scopeSpans": [{
                    "scope": {"name": "emqx_tpu_torch.broker"},
                    "spans": [
                        {
                            "traceId": s.trace_id,
                            "spanId": s.span_id,
                            **(
                                {"parentSpanId": s.parent_id}
                                if s.parent_id else {}
                            ),
                            "name": s.name,
                            "kind": 1,
                            "startTimeUnixNano": str(s.start_ns),
                            "endTimeUnixNano": str(s.end_ns),
                            "attributes": [
                                attr(k, v) for k, v in s.attrs.items()
                            ],
                        }
                        for s in spans
                    ],
                }],
            }]
        }


class MemoryTracer(Tracer):
    """Test/debug sink: keeps finished spans in memory."""

    def __init__(self) -> None:
        self.spans: List[Span] = []

    def finish(self, span: Span) -> None:
        span.end()
        self.spans.append(span)
