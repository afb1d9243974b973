"""Kernel telemetry for the port's match path (the port's own copy of
emqx_tpu/obs/kernel_telemetry.py: the collector, its null twin and the
dispatch-leg names).

The Router/DeviceTable hot path reports into one always-on collector:

  * per-dispatch latency in fixed-bucket streaming histograms
    (p50/p99/p999 queryable at runtime), one series per leg — the
    hash-index kernel, the residual dense kernel, the host-trie
    fallback, plus the encode/unpack host stages and device sync;
  * a shape-bucket tracker keyed on each kernel's launch shapes
    (batch size, max_hits, packed class count, slot-table size): the
    counter stays flat under steady shapes and increments exactly when
    a new shape bucket appears;
  * DeviceTable gauges: device bytes resident, pow2 capacity vs active
    rows, cuckoo slot load factor, pending-delta queue depth, last
    sync batch size;
  * escalation/fallback counters: hash-kernel overflow re-launches,
    ambiguity host fallbacks, rows the pattern-class index couldn't
    class (residual).

The mesh path (parallel/sharded_match.py) reports the residual wait of
its finish halves as the family `mesh_combine_seconds`
(observe_family), the last churn sync's row+slot batch as the
`mesh_sync_batch_rows` gauge, the layout as `mesh_shards`, and
per-shard host->device rows as the labeled counter family
`mesh_shard_transfer_rows_total{shard=...}`; its launch shapes under the
keys `mesh_match_ids`, `mesh_match_ids_hash`, `apply_delta`,
`mesh_slot_delta` and `mesh_sync`.

Export surfaces: `prometheus_lines()` renders the `emqx_xla_*`
families (the reference's names, kept so the two scrapes compare one to
one: histograms with `_bucket`/`_sum`/`_count` + `le` labels) appended
to the broker scrape; `snapshot()` is the JSON view the flight
recorder's bundles carry; an optional `tracer` (obs/otel.py Tracer)
receives encode -> dispatch -> unpack spans per batch, and an attached
flight recorder (`flight`, obs/flight_recorder.py) receives every
dispatch-leg sample and every new shape bucket as a ring event.

`NullKernelTelemetry` keeps the hot path branch-free when disabled:
every record method is a bound no-op and `clock` returns 0.0 without a
syscall, so instrumented code never tests a flag.
"""

from __future__ import annotations

import logging
from bisect import bisect_left
from time import perf_counter
from typing import Any, Dict, List, Sequence, Set, Tuple

log = logging.getLogger("emqx_tpu_torch.obs.kernel_telemetry")

# First bucket upper bound == bench.py's epsilon clamp ceiling
# (EPS=1e-5 per batch, saturation test at EPS*1.2): a latency sample in
# bucket zero IS a floor-saturated measurement, so "the estimate sits
# on the clamp" becomes a histogram query instead of bespoke bracketing
# logic that can drift from the exporter.
CLAMP_BOUND = 1.2e-5

# √2-spaced bounds from the clamp ceiling up to ~10s: 40 finite buckets
# + one +Inf overflow. Fixed at import so every histogram (router,
# bench, tests) shares one bucket layout and merges are index-aligned.
_N_BOUNDS = 40
BOUNDS: Tuple[float, ...] = tuple(
    CLAMP_BOUND * (2.0 ** (i / 2.0)) for i in range(_N_BOUNDS)
)

# dispatch legs with dedicated series (callers may add ad-hoc legs,
# e.g. bench labels its configs)
LEG_HASH = "hash"  # pattern-class cuckoo kernel (the production leg)
LEG_DENSE = "dense"  # residual dense kernel / no-index path
LEG_FALLBACK = "fallback"  # host-trie re-match (ambiguity contract)
LEG_ENCODE = "encode"  # host: topic dictionary-encode
LEG_UNPACK = "unpack"  # host: candidate verify + dest expansion
LEG_SYNC = "sync"  # DeviceTable delta scatter / full upload


class StreamingHistogram:
    """Fixed-bucket streaming latency histogram (seconds).

    O(1) observe via bisect on the shared √2 bound ladder; percentile
    answers by linear interpolation inside the located bucket. Buckets
    are cumulative only at render time (Prometheus `le` semantics)."""

    __slots__ = ("bounds", "counts", "total", "sum")

    unit = "seconds"

    def __init__(self, bounds: Sequence[float] = BOUNDS):
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)  # [+Inf] overflow last
        self.total = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self.total += 1
        self.sum += v

    def merge(self, other: "StreamingHistogram") -> None:
        assert self.bounds == other.bounds
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.total += other.total
        self.sum += other.sum

    def percentile(self, p: float) -> float:
        """p in [0, 100] -> seconds (0.0 when empty). Interpolates
        linearly within the located bucket; the +Inf bucket reports the
        last finite bound (a floor, honestly labeled by the caller)."""
        if self.total == 0:
            return 0.0
        rank = (p / 100.0) * self.total
        cum = 0.0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank and c > 0:
                if i >= len(self.bounds):  # +Inf bucket
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                frac = (rank - (cum - c)) / c
                return lo + (hi - lo) * max(0.0, min(1.0, frac))
        return self.bounds[-1]

    def clamp_saturated(self) -> bool:
        """True when at least half the samples sit in bucket zero —
        i.e. the median is at or below the epsilon clamp ceiling, so
        the series measures the floor, not a throughput."""
        return self.total > 0 and 2 * self.counts[0] >= self.total

    def snapshot(self) -> Dict[str, Any]:
        return {
            "count": self.total,
            "sum_seconds": round(self.sum, 9),
            "p50_ms": round(self.percentile(50) * 1e3, 6),
            "p99_ms": round(self.percentile(99) * 1e3, 6),
            "p999_ms": round(self.percentile(99.9) * 1e3, 6),
            "clamp_saturated": self.clamp_saturated(),
        }


class CountHistogram(StreamingHistogram):
    """Unitless twin for SIZE distributions (fanout width, batch
    occupancy): same streaming ladder machinery, but the snapshot
    reports raw quantiles — `p50`, not `p50_ms` — so a subscriber
    count never renders as seconds of latency, and the exposition
    `_sum` drops the nanosecond padding."""

    __slots__ = ()

    unit = "count"

    def snapshot(self) -> Dict[str, Any]:
        return {
            "count": self.total,
            "sum": round(self.sum, 3),
            "p50": round(self.percentile(50), 3),
            "p99": round(self.percentile(99), 3),
            "p999": round(self.percentile(99.9), 3),
            "clamp_saturated": self.clamp_saturated(),
        }


def _fmt_le(v: float) -> str:
    return format(v, "g")


def render_histogram_lines(
    lines: List[str],
    fam: str,
    label_str: str,
    h: StreamingHistogram,
    emit_type: bool = True,
) -> None:
    """Append one labeled histogram series in Prometheus text
    exposition (cumulative `le` buckets, terminal +Inf, `_sum`/`_count`).
    Shared by every histogram exporter in obs/ — kernel telemetry,
    flight-recorder hook durations, sentinel publish stages — so the
    structural invariants live in one place. `emit_type=False` for the
    2nd..nth series of one family."""
    if emit_type:
        lines.append(f"# TYPE {fam} histogram")
    cum = 0
    for le, c in zip(h.bounds, h.counts):
        cum += c
        lines.append(f'{fam}_bucket{{{label_str},le="{_fmt_le(le)}"}} {cum}')
    lines.append(f'{fam}_bucket{{{label_str},le="+Inf"}} {h.total}')
    # seconds histograms keep nanosecond precision; unitless (count)
    # histograms render their sum as a plain number
    if h.unit == "seconds":
        lines.append(f"{fam}_sum{{{label_str}}} {h.sum:.9f}")
    else:
        lines.append(f"{fam}_sum{{{label_str}}} {_fmt_le(h.sum)}")
    lines.append(f"{fam}_count{{{label_str}}} {h.total}")


class KernelTelemetry:
    """The live collector. One instance per Router (always-on by
    default); every method is cheap host work — dict probes, a bisect,
    integer adds — so the <2% overhead budget holds even on the
    microsecond-scale host legs."""

    enabled = True
    clock = staticmethod(perf_counter)

    def __init__(self, tracer=None, retrace_warn_after: int = 16):
        # spans flow through the obs/otel.py Tracer seam when attached
        # (None costs one attribute read per batch, same contract as
        # broker.tracer)
        self.tracer = tracer
        # flight-recorder seam (obs/flight_recorder.FlightRecorder):
        # when attached, every dispatch-leg sample also lands in the
        # ring as an `xla.<leg>` event (the reference's kind names) and
        # every new shape bucket as `xla.recompile`. None costs one
        # attribute read per record.
        self.flight = None
        self.retrace_warn_after = retrace_warn_after
        self.hist: Dict[str, StreamingHistogram] = {}
        # standalone histograms outside the dispatch legs (the result
        # transfer's `transfer_seconds`)
        self.family_hist: Dict[str, StreamingHistogram] = {}
        self.counters: Dict[str, int] = {}
        # labeled counter families: name -> {((k, v), ...) -> count}
        self.labeled_counters: Dict[str, Dict[Tuple[Tuple[str, str], ...], int]] = {}
        self.gauges: Dict[str, float] = {}
        self._shape_keys: Dict[str, Set[tuple]] = {}
        self._trace_seq = 0
        # serve-time shape accounting: False during the engine's shape
        # warm-up, True once mark_serving() flips it — a fresh shape key
        # after that is a new launch shape a production publisher met,
        # counted as `recompiles_at_serve_total`
        self.serving = False

    # --- dispatch histograms ---------------------------------------------

    def histogram(self, leg: str) -> StreamingHistogram:
        h = self.hist.get(leg)
        if h is None:
            h = self.hist[leg] = StreamingHistogram()
        return h

    def record_dispatch(self, leg: str, seconds: float) -> None:
        self.histogram(leg).observe(seconds)
        fr = self.flight
        if fr is not None:
            fr.record("xla." + leg, "", {"s": seconds})

    def record_samples(
        self, leg: str, values: Sequence[float]
    ) -> StreamingHistogram:
        """Fold a batch of already-measured samples into `leg`,
        returning a histogram of JUST this batch so the caller can
        query saturation per measurement while the collector
        accumulates the run-wide series."""
        batch = StreamingHistogram()
        for v in values:
            batch.observe(float(v))
        self.histogram(leg).merge(batch)
        return batch

    def observe_family(self, name: str, seconds: float) -> None:
        """Record one sample into the standalone histogram `name`
        (created on first observe)."""
        h = self.family_hist.get(name)
        if h is None:
            h = self.family_hist[name] = StreamingHistogram()
        h.observe(seconds)

    def dispatch_percentile(
        self,
        p: float,
        legs: Sequence[str] = (LEG_HASH, LEG_DENSE, LEG_FALLBACK),
    ) -> float:
        """Percentile over the merged device-dispatch legs (seconds) —
        the dashboard's one-number 'match p99'."""
        merged = StreamingHistogram()
        for leg in legs:
            h = self.hist.get(leg)
            if h is not None:
                merged.merge(h)
        return merged.percentile(p)

    # --- counters / gauges ------------------------------------------------

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def count_labeled(self, name: str, labels: Dict[str, str], n: int = 1) -> None:
        """Increment one series of the labeled counter family `name`
        (e.g. mesh_shard_transfer_rows_total{shard}): two dict probes and
        a tuple build."""
        fam = self.labeled_counters.get(name)
        if fam is None:
            fam = self.labeled_counters[name] = {}
        key = tuple(sorted(labels.items()))
        fam[key] = fam.get(key, 0) + n

    def set_gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def add_gauge(self, name: str, delta: float) -> None:
        """Relative gauge move (e.g. transfer_inflight up at launch,
        down at collect) — one dict probe + add, hot-path safe."""
        self.gauges[name] = self.gauges.get(name, 0) + delta

    # --- recompile / shape-bucket tracking --------------------------------

    def record_shape(self, kernel: str, key: tuple) -> bool:
        """Note a dispatch of `kernel` under jit-relevant static shapes
        `key`. A fresh key is a new shape bucket; the
        counter therefore stays flat across repeated same-shape batches.
        Crossing `retrace_warn_after` distinct keys flags runaway
        batch-shape churn. Returns True when the key was new."""
        seen = self._shape_keys.get(kernel)
        if seen is None:
            seen = self._shape_keys[kernel] = set()
        if key in seen:
            return False
        seen.add(key)
        self.count("recompiles_total")
        if self.serving:
            self.count("recompiles_at_serve_total")
        fr = self.flight
        if fr is not None:
            fr.record(
                "xla.recompile", "",
                {"kernel": kernel, "shape": str(key), "buckets": len(seen)},
            )
        if len(seen) == self.retrace_warn_after:
            self.count("retrace_warnings_total")
            log.warning(
                "kernel %s reached %d distinct shape buckets — "
                "batch-shape churn; pad batches to "
                "pow2 sizes", kernel, len(seen),
            )
        return True

    def shape_buckets(self) -> Dict[str, int]:
        return {k: len(v) for k, v in self._shape_keys.items()}

    def mark_serving(self) -> None:
        """Close the warm-up window: every shape bucket met from here on
        is a serve-time new launch shape. The counter is seeded at 0 so
        the family renders on the scrape even over a clean run."""
        self.serving = True
        self.counters.setdefault("recompiles_at_serve_total", 0)

    # --- device-table state ----------------------------------------------

    def record_sync(
        self, rows: int, seconds: float, pending: int, full: bool
    ) -> None:
        self.record_dispatch(LEG_SYNC, seconds)
        self.count("sync_rows_total", rows)
        if full:
            self.count("full_uploads_total")
        self.set_gauge("sync_batch_size", rows)
        self.set_gauge("pending_deltas", pending)

    def observe_device_table(self, dtable) -> None:
        """Sample DeviceTable/ShardedDeviceTable-resident state into
        gauges. Called after sync when device state changed; all O(1)
        attribute reads plus a handful of nbytes sums."""
        table = dtable.table
        hbm = sum(
            _nbytes(a) for a in (
                dtable._dev, dtable._dev_meta, dtable._dev_slots, dtable._dev_residual,
            )
        )
        self.set_gauge("device_table_bytes", hbm)
        self.set_gauge("device_table_capacity", table.capacity)
        self.set_gauge("device_table_rows", len(table))
        self.set_gauge("pending_deltas", len(table.dirty))
        ix = getattr(dtable, "index", None)
        if ix is not None:
            self.set_gauge("classes_active", ix.active_hi())
            self.set_gauge("residual_rows", len(ix.residual_rows))
            self.set_gauge(
                "slot_load_factor",
                round(len(ix) / ix.n_slots, 6) if ix.n_slots else 0.0,
            )

    # --- spans (encode -> dispatch -> unpack) -----------------------------

    def span(self, name: str, parent=None):
        """Start a child span under `parent` (or a new trace) through
        the attached Tracer; returns None when no tracer is wired so
        hot-path callers pay one attribute read."""
        tr = self.tracer
        if tr is None:
            return None
        if parent is not None:
            trace_id = parent.trace_id
        else:
            self._trace_seq += 1
            trace_id = f"{self._trace_seq:032x}"
        return tr.start_span(name, trace_id, parent)

    def end_span(self, span) -> None:
        if span is not None:
            self.tracer.finish(span)

    # --- export -----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able runtime view (the flight bundles' telemetry dump)."""
        return {
            "enabled": True,
            "counters": dict(sorted(self.counters.items())),
            "labeled_counters": {
                name: {
                    ",".join(f"{k}={v}" for k, v in key): n
                    for key, n in sorted(series.items())
                }
                for name, series in sorted(self.labeled_counters.items())
            },
            "gauges": dict(sorted(self.gauges.items())),
            "dispatch": {
                leg: h.snapshot() for leg, h in sorted(self.hist.items())
            },
            "families": {
                name: h.snapshot()
                for name, h in sorted(self.family_hist.items())
            },
            "recompiles": {
                "total": self.counters.get("recompiles_total", 0),
                "shape_buckets": dict(sorted(self.shape_buckets().items())),
            },
        }

    def prometheus_lines(self, node_name: str = "emqx@127.0.0.1") -> List[str]:
        """`emqx_xla_*` families in Prometheus text exposition. The
        namespace is disjoint from the broker's `emqx_` families (none
        of which start with `xla_`), so appending to the broker scrape
        preserves the one-family-per-name invariant."""
        node = f'node="{node_name}"'
        lines: List[str] = []
        if self.hist:
            fam = "emqx_xla_dispatch_duration_seconds"
            lines.append(f"# TYPE {fam} histogram")
            for leg in sorted(self.hist):
                render_histogram_lines(
                    lines, fam, f'{node},leg="{leg}"', self.hist[leg],
                    emit_type=False,
                )
        for name in sorted(self.family_hist):
            render_histogram_lines(
                lines, f"emqx_xla_{name}", node, self.family_hist[name]
            )
        for name in sorted(self.counters):
            fam = f"emqx_xla_{name}"
            lines.append(f"# TYPE {fam} counter")
            lines.append(f"{fam}{{{node}}} {self.counters[name]}")
        for name in sorted(self.labeled_counters):
            fam = f"emqx_xla_{name}"
            lines.append(f"# TYPE {fam} counter")
            series = self.labeled_counters[name]
            for key in sorted(series):
                lbl = ",".join(f'{k}="{v}"' for k, v in key)
                lines.append(f"{fam}{{{node},{lbl}}} {series[key]}")
        for name in sorted(self.gauges):
            fam = f"emqx_xla_{name}"
            lines.append(f"# TYPE {fam} gauge")
            lines.append(f"{fam}{{{node}}} {self.gauges[name]}")
        buckets = self.shape_buckets()
        if buckets:
            fam = "emqx_xla_jit_cache_entries"
            lines.append(f"# TYPE {fam} gauge")
            for kernel in sorted(buckets):
                lines.append(
                    f'{fam}{{{node},kernel="{kernel}"}} {buckets[kernel]}'
                )
        return lines


def _nbytes(x) -> int:
    """Bytes of a tensor or of nested tuples of tensors (a mesh table
    holds one tuple per device); 0 for None."""
    if x is None:
        return 0
    if isinstance(x, tuple):
        return sum(_nbytes(a) for a in x)
    return int(x.nbytes)


class NullKernelTelemetry:
    """Branch-free disabled collector: instrumented code calls the same
    methods and multiplies out to nothing — no flag tests on the hot
    path, no syscalls (clock returns 0.0), no state."""

    enabled = False
    tracer = None
    flight = None

    @staticmethod
    def clock() -> float:
        return 0.0

    def histogram(self, leg):  # tests/bench introspection only
        return StreamingHistogram()

    def record_dispatch(self, leg, seconds) -> None:
        pass

    def record_samples(self, leg, values) -> StreamingHistogram:
        batch = StreamingHistogram()
        for v in values:
            batch.observe(float(v))
        return batch

    def observe_family(self, name, seconds) -> None:
        pass

    def dispatch_percentile(self, p, legs=()) -> float:
        return 0.0

    def count(self, name, n=1) -> None:
        pass

    def count_labeled(self, name, labels, n=1) -> None:
        pass

    def set_gauge(self, name, value) -> None:
        pass

    def add_gauge(self, name, delta) -> None:
        pass

    def record_shape(self, kernel, key) -> bool:
        return False

    def record_sync(self, rows, seconds, pending, full) -> None:
        pass

    def observe_device_table(self, dtable) -> None:
        pass

    def span(self, name, parent=None):
        return None

    def end_span(self, span) -> None:
        pass

    def shape_buckets(self) -> Dict[str, int]:
        return {}

    def mark_serving(self) -> None:
        pass

    def snapshot(self) -> Dict[str, Any]:
        return {"enabled": False}

    def prometheus_lines(self, node_name: str = "emqx@127.0.0.1") -> List[str]:
        return []


NULL = NullKernelTelemetry()
