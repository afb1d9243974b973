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

`NullKernelTelemetry` keeps the hot path branch-free when disabled:
every record method is a bound no-op and `clock` returns 0.0 without a
syscall, so instrumented code never tests a flag.
"""

from __future__ import annotations

import logging
from bisect import bisect_left
from time import perf_counter
from typing import Dict, Sequence, Set, Tuple

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
        self.retrace_warn_after = retrace_warn_after
        self.hist: Dict[str, StreamingHistogram] = {}
        # standalone histograms outside the dispatch legs (the result
        # transfer's `transfer_seconds`)
        self.family_hist: Dict[str, StreamingHistogram] = {}
        self.counters: Dict[str, int] = {}
        self.gauges: Dict[str, float] = {}
        self._shape_keys: Dict[str, Set[tuple]] = {}
        self._trace_seq = 0

    # --- dispatch histograms ---------------------------------------------

    def histogram(self, leg: str) -> StreamingHistogram:
        h = self.hist.get(leg)
        if h is None:
            h = self.hist[leg] = StreamingHistogram()
        return h

    def record_dispatch(self, leg: str, seconds: float) -> None:
        self.histogram(leg).observe(seconds)

    def observe_family(self, name: str, seconds: float) -> None:
        """Record one sample into the standalone histogram `name`
        (created on first observe)."""
        h = self.family_hist.get(name)
        if h is None:
            h = self.family_hist[name] = StreamingHistogram()
        h.observe(seconds)

    # --- counters / gauges ------------------------------------------------

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

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
        if len(seen) == self.retrace_warn_after:
            self.count("retrace_warnings_total")
            log.warning(
                "kernel %s reached %d distinct shape buckets — "
                "batch-shape churn; pad batches to "
                "pow2 sizes", kernel, len(seen),
            )
        return True

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
        hbm = 0
        for arrs in (
            dtable._dev, dtable._dev_meta, dtable._dev_slots,
        ):
            if arrs is not None:
                hbm += sum(int(a.nbytes) for a in arrs)
        if dtable._dev_residual is not None:
            hbm += int(dtable._dev_residual.nbytes)
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


class NullKernelTelemetry:
    """Branch-free disabled collector: instrumented code calls the same
    methods and multiplies out to nothing — no flag tests on the hot
    path, no syscalls (clock returns 0.0), no state."""

    enabled = False
    tracer = None

    @staticmethod
    def clock() -> float:
        return 0.0

    def histogram(self, leg):  # tests/bench introspection only
        return StreamingHistogram()

    def record_dispatch(self, leg, seconds) -> None:
        pass

    def observe_family(self, name, seconds) -> None:
        pass

    def count(self, name, n=1) -> None:
        pass

    def set_gauge(self, name, value) -> None:
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


NULL = NullKernelTelemetry()
