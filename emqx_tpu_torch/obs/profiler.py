"""Delivery-path microscope — continuous sampling profiler + loop-lag
ticker + the stage-mark seam the sampler attributes stacks with (the
port's own copy of emqx_tpu/obs/profiler.py).

The Python-side delivery path hides inside the sentinel's one opaque
`queue` bucket unless something splits it. Three pieces make it visible
without per-call probes:

  * **SamplingProfiler** — a daemon thread wakes `hz` times a second,
    walks `sys._current_frames()` for the target thread (the event
    loop's), and folds the stack into a bounded frame table. No
    tracing hooks, no per-call instrumentation: the served path pays
    NOTHING while the sampler sleeps, and one dict fold per sample
    while it runs. Stacks aggregate per delivery sub-stage (see
    STAGE_MARK below) and render as collapsed-stack flamegraph text
    (Brendan Gregg format). A sample is counted as on-CPU when process
    CPU time advanced by at least half the sampling interval since the
    previous sample — a process-level approximation, honestly
    labeled, that separates "the loop is busy" from "the loop is
    parked in epoll".

  * **STAGE_MARK** — one module-global cell the instrumented delivery
    path stamps with the sub-stage it is entering (`dispatch_loop`,
    `session_write`, ...; the Router stamps `encode` and `launch`).
    The hot-path cost is a single attribute store per stage TRANSITION
    (per batch / per publish, never per subscriber); the sampler reads
    it to bucket each stack under the sub-stage that was live when the
    sample hit.

  * **LoopLagMonitor** — `queue` would otherwise absorb event-loop
    scheduling delay from unrelated co-tenant tasks. A sampled ticker
    sleeps a fixed interval and records the overshoot (actual -
    requested) into `emqx_xla_loop_lag_seconds`, so co-tenant load has
    its own series instead of polluting the delivery sub-stages.

The profiler auto-arms for `arm_s` seconds whenever the flight
recorder freezes a bundle (obs/flight_recorder.py), so every anomaly
snapshot ships with the stacks that caused it.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from .kernel_telemetry import StreamingHistogram

# Delivery sub-stages: the first-class decomposition of the
# sentinel's queue+deliver wall, exported as
# emqx_xla_delivery_stage_seconds{stage=..}. Order is pipeline order:
#   submit_wait   — engine submit() -> the batch flush fires
#   coalesce      — flush start -> this publish's hook fold completed
#   plan_resolve  — fanout-plan cache probe / build / split
#   dispatch_loop — the per-subscriber fan walk minus writes/acks
#   session_write — packet serialize + sink/socket writes
#   ack_sweep     — QoS1/2 inflight bookkeeping + puback/retry sweeps
DELIVERY_STAGES = (
    "submit_wait", "coalesce", "plan_resolve", "dispatch_loop",
    "session_write", "ack_sweep",
)

# frame-table bounds: unique stacks and frames are interned; past the
# caps new stacks fold into one explicit overflow bucket so a stack
# storm cannot grow the table without bound (counted, never silent)
MAX_STACKS = 8192
MAX_DEPTH = 64

_OVERFLOW_KEY = ("<overflow>",)


class _StageMark:
    """The one-cell stage register the delivery path stamps and the
    sampler reads. A plain attribute store/read — no locks: a torn
    read can only misattribute one sample to a neighboring stage,
    which the sampling error already dominates."""

    __slots__ = ("stage",)

    def __init__(self) -> None:
        self.stage = ""


# module-global: broker/pubsub + dispatch_engine import this once and
# stamp `.stage`; the sampler thread reads it per sample
STAGE_MARK = _StageMark()


class SamplingProfiler:
    """Thread-based wall+CPU stack sampler over the event-loop thread.

    `start()` spawns one daemon thread; `stop()` joins it. While
    stopped the served path pays zero (no hooks are installed —
    ever). Aggregation: stack tuple (outermost..innermost
    "module:func:line" frames) -> [wall_samples, cpu_samples], bucketed
    under the STAGE_MARK sub-stage live at sample time ("" = outside
    the delivery path)."""

    def __init__(
        self,
        hz: float = 100.0,
        target_thread_id: Optional[int] = None,
        max_stacks: int = MAX_STACKS,
        max_depth: int = MAX_DEPTH,
    ):
        self.hz = max(1.0, min(float(hz), 1000.0))
        self.interval = 1.0 / self.hz
        # default target: the thread that constructs the profiler —
        # boot/Observability run on the event-loop thread, so the
        # sampler watches the loop unless told otherwise
        self.target_thread_id = (
            threading.get_ident()
            if target_thread_id is None
            else target_thread_id
        )
        self.max_stacks = max_stacks
        self.max_depth = max_depth
        # stage -> {stack_tuple -> [wall, cpu]}
        self.stacks: Dict[str, Dict[Tuple[str, ...], List[int]]] = {}
        self.samples_total = 0
        self.cpu_samples_total = 0
        self.overflow_total = 0
        self.missed_thread_total = 0
        self.started_at: Optional[float] = None
        self.stopped_at: Optional[float] = None
        self.arms_total = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._disarm_at: Optional[float] = None
        self._lock = threading.Lock()

    # --- lifecycle --------------------------------------------------------

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> bool:
        """Idempotent; returns True when a sampler thread was spawned
        by THIS call."""
        if self.running:
            return False
        self._stop.clear()
        self._disarm_at = None
        self.started_at = time.time()
        self.stopped_at = None
        self._thread = threading.Thread(
            target=self._run, name="xla-profiler", daemon=True
        )
        self._thread.start()
        return True

    def stop(self) -> None:
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join(timeout=2.0)
        self._thread = None
        self.stopped_at = time.time()

    def arm_for(self, seconds: float) -> None:
        """Flight-recorder auto-arm: run for `seconds` then self-stop
        (extends the window if already armed; never shortens a manual
        start)."""
        self.arms_total += 1
        until = time.monotonic() + max(0.0, seconds)
        if self.running:
            if self._disarm_at is not None and until > self._disarm_at:
                self._disarm_at = until
            return
        self.start()
        self._disarm_at = until

    def reset(self) -> None:
        with self._lock:
            self.stacks = {}
            self.samples_total = 0
            self.cpu_samples_total = 0
            self.overflow_total = 0
            self.missed_thread_total = 0

    # --- the sampler loop -------------------------------------------------

    def _run(self) -> None:
        interval = self.interval
        get_frames = sys._current_frames
        tid = self.target_thread_id
        mark = STAGE_MARK
        last_cpu = time.process_time()
        # count unique stacks across every stage bucket for the cap
        n_stacks = 0
        while not self._stop.wait(interval):
            if (
                self._disarm_at is not None
                and time.monotonic() >= self._disarm_at
            ):
                break
            frame = get_frames().get(tid)
            if frame is None:
                self.missed_thread_total += 1
                continue
            stack: List[str] = []
            depth = 0
            f: Any = frame
            while f is not None and depth < self.max_depth:
                co = f.f_code
                stack.append(
                    f"{co.co_filename.rsplit('/', 1)[-1]}:"
                    f"{co.co_name}:{f.f_lineno}"
                )
                f = f.f_back
                depth += 1
            stack.reverse()
            key = tuple(stack)
            cpu = time.process_time()
            on_cpu = (cpu - last_cpu) >= 0.5 * interval
            last_cpu = cpu
            stage = mark.stage
            with self._lock:
                bucket = self.stacks.get(stage)
                if bucket is None:
                    bucket = self.stacks[stage] = {}
                cell = bucket.get(key)
                if cell is None:
                    if n_stacks >= self.max_stacks:
                        self.overflow_total += 1
                        key = _OVERFLOW_KEY
                        cell = bucket.get(key)
                        if cell is None:
                            cell = bucket[key] = [0, 0]
                    else:
                        n_stacks += 1
                        cell = bucket[key] = [0, 0]
                cell[0] += 1
                if on_cpu:
                    cell[1] += 1
                    self.cpu_samples_total += 1
                self.samples_total += 1
        self.stopped_at = time.time()

    # --- export -----------------------------------------------------------

    def top_stacks(
        self, stage: Optional[str] = None, n: int = 10, which: str = "wall"
    ) -> List[Dict[str, Any]]:
        """Top-N stacks by sample count — per sub-stage when `stage`
        names one, over every bucket otherwise."""
        idx = 0 if which == "wall" else 1
        rows: List[Dict[str, Any]] = []
        with self._lock:
            buckets = (
                {stage: self.stacks.get(stage, {})}
                if stage is not None
                else dict(self.stacks)
            )
            for st, bucket in buckets.items():
                for key, cell in bucket.items():
                    if cell[idx]:
                        rows.append(
                            {
                                "stage": st,
                                "stack": list(key),
                                "wall_samples": cell[0],
                                "cpu_samples": cell[1],
                            }
                        )
        rows.sort(key=lambda r: -r[f"{which}_samples"])
        return rows[:n]

    def collapsed(
        self, stage: Optional[str] = None, which: str = "wall"
    ) -> str:
        """Collapsed-stack flamegraph text: `frame;frame;frame count`
        per line (flamegraph.pl / speedscope input). Stage-bucketed
        stacks are rooted under a `stage:<name>` frame so one
        flamegraph shows the sub-stage split at its base."""
        idx = 0 if which == "wall" else 1
        out: List[str] = []
        with self._lock:
            for st in sorted(self.stacks):
                if stage is not None and st != stage:
                    continue
                root = f"stage:{st or 'other'}"
                for key, cell in sorted(self.stacks[st].items()):
                    if cell[idx]:
                        out.append(
                            ";".join((root,) + key) + f" {cell[idx]}"
                        )
        return "\n".join(out)

    def status(self) -> Dict[str, Any]:
        with self._lock:
            per_stage = {
                st or "other": sum(c[0] for c in bucket.values())
                for st, bucket in sorted(self.stacks.items())
            }
            n_stacks = sum(len(b) for b in self.stacks.values())
        other = per_stage.get("other", 0)
        total = self.samples_total
        return {
            "running": self.running,
            "hz": self.hz,
            "samples_total": self.samples_total,
            "cpu_samples_total": self.cpu_samples_total,
            # fraction of samples landing in a NAMED stage bucket (the
            # attribution contract: `other` is what no mark covered)
            "attributed_ratio": (
                round((total - other) / total, 4) if total else 0.0
            ),
            "unique_stacks": n_stacks,
            "overflow_total": self.overflow_total,
            "missed_thread_total": self.missed_thread_total,
            "stage_samples": per_stage,
            "arms_total": self.arms_total,
            "started_at": self.started_at,
            "stopped_at": self.stopped_at,
        }

    def snapshot(self, top_n: int = 10) -> Dict[str, Any]:
        """Flight-bundle payload: status + top stacks per sub-stage
        (bounded — a bundle must stay a bundle, not a heap dump)."""
        with self._lock:
            stages = sorted(self.stacks)
        return {
            **self.status(),
            "top_stacks": {
                st or "other": self.top_stacks(stage=st, n=top_n)
                for st in stages
            },
        }

    def prometheus_lines(
        self, node_name: str = "emqx@127.0.0.1"
    ) -> List[str]:
        node = f'node="{node_name}"'
        st = self.status()
        lines = [
            "# TYPE emqx_xla_profiler_samples_total counter",
            f"emqx_xla_profiler_samples_total{{{node}}} "
            f"{st['samples_total']}",
            "# TYPE emqx_xla_profiler_cpu_samples_total counter",
            f"emqx_xla_profiler_cpu_samples_total{{{node}}} "
            f"{st['cpu_samples_total']}",
            "# TYPE emqx_xla_profiler_overflow_total counter",
            f"emqx_xla_profiler_overflow_total{{{node}}} "
            f"{st['overflow_total']}",
            "# TYPE emqx_xla_profiler_running gauge",
            f"emqx_xla_profiler_running{{{node}}} {int(st['running'])}",
            "# TYPE emqx_xla_profiler_unique_stacks gauge",
            f"emqx_xla_profiler_unique_stacks{{{node}}} "
            f"{st['unique_stacks']}",
        ]
        return lines


class LoopLagMonitor:
    """Sampled event-loop lag ticker: `asyncio.sleep(interval)` in a
    supervised task, overshoot lands in the
    `emqx_xla_loop_lag_seconds` histogram. Bounded recent-lag deque
    feeds the status/API view. Costs one timer per interval — nothing
    rides the publish path."""

    def __init__(self, interval_s: float = 0.1, max_recent: int = 64):
        self.interval_s = max(0.005, float(interval_s))
        self.hist = StreamingHistogram()
        self.recent: Deque[float] = deque(maxlen=max_recent)
        self.ticks_total = 0
        self._task: Optional[Any] = None

    @property
    def running(self) -> bool:
        t = self._task
        return t is not None and not t.done()

    def start(self) -> bool:
        """Idempotent; needs a running event loop (returns False when
        none is — callers retry from an async context)."""
        import asyncio

        if self.running:
            return False
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return False
        self._task = loop.create_task(self._tick())
        self._task.add_done_callback(_swallow_cancel)
        return True

    def stop(self) -> None:
        t = self._task
        if t is not None and not t.done():
            t.cancel()
        self._task = None

    async def _tick(self) -> None:
        import asyncio

        interval = self.interval_s
        clock = time.perf_counter
        while True:
            t0 = clock()
            await asyncio.sleep(interval)
            lag = max(0.0, clock() - t0 - interval)
            self.hist.observe(lag)
            self.recent.append(lag)
            self.ticks_total += 1

    def status(self) -> Dict[str, Any]:
        return {
            "running": self.running,
            "interval_s": self.interval_s,
            "ticks_total": self.ticks_total,
            "lag": self.hist.snapshot(),
            "recent_ms": [round(v * 1e3, 4) for v in self.recent],
        }

    def prometheus_lines(
        self, node_name: str = "emqx@127.0.0.1"
    ) -> List[str]:
        from .kernel_telemetry import render_histogram_lines

        lines: List[str] = []
        render_histogram_lines(
            lines, "emqx_xla_loop_lag_seconds", f'node="{node_name}"',
            self.hist,
        )
        return lines


def _swallow_cancel(task) -> None:
    """Done-callback for the supervised ticker task: a cancel at stop
    is the expected teardown; anything else is re-raised to the loop's
    exception handler by retrieving it."""
    if task.cancelled():
        return
    exc = task.exception()
    if exc is not None:
        raise exc
