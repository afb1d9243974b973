"""Box-throughput calibration for chaos/soak deadlines.

The SOAK_r19 red check (`node_evacuation.takeover_imported`) was a
measurement artifact, not a regression: the 10s settle window is a
wall-clock constant tuned on a fast dev box, while a 1-core CI box
finishes the identical takeover work in 11.4s. The same family of
flakes straddles the 30s per-test wall (`ds_replication` split-brain,
chaos drift/asymmetry) — the work always completes, the fixed budget
just doesn't fit the box.

`box_scale()` measures how much slower THIS box runs interpreter-bound
work than the reference box the budgets were tuned on: a ~20ms
pure-Python busy loop (the chaos settle paths are interpreter-bound,
so it is the right proxy), best-of-3 so a scheduler preemption cannot
masquerade as a slow box, cached per process, clamped to [1, 16] —
a budget never shrinks below its tuned wall value and never stretches
into uselessness. `ChaosEngine.scaled_timeout` and the tests' poll
deadlines multiply through it, the same discipline the replica_drift
repair budget already applies via its pair-count term.

Deliberately dependency-free (stdlib `time` only): tests/conftest.py
imports it at collection time, before jax or the broker tree loads.
"""

from __future__ import annotations

import time
from typing import Optional

# busy-loop iterations/second the reference box sustains (measured
# where the 10s/30s budgets were tuned); boxes at or above it get
# scale 1.0
NOMINAL_RATE = 6.0e6

# never stretch a budget past this — a box >16x slower than reference
# has problems no deadline policy fixes
MAX_SCALE = 16.0

_cached: Optional[float] = None


def _measure_rate() -> float:
    """Iterations/second of a ~20ms pure-Python arithmetic loop."""
    t0 = time.perf_counter()
    acc = 0
    n = 0
    while True:
        for i in range(10_000):
            acc = (acc * 1103515245 + i) & 0xFFFFFFFF
        n += 10_000
        dt = time.perf_counter() - t0
        if dt >= 0.02:
            return n / dt


def box_scale() -> float:
    """Deadline multiplier for this box, >= 1.0, cached per process.
    1.0 on a reference-speed (or faster) box; proportionally larger on
    slower ones, clamped to MAX_SCALE."""
    global _cached
    if _cached is None:
        rate = max(_measure_rate() for _ in range(3))
        _cached = min(MAX_SCALE, max(1.0, NOMINAL_RATE / rate))
    return _cached


def scaled(base: float) -> float:
    """`base` tuned-wall seconds stretched by the box scale."""
    return base * box_scale()
