#!/usr/bin/env python3
"""Show the garbage collections that land inside phase 5's timed serve.

    python3 tools/gc_probe.py [ROOT]

Runs `chip_smoke.py`'s `main()` from ROOT (this checkout by default; an
unpacked parent works too) on the card with a `gc.callbacks` hook that
notes every collection longer than 50 ms, and stops right after phase
5's serve: prints its topics/s, its window on the host clock, the
collections inside that window (generation, seconds, end time) and all
collections before it. Phase 5's rate is 32,768 topics over the
begin+finish wall, so one full collection over the million-route object
graph inside it moves the rate several-fold.
"""

import gc
import os
import sys
import time

root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, root)
os.chdir(root)
import chip_smoke as C  # noqa: E402

log, t = [], {}


def cb(phase, info):
    if phase == "start":
        t["s"] = time.perf_counter()
    else:
        d = time.perf_counter() - t["s"]
        if d > 0.05:
            log.append((info["generation"], round(d, 3), round(time.perf_counter(), 3)))


gc.callbacks.append(cb)
real_serve = C.serve


def serve(*a, **k):
    t0 = time.perf_counter()
    n0 = len(log)
    r = real_serve(*a, **k)
    print(f"PROBE {root}: serve topics/s {r[0]:.1f} window [{t0:.3f}, {time.perf_counter():.3f}] "
          f"collections >50 ms in it {log[n0:]}; all so far {log}", flush=True)
    sys.exit(0)


C.serve = serve
C.main([])
