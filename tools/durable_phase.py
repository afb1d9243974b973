"""Run chip_smoke.py's phase 13 (the durable tier) alone on the card, at
sizes of one's choosing: how phase 13's cuts are sized.

    python3 tools/durable_phase.py [SIZES_JSON ...] [--seed N] [--timeout S]
                                   [--fsync-probe N] [--profile OUT_DIR]

Builds the native host cores and every kernel (as phase 2 does), then,
for each SIZES_JSON in turn (keys of `chip_smoke.P13_SIZES` to override,
e.g. '{"filters": 512, "durable": 8192}'; none: the committed sizes),
runs the card's and the oracle's children (`chip_smoke.durable_children`,
killed at --timeout seconds) and `chip_smoke.durable_verdict` on their
results, printing the phase's figure lines and its seconds. A size that
fails or runs out of time is reported and the next one runs. Exit 1 if
any failed.

--fsync-probe N first times N writes of 4 KiB, each followed by fsync,
in the directory the children write to (the disk the DS shards' WAL
commits go to), and prints their p50, p99 and total. --profile runs
both children under cProfile, writes each size's top functions to
OUT_DIR/phase13-<i>-<role>.txt and prints the card child's ten largest
by own time.
"""

import argparse
import json
import os
import pstats
import shutil
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def fsync_probe(root, n, card):
    """Times n writes of 4 KiB, each followed by fsync, in root."""
    path = os.path.join(root, "fsync_probe")
    block = os.urandom(4096)
    lat = []
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        for _ in range(n):
            t = time.perf_counter()
            os.write(fd, block)
            os.fsync(fd)
            lat.append((time.perf_counter() - t) * 1e3)
    finally:
        os.close(fd)
        os.unlink(path)
    lat.sort()
    print(f"fsync probe: {n} writes of 4 KiB + fsync, p50 {statistics.median(lat):.3f} ms, "
          f"p99 {lat[min(n - 1, int(n * 0.99))]:.3f} ms, total {sum(lat) / 1e3:.3f} s "
          f"[{card}]", flush=True)


def report_profiles(root, out_dir, i):
    """Each child's cProfile, its top 40 by own and by cumulative time,
    into out_dir; the card child's ten largest by own time printed."""
    os.makedirs(out_dir, exist_ok=True)
    for role in ("card", "oracle"):
        prof = os.path.join(root, f"{role}.prof")
        if not os.path.exists(prof):
            print(f"profile {role}: none (the child did not finish)", flush=True)
            continue
        with open(os.path.join(out_dir, f"phase13-{i}-{role}.txt"), "w") as f:
            for key in ("tottime", "cumulative"):
                pstats.Stats(prof, stream=f).sort_stats(key).print_stats(40)
        if role == "card":
            st = pstats.Stats(prof)
            top = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:10]
            for (file, line, fn), (_cc, nc, tt, ct, _callers) in top:
                print(f"profile card: {tt:.3f} s own, {ct:.3f} s cumulative, {nc} calls: "
                      f"{os.path.basename(file)}:{line} {fn}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sizes", nargs="*")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--timeout", type=float, default=cs.P13_LIMIT_S)
    ap.add_argument("--fsync-probe", type=int, default=0)
    ap.add_argument("--profile", default=None)
    args = ap.parse_args()
    from emqx_tpu_torch import native
    from emqx_tpu_torch.broker import pubsub as _pubsub  # noqa: F401  registers every kernel
    from emqx_tpu_torch.ops import _build

    t0 = time.perf_counter()
    native.build_all()
    _build.build_all()
    card = cs.card_line()
    print(f"builds {time.perf_counter() - t0:.3f} s [{card}]", flush=True)
    bad = 0
    for i, spec in enumerate(args.sizes or ["{}"]):
        sz = dict(cs.P13_SIZES, **json.loads(spec))
        print(f"sizes {json.dumps(sz)}", flush=True)
        root = tempfile.mkdtemp(prefix="durable_phase_")
        if args.fsync_probe:
            fsync_probe(root, args.fsync_probe, card)
        t0 = time.perf_counter()
        try:
            dev_r, ora_r = cs.durable_children(root, args.seed, sz, args.timeout,
                                               profile=bool(args.profile))
            cs.durable_verdict(dev_r, ora_r, sz, card)
            st = dev_r["stats"]
            print(f"phase s {time.perf_counter() - t0:.3f} (card {dev_r['s']:.3f}: (a) "
                  f"{st['a_s']:.3f}, (c) {st['c_s']:.3f}, (d) {st['d_s']:.3f}; oracle "
                  f"{ora_r['s']:.3f}) [{card}]", flush=True)
        except AssertionError as exc:
            bad += 1
            print(f"failed after {time.perf_counter() - t0:.3f} s: {str(exc)[:4000]}",
                  flush=True)
        finally:
            if args.profile:
                report_profiles(root, args.profile, i)
            shutil.rmtree(root, ignore_errors=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
