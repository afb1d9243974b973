"""Run chip_smoke.py's phase 14 (the booted node) and phase 15 (the chaos
soak) alone on the card, at sizes of one's choosing: how their cuts are
sized.

    python3 tools/boot_phase.py [--boot SIZES_JSON ...] [--soak N ...]
                                [--seed N] [--timeout S]

Builds the native host cores and every kernel (as phase 2 does), then
runs phase 14 once for each --boot SIZES_JSON (keys of
`chip_smoke.P14_SIZES` to override, e.g. '{"tcp": 128}'; '{}' for the
committed sizes): the card's and the CPU run's children
(`chip_smoke.durable_children` with `boot_child`, killed at --timeout
seconds) and `chip_smoke.boot_verdict`; then phase 15
(`chip_smoke.soak_phase`, limit --timeout) once for each --soak
session count. Prints each run's figure lines and seconds; a run that
fails or runs out of time is reported and the next one runs. Exit 1
if any failed.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--boot", action="append", default=[])
    ap.add_argument("--soak", action="append", type=int, default=[])
    ap.add_argument("--seed", type=int, default=8)
    ap.add_argument("--timeout", type=float, required=True)
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
    for spec in args.boot:
        sz = dict(cs.P14_SIZES, **json.loads(spec))
        print(f"boot sizes {json.dumps(sz)}", flush=True)
        root = tempfile.mkdtemp(prefix="boot_phase_")
        t0 = time.perf_counter()
        try:
            dev_r, ora_r = cs.durable_children(root, args.seed, sz, args.timeout,
                                               entry="boot_child", phase=14)
            cs.boot_verdict(dev_r, ora_r, sz, card)
            print(f"phase 14 s {time.perf_counter() - t0:.3f} (card {dev_r['s']:.3f}, "
                  f"CPU run {ora_r['s']:.3f}) [{card}]", flush=True)
        except AssertionError as exc:
            bad += 1
            print(f"failed after {time.perf_counter() - t0:.3f} s: {str(exc)[:4000]}",
                  flush=True)
        finally:
            shutil.rmtree(root, ignore_errors=True)
    for n in args.soak:
        print(f"soak sessions {n}", flush=True)
        t0 = time.perf_counter()
        try:
            cs.soak_phase(card, sessions=n, limit_s=args.timeout)
        except AssertionError as exc:
            bad += 1
            print(f"failed after {time.perf_counter() - t0:.3f} s: {str(exc)[:4000]}",
                  flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
