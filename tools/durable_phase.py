"""Run chip_smoke.py's phase 13 (the durable tier) alone on the card, at
sizes of one's choosing: how phase 13's cuts are sized.

    python3 tools/durable_phase.py [SIZES_JSON ...] [--seed N] [--timeout S]

Builds the native host cores and every kernel (as phase 2 does), then,
for each SIZES_JSON in turn (keys of `chip_smoke.P13_SIZES` to override,
e.g. '{"filters": 512, "durable": 8192}'; none: the committed sizes),
runs the card's and the oracle's children (`chip_smoke.durable_children`,
killed at --timeout seconds) and `chip_smoke.durable_verdict` on their
results, printing the phase's figure lines and its seconds. A size that
fails or runs out of time is reported and the next one runs. Exit 1 if
any failed.
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
    ap.add_argument("sizes", nargs="*")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--timeout", type=float, default=cs.P13_LIMIT_S)
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
    for spec in args.sizes or ["{}"]:
        sz = dict(cs.P13_SIZES, **json.loads(spec))
        print(f"sizes {json.dumps(sz)}", flush=True)
        root = tempfile.mkdtemp(prefix="durable_phase_")
        t0 = time.perf_counter()
        try:
            dev_r, ora_r = cs.durable_children(root, args.seed, sz, args.timeout)
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
            shutil.rmtree(root, ignore_errors=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
