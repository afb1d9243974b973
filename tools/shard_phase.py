"""Run chip_smoke.py's phase 16 (the mesh chaos scenarios: chip loss,
chip flap, reshard churn on a (1, 8) mesh) alone on the card, at session
counts of one's choosing: how its cut is sized.

    python3 tools/shard_phase.py [--mesh-half] [--sessions N ...] [--timeout S]

Builds the native host cores and every kernel (as phase 2 does). With
--mesh-half it first runs phase 10's mesh half ((e) the whole-device
breaker and (f) the shard breaker) on a broker built as phase 9 builds
its (2, 4) mesh broker, at full width (`chip_smoke.failure_domain_phase`
with no single-device broker). Then it runs `chip_smoke.shard_phase`
once for each --sessions count (default phase 16's own,
`chip_smoke.P16_SESSIONS`), each held to --timeout seconds (default
phase 16's limit, `chip_smoke.P16_LIMIT_S`). Prints each run's figure
lines and seconds; a run that fails or runs out of time is reported and
the next one runs. Exit 1 if any failed.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sessions", action="append", type=int, default=[])
    ap.add_argument("--timeout", type=float, default=cs.P16_LIMIT_S)
    ap.add_argument("--mesh-half", action="store_true",
                    help="run phase 10's (e) and (f) on a (2, 4) mesh broker first")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("shard_phase: no CUDA device is available", file=sys.stderr)
        return 2
    from emqx_tpu_torch import native
    from emqx_tpu_torch.broker import pubsub as _pubsub  # noqa: F401  registers every kernel
    from emqx_tpu_torch.ops import _build

    t0 = time.perf_counter()
    native.build_all()
    _build.build_all()
    card = cs.card_line()
    print(f"builds {time.perf_counter() - t0:.3f} s [{card}]", flush=True)
    bad = 0
    if args.mesh_half:
        import gc

        import numpy as np

        from emqx_tpu_torch.broker.pubsub import Broker

        t0 = time.perf_counter()
        rng = np.random.default_rng(3)
        broker = Broker(max_levels=16, mesh=cs.mesh_of(cs.MESH))
        skel, exact, _host_s = cs.add_route_set(broker.router, rng)
        broker.router.device_table.sync()
        print(f"mesh broker {broker.router.stats()} in {time.perf_counter() - t0:.3f} s",
              flush=True)
        try:
            cs.failure_domain_phase(None, (broker, skel, exact), np.random.default_rng(4),
                                    0, card)
        except AssertionError as exc:
            bad += 1
            print(f"phase 10's mesh half failed: {str(exc)[:4000]}", flush=True)
        del broker
        gc.collect()
        torch.cuda.empty_cache()
    for n in args.sessions or [cs.P16_SESSIONS]:
        print(f"shard soak sessions {n}", flush=True)
        t0 = time.perf_counter()
        try:
            cs.shard_phase(card, sessions=n, limit_s=args.timeout)
        except AssertionError as exc:
            bad += 1
            print(f"failed after {time.perf_counter() - t0:.3f} s: {str(exc)[:4000]}",
                  flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
