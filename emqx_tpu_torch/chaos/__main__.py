"""Standalone chaos soak driver of the port.

    python -m emqx_tpu_torch.chaos --sessions 1000000 --out /tmp/soak.json

Builds one broker on the CUDA card (`--device cpu` for the plain
versions), sustains the Zipf publish storm, runs the scenario catalog
(its mesh scenarios are skipped: the broker has no mesh), asserts every
contract, and writes the soak row to
`--out` when one is given (there is no default, so no run writes over
a file of the repository). Exit code 1 when any contract is violated,
2 when a scenario or option needs what this entry point does not build
(a mesh scenario: its broker has no mesh; `ChaosEngine.standalone(mesh=)`
runs them, as tools/shard_phase.py does on the card) or what the port
does not have yet (the clustered soak, a cluster scenario: ROADMAP
Queue 1 item 8b).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import sys

from .engine import ContractViolation, run_soak
from .scenarios import CATALOG, CLUSTER_SCENARIOS, MESH_SCENARIOS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m emqx_tpu_torch.chaos",
        description="million-session soak + chaos scenarios, "
        "judged by the sentinel",
    )
    ap.add_argument("--sessions", type=int, default=1_000_000)
    ap.add_argument("--victim-sessions", type=int, default=0,
                    help="the clustered soak's victim fleet (not ported: "
                    "anything above 0 is refused)")
    ap.add_argument("--groups", type=int, default=None,
                    help="distinct subscription groups (default n/5)")
    ap.add_argument("--zipf", type=float, default=1.2, dest="zipf_s")
    ap.add_argument("--sample-n", type=int, default=64,
                    help="sentinel audit sampling (1/N publishes)")
    ap.add_argument("--baseline", type=float, default=20.0,
                    help="clean storm seconds before the first fault")
    ap.add_argument("--scenario", action="append",
                    choices=CATALOG + list(CLUSTER_SCENARIOS),
                    help="run only these scenarios (repeatable)")
    ap.add_argument("--out", default=None,
                    help="write the soak row (JSON) to this path")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device: the CUDA card by default, 'cpu' "
                    "for the plain PyTorch versions")
    ap.add_argument("--lenient", action="store_true",
                    help="report contract violations without failing")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )

    def progress(msg: str) -> None:
        print(f"[chaos] {msg}", file=sys.stderr, flush=True)

    mesh_asked = [n for n in args.scenario or () if n in MESH_SCENARIOS]
    if mesh_asked:
        print(f"[chaos] NEEDS A MESH: {mesh_asked} run on "
              "ChaosEngine.standalone(mesh=...); this entry point's broker has none",
              file=sys.stderr)
        return 2

    try:
        row = asyncio.run(
            run_soak(
                sessions=args.sessions,
                victim_sessions=args.victim_sessions,
                groups=args.groups,
                zipf_s=args.zipf_s,
                sample_n=args.sample_n,
                baseline_s=args.baseline,
                scenarios=args.scenario,
                report_path=args.out,
                data_dir=args.data_dir,
                progress=progress,
                strict=not args.lenient,
                device=args.device,
            )
        )
    except NotImplementedError as e:
        print(f"[chaos] NOT PORTED: {e}", file=sys.stderr)
        return 2
    except ContractViolation as e:
        print(f"[chaos] CONTRACT VIOLATION: {e}", file=sys.stderr)
        return 1
    ok = row["contracts_ok"]
    progress(
        f"{'PASS' if ok else 'FAIL'}: {row['sessions']} sessions, "
        f"{row['storm']['sustained_pub_per_sec']} pub/s sustained, "
        f"p99 {row['publish_p99_ms_incl_chaos']}ms, "
        f"faults {row['divergences_detected']}/"
        f"{row['divergences_injected']} detected, "
        f"{row['silent_divergences']} silent"
    )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
