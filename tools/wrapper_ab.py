#!/usr/bin/env python3
"""Time two trees' kernel wrappers in one process, in turns, on one card.

    python3 tools/wrapper_ab.py PARENT_ROOT [--rounds N]

PARENT_ROOT is the root of another checkout of this repository (for
example `git archive <commit> | tar -x -C build/ab/parent`). Its
`emqx_tpu_torch` package is loaded beside this tree's under the name
`emqx_tpu_torch_parent` (the port imports itself only relatively) and
builds its kernels into its own `build/`. Both trees then time the same
calls on the same inputs, parent, this tree, this tree, parent, N
rounds: K8 (`probe_retained`) at B=8 and B=4096 over a 2^19-bucket table
about half full, K14 (`_combine_launch`) on phase 9's synthetic rows at
max_hits 2,048 and 4,096, and as controls K12 (`add_one` on a scalar)
and K6 (`scatter_segs`, one batch of 1,024 ids). Each reading is
`chip_smoke.run_ms`: the card's time a call (`device_ms`) and the
host's enqueue time a call (`enqueue_ms`). One process holds both
trees, so the host's speed, which moves between processes, is the same
for both. Prints one line a case with every reading and the medians,
then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def load_tree(root: Path, name: str):
    """`root`'s emqx_tpu_torch package as module `name`."""
    pkg = root / "emqx_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent_root", type=Path)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

    import importlib

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("wrapper_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C

    trees = {}
    for tag, name, root in (("parent", "emqx_tpu_torch_parent", args.parent_root.resolve()),
                            ("this", "emqx_tpu_torch", ROOT)):
        if tag == "parent":
            load_tree(root, name)
        mods = {m: importlib.import_module(f"{name}.{m}") for m in (
            "ops._build", "ops.retained", "ops.transfer", "ops.fanout",
            "ops.hash_index", "parallel.sharded_match", "convert", "broker.pubsub")}
        mods["ops._build"].build_all()
        trees[tag] = mods

    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)
    nb = 1 << 19
    live = rng.random(nb * 4) < 0.49
    fp = np.where(live, rng.integers(1 << 24, 1 << 32, nb * 4), 0).astype(np.uint32)
    bucket = np.where(live, rng.integers(0, 1 << 20, nb * 4), -1).astype(np.int32)
    H = trees["this"]["ops.hash_index"]
    slots = H.SlotArrays(fp, bucket, np.zeros(nb, np.uint32))
    H._pack_probe(slots)
    tabs = trees["this"]["convert"].retained_state_from_numpy(slots.probe, fp, bucket, dev)
    lv = np.flatnonzero(live)

    cases = {}
    for b in (8, 4096):
        s = rng.choice(lv, b)
        f = fp[s].copy()
        f[::8] = rng.integers(0, 1 << 32, len(f[::8]))
        q = C.k8_inputs((s // 4).astype(np.uint32), f, np.arange(b) < b - 1, dev)
        cases[f"K8 B={b}"] = {
            tag: (lambda m=m, q=q: m["ops.retained"].probe_retained(*tabs, *q))
            for tag, m in trees.items()}
        want = trees["this"]["ops.retained"].probe_retained_ref(*tabs, *q)
        for fn in cases[f"K8 B={b}"].values():
            C.max_abs_err(fn(), want)
    for mh in (2048, 4096):
        a, bb, c, m_ = C.k14_case("scattered", mh, dev, rng)
        cases[f"K14 max_hits={mh}"] = {
            tag: (lambda m=m, a=a, bb=bb, c=c, m_=m_:
                  m["parallel.sharded_match"]._combine_launch(a, bb, c, m_))
            for tag, m in trees.items()}
        want = trees["this"]["parallel.sharded_match"].combine_pairs_ref(a, bb, c, m_)
        for fn in cases[f"K14 max_hits={mh}"].values():
            C.max_abs_err(fn(), want)
    x = torch.tensor(0.5, dtype=torch.float32, device=dev)
    cases["K12 scalar"] = {tag: (lambda m=m: m["ops.transfer"].add_one(x))
                           for tag, m in trees.items()}
    n = 1 << 16
    seg_off = torch.zeros(n, dtype=torch.int32, device=dev)
    seg_len = torch.zeros(n, dtype=torch.int32, device=dev)
    idx = torch.from_numpy(rng.integers(0, n, (1, 1024)).astype(np.int32)).to(dev)
    val = torch.ones((1, 1024), dtype=torch.int32, device=dev)
    cases["K6 1,024 ids"] = {
        tag: (lambda m=m: m["ops.fanout"].scatter_segs(seg_off, seg_len, idx, val, val))
        for tag, m in trees.items()}

    for name, fns in cases.items():
        got = {"parent": [], "this": []}
        for _ in range(args.rounds):
            for tag in ("parent", "this", "this", "parent"):
                got[tag].append(C.run_ms(fns[tag]))
        med = {tag: (statistics.median(d for d, _ in v), statistics.median(e for _, e in v))
               for tag, v in got.items()}
        print(f"{name}: device_ms parent {med['parent'][0]:.6f} this {med['this'][0]:.6f}; "
              f"enqueue_ms parent {med['parent'][1]:.6f} this {med['this'][1]:.6f}; "
              f"readings (device_ms, enqueue_ms) parent "
              f"{[(round(d, 6), round(e, 6)) for d, e in got['parent']]} this "
              f"{[(round(d, 6), round(e, 6)) for d, e in got['this']]}", flush=True)
    print(C.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
