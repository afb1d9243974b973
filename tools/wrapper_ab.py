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
max_hits 2,048 and 4,096, K12 (`add_one` on a scalar, one launch's
floor), K6 (`scatter_segs`, one batch of 1,024 ids), the fanout
mirror's delta sync on tables of phase 7's size (SYNC_TABLES): the
kernels of one sync (the fused `fanout_sync` where a tree has it, else
`scatter_segs` + `scatter_edges` on the pow2-padded batches its sync
launched) at phase 7's churn and route-churn deltas and at a full-pool
delta, and the whole `FanoutDeviceState.sync()` (staging, copies and
launches) at the two churn deltas, the same ids dirtied again before
every call; and the router's table delta sync on each tree's own
Router holding phase 5's route set (`chip_smoke.add_route_set`, the
same seed in both): the kernels of one sync (the fused `table_sync`
where a tree has it, else `scatter_rows` + `scatter_slots` on the
pow2-padded batches its sync launched) at one and two rounds of phase
5's churn (`chip_smoke.churn`), and the whole `DeviceTable.sync()`
(staging, copies, the residual mask and launches) at one round's
delta, the same rows and slots dirtied again (and the mask marked
dirty, as every phase 5 sync finds it) before every call; and the
mesh's table delta sync on each tree's own Router(mesh=(2, 4)), all
eight shards on the card, holding phase 9's route set (the same seed in
both): the kernels of one sync (the fused `mesh_table_sync` on one
staged buffer where a tree has it, else the fused K18 `mesh_sync` on the
pow2-padded batches its sync launched) at one round of phase 5's churn,
and the whole `ShardedDeviceTable.sync()` at that delta, the same rows
and slots dirtied again (and the mask marked dirty) before every call;
and the dense forms at phase 9's full width (FORMS_CASES: one table of
2,097,152 rows holding phase 9's route set, built once, and 1,024 of
its topics, both trees fed the same tensors): K10 `match_packed`, K11
`match_counts`, and K13's packed form and counts on each tree's own
(2, 4) mesh of the card (each wrapper as its tree has it: a parent's
zero fills, separate or in its C entry, are in its time), and K9 at 64
topics; and beside them the mesh combine at phase 9's block capacity
(PROBE_MH): K14 (`_combine_launch`) on `chip_smoke.k14_case`'s
scattered rows and K15 (`make_combine_probe_kernel` on each tree's own
(2, 4) mesh of the card, salt 12345). `--only forms` times the dense
forms and the combine alone.
Each reading
is `chip_smoke.run_ms`: the card's time a call (`device_ms`) and the
host's enqueue time a call (`enqueue_ms`). A whole `sync()` copies
from pageable host memory, and such a copy can wait for the stream, so
under run_ms's hold its enqueue time takes in the held spin and its
device time misses it (both wrong); its host time is read with the
stream idle instead (`host_ms`: the host clock over calls back to
back, no hold), and its card time by torch.profiler (`card_ms`: the
union of its kernels' and copies' device intervals, over the calls).
One process holds both
trees, so the host's speed, which moves between processes, is the same
for both. Prints one line a case with every reading and the medians,
then the card's name and power limit.

PARENT_ROOT may also be a variant of this tree (a constant changed in
one of its sources): `git archive` the tree into `build/var/NAME`, edit
it there, and pass that root.
"""

from __future__ import annotations

import argparse
import importlib.util
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# phase 7's fanout tables (rows, edges), and its delta syncs' sizes
# (rows, edges): the set-up churn's, and a sync after route churn
SYNC_TABLES = (1 << 21, 1 << 19)
SYNC_DELTAS = {"churn": (2, 32), "route churn": (1000, 1000)}
# rounds of phase 5's churn in a table delta (one is what each of its
# syncs applies)
TABLE_ROUNDS = (1, 2)
# phase 9's block capacity: the width of the mesh combine (K14, K15)
PROBE_MH = 2048


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
    ap.add_argument("--only", choices=("forms",), help="time only these cases")
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
            "ops.hash_index", "ops.table", "parallel.sharded_match", "convert",
            "models.router", "broker.pubsub", "parallel.mesh", "ops.match")}
        mods["ops._build"].build_all()
        trees[tag] = mods

    dev = torch.device("cuda", torch.cuda.current_device())
    cases = {}
    if args.only == "forms":
        cases.update(forms_cases(trees, dev, C))
        time_cases(cases, set(), args.rounds, C)
        return 0
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

    cases.update(sync_cases(trees, dev, rng, C))
    profiled = set()
    for gen in (table_cases, mesh_cases):
        for name, fns, whole in gen(trees, dev, C):
            cases[name] = fns
            if whole:
                profiled.add(name)
    cases.update(forms_cases(trees, dev, C))
    time_cases(cases, profiled, args.rounds, C)
    return 0


def time_cases(cases, profiled, rounds, C):
    """Time every case's two trees in turns (module docstring) and print
    one line a case, then the card's name and power limit."""
    for name, fns in cases.items():
        got = {"parent": [], "this": []}
        card = {"parent": [], "this": []}
        host = {"parent": [], "this": []}
        for _ in range(rounds):
            for tag in ("parent", "this", "this", "parent"):
                got[tag].append(C.run_ms(fns[tag]))
                if name in profiled:
                    card[tag].append(card_ms(fns[tag], C))
                    host[tag].append(host_ms(fns[tag]))
        med = {tag: (statistics.median(d for d, _ in v), statistics.median(e for _, e in v))
               for tag, v in got.items()}
        extra = ""
        if name in profiled:
            extra = "".join(
                f"; {key} parent {statistics.median(v['parent']):.6f} this "
                f"{statistics.median(v['this']):.6f}, readings parent "
                f"{[round(x, 6) for x in v['parent']]} this {[round(x, 6) for x in v['this']]}"
                for key, v in (("host_ms", host), ("card_ms", card)))
        print(f"{name}: device_ms parent {med['parent'][0]:.6f} this {med['this'][0]:.6f}; "
              f"enqueue_ms parent {med['parent'][1]:.6f} this {med['this'][1]:.6f}; "
              f"readings (device_ms, enqueue_ms) parent "
              f"{[(round(d, 6), round(e, 6)) for d, e in got['parent']]} this "
              f"{[(round(d, 6), round(e, 6)) for d, e in got['this']]}{extra}", flush=True)
    print(C.card_line(), flush=True)


def host_ms(fn, calls: int = 50) -> float:
    """The host's time a call of `fn` with the stream idle at the start:
    the host clock over `calls` calls back to back, over `calls` (a
    warm-up call and a synchronize first)."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    out = 1e3 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return out


def card_ms(fn, C, calls: int = 20) -> float:
    """The card's time a call of `fn` by torch.profiler: the union of the
    device intervals (kernels and copies) over `calls` calls, over
    `calls`; 0.0 when the trace holds no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return 1e3 * C.device_seconds(prof) / calls


def table_cases(trees, dev, C):
    """The router's table delta sync (module docstring): yields (name,
    {tag: fn}, whether the case is a whole sync()), each fn checked
    against the host arrays in both trees first."""
    import numpy as np
    import torch

    built = {}
    for tag, m in trees.items():
        R = m["models.router"]
        rng = np.random.default_rng(0)
        router = R.Router(max_levels=16, device=dev)
        skel, _exact, _s = C.add_route_set(router, rng)
        dt, t, ix = router.device_table, router.table, router.index
        dt.sync()
        kernels = {}
        for k in range(max(TABLE_ROUNDS)):
            C.churn(router, skel, rng)
            if k + 1 in TABLE_ROUNDS:
                kernels[k + 1] = table_kernels(R, m, dt, t, ix, dev, C)
        first = kernels[1][1]
        dt.sync()
        r_list, s_list = first

        def whole(dt=dt, t=t, ix=ix, r_list=r_list, s_list=s_list):
            t.dirty.extend(r_list)
            ix.dirty_slots.extend(s_list)
            ix.residual_dirty = True
            dt.sync()

        whole()
        torch.cuda.synchronize()
        held_tables(dt, t, ix, C)
        built[tag] = (kernels, whole, len(r_list), len(s_list))
    for n in TABLE_ROUNDS:
        n_r, n_s = (len(x) for x in built["this"][0][n][1])
        yield (f"K3+K4 kernels, {n} churn round(s) ({n_r} rows, {n_s} slots)",
               {tag: b[0][n][0] for tag, b in built.items()}, False)
    _k, _w, n_r, n_s = built["this"]
    yield (f"DeviceTable.sync(), one churn round ({n_r} rows, {n_s} slots)",
           {tag: b[1] for tag, b in built.items()}, True)


def table_kernels(R, m, dt, t, ix, dev, C):
    """(fn, (row ids, slot ids)): the kernels of the pending delta's sync
    on clones of the device tables, checked against the host arrays."""
    import numpy as np
    import torch

    rows = np.unique(np.asarray(t.dirty, np.int32))
    sids = np.unique(np.asarray(ix.dirty_slots, np.int32))
    host, hslots = t.snapshot(), ix.slots
    dev_t = type(dt.filters())(*(x.clone() for x in dt.filters()))
    slots = type(dt.hash_state()[1])(*(x.clone() for x in dt.hash_state()[1]))
    residual = dt._dev_residual.clone()
    if hasattr(R, "table_sync"):
        staged = R.stage_table_delta(host, rows, hslots, sids, ix.residual_rows, dev)

        def fn():
            R.table_sync(dev_t, slots, residual, staged, len(rows), len(sids))
    else:
        pad = m["ops.table"].pad_pow2_batches
        idx, sidx = pad(rows, R.SYNC_BATCH_SIZE), pad(sids, R.SYNC_BATCH_SIZE)
        cols = [torch.from_numpy(np.ascontiguousarray(c)).to(dev) for c in (
            idx, host.words[idx], host.prefix_len[idx], host.has_hash[idx],
            host.root_wild[idx], host.active[idx])]
        scols = [torch.from_numpy(np.ascontiguousarray(c).view(np.int32)).to(dev)
                 for c in (sidx, hslots.fp[sidx], hslots.bucket[sidx],
                           hslots.probe[sidx // 4])]
        scols[1], scols[3] = scols[1].view(torch.uint32), scols[3].view(torch.uint32)

        def fn():
            R.scatter_rows(dev_t, *cols)
            R.scatter_slots(slots, *scols)
    fn()
    torch.cuda.synchronize()
    ri = torch.from_numpy(rows.astype(np.int64)).to(dev)
    si = torch.from_numpy(sids.astype(np.int64)).to(dev)
    for g, h in zip(dev_t, host):
        C.max_abs_err([g[ri]], [torch.from_numpy(np.ascontiguousarray(h[rows])).to(dev)])
    for g, h, sel, ids in zip(slots, hslots, (si, si, si // 4), (sids, sids, sids // 4)):
        C.max_abs_err([g.view(torch.int32)[sel]],
                      [torch.from_numpy(np.ascontiguousarray(h[ids]).view(np.int32)).to(dev)])
    return fn, (rows.tolist(), sids.tolist())


def held_tables(dt, t, ix, C):
    """The device table, slot arrays and residual mask equal the host's."""
    import numpy as np
    import torch

    for g, h in zip(dt.filters(), t.snapshot()):
        C.max_abs_err([g], [torch.from_numpy(h).to(g.device)])
    for g, h in zip(dt.hash_state()[1], ix.slots):
        C.max_abs_err([g.view(torch.int32)], [torch.from_numpy(h.view(np.int32)).to(g.device)])
    mask = np.zeros(t.capacity, bool)
    mask[list(ix.residual_rows)] = True
    C.max_abs_err([dt._dev_residual], [torch.from_numpy(mask).to(dt._dev_residual.device)])


def mesh_cases(trees, dev, C):
    """The mesh's table delta sync (module docstring): yields (name,
    {tag: fn}, whether the case is a whole sync()), each fn checked
    against the host arrays in both trees first."""
    import numpy as np
    import torch

    built = {}
    for tag, m in trees.items():
        rng = np.random.default_rng(3)
        mesh = m["parallel.mesh"].make_mesh(2, 4, devices=[dev] * 8)
        router = m["models.router"].Router(max_levels=16, mesh=mesh)
        skel, _exact, _s = C.add_route_set(router, rng)
        dt, t, ix = router.device_table, router.table, router.index
        dt.sync()
        C.churn(router, skel, rng)
        rows = np.unique(np.asarray(t.dirty, np.int32))
        sids = np.unique(np.asarray(ix.dirty_slots, np.int32))
        kernels = mesh_kernels(m, dt, t, ix, rows, sids, C)
        dt.sync()
        r_list, s_list = rows.tolist(), sids.tolist()

        def whole(dt=dt, t=t, ix=ix, r_list=r_list, s_list=s_list):
            t.dirty.extend(r_list)
            ix.dirty_slots.extend(s_list)
            ix.residual_dirty = True
            dt.sync()

        whole()
        torch.cuda.synchronize()
        held_mesh(dt, t, ix, C)
        built[tag] = (kernels, whole, len(rows), len(sids))
    _k, _w, n_r, n_s = built["this"]
    yield (f"K13+K18 mesh kernels, one churn round ({n_r} rows, {n_s} slots)",
           {tag: b[0] for tag, b in built.items()}, False)
    yield (f"ShardedDeviceTable.sync(), one churn round ({n_r} rows, {n_s} slots)",
           {tag: b[1] for tag, b in built.items()}, True)


def mesh_kernels(m, dt, t, ix, rows, sids, C):
    """The kernels of the pending delta's mesh sync on clones of the one
    group's tables, checked against the host arrays."""
    import importlib

    import numpy as np
    import torch

    S = m["parallel.sharded_match"]
    mesh = dt.mesh
    host, hslots = t.snapshot(), ix.slots
    dev_t = tuple(type(d)(*(x.clone() for x in d)) for d in dt._dev)
    slots = tuple(type(s)(*(x.clone() for x in s)) for s in dt._dev_slots)
    residual = tuple(x.clone() for x in dt._dev_residual)
    if hasattr(S, "mesh_table_sync"):
        pkg = S.__name__.rsplit(".", 2)[0]
        D = importlib.import_module(f"{pkg}.ops.delta")
        staged = dt._stage(D.pack_table_delta(host, rows, hslots, sids, ix.residual_rows))

        def fn():
            S.mesh_table_sync(mesh, dev_t, slots, residual, staged, len(rows), len(sids))
    else:
        pad = m["ops.table"].pad_pow2_batches
        idx, sidx = pad(rows, dt.DELTA_BATCH), pad(sids, dt.DELTA_BATCH)
        cols = [dt._stage(c) for c in (idx, host.words[idx], host.prefix_len[idx],
                                       host.has_hash[idx], host.root_wild[idx],
                                       host.active[idx], sidx, hslots.fp[sidx],
                                       hslots.bucket[sidx], hslots.probe[sidx // 4])]
        fused = S.make_mesh_sync_kernel(mesh)
        cs = tuple(tuple(s[k] for s in slots) for k in range(3))

        def fn():
            fused(dev_t, *cs, *cols)
    fn()
    torch.cuda.synchronize()
    dev = dev_t[0].words.device
    ri = torch.from_numpy(rows.astype(np.int64)).to(dev)
    si = torch.from_numpy(sids.astype(np.int64)).to(dev)
    for g, h in zip(dev_t[0], host):
        C.max_abs_err([g[ri]], [torch.from_numpy(np.ascontiguousarray(h[rows])).to(dev)])
    for g, h, sel, ids in zip(slots[0], hslots, (si, si, si // 4), (sids, sids, sids // 4)):
        C.max_abs_err([g.view(torch.int32)[sel]],
                      [torch.from_numpy(np.ascontiguousarray(h[ids]).view(np.int32)).to(dev)])
    return fn


def held_mesh(dt, t, ix, C):
    """The mesh's one group holds the host table, slots and residual mask
    (a (2, 4) layout of a pow2 table on one card: no padding)."""
    import numpy as np
    import torch

    (f,), (sl,), (res,) = dt._dev, dt._dev_slots, dt._dev_residual
    for g, h in zip(f, t.snapshot()):
        C.max_abs_err([g], [torch.from_numpy(h).to(g.device)])
    for g, h in zip(sl, ix.slots):
        C.max_abs_err([g.view(torch.int32)], [torch.from_numpy(h.view(np.int32)).to(g.device)])
    mask = np.zeros(t.capacity, bool)
    mask[list(ix.residual_rows)] = True
    C.max_abs_err([res], [torch.from_numpy(mask).to(res.device)])


def forms_cases(trees, dev, C):
    """The dense forms at phase 9's width and the mesh combine (module
    docstring): {name: {tag: fn}}, each fn held against the plain
    version first."""
    import numpy as np
    import torch

    M = trees["this"]["ops.match"]
    S = trees["this"]["parallel.sharded_match"]
    snap, enc, f, t, (mesh, fa, ta), (want10, want13) = C.forms_inputs(trees["this"], dev)
    small = M.EncodedTopics(*(x[:C.DENSE_B] for x in t))
    b, n = int(t.ids.shape[0]), int(f.words.shape[0])
    want = {"K10": want10, "K11": M.match_counts_ref(f, t), "K9": M.match_dense_ref(f, small)}
    cases = {
        f"K10 match_packed, B={b} over {n} rows": {
            tag: (lambda m=m: m["ops.match"].match_packed(f, t)) for tag, m in trees.items()},
        f"K11 match_counts, B={b}": {
            tag: (lambda m=m: m["ops.match"].match_counts(f, t)) for tag, m in trees.items()},
        f"K9 match_dense, B={C.DENSE_B}": {
            tag: (lambda m=m: m["ops.match"].match_dense(f, small)) for tag, m in trees.items()},
    }
    for (name, fns), key in zip(cases.items(), ("K10", "K11", "K9")):
        for fn in fns.values():
            C.max_abs_err([C.u32(fn())], [want[key]])
    del want, want10
    mesh_fns = {}
    for tag, m in trees.items():
        tmesh = m["parallel.mesh"].make_mesh(2, 4, devices=[dev] * 8)
        fm = m["parallel.mesh"].put_filters(snap, tmesh)
        tm = m["parallel.mesh"].put_topics(enc, tmesh)
        counts, packed, _ = m["parallel.sharded_match"].make_sharded_kernels(tmesh)
        mesh_fns[tag] = (lambda c=counts, fm=fm, tm=tm: c(fm, tm),
                         lambda p=packed, fm=fm, tm=tm: p(fm, tm))
    cnt = torch.zeros(b, dtype=torch.int32, device=dev)
    S.dense_tiles_ref(M.FORM_COUNTS, fa, ta, S._tiles(mesh, 0), n // 4, b // 2, cnt)
    for fc, fp in mesh_fns.values():
        C.max_abs_err([fc()], [cnt])
        C.max_abs_err([C.u32(fp())], [want13])
    del cnt, want13, mesh, fa, ta
    cases[f"K13 packed, (2, 4) on one card, B={b} over {n} rows"] = {
        tag: v[1] for tag, v in mesh_fns.items()}
    cases[f"K13 counts, (2, 4) on one card, B={b}"] = {tag: v[0] for tag, v in mesh_fns.items()}

    # the mesh combine: K14 on synthetic rows, K15 on each tree's mesh
    a, bb, c, mh = C.k14_case("scattered", PROBE_MH, dev, np.random.default_rng(0))
    cases[f"K14 max_hits={mh}"] = {
        tag: (lambda m=m: m["parallel.sharded_match"]._combine_launch(a, bb, c, mh))
        for tag, m in trees.items()}
    want = S.combine_pairs_ref(a, bb, c, mh)
    for fn in cases[f"K14 max_hits={mh}"].values():
        C.max_abs_err(fn(), want)
    salt = C.PROBE_SALTS[0]
    probes = {tag: m["parallel.sharded_match"].make_combine_probe_kernel(
        m["parallel.mesh"].make_mesh(2, 4, devices=[dev] * 8), mh) for tag, m in trees.items()}
    cases[f"K15 (2, 4) on one card, max_hits={mh}"] = {
        tag: (lambda p=p: p(salt)) for tag, p in probes.items()}
    want = C.probe_ref(trees["this"]["parallel.mesh"].make_mesh(2, 4, devices=[dev] * 8),
                       salt, mh)
    for fn in cases[f"K15 (2, 4) on one card, max_hits={mh}"].values():
        C.max_abs_err(fn(), want)
    return cases


def sync_cases(trees, dev, rng, C):
    """The fanout delta sync's cases (module docstring), each checked
    against the host arrays in both trees first."""
    import numpy as np
    import torch

    n_cap, e_cap = SYNC_TABLES
    host = [rng.integers(0, 1 << 20, n).astype(np.int32)
            for n in (n_cap, n_cap, e_cap, e_cap)]
    truth = [torch.from_numpy(a).to(dev) for a in host]
    deltas = {name: (np.sort(rng.choice(n_cap, r, replace=False)).astype(np.int32),
                     np.sort(rng.choice(e_cap, e, replace=False)).astype(np.int32))
              for name, (r, e) in SYNC_DELTAS.items()}
    deltas["full pool"] = (np.arange(n_cap, dtype=np.int32), np.arange(e_cap, dtype=np.int32))
    cases = {}
    for name, (rows, edges) in deltas.items():
        fns = {}
        for tag, m in trees.items():
            F = m["ops.fanout"]
            tabs = [torch.zeros_like(t) for t in truth]
            if hasattr(F, "fanout_sync"):
                staged = F.stage_delta(rows, edges, *host, dev)
                fn = (lambda F=F, tabs=tabs, staged=staged, n=(len(rows), len(edges)):
                      F.fanout_sync(*tabs, staged, *n))
            else:
                cols = []
                for ids, k in ((rows, 0), (edges, 2)):
                    idx = m["ops.table"].pad_pow2_batches(ids, F.SYNC_BATCH)
                    cols.append([torch.from_numpy(c).to(dev)
                                 for c in (idx, host[k][idx], host[k + 1][idx])])

                def fn(F=F, tabs=tabs, cols=cols):
                    F.scatter_segs(*tabs[:2], *cols[0])
                    F.scatter_edges(*tabs[2:], *cols[1])
            fn()
            for t, w, ids in zip(tabs, truth, (rows, rows, edges, edges)):
                sel = torch.from_numpy(ids.astype(np.int64)).to(dev)
                C.max_abs_err([t[sel]], [w[sel]])
            fns[tag] = fn
        cases[f"K6+K7 kernels, {name} delta ({len(rows)} rows, {len(edges)} edges)"] = fns
        if name == "full pool":
            continue
        fns = {}
        for tag, m in trees.items():
            F = m["ops.fanout"]
            store = F.DestStore(edge_capacity=e_cap, row_capacity=n_cap,
                                client_capacity=1024)
            store.seg_off[:], store.seg_len[:] = host[0], host[1]
            store.edge_client[:], store.edge_opts[:] = host[2], host[3]
            mirror = F.FanoutDeviceState(store, device=dev)
            mirror.sync()  # the full upload
            r_list, e_list = rows.tolist(), edges.tolist()

            def fn(store=store, mirror=mirror, r_list=r_list, e_list=e_list):
                store.dirty_rows.extend(r_list)
                store.dirty_edges.extend(e_list)
                mirror.sync()

            fn()
            C.max_abs_err(mirror.tensors(), truth)
            fns[tag] = fn
        cases[f"FanoutDeviceState.sync(), {name} delta"] = fns
    return cases


if __name__ == "__main__":
    sys.exit(main())
