#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (emqx_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; no phase swallows an exception):

1. Device: require a CUDA card; print `nvidia-smi`'s name and power limit.
2. Build: compile the four kernels from emqx_tpu_torch/ops/csrc with nvcc
   for sm_90a (one nvcc per source, in parallel) and print the seconds.
3. Slice set-up: a Router(max_levels=16) on the card holding 1,048,576
   routes `t{i%997}/r{i%13}/d{i}/+/m/#` (BASELINE.json config 2), 4,800
   filters over 600 distinct '+'/'#' skeletons (past the 256-class budget,
   so the residual dense leg runs), $SYS filters and 300 exact topics.
4. Kernel vs plain, on the card, at the slice's shapes: K1 on a 1024-topic
   batch (and once with max_hits below the total), K2 over the residual
   mask of the full table capacity and over the full table's own active
   mask (the dense-only mode's shape), K3/K4 on one churn sync. Every
   output must equal the plain PyTorch version's on the same inputs
   exactly (integer outputs: the tolerance is 0). Each kernel's median
   time over 20 launches (CUDA events) and the plain version's are taken.
5. Slice end to end: warm-up; launch counters set to 0; 32 batches of
   1024 Zipf-distributed topics through match_filters_begin/finish,
   pipelined two deep, match cache off; counters read. Between batches
   ~1,000 routes are deleted and re-added and 256 skeleton filters are
   swapped for a different filter of the same skeleton, which takes the
   freed row and bucket while the previous batch is in flight (every
   sync runs K3/K4). Every topic's answer must hold each filter that the
   host path (Router.match_filters: exact dict + trie) gives at both its
   begin and its finish, and only filters it gives at one of them: equal
   to the host path wherever no route of the topic changed in flight.
   Every kernel's launch counter must be > 0. One line per kernel: its
   times, its bound and its launches here, and the host legs of the run
   (encode, sync, hash, dense, unpack). Then 8 more batches run under
   torch.profiler for the device's busy share of the begin+finish wall.
6. Dense-only mode: a second Router(use_hash_index=False) over the same
   routes; warm-up; counters set to 0; 8 batches served and checked as
   in phase 5; counters read: K2 and K3 must have run, K1 and K4 not.
7. Summary: one `{"kernels": [...]}` JSON line (launches from phase 5),
   then, as the last line, `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_OPS_PER_S = 67e12  # float32 outside the tensor cores, H100 SXM data sheet

N_ROUTES = 1 << 20
N_SKELETONS = 600
PER_SKELETON = 8
N_EXACT = 300
BATCH = 1024
N_BATCHES = 32
N_DENSE_BATCHES = 8
CHURN = 1000
SWAP = 256
REPEATS = 20


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def median_ms(fn, repeats: int = REPEATS) -> float:
    """Median of `repeats` single-call times on the current stream, by
    CUDA events (one warm-up call first)."""
    import torch

    fn()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs_err(got, want) -> int:
    """Largest |kernel - plain| over all (integer) outputs; raises unless
    it is 0: the tolerance is exact equality."""
    import torch

    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"output {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    if err:
        raise AssertionError(f"kernel differs from its plain version by {err}")
    return err


# --- workload ---------------------------------------------------------------


def skeleton_filters(rng):
    """N_SKELETONS distinct (plen, '+' positions, '#') skeletons over
    levels 3..12, PER_SKELETON filters each with distinct literals."""
    seen = set()
    skels = []
    while len(skels) < N_SKELETONS:
        plen = int(rng.integers(3, 13))
        plus = int(rng.integers(0, 1 << plen))
        hh = bool(rng.integers(0, 2))
        if plus == (1 << plen) - 1 or (plen, plus, hh) in seen:
            continue
        seen.add((plen, plus, hh))
        skels.append((plen, plus, hh))
    out = []
    for k, (plen, plus, hh) in enumerate(skels):
        for j in range(PER_SKELETON):
            ws = ["+" if (plus >> i) & 1 else f"s{k % 7}x{(i * 3 + j) % 8}"
                  for i in range(plen)]
            if ws[0] != "+":
                ws[0] = f"k{k}"  # a literal root unique to the skeleton
            if hh:
                ws.append("#")
            out.append("/".join(ws))
    return list(dict.fromkeys(out))


def swap_of(flt: str) -> str:
    """Another filter of the same skeleton: the last literal level
    changed. A topic matches at most one of `flt` and `swap_of(flt)`."""
    ws = flt.split("/")
    i = max(k for k, w in enumerate(ws) if w not in ("+", "#"))
    ws[i] += "z"
    return "/".join(ws)


def instantiate(flt: str, rng) -> str:
    """A topic that matches `flt`."""
    ws = []
    for w in flt.split("/"):
        if w == "+":
            ws.append(f"v{int(rng.integers(0, 50))}")
        elif w == "#":
            ws.extend(f"h{int(rng.integers(0, 9))}" for _ in range(int(rng.integers(0, 3))))
        else:
            ws.append(w)
    return "/".join(ws)


def publish_batch(rng, skel, exact):
    """BATCH topics: 70% device topics with Zipf-drawn ids, 10% hits on
    the skeleton filters or their swaps (residual or classed), 5% $SYS,
    10% exact topics, 5% matching nothing."""
    kinds = rng.random(BATCH)
    ids = (rng.zipf(1.2, BATCH) - 1) % N_ROUTES
    out = []
    for k, d in zip(kinds.tolist(), ids.tolist()):
        if k < 0.70:
            tail = "/x" * int(rng.integers(0, 3))
            out.append(f"t{d % 997}/r{d % 13}/d{d}/w{d % 5}/m{tail}")
        elif k < 0.80:
            f = skel[int(rng.integers(0, len(skel)))]
            out.append(instantiate(f if rng.random() < 0.5 else swap_of(f), rng))
        elif k < 0.85:
            out.append(f"$SYS/brokers/n{int(rng.integers(0, 4))}/stats")
        elif k < 0.95:
            out.append(exact[int(rng.integers(0, len(exact)))])
        else:
            out.append(f"nomatch/{int(rng.integers(0, 1000))}/zz")
    return out


def build_router(rng, device, use_hash_index=True):
    from emqx_tpu_torch.models.router import Router

    router = Router(max_levels=16, device=device, use_hash_index=use_hash_index)
    t0 = time.perf_counter()
    step = 1 << 16
    for lo in range(0, N_ROUTES, step):
        router.add_routes([
            (f"t{i % 997}/r{i % 13}/d{i}/+/m/#", f"n{i % 7}")
            for i in range(lo, min(N_ROUTES, lo + step))
        ])
    skel = skeleton_filters(rng)
    router.add_routes([(f, "s") for f in skel])
    router.add_routes([("$SYS/brokers/+/stats", "sys"), ("$SYS/#", "sys")])
    exact = [f"e/{k}/v" for k in range(N_EXACT)]
    router.add_routes([(t, f"x{k % 3}") for k, t in enumerate(exact)])
    host_s = time.perf_counter() - t0
    return router, skel, exact, host_s


def churn(router, skel, rng) -> None:
    """Delete and re-add CHURN of the 1M routes, and swap SWAP skeleton
    filters for their `swap_of` twin (or back). Each swap deletes a
    route and adds a different one at once, so the new filter takes the
    freed row and bucket off the free lists while a batch that matched
    the old one may be in flight. The next sync rewrites ~CHURN+SWAP
    rows and their cuckoo slots on the device."""
    for i in rng.integers(0, N_ROUTES, CHURN).tolist():
        f, d = f"t{i % 997}/r{i % 13}/d{i}/+/m/#", f"n{i % 7}"
        router.delete_route(f, d)
        router.add_route(f, d)
    for j in rng.integers(0, len(skel), SWAP).tolist():
        f = skel[j]
        old, new = (f, swap_of(f)) if router.has_route(f, "s") else (swap_of(f), f)
        router.delete_route(old, "s")
        router.add_route(new, "s")


# --- kernel checks -------------------------------------------------------------


def check_kernels(router, skel, topics, rng):
    """Phase 4: each kernel against its plain version on the same CUDA
    inputs at the slice's shapes. Returns the per-kernel records."""
    import numpy as np
    import torch

    from emqx_tpu_torch.device import to_device
    from emqx_tpu_torch.models import router as R
    from emqx_tpu_torch.ops import hash_index as H
    from emqx_tpu_torch.ops import match as M
    from emqx_tpu_torch.ops.hash_index import BUCKET_W, SlotArrays
    from emqx_tpu_torch.ops.table import EncodedFilters, next_pow2, pad_pow2_batches

    dt = router.device_table
    dev = dt.device
    dt.sync()
    enc = M.encode_topics(router.table.vocab, topics, router.max_levels)
    denc = dt._topics(enc)
    B, L = enc.ids.shape
    recs = {}

    # K1: the hash leg at the router's max_hits, then overflowing
    meta, slots = dt.hash_state()
    mh = max(1024, next_pow2(2 * B))
    got = H.match_ids_hash(meta, slots, denc, max_hits=mh)
    want = H.match_ids_hash_ref(meta, slots, denc, max_hits=mh)
    err = max_abs_err(got, want)
    total = int(got[2])
    # the overflow path: below the total, and the escalated bound
    small = max(1, total // 3)
    for bound in (small, next_pow2(total)):
        err = max(err, max_abs_err(
            H.match_ids_hash(meta, slots, denc, max_hits=bound),
            H.match_ids_hash_ref(meta, slots, denc, max_hits=bound)))
    C = int(meta.plen.shape[0])
    tl = denc.lens[:, None]
    pl = meta.plen[None, :]
    elig = (torch.where(meta.has_hash[None, :], tl >= pl, tl == pl)
            & meta.active[None, :]
            & ~(denc.dollar[:, None] & meta.root_wild[None, :]))
    n_elig = int(elig.sum())
    hits = min(total, mh)
    bytes_k1 = (C * 11 + B * (4 * L + 5) + n_elig * 2 * 4 + hits * 12
                + mh * 8 + 8)
    ops_k1 = B * C * 8 + n_elig * (8 * L + 24) + hits * 40
    recs["match_ids_hash"] = dict(
        ms=median_ms(lambda: H.match_ids_hash(meta, slots, denc, max_hits=mh)),
        plain_ms=median_ms(lambda: H.match_ids_hash_ref(meta, slots, denc, max_hits=mh)),
        bytes=bytes_k1, ops=ops_k1, err=err,
        shape=f"B={B} C={C} buckets={int(slots.probe.shape[0])} max_hits={mh} "
              f"total={total} overflow_max_hits={small}",
    )

    # K2: the residual leg over the full table capacity, then the
    # dense-only mode's shape: the full table's own active mask
    for name, filters, mh2 in (
        ("match_ids", dt.residual_filters(), max(1024, next_pow2(2 * B))),
        ("match_ids_dense_only", dt.filters(), max(4096, next_pow2(4 * B))),
    ):
        N = int(filters.words.shape[0])
        got = M.match_ids(filters, denc, max_hits=mh2)
        err = max_abs_err(got, M.match_ids_ref(filters, denc, max_hits=mh2))
        act = filters.active
        n_act = int(act.sum())
        plen_sum = int(filters.prefix_len[act].sum())
        hits2 = min(int(got[2]), mh2)
        bytes_k2 = N + n_act * (4 * L + 6) + B * (4 * L + 5) + mh2 * 8 + 4
        ops_k2 = B * (plen_sum + 3 * n_act)
        recs[name] = dict(
            ms=median_ms(lambda: M.match_ids(filters, denc, max_hits=mh2)),
            plain_ms=median_ms(lambda: M.match_ids_ref(filters, denc, max_hits=mh2)),
            bytes=bytes_k2, ops=ops_k2, err=err,
            shape=f"B={B} N={N} L={L} active={n_act} max_hits={mh2} "
                  f"total={int(got[2])} written={hits2}",
        )

    # K3/K4: one churn sync, applied to copies of the device state
    churn(router, skel, rng)
    churn(router, skel, rng)
    t = router.table
    rows = pad_pow2_batches(np.unique(np.asarray(t.dirty, np.int32)), R.SYNC_BATCH_SIZE)
    cols = [to_device(c, dev) for c in (
        rows, t.words[rows], t.prefix_len[rows], t.has_hash[rows],
        t.root_wild[rows], t.active[rows])]
    base = dt.filters()
    a = EncodedFilters(*(x.clone() for x in base))
    b = EncodedFilters(*(x.clone() for x in base))
    R.scatter_rows(a, *cols)
    R.scatter_rows_ref(b, *cols)
    err = max_abs_err(a, b)
    host = EncodedFilters(*(to_device(x, dev) for x in t.snapshot()))
    err = max(err, max_abs_err(a, host))
    n3 = int(rows.size)
    recs["scatter_rows"] = dict(
        ms=median_ms(lambda: R.scatter_rows(a, *cols)),
        plain_ms=median_ms(lambda: R.scatter_rows_ref(b, *cols)),
        bytes=2 * n3 * (4 * L + 7) + n3 * 4, ops=0, err=err,
        shape=f"dirty_rows={len(set(t.dirty))} padded={rows.shape} L={L}",
    )
    ix = router.index
    idx = pad_pow2_batches(np.unique(np.asarray(ix.dirty_slots, np.int32)), R.SYNC_BATCH_SIZE)
    scols = [to_device(c, dev) for c in (
        idx, ix.slots.fp[idx], ix.slots.bucket[idx], ix.slots.probe[idx // BUCKET_W])]
    _meta, sbase = dt.hash_state()
    a = SlotArrays(*(x.clone() for x in sbase))
    b = SlotArrays(*(x.clone() for x in sbase))
    R.scatter_slots(a, *scols)
    R.scatter_slots_ref(b, *scols)
    err = max(max_abs_err([x.view(torch.int32) for x in a], [x.view(torch.int32) for x in b]),
              max_abs_err([x.view(torch.int32) for x in a],
                          [to_device(x, dev).view(torch.int32) for x in ix.slots]))
    n4 = int(idx.size)
    recs["scatter_slots"] = dict(
        ms=median_ms(lambda: R.scatter_slots(a, *scols)),
        plain_ms=median_ms(lambda: R.scatter_slots_ref(b, *scols)),
        bytes=n4 * 16 + n4 * 12, ops=0, err=err,
        shape=f"dirty_slots={len(set(ix.dirty_slots))} padded={idx.shape}",
    )
    torch.cuda.synchronize()
    for name, r in recs.items():
        r["bound_ms"] = 1e3 * max(r["bytes"] / H100_BYTES_PER_S, r["ops"] / H100_OPS_PER_S)
        r["bound_by"] = ("bytes" if r["bytes"] / H100_BYTES_PER_S
                         >= r["ops"] / H100_OPS_PER_S else "operations")
    return recs


# --- the slice end to end ------------------------------------------------------


def serve(router, skel, exact, rng, n_batches: int = N_BATCHES):
    """Phase 5: the pipelined publish stream with churn, every batch
    checked against the host path at its begin and at its finish.
    Returns (topics/s over the begin+finish host wall, escalations,
    topics served, that wall, topics whose routes changed in flight)."""
    from emqx_tpu_torch.obs.kernel_telemetry import KernelTelemetry

    # a fresh collector: the legs and counters read below are this run's
    router.telemetry = router.device_table.telemetry = KernelTelemetry()
    pending = []
    served = 0
    moved = 0
    busy = 0.0
    batches = [publish_batch(rng, skel, exact) for _ in range(n_batches)]

    def finish_oldest():
        nonlocal served, busy, moved
        k, topics, p, before = pending.pop(0)
        t0 = time.perf_counter()
        got = router.match_filters_finish(p)
        busy += time.perf_counter() - t0
        bad = []
        for t, g, b in zip(topics, got, before):
            a = set(router.match_filters(t))
            moved += a != b
            if len(g) != len(set(g)) or not (a & b <= set(g) <= a | b):
                bad.append((t, sorted(g), sorted(b), sorted(a)))
        if bad:
            raise AssertionError(
                f"batch {k}: {len(bad)} of {len(topics)} topics differ from "
                f"the host path, e.g. (topic, device, host at begin, host "
                f"at finish) {bad[:3]}")
        served += len(topics)

    for k, topics in enumerate(batches):
        t0 = time.perf_counter()
        p = router.match_filters_begin(topics)
        busy += time.perf_counter() - t0
        # host truth as of this batch's launch
        before = [set(router.match_filters(t)) for t in topics]
        pending.append((k, topics, p, before))
        if len(pending) == 2:
            finish_oldest()
        if k + 1 < n_batches:
            churn(router, skel, rng)
    while pending:
        finish_oldest()
    c = router.telemetry.counters
    esc = c.get("hash_overflow_retries_total", 0) + c.get("escalations_total", 0)
    return served / busy, esc, served, busy, moved


def device_busy_share(router, skel, exact, rng, n_batches: int = 8):
    """A few more batches under torch.profiler: the union of the device
    activity intervals over the begin+finish host wall. The profiler's
    own host overhead inflates the wall, so this reads low rather than
    high."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _rate, _esc, served, busy, _moved = serve(router, skel, exact, rng, n_batches)
        torch.cuda.synchronize()
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA)
    dev_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            dev_us += b - max(a, end)
            end = b
    return dev_us * 1e-6, busy, served


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from emqx_tpu_torch.ops import _build
    from emqx_tpu_torch.models import router as _router  # noqa: F401  registers K3/K4

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # phase 2: build
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {sorted(_build.KERNELS)} in {time.perf_counter() - t0:.3f} s")

    rng = np.random.default_rng(args.seed)

    # phase 3: slice set-up
    router, skel, exact, host_s = build_router(rng, "cuda")
    log(f"routes: {router.stats()} residual_rows={len(router.index.residual_rows)} "
        f"classes={router.index.active_hi()} host_build_s={host_s:.3f} [{card}]")
    if not router.index.residual_rows:
        raise AssertionError("the residual leg has no rows")

    # phase 4: kernel vs plain
    recs = check_kernels(router, skel, publish_batch(rng, skel, exact), rng)

    # phase 5: the slice end to end; counters from zero just before it
    t0 = time.perf_counter()
    warmed = router.warmup_shapes(max_batch=BATCH)
    warm_s = time.perf_counter() - t0
    _build.reset_launches()
    rate, esc, served, _busy, moved = serve(router, skel, exact, rng)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in _build.KERNELS.items()}
    log(f"slice: {served} topics in {N_BATCHES} batches, {rate:.1f} topics/s "
        f"(begin+finish wall, syncs included), overflow_escalations={esc}, "
        f"topics_with_routes_changed_in_flight={moved}, "
        f"warmup_shapes={warmed} in {warm_s:.3f} s, host_build_s={host_s:.3f}, "
        f"launches={launches} [{card}]")
    legs = {leg: {"n": h.total, "sum_s": round(h.sum, 6),
                  "p50_ms": round(h.percentile(50) * 1e3, 4),
                  "p99_ms": round(h.percentile(99) * 1e3, 4)}
            for leg, h in sorted(router.telemetry.hist.items())}
    log(f"slice legs (host clock, telemetry histograms): {json.dumps(legs)}")
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    if not moved:
        raise AssertionError("no topic saw a route change in flight")
    dev_s, wall_s, n = device_busy_share(router, skel, exact, rng)
    log(f"profile: {n} topics, device busy {dev_s:.6f} s of {wall_s:.6f} s "
        f"begin+finish wall, busy share {dev_s / wall_s:.4f} [{card}]")

    # phase 6: dense-only mode over the same routes
    del router
    gc.collect()
    torch.cuda.empty_cache()
    dense, skel, exact, dense_host_s = build_router(
        np.random.default_rng(args.seed), "cuda", use_hash_index=False)
    dense.warmup_shapes(max_batch=BATCH)
    _build.reset_launches()
    d_rate, d_esc, d_served, _busy, d_moved = serve(
        dense, skel, exact, rng, N_DENSE_BATCHES)
    torch.cuda.synchronize()
    d_launches = {name: k.launches for name, k in _build.KERNELS.items()}
    log(f"dense-only: {d_served} topics in {N_DENSE_BATCHES} batches, "
        f"{d_rate:.1f} topics/s (begin+finish wall, syncs included), "
        f"overflow_escalations={d_esc}, topics_with_routes_changed_in_flight="
        f"{d_moved}, host_build_s={dense_host_s:.3f}, launches={d_launches} [{card}]")
    if d_launches["match_ids"] <= 0 or d_launches["scatter_rows"] <= 0:
        raise AssertionError(f"dense-only mode skipped K2 or K3: {d_launches}")
    if d_launches["match_ids_hash"] or d_launches["scatter_slots"]:
        raise AssertionError(f"dense-only mode launched the hash leg: {d_launches}")
    del dense
    gc.collect()

    path_launches = dict(launches, match_ids_dense_only=d_launches["match_ids"])
    for name, r in recs.items():
        log(f"kernel {name}: ms={r['ms']:.6f} plain_ms={r['plain_ms']:.6f} "
            f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) "
            f"launches={path_launches[name]} equal=True [{r['shape']}] [{card}]")

    # phase 7: summary
    meta = {
        "match_ids_hash": ("emqx_tpu_torch/ops/csrc/hash_match.cu",
                           "emqx_tpu/ops/hash_index.py:899"),
        "match_ids": ("emqx_tpu_torch/ops/csrc/dense_match.cu",
                      "emqx_tpu/ops/match.py:158"),
        "scatter_rows": ("emqx_tpu_torch/ops/csrc/scatter.cu",
                         "emqx_tpu/models/router.py:67"),
        "scatter_slots": ("emqx_tpu_torch/ops/csrc/scatter.cu",
                          "emqx_tpu/models/router.py:100"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r = recs[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "verified": True,
        })
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
