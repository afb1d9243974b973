#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (emqx_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--serve]

`--serve` runs phases 1-3, then only the serve paths of phases 5, 6 and
9 (no kernel checks) and prints their rates, and phases 5 and 9's leg
medians and timed generation-2 collections, on one line: the quick way
to compare two trees in many turns of one call.

Phases (any failure exits non-zero; no phase swallows an exception):

1. Device: require a CUDA card; print `nvidia-smi`'s name and power limit.
2. Build: compile the two native host cores (emqx_tpu_torch/native:
   the churn core and delivery ledger, the frame codec) with g++ against
   this Python's headers, printing their seconds, the g++ version and
   the include directory; compile every kernel from
   emqx_tpu_torch/ops/csrc with nvcc for sm_90a (one nvcc per source, in
   parallel) and print the seconds. Then (not with --serve) the native
   cores against their Python twins on this machine's build: one Router
   with the churn core and one with its twin through the same seeded
   storm (65,536 routes of phase 3's pattern, its 4,800 skeleton
   filters, $SYS filters, exact topics, too-deep filters, then three
   rounds of single and batched adds and deletes and skeleton swaps),
   with device tables on the CPU: equal generation moves call for call,
   equal staged deltas (live rows by filter), each device table equal
   to a full upload after every delta sync, equal `churn_state` after
   the last round and equal answers after every round; the same at
   16,384 routes and 100 skeletons, where every class is compared too;
   the delivery ledger's seeded 20,000-op fuzz, native against twin;
   the frame corpus (`frame_results`: v4/v5 PUBLISH QoS 0-2, the PUBACK
   family, SUBACK, a PUBLISH with properties, cut-short and malformed
   frames) through the native codec and the Python one, bytes, parses
   and FrameErrors equal. From phase 3 on, each route-building phase
   (3, 5, 6, 7, 8, 9, 10) prints a "churn core" line and fails unless
   every Router took the churn core, every Router holding routes has a
   live churn handle and no twin leg ran (`ChurnCoreWatch`); phases 7,
   8 and 10 print a "native cores" line and fail if any session bound
   the twin ledger; phase 7 (sessions) and phase 8 (the server: sessions,
   native frame encodes and decodes) fail unless the native legs
   served.
3. Slice set-up: a Router(max_levels=16) on the card holding 1,048,576
   routes `t{i%997}/r{i%13}/d{i}/+/m/#` (BASELINE.json config 2), 4,800
   filters over 600 distinct '+'/'#' skeletons (past the 256-class budget,
   so the residual dense leg runs), $SYS filters and 300 exact topics.
4. Kernel vs plain, on the card, at the slice's shapes: K1 on a 1024-topic
   batch (at the router's first bound, below the total and at
   next_pow2(total)), K2 over the residual
   mask of the full table capacity and over the full table's own active
   mask (the dense-only mode's shape), then K2 at its edge cases on
   edited clones of the table (max_hits below the total; 4,096 extra
   live '#' rows in one chunk, past one block's hit record; an all-dead
   mask; live rows only in the last chunk; B = 1 and 2,048; N = chunk),
   the fused K3/K4 table sync (`table_sync`) on one churn round's delta,
   as each of phase 5's syncs sees it (both sides with the residual bytes, rows only, slots only, ids past
   both tables), on 1 and 1,025 entries a side and on the full table,
   each table also against the host arrays (rows, slots and residual
   mask), and `scatter_rows`/`scatter_slots` at the delta's padded
   [nb, K] batches; timed against nine `index_copy_` calls on the staged
   views, with one launch's floor (K12 on a scalar) beside it. Every
   output must equal the plain PyTorch
   version's on the same inputs exactly (integer outputs: the tolerance
   is 0). Times, for every kernel of every phase, its plain version and
   (where one exists) the one PyTorch call computing the same function:
   `call_ms`, the median of 20 single calls each between two CUDA events
   (with the card idle, this holds the host's enqueue of the call too);
   `device_ms`, a run of 50 calls back to back between one event pair,
   over 50, with the stream held by a spin kernel while the host
   enqueues the run, so the run reads the card's time; `enqueue_ms`, the
   host clock over that loop. `ms`, `plain_ms` and `library_ms` in the
   kernels line are the device times.
5. Slice end to end: warm-up; launch counters set to 0; 32 batches of
   1024 Zipf-distributed topics through match_filters_begin/finish,
   pipelined two deep, match cache off; counters read. Between batches
   ~1,000 routes are deleted and re-added and 256 skeleton filters are
   swapped for a different filter of the same skeleton, which takes the
   freed row and bucket while the previous batch is in flight (every
   sync stages its dirty rows, their residual bytes and its dirty slots
   in one buffer: one copy, one `table_sync` launch). Every topic's
   answer must hold each filter that the
   host path (Router.match_filters: exact dict + trie) gives at both its
   begin and its finish, and only filters it gives at one of them: equal
   to the host path wherever no route of the topic changed in flight.
   Every kernel's launch counter must be > 0. K1's launches, the
   escalations, the hash leg's bound floor, amb batches and host
   fallbacks are printed; more than one escalation, or more than
   N_BATCHES + 1 K1 launches, fails (the bound sticks after the first
   overflow). Printed too: the generation-2 garbage collections that
   started inside the begin+finish wall and elsewhere in the serve, with
   their seconds, and the table syncs' launches and entries (rows and
   slots a sync). One line per kernel: its
   times, its bound and its launches here, and the host legs of the run
   (encode, sync, hash, dense, unpack). Then 8 more batches run under
   torch.profiler for the device's busy share of the begin+finish wall.
6. Dense-only mode: a second Router(use_hash_index=False) over the same
   routes; warm-up; counters set to 0; 8 batches served and checked as
   in phase 5; counters read: K2 and `table_sync` must have run, with no
   slot entries in any sync, and K1 not.
7. The broker publish path: a Broker(max_levels=16) on the card, its
   router given the same 1,048,576 routes through Router.add_routes;
   100,000 sessions on `pfan/+/x` at QoS i%3, half also on `pfan/#` at
   QoS 2 (a ~150k gathered fan, ~100k after dedup), 16 groups of 2,048
   sessions on `mfan/{g}/+`, 8 shared members on `$share/g1/pfan/+/x`,
   and no_local / retain-as-published subscriptions (262,144 client
   rows). K5 (at a 2k-fan and the 150k-fan plan, on persistent tables
   carried from the one plan into the other, and on a fresh table;
   two records), the fused K6/K7 sync (`fanout_sync`: one churn's
   delta, both sides, rows only, edges only and with ids past both
   tables, on copies of the stale mirror; 1 and 1,025 entries a side
   and the full pool on scrambled copies of the host truth; each table
   also against the host arrays; `scatter_segs`/`scatter_edges` at the
   delta's padded [nb, K] batches; timed against four `index_copy_`
   calls, with one launch's floor, K12 on a scalar, beside it) and
   K12 (the probe's scalar and 1 MB buffer) against
   their plain versions, exactly (K12 also in int32 and float32 at the
   scalar, 1 MB, 64 MB, an odd length 2^18 + 3 and that length from a
   view one element in, the 64 MB buffer timed against torch.add, and
   K12 and the scalar against torch.add, the library yardstick); the
   150k-fan plan by host walk and by device resolve. Then the DispatchEngine (queue_depth 1024, pipeline
   depth 2, the default match cache, fanout min_fan 1024,
   transfer_chunk_kb 0 so warm-up probes the link through K12) with the
   counters set to 0 just before its warm-up: 32 windows of 1,024 QoS-0
   publishes (64-byte payloads; 4 on `pfan/{k}/x`, 20 on `mfan/{g}/{v}`,
   the rest phase 5's mix) through submit_many, two windows at a time.
   After each pair lands: every plan a device resolve installed equals
   Broker._build_fanout_plan over the same filters, every publish's
   delivery count equals the host oracle's, and every (client, topic)
   the plans name was delivered exactly once, and nothing else. Between
   pairs: 8 late joiners on `pfan/#`, 4 leavers from `pfan/+/x`, 16
   re-subscribes at another QoS in one mfan group, one session closed
   and re-opened, and after every second pair phase 5's delete and
   re-add of 1,000 routes (the pairs between keep the match cache warm,
   so they launch overlapped resolves). K5, the fused K6/K7 sync and
   K12 must each have launched and a plan must have been resolved on
   the card and one overlapped. Printed: publishes/s and deliveries/s over the
   traffic wall, fanout_resolve_seconds p50/p99, the resolves by
   source, the host walk against K5 for one 150k-fan plan, launches.
8. Retained reads and the MQTT server: a Broker on the card whose
   Retainer stores 1,000,000 names `dev/{g}/{k}/state` (g < 10,000,
   k < 100, 64-byte payloads, stored QoS i%3; bench.py:1438) and 1,024
   `$SYS/{g}/x/state`, with the device index attached. (a) Waves of 512
   and 4,096 filters (70% `dev/{g}/+/state`, 10% `dev/{g}/#`, 10%
   `dev/{g}/{k}/+`, 8% `+/{g}/+/state`, 1% `dev/+/{k}/state`, 1% a
   literal no name uses), one untimed and 4 timed per size, and one
   5,000-filter wave, through RetainedIndex.read_begin/finish: every
   answer equals the host trie walk, and the timed waves' messages from
   Retainer.retained_read_begin/finish are the stored messages of the
   host walk's names; device, host-walk and end-to-end filters/s. (b) K8
   at its edges, each equal to its plain version: a crafted table of
   1,024 buckets (two verified lanes, three byte matches, a byte match
   with a wrong fingerprint, a verified dead slot, a second lane that
   verifies after a first that fails) with padding lanes in the middle,
   then over the live table B = 1, 257 and every rung of BATCH_LADDER
   (device_ms and enqueue_ms printed at each); then K8 against its
   plain version over the live table at B=4096 and B=8, exactly, timed.
   (c) The port's Server on 127.0.0.1: 256 TCP
   clients (half MQTT 5, half 3.1.1), each one 8-filter SUBSCRIBE (QoS
   1 grants on the one-name and exact filters, which the clients
   PUBACK), 128 single-filter SUBSCRIBEs (the B=1 read), 64 re-
   subscribes with retain_handling 1 and 64 with 2; two rounds, with a
   publisher client's 256 new retained names, 256 deletes and 256
   replaces between them. Every SUBACK grants each QoS, the retained
   PUBLISHes after it equal the host walk's multiset, nothing else
   arrives, no drop counter moves, K8 launched, and device reads are at
   least 99% of the wildcard reads. Printed: subscribes/s, retained
   messages/s, SUBACK latency p50/p99, device reads against host
   fallbacks, the churn's seconds, K8's launches, also by ladder rung. (d) `python -m
   emqx_tpu_torch.broker.server` started as a user starts it (on the
   card by default) serves a retained read to a raw-socket client, and
   is stopped. Printed last: the phase's seconds, by stage.
9. The sub-sharded mesh routing path on the one card: a
   Router(max_levels=16, mesh=make_mesh(2, 4, devices=["cuda"] * 8))
   given phase 3's route set. (a) K10 and K11 at 1,024 topics and K9 at
   64 over the table's full capacity (2,097,152 rows), each equal to its
   plain version, 32 topics' rows equal to the host oracle's
   (Router.match_filters), K9 equal to K10's bitmap unpacked, K9's,
   K10's and K11's launches by torch.profiler (with each kernel's
   events in the trace and the traced calls' CUDA-event time) and K11's
   global atomics (at most, nonzero); then K9, K10 and K11 on
   FORM_EDGES' small tables built by the port (a dead block, dead
   words and lone live rows in a partial last block, rows of 17-24
   levels, max_levels 7, '#' and '+/#' rows against $SYS topics, 37
   and 1,000 topics, unpadded and padded) and K9 and K11 on the counts'
   own edge (COUNTS_EDGE_ROWS rows, not a multiple of 32 or 16: K9's
   output rows unaligned), each equal to its plain version, every
   topic's rows and count to the table's host oracle and K9 to K10's
   bitmap unpacked. (b) The mesh sync and warm_up shapes (each
   batch shape's first escalation step, the churn scatters); counters
   set to 0; 16 pipelined 1024-topic batches of phase 5's mix with
   phase 5's churn between them, every answer checked against the host
   path at begin and at finish as in phase 5; counters read: K14, K16,
   K17 and the fused K13/K18 mesh table sync (`mesh_table_sync`: every
   sync stages its dirty rows, their residual bytes and its dirty slots
   in one buffer, one copy and one launch a device group) must have
   run. Printed: topics/s, escalations, device batches against host
   fallbacks, mesh_combine_seconds, the generation-2 collections in and
   out of the timed window, the mesh table syncs' launches and entries,
   and the host legs (encode, sync, hash, dense, unpack). Then each mesh
   kernel against its plain version on the router's own state (K13
   counts and packed, K14 over both legs' tiles, K15 (one launch, by
   torch.profiler) and K15 at salts 12345, -2, 1.5e9 and 2,147,483,646
   and block capacities of 1 and 7 beside the router's, on the (2, 4)
   mesh and the padded (1, 3) layout, K16, K17; K13
   packed and counts also on FORM_EDGES' tables on the (2, 4) mesh and
   the padded (1, 3) layout, K13 counts on the counts' own edge there
   (shards of 286 and 381 rows), and both forms' launches by
   torch.profiler), timed
   as in phase 4 (the plain versions, hundreds of ms a call, over 3
   calls both ways), and `mesh_table_sync` as phase 4 holds
   `table_sync`: one churn round's delta (both sides with the residual
   bytes, rows only, slots only, ids past the tables and negative ids),
   1 and 1,025 entries a side, the full table, the delta on the padded
   (1, 3) layout and on a group holding sub shards 1 and 3 of four (the
   owner map), each table against the host arrays too, and the
   reference-shaped apply_delta, slot delta and fused sync on the
   delta's padded [nb, K] batches; timed against nine `index_copy_`
   calls; K14 first at its edges on synthetic rows (valid entries
   scattered, a block cut at max_hits, every valid entry in the last
   shard, counts above the valid entries, nothing valid, max_hits 1,
   the padded (1, 3) layout), each equal to its plain version and
   timed at the block capacity and at twice it (the widest a path
   launches: warm_up's first escalation step), and K14 on the hash
   leg's tiles at that width; K16, K17 and
   K14 again at a block capacity of at most half the largest tile count
   (the per-tile truncation, exact counts past it, the combine's cut,
   which at least one leg must reach; K14 timed there too); then
   one 1024-topic batch with the block capacity forced to
   ESCALATION_MH, which both legs must escalate past, against the host
   path, every K14 call of it equal to its plain version. (c) The padded (1, 3) layout with churn, with and without the
   class index; on the hashed one, counters set to 0 and route adds
   that grow the class index (a row-only sync: K13 apply_delta's work)
   and then the table (full row upload, a slot-only sync: the K18 slot
   delta's), each one `mesh_table_sync` launch, each answer against the
   host path; the dry run's Broker(mesh=...)
   publish of 24 rooms with exact delivery counts;
   DispatchEngine.warmup() reporting 4 shards. The mesh router of (a)
   and (b) is a Broker(mesh=...)'s, kept for phase 10.
10. The device failure domain, on phase 7's broker (kept from phase 7)
   and phase 9's mesh broker, launch counters set to 0 at its start: a
   DispatchEngine (queue_depth 1024, breaker_threshold 3, the probe
   loop parked so that the phase drives `probe_once()`) with the
   `xla_device_breaker` alarm and a seeded DeviceFaultInjector; windows
   of 1,024 publishes (1 on `pfan/{k}/x`, 4 on `mfan/{g}/{v}`, the rest
   phase 5's mix), each held against the host oracle as phase 7's
   pairs are (counts, matched filters, every delivery). (a) One window
   in five batches, one transient fault at each leg (sync, match_begin,
   fanout_begin, fanout_finish, match_finish; every plan staled before
   each batch): no publisher sees it, the breaker stays closed,
   breaker_fallback_total and fanout_host_fallback_total move. (b)
   Sticky loss: trips within 3 windows with its alarm; then a new
   filter, a residual filter swapped for its same-skeleton twin (both
   subscribed) and another residual filter deleted; 8 windows with
   phase 7's churn served from the host, during which K1, K2, K5 and
   the two fused syncs launch nothing; a probe fails. (c) heal() and
   probe_once(): canary, device_resync (the fanout mirror re-uploaded),
   the full table sync, the verified canary, the close (each timed);
   the device residual mask equals the host's; 8 windows on the card
   with churn, the outage's mutations in each, every path kernel
   launched. (d) One match fetch stalled 5x past breaker_deadline_ms:
   counted once, served, breaker closed. (e) The mesh: one window, a
   sticky loss tripping within 3 windows, 2 degraded windows launching
   no mesh kernel, heal and probe_once (timed), a 256-topic canary equal
   to the host, 2 windows on the card launching K14, K16, K17 and the
   mesh sync; phase 5's churn between windows. Printed: each step's
   line, heal() to closed and device_resync + first full sync (single
   and mesh), degraded against on-card publishes/s (no claim), the
   phase's seconds and launches.
11. The publish path's observability, on phase 7's broker and phase 9's
   mesh broker (both at full width, nothing cut), launch counters set
   to 0 at its start, with `obs.Observability` attached (its flight
   bundles in a temporary folder, removed at the end). (a) 4 of phase
   7's windows with churn (held against the host oracle as phase 7's
   pairs are) at sample_n 15: at least 256 audits, all clean
   (audit_clean_total == audit_total, audit_total + skipped == the
   captured spans), plus one pfan and one mfan publish at a sampled
   tick (the 150k plan and a 2,048 plan audited); a histogram for every
   publish stage and delivery sub-stage; stage p50/p99 and the
   sum-to-wall self-check's out-of-band share printed. Then 2 turns of
   one window pair, with Observability at sample_n 1024 and without it
   (on, off; the same seeded windows): publishes/s, deliveries/s and the
   delivery walk's seconds each, with the "on" turn's flight triggers,
   profiler samples and tracked slow subscriptions, recorded, no
   limit. At sample_n 1
   from here: (b) `chaos_corrupt_rows` on one classed filter (8 new
   subscribers), a publish on a fresh matching topic: divergence 1, the
   filter quarantined, `xla_audit_divergence` active, an
   `audit_divergence` bundle naming it (kind "match"); one batched match
   launches `table_sync`, re-uploads the index (meta, slots, residual
   mask), unquarantines (1) and returns the filter (its milliseconds
   printed); the next publish delivers the oracle's count. (c) One
   client dropped from the cached `mfan/3/+` plan: a "fanout"
   divergence and quarantine; a synchronous publish while quarantined
   moves `audit_quarantine_resolve_refusals_total` and delivers in
   full; a batched match heals; the next publish is full. (d) (b) on
   phase 9's (2, 4) mesh broker: `mesh_table_sync`,
   `mesh_match_ids_hash` and `combine_pairs` launch. (e) A
   DeviceFaultInjector's sticky loss trips the breaker: a
   `device_breaker_trip` bundle and a `breaker.trip` ring event; heal()
   and probe_once(): `breaker.close`. (f) The scrape: each family once;
   the audit, stage, SLO and flight families present; its seconds. (g)
   A MemoryTracer: `mqtt.publish` -> `broker.route` + `broker.dispatch`
   with the reference's attributes. Fails on any condition, if a
   device-fault counter moves outside (e), if K1, K2, the table sync,
   K5 or the fanout sync never launched, or if the phase takes more than
   90 s.
12. Summary: one line per kernel (times, bound, launches, phase 10's
   and phase 11's launches, equal), the
   run's seconds and each phase's, one `{"kernels": [...]}` JSON line
   (`ms`, `plain_ms`, `library_ms` the device times; `call_ms`,
   `device_ms`, `plain_call_ms`, `library_call_ms` beside them; launches of K1, K2
   and the fused K3/K4 sync from phase 5 (K3 and K4 are two entries of
   the one fused record), of the dense-only K2 from phase 6, of K5, the fused
   K6/K7 sync and K12 from phase 7 (K5's two records both show K5's;
   K6 and K7 are two entries of the one fused record), of K8 from phase
   8's server rounds, of K14, K16, K17
   and the fused K13/K18 mesh table sync from phase 9's batches (its
   K13 apply_delta and K18 slot delta entries, three entries of the one
   record, count phase 9 (c)'s row-only and slot-only growth launches);
   K9-K11, K13's counts
   and packed and K15 are on no serve path and show 0; `launches_phase10`
   and `launches_phase11` beside it), then, as the last line, `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import gc
import json
import logging
import statistics
import subprocess
import sys
import time

DEVICE = "cuda"
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
REPEATS = 20  # calls of a single-call time
DEVICE_RUN = 50  # calls of a device-time run
HOLD_S = 0.25  # the longest the stream is held while the host enqueues a run
# spin-kernel cycles a second: at or above the H100's top SM clock, so a
# hold lasts at least as long as asked
SPIN_HZ = 2.0e9
# phase 7: the broker publish path
N_PFAN = 100_000
N_MFAN_GROUPS = 16
MFAN_GROUP = 2048
N_SHARED = 8
N_WINDOWS = 32
WINDOW = 1024
N_PFAN_PUBS = 4
N_MFAN_PUBS = 20
# the set-up churn's index, outside the pairs' 0..N_WINDOWS/2
SETUP_CHURN = -2
# phase 8: retained reads and the server (bench.py:1438 bench_retained's
# 1M names `dev/{g}/{k}/state`)
N_RET_GROUPS = 10_000
N_RET_PER_GROUP = 100
N_RET_SYS = 1024
RET_WAVES = (512, 4096)
# 4 timed waves per size and 256 clients keep the phase near two
# minutes of the run (8 and 512 took 181.6 s on an H100 80GB HBM3, 700 W)
N_TIMED_WAVES = 4
SPLIT_WAVE = 5000
N_CLIENTS = 256
N_SINGLE = 128
N_RH = 64
N_RET_CHURN = 256
SUB_FILTERS = 8
# phase 9: the sub-sharded mesh routing path on one card
MESH = (2, 4)
N_MESH_BATCHES = 16
DENSE_B = 64
MESH_ORACLE_TOPICS = 32
PLAIN_REPEATS = 3  # the plain versions of phase 9 are timed over 3 calls, both ways
ESCALATION_MH = 2  # phase 9's forced block capacity, below both legs' block totals
# phase 10: the device failure domain on phase 7's broker and phase 9's mesh
P10_THRESHOLD = 3  # the engine's breaker_threshold
P10_WINDOWS = 8  # degraded windows, then as many on the card after the close
P10_MESH_WINDOWS = 2
# a phase-10 window's pfan and mfan topics: it delivers ~110k times, a
# phase-7 window (4 and 20) ~440k, and the host's delivery walk bounds both
P10_PFAN_PUBS = 1
P10_MFAN_PUBS = 4
P10_CHURN_K = 1000  # broker_churn's index base, past phase 7's
# phase 11: the publish path's observability on phase 7's broker
P11_SAMPLE_N = 15  # 4 windows of 1,024 publishes -> 273 sampled spans
P11_WINDOWS = 4
# one window pair a turn, the same seeded windows in both; an "on" turn
# runs ~2.5x a pair's seconds, so two turns keep the phase near 60 s
P11_TURNS = ("on", "off")
P11_CHURN_K = 2000
P11_CHAIN_SUBS = 8
P11_LIMIT_S = 90.0
PROBE_PARKED_MS = 3_600_000.0  # the probe loop never wakes: the phase drives probe_once()
SINGLE_PATH = ("match_ids_hash", "match_ids", "table_sync", "resolve_fanout", "fanout_sync")
# filter classes (see ret_filter) and their shares: a wave's, a client's
WAVE_MIX = (("A", 70), ("B", 10), ("C", 10), ("D", 8), ("E", 1), ("F", 1))
CLIENT_MIX = (("A", 30), ("B", 15), ("C", 15), ("D", 15), ("F", 10), ("X", 15))


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def median_ms(fn, repeats: int = REPEATS) -> float:
    """A call's single-call time (`call_ms`): the median of `repeats`
    calls, each alone between two CUDA events on the current stream (one
    warm-up call first). With the card idle, the event pair also holds
    the host's enqueue of the call, which leads the reading of a small
    kernel."""
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


def run_ms(fn, n: int = DEVICE_RUN):
    """A call's device time (`device_ms`) and host enqueue time
    (`enqueue_ms`): n calls back to back between one pair of CUDA events,
    after a warm-up call, over n. A spin kernel first holds the stream
    for twice the host's enqueue time of the run (when that is at most
    HOLD_S), so the calls run back to back on the card and the run reads
    the card's time, not the host's; the enqueue time is the host clock
    over the same loop. A function that waits for the card inside (a
    plain version's nonzero) runs at the host's pace all the same."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    one_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if 2 * n * one_s <= HOLD_S:
        torch.cuda._sleep(int(2 * n * one_s * SPIN_HZ))
    a.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    enqueue_s = time.perf_counter() - t0
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n, 1e3 * enqueue_s / n


def timed(kernel, plain, library=None, plain_repeats: int = REPEATS,
          plain_run: int = DEVICE_RUN):
    """The times of a kernel record: for the kernel, its plain version
    and (where one PyTorch call computes the same function) that call,
    the single-call time (`*call_ms`), the device time and the host
    enqueue time of a run (`*device_ms`, `*enqueue_ms`). `ms`,
    `plain_ms` and `library_ms` are the device times."""
    rec = {}
    for key, fn, repeats, n in (("", kernel, REPEATS, DEVICE_RUN),
                                ("plain_", plain, plain_repeats, plain_run),
                                ("library_", library, REPEATS, DEVICE_RUN)):
        if fn is None:
            rec.update({f"{key}ms": None, f"{key}call_ms": None,
                        f"{key}device_ms": None, f"{key}enqueue_ms": None})
            continue
        rec[f"{key}call_ms"] = median_ms(fn, repeats)
        rec[f"{key}device_ms"], rec[f"{key}enqueue_ms"] = run_ms(fn, n)
        rec[f"{key}ms"] = rec[f"{key}device_ms"]
    return rec


def launch_breakdown(fn, calls: int = 10) -> str:
    """Device microseconds per call of each kernel a wrapper launches,
    by torch.profiler over `calls` calls, largest first, each with the
    number of its events in the trace; then the same calls' time a call
    between two CUDA events recorded inside the trace. A trace can come
    back short: with no device activity, or with fewer events of a
    kernel than calls (seen in phase 9 (a)'s first traces), so
    a trace in which some kernel has fewer than `calls` events is taken
    again, up to three times in all, and the line says how many it
    took. Every wrapper traced here launches each of its kernels once a
    call."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            a.record()
            for _ in range(calls):
                fn()
            b.record()
            torch.cuda.synchronize()
        rows = sorted(((ev.device_time_total / calls, ev.count,
                        re.search(r"(\w+(?:<\w+>)?)\(", ev.key), ev.key)
                       for ev in prof.key_averages() if ev.device_time_total),
                      reverse=True, key=lambda r: r[0])
        if rows and min(n for _us, n, _m, _key in rows) >= calls:
            break
    traced = ", ".join(f"{m.group(1) if m else key} {us:.3f} ({n} events)"
                       for us, n, m, key in rows) or "no trace"
    return (f"{traced} (events: {1e3 * a.elapsed_time(b) / calls:.3f} us a call; "
            f"trace {attempt} of 3)")


def set_bounds(recs) -> None:
    """Each record's bound: the larger of its bytes over the card's
    memory rate and its operations over its peak rate, and which."""
    for r in recs.values():
        t_bytes = r["bytes"] / H100_BYTES_PER_S
        t_ops = r["ops"] / H100_OPS_PER_S
        r["bound_ms"] = 1e3 * max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"


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


def skeleton_filters(rng, n_skeletons=N_SKELETONS):
    """n_skeletons distinct (plen, '+' positions, '#') skeletons over
    levels 3..12, PER_SKELETON filters each with distinct literals."""
    seen = set()
    skels = []
    while len(skels) < n_skeletons:
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


def add_route_set(router, rng):
    """The slice's route set, through the cluster-route storm path
    (Router.add_routes). Returns (skeleton filters, exact topics, host
    seconds)."""
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
    return skel, exact, time.perf_counter() - t0


def build_router(rng, device, use_hash_index=True):
    from emqx_tpu_torch.models.router import Router

    router = Router(max_levels=16, device=device, use_hash_index=use_hash_index)
    skel, exact, host_s = add_route_set(router, rng)
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


# --- the native host cores against their twins (before phase 3) -------------------

NATIVE_ROUTES = 1 << 16
NATIVE_ROUNDS = 3
NATIVE_LEDGER_OPS = 20_000
NATIVE_TOPICS = 64
# too deep for max_levels 16: the host-only deep stores
DEEP_FILTER = "/".join(["z"] * 20) + "/#"
DEEP_EXACT = "/".join(["q"] * 20)


def native_route_ops(rng, n_routes, skel, rounds=NATIVE_ROUNDS):
    """The native check's seeded storm, as calls (method name, argument
    tuple): the set-up (n_routes of the slice's pattern in four
    add_routes batches, the skeleton filters, $SYS filters, exact
    topics, too-deep filters and topics), then `rounds` churn rounds of
    single and batched deletes and adds (refcounted duplicates, new
    dests on live filters, exact topics, the too-deep stores coming
    and going) and single skeleton swaps. Returns (set-up calls, a list
    of each round's calls, topics that hit every kind)."""
    pat = lambda i: (f"t{i % 997}/r{i % 13}/d{i}/+/m/#", f"n{i % 7}")  # noqa: E731
    exact = [f"e/{k}/v" for k in range(N_EXACT)]
    q = max(1, n_routes // 4)
    setup = [("add_routes", ([pat(i) for i in range(lo, min(n_routes, lo + q))],))
             for lo in range(0, n_routes, q)]
    setup += [("add_routes", ([(f, "s") for f in skel],)),
              ("add_routes", ([("$SYS/brokers/+/stats", "sys"), ("$SYS/#", "sys")],)),
              ("add_routes", ([(t, f"x{k % 3}") for k, t in enumerate(exact)]
                              + [(DEEP_FILTER, "deep"), (DEEP_EXACT, "deep")],))]
    have = set(skel)
    rounds_out = []
    for r in range(rounds):
        calls = []
        for i in rng.integers(0, n_routes, 200).tolist():
            calls += [("delete_route", pat(i)), ("add_route", pat(i))]
        idx = rng.integers(0, n_routes, 2000).tolist()
        calls.append(("delete_routes", ([pat(i) for i in idx],)))
        re_add = [pat(i) for i in idx] + [pat(i) for i in idx[:100]]
        re_add += [(pat(i)[0], "n9") for i in idx[100:300]]  # a new dest on a live filter
        calls.append(("add_routes", (re_add,)))
        calls.append(("delete_routes", ([(pat(i)[0], "n9") for i in idx[100:200]],)))
        for j in rng.integers(0, len(skel), 64).tolist():
            f = skel[j]
            old, new = (f, swap_of(f)) if f in have else (swap_of(f), f)
            have.discard(old)
            have.add(new)
            calls += [("delete_route", (old, "s")), ("add_route", (new, "s"))]
        ex = rng.integers(0, N_EXACT, 20).tolist()
        calls.append(("delete_routes", ([(exact[k], f"x{k % 3}") for k in ex],)))
        calls += [("add_route", (exact[k], f"y{r}")) for k in ex]
        if r % 2 == 0:
            calls += [("delete_route", (DEEP_FILTER, "deep")),
                      ("delete_routes", ([(DEEP_EXACT, "deep")],)),
                      ("add_route", ("$SYS/brokers/+/clients", "sys"))]
        else:
            calls += [("add_route", (DEEP_FILTER, "deep")),
                      ("add_routes", ([(DEEP_EXACT, "deep")],)),
                      ("delete_route", ("$SYS/brokers/+/clients", "sys"))]
        rounds_out.append(calls)
    topics = [instantiate(pat(int(i))[0], rng) for i in rng.integers(0, n_routes, NATIVE_TOPICS // 2)]
    topics += [instantiate(skel[int(j)], rng) for j in rng.integers(0, len(skel), NATIVE_TOPICS // 4)]
    topics += ["$SYS/brokers/n1/stats", "$SYS/brokers/n2/clients", exact[0], exact[-1],
               DEEP_EXACT, DEEP_FILTER.replace("#", "x/y"), "nomatch/1/zz"]
    return setup, rounds_out, topics


def run_calls(router, calls):
    """Apply calls to a router; returns, call by call, whether its
    route-set generation moved."""
    moved = []
    for name, args in calls:
        g = router.generation
        getattr(router, name)(*args)
        moved.append(router.generation != g)
    return moved


def _word_table(vocab, plus):
    """Word id -> word (or '+'), as an object array indexed by id."""
    import numpy as np

    out = np.full(max(vocab._next, plus + 1), "", dtype=object)
    for i, w in vocab._words.items():
        out[i] = w
    out[plus] = "+"
    return out


def churn_state(router, strict_classes=True):
    """Everything the route write path leaves behind, keyed by filter
    strings and words instead of row, word, class, bucket and slot ids
    (those follow arrival order, which the batched twin and the churn
    core walk differently), after each structure's own invariants hold:
    the table (live filters' words, '#' and root flags, free rows), the
    vocab (each word's refcount, the next id, the free ids), the class
    index (each filter's bucket, its class's skeleton, the bucket's
    cuckoo slot, fingerprint and probe byte, every h1/fp against the
    host hash, `_skel_packed` against `_skel_class`, the residual rows),
    the dest store after `_fanout_flush` (each filter's live edges in
    order), the host-only deep stores and the routes. With
    `strict_classes` False (a class budget that a batch exhausts: which
    skeletons get a class then follows arrival order) the skeletons
    and the residual set are left out of the comparison; their
    invariants are still held."""
    import numpy as np

    t = router.table
    v = t.vocab
    plus = sys.modules[type(v).__module__].PLUS
    cap = t.capacity
    live = np.flatnonzero(t.active[:cap])
    live_l = live.tolist()
    assert len(live_l) == len(t) == cap - len(t._free), "table counts"
    assert sorted(live_l + list(t._free)) == list(range(cap)), "table free list"
    words = t.words[live]
    plen = t.prefix_len[live].astype(np.int64)
    in_prefix = np.arange(t.max_levels)[None, :] < plen[:, None]
    assert not words[~in_prefix].any(), "padding"
    dec = _word_table(v, plus)[words]
    hh_l = t.has_hash[live].tolist()
    rw_l = t.root_wild[live].tolist()
    rows = {}
    for i, r in enumerate(live_l):
        f = t._fstr[r]
        ws = dec[i, :plen[i]].tolist() + (["#"] if hh_l[i] else [])
        assert "/".join(ws) == f, f
        assert t._filters[r] is None or t._filters[r] == tuple(f.split("/")), f
        assert f not in rows, f"{f} on two rows"
        rows[f] = (hh_l[i], rw_l[i])
    fr, xr = router._filter_row, router._exact_row
    assert len(fr) + len(xr) == len(live_l), "filter rows"
    assert all(fr.get(t._fstr[r], xr.get(t._fstr[r])) == r for r in live_l), "filter rows"
    rf = router._row_filter
    assert all(rf[r] == t._fstr[r] for r in live_l), "row filters"
    assert sum(x is not None for x in rf) == len(live_l), "row filters"
    refs = {w: int(v._refs[i]) for w, i in v._ids.items()}
    assert v._words == {i: w for w, i in v._ids.items()}, "vocab words"
    assert not set(v._free) & set(v._words), "vocab free ids"
    out = {
        "table": rows, "vocab": (refs, v._next, len(v._free)),
        "exact": {f: dict(d) for f, d in router._exact.items()},
        "wild": {f: dict(d) for f, d in router._wild.items()},
        "deep": {f: dict(d) for f, d in router._deep.items()},
        "exact_deep": sorted(router._exact_deep),
        "deep_trie": sorted(router._deep_trie.match(tuple(DEEP_FILTER.split("/")[:-1]) + ("x",))),
    }
    ix = router.index
    if ix is not None:
        hmod = sys.modules[type(ix).__module__]
        skel_of = {cid: sk for sk, cid in ix._skel_class.items()}
        assert ix._skel_packed == {p | (int(h) << 6) | (pm << 7): c
                                   for (p, h, pm), c in ix._skel_class.items()}, "_skel_packed"
        assert sorted(np.flatnonzero(ix.meta.active).tolist()) == sorted(skel_of), "meta.active"
        for cid, (p, h, pm) in skel_of.items():
            assert (int(ix.meta.plen[cid]), bool(ix.meta.has_hash[cid]),
                    int(ix.meta.plus[cid])) == (p, h, pm), "class meta"
        rb = ix._row_bucket[live]
        bucketed = rb >= 0
        bids = rb[bucketed]
        assert len(np.unique(bids)) == len(bids) == ix._live == len(ix._bucket_of), "buckets"
        assert int((ix.slots.bucket >= 0).sum()) == ix._live, "live slots"
        brow = live[bucketed]
        bflt = [t._fstr[r] for r in brow.tolist()]
        bid_l = bids.tolist()
        assert all(ix._bucket_of[f] == b for f, b in zip(bflt, bid_l)), "bucket of"
        assert all(list(ix.bucket_rows(b)) == [r]
                   for b, r in zip(bid_l, brow.tolist())), "bucket rows"
        assert all((w if type(w) is str else "/".join(w)) == f
                   for w, f in zip((ix._bkt_ws[b] for b in bid_l), bflt)), "bucket words"
        cids = ix._bkt_cid[bids]
        bw = words[bucketed].astype(np.int64)
        xs = np.where(in_prefix[bucketed] & (bw != plus), bw + 1, 0).astype(np.uint32)
        h1, fp = hmod._hash_host_batch(cids.astype(np.uint32), xs)
        assert np.array_equal(h1, ix._bkt_h1[bids]) and np.array_equal(fp, ix._bkt_fp[bids]), "hash"
        slot = ix._bkt_slot[bids]
        assert (slot >= 0).all() and np.array_equal(ix.slots.bucket[slot], bids), "slots"
        assert np.array_equal(ix.slots.fp[slot], fp), "slot fingerprints"
        per_class = np.bincount(cids, minlength=len(ix._class_buckets))
        assert all(int(ix._class_buckets[c]) == int(per_class[c]) for c in skel_of), "class buckets"
        assert per_class.sum() == per_class[list(skel_of)].sum(), "retired classes"
        lanes = ix.slots.bucket.reshape(-1, hmod.BUCKET_W) >= 0
        w = np.where(lanes, np.maximum(ix.slots.fp.reshape(-1, hmod.BUCKET_W) >> 24, 1), 0)
        probe = (w.astype(np.uint32) << (8 * np.arange(hmod.BUCKET_W, dtype=np.uint32))).sum(1)
        assert np.array_equal(probe.astype(np.uint32), ix.slots.probe), "probe words"
        residual = sorted(t._fstr[r] for r in ix.residual_rows)
        assert len(residual) + len(bid_l) == len(live_l), "indexed rows"
        assert (ix._row_bucket[list(ix.residual_rows)] < 0).all(), "residual rows"
        if strict_classes:
            out["index"] = ({f: skel_of[c] for f, c in zip(bflt, cids.tolist())}, residual)
    ds = router.dest_store
    router._fanout_flush(live_l)
    assert not ds.pending_rows, "pending rows"
    edges = {}
    for f, row in list(fr.items()) + list(xr.items()):
        slots = ds._slots[row] if row < ds.row_capacity else None
        off = int(ds.seg_off[row]) if slots else 0
        order = sorted((k, d) for d, k in (slots or {}).items())
        edges[f] = [(d, int(ds.edge_opts[off + k])) for k, d in order]
        assert not slots or int(ds.seg_live[row]) == len(order), f
    out["dest_store"] = edges
    out["routes"] = sorted(map(repr, router.routes()))
    return out


class DeltaCapture:
    """Records, while entered, every table delta the port stages (a
    DeviceTable's `stage_table_delta`, a ShardedDeviceTable's
    `pack_table_delta`): its live rows keyed by filter (words, '#',
    root flag and, with `strict_classes`, the residual byte), its dead
    rows and its slot entries, for the router `self.router`."""

    def __init__(self, strict_classes=True):
        self.strict = strict_classes
        self.router = None
        self.deltas = []

    def _note(self, host, rows, slots, sids, residual_rows):
        t = self.router.table
        plus = sys.modules[type(t.vocab).__module__].PLUS
        table = _word_table(t.vocab, plus)
        live, dead = [], 0
        for r in rows.tolist():
            if not host.active[r]:
                dead += 1
                continue
            plen = int(host.prefix_len[r])
            ent = (t._fstr[r], tuple(table[host.words[r, :plen]].tolist()),
                   bool(host.has_hash[r]), bool(host.root_wild[r]))
            if self.strict and residual_rows is not None:
                ent += (r in residual_rows,)
            live.append(ent)
        self.deltas.append((sorted(live), dead, len(sids)))

    def __enter__(self):
        from emqx_tpu_torch.models import router as router_mod
        from emqx_tpu_torch.parallel import sharded_match

        self._real = (router_mod.stage_table_delta, sharded_match.pack_table_delta)
        real_stage, real_pack = self._real

        def stage(host, rows, slots, sids, residual_rows, device):
            self._note(host, rows, slots, sids, residual_rows)
            return real_stage(host, rows, slots, sids, residual_rows, device)

        def pack(host, rows, slots, sids, residual_rows):
            self._note(host, rows, slots, sids, residual_rows)
            return real_pack(host, rows, slots, sids, residual_rows)

        router_mod.stage_table_delta = stage
        sharded_match.pack_table_delta = pack
        return self

    def __exit__(self, *exc):
        from emqx_tpu_torch.models import router as router_mod
        from emqx_tpu_torch.parallel import sharded_match

        router_mod.stage_table_delta, sharded_match.pack_table_delta = self._real
        return False


def _tensors(x):
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _tensors(y)]
    return []


def delta_equals_full_upload(router) -> None:
    """The router's device table, brought up to date by its delta syncs,
    equals a fresh table's full upload of the same host state (rows,
    residual mask, class metadata and slot arrays): a dirty row or slot
    that never reached a staged delta shows here."""
    import torch

    dt = router.device_table
    fresh = type(dt)(router.table, router.mesh, index=router.index) if router.mesh is not None \
        else type(dt)(router.table, device=dt.device, index=router.index)
    fresh.sync()
    for name in ("_dev", "_dev_meta", "_dev_slots", "_dev_residual"):
        a, b = _tensors(getattr(dt, name)), _tensors(getattr(fresh, name))
        assert len(a) == len(b), name
        for x, y in zip(a, b):
            assert x.shape == y.shape and torch.equal(x, y), f"{name} differs from a full upload"


def native_router_run(router, setup, rounds, topics, capture, strict_classes=True,
                      every_round=False):
    """Drive one router through the storm with its device table synced
    after the set-up and after every round; returns its generation
    moves, staged deltas, states (`churn_state` after the last round, or
    after each with `every_round`) and answers (device batch and host
    path, per round). A round's delta is None where the
    round grew the table (a full upload of the rows)."""
    capture.router = router
    moved = run_calls(router, setup)
    router.device_table.sync()
    states, answers, deltas = [], [], []
    for calls in rounds:
        moved += run_calls(router, calls)
        n0 = len(capture.deltas)
        grew = router.table.grew
        router.device_table.sync()
        assert len(capture.deltas) <= n0 + 1
        # a growth sync uploads the rows whole (the mesh still stages
        # its slots): no row delta
        deltas.append(None if grew or len(capture.deltas) == n0 else capture.deltas[n0])
        delta_equals_full_upload(router)
        if every_round or len(states) == len(rounds) - 1:
            states.append(churn_state(router, strict_classes))
        else:
            states.append(None)
        answers.append(([sorted(x) for x in router.match_filters_batch(topics)],
                        [sorted(router.match_filters(t)) for t in topics]))
    return moved, deltas, states, answers


def native_twin_routers(n_routes=NATIVE_ROUTES, seed=0, device="cpu", mesh=None,
                        n_skeletons=N_SKELETONS, rounds=NATIVE_ROUNDS, every_round=False):
    """The churn core against its twin: one Router with the native core
    (the default) and one with the twin, through the same seeded storm;
    their generation moves call for call, their staged deltas (live
    rows by filter), their states after every round (`churn_state`)
    and their answers must be equal. A class budget smaller than the
    storm's skeletons (`n_skeletons` past the class budget, as phase 3's
    600) leaves the class assignment out (`churn_state`). Returns a
    summary dict."""
    import numpy as np

    from emqx_tpu_torch.models.router import Router
    from emqx_tpu_torch.ops import speedups
    from emqx_tpu_torch.ops.hash_index import DEFAULT_CLASS_BUDGET

    rng = np.random.default_rng(seed)
    skel = skeleton_filters(rng, n_skeletons)
    setup, rounds_calls, topics = native_route_ops(rng, n_routes, skel, rounds)
    # the storm's other skeletons: the route pattern, $SYS, exact topics
    strict = n_skeletons + 8 <= DEFAULT_CLASS_BUDGET
    runs = []
    for native in (True, False):
        speedups.set_native_enabled(native)
        try:
            r = Router(max_levels=16, device=device, mesh=mesh)
        finally:
            speedups.set_native_enabled(True)
        assert (r._sp is not None) == native
        cap = DeltaCapture(strict)
        t0 = time.perf_counter()
        with cap:
            run = native_router_run(r, setup, rounds_calls, topics, cap, strict, every_round)
        runs.append((*run, time.perf_counter() - t0, r))
    (m_n, d_n, s_n, a_n, sec_n, rn), (m_t, d_t, s_t, a_t, sec_t, rt) = runs
    assert m_n == m_t, "generation moves differ"
    for k, (x, y) in enumerate(zip(s_n, s_t)):
        for key in x or ():
            assert x[key] == y[key], f"round {k}: {key} differs"
    assert a_n == a_t, "answers differ"
    # a round where one side grew its table (the reserve chunk grows
    # earlier) re-uploaded whole there: its delta has no counterpart
    pairs = [(x, y) for x, y in zip(d_n, d_t) if x is not None and y is not None]
    for x, y in pairs:
        assert x[0] == y[0], "staged live rows differ"
    return {"routes": len(rn.table), "calls": len(m_n), "strict_classes": strict,
            "deltas": len(pairs), "delta_rows": sum(len(x[0]) + x[1] for x, _ in pairs),
            "native_s": round(sec_n, 3), "twin_s": round(sec_t, 3),
            "capacity": (rn.table.capacity, rt.table.capacity),
            "n_buckets": (rn.index.n_buckets, rt.index.n_buckets),
            "residual_rows": (len(rn.index.residual_rows), len(rt.index.residual_rows))}


def ledger_fuzz(ledgers, n_ops=NATIVE_LEDGER_OPS, seed=0x19):
    """A seeded fuzz over the delivery ledger's whole surface (the
    reference's tests/test_delivery_engine.py fuzz), every op run on
    every ledger: each result and, every 50 ops and at the end, each
    slot's dump must be equal across them. Slot ids are each ledger's
    own (free-list order). Returns the ops run."""
    import random

    rng = random.Random(seed)
    phases = (0, 1, 2)  # PUBACK, PUBREC, PUBCOMP
    slots = []

    def op(name, pair, *args):
        got = [getattr(led, name)(s, *args) for led, s in zip(ledgers, pair)]
        assert all(g == got[0] for g in got), (name, args, got)
        return got[0]

    def dump(pair):
        got = [led.dump(s) for led, s in zip(ledgers, pair)]
        assert all(g == got[0] for g in got), got
        return got[0]

    for _ in range(4):
        slots.append(tuple(led.open() for led in ledgers))
    now = 100.0
    for step in range(n_ops):
        now += rng.random()
        roll = rng.random()
        if roll < 0.04 and len(slots) < 8:
            slots.append(tuple(led.open() for led in ledgers))
        elif roll < 0.06 and len(slots) > 1:
            pair = rng.choice(slots)
            for led, s in zip(ledgers, pair):
                led.close(s)
            slots.remove(pair)
        pair = rng.choice(slots)
        roll = rng.random()
        if roll < 0.35:
            op("reserve", pair, rng.choice((1, 2)), now, rng.choice((1, 2, 4, 32)))
        elif roll < 0.42:
            n = rng.randrange(1, 6)
            qos = [rng.choice((1, 2)) for _ in range(n)]
            rmax = [rng.choice((2, 4, 32)) for _ in range(n)]
            got = [led.reserve_many([s] * n, qos, now, rmax) for led, s in zip(ledgers, pair)]
            assert all(g == got[0] for g in got), ("reserve_many", got)
        elif roll < 0.55:
            infl = dump(pair)[1]
            if infl and rng.random() < 0.8:
                pid, phase, _, _ = rng.choice(infl)
                kind = phase if rng.random() < 0.7 else rng.choice(phases)
            else:
                pid, kind = rng.randrange(1, 0x10000), 0
            op("ack", pair, pid, kind)
        elif roll < 0.62:
            infl = dump(pair)[1]
            op("forget", pair, infl[0][0] if infl else rng.randrange(1, 0x10000))
        elif roll < 0.70:
            op("retry_due", pair, now, rng.choice((0.0, 5.0, 1e9)))
        elif roll < 0.74:
            op("touch_all", pair, now)
        elif roll < 0.90:
            op("enqueue", pair, rng.randrange(0, 8), rng.choice((0, 0, 1, 2)),
               rng.choice((2, 4, 8)), rng.choice((0, 1)))
        elif roll < 0.96:
            op("popleft", pair)
        else:
            op("window_len", pair)
        if step % 50 == 0:
            for p in slots:
                dump(p)
    for p in slots:
        dump(p)
    return n_ops


def frame_corpus(pk):
    """The codec's corpus over a packet module `pk` (the port's or the
    reference's broker/packet.py): v4/v5 PUBLISH at QoS 0-2 (empty,
    wide, multi-byte remaining lengths, UTF-8 topics, retain and dup),
    the PUBACK family with and without reason codes, SUBACK, and a
    PUBLISH with properties (outside the native surface)."""
    return [
        pk.Publish(topic="t", payload=b"", qos=0),
        pk.Publish(topic="a/b/c", payload=b"x" * 200, qos=1, packet_id=1),
        pk.Publish(topic="t/\u00e9/\u2206", payload=bytes(range(256)), qos=2, retain=True,
                   dup=True, packet_id=0xFFFF),
        pk.Publish(topic="big", payload=b"p" * 20000, qos=0),
        pk.Publish(topic="w", payload=b"q" * 130, qos=1, packet_id=77),
        pk.Publish(topic="$SYS/brokers/n1/stats", payload=b"{}", qos=2, packet_id=9),
        pk.Puback(pk.Type.PUBACK, 1, 0),
        pk.Puback(pk.Type.PUBREC, 0xFFFF, 0x80),
        pk.Puback(pk.Type.PUBREL, 515, 0x92),
        pk.Puback(pk.Type.PUBCOMP, 7, 0),
        pk.Suback(9, [0, 1, 2, 0x80]),
        pk.Suback(0xFFFF, [0]),
        pk.Publish(topic="p", payload=b"x", qos=1, packet_id=3,
                   props={"message_expiry_interval": 30}),
    ]


# malformed and truncated wire input: QoS 3, a 5-byte remaining length,
# a PUBLISH whose topic runs past its frame, a packet id of 0, a PUBACK
# of the wrong length, and a frame past the parser's size limit
MALFORMED = (b"\x36\x02\x00\x05", b"\x30\xff\xff\xff\xff\x01",
             b"\x32\x04\x00\x09ab", b"\x32\x05\x00\x01a\x00\x00",
             b"\x40\x01\x00", b"\x30\x7f" + b"\x00\x01a" + b"x" * 124)


def _parsed(p):
    return (type(p).__name__, tuple(sorted((k, repr(v)) for k, v in vars(p).items()
                                           if not k.startswith("_"))))


def frame_results(codec, pyframe, pk):
    """Every result of one codec over the corpus, as comparable values:
    the wire bytes of each packet at v4 and v5; the packets parsed back
    from the whole stream fed in seeded chunks, and from each frame cut
    short; each malformed input's FrameError (message and reason code)."""
    import random

    out = []
    corpus = frame_corpus(pk)
    for ver in (pk.MQTT_V4, pk.MQTT_V5):
        wires = [codec.serialize(p, ver) for p in corpus]
        out.append(wires)
        decodable = [w for w, p in zip(wires, corpus)
                     if ver == pk.MQTT_V5 or not getattr(p, "props", None)]
        rng = random.Random(7)
        wire = b"".join(decodable)
        parser = codec.Parser(proto_ver=ver)
        got, i = [], 0
        while i < len(wire):
            j = min(len(wire), i + rng.randrange(1, 700))
            got.extend(parser.feed(wire[i:j]))
            i = j
        out.append([_parsed(p) for p in got])
        for w in decodable:
            out.append([_parsed(p) for p in codec.Parser(proto_ver=ver).feed(w[:-1])])
        for bad in MALFORMED:
            parser = codec.Parser(proto_ver=ver, max_packet_size=100)
            try:
                out.append(("parsed", [_parsed(p) for p in parser.feed(bad)]))
            except pyframe.FrameError as e:
                out.append(("error", str(e), e.code))
    return out


class ChurnCoreWatch:
    """From the port's own state, whether the native churn core served
    every route write since the last `line()`: every Router built
    since then took the core at construction (`_sp`), every Router
    holding routes has a live churn handle, and no twin leg ran (each
    twin leg of add_route, add_routes, delete_route and delete_routes
    calls `_drop_native_state` first; the watch counts those calls)."""

    def __init__(self):
        import weakref

        from emqx_tpu_torch.models.router import Router

        self.twin_legs = 0
        self._refs = []
        self._seen = 0
        real_drop, real_init = Router._drop_native_state, Router.__init__

        def drop(router):
            self.twin_legs += 1
            real_drop(router)

        def init(router, *a, **k):
            real_init(router, *a, **k)
            self._refs.append(weakref.ref(router))

        Router._drop_native_state = drop
        Router.__init__ = init

    def line(self, where: str) -> str:
        new = self._refs[self._seen:]
        self._seen = len(self._refs)
        live = [r for r in (w() for w in self._refs) if r is not None]
        holding = [r for r in live if r.topic_count()]
        if self.twin_legs:
            raise AssertionError(f"{where}: {self.twin_legs} route writes took the twin")
        if any(w() is not None and w()._sp is None for w in new):
            raise AssertionError(f"{where}: a Router was built without the churn core")
        if any(r._churn_handle is None for r in holding):
            raise AssertionError(f"{where}: a Router holding routes has no churn handle")
        return (f"churn core ({where}): {len(new)} routers built with it, "
                f"{len(holding)} holding routes, each with a live handle; twin legs "
                f"{self.twin_legs}")


def native_checks(card):
    """Before phase 3: the native host cores against their twins, on this
    machine's own build (its compiler, its Python): the churn core at
    NATIVE_ROUTES routes of the slice's pattern with phase 3's skeleton
    filters (600, past the class budget) and at 16,384 routes with 100
    skeletons (every class compared), `native_twin_routers` each; the
    delivery ledger's seeded fuzz; the frame corpus (`frame_results`)
    through the native codec and the Python one. Prints one line."""
    from emqx_tpu_torch import framec
    from emqx_tpu_torch.broker import delivery, frame, packet

    t0 = time.perf_counter()
    full = native_twin_routers()
    strict = native_twin_routers(n_routes=1 << 14, n_skeletons=100)
    t_routes = time.perf_counter() - t0
    n_ops = ledger_fuzz([delivery.NativeDeliveryLedger(delivery._load()),
                         delivery.PyDeliveryLedger()])
    m = framec.FRAME_METRICS
    before = m.snapshot()
    got = frame_results(framec, frame, packet)
    enc, dec = m.native_encodes - before["native_encodes"], m.native_decodes - before["native_decodes"]
    want = frame_results(frame, frame, packet)
    if got != want:
        raise AssertionError("the native frame codec disagrees with the Python codec")
    if not enc or not dec:
        raise AssertionError(f"the frame corpus never reached the native codec ({enc}, {dec})")
    errors = sum(isinstance(x, tuple) and x[0] == "error" for x in got)
    log(f"native vs twin: churn core equal at {json.dumps(full)} and {json.dumps(strict)} "
        f"({t_routes:.3f} s); ledger fuzz {n_ops} ops equal; frame corpus {len(got)} results "
        f"equal ({errors} FrameErrors; native encodes {enc}, decodes {dec}) in "
        f"{time.perf_counter() - t0:.3f} s [{card}]")


def codec_counts():
    """The frame codec's and the delivery ledger's counters."""
    from emqx_tpu_torch import framec
    from emqx_tpu_torch.broker import delivery

    return {**framec.FRAME_METRICS.snapshot(), **delivery.DELIVERY_METRICS.snapshot()}


def codec_line(before, where: str, need_sessions: bool = True, need_frames: bool = True) -> str:
    """The codec's and the ledger's counts since `before` (codec_counts);
    raises if a session bound the twin ledger, and unless (with
    `need_sessions`) a session bound the native one and (with
    `need_frames`) the native codec both encoded and decoded."""
    now = codec_counts()
    d = {k: now[k] - before[k] for k in now if k != "native_enabled"}
    if now["sessions_python"]:
        raise AssertionError(f"{where}: {now['sessions_python']} sessions bound the twin ledger")
    if need_sessions and d["sessions_native"] <= 0:
        raise AssertionError(f"{where}: no session bound the native ledger")
    if need_frames and (d["native_encodes"] <= 0 or d["native_decodes"] <= 0):
        raise AssertionError(f"{where}: the native codec did not serve ({d})")
    return (f"native cores ({where}): sessions_native {d['sessions_native']}, "
            f"sessions_python {d['sessions_python']}; frames native encodes "
            f"{d['native_encodes']}, decodes {d['native_decodes']}, fallback encodes "
            f"{d['fallback_encodes']}, decodes {d['fallback_decodes']}")


# --- kernel checks -------------------------------------------------------------


def check_kernels(router, skel, topics, rng):
    """Phase 4: each kernel against its plain version on the same CUDA
    inputs at the slice's shapes. Returns the per-kernel records."""
    import torch

    from emqx_tpu_torch.ops import hash_index as H
    from emqx_tpu_torch.ops import match as M
    from emqx_tpu_torch.ops.table import next_pow2

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
    k1_cases = match_ids_hash_edge_cases(meta, slots, denc, mh)
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
        **timed(lambda: H.match_ids_hash(meta, slots, denc, max_hits=mh),
                lambda: H.match_ids_hash_ref(meta, slots, denc, max_hits=mh)),
        bytes=bytes_k1, ops=ops_k1, err=err,
        shape=f"B={B} C={C} buckets={int(slots.probe.shape[0])} max_hits={mh} "
              f"total={total} amb={int(got[3])}; equal also at max_hits {small} and "
              f"{next_pow2(total)}, and at its edge cases: {'; '.join(k1_cases)}; "
              f"its launches, device us a call: "
              + launch_breakdown(lambda: H.match_ids_hash(meta, slots, denc, max_hits=mh)),
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
            **timed(lambda: M.match_ids(filters, denc, max_hits=mh2),
                    lambda: M.match_ids_ref(filters, denc, max_hits=mh2)),
            bytes=bytes_k2, ops=ops_k2, err=err,
            shape=f"B={B} N={N} L={L} active={n_act} max_hits={mh2} "
                  f"total={int(got[2])} written={hits2}; its launches, device us a call: "
                  + launch_breakdown(lambda: M.match_ids(filters, denc, max_hits=mh2)),
        )
    cases = match_ids_edge_cases(dt.filters(), denc, int(got[2]))
    recs["match_ids_dense_only"]["shape"] += "; edge cases equal: " + "; ".join(cases)

    # K3/K4: the fused table sync on phase 5's churn delta and its edges
    recs["table_sync"] = table_sync_checks(router, skel, rng, dev)
    torch.cuda.synchronize()
    set_bounds(recs)
    return recs


def i32(tables):
    """uint32 tables as their int32 bits (max_abs_err widens to int64)."""
    import torch

    return [x.view(torch.int32) if x.dtype == torch.uint32 else x for x in tables]


def table_sync_checks(router, skel, rng, dev):
    """The fused K3/K4 table sync against its plain version, exactly, and
    every table (the five filter columns, the three slot arrays, the
    residual mask) against the host arrays (`t.snapshot()`, `ix.slots`,
    a mask from `ix.residual_rows`): phase 5's churn delta (one churn
    round, as each of its syncs sees: both sides, with the residual
    bytes), rows only, slots only,
    and with ids past both tables, on copies of the stale device state;
    1 and 1,025 entries a side and the full table (every row and slot)
    on copies of the host truth with those entries scrambled. Then the
    reference-shaped `scatter_rows`/`scatter_slots` on the delta's [nb,
    K] padded batches. The churn delta is timed against nine
    `index_copy_` calls on the same staged views (ids widened to int64
    once, outside the timing); its bound counts each row entry's 12 +
    4L bytes read and 8 + 4L written, each slot entry's 16 read and 12
    written. The delta stays dirty for phase 5's first sync. Returns the
    record."""
    import numpy as np
    import torch

    from emqx_tpu_torch.device import to_device
    from emqx_tpu_torch.models import router as R
    from emqx_tpu_torch.ops import transfer as T
    from emqx_tpu_torch.ops.hash_index import BUCKET_W, SlotArrays
    from emqx_tpu_torch.ops.table import EncodedFilters, pad_pow2_batches

    dt = router.device_table
    t, ix = router.table, router.index
    dt.sync()
    churn(router, skel, rng)
    if t.grew or ix.rebuilt:
        raise AssertionError("phase 5's churn grew the table or rebuilt the index")
    rows = np.unique(np.asarray(t.dirty, np.int32))
    sids = np.unique(np.asarray(ix.dirty_slots, np.int32))
    host, hslots = t.snapshot(), ix.slots
    N, L = host.words.shape
    S = len(hslots.fp)
    mask = np.zeros(N, bool)
    mask[list(ix.residual_rows)] = True
    truth = ([to_device(a, dev) for a in host] + [to_device(a, dev) for a in hslots]
             + [to_device(mask, dev)])
    stale = list(dt.filters()) + list(dt.hash_state()[1]) + [dt._dev_residual]
    none = np.zeros(0, np.int32)

    def split(tables):
        return EncodedFilters(*tables[:5]), SlotArrays(*tables[5:8]), tables[8]

    def run_case(base, r, s, host=host, hslots=hslots):
        """(tables after the kernel, staged): kernel and plain version on
        clones of `base`."""
        staged = R.stage_table_delta(host, r, hslots, s, ix.residual_rows, dev)
        a = [x.clone() for x in base]
        b = [x.clone() for x in base]
        R.table_sync(*split(a), staged, len(r), len(s))
        R.table_sync_ref(*split(b), staged, len(r), len(s))
        torch.cuda.synchronize()
        max_abs_err(i32(a), i32(b))
        return a, staged

    def held(tables, want, what):
        max_abs_err(i32(tables), i32(want))
        return what

    def scrambled(r, s, full=False):
        """The host truth with rows r and slots s (and their probe words
        and mask bytes) changed."""
        x = [y.clone() for y in truth]
        ri = torch.from_numpy(r.astype(np.int64)).to(dev)
        si = torch.from_numpy(s.astype(np.int64)).to(dev)
        for k, y in enumerate(i32(x)):
            sel = ri if k in (0, 1, 2, 3, 4, 8) else si // BUCKET_W if k == 7 else si
            if y.dtype == torch.bool:
                y[sel] = ~y[sel]
            elif full:
                y.fill_(-7)
            else:
                y[sel] = -7
        return x

    lines = []
    # phase 5's churn delta: both sides, one side, ids past both tables
    a, staged = run_case(stale, rows, sids)
    n_r, n_s = len(rows), len(sids)
    n_res = len(ix.residual_rows.intersection(rows.tolist()))
    lines.append(held(a, truth, f"churn delta rows={n_r} (residual {n_res}) slots={n_s}"))
    a, _ = run_case(stale, rows, none)
    lines.append(held(a, truth[:5] + stale[5:8] + truth[8:], "rows only"))
    a, _ = run_case(stale, none, sids)
    lines.append(held(a, stale[:5] + truth[5:8] + stale[8:], "slots only"))
    past_host = EncodedFilters(*(np.concatenate([x, x[:16]]) for x in host))
    past_slots = SlotArrays(*(np.concatenate([x, x[:16]]) for x in hslots))
    a, _ = run_case(stale, np.concatenate([rows, np.int32([N, N + 7])]),
                    np.concatenate([sids, np.int32([S, S + 5])]), past_host, past_slots)
    lines.append(held(a, truth, "ids past both tables dropped"))
    # 1 and 1,025 entries a side, and the full table
    g = np.random.default_rng(9)
    for n in (1, 1025):
        r = np.sort(g.choice(N, n, replace=False)).astype(np.int32)
        s = np.sort(g.choice(S, n, replace=False)).astype(np.int32)
        a, _ = run_case(scrambled(r, s), r, s)
        lines.append(held(a, truth, f"{n} a side"))
    r_all = np.arange(N, dtype=np.int32)
    s_all = np.arange(S, dtype=np.int32)
    a, full_staged = run_case(scrambled(r_all, s_all, full=True), r_all, s_all)
    lines.append(held(a, truth, f"full table rows={N} slots={S}"))
    fa = split(a)
    full_dev, full_enq = run_ms(lambda: R.table_sync(*fa, full_staged, N, S))
    lines.append(f"full table device_ms={full_dev:.6f} enqueue_ms={full_enq:.6f} bound_ms="
                 f"{1e3 * ((20 + 8 * L) * N + 28 * S) / H100_BYTES_PER_S:.6f}")
    del a, fa, full_staged
    # the reference-shaped wrappers on the padded [nb, K] batches
    idx = pad_pow2_batches(rows, R.SYNC_BATCH_SIZE)
    cols = [to_device(c, dev) for c in (idx, host.words[idx], host.prefix_len[idx],
                                        host.has_hash[idx], host.root_wild[idx],
                                        host.active[idx])]
    sidx = pad_pow2_batches(sids, R.SYNC_BATCH_SIZE)
    scols = [to_device(c, dev) for c in (sidx, hslots.fp[sidx], hslots.bucket[sidx],
                                         hslots.probe[sidx // BUCKET_W])]
    for name, fn, ref, c, k0, k1 in (
            ("scatter_rows", R.scatter_rows, R.scatter_rows_ref, cols, 0, 5),
            ("scatter_slots", R.scatter_slots, R.scatter_slots_ref, scols, 5, 8)):
        a = [x.clone() for x in stale[k0:k1]]
        b = [x.clone() for x in stale[k0:k1]]
        tab = EncodedFilters if k0 == 0 else SlotArrays
        fn(tab(*a), *c)
        ref(tab(*b), *c)
        max_abs_err(i32(a), i32(b))
        max_abs_err(i32(a), i32(truth[k0:k1]))
        d_ms, e_ms = run_ms(lambda fn=fn, a=a, tab=tab, c=c: fn(tab(*a), *c))
        lines.append(f"{name} at [{c[0].shape[0]}, {c[0].shape[1]}] equal, "
                     f"device_ms={d_ms:.6f} enqueue_ms={e_ms:.6f}")

    # the churn delta timed: the kernel, its plain version, nine index_copy_
    a = [x.clone() for x in stale]
    b = [x.clone() for x in stale]
    c = [x.clone() for x in stale]
    (rid, words, plen, hh, rw, act, res), (sid, fp, bucket, probe) = \
        R.staged_columns(staged, n_r, L, n_s)
    ri, si = rid.long(), sid.long()
    pi = si // BUCKET_W
    ci = i32(c)

    def library():
        for k, v in enumerate((words, plen, hh, rw, act)):
            ci[k].index_copy_(0, ri, v)
        ci[5].index_copy_(0, si, fp.view(torch.int32))
        ci[6].index_copy_(0, si, bucket)
        ci[7].index_copy_(0, pi, probe.view(torch.int32))
        ci[8].index_copy_(0, ri, res)

    library()
    max_abs_err(i32(c), i32(truth))
    sa, sb = split(a), split(b)
    rec = dict(
        **timed(lambda: R.table_sync(*sa, staged, n_r, n_s),
                lambda: R.table_sync_ref(*sb, staged, n_r, n_s), library),
        bytes=(20 + 8 * L) * n_r + 28 * n_s, ops=0, err=0,
    )
    floor, _ = run_ms(lambda x=torch.tensor(0.5, device=dev): T.add_one(x))
    rec["shape"] = (f"rows={n_r} slots={n_s} (distinct, unpadded; {n_res} rows residual) "
                    f"of tables {N} x {L}, {S} slots; one launch's floor (K12, scalar) "
                    f"device_ms={floor:.6f}; library: nine index_copy_ calls; "
                    f"equal: " + "; ".join(lines))
    return rec


def match_ids_hash_edge_cases(meta, slots, denc, mh):
    """K1 against its plain version, exactly, off phase 5's shape: 37
    classes (a block spans more topics than it stages: the level ids
    come from global memory), 512 classes (the router's twice over: a
    topic spans two blocks), B = 1, and max_hits 1 (every block's ranks
    past it). Returns one line a case."""
    import torch

    from emqx_tpu_torch.ops import hash_index as H
    from emqx_tpu_torch.ops import match as M

    out = []
    one = M.EncodedTopics(*(x[:1].contiguous() for x in denc))
    for name, m, t, hits in (
        ("C = 37", H.ClassMeta(*(x[:37].contiguous() for x in meta)), denc, mh),
        ("C = 512", H.ClassMeta(*(torch.cat([x, x]) for x in meta)), denc, mh),
        ("B = 1", meta, one, mh),
        ("max_hits = 1", meta, denc, 1),
    ):
        got = H.match_ids_hash(m, slots, t, max_hits=hits)
        max_abs_err(got, H.match_ids_hash_ref(m, slots, t, max_hits=hits))
        out.append(f"{name}: total={int(got[2])}")
    return out


def match_ids_edge_cases(filters, denc, total):
    """K2 against its plain version, exactly, at its edge cases, on
    edited clones of the dense-only table (never the router's own
    state): max_hits below the total; 4,096 extra live '#' rows in one
    chunk (one block's hits past its list capacity: it walks again),
    at the default max_hits and at one that holds every hit; an
    all-dead mask; live rows only in the last chunk (chunk 0's rows
    copied there); B = 1 and B = 2,048; N = chunk. Returns one line a
    case."""
    import torch

    from emqx_tpu_torch.ops import match as M
    from emqx_tpu_torch.ops.table import EncodedFilters, next_pow2

    N = int(filters.words.shape[0])
    chunk = min(65536, N)
    mh = max(4096, next_pow2(4 * int(denc.ids.shape[0])))
    out = []

    def check(name, f, t, max_hits):
        got = M.match_ids(f, t, max_hits=max_hits)
        max_abs_err(got, M.match_ids_ref(f, t, max_hits=max_hits))
        out.append(f"{name} (B={int(t.ids.shape[0])} N={int(f.words.shape[0])} "
                   f"max_hits={max_hits}): total={int(got[2])}")
        return int(got[2])

    def clone():
        return EncodedFilters(*(x.clone() for x in filters))

    check("max_hits below the total", filters, denc, max(1, total // 3))
    f = clone()
    dead = (~f.active).view(-1, chunk).sum(dim=1)
    k = min(4096, int(dead.max()))
    c = int(torch.nonzero(dead >= k)[0])
    rows = c * chunk + torch.nonzero(~f.active[c * chunk:(c + 1) * chunk])[:k, 0]
    f.words[rows] = 0
    f.prefix_len[rows] = 0
    f.has_hash[rows] = True
    f.root_wild[rows] = True
    f.active[rows] = True
    big = check(f"{k} '#' rows in chunk {c}", f, denc, mh)
    check(f"{k} '#' rows in chunk {c}, every hit placed", f, denc, next_pow2(big))
    f = clone()
    f.active.zero_()
    if check("all rows dead", f, denc, mh):
        raise AssertionError("K2 matched rows of an all-dead mask")
    f = clone()
    for x in f:
        x[N - chunk:] = x[:chunk]
    f.active[:N - chunk] = False
    check("live rows only in the last chunk", f, denc, mh)
    del f
    check("B = 1", filters, M.EncodedTopics(*(x[:1].contiguous() for x in denc)), mh)
    check("B = 2,048", filters, M.EncodedTopics(*(torch.cat([x, x]) for x in denc)), 2 * mh)
    check("N = chunk", EncodedFilters(*(x[:chunk].clone() for x in filters)), denc, mh)
    return out


# --- the slice end to end ------------------------------------------------------


class Gen2Collections:
    """The generation-2 garbage collections while installed
    (`gc.callbacks`), each one's seconds, split by whether it started
    inside a timed section (the caller sets `timing` around them). One
    full collection over the million-route object graph takes ~1.5 s,
    so whether it lands in a timed window decides that window's rate."""

    def __init__(self):
        self.timing = False
        self.timed, self.other = [], []
        self._start = None

    def __call__(self, phase, info):
        if info["generation"] != 2:
            return
        if phase == "start":
            self._start = (time.perf_counter(), self.timing)
        elif self._start is not None:
            t0, timed = self._start
            (self.timed if timed else self.other).append(time.perf_counter() - t0)
            self._start = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)

    def line(self) -> str:
        return (f"gen2 collections in the timed window {len(self.timed)} "
                f"({sum(self.timed):.3f} s), elsewhere in the run {len(self.other)} "
                f"({sum(self.other):.3f} s)")


class TableSyncs:
    """Each delta sync's (row, slot) entry counts while active:
    DeviceTable.sync calls models.router.table_sync by name, and
    ShardedDeviceTable.sync parallel.sharded_match.mesh_table_sync (with
    `mesh=True`); this wraps the one called with a recorder. The kernel's
    launch count is its own."""

    def __init__(self, mesh: bool = False):
        self._where = ("parallel.sharded_match", "mesh_table_sync") if mesh else (
            "models.router", "table_sync")

    def __enter__(self):
        import importlib

        mod_name, fn_name = self._where
        self._mod = importlib.import_module(f"emqx_tpu_torch.{mod_name}")
        self._real = getattr(self._mod, fn_name)
        self.entries = []

        def recorded(*a):
            self.entries.append(tuple(a[-2:]))
            self._real(*a)

        setattr(self._mod, fn_name, recorded)
        return self

    def __exit__(self, *exc):
        setattr(self._mod, self._where[1], self._real)

    def line(self) -> str:
        e = self.entries
        if not e:
            return "table syncs 0"
        return (f"table syncs {len(e)}, row entries a sync median "
                f"{statistics.median(r for r, _ in e)} max {max(r for r, _ in e)}, "
                f"slot entries a sync median {statistics.median(s for _, s in e)} "
                f"max {max(s for _, s in e)}")


def serve(router, skel, exact, rng, n_batches: int = N_BATCHES):
    """Phase 5: the pipelined publish stream with churn, every batch
    checked against the host path at its begin and at its finish.
    Returns (topics/s over the begin+finish host wall, escalations,
    topics served, that wall, topics whose routes changed in flight,
    the generation-2 collections of the run: `Gen2Collections`, timed
    over the same begin+finish sections)."""
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
        gcs.timing = True
        t0 = time.perf_counter()
        got = router.match_filters_finish(p)
        busy += time.perf_counter() - t0
        gcs.timing = False
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

    with Gen2Collections() as gcs:
        for k, topics in enumerate(batches):
            gcs.timing = True
            t0 = time.perf_counter()
            p = router.match_filters_begin(topics)
            busy += time.perf_counter() - t0
            gcs.timing = False
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
    return served / busy, esc, served, busy, moved, gcs


def device_busy_share(router, skel, exact, rng, n_batches: int = 8):
    """A few more batches under torch.profiler: the union of the device
    activity intervals over the begin+finish host wall. The profiler's
    own host overhead inflates the wall, so this reads low rather than
    high."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _rate, _esc, served, busy, _moved, _gc = serve(router, skel, exact, rng, n_batches)
        torch.cuda.synchronize()
    return device_seconds(prof), busy, served


def device_seconds(prof) -> float:
    """The union of a profile's device activity intervals, in seconds."""
    import torch

    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA)
    dev_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            dev_us += b - max(a, end)
            end = b
    return dev_us * 1e-6


# --- the broker publish path (phase 7) ------------------------------------------


class Deliveries:
    """Every session's QoS-0 sink writes (client, topic) here; the
    counter is read and cleared once per window pair."""

    def __init__(self) -> None:
        from collections import Counter

        self.seen = Counter()

    def sink_for(self, cid):
        seen = self.seen

        def sink(pkts):
            for p in pkts:
                seen[(cid, p.topic)] += 1

        return sink


def build_broker(rng, device, deliveries):
    """Phase 7 set-up: a Broker on the card whose router holds the
    slice's 1,048,576 routes (storm path), N_PFAN sessions on
    `pfan/+/x` (half also on `pfan/#` at QoS 2: the aggre/1 dedup
    shape), N_MFAN_GROUPS groups of MFAN_GROUP sessions on
    `mfan/{g}/+`, N_SHARED shared members on `$share/g1/pfan/+/x`, and
    a few no_local / retain-as-published subscriptions."""
    from emqx_tpu_torch.broker.packet import SubOpts
    from emqx_tpu_torch.broker.pubsub import Broker

    broker = Broker(max_levels=16, device=device)
    skel, exact, routes_s = add_route_set(broker.router, rng)
    t0 = time.perf_counter()
    opts = [SubOpts(qos=q) for q in range(3)]

    def session(cid):
        s, _ = broker.open_session(cid, True)
        s.outgoing_sink = deliveries.sink_for(cid)
        return s

    for i in range(N_PFAN):
        s = session(f"pf{i}")
        broker.subscribe(s, "pfan/+/x", opts[i % 3])
        if i % 2 == 0:
            broker.subscribe(s, "pfan/#", opts[2])
    for g in range(N_MFAN_GROUPS):
        for j in range(MFAN_GROUP):
            broker.subscribe(session(f"mf{g}_{j}"), f"mfan/{g}/+", opts[j % 3])
    for j in range(N_SHARED):
        broker.subscribe(session(f"sh{j}"), "$share/g1/pfan/+/x", opts[j % 3])
    for j in range(8):
        broker.subscribe(session(f"nl{j}"), "pfan/+/x",
                         SubOpts(qos=j % 3, no_local=True))
        broker.subscribe(session(f"rap{j}"), "mfan/0/+",
                         SubOpts(qos=1, retain_as_published=True))
    return broker, skel, exact, routes_s, time.perf_counter() - t0


def broker_window(rng, skel, exact, w, n_pfan=N_PFAN_PUBS, n_mfan=N_MFAN_PUBS):
    """One window of WINDOW QoS-0 publishes with 64-byte payloads:
    n_pfan on `pfan/{k}/x`, n_mfan on `mfan/{g}/{v}` (each topic once
    per window pair, the same topics every pair), the rest the slice's
    publish mix."""
    from emqx_tpu_torch.broker.message import Message

    half = w % 2
    topics = [f"pfan/{half * n_pfan + j}/x" for j in range(n_pfan)]
    topics += [f"mfan/{j % N_MFAN_GROUPS}/v{half * n_mfan + j}"
               for j in range(n_mfan)]
    topics += publish_batch(rng, skel, exact)[: WINDOW - len(topics)]
    order = rng.permutation(len(topics)).tolist()
    return [Message(topic=topics[i], payload=bytes(64), from_client="pub")
            for i in order]


def broker_churn(broker, skel, rng, k, deliveries):
    """Between window pairs: late joiners on `pfan/#`, leavers from
    `pfan/+/x`, re-subscribes at another QoS in one mfan group, one
    session closed and re-opened — and, after every second pair, the
    slice's delete and re-add of CHURN routes (that bumps the route
    generation and so empties the match cache; the pairs between keep
    it warm, so their cached topics launch overlapped resolves)."""
    from emqx_tpu_torch.broker.packet import SubOpts

    for j in range(8):
        cid = f"late{k}_{j}"
        s, _ = broker.open_session(cid, True)
        s.outgoing_sink = deliveries.sink_for(cid)
        broker.subscribe(s, "pfan/#", SubOpts(qos=j % 3))
    for i in rng.choice(N_PFAN, 4, replace=False).tolist():
        s = broker.sessions[f"pf{i}"]
        if "pfan/+/x" in s.subscriptions:
            broker.unsubscribe(s, "pfan/+/x")
    g = k % N_MFAN_GROUPS
    for j in rng.choice(MFAN_GROUP, 16, replace=False).tolist():
        s = broker.sessions[f"mf{g}_{j}"]
        q = (s.subscriptions[f"mfan/{g}/+"].qos + 1) % 3
        broker.subscribe(s, f"mfan/{g}/+", SubOpts(qos=q))
    cid = f"pf{int(rng.integers(0, N_PFAN))}"
    subs = dict(broker.sessions[cid].subscriptions)
    broker.close_session(broker.sessions[cid])
    s, _ = broker.open_session(cid, True)
    s.outgoing_sink = deliveries.sink_for(cid)
    for flt, o in subs.items():
        broker.subscribe(s, flt, o)
    if k % 2 == 1:
        for i in rng.integers(0, N_ROUTES, CHURN).tolist():
            f, d = f"t{i % 997}/r{i % 13}/d{i}/+/m/#", f"n{i % 7}"
            broker.router.delete_route(f, d)
            broker.router.add_route(f, d)


def oracle_of(broker, topic, cache):
    """(key, plan, shared legs) of the host path for one topic: the
    host trie's match and Broker._build_fanout_plan, cached per
    matched filter set."""
    pairs = broker.router.match_pairs(topic)
    key = tuple(f for f, _ in pairs)
    got = cache.get(key)
    if got is None:
        # one elected member per shared group leg (the members are live)
        groups = sum(
            1 for _f, dests in pairs for d in dests
            if isinstance(d, tuple) and d and d[0] == "$group"
        )
        got = cache[key] = (broker._build_fanout_plan(pairs), groups)
    return key, got


def check_pair(broker, served, installed, deliveries, pair):
    """After a window pair lands: every device-installed plan equals the
    host oracle over the same filters; every publish's delivery count
    equals the oracle's; every (client, topic) the plans name was
    delivered exactly once, and nothing else was. Returns deliveries."""
    cache = {}
    fd = broker.router.filter_dests
    for key, plan in installed:
        want = broker._build_fanout_plan([(f, fd(f)) for f in key])
        if plan != want:
            raise AssertionError(
                f"pair {pair}: device plan for {key} differs from the host "
                f"oracle ({len(plan[0])}+{len(plan[1])} vs "
                f"{len(want[0])}+{len(want[1])} entries)")
    per_topic = {}
    total = 0
    for topic, n, dkey in served:
        if isinstance(n, BaseException):
            raise AssertionError(f"pair {pair}: publish on {topic} failed: {n!r}")
        key, (plan, groups) = oracle_of(broker, topic, cache)
        if set(dkey) != set(key):
            raise AssertionError(f"pair {pair}: {topic} matched {dkey}, host {key}")
        want = len(plan[0]) + len(plan[1]) + groups
        if n != want:
            raise AssertionError(
                f"pair {pair}: {topic} delivered {n}, host oracle {want}")
        total += n
        per_topic[topic] = per_topic.get(topic, 0) + n
    seen = deliveries.seen
    got_topic = {}
    for (_c, t), v in seen.items():
        if v != 1:
            raise AssertionError(f"pair {pair}: ({_c}, {t}) delivered {v} times")
        got_topic[t] = got_topic.get(t, 0) + 1
    for t, n in per_topic.items():
        if got_topic.get(t, 0) != n:
            raise AssertionError(
                f"pair {pair}: {t}: sinks saw {got_topic.get(t, 0)}, "
                f"counted {n}")
        if t.startswith(("pfan/", "mfan/")):
            _key, (plan, _g) = oracle_of(broker, t, cache)
            for c, _s, _o in plan[0]:
                if (c, t) not in seen:
                    raise AssertionError(f"pair {pair}: {c} missed {t}")
    extra = set(got_topic) - set(per_topic)
    if extra:
        raise AssertionError(f"pair {pair}: deliveries on unpublished {sorted(extra)[:3]}")
    seen.clear()
    return total


def record_serving(broker, served, installed):
    """Wrap the broker's window dispatch and the router's plan resolves
    (instance attributes shadow the class's): every served publish lands
    in `served` as (topic, count, matched filters), every plan resolved
    on the card in `installed` as (filters, plan). Returns the (object,
    name) pairs to delete when done."""
    router = broker.router
    keys = {}
    orig_window = broker.dispatch_window
    orig_begin = router.resolve_fanout_begin
    orig_finish = router.resolve_fanout_finish

    def dispatch_window(lives, filter_lists, spans=None, capture_errors=False):
        results, meta = orig_window(lives, filter_lists, spans, capture_errors)
        for live, n, m in zip(lives, results, meta):
            if live is not None:
                served.append((live.topic, n, m[0]))
        return results, meta

    def resolve_begin(filters, min_fan=0):
        h = orig_begin(filters, min_fan)
        if h is not None:
            keys[id(h)] = tuple(filters)
        return h

    def resolve_finish(h):
        plan = orig_finish(h)
        installed.append((keys.pop(id(h)), plan))
        return plan

    broker.dispatch_window = dispatch_window
    router.resolve_fanout_begin = resolve_begin
    router.resolve_fanout_finish = resolve_finish
    return [(broker, "dispatch_window"), (router, "resolve_fanout_begin"),
            (router, "resolve_fanout_finish")]


def serve_broker(broker, skel, exact, rng, deliveries, n_windows=N_WINDOWS,
                 profiled=True, k_base=0):
    """Phase 7's traffic: windows of WINDOW publishes through the
    DispatchEngine, two at a time (the pipeline's depth), each pair
    checked against the host oracle once it has landed, then churn
    (broker_churn's index from `k_base`). With `profiled`, one more pair
    under torch.profiler. Returns the run's record."""
    import asyncio

    router = broker.router
    served = []
    installed = []
    # host seconds per stage of the traffic, by wrapping the methods the
    # engine reaches (instance attributes shadow the class's; the
    # deferred fanout shards are scheduled through the wrapped walks)
    stages = ("pre_publish", "match_begin", "match_finish", "plan", "walk")
    acc = dict.fromkeys(stages, 0.0)
    wrapped = []

    def wrap(obj, name, stage):
        orig = getattr(obj, name)

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return orig(*a, **k)
            finally:
                acc[stage] += time.perf_counter() - t0

        setattr(obj, name, timed)
        wrapped.append((obj, name))

    wrap(broker, "_pre_publish", "pre_publish")
    wrap(router, "match_filters_begin", "match_begin")
    wrap(router, "match_filters_finish", "match_finish")
    wrap(broker, "_resolve_plan", "plan")
    wrap(broker, "_deliver_plan_window", "walk")
    wrap(broker, "_deliver_plan", "walk")
    wrapped += record_serving(broker, served, installed)
    rec = {"publishes": 0, "deliveries": 0, "traffic_s": 0.0, "check_s": 0.0,
           "churn_s": 0.0, "stages": dict.fromkeys(stages, 0.0)}

    async def pair(k):
        """Two windows submitted together, landed, checked; returns the
        traffic wall, its stage seconds, the publishes and the
        deliveries."""
        eng = broker.engine
        windows = [broker_window(rng, skel, exact, 2 * k + h) for h in (0, 1)]
        a0 = dict(acc)
        t0 = time.perf_counter()
        futs = [eng.submit_many(w) for w in windows]
        sums = await asyncio.gather(*futs)
        await eng.drain()
        for _ in range(4):  # deferred fanout shards run on the loop
            await asyncio.sleep(0)
        t1 = time.perf_counter()
        spent = {st: acc[st] - a0[st] for st in stages}
        n = check_pair(broker, served, installed, deliveries, k)
        if n != sum(sums):
            raise AssertionError(f"pair {k}: futures summed {sum(sums)}, publishes {n}")
        n_pubs = len(served)
        served.clear()
        installed.clear()
        rec["check_s"] += time.perf_counter() - t1
        return t1 - t0, spent, n_pubs, n

    async def run():
        from torch.profiler import ProfilerActivity, profile

        n_pairs = n_windows // 2
        for k in range(n_pairs):
            wall, spent, n_pubs, n = await pair(k)
            rec["traffic_s"] += wall
            for st, v in spent.items():
                rec["stages"][st] += v
            rec["publishes"] += n_pubs
            rec["deliveries"] += n
            t0 = time.perf_counter()
            broker_churn(broker, skel, rng, k_base + k, deliveries)
            rec["churn_s"] += time.perf_counter() - t0
        if profiled:
            # one more pair, not counted above, under torch.profiler:
            # the device's busy share of a pair's traffic wall
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                wall, spent, _n_pubs, n = await pair(n_pairs)
            rec["profiled"] = (device_seconds(prof), wall, spent["walk"], n)
        await broker.engine.stop()

    try:
        asyncio.run(run())
    finally:
        for obj, name in wrapped:
            if name in vars(obj):
                delattr(obj, name)
    return rec


def k5_scratch(F, n_clients, dev):
    """K5's persistent keys, or None on a tree without them (the parent
    of an A/B pair, which times K5 without)."""
    cls = getattr(F, "FanoutScratch", None)
    return cls(n_clients, dev) if cls is not None else None


def k5_call(fn, state, rows, n_clients, max_fan, scratch):
    """K5 (`fn`: the wrapper or its plain version) on persistent keys
    where the tree has them."""
    extra = {} if scratch is None else {"scratch": scratch}
    return fn(*state, rows, n_clients=n_clients, max_fan=max_fan, **extra)


def resolve_fanout_edge_cases(F, state, rows_arr, nc, max_fan, dev):
    """K5 against its plain version, exactly, off the broker's shapes:
    the pfan plan's rows padded to M = 2,048 (past the rows a gather
    block scans itself: one scan launch, the search in global memory),
    and on a tree with persistent keys the last epoch and the wrap after
    it (the one clear of the keys). Returns one line a case."""
    import numpy as np

    from emqx_tpu_torch.device import to_device

    out = []
    wide = np.full(2048, -1, np.int32)
    wide[: len(rows_arr)] = rows_arr
    wide = to_device(wide, dev)
    k_scr, p_scr = k5_scratch(F, nc, dev), k5_scratch(F, nc, dev)
    for name in ("M = 2,048", "the last epoch", "the wrap"):
        if name != "M = 2,048":
            if k_scr is None:
                continue
            if name == "the last epoch":
                k_scr.epoch = p_scr.epoch = F.EPOCH_LIMIT - 1
        got = k5_call(F.resolve_fanout, state, wide, nc, max_fan, k_scr)
        max_abs_err(got, k5_call(F.resolve_fanout_ref, state, wide, nc, max_fan, p_scr))
        out.append(f"{name}: winners={int(got[1])} epoch={getattr(k_scr, 'epoch', None)}")
    return out


def check_broker_kernels(broker, skel, rng, deliveries):
    """K5 at the pfan (150k gathered) and an mfan (2k) plan's shapes on
    persistent tables, the fused K6/K7 sync on one churn's delta, K12
    on the probe's scalar and 1 MB buffer: each against its plain version on
    the same CUDA inputs.
    Also the host walk's and the device resolve's time for the pfan
    plan. Returns (records, host-vs-device line)."""
    import numpy as np
    import torch

    from emqx_tpu_torch.device import to_device
    from emqx_tpu_torch.ops import fanout as F
    from emqx_tpu_torch.ops import transfer as T
    from emqx_tpu_torch.ops.table import next_pow2

    router = broker.router
    store = router.dest_store
    fan_dev = router.device_table.fanout
    dev = router.device
    recs = {}

    def rows_of(topic):
        pairs = router.match_pairs(topic)
        key = tuple(f for f, _ in pairs)
        rows = [router._fanout_row(f) for f in key]
        router._fanout_flush(rows)
        return pairs, key, rows

    # K5 on persistent tables, as FanoutDeviceState holds them: one
    # scratch for the kernel and one for its plain version, each carried
    # from the mfan plan into the pfan plan (the pfan call meets the
    # mfan call's keys of an older epoch), each plan against the other's
    # and against the host oracle
    nc = store.client_pow2()
    k_scr, p_scr = k5_scratch(F, nc, dev), k5_scratch(F, nc, dev)
    for name, topic in (("resolve_fanout_small", "mfan/3/v0"), ("resolve_fanout", "pfan/0/x")):
        pairs, key, rows = rows_of(topic)
        fan_dev.sync()
        fan = store.fan_of(rows)
        max_fan = F.fan_bucket(max(fan, 64))
        rows_arr = np.full(next_pow2(max(len(rows), 4)), -1, np.int32)
        rows_arr[: len(rows)] = rows
        trows = to_device(rows_arr, dev)
        state = fan_dev.tensors()
        got = k5_call(F.resolve_fanout, state, trows, nc, max_fan, k_scr)
        want = k5_call(F.resolve_fanout_ref, state, trows, nc, max_fan, p_scr)
        err = max_abs_err(got, want)
        # and against a fresh table of this call alone
        err = max(err, max_abs_err(got, F.resolve_fanout(*state, trows, n_clients=nc,
                                                         max_fan=max_fan)))
        out = got[0].cpu().numpy()
        if store.build_plan(out[out >= 0]) != broker._build_fanout_plan(pairs):
            raise AssertionError(f"K5 plan for {key} differs from the host oracle")
        total = int(got[2])
        m = len(rows_arr)

        def run(state=state, trows=trows, max_fan=max_fan):
            return k5_call(F.resolve_fanout, state, trows, nc, max_fan, k_scr)

        def plain(state=state, trows=trows, max_fan=max_fan):
            return k5_call(F.resolve_fanout_ref, state, trows, nc, max_fan, p_scr)

        recs[name] = dict(
            **timed(run, plain),
            bytes=m * 12 + total * 8 + max_fan * 4 + 8,
            ops=total * (4 * max(1, m.bit_length()) + 16),
            err=err,
            shape=f"{topic}: M={m} fan={fan} max_fan={max_fan} n_clients={nc} "
                  f"E={int(state[2].shape[0])} winners={int(got[1])} "
                  f"epoch={getattr(k_scr, 'epoch', None)}; "
                  f"launches are K5's over phase 7, both plan shapes; its launches, "
                  f"device us a call: " + launch_breakdown(run),
        )
    recs["resolve_fanout"]["shape"] += "; edge cases equal: " + "; ".join(
        resolve_fanout_edge_cases(F, state, rows_arr, nc, max_fan, dev))
    # the pfan plan three ways: the host walk, the device resolve end to
    # end (begin + finish, plan materialized), the kernel alone
    host_ms, dev_ms = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        broker._build_fanout_plan(pairs)
        host_ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        router.resolve_fanout_finish(router.resolve_fanout_begin(key))
        dev_ms.append(1e3 * (time.perf_counter() - t0))
    versus = (f"plan at fan {fan} ({len(broker._build_fanout_plan(pairs)[0])} "
              f"winners): host walk {statistics.median(host_ms):.3f} ms, device "
              f"resolve begin+finish {statistics.median(dev_ms):.3f} ms, K5 "
              f"kernel {recs['resolve_fanout']['device_ms']:.6f} ms (device)")

    # K6/K7, fused: one churn's delta, on copies of the mirror. Its index
    # is one no pair uses (its own late joiners and mfan group) and even
    # (no route churn: a re-added storm route may grow the edge pool)
    pending = set(store.pending_rows)
    broker_churn(broker, skel, rng, SETUP_CHURN, deliveries)
    # the churn core only marks the churned rows pending; the next
    # resolve of their filters flushes them: flush them here, as it would
    router._fanout_flush(sorted(store.pending_rows - pending))
    if store.grew:
        raise AssertionError("the churn grew the edge pool: no delta sync to check")
    recs["fanout_sync"] = fanout_sync_checks(F, store, fan_dev, dev)

    # K12: the probe's float32 scalar and its 1 MB int32 fetch buffer,
    # timed against torch.add; its edge cases equal to the plain version
    x = torch.tensor(0.5, dtype=torch.float32, device=dev)
    buf = torch.arange(1 << 18, dtype=torch.int32, device=dev)
    e, cases = add_one_edge_cases(dev)
    scalar = timed(lambda: T.add_one(x), lambda: T.add_one_ref(x), lambda: torch.add(x, 1))
    recs["probe_add_one"] = dict(
        **timed(lambda: T.add_one(buf), lambda: T.add_one_ref(buf), lambda: torch.add(buf, 1)),
        bytes=2 * buf.nbytes, ops=buf.numel(), err=e,
        shape=f"int32 [{buf.numel()}] (the fetch leg); " + "; ".join(
            [f"float32 scalar: {times_line(scalar)}"] + cases),
    )
    torch.cuda.synchronize()
    set_bounds(recs)
    return recs, versus


def fanout_sync_checks(F, store, fan_dev, dev):
    """The fused K6/K7 sync against its plain version, exactly, and every
    table against the host arrays: phase 7's churn delta (both sides,
    rows only, edges only, with ids past both tables) on copies of the
    stale mirror; 1 and 1,025 entries a side and the full pool (every
    row and edge) on copies of the host truth with those entries
    scrambled. Then the reference-shaped wrappers on the churn delta's
    [nb, K] padded batches. The churn delta is timed against four
    `index_copy_` calls on the same staged views (ids widened to int64
    once, outside the timing) and the bound counts its distinct entries:
    12 bytes read and 8 written each. Returns the record."""
    import numpy as np
    import torch

    from emqx_tpu_torch.device import to_device
    from emqx_tpu_torch.ops import transfer as T
    from emqx_tpu_torch.ops.table import pad_pow2_batches

    host = (store.seg_off, store.seg_len, store.edge_client, store.edge_opts)
    truth = [to_device(a, dev) for a in host]
    rows = np.unique(np.asarray(store.dirty_rows, np.int32))
    edges = np.unique(np.asarray(store.dirty_edges, np.int32))
    n_cap, e_cap = len(store.seg_off), len(store.edge_client)
    none = np.zeros(0, np.int32)

    def run_case(base, r, e, extra=None):
        """(tables after the kernel, staged, n_r, n_e): kernel and plain
        version on clones of `base`; `extra` (ids, ids) appends ids past
        the tables with arbitrary values."""
        staged = F.stage_delta(r, e, *host, dev)
        n_r, n_e = len(r), len(e)
        if extra is not None:
            rr, ee = (np.concatenate([r, extra[0]]), np.concatenate([e, extra[1]]))
            v = staged.cpu().numpy()
            cols = [np.concatenate([v[k * n_r:(k + 1) * n_r], x])
                    for k, x in enumerate((extra[0], extra[0] + 5, extra[0] - 9))]
            o = 3 * n_r
            cols += [np.concatenate([v[o + k * n_e:o + (k + 1) * n_e], x])
                     for k, x in enumerate((extra[1], extra[1] + 3, extra[1] - 2))]
            n_r, n_e = len(rr), len(ee)
            staged = to_device(np.concatenate(cols).astype(np.int32), dev)
        a = [x.clone() for x in base]
        b = [x.clone() for x in base]
        F.fanout_sync(*a, staged, n_r, n_e)
        F.fanout_sync_ref(*b, staged, n_r, n_e)
        torch.cuda.synchronize()
        max_abs_err(a, b)
        return a, staged, n_r, n_e

    def scrambled(r, e, full=False):
        """The host truth with rows r and edges e set to -7."""
        t = [x.clone() for x in truth]
        for k, ids in ((0, r), (1, r), (2, e), (3, e)):
            if full:
                t[k].fill_(-7)
            elif len(ids):
                t[k][torch.from_numpy(ids.astype(np.int64)).to(dev)] = -7
        return t

    def held(tables, want, what):
        max_abs_err(tables, want)
        return what

    stale = fan_dev.tensors()
    lines = []
    # phase 7's churn delta: both sides, one side, ids past both tables
    a, staged, n_r, n_e = run_case(stale, rows, edges)
    lines.append(held(a, truth, f"churn delta rows={n_r} edges={n_e}"))
    a, *_ = run_case(stale, rows, none)
    lines.append(held(a, truth[:2] + list(stale[2:]), "rows only"))
    a, *_ = run_case(stale, none, edges)
    lines.append(held(a, list(stale[:2]) + truth[2:], "edges only"))
    a, *_ = run_case(stale, rows, edges, (np.int32([n_cap, n_cap + 7]),
                                          np.int32([e_cap, e_cap + 1000])))
    lines.append(held(a, truth, "ids past both tables dropped"))
    # 1 and 1,025 entries a side, and the full pool
    rng = np.random.default_rng(5)
    for n in (1, 1025):
        r = np.sort(rng.choice(n_cap, n, replace=False)).astype(np.int32)
        e = np.sort(rng.choice(e_cap, n, replace=False)).astype(np.int32)
        a, *_ = run_case(scrambled(r, e), r, e)
        lines.append(held(a, truth, f"{n} a side"))
    r_all = np.arange(n_cap, dtype=np.int32)
    e_all = np.arange(e_cap, dtype=np.int32)
    full_base = scrambled(r_all, e_all, full=True)
    a, full_staged, *_ = run_case(full_base, r_all, e_all)
    lines.append(held(a, truth, f"full pool rows={n_cap} edges={e_cap}"))
    full_dev, _ = run_ms(lambda: F.fanout_sync(*a, full_staged, n_cap, e_cap))
    lines.append(f"full pool device_ms={full_dev:.6f} bound_ms="
                 f"{1e3 * 20 * (n_cap + e_cap) / H100_BYTES_PER_S:.6f}")
    # the reference-shaped wrappers on the padded [nb, K] batches
    for name, fn, ids, k in (("scatter_segs", F.scatter_segs, rows, 0),
                             ("scatter_edges", F.scatter_edges, edges, 2)):
        idx = pad_pow2_batches(ids, F.SYNC_BATCH)
        vals = [to_device(idx, dev)] + [to_device(c[idx], dev) for c in host[k:k + 2]]
        a = [x.clone() for x in stale[k:k + 2]]
        b = [x.clone() for x in stale[k:k + 2]]
        fn(*a, *vals)
        F.scatter_cols_ref(*b, *vals)
        max_abs_err(a, b)
        max_abs_err(a, truth[k:k + 2])
        d_ms, e_ms = run_ms(lambda fn=fn, a=a, vals=vals: fn(*a, *vals))
        lines.append(f"{name} at [{idx.shape[0]}, {idx.shape[1]}] equal, "
                     f"device_ms={d_ms:.6f} enqueue_ms={e_ms:.6f}")

    # the churn delta timed: the kernel, its plain version, four index_copy_
    a = [x.clone() for x in stale]
    b = [x.clone() for x in stale]
    c = [x.clone() for x in stale]
    o = 3 * n_r
    ridx = staged[:n_r].long()
    eidx = staged[o:o + n_e].long()

    def library():
        c[0].index_copy_(0, ridx, staged[n_r:2 * n_r])
        c[1].index_copy_(0, ridx, staged[2 * n_r:o])
        c[2].index_copy_(0, eidx, staged[o + n_e:o + 2 * n_e])
        c[3].index_copy_(0, eidx, staged[o + 2 * n_e:])

    library()
    max_abs_err(c, truth)
    n = n_r + n_e
    rec = dict(
        **timed(lambda: F.fanout_sync(*a, staged, n_r, n_e),
                lambda: F.fanout_sync_ref(*b, staged, n_r, n_e), library),
        bytes=20 * n, ops=0, err=0,
    )
    floor, _ = run_ms(lambda x=torch.tensor(0.5, device=dev): T.add_one(x))
    rec["shape"] = (f"rows={n_r} edges={n_e} (distinct, unpadded) of tables "
                    f"{n_cap}, {e_cap}; one launch's floor (K12, scalar) "
                    f"device_ms={floor:.6f}; library: four index_copy_ calls; "
                    f"equal: " + "; ".join(lines))
    return rec


def times_line(r) -> str:
    """A record's times, kernel, plain version and library call."""
    out = [f"call_ms={r['call_ms']:.6f} device_ms={r['device_ms']:.6f} "
           f"enqueue_ms={r['enqueue_ms']:.6f}",
           f"plain call_ms={r['plain_call_ms']:.6f} device_ms={r['plain_device_ms']:.6f}"]
    if r.get("library_call_ms") is not None:
        out.append(f"library call_ms={r['library_call_ms']:.6f} device_ms="
                   f"{r['library_device_ms']:.6f} enqueue_ms={r['library_enqueue_ms']:.6f}")
    return ", ".join(out)


def add_one_edge_cases(dev):
    """K12 against its plain version, exactly, in int32 and float32: the
    scalar, 1 MB, 64 MB, an odd length (2^18 + 3) and the same from a
    view one element in (its pointer off the 16-byte grid); the 64 MB
    buffer timed against torch.add, where the bytes and not the launch
    show. Returns (the largest error, one line a case)."""
    import torch

    from emqx_tpu_torch.ops import transfer as T

    err, out = 0, []
    for dtype in (torch.int32, torch.float32):
        for n, off in ((1, 0), (1 << 18, 0), (1 << 24, 0), ((1 << 18) + 3, 0),
                       ((1 << 18) + 3, 1)):
            x = torch.arange(n + off, device=dev).to(dtype)[off:]
            err = max(err, max_abs_err([T.add_one(x)], [T.add_one_ref(x)]))
            if n == 1 << 24:
                r = timed(lambda: T.add_one(x), lambda: T.add_one_ref(x),
                          lambda: torch.add(x, 1))
                out.append(f"{str(dtype)[6:]} [{n}] 64 MB: {times_line(r)}, bound_ms="
                           f"{1e3 * 2 * x.nbytes / H100_BYTES_PER_S:.6f}")
        out.append(f"{str(dtype)[6:]} scalar, 1 MB, 64 MB, [2^18+3] and its view "
                   f"at offset 1 equal")
    return err, out


# the failure domain's counters that move only on a device fault or a
# trip; outside phase 10 no fault is injected, so each must stay at 0
FAULT_COUNTERS = ("breaker_device_failures_total", "breaker_begin_failures_total",
                  "breaker_fallback_total", "breaker_trips_total",
                  "warmup_failures_total", "warmup_probe_failures_total")


def require_no_device_fault(counters, where: str) -> None:
    """Fail the run when a phase with no injected fault re-served from
    the host, counted a device failure or tripped the breaker: its
    answers and rates would not all be the card's."""
    moved = {k: counters[k] for k in FAULT_COUNTERS if counters.get(k, 0)}
    if moved:
        raise AssertionError(f"{where}: device faults with none injected: {moved}")


def broker_phase(rng, card):
    """Phase 7. Returns (kernel records, launches in the phase, and
    (broker, skeleton filters, exact topics, deliveries) for phase 10)."""
    import torch

    from emqx_tpu_torch.obs.kernel_telemetry import KernelTelemetry
    from emqx_tpu_torch.ops import _build

    deliveries = Deliveries()
    broker, skel, exact, routes_s, subs_s = build_broker(rng, DEVICE, deliveries)
    router = broker.router
    store = router.dest_store
    log(f"broker: routes={router.stats()} sessions={len(broker.sessions)} "
        f"subscriptions={len(broker.suboptions)} clients={len(store.client_row)} "
        f"n_clients={store.client_pow2()} edges={store.stats()} "
        f"host_routes_s={routes_s:.3f} host_subscribe_s={subs_s:.3f} [{card}]")
    if store.client_pow2() != max(1024, 1 << (len(store.client_row) - 1).bit_length()):
        raise AssertionError(f"client registry at {store.client_pow2()} for "
                             f"{len(store.client_row)} clients")
    recs, versus = check_broker_kernels(broker, skel, rng, deliveries)
    # the engine's warm-up and the traffic: counters from zero just
    # before them, a fresh collector for this run's histograms
    router.telemetry = router.device_table.telemetry = KernelTelemetry()
    router.device_table.fanout.telemetry = router.telemetry
    eng = broker.enable_dispatch_engine(queue_depth=WINDOW, pipeline_depth=2,
                                        transfer_chunk_kb=0)
    # the entries of every fanout mirror sync on the path (0: nothing dirty)
    fan = router.device_table.fanout
    synced = []

    def counted_sync(real=fan.sync):
        synced.append(real())
        return synced[-1]

    fan.sync = counted_sync
    _build.reset_launches()
    t0 = time.perf_counter()
    info = eng.warmup()
    warm_s = time.perf_counter() - t0
    warm = {name: k.launches for name, k in _build.KERNELS.items()}
    rec = serve_broker(broker, skel, exact, rng, deliveries)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in _build.KERNELS.items()}
    del fan.sync
    dirty = sorted(n for n in synced if n)
    log(f"broker fanout syncs: {len(synced)} calls, {len(dirty)} with entries "
        f"(median {dirty[len(dirty) // 2] if dirty else 0}, max "
        f"{dirty[-1] if dirty else 0}); fused K6/K7 launches "
        f"{launches['fanout_sync']} [{card}]")
    tel = router.telemetry
    c = tel.counters
    require_no_device_fault(c, "phase 7's engine")
    h = tel.family_hist.get("fanout_resolve_seconds")
    log(f"broker warm-up: {info} in {warm_s:.3f} s, launches={warm} [{card}]")
    log(f"broker: {rec['publishes']} publishes in {N_WINDOWS} windows of {WINDOW}, "
        f"{rec['deliveries']} deliveries in {rec['traffic_s']:.3f} s of traffic "
        f"wall: {rec['publishes'] / rec['traffic_s']:.1f} publishes/s, "
        f"{rec['deliveries'] / rec['traffic_s']:.1f} deliveries/s "
        f"(checks {rec['check_s']:.3f} s and churn {rec['churn_s']:.3f} s "
        f"outside) [{card}]")
    log(f"broker resolves: device plans {c.get('fanout_device_plans_total', 0)}, "
        f"overlapped at begin {c.get('fanout_resolves_overlapped_total', 0)}, "
        f"synchronous in dispatch {c.get('fanout_resolves_dispatch_total', 0)}, "
        f"host (small fan) {c.get('fanout_small_fan_total', 0)}, host (host-resident "
        f"filter; no device fault and no open breaker, checked) "
        f"{c.get('fanout_host_fallback_total', 0)}; fanout_resolve_seconds "
        f"n={h.total if h else 0} p50={1e3 * h.percentile(50) if h else 0:.4f} ms "
        f"p99={1e3 * h.percentile(99) if h else 0:.4f} ms; plan hits "
        f"{c.get('fanout_plan_hits', 0)} misses {c.get('fanout_plan_misses', 0)} "
        f"stale {c.get('fanout_plan_stale', 0)} evictions "
        f"{c.get('fanout_plan_evictions_total', 0)}; ring occupancy "
        f"{eng.ring_status()['occupancy_ratio']} [{card}]")
    log(f"broker {versus} [{card}]")
    legs = {leg: {"n": hh.total, "sum_s": round(hh.sum, 6),
                  "p50_ms": round(hh.percentile(50) * 1e3, 4),
                  "p99_ms": round(hh.percentile(99) * 1e3, 4)}
            for leg, hh in sorted(list(tel.hist.items()) + list(tel.family_hist.items()))}
    log(f"broker legs (host clock, telemetry histograms): {json.dumps(legs)}")
    dev_s, p_wall, p_walk, p_n = rec["profiled"]
    st = rec["stages"]
    rest = rec["traffic_s"] - sum(st.values())
    log(f"broker time: traffic {rec['traffic_s']:.3f} s = delivery walk (inline "
        f"and deferred shards) {st['walk']:.3f} s + plan resolves in dispatch "
        f"{st['plan']:.3f} s + match begin {st['match_begin']:.3f} s + match "
        f"finish {st['match_finish']:.3f} s + publish hooks {st['pre_publish']:.3f} "
        f"s + the rest (window grouping, engine, shared election, event loop) "
        f"{rest:.3f} s; profiled pair: device busy {dev_s:.6f} s of "
        f"{p_wall:.3f} s traffic wall (share {dev_s / p_wall:.5f}), delivery "
        f"walk {p_walk:.3f} s, {p_n} deliveries [{card}]")
    log(f"broker launches (warm-up included): {launches} [{card}]")
    if c.get("fanout_device_plans_total", 0) <= 0:
        raise AssertionError("no plan was resolved on the card")
    missing = [n for n in ("resolve_fanout", "fanout_sync", "probe_add_one")
               if launches[n] <= 0]
    if missing:
        raise AssertionError(f"broker phase never launched {missing}")
    if not c.get("fanout_resolves_overlapped_total", 0):
        raise AssertionError("no overlapped resolve ran")
    return recs, launches, (broker, skel, exact, deliveries)


# --- retained reads and the server (phase 8) ---------------------------------------


def ret_filter(cls: str, rng, n_groups=None, per_group=None) -> str:
    """One filter of a phase-8 class over the `dev/{g}/{k}/state` store
    (g < n_groups, k < per_group; phase 8's sizes by default)."""
    g = int(rng.integers(0, n_groups or N_RET_GROUPS))
    k = int(rng.integers(0, per_group or N_RET_PER_GROUP))
    return {
        "A": f"dev/{g}/+/state",  # 100 names: the reference bench's filter
        "B": f"dev/{g}/#",  # 100 names
        "C": f"dev/{g}/{k}/+",  # 1 name: one bucket per name
        "D": f"+/{g}/+/state",  # 100 names; the $SYS names excluded
        "E": f"dev/+/{k}/state",  # 10,000 names
        "F": f"dev/{g}/+/nope",  # a literal no name uses: empty, no launch
        "X": f"dev/{g}/{k}/state",  # exact: a dict hit
    }[cls]


def draw_classes(mix, n, rng):
    import numpy as np

    names = [c for c, _ in mix]
    w = np.array([p for _, p in mix], float)
    return [names[i] for i in rng.choice(len(names), size=n, p=w / w.sum())]


def ret_oracle(ret, flt, granted):
    """The host walk's answer as a multiset of (topic, payload, QoS)."""
    from collections import Counter

    from emqx_tpu_torch.ops import topic as topic_mod

    names = ret._match_names(topic_mod.words(flt)) if topic_mod.is_wildcard(flt) else [flt]
    out = Counter()
    for n in names:
        m = ret._store.get(n)
        if m is not None:
            out[(n, bytes(m.payload), min(m.qos, granted))] += 1
    return out


def retained_names(n_groups=None, per_group=None, n_sys=None):
    """Phase 8's stored names in store order: `dev/{g}/{k}/state` for
    i < n_groups * per_group (g = i % n_groups, k = i // n_groups), then
    `$SYS/{g}/x/state` for g < n_sys (phase 8's sizes by default)."""
    g_n = n_groups or N_RET_GROUPS
    for i in range(g_n * (per_group or N_RET_PER_GROUP)):
        yield f"dev/{i % g_n}/{i // g_n}/state"
    for g in range(N_RET_SYS if n_sys is None else n_sys):
        yield f"$SYS/{g}/x/state"


def build_retained(device):
    """Phase 8 set-up: a Broker on the card whose Retainer stores
    N_RET_GROUPS * N_RET_PER_GROUP names `dev/{g}/{k}/state` (64-byte
    payloads, stored QoS i%3) and N_RET_SYS `$SYS/{g}/x/state`, then
    attaches the device index. Returns (broker, store seconds, attach
    seconds)."""
    from emqx_tpu_torch.broker.message import Message
    from emqx_tpu_torch.broker.pubsub import Broker
    from emqx_tpu_torch.obs.kernel_telemetry import KernelTelemetry

    broker = Broker(max_levels=16, device=device)
    ret = broker.retainer
    n = N_RET_GROUPS * N_RET_PER_GROUP
    ret.max_retained = n + N_RET_SYS + N_RET_CHURN
    t0 = time.perf_counter()
    for i, name in enumerate(retained_names()):
        if i < n:
            ret.retain(Message(topic=name, payload=b"%064d" % i, qos=i % 3, retain=True))
        else:
            ret.retain(Message(topic=name, payload=b"%064d" % (i - n), retain=True))
    store_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ret.enable_device(telemetry=KernelTelemetry())
    return broker, store_s, time.perf_counter() - t0


def retained_waves(ret, rng):
    """Phase 8 (a): filter waves through RetainedIndex.read_begin/finish,
    every answer against the host trie walk, and the timed waves also
    through Retainer.retained_read_begin/finish, whose messages must be
    the stored ones of the host walk's names. Returns (per wave size:
    device, host-walk and end-to-end filters/s; the first wave's
    seconds, which build the classes)."""
    from emqx_tpu_torch.ops import topic as topic_mod

    idx = ret._index

    def wave(n):
        return [ret_filter(c, rng) for c in draw_classes(WAVE_MIX, n, rng)]

    def check(filters, got, host=None):
        for i, (f, names) in enumerate(zip(filters, got)):
            want = host[i] if host is not None else ret._match_names(topic_mod.words(f))
            if names is not None and sorted(names) != sorted(want):
                raise AssertionError(f"retained read of {f}: {len(names)} names, "
                                     f"the host walk {len(want)}")

    def check_messages(filters, got, host):
        for f, msgs, names in zip(filters, got, host):
            if (sorted(m.topic for m in msgs) != sorted(names)
                    or any(ret._store[m.topic] is not m for m in msgs)):
                raise AssertionError(f"retained_read_finish of {f}: {len(msgs)} "
                                     f"messages, the host walk {len(names)} names")

    first = wave(RET_WAVES[0])
    t0 = time.perf_counter()
    got = idx.read_finish(idx.read_begin(first))
    first_s = time.perf_counter() - t0
    check(first, got)
    rates = {}
    for size in RET_WAVES:
        filters = wave(size)
        check(filters, idx.read_finish(idx.read_begin(filters)))
        dev_t, host_t, e2e_t = [], [], []
        for _ in range(N_TIMED_WAVES):
            filters = wave(size)
            t0 = time.perf_counter()
            got = idx.read_finish(idx.read_begin(filters))
            dev_t.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            host = [ret._match_names(topic_mod.words(f)) for f in filters]
            host_t.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            msgs = ret.retained_read_finish(ret.retained_read_begin(filters))
            e2e_t.append(time.perf_counter() - t0)
            check(filters, got, host)
            check_messages(filters, msgs, host)
        rates[size] = tuple(size / statistics.median(t) for t in (dev_t, host_t, e2e_t))
    filters = wave(SPLIT_WAVE)
    check(filters, idx.read_finish(idx.read_begin(filters)))
    return rates, first_s


def lane_matches(idx, keys):
    """Per query, the lanes whose probe byte matches (K8's nbm), from
    the host table: the fingerprints K8 reads are min(nbm, 2) a lane."""
    import numpy as np

    s = idx._slots
    mask = np.uint32(s.probe.shape[0] - 1)
    h1 = np.array([q[0] for q in keys], np.uint32)
    fp = np.array([q[1] for q in keys], np.uint32)
    with np.errstate(over="ignore"):
        b1 = h1 & mask
        b2 = b1 ^ (((fp | np.uint32(1)) * np.uint32(0x9E3779B9)) & mask)
    p8 = np.maximum(fp >> np.uint32(24), np.uint32(1))
    nbm = np.zeros(len(keys), np.int64)
    for w in (s.probe[b1], s.probe[b2]):
        for lane in range(4):
            nbm += ((w >> np.uint32(8 * lane)) & np.uint32(0xFF)) == p8
    return nbm


def k8_inputs(h1, fp, valid, dev):
    """K8's three query tensors on `dev` (h1, fp uint32, valid bool),
    built here so that the tool serves a tree with any staging."""
    import numpy as np
    import torch

    def u32(a):
        return torch.from_numpy(np.asarray(a, np.uint32).view(np.int32)).to(dev).view(
            torch.uint32)

    return u32(h1), u32(fp), torch.from_numpy(np.asarray(valid, bool)).to(dev)


def k8_crafted(rng, dev):
    """A small table of 1,024 buckets, about half its slots live, with
    hand-made lanes, and one query per case: a key stored twice (two
    verified lanes: amb), a key whose probe byte fills two more lanes
    under other fingerprints (three byte matches: amb), a byte match with
    a wrong fingerprint (-1), a verified lane whose slot is dead (its
    probe byte set, bucket id -1: -1), and a first byte match that fails
    before a second that verifies (the second's id). Returns ((probe, fp,
    bucket) on dev, [(h1, fp, case, bid wanted or None, amb wanted)])."""
    import numpy as np

    from emqx_tpu_torch import convert
    from emqx_tpu_torch.ops import hash_index as H

    nb = 1024
    live = rng.random(nb * 4) < 0.5
    fp = np.where(live, rng.integers(1 << 24, 1 << 32, nb * 4), 0).astype(np.uint32)
    bucket = np.where(live, rng.integers(0, 1 << 20, nb * 4), -1).astype(np.int32)
    used = set()

    def key(top):
        """(h1, fp, b1, b2): a probe byte `top`, two buckets no earlier
        case touched."""
        while True:
            b1 = int(rng.integers(0, nb))
            f = (top << 24) | int(rng.integers(0, 1 << 24))
            b2 = b1 ^ ((((f | 1) * 0x9E3779B9) & 0xFFFFFFFF) & (nb - 1))
            if b1 not in used and b2 not in used:
                used.update((b1, b2))
                return b1, f, b1, b2

    def seat(bkt, lane, f, g):
        fp[bkt * 4 + lane] = f
        bucket[bkt * 4 + lane] = g

    def clear(*bkts):
        for bkt in bkts:
            for lane in range(4):
                seat(bkt, lane, 0, -1)

    cases = []
    h1, f, b1, b2 = key(77)
    seat(b1, 1, f, 111)
    seat(b2, 2, f, 222)
    cases.append((h1, f, "two_verified", None, True))
    h1, f, b1, b2 = key(78)
    seat(b1, 0, f, 333)
    seat(b1, 3, f ^ 0x10, 334)
    seat(b2, 1, f ^ 0x20, 335)
    cases.append((h1, f, "three_bytes", None, True))
    h1, f, b1, b2 = key(79)
    clear(b1, b2)
    seat(b1, 2, f ^ 1, 444)
    cases.append((h1, f, "wrong_fp", -1, False))
    h1, f, b1, b2 = key(80)
    clear(b1, b2)
    seat(b1, 0, f, -1)
    dead = (b1, f)
    cases.append((h1, f, "dead_slot", -1, False))
    h1, f, b1, b2 = key(81)
    clear(b1, b2)
    seat(b1, 1, f ^ 2, 555)
    seat(b2, 3, f, 556)
    cases.append((h1, f, "second_lane", 556, False))
    slots = H.SlotArrays(fp, bucket, np.zeros(nb, np.uint32))
    H._pack_probe(slots)
    slots.probe[dead[0]] |= np.uint32(dead[1] >> 24)  # lane 0's byte, its slot dead
    return convert.retained_state_from_numpy(slots.probe, fp, bucket, dev), cases


def k8_edge_cases(idx, tabs, rng, card):
    """K8 at its edges on the card, each equal to its plain version: the
    crafted table (`k8_crafted`; each case's own answer too), its cases
    among live hits with every fifth lane and the last two padding; then
    over the live table B = 1, 257 (not a multiple of the block) and
    every rung of BATCH_LADDER: wave keys, a random (h1, fp) every eighth
    lane (a miss), a wrong full fingerprint under a hit's probe byte
    every ninth, every fifth lane padding and the last eighth padding.
    Prints device_ms and enqueue_ms at every size. Returns the largest
    error (0)."""
    import numpy as np
    import torch

    from emqx_tpu_torch.ops import retained as RI

    dev = tabs[0].device
    ctabs, cases = k8_crafted(rng, dev)
    c_fp = ctabs[1].cpu().view(torch.int32).numpy().view(np.uint32)
    live = np.flatnonzero(ctabs[2].cpu().numpy() >= 0)[:40]
    h1, fp = [int(s) // 4 for s in live], [int(c_fp[s]) for s in live]
    for k, case in enumerate(cases):
        h1.insert(5 * k + 1, case[0])
        fp.insert(5 * k + 1, case[1])
    valid = np.array([i % 5 != 4 and i < len(h1) - 2 for i in range(len(h1))])
    q = k8_inputs(h1, fp, valid, dev)
    got = RI.probe_retained(*ctabs, *q)
    err = max_abs_err(got, RI.probe_retained_ref(*ctabs, *q))
    bid, amb = (x.cpu().numpy() for x in got)
    for k, (_h1, _fp, case, want_bid, want_amb) in enumerate(cases):
        j = 5 * k + 1
        if bool(amb[j]) != want_amb or want_bid not in (None, int(bid[j])):
            raise AssertionError(f"K8 crafted case {case}: bid {int(bid[j])} amb "
                                 f"{bool(amb[j])}, wanted {want_bid} {want_amb}")
    if amb[~valid].any() or (bid[~valid] != -1).any():
        raise AssertionError("K8 answered a padding lane")
    lines = [f"crafted ({', '.join(c[2] for c in cases)}) equal"]
    for b in (1, 257) + tuple(RI.BATCH_LADDER):
        h1, fp = [], []
        while len(h1) < b:
            n = len(h1)
            if n % 8 == 7:
                h1.append(int(rng.integers(0, 1 << 32)))
                fp.append(int(rng.integers(0, 1 << 32)))
                continue
            qk = idx._query(ret_filter(draw_classes(WAVE_MIX[:5], 1, rng)[0], rng))
            if isinstance(qk, str):
                continue
            h1.append(qk[0])
            fp.append(qk[1] ^ 1 if n % 9 == 8 and qk[1] >> 24 >= 2 else qk[1])
        valid = [i % 5 != 4 and i < b - b // 8 for i in range(b)]
        q = k8_inputs(h1, fp, valid, dev)
        got = RI.probe_retained(*tabs, *q)
        err = max(err, max_abs_err(got, RI.probe_retained_ref(*tabs, *q)))
        d_ms, e_ms = run_ms(lambda: RI.probe_retained(*tabs, *q))
        lines.append(f"B={b}: hits={int((got[0] >= 0).sum())} amb={int(got[1].sum())} "
                     f"device_ms={d_ms:.6f} enqueue_ms={e_ms:.6f}")
    log(f"K8 edge cases, each equal to its plain version: {'; '.join(lines)} [{card}]")
    return err


def check_retained_kernel(ret, rng, card):
    """Phase 8 (b): K8 at its edge cases (`k8_edge_cases`), then against
    its plain version on the card over the live table, at B=4096 (a
    wave's top rung) and B=8 (a SUBSCRIBE packet's rung), hits, misses
    and a padding lane, timed. Returns the record."""
    import numpy as np
    import torch

    from emqx_tpu_torch.ops import retained as RI

    idx = ret._index
    tabs = idx._device_tables()
    edge_err = k8_edge_cases(idx, tabs, rng, card)
    out = {}
    for b in (RI.MAX_BATCH, RI.BATCH_LADDER[0]):
        # the wave mix's probe keys, every eighth one a random (h1, fp)
        # (a miss), and the last lane padding
        keys = []
        while len(keys) < b - 1:
            if len(keys) % 8 == 7:
                keys.append(tuple(int(x) for x in rng.integers(0, 1 << 32, 2)))
                continue
            q = idx._query(ret_filter(draw_classes(WAVE_MIX[:5], 1, rng)[0], rng))
            if not isinstance(q, str):
                keys.append(q)
        staged = idx._stage(keys)
        got = RI.probe_retained(*tabs, *staged)
        err = max_abs_err(got, RI.probe_retained_ref(*tabs, *staged))
        hits = int((got[0] >= 0).sum())
        nbm = lane_matches(idx, keys)
        # queries in (9 B), two probe words per valid lane, the
        # fingerprints the lane screen passes (at most two), a bucket id
        # per hit, outputs (5 B)
        nbytes = (b * 9 + len(keys) * 8 + int(np.minimum(nbm, 2).sum()) * 4
                  + hits * 4 + b * 5)
        out[b] = dict(
            **timed(lambda: RI.probe_retained(*tabs, *staged),
                    lambda: RI.probe_retained_ref(*tabs, *staged)),
            bytes=nbytes, ops=b * 40, err=err,
            shape=f"B={b} buckets={int(tabs[0].shape[0])} hits={hits} "
                  f"amb={int(got[1].sum())} lanes_screened={int(nbm.sum())}",
        )
    torch.cuda.synchronize()
    set_bounds(out)
    small = out[RI.BATCH_LADDER[0]]
    rec = out[RI.MAX_BATCH]
    rec["err"] = max(rec["err"], small["err"], edge_err)
    rec["shape"] += (f"; at B=8: {times_line(small)} "
                     f"bound_ms={small['bound_ms']:.9f} [{small['shape']}]")
    return rec


class MqttClient:
    """One raw-socket MQTT client over the port's frame codec. A reader
    task parses what arrives, PUBACKs every QoS 1 PUBLISH at once, and
    queues the packets."""

    def __init__(self, cid, ver, stats):
        self.cid = cid
        self.ver = ver
        self.stats = stats
        self.subs = {}  # filter -> granted QoS
        self.pending = []  # SUBSCRIBEs not yet checked

    async def connect(self, addr):
        import asyncio

        from emqx_tpu_torch.broker import frame
        from emqx_tpu_torch.broker import packet as P

        self.P = P
        self.frame = frame
        self.reader, self.writer = await asyncio.open_connection(*addr)
        self.parser = frame.Parser(proto_ver=self.ver)
        self.queue = asyncio.Queue()
        self.task = asyncio.get_running_loop().create_task(self._read())
        self.send(P.Connect(proto_ver=self.ver, client_id=self.cid, keepalive=0))
        ack = await self.next()
        if not isinstance(ack, P.Connack) or ack.code != 0:
            raise AssertionError(f"{self.cid}: {ack}")

    async def _read(self):
        P = self.P
        try:
            while True:
                data = await self.reader.read(1 << 16)
                if not data:
                    return
                for p in self.parser.feed(data):
                    if isinstance(p, P.Publish) and p.qos == 1:
                        self.send(P.Puback(P.Type.PUBACK, p.packet_id))
                    self.queue.put_nowait(p)
        finally:
            self.queue.put_nowait(None)  # wakes `next`, which reports why

    def send(self, pkt):
        self.writer.write(self.frame.serialize(pkt, self.ver))

    async def next(self):
        import asyncio

        p = await asyncio.wait_for(self.queue.get(), 120)
        if p is None:
            await asyncio.wait({self.task}, timeout=5)
            t = self.task
            if t.done() and not t.cancelled() and t.exception() is not None:
                raise t.exception()
            raise AssertionError(f"{self.cid}: the server closed the connection")
        return p

    async def subscribe(self, pid, filters):
        """One SUBSCRIBE of [(filter, QoS, retain_handling)] followed by a
        PINGREQ; keeps everything that arrives before the PINGRESP for
        `check`."""
        P = self.P
        due = [rh == 0 or (rh == 1 and f not in self.subs) for f, _q, rh in filters]
        self.subs.update((f, q) for f, q, _ in filters)
        t0 = time.perf_counter()
        self.send(P.Subscribe(pid, [(f, P.SubOpts(qos=q, retain_handling=rh))
                                    for f, q, rh in filters]))
        self.send(P.Pingreq())
        ack = await self.next()
        self.stats["suback_s"].append(time.perf_counter() - t0)
        got = []
        while True:
            p = await self.next()
            if isinstance(p, P.Pingresp):
                break
            got.append(p)
        self.pending.append((filters, due, ack, got))
        self.stats["subscribes"] += 1
        self.stats["retained"] += len(got)

    def check(self, ret):
        """Each SUBACK grants each QoS, and the retained PUBLISHes after
        it are the host walk's multiset, retain flag set: nothing for
        retain_handling 2 or for 1 on an existing subscription."""
        from collections import Counter

        P = self.P
        for filters, due, ack, got in self.pending:
            if not isinstance(ack, P.Suback) or list(ack.codes) != [q for _, q, _ in filters]:
                raise AssertionError(f"{self.cid}: {ack} for {filters}")
            want = Counter()
            for (f, q, _rh), d in zip(filters, due):
                if d:
                    want.update(ret_oracle(ret, f, q))
            seen = Counter()
            for p in got:
                if not isinstance(p, P.Publish) or not p.retain:
                    raise AssertionError(f"{self.cid}: {p} after the SUBACK")
                seen[(p.topic, bytes(p.payload), p.qos)] += 1
            if seen != want:
                raise AssertionError(
                    f"{self.cid}: retained PUBLISHes for {filters} differ from the "
                    f"host walk ({sum(seen.values())} vs {sum(want.values())})")
        self.pending.clear()

    async def barrier(self):
        """PINGREQ, then everything that arrives before the PINGRESP."""
        P = self.P
        self.send(P.Pingreq())
        extra = []
        while True:
            p = await self.next()
            if isinstance(p, P.Pingresp):
                return extra
            extra.append(p)

    async def close(self):
        self.writer.close()
        self.task.cancel()


def client_filters(rng, n):
    """n distinct filters of CLIENT_MIX with their grants: QoS 1 for C
    and X, QoS 0 for the rest; retain_handling 0."""
    out = {}
    while len(out) < n:
        cls = draw_classes(CLIENT_MIX, 1, rng)[0]
        out.setdefault(ret_filter(cls, rng), 1 if cls in ("C", "X") else 0)
    return [(f, q, 0) for f, q in out.items()]


def churn_publishes(ret, rng):
    """Between the rounds: N_RET_CHURN new retained names, as many
    deletes (empty payload) and as many replaces, QoS 0 and 1."""
    from emqx_tpu_torch.broker import packet as P

    pubs = []
    names = set()
    while len(names) < 2 * N_RET_CHURN:
        names.add(f"dev/{int(rng.integers(0, N_RET_GROUPS))}/"
                  f"{int(rng.integers(0, N_RET_PER_GROUP))}/state")
    names = sorted(names)
    rng.shuffle(names)
    for j in range(N_RET_CHURN):
        g = int(rng.integers(0, N_RET_GROUPS))
        pubs.append((f"dev/{g}/{N_RET_PER_GROUP + j}/state", b"n%063d" % j))
        pubs.append((names[j], b""))
        pubs.append((names[N_RET_CHURN + j], b"r%063d" % j))
    return [P.Publish(topic=t, payload=pl, qos=k % 2, retain=True,
                      packet_id=k + 1 if k % 2 else None)
            for k, (t, pl) in enumerate(pubs)]


def server_phase(broker, rng, card):
    """Phase 8 (c): the port's Server over the card broker; N_CLIENTS TCP
    clients (half MQTT 5, half 3.1.1) in two rounds of SUBSCRIBEs, with
    retained churn from a publisher client between them. Returns the
    record and K8's launches in the phase."""
    import asyncio
    import resource
    from collections import Counter

    from emqx_tpu_torch.broker.server import Server
    from emqx_tpu_torch.obs.kernel_telemetry import KernelTelemetry
    from emqx_tpu_torch.ops import _build

    ret = broker.retainer
    idx = ret._index
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    need = 2 * N_CLIENTS + 256
    if soft < need and (hard == resource.RLIM_INFINITY or hard >= need):
        resource.setrlimit(resource.RLIMIT_NOFILE, (need, hard))
    elif soft < need:
        raise AssertionError(f"open-file limit {soft}/{hard} is below {need}")
    stats = dict(subscribes=0, retained=0, suback_s=[])
    rec = {}
    # K8's launches by ladder rung: every launch stages its rung first
    rungs = Counter()
    real_stage = idx._stage

    def stage_counted(chunk):
        staged = real_stage(chunk)
        rungs[int(staged[0].shape[0])] += 1
        return staged

    async def run():
        srv = Server(broker, host="127.0.0.1", port=0)
        await srv.start()
        clients = [MqttClient(f"rc{i}", 5 if i % 2 else 4, stats) for i in range(N_CLIENTS)]
        pub = MqttClient("publisher", 4, stats)
        try:
            for base in range(0, N_CLIENTS, 64):
                await asyncio.gather(*(c.connect(srv.listen_addr)
                                       for c in clients[base:base + 64]))
            await pub.connect(srv.listen_addr)
            drops = {k: v for k, v in broker.metrics.all().items() if k.startswith("delivery.dropped")}
            # counters from zero after the connects, just before the traffic
            _build.reset_launches()
            idx.tel = KernelTelemetry()
            idx._stage = stage_counted
            walls = []
            for r in range(2):
                t0 = time.perf_counter()
                await asyncio.gather(*(c.subscribe(10 * r + 1, client_filters(rng, SUB_FILTERS))
                                       for c in clients))
                # single-filter SUBSCRIBEs: the B=1 read of Broker._read_retained
                await asyncio.gather(*(
                    c.subscribe(10 * r + 2, [(ret_filter(cls, rng), 0, 0)])
                    for c, cls in zip(clients[:N_SINGLE],
                                      draw_classes(WAVE_MIX[:4], N_SINGLE, rng))))
                # retain_handling 1 on an existing subscription, 2 on a new one
                rh1 = clients[N_SINGLE:N_SINGLE + N_RH]
                rh2 = clients[N_SINGLE + N_RH:N_SINGLE + 2 * N_RH]
                await asyncio.gather(
                    *(c.subscribe(10 * r + 3, [next(iter(c.subs.items())) + (1,)])
                      for c in rh1),
                    *(c.subscribe(10 * r + 4, [(ret_filter("A", rng), 0, 2)])
                      for c in rh2))
                walls.append(time.perf_counter() - t0)
                for c in clients:
                    c.check(ret)
                if r == 0:
                    t0 = time.perf_counter()
                    churn = churn_publishes(ret, rng)
                    for p in churn:
                        pub.send(p)
                    acks = await pub.barrier()
                    rec["churn_s"] = time.perf_counter() - t0
                    if len(acks) != sum(p.qos for p in churn):
                        raise AssertionError(f"publisher got {len(acks)} PUBACKs")
                    live = await asyncio.gather(*(c.barrier() for c in clients))
                    rec["live"] = sum(map(len, live))
                    rec["churn"] = len(churn)
            rec["walls"] = walls
            after = {k: v for k, v in broker.metrics.all().items() if k.startswith("delivery.dropped")}
            if after != drops or any(s.dropped for s in broker.sessions.values()):
                raise AssertionError(f"drops moved: {drops} -> {after}")
        finally:
            idx.__dict__.pop("_stage", None)
            for c in clients + [pub]:
                if hasattr(c, "writer"):
                    await c.close()
            await srv.stop()

    asyncio.run(run())
    rec.update(stats)
    rec["launches"] = _build.KERNELS["retained_probe"].launches
    rec["rungs"] = dict(sorted(rungs.items()))
    c = idx.tel.counters
    rec["device_reads"] = c.get("retained_device_reads_total", 0)
    rec["host_reads"] = c.get("retained_host_fallback_total", 0)
    rec["builds"] = c.get("retained_index_builds_total", 0)
    return rec


def cli_server_check():
    """Phase 8 (d): `python -m emqx_tpu_torch.broker.server` as a user
    starts it (the card by default, the retained leg on) serves a
    retained read to a raw-socket client. Returns the seconds from the
    start to the first answered SUBSCRIBE."""
    import os
    import socket
    import subprocess

    from emqx_tpu_torch.broker import frame
    from emqx_tpu_torch.broker import packet as P

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "emqx_tpu_torch.broker.server", "--host", "127.0.0.1",
         "--port", str(port)],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
    )
    try:
        while True:
            try:
                sock = socket.create_connection(("127.0.0.1", port), timeout=30)
                break
            except OSError:
                if proc.poll() is not None:
                    raise AssertionError(f"the server exited: {proc.stderr.read().decode()}")
                if time.perf_counter() - t0 > 120:
                    raise AssertionError("the server never listened")
                time.sleep(0.2)
        with sock:
            parser = frame.Parser(proto_ver=5)
            got = []

            def recv(n):
                while len(got) < n:
                    data = sock.recv(1 << 16)
                    if not data:
                        raise AssertionError("the server closed the connection")
                    got.extend(parser.feed(data))
                out = got[:n]
                del got[:n]
                return out

            def send(pkt):
                sock.sendall(frame.serialize(pkt, 5))

            send(P.Connect(proto_ver=5, client_id="cli", keepalive=0))
            recv(1)
            names = [f"cli/{i}/state" for i in range(8)]
            for i, t in enumerate(names):
                send(P.Publish(topic=t, payload=b"%d" % i, retain=True))
            send(P.Subscribe(1, [("cli/+/state", P.SubOpts(qos=0)),
                                 ("cli/#", P.SubOpts(qos=0))]))
            ack, *pubs = recv(1 + 2 * len(names))
            if not isinstance(ack, P.Suback) or sorted(p.topic for p in pubs) != sorted(names * 2):
                raise AssertionError(f"the CLI server answered {ack} and {len(pubs)} PUBLISHes")
        return time.perf_counter() - t0
    finally:
        proc.terminate()
        proc.wait(timeout=60)


def retained_phase(rng, card):
    """Phase 8. Returns (K8's record, K8's launches in the server run)."""
    import torch

    t_phase = time.perf_counter()
    stages = {}
    broker, store_s, attach_s = build_retained(DEVICE)
    stages["set-up"] = time.perf_counter() - t_phase
    ret = broker.retainer
    idx = ret._index
    log(f"retained: {len(ret)} names stored in {store_s:.3f} s, device index "
        f"attached in {attach_s:.3f} s [{card}]")
    t0 = time.perf_counter()
    rates, first_s = retained_waves(ret, rng)
    stages["waves"] = time.perf_counter() - t0
    c = idx.tel.counters
    dev_reads = c.get("retained_device_reads_total", 0)
    host_reads = c.get("retained_host_fallback_total", 0)
    log(f"retained waves: first wave (class builds, mirror upload, ladder) "
        f"{first_s:.3f} s; classes={len(idx._cls_plen)} buckets={idx._n_buckets} "
        f"bucket_ids={len(idx._key_bid)}; device reads {dev_reads}, host "
        f"fallbacks {host_reads} [{card}]")
    if dev_reads < 0.99 * (dev_reads + host_reads):
        raise AssertionError(f"device reads {dev_reads} of {dev_reads + host_reads}")
    for size, (dev, host, e2e) in rates.items():
        log(f"retained wave of {size}: device {dev:.1f} filters/s vs host walk "
            f"{host:.1f} filters/s ({dev / host:.2f}x); retained_read_begin/finish "
            f"{e2e:.1f} filters/s [{card}]")
    t0 = time.perf_counter()
    rec = check_retained_kernel(ret, rng, card)
    stages["kernel"] = time.perf_counter() - t0
    log(f"kernel retained_probe: {times_line(rec)} "
        f"bound_ms={rec['bound_ms']:.6f} [{rec['shape']}] [{card}]")
    t0 = time.perf_counter()
    s = server_phase(broker, rng, card)
    torch.cuda.synchronize()
    stages["server"] = time.perf_counter() - t0
    wall = sum(s["walls"])
    lat = sorted(s["suback_s"])
    reads = s["device_reads"] + s["host_reads"]
    log(f"server: {N_CLIENTS} clients, {s['subscribes']} SUBSCRIBEs and "
        f"{s['retained']} retained PUBLISHes in {wall:.3f} s of rounds: "
        f"{s['subscribes'] / wall:.1f} subscribes/s, {s['retained'] / wall:.1f} "
        f"retained messages/s; SUBACK latency p50 "
        f"{1e3 * lat[len(lat) // 2]:.3f} ms p99 {1e3 * lat[int(len(lat) * 0.99)]:.3f} ms; "
        f"device reads {s['device_reads']}, host fallbacks {s['host_reads']}, "
        f"index builds {s['builds']}; churn of {s['churn']} retained publishes "
        f"served in {s['churn_s']:.3f} s ({s['live']} live deliveries); "
        f"K8 launches {s['launches']}, by rung {s['rungs']} [{card}]")
    if s["launches"] <= 0:
        raise AssertionError("the server phase never launched K8")
    if s["device_reads"] < 0.99 * reads:
        raise AssertionError(f"device reads {s['device_reads']} of {reads} wildcard reads")
    t0 = time.perf_counter()
    log(f"cli: python -m emqx_tpu_torch.broker.server served a retained read "
        f"{cli_server_check():.3f} s after its start [{card}]")
    stages["cli"] = time.perf_counter() - t0
    log(f"phase 8: {time.perf_counter() - t_phase:.3f} s ("
        + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items()) + f") [{card}]")
    return rec, s["launches"]


# --- the sub-sharded mesh routing path (phase 9) -----------------------------------


def mesh_of(shape):
    """A (dp, sub) mesh whose every shard sits on DEVICE (one card)."""
    from emqx_tpu_torch.parallel.mesh import make_mesh

    n_dp, n_sub = shape
    return make_mesh(n_dp, n_sub, devices=[DEVICE] * (n_dp * n_sub))


def host_rows(router, topic):
    """The table rows of the filters the host oracle (Router.match_filters:
    exact dict + trie walk) gives for `topic`, sorted."""
    import numpy as np

    rows = []
    for f in router.match_filters(topic):
        r = router._filter_row.get(f)
        if r is None:
            r = router._exact_row[f]
        rows.append(r)
    return np.sort(np.array(rows, np.int64))


def u32(t):
    """A uint32 tensor's int32 view (comparisons, host copies)."""
    import torch

    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def dense_work(filters, b):
    """(bytes, operations) the dense predicate needs for b topics over a
    table: the active mask, each live row once, the topics once; per
    (topic, live row) its length/flag checks and a compare per level."""
    L = int(filters.words.shape[1])
    act = filters.active
    n_act = int(act.sum())
    plen_sum = int(filters.prefix_len[act].sum())
    n = int(act.shape[0])
    return n + n_act * (4 * L + 6) + b * (4 * L + 5), b * (plen_sum + 3 * n_act), n_act


# K10's and K13 packed's edge tables (phase 9 (a) and (d); the CPU tests
# build the same ones through `form_edge_case`): name -> (max_levels,
# topics, pad_to). Each case's snapshot keeps FORM_EDGE_ROWS rows (4.5 of
# the packed kernel's 256-row blocks on one device, 1.125 a sub shard of
# the (2, 4) mesh); the padded (1, 3) layout keeps one row fewer (three
# shards of 384 rows, one of them a pad row).
FORM_EDGE_ROWS = 1152
FORM_EDGES = {
    "dead_words": (6, 48, 0),   # a dead block, dead words, lone live rows
    "deep": (24, 48, 0),        # rows of 17-24 levels, decided past level 16
    "levels7": (7, 48, 0),      # max_levels not a multiple of 4
    "sys": (6, 48, 0),          # '#' and '+/#' rows against $SYS topics
    "topics37": (6, 37, 0),     # B not a multiple of a topic group or tile
    "topics37_pad64": (6, 37, 64),
    "topics1000": (6, 1000, 0),
    "topics1000_pad1024": (6, 1000, 1024),
}
# The counts' own edge (K11 and K13 counts only: the bitmap refuses it):
# FORM_EDGES' COUNTS_EDGE table cut to COUNTS_EDGE_ROWS rows, a multiple
# neither of 32 nor of a block's 256 rows (shards of 286 rows on the
# (2, 4) mesh, 381 on the (1, 3) layout); live rows lie past the cut.
COUNTS_EDGE, COUNTS_EDGE_ROWS = "dead_words", FORM_EDGE_ROWS - 11
EDGE_WORDS = ("a", "b", "c", "dev", "")  # filter levels; topics add "zz", in no filter


def edge_filter(rng, levels):
    n = int(rng.integers(1, levels + 1))
    ws = [str(rng.choice(EDGE_WORDS + ("+",))) for _ in range(n)]
    if rng.random() < 0.35:
        ws[-1] = "#"
    if rng.random() < 0.1:
        ws[0] = "$SYS"
    return "/".join(ws)


def edge_topic(rng, levels):
    n = int(rng.integers(1, levels + 2))
    ws = [str(rng.choice(EDGE_WORDS + ("zz",))) for _ in range(n)]
    if rng.random() < 0.15:
        ws[0] = str(rng.choice(["$SYS", "$x"]))
    return "/".join(ws)


def deep_family(rng, n):
    """n filters of 17-24 levels sharing a 16-level base, so that the
    levels past 16 decide which of them a topic matches."""
    base = [str(rng.choice(EDGE_WORDS + ("+",), p=[0.17] * 5 + [0.15])) for _ in range(16)]
    out = []
    for _ in range(n):
        ws = base + [str(rng.choice(EDGE_WORDS + ("+",))) for _ in range(int(rng.integers(1, 9)))]
        if rng.random() < 0.35:
            ws.append("#")
        out.append("/".join(ws))
    return out


def instantiate_edge(rng, flt, mutate=False):
    """A topic `flt` matches ('+' a word, '#' 0-2 words); with `mutate`,
    one level past 16 becomes "zz", which no filter holds."""
    ws = []
    for w in flt.split("/"):
        if w == "+":
            ws.append(str(rng.choice(EDGE_WORDS)))
        elif w == "#":
            ws += [str(rng.choice(EDGE_WORDS)) for _ in range(int(rng.integers(0, 3)))]
        else:
            ws.append(w)
    if mutate:
        ws[int(rng.integers(16, len(ws)))] = "zz"
    return "/".join(ws)


def form_edge_case(case, *table_types):
    """Edge case `case` of FORM_EDGES: one table of each of table_types
    (the port's FilterTable; in the tests also the reference's),
    capacity 2,048, fed the same adds and removes from numpy's generator
    seeded with the case's index. Returns (tables, topics, pad_to); every
    live row lies below FORM_EDGE_ROWS - 1."""
    import numpy as np

    levels, n_topics, pad_to = FORM_EDGES[case]
    rng = np.random.default_rng(list(FORM_EDGES).index(case))
    n = FORM_EDGE_ROWS - 1
    if case == "deep":
        deep = [f for _ in range(12) for f in deep_family(rng, 40)]
        flts = deep + [edge_filter(rng, 6) for _ in range(n - len(deep))]
        flts = [flts[i] for i in rng.permutation(n)]
        picks = rng.choice(len(deep), n_topics // 2, replace=False)
        topics = [instantiate_edge(rng, deep[i], mutate=k % 3 == 2) for k, i in enumerate(picks)]
        topics += [edge_topic(rng, 26) for _ in range(n_topics - len(topics))]
    elif case == "sys":
        special = ["#", "+/#", "$SYS/#", "+/+", "$SYS/+"] * 32
        flts = special + [edge_filter(rng, levels) for _ in range(n - len(special))]
        flts = [flts[i] for i in rng.permutation(n)]
        topics = ["$SYS/" + edge_topic(rng, 4) for _ in range(n_topics // 2)]
        topics += [edge_topic(rng, levels) for _ in range(n_topics - len(topics))]
    else:
        flts = [edge_filter(rng, levels) for _ in range(n)]
        topics = [edge_topic(rng, levels) for _ in range(n_topics)]
    tables = [T(max_levels=levels, capacity=2048) for T in table_types]
    for f in flts:
        rows = {t.add(f) for t in tables}
        if len(rows) != 1:
            raise AssertionError(f"the tables put {f!r} at rows {rows}")
    if case == "dead_words":
        # rows 512-767 (a whole block), words 1, 2 and 5, words 3, 7 and 30
        # but one row each, then one row in three of the rest
        lone = {113, 255, 960}
        dead = set(range(512, 768)) | set(range(32, 96)) | set(range(160, 192))
        dead |= (set(range(96, 128)) | set(range(224, 256)) | set(range(960, 992))) - lone
        rest = np.array(sorted(set(range(n)) - dead - lone))
        dead |= set(rest[rng.random(len(rest)) < 1 / 3].tolist())
    else:
        dead = set(np.flatnonzero(rng.random(n) < 0.25).tolist())
    for r in sorted(dead):
        for t in tables:
            t.remove(r)
    return tables, topics, pad_to


def forms_inputs(mods, dev, seed=3):
    """Phase 9's dense forms at full width, as tools/wrapper_ab.py and
    tools/packed_variants.py time them: add_route_set's route set in a
    Router(max_levels=16) table (2,097,152 rows) and 1,024 of
    publish_batch's topics, from numpy's generator seeded with `seed`.
    `mods` maps "models.router", "ops.match", "parallel.mesh" and
    "parallel.sharded_match" to one tree's modules. Returns (snap, enc,
    f, t, (mesh, fm, tm), (want_k10, want_k13)): the host arrays, the
    table and topics on `dev`, the (2, 4) mesh of `dev` with its placed
    table and topics, and the plain versions' bitmaps (int32 views)."""
    import numpy as np
    import torch

    M, MS, S = mods["ops.match"], mods["parallel.mesh"], mods["parallel.sharded_match"]
    rng = np.random.default_rng(seed)
    router = mods["models.router"].Router(max_levels=16, device=dev)
    skel, exact, _s = add_route_set(router, rng)
    snap = router.table.snapshot()
    enc = M.encode_topics(router.table.vocab, publish_batch(rng, skel, exact), 16)
    del router
    f = M.EncodedFilters(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in snap))
    t = M.EncodedTopics(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in enc))
    b, n = int(t.ids.shape[0]), int(f.words.shape[0])
    mesh = MS.make_mesh(2, 4, devices=[dev] * 8)
    (fm,), (tm,) = MS.put_filters(snap, mesh), MS.put_topics(enc, mesh)
    want13 = torch.zeros((b, n // 32), dtype=torch.int32, device=dev)
    S.dense_tiles_ref(M.FORM_PACKED, fm, tm, S._tiles(mesh, 0), n // 4, b // 2, want13)
    return snap, enc, f, t, (mesh, fm, tm), (u32(M.match_packed_ref(f, t)), want13)


def form_edge_checks(layout, card):
    """K9, K10 and K11 (layout "single") or K13 packed and counts (layout
    (2, 4), or (1, 3): the padded layout, FORM_EDGE_ROWS - 1 rows) on the
    card on every FORM_EDGES table, and the counts (and on one device the
    matrix) alone on the counts' own edge (COUNTS_EDGE's table cut to
    COUNTS_EDGE_ROWS rows: K9's output rows are not 16-byte aligned),
    each held against its plain version exactly; on one device every
    topic's rows and count also against the table's host oracle, and
    K9's matrix against K10's bitmap unpacked. Returns one line a case."""
    import numpy as np
    import torch

    from emqx_tpu_torch.device import resolve, to_device
    from emqx_tpu_torch.ops import match as M
    from emqx_tpu_torch.ops.table import EncodedFilters, FilterTable
    from emqx_tpu_torch.parallel import mesh as MS
    from emqx_tpu_torch.parallel import sharded_match as S

    dev = resolve(DEVICE)
    cases = [(case, FORM_EDGE_ROWS - (layout == (1, 3)), True) for case in FORM_EDGES]
    cases.append((COUNTS_EDGE, COUNTS_EDGE_ROWS, False))
    out = []
    for case, n_rows, packed in cases:
        (t,), topics, pad_to = form_edge_case(case, FilterTable)
        name = case if packed else f"{case} rows={n_rows} (counts only)"
        snap = EncodedFilters(*(a[:n_rows] for a in t.snapshot()))
        enc = M.encode_topics(t.vocab, topics, t.max_levels, pad_to=pad_to)
        host = None
        if layout == "single":
            f = EncodedFilters(*(to_device(a, dev) for a in snap))
            d = M.EncodedTopics(*(to_device(a, dev) for a in enc))
            counts = M.match_counts(f, d)
            max_abs_err([counts], [M.match_counts_ref(f, d)])
            dense = M.match_dense(f, d)
            max_abs_err([dense], [M.match_dense_ref(f, d)])
            hd = dense.cpu().numpy()
            if packed:
                got = M.match_packed(f, d, chunk=n_rows)
                max_abs_err([u32(got)], [u32(M.match_packed_ref(f, d, chunk=n_rows))])
                host = u32(got).cpu().numpy().view(np.uint32)
                if not np.array_equal(hd, np.unpackbits(host.view(np.uint8), axis=1,
                                                        bitorder="little").astype(bool)):
                    raise AssertionError(f"K9 {case} differs from K10's bitmap")
            hc = counts.cpu().numpy()
            for i, rows in enumerate(M.oracle_match_rows(t, topics)):
                rows = rows[rows < n_rows]
                if hc[i] != len(rows):
                    raise AssertionError(f"K11 {name} topic {topics[i]!r}: count {hc[i]} "
                                         f"differs from the host oracle's {len(rows)}")
                if not np.array_equal(np.flatnonzero(hd[i]), rows):
                    raise AssertionError(f"K9 {name} topic {topics[i]!r}: rows differ "
                                         f"from the host oracle")
                if host is not None and not np.array_equal(M.unpack_indices(host[i]), rows):
                    raise AssertionError(f"K10 {case} topic {topics[i]!r}: rows differ "
                                         f"from the host oracle")
            if hc[len(topics):].any() or hd[len(topics):].any():
                raise AssertionError(f"K9/K11 {name}: a pad topic matches")
        else:
            mesh = mesh_of(layout)
            (f,), (d,) = MS.put_filters(snap, mesh), MS.put_topics(enc, mesh)
            counts_k, packed_k, _apply = S.make_sharded_kernels(mesh)
            n_loc, b_loc = f.words.shape[0] // layout[1], d.ids.shape[0] // layout[0]
            if (n_loc % 32 == 0) != packed:
                raise AssertionError(f"{name} on {layout}: {n_loc} rows a shard")
            counts = counts_k((f,), (d,))
            want = torch.zeros(counts.shape, dtype=torch.int32, device=counts.device)
            S.dense_tiles_ref(M.FORM_COUNTS, f, d, S._tiles(mesh, 0), n_loc, b_loc, want)
            max_abs_err([counts], [want])
            if packed:
                got = packed_k((f,), (d,))
                want = torch.zeros(got.shape, dtype=torch.int32, device=got.device)
                S.dense_tiles_ref(M.FORM_PACKED, f, d, S._tiles(mesh, 0), n_loc, b_loc, want)
                max_abs_err([u32(got)], [want])
                host = u32(got).cpu().numpy().view(np.uint32)
            hc = counts.cpu().numpy()
        line = (f"{name} (B={hc.shape[0]} N={n_rows} L={t.max_levels} "
                f"live={int(snap.active.sum())}): equal, matches={int(hc.sum())}")
        if host is not None:
            line += f", set_bits={int(np.unpackbits(host.view(np.uint8)).sum())}"
        out.append(line)
    torch.cuda.synchronize()
    return out


# rows a block of packed_match.cu's counts mode (its PT): the unit of
# its global atomics
COUNTS_BLOCK_ROWS = 256


def counts_atomics(active, packed):
    """(at most, nonzero): the global atomics of the counts kernel on a
    table, from its active mask and its bitmap ([B, N/32], N a multiple
    of COUNTS_BLOCK_ROWS): at most one a (live block, topic), and one
    where the block's rows match the topic. The same for K11 and for
    K13 counts on a mesh whose shard rows are a multiple of the block."""
    b = packed.shape[0]
    live = int(active.view(-1, COUNTS_BLOCK_ROWS).any(dim=1).sum())
    nonzero = int((u32(packed).view(b, -1, COUNTS_BLOCK_ROWS // 32) != 0).any(dim=2).sum())
    return live * b, nonzero


def check_dense_forms(router, topics, card):
    """Phase 9 (a): K9-K11 on the card over the route table (its full
    capacity) against their plain versions; K10/K11 at BATCH topics, K9
    at DENSE_B; MESH_ORACLE_TOPICS topics against the host oracle; K9,
    K10 and K11 on FORM_EDGES' tables, K9 and K11 on the counts' own
    edge."""
    import numpy as np
    import torch

    from emqx_tpu_torch.device import resolve, to_device
    from emqx_tpu_torch.ops import match as M
    from emqx_tpu_torch.ops.table import EncodedFilters

    dev = resolve(DEVICE)
    t = router.table
    filters = EncodedFilters(*(to_device(a, dev) for a in t.snapshot()))
    enc = M.encode_topics(t.vocab, topics, router.max_levels)
    denc = M.EncodedTopics(*(to_device(a, dev) for a in enc))
    small = M.EncodedTopics(*(x[:DENSE_B] for x in denc))
    B, L = enc.ids.shape
    N = int(filters.words.shape[0])
    recs = {}
    packed = M.match_packed(filters, denc)
    err = max_abs_err([u32(packed)], [u32(M.match_packed_ref(filters, denc))])
    counts = M.match_counts(filters, denc)
    err_c = max_abs_err([counts], [M.match_counts_ref(filters, denc)])
    dense = M.match_dense(filters, small)
    err_d = max_abs_err([dense], [M.match_dense_ref(filters, small)])
    host = u32(packed).cpu().numpy().view(np.uint32)
    hcounts = counts.cpu().numpy()
    for i in range(MESH_ORACLE_TOPICS):
        want = host_rows(router, topics[i])
        if not np.array_equal(M.unpack_indices(host[i]), want) or hcounts[i] != len(want):
            raise AssertionError(f"K10/K11 topic {topics[i]!r}: rows differ from the host oracle")
    if not np.array_equal(dense.cpu().numpy(), np.unpackbits(
            host[:DENSE_B].view(np.uint8), axis=1, bitorder="little").astype(bool)):
        raise AssertionError("K9 differs from K10's bitmap")
    nbytes, ops, n_act = dense_work(filters, B)
    nb_small, ops_small, _ = dense_work(filters, DENSE_B)
    shape = f"N={N} L={L} active={n_act}"
    live_words = int(filters.active.view(-1, 32).any(dim=1).sum())
    recs["match_packed"] = dict(
        **timed(lambda: M.match_packed(filters, denc),
                lambda: M.match_packed_ref(filters, denc), plain_repeats=PLAIN_REPEATS, plain_run=PLAIN_REPEATS),
        bytes=nbytes + B * N // 8, ops=ops, err=err,
        shape=f"B={B} {shape} live_words={live_words} of {N // 32} "
              f"set_bits={int(counts.sum())}; its launches, device us a call: "
              + launch_breakdown(lambda: M.match_packed(filters, denc)))
    at_most, nonzero = counts_atomics(filters.active, packed)
    recs["match_counts"] = dict(
        **timed(lambda: M.match_counts(filters, denc),
                lambda: M.match_counts_ref(filters, denc), plain_repeats=PLAIN_REPEATS, plain_run=PLAIN_REPEATS),
        bytes=nbytes + 4 * B, ops=ops, err=err_c,
        shape=f"B={B} {shape} global_atomics at_most={at_most} nonzero={nonzero}; its "
              f"launches, device us a call: "
              + launch_breakdown(lambda: M.match_counts(filters, denc)))
    recs["match_dense"] = dict(
        **timed(lambda: M.match_dense(filters, small),
                lambda: M.match_dense_ref(filters, small), plain_repeats=PLAIN_REPEATS, plain_run=PLAIN_REPEATS),
        bytes=nb_small + DENSE_B * N, ops=ops_small, err=err_d,
        shape=f"B={DENSE_B} {shape} output_bytes={DENSE_B * N} live_words={live_words}; "
              f"its launches, device us a call: "
              + launch_breakdown(lambda: M.match_dense(filters, small)))
    del filters, packed, dense
    torch.cuda.synchronize()
    log("K9, K10 and K11 edge cases: " + "; ".join(form_edge_checks("single", card))
        + f" [{card}]")
    set_bounds(recs)
    return recs


def clone_tree(x):
    """A deep copy of nested tuples of tensors."""
    if isinstance(x, tuple):
        return type(x)(*(clone_tree(a) for a in x)) if hasattr(x, "_fields") \
            else tuple(clone_tree(a) for a in x)
    return x.clone()


def flat(x):
    """Nested tuples of tensors -> a flat list (int32 views of uint32)."""
    if isinstance(x, tuple):
        return [t for a in x for t in flat(a)]
    return [u32(x)]


# K15's salts (the first is the timed one): -2 makes sub 0's entry -1
# (invalid), 1.5e9 wraps salt * 2 + 1, 2,147,483,646 wraps sub 1's
# entry negative; and its block capacities beside phase 9's: one slot a
# block, and a width that allows no 16-byte row access
PROBE_SALTS = (12345, -2, 1_500_000_000, 2_147_483_646)
PROBE_MH = (1, 7)


def probe_ref(mesh, salt, mh):
    """K15's plain version on a mesh whose one device holds every tile:
    combine_probe_ref's buffers, gathered (a view), then
    combine_pairs_ref. Returns (ca, cb [n_dp, mh], totals [n_dp, 1])."""
    from emqx_tpu_torch.parallel import sharded_match as S

    n_dp, n_sub = mesh.shape["dp"], mesh.shape["sub"]
    a, b, c = S.combine_probe_ref(salt, S._tiles(mesh, 0), mh, mesh.groups[0].device)
    ca, cb, tot = S.combine_pairs_ref(a.reshape(n_dp, -1), b.reshape(n_dp, -1),
                                      c.reshape(n_dp, n_sub), mh)
    return ca, cb, tot.reshape(-1, 1)


def probe_checks(mh):
    """K15 on the card at every PROBE_SALTS salt and at block capacities
    mh and PROBE_MH, on the (2, 4) mesh and the padded (1, 3) layout of
    the one card, each equal to its plain version exactly. Returns the
    totals a case, per layout and capacity."""
    from emqx_tpu_torch.parallel import sharded_match as S

    out = []
    for layout in (MESH, (1, 3)):
        mesh = mesh_of(layout)
        for m in (mh, *PROBE_MH):
            probe = S.make_combine_probe_kernel(mesh, m)
            totals = []
            for salt in PROBE_SALTS:
                got = probe(salt)
                max_abs_err(got, probe_ref(mesh, salt, m))
                totals.append(got[2].reshape(-1).tolist())
            out.append(f"{layout} max_hits={m}: equal, totals by salt {totals}")
    return "; ".join(out)


def check_mesh_kernels(router, skel, exact, rng, card):
    """Phase 9 (d) and the checks of K13, K16 and K17: every mesh kernel
    against its plain version on the card, on the mesh router's own
    state at the slice's shapes (BATCH topics, the table's block
    capacity), then timed."""
    import torch

    from emqx_tpu_torch.ops import match as M
    from emqx_tpu_torch.parallel import mesh as MS
    from emqx_tpu_torch.parallel import sharded_match as S

    dt = router.device_table
    mesh = dt.mesh
    if len(mesh.groups) != 1:
        raise AssertionError(f"expected every shard on one card: {mesh}")
    dt.sync()
    n_dp, n_sub = mesh.shape["dp"], mesh.shape["sub"]
    n_tiles = n_dp * n_sub
    tiles = S._tiles(mesh, 0)
    topics = publish_batch(rng, skel, exact)
    enc = M.encode_topics(router.table.vocab, topics, router.max_levels)
    (t_dev,) = MS.put_topics(enc, mesh)
    B, L = enc.ids.shape
    b_loc = B // n_dp
    mh = dt._block_mh()
    recs = {}

    # K17: the hash leg's tiles
    meta, slots = dt._dev_meta[0], dt._dev_slots[0]
    nb = router.index.n_buckets
    nb_loc = int(slots.probe.shape[0]) // n_sub
    C = int(meta.plen.shape[0])
    h_got = S._tiles_hash(mesh, 0, meta, slots, t_dev, nb, mh)
    h_want = S.hash_tiles_ref(meta, slots, t_dev, tiles, nb_loc, nb, b_loc, mh)
    err = max_abs_err(h_got, h_want)
    from emqx_tpu_torch.ops.hash_index import class_hash_ref

    elig = class_hash_ref(meta, t_dev)[0]
    n_elig = int(elig.sum())
    h_hits = int(h_got[2].clamp(max=mh).sum())
    recs["mesh_match_ids_hash"] = dict(
        **timed(lambda: S._tiles_hash(mesh, 0, meta, slots, t_dev, nb, mh),
                lambda: S.hash_tiles_ref(meta, slots, t_dev, tiles, nb_loc, nb, b_loc, mh),
                plain_repeats=PLAIN_REPEATS, plain_run=PLAIN_REPEATS),
        bytes=C * 11 + B * (4 * L + 5) + n_elig * 2 * 4 + h_hits * 12 + n_tiles * (mh * 8 + 4) + 4,
        ops=B * C * 8 + n_elig * (8 * L + 24) + h_hits * 40, err=err,
        shape=f"tiles={n_tiles} B={B} C={C} buckets={nb} per_shard={nb_loc} max_hits={mh} "
              f"flagged_per_tile={h_got[2].tolist()} amb={int(h_got[3])}; its launches, "
              f"device us a call: " + launch_breakdown(
                  lambda: S._tiles_hash(mesh, 0, meta, slots, t_dev, nb, mh)))

    # K16: the residual leg's tiles
    (f_res,) = dt._filters(residual=True)
    n_loc = int(f_res.words.shape[0]) // n_sub
    d_got = S._tiles_match_ids(mesh, 0, f_res, t_dev, mh)
    err = max_abs_err(d_got, S.match_ids_tiles_ref(f_res, t_dev, tiles, n_loc, b_loc, mh))
    nbytes, ops, n_act = dense_work(f_res, B)
    recs["mesh_match_ids"] = dict(
        **timed(lambda: S._tiles_match_ids(mesh, 0, f_res, t_dev, mh),
                lambda: S.match_ids_tiles_ref(f_res, t_dev, tiles, n_loc, b_loc, mh),
                plain_repeats=PLAIN_REPEATS, plain_run=PLAIN_REPEATS),
        bytes=nbytes + n_tiles * (mh * 8 + 4), ops=ops, err=err,
        shape=f"tiles={n_tiles} B={B} rows_per_shard={n_loc} L={L} residual_rows={n_act} "
              f"max_hits={mh} hits_per_tile={d_got[2].tolist()}")

    # K14 at its edge cases, at this block capacity and at the widest a
    # path launches (warm_up's first escalation step: twice it)
    mh_wide = 2 * mh
    k14_edge_cases(mh, mh_wide, t_dev.ids.device, rng, card)

    # K14 over both legs' tile buffers (the gather is a view on one card)
    for leg, parts in (("hash", h_got[:3]), ("dense", d_got)):
        (_d, _j, a_all), (_, _, b_all), (_, _, c_all) = (
            S._gather_sub(mesh, [p])[0] for p in parts)
        got = S._combine_launch(a_all, b_all, c_all, mh)
        err = max_abs_err(got, S.combine_pairs_ref(a_all, b_all, c_all, mh))
        if leg == "hash":
            # all of a (its sign marks a valid entry), b only where a
            # is valid, the counts; the outputs written whole
            n_valid = int((a_all >= 0).sum())
            recs["combine_pairs"] = dict(
                **timed(lambda: S._combine_launch(a_all, b_all, c_all, mh),
                        lambda: S.combine_pairs_ref(a_all, b_all, c_all, mh),
                        plain_repeats=PLAIN_REPEATS, plain_run=PLAIN_REPEATS),
                bytes=n_tiles * (mh * 4 + 4) + n_valid * 4 + n_dp * (mh * 8 + 4), ops=0,
                err=err,
                shape=f"dp={n_dp} sub={n_sub} max_hits={mh} gathered={n_sub * mh} "
                      f"valid={n_valid} totals={got[2].tolist()} (the dense leg's too: equal)")
        elif err:
            raise AssertionError("K14 differs on the dense leg")
    # K14 on the hash leg's tiles at the widest block capacity
    wide = S._tiles_hash(mesh, 0, meta, slots, t_dev, nb, mh_wide)[:3]
    (_d, _j, a_w), (_, _, b_w), (_, _, c_w) = (S._gather_sub(mesh, [p])[0] for p in wide)
    max_abs_err(S._combine_launch(a_w, b_w, c_w, mh_wide),
                S.combine_pairs_ref(a_w, b_w, c_w, mh_wide))
    w_dev, w_enq = run_ms(lambda: S._combine_launch(a_w, b_w, c_w, mh_wide))
    recs["combine_pairs"]["shape"] += (
        f"; at the widest width served (max_hits={mh_wide}, gathered={n_sub * mh_wide}, "
        f"valid={int((a_w >= 0).sum())}): equal, device_ms={w_dev:.6f} "
        f"enqueue_ms={w_enq:.6f}")

    # the overflow paths: each leg's tiles and their combine at the
    # largest power of two up to half the leg's largest tile count (the
    # per-tile truncation, the exact count past mh; the combine's cut)
    over = {}
    for leg, cnt in (("hash", h_got[2]), ("dense", d_got[2])):
        top = int(cnt.max())
        if top < 2:
            raise AssertionError(f"the {leg} leg has no tile count to overflow: {cnt.tolist()}")
        mh_o = 1 << ((top // 2).bit_length() - 1)
        if leg == "hash":
            got = S._tiles_hash(mesh, 0, meta, slots, t_dev, nb, mh_o)
            max_abs_err(got, S.hash_tiles_ref(meta, slots, t_dev, tiles, nb_loc, nb, b_loc, mh_o))
            got = got[:3]
        else:
            got = S._tiles_match_ids(mesh, 0, f_res, t_dev, mh_o)
            max_abs_err(got, S.match_ids_tiles_ref(f_res, t_dev, tiles, n_loc, b_loc, mh_o))
        (_d, _j, a_all), (_, _, b_all), (_, _, c_all) = (
            S._gather_sub(mesh, [p])[0] for p in got)
        comb = S._combine_launch(a_all, b_all, c_all, mh_o)
        max_abs_err(comb, S.combine_pairs_ref(a_all, b_all, c_all, mh_o))
        k14_ms = run_ms(lambda: S._combine_launch(a_all, b_all, c_all, mh_o))
        over[leg] = dict(max_hits=mh_o, tile_counts=cnt.tolist(), valid_per_block=(
            a_all >= 0).sum(dim=1).tolist(), totals=comb[2].tolist(),
            k14_device_ms=round(k14_ms[0], 6), k14_enqueue_ms=round(k14_ms[1], 6))
    if not any(max(v["valid_per_block"]) > v["max_hits"] for v in over.values()):
        raise AssertionError(f"no combine cut its block at max_hits: {over}")
    log(f"mesh overflow: K17, K16 and K14 equal to their plain versions below the "
        f"tile counts {over} [{card}]")

    # K15: the salted one-entry buffers, combined in one launch; then at
    # its edges
    probe = S.make_combine_probe_kernel(mesh, mh)
    salt = PROBE_SALTS[0]
    err = max_abs_err(probe(salt), probe_ref(mesh, salt, mh))
    recs["combine_probe"] = dict(
        **timed(lambda: probe(salt), lambda: probe_ref(mesh, salt, mh),
                plain_repeats=PLAIN_REPEATS, plain_run=PLAIN_REPEATS),
        # the salted buffers written (a, b, counts), then the combine's
        # bytes on them: all of a, b at its one valid entry per tile,
        # the counts, the outputs
        bytes=n_tiles * (mh * 8 + 4) + n_tiles * (mh * 4 + 8) + n_dp * (mh * 8 + 4),
        ops=0, err=err,
        shape=f"dp={n_dp} sub={n_sub} max_hits={mh} salt={salt}; its launches, device us "
              f"a call: " + launch_breakdown(lambda: probe(salt)))
    log(f"K15 edge cases: {probe_checks(mh)} [{card}]")

    # K13 counts and packed over the full table's tiles
    counts_k, packed_k, _apply = S.make_sharded_kernels(mesh)
    (f_all,) = dt._dev
    n_loc = int(f_all.words.shape[0]) // n_sub
    cnt = counts_k(dt._dev, (t_dev,))
    cnt_ref = torch.zeros(B, dtype=torch.int32, device=cnt.device)
    S.dense_tiles_ref(M.FORM_COUNTS, f_all, t_dev, tiles, n_loc, b_loc, cnt_ref)
    err = max_abs_err([cnt], [cnt_ref])
    pk = packed_k(dt._dev, (t_dev,))
    pk_ref = torch.zeros(pk.shape, dtype=torch.int32, device=pk.device)
    S.dense_tiles_ref(M.FORM_PACKED, f_all, t_dev, tiles, n_loc, b_loc, pk_ref)
    err_p = max_abs_err([u32(pk)], [pk_ref])
    nbytes, ops, n_act = dense_work(f_all, B)

    def counts_ref():
        out = torch.zeros(B, dtype=torch.int32, device=cnt.device)
        S.dense_tiles_ref(M.FORM_COUNTS, f_all, t_dev, tiles, n_loc, b_loc, out)

    def packed_ref():
        out = torch.zeros(pk.shape, dtype=torch.int32, device=pk.device)
        S.dense_tiles_ref(M.FORM_PACKED, f_all, t_dev, tiles, n_loc, b_loc, out)

    shape = f"tiles={n_tiles} B={B} rows_per_shard={n_loc} L={L} active={n_act}"
    at_most, nonzero = counts_atomics(f_all.active, pk)
    recs["mesh_match_counts"] = dict(
        **timed(lambda: counts_k(dt._dev, (t_dev,)), counts_ref, plain_repeats=PLAIN_REPEATS, plain_run=PLAIN_REPEATS),
        bytes=nbytes + 4 * B, ops=ops, err=err,
        shape=f"{shape} global_atomics at_most={at_most} nonzero={nonzero}; its launches, "
              f"device us a call: " + launch_breakdown(lambda: counts_k(dt._dev, (t_dev,))))
    recs["mesh_match_packed"] = dict(
        **timed(lambda: packed_k(dt._dev, (t_dev,)), packed_ref, plain_repeats=PLAIN_REPEATS, plain_run=PLAIN_REPEATS),
        bytes=nbytes + B * n_loc * n_sub // 8, ops=ops, err=err_p,
        shape=f"{shape}; its launches, device us a call: "
              + launch_breakdown(lambda: packed_k(dt._dev, (t_dev,))))
    del pk, pk_ref
    for layout in (MESH, (1, 3)):
        log(f"K13 packed and counts edge cases on {layout}: "
            + "; ".join(form_edge_checks(layout, card)) + f" [{card}]")

    # K13 apply_delta and K18: the fused mesh table sync on phase 9's
    # churn delta and its edges; the router syncs the delta for real later
    recs["mesh_table_sync"] = mesh_table_sync_checks(router, skel, rng, card)
    torch.cuda.synchronize()
    set_bounds(recs)
    return recs


def mesh_table_sync_checks(router, skel, rng, card):
    """The fused K13/K18 mesh table sync (`mesh_table_sync`) against its
    plain version, exactly, and every table (the five filter columns,
    the three slot arrays, the residual mask, in the mesh's layout)
    against the host arrays (`put_filters(t.snapshot())`, the padded
    slots, a mask from `ix.residual_rows`): phase 9's churn delta (one
    churn round, as each of its syncs sees: both sides, with the residual
    bytes), rows only, slots only, and with ids past the tables and
    negative ids, on copies of the stale mesh state; 1 and 1,025 entries
    a side and the full table on copies of the host truth with those
    entries scrambled; the churn delta on the padded (1, 3) layout and on
    a group that holds sub shards 1 and 3 of four (the owner map, which
    only a second card reaches otherwise). Then the three
    reference-shaped wrappers (K13 apply_delta, the K18 slot delta and
    fused sync) on the delta's [nb, K] padded batches. The churn delta is
    timed against nine `index_copy_` calls on the same staged views (ids
    widened to int64 once, outside the timing); its bound counts what
    table_sync's does. The delta stays dirty for the router's next sync.
    Returns the record."""
    import numpy as np
    import torch

    from emqx_tpu_torch.device import to_device
    from emqx_tpu_torch.ops import delta as D
    from emqx_tpu_torch.ops import transfer as T
    from emqx_tpu_torch.ops.hash_index import BUCKET_W, SlotArrays
    from emqx_tpu_torch.ops.table import EncodedFilters, pad_pow2_batches
    from emqx_tpu_torch.parallel import mesh as MS
    from emqx_tpu_torch.parallel import sharded_match as S

    dt = router.device_table
    mesh = dt.mesh
    t, ix = router.table, router.index
    dt.sync()
    churn(router, skel, rng)
    if t.grew or ix.rebuilt:
        raise AssertionError("phase 9's churn grew the table or rebuilt the index")
    rows = np.unique(np.asarray(t.dirty, np.int32))
    sids = np.unique(np.asarray(ix.dirty_slots, np.int32))
    host, hslots = t.snapshot(), ix.slots
    N, L = host.words.shape
    n_slots = len(hslots.fp)
    n_sub = mesh.shape["sub"]
    subs = mesh.groups[0].subs
    dev = mesh.groups[0].device
    mask = np.zeros(N, bool)
    mask[list(ix.residual_rows)] = True
    none = np.zeros(0, np.int32)

    def tables(n, held):
        """The host truth as a group holding sub shards `held` of n
        keeps it (nine tensors)."""
        fp, bkt = MS.pad_slots(np.array(hslots.fp), np.array(hslots.bucket), n)
        out = []
        for a in (*host, fp, bkt, np.array(hslots.probe), mask):
            a = MS.pad_rows(a, n)
            loc = a.shape[0] // n
            out.append(to_device(np.concatenate([a[k * loc:(k + 1) * loc] for k in held]),
                                 dev))
        return out

    truth = tables(n_sub, subs)
    stale = list(dt._dev[0]) + list(dt._dev_slots[0]) + [dt._dev_residual[0]]

    def split(x):
        return EncodedFilters(*x[:5]), SlotArrays(*x[5:8]), x[8]

    def run_case(m, gi, base, r, s, host=host, hslots=hslots):
        """(tables after the kernel, staged): the kernel on group gi of
        mesh m and the plain version, on clones of `base`."""
        staged = to_device(D.pack_table_delta(host, r, hslots, s, ix.residual_rows), dev)
        a = [x.clone() for x in base]
        b = [x.clone() for x in base]
        if m is mesh:
            S.mesh_table_sync(m, *((x,) for x in split(a)), (staged,), len(r), len(s))
        else:
            S.group_table_sync(m, gi, *split(a), staged, len(r), len(s))
        S.mesh_table_sync_ref(m.groups[gi].subs, m.shape["sub"], *split(b), staged,
                              len(r), len(s))
        torch.cuda.synchronize()
        max_abs_err(i32(a), i32(b))
        return a, staged

    def held(tables, want, what):
        max_abs_err(i32(tables), i32(want))
        return what

    def scrambled(base, r, s, full=False):
        """`base` (a layout where each id is its own position) with rows
        r and slots s (and their probe words and mask bytes) changed."""
        x = [y.clone() for y in base]
        ri = torch.from_numpy(r.astype(np.int64)).to(dev)
        si = torch.from_numpy(s.astype(np.int64)).to(dev)
        for k, y in enumerate(i32(x)):
            sel = ri if k in (0, 1, 2, 3, 4, 8) else si // BUCKET_W if k == 7 else si
            if y.dtype == torch.bool:
                y[sel] = ~y[sel]
            elif full:
                y.fill_(-7)
            else:
                y[sel] = -7
        return x

    lines = []
    # phase 9's churn delta: both sides, one side, ids past the tables
    a, staged = run_case(mesh, 0, stale, rows, sids)
    n_r, n_s = len(rows), len(sids)
    n_res = len(ix.residual_rows.intersection(rows.tolist()))
    lines.append(held(a, truth, f"churn delta rows={n_r} (residual {n_res}) slots={n_s}"))
    a, _ = run_case(mesh, 0, stale, rows, none)
    lines.append(held(a, truth[:5] + stale[5:8] + truth[8:], "rows only"))
    a, _ = run_case(mesh, 0, stale, none, sids)
    lines.append(held(a, stale[:5] + truth[5:8] + stale[8:], "slots only"))
    past_host = EncodedFilters(*(np.concatenate([x, x[:16]]) for x in host))
    past_slots = SlotArrays(*(np.concatenate([x, x[:16]]) for x in hslots))
    a, _ = run_case(mesh, 0, stale, np.sort(np.concatenate([rows, np.int32([N, N + 7, -1, -3])])),
                    np.sort(np.concatenate([sids, np.int32([n_slots, n_slots + 5, -1, -2])])),
                    past_host, past_slots)
    lines.append(held(a, truth, "ids past the tables and negative ids dropped"))
    # 1 and 1,025 entries a side, and the full table
    g = np.random.default_rng(9)
    for n in (1, 1025):
        r = np.sort(g.choice(N, n, replace=False)).astype(np.int32)
        s = np.sort(g.choice(n_slots, n, replace=False)).astype(np.int32)
        a, _ = run_case(mesh, 0, scrambled(truth, r, s), r, s)
        lines.append(held(a, truth, f"{n} a side"))
    r_all = np.arange(N, dtype=np.int32)
    s_all = np.arange(n_slots, dtype=np.int32)
    a, full_staged = run_case(mesh, 0, scrambled(truth, r_all, s_all, full=True), r_all, s_all)
    lines.append(held(a, truth, f"full table rows={N} slots={n_slots}"))
    fa = tuple((x,) for x in split(a))
    full_dev, full_enq = run_ms(lambda: S.mesh_table_sync(mesh, *fa, (full_staged,), N, n_slots))
    lines.append(f"full table device_ms={full_dev:.6f} enqueue_ms={full_enq:.6f} bound_ms="
                 f"{1e3 * ((20 + 8 * L) * N + 28 * n_slots) / H100_BYTES_PER_S:.6f}")
    del a, fa, full_staged
    # the churn delta on the padded (1, 3) layout, timed
    m3 = mesh_of((1, 3))
    truth3 = tables(3, (0, 1, 2))
    a, staged3 = run_case(m3, 0, scrambled(truth3, rows, sids), rows, sids)
    lines.append(held(a, truth3, f"(1, 3) padded layout, {truth3[0].shape[0]} rows"))
    f3 = tuple((x,) for x in split(a))
    d3, e3 = run_ms(lambda: S.mesh_table_sync(m3, *f3, (staged3,), n_r, n_s))
    lines.append(f"(1, 3) device_ms={d3:.6f} enqueue_ms={e3:.6f}")
    del a, f3, truth3
    # the owner map: a group holding sub shards 1 and 3 of four (the other
    # two on a stand-in device that is never touched)
    devs = np.empty(4, dtype=object)
    devs[:] = [torch.device("meta"), dev, torch.device("meta"), dev]
    m13 = MS.Mesh(devs.reshape(1, 4))
    gi = [grp.device for grp in m13.groups].index(dev)

    def halves(x):
        loc = x.shape[0] // 4
        return torch.cat([x[loc:2 * loc], x[3 * loc:]])

    a, staged13 = run_case(m13, gi, [halves(x) for x in stale], rows, sids)
    lines.append(held(a, [halves(x) for x in truth],
                      f"a group holding sub shards {m13.groups[gi].subs} of 4"))
    a13 = split(a)
    d13, e13 = run_ms(lambda: S.group_table_sync(m13, gi, *a13, staged13, n_r, n_s))
    lines.append(f"owner map device_ms={d13:.6f} enqueue_ms={e13:.6f}")
    del a, a13
    # the reference-shaped wrappers on the padded [nb, K] batches
    idx = pad_pow2_batches(rows, dt.DELTA_BATCH)
    sidx = pad_pow2_batches(sids, dt.DELTA_BATCH)
    rcols = [(to_device(c, dev),) for c in (idx, host.words[idx], host.prefix_len[idx],
                                           host.has_hash[idx], host.root_wild[idx],
                                           host.active[idx])]
    scols = [(to_device(c, dev),) for c in (sidx, hslots.fp[sidx], hslots.bucket[sidx],
                                           hslots.probe[sidx // BUCKET_W])]
    apply_delta = S.make_sharded_kernels(mesh)[2]
    slot_delta = S.make_slot_delta_kernel(mesh)
    fused = S.make_mesh_sync_kernel(mesh)

    def one(x):
        return [c[0] for c in x]

    for name, fn, ref, k0, k1 in (
            ("apply_delta (K13)", lambda x: apply_delta((EncodedFilters(*x),), *rcols),
             lambda x: S.scatter_owned_rows_ref(EncodedFilters(*x), subs, n_sub, *one(rcols)),
             0, 5),
            ("slot delta (K18)", lambda x: slot_delta(*((y,) for y in x), *scols),
             lambda x: S.scatter_owned_slots_ref(SlotArrays(*x), subs, n_sub, *one(scols)),
             5, 8),
            ("fused sync (K18)",
             lambda x: fused((EncodedFilters(*x[:5]),), *((y,) for y in x[5:]), *rcols,
                             *scols),
             lambda x: (S.scatter_owned_rows_ref(EncodedFilters(*x[:5]), subs, n_sub,
                                                 *one(rcols)),
                        S.scatter_owned_slots_ref(SlotArrays(*x[5:]), subs, n_sub,
                                                  *one(scols))),
             0, 8)):
        a = [x.clone() for x in stale[k0:k1]]
        b = [x.clone() for x in stale[k0:k1]]
        fn(a)
        ref(b)
        max_abs_err(i32(a), i32(b))
        max_abs_err(i32(a), i32(truth[k0:k1]))
        d_ms, e_ms = run_ms(lambda fn=fn, a=a: fn(a))
        lines.append(f"{name} at [{idx.shape[0]}, {idx.shape[1]}] + [{sidx.shape[0]}, "
                     f"{sidx.shape[1]}] equal, device_ms={d_ms:.6f} enqueue_ms={e_ms:.6f}")

    # the churn delta timed: the kernel, its plain version, nine index_copy_
    a = [x.clone() for x in stale]
    b = [x.clone() for x in stale]
    c = [x.clone() for x in stale]
    (rid, words, plen, hh, rw, act, res), (sid, fp, bucket, probe) = \
        D.staged_columns(staged, n_r, L, n_s)
    ri, si = rid.long(), sid.long()
    pi = si // BUCKET_W
    ci = i32(c)

    def library():
        for k, v in enumerate((words, plen, hh, rw, act)):
            ci[k].index_copy_(0, ri, v)
        ci[5].index_copy_(0, si, fp.view(torch.int32))
        ci[6].index_copy_(0, si, bucket)
        ci[7].index_copy_(0, pi, probe.view(torch.int32))
        ci[8].index_copy_(0, ri, res)

    library()
    max_abs_err(i32(c), i32(truth))
    sa = tuple((x,) for x in split(a))
    sb = split(b)
    rec = dict(
        **timed(lambda: S.mesh_table_sync(mesh, *sa, (staged,), n_r, n_s),
                lambda: S.mesh_table_sync_ref(subs, n_sub, *sb, staged, n_r, n_s), library,
                plain_repeats=PLAIN_REPEATS, plain_run=PLAIN_REPEATS),
        bytes=(20 + 8 * L) * n_r + 28 * n_s, ops=0, err=0,
    )
    floor, _ = run_ms(lambda x=torch.tensor(0.5, device=dev): T.add_one(x))
    rec["shape"] = (f"shards={n_sub} rows={n_r} slots={n_s} (distinct, unpadded; {n_res} "
                    f"rows residual) of tables {N} x {L}, {n_slots} slots; one launch's "
                    f"floor (K12, scalar) device_ms={floor:.6f}; library: nine index_copy_ "
                    f"calls; equal: " + "; ".join(lines))
    log(f"mesh table sync: {rec['shape']} [{card}]")
    return rec


K14_CASES = ("scattered", "cut", "last_shard", "counts_above", "all_invalid", "mh1",
             "padded13")


def k14_case(case, mh, dev, rng):
    """One synthetic K14 input on dev: (a_all, b_all, cnt, max_hits) for
    phase 9's (2, 4) layout unless the case says otherwise. Valid
    entries (a >= 0) sit anywhere in a shard's buffer."""
    import numpy as np
    import torch

    n_dp, n_sub = (1, 3) if case == "padded13" else (2, 4)
    mh = 1 if case == "mh1" else mh
    shape = (n_dp, n_sub, mh)
    valid = rng.random(shape) < {"cut": 0.9, "mh1": 0.5, "counts_above": 0.3}.get(case, 0.12)
    if case == "last_shard":
        valid[:, :-1] = False
    elif case == "all_invalid":
        valid[:] = False
    a = np.where(valid, rng.integers(0, 1 << 20, shape), -1).astype(np.int32)
    b = np.where(valid, rng.integers(0, 1 << 20, shape), -1).astype(np.int32)
    cnt = valid.sum(-1).astype(np.int32)
    if case == "counts_above":
        cnt += rng.integers(1, 4, cnt.shape).astype(np.int32)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x.reshape(n_dp, -1))).to(dev)

    return put(a), put(b), put(cnt), mh


def k14_edge_cases(mh, mh_wide, dev, rng, card):
    """K14 on synthetic rows (`k14_case`), each equal to its plain
    version and timed (device_ms, enqueue_ms) at phase 9's block
    capacity and at the widest one served."""
    from emqx_tpu_torch.parallel import sharded_match as S

    lines = []
    for case in K14_CASES:
        times = []
        for width in ((mh,) if case == "mh1" else (mh, mh_wide)):
            a, b, c, m = k14_case(case, width, dev, rng)
            max_abs_err(S._combine_launch(a, b, c, m), S.combine_pairs_ref(a, b, c, m))
            d_ms, e_ms = run_ms(lambda: S._combine_launch(a, b, c, m))
            times.append(f"max_hits={m} valid={int((a >= 0).sum())} device_ms={d_ms:.6f} "
                         f"enqueue_ms={e_ms:.6f}")
        lines.append(f"{case}: " + ", ".join(times))
    log(f"K14 edge cases, each equal to its plain version: {'; '.join(lines)} [{card}]")


def oracle_check(router, topics, tag):
    """Every answer of one begin/finish batch equals the host path's."""
    got = router.match_filters_finish(router.match_filters_begin(topics))
    for t, g in zip(topics, got):
        if sorted(g) != sorted(router.match_filters(t)):
            raise AssertionError(f"{tag}: {t!r} -> {sorted(g)}, host "
                                 f"{sorted(router.match_filters(t))}")


# the growth window's launch kinds: row-only (K13 apply_delta's work) and
# slot-only (the K18 slot delta's), read from sharded_match.SYNC_LAUNCH_KINDS
GROWTH_PATH = ("mesh_table_sync (K13 apply_delta)", "mesh_table_sync (K18 slot delta)")
GROWTH_STEP, GROWTH_STEPS = 50, 40  # routes a growth step adds, steps at most


def small_mesh_checks(card):
    """Phase 9 (c): the padded (1, 3) layout with churn, hashed and
    dense-only (row-only syncs); on the hashed one the growth syncs
    (counters from zero just before them); the dry run's
    Broker(mesh=...) publish of 24 rooms and DispatchEngine.warmup() on
    the (2, 4) mesh; every answer against the host path. Returns (the
    seconds, the growth syncs' launches)."""
    import torch

    from emqx_tpu_torch.broker.message import Message
    from emqx_tpu_torch.broker.packet import SubOpts
    from emqx_tpu_torch.broker.pubsub import Broker
    from emqx_tpu_torch.models.router import Router
    from emqx_tpu_torch.ops import _build
    from emqx_tpu_torch.parallel import sharded_match as S
    from emqx_tpu_torch.parallel.mesh import shard_rows

    t0 = time.perf_counter()
    pairs = [(f"a/{i}/+", f"s{i}") for i in range(300)]
    pairs += [("b/#", "sb"), ("exact/topic/x", "sx"), ("c/+/d", "scd")]
    topics = [f"a/{i}/z" for i in range(0, 300, 7)] + [
        "b/q/w", "exact/topic/x", "c/9/d", "no/match/here"]
    m3 = mesh_of((1, 3))
    for use_hash_index in (True, False):
        r = Router(mesh=m3, use_hash_index=use_hash_index)
        r.add_routes(pairs)
        r.device_table.sync()
        if shard_rows(r.table.capacity, m3) * 3 == r.table.capacity:
            raise AssertionError("the (1, 3) layout does not pad")
        oracle_check(r, topics, f"mesh(1,3) hash={use_hash_index}")
        r.delete_routes([(f"a/{i}/+", f"s{i}") for i in range(7)])
        r.add_routes([(f"p/{i}/+", f"p{i}") for i in range(23)])
        oracle_check(r, topics + [f"p/{i}/q" for i in range(23)],
                     f"mesh(1,3) hash={use_hash_index} churn")
        if not use_hash_index:
            continue
        # growth: routes added GROWTH_STEP at a time until the class
        # index has doubled its buckets alone (slots re-uploaded, rows by
        # the row-only scatter) and the table its rows alone (rows
        # re-uploaded, slots by the slot-only scatter)
        _build.reset_launches()
        kinds = S.SYNC_LAUNCH_KINDS
        kinds.update(dict.fromkeys(kinds, 0))
        sizes = [(r.table.capacity, r.index.n_buckets)]
        with TableSyncs(mesh=True) as syncs:
            for step in range(GROWTH_STEPS):
                r.add_routes([(f"g{step}/{i}/+", f"g{i}") for i in range(GROWTH_STEP)])
                oracle_check(r, [f"g{step}/{i}/z" for i in range(0, GROWTH_STEP, 5)]
                             + topics, f"mesh(1,3) growth {step}")
                if (r.table.capacity, r.index.n_buckets) != sizes[-1]:
                    sizes.append((r.table.capacity, r.index.n_buckets))
                growth = dict(zip(GROWTH_PATH, (kinds["rows"], kinds["slots"])))
                if min(growth.values()) > 0:
                    break
        torch.cuda.synchronize()
        if min(growth.values()) <= 0:
            raise AssertionError(f"the growth syncs skipped a kind: {growth}, "
                                 f"(capacity, buckets) {sizes}")
        n_synced = sum(1 for e in syncs.entries if sum(e))
        n_launched = _build.KERNELS["mesh_table_sync"].launches
        if n_launched != n_synced or sum(kinds.values()) != n_launched:
            raise AssertionError(f"{n_synced} growth syncs with entries launched "
                                 f"mesh_table_sync {n_launched} times, by kind {kinds}")

    b = Broker(max_levels=6, mesh=mesh_of(MESH))
    delivered = {}
    for i in range(24):
        s, _ = b.open_session(f"c{i}", True)
        b.subscribe(s, f"room/{i}/+", SubOpts(qos=0))
        delivered[f"c{i}"] = []
        s.outgoing_sink = delivered[f"c{i}"].extend
    s_all, _ = b.open_session("watch", True)
    b.subscribe(s_all, "room/#", SubOpts(qos=1))
    delivered["watch"] = []
    s_all.outgoing_sink = delivered["watch"].extend
    counts = b.publish_batch([Message(topic=f"room/{i}/t", payload=b"x", qos=1)
                              for i in range(24)])
    if counts != [2] * 24 or len(delivered["watch"]) != 24 or any(
            len(delivered[f"c{i}"]) != 1 for i in range(24)):
        raise AssertionError(f"mesh broker delivered {counts}")
    info = b.enable_dispatch_engine(queue_depth=64).warmup()
    if info.get("mesh_shards") != MESH[1]:
        raise AssertionError(f"engine warm-up on the mesh: {info}")
    require_no_device_fault(b.router.telemetry.counters, "phase 9's Broker(mesh)")

    log(f"mesh small checks: (1,3) padded layout with churn (hash and dense-only), "
        f"growth syncs (capacity, buckets) {sizes} launches {growth}, "
        f"Broker(mesh) 24 rooms {sum(counts)} deliveries, engine warm-up {info} [{card}]")
    return time.perf_counter() - t0, growth


MESH_PATH = ("mesh_match_ids_hash", "mesh_match_ids", "combine_pairs", "mesh_table_sync")


def mesh_phase(rng, card):
    """Phase 9. Returns (kernel records, launches in the main path's run,
    and (broker, skeleton filters, exact topics) for phase 10)."""
    import gc

    import torch

    from emqx_tpu_torch.broker.pubsub import Broker
    from emqx_tpu_torch.ops import _build

    stages = {}
    t_phase = time.perf_counter()
    mesh = mesh_of(MESH)
    # a Broker's Router(mesh=...): phase 10 drives its dispatch engine
    m_broker = Broker(max_levels=16, mesh=mesh)
    router = m_broker.router
    skel, exact, host_s = add_route_set(router, rng)
    stages["set-up"] = time.perf_counter() - t_phase
    log(f"mesh: {mesh} routes={router.stats()} residual_rows="
        f"{len(router.index.residual_rows)} host_build_s={host_s:.3f} [{card}]")

    t0 = time.perf_counter()
    recs = check_dense_forms(router, publish_batch(rng, skel, exact), card)
    gc.collect()
    torch.cuda.empty_cache()
    stages["dense forms"] = time.perf_counter() - t0

    # the main path: sync and warm-up, then counters from zero just
    # before the timed batches
    t0 = time.perf_counter()
    router.device_table.sync()
    warmed = router.warmup_shapes(max_batch=BATCH)
    warm_s = time.perf_counter() - t0
    _build.reset_launches()
    with TableSyncs(mesh=True) as syncs:
        rate, esc, served, busy, moved, gcs = serve(router, skel, exact, rng, N_MESH_BATCHES)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in _build.KERNELS.items()}
    stages["serve"] = time.perf_counter() - t0
    c = router.telemetry.counters
    h = router.telemetry.family_hist.get("mesh_combine_seconds")
    log(f"mesh slice: {served} topics in {N_MESH_BATCHES} batches on a {MESH} mesh, "
        f"{rate:.1f} topics/s (begin+finish wall, syncs included), "
        f"overflow_escalations={esc}, block_max_hits={router.device_table._block_mh()}, "
        f"device batches {c.get('dispatch_batches_total', 0)} against host answers "
        f"(amb fallbacks) {c.get('host_fallback_total', 0)}, "
        f"topics_with_routes_changed_in_flight={moved}, warmup_shapes={warmed} in "
        f"{warm_s:.3f} s, mesh_combine_seconds p50="
        f"{1e3 * h.percentile(50) if h else 0:.4f} ms, {gcs.line()}, "
        f"launches={launches} [{card}]")
    log(f"mesh table syncs: mesh_table_sync launches {launches['mesh_table_sync']} over "
        f"{N_MESH_BATCHES} batches; {syncs.line()} [{card}]")
    legs = {leg: {"n": hh.total, "sum_s": round(hh.sum, 6),
                  "p50_ms": round(hh.percentile(50) * 1e3, 4),
                  "p99_ms": round(hh.percentile(99) * 1e3, 4)}
            for leg, hh in sorted(router.telemetry.hist.items())}
    log(f"mesh slice legs (host clock, telemetry histograms): {json.dumps(legs)}")
    missing = [n for n in MESH_PATH if launches[n] <= 0]
    if missing:
        raise AssertionError(f"mesh kernels never launched on the main path: {missing}")
    if not moved:
        raise AssertionError("no topic saw a route change in flight")

    t0 = time.perf_counter()
    recs.update(check_mesh_kernels(router, skel, exact, rng, card))
    oracle_check(router, publish_batch(rng, skel, exact)[:256], "mesh after the checks")
    # escalation: one batch with the block capacity forced below both
    # legs' block totals, every answer against the host path
    # (every K14 call of that batch held against its plain version)
    from emqx_tpu_torch.parallel import sharded_match as S

    dt = router.device_table
    default_mh = dt.default_mh
    dt.default_mh, dt._mh_floor = ESCALATION_MH, 0
    c = router.telemetry.counters
    before = {k: c.get(k, 0) for k in ("escalations_total", "hash_overflow_retries_total")}
    real_combine, widths = S._combine_launch, []

    def combine_held(a, b, cnt, mh):
        got = real_combine(a, b, cnt, mh)
        max_abs_err(got, S.combine_pairs_ref(a, b, cnt, mh))
        widths.append(mh)
        return got

    S._combine_launch = combine_held
    try:
        oracle_check(router, publish_batch(rng, skel, exact), "mesh escalation")
    finally:
        S._combine_launch = real_combine
        dt.default_mh = default_mh
    esc = {k: c.get(k, 0) - v for k, v in before.items()}
    if min(esc.values()) < 1:
        raise AssertionError(f"a leg did not escalate past max_hits={ESCALATION_MH}: {esc}")
    log(f"mesh escalation: block capacity {ESCALATION_MH} -> floor {dt._mh_floor}, "
        f"dense leg escalations {esc['escalations_total']}, hash leg "
        f"{esc['hash_overflow_retries_total']}, every answer equal to the host path, "
        f"K14 equal to its plain version at max_hits {widths} [{card}]")
    stages["kernel checks"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    stages["small checks"], growth = small_mesh_checks(card)
    log(f"phase 9: {time.perf_counter() - t_phase:.3f} s ("
        + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items()) + f") [{card}]")
    return recs, dict(launches, **growth), (m_broker, skel, exact)


# --- the device failure domain (phase 10) -----------------------------------------


def resync_timer(router, times):
    """Time the breaker's full re-upload inside the next probe: the
    router's device_resync (which re-uploads the fanout mirror) and the
    device table's first sync after it (the full upload of rows, slots
    and the residual mask), each up to a device synchronise, into
    `times` (ms). Returns the (object, name) pairs to delete."""
    import torch

    dt = router.device_table
    real_resync, real_sync = router.device_resync, dt.sync

    def first_sync():
        t0 = time.perf_counter()
        n = real_sync()
        torch.cuda.synchronize()
        times["full_sync_ms"] = 1e3 * (time.perf_counter() - t0)
        del dt.sync
        return n

    def resync():
        t0 = time.perf_counter()
        real_resync()
        torch.cuda.synchronize()
        times["resync_ms"] = 1e3 * (time.perf_counter() - t0)
        dt.sync = first_sync

    router.device_resync = resync
    return [(router, "device_resync"), (dt, "sync")]


def residual_pair(router):
    """Two skeleton filters (dest "s") whose rows are residual: the
    first is swapped for its `swap_of` twin during the outage, the
    second deleted."""
    out = []
    for row in sorted(router.index.residual_rows):
        f = router._row_filter[row]
        if f is not None and router._filter_row.get(f) == row and router.has_route(f, "s"):
            out.append(f)
            if len(out) == 2:
                return out
    raise AssertionError("the broker's table holds fewer than two residual skeleton filters")


def mask_matches_host(router, tag):
    """The device residual mask equals the host index's residual rows."""
    import torch

    mask = router.device_table._dev_residual
    rows = torch.nonzero(mask).flatten().cpu().tolist()
    if rows != sorted(router.index.residual_rows):
        raise AssertionError(f"{tag}: device residual mask holds {len(rows)} rows, "
                             f"host {len(router.index.residual_rows)}")


def failure_domain_phase(b_ctx, m_ctx, rng, seed, card):
    """Phase 10: the device failure domain on phase 7's broker (a-d) and
    on phase 9's mesh broker (e). Returns the launches of the phase,
    counted from 0 at its start."""
    import asyncio

    import torch

    from emqx_tpu_torch.broker.message import Message
    from emqx_tpu_torch.broker.packet import SubOpts
    from emqx_tpu_torch.chaos import LEGS, DeviceFaultInjector
    from emqx_tpu_torch.obs.alarm import Alarms
    from emqx_tpu_torch.obs.kernel_telemetry import KernelTelemetry
    from emqx_tpu_torch.ops import _build

    broker, skel, exact, deliveries = b_ctx
    m_broker, m_skel, m_exact = m_ctx
    router = broker.router
    t_phase = time.perf_counter()
    stages = {}
    # counters from zero for this phase, as phase 7 does
    router.telemetry = router.device_table.telemetry = KernelTelemetry()
    router.device_table.fanout.telemetry = router.telemetry
    c = router.telemetry.counters
    alarms = Alarms(broker)
    eng = broker.enable_dispatch_engine(
        queue_depth=WINDOW, pipeline_depth=2, transfer_chunk_kb=0,
        breaker_threshold=P10_THRESHOLD, probe_backoff_ms=PROBE_PARKED_MS,
        probe_backoff_max_ms=PROBE_PARKED_MS, alarms=alarms)
    inj = DeviceFaultInjector(seed=seed).install(router)
    served, installed = [], []
    wrapped = record_serving(broker, served, installed)
    rec = {}
    _build.reset_launches()

    def launches():
        return {name: k.launches for name, k in _build.KERNELS.items()}

    def msg(topic):
        return Message(topic=topic, payload=bytes(64), from_client="pub")

    def window(w, extra=()):
        """A phase-10 window: WINDOW publishes, the last len(extra) of
        them on the given topics."""
        msgs = broker_window(rng, skel, exact, w, P10_PFAN_PUBS, P10_MFAN_PUBS)
        if extra:
            msgs[-len(extra):] = [msg(t) for t in extra]
        return msgs

    def stale_plans():
        """Every pfan and mfan plan re-resolves at its next use."""
        for f in ["pfan/+/x", "pfan/#"] + [f"mfan/{g}/+" for g in range(N_MFAN_GROUPS)]:
            broker._mark_fanout(f)

    async def serve(b, e, chunks, tag, before=None, dl=deliveries, sv=served, ins=installed):
        """Submit each chunk and land it; then hold every publish of the
        window against the host oracle (check_pair). Returns (publishes,
        traffic seconds)."""
        wall = 0.0
        total = 0
        for i, chunk in enumerate(chunks):
            if before is not None:
                before(i)
            t0 = time.perf_counter()
            total += await e.submit_many(chunk)
            await e.drain()
            for _ in range(4):  # deferred fanout shards run on the loop
                await asyncio.sleep(0)
            wall += time.perf_counter() - t0
        n_pubs = len(sv)
        n = check_pair(b, sv, ins, dl, tag)
        if n != total:
            raise AssertionError(f"{tag}: futures summed {total}, publishes {n}")
        sv.clear()
        ins.clear()
        return n_pubs, wall

    async def single():
        t0 = time.perf_counter()
        rec["warmup"] = eng.warmup()
        stages["warm-up"] = time.perf_counter() - t0
        # (a) one window in five batches, one transient fault at each leg
        t0 = time.perf_counter()
        # a fresh topic a batch: each batch has an uncached topic, so
        # each reaches the device legs
        msgs = window(0, [f"p10fresh/{i}" for i in range(5)])
        fan = [m for m in msgs if m.topic.startswith(("pfan/", "mfan/"))]
        rest = [m for m in msgs if not m.topic.startswith(("pfan/", "mfan/"))]
        order = ("sync", "fanout_begin", "match_begin", "fanout_finish", "match_finish")
        chunks = [fan[i::len(order)] + rest[i::len(order)] for i in range(len(order))]

        def arm(i):
            stale_plans()
            inj.fail_transient(1, legs=(order[i],))

        await serve(broker, eng, chunks, "transient", before=arm)
        want = {(leg, "all"): 1 for leg in LEGS}
        if inj.injected != want:
            raise AssertionError(f"transient faults injected {inj.injected}, want {want}")
        if eng.breaker_state != "closed":
            raise AssertionError(f"one transient a leg tripped the breaker ({eng.status()['breaker']})")
        if not (c.get("breaker_fallback_total", 0) and c.get("fanout_host_fallback_total", 0)):
            raise AssertionError(f"the re-serve counters did not move: {c}")
        log(f"failure domain (a) transient: one window of {len(msgs)} publishes in "
            f"{len(order)} batches, one fault at each leg {sorted(inj.injected)}, every count "
            f"equal to the host oracle; breaker {eng.breaker_state}, breaker_fallback_total "
            f"{c['breaker_fallback_total']}, fanout_host_fallback_total "
            f"{c['fanout_host_fallback_total']}, device failures "
            f"{c.get('breaker_device_failures_total', 0)} [{card}]")
        broker_churn(broker, skel, rng, P10_CHURN_K, deliveries)
        stages["(a) transient"] = time.perf_counter() - t0

        # (b) sticky loss: trip, then degraded windows with churn
        t0 = time.perf_counter()
        inj.fail_sticky()
        trip = 0
        for w in range(1, P10_THRESHOLD + 1):
            await serve(broker, eng, [window(w)], f"sticky {w}")
            if eng.breaker_state == "open":
                trip = w
                break
        if not trip or not router.device_suspended:
            raise AssertionError(f"sticky loss did not trip within {P10_THRESHOLD} windows")
        if not alarms.is_active("xla_device_breaker"):
            raise AssertionError("the breaker tripped without its alarm")
        # the mid-outage mutations: a new filter with a subscriber, a
        # residual filter swapped for its twin (with a subscriber), and
        # another residual filter deleted
        res_a, res_b = residual_pair(router)
        twin = swap_of(res_a)
        row_a = router._filter_row[res_a]
        for cid, flt in (("p10new", "p10new/+/x"), ("p10res", twin)):
            s, _ = broker.open_session(cid, True)
            s.outgoing_sink = deliveries.sink_for(cid)
            broker.subscribe(s, flt, SubOpts(qos=1))
        router.delete_route(res_a, "s")
        router.add_route(twin, "s")
        router.delete_route(res_b, "s")
        if router._filter_row[twin] not in router.index.residual_rows:
            raise AssertionError(f"{twin} is not a residual filter")

        def extras(k):
            return (f"p10new/{k}/x", instantiate(twin, rng), instantiate(res_a, rng),
                    instantiate(res_b, rng))

        before = launches()
        pubs = wall = 0
        for k in range(P10_WINDOWS):
            n, t = await serve(broker, eng, [window(10 + k, extras(k))], f"degraded {k}")
            pubs += n
            wall += t
            broker_churn(broker, skel, rng, P10_CHURN_K + 1 + k, deliveries)
        moved = {n: v - before[n] for n, v in launches().items() if v != before[n]}
        if moved:
            raise AssertionError(f"kernels launched while the breaker was open: {moved}")
        rec["degraded"] = (pubs, wall)
        # a probe fails while the card is lost; the breaker stays open
        if eng.probe_once() or eng.breaker_state != "open":
            raise AssertionError("a probe closed the breaker on a lost card")
        log(f"failure domain (b) sticky loss: tripped after {trip} windows "
            f"(threshold {P10_THRESHOLD}), alarm xla_device_breaker active; "
            f"{P10_WINDOWS} degraded windows with churn, the residual filter at row "
            f"{row_a} swapped for its twin (now row {router._filter_row[twin]}) and another "
            f"deleted, a new filter subscribed: {pubs} publishes in {wall:.3f} s, every "
            f"count and match equal to the host oracle; no kernel launched while open "
            f"({', '.join(SINGLE_PATH)}); a probe on the lost card failed; "
            f"breaker_degraded_batches_total {c.get('breaker_degraded_batches_total', 0)} [{card}]")
        stages["(b) sticky"] = time.perf_counter() - t0

        # (c) heal and recover: full re-upload, verified canary, close
        t0 = time.perf_counter()
        times = {}
        timers = resync_timer(router, times)
        try:
            t_heal = time.perf_counter()
            inj.heal()
            closed = eng.probe_once()
            heal_s = time.perf_counter() - t_heal
        finally:
            for obj, name in timers:
                if name in vars(obj):
                    delattr(obj, name)
        if not closed or eng.breaker_state != "closed" or router.device_suspended:
            raise AssertionError(f"the breaker did not close after heal(): {eng.status()['breaker']}")
        if alarms.is_active("xla_device_breaker"):
            raise AssertionError("the breaker closed with its alarm still active")
        mask_matches_host(router, "after the resync")
        rec["recovery"] = (heal_s, times)
        before = launches()
        plans0 = c.get("fanout_device_plans_total", 0)
        pubs = wall = 0
        for k in range(P10_WINDOWS):
            n, t = await serve(broker, eng, [window(20 + k, extras(100 + k))], f"recovered {k}")
            pubs += n
            wall += t
            broker_churn(broker, skel, rng, P10_CHURN_K + 20 + k, deliveries)
            if eng.breaker_state != "closed":
                raise AssertionError(f"the breaker left closed in window {k}: {eng.status()['breaker']}")
        after = launches()
        still = [n for n in SINGLE_PATH if after[n] == before[n]]
        if still or c.get("fanout_device_plans_total", 0) == plans0:
            raise AssertionError(f"the card did not serve again after the close: {still}")
        rec["device"] = (pubs, wall)
        log(f"failure domain (c) recovery: heal() to closed {heal_s:.3f} s through "
            f"probe_once (canary, device_resync {times['resync_ms']:.3f} ms + first full "
            f"sync {times['full_sync_ms']:.3f} ms, verified canary); device residual mask "
            f"equal to the host's; {P10_WINDOWS} windows on the card with churn: {pubs} "
            f"publishes in {wall:.3f} s, every count and match equal to the host oracle, the "
            f"mid-outage mutations included; launches over them "
            f"{ {n: after[n] - before[n] for n in SINGLE_PATH} } [{card}]")
        stages["(c) recovery"] = time.perf_counter() - t0

        # (d) a stall past breaker_deadline_ms: counted, results served
        t0 = time.perf_counter()
        late0 = c.get("breaker_deadline_exceeded_total", 0)
        stall_s = 5 * eng.breaker_deadline_s
        inj.stall(stall_s, n=1, legs=("match_finish",))
        await serve(broker, eng, [window(40)], "stall")
        inj.heal()
        late = c.get("breaker_deadline_exceeded_total", 0) - late0
        if inj.stalls_injected != 1 or late != 1 or eng.breaker_state != "closed":
            raise AssertionError(f"stall: injected {inj.stalls_injected}, deadline expiries "
                                 f"{late}, breaker {eng.breaker_state}")
        log(f"failure domain (d) stall: one match fetch held {1e3 * stall_s:.1f} ms past "
            f"breaker_deadline_ms {1e3 * eng.breaker_deadline_s:.1f}: "
            f"breaker_deadline_exceeded_total +{late}, its window served and equal to the "
            f"host oracle, breaker {eng.breaker_state} [{card}]")
        stages["(d) stall"] = time.perf_counter() - t0
        await eng.stop()

    # (e) the mesh: phase 9's Router(mesh=(2, 4)) behind its broker
    m_router = m_broker.router
    m_alarms = Alarms(m_broker)
    m_eng = m_broker.enable_dispatch_engine(
        queue_depth=BATCH, pipeline_depth=2, breaker_threshold=P10_THRESHOLD,
        probe_backoff_ms=PROBE_PARKED_MS, probe_backoff_max_ms=PROBE_PARKED_MS,
        alarms=m_alarms)
    m_inj = DeviceFaultInjector(seed=seed).install(m_router)
    m_served, m_installed = [], []
    m_deliveries = Deliveries()
    m_wrapped = record_serving(m_broker, m_served, m_installed)

    async def mesh():
        t0 = time.perf_counter()

        async def m_window(tag):
            topics = publish_batch(rng, m_skel, m_exact)
            await serve(m_broker, m_eng, [[msg(t) for t in topics]], tag,
                        dl=m_deliveries, sv=m_served, ins=m_installed)
            churn(m_router, m_skel, rng)

        await m_window("mesh healthy")
        m_inj.fail_sticky()
        trip = 0
        for w in range(1, P10_THRESHOLD + 1):
            await m_window(f"mesh sticky {w}")
            if m_eng.breaker_state == "open":
                trip = w
                break
        if not trip or not m_alarms.is_active("xla_device_breaker"):
            raise AssertionError(f"mesh: sticky loss did not trip within {P10_THRESHOLD} windows")
        before = launches()
        for k in range(P10_MESH_WINDOWS):
            await m_window(f"mesh degraded {k}")
        moved = {n: v - before[n] for n, v in launches().items() if v != before[n]}
        if moved:
            raise AssertionError(f"mesh: kernels launched while the breaker was open: {moved}")
        times = {}
        timers = resync_timer(m_router, times)
        try:
            t_heal = time.perf_counter()
            m_inj.heal()
            closed = m_eng.probe_once()
            heal_s = time.perf_counter() - t_heal
        finally:
            for obj, name in timers:
                if name in vars(obj):
                    delattr(obj, name)
        if not closed or m_eng.breaker_state != "closed" or m_alarms.is_active("xla_device_breaker"):
            raise AssertionError(f"mesh: the breaker did not close: {m_eng.status()['breaker']}")
        canary = publish_batch(rng, m_skel, m_exact)[:256]
        got = m_router.canary_match(canary)
        for t, g in zip(canary, got):
            if sorted(g) != sorted(m_router.match_filters(t)):
                raise AssertionError(f"mesh canary: {t!r} -> {sorted(g)}")
        before = launches()
        for k in range(P10_MESH_WINDOWS):
            await m_window(f"mesh recovered {k}")
        after = launches()
        still = [n for n in MESH_PATH if after[n] == before[n]]
        if still or m_eng.breaker_state != "closed":
            raise AssertionError(f"mesh: the card did not serve again after the close: {still}")
        rec["mesh"] = (heal_s, times)
        log(f"failure domain (e) mesh {MESH}: tripped after {trip} windows, "
            f"{P10_MESH_WINDOWS} degraded windows launched no kernel; heal() to closed "
            f"{heal_s:.3f} s (device_resync {times['resync_ms']:.3f} ms + first full sync "
            f"{times['full_sync_ms']:.3f} ms); canary of {len(canary)} topics equal to the "
            f"host; {P10_MESH_WINDOWS} windows on the card after, every match equal to the "
            f"host oracle; launches over them {({n: after[n] - before[n] for n in MESH_PATH})} "
            f"[{card}]")
        stages["(e) mesh"] = time.perf_counter() - t0
        await m_eng.stop()

    try:
        asyncio.run(single())
        asyncio.run(mesh())
    finally:
        for obj, name in wrapped + m_wrapped:
            if name in vars(obj):
                delattr(obj, name)
        inj.uninstall()
        m_inj.uninstall()
    torch.cuda.synchronize()
    phase = launches()
    missing = [n for n in SINGLE_PATH + MESH_PATH if phase[n] <= 0]
    if missing:
        raise AssertionError(f"phase 10 never launched {missing}")
    (d_pubs, d_wall), (c_pubs, c_wall) = rec["degraded"], rec["device"]
    log(f"failure domain rates (information, no claim): degraded {d_pubs / d_wall:.1f} "
        f"publishes/s against {c_pubs / c_wall:.1f} on the card over {P10_WINDOWS} windows "
        f"each of the same mix, the reduced fan mix of {P10_PFAN_PUBS} pfan and "
        f"{P10_MFAN_PUBS} mfan publishes a window (phase 7's: {N_PFAN_PUBS} and "
        f"{N_MFAN_PUBS}); single-device heal() to closed {rec['recovery'][0]:.3f} s, "
        f"device_resync + first full sync "
        f"{rec['recovery'][1]['resync_ms'] + rec['recovery'][1]['full_sync_ms']:.3f} ms; "
        f"mesh {rec['mesh'][0]:.3f} s, "
        f"{rec['mesh'][1]['resync_ms'] + rec['mesh'][1]['full_sync_ms']:.3f} ms [{card}]")
    log(f"phase 10: {time.perf_counter() - t_phase:.3f} s ("
        + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
        + f"), launches {phase} [{card}]")
    return phase


# --- the publish path's observability (phase 11) --------------------------------------


def p11_classed_filter(router):
    """A wildcard filter of the route set that the pattern-class index
    holds in a cuckoo slot (the hash leg serves it), not a residual row."""
    ix = router.index
    for f, row in router._filter_row.items():
        if ("+" in f and not f.startswith("$") and row < len(ix._row_bucket)
                and ix._row_bucket[row] >= 0 and row not in ix.residual_rows):
            return f
    raise AssertionError("no classed wildcard filter in the route set")


def p11_topic(flt: str, tag: str) -> str:
    """A topic no earlier phase published that `flt` matches."""
    return "/".join(tag if w == "+" else f"{tag}/z" if w == "#" else w
                    for w in flt.split("/"))


def p11_want(broker, topic) -> int:
    """The host oracle's delivery count for one publish."""
    _key, (plan, groups) = oracle_of(broker, topic, {})
    return len(plan[0]) + len(plan[1]) + groups


def p11_bundle(obs, reason):
    """The newest persisted flight bundle of `reason`, or None."""
    store = obs.flight.store
    names = [s["name"] for s in store.list() if s["name"].endswith(f"-{reason}.json")]
    return store.read(names[-1]) if names else None


async def p11_publish(broker, eng, topics):
    """Serve `topics` through the engine, land them and drain the
    sentinel's deferred audits; returns the delivery counts."""
    import asyncio

    from emqx_tpu_torch.broker.message import Message

    out = []
    for t in topics:
        out.append(await eng.submit_many(
            [Message(topic=t, payload=bytes(64), from_client="pub")]))
        await eng.drain()
        await asyncio.sleep(0)
    broker.sentinel.run_audits()
    return out


async def p11_row_chain(broker, eng, obs, tag, sync_kernel):
    """Phase 11 (b) and (d): corrupt one classed filter's device slot,
    detect, quarantine, alarm, bundle, heal through one batched match,
    serve in full. Returns the step's record."""
    from collections import Counter

    from emqx_tpu_torch.broker.packet import SubOpts
    from emqx_tpu_torch.ops import _build

    router = broker.router
    dt = router.device_table
    c = router.telemetry.counters
    flt = p11_classed_filter(router)
    seen = Counter()
    for i in range(P11_CHAIN_SUBS):
        s, _ = broker.open_session(f"p11{tag}{i}", True)
        s.outgoing_sink = lambda pkts, cid=f"p11{tag}{i}": seen.update([cid] * len(pkts))
        broker.subscribe(s, flt, SubOpts(qos=0))
    topics = [p11_topic(flt, f"p11{tag}{k}") for k in range(4)]
    for t in topics:
        if flt not in router.match_filters(t):
            raise AssertionError(f"{tag}: {t} does not match {flt}")
    (n0,) = await p11_publish(broker, eng, topics[:1])
    if n0 != p11_want(broker, topics[0]) or n0 < P11_CHAIN_SUBS:
        raise AssertionError(f"{tag}: before the corruption {n0} deliveries, "
                             f"host oracle {p11_want(broker, topics[0])}")
    div0 = c.get("audit_divergence_total", 0)
    unq0 = c.get("audit_unquarantine_total", 0)
    arrays = (dt._dev_meta, dt._dev_slots, dt._dev_residual)
    k = router.chaos_corrupt_rows([flt])
    if k != 1:
        raise AssertionError(f"{tag}: chaos_corrupt_rows corrupted {k} slots")
    (n1,) = await p11_publish(broker, eng, topics[1:2])
    want1 = p11_want(broker, topics[1])
    bundle = p11_bundle(obs, "audit_divergence")
    if (c.get("audit_divergence_total", 0) != div0 + 1
            or router.quarantined_filters() != [flt]
            or not obs.alarms.is_active("xla_audit_divergence")
            or bundle is None or bundle["details"].get("kind") != "match"
            or flt not in bundle["details"].get("filters", ())
            or n1 >= want1):
        raise AssertionError(
            f"{tag}: the chain did not complete in one sampling window: served "
            f"{n1} of {want1}, divergences +{c.get('audit_divergence_total', 0) - div0}, "
            f"quarantined {router.quarantined_filters()}, bundle "
            f"{None if bundle is None else bundle['details']}")
    before = {n: kk.launches for n, kk in _build.KERNELS.items()}
    t0 = time.perf_counter()
    out = router.match_filters_finish(router.match_filters_begin(topics[2:3]))
    heal_ms = 1e3 * (time.perf_counter() - t0)
    synced = _build.KERNELS[sync_kernel].launches - before[sync_kernel]
    reuploaded = all(a is not b for a, b in zip(arrays, (dt._dev_meta, dt._dev_slots,
                                                          dt._dev_residual)))
    if (flt not in out[0] or router.quarantined_filters()
            or c.get("audit_unquarantine_total", 0) != unq0 + 1 or synced < 1
            or not reuploaded):
        raise AssertionError(
            f"{tag}: the clean sync did not heal: {flt} in answer {flt in out[0]}, "
            f"quarantined {router.quarantined_filters()}, {sync_kernel} launches "
            f"{synced}, index re-uploaded {reuploaded}")
    (n3,) = await p11_publish(broker, eng, topics[3:])
    if n3 != p11_want(broker, topics[3]):
        raise AssertionError(f"{tag}: after the heal {n3} deliveries, host oracle "
                             f"{p11_want(broker, topics[3])}")
    for cid in [f"p11{tag}{i}" for i in range(P11_CHAIN_SUBS)]:
        broker.close_session(broker.sessions[cid])
    return {"filter": flt, "served_short": (n1, want1), "heal_ms": heal_ms,
            "sync_launches": synced, "after": n3,
            "bundle": bundle["details"]["filters"]}


def observability_phase(b_ctx, m_ctx, rng, seed, card):
    """Phase 11: the publish path's observability on phase 7's broker
    (a-c, e-g) and phase 9's mesh broker (d). Returns the launches of the
    phase, counted from 0 at its start."""
    import asyncio
    import collections
    import shutil
    import tempfile

    import numpy as np
    import torch

    from emqx_tpu_torch.broker.message import Message
    from emqx_tpu_torch.chaos import DeviceFaultInjector
    from emqx_tpu_torch.obs import DELIVERY_STAGES, Observability
    from emqx_tpu_torch.obs.kernel_telemetry import KernelTelemetry
    from emqx_tpu_torch.obs.otel import MemoryTracer
    from emqx_tpu_torch.obs.sentinel import DECOMP_TOLERANCE, STAGES
    from emqx_tpu_torch.ops import _build

    broker, skel, exact, deliveries = b_ctx
    m_broker = m_ctx[0]
    router = broker.router
    t_phase = time.perf_counter()
    stages = {}
    tmp = tempfile.mkdtemp(prefix="emqx_tpu_torch_p11_")

    def fresh_telemetry(r):
        # counters from zero, as phases 7 and 10 do, before an
        # Observability binds the collector
        r.telemetry = r.device_table.telemetry = KernelTelemetry()
        r.device_table.fanout.telemetry = r.telemetry
        return r.telemetry.counters

    def attach(b, name, sample_n):
        obs = Observability(b, node_name=f"{name}@card",
                            trace_dir=f"{tmp}/{name}/trace",
                            flight_dir=f"{tmp}/{name}/flight")
        obs.sentinel.sample_n = sample_n
        return obs

    def engine(b):
        return b.enable_dispatch_engine(
            queue_depth=WINDOW, pipeline_depth=2, transfer_chunk_kb=0,
            breaker_threshold=P10_THRESHOLD, probe_backoff_ms=PROBE_PARKED_MS,
            probe_backoff_max_ms=PROBE_PARKED_MS)

    def launches():
        return {name: k.launches for name, k in _build.KERNELS.items()}

    _build.reset_launches()
    obs = m_obs = None
    try:
        # (a) clean audit at full width
        t0 = time.perf_counter()
        c = fresh_telemetry(router)
        obs = attach(broker, "p11a", P11_SAMPLE_N)
        st = obs.sentinel
        # the pending-audit deque drops past its bound (64 captures, the
        # reference's default) without a count; a window's collect
        # captures ~WINDOW / P11_SAMPLE_N at once, so the bound is
        # raised for this step and every captured span is audited
        st._pending = collections.deque(maxlen=8 * WINDOW)
        engine(broker).warmup()
        rec = serve_broker(broker, skel, exact, rng, deliveries, n_windows=P11_WINDOWS,
                           profiled=False, k_base=P11_CHURN_K)

        async def sampled_fans():
            eng = engine(broker)
            out = []
            for t in ("pfan/7/x", "mfan/5/p11a"):
                st._tick = st.sample_n - 1  # the next publish is sampled
                spans0 = st.spans_total
                out += await p11_publish(broker, eng, [t])
                if st.spans_total != spans0 + 1:
                    raise AssertionError(f"(a): {t} was not sampled")
            await eng.stop()
            return out

        fans = asyncio.run(sampled_fans())
        want = [p11_want(broker, t) for t in ("pfan/7/x", "mfan/5/p11a")]
        if fans != want:
            raise AssertionError(f"(a): sampled fan publishes delivered {fans}, host {want}")
        deliveries.seen.clear()
        audits = c.get("audit_total", 0)
        skipped = c.get("audit_skipped_stale_total", 0)
        clean = c.get("audit_clean_total", 0)
        missing = ([s for s in STAGES if s not in st.stage_hist]
                   + [s for s in DELIVERY_STAGES if s not in st.delivery_hist])
        if (c.get("audit_divergence_total", 0) or clean != audits
                or audits + skipped != st.spans_total or audits < 256 or missing):
            raise AssertionError(
                f"(a): audits {audits} clean {clean} skipped {skipped} divergences "
                f"{c.get('audit_divergence_total', 0)} spans {st.spans_total}; "
                f"stages without a histogram {missing}")
        require_no_device_fault(c, "phase 11 (a)")
        decomp = st.decomposition_snapshot()
        checked = decomp["in_band"] + decomp["out_of_band"]
        hist = {**{s: st.stage_hist[s] for s in STAGES},
                **{f"sub.{s}": st.delivery_hist[s] for s in DELIVERY_STAGES}}
        pcts = {k: (round(h.percentile(50) * 1e3, 4), round(h.percentile(99) * 1e3, 4),
                    h.total) for k, h in hist.items()}
        log(f"observability (a) clean audit: {rec['publishes']} publishes in "
            f"{P11_WINDOWS} windows of {WINDOW} with churn at sample_n {P11_SAMPLE_N}, "
            f"every count and match equal to the host oracle, plus pfan/7/x ({fans[0]} "
            f"deliveries) and mfan/5/p11a ({fans[1]}) at a sampled tick: "
            f"{st.spans_total} sampled spans, audit_total {audits}, clean {clean}, "
            f"skipped_stale {skipped}, divergences 0; stage ms (p50, p99, n) "
            f"{json.dumps(pcts)}; sum-to-wall check: {decomp['out_of_band']} of "
            f"{checked} spans out of band (tolerance {DECOMP_TOLERANCE}, share "
            f"{decomp['out_of_band'] / max(1, checked):.4f}), warm-up spans excluded "
            f"{st.warmup_skipped}; SLO {json.dumps(st.summary()['slo'])} [{card}]")
        obs.stop()
        obs = None
        stages["(a) audit"] = time.perf_counter() - t0

        # publishes/s with and without Observability, interleaved turns
        t0 = time.perf_counter()
        turns = []
        for i, mode in enumerate(P11_TURNS):
            t_obs = attach(broker, f"p11t{i}", 1024) if mode == "on" else None
            engine(broker)
            try:
                r = serve_broker(broker, skel, exact, np.random.default_rng(seed + 110),
                                 deliveries, n_windows=2, profiled=False,
                                 k_base=P11_CHURN_K + 10 + i)
                seen = "" if t_obs is None else (
                    f"; flight triggers {t_obs.flight.triggers_total}, profiler "
                    f"samples {t_obs.profiler.samples_total}, slow subscriptions "
                    f"tracked {len(t_obs.slow_subs._tab)}")
            finally:
                if t_obs is not None:
                    t_obs.stop()
            turns.append((mode, r["publishes"] / r["traffic_s"],
                          r["deliveries"] / r["traffic_s"], r["traffic_s"],
                          r["stages"]["walk"], seen))
        require_no_device_fault(c, "phase 11 turns")
        log("observability rates (a record, no limit, no claim): " + "; ".join(
            f"turn {i} Observability {m}: {p:.1f} publishes/s, {d:.1f} deliveries/s "
            f"({w:.3f} s traffic, delivery walk {walk:.3f} s{seen})"
            for i, (m, p, d, w, walk, seen) in enumerate(turns))
            + f"; one window pair of phase 7's mix a turn, sample_n 1024 [{card}]")
        stages["turns"] = time.perf_counter() - t0

        # (b), (c), (e), (f), (g) at sample_n 1 on a fresh collector
        c = fresh_telemetry(router)
        obs = attach(broker, "p11b", 1)
        eng = engine(broker)
        rec = {}

        async def steps():
            t0 = time.perf_counter()
            rec["b"] = await p11_row_chain(broker, eng, obs, "b", "table_sync")
            log(f"observability (b) device-row chain: {rec['b']['filter']} corrupted in "
                f"its cuckoo slot, a fresh publish served {rec['b']['served_short'][0]} "
                f"of {rec['b']['served_short'][1]}; in one sampling window (sample_n 1): "
                f"audit_divergence_total 1, quarantined, xla_audit_divergence active, "
                f"audit_divergence bundle (kind match, filters {rec['b']['bundle']}); "
                f"one batched match healed it in {rec['b']['heal_ms']:.3f} ms "
                f"(table_sync launches {rec['b']['sync_launches']}, meta, slots and "
                f"residual mask re-uploaded, audit_unquarantine_total 1); the next "
                f"publish delivered {rec['b']['after']}, the host oracle's count [{card}]")
            stages["(b) row chain"] = time.perf_counter() - t0

            # (c) the plan chain on a 2,048-session plan
            t0 = time.perf_counter()
            topics = [f"mfan/3/p11c{k}" for k in range(4)]
            (n0,) = await p11_publish(broker, eng, topics[:1])
            key = tuple(f for f, _ in router.match_pairs(topics[0]))
            entry = broker._fanout_cache[key]
            mem, other = entry[1]
            broker._fanout_cache[key] = (entry[0], (mem[:-1], other))
            div0 = c.get("audit_divergence_total", 0)
            # the injected divergence logs the whole served and oracle
            # plans (2,048 entries each): kept off this run's stderr
            s_log = logging.getLogger("emqx_tpu_torch.obs.sentinel")
            level = s_log.level
            s_log.setLevel(logging.CRITICAL)
            try:
                (n1,) = await p11_publish(broker, eng, topics[1:2])
            finally:
                s_log.setLevel(level)
            if (n1 != n0 - 1 or c.get("audit_divergence_total", 0) != div0 + 1
                    or broker.sentinel.divergences[-1]["kind"] != "fanout"
                    or router.quarantined_filters() != sorted(key)):
                raise AssertionError(f"(c): served {n1} after {n0}, divergences "
                                     f"{c.get('audit_divergence_total', 0) - div0}, "
                                     f"quarantined {router.quarantined_filters()}")
            ref0 = c.get("audit_quarantine_resolve_refusals_total", 0)
            n2 = broker.publish(Message(topic=topics[2], payload=bytes(64)))
            broker.sentinel.run_audits()
            refused = c.get("audit_quarantine_resolve_refusals_total", 0) - ref0
            want2 = p11_want(broker, topics[2])
            if refused < 1 or n2 != want2:
                raise AssertionError(f"(c): while quarantined refusals +{refused}, "
                                     f"served {n2} of {want2}")
            t_h = time.perf_counter()
            out = router.match_filters_finish(router.match_filters_begin([topics[3]]))
            heal_ms = 1e3 * (time.perf_counter() - t_h)
            if router.quarantined_filters() or sorted(out[0]) != sorted(key):
                raise AssertionError(f"(c): the clean sync did not heal: {out}")
            (n3,) = await p11_publish(broker, eng, ["mfan/3/p11c4"])
            if n3 != p11_want(broker, "mfan/3/p11c4") or n3 != n0:
                raise AssertionError(f"(c): after the heal {n3} deliveries, before {n0}")
            log(f"observability (c) plan chain: one client dropped from the cached "
                f"{key} plan ({n0} deliveries) served {n1}; a fanout divergence "
                f"(its bundle within (b)'s trigger cooldown: flight triggers "
                f"{obs.flight.triggers_total}), quarantined {sorted(key)}; a synchronous publish while quarantined: "
                f"audit_quarantine_resolve_refusals_total +{refused}, {n2} deliveries "
                f"(the host oracle's); one batched match healed it in {heal_ms:.3f} ms; "
                f"the next publish delivered {n3} [{card}]")
            stages["(c) plan chain"] = time.perf_counter() - t0
            require_no_device_fault(c, "phase 11 (b) and (c)")

            # (e) the breaker's flight hooks
            t0 = time.perf_counter()
            inj = DeviceFaultInjector(seed=seed).install(router)
            try:
                inj.fail_sticky()
                trip = 0
                for w in range(1, P10_THRESHOLD + 2):
                    await p11_publish(broker, eng, [f"p11e/{w}/{j}" for j in range(4)])
                    if eng.breaker_state == "open":
                        trip = w
                        break
                bundle = p11_bundle(obs, "device_breaker_trip")
                kinds = [e["kind"] for e in obs.flight.recorder.recent()]
                if not trip or bundle is None or "breaker.trip" not in kinds:
                    raise AssertionError(f"(e): trip {trip}, bundle {bundle is not None}, "
                                         f"breaker.trip in the ring {'breaker.trip' in kinds}")
                inj.heal()
                closed = eng.probe_once()
                kinds = [e["kind"] for e in obs.flight.recorder.recent()]
                if not closed or "breaker.close" not in kinds:
                    raise AssertionError(f"(e): closed {closed}, breaker.close in the ring "
                                         f"{'breaker.close' in kinds}")
            finally:
                inj.uninstall()
            rec["faults"] = {k: c.get(k, 0) for k in FAULT_COUNTERS}
            log(f"observability (e) breaker hooks: sticky loss tripped after {trip} "
                f"batches; device_breaker_trip bundle (details "
                f"{sorted(bundle['details'])}), breaker.trip and breaker.close in the "
                f"ring after heal() and probe_once(); fault counters {rec['faults']} "
                f"[{card}]")
            stages["(e) breaker"] = time.perf_counter() - t0
            await eng.stop()

        asyncio.run(steps())

        # (d) the device-row chain on phase 9's mesh broker
        t0 = time.perf_counter()
        m_c = fresh_telemetry(m_broker.router)
        m_obs = attach(m_broker, "p11d", 1)
        m_eng = engine(m_broker)
        before = launches()

        async def mesh_chain():
            out = await p11_row_chain(m_broker, m_eng, m_obs, "d", "mesh_table_sync")
            await m_eng.stop()
            return out

        rec["d"] = asyncio.run(mesh_chain())
        torch.cuda.synchronize()
        moved = {n: v - before[n] for n, v in launches().items() if v != before[n]}
        need = ("mesh_table_sync", "mesh_match_ids_hash", "combine_pairs")
        if [n for n in need if not moved.get(n)]:
            raise AssertionError(f"(d): mesh kernels not launched: {moved}")
        require_no_device_fault(m_c, "phase 11 (d)")
        log(f"observability (d) mesh {MESH} device-row chain (phase 9's mesh broker, "
            f"{N_ROUTES:,} routes, no depth cut): {rec['d']['filter']} served "
            f"{rec['d']['served_short'][0]} of {rec['d']['served_short'][1]}, "
            f"divergence, quarantine, alarm and bundle (filters {rec['d']['bundle']}) in "
            f"one sampling window; one batched match healed it in "
            f"{rec['d']['heal_ms']:.3f} ms (mesh_table_sync launches "
            f"{rec['d']['sync_launches']}, index re-uploaded per group); the next publish "
            f"delivered {rec['d']['after']}; launches {moved} [{card}]")
        m_obs.stop()
        m_obs = None
        stages["(d) mesh chain"] = time.perf_counter() - t0

        # (f) the scrape
        t0 = time.perf_counter()
        text = obs.prometheus_text()
        scrape_s = time.perf_counter() - t0
        fams = [ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE ")]
        series = [ln.rsplit(" ", 1)[0] for ln in text.splitlines()
                  if ln and not ln.startswith("#")]
        need = ("emqx_xla_audit_total", "emqx_xla_audit_divergence_total",
                "emqx_xla_audit_quarantine_total", "emqx_xla_audit_unquarantine_total",
                "emqx_xla_audit_quarantine_resolve_refusals_total",
                "emqx_xla_publish_stage_seconds", "emqx_xla_delivery_stage_seconds",
                "emqx_xla_slo_burn_rate", "emqx_xla_slo_breached",
                "emqx_flight_events_total", "emqx_flight_snapshots_total",
                "emqx_flight_triggers_total", "emqx_hook_duration_seconds")
        absent = [f for f in need if f not in fams]
        if len(fams) != len(set(fams)) or len(series) != len(set(series)) or absent:
            raise AssertionError(f"(f): families twice or missing {absent}")
        log(f"observability (f) scrape: {len(fams)} families, {len(series)} series, "
            f"{len(text)} bytes in {scrape_s:.6f} s, each family once, the audit, "
            f"stage, SLO and flight families present [{card}]")

        # (g) OTel spans around single publishes
        tr = MemoryTracer()
        broker.tracer = tr
        try:
            ns = [broker.publish(Message(topic=t, payload=bytes(64), from_client="pub"))
                  for t in ("mfan/6/p11g", publish_batch(rng, skel, exact)[0])]
        finally:
            broker.tracer = None
        by_id = {sp.span_id: sp for sp in tr.spans}
        roots = [sp for sp in tr.spans if sp.name == "mqtt.publish"]
        kids = sorted((sp.name, by_id[sp.parent_id].name) for sp in tr.spans if sp.parent_id)
        ok = (len(roots) == 2 and kids == [("broker.dispatch", "mqtt.publish")] * 2
              + [("broker.route", "mqtt.publish")] * 2
              and all(r.attrs.get("mqtt.deliveries") == n for r, n in zip(roots, ns))
              and all({"mqtt.topic", "mqtt.qos", "mqtt.clientid"} <= set(r.attrs)
                      for r in roots)
              and all("broker.matched_filters" in sp.attrs for sp in tr.spans
                      if sp.name == "broker.route"))
        if not ok:
            raise AssertionError(f"(g): span tree {kids}, roots "
                                 f"{[r.attrs for r in roots]}")
        deliveries.seen.clear()
        log(f"observability (g) OTel: {len(tr.spans)} spans for 2 publishes "
            f"({ns} deliveries), mqtt.publish -> broker.route + broker.dispatch with "
            f"the reference's attributes [{card}]")
        if {k: c.get(k, 0) for k in FAULT_COUNTERS} != rec["faults"]:
            raise AssertionError("phase 11: device-fault counters moved outside (e)")
    finally:
        for o in (obs, m_obs):
            if o is not None:
                o.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    phase = launches()
    missing = [n for n in SINGLE_PATH if phase[n] <= 0]
    if missing:
        raise AssertionError(f"phase 11 never launched {missing}")
    took = time.perf_counter() - t_phase
    log(f"phase 11: {took:.3f} s ("
        + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
        + f"), launches {phase} [{card}]")
    if took > P11_LIMIT_S:
        raise AssertionError(f"phase 11 took {took:.3f} s, over {P11_LIMIT_S} s")
    return phase


def host_encode_ms(router, skel, exact, seed: int) -> float:
    """The host's own speed in this process: the median of 20 host
    encodes of one batch, no device work."""
    import numpy as np

    from emqx_tpu_torch.ops import match as M

    batch = publish_batch(np.random.default_rng(seed), skel, exact)
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        M.encode_topics(router.table.vocab, batch, router.max_levels)
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def serve_rates(router, skel, exact, rng, seed: int, card: str) -> None:
    """`--serve`: phases 5, 6 and 9's serve paths as the full run drives
    them (warm-up, then the timed batches with churn, every answer
    checked against the host path), phase 5's busy share, phases 5 and
    9's leg medians and timed generation-2 collections, without the
    kernel checks; one line of their rates. Two
    trees compare in many turns of one call with it. `host_encode_ms`
    (the median of 20 host encodes of one batch, no device work) reads
    the host's own speed in that process, against which a host-bound
    rate is read."""
    import gc

    import numpy as np
    import torch

    from emqx_tpu_torch.models.router import Router

    out = {"host_encode_ms": host_encode_ms(router, skel, exact, seed)}
    router.warmup_shapes(max_batch=BATCH)
    out["topics_s"], out["escalations"], *_, gcs = serve(router, skel, exact, rng)
    out["gen2_timed"], out["gen2_timed_s"] = len(gcs.timed), round(sum(gcs.timed), 6)
    out["legs_p50_ms"] = {leg: round(h.percentile(50) * 1e3, 4)
                          for leg, h in sorted(router.telemetry.hist.items())}
    dev_s, wall_s, _n = device_busy_share(router, skel, exact, rng)
    out["busy_share"] = dev_s / wall_s
    del router
    gc.collect()
    torch.cuda.empty_cache()
    dense, skel, exact, _ = build_router(np.random.default_rng(seed), DEVICE,
                                         use_hash_index=False)
    dense.warmup_shapes(max_batch=BATCH)
    out["dense_only_topics_s"] = serve(dense, skel, exact, rng, N_DENSE_BATCHES)[0]
    del dense
    gc.collect()
    torch.cuda.empty_cache()
    rng9 = np.random.default_rng(seed + 3)
    mesh = Router(max_levels=16, mesh=mesh_of(MESH))
    skel, exact, _ = add_route_set(mesh, rng9)
    mesh.device_table.sync()
    mesh.warmup_shapes(max_batch=BATCH)
    out["mesh_topics_s"], *_, gcs = serve(mesh, skel, exact, rng9, N_MESH_BATCHES)
    out["mesh_gen2_timed"], out["mesh_gen2_timed_s"] = len(gcs.timed), round(sum(gcs.timed), 6)
    out["mesh_legs_p50_ms"] = {leg: round(h.percentile(50) * 1e3, 4)
                               for leg, h in sorted(mesh.telemetry.hist.items())}
    log(f"serve: {json.dumps(out)} [{card}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--serve", action="store_true",
                    help="only the serve paths of phases 5, 6 and 9, for A/B turns")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    t_run = time.perf_counter()
    phase_s = {}
    t_lap = [t_run]

    def lap(phase):
        now = time.perf_counter()
        phase_s[phase] = round(now - t_lap[0], 3)
        t_lap[0] = now

    # phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from emqx_tpu_torch.ops import _build
    from emqx_tpu_torch.broker import pubsub as _pubsub  # noqa: F401  registers every kernel

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    lap(1)
    # phase 2: build
    from emqx_tpu_torch import native

    t0 = time.perf_counter()
    native_s = native.build_all()
    log(f"native build: {json.dumps(native_s)} in {time.perf_counter() - t0:.3f} s; "
        f"{native.compiler_version()}; python include {native.include_dir()}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {sorted(_build.KERNELS)} in {time.perf_counter() - t0:.3f} s")
    if not args.serve:
        native_checks(card)

    rng = np.random.default_rng(args.seed)
    lap(2)

    # phase 3: slice set-up
    watch = ChurnCoreWatch()
    router, skel, exact, host_s = build_router(rng, DEVICE)
    log(f"routes: {router.stats()} residual_rows={len(router.index.residual_rows)} "
        f"classes={router.index.active_hi()} host_build_s={host_s:.3f} [{card}]")
    log(watch.line("phase 3"))
    if not router.index.residual_rows:
        raise AssertionError("the residual leg has no rows")
    if args.serve:
        serve_rates(router, skel, exact, rng, args.seed, card)
        return 0

    lap(3)
    # phase 4: kernel vs plain
    recs = check_kernels(router, skel, publish_batch(rng, skel, exact), rng)
    lap(4)

    # phase 5: the slice end to end; counters from zero just before it
    t0 = time.perf_counter()
    warmed = router.warmup_shapes(max_batch=BATCH)
    warm_s = time.perf_counter() - t0
    _build.reset_launches()
    with TableSyncs() as syncs:
        rate, esc, served, _busy, moved, gcs = serve(router, skel, exact, rng)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in _build.KERNELS.items()}
    log(f"slice: {served} topics in {N_BATCHES} batches, {rate:.1f} topics/s "
        f"(begin+finish wall, syncs included), overflow_escalations={esc}, "
        f"topics_with_routes_changed_in_flight={moved}, "
        f"warmup_shapes={warmed} in {warm_s:.3f} s, host_build_s={host_s:.3f}, "
        f"{gcs.line()}, launches={launches} [{card}]")
    log(f"slice table syncs: table_sync launches {launches['table_sync']} over "
        f"{N_BATCHES} batches; {syncs.line()} [{card}]")
    legs = {leg: {"n": h.total, "sum_s": round(h.sum, 6),
                  "p50_ms": round(h.percentile(50) * 1e3, 4),
                  "p99_ms": round(h.percentile(99) * 1e3, 4)}
            for leg, h in sorted(router.telemetry.hist.items())}
    log(f"slice legs (host clock, telemetry histograms): {json.dumps(legs)}")
    c = router.telemetry.counters
    # a tree without the sticky bound (the parent of an A/B pair) is read,
    # not held to it
    floor = getattr(router.device_table, "_hash_mh_floor", None)
    log(f"slice hash leg: K1 launches {launches['match_ids_hash']} over {N_BATCHES} "
        f"batches, escalations {esc}, bound floor {floor}, amb batches "
        f"{c.get('ambiguous_batches_total', 0)}, host fallbacks "
        f"{c.get('host_fallback_total', 0)}, host_encode_ms "
        f"{host_encode_ms(router, skel, exact, args.seed):.4f} [{card}]")
    missing = [n for n in ("match_ids_hash", "match_ids", "table_sync") if launches[n] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    if floor is not None and (esc > 1 or launches["match_ids_hash"] > N_BATCHES + 1):
        raise AssertionError(f"the hash leg's bound did not stick: {esc} escalations, "
                             f"{launches['match_ids_hash']} K1 launches over {N_BATCHES} "
                             f"batches")
    if not moved:
        raise AssertionError("no topic saw a route change in flight")
    dev_s, wall_s, n = device_busy_share(router, skel, exact, rng)
    log(f"profile: {n} topics, device busy {dev_s:.6f} s of {wall_s:.6f} s "
        f"begin+finish wall, busy share {dev_s / wall_s:.4f} [{card}]")
    log(watch.line("phase 5"))

    lap(5)
    # phase 6: dense-only mode over the same routes
    del router
    gc.collect()
    torch.cuda.empty_cache()
    dense, skel, exact, dense_host_s = build_router(
        np.random.default_rng(args.seed), DEVICE, use_hash_index=False)
    dense.warmup_shapes(max_batch=BATCH)
    _build.reset_launches()
    with TableSyncs() as d_syncs:
        d_rate, d_esc, d_served, _busy, d_moved, _gc = serve(
            dense, skel, exact, rng, N_DENSE_BATCHES)
    torch.cuda.synchronize()
    d_launches = {name: k.launches for name, k in _build.KERNELS.items()}
    log(f"dense-only: {d_served} topics in {N_DENSE_BATCHES} batches, "
        f"{d_rate:.1f} topics/s (begin+finish wall, syncs included), "
        f"overflow_escalations={d_esc}, topics_with_routes_changed_in_flight="
        f"{d_moved}, host_build_s={dense_host_s:.3f}, {d_syncs.line()}, "
        f"launches={d_launches} [{card}]")
    if d_launches["match_ids"] <= 0 or d_launches["table_sync"] <= 0:
        raise AssertionError(f"dense-only mode skipped K2 or the table sync: {d_launches}")
    if d_launches["match_ids_hash"] or any(n_s for _, n_s in d_syncs.entries):
        raise AssertionError(f"dense-only mode launched the hash leg or synced slots: "
                             f"{d_launches}, {d_syncs.line()}")
    log(watch.line("phase 6"))
    del dense
    gc.collect()
    torch.cuda.empty_cache()

    lap(6)
    # phase 7: the broker publish path
    counts = codec_counts()
    b_recs, b_launches, b_ctx = broker_phase(np.random.default_rng(args.seed + 1), card)
    log(watch.line("phase 7"))
    # phase 7's QoS-0 broadcast to sinks reaches no codec: sessions only
    log(codec_line(counts, "phase 7", need_frames=False))
    recs.update(b_recs)
    gc.collect()
    # phase 7's broker lives on for phase 10: keep its objects out of the
    # collector's scans in phases 8 and 9 (phase 10's engine unfreezes)
    gc.freeze()
    torch.cuda.empty_cache()
    lap(7)

    # phase 8: retained reads and the server
    counts = codec_counts()
    recs["retained_probe"], k8_launches = retained_phase(
        np.random.default_rng(args.seed + 2), card)
    log(watch.line("phase 8"))
    log(codec_line(counts, "phase 8"))
    lap(8)

    # phase 9: the sub-sharded mesh routing path
    m_recs, m_launches, m_ctx = mesh_phase(np.random.default_rng(args.seed + 3), card)
    recs.update(m_recs)
    log(watch.line("phase 9"))
    lap(9)

    # phase 10: the device failure domain, on phase 7's broker and phase
    # 9's mesh; launch counters from zero at its start
    counts = codec_counts()
    f_launches = failure_domain_phase(b_ctx, m_ctx, np.random.default_rng(args.seed + 4),
                                      args.seed, card)
    log(watch.line("phase 10"))
    log(codec_line(counts, "phase 10", need_sessions=False, need_frames=False))
    lap(10)

    # phase 11: the publish path's observability, on phase 7's broker and
    # phase 9's mesh broker; launch counters from zero at its start
    o_launches = observability_phase(b_ctx, m_ctx, np.random.default_rng(args.seed + 5),
                                     args.seed, card)
    log(watch.line("phase 11"))
    lap(11)

    def phase10_launches(name):
        # a fused kernel's total on each of its entries; the dense-only
        # record's launches are phase 6's, none of them phase 10's
        if name == "match_ids_dense_only":
            return 0
        key = name.split(" ")[0].replace("resolve_fanout_small", "resolve_fanout")
        return f_launches.get(key, 0)

    def phase11_launches(name):
        if name == "match_ids_dense_only":
            return 0
        key = name.split(" ")[0].replace("resolve_fanout_small", "resolve_fanout")
        return o_launches.get(key, 0)

    path_launches = dict(launches, match_ids_dense_only=d_launches["match_ids"],
                         retained_probe=k8_launches)
    for name in b_recs:
        path_launches[name] = b_launches[name.replace("resolve_fanout_small", "resolve_fanout")]
    for name in list(m_recs) + list(GROWTH_PATH):
        path_launches[name] = m_launches[name]
    for name, r in recs.items():
        log(f"kernel {name}: {times_line(r)} "
            f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) "
            f"launches={path_launches[name]} phase10_launches="
            f"{phase10_launches(name)} phase11_launches={phase11_launches(name)} "
            f"equal=True [{r['shape']}] [{card}]")

    # phase 12: summary
    meta = {
        "match_ids_hash": ("emqx_tpu_torch/ops/csrc/hash_match.cu",
                           "emqx_tpu/ops/hash_index.py:899"),
        "match_ids": ("emqx_tpu_torch/ops/csrc/dense_match.cu",
                      "emqx_tpu/ops/match.py:159"),
        "match_ids_dense_only": ("emqx_tpu_torch/ops/csrc/dense_match.cu",
                                 "emqx_tpu/ops/match.py:159"),
        # K3 and K4 are one fused launch: both entries read its record
        "table_sync (K3)": ("emqx_tpu_torch/ops/csrc/scatter.cu",
                            "emqx_tpu/models/router.py:67"),
        "table_sync (K4)": ("emqx_tpu_torch/ops/csrc/scatter.cu",
                            "emqx_tpu/models/router.py:100"),
        "resolve_fanout": ("emqx_tpu_torch/ops/csrc/fanout.cu",
                           "emqx_tpu/ops/fanout.py:137"),
        "resolve_fanout_small": ("emqx_tpu_torch/ops/csrc/fanout.cu",
                                 "emqx_tpu/ops/fanout.py:137"),
        # K6 and K7 are one fused launch: both entries read its record
        "fanout_sync (K6)": ("emqx_tpu_torch/ops/csrc/scatter.cu",
                             "emqx_tpu/ops/fanout.py:95"),
        "fanout_sync (K7)": ("emqx_tpu_torch/ops/csrc/scatter.cu",
                             "emqx_tpu/ops/fanout.py:118"),
        "probe_add_one": ("emqx_tpu_torch/ops/csrc/probe.cu",
                          "emqx_tpu/ops/transfer.py:150"),
        "retained_probe": ("emqx_tpu_torch/ops/csrc/retained_probe.cu",
                           "emqx_tpu/ops/retained.py:81"),
        "match_dense": ("emqx_tpu_torch/ops/csrc/packed_match.cu",
                        "emqx_tpu/ops/match.py:120"),
        "match_packed": ("emqx_tpu_torch/ops/csrc/packed_match.cu",
                         "emqx_tpu/ops/match.py:129"),
        "match_counts": ("emqx_tpu_torch/ops/csrc/packed_match.cu",
                         "emqx_tpu/ops/match.py:214"),
        "mesh_match_counts": ("emqx_tpu_torch/ops/csrc/packed_match.cu",
                              "emqx_tpu/parallel/sharded_match.py:73"),
        "mesh_match_packed": ("emqx_tpu_torch/ops/csrc/packed_match.cu",
                              "emqx_tpu/parallel/sharded_match.py:82"),
        # K13 apply_delta and K18 are one fused launch: the three entries
        # read its record; apply_delta and the slot delta count the
        # growth window's row-only and slot-only launches (the wrapper's
        # tally by kind, sharded_match.SYNC_LAUNCH_KINDS)
        "mesh_table_sync (K13 apply_delta)": ("emqx_tpu_torch/ops/csrc/scatter.cu",
                                              "emqx_tpu/parallel/sharded_match.py:58"),
        "combine_pairs": ("emqx_tpu_torch/ops/csrc/combine.cu",
                          "emqx_tpu/parallel/sharded_match.py:146"),
        "combine_probe": ("emqx_tpu_torch/ops/csrc/combine.cu",
                          "emqx_tpu/parallel/sharded_match.py:165"),
        "mesh_match_ids": ("emqx_tpu_torch/ops/csrc/dense_match.cu",
                           "emqx_tpu/parallel/sharded_match.py:202"),
        "mesh_match_ids_hash": ("emqx_tpu_torch/ops/csrc/hash_match.cu",
                                "emqx_tpu/parallel/sharded_match.py:260"),
        "mesh_table_sync (K18 slot delta)": ("emqx_tpu_torch/ops/csrc/scatter.cu",
                                             "emqx_tpu/parallel/sharded_match.py:439"),
        "mesh_table_sync (K18)": ("emqx_tpu_torch/ops/csrc/scatter.cu",
                                  "emqx_tpu/parallel/sharded_match.py:493"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        key = name.split(" ")[0]
        r = recs[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": path_launches.get(name, path_launches[key]),
            "launches_phase10": phase10_launches(name),
            "launches_phase11": phase11_launches(name),
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "call_ms": r["call_ms"],
            "device_ms": r["device_ms"], "plain_call_ms": r["plain_call_ms"],
            "library_call_ms": r["library_call_ms"], "verified": True,
        })
    log(f"run: {time.perf_counter() - t_run:.3f} s; seconds by phase {phase_s} [{card}]")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
