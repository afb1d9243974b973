"""Retained-message match index (counterpart of emqx_tpu/ops/retained.py:
the host `RetainedIndex` and kernel K8).

Routing (ops/hash_index.py) stores FILTERS and queries with topic
NAMES: classes come from the stored filters' skeletons and a topic
probes every class. The retained read is the mirror problem — the
store holds wildcard-free topic NAMES and the SUBSCRIBE-side filter is
the query — so the table inverts: **classes come from the QUERY
filters' skeletons** (plen, '#'-suffix, '+'-position mask), and every
stored name inserts one row per active class it is eligible for,
keyed by its literal-position projection. Names that differ only at
a class's '+' positions (or past its '#') share a projection, hence a
bucket; the bucket's member set IS the answer to that filter.

The probe is therefore an exact-match lookup, [B] not [B,C]: each
query filter knows its own class, the host mixes (h1, fp) per query
with the SAME bit-exact hash the routing kernel uses, and the device
does 2 probe-word gathers + ≤2 full-fingerprint verifies per query
(K1's phase 2 without the compaction; eligibility is enforced at
INSERT time, so a table hit is already length- and '$'-correct). The
host finish half then verifies the winning bucket's stored projection
against the query's (killing 2^-32 fingerprint collisions) and
expands members.

Exactness contract (same shape as routing's):

  * a query whose key is in the table always byte-matches its own
    lane, so a single surviving full-fp lane with a mismatched
    projection proves the key absent — empty result, no fallback;
  * >1 full-fp lanes or >2 byte-matching lanes make the probe
    ambiguous for THAT query — it takes the host trie walk, counted
    (`retained_host_fallback_total`), never silently wrong;
  * deeper-than-`max_levels` names or filters, class-budget overflow
    and sub-`min_device` stores go to the host walk up front; a
    literal no stored name uses answers empty with no launch.

Builds (class creation, pow2 growth) are control-plane events: the
first read after one re-uploads the mirror and launches the pow2 batch
ladder once per table size (`_warmup`), which on the card also builds
and loads K8's library at attach rather than at the first serve.
Results ride `ops/transfer.py` FetchTickets: `read_begin` launches
every chunk's kernel and starts its device→host copy, `read_finish`
pays only the residual wait.

K8 (`probe_retained`) launches `csrc/retained_probe.cu` for CUDA
tensors; `probe_retained_ref` is its plain PyTorch version, which CPU
tensors take. A launch moves one buffer each way: `stage_queries` packs
a rung's (h1, fp, valid) into 9·B bytes copied to the device at once,
and the wrapper writes both outputs into one 5·B-byte buffer, which the
read's FetchTicket copies back in one piece.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve, to_device
from ..obs.kernel_telemetry import NULL as _NULL_TEL
from . import topic as topic_mod
from ._build import I, P, CudaKernel, raw_stream
from .hash_index import (
    BUCKET_W,
    M32,
    MIN_SLOTS,
    SlotArrays,
    _ALT_MUL,
    _evict_insert,
    _hash_host,
    _hash_host_batch,
    _pack_probe,
    _refresh_probe_many,
    _u32,
    build_slots,
)
from .match import check_tensor
from .transfer import start_fetch
from .vocab import OOV, Vocab

DEFAULT_MAX_LEVELS = 16
DEFAULT_CLASS_BUDGET = 64
# pow2 batch ladder: queries pad up to the next rung, storms chunk at
# the top rung — 4 launch shapes per table size, ever
BATCH_LADDER = (8, 64, 512, 4096)
MAX_BATCH = BATCH_LADDER[-1]

_KERNEL = "retained_probe"


# --- K8: the plain PyTorch version ---------------------------------------


def probe_retained_ref(probe, fp_tab, bucket_tab, qh1, qfp, qvalid):
    """Plain PyTorch version of K8, on any device: (bucket_id int32 [B],
    -1 on a miss; amb bool [B]). uint32 arithmetic runs in int64
    masked to 32 bits (the CPU build has no uint32 shift)."""
    dev = qh1.device
    mask = probe.shape[0] - 1
    h1 = _u32(qh1)
    fp = _u32(qfp)
    b1 = h1 & mask
    b2 = b1 ^ ((((fp | 1) * _ALT_MUL) & M32) & mask)
    words = _u32(probe)
    w1 = words[b1]
    w2 = words[b2]
    p8 = torch.clamp_min(fp >> 24, 1)
    lid = torch.arange(2 * BUCKET_W, dtype=torch.int64, device=dev)
    shift = 8 * (lid & 3)
    lane_byte = torch.where(
        lid[None, :] < BUCKET_W, w1[:, None] >> shift, w2[:, None] >> shift
    ) & 0xFF
    bm = (lane_byte == p8[:, None]) & qvalid[:, None]
    nbm = bm.sum(1)
    l1 = torch.argmax(bm.to(torch.int32), 1)  # first byte-matching lane
    bm2 = bm & (lid[None, :] != l1[:, None])
    l2 = torch.argmax(bm2.to(torch.int32), 1)  # second (0 when absent)

    def slot_of(ln):
        return torch.where(ln < BUCKET_W, b1, b2) * BUCKET_W + (ln & 3)

    s1 = slot_of(l1)
    s2 = slot_of(l2)
    fps = _u32(fp_tab)
    ok1 = (nbm >= 1) & (fps[s1] == fp)
    ok2 = (nbm >= 2) & (fps[s2] == fp)
    g = bucket_tab[torch.where(ok1, s1, s2)]
    hit = (ok1 | ok2) & (g >= 0)
    out = torch.where(hit, g, -1).to(torch.int32)
    amb = (ok1 & ok2) | (qvalid & (nbm > 2))
    return out, amb


# --- K8: the CUDA kernel --------------------------------------------------

_RETAINED_PROBE = CudaKernel(
    _KERNEL, "retained_probe.cu", "emqx_retained_probe",
    [P, P, P, I, P, P, P, I, P, P, P],
)


def result_views(buf: torch.Tensor):
    """(bid int32 [B], amb bool [B]) over a K8 result buffer of 5·B
    bytes: the bucket ids' bytes, then the flags'."""
    b = buf.shape[0] // 5
    return buf[: 4 * b].view(torch.int32), buf[4 * b :].view(torch.bool)


def host_result(buf: np.ndarray):
    """(bids int32, ambs bool) numpy views of a K8 result buffer fetched
    to the host (`result_views`' layout)."""
    b = buf.shape[0] // 5
    return buf[: 4 * b].view(np.int32), buf[4 * b :].view(np.bool_)


def probe_retained(probe, fp_tab, bucket_tab, qh1, qfp, qvalid, out=None):
    """[B] exact-key probe: 2 probe-word gathers, byte screen, ≤2
    full-fingerprint verifies, one bucket-id gather. Returns
    (bucket_id int32 [B] — -1 miss, amb bool [B] — per-query host
    escalation flags) on the queries' device, both views of one uint8
    buffer of 5·B bytes (`result_views`): `out` when given, else a new
    one.

    CUDA tensors launch kernel K8; CPU tensors take the plain version."""
    dev = qh1.device
    b = qh1.shape[0]
    if out is None:
        out = torch.empty(5 * b, dtype=torch.uint8, device=dev)
    elif dev.type != "cpu":
        check_tensor("out", out, torch.uint8, (5 * b,), dev)
    bid, amb = result_views(out)
    if dev.type == "cpu":
        got = probe_retained_ref(probe, fp_tab, bucket_tab, qh1, qfp, qvalid)
        bid.copy_(got[0])
        amb.copy_(got[1])
        return bid, amb
    s = probe.shape[0]
    if s < 1 or s & (s - 1):
        raise ValueError(f"bucket count {s} is not a power of two")
    check_tensor("probe", probe, torch.uint32, (s,), dev)
    check_tensor("fp_tab", fp_tab, torch.uint32, (s * BUCKET_W,), dev)
    check_tensor("bucket_tab", bucket_tab, torch.int32, (s * BUCKET_W,), dev)
    check_tensor("qh1", qh1, torch.uint32, (b,), dev)
    check_tensor("qfp", qfp, torch.uint32, (b,), dev)
    check_tensor("qvalid", qvalid, torch.bool, (b,), dev)
    fp_ptr, bucket_ptr = fp_tab.data_ptr(), bucket_tab.data_ptr()
    if (fp_ptr | bucket_ptr) & 15:
        # K8 reads a bucket's four lanes as one 16-byte vector
        raise ValueError("fp_tab and bucket_tab must be 16-byte aligned")
    _RETAINED_PROBE(
        probe.data_ptr(), fp_ptr, bucket_ptr, s,
        qh1.data_ptr(), qfp.data_ptr(), qvalid.data_ptr(), b,
        bid.data_ptr(), amb.data_ptr(), raw_stream(dev),
    )
    return bid, amb


def stage_queries(h1, fp, valid, b: int, device: torch.device):
    """(qh1 uint32, qfp uint32, qvalid bool [b]) on `device` for one K8
    launch: the given queries' (h1, fp, valid) packed into one host
    buffer of 9·b bytes (zero past them: padding lanes), one copy to the
    device, the three tensors views of it."""
    n = len(h1)
    buf = np.zeros(9 * b, np.uint8)
    buf[: 4 * b].view(np.uint32)[:n] = h1
    buf[4 * b : 8 * b].view(np.uint32)[:n] = fp
    buf[8 * b : 8 * b + n] = valid
    t = to_device(buf, device)
    return (t[: 4 * b].view(torch.uint32), t[4 * b : 8 * b].view(torch.uint32),
            t[8 * b :].view(torch.bool))


class ReadTicket:
    """Launched retained read: per-filter plans plus the in-flight
    device chunks. Consumed exactly once by `read_finish`."""

    __slots__ = ("plans", "chunks", "generation")

    def __init__(self, plans, chunks, generation) -> None:
        self.plans = plans  # per filter: ("host",)|("empty",)|("dev", qi)
        self.chunks = chunks  # [(FetchTicket, n_valid, [meta per query])]
        self.generation = generation


class RetainedIndex:
    """Cuckoo-backed retained-name index for one table (the
    reference's ShardedRetainedIndex waits with the mesh). Holds names as
    interned word rows; answers wildcard filters with name lists.
    `device` holds the K8 mirror: None means the CUDA card (raising
    when none is present), "cpu" runs the plain version."""

    def __init__(
        self,
        max_levels: int = DEFAULT_MAX_LEVELS,
        class_budget: int = DEFAULT_CLASS_BUDGET,
        min_device: int = 0,
        telemetry=None,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve(device)
        self.L = max_levels
        self.class_budget = class_budget
        self.min_device = min_device
        self.tel = telemetry if telemetry is not None else _NULL_TEL
        self.vocab = Vocab()
        # name rows (columnar): _row_x holds word_id+1 per level (the
        # hash's x encoding), 0 past the name's length
        cap = 1024
        self._row_x = np.zeros((cap, self.L), np.uint32)
        self._row_len = np.zeros(cap, np.int32)
        self._row_dollar = np.zeros(cap, bool)
        self._row_live = np.zeros(cap, bool)
        self._row_name: List[Optional[str]] = [None] * cap
        self._row_of: Dict[str, int] = {}
        self._free: List[int] = list(range(cap - 1, -1, -1))
        # names deeper than max_levels: kept out of the table, so every
        # read goes to the host walk while one is stored
        self._deep_names = 0
        # classes (from QUERY skeletons)
        self._cid_of: Dict[Tuple[int, bool, int], int] = {}
        self._cls_plen: List[int] = []
        self._cls_hash: List[bool] = []
        self._cls_rootwild: List[bool] = []
        self._cls_plus: List[int] = []
        # buckets: key (cid, projection-bytes) -> bid
        self._key_bid: Dict[Tuple[int, bytes], int] = {}
        self._bid_key: List[Optional[Tuple[int, bytes]]] = []
        self._bid_members: List[Optional[Set[int]]] = []
        self._bid_h1: List[int] = []
        self._bid_fp: List[int] = []
        self._bid_free: List[int] = []
        # cuckoo table (host truth) + device mirror
        self._n_buckets = MIN_SLOTS // BUCKET_W
        self._slots = SlotArrays(
            np.zeros(self._n_buckets * BUCKET_W, np.uint32),
            np.full(self._n_buckets * BUCKET_W, -1, np.int32),
            np.zeros(self._n_buckets, np.uint32),
        )
        self._host_version = 0
        self._dev_version = -1
        self._dev = None  # (probe, fp, bucket) tensors on self.device
        self._warm_buckets = -1  # n_buckets the ladder was launched for
        self.generation = 0  # bumped on any mutation; stale tickets
        # fall back to the host walk instead of reading moved buckets

    def __len__(self) -> int:
        return len(self._row_of)

    # --- name side (insert/remove) -------------------------------------

    def _encode_name(self, name: str):
        ws = topic_mod.words(name)
        if len(ws) > self.L:
            return None
        x = np.zeros(self.L, np.uint32)
        for i, w in enumerate(ws):
            x[i] = (self.vocab.intern(w) + 1) & M32
        return x, len(ws), name.startswith("$")

    def add(self, name: str) -> bool:
        """Index a stored name. Returns False (uncovered, host-only)
        for names deeper than max_levels — the caller's host walk
        still covers them, so reads for such depths must escalate;
        we keep them out rather than corrupting the table."""
        if name in self._row_of:
            return True
        enc = self._encode_name(name)
        if enc is None:
            self._deep_names += 1
            return False
        x, ln, dollar = enc
        if not self._free:
            self._grow_rows()
        row = self._free.pop()
        self._row_x[row] = x
        self._row_len[row] = ln
        self._row_dollar[row] = dollar
        self._row_live[row] = True
        self._row_name[row] = name
        self._row_of[name] = row
        for cid in range(len(self._cls_plen)):
            if self._eligible(row, cid):
                self._insert_member(cid, row)
        self.generation += 1
        return True

    def remove(self, name: str) -> None:
        row = self._row_of.pop(name, None)
        if row is None:
            # deep (uncovered) names were never indexed
            if len(topic_mod.words(name)) > self.L:
                self._deep_names = max(self._deep_names - 1, 0)
            return
        for cid in range(len(self._cls_plen)):
            if self._eligible(row, cid):
                self._remove_member(cid, row)
        for i in range(int(self._row_len[row])):
            self.vocab.release(self.vocab.word(int(self._row_x[row, i]) - 1))
        self._row_live[row] = False
        self._row_name[row] = None
        self._row_x[row] = 0
        self._free.append(row)
        self.generation += 1

    def _grow_rows(self) -> None:
        old = self._row_x.shape[0]
        cap = old * 2
        for arr_name in ("_row_x", "_row_len", "_row_dollar", "_row_live"):
            a = getattr(self, arr_name)
            na = np.zeros((cap,) + a.shape[1:], a.dtype)
            na[:old] = a
            setattr(self, arr_name, na)
        self._row_name.extend([None] * old)
        self._free.extend(range(cap - 1, old - 1, -1))

    def _eligible(self, row: int, cid: int) -> bool:
        ln = int(self._row_len[row])
        plen = self._cls_plen[cid]
        if self._cls_hash[cid]:
            if ln < plen:
                return False
        elif ln != plen:
            return False
        if self._cls_rootwild[cid] and bool(self._row_dollar[row]):
            return False
        return True

    def _proj_of(self, row: int, cid: int) -> bytes:
        plen = self._cls_plen[cid]
        plus = self._cls_plus[cid]
        x = self._row_x[row, :plen].copy()
        for i in range(plen):
            if (plus >> i) & 1:
                x[i] = 0
        return x.tobytes()

    # --- bucket/cuckoo side --------------------------------------------

    def _insert_member(self, cid: int, row: int) -> None:
        key = (cid, self._proj_of(row, cid))
        bid = self._key_bid.get(key)
        if bid is not None:
            self._bid_members[bid].add(row)
            return
        bid = self._alloc_bid(key)
        proj = np.frombuffer(key[1], np.uint32)
        lit = [
            (i, int(proj[i]) - 1)
            for i in range(self._cls_plen[cid])
            if proj[i] != 0
        ]
        h1, fp = _hash_host(cid, lit, self.L)
        self._bid_h1[bid] = h1
        self._bid_fp[bid] = fp
        self._bid_members[bid] = {row}
        self._key_bid[key] = bid
        if not _evict_insert(
            self._slots, self._n_buckets, h1 & (self._n_buckets - 1), fp, bid
        ):
            self._rebuild(self._n_buckets * 2)
        else:
            # _evict_insert kicks touch many buckets; the reference's
            # sync is the full probe repack (vectorized), kept as is
            _pack_probe(self._slots)
        self._host_version += 1

    def _remove_member(self, cid: int, row: int) -> None:
        key = (cid, self._proj_of(row, cid))
        bid = self._key_bid.get(key)
        if bid is None:
            return
        members = self._bid_members[bid]
        members.discard(row)
        if members:
            return
        # bucket emptied: clear its slot and retire the bid
        del self._key_bid[key]
        self._bid_key[bid] = None
        self._bid_members[bid] = None
        sl = np.flatnonzero(self._slots.bucket == bid)
        if len(sl):
            self._slots.bucket[sl] = -1
            self._slots.fp[sl] = 0
            _refresh_probe_many(self._slots, np.unique(sl // BUCKET_W))
        self._bid_free.append(bid)
        self._host_version += 1

    def _alloc_bid(self, key) -> int:
        if self._bid_free:
            bid = self._bid_free.pop()
            self._bid_key[bid] = key
            return bid
        self._bid_key.append(key)
        self._bid_members.append(None)
        self._bid_h1.append(0)
        self._bid_fp.append(0)
        return len(self._bid_key) - 1

    def _rebuild(self, min_buckets: int) -> None:
        live = [
            b for b in range(len(self._bid_key))
            if self._bid_key[b] is not None
        ]
        h1 = np.array([self._bid_h1[b] for b in live], np.uint32)
        fp = np.array([self._bid_fp[b] for b in live], np.uint32)
        ids = np.array(live, np.int32)
        slots, _pos, n_buckets = build_slots(
            h1, fp, ids, min_buckets=max(min_buckets, MIN_SLOTS // BUCKET_W)
        )
        self._slots = slots
        self._n_buckets = n_buckets
        self._host_version += 1
        if self.tel.enabled:
            self.tel.count("retained_index_builds_total")

    # --- class side -----------------------------------------------------

    def _skeleton(self, fw: Sequence[str]):
        has_hash = fw[-1] == "#"
        prefix = fw[:-1] if has_hash else fw
        plen = len(prefix)
        if plen > self.L:
            return None
        plus = 0
        for i, w in enumerate(prefix):
            if w == "+":
                plus |= 1 << i
        root_wild = len(fw) > 0 and fw[0] in ("+", "#")
        return plen, has_hash, plus, root_wild

    def _ensure_class(self, plen, has_hash, plus, root_wild):
        cid = self._cid_of.get((plen, has_hash, plus))
        if cid is not None:
            return cid
        if len(self._cls_plen) >= self.class_budget:
            return None
        cid = len(self._cls_plen)
        self._cid_of[(plen, has_hash, plus)] = cid
        self._cls_plen.append(plen)
        self._cls_hash.append(has_hash)
        self._cls_rootwild.append(root_wild)
        self._cls_plus.append(plus)
        self._build_class(cid)
        return cid

    def _build_class(self, cid: int) -> None:
        """Bulk-insert every eligible stored name into the new class
        (vectorized): project, group identical projections into
        buckets, batch-hash, rebuild the table once."""
        plen = self._cls_plen[cid]
        plus = self._cls_plus[cid]
        live = np.flatnonzero(self._row_live)
        if self._cls_hash[cid]:
            live = live[self._row_len[live] >= plen]
        else:
            live = live[self._row_len[live] == plen]
        if self._cls_rootwild[cid]:
            live = live[~self._row_dollar[live]]
        if len(live):
            proj = self._row_x[live, :plen].copy()
            for i in range(plen):
                if (plus >> i) & 1:
                    proj[:, i] = 0
            if plen:
                uniq, inv = np.unique(proj, axis=0, return_inverse=True)
                inv = inv.reshape(-1)
            else:
                uniq = np.zeros((1, 0), np.uint32)
                inv = np.zeros(len(live), np.int64)
            xs = np.zeros((len(uniq), self.L), np.uint32)
            if plen:
                xs[:, :plen] = uniq
            h1s, fps = _hash_host_batch(np.full(len(uniq), cid, np.uint32), xs)
            members: List[Set[int]] = [set() for _ in range(len(uniq))]
            for r, u in zip(live.tolist(), inv.tolist()):
                members[u].add(r)
            for u in range(len(uniq)):
                key = (cid, uniq[u].tobytes())
                bid = self._alloc_bid(key)
                self._bid_h1[bid] = int(h1s[u])
                self._bid_fp[bid] = int(fps[u])
                self._bid_members[bid] = members[u]
                self._key_bid[key] = bid
        self._rebuild(self._n_buckets)
        self.generation += 1

    # --- device sync / warmup ------------------------------------------

    def warmup(self) -> None:
        """Upload the mirror and launch the batch ladder now, at attach,
        so the first read pays neither (nor, on the card, K8's build)."""
        self._device_tables()

    def _device_tables(self):
        if self._dev is None or self._dev_version != self._host_version:
            s = self._slots
            self._dev = tuple(
                to_device(a, self.device) for a in (s.probe, s.fp, s.bucket)
            )
            self._dev_version = self._host_version
        if self._warm_buckets != self._n_buckets:
            self._warmup()
        return self._dev

    def _warmup(self) -> None:
        """Launch the pow2 batch ladder once against the CURRENT table
        size, so a build (a control-plane event) pays the first launch
        of each shape — and on the card K8's build and load — before
        serving resumes; read storms then add no shape keys."""
        probe, fp_tab, bucket_tab = self._dev
        tel = self.tel
        for b in BATCH_LADDER:
            if tel.enabled:
                tel.record_shape(_KERNEL, (b, self._n_buckets))
            probe_retained(probe, fp_tab, bucket_tab,
                           *stage_queries((), (), (), b, self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warm_buckets = self._n_buckets

    # --- read halves ----------------------------------------------------

    def _query(self, flt: str):
        """A wildcard filter's probe key (h1, fp, cid, projection), or
        "host" (deeper than max_levels, class budget spent) or "empty"
        (a literal no stored name uses: provably no match)."""
        fw = topic_mod.words(flt)
        sk = self._skeleton(fw)
        if sk is None:
            return "host"
        plen, has_hash, plus, root_wild = sk
        cid = self._ensure_class(plen, has_hash, plus, root_wild)
        if cid is None:
            return "host"
        prefix = fw[:-1] if has_hash else fw
        x = np.zeros(self.L, np.uint32)
        lit = []
        for i, w in enumerate(prefix):
            if (plus >> i) & 1:
                continue
            wid = self.vocab.lookup(w)
            if wid == OOV:
                return "empty"
            x[i] = wid + 1
            lit.append((i, wid))
        h1, fp = _hash_host(cid, lit, self.L)
        return h1, fp, cid, x[:plen].tobytes()

    def _stage(self, chunk):
        """(qh1, qfp, qvalid) on the device for up to MAX_BATCH probe
        keys, padded to their ladder rung (`stage_queries`)."""
        b = next(r for r in BATCH_LADDER if len(chunk) <= r)
        return stage_queries([q[0] for q in chunk], [q[1] for q in chunk], True, b,
                             self.device)

    def read_begin(self, filters: Sequence[str]) -> ReadTicket:
        """Launch the batched probe for a wave of wildcard filters.
        Non-wildcard filters are the caller's dict hit — do not pass
        them here. Every plan that cannot ride the device is marked
        for the caller's host walk, counted at finish."""
        plans: List[tuple] = []
        queries = []  # (h1, fp, cid, proj_bytes, filter_index)
        host_only = len(self._row_of) < self.min_device or self._deep_names > 0
        for fi, flt in enumerate(filters):
            q = "host" if host_only else self._query(flt)
            if isinstance(q, str):
                plans.append((q,))
            else:
                queries.append(q + (fi,))
                plans.append(("dev", fi))
        chunks = []
        if queries:
            probe, fp_tab, bucket_tab = self._device_tables()
            tel = self.tel
            for base in range(0, len(queries), MAX_BATCH):
                chunk = queries[base : base + MAX_BATCH]
                staged = self._stage(chunk)
                b = staged[0].shape[0]
                if tel.enabled:
                    tel.record_shape(_KERNEL, (b, self._n_buckets))
                t0 = tel.clock()
                buf = torch.empty(5 * b, dtype=torch.uint8, device=self.device)
                probe_retained(probe, fp_tab, bucket_tab, *staged, buf)
                if tel.enabled:
                    tel.observe_family("retained_probe_seconds", tel.clock() - t0)
                # one copy carries both outputs
                chunks.append((start_fetch((buf,), tel), len(chunk), chunk))
        return ReadTicket(plans, chunks, self.generation)

    def read_finish(self, ticket: ReadTicket) -> List[Optional[List[str]]]:
        """Collect: per filter, a list of matching names, or None when
        that filter must take the caller's host walk (escalation,
        ambiguity, or a table mutated under an in-flight ticket)."""
        tel = self.tel
        stale = ticket.generation != self.generation
        dev_names: Dict[int, Optional[List[str]]] = {}
        for fetch, n_valid, metas in ticket.chunks:
            bids, ambs = host_result(fetch.wait()[0])
            for j in range(n_valid):
                _h1, _fp, cid, proj, qi = metas[j]
                if stale or bool(ambs[j]):
                    dev_names[qi] = None
                    continue
                bid = int(bids[j])
                if bid < 0:
                    dev_names[qi] = []
                    continue
                key = self._bid_key[bid] if bid < len(self._bid_key) else None
                if key is None or key[0] != cid or key[1] != proj:
                    # single-lane fingerprint collision: the true key
                    # would have matched its own lane too (-> amb), so
                    # a mismatch here proves absence
                    dev_names[qi] = []
                    continue
                dev_names[qi] = [self._row_name[r] for r in self._bid_members[bid]]
        out: List[Optional[List[str]]] = []
        host = device = 0
        for plan in ticket.plans:
            if plan[0] == "host":
                host += 1
                out.append(None)
            elif plan[0] == "empty":
                device += 1
                out.append([])
            else:
                res = dev_names.get(plan[1])
                if res is None:
                    host += 1
                else:
                    device += 1
                out.append(res)
        if tel.enabled:
            if device:
                tel.count("retained_device_reads_total", device)
            if host:
                tel.count("retained_host_fallback_total", host)
        return out

