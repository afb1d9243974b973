// K2: dense batched wildcard match with order-preserving compaction, and
// K16: the same per (dp, sub) tile of a mesh.
//
// K2 replaces emqx_tpu/ops/match.py `match_ids` (with `_match_block`):
// the predicate of dense_pred.cuh over every (topic, row) pair,
// compacted to the first max_hits pairs in (chunk, topic, row) order --
// the order the lax.scan over chunk = min(65536, N) rows writes -- plus
// the exact total.
//
// K16 replaces the per-shard body of emqx_tpu/parallel/sharded_match.py
// `make_match_ids_kernel`: each tile matches its local [B/dp, N/sub]
// plane and compacts its hits in (topic, row) order -- the plain
// `nonzero` of the tile -- to max_hits (topic, row) pairs with GLOBAL ids
// (topic + dp_i * b_loc, row + sub_i * n_loc), plus the tile's exact
// count. The cross-shard combine (combine.cu, K14) follows it.
//
// What bounds it on the H100: in dense-only mode (no class index) the
// operations: 1,053,629 live rows x 1,024 topics, a few integer
// operations a pair (bound 0.129 ms); on the residual leg the bytes: the
// 2 MB active mask admits 2,746 of the 2M rows (bound 0.0007 ms), so
// there it is launches and latency.
//
// Design, one launch sequence on the current stream:
//   1. live_count, scan, live_write: the active mask (read twice, 16
//      bytes a thread) becomes the ascending list of live row ids and the
//      list offset of every chunk's first row. Nothing after this touches
//      a dead row, so a sparse mask costs one read of it.
//   2. dense_items<false>: a block owns one item -- (tile, chunk, part of
//      the chunk's live list, TB topics) -- holds its topics in shared
//      memory and splits its part over its warps. Each thread gathers one
//      live row into registers (dense_pred.cuh `RegRow`), tests TG topics
//      at a time with the branch-free `quick` test into a lane mask, and
//      one warp reduction says which of them any lane passed; only those
//      take the rest of the predicate and a ballot. (A topic at a time is
//      a chain of dependent shared loads and a vote, latency-bound; TG
//      independent tests keep the warp issuing.) A chunk's list splits in
//      PARTS so that a chunk holding all the live rows still fills the
//      card. A warp's hit ranks in its share of the segment by a per-warp
//      running count. The block records its hits (row, topic, warp, rank)
//      in shared memory, then writes its count for each (segment, part)
//      and, once the warp counts are summed in order, each hit with its
//      rank in the part.
//   3. part_scan, scan: segment offsets (segments: (chunk, topic) for K2,
//      (tile, topic, chunk) for K16, so each order is the order of its
//      segments; a segment's count is the sum of its parts), a block for
//      each tile of SEG_TILE segments, then the tiles' sums and the total.
//   4. dense_items<true>: each block places its recorded hits at segment
//      offset + its earlier parts + rank (a copy of a few thousand entries
//      in all) and fills the slots past each tile's count with -1. A block
//      whose hits overflowed its HCAP-entry record (a '#' row matches every
//      topic) walks its item again, writing each hit straight to its place
//      from the warp offsets it saved: only those blocks evaluate the
//      predicate twice. Exact in every case.
#include "scan.cuh"
#include "dense_pred.cuh"

namespace {

constexpr int LIST_THREADS = 256;
constexpr int LIST_PER = 16;  // consecutive rows a compaction thread reads
constexpr int LIST_ROWS = LIST_THREADS * LIST_PER;  // rows per compaction block
constexpr int MT = 512;            // threads of a match block
constexpr int MWARPS = MT / 32;
constexpr int TB = 128;            // topics of a match block
constexpr int HCAP = 1024;         // hits a match block records
constexpr int TG = 16;             // topics a warp tests at once
constexpr int PARTS = 4;           // parts of a chunk's live list, a block each
constexpr int SEG_TILE = SCAN_THREADS * 4;  // segments one part_scan block scans
static_assert(TB <= 256 && MWARPS <= 128, "hit keys pack the topic in 8 bits");
static_assert(TB % TG == 0, "topic groups tile TB");

struct DenseArgs {
  const int* words;         // [n_rows, L], n_rows = shards here * n_loc
  const int* plen;          // [n_rows]
  const uint8_t* has_hash;
  const uint8_t* root_wild;
  const uint8_t* active;
  int n_rows, n_loc, L, chunk, n_chunks;
  bool vec;                 // words 16-byte aligned and L % 4 == 0
  bool mask_vec;            // active 16-byte aligned
  const int* t_ids;         // [n_dp_here * b_loc, L]
  const int* t_len;
  const uint8_t* t_dollar;
  int b_loc, n_tt;          // topics a tile, topic tiles of TB
  const int* tiles;         // [n_tiles, 4]
  int n_tiles, n_items;     // items = tiles x chunks x PARTS x topic tiles
  int seg_tile, seg_t, seg_c;  // segment = tile*seg_tile + t*seg_t + c*seg_c
  int max_hits;
  int* out_ti;              // [n_tiles, max_hits]
  int* out_ri;
  int* out_cnt;             // [n_tiles] (K16) or null (K2)
  // scratch (see layout())
  int* range_cnt;           // [n_ranges] live rows per compaction block
  int* range_off;           // [n_ranges]
  int* list;                // [n_rows] live row ids, ascending
  int* chunk_off;           // [shards here * n_chunks + 1] list offset of each chunk
  int* part_cnt;            // [n_seg, PARTS] hits of each part of each segment
  int* seg_off;             // [n_seg] offset in its SEG_TILE tile of segments
  int* tile_sum;            // [n_stiles] hits of each tile of segments
  int* tile_pre;            // [n_stiles] hits of the tiles before it
  int* total;               // [1] all segments' hits
  int* item_hits;           // [n_items]
  int4* stage;              // [n_items, HCAP] (topic, rank in the part, ti, ri)
  int* wbase;               // [n_items, MWARPS, TB] warp offsets of overflowed items
};

long long align4(long long n) { return (n + 3) & ~3LL; }

// Carve the scratch; returns the ints it needs (ops/match.py
// `dense_geometry` computes the same total).
long long layout(DenseArgs& a, int* s, int n_ranges, int n_seg) {
  long long at = 0;
  auto take = [&](long long n) {
    int* p = s + at;
    at += align4(n);
    return p;
  };
  const int n_gchunks = (a.n_rows / a.n_loc) * a.n_chunks;
  a.range_cnt = take(n_ranges);
  a.range_off = take(n_ranges);
  a.list = take(a.n_rows);
  a.chunk_off = take(n_gchunks + 1);
  a.part_cnt = take(static_cast<long long>(n_seg) * PARTS);
  a.seg_off = take(n_seg);
  a.tile_sum = take(ceil_div(n_seg, SEG_TILE));
  a.tile_pre = take(ceil_div(n_seg, SEG_TILE));
  a.total = take(1);
  a.item_hits = take(a.n_items);
  a.stage = reinterpret_cast<int4*>(take(4LL * a.n_items * HCAP));
  a.wbase = take(static_cast<long long>(a.n_items) * MWARPS * TB);
  return at;
}

size_t smem_bytes(int L) {
  // s_th [TB] int2 + s_tw [TB*L] + s_base [TB] + s_wc [MWARPS*TB]
  // + s_hrow, s_hkey, s_hrank [HCAP]
  return sizeof(int) * (3 * TB + size_t(TB) * L + MWARPS * TB + 3 * HCAP);
}

// The LIST_PER rows from r0 a compaction thread owns: a bit each, set
// when the row is live.
__device__ __forceinline__ unsigned live_bits(const uint8_t* __restrict__ active, int n,
                                              int r0, bool vec) {
  unsigned bits = 0;
  if (vec && r0 + LIST_PER <= n) {
    const uint4 q = *reinterpret_cast<const uint4*>(active + r0);
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < LIST_PER; ++k)
      bits |= ((w[k >> 2] >> (8 * (k & 3))) & 0xffu ? 1u : 0u) << k;
  } else {
    for (int k = 0; k < LIST_PER && r0 + k < n; ++k) bits |= (active[r0 + k] ? 1u : 0u) << k;
  }
  return bits;
}

// Live rows per LIST_ROWS-row block of the mask.
__global__ void __launch_bounds__(LIST_THREADS)
live_count(const uint8_t* __restrict__ active, int n, bool vec, int* __restrict__ cnt) {
  const int r0 = blockIdx.x * LIST_ROWS + threadIdx.x * LIST_PER;
  int all;
  block_exclusive_scan(__popc(live_bits(active, n, r0, vec)), all);
  if (threadIdx.x == 0) cnt[blockIdx.x] = all;
}

// Each live row's id at its rank in the list; each chunk's first row
// (live or not) records the number of live rows before it.
__global__ void __launch_bounds__(LIST_THREADS)
live_write(const uint8_t* __restrict__ active, int n, bool vec,
           const int* __restrict__ off, int* __restrict__ list, int n_loc, int chunk,
           int n_chunks, int* __restrict__ chunk_off) {
  const int r0 = blockIdx.x * LIST_ROWS + threadIdx.x * LIST_PER;
  const unsigned bits = live_bits(active, n, r0, vec);
  int all;
  int rank = off[blockIdx.x] + block_exclusive_scan(__popc(bits), all);
  for (int k = 0; k < LIST_PER && r0 + k < n; ++k) {
    const int r = r0 + k;
    const int s = r / n_loc, lr = r - s * n_loc;
    if (lr % chunk == 0) chunk_off[s * n_chunks + lr / chunk] = rank;
    if ((bits >> k) & 1u) list[rank++] = r;
  }
}

// Segment offsets within tiles of SEG_TILE segments, a block a tile;
// each segment's count is the sum of its parts (one int4). The tile sums
// are scanned after (exclusive_scan_1block) and added at each lookup.
__global__ void __launch_bounds__(SCAN_THREADS)
part_scan(const int4* __restrict__ part_cnt, int* __restrict__ seg_off, int n_seg,
          int* __restrict__ tile_sum) {
  static_assert(PARTS == 4, "a segment's parts are one int4");
  const int i0 = blockIdx.x * SEG_TILE + threadIdx.x * 4;
  int v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = 0;
    if (i0 + k < n_seg) {
      const int4 x = part_cnt[i0 + k];
      v[k] = x.x + x.y + x.z + x.w;
    }
  }
  int sum;
  int run = block_exclusive_scan(v[0] + v[1] + v[2] + v[3], sum);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (i0 + k < n_seg) seg_off[i0 + k] = run;
    run += v[k];
  }
  if (threadIdx.x == 0) tile_sum[blockIdx.x] = sum;
}

// Hits of every segment before segment s.
__device__ __forceinline__ int seg_offset(const DenseArgs& a, int s) {
  return a.seg_off[s] + a.tile_pre[s / SEG_TILE];
}

// PLACE false: match one item, record its hits, write its segment
// counts. PLACE true: place the recorded hits (or walk again), fill -1.
template <bool PLACE>
__global__ void __launch_bounds__(MT, 2) dense_items(DenseArgs a) {
  extern __shared__ int4 smem4[];
  __shared__ int s_nh;
  const int L = a.L;
  int2* s_th = reinterpret_cast<int2*>(smem4);  // topic (header, level 0) [TB]
  int* s_tw = reinterpret_cast<int*>(s_th + TB);  // topic words [TB][L]
  int* s_base = s_tw + TB * L;         // where each topic's hits of this part start [TB]
  int* s_wc = s_base + TB;             // per-warp running counts [MWARPS][TB]
  int* s_hrow = s_wc + MWARPS * TB;    // recorded hits: row [HCAP]
  int* s_hkey = s_hrow + HCAP;         //   topic | warp << 8
  int* s_hrank = s_hkey + HCAP;        //   rank in the warp's share of the segment

  const int item = blockIdx.x;  // (tile, chunk, part, topic tile)
  const int tt = item % a.n_tt;
  const int part = item / a.n_tt % PARTS;
  const int c = item / (a.n_tt * PARTS) % a.n_chunks;
  const int tile = item / (a.n_tt * PARTS * a.n_chunks);
  const Tile tl_ = load_tile(a.tiles, tile);
  const int t0 = tt * TB;
  const int nt = min(TB, a.b_loc - t0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int seg0 = tile * a.seg_tile + t0 * a.seg_t + c * a.seg_c;
  const int gc = tl_.sub_pos * a.n_chunks + c;
  // this part of the chunk's live list
  const int c_lo = a.chunk_off[gc], c_hi = a.chunk_off[gc + 1];
  const int p_len = ((c_hi - c_lo + PARTS - 1) / PARTS + 31) / 32 * 32;
  const int lo = min(c_hi, c_lo + part * p_len), hi = min(c_hi, lo + p_len);
  const long long r_base = static_cast<long long>(tl_.sub_pos) * a.n_loc;
  const int ti_base = t0 + tl_.dp_i * a.b_loc;
  const long long ri_base = static_cast<long long>(tl_.sub_i) * a.n_loc - r_base;
  int* oti = a.out_ti + static_cast<size_t>(tile) * a.max_hits;
  int* ori = a.out_ri + static_cast<size_t>(tile) * a.max_hits;
  int base_off = 0;

  if (PLACE) {
    base_off = seg_offset(a, tile * a.seg_tile);
    const int hi_off = tile + 1 < a.n_tiles ? seg_offset(a, (tile + 1) * a.seg_tile) : *a.total;
    const int cnt = hi_off - base_off;
    const int per_tile = a.n_chunks * PARTS * a.n_tt;
    const int j = item - tile * per_tile;
    for (int p = min(cnt, a.max_hits) + j * MT + tid; p < a.max_hits; p += per_tile * MT) {
      oti[p] = -1;
      ori[p] = -1;
    }
    if (j == 0 && tid == 0 && a.out_cnt != nullptr) a.out_cnt[tile] = cnt;
    if (seg_offset(a, seg0) - base_off >= a.max_hits) return;  // every hit lands past max_hits
    const int h = a.item_hits[item];
    if (h == 0) return;
    // a topic's hits of this part follow its segment's earlier parts
    for (int t = tid; t < nt; t += MT) {
      const int seg = seg0 + t * a.seg_t;
      int b = seg_offset(a, seg) - base_off;
      for (int q = 0; q < part; ++q) b += a.part_cnt[seg * PARTS + q];
      s_base[t] = b;
    }
    __syncthreads();
    if (h <= HCAP) {
      for (int i = tid; i < h; i += MT) {
        const int4 e = a.stage[static_cast<size_t>(item) * HCAP + i];
        const int dst = s_base[e.x] + e.y;
        if (dst < a.max_hits) {
          oti[dst] = e.z;
          ori[dst] = e.w;
        }
      }
      return;
    }
    // overflowed (so lo < hi): walk again below, writing each hit
  } else if (lo == hi) {
    for (int t = tid; t < nt; t += MT) a.part_cnt[(seg0 + t * a.seg_t) * PARTS + part] = 0;
    if (tid == 0) a.item_hits[item] = 0;
    return;
  }

  const long long t_base = static_cast<long long>(tl_.dp_pos) * a.b_loc + t0;
  for (int e = tid; e < nt * L; e += MT) s_tw[e] = a.t_ids[t_base * L + e];
  // topics past nt get the header -1, which no row's window admits
  for (int t = tid; t < TB; t += MT)
    s_th[t] = t < nt ? make_int2(topic_header(a.t_len[t_base + t], a.t_dollar[t_base + t]),
                                 a.t_ids[(t_base + t) * L])
                     : make_int2(-1, 0);
  for (int e = tid; e < MWARPS * TB; e += MT)
    s_wc[e] = PLACE ? a.wbase[static_cast<size_t>(item) * MWARPS * TB + e] : 0;
  if (tid == 0) s_nh = 0;
  __syncthreads();

  // this warp's share of the chunk's live list, in list order
  const int span = ((hi - lo + 31) / 32 + MWARPS - 1) / MWARPS * 32;
  const int w_lo = lo + warp * span;
  const int w_hi = min(hi, w_lo + span);
  int* wc = s_wc + warp * TB;
  const unsigned below = (1u << lane) - 1u;
  // a warp's hits on topic t (mask m): rank in the warp's share of the
  // segment; recorded (count pass) or written to their place (walk again)
  auto on_hits = [&](int t, int r, bool ok, unsigned m) {
    const int prior = wc[t];
    __syncwarp();
    if (lane == 0) wc[t] = prior + __popc(m);
    __syncwarp();
    const int rank = prior + __popc(m & below);
    if (PLACE) {
      const int dst = s_base[t] + rank;
      if (ok && dst < a.max_hits) {
        oti[dst] = ti_base + t;
        ori[dst] = static_cast<int>(r + ri_base);
      }
      return;
    }
    int at = 0;
    if (lane == 0) at = atomicAdd(&s_nh, __popc(m));
    at = __shfl_sync(EMQX_FULL_MASK, at, 0) + __popc(m & below);
    if (ok && at < HCAP) {
      s_hrow[at] = r;
      s_hkey[at] = t | (warp << 8);
      s_hrank[at] = rank;
    }
  };
  for (int p0 = w_lo; p0 < w_hi; p0 += 32) {
    const int p = p0 + lane;
    const bool live = p < w_hi;
    const int r = live ? a.list[p] : 0;
    RegRow row;
    if (live) {
      load_reg_row(row, a.words, a.plen, a.has_hash, a.root_wild, r, L, a.vec);
    } else {
      row.win = RowWindow{0x7fffffff, 0u, 0};  // admits no topic
      row.w0 = -1;
    }
    for (int g = 0; g < nt; g += TG) {
      // TG topics' quick tests, independent of each other, into a lane
      // mask; one warp reduction says which topics any lane passed --
      // almost never one, so a group costs little more than the tests
      unsigned q = 0;
#pragma unroll
      for (int k = 0; k < TG; ++k) {
        const int2 th = s_th[g + k];
        q |= static_cast<unsigned>(quick(th.x, th.y, row)) << k;
      }
      unsigned through = __reduce_or_sync(EMQX_FULL_MASK, q);
      while (through != 0u) {  // warp-uniform
        const int k = __ffs(through) - 1;
        through &= through - 1;
        const int t = g + k;
        const bool ok = (q >> k & 1u) && rest(s_tw + t * L, row);
        const unsigned m = __ballot_sync(EMQX_FULL_MASK, ok);
        if (m != 0u) on_hits(t, r, ok, m);
      }
    }
  }
  if (PLACE) return;

  // the segment counts, and each warp's offset in each segment
  __syncthreads();
  for (int t = tid; t < nt; t += MT) {
    int run = 0;
    for (int w = 0; w < MWARPS; ++w) {
      const int v = s_wc[w * TB + t];
      s_wc[w * TB + t] = run;
      run += v;
    }
    a.part_cnt[(seg0 + t * a.seg_t) * PARTS + part] = run;
  }
  __syncthreads();
  const int h = s_nh;
  if (tid == 0) a.item_hits[item] = h;
  if (h <= HCAP) {
    for (int i = tid; i < h; i += MT) {
      const int key = s_hkey[i];
      const int t = key & 0xff, w = key >> 8;
      a.stage[static_cast<size_t>(item) * HCAP + i] =
          make_int4(t, s_wc[w * TB + t] + s_hrank[i], ti_base + t,
                    static_cast<int>(s_hrow[i] + ri_base));
    }
  } else {
    for (int e = tid; e < MWARPS * TB; e += MT)
      a.wbase[static_cast<size_t>(item) * MWARPS * TB + e] = s_wc[e];
  }
}

// The whole sequence; returns cudaErrorInvalidValue when the scratch is
// short of what the layout needs.
int launch(DenseArgs a, int* scratch, long long scratch_len, int* total_out,
           cudaStream_t stream) {
  const int n_ranges = ceil_div(a.n_rows, LIST_ROWS);
  const int n_seg = a.n_tiles * a.b_loc * a.n_chunks;
  a.n_tt = ceil_div(a.b_loc, TB);
  a.n_items = a.n_tiles * a.n_chunks * PARTS * a.n_tt;
  a.vec = reinterpret_cast<uintptr_t>(a.words) % 16 == 0 && a.L % 4 == 0;
  if (layout(a, scratch, n_ranges, n_seg) > scratch_len)
    return static_cast<int>(cudaErrorInvalidValue);
  if (total_out != nullptr) a.total = total_out;
  const int n_gchunks = (a.n_rows / a.n_loc) * a.n_chunks;

  a.mask_vec = reinterpret_cast<uintptr_t>(a.active) % 16 == 0;
  live_count<<<n_ranges, LIST_THREADS, 0, stream>>>(a.active, a.n_rows, a.mask_vec,
                                                     a.range_cnt);
  exclusive_scan_1block<<<1, SCAN_THREADS, 0, stream>>>(
      a.range_cnt, a.range_off, n_ranges, a.chunk_off + n_gchunks);
  live_write<<<n_ranges, LIST_THREADS, 0, stream>>>(a.active, a.n_rows, a.mask_vec,
                                                     a.range_off, a.list, a.n_loc,
                                                     a.chunk, a.n_chunks, a.chunk_off);
  const size_t smem = smem_bytes(a.L);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(dense_items<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    cudaFuncSetAttribute(dense_items<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  }
  dense_items<false><<<a.n_items, MT, smem, stream>>>(a);
  const int n_stiles = ceil_div(n_seg, SEG_TILE);
  part_scan<<<n_stiles, SCAN_THREADS, 0, stream>>>(reinterpret_cast<const int4*>(a.part_cnt),
                                                   a.seg_off, n_seg, a.tile_sum);
  exclusive_scan_1block<<<1, SCAN_THREADS, 0, stream>>>(a.tile_sum, a.tile_pre, n_stiles,
                                                        a.total);
  dense_items<true><<<a.n_items, MT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2. scratch holds scratch_len ints (ops/match.py `dense_geometry`).
// Outputs: ti, ri [max_hits] (-1 past the hit count), total (exact, may
// exceed max_hits). Returns cudaGetLastError() after the launches.
extern "C" int emqx_match_ids(const int* words, const int* plen,
                              const uint8_t* has_hash, const uint8_t* root_wild,
                              const uint8_t* active, int N, int L,
                              const int* t_ids, const int* t_len,
                              const uint8_t* t_dollar, int B, int chunk,
                              int max_hits, int* out_ti, int* out_ri,
                              int* out_total, int* scratch, long long scratch_len,
                              cudaStream_t stream) {
  DenseArgs a{};
  a.words = words, a.plen = plen, a.has_hash = has_hash, a.root_wild = root_wild;
  a.active = active, a.n_rows = N, a.n_loc = N, a.L = L, a.chunk = chunk;
  a.n_chunks = N / chunk;
  a.t_ids = t_ids, a.t_len = t_len, a.t_dollar = t_dollar, a.b_loc = B;
  a.tiles = nullptr, a.n_tiles = 1;
  a.seg_tile = 0, a.seg_t = 1, a.seg_c = B;
  a.max_hits = max_hits, a.out_ti = out_ti, a.out_ri = out_ri, a.out_cnt = nullptr;
  return launch(a, scratch, scratch_len, out_total, stream);
}

// K16. The n_tiles tiles of this device (tiles [n_tiles, 4]) over its
// shards' rows (n_rows = shards here * n_loc) and topic blocks (b_loc a
// block). scratch holds scratch_len ints (ops/match.py `dense_geometry`).
// Outputs: ti, ri [n_tiles, max_hits] (global ids, -1 past each tile's
// count), cnt [n_tiles] (exact, may exceed max_hits).
extern "C" int emqx_mesh_match_ids(const int* words, const int* plen,
                                   const uint8_t* has_hash,
                                   const uint8_t* root_wild,
                                   const uint8_t* active, int n_rows, int n_loc, int L,
                                   const int* t_ids, const int* t_len,
                                   const uint8_t* t_dollar, int b_loc, int chunk,
                                   const int* tiles, int n_tiles, int max_hits,
                                   int* out_ti, int* out_ri, int* out_cnt,
                                   int* scratch, long long scratch_len,
                                   cudaStream_t stream) {
  DenseArgs a{};
  a.words = words, a.plen = plen, a.has_hash = has_hash, a.root_wild = root_wild;
  a.active = active, a.n_rows = n_rows, a.n_loc = n_loc, a.L = L, a.chunk = chunk;
  a.n_chunks = ceil_div(n_loc, chunk);
  a.t_ids = t_ids, a.t_len = t_len, a.t_dollar = t_dollar, a.b_loc = b_loc;
  a.tiles = tiles, a.n_tiles = n_tiles;
  a.seg_tile = b_loc * a.n_chunks, a.seg_t = a.n_chunks, a.seg_c = 1;
  a.max_hits = max_hits, a.out_ti = out_ti, a.out_ri = out_ri, a.out_cnt = out_cnt;
  return launch(a, scratch, scratch_len, nullptr, stream);
}
