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
// What bounds it on the H100: in dense mode (no class index) it is the
// B*N*L compares, a few integer operations per pair; the table itself
// is read once per topic tile from L2. On the residual leg the active
// mask admits a few thousand of the 2M rows, so the work is reading the
// 2 MB active mask once per topic tile.
//
// Design: a block owns one chunk of one tile's rows and TB of its topics
// (held in shared memory) and walks the chunk's rows RT at a time, one
// row per thread. A sub-tile whose rows are all inactive costs one block
// vote; a warp with no active row skips staging and the compares. The
// count pass counts matches per segment -- (chunk, topic) for K2,
// (tile, topic, chunk) for K16, so each order is the order of its
// segments -- a one-block scan turns the counts into segment offsets,
// and the write pass repeats the predicate and writes each match at its
// segment offset (less its tile's first offset) plus its rank, which it
// carries across sub-tiles in shared memory. A write-pass block whose
// first segment already starts past max_hits exits at once.
#include "scan.cuh"
#include "dense_pred.cuh"

namespace {

constexpr int RT = 256;  // rows per sub-tile: one per thread
constexpr int TB = 32;   // topics per block
constexpr int WARPS = RT / 32;

struct DenseArgs {
  const int* words;         // [n_sub_here * n_loc, L]
  const int* plen;          // [n_sub_here * n_loc]
  const uint8_t* has_hash;
  const uint8_t* root_wild;
  const uint8_t* active;
  int n_loc, L, chunk, n_chunks;
  const int* t_ids;         // [n_dp_here * b_loc, L]
  const int* t_len;
  const uint8_t* t_dollar;
  int b_loc;
  const int* tiles;         // [n_tiles, 4]
  int seg_tile, seg_t, seg_c;  // segment = tile*seg_tile + t*seg_t + c*seg_c
  int* counts;              // [n_seg]  count pass output
  const int* offs;          // [n_seg]  write pass input
  int max_hits;
  int* out_ti;              // [n_tiles, max_hits]
  int* out_ri;
};

size_t smem_bytes(int L) {
  // s_tw [TB*L] + s_rw [WARPS*L*32] + s_tl, s_td, s_cnt [TB each]
  // + s_mask [TB*WARPS]
  return sizeof(int) * (size_t(TB) * L + size_t(WARPS) * L * 32 + 3 * TB +
                        TB * WARPS);
}

template <bool WRITE>
__global__ void __launch_bounds__(RT) dense_pass(DenseArgs a) {
  extern __shared__ int smem[];
  const int L = a.L;
  int* s_tw = smem;                       // topic words [TB][L]
  int* s_rw = s_tw + TB * L;              // staged row words [WARPS][L][32]
  int* s_tl = s_rw + WARPS * L * 32;      // topic lengths [TB]
  int* s_td = s_tl + TB;                  // topic $-flags [TB]
  int* s_cnt = s_td + TB;                 // matches so far per topic [TB]
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_cnt + TB);  // [TB][WARPS]

  const int tile = blockIdx.y / a.n_chunks;  // grid.y walks (tile, chunk)
  const Tile tl_ = load_tile(a.tiles, tile);
  const int c = blockIdx.y - tile * a.n_chunks;
  const int t0 = blockIdx.x * TB;
  const int nt = min(TB, a.b_loc - t0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int seg0 = tile * a.seg_tile + t0 * a.seg_t + c * a.seg_c;
  const int base_off = WRITE ? a.offs[tile * a.seg_tile] : 0;

  if (WRITE && a.offs[seg0] - base_off >= a.max_hits) return;  // block-uniform

  const long long t_base = static_cast<long long>(tl_.dp_pos) * a.b_loc + t0;
  for (int e = tid; e < nt * L; e += RT) s_tw[e] = a.t_ids[t_base * L + e];
  for (int t = tid; t < TB; t += RT) {
    s_tl[t] = t < nt ? a.t_len[t_base + t] : 0;
    s_td[t] = t < nt ? a.t_dollar[t_base + t] : 1;
    s_cnt[t] = 0;
  }
  __syncthreads();

  // rows of this tile: [r_base, r_base + n_loc) of this device's arrays
  const long long r_base = static_cast<long long>(tl_.sub_pos) * a.n_loc;
  const int row_lo = c * a.chunk;
  const int row_hi = min(row_lo + a.chunk, a.n_loc);
  int* my_rw = s_rw + warp * L * 32;
  for (int base = row_lo; base < row_hi; base += RT) {
    const int row = base + tid;  // local row id
    const bool act = row < row_hi && a.active[r_base + row];
    if (!__syncthreads_or(act)) continue;  // no live row in this sub-tile
    const unsigned am = __ballot_sync(EMQX_FULL_MASK, act);
    int pl = 0;
    bool hh = false, rw = false;
    if (am) {
      stage_warp_rows(my_rw, a.words, r_base + base + warp * 32, r_base + row_hi,
                      L, lane);
      if (act) {
        pl = a.plen[r_base + row];
        hh = a.has_hash[r_base + row];
        rw = a.root_wild[r_base + row];
      }
    }
    for (int t = 0; t < nt; ++t) {
      const bool ok = act && dense_pred(s_tl[t], s_td[t], s_tw + t * L, pl, hh, rw,
                                        my_rw + lane, L);
      const unsigned m = am ? __ballot_sync(EMQX_FULL_MASK, ok) : 0u;
      if (lane == 0) s_mask[t * WARPS + warp] = m;
    }
    __syncthreads();
    if (WRITE) {
      const unsigned below = (1u << lane) - 1u;
      for (int t = 0; t < nt; ++t) {
        const unsigned m = s_mask[t * WARPS + warp];
        if (!((m >> lane) & 1u)) continue;
        int rank = s_cnt[t] + __popc(m & below);
        for (int w = 0; w < warp; ++w) rank += __popc(s_mask[t * WARPS + w]);
        const int dst = a.offs[seg0 + t * a.seg_t] - base_off + rank;
        if (dst < a.max_hits) {
          const size_t o = static_cast<size_t>(tile) * a.max_hits + dst;
          a.out_ti[o] = t0 + t + tl_.dp_i * a.b_loc;
          a.out_ri[o] = row + tl_.sub_i * a.n_loc;
        }
      }
      __syncthreads();
    }
    if (tid < nt) {
      int s = 0;
      for (int w = 0; w < WARPS; ++w) s += __popc(s_mask[tid * WARPS + w]);
      s_cnt[tid] += s;
    }
    __syncthreads();
  }
  if (!WRITE && tid < nt) a.counts[seg0 + tid * a.seg_t] = s_cnt[tid];
}

void launch(const DenseArgs& base, int n_tiles, int nseg, int* scratch, int* out_total,
            cudaStream_t stream) {
  DenseArgs a = base;
  a.counts = scratch;
  a.offs = scratch + nseg;
  const size_t smem = smem_bytes(a.L);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(dense_pass<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    cudaFuncSetAttribute(dense_pass<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  }
  const dim3 grid(ceil_div(a.b_loc, TB), a.n_chunks * n_tiles);
  dense_pass<false><<<grid, RT, smem, stream>>>(a);
  exclusive_scan_1block<<<1, SCAN_THREADS, 0, stream>>>(scratch, scratch + nseg,
                                                        nseg, out_total);
  fill_results<<<max(1, ceil_div(static_cast<long long>(a.max_hits) * n_tiles, 256)),
                 256, 0, stream>>>(a.out_ti, a.out_ri, a.max_hits * n_tiles, nullptr);
  dense_pass<true><<<grid, RT, smem, stream>>>(a);
}

}  // namespace

// K2. Returns cudaGetLastError() after the launches. scratch holds
// 2 * (N / chunk) * B ints. Outputs: ti, ri [max_hits] (-1 past the hit count), total
// (exact, may exceed max_hits).
extern "C" int emqx_match_ids(const int* words, const int* plen,
                              const uint8_t* has_hash, const uint8_t* root_wild,
                              const uint8_t* active, int N, int L,
                              const int* t_ids, const int* t_len,
                              const uint8_t* t_dollar, int B, int chunk,
                              int max_hits, int* out_ti, int* out_ri,
                              int* out_total, int* scratch,
                              cudaStream_t stream) {
  const int n_chunks = N / chunk;
  DenseArgs a{words, plen, has_hash, root_wild, active, N, L, chunk, n_chunks,
              t_ids, t_len, t_dollar, B, nullptr, 0, 1, B,
              nullptr, nullptr, max_hits, out_ti, out_ri};
  launch(a, 1, n_chunks * B, scratch, out_total, stream);
  return static_cast<int>(cudaGetLastError());
}

// K16. The n_tiles tiles of this device (tiles [n_tiles, 4]) over its
// shards' rows (n_loc a shard) and topic blocks (b_loc a block).
// scratch holds 2 * n_tiles * b_loc * ceil(n_loc / chunk) + 1 ints.
// Outputs: ti, ri [n_tiles, max_hits] (global ids, -1 past each tile's
// count), cnt [n_tiles] (exact, may exceed max_hits).
extern "C" int emqx_mesh_match_ids(const int* words, const int* plen,
                                   const uint8_t* has_hash,
                                   const uint8_t* root_wild,
                                   const uint8_t* active, int n_loc, int L,
                                   const int* t_ids, const int* t_len,
                                   const uint8_t* t_dollar, int b_loc, int chunk,
                                   const int* tiles, int n_tiles, int max_hits,
                                   int* out_ti, int* out_ri, int* out_cnt,
                                   int* scratch, cudaStream_t stream) {
  const int n_chunks = ceil_div(n_loc, chunk);
  const int seg_tile = b_loc * n_chunks;
  const int nseg = n_tiles * seg_tile;
  DenseArgs a{words, plen, has_hash, root_wild, active, n_loc, L, chunk, n_chunks,
              t_ids, t_len, t_dollar, b_loc, tiles, seg_tile, n_chunks, 1,
              nullptr, nullptr, max_hits, out_ti, out_ri};
  int* total = scratch + 2 * nseg;
  launch(a, n_tiles, nseg, scratch, total, stream);
  tile_totals<<<ceil_div(n_tiles, 256), 256, 0, stream>>>(scratch + nseg, total,
                                                          seg_tile, n_tiles, out_cnt);
  return static_cast<int>(cudaGetLastError());
}
