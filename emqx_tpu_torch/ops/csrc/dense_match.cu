// K2: dense batched wildcard match with order-preserving compaction.
//
// Replaces emqx_tpu/ops/match.py `match_ids` (with `_match_block`): the
// predicate
//
//   ok[b, n] = active[n] & ~(dollar[b] & root_wild[n])
//            & (has_hash[n] ? len[b] >= plen[n] : len[b] == plen[n])
//            & all_{i < plen[n]} (words[n, i] == PLUS | words[n, i] == ids[b, i])
//
// over every (topic, row) pair, compacted to the first max_hits pairs in
// (chunk, topic, row) order -- the order the lax.scan over
// chunk = min(65536, N) rows writes -- plus the exact total.
//
// What bounds it on the H100: in dense mode (no class index) it is the
// B*N*L compares, a few integer operations per pair; the table itself
// is read once per topic tile from L2. On the residual leg the active
// mask admits a few thousand of the 2M rows, so the work is reading the
// 2 MB active mask once per topic tile.
//
// Design: a block owns one chunk and a tile of TB topics (held in shared
// memory) and walks the chunk's rows RT at a time, one row per thread.
// A sub-tile whose rows are all inactive costs one block vote; a warp
// with no active row skips staging and the compares. The count pass
// counts matches per (chunk, topic) segment, a one-block scan turns the
// counts into segment offsets, and the write pass repeats the predicate
// and writes each match at its segment offset plus its rank, which it
// carries across sub-tiles in shared memory. Segments are ordered
// (chunk, topic), so a write-pass block whose first segment already
// starts past max_hits exits at once.
#include "scan.cuh"

namespace {

constexpr int RT = 256;  // rows per sub-tile: one per thread
constexpr int TB = 32;   // topics per block
constexpr int WARPS = RT / 32;
constexpr int PLUS = 1;  // vocab id of '+'

struct DenseArgs {
  const int* words;         // [N, L]
  const int* plen;          // [N]
  const uint8_t* has_hash;  // [N]
  const uint8_t* root_wild; // [N]
  const uint8_t* active;    // [N]
  int N, L, chunk;
  const int* t_ids;         // [B, L]
  const int* t_len;         // [B]
  const uint8_t* t_dollar;  // [B]
  int B;
  int* counts;              // [n_chunks * B]  count pass output
  const int* offs;          // [n_chunks * B]  write pass input
  int max_hits;
  int* out_ti;
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

  const int c = blockIdx.y;
  const int t0 = blockIdx.x * TB;
  const int nt = min(TB, a.B - t0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int seg0 = c * a.B + t0;

  if (WRITE && a.offs[seg0] >= a.max_hits) return;  // block-uniform

  for (int e = tid; e < nt * L; e += RT) s_tw[e] = a.t_ids[size_t(t0) * L + e];
  for (int t = tid; t < TB; t += RT) {
    s_tl[t] = t < nt ? a.t_len[t0 + t] : 0;
    s_td[t] = t < nt ? a.t_dollar[t0 + t] : 1;
    s_cnt[t] = 0;
  }
  __syncthreads();

  const int row_end = c * a.chunk + a.chunk;
  int* my_rw = s_rw + warp * L * 32;
  for (int base = c * a.chunk; base < row_end; base += RT) {
    const int row = base + tid;
    const bool act = row < row_end && a.active[row];
    if (!__syncthreads_or(act)) continue;  // no live row in this sub-tile
    const unsigned am = __ballot_sync(EMQX_FULL_MASK, act);
    int pl = 0;
    bool hh = false, rw = false;
    if (am) {
      // stage the warp's 32 consecutive rows (coalesced), transposed so
      // lane l reads its own row's level i at my_rw[i*32 + l]
      const int wrow0 = base + warp * 32;
      for (int e = lane; e < 32 * L; e += 32) {
        const int r = e / L, i = e - r * L;
        const int g = wrow0 + r;
        my_rw[i * 32 + r] = g < row_end ? a.words[size_t(g) * L + i] : 0;
      }
      __syncwarp();
      if (act) {
        pl = a.plen[row];
        hh = a.has_hash[row];
        rw = a.root_wild[row];
      }
    }
    const int lim = min(pl, L);
    for (int t = 0; t < nt; ++t) {
      bool ok = false;
      if (act) {
        const int tl = s_tl[t];
        ok = (hh ? tl >= pl : tl == pl) && !(s_td[t] && rw);
        const int* tw = s_tw + t * L;
        for (int i = 0; ok && i < lim; ++i) {
          const int w = my_rw[i * 32 + lane];
          ok = (w == PLUS) || (w == tw[i]);
        }
      }
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
        const int dst = a.offs[seg0 + t] + rank;
        if (dst < a.max_hits) {
          a.out_ti[dst] = t0 + t;
          a.out_ri[dst] = row;
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
  if (!WRITE && tid < nt) a.counts[seg0 + tid] = s_cnt[tid];
}

}  // namespace

// Returns cudaGetLastError() after the launches. scratch holds
// 2 * (N / chunk) * B ints. Outputs: ti, ri [max_hits] (-1 past the hit
// count), total (exact, may exceed max_hits).
extern "C" int emqx_match_ids(const int* words, const int* plen,
                              const uint8_t* has_hash, const uint8_t* root_wild,
                              const uint8_t* active, int N, int L,
                              const int* t_ids, const int* t_len,
                              const uint8_t* t_dollar, int B, int chunk,
                              int max_hits, int* out_ti, int* out_ri,
                              int* out_total, int* scratch,
                              cudaStream_t stream) {
  const int n_chunks = N / chunk;
  const int nseg = n_chunks * B;
  DenseArgs a{words, plen, has_hash, root_wild, active, N, L, chunk,
              t_ids, t_len, t_dollar, B, scratch, scratch + nseg,
              max_hits, out_ti, out_ri};
  const size_t smem = smem_bytes(L);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(dense_pass<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    cudaFuncSetAttribute(dense_pass<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  }
  const dim3 grid(ceil_div(B, TB), n_chunks);
  dense_pass<false><<<grid, RT, smem, stream>>>(a);
  exclusive_scan_1block<<<1, SCAN_THREADS, 0, stream>>>(scratch, scratch + nseg,
                                                        nseg, out_total);
  fill_results<<<max(1, ceil_div(max_hits, 256)), 256, 0, stream>>>(
      out_ti, out_ri, max_hits, nullptr);
  dense_pass<true><<<grid, RT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
