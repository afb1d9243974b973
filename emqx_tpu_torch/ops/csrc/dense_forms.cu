// K9 and K11: the dense match in two of its uncompacted forms, and
// K13's counts, which are K11 per (dp, sub) tile. (K10 and K13's packed
// form, the bitmap, are packed_match.cu.)
//
// Replace emqx_tpu/ops/match.py `match_dense` (K9: bool [B, N]) and
// `match_counts` (K11: int32 [B] matches per topic), and the
// `match_counts` of emqx_tpu/parallel/sharded_match.py
// `make_sharded_kernels` (K13): the same function with rows split over
// the mesh's sub axis and topics over its dp axis -- counts add over
// sub.
//
// The predicate is dense_pred.cuh's, shared with K2, K16 and K10.
//
// What bounds it on the H100: the operations. Every (topic, row) pair is
// evaluated (no compaction, no early exit across rows): B*N predicate
// evaluations of a few integer operations each, against reading the
// table once (N * (4L + 7) bytes) and writing B*N bytes (K9) or 4B
// (K11).
//
// Design: a block owns RT rows of one tile, stages each warp's 32 rows
// in shared memory once (transposed, at a padded stride: see
// dense_pred.cuh), and walks every topic of the tile's block TB at
// a time (topics staged in shared memory, read from L2 by each block).
// Per topic, K11 adds the popcount of the warp's ballot of its 32
// verdicts to a per-topic shared count that one atomic per (block,
// topic) adds to the output -- the only cross-block step, a reduction --
// and K9 writes each thread's verdict as a byte, 256 consecutive bytes
// per topic and block.
#include "scan.cuh"
#include "dense_pred.cuh"

namespace {

constexpr int RT = 256;  // rows per block: one per thread
constexpr int TB = 32;   // topics staged at a time
constexpr int WARPS = RT / 32;

enum Mode { DENSE = 0, COUNTS = 2 };  // mode 1, the bitmap, is packed_match.cu

struct FormsArgs {
  const int* words;         // [n_sub_here * n_loc, L]
  const int* plen;
  const uint8_t* has_hash;
  const uint8_t* root_wild;
  const uint8_t* active;
  int n_loc, L;
  const int* t_ids;         // [n_dp_here * b_loc, L]
  const int* t_len;
  const uint8_t* t_dollar;
  int b_loc;
  const int* tiles;         // [n_tiles, 4] or null for one tile
  void* out;
  long long out_w;          // row width of K9's [B, N] output
};

size_t smem_bytes(int L) {
  // s_tw [TB*L] + s_rw [WARPS*L*STAGE_STRIDE] + s_tl, s_td, s_cnt [TB each]
  return sizeof(int) * (size_t(TB) * L + size_t(WARPS) * L * STAGE_STRIDE + 3 * TB);
}

template <int MODE>
__global__ void __launch_bounds__(RT) forms_pass(FormsArgs a) {
  extern __shared__ int smem[];
  const int L = a.L;
  int* s_tw = smem;
  int* s_rw = s_tw + TB * L;
  int* s_tl = s_rw + WARPS * L * STAGE_STRIDE;
  int* s_td = s_tl + TB;
  int* s_cnt = s_td + TB;

  const Tile tl_ = load_tile(a.tiles, blockIdx.y);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int base = blockIdx.x * RT;
  const int row = base + tid;  // local row id
  const long long r_base = static_cast<long long>(tl_.sub_pos) * a.n_loc;
  const bool act = row < a.n_loc && a.active[r_base + row];
  const unsigned am = __ballot_sync(EMQX_FULL_MASK, act);
  int* my_rw = s_rw + warp * L * STAGE_STRIDE;
  int pl = 0;
  bool hh = false, rw = false;
  if (am) {
    stage_warp_rows(my_rw, a.words, r_base + base + warp * 32, r_base + a.n_loc, L,
                    lane);
    if (act) {
      pl = a.plen[r_base + row];
      hh = a.has_hash[r_base + row];
      rw = a.root_wild[r_base + row];
    }
  }
  const long long g_row = static_cast<long long>(tl_.sub_i) * a.n_loc + row;
  const long long t_src = static_cast<long long>(tl_.dp_pos) * a.b_loc;
  const long long t_dst = static_cast<long long>(tl_.dp_i) * a.b_loc;
  for (int t0 = 0; t0 < a.b_loc; t0 += TB) {
    const int nt = min(TB, a.b_loc - t0);
    __syncthreads();  // the previous topic tile is done with s_tw, s_cnt
    for (int e = tid; e < nt * L; e += RT) s_tw[e] = a.t_ids[(t_src + t0) * L + e];
    if (tid < nt) {
      s_tl[tid] = a.t_len[t_src + t0 + tid];
      s_td[tid] = a.t_dollar[t_src + t0 + tid];
      s_cnt[tid] = 0;
    }
    __syncthreads();
    for (int t = 0; t < nt; ++t) {
      const bool ok = act && dense_pred(s_tl[t], s_td[t], s_tw + t * L, pl, hh, rw,
                                        my_rw + lane, L);
      const long long out_row = (t_dst + t0 + t) * a.out_w;
      if (MODE == DENSE) {
        if (row < a.n_loc) static_cast<uint8_t*>(a.out)[out_row + g_row] = ok;
      } else {
        const unsigned m = __ballot_sync(EMQX_FULL_MASK, ok);
        if (lane == 0 && m) atomicAdd(&s_cnt[t], __popc(m));
      }
    }
    if (MODE == COUNTS) {
      __syncthreads();
      if (tid < nt && s_cnt[tid])
        atomicAdd(static_cast<int*>(a.out) + t_dst + t0 + tid, s_cnt[tid]);
    }
  }
}

template <int MODE>
void launch(const FormsArgs& a, int n_tiles, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.L);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(forms_pass<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         int(smem));
  const dim3 grid(ceil_div(a.n_loc, RT), n_tiles);
  forms_pass<MODE><<<grid, RT, smem, stream>>>(a);
}

}  // namespace

// mode 0 (K9): out is bool [B, out_w = N]; mode 2 (K11): int32 [B],
// zeroed here first (out_len ints) and added to by every tile. The
// n_tiles tiles of this device (tiles [n_tiles, 4], or null for the one
// tile (0, 0, 0, 0)) each cover n_loc rows and b_loc topics. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for another mode.
extern "C" int emqx_dense_forms(int mode, const int* words, const int* plen,
                                const uint8_t* has_hash, const uint8_t* root_wild,
                                const uint8_t* active, int n_loc, int L,
                                const int* t_ids, const int* t_len,
                                const uint8_t* t_dollar, int b_loc,
                                const int* tiles, int n_tiles, void* out,
                                long long out_w, long long out_len,
                                cudaStream_t stream) {
  FormsArgs a{words, plen, has_hash, root_wild, active, n_loc, L,
              t_ids, t_len, t_dollar, b_loc, tiles, out, out_w};
  if (mode == DENSE) {
    launch<DENSE>(a, n_tiles, stream);
  } else if (mode != COUNTS) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    cudaMemsetAsync(out, 0, sizeof(int) * out_len, stream);
    launch<COUNTS>(a, n_tiles, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
