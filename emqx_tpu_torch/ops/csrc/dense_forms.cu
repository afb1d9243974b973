// K9: the dense match in its uncompacted form, the bool [B, N] matrix.
// (K10 and K13's packed form, the bitmap, and K11 and K13's counts are
// packed_match.cu.)
//
// Replaces emqx_tpu/ops/match.py `match_dense` (K9: bool [B, N]). The
// predicate is dense_pred.cuh's, shared with K2, K16, K10 and K11.
//
// What bounds it on the H100: the bytes at the widths it is called at.
// Every (topic, row) pair is evaluated (no compaction, no early exit
// across rows) and written: B*N predicate evaluations of a few integer
// operations each, against reading the table once (N * (4L + 7) bytes)
// and writing B*N bytes.
//
// Design: a block owns RT rows, stages each warp's 32 rows in shared
// memory once (transposed, at a padded stride: see dense_pred.cuh), and
// walks every topic TB at a time (topics staged in shared memory, read
// from L2 by each block), writing each thread's verdict as a byte, 256
// consecutive bytes per topic and block.
#include "scan.cuh"
#include "dense_pred.cuh"

namespace {

constexpr int RT = 256;  // rows per block: one per thread
constexpr int TB = 32;   // topics staged at a time
constexpr int WARPS = RT / 32;

enum Mode { DENSE = 0 };  // modes 1 and 2, the bitmap and the counts, are packed_match.cu

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
  uint8_t* out;             // [B, out_w]
  long long out_w;          // row width of the output
};

size_t smem_bytes(int L) {
  // s_tw [TB*L] + s_rw [WARPS*L*STAGE_STRIDE] + s_tl, s_td [TB each]
  return sizeof(int) * (size_t(TB) * L + size_t(WARPS) * L * STAGE_STRIDE + 2 * TB);
}

__global__ void __launch_bounds__(RT) forms_pass(FormsArgs a) {
  extern __shared__ int smem[];
  const int L = a.L;
  int* s_tw = smem;
  int* s_rw = s_tw + TB * L;
  int* s_tl = s_rw + WARPS * L * STAGE_STRIDE;
  int* s_td = s_tl + TB;

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
    __syncthreads();  // the previous topic tile is done with s_tw
    for (int e = tid; e < nt * L; e += RT) s_tw[e] = a.t_ids[(t_src + t0) * L + e];
    if (tid < nt) {
      s_tl[tid] = a.t_len[t_src + t0 + tid];
      s_td[tid] = a.t_dollar[t_src + t0 + tid];
    }
    __syncthreads();
    for (int t = 0; t < nt; ++t) {
      const bool ok = act && dense_pred(s_tl[t], s_td[t], s_tw + t * L, pl, hh, rw,
                                        my_rw + lane, L);
      if (row < a.n_loc) a.out[(t_dst + t0 + t) * a.out_w + g_row] = ok;
    }
  }
}

}  // namespace

// mode 0 (K9): out is bool [B, out_w = N]. The n_tiles tiles of this
// device (tiles [n_tiles, 4], or null for the one tile (0, 0, 0, 0))
// each cover n_loc rows and b_loc topics. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for another mode.
extern "C" int emqx_dense_forms(int mode, const int* words, const int* plen,
                                const uint8_t* has_hash, const uint8_t* root_wild,
                                const uint8_t* active, int n_loc, int L,
                                const int* t_ids, const int* t_len,
                                const uint8_t* t_dollar, int b_loc,
                                const int* tiles, int n_tiles, uint8_t* out,
                                long long out_w, cudaStream_t stream) {
  if (mode != DENSE) return static_cast<int>(cudaErrorInvalidValue);
  FormsArgs a{words, plen, has_hash, root_wild, active, n_loc, L,
              t_ids, t_len, t_dollar, b_loc, tiles, out, out_w};
  const size_t smem = smem_bytes(L);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(forms_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  const dim3 grid(ceil_div(n_loc, RT), n_tiles);
  forms_pass<<<grid, RT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
