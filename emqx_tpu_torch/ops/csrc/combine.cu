// K14: the cross-shard combine of a mesh match, and K15's salted buffers.
//
// K14 replaces emqx_tpu/parallel/sharded_match.py `_combine_pairs` with
// the `psum` of the counts beside it: for each dp block, the n_sub
// shards' compacted [mh] buffers, gathered side by side over the sub
// axis ([n_sub * mh], sub-major), are recompacted in order -- every
// valid entry (a >= 0) of sub 0 in its buffer order, then sub 1, and so
// on -- into one [mh] pair of buffers, truncated to mh, -1 past the
// count: `jnp.nonzero(a_all >= 0, size=mh, fill_value=-1)` over the
// gathered vector. The block's total is the sum of its shards' exact
// counts. When that total fits mh, every shard's count fitted too, so no
// shard dropped an entry upstream.
//
// K15 replaces the buffer build of `make_combine_probe_kernel` (the mesh
// microscope's combine-only probe): each shard's buffers hold one entry
// at position 0 -- a = salt + sub_i + 1, b = salt * 2 + 1 (int32,
// wrapping) -- and -1 elsewhere, and its count is 1 when a >= 0; K14
// then combines them.
//
// What bounds it on the H100: nothing the card notices -- n_sub * mh
// ints read and mh written per dp block (a few hundred KB at most), so
// the three launches dominate.
//
// Design: one thread per gathered entry; the count pass counts valid
// entries per block, the one-block scan (scan.cuh) gives offsets, the
// write pass ranks each valid entry inside its block by warp ballots and
// writes it at its dp block's offset plus rank when that is below mh.
#include "scan.cuh"
#include "dense_pred.cuh"  // Tile, load_tile

namespace {

constexpr int CT = 256;
constexpr int WARPS = CT / 32;

template <bool WRITE>
__global__ void __launch_bounds__(CT)
combine_pass(const int* __restrict__ a_all, const int* __restrict__ b_all, int width,
             int n_blk, int* __restrict__ counts, const int* __restrict__ offs, int mh,
             int* __restrict__ out_a, int* __restrict__ out_b) {
  __shared__ int s_wc[WARPS];
  const int j = blockIdx.y;  // dp block
  const int blk = j * n_blk + blockIdx.x;
  const int base_off = WRITE ? offs[j * n_blk] : 0;
  if (WRITE && offs[blk] - base_off >= mh) return;  // block-uniform
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = blockIdx.x * CT + tid;
  const size_t src = static_cast<size_t>(j) * width + i;
  const bool v = i < width && a_all[src] >= 0;
  const unsigned m = __ballot_sync(EMQX_FULL_MASK, v);
  if (lane == 0) s_wc[warp] = __popc(m);
  __syncthreads();
  if (!WRITE) {
    if (tid == 0) {
      int s = 0;
      for (int w = 0; w < WARPS; ++w) s += s_wc[w];
      counts[blk] = s;
    }
    return;
  }
  if (!v) return;
  int dst = offs[blk] - base_off + __popc(m & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) dst += s_wc[w];
  if (dst < mh) {
    out_a[static_cast<size_t>(j) * mh + dst] = a_all[src];
    out_b[static_cast<size_t>(j) * mh + dst] = b_all[src];
  }
}

// outputs to -1, and each dp block's total: the sum of its shards' counts
__global__ void combine_fill(int* __restrict__ out_a, int* __restrict__ out_b, int n,
                             const int* __restrict__ cnt, int n_sub, int n_dp,
                             int* __restrict__ out_tot) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    out_a[i] = -1;
    out_b[i] = -1;
  }
  if (i < n_dp) {
    int s = 0;
    for (int k = 0; k < n_sub; ++k) s += cnt[i * n_sub + k];
    out_tot[i] = s;
  }
}

__global__ void probe_build(int salt, const int* __restrict__ tiles, int mh,
                            int* __restrict__ a, int* __restrict__ b,
                            int* __restrict__ cnt) {
  const int k = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mh) return;
  const Tile tl = load_tile(tiles, k);
  const int va = static_cast<int>(static_cast<uint32_t>(salt) +
                                  static_cast<uint32_t>(tl.sub_i) + 1u);
  const int vb = static_cast<int>(static_cast<uint32_t>(salt) * 2u + 1u);
  a[static_cast<size_t>(k) * mh + i] = i == 0 ? va : -1;
  b[static_cast<size_t>(k) * mh + i] = i == 0 ? vb : -1;
  if (i == 0) cnt[k] = va >= 0 ? 1 : 0;
}

}  // namespace

// K14 over the n_dp dp blocks gathered on this device: a_all, b_all
// [n_dp, n_sub * mh], cnt [n_dp, n_sub] (the shards' exact counts).
// scratch holds 2 * n_dp * ceil(n_sub * mh / 256) + 1 ints. Outputs:
// out_a, out_b [n_dp, mh], out_tot [n_dp]. Returns cudaGetLastError().
extern "C" int emqx_combine_pairs(const int* a_all, const int* b_all, const int* cnt,
                                  int n_dp, int n_sub, int mh, int* out_a, int* out_b,
                                  int* out_tot, int* scratch, cudaStream_t stream) {
  const int width = n_sub * mh;
  const int n_blk = ceil_div(width, CT);
  const int nseg = n_dp * n_blk;
  const dim3 grid(n_blk, n_dp);
  combine_pass<false><<<grid, CT, 0, stream>>>(a_all, b_all, width, n_blk, scratch,
                                               nullptr, mh, out_a, out_b);
  exclusive_scan_1block<<<1, SCAN_THREADS, 0, stream>>>(scratch, scratch + nseg, nseg,
                                                        scratch + 2 * nseg);
  combine_fill<<<max(1, ceil_div(static_cast<long long>(n_dp) * mh, 256)), 256, 0,
                 stream>>>(out_a, out_b, n_dp * mh, cnt, n_sub, n_dp, out_tot);
  combine_pass<true><<<grid, CT, 0, stream>>>(a_all, b_all, width, n_blk, nullptr,
                                              scratch + nseg, mh, out_a, out_b);
  return static_cast<int>(cudaGetLastError());
}

// K15's buffers for the n_tiles tiles of this device (tiles [n_tiles,
// 4]): a, b [n_tiles, mh], cnt [n_tiles]. Returns cudaGetLastError().
extern "C" int emqx_combine_probe(int salt, const int* tiles, int n_tiles, int mh,
                                  int* a, int* b, int* cnt, cudaStream_t stream) {
  probe_build<<<dim3(ceil_div(mh, 256), n_tiles), 256, 0, stream>>>(salt, tiles, mh, a,
                                                                    b, cnt);
  return static_cast<int>(cudaGetLastError());
}
