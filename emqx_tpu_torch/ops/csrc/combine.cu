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
// shard dropped an entry upstream. Valid entries may sit anywhere in a
// shard's buffer: nothing here assumes a compacted prefix.
//
// K15 replaces the buffer build of `make_combine_probe_kernel` (the mesh
// microscope's combine-only probe): each shard's buffers hold one entry
// at position 0 -- a = salt + sub_i + 1, b = salt * 2 + 1 (int32,
// wrapping) -- and -1 elsewhere, and its count is 1 when a >= 0; K14
// then combines them.
//
// What bounds it on the H100: nothing the card notices -- n_sub * mh
// ints of a and b read and mh of each written per dp block (a few
// hundred KB at most). The launch and the latency of the row's loads
// set the time.
//
// Design: one launch, one CTA of CT = 1,024 threads per dp block, no
// scratch. The CTA walks its gathered row in tiles of CT * 4 entries,
// each thread owning 4 consecutive ones (one 16-byte load of a and one
// of b where the row allows it), with the next tile's loads issued
// before the current one is ranked. Four ballots rank a thread's valid
// entries inside its warp; every warp scans the CTA's warp totals from
// shared memory itself (double-buffered, one barrier a tile), so an
// entry lands at carry + its rank while that is below mh. The walk
// stops once the carry reaches mh; the CTA then writes the -1 tail over
// [min(carry, mh), mh) and the block's total. The four launches before
// (count pass, one-block scan, fill, write pass) and their scratch are
// gone.
#include "scan.cuh"         // ceil_div, EMQX_FULL_MASK
#include "dense_pred.cuh"  // Tile, load_tile

namespace {

constexpr int CT = 1024;
constexpr int WARPS = CT / 32;
constexpr int PER = 4;  // consecutive entries a thread owns in a tile (a multiple of 4)
constexpr int TILE = CT * PER;

struct Quad {
  int a[PER];
  int b[PER];
};

// The PER entries of a row from position i (entries past width read as
// invalid). vec: the row allows 16-byte loads (width % 4 == 0 and both
// bases aligned), so each group of four entries is all in or all out.
__device__ __forceinline__ Quad load_quad(const int* __restrict__ a,
                                          const int* __restrict__ b, int i, int width,
                                          bool vec) {
  Quad q;
  if (vec) {
#pragma unroll
    for (int v = 0; v < PER; v += 4) {
      int4 x = make_int4(-1, -1, -1, -1), y = x;
      if (i + v < width) {
        x = __ldg(reinterpret_cast<const int4*>(a + i + v));
        y = __ldg(reinterpret_cast<const int4*>(b + i + v));
      }
      q.a[v] = x.x, q.a[v + 1] = x.y, q.a[v + 2] = x.z, q.a[v + 3] = x.w;
      q.b[v] = y.x, q.b[v + 1] = y.y, q.b[v + 2] = y.z, q.b[v + 3] = y.w;
    }
    return q;
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const bool in = i + k < width;
    q.a[k] = in ? __ldg(a + i + k) : -1;
    q.b[k] = in ? __ldg(b + i + k) : -1;
  }
  return q;
}

__global__ void __launch_bounds__(CT)
combine_k(const int* __restrict__ a_all, const int* __restrict__ b_all,
          const int* __restrict__ cnt, int n_sub, int mh, bool vec,
          int* __restrict__ out_a, int* __restrict__ out_b, int* __restrict__ out_tot) {
  __shared__ int s_wc[2][WARPS];
  const int j = blockIdx.x;  // dp block
  const int width = n_sub * mh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* a = a_all + static_cast<size_t>(j) * width;
  const int* b = b_all + static_cast<size_t>(j) * width;
  int* oa = out_a + static_cast<size_t>(j) * mh;
  int* ob = out_b + static_cast<size_t>(j) * mh;
  const unsigned lt = (1u << lane) - 1u;

  int carry = 0;
  Quad cur = load_quad(a, b, tid * PER, width, vec);
  for (int base = 0, t = 0; base < width && carry < mh; base += TILE, t ^= 1) {
    const Quad nxt = load_quad(a, b, base + TILE + tid * PER, width, vec);
    int before = 0, wc = 0;  // this lane's rank in its warp; the warp's count
    unsigned mine = 0;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const unsigned m = __ballot_sync(EMQX_FULL_MASK, cur.a[k] >= 0);
      before += __popc(m & lt);
      wc += __popc(m);
      mine |= ((m >> lane) & 1u) << k;
    }
    if (lane == 0) s_wc[t][warp] = wc;
    __syncthreads();
    // every warp scans the warp totals itself: no second barrier
    const int w_cnt = lane < WARPS ? s_wc[t][lane] : 0;
    int inc = w_cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(EMQX_FULL_MASK, inc, d);
      if (lane >= d) inc += y;
    }
    const int w_off = __shfl_sync(EMQX_FULL_MASK, inc - w_cnt, warp);
    const int tile_total = __shfl_sync(EMQX_FULL_MASK, inc, 31);
    int dst = carry + w_off + before;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if ((mine >> k) & 1u) {
        if (dst < mh) {
          oa[dst] = cur.a[k];
          ob[dst] = cur.b[k];
        }
        ++dst;
      }
    }
    carry += tile_total;
    cur = nxt;
  }
  for (int i = min(carry, mh) + tid; i < mh; i += CT) {
    oa[i] = -1;
    ob[i] = -1;
  }
  if (tid == 0) {
    int s = 0;
    for (int k = 0; k < n_sub; ++k) s += cnt[j * n_sub + k];
    out_tot[j] = s;
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
// Outputs: out_a, out_b [n_dp, mh], out_tot [n_dp]. One launch.
// Returns cudaGetLastError().
extern "C" int emqx_combine_pairs(const int* a_all, const int* b_all, const int* cnt,
                                  int n_dp, int n_sub, int mh, int* out_a, int* out_b,
                                  int* out_tot, cudaStream_t stream) {
  const bool vec = (n_sub * mh) % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(a_all) |
                     reinterpret_cast<uintptr_t>(b_all)) & 15u) == 0;
  if (n_dp > 0) {
    combine_k<<<n_dp, CT, 0, stream>>>(a_all, b_all, cnt, n_sub, mh, vec, out_a, out_b,
                                       out_tot);
  }
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
