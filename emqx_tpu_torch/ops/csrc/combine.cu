// K14: the cross-shard combine of a mesh match, and K15, its probe.
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
// K15 replaces `make_combine_probe_kernel` (the mesh microscope's
// combine-only probe): each shard's buffers hold one entry at position
// 0 -- a = salt + sub_i + 1, b = salt * 2 + 1 (int32, wrapping) -- and
// -1 elsewhere, and its count is 1 when a >= 0; K14's walk then combines
// them. The probe exists so that its time is the real combine's, so it
// writes the buffers out in full and walks them from memory, with K14's
// own code (`combine_row`): a kernel that wrote the known answer would
// measure nothing.
//
// What bounds them on the H100: nothing the card notices -- n_sub * mh
// ints of a and b read and mh of each written per dp block (a few
// hundred KB at most). The launch and the latency of the row's loads
// set the time.
//
// Design of K14: one launch, one CTA of CT = 1,024 threads per dp block,
// no scratch. The CTA walks its gathered row in tiles of CT * 4 entries,
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
//
// Design of K15: one launch where one device holds every tile of a dp
// block (every layout on one card: the gathered row is then a view of
// the tiles' buffers). One CTA a dp block writes its n_sub salted
// buffers and counts straight into the gathered row, then, after a
// barrier, runs K14's walk over that row. The walk reads what the same
// kernel wrote, which the read-only path (`__ldg`) may not see, so the
// probe's loads go through L2 (`__ldcg`). A mesh over several devices
// launches the same kernel to build each device's tiles (a CTA a tile,
// no walk), then gathers them and launches K14. Before, K15 was always
// a build launch and a K14 launch.
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

// One load: through the read-only path, or (COHERENT: data this kernel
// wrote) through L2.
template <bool COHERENT, typename T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (COHERENT) {
    return __ldcg(p);
  } else {
    return __ldg(p);
  }
}

// The PER entries of a row from position i (entries past width read as
// invalid). vec: the row allows 16-byte loads (width % 4 == 0 and both
// bases aligned), so each group of four entries is all in or all out.
template <bool COHERENT>
__device__ __forceinline__ Quad load_quad(const int* __restrict__ a,
                                          const int* __restrict__ b, int i, int width,
                                          bool vec) {
  Quad q;
  if (vec) {
#pragma unroll
    for (int v = 0; v < PER; v += 4) {
      int4 x = make_int4(-1, -1, -1, -1), y = x;
      if (i + v < width) {
        x = load<COHERENT>(reinterpret_cast<const int4*>(a + i + v));
        y = load<COHERENT>(reinterpret_cast<const int4*>(b + i + v));
      }
      q.a[v] = x.x, q.a[v + 1] = x.y, q.a[v + 2] = x.z, q.a[v + 3] = x.w;
      q.b[v] = y.x, q.b[v + 1] = y.y, q.b[v + 2] = y.z, q.b[v + 3] = y.w;
    }
    return q;
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const bool in = i + k < width;
    q.a[k] = in ? load<COHERENT>(a + i + k) : -1;
    q.b[k] = in ? load<COHERENT>(b + i + k) : -1;
  }
  return q;
}

// K14's walk of dp block j, by the CTA: its gathered row of a_all,
// b_all [*, n_sub * mh] and its shards' counts in cnt [*, n_sub]; writes
// its row of out_a, out_b [*, mh] and out_tot[j].
template <bool COHERENT>
__device__ __forceinline__ void combine_row(const int* __restrict__ a_all,
                                            const int* __restrict__ b_all,
                                            const int* __restrict__ cnt, int j, int n_sub,
                                            int mh, bool vec, int* __restrict__ out_a,
                                            int* __restrict__ out_b,
                                            int* __restrict__ out_tot) {
  __shared__ int s_wc[2][WARPS];
  const int width = n_sub * mh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* a = a_all + static_cast<size_t>(j) * width;
  const int* b = b_all + static_cast<size_t>(j) * width;
  int* oa = out_a + static_cast<size_t>(j) * mh;
  int* ob = out_b + static_cast<size_t>(j) * mh;
  const unsigned lt = (1u << lane) - 1u;

  int carry = 0;
  Quad cur = load_quad<COHERENT>(a, b, tid * PER, width, vec);
  for (int base = 0, t = 0; base < width && carry < mh; base += TILE, t ^= 1) {
    const Quad nxt = load_quad<COHERENT>(a, b, base + TILE + tid * PER, width, vec);
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
    for (int k = 0; k < n_sub; ++k) s += load<COHERENT>(cnt + j * n_sub + k);
    out_tot[j] = s;
  }
}

__global__ void __launch_bounds__(CT)
combine_k(const int* __restrict__ a_all, const int* __restrict__ b_all,
          const int* __restrict__ cnt, int n_sub, int mh, bool vec,
          int* __restrict__ out_a, int* __restrict__ out_b, int* __restrict__ out_tot) {
  combine_row<false>(a_all, b_all, cnt, blockIdx.x, n_sub, mh, vec, out_a, out_b, out_tot);
}

// K15: CTA c writes the salted buffers of tiles [c * per, (c + 1) * per)
// -- a, b [*, mh] and cnt, tile k's at row k -- and, with COMBINE (per =
// n_sub: the dp block's every tile, rows side by side in sub order, so
// the CTA's rows are its gathered row), walks them as K14 does. vec: the
// rows allow 16-byte stores and loads (mh % 4 == 0, a and b aligned).
template <bool COMBINE>
__global__ void __launch_bounds__(CT)
probe_k(int salt, const int* __restrict__ tiles, int per, int mh, bool vec, int* a,
        int* b, int* cnt, int* __restrict__ out_a, int* __restrict__ out_b,
        int* __restrict__ out_tot) {
  const int tid = threadIdx.x;
  const size_t k0 = static_cast<size_t>(blockIdx.x) * per;
  int* ra = a + k0 * mh;
  int* rb = b + k0 * mh;
  const int vb = static_cast<int>(static_cast<uint32_t>(salt) * 2u + 1u);
  // -1 everywhere (four at a time where the rows allow it), then each
  // tile's entry at its position 0 and its count
  const int width = per * mh;
  if (vec) {
    const int4 none = make_int4(-1, -1, -1, -1);
    for (int i = 4 * tid; i < width; i += 4 * CT) {
      *reinterpret_cast<int4*>(ra + i) = none;
      *reinterpret_cast<int4*>(rb + i) = none;
    }
  } else {
    for (int i = tid; i < width; i += CT) {
      ra[i] = -1;
      rb[i] = -1;
    }
  }
  __syncthreads();  // the entries below land after the fill
  if (tid < per) {
    const Tile tl = load_tile(tiles, static_cast<int>(k0) + tid);
    const int va = static_cast<int>(static_cast<uint32_t>(salt) +
                                    static_cast<uint32_t>(tl.sub_i) + 1u);
    ra[tid * mh] = va;
    rb[tid * mh] = vb;
    cnt[k0 + tid] = va >= 0 ? 1 : 0;
  }
  if constexpr (COMBINE) {
    __syncthreads();  // the row and its counts are written
    combine_row<true>(a, b, cnt, blockIdx.x, per, mh, vec, out_a, out_b, out_tot);
  }
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

// K15 for the n_tiles tiles of this device (tiles [n_tiles, 4]): writes
// a, b [n_tiles, mh] and cnt [n_tiles]. With out_a non-null the device
// holds every tile of its n_tiles / n_sub dp blocks in order (tile k is
// (k / n_sub, k % n_sub)) and the same launch combines each block into
// out_a, out_b [n_tiles / n_sub, mh] and out_tot [n_tiles / n_sub]; with
// out_a null it only builds (the gather and K14 follow). One launch.
// Returns cudaGetLastError().
extern "C" int emqx_combine_probe(int salt, const int* tiles, int n_tiles, int n_sub,
                                  int mh, int* a, int* b, int* cnt, int* out_a,
                                  int* out_b, int* out_tot, cudaStream_t stream) {
  const bool vec = mh % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15u) == 0;
  if (n_tiles > 0) {
    if (out_a != nullptr) {
      probe_k<true><<<n_tiles / n_sub, CT, 0, stream>>>(salt, tiles, n_sub, mh, vec, a, b,
                                                        cnt, out_a, out_b, out_tot);
    } else {
      probe_k<false><<<n_tiles, CT, 0, stream>>>(salt, tiles, 1, mh, vec, a, b, cnt,
                                                 nullptr, nullptr, nullptr);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
