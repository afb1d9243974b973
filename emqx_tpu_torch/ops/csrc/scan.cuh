// Shared pieces of the compacting kernels (dense_match.cu, combine.cu,
// fanout.cu, hash_match.cu): the block-wide exclusive scan and the
// single-block exclusive scan that turns per-block match counts into
// write offsets.
//
// K2 and K14 compact as count pass -> scan -> write (or place) pass. The
// TPU programs compacted with jnp.nonzero inside one XLA program; on a
// GPU the blocks of one grid run in no order, so the order-preserving
// compaction needs the counts of every earlier block before any block
// writes. The count arrays are small (one int per block or per (chunk,
// topic) segment), so one block of SCAN_THREADS threads scans them, 16K
// counts a tile; K2's segments are scanned by tiles in parallel
// (dense_match.cu `part_scan`) and their tile sums here. K1/K17
// (hash_match.cu) compact in one pass with a decoupled look-back
// instead, and K5 (fanout.cu) scans its matched rows inside one block.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define EMQX_FULL_MASK 0xFFFFFFFFu

constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ENTRIES = 16;  // consecutive entries a thread scans per tile

// Exclusive scan of x over the block (blockDim.x a multiple of 32);
// `total` gets the block's sum. Every thread of the block calls it.
__device__ __forceinline__ int block_exclusive_scan(int x, int& total) {
  __shared__ int s_warp[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int inc = x;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(EMQX_FULL_MASK, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? s_warp[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(EMQX_FULL_MASK, w, d);
      if (lane >= d) w += y;
    }
    if (lane < n_warps) s_warp[lane] = w;
  }
  __syncthreads();
  total = s_warp[n_warps - 1];
  const int before = (warp > 0 ? s_warp[warp - 1] : 0) + inc - x;
  __syncthreads();  // s_warp is free for the next call
  return before;
}

// offs[i] = counts[0] + ... + counts[i-1]; *total = sum of all counts.
// One block walks the counts in tiles of SCAN_THREADS * SCAN_ENTRIES:
// each thread loads its SCAN_ENTRIES consecutive counts (16-byte loads
// when both arrays are 16-byte aligned), the block scans the per-thread
// sums, each thread writes its offsets, and the tile's sum carries to the
// next tile.
__global__ void __launch_bounds__(SCAN_THREADS)
exclusive_scan_1block(const int* __restrict__ counts, int* __restrict__ offs,
                      int n, int* __restrict__ total) {
  constexpr int E = SCAN_ENTRIES;
  const bool vec =
      (reinterpret_cast<uintptr_t>(counts) | reinterpret_cast<uintptr_t>(offs)) % 16 == 0;
  int carry = 0;
  for (int base = 0; base < n; base += SCAN_THREADS * E) {
    const int i0 = base + threadIdx.x * E;
    const bool whole = vec && i0 + E <= n;
    int v[E];
    if (whole) {
#pragma unroll
      for (int k = 0; k < E; k += 4) {
        const int4 x = reinterpret_cast<const int4*>(counts + i0)[k / 4];
        v[k] = x.x, v[k + 1] = x.y, v[k + 2] = x.z, v[k + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < E; ++k) v[k] = i0 + k < n ? counts[i0 + k] : 0;
    }
    int sum = 0;
#pragma unroll
    for (int k = 0; k < E; ++k) sum += v[k];
    int tile;
    int run = carry + block_exclusive_scan(sum, tile);
#pragma unroll
    for (int k = 0; k < E; k += 4) {
      const int4 o = make_int4(run, run + v[k], run + v[k] + v[k + 1],
                               run + v[k] + v[k + 1] + v[k + 2]);
      run += v[k] + v[k + 1] + v[k + 2] + v[k + 3];
      if (whole) {
        reinterpret_cast<int4*>(offs + i0)[k / 4] = o;
      } else {
        const int w[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (i0 + k + j < n) offs[i0 + k + j] = w[j];
      }
    }
    carry += tile;
  }
  if (threadIdx.x == 0) *total = carry;
}

static inline int ceil_div(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}
