// Shared pieces of the compacting kernels (hash_match.cu,
// dense_match.cu, combine.cu): the single-block exclusive scan that turns
// per-block match counts into write offsets, the output fill, and the
// per-tile counts of a mesh launch.
//
// Both compacting kernels run as count pass -> scan -> write pass. The
// TPU programs compacted with jnp.nonzero inside one XLA program; on a
// GPU the blocks of one grid run in no order, so the order-preserving
// compaction needs the counts of every earlier block before any block
// writes. The count arrays are small (one int per block or per
// (chunk, topic) segment), so one block of SCAN_THREADS threads scans
// them in a few microseconds.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define EMQX_FULL_MASK 0xFFFFFFFFu

constexpr int SCAN_THREADS = 1024;

// offs[i] = counts[0] + ... + counts[i-1]; *total = sum of all counts.
// Each thread sums one contiguous run of counts, the block scans the
// run sums (Hillis-Steele in shared memory), then each thread writes its
// run's offsets.
__global__ void __launch_bounds__(SCAN_THREADS)
exclusive_scan_1block(const int* __restrict__ counts, int* __restrict__ offs,
                      int n, int* __restrict__ total) {
  __shared__ int part[SCAN_THREADS];
  const int tid = threadIdx.x;
  const int per = (n + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min(n, tid * per);
  const int hi = min(n, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += counts[i];
  part[tid] = s;
  __syncthreads();
  for (int d = 1; d < SCAN_THREADS; d <<= 1) {
    const int v = tid >= d ? part[tid - d] : 0;
    __syncthreads();
    part[tid] += v;
    __syncthreads();
  }
  int run = part[tid] - s;
  for (int i = lo; i < hi; ++i) {
    offs[i] = run;
    run += counts[i];
  }
  if (tid == SCAN_THREADS - 1) *total = part[tid];
}

// Result slots past the true hit count hold -1 (jnp.nonzero's
// fill_value=-1); the optional counter starts at 0.
__global__ void fill_results(int* __restrict__ a, int* __restrict__ b, int n,
                             int* __restrict__ zero) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    a[i] = -1;
    b[i] = -1;
  }
  if (zero != nullptr && i == 0) *zero = 0;
}

// A mesh launch compacts each of its n_tiles tiles on its own: a tile's
// segments are the seg_tile consecutive ones from k * seg_tile, so its
// exact count is the span of their offsets (offs from the scan above,
// total its grand total).
__global__ void tile_totals(const int* __restrict__ offs, const int* __restrict__ total,
                            int seg_tile, int n_tiles, int* __restrict__ cnt) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_tiles) return;
  const int hi = k + 1 < n_tiles ? offs[(k + 1) * seg_tile] : *total;
  cnt[k] = hi - offs[k * seg_tile];
}

static inline int ceil_div(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}
