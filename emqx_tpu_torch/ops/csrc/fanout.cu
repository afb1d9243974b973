// K5: the dedup/max-QoS fanout plan over the CSR destination table.
//
// Replaces emqx_tpu/ops/fanout.py `resolve_fanout` (a jitted jnp
// program): gather the matched filter rows' edge segments into
// occurrence order, keep per client the edge of highest granted QoS
// (earliest occurrence on ties), and emit the winners in order of each
// client's first occurrence — exactly Broker._build_fanout_plan's
// `best`-dict order. out[p] is the winning edge of the client whose
// first occurrence is position p, -1 everywhere else.
//
// Two launches on one stream (three when more than FUSED_ROWS filters
// matched), no host round trip, and no pass over the client registry:
//   1. gather_k     one thread per gathered position e < max_fan. Each
//                   block first scans the matched rows' masked segment
//                   lengths in shared memory (M is the matched-filter
//                   count, a power of two >= 4: a few loads a block);
//                   block 0 writes `total` and n_winners = 0. Past
//                   FUSED_ROWS rows, scan_rows_k (one block) writes the
//                   scan once and the blocks search it in global memory.
//                   An upper-bound binary search over the inclusive scan
//                   (searchsorted side="right", clipped to M-1) names the
//                   row; the edge id src[e] and the lane's client (or -1)
//                   are kept in scratch, and an ok lane does
//                     atomicMax(tw[cl], epoch << 32 | qos << 24 | 2^24-1-e)
//                     atomicMin(tf[cl], (EPOCH_LIMIT - epoch) << 32 | e);
//   2. winners_k    one thread per position: e is its client's first
//                   occurrence exactly when it is ok and tf[cl] holds e's
//                   own key; it writes out[e] = src[2^24-1 - (tw[cl] &
//                   0xFFFFFF)] and is counted into n_winners (warp-
//                   aggregated atomics); every other position writes -1.
// Max and min do not depend on the order the atomics land in, so the
// result is exact whatever order the blocks run in. JAX's mode="drop"
// sentinels become skipped writes: a lane that is not ok, or a client
// row >= n_clients, touches nothing; every gather is clamped into its
// array, as JAX clamps out-of-range gathers.
//
// The winner and first-position keys (tw, tf: 64 bits each, interleaved
// as keys[2c], keys[2c+1], so the winner pass reads both in one 16-byte
// load) persist across calls: FanoutDeviceState owns them and grows
// them with the client registry. They stay valid by epoch tags (choice
// (b) of the two ways, over a reset pass of the clients a call touched,
// which would cost a launch a call): each call has an epoch one above
// the last; a key of an older epoch is below every key of this one in
// tw and above every key of this one in tf, so stale entries lose both
// races with no clearing. Keys stay below 2^63 (epoch <= EPOCH_LIMIT =
// 2^31 - 1), so the plain version holds them in int64 with the same
// bits. A fresh table, and the call after epoch EPOCH_LIMIT, clear it
// once (clear_k: tw = 0, the epoch before any; tf = 2^63 - 1, above any
// key) and restart at epoch 1. Calls that share the tables must run in
// order: the port enqueues every resolve (the engine's overlapped ones
// too) on one stream, so call k+1's gather runs after call k's winners.
//
// What bounds it on the H100: bytes. At the broker phase's 150k fan the
// work is ~150k edge reads (8 bytes each, scattered by segment), two
// 64-bit atomics per ok edge and one 16-byte read back on the client
// keys, ~16 bytes of scratch per position; at the 2k mfan plan a few
// tens of kilobytes. Both are microseconds of HBM time, so the two
// dependent launches set the time; the work now follows the fan, not the
// 262,144-row registry that the earlier init and winner sweeps walked.
#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

typedef unsigned long long u64;

constexpr int THREADS = 256;
constexpr int POS_MASK = (1 << 24) - 1;
constexpr int QOS_MASK = 0x3;
constexpr int SKIP_BIT = 1 << 7;
constexpr int FUSED_ROWS = 1024;  // matched rows a gather block scans itself
constexpr u64 EPOCH_LIMIT = 0x7FFFFFFFull;
constexpr u64 FIRST_EMPTY = 0x7FFFFFFFFFFFFFFFull;

__device__ __forceinline__ u64 first_key(u64 epoch, int e) {
  return ((EPOCH_LIMIT - epoch) << 32) | static_cast<u64>(e);
}

__global__ void clear_k(ulonglong2* __restrict__ keys, int cap) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < cap) keys[i] = make_ulonglong2(0ull, FIRST_EMPTY);
}

// The matched rows' masked segment lengths, scanned inclusively into
// incl[0, M), their segment starts into start[0, M); returns the total.
// Every thread of the block calls it.
__device__ int scan_rows(const int* __restrict__ seg_off, const int* __restrict__ seg_len,
                         int C, const int* __restrict__ rows, int M, int* incl,
                         int* start) {
  int carry = 0;
  for (int base = 0; base < M; base += THREADS) {
    const int i = base + threadIdx.x;
    int len = 0;
    int off = 0;
    if (i < M) {
      const int r = rows[i];
      const int rr = r >= 0 ? min(r, C - 1) : 0;
      len = r >= 0 ? seg_len[rr] : 0;
      off = seg_off[rr];
    }
    int tile;
    const int before = block_exclusive_scan(len, tile);
    if (i < M) {
      incl[i] = carry + before + len;
      start[i] = off;
    }
    carry += tile;
  }
  return carry;
}

__global__ void __launch_bounds__(THREADS)
scan_rows_k(const int* __restrict__ seg_off, const int* __restrict__ seg_len, int C,
            const int* __restrict__ rows, int M, int* __restrict__ incl,
            int* __restrict__ start, int* __restrict__ total) {
  const int t = scan_rows(seg_off, seg_len, C, rows, M, incl, start);
  if (threadIdx.x == 0) *total = t;
}

__global__ void __launch_bounds__(THREADS)
gather_k(const int* __restrict__ seg_off, const int* __restrict__ seg_len, int C,
         const int* __restrict__ rows, const int* __restrict__ edge_client,
         const int* __restrict__ edge_opts, int E, const int* __restrict__ g_incl,
         const int* __restrict__ g_start, int M, int* __restrict__ total_p,
         int* __restrict__ n_win, int n_clients, int max_fan, u64 epoch,
         u64* __restrict__ keys, int* __restrict__ src_out, int* __restrict__ cl_out) {
  extern __shared__ int s_rows[];  // [2 * M] when fused: incl, then start
  const bool fused = M <= FUSED_ROWS;
  const int* inc = g_incl;
  const int* st = g_start;
  int total;
  if (fused) {
    total = scan_rows(seg_off, seg_len, C, rows, M, s_rows, s_rows + M);
    __syncthreads();
    inc = s_rows;
    st = s_rows + M;
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      *total_p = total;
      *n_win = 0;
    }
  } else {
    total = *total_p;
    if (blockIdx.x == 0 && threadIdx.x == 0) *n_win = 0;
  }
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= max_fan) return;
  // first row whose inclusive end lies beyond e
  int lo = 0;
  int hi = M;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (inc[mid] > e) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  const int fi = min(lo, M - 1);
  const int prev = fi > 0 ? inc[fi - 1] : 0;
  const int src = e < min(total, max_fan) ? st[fi] + (e - prev) : 0;
  src_out[e] = src;
  const int s = min(max(src, 0), E - 1);
  const int cl = edge_client[s];
  const int op = edge_opts[s];
  // tombstones and shared legs carry client -1; skip-bit edges have a
  // client row but no suboption (the oracle's subopts.get miss)
  const bool ok = e < total && cl >= 0 && cl < n_clients && (op & SKIP_BIT) == 0;
  cl_out[e] = ok ? cl : -1;
  if (ok) {
    const u64 w = static_cast<u64>(((op & QOS_MASK) << 24) | (POS_MASK - e));
    atomicMax(&keys[2 * static_cast<size_t>(cl)], (epoch << 32) | w);
    atomicMin(&keys[2 * static_cast<size_t>(cl) + 1], first_key(epoch, e));
  }
}

__global__ void __launch_bounds__(THREADS)
winners_k(const int* __restrict__ cl_at, const int* __restrict__ src, int max_fan,
          u64 epoch, const ulonglong2* __restrict__ keys, int* __restrict__ out,
          int* __restrict__ n_win) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  bool first = false;
  if (e < max_fan) {
    const int c = cl_at[e];
    int o = -1;
    if (c >= 0) {
      const ulonglong2 k = keys[c];  // (tw, tf)
      if (k.y == first_key(epoch, e)) {
        first = true;
        const int p = POS_MASK - static_cast<int>(k.x & POS_MASK);
        o = src[min(max(p, 0), max_fan - 1)];
      }
    }
    out[e] = o;
  }
  // every thread of the warp reaches the ballot (no early return)
  const unsigned mask = __ballot_sync(EMQX_FULL_MASK, first);
  if ((threadIdx.x & 31) == 0 && mask != 0u) atomicAdd(n_win, __popc(mask));
}

}  // namespace

// out int32 [max_fan], n_win / total int32 scalars. scratch holds
// scratch_len >= 2 * M + 2 * max_fan ints (incl, start [M]; src, the
// lanes' clients [max_fan]); keys holds 2 * cap >= 2 * n_clients 64-bit
// keys (tw, tf of each client) that persist across calls, and epoch
// (1..2^31-1) is one above the last call's on these keys; clear != 0
// clears them first (a fresh table, or the call after the last epoch).
// Returns cudaErrorInvalidValue for a bad shape or scratch, else
// cudaGetLastError().
extern "C" int emqx_resolve_fanout(const int* seg_off, const int* seg_len,
                                   int C, const int* edge_client,
                                   const int* edge_opts, int E,
                                   const int* rows, int M, int n_clients,
                                   int max_fan, int* out, int* n_win,
                                   int* total, int* scratch, long long scratch_len,
                                   unsigned long long* keys, int cap, int epoch,
                                   int clear, cudaStream_t stream) {
  if (C < 1 || E < 1 || M < 1 || n_clients < 1 || max_fan < 1 || cap < n_clients ||
      epoch < 1 || static_cast<u64>(epoch) > EPOCH_LIMIT ||
      scratch_len < 2LL * M + 2LL * max_fan) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* incl = scratch;
  int* start = scratch + M;
  int* src = scratch + 2 * M;
  int* cl_at = src + max_fan;
  const u64 ep = static_cast<u64>(epoch);
  ulonglong2* kv = reinterpret_cast<ulonglong2*>(keys);
  if (clear) clear_k<<<ceil_div(cap, THREADS), THREADS, 0, stream>>>(kv, cap);
  const bool fused = M <= FUSED_ROWS;
  if (!fused) {
    scan_rows_k<<<1, THREADS, 0, stream>>>(seg_off, seg_len, C, rows, M, incl, start,
                                           total);
  }
  const size_t smem = fused ? 2 * M * sizeof(int) : 0;
  const int blocks = ceil_div(max_fan, THREADS);
  gather_k<<<blocks, THREADS, smem, stream>>>(seg_off, seg_len, C, rows, edge_client,
                                              edge_opts, E, incl, start, M, total, n_win,
                                              n_clients, max_fan, ep, keys, src, cl_at);
  winners_k<<<blocks, THREADS, 0, stream>>>(cl_at, src, max_fan, ep, kv, out, n_win);
  return static_cast<int>(cudaGetLastError());
}
