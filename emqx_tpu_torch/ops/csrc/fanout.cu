// K5: the dedup/max-QoS fanout plan over the CSR destination table.
//
// Replaces emqx_tpu/ops/fanout.py `resolve_fanout` (a jitted jnp
// program): gather the matched filter rows' edge segments into
// occurrence order, keep per client the edge of highest granted QoS
// (earliest occurrence on ties), and emit the winners in order of each
// client's first occurrence — exactly Broker._build_fanout_plan's
// `best`-dict order.
//
// Five launches on one stream, no host round trip:
//   1. row_lens_k     masked segment length per matched row [M];
//   2. exclusive_scan_1block (scan.cuh) of those lengths, which also
//      writes `total`; M is the matched filter count, so one block is
//      enough;
//   3. init_k         tw = -1, tf = max_fan over n_clients, out = -1,
//                     n_winners = 0;
//   4. gather_k       one thread per gathered position e < max_fan: an
//                     upper-bound binary search over the inclusive
//                     scan (searchsorted side="right", clipped to M-1)
//                     names the row, the edge id src[e] is kept in
//                     scratch, and an ok lane does
//                       atomicMax(tw[cl], qos << 24 | 2^24-1-e)
//                       atomicMin(tf[cl], e);
//   5. winners_k      one thread per client: a present client writes
//                     out[tf[c]] = src[2^24-1 - (tw[c] & 0xFFFFFF)],
//                     and warp-aggregated atomics count n_winners.
// Max and min do not depend on the order the atomics land in, so the
// result is exact whatever order the blocks run in. JAX's mode="drop"
// sentinels become skipped writes: a lane that is not ok, or a client
// row >= n_clients, touches nothing; every gather is clamped into its
// array, as JAX clamps out-of-range gathers.
//
// What bounds it on the H100: bytes. At the broker phase's 150k fan
// the work is ~150k edge reads (8 bytes each, scattered by segment),
// two atomics per edge on 1 MB client tables, and the O(n_clients)
// init and winner passes over 262,144 clients (~3 MB in all) — a few
// microseconds of HBM time, so launch latency and the five dependent
// launches dominate. A later PR can fuse init into the winner pass of
// the previous call.
#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int POS_MASK = (1 << 24) - 1;
constexpr int QOS_MASK = 0x3;
constexpr int SKIP_BIT = 1 << 7;

__global__ void row_lens_k(const int* __restrict__ seg_len, int C,
                           const int* __restrict__ rows, int M,
                           int* __restrict__ lens) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const int r = rows[i];
  lens[i] = r >= 0 ? seg_len[min(r, C - 1)] : 0;
}

__global__ void init_k(int* __restrict__ tw, int* __restrict__ tf, int nc,
                       int* __restrict__ out, int max_fan,
                       int* __restrict__ n_win) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < nc) {
    tw[i] = -1;
    tf[i] = max_fan;
  }
  if (i < max_fan) out[i] = -1;
  if (i == 0) *n_win = 0;
}

__global__ void gather_k(const int* __restrict__ seg_off, int C,
                         const int* __restrict__ edge_client,
                         const int* __restrict__ edge_opts, int E,
                         const int* __restrict__ rows,
                         const int* __restrict__ lens,
                         const int* __restrict__ excl, int M,
                         const int* __restrict__ total_p, int n_clients,
                         int max_fan, int* __restrict__ tw,
                         int* __restrict__ tf, int* __restrict__ src_out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= max_fan) return;
  const int total = *total_p;
  // first row whose inclusive end (excl + lens) lies beyond e
  int lo = 0;
  int hi = M;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (excl[mid] + lens[mid] > e) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  const int fi = min(lo, M - 1);
  // excl[fi] is the inclusive scan at fi-1, and 0 at fi == 0
  const int prev = excl[fi];
  int src = 0;
  if (e < min(total, max_fan)) {
    const int r = rows[fi];
    const int rr = r >= 0 ? min(r, C - 1) : 0;
    src = seg_off[rr] + (e - prev);
  }
  src_out[e] = src;
  const int s = min(max(src, 0), E - 1);
  const int cl = edge_client[s];
  const int op = edge_opts[s];
  // tombstones and shared legs carry client -1; skip-bit edges have a
  // client row but no suboption (the oracle's subopts.get miss)
  const bool ok = e < total && cl >= 0 && (op & SKIP_BIT) == 0;
  if (ok && cl < n_clients) {
    atomicMax(&tw[cl], ((op & QOS_MASK) << 24) | (POS_MASK - e));
    atomicMin(&tf[cl], e);
  }
}

__global__ void winners_k(const int* __restrict__ tw,
                          const int* __restrict__ tf, int nc,
                          const int* __restrict__ src, int max_fan,
                          int* __restrict__ out, int* __restrict__ n_win) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  bool present = false;
  if (c < nc) {
    const int w = tw[c];
    if (w >= 0) {
      present = true;
      const int p = min(max(POS_MASK - (w & POS_MASK), 0), max_fan - 1);
      const int slot = tf[c];
      if (slot >= 0 && slot < max_fan) out[slot] = src[p];
    }
  }
  // every thread of the warp reaches the ballot (no early return)
  const unsigned mask = __ballot_sync(EMQX_FULL_MASK, present);
  if ((threadIdx.x & 31) == 0 && mask != 0u) atomicAdd(n_win, __popc(mask));
}

}  // namespace

// out int32 [max_fan], n_win / total int32 scalars; scratch: lens and
// excl int32 [M], tw and tf int32 [n_clients], src int32 [max_fan].
// Returns cudaGetLastError().
extern "C" int emqx_resolve_fanout(const int* seg_off, const int* seg_len,
                                   int C, const int* edge_client,
                                   const int* edge_opts, int E,
                                   const int* rows, int M, int n_clients,
                                   int max_fan, int* out, int* n_win,
                                   int* total, int* lens, int* excl, int* tw,
                                   int* tf, int* src, cudaStream_t stream) {
  if (C < 1 || E < 1 || M < 1 || n_clients < 1 || max_fan < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  row_lens_k<<<ceil_div(M, THREADS), THREADS, 0, stream>>>(seg_len, C, rows,
                                                           M, lens);
  exclusive_scan_1block<<<1, SCAN_THREADS, 0, stream>>>(lens, excl, M, total);
  const long long n_init = n_clients > max_fan ? n_clients : max_fan;
  init_k<<<ceil_div(n_init, THREADS), THREADS, 0, stream>>>(tw, tf, n_clients,
                                                           out, max_fan, n_win);
  gather_k<<<ceil_div(max_fan, THREADS), THREADS, 0, stream>>>(
      seg_off, C, edge_client, edge_opts, E, rows, lens, excl, M, total,
      n_clients, max_fan, tw, tf, src);
  winners_k<<<ceil_div(n_clients, THREADS), THREADS, 0, stream>>>(
      tw, tf, n_clients, src, max_fan, out, n_win);
  return static_cast<int>(cudaGetLastError());
}
