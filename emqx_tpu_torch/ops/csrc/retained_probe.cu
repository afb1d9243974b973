// K8: the retained read's exact-key cuckoo probe.
//
// Replaces emqx_tpu/ops/retained.py `_probe_kernel` (a jitted jnp
// program). The retained index stores wildcard-free topic NAMES and
// answers SUBSCRIBE filters: each query filter's class and literal
// projection were hashed on the host to (h1, fp), so a query is one
// exact-key lookup. Per query lane i:
//   1. b1 = h1 & (S-1), b2 = b1 ^ spread(fp), one probe word each;
//   2. the lane screen of K1's phase 2: l1 is the first lane whose probe
//      byte equals max(fp >> 24, 1), l2 the next one; ok1/ok2 when their
//      full fingerprint equals fp;
//   3. bucket id = bucket_tab[winning slot] when a lane verified and
//      the slot is live, else -1; amb when two lanes verified or more
//      than two byte-matched (the host then walks its trie).
// Padding lanes (qvalid 0) answer -1, not ambiguous, and read no table.
//
// What bounds it on the H100: per query about 72 bytes (the three
// inputs, two probe words, both buckets' four fingerprints and four
// bucket ids, the two outputs): ~0.3 MB at B=4096, ~0.0001 ms at
// 3.35 TB/s. Memory latency and the launch set the time: the tables
// (2 MB of probe words, 8 MB each of fingerprints and bucket ids at 2^19
// buckets) sit in the 50 MB L2 once warm.
//
// Design: one thread per query, no shared memory, no cross-block step.
// Every table load of a query depends only on (h1, fp), so the thread
// issues all six at once -- the two probe words and, as one 16-byte
// vector each, the four fingerprints and four bucket ids of b1 and of
// b2 -- and picks the lane screen, the verify and the winner's bucket
// id from registers: one memory round trip after the query's own
// loads, where reading the fingerprints and then the bucket id behind
// the probe words took three. `verify_lanes` (cuckoo.cuh, K1's and
// K17's) stays as it is; `verify_wide` below is K8's own.
// 64 threads a block: B=4096 spreads over 64 SMs. Timed against 32, 128
// and 256 on one H100 at 2^19 buckets, 64 was the fastest at B=4096
// and B=512 (more blocks in flight hide the loads' latency) and all
// four tied at B=8, the rung most server launches take (one block).
#include "cuckoo.cuh"

namespace {

constexpr int RT = 64;  // queries per block

template <typename V>
__device__ __forceinline__ auto lane_of(const V& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// The lane rule of verify_lanes over registers: lanes 0-3 are bucket
// b1's (w1, f1, g1), lanes 4-7 bucket b2's. Returns the bucket id (-1
// on a miss or a dead slot) and sets amb.
__device__ __forceinline__ int verify_wide(uint32_t fp, uint32_t w1, uint32_t w2,
                                           const uint4& f1, const uint4& f2,
                                           const int4& g1, const int4& g2, bool& amb) {
  const uint32_t p8 = max(fp >> 24, 1u);
  int nbm = 0, first = -1, second = -1;
  bool ok1 = false, ok2 = false;
#pragma unroll
  for (int l = 0; l < 2 * BUCKET_W; ++l) {
    const uint32_t w = l < BUCKET_W ? w1 : w2;
    if (((w >> (8 * (l & 3))) & 0xFFu) == p8) {
      const bool ok = (l < BUCKET_W ? lane_of(f1, l & 3) : lane_of(f2, l & 3)) == fp;
      const int g = l < BUCKET_W ? lane_of(g1, l & 3) : lane_of(g2, l & 3);
      if (nbm == 0) {
        ok1 = ok;
        first = g;
      } else if (nbm == 1) {
        ok2 = ok;
        second = g;
      }
      ++nbm;
    }
  }
  amb = (ok1 && ok2) || nbm > 2;
  const int g = ok1 ? first : (ok2 ? second : -1);
  return g >= 0 ? g : -1;
}

__global__ void __launch_bounds__(RT) retained_probe_k(
    const uint32_t* __restrict__ probe, const uint4* __restrict__ fp4,
    const int4* __restrict__ bucket4, int S, const uint32_t* __restrict__ qh1,
    const uint32_t* __restrict__ qfp, const uint8_t* __restrict__ qvalid, int B,
    int* __restrict__ out_bid, uint8_t* __restrict__ out_amb) {
  const int i = blockIdx.x * RT + threadIdx.x;
  if (i >= B) return;
  const bool valid = qvalid[i];
  const uint32_t fp = qfp[i];
  const uint32_t h1 = qh1[i];
  int bid = -1;
  bool amb = false;
  if (valid) {
    const uint32_t mask = static_cast<uint32_t>(S - 1);
    const uint32_t b1 = h1 & mask;
    const uint32_t b2 = alt_bucket(b1, fp, mask);
    const uint32_t w1 = __ldg(probe + b1);
    const uint32_t w2 = __ldg(probe + b2);
    const uint4 f1 = __ldg(fp4 + b1);
    const uint4 f2 = __ldg(fp4 + b2);
    const int4 g1 = __ldg(bucket4 + b1);
    const int4 g2 = __ldg(bucket4 + b2);
    bid = verify_wide(fp, w1, w2, f1, f2, g1, g2, amb);
  }
  out_bid[i] = bid;
  out_amb[i] = amb ? 1 : 0;
}

}  // namespace

// probe [S] (S a power of two), slot_fp and slot_bucket [S*4], each
// 16-byte aligned (the wrapper checks), queries qh1, qfp, qvalid [B].
// Outputs out_bid int32 [B], out_amb bool [B] (0/1 bytes). Returns
// cudaGetLastError() after the launch.
extern "C" int emqx_retained_probe(
    const uint32_t* probe, const uint32_t* slot_fp, const int* slot_bucket,
    int S, const uint32_t* qh1, const uint32_t* qfp, const uint8_t* qvalid,
    int B, int* out_bid, uint8_t* out_amb, cudaStream_t stream) {
  if (B > 0) {
    retained_probe_k<<<(B + RT - 1) / RT, RT, 0, stream>>>(
        probe, reinterpret_cast<const uint4*>(slot_fp),
        reinterpret_cast<const int4*>(slot_bucket), S, qh1, qfp, qvalid, B, out_bid,
        out_amb);
  }
  return static_cast<int>(cudaGetLastError());
}
