// K8: the retained read's exact-key cuckoo probe.
//
// Replaces emqx_tpu/ops/retained.py `_probe_kernel` (a jitted jnp
// program). The retained index stores wildcard-free topic NAMES and
// answers SUBSCRIBE filters: each query filter's class and literal
// projection were hashed on the host to (h1, fp), so a query is one
// exact-key lookup. Per query lane i:
//   1. b1 = h1 & (S-1), b2 = b1 ^ spread(fp), one probe word each;
//   2. the lane screen and verify of K1's phase 2 (cuckoo.cuh): the
//      first two lanes whose probe byte equals max(fp >> 24, 1) have
//      their full fingerprint compared;
//   3. bucket id = bucket_tab[winning slot] when a lane verified and
//      the slot is live, else -1; amb when two lanes verified or more
//      than two byte-matched (the host then walks its trie).
// Padding lanes (qvalid 0) answer -1, not ambiguous, and read nothing.
//
// What bounds it on the H100: per query about 34 bytes (the three
// inputs, two probe words, at most two fingerprints, one bucket id and
// the two outputs): ~139 KB at B=4096, ~0.00004 ms at 3.35 TB/s. So
// the launch dominates; the probe array (2 MB at 2^19 buckets) and the
// fingerprints sit in the 50 MB L2 once warm.
//
// Design: one thread per query, no shared memory, no cross-block step:
// every output is its own lane's, so block order cannot matter. The
// bucket id is gathered only for a verified lane (same result as the
// JAX program's unconditional gather).
#include "cuckoo.cuh"

namespace {

constexpr int RT = 256;  // queries per block

__global__ void __launch_bounds__(RT) retained_probe_k(
    const uint32_t* __restrict__ probe, const uint32_t* __restrict__ slot_fp,
    const int* __restrict__ slot_bucket, int S, const uint32_t* __restrict__ qh1,
    const uint32_t* __restrict__ qfp, const uint8_t* __restrict__ qvalid, int B,
    int* __restrict__ out_bid, uint8_t* __restrict__ out_amb) {
  const int i = blockIdx.x * RT + threadIdx.x;
  if (i >= B) return;
  int bid = -1;
  bool amb = false;
  if (qvalid[i]) {
    const uint32_t mask = static_cast<uint32_t>(S - 1);
    const uint32_t fp = qfp[i];
    const uint32_t b1 = qh1[i] & mask;
    const uint32_t b2 = alt_bucket(b1, fp, mask);
    const LaneVerdict v = verify_lanes(fp, b1, b2, probe[b1], probe[b2], slot_fp);
    if (v.ok) {
      const int g = slot_bucket[v.slot];
      if (g >= 0) bid = g;
    }
    amb = v.amb;
  }
  out_bid[i] = bid;
  out_amb[i] = amb ? 1 : 0;
}

}  // namespace

// probe [S] (S a power of two), slot_fp and slot_bucket [S*4], queries
// qh1, qfp, qvalid [B]. Outputs out_bid int32 [B], out_amb bool [B]
// (0/1 bytes). Returns cudaGetLastError() after the launch.
extern "C" int emqx_retained_probe(
    const uint32_t* probe, const uint32_t* slot_fp, const int* slot_bucket,
    int S, const uint32_t* qh1, const uint32_t* qfp, const uint8_t* qvalid,
    int B, int* out_bid, uint8_t* out_amb, cudaStream_t stream) {
  if (B > 0) {
    retained_probe_k<<<(B + RT - 1) / RT, RT, 0, stream>>>(
        probe, slot_fp, slot_bucket, S, qh1, qfp, qvalid, B, out_bid, out_amb);
  }
  return static_cast<int>(cudaGetLastError());
}
