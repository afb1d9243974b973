// Shared pieces of the cuckoo-table probes (hash_match.cu's K1 phase 2,
// retained_probe.cu's K8): the alternate-bucket rule and the exact lane
// screen + full-fingerprint verify, so the lane rule exists once.
//
// A table is n_buckets (a power of two) buckets of BUCKET_W slots,
// stored flat: slot_fp[s], slot_bucket[s] for s = bucket * 4 + lane,
// plus one probe word per bucket whose byte l holds max(fp >> 24, 1)
// for a live slot and 0 for an empty one (ops/hash_index.py SlotArrays).
// A key (h1, fp) may sit in b1 = h1 & mask or b2 = alt_bucket(b1, fp).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

constexpr int BUCKET_W = 4;
constexpr uint32_t ALT_MUL = 0x9E3779B9u;

__device__ __forceinline__ uint32_t alt_bucket(uint32_t b1, uint32_t fp,
                                               uint32_t mask) {
  return b1 ^ (((fp | 1u) * ALT_MUL) & mask);
}

struct LaneVerdict {
  int slot;  // the winning slot: the first verified lane's, else the second's
  bool ok;   // a lane's full fingerprint equals fp
  bool amb;  // two lanes verified, or more than two lanes byte-matched
};

// The 2 * BUCKET_W lanes are bytes 0-3 of w1 (bucket b1), then bytes 0-3
// of w2 (b2). A mesh shard (K17) passes 0 as the word of a bucket it does
// not own: no probe byte is 0, so those lanes never byte-match, which is
// the reference's per-bucket lane validity. l1 is the first lane whose byte equals the probe byte, l2
// the first other one; with no such lane each is lane 0 (argmax's rule
// in the JAX programs). Only l1 and l2 have their full fingerprint read.
__device__ __forceinline__ LaneVerdict verify_lanes(
    uint32_t fp, uint32_t b1, uint32_t b2, uint32_t w1, uint32_t w2,
    const uint32_t* __restrict__ slot_fp) {
  const uint32_t p8 = max(fp >> 24, 1u);
  int nbm = 0, l1 = 0, l2 = 0;
#pragma unroll
  for (int l = 0; l < 2 * BUCKET_W; ++l) {
    const uint32_t w = l < BUCKET_W ? w1 : w2;
    if (((w >> (8 * (l & 3))) & 0xFFu) == p8) {
      if (nbm == 0) l1 = l;
      else if (nbm == 1) l2 = l;
      ++nbm;
    }
  }
  const int s1 = static_cast<int>((l1 < BUCKET_W ? b1 : b2) * BUCKET_W + (l1 & 3));
  const int s2 = static_cast<int>((l2 < BUCKET_W ? b1 : b2) * BUCKET_W + (l2 & 3));
  const bool ok1 = nbm >= 1 && slot_fp[s1] == fp;
  const bool ok2 = nbm >= 2 && slot_fp[s2] == fp;
  return LaneVerdict{ok1 ? s1 : s2, ok1 || ok2, (ok1 && ok2) || nbm > 2};
}
