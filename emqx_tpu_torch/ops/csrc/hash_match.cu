// K1: pattern-class cuckoo match with order-preserving compaction.
//
// Replaces emqx_tpu/ops/hash_index.py `match_ids_hash`. For every
// (topic b, class c) pair, in flat order p = b*C + c:
//   1. eligibility: the class's length rule ('#' or exact), active
//      flag and the '$'-root rule;
//   2. the FNV-style h1/fp mix over the class's literal levels -- bit
//      for bit the host's `_hash_host`, since the host placed the slots
//      with it (plus >> i is guarded for i >= 32, where XLA gives 0 and
//      C++ is undefined);
//   3. the two cuckoo buckets b1 = h1 & mask, b2 = b1 ^ spread(fp), one
//      u32 probe-word gather each, and the zero-byte screen;
//   4. compaction of the flagged pairs in ascending p (jnp.nonzero's
//      order), with the exact flagged-pair total even past max_hits;
//   5. for the first min(total, max_hits) flagged pairs only: the exact
//      lane-byte compare over both probe words, a full-fingerprint check
//      of the first and second byte-matching lanes, one bucket-id
//      gather, and the `amb` count (two lanes verified, or more than two
//      byte-matching lanes).
//
// What bounds it on the H100: B*C hash mixes of L levels (a few integer
// operations each) and two 4-byte gathers per pair from a probe array
// that fits in the 50 MB L2; the sparse phase touches two fingerprints
// and one bucket id per surviving pair. At B=1024 and a handful of
// classes this is microseconds of work, so launch overhead and the
// three-pass structure dominate.
//
// Design: one thread per pair. The count pass flags pairs and writes
// one count per block; a one-block scan gives each block its offset;
// the write pass recomputes the flags, ranks each flagged pair inside
// its block with warp ballots, and runs phase 2 for pairs ranked below
// max_hits. Blocks whose offset is already past max_hits exit at once.
#include "scan.cuh"

namespace {

constexpr int HT = 256;  // pairs per block
constexpr int WARPS = HT / 32;
constexpr int BUCKET_W = 4;

constexpr uint32_t H1_SEED = 0x811C9DC5u, H1_CLS = 0x9E3779B1u, H1_MUL = 16777619u;
constexpr uint32_t FP_SEED = 0x2545F491u, FP_CLS = 0x85EBCA6Bu;
constexpr uint32_t FP_XOR = 0xC2B2AE35u, FP_MUL = 0x27D4EB2Fu;
constexpr uint32_t ALT_MUL = 0x9E3779B9u;

struct HashArgs {
  const int* plen;            // [C]
  const uint8_t* has_hash;    // [C]
  const uint8_t* root_wild;   // [C]
  const uint32_t* plus;       // [C]
  const uint8_t* active;      // [C]
  int C;
  const uint32_t* slot_fp;    // [S*4]
  const int* slot_bucket;     // [S*4]
  const uint32_t* probe;      // [S]
  int S;                      // number of buckets, a power of two
  const int* t_ids;           // [B, L]
  const int* t_len;           // [B]
  const uint8_t* t_dollar;    // [B]
  int B, L;
  int* counts;                // [n_blocks] count pass output
  const int* offs;            // [n_blocks] write pass input
  int max_hits;
  int* out_ti;
  int* out_bi;
  int* out_amb;
};

__device__ __forceinline__ bool has_byte(uint32_t w, uint32_t rep) {
  const uint32_t x = w ^ rep;
  return ((x - 0x01010101u) & ~x & 0x80808080u) != 0u;
}

struct Probe {
  bool hit;
  uint32_t fp, b1, b2, w1, w2;
};

__device__ __forceinline__ Probe probe_pair(const HashArgs& a, int b, int c) {
  Probe r{false, 0u, 0u, 0u, 0u, 0u};
  const int pl = a.plen[c];
  const int tl = a.t_len[b];
  const bool len_ok = a.has_hash[c] ? tl >= pl : tl == pl;
  if (!(len_ok && a.active[c] && !(a.t_dollar[b] && a.root_wild[c]))) return r;
  const uint32_t cid = static_cast<uint32_t>(c);
  const uint32_t plus = a.plus[c];
  uint32_t h1 = H1_SEED ^ (cid * H1_CLS);
  uint32_t fp = FP_SEED + cid * FP_CLS;
  const int* ids = a.t_ids + size_t(b) * a.L;
  for (int i = 0; i < a.L; ++i) {
    const bool is_plus = i < 32 && ((plus >> i) & 1u);
    const uint32_t x =
        (i < pl && !is_plus) ? static_cast<uint32_t>(ids[i]) + 1u : 0u;
    h1 = (h1 ^ x) * H1_MUL;
    fp = (fp ^ (x * FP_XOR)) * FP_MUL;
  }
  const uint32_t mask = static_cast<uint32_t>(a.S - 1);
  r.fp = fp;
  r.b1 = h1 & mask;
  r.b2 = r.b1 ^ (((fp | 1u) * ALT_MUL) & mask);
  const uint32_t p8 = max(fp >> 24, 1u);
  const uint32_t rep = p8 * 0x01010101u;
  r.w1 = a.probe[r.b1];
  r.w2 = a.probe[r.b2];
  r.hit = has_byte(r.w1, rep) || has_byte(r.w2, rep);
  return r;
}

template <bool WRITE>
__global__ void __launch_bounds__(HT) hash_pass(HashArgs a) {
  __shared__ int s_wc[WARPS];
  if (WRITE && a.offs[blockIdx.x] >= a.max_hits) return;  // block-uniform
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long p = static_cast<long long>(blockIdx.x) * HT + tid;
  const long long n = static_cast<long long>(a.B) * a.C;
  Probe pr{false, 0u, 0u, 0u, 0u, 0u};
  int b = 0;
  if (p < n) {
    b = static_cast<int>(p / a.C);
    pr = probe_pair(a, b, static_cast<int>(p - static_cast<long long>(b) * a.C));
  }
  const unsigned m = __ballot_sync(EMQX_FULL_MASK, pr.hit);
  if (lane == 0) s_wc[warp] = __popc(m);
  __syncthreads();
  if (!WRITE) {
    if (tid == 0) {
      int s = 0;
      for (int w = 0; w < WARPS; ++w) s += s_wc[w];
      a.counts[blockIdx.x] = s;
    }
    return;
  }
  if (!pr.hit) return;
  int dst = a.offs[blockIdx.x] + __popc(m & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) dst += s_wc[w];
  if (dst >= a.max_hits) return;

  // phase 2: exact lane-byte compare over the 2*BUCKET_W lanes; verify
  // the full fingerprint of the first two byte-matching lanes
  const uint32_t p8 = max(pr.fp >> 24, 1u);
  int nbm = 0, l1 = 0, l2 = 0;
  for (int l = 0; l < 2 * BUCKET_W; ++l) {
    const uint32_t w = l < BUCKET_W ? pr.w1 : pr.w2;
    if (((w >> (8 * (l & 3))) & 0xFFu) == p8) {
      if (nbm == 0) l1 = l;
      else if (nbm == 1) l2 = l;
      ++nbm;
    }
  }
  const int s1 = static_cast<int>((l1 < BUCKET_W ? pr.b1 : pr.b2) * BUCKET_W + (l1 & 3));
  const int s2 = static_cast<int>((l2 < BUCKET_W ? pr.b1 : pr.b2) * BUCKET_W + (l2 & 3));
  const bool ok1 = nbm >= 1 && a.slot_fp[s1] == pr.fp;
  const bool ok2 = nbm >= 2 && a.slot_fp[s2] == pr.fp;
  int ti = -1, bi = -1;
  if (ok1 || ok2) {
    const int g = a.slot_bucket[ok1 ? s1 : s2];
    if (g >= 0) {
      ti = b;
      bi = g;
    }
  }
  a.out_ti[dst] = ti;
  a.out_bi[dst] = bi;
  if ((ok1 && ok2) || nbm > 2) atomicAdd(a.out_amb, 1);
}

}  // namespace

// Returns cudaGetLastError() after the launches. scratch holds
// 2 * ceil(B*C / 256) ints. Outputs: ti, bi [max_hits] (-1 past the
// hit count and for pairs phase 2 rejects), total (exact flagged-pair
// count), amb.
extern "C" int emqx_match_ids_hash(
    const int* plen, const uint8_t* has_hash, const uint8_t* root_wild,
    const uint32_t* plus, const uint8_t* active, int C,
    const uint32_t* slot_fp, const int* slot_bucket, const uint32_t* probe,
    int S, const int* t_ids, const int* t_len, const uint8_t* t_dollar, int B,
    int L, int max_hits, int* out_ti, int* out_bi, int* out_total,
    int* out_amb, int* scratch, cudaStream_t stream) {
  const int n_blocks = ceil_div(static_cast<long long>(B) * C, HT);
  HashArgs a{plen, has_hash, root_wild, plus, active, C,
             slot_fp, slot_bucket, probe, S,
             t_ids, t_len, t_dollar, B, L,
             scratch, scratch + n_blocks, max_hits, out_ti, out_bi, out_amb};
  hash_pass<false><<<n_blocks, HT, 0, stream>>>(a);
  exclusive_scan_1block<<<1, SCAN_THREADS, 0, stream>>>(
      scratch, scratch + n_blocks, n_blocks, out_total);
  fill_results<<<max(1, ceil_div(max_hits, 256)), 256, 0, stream>>>(
      out_ti, out_bi, max_hits, out_amb);
  hash_pass<true><<<n_blocks, HT, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
