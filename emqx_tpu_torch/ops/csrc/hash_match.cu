// K1: pattern-class cuckoo match with order-preserving compaction, and
// K17: the same per (dp, sub) tile of a mesh whose buckets are split over
// the sub axis.
//
// K1 replaces emqx_tpu/ops/hash_index.py `match_ids_hash`. For every
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
// K17 replaces the per-shard body of emqx_tpu/parallel/sharded_match.py
// `make_sharded_hash_kernel`: a tile (dp_i, sub_i) runs the same steps
// over its b_loc topics, with the LOGICAL mask n_buckets - 1, and probes
// only the buckets its shard owns, [sub_i * nb_loc, (sub_i + 1) *
// nb_loc): a bucket outside that range reads as the probe word 0, which
// no probe byte (always >= 1) matches, so its lanes drop out of the
// screen and the lane verify exactly as the reference's validity mask
// drops them. A pair is flagged when either of its owned buckets has a
// byte hit, so a pair whose b1 and b2 sit on two shards is flagged by
// both; only the shard that holds the key verifies it. Each tile
// compacts on its own (topic, class order, global topic and bucket ids,
// exact count); `amb` adds over every tile. The combine (combine.cu,
// K14) follows it. K1 is the one tile (0, 0, 0, 0) owning every bucket.
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
// max_hits within their tile. Blocks whose offset is already past
// max_hits exit at once.
#include "cuckoo.cuh"
#include "scan.cuh"
#include "dense_pred.cuh"  // Tile, load_tile

namespace {

constexpr int HT = 256;  // pairs per block
constexpr int WARPS = HT / 32;

constexpr uint32_t H1_SEED = 0x811C9DC5u, H1_CLS = 0x9E3779B1u, H1_MUL = 16777619u;
constexpr uint32_t FP_SEED = 0x2545F491u, FP_CLS = 0x85EBCA6Bu;
constexpr uint32_t FP_XOR = 0xC2B2AE35u, FP_MUL = 0x27D4EB2Fu;

struct HashArgs {
  const int* plen;            // [C]
  const uint8_t* has_hash;    // [C]
  const uint8_t* root_wild;   // [C]
  const uint32_t* plus;       // [C]
  const uint8_t* active;      // [C]
  int C;
  const uint32_t* slot_fp;    // [n_sub_here * nb_loc * 4]
  const int* slot_bucket;     // [n_sub_here * nb_loc * 4]
  const uint32_t* probe;      // [n_sub_here * nb_loc]
  int nb_loc;                 // buckets a shard owns (K1: all of them)
  uint32_t mask;              // logical bucket count - 1 (a power of two)
  const int* t_ids;           // [n_dp_here * b_loc, L]
  const int* t_len;
  const uint8_t* t_dollar;
  int b_loc, L;
  const int* tiles;           // [n_tiles, 4], or null for one tile
  int n_blk;                  // blocks a tile
  int* counts;                // [n_tiles * n_blk] count pass output
  const int* offs;            // [n_tiles * n_blk] write pass input
  int max_hits;
  int* out_ti;                // [n_tiles, max_hits]
  int* out_bi;
  int* out_amb;
};

__device__ __forceinline__ bool has_byte(uint32_t w, uint32_t rep) {
  const uint32_t x = w ^ rep;
  return ((x - 0x01010101u) & ~x & 0x80808080u) != 0u;
}

struct Probe {
  bool hit;
  uint32_t fp, b1, b2, w1, w2;  // b1, b2: bucket positions in the tile's shard
};

// The probe word of logical bucket b for a shard whose first bucket is
// lo: 0 (no lane) for a bucket the shard does not own.
__device__ __forceinline__ uint32_t owned_word(const HashArgs& a, const uint32_t* probe,
                                               uint32_t b, uint32_t lo, uint32_t* local) {
  *local = b - lo;  // wraps past nb_loc for b < lo: not owned either way
  return *local < static_cast<uint32_t>(a.nb_loc) ? probe[*local] : 0u;
}

// Pair (topic, class c) of a tile: the topic's row `row` of this
// device's topic arrays.
__device__ __forceinline__ Probe probe_pair(const HashArgs& a, const Tile& tl,
                                            size_t row, int c) {
  Probe r{false, 0u, 0u, 0u, 0u, 0u};
  const int pl = a.plen[c];
  const int tl_len = a.t_len[row];
  const bool len_ok = a.has_hash[c] ? tl_len >= pl : tl_len == pl;
  if (!(len_ok && a.active[c] && !(a.t_dollar[row] && a.root_wild[c]))) return r;
  const int* ids = a.t_ids + row * a.L;
  const uint32_t cid = static_cast<uint32_t>(c);
  const uint32_t plus = a.plus[c];
  uint32_t h1 = H1_SEED ^ (cid * H1_CLS);
  uint32_t fp = FP_SEED + cid * FP_CLS;
  for (int i = 0; i < a.L; ++i) {
    const bool is_plus = i < 32 && ((plus >> i) & 1u);
    const uint32_t x =
        (i < pl && !is_plus) ? static_cast<uint32_t>(ids[i]) + 1u : 0u;
    h1 = (h1 ^ x) * H1_MUL;
    fp = (fp ^ (x * FP_XOR)) * FP_MUL;
  }
  const uint32_t g1 = h1 & a.mask;
  const uint32_t g2 = alt_bucket(g1, fp, a.mask);
  const uint32_t lo = static_cast<uint32_t>(tl.sub_i) * static_cast<uint32_t>(a.nb_loc);
  const uint32_t* probe = a.probe + static_cast<size_t>(tl.sub_pos) * a.nb_loc;
  r.fp = fp;
  r.w1 = owned_word(a, probe, g1, lo, &r.b1);
  r.w2 = owned_word(a, probe, g2, lo, &r.b2);
  const uint32_t p8 = max(fp >> 24, 1u);
  const uint32_t rep = p8 * 0x01010101u;
  r.hit = has_byte(r.w1, rep) || has_byte(r.w2, rep);
  return r;
}

template <bool WRITE>
__global__ void __launch_bounds__(HT) hash_pass(HashArgs a) {
  __shared__ int s_wc[WARPS];
  const int tile = blockIdx.y;
  const int blk = tile * a.n_blk + blockIdx.x;
  const int base_off = WRITE ? a.offs[tile * a.n_blk] : 0;
  if (WRITE && a.offs[blk] - base_off >= a.max_hits) return;  // block-uniform
  const Tile tl = load_tile(a.tiles, tile);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long p = static_cast<long long>(blockIdx.x) * HT + tid;
  const long long n = static_cast<long long>(a.b_loc) * a.C;
  Probe pr{false, 0u, 0u, 0u, 0u, 0u};
  int b = 0;
  if (p < n) {
    b = static_cast<int>(p / a.C);
    pr = probe_pair(a, tl, static_cast<size_t>(tl.dp_pos) * a.b_loc + b,
                    static_cast<int>(p - static_cast<long long>(b) * a.C));
  }
  const unsigned m = __ballot_sync(EMQX_FULL_MASK, pr.hit);
  if (lane == 0) s_wc[warp] = __popc(m);
  __syncthreads();
  if (!WRITE) {
    if (tid == 0) {
      int s = 0;
      for (int w = 0; w < WARPS; ++w) s += s_wc[w];
      a.counts[blk] = s;
    }
    return;
  }
  if (!pr.hit) return;
  int dst = a.offs[blk] - base_off + __popc(m & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) dst += s_wc[w];
  if (dst >= a.max_hits) return;

  // phase 2: exact lane-byte compare over the 2*BUCKET_W lanes; verify
  // the full fingerprint of the first two byte-matching lanes (lanes of
  // a bucket the shard does not own read as 0 and never byte-match)
  const size_t s_base = static_cast<size_t>(tl.sub_pos) * a.nb_loc * BUCKET_W;
  const LaneVerdict v =
      verify_lanes(pr.fp, pr.b1, pr.b2, pr.w1, pr.w2, a.slot_fp + s_base);
  int ti = -1, bi = -1;
  if (v.ok) {
    const int g = a.slot_bucket[s_base + v.slot];
    if (g >= 0) {
      ti = b + tl.dp_i * a.b_loc;
      bi = g;
    }
  }
  const size_t o = static_cast<size_t>(tile) * a.max_hits + dst;
  a.out_ti[o] = ti;
  a.out_bi[o] = bi;
  if (v.amb) atomicAdd(a.out_amb, 1);
}

void launch(HashArgs a, int n_tiles, int* scratch, int* out_total, cudaStream_t stream) {
  const int nseg = n_tiles * a.n_blk;
  a.counts = scratch;
  a.offs = scratch + nseg;
  const dim3 grid(a.n_blk, n_tiles);
  hash_pass<false><<<grid, HT, 0, stream>>>(a);
  exclusive_scan_1block<<<1, SCAN_THREADS, 0, stream>>>(
      scratch, scratch + nseg, nseg, out_total);
  fill_results<<<max(1, ceil_div(static_cast<long long>(a.max_hits) * n_tiles, 256)),
                 256, 0, stream>>>(a.out_ti, a.out_bi, a.max_hits * n_tiles, a.out_amb);
  hash_pass<true><<<grid, HT, 0, stream>>>(a);
}

}  // namespace

// K1. Returns cudaGetLastError() after the launches. scratch holds
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
  HashArgs a{plen, has_hash, root_wild, plus, active, C,
             slot_fp, slot_bucket, probe, S, static_cast<uint32_t>(S - 1),
             t_ids, t_len, t_dollar, B, L, nullptr,
             ceil_div(static_cast<long long>(B) * C, HT),
             nullptr, nullptr, max_hits, out_ti, out_bi, out_amb};
  launch(a, 1, scratch, out_total, stream);
  return static_cast<int>(cudaGetLastError());
}

// K17. The n_tiles tiles of this device (tiles [n_tiles, 4]): b_loc
// topics a dp block, nb_loc buckets a sub shard, n_buckets the logical
// (power-of-two) bucket count. scratch holds 2 * n_tiles * ceil(b_loc*C /
// 256) + 1 ints. Outputs: ti, bi [n_tiles, max_hits] (global ids, -1 past
// each tile's count and for rejects), cnt [n_tiles] (exact flagged
// pairs), amb (over every tile).
extern "C" int emqx_mesh_match_ids_hash(
    const int* plen, const uint8_t* has_hash, const uint8_t* root_wild,
    const uint32_t* plus, const uint8_t* active, int C,
    const uint32_t* slot_fp, const int* slot_bucket, const uint32_t* probe,
    int nb_loc, int n_buckets, const int* t_ids, const int* t_len,
    const uint8_t* t_dollar, int b_loc, int L, const int* tiles, int n_tiles,
    int max_hits, int* out_ti, int* out_bi, int* out_cnt, int* out_amb,
    int* scratch, cudaStream_t stream) {
  const int n_blk = ceil_div(static_cast<long long>(b_loc) * C, HT);
  HashArgs a{plen, has_hash, root_wild, plus, active, C,
             slot_fp, slot_bucket, probe, nb_loc,
             static_cast<uint32_t>(n_buckets - 1),
             t_ids, t_len, t_dollar, b_loc, L, tiles, n_blk,
             nullptr, nullptr, max_hits, out_ti, out_bi, out_amb};
  const int nseg = n_tiles * n_blk;
  int* total = scratch + 2 * nseg;
  launch(a, n_tiles, scratch, total, stream);
  tile_totals<<<ceil_div(n_tiles, 256), 256, 0, stream>>>(scratch + nseg, total, n_blk,
                                                          n_tiles, out_cnt);
  return static_cast<int>(cudaGetLastError());
}
