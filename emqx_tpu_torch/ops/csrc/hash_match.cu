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
// and one bucket id per surviving pair. At B=1024 and 256 classes this
// is microseconds of work, so the launches and the passes over the
// pairs set the time.
//
// Design: one pass, one thread per pair, each pair hashed once. A block
// owns HT consecutive pairs of a tile and takes its place in the tile's
// order from an atomic ticket (never blockIdx), so it waits only on
// blocks that are already running: forward progress holds however the
// grid is scheduled. It flags its pairs, counts them with warp ballots,
// and publishes its count at once (status A); warp 0 then looks back
// over the earlier blocks' status words 32 at a time, adding counts (A)
// until it meets an inclusive prefix (P), and publishes its own prefix
// (P). A status word is one 64-bit store, flag and value together, so
// no fence orders them. Each flagged pair then has its rank (block
// prefix + warp offset + lane rank) and runs phase 2 only when ranked
// below max_hits; ranks past max_hits still count into the exact total.
// The tile's last block writes the tile's total and fills the -1 tail.
// The ticket, `amb` and the status words live in the scratch, which one
// cudaMemsetAsync zeroes before the pass (ops/hash_index.py
// `hash_geometry` sizes it). At phase 5's shape (C = 256 = HT) a block
// is one topic; a block stages the level ids of the (at most
// STAGE_TOPICS) topics its pairs span in shared memory, and any other C
// reads them from global memory.
#include "cuckoo.cuh"
#include "scan.cuh"
#include "dense_pred.cuh"  // Tile, load_tile

namespace {

constexpr int HT = 256;  // pairs per block
constexpr int WARPS = HT / 32;
constexpr int STAGE_TOPICS = 4;   // topic rows a block stages
constexpr int STAGE_LEVELS = 128; // ops/match.py MAX_KERNEL_LEVELS

typedef unsigned long long u64;
constexpr u64 FLAG_A = 1ull << 32;  // the block's own count is published
constexpr u64 FLAG_P = 2ull << 32;  // the inclusive prefix is published
constexpr u64 FLAG_MASK = 3ull << 32;

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
  unsigned* ticket;           // scratch[0]: the next block's place
  int* out_amb;               // scratch[1]
  u64* status;                // [n_tiles * n_blk], from scratch[2]
  int max_hits;
  int* out_ti;                // [n_tiles, max_hits]
  int* out_bi;
  int* out_cnt;               // [n_tiles] exact flagged pairs (K1: total)
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
// device's topic arrays, its level ids at `ids` (shared or global).
__device__ __forceinline__ Probe probe_pair(const HashArgs& a, const Tile& tl,
                                            size_t row, const int* ids, int c) {
  Probe r{false, 0u, 0u, 0u, 0u, 0u};
  const int pl = a.plen[c];
  const int tl_len = a.t_len[row];
  const bool len_ok = a.has_hash[c] ? tl_len >= pl : tl_len == pl;
  if (!(len_ok && a.active[c] && !(a.t_dollar[row] && a.root_wild[c]))) return r;
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

__device__ __forceinline__ u64 load_status(const u64* s) {
  return *reinterpret_cast<const volatile u64*>(s);
}

__device__ __forceinline__ void store_status(u64* s, u64 w) {
  *reinterpret_cast<volatile u64*>(s) = w;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(EMQX_FULL_MASK, v, d);
  return v;
}

// The sum of the counts of blocks 0..blk-1 of a tile (st: the tile's
// status words), by the whole warp: lane l reads block top - l; the
// window waits until each of its blocks has published, adds the counts
// down to and including the nearest inclusive prefix, and moves 32
// blocks down while it has met none. Before block 0 reads as a prefix
// of 0. (A step of 64-256 words, which waits on more blocks at once,
// timed slower at phase 5's and phase 9's shapes on an H100.)
__device__ int look_back(const u64* st, int blk, int lane) {
  int excl = 0;
  for (int top = blk - 1;; top -= 32) {
    const int j = top - lane;
    u64 w = j >= 0 ? load_status(st + j) : FLAG_P;
    while (__any_sync(EMQX_FULL_MASK, (w & FLAG_MASK) == 0ull)) {
      if ((w & FLAG_MASK) == 0ull) w = load_status(st + j);
    }
    const unsigned pm = __ballot_sync(EMQX_FULL_MASK, (w & FLAG_MASK) == FLAG_P);
    const int stop = pm ? __ffs(pm) - 1 : 31;
    excl += warp_sum(lane <= stop ? static_cast<int>(static_cast<uint32_t>(w)) : 0);
    if (pm) return excl;
  }
}

__global__ void __launch_bounds__(HT) hash_compact(HashArgs a) {
  __shared__ int s_ids[STAGE_TOPICS * STAGE_LEVELS];
  __shared__ int s_wc[WARPS];
  __shared__ int s_place, s_excl, s_count;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_place = static_cast<int>(atomicAdd(a.ticket, 1u));
  __syncthreads();
  const int tile = s_place / a.n_blk;
  const int blk = s_place - tile * a.n_blk;
  const Tile tl = load_tile(a.tiles, tile);
  const long long n = static_cast<long long>(a.b_loc) * a.C;
  const long long p0 = static_cast<long long>(blk) * HT;
  const int b0 = static_cast<int>(p0 / a.C);
  const int b_end = static_cast<int>(min(p0 + HT - 1, n - 1) / a.C);
  const size_t row0 = static_cast<size_t>(tl.dp_pos) * a.b_loc + b0;
  const bool staged = b_end - b0 < STAGE_TOPICS && a.L <= STAGE_LEVELS;
  if (staged) {
    const int n_ids = (b_end - b0 + 1) * a.L;
    for (int i = tid; i < n_ids; i += HT) s_ids[i] = a.t_ids[row0 * a.L + i];
  }
  __syncthreads();

  const long long p = p0 + tid;
  Probe pr{false, 0u, 0u, 0u, 0u, 0u};
  int b = 0;
  if (p < n) {
    b = static_cast<int>(p / a.C);
    const int k = b - b0;
    const int* ids = staged ? s_ids + k * a.L : a.t_ids + (row0 + k) * a.L;
    pr = probe_pair(a, tl, row0 + k, ids, static_cast<int>(p - static_cast<long long>(b) * a.C));
  }
  const unsigned m = __ballot_sync(EMQX_FULL_MASK, pr.hit);
  if (lane == 0) s_wc[warp] = __popc(m);
  __syncthreads();
  if (warp == 0) {
    // warp offsets, the block's count; publish, look back, publish
    const int wc = lane < WARPS ? s_wc[lane] : 0;
    int inc = wc;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(EMQX_FULL_MASK, inc, d);
      if (lane >= d) inc += y;
    }
    const int count = __shfl_sync(EMQX_FULL_MASK, inc, 31);
    if (lane < WARPS) s_wc[lane] = inc - wc;
    u64* st = a.status + static_cast<size_t>(tile) * a.n_blk;
    int excl = 0;
    if (blk == 0) {
      if (lane == 0) store_status(st, FLAG_P | static_cast<uint32_t>(count));
    } else {
      if (lane == 0) store_status(st + blk, FLAG_A | static_cast<uint32_t>(count));
      excl = look_back(st, blk, lane);
      if (lane == 0) store_status(st + blk, FLAG_P | static_cast<uint32_t>(excl + count));
    }
    if (lane == 0) {
      s_excl = excl;
      s_count = count;
    }
  }
  __syncthreads();
  const int excl = s_excl;
  const size_t o_tile = static_cast<size_t>(tile) * a.max_hits;
  if (blk == a.n_blk - 1) {
    // the tile's last block: its exact count and the -1 tail
    const int total = excl + s_count;
    if (tid == 0) a.out_cnt[tile] = total;
    for (int i = min(total, a.max_hits) + tid; i < a.max_hits; i += HT) {
      a.out_ti[o_tile + i] = -1;
      a.out_bi[o_tile + i] = -1;
    }
  }
  if (!pr.hit) return;
  const int dst = excl + s_wc[warp] + __popc(m & ((1u << lane) - 1u));
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
  a.out_ti[o_tile + dst] = ti;
  a.out_bi[o_tile + dst] = bi;
  if (v.amb) atomicAdd(a.out_amb, 1);
}

// Zero the scratch (ticket, amb, status words), then the one pass.
// Returns cudaErrorInvalidValue when the scratch is short.
int launch(HashArgs a, int n_tiles, int* scratch, long long scratch_len,
           cudaStream_t stream) {
  const long long need = 2 + 2LL * n_tiles * a.n_blk;
  if (a.n_blk < 1 || n_tiles < 1 || a.max_hits < 1 || scratch_len < need)
    return static_cast<int>(cudaErrorInvalidValue);
  a.ticket = reinterpret_cast<unsigned*>(scratch);
  a.out_amb = scratch + 1;
  a.status = reinterpret_cast<u64*>(scratch + 2);
  const cudaError_t rc = cudaMemsetAsync(scratch, 0, need * sizeof(int), stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  hash_compact<<<n_tiles * a.n_blk, HT, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1. scratch holds scratch_len >= 2 + 2 * ceil(B*C / 256) ints
// (ops/hash_index.py `hash_geometry`); scratch[1] is the `amb` output.
// Outputs: ti, bi [max_hits] (-1 past the hit count and for pairs phase
// 2 rejects), total (exact flagged-pair count), amb (pairs ranked below
// max_hits with two verified lanes or more than two byte-matching ones).
extern "C" int emqx_match_ids_hash(
    const int* plen, const uint8_t* has_hash, const uint8_t* root_wild,
    const uint32_t* plus, const uint8_t* active, int C,
    const uint32_t* slot_fp, const int* slot_bucket, const uint32_t* probe,
    int S, const int* t_ids, const int* t_len, const uint8_t* t_dollar, int B,
    int L, int max_hits, int* out_ti, int* out_bi, int* out_total,
    int* scratch, long long scratch_len, cudaStream_t stream) {
  HashArgs a{plen, has_hash, root_wild, plus, active, C,
             slot_fp, slot_bucket, probe, S, static_cast<uint32_t>(S - 1),
             t_ids, t_len, t_dollar, B, L, nullptr,
             ceil_div(static_cast<long long>(B) * C, HT),
             nullptr, nullptr, nullptr, max_hits, out_ti, out_bi, out_total};
  return launch(a, 1, scratch, scratch_len, stream);
}

// K17. The n_tiles tiles of this device (tiles [n_tiles, 4]): b_loc
// topics a dp block, nb_loc buckets a sub shard, n_buckets the logical
// (power-of-two) bucket count. scratch holds scratch_len >= 2 + 2 *
// n_tiles * ceil(b_loc*C / 256) ints (`hash_geometry`); scratch[1] is the
// `amb` output (over every tile). Outputs: ti, bi [n_tiles, max_hits]
// (global ids, -1 past each tile's count and for rejects), cnt [n_tiles]
// (exact flagged pairs).
extern "C" int emqx_mesh_match_ids_hash(
    const int* plen, const uint8_t* has_hash, const uint8_t* root_wild,
    const uint32_t* plus, const uint8_t* active, int C,
    const uint32_t* slot_fp, const int* slot_bucket, const uint32_t* probe,
    int nb_loc, int n_buckets, const int* t_ids, const int* t_len,
    const uint8_t* t_dollar, int b_loc, int L, const int* tiles, int n_tiles,
    int max_hits, int* out_ti, int* out_bi, int* out_cnt,
    int* scratch, long long scratch_len, cudaStream_t stream) {
  HashArgs a{plen, has_hash, root_wild, plus, active, C,
             slot_fp, slot_bucket, probe, nb_loc,
             static_cast<uint32_t>(n_buckets - 1),
             t_ids, t_len, t_dollar, b_loc, L, tiles,
             ceil_div(static_cast<long long>(b_loc) * C, HT),
             nullptr, nullptr, nullptr, max_hits, out_ti, out_bi, out_cnt};
  return launch(a, n_tiles, scratch, scratch_len, stream);
}
