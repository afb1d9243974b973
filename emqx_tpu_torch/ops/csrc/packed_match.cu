// The dense match in its three forms, one kernel, `packed_pass`, whose
// template parameter is the form:
//   * BITMAP: K10 and K13's packed form, the match folded into a uint32
//     bitmap;
//   * COUNTS: K11 and K13's counts, the same tests summed per topic;
//   * BYTES:  K9, the bool matrix, a byte a (topic, row).
//
// Replaces emqx_tpu/ops/match.py:129 `match_packed` with `_pack_bits`
// (:111) -- uint32 [B, N/32], bit k of word j = row 32j + k -- and
// emqx_tpu/parallel/sharded_match.py:82 `match_packed` (K13 packed): the
// same with rows split over the mesh's sub axis and topics over its dp
// axis, each (dp, sub) tile writing its block of the global [B, N/32]
// plane (rows dp_i * b_loc .., words sub_i * n_loc/32 ..). COUNTS
// replaces emqx_tpu/ops/match.py:214 `match_counts` (K11: int32 [B],
// `_match_block(...).sum(axis=1)`) and sharded_match.py:73
// `match_counts` (K13 counts: each tile adds its rows' counts into
// out[dp_i * b_loc ..], the sum over sub). BYTES replaces
// emqx_tpu/ops/match.py:120 `match_dense` (K9: bool [B, N],
// `_match_block` over the whole table; one tile, no mesh caller). The
// predicate is dense_pred.cuh's, shared with K2 and K16.
//
// What bounds it on the H100: the bitmap and the counts, the
// operations. The predicate runs over every (topic, live row) pair, a
// few integer operations each (0.129 ms for 1,024 topics over phase 9's
// 1,053,629 live rows at 67 T/s), ahead of the bytes: the table once and
// the bitmap written once (B*N/8 bytes: 0.080 ms for 1,024 x 2,097,152
// at 3.35 TB/s; a count writes 4B). As compiled, `quick` and the mask
// are integer compares, selects and logic, which issue at half the fp32
// rate the bound assumes: the kernel waits on them, not on latency (more
// blocks an SM gain nothing). The bool matrix, the bytes: B*N bytes
// written (0.040 ms for 64 x 2,097,152) against the tests of 64 topics
// (0.008 ms at 67 T/s), so its stores decide how close it gets.
//
// Design: a block owns PW consecutive 32-row words of one tile, a warp
// a word, and walks every topic of the tile TT at a time.
//   * Dead rows cost next to nothing. A block whose PW*32 rows are all
//     inactive evaluates nothing: the bitmap and the matrix write their
//     runs as zeros for every topic, a count returns at once (its output
//     is zeroed before the launch). A dead word in a live block writes
//     zeros into the block's buffer and skips the topic loop. An
//     inactive lane in a live word (rows at or past n_loc are inactive)
//     holds a window that admits no topic, so it never reads its row and
//     never reaches `rest`.
//   * Rows in registers, topics in groups. Each live lane gathers its
//     row once as a `RegRow` (levels past REG_LEVELS are read from the
//     table inside `rest`, as K2 reads them) and keeps it across every
//     topic. It tests TG topics at a time with the branch-free `quick`
//     into a lane mask; one warp reduction says which of the TG any lane
//     passed, and only those take `rest` and a ballot, which is the
//     word. Lane k keeps topic k's word (its popcount for a count), so a
//     group's TG values land in the buffer in one store. (A topic at a
//     time is a chain of dependent shared loads and a vote per topic,
//     latency-bound.)
//   * The bitmap's stores are whole segments. The block gathers its PW
//     words for TT topics in shared memory (a pad word a topic: the
//     lanes' stores hit distinct banks), then writes each topic's
//     contiguous run of PW words with 16-byte stores: PW*4 bytes a topic
//     instead of one 4-byte store per warp per topic.
//   * The matrix expands the same buffer. After the barrier each thread
//     turns BR bits of a topic's run into BR bytes of 0 or 1 (a nibble
//     at a time: nib * 0x00204081 & 0x01010101) and writes them with one
//     streaming store (`__stcs`: the B*N output passes L2 by, the table
//     stays in it); 16 threads write a topic's 256-byte run. Where the
//     output's rows are not 16-byte aligned (N % 16 != 0) the same
//     thread writes its bytes one by one. Rows at or past n_loc are
//     never written.
//   * A count reduces in two levels. Thread t sums the PW warps' counts
//     of topic t from the same buffer and adds the sum to the output with
//     one global atomic, only when it is nonzero: at most one atomic per
//     (live block, topic). Integer adds commute, so the counts are exact
//     and the same on every run.
//   * Enough blocks: N/32/PW blocks a tile (8,192 for K10's one tile of
//     2,097,152 rows; 2,048 for each of K13's eight tiles of 524,288),
//     four an SM at 64 registers a thread.
// Two barriers a topic tile: after the tests (the buffer is whole),
// and after the next tile's topics are staged (the buffer is written).
// The constants were chosen on the card at phase 9's width with
// tools/packed_variants.py (PERF.md section 6).
#include "scan.cuh"
#include "dense_pred.cuh"

namespace {

constexpr int PT = 256;       // threads of a block: a row each
constexpr int PW = PT / 32;   // words of a block: a warp each
constexpr int TT = 256;       // topics staged at a time
constexpr int TG = 32;        // topics a warp tests at once
constexpr int OS = PW + 1;    // buffer words a topic: PW and a pad word
constexpr int QUADS = PW / 4;  // 16-byte stores a topic's bitmap run
constexpr int BR = 16;        // rows (bytes) of one store of the matrix
constexpr int PIECES = PT / BR;  // stores a topic's matrix run
constexpr int MIN_BLOCKS = 4;  // blocks an SM holds: a cap of 64 registers
static_assert(TT % TG == 0 && TG <= 32, "topic groups tile TT; a lane keeps a word");
static_assert(PW % 4 == 0, "a block's run is whole 16-byte stores");
static_assert(BR == 4 || BR == 8 || BR == 16, "a matrix store is 4, 8 or 16 bytes");

enum Form { BITMAP = 0, COUNTS = 1, BYTES = 2 };

struct PackedArgs {
  const int* words;         // [n_sub_here * n_loc, L]
  const int* plen;
  const uint8_t* has_hash;
  const uint8_t* root_wild;
  const uint8_t* active;
  int n_loc, L;
  bool vec;                 // words 16-byte aligned and L % 4 == 0
  const int* t_ids;         // [n_dp_here * b_loc, L]
  const int* t_len;
  const uint8_t* t_dollar;
  int b_loc;
  const int* tiles;         // [n_tiles, 4] or null for one tile
  uint32_t* out;            // the bitmap [B, out_w]; a count's int32 [B] and the
                            // matrix's bool [B, out_w] as uint32
  long long out_w;
  bool out_vec;             // vector stores: out 16-byte aligned and, for the
                            // bitmap, out_w and n_loc/32 multiples of 4; for the
                            // matrix, out_w and n_loc multiples of 16
};

size_t smem_bytes(int L) {
  // s_th [TT] int2 + s_tw [TT*L] + s_out [TT*OS]
  return sizeof(int2) * TT + sizeof(int) * (size_t(TT) * L + size_t(TT) * OS);
}

// Write the runs of topics [0, nt): topic t's n_w words (buffer row t,
// or zeros when buf is null) at out[(row0 + t) * out_w + col0 ...].
__device__ __forceinline__ void store_runs(const PackedArgs& a, long long row0,
                                           long long col0, int nt, int n_w,
                                           const uint32_t* buf) {
  for (int e = threadIdx.x; e < nt * QUADS; e += PT) {
    const int t = e / QUADS, w = 4 * (e - t * QUADS);
    if (w >= n_w) continue;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (buf != nullptr) {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = buf[t * OS + w + j];
    }
    uint32_t* dst = a.out + (row0 + t) * a.out_w + col0 + w;
    if (a.out_vec && w + 4 <= n_w) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
      for (int j = 0; j < 4 && w + j < n_w; ++j) dst[j] = v[j];
    }
  }
}

// The four bits of nib as four bytes of 0 or 1, row k in byte k.
__device__ __forceinline__ uint32_t nibble_bytes(uint32_t nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

// Write the matrix runs of topics [0, nt): topic t's n_rows bits (buffer
// row t, or zeros when buf is null) as bytes at out[(row0 + t) * out_w +
// col0 ...], BR bytes a store.
__device__ __forceinline__ void store_bytes(const PackedArgs& a, long long row0,
                                            long long col0, int nt, int n_rows,
                                            const uint32_t* buf) {
  uint8_t* out = reinterpret_cast<uint8_t*>(a.out);
  for (int e = threadIdx.x; e < nt * PIECES; e += PT) {
    const int t = e / PIECES, r = BR * (e - t * PIECES);
    if (r >= n_rows) continue;
    const uint32_t bits = buf == nullptr ? 0u : buf[t * OS + r / 32] >> (r % 32);
    uint8_t* dst = out + (row0 + t) * a.out_w + col0 + r;
    if (a.out_vec) {  // n_rows is a multiple of 16: the store is whole
      uint32_t v[BR / 4];
#pragma unroll
      for (int j = 0; j < BR / 4; ++j) v[j] = nibble_bytes(bits >> (4 * j) & 0xfu);
      if constexpr (BR == 16) {
        __stcs(reinterpret_cast<uint4*>(dst), make_uint4(v[0], v[1], v[2], v[3]));
      } else if constexpr (BR == 8) {
        __stcs(reinterpret_cast<uint2*>(dst), make_uint2(v[0], v[1]));
      } else {
        __stcs(reinterpret_cast<unsigned int*>(dst), v[0]);
      }
    } else {
      for (int j = 0; j < BR && r + j < n_rows; ++j) dst[j] = bits >> j & 1u;
    }
  }
}

// Add the counts of topics [0, nt) to out[row0 + t]: topic t's sum over
// the block's PW warps (buffer row t), when it is nonzero. The buffer's
// stride OS is odd, so the threads' reads hit distinct banks.
__device__ __forceinline__ void add_counts(const PackedArgs& a, long long row0, int nt,
                                           const uint32_t* buf) {
  for (int t = threadIdx.x; t < nt; t += PT) {
    uint32_t sum = 0u;
#pragma unroll
    for (int w = 0; w < PW; ++w) sum += buf[t * OS + w];
    if (sum != 0u) atomicAdd(a.out + row0 + t, sum);
  }
}

template <int FORM>
__global__ void __launch_bounds__(PT, MIN_BLOCKS) packed_pass(PackedArgs a) {
  extern __shared__ int4 smem4[];
  const int L = a.L;
  int2* s_th = reinterpret_cast<int2*>(smem4);  // topic (header, level 0) [TT]
  int* s_tw = reinterpret_cast<int*>(s_th + TT);  // topic words [TT][L]
  uint32_t* s_out = reinterpret_cast<uint32_t*>(s_tw + TT * L);  // words [TT][OS]

  const Tile tl_ = load_tile(a.tiles, blockIdx.y);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_words = (a.n_loc + 31) >> 5;  // the bitmap's n_loc is a multiple of 32
  const int w0 = blockIdx.x * PW;
  const int n_w = min(PW, n_words - w0);  // the last block of a tile may hold fewer
  const int row = w0 * 32 + tid;          // local row
  const long long r = static_cast<long long>(tl_.sub_pos) * a.n_loc + row;
  const bool act = row < a.n_loc && a.active[r];
  const long long col0 = static_cast<long long>(tl_.sub_i) * n_words + w0;
  // the matrix's column of the block's first row, and its rows
  const long long r0 = static_cast<long long>(tl_.sub_i) * a.n_loc + w0 * 32;
  const int n_rows = min(PT, a.n_loc - w0 * 32);
  const long long t_src = static_cast<long long>(tl_.dp_pos) * a.b_loc;
  const long long t_dst = static_cast<long long>(tl_.dp_i) * a.b_loc;

  if (!__syncthreads_or(act)) {  // a dead block: no topic evaluated
    // its zeros
    if constexpr (FORM == BITMAP) store_runs(a, t_dst, col0, a.b_loc, n_w, nullptr);
    if constexpr (FORM == BYTES) store_bytes(a, t_dst, r0, a.b_loc, n_rows, nullptr);
    return;
  }
  const bool live_word = __ballot_sync(EMQX_FULL_MASK, act) != 0u;  // warp-uniform
  RegRow rr;
  if (act) {
    load_reg_row(rr, a.words, a.plen, a.has_hash, a.root_wild, r, L, a.vec);
  } else {
    rr.win = RowWindow{0x7fffffff, 0u, 0};  // admits no topic
    rr.w0 = -1;
  }

  for (int t0 = 0; t0 < a.b_loc; t0 += TT) {
    const int nt = min(TT, a.b_loc - t0);
    const long long tb = t_src + t0;
    // stage the tile's topics; those past nt get the header -1, which no
    // row's window admits
    for (int e = tid; e < nt * L; e += PT) s_tw[e] = a.t_ids[tb * L + e];
    for (int t = tid; t < TT; t += PT)
      s_th[t] = t < nt ? make_int2(topic_header(a.t_len[tb + t], a.t_dollar[tb + t]),
                                   a.t_ids[(tb + t) * L])
                       : make_int2(-1, 0);
    __syncthreads();  // topics staged; the previous tile's runs are read out
    if (live_word) {
      for (int g = 0; g < nt; g += TG) {
        unsigned q = 0;
#pragma unroll
        for (int k = 0; k < TG; ++k) {
          const int2 th = s_th[g + k];
          q |= static_cast<unsigned>(quick(th.x, th.y, rr)) << k;
        }
        unsigned through = __reduce_or_sync(EMQX_FULL_MASK, q);
        unsigned mine = 0u;  // lane k: the word (or its popcount) of topic g + k
        while (through != 0u) {  // warp-uniform
          const int k = __ffs(through) - 1;
          through &= through - 1;
          const bool ok = (q >> k & 1u) && rest(s_tw + (g + k) * L, rr);
          const unsigned m = __ballot_sync(EMQX_FULL_MASK, ok);
          mine = lane == k ? (FORM == COUNTS ? __popc(m) : m) : mine;
        }
        if (lane < TG) s_out[(g + lane) * OS + warp] = mine;
      }
    } else {
      for (int t = lane; t < nt; t += 32) s_out[t * OS + warp] = 0u;
    }
    __syncthreads();  // the buffer is whole; the tile's topics are done with
    if constexpr (FORM == COUNTS) {
      add_counts(a, t_dst + t0, nt, s_out);
    } else if constexpr (FORM == BYTES) {
      store_bytes(a, t_dst + t0, r0, nt, n_rows, s_out);
    } else {
      store_runs(a, t_dst + t0, col0, nt, n_w, s_out);
    }
  }
}

template <int FORM>
int launch(const PackedArgs& a, int n_tiles, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.L);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(packed_pass<FORM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         int(smem));
  const dim3 grid(ceil_div(ceil_div(a.n_loc, 32), PW), n_tiles);
  packed_pass<FORM><<<grid, PT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K10 (tiles null, n_tiles 1: the one tile (0, 0, 0, 0)) and K13 packed
// (the n_tiles tiles of this device, tiles [n_tiles, 4]): out is uint32
// [B, out_w], every word of each tile's block written (n_loc a multiple
// of 32). Returns cudaGetLastError(); cudaErrorInvalidValue for a row
// count that is not a multiple of 32.
extern "C" int emqx_match_packed(const int* words, const int* plen,
                                 const uint8_t* has_hash, const uint8_t* root_wild,
                                 const uint8_t* active, int n_loc, int L,
                                 const int* t_ids, const int* t_len,
                                 const uint8_t* t_dollar, int b_loc,
                                 const int* tiles, int n_tiles, uint32_t* out,
                                 long long out_w, cudaStream_t stream) {
  if (n_loc % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_loc == 0 || b_loc == 0 || n_tiles == 0) return static_cast<int>(cudaGetLastError());
  PackedArgs a{words, plen, has_hash, root_wild, active, n_loc, L,
               reinterpret_cast<uintptr_t>(words) % 16 == 0 && L % 4 == 0,
               t_ids, t_len, t_dollar, b_loc, tiles, out, out_w,
               reinterpret_cast<uintptr_t>(out) % 16 == 0 && out_w % 4 == 0 &&
                   (n_loc / 32) % 4 == 0};
  return launch<BITMAP>(a, n_tiles, stream);
}

// K11 (tiles null, n_tiles 1) and K13 counts (the n_tiles tiles of this
// device): out is int32 [out_len], zeroed here first (the wrappers
// allocate it uninitialised), then each tile adds its rows' counts of
// topic t at out[dp_i * b_loc + t]. Any n_loc: the rows past it in the
// last word are inactive. Returns the memset's error or
// cudaGetLastError().
extern "C" int emqx_match_counts(const int* words, const int* plen,
                                 const uint8_t* has_hash, const uint8_t* root_wild,
                                 const uint8_t* active, int n_loc, int L,
                                 const int* t_ids, const int* t_len,
                                 const uint8_t* t_dollar, int b_loc,
                                 const int* tiles, int n_tiles, int* out,
                                 long long out_len, cudaStream_t stream) {
  if (out_len > 0) {
    const cudaError_t e = cudaMemsetAsync(out, 0, sizeof(int) * out_len, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (n_loc == 0 || b_loc == 0 || n_tiles == 0) return static_cast<int>(cudaGetLastError());
  PackedArgs a{words, plen, has_hash, root_wild, active, n_loc, L,
               reinterpret_cast<uintptr_t>(words) % 16 == 0 && L % 4 == 0,
               t_ids, t_len, t_dollar, b_loc, tiles, reinterpret_cast<uint32_t*>(out),
               0, false};
  return launch<COUNTS>(a, n_tiles, stream);
}

// K9: out is bool [b, n], every byte written (0 or 1). One tile (the
// whole table and batch: K9 has no mesh caller). Any n: the rows past
// it in the last word are inactive and never written. The stores are
// 16 bytes when out is 16-byte aligned and n % 16 == 0, else a byte at a
// time. Returns cudaGetLastError().
extern "C" int emqx_match_dense(const int* words, const int* plen,
                                const uint8_t* has_hash, const uint8_t* root_wild,
                                const uint8_t* active, int n, int L,
                                const int* t_ids, const int* t_len,
                                const uint8_t* t_dollar, int b, uint8_t* out,
                                cudaStream_t stream) {
  if (n == 0 || b == 0) return static_cast<int>(cudaGetLastError());
  PackedArgs a{words, plen, has_hash, root_wild, active, n, L,
               reinterpret_cast<uintptr_t>(words) % 16 == 0 && L % 4 == 0,
               t_ids, t_len, t_dollar, b, nullptr, reinterpret_cast<uint32_t*>(out), n,
               reinterpret_cast<uintptr_t>(out) % 16 == 0 && n % 16 == 0};
  return launch<BYTES>(a, 1, stream);
}
