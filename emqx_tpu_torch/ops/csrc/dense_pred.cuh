// The dense match predicate (emqx_tpu/ops/match.py `_match_block`), once,
// for every kernel that evaluates it: K2 and K16 (dense_match.cu), and
// the three dense forms, the matrix K9, the bitmap K10 and the counts K11
// (packed_match.cu). Keeping it here means they cannot drift apart.
//
//   ok[b, n] = active[n] & ~(dollar[b] & root_wild[n])
//            & (has_hash[n] ? len[b] >= plen[n] : len[b] == plen[n])
//            & all_{i < plen[n]} (words[n, i] == PLUS | words[n, i] == ids[b, i])
//
// in two parts, each defined once below:
//   * the head: a topic is the header hdr = (len << 1) | dollar, a row
//     the window (lo, span, rwm) of `row_window`; the length and $-root
//     rules hold iff hdr - lo <= span (unsigned) and !(hdr & rwm);
//   * the levels: `level_ok` for each i < min(plen, L).
//
// A row's words are held in registers: each thread gathers one live row
// by id (`RegRow`), its first REG_LEVELS levels in registers, deeper
// levels read from the table when a row has them. Its `quick` test is
// the head and level 0 -- branch-free, a few integer operations, and
// what rejects almost every pair -- and `rest` the levels after 0. The
// kernels hold a tile of topics in shared memory (broadcast reads).
//
// A tile is one (dp, sub) shard pair of a mesh: the kernels read the
// tile's local rows and topics and write global ids. tiles[k] holds
// (dp_i, sub_i, dp_pos, sub_pos): the shard's mesh coordinates and its
// position inside this device's tensors (the shards a device holds are
// stored back to back, in axis order). One device and no mesh is the
// tile (0, 0, 0, 0), passed as a null tiles pointer.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#ifndef EMQX_FULL_MASK
#define EMQX_FULL_MASK 0xFFFFFFFFu
#endif

constexpr int DENSE_PLUS = 1;  // vocab id of '+'
constexpr int REG_LEVELS = 16;  // levels of a register row

struct Tile {
  int dp_i, sub_i, dp_pos, sub_pos;
};

__device__ __forceinline__ Tile load_tile(const int* __restrict__ tiles, int k) {
  if (tiles == nullptr) return Tile{0, 0, 0, 0};
  return Tile{tiles[4 * k], tiles[4 * k + 1], tiles[4 * k + 2], tiles[4 * k + 3]};
}

// --- the predicate ----------------------------------------------------------

__device__ __forceinline__ int topic_header(int len, bool dollar) {
  return (len << 1) | (dollar ? 1 : 0);
}

struct RowWindow {
  int lo;        // 2 * plen
  unsigned span;  // 1 (len == plen: hdr is 2 plen or 2 plen + 1), or any (len >= plen)
  int rwm;       // 1 when a $-topic (hdr & 1) may not match: the root is wild
};

__device__ __forceinline__ RowWindow row_window(int pl, bool hh, bool root_wild) {
  return RowWindow{2 * pl, hh ? 0x7fffffffu : 1u, root_wild ? 1 : 0};
}

// The length and $-root rules.
__device__ __forceinline__ bool head_ok(int hdr, const RowWindow& w) {
  return static_cast<unsigned>(hdr - w.lo) <= w.span && !(hdr & w.rwm);
}

// One level: the row's word w against the topic's t.
__device__ __forceinline__ bool level_ok(int w, int t) {
  return w == DENSE_PLUS || w == t;
}

// --- register rows --------------------------------------------------------

struct RegRow {
  int w[REG_LEVELS];  // levels 0 .. REG_LEVELS - 1 (0 past L)
  const int* src;     // the row in the table, for levels >= REG_LEVELS
  int lim;            // levels to compare: min(plen, L)
  RowWindow win;
  int w0;             // level 0 to match, or -1: any (no level, or '+')
};

// Gather row r of the table. vec: words is 16-byte aligned and L a
// multiple of 4, so each group of 4 levels is one 16-byte load.
__device__ __forceinline__ void load_reg_row(RegRow& row, const int* __restrict__ words,
                                             const int* __restrict__ plen,
                                             const uint8_t* __restrict__ has_hash,
                                             const uint8_t* __restrict__ root_wild,
                                             long long r, int L, bool vec) {
  const int* src = words + r * L;
  row.src = src;
#pragma unroll
  for (int q = 0; q < REG_LEVELS / 4; ++q) {
    if (vec && 4 * q < L) {
      const int4 v = reinterpret_cast<const int4*>(src)[q];
      row.w[4 * q] = v.x;
      row.w[4 * q + 1] = v.y;
      row.w[4 * q + 2] = v.z;
      row.w[4 * q + 3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) row.w[4 * q + j] = 4 * q + j < L ? src[4 * q + j] : 0;
    }
  }
  const int pl = plen[r];
  row.lim = min(pl, L);
  row.win = row_window(pl, has_hash[r], root_wild[r]);
  row.w0 = row.lim == 0 || row.w[0] == DENSE_PLUS ? -1 : row.w[0];
}

// The head and level 0 of topic (hdr, tw0).
__device__ __forceinline__ bool quick(int hdr, int tw0, const RegRow& row) {
  return head_ok(hdr, row.win) && (row.w0 < 0 || row.w0 == tw0);
}

// Levels 1 .. lim - 1 against the topic's words tw.
__device__ __forceinline__ bool rest(const int* tw, const RegRow& row) {
#pragma unroll
  for (int i = 1; i < REG_LEVELS; ++i) {
    if (i >= row.lim) return true;
    if (!level_ok(row.w[i], tw[i])) return false;
  }
  for (int i = REG_LEVELS; i < row.lim; ++i)
    if (!level_ok(row.src[i], tw[i])) return false;
  return true;
}
