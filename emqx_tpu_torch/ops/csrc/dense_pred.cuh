// The dense match predicate (emqx_tpu/ops/match.py `_match_block`), once,
// for every kernel that evaluates it: K2 and K16 (dense_match.cu) and the
// dense forms K9-K11 (dense_forms.cu). Keeping it here means they cannot
// drift apart.
//
//   ok[b, n] = active[n] & ~(dollar[b] & root_wild[n])
//            & (has_hash[n] ? len[b] >= plen[n] : len[b] == plen[n])
//            & all_{i < plen[n]} (words[n, i] == PLUS | words[n, i] == ids[b, i])
//
// The kernels stage a warp's 32 consecutive rows in shared memory,
// transposed, so lane l reads level i of its own row at rw[i * 32 + l]
// (conflict-free), and hold a tile of topics in shared memory too.
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

struct Tile {
  int dp_i, sub_i, dp_pos, sub_pos;
};

__device__ __forceinline__ Tile load_tile(const int* __restrict__ tiles, int k) {
  if (tiles == nullptr) return Tile{0, 0, 0, 0};
  return Tile{tiles[4 * k], tiles[4 * k + 1], tiles[4 * k + 2], tiles[4 * k + 3]};
}

// Stage rows [row0, row0 + 32) of words [*, L] (rows at or past row_end
// read as 0) into rw, transposed: rw[i * 32 + r] = words[row0 + r, i].
// Every lane of the warp calls it.
__device__ __forceinline__ void stage_warp_rows(int* __restrict__ rw,
                                                const int* __restrict__ words,
                                                long long row0, long long row_end,
                                                int L, int lane) {
  for (int e = lane; e < 32 * L; e += 32) {
    const int r = e / L, i = e - r * L;
    const long long g = row0 + r;
    rw[i * 32 + r] = g < row_end ? words[g * L + i] : 0;
  }
  __syncwarp();
}

// The predicate for one live row (active checked by the caller): topic
// length tl, $-flag td, words tw[L]; the row's plen, has_hash, root_wild
// and its staged words rw[i * 32].
__device__ __forceinline__ bool dense_pred(int tl, bool td, const int* tw, int pl,
                                           bool hh, bool rw_flag,
                                           const int* rw, int L) {
  if (!(hh ? tl >= pl : tl == pl) || (td && rw_flag)) return false;
  const int lim = min(pl, L);
  for (int i = 0; i < lim; ++i) {
    const int w = rw[i * 32];
    if (w != DENSE_PLUS && w != tw[i]) return false;
  }
  return true;
}
