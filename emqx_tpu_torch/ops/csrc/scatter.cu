// K3/K4/K6/K7 and the mesh's K13 apply_delta/K18: in-place delta scatters
// that keep the device tables in step with route and subscription churn.
//
// Replace emqx_tpu/models/router.py `_scatter_rows` (K3: the five
// filter-table columns at [nb, K] padded row ids) and `_scatter_slots`
// (K4: cuckoo fp/bucket at slot ids, probe words at slot // 4), and
// emqx_tpu/ops/fanout.py `_scatter_segs` (K6: seg_off/seg_len at row
// ids) and `_scatter_edges` (K7: edge_client/edge_opts at edge ids).
// The JAX programs donate their buffers and scan over the nb batches;
// here the device tensors are updated in place by one launch over all
// entries.
//
// K3 and K4 are one kernel, `emqx_table_sync`: a DeviceTable's whole
// delta sync in one launch. Threads [0, n_r * L) write filter rows, one
// thread a (row, level) word; the word-0 thread of a row also writes its
// prefix_len, has_hash, root_wild and active, and its residual-mask byte
// where a residual column is given (a null pointer leaves the mask
// alone). The next n_s threads write cuckoo slots: fp, bucket and the
// slot's probe word. DeviceTable.sync stages its delta as one byte
// buffer [rows | prefix_len | has_hash | root_wild | active | residual |
// pad to 16 B | words (n_r x L) | slots | fp | bucket | probe] in one
// host->device copy and passes each column as a pointer into it; the
// residual column carries the mask's changes, since a row's residual
// flag changes only when the row is added or removed, and such a row is
// always in the delta. The reference-shaped wrappers scatter_rows /
// scatter_slots pass their own [nb, K] batches with the other side
// empty and no residual column.
//
// K6 and K7 are one kernel, `emqx_fanout_sync`: a fanout mirror's whole
// delta sync in one launch. Threads [0, n_r) write segment rows, threads
// [n_r, n_r + n_e) write edges, as `mesh_table_sync_k` below fuses the
// mesh's two streams. FanoutDeviceState.sync stages its delta as one
// int32 buffer [ridx n_r | roff n_r | rlen n_r | eidx n_e | ecl n_e | eop
// n_e] in one host->device copy, and passes the six columns as pointers
// into it;
// the reference-shaped wrappers scatter_segs/scatter_edges pass their
// own [nb, K] batches with the other side empty.
//
// Both syncs stage with no pow2 padding (CUDA has no recompile to
// bound), and nothing dirty launches nothing. A sync's ids come from
// np.unique: sorted and distinct, so neighbouring threads load
// neighbouring words and, along a run of consecutive ids, store to
// neighbouring addresses.
//
// Write order: real ids are distinct; the only repeats are the padding
// of the [nb, K] batches, which repeats the last id with the same values
// (ops/table.py pad_pow2_batches), and probe words of slots that share
// a bucket, which carry the same host-merged word. Every writer of one
// address writes the same value, so whichever writer lands last is
// correct. Ids outside a table are dropped, as JAX drops out-of-range
// scatter updates: a row id past N, a slot id past n_slots and with it
// its probe word.
//
// What bounds it on the H100: a fanout sync moves 20 bytes an entry (an
// id and two values read, two values written), so phase 7's delta of a
// few hundred entries is a few KB, nanoseconds of HBM time, and only a
// delta of ~300k entries or more (6 MB, 2 us at 3.35 TB/s) outweighs the
// launch's own floor (~2 us, K12 on a scalar); a table sync of ~1,250
// dirty rows and ~1,300 slots (~150 KB) is the same. So one launch a
// sync, from one staged copy, is the lever; one thread per entry keeps
// the loads coalesced.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// threads a block of the fused fanout sync: at phase 7's churn delta (34
// entries, one CTA either way) 256 read 1.6-6% faster than 128 on an H100
// 80GB HBM3 at 700 W (tools/wrapper_ab.py against a 128-thread variant,
// two calls); 128 read 7-9% faster at 1,024-2,000 entries and 1% on a
// full-pool delta. Phase 7's median sync is 64 entries.
constexpr int kSyncThreads = 256;

__global__ void fanout_sync_k(int* __restrict__ seg_off, int* __restrict__ seg_len,
                              int n_rows_cap, int* __restrict__ edge_client,
                              int* __restrict__ edge_opts, int n_edge_cap,
                              const int* __restrict__ ridx,
                              const int* __restrict__ roff,
                              const int* __restrict__ rlen, long long n_r,
                              const int* __restrict__ eidx,
                              const int* __restrict__ ecl,
                              const int* __restrict__ eop, long long n_e) {
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q < n_r) {
    const int i = ridx[q];
    if (i < 0 || i >= n_rows_cap) return;
    seg_off[i] = roff[q];
    seg_len[i] = rlen[q];
  } else if (q < n_r + n_e) {
    const long long e = q - n_r;
    const int i = eidx[e];
    if (i < 0 || i >= n_edge_cap) return;
    edge_client[i] = ecl[e];
    edge_opts[i] = eop[e];
  }
}

// threads a block of the table sync: at phase 5's churn delta (1,247
// rows of 16 levels and 1,284 slots, ~88 CTAs of 256) 256 read 2.4%
// faster than 128 and 22% faster than 512 on an H100 80GB HBM3 at 700 W
// (tools/wrapper_ab.py against variants, one call); 128 read 11% faster
// at twice that delta.
constexpr int kTableThreads = 256;

__global__ void table_sync_k(int* __restrict__ words, int* __restrict__ plen,
                             uint8_t* __restrict__ has_hash,
                             uint8_t* __restrict__ root_wild,
                             uint8_t* __restrict__ active,
                             uint8_t* __restrict__ residual, int N, int L,
                             uint32_t* __restrict__ fp, int* __restrict__ bucket,
                             uint32_t* __restrict__ probe, int n_slots,
                             const int* __restrict__ rows, const int* __restrict__ w,
                             const int* __restrict__ p, const uint8_t* __restrict__ h,
                             const uint8_t* __restrict__ rw,
                             const uint8_t* __restrict__ act,
                             const uint8_t* __restrict__ res, long long n_r,
                             const int* __restrict__ sidx,
                             const uint32_t* __restrict__ f,
                             const int* __restrict__ b,
                             const uint32_t* __restrict__ pw, long long n_s) {
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nw = n_r * L;
  if (q < nw) {
    const long long e = q / L;
    const int i = static_cast<int>(q - e * L);
    const int row = rows[e];
    if (row < 0 || row >= N) return;
    words[static_cast<long long>(row) * L + i] = w[q];
    if (i == 0) {
      plen[row] = p[e];
      has_hash[row] = h[e];
      root_wild[row] = rw[e];
      active[row] = act[e];
      if (res != nullptr) residual[row] = res[e];
    }
  } else if (q < nw + n_s) {
    const long long e = q - nw;
    const int s = sidx[e];
    if (s < 0 || s >= n_slots) return;
    fp[s] = f[e];
    bucket[s] = b[e];
    probe[s / 4] = pw[e];
  }
}

}  // namespace

// A DeviceTable's delta sync: for e < n_r, row rows[e] of the filter
// table takes words w[e * L .. e * L + L), prefix_len p[e], the bools
// h/rw/act[e] and, when res is not null, residual[row] = res[e]; for
// e < n_s, slot sidx[e] takes fp f[e], bucket b[e] and its probe word
// probe[sidx[e] / 4] = pw[e]. One launch, none when both sides are empty.
// Returns cudaGetLastError().
extern "C" int emqx_table_sync(int* words, int* plen, uint8_t* has_hash,
                               uint8_t* root_wild, uint8_t* active, uint8_t* residual,
                               int N, int L, uint32_t* fp, int* bucket, uint32_t* probe,
                               int n_slots, const int* rows, const int* w, const int* p,
                               const uint8_t* h, const uint8_t* rw, const uint8_t* act,
                               const uint8_t* res, long long n_r, const int* sidx,
                               const uint32_t* f, const int* b, const uint32_t* pw,
                               long long n_s, cudaStream_t stream) {
  const long long n = n_r * L + n_s;
  if (n > 0) {
    const int blocks = static_cast<int>((n + kTableThreads - 1) / kTableThreads);
    table_sync_k<<<blocks, kTableThreads, 0, stream>>>(
        words, plen, has_hash, root_wild, active, residual, N, L, fp, bucket, probe,
        n_slots, rows, w, p, h, rw, act, res, n_r, sidx, f, b, pw, n_s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The fanout mirror's delta sync: seg_off/seg_len[ridx[q]] = roff/rlen[q]
// for q < n_r, edge_client/edge_opts[eidx[e]] = ecl/eop[e] for e < n_e,
// in one launch (none when both sides are empty). Returns
// cudaGetLastError().
extern "C" int emqx_fanout_sync(int* seg_off, int* seg_len, int n_rows_cap,
                                int* edge_client, int* edge_opts, int n_edge_cap,
                                const int* ridx, const int* roff, const int* rlen,
                                long long n_r, const int* eidx, const int* ecl,
                                const int* eop, long long n_e, cudaStream_t stream) {
  const long long n = n_r + n_e;
  if (n > 0) {
    const int blocks = static_cast<int>((n + kSyncThreads - 1) / kSyncThreads);
    fanout_sync_k<<<blocks, kSyncThreads, 0, stream>>>(
        seg_off, seg_len, n_rows_cap, edge_client, edge_opts, n_edge_cap, ridx, roff,
        rlen, n_r, eidx, ecl, eop, n_e);
  }
  return static_cast<int>(cudaGetLastError());
}

// --- the mesh's owned table sync ----------------------------------------------
//
// K13's `apply_delta` (emqx_tpu/parallel/sharded_match.py
// `make_sharded_kernels`), K18's `make_slot_delta_kernel` and
// `make_mesh_sync_kernel` are one kernel, `emqx_mesh_table_sync`: a
// ShardedDeviceTable's whole delta sync on one device group in one launch.
// The reference sends every shard the same batch of GLOBAL ids and lets
// each drop what it does not own; here each entry's owner is computed,
// one thread an owned word. Filter row r belongs to sub shard s = r /
// local_n, cuckoo slot i and its probe word i / 4 both to s = i / n_loc
// (n_loc = nb_loc * 4: shards are bucket-aligned). A group keeps the
// shards it holds back to back, shard s at position k = sub_pos[s]: row r
// lands at k * local_n + (r - s * local_n), slot i at k * n_loc + (i - s
// * n_loc), its probe word at k * nb_loc + (i / 4 - s * nb_loc); a group
// that holds every shard in order (the only layout on one card) has the
// identity map, and every id lands at itself. An id below 0, past the n_sub
// shards, or owned by a shard the group does not hold is dropped, as the
// reference's mode='drop' (with its clamp of negative indices) drops it
// on every shard.
//
// Threads [0, n_r * L) write filter rows, one thread a (row, level) word;
// the word-0 thread of a row also writes its prefix_len, has_hash,
// root_wild and active, and its residual-mask byte where a residual
// column is given (a null pointer leaves the mask alone). The next n_s
// threads write slots: fp, bucket and the probe word. ShardedDeviceTable
// stages its delta as DeviceTable does (ops/delta.py, one buffer, one
// copy a group) and passes each column as a pointer into it; the
// reference-shaped wrappers pass their own [nb, K] batches with the other
// side empty and no residual column.
//
// Write order: staged ids are distinct; the [nb, K] batches' padding
// repeats the last id with the same values, and the probe words of slots
// that share a bucket carry the same host-merged word. Every writer of
// one address writes the same value, so the order does not change the
// result. Bounded like the table sync: a churn delta moves ~150 KB, so
// one launch a sync is the lever, and one thread an owned entry (not one
// a held shard, each walking the whole delta) keeps the grid to the
// delta's size.

namespace {

// threads a block of the mesh table sync (the table sync's choice)
constexpr int kMeshThreads = 256;

__global__ void mesh_table_sync_k(int* __restrict__ words, int* __restrict__ plen,
                                  uint8_t* __restrict__ has_hash,
                                  uint8_t* __restrict__ root_wild,
                                  uint8_t* __restrict__ active,
                                  uint8_t* __restrict__ residual, int local_n, int L,
                                  uint32_t* __restrict__ fp, int* __restrict__ bucket,
                                  uint32_t* __restrict__ probe, int nb_loc,
                                  const int* __restrict__ sub_pos, int n_sub,
                                  const int* __restrict__ rows, const int* __restrict__ w,
                                  const int* __restrict__ p,
                                  const uint8_t* __restrict__ h,
                                  const uint8_t* __restrict__ rw,
                                  const uint8_t* __restrict__ act,
                                  const uint8_t* __restrict__ res, long long n_r,
                                  const int* __restrict__ sidx,
                                  const uint32_t* __restrict__ f,
                                  const int* __restrict__ b,
                                  const uint32_t* __restrict__ pw, long long n_s) {
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nw = n_r * L;
  if (q < nw) {
    const long long e = q / L;
    const int i = static_cast<int>(q - e * L);
    const int row = rows[e];
    if (row < 0) return;
    const int s = row / local_n;
    if (s >= n_sub) return;
    const int k = sub_pos[s];
    if (k < 0) return;
    const long long dst = static_cast<long long>(k) * local_n + (row - s * local_n);
    words[dst * L + i] = w[q];
    if (i == 0) {
      plen[dst] = p[e];
      has_hash[dst] = h[e];
      root_wild[dst] = rw[e];
      active[dst] = act[e];
      if (res != nullptr) residual[dst] = res[e];
    }
  } else if (q < nw + n_s) {
    const long long e = q - nw;
    const int slot = sidx[e];
    if (slot < 0) return;
    const int n_loc = nb_loc * 4;
    const int s = slot / n_loc;
    if (s >= n_sub) return;
    const int k = sub_pos[s];
    if (k < 0) return;
    const long long ds = static_cast<long long>(k) * n_loc + (slot - s * n_loc);
    const long long db = static_cast<long long>(k) * nb_loc + (slot / 4 - s * nb_loc);
    fp[ds] = f[e];
    bucket[ds] = b[e];
    probe[db] = pw[e];
  }
}

}  // namespace

// A mesh device group's delta sync: for e < n_r, global row rows[e] takes
// words w[e * L .. e * L + L), prefix_len p[e], the bools h/rw/act[e] and,
// when res is not null, its residual byte res[e]; for e < n_s, global slot
// sidx[e] takes fp f[e], bucket b[e] and its probe word pw[e]; each at its
// owner shard's position in the group (sub_pos[s], -1 for a shard it
// does not hold), ids the group does not own dropped. local_n is rows a shard,
// nb_loc probe words a shard (pass 1 for an empty side). One launch, none
// when both sides are empty. Returns cudaGetLastError().
extern "C" int emqx_mesh_table_sync(int* words, int* plen, uint8_t* has_hash,
                                    uint8_t* root_wild, uint8_t* active,
                                    uint8_t* residual, int local_n, int L, uint32_t* fp,
                                    int* bucket, uint32_t* probe, int nb_loc,
                                    const int* sub_pos, int n_sub, const int* rows,
                                    const int* w, const int* p, const uint8_t* h,
                                    const uint8_t* rw, const uint8_t* act,
                                    const uint8_t* res, long long n_r, const int* sidx,
                                    const uint32_t* f, const int* b, const uint32_t* pw,
                                    long long n_s, cudaStream_t stream) {
  const long long n = n_r * L + n_s;
  if (n > 0) {
    const int blocks = static_cast<int>((n + kMeshThreads - 1) / kMeshThreads);
    mesh_table_sync_k<<<blocks, kMeshThreads, 0, stream>>>(
        words, plen, has_hash, root_wild, active, residual, local_n, L, fp, bucket,
        probe, nb_loc, sub_pos, n_sub, rows, w, p, h, rw, act, res, n_r, sidx, f, b, pw,
        n_s);
  }
  return static_cast<int>(cudaGetLastError());
}
