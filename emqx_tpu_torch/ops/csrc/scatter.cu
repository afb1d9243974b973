// K3/K4: in-place delta scatters that keep the device tables in step
// with route churn.
//
// Replace emqx_tpu/models/router.py `_scatter_rows` (K3: the five
// filter-table columns at [nb, K] padded row ids) and `_scatter_slots`
// (K4: cuckoo fp/bucket at slot ids, probe words at slot // 4). The JAX
// programs donate their buffers and scan over the nb batches; here the
// device tensors are updated in place by one launch over all nb*K
// entries.
//
// Write order: the host drains dirty ids with np.unique, so real ids are
// distinct; the only repeats are the padding, which repeats the last id
// with the same values (ops/table.py pad_pow2_batches), and probe words
// of slots that share a bucket, which carry the same host-merged word.
// Every writer of one address writes the same value, so whichever
// writer lands last is correct. Ids outside the table are dropped, as
// JAX drops out-of-range scatter updates.
//
// What bounds it on the H100: a sync of ~2,000 dirty rows moves ~150 KB,
// far below a microsecond of HBM time, so the launch itself dominates;
// one thread per written word keeps the stores coalesced on the source
// side.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void scatter_rows_k(int* __restrict__ words, int* __restrict__ plen,
                               uint8_t* __restrict__ has_hash,
                               uint8_t* __restrict__ root_wild,
                               uint8_t* __restrict__ active, int N, int L,
                               const int* __restrict__ rows,
                               const int* __restrict__ w,
                               const int* __restrict__ p,
                               const uint8_t* __restrict__ h,
                               const uint8_t* __restrict__ rw,
                               const uint8_t* __restrict__ act, long long n) {
  const long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= n * L) return;
  const long long e = k / L;
  const int i = static_cast<int>(k - e * L);
  const int row = rows[e];
  if (row < 0 || row >= N) return;
  words[static_cast<size_t>(row) * L + i] = w[k];
  if (i == 0) {
    plen[row] = p[e];
    has_hash[row] = h[e];
    root_wild[row] = rw[e];
    active[row] = act[e];
  }
}

__global__ void scatter_slots_k(uint32_t* __restrict__ fp, int* __restrict__ bucket,
                                uint32_t* __restrict__ probe, int n_slots,
                                const int* __restrict__ idx,
                                const uint32_t* __restrict__ f,
                                const int* __restrict__ b,
                                const uint32_t* __restrict__ pw, long long n) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int s = idx[e];
  if (s < 0 || s >= n_slots) return;
  fp[s] = f[e];
  bucket[s] = b[e];
  probe[s / 4] = pw[e];
}

}  // namespace

// n = nb * K entries. Returns cudaGetLastError().
extern "C" int emqx_scatter_rows(int* words, int* plen, uint8_t* has_hash,
                                 uint8_t* root_wild, uint8_t* active, int N,
                                 int L, const int* rows, const int* w,
                                 const int* p, const uint8_t* h,
                                 const uint8_t* rw, const uint8_t* act,
                                 long long n, cudaStream_t stream) {
  const long long total = n * L;
  if (total > 0) {
    const int blocks = static_cast<int>((total + 255) / 256);
    scatter_rows_k<<<blocks, 256, 0, stream>>>(words, plen, has_hash, root_wild,
                                               active, N, L, rows, w, p, h, rw,
                                               act, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int emqx_scatter_slots(uint32_t* fp, int* bucket, uint32_t* probe,
                                  int n_slots, const int* idx, const uint32_t* f,
                                  const int* b, const uint32_t* pw, long long n,
                                  cudaStream_t stream) {
  if (n > 0) {
    const int blocks = static_cast<int>((n + 255) / 256);
    scatter_slots_k<<<blocks, 256, 0, stream>>>(fp, bucket, probe, n_slots, idx,
                                                f, b, pw, n);
  }
  return static_cast<int>(cudaGetLastError());
}
