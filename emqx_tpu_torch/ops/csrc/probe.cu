// K12: the add-one dispatch of the link probe.
//
// Replaces the jitted `triv(x) = x + 1` inside emqx_tpu/ops/transfer.py
// `probe_link`: one float32 scalar round trip gives the launch +
// transfer floor (RTT), and the same kernel over a 1 MB int32 buffer
// gives the device->host fetch rate. The dispatch engine sizes its
// transfer chunk (the cap on compacted result buffers) from the two.
//
// What bounds it on the H100: for the scalar, nothing on the card --
// the round trip is launch latency plus two PCIe transfers; for the
// 1 MB buffer, 2 MB of HBM traffic (~0.6 us at 3.35 TB/s), below the
// launch itself, so the fetch leg measures the link, as intended.
//
// Design: 16-byte accesses (int4 / float4) over the aligned body, one
// a thread, a scalar head up to the first 16-byte boundary and a scalar
// tail (the whole range scalar when input and output are misaligned to
// each other), grid-stride over at most 4 blocks per SM, 32-bit index
// arithmetic below 2^31 elements; a lone warp for a scalar. (Four
// vectors in flight per thread measured no faster at 1 MB or 64 MB on
// an H100 80GB HBM3 at 700 W, and slower at an odd length.) The wrapper
// reads the current stream through torch's raw accessor: building a
// torch.cuda.Stream object cost more host time than the launch.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// y = x + 1: n_vec 16-byte vectors from element `head` on; the scalars
// before them (head) and after them, grid-stride. Index is int when every
// element index fits, which keeps the index arithmetic 32-bit.
template <typename T, typename V, typename Index>
__global__ void __launch_bounds__(THREADS)
add_one_k(const T* __restrict__ x, T* __restrict__ y, Index n, Index head, Index n_vec) {
  const T one = static_cast<T>(1);
  const Index threads = static_cast<Index>(gridDim.x) * blockDim.x;
  const Index i0 = static_cast<Index>(blockIdx.x) * blockDim.x + threadIdx.x;
  const V* __restrict__ xv = reinterpret_cast<const V*>(x + head);
  V* __restrict__ yv = reinterpret_cast<V*>(y + head);
  for (Index i = i0; i < n_vec; i += threads) {
    V v = xv[i];
    v.x += one;
    v.y += one;
    v.z += one;
    v.w += one;
    yv[i] = v;
  }
  for (Index i = i0; i < head; i += threads) y[i] = x[i] + one;
  for (Index i = head + 4 * n_vec + i0; i < n; i += threads) y[i] = x[i] + one;
}

int max_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    blocks = 4 * (sms > 0 ? sms : 132);
  }
  return blocks;
}

template <typename T, typename V>
void launch(const void* xp, void* yp, long long n, cudaStream_t stream) {
  const auto xa = reinterpret_cast<uintptr_t>(xp), ya = reinterpret_cast<uintptr_t>(yp);
  long long head = n, n_vec = 0;
  if (xa % 16 == ya % 16) {
    head = static_cast<long long>((16 - xa % 16) % 16 / sizeof(T));
    if (head > n) head = n;
    n_vec = (n - head) / 4;
  }
  // one thread a vector, or a scalar where no vector is left (at most 3
  // each side unless x and y are misaligned to each other); a lone warp
  // for a handful of scalars
  const long long work = n_vec > n - 4 * n_vec ? n_vec : n - 4 * n_vec;
  const int threads = work < THREADS ? 32 : THREADS;
  const long long want = (work + threads - 1) / threads;
  const int blocks = static_cast<int>(want < max_blocks() ? want : max_blocks());
  if (n < (1LL << 31) - THREADS * static_cast<long long>(max_blocks())) {
    add_one_k<T, V, int><<<blocks, threads, 0, stream>>>(
        static_cast<const T*>(xp), static_cast<T*>(yp), static_cast<int>(n),
        static_cast<int>(head), static_cast<int>(n_vec));
  } else {
    add_one_k<T, V, long long><<<blocks, threads, 0, stream>>>(
        static_cast<const T*>(xp), static_cast<T*>(yp), n, head, n_vec);
  }
}

}  // namespace

// y = x + 1 over n float32 (is_float != 0) or int32 elements.
// Returns cudaGetLastError().
extern "C" int emqx_add_one(const void* x, void* y, long long n, int is_float,
                            cudaStream_t stream) {
  if (n > 0) {
    if (is_float) {
      launch<float, float4>(x, y, n, stream);
    } else {
      launch<int, int4>(x, y, n, stream);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
