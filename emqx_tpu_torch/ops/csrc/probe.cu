// K12: the add-one dispatch of the link probe.
//
// Replaces the jitted `triv(x) = x + 1` inside emqx_tpu/ops/transfer.py
// `probe_link`: one float32 scalar round trip gives the launch +
// transfer floor (RTT), and the same kernel over a 1 MB int32 buffer
// gives the device->host fetch rate. The dispatch engine sizes its
// transfer chunk (the cap on compacted result buffers) from the two.
//
// What bounds it on the H100: for the scalar, nothing on the card —
// the round trip is launch latency plus two PCIe transfers; for the
// 1 MB buffer, 2 MB of HBM traffic (~0.6 us at 3.35 TB/s), so the
// fetch leg measures the link, as intended.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void add_one_k(const T* __restrict__ x, T* __restrict__ y,
                          long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] + static_cast<T>(1);
}

}  // namespace

// y = x + 1 over n float32 (is_float != 0) or int32 elements.
// Returns cudaGetLastError().
extern "C" int emqx_add_one(const void* x, void* y, long long n, int is_float,
                            cudaStream_t stream) {
  if (n > 0) {
    const int blocks = static_cast<int>((n + 255) / 256);
    if (is_float) {
      add_one_k<float><<<blocks, 256, 0, stream>>>(
          static_cast<const float*>(x), static_cast<float*>(y), n);
    } else {
      add_one_k<int><<<blocks, 256, 0, stream>>>(static_cast<const int*>(x),
                                                 static_cast<int*>(y), n);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
