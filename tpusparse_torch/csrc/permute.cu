// Static column gather for Hopper: out[b, p] = y[b, src[p]] for p < n, and 0
// where src[p] < 0 (a dead lane) or src[p] >= ldy.
//
// Replaces the TPU kernel tpusparse/kernels/permute.py:_permute_kernel (the
// unpermute of a column-sorted RSELL pack). The TPU kernel rebuilt each
// output lane from one-hot source-group masks because XLA's lane gather is
// near-serial there; here the wrapper turns those masks into one int32
// source lane per output lane when the pack is built, and each thread does
// one gather.
//
// Bound: bytes — y, src and out are each touched once (96 KB at B = 1,
// n = 8192), far below the launch latency: the call costs its launch.
//
// Design: one thread per output element, consecutive threads on consecutive
// output lanes, so the src read and the out write are coalesced and the y
// reads of one batch row stay inside that row (L2-resident).
#include <cuda_runtime.h>

namespace tps {

__global__ void permute_kernel(const float* __restrict__ y, const int* __restrict__ src,
                               float* __restrict__ out, int batch, int ldy, int n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)batch * n) return;
  const int b = (int)(e / n), p = (int)(e % n);
  const int s = src[p];
  out[e] = (s >= 0 && s < ldy) ? y[(size_t)b * ldy + s] : 0.f;
}

}  // namespace tps

// y: (batch, ldy) fp32; src: (n,) int32; out: (batch, n) fp32.
extern "C" int tps_permute_columns(const void* y, const void* src, void* out,
                                   int batch, int ldy, int n, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)batch * n;
  if (total > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    tps::permute_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(y), static_cast<const int*>(src),
        static_cast<float*>(out), batch, ldy, n);
  }
  return (int)cudaGetLastError();
}
