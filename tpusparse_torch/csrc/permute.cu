// Static column gather for Hopper (K5): out[b, p] = y[b, src[p]] for p < n,
// and 0 where src[p] < 0 (a dead lane) or src[p] >= the width of y. y is one
// (batch, ld0) array or the concatenation, along the columns, of up to
// three (batch, ld_k) arrays that are never joined in memory: lane s of the
// concatenation is lane s - ld0 - .. - ld_{k-1} of part k.
//
// Replaces the TPU kernel tpusparse/kernels/permute.py:_permute_kernel (the
// unpermute of a column-sorted pack). The TPU kernel rebuilt each output
// lane from one-hot source-group masks because XLA's lane gather is
// near-serial there; here the wrapper turns those masks into one int32
// source lane per output lane when the pack is built, and each thread does
// one gather. A sorted RSELL pack no longer launches it: K4's second kernel
// gathers through the same source lanes (rsell_spmv.cu). Binned SELL
// launches it once a call, reading its buckets' K1 outputs in place.
//
// Bound: bytes — y, src and out are each touched once (96 KB at B = 1,
// n = 8192), far below the launch latency: the call costs its launch.
//
// Design: one thread per output element, consecutive threads on consecutive
// output lanes, so the src read and the out write are coalesced and the y
// reads of one batch row stay inside that row (L2-resident).
#include <cuda_runtime.h>

namespace tps {

constexpr int kPermuteParts = 3;

struct PermuteParts {
  const float* y[kPermuteParts];
  int ld[kPermuteParts];   // 0: no such part
};

__global__ void permute_kernel(PermuteParts parts, const int* __restrict__ src,
                               float* __restrict__ out, int batch, int n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)batch * n) return;
  const int b = (int)(e / n), p = (int)(e % n);
  int s = src[p];
  float v = 0.f;
  if (s >= 0) {
#pragma unroll
    for (int k = 0; k < kPermuteParts; ++k) {
      if (s < parts.ld[k]) {
        v = parts.y[k][(size_t)b * parts.ld[k] + s];
        break;
      }
      s -= parts.ld[k];
    }
  }
  out[e] = v;
}

}  // namespace tps

// y0, y1, y2: (batch, ld_k) fp32 (ld_k = 0 and a null pointer for a part
// that is not there); src: (n,) int32; out: (batch, n) fp32.
extern "C" int tps_permute_columns(const void* y0, const void* y1, const void* y2,
                                   const void* src, void* out, int ld0, int ld1, int ld2,
                                   int batch, int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ld0 < 0 || ld1 < 0 || ld2 < 0) return (int)cudaErrorInvalidValue;
  const tps::PermuteParts parts = {
      {static_cast<const float*>(y0), static_cast<const float*>(y1),
       static_cast<const float*>(y2)},
      {ld0, ld1, ld2}};
  const long long total = (long long)batch * n;
  if (total > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    tps::permute_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        parts, static_cast<const int*>(src), static_cast<float*>(out), batch, n);
  }
  return (int)cudaGetLastError();
}
