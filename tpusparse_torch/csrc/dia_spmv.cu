// DIA SpMV for Hopper: k diagonals of a square A stored as (k, n) rows,
//   y[p] = sum_i vals[i, p] * x[p + d_i]
//        (+ vals[i, p - d_i] * x[p - d_i] for each d_i > 0 when `sym`),
// with reads outside [0, n) as 0.
//
// Replaces the TPU kernel tpusparse/kernels/dia_spmv.py:_dia_kernel
// (through dia_spmv_pallas). Its halo strips carry a neighbour's edge in the
// sharded partition; on one device they are zero, which is what the bounds
// checks below give. Its in-register roll-and-select shifts have no
// counterpart here: a thread reads x[p + d] directly, and the neighbouring
// threads' reads of the same lines come from L1/L2.
//
// Bound: bytes. Each output position reads k values and writes one, and x is
// read once however many diagonals touch it; 2 flops a product. The 1M-
// unknown sym 5-point Laplacian (3 stored diagonals: vals 12.6 MB, x and y
// 4.2 MB each) takes 6.3 us at 3.35 TB/s.
//
// Design: a stream kernel. A 256-thread block owns 1024 consecutive
// positions, 4 per thread at a stride of 256, so a warp's reads of vals,
// x and y are coalesced and each thread has 4 independent sums in flight.
// The offsets are a kernel argument (k <= 32). The terms are added in the
// TPU kernel's order (diagonal i, then its mirror) with a separate multiply
// and add, so every product and every partial sum is the one the TPU
// kernel's fp32 arithmetic forms (dia_spmv.py:102-107).
#include <cuda_runtime.h>

namespace tps {

constexpr int kMaxDiags = 32;
constexpr int kDiaThreads = 256, kDiaPer = 4;

struct DiaOffsets {
  int d[kMaxDiags];
};

__global__ void __launch_bounds__(kDiaThreads)
dia_kernel(const float* __restrict__ vals, const float* __restrict__ x,
           float* __restrict__ y, DiaOffsets off, int k, int sym, int n,
           int ldv) {
  const long long base = (long long)blockIdx.x * kDiaThreads * kDiaPer + threadIdx.x;
  float acc[kDiaPer];
#pragma unroll
  for (int j = 0; j < kDiaPer; ++j) acc[j] = 0.f;
  for (int i = 0; i < k; ++i) {
    const int d = off.d[i];
    const float* v = vals + (size_t)i * ldv;
#pragma unroll
    for (int j = 0; j < kDiaPer; ++j) {
      const long long p = base + (long long)j * kDiaThreads;
      if (p >= n) continue;
      const long long q = p + d;
      const float xv = (q >= 0 && q < n) ? x[q] : 0.f;
      acc[j] = __fadd_rn(acc[j], __fmul_rn(v[p], xv));
      if (sym && d > 0) {
        const long long r = p - d;  // mirror: vals_{-d}[p] = vals_d[p - d]
        const float m = r >= 0 ? __fmul_rn(v[r], x[r]) : 0.f;
        acc[j] = __fadd_rn(acc[j], m);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kDiaPer; ++j) {
    const long long p = base + (long long)j * kDiaThreads;
    if (p < n) y[p] = acc[j];
  }
}

}  // namespace tps

// offsets: host array of k int32 diagonal offsets (m_index - out_index),
// 0 < k <= 32; vals: (k, ldv) fp32 with ldv >= n; x, y: (n,) fp32.
extern "C" int tps_dia_spmv(const void* offsets, const void* vals, const void* x,
                            void* y, int k, int sym, int n, int ldv, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (k <= 0 || k > tps::kMaxDiags || ldv < n) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  tps::DiaOffsets off{};
  const int* src = static_cast<const int*>(offsets);
  for (int i = 0; i < k; ++i) off.d[i] = src[i];
  const int per_block = tps::kDiaThreads * tps::kDiaPer;
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  tps::dia_kernel<<<blocks, tps::kDiaThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const float*>(x),
      static_cast<float*>(y), off, k, sym, n, ldv);
  return (int)cudaGetLastError();
}
