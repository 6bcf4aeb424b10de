// Dense GEMV/GEMM for Hopper: y = x @ A, A (m, n) fp32 row-major, x (B, m).
//
// Replaces the TPU kernel tpusparse/kernels/dense.py:_dense_kernel (the
// dense_pallas baseline). Its split-bf16 dot3 was a TPU workaround for the
// MXU; here every product is one FP32 FFMA (no tensor cores, no TF32).
//
// Bound: bytes. A is read once (4*m*n bytes) for 2*B*m*n flops; at B <= 8
// that is at most 4 flops per byte, far below the card's balance.
//
// Design: a 128-thread block owns 128 output columns and walks the rows in
// tiles of 128 with the shared row-tile body (dense_common.cuh: lane q of
// each warp owns 4 adjacent columns, one 16-byte load a row, two groups of
// rows in flight, the x tile in shared memory); 4 x B accumulators live in
// registers and the warps' sums are added once, at the end. With n/128
// column blocks (32 at n = 4096) the card would be mostly idle, so the
// contraction axis m is split across blockIdx.y into slices whose partial
// sums a second kernel adds in a fixed order (deterministic). Unaligned m
// and n are masked, never padded.
#include "dense_common.cuh"

namespace tps {

template <int BT, bool kVec>
__global__ void __launch_bounds__(kThreads)
dense_partial_kernel(const float* __restrict__ a, const float* __restrict__ x,
                     float* __restrict__ part, int m, int n, int batch,
                     int per_slice) {
  __shared__ float xs[BT][kRowTile];
  __shared__ __align__(16) float red[kWarps][BT][kLanes];
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * kLanes + kCols * lane;  // this lane's 4 columns
  const int slice = blockIdx.y, b0 = blockIdx.z * BT;
  float acc[BT][kCols];
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[b][c] = 0.f;
  const int m0 = slice * per_slice;
  const int m1 = min(m, m0 + per_slice);
  for (int mt = m0; mt < m1; mt += kRowTile)
    dense_rows<BT, kVec>(a, n, n, c0, mt, min(kRowTile, m1 - mt), x, m, b0,
                         batch, xs, acc);
  block_sum_store<BT>(acc, red,
                      part + ((size_t)slice * batch + b0) * n + (size_t)blockIdx.x * kLanes,
                      n, batch - b0, n - blockIdx.x * kLanes);
}

template <int BT>
void launch_dense(bool vec, dim3 grid, cudaStream_t st, const float* a,
                  const float* x, float* part, int m, int n, int batch,
                  int per_slice) {
  if (vec)
    dense_partial_kernel<BT, true><<<grid, kThreads, 0, st>>>(a, x, part, m, n, batch, per_slice);
  else
    dense_partial_kernel<BT, false><<<grid, kThreads, 0, st>>>(a, x, part, m, n, batch, per_slice);
}

}  // namespace tps

// a: (m, n) fp32; x: (batch, m) fp32; part: (slices, batch, n) fp32 scratch;
// y: (batch, n) fp32.
extern "C" int tps_dense_spmm(const void* a, const void* x, void* part, void* y,
                              int m, int n, int batch, int slices, int per_slice,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* aa = static_cast<const float*>(a);
  const auto* xx = static_cast<const float*>(x);
  auto* pp = static_cast<float*>(part);
  auto* yy = static_cast<float*>(y);
  if (n > 0 && batch > 0 && slices > 0) {
    const int bt = tps::batch_tile(batch);
    const bool vec = n % tps::kCols == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
    const dim3 grid((n + tps::kLanes - 1) / tps::kLanes, slices, (batch + bt - 1) / bt);
    switch (bt) {
      case 1: tps::launch_dense<1>(vec, grid, st, aa, xx, pp, m, n, batch, per_slice); break;
      case 2: tps::launch_dense<2>(vec, grid, st, aa, xx, pp, m, n, batch, per_slice); break;
      case 4: tps::launch_dense<4>(vec, grid, st, aa, xx, pp, m, n, batch, per_slice); break;
      default: tps::launch_dense<8>(vec, grid, st, aa, xx, pp, m, n, batch, per_slice); break;
    }
    tps::launch_reduce(pp, nullptr, yy, slices, batch, n, n, st);
  }
  return (int)cudaGetLastError();
}
