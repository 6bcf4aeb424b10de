// Activation-sparse dense GEMV/GEMM ("ASP") for Hopper: y = x @ A over the
// 128-row windows of a plan only,
//   y[b, c] = sum_{p < k} sum_{u < 128} x[b, plan[p]*128 + u] * A[plan[p]*128 + u, c].
//
// Replaces the TPU kernel tpusparse/kernels/asp_spmv.py:_asp_kernel (through
// _asp_pallas, for both the static plan and the device plan). Its split-bf16
// dot3 was a TPU workaround for the MXU; every product here is one FP32 FFMA.
//
// Bound: bytes. The live windows of A are read once (4 * 128 * n bytes a
// window) for 2 * B * 128 * n flops a window: at B <= 8, at most 4 flops a
// byte, far below the card's balance. The 8192^2 A at B = 8 with every
// window live reads 268 MB, 80 us at 3.35 TB/s.
//
// Design: the dense kernel's split contraction (dense.cu, with the same
// row-tile body, dense_common.cuh) with the AWSP kernel's plan indirection
// (awsp_spmv.cu). A block owns 128 output columns and one slice of plan
// positions; it reads the live count k from device memory and visits the
// positions of its slice below k, so the grid is sized from the plan length
// (every window, for a device plan) and a device plan needs no host sync. A
// block with no live position writes zero partials. A has one extra all-zero
// window (id nt) that an all-zero X's plan points at, so y = 0 there. The
// slices are summed by the fixed-order second pass (deterministic).
#include "dense_common.cuh"

namespace tps {

template <int BT, bool kVec>
__global__ void __launch_bounds__(kThreads)
asp_partial_kernel(const int* __restrict__ plan, const int* __restrict__ count,
                   const float* __restrict__ a, const float* __restrict__ x,
                   float* __restrict__ part, int lda, int n, int batch, int ldx,
                   int plan_len, int per_slice) {
  __shared__ float xs[BT][kRowTile];
  __shared__ __align__(16) float red[kWarps][BT][kLanes];
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * kLanes + kCols * lane;  // this lane's 4 columns
  const int slice = blockIdx.y, b0 = blockIdx.z * BT;
  const int k = min(*count, plan_len);  // live plan positions, read on device
  float acc[BT][kCols];
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[b][c] = 0.f;
  const int p0 = slice * per_slice;
  const int p1 = min(k, p0 + per_slice);
  for (int p = p0; p < p1; ++p)
    dense_rows<BT, kVec>(a, lda, n, c0, plan[p] * kRowTile, kRowTile, x, ldx,
                         b0, batch, xs, acc);
  block_sum_store<BT>(acc, red,
                      part + ((size_t)slice * batch + b0) * n + (size_t)blockIdx.x * kLanes,
                      n, batch - b0, n - blockIdx.x * kLanes);
}

template <int BT>
void launch_asp(bool vec, dim3 grid, cudaStream_t st, const int* plan,
                const int* count, const float* a, const float* x, float* part,
                int lda, int n, int batch, int ldx, int plan_len, int per_slice) {
  if (vec)
    asp_partial_kernel<BT, true><<<grid, kThreads, 0, st>>>(plan, count, a, x, part, lda, n, batch, ldx, plan_len, per_slice);
  else
    asp_partial_kernel<BT, false><<<grid, kThreads, 0, st>>>(plan, count, a, x, part, lda, n, batch, ldx, plan_len, per_slice);
}

}  // namespace tps

// plan: (plan_len,) int32 window ids; count: (1,) int32 live positions;
// a: (rows, lda) fp32 with the zero window last, n <= lda real columns;
// x: (batch, ldx) fp32 (missing columns read as 0); part: (slices, batch, n)
// fp32 scratch; y: (batch, n) fp32.
extern "C" int tps_asp_spmm(const void* plan, const void* count, const void* a,
                            const void* x, void* part, void* y, int lda, int n,
                            int batch, int ldx, int plan_len, int slices,
                            int per_slice, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* pl = static_cast<const int*>(plan);
  const auto* kk = static_cast<const int*>(count);
  const auto* aa = static_cast<const float*>(a);
  const auto* xx = static_cast<const float*>(x);
  auto* pp = static_cast<float*>(part);
  if (n > 0 && batch > 0 && slices > 0) {
    const int bt = tps::batch_tile(batch);
    const bool vec = lda % tps::kCols == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
    const dim3 grid((n + tps::kLanes - 1) / tps::kLanes, slices, (batch + bt - 1) / bt);
    switch (bt) {
      case 1: tps::launch_asp<1>(vec, grid, st, pl, kk, aa, xx, pp, lda, n, batch, ldx, plan_len, per_slice); break;
      case 2: tps::launch_asp<2>(vec, grid, st, pl, kk, aa, xx, pp, lda, n, batch, ldx, plan_len, per_slice); break;
      case 4: tps::launch_asp<4>(vec, grid, st, pl, kk, aa, xx, pp, lda, n, batch, ldx, plan_len, per_slice); break;
      default: tps::launch_asp<8>(vec, grid, st, pl, kk, aa, xx, pp, lda, n, batch, ldx, plan_len, per_slice); break;
    }
    tps::launch_reduce(pp, nullptr, static_cast<float*>(y), slices, batch, n, n, st);
  }
  return (int)cudaGetLastError();
}
