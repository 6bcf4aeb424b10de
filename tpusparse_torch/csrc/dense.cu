// Dense GEMV/GEMM for Hopper: y = x @ A, A (m, n) fp32 row-major, x (B, m).
//
// Replaces the TPU kernel tpusparse/kernels/dense.py:_dense_kernel (the
// dense_pallas baseline). Its split-bf16 dot3 was a TPU workaround for the
// MXU; here every product is one FP32 FFMA (no tensor cores, no TF32).
//
// Bound: bytes. A is read once (4*m*n bytes) for 2*B*m*n flops; at B <= 8
// that is at most 4 flops per byte, far below the card's balance.
//
// Design: a 128-thread block owns 128 output columns and a slice of the rows
// (n/128 column groups, 32 at n = 4096, would leave the card mostly idle,
// so the contraction axis m is split across blockIdx.y, as many slices as
// fill the card's resident blocks once: kernels/dense.py:dense_shape).
// Lane q of each warp owns the 4 adjacent columns 4q .. 4q+3 and keeps
// 4 x B accumulators in registers.
// - At 8 batch rows the rows stream through a ring of kStages shared-memory
//   stages of kStageRows rows: every thread issues cp.async copies (16
//   bytes, or 4 where n % 4 != 0 or A is not 16-byte aligned; past the
//   slice or past n they zero-fill) for the stage kStages-1 ahead before it
//   multiplies the current one, so the loads never wait behind the 32 FFMAs
//   a row. The stage also carries the x values of its rows; warp w
//   multiplies rows 4w .. 4w+3 of each stage.
// - At 1-4 batch rows the FFMAs are few, and the register-prefetch body of
//   dense_common.cuh (two groups of 4 rows in flight a warp) streams faster
//   than the ring: on an H100 at B = 1 the ring took 1.08 x the earlier
//   two-kernel K2's time, this body 1.00 x (tpusparse_torch/bench/abba.py, PERF.md).
// The warps' sums are added once, at the end; then the last block of the
// column group to arrive adds the slices in a fixed order
// (split_reduce.cuh): one launch a call, deterministic.
#include "async_copy.cuh"
#include "dense_common.cuh"
#include "split_reduce.cuh"

namespace tps {

constexpr int kStageRows = 16;   // rows of A per stage: 8 KB at 128 columns
constexpr int kStages = 4;       // stages in the ring, kStages-1 in flight
template <int BT>
struct DenseStage {
  float a[kStageRows][kLanes];
  float x[BT][kStageRows];
};

// The ring carries 8 batch rows; at 1-4 the register-prefetch body runs.
template <int BT>
constexpr bool kRing = BT == 8;
// Shared memory of a block: the ring, or at 1-4 rows 16 KB (the x tile and
// the warps' sums, then the tail's slices, 32 at a time at B = 1).
template <int BT>
constexpr int kDenseSmem = kRing<BT> ? kStages * (int)sizeof(DenseStage<BT>) : 16 * 1024;

// Issue the copies of rows r0 .. r0+kStageRows-1 (those below r1) of this
// block's 128 columns, and of x for those rows, into stage st.
template <int BT, bool kVec>
__device__ __forceinline__ void load_stage(DenseStage<BT>& st, const float* __restrict__ a,
                                           const float* __restrict__ x, int m, int n, int c0,
                                           int r0, int r1, int b0, int batch) {
  if (kVec) {
    for (int q = threadIdx.x; q < kStageRows * kLanes / 4; q += kThreads) {
      const int u = q / (kLanes / 4), c = 4 * (q % (kLanes / 4));
      const bool ok = r0 + u < r1 && c0 + c < n;
      copy_async<16>(&st.a[u][c], ok ? a + (size_t)(r0 + u) * n + c0 + c : a, ok);
    }
  } else {
    for (int q = threadIdx.x; q < kStageRows * kLanes; q += kThreads) {
      const int u = q / kLanes, c = q % kLanes;
      const bool ok = r0 + u < r1 && c0 + c < n;
      copy_async<4>(&st.a[u][c], ok ? a + (size_t)(r0 + u) * n + c0 + c : a, ok);
    }
  }
  for (int q = threadIdx.x; q < BT * kStageRows; q += kThreads) {
    const int b = q / kStageRows, u = q % kStageRows;
    const bool ok = b0 + b < batch && r0 + u < r1;
    copy_async<4>(&st.x[b][u], ok ? x + (size_t)(b0 + b) * m + r0 + u : x, ok);
  }
}

template <int BT, bool kVec>
__global__ void __launch_bounds__(kThreads, BT == 8 ? 4 : BT == 4 ? 6 : 8)   // as dense_shape
dense_kernel(const float* __restrict__ a, const float* __restrict__ x,
             float* __restrict__ part, float* __restrict__ y, int* __restrict__ counters,
             int m, int n, int batch, int per_slice) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto* ring = reinterpret_cast<DenseStage<BT>*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * kLanes, slice = blockIdx.y, b0 = blockIdx.z * BT;
  const int m0 = slice * per_slice, m1 = min(m, m0 + per_slice);
  const int stages = (max(m1 - m0, 0) + kStageRows - 1) / kStageRows;
  float acc[BT][kCols];   // rows b0 + b, columns c0 + 4 * lane .. + 3
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[b][c] = 0.f;

  if constexpr (kRing<BT>) {
#pragma unroll
    for (int g = 0; g < kStages - 1; ++g) {
      if (g < stages)
        load_stage<BT, kVec>(ring[g], a, x, m, n, c0, m0 + g * kStageRows, m1, b0, batch);
      copy_commit();
    }
    for (int g = 0; g < stages; ++g) {
      copy_wait<kStages - 2>();   // this thread's copies of stage g landed
      __syncthreads();            // everyone's, and stage g-1 is free again
      const int ahead = g + kStages - 1;
      if (ahead < stages)
        load_stage<BT, kVec>(ring[ahead % kStages], a, x, m, n, c0, m0 + ahead * kStageRows,
                             m1, b0, batch);
      copy_commit();
      const DenseStage<BT>& st = ring[g % kStages];
      float4 xv[BT];
#pragma unroll
      for (int b = 0; b < BT; ++b) xv[b] = reinterpret_cast<const float4*>(st.x[b])[warp];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 av = reinterpret_cast<const float4*>(st.a[4 * warp + u])[lane];
        const float v[kCols] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          const float xb = u == 0 ? xv[b].x : u == 1 ? xv[b].y : u == 2 ? xv[b].z : xv[b].w;
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[b][c] = fmaf(v[c], xb, acc[b][c]);
        }
      }
    }
  } else {
    // few batch rows: the register-prefetch body (dense_common.cuh), which
    // streams faster here than the ring
    float (*xs)[kRowTile] = reinterpret_cast<float(*)[kRowTile]>(smem);
    for (int mt = m0; mt < m1; mt += kRowTile)
      dense_rows<BT, kVec>(a, n, n, c0 + kCols * lane, mt, min(kRowTile, m1 - mt), x, m, b0,
                           batch, xs, acc);
  }
  copy_wait<0>();
  __syncthreads();   // shared memory is free: it holds the warps' sums, then the tail's slices
  const int rows = min(BT, batch - b0), cols = min(kLanes, n - c0);
  block_sum_store<BT>(acc, reinterpret_cast<float(*)[BT][kLanes]>(smem),
                      part + ((size_t)slice * batch + b0) * n + c0, n, rows, cols);
  // words of the sums a thread reduces: 4 columns each with kVec (n % 4 == 0)
  split_reduce_tail<kVec ? (BT >= 4 ? BT / 4 : 1) : BT, kVec>(part, y, counters + blockIdx.z * gridDim.x + blockIdx.x, gridDim.y,
                    batch, n, n, b0, rows, c0, cols, reinterpret_cast<float*>(smem),
                    kDenseSmem<BT> / sizeof(float));
}

template <int BT>
void launch_dense(bool vec, dim3 grid, cudaStream_t st, const float* a, const float* x,
                  float* part, float* y, int* counters, int m, int n, int batch,
                  int per_slice) {
  constexpr int smem = kDenseSmem<BT>;
  static_assert(smem >= kWarps * BT * kLanes * (int)sizeof(float) &&
                    smem >= BT * kRowTile * (int)sizeof(float) && smem <= 48 * 1024,
                "K2's shared memory holds the warps' sums and fits the default limit");
  if (vec)
    dense_kernel<BT, true><<<grid, kThreads, smem, st>>>(a, x, part, y, counters, m, n, batch,
                                                         per_slice);
  else
    dense_kernel<BT, false><<<grid, kThreads, smem, st>>>(a, x, part, y, counters, m, n,
                                                          batch, per_slice);
}

}  // namespace tps

// a: (m, n) fp32; x: (batch, m) fp32; part: (slices, batch, n) fp32 scratch;
// y: (batch, n) fp32; counters: ceil(n/128) * ceil(batch/bt) int32, all 0.
// per_slice is a multiple of kStageRows.
extern "C" int tps_dense_spmm(const void* a, const void* x, void* part, void* y,
                              void* counters, int m, int n, int batch, int slices,
                              int per_slice, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* aa = static_cast<const float*>(a);
  const auto* xx = static_cast<const float*>(x);
  auto* pp = static_cast<float*>(part);
  auto* yy = static_cast<float*>(y);
  auto* cc = static_cast<int*>(counters);
  if (n > 0 && batch > 0 && slices > 0) {
    const int bt = tps::batch_tile(batch);
    const bool vec = n % tps::kCols == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
    const dim3 grid((n + tps::kLanes - 1) / tps::kLanes, slices, (batch + bt - 1) / bt);
    switch (bt) {
      case 1: tps::launch_dense<1>(vec, grid, st, aa, xx, pp, yy, cc, m, n, batch, per_slice); break;
      case 2: tps::launch_dense<2>(vec, grid, st, aa, xx, pp, yy, cc, m, n, batch, per_slice); break;
      case 4: tps::launch_dense<4>(vec, grid, st, aa, xx, pp, yy, cc, m, n, batch, per_slice); break;
      default: tps::launch_dense<8>(vec, grid, st, aa, xx, pp, yy, cc, m, n, batch, per_slice); break;
    }
  }
  return (int)cudaGetLastError();
}
