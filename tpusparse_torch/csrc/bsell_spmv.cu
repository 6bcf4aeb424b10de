// Block-SELL SpMV/SpMM for Hopper (the SELL tier of TCSR): over a list of
// (W x 128) SELL tiles sorted by (bj, bi),
//   y[b, bj[k]*128 + r] += sum_s vals[k,s,r] * x[b, bi[k]*128 + idx[k,s,r]].
//
// Replaces the TPU kernel tpusparse/kernels/bsell_spmv.py:_bsell_kernel_wide
// and _bsell_kernel_scan (tile body _tile_product). Their (B*8, N) output
// slab and the ones-matrix reduction on the MXU (dot2_exact_lhs) are TPU
// workarounds and are not carried over: every product is an fp32 FFMA.
//
// Bound: bytes. A tile moves 5 * W * 128 bytes (fp32 values + int8 indices)
// for 2 * W * 128 * B flops. The 320-tile, W = 88 SELL tier of
// blockpruned-4096 (18.0 MB) takes 5.4 us at 3.35 TB/s.
//
// Design: K1's tile body (sell_common.cuh: lane q of each warp owns columns
// 4q .. 4q+3 and reads a slot row with one 16-byte value load and one
// 4-byte index load, the 4 warps split the W slot rows, the x window is
// staged in shared memory for every batch row of the block and gathered from
// there) applied to a coordinate list: the window is taken from bi[k] and the
// output group from the work item. The tiles are cut into items and reduced
// per group as in K6 (work_items.cuh).
#include "sell_common.cuh"
#include "work_items.cuh"

namespace tps {

template <int BT>
__global__ void __launch_bounds__(kThreads)
bsell_partial_kernel(const int* __restrict__ items, const int* __restrict__ bi,
                     const int8_t* __restrict__ idx, const float* __restrict__ vals,
                     const float* __restrict__ x, float* __restrict__ part, int w,
                     int batch, int ldx) {
  __shared__ float xs[BT][kLanes];
  __shared__ __align__(16) float red[kWarps][BT][kLanes];
  const int item = blockIdx.x, b0 = blockIdx.y * BT;
  const int k0 = items[3 * item + 1], k1 = items[3 * item + 2];
  float acc[BT][kCols];
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[b][c] = 0.f;
  for (int k = k0; k < k1; ++k) {
    stage_window<BT>(xs, x, ldx, bi[k], b0, batch);
    const size_t tile = (size_t)k * w * kLanes;
    accumulate_tile<float, BT>(idx + tile, vals + tile, w, xs, acc);
  }
  block_sum_store<BT>(acc, red, part + ((size_t)item * batch + b0) * kLanes,
                      kLanes, batch - b0, kLanes);
}

}  // namespace tps

// items: (nitems, 3) int32 (group, first tile, end tile), sorted by group;
// gptr: (nb+1,) int32 item offsets per group; bi: (nblk,) int32;
// idx/vals: (nblk, w, 128) int8 / fp32; x: (batch, ldx) fp32 (missing
// columns read as 0); part: (nitems, batch, 128) fp32 scratch;
// y: (batch, n) fp32, n <= nb*128.
extern "C" int tps_bsell_spmm(const void* items, const void* gptr, const void* bi,
                              const void* idx, const void* vals, const void* x,
                              void* part, void* y, int nitems, int w, int batch,
                              int ldx, int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* it = static_cast<const int*>(items);
  const auto* ii = static_cast<const int*>(bi);
  const auto* ix = static_cast<const int8_t*>(idx);
  const auto* vv = static_cast<const float*>(vals);
  const auto* xx = static_cast<const float*>(x);
  auto* pp = static_cast<float*>(part);
  if (batch <= 0 || n <= 0) return (int)cudaGetLastError();
  if (nitems > 0) {
    const int bt = tps::batch_tile(batch);
    const dim3 grid(nitems, (batch + bt - 1) / bt);
    switch (bt) {
      case 1: tps::bsell_partial_kernel<1><<<grid, tps::kThreads, 0, st>>>(it, ii, ix, vv, xx, pp, w, batch, ldx); break;
      case 2: tps::bsell_partial_kernel<2><<<grid, tps::kThreads, 0, st>>>(it, ii, ix, vv, xx, pp, w, batch, ldx); break;
      case 4: tps::bsell_partial_kernel<4><<<grid, tps::kThreads, 0, st>>>(it, ii, ix, vv, xx, pp, w, batch, ldx); break;
      default: tps::bsell_partial_kernel<8><<<grid, tps::kThreads, 0, st>>>(it, ii, ix, vv, xx, pp, w, batch, ldx); break;
    }
  }
  tps::launch_group_reduce(static_cast<const int*>(gptr), pp,
                           static_cast<float*>(y), batch, n, st);
  return (int)cudaGetLastError();
}
