// Block-sparse rows (BSR) SpMV/SpMM for Hopper: over a list of dense
// (TBm x 128) fp32 blocks sorted by (bj, bi),
//   y[b, bj[k]*128 + r] += sum_i x[b, bi[k]*TBm + i] * blocks[k, i, r].
//
// Replaces the TPU kernel tpusparse/kernels/bsr_spmv.py:_bsr_kernel_wide and
// _bsr_kernel_scan. Their split is a VMEM budget with no meaning here, and
// their split-bf16 dot (dot3) is not carried over: every product is an fp32
// FFMA.
//
// Bound: bytes. A block moves TBm * 512 bytes for 2 * TBm * 128 * B flops,
// 0.5 * B flops a byte, far below the card's fp32 balance (~20 flops a byte)
// at B <= 8. The 320-block pack of blockpruned-4096 (21.0 MB) takes 6.3 us at
// 3.35 TB/s.
//
// Design: the (bj, bi)-sorted block list is a stream of runs of one output
// group, cut on the host into work items (work_items.cuh). A 128-thread
// block sums one item: lane q of each warp owns columns 4q .. 4q+3 of the
// group and reads them with one 16-byte load per block row; the 4 warps
// take rows w, w+4, ... of the block. The x segment of the block's rows is
// staged in shared memory, 128 rows at a time, for every batch row of the
// block, and read from there as a broadcast. The warps' sums go to a
// (B, 128) partial per item, and the fixed-order group reduce writes y.
// Splitting by item rather than by group matters: blockpruned-4096 has 32
// output groups of about 10 blocks each, so one block per group would keep
// most of the 132 SMs idle.
#include "sell_common.cuh"
#include "work_items.cuh"

namespace tps {

template <int BT>
__global__ void __launch_bounds__(kThreads)
bsr_partial_kernel(const int* __restrict__ items, const int* __restrict__ bi,
                   const float* __restrict__ blocks, const float* __restrict__ x,
                   float* __restrict__ part, int block_m, int batch, int ldx) {
  __shared__ float xs[BT][kLanes];
  __shared__ __align__(16) float red[kWarps][BT][kLanes];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int item = blockIdx.x, b0 = blockIdx.y * BT;
  const int k0 = items[3 * item + 1], k1 = items[3 * item + 2];
  float acc[BT][kCols];
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[b][c] = 0.f;
  for (int k = k0; k < k1; ++k) {
    const float* blk = blocks + (size_t)k * block_m * kLanes;
    const int row0 = bi[k] * block_m;  // first contraction row of the block
    for (int s0 = 0; s0 < block_m; s0 += kLanes) {
      const int rows = min(kLanes, block_m - s0);
      __syncthreads();  // every thread is done with the previous segment
      for (int q = threadIdx.x; q < BT * kLanes; q += kThreads) {
        const int b = q / kLanes, i = q % kLanes, col = row0 + s0 + i;
        xs[b][i] = (b0 + b < batch && i < rows && col < ldx)
                       ? x[(size_t)(b0 + b) * ldx + col]
                       : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int i = warp; i < rows; i += kWarps) {
        float v[kCols];
        load4(blk + (size_t)(s0 + i) * kLanes, lane, v);
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          const float xv = xs[b][i];
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[b][c] = fmaf(v[c], xv, acc[b][c]);
        }
      }
    }
  }
  block_sum_store<BT>(acc, red, part + ((size_t)item * batch + b0) * kLanes,
                      kLanes, batch - b0, kLanes);
}

}  // namespace tps

// items: (nitems, 3) int32 (group, first block, end block), sorted by group;
// gptr: (nb+1,) int32 item offsets per group; bi: (nblk,) int32;
// blocks: (nblk, block_m, 128) fp32, block_m a multiple of 8; x: (batch,
// ldx) fp32 (missing columns read as 0); part: (nitems, batch, 128) fp32
// scratch; y: (batch, n) fp32, n <= nb*128.
extern "C" int tps_bsr_spmm(const void* items, const void* gptr, const void* bi,
                            const void* blocks, const void* x, void* part, void* y,
                            int nitems, int block_m, int batch, int ldx, int n,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (block_m <= 0 || block_m % 8) return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* it = static_cast<const int*>(items);
  const auto* ii = static_cast<const int*>(bi);
  const auto* bb = static_cast<const float*>(blocks);
  const auto* xx = static_cast<const float*>(x);
  auto* pp = static_cast<float*>(part);
  if (batch <= 0 || n <= 0) return (int)cudaGetLastError();
  if (nitems > 0) {
    const int bt = tps::batch_tile(batch);
    const dim3 grid(nitems, (batch + bt - 1) / bt);
    switch (bt) {
      case 1: tps::bsr_partial_kernel<1><<<grid, tps::kThreads, 0, st>>>(it, ii, bb, xx, pp, block_m, batch, ldx); break;
      case 2: tps::bsr_partial_kernel<2><<<grid, tps::kThreads, 0, st>>>(it, ii, bb, xx, pp, block_m, batch, ldx); break;
      case 4: tps::bsr_partial_kernel<4><<<grid, tps::kThreads, 0, st>>>(it, ii, bb, xx, pp, block_m, batch, ldx); break;
      default: tps::bsr_partial_kernel<8><<<grid, tps::kThreads, 0, st>>>(it, ii, bb, xx, pp, block_m, batch, ldx); break;
    }
  }
  tps::launch_group_reduce(static_cast<const int*>(gptr), pp,
                           static_cast<float*>(y), batch, n, st);
  return (int)cudaGetLastError();
}
