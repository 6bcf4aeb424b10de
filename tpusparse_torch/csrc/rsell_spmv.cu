// Ragged SELL (RSELL) SpMV/SpMM for Hopper: over a stream of chunks of
// 8 slots x 128 lanes,
//   y[b, cj[k]*128 + r] += sum_s vals[k,s,r] * x[b, ct[k]*128 + idx[k,s,r]].
//
// Replaces the TPU kernel tpusparse/kernels/rsell_spmv.py:_rsell_kernel
// (its run body and its flat body alike).
//
// Bound: bytes. A chunk moves 5 KB (fp32 values + int8 indices) for
// 2 * 1024 * B flops, far below the card's operations-per-byte balance;
// the 8192^2 powerlaw pack (40 MB) takes 11.9 us at 3.35 TB/s.
//
// Design: the stream is cut, once per pack, into items (kernels/
// rsell_spmv.py:work_plan): runs of consecutive chunks of one output group,
// at most a few chunks each, so that a skewed pack, whose first group holds
// far more chunks than the tail groups, still spreads evenly over the SMs.
// A 128-thread block sums one item: the 4 warps take contiguous quarters of
// its chunks, lane q owns columns 4q .. 4q+3 of the group and reads each
// slot row of a chunk with one 16-byte value load and one 4-byte index load
// (sell_common.cuh's layout). A warp loads all 8 slot rows of a chunk into
// registers first, then stages that chunk's 128-value x window for every
// batch row of the block in its own slice of shared memory (only when the
// window differs from the one it holds: the chunks of one tile share it),
// then gathers from there. The warps' sums go to a (B, 128) partial per
// item, and a second kernel adds each group's partials in a fixed order
// (deterministic; no float atomics), writing y for columns < n; it splits
// each group's items over 32 slices, because the first group of a sorted
// skewed pack holds far more items than the tail groups (work_items.cuh).
#include "sell_common.cuh"
#include "work_items.cuh"

namespace tps {

constexpr int kSub = 8;  // slot rows per chunk

template <int BT>
__global__ void __launch_bounds__(kThreads)
rsell_partial_kernel(const int* __restrict__ items, const int* __restrict__ ct,
                     const int8_t* __restrict__ idx, const float* __restrict__ vals,
                     const float* __restrict__ x, float* __restrict__ part,
                     int batch, int ldx) {
  __shared__ float xs[kWarps][BT][kLanes];
  __shared__ __align__(16) float red[kWarps][BT][kLanes];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int item = blockIdx.x, b0 = blockIdx.y * BT;
  const int c0 = items[3 * item + 1], c1 = items[3 * item + 2];
  const int q = (c1 - c0 + kWarps - 1) / kWarps;
  const int k0 = c0 + warp * q, k1 = min(c1, k0 + q);
  float acc[BT][kCols];
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[b][c] = 0.f;
  int held = -1;  // the x window this warp's shared slice holds
  for (int k = k0; k < k1; ++k) {
    float4 v[kSub];
    char4 ix[kSub];
    const size_t base = (size_t)k * kSub * kLanes;
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      v[s] = reinterpret_cast<const float4*>(vals + base + (size_t)s * kLanes)[lane];
      ix[s] = reinterpret_cast<const char4*>(idx + base + (size_t)s * kLanes)[lane];
    }
    const int t = ct[k];
    if (t != held) {
      __syncwarp();  // every lane is done with the previous window
      for (int e = lane; e < BT * kLanes; e += 32) {
        const int b = e / kLanes, col = t * kLanes + e % kLanes;
        xs[warp][b][e % kLanes] = (b0 + b < batch && col < ldx)
                                      ? x[(size_t)(b0 + b) * ldx + col]
                                      : 0.f;
      }
      __syncwarp();
      held = t;
    }
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      const float vv[kCols] = {v[s].x, v[s].y, v[s].z, v[s].w};
      const int ii[kCols] = {ix[s].x, ix[s].y, ix[s].z, ix[s].w};
#pragma unroll
      for (int b = 0; b < BT; ++b)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[b][c] = fmaf(vv[c], xs[warp][b][ii[c]], acc[b][c]);
    }
  }
  block_sum_store<BT>(acc, red, part + ((size_t)item * batch + b0) * kLanes,
                      kLanes, batch - b0, kLanes);
}

}  // namespace tps

// items: (nitems, 3) int32 (group, first chunk, end chunk), sorted by group;
// gptr: (nb+1,) int32 item offsets per group; ct: (nchunk,) int32;
// idx/vals: (nchunk, 8, 128) int8 / fp32; x: (batch, ldx) fp32 (missing
// columns read as 0); part: (nitems, batch, 128) fp32 scratch;
// y: (batch, n) fp32, n <= nb*128.
extern "C" int tps_rsell_spmm(const void* items, const void* gptr, const void* ct,
                              const void* idx, const void* vals, const void* x,
                              void* part, void* y, int nitems, int batch, int ldx,
                              int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* it = static_cast<const int*>(items);
  const auto* tt = static_cast<const int*>(ct);
  const auto* ix = static_cast<const int8_t*>(idx);
  const auto* vv = static_cast<const float*>(vals);
  const auto* xx = static_cast<const float*>(x);
  auto* pp = static_cast<float*>(part);
  if (batch <= 0 || n <= 0) return (int)cudaGetLastError();
  if (nitems > 0) {
    const int bt = tps::batch_tile(batch);
    const dim3 grid(nitems, (batch + bt - 1) / bt);
    switch (bt) {
      case 1: tps::rsell_partial_kernel<1><<<grid, tps::kThreads, 0, st>>>(it, tt, ix, vv, xx, pp, batch, ldx); break;
      case 2: tps::rsell_partial_kernel<2><<<grid, tps::kThreads, 0, st>>>(it, tt, ix, vv, xx, pp, batch, ldx); break;
      case 4: tps::rsell_partial_kernel<4><<<grid, tps::kThreads, 0, st>>>(it, tt, ix, vv, xx, pp, batch, ldx); break;
      default: tps::rsell_partial_kernel<8><<<grid, tps::kThreads, 0, st>>>(it, tt, ix, vv, xx, pp, batch, ldx); break;
    }
  }
  tps::launch_group_reduce(static_cast<const int*>(gptr), pp,
                           static_cast<float*>(y), batch, n, st);
  return (int)cudaGetLastError();
}
