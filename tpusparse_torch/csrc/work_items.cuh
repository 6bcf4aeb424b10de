// The second pass of the kernels that walk a sorted tile stream by work
// items (K4 RSELL, K6 BSR, K7 block-SELL).
//
// The host cuts a stream of tiles (or chunks), sorted by output group, into
// items (tpusparse_torch/kernels/rsell_spmv.py:work_plan): runs of
// consecutive tiles of one group, at most a few tiles each. A block sums one
// item into a (batch, 128) partial; the kernel below then adds each group's
// partials in a fixed order (deterministic: no float atomics) and writes y.
#pragma once

#include <cuda_runtime.h>

namespace tps {

// y[b, c] = sum of part[i, b, c % 128] over the items i of group c / 128
// (gptr[j] .. gptr[j+1]). The first group of a sorted skewed pack holds far
// more items than the others (one thread per column added them in 8.65 us of
// a 30.24 us RSELL call on the 8192^2 powerlaw pack, H100, PERF.md), so a
// block of 32 columns x 32 item slices splits each group's items: thread
// (c, r) adds items i0 + r, i0 + r + 32, ... in order, and the 32 slice sums
// of a column are added in slice order (deterministic).
//
// kDst (K4 on a column-sorted pack): the sum of the pack's column c is
// written to y's column dst[c] (nowhere where dst[c] < 0), y's rows ldy
// apart: the unpermute of the pack-order sum, bit for bit, with no launch of
// its own; the blocks still read the partials in pack order, coalesced.
constexpr int kRedCols = 32, kRedSlices = 32;

template <bool kDst>
static __global__ void __launch_bounds__(kRedCols * kRedSlices)
group_reduce_kernel(const int* __restrict__ gptr, const float* __restrict__ part,
                    float* __restrict__ y, int batch, int n, const int* __restrict__ dst,
                    int ldy) {
  constexpr int lanes = 128;
  __shared__ float red[kRedSlices][kRedCols + 1];
  const int c = threadIdx.x, r = threadIdx.y, b = blockIdx.y;
  const int j = blockIdx.x / (lanes / kRedCols);
  const int col = (blockIdx.x % (lanes / kRedCols)) * kRedCols + c;
  const int i0 = gptr[j], i1 = gptr[j + 1];
  const size_t stride = (size_t)batch * lanes;
  const float* p = part + (size_t)b * lanes + col;
  float s = 0.f;
#pragma unroll 4
  for (int i = i0 + r; i < i1; i += kRedSlices) s += p[(size_t)i * stride];
  red[r][c] = s;
  __syncthreads();
  if (r == 0) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < kRedSlices; ++q) t += red[q][c];
    if (j * lanes + col < n) {
      if (!kDst)
        y[(size_t)b * n + j * lanes + col] = t;
      else if (dst[j * lanes + col] >= 0)
        y[(size_t)b * ldy + dst[j * lanes + col]] = t;
    }
  }
}

// Launch the reduce of the pack's columns c < n for y (batch, n), or, with
// dst, for y (batch, ldy) through dst: one block per 32 columns and batch
// row. A group with no items writes zeros.
inline void launch_group_reduce(const int* gptr, const float* part, float* y,
                                int batch, int n, cudaStream_t st,
                                const int* dst = nullptr, int ldy = 0) {
  if (batch <= 0 || n <= 0) return;
  const int groups = (n + 127) / 128;
  const dim3 grid(groups * (128 / kRedCols), batch);
  if (dst != nullptr)
    group_reduce_kernel<true><<<grid, dim3(kRedCols, kRedSlices), 0, st>>>(gptr, part, y, batch,
                                                                           n, dst, ldy);
  else
    group_reduce_kernel<false><<<grid, dim3(kRedCols, kRedSlices), 0, st>>>(gptr, part, y, batch,
                                                                            n, nullptr, 0);
}

}  // namespace tps
