// Part-tile work items, shared by K6 (bsr_spmv.cu) and K7 (bsell_spmv.cu).
//
// The host (tpusparse_torch/kernels/block_items.py) sees a pack's tiles,
// sorted by output group, as one stream of rows: row r is row r % rows of
// tile r / rows and is stored at r * 128. It cuts each group's run of rows
// into items (group, first row, end row), sorted by group. Items of a part
// of a tile let a pack of few tiles fill the card (320 one-tile items ran
// 2.4 blocks an SM on blockpruned-4096, H100, PERF.md).
//
// A block (blockIdx.x the item, blockIdx.y the batch tile) sums its item
// into part[(item * batch + b) * 128 + c]; a second kernel then adds each
// group's partials in a fixed order (deterministic, no float atomics; a
// group with no item gets zeros): at 1-4 batch rows the group reduce
// of work_items.cuh, which splits a group's items over 32 threads, at 8
// item_reduce_kernel below, one thread an output. On an H100 each measured
// faster where it runs than the other, and both faster than summing in the
// items' kernel by its last block to arrive (PERF.md).
#pragma once

#include <cuda_runtime.h>

#include "sell_common.cuh"
#include "work_items.cuh"

namespace tps {

static_assert(kThreads == kLanes, "a block's thread i stages column (or row) i of x");

struct Item {
  int group, r0, r1;   // rows r0 .. r1-1 of the stream
};

__device__ __forceinline__ Item load_item(const int* __restrict__ items, int i) {
  return Item{items[3 * i], items[3 * i + 1], items[3 * i + 2]};
}

// y[b, c] = group c / 128's partials added in item order from 0.f, one
// thread an output (b, c). kDst: the sum goes to y[b, dst[c]] (rows ldy
// apart; nowhere where dst[c] < 0), as in group_reduce_kernel.
template <bool kDst>
static __global__ void __launch_bounds__(256)
item_reduce_kernel(const int* __restrict__ gptr, const float* __restrict__ part,
                   float* __restrict__ y, int batch, int n, const int* __restrict__ dst,
                   int ldy) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= batch * n) return;
  const int b = e / n, c = e - b * n, j = c / kLanes;
  const int i0 = gptr[j], i1 = gptr[j + 1];
  const size_t step = (size_t)batch * kLanes;
  const float* p = part + ((size_t)i0 * batch + b) * kLanes + (c - j * kLanes);
  float s = 0.f;
  for (int i = i0; i < i1; ++i, p += step) s += *p;
  if (!kDst)
    y[e] = s;
  else if (dst[c] >= 0)
    y[(size_t)b * ldy + dst[c]] = s;
}

// The second pass over a call's partials (nitems, batch, 128): the pack's
// columns c < n (n <= groups * 128) into y (batch, n), or, with dst (K4's
// fused unpermute), into y (batch, ldy) at columns dst[c].
inline void launch_items_reduce(const int* gptr, const float* part, float* y, int batch, int n,
                                cudaStream_t st, const int* dst = nullptr, int ldy = 0) {
  if (batch <= 0 || n <= 0) return;
  if (batch_tile(batch) != 8)
    launch_group_reduce(gptr, part, y, batch, n, st, dst, ldy);
  else if (dst != nullptr)
    item_reduce_kernel<true><<<(batch * n + 255) / 256, 256, 0, st>>>(gptr, part, y, batch, n,
                                                                     dst, ldy);
  else
    item_reduce_kernel<false><<<(batch * n + 255) / 256, 256, 0, st>>>(gptr, part, y, batch, n,
                                                                      nullptr, 0);
}

}  // namespace tps
