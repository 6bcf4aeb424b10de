// The row-tile body shared by the dense kernel (dense.cu) and the
// activation-sparse dense kernel (asp_spmv.cu): acc += x[:, r0:r0+rows] @
// A[r0:r0+rows, :] for the 4 columns c0 .. c0+3 this lane owns.
//
// A is row-major with leading dimension lda and n real columns; lane q of
// each warp owns 4 adjacent columns and reads them from each row with one
// 16-byte load (kVec: lda % 4 == 0 and A 16-byte aligned; otherwise 4 masked
// scalar loads), and the 4 warps split the rows. Each warp keeps two groups
// of kDepth rows in flight: the next group's loads are issued before the
// current group's FMAs, and the first before the barrier that publishes the
// x tile (measured on an H100 at B = 8: 40.4 -> 34.9 us, PERF.md; the same
// change made SELL slower, so it is not in sell_common.cuh). The x tile,
// x[b0 + b, r0 + u] for u < rows (0 past ldx or the batch), is staged in
// shared memory for all batch rows of the block.
#pragma once

#include "sell_common.cuh"

namespace tps {

constexpr int kRowTile = 128;
constexpr int kDepth = 4;   // rows per warp in one load group

template <int BT, bool kVec>
__device__ __forceinline__ void dense_rows(const float* __restrict__ a, int lda,
                                           int n, int c0, int r0, int rows,
                                           const float* __restrict__ x, int ldx,
                                           int b0, int batch,
                                           float (*xs)[kRowTile],
                                           float (&acc)[BT][kCols]) {
  const int warp = threadIdx.x >> 5;
  const int mine = rows > warp ? (rows - warp + kWarps - 1) / kWarps : 0;
  float4 vb[kDepth];  // the group in flight
  auto load = [&](int g) {
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      const int i = g * kDepth + u;
      if (i < mine && c0 < n) {
        const float* row = a + (size_t)(r0 + warp + i * kWarps) * lda + c0;
        if (kVec) {
          vb[u] = *reinterpret_cast<const float4*>(row);
        } else {
          vb[u] = make_float4(row[0], c0 + 1 < n ? row[1] : 0.f,
                              c0 + 2 < n ? row[2] : 0.f, c0 + 3 < n ? row[3] : 0.f);
        }
      }
    }
  };
  load(0);
  __syncthreads();  // every thread is done with the previous tile
  for (int q = threadIdx.x; q < BT * kRowTile; q += kThreads) {
    const int b = q / kRowTile, u = q % kRowTile;
    xs[b][u] = (b0 + b < batch && u < rows && r0 + u < ldx)
                   ? x[(size_t)(b0 + b) * ldx + r0 + u]
                   : 0.f;
  }
  __syncthreads();
  for (int g = 0; g * kDepth < mine; ++g) {
    float4 vc[kDepth];
#pragma unroll
    for (int u = 0; u < kDepth; ++u) vc[u] = vb[u];
    if ((g + 1) * kDepth < mine) load(g + 1);
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      const int i = g * kDepth + u;
      if (i < mine && c0 < n) {
        const int r = warp + i * kWarps;
        const float v[kCols] = {vc[u].x, vc[u].y, vc[u].z, vc[u].w};
#pragma unroll
        for (int b = 0; b < BT; ++b)
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[b][c] = fmaf(v[c], xs[b][r], acc[b][c]);
      }
    }
  }
}

}  // namespace tps
