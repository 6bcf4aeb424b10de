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
// Design: the blocks array is one (nblk * TBm, 128) panel with a leading
// dimension of 128, so K6 streams it as K2 (dense.cu) streams A; only the x
// row of panel row R differs: bi[R / TBm] * TBm + R % TBm. The (bj, bi)-
// sorted panel is cut on the host into part-tile items of one output group
// (block_items.cuh), sized as K2 sizes its slices, so a small pack still
// fills the card (blockpruned-4096 at TBm 128 gives 1024 items at 1-2 batch
// rows, where one block an item gave 320). A 128-thread block sums one item
// and batch tile; lane q of each warp owns columns 4q .. 4q+3 of the group:
// - at 8 batch rows the rows stream through a ring of kBsrStages shared-
//   memory stages of 16 rows (cp.async, issued kBsrStages-1 stages ahead of
//   the multiply, with the x values of those rows), as K2 does (staging the
//   item's x rows once instead, by plain loads, measured slower on an H100:
//   the block waited on them with only the first stages in flight);
// - at 1-4 rows K2's register-prefetch body: each warp keeps two groups of
//   4 rows in flight, the first issued before the barrier that publishes
//   the item's x rows, so no segment drains the loads (the one-block-an-item
//   kernel staged x between two barriers every 128 rows, then had 8 rows a
//   warp in flight).
// The warps' sums are added once, at the end, into the item's partial; a
// second kernel adds each group's partials (block_items.cuh).
#include "async_copy.cuh"
#include "block_items.cuh"

namespace tps {

constexpr int kBsrStageRows = 16;  // rows a ring stage: 8 KB of blocks
constexpr int kBsrStages = 4;      // stages in the ring, kBsrStages-1 in flight
constexpr int kBsrTile = kThreads;  // x rows the register body stages at once: one a thread
constexpr int kBsrDepth = 4;       // rows a warp in one load group

template <int BT>
struct BsrStage {
  float a[kBsrStageRows][kLanes];
  float x[BT][kBsrStageRows];
};

// The ring carries 8 batch rows; at 1-4 the register-prefetch body runs.
template <int BT>
constexpr bool kBsrRing = BT == 8;
// Shared memory of a block: the ring, or at 1-4 rows the x rows, then the
// warps' sums.
template <int BT>
constexpr int kBsrSmem = kBsrRing<BT> ? kBsrStages * (int)sizeof(BsrStage<BT>)
                                      : kWarps * BT * kLanes * (int)sizeof(float);

// The x column of panel row R (block R / block_m, row R % block_m).
__device__ __forceinline__ int bsr_xcol(const int* __restrict__ bi, int r, int block_m) {
  const int k = r / block_m;
  return bi[k] * block_m + (r - k * block_m);
}

// Issue the copies of panel rows r0 .. r0+15 (those below r1), and of x for
// those rows (0 past ldx or the batch), into stage st.
template <int BT>
__device__ __forceinline__ void bsr_load_stage(BsrStage<BT>& st, const float* __restrict__ blocks,
                                               const int* __restrict__ bi,
                                               const float* __restrict__ x, int block_m,
                                               int ldx, int r0, int r1, int b0, int batch) {
  for (int q = threadIdx.x; q < kBsrStageRows * kLanes / 4; q += kThreads) {
    const int u = q / (kLanes / 4), c = 4 * (q % (kLanes / 4));
    const bool ok = r0 + u < r1;
    copy_async<16>(&st.a[u][c], ok ? blocks + (size_t)(r0 + u) * kLanes + c : blocks, ok);
  }
  for (int q = threadIdx.x; q < BT * kBsrStageRows; q += kThreads) {
    const int b = q / kBsrStageRows, u = q % kBsrStageRows;
    bool ok = b0 + b < batch && r0 + u < r1;
    const int col = ok ? bsr_xcol(bi, r0 + u, block_m) : 0;
    ok = ok && col < ldx;
    copy_async<4>(&st.x[b][u], ok ? x + (size_t)(b0 + b) * ldx + col : x, ok);
  }
}

// acc += x[:, rows r0 .. r0+rows-1] @ panel[r0 .. r0+rows-1, 4*lane .. +3]
// (rows <= kBsrTile): the register-prefetch body of dense_common.cuh over
// the panel, with x's rows taken through bi.
template <int BT>
__device__ __forceinline__ void bsr_rows(const float* __restrict__ blocks,
                                         const int* __restrict__ bi, int block_m, int r0,
                                         int rows, const float* __restrict__ x, int ldx, int b0,
                                         int batch, float (*xs)[kBsrTile],
                                         float (&acc)[BT][kCols]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mine = rows > warp ? (rows - warp + kWarps - 1) / kWarps : 0;
  float4 vb[kBsrDepth];   // the group in flight
  auto load = [&](int g) {
#pragma unroll
    for (int u = 0; u < kBsrDepth; ++u) {
      const int i = g * kBsrDepth + u;
      if (i < mine)
        vb[u] = reinterpret_cast<const float4*>(
            blocks + (size_t)(r0 + warp + i * kWarps) * kLanes)[lane];
    }
  };
  load(0);
  __syncthreads();  // every thread is done with the previous rows' x
#pragma unroll
  for (int b = 0; b < BT; ++b) {   // thread u stages row u of every batch row
    const int u = threadIdx.x;
    float v = 0.f;
    if (b0 + b < batch && u < rows) {
      const int col = bsr_xcol(bi, r0 + u, block_m);
      if (col < ldx) v = x[(size_t)(b0 + b) * ldx + col];
    }
    xs[b][u] = v;
  }
  __syncthreads();
  for (int g = 0; g * kBsrDepth < mine; ++g) {
    float4 vc[kBsrDepth];
#pragma unroll
    for (int u = 0; u < kBsrDepth; ++u) vc[u] = vb[u];
    if ((g + 1) * kBsrDepth < mine) load(g + 1);
#pragma unroll
    for (int u = 0; u < kBsrDepth; ++u) {
      const int i = g * kBsrDepth + u;
      if (i < mine) {
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

template <int BT>
__global__ void __launch_bounds__(kThreads, BT == 8 ? 4 : BT == 4 ? 6 : 8)   // as K2
bsr_kernel(const int* __restrict__ items, const int* __restrict__ bi,
           const float* __restrict__ blocks, const float* __restrict__ x,
           float* __restrict__ part, int block_m, int batch, int ldx) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Item it = load_item(items, blockIdx.x);
  const int b0 = blockIdx.y * BT;
  float acc[BT][kCols];   // batch rows b0 + b, columns 4 * lane .. + 3
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[b][c] = 0.f;

  if constexpr (kBsrRing<BT>) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    auto* ring = reinterpret_cast<BsrStage<BT>*>(smem);
    const int stages = (it.r1 - it.r0 + kBsrStageRows - 1) / kBsrStageRows;
#pragma unroll
    for (int g = 0; g < kBsrStages - 1; ++g) {
      if (g < stages)
        bsr_load_stage<BT>(ring[g], blocks, bi, x, block_m, ldx, it.r0 + g * kBsrStageRows,
                           it.r1, b0, batch);
      copy_commit();
    }
    for (int g = 0; g < stages; ++g) {
      copy_wait<kBsrStages - 2>();   // this thread's copies of stage g landed
      __syncthreads();               // everyone's, and stage g-1 is free again
      const int ahead = g + kBsrStages - 1;
      if (ahead < stages)
        bsr_load_stage<BT>(ring[ahead % kBsrStages], blocks, bi, x, block_m, ldx,
                           it.r0 + ahead * kBsrStageRows, it.r1, b0, batch);
      copy_commit();
      const BsrStage<BT>& st = ring[g % kBsrStages];
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
    float (*xs)[kBsrTile] = reinterpret_cast<float (*)[kBsrTile]>(smem);
    for (int t0 = it.r0; t0 < it.r1; t0 += kBsrTile)
      bsr_rows<BT>(blocks, bi, block_m, t0, min(kBsrTile, it.r1 - t0), x, ldx, b0, batch, xs,
                   acc);
  }
  copy_wait<0>();
  __syncthreads();   // shared memory is free: it holds the warps' sums
  block_sum_store<BT>(acc, reinterpret_cast<float (*)[BT][kLanes]>(smem),
                      part + ((size_t)blockIdx.x * batch + b0) * kLanes, kLanes,
                      batch - b0, kLanes);
}

template <int BT>
void launch_bsr(dim3 grid, cudaStream_t st, const int* items, const int* bi,
                const float* blocks, const float* x, float* part, int block_m, int batch,
                int ldx) {
  constexpr int smem = kBsrSmem<BT>;
  static_assert(smem >= kWarps * BT * kLanes * (int)sizeof(float) &&
                    smem >= BT * kBsrTile * (int)sizeof(float) && smem <= 48 * 1024,
                "K6's shared memory holds the warps' sums and fits the default limit");
  bsr_kernel<BT><<<grid, kThreads, smem, st>>>(items, bi, blocks, x, part, block_m, batch, ldx);
}

}  // namespace tps

// items: (nitems, 3) int32 (group, first row, end row) over the panel's
// rows, sorted by group; gptr: (nb+1,) int32
// item offsets per group; bi: (nblk,) int32; blocks: (nblk, block_m, 128)
// fp32, 16-byte aligned, block_m a multiple of 8; x: (batch, ldx) fp32
// (missing columns read as 0); part: (nitems, batch, 128) fp32 scratch;
// y: (batch, n) fp32, n <= nb*128.
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
      case 1: tps::launch_bsr<1>(grid, st, it, ii, bb, xx, pp, block_m, batch, ldx); break;
      case 2: tps::launch_bsr<2>(grid, st, it, ii, bb, xx, pp, block_m, batch, ldx); break;
      case 4: tps::launch_bsr<4>(grid, st, it, ii, bb, xx, pp, block_m, batch, ldx); break;
      default: tps::launch_bsr<8>(grid, st, it, ii, bb, xx, pp, block_m, batch, ldx); break;
    }
  }
  tps::launch_items_reduce(static_cast<const int*>(gptr), pp, static_cast<float*>(y), batch, n,
                           st);
  return (int)cudaGetLastError();
}
