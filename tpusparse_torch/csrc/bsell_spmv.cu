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
// Design: the tiles are one stream of W-slot rows (row r of the stream is
// slot r % W of tile r / W, at r * 128), cut on the host into part-tile
// items of one output group (block_items.cuh), at most kMaxWin tiles each:
// blockpruned-4096's 320 tiles of W 88 give 1024 items at 1-2 batch rows,
// where one block a tile left the card with 2.4 blocks an SM. A 128-thread
// block sums one item and batch tile. It stages the x windows of all the
// item's tiles at once (bi[k]: one barrier an item, not two a tile; thread
// i loads column i of every window and batch row, all in flight together),
// then streams the item's slot rows with no barrier: lane q of each warp
// owns columns 4q .. 4q+3 and reads a slot row with one 16-byte value load
// and one 4-byte index load, and the 4 warps take rows w, w+4, ... At 1-4
// batch rows each warp keeps two groups of kBsellDepth rows in flight (the
// next group's loads issued before the current group's gathers from
// shared memory and FFMAs; the first group before the barrier, which
// measured 0.2-1 us faster on an H100 than after it); at 8 it runs K1's
// loop. The warps' sums are added once, at the end, into the item's
// partial; a second kernel adds each group's partials (block_items.cuh).
#include "block_items.cuh"

namespace tps {

constexpr int kMaxWin = 4;        // x windows an item spans at most (the plan's max_tiles)
// Slot rows a warp in one load group at 1-4 batch rows: 2, which keeps the
// kernel within 64 registers at 1-2 rows (8 blocks an SM; 4 rows spilled
// there). At 8 rows the gather from shared memory, not HBM, sets the time,
// and K1's loop (4 rows unrolled, their loads hoisted, no buffer pair)
// keeps 64 registers and 8 blocks an SM: 3 us faster at the headline than
// two groups of 2 at 6 blocks an SM, and level on blockpruned-4096
// (PERF.md).
constexpr int kBsellDepth = 2;

// Shared memory of a block: the item's x windows, later the warps' sums.
template <int BT>
constexpr int kBsellSmem = (kMaxWin > kWarps ? kMaxWin : kWarps) * BT * kLanes * (int)sizeof(float);

template <int BT>
__global__ void __launch_bounds__(kThreads, BT == 4 ? 6 : 8)
bsell_kernel(const int* __restrict__ items, const int* __restrict__ bi,
             const int8_t* __restrict__ idx, const float* __restrict__ vals,
             const float* __restrict__ x, float* __restrict__ part, int w, int batch,
             int ldx) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto* xs = reinterpret_cast<float (*)[BT][kLanes]>(smem);   // [kMaxWin][BT][128]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Item it = load_item(items, blockIdx.x);
  const int b0 = blockIdx.y * BT;
  const int rows = it.r1 - it.r0;
  const int mine = rows > warp ? (rows - warp + kWarps - 1) / kWarps : 0;
  const int k0 = rows > 0 ? it.r0 / w : 0;                     // the item's first tile
  const int nwin = rows > 0 ? (it.r1 - 1) / w - k0 + 1 : 0;    // <= kMaxWin
  float acc[BT][kCols];   // batch rows b0 + b, columns 4 * lane .. + 3
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[b][c] = 0.f;

  // this lane's 4 columns of the warp's first row; row i is kWarps * i rows on
  const size_t first = (size_t)(it.r0 + warp) * kLanes + kCols * lane;
  const float4* vrow = reinterpret_cast<const float4*>(vals + first);
  const char4* irow = reinterpret_cast<const char4*>(idx + first);
  constexpr int kStep = kWarps * kLanes / kCols;   // float4s (char4s) from one row to the next
  float4 vb[kBsellDepth];   // the group in flight: values and offsets
  char4 ib[kBsellDepth];
  auto load = [&](int g) {
    const float4* vg = vrow + (size_t)g * kBsellDepth * kStep;
    const char4* ig = irow + (size_t)g * kBsellDepth * kStep;
#pragma unroll
    for (int u = 0; u < kBsellDepth; ++u) {
      if (g * kBsellDepth + u < mine) {
        vb[u] = vg[u * kStep];
        ib[u] = ig[u * kStep];
      }
    }
  };
  if constexpr (BT < 8) load(0);   // in flight across the staging barrier
  {   // thread i stages column i of every window and batch row: all loads at once
    int t[kMaxWin];
#pragma unroll
    for (int v = 0; v < kMaxWin; ++v) t[v] = v < nwin ? bi[k0 + v] : 0;
#pragma unroll
    for (int v = 0; v < kMaxWin; ++v)
      if (v < nwin)
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          const int col = t[v] * kLanes + threadIdx.x;
          xs[v][b][threadIdx.x] =
              (b0 + b < batch && col < ldx) ? x[(size_t)(b0 + b) * ldx + col] : 0.f;
        }
  }
  __syncthreads();
  // the warp's next row to multiply, it.r0 + warp + i * kWarps, as (window, slot)
  int cw = 0, cs = 0;
  if (mine > 0) {
    cw = (it.r0 + warp) / w - k0;
    cs = it.r0 + warp - (cw + k0) * w;
  }
  if constexpr (BT == 8) {
#pragma unroll 4
    for (int i = 0; i < mine; ++i) {
      const float4 q = vrow[(size_t)i * kStep];
      const char4 c4 = irow[(size_t)i * kStep];
      const float v[kCols] = {q.x, q.y, q.z, q.w};
      const int ii[kCols] = {c4.x, c4.y, c4.z, c4.w};   // in-window offsets
      const float (*xw)[kLanes] = xs[cw];
#pragma unroll
      for (int b = 0; b < BT; ++b)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[b][c] = fmaf(v[c], xw[b][ii[c]], acc[b][c]);
      for (cs += kWarps; cs >= w; cs -= w) ++cw;
    }
  } else {
    for (int g = 0; g * kBsellDepth < mine; ++g) {
      float4 vc[kBsellDepth];
      char4 ic[kBsellDepth];
#pragma unroll
      for (int u = 0; u < kBsellDepth; ++u) {
        vc[u] = vb[u];
        ic[u] = ib[u];
      }
      if ((g + 1) * kBsellDepth < mine) load(g + 1);
#pragma unroll
      for (int u = 0; u < kBsellDepth; ++u) {
        if (g * kBsellDepth + u < mine) {
          const float v[kCols] = {vc[u].x, vc[u].y, vc[u].z, vc[u].w};
          const int ii[kCols] = {ic[u].x, ic[u].y, ic[u].z, ic[u].w};   // in-window offsets
          const float (*xw)[kLanes] = xs[cw];
#pragma unroll
          for (int b = 0; b < BT; ++b)
#pragma unroll
            for (int c = 0; c < kCols; ++c) acc[b][c] = fmaf(v[c], xw[b][ii[c]], acc[b][c]);
          for (cs += kWarps; cs >= w; cs -= w) ++cw;
        }
      }
    }
  }
  __syncthreads();   // done with the windows: the memory holds the warps' sums
  block_sum_store<BT>(acc, reinterpret_cast<float (*)[BT][kLanes]>(smem),
                      part + ((size_t)blockIdx.x * batch + b0) * kLanes, kLanes,
                      batch - b0, kLanes);
}

template <int BT>
void launch_bsell(dim3 grid, cudaStream_t st, const int* items, const int* bi,
                  const int8_t* idx, const float* vals, const float* x, float* part, int w,
                  int batch, int ldx) {
  constexpr int smem = kBsellSmem<BT>;
  static_assert(smem >= kWarps * BT * kLanes * (int)sizeof(float) &&
                    smem >= kMaxWin * BT * kLanes * (int)sizeof(float) && smem <= 48 * 1024,
                "K7's shared memory holds the windows and the warps' sums and fits the "
                "default limit");
  bsell_kernel<BT><<<grid, kThreads, smem, st>>>(items, bi, idx, vals, x, part, w, batch, ldx);
}

}  // namespace tps

// items: (nitems, 3) int32 (group, first row, end row) over the stream of
// slot rows, sorted by group, each within kMaxWin tiles; gptr: (nb+1,) int32 item offsets per group; bi: (nblk,)
// int32; idx/vals: (nblk, w, 128) int8 / fp32, 16-byte aligned; x: (batch,
// ldx) fp32 (missing columns read as 0); part: (nitems, batch, 128) fp32
// scratch; y: (batch, n) fp32, n <= nb*128.
extern "C" int tps_bsell_spmm(const void* items, const void* gptr, const void* bi,
                              const void* idx, const void* vals, const void* x,
                              void* part, void* y, int nitems, int w, int batch,
                              int ldx, int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (w <= 0) return (int)cudaErrorInvalidValue;
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
      case 1: tps::launch_bsell<1>(grid, st, it, ii, ix, vv, xx, pp, w, batch, ldx); break;
      case 2: tps::launch_bsell<2>(grid, st, it, ii, ix, vv, xx, pp, w, batch, ldx); break;
      case 4: tps::launch_bsell<4>(grid, st, it, ii, ix, vv, xx, pp, w, batch, ldx); break;
      default: tps::launch_bsell<8>(grid, st, it, ii, ix, vv, xx, pp, w, batch, ldx); break;
    }
  }
  tps::launch_items_reduce(static_cast<const int*>(gptr), pp, static_cast<float*>(y), batch, n,
                           st);
  return (int)cudaGetLastError();
}
