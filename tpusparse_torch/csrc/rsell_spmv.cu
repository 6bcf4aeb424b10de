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
// Design: the stream is one stream of 8-slot rows (row r is slot r % 8 of
// chunk r / 8, at r * 128), cut on the host, once per pack and batch tile,
// into items of whole chunks of one output group (block_items.cuh; the
// plan is kernels/rsell_spmv.py:rsell_plans), sized to fill the card about
// once, so a skewed pack, whose first group holds far more chunks than the
// tail groups, still spreads evenly over the SMs. An item's chunks read at
// most kRsellWin<BT> runs of one x window (8, or 4 at 8 batch rows, where 8
// windows would cost two of the 8 blocks an SM); its row in the plan names
// those windows and the first chunk of each run after the first.
// From 2 batch rows a 128-thread block sums one item and batch tile: it
// first stages the item's x windows for its batch rows in shared memory,
// all at once and once a block (16-byte loads where x allows them, one
// column quad a thread, every load in flight together, one barrier), then
// streams the item's slot rows with no barrier: lane q of each warp owns
// columns 4q .. 4q+3 of the group and reads a slot row with one 16-byte
// value load and one 4-byte index load, and the 4 warps take rows w, w+4,
// ... in K1's loop (kRsellUnroll rows' loads issued together, 8 blocks an
// SM, 6 at 4 rows). A row's window is its chunk's run: the warp moves to
// the next run when its chunk reaches that run's first chunk (kept in
// shared memory), at most once a row. At one batch row the earlier body
// runs on the same items (each warp a contiguous quarter of the chunks,
// all 8 slot rows of a chunk loaded at once, its x window staged by the
// warp), which measured 0.93-0.98 x the block-staged body there on an
// H100 (PERF.md). The warps' sums are added once, at the end, into the
// item's partial; a second kernel adds each group's partials in a fixed
// order (block_items.cuh: the group reduce of work_items.cuh at 1-4 batch
// rows, which splits the skewed pack's first group over 32 slices, and one
// thread an output at 8, which measured 2-3 us faster there on both packs).
#include <climits>

#include "block_items.cuh"

namespace tps {

constexpr int kSub = 8;          // slot rows per chunk
constexpr int kRsellItemWin = 8;   // window columns of an item's row in the plan
constexpr int kRsellItem = 3 + 2 * kRsellItemWin - 1;   // int32 an item in the plan
// Rows a warp's loop unrolls: their loads are issued together.
constexpr int kRsellUnroll = 8;
// x windows an item stages at most, by batch rows (the plan's MAX_WINDOWS)
template <int BT>
constexpr int kRsellWin = BT == 8 ? 4 : 8;

// Shared memory of a block: the item's x windows, later the warps' sums.
template <int BT>
constexpr int kRsellSmem = ((kRsellWin<BT>) > kWarps ? (kRsellWin<BT>) : kWarps) * BT * kLanes * (int)sizeof(float);

template <int BT>
__global__ void __launch_bounds__(kThreads, BT == 4 ? 6 : 8)
rsell_item_kernel(const int* __restrict__ items, const int8_t* __restrict__ idx,
                  const float* __restrict__ vals, const float* __restrict__ x,
                  float* __restrict__ part, int batch, int ldx, bool vec_x) {
  constexpr int W = kRsellWin<BT>;
  extern __shared__ __align__(16) unsigned char smem[];
  auto* xs = reinterpret_cast<float (*)[BT][kLanes]>(smem);   // [W][BT][128]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __shared__ int runs[kRsellItemWin];   // the chunks where the item's runs after the first start
  const int* it = items + (size_t)blockIdx.x * kRsellItem;
  const int r0 = it[1], r1 = it[2];
  int win[W];
#pragma unroll
  for (int v = 0; v < W; ++v) win[v] = it[3 + v];
  if (threadIdx.x < kRsellItemWin)   // past W - 1: none (the plan's 2^31 - 1, or this)
    runs[threadIdx.x] = threadIdx.x < W - 1 ? it[3 + kRsellItemWin + threadIdx.x] : INT_MAX;
  const int b0 = blockIdx.y * BT;
  const int rows = r1 - r0;
  const int mine = rows > warp ? (rows - warp + kWarps - 1) / kWarps : 0;
  float acc[BT][kCols];   // batch rows b0 + b, columns 4 * lane .. + 3
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[b][c] = 0.f;

  // this lane's 4 columns of the warp's first row; row i is kWarps * i rows on
  const size_t first = (size_t)(r0 + warp) * kLanes + kCols * lane;
  const float4* vrow = reinterpret_cast<const float4*>(vals + first);
  const char4* irow = reinterpret_cast<const char4*>(idx + first);
  constexpr int kStep = kWarps * kLanes / kCols;   // float4s (char4s) from one row to the next

  if (vec_x) {
    // x rows of 16-byte quads: thread t stages quad t % 32 of rows
    // (window, batch row) t / 32, t / 32 + 4, ..., every load at once
#pragma unroll
    for (int j = 0; j < W * BT / kWarps; ++j) {
      const int wb = warp + kWarps * j, v = wb / BT, b = wb % BT;
      int t = win[0];
#pragma unroll
      for (int u = 1; u < W; ++u) t = v == u ? win[u] : t;
      const int col = t * kLanes + kCols * lane;
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t >= 0 && b0 + b < batch && col < ldx)
        q = *reinterpret_cast<const float4*>(x + (size_t)(b0 + b) * ldx + col);
      reinterpret_cast<float4*>(xs[v][b])[lane] = q;
    }
  } else {
    // thread i stages column i of every window and batch row
#pragma unroll
    for (int v = 0; v < W; ++v)
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const int col = win[v] * kLanes + threadIdx.x;
        xs[v][b][threadIdx.x] = (win[v] >= 0 && b0 + b < batch && col < ldx)
                                    ? x[(size_t)(b0 + b) * ldx + col]
                                    : 0.f;
      }
  }
  __syncthreads();

  // the window slot of the row's chunk: the runs started at or before it.
  // A warp's next row is 4 rows on, so at most one run starts between them.
  int slot = 0, next = runs[0];
#pragma unroll kRsellUnroll
  for (int i = 0; i < mine; ++i) {
    const float4 q = vrow[(size_t)i * kStep];
    const char4 c4 = irow[(size_t)i * kStep];
    const float v[kCols] = {q.x, q.y, q.z, q.w};
    const int ii[kCols] = {c4.x, c4.y, c4.z, c4.w};   // in-window offsets
    if ((r0 + warp + i * kWarps) / kSub >= next) next = runs[++slot];
    const float (*xw)[kLanes] = xs[slot];
#pragma unroll
    for (int b = 0; b < BT; ++b)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[b][c] = fmaf(v[c], xw[b][ii[c]], acc[b][c]);
  }
  __syncthreads();   // done with the windows: the memory holds the warps' sums
  block_sum_store<BT>(acc, reinterpret_cast<float (*)[BT][kLanes]>(smem),
                      part + ((size_t)blockIdx.x * batch + b0) * kLanes, kLanes,
                      batch - b0, kLanes);
}

// One batch row: the earlier K4's body on the same items, which streamed
// faster there on an H100 than staging the windows once a block (PERF.md).
// The 4 warps take contiguous quarters of the item's chunks; a warp loads
// all 8 slot rows of a chunk into registers, then stages that chunk's x
// window in its own slice of shared memory (only when it differs from the
// one it holds), then gathers from there.
__global__ void __launch_bounds__(kThreads)
rsell_warp_kernel(const int* __restrict__ items, const int* __restrict__ ct,
                  const int8_t* __restrict__ idx, const float* __restrict__ vals,
                  const float* __restrict__ x, float* __restrict__ part, int ldx) {
  __shared__ float xs[kWarps][kLanes];
  __shared__ __align__(16) float red[kWarps][1][kLanes];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* it = items + (size_t)blockIdx.x * kRsellItem;
  const int c0 = it[1] / kSub, c1 = it[2] / kSub;
  const int q = (c1 - c0 + kWarps - 1) / kWarps;
  const int k0 = c0 + warp * q, k1 = min(c1, k0 + q);
  float acc[1][kCols] = {{0.f, 0.f, 0.f, 0.f}};
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
      for (int e = lane; e < kLanes; e += 32) {
        const int col = t * kLanes + e;
        xs[warp][e] = col < ldx ? x[col] : 0.f;
      }
      __syncwarp();
      held = t;
    }
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      const float vv[kCols] = {v[s].x, v[s].y, v[s].z, v[s].w};
      const int ii[kCols] = {ix[s].x, ix[s].y, ix[s].z, ix[s].w};
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[0][c] = fmaf(vv[c], xs[warp][ii[c]], acc[0][c]);
    }
  }
  block_sum_store<1>(acc, red, part + (size_t)blockIdx.x * kLanes, kLanes, 1, kLanes);
}

template <int BT>
void launch_rsell(dim3 grid, cudaStream_t st, const int* items, const int8_t* idx,
                  const float* vals, const float* x, float* part, int batch, int ldx,
                  bool vec_x) {
  constexpr int smem = kRsellSmem<BT>;
  static_assert(kRsellWin<BT> * BT % kWarps == 0 && kRsellWin<BT> <= kRsellItemWin,
                "the 16-byte staging covers every window row of the plan's");
  static_assert(smem >= kWarps * BT * kLanes * (int)sizeof(float) &&
                    smem >= kRsellWin<BT> * BT * kLanes * (int)sizeof(float) && smem <= 48 * 1024,
                "K4's shared memory holds the windows and the warps' sums and fits the "
                "default limit");
  rsell_item_kernel<BT><<<grid, kThreads, smem, st>>>(items, idx, vals, x, part, batch, ldx,
                                                      vec_x);
}

}  // namespace tps

// items: (nitems, 18) int32 (group, first row, end row, the item's 8 x
// windows (-1 past the last; at most kRsellWin<bt> live), the first chunk
// of each window's run after the first (2^31 - 1 past the last)) over the
// stream of slot rows, whole chunks, sorted by group; gptr: (nb+1,) int32
// item offsets per group;
// ct: (nchunk,) int32 each chunk's x window (read at one batch row);
// idx/vals: (nchunk, 8, 128) int8 / fp32, 16-byte aligned; x: (batch, ldx)
// fp32 (missing columns read as 0); part: (nitems, batch, 128) fp32
// scratch; y: (batch, n) fp32, n <= nb*128.
extern "C" int tps_rsell_spmm(const void* items, const void* gptr, const void* ct,
                              const void* idx, const void* vals, const void* x, void* part,
                              void* y, int nitems, int batch, int ldx, int n, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* it = static_cast<const int*>(items);
  const auto* ix = static_cast<const int8_t*>(idx);
  const auto* vv = static_cast<const float*>(vals);
  const auto* xx = static_cast<const float*>(x);
  auto* pp = static_cast<float*>(part);
  if (batch <= 0 || n <= 0) return (int)cudaGetLastError();
  if (nitems > 0) {
    const int bt = tps::batch_tile(batch);
    const dim3 grid(nitems, (batch + bt - 1) / bt);
    const bool vec_x = ldx % tps::kCols == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    switch (bt) {
      case 1:
        tps::rsell_warp_kernel<<<grid, tps::kThreads, 0, st>>>(
            it, static_cast<const int*>(ct), ix, vv, xx, pp, ldx);
        break;
      case 2: tps::launch_rsell<2>(grid, st, it, ix, vv, xx, pp, batch, ldx, vec_x); break;
      case 4: tps::launch_rsell<4>(grid, st, it, ix, vv, xx, pp, batch, ldx, vec_x); break;
      default: tps::launch_rsell<8>(grid, st, it, ix, vv, xx, pp, batch, ldx, vec_x); break;
    }
  }
  tps::launch_items_reduce(static_cast<const int*>(gptr), pp, static_cast<float*>(y), batch, n,
                           st);
  return (int)cudaGetLastError();
}
