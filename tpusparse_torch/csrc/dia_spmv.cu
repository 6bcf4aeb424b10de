// DIA SpMV for Hopper: k diagonals of a square A stored as (k, ldv) rows,
//   y[p] = sum_i vals[i, p] * x[p + d_i]
//        (+ vals[i, p - d_i] * x[p - d_i] for each d_i > 0 when `sym`),
// with reads outside [0, n) as 0.
//
// Replaces the TPU kernel tpusparse/kernels/dia_spmv.py:_dia_kernel
// (through dia_spmv_pallas). That kernel loads each grid block's x slab and
// a halo on each side once, forms every shifted window in registers
// (a sublane slice plus a lane roll), and builds the mirror values from the
// block's own vals rows plus a halo, so that each operand streams from HBM
// once. Its halo strips carry a neighbour's edge in the sharded partition;
// on one device they are zero, which the zero fill below gives.
//
// Bound: bytes. Each output position reads its k stored values, x once and
// writes y once; 2 flops a product. The 1M-unknown sym 5-point Laplacian
// (3 stored diagonals: vals 12.6 MB, x and y 4.2 MB each) takes 6.3 us at
// 3.35 TB/s; HPCG's 27-point stencil on 104^3 (14 stored diagonals: vals
// 63.0 MB) 21.5 us.
//
// Design: one tile of T consecutive outputs a block (T a multiple of 128;
// 256 threads, 4 outputs a thread a pass of 1024). The host builds a plan
// once per matrix (kernels/dia_spmv.py:dia_plan): the terms in the TPU
// kernel's order (diagonal i, then its mirror) and, for each source (x, or
// a vals row), the shifts at which the terms read it, grouped into windows
// of nearby shifts (neighbours at most T apart share one). A block copies
// each window [base + lo, base + T + hi) of its tile into shared memory
// once, by 16-byte cp.async from a 16-byte boundary at or below its first
// read (4-byte copies in the scalar body), zeros outside [0, n); then it
// forms every term from shared memory. So x is staged once for all its
// nearby diagonals (the Laplacian's -1..1 and +-1024 share one window), and
// a sym row's window [base - d, base + T) serves both its direct term at p
// and its mirror at p - d; a far row (d > T) reads its mirror through a
// window of its own, which an earlier tile read from HBM and this one reads
// from L2. The loads of all windows are in flight at once, and the card
// holds several blocks an SM (7 on the Laplacian at T = 1024), so one
// block's products overlap the others' copies. Persistent blocks that walk
// tiles in order through rings of shared memory, reusing each halo, cross
// L2 once but measured slower: a block's tiles then wait on each other.
//
// In the products a warp takes 128 consecutive outputs, lane l the outputs
// l, l + 32, l + 64, l + 96: each read of a window at any shift is 32
// consecutive floats, one conflict-free shared load with an immediate
// offset. Four consecutive outputs a thread, read as float4s, would cost a
// second load and a selection at every shift that is no multiple of 4, and
// the products, not the copies, then set the time. Each product is
// __fmul_rn and each sum __fadd_rn in the TPU kernel's order, so the result
// is the plain version's, bit for bit (a mirror read before 0 adds 0 * 0).
// y is written 128 bytes a warp store.
//
// L2 -> SM bytes a position against the HBM bound: every tile reads its
// windows, each T plus its span, and writes y. The Laplacian at T = 1024
// moves 8 floats a position (x 3, vals 4, y 1) against 5 (1.6x the HBM
// bytes); HPCG's 27-point stencil about 30 against 16 (1.9x): its 9 far
// rows read their direct and mirror windows apart. That ratio, at the L2's
// rate, sets a limit below the HBM rate.
//
// Windows that would not fit the plan's shared-memory budget stay in global
// memory: their terms read x or vals there, 128 bytes a warp load with
// bounds tests, in the same kernel (a slower loop, whose loads wait in
// turn; the plan first takes a smaller tile that stages every window). The scalar body (n % 4, ldv % 4 or a
// pointer off 16 bytes) is the same kernel with 4-byte copies; the wrapper
// picks it by shape before the launch.
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace tps {

constexpr int kMaxDiags = 32;
constexpr int kDiaThreads = 256, kDiaPer = 4;
constexpr int kDiaPass = kDiaThreads * kDiaPer;      // positions a pass
constexpr int kDiaWarpSpan = 32 * kDiaPer;            // a warp's outputs
constexpr int kMaxTerms = 2 * kMaxDiags - 1;          // diagonals + mirrors
constexpr int kMaxWindows = 4 * kMaxDiags - 1;        // x's and the rows'

// One term: x at p + e, vals row `row` at p + s (s = 0, or -d for a
// mirror); xi, vi: the shared-memory index of the tile's first position's
// read, or -1 where its window stays in global memory.
struct DiaTerm {
  int e, s, row, xi, vi;
};
// One staged window: source (-1 for x, else a vals row), first position
// relative to the tile's base (a multiple of 4), length and shared-memory
// offset in floats (multiples of 4).
struct DiaWindow {
  int src, lo, len, off;
};
struct DiaPlan {
  DiaTerm term[kMaxTerms];
  DiaWindow win[kMaxWindows];
};

__device__ __forceinline__ float fmadd(float acc, float v, float x) {
  return __fadd_rn(acc, __fmul_rn(v, x));
}

template <bool VEC>
__global__ void __launch_bounds__(kDiaThreads)
dia_tile_kernel(const float* __restrict__ vals, const float* __restrict__ x,
                float* __restrict__ y, const __grid_constant__ DiaPlan plan, int nterms,
                int nwin, int staged, int tile, int n, int ldv) {
  extern __shared__ __align__(16) float smem[];
  const long long base = (long long)blockIdx.x * tile;
  // Stage every window once: 16-byte copies (n % 4 == 0 and the window
  // starts on 4 positions, so a chunk lies wholly inside or outside [0, n)),
  // or 4-byte copies in the scalar body; zeros outside [0, n).
  for (int w = 0; w < nwin; ++w) {
    const DiaWindow win = plan.win[w];
    const float* src = win.src < 0 ? x : vals + (size_t)win.src * ldv;
    const long long g0 = base + win.lo;
    float* dst = smem + win.off;
    constexpr int step = VEC ? 4 : 1;
    for (int c = threadIdx.x * step; c < win.len; c += kDiaThreads * step) {
      const long long g = g0 + c;
      const bool ok = g >= 0 && g < n;
      copy_async<VEC ? 16 : 4>(dst + c, ok ? src + g : src, ok);
    }
  }
  copy_commit();
  copy_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int q0 = (threadIdx.x >> 5) * kDiaWarpSpan; q0 < tile; q0 += kDiaPass) {
    if (base + q0 >= n) break;
    const int q = q0 + lane;                  // outputs q + 32 j
    const long long p = base + q;
    float acc[kDiaPer] = {0.f, 0.f, 0.f, 0.f};
    if (staged) {          // every term from shared memory
#pragma unroll 2
      for (int t = 0; t < nterms; ++t) {
        const float* xs = smem + plan.term[t].xi + q;
        const float* vs = smem + plan.term[t].vi + q;
#pragma unroll
        for (int j = 0; j < kDiaPer; ++j) acc[j] = fmadd(acc[j], vs[32 * j], xs[32 * j]);
      }
    } else {
      for (int t = 0; t < nterms; ++t) {
        const DiaTerm tm = plan.term[t];
        const float* vrow = vals + (size_t)tm.row * ldv;
        float xv[kDiaPer], vv[kDiaPer];
#pragma unroll
        for (int j = 0; j < kDiaPer; ++j) {
          const long long px = p + 32 * j + tm.e, pv = p + 32 * j + tm.s;
          // a position past n reads 0 and is not stored
          xv[j] = tm.xi >= 0 ? smem[tm.xi + q + 32 * j]
                             : (px >= 0 && px < n ? __ldg(x + px) : 0.f);
          vv[j] = tm.vi >= 0 ? smem[tm.vi + q + 32 * j]
                             : (pv >= 0 && p + 32 * j < n ? __ldg(vrow + pv) : 0.f);
        }
#pragma unroll
        for (int j = 0; j < kDiaPer; ++j) acc[j] = fmadd(acc[j], vv[j], xv[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kDiaPer; ++j)
      if (p + 32 * j < n) y[p + 32 * j] = acc[j];
  }
}

// The opt-in dynamic shared memory each body was given, by device (0: not
// yet). File scope, not a template-local static: those are process-wide
// symbols shared with any other library holding the same template.
constexpr int kMaxDevices = 64;
static int dia_smem_limit[2][kMaxDevices];

template <bool VEC>
int dia_launch(const DiaPlan& plan, const float* vals, const float* x, float* y, int nterms,
               int nwin, int staged, int tile, int smem_bytes, int n, int ldv, int device,
               cudaStream_t st) {
  if (smem_bytes > 48 * 1024) {
    int* limit = dia_smem_limit[VEC ? 1 : 0];
    int lim = device < kMaxDevices ? limit[device] : 0;
    if (lim == 0) {
      cudaError_t err =
          cudaDeviceGetAttribute(&lim, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
      if (err != cudaSuccess) return (int)err;
      cudaFuncAttributes attr;   // the block's static shared memory counts too
      err = cudaFuncGetAttributes(&attr, dia_tile_kernel<VEC>);
      if (err != cudaSuccess) return (int)err;
      lim -= (int)attr.sharedSizeBytes;
      err = cudaFuncSetAttribute(dia_tile_kernel<VEC>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, lim);
      if (err != cudaSuccess) return (int)err;
      if (device < kMaxDevices) limit[device] = lim;
    }
    if (smem_bytes > lim) return (int)cudaErrorInvalidValue;
  }
  const unsigned blocks = (unsigned)((n + (long long)tile - 1) / tile);
  dia_tile_kernel<VEC><<<blocks, kDiaThreads, smem_bytes, st>>>(vals, x, y, plan, nterms, nwin,
                                                                 staged, tile, n, ldv);
  return (int)cudaGetLastError();
}

}  // namespace tps

// plan: host int32 words, nterms terms of 5 (e, s, row, xi, vi) then nwin
// windows of 4 (src, lo, len, off), as kernels/dia_spmv.py:dia_plan lays
// them out; vals: (k, ldv) fp32 rows with ldv >= n, k <= 32; x, y: (n,)
// fp32; tile: positions a block, a multiple of 128; smem_bytes: the staged
// windows' bytes; vec: 1 for the 16-byte copies (n % 4 == ldv % 4 == 0,
// vals and x 16-byte aligned), 0 for the scalar body.
extern "C" int tps_dia_spmv(const void* plan, const void* vals, const void* x, void* y,
                            int nterms, int nwin, int tile, int smem_bytes, int vec, int n,
                            int ldv, int device, void* stream) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nterms <= 0 || nterms > tps::kMaxTerms || nwin < 0 || nwin > tps::kMaxWindows ||
      tile <= 0 || tile % tps::kDiaWarpSpan || ldv < n || smem_bytes < 0)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  tps::DiaPlan p{};
  const int* words = static_cast<const int*>(plan);
  int staged = 1;
  for (int t = 0; t < nterms; ++t, words += 5) {
    p.term[t] = tps::DiaTerm{words[0], words[1], words[2], words[3], words[4]};
    staged &= p.term[t].xi >= 0 && p.term[t].vi >= 0;
  }
  for (int w = 0; w < nwin; ++w, words += 4) {
    p.win[w] = tps::DiaWindow{words[0], words[1], words[2], words[3]};
    const tps::DiaWindow& win = p.win[w];
    if (win.lo % 4 || win.len % 4 || win.off % 4 || win.len < tile ||
        4LL * (win.off + win.len) > smem_bytes)
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  const float* xx = static_cast<const float*>(x);
  float* yy = static_cast<float*>(y);
  return vec ? tps::dia_launch<true>(p, v, xx, yy, nterms, nwin, staged, tile, smem_bytes, n,
                                     ldv, device, st)
             : tps::dia_launch<false>(p, v, xx, yy, nterms, nwin, staged, tile, smem_bytes, n,
                                      ldv, device, st);
}
