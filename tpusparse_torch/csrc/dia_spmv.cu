// DIA SpMV for Hopper: k diagonals of a square A stored as (k, ldv) rows,
//   y[p] = sum_i vals[i, p] * x[p + d_i]
//        (+ vals[i, p - d_i] * x[p - d_i] for each d_i > 0 when `sym`),
// with reads outside [0, n) from the halo strips, or 0 where there are none.
//
// Replaces the TPU kernel tpusparse/kernels/dia_spmv.py:_dia_kernel
// (through dia_spmv_pallas). That kernel loads each grid block's x slab and
// a halo on each side once, forms every shifted window in registers
// (a sublane slice plus a lane roll), and builds the mirror values from the
// block's own vals rows plus a halo, so that each operand streams from HBM
// once. Its halo strips carry a neighbour's edge in the sharded partition
// (parallel/sparse.py:dia_spmm_sharded): xl, the hs = halo_rows * 128 x
// values before position 0, xr the hs after position n, vl the hs values of
// each vals row before position 0 (the mirror reads of a sym operator). A
// strip left out (null) reads as zeros, the one-device case.
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
// read (4-byte copies in the scalar body), a strip's values outside [0, n)
// (zeros where there is no strip, or past the strip: only outputs past n
// read there); then it forms every term from shared memory. So x is staged
// once for all its nearby diagonals (the Laplacian's -1..1 and +-1024 share one window), and
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
// picks it by shape before the launch. A call with strips runs a second
// kernel of the same body (dia_strip_kernel), whose copies also test the
// strips; a call with none runs dia_tile_kernel, which compiles as it did
// before strips were an input (its copy tests cost the 27-point stencil ~6%
// when one kernel served both, PERF.md).
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

// The halo strips: xl, the hs x values before position 0; xr, the hs from
// position n; vl, each vals row's hs values before 0 (row r at vl + r * hs).
// A null strip reads as zeros.
struct DiaStrips {
  const float* xl;
  const float* xr;
  const float* vl;
  int hs;
};

// Where position g outside [0, n) of source `src` (-1: x, else a vals row)
// is read from: a strip (true, `at` set), or nowhere (false: a zero). With
// 16-byte copies g, n and hs are multiples of 4, so a chunk of 4 lies wholly
// in one strip.
__device__ __forceinline__ bool strip_source(const float*& at, int src, long long g, int n,
                                             const DiaStrips& s) {
  if (g < 0) {
    if (g < -s.hs) return false;
    const float* strip = src < 0 ? s.xl : s.vl;
    if (strip == nullptr) return false;
    at = strip + (src < 0 ? 0 : (size_t)src * s.hs) + s.hs + g;
    return true;
  }
  // past n: only x has a strip there (a vals row's window ends at the tile)
  if (src >= 0 || s.xr == nullptr || g - n >= s.hs) return false;
  at = s.xr + (g - n);
  return true;
}

// One read of source `src` (its first position `row`) at g: inside [0, n)
// the array, outside it a strip where STRIPS (else, and past a strip, 0).
template <bool STRIPS>
__device__ __forceinline__ float dia_read(const float* row, int src, long long g, int n,
                                          const DiaStrips& s) {
  if (g >= 0 && g < n) return __ldg(row + g);
  if constexpr (STRIPS) {
    const float* at;
    if (strip_source(at, src, g, n, s)) return __ldg(at);
  }
  return 0.f;
}

template <bool VEC, bool STRIPS>
__device__ __forceinline__ void dia_tile(const float* __restrict__ vals,
                                         const float* __restrict__ x, const DiaStrips& strips,
                                         float* __restrict__ y, const DiaPlan& plan, int nterms,
                                         int nwin, int staged, int tile, int n, int ldv) {
  extern __shared__ __align__(16) float smem[];
  const long long base = (long long)blockIdx.x * tile;
  // Stage every window once: 16-byte copies (n % 4 == 0 and the window
  // starts on 4 positions, so a chunk lies wholly inside or outside [0, n)),
  // or 4-byte copies in the scalar body; strips or zeros outside [0, n).
  for (int w = 0; w < nwin; ++w) {
    const DiaWindow win = plan.win[w];
    const float* src = win.src < 0 ? x : vals + (size_t)win.src * ldv;
    const long long g0 = base + win.lo;
    float* dst = smem + win.off;
    constexpr int step = VEC ? 4 : 1;
    for (int c = threadIdx.x * step; c < win.len; c += kDiaThreads * step) {
      const long long g = g0 + c;
      bool ok = g >= 0 && g < n;
      const float* from = ok ? src + g : src;
      if constexpr (STRIPS) {
        if (!ok) ok = strip_source(from, win.src, g, n, strips);
      }
      copy_async<VEC ? 16 : 4>(dst + c, from, ok);
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
          // a position past n reads 0 and is not stored
          xv[j] = tm.xi >= 0 ? smem[tm.xi + q + 32 * j]
                             : dia_read<STRIPS>(x, -1, p + 32 * j + tm.e, n, strips);
          vv[j] = tm.vi >= 0 ? smem[tm.vi + q + 32 * j]
                  : p + 32 * j < n
                      ? dia_read<STRIPS>(vrow, tm.row, p + 32 * j + tm.s, n, strips)
                      : 0.f;
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

// Two kernels of one body: with no strip (the one-device call, the
// parameters it had before strips, so that it compiles as it did) and with
// strips (the halo partition's slabs).
template <bool VEC>
__global__ void __launch_bounds__(kDiaThreads)
dia_tile_kernel(const float* __restrict__ vals, const float* __restrict__ x,
                float* __restrict__ y, const __grid_constant__ DiaPlan plan, int nterms,
                int nwin, int staged, int tile, int n, int ldv) {
  dia_tile<VEC, false>(vals, x, DiaStrips{}, y, plan, nterms, nwin, staged, tile, n, ldv);
}

template <bool VEC>
__global__ void __launch_bounds__(kDiaThreads)
dia_strip_kernel(const float* __restrict__ vals, const float* __restrict__ x,
                 const DiaStrips strips, float* __restrict__ y,
                 const __grid_constant__ DiaPlan plan, int nterms, int nwin, int staged,
                 int tile, int n, int ldv) {
  dia_tile<VEC, true>(vals, x, strips, y, plan, nterms, nwin, staged, tile, n, ldv);
}

// The opt-in dynamic shared memory each kernel was given, by device (0: not
// yet). File scope, not a template-local static: those are process-wide
// symbols shared with any other library holding the same template.
constexpr int kMaxDevices = 64;
static int dia_smem_limit[4][kMaxDevices];

template <typename Kernel>
int dia_smem_optin(Kernel kernel, int* limit, int smem_bytes, int device) {
  if (smem_bytes <= 48 * 1024) return 0;
  int lim = device < kMaxDevices ? limit[device] : 0;
  if (lim == 0) {
    cudaError_t err = cudaDeviceGetAttribute(&lim, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;   // the block's static shared memory counts too
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    lim -= (int)attr.sharedSizeBytes;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lim);
    if (err != cudaSuccess) return (int)err;
    if (device < kMaxDevices) limit[device] = lim;
  }
  return smem_bytes > lim ? (int)cudaErrorInvalidValue : 0;
}

template <bool VEC>
int dia_launch(const DiaPlan& plan, const float* vals, const float* x, const DiaStrips& strips,
               float* y, int nterms, int nwin, int staged, int tile, int smem_bytes, int n, int ldv,
               int device, cudaStream_t st) {
  const bool with = strips.xl || strips.xr || strips.vl;
  int* limit = dia_smem_limit[(VEC ? 1 : 0) + (with ? 2 : 0)];
  const int rc = with ? dia_smem_optin(dia_strip_kernel<VEC>, limit, smem_bytes, device)
                      : dia_smem_optin(dia_tile_kernel<VEC>, limit, smem_bytes, device);
  if (rc != 0) return rc;
  const unsigned blocks = (unsigned)((n + (long long)tile - 1) / tile);
  if (with)
    dia_strip_kernel<VEC><<<blocks, kDiaThreads, smem_bytes, st>>>(vals, x, strips, y, plan,
                                                                  nterms, nwin, staged, tile, n,
                                                                  ldv);
  else
    dia_tile_kernel<VEC><<<blocks, kDiaThreads, smem_bytes, st>>>(vals, x, y, plan, nterms, nwin,
                                                                 staged, tile, n, ldv);
  return (int)cudaGetLastError();
}

}  // namespace tps

// plan: host int32 words, nterms terms of 5 (e, s, row, xi, vi) then nwin
// windows of 4 (src, lo, len, off), as kernels/dia_spmv.py:dia_plan lays
// them out; vals: (k, ldv) fp32 rows with ldv >= n, k <= 32; x, y: (n,)
// fp32; xl, xr: (hs,) fp32 x strips before 0 and from n, vl: (k, hs) fp32
// vals strip before 0, each null for zeros (hs a multiple of 128, and every
// window within hs of [0, n), as the wrapper checks); tile: positions a
// block, a multiple of 128; smem_bytes: the staged windows' bytes; vec: 1
// for the 16-byte copies (n % 4 == ldv % 4 == 0, every pointer 16-byte
// aligned), 0 for the scalar body.
extern "C" int tps_dia_spmv(const void* plan, const void* vals, const void* x, const void* xl,
                            const void* xr, const void* vl, void* y, int nterms, int nwin,
                            int tile, int smem_bytes, int vec, int n, int ldv, int hs,
                            int device, void* stream) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nterms <= 0 || nterms > tps::kMaxTerms || nwin < 0 || nwin > tps::kMaxWindows ||
      tile <= 0 || tile % tps::kDiaWarpSpan || ldv < n || smem_bytes < 0 || hs < 0 ||
      hs % tps::kDiaWarpSpan || ((xl || xr || vl) && hs == 0))
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
  const tps::DiaStrips strips{static_cast<const float*>(xl), static_cast<const float*>(xr),
                              static_cast<const float*>(vl), hs};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  const float* xx = static_cast<const float*>(x);
  float* yy = static_cast<float*>(y);
  return vec ? tps::dia_launch<true>(p, v, xx, strips, yy, nterms, nwin, staged, tile, smem_bytes,
                                     n, ldv, device, st)
             : tps::dia_launch<false>(p, v, xx, strips, yy, nterms, nwin, staged, tile, smem_bytes,
                                      n, ldv, device, st);
}
