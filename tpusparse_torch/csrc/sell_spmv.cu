// SELL SpMV/SpMM for Hopper (K1): y[b, j*128+r] = sum_t sum_s
//   vals[j,t,s,r] * x[b, t*128 + idx[j,t,s,r]]   (times scales[j,r] for int8).
//
// Replaces the TPU kernel tpusparse/kernels/sell_spmv.py:_sell_kernel, whose
// BlockSpecs stream each (W, 128) tile of the pack once and apply it to the
// whole batch's x window.
//
// Bound: bytes up to a few batch rows. Each stored slot moves 5 bytes (fp32
// value + int8 index; 3 for bf16, 2 for int8) and costs 2*B flops. At large
// B the gather of x from shared memory sets the time instead: B * 4 bytes
// of shared-memory reads a slot, 1.47 GB at 4096^2, d = 0.5, B = 32.
//
// Two kernels, by batch rows (kernels/sell_spmv.py:sell_shape); both read
// the pack once for all the batch rows a block holds, and both leave the
// slices' partial sums to sell_common.cuh's fixed-order reduce pass, which
// applies the int8 scales after the sum (deterministic, no atomics; fusing
// it into the kernel measured no faster here: PERF.md).
//
// Up to 8 rows, sell_partial_kernel: a 128-thread block works on column
// group j and a short run of windows (about 8 blocks an SM); lane q of each
// warp owns columns j*128 + 4q .. 4q+3 and reads them with one vector load
// per slot row (sell_common.cuh), and the 4 warps split the W slot rows. The
// x window of each t is staged in shared memory for all batch rows of the
// block and gathered from there; 4 x B accumulators live in registers. At
// 8 rows and fewer this streamed the pack faster on an H100 than the ring
// kernel below (PERF.md), so it stays as it was.
//
// From 9 rows, sell_ring_kernel: a block of 8 warps (one or two an SM) owns
// column group j, 16 or 32 batch rows and a contiguous run of windows t, so
// the pack is read once for every 32 rows, where 8-row blocks read it once
// for every 8.
// - Tile (j, t)'s vals and idx are contiguous slabs (W*128 values, then
//   W*128 bytes of offsets). Thread 0 fetches both with 1D bulk copies into
//   a ring of 1-2 stages that complete on one mbarrier a stage: the next
//   tile streams in while this one is used.
// - x's window is kept transposed, xT[c][b], a row of bb + 4 floats (odd
//   16-byte units). It is loaded into registers one tile ahead (coalesced)
//   and stored with 16-byte stores after the current tile's products.
// - A lane owns 4 adjacent columns (reading each slot row's 4 values and
//   offsets with one vector load each) and one batch quad; the Q = bb/4
//   lanes of a column quad take its Q batch quads, so a quarter warp reads
//   2 (16 rows) or 1 (32 rows) offsets' rows of xT with 16-byte loads (one
//   row: every bank once). (A lane owning one column and all the rows
//   measured 1.3 x slower at 32 rows: 8 offsets a quarter warp share banks.)
//   Q warps cover the 128 columns and the block's warps are row groups of
//   Q; row group k takes the tile's slot rows k, k + R, ... One
//   __syncthreads a tile frees the previous tile's stage and x buffer.
// - At the end the row groups' sums are added in a fixed order and written
//   as the slice's partial sums.
#include "async_copy.cuh"
#include "sell_common.cuh"

namespace tps {

// ---- up to 8 rows --------------------------------------------------------

template <typename T, int BT>
__global__ void __launch_bounds__(kThreads)
sell_partial_kernel(const int8_t* __restrict__ idx, const T* __restrict__ vals,
                    const float* __restrict__ x, float* __restrict__ part,
                    int nt, int w, int batch, int ldx, int per_slice) {
  __shared__ float xs[BT][kLanes];
  __shared__ __align__(16) float red[kWarps][BT][kLanes];
  const int j = blockIdx.x, slice = blockIdx.y, b0 = blockIdx.z * BT;
  const size_t np = (size_t)gridDim.x * kLanes;
  float acc[BT][kCols];
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[b][c] = 0.f;
  const int t0 = slice * per_slice;
  const int t1 = min(nt, t0 + per_slice);
  for (int t = t0; t < t1; ++t) {
    stage_window<BT>(xs, x, ldx, t, b0, batch);
    const size_t tile = ((size_t)j * nt + t) * w * kLanes;
    accumulate_tile<T, BT>(idx + tile, vals + tile, w, xs, acc);
  }
  block_sum_store<BT>(acc, red,
                      part + ((size_t)slice * batch + b0) * np + (size_t)j * kLanes,
                      np, batch - b0, kLanes);
}

// ---- 16 or 32 rows -------------------------------------------------------

constexpr int kRingWarps = 8;       // 16 measured slower at 32 rows (PERF.md)
constexpr int kRingHeader = 128;    // the stages' mbarriers
constexpr int kRingMaxStages = 2;

// Floats of one transposed x window for bb batch rows (the wrapper's
// x_window_floats).
__host__ __device__ constexpr int x_window(int bb) { return kLanes * (bb + 4); }

template <typename T>
__global__ void __launch_bounds__(32 * kRingWarps, 2)
sell_ring_kernel(const int8_t* __restrict__ idx, const T* __restrict__ vals,
                 const float* __restrict__ x, float* __restrict__ part, int nt, int w,
                 int batch, int ldx, int per_slice, int bb, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  auto* bars = reinterpret_cast<uint64_t*>(smem);
  const int slots = w * kLanes;
  const int val_bytes = slots * (int)sizeof(T);
  const int stage_bytes = val_bytes + slots;       // its vals, then its idx
  const int xbufs = max(stages, 2);
  unsigned char* ring = smem + kRingHeader;
  float* xs = reinterpret_cast<float*>(ring + stages * stage_bytes);   // [xbufs][128][bb+4]
  const int xw = x_window(bb), xs_ld = bb + 4;
  const int j = blockIdx.x, slice = blockIdx.y, b0 = blockIdx.z * bb;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nq = bb / 4;                            // lanes (batch quads) a column quad
  const int nthreads = blockDim.x, rgroups = (nthreads >> 5) / nq;
  const int rg = warp / nq, bq = lane % nq;
  const int quad = (warp % nq) * (32 / nq) + lane / nq;   // columns 4*quad .. 4*quad+3
  const int t0 = slice * per_slice, count = max(0, min(nt, t0 + per_slice) - t0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) bar_init(&bars[s]);
    bar_init_fence();
  }
  __syncthreads();

  auto issue_tile = [&](int i) {   // thread 0: tile t0 + i into stage i % stages
    const int s = i % stages;
    unsigned char* dst = ring + s * stage_bytes;
    const size_t base = ((size_t)j * nt + t0 + i) * slots;
    bar_expect(&bars[s], stage_bytes);
    bulk_copy(dst, vals + base, val_bytes, &bars[s]);
    bulk_copy(dst + val_bytes, idx + base, slots, &bars[s]);
  };
  // Thread t holds column t % 128 of batch quads t / 128, t / 128 + G, ...
  // (G = threads / 128) of the next window in registers.
  const int xc = threadIdx.x % kLanes, xg = threadIdx.x / kLanes, ng = nthreads / kLanes;
  float4 xr[4];
  auto load_x = [&](int i) {
    const int col = (t0 + i) * kLanes + xc;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int q = xg + ng * p;
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int b = b0 + 4 * q + u;
        v[u] = (q < nq && b < batch && col < ldx) ? x[(size_t)b * ldx + col] : 0.f;
      }
      xr[p] = make_float4(v[0], v[1], v[2], v[3]);
    }
  };
  auto store_x = [&](int i) {
    float* xd = xs + (i % xbufs) * xw + xc * xs_ld;
#pragma unroll
    for (int p = 0; p < 4; ++p)
      if (xg + ng * p < nq) reinterpret_cast<float4*>(xd)[xg + ng * p] = xr[p];
  };

  if (count > 0) {
    load_x(0);
    store_x(0);
  }
  if (threadIdx.x == 0)
    for (int i = 0; i < min(stages - 1, count); ++i) issue_tile(i);

  float acc[4][kCols];
#pragma unroll
  for (int b = 0; b < 4; ++b)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[b][c] = 0.f;

  for (int i = 0; i < count; ++i) {
    const int s = i % stages;
    if (stages == 1) {
      __syncthreads();                     // every warp is done with the one stage
      if (threadIdx.x == 0) issue_tile(i);
    }
    bar_wait(&bars[s], (i / stages) & 1);  // tile i's slabs
    __syncthreads();                       // x visible; tile i-1's stage and x free
    if (stages > 1 && threadIdx.x == 0 && i + stages - 1 < count) issue_tile(i + stages - 1);
    if (i + 1 < count) load_x(i + 1);

    const T* sv = reinterpret_cast<const T*>(ring + s * stage_bytes);
    const int8_t* si = reinterpret_cast<const int8_t*>(ring + s * stage_bytes + val_bytes);
    const float* xb = xs + (i % xbufs) * xw + bq * 4;
#pragma unroll 4
    for (int r = rg; r < w; r += rgroups) {
      const char4 i4 = reinterpret_cast<const char4*>(si + (size_t)r * kLanes)[quad];
      float v[kCols];
      load4(sv + (size_t)r * kLanes, quad, v);
      const int ii[kCols] = {i4.x, i4.y, i4.z, i4.w};   // in-window offsets
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float4 q = *reinterpret_cast<const float4*>(xb + ii[c] * xs_ld);
        acc[0][c] = fmaf(v[c], q.x, acc[0][c]);
        acc[1][c] = fmaf(v[c], q.y, acc[1][c]);
        acc[2][c] = fmaf(v[c], q.z, acc[2][c]);
        acc[3][c] = fmaf(v[c], q.w, acc[3][c]);
      }
    }
    if (i + 1 < count) store_x(i + 1);     // buffer (i+1) % xbufs is free
  }

  // The row groups' sums, added in order 0 .. R-1, are the slice's partial
  // sums. red reuses the ring: every copy has landed and every warp is past
  // its last tile after the barrier.
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);     // [R][bb][128]
#pragma unroll
  for (int b = 0; b < 4; ++b)
    reinterpret_cast<float4*>(red + ((size_t)rg * bb + bq * 4 + b) * kLanes)[quad] =
        make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
  __syncthreads();
  const size_t np = (size_t)gridDim.x * kLanes;
  const int rows = min(bb, batch - b0);
  for (int q = threadIdx.x; q < rows * kLanes; q += nthreads) {
    float sum = 0.f;
    for (int k = 0; k < rgroups; ++k) sum += red[(size_t)k * bb * kLanes + q];
    part[((size_t)slice * batch + b0 + q / kLanes) * np + (size_t)j * kLanes + q % kLanes] = sum;
  }
}

// Bytes of dynamic shared memory of a ring block (the wrapper's
// sell_smem_bytes): the ring and its x windows (at least two), or the row
// groups' sums at the end.
inline size_t sell_smem(int w, int elem, int bb, int stages) {
  const size_t ring = (size_t)stages * w * kLanes * (elem + 1) +
                      sizeof(float) * (size_t)(stages > 2 ? stages : 2) * x_window(bb);
  const size_t red = sizeof(float) * (size_t)kRingWarps * kLanes * 4;
  return kRingHeader + (ring > red ? ring : red);
}

// The dynamic shared-memory limit raised once a kernel, device and process.
// A file-scope array, not a static inside the template: those are
// process-wide unique symbols, shared with any other library that holds the
// same template.
constexpr int kSellDevices = 64;
static int sell_smem_set[3][kSellDevices];

template <typename T>
int sell_spmm_t(const int8_t* idx, const T* vals, const float* x, const float* scales,
                float* part, float* y, int nb, int nt, int w, int batch, int ldx, int slices,
                int per_slice, int n, int bb, int stages, int device, cudaStream_t st) {
  if (bb <= 8) {   // sell_partial_kernel, bb = its batch tile
    const dim3 grid(nb, slices, (batch + bb - 1) / bb);
    switch (bb) {
      case 1: sell_partial_kernel<T, 1><<<grid, kThreads, 0, st>>>(idx, vals, x, part, nt, w, batch, ldx, per_slice); break;
      case 2: sell_partial_kernel<T, 2><<<grid, kThreads, 0, st>>>(idx, vals, x, part, nt, w, batch, ldx, per_slice); break;
      case 4: sell_partial_kernel<T, 4><<<grid, kThreads, 0, st>>>(idx, vals, x, part, nt, w, batch, ldx, per_slice); break;
      case 8: sell_partial_kernel<T, 8><<<grid, kThreads, 0, st>>>(idx, vals, x, part, nt, w, batch, ldx, per_slice); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    if ((bb != 16 && bb != 32) || stages < 1 || stages > kRingMaxStages)
      return (int)cudaErrorInvalidValue;
    const size_t smem = sell_smem(w, (int)sizeof(T), bb, stages);
    constexpr int kind = sizeof(T) == 4 ? 0 : sizeof(T) == 2 ? 1 : 2;
    int* have = device < kSellDevices ? &sell_smem_set[kind][device] : nullptr;
    if (have == nullptr || *have < (int)smem) {   // static shared memory counts too
      int lim = 0;
      cudaError_t err = cudaDeviceGetAttribute(&lim, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                               device);
      if (err != cudaSuccess) return (int)err;
      cudaFuncAttributes attr;
      err = cudaFuncGetAttributes(&attr, sell_ring_kernel<T>);
      if (err != cudaSuccess) return (int)err;
      lim -= (int)attr.sharedSizeBytes;
      if (smem > (size_t)lim) return (int)cudaErrorInvalidValue;
      err = cudaFuncSetAttribute(sell_ring_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, lim);
      if (err != cudaSuccess) return (int)err;
      if (have != nullptr) *have = lim;
    }
    const dim3 grid(nb, slices, (batch + bb - 1) / bb);
    sell_ring_kernel<T><<<grid, 32 * kRingWarps, smem, st>>>(idx, vals, x, part, nt, w, batch, ldx,
                                                        per_slice, bb, stages);
  }
  launch_reduce(part, scales, y, slices, batch, nb * kLanes, n, st);
  return 0;
}

}  // namespace tps

// vals_kind: 0 = fp32, 1 = bf16, 2 = int8 (then `scales` is (nb, 128) fp32).
// idx/vals: (nb, nt, w, 128), both 16-byte aligned; x: (batch, ldx) fp32,
// ldx <= nt*128 (missing columns read as 0); part: (slices, batch, nb*128)
// fp32 scratch; y: (batch, n) fp32. A block holds bb batch rows: 1, 2, 4 or
// 8 (the 128-thread kernel), or 16 or 32 (the ring kernel, a ring of
// `stages` tiles).
extern "C" int tps_sell_spmm(const void* idx, const void* vals, int vals_kind,
                             const void* x, const void* scales, void* part,
                             void* y, int nb, int nt, int w, int batch, int ldx,
                             int slices, int per_slice, int n, int bb, int stages,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nb <= 0 || batch <= 0 || slices <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* ix = static_cast<const int8_t*>(idx);
  const auto* xx = static_cast<const float*>(x);
  const auto* sc = static_cast<const float*>(scales);
  auto* pp = static_cast<float*>(part);
  auto* yy = static_cast<float*>(y);
  int rc;
  switch (vals_kind) {
    case 0: rc = tps::sell_spmm_t(ix, static_cast<const float*>(vals), xx, sc, pp, yy, nb, nt, w, batch, ldx, slices, per_slice, n, bb, stages, device, st); break;
    case 1: rc = tps::sell_spmm_t(ix, static_cast<const __nv_bfloat16*>(vals), xx, sc, pp, yy, nb, nt, w, batch, ldx, slices, per_slice, n, bb, stages, device, st); break;
    case 2: rc = tps::sell_spmm_t(ix, static_cast<const int8_t*>(vals), xx, sc, pp, yy, nb, nt, w, batch, ldx, slices, per_slice, n, bb, stages, device, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

extern "C" const char* tps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
