// SELL SpMM by decompress-to-dense for Hopper (K11):
//   dense_t[c, r] = sum_s [idx[j,t,s,r] == c] * vals[j,t,s,r]      (c, r < 128)
//   y[b, j*128 + r] = sum_t sum_c x[b, t*128 + c] * dense_t[c, r].
//
// Replaces the TPU study kernel tpusparse/kernels/sell_mxu_spmm.py:_mxu_kernel,
// which scatters each (W, 128) SELL tile into a dense (128, 128) VMEM tile
// and multiplies it on the MXU, so one dense product serves every batch row
// (the reference's csr_tiling strategy). Here the dense product runs on
// Hopper's tensor cores.
//
// Bound: the function's own is bytes (the SELL pack, 5 bytes a slot, beside
// 2*nnz*B flops). The design does dense work on purpose: 3 x 2*128*128*B
// tensor-core flops a tile (3xTF32, below) whatever the tile's nonzeros, at
// the card's TF32 rate (495 TFLOP/s dense): 6.5 us at 4096^2, B = 32,
// under the 17.5 us the pack takes to stream at d = 0.5.
//
// Design: a 256-thread block owns column group j, one batch tile of up to
// 32 rows and a contiguous run of windows t (about one block an SM, each
// walking several tiles: kernels/sell_mxu_spmm.py:mxu_shape).
// - Tile (j, t)'s vals and idx are contiguous slabs (W*512 and W*128 bytes
//   of the (nb, nt, W, 128) layout). Thread 0 fetches both with 1D bulk
//   copies into a ring of 1-4 stages (as many as shared memory holds) that
//   complete on one mbarrier a stage, so the next tiles stream in while
//   this one is used. x's window for the tile comes by cp.async (zero past
//   ldx and the batch) into a second, two-buffer ring, one tile ahead.
// - The scatter stores instead of adding: on a zeroed tile, "store vals at
//   (idx, r) unless vals == 0" gives the additive scatter's tile bit for
//   bit wherever no column holds two real slots with one offset in a window
//   (from_dense cannot make them) and pad slots are (idx 0, val 0), which
//   the store skips (a real -0.0 is skipped too, where the add gives +0.0
//   as well). Stores never need an order, so two lanes share a column. A
//   CsrMatrix with duplicate entries does give such slots (from_coo keeps
//   them, sell_pack_csr gives each its own slot): the product pass counts
//   each row's nonzero cells as it loads them, a row with fewer cells than
//   stored slots shows a repeated offset, and then the warp rebuilds its
//   rows by adding in slot order and multiplies again. The tile is kept
//   transposed, T[r][c], with a row stride of 132 floats so that the
//   fragment loads below hit 32 distinct banks. After the product each
//   warp zeroes its rows with 16-byte stores.
// - Warp w owns output columns r = 16w .. 16w+15: it scatters, multiplies
//   and clears only rows 16w .. 16w+15 of T, so T needs only __syncwarp.
//   y^T[r, b] += sum_c T[r, c] * x[b, c] runs as mma.sync m16n8k8 TF32
//   (M the warp's 16 columns, N the batch tile in 8s, K the 128 window
//   rows), in 3xTF32: each operand v splits into a TF32 hi and the rest lo
//   (split_tf32), and lo*hi, hi*lo and hi*hi accumulate in the mma's fp32
//   registers over one tile (six sets, by product and k-step parity, so
//   the dependent chains stay short). Each tile's sums are then added to
//   the block's with a rounded FADD: the tensor cores' own accumulation
//   drops low bits, and over a run of 16 tiles (4096^2, B = 40) that alone
//   passed 1e-4. Single-pass TF32 would put 2048^2, d = 0.5 more than 1e-3
//   from the float64 oracle, past the contract; 3xTF32 stays near fp32's
//   own error (tests/test_torch_redesign.py).
// - The slices' partial sums are added by the last block of each group
//   (split_reduce.cuh): one launch a call, deterministic.
#include "async_copy.cuh"
#include "sell_common.cuh"
#include "split_reduce.cuh"

namespace tps {

constexpr int kMxuWarps = 8;
constexpr int kMxuThreads = 32 * kMxuWarps;   // warp w: output columns 16w .. 16w+15
constexpr int kTileLd = kLanes + 4;            // row stride of T and of the x tiles
constexpr int kMaxStages = 4;
constexpr int kHeader = 128;                   // the stages' mbarriers
constexpr int kMaxDevices = 64;

// v = hi + lo with hi a TF32 value (11 significant bits, nearest) and lo
// the exact rest, by Veltkamp's split with the constant 2^13 + 1: three
// fp32 operations at the full FP32 rate. cvt.rna.tf32.f32 runs on the
// slower conversion unit instead, and cost 3.2-3.6 us more a call at
// 4096^2 (tpusparse_torch/bench/abba.py on an H100, all six floors points). The
// intrinsics keep the compiler from fusing them into an FMA, which would
// break the split. lo has up to 12 significant bits; the tensor core reads
// 11 of them (it ignores a TF32 operand's low 13 bits), an error of at most
// 2^-22 of v. |v| above 4e34 would overflow (no SELL value comes near).
__device__ __forceinline__ void split_tf32(float v, unsigned& hi, unsigned& lo) {
  const float c = __fmul_rn(v, 8193.f);
  const float h = __fsub_rn(c, __fsub_rn(c, v));
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(v, h));
}

// d += a * b, one m16n8k8 TF32 product with fp32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Lanes l and l + 16 of a warp share tile column r (T row r) and take the
// alternate slot rows k = l / 16, l / 16 + 2, ...; a lane handles 4 of its
// rows at a time (W is a multiple of 8), loads first, then stores.
//
// T[r][idx[k, r]] = vals[k, r] for the slots whose value is not 0, on a
// zeroed row; returns how many this lane stored.
__device__ __forceinline__ int scatter_column(const float* sv, const int8_t* si, float* trow,
                                              int r, int lane, int w) {
  int stored = 0;
  for (int k = lane >> 4; k < w; k += 8) {
    float v[4];
    int c[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      v[u] = sv[(k + 2 * u) * kLanes + r];
      c[u] = si[(k + 2 * u) * kLanes + r];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (v[u] != 0.f) {
        trow[c[u]] = v[u];
        ++stored;
      }
  }
  return stored;
}

// The additive scatter of the warp's 16 columns, one lane a column, in slot
// order (the plain version's order), on zeroed rows.
__device__ __forceinline__ void add_column(const float* sv, const int8_t* si, float* trow,
                                           int r, int lane, int w) {
  if (lane < 16)
    for (int k = 0; k < w; ++k) {
      const float v = sv[k * kLanes + r];
      if (v != 0.f) trow[si[k * kLanes + r]] += v;
    }
}

// Zero the warp's 16 rows of T (16-byte stores).
__device__ __forceinline__ void zero_rows(float* tile, int warp, int lane) {
  float4* rows = reinterpret_cast<float4*>(tile + 16 * warp * kTileLd);
  for (int q = lane; q < 16 * kTileLd / 4; q += 32) rows[q] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// NT tiles of 8 batch rows: a batch tile of BT = 8 * NT rows.
template <int NT>
__global__ void __launch_bounds__(kMxuThreads, 1)
sell_mxu_kernel(const int8_t* __restrict__ idx, const float* __restrict__ vals,
                const float* __restrict__ x, float* __restrict__ part, float* __restrict__ y,
                int* __restrict__ counters, int nt, int w, int batch, int ldx, int n,
                int per_slice, int stages) {
  constexpr int BT = 8 * NT;
  extern __shared__ __align__(128) unsigned char smem[];
  auto* bars = reinterpret_cast<uint64_t*>(smem);
  const int slots = w * kLanes;                       // slots of one tile
  const int stage_bytes = 5 * slots;                  // its vals, then its idx
  unsigned char* ring = smem + kHeader;
  float* tile = reinterpret_cast<float*>(ring + stages * stage_bytes);   // T[128 r][kTileLd]
  float* xs = tile + kLanes * kTileLd;                                    // [2][BT][kTileLd]
  const int j = blockIdx.x, slice = blockIdx.y, b0 = blockIdx.z * BT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t0 = slice * per_slice, count = max(0, min(nt, t0 + per_slice) - t0);

  for (int q = threadIdx.x; q < kLanes * kTileLd / 4; q += kMxuThreads)
    reinterpret_cast<float4*>(tile)[q] = make_float4(0.f, 0.f, 0.f, 0.f);
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
    bulk_copy(dst, vals + base, 4 * slots, &bars[s]);
    bulk_copy(dst + 4 * slots, idx + base, slots, &bars[s]);
  };
  auto issue_x = [&](int i) {      // every thread: x's window of tile t0 + i
    float* xd = xs + (i & 1) * BT * kTileLd;
    const int col0 = (t0 + i) * kLanes;
    for (int q = threadIdx.x; q < BT * kLanes; q += kMxuThreads) {
      const int b = q / kLanes, c = q % kLanes;
      const bool ok = b0 + b < batch && col0 + c < ldx;
      copy_async<4>(xd + b * kTileLd + c, ok ? x + (size_t)(b0 + b) * ldx + col0 + c : x, ok);
    }
    copy_commit();
  };

  if (threadIdx.x == 0)
    for (int i = 0; i < min(stages - 1, count); ++i) issue_tile(i);
  if (count > 0) issue_x(0);

  float acc[NT][4];
#pragma unroll
  for (int q = 0; q < NT; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
  const int r = 16 * warp + (lane & 15);   // the column this lane scatters
  float* trow = tile + r * kTileLd;
  const int g = lane >> 2, tg = lane & 3;  // mma fragment coordinates
  const float* ta = tile + (16 * warp + g) * kTileLd + tg;

  for (int i = 0; i < count; ++i) {
    const int s = i % stages;
    if (stages == 1) {
      __syncthreads();                     // every warp is done with the one stage
      if (threadIdx.x == 0) issue_tile(i);
    }
    copy_wait<0>();                        // this thread's x copies of tile i
    bar_wait(&bars[s], (i / stages) & 1);  // tile i's slabs
    __syncthreads();                       // x visible; tile i-1's stage and x free
    if (stages > 1 && threadIdx.x == 0 && i + stages - 1 < count) issue_tile(i + stages - 1);
    if (i + 1 < count) issue_x(i + 1);

    const float* sv = reinterpret_cast<const float*>(ring + s * stage_bytes);
    const int8_t* si = reinterpret_cast<const int8_t*>(ring + s * stage_bytes + 4 * slots);
    const int stored = scatter_column(sv, si, trow, r, lane, w);
    __syncwarp();
    const float* xb = xs + (i & 1) * BT * kTileLd + g * kTileLd + tg;
    // this tile's sums: a set for each of the three products and each
    // k-step parity, so no chain of dependent mma is longer than 8
    float part_acc[6][NT][4];
    for (int pass = 0;; ++pass) {
#pragma unroll
      for (int h = 0; h < 6; ++h)
#pragma unroll
        for (int q = 0; q < NT; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) part_acc[h][q][e] = 0.f;
      int cells_lo = 0, cells_hi = 0;   // nonzero cells of rows g and g + 8
#pragma unroll
      for (int kk = 0; kk < kLanes / 8; ++kk) {
        const int k0 = 8 * kk;
        const float a[4] = {ta[k0], ta[8 * kTileLd + k0], ta[k0 + 4], ta[8 * kTileLd + k0 + 4]};
        cells_lo += (a[0] != 0.f) + (a[2] != 0.f);
        cells_hi += (a[1] != 0.f) + (a[3] != 0.f);
        unsigned ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(a[e], ah[e], al[e]);
#pragma unroll
        for (int q = 0; q < NT; ++q) {
          unsigned bh[2], bl[2];
          split_tf32(xb[8 * q * kTileLd + k0], bh[0], bl[0]);
          split_tf32(xb[8 * q * kTileLd + k0 + 4], bh[1], bl[1]);
          const int h = 3 * (kk & 1);
          mma_tf32(part_acc[h][q], al, bh);
          mma_tf32(part_acc[h + 1][q], ah, bl);
          mma_tf32(part_acc[h + 2][q], ah, bh);
        }
      }
      if (pass == 1) break;
      // Every cell the stores reached was loaded once above: a row holds as
      // many nonzero cells as its column has stored slots, unless two slots
      // named one offset (a CsrMatrix with duplicate entries). Then the
      // warp rebuilds its rows by adding, and multiplies again.
      cells_lo += __shfl_xor_sync(0xffffffffu, cells_lo, 1);
      cells_lo += __shfl_xor_sync(0xffffffffu, cells_lo, 2);
      cells_hi += __shfl_xor_sync(0xffffffffu, cells_hi, 1);
      cells_hi += __shfl_xor_sync(0xffffffffu, cells_hi, 2);
      const int src = 4 * (lane & 7);
      const int lo = __shfl_sync(0xffffffffu, cells_lo, src);
      const int hi = __shfl_sync(0xffffffffu, cells_hi, src);
      const int slots_r = stored + __shfl_xor_sync(0xffffffffu, stored, 16);
      if (!__any_sync(0xffffffffu, ((lane & 15) < 8 ? lo : hi) != slots_r)) break;
      zero_rows(tile, warp, lane);
      __syncwarp();
      add_column(sv, si, trow, r, lane, w);
      __syncwarp();
    }
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[q][e] += ((part_acc[0][q][e] + part_acc[3][q][e]) +
                      (part_acc[1][q][e] + part_acc[4][q][e])) +
                     (part_acc[2][q][e] + part_acc[5][q][e]);
    __syncwarp();
    zero_rows(tile, warp, lane);
  }

  // acc[q]: rows (16w + g, 16w + g + 8) x batch columns (8q + 2tg, 8q + 2tg + 1)
  const size_t np = (size_t)gridDim.x * kLanes;
  const int col = j * kLanes + 16 * warp + g;
#pragma unroll
  for (int q = 0; q < NT; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int b = b0 + 8 * q + 2 * tg + (e & 1);
      if (b < batch)
        part[((size_t)slice * batch + b) * np + col + 8 * (e >> 1)] =
            acc[q][e];
    }
  split_reduce_tail<NT, true>(part, y, counters + blockIdx.z * gridDim.x + j, gridDim.y, batch, np, n,
                    b0, min(BT, batch - b0), j * kLanes, min(kLanes, n - j * kLanes), tile,
                    (kLanes + 2 * BT) * kTileLd);   // T and the x tiles are free
}

// The dynamic shared-memory limit raised for each kernel (NT = 1, 2, 4),
// once a device and process. A file-scope array, not a static inside the
// template: those are process-wide unique symbols, shared with any other
// library that holds the same template.
static int smem_limit[3][kMaxDevices];

template <int NT>
int sell_mxu_launch(const int8_t* idx, const float* vals, const float* x, float* part,
                    float* y, int* counters, int nb, int nt, int w, int batch, int ldx,
                    int slices, int per_slice, int n, int device, cudaStream_t st) {
  constexpr int BT = 8 * NT;
  int* limit = smem_limit[NT == 1 ? 0 : NT == 2 ? 1 : 2];
  int lim = device < kMaxDevices ? limit[device] : 0;
  if (lim == 0) {
    cudaError_t err = cudaDeviceGetAttribute(&lim, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                             device);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;   // the block's static shared memory counts too
    err = cudaFuncGetAttributes(&attr, sell_mxu_kernel<NT>);
    if (err != cudaSuccess) return (int)err;
    lim -= (int)attr.sharedSizeBytes;
    err = cudaFuncSetAttribute(sell_mxu_kernel<NT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, lim);
    if (err != cudaSuccess) return (int)err;
    if (device < kMaxDevices) limit[device] = lim;
  }
  const size_t fixed = kHeader + sizeof(float) * (size_t)kTileLd * (kLanes + 2 * BT);
  const size_t stage = 5 * (size_t)w * kLanes;
  int stages = kMaxStages;
  while (stages > 1 && fixed + stages * stage > (size_t)lim) --stages;
  const size_t smem = fixed + stages * stage;
  if (smem > (size_t)lim) return (int)cudaErrorInvalidValue;
  const dim3 grid(nb, slices, (batch + BT - 1) / BT);
  sell_mxu_kernel<NT><<<grid, kMxuThreads, smem, st>>>(idx, vals, x, part, y, counters, nt, w,
                                                       batch, ldx, n, per_slice, stages);
  return 0;
}

}  // namespace tps

// idx: (nb, nt, w, 128) int8, vals: (nb, nt, w, 128) fp32 (a SELL pack), both
// 16-byte aligned; x: (batch, ldx) fp32, ldx <= nt*128 (missing columns read
// as 0); part: (slices, batch, nb*128) fp32 scratch; y: (batch, n) fp32;
// counters: nb * ceil(batch/32) int32 (nb * 1 below 32 rows), all 0.
extern "C" int tps_sell_mxu_spmm(const void* idx, const void* vals, const void* x,
                                 void* part, void* y, void* counters, int nb, int nt, int w,
                                 int batch, int ldx, int slices, int per_slice, int n,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nb <= 0 || batch <= 0 || slices <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* ix = static_cast<const int8_t*>(idx);
  const auto* vv = static_cast<const float*>(vals);
  const auto* xx = static_cast<const float*>(x);
  auto* pp = static_cast<float*>(part);
  auto* yy = static_cast<float*>(y);
  auto* cc = static_cast<int*>(counters);
  int rc;
  if (batch <= 8)
    rc = tps::sell_mxu_launch<1>(ix, vv, xx, pp, yy, cc, nb, nt, w, batch, ldx, slices, per_slice, n, device, st);
  else if (batch <= 16)
    rc = tps::sell_mxu_launch<2>(ix, vv, xx, pp, yy, cc, nb, nt, w, batch, ldx, slices, per_slice, n, device, st);
  else
    rc = tps::sell_mxu_launch<4>(ix, vv, xx, pp, yy, cc, nb, nt, w, batch, ldx, slices, per_slice, n, device, st);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
