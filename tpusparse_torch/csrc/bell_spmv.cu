// Bitmap blocked-ELL SpMV/SpMM for Hopper (K12):
//   y[b, j*128 + r] = sum_i sum_l A[i*BM + l, j*128 + r] * x[b, i*BM + l],
// with A stored per (output group j, contraction block i) as a bitmap
// (128, BM/32) uint32 and each column's nonzeros packed to the left in
// vals (128, W) (tpusparse_torch/formats/bell.py).
//
// Replaces the TPU kernel tpusparse/kernels/bell_spmv.py:_bell_kernel, which
// expands the bitmap to a (128, BM) mask, ranks it with a matmul against a
// triangular matrix (plus the per-m-tile carries), decompresses a dense
// tile and multiplies it on the MXU.
//
// Bound: bytes. A product must read the bitmap (BM/8 bytes a column a block)
// and the live values (4 bytes each), and does 2*B flops a value, far under
// the card's operations-per-byte balance. Pads past a column's count are
// zero and are never read.
//
// Design: one warp ranks one output column r of a (j, i) tile at a time,
// 32 positions a step. Position l's bit sits in word l % nwords at bit
// l / nwords (the TPU layout, kept so packs compare); a lane takes its word
// from the lane that holds it with a shuffle. __ballot_sync gives the live
// lanes of the step, and a lane's value is vals[r, base + popc(ballot below
// the lane)]: live values are packed to the left, so the ranks of a step are
// consecutive. The column's live values (count = popc of its words) are
// first copied into a per-warp buffer in shared memory with 16-byte loads,
// the next column's copy being in flight while the current one is summed.
// A warp sum gives the column's dot product with each batch row. A block
// covers 64 columns of one group (8 warps, 8 columns each) and a slice of
// contraction blocks; the x windows and the tile's bitmap words are staged
// in shared memory. As in K1, the slices write partial sums that the fixed-
// order reduce of sell_common.cuh adds up: no atomics, deterministic.
#include "sell_common.cuh"

namespace tps {

constexpr int kBellWarps = 8;
constexpr int kBellThreads = 32 * kBellWarps;
constexpr int kBellCols = 64;                 // output columns per block
constexpr int kBellColsPerWarp = kBellCols / kBellWarps;
constexpr int kBellMaxVec = 8;                // float4 per lane: W <= 1024
constexpr unsigned kFull = 0xffffffffu;

// Copy the first `cnt` values of a packed row into registers (16-byte loads;
// the last load may read up to 3 zero pads, never past the row, since W is
// a multiple of 4 and cnt <= W).
__device__ __forceinline__ void bell_load_row(const float* __restrict__ row, int cnt,
                                              int lane, float4 (&t)[kBellMaxVec]) {
#pragma unroll
  for (int u = 0; u < kBellMaxVec; ++u) {
    const int p = (u * 32 + lane) * 4;
    t[u] = p < cnt ? reinterpret_cast<const float4*>(row)[p >> 2]
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ void bell_store_row(float* buf, int cnt, int lane,
                                               const float4 (&t)[kBellMaxVec]) {
#pragma unroll
  for (int u = 0; u < kBellMaxVec; ++u) {
    const int p = (u * 32 + lane) * 4;
    if (p < cnt) reinterpret_cast<float4*>(buf)[p >> 2] = t[u];
  }
}

// Live values of local column c: the popcount of its nwords words.
__device__ __forceinline__ int bell_count(const uint32_t* bm, int c, int nwords, int lane) {
  return __reduce_add_sync(kFull, lane < nwords ? __popc(bm[c * nwords + lane]) : 0);
}

template <int BT>
__global__ void __launch_bounds__(kBellThreads)
bell_partial_kernel(const uint32_t* __restrict__ bitmap, const float* __restrict__ vals,
                    const float* __restrict__ x, float* __restrict__ part, int mb,
                    int block_m, int w, int batch, int ldx, int per_slice) {
  extern __shared__ __align__(16) float smem[];
  const int nwords = block_m >> 5;
  float* xs = smem;                                              // [BT][block_m]
  uint32_t* bm = reinterpret_cast<uint32_t*>(xs + BT * block_m);  // [kBellCols][nwords]
  float* vbuf = reinterpret_cast<float*>(bm + kBellCols * nwords);  // [kBellWarps][w]
  float* red = vbuf + kBellWarps * w;                            // [BT][kBellCols]

  constexpr int chunks = kLanes / kBellCols;
  const int j = blockIdx.x / chunks, c0 = (blockIdx.x % chunks) * kBellCols;
  const int slice = blockIdx.y, b0 = blockIdx.z * BT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  float* vb = vbuf + warp * w;
  // step s of a column: position l = 32 s + lane sits in word l % nwords at
  // bit l / nwords; both advance by (32 % nwords, 32 / nwords) a step
  const int d_word = 32 % nwords, d_bit = 32 / nwords;

  for (int q = threadIdx.x; q < BT * kBellCols; q += kBellThreads) red[q] = 0.f;
  const int i0 = slice * per_slice, i1 = min(mb, i0 + per_slice);
  for (int i = i0; i < i1; ++i) {
    __syncthreads();  // the previous block's x window and words are done with
    for (int q = threadIdx.x; q < BT * block_m; q += kBellThreads) {
      const int b = q / block_m, col = i * block_m + q % block_m;
      xs[q] = (b0 + b < batch && col < ldx) ? x[(size_t)(b0 + b) * ldx + col] : 0.f;
    }
    const size_t tile = (size_t)j * mb + i;        // (j, i) tile, 128 rows
    const uint32_t* words = bitmap + (tile * kLanes + c0) * nwords;
    for (int q = threadIdx.x; q < kBellCols * nwords; q += kBellThreads) bm[q] = words[q];
    __syncthreads();

    const float* vrows = vals + (tile * kLanes + c0) * (size_t)w;
    float4 t[kBellMaxVec];
    int cnt = bell_count(bm, warp, nwords, lane);
    bell_load_row(vrows + (size_t)warp * w, cnt, lane, t);
    for (int k = 0; k < kBellColsPerWarp; ++k) {
      const int c = warp + k * kBellWarps;
      __syncwarp();                                // the previous column is summed
      bell_store_row(vb, cnt, lane, t);
      __syncwarp();
      if (k + 1 < kBellColsPerWarp) {              // next column's copy in flight
        const int cn = c + kBellWarps;
        cnt = bell_count(bm, cn, nwords, lane);
        bell_load_row(vrows + (size_t)cn * w, cnt, lane, t);
      }
      const uint32_t mine = lane < nwords ? bm[c * nwords + lane] : 0u;
      float acc[BT];
#pragma unroll
      for (int b = 0; b < BT; ++b) acc[b] = 0.f;
      int base = 0, wi = lane % nwords, bit = lane / nwords;
      for (int l0 = 0; l0 < block_m; l0 += 32) {
        const uint32_t word = __shfl_sync(kFull, mine, wi);
        const bool live = (word >> bit) & 1u;
        const unsigned ballot = __ballot_sync(kFull, live);
        if (live) {
          const float v = vb[base + __popc(ballot & below)];
          const int l = l0 + lane;
#pragma unroll
          for (int b = 0; b < BT; ++b) acc[b] = fmaf(v, xs[b * block_m + l], acc[b]);
        }
        base += __popc(ballot);
        wi += d_word;
        bit += d_bit;
        if (wi >= nwords) { wi -= nwords; ++bit; }
      }
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        float s = acc[b];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
        acc[b] = s;
      }
      if (lane == 0) {
#pragma unroll
        for (int b = 0; b < BT; ++b) red[b * kBellCols + c] += acc[b];
      }
    }
  }
  __syncthreads();
  const size_t np = (size_t)(gridDim.x / chunks) * kLanes;
  for (int q = threadIdx.x; q < BT * kBellCols; q += kBellThreads) {
    const int b = q / kBellCols, c = q % kBellCols;
    if (b0 + b < batch)
      part[((size_t)slice * batch + b0 + b) * np + (size_t)j * kLanes + c0 + c] = red[q];
  }
}

template <int BT>
int bell_launch(const uint32_t* bitmap, const float* vals, const float* x, float* part,
                int nb, int mb, int block_m, int w, int batch, int ldx, int slices,
                int per_slice, cudaStream_t st) {
  const size_t smem = ((size_t)BT * block_m + (size_t)kBellCols * (block_m / 32) +
                       (size_t)kBellWarps * w + (size_t)BT * kBellCols) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bell_partial_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(nb * (kLanes / kBellCols), slices, (batch + BT - 1) / BT);
  bell_partial_kernel<BT><<<grid, kBellThreads, smem, st>>>(
      bitmap, vals, x, part, mb, block_m, w, batch, ldx, per_slice);
  return 0;
}

}  // namespace tps

// bitmap: (nb, mb, 128, block_m/32) uint32 bits; vals: (nb, mb, 128, w) fp32,
// w a multiple of 4 and <= 1024; block_m a multiple of 32, <= 1024.
// x: (batch, ldx) fp32, ldx <= mb*block_m (missing columns read as 0);
// part: (slices, batch, nb*128) fp32 scratch; y: (batch, n) fp32.
extern "C" int tps_bell_spmm(const void* bitmap, const void* vals, const void* x,
                             void* part, void* y, int nb, int mb, int block_m, int w,
                             int batch, int ldx, int slices, int per_slice, int n,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nb <= 0 || batch <= 0 || slices <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* bm = static_cast<const uint32_t*>(bitmap);
  const auto* vv = static_cast<const float*>(vals);
  const auto* xx = static_cast<const float*>(x);
  auto* pp = static_cast<float*>(part);
  int rc;
  switch (tps::batch_tile(batch)) {
    case 1: rc = tps::bell_launch<1>(bm, vv, xx, pp, nb, mb, block_m, w, batch, ldx, slices, per_slice, st); break;
    case 2: rc = tps::bell_launch<2>(bm, vv, xx, pp, nb, mb, block_m, w, batch, ldx, slices, per_slice, st); break;
    case 4: rc = tps::bell_launch<4>(bm, vv, xx, pp, nb, mb, block_m, w, batch, ldx, slices, per_slice, st); break;
    default: rc = tps::bell_launch<8>(bm, vv, xx, pp, nb, mb, block_m, w, batch, ldx, slices, per_slice, st); break;
  }
  if (rc != 0) return rc;
  tps::launch_reduce(pp, nullptr, static_cast<float*>(y), slices, batch, nb * tps::kLanes,
                     n, st);
  return (int)cudaGetLastError();
}
