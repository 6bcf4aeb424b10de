// SELL SpMM by decompress-to-dense for Hopper (K11):
//   dense_t[c, r] = sum_s [idx[j,t,s,r] == c] * vals[j,t,s,r]      (c, r < 128)
//   y[b, j*128 + r] = sum_t sum_c x[b, t*128 + c] * dense_t[c, r].
//
// Replaces the TPU study kernel tpusparse/kernels/sell_mxu_spmm.py:_mxu_kernel,
// which scatter-adds each (W, 128) SELL tile into a dense (128, 128) VMEM
// tile and multiplies it on the MXU, so one dense product serves every
// batch row (the reference's csr_tiling strategy).
//
// Bound: the function's own is bytes (the SELL pack, 5 bytes a slot, beside
// 2*nnz*B flops). The design does dense work on purpose: 2*128*128*B flops a
// tile whatever the tile's nonzeros, i.e. 2*M*N*B over the whole product,
// at the card's FP32 FFMA rate (67 TFLOP/s). At low density and small B that
// dense work, not the bytes, sets its time; that is the finding the floors
// study (tpusparse_torch/bench/report.py) measures.
//
// Design: a 128-thread block owns column group j and a slice of windows t.
// For each t it zeroes a 128 x 128 fp32 tile in shared memory (64 KB, above
// the 48 KB default, so the launch raises the block's dynamic shared-memory
// limit), and thread r scatter-ADDS its column's W slots into column r of
// the tile. The add is required: pad slots carry index 0 and value 0 and
// alias a real offset-0 entry, which a store would overwrite; one thread
// owns each column, so the adds never race. Then thread r accumulates
// y[b, r] += sum_c x[b, c] * tile[c, r] for its BT batch rows in registers
// (FP32 FFMA, no tensor cores, no TF32), reading x four columns at a time
// from the staged window. Batches above 32 run in tiles of 32 over
// blockIdx.z. As in K1, the slices write partial sums that the fixed-order
// reduce of sell_common.cuh adds up: no atomics, deterministic.
#include "sell_common.cuh"

namespace tps {

constexpr int kMxuThreads = kLanes;           // one thread per output column

template <int BT>
__global__ void __launch_bounds__(kMxuThreads)
sell_mxu_partial_kernel(const int8_t* __restrict__ idx, const float* __restrict__ vals,
                        const float* __restrict__ x, float* __restrict__ part, int nt,
                        int w, int batch, int ldx, int per_slice) {
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;                          // [128 c][128 r]
  float* xs = smem + kLanes * kLanes;          // [BT][128]
  const int j = blockIdx.x, slice = blockIdx.y, b0 = blockIdx.z * BT;
  const int r = threadIdx.x;
  float acc[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) acc[b] = 0.f;
  const int t0 = slice * per_slice, t1 = min(nt, t0 + per_slice);
  for (int t = t0; t < t1; ++t) {
    __syncthreads();                           // done with the previous tile
    for (int q = r; q < kLanes * kLanes / 4; q += kMxuThreads)
      reinterpret_cast<float4*>(tile)[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = r; q < BT * kLanes; q += kMxuThreads) {
      const int b = q / kLanes, col = t * kLanes + q % kLanes;
      xs[q] = (b0 + b < batch && col < ldx) ? x[(size_t)(b0 + b) * ldx + col] : 0.f;
    }
    __syncthreads();
    const size_t base = ((size_t)j * nt + t) * w * kLanes + r;
#pragma unroll 8
    for (int s = 0; s < w; ++s) {
      const int c = idx[base + (size_t)s * kLanes];
      tile[c * kLanes + r] += vals[base + (size_t)s * kLanes];
    }
    // only thread r wrote column r, and only thread r reads it below
#pragma unroll 2
    for (int c = 0; c < kLanes; c += 4) {
      const float d0 = tile[(c + 0) * kLanes + r], d1 = tile[(c + 1) * kLanes + r];
      const float d2 = tile[(c + 2) * kLanes + r], d3 = tile[(c + 3) * kLanes + r];
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const float4 xv = reinterpret_cast<const float4*>(xs + b * kLanes)[c >> 2];
        acc[b] = fmaf(xv.x, d0, acc[b]);
        acc[b] = fmaf(xv.y, d1, acc[b]);
        acc[b] = fmaf(xv.z, d2, acc[b]);
        acc[b] = fmaf(xv.w, d3, acc[b]);
      }
    }
  }
  const size_t np = (size_t)gridDim.x * kLanes;
#pragma unroll
  for (int b = 0; b < BT; ++b)
    if (b0 + b < batch)
      part[((size_t)slice * batch + b0 + b) * np + (size_t)j * kLanes + r] = acc[b];
}

template <int BT>
int sell_mxu_launch(const int8_t* idx, const float* vals, const float* x, float* part,
                    int nb, int nt, int w, int batch, int ldx, int slices, int per_slice,
                    cudaStream_t st) {
  const int smem = (kLanes * kLanes + BT * kLanes) * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      sell_mxu_partial_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nb, slices, (batch + BT - 1) / BT);
  sell_mxu_partial_kernel<BT><<<grid, kMxuThreads, smem, st>>>(
      idx, vals, x, part, nt, w, batch, ldx, per_slice);
  return 0;
}

}  // namespace tps

// idx: (nb, nt, w, 128) int8, vals: (nb, nt, w, 128) fp32 (a SELL pack);
// x: (batch, ldx) fp32, ldx <= nt*128 (missing columns read as 0);
// part: (slices, batch, nb*128) fp32 scratch; y: (batch, n) fp32.
extern "C" int tps_sell_mxu_spmm(const void* idx, const void* vals, const void* x,
                                 void* part, void* y, int nb, int nt, int w, int batch,
                                 int ldx, int slices, int per_slice, int n, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nb <= 0 || batch <= 0 || slices <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* ix = static_cast<const int8_t*>(idx);
  const auto* vv = static_cast<const float*>(vals);
  const auto* xx = static_cast<const float*>(x);
  auto* pp = static_cast<float*>(part);
  int rc;
  if (batch <= 1) rc = tps::sell_mxu_launch<1>(ix, vv, xx, pp, nb, nt, w, batch, ldx, slices, per_slice, st);
  else if (batch <= 2) rc = tps::sell_mxu_launch<2>(ix, vv, xx, pp, nb, nt, w, batch, ldx, slices, per_slice, st);
  else if (batch <= 4) rc = tps::sell_mxu_launch<4>(ix, vv, xx, pp, nb, nt, w, batch, ldx, slices, per_slice, st);
  else if (batch <= 8) rc = tps::sell_mxu_launch<8>(ix, vv, xx, pp, nb, nt, w, batch, ldx, slices, per_slice, st);
  else if (batch <= 16) rc = tps::sell_mxu_launch<16>(ix, vv, xx, pp, nb, nt, w, batch, ldx, slices, per_slice, st);
  else rc = tps::sell_mxu_launch<32>(ix, vv, xx, pp, nb, nt, w, batch, ldx, slices, per_slice, st);
  if (rc != 0) return rc;
  tps::launch_reduce(pp, nullptr, static_cast<float*>(y), slices, batch, nb * tps::kLanes,
                     n, st);
  return (int)cudaGetLastError();
}
