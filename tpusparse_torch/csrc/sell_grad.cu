// SELL value gradient for Hopper:
//   dvals[j,t,s,r] = sum_b x[b, t*128 + idx[j,t,s,r]] * g[b, j*128 + r],
// and exactly 0 where idx == -1 (a pad slot).
//
// Replaces the TPU kernel tpusparse/kernels/sell_grad.py:_dvals_kernel
// (through sell_dvals_padded). Its windows_per_step / col_groups_per_step
// and the VMEM shrink loop size the TPU's grid steps and have no
// counterpart here.
//
// Bound: bytes. Each slot reads 1 byte of idx and writes 4 bytes of dvals;
// x and g add B*(Mp + Np)*4 bytes, read once from HBM and then from L2. Its
// 2*B flops a slot are far below the card's operations-per-byte balance.
//
// Design: one 128-thread block per (j, t) tile. The x window of t is staged
// in shared memory for every batch row, as K1 does (sell_common.cuh);
// lane q of each warp owns the 4 adjacent columns j*128 + 4q .. 4q+3 and
// keeps their g values in registers; the 4 warps split the W slot rows, and
// each slot row costs a lane one char4 read of idx and one float4 write of
// dvals. Every slot is written once: no second pass, no float atomics. The
// sum runs over b in order, each step a separate multiply and add
// (__fmul_rn / __fadd_rn), the TPU kernel's arithmetic (sell_grad.py:43-48),
// so the kernel and its plain version agree bit for bit. A batch of more
// than 8 rows, off the training path's shapes, takes a generic body that
// reads x and g through L1 instead.
#include "sell_common.cuh"

namespace tps {

// At least 8 blocks an SM (64 registers a thread): one wave holds the 1,024
// tiles of a 4096^2 pack; the uncapped B = 8 body took 72 registers, so 7
// blocks fitted and a second, nearly empty wave doubled its time.
template <int BT>
__global__ void __launch_bounds__(kThreads, 8)
dvals_kernel(const int8_t* __restrict__ idx, const float* __restrict__ x,
             const float* __restrict__ g, float* __restrict__ out, int nt,
             int w, int batch, int ldx, int ldg) {
  __shared__ float xs[BT][kLanes];
  const int j = blockIdx.x / nt, t = blockIdx.x % nt;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float gr[BT][kCols];
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = j * kLanes + kCols * lane + c;
      gr[b][c] = (b < batch && col < ldg) ? g[(size_t)b * ldg + col] : 0.f;
    }
  stage_window<BT>(xs, x, ldx, t, 0, batch);
  const size_t tile = (size_t)blockIdx.x * w * kLanes;
#pragma unroll 4
  for (int s = warp; s < w; s += kWarps) {
    const size_t row = tile + (size_t)s * kLanes;
    const char4 i4 = reinterpret_cast<const char4*>(idx + row)[lane];
    const int ii[kCols] = {i4.x, i4.y, i4.z, i4.w};
    float v[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int off = max(ii[c], 0);
      float acc = 0.f;
#pragma unroll
      for (int b = 0; b < BT; ++b)
        if (b < batch) acc = __fadd_rn(acc, __fmul_rn(xs[b][off], gr[b][c]));
      v[c] = ii[c] < 0 ? 0.f : acc;
    }
    reinterpret_cast<float4*>(out + row)[lane] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Any batch: the same sums, with x and g read from global memory (L1).
__global__ void __launch_bounds__(kThreads)
dvals_kernel_any(const int8_t* __restrict__ idx, const float* __restrict__ x,
                 const float* __restrict__ g, float* __restrict__ out, int nt,
                 int w, int batch, int ldx, int ldg) {
  const int j = blockIdx.x / nt, t = blockIdx.x % nt;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t tile = (size_t)blockIdx.x * w * kLanes;
  for (int s = warp; s < w; s += kWarps) {
    const size_t row = tile + (size_t)s * kLanes;
    const char4 i4 = reinterpret_cast<const char4*>(idx + row)[lane];
    const int ii[kCols] = {i4.x, i4.y, i4.z, i4.w};
    float v[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int xc = t * kLanes + max(ii[c], 0);
      const int gc = j * kLanes + kCols * lane + c;
      float acc = 0.f;
      for (int b = 0; b < batch; ++b) {
        const float xv = xc < ldx ? __ldg(x + (size_t)b * ldx + xc) : 0.f;
        const float gv = gc < ldg ? __ldg(g + (size_t)b * ldg + gc) : 0.f;
        acc = __fadd_rn(acc, __fmul_rn(xv, gv));
      }
      v[c] = ii[c] < 0 ? 0.f : acc;
    }
    reinterpret_cast<float4*>(out + row)[lane] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

}  // namespace tps

// idx: (nb, nt, w, 128) int8, -1 on pad slots; x: (batch, ldx) fp32 with
// ldx <= nt*128; g: (batch, ldg) fp32 with ldg <= nb*128 (columns past
// either width read as 0); out: (nb, nt, w, 128) fp32.
extern "C" int tps_sell_dvals(const void* idx, const void* x, const void* g,
                              void* out, int nb, int nt, int w, int batch,
                              int ldx, int ldg, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)nb * nt;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (tiles == 0 || w == 0) return (int)cudaGetLastError();
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* ix = static_cast<const int8_t*>(idx);
  const auto* xx = static_cast<const float*>(x);
  const auto* gg = static_cast<const float*>(g);
  auto* oo = static_cast<float*>(out);
  const unsigned grid = (unsigned)tiles;
  const int k = tps::kThreads;
  if (batch > 8) {
    tps::dvals_kernel_any<<<grid, k, 0, st>>>(ix, xx, gg, oo, nt, w, batch, ldx, ldg);
  } else {
    switch (tps::batch_tile(batch)) {
      case 1: tps::dvals_kernel<1><<<grid, k, 0, st>>>(ix, xx, gg, oo, nt, w, batch, ldx, ldg); break;
      case 2: tps::dvals_kernel<2><<<grid, k, 0, st>>>(ix, xx, gg, oo, nt, w, batch, ldx, ldg); break;
      case 4: tps::dvals_kernel<4><<<grid, k, 0, st>>>(ix, xx, gg, oo, nt, w, batch, ldx, ldg); break;
      default: tps::dvals_kernel<8><<<grid, k, 0, st>>>(ix, xx, gg, oo, nt, w, batch, ldx, ldg); break;
    }
  }
  return (int)cudaGetLastError();
}
