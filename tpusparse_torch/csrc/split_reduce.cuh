// The fixed-order split-contraction reduce, fused into the kernel that
// writes the partial sums (K2 dense.cu, K11 sell_mxu_spmm.cu, K12
// bell_spmv.cu), so that a call is one launch.
//
// Every block of a (column group, batch tile) writes its slice's partial
// sums to part[(slice * batch + b) * ldp + c], then calls split_reduce_tail:
// the block publishes its writes (__threadfence) and counts its arrival on
// the group's counter with one atomicAdd. The block that arrives last sums
// the slices in order 0 .. slices-1 from 0.f, as reduce_partials_kernel
// (sell_common.cuh) does, writes y and sets the counter back to 0 for the
// next call. Which block comes last varies; the order of the sum does not,
// so two calls give the same bits. The counters (int32, one per group and
// batch tile) are zeroed once by their owner and left at 0 by every call;
// one set per stream, since two calls in flight on two streams would
// otherwise count each other's blocks.
//
// The last block's work is the tail of the whole call, so nothing in it
// waits on one load at a time: each thread owns up to kWords words of the
// outputs (4 adjacent columns with kVec, which needs ldp % 4 == 0, else 1;
// kWords is as small as the kernel's shape allows, since the tail's
// registers count against the whole kernel's occupancy), copies them
// from as many slices as the scratch holds into its own part of shared
// memory (cp.async, all in flight at once; the 16-byte form reads L2,
// where the other blocks' fenced writes are), then adds them up in order
// in registers. No index is divided in the copy loop.
#pragma once

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace tps {

// rows x cols outputs of this group and batch tile: y[(b0 + b) * ldy + c0 + c]
// = sum_k part[(k * batch + b0 + b) * ldp + c0 + c]. Call from every thread,
// after the block is done with `scratch` (shared, 16-byte aligned). The
// block's threads x kWords words must cover the outputs, and the scratch
// must hold one slice of them: rows * round_up(cols, 4) floats.
template <int kWords, bool kVec>
__device__ __forceinline__ void split_reduce_tail(const float* part, float* __restrict__ y,
                                                  int* counter, int slices, int batch,
                                                  size_t ldp, size_t ldy, int b0, int rows,
                                                  int c0, int cols, float* scratch,
                                                  int scratch_floats) {
  __shared__ int last;
  __threadfence();   // this block's partial sums are visible before it counts
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == slices - 1;
  __syncthreads();
  if (!last) return;
  if (rows <= 0 || cols <= 0) {     // nothing of y here; the counter still resets
    if (threadIdx.x == 0) *counter = 0;
    return;
  }
  __threadfence();   // ... and the other blocks' before the last one reads them
  constexpr int width = kVec ? 4 : 1;             // floats a word
  const int cw = (cols + width - 1) / width;      // words a row
  const int per = rows * cw;                      // words a slice
  const int chunk = max(1, scratch_floats / (width * per));
  const int t = threadIdx.x, nthreads = blockDim.x;
  const float* src[kWords];                   // my words in slice 0
  float4 acc[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const int o = t + i * nthreads;
    const int b = o / cw, c = o % cw;
    src[i] = part + (size_t)(b0 + b) * ldp + c0 + width * c;
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const size_t step = (size_t)batch * ldp;        // from one slice to the next
  for (int k0 = 0; k0 < slices; k0 += chunk) {
    const int nk = min(chunk, slices - k0);
    for (int k = 0; k < nk; ++k)
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        const int o = t + i * nthreads;
        if (o < per) {
          float* dst = scratch + width * ((size_t)k * per + o);
          if (kVec)
            copy_async<16>(dst, src[i] + (k0 + k) * step, true);
          else
            copy_async<4>(dst, src[i] + (k0 + k) * step, true);
        }
      }
    copy_commit();
    copy_wait<0>();   // each thread reads back only what it copied
    for (int k = 0; k < nk; ++k)
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        const int o = t + i * nthreads;
        if (o < per) {
          const float* v = scratch + width * ((size_t)k * per + o);
          if (kVec) {
            const float4 q = *reinterpret_cast<const float4*>(v);
            acc[i].x += q.x; acc[i].y += q.y; acc[i].z += q.z; acc[i].w += q.w;
          } else {
            acc[i].x += *v;
          }
        }
      }
  }
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const int o = t + i * nthreads;
    if (o < per) {
      const int b = o / cw, c = width * (o % cw);
      float* out = y + (size_t)(b0 + b) * ldy + c0 + c;
      const float s[4] = {acc[i].x, acc[i].y, acc[i].z, acc[i].w};
      for (int u = 0; u < width && c + u < cols; ++u) out[u] = s[u];
    }
  }
  if (threadIdx.x == 0) *counter = 0;
}

}  // namespace tps
