// The device plan of the activation-skipping products (K3 AWSP over window
// groups of G*128 rows, K9 ASP over 128-row windows): from X alone, with no
// host sync,
//   plan = the ids of the groups where X has a nonzero, ascending, then the
//          zero group ng in every place after them;
//   k    = max(1, number of live groups),
// bit for bit what kernels/awsp_spmv.py:device_group_plan_plain gives (the
// JAX package's device_group_plan, tpusparse/kernels/awsp_spmv.py, is XLA
// ops; in torch ops it took ~10 launches and ~17 us of device time).
//
// Bound: bytes — X is read once (128 KB at the headline's B = 8); the call
// costs its launch and a few round trips to memory.
//
// Design: one launch. Each block tests kPlanChunk floats of one group (a
// run of its batch rows' columns, one 16-byte load a thread where x allows
// it), marks the group live in a flag array that is 0 between calls (kept
// after the arrival counter) and counts its arrival with one release-acquire
// atomic. The last block to arrive reads the flags back from L2, compacts
// them 256 at a time (a warp ballot a warp), writes plan and k, and sets the
// flags and the counter back to 0 for the next call.
#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tps {

constexpr int kPlanThreads = 256;
constexpr int kPlanChunk = 4 * kPlanThreads;   // floats a block tests: a 16-byte load a thread

__global__ void __launch_bounds__(kPlanThreads)
group_plan_kernel(const float* __restrict__ x, int* __restrict__ plan, int* __restrict__ count,
                  int* counter, int* flags, int batch, int ldx, int ng, int span, int per_group,
                  bool vec) {
  __shared__ int last;
  __shared__ int warp_live[kPlanThreads / 32];
  const int grp = blockIdx.x / per_group, piece = blockIdx.x % per_group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this block's elements [e0, e1) of the group's batch rows x columns
  // (element e is row e / width, column c0 + e % width)
  const int c0 = grp * span, width = max(0, min(c0 + span, ldx) - c0);
  const int e0 = min(piece * kPlanChunk, batch * width);
  const int e1 = min(e0 + kPlanChunk, batch * width);
  int any = 0;
  if (vec) {   // ldx, span and x multiples of 4 floats: width and e0 too
    const int w4 = width / 4;
    for (int e = e0 / 4 + tid; e < e1 / 4; e += kPlanThreads) {
      const int b = e / w4, q = e - b * w4;
      const float4 v = reinterpret_cast<const float4*>(x + (size_t)b * ldx + c0)[q];
      any |= (v.x != 0.f) | (v.y != 0.f) | (v.z != 0.f) | (v.w != 0.f);
    }
  } else {
#pragma unroll 4
    for (int e = e0 + tid; e < e1; e += kPlanThreads) {
      const int b = e / width, q = e - b * width;
      any |= x[(size_t)b * ldx + c0 + q] != 0.f;
    }
  }
  const int live = __syncthreads_or(any);
  if (tid == 0) {
    if (live) flags[grp] = 1;
    // release: the flag is visible before the block counts; acquire: the
    // last block sees every block's flag
    cuda::atomic_ref<int, cuda::thread_scope_device> arrived(*counter);
    last = arrived.fetch_add(1, cuda::memory_order_acq_rel) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // plan[0 .. ng) = the live ids, ascending, then ng: each chunk's live ids
  // land after the earlier chunks' and, within it, the earlier warps'
  int base = 0;
  for (int c = 0; c < ng; c += kPlanThreads) {
    const int i = c + tid;
    const int f = i < ng ? __ldcg(flags + i) : 0;
    const unsigned m = __ballot_sync(0xffffffffu, f != 0);
    if (lane == 0) warp_live[warp] = __popc(m);
    __syncthreads();
    int at = base, all = 0;
#pragma unroll
    for (int q = 0; q < kPlanThreads / 32; ++q) {
      at += q < warp ? warp_live[q] : 0;
      all += warp_live[q];
    }
    if (f) plan[at + __popc(m & ((1u << lane) - 1u))] = i;
    base += all;
    __syncthreads();   // the counts are read before the next chunk's
  }
  for (int i = tid; i < ng; i += kPlanThreads) {
    if (i >= base) plan[i] = ng;
    flags[i] = 0;      // 0 again for the next call
  }
  if (tid == 0) {
    *count = max(base, 1);
    *counter = 0;
  }
}

}  // namespace tps

// x: (batch, ldx) fp32 (columns past ldx read as 0, columns past ng*span are
// not read); plan: (ng,) int32; count: (1,) int32; counters: 1 + ng int32,
// all 0 (the arrival counter, then the flags; every call leaves them at 0).
extern "C" int tps_group_plan(const void* x, void* plan, void* count, void* counters, int batch,
                              int ldx, int ng, int span, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ng <= 0 || span <= 0 || batch < 0 || ldx < 0) return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const bool vec = ldx % 4 == 0 && span % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const auto* xx = static_cast<const float*>(x);
  auto* pl = static_cast<int*>(plan);
  auto* kk = static_cast<int*>(count);
  long long per = ((long long)batch * span + tps::kPlanChunk - 1) / tps::kPlanChunk;
  per = per < 1 ? 1 : per;   // blocks a group
  if (per * ng > 0x7fffffff) return (int)cudaErrorInvalidValue;
  auto* cc = static_cast<int*>(counters);
  tps::group_plan_kernel<<<(unsigned)(per * ng), tps::kPlanThreads, 0, st>>>(
      xx, pl, kk, cc, cc + 1, batch, ldx, ng, span, (int)per, vec);
  return (int)cudaGetLastError();
}
