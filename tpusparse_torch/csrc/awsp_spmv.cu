// AWSP SpMV/SpMM for Hopper (K3): the SELL product restricted to the active
// G x 128-row window groups of a plan,
//   y[b, j*128 + r] = sum_{p < k} sum_{u < G} sum_s vals[j, t, s, r] * x[b, t*128 + idx[j, t, s, r]],
// with t = plan[p] * G + u.
//
// Replaces the TPU kernel tpusparse/kernels/awsp_spmv.py:_awsp_kernel
// (through _awsp_call, for both the static plan and the device plan).
//
// Bound: bytes — the live groups' tiles only (5 bytes a fp32 slot, 3 a bf16
// slot) for 2 * B flops a slot: far below the card's operations-per-byte
// balance. The headline pack with every group live (4096^2, d = 0.5, B = 1)
// reads 57.7 MB, 17.2 us at 3.35 TB/s; with a quarter of the groups live
// 14.4 MB, 4.3 us.
//
// Design: one launch a call, whatever the live count.
// - The work of a column group j is its live slot rows: the k live plan
//   positions' G windows, W rows each, k*G*W rows in plan order (row r is
//   row r % W of window r / W of the live list). The launch grid is sized
//   from the plan's static length (never from k, so a device plan needs no
//   host sync): `slices` blocks a column group and batch tile, chosen by the
//   wrapper so that the grid fills the card once. Each block reads k from
//   device memory (with the plan, up to kAwspPlanMax entries of it, in the
//   same round trip) and takes the s-th of the even, 4-row-aligned parts of
//   its group's live rows. With few live windows a part is a piece of a
//   window, so the live work still fills the card; a block past the last
//   part returns at once, reading nothing of the pack.
// - A part streams through a ring of kAwspStages shared-memory stages. A
//   stage is up to kAwspRows consecutive slot rows of one tile: one thread
//   fetches their values and their offsets with two 1D bulk copies (each a
//   contiguous slab) that complete on the stage's mbarrier, kAwspStages-1
//   stages ahead of the multiply. With a tile's first stage the threads
//   copy the tile's x window into a ring of x windows of its own (16-byte
//   cp.async where x allows, zero past the batch or x's width). On an H100
//   2D tensor copies (TMA) of 8-row boxes, 16-row stages, 4 stages and 8
//   warps a block measured no faster (PERF.md).
// - Lane q of each warp owns columns 4q .. 4q+3 of the group and the warps
//   take the stage's rows w, w + 4, ...: one vector read of 4 values and 4
//   offsets a row from shared memory, then the gathers of x. One
//   __syncthreads a stage frees the previous stage.
// - At the end the warps' sums are added in warp order and written as the
//   part's partial sums; the last of the parts to arrive adds the parts in
//   order 0 .. parts-1 (split_reduce.cuh) and writes y: deterministic, no
//   float atomics, one launch. Only the parts that got work arrive, and
//   their number follows from k.
// An all-zero X gives k = 1 with plan[0] = ng, the all-zero group, so y = 0;
// k = 0 gives one empty part and y = 0 as well.
#include <cstddef>
#include <cstdint>

#include "async_copy.cuh"
#include "sell_common.cuh"
#include "split_reduce.cuh"

namespace tps {

constexpr int kAwspRows = 32;      // slot rows a ring stage, at most
constexpr int kAwspStages = 3;     // stages in the ring, kAwspStages-1 in flight
constexpr int kAwspWarps = 4;      // warps a block
constexpr int kAwspThreads = 32 * kAwspWarps;
constexpr int kAwspHeader = 128;   // the stages' mbarriers
constexpr int kAwspQuantum = 4;    // a part's rows: a multiple of this
constexpr int kAwspPlanMax = 256;  // plan entries a block keeps in shared memory

// A stage's slot rows, then (in a ring of their own) the x windows of the
// tiles in flight: a tile's window is copied once, with its first stage.
template <typename T>
struct AwspStage {
  T vals[kAwspRows][kLanes];
  int8_t idx[kAwspRows][kLanes];
};

template <typename T, int BT>
constexpr int kAwspSmem = kAwspHeader + kAwspStages * ((int)sizeof(AwspStage<T>) + BT * kLanes * 4);

// Floats of the tail's scratch: after the warps' sums, the rest of the ring.
template <typename T, int BT>
constexpr int kAwspScratch = (kAwspSmem<T, BT> - kAwspHeader) / 4 - kAwspWarps * BT * kLanes;

template <typename T, int BT>
__global__ void __launch_bounds__(kAwspThreads)
awsp_stream_kernel(const int* __restrict__ plan, const int* __restrict__ count,
                   const int8_t* __restrict__ idx, const T* __restrict__ vals,
                   const float* __restrict__ x, float* part, float* __restrict__ y,
                   int* counters, int ntot, int g, int plan_len, int w, int batch, int ldx,
                   int n, bool vec_x) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int plan_s[kAwspPlanMax];
  // k and (a short plan) the plan, read together: one round trip to memory
  const bool short_plan = plan_len <= kAwspPlanMax;
  if (short_plan)
    for (int q = threadIdx.x; q < plan_len; q += kAwspThreads) plan_s[q] = plan[q];
  const int* pl = short_plan ? plan_s : plan;
  auto* bars = reinterpret_cast<uint64_t*>(smem);
  auto* ring = reinterpret_cast<AwspStage<T>*>(smem + kAwspHeader);
  auto* xw = reinterpret_cast<float (*)[BT][kLanes]>(smem + kAwspHeader +
                                                     kAwspStages * sizeof(AwspStage<T>));
  const int j = blockIdx.x, slice = blockIdx.y, b0 = blockIdx.z * BT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // this block's part of the group's live rows, from k read on the device
  const int live = max(0, min(*count, plan_len)) * g * w, slices = (int)gridDim.y;
  const int per = ((live + slices - 1) / slices + kAwspQuantum - 1) / kAwspQuantum * kAwspQuantum;
  const int parts = per > 0 ? (live + per - 1) / per : 1;
  if (slice >= parts) return;   // no share: no read of the pack, no arrival
  const int r0 = slice * per, r1 = min(live, r0 + per);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kAwspStages; ++s) bar_init(&bars[s]);
    bar_init_fence();
  }
  __syncthreads();   // the barriers and plan_s are ready

  // The stage that starts at live row c: rows c .. end(c)-1 of one tile.
  auto stage_end = [&](int c) { return min(min(r1, (c / w + 1) * w), c + kAwspRows); };
  // Issue the copies of the stage that starts at row `c` into ring[s % kAwspStages]
  // and, if it is a tile's first, the tile's x window into xw[tile % kAwspStages]
  // (the tiles in flight are no more than the stages).
  int tile_in = -1;   // tiles issued so far, less one
  auto issue = [&](int s, int c) {
    AwspStage<T>& st = ring[s % kAwspStages];
    const int i = c / w;                             // the tile's place in the live list
    const int t = pl[i / g] * g + i % g;             // its window
    if (threadIdx.x == 0) {
      const int rows = stage_end(c) - c;
      const size_t first = (((size_t)j * ntot + t) * w + (c - i * w)) * kLanes;
      bar_expect(&bars[s % kAwspStages], (unsigned)(rows * kLanes * ((int)sizeof(T) + 1)));
      bulk_copy(&st.vals[0][0], vals + first, (unsigned)(rows * kLanes * (int)sizeof(T)),
                &bars[s % kAwspStages]);
      bulk_copy(&st.idx[0][0], idx + first, (unsigned)(rows * kLanes), &bars[s % kAwspStages]);
    }
    if (c != r0 && c % w != 0) return;               // the tile's window is in flight
    float (*xd)[kLanes] = xw[++tile_in % kAwspStages];
    if (vec_x) {   // 16-byte copies: ldx % 4 == 0, so a quad is all in x or all past it
      for (int q = threadIdx.x; q < BT * kLanes / 4; q += kAwspThreads) {
        const int b = q / (kLanes / 4), col = t * kLanes + 4 * (q % (kLanes / 4));
        const bool ok = b0 + b < batch && col < ldx;
        copy_async<16>(&xd[b][col - t * kLanes], ok ? x + (size_t)(b0 + b) * ldx + col : x, ok);
      }
    } else {
      for (int q = threadIdx.x; q < BT * kLanes; q += kAwspThreads) {
        const int b = q / kLanes, col = t * kLanes + q % kLanes;
        const bool ok = b0 + b < batch && col < ldx;
        copy_async<4>(&xd[b][q % kLanes], ok ? x + (size_t)(b0 + b) * ldx + col : x, ok);
      }
    }
  };

  float acc[BT][kCols];   // rows b0 + b, columns j*128 + 4*lane .. + 3
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[b][c] = 0.f;

  int ic = r0;   // the first row not yet issued
#pragma unroll
  for (int s = 0; s < kAwspStages - 1; ++s) {
    if (ic < r1) {
      issue(s, ic);
      ic = stage_end(ic);
    }
    copy_commit();
  }
  int tile = -1;   // the consumed stage's tile, counted from 0
  for (int s = 0, cc = r0; cc < r1; ++s) {
    copy_wait<kAwspStages - 2>();   // this thread's x copies up to stage s landed
    bar_wait(&bars[s % kAwspStages], (s / kAwspStages) & 1);   // and stage s's rows
    __syncthreads();                // everyone's, and stage s-1 is free again
    if (ic < r1) {
      issue(s + kAwspStages - 1, ic);
      ic = stage_end(ic);
    }
    copy_commit();
    if (cc == r0 || cc % w == 0) ++tile;
    const int ce = stage_end(cc);
    const AwspStage<T>& st = ring[s % kAwspStages];
    const float (*xs)[kLanes] = xw[tile % kAwspStages];
#pragma unroll 4
    for (int r = warp; r < ce - cc; r += kAwspWarps) {
      const char4 i4 = reinterpret_cast<const char4*>(st.idx[r])[lane];
      float v[kCols];
      load4(st.vals[r], lane, v);
      const int ii[kCols] = {i4.x, i4.y, i4.z, i4.w};   // in-window offsets
#pragma unroll
      for (int b = 0; b < BT; ++b)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[b][c] = fmaf(v[c], xs[b][ii[c]], acc[b][c]);
    }
    cc = ce;
  }
  copy_wait<0>();
  __syncthreads();   // every warp is past its last stage: the ring holds the sums

  float* red = reinterpret_cast<float*>(smem + kAwspHeader);   // [kAwspWarps][BT][128]
#pragma unroll
  for (int b = 0; b < BT; ++b)
    reinterpret_cast<float4*>(red + (warp * BT + b) * kLanes)[lane] =
        make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
  __syncthreads();
  const size_t ldp = (size_t)gridDim.x * kLanes;
  const int rows = min(BT, batch - b0);
  for (int q = threadIdx.x; q < rows * kLanes; q += kAwspThreads) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kAwspWarps; ++k) s += red[k * BT * kLanes + q];
    part[((size_t)slice * batch + b0 + q / kLanes) * ldp + (size_t)j * kLanes + q % kLanes] = s;
  }
  constexpr int kWords = (BT * kLanes / 4 + kAwspThreads - 1) / kAwspThreads;
  split_reduce_tail<kWords, true>(
      part, y, counters + blockIdx.z * gridDim.x + j, parts, batch, ldp, n, b0, rows,
      j * kLanes, min(kLanes, n - j * kLanes), red + kAwspWarps * BT * kLanes,
      kAwspScratch<T, BT>);
}

// The dynamic shared-memory limit raised for each kernel, once a device and
// process (a file-scope array: a static inside the template would be one
// symbol across every library holding the same template).
constexpr int kAwspDevices = 16;
static bool awsp_smem_set[2][4][kAwspDevices];

template <typename T, int BT>
int launch_awsp(dim3 grid, int device, cudaStream_t st, const int* plan, const int* count,
                const int8_t* idx, const T* vals, const float* x, float* part, float* y,
                int* counters, int ntot, int g, int plan_len, int w, int batch, int ldx, int n,
                bool vec_x) {
  constexpr int smem = kAwspSmem<T, BT>;
  static_assert(kAwspScratch<T, BT> >= BT * kLanes, "the tail's scratch holds one slice");
  static_assert(sizeof(AwspStage<T>) % 16 == 0 && offsetof(AwspStage<T>, idx) % 16 == 0,
                "bulk copies land 16-byte aligned");
  auto kern = awsp_stream_kernel<T, BT>;
  bool* set = device < kAwspDevices
                  ? &awsp_smem_set[sizeof(T) == 4 ? 0 : 1]
                                  [BT == 1 ? 0 : BT == 2 ? 1 : BT == 4 ? 2 : 3][device]
                  : nullptr;
  if (set == nullptr || !*set) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (set != nullptr) *set = true;
  }
  kern<<<grid, kAwspThreads, smem, st>>>(plan, count, idx, vals, x, part, y, counters, ntot, g,
                                         plan_len, w, batch, ldx, n, vec_x);
  return 0;
}

template <typename T>
int awsp_spmm_t(const int* plan, const int* count, const int8_t* idx, const T* vals,
                const float* x, float* part, float* y, int* counters, int nb, int ntot, int g,
                int plan_len, int w, int batch, int ldx, int slices, int n, int device,
                cudaStream_t st) {
  const int bt = batch_tile(batch);
  const dim3 grid(nb, slices, (batch + bt - 1) / bt);
  const bool v = ldx % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  switch (bt) {
    case 1: return launch_awsp<T, 1>(grid, device, st, plan, count, idx, vals, x, part, y, counters, ntot, g, plan_len, w, batch, ldx, n, v);
    case 2: return launch_awsp<T, 2>(grid, device, st, plan, count, idx, vals, x, part, y, counters, ntot, g, plan_len, w, batch, ldx, n, v);
    case 4: return launch_awsp<T, 4>(grid, device, st, plan, count, idx, vals, x, part, y, counters, ntot, g, plan_len, w, batch, ldx, n, v);
    default: return launch_awsp<T, 8>(grid, device, st, plan, count, idx, vals, x, part, y, counters, ntot, g, plan_len, w, batch, ldx, n, v);
  }
}

}  // namespace tps

// plan: (plan_len,) int32 group ids; count: (1,) int32 live positions.
// idx/vals: (nb, ntot, W, 128), ntot = (ng+1)*G, 16-byte aligned; vals_kind
// 0 = fp32, 1 = bf16. x: (batch, ldx) fp32, ldx <= ntot*128 (missing
// columns read as 0); part: (slices, batch, nb*128) fp32 scratch; y:
// (batch, n) fp32, n <= nb*128; counters: int32 arrival counters, at least
// nb x batch tiles, all 0 (every call leaves them at 0).
extern "C" int tps_awsp_spmm(const void* plan, const void* count, const void* idx,
                             const void* vals, int vals_kind, const void* x, void* part,
                             void* y, void* counters, int nb, int ntot, int g, int plan_len,
                             int w, int batch, int ldx, int slices, int n, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nb <= 0 || batch <= 0 || n <= 0) return (int)cudaGetLastError();
  if (slices <= 0 || g <= 0 || w < 0) return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* pl = static_cast<const int*>(plan);
  const auto* kk = static_cast<const int*>(count);
  const auto* ix = static_cast<const int8_t*>(idx);
  const auto* xx = static_cast<const float*>(x);
  auto* pp = static_cast<float*>(part);
  auto* yy = static_cast<float*>(y);
  auto* cc = static_cast<int*>(counters);
  int rc;
  switch (vals_kind) {
    case 0: rc = tps::awsp_spmm_t(pl, kk, ix, static_cast<const float*>(vals), xx, pp, yy, cc, nb, ntot, g, plan_len, w, batch, ldx, slices, n, device, st); break;
    case 1: rc = tps::awsp_spmm_t(pl, kk, ix, static_cast<const __nv_bfloat16*>(vals), xx, pp, yy, cc, nb, ntot, g, plan_len, w, batch, ldx, slices, n, device, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
