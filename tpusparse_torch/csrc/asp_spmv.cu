// Activation-sparse dense GEMV/GEMM ("ASP") for Hopper: y = x @ A over the
// 128-row windows of a plan only,
//   y[b, c] = sum_{p < k} sum_{u < 128} x[b, plan[p]*128 + u] * A[plan[p]*128 + u, c].
//
// Replaces the TPU kernel tpusparse/kernels/asp_spmv.py:_asp_kernel (through
// _asp_pallas, for both the static plan and the device plan). Its split-bf16
// dot3 was a TPU workaround for the MXU; every product here is one FP32 FFMA.
//
// Bound: bytes. The live windows of A are read once (4 * 128 * n bytes a
// window) for 2 * B * 128 * n flops a window: at B <= 8, at most 4 flops a
// byte, far below the card's balance. The 8192^2 A at B = 8 with every
// window live reads 268 MB, 80 us at 3.35 TB/s.
//
// Design: one launch a call, no partial sums in device memory.
// - A strip of 128 output columns and a batch tile belongs to a thread-block
//   cluster of C = 1, 2, 4 or 8 blocks (the wrapper's asp_shape picks the
//   largest C for which strips x tiles x C blocks fit the card one block an
//   SM: more blocks an SM, each streaming its own rows, measured slower on
//   an H100). The k live windows give k * 128 "plan rows"; the cluster's
//   rank r takes the r-th of C equal runs of them, in stages of kAspRows
//   rows, reading k from device memory (a device plan needs no host sync).
// - A's rows stream through a ring of kAspStages shared-memory stages, each
//   filled by one 2D tensor copy (TMA: a tensor map over A, built by the C
//   entry, box kAspRows rows x 128 columns; columns past lda arrive as
//   zeros) that completes on the stage's mbarrier, kAspStages-1 stages
//   ahead of the multiply (32 1D bulk copies a stage, one a row, measured
//   1.07-1.17 x slower on an H100: PERF.md). Each stage carries the x values
//   of its rows (cp.async, zero past the batch or x's width). Where the
//   tensor map cannot be built (lda % 4 != 0 or A not 16-byte aligned)
//   every thread copies A's elements with 4-byte cp.async instead, in the
//   same kernel. One __syncthreads a stage frees the previous stage.
// - Lane q of each warp owns columns 4q .. 4q+3 of the strip; warp w
//   multiplies rows kRowsW*w .. kRowsW*(w+1)-1 of a stage.
// - At the end the warps' sums are added in warp order in shared memory,
//   and then across the cluster through distributed shared memory: rank r
//   adds the sums of ranks 0 .. C-1, in rank order, for its 1/C of the
//   strip's outputs, and writes them (deterministic, no atomics, no second
//   pass). A second cluster barrier keeps every rank's shared memory alive
//   until all have read it.
// A has one extra all-zero window (id nt) that an all-zero X's plan points
// at, so y = 0 there.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>

#include "async_copy.cuh"
#include "sell_common.cuh"

namespace tps {

namespace cg = cooperative_groups;

constexpr int kAspRows = 32;       // rows a ring stage: 16 KB of A, one tensor copy
constexpr int kAspStages = 4;      // stages in the ring, kAspStages-1 in flight
constexpr int kAspHeader = 128;    // the stages' mbarriers
constexpr int kAspMaxCluster = 8;  // portable cluster sizes: 1, 2, 4, 8
constexpr int kRowsW = kAspRows / kWarps;   // rows of a stage a warp multiplies
static_assert(kLanes % kAspRows == 0, "a stage lies inside one window");
static_assert(kRowsW % 4 == 0, "a warp reads its rows' x as float4s");

template <int BT>
struct AspStage {
  float a[kAspRows][kLanes];
  float x[BT][kAspRows];
};

// Shared memory of a block: the mbarriers and the ring; after the ring, the
// warps' sums and the block's sum.
template <int BT>
constexpr int kAspSmem = kAspHeader + kAspStages * (int)sizeof(AspStage<BT>);
template <int BT>
constexpr int kAspSums = (kWarps + 1) * BT * kLanes * (int)sizeof(float);

// One 2D tensor copy: the box at (column c, row r) of the map's tensor into
// shared dst (128-byte aligned), completing on bar.
__device__ __forceinline__ void tensor_copy_2d(void* dst, const CUtensorMap* map, int c, int r,
                                               uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(smem_u32(bar))
      : "memory");
}

template <int BT, bool kTensor>
__global__ void __launch_bounds__(kThreads)
asp_cluster_kernel(const __grid_constant__ CUtensorMap map, const int* __restrict__ plan,
                   const int* __restrict__ count, const float* __restrict__ a,
                   const float* __restrict__ x, float* __restrict__ y, int lda, int n,
                   int batch, int ldx, int plan_len) {
  extern __shared__ __align__(128) unsigned char smem[];
  auto* bars = reinterpret_cast<uint64_t*>(smem);
  auto* ring = reinterpret_cast<AspStage<BT>*>(smem + kAspHeader);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), csize = (int)cluster.num_blocks();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.y * kLanes, b0 = blockIdx.z * BT;
  // the live plan rows in stages: this rank's run of them
  const int all = max(0, min(*count, plan_len)) * (kLanes / kAspRows);
  const int per = (all + csize - 1) / csize;
  const int first = rank * per, stages = max(0, min(all, first + per) - first);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kAspStages; ++s) bar_init(&bars[s]);
    bar_init_fence();
  }
  __syncthreads();

  // Issue the copies of this rank's stage g into ring[g % kAspStages].
  auto issue = [&](int g) {
    AspStage<BT>& st = ring[g % kAspStages];
    const int pr = (first + g) * kAspRows;                      // plan row
    const int row = plan[pr / kLanes] * kLanes + pr % kLanes;   // A's (and x's) first row
    if (kTensor) {
      if (threadIdx.x == 0) {
        bar_expect(&bars[g % kAspStages], (unsigned)sizeof(st.a));
        tensor_copy_2d(&st.a[0][0], &map, c0, row, &bars[g % kAspStages]);
      }
    } else {
      for (int q = threadIdx.x; q < kAspRows * kLanes; q += kThreads) {
        const int u = q / kLanes, c = q % kLanes;
        const bool ok = c0 + c < n;
        copy_async<4>(&st.a[u][c], ok ? a + (size_t)(row + u) * lda + c0 + c : a, ok);
      }
    }
    for (int q = threadIdx.x; q < BT * kAspRows; q += kThreads) {
      const int b = q / kAspRows, u = q % kAspRows;
      const bool ok = b0 + b < batch && row + u < ldx;
      copy_async<4>(&st.x[b][u], ok ? x + (size_t)(b0 + b) * ldx + row + u : x, ok);
    }
  };

  float acc[BT][kCols];   // rows b0 + b, columns c0 + 4 * lane .. + 3
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[b][c] = 0.f;

#pragma unroll
  for (int g = 0; g < kAspStages - 1; ++g) {
    if (g < stages) issue(g);
    copy_commit();
  }
  for (int g = 0; g < stages; ++g) {
    copy_wait<kAspStages - 2>();   // this thread's copies of stage g landed
    if (kTensor) bar_wait(&bars[g % kAspStages], (g / kAspStages) & 1);   // and A's rows
    __syncthreads();               // everyone's, and stage g-1 is free again
    const int ahead = g + kAspStages - 1;
    if (ahead < stages) issue(ahead);
    copy_commit();
    const AspStage<BT>& st = ring[g % kAspStages];
#pragma unroll
    for (int u4 = 0; u4 < kRowsW / 4; ++u4) {
      float4 xv[BT];   // x of 4 of this warp's rows
#pragma unroll
      for (int b = 0; b < BT; ++b)
        xv[b] = reinterpret_cast<const float4*>(st.x[b])[kRowsW / 4 * warp + u4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 av =
            reinterpret_cast<const float4*>(st.a[kRowsW * warp + 4 * u4 + e])[lane];
        const float v[kCols] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          const float xb = e == 0 ? xv[b].x : e == 1 ? xv[b].y : e == 2 ? xv[b].z : xv[b].w;
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[b][c] = fmaf(v[c], xb, acc[b][c]);
        }
      }
    }
  }
  copy_wait<0>();
  __syncthreads();   // the ring is free: it holds the warps' sums, then the block's

  float* red = reinterpret_cast<float*>(smem + kAspHeader);   // [kWarps][BT][128]
  float* sum = red + kWarps * BT * kLanes;                     // [BT][128]
#pragma unroll
  for (int b = 0; b < BT; ++b)
    reinterpret_cast<float4*>(red + (warp * BT + b) * kLanes)[lane] =
        make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
  __syncthreads();
  for (int q = threadIdx.x; q < BT * kLanes; q += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * BT * kLanes + q];
    sum[q] = s;
  }
  cluster.sync();   // every rank's sum is in its shared memory
  const int outs = BT * kLanes / csize;   // this rank's outputs: a 1/C slice
  for (int q = rank * outs + threadIdx.x; q < (rank + 1) * outs; q += kThreads) {
    float s = 0.f;
    for (int p = 0; p < csize; ++p) s += cluster.map_shared_rank(sum, p)[q];
    const int b = q / kLanes, c = q % kLanes;
    if (b0 + b < batch && c0 + c < n) y[(size_t)(b0 + b) * n + c0 + c] = s;
  }
  cluster.sync();   // no rank leaves while another reads its shared memory
}

// The dynamic shared-memory limit raised for each kernel, once a device and
// process (a file-scope array: a static inside the template would be one
// symbol across every library holding the same template).
constexpr int kAspDevices = 16;
static bool asp_smem_set[4][2][kAspDevices];

// cuTensorMapEncodeTiled, looked up once a process through the runtime's
// entry-point query (no link to libcuda).
static PFN_cuTensorMapEncodeTiled_v12000 asp_encode = nullptr;

// The tensor map of A (rows, lda) fp32 with boxes of kAspRows rows x 128
// columns (lda % 4 == 0, A 16-byte aligned).
static int asp_tensor_map(CUtensorMap* map, const float* a, int rows, int lda) {
  if (asp_encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return (int)cudaErrorNotSupported;
    asp_encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)lda, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)lda * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)kLanes, (cuuint32_t)kAspRows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = asp_encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(a),
                                dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int BT, bool kTensor>
int launch_asp(dim3 grid, int cluster, int device, cudaStream_t st, const CUtensorMap& map,
               const int* plan, const int* count, const float* a, const float* x, float* y,
               int lda, int n, int batch, int ldx, int plan_len) {
  constexpr int smem = kAspSmem<BT>;
  static_assert(smem >= kAspHeader + kAspSums<BT>, "the ring holds the sums");
  auto kern = asp_cluster_kernel<BT, kTensor>;
  bool* set = device < kAspDevices
                  ? &asp_smem_set[BT == 1 ? 0 : BT == 2 ? 1 : BT == 4 ? 2 : 3][kTensor][device]
                  : nullptr;
  if (set == nullptr || !*set) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (set != nullptr) *set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, map, plan, count, a, x, y, lda, n, batch, ldx,
                                 plan_len);
}

template <int BT>
int launch_asp_bt(bool tensor, dim3 grid, int cluster, int device, cudaStream_t st,
                  const CUtensorMap& map, const int* plan, const int* count, const float* a,
                  const float* x, float* y, int lda, int n, int batch, int ldx, int plan_len) {
  return tensor ? launch_asp<BT, true>(grid, cluster, device, st, map, plan, count, a, x, y, lda,
                                     n, batch, ldx, plan_len)
                : launch_asp<BT, false>(grid, cluster, device, st, map, plan, count, a, x, y,
                                        lda, n, batch, ldx, plan_len);
}

}  // namespace tps

// plan: (plan_len,) int32 window ids; count: (1,) int32 live positions;
// a: (rows, lda) fp32 with the zero window last, n <= lda real columns;
// x: (batch, ldx) fp32 (missing columns read as 0); y: (batch, n) fp32;
// cluster: blocks a strip's cluster, 1, 2, 4 or 8 (kernels/asp_spmv.py:
// asp_shape).
extern "C" int tps_asp_spmm(const void* plan, const void* count, const void* a,
                            const void* x, void* y, int rows, int lda, int n, int batch,
                            int ldx, int plan_len, int cluster, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (cluster < 1 || cluster > tps::kAspMaxCluster || (cluster & (cluster - 1)))
    return (int)cudaErrorInvalidValue;
  if (n <= 0 || batch <= 0) return (int)cudaGetLastError();
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* pl = static_cast<const int*>(plan);
  const auto* kk = static_cast<const int*>(count);
  const auto* aa = static_cast<const float*>(a);
  const auto* xx = static_cast<const float*>(x);
  auto* yy = static_cast<float*>(y);
  const int bt = tps::batch_tile(batch);
  const bool tensor = lda % tps::kCols == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  CUtensorMap map = {};
  if (tensor) {
    const int rc = tps::asp_tensor_map(&map, aa, rows, lda);
    if (rc != 0) return rc;
  }
  const dim3 grid(cluster, (n + tps::kLanes - 1) / tps::kLanes, (batch + bt - 1) / bt);
  int rc;
  switch (bt) {
    case 1: rc = tps::launch_asp_bt<1>(tensor, grid, cluster, device, st, map, pl, kk, aa, xx, yy, lda, n, batch, ldx, plan_len); break;
    case 2: rc = tps::launch_asp_bt<2>(tensor, grid, cluster, device, st, map, pl, kk, aa, xx, yy, lda, n, batch, ldx, plan_len); break;
    case 4: rc = tps::launch_asp_bt<4>(tensor, grid, cluster, device, st, map, pl, kk, aa, xx, yy, lda, n, batch, ldx, plan_len); break;
    default: rc = tps::launch_asp_bt<8>(tensor, grid, cluster, device, st, map, pl, kk, aa, xx, yy, lda, n, batch, ldx, plan_len); break;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
