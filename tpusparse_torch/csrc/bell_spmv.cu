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
// zero and are never read (but for up to 3 that round a copy to 16 bytes).
// What sets the time in practice is the instructions a column costs, so the
// design spends them once a column, not once a column and batch row.
//
// Design: a 256-thread block owns half an output group (64 columns), up to
// 32 batch rows and a run of contraction blocks i (kernels/bell_spmv.py:
// bell_shape, two or three blocks an SM). The run's bitmap words and x
// windows are copied into shared memory first (cp.async); x is kept
// transposed, xT[l][b], a row of x_stride(bb) floats (odd 16-byte units),
// so a lane fetches 4 batch rows at one position with one 16-byte load.
// Warp w takes columns w, w + 8, ... of its half of each block i of the run
// in turn, and streams their live values through its own ring of 3 column
// buffers: cp.async copies of the column two ahead (the count, popc of the
// column's words, says how many 16-byte pieces to copy) are in flight while
// the current column is used. For each column:
// - decode, once for the whole batch: position l sits in word l % nwords at
//   bit l / nwords (the TPU layout, kept so packs compare); 32 positions a
//   step, __ballot_sync gives the live ones and popc of the ballot below a
//   lane its rank, and the warp writes the sorted list of live positions
//   (uint16, as offsets of their rows of xT) to shared memory;
// - multiply: at 1 or 2 rows a lane takes 4 consecutive live values and
//   their positions with one vector load each; from 4 rows the Q = bb/V
//   lanes of a live value take its batch rows, V = min(bb, 8) each, and the
//   warp walks 32/Q consecutive live values a step, so a quarter warp reads
//   x at nearby positions;
// - a transposing butterfly over the lanes that share rows (V values a
//   lane, halved each step) leaves row Vq + r's sum in lane (32/V) r + q,
//   which adds it to the block's sums (one owner a column, in order of i).
// Then the block's sums are the slice's partial sums, and the last block of
// each half group adds the slices in a fixed order (split_reduce.cuh): one
// launch a call, deterministic (it measured 0.5-1.2 us faster on an H100
// than sell_common.cuh's reduce pass: PERF.md).
#include "async_copy.cuh"
#include "sell_common.cuh"
#include "split_reduce.cuh"

namespace tps {

constexpr int kBellWarps = 8;
constexpr int kBellThreads = 32 * kBellWarps;
constexpr int kBellRing = 3;                   // column buffers a warp
constexpr int kBellCols = 64;                  // columns a block
constexpr int kBellColsPerWarp = kBellCols / kBellWarps;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int bell_x_stride(int bb) {
  return bb <= 2 ? bb : ((bb / 4) % 2 == 1 ? bb : bb + 4);
}

// Byte offsets of the shared-memory regions (the wrapper's bell_smem_bytes):
// words, x, the warps' rings, the warps' lists, then the block's sums; the
// first four (or bb*64 floats, if more) are the tail's scratch at the end.
struct BellSmem {
  size_t x, ring, list, red, total;
  __host__ __device__ BellSmem(int block_m, int w, int bb, int per) {
    x = (size_t)per * kBellCols * (block_m / 32) * 4;
    ring = x + (size_t)per * block_m * bell_x_stride(bb) * 4;
    list = ring + (size_t)kBellWarps * kBellRing * w * 4;
    red = list + (size_t)kBellWarps * (block_m + 4) * 2;
    const size_t tail = (size_t)bb * kBellCols * 4;
    if (red < tail) red = tail;
    total = red + (size_t)bb * kBellCols * 4;
  }
};

template <int V>
__device__ __forceinline__ void load_xv(const float* row, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = row[0];
  } else if constexpr (V == 2) {
    const float2 q = *reinterpret_cast<const float2*>(row);
    v[0] = q.x; v[1] = q.y;
  } else {
#pragma unroll
    for (int u = 0; u < V / 4; ++u) {
      const float4 q = reinterpret_cast<const float4*>(row)[u];
      v[4 * u] = q.x; v[4 * u + 1] = q.y; v[4 * u + 2] = q.z; v[4 * u + 3] = q.w;
    }
  }
}

// The sums of V values a lane over the lanes that share lane % nq (nq <= 32
// / V): each of the first log2(V) steps (offsets 16, 8, ...) halves the
// values a lane holds, sending the half it gives up to its partner; then a
// plain butterfly down to offset nq. Returns the total of value lane / (32
// / V) of the lanes with this lane % nq. A fixed tree: the same bits every
// call.
template <int V>
__device__ __forceinline__ float transpose_sum(float (&v)[V], int lane, int nq) {
  int off = 16;
#pragma unroll
  for (int h = V / 2; h >= 1; h /= 2, off /= 2) {
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = upper ? v[i] : v[i + h];
      const float keep = upper ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, off);
    }
  }
  float s = v[0];
  for (int o = 16 / V; o >= nq; o /= 2) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

template <int V>
__global__ void __launch_bounds__(kBellThreads, 3)
bell_kernel(const uint32_t* __restrict__ bitmap, const float* __restrict__ vals,
            const float* __restrict__ x, float* __restrict__ part, float* __restrict__ y,
            int* __restrict__ counters, int mb, int block_m, int w, int batch, int ldx,
            int n, int per_slice, int bb) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BellSmem lay(block_m, w, bb, per_slice);
  const int nwords = block_m >> 5;
  const int xs_ld = bell_x_stride(bb);
  auto* words = reinterpret_cast<uint32_t*>(smem);                 // [per][64][nwords]
  auto* xs = reinterpret_cast<float*>(smem + lay.x);               // [per][block_m][xs_ld]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* ring = reinterpret_cast<float*>(smem + lay.ring) + warp * kBellRing * w;
  auto* list = reinterpret_cast<uint16_t*>(smem + lay.list) + warp * (block_m + 4);
  auto* red = reinterpret_cast<float*>(smem + lay.red);            // [bb][64]
  const int j = blockIdx.x >> 1, c0 = (blockIdx.x & 1) * kBellCols;
  const int slice = blockIdx.y, b0 = blockIdx.z * bb;
  const int i0 = slice * per_slice, count = max(0, min(mb, i0 + per_slice) - i0);
  const int rows = min(bb, batch - b0);
  const size_t tile0 = (size_t)j * mb + i0;                        // (j, i0) tile

  // The run's words of the block's 64 columns and its x windows, transposed.
  const int chunks = kBellCols * nwords / 4;                        // 16-byte pieces a block
  for (int q = threadIdx.x; q < count * chunks; q += kBellThreads) {
    const int ii = q / chunks, u = q % chunks;
    copy_async<16>(words + 4 * q,
                   bitmap + ((tile0 + ii) * kLanes + c0) * nwords + 4 * u, true);
  }
  copy_commit();
  const int span = count * block_m;
  for (int q = threadIdx.x; q < bb * span; q += kBellThreads) {
    // up to 2 rows, consecutive threads copy consecutive positions; from 4,
    // consecutive batch rows (rows of xs_ld floats: few shared writes a bank)
    const int b = bb <= 2 ? q / span : q % bb, l = bb <= 2 ? q % span : q / bb;
    const int col = i0 * block_m + l;
    const bool ok = b < rows && col < ldx;
    copy_async<4>(xs + (size_t)l * xs_ld + b, ok ? x + (size_t)(b0 + b) * ldx + col : x, ok);
  }
  copy_commit();
  for (int q = threadIdx.x; q < bb * kBellCols; q += kBellThreads) red[q] = 0.f;
  copy_wait<1>();      // this thread's words
  __syncthreads();     // everyone's words

  const int items = count * kBellColsPerWarp;   // (block, column) pairs of the warp
  auto column = [&](int q, int& ii, int& c) {
    ii = q / kBellColsPerWarp;
    c = warp + kBellWarps * (q % kBellColsPerWarp);
  };
  auto live_count = [&](int ii, int c) {
    const uint32_t* cw = words + ((size_t)ii * kBellCols + c) * nwords;
    return __reduce_add_sync(kFull, lane < nwords ? __popc(cw[lane]) : 0);
  };
  auto issue = [&](int q) {   // the live values of item q into buffer q % kBellRing
    if (q < items) {
      int ii, c;
      column(q, ii, c);
      const int pieces = (live_count(ii, c) + 3) >> 2;
      const float* src = vals + ((tile0 + ii) * kLanes + c0 + c) * (size_t)w;
      float* dst = ring + (q % kBellRing) * w;
      for (int u = lane; u < pieces; u += 32) copy_async<16>(dst + 4 * u, src + 4 * u, true);
    }
    copy_commit();            // every lane, every item: the groups stay in step
  };
  for (int q = 0; q < kBellRing - 1; ++q) issue(q);
  copy_wait<kBellRing - 1>();   // this thread's x (older than the ring's groups)
  __syncthreads();              // everyone's x

  const unsigned below = (1u << lane) - 1u;
  const bool fixed_word = (32 % nwords) == 0;   // a lane's word is the same every step
  const int nq = V >= 4 ? bb / V : 1;           // lanes a live value (its batch V-tuples)
  const int bq = lane % nq, kk = lane / nq, kstep = 32 / nq;
  const int row = bq * V + lane / (32 / V);     // the row whose sum this lane ends with
  const bool writer = (lane & (32 / V - 1)) == bq && row < rows;
  for (int q = 0; q < items; ++q) {
    issue(q + kBellRing - 1);
    copy_wait<kBellRing - 1>();   // this lane's copies of item q
    __syncwarp();                 // ... and every lane's
    int ii, c;
    column(q, ii, c);
    const uint32_t* cw = words + ((size_t)ii * kBellCols + c) * nwords;

    // Decode: the sorted list of live positions, each as the offset of its
    // row of xT (l * xs_ld < 2^16: l < 1024, xs_ld <= 36).
    int cnt = 0;
    if (fixed_word) {
      const uint32_t mine = cw[lane % nwords];
      const int d_bit = 32 / nwords;
      int bit = lane / nwords;
#pragma unroll 16
      for (int l0 = 0; l0 < block_m; l0 += 32, bit += d_bit) {
        const bool on = (mine >> bit) & 1u;
        const unsigned ballot = __ballot_sync(kFull, on);
        if (on) list[cnt + __popc(ballot & below)] = (uint16_t)((l0 + lane) * xs_ld);
        cnt += __popc(ballot);
      }
    } else {
      const int d_word = 32 % nwords, d_bit = 32 / nwords;
      int wi = lane % nwords, bit = lane / nwords;
      for (int l0 = 0; l0 < block_m; l0 += 32) {
        const bool on = (cw[wi] >> bit) & 1u;
        const unsigned ballot = __ballot_sync(kFull, on);
        if (on) list[cnt + __popc(ballot & below)] = (uint16_t)((l0 + lane) * xs_ld);
        cnt += __popc(ballot);
        wi += d_word;
        bit += d_bit;
        if (wi >= nwords) { wi -= nwords; ++bit; }
      }
    }
    __syncwarp();

    // Multiply: each live value once, for all of the block's batch rows.
    const float* vr = ring + (q % kBellRing) * w;
    const float* xw = xs + (size_t)ii * block_m * xs_ld + bq * V;
    float acc[V];
#pragma unroll
    for (int b = 0; b < V; ++b) acc[b] = 0.f;
    if constexpr (V <= 2) {
      // 1 or 2 rows: lane k4 takes live values 4*k4 .. 4*k4+3, 4 values and
      // their positions with one vector load each (pads: value 0 at l 0)
      if (lane < ((cnt + 3) & ~3) - cnt) list[cnt + lane] = 0;
      __syncwarp();
      for (int k4 = lane; 4 * k4 < cnt; k4 += 32) {
        const float4 v = reinterpret_cast<const float4*>(vr)[k4];
        const ushort4 p = reinterpret_cast<const ushort4*>(list)[k4];
        const float vv[4] = {v.x, v.y, v.z, v.w};
        const int pp[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float xv[V];
          load_xv<V>(xw + pp[e], xv);
#pragma unroll
          for (int b = 0; b < V; ++b) acc[b] = fmaf(vv[e], xv[b], acc[b]);
        }
      }
    } else {
      // 4 or 8 rows a lane: the nq lanes of a value take its batch rows, V
      // each, and the warp walks 32 / nq consecutive live values a step
#pragma unroll 4
      for (int k = kk; k < cnt; k += kstep) {
        const float v = vr[k];
        float xv[V];
        load_xv<V>(xw + list[k], xv);
#pragma unroll
        for (int b = 0; b < V; ++b) acc[b] = fmaf(v, xv[b], acc[b]);
      }
    }
    const float sum = transpose_sum<V>(acc, lane, nq);
    if (writer) red[row * kBellCols + c] += sum;
    __syncwarp();   // buffer q % kBellRing and the list are free
  }

  __syncthreads();
  const size_t np = (size_t)(gridDim.x >> 1) * kLanes;
  for (int q = threadIdx.x; q < rows * kBellCols; q += kBellThreads)
    part[((size_t)slice * batch + b0 + q / kBellCols) * np + (size_t)j * kLanes + c0 +
         q % kBellCols] = red[q];
  __syncthreads();   // the tail reuses the first regions as its scratch
  split_reduce_tail<2, true>(part, y, counters + blockIdx.z * gridDim.x + blockIdx.x,
                             gridDim.y, batch, np, n, b0, rows, j * kLanes + c0,
                             min(kBellCols, n - j * kLanes - c0),
                             reinterpret_cast<float*>(smem), (int)(lay.red / 4));
}

// The dynamic shared-memory limit raised once a kernel, device and process
// (a file-scope array: see sell_mxu_spmm.cu).
constexpr int kBellDevices = 64;
static int bell_smem_set[4][kBellDevices];

template <int V>
int bell_launch(const uint32_t* bitmap, const float* vals, const float* x, float* part,
                float* y, int* counters, int nb, int mb, int block_m, int w, int batch,
                int ldx, int slices, int per_slice, int n, int bb, int device,
                cudaStream_t st) {
  const size_t smem = BellSmem(block_m, w, bb, per_slice).total;
  constexpr int slot = V == 1 ? 0 : V == 2 ? 1 : V == 4 ? 2 : 3;
  int* have = device < kBellDevices ? &bell_smem_set[slot][device] : nullptr;
  if (have == nullptr || *have < (int)smem) {   // static shared memory counts too
    int lim = 0;
    cudaError_t err = cudaDeviceGetAttribute(&lim, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                             device);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;   // the block's static shared memory counts too
    err = cudaFuncGetAttributes(&attr, bell_kernel<V>);
    if (err != cudaSuccess) return (int)err;
    lim -= (int)attr.sharedSizeBytes;
    if (smem > (size_t)lim) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(bell_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, lim);
    if (err != cudaSuccess) return (int)err;
    if (have != nullptr) *have = lim;
  }
  const dim3 grid(2 * nb, slices, (batch + bb - 1) / bb);
  bell_kernel<V><<<grid, kBellThreads, smem, st>>>(bitmap, vals, x, part, y, counters, mb,
                                                   block_m, w, batch, ldx, n, per_slice, bb);
  return 0;
}

}  // namespace tps

// bitmap: (nb, mb, 128, block_m/32) uint32 bits; vals: (nb, mb, 128, w) fp32,
// both 16-byte aligned, w a multiple of 4 and <= 1024; block_m a multiple of
// 32, <= 1024. x: (batch, ldx) fp32, ldx <= mb*block_m (missing columns read
// as 0); part: (slices, batch, nb*128) fp32 scratch; y: (batch, n) fp32;
// counters: 2 * nb * ceil(batch / bb) int32 (one per half group and batch
// block), all 0. A block holds bb
// batch rows (1, 2, 4, 8, 16 or 32) and a run of per_slice contraction
// blocks.
extern "C" int tps_bell_spmm(const void* bitmap, const void* vals, const void* x,
                             void* part, void* y, void* counters, int nb, int mb,
                             int block_m, int w, int batch, int ldx, int slices,
                             int per_slice, int n, int bb, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nb <= 0 || batch <= 0 || slices <= 0) return 0;
  if (bb < 1 || bb > 32 || (bb & (bb - 1)) || block_m % 32 || block_m > 1024 || w % 4 ||
      w > 1024)
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* bm = static_cast<const uint32_t*>(bitmap);
  const auto* vv = static_cast<const float*>(vals);
  const auto* xx = static_cast<const float*>(x);
  auto* pp = static_cast<float*>(part);
  auto* yy = static_cast<float*>(y);
  auto* cc = static_cast<int*>(counters);
  int rc;
  switch (bb) {
    case 1: rc = tps::bell_launch<1>(bm, vv, xx, pp, yy, cc, nb, mb, block_m, w, batch, ldx, slices, per_slice, n, bb, device, st); break;
    case 2: rc = tps::bell_launch<2>(bm, vv, xx, pp, yy, cc, nb, mb, block_m, w, batch, ldx, slices, per_slice, n, bb, device, st); break;
    case 4: rc = tps::bell_launch<4>(bm, vv, xx, pp, yy, cc, nb, mb, block_m, w, batch, ldx, slices, per_slice, n, bb, device, st); break;
    default: rc = tps::bell_launch<8>(bm, vv, xx, pp, yy, cc, nb, mb, block_m, w, batch, ldx, slices, per_slice, n, bb, device, st); break;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
