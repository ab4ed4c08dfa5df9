// Vector-quantization assignment and EMA statistics for Hopper (sm_90a).
//
// Replaces the three TPU kernels of faceoff_tpu/ops/vq_pallas.py:
//   _vq_kernel            (K <= 2048, one pass: scores, argmax, quant,
//                          counts and sums carried across the TPU grid),
//   _assign_kernel_tiled  (K > 2048: running argmax over K tiles),
//   _stats_kernel_tiled   (K > 2048: counts and sums one K tile at a time).
// Two kernels here serve every K:
//
//   vq_assign_kernel   scores = x . e_k - 0.5 ||e_k||^2, idx = argmax with
//                      the lowest index winning ties, quant = E[:, idx]^T.
//   vq_stats_kernel    counts[k] = #rows with idx k, sums[:, k] = sum of
//                      those rows, over rows < N only.
//
// What bounds them. At the flagship bottom quantizer (N = 524288 rows,
// D = 64, K = 512) the assignment is 2 N D K = 34.4 GFLOP of float32 FMA,
// 0.51 ms at the card's 67 TFLOP/s outside the tensor cores, against
// 270 MB of traffic (x in, quant out, idx out), 0.08 ms at 3.35 TB/s: the
// arithmetic bounds it. The statistics are N D adds over 134 MB of x:
// bytes bound them.
//
// Design. The TPU kernels lean on the sequential grid: the statistics are
// one output block that every grid step adds into. On Hopper the blocks
// run in parallel, so nothing carries from one block to the next; each
// kernel is its own pass.
//
// The assignment gives each thread one row. A block stages its 128 rows
// in shared memory, transposed and padded so that both the staging stores
// and the per-thread reads are free of bank conflicts, then streams the
// codebook through shared memory in tiles of 128 codes (32 KB at D = 64),
// computing each tile's half squared norms once. Inside a tile a thread
// keeps 32 scores in registers: for every d it reads its x_d once and the
// 32 codes' d-th components as eight float4 broadcasts, so there is one
// shared load for every four FMAs. The running argmax takes codes in
// ascending order with a strict '>', so the earliest code wins a tie, as
// in the TPU kernels. Padded codes of the last tile score -inf. The
// arithmetic is plain float32 FMA: TF32 or bf16 tensor cores would change
// which code wins. quant is written by the whole block, row after row,
// so the stores coalesce; the codebook reads hit L2.
//
// The statistics kernel gives each block one K tile of codes (all K when
// K (D + 1) floats fit in shared memory, as at K = 512, D = 64: 133 KB)
// and a contiguous run of rows; each warp walks a sub-run, one row per
// step with its lanes over d, and keeps the sum of the current code in
// registers until the code changes. Neighbouring pixels mostly share a
// code, and with random weights a few codes take most rows, so this run
// accumulation is what keeps contention off the shared-memory atomics.
// At the end the block adds its nonzero codes into the global outputs
// with atomics. Rows are read once per K tile: once at the flagship K.
// Float sums are added in an order that changes from run to run; counts
// are integers, exact below 2^24.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRows = 128;          // rows per assignment block (= threads)
constexpr int kRowStride = kRows + 1;
constexpr int kTileK = 128;         // codes per shared-memory tile
constexpr int kChunk = 32;          // scores a thread keeps in registers
constexpr int kStatsThreads = 1024;
constexpr int kMaxLaneSlots = 8;    // D <= 32 * kMaxLaneSlots in the stats
static_assert(kTileK == kRows, "one thread computes each code's norm");
static_assert(kTileK % kChunk == 0 && kChunk % 4 == 0, "float4 chunks");

__global__ void __launch_bounds__(kRows)
vq_assign_kernel(const float* __restrict__ x, const float* __restrict__ embed,
                 int* __restrict__ idx_out, float* __restrict__ quant,
                 int n, int d, int k) {
  // the codebook tile comes first so that its float4 reads are aligned
  extern __shared__ __align__(16) float smem[];
  float* se = smem;                          // [d][kTileK]
  float* shn = se + d * kTileK;              // [kTileK]
  float* sx = shn + kTileK;                  // [d][kRowStride]
  int* sidx = reinterpret_cast<int*>(sx + d * kRowStride);  // [kRows]

  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;

  for (int i = tid; i < kRows * d; i += kRows) {
    const int r = i / d;
    const int c = i - r * d;
    const long long row = row0 + r;
    sx[c * kRowStride + r] = row < n ? x[row * d + c] : 0.0f;
  }

  float best = -CUDART_INF_F;
  int best_idx = 0;
  for (int k0 = 0; k0 < k; k0 += kTileK) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < d * kTileK; i += kRows) {
      const int c = i / kTileK;
      const int kk = i - c * kTileK;
      se[i] = (k0 + kk < k) ? embed[static_cast<long long>(c) * k + k0 + kk]
                            : 0.0f;
    }
    __syncthreads();
    {
      float s = 0.0f;
      for (int c = 0; c < d; ++c) {
        const float v = se[c * kTileK + tid];
        s = fmaf(v, v, s);
      }
      shn[tid] = (k0 + tid < k) ? 0.5f * s : CUDART_INF_F;
    }
    __syncthreads();

    for (int c0 = 0; c0 < kTileK; c0 += kChunk) {
      float acc[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) acc[j] = 0.0f;
#pragma unroll 4
      for (int c = 0; c < d; ++c) {
        const float xv = sx[c * kRowStride + tid];
        const float4* e4 =
            reinterpret_cast<const float4*>(se + c * kTileK + c0);
#pragma unroll
        for (int j = 0; j < kChunk / 4; ++j) {
          const float4 e = e4[j];
          acc[4 * j + 0] = fmaf(xv, e.x, acc[4 * j + 0]);
          acc[4 * j + 1] = fmaf(xv, e.y, acc[4 * j + 1]);
          acc[4 * j + 2] = fmaf(xv, e.z, acc[4 * j + 2]);
          acc[4 * j + 3] = fmaf(xv, e.w, acc[4 * j + 3]);
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float s = acc[j] - shn[c0 + j];
        if (s > best) {
          best = s;
          best_idx = k0 + c0 + j;
        }
      }
    }
  }

  sidx[tid] = best_idx;
  if (row0 + tid < n) idx_out[row0 + tid] = best_idx;
  __syncthreads();
  for (int i = tid; i < kRows * d; i += kRows) {
    const int r = i / d;
    const int c = i - r * d;
    const long long row = row0 + r;
    if (row < n) {
      quant[row * d + c] = embed[static_cast<long long>(c) * k + sidx[r]];
    }
  }
}

// Adds a warp's run of rows of one code into the block's shared sums.
__device__ __forceinline__ void flush_run(float* ssum, unsigned* scnt,
                                          int code, int d, int lane,
                                          float (&acc)[kMaxLaneSlots],
                                          unsigned& cnt) {
  if (code < 0) return;
#pragma unroll
  for (int j = 0; j < kMaxLaneSlots; ++j) {
    const int c = lane + 32 * j;
    if (c < d) atomicAdd(&ssum[code * (d + 1) + c], acc[j]);
    acc[j] = 0.0f;
  }
  if (lane == 0) atomicAdd(&scnt[code], cnt);
  cnt = 0;
}

__global__ void __launch_bounds__(kStatsThreads)
vq_stats_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                float* __restrict__ counts, float* __restrict__ sums,
                int n, int d, int k, int tile_k, int rows_per_block) {
  extern __shared__ __align__(16) float smem[];
  float* ssum = smem;                                      // [tile_k][d + 1]
  unsigned* scnt = reinterpret_cast<unsigned*>(ssum + tile_k * (d + 1));

  const int k0 = blockIdx.y * tile_k;
  const int tk = min(tile_k, k - k0);
  for (int i = threadIdx.x; i < tile_k * (d + 1); i += blockDim.x) {
    ssum[i] = 0.0f;
  }
  for (int i = threadIdx.x; i < tile_k; i += blockDim.x) scnt[i] = 0u;
  __syncthreads();

  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(static_cast<long long>(n), r0 + rows_per_block);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const long long span = r1 > r0 ? r1 - r0 : 0;
  const long long per_warp = (span + warps - 1) / warps;
  const long long w0 = r0 + warp * per_warp;
  const long long w1 = min(r1, w0 + per_warp);

  float acc[kMaxLaneSlots];
#pragma unroll
  for (int j = 0; j < kMaxLaneSlots; ++j) acc[j] = 0.0f;
  unsigned cnt = 0;
  int cur = -1;
  for (long long base = w0; base < w1; base += 32) {
    // one coalesced load of the next 32 codes, then a broadcast per row
    const long long mine = base + lane;
    const int my_code = mine < w1 ? idx[mine] - k0 : -1;
    const int steps = static_cast<int>(min(32LL, w1 - base));
    for (int t = 0; t < steps; ++t) {
      const int code = __shfl_sync(0xffffffffu, my_code, t);
      if (code < 0 || code >= tk) continue;
      if (code != cur) {
        flush_run(ssum, scnt, cur, d, lane, acc, cnt);
        cur = code;
      }
      const float* xr = x + (base + t) * d;
#pragma unroll
      for (int j = 0; j < kMaxLaneSlots; ++j) {
        const int c = lane + 32 * j;
        if (c < d) acc[j] += xr[c];
      }
      ++cnt;
    }
  }
  flush_run(ssum, scnt, cur, d, lane, acc, cnt);
  __syncthreads();

  for (int i = threadIdx.x; i < tk; i += blockDim.x) {
    if (scnt[i]) atomicAdd(&counts[k0 + i], static_cast<float>(scnt[i]));
  }
  for (int i = threadIdx.x; i < tk * d; i += blockDim.x) {
    const int c = i / tk;
    const int kk = i - c * tk;
    if (scnt[kk]) {
      atomicAdd(&sums[static_cast<long long>(c) * k + k0 + kk],
                ssum[kk * (d + 1) + c]);
    }
  }
}

}  // namespace

// Shared-memory bytes of an assignment block for width d.
static long long assign_smem_bytes(int d) {
  return static_cast<long long>(sizeof(float)) *
             (static_cast<long long>(d) * (kRowStride + kTileK) + kTileK) +
         static_cast<long long>(sizeof(int)) * kRows;
}

// The largest statistics tile of codes for width d that fits in
// `smem_bytes` of shared memory (0 when not even one code fits).
static int stats_tile(int d, int k, long long smem_bytes) {
  const long long per_code =
      static_cast<long long>(sizeof(float)) * (d + 1) + sizeof(unsigned);
  long long t = smem_bytes / per_code;
  if (t > k) t = k;
  return static_cast<int>(t);
}

static int smem_optin_bytes() {
  int dev = 0;
  cudaGetDevice(&dev);
  int bytes = 0;
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return bytes;
}

// Launches the assignment on `stream` (a cudaStream_t passed as void*):
// x (n, d) and embed (d, k) float32, contiguous; writes idx (n,) int32 and
// quant (n, d). Returns cudaGetLastError() as an int, 0 when the launch
// was accepted; cudaErrorInvalidValue when d is too wide for the block's
// shared memory. The Python wrapper checks n >= 1, 1 <= d <= 224, k >= 1.
extern "C" int faceoff_vq_assign_rows(const float* x, const float* embed,
                                      int* idx, float* quant, int n, int d,
                                      int k, void* stream) {
  const long long smem = assign_smem_bytes(d);
  if (smem > smem_optin_bytes()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaFuncSetAttribute(vq_assign_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const int blocks = (n + kRows - 1) / kRows;
  vq_assign_kernel<<<blocks, kRows, smem, static_cast<cudaStream_t>(stream)>>>(
      x, embed, idx, quant, n, d, k);
  return static_cast<int>(cudaGetLastError());
}

// Launches the statistics on `stream`: x (n, d) float32 and idx (n,)
// int32 in [0, k); counts (k,) and sums (d, k) must be zero and are added
// into. Returns cudaGetLastError() as an int; cudaErrorInvalidValue when
// not one code fits in shared memory. The wrapper checks d <= 224.
extern "C" int faceoff_vq_stats(const float* x, const int* idx,
                                float* counts, float* sums, int n, int d,
                                int k, void* stream) {
  int dev = 0;
  cudaGetDevice(&dev);
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tile_k = stats_tile(d, k, smem_optin_bytes());
  if (tile_k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int k_tiles = (k + tile_k - 1) / tile_k;
  const long long smem = static_cast<long long>(tile_k) *
                         ((d + 1) * sizeof(float) + sizeof(unsigned));
  cudaFuncSetAttribute(vq_stats_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  // one block per SM per K tile, unless rows run out first
  int row_blocks = sms > 0 ? sms : 132;
  const int min_rows = kStatsThreads / 32 * 8;  // 8 rows a warp at least
  const int most = (n + min_rows - 1) / min_rows;
  if (row_blocks > most) row_blocks = most > 0 ? most : 1;
  const int rows_per_block = (n + row_blocks - 1) / row_blocks;
  const dim3 grid(row_blocks, k_tiles);
  vq_stats_kernel<<<grid, kStatsThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      x, idx, counts, sums, n, d, k, tile_k, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}
