// Vector-quantization assignment and EMA statistics for Hopper (sm_90a).
//
// Replaces the three TPU kernels of faceoff_tpu/ops/vq_pallas.py:
//   _vq_kernel            (K <= 2048, one pass: scores, argmax, quant,
//                          counts and sums carried across the TPU grid),
//   _assign_kernel_tiled  (K > 2048: running argmax over K tiles),
//   _stats_kernel_tiled   (K > 2048: counts and sums one K tile at a time).
// On Hopper the blocks run in parallel and nothing carries from one to the
// next, so the work splits into an assignment and a statistics pass, each
// serving every K:
//
//   assignment   idx = argmax_k (x . e_k - 0.5 ||e_k||^2), the lowest index
//                winning a tie; quant = E[:, idx]^T.
//   statistics   counts[k] = #rows with idx k, sums[:, k] = sum of those
//                rows, over rows < N only.
//
// Assignment: split operands on the tensor cores, then an exact re-score
// of near ties. At the flagship bottom quantizer (N = 524288, D = 64,
// K = 512) the scores are 2 N D K = 34.4 GFLOP: 0.51 ms of float32 FMA at
// the 67 TFLOP/s of the CUDA cores, against 0.08 ms for its bytes (x in,
// quant and idx out). The tensor cores do TF32 (10-bit mantissa) at
// 495 TFLOP/s and bf16 (7-bit) at 989; one TF32 product would pick
// another code than float32 wherever two scores lie within about 2^-11 of
// each other. So each operand is split, v = hi + lo with hi = rna(v) in
// TF32 (cvt.rna.tf32.f32) and lo = v - hi exactly, and the score is
//   x_hi . e_hi                         one m16n8k8 TF32 product, exact
//                                       products,
// + bf16(x_hi) . bf16(e_lo) + bf16(x_lo) . bf16(e_hi)
//                                       one m16n8k16 bf16 product of twice
//                                       the depth (the cross terms are
//                                       2^-11 of the score, so bf16's 2^-9
//                                       rounding costs 2^-19 of it),
// with float32 accumulators: 0.14 ms of tensor-core work at the flagship
// shape; operations bound it. What it drops ((x - x_hi)(e - e_hi) and the
// cross terms' bf16 rounding) is at most 17.1 2^-22 of sum |x_d e_d|; what
// the tensor core's accumulation may lose (its rounding is not promised)
// is taken as at most 32 (TF32 step) and 64 (bf16 step) ulps of the
// largest addend (`vq_cuda.MMA_ULPS_TF32`, `MMA_ULPS_BF16`). The wrapper
// turns that into a per-row bound
//   eps_row = c1(D) ||x||_2 max_k ||e_k||_2 + c2 max_k ||e_k||^2
// (`ops/vq_cuda.split_score_eps`; ||x||_2 max ||e_k||_2 >= sum |x_d e_d|),
// and a row whose best and second-best split scores lie more than
// 2 eps_row apart has the exact argmax. Every other row is flagged and
// re-scored over all K by the plain float32 FMA loop (ascending d, strict
// '>', lowest index wins a tie), the arithmetic the earlier CUDA-core
// kernel ran for every row; with random data under one row in a hundred is
// flagged.
//
//   vq_prep_kernel     per code, 0.5 ||e_k||^2 by float32 FMA in ascending d
//                      (+inf for the padding codes); E^T split into hi/lo
//                      (float32), code-major and zero-padded to (Kp, Dp) =
//                      (64-, 8-multiples); E^T (K, D) for the quant rows;
//                      and max ||e_k||^2 by an atomic max.
//   vq_assign_kernel   32 rows a warp (two m16 fragments), 16 warps a block
//                      up to D = 72 (so each codebook tile read from L2
//                      serves 512 rows), else 4;
//                      x staged once in shared memory (float32, split and
//                      rounded as the fragments load); E hi/lo streamed in
//                      tiles of 64 codes x 32 depths by cp.async, three
//                      stages. Within a k8 step the depths are permuted so
//                      that each fragment pair is one 8-byte shared load.
//                      Each thread keeps, for its 4 rows, the best and
//                      second-best score and the best index across K tiles;
//                      the quad of lanes that shares a row merges them with
//                      __shfl_xor_sync (the lower index wins a tie at every
//                      step). Writes idx and the coalesced quant rows, and
//                      appends flagged rows to a list.
//   vq_rescore_kernel  eight flagged rows and one slice of 1024 codes a
//                      block, exact float32 scores; slices meet in a 64-bit
//                      atomic max of (score, ~index) per row.
//   vq_rescore_finish_kernel  the flagged rows' idx and quant.
//
// Statistics: a stable counting sort by code, so x is read once at every
// K, and every sum is added in an order fixed by the inputs alone: equal
// inputs give bitwise equal counts and sums in every run (the EMA
// codebook, and so a resumed training run, does not depend on the order
// in which the card schedules warps). The sums are N D adds over N D 4
// bytes of x: bytes bound them (0.04 ms at the flagship shape).
//
//   stats_sort_kernel<true>   one warp per segment of about 512 rows (at
//                         most 1024 segments), up to 8 a block: per-warp
//                         counts of each code in shared memory, then each
//                         warp's prefix within its block and the block's
//                         counts.
//   stats_segscan_kernel  one warp per code: the exclusive scan of its
//                         blocks' counts, in block order.
//   stats_scan_kernel     one block: exclusive scans over K of the counts
//                         (code offsets) and of ceil(count / 128) (chunk
//                         offsets); writes the float counts.
//   stats_sort_kernel<false>  row ids into code order, each code's rows in
//                         ascending row order (a lane's rank among the
//                         lanes of its group holding its code, by
//                         __match_any_sync).
//   stats_segsum_kernel   one warp per chunk of at most 128 rows of one
//                         code: its row ids read once into shared memory;
//                         16-byte loads where D % 4 == 0, groups of lanes on
//                         different rows and eight rows a group in flight,
//                         sums in registers, written to the chunk's own
//                         partial sums.
//   stats_reduce_kernel   one thread per (code, d): the code's chunks'
//                         partial sums added in chunk order.
// Why the fixed order: with rows placed and chunk sums added by atomics,
// hot codes' sums changed in their last bits from run to run, and two
// training runs from one seed drifted apart (PERF.md). Counts are
// integers, exact below 2^24 rows a code.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// -- assignment -------------------------------------------------------------

constexpr int kTileN = 64;           // codes per tile: 8 n8 fragments
constexpr int kTileD = 32;           // depths per pipeline stage: 4 k8 steps
constexpr int kStages = 3;
constexpr int kSD = kTileD + 8;      // code row stride in a stage (floats)
constexpr int kStageFloats = 2 * kTileN * kSD;  // hi, then lo
constexpr int kHnBufs = 4;           // half-norm tiles in flight
constexpr int kNFrag = kTileN / 8;

// The k8 step's depths are permuted so that each lane's two depths are
// adjacent: fragment slot tig holds depth 2 tig, slot tig + 4 depth
// 2 tig + 1 (for A and B alike, so the product is unchanged), and one
// 8-byte shared load gives both. Row strides that are odd multiples of 8
// floats keep those loads free of bank conflicts.
__host__ __device__ constexpr int x_stride(int dp) {
  return (dp / 8) % 2 ? dp : dp + 8;
}

__device__ __forceinline__ float to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// m16n8k16 bf16 with float32 accumulators: A (16 x 16) and B (16 x 8) as
// bf16 pairs, the lower k in the low half.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even) in one register, `lo` in the
// low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Block of 32 codes x 8 depth lanes: E^T split into its TF32 head and the
// exact rest, code-major and zero-padded (Kp, Dp); E^T (K, D) for the
// quant rows; the half squared norms by float32 FMA in ascending d (+inf
// for the padding codes); and the largest squared norm.
__global__ void __launch_bounds__(256)
vq_prep_kernel(const float* __restrict__ embed, float* __restrict__ eh,
               float* __restrict__ el, float* __restrict__ et,
               float* __restrict__ hn, unsigned* __restrict__ emax2, int d,
               int dp, int k) {
  extern __shared__ float sv[];  // [dp][33]
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int j0 = blockIdx.x * 32;
  const int j = j0 + tx;
  for (int c = ty; c < dp; c += 8) {
    sv[c * 33 + tx] =
        (j < k && c < d) ? embed[static_cast<long long>(c) * k + j] : 0.0f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 32 * dp; i += blockDim.x) {
    const int jj = i / dp;
    const int c = i - jj * dp;
    const float v = sv[c * 33 + jj];
    const float h = to_tf32(v);
    const long long o = static_cast<long long>(j0 + jj) * dp + c;
    eh[o] = h;
    el[o] = v - h;  // exact
    if (j0 + jj < k && c < d) {
      et[static_cast<long long>(j0 + jj) * d + c] = v;
    }
  }
  if (ty == 0) {
    float s = 0.0f;
    for (int c = 0; c < d; ++c) {
      const float v = sv[c * 33 + tx];
      s = fmaf(v, v, s);
    }
    hn[j] = j < k ? 0.5f * s : CUDART_INF_F;
    if (j < k) atomicMax(emax2, __float_as_uint(s));
  }
}

struct Top2 {
  float best, second;
  int idx;
};

// Codes arrive in ascending order, so a strict '>' keeps the lowest index
// of equal scores. A NaN score leaves best alone and sets second to best,
// so its row goes to the re-score.
__device__ __forceinline__ void top2_take(Top2& t, float s, int j) {
  t.idx = s > t.best ? j : t.idx;
  t.second = fmaxf(t.second, fminf(s, t.best));
  t.best = fmaxf(t.best, s);
}

// Merge with the quad partner `lane ^ mask`; the lower index wins a tie.
__device__ __forceinline__ void top2_merge(Top2& t, int mask) {
  const float ob = __shfl_xor_sync(0xffffffffu, t.best, mask);
  const float os = __shfl_xor_sync(0xffffffffu, t.second, mask);
  const int oi = __shfl_xor_sync(0xffffffffu, t.idx, mask);
  if (ob > t.best || (ob == t.best && oi < t.idx)) {
    t.second = fmaxf(os, t.best);
    t.best = ob;
    t.idx = oi;
  } else {
    t.second = fmaxf(t.second, ob);
  }
}

// kWarps warps of 32 rows each: 16 where they fit in shared memory (up to
// D = 72), so that each codebook tile streamed from L2 serves 512 rows;
// else 4.
template <int kWarps>
__global__ void __launch_bounds__(kWarps * 32, kWarps == 4 ? 3 : 1)
vq_assign_kernel(const float* __restrict__ x, const float* __restrict__ et,
                 const float* __restrict__ eh, const float* __restrict__ el,
                 const float* __restrict__ hn,
                 const unsigned* __restrict__ emax2,
                 int* __restrict__ idx_out, float* __restrict__ quant,
                 int* __restrict__ flag_count, int* __restrict__ flag_list,
                 unsigned long long* __restrict__ keys, int n, int d, int dp,
                 int kp, float c1, float c2) {
  constexpr int kRows = kWarps * 32;
  constexpr int kThreads = kWarps * 32;
  extern __shared__ __align__(16) float smem[];
  const int xs = x_stride(dp);
  float* se = smem;                          // [kStages][hi, lo][kTileN][kSD]
  float* shn = se + kStages * kStageFloats;  // [kHnBufs][kTileN]
  float* sx = shn + kHnBufs * kTileN;        // [kRows][xs]
  int* sidx = reinterpret_cast<int*>(se);    // [kRows], after the main loop

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int n_tiles = kp / kTileN;
  const int nd = (dp + kTileD - 1) / kTileD;
  const int total = n_tiles * nd;

  auto load_stage = [&](int it) {
    if (it >= total) return;
    const int t = it / nd;
    const int c0 = (it - t * nd) * kTileD;
    const int q_per_code = min(kTileD, dp - c0) / 4;
    const int n0 = t * kTileN;
    float* dst = se + (it % kStages) * kStageFloats;
    const int per = kTileN * q_per_code;
    for (int i = tid; i < 2 * per; i += kThreads) {
      const int which = i >= per;
      const int rem = i - which * per;
      const int code = rem / q_per_code;
      const int q = rem - code * q_per_code;
      const float* src = (which ? el : eh) +
                         static_cast<long long>(n0 + code) * dp + c0 + 4 * q;
      cp_async16(dst + which * kTileN * kSD + code * kSD + 4 * q, src);
    }
    if (c0 == 0 && tid < kTileN / 4) {
      cp_async16(shn + (t % kHnBufs) * kTileN + 4 * tid, hn + n0 + 4 * tid);
    }
  };

  // x rows, zero-padded to dp columns, in the first group with stage 0
  if ((d & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const int qrow = dp / 4;
    for (int i = tid; i < kRows * qrow; i += kThreads) {
      const int r = i / qrow;
      const int c = 4 * (i - r * qrow);
      const long long row = row0 + r;
      float* dst = sx + r * xs + c;
      if (row < n && c < d) {
        cp_async16(dst, x + row * d + c);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int i = tid; i < kRows * dp; i += kThreads) {
      const int r = i / dp;
      const int c = i - r * dp;
      const long long row = row0 + r;
      sx[r * xs + c] = (row < n && c < d) ? x[row * d + c] : 0.0f;
    }
  }
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    load_stage(st);
    cp_async_commit();
  }

  Top2 top[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) top[mi][h] = {-CUDART_INF_F, -CUDART_INF_F, 0};

  float acc[2][kNFrag][4];
  const float* xw = sx + (warp * 32 + gid) * xs + 2 * tig;
  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage it has landed; stage it - 1 is free
    load_stage(it + kStages - 1);
    cp_async_commit();

    const int t = it / nd;
    const int c0 = (it - t * nd) * kTileD;
    if (c0 == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNFrag; ++ni)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[mi][ni][v] = 0.0f;
    }
    const int ksteps = min(kTileD, dp - c0) / 8;
    const float* seh =
        se + (it % kStages) * kStageFloats + gid * kSD + 2 * tig;
    const float* sel = seh + kTileN * kSD;
    for (int ks = 0; ks < ksteps; ++ks) {
      // A: the TF32 heads for x_hi.e_hi; bf16 pairs for the cross terms,
      // x_hi at k = 2 tig, 2 tig + 1 and x_lo = x - x_hi at k + 8
      uint32_t ah[2][4], as[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* p = xw + mi * 16 * xs + c0 + ks * 8;
        const float2 v0 = *reinterpret_cast<const float2*>(p);
        const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * xs);
        const float h00 = to_tf32(v0.x), h01 = to_tf32(v0.y);
        const float h10 = to_tf32(v1.x), h11 = to_tf32(v1.y);
        ah[mi][0] = __float_as_uint(h00);
        ah[mi][1] = __float_as_uint(h10);
        ah[mi][2] = __float_as_uint(h01);
        ah[mi][3] = __float_as_uint(h11);
        as[mi][0] = pack_bf16(h00, h01);
        as[mi][1] = pack_bf16(h10, h11);
        as[mi][2] = pack_bf16(v0.x - h00, v0.y - h01);
        as[mi][3] = pack_bf16(v1.x - h10, v1.y - h11);
      }
      // B: e_hi as TF32; bf16 pairs of e_lo (with x_hi) and e_hi (with x_lo)
      uint32_t bh[kNFrag][2], bs[kNFrag][2];
#pragma unroll
      for (int ni = 0; ni < kNFrag; ++ni) {
        const float2 h =
            *reinterpret_cast<const float2*>(seh + ni * 8 * kSD + ks * 8);
        const float2 l =
            *reinterpret_cast<const float2*>(sel + ni * 8 * kSD + ks * 8);
        bh[ni][0] = __float_as_uint(h.x);
        bh[ni][1] = __float_as_uint(h.y);
        bs[ni][0] = pack_bf16(l.x, l.y);
        bs[ni][1] = pack_bf16(h.x, h.y);
      }
      // the cross terms first, then the large product; 16 independent
      // accumulators between two products into the same one
#pragma unroll
      for (int ni = 0; ni < kNFrag; ++ni)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          mma_bf16(acc[mi][ni], as[mi], bs[ni][0], bs[ni][1]);
#pragma unroll
      for (int ni = 0; ni < kNFrag; ++ni)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          mma_tf32(acc[mi][ni], ah[mi], bh[ni][0], bh[ni][1]);
    }

    if (c0 + kTileD >= dp) {  // the tile's last depth chunk: its epilogue
      const float* th = shn + (t % kHnBufs) * kTileN;
#pragma unroll
      for (int ni = 0; ni < kNFrag; ++ni) {
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int col = ni * 8 + tig * 2 + v;
          const float h = th[col];
          const int j = t * kTileN + col;
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            top2_take(top[mi][0], acc[mi][ni][v] - h, j);
            top2_take(top[mi][1], acc[mi][ni][2 + v] - h, j);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages are free for sidx

  const float emax_sq = __uint_as_float(*emax2);
  const float emax = sqrtf(emax_sq);
  const unsigned lt_mask = (1u << lane) - 1u;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      Top2 tp = top[mi][h];
      top2_merge(tp, 1);
      top2_merge(tp, 2);
      const int r = warp * 32 + mi * 16 + h * 8 + gid;
      float ss = 0.0f;
      for (int c = tig; c < dp; c += 4) {
        const float v = sx[r * xs + c];
        ss = fmaf(v, v, ss);
      }
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      ss += __shfl_xor_sync(0xffffffffu, ss, 2);
      const float eps = c1 * sqrtf(ss) * emax + c2 * emax_sq;
      const long long row = row0 + r;
      const bool mine = tig == 0 && row < n;
      // NaN or infinite inputs fail the test and go to the re-score
      const bool flagged = mine && !(tp.best - tp.second > 2.0f * eps);
      if (tig == 0) sidx[r] = tp.idx;
      if (mine) idx_out[row] = tp.idx;
      const unsigned fm = __ballot_sync(0xffffffffu, flagged);
      if (fm) {
        const int leader = __ffs(fm) - 1;
        int base = 0;
        if (lane == leader) base = atomicAdd(flag_count, __popc(fm));
        base = __shfl_sync(0xffffffffu, base, leader);
        if (flagged) {
          const int pos = base + __popc(fm & lt_mask);
          flag_list[pos] = static_cast<int>(row);
          keys[pos] = 0ull;  // below every score's key
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kRows * d; i += kThreads) {
    const int r = i / d;
    const int c = i - r * d;
    const long long row = row0 + r;
    if (row < n) {
      quant[row * d + c] = et[static_cast<long long>(sidx[r]) * d + c];
    }
  }
}

// The re-score of the flagged rows: exact float32 scores over all K, as
// the plain float32 kernel computes them (FMA in ascending d, then minus
// the half norm), and each row's argmax, the lowest index winning a tie.
// A block takes kRescoreRows flagged rows and one slice of kSliceCodes
// codes: the rows sit in shared memory, and a thread scores its codes
// (kRescoreThreads apart) for all of them, so each codebook entry read from
// L2 serves kRescoreRows rows. Slices meet in a 64-bit atomic max of
// (order-preserving score bits, ~index) per row: the higher score wins, then
// the lower index. A second kernel decodes the winners and writes idx and
// quant.
constexpr int kRescoreThreads = 256;
constexpr int kRescoreRows = 8;
constexpr int kSliceCodes = 1024;
constexpr int kMaxDim = 224;

// Score bits that order as the scores do, NaN taken as -inf (it never wins
// a strict '>'); the low word is ~index, so a lower index is a larger key.
__device__ __forceinline__ unsigned long long rescore_key(float s, int j) {
  if (s != s) s = -CUDART_INF_F;
  const unsigned u = __float_as_uint(s);
  const unsigned ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(ord) << 32) |
         static_cast<unsigned>(~j);
}

__global__ void __launch_bounds__(kRescoreThreads)
vq_rescore_kernel(const float* __restrict__ x, const float* __restrict__ embed,
                  const float* __restrict__ hn,
                  const int* __restrict__ flag_count,
                  const int* __restrict__ flag_list,
                  unsigned long long* __restrict__ keys, int d, int k) {
  __shared__ float xr[kRescoreRows][kMaxDim];
  __shared__ int wrow[kRescoreRows];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int count = *flag_count;
  const int j_end = min(k, static_cast<int>(blockIdx.y + 1) * kSliceCodes);
  for (int f0 = blockIdx.x * kRescoreRows; f0 < count;
       f0 += gridDim.x * kRescoreRows) {
    const int rows = min(kRescoreRows, count - f0);
    __syncthreads();  // the previous group is done with xr and wrow
    if (tid < kRescoreRows) wrow[tid] = tid < rows ? flag_list[f0 + tid] : 0;
    __syncthreads();
    for (int i = tid; i < kRescoreRows * d; i += kRescoreThreads) {
      const int r = i / d;
      const int c = i - r * d;
      xr[r][c] = x[static_cast<long long>(wrow[r]) * d + c];
    }
    __syncthreads();
    float best[kRescoreRows];
    int bi[kRescoreRows];
#pragma unroll
    for (int r = 0; r < kRescoreRows; ++r) {
      best[r] = -CUDART_INF_F;
      bi[r] = 0;
    }
    for (int j = blockIdx.y * kSliceCodes + tid; j < j_end;
         j += kRescoreThreads) {
      float acc[kRescoreRows];
#pragma unroll
      for (int r = 0; r < kRescoreRows; ++r) acc[r] = 0.0f;
      for (int c = 0; c < d; ++c) {
        const float e = __ldg(embed + static_cast<long long>(c) * k + j);
#pragma unroll
        for (int r = 0; r < kRescoreRows; ++r) {
          acc[r] = fmaf(xr[r][c], e, acc[r]);
        }
      }
      const float h = hn[j];
#pragma unroll
      for (int r = 0; r < kRescoreRows; ++r) {
        const float s = acc[r] - h;
        if (s > best[r]) {
          best[r] = s;
          bi[r] = j;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRescoreRows; ++r) {
      unsigned long long key = rescore_key(best[r], bi[r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(0xffffffffu, key, off);
        key = o > key ? o : key;
      }
      if (lane == 0 && r < rows) atomicMax(&keys[f0 + r], key);
    }
  }
}

// One warp per flagged row: the winner's index and quant row.
__global__ void __launch_bounds__(kRescoreThreads)
vq_rescore_finish_kernel(const float* __restrict__ et,
                         const int* __restrict__ flag_count,
                         const int* __restrict__ flag_list,
                         const unsigned long long* __restrict__ keys,
                         int* __restrict__ idx_out, float* __restrict__ quant,
                         int d) {
  const int lane = threadIdx.x & 31;
  const int gw = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int nw = (gridDim.x * blockDim.x) >> 5;
  const int count = *flag_count;
  for (int f = gw; f < count; f += nw) {
    const long long row = flag_list[f];
    const int i = static_cast<int>(~static_cast<unsigned>(keys[f]));
    if (lane == 0) idx_out[row] = i;
    for (int c = lane; c < d; c += 32) {
      quant[row * d + c] = et[static_cast<long long>(i) * d + c];
    }
  }
}

// -- statistics -------------------------------------------------------------

constexpr int kChunkRows = 128;   // rows of one code summed by one warp
constexpr int kSegRows = 512;     // rows of one sort segment (one warp)
constexpr int kMaxSegments = 1024;
constexpr long long kMaxSegCounters = 1LL << 22;  // segments x codes
constexpr int kSortThreads = 256;
constexpr int kSortBatch = 16;    // groups of 32 rows whose ids load at once
constexpr int kScanThreads = 1024;
constexpr int kSumThreads = 256;

// Segments of the stable sort for (n, k): about kSegRows rows each, at
// most kMaxSegments, and at most kMaxSegCounters / k so that the
// per-segment counters stay small at a large K.
__host__ int stats_segments(long long n, int k) {
  long long s = (n + kSegRows - 1) / kSegRows;
  if (s > kMaxSegments) s = kMaxSegments;
  const long long cap = kMaxSegCounters / k;
  if (s > cap) s = cap;
  return s < 1 ? 1 : static_cast<int>(s);
}

// The stable sort's two passes. Block b holds warps w < W, warp w the rows
// of segment s = b W + w, 32 at a time in row order (kSortBatch groups of
// ids loaded at once). For each code present in a group the lowest lane
// holding it reads and advances the warp's own counter ctr[code] (no other
// warp touches it, so no atomics) and hands the old value to its peers,
// each of which adds its rank among the lower lanes holding the same code.
//
// COUNT: the warps count their segments; then, in shared memory, the
// block turns its warps' counts into each warp's exclusive prefix within
// the block (seg_pre[s]) and the block's totals (blk[b]).
// Placement: each warp starts its counters at blk[b] (by then the
// block's first position within each code, stats_segscan_kernel) plus
// seg_pre[s], and each row goes to order[offsets[code] + counter + rank]:
// the rows of every code land in ascending row order.
// With use_shared the counters are W x k ints of shared memory; else
// W = 1 and the warp counts straight into blk[b] in global memory (zeroed
// before the count), where seg_pre is not used.
template <bool COUNT>
__global__ void __launch_bounds__(kSortThreads)
stats_sort_kernel(const int* __restrict__ idx, int* __restrict__ seg_pre,
                  int* __restrict__ blk, const int* __restrict__ offsets,
                  int* __restrict__ order, int n, int k, int seg_rows,
                  int use_shared) {
  extern __shared__ int sh[];  // [W][k] with use_shared
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long seg = static_cast<long long>(blockIdx.x) * nw + warp;
  int* brow = blk + static_cast<long long>(blockIdx.x) * k;
  int* ctr = use_shared ? sh + static_cast<long long>(warp) * k : brow;
  if (use_shared) {
    const int* pre = seg_pre + seg * k;
    for (int c = lane; c < k; c += 32) ctr[c] = COUNT ? 0 : brow[c] + pre[c];
    __syncwarp();
  }
  const long long r0 = seg * seg_rows;
  const long long r1 = min(static_cast<long long>(n), r0 + seg_rows);
  for (long long b0 = r0; b0 < r1; b0 += 32 * kSortBatch) {
    int codes[kSortBatch];  // kSortBatch loads in flight at once
#pragma unroll
    for (int u = 0; u < kSortBatch; ++u) {
      const long long r = b0 + u * 32 + lane;
      codes[u] = r < r1 ? __ldg(idx + r) : 0;
    }
#pragma unroll
    for (int u = 0; u < kSortBatch; ++u) {
      const long long r = b0 + u * 32 + lane;
      const bool valid = r < r1;
      const unsigned active = __ballot_sync(0xffffffffu, valid);
      if (valid) {
        const int code = codes[u];
        const unsigned peers = __match_any_sync(active, code);
        const int leader = __ffs(peers) - 1;
        int base = 0;
        if (lane == leader) {
          base = ctr[code];
          ctr[code] = base + __popc(peers);
        }
        if (!COUNT) {
          base = __shfl_sync(peers, base, leader);
          order[offsets[code] + base +
                __popc(peers & ((1u << lane) - 1u))] = static_cast<int>(r);
        }
      }
      __syncwarp();  // the counters' updates are seen by the next group
    }
  }
  if (COUNT && use_shared) {
    __syncthreads();
    int* pre0 = seg_pre + static_cast<long long>(blockIdx.x) * nw * k;
    for (int c = threadIdx.x; c < k; c += blockDim.x) {
      int run = 0;
      for (int w = 0; w < nw; ++w) {
        const int t = sh[w * k + c];
        pre0[static_cast<long long>(w) * k + c] = run;
        run += t;
      }
      brow[c] = run;
    }
  }
}

// One warp per code: the exclusive scan of the blocks' counts of the code
// (blk, `blocks` rows of k), in block order, written back as each block's
// first position within the code; the code's total into cnt.
__global__ void __launch_bounds__(kSortThreads)
stats_segscan_kernel(int* __restrict__ blk, int* __restrict__ cnt, int k,
                     int blocks) {
  const int code = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (code >= k) return;
  const int lane = threadIdx.x & 31;
  int carry = 0;
  for (int b0 = 0; b0 < blocks; b0 += 32) {
    const int b = b0 + lane;
    int* p = blk + static_cast<long long>(b) * k + code;
    const int v = b < blocks ? *p : 0;
    int inc = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += t;
    }
    if (b < blocks) *p = carry + inc - v;
    carry += __shfl_sync(0xffffffffu, inc, 31);
  }
  if (lane == 0) cnt[code] = carry;
}

// Exclusive block scan of two ints; returns the block totals.
__device__ __forceinline__ int2 block_scan2(int a, int b, int& ex_a,
                                            int& ex_b) {
  __shared__ int wa[32], wb[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int ia = a, ib = b;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int ta = __shfl_up_sync(0xffffffffu, ia, off);
    const int tb = __shfl_up_sync(0xffffffffu, ib, off);
    if (lane >= off) {
      ia += ta;
      ib += tb;
    }
  }
  if (lane == 31) {
    wa[warp] = ia;
    wb[warp] = ib;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    int va = lane < nwarps ? wa[lane] : 0;
    int vb = lane < nwarps ? wb[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int ta = __shfl_up_sync(0xffffffffu, va, off);
      const int tb = __shfl_up_sync(0xffffffffu, vb, off);
      if (lane >= off) {
        va += ta;
        vb += tb;
      }
    }
    wa[lane] = va;  // inclusive scan of the warp totals
    wb[lane] = vb;
  }
  __syncthreads();
  const int pa = warp > 0 ? wa[warp - 1] : 0;
  const int pb = warp > 0 ? wb[warp - 1] : 0;
  ex_a = pa + ia - a;
  ex_b = pb + ib - b;
  const int2 tot = make_int2(wa[(blockDim.x >> 5) - 1],
                             wb[(blockDim.x >> 5) - 1]);
  __syncthreads();  // the next call rewrites wa, wb
  return tot;
}

__global__ void __launch_bounds__(kScanThreads)
stats_scan_kernel(const int* __restrict__ cnt, int* __restrict__ offsets,
                  int* __restrict__ chunk_off, float* __restrict__ counts,
                  int k) {
  int carry_rows = 0, carry_chunks = 0;
  for (int base = 0; base < k; base += blockDim.x) {
    const int j = base + threadIdx.x;
    const int c = j < k ? cnt[j] : 0;
    const int ch = (c + kChunkRows - 1) / kChunkRows;
    int ex_c, ex_ch;
    const int2 tot = block_scan2(c, ch, ex_c, ex_ch);
    if (j < k) {
      offsets[j] = carry_rows + ex_c;
      chunk_off[j] = carry_chunks + ex_ch;
      counts[j] = static_cast<float>(c);
    }
    carry_rows += tot.x;
    carry_chunks += tot.y;
  }
  if (threadIdx.x == 0) {
    offsets[k] = carry_rows;
    chunk_off[k] = carry_chunks;
  }
}

template <int VEC> struct Vec;
template <> struct Vec<1> {
  static __device__ __forceinline__ void add(float* a, const float* p) {
    a[0] += __ldg(p);
  }
};
template <> struct Vec<4> {
  static __device__ __forceinline__ void add(float* a, const float* p) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    a[0] += v.x;
    a[1] += v.y;
    a[2] += v.z;
    a[3] += v.w;
  }
};

// The code whose chunks hold chunk `ch`: the last j < k with
// chunk_off[j] <= ch, by a 32-way search of the warp (chunk_off is
// nondecreasing and chunk_off[0] = 0).
__device__ __forceinline__ int find_code(const int* __restrict__ chunk_off,
                                         int k, int ch) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = k;
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) / 32;
    const int j = lo + lane * step;
    const bool ok = j < hi && __ldg(chunk_off + j) <= ch;
    const unsigned m = __ballot_sync(0xffffffffu, ok);
    lo += (31 - __clz(m)) * step;
    hi = min(hi, lo + step);
  }
  return lo;
}

// One warp per chunk. Lanes form 32 / P groups of P lanes (P the power of
// two >= D / VEC, at most 32); a group sums every (32 / P)-th row of the
// chunk, kUnroll rows in flight, lane q of the group columns
// VEC (q + P s) .. + VEC - 1 for slots s < SLOTS. The chunk's row ids are
// read once, coalesced, into shared memory. The chunk's sum goes to
// partial[ch] (D floats); the rows of a chunk and the order of its adds
// are fixed, so the partial sums are the same in every run.
template <int VEC, int SLOTS>
__global__ void __launch_bounds__(kSumThreads)
stats_segsum_kernel(const float* __restrict__ x, const int* __restrict__ order,
                    const int* __restrict__ offsets,
                    const int* __restrict__ chunk_off,
                    float* __restrict__ partial, int d, int k, int p) {
  constexpr int kUnroll = 8;
  __shared__ int srows[kSumThreads / 32][kChunkRows];
  const int lane = threadIdx.x & 31;
  int* rows = srows[threadIdx.x >> 5];
  const int gw = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int nw = (gridDim.x * blockDim.x) >> 5;
  const int nq = d / VEC;
  const int groups = 32 / p;
  const int g = lane / p;
  const int q0 = lane - g * p;
  const int total = chunk_off[k];
  for (int ch = gw; ch < total; ch += nw) {
    const int code = find_code(chunk_off, k, ch);
    const int start = offsets[code] + (ch - chunk_off[code]) * kChunkRows;
    const int cnt = min(kChunkRows, offsets[code + 1] - start);
    __syncwarp();
    for (int i = lane; i < cnt; i += 32) rows[i] = __ldg(order + start + i);
    __syncwarp();
    float acc[SLOTS][VEC];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[s][v] = 0.0f;
    for (int i0 = g; i0 < cnt; i0 += groups * kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * groups;
        if (i < cnt) {
          const float* xr = x + static_cast<long long>(rows[i]) * d;
#pragma unroll
          for (int s = 0; s < SLOTS; ++s) {
            const int q = q0 + s * p;
            if (q < nq) Vec<VEC>::add(acc[s], xr + q * VEC);
          }
        }
      }
    }
    for (int off = p; off < 32; off <<= 1) {
#pragma unroll
      for (int s = 0; s < SLOTS; ++s)
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          acc[s][v] += __shfl_xor_sync(0xffffffffu, acc[s][v], off);
    }
    if (g == 0) {
      float* out = partial + static_cast<long long>(ch) * d;
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const int q = q0 + s * p;
        if (q < nq) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) out[q * VEC + v] = acc[s][v];
        }
      }
    }
  }
}

// sums[j, code] = the code's chunk sums in chunk order (0 for a code of no
// rows), one thread per (code, j).
__global__ void __launch_bounds__(kSumThreads)
stats_reduce_kernel(const float* __restrict__ partial,
                    const int* __restrict__ chunk_off,
                    float* __restrict__ sums, int d, int k) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(k) * d) return;
  const int code = static_cast<int>(t / d);
  const int j = static_cast<int>(t - static_cast<long long>(code) * d);
  const int c1 = chunk_off[code + 1];
  float acc = 0.0f;
  for (int ch = chunk_off[code]; ch < c1; ++ch) {
    acc += partial[static_cast<long long>(ch) * d + j];
  }
  sums[static_cast<long long>(j) * k + code] = acc;
}

// Device attributes and kernel shared-memory limits, cached per device:
// querying and setting them on every call costs more host time than the
// small statistics launches themselves, and a call captured in a CUDA
// graph after a first call sets nothing.
constexpr int kMaxDevices = 64;

struct DeviceInfo {
  int sms = 0;
  int optin = 0;
  int smem_set[4] = {0, 0, 0, 0};  // assign (16, 4 warps), sort (2 passes)
};

DeviceInfo& device_info() {
  static DeviceInfo info[kMaxDevices];
  static thread_local DeviceInfo uncached;
  int dev = 0;
  cudaGetDevice(&dev);
  DeviceInfo& di = dev < kMaxDevices ? info[dev] : (uncached = DeviceInfo());
  if (di.sms == 0) {
    cudaDeviceGetAttribute(&di.sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&di.optin,
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return di;
}

// Raises `fn`'s dynamic shared-memory limit to `bytes` unless it is there.
template <typename F>
void allow_smem(DeviceInfo& di, int slot, F fn, int bytes) {
  if (bytes > di.smem_set[slot]) {
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
    di.smem_set[slot] = bytes;
  }
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

}  // namespace

// Shared-memory bytes of an assignment block of `warps` warps, width d.
static long long assign_smem_bytes(int d, int warps) {
  const int dp = round_up(d, 8);
  return static_cast<long long>(sizeof(float)) *
         (kStages * kStageFloats + kHnBufs * kTileN +
          32LL * warps * x_stride(dp));
}

// Floats of the assignment's scratch for (d, k): E^T hi and lo, the half
// norms, the largest squared norm and E^T.
extern "C" long long faceoff_vq_assign_scratch_floats(int d, int k) {
  const long long dp = round_up(d, 8);
  const long long kp = round_up(k, kTileN);
  return 2 * kp * dp + kp + 4 + static_cast<long long>(k) * d;
}

// Launches the assignment on `stream` (a cudaStream_t passed as void*):
// x (n, d) and embed (d, k) float32, contiguous; writes idx (n,) int32 and
// quant (n, d). fwork holds faceoff_vq_assign_scratch_floats(d, k) floats;
// iwork n + 1 ints (the flagged-row count, then the flagged rows); keys n
// 64-bit words (the re-score's running winners). c1, c2
// are the coefficients of the per-row error bound. Returns
// cudaGetLastError() as an int, 0 when every launch was accepted;
// cudaErrorInvalidValue when d is too wide for the block's shared memory.
// The Python wrapper checks n >= 1, 1 <= d <= 224, k >= 1.
extern "C" int faceoff_vq_assign_rows(const float* x, const float* embed,
                                      int* idx, float* quant, float* fwork,
                                      int* iwork, unsigned long long* keys,
                                      int n, int d, int k, float c1, float c2,
                                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  DeviceInfo& di = device_info();
  const int warps = assign_smem_bytes(d, 16) <= di.optin ? 16 : 4;
  if (d > kMaxDim || assign_smem_bytes(d, warps) > di.optin) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = assign_smem_bytes(d, warps);
  const int dp = round_up(d, 8);
  const int kp = round_up(k, kTileN);
  float* eh = fwork;
  float* el = eh + static_cast<long long>(kp) * dp;
  float* hn = el + static_cast<long long>(kp) * dp;
  unsigned* emax2 = reinterpret_cast<unsigned*>(hn + kp);
  float* et = hn + kp + 4;
  cudaMemsetAsync(emax2, 0, sizeof(unsigned), st);
  cudaMemsetAsync(iwork, 0, sizeof(int), st);
  vq_prep_kernel<<<kp / 32, 256, dp * 33 * sizeof(float), st>>>(
      embed, eh, el, et, hn, emax2, d, dp, k);
  const int rows = 32 * warps;
  const int blocks_a = (n + rows - 1) / rows;
  if (warps == 16) {
    allow_smem(di, 0, vq_assign_kernel<16>, static_cast<int>(smem));
    vq_assign_kernel<16><<<blocks_a, rows, smem, st>>>(
        x, et, eh, el, hn, emax2, idx, quant, iwork, iwork + 1, keys, n, d, dp,
        kp, c1, c2);
  } else {
    allow_smem(di, 1, vq_assign_kernel<4>, static_cast<int>(smem));
    vq_assign_kernel<4><<<blocks_a, rows, smem, st>>>(
        x, et, eh, el, hn, emax2, idx, quant, iwork, iwork + 1, keys, n, d, dp,
        kp, c1, c2);
  }
  const int slices = (k + kSliceCodes - 1) / kSliceCodes;
  const int groups = (n + kRescoreRows - 1) / kRescoreRows;
  int gx = (4 * di.sms + slices - 1) / slices;
  if (gx > groups) gx = groups;
  vq_rescore_kernel<<<dim3(gx, slices), kRescoreThreads, 0, st>>>(
      x, embed, hn, iwork, iwork + 1, keys, d, k);
  const int fin = (n + 7) / 8 < 4 * di.sms ? (n + 7) / 8 : 4 * di.sms;
  vq_rescore_finish_kernel<<<fin, kRescoreThreads, 0, st>>>(
      et, iwork, iwork + 1, keys, idx, quant, d);
  return static_cast<int>(cudaGetLastError());
}

// Ints of the statistics' scratch for (n, d, k): the code counts,
// offsets and chunk offsets, the rows in code order, the sort's
// per-segment prefixes (up to 7 segments of padding in the last block)
// and per-block counts, and the chunks' partial sums (floats).
extern "C" long long faceoff_vq_stats_scratch_ints(int n, int d, int k) {
  const long long segments = stats_segments(n, k);
  const long long max_chunks = (n + kChunkRows - 1) / kChunkRows + k;
  return static_cast<long long>(n) + 3LL * k + 2 +
         (2 * segments + kSortThreads / 32 - 1) * k + max_chunks * d;
}

// Launches the statistics on `stream`: x (n, d) float32 and idx (n,)
// int32 in [0, k), contiguous; writes counts (k,) and sums (d, k). iwork
// holds faceoff_vq_stats_scratch_ints(n, d, k) ints. Every launch adds
// in a fixed order, so equal inputs give bitwise equal sums. Returns
// cudaGetLastError() as an int. The wrapper checks 1 <= d <= 224.
extern "C" int faceoff_vq_stats(const float* x, const int* idx,
                                float* counts, float* sums, int* iwork, int n,
                                int d, int k, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  DeviceInfo& di = device_info();
  const int segments = stats_segments(n, k);
  const int seg_rows = (n + segments - 1) / segments;
  const long long max_chunks = (n + kChunkRows - 1) / kChunkRows + k;
  // the sort's counters in shared memory, as many warps a block as fit
  // (at least one), else in global memory, one warp a block
  const long long ctr_bytes = static_cast<long long>(k) * sizeof(int);
  const int use_shared = ctr_bytes <= di.optin;
  int sort_warps = kSortThreads / 32;
  while (sort_warps > 1 && (!use_shared || sort_warps * ctr_bytes > di.optin)) {
    sort_warps /= 2;
  }
  const int sort_blocks = (segments + sort_warps - 1) / sort_warps;
  const int sort_smem =
      use_shared ? static_cast<int>(sort_warps * ctr_bytes) : 0;
  int* cnt = iwork;
  int* offsets = cnt + k;
  int* chunk_off = offsets + k + 1;
  int* order = chunk_off + k + 1;
  int* seg_pre = order + n;
  int* blk = seg_pre + static_cast<long long>(sort_blocks) * sort_warps * k;
  float* partial =
      reinterpret_cast<float*>(blk + static_cast<long long>(sort_blocks) * k);
  if (!use_shared) {
    cudaMemsetAsync(blk, 0, ctr_bytes * sort_blocks, st);
  }

  allow_smem(di, 2, stats_sort_kernel<true>, sort_smem);
  allow_smem(di, 3, stats_sort_kernel<false>, sort_smem);
  stats_sort_kernel<true><<<sort_blocks, sort_warps * 32, sort_smem, st>>>(
      idx, seg_pre, blk, nullptr, nullptr, n, k, seg_rows, use_shared);
  const int scan_warps = kSortThreads / 32;
  stats_segscan_kernel<<<(k + scan_warps - 1) / scan_warps, kSortThreads, 0,
                         st>>>(blk, cnt, k, sort_blocks);
  stats_scan_kernel<<<1, kScanThreads, 0, st>>>(cnt, offsets, chunk_off,
                                                counts, k);
  stats_sort_kernel<false><<<sort_blocks, sort_warps * 32, sort_smem, st>>>(
      idx, seg_pre, blk, offsets, order, n, k, seg_rows, use_shared);

  const bool vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int nq = vec4 ? d / 4 : d;
  int p = 1;
  while (p < nq && p < 32) p <<= 1;
  const int warps_per_block = kSumThreads / 32;
  long long sum_blocks = (max_chunks + warps_per_block - 1) / warps_per_block;
  if (sum_blocks > 32LL * di.sms) sum_blocks = 32LL * di.sms;
  const int grid = static_cast<int>(sum_blocks);
  if (vec4) {
    if (nq <= 32) {
      stats_segsum_kernel<4, 1><<<grid, kSumThreads, 0, st>>>(
          x, order, offsets, chunk_off, partial, d, k, p);
    } else {
      stats_segsum_kernel<4, 2><<<grid, kSumThreads, 0, st>>>(
          x, order, offsets, chunk_off, partial, d, k, p);
    }
  } else {
    stats_segsum_kernel<1, 7><<<grid, kSumThreads, 0, st>>>(
        x, order, offsets, chunk_off, partial, d, k, p);
  }
  const long long outs = static_cast<long long>(k) * d;
  stats_reduce_kernel<<<static_cast<int>((outs + kSumThreads - 1) /
                                         kSumThreads),
                        kSumThreads, 0, st>>>(partial, chunk_off, sums, d, k);
  return static_cast<int>(cudaGetLastError());
}
