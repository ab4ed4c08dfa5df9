// Pyramidal Lucas-Kanade tracking of a set of points, forward from frame
// A to frame B and back from B to A, behind a plain C interface for
// ctypes (faceoff_tpu_torch/ops/lk_cuda.py).
//
// Not a port of a TPU kernel: it replaces the two cv2.calcOpticalFlowPyrLK
// calls of faceoff_tpu/preprocess/detectors.py:483 and :488 (the landmark
// tracker's forward-backward check), which the JAX package runs on the
// host and for which PyTorch has no operator. lk_cuda.py lists the
// arithmetic, which is OpenCV's (lkpyramid.cpp).
//
// Design: a CUDA block of WPP warps per point (4 in the port). A point's
// work is a dependent chain (2 directions x up to 4 levels x (a setup and
// up to 30 iterations)), each link a sum over the window, so the kernel
// is bound by the latency of a link, not by operations.
// Thread t of a point owns the window pixels t, t + 32 WPP, ... (KPL of
// them, win * win <= 32 WPP KPL) and keeps their interpolated image values
// and derivatives in registers across a level's iterations; an iteration
// issues all its loads of J before any arithmetic. The 2 x 2 system and
// the right-hand side are exact integer sums: each thread adds its
// pixels' products in 32 bits (lk_cuda.py's bounds prove they cannot
// overflow; tests/test_torch_ccl_lk_arith.py checks the proof), a 64-bit
// butterfly of __shfl_xor_sync gives every lane its warp's total (32-bit
// butterfly levels measured no faster), and the warps' totals meet in
// shared memory after one named barrier (two buffers in turn, so no
// second barrier). Every thread then does the same float steps on the
// same sums, so the point's state needs no broadcast; thread 0 writes the
// results. The float steps use the _rn intrinsics: one IEEE operation
// each, never contracted into a fused multiply-add, so that they round as
// the plain torch version's do.
// Bound: latency (chip_smoke.py: the longest point's setups and
// iterations times the least time of one link, measured by
// tools/ccl_lk_probe.cu); the operations bound counts, per window pixel,
// 33 integer operations a setup (three bilinear interpolations of 9,
// three products and their three sum adds) and 14 an iteration (one
// interpolation of 9, a subtraction, two products and two sum adds):
// chip_smoke.py's LK_OPS_SETUP and LK_OPS_ITER.
//
// Returns 0, 1 for a window shape the launcher was not built for, or
// 1000 + a cudaError_t.

#include <cuda_runtime.h>

namespace lk {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWBits = 14;
constexpr float kFltScale = 1.f / (1 << 20);
constexpr float kFltEpsilon = 1.1920928955078125e-07f;

struct Level {
  long long rows, cols, img_off, der_off;
};

__device__ __forceinline__ void weights(float a, float b, int* iw) {
  float ia = __fsub_rn(1.f, a), ib = __fsub_rn(1.f, b);
  iw[0] = __float2int_rn(__fmul_rn(__fmul_rn(ia, ib), 16384.f));
  iw[1] = __float2int_rn(__fmul_rn(__fmul_rn(a, ib), 16384.f));
  iw[2] = __float2int_rn(__fmul_rn(__fmul_rn(ia, b), 16384.f));
  iw[3] = (1 << kWBits) - iw[0] - iw[1] - iw[2];
}

__device__ __forceinline__ int descale(int v, int n) {
  return (v + (1 << (n - 1))) >> n;
}

// Bilinear interpolation at q of an image (step 1) or of one derivative
// (step 2: the int16 pairs), stride in pixels.
template <int STEP, typename T>
__device__ __forceinline__ int interp(const T* q, int stride,
                                      const int* iw) {
  return __ldg(q) * iw[0] + __ldg(q + STEP) * iw[1] +
         __ldg(q + STEP * stride) * iw[2] +
         __ldg(q + STEP * stride + STEP) * iw[3];
}

// The warp's sums of K per-lane values, in every lane.
template <int K>
__device__ __forceinline__ void warp_sum(const int (&v)[K],
                                         long long (&out)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = v[k];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] += __shfl_xor_sync(kFull, out[k], off);
  }
}

// A point's shared memory: its warps' partial sums, two buffers used in
// turn.
template <int WPP>
struct PointShared {
  long long partial[2][WPP][3];
};

// The WPP warps of a point wait for each other (named barrier `id`).
__device__ __forceinline__ void point_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The point's sums of K per-thread values, in every thread: a warp's
// butterfly, then (WPP > 1) the warps' totals added through shared
// memory in a fixed order.
template <int K, int WPP, typename Shared>
__device__ __forceinline__ void point_sum(const int (&v)[K],
                                          long long (&out)[K], Shared& sh,
                                          int& buf, int wip, int bar) {
  warp_sum<K>(v, out);
  if (WPP > 1) {
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) sh.partial[buf][wip][k] = out[k];
    }
    point_sync(bar, 32 * WPP);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      long long total = 0;
#pragma unroll
      for (int w = 0; w < WPP; ++w) total += sh.partial[buf][w][k];
      out[k] = total;
    }
    buf ^= 1;  // the next sum writes the other buffer: no second barrier
  }
}

// Tracks `start` from image I (with derivatives dI) into image J; every
// thread of the point returns the same point and status. wyx[k]: the
// window row << 8 | column of this thread's k-th pixel, -1 past the
// window.
template <int KPL, int WPP, typename Shared>
__device__ void track(const unsigned char* __restrict__ img_i,
                      const short* __restrict__ der_i,
                      const unsigned char* __restrict__ img_j,
                      const Level* __restrict__ levels, int n_levels,
                      int win, int max_iter, float min_eig, double eps2,
                      float2 start, const int (&wyx)[KPL], Shared& sh,
                      int& buf, int wip, int bar, float2* result,
                      bool* status) {
  const float half = __fmul_rn(static_cast<float>(win - 1), 0.5f);
  bool ok = true;
  float2 nxt = make_float2(0.f, 0.f);
  for (int level = n_levels - 1; level >= 0; --level) {
    const int rows = static_cast<int>(__ldg(&levels[level].rows));
    const int cols = static_cast<int>(__ldg(&levels[level].cols));
    const long long img_off = __ldg(&levels[level].img_off);
    const long long der_off = __ldg(&levels[level].der_off);
    const int stride = cols + 2 * win;
    const float scale = 1.f / static_cast<float>(1 << level);
    float2 prev = make_float2(__fmul_rn(start.x, scale),
                              __fmul_rn(start.y, scale));
    if (level == n_levels - 1) {
      nxt = prev;
    } else {
      nxt = make_float2(__fmul_rn(nxt.x, 2.f), __fmul_rn(nxt.y, 2.f));
    }
    prev = make_float2(__fsub_rn(prev.x, half), __fsub_rn(prev.y, half));
    int ipx = static_cast<int>(floorf(prev.x));
    int ipy = static_cast<int>(floorf(prev.y));
    if (ipx < -win || ipx >= cols || ipy < -win || ipy >= rows) {
      if (level == 0) ok = false;
      continue;
    }
    int iw[4];
    weights(__fsub_rn(prev.x, static_cast<float>(ipx)),
            __fsub_rn(prev.y, static_cast<float>(ipy)), iw);
    int off[KPL];
#pragma unroll
    for (int k = 0; k < KPL; ++k)
      off[k] = wyx[k] < 0 ? 0 : (wyx[k] >> 8) * stride + (wyx[k] & 255);
    const long long corner =
        static_cast<long long>(ipy + win) * stride + ipx + win;
    const unsigned char* src = img_i + img_off + corner;
    const short* der = der_i + der_off + 2 * corner;
    // No branch a pixel: a pixel past the window reads the window's corner
    // and gets zero derivatives, so it adds nothing here or below, and the
    // compiler can issue every load of the loop at once.
    int ival[KPL], ix[KPL], iy[KPL];
    int s[3] = {0, 0, 0};
#pragma unroll
    for (int k = 0; k < KPL; ++k) {
      const int in = wyx[k] >= 0;
      ival[k] = descale(interp<1>(src + off[k], stride, iw), kWBits - 5);
      ix[k] = in * descale(interp<2>(der + 2 * off[k], stride, iw), kWBits);
      iy[k] = in * descale(interp<2>(der + 2 * off[k] + 1, stride, iw),
                           kWBits);
      s[0] += ix[k] * ix[k];
      s[1] += ix[k] * iy[k];
      s[2] += iy[k] * iy[k];
    }
    long long a[3];
    point_sum<3, WPP>(s, a, sh, buf, wip, bar);
    const float a11 = __fmul_rn(__ll2float_rn(a[0]), kFltScale);
    const float a12 = __fmul_rn(__ll2float_rn(a[1]), kFltScale);
    const float a22 = __fmul_rn(__ll2float_rn(a[2]), kFltScale);
    float det = __fsub_rn(__fmul_rn(a11, a22), __fmul_rn(a12, a12));
    const float diff = __fsub_rn(a11, a22);
    const float disc = __fadd_rn(__fmul_rn(diff, diff),
                                 __fmul_rn(__fmul_rn(4.f, a12), a12));
    const float eig = __fdiv_rn(
        __fsub_rn(__fadd_rn(a22, a11), __fsqrt_rn(disc)),
        static_cast<float>(2 * win * win));
    if (eig < min_eig || det < kFltEpsilon) {
      if (level == 0) ok = false;
      continue;
    }
    const float inv = __fdiv_rn(1.f, det);
    float2 cur = make_float2(__fsub_rn(nxt.x, half), __fsub_rn(nxt.y, half));
    float pdx = 0.f, pdy = 0.f;
    const unsigned char* dst_level = img_j + img_off;
    for (int j = 0; j < max_iter; ++j) {
      int inx = static_cast<int>(floorf(cur.x));
      int iny = static_cast<int>(floorf(cur.y));
      if (inx < -win || inx >= cols || iny < -win || iny >= rows) {
        if (level == 0) ok = false;
        break;
      }
      weights(__fsub_rn(cur.x, static_cast<float>(inx)),
              __fsub_rn(cur.y, static_cast<float>(iny)), iw);
      const unsigned char* dst = dst_level +
                                 static_cast<long long>(iny + win) * stride +
                                 inx + win;
      // every load first, then the arithmetic: one round of load latency
      int px[KPL][4];
#pragma unroll
      for (int k = 0; k < KPL; ++k) {
        const unsigned char* q = dst + off[k];
        px[k][0] = __ldg(q);
        px[k][1] = __ldg(q + 1);
        px[k][2] = __ldg(q + stride);
        px[k][3] = __ldg(q + stride + 1);
      }
      int t[2] = {0, 0};
#pragma unroll
      for (int k = 0; k < KPL; ++k) {
        const int jv = descale(px[k][0] * iw[0] + px[k][1] * iw[1] +
                                   px[k][2] * iw[2] + px[k][3] * iw[3],
                               kWBits - 5) -
                       ival[k];
        t[0] += jv * ix[k];
        t[1] += jv * iy[k];
      }
      long long b[2];
      point_sum<2, WPP>(t, b, sh, buf, wip, bar);
      const float b1 = __fmul_rn(__ll2float_rn(b[0]), kFltScale);
      const float b2 = __fmul_rn(__ll2float_rn(b[1]), kFltScale);
      const float dx = __fmul_rn(
          __fsub_rn(__fmul_rn(a12, b2), __fmul_rn(a22, b1)), inv);
      const float dy = __fmul_rn(
          __fsub_rn(__fmul_rn(a12, b1), __fmul_rn(a11, b2)), inv);
      cur = make_float2(__fadd_rn(cur.x, dx), __fadd_rn(cur.y, dy));
      nxt = make_float2(__fadd_rn(cur.x, half), __fadd_rn(cur.y, half));
      const double dd = __dadd_rn(
          __dmul_rn(static_cast<double>(dx), static_cast<double>(dx)),
          __dmul_rn(static_cast<double>(dy), static_cast<double>(dy)));
      if (dd <= eps2) break;
      if (j > 0 && static_cast<double>(fabsf(__fadd_rn(dx, pdx))) < 0.01 &&
          static_cast<double>(fabsf(__fadd_rn(dy, pdy))) < 0.01) {
        nxt = make_float2(__fsub_rn(nxt.x, __fmul_rn(dx, 0.5f)),
                          __fsub_rn(nxt.y, __fmul_rn(dy, 0.5f)));
        break;
      }
      pdx = dx;
      pdy = dy;
    }
  }
  *result = nxt;
  *status = ok;
}

// A CUDA block a point: WPP warps (named barrier 1), KPL window pixels a
// thread.
template <int KPL, int WPP>
__global__ void __launch_bounds__(32 * WPP)
    pyr_lk_kernel(const unsigned char* __restrict__ img_a,
                  const short* __restrict__ der_a,
                  const unsigned char* __restrict__ img_b,
                  const short* __restrict__ der_b,
                  const Level* __restrict__ levels, int n_levels, int win,
                  int max_iter, float min_eig, double eps2,
                  const float* __restrict__ pts, float* __restrict__ fwd,
                  unsigned char* __restrict__ st_fwd,
                  float* __restrict__ back,
                  unsigned char* __restrict__ st_back,
                  float* __restrict__ fb, int n) {
  __shared__ PointShared<WPP> shared;
  const int i = blockIdx.x, t = threadIdx.x, wip = t >> 5;
  int wyx[KPL];
#pragma unroll
  for (int k = 0; k < KPL; ++k) {
    const int p = t + 32 * WPP * k;
    wyx[k] = p < win * win ? (p / win) << 8 | p % win : -1;
  }
  const float2 p0 = make_float2(__ldg(pts + 2 * i), __ldg(pts + 2 * i + 1));
  float2 p1, q;
  bool s1, s2;
  int buf = 0;
  track<KPL, WPP>(img_a, der_a, img_b, levels, n_levels, win, max_iter,
                  min_eig, eps2, p0, wyx, shared, buf, wip, 1, &p1, &s1);
  track<KPL, WPP>(img_b, der_b, img_a, levels, n_levels, win, max_iter,
                  min_eig, eps2, p1, wyx, shared, buf, wip, 1, &q, &s2);
  if (t == 0) {
    fwd[2 * i] = p1.x;
    fwd[2 * i + 1] = p1.y;
    back[2 * i] = q.x;
    back[2 * i + 1] = q.y;
    st_fwd[i] = s1;
    st_back[i] = s2;
    const float dx = __fsub_rn(q.x, p0.x), dy = __fsub_rn(q.y, p0.y);
    fb[i] = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
  }
}

struct Args {
  const unsigned char* img_a;
  const short* der_a;
  const unsigned char* img_b;
  const short* der_b;
  const Level* levels;
  int n_levels, win, max_iter;
  float min_eig;
  double eps2;
  const float* pts;
  float* fwd;
  unsigned char* st_fwd;
  float* back;
  unsigned char* st_back;
  float* fb;
  int n;
};

template <int KPL, int WPP>
int launch(const Args& a, cudaStream_t stream) {
  pyr_lk_kernel<KPL, WPP><<<a.n, 32 * WPP, 0, stream>>>(
          a.img_a, a.der_a, a.img_b, a.der_b, a.levels, a.n_levels, a.win,
          a.max_iter, a.min_eig, a.eps2, a.pts, a.fwd, a.st_fwd, a.back,
          a.st_back, a.fb, a.n);
  cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : 1000 + static_cast<int>(e);
}

// Warps a point in the port (lk_cuda.POINT_WARPS;
// tools/ccl_lk_variants_torch.py times other forms).
constexpr int kWarpsPerPoint = 4;

}  // namespace lk

// levels: (n_levels, 4) int64 on the device (rows, cols, image offset,
// derivative offset), shared by both pyramids. kpl: window pixels a
// thread (lk_cuda.lane_pixels(win): 4 or 8, win * win <= 32 * 4 * kpl).
extern "C" int faceoff_pyr_lk(const unsigned char* img_a, const short* der_a,
                              const unsigned char* img_b, const short* der_b,
                              const long long* levels, int n_levels, int win,
                              int max_iter, float min_eig, double eps2,
                              const float* pts, float* fwd,
                              unsigned char* st_fwd, float* back,
                              unsigned char* st_back, float* fb, int n,
                              int kpl, void* stream_ptr) {
  if (n == 0) return 0;
  if (win * win > 32 * lk::kWarpsPerPoint * kpl) return 1;
  const lk::Args a{img_a, der_a, img_b, der_b,
                   reinterpret_cast<const lk::Level*>(levels), n_levels, win,
                   max_iter, min_eig, eps2, pts, fwd, st_fwd, back, st_back,
                   fb, n};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (kpl == 4) return lk::launch<4, lk::kWarpsPerPoint>(a, stream);
  if (kpl == 8) return lk::launch<8, lk::kWarpsPerPoint>(a, stream);
  return 1;
}
