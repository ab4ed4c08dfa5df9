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
// Design: one block per point. Each thread owns one pixel of the window
// (win * win <= 1024) and keeps its interpolated image value and
// derivatives in registers across the iterations of a level. The 2 x 2
// system and the right-hand side are exact integer sums (a warp-shuffle
// reduction, then the warps' partial sums in shared memory, which every
// thread adds in the same order). Every thread then does the same float
// steps on the same sums, so the point's state needs no broadcast; thread
// 0 writes the results. The float steps use the _rn intrinsics: one IEEE
// operation each, never contracted into a fused multiply-add, so that
// they round as the plain torch version's do.
// Bound: operations. Per window pixel, setting up a level takes 33
// integer operations (three bilinear interpolations of 9, three products
// and their three block-sum adds) and each iteration 14 (one
// interpolation of 9, a subtraction, two products and two block-sum
// adds); chip_smoke.py counts them as LK_OPS_SETUP and LK_OPS_ITER.
//
// Returns 0 or 1000 + a cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int kWBits = 14;
constexpr int kMaxWarps = 32;
constexpr float kFltScale = 1.f / (1 << 20);
constexpr float kFltEpsilon = 1.1920928955078125e-07f;

struct Level {
  long long rows, cols, img_off, der_off;
};

struct Sums {
  long long v[3];
};

// Block-wide sums of up to three int64 values; every thread gets them.
template <int K>
__device__ Sums block_sum(Sums s, long long (*shared)[3]) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int n_warps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    long long v = s.v[k];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) shared[warp][k] = v;
  }
  __syncthreads();
  Sums out;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    long long t = 0;
    for (int w = 0; w < n_warps; ++w) t += shared[w][k];
    out.v[k] = t;
  }
  __syncthreads();
  return out;
}

__device__ __forceinline__ void weights(float a, float b, int* iw) {
  float ia = __fsub_rn(1.f, a), ib = __fsub_rn(1.f, b);
  iw[0] = __float2int_rn(__fmul_rn(__fmul_rn(ia, ib), 16384.f));
  iw[1] = __float2int_rn(__fmul_rn(__fmul_rn(a, ib), 16384.f));
  iw[2] = __float2int_rn(__fmul_rn(__fmul_rn(ia, b), 16384.f));
  iw[3] = (1 << kWBits) - iw[0] - iw[1] - iw[2];
}

__device__ __forceinline__ long long descale(long long v, int n) {
  return (v + (1LL << (n - 1))) >> n;
}

// Tracks `start` from image I (with derivatives dI) into image J; all
// threads of the block return the same point and status.
__device__ void track(const unsigned char* img_i, const short* der_i,
                      const unsigned char* img_j, const Level* levels,
                      int n_levels, int win, int max_iter, float min_eig,
                      double eps2, float2 start, float2* result,
                      bool* status, long long (*shared)[3]) {
  const float half = __fmul_rn(static_cast<float>(win - 1), 0.5f);
  const int tid = threadIdx.x;
  const bool owner = tid < win * win;
  const int wy = owner ? tid / win : 0, wx = owner ? tid % win : 0;
  bool ok = true;
  float2 nxt = make_float2(0.f, 0.f);
  for (int level = n_levels - 1; level >= 0; --level) {
    const Level lv = levels[level];
    const int rows = static_cast<int>(lv.rows);
    const int cols = static_cast<int>(lv.cols);
    const long long stride = lv.cols + 2 * win;
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
    long long ival = 0, ix = 0, iy = 0;
    Sums s = {{0, 0, 0}};
    if (owner) {
      long long p = (ipy + win + wy) * stride + ipx + win + wx;
      const unsigned char* src = img_i + lv.img_off;
      ival = descale(static_cast<long long>(src[p]) * iw[0] +
                         static_cast<long long>(src[p + 1]) * iw[1] +
                         static_cast<long long>(src[p + stride]) * iw[2] +
                         static_cast<long long>(src[p + stride + 1]) * iw[3],
                     kWBits - 5);
      const short* d = der_i + lv.der_off;
      long long q = 2 * p, qs = 2 * stride;
      ix = descale(static_cast<long long>(d[q]) * iw[0] +
                       static_cast<long long>(d[q + 2]) * iw[1] +
                       static_cast<long long>(d[q + qs]) * iw[2] +
                       static_cast<long long>(d[q + qs + 2]) * iw[3],
                   kWBits);
      iy = descale(static_cast<long long>(d[q + 1]) * iw[0] +
                       static_cast<long long>(d[q + 3]) * iw[1] +
                       static_cast<long long>(d[q + qs + 1]) * iw[2] +
                       static_cast<long long>(d[q + qs + 3]) * iw[3],
                   kWBits);
      s.v[0] = ix * ix;
      s.v[1] = ix * iy;
      s.v[2] = iy * iy;
    }
    s = block_sum<3>(s, shared);
    const float a11 = __fmul_rn(__ll2float_rn(s.v[0]), kFltScale);
    const float a12 = __fmul_rn(__ll2float_rn(s.v[1]), kFltScale);
    const float a22 = __fmul_rn(__ll2float_rn(s.v[2]), kFltScale);
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
    const unsigned char* dst = img_j + lv.img_off;
    for (int j = 0; j < max_iter; ++j) {
      int inx = static_cast<int>(floorf(cur.x));
      int iny = static_cast<int>(floorf(cur.y));
      if (inx < -win || inx >= cols || iny < -win || iny >= rows) {
        if (level == 0) ok = false;
        break;
      }
      weights(__fsub_rn(cur.x, static_cast<float>(inx)),
              __fsub_rn(cur.y, static_cast<float>(iny)), iw);
      Sums b = {{0, 0, 0}};
      if (owner) {
        long long p = (iny + win + wy) * stride + inx + win + wx;
        long long jv =
            descale(static_cast<long long>(dst[p]) * iw[0] +
                        static_cast<long long>(dst[p + 1]) * iw[1] +
                        static_cast<long long>(dst[p + stride]) * iw[2] +
                        static_cast<long long>(dst[p + stride + 1]) * iw[3],
                    kWBits - 5) -
            ival;
        b.v[0] = jv * ix;
        b.v[1] = jv * iy;
      }
      b = block_sum<2>(b, shared);
      const float b1 = __fmul_rn(__ll2float_rn(b.v[0]), kFltScale);
      const float b2 = __fmul_rn(__ll2float_rn(b.v[1]), kFltScale);
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

__global__ void pyr_lk_kernel(const unsigned char* img_a, const short* der_a,
                              const unsigned char* img_b, const short* der_b,
                              const Level* levels, int n_levels, int win,
                              int max_iter, float min_eig, double eps2,
                              const float* pts, float* fwd,
                              unsigned char* st_fwd, float* back,
                              unsigned char* st_back, float* fb) {
  __shared__ long long shared[kMaxWarps][3];
  const int i = blockIdx.x;
  const float2 p0 = make_float2(pts[2 * i], pts[2 * i + 1]);
  float2 p1, q;
  bool s1, s2;
  track(img_a, der_a, img_b, levels, n_levels, win, max_iter, min_eig, eps2,
        p0, &p1, &s1, shared);
  track(img_b, der_b, img_a, levels, n_levels, win, max_iter, min_eig, eps2,
        p1, &q, &s2, shared);
  if (threadIdx.x == 0) {
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

}  // namespace

// levels: (n_levels, 4) int64 on the device (rows, cols, image offset,
// derivative offset), shared by both pyramids.
extern "C" int faceoff_pyr_lk(const unsigned char* img_a, const short* der_a,
                              const unsigned char* img_b, const short* der_b,
                              const long long* levels, int n_levels, int win,
                              int max_iter, float min_eig, double eps2,
                              const float* pts, float* fwd,
                              unsigned char* st_fwd, float* back,
                              unsigned char* st_back, float* fb, int n,
                              void* stream_ptr) {
  if (n == 0) return 0;
  int threads = ((win * win + 31) / 32) * 32;
  pyr_lk_kernel<<<n, threads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      img_a, der_a, img_b, der_b, reinterpret_cast<const Level*>(levels),
      n_levels, win, max_iter, min_eig, eps2, pts, fwd, st_fwd, back, st_back,
      fb);
  cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : 1000 + static_cast<int>(e);
}
