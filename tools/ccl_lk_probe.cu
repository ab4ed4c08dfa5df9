// Variants of kernels A (connected components) and B (pyramidal
// Lucas-Kanade) of faceoff_tpu_torch/csrc/ccl.cu and csrc/lk.cu, built and
// timed by tools/ccl_lk_variants_torch.py beside the port's own kernels to
// find what bounds them on the card. Not used by the port. The port's
// sources are included, so their templates (ccl::launch<TBH, TBW>,
// lk::launch<KPL, WPP>) are instantiated here at other shapes.
//
// A variants (probe_ccl):
//   0 original    the first form of the port, copied below: union-
//                 find over pixels in global memory, a thread a pixel, a
//                 memset and four launches, six atomics a foreground pixel
//                 on its component's table slot
//   1..           ccl::launch<TBH, TBW> at PROBE_CCL's tile shapes (in 2 x 2
//                 blocks)
// B variants (probe_lk):
//   0 original    the first form of the port, copied below: a CUDA
//                 block of 448 threads a point, a pixel a thread, int64
//                 block sums through shared memory with two barriers
//   1..           lk::launch<KPL, WPP> at PROBE_LK's forms: KPL window
//                 pixels a thread, WPP warps a point (their sums added
//                 through shared memory after a named barrier)
// probe_link_chain: one warp running `links` dependent links of kernel
// B's iteration without its loads: the bilinear weights, the butterfly
// sums of two values and the float steps of the update. Its time a link
// is the least time one link of B can take: chip_smoke.py multiplies it
// by the longest point's setups and iterations (B's latency bound).

#include "../faceoff_tpu_torch/csrc/ccl.cu"
#include "../faceoff_tpu_torch/csrc/lk.cu"

#define PROBE_CCL(X) X(16, 32) X(16, 16) X(8, 32) X(32, 16) X(32, 32) X(8, 16)
#define PROBE_LK(X) X(4, 4) X(14, 1) X(7, 2) X(2, 8)

// ---- the port's first kernel A ------------------------------------------
namespace original_ccl {
namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int find_root(const int* parent, int x) {
  int p = __ldcg(parent + x);
  while (p != x) {
    x = p;
    p = __ldcg(parent + x);
  }
  return x;
}

__device__ void unite(int* parent, int a, int b) {
  while (true) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a == b) return;
    if (a > b) {
      int t = a;
      a = b;
      b = t;
    }
    int old = atomicMin(parent + b, a);
    if (old == b) return;  // b was a root and now hangs under a
    b = old;               // b moved meanwhile: retry from where it went
  }
}

__global__ void init_kernel(const unsigned char* mask, int* parent,
                            long long n) {
  long long p = blockIdx.x * static_cast<long long>(blockDim.x) +
                threadIdx.x;
  if (p >= n) return;
  parent[p] = mask[p] ? static_cast<int>(p) : -1;
}

__global__ void merge_kernel(const unsigned char* mask, int* parent, int h,
                             int w, long long n) {
  long long p = blockIdx.x * static_cast<long long>(blockDim.x) +
                threadIdx.x;
  if (p >= n || !mask[p]) return;
  int local = static_cast<int>(p % (static_cast<long long>(h) * w));
  int y = local / w, x = local % w;
  int me = static_cast<int>(p);
  if (x > 0 && mask[p - 1]) unite(parent, me, me - 1);
  if (y > 0) {
    long long up = p - w;
    if (x > 0 && mask[up - 1]) unite(parent, me, static_cast<int>(up - 1));
    if (mask[up]) unite(parent, me, static_cast<int>(up));
    if (x + 1 < w && mask[up + 1])
      unite(parent, me, static_cast<int>(up + 1));
  }
}

__global__ void flatten_kernel(int* parent, int* slot, int* count,
                               int* table, int capacity, long long n) {
  long long p = blockIdx.x * static_cast<long long>(blockDim.x) +
                threadIdx.x;
  if (p >= n) return;
  int q = parent[p];
  if (q < 0) return;
  int me = static_cast<int>(p);
  if (q != me) {
    parent[p] = find_root(parent, me);
    return;
  }
  int s = atomicAdd(count, 1);  // below capacity: see above
  slot[p] = s;
  table[s] = me;                            // root
  table[capacity + s] = INT_MAX;            // x0
  table[2 * capacity + s] = INT_MAX;        // y0
  table[3 * capacity + s] = -1;             // x1
  table[4 * capacity + s] = -1;             // y1
  table[5 * capacity + s] = 0;              // area
  table[6 * capacity + s] = INT_MAX;        // key
}

__global__ void stats_kernel(const int* parent, const int* slot, int* table,
                             int capacity, int h, int w, long long n) {
  long long p = blockIdx.x * static_cast<long long>(blockDim.x) +
                threadIdx.x;
  if (p >= n) return;
  int r = parent[p];
  if (r < 0) return;
  int s = slot[r];
  int local = static_cast<int>(p % (static_cast<long long>(h) * w));
  int y = local / w, x = local % w;
  atomicMin(table + capacity + s, x);
  atomicMin(table + 2 * capacity + s, y);
  atomicMax(table + 3 * capacity + s, x);
  atomicMax(table + 4 * capacity + s, y);
  atomicAdd(table + 5 * capacity + s, 1);
  atomicMin(table + 6 * capacity + s, (y / 2) * ((w + 1) / 2) + x / 2);
}

}  // namespace

int run(const unsigned char* mask, int* labels, int* slot, int* count,
        int* table, int capacity, int batch, int h, int w,
        cudaStream_t stream) {
  long long n = static_cast<long long>(batch) * h * w;
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(int), stream);
  if (e != cudaSuccess) return 1000 + static_cast<int>(e);
  if (n == 0) return 0;
  unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) /
                                                  kThreads);
  init_kernel<<<blocks, kThreads, 0, stream>>>(mask, labels, n);
  merge_kernel<<<blocks, kThreads, 0, stream>>>(mask, labels, h, w, n);
  flatten_kernel<<<blocks, kThreads, 0, stream>>>(labels, slot, count, table,
                                                  capacity, n);
  stats_kernel<<<blocks, kThreads, 0, stream>>>(labels, slot, table,
                                                capacity, h, w, n);
  e = cudaGetLastError();
  return e == cudaSuccess ? 0 : 1000 + static_cast<int>(e);
}

}  // namespace original_ccl

// ---- the port's first kernel B ------------------------------------------
namespace original_lk {
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

int run(const lk::Args& a, cudaStream_t stream) {
  int threads = ((a.win * a.win + 31) / 32) * 32;
  pyr_lk_kernel<<<a.n, threads, 0, stream>>>(
      a.img_a, a.der_a, a.img_b, a.der_b,
      reinterpret_cast<const Level*>(a.levels), a.n_levels, a.win,
      a.max_iter, a.min_eig, a.eps2, a.pts, a.fwd, a.st_fwd, a.back,
      a.st_back, a.fb);
  cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : 1000 + static_cast<int>(e);
}

}  // namespace original_lk

namespace probe {

// B's iteration without its loads, `links` times in a row on one warp.
// eps2 and cancel are -1 at run time, so neither test ends the chain, and
// the steps stay about 1e-4 px (the sums scaled by 2^-30), so the point
// never leaves the image.
__global__ void link_chain(int links, double eps2, double cancel,
                           float* out) {
  const int lane = threadIdx.x & 31;
  const float half = 10.f;
  float2 cur = make_float2(40.25f, 30.5f);
  const float a11 = 3.f, a12 = 0.25f, a22 = 2.5f;
  const float inv = __fdiv_rn(
      1.f, __fsub_rn(__fmul_rn(a11, a22), __fmul_rn(a12, a12)));
  float2 nxt = cur;
  float pdx = 0.f, pdy = 0.f;
  for (int j = 0; j < links; ++j) {
    int inx = static_cast<int>(floorf(cur.x));
    int iny = static_cast<int>(floorf(cur.y));
    if (inx < -21 || inx >= 4096 || iny < -21 || iny >= 4096) break;
    int iw[4];
    lk::weights(__fsub_rn(cur.x, static_cast<float>(inx)),
                __fsub_rn(cur.y, static_cast<float>(iny)), iw);
    int t[2] = {iw[0] - iw[3] + lane * 33, iw[1] - iw[2] - lane * 31};
    long long b[2];
    lk::warp_sum<2>(t, b);
    const float b1 = __fmul_rn(__ll2float_rn(b[0]), 0x1p-30f);
    const float b2 = __fmul_rn(__ll2float_rn(b[1]), 0x1p-30f);
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
    if (j > 0 && static_cast<double>(fabsf(__fadd_rn(dx, pdx))) < cancel &&
        static_cast<double>(fabsf(__fadd_rn(dy, pdy))) < cancel)
      break;
    pdx = dx;
    pdy = dy;
  }
  if (lane == 0) out[0] = __fadd_rn(nxt.x, nxt.y);
}

inline int status(cudaError_t e) {
  return e == cudaSuccess ? 0 : 1000 + static_cast<int>(e);
}

}  // namespace probe

extern "C" {

// Tile shapes (TBH, TBW) of variants 1.. of probe_ccl.
int probe_ccl_shapes(int* out, int max_shapes) {
  int i = 0;
#define SHAPE(H, W)      \
  if (i < max_shapes) {  \
    out[2 * i] = H;      \
    out[2 * i + 1] = W;  \
  }                      \
  ++i;
  PROBE_CCL(SHAPE)
#undef SHAPE
  return i;
}

// Variant 0 takes `slot` (one int a pixel) and writes its parents into
// `labels`; the others take parent, bits and stats as the port's.
int probe_ccl(int variant, const unsigned char* mask, int* labels,
              int* parent, unsigned char* bits, int* stats, int* slot,
              int* count, int* table, int capacity, int batch, int h, int w,
              cudaStream_t stream) {
  if (variant == 0)
    return original_ccl::run(mask, labels, slot, count, table, capacity,
                             batch, h, w, stream);
  int v = 1;
#define LAUNCH(H, W)                                                     \
  if (variant == v)                                                      \
    return ccl::launch<H, W>(mask, labels, parent, bits, stats, count,   \
                             table, capacity, batch, h, w, stream);      \
  ++v;
  PROBE_CCL(LAUNCH)
#undef LAUNCH
  return 1;
}

// Forms (KPL, WPP) of variants 1.. of probe_lk.
int probe_lk_forms(int* out, int max_forms) {
  int i = 0;
#define FORM(K, P)      \
  if (i < max_forms) {  \
    out[2 * i] = K;     \
    out[2 * i + 1] = P; \
  }                     \
  ++i;
  PROBE_LK(FORM)
#undef FORM
  return i;
}

// faceoff_pyr_lk's arguments; the forms need win * win <= 32 WPP KPL.
int probe_lk(int variant, const unsigned char* img_a, const short* der_a,
             const unsigned char* img_b, const short* der_b,
             const long long* levels, int n_levels, int win, int max_iter,
             float min_eig, double eps2, const float* pts, float* fwd,
             unsigned char* st_fwd, float* back, unsigned char* st_back,
             float* fb, int n, cudaStream_t stream) {
  if (n == 0) return 0;
  const lk::Args a{img_a, der_a, img_b, der_b,
                   reinterpret_cast<const lk::Level*>(levels), n_levels, win,
                   max_iter, min_eig, eps2, pts, fwd, st_fwd, back, st_back,
                   fb, n};
  if (variant == 0) return original_lk::run(a, stream);
  int v = 1;
#define LAUNCH(K, P)                      \
  if (variant == v) {                     \
    if (win * win > 32 * P * K) return 1; \
    return lk::launch<K, P>(a, stream);   \
  }                                       \
  ++v;
  PROBE_LK(LAUNCH)
#undef LAUNCH
  return 1;
}

// One warp, `links` links of B's iteration; out: one float.
int probe_link_chain(int links, float* out, cudaStream_t stream) {
  probe::link_chain<<<1, 32, 0, stream>>>(links, -1.0, -1.0, out);
  return probe::status(cudaGetLastError());
}

}  // extern "C"
