// Variants of the bilinear warp, built and timed by
// tools/warp_variants_torch.py beside the port's kernels
// (faceoff_tpu_torch/csrc/warp.cu) to find what bounds the warp on the
// card. Not used by the port. All over NHWC float32 at coordinates xs/ys.
//
// Forward variants:
//   0 direct      one thread per output pixel, four scalar gathers per
//                 channel in a loop over a runtime C, scalar stores at the
//                 pixel stride
//   1 direct_c3   the same with C = 3 at compile time, unrolled (the
//                 port's forward at C = 3)
//   2 loads_c3    direct_c3's coordinate loads and gathers; stores only
//                 where the sum equals an impossible value (never)
//   3 stores_c3   direct_c3's coordinate loads and scalar stores, no
//                 gathers
//   4 copy        a streaming pass over the same bytes: coordinates read,
//                 the image read and the output written with 16-byte
//                 accesses (what the card's memory allows)
//   5 vec4        four adjacent pixels a thread (C = 3): 16-byte coordinate
//                 loads, three 16-byte stores
//   6 staged      16 x 16 tiles of direct gathers (C = 3), outputs through
//                 shared memory with 16-byte stores
//   7 window      16 x 16 tiles (C = 3): coordinates by 16-byte loads, the
//                 tile's source footprint staged in shared memory with
//                 cp.async, taps read from it, outputs stored 16 bytes at a
//                 time; tiles whose footprint does not fit gather directly
// Backward variants:
//   0 direct      one thread per output pixel, scalar global atomicAdd
//                 per tap and channel, and four gathers per channel for
//                 d_xs/d_ys (the port's backward on tiles that splat
//                 directly)
//   1 stores      the same with plain stores in place of the atomics
//                 (wrong where taps collide: timing only)
//   2 no_atomics  d_xs/d_ys only (the gathers, no splat)
//   3 red6        direct, with each tap row's two pixels (six contiguous
//                 floats at C = 3) added by float2/float4 vector atomics
//   4 hybrid      16 x 16 tiles: d_xs/d_ys from direct gathers, the splat
//                 added into a shared-memory window with float atomics,
//                 flushed into d_img with vector atomics
//   5 hybrid_noflush  the same without the flush (timing only)
//   6 hybrid_scalar   the same with a scalar-atomic flush

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

// -- a first tiled design: 16 x 16 output tiles whose source footprint is
// staged in a shared-memory window (cp.async), outputs and g moved with
// 16-byte accesses, and the splat accumulated in the window with
// shared-memory float atomics, then flushed with global atomics
// (forward variant 7, backward variants 4-6)

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;  // one thread per output pixel
constexpr int kWarps = kThreads / 32;
constexpr int kWindowFloats = 4096;       // 16 KB: the source window
constexpr int kStageChannels = 4;         // outputs / g staged for C <= 4
constexpr int kStageFloats = kThreads * kStageChannels;

// The window of a tile's source footprint. Pixel (y, x), channel ch of the
// frame lives at win[(y - y0) * stride + pad + (x - x0) * c + ch].
struct Window {
  int x0, y0;      // footprint origin
  int bw, bh;      // footprint size in pixels
  int stride;      // floats a window row, congruent to w * c modulo 4
  int pad;         // congruent to the global word address of (y0, x0, 0)
  bool fits;       // bh * stride <= kWindowFloats
};

__device__ __forceinline__ int tap_origin(float v, int n) {
  return static_cast<int>(fminf(fmaxf(floorf(v), -2.0f),
                                static_cast<float>(n)));
}

__device__ __forceinline__ unsigned word_residue(const float* p) {
  return static_cast<unsigned>(reinterpret_cast<uintptr_t>(p) >> 2) & 3u;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The tile's footprint from each thread's clipped tap origins (xi, yi);
// threads without a pixel pass valid = false. All threads of the block
// call it. The footprint rule's plain twin is
// faceoff_tpu_torch/ops/warp_cuda.py::tile_footprints.
__device__ Window tile_window(int xi, int yi, bool valid, const float* img,
                              long long frame_words, int w, int c,
                              int* red) {
  int v[4] = {valid ? xi : INT_MAX, valid ? -xi : INT_MAX,
              valid ? yi : INT_MAX, valid ? -yi : INT_MAX};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = __reduce_min_sync(0xffffffffu, v[k]);
    if (lane == 0) red[k * kWarps + warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = red[k * kWarps];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) v[k] = min(v[k], red[k * kWarps + i]);
  }
  Window b;
  b.x0 = v[0];
  b.y0 = v[2];
  b.bw = -v[1] - v[0] + 2;
  b.bh = -v[3] - v[2] + 2;
  long long stride = static_cast<long long>(b.bw) * c + 3;
  stride += (static_cast<long long>(w) * c - stride) & 3;
  b.fits = static_cast<long long>(b.bh) * stride <= kWindowFloats;
  b.stride = b.fits ? static_cast<int>(stride) : 0;
  const long long origin = static_cast<long long>(word_residue(img)) +
                           frame_words +
                           static_cast<long long>(b.y0) * w * c +
                           static_cast<long long>(b.x0) * c;
  b.pad = static_cast<int>(origin & 3);
  return b;
}

// The inside columns [xl, xh] of a window row (xl > xh: none).
__device__ __forceinline__ void inside_columns(const Window& b, int w, int* xl,
                                               int* xh) {
  *xl = max(b.x0, 0);
  *xh = min(b.x0 + b.bw - 1, w - 1);
}

// Copies the footprint of one frame `src` (h x w x c) into `win`, zero where
// it leaves the image; returns after the copies have landed and the block
// has synchronised. One warp a row.
__device__ void stage_window(const float* __restrict__ src, float* win,
                             const Window& b, int h, int w, int c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row_len = b.bw * c;
  int xl, xh;
  inside_columns(b, w, &xl, &xh);
  for (int v = warp; v < b.bh; v += kWarps) {
    const int y = b.y0 + v;
    float* row = win + v * b.stride + b.pad;
    int jl = 0, jh = 0;
    if (y >= 0 && y < h && xl <= xh) {
      jl = (xl - b.x0) * c;
      jh = (xh + 1 - b.x0) * c;
    }
    for (int j = lane; j < jl; j += 32) row[j] = 0.0f;
    for (int j = jh + lane; j < row_len; j += 32) row[j] = 0.0f;
    if (jl < jh) {
      const float* g = src + (static_cast<long long>(y) * w + xl) * c;
      float* s = row + jl;
      const int len = jh - jl;
      const int head = min(len, static_cast<int>((4u - word_residue(g)) & 3u));
      const int body = (len - head) >> 2;
      const int tail = head + 4 * body;
      if (lane < head) cp_async4(s + lane, g + lane);
      for (int k = lane; k < body; k += 32) {
        cp_async16(s + head + 4 * k, g + head + 4 * k);
      }
      if (tail + lane < len) cp_async4(s + tail + lane, g + tail + lane);
    }
  }
  cp_async_wait_all();
  __syncthreads();
}

// Loads the tile's coordinates: 16-byte loads where every tile row starts
// 16-byte aligned, else one per pixel. Returns this thread's (x, y).
__device__ __forceinline__ void load_coords(const float* __restrict__ xs,
                                            const float* __restrict__ ys,
                                            long long frame, int oh, int ow,
                                            int ox0, int oy0, bool valid,
                                            float* sxy, float* x, float* y) {
  const bool vec = (ow & 3) == 0 && word_residue(xs) == 0 &&
                   word_residue(ys) == 0;
  const int t = threadIdx.x;
  if (vec) {
    // threads 0-63 take xs, 64-127 ys: four pixels of one tile row each
    if (t < 2 * kTile * kTile / 4) {
      const int which = t / (kTile * kTile / 4);
      const int q = t % (kTile * kTile / 4);
      const int r = q / (kTile / 4), col = 4 * (q % (kTile / 4));
      if (oy0 + r < oh && ox0 + col < ow) {
        const float* src = which == 0 ? xs : ys;
        const float4 v = __ldg(reinterpret_cast<const float4*>(
            src + (frame * oh + oy0 + r) * ow + ox0 + col));
        float* d = sxy + which * kThreads + r * kTile + col;
        d[0] = v.x;
        d[1] = v.y;
        d[2] = v.z;
        d[3] = v.w;
      }
    }
    __syncthreads();
    *x = valid ? sxy[t] : 0.0f;
    *y = valid ? sxy[kThreads + t] : 0.0f;
  } else if (valid) {
    const long long p = (frame * oh + oy0 + t / kTile) * ow + ox0 + t % kTile;
    *x = __ldg(xs + p);
    *y = __ldg(ys + p);
  } else {
    *x = *y = 0.0f;
  }
}

// Moves the tile's C <= 4 floats a pixel between global memory (rows of
// the output grid) and `stage` (pixel t at stage[t * c]): 16-byte global
// accesses where aligned. One warp a tile row.
template <bool kToGlobal>
__device__ void move_rows(float* __restrict__ glob, float* stage,
                          long long frame, int oh, int ow, int ox0, int oy0,
                          int c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int len = min(kTile, ow - ox0) * c;
  for (int r = warp; r < kTile && oy0 + r < oh; r += kWarps) {
    float* g = glob + ((frame * oh + oy0 + r) * ow + ox0) * c;
    float* s = stage + r * kTile * c;
    const int head = min(len, static_cast<int>((4u - word_residue(g)) & 3u));
    const int body = (len - head) >> 2;
    const int tail = head + 4 * body;
    for (int j = lane; j < head; j += 32) {
      if (kToGlobal) g[j] = s[j]; else s[j] = g[j];
    }
    for (int k = lane; k < body; k += 32) {
      float4* gv = reinterpret_cast<float4*>(g + head + 4 * k);
      float* sv = s + head + 4 * k;
      if (kToGlobal) {
        *gv = make_float4(sv[0], sv[1], sv[2], sv[3]);
      } else {
        const float4 v = __ldg(gv);
        sv[0] = v.x;
        sv[1] = v.y;
        sv[2] = v.z;
        sv[3] = v.w;
      }
    }
    for (int j = tail + lane; j < len; j += 32) {
      if (kToGlobal) g[j] = s[j]; else s[j] = g[j];
    }
  }
}

// A pixel's four taps read directly from global memory: the offsets of
// their pixels (clipped into the image) and their inside tests.
struct DirectTaps {
  bool in00, in01, in10, in11;
  long long o00, o01, o10, o11;
};

__device__ __forceinline__ DirectTaps direct_taps(float x0, float y0,
                                                  long long frame, int h,
                                                  int w, int c) {
  DirectTaps t;
  const float x1 = x0 + 1.0f, y1 = y0 + 1.0f;
  const float wmax = static_cast<float>(w - 1);
  const float hmax = static_cast<float>(h - 1);
  const bool mx0 = (x0 >= 0.0f) && (x0 <= wmax);
  const bool mx1 = (x1 >= 0.0f) && (x1 <= wmax);
  const bool my0 = (y0 >= 0.0f) && (y0 <= hmax);
  const bool my1 = (y1 >= 0.0f) && (y1 <= hmax);
  t.in00 = mx0 && my0;
  t.in01 = mx1 && my0;
  t.in10 = mx0 && my1;
  t.in11 = mx1 && my1;
  // clip in float before converting, so far-away coordinates stay in range
  const int xi0 = static_cast<int>(fminf(fmaxf(x0, 0.0f), wmax));
  const int xi1 = static_cast<int>(fminf(fmaxf(x1, 0.0f), wmax));
  const int yi0 = static_cast<int>(fminf(fmaxf(y0, 0.0f), hmax));
  const int yi1 = static_cast<int>(fminf(fmaxf(y1, 0.0f), hmax));
  const long long base = frame * h * w * c;
  t.o00 = base + (static_cast<long long>(yi0) * w + xi0) * c;
  t.o01 = base + (static_cast<long long>(yi0) * w + xi1) * c;
  t.o10 = base + (static_cast<long long>(yi1) * w + xi0) * c;
  t.o11 = base + (static_cast<long long>(yi1) * w + xi1) * c;
  return t;
}

template <int kC>
__global__ void __launch_bounds__(kThreads)
    window_forward(const float* __restrict__ img, const float* __restrict__ xs,
                 const float* __restrict__ ys, float* __restrict__ out,
                 int h, int w, int c_rt, int oh, int ow) {
  __shared__ __align__(16) float win[kWindowFloats];
  __shared__ __align__(16) float stage[kStageFloats];
  __shared__ __align__(16) float sxy[2 * kThreads];
  __shared__ int red[4 * kWarps];
  const int c = kC > 0 ? kC : c_rt;
  const int t = threadIdx.x;
  const int ox0 = blockIdx.x * kTile, oy0 = blockIdx.y * kTile;
  const int ox = ox0 + t % kTile, oy = oy0 + t / kTile;
  const long long frame = blockIdx.z;
  const bool valid = ox < ow && oy < oh;
  const long long frame_words = frame * h * w * c;

  float x, y;
  load_coords(xs, ys, frame, oh, ow, ox0, oy0, valid, sxy, &x, &y);
  const float fx = floorf(x), fy = floorf(y);
  const float dx = x - fx, dy = y - fy;
  const int xi = tap_origin(x, w), yi = tap_origin(y, h);
  const Window b = tile_window(xi, yi, valid, img, frame_words, w, c, red);
  const bool staged = c <= kStageChannels;
  float* dst = staged ? stage + t * c
                      : out + ((frame * oh + oy) * ow + ox) * c;

  if (b.fits) {
    stage_window(img + frame_words, win, b, h, w, c);
    if (valid) {
      const float* p0 = win + (yi - b.y0) * b.stride + b.pad + (xi - b.x0) * c;
      const float* p1 = p0 + b.stride;
#pragma unroll
      for (int ch = 0; ch < (kC > 0 ? kC : c); ++ch) {
        const float top = p0[ch] * (1.0f - dx) + p0[c + ch] * dx;
        const float bot = p1[ch] * (1.0f - dx) + p1[c + ch] * dx;
        dst[ch] = top * (1.0f - dy) + bot * dy;
      }
    }
  } else if (valid) {
    const DirectTaps d = direct_taps(fx, fy, frame, h, w, c);
#pragma unroll
    for (int ch = 0; ch < (kC > 0 ? kC : c); ++ch) {
      const float v00 = d.in00 ? __ldg(img + d.o00 + ch) : 0.0f;
      const float v01 = d.in01 ? __ldg(img + d.o01 + ch) : 0.0f;
      const float v10 = d.in10 ? __ldg(img + d.o10 + ch) : 0.0f;
      const float v11 = d.in11 ? __ldg(img + d.o11 + ch) : 0.0f;
      const float top = v00 * (1.0f - dx) + v01 * dx;
      const float bot = v10 * (1.0f - dx) + v11 * dx;
      dst[ch] = top * (1.0f - dy) + bot * dy;
    }
  }
  if (staged) {
    __syncthreads();
    move_rows<true>(out, stage, frame, oh, ow, ox0, oy0, c);
  }
}

// Adds the window's inside pixels into d_img (one frame): 16-byte vector
// atomics where the global address is 16-byte aligned (the window's shared
// address then is too, when d_img and img start at the same residue modulo
// 16 bytes; else all scalar), scalar atomics at the row ends; zero values
// and chunks that are all zero are skipped. One warp a row.
__device__ void flush_window(float* __restrict__ dst, const float* win,
                             const Window& b, int h, int w, int c,
                             bool vec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int xl, xh;
  inside_columns(b, w, &xl, &xh);
  if (xl > xh) return;
  const int len = (xh + 1 - xl) * c;
  for (int v = warp; v < b.bh; v += kWarps) {
    const int y = b.y0 + v;
    if (y < 0 || y >= h) continue;
    float* g = dst + (static_cast<long long>(y) * w + xl) * c;
    const float* s = win + v * b.stride + b.pad + (xl - b.x0) * c;
    if (!vec) {
      for (int j = lane; j < len; j += 32) {
        if (s[j] != 0.0f) atomicAdd(g + j, s[j]);
      }
      continue;
    }
    const int head = min(len, static_cast<int>((4u - word_residue(g)) & 3u));
    const int body = (len - head) >> 2;
    const int tail = head + 4 * body;
    if (lane < head && s[lane] != 0.0f) atomicAdd(g + lane, s[lane]);
    for (int k = lane; k < body; k += 32) {
      const float4 val = *reinterpret_cast<const float4*>(s + head + 4 * k);
      if (val.x != 0.0f || val.y != 0.0f || val.z != 0.0f || val.w != 0.0f) {
        atomicAdd(reinterpret_cast<float4*>(g + head + 4 * k), val);
      }
    }
    const int j = tail + lane;
    if (j < len && s[j] != 0.0f) atomicAdd(g + j, s[j]);
  }
}


dim3 tiles(int n, int oh, int ow) {
  return dim3((ow + kTile - 1) / kTile, (oh + kTile - 1) / kTile, n);
}

// -- one thread per output pixel


constexpr int kProbeThreads = 128;

struct Taps {
  float dx, dy;
  bool in00, in01, in10, in11;
  long long o00, o01, o10, o11;  // element offsets of the taps' pixels
};

__device__ __forceinline__ Taps taps_of(float x, float y, long long frame,
                                        int h, int w, int c) {
  Taps t;
  const float x0 = floorf(x), y0 = floorf(y);
  t.dx = x - x0;
  t.dy = y - y0;
  const float x1 = x0 + 1.0f, y1 = y0 + 1.0f;
  const float wmax = static_cast<float>(w - 1);
  const float hmax = static_cast<float>(h - 1);
  const bool mx0 = (x0 >= 0.0f) && (x0 <= wmax);
  const bool mx1 = (x1 >= 0.0f) && (x1 <= wmax);
  const bool my0 = (y0 >= 0.0f) && (y0 <= hmax);
  const bool my1 = (y1 >= 0.0f) && (y1 <= hmax);
  t.in00 = mx0 && my0;
  t.in01 = mx1 && my0;
  t.in10 = mx0 && my1;
  t.in11 = mx1 && my1;
  const int xi0 = static_cast<int>(fminf(fmaxf(x0, 0.0f), wmax));
  const int xi1 = static_cast<int>(fminf(fmaxf(x1, 0.0f), wmax));
  const int yi0 = static_cast<int>(fminf(fmaxf(y0, 0.0f), hmax));
  const int yi1 = static_cast<int>(fminf(fmaxf(y1, 0.0f), hmax));
  const long long base = frame * h * w * c;
  t.o00 = base + (static_cast<long long>(yi0) * w + xi0) * c;
  t.o01 = base + (static_cast<long long>(yi0) * w + xi1) * c;
  t.o10 = base + (static_cast<long long>(yi1) * w + xi0) * c;
  t.o11 = base + (static_cast<long long>(yi1) * w + xi1) * c;
  return t;
}

template <int kVariant, int kC>
__global__ void forward_kernel(const float* __restrict__ img,
                               const float* __restrict__ xs,
                               const float* __restrict__ ys,
                               float* __restrict__ out, int h, int w,
                               int c_rt, int oh, int ow) {
  const int c = kC > 0 ? kC : c_rt;
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  if (ox >= ow) return;
  const long long frame = blockIdx.z;
  const long long p = (frame * oh + blockIdx.y) * ow + ox;
  const float x = xs[p], y = ys[p];
  float* dst = out + p * c;
  if (kVariant == 3) {
#pragma unroll
    for (int ch = 0; ch < (kC > 0 ? kC : 1); ++ch) dst[ch] = x + y * ch;
    return;
  }
  const Taps t = taps_of(x, y, frame, h, w, c);
  float sum = 0.0f;
#pragma unroll
  for (int ch = 0; ch < (kC > 0 ? kC : 1); ++ch) {
    const float v00 = t.in00 ? __ldg(img + t.o00 + ch) : 0.0f;
    const float v01 = t.in01 ? __ldg(img + t.o01 + ch) : 0.0f;
    const float v10 = t.in10 ? __ldg(img + t.o10 + ch) : 0.0f;
    const float v11 = t.in11 ? __ldg(img + t.o11 + ch) : 0.0f;
    const float top = v00 * (1.0f - t.dx) + v01 * t.dx;
    const float bot = v10 * (1.0f - t.dx) + v11 * t.dx;
    const float v = top * (1.0f - t.dy) + bot * t.dy;
    if (kVariant == 2) {
      sum += v;
    } else {
      dst[ch] = v;
    }
  }
  if (kVariant == 2 && sum == -1.2345e30f) dst[0] = sum;
}

// the generic-C loop of variant 0 (kC == 0 unrolls one channel)
__global__ void direct_any_c(const float* __restrict__ img,
                             const float* __restrict__ xs,
                             const float* __restrict__ ys,
                             float* __restrict__ out, int h, int w, int c,
                             int oh, int ow) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  if (ox >= ow) return;
  const long long frame = blockIdx.z;
  const long long p = (frame * oh + blockIdx.y) * ow + ox;
  const Taps t = taps_of(xs[p], ys[p], frame, h, w, c);
  float* dst = out + p * c;
  for (int ch = 0; ch < c; ++ch) {
    const float v00 = t.in00 ? __ldg(img + t.o00 + ch) : 0.0f;
    const float v01 = t.in01 ? __ldg(img + t.o01 + ch) : 0.0f;
    const float v10 = t.in10 ? __ldg(img + t.o10 + ch) : 0.0f;
    const float v11 = t.in11 ? __ldg(img + t.o11 + ch) : 0.0f;
    const float top = v00 * (1.0f - t.dx) + v01 * t.dx;
    const float bot = v10 * (1.0f - t.dx) + v11 * t.dx;
    dst[ch] = top * (1.0f - t.dy) + bot * t.dy;
  }
}

// variant 4: float4 streams over coordinates, image and output
__global__ void copy_kernel(const float4* __restrict__ img,
                            const float4* __restrict__ xs,
                            const float4* __restrict__ ys,
                            float4* __restrict__ out, long long n_img4,
                            long long n_coord4, long long n_out4) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  float acc = 0.0f;
  for (long long i = blockIdx.x * blockDim.x + threadIdx.x; i < n_out4;
       i += stride) {
    const float4 a = i < n_img4 ? __ldg(img + i) : make_float4(0, 0, 0, 0);
    float4 b = make_float4(0, 0, 0, 0);
    if (i < n_coord4) {
      const float4 u = __ldg(xs + i), v = __ldg(ys + i);
      b = make_float4(u.x + v.x, u.y + v.y, u.z + v.z, u.w + v.w);
    }
    out[i] = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
    acc += a.x;
  }
  if (acc == -1.2345e30f) out[0].x = acc;
}

template <int kVariant>
__global__ void backward_kernel(const float* __restrict__ img,
                                const float* __restrict__ xs,
                                const float* __restrict__ ys,
                                const float* __restrict__ g,
                                float* __restrict__ d_img,
                                float* __restrict__ d_xs,
                                float* __restrict__ d_ys, int h, int w, int c,
                                int oh, int ow) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  if (ox >= ow) return;
  const long long frame = blockIdx.z;
  const long long p = (frame * oh + blockIdx.y) * ow + ox;
  const Taps t = taps_of(xs[p], ys[p], frame, h, w, c);
  const float* gp = g + p * c;
  const float w00 = (1.0f - t.dx) * (1.0f - t.dy), w01 = t.dx * (1.0f - t.dy);
  const float w10 = (1.0f - t.dx) * t.dy, w11 = t.dx * t.dy;
  float gx = 0.0f, gy = 0.0f;
  for (int ch = 0; ch < c; ++ch) {
    const float gv = gp[ch];
    if (kVariant == 0) {
      if (t.in00) atomicAdd(d_img + t.o00 + ch, gv * w00);
      if (t.in01) atomicAdd(d_img + t.o01 + ch, gv * w01);
      if (t.in10) atomicAdd(d_img + t.o10 + ch, gv * w10);
      if (t.in11) atomicAdd(d_img + t.o11 + ch, gv * w11);
    } else if (kVariant == 1) {
      if (t.in00) d_img[t.o00 + ch] = gv * w00;
      if (t.in01) d_img[t.o01 + ch] = gv * w01;
      if (t.in10) d_img[t.o10 + ch] = gv * w10;
      if (t.in11) d_img[t.o11 + ch] = gv * w11;
    }
    const float v00 = t.in00 ? __ldg(img + t.o00 + ch) : 0.0f;
    const float v01 = t.in01 ? __ldg(img + t.o01 + ch) : 0.0f;
    const float v10 = t.in10 ? __ldg(img + t.o10 + ch) : 0.0f;
    const float v11 = t.in11 ? __ldg(img + t.o11 + ch) : 0.0f;
    const float top = v00 * (1.0f - t.dx) + v01 * t.dx;
    const float bot = v10 * (1.0f - t.dx) + v11 * t.dx;
    gx += gv * ((v01 - v00) * (1.0f - t.dy) + (v11 - v10) * t.dy);
    gy += gv * (bot - top);
  }
  d_xs[p] = gx;
  d_ys[p] = gy;
}

// forward variant 5: four horizontally adjacent pixels a thread, C = 3;
// coordinates as one 16-byte load each, outputs as three 16-byte stores
// (ow a multiple of 4, 16-byte aligned buffers)
__global__ void __launch_bounds__(kProbeThreads)
    vec4_forward(const float* __restrict__ img, const float* __restrict__ xs,
                 const float* __restrict__ ys, float* __restrict__ out, int h,
                 int w, int oh, int ow) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (4 * q >= ow) return;
  const long long frame = blockIdx.z;
  const long long p = (frame * oh + blockIdx.y) * ow + 4 * q;
  const float4 xv = __ldg(reinterpret_cast<const float4*>(xs + p));
  const float4 yv = __ldg(reinterpret_cast<const float4*>(ys + p));
  const float px[4] = {xv.x, xv.y, xv.z, xv.w};
  const float py[4] = {yv.x, yv.y, yv.z, yv.w};
  float o[12];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const Taps t = taps_of(px[k], py[k], frame, h, w, 3);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float v00 = t.in00 ? __ldg(img + t.o00 + ch) : 0.0f;
      const float v01 = t.in01 ? __ldg(img + t.o01 + ch) : 0.0f;
      const float v10 = t.in10 ? __ldg(img + t.o10 + ch) : 0.0f;
      const float v11 = t.in11 ? __ldg(img + t.o11 + ch) : 0.0f;
      const float top = v00 * (1.0f - t.dx) + v01 * t.dx;
      const float bot = v10 * (1.0f - t.dx) + v11 * t.dx;
      o[3 * k + ch] = top * (1.0f - t.dy) + bot * t.dy;
    }
  }
  float4* dst = reinterpret_cast<float4*>(out + p * 3);
  dst[0] = make_float4(o[0], o[1], o[2], o[3]);
  dst[1] = make_float4(o[4], o[5], o[6], o[7]);
  dst[2] = make_float4(o[8], o[9], o[10], o[11]);
}

// forward variant 6: the port's 16 x 16 tiles with direct gathers only
// (C = 3), outputs staged in shared memory and stored 16 bytes at a time
__global__ void __launch_bounds__(kThreads)
    staged_forward(const float* __restrict__ img, const float* __restrict__ xs,
                   const float* __restrict__ ys, float* __restrict__ out,
                   int h, int w, int oh, int ow) {
  __shared__ __align__(16) float stage[kThreads * 3];
  const int t = threadIdx.x;
  const int ox0 = blockIdx.x * kTile, oy0 = blockIdx.y * kTile;
  const int ox = ox0 + t % kTile, oy = oy0 + t / kTile;
  const long long frame = blockIdx.z;
  if (ox < ow && oy < oh) {
    const long long p = (frame * oh + oy) * ow + ox;
    const Taps tp = taps_of(__ldg(xs + p), __ldg(ys + p), frame, h, w, 3);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float v00 = tp.in00 ? __ldg(img + tp.o00 + ch) : 0.0f;
      const float v01 = tp.in01 ? __ldg(img + tp.o01 + ch) : 0.0f;
      const float v10 = tp.in10 ? __ldg(img + tp.o10 + ch) : 0.0f;
      const float v11 = tp.in11 ? __ldg(img + tp.o11 + ch) : 0.0f;
      const float top = v00 * (1.0f - tp.dx) + v01 * tp.dx;
      const float bot = v10 * (1.0f - tp.dx) + v11 * tp.dx;
      stage[3 * t + ch] = top * (1.0f - tp.dy) + bot * tp.dy;
    }
  }
  __syncthreads();
  move_rows<true>(out, stage, frame, oh, ow, ox0, oy0, 3);
}

// Adds six floats into p[0..5] with the fewest aligned vector atomics.
__device__ __forceinline__ void red6(float* p, const float* v) {
  switch (word_residue(p)) {
    case 0:
      atomicAdd(reinterpret_cast<float4*>(p),
                make_float4(v[0], v[1], v[2], v[3]));
      atomicAdd(reinterpret_cast<float2*>(p + 4), make_float2(v[4], v[5]));
      break;
    case 1:
      atomicAdd(p, v[0]);
      atomicAdd(reinterpret_cast<float2*>(p + 1), make_float2(v[1], v[2]));
      atomicAdd(reinterpret_cast<float2*>(p + 3), make_float2(v[3], v[4]));
      atomicAdd(p + 5, v[5]);
      break;
    case 2:
      atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
      atomicAdd(reinterpret_cast<float4*>(p + 2),
                make_float4(v[2], v[3], v[4], v[5]));
      break;
    default:
      atomicAdd(p, v[0]);
      atomicAdd(reinterpret_cast<float4*>(p + 1),
                make_float4(v[1], v[2], v[3], v[4]));
      atomicAdd(p + 5, v[5]);
  }
}

// backward variant 3: the direct backward (C = 3) with each tap row's two
// pixels, six contiguous floats, added by vector atomics (red6)
__global__ void __launch_bounds__(kProbeThreads)
    red6_backward(const float* __restrict__ img, const float* __restrict__ xs,
                  const float* __restrict__ ys, const float* __restrict__ g,
                  float* __restrict__ d_img, float* __restrict__ d_xs,
                  float* __restrict__ d_ys, int h, int w, int oh, int ow) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  if (ox >= ow) return;
  const long long frame = blockIdx.z;
  const long long p = (frame * oh + blockIdx.y) * ow + ox;
  const Taps t = taps_of(xs[p], ys[p], frame, h, w, 3);
  const float w00 = (1.0f - t.dx) * (1.0f - t.dy), w01 = t.dx * (1.0f - t.dy);
  const float w10 = (1.0f - t.dx) * t.dy, w11 = t.dx * t.dy;
  float gv[3], top_row[6], bot_row[6];
  float gx = 0.0f, gy = 0.0f;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    gv[ch] = g[p * 3 + ch];
    top_row[ch] = gv[ch] * w00;
    top_row[3 + ch] = gv[ch] * w01;
    bot_row[ch] = gv[ch] * w10;
    bot_row[3 + ch] = gv[ch] * w11;
    const float v00 = t.in00 ? __ldg(img + t.o00 + ch) : 0.0f;
    const float v01 = t.in01 ? __ldg(img + t.o01 + ch) : 0.0f;
    const float v10 = t.in10 ? __ldg(img + t.o10 + ch) : 0.0f;
    const float v11 = t.in11 ? __ldg(img + t.o11 + ch) : 0.0f;
    const float top = v00 * (1.0f - t.dx) + v01 * t.dx;
    const float bot = v10 * (1.0f - t.dx) + v11 * t.dx;
    gx += gv[ch] * ((v01 - v00) * (1.0f - t.dy) + (v11 - v10) * t.dy);
    gy += gv[ch] * (bot - top);
  }
  const bool in[4] = {t.in00, t.in01, t.in10, t.in11};
  const long long off[4] = {t.o00, t.o01, t.o10, t.o11};
  const float* rows[2] = {top_row, bot_row};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (in[2 * r] && in[2 * r + 1]) {
      red6(d_img + off[2 * r], rows[r]);
    } else {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (!in[2 * r + k]) continue;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          atomicAdd(d_img + off[2 * r + k] + ch, rows[r][3 * k + ch]);
        }
      }
    }
  }
  d_xs[p] = gx;
  d_ys[p] = gy;
}

// backward variants 4-6: the port's 16 x 16 tiles (C = 3) with d_xs/d_ys
// from direct gathers, and the splat accumulated in the shared-memory
// window and flushed (4: vector atomics, 5: no flush, timing only,
// 6: scalar atomics)
template <int kMode>
__global__ void __launch_bounds__(kThreads)
    hybrid_backward(const float* __restrict__ img,
                    const float* __restrict__ xs,
                    const float* __restrict__ ys,
                    const float* __restrict__ g, float* __restrict__ d_img,
                    float* __restrict__ d_xs, float* __restrict__ d_ys, int h,
                    int w, int oh, int ow) {
  __shared__ __align__(16) float win[kWindowFloats];
  __shared__ int red[4 * kWarps];
  const int t = threadIdx.x;
  const int ox0 = blockIdx.x * kTile, oy0 = blockIdx.y * kTile;
  const int ox = ox0 + t % kTile, oy = oy0 + t / kTile;
  const long long frame = blockIdx.z;
  const bool valid = ox < ow && oy < oh;
  const long long frame_words = frame * h * w * 3;
  const long long p = (frame * oh + oy) * ow + ox;
  float x = 0.0f, y = 0.0f, gv[3] = {0.0f, 0.0f, 0.0f};
  if (valid) {
    x = __ldg(xs + p);
    y = __ldg(ys + p);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) gv[ch] = __ldg(g + p * 3 + ch);
  }
  const float fx = floorf(x), fy = floorf(y);
  const float dx = x - fx, dy = y - fy;
  const DirectTaps d = direct_taps(fx, fy, frame, h, w, 3);
  if (valid) {
    float gx = 0.0f, gy = 0.0f;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float v00 = d.in00 ? __ldg(img + d.o00 + ch) : 0.0f;
      const float v01 = d.in01 ? __ldg(img + d.o01 + ch) : 0.0f;
      const float v10 = d.in10 ? __ldg(img + d.o10 + ch) : 0.0f;
      const float v11 = d.in11 ? __ldg(img + d.o11 + ch) : 0.0f;
      const float top = v00 * (1.0f - dx) + v01 * dx;
      const float bot = v10 * (1.0f - dx) + v11 * dx;
      gx += gv[ch] * ((v01 - v00) * (1.0f - dy) + (v11 - v10) * dy);
      gy += gv[ch] * (bot - top);
    }
    d_xs[p] = gx;
    d_ys[p] = gy;
  }
  const int xi = tap_origin(x, w), yi = tap_origin(y, h);
  const Window b = tile_window(xi, yi, valid, img, frame_words, w, 3, red);
  const float w00 = (1.0f - dx) * (1.0f - dy), w01 = dx * (1.0f - dy);
  const float w10 = (1.0f - dx) * dy, w11 = dx * dy;
  if (b.fits) {
    float4* w4 = reinterpret_cast<float4*>(win);
    for (int k = t; k < (b.bh * b.stride + 3) / 4; k += kThreads) {
      w4[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();
    if (valid) {
      float* p0 = win + (yi - b.y0) * b.stride + b.pad + (xi - b.x0) * 3;
      float* p1 = p0 + b.stride;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        atomicAdd(p0 + ch, gv[ch] * w00);
        atomicAdd(p0 + 3 + ch, gv[ch] * w01);
        atomicAdd(p1 + ch, gv[ch] * w10);
        atomicAdd(p1 + 3 + ch, gv[ch] * w11);
      }
    }
    __syncthreads();
    if (kMode != 5) {
      flush_window(d_img + frame_words, win, b, h, w, 3, kMode == 4);
    }
  } else if (valid) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      if (d.in00) atomicAdd(d_img + d.o00 + ch, gv[ch] * w00);
      if (d.in01) atomicAdd(d_img + d.o01 + ch, gv[ch] * w01);
      if (d.in10) atomicAdd(d_img + d.o10 + ch, gv[ch] * w10);
      if (d.in11) atomicAdd(d_img + d.o11 + ch, gv[ch] * w11);
    }
  }
}

}  // namespace

// Forward variant `variant` (0-4 above) on `stream`; returns
// cudaGetLastError(). Variants 1-3 need c == 3; variant 4 needs 16-byte
// aligned buffers.
extern "C" int probe_warp(int variant, const float* img, const float* xs,
                          const float* ys, float* out, int n, int h, int w,
                          int c, int oh, int ow, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kProbeThreads),
      grid((ow + kProbeThreads - 1) / kProbeThreads, oh, n);
  switch (variant) {
    case 0:
      direct_any_c<<<grid, block, 0, s>>>(img, xs, ys, out, h, w, c, oh, ow);
      break;
    case 1:
      forward_kernel<1, 3><<<grid, block, 0, s>>>(img, xs, ys, out, h, w, c,
                                                  oh, ow);
      break;
    case 2:
      forward_kernel<2, 3><<<grid, block, 0, s>>>(img, xs, ys, out, h, w, c,
                                                  oh, ow);
      break;
    case 3:
      forward_kernel<3, 3><<<grid, block, 0, s>>>(img, xs, ys, out, h, w, c,
                                                  oh, ow);
      break;
    case 4: {
      const long long n_img4 = static_cast<long long>(n) * h * w * c / 4;
      const long long n_coord4 = static_cast<long long>(n) * oh * ow / 4;
      const long long n_out4 = static_cast<long long>(n) * oh * ow * c / 4;
      copy_kernel<<<132 * 16, 256, 0, s>>>(
          reinterpret_cast<const float4*>(img),
          reinterpret_cast<const float4*>(xs),
          reinterpret_cast<const float4*>(ys), reinterpret_cast<float4*>(out),
          n_img4, n_coord4, n_out4);
      break;
    }
    case 5:
      vec4_forward<<<dim3((ow / 4 + kProbeThreads - 1) / kProbeThreads, oh, n),
                     kProbeThreads, 0, s>>>(img, xs, ys, out, h, w, oh, ow);
      break;
    case 6:
      staged_forward<<<tiles(n, oh, ow), kThreads, 0, s>>>(img, xs, ys, out,
                                                           h, w, oh, ow);
      break;
    case 7:
      window_forward<3><<<tiles(n, oh, ow), kThreads, 0, s>>>(
          img, xs, ys, out, h, w, c, oh, ow);
      break;
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward variant `variant` (0-2 above); d_img must be zero for variant 0
// and is unused by variant 2.
extern "C" int probe_warp_backward(int variant, const float* img,
                                   const float* xs, const float* ys,
                                   const float* g, float* d_img, float* d_xs,
                                   float* d_ys, int n, int h, int w, int c,
                                   int oh, int ow, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kProbeThreads),
      grid((ow + kProbeThreads - 1) / kProbeThreads, oh, n);
  switch (variant) {
    case 0:
      backward_kernel<0><<<grid, block, 0, s>>>(img, xs, ys, g, d_img, d_xs,
                                                d_ys, h, w, c, oh, ow);
      break;
    case 1:
      backward_kernel<1><<<grid, block, 0, s>>>(img, xs, ys, g, d_img, d_xs,
                                                d_ys, h, w, c, oh, ow);
      break;
    case 2:
      backward_kernel<2><<<grid, block, 0, s>>>(img, xs, ys, g, d_img, d_xs,
                                                d_ys, h, w, c, oh, ow);
      break;
    case 3:
      red6_backward<<<grid, block, 0, s>>>(img, xs, ys, g, d_img, d_xs, d_ys,
                                           h, w, oh, ow);
      break;
    case 4:
      hybrid_backward<4><<<tiles(n, oh, ow), kThreads, 0, s>>>(
          img, xs, ys, g, d_img, d_xs, d_ys, h, w, oh, ow);
      break;
    case 5:
      hybrid_backward<5><<<tiles(n, oh, ow), kThreads, 0, s>>>(
          img, xs, ys, g, d_img, d_xs, d_ys, h, w, oh, ow);
      break;
    case 6:
      hybrid_backward<6><<<tiles(n, oh, ow), kThreads, 0, s>>>(
          img, xs, ys, g, d_img, d_xs, d_ys, h, w, oh, ow);
      break;
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
