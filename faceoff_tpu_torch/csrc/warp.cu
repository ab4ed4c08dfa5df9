// Batched bilinear image warp for Hopper (sm_90a), forward and backward.
//
// Replaces the TPU kernel faceoff_tpu/ops/warp_pallas.py::_warp_kernel
// (reached through _warp_pallas_raw and bilinear_warp_frames) and its
// custom VJP _warp_diff_bwd. The forward samples imgs (N, H, W, C) float32
// at float coordinates xs/ys (N, OH, OW) and writes out (N, OH, OW, C).
// Each of the four taps is zero outside the image, tested on the tap's own
// unclipped position, exactly as the plain reference
// faceoff_tpu_torch/ops/warp.py::_bilinear_sample does. For an output
// gradient g (N, OH, OW, C) the backward writes
//   d_img  (N, H, W, C): the bilinear splat, g times each inside tap's
//          weight added into that tap's pixel (the wrapper zeroes d_img);
//   d_xs, d_ys (N, OH, OW): per output pixel, summed over channels,
//          sum_c g_c * d(out_c)/dx with floor() taken as flat, as JAX
//          differentiates _bilinear_sample.
//
// What bounds them: bytes. Per output pixel the forward reads 8 B of
// coordinates and its taps and writes C floats; the backward also reads g
// and writes d_xs, d_ys and d_img. The TPU kernel builds one-hot matrices
// for the MXU only because TPU gathers are slow; Hopper gathers.
//
// Forward: one thread per output pixel gathers its four taps from global
// memory. C is a template parameter: at C = 3 the channel loop is unrolled
// and the twelve tap loads of a pixel are in flight together (a loop over
// a runtime C left each channel's loads waiting on the last: 1.3-1.6x
// slower). Measured on an H100 (tools/warp_variants_torch.py) this gather
// runs within 1.08x of a streaming copy of the same bytes at the training
// step's call; staging each tile's source in shared memory, or its outputs
// for 16-byte stores, made it slower, so it stays a gather.
//
// Backward: one block of 256 threads per 16 x 16 tile of output pixels.
// d_xs/d_ys come from the same direct gathers as the forward. The splat is
// what costs: twelve scalar global atomics a pixel, at a 12 B stride, into
// a d_img too large for L2, took 0.47 of the 0.59 ms at (128,256,256,3);
// the same splat into a shared-memory window with float atomics was barely
// faster (the shared float atomics alone about 0.3 ms). So each tile
// splats in the gather form, with no float atomics:
//   1. A block reduction of the tap origins floor(x), floor(y), clipped to
//      [-2, n] (tile_footprint), gives the tile's source footprint: columns
//      [x_min, x_max + 1], rows [y_min, y_max + 1]. Clipping keeps every
//      tap's inside test: an origin below -1 has both taps outside, as has
//      -2; one at n or beyond has both outside, as has n; NaN goes to -2.
//   2. If the footprint has at most kWindowCells pixels and C <= 4, every
//      pixel of the tile is put on a list of the footprint cell of its tap
//      origin (one integer atomicExch a pixel), with its four tap weights
//      and g in shared memory.
//   3. One warp a footprint row, one lane a source pixel: it sums g w_tap
//      over the pixels on the lists of the four cells whose tap lands on
//      it, and adds each channel's sum into d_img with one global atomic.
//      A warp's atomics cover consecutive pixels, and each source value
//      gets one atomic a tile instead of one a tap.
//   4. A tile whose footprint is larger (strong minification, coordinates
//      far outside the image), or any tile when C > 4, splats with direct
//      global atomics in the same launch.
// All arithmetic is float32. The backward's sums are added in another
// order than autograd's, and tiles' atomics in an order that varies from
// run to run, so d_img agrees with autograd to rounding, not bit for bit.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kForwardThreads = 128;
constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;  // backward: one thread a pixel
constexpr int kWarps = kThreads / 32;
constexpr int kBackwardBlocks = 6;       // blocks an SM: at most 40 registers
constexpr int kWindowCells = 1024;       // the largest footprint splatted
constexpr int kStageChannels = 4;        // the most channels splatted so

// A pixel's four taps read directly from global memory: the offsets of
// their pixels (clipped into the image) and their inside tests.
struct Taps {
  bool in00, in01, in10, in11;
  long long o00, o01, o10, o11;
};

__device__ __forceinline__ Taps taps_of(float x0, float y0, long long frame,
                                        int h, int w, int c) {
  Taps t;
  const float x1 = x0 + 1.0f, y1 = y0 + 1.0f;
  const float wmax = static_cast<float>(w - 1);
  const float hmax = static_cast<float>(h - 1);
  // per-tap inside tests on the unclipped tap positions
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

// The four taps' values of channel ch (0 outside the image).
struct TapValues {
  float v00, v01, v10, v11;
};

__device__ __forceinline__ TapValues tap_values(const float* __restrict__ img,
                                                const Taps& t, int ch) {
  return {t.in00 ? __ldg(img + t.o00 + ch) : 0.0f,
          t.in01 ? __ldg(img + t.o01 + ch) : 0.0f,
          t.in10 ? __ldg(img + t.o10 + ch) : 0.0f,
          t.in11 ? __ldg(img + t.o11 + ch) : 0.0f};
}

template <int kC>
__global__ void __launch_bounds__(kForwardThreads)
    warp_forward(const float* __restrict__ img, const float* __restrict__ xs,
                 const float* __restrict__ ys, float* __restrict__ out,
                 int h, int w, int c_rt, int oh, int ow) {
  const int c = kC > 0 ? kC : c_rt;
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  if (ox >= ow) return;
  const long long frame = blockIdx.z;
  const long long p = (frame * oh + blockIdx.y) * ow + ox;
  const float x = xs[p], y = ys[p];
  const float x0 = floorf(x), y0 = floorf(y);
  const float dx = x - x0, dy = y - y0;
  const Taps t = taps_of(x0, y0, frame, h, w, c);
  float* dst = out + p * c;
#pragma unroll
  for (int ch = 0; ch < (kC > 0 ? kC : c); ++ch) {
    const TapValues v = tap_values(img, t, ch);
    const float top = v.v00 * (1.0f - dx) + v.v01 * dx;
    const float bot = v.v10 * (1.0f - dx) + v.v11 * dx;
    dst[ch] = top * (1.0f - dy) + bot * dy;
  }
}

// A tile's source footprint: columns [x0, x0 + bw), rows [y0, y0 + bh).
struct Footprint {
  int x0, y0, bw, bh;
  bool fits;  // bw * bh <= kWindowCells and c <= kStageChannels
};

__device__ __forceinline__ int tap_origin(float v, int n) {
  return static_cast<int>(fminf(fmaxf(floorf(v), -2.0f),
                                static_cast<float>(n)));
}

// The tile's footprint from each thread's clipped tap origins (xi, yi);
// threads without a pixel pass valid = false. All threads of the block
// call it. Its plain twin is
// faceoff_tpu_torch/ops/warp_cuda.py::tile_footprints.
__device__ Footprint tile_footprint(int xi, int yi, bool valid, int c,
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
  Footprint b;
  b.x0 = v[0];
  b.y0 = v[2];
  b.bw = -v[1] - v[0] + 2;
  b.bh = -v[3] - v[2] + 2;
  b.fits = static_cast<long long>(b.bw) * b.bh <= kWindowCells &&
           c <= kStageChannels;
  return b;
}

template <int kC>
__global__ void __launch_bounds__(kThreads, kBackwardBlocks)
    warp_backward(const float* __restrict__ img, const float* __restrict__ xs,
                  const float* __restrict__ ys, const float* __restrict__ g,
                  float* __restrict__ d_img, float* __restrict__ d_xs,
                  float* __restrict__ d_ys, int h, int w, int c_rt, int oh,
                  int ow) {
  __shared__ int head[kWindowCells];  // first pixel with this tap origin
  __shared__ int next[kThreads];      // the next pixel on its list
  __shared__ float weights[4][kThreads];
  __shared__ float gs[kStageChannels * kThreads];
  __shared__ int red[4 * kWarps];
  const int c = kC > 0 ? kC : c_rt;
  const int t = threadIdx.x;
  const int ox = blockIdx.x * kTile + t % kTile;
  const int oy = blockIdx.y * kTile + t / kTile;
  const long long frame = blockIdx.z;
  const bool valid = ox < ow && oy < oh;
  const long long p = (frame * oh + oy) * ow + ox;
  const float x = valid ? xs[p] : 0.0f, y = valid ? ys[p] : 0.0f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float dx = x - x0, dy = y - y0;
  const float* gp = g + p * c;

  if (d_xs != nullptr && valid) {
    const Taps taps = taps_of(x0, y0, frame, h, w, c);
    float gx = 0.0f, gy = 0.0f;
#pragma unroll
    for (int ch = 0; ch < (kC > 0 ? kC : c); ++ch) {
      const float gv = __ldg(gp + ch);
      const TapValues v = tap_values(img, taps, ch);
      const float top = v.v00 * (1.0f - dx) + v.v01 * dx;
      const float bot = v.v10 * (1.0f - dx) + v.v11 * dx;
      gx += gv * ((v.v01 - v.v00) * (1.0f - dy) + (v.v11 - v.v10) * dy);
      gy += gv * (bot - top);
    }
    d_xs[p] = gx;
    d_ys[p] = gy;
  }
  if (d_img == nullptr) return;

  // out = ((1-dx) v00 + dx v01) (1-dy) + ((1-dx) v10 + dx v11) dy
  const float w00 = (1.0f - dx) * (1.0f - dy), w01 = dx * (1.0f - dy);
  const float w10 = (1.0f - dx) * dy, w11 = dx * dy;
  const int xi = tap_origin(x, w), yi = tap_origin(y, h);
  const Footprint b = tile_footprint(xi, yi, valid, c, red);
  if (!b.fits) {
    if (valid) {
      const Taps taps = taps_of(x0, y0, frame, h, w, c);
#pragma unroll
      for (int ch = 0; ch < (kC > 0 ? kC : c); ++ch) {
        const float gv = __ldg(gp + ch);
        if (taps.in00) atomicAdd(d_img + taps.o00 + ch, gv * w00);
        if (taps.in01) atomicAdd(d_img + taps.o01 + ch, gv * w01);
        if (taps.in10) atomicAdd(d_img + taps.o10 + ch, gv * w10);
        if (taps.in11) atomicAdd(d_img + taps.o11 + ch, gv * w11);
      }
    }
    return;
  }

  // the tile's pixels on lists by tap origin, with their weights and g
  for (int k = t; k < b.bw * b.bh; k += kThreads) head[k] = -1;
  if (valid) {
    weights[0][t] = w00;
    weights[1][t] = w01;
    weights[2][t] = w10;
    weights[3][t] = w11;
#pragma unroll
    for (int ch = 0; ch < (kC > 0 ? kC : c); ++ch) {
      gs[t * c + ch] = __ldg(gp + ch);
    }
  }
  __syncthreads();
  if (valid) next[t] = atomicExch(&head[(yi - b.y0) * b.bw + (xi - b.x0)], t);
  __syncthreads();

  // one warp a footprint row inside the image, one lane a source pixel
  const int lane = t & 31;
  const int xl = max(b.x0, 0), xh = min(b.x0 + b.bw - 1, w - 1);
  float* dst = d_img + frame * h * w * c;
  for (int v = t >> 5; v < b.bh; v += kWarps) {
    const int sy = b.y0 + v;
    if (sy < 0 || sy >= h) continue;
    for (int sx = xl + lane; sx <= xh; sx += 32) {
      const int u = sx - b.x0;
      float acc[kStageChannels] = {};
      // the pixels whose tap (a, e) lands on cell (u, v) have their origin
      // at cell (u - a, v - e)
#pragma unroll
      for (int tap = 0; tap < 4; ++tap) {
        const int cu = u - (tap & 1), cv = v - (tap >> 1);
        if (cu < 0 || cv < 0) continue;
        for (int q = head[cv * b.bw + cu]; q >= 0; q = next[q]) {
          const float wq = weights[tap][q];
#pragma unroll
          for (int ch = 0; ch < kStageChannels; ++ch) {
            if (ch < c) acc[ch] += gs[q * c + ch] * wq;
          }
        }
      }
      float* cell = dst + (static_cast<long long>(sy) * w + sx) * c;
#pragma unroll
      for (int ch = 0; ch < kStageChannels; ++ch) {
        if (ch < c && acc[ch] != 0.0f) atomicAdd(cell + ch, acc[ch]);
      }
    }
  }
}

}  // namespace

// Launches the warp on `stream` (a cudaStream_t passed as void*) and
// returns cudaGetLastError() as an int: 0 when the launch was accepted.
// Sizes must be positive and oh, n at most 65535 (grid y and z limits);
// the Python wrapper checks them.
extern "C" int faceoff_bilinear_warp(const float* img, const float* xs,
                                     const float* ys, float* out, int n,
                                     int h, int w, int c, int oh, int ow,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((ow + kForwardThreads - 1) / kForwardThreads, oh, n);
  if (c == 3) {
    warp_forward<3><<<grid, kForwardThreads, 0, s>>>(img, xs, ys, out, h, w,
                                                     c, oh, ow);
  } else {
    warp_forward<0><<<grid, kForwardThreads, 0, s>>>(img, xs, ys, out, h, w,
                                                     c, oh, ow);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches the backward on `stream`: g is (n, oh, ow, c); d_img (n, h, w, c)
// must be zero and is added into, or null to skip it; d_xs and d_ys
// (n, oh, ow) are written, or both null to skip them. Returns
// cudaGetLastError() as an int. The same size limits as the forward.
extern "C" int faceoff_bilinear_warp_backward(
    const float* img, const float* xs, const float* ys, const float* g,
    float* d_img, float* d_xs, float* d_ys, int n, int h, int w, int c,
    int oh, int ow, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((ow + kTile - 1) / kTile, (oh + kTile - 1) / kTile, n);
  if (c == 3) {
    warp_backward<3><<<grid, kThreads, 0, s>>>(img, xs, ys, g, d_img, d_xs,
                                               d_ys, h, w, c, oh, ow);
  } else {
    warp_backward<0><<<grid, kThreads, 0, s>>>(img, xs, ys, g, d_img, d_xs,
                                               d_ys, h, w, c, oh, ow);
  }
  return static_cast<int>(cudaGetLastError());
}

