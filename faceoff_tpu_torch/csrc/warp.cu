// Batched bilinear image warp for Hopper (sm_90a).
//
// Replaces the TPU kernel faceoff_tpu/ops/warp_pallas.py::_warp_kernel
// (reached through _warp_pallas_raw and bilinear_warp_frames). It samples
// imgs (N, H, W, C) float32 at float coordinates xs/ys (N, OH, OW) and
// writes out (N, OH, OW, C) float32. Each of the four taps is zero
// outside the image, tested on the tap's own position, exactly as the
// plain reference faceoff_tpu_torch/ops/warp.py::_bilinear_sample does.
//
// What bounds it: memory. Per frame it reads 8 B of coordinates per
// output pixel and at least H*W*C*4 B of source, and writes OH*OW*C*4 B;
// at 256x256x3 that is about 2.1 MB, about 0.6 us at 3.35 TB/s, so at
// batch 1 the launch itself dominates. The arithmetic (a dozen flops per
// output value) is far below the card's rate.
//
// Design: the TPU kernel builds one-hot matrices and multiplies them on
// the MXU only because TPU gathers are slow. Hopper gathers directly: one
// thread per output pixel, looping over C; neighbouring threads take
// neighbouring output x, so the coordinate loads and output stores
// coalesce and the four source taps of a warp fall in a few cache lines.
// All arithmetic is float32.
//
// The backward (bilinear_warp_backward_kernel) replaces the custom VJP of
// faceoff_tpu/ops/warp_pallas.py::_warp_diff (_warp_diff_bwd), which
// transposes the gather form of the same sample. For an output gradient
// g (N, OH, OW, C) it writes
//   d_img  (N, H, W, C): the bilinear splat, g times each inside tap's
//          weight added into that tap's pixel with atomicAdd; zero for
//          pixels no inside tap reaches (the wrapper zeroes it first);
//   d_xs, d_ys (N, OH, OW): per output pixel, summed over channels,
//          sum_c g_c * d(out_c)/dx with floor() taken as flat, as JAX
//          differentiates _bilinear_sample.
// One thread per output pixel, the same four inside tests as the forward.
// Bytes bound it: g, the coordinates and the taps read, d_img zeroed and
// added into, d_xs/d_ys written. The atomics rarely collide: four
// neighbouring output pixels share a source pixel only where the warp
// magnifies.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void bilinear_warp_kernel(const float* __restrict__ img,
                                     const float* __restrict__ xs,
                                     const float* __restrict__ ys,
                                     float* __restrict__ out,
                                     int h, int w, int c, int oh, int ow) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  if (ox >= ow) return;
  const int oy = blockIdx.y;
  const long long frame = blockIdx.z;
  const long long p = (frame * oh + oy) * ow + ox;

  const float x = xs[p];
  const float y = ys[p];
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float dx = x - x0;
  const float dy = y - y0;
  const float x1 = x0 + 1.0f;
  const float y1 = y0 + 1.0f;
  const float wmax = static_cast<float>(w - 1);
  const float hmax = static_cast<float>(h - 1);

  // per-tap inside tests on the unclipped tap positions
  const bool mx0 = (x0 >= 0.0f) && (x0 <= wmax);
  const bool mx1 = (x1 >= 0.0f) && (x1 <= wmax);
  const bool my0 = (y0 >= 0.0f) && (y0 <= hmax);
  const bool my1 = (y1 >= 0.0f) && (y1 <= hmax);
  // clip in float before converting, so far-away coordinates stay in range
  const int xi0 = static_cast<int>(fminf(fmaxf(x0, 0.0f), wmax));
  const int xi1 = static_cast<int>(fminf(fmaxf(x1, 0.0f), wmax));
  const int yi0 = static_cast<int>(fminf(fmaxf(y0, 0.0f), hmax));
  const int yi1 = static_cast<int>(fminf(fmaxf(y1, 0.0f), hmax));

  const float* src = img + frame * h * w * c;
  const float* r00 = src + (static_cast<long long>(yi0) * w + xi0) * c;
  const float* r01 = src + (static_cast<long long>(yi0) * w + xi1) * c;
  const float* r10 = src + (static_cast<long long>(yi1) * w + xi0) * c;
  const float* r11 = src + (static_cast<long long>(yi1) * w + xi1) * c;
  float* dst = out + p * c;

  for (int ch = 0; ch < c; ++ch) {
    const float v00 = (mx0 && my0) ? __ldg(r00 + ch) : 0.0f;
    const float v01 = (mx1 && my0) ? __ldg(r01 + ch) : 0.0f;
    const float v10 = (mx0 && my1) ? __ldg(r10 + ch) : 0.0f;
    const float v11 = (mx1 && my1) ? __ldg(r11 + ch) : 0.0f;
    const float top = v00 * (1.0f - dx) + v01 * dx;
    const float bot = v10 * (1.0f - dx) + v11 * dx;
    dst[ch] = top * (1.0f - dy) + bot * dy;
  }
}

__global__ void bilinear_warp_backward_kernel(
    const float* __restrict__ img, const float* __restrict__ xs,
    const float* __restrict__ ys, const float* __restrict__ g,
    float* __restrict__ d_img, float* __restrict__ d_xs,
    float* __restrict__ d_ys, int h, int w, int c, int oh, int ow) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  if (ox >= ow) return;
  const int oy = blockIdx.y;
  const long long frame = blockIdx.z;
  const long long p = (frame * oh + oy) * ow + ox;

  const float x = xs[p];
  const float y = ys[p];
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float dx = x - x0;
  const float dy = y - y0;
  const float x1 = x0 + 1.0f;
  const float y1 = y0 + 1.0f;
  const float wmax = static_cast<float>(w - 1);
  const float hmax = static_cast<float>(h - 1);

  const bool mx0 = (x0 >= 0.0f) && (x0 <= wmax);
  const bool mx1 = (x1 >= 0.0f) && (x1 <= wmax);
  const bool my0 = (y0 >= 0.0f) && (y0 <= hmax);
  const bool my1 = (y1 >= 0.0f) && (y1 <= hmax);
  const bool in00 = mx0 && my0, in01 = mx1 && my0;
  const bool in10 = mx0 && my1, in11 = mx1 && my1;
  const int xi0 = static_cast<int>(fminf(fmaxf(x0, 0.0f), wmax));
  const int xi1 = static_cast<int>(fminf(fmaxf(x1, 0.0f), wmax));
  const int yi0 = static_cast<int>(fminf(fmaxf(y0, 0.0f), hmax));
  const int yi1 = static_cast<int>(fminf(fmaxf(y1, 0.0f), hmax));

  const long long base = frame * h * w * c;
  const long long o00 = base + (static_cast<long long>(yi0) * w + xi0) * c;
  const long long o01 = base + (static_cast<long long>(yi0) * w + xi1) * c;
  const long long o10 = base + (static_cast<long long>(yi1) * w + xi0) * c;
  const long long o11 = base + (static_cast<long long>(yi1) * w + xi1) * c;
  const float* gp = g + p * c;
  // out = ((1-dx) v00 + dx v01) (1-dy) + ((1-dx) v10 + dx v11) dy
  const float w00 = (1.0f - dx) * (1.0f - dy), w01 = dx * (1.0f - dy);
  const float w10 = (1.0f - dx) * dy, w11 = dx * dy;

  float gx = 0.0f, gy = 0.0f;
  for (int ch = 0; ch < c; ++ch) {
    const float gv = gp[ch];
    if (d_img != nullptr) {
      if (in00) atomicAdd(d_img + o00 + ch, gv * w00);
      if (in01) atomicAdd(d_img + o01 + ch, gv * w01);
      if (in10) atomicAdd(d_img + o10 + ch, gv * w10);
      if (in11) atomicAdd(d_img + o11 + ch, gv * w11);
    }
    if (d_xs != nullptr) {
      const float v00 = in00 ? __ldg(img + o00 + ch) : 0.0f;
      const float v01 = in01 ? __ldg(img + o01 + ch) : 0.0f;
      const float v10 = in10 ? __ldg(img + o10 + ch) : 0.0f;
      const float v11 = in11 ? __ldg(img + o11 + ch) : 0.0f;
      const float top = v00 * (1.0f - dx) + v01 * dx;
      const float bot = v10 * (1.0f - dx) + v11 * dx;
      gx += gv * ((v01 - v00) * (1.0f - dy) + (v11 - v10) * dy);
      gy += gv * (bot - top);
    }
  }
  if (d_xs != nullptr) {
    d_xs[p] = gx;
    d_ys[p] = gy;
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
  const dim3 block(kThreads);
  const dim3 grid((ow + kThreads - 1) / kThreads, oh, n);
  bilinear_warp_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, xs, ys, out, h, w, c, oh, ow);
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
  const dim3 block(kThreads);
  const dim3 grid((ow + kThreads - 1) / kThreads, oh, n);
  bilinear_warp_backward_kernel<<<grid, block, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      img, xs, ys, g, d_img, d_xs, d_ys, h, w, c, oh, ow);
  return static_cast<int>(cudaGetLastError());
}
