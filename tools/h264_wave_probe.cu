// The least dependent steps of the wavefronts of kernels H3
// (intra_reconstruct) and H4 (deblock) of faceoff_tpu_torch/csrc/h264.cu,
// for their latency bounds (chip_smoke.py, phase 21). It stands alone:
// nothing here is the port's code, so the bound does not move with the
// port's design.
//
// probe_h264_intra_link: one thread, `links` Intra4x4 predictions in a
// chain. A link predicts a 4x4 block from 13 samples in registers (its
// left column, top-left, top and top-right: 8.3.1.2, a mode a link in
// turn among the eight directional ones), adds a residual and clips; the
// next link's 13 samples are this one's outputs. It is the least step of
// H3's chain, where a 4x4 block waits on the one before it.
// probe_h264_deblock_link: one thread, `links` edge filters in a chain
// (8.7.2.3-4 on 8 samples in registers, bS 1 to 4 in turn); the next
// edge's p samples are this one's filtered q samples, as along a line of
// a macroblock. It is the least step of H4's chain.
// probe_h264_handoff: two warps of one CUDA block passing a counter back
// and forth through shared memory (a release store, an acquire poll),
// 2 x `rounds` handoffs: the least time for a macroblock row to learn
// that the row above has finished a macroblock.
// probe_h264_handoff_gpu: the same between two CUDA blocks through
// global memory (for information: rows of two blocks hand off so).
// chip_smoke.py counts links and handoffs on the longest dependent path
// of a call's macroblocks (h264_chain_ms).

#include <cuda/atomic>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ int clip1(int x) { return min(max(x, 0), 255); }

// one Intra4x4 mode's 16 samples from e = p[-1, 3..0], p[-1, -1],
// p[0..7, -1] (8.3.1.2.2-9), plus a residual, clipped
template <int MODE>
__device__ __forceinline__ void predict(const int (&e)[13], int res,
                                        int (&o)[16]) {
  auto L = [&](int y) { return e[3 - y]; };     // p[-1, y]
  auto T = [&](int x) { return x < 0 ? e[4] : e[5 + x]; };  // p[x, -1]
#pragma unroll
  for (int y = 0; y < 4; y++) {
#pragma unroll
    for (int x = 0; x < 4; x++) {
      int p;
      if (MODE == 0) {
        p = T(x);
      } else if (MODE == 1) {
        p = L(y);
      } else if (MODE == 3) {
        p = x == 3 && y == 3 ? (T(6) + 3 * T(7) + 2) >> 2
                             : (T(x + y) + 2 * T(x + y + 1) + T(x + y + 2) + 2) >> 2;
      } else if (MODE == 4) {
        int k = x - y;
        auto S = [&](int i) { return i < 0 ? L(-1 - i) : T(i - 1); };
        p = k > 0 ? (T(k - 2) + 2 * T(k - 1) + T(k) + 2) >> 2
            : k < 0 ? (S(k - 1) + 2 * S(k) + S(k + 1) + 2) >> 2
                    : (T(0) + 2 * T(-1) + L(0) + 2) >> 2;
      } else if (MODE == 5) {
        int z = 2 * x - y;
        p = z >= 0 && !(z & 1) ? (T(x - (y >> 1) - 1) + T(x - (y >> 1)) + 1) >> 1
            : z > 0 ? (T(x - (y >> 1) - 2) + 2 * T(x - (y >> 1) - 1) + T(x - (y >> 1)) + 2) >> 2
            : z == -1 ? (L(0) + 2 * T(-1) + T(0) + 2) >> 2
                      : (L(y - 1) + 2 * L(y - 2) + L(y - 3) + 2) >> 2;
      } else if (MODE == 6) {
        int z = 2 * y - x;
        p = z >= 0 && !(z & 1) ? (L(y - (x >> 1) - 1) + L(y - (x >> 1)) + 1) >> 1
            : z > 0 ? (L(y - (x >> 1) - 2) + 2 * L(y - (x >> 1) - 1) + L(y - (x >> 1)) + 2) >> 2
            : z == -1 ? (L(0) + 2 * T(-1) + T(0) + 2) >> 2
                      : (T(x - 1) + 2 * T(x - 2) + T(x - 3) + 2) >> 2;
      } else if (MODE == 7) {
        int q = x + (y >> 1);
        p = y & 1 ? (T(q) + 2 * T(q + 1) + T(q + 2) + 2) >> 2
                  : (T(q) + T(q + 1) + 1) >> 1;
      } else {  // 8, horizontal-up
        int z = x + 2 * y, q = y + (x >> 1);
        p = z > 5 ? L(3)
            : z == 5 ? (L(2) + 3 * L(3) + 2) >> 2
            : z & 1 ? (L(q) + 2 * L(q + 1) + L(q + 2) + 2) >> 2
                    : (L(q) + L(q + 1) + 1) >> 1;
      }
      o[4 * y + x] = clip1(p + res);
    }
  }
}

// the next link's samples: its left column this block's right one, its
// top-left and top row this block's bottom row, its top-right again
__device__ __forceinline__ void feed(const int (&o)[16], int (&e)[13]) {
#pragma unroll
  for (int i = 0; i < 4; i++) e[i] = o[4 * (3 - i) + 3];
  e[4] = o[11];
#pragma unroll
  for (int i = 0; i < 4; i++) e[5 + i] = o[12 + i], e[9 + i] = o[15 - i];
}

__global__ void intra_chain(int links, uint8_t* buf) {
  int e[13], o[16];
#pragma unroll
  for (int i = 0; i < 13; i++) e[i] = buf[i];
  int res = int(buf[13]) - 128;
  for (int j = 0; j < links; j += 8) {
    predict<0>(e, res, o); feed(o, e);
    predict<3>(e, -res, o); feed(o, e);
    predict<4>(e, res, o); feed(o, e);
    predict<1>(e, -res, o); feed(o, e);
    predict<5>(e, res, o); feed(o, e);
    predict<6>(e, -res, o); feed(o, e);
    predict<7>(e, res, o); feed(o, e);
    predict<8>(e, -res, o); feed(o, e);
  }
#pragma unroll
  for (int i = 0; i < 13; i++) buf[16 + i] = uint8_t(e[i]);
}

// 8.7.2.3-4 on v = p3 p2 p1 p0 q0 q1 q2 q3
__device__ __forceinline__ void filter(int (&v)[8], int bs, int alpha,
                                       int beta, int tc0) {
  int p3 = v[0], p2 = v[1], p1 = v[2], p0 = v[3];
  int q0 = v[4], q1 = v[5], q2 = v[6], q3 = v[7];
  if (!(abs(p0 - q0) < alpha && abs(p1 - p0) < beta && abs(q1 - q0) < beta))
    return;
  bool ap = abs(p2 - p0) < beta, aq = abs(q2 - q0) < beta;
  if (bs < 4) {
    int tc = tc0 + ap + aq;
    int d = min(max((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc), tc);
    v[3] = clip1(p0 + d);
    v[4] = clip1(q0 - d);
    int mid = (p0 + q0 + 1) >> 1;
    if (ap) v[2] = p1 + min(max((p2 + mid - (p1 << 1)) >> 1, -tc0), tc0);
    if (aq) v[5] = q1 + min(max((q2 + mid - (q1 << 1)) >> 1, -tc0), tc0);
  } else {
    bool small = abs(p0 - q0) < ((alpha >> 2) + 2);
    if (ap && small) {
      v[3] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
      v[2] = (p2 + p1 + p0 + q0 + 2) >> 2;
      v[1] = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
    } else {
      v[3] = (2 * p1 + p0 + q1 + 2) >> 2;
    }
    if (aq && small) {
      v[4] = (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3;
      v[5] = (p0 + q0 + q1 + q2 + 2) >> 2;
      v[6] = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
    } else {
      v[4] = (2 * q1 + q0 + p1 + 2) >> 2;
    }
  }
}

__global__ void deblock_chain(int links, uint8_t* buf) {
  int v[8];
#pragma unroll
  for (int i = 0; i < 8; i++) v[i] = buf[i];
  const int alpha = buf[8], beta = buf[9], tc0 = buf[10];
  for (int j = 0; j < links; j++) {
    filter(v, 1 + (j & 3), alpha, beta, tc0);
    // the next edge 4 samples on: its p side this edge's q side, its q
    // side the line's next samples
#pragma unroll
    for (int i = 0; i < 4; i++) v[i] = v[4 + i], v[4 + i] = v[i] + (j & 1);
  }
#pragma unroll
  for (int i = 0; i < 8; i++) buf[16 + i] = uint8_t(v[i]);
}

// warp 0 stands for a row, warp 1 for the row below: each waits until
// the other has published, then publishes its own count
__global__ void handoff_chain(int rounds, int* out) {
  __shared__ int flag[2];
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x < 2) flag[threadIdx.x] = 0;
  __syncthreads();
  for (int i = 0; i < rounds; ++i) {
    if (lane == 0) {
      cuda::atomic_ref<int, cuda::thread_scope_block> other(flag[wid ^ 1]);
      while (other.load(cuda::memory_order_acquire) < i + wid) {
      }
    }
    __syncwarp();
    if (lane == 0)
      cuda::atomic_ref<int, cuda::thread_scope_block>(flag[wid]).store(
          i + 1, cuda::memory_order_release);
  }
  if (threadIdx.x == 0) out[0] = flag[1];
}

__global__ void handoff_gpu_chain(int rounds, int* progress) {
  const int b = blockIdx.x, lane = threadIdx.x & 31;
  for (int i = 0; i < rounds; ++i) {
    if (lane == 0) {
      cuda::atomic_ref<int, cuda::thread_scope_device> other(progress[b ^ 1]);
      while (other.load(cuda::memory_order_acquire) < i + b) __nanosleep(32);
    }
    __syncwarp();
    if (lane == 0)
      cuda::atomic_ref<int, cuda::thread_scope_device>(progress[b]).store(
          i + 1, cuda::memory_order_release);
  }
}

int status(cudaError_t e) { return e == cudaSuccess ? 0 : 1000 + int(e); }

}  // namespace

extern "C" {

// `buf` holds 32 bytes of device memory
int probe_h264_intra_link(int links, uint8_t* buf, cudaStream_t stream) {
  intra_chain<<<1, 1, 0, stream>>>(links, buf);
  return status(cudaGetLastError());
}

int probe_h264_deblock_link(int links, uint8_t* buf, cudaStream_t stream) {
  deblock_chain<<<1, 1, 0, stream>>>(links, buf);
  return status(cudaGetLastError());
}

// `sync` holds 2 ints of device scratch
int probe_h264_handoff(int rounds, int* sync, cudaStream_t stream) {
  handoff_chain<<<1, 64, 0, stream>>>(rounds, sync);
  return status(cudaGetLastError());
}

int probe_h264_handoff_gpu(int rounds, int* sync, cudaStream_t stream) {
  cudaError_t e = cudaMemsetAsync(sync, 0, sizeof(int) * 2, stream);
  if (e != cudaSuccess) return status(e);
  handoff_gpu_chain<<<2, 32, 0, stream>>>(rounds, sync);
  return status(cudaGetLastError());
}

}  // extern "C"
