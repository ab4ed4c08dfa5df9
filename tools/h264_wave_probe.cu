// The least steps of the wavefronts of kernels H3 (intra_reconstruct)
// and H4 (deblock) of faceoff_tpu_torch/csrc/h264.cu, timed by
// chip_smoke.py (phase 21) for their latency bounds. Not used by the
// port. The port's source is included, so the probes use the kernels'
// own thread count, L2 read (ld) and row handoff (wait_row, publish).
//
// probe_h264_link: one block of WAVE_THREADS threads running `links`
// dependent links and nothing else. A link: 16 threads each store a
// sample, the block meets at one barrier, and each thread reads back
// through L2 the sample its neighbour stored. It is the least step of
// H3's Intra4x4 chain (a 4x4 block predicted from the samples of the
// block before it) and of H4's (an edge filtered over samples that the
// edge before it changed): the body's loads, arithmetic and second
// barrier left out.
// probe_h264_handoff: two blocks handing a row's progress back and
// forth through wait_row and publish, 2 x `rounds` handoffs in all: the
// least time for a macroblock to learn that its neighbour in the row
// above has finished.
// chip_smoke.py counts both on the longest dependent path of a call's
// macroblocks (h264_chain_ms).

#include "../faceoff_tpu_torch/csrc/h264.cu"

namespace {

__global__ void link_chain(int links, uint8_t* buf) {
  const int t = threadIdx.x;
  int v = t;
  for (int j = 0; j < links; ++j) {
    // two halves in turn: a sample is stored again only after every
    // thread has passed the barrier that follows its last read
    uint8_t* half = buf + 16 * (j & 1);
    if (t < 16) half[t] = uint8_t(v);
    __threadfence_block();
    __syncthreads();
    if (t < 16) v = ld(half + ((t + 1) & 15)) + 1;
  }
  if (t < 16) buf[32 + t] = uint8_t(v);
}

// block 0 stands for row 0 and block 1 for row 1: each waits until the
// other has published, then publishes its own count
__global__ void handoff_chain(int rounds, int* progress) {
  for (int i = 0; i < rounds; ++i) {
    if (blockIdx.x == 0) {
      wait_row(progress + 1, 1, i);  // progress[1] >= i
      publish(progress, 0, i + 1);
    } else {
      wait_row(progress, 1, i + 1);  // progress[0] >= i + 1
      publish(progress, 1, i + 1);
    }
  }
}

}  // namespace

extern "C" {

// `buf` holds 48 bytes of device memory
int probe_h264_link(int links, uint8_t* buf, cudaStream_t stream) {
  link_chain<<<1, WAVE_THREADS, 0, stream>>>(links, buf);
  return status(cudaGetLastError());
}

// `progress` holds 2 ints of device scratch
int probe_h264_handoff(int rounds, int* progress, cudaStream_t stream) {
  cudaError_t e = cudaMemsetAsync(progress, 0, sizeof(int) * 2, stream);
  if (e != cudaSuccess) return status(e);
  handoff_chain<<<2, WAVE_THREADS, 0, stream>>>(rounds, progress);
  return status(cudaGetLastError());
}

}  // extern "C"
