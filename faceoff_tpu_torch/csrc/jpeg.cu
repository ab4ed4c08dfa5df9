// JPEG decoding on the card through nvJPEG, the CUDA toolkit's decoder,
// behind a plain C interface for ctypes (faceoff_tpu_torch/io/image.py).
//
// This is not a port of a TPU kernel: the JAX package decodes frames on
// the host with cv2 (faceoff_tpu/data/dataset.py load_frame) or libjpeg
// (faceoff_tpu/native). The machine with the card has neither for the
// port's use, and decoding on the card writes the frames straight into
// the resident corpus. Built by ops/cuda_build.py, linked with -lnvjpeg.
//
// One handle and one decoder state serve the process; the Python side
// serialises the calls, and each decode waits for its stream before it
// returns, so that the next call, which reuses the state's buffers,
// cannot overtake a decode still in flight. Every function returns 0, an
// nvjpegStatus_t, or 1000 + a cudaError_t.

#include <cuda_runtime.h>
#include <nvjpeg.h>

namespace {

nvjpegHandle_t g_handle = nullptr;
nvjpegJpegState_t g_state = nullptr;

int ensure_decoder() {
  if (g_handle != nullptr) return 0;
  nvjpegStatus_t s = nvjpegCreateSimple(&g_handle);
  if (s != NVJPEG_STATUS_SUCCESS) {
    g_handle = nullptr;
    return static_cast<int>(s);
  }
  s = nvjpegJpegStateCreate(g_handle, &g_state);
  if (s != NVJPEG_STATUS_SUCCESS) {
    nvjpegDestroy(g_handle);
    g_handle = nullptr;
    return static_cast<int>(s);
  }
  return 0;
}

}  // namespace

extern "C" int faceoff_jpeg_info(const unsigned char* data, size_t length,
                                 int* width, int* height, int* components,
                                 int* subsampling) {
  int status = ensure_decoder();
  if (status != 0) return status;
  int widths[NVJPEG_MAX_COMPONENT];
  int heights[NVJPEG_MAX_COMPONENT];
  int n = 0;
  nvjpegChromaSubsampling_t sub;
  nvjpegStatus_t s = nvjpegGetImageInfo(g_handle, data, length, &n, &sub,
                                        widths, heights);
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  *width = widths[0];
  *height = heights[0];
  *components = n;
  *subsampling = static_cast<int>(sub);
  return 0;
}

// Decodes into `out`: height rows of `pitch` bytes, RGB interleaved.
extern "C" int faceoff_jpeg_decode_rgbi(const unsigned char* data,
                                        size_t length, unsigned char* out,
                                        int pitch, void* stream) {
  int status = ensure_decoder();
  if (status != 0) return status;
  nvjpegImage_t image;
  for (int c = 0; c < NVJPEG_MAX_COMPONENT; ++c) {
    image.channel[c] = nullptr;
    image.pitch[c] = 0;
  }
  image.channel[0] = out;
  image.pitch[0] = static_cast<size_t>(pitch);
  nvjpegStatus_t s = nvjpegDecode(g_handle, g_state, data, length,
                                  NVJPEG_OUTPUT_RGBI, &image,
                                  static_cast<cudaStream_t>(stream));
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  cudaError_t e = cudaStreamSynchronize(static_cast<cudaStream_t>(stream));
  if (e == cudaSuccess) e = cudaGetLastError();
  return e == cudaSuccess ? 0 : 1000 + static_cast<int>(e);
}
