// JPEG decoding and encoding on the card through nvJPEG, the CUDA
// toolkit's codec, behind a plain C interface for ctypes
// (faceoff_tpu_torch/io/image.py).
//
// This is not a port of a TPU kernel: the JAX package decodes frames on
// the host with cv2 (faceoff_tpu/data/dataset.py load_frame) or libjpeg
// (faceoff_tpu/native, fo_load_frames) and writes them with cv2.imwrite
// (faceoff_tpu/preprocess/landmarks.py). The machine with the card has
// neither for the port's use; decoding on the card writes the frames
// straight into the tensors that need them, and encoding there reads the
// frames where the preprocessing left them. Built by ops/cuda_build.py,
// linked with -lnvjpeg.
//
// One library handle serves the process (nvJPEG's handle may be shared
// between threads); every calling thread has its own batched-decoder
// state and its own encoder state and parameters (thread_local, released
// when the thread ends), so threads decode and encode at once.
// Each call waits for its stream before it returns, so that the next
// call of the same thread, which reuses the state's buffers, cannot
// overtake one still in flight. Every function returns 0, an
// nvjpegStatus_t, or 1000 + a cudaError_t.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <mutex>
#include <vector>

namespace {

nvjpegHandle_t g_handle = nullptr;
int g_handle_status = 0;
std::once_flag g_handle_once;

int ensure_handle() {
  std::call_once(g_handle_once, [] {
    nvjpegStatus_t s = nvjpegCreateSimple(&g_handle);
    if (s != NVJPEG_STATUS_SUCCESS) {
      g_handle = nullptr;
      g_handle_status = static_cast<int>(s);
    }
  });
  return g_handle == nullptr ? (g_handle_status ? g_handle_status : 1)
                             : 0;
}

int cuda_status(cudaError_t e) {
  return e == cudaSuccess ? 0 : 1000 + static_cast<int>(e);
}

int wait(cudaStream_t stream) {
  cudaError_t e = cudaStreamSynchronize(stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  return cuda_status(e);
}

// The calling thread's states, created at first use.
struct Coder {
  nvjpegJpegState_t batched = nullptr;
  nvjpegEncoderState_t encoder = nullptr;
  nvjpegEncoderParams_t params = nullptr;

  ~Coder() {
    if (params) nvjpegEncoderParamsDestroy(params);
    if (encoder) nvjpegEncoderStateDestroy(encoder);
    if (batched) nvjpegJpegStateDestroy(batched);
  }
};

thread_local Coder t_coder;

nvjpegImage_t interleaved(unsigned char* ptr, int pitch) {
  nvjpegImage_t image;
  for (int c = 0; c < NVJPEG_MAX_COMPONENT; ++c) {
    image.channel[c] = nullptr;
    image.pitch[c] = 0;
  }
  image.channel[0] = ptr;
  image.pitch[0] = static_cast<size_t>(pitch);
  return image;
}

}  // namespace

extern "C" int faceoff_jpeg_info(const unsigned char* data, size_t length,
                                 int* width, int* height, int* components,
                                 int* subsampling) {
  int status = ensure_handle();
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

// Decodes n images with nvJPEG's batched decoder, image i into outs[i]
// (rows of pitches[i] bytes, RGB interleaved).
extern "C" int faceoff_jpeg_decode_batch(int n,
                                         const unsigned char* const* datas,
                                         const size_t* lengths,
                                         unsigned char* const* outs,
                                         const int* pitches,
                                         void* stream_ptr) {
  int status = ensure_handle();
  if (status != 0) return status;
  if (n == 0) return 0;
  Coder& c = t_coder;
  nvjpegStatus_t s;
  if (c.batched == nullptr) {
    s = nvjpegJpegStateCreate(g_handle, &c.batched);
    if (s != NVJPEG_STATUS_SUCCESS) {
      c.batched = nullptr;
      return static_cast<int>(s);
    }
  }
  s = nvjpegDecodeBatchedInitialize(g_handle, c.batched, n, 1,
                                    NVJPEG_OUTPUT_RGBI);
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  std::vector<nvjpegImage_t> images(n);
  for (int i = 0; i < n; ++i) images[i] = interleaved(outs[i], pitches[i]);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  s = nvjpegDecodeBatched(g_handle, c.batched, datas, lengths, images.data(),
                          stream);
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  return wait(stream);
}

// Encodes one RGB interleaved image (rows of `pitch` bytes on the card)
// at `quality` with chroma `subsampling` (an nvjpegChromaSubsampling_t)
// and leaves the bitstream in the thread's encoder state; *length gets
// its size in bytes. faceoff_jpeg_encode_take copies it out.
extern "C" int faceoff_jpeg_encode(const unsigned char* src, int width,
                                   int height, int pitch, int quality,
                                   int subsampling, size_t* length,
                                   void* stream_ptr) {
  int status = ensure_handle();
  if (status != 0) return status;
  Coder& c = t_coder;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  nvjpegStatus_t s;
  if (c.encoder == nullptr) {
    s = nvjpegEncoderStateCreate(g_handle, &c.encoder, stream);
    if (s != NVJPEG_STATUS_SUCCESS) {
      c.encoder = nullptr;
      return static_cast<int>(s);
    }
  }
  if (c.params == nullptr) {
    s = nvjpegEncoderParamsCreate(g_handle, &c.params, stream);
    if (s != NVJPEG_STATUS_SUCCESS) {
      c.params = nullptr;
      return static_cast<int>(s);
    }
  }
  s = nvjpegEncoderParamsSetQuality(c.params, quality, stream);
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  s = nvjpegEncoderParamsSetSamplingFactors(
      c.params, static_cast<nvjpegChromaSubsampling_t>(subsampling), stream);
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  nvjpegImage_t image =
      interleaved(const_cast<unsigned char*>(src), pitch);
  s = nvjpegEncodeImage(g_handle, c.encoder, c.params, &image,
                        NVJPEG_INPUT_RGBI, width, height, stream);
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  s = nvjpegEncodeRetrieveBitstream(g_handle, c.encoder, nullptr, length,
                                    stream);
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  return wait(stream);
}

// Copies the bitstream of the thread's last encode into `out` (`length`
// bytes, as faceoff_jpeg_encode reported).
extern "C" int faceoff_jpeg_encode_take(unsigned char* out, size_t length,
                                        void* stream_ptr) {
  Coder& c = t_coder;
  if (c.encoder == nullptr) return 1;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  nvjpegStatus_t s = nvjpegEncodeRetrieveBitstream(g_handle, c.encoder, out,
                                                   &length, stream);
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  return wait(stream);
}
