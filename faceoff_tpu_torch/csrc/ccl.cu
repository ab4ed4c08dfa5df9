// Connected components (8-connectivity) of a batch of uint8 masks, with
// each component's area, bounding box and cv2 order key, behind a plain C
// interface for ctypes (faceoff_tpu_torch/ops/ccl_cuda.py).
//
// Not a port of a TPU kernel: it replaces cv2.connectedComponentsWithStats
// at faceoff_tpu/preprocess/detectors.py:59 and :390, which the JAX
// package runs on the host and for which PyTorch has no operator.
//
// Design: union-find with one thread per pixel, in four launches on the
// caller's stream (after zeroing the component count).
//   1. init: every foreground pixel is its own parent (its flat index);
//      background -1.
//   2. merge: each foreground pixel joins its W, NW, N and NE foreground
//      neighbours. A union finds both roots and hooks the larger onto the
//      smaller with atomicMin; when another thread moved the larger root
//      first, it retries from the value it found. Roots only ever point
//      to smaller indices, so every component ends at its smallest flat
//      index (as the plain version's).
//   3. flatten: every foreground pixel points straight at its root; each
//      root takes the next slot of a compact table with an atomic counter
//      and sets that slot's statistics to their neutral values.
//   4. stats: each foreground pixel adds itself to its root's slot: area,
//      box and minimum block key (y / 2) * ceil(W / 2) + x / 2 (cv2's
//      label order), with atomics.
// The table's rows: root, x0, y0, x1, y1, area, key, each `capacity`
// long, the first *count columns valid, in no particular order. Under
// 8-connectivity the foreground pixels of one 2 x 2 block belong to one
// component, so a batch of B masks has at most B * ceil(H / 2) *
// ceil(W / 2) components, the capacity the caller allocates. `slot` (one int a pixel) is written at
// the roots only.
// Bound: bytes. The mask is read once and the labels and the table
// written once; the atomics of a large component serialise on one
// address, which a later version can aggregate per warp.
//
// Returns 0 or 1000 + a cudaError_t.

#include <climits>
#include <cuda_runtime.h>

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

extern "C" int faceoff_ccl(const unsigned char* mask, int* labels,
                           int* slot, int* count, int* table, int capacity,
                           int batch, int h, int w, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
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
