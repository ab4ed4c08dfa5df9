// Connected components (8-connectivity) of a batch of uint8 masks, with
// each component's area, bounding box and cv2 order key, behind a plain C
// interface for ctypes (faceoff_tpu_torch/ops/ccl_cuda.py).
//
// Not a port of a TPU kernel: it replaces cv2.connectedComponentsWithStats
// at faceoff_tpu/preprocess/detectors.py:59 and :390, which the JAX
// package runs on the host and for which PyTorch has no operator.
//
// Design: union-find over 2 x 2 pixel blocks (block-based Komura
// equivalence: Allegretti, Bolelli and Grana, IEEE TPDS 2020). Under
// 8-connectivity the foreground pixels of a 2 x 2 block belong to one
// component, so the nodes are the blocks, a quarter of the pixels, and a
// block is linked to a neighbour block when a foreground pixel of each
// touch (`linked`). A block's index over the batch is
// frame * ceil(H / 2) * ceil(W / 2) + (y / 2) * ceil(W / 2) + x / 2: within
// a frame it is cv2's label-order key, so a component whose root is its
// smallest block index has its key in that root. Four launches on the
// caller's stream:
//   1. local: a CUDA block labels a tile of TBH x TBW blocks in shared
//      memory: runs of joined blocks along each row from a warp ballot,
//      then union-find with shared atomics over the runs, each pair of
//      touching runs joined once (roots at the smallest index). It
//      reduces each tile component's statistics (x0, y0, x1, y1, area and
//      the smallest flat pixel index) in shared memory, the blocks of each
//      warp's first root across the warp first (__reduce_*_sync), and
//      writes every block's pixel bits, every foreground block's parent
//      (its tile root) and, at each tile root, that component's
//      statistics. A tile without foreground writes its bits and stops.
//      Block (0, 0) zeroes the component count.
//   2. border: the blocks on a tile's first row, first column and last
//      column join their neighbours in other tiles, in global memory:
//      roots hook the larger onto the smaller with atomicMin and retry
//      when another thread moved the larger first; finds halve the path.
//      Only tile roots are ever stored as parents.
//   3. roots: every tile root finds its component's root (the smallest
//      block index), points straight at it, and adds its statistics to
//      the root's with one atomic a statistic: one set of atomics per
//      component and tile, not per pixel.
//   4. label: every foreground pixel's label is its root's smallest flat
//      pixel index (two loads: block -> tile root -> root); each root
//      takes a slot of the compact table (one atomic a warp) and writes
//      its row.
// The table's rows: root (the smallest flat pixel index), x0, y0, x1, y1,
// area, key, each `capacity` long, the first *count columns valid, in no
// particular order. A batch of B masks has at most B * ceil(H / 2) *
// ceil(W / 2) components (one a block), the capacity the caller
// allocates, which is also the length of the scratch: parent and bits (a
// block each) and stats (six rows of `capacity`).
// Bound: bytes. The mask is read once, the labels written once (4 bytes a
// pixel, most of the traffic); the scratch adds 5 bytes a block written
// and read back, and 24 at each tile root.
//
// Returns 0 or 1000 + a cudaError_t.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace ccl {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLabelThreads = 256;
constexpr int kRootBit = 16;  // in bits[]: the block is its tile's root

// Pixel bits of a block: 1 top left, 2 top right, 4 bottom left, 8
// bottom right. Whether foreground pixels of block `me` and of its
// neighbour `nb` touch under 8-connectivity, for the four neighbours a
// block looks back at.
__device__ __forceinline__ bool linked_w(int me, int nb) {
  return (me & 5) && (nb & 10);
}
__device__ __forceinline__ bool linked_nw(int me, int nb) {
  return (me & 1) && (nb & 8);
}
__device__ __forceinline__ bool linked_n(int me, int nb) {
  return (me & 3) && (nb & 12);
}
__device__ __forceinline__ bool linked_ne(int me, int nb) {
  return (me & 2) && (nb & 4);
}

struct Geometry {
  int h, w;          // pixels of a frame
  int bh, bw;        // blocks of a frame
  int tiles_y, tiles_x;
  long long n_blocks;  // over the batch: the capacity
};

// The pixel bits of block (by, bx) of the frame at `frame`. PAIR: W is
// even and the mask 2-byte aligned, so a block row is one 16-bit load.
template <bool PAIR>
__device__ __forceinline__ int block_bits(const unsigned char* frame,
                                          const Geometry& g, int by,
                                          int bx) {
  const int y = 2 * by, x = 2 * bx;
  const unsigned char* row = frame + static_cast<long long>(y) * g.w + x;
  const bool down = y + 1 < g.h;
  if (PAIR) {
    unsigned top = __ldg(reinterpret_cast<const unsigned short*>(row));
    unsigned bot = down ? __ldg(reinterpret_cast<const unsigned short*>(
                              row + g.w))
                        : 0u;
    return ((top & 0xffu) ? 1 : 0) | ((top >> 8) ? 2 : 0) |
           ((bot & 0xffu) ? 4 : 0) | ((bot >> 8) ? 8 : 0);
  }
  const bool right = x + 1 < g.w;
  int bits = __ldg(row) ? 1 : 0;
  if (right && __ldg(row + 1)) bits |= 2;
  if (down) {
    if (__ldg(row + g.w)) bits |= 4;
    if (right && __ldg(row + g.w + 1)) bits |= 8;
  }
  return bits;
}

// lab is volatile: other threads hook roots while this one walks.
__device__ __forceinline__ int find_shared(const volatile int* lab, int x) {
  int p = lab[x];
  while (p != x) {
    x = p;
    p = lab[x];
  }
  return x;
}

__device__ void unite_shared(int* lab, int a, int b) {
  while (true) {
    a = find_shared(lab, a);
    b = find_shared(lab, b);
    if (a == b) return;
    if (a > b) {
      int t = a;
      a = b;
      b = t;
    }
    int old = atomicMin(lab + b, a);
    if (old == b) return;
    b = old;
  }
}

// Root of x in the global forest, halving the path on the way (safe
// while roots are hooked: a stored parent is always an ancestor).
__device__ __forceinline__ int find_halve(int* parent, int x) {
  while (true) {
    int p = __ldcg(parent + x);
    if (p == x) return x;
    int q = __ldcg(parent + p);
    if (q == p) return p;
    parent[x] = q;
    x = q;
  }
}

__device__ __forceinline__ int find_plain(const int* parent, int x) {
  int p = __ldcg(parent + x);
  while (p != x) {
    x = p;
    p = __ldcg(parent + x);
  }
  return x;
}

__device__ void unite_global(int* parent, int a, int b) {
  while (true) {
    a = find_halve(parent, a);
    b = find_halve(parent, b);
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

// 1. Label a tile of TBH x TBW blocks (a thread a block).
template <int TBH, int TBW, bool PAIR>
__global__ void __launch_bounds__(TBH * TBW)
    local_kernel(const unsigned char* __restrict__ mask, Geometry g,
                 int* __restrict__ parent, unsigned char* __restrict__ bits,
                 int* __restrict__ stats, int* __restrict__ count) {
  static_assert(32 % TBW == 0, "a tile row lies in one warp");
  constexpr int N = TBH * TBW;
  __shared__ int lab[N];
  __shared__ int run[N];
  __shared__ unsigned char sbits[N];
  __shared__ int st[6][N];
  const int i = threadIdx.x, lane = i & 31;
  const long long per_frame = static_cast<long long>(g.tiles_y) * g.tiles_x;
  const int f = static_cast<int>(blockIdx.x / per_frame);
  const int t = static_cast<int>(blockIdx.x % per_frame);
  const int ly = i / TBW, lx = i % TBW;
  const int by0 = (t / g.tiles_x) * TBH, bx0 = (t % g.tiles_x) * TBW;
  const int by = by0 + ly, bx = bx0 + lx;
  const bool inside = by < g.bh && bx < g.bw;
  const long long hw = static_cast<long long>(g.h) * g.w;
  const int me = inside ? block_bits<PAIR>(mask + f * hw, g, by, bx) : 0;
  const long long base = f * (static_cast<long long>(g.bh) * g.bw);
  const long long gi = base + static_cast<long long>(by) * g.bw + bx;
  if (!__syncthreads_or(me)) {  // a tile without foreground
    if (inside) bits[gi] = 0;
    if (blockIdx.x == 0 && i == 0) *count = 0;
    return;
  }
  // Runs along a tile row: a block joined to its W neighbour (the lane
  // before it) continues that block's run. Every block starts pointing
  // at its run's first block, so the W links need no union.
  const int w_bits = __shfl_up_sync(kFull, me, 1);
  const bool cont = lx > 0 && me && linked_w(me, w_bits);
  const unsigned starts = ~__ballot_sync(kFull, cont);
  const int rs = i - lane + 31 - __clz(starts & (kFull >> (31 - lane)));
  sbits[i] = static_cast<unsigned char>(me);
  run[i] = me ? rs : -1;
  lab[i] = me ? rs : -1;
  if (blockIdx.x == 0 && i == 0) *count = 0;
  __syncthreads();
  // Joins to the runs of the row above (NW, N, NE), each run pair once:
  // a run the W neighbour (same run) also reaches is joined by it, or by
  // the first block of the run that reaches it.
  if (me && ly > 0) {
    const int up = i - TBW;
    const int ra = lx > 0 && linked_nw(me, sbits[up - 1]) ? run[up - 1] : -1;
    const int rb = linked_n(me, sbits[up]) ? run[up] : -1;
    const int rc =
        lx + 1 < TBW && linked_ne(me, sbits[up + 1]) ? run[up + 1] : -1;
    int wa = -1, wb = -1, wc = -1;
    if (cont) {
      wa = lx > 1 && linked_nw(w_bits, sbits[up - 2]) ? run[up - 2] : -1;
      wb = linked_n(w_bits, sbits[up - 1]) ? run[up - 1] : -1;
      wc = linked_ne(w_bits, sbits[up]) ? run[up] : -1;
    }
    if (ra >= 0 && ra != wa && ra != wb && ra != wc)
      unite_shared(lab, rs, ra);
    if (rb >= 0 && rb != ra && rb != wa && rb != wb && rb != wc)
      unite_shared(lab, rs, rb);
    if (rc >= 0 && rc != ra && rc != rb && rc != wa && rc != wb && rc != wc)
      unite_shared(lab, rs, rc);
  }
  __syncthreads();
  const int r = me ? find_shared(lab, i) : -1;
  if (r == i) {
    st[0][i] = INT_MAX;  // x0
    st[1][i] = INT_MAX;  // y0
    st[2][i] = -1;       // x1
    st[3][i] = -1;       // y1
    st[4][i] = 0;        // area
    st[5][i] = INT_MAX;  // smallest flat pixel index
  }
  __syncthreads();
  // this block's statistics, reduced over the warp's blocks of one root
  const int x = 2 * bx, y = 2 * by;
  const int v0 = x + ((me & 5) ? 0 : 1);
  const int v1 = y + ((me & 3) ? 0 : 1);
  const int v2 = x + ((me & 10) ? 1 : 0);
  const int v3 = y + ((me & 12) ? 1 : 0);
  const int v4 = __popc(me);
  const int first = (me & 3) ? ((me & 1) ? x : x + 1)
                             : ((me & 4) ? x : x + 1);
  const int v5 = static_cast<int>(f * hw + static_cast<long long>(v1) * g.w +
                                  first);
  // The blocks of lane 0's root are reduced across the warp first (the
  // __reduce_*_sync reductions take a mask that is the same in every lane:
  // their result is one value a warp), the others add themselves alone.
  const int lead = __shfl_sync(kFull, r, 0);
  const bool led = r == lead;
  const int m0 = __reduce_min_sync(kFull, led ? v0 : INT_MAX);
  const int m1 = __reduce_min_sync(kFull, led ? v1 : INT_MAX);
  const int m2 = __reduce_max_sync(kFull, led ? v2 : -1);
  const int m3 = __reduce_max_sync(kFull, led ? v3 : -1);
  const int m4 = __reduce_add_sync(kFull, led ? v4 : 0);
  const int m5 = __reduce_min_sync(kFull, led ? v5 : INT_MAX);
  if (lead >= 0 && lane == 0) {
    atomicMin(&st[0][lead], m0);
    atomicMin(&st[1][lead], m1);
    atomicMax(&st[2][lead], m2);
    atomicMax(&st[3][lead], m3);
    atomicAdd(&st[4][lead], m4);
    atomicMin(&st[5][lead], m5);
  }
  if (r >= 0 && !led) {
    atomicMin(&st[0][r], v0);
    atomicMin(&st[1][r], v1);
    atomicMax(&st[2][r], v2);
    atomicMax(&st[3][r], v3);
    atomicAdd(&st[4][r], v4);
    atomicMin(&st[5][r], v5);
  }
  __syncthreads();
  if (!inside) return;
  bits[gi] = static_cast<unsigned char>(me | (r == i ? kRootBit : 0));
  if (!me) return;
  const int root = static_cast<int>(
      base + static_cast<long long>(by0 + r / TBW) * g.bw + bx0 + r % TBW);
  parent[gi] = root;
  if (r == i) {
#pragma unroll
    for (int k = 0; k < 6; ++k) stats[k * g.n_blocks + gi] = st[k][i];
  }
}

// A block's tile root: itself, or its parent. The border launch stores
// parents at tile roots only, so a tile root read this way stays valid
// through that launch.
__device__ __forceinline__ int tile_root(const int* parent,
                                         const unsigned char* bits, int x) {
  return (bits[x] & kRootBit) ? x : parent[x];
}

// 2. Join the blocks on tile borders with their neighbours in other
// tiles. A tile has TBW + 2 (TBH - 1) border positions: its first row,
// then its first and its last column below that row. A join of two tile
// roots is left out where the same pair is joined by a link that is sure
// to be made: the previous block's along the same edge (its N link on the
// first row, its W link on the first column, the right tile's W link for
// a last-column NE link) or this block's own N or W link. Those chains
// point left, up or to N and W links only, so each ends at a join that is
// made.
template <int TBH, int TBW>
__global__ void border_kernel(Geometry g, int* __restrict__ parent,
                              const unsigned char* __restrict__ bits,
                              long long n_items) {
  constexpr int P = TBW + 2 * (TBH - 1);
  const long long item = blockIdx.x * static_cast<long long>(blockDim.x) +
                         threadIdx.x;
  if (item >= n_items) return;
  const long long tile = item / P;
  const int pos = static_cast<int>(item % P);
  const long long per_frame = static_cast<long long>(g.tiles_y) * g.tiles_x;
  const long long f = tile / per_frame;
  const int t = static_cast<int>(tile % per_frame);
  int ly, lx;
  if (pos < TBW) {
    ly = 0;
    lx = pos;
  } else {
    ly = 1 + (pos - TBW) / 2;
    lx = ((pos - TBW) & 1) ? TBW - 1 : 0;
  }
  const int by = (t / g.tiles_x) * TBH + ly, bx = (t % g.tiles_x) * TBW + lx;
  if (by >= g.bh || bx >= g.bw) return;
  const long long base = f * (static_cast<long long>(g.bh) * g.bw);
  const int me_i = static_cast<int>(base + static_cast<long long>(by) * g.bw +
                                    bx);
  const int me = bits[me_i] & 15;
  if (!me) return;
  const int mine = tile_root(parent, bits, me_i);
  int w_pair = -1, n_pair = -1;  // the tile roots this block's W, N reach
  if (lx == 0 && bx > 0 && linked_w(me, bits[me_i - 1] & 15)) {
    w_pair = tile_root(parent, bits, me_i - 1);
    const int up = me_i - g.bw;  // in this tile when ly > 0
    if (!(ly > 0 && linked_w(bits[up] & 15, bits[up - 1] & 15) &&
          tile_root(parent, bits, up) == mine &&
          tile_root(parent, bits, up - 1) == w_pair))
      unite_global(parent, mine, w_pair);
  }
  if (by == 0) return;
  const int up = me_i - g.bw;
  if (ly == 0 && linked_n(me, bits[up] & 15)) {
    n_pair = tile_root(parent, bits, up);
    if (!(lx > 0 && linked_n(bits[me_i - 1] & 15, bits[up - 1] & 15) &&
          tile_root(parent, bits, me_i - 1) == mine &&
          tile_root(parent, bits, up - 1) == n_pair))
      unite_global(parent, mine, n_pair);
  }
  if ((ly == 0 || lx == 0) && bx > 0 && linked_nw(me, bits[up - 1] & 15)) {
    const int other = tile_root(parent, bits, up - 1);
    bool dup = other == n_pair || other == w_pair;
    if (ly == 0 && lx > 0)  // the left block's N link
      dup = dup || (linked_n(bits[me_i - 1] & 15, bits[up - 1] & 15) &&
                    tile_root(parent, bits, me_i - 1) == mine);
    if (ly > 0)  // the block above's W link
      dup = dup || (linked_w(bits[up] & 15, bits[up - 1] & 15) &&
                    tile_root(parent, bits, up) == mine);
    if (!dup) unite_global(parent, mine, other);
  }
  if ((ly == 0 || lx == TBW - 1) && bx + 1 < g.bw &&
      linked_ne(me, bits[up + 1] & 15)) {
    const int other = tile_root(parent, bits, up + 1);
    bool dup = other == n_pair;
    if (ly == 0 && lx + 1 < TBW)  // the right block's N link
      dup = dup || (linked_n(bits[me_i + 1] & 15, bits[up + 1] & 15) &&
                    tile_root(parent, bits, me_i + 1) == mine);
    if (ly > 0)  // the right tile's W link from up + 1 to up
      dup = dup || (linked_w(bits[up + 1] & 15, bits[up] & 15) &&
                    tile_root(parent, bits, up) == mine);
    if (!dup) unite_global(parent, mine, other);
  }
}

// 3. Each tile root: point at the component's root, add its statistics
// there. No path is rewritten here but a tile root's own parent. A thread
// reads the bits of four blocks as one word (`bits` is 4-byte aligned).
__global__ void roots_kernel(int* __restrict__ parent,
                             const unsigned char* __restrict__ bits,
                             int* __restrict__ stats, long long n_blocks) {
  const long long g0 =
      4 * (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x);
  if (g0 >= n_blocks) return;
  unsigned word = 0;
  if (g0 + 4 <= n_blocks) {
    word = *reinterpret_cast<const unsigned*>(bits + g0);
  } else {
    for (int k = 0; g0 + k < n_blocks; ++k)
      word |= static_cast<unsigned>(bits[g0 + k]) << (8 * k);
  }
  word &= kRootBit * 0x01010101u;
  while (word) {
    const int k = (__ffs(word) - 1) / 8;
    word &= word - 1;
    const long long gi = g0 + k;
    const int me = static_cast<int>(gi);
    const int r = find_plain(parent, me);
    if (r == me) continue;
    parent[gi] = r;
    atomicMin(stats + r, stats[gi]);
    atomicMin(stats + n_blocks + r, stats[n_blocks + gi]);
    atomicMax(stats + 2 * n_blocks + r, stats[2 * n_blocks + gi]);
    atomicMax(stats + 3 * n_blocks + r, stats[3 * n_blocks + gi]);
    atomicAdd(stats + 4 * n_blocks + r, stats[4 * n_blocks + gi]);
    atomicMin(stats + 5 * n_blocks + r, stats[5 * n_blocks + gi]);
  }
}

// 4. Labels (a thread a block: its 2 x 2 pixels) and the table rows.
template <bool PAIR>
__global__ void __launch_bounds__(kLabelThreads)
    label_kernel(Geometry g, const int* __restrict__ parent,
                 const unsigned char* __restrict__ bits,
                 const int* __restrict__ stats, int* __restrict__ labels,
                 int* __restrict__ count, int* __restrict__ table,
                 int capacity) {
  const long long gi = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
  const bool inside = gi < g.n_blocks;
  const int me = inside ? bits[gi] & 15 : 0;
  int root = -1, first = -1;
  if (me) {
    root = __ldg(parent + __ldg(parent + gi));
    first = __ldg(stats + 5 * g.n_blocks + root);
  }
  // the component roots of this warp take consecutive table slots
  const bool is_root = me && root == gi;
  const unsigned roots = __ballot_sync(kFull, is_root);
  const int lane = threadIdx.x & 31;
  int slot0 = 0;
  if (roots) {
    const int leader = __ffs(roots) - 1;
    if (lane == leader) slot0 = atomicAdd(count, __popc(roots));
    slot0 = __shfl_sync(kFull, slot0, leader);
  }
  if (!inside) return;
  const long long per_frame = static_cast<long long>(g.bh) * g.bw;
  const long long f = gi / per_frame;
  const int key = static_cast<int>(gi % per_frame);
  const int by = key / g.bw, bx = key % g.bw;
  if (is_root) {
    const int s = slot0 + __popc(roots & ((1u << lane) - 1u));
    table[s] = first;
#pragma unroll
    for (int k = 0; k < 5; ++k)
      table[(k + 1) * capacity + s] = __ldg(stats + k * g.n_blocks + root);
    table[6 * capacity + s] = key;
  }
  const int y = 2 * by, x = 2 * bx;
  int* out = labels + f * (static_cast<long long>(g.h) * g.w) +
             static_cast<long long>(y) * g.w + x;
  const int a = (me & 1) ? first : -1, b = (me & 2) ? first : -1;
  const int c = (me & 4) ? first : -1, d = (me & 8) ? first : -1;
  const bool down = y + 1 < g.h;
  if (PAIR) {
    *reinterpret_cast<int2*>(out) = make_int2(a, b);
    if (down) *reinterpret_cast<int2*>(out + g.w) = make_int2(c, d);
    return;
  }
  const bool right = x + 1 < g.w;
  out[0] = a;
  if (right) out[1] = b;
  if (down) {
    out[g.w] = c;
    if (right) out[g.w + 1] = d;
  }
}

inline int status(cudaError_t e) {
  return e == cudaSuccess ? 0 : 1000 + static_cast<int>(e);
}

// The four launches at tile shape TBH x TBW (blocks), on `stream`.
template <int TBH, int TBW>
int launch(const unsigned char* mask, int* labels, int* parent,
           unsigned char* bits, int* stats, int* count, int* table,
           int capacity, int batch, int h, int w, cudaStream_t stream) {
  Geometry g;
  g.h = h;
  g.w = w;
  g.bh = (h + 1) / 2;
  g.bw = (w + 1) / 2;
  g.tiles_y = (g.bh + TBH - 1) / TBH;
  g.tiles_x = (g.bw + TBW - 1) / TBW;
  g.n_blocks = static_cast<long long>(batch) * g.bh * g.bw;
  if (g.n_blocks == 0) return status(cudaMemsetAsync(count, 0, sizeof(int),
                                                     stream));
  if (reinterpret_cast<uintptr_t>(bits) % 4 != 0)
    return status(cudaErrorInvalidValue);
  const long long tiles = static_cast<long long>(batch) * g.tiles_y *
                          g.tiles_x;
  // W even and the mask 2-byte aligned: 16-bit mask loads, 8-byte label
  // stores (the labels are the wrapper's fresh allocation)
  const bool pair = w % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(mask) % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(labels) % 8 == 0;
  if (pair)
    local_kernel<TBH, TBW, true><<<static_cast<unsigned>(tiles), TBH * TBW,
                                   0, stream>>>(mask, g, parent, bits, stats,
                                                count);
  else
    local_kernel<TBH, TBW, false><<<static_cast<unsigned>(tiles), TBH * TBW,
                                    0, stream>>>(mask, g, parent, bits, stats,
                                                 count);
  const long long items = tiles * (TBW + 2 * (TBH - 1));
  border_kernel<TBH, TBW>
      <<<static_cast<unsigned>((items + 255) / 256), 256, 0, stream>>>(
          g, parent, bits, items);
  const unsigned grid = static_cast<unsigned>(
      (g.n_blocks + kLabelThreads - 1) / kLabelThreads);
  roots_kernel<<<(grid + 3) / 4, kLabelThreads, 0, stream>>>(
      parent, bits, stats, g.n_blocks);
  if (pair)
    label_kernel<true><<<grid, kLabelThreads, 0, stream>>>(
        g, parent, bits, stats, labels, count, table, capacity);
  else
    label_kernel<false><<<grid, kLabelThreads, 0, stream>>>(
        g, parent, bits, stats, labels, count, table, capacity);
  return status(cudaGetLastError());
}

// The tile shape of the port (tools/ccl_lk_variants_torch.py times others).
constexpr int kTileH = 16, kTileW = 32;

}  // namespace ccl

// capacity = batch * ceil(h / 2) * ceil(w / 2); parent (capacity) int32,
// bits (capacity) uint8, 4-byte aligned, and stats (6, capacity) int32
// are scratch.
extern "C" int faceoff_ccl(const unsigned char* mask, int* labels,
                           int* parent, unsigned char* bits, int* stats,
                           int* count, int* table, int capacity, int batch,
                           int h, int w, void* stream_ptr) {
  return ccl::launch<ccl::kTileH, ccl::kTileW>(
      mask, labels, parent, bits, stats, count, table, capacity, batch, h, w,
      static_cast<cudaStream_t>(stream_ptr));
}
