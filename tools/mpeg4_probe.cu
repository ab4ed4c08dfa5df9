// Variants of kernels V1 (dequantisation and IDCT), V2 (motion
// compensation, half- and quarter-pel), V3 (motion search), V4 (forward
// DCT and quantisation) and V5 (bidirectional prediction) of
// faceoff_tpu_torch/csrc/mpeg4.cu, built and timed by
// tools/mp4_variants_torch.py beside the port's own kernels to find what
// bounds them on the card. Not used by the port. The port's source is
// included, so its templates (dequant_idct_kernel<BPB, RPT>,
// motion_compensate_kernel<ROWS, MBS, RES>, motion_search_kernel<RUN, DY,
// MBS>, fdct_quant_kernel<MBS>, motion_compensate_qpel_kernel<MBS>,
// bidir_compensate_kernel<MBS, QPEL>) are instantiated here at other
// shapes.
//
// V1 variants (probe_dequant_idct):
//   0 original    the first form of the port: 8 threads a block, 32 blocks
//                 a CUDA block, eight scalar level loads and the bidx and
//                 record chain on every thread, int16 rows in shared
//                 memory, a 64-bit column pass, eight scalar stores
//   1 block       a thread an 8 x 8 block: both passes in registers, eight
//                 16-byte loads and stores
//   2 copy        a thread a row at the port's shape: V1's loads (levels,
//                 bidx, record) and 16-byte stores, no arithmetic: the
//                 floor the memory system gives this access pattern
//   3..           dequant_idct_kernel<BPB, RPT> at PROBE_IDCT's shapes
//                 (blocks a CUDA block, rows a thread)
// V2 variants (probe_motion_compensate):
//   0 original    the first form of the port: a CUDA block a macroblock, a
//                 thread a luma pixel (the first 128 also a chroma pixel),
//                 the item, record and taps loaded by every thread, a byte
//                 at a time
//   1 copy        the port's residual shape doing V2's loads (item,
//                 records and residual into shared memory, the reference
//                 words) and 8-byte stores, no averaging: the floor of this
//                 access pattern
//   2..           motion_compensate_kernel<ROWS, MBS, RES> at PROBE_MC's
//                 shapes, RES 1 for a call with a residual, else 0
// V2 at quarter-pel (probe_mc_qpel) and V5 (probe_bidir_compensate):
//   0 original    PR 21's form (asp_original): a CUDA block of 256 threads
//                 a macroblock, samples staged as int in shared memory
//                 behind block-wide barriers, a thread a pixel
//   1 copy        the port's warp-a-macroblock shape doing its loads (the
//                 record, the residual rows, each direction's window words
//                 or reference rows, the chroma rows) and 8-byte stores,
//                 no filtering: the floor of this access pattern
//   2-4           the copy without the residual, without the references,
//                 without both (the record and the stores)
//   5             the record and the stores, each warp storing its own
//                 rows (16 rows of 16 bytes a warp-wide store)
//   6..           motion_compensate_qpel_kernel<MBS, MINB, STAGE> and
//                 bidir_compensate_kernel<MBS, QPEL, MINB, STAGE> at
//                 PROBE_GM's shapes (64 registers), at the port's MBS with
//                 PROBE_GM_MINB's CUDA blocks an SM (__launch_bounds__'
//                 second argument), then at the port's shape with the
//                 block's rows staged and unstaged
#include "../faceoff_tpu_torch/csrc/mpeg4.cu"

namespace original {

__constant__ int kHalf[9][2] = {{0, 0}, {-1, -1}, {0, -1}, {1, -1}, {-1, 0},
                                {1, 0}, {-1, 1}, {0, 1}, {1, 1}};
constexpr int WIN = 52;
constexpr int WIN_OFF = 18;
constexpr int WIN_WORDS = 14;
constexpr int N_CAND = SIDE * SIDE;

__global__ void motion_search(const uint8_t* __restrict__ Y, int h16,
                              int w16, const int32_t* __restrict__ items,
                              int width, int height,
                              int32_t* __restrict__ out) {
  __shared__ uint32_t win[WIN * WIN_WORDS];
  __shared__ uint32_t cur[16 * 4];
  __shared__ unsigned long long best[256];
  __shared__ int sums[12];
  int m = blockIdx.x, t = threadIdx.x;
  int c_i = items[blockIdx.y * 2], r_i = items[blockIdx.y * 2 + 1];
  int mbw = w16 >> 4;
  int my = m / mbw, mx = m % mbw;
  int n_mb = gridDim.x;
  size_t plane = (size_t)h16 * w16;
  const uint8_t* cp = Y + c_i * plane;
  const uint8_t* rp = Y + r_i * plane;
  uint8_t* wb = reinterpret_cast<uint8_t*>(win);
  int oy = my * 16 - WIN_OFF, ox = mx * 16 - WIN_OFF;
  for (int i = t; i < WIN * WIN_WORDS * 4; i += 256) {
    int wy = i / (WIN_WORDS * 4), wx = i % (WIN_WORDS * 4);
    int yy = min(max(oy + wy, 0), height - 1);
    int xx = min(max(ox + wx, 0), width - 1);
    wb[i] = rp[(size_t)yy * w16 + xx];
  }
  if (t < 64) {
    int py = t >> 2, w = t & 3;
    const uint8_t* s = cp + (size_t)(my * 16 + py) * w16 + mx * 16 + 4 * w;
    cur[t] = s[0] | (s[1] << 8) | (s[2] << 16) | ((uint32_t)s[3] << 24);
  }
  if (t < 12) sums[t] = 0;
  __syncthreads();
  unsigned long long mine = ~0ull;
  for (int c = t; c < N_CAND; c += 256) {
    int dy = c / (2 * RANGE + 1) - RANGE, dx = c % (2 * RANGE + 1) - RANGE;
    int sad = 0;
    int col = WIN_OFF + dx;
    int sh = col & 3;
    unsigned sel = 0x3210 + 0x1111 * sh;
    for (int py = 0; py < 16; ++py) {
      const uint32_t* wr = win + (WIN_OFF + dy + py) * WIN_WORDS + (col >> 2);
      uint32_t w0 = wr[0], w1 = wr[1], w2 = wr[2], w3 = wr[3], w4 = wr[4];
      sad += __vsadu4(__byte_perm(w0, w1, sel), cur[py * 4 + 0]);
      sad += __vsadu4(__byte_perm(w1, w2, sel), cur[py * 4 + 1]);
      sad += __vsadu4(__byte_perm(w2, w3, sel), cur[py * 4 + 2]);
      sad += __vsadu4(__byte_perm(w3, w4, sel), cur[py * 4 + 3]);
    }
    int cheb = max(abs(dx), abs(dy));
    unsigned long long key = ((unsigned long long)sad << 17) |
                             (cheb << 12) | ((dy + RANGE) << 6) | (dx + RANGE);
    mine = min(mine, key);
  }
  best[t] = mine;
  __syncthreads();
  for (int s = 128; s > 0; s >>= 1) {
    if (t < s) best[t] = min(best[t], best[t + s]);
    __syncthreads();
  }
  unsigned long long k = best[0];
  int order = (int)(k & ((1 << 17) - 1));
  int bdx = (order & 63) - RANGE, bdy = ((order >> 6) & 63) - RANGE;
  int py = t >> 4, px = t & 15;
  int cv = cp[(size_t)(my * 16 + py) * w16 + mx * 16 + px];
  for (int i = 0; i < 9; ++i) {
    int X = 2 * (WIN_OFF + px + bdx) + kHalf[i][0];
    int Yh = 2 * (WIN_OFF + py + bdy) + kHalf[i][1];
    int x0 = X >> 1, y0 = Yh >> 1, fx = X & 1, fy = Yh & 1;
    int a = wb[y0 * WIN_WORDS * 4 + x0], b = wb[y0 * WIN_WORDS * 4 + x0 + 1];
    int c = wb[(y0 + 1) * WIN_WORDS * 4 + x0];
    int d = wb[(y0 + 1) * WIN_WORDS * 4 + x0 + 1];
    int p = !fx ? (!fy ? a : (a + c + 1) >> 1)
                : (!fy ? (a + b + 1) >> 1 : (a + b + c + d + 2) >> 2);
    atomicAdd(&sums[i], abs(p - cv));
  }
  atomicAdd(&sums[9], cv);
  __syncthreads();
  int mean = (sums[9] + 128) >> 8;
  atomicAdd(&sums[10], abs(cv - mean));
  __syncthreads();
  if (t == 0) {
    int bi = 0;
    for (int i = 1; i < 9; ++i)
      if (sums[i] < sums[bi]) bi = i;
    int sad = sums[bi];
    bool intra = sums[10] + 512 < sad;
    int32_t* o = out + ((size_t)blockIdx.y * n_mb + m) * 3;
    o[0] = intra ? MB_INTRA : MB_INTER;
    o[1] = intra ? 0 : 2 * bdx + kHalf[bi][0];
    o[2] = intra ? 0 : 2 * bdy + kHalf[bi][1];
  }
}

__global__ void fdct_quant(
    const uint8_t* __restrict__ sy, const uint8_t* __restrict__ su,
    const uint8_t* __restrict__ sv, const uint8_t* __restrict__ py_,
    const uint8_t* __restrict__ pu, const uint8_t* __restrict__ pv, int h16,
    int w16, const int32_t* __restrict__ mb, int n_mb,
    const int32_t* __restrict__ items, int16_t* __restrict__ out) {
  __shared__ int x[6][64];
  __shared__ int tr[6][64];
  int m = blockIdx.x, t = threadIdx.x;
  int b = t >> 6, i = t & 63;
  int s_i = items[blockIdx.y * 2], p_i = items[blockIdx.y * 2 + 1];
  int mbw = w16 >> 4;
  int my = m / mbw, mx = m % mbw;
  const int32_t* rec = mb + ((size_t)blockIdx.y * n_mb + m) * MB_FIELDS;
  bool intra = rec[0] == MB_INTRA;
  int qp = rec[1];
  size_t lplane = (size_t)h16 * w16, cplane = lplane >> 2;
  int yy = i >> 3, xx = i & 7;
  int v;
  if (b < 4) {
    size_t o = (size_t)(my * 16 + (b >> 1) * 8 + yy) * w16 + mx * 16 +
               (b & 1) * 8 + xx;
    v = sy[s_i * lplane + o];
    if (!intra) v -= py_[p_i * lplane + o];
  } else {
    size_t o = (size_t)(my * 8 + yy) * (w16 >> 1) + mx * 8 + xx;
    const uint8_t* s = b == 4 ? su : sv;
    const uint8_t* p = b == 4 ? pu : pv;
    v = s[s_i * cplane + o];
    if (!intra) v -= p[p_i * cplane + o];
  }
  x[b][i] = v;
  __syncthreads();
  {
    int y = i >> 3, u = i & 7;
    int s = 0;
    for (int k = 0; k < 8; ++k) s += x[b][y * 8 + k] * kFdct[u * 8 + k];
    tr[b][i] = (s + 512) >> 10;
  }
  __syncthreads();
  int vv = i >> 3, u = i & 7;
  int s = 0;
  for (int k = 0; k < 8; ++k) s += kFdct[vv * 8 + k] * tr[b][k * 8 + u];
  int F = (s + 32768) >> 16;
  int lv;
  if (i == 0 && intra) {
    int sc = d_dc_scaler(qp, b < 4);
    int q = F + (sc >> 1);
    q = q >= 0 ? q / sc : -((-q + sc - 1) / sc);
    lv = min(max(q, 1), 254);
  } else {
    int a = abs(F);
    int mag = intra ? a / (2 * qp) : max(a - qp / 2, 0) / (2 * qp);
    mag = min(mag, 2047);
    lv = F < 0 ? -mag : (F > 0 ? mag : 0);
  }
  out[(((size_t)blockIdx.y * n_mb + m) * 6 + b) * 64 + i] = (int16_t)lv;
}

// the port's first V1 and V2
__constant__ int kW[8] = {0, 22725, 21407, 19266, 16383, 12873, 8867, 4520};
__constant__ int kChromaRound[16] = {0, 0, 0, 1, 1, 1, 1, 1,
                                     1, 1, 1, 1, 1, 1, 2, 2};
constexpr int V1_BLOCKS = 32;

__global__ void dequant_idct(const int16_t* __restrict__ blocks,
                             const int32_t* __restrict__ bidx, int nb,
                             const int32_t* __restrict__ mb,
                             int16_t* __restrict__ out) {
  __shared__ int16_t rows[V1_BLOCKS][64];
  int local = threadIdx.x >> 3, r = threadIdx.x & 7;
  int j = blockIdx.x * V1_BLOCKS + local;
  bool live = j < nb;
  int idx = live ? bidx[j] : 0;
  if (live) {
    const int32_t* rec = mb + (size_t)(idx / 6) * MB_FIELDS;
    int qp = rec[1];
    bool intra = rec[0] == MB_INTRA;
    bool luma = (idx % 6) < 4;
    int x[8];
    for (int c = 0; c < 8; ++c) {
      int l = blocks[(size_t)j * 64 + r * 8 + c];
      int f;
      if (r == 0 && c == 0 && intra) {
        f = l * d_dc_scaler(qp, luma);
      } else if (l == 0) {
        f = 0;
      } else {
        int mag = qp * (2 * abs(l) + 1) - (1 - (qp & 1));
        f = l < 0 ? -mag : mag;
      }
      x[c] = min(max(f, -2048), 2047);
    }
    bool dc_only = !(x[1] | x[2] | x[3] | x[4] | x[5] | x[6] | x[7]);
    int16_t* o = &rows[local][r * 8];
    if (dc_only) {
      int v = d_wrap16((long long)x[0] * 8);
      for (int c = 0; c < 8; ++c) o[c] = (int16_t)v;
    } else {
      int a0 = kW[4] * x[0] + (1 << 10), a1 = a0, a2 = a0, a3 = a0;
      a0 += kW[2] * x[2] + kW[4] * x[4] + kW[6] * x[6];
      a1 += kW[6] * x[2] - kW[4] * x[4] - kW[2] * x[6];
      a2 += -kW[6] * x[2] - kW[4] * x[4] + kW[2] * x[6];
      a3 += -kW[2] * x[2] + kW[4] * x[4] - kW[6] * x[6];
      int b0 = kW[1] * x[1] + kW[3] * x[3] + kW[5] * x[5] + kW[7] * x[7];
      int b1 = kW[3] * x[1] - kW[7] * x[3] - kW[1] * x[5] - kW[5] * x[7];
      int b2 = kW[5] * x[1] - kW[1] * x[3] + kW[7] * x[5] + kW[3] * x[7];
      int b3 = kW[7] * x[1] - kW[5] * x[3] + kW[3] * x[5] - kW[1] * x[7];
      o[0] = (int16_t)d_wrap16((a0 + b0) >> 11);
      o[1] = (int16_t)d_wrap16((a1 + b1) >> 11);
      o[2] = (int16_t)d_wrap16((a2 + b2) >> 11);
      o[3] = (int16_t)d_wrap16((a3 + b3) >> 11);
      o[4] = (int16_t)d_wrap16((a3 - b3) >> 11);
      o[5] = (int16_t)d_wrap16((a2 - b2) >> 11);
      o[6] = (int16_t)d_wrap16((a1 - b1) >> 11);
      o[7] = (int16_t)d_wrap16((a0 - b0) >> 11);
    }
  }
  __syncthreads();
  if (!live) return;
  long long x[8];
  for (int k = 0; k < 8; ++k) x[k] = rows[local][k * 8 + r];
  long long a0 = (long long)kW[4] * (x[0] + ((1 << 19) / kW[4]));
  long long a1 = a0, a2 = a0, a3 = a0;
  a0 += kW[2] * x[2] + kW[4] * x[4] + kW[6] * x[6];
  a1 += kW[6] * x[2] - kW[4] * x[4] - kW[2] * x[6];
  a2 += -kW[6] * x[2] - kW[4] * x[4] + kW[2] * x[6];
  a3 += -kW[2] * x[2] + kW[4] * x[4] - kW[6] * x[6];
  long long b0 = kW[1] * x[1] + kW[3] * x[3] + kW[5] * x[5] + kW[7] * x[7];
  long long b1 = kW[3] * x[1] - kW[7] * x[3] - kW[1] * x[5] - kW[5] * x[7];
  long long b2 = kW[5] * x[1] - kW[1] * x[3] + kW[7] * x[5] + kW[3] * x[7];
  long long b3 = kW[7] * x[1] - kW[5] * x[3] + kW[3] * x[5] - kW[1] * x[7];
  int16_t* o = out + (size_t)idx * 64 + r;
  o[0] = (int16_t)d_wrap16((a0 + b0) >> 20);
  o[8] = (int16_t)d_wrap16((a1 + b1) >> 20);
  o[16] = (int16_t)d_wrap16((a2 + b2) >> 20);
  o[24] = (int16_t)d_wrap16((a3 + b3) >> 20);
  o[32] = (int16_t)d_wrap16((a3 - b3) >> 20);
  o[40] = (int16_t)d_wrap16((a2 - b2) >> 20);
  o[48] = (int16_t)d_wrap16((a1 - b1) >> 20);
  o[56] = (int16_t)d_wrap16((a0 - b0) >> 20);
}

// half-pel sample of a plane at half-pel (X, Y), every tap clamped into w x h
__device__ __forceinline__ int interp(const uint8_t* __restrict__ p,
                                      int stride, int X, int Y, int w, int h,
                                      int rnd) {
  int x0 = X >> 1, y0 = Y >> 1, fx = X & 1, fy = Y & 1;
  int xa = min(max(x0, 0), w - 1), xb = min(max(x0 + 1, 0), w - 1);
  int ya = min(max(y0, 0), h - 1), yb = min(max(y0 + 1, 0), h - 1);
  int a = p[ya * stride + xa];
  if (!fx && !fy) return a;
  if (!fy) return (a + p[ya * stride + xb] + 1 - rnd) >> 1;
  int c = p[yb * stride + xa];
  if (!fx) return (a + c + 1 - rnd) >> 1;
  return (a + p[ya * stride + xb] + c + p[yb * stride + xb] + 2 - rnd) >> 2;
}

__device__ __forceinline__ int table_chroma_vector(int s) {
  return kChromaRound[s & 15] + ((s >> 3) & ~1);
}

__global__ void motion_compensate(
    uint8_t* __restrict__ Y, uint8_t* __restrict__ U, uint8_t* __restrict__ V,
    int h16, int w16, const int32_t* __restrict__ mb, int n_mb,
    const int16_t* __restrict__ res, const int32_t* __restrict__ items,
    int width, int height) {
  int m = blockIdx.x, t = threadIdx.x;
  const int32_t* it = items + blockIdx.y * 4;
  int f = it[0], ref = it[1], outs = it[2], rnd = it[3];
  int mbw = w16 >> 4;
  int my = m / mbw, mx = m % mbw;
  const int32_t* rec = mb + ((size_t)f * n_mb + m) * MB_FIELDS;
  bool intra = rec[0] == MB_INTRA;
  size_t lplane = (size_t)h16 * w16, cplane = lplane >> 2;
  const int16_t* r = res ? res + ((size_t)f * n_mb + m) * 6 * 64 : nullptr;
  {
    int py = t >> 4, px = t & 15;
    int b = ((py >= 8) << 1) | (px >= 8);
    int lx = mx * 16 + px, ly = my * 16 + py;
    int p = 0;
    if (!intra && ref >= 0)
      p = interp(Y + ref * lplane, w16, 2 * lx + rec[4 + 2 * b],
                 2 * ly + rec[5 + 2 * b], width, height, rnd);
    int rv = r ? r[b * 64 + (py & 7) * 8 + (px & 7)] : 0;
    Y[outs * lplane + (size_t)ly * w16 + lx] =
        (uint8_t)min(max(p + rv, 0), 255);
  }
  if (t < 128) {
    int c = t >> 6, q = t & 63;
    int cy = q >> 3, cx = q & 7;
    uint8_t* P = c ? V : U;
    int cw = w16 >> 1;
    int lx = mx * 8 + cx, ly = my * 8 + cy;
    int p = 0;
    if (!intra && ref >= 0) {
      int sx = rec[4] + rec[6] + rec[8] + rec[10];
      int sy = rec[5] + rec[7] + rec[9] + rec[11];
      p = interp(P + ref * cplane, cw, 2 * lx + table_chroma_vector(sx),
                 2 * ly + table_chroma_vector(sy), width >> 1, height >> 1,
                 rnd);
    }
    int rv = r ? r[(4 + c) * 64 + q] : 0;
    P[outs * cplane + (size_t)ly * cw + lx] =
        (uint8_t)min(max(p + rv, 0), 255);
  }
}

}  // namespace original

namespace old {

// The earlier forms of the redesigned V3, at their own window size:
// runs padded past dx 16, the shifts made again under each dy's branch.
// first: border windows a byte at a time, a pixel a half-pel task with ten
// reductions a task. second: clamped-row vector fills, a column of 4
// pixels a half-pel task.
constexpr int WIN_ROWS = 56;
__constant__ int kHalf[9][2] = {{0, 0}, {-1, -1}, {0, -1}, {1, -1}, {-1, 0},
                                {1, 0}, {-1, 1}, {0, 1}, {1, 1}};

template <int R, int D, int MPB>
struct OldShape {
  static_assert(R % 4 == 0, "runs start on a word");
  static constexpr int NRUN = (SIDE + R - 1) / R;
  static constexpr int NDY = (SIDE + D - 1) / D;
  static constexpr int LIVE = NRUN * NDY;  // threads of a macroblock
  static constexpr int THREADS = (LIVE * MPB + 31) / 32 * 32;
  static constexpr int NW = R / 4 + 4;     // words of a row a thread loads
  static_assert(WIN_Y + (NDY - 1) * D - RANGE + D + 14 < WIN_ROWS,
                "the window holds every row read");
  static_assert(WIN_X + (NRUN - 1) * R - RANGE + 4 * NW <= WIN_LOAD,
                "the window holds every column read");
};

template <int R, int D, int MPB>
__global__ void __launch_bounds__(OldShape<R, D, MPB>::THREADS)
first_search(const uint8_t* __restrict__ Y, int h16, int w16,
                     const int32_t* __restrict__ items, int n_mb, int width,
                     int height, int32_t* __restrict__ out) {
  using S = OldShape<R, D, MPB>;
  __shared__ __align__(16) uint8_t win[MPB][WIN_ROWS * WIN_STRIDE];
  __shared__ uint4 cur[MPB][16];
  __shared__ unsigned best[MPB];
  __shared__ int sums[MPB][11];  // 9 half-pel SADs, the deviation, the sum
  const int t = threadIdx.x, lane = t & 31;
  const int g = blockIdx.y;
  const int c_i = items[2 * g], r_i = items[2 * g + 1];
  const size_t plane = (size_t)h16 * w16;
  const uint8_t* cp = Y + c_i * plane;
  const uint8_t* rp = Y + r_i * plane;
  const int mbw = w16 >> 4;
  const int m0 = blockIdx.x * MPB;
#pragma unroll 1
  for (int k = 0; k < MPB && m0 + k < n_mb; ++k) {
    const int m = m0 + k, my = m / mbw, mx = m - my * mbw;
    const int oy = my * 16 - WIN_Y, ox = mx * 16 - WIN_X;
    uint8_t* w = win[k];
    if (oy >= 0 && ox >= 0 && oy + WIN_ROWS <= height &&
        ox + WIN_LOAD <= width) {
      for (int i = t; i < WIN_ROWS * (WIN_LOAD / 16); i += S::THREADS) {
        const int wy = i / (WIN_LOAD / 16), q = i - wy * (WIN_LOAD / 16);
        const uint4 v = *reinterpret_cast<const uint4*>(
            rp + (size_t)(oy + wy) * w16 + ox + 16 * q);
        uint2* d = reinterpret_cast<uint2*>(w + wy * WIN_STRIDE + 16 * q);
        d[0] = make_uint2(v.x, v.y);
        d[1] = make_uint2(v.z, v.w);
      }
    } else {
      for (int i = t; i < WIN_ROWS * WIN_LOAD; i += S::THREADS) {
        const int wy = i / WIN_LOAD, wx = i - wy * WIN_LOAD;
        const int yy = min(max(oy + wy, 0), height - 1);
        const int xx = min(max(ox + wx, 0), width - 1);
        w[wy * WIN_STRIDE + wx] = rp[(size_t)yy * w16 + xx];
      }
    }
    if (t < 16)
      cur[k][t] = *reinterpret_cast<const uint4*>(
          cp + (size_t)(my * 16 + t) * w16 + mx * 16);
    if (t < 11) sums[k][t] = 0;
    if (t == 0) best[k] = ~0u;
  }
  __syncthreads();
  // the pixel sum: a warp's 32 words lie in one macroblock
  for (int q = t; q < MPB * 64; q += S::THREADS) {
    const int k = q >> 6;
    if (m0 + k >= n_mb) break;
    const uint32_t* cw = reinterpret_cast<const uint32_t*>(cur[k]);
    const int s = __reduce_add_sync(0xffffffffu, sad4(cw[q & 63], 0u, 0u));
    if (lane == 0) atomicAdd(&sums[k][10], s);
  }
  // the integer search
  const int k = t / S::LIVE, u = t - k * S::LIVE;
  const bool live = k < MPB && m0 + k < n_mb;
  unsigned key = ~0u;
  if (live) {
    const int dy0 = (u % S::NDY) * D - RANGE, dx0 = (u / S::NDY) * R - RANGE;
    const uint8_t* base = win[k] + (WIN_Y + dy0) * WIN_STRIDE + WIN_X + dx0;
    unsigned acc[D][R];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) acc[i][j] = 0;
#pragma unroll 1
    for (int r = 0; r < D + 15; ++r) {
      uint32_t w[S::NW], sh[3][S::NW - 1];
      if constexpr (R % 8 == 0) {
        const uint2* row = reinterpret_cast<const uint2*>(base +
                                                          r * WIN_STRIDE);
#pragma unroll
        for (int q = 0; q < S::NW / 2; ++q) {
          const uint2 v = row[q];
          w[2 * q] = v.x;
          w[2 * q + 1] = v.y;
        }
      } else {
        const uint32_t* row = reinterpret_cast<const uint32_t*>(
            base + r * WIN_STRIDE);
#pragma unroll
        for (int q = 0; q < S::NW; ++q) w[q] = row[q];
      }
#pragma unroll
      for (int s = 1; s < 4; ++s)
#pragma unroll
        for (int q = 0; q < S::NW - 1; ++q)
          sh[s - 1][q] = __byte_perm(w[q], w[q + 1], 0x3210 + 0x1111 * s);
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const int py = r - i;
        if (py < 0 || py >= 16) continue;
        const uint4 c = cur[k][py];
        const unsigned cw[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int j = 0; j < R; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int o = (j >> 2) + q;
            const unsigned a = (j & 3) ? sh[(j & 3) - 1][o] : w[o];
            acc[i][j] = sad4(a, cw[q], acc[i][j]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j)
        if (dx0 + j <= RANGE && dy0 + i <= RANGE)
          key = min(key, search_key(acc[i][j], dx0 + j, dy0 + i));
  }
  // a macroblock's threads are consecutive: a segmented warp minimum
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned o = __shfl_down_sync(0xffffffffu, key, off);
    if (lane + off < 32 && (t + off) / S::LIVE == k) key = min(key, o);
  }
  if (live && (lane == 0 || u == 0)) atomicMin(&best[k], key);
  __syncthreads();
  // the half-pel neighbours (rounding 0) and the deviation: pixel tasks,
  // a warp's 32 in one macroblock
  for (int q = t; q < MPB * 256; q += S::THREADS) {
    const int kk = q >> 8, p = q & 255;
    if (m0 + kk >= n_mb) break;
    const int order = best[kk] & ((1 << ORDER_BITS) - 1);
    const int bx = order % SIDE - RANGE, by = (order / SIDE) % SIDE - RANGE;
    const int cv = reinterpret_cast<const uint8_t*>(cur[kk])[p];
    const uint8_t* w = win[kk] + (WIN_Y + (p >> 4) + by - 1) * WIN_STRIDE +
                       WIN_X + (p & 15) + bx - 1;
    int a[3][3];
#pragma unroll
    for (int y = 0; y < 3; ++y)
#pragma unroll
      for (int x = 0; x < 3; ++x) a[y][x] = w[y * WIN_STRIDE + x];
    int v[10];
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      // window taps of half-pel offset (hx, hy): column x0 (and x0 + 1
      // where hx is odd), row y0 (and y0 + 1)
      const int X = 2 + kHalf[i][0], Yh = 2 + kHalf[i][1];
      const int x0 = X >> 1, y0 = Yh >> 1, fx = X & 1, fy = Yh & 1;
      const int pa = a[y0][x0];
      int pr;
      if (!fx && !fy) pr = pa;
      else if (!fy) pr = (pa + a[y0][x0 + 1] + 1) >> 1;
      else if (!fx) pr = (pa + a[y0 + 1][x0] + 1) >> 1;
      else
        pr = (pa + a[y0][x0 + 1] + a[y0 + 1][x0] + a[y0 + 1][x0 + 1] + 2) >> 2;
      v[i] = abs(pr - cv);
    }
    v[9] = abs(cv - ((sums[kk][10] + 128) >> 8));
#pragma unroll
    for (int i = 0; i < 10; ++i) v[i] = __reduce_add_sync(0xffffffffu, v[i]);
    if (lane == 0)
#pragma unroll
      for (int i = 0; i < 10; ++i) atomicAdd(&sums[kk][i], v[i]);
  }
  __syncthreads();
  if (t < MPB && m0 + t < n_mb) {
    const int order = best[t] & ((1 << ORDER_BITS) - 1);
    const int bx = order % SIDE - RANGE, by = (order / SIDE) % SIDE - RANGE;
    int bi = 0;
    for (int i = 1; i < 9; ++i)
      if (sums[t][i] < sums[t][bi]) bi = i;
    const bool intra = sums[t][9] + 512 < sums[t][bi];
    int32_t* o = out + ((size_t)g * n_mb + m0 + t) * 3;
    o[0] = intra ? MB_INTRA : MB_INTER;
    o[1] = intra ? 0 : 2 * bx + kHalf[bi][0];
    o[2] = intra ? 0 : 2 * by + kHalf[bi][1];
  }
}


template <int R, int D, int MPB>
__global__ void __launch_bounds__(OldShape<R, D, MPB>::THREADS)
second_search(const uint8_t* __restrict__ Y, int h16, int w16,
                     const int32_t* __restrict__ items, int n_mb, int width,
                     int height, int32_t* __restrict__ out) {
  using S = OldShape<R, D, MPB>;
  __shared__ __align__(16) uint8_t win[MPB][WIN_ROWS * WIN_STRIDE];
  __shared__ uint4 cur[MPB][16];
  __shared__ unsigned best[MPB];
  __shared__ int sums[MPB][11];  // 9 half-pel SADs, the deviation, the sum
  const int t = threadIdx.x, lane = t & 31;
  const int g = blockIdx.y;
  const int c_i = items[2 * g], r_i = items[2 * g + 1];
  const size_t plane = (size_t)h16 * w16;
  const uint8_t* cp = Y + c_i * plane;
  const uint8_t* rp = Y + r_i * plane;
  const int mbw = w16 >> 4;
  const int m0 = blockIdx.x * MPB;
#pragma unroll 1
  for (int k = 0; k < MPB && m0 + k < n_mb; ++k) {
    const int m = m0 + k, my = m / mbw, mx = m - my * mbw;
    const int oy = my * 16 - WIN_Y, ox = mx * 16 - WIN_X;
    // 16 bytes a thread: a vector load where the chunk lies inside the
    // picture's width, the clamped bytes where it does not
    for (int i = t; i < WIN_ROWS * (WIN_LOAD / 16); i += S::THREADS) {
      const int wy = i / (WIN_LOAD / 16), x0 = ox + 16 * (i - wy * (WIN_LOAD /
                                                                 16));
      const uint8_t* src = rp + (size_t)min(max(oy + wy, 0), height - 1) * w16;
      uint4 v;
      if (x0 >= 0 && x0 + 16 <= width) {
        v = *reinterpret_cast<const uint4*>(src + x0);
      } else {
        unsigned b[4] = {0, 0, 0, 0};
#pragma unroll
        for (int c = 0; c < 16; ++c)
          b[c >> 2] |= (unsigned)src[min(max(x0 + c, 0), width - 1)]
                       << (8 * (c & 3));
        v = make_uint4(b[0], b[1], b[2], b[3]);
      }
      uint2* d = reinterpret_cast<uint2*>(win[k] + wy * WIN_STRIDE + x0 - ox);
      d[0] = make_uint2(v.x, v.y);
      d[1] = make_uint2(v.z, v.w);
    }
    if (t < 16)
      cur[k][t] = *reinterpret_cast<const uint4*>(
          cp + (size_t)(my * 16 + t) * w16 + mx * 16);
    if (t < 11) sums[k][t] = 0;
    if (t == 0) best[k] = ~0u;
  }
  __syncthreads();
  // the pixel sum: a warp's 32 words lie in one macroblock
  for (int q = t; q < MPB * 64; q += S::THREADS) {
    const int k = q >> 6;
    if (m0 + k >= n_mb) break;
    const uint32_t* cw = reinterpret_cast<const uint32_t*>(cur[k]);
    const int s = __reduce_add_sync(0xffffffffu, sad4(cw[q & 63], 0u, 0u));
    if (lane == 0) atomicAdd(&sums[k][10], s);
  }
  // the integer search
  const int k = t / S::LIVE, u = t - k * S::LIVE;
  const bool live = k < MPB && m0 + k < n_mb;
  unsigned key = ~0u;
  if (live) {
    const int dy0 = (u % S::NDY) * D - RANGE, dx0 = (u / S::NDY) * R - RANGE;
    const uint8_t* base = win[k] + (WIN_Y + dy0) * WIN_STRIDE + WIN_X + dx0;
    unsigned acc[D][R];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) acc[i][j] = 0;
#pragma unroll 1
    for (int r = 0; r < D + 15; ++r) {
      uint32_t w[S::NW], sh[3][S::NW - 1];
      if constexpr (R % 8 == 0) {
        const uint2* row = reinterpret_cast<const uint2*>(base +
                                                          r * WIN_STRIDE);
#pragma unroll
        for (int q = 0; q < S::NW / 2; ++q) {
          const uint2 v = row[q];
          w[2 * q] = v.x;
          w[2 * q + 1] = v.y;
        }
      } else {
        const uint32_t* row = reinterpret_cast<const uint32_t*>(
            base + r * WIN_STRIDE);
#pragma unroll
        for (int q = 0; q < S::NW; ++q) w[q] = row[q];
      }
#pragma unroll
      for (int s = 1; s < 4; ++s)
#pragma unroll
        for (int q = 0; q < S::NW - 1; ++q)
          sh[s - 1][q] = __byte_perm(w[q], w[q + 1], 0x3210 + 0x1111 * s);
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const int py = r - i;
        if (py < 0 || py >= 16) continue;
        const uint4 c = cur[k][py];
        const unsigned cw[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int j = 0; j < R; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int o = (j >> 2) + q;
            const unsigned a = (j & 3) ? sh[(j & 3) - 1][o] : w[o];
            acc[i][j] = sad4(a, cw[q], acc[i][j]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j)
        if (dx0 + j <= RANGE && dy0 + i <= RANGE)
          key = min(key, search_key(acc[i][j], dx0 + j, dy0 + i));
  }
  // a macroblock's threads are consecutive: a segmented warp minimum
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned o = __shfl_down_sync(0xffffffffu, key, off);
    if (lane + off < 32 && (t + off) / S::LIVE == k) key = min(key, o);
  }
  if (live && (lane == 0 || u == 0)) atomicMin(&best[k], key);
  __syncthreads();
  // the half-pel neighbours (rounding 0) and the deviation: a task is a
  // column of 4 pixels (its 6 x 3 window bytes serve all 4), a warp's 32
  // tasks in one macroblock; sums kept in registers, reduced once a task
  for (int q = t; q < MPB * 64; q += S::THREADS) {
    const int kk = q >> 6, col = q & 15, row = (q >> 4) & 3;
    if (m0 + kk >= n_mb) break;
    const int order = best[kk] & ((1 << ORDER_BITS) - 1);
    const int bx = order % SIDE - RANGE, by = (order / SIDE) % SIDE - RANGE;
    const int mean = (sums[kk][10] + 128) >> 8;
    const uint8_t* cb = reinterpret_cast<const uint8_t*>(cur[kk]);
    const uint8_t* w = win[kk] + (WIN_Y + 4 * row + by - 1) * WIN_STRIDE +
                       WIN_X + col + bx - 1;
    int a[6][3];
#pragma unroll
    for (int y = 0; y < 6; ++y)
#pragma unroll
      for (int x = 0; x < 3; ++x) a[y][x] = w[y * WIN_STRIDE + x];
    int v[10];
#pragma unroll
    for (int i = 0; i < 10; ++i) v[i] = 0;
#pragma unroll
    for (int py = 0; py < 4; ++py) {
      const int cv = cb[(4 * row + py) * 16 + col];
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        // taps of half-pel offset (hx, hy): column x0 (and x0 + 1 where
        // hx is odd), row y0 (and y0 + 1)
        const int X = 2 + kHalf[i][0], Yh = 2 + kHalf[i][1];
        const int x0 = X >> 1, y0 = py + (Yh >> 1), fx = X & 1, fy = Yh & 1;
        const int pa = a[y0][x0];
        int pr;
        if (!fx && !fy)
          pr = pa;
        else if (!fy)
          pr = (pa + a[y0][x0 + 1] + 1) >> 1;
        else if (!fx)
          pr = (pa + a[y0 + 1][x0] + 1) >> 1;
        else
          pr = (pa + a[y0][x0 + 1] + a[y0 + 1][x0] + a[y0 + 1][x0 + 1] + 2) >>
               2;
        v[i] += abs(pr - cv);
      }
      v[9] += abs(cv - mean);
    }
#pragma unroll
    for (int i = 0; i < 10; ++i) v[i] = __reduce_add_sync(0xffffffffu, v[i]);
    if (lane == 0)
#pragma unroll
      for (int i = 0; i < 10; ++i) atomicAdd(&sums[kk][i], v[i]);
  }
  __syncthreads();
  if (t < MPB && m0 + t < n_mb) {
    const int order = best[t] & ((1 << ORDER_BITS) - 1);
    const int bx = order % SIDE - RANGE, by = (order / SIDE) % SIDE - RANGE;
    int bi = 0;
    for (int i = 1; i < 9; ++i)
      if (sums[t][i] < sums[t][bi]) bi = i;
    const bool intra = sums[t][9] + 512 < sums[t][bi];
    int32_t* o = out + ((size_t)g * n_mb + m0 + t) * 3;
    o[0] = intra ? MB_INTRA : MB_INTER;
    o[1] = intra ? 0 : 2 * bx + kHalf[bi][0];
    o[2] = intra ? 0 : 2 * by + kHalf[bi][1];
  }
}


}  // namespace old

namespace asp_original {

// V2's quarter-pel form and V5 as PR 21 wrote them (a CUDA block a
// macroblock; its note follows), kept to time the redesign against.
//
// The prediction of one macroblock from one reference, as
// ops/mpeg4_cuda._predict computes it. Quarter-pel luma: the (S + 1)^2
// integer samples of each 16 x 16 block (or of each of four 8 x 8 ones)
// are staged in shared memory, clamped into the edge_w x edge_h picture;
// the horizontal half samples of every staged row (the 8-tap filter,
// taps mirrored at the block's edges) and the horizontal quarter means
// go to a second shared array; each thread then filters its pixel's
// column of that array and takes the vertical mean (FFmpeg's order of
// operations). Half-pel luma and all chroma are bilinear samples, a
// thread a pixel. 256 threads: a luma pixel each, the first 128 a chroma
// pixel each too. This is the simple first form: it stages every sample
// once a macroblock and direction, and makes no use of the vectors of
// neighbouring macroblocks.
constexpr int GM_THREADS = 256;
constexpr int GM_FULL = 4 * 81;   // 17 x 17, or four 9 x 9 staged samples
constexpr int GM_HALF = 4 * 72;   // 17 x 16, or four 9 x 8 half samples

__device__ __forceinline__ int mirror(int k, int size) {
  return k < 0 ? -1 - k : (k > size ? 2 * size + 1 - k : k);
}

// the 8-tap filter at half position c (between c and c + 1) over samples
// at(0 .. size)
template <typename F>
__device__ __forceinline__ int lowpass(F at, int c, int size, int rnd) {
  const int v = 20 * (at(mirror(c, size)) + at(mirror(c + 1, size))) -
                6 * (at(mirror(c - 1, size)) + at(mirror(c + 2, size))) +
                3 * (at(mirror(c - 2, size)) + at(mirror(c + 3, size))) -
                (at(mirror(c - 3, size)) + at(mirror(c + 4, size)));
  return min(max((v + 16 - rnd) >> 5, 0), 255);
}

__device__ __forceinline__ int bilinear(const uint8_t* __restrict__ p,
                                        int stride, int X, int Y, int w,
                                        int h, int rnd) {
  const int x0 = X >> 1, y0 = Y >> 1, fx = X & 1, fy = Y & 1;
  const int xa = min(max(x0, 0), w - 1), xb = min(max(x0 + 1, 0), w - 1);
  const int ya = min(max(y0, 0), h - 1), yb = min(max(y0 + 1, 0), h - 1);
  const int a = p[(size_t)ya * stride + xa], b = p[(size_t)ya * stride + xb];
  const int c = p[(size_t)yb * stride + xa], d = p[(size_t)yb * stride + xb];
  if (!fx && !fy) return a;
  if (!fy) return (a + b + 1 - rnd) >> 1;
  if (!fx) return (a + c + 1 - rnd) >> 1;
  return (a + b + c + d + 2 - rnd) >> 2;
}

// One direction's prediction of macroblock (mx, my) from the reference
// planes Y, U, V (one slot): `lum` for luma pixel t, `chr` for chroma
// pixel t < 128 (plane t / 64). Every thread of the block must call it.
__device__ void predict_mb(const uint8_t* __restrict__ Y,
                           const uint8_t* __restrict__ U,
                           const uint8_t* __restrict__ V, int w16, int mx,
                           int my, const int32_t* vec, bool four, bool qpel,
                           int rule, int rnd, int ew, int eh, int* full,
                           int* half, int& lum, int& chr) {
  const int t = threadIdx.x, py = t >> 4, px = t & 15;
  if (qpel) {
    const int S = four ? 8 : 16, NB = four ? 4 : 1;
    const int FW = S + 1, FS = FW * FW, HS = FW * S;
    for (int i = t; i < NB * FS; i += GM_THREADS) {
      const int b = i / FS, k = i - b * FS, r = k / FW, c = k - r * FW;
      const int bx = mx * 16 + (four ? 8 * (b & 1) : 0) + (vec[2 * b] >> 2);
      const int by = my * 16 + (four ? 8 * (b >> 1) : 0) +
                     (vec[2 * b + 1] >> 2);
      full[i] = Y[(size_t)min(max(by + r, 0), eh - 1) * w16 +
                  min(max(bx + c, 0), ew - 1)];
    }
    __syncthreads();
    for (int i = t; i < NB * HS; i += GM_THREADS) {
      const int b = i / HS, k = i - b * HS, r = k / S, c = k - r * S;
      const int* f = full + b * FS + r * FW;
      const int fx = vec[2 * b] & 3;
      const int h = lowpass([&](int q) { return f[q]; }, c, S, rnd);
      const int g = fx == 3 ? f[c + 1] : f[c];
      half[i] = fx == 0 ? f[c] : (fx == 2 ? h : (h + g + 1 - rnd) >> 1);
    }
    __syncthreads();
    const int b = four ? ((py >> 3) << 1) | (px >> 3) : 0;
    const int r = four ? py & 7 : py, c = four ? px & 7 : px;
    const int* hb = half + b * HS;
    const int fy = vec[2 * b + 1] & 3;
    const int v = lowpass([&](int q) { return hb[q * S + c]; }, r, S, rnd);
    const int g = hb[(fy == 3 ? r + 1 : r) * S + c];
    lum = fy == 0 ? hb[r * S + c] : (fy == 2 ? v : (g + v + 1 - rnd) >> 1);
    __syncthreads();  // the arrays are free for the next direction
  } else {
    const int b = ((py >> 3) << 1) | (px >> 3);
    lum = bilinear(Y, w16, 2 * (mx * 16 + px) + vec[2 * b],
                   2 * (my * 16 + py) + vec[2 * b + 1], ew, eh, rnd);
  }
  if (t < 128) {
    const int q = t & 63;
    const int cx = chroma_of(vec, 0, four, qpel, rule);
    const int cy = chroma_of(vec, 1, four, qpel, rule);
    chr = bilinear(t < 64 ? U : V, w16 >> 1, 2 * (mx * 8 + (q & 7)) + cx,
                   2 * (my * 8 + (q >> 3)) + cy, ew >> 1, eh >> 1, rnd);
  }
}

// the residual of luma pixel t (or chroma pixel t < 128 with `chroma`) of
// one macroblock's (6, 64) int16 blocks
__device__ __forceinline__ int residual_of(const int16_t* __restrict__ r,
                                          int t, bool chroma) {
  if (!r) return 0;
  if (chroma) return r[(4 + (t >> 6)) * 64 + (t & 63)];
  const int py = t >> 4, px = t & 15;
  return r[(((py >> 3) << 1) | (px >> 3)) * 64 + (py & 7) * 8 + (px & 7)];
}

__device__ __forceinline__ void store_mb(uint8_t* Y, uint8_t* U, uint8_t* V,
                                         int w16, int mx, int my, int lum,
                                         int chr, const int16_t* r) {
  const int t = threadIdx.x;
  Y[(size_t)(my * 16 + (t >> 4)) * w16 + mx * 16 + (t & 15)] =
      (uint8_t)min(max(lum + residual_of(r, t, false), 0), 255);
  if (t < 128) {
    const int q = t & 63;
    (t < 64 ? U : V)[(size_t)(my * 8 + (q >> 3)) * (w16 >> 1) + mx * 8 +
                     (q & 7)] =
        (uint8_t)min(max(chr + residual_of(r, t, true), 0), 255);
  }
}

// V2 at quarter-pel: items (f, reference slot, output slot, rounding)
// over records (F, M, MB_FIELDS), a CUDA block a macroblock and item.
__global__ void __launch_bounds__(GM_THREADS)
motion_compensate_qpel_kernel(uint8_t* __restrict__ Y, uint8_t* __restrict__ U,
                              uint8_t* __restrict__ V, int h16, int w16,
                              const int32_t* __restrict__ mb, int n_mb,
                              const int16_t* __restrict__ res,
                              const int32_t* __restrict__ items, int ew,
                              int eh, int rule) {
  __shared__ int full[GM_FULL], half[GM_HALF];
  __shared__ int32_t rec[MB_FIELDS];
  const int t = threadIdx.x, m = blockIdx.x;
  const int32_t* it = items + 4 * blockIdx.y;
  const int f = it[0], ref = it[1], outs = it[2], rnd = it[3];
  const size_t k = (size_t)f * n_mb + m;
  if (t < MB_FIELDS) rec[t] = mb[k * MB_FIELDS + t];
  __syncthreads();
  const int mbw = w16 >> 4, my = m / mbw, mx = m - my * mbw;
  const size_t lp = (size_t)h16 * w16, cp = lp >> 2;
  int lum = 0, chr = 0;
  if (ref >= 0 && rec[0] != MB_INTRA)
    predict_mb(Y + ref * lp, U + ref * cp, V + ref * cp, w16, mx, my,
               rec + 4, rec[0] == MB_INTER4V, true, rule, rnd, ew, eh, full,
               half, lum, chr);
  store_mb(Y + outs * lp, U + outs * cp, V + outs * cp, w16, mx, my, lum, chr,
           res ? res + k * 384 : nullptr);
}

// V5: the B-VOPs of a batch. Items (j, past slot, future slot, output
// slot) over records (FB, M, B_FIELDS) and residuals (FB, M, 6, 64); a CUDA
// block a macroblock and item. It replaces no TPU kernel: cv2's decoding of
// B-VOPs (faceoff_tpu/io/video.py:61). Bound by bytes: the residual (768),
// the output (384) and one or two references (384 each, and the margins
// of the 8-tap filter) a macroblock.
__global__ void __launch_bounds__(GM_THREADS)
bidir_compensate_kernel(uint8_t* __restrict__ Y, uint8_t* __restrict__ U,
                        uint8_t* __restrict__ V, int h16, int w16,
                        const int32_t* __restrict__ bmb, int n_mb,
                        const int16_t* __restrict__ res,
                        const int32_t* __restrict__ items, int ew, int eh,
                        int qpel, int rule) {
  __shared__ int full[GM_FULL], half[GM_HALF];
  __shared__ int32_t rec[B_FIELDS];
  const int t = threadIdx.x, m = blockIdx.x;
  const int32_t* it = items + 4 * blockIdx.y;
  const int j = it[0], past = it[1], future = it[2], outs = it[3];
  const size_t k = (size_t)j * n_mb + m;
  if (t < B_FIELDS) rec[t] = bmb[k * B_FIELDS + t];
  __syncthreads();
  const int mbw = w16 >> 4, my = m / mbw, mx = m - my * mbw;
  const size_t lp = (size_t)h16 * w16, cp = lp >> 2;
  const int dir = rec[3];
  const bool four = dir & B_8X8;
  int fl = 0, fc = 0, bl = 0, bc = 0;
  if (dir & B_FWD)
    predict_mb(Y + past * lp, U + past * cp, V + past * cp, w16, mx, my,
               rec + 4, four, qpel, rule, 0, ew, eh, full, half, fl, fc);
  if (dir & B_BWD)
    predict_mb(Y + future * lp, U + future * cp, V + future * cp, w16, mx,
               my, rec + 12, four, qpel, rule, 0, ew, eh, full, half, bl, bc);
  const bool both = (dir & B_FWD) && (dir & B_BWD);
  const int lum = both ? (fl + bl + 1) >> 1 : ((dir & B_FWD) ? fl : bl);
  const int chr = both ? (fc + bc + 1) >> 1 : ((dir & B_FWD) ? fc : bc);
  store_mb(Y + outs * lp, U + outs * cp, V + outs * cp, w16, mx, my, lum, chr,
           res ? res + k * 384 : nullptr);
}

}  // namespace asp_original

namespace probe {

// the source and prediction rows of block j's row r (see fdct_quant_kernel)
__device__ __forceinline__ void block_rows(
    const uint8_t* sy, const uint8_t* su, const uint8_t* sv,
    const uint8_t* py_, const uint8_t* pu, const uint8_t* pv, int h16,
    int w16, int n_mb, const int32_t* items, int gm, int b,
    const uint8_t** s, const uint8_t** p, int* stride) {
  const int g = gm / n_mb, m = gm - g * n_mb;
  const int s_i = items[2 * g], p_i = items[2 * g + 1];
  const int mbw = w16 >> 4, my = m / mbw, mx = m - my * mbw;
  if (b < 4) {
    const size_t o = (size_t)(my * 16 + (b >> 1) * 8) * w16 + mx * 16 +
                     (b & 1) * 8;
    const size_t lplane = (size_t)h16 * w16;
    *s = sy + s_i * lplane + o;
    *p = py_ + p_i * lplane + o;
    *stride = w16;
  } else {
    const size_t o = (size_t)(my * 8) * (w16 >> 1) + mx * 8;
    const size_t cplane = (size_t)h16 * w16 >> 2;
    *s = (b == 4 ? su : sv) + s_i * cplane + o;
    *p = (b == 4 ? pu : pv) + p_i * cplane + o;
    *stride = w16 >> 1;
  }
}

// V1 a thread a block: both passes in registers
__global__ void __launch_bounds__(128)
idct_block(const int16_t* __restrict__ blocks, const int32_t* __restrict__ bidx,
           int nb, const int32_t* __restrict__ mb, int16_t* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nb) return;
  const int idx = bidx[j];
  const int2 rec = *reinterpret_cast<const int2*>(
      mb + (size_t)(idx / 6) * MB_FIELDS);
  const int qp = rec.y;
  const uint4* src = reinterpret_cast<const uint4*>(blocks + (size_t)j * 64);
  uint4 lv[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) lv[r] = src[r];
  const int dc = min(max((int)(int16_t)(lv[0].x & 0xFFFF) *
                             d_dc_scaler(qp, idx % 6 < 4), -2048), 2047);
  int v[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
    dequant_row(lv[r], qp, r == 0 && rec.x == MB_INTRA, dc, v[r]);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    int y[8], o[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) y[k] = v[k][c];
    idct_column(y, o);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k][c] = o[k];
  }
  uint4* dst = reinterpret_cast<uint4*>(out + (size_t)idx * 64);
#pragma unroll
  for (int r = 0; r < 8; ++r) dst[r] = pack16(v[r]);
}

// V1's loads and stores at the port's shape, no arithmetic
__global__ void __launch_bounds__(8 * V1_BPB)
idct_copy(const int16_t* __restrict__ blocks, const int32_t* __restrict__ bidx,
          int nb, const int32_t* __restrict__ mb, int16_t* __restrict__ out) {
  const int t = threadIdx.x, r = t & 7;
  const int j = blockIdx.x * V1_BPB + (t >> 3);
  if (j >= nb) return;
  uint4 lv = reinterpret_cast<const uint4*>(blocks + (size_t)j * 64)[r];
  const int idx = bidx[j];
  const int2 rec = *reinterpret_cast<const int2*>(
      mb + (size_t)(idx / 6) * MB_FIELDS);
  lv.x ^= (unsigned)(rec.x + rec.y);
  reinterpret_cast<uint4*>(out + (size_t)idx * 64)[r] = lv;
}

// V2's loads and stores at a shape of the port's (the same lanes, the
// records and residual staged the same way), no averaging
template <int ROWS, int MPB>
__global__ void __launch_bounds__(McShape<ROWS, MPB>::THREADS)
mc_copy(uint8_t* __restrict__ Y, uint8_t* __restrict__ U,
        uint8_t* __restrict__ V, int h16, int w16,
        const int32_t* __restrict__ mb, int n_mb,
        const int16_t* __restrict__ res, const int32_t* __restrict__ items,
        int width, int height) {
  using S = McShape<ROWS, MPB>;
  __shared__ int32_t recs[MPB * MB_FIELDS];
  __shared__ uint4 sres[MPB * MC_RES_MB];
  const int t = threadIdx.x;
  const int32_t* it = items + 4 * blockIdx.y;
  const int f = it[0], ref = it[1], outs = it[2];
  const int m0 = blockIdx.x * MPB;
  const int n_live = min(MPB, n_mb - m0);
  const size_t first = (size_t)f * n_mb + m0;
  for (int i = t; i < n_live * MB_FIELDS; i += S::THREADS)
    recs[i] = mb[first * MB_FIELDS + i];
  if (res) {
    const uint4* src = reinterpret_cast<const uint4*>(res + first * 6 * 64);
    for (int i = t; i < n_live * 48; i += S::THREADS) {
      const int k = i / 48, q = i - 48 * k;
      sres[k * MC_RES_MB + (q >> 3) * MC_RES_BLOCK + (q & 7)] = src[i];
    }
  }
  __syncthreads();
  int k, b, r0;
  if (t < S::LUMA) {
    const int pos = t % (2 * MPB), g = t / (2 * MPB) * ROWS;
    k = pos >> 1;
    b = ((g >> 3) << 1) | (pos & 1);
    r0 = g & 7;
  } else {
    const int c = t - S::LUMA, rest = c / MPB;
    k = c - rest * MPB;
    b = 4 + rest / (8 / ROWS);
    r0 = (rest % (8 / ROWS)) * ROWS;
  }
  if (k >= n_live) return;
  const int m = m0 + k;
  const int32_t* rec = recs + k * MB_FIELDS;
  const int mbw = w16 >> 4, my = m / mbw, mx = m - my * mbw;
  const bool luma = b < 4;
  const size_t plane = luma ? (size_t)h16 * w16 : (size_t)h16 * w16 >> 2;
  const int stride = luma ? w16 : w16 >> 1;
  uint8_t* P = luma ? Y : (b == 4 ? U : V);
  const int px = luma ? mx * 16 + (b & 1) * 8 : mx * 8;
  const int py = (luma ? my * 16 + (b >> 1) * 8 : my * 8) + r0;
  uint2 w[ROWS];
  const uint4* rv = sres + k * MC_RES_MB + b * MC_RES_BLOCK + r0;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    w[i] = make_uint2(0, 0);
    if (res) w[i] = make_uint2(rv[i].x ^ rv[i].y, rv[i].z ^ rv[i].w);
  }
  if (ref >= 0 && rec[0] != MB_INTRA) {
    const int vx = luma ? rec[4 + 2 * b] : rec[4];
    const int vy = luma ? rec[5 + 2 * b] : rec[5];
    const int pw = luma ? width : width >> 1, ph = luma ? height : height >> 1;
    const int X = 2 * px + vx, Yh = 2 * py + vy;
    const int x0 = X >> 1, y0 = Yh >> 1;
    const bool fy = Yh & 1;
    const bool interior = x0 >= 0 && x0 + 9 <= pw;
    const uint8_t* base = P + ref * plane;
#pragma unroll
    for (int i = 0; i <= ROWS; ++i)
      if (i < ROWS || fy) {
        const RefRow a = ref_row(
            base + (size_t)min(max(y0 + i, 0), ph - 1) * stride, x0, pw,
            interior);
        w[i < ROWS ? i : ROWS - 1].x ^= a.a0;
        w[i < ROWS ? i : ROWS - 1].y ^= a.a1;
      }
  }
  uint8_t* o = P + outs * plane + (size_t)py * stride + px;
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
    *reinterpret_cast<uint2*>(o + (size_t)i * stride) = w[i];
}

constexpr int BLOCK_THREADS = 192;

__global__ void __launch_bounds__(BLOCK_THREADS)
fdct_block(const uint8_t* __restrict__ sy, const uint8_t* __restrict__ su,
           const uint8_t* __restrict__ sv, const uint8_t* __restrict__ py_,
           const uint8_t* __restrict__ pu, const uint8_t* __restrict__ pv,
           int h16, int w16, const int32_t* __restrict__ mb, int n_mb,
           int total, const int32_t* __restrict__ items,
           int16_t* __restrict__ out) {
  const int j = blockIdx.x * BLOCK_THREADS + threadIdx.x;
  const int gm = j / 6, b = j - gm * 6;
  if (gm >= total) return;
  const int32_t* rec = mb + (size_t)gm * MB_FIELDS;
  const bool intra = rec[0] == MB_INTRA;
  const int qp = rec[1];
  const uint8_t *s, *p;
  int stride;
  block_rows(sy, su, sv, py_, pu, pv, h16, w16, n_mb, items, gm, b, &s, &p,
             &stride);
  int tr[8][8];
#pragma unroll
  for (int y = 0; y < 8; ++y) {
    const uint2 sa = *reinterpret_cast<const uint2*>(s + y * stride);
    const uint2 pa = *reinterpret_cast<const uint2*>(p + y * stride);
    int x[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const unsigned sw = c < 4 ? sa.x : sa.y, pw = c < 4 ? pa.x : pa.y;
      const int sh = 8 * (c & 3);
      x[c] = (int)((sw >> sh) & 255) - (intra ? 0 : (int)((pw >> sh) & 255));
    }
    int e[4], o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      e[k] = x[k] + x[7 - k];
      o[k] = x[k] - x[7 - k];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int* h = (u & 1) ? o : e;
      int acc = 512;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc += kFdct[u * 8 + k] * h[k];
      tr[y][u] = acc >> 10;
    }
  }
  const int d2 = 2 * qp, half = qp >> 1;
  int16_t* dst = out + (size_t)j * 64;
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    int lv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      int acc = 32768;
#pragma unroll
      for (int y = 0; y < 4; ++y)
        acc += kFdct[v * 8 + y] *
               ((v & 1) ? tr[y][u] - tr[7 - y][u] : tr[y][u] + tr[7 - y][u]);
      const int f = acc >> 16;
      if (v == 0 && u == 0 && intra) {
        const int sc = d_dc_scaler(qp, b < 4);
        const int q = f + (sc >> 1);
        const int dc = q >= 0 ? div_recip(q, sc) : -div_recip(-q + sc - 1, sc);
        lv[u] = min(max(dc, 1), 254);
      } else {
        const int a = abs(f);
        const int n = intra ? a : max(a - half, 0);
        const int mag = min(div_recip(n, d2), 2047);
        lv[u] = f < 0 ? -mag : mag;
      }
    }
    uint4 packed;
    packed.x = (uint16_t)lv[0] | ((unsigned)(uint16_t)lv[1] << 16);
    packed.y = (uint16_t)lv[2] | ((unsigned)(uint16_t)lv[3] << 16);
    packed.z = (uint16_t)lv[4] | ((unsigned)(uint16_t)lv[5] << 16);
    packed.w = (uint16_t)lv[6] | ((unsigned)(uint16_t)lv[7] << 16);
    *reinterpret_cast<uint4*>(dst + v * 8) = packed;
  }
}

__global__ void __launch_bounds__(48 * FQ_MBS)
fdct_copy(const uint8_t* __restrict__ sy, const uint8_t* __restrict__ su,
          const uint8_t* __restrict__ sv, const uint8_t* __restrict__ py_,
          const uint8_t* __restrict__ pu, const uint8_t* __restrict__ pv,
          int h16, int w16, const int32_t* __restrict__ mb, int n_mb,
          int total, const int32_t* __restrict__ items,
          int16_t* __restrict__ out) {
  const int t = threadIdx.x, r = t & 7;
  const int j = blockIdx.x * 6 * FQ_MBS + (t >> 3);
  const int gm = j / 6, b = j - gm * 6;
  if (gm >= total) return;
  const bool intra = mb[(size_t)gm * MB_FIELDS] == MB_INTRA;
  const uint8_t *s, *p;
  int stride;
  block_rows(sy, su, sv, py_, pu, pv, h16, w16, n_mb, items, gm, b, &s, &p,
             &stride);
  const uint2 sa = *reinterpret_cast<const uint2*>(s + r * stride);
  const uint2 pa = *reinterpret_cast<const uint2*>(p + r * stride);
  int x[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const unsigned sw = c < 4 ? sa.x : sa.y, pw = c < 4 ? pa.x : pa.y;
    const int sh = 8 * (c & 3);
    x[c] = (int)((sw >> sh) & 255) - (intra ? 0 : (int)((pw >> sh) & 255));
  }
  uint4 packed;
  packed.x = (uint16_t)x[0] | ((unsigned)(uint16_t)x[1] << 16);
  packed.y = (uint16_t)x[2] | ((unsigned)(uint16_t)x[3] << 16);
  packed.z = (uint16_t)x[4] | ((unsigned)(uint16_t)x[5] << 16);
  packed.w = (uint16_t)x[6] | ((unsigned)(uint16_t)x[7] << 16);
  *reinterpret_cast<uint4*>(out + (size_t)j * 64 + r * 8) = packed;
}

// Instruction rates: each thread runs `iters` rounds of 8 independent
// chains of one instruction; out[thread] keeps the result live.
template <int KIND>
__global__ void rate(int iters, unsigned seed, unsigned* out) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned a[8];
  float f[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a[i] = seed * (t + 1) + 0x01010101u * i;
    f[i] = (float)a[i];
  }
  const unsigned b = seed ^ t;
  const float fb = (float)b * 1e-9f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if constexpr (KIND == 0) a[i] = sad4(a[i], b, a[i]);
      if constexpr (KIND == 1) a[i] = __byte_perm(a[i], b, 0x4321);
      if constexpr (KIND == 2) f[i] = fmaf(f[i], fb, 1.0f);
      if constexpr (KIND == 3) a[i] = a[i] * b + 0x9e3779b9u;
    }
  }
  unsigned r = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) r += a[i] + __float_as_uint(f[i]);
  out[t] = r;
}

// gm_copy's work for one macroblock (a warp)
template <int MBS, bool BIDIR, bool QPEL, int PART, bool STAGE>
__device__ __forceinline__ void copy_mb(
    uint8_t* __restrict__ Y, uint8_t* __restrict__ U, uint8_t* __restrict__ V,
    int h16, int w16, const int32_t* __restrict__ mb, int n_mb,
    const int16_t* __restrict__ res, const int32_t* it, int ew, int eh,
    int rule, int32_t* rec, GmOut<STAGE ? MBS : 1>& stage) {
  constexpr int FIELDS = BIDIR ? B_FIELDS : MB_FIELDS;
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int m = blockIdx.x * MBS + wi;
  const size_t k = (size_t)it[0] * n_mb + m;
  const int outs = it[BIDIR ? 3 : 2];
  if (lane < FIELDS) rec[lane] = mb[k * FIELDS + lane];
  uint4 rl, rc;
  residual_rows(res && !(PART & 1) ? res + k * 384 : nullptr, lane, rl, rc);
  __syncwarp();
  const int mbw = w16 >> 4, my = m / mbw, mx = m - my * mbw;
  const size_t lp = (size_t)h16 * w16, cp = lp >> 2;
  bool act[2];
  int slot[2];
  const int32_t* vec[2] = {rec + 4, rec + 12};
  bool four;
  if (BIDIR) {
    const int dir = rec[3];
    four = dir & B_8X8;
    act[0] = dir & B_FWD;
    act[1] = (dir & B_BWD) || !act[0];
    slot[0] = it[1];
    slot[1] = it[2];
  } else {
    four = rec[0] == MB_INTER4V;
    act[0] = it[1] >= 0 && rec[0] != MB_INTRA;
    act[1] = false;
    slot[0] = slot[1] = it[1];
  }
  if (PART & 2) act[0] = act[1] = false;
  uint2 lum = make_uint2(rl.x ^ rl.y, rl.z ^ rl.w);
  uint2 chr = make_uint2(rc.x ^ rc.y, rc.z ^ rc.w);
  const int R = lane >> 1, H = lane & 1, b = (R >> 3) * 2 + H;
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    if (!act[d]) continue;
    if (QPEL) {
      QLoad q = {{0, 0, 0}, {0, 0, 0}};
      qpel_load(Y + slot[d] * lp, w16, mx, my, vec[d], four, ew, eh, lane, q);
      lum.x ^= q.m[0] ^ q.x[0] ^ q.x[2];
      lum.y ^= q.m[1] ^ q.m[2] ^ q.x[1];
    } else {
      RefRow a, c;
      hpel_rows(Y + slot[d] * lp, w16, mx * 16 + 8 * H, my * 16 + R,
                vec[d][2 * b], vec[d][2 * b + 1], ew, eh, true, 2, 16, lane,
                a, c);
      lum.x ^= a.a0 ^ c.b0;
      lum.y ^= a.a1 ^ c.b1;
    }
  }
  const int cd = BIDIR ? lane >> 4 : 0;
  const bool cact = (BIDIR || lane < 16) && act[cd];
  const int cx = chroma_of(vec[cd], 0, four, QPEL, rule);
  const int cy = chroma_of(vec[cd], 1, four, QPEL, rule);
  RefRow a, c;
  chroma_load(U + slot[cd] * cp, V + slot[cd] * cp, w16, mx, my, cx, cy, ew,
              eh, cact, lane, a, c);
  if (cact) {
    chr.x ^= a.a0 ^ c.b0;
    chr.y ^= a.a1 ^ c.b1;
  }
  if (BIDIR) {
    chr.x ^= __shfl_xor_sync(0xffffffffu, chr.x, 16);
    chr.y ^= __shfl_xor_sync(0xffffffffu, chr.y, 16);
  }
  if constexpr (STAGE)
    stage_rows<MBS>(stage, wi, lane, lum, chr);
  else
    store_rows(Y + outs * lp, U + outs * cp, V + outs * cp, w16, mx, my, lane,
               lum, chr);
}

// V2's quarter-pel form's and V5's loads and stores at a shape of the
// port's (the record, the residual rows, each direction's window words or
// reference rows, the chroma rows, the chroma shuffle of V5), no
// filtering: the floor of this access pattern. PART 1 leaves out the
// residual, 2 the references, 3 both (the record and the stores only);
// STAGE false stores each warp's rows itself, as run 2's form did.
template <int MBS, bool BIDIR, bool QPEL, int PART = 0, bool STAGE = true>
__global__ void __launch_bounds__(32 * MBS)
gm_copy(uint8_t* __restrict__ Y, uint8_t* __restrict__ U,
        uint8_t* __restrict__ V, int h16, int w16,
        const int32_t* __restrict__ mb, int n_mb,
        const int16_t* __restrict__ res, const int32_t* __restrict__ items,
        int ew, int eh, int rule) {
  constexpr int FIELDS = BIDIR ? B_FIELDS : MB_FIELDS;
  __shared__ int32_t recs[MBS][FIELDS];
  __shared__ GmOut<STAGE ? MBS : 1> stage;
  const int wi = threadIdx.x >> 5;
  const int m0 = blockIdx.x * MBS, m = m0 + wi;
  const int32_t* it = items + 4 * blockIdx.y;
  const int outs = it[BIDIR ? 3 : 2];
  const size_t lp = (size_t)h16 * w16, cp = lp >> 2;
  if (m < n_mb) copy_mb<MBS, BIDIR, QPEL, PART, STAGE>(
      Y, U, V, h16, w16, mb, n_mb, res, it, ew, eh, rule, recs[wi], stage);
  if constexpr (STAGE) {
    block_bar<MBS>();
    store_block<MBS>(stage, Y + outs * lp, U + outs * cp, V + outs * cp, w16,
                     m0, n_mb);
  }
}

// the macroblocks a CUDA block tried for V2's quarter-pel form and V5 (at
// 64 registers: 32 / MBS CUDA blocks an SM), then the CUDA blocks an SM
// must hold at the port's macroblocks a block (the cap on registers)
#define PROBE_GM(X) X(1) X(2) X(4) X(8) X(16)
#define PROBE_GM_MINB(X) X(1) X(6) X(12)

// the V1 blocks a CUDA block tried
#define PROBE_IDCT(X) X(8, 1) X(16, 1) X(32, 1) X(64, 1) X(16, 2) X(32, 2) \
  X(64, 2)
// the V2 shapes tried: {ROWS, MBS}
#define PROBE_MC(X) X(1, 4) X(1, 8) X(1, 16) X(2, 4) X(2, 8) X(2, 16) X(4, 8) \
  X(4, 16)
// the V3 shapes tried: {RUN, DY, MBS}
#define PROBE_SEARCH(X) X(8, 3, 1) X(8, 3, 2) X(8, 3, 4) X(8, 3, 8) \
  X(4, 3, 2) X(8, 1, 2)
// the V4 macroblocks a CUDA block tried
#define PROBE_FDCT(X) X(1) X(2) X(4) X(8) X(16)

}  // namespace probe

extern "C" {

int probe_idct_shapes(int* out, int n) {
  int i = 0;
#define SHAPE(B, R) if (i < n) { out[2 * i] = B; out[2 * i + 1] = R; } ++i;
  PROBE_IDCT(SHAPE)
#undef SHAPE
  return i;
}

int probe_mc_shapes(int* out, int n) {
  int i = 0;
#define SHAPE(R, M) if (i < n) { out[2 * i] = R; out[2 * i + 1] = M; } ++i;
  PROBE_MC(SHAPE)
#undef SHAPE
  return i;
}

int probe_dequant_idct(int variant, const int16_t* blocks,
                       const int32_t* bidx, int nb, const int32_t* mb,
                       int16_t* out, cudaStream_t stream) {
  switch (variant) {
    case 0:
      original::dequant_idct<<<(nb + original::V1_BLOCKS - 1) /
                                   original::V1_BLOCKS,
                               original::V1_BLOCKS * 8, 0, stream>>>(
          blocks, bidx, nb, mb, out);
      return status(cudaGetLastError());
    case 1:
      probe::idct_block<<<(nb + 127) / 128, 128, 0, stream>>>(blocks, bidx,
                                                             nb, mb, out);
      return status(cudaGetLastError());
    case 2:
      probe::idct_copy<<<(nb + V1_BPB - 1) / V1_BPB, 8 * V1_BPB, 0,
                         stream>>>(blocks, bidx, nb, mb, out);
      return status(cudaGetLastError());
  }
  int v = 3;
#define LAUNCH(B, R)                                                        \
  if (variant == v) {                                                       \
    dequant_idct_kernel<B, R><<<(nb + B - 1) / B, 8 / R * B, 0, stream>>>(  \
        blocks, bidx, nb, mb, out);                                         \
    return status(cudaGetLastError());                                      \
  }                                                                         \
  ++v;
  PROBE_IDCT(LAUNCH)
#undef LAUNCH
  return 1;
}

int probe_motion_compensate(int variant, uint8_t* y, uint8_t* u, uint8_t* v_,
                            int h16, int w16, const int32_t* mb, int n_mb,
                            const int16_t* res, const int32_t* items, int g,
                            int width, int height, cudaStream_t stream) {
  if (variant == 0) {
    original::motion_compensate<<<dim3(n_mb, g), 256, 0, stream>>>(
        y, u, v_, h16, w16, mb, n_mb, res, items, width, height);
    return status(cudaGetLastError());
  }
  if (variant == 1) {
    probe::mc_copy<MC_RES_ROWS, MC_RES_MBS>
        <<<dim3((n_mb + MC_RES_MBS - 1) / MC_RES_MBS, g),
           McShape<MC_RES_ROWS, MC_RES_MBS>::THREADS, 0, stream>>>(
            y, u, v_, h16, w16, mb, n_mb, res, items, width, height);
    return status(cudaGetLastError());
  }
  int v = 2;
#define LAUNCH(R, M)                                                        \
  if (variant == v) {                                                       \
    const dim3 grid((n_mb + M - 1) / M, g);                                 \
    if (res)                                                                \
      motion_compensate_kernel<R, M, 1>                                     \
          <<<grid, McShape<R, M>::THREADS, 0, stream>>>(                    \
              y, u, v_, h16, w16, mb, n_mb, res, items, width, height);     \
    else                                                                    \
      motion_compensate_kernel<R, M, 0>                                     \
          <<<grid, McShape<R, M>::THREADS, 0, stream>>>(                    \
              y, u, v_, h16, w16, mb, n_mb, res, items, width, height);     \
    return status(cudaGetLastError());                                      \
  }                                                                         \
  ++v;
  PROBE_MC(LAUNCH)
#undef LAUNCH
  return 1;
}

int probe_search_shapes(int* out, int n) {
  int i = 0;
#define SHAPE(R, D, M) if (i < n) { out[3 * i] = R; out[3 * i + 1] = D; \
    out[3 * i + 2] = M; } ++i;
  PROBE_SEARCH(SHAPE)
#undef SHAPE
  return i;
}

int probe_fdct_shapes(int* out, int n) {
  int i = 0;
#define SHAPE(M) if (i < n) out[i] = M; ++i;
  PROBE_FDCT(SHAPE)
#undef SHAPE
  return i;
}

int probe_motion_search(int variant, const uint8_t* y, int h16, int w16,
                        const int32_t* items, int g, int width, int height,
                        int32_t* out, cudaStream_t stream) {
  const int n_mb = (h16 / 16) * (w16 / 16);
  if (variant == 0) {
    original::motion_search<<<dim3(n_mb, g), 256, 0, stream>>>(
        y, h16, w16, items, width, height, out);
    return status(cudaGetLastError());
  }
  if (variant == 1) {
    old::first_search<8, 3, 1>
        <<<dim3(n_mb, g), old::OldShape<8, 3, 1>::THREADS, 0, stream>>>(
            y, h16, w16, items, n_mb, width, height, out);
    return status(cudaGetLastError());
  }
  if (variant == 2) {
    old::second_search<8, 3, 4>
        <<<dim3((n_mb + 3) / 4, g), old::OldShape<8, 3, 4>::THREADS, 0,
           stream>>>(y, h16, w16, items, n_mb, width, height, out);
    return status(cudaGetLastError());
  }
  int v = 3;
#define LAUNCH(R, D, M)                                                     \
  if (variant == v) {                                                       \
    motion_search_kernel<R, D, M>                                           \
        <<<dim3((n_mb + M - 1) / M, g), SearchShape<R, D, M>::THREADS, 0,   \
           stream>>>(y, h16, w16, items, n_mb, width, height, out);         \
    return status(cudaGetLastError());                                      \
  }                                                                         \
  ++v;
  PROBE_SEARCH(LAUNCH)
#undef LAUNCH
  return 1;
}

int probe_fdct_quant(int variant, const uint8_t* sy, const uint8_t* su,
                     const uint8_t* sv, const uint8_t* py,
                     const uint8_t* pu, const uint8_t* pv, int h16, int w16,
                     const int32_t* mb, const int32_t* items, int g,
                     int16_t* out, cudaStream_t stream) {
  const int n_mb = (h16 / 16) * (w16 / 16), total = g * n_mb;
  switch (variant) {
    case 0:
      original::fdct_quant<<<dim3(n_mb, g), 384, 0, stream>>>(
          sy, su, sv, py, pu, pv, h16, w16, mb, n_mb, items, out);
      return status(cudaGetLastError());
    case 1:
      probe::fdct_block<<<(total * 6 + probe::BLOCK_THREADS - 1) /
                              probe::BLOCK_THREADS,
                          probe::BLOCK_THREADS, 0, stream>>>(
          sy, su, sv, py, pu, pv, h16, w16, mb, n_mb, total, items, out);
      return status(cudaGetLastError());
    case 2:
      probe::fdct_copy<<<(total + FQ_MBS - 1) / FQ_MBS, 48 * FQ_MBS, 0,
                         stream>>>(sy, su, sv, py, pu, pv, h16, w16, mb, n_mb,
                                   total, items, out);
      return status(cudaGetLastError());
  }
  int v = 3;
#define LAUNCH(M)                                                           \
  if (variant == v) {                                                       \
    fdct_quant_kernel<M><<<(total + M - 1) / M, 48 * M, 0, stream>>>(       \
        sy, su, sv, py, pu, pv, h16, w16, mb, n_mb, total, items, out);     \
    return status(cudaGetLastError());                                      \
  }                                                                         \
  ++v;
  PROBE_FDCT(LAUNCH)
#undef LAUNCH
  return 1;
}

int probe_gm_shapes(int* out, int n) {
  int i = 0;
#define SHAPE(M) if (i < n) out[i] = M; ++i;
  PROBE_GM(SHAPE)
#undef SHAPE
  return i;
}

int probe_gm_minb(int* out, int n) {
  int i = 0;
#define SHAPE(M) if (i < n) out[i] = M; ++i;
  PROBE_GM_MINB(SHAPE)
#undef SHAPE
  return i;
}

// V5: 0 PR 21's form, 1-5 copy and its parts (at BD_MBS), 6..
// bidir_compensate_kernel at PROBE_GM's shapes, PROBE_GM_MINB's, staged
// and unstaged
int probe_bidir_compensate(int variant, uint8_t* y, uint8_t* u, uint8_t* v_,
                           int h16, int w16, const int32_t* bmb, int n_mb,
                           const int16_t* res, const int32_t* items, int g,
                           int ew, int eh, int qpel, int rule,
                           cudaStream_t stream) {
  if (variant == 0) {
    asp_original::bidir_compensate_kernel<<<dim3(n_mb, g),
                                            asp_original::GM_THREADS, 0,
                                            stream>>>(
        y, u, v_, h16, w16, bmb, n_mb, res, items, ew, eh, qpel, rule);
    return status(cudaGetLastError());
  }
  const dim3 grid((n_mb + BD_MBS - 1) / BD_MBS, g);
#define COPY(V, P, S)                                                       \
  if (variant == V) {                                                       \
    if (qpel)                                                               \
      probe::gm_copy<BD_MBS, true, true, P, S>                              \
          <<<grid, 32 * BD_MBS, 0, stream>>>(y, u, v_, h16, w16, bmb, n_mb, \
                                             res, items, ew, eh, rule);     \
    else                                                                    \
      probe::gm_copy<BD_MBS, true, false, P, S>                             \
          <<<grid, 32 * BD_MBS, 0, stream>>>(y, u, v_, h16, w16, bmb, n_mb, \
                                             res, items, ew, eh, rule);     \
    return status(cudaGetLastError());                                      \
  }
  COPY(1, 0, true) COPY(2, 1, true) COPY(3, 2, true) COPY(4, 3, true)
  COPY(5, 3, false)
#undef COPY
  int v = 6;
#define LAUNCH(M)                                                           \
  if (variant == v) {                                                       \
    const dim3 grid((n_mb + M - 1) / M, g);                                 \
    if (qpel)                                                               \
      bidir_compensate_kernel<M, true, 32 / M, BD_STAGE>                    \
          <<<grid, 32 * M, 0, stream>>>(y, u, v_, h16, w16, bmb, n_mb, res, \
                                        items, ew, eh, rule);               \
    else                                                                    \
      bidir_compensate_kernel<M, false, 32 / M, BD_STAGE>                   \
          <<<grid, 32 * M, 0, stream>>>(y, u, v_, h16, w16, bmb, n_mb, res, \
                                        items, ew, eh, rule);               \
    return status(cudaGetLastError());                                      \
  }                                                                         \
  ++v;
  PROBE_GM(LAUNCH)
#undef LAUNCH
#define LAUNCH(B)                                                           \
  if (variant == v) {                                                       \
    const dim3 grid((n_mb + BD_MBS - 1) / BD_MBS, g);                       \
    if (qpel)                                                               \
      bidir_compensate_kernel<BD_MBS, true, B, BD_STAGE>                    \
          <<<grid, 32 * BD_MBS, 0, stream>>>(y, u, v_, h16, w16, bmb, n_mb, \
                                             res, items, ew, eh, rule);     \
    else                                                                    \
      bidir_compensate_kernel<BD_MBS, false, B, BD_STAGE>                   \
          <<<grid, 32 * BD_MBS, 0, stream>>>(y, u, v_, h16, w16, bmb, n_mb, \
                                             res, items, ew, eh, rule);     \
    return status(cudaGetLastError());                                      \
  }                                                                         \
  ++v;
  PROBE_GM_MINB(LAUNCH)
#undef LAUNCH
  // the port's shape with its block's rows staged, then unstaged
#define LAUNCH(S)                                                           \
  if (variant == v) {                                                       \
    if (qpel)                                                               \
      bidir_compensate_kernel<BD_MBS, true, BD_MINB, S>                     \
          <<<grid, 32 * BD_MBS, 0, stream>>>(y, u, v_, h16, w16, bmb, n_mb, \
                                             res, items, ew, eh, rule);     \
    else                                                                    \
      bidir_compensate_kernel<BD_MBS, false, BD_MINB, S>                    \
          <<<grid, 32 * BD_MBS, 0, stream>>>(y, u, v_, h16, w16, bmb, n_mb, \
                                             res, items, ew, eh, rule);     \
    return status(cudaGetLastError());                                      \
  }                                                                         \
  ++v;
  LAUNCH(true) LAUNCH(false)
#undef LAUNCH
  return 1;
}

// V2 at quarter-pel: 0 PR 21's form, 1-5 copy and its parts (at MCQ_MBS),
// 6.. motion_compensate_qpel_kernel at PROBE_GM's shapes, PROBE_GM_MINB's,
// staged and unstaged
int probe_mc_qpel(int variant, uint8_t* y, uint8_t* u, uint8_t* v_, int h16,
                  int w16, const int32_t* mb, int n_mb, const int16_t* res,
                  const int32_t* items, int g, int ew, int eh, int rule,
                  cudaStream_t stream) {
  if (variant == 0) {
    asp_original::motion_compensate_qpel_kernel<<<
        dim3(n_mb, g), asp_original::GM_THREADS, 0, stream>>>(
        y, u, v_, h16, w16, mb, n_mb, res, items, ew, eh, rule);
    return status(cudaGetLastError());
  }
  const dim3 grid((n_mb + MCQ_MBS - 1) / MCQ_MBS, g);
#define COPY(V, P, S)                                                       \
  if (variant == V) {                                                       \
    probe::gm_copy<MCQ_MBS, false, true, P, S>                              \
        <<<grid, 32 * MCQ_MBS, 0, stream>>>(y, u, v_, h16, w16, mb, n_mb,   \
                                            res, items, ew, eh, rule);      \
    return status(cudaGetLastError());                                      \
  }
  COPY(1, 0, true) COPY(2, 1, true) COPY(3, 2, true) COPY(4, 3, true)
  COPY(5, 3, false)
#undef COPY
  int v = 6;
#define LAUNCH(M)                                                           \
  if (variant == v) {                                                       \
    motion_compensate_qpel_kernel<M, 32 / M, MCQ_STAGE>                     \
        <<<dim3((n_mb + M - 1) / M, g), 32 * M, 0, stream>>>(               \
            y, u, v_, h16, w16, mb, n_mb, res, items, ew, eh, rule);        \
    return status(cudaGetLastError());                                      \
  }                                                                         \
  ++v;
  PROBE_GM(LAUNCH)
#undef LAUNCH
#define LAUNCH(B)                                                           \
  if (variant == v) {                                                       \
    motion_compensate_qpel_kernel<MCQ_MBS, B, MCQ_STAGE>                    \
        <<<grid, 32 * MCQ_MBS, 0, stream>>>(y, u, v_, h16, w16, mb, n_mb,   \
                                            res, items, ew, eh, rule);      \
    return status(cudaGetLastError());                                      \
  }                                                                         \
  ++v;
  PROBE_GM_MINB(LAUNCH)
#undef LAUNCH
  // the port's shape with its block's rows staged, then unstaged
#define LAUNCH(S)                                                           \
  if (variant == v) {                                                       \
    motion_compensate_qpel_kernel<MCQ_MBS, MCQ_MINB, S>                     \
        <<<grid, 32 * MCQ_MBS, 0, stream>>>(y, u, v_, h16, w16, mb, n_mb,   \
                                            res, items, ew, eh, rule);      \
    return status(cudaGetLastError());                                      \
  }                                                                         \
  ++v;
  LAUNCH(true) LAUNCH(false)
#undef LAUNCH
  return 1;
}

int probe_rate(int kind, int blocks, int threads, int iters, unsigned* out,
               cudaStream_t stream) {
  switch (kind) {
    case 0:
      probe::rate<0><<<blocks, threads, 0, stream>>>(iters, 7u, out);
      break;
    case 1:
      probe::rate<1><<<blocks, threads, 0, stream>>>(iters, 7u, out);
      break;
    case 2:
      probe::rate<2><<<blocks, threads, 0, stream>>>(iters, 7u, out);
      break;
    case 3:
      probe::rate<3><<<blocks, threads, 0, stream>>>(iters, 7u, out);
      break;
    default:
      return 1;
  }
  return status(cudaGetLastError());
}

}  // extern "C"
