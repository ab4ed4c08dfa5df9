// Forms of kernels H3 (intra_reconstruct) and H4 (deblock) of
// faceoff_tpu_torch/csrc/h264.cu beside the port's, timed in turns by
// tools/h264_variants_torch.py. Not used by the port. The port's source
// is included, so the port's kernels are instantiated here at other
// WAVE_ROWS (macroblock rows a thread block: 1, 2, 4, 8); the
// `original` forms are the port's first ones (one thread block of 64
// threads a macroblock row, a block barrier and L2 reads between the
// dependent steps, the row handoff by atomics), kept as they were.
//
// probe_h264_intra(form, ...), probe_h264_deblock(form, ...): form 0 the
// original, form k > 0 the port's kernel at kRows[k - 1] rows a block;
// the arguments are h264_intra_reconstruct's and h264_deblock's.
// probe_h264_forms(rows, n): the rows a block of forms 1.., their count.

#include "../faceoff_tpu_torch/csrc/h264.cu"

namespace orig {

__device__ __forceinline__ int ld(const uint8_t* p) {
  return int(__ldcg(p));
}

// the wavefront's bookkeeping: row claimed by ticket; wait until the row
// above has finished `need` macroblocks; publish this row's progress
__device__ int claim_row(int* ticket) {
  __shared__ int row;
  if (threadIdx.x == 0) row = atomicAdd(ticket, 1);
  __syncthreads();
  return row;
}

__device__ void wait_row(const int* progress, int y, int need) {
  if (y > 0) {
    if (threadIdx.x == 0) {
      while (atomicAdd(const_cast<int*>(progress + y - 1), 0) < need) {
      }
      __threadfence();
    }
    __syncthreads();
  }
}

__device__ void publish(int* progress, int y, int done) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicExch(progress + y, done);
}

// intra availability of a neighbour macroblock (8.3.1.2 etc.)
__device__ bool intra_avail(const int32_t* mb, int mbw, int mbh, int x,
                            int y, int dx, int dy, int slice, int cip) {
  int nx = x + dx, ny = y + dy;
  if (nx < 0 || nx >= mbw || ny < 0 || ny >= mbh) return false;
  const int32_t* n = mb + int64_t(ny * mbw + nx) * MB_FIELDS;
  if (n[F_SLICE] != slice) return false;
  return !(cip && n[F_KIND] <= H_INTER);
}

__device__ int dc_pred(int st, int sl, bool top, bool left, int n_log2) {
  if (top && left) return (st + sl + (1 << n_log2)) >> (n_log2 + 1);
  if (left) return (sl + (1 << (n_log2 - 1))) >> n_log2;
  if (top) return (st + (1 << (n_log2 - 1))) >> n_log2;
  return 128;
}

constexpr int WAVE_THREADS = 64;

// H3: a thread block a macroblock row
__global__ void intra_kernel(uint8_t* __restrict__ yp,
                             uint8_t* __restrict__ up,
                             uint8_t* __restrict__ vp, int h, int w, int out,
                             const int32_t* __restrict__ mb,
                             const uint8_t* __restrict__ pcm, int mbw,
                             const int16_t* __restrict__ ry,
                             const int16_t* __restrict__ rc, int* ticket,
                             int* progress) {
  int mbh = h / 16;
  int y = claim_row(ticket);
  int t = threadIdx.x;
  int hc = h >> 1, wc = w >> 1;
  uint8_t* Y = yp + int64_t(out) * h * w;
  uint8_t* P[2] = {up + int64_t(out) * hc * wc, vp + int64_t(out) * hc * wc};
  __shared__ int edge[2][20];
  __shared__ int tl_s[2];
  for (int x = 0; x < mbw; x++) {
    wait_row(progress, y, min(x + 2, mbw));
    const int32_t* row = mb + int64_t(y * mbw + x) * MB_FIELDS;
    int kind = row[F_KIND];
    if (kind == H_PCM) {
      const uint8_t* s = pcm + int64_t(row[F_PCM]) * 384;
      for (int i = t; i < 256; i += WAVE_THREADS)
        Y[int64_t(16 * y + (i >> 4)) * w + 16 * x + (i & 15)] = s[i];
      for (int i = t; i < 128; i += WAVE_THREADS) {
        int c = i >> 6, k = i & 63;
        P[c][int64_t(8 * y + (k >> 3)) * wc + 8 * x + (k & 7)] =
            s[256 + i];
      }
    } else if (kind == H_I4 || kind == H_I16) {
      int slice = row[F_SLICE], cip = row[F_CIP];
      bool avA = intra_avail(mb, mbw, mbh, x, y, -1, 0, slice, cip);
      bool avB = intra_avail(mb, mbw, mbh, x, y, 0, -1, slice, cip);
      bool avC = intra_avail(mb, mbw, mbh, x, y, 1, -1, slice, cip);
      bool avD = intra_avail(mb, mbw, mbh, x, y, -1, -1, slice, cip);
      int x0 = 16 * x, y0 = 16 * y;
      if (kind == H_I16) {
        __shared__ int top[16], left[16], tl;
        if (t < 16) {
          top[t] = ld(Y + int64_t(max(y0 - 1, 0)) * w + x0 + t);
          left[t] = ld(Y + int64_t(y0 + t) * w + max(x0 - 1, 0));
        }
        if (t == 16) tl = ld(Y + int64_t(max(y0 - 1, 0)) * w + max(x0 - 1, 0));
        __syncthreads();
        int mode = row[F_I16];
        int st = 0, sl = 0, hh = 0, vv = 0;
        for (int i = 0; i < 16; i++) {
          st += top[i];
          sl += left[i];
        }
        for (int k = 0; k < 8; k++) {
          int a = 6 - k >= 0 ? top[6 - k] : tl;
          int c = 6 - k >= 0 ? left[6 - k] : tl;
          hh += (k + 1) * (top[8 + k] - a);
          vv += (k + 1) * (left[8 + k] - c);
        }
        int dc = dc_pred(st, sl, avB, avA, 4);
        int pa = 16 * (left[15] + top[15]);
        int pb = (5 * hh + 32) >> 6, pc = (5 * vv + 32) >> 6;
        for (int i = t; i < 256; i += WAVE_THREADS) {
          int xx = i & 15, yy = i >> 4, p;
          if (mode == 0) p = top[xx];
          else if (mode == 1) p = left[yy];
          else if (mode == 2) p = dc;
          else p = clip1((pa + pb * (xx - 7) + pc * (yy - 7) + 16) >> 5);
          int64_t at = int64_t(y0 + yy) * w + x0 + xx;
          Y[at] = uint8_t(clip1(p + ry[at]));
        }
        __syncthreads();
      } else {
        uint32_t md[2] = {uint32_t(row[F_MODES]), uint32_t(row[F_MODES_HI])};
        // top-right inside the macroblock decoded before the block (by > 0)
        const int TR[16] = {0, 0, 0, 0, 1, 0, 1, 0, 1, 1, 1, 0, 1, 0, 1, 0};
        __shared__ int e[13];
        for (int k = 0; k < 16; k++) {
          const int rast[16] = {0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11,
                                14, 15};
          int b = rast[k], bx = b & 3, by = b >> 2;
          int bx0 = x0 + 4 * bx, by0 = y0 + 4 * by;
          bool left_av = bx > 0 || avA, top_av = by > 0 || avB;
          bool tr_av = by == 0 ? (bx == 3 ? avC : avB) : TR[b] == 1;
          if (t < 13) {
            int v;
            if (t < 4) {  // p[-1, 3 - t]
              v = ld(Y + int64_t(by0 + 3 - t) * w + max(bx0 - 1, 0));
            } else if (t == 4) {
              v = ld(Y + int64_t(max(by0 - 1, 0)) * w + max(bx0 - 1, 0));
            } else {
              int xx = t - 5;
              if (xx >= 4 && !tr_av) xx = 3;
              v = ld(Y + int64_t(max(by0 - 1, 0)) * w + min(bx0 + xx, w - 1));
            }
            e[t] = v;
          }
          __syncthreads();
          if (t < 16) {
            int mode = (md[b >> 3] >> (4 * (b & 7))) & 15;
            int p;
            if (mode == 2) {
              int st = e[5] + e[6] + e[7] + e[8], sl = e[0] + e[1] + e[2] + e[3];
              p = dc_pred(st, sl, top_av, left_av, 2);
            } else {
              const int* tp = c_taps + (mode * 16 + t) * 8;
              p = (e[tp[0]] * tp[3] + e[tp[1]] * tp[4] + e[tp[2]] * tp[5] +
                   tp[6]) >> tp[7];
            }
            int64_t at = int64_t(by0 + (t >> 2)) * w + bx0 + (t & 3);
            Y[at] = uint8_t(clip1(p + ry[at]));
          }
          __threadfence_block();
          __syncthreads();
        }
      }
      // chroma: both components
      int cx0 = x0 >> 1, cy0 = y0 >> 1;
      if (t < 34) {
        int c = t / 17, k = t % 17;
        const uint8_t* pl = P[c];
        int v;
        if (k < 8) v = ld(pl + int64_t(max(cy0 - 1, 0)) * wc + cx0 + k);
        else if (k < 16) v = ld(pl + int64_t(cy0 + k - 8) * wc + max(cx0 - 1, 0));
        else v = ld(pl + int64_t(max(cy0 - 1, 0)) * wc + max(cx0 - 1, 0));
        if (k < 16) edge[c][k] = v;
        else tl_s[c] = v;
      }
      __syncthreads();
      int cmode = row[F_CMODE];
      for (int i = t; i < 128; i += WAVE_THREADS) {
        int c = i >> 6, k = i & 63, xx = k & 7, yy = k >> 3;
        const int* top = edge[c];
        const int* left = edge[c] + 8;
        int p;
        if (cmode == 0) {
          int cbx = xx >> 2, cby = yy >> 2, st = 0, sl = 0;
          for (int j = 0; j < 4; j++) {
            st += top[4 * cbx + j];
            sl += left[4 * cby + j];
          }
          if (cbx == cby) p = dc_pred(st, sl, avB, avA, 2);
          else if (cby == 0) p = avB ? (st + 2) >> 2 : avA ? (sl + 2) >> 2 : 128;
          else p = avA ? (sl + 2) >> 2 : avB ? (st + 2) >> 2 : 128;
        } else if (cmode == 1) {
          p = left[yy];
        } else if (cmode == 2) {
          p = top[xx];
        } else {
          int hh = 0, vv = 0;
          for (int j = 0; j < 4; j++) {
            int a = 2 - j >= 0 ? top[2 - j] : tl_s[c];
            int b2 = 2 - j >= 0 ? left[2 - j] : tl_s[c];
            hh += (j + 1) * (top[4 + j] - a);
            vv += (j + 1) * (left[4 + j] - b2);
          }
          int pa = 16 * (left[7] + top[7]);
          int pb = (34 * hh + 32) >> 6, pc = (34 * vv + 32) >> 6;
          p = clip1((pa + pb * (xx - 3) + pc * (yy - 3) + 16) >> 5);
        }
        int64_t at = int64_t(cy0 + yy) * wc + cx0 + xx;
        P[c][at] = uint8_t(clip1(p + rc[int64_t(c) * hc * wc + at]));
      }
    }
    publish(progress, y, x + 1);
  }
}

// bS of the edge between 4x4 luma blocks pb (of macroblock pm) and qb (of
// qm)
__device__ int bs_of(const int32_t* mb, const int32_t* blk, int pm, int pb,
                     int qm, int qb, bool mb_edge) {
  int kp = mb[int64_t(pm) * MB_FIELDS + F_KIND];
  int kq = mb[int64_t(qm) * MB_FIELDS + F_KIND];
  if (kp >= H_I4 || kq >= H_I4) return mb_edge ? 4 : 3;
  const int32_t* p = blk + (int64_t(pm) * 16 + pb) * BLK_FIELDS;
  const int32_t* q = blk + (int64_t(qm) * 16 + qb) * BLK_FIELDS;
  if (p[3] != 0 || q[3] != 0) return 2;
  if (p[2] != q[2] || abs(p[0] - q[0]) >= 4 || abs(p[1] - q[1]) >= 4)
    return 1;
  return 0;
}

// 8.7.2.3-4 on one line of 8 samples at `at`, `step` apart
__device__ void filter_line(uint8_t* pl, int64_t at, int64_t step, int bs,
                            int qpav, int off_a, int off_b, bool chroma) {
  int v[8];
  for (int i = 0; i < 8; i++) v[i] = ld(pl + at + (i - 4) * step);
  int p3 = v[0], p2 = v[1], p1 = v[2], p0 = v[3];
  int q0 = v[4], q1 = v[5], q2 = v[6], q3 = v[7];
  int ia = min(max(qpav + off_a, 0), 51), ib = min(max(qpav + off_b, 0), 51);
  int alpha = c_alpha[ia], beta = c_beta[ib];
  if (!(bs > 0 && abs(p0 - q0) < alpha && abs(p1 - p0) < beta &&
        abs(q1 - q0) < beta))
    return;
  bool ap = !chroma && abs(p2 - p0) < beta;
  bool aq = !chroma && abs(q2 - q0) < beta;
  int o[6] = {p2, p1, p0, q0, q1, q2};
  if (bs < 4) {
    int tc0 = c_tc0[ia * 3 + bs - 1];
    int tc = chroma ? tc0 + 1 : tc0 + ap + aq;
    int delta = min(max((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc), tc);
    o[2] = clip1(p0 + delta);
    o[3] = clip1(q0 - delta);
    int mid = (p0 + q0 + 1) >> 1;
    if (ap) o[1] = p1 + min(max((p2 + mid - (p1 << 1)) >> 1, -tc0), tc0);
    if (aq) o[4] = q1 + min(max((q2 + mid - (q1 << 1)) >> 1, -tc0), tc0);
  } else {
    bool small = abs(p0 - q0) < ((alpha >> 2) + 2);
    if (ap && small) {
      o[2] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
      o[1] = (p2 + p1 + p0 + q0 + 2) >> 2;
      o[0] = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
    } else {
      o[2] = (2 * p1 + p0 + q1 + 2) >> 2;
    }
    if (aq && small) {
      o[3] = (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3;
      o[4] = (p0 + q0 + q1 + q2 + 2) >> 2;
      o[5] = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
    } else {
      o[3] = (2 * q1 + q0 + p1 + 2) >> 2;
    }
  }
  for (int i = 0; i < 6; i++) pl[at + (i - 3) * step] = uint8_t(o[i]);
}

// H4: a thread block a macroblock row; per macroblock the vertical edges,
// then the horizontal ones, luma (threads 0-15, a line each) beside
// chroma's edges 0 and 4 (threads 16-31: 8 lines of Cb, 8 of Cr)
__global__ void deblock_kernel(uint8_t* __restrict__ yp,
                               uint8_t* __restrict__ up,
                               uint8_t* __restrict__ vp, int h, int w,
                               int out, const int32_t* __restrict__ mb,
                               const int32_t* __restrict__ blk, int mbw,
                               int* ticket, int* progress) {
  int y = claim_row(ticket);
  int t = threadIdx.x;
  int hc = h >> 1, wc = w >> 1;
  uint8_t* Y = yp + int64_t(out) * h * w;
  uint8_t* P[2] = {up + int64_t(out) * hc * wc, vp + int64_t(out) * hc * wc};
  for (int x = 0; x < mbw; x++) {
    wait_row(progress, y, min(x + 2, mbw));
    int q = y * mbw + x;
    const int32_t* row = mb + int64_t(q) * MB_FIELDS;
    if (row[F_FILTER] == 0) {
      for (int dir = 0; dir < 2; dir++) {
        for (int e = 0; e < 4; e++) {
          if (e == 0 && (dir == 0 ? x == 0 : y == 0)) continue;
          int pm = e > 0 ? q : (dir == 0 ? q - 1 : q - mbw);
          const int32_t* prow = mb + int64_t(pm) * MB_FIELDS;
          int qp_p = prow[F_KIND] == H_PCM ? 0 : prow[F_QP];
          int qp_q = row[F_KIND] == H_PCM ? 0 : row[F_QP];
          if (t < 16) {
            int line = t, pb, qb;
            if (dir == 0) {
              qb = (line >> 2) * 4 + e;
              pb = (line >> 2) * 4 + ((e + 3) & 3);
            } else {
              qb = e * 4 + (line >> 2);
              pb = ((e + 3) & 3) * 4 + (line >> 2);
            }
            int bs = bs_of(mb, blk, pm, pb, q, qb, e == 0);
            int64_t at = dir == 0
                ? int64_t(16 * y + line) * w + 16 * x + 4 * e
                : int64_t(16 * y + 4 * e) * w + 16 * x + line;
            filter_line(Y, at, dir == 0 ? 1 : w, bs, (qp_p + qp_q + 1) >> 1,
                        row[F_ALPHA], row[F_BETA], false);
          } else if (t < 32 && (e & 1) == 0) {
            int c = (t - 16) >> 3, k = (t - 16) & 7;
            int line = 2 * k, pb, qb;
            if (dir == 0) {
              qb = (line >> 2) * 4 + e;
              pb = (line >> 2) * 4 + ((e + 3) & 3);
            } else {
              qb = e * 4 + (line >> 2);
              pb = ((e + 3) & 3) * 4 + (line >> 2);
            }
            int bs = bs_of(mb, blk, pm, pb, q, qb, e == 0);
            int cp = c_cqp[min(max(qp_p + prow[F_QPC], 0), 51)];
            int cq = c_cqp[min(max(qp_q + row[F_QPC], 0), 51)];
            int64_t at = dir == 0
                ? int64_t(8 * y + k) * wc + 8 * x + 2 * e
                : int64_t(8 * y + 2 * e) * wc + 8 * x + k;
            filter_line(P[c], at, dir == 0 ? 1 : wc, bs, (cp + cq + 1) >> 1,
                        row[F_ALPHA], row[F_BETA], true);
          }
          __threadfence_block();
          __syncthreads();
        }
      }
    }
    publish(progress, y, x + 1);
  }
}

}  // namespace orig

namespace {

constexpr int kRows[] = {1, 2, 4, 8};
constexpr int kForms = 1 + int(sizeof(kRows) / sizeof(kRows[0]));

template <int ROWS>
void intra_at(cudaStream_t s, uint8_t* y, uint8_t* u, uint8_t* v,
              int h, int w, int out, const int32_t* mb, const uint8_t* pcm,
              int mbw, const int16_t* ry, const int16_t* rc, int* sync) {
  intra_kernel<ROWS><<<(h / 16 + ROWS - 1) / ROWS, 32 * ROWS, 0, s>>>(
      y, u, v, h, w, out, mb, pcm, mbw, ry, rc, sync, sync + 1);
}

template <int ROWS>
void deblock_at(cudaStream_t s, uint8_t* y, uint8_t* u, uint8_t* v, int h,
                int w, int out, const int32_t* mb, const int32_t* blk,
                int mbw, int* sync) {
  deblock_kernel<ROWS><<<(h / 16 + ROWS - 1) / ROWS, 32 * ROWS, 0, s>>>(
      y, u, v, h, w, out, mb, blk, mbw, sync, sync + 1);
}

}  // namespace

extern "C" {

int probe_h264_forms(int* rows, int n) {
  for (int i = 0; i < kForms - 1 && i < n; i++) rows[i] = kRows[i];
  return kForms;
}

int probe_h264_intra(int form, uint8_t* y, uint8_t* u, uint8_t* v, int h,
                     int w, int out, const int32_t* mb, const uint8_t* pcm,
                     int mbw, const int16_t* ry, const int16_t* rc,
                     int* sync, cudaStream_t stream) {
  int rows = h / 16;
  cudaError_t e = cudaMemsetAsync(sync, 0, sizeof(int) * (1 + rows), stream);
  if (e != cudaSuccess) return status(e);
  switch (form) {
    case 0:
      orig::intra_kernel<<<rows, orig::WAVE_THREADS, 0, stream>>>(
          y, u, v, h, w, out, mb, pcm, mbw, ry, rc, sync, sync + 1);
      break;
    case 1: intra_at<1>(stream, y, u, v, h, w, out, mb, pcm, mbw, ry, rc, sync); break;
    case 2: intra_at<2>(stream, y, u, v, h, w, out, mb, pcm, mbw, ry, rc, sync); break;
    case 3: intra_at<4>(stream, y, u, v, h, w, out, mb, pcm, mbw, ry, rc, sync); break;
    case 4: intra_at<8>(stream, y, u, v, h, w, out, mb, pcm, mbw, ry, rc, sync); break;
    default: return 1;
  }
  return status(cudaGetLastError());
}

int probe_h264_deblock(int form, uint8_t* y, uint8_t* u, uint8_t* v, int h,
                       int w, int out, const int32_t* mb, const int32_t* blk,
                       int mbw, int* sync, cudaStream_t stream) {
  int rows = h / 16;
  cudaError_t e = cudaMemsetAsync(sync, 0, sizeof(int) * (1 + rows), stream);
  if (e != cudaSuccess) return status(e);
  switch (form) {
    case 0:
      orig::deblock_kernel<<<rows, orig::WAVE_THREADS, 0, stream>>>(
          y, u, v, h, w, out, mb, blk, mbw, sync, sync + 1);
      break;
    case 1: deblock_at<1>(stream, y, u, v, h, w, out, mb, blk, mbw, sync); break;
    case 2: deblock_at<2>(stream, y, u, v, h, w, out, mb, blk, mbw, sync); break;
    case 3: deblock_at<4>(stream, y, u, v, h, w, out, mb, blk, mbw, sync); break;
    case 4: deblock_at<8>(stream, y, u, v, h, w, out, mb, blk, mbw, sync); break;
    default: return 1;
  }
  return status(cudaGetLastError());
}

}  // extern "C"
