// H.264 Constrained Baseline decoding (faceoff_tpu_torch/io/h264.py,
// ops/h264_cuda.py): the host half, the macroblock layer of each picture
// parsed on host threads into records, and four device stages in integer
// arithmetic, each equal bit for bit to its plain torch version.
//
//   H1 h264_residual           dequantisation and the inverse 4x4
//                              transform of every block of a batch (the
//                              Intra16x16 DC Hadamard, the chroma DC 2x2
//                              transform), one thread a 4x4 block
//   H2 h264_inter_predict      the inter macroblocks of one P picture:
//                              six-tap quarter-pel luma, eighth-pel
//                              chroma, plus the residual; a thread block
//                              a macroblock, a thread a luma sample
//   H3 h264_intra_reconstruct  the intra macroblocks of one picture, a
//                              wavefront: a thread block a macroblock row
//                              (rows claimed by ticket, so no block waits
//                              on one that has not started), macroblock
//                              (x, y) after the row above has finished
//                              x + 2; Intra4x4's blocks in decoding order
//   H4 h264_deblock            the loop filter of one picture, the same
//                              wavefront
//
// Sample reads of H3 and H4 go through L2 (__ldcg): other blocks write
// the rows above while a block runs. Records (see io/h264.py): mb
// (M, 16) int32, blk (M, 16, 4) int32, bmap (M, 27) int32, coef (NB, 16)
// int16, pcm (NP, 384) uint8.
//
// The host half compiles without CUDA too (any C++17 compiler); the
// kernels only under nvcc.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

enum { H_SKIP = 0, H_INTER = 1, H_I4 = 2, H_I16 = 3, H_PCM = 4 };
enum {
  F_KIND = 0, F_QP, F_QPC, F_I16, F_CMODE, F_SLICE, F_FILTER, F_ALPHA,
  F_BETA, F_CIP, F_MODES, F_MODES_HI, F_PCM, MB_FIELDS = 16
};
constexpr int BLK_FIELDS = 4;
constexpr int NBLK = 27;

// ---------------------------------------------------------------------------
// the host parser
// ---------------------------------------------------------------------------

struct ParseError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// a VLC decoding table: each `bits`-bit peek gives (symbol << 8) | length
struct Vlc {
  int bits = 0;
  std::vector<int32_t> table;
  void build(int n, const int32_t* lens, const int32_t* codes) {
    bits = 0;
    for (int i = 0; i < n; i++) bits = lens[i] > bits ? lens[i] : bits;
    table.assign(size_t(1) << bits, 0);
    for (int i = 0; i < n; i++) {
      if (!lens[i]) continue;
      uint32_t lo = uint32_t(codes[i]) << (bits - lens[i]);
      for (uint32_t k = lo; k < lo + (1u << (bits - lens[i])); k++)
        table[k] = (i << 8) | lens[i];
    }
  }
};

// tables: 0-3 coeff_token by nC range, 4 chroma DC coeff_token, 5-19
// total_zeros by total_coeff, 20-22 chroma DC total_zeros, 23-29
// run_before by zerosLeft; two me(v) maps for coded_block_pattern
Vlc g_vlc[30];
int g_cbp[2][48];

struct Bits {
  const uint8_t* d;
  int64_t pos, trail;
  uint32_t peek(int n) const {
    if (n == 0) return 0;
    const uint8_t* p = d + (pos >> 3);
    uint64_t v = 0;
    for (int i = 0; i < 8; i++) v = (v << 8) | p[i];
    return uint32_t((v << (pos & 7)) >> (64 - n));
  }
  uint32_t read(int n) {
    uint32_t v = peek(n);
    pos += n;
    return v;
  }
  int ue() {
    uint32_t v = peek(32);
    if (v == 0) throw ParseError("Exp-Golomb code too long");
    int lz = __builtin_clz(v);
    pos += lz;
    return int(read(lz + 1)) - 1;
  }
  int se() {
    int k = ue();
    return (k & 1) ? (k + 1) >> 1 : -(k >> 1);
  }
  int te(int cmax) { return cmax == 1 ? 1 - int(read(1)) : ue(); }
  int vlc(const Vlc& t) {
    int e = t.table[peek(t.bits)];
    if ((e & 255) == 0) throw ParseError("no VLC code");
    pos += e & 255;
    return e >> 8;
  }
  bool more() const { return pos < trail; }
};

// one slice as io/h264.py's scan gives it
enum {
  S_OFFSET = 0, S_SIZE, S_DATA_BIT, S_KIND, S_FIRST_MB, S_QP, S_NUM_REF,
  S_FILTER, S_ALPHA, S_BETA, S_QPC, S_CIP, S_REFS, SLICE_FIELDS = S_REFS + 32
};
constexpr int SLICE_P = 0;

const int ZIGZAG4[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14,
                         15};
const int BLK_RASTER[16] = {0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11,
                            14, 15};

struct Part {
  bool avail;
  int ref, mx, my;
};

struct Picture {
  int w, h, m;
  const int64_t* sl = nullptr;
  const uint8_t* data = nullptr;
  int cur_slice = 0;
  std::vector<int32_t> mb, blk, bmap;
  std::vector<int16_t> coef;
  std::vector<uint8_t> pcm;
  std::vector<int> kind, slice_of, modes, tc, tcc, mv, ref;
  std::string error;

  void init(int mbw, int mbh) {
    w = mbw;
    h = mbh;
    m = w * h;
    mb.assign(size_t(m) * MB_FIELDS, 0);
    for (int i = 0; i < m; i++) mb[size_t(i) * MB_FIELDS + F_PCM] = -1;
    blk.assign(size_t(m) * 16 * BLK_FIELDS, 0);
    bmap.assign(size_t(m) * NBLK, -1);
    kind.assign(m, -1);
    slice_of.assign(m, -1);
    modes.assign(size_t(m) * 16, 0);
    tc.assign(size_t(m) * 16, 0);
    tcc.assign(size_t(m) * 8, 0);
    mv.assign(size_t(m) * 32, 0);
    ref.assign(size_t(m) * 16, -1);
  }

  int nb(int addr, int dx, int dy) const {
    int x = addr % w + dx, y = addr / w + dy;
    if (x < 0 || x >= w || y < 0 || y >= h) return -1;
    int n = y * w + x;
    return (slice_of[n] == cur_slice && n < addr) ? n : -1;
  }

  void store_coef(int addr, int b, const int* raster) {
    bool any = false;
    for (int i = 0; i < 16; i++) any |= raster[i] != 0;
    if (!any) return;
    bmap[size_t(addr) * NBLK + b] = int(coef.size() / 16);
    for (int i = 0; i < 16; i++) coef.push_back(int16_t(raster[i]));
  }

  int nc_luma(int addr, int r) const {
    int bx = r & 3, by = r >> 2, na = 0, nbv = 0;
    bool ha, hb;
    if (bx) {
      ha = true;
      na = tc[size_t(addr) * 16 + r - 1];
    } else {
      int a = nb(addr, -1, 0);
      ha = a >= 0;
      if (ha) na = tc[size_t(a) * 16 + r + 3];
    }
    if (by) {
      hb = true;
      nbv = tc[size_t(addr) * 16 + r - 4];
    } else {
      int b = nb(addr, 0, -1);
      hb = b >= 0;
      if (hb) nbv = tc[size_t(b) * 16 + r + 12];
    }
    if (ha && hb) return (na + nbv + 1) >> 1;
    return ha ? na : hb ? nbv : 0;
  }

  int nc_chroma(int addr, int c, int k) const {
    int bx = k & 1, by = k >> 1, base = 4 * c, na = 0, nbv = 0;
    bool ha, hb;
    if (bx) {
      ha = true;
      na = tcc[size_t(addr) * 8 + base + k - 1];
    } else {
      int a = nb(addr, -1, 0);
      ha = a >= 0;
      if (ha) na = tcc[size_t(a) * 8 + base + k + 1];
    }
    if (by) {
      hb = true;
      nbv = tcc[size_t(addr) * 8 + base + k - 2];
    } else {
      int b = nb(addr, 0, -1);
      hb = b >= 0;
      if (hb) nbv = tcc[size_t(b) * 8 + base + k + 2];
    }
    if (ha && hb) return (na + nbv + 1) >> 1;
    return ha ? na : hb ? nbv : 0;
  }

  Part part(int addr, int xn, int yn, const bool* done) const {
    if (yn > 15 || (xn > 15 && yn >= 0)) return {false, -1, 0, 0};
    if (xn >= 0 && xn <= 15 && yn >= 0) {
      int b = (yn >> 2) * 4 + (xn >> 2);
      if (!done[b]) return {false, -1, 0, 0};
      size_t i = size_t(addr) * 16 + b;
      return {true, ref[i], mv[2 * i], mv[2 * i + 1]};
    }
    int dx = xn < 0 ? -1 : (xn > 15 ? 1 : 0), dy = yn < 0 ? -1 : 0;
    int n = nb(addr, dx, dy);
    if (n < 0) return {false, -1, 0, 0};
    int b = ((yn & 15) >> 2) * 4 + ((xn & 15) >> 2);
    if (kind[n] >= H_I4) return {true, -1, 0, 0};
    size_t i = size_t(n) * 16 + b;
    return {true, ref[i], mv[2 * i], mv[2 * i + 1]};
  }

  static int median(int a, int b, int c) {
    int lo = a < b ? a : b, hi = a < b ? b : a;
    return c < lo ? lo : (c > hi ? hi : c);
  }

  void mvp(int addr, int x, int y, int pw, int shape, int refi,
           const bool* done, int* out) const {
    Part a = part(addr, x - 1, y, done), b = part(addr, x, y - 1, done);
    Part c = part(addr, x + pw, y - 1, done);
    if (!c.avail) c = part(addr, x - 1, y - 1, done);
    if (shape == 1) {
      if (y == 0 && b.ref == refi) { out[0] = b.mx; out[1] = b.my; return; }
      if (y == 8 && a.ref == refi) { out[0] = a.mx; out[1] = a.my; return; }
    } else if (shape == 2) {
      if (x == 0 && a.ref == refi) { out[0] = a.mx; out[1] = a.my; return; }
      if (x == 8 && c.ref == refi) { out[0] = c.mx; out[1] = c.my; return; }
    }
    if (!b.avail && !c.avail && a.avail) b = c = a;
    int same = (a.ref == refi) + (b.ref == refi) + (c.ref == refi);
    if (same == 1) {
      const Part& p = a.ref == refi ? a : (b.ref == refi ? b : c);
      out[0] = p.mx;
      out[1] = p.my;
      return;
    }
    out[0] = median(a.mx, b.mx, c.mx);
    out[1] = median(a.my, b.my, c.my);
  }

  void set_part(int addr, int x, int y, int pw, int ph, int refi,
                const int* v, bool* done) {
    for (int by = y >> 2; by < (y + ph) >> 2; by++)
      for (int bx = x >> 2; bx < (x + pw) >> 2; bx++) {
        int b = by * 4 + bx;
        size_t i = size_t(addr) * 16 + b;
        ref[i] = refi;
        mv[2 * i] = v[0];
        mv[2 * i + 1] = v[1];
        done[b] = true;
      }
  }

  void common(int addr, int k, int qp) {
    kind[addr] = k;
    slice_of[addr] = cur_slice;
    int32_t* row = &mb[size_t(addr) * MB_FIELDS];
    row[F_KIND] = k;
    row[F_QP] = qp;
    row[F_QPC] = int32_t(sl[S_QPC]);
    row[F_SLICE] = cur_slice;
    row[F_FILTER] = int32_t(sl[S_FILTER]);
    row[F_ALPHA] = int32_t(sl[S_ALPHA]);
    row[F_BETA] = int32_t(sl[S_BETA]);
    row[F_CIP] = int32_t(sl[S_CIP]);
  }

  int slot_of(int refi) const {
    int s = refi < 32 ? int(sl[S_REFS + refi]) : -1;
    if (s < 0) throw ParseError("ref_idx names no reference picture");
    return s;
  }

  void store_blocks(int addr) {
    for (int b = 0; b < 16; b++) {
      size_t i = size_t(addr) * 16 + b;
      int32_t* r = &blk[i * BLK_FIELDS];
      r[0] = mv[2 * i];
      r[1] = mv[2 * i + 1];
      r[2] = ref[i] < 0 ? -1 : slot_of(ref[i]);
      r[3] = tc[i];
    }
  }

  void skip(int addr, int qp) {
    slice_of[addr] = cur_slice;
    kind[addr] = H_SKIP;
    bool done[16] = {};
    Part a = part(addr, -1, 0, done), b = part(addr, 0, -1, done);
    int v[2] = {0, 0};
    if (a.avail && b.avail && !(a.ref == 0 && a.mx == 0 && a.my == 0) &&
        !(b.ref == 0 && b.mx == 0 && b.my == 0))
      mvp(addr, 0, 0, 16, 0, 0, done, v);
    set_part(addr, 0, 0, 16, 16, 0, v, done);
    common(addr, H_SKIP, qp);
    for (int i = 0; i < 16; i++) tc[size_t(addr) * 16 + i] = 0;
    for (int i = 0; i < 8; i++) tcc[size_t(addr) * 8 + i] = 0;
    store_blocks(addr);
  }

  // residual_block_cavlc: TotalCoeff; levels in scan order into coeff
  int residual_block(Bits& r, int nc, int max_coeff, int* coeff) {
    for (int i = 0; i < max_coeff; i++) coeff[i] = 0;
    int sym = r.vlc(g_vlc[nc < 0 ? 4 : nc < 2 ? 0 : nc < 4 ? 1 : nc < 8 ? 2
                                                                        : 3]);
    int tcn = sym >> 2, t1 = sym & 3;
    if (tcn == 0) return 0;
    if (tcn > max_coeff) throw ParseError("too many coefficients");
    int levels[16];
    int suffix = (tcn > 10 && t1 < 3) ? 1 : 0;
    for (int i = 0; i < tcn; i++) {
      if (i < t1) {
        levels[i] = r.read(1) ? -1 : 1;
        continue;
      }
      uint32_t v = r.peek(32);
      int prefix = v ? __builtin_clz(v) : 32;
      if (prefix > 31) throw ParseError("level_prefix too long");
      r.pos += prefix + 1;
      int code = (prefix < 15 ? prefix : 15) << suffix;
      if (suffix > 0 || prefix >= 14) {
        int size = (prefix == 14 && suffix == 0) ? 4
                   : (prefix >= 15 ? prefix - 3 : suffix);
        if (size) code += int(r.read(size));
      }
      if (prefix >= 15 && suffix == 0) code += 15;
      if (prefix >= 16) code += (1 << (prefix - 3)) - 4096;
      if (i == t1 && t1 < 3) code += 2;
      int lv = (code % 2 == 0) ? (code + 2) >> 1 : (-code - 1) >> 1;
      levels[i] = lv;
      if (suffix == 0) suffix = 1;
      if ((lv < 0 ? -lv : lv) > (3 << (suffix - 1)) && suffix < 6) suffix++;
    }
    int zeros = 0;
    if (tcn < max_coeff)
      zeros = r.vlc(g_vlc[nc < 0 ? 20 + tcn - 1 : 5 + tcn - 1]);
    int pos = tcn + zeros - 1;
    if (pos >= max_coeff) throw ParseError("total_zeros beyond the block");
    for (int i = 0; i < tcn; i++) {
      coeff[pos] = levels[i];
      int step = 0;
      if (i < tcn - 1 && zeros > 0) {
        step = r.vlc(g_vlc[23 + (zeros < 7 ? zeros : 7) - 1]);
        zeros -= step;
      }
      pos -= step + 1;
    }
    if (pos < -1) throw ParseError("run_before beyond the block");
    return tcn;
  }

  static void unzig(const int* levels, int n, int start, int* out) {
    for (int i = 0; i < 16; i++) out[i] = 0;
    for (int i = 0; i < n; i++) out[ZIGZAG4[i + start]] = levels[i];
  }

  int pred_mode(int addr, int raster, const int* md, int cip) const {
    int got[2];
    const int d[2][2] = {{-1, 0}, {0, -1}};
    for (int k = 0; k < 2; k++) {
      int bx = (raster & 3) + d[k][0], by = (raster >> 2) + d[k][1];
      if (bx >= 0 && by >= 0) {
        got[k] = md[by * 4 + bx];
        continue;
      }
      int n = nb(addr, bx < 0 ? d[k][0] : 0, by < 0 ? d[k][1] : 0);
      if (n < 0 || (cip && kind[n] <= H_INTER)) return 2;
      got[k] = kind[n] == H_I4 ? modes[size_t(n) * 16 + (by & 3) * 4 + (bx & 3)]
                               : 2;
    }
    return got[0] < got[1] ? got[0] : got[1];
  }

  int residual(Bits& r, int addr, int qp, int cbp, int k) {
    int luma = cbp & 15, chroma = cbp >> 4;
    if (luma || chroma || k == H_I16) {
      int delta = r.se();
      if (delta < -26 || delta > 25) throw ParseError("mb_qp_delta");
      qp = (qp + delta + 52) % 52;
    }
    common(addr, k, qp);
    int* t = &tc[size_t(addr) * 16];
    int* tcc_ = &tcc[size_t(addr) * 8];
    for (int i = 0; i < 16; i++) t[i] = 0;
    for (int i = 0; i < 8; i++) tcc_[i] = 0;
    int lv[16], raster[16];
    if (k == H_I16) {
      residual_block(r, nc_luma(addr, 0), 16, lv);
      unzig(lv, 16, 0, raster);
      store_coef(addr, 16, raster);
    }
    for (int i = 0; i < 16; i++) {
      int rs = BLK_RASTER[i];
      if (!((luma >> (i >> 2)) & 1)) continue;
      int nc = nc_luma(addr, rs);
      int n;
      if (k == H_I16) {
        n = residual_block(r, nc, 15, lv);
        unzig(lv, 15, 1, raster);
      } else {
        n = residual_block(r, nc, 16, lv);
        unzig(lv, 16, 0, raster);
      }
      t[rs] = n;
      store_coef(addr, rs, raster);
    }
    if (chroma) {
      for (int c = 0; c < 2; c++) {
        residual_block(r, -1, 4, lv);
        int dc[16] = {lv[0], lv[1], lv[2], lv[3]};
        store_coef(addr, 17 + c, dc);
      }
    }
    if (chroma == 2) {
      for (int c = 0; c < 2; c++)
        for (int j = 0; j < 4; j++) {
          int n = residual_block(r, nc_chroma(addr, c, j), 15, lv);
          tcc_[4 * c + j] = n;
          unzig(lv, 15, 1, raster);
          store_coef(addr, 19 + 4 * c + j, raster);
        }
    }
    store_blocks(addr);
    return qp;
  }

  int inter(Bits& r, int addr, int qp, int mb_type) {
    slice_of[addr] = cur_slice;
    kind[addr] = H_INTER;
    bool done[16] = {};
    int n_ref = int(sl[S_NUM_REF]);
    int v[2], p[2];
    if (mb_type < 3) {
      int count = mb_type == 0 ? 1 : 2;
      int pw = mb_type == 2 ? 8 : 16, ph = mb_type == 1 ? 8 : 16;
      int refs[2] = {0, 0};
      for (int k = 0; k < count; k++) refs[k] = n_ref > 1 ? r.te(n_ref - 1) : 0;
      for (int k = 0; k < count; k++) {
        int x = mb_type == 2 ? 8 * k : 0, y = mb_type == 1 ? 8 * k : 0;
        if (refs[k] >= n_ref) throw ParseError("ref_idx");
        mvp(addr, x, y, pw, mb_type, refs[k], done, p);
        v[0] = p[0] + r.se();
        v[1] = p[1] + r.se();
        set_part(addr, x, y, pw, ph, refs[k], v, done);
      }
    } else {
      int subs[4], refs[4];
      for (int k = 0; k < 4; k++) {
        subs[k] = r.ue();
        if (subs[k] > 3) throw ParseError("sub_mb_type");
      }
      for (int k = 0; k < 4; k++)
        refs[k] = (n_ref > 1 && mb_type == 3) ? r.te(n_ref - 1) : 0;
      for (int k = 0; k < 4; k++) {
        if (refs[k] >= n_ref) throw ParseError("ref_idx");
        int x0 = 8 * (k & 1), y0 = 8 * (k >> 1);
        int s = subs[k];
        int count = s == 0 ? 1 : (s == 3 ? 4 : 2);
        int pw = (s == 0 || s == 1) ? 8 : 4, ph = (s == 0 || s == 2) ? 8 : 4;
        for (int j = 0; j < count; j++) {
          int x = x0 + (s == 2 ? 4 * j : s == 3 ? 4 * (j & 1) : 0);
          int y = y0 + (s == 1 ? 4 * j : s == 3 ? 4 * (j >> 1) : 0);
          mvp(addr, x, y, pw, 0, refs[k], done, p);
          v[0] = p[0] + r.se();
          v[1] = p[1] + r.se();
          set_part(addr, x, y, pw, ph, refs[k], v, done);
        }
      }
    }
    int code = r.ue();
    if (code > 47) throw ParseError("coded_block_pattern");
    return residual(r, addr, qp, g_cbp[1][code], H_INTER);
  }

  int macroblock(Bits& r, int addr, int qp) {
    int mb_type = r.ue();
    if (sl[S_KIND] == SLICE_P) {
      if (mb_type < 5) return inter(r, addr, qp, mb_type);
      mb_type -= 5;
    }
    if (mb_type > 25) throw ParseError("mb_type");
    for (int b = 0; b < 16; b++) {
      size_t i = size_t(addr) * 16 + b;
      ref[i] = -1;
      mv[2 * i] = mv[2 * i + 1] = 0;
    }
    if (mb_type == 25) {  // I_PCM
      r.pos = (r.pos + 7) & ~int64_t(7);
      mb[size_t(addr) * MB_FIELDS + F_PCM] = int32_t(pcm.size() / 384);
      const uint8_t* s = r.d + (r.pos >> 3);
      pcm.insert(pcm.end(), s, s + 384);
      r.pos += 384 * 8;
      common(addr, H_PCM, qp);
      for (int i = 0; i < 16; i++) tc[size_t(addr) * 16 + i] = 16;
      for (int i = 0; i < 8; i++) tcc[size_t(addr) * 8 + i] = 16;
      store_blocks(addr);
      return qp;
    }
    bool i16 = mb_type > 0;
    int k = i16 ? H_I16 : H_I4;
    kind[addr] = k;
    slice_of[addr] = cur_slice;
    int32_t* row = &mb[size_t(addr) * MB_FIELDS];
    int t = mb_type - 1;
    if (!i16) {
      int* md = &modes[size_t(addr) * 16];
      int cip = int(sl[S_CIP]);
      for (int j = 0; j < 16; j++) {
        int rs = BLK_RASTER[j];
        int pred = pred_mode(addr, rs, md, cip);
        int mode;
        if (r.read(1)) {
          mode = pred;
        } else {
          int rem = int(r.read(3));
          mode = rem < pred ? rem : rem + 1;
        }
        md[rs] = mode;
      }
      uint32_t lo = 0, hi = 0;
      for (int b = 0; b < 8; b++) {
        lo |= uint32_t(md[b]) << (4 * b);
        hi |= uint32_t(md[8 + b]) << (4 * b);
      }
      row[F_MODES] = int32_t(lo);
      row[F_MODES_HI] = int32_t(hi);
    } else {
      row[F_I16] = t % 4;
    }
    int cmode = r.ue();
    if (cmode > 3) throw ParseError("intra_chroma_pred_mode");
    row[F_CMODE] = cmode;
    int cbp;
    if (i16) {
      cbp = (((t / 4) % 3) << 4) | (t >= 12 ? 15 : 0);
    } else {
      int code = r.ue();
      if (code > 47) throw ParseError("coded_block_pattern");
      cbp = g_cbp[0][code];
    }
    return residual(r, addr, qp, cbp, k);
  }

  int parse_slice(int number) {
    const uint8_t* rb = data + sl[S_OFFSET];
    int64_t size = sl[S_SIZE];
    int64_t end = size;
    while (end && rb[end - 1] == 0) end--;
    int64_t trail = 0;
    if (end) {
      uint8_t last = rb[end - 1];
      trail = end * 8 - 1 - __builtin_ctz(last);
    }
    Bits r{rb, sl[S_DATA_BIT], trail};
    cur_slice = number;
    int addr = int(sl[S_FIRST_MB]);
    int qp = int(sl[S_QP]);
    bool more = true;
    while (more) {
      if (addr >= m) throw ParseError("slice data beyond the picture");
      if (sl[S_KIND] == SLICE_P) {
        int run = r.ue();
        if (addr + run > m) throw ParseError("mb_skip_run beyond the picture");
        for (int i = 0; i < run; i++) skip(addr++, qp);
        if (run) {
          more = r.more();
          if (!more) break;
          if (addr >= m) throw ParseError("slice data beyond the picture");
        }
      }
      qp = macroblock(r, addr, qp);
      addr++;
      more = r.more();
    }
    if (r.pos > r.trail) throw ParseError("slice data overruns its NAL unit");
    return addr;
  }
};

struct Batch {
  std::vector<Picture> pics;
  std::string error;
};

}  // namespace

extern "C" {

int h264_set_vlc(int which, int n, const int32_t* lens, const int32_t* codes) {
  if (which < 0 || which >= 30) return 1;
  g_vlc[which].build(n, lens, codes);
  return 0;
}

int h264_set_cbp(const int32_t* intra, const int32_t* inter) {
  for (int i = 0; i < 48; i++) {
    g_cbp[0][i] = intra[i];
    g_cbp[1][i] = inter[i];
  }
  return 0;
}

// Parses F pictures (the slices of picture f are first[f]..first[f+1]-1 of
// `slices`, SLICE_FIELDS int64 each, their RBSPs in `data`, padded) on
// `threads` host threads. counts: coded blocks, I_PCM macroblocks.
void* h264_parse(const uint8_t* data, const int64_t* slices,
                 const int32_t* first, int n_pics, int mb_width,
                 int mb_height, int threads, int64_t* counts) {
  Batch* b = new Batch();
  b->pics.resize(n_pics);
  std::atomic<int> next(0);
  auto work = [&]() {
    for (int f = next++; f < n_pics; f = next++) {
      Picture& p = b->pics[f];
      try {
        p.init(mb_width, mb_height);
        p.data = data;
        int end = 0;
        for (int s = first[f]; s < first[f + 1]; s++) {
          p.sl = slices + int64_t(s) * SLICE_FIELDS;
          if (p.sl[S_FIRST_MB] != end)
            throw ParseError("slices do not tile the picture (arbitrary "
                             "slice order)");
          end = p.parse_slice(s - first[f]);
        }
        if (end != p.m) throw ParseError("the slices do not cover the picture");
      } catch (const std::exception& e) {
        p.error = "picture " + std::to_string(f) + ": " + e.what();
      }
    }
  };
  int n = threads < 1 ? 1 : threads;
  if (n > n_pics) n = n_pics < 1 ? 1 : n_pics;
  std::vector<std::thread> pool;
  for (int i = 1; i < n; i++) pool.emplace_back(work);
  work();
  for (auto& t : pool) t.join();
  int64_t nb = 0, np = 0;
  for (auto& p : b->pics) {
    if (!p.error.empty() && b->error.empty()) b->error = p.error;
    nb += int64_t(p.coef.size() / 16);
    np += int64_t(p.pcm.size() / 384);
  }
  counts[0] = nb;
  counts[1] = np;
  return b;
}

const char* h264_error(void* handle) {
  Batch* b = static_cast<Batch*>(handle);
  return b->error.empty() ? nullptr : b->error.c_str();
}

// the records of the batch, pictures after one another, coef and I_PCM
// rows numbered across the batch
int h264_parse_fetch(void* handle, int32_t* mb, int32_t* blk, int32_t* bmap,
                     int16_t* coef, uint8_t* pcm) {
  Batch* b = static_cast<Batch*>(handle);
  int64_t nc = 0, np = 0;
  for (auto& p : b->pics) {
    size_t m = size_t(p.m);
    for (size_t i = 0; i < m; i++) {
      int32_t* row = mb + i * MB_FIELDS;
      std::memcpy(row, &p.mb[i * MB_FIELDS], MB_FIELDS * 4);
      if (row[F_PCM] >= 0) row[F_PCM] += int32_t(np);
    }
    std::memcpy(blk, p.blk.data(), m * 16 * BLK_FIELDS * 4);
    for (size_t i = 0; i < m * NBLK; i++)
      bmap[i] = p.bmap[i] >= 0 ? p.bmap[i] + int32_t(nc) : -1;
    std::memcpy(coef + nc * 16, p.coef.data(), p.coef.size() * 2);
    std::memcpy(pcm + np * 384, p.pcm.data(), p.pcm.size());
    nc += int64_t(p.coef.size() / 16);
    np += int64_t(p.pcm.size() / 384);
    mb += m * MB_FIELDS;
    blk += m * 16 * BLK_FIELDS;
    bmap += m * NBLK;
  }
  return 0;
}

void h264_free(void* handle) { delete static_cast<Batch*>(handle); }

}  // extern "C"

#ifdef __CUDACC__
// ---------------------------------------------------------------------------
// the device stages
// ---------------------------------------------------------------------------

namespace {

__constant__ int c_taps[9 * 16 * 8];  // ops/h264_cuda.INTRA4_TAPS
__constant__ int c_alpha[52], c_beta[52], c_tc0[52 * 3];
__constant__ int c_scale[6 * 16];     // normAdjust4x4 by qP % 6
__constant__ int c_cqp[52];           // Table 8-15

__device__ __forceinline__ int clip1(int x) { return min(max(x, 0), 255); }

__device__ __forceinline__ int ld(const uint8_t* p) {
  return int(__ldcg(p));
}

// H1: one thread a 4x4 block (16 luma, 8 chroma a macroblock)
__global__ void residual_kernel(const int16_t* __restrict__ coef,
                                const int32_t* __restrict__ bmap,
                                const int32_t* __restrict__ mb, int n_mb,
                                int mbw, int mbh, int16_t* __restrict__ ry,
                                int16_t* __restrict__ rc) {
  int64_t gid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (gid >= int64_t(n_mb) * 24) return;
  int fm = int(gid / 24), b = int(gid % 24);
  int m_per = mbw * mbh;
  int f = fm / m_per, m = fm % m_per;
  int mx = m % mbw, my = m / mbw;
  const int32_t* row = mb + int64_t(fm) * MB_FIELDS;
  const int32_t* map = bmap + int64_t(fm) * NBLK;
  int kind = row[F_KIND];
  bool active = kind != H_SKIP && kind != H_PCM;
  int d[16];
  const int H4[4][4] = {{1, 1, 1, 1}, {1, 1, -1, -1}, {1, -1, -1, 1},
                        {1, -1, 1, -1}};
  if (b < 16) {
    int qp = row[F_QP], q6 = qp / 6, qm = qp % 6;
    int k = map[b];
    for (int i = 0; i < 16; i++)
      d[i] = k >= 0 ? (int(coef[int64_t(k) * 16 + i]) * c_scale[qm * 16 + i])
                          << q6
                    : 0;
    if (kind == H_I16) {
      int kd = map[16];
      int bx = b & 3, by = b >> 2, f_ = 0;
      if (kd >= 0) {
        const int16_t* c = coef + int64_t(kd) * 16;
        for (int i = 0; i < 4; i++) {
          int s = 0;
          for (int j = 0; j < 4; j++) s += int(c[i * 4 + j]) * H4[j][bx];
          f_ += H4[by][i] * s;
        }
      }
      int v0 = 16 * c_scale[qm * 16];
      d[0] = q6 >= 6 ? (f_ * v0) << (q6 - 6)
                     : (f_ * v0 + (1 << (5 - q6))) >> (6 - q6);
    }
  } else {
    int cb = b - 16, comp = cb >> 2, j = cb & 3;
    int qpc = c_cqp[min(max(row[F_QP] + row[F_QPC], 0), 51)];
    int q6 = qpc / 6, qm = qpc % 6;
    int k = map[19 + 4 * comp + j];
    for (int i = 0; i < 16; i++)
      d[i] = k >= 0 ? (int(coef[int64_t(k) * 16 + i]) * c_scale[qm * 16 + i])
                          << q6
                    : 0;
    int kd = map[17 + comp], f_ = 0;
    if (kd >= 0) {
      const int16_t* c = coef + int64_t(kd) * 16;
      int jx = j & 1, jy = j >> 1;
      // f = [[1,1],[1,-1]] c [[1,1],[1,-1]]
      for (int i = 0; i < 2; i++) {
        int s = 0;
        for (int l = 0; l < 2; l++)
          s += int(c[i * 2 + l]) * ((l == 1 && jx == 1) ? -1 : 1);
        f_ += ((i == 1 && jy == 1) ? -1 : 1) * s;
      }
    }
    d[0] = ((f_ * 16 * c_scale[qm * 16]) << q6) >> 5;
  }
  // 8.5.12.2: rows, then columns
  int t[16];
  for (int i = 0; i < 4; i++) {
    int x0 = d[i * 4], x1 = d[i * 4 + 1], x2 = d[i * 4 + 2], x3 = d[i * 4 + 3];
    int e = x0 + x2, f1 = x0 - x2, g = (x1 >> 1) - x3, h = x1 + (x3 >> 1);
    t[i * 4] = e + h;
    t[i * 4 + 1] = f1 + g;
    t[i * 4 + 2] = f1 - g;
    t[i * 4 + 3] = e - h;
  }
  int r[16];
  for (int j = 0; j < 4; j++) {
    int x0 = t[j], x1 = t[4 + j], x2 = t[8 + j], x3 = t[12 + j];
    int e = x0 + x2, f1 = x0 - x2, g = (x1 >> 1) - x3, h = x1 + (x3 >> 1);
    r[j] = e + h;
    r[4 + j] = f1 + g;
    r[8 + j] = f1 - g;
    r[12 + j] = e - h;
  }
  if (b < 16) {
    int w = 16 * mbw;
    int64_t base = int64_t(f) * (16 * mbh) * w +
                   int64_t(16 * my + 4 * (b >> 2)) * w + 16 * mx + 4 * (b & 3);
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 4; j++)
        ry[base + int64_t(i) * w + j] =
            int16_t(active ? (r[i * 4 + j] + 32) >> 6 : 0);
  } else {
    int cb = b - 16, comp = cb >> 2, j = cb & 3;
    int w = 8 * mbw, h = 8 * mbh;
    int64_t base = (int64_t(f) * 2 + comp) * h * w +
                   int64_t(8 * my + 4 * (j >> 1)) * w + 8 * mx + 4 * (j & 1);
    for (int i = 0; i < 4; i++)
      for (int k = 0; k < 4; k++)
        rc[base + int64_t(i) * w + k] =
            int16_t(active ? (r[i * 4 + k] + 32) >> 6 : 0);
  }
}

__device__ __forceinline__ int tap6(int a, int b, int c, int d, int e,
                                    int f) {
  return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
}

// H2: a thread block a macroblock; 256 threads, a luma sample each, then
// 128 chroma samples
__global__ void inter_kernel(uint8_t* __restrict__ yp,
                             uint8_t* __restrict__ up,
                             uint8_t* __restrict__ vp, int h, int w, int out,
                             const int32_t* __restrict__ mb,
                             const int32_t* __restrict__ blk, int mbw,
                             const int16_t* __restrict__ ry,
                             const int16_t* __restrict__ rc) {
  int m = blockIdx.x;
  int kind = mb[int64_t(m) * MB_FIELDS + F_KIND];
  if (kind > H_INTER) return;
  int mx = m % mbw, my = m / mbw;
  int t = threadIdx.x;
  int64_t plane = int64_t(h) * w;
  {
    int xx = t & 15, yy = t >> 4;
    int b = (yy >> 2) * 4 + (xx >> 2);
    const int32_t* rec = blk + (int64_t(m) * 16 + b) * BLK_FIELDS;
    int mvx = rec[0], mvy = rec[1], slot = rec[2];
    int X = 16 * mx + xx, Y = 16 * my + yy;
    int xi = X + (mvx >> 2), yi = Y + (mvy >> 2);
    const uint8_t* ref = yp + int64_t(slot) * plane;
    int win[6][6];
    for (int i = 0; i < 6; i++) {
      int yy2 = min(max(yi - 2 + i, 0), h - 1);
      for (int j = 0; j < 6; j++) {
        int xx2 = min(max(xi - 2 + j, 0), w - 1);
        win[i][j] = ref[int64_t(yy2) * w + xx2];
      }
    }
    int G = win[2][2], Hs = win[2][3], Ms = win[3][2];
    int b1 = tap6(win[2][0], win[2][1], win[2][2], win[2][3], win[2][4],
                  win[2][5]);
    int h1 = tap6(win[0][2], win[1][2], win[2][2], win[3][2], win[4][2],
                  win[5][2]);
    int m1 = tap6(win[0][3], win[1][3], win[2][3], win[3][3], win[4][3],
                  win[5][3]);
    int s1 = tap6(win[3][0], win[3][1], win[3][2], win[3][3], win[3][4],
                  win[3][5]);
    int rows[6];
    for (int i = 0; i < 6; i++)
      rows[i] = tap6(win[i][0], win[i][1], win[i][2], win[i][3], win[i][4],
                     win[i][5]);
    int j1 = tap6(rows[0], rows[1], rows[2], rows[3], rows[4], rows[5]);
    int bb = clip1((b1 + 16) >> 5), hh = clip1((h1 + 16) >> 5);
    int mm = clip1((m1 + 16) >> 5), ss = clip1((s1 + 16) >> 5);
    int jj = clip1((j1 + 512) >> 10);
    int pred;
    switch ((mvx & 3) * 4 + (mvy & 3)) {
      case 0: pred = G; break;
      case 1: pred = (G + hh + 1) >> 1; break;
      case 2: pred = hh; break;
      case 3: pred = (Ms + hh + 1) >> 1; break;
      case 4: pred = (G + bb + 1) >> 1; break;
      case 5: pred = (bb + hh + 1) >> 1; break;
      case 6: pred = (hh + jj + 1) >> 1; break;
      case 7: pred = (hh + ss + 1) >> 1; break;
      case 8: pred = bb; break;
      case 9: pred = (bb + jj + 1) >> 1; break;
      case 10: pred = jj; break;
      case 11: pred = (jj + ss + 1) >> 1; break;
      case 12: pred = (Hs + bb + 1) >> 1; break;
      case 13: pred = (bb + mm + 1) >> 1; break;
      case 14: pred = (jj + mm + 1) >> 1; break;
      default: pred = (mm + ss + 1) >> 1; break;
    }
    int64_t at = int64_t(Y) * w + X;
    yp[int64_t(out) * plane + at] = uint8_t(clip1(pred + ry[at]));
  }
  if (t < 128) {
    int comp = t >> 6, k = t & 63, cx = k & 7, cy = k >> 3;
    int b = (cy >> 1) * 4 + (cx >> 1);
    const int32_t* rec = blk + (int64_t(m) * 16 + b) * BLK_FIELDS;
    int mvx = rec[0], mvy = rec[1], slot = rec[2];
    int hc = h >> 1, wc = w >> 1;
    int X = 8 * mx + cx, Y = 8 * my + cy;
    int xi = X + (mvx >> 3), yi = Y + (mvy >> 3), fx = mvx & 7, fy = mvy & 7;
    uint8_t* pl = comp ? vp : up;
    const uint8_t* ref = pl + int64_t(slot) * hc * wc;
    int x0 = min(max(xi, 0), wc - 1), x1 = min(max(xi + 1, 0), wc - 1);
    int y0 = min(max(yi, 0), hc - 1), y1 = min(max(yi + 1, 0), hc - 1);
    int A = ref[int64_t(y0) * wc + x0], B = ref[int64_t(y0) * wc + x1];
    int C = ref[int64_t(y1) * wc + x0], D = ref[int64_t(y1) * wc + x1];
    int pred = ((8 - fx) * (8 - fy) * A + fx * (8 - fy) * B +
                (8 - fx) * fy * C + fx * fy * D + 32) >> 6;
    int64_t at = int64_t(Y) * wc + X;
    pl[int64_t(out) * hc * wc + at] =
        uint8_t(clip1(pred + rc[int64_t(comp) * hc * wc + at]));
  }
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

int status(cudaError_t e) { return e == cudaSuccess ? 0 : 1000 + int(e); }

}  // namespace

extern "C" {

int h264_set_constants(const int32_t* taps, const int32_t* alpha,
                       const int32_t* beta, const int32_t* tc0,
                       const int32_t* scale, const int32_t* cqp) {
  cudaError_t e = cudaMemcpyToSymbol(c_taps, taps, sizeof(int) * 9 * 16 * 8);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_alpha, alpha, sizeof(int) * 52);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_beta, beta, sizeof(int) * 52);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_tc0, tc0, sizeof(int) * 156);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_scale, scale, sizeof(int) * 96);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_cqp, cqp, sizeof(int) * 52);
  return status(e);
}

int h264_residual(const int16_t* coef, const int32_t* bmap, const int32_t* mb,
                  int n_pics, int mbw, int mbh, int16_t* ry, int16_t* rc,
                  cudaStream_t stream) {
  int64_t n = int64_t(n_pics) * mbw * mbh * 24;
  int threads = 192;
  residual_kernel<<<unsigned((n + threads - 1) / threads), threads, 0,
                    stream>>>(coef, bmap, mb, n_pics * mbw * mbh, mbw, mbh,
                              ry, rc);
  return status(cudaGetLastError());
}

int h264_inter_predict(uint8_t* y, uint8_t* u, uint8_t* v, int h, int w,
                       int out, const int32_t* mb, const int32_t* blk,
                       int mbw, const int16_t* ry, const int16_t* rc,
                       cudaStream_t stream) {
  int m = mbw * (h / 16);
  inter_kernel<<<m, 256, 0, stream>>>(y, u, v, h, w, out, mb, blk, mbw, ry,
                                      rc);
  return status(cudaGetLastError());
}

// `sync` holds 1 + h / 16 ints of device scratch (ticket, then progress)
int h264_intra_reconstruct(uint8_t* y, uint8_t* u, uint8_t* v, int h, int w,
                           int out, const int32_t* mb, const uint8_t* pcm,
                           int mbw, const int16_t* ry, const int16_t* rc,
                           int* sync, cudaStream_t stream) {
  int rows = h / 16;
  cudaError_t e = cudaMemsetAsync(sync, 0, sizeof(int) * (1 + rows), stream);
  if (e != cudaSuccess) return status(e);
  intra_kernel<<<rows, WAVE_THREADS, 0, stream>>>(y, u, v, h, w, out, mb, pcm,
                                                  mbw, ry, rc, sync, sync + 1);
  return status(cudaGetLastError());
}

int h264_deblock(uint8_t* y, uint8_t* u, uint8_t* v, int h, int w, int out,
                 const int32_t* mb, const int32_t* blk, int mbw, int* sync,
                 cudaStream_t stream) {
  int rows = h / 16;
  cudaError_t e = cudaMemsetAsync(sync, 0, sizeof(int) * (1 + rows), stream);
  if (e != cudaSuccess) return status(e);
  deblock_kernel<<<rows, WAVE_THREADS, 0, stream>>>(y, u, v, h, w, out, mb,
                                                    blk, mbw, sync, sync + 1);
  return status(cudaGetLastError());
}

}  // extern "C"
#endif  // __CUDACC__
