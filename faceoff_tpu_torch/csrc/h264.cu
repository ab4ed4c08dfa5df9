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
//                              wavefront: a warp a macroblock row,
//                              WAVE_ROWS rows a thread block (blocks
//                              claim rows by ticket, so no block waits on
//                              one that has not started), macroblock
//                              (x, y) after the row above has finished
//                              x + 2; the macroblock built in shared
//                              memory, Intra4x4's blocks by sub-waves
//   H4 h264_deblock            the loop filter of one picture, the same
//                              wavefront, each lane filtering a line in
//                              registers
//
// H3 and H4 are bound by their dependent chains (Intra4x4's blocks, the
// edges of a line, a handoff where the chain crosses a row), not by
// bytes: see the notes above the kernels. Samples they read from other
// rows go through L2 (__ldcg). Records (see io/h264.py): mb
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
#include <cuda/atomic>
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

// the wavefronts H3 and H4 (8.3, 8.7): macroblock (x, y) after (x - 1, y)
// and (x + 1, y - 1), the order in which raster decoding gives each
// macroblock the neighbours it reads. A warp a macroblock row, ROWS rows
// a CUDA block; blocks claim their rows by ticket, so no block waits on
// one that has not started, whatever the residency. A row publishes its
// progress (how many of its first macroblocks are final) to the next row
// of its block through shared memory and to the first row of the next
// block through a counter in global memory: release stores, acquire
// polls by one lane, the value seen kept so that a later wait it covers
// costs nothing. Samples a warp reads from another row go through L2
// (__ldcg).
constexpr unsigned FULL = 0xffffffffu;
constexpr int WAVE_ROWS = 4;  // the port's rows a block (tools/h264_variants)
constexpr int kMaxChunks = 64;  // 32-macroblock chunks a row: 32768 px

template <int ROWS>
struct Wave {
  int* progress;  // global: a counter a row of the picture
  int* flag;      // shared: a counter a row of the block
  int y, r;       // the warp's row, and its place in the block
  int seen;       // the row above's progress as last read

  // until row y - 1 has finished `need` macroblocks
  __device__ void wait(int need) {
    if (y == 0 || seen >= need) return;
    int v = 0;
    if ((threadIdx.x & 31) == 0) {
      if (r > 0) {
        cuda::atomic_ref<int, cuda::thread_scope_block> f(flag[r - 1]);
        while ((v = f.load(cuda::memory_order_acquire)) < need) {
        }
      } else {
        cuda::atomic_ref<int, cuda::thread_scope_device> f(progress[y - 1]);
        while ((v = f.load(cuda::memory_order_acquire)) < need)
          __nanosleep(32);
      }
    }
    seen = __shfl_sync(FULL, v, 0);
    __syncwarp();
  }

  // the row's first `done` macroblocks final, their samples stored
  __device__ void publish(int done) const {
    if (r == ROWS - 1) __threadfence();
    else __threadfence_block();
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      if (r == ROWS - 1) {
        cuda::atomic_ref<int, cuda::thread_scope_device>(progress[y]).store(
            done, cuda::memory_order_release);
      } else {
        cuda::atomic_ref<int, cuda::thread_scope_block>(flag[r]).store(
            done, cuda::memory_order_release);
      }
    }
  }
};

// the rows of a block: thread 0 takes the next ticket
__device__ __forceinline__ int claim_rows(int* ticket, int* s_row, int rows) {
  if (threadIdx.x == 0) *s_row = atomicAdd(ticket, 1) * rows;
  __syncthreads();
  return *s_row + int(threadIdx.x >> 5);
}

// which of a row's macroblocks the kernel works on: `field` of each
// record (kind or filter flag) tested by `want`, a bit a macroblock,
// 32 a word of `masks`; loads of 8 chunks in flight at once
template <class F>
__device__ void row_masks(const int32_t* mb, int y, int mbw, int field,
                          F want, unsigned* masks) {
  const int lane = threadIdx.x & 31, nch = (mbw + 31) >> 5;
  for (int c0 = 0; c0 < nch; c0 += 8) {
    int v[8];
#pragma unroll
    for (int j = 0; j < 8; j++) {
      int x = 32 * (c0 + j) + lane;
      v[j] = x < mbw ? mb[int64_t(y * mbw + x) * MB_FIELDS + field] : -1;
    }
#pragma unroll
    for (int j = 0; j < 8; j++) {
      unsigned m = __ballot_sync(FULL, v[j] >= 0 && want(v[j]));
      if (lane == 0 && c0 + j < nch) masks[c0 + j] = m;
    }
  }
  __syncwarp();
}

// the first macroblock from `from` on that the row works on, else mbw
__device__ __forceinline__ int next_work(const unsigned* masks, int from,
                                         int mbw) {
  const int nch = (mbw + 31) >> 5;
  for (int c = from >> 5; c < nch; c++) {
    unsigned m = masks[c];
    if (c == from >> 5) m &= ~0u << (from & 31);
    if (m) return 32 * c + __ffs(m) - 1;
  }
  return mbw;
}

__device__ int dc_pred(int st, int sl, bool top, bool left, int n_log2) {
  if (top && left) return (st + sl + (1 << n_log2)) >> (n_log2 + 1);
  if (left) return (sl + (1 << (n_log2 - 1))) >> n_log2;
  if (top) return (st + (1 << (n_log2 - 1))) >> n_log2;
  return 128;
}

// H3's macroblock in shared memory: luma rows -1..15 by columns -1..19
// (the row above, its top-right, the left column), chroma rows and
// columns -1..7 a component; 16-byte aligned rows
constexpr int TS = 48, TC = 16, CS = 16, CC = 8;
__device__ __forceinline__ int lt(int row, int col) {
  return (row + 1) * TS + TC + col;
}
__device__ __forceinline__ int ct(int row, int col) {
  return (row + 1) * CS + CC + col;
}
// the 4x4 blocks (raster) whose top-right samples inside the macroblock
// are decoded before them (6.4.11.4)
constexpr int kTrInside = 0x5750;

// H3's inputs for one macroblock, loaded a macroblock ahead: its record
// (lanes 0-15 a field each), the slice and kind of its left, top and
// top-right neighbours (lanes 16-21), its residual (16 bytes a lane, and
// chroma's on lanes 0-15) and, where the macroblock before it is not
// reconstructed here, its left column (lanes 0-15 luma, 16-31 chroma)
struct IntraIn {
  int rec;
  uint4 ry, rc;
  uint8_t left;
};

__device__ __forceinline__ IntraIn intra_in(const int32_t* mb, int mbw,
                                            int mbh, int x, int y,
                                            const int16_t* ry,
                                            const int16_t* rc, int w,
                                            const uint8_t* Y,
                                            const uint8_t* U,
                                            const uint8_t* V, bool left) {
  const int lane = threadIdx.x & 31, hc = 8 * mbh, wc = w >> 1;
  IntraIn in;
  const int32_t* row = mb + int64_t(y * mbw + x) * MB_FIELDS;
  if (lane < 16) {
    in.rec = row[lane];
  } else {
    // left, top, top-right: slice then kind
    const int k = lane - 16, n = k >> 1;
    const int dx = n == 0 ? -1 : n - 1, dy = n == 0 ? 0 : -1;
    const int nx = x + dx, ny = y + dy;
    in.rec = k < 6 && nx >= 0 && nx < mbw && ny >= 0
                 ? mb[int64_t(ny * mbw + nx) * MB_FIELDS +
                      (k & 1 ? F_KIND : F_SLICE)]
                 : -1;
  }
  in.ry = *reinterpret_cast<const uint4*>(
      ry + int64_t(16 * y + (lane >> 1)) * w + 16 * x + 8 * (lane & 1));
  in.rc = lane < 16 ? *reinterpret_cast<const uint4*>(
                          rc + int64_t(lane >> 3) * hc * wc +
                          int64_t(8 * y + (lane & 7)) * wc + 8 * x)
                    : make_uint4(0, 0, 0, 0);
  in.left = 0;
  if (left && x > 0) {
    in.left = lane < 16
                  ? __ldcg(Y + int64_t(16 * y + lane) * w + 16 * x - 1)
                  : __ldcg(((lane >> 3) & 1 ? V : U) +
                           int64_t(8 * y + (lane & 7)) * wc + 8 * x - 1);
  }
  return in;
}

// the samples above a macroblock, p[-1..15, -1] (lanes 0-16) and
// chroma's p[-1..7, -1] (lanes 0-17, component lane / 9), final once the
// row above has finished the macroblocks x - 1 and x
__device__ __forceinline__ uint32_t intra_top(const uint8_t* Y,
                                              const uint8_t* U,
                                              const uint8_t* V, int x, int y,
                                              int w) {
  const int lane = threadIdx.x & 31, wc = w >> 1;
  uint32_t v = 0;
  const int c = lane - 1;
  if (lane < 17 && 16 * x + c >= 0)
    v = __ldcg(Y + int64_t(16 * y - 1) * w + 16 * x + c);
  const int cc = lane >= 9, k = lane - 9 * cc - 1;
  if (lane < 18 && 8 * x + k >= 0)
    v |= uint32_t(__ldcg((cc ? V : U) + int64_t(8 * y - 1) * wc + 8 * x + k))
         << 8;
  return v;
}

// H3: a warp a macroblock row. From a ballot over the row's kinds it
// knows the intra and I_PCM macroblocks it reconstructs, and publishes
// its progress past the others in one store. A macroblock's record, its
// neighbours' slices and kinds, its residual and (after an inter
// macroblock) its left column are loaded while the one before it is
// reconstructed, and the samples above it just after that one is
// published. It is built in shared memory: the residual staged and each
// lane's taps resolved to tile offsets before the dependent steps;
// chroma (4 samples a lane); then Intra4x4 in its 10 sub-waves (the two
// blocks of a sub-wave on lanes 0-15 and 16-31, a sample a lane,
// __syncwarp between), or Intra16x16 (8 samples a lane). Only block
// (3, 0) reads the macroblock above and to the right, so the wait for
// that one comes after sub-wave 2. The macroblock goes out in 16- and
// 8-byte rows. What bounds it is its chain: Intra4x4's 10 steps, each a
// round of shared loads, the arithmetic and a store, and a handoff
// where the chain crosses a row.
template <int ROWS>
__global__ void __launch_bounds__(32 * ROWS)
    intra_kernel(uint8_t* __restrict__ yp, uint8_t* __restrict__ up,
                 uint8_t* __restrict__ vp, int h, int w, int out,
                 const int32_t* __restrict__ mb,
                 const uint8_t* __restrict__ pcm, int mbw,
                 const int16_t* __restrict__ ry,
                 const int16_t* __restrict__ rc, int* ticket,
                 int* progress) {
  __shared__ int s_taps[9 * 16];
  __shared__ int s_flag[ROWS], s_row;
  __shared__ unsigned s_work[ROWS][kMaxChunks];
  __shared__ __align__(16) uint8_t s_y[ROWS][17 * TS];
  __shared__ __align__(16) uint8_t s_c[ROWS][2][9 * CS];
  __shared__ __align__(16) int16_t s_ry[ROWS][256];
  __shared__ __align__(16) int16_t s_rc[ROWS][128];
  const int t = threadIdx.x, lane = t & 31, r = t >> 5;
  for (int i = t; i < 9 * 16; i += 32 * ROWS) {
    // indices i0-i2 into the 13 edge samples, weights w0-w2, rounding,
    // shift
    const int* tp = c_taps + i * 8;
    s_taps[i] = tp[0] | tp[1] << 4 | tp[2] << 8 | tp[3] << 12 |
                tp[4] << 14 | tp[5] << 16 | tp[6] << 18 | tp[7] << 20;
  }
  if (t < ROWS) s_flag[t] = 0;
  const int mbh = h / 16, y = claim_rows(ticket, &s_row, ROWS);
  if (y >= mbh) return;
  Wave<ROWS> wave{progress, s_flag, y, r, 0};
  const int hc = h >> 1, wc = w >> 1;
  uint8_t* const Y = yp + int64_t(out) * h * w;
  uint8_t* const U = up + int64_t(out) * hc * wc;
  uint8_t* const V = vp + int64_t(out) * hc * wc;
  uint8_t* const ty = s_y[r];
  unsigned* const work = s_work[r];
  const int cl = (lane >> 3) & 1, kl = lane & 7;  // lanes 16-31: chroma rows
  // this lane's sample in a 4x4 block, and its group's block at sub-wave s
  const int g = lane >> 4, px = lane & 3, py = (lane >> 2) & 3;
  row_masks(mb, y, mbw, F_KIND, [](int k) { return k >= H_I4; }, work);
  int x = next_work(work, 0, mbw), last = -2;
  if (x > 0) wave.publish(x);
  IntraIn in;
  if (x < mbw) in = intra_in(mb, mbw, mbh, x, y, ry, rc, w, Y, U, V, true);
  uint32_t top = 0;
  bool top_in = false;  // `top` holds the samples above x
  while (x < mbw) {
    const int nx = next_work(work, x + 1, mbw);
    const IntraIn cur = in;
    if (nx < mbw)
      in = intra_in(mb, mbw, mbh, nx, y, ry, rc, w, Y, U, V, nx > x + 1);
    const int kind = __shfl_sync(FULL, cur.rec, F_KIND);
    const int x0 = 16 * x, y0 = 16 * y;
    if (kind == H_PCM) {  // reads no neighbour
      const uint8_t* s =
          pcm + int64_t(__shfl_sync(FULL, cur.rec, F_PCM)) * 384;
      for (int i = 0; i < 8; i++) {
        int k = 8 * lane + i;
        ty[lt(k >> 4, k & 15)] = s[k];
      }
      for (int i = 0; i < 4; i++) {
        int k = 4 * lane + i, c = k >> 6;
        s_c[r][c][ct((k >> 3) & 7, k & 7)] = s[256 + k];
      }
      __syncwarp();
    } else {
      const int slice = __shfl_sync(FULL, cur.rec, F_SLICE);
      const int cip = __shfl_sync(FULL, cur.rec, F_CIP);
      const int mode16 = __shfl_sync(FULL, cur.rec, F_I16);
      const int cmode = __shfl_sync(FULL, cur.rec, F_CMODE);
      const uint32_t md0 = __shfl_sync(FULL, cur.rec, F_MODES);
      const uint32_t md1 = __shfl_sync(FULL, cur.rec, F_MODES_HI);
      bool av[3];  // A, B, C: in the picture and the slice, not inter
                   // under constrained_intra_pred
#pragma unroll
      for (int n = 0; n < 3; n++) {
        int ns = __shfl_sync(FULL, cur.rec, 16 + 2 * n);
        int nk = __shfl_sync(FULL, cur.rec, 17 + 2 * n);
        av[n] = nk >= 0 && ns == slice && !(cip && nk <= H_INTER);
      }
      const bool avA = av[0], avB = av[1], avC = av[2];
      reinterpret_cast<uint4*>(s_ry[r])[lane] = cur.ry;
      if (lane < 16) reinterpret_cast<uint4*>(s_rc[r])[lane] = cur.rc;
      // the left column: this warp's last macroblock's, or loaded ahead
      uint8_t left = cur.left;
      if (last == x - 1)
        left = lane < 16 ? ty[lt(lane, 15)] : s_c[r][cl][ct(kl, 7)];
      if (lane < 16) ty[lt(lane, -1)] = left;
      else s_c[r][cl][ct(kl, -1)] = left;
      if (y > 0) {
        if (!top_in) {
          wave.wait(x + 1);
          top = intra_top(Y, U, V, x, y, w);
        }
        if (lane < 17) ty[lt(-1, lane - 1)] = uint8_t(top);
        if (lane < 18) s_c[r][lane >= 9][ct(-1, lane % 9 - 1)] = uint8_t(top >> 8);
      }
      // the top-right, p[16..19, -1], now if it is final, else before
      // sub-wave 3
      const bool tr_late = kind == H_I4 && avC && wave.seen < x + 2;
      if (kind == H_I4 && avC && !tr_late && lane < 4)
        ty[lt(-1, 16 + lane)] = __ldcg(Y + int64_t(y0 - 1) * w + x0 + 16 + lane);
      __syncwarp();
      // chroma: lane l, component l >> 4, row (l >> 1) & 7, 4 samples
      {
        const int c = lane >> 4, yy = (lane >> 1) & 7, xx0 = 4 * (lane & 1);
        const uint8_t* T = s_c[r][c];
        int v = 0, pa = 0, pb = 0, pc = 0;
        if (cmode == 0) {
          int cbx = lane & 1, cby = yy >> 2, st = 0, sl = 0;
          for (int j = 0; j < 4; j++) {
            st += T[ct(-1, 4 * cbx + j)];
            sl += T[ct(4 * cby + j, -1)];
          }
          if (cbx == cby) v = dc_pred(st, sl, avB, avA, 2);
          else if (cby == 0) v = avB ? (st + 2) >> 2 : avA ? (sl + 2) >> 2 : 128;
          else v = avA ? (sl + 2) >> 2 : avB ? (st + 2) >> 2 : 128;
        } else if (cmode == 3) {
          int hh = 0, vv = 0;
          for (int j = 0; j < 4; j++) {
            hh += (j + 1) * (T[ct(-1, 4 + j)] - T[ct(-1, 2 - j)]);
            vv += (j + 1) * (T[ct(4 + j, -1)] - T[ct(2 - j, -1)]);
          }
          pa = 16 * (T[ct(7, -1)] + T[ct(-1, 7)]);
          pb = (34 * hh + 32) >> 6;
          pc = (34 * vv + 32) >> 6;
        }
        uint8_t o4[4];
        for (int i = 0; i < 4; i++) {
          int xx = xx0 + i, p;
          if (cmode == 0) p = v;
          else if (cmode == 1) p = T[ct(yy, -1)];
          else if (cmode == 2) p = T[ct(-1, xx)];
          else p = clip1((pa + pb * (xx - 3) + pc * (yy - 3) + 16) >> 5);
          o4[i] = uint8_t(clip1(p + s_rc[r][c * 64 + yy * 8 + xx]));
        }
        for (int i = 0; i < 4; i++) s_c[r][c][ct(yy, xx0 + i)] = o4[i];
      }
      if (kind == H_I16) {
        const int yy = lane >> 1, xx0 = 8 * (lane & 1);
        int dc = 0, pa = 0, pb = 0, pc = 0;
        if (mode16 == 2) {
          int st = 0, sl = 0;
          for (int i = 0; i < 16; i++) {
            st += ty[lt(-1, i)];
            sl += ty[lt(i, -1)];
          }
          dc = dc_pred(st, sl, avB, avA, 4);
        } else if (mode16 == 3) {  // p[-1, -1] sits at row and column -1
          int hh = 0, vv = 0;
          for (int k = 0; k < 8; k++) {
            hh += (k + 1) * (ty[lt(-1, 8 + k)] - ty[lt(-1, 6 - k)]);
            vv += (k + 1) * (ty[lt(8 + k, -1)] - ty[lt(6 - k, -1)]);
          }
          pa = 16 * (ty[lt(15, -1)] + ty[lt(-1, 15)]);
          pb = (5 * hh + 32) >> 6;
          pc = (5 * vv + 32) >> 6;
        }
        uint8_t o8[8];
        for (int i = 0; i < 8; i++) {
          int xx = xx0 + i, p;
          if (mode16 == 0) p = ty[lt(-1, xx)];
          else if (mode16 == 1) p = ty[lt(yy, -1)];
          else if (mode16 == 2) p = dc;
          else p = clip1((pa + pb * (xx - 7) + pc * (yy - 7) + 16) >> 5);
          o8[i] = uint8_t(clip1(p + s_ry[r][yy * 16 + xx]));
        }
        for (int i = 0; i < 8; i++) ty[lt(yy, xx0 + i)] = o8[i];
        __syncwarp();
      } else {
        // each sub-wave's sample of this lane: its three tile offsets,
        // weights, rounding, shift and residual, resolved before the
        // dependent steps
        int offs[10], wts[10], res[10];
#pragma unroll
        for (int s = 0; s < 10; s++) {
          const int bx = g ? (s & 1) : (s < 4 ? s : 2 + (s & 1));
          const int by = (s - bx) >> 1, b = 4 * by + bx;
          const int mode = ((b >> 3 ? md1 : md0) >> (4 * (b & 7))) & 15;
          const bool tr_av = by == 0 ? (bx == 3 ? avC : avB)
                                     : ((kTrInside >> b) & 1);
          const int o = lt(4 * by, 4 * bx);
          const int tap = s_taps[mode * 16 + py * 4 + px];
          int off = 0;
#pragma unroll
          for (int j = 0; j < 3; j++) {
            // E[i]: p[-1, 3 - i] (i < 4), p[-1, -1], p[i - 5, -1]; the
            // top-right p[3, -1] where it is not available
            int i = (tap >> (4 * j)) & 15;
            if (i > 8 && !tr_av) i = 8;
            off |= (o + (i < 4 ? (3 - i) * TS - 1
                               : (i == 4 ? -TS - 1 : i - 5 - TS)))
                   << (10 * j);
          }
          offs[s] = off;
          wts[s] = ((tap >> 12) & 1023) | (mode == 2) << 10 |
                   (by > 0 || avB) << 11 | (bx > 0 || avA) << 12;
          res[s] = s_ry[r][(4 * by + py) * 16 + 4 * bx + px];
        }
#pragma unroll
        for (int s = 0; s < 10; s++) {
          if (s == 3 && tr_late) {
            wave.wait(x + 2);
            if (lane < 4)
              ty[lt(-1, 16 + lane)] =
                  __ldcg(Y + int64_t(y0 - 1) * w + x0 + 16 + lane);
            __syncwarp();
          }
          const int bx = g ? (s & 1) : (s < 4 ? s : 2 + (s & 1));
          const int by = (s - bx) >> 1;
          if (g == 0 || (s >= 2 && s <= 7)) {
            const int o = lt(4 * by, 4 * bx), wt = wts[s];
            const int a0 = ty[offs[s] & 1023], a1 = ty[(offs[s] >> 10) & 1023];
            const int a2 = ty[offs[s] >> 20];
            int st = 0, sl = 0;
#pragma unroll
            for (int i = 0; i < 4; i++) {
              st += ty[o - TS + i];
              sl += ty[o + i * TS - 1];
            }
            const int p = (wt >> 10) & 1
                ? dc_pred(st, sl, (wt >> 11) & 1, (wt >> 12) & 1, 2)
                : (a0 * (wt & 3) + a1 * ((wt >> 2) & 3) +
                   a2 * ((wt >> 4) & 3) + ((wt >> 6) & 3)) >> ((wt >> 8) & 3);
            ty[o + py * TS + px] = uint8_t(clip1(p + res[s]));
          }
          __syncwarp();
        }
      }
    }
    // the macroblock out in whole rows: luma lanes 0-15, chroma 16-31
    if (lane < 16)
      *reinterpret_cast<uint4*>(Y + int64_t(y0 + lane) * w + x0) =
          *reinterpret_cast<const uint4*>(ty + lt(lane, 0));
    else
      *reinterpret_cast<uint2*>((cl ? V : U) + int64_t(8 * y + kl) * wc +
                                8 * x) =
          *reinterpret_cast<const uint2*>(s_c[r][cl] + ct(kl, 0));
    wave.publish(nx);
    last = x;
    // the samples above the next macroblock, once the row above has
    // finished it and the one before it
    top_in = nx == x + 1 && nx < mbw && y > 0 &&
             __shfl_sync(FULL, in.rec, F_KIND) != H_PCM;
    if (top_in) {
      wave.wait(x + 2);
      top = intra_top(Y, U, V, nx, y, w);
    }
    x = nx;
  }
}

// bS (8.7.2.1) of the edge between 4x4 luma blocks p and q (records mv x,
// mv y, reference slot, total_coeff) of macroblocks of kinds kp and kq
__device__ __forceinline__ int bs_rule(int kp, int kq, int4 p, int4 q,
                                       bool mb_edge) {
  if (kp >= H_I4 || kq >= H_I4) return mb_edge ? 4 : 3;
  if (p.w != 0 || q.w != 0) return 2;
  if (p.z != q.z || abs(p.x - q.x) >= 4 || abs(p.y - q.y) >= 4) return 1;
  return 0;
}

__device__ __forceinline__ int4 shfl4(int4 v, int src) {
  return make_int4(__shfl_sync(FULL, v.x, src), __shfl_sync(FULL, v.y, src),
                   __shfl_sync(FULL, v.z, src), __shfl_sync(FULL, v.w, src));
}

// an edge's line parameters, packed: alpha, beta, tC0 a byte each, bS
__device__ __forceinline__ int edge_param(int bs, int qpav, int off_a,
                                          int off_b, const int* s_alpha,
                                          const int* s_beta,
                                          const int* s_tc0) {
  if (bs == 0) return 0;
  int ia = min(max(qpav + off_a, 0), 51), ib = min(max(qpav + off_b, 0), 51);
  int tc0 = bs < 4 ? s_tc0[ia * 3 + bs - 1] : 0;
  return s_alpha[ia] | s_beta[ib] << 8 | tc0 << 16 | bs << 24;
}

// 8.7.2.3-4 across the edge between v[P - 1] and v[P] of a line in
// registers
template <int P>
__device__ __forceinline__ void filter_at(int (&v)[20], int prm,
                                          bool chroma) {
  const int bs = prm >> 24;
  if (bs == 0) return;
  const int alpha = prm & 255, beta = (prm >> 8) & 255,
            tc0 = (prm >> 16) & 255;
  const int p3 = v[P - 4], p2 = v[P - 3], p1 = v[P - 2], p0 = v[P - 1];
  const int q0 = v[P], q1 = v[P + 1], q2 = v[P + 2], q3 = v[P + 3];
  if (!(abs(p0 - q0) < alpha && abs(p1 - p0) < beta && abs(q1 - q0) < beta))
    return;
  const bool ap = !chroma && abs(p2 - p0) < beta;
  const bool aq = !chroma && abs(q2 - q0) < beta;
  if (bs < 4) {
    int tc = chroma ? tc0 + 1 : tc0 + ap + aq;
    int delta = min(max((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc), tc);
    v[P - 1] = clip1(p0 + delta);
    v[P] = clip1(q0 - delta);
    int mid = (p0 + q0 + 1) >> 1;
    if (ap) v[P - 2] = p1 + min(max((p2 + mid - (p1 << 1)) >> 1, -tc0), tc0);
    if (aq) v[P + 1] = q1 + min(max((q2 + mid - (q1 << 1)) >> 1, -tc0), tc0);
  } else {
    const bool small = abs(p0 - q0) < ((alpha >> 2) + 2);
    if (ap && small) {
      v[P - 1] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
      v[P - 2] = (p2 + p1 + p0 + q0 + 2) >> 2;
      v[P - 3] = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
    } else {
      v[P - 1] = (2 * p1 + p0 + q1 + 2) >> 2;
    }
    if (aq && small) {
      v[P] = (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3;
      v[P + 1] = (p0 + q0 + q1 + q2 + 2) >> 2;
      v[P + 2] = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
    } else {
      v[P] = (2 * q1 + q0 + p1 + 2) >> 2;
    }
  }
}

__device__ __forceinline__ void unpack(uint32_t word, int* v) {
  for (int i = 0; i < 4; i++) v[i] = (word >> (8 * i)) & 255;
}
__device__ __forceinline__ uint32_t pack(const int* v) {
  return uint32_t(v[0]) | uint32_t(v[1]) << 8 | uint32_t(v[2]) << 16 |
         uint32_t(v[3]) << 24;
}

// H4's inputs for one macroblock, loaded a macroblock ahead: its record
// (lanes 0-15 a field each) and the kind, QP and chroma QP offset of its
// left and top neighbours (lanes 16-21); the block records of its 4x4
// blocks (lanes 0-15), of the left one's column 3 (16-19) and of the top
// one's row 3 (20-23); this lane's line of its samples, and, where the
// macroblock before it is not filtered here, the 4 samples left of it
struct DeblockIn {
  int rec;
  int4 blk;
  uint4 own;
  uint32_t left;
};

__device__ __forceinline__ DeblockIn deblock_in(const int32_t* mb,
                                                const int32_t* blk, int mbw,
                                                int x, int y, uint8_t* own,
                                                bool chroma, bool left) {
  const int lane = threadIdx.x & 31, m = y * mbw + x;
  DeblockIn in;
  if (lane < 16) {
    in.rec = mb[int64_t(m) * MB_FIELDS + lane];
  } else {
    const int k = lane - 16, n = k < 3 ? m - 1 : m - mbw;
    const bool ok = k < 6 && (k < 3 ? x > 0 : y > 0);
    in.rec = ok ? mb[int64_t(n) * MB_FIELDS + (k % 3 == 0 ? F_KIND
                                               : k % 3 == 1 ? F_QP : F_QPC)]
                : 0;
  }
  int sm = -1, sb = 0;
  if (lane < 16) sm = m, sb = lane;
  else if (lane < 20 && x > 0) sm = m - 1, sb = 4 * (lane - 16) + 3;
  else if (lane >= 20 && lane < 24 && y > 0) sm = m - mbw, sb = 12 + lane - 20;
  in.blk = sm >= 0 ? __ldg(reinterpret_cast<const int4*>(
                         blk + (int64_t(sm) * 16 + sb) * BLK_FIELDS))
                   : make_int4(0, 0, 0, 0);
  if (chroma) {
    uint2 b = __ldcg(reinterpret_cast<const uint2*>(own));
    in.own = make_uint4(b.x, b.y, 0, 0);
  } else {
    in.own = __ldcg(reinterpret_cast<const uint4*>(own));
  }
  in.left = left && x > 0 ? __ldcg(reinterpret_cast<const uint32_t*>(own - 4))
                          : 0;
  return in;
}

// H4: a warp a macroblock row, the same wavefront. Lane l < 16 holds luma
// line l, lane 16 + 8c + k chroma line k of component c: first a row (the
// left macroblock's last 4 samples, then 16 or 8 of its own) for the
// vertical edges, then, after one transpose through shared memory, a
// column (the 4 samples above, then its own) for the horizontal ones;
// each lane filters its edges in order in registers. From a ballot over
// the row's filter flags it knows the macroblocks it filters and
// publishes its progress past the others in one store. A macroblock's
// records, block records and samples are loaded while the one before it
// is filtered; its edges' parameters come from them before any wait
// (lanes 0-15 each the bS of its 4x4 block's left and top edges, block
// records passed by shuffles; each lane then takes its lines' bS, alpha,
// beta and tC0, the tables in shared memory). The vertical edges read
// nothing of the row above, so the wait for the macroblocks above (and
// above and to the right, whose left edge changes samples above this
// one) comes after them, unless the row above is known to have passed
// them and the samples above are loaded first. Samples out in 16- and
// 8-byte rows. What bounds it is its chain: 8 edges a line, two
// transposes and a handoff where the chain crosses a row.
template <int ROWS>
__global__ void __launch_bounds__(32 * ROWS)
    deblock_kernel(uint8_t* __restrict__ yp, uint8_t* __restrict__ up,
                   uint8_t* __restrict__ vp, int h, int w, int out,
                   const int32_t* __restrict__ mb,
                   const int32_t* __restrict__ blk, int mbw, int* ticket,
                   int* progress) {
  __shared__ int s_alpha[52], s_beta[52], s_tc0[52 * 3], s_cqp[52];
  __shared__ int s_flag[ROWS], s_row;
  __shared__ unsigned s_work[ROWS][kMaxChunks];
  __shared__ __align__(16) uint8_t s_t[ROWS][384];
  const int t = threadIdx.x, lane = t & 31, r = t >> 5;
  for (int i = t; i < 52 * 3; i += 32 * ROWS) {
    s_tc0[i] = c_tc0[i];
    if (i < 52) {
      s_alpha[i] = c_alpha[i];
      s_beta[i] = c_beta[i];
      s_cqp[i] = c_cqp[i];
    }
  }
  if (t < ROWS) s_flag[t] = 0;
  const int mbh = h / 16, y = claim_rows(ticket, &s_row, ROWS);
  if (y >= mbh) return;
  Wave<ROWS> wave{progress, s_flag, y, r, 0};
  const int hc = h >> 1, wc = w >> 1;
  const bool chroma = lane >= 16;
  const int li = lane & 15, c = li >> 3, k = lane & 7;
  // this lane's plane, and the row and column of its line
  uint8_t* const pl = chroma ? (c ? vp : up) + int64_t(out) * hc * wc
                             : yp + int64_t(out) * h * w;
  const int pw = chroma ? wc : w, n = chroma ? 8 : 16;
  const int line = chroma ? k : li;
  uint8_t* const tile = s_t[r] + (chroma ? 256 + 64 * c : 0);
  unsigned* const work = s_work[r];
  auto own_at = [&](int xx) { return pl + int64_t(n * y + line) * pw + n * xx; };
  row_masks(mb, y, mbw, F_FILTER, [](int f) { return f == 0; }, work);
  int x = next_work(work, 0, mbw), last = -2;
  if (x > 0) wave.publish(x);
  DeblockIn in;
  if (x < mbw) in = deblock_in(mb, blk, mbw, x, y, own_at(x), chroma, true);
  uint32_t keep = 0;
  while (x < mbw) {
    const int nx = next_work(work, x + 1, mbw);
    const DeblockIn cur = in;
    if (nx < mbw)
      in = deblock_in(mb, blk, mbw, nx, y, own_at(nx), chroma, nx > x + 1);
    // the edges' parameters
    const int kq = __shfl_sync(FULL, cur.rec, F_KIND);
    const int qpq = kq == H_PCM ? 0 : __shfl_sync(FULL, cur.rec, F_QP);
    const int cqq = s_cqp[min(max(qpq + __shfl_sync(FULL, cur.rec, F_QPC), 0), 51)];
    const int off_a = __shfl_sync(FULL, cur.rec, F_ALPHA);
    const int off_b = __shfl_sync(FULL, cur.rec, F_BETA);
    const int kl = __shfl_sync(FULL, cur.rec, 16), kt = __shfl_sync(FULL, cur.rec, 19);
    const int qpl = kl == H_PCM ? 0 : __shfl_sync(FULL, cur.rec, 17);
    const int qpt = kt == H_PCM ? 0 : __shfl_sync(FULL, cur.rec, 20);
    const int cql = s_cqp[min(max(qpl + __shfl_sync(FULL, cur.rec, 18), 0), 51)];
    const int cqt = s_cqp[min(max(qpt + __shfl_sync(FULL, cur.rec, 21), 0), 51)];
    const int bx = li & 3, by = li >> 2;
    const int4 rl = shfl4(cur.blk, bx ? lane - 1 : 16 + by);
    const int4 rt = shfl4(cur.blk, by ? lane - 4 : 20 + bx);
    const int bsv = bx == 0 && x == 0 ? 0 : bs_rule(bx ? kq : kl, kq, rl, cur.blk, bx == 0);
    const int bsh = by == 0 && y == 0 ? 0 : bs_rule(by ? kq : kt, kq, rt, cur.blk, by == 0);
    const int both = bsv | bsh << 4;
    int pv[4], ph[4];
#pragma unroll
    for (int j = 0; j < 4; j++) {
      // luma line l: block row l >> 2, edge j; chroma line k: luma line
      // 2k's edges 0 and 2 (its edges 0 and 4)
      const int sv = chroma ? 4 * (k >> 1) + 2 * (j & 1) : 4 * (li >> 2) + j;
      const int sh = chroma ? 8 * (j & 1) + (k >> 1) : 4 * j + (li >> 2);
      int bv = __shfl_sync(FULL, both, sv) & 15;
      int bh = (__shfl_sync(FULL, both, sh) >> 4) & 15;
      if (chroma && j >= 2) bv = bh = 0;
      const int qv = j ? (chroma ? cqq : qpq)
                       : chroma ? (cql + cqq + 1) >> 1 : (qpl + qpq + 1) >> 1;
      const int qh = j ? (chroma ? cqq : qpq)
                       : chroma ? (cqt + cqq + 1) >> 1 : (qpt + qpq + 1) >> 1;
      pv[j] = edge_param(bv, qv, off_a, off_b, s_alpha, s_beta, s_tc0);
      ph[j] = edge_param(bh, qh, off_a, off_b, s_alpha, s_beta, s_tc0);
    }
    // the line: the left macroblock's last 4 samples (this warp's, or
    // loaded ahead), then its own
    int v[20];
    unpack(last == x - 1 ? keep : cur.left, v);
    unpack(cur.own.x, v + 4);
    unpack(cur.own.y, v + 8);
    unpack(cur.own.z, v + 12);
    unpack(cur.own.w, v + 16);
    uint8_t* const own = own_at(x);
    // the 4 samples above this lane's column, final once the row above
    // has finished x + 1 too (its left edge changes columns 13-15,
    // chroma's 7): loaded now if it has, else after the vertical edges
    uint32_t above = 0;
    const uint8_t* const a = pl + int64_t(n * y - 4) * pw + n * x + line;
    const bool early = y > 0 && wave.seen >= min(x + 2, mbw);
    if (early)
      for (int i = 0; i < 4; i++)
        above |= uint32_t(__ldcg(a + i * pw)) << (8 * i);
    filter_at<4>(v, pv[0], chroma);
    filter_at<8>(v, pv[1], chroma);
    filter_at<12>(v, pv[2], chroma);
    filter_at<16>(v, pv[3], chroma);
    if (x > 0) *reinterpret_cast<uint32_t*>(own - 4) = pack(v);
    // transpose: rows in, columns out
    if (chroma) {
      *reinterpret_cast<uint2*>(tile + 8 * line) = make_uint2(pack(v + 4), pack(v + 8));
    } else {
      *reinterpret_cast<uint4*>(tile + 16 * line) =
          make_uint4(pack(v + 4), pack(v + 8), pack(v + 12), pack(v + 16));
    }
    __syncwarp();
    for (int i = 0; i < 16; i++) v[4 + i] = i < n ? tile[n * i + line] : 0;
    if (y > 0 && !early) {
      wave.wait(min(x + 2, mbw));
      for (int i = 0; i < 4; i++)
        above |= uint32_t(__ldcg(a + i * pw)) << (8 * i);
    }
    unpack(above, v);
    __syncwarp();
    filter_at<4>(v, ph[0], chroma);
    filter_at<8>(v, ph[1], chroma);
    filter_at<12>(v, ph[2], chroma);
    filter_at<16>(v, ph[3], chroma);
    if (y > 0) {
      uint8_t* const b = pl + int64_t(n * y - 3) * pw + n * x + line;
      for (int i = 0; i < 3; i++) b[i * pw] = uint8_t(v[1 + i]);
    }
    for (int i = 0; i < 16; i++)
      if (i < n) tile[n * i + line] = uint8_t(v[4 + i]);
    __syncwarp();
    if (chroma) {
      uint2 b = *reinterpret_cast<const uint2*>(tile + 8 * line);
      *reinterpret_cast<uint2*>(own) = b;
      keep = b.y;
    } else {
      uint4 b = *reinterpret_cast<const uint4*>(tile + 16 * line);
      *reinterpret_cast<uint4*>(own) = b;
      keep = b.w;
    }
    wave.publish(nx);
    last = x;
    x = nx;
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
  if (mbw > 32 * kMaxChunks) return status(cudaErrorInvalidValue);
  int rows = h / 16;
  cudaError_t e = cudaMemsetAsync(sync, 0, sizeof(int) * (1 + rows), stream);
  if (e != cudaSuccess) return status(e);
  intra_kernel<WAVE_ROWS>
      <<<(rows + WAVE_ROWS - 1) / WAVE_ROWS, 32 * WAVE_ROWS, 0, stream>>>(
          y, u, v, h, w, out, mb, pcm, mbw, ry, rc, sync, sync + 1);
  return status(cudaGetLastError());
}

int h264_deblock(uint8_t* y, uint8_t* u, uint8_t* v, int h, int w, int out,
                 const int32_t* mb, const int32_t* blk, int mbw, int* sync,
                 cudaStream_t stream) {
  if (mbw > 32 * kMaxChunks) return status(cudaErrorInvalidValue);
  int rows = h / 16;
  cudaError_t e = cudaMemsetAsync(sync, 0, sizeof(int) * (1 + rows), stream);
  if (e != cudaSuccess) return status(e);
  deblock_kernel<WAVE_ROWS>
      <<<(rows + WAVE_ROWS - 1) / WAVE_ROWS, 32 * WAVE_ROWS, 0, stream>>>(
          y, u, v, h, w, out, mb, blk, mbw, sync, sync + 1);
  return status(cudaGetLastError());
}

}  // extern "C"
#endif  // __CUDACC__
