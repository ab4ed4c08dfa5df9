// The MPEG-4 Part 2 (mp4v) codec of the port: the host entropy coder in
// C++ and the five device stages as CUDA kernels (ops/mpeg4_cuda.py has
// the plain version of each and the record layout; io/mpeg4.py has the
// plain entropy coder, whose VLC tables mpeg4_set_vlc receives).
//
//   host   mpeg4_parse / mpeg4_write: VOP bits <-> macroblock records, the
//          VOPs of a batch spread over threads (each I- or P-VOP is
//          independent once the VOL is known; the B-VOPs follow in a
//          second wave, each reading its future anchor's records)
//   V1     dequant_idct: H.263 inverse quantisation and the integer
//          "simple" IDCT of every coded block of a batch, a thread a row,
//          the column pass in int32 where a bound certifies it
//   V2     motion_compensate: half-pel prediction (+ residual, clipped),
//          rows of 8 pixels a thread from word-wide reference rows, every
//          item (a VOP) of a launch in grid.y; quarter-pel (the Advanced
//          Simple Profile) as V5, a warp a macroblock
//   V3     motion_search: +-16 pixel full search on the reference window in
//          shared memory with packed-byte SADs (vabsdiff4), a run of
//          candidates a thread, then half-pel refinement and the intra
//          decision
//   V4     fdct_quant: integer 8x8 forward DCT (butterflies in registers)
//          and H.263 quantisation by multiply-high, a thread a block row
//   V5     bidir_compensate: the B-VOPs' prediction from two anchors
//          (half- or quarter-pel, rounding 0, (f + b + 1) >> 1 where both
//          predict) plus the residual, clipped: a warp a macroblock, a
//          lane a row of 8 pixels, the 8-tap passes two pixels a word in
//          16-bit lanes, both directions in registers
//
// Every stage is integer arithmetic and matches its plain version bit for
// bit. Without __CUDACC__ only the host coder is compiled (a C++ compiler
// can build it alone).

#include <algorithm>
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

constexpr int MB_FIELDS = 12;
constexpr int B_FIELDS = 20;
constexpr int VOP_FIELDS = 6;
constexpr int VOP_I = 0, VOP_P = 1, VOP_SKIP = 2, VOP_B = 3;
constexpr int MB_SKIP = 0, MB_INTER = 1, MB_INTRA = 2, MB_INTER4V = 3;
constexpr int B_FWD = 1, B_BWD = 2, B_8X8 = 4;
// mb_type of B-VOPs (Table B-4)
constexpr int B_DIRECT = 0, B_INTERP = 1, B_BACKWARD = 2, B_FORWARD = 3;

// ---- VLC tables, set from Python ----------------------------------------

enum Table { MCBPC_I = 0, MCBPC_P, CBPY, DC_L, DC_C, MVD, T_INTER, T_INTRA,
             MB_B, N_TABLES };
constexpr int ESC = -1;
constexpr int MCBPC_I_STUFFING = 8, MCBPC_P_STUFFING = 20;

struct Vlc {
  int bits = 0;
  std::vector<int32_t> sym;
  std::vector<uint8_t> len;
  std::vector<uint32_t> code;   // by symbol index (non-TCOEF tables)
  std::vector<uint8_t> clen;
};

Vlc g_vlc[N_TABLES];
// TCOEF: code index of (last, run, level), LMAX, RMAX
constexpr int MAXRUN = 64, MAXLEV = 32;
int g_tidx[2][2][MAXRUN][MAXLEV];  // [table][last][run][level] -> entry or -1
uint32_t g_tcode[2][128];
uint8_t g_tlen[2][128];
int g_lmax[2][2][MAXRUN];   // 0: no code for the run
int g_rmax[2][2][MAXLEV];   // -1: no code for the level
uint32_t g_esc_code = 0;
int g_esc_len = 0;

const int ZIGZAG[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const int ALT_H[64] = {
    0, 1, 2, 3, 8, 9, 16, 17, 10, 11, 4, 5, 6, 7, 15, 14,
    13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
    30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
    46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
int ALT_V[64];
const int DQUANT[4] = {-1, -2, 1, 2};
const int DC_THR_QP[8] = {99, 13, 15, 17, 19, 21, 23, 0};
const int C_OFF[4] = {2, 1, 1, -1};

int dc_scaler(int qp, bool luma) {
  if (qp < 5) return 8;
  if (luma) return qp < 9 ? 2 * qp : (qp < 25 ? qp + 8 : 2 * qp - 16);
  return qp < 25 ? (qp + 13) / 2 : qp - 6;
}

int time_bits(int res) {
  int b = 0;
  while ((1 << b) < res) ++b;  // bit length of res - 1
  return std::max(b, 1);
}

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// ---- bits -------------------------------------------------------------------

struct Reader {
  const uint8_t* d;
  int64_t end;   // in bits
  int64_t pos;
  uint32_t peek(int n) const {  // n in 1..32; reads past the end give 0
    int64_t byte = pos >> 3;
    uint64_t v = 0;
    int64_t nbytes = (end + 7) >> 3;
    for (int i = 0; i < 8; ++i) {
      int64_t b = byte + i;
      v = (v << 8) | (b < nbytes ? d[b] : 0);
    }
    return (uint32_t)((v << (pos & 7)) >> (64 - n));
  }
  uint32_t read(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    pos += n;
    return v;
  }
  int vlc(const Vlc& t) {
    uint32_t i = peek(t.bits);
    int n = t.len[i];
    if (!n) throw Error("no VLC code at bit " + std::to_string(pos));
    pos += n;
    return t.sym[i];
  }
  void marker() {
    if (!read(1)) throw Error("marker bit missing");
  }
  int64_t left() const { return end - pos; }
};

struct Writer {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int nacc = 0;
  int64_t nbits = 0;
  void put(uint32_t v, int n) {
    if (n == 0) return;
    if (n < 32) v &= (1u << n) - 1;
    acc = (acc << n) | v;
    nacc += n;
    nbits += n;
    while (nacc >= 8) {
      nacc -= 8;
      out.push_back((uint8_t)(acc >> nacc));
    }
  }
  void stuff() {
    put(0, 1);
    int k = (int)((8 - (nbits & 7)) & 7);
    put((1u << k) - 1, k);
  }
  void flush() {
    if (nacc) put(0, 8 - nacc);
  }
};

// ---- predictors ------------------------------------------------------------

// io/mpeg4.Vol.as_ints: width, height, time resolution, resync markers
// disabled, quant precision, quarter_sample, quant_type, low_delay
struct Vol {
  int width, height, res, resync_disable, qprec, qpel, quant_type,
      low_delay;
  int mbw, mbh, n_mb, tbits, mbbits;
  explicit Vol(const int32_t* v)
      : width(v[0]), height(v[1]), res(v[2]), resync_disable(v[3]),
        qprec(v[4]), qpel(v[5]), quant_type(v[6]), low_delay(v[7]) {
    mbw = (width + 15) / 16;
    mbh = (height + 15) / 16;
    n_mb = mbw * mbh;
    tbits = time_bits(res);
    int b = 0;
    while ((1 << b) < n_mb) ++b;
    mbbits = std::max(b, 1);
  }
};

struct Pred {
  int mbw, mbh, off[3], stride[3];
  std::vector<int> dc;
  std::vector<int16_t> row, col;  // 7 levels a block
  std::vector<uint8_t> intra;
  std::vector<int> qp;
  std::vector<int> mvx, mvy;
  int start = 0;
  explicit Pred(const Vol& v) : mbw(v.mbw), mbh(v.mbh) {
    int nl = 4 * mbw * mbh, nc = mbw * mbh;
    off[0] = 0; off[1] = nl; off[2] = nl + nc;
    stride[0] = 2 * mbw; stride[1] = stride[2] = mbw;
    int n = nl + 2 * nc;
    dc.assign(n, 1024);
    row.assign(7 * n, 0);
    col.assign(7 * n, 0);
    intra.assign(nc, 0);
    qp.assign(nc, 0);
    mvx.assign(nl, 0);
    mvy.assign(nl, 0);
  }
  void block(int m, int b, int& plane, int& y, int& x) const {
    int my = m / mbw, mx = m % mbw;
    if (b < 4) { plane = 0; y = 2 * my + (b >> 1); x = 2 * mx + (b & 1); }
    else { plane = b - 3; y = my; x = mx; }
  }
  int key(int plane, int y, int x) const {
    if (y < 0 || x < 0) return -1;
    int s = plane == 0 ? 1 : 0;
    int m = (y >> s) * mbw + (x >> s);
    if (m < start || !intra[m]) return -1;
    return off[plane] + y * stride[plane] + x;
  }
  // key of block, predicting DC, top?, key of the predicting block
  void dc_direction(int m, int b, int& k, int& pdc, int& top, int& pk) const {
    int plane, y, x;
    block(m, b, plane, y, x);
    int ka = key(plane, y, x - 1), kb = key(plane, y - 1, x - 1),
        kc = key(plane, y - 1, x);
    int fa = ka < 0 ? 1024 : dc[ka], fb = kb < 0 ? 1024 : dc[kb],
        fc = kc < 0 ? 1024 : dc[kc];
    k = off[plane] + y * stride[plane] + x;
    if (std::abs(fa - fb) < std::abs(fb - fc)) { pdc = fc; top = 1; pk = kc; }
    else { pdc = fa; top = 0; pk = ka; }
  }
  void ac_prediction(int pk, int top, int q, int add[7]) const {
    if (pk < 0) { for (int i = 0; i < 7; ++i) add[i] = 0; return; }
    const int16_t* v = top ? &row[7 * pk] : &col[7 * pk];
    int plane = pk < off[1] ? 0 : (pk < off[2] ? 1 : 2);
    int local = pk - off[plane];
    int y = local / stride[plane], x = local % stride[plane];
    int s = plane == 0 ? 1 : 0;
    int qa = qp[(y >> s) * mbw + (x >> s)];
    for (int i = 0; i < 7; ++i) {
      int a = v[i] * qa;
      add[i] = qa == q ? v[i]
                       : (a >= 0 ? (a + (q >> 1)) / q : -((-a + (q >> 1)) / q));
    }
  }
  void store_intra(int k, const int16_t* lv, int scale) {
    int d = lv[0] * scale;
    dc[k] = d < 0 ? 0 : std::min(d, 2047);
    for (int i = 1; i < 8; ++i) {
      row[7 * k + i - 1] = lv[i];
      col[7 * k + i - 1] = lv[8 * i];
    }
  }
  bool mv(int y, int x, int& vx, int& vy) const {
    if (y < 0 || x < 0 || x >= 2 * mbw) return false;
    if ((y >> 1) * mbw + (x >> 1) < start) return false;
    int k = y * 2 * mbw + x;
    vx = mvx[k]; vy = mvy[k];
    return true;
  }
  void mv_prediction(int m, int b, int& px, int& py) const {
    int plane, y, x;
    block(m, b, plane, y, x);
    int cx[3] = {0, 0, 0}, cy[3] = {0, 0, 0};
    bool ok[3] = {mv(y, x - 1, cx[0], cy[0]), mv(y - 1, x, cx[1], cy[1]),
                  mv(y - 1, x + C_OFF[b], cx[2], cy[2])};
    int nv = ok[0] + ok[1] + ok[2];
    if (nv == 0) { px = py = 0; return; }
    if (nv == 1) {
      for (int i = 0; i < 3; ++i)
        if (ok[i]) { px = cx[i]; py = cy[i]; }
      return;
    }
    auto med = [](int a, int b, int c) {
      return std::max(std::min(a, b), std::min(std::max(a, b), c));
    };
    px = med(cx[0], cx[1], cx[2]);
    py = med(cy[0], cy[1], cy[2]);
  }
  void set_mvs(int m, const int v[8]) {
    for (int b = 0; b < 4; ++b) {
      int plane, y, x;
      block(m, b, plane, y, x);
      int k = y * 2 * mbw + x;
      mvx[k] = v[2 * b];
      mvy[k] = v[2 * b + 1];
    }
  }
};

// ---- parsing ----------------------------------------------------------------

void read_tcoef(Reader& br, int t, int& last, int& run, int& level) {
  const Vlc& v = g_vlc[t == 0 ? T_INTER : T_INTRA];
  int s = br.vlc(v);
  if (s != ESC) {
    last = s >> 16; run = (s >> 8) & 255; level = s & 255;
    if (br.read(1)) level = -level;
    return;
  }
  if (br.read(1) == 0) {
    s = br.vlc(v);
    if (s == ESC) throw Error("escape inside escape mode 1");
    last = s >> 16; run = (s >> 8) & 255; level = s & 255;
    level += g_lmax[t][last][run];
    if (br.read(1)) level = -level;
    return;
  }
  if (br.read(1) == 0) {
    s = br.vlc(v);
    if (s == ESC) throw Error("escape inside escape mode 2");
    last = s >> 16; run = (s >> 8) & 255; level = s & 255;
    run += g_rmax[t][last][level] + 1;
    if (br.read(1)) level = -level;
    return;
  }
  last = br.read(1);
  run = br.read(6);
  br.marker();
  level = br.read(12);
  br.marker();
  if (level >= 2048) level -= 4096;
  if (level == 0 || level == -2048) throw Error("forbidden escape level");
}

void read_levels(Reader& br, int t, const int* scan, int16_t* lv, int pos) {
  while (true) {
    int last, run, level;
    read_tcoef(br, t, last, run, level);
    pos += run;
    if (pos > 63) throw Error("more than 64 coefficients in a block");
    lv[scan[pos]] = (int16_t)level;
    ++pos;
    if (last) return;
  }
}

int read_mv(Reader& br, int pred, int fcode) {
  int code = br.vlc(g_vlc[MVD]);
  int val = 0;
  if (code) {
    int sign = br.read(1);
    int r = fcode - 1;
    val = r ? ((code - 1) << r) + (int)br.read(r) + 1 : code;
    if (sign) val = -val;
  }
  int f32 = 32 << (fcode - 1);
  int v = pred + val + f32;
  v %= 2 * f32;
  if (v < 0) v += 2 * f32;
  return v - f32;
}

int resync_length(Reader& br, int prefix) {
  int n = 8 - (int)(br.pos & 7);
  if (br.peek(n) != (1u << (n - 1)) - 1) return 0;
  Reader r = br;
  r.pos += n;
  bool ok = r.left() > prefix && r.peek(prefix + 1) == 1;
  return ok ? n : 0;
}

struct ParsedVop {
  int32_t vop[VOP_FIELDS];
  std::vector<int32_t> mb;  // MB_FIELDS a macroblock, B_FIELDS for a B-VOP
  std::vector<int16_t> blocks;
  std::vector<int32_t> bidx;
  std::string error;
};

// What io/mpeg4.plan_stream decided for a VOP: its kind (VOP_SKIP: read
// the header only) and TRB, TRD of a B-VOP
struct Step {
  int kind, trb, trd;
};

int64_t find_vop(const uint8_t* d, int64_t n) {
  for (int64_t i = 0; i + 3 < n; ++i)
    if (d[i] == 0 && d[i + 1] == 0 && d[i + 2] == 1 && d[i + 3] == 0xB6)
      return (i + 4) * 8;
  throw Error("sample holds no VOP start code");
}

// a video packet header at this position: its quant_scale, or -1 where no
// resync marker stands here
int packet_header(Reader& br, const Vol& vol, int kind, int prefix, int m) {
  int k = resync_length(br, prefix);
  if (!k) return -1;
  br.pos += k + prefix + 1;
  int m0 = br.read(vol.mbbits);
  int qp = br.read(vol.qprec);
  if (br.read(1)) {
    while (br.read(1)) {}
    br.marker();
    br.read(vol.tbits);
    br.marker();
    br.read(2);
    br.read(3);
    if (kind != VOP_I) br.read(3);
    if (kind == VOP_B) br.read(3);
  }
  if (m0 != m) throw Error("video packet starts at an unexpected macroblock");
  return qp;
}

// the macroblocks of a B-VOP (io/mpeg4._parse_b_mbs)
void parse_b_mbs(Reader& br, const Vol& vol, int qp, int fcode, int bcode,
                 const int32_t* col, const Step& st, bool direct_16,
                 ParsedVop& out) {
  out.mb.assign((size_t)vol.n_mb * B_FIELDS, 0);
  const int prefix = 15 + std::max(std::max(fcode, bcode), 2);
  int pf[2] = {0, 0}, pb[2] = {0, 0};
  int16_t lv[64];
  for (int m = 0; m < vol.n_mb; ++m) {
    if (m % vol.mbw == 0) pf[0] = pf[1] = pb[0] = pb[1] = 0;
    if (!vol.resync_disable && m > 0) {
      int q = packet_header(br, vol, VOP_B, prefix, m);
      if (q >= 0) {
        qp = q;
        pf[0] = pf[1] = pb[0] = pb[1] = 0;
      }
    }
    int32_t* row = &out.mb[(size_t)m * B_FIELDS];
    const int32_t* c = col + (size_t)m * MB_FIELDS;
    row[0] = MB_INTER;
    row[1] = qp;
    if (c[0] == MB_SKIP) {
      row[3] = B_FWD;
      continue;
    }
    int cbp = 0, mb_type;
    const bool direct_skip = br.read(1);
    if (direct_skip) {
      mb_type = B_DIRECT;
    } else {
      const int modb2 = br.read(1);
      mb_type = br.vlc(g_vlc[MB_B]);
      if (!modb2) cbp = br.read(6);
      if (mb_type != B_DIRECT && cbp && br.read(1))
        qp = std::min(std::max(qp + (br.read(1) ? 4 : 0) - 2, 1), 31);
      row[1] = qp;
    }
    row[2] = cbp;
    row[3] = mb_type == B_FORWARD ? B_FWD
                                  : (mb_type == B_BACKWARD ? B_BWD
                                                           : B_FWD | B_BWD);
    if (mb_type == B_DIRECT) {
      int delta[2] = {0, 0};
      if (!direct_skip) {
        delta[0] = read_mv(br, 0, 1);
        delta[1] = read_mv(br, 0, 1);
      }
      const bool four = c[0] == MB_INTER4V;
      // direct_vectors of io/mpeg4.py; C's division truncates toward
      // zero, as the standard's
      for (int b = 0; b < 4; ++b) {
        const int s = four ? b : 0;
        for (int k = 0; k < 2; ++k) {
          const int v = c[4 + 2 * s + k], d = delta[k];
          const int fv = st.trb * v / st.trd + d;
          row[4 + 2 * b + k] = fv;
          row[12 + 2 * b + k] = d ? fv - v : (st.trb - st.trd) * v / st.trd;
        }
      }
      if (four || (vol.qpel && !direct_16)) row[3] |= B_8X8;
    }
    if (mb_type == B_FORWARD || mb_type == B_INTERP) {
      pf[0] = read_mv(br, pf[0], fcode);
      pf[1] = read_mv(br, pf[1], fcode);
      for (int b = 0; b < 4; ++b) {
        row[4 + 2 * b] = pf[0];
        row[5 + 2 * b] = pf[1];
      }
    }
    if (mb_type == B_BACKWARD || mb_type == B_INTERP) {
      pb[0] = read_mv(br, pb[0], bcode);
      pb[1] = read_mv(br, pb[1], bcode);
      for (int b = 0; b < 4; ++b) {
        row[12 + 2 * b] = pb[0];
        row[13 + 2 * b] = pb[1];
      }
    }
    for (int b = 0; b < 6; ++b) {
      if (!((cbp >> (5 - b)) & 1)) continue;
      std::memset(lv, 0, sizeof(lv));
      read_levels(br, 0, ZIGZAG, lv, 0);
      out.blocks.insert(out.blocks.end(), lv, lv + 64);
      out.bidx.push_back(m * 6 + b);
    }
  }
}

// one VOP; a B-VOP reads `col`, its future anchor's (M, MB_FIELDS) records
void parse_vop(const uint8_t* d, int64_t n, const Vol& vol, const Step& st,
               const int32_t* col, bool direct_16, ParsedVop& out) {
  Reader br{d, n * 8, find_vop(d, n)};
  out.mb.assign((size_t)vol.n_mb * MB_FIELDS, 0);
  int kind = br.read(2);
  if (kind == 3) throw Error("S-VOPs (sprites or GMC)");
  int modulo = 0;
  while (br.read(1)) {
    if (++modulo > (1 << 16)) throw Error("endless modulo_time_base");
  }
  br.marker();
  int incr = br.read(vol.tbits);
  br.marker();
  if (st.kind == VOP_SKIP || !br.read(1)) {
    int32_t v[VOP_FIELDS] = {VOP_SKIP, 0, 1, 1, modulo, incr};
    std::memcpy(out.vop, v, sizeof(v));
    return;
  }
  if (kind == 2) kind = VOP_B;
  int rounding = kind == VOP_P ? br.read(1) : 0;
  int thr = br.read(3);
  int qp = br.read(vol.qprec);
  if (qp == 0) throw Error("vop_quant 0");
  int fcode = 1, bcode = 1;
  if (kind != VOP_I) {
    fcode = br.read(3);
    if (fcode == 0) throw Error("vop_fcode_forward 0");
  }
  if (kind == VOP_B) {
    bcode = br.read(3);
    if (bcode == 0) throw Error("vop_fcode_backward 0");
  }
  int32_t v[VOP_FIELDS] = {kind, rounding, qp, fcode, modulo, incr};
  std::memcpy(out.vop, v, sizeof(v));
  if (kind == VOP_B) {
    if (!col) throw Error("a B-VOP without its future anchor");
    parse_b_mbs(br, vol, qp, fcode, bcode, col, st, direct_16, out);
    return;
  }
  Pred pred(vol);
  int prefix = kind == VOP_I ? 16 : 15 + fcode;
  int qmax = (1 << vol.qprec) - 1;
  int m = 0;
  int16_t lv[64];
  while (m < vol.n_mb) {
    if (!vol.resync_disable && m > 0) {
      int q = packet_header(br, vol, kind, prefix, m);
      if (q >= 0) {
        qp = q;
        pred.start = m;
      }
    }
    int32_t* row = &out.mb[(size_t)m * MB_FIELDS];
    int mcbpc;
    if (kind == VOP_P) {
      if (br.read(1)) {
        pred.qp[m] = qp;
        pred.intra[m] = 0;
        int z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        pred.set_mvs(m, z);
        row[1] = qp;
        ++m;
        continue;
      }
      mcbpc = br.vlc(g_vlc[MCBPC_P]);
      if (mcbpc == MCBPC_P_STUFFING) continue;
    } else {
      mcbpc = br.vlc(g_vlc[MCBPC_I]);
      if (mcbpc == MCBPC_I_STUFFING) continue;
      mcbpc += 12;
    }
    int mb_type = mcbpc >> 2, cbpc = mcbpc & 3;
    bool intra = mb_type >= 3;
    int acp = intra ? br.read(1) : 0;
    int cbpy = br.vlc(g_vlc[CBPY]);
    if (!intra) cbpy = 15 - cbpy;
    if (mb_type == 1 || mb_type == 4)
      qp = std::min(std::max(qp + DQUANT[br.read(2)], 1), qmax);
    int cbp = (cbpy << 2) | cbpc;
    pred.qp[m] = qp;
    pred.intra[m] = intra;
    int vec[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (!intra) {
      int nv = mb_type == 2 ? 4 : 1;
      for (int b = 0; b < nv; ++b) {
        int px, py;
        pred.mv_prediction(m, b, px, py);
        int vx = read_mv(br, px, fcode), vy = read_mv(br, py, fcode);
        for (int j = b; j < 4; ++j) { vec[2 * j] = vx; vec[2 * j + 1] = vy; }
        pred.set_mvs(m, vec);
      }
    }
    pred.set_mvs(m, vec);
    row[0] = intra ? MB_INTRA : (mb_type == 2 ? MB_INTER4V : MB_INTER);
    row[1] = qp; row[2] = cbp; row[3] = acp;
    for (int i = 0; i < 8; ++i) row[4 + i] = vec[i];
    bool dc_vlc = qp < DC_THR_QP[thr];
    for (int b = 0; b < 6; ++b) {
      int coded = (cbp >> (5 - b)) & 1;
      std::memset(lv, 0, sizeof(lv));
      if (!intra) {
        if (coded) {
          read_levels(br, 0, ZIGZAG, lv, 0);
          out.blocks.insert(out.blocks.end(), lv, lv + 64);
          out.bidx.push_back(m * 6 + b);
        }
        continue;
      }
      int key, pdc, top, pk;
      pred.dc_direction(m, b, key, pdc, top, pk);
      int scale = dc_scaler(qp, b < 4);
      int diff = 0;
      if (dc_vlc) {
        int size = br.vlc(g_vlc[b < 4 ? DC_L : DC_C]);
        if (size) {
          diff = br.read(size);
          if (!(diff >> (size - 1))) diff -= (1 << size) - 1;
          if (size > 8) br.marker();
        }
      }
      const int* scan = !acp ? ZIGZAG : (top ? ALT_H : ALT_V);
      if (coded) read_levels(br, 1, scan, lv, dc_vlc ? 1 : 0);
      if (!dc_vlc) diff = lv[0];
      lv[0] = (int16_t)(diff + (pdc + (scale >> 1)) / scale);
      if (acp) {
        int add[7];
        pred.ac_prediction(pk, top, qp, add);
        for (int i = 1; i < 8; ++i) lv[top ? i : 8 * i] += add[i - 1];
      }
      pred.store_intra(key, lv, scale);
      out.blocks.insert(out.blocks.end(), lv, lv + 64);
      out.bidx.push_back(m * 6 + b);
    }
    ++m;
  }
}

// ---- writing ----------------------------------------------------------------

void put_code(Writer& bw, int t, int sym) {
  bw.put(g_vlc[t].code[sym], g_vlc[t].clen[sym]);
}

void put_tcoef(Writer& bw, int t, int last, int run, int level) {
  int a = std::abs(level), sign = level < 0;
  auto idx = [&](int l, int r, int v) {
    if (r < 0 || r >= MAXRUN || v <= 0 || v >= MAXLEV) return -1;
    return g_tidx[t][l][r][v];
  };
  int i = idx(last, run, a);
  if (i >= 0) {
    bw.put(g_tcode[t][i], g_tlen[t][i]);
    bw.put(sign, 1);
    return;
  }
  if (run < MAXRUN && g_lmax[t][last][run]) {
    i = idx(last, run, a - g_lmax[t][last][run]);
    if (i >= 0) {
      bw.put(g_esc_code, g_esc_len);
      bw.put(0, 1);
      bw.put(g_tcode[t][i], g_tlen[t][i]);
      bw.put(sign, 1);
      return;
    }
  }
  if (a < MAXLEV && g_rmax[t][last][a] >= 0) {
    i = idx(last, run - g_rmax[t][last][a] - 1, a);
    if (i >= 0) {
      bw.put(g_esc_code, g_esc_len);
      bw.put(2, 2);
      bw.put(g_tcode[t][i], g_tlen[t][i]);
      bw.put(sign, 1);
      return;
    }
  }
  if (a == 0 || a > 2047 || run > 63) throw Error("event out of range");
  bw.put(g_esc_code, g_esc_len);
  bw.put(3, 2);
  bw.put(last, 1);
  bw.put(run, 6);
  bw.put(1, 1);
  bw.put((uint32_t)level & 0xFFF, 12);
  bw.put(1, 1);
}

void put_levels(Writer& bw, int t, const int* scan, const int* lv, int start) {
  int nz[64], k = 0;
  for (int i = start; i < 64; ++i)
    if (lv[scan[i]]) nz[k++] = i;
  int prev = start;
  for (int j = 0; j < k; ++j) {
    put_tcoef(bw, t, j == k - 1, nz[j] - prev, lv[scan[nz[j]]]);
    prev = nz[j] + 1;
  }
}

void put_mvd(Writer& bw, int diff, int fcode) {
  int f32 = 32 << (fcode - 1);
  diff = ((diff + f32) % (2 * f32) + 2 * f32) % (2 * f32) - f32;
  if (diff == 0) { bw.put(1, 1); return; }
  int r = fcode - 1;
  int a = std::abs(diff) - 1;
  put_code(bw, MVD, (a >> r) + 1);
  bw.put(diff < 0, 1);
  bw.put(a & ((1 << r) - 1), r);
}

void put_dc(Writer& bw, int diff, bool luma) {
  int a = std::abs(diff), size = 0;
  while ((1 << size) <= a) ++size;
  put_code(bw, luma ? DC_L : DC_C, size);
  if (size) {
    bw.put(diff > 0 ? diff : diff + (1 << size) - 1, size);
    if (size > 8) bw.put(1, 1);
  }
}

// one VOP of the encoder: no video packets, intra_dc_vlc_thr 0, no AC
// prediction (the writer of io/mpeg4.py with its defaults)
void write_vop(const int32_t* vop, const int32_t* mb, const int16_t* coef,
               const Vol& vol, std::vector<uint8_t>& out) {
  int kind = vop[0], rounding = vop[1], qp = vop[2], fcode = vop[3],
      modulo = vop[4], incr = vop[5];
  Writer bw;
  bw.put(0x1B6, 32);
  bw.put(kind == VOP_SKIP ? VOP_P : kind, 2);
  for (int i = 0; i < modulo; ++i) bw.put(1, 1);
  bw.put(0, 1);
  bw.put(1, 1);
  bw.put(incr, vol.tbits);
  bw.put(1, 1);
  if (kind == VOP_SKIP) {
    bw.put(0, 1);
    bw.stuff();
    bw.flush();
    out.swap(bw.out);
    return;
  }
  bw.put(1, 1);
  if (kind == VOP_P) bw.put(rounding, 1);
  bw.put(0, 3);
  bw.put(qp, vol.qprec);
  if (kind == VOP_P) bw.put(fcode, 3);
  Pred pred(vol);
  int sent[6][64];
  int16_t lv16[64];
  for (int m = 0; m < vol.n_mb; ++m) {
    const int32_t* row = mb + (size_t)m * MB_FIELDS;
    const int16_t* lv = coef + (size_t)m * 6 * 64;
    int mode = row[0], mqp = row[1];
    bool anyv = false, anyl = false, four = false;
    for (int i = 0; i < 8; ++i) anyv |= row[4 + i] != 0;
    for (int i = 0; i < 6 * 64; ++i) anyl |= lv[i] != 0;
    for (int b = 1; b < 4; ++b)
      four |= row[4 + 2 * b] != row[4] || row[5 + 2 * b] != row[5];
    if (kind == VOP_P && (mode == MB_SKIP ||
                          (mode == MB_INTER && !anyv && !anyl))) {
      bw.put(1, 1);
      pred.qp[m] = qp;
      pred.intra[m] = 0;
      int z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      pred.set_mvs(m, z);
      continue;
    }
    bool intra = mode == MB_INTRA || kind == VOP_I;
    int dq = mqp - qp;
    int dqi = -1;
    for (int i = 0; i < 4; ++i)
      if (DQUANT[i] == dq) dqi = i;
    if (dq && dqi < 0) throw Error("qp step is no DQUANT step");
    four = four && !intra;
    if (four && dq) throw Error("four vectors and DQUANT");
    qp = mqp;
    pred.qp[m] = qp;
    pred.intra[m] = intra;
    for (int b = 0; b < 6; ++b)
      for (int i = 0; i < 64; ++i) sent[b][i] = lv[b * 64 + i];
    int cbp = 0;
    if (intra) {
      int z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      pred.set_mvs(m, z);
      for (int b = 0; b < 6; ++b) {
        int key, pdc, top, pk;
        pred.dc_direction(m, b, key, pdc, top, pk);
        int scale = dc_scaler(qp, b < 4);
        sent[b][0] -= (pdc + (scale >> 1)) / scale;
        std::memcpy(lv16, lv + b * 64, sizeof(lv16));
        pred.store_intra(key, lv16, scale);
        bool any = false;
        for (int i = 1; i < 64; ++i) any |= sent[b][i] != 0;
        cbp |= (int)any << (5 - b);
      }
    } else {
      for (int b = 0; b < 6; ++b) {
        bool any = false;
        for (int i = 0; i < 64; ++i) any |= sent[b][i] != 0;
        cbp |= (int)any << (5 - b);
      }
    }
    int mb_type = (intra ? 3 : (four ? 2 : 0)) + (dq ? 1 : 0);
    if (kind == VOP_P) {
      bw.put(0, 1);
      put_code(bw, MCBPC_P, 4 * mb_type + (cbp & 3));
    } else {
      put_code(bw, MCBPC_I, 4 * (mb_type - 3) + (cbp & 3));
    }
    if (intra) bw.put(0, 1);  // ac_pred_flag
    put_code(bw, CBPY, intra ? (cbp >> 2) : 15 - (cbp >> 2));
    if (dq) bw.put(dqi, 2);
    if (!intra) {
      int vec[8];
      int nv = four ? 4 : 1;
      for (int b = 0; b < nv; ++b) {
        int px, py;
        pred.mv_prediction(m, b, px, py);
        put_mvd(bw, row[4 + 2 * b] - px, fcode);
        put_mvd(bw, row[5 + 2 * b] - py, fcode);
        for (int j = 0; j < 4; ++j) {
          int s = j < b ? j : b;
          vec[2 * j] = row[4 + 2 * s];
          vec[2 * j + 1] = row[5 + 2 * s];
        }
        pred.set_mvs(m, vec);
      }
      for (int j = 0; j < 4; ++j) {
        int s = four ? j : 0;
        vec[2 * j] = row[4 + 2 * s];
        vec[2 * j + 1] = row[5 + 2 * s];
      }
      pred.set_mvs(m, vec);
    }
    for (int b = 0; b < 6; ++b) {
      if (intra) {
        put_dc(bw, sent[b][0], b < 4);
        if ((cbp >> (5 - b)) & 1) put_levels(bw, 1, ZIGZAG, sent[b], 1);
      } else if ((cbp >> (5 - b)) & 1) {
        put_levels(bw, 0, ZIGZAG, sent[b], 0);
      }
    }
  }
  bw.stuff();
  bw.flush();
  out.swap(bw.out);
}

// ---- handles -------------------------------------------------------------------

struct Handle {
  virtual ~Handle() = default;
  std::string error;
};

struct ParseHandle : Handle {
  std::vector<ParsedVop> vops;
  std::vector<int> kinds;  // the parsed record kind of each VOP
  int n_mb = 0;
};

struct WriteHandle : Handle {
  std::vector<std::vector<uint8_t>> out;
};

template <typename F>
void parallel(int n, int threads, F fn) {
  threads = std::max(1, std::min(threads, n));
  std::atomic<int> next{0};
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t)
    pool.emplace_back([&] {
      for (int i = next++; i < n; i = next++) fn(i);
    });
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// table: 0..7 as enum Table; sym -1 is the TCOEF escape. For TCOEF tables
// sym = last << 16 | run << 8 | level.
int mpeg4_set_vlc(int table, int n, const int32_t* codes,
                  const int32_t* lens, const int32_t* syms) {
  if (table < 0 || table >= N_TABLES) return 1;
  Vlc& v = g_vlc[table];
  v.bits = 0;
  for (int i = 0; i < n; ++i) v.bits = std::max(v.bits, (int)lens[i]);
  v.sym.assign((size_t)1 << v.bits, 0);
  v.len.assign((size_t)1 << v.bits, 0);
  v.code.assign(n, 0);
  v.clen.assign(n, 0);
  bool tcoef = table == T_INTER || table == T_INTRA;
  int t = table == T_INTRA ? 1 : 0;
  if (tcoef) {
    for (int l = 0; l < 2; ++l) {
      for (int r = 0; r < MAXRUN; ++r) {
        g_lmax[t][l][r] = 0;
        for (int k = 0; k < MAXLEV; ++k) g_tidx[t][l][r][k] = -1;
      }
      for (int k = 0; k < MAXLEV; ++k) g_rmax[t][l][k] = -1;
    }
  }
  for (int i = 0; i < n; ++i) {
    uint32_t lo = (uint32_t)codes[i] << (v.bits - lens[i]);
    for (uint32_t j = lo; j < lo + (1u << (v.bits - lens[i])); ++j) {
      if (v.len[j]) return 2;  // overlapping codes
      v.sym[j] = syms[i];
      v.len[j] = (uint8_t)lens[i];
    }
    if (!tcoef) {
      if (syms[i] < 0 || syms[i] >= n) return 3;
      v.code[syms[i]] = codes[i];
      v.clen[syms[i]] = (uint8_t)lens[i];
    } else if (syms[i] == ESC) {
      g_esc_code = codes[i];
      g_esc_len = lens[i];
    } else {
      int l = syms[i] >> 16, r = (syms[i] >> 8) & 255, lev = syms[i] & 255;
      if (i >= 128 || r >= MAXRUN || lev >= MAXLEV) return 4;
      g_tidx[t][l][r][lev] = i;
      g_tcode[t][i] = codes[i];
      g_tlen[t][i] = (uint8_t)lens[i];
      g_lmax[t][l][r] = std::max(g_lmax[t][l][r], lev);
      g_rmax[t][l][lev] = std::max(g_rmax[t][l][lev], r);
    }
  }
  for (int p = 0; p < 64; ++p) ALT_V[p] = (ALT_H[p] % 8) * 8 + ALT_H[p] / 8;
  return 0;
}

// Parse n VOPs (sample i at data + offsets[i], sizes[i] bytes) as `plan`
// (n rows kind, TRB, TRD; io/mpeg4.plan_stream) says: the I- and P-VOPs
// (and the VOPs only read for their header) on threads, then the B-VOPs,
// each with the records of the last anchor before it, which must lie in
// the batch. counts gets the anchors' coded blocks, the B-VOPs' coded
// blocks and the B-VOPs. Returns a handle for mpeg4_parse_fetch; a parse
// error leaves its message in mpeg4_error.
void* mpeg4_parse(const uint8_t* data, const int64_t* offsets,
                  const int64_t* sizes, int n, const int32_t* vol_fields,
                  const int32_t* plan, int direct_16, int threads,
                  int64_t* counts) {
  auto* h = new ParseHandle();
  Vol vol(vol_fields);
  h->n_mb = vol.n_mb;
  h->vops.resize(n);
  std::vector<Step> steps(n);
  std::vector<int> anchor(n, -1);  // the last I/P-VOP before each VOP
  int last = -1;
  for (int i = 0; i < n; ++i) {
    steps[i] = Step{plan[3 * i], plan[3 * i + 1], plan[3 * i + 2]};
    anchor[i] = last;
    if (steps[i].kind == VOP_I || steps[i].kind == VOP_P) last = i;
  }
  for (int wave = 0; wave < 2; ++wave) {
    std::vector<int> todo;
    for (int i = 0; i < n; ++i)
      if ((steps[i].kind == VOP_B) == (wave == 1)) todo.push_back(i);
    parallel((int)todo.size(), threads, [&](int t) {
      const int i = todo[t];
      try {
        const int a = anchor[i];
        const int32_t* col = nullptr;
        if (steps[i].kind == VOP_B) {
          if (a < 0 || !h->vops[a].error.empty())
            throw Error("a B-VOP without its future anchor");
          col = h->vops[a].mb.data();
        }
        parse_vop(data + offsets[i], sizes[i], vol, steps[i], col,
                  direct_16 != 0, h->vops[i]);
      } catch (const std::exception& e) {
        h->vops[i].error = "VOP " + std::to_string(i) + ": " + e.what();
      }
    });
  }
  int64_t nb = 0, nbb = 0, fb = 0;
  h->kinds.resize(n);
  for (int i = 0; i < n; ++i) {
    auto& v = h->vops[i];
    if (!v.error.empty() && h->error.empty()) h->error = v.error;
    h->kinds[i] = v.error.empty() ? v.vop[0] : VOP_SKIP;
    if (h->kinds[i] == VOP_B) {
      nbb += (int64_t)v.bidx.size();
      ++fb;
    } else {
      nb += (int64_t)v.bidx.size();
    }
  }
  counts[0] = nb;
  counts[1] = nbb;
  counts[2] = fb;
  return h;
}

// The records: vop (n, VOP_FIELDS); mb (n, M, MB_FIELDS) (zero for
// B-VOPs); the anchors' blocks and flat indices; bmb (FB, M, B_FIELDS),
// the B-VOPs' blocks and flat indices j * M * 6 + m * 6 + b.
int mpeg4_parse_fetch(void* handle, int32_t* vop, int32_t* mb,
                      int16_t* blocks, int32_t* bidx, int32_t* bmb,
                      int16_t* bblocks, int32_t* bbidx) {
  auto* h = static_cast<ParseHandle*>(handle);
  if (!h->error.empty()) return 1;
  int64_t nb = 0, nbb = 0, j = 0;
  const int64_t per = (int64_t)h->n_mb * MB_FIELDS;
  const int64_t bper = (int64_t)h->n_mb * B_FIELDS;
  for (size_t f = 0; f < h->vops.size(); ++f) {
    const ParsedVop& v = h->vops[f];
    std::memcpy(vop + f * VOP_FIELDS, v.vop, sizeof(v.vop));
    if (h->kinds[f] == VOP_B) {
      std::memset(mb + f * per, 0, per * sizeof(int32_t));
      std::memcpy(bmb + j * bper, v.mb.data(), bper * sizeof(int32_t));
      std::memcpy(bblocks + nbb * 64, v.blocks.data(),
                  v.blocks.size() * sizeof(int16_t));
      const int32_t base = (int32_t)(j * h->n_mb * 6);
      for (size_t k = 0; k < v.bidx.size(); ++k)
        bbidx[nbb + k] = base + v.bidx[k];
      nbb += (int64_t)v.bidx.size();
      ++j;
      continue;
    }
    if (h->kinds[f] == VOP_SKIP || v.mb.empty())
      std::memset(mb + f * per, 0, per * sizeof(int32_t));
    else
      std::memcpy(mb + f * per, v.mb.data(), per * sizeof(int32_t));
    std::memcpy(blocks + nb * 64, v.blocks.data(),
                v.blocks.size() * sizeof(int16_t));
    int32_t base = (int32_t)(f * h->n_mb * 6);
    for (size_t k = 0; k < v.bidx.size(); ++k)
      bidx[nb + k] = base + v.bidx[k];
    nb += (int64_t)v.bidx.size();
  }
  return 0;
}

// Write n VOPs from records vop (n, 6), mb (n, M, 12), coef (n, M, 6, 64).
// total[0] gets the bytes of all samples.
void* mpeg4_write(const int32_t* vop, const int32_t* mb, const int16_t* coef,
                  int n, const int32_t* vol_fields, int threads,
                  int64_t* total) {
  auto* h = new WriteHandle();
  Vol vol(vol_fields);
  h->out.resize(n);
  std::vector<std::string> errs(n);
  parallel(n, threads, [&](int i) {
    try {
      write_vop(vop + (size_t)i * VOP_FIELDS,
                mb + (size_t)i * vol.n_mb * MB_FIELDS,
                coef + (size_t)i * vol.n_mb * 6 * 64, vol, h->out[i]);
    } catch (const std::exception& e) {
      errs[i] = "VOP " + std::to_string(i) + ": " + e.what();
    }
  });
  int64_t s = 0;
  for (int i = 0; i < n; ++i) {
    if (!errs[i].empty() && h->error.empty()) h->error = errs[i];
    s += (int64_t)h->out[i].size();
  }
  total[0] = s;
  return h;
}

int mpeg4_write_fetch(void* handle, uint8_t* out, int64_t* sizes) {
  auto* h = static_cast<WriteHandle*>(handle);
  if (!h->error.empty()) return 1;
  int64_t pos = 0;
  for (size_t i = 0; i < h->out.size(); ++i) {
    std::memcpy(out + pos, h->out[i].data(), h->out[i].size());
    sizes[i] = (int64_t)h->out[i].size();
    pos += sizes[i];
  }
  return 0;
}

const char* mpeg4_error(void* handle) {
  return static_cast<Handle*>(handle)->error.c_str();
}

int mpeg4_free(void* handle) {
  delete static_cast<Handle*>(handle);
  return 0;
}

}  // extern "C"

#ifdef __CUDACC__

namespace {

__constant__ int kFdct[64] = {
    2896, 2896, 2896, 2896, 2896, 2896, 2896, 2896,
    4017, 3406, 2276, 799, -799, -2276, -3406, -4017,
    3784, 1567, -1567, -3784, -3784, -1567, 1567, 3784,
    3406, -799, -4017, -2276, 2276, 4017, 799, -3406,
    2896, -2896, -2896, 2896, 2896, -2896, -2896, 2896,
    2276, -4017, 799, 3406, -3406, -799, 4017, -2276,
    1567, -3784, 3784, -1567, -1567, 3784, -3784, 1567,
    799, -2276, 3406, -4017, 4017, -3406, 2276, -799};

__device__ __forceinline__ int d_dc_scaler(int qp, bool luma) {
  if (qp < 5) return 8;
  if (luma) return qp < 9 ? 2 * qp : (qp < 25 ? qp + 8 : 2 * qp - 16);
  return qp < 25 ? (qp + 13) / 2 : qp - 6;
}

// the value stored to int16 and read back (the C code's int16 rows)
template <typename T>
__device__ __forceinline__ int d_wrap16(T v) {
  return (int)(int16_t)(uint16_t)(v & 0xFFFF);
}

// V1: H.263 inverse quantisation and FFmpeg's "simple" IDCT of the coded
// blocks of a batch, each into row bidx[j] of the output. It replaces no
// TPU kernel: the JAX package hands mp4v decoding to cv2
// (faceoff_tpu/io/video.py:61). Bound by bytes (128 in and 128 out a
// block) and then by the integer multiplies, about 64 a row. A thread
// takes RPT rows, 8 / RPT threads a block, BPB blocks a CUDA block: one
// 16-byte load of each row's levels, issued before the block's bidx and
// record (each one broadcast request, the record's mode and qp one 8-byte
// word; the first form made eight scalar loads and the bidx and record
// chain on every thread); the row pass in int32 (the DC-only shortcut
// read from the levels); the rows through a padded tile in shared memory
// (one warp, no barrier) to the thread's columns, two read as one word.
// The column pass runs in int32 where the column certifies it: every
// |input| <= COL_SAFE keeps each partial sum below 2^31 (122424 * 17537 +
// 524256 < 2^31; the bound is reached, tests/test_torch_mpeg4_arith.py),
// else in 64 bits as the plain version (the first form ran every column in
// 64 bits). The columns go back through the tile so that each row leaves
// as one 16-byte store.
constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873,
              W6 = 8867, W7 = 4520;
constexpr int COL_SAFE = 17537;
constexpr int IDCT_TILE = 72;  // int16 of a block's tile: 8 rows of 8 and
                               // 16 bytes that put the tiles of a warp on
                               // distinct banks

// The simple IDCT's butterfly on one row or column x in T (int or 64
// bits): o[i] = (sum_i) >> SHIFT, wrapped to int16; `a` is the first
// even term with its rounding (W4 x0 + 2^10 in rows, W4 (x0 + 32) in
// columns).
template <typename T, int SHIFT>
__device__ __forceinline__ void idct8(const T (&x)[8], T a, int (&o)[8]) {
  const T a0 = a + W2 * x[2] + W4 * x[4] + W6 * x[6];
  const T a1 = a + W6 * x[2] - W4 * x[4] - W2 * x[6];
  const T a2 = a - W6 * x[2] - W4 * x[4] + W2 * x[6];
  const T a3 = a - W2 * x[2] + W4 * x[4] - W6 * x[6];
  const T b0 = W1 * x[1] + W3 * x[3] + W5 * x[5] + W7 * x[7];
  const T b1 = W3 * x[1] - W7 * x[3] - W1 * x[5] - W5 * x[7];
  const T b2 = W5 * x[1] - W1 * x[3] + W7 * x[5] + W3 * x[7];
  const T b3 = W7 * x[1] - W5 * x[3] + W3 * x[5] - W1 * x[7];
  o[0] = d_wrap16((a0 + b0) >> SHIFT);
  o[1] = d_wrap16((a1 + b1) >> SHIFT);
  o[2] = d_wrap16((a2 + b2) >> SHIFT);
  o[3] = d_wrap16((a3 + b3) >> SHIFT);
  o[4] = d_wrap16((a3 - b3) >> SHIFT);
  o[5] = d_wrap16((a2 - b2) >> SHIFT);
  o[6] = d_wrap16((a1 - b1) >> SHIFT);
  o[7] = d_wrap16((a0 - b0) >> SHIFT);
}

__device__ __forceinline__ uint4 pack16(const int (&v)[8]) {
  uint4 p;
  p.x = (uint16_t)v[0] | ((unsigned)(uint16_t)v[1] << 16);
  p.y = (uint16_t)v[2] | ((unsigned)(uint16_t)v[3] << 16);
  p.z = (uint16_t)v[4] | ((unsigned)(uint16_t)v[5] << 16);
  p.w = (uint16_t)v[6] | ((unsigned)(uint16_t)v[7] << 16);
  return p;
}

// one row of levels (a 16-byte word) dequantised, then the row pass;
// with `intra_dc`, x[0] is `dc` (row 0 of an intra block)
__device__ __forceinline__ void dequant_row(uint4 lv, int qp, bool intra_dc,
                                            int dc, int (&row)[8]) {
  const unsigned lw[4] = {lv.x, lv.y, lv.z, lv.w};
  // |F| = qp (2 |l| + 1) - (1 - (qp & 1)) = 2 qp |l| + c0
  const int c0 = qp - 1 + (qp & 1);
  int x[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const unsigned w = lw[c >> 1];
    const int l = (c & 1) ? (int)w >> 16 : (int)(int16_t)(w & 0xFFFF);
    const int mag = min(2 * qp * abs(l) + c0, l < 0 ? 2048 : 2047);
    x[c] = l == 0 ? 0 : (l < 0 ? -mag : mag);
  }
  if (intra_dc) x[0] = dc;
  if (((lv.x >> 16) | lv.y | lv.z | lv.w) == 0) {  // DC only
#pragma unroll
    for (int c = 0; c < 8; ++c) row[c] = x[0] * 8;
  } else {
    idct8<int, 11>(x, W4 * x[0] + (1 << 10), row);
  }
}

// the column pass on one column, in int32 where COL_SAFE certifies it
__device__ __forceinline__ void idct_column(const int (&y)[8], int (&o)[8]) {
  int big = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) big = max(big, abs(y[k]));
  if (big <= COL_SAFE) {
    idct8<int, 20>(y, W4 * (y[0] + 32), o);
  } else {
    long long z[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) z[k] = y[k];
    idct8<long long, 20>(z, (long long)W4 * (z[0] + 32), o);
  }
}

// MPEG quantisation's matrices (intra, then inter; raster), sent once a
// VOL by mpeg4_set_matrices
__constant__ uint16_t kMatrix[128];

// one row r of levels (a 16-byte word) dequantised by MPEG rules
// (ops/mpeg4_cuda.dequantize_mpeg_plain): F = (2 l + k) W qp / 16,
// truncated toward zero, k = 0 intra and sign(l) inter, saturated; with
// `intra_dc`, x[0] is `dc`
__device__ __forceinline__ void mpeg_row(uint4 lv, int r, int qp, bool intra,
                                         bool intra_dc, int dc,
                                         int (&x)[8]) {
  const unsigned lw[4] = {lv.x, lv.y, lv.z, lv.w};
  const uint16_t* w = kMatrix + (intra ? 0 : 64) + 8 * r;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const unsigned u = lw[c >> 1];
    const int l = (c & 1) ? (int)u >> 16 : (int)(int16_t)(u & 0xFFFF);
    const int a = abs(l);
    const int mag = min(((2 * a + (intra ? 0 : 1)) * w[c] * qp) >> 4,
                        l < 0 ? 2048 : 2047);
    x[c] = l == 0 ? 0 : (l < 0 ? -mag : mag);
  }
  if (intra_dc) x[0] = dc;
}

// the row pass on dequantised values x, DC-only rows by the shortcut
__device__ __forceinline__ void row_pass(const int (&x)[8], int (&row)[8]) {
  if ((x[1] | x[2] | x[3] | x[4] | x[5] | x[6] | x[7]) == 0) {
#pragma unroll
    for (int c = 0; c < 8; ++c) row[c] = x[0] * 8;
  } else {
    idct8<int, 11>(x, W4 * x[0] + (1 << 10), row);
  }
}

// FFmpeg's Xvid IDCT (ops/mpeg4_cuda.idct_xvid_plain), which decodes
// Xvid's streams: a row pass with a table and a rounding term a row, in
// 32-bit wrapping arithmetic as the C code's unsigned sums
__constant__ int kXvidTab[4][7] = {
    {22725, 21407, 19266, 16384, 12873, 8867, 4520},
    {31521, 29692, 26722, 22725, 17855, 12299, 6270},
    {29692, 27969, 25172, 21407, 16819, 11585, 5906},
    {26722, 25172, 22654, 19266, 15137, 10426, 5315}};
__constant__ int kXvidRowTab[8] = {0, 1, 2, 3, 0, 3, 2, 1};
__constant__ int kXvidRnd[8] = {65536, 3597, 2260, 1203, 0, 120, 512, 512};

__device__ __forceinline__ void xvid_row(const int (&x)[8], int r,
                                         int (&o)[8]) {
  const int* c = kXvidTab[kXvidRowTab[r]];
  const unsigned c1 = c[0], c2 = c[1], c3 = c[2], c4 = c[3], c5 = c[4],
                 c6 = c[5], c7 = c[6];
  unsigned u[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) u[i] = (unsigned)x[i];
  const unsigned k = c4 * u[0] + (unsigned)kXvidRnd[r];
  const unsigned a0 = k + c2 * u[2] + c4 * u[4] + c6 * u[6];
  const unsigned a1 = k + c6 * u[2] - c4 * u[4] - c2 * u[6];
  const unsigned a2 = k - c6 * u[2] - c4 * u[4] + c2 * u[6];
  const unsigned a3 = k - c2 * u[2] + c4 * u[4] - c6 * u[6];
  const unsigned b0 = c1 * u[1] + c3 * u[3] + c5 * u[5] + c7 * u[7];
  const unsigned b1 = c3 * u[1] - c7 * u[3] - c1 * u[5] - c5 * u[7];
  const unsigned b2 = c5 * u[1] - c1 * u[3] + c7 * u[5] + c3 * u[7];
  const unsigned b3 = c7 * u[1] - c5 * u[3] + c3 * u[5] - c1 * u[7];
  o[0] = d_wrap16((int)(a0 + b0) >> 11);
  o[1] = d_wrap16((int)(a1 + b1) >> 11);
  o[2] = d_wrap16((int)(a2 + b2) >> 11);
  o[3] = d_wrap16((int)(a3 + b3) >> 11);
  o[4] = d_wrap16((int)(a3 - b3) >> 11);
  o[5] = d_wrap16((int)(a2 - b2) >> 11);
  o[6] = d_wrap16((int)(a1 - b1) >> 11);
  o[7] = d_wrap16((int)(a0 - b0) >> 11);
}

// (int)(c * (unsigned)x) >> 16, the C code's MULT
__device__ __forceinline__ int xmult(unsigned c, int x) {
  return (int)(c * (unsigned)x) >> 16;
}

// the Xvid column pass on one column (rows 0 .. 7 of y)
__device__ __forceinline__ void xvid_column(const int (&y)[8], int (&o)[8]) {
  constexpr unsigned TAN1 = 0x32EC, TAN2 = 0x6A0A, TAN3 = 0xAB0E,
                     SQRT2 = 0x5A82;
  int m0 = xmult(TAN1, y[7]) + y[1];
  int m1 = xmult(TAN1, y[1]) - y[7];
  const int m2 = xmult(TAN3, y[5]) + y[3];
  const int m3 = xmult(TAN3, y[3]) - y[5];
  const int m7 = m0 + m2, m4 = m1 - m3;
  m0 = m0 - m2;
  m1 = m1 + m3;
  const int m6 = 2 * xmult(SQRT2, m0 + m1), m5 = 2 * xmult(SQRT2, m0 - m1);
  const int e3 = xmult(TAN2, y[6]) + y[2], e2 = xmult(TAN2, y[2]) - y[6];
  const int e0 = y[0] + y[4], e1 = y[0] - y[4];
  const int t0 = e0 + e3, t3 = e0 - e3, t1 = e1 + e2, t2 = e1 - e2;
  o[0] = d_wrap16((t0 + m7) >> 6);
  o[7] = d_wrap16((t0 - m7) >> 6);
  o[3] = d_wrap16((t3 + m4) >> 6);
  o[4] = d_wrap16((t3 - m4) >> 6);
  o[1] = d_wrap16((t1 + m6) >> 6);
  o[6] = d_wrap16((t1 - m6) >> 6);
  o[2] = d_wrap16((t2 + m5) >> 6);
  o[5] = d_wrap16((t2 - m5) >> 6);
}

// FIELDS is the record's stride (MB_FIELDS for I- and P-VOPs, B_FIELDS
// for B-VOPs); MPEG selects MPEG quantisation with mismatch control on
// inter blocks (the sum of a block's values is reduced over its TPB
// threads by shuffles; the thread of row 7 flips coefficient 63); XVID
// the Xvid IDCT. (The defaults are the mp4v path's form.)
template <int BPB, int RPT, int FIELDS = MB_FIELDS, bool MPEG = false,
          bool XVID = false>
__global__ void __launch_bounds__(8 / RPT * BPB)
dequant_idct_kernel(const int16_t* __restrict__ blocks,
                    const int32_t* __restrict__ bidx, int nb,
                    const int32_t* __restrict__ mb,
                    int16_t* __restrict__ out) {
  constexpr int TPB = 8 / RPT;  // threads a block
  static_assert(RPT == 1 || RPT == 2, "a row or two a thread");
  static_assert(BPB * TPB % 32 == 0, "whole warps");
  __shared__ __align__(16) int16_t tile[BPB * IDCT_TILE];
  const int t = threadIdx.x, r0 = (t % TPB) * RPT;
  const int j = blockIdx.x * BPB + t / TPB;
  const bool live = j < nb;
  int16_t* tl = tile + (t / TPB) * IDCT_TILE;
  const uint4* src = reinterpret_cast<const uint4*>(blocks + (size_t)j * 64);
  uint4 lv[RPT];
  int idx = 0;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
    lv[i] = live ? src[r0 + i] : make_uint4(0, 0, 0, 0);
  if (live) idx = bidx[j];
  int qp = 1, dc = 0;
  bool intra = false, intra_dc = false;
  if (live) {
    const int2 rec = *reinterpret_cast<const int2*>(
        mb + (size_t)(idx / 6) * FIELDS);
    qp = rec.y;
    intra = rec.x == MB_INTRA;
    intra_dc = r0 == 0 && intra;
    dc = min(max((int)(int16_t)(lv[0].x & 0xFFFF) *
                     d_dc_scaler(qp, idx % 6 < 4), -2048), 2047);
  }
  if constexpr (MPEG) {
    int x[RPT][8];
    int sum = 0;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      mpeg_row(lv[i], r0 + i, qp, intra, i == 0 && intra_dc, dc, x[i]);
#pragma unroll
      for (int c = 0; c < 8; ++c) sum += x[i][c];
    }
#pragma unroll
    for (int off = 1; off < TPB; off <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (!intra && r0 + RPT - 1 == 7 && (sum & 1) == 0) x[RPT - 1][7] ^= 1;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      int row[8];
      if (XVID)
        xvid_row(x[i], r0 + i, row);
      else
        row_pass(x[i], row);
      reinterpret_cast<uint4*>(tl)[r0 + i] = pack16(row);
    }
  } else if (XVID) {
    // H.263 dequantisation, the Xvid row pass
    const int c0 = qp - 1 + (qp & 1);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const unsigned lw[4] = {lv[i].x, lv[i].y, lv[i].z, lv[i].w};
      int x[8], row[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const unsigned w = lw[c >> 1];
        const int l = (c & 1) ? (int)w >> 16 : (int)(int16_t)(w & 0xFFFF);
        const int mag = min(2 * qp * abs(l) + c0, l < 0 ? 2048 : 2047);
        x[c] = l == 0 ? 0 : (l < 0 ? -mag : mag);
      }
      if (i == 0 && intra_dc) x[0] = dc;
      xvid_row(x, r0 + i, row);
      reinterpret_cast<uint4*>(tl)[r0 + i] = pack16(row);
    }
  } else {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      int row[8];
      dequant_row(lv[i], qp, i == 0 && intra_dc, dc, row);
      reinterpret_cast<uint4*>(tl)[r0 + i] = pack16(row);
    }
  }
  __syncwarp();
  // columns r0 .. r0 + RPT - 1 (two read as one word)
  int y[RPT][8], o[RPT][8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (RPT == 2) {
      const unsigned w = *reinterpret_cast<const unsigned*>(tl + k * 8 + r0);
      y[0][k] = (int)(int16_t)(w & 0xFFFF);
      y[RPT - 1][k] = (int)w >> 16;
    } else {
      y[0][k] = tl[k * 8 + r0];
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (XVID)
      xvid_column(y[i], o[i]);
    else
      idct_column(y[i], o[i]);
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (RPT == 2)
      *reinterpret_cast<unsigned*>(tl + k * 8 + r0) =
          (uint16_t)o[0][k] | ((unsigned)(uint16_t)o[RPT - 1][k] << 16);
    else
      tl[k * 8 + r0] = (int16_t)o[0][k];
  }
  __syncwarp();
  if (live)
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      reinterpret_cast<uint4*>(out + (size_t)idx * 64)[r0 + i] =
          reinterpret_cast<const uint4*>(tl)[r0 + i];
}

// the chroma vector (half pels) from the sum s of the four luma vectors:
// Table 7-9's rounding of s & 15 (0, 0, 0, 1 x 11, 2, 2) by two compares
__device__ __forceinline__ int chroma_vector(int s) {
  const int q = s & 15;
  return (q >= 3) + (q >= 14) + ((s >> 3) & ~1);
}

// V2: the half-pel prediction of one VOP of every GOP from its reference
// slot plus the residual, clipped to 8 bits. It replaces no TPU kernel:
// cv2's mp4v decoding (faceoff_tpu/io/video.py:61) and the encoder's
// prediction and reconstruction. Bound by bytes: a macroblock's residual
// (768), output (384) and reference (384 and the half-pel margins)
// against a few integer operations a pixel. The first form (a thread a
// pixel) put three dependent loads (item, record, taps) and byte-wide
// accesses in front of every pixel; a first redesign (a thread a row of
// one 8 x 8 block, a macroblock's rows in consecutive lanes) made each
// warp-wide reference load touch 32 picture rows, 32 L1 lines a request.
// Here a thread makes ROWS rows of 8 pixels, and the lanes of a warp walk
// along picture rows: MPB macroblocks in raster order a CUDA block, luma
// lanes (macroblock, left or right half) for each group of rows, then
// chroma lanes (macroblock) for each plane and group of rows, so that a
// warp's reference loads and 8-byte stores cover a few lines. The item is
// read once a thread (one broadcast request); the block's records and
// residual are loaded coalesced into shared memory (the residual padded,
// MC_RES_MB, so that a warp's luma lanes read distinct banks). A
// reference row of an interior block is three aligned words moved to the
// vector's byte offset by funnel shifts; a row whose 9 bytes cross the
// picture's edge is read a byte at a time, each tap clamped into the
// width x height picture. All four half-pel phases take one branch-free
// four-tap average in 16-bit lanes, (a + b + c + d + 2 - rnd) >> 2, the
// second column (row) repeating the first where the x (y) phase is 0:
// that equals the two- and one-tap averages for both rounding types
// (tests/test_torch_mpeg4_arith.py). RES is 1 with a residual, 0 without
// (the encoder's prediction); the two calls take their own shapes
// (MC_RES_*, MC_PRED_*).
template <int ROWS, int MPB>
struct McShape {
  static_assert(8 % ROWS == 0, "rows tile an 8 x 8 block");
  static constexpr int LUMA = 2 * MPB * 16 / ROWS;   // (rows, mb, half)
  static constexpr int CHROMA = 2 * MPB * 8 / ROWS;  // (plane, rows, mb)
  static constexpr int THREADS = LUMA + CHROMA;
};
// 16-byte units of a macroblock's residual in shared memory: 6 blocks of
// 9 (8 rows and a pad) and 4 more, so that 8 luma lanes (4 macroblocks,
// both halves) fall on distinct banks
constexpr int MC_RES_BLOCK = 9, MC_RES_MB = 58;

// a reference row's bytes x .. x + 7 (a) and x + 1 .. x + 8 (b), two
// words each
struct RefRow {
  uint32_t a0, a1, b0, b1;
};

__device__ __forceinline__ RefRow ref_row(const uint8_t* __restrict__ row,
                                          int x, int w, bool interior) {
  uint32_t w0, w1, w2;
  int sh;
  if (interior) {  // x .. x + 8 inside [0, w): three aligned words
    const uint32_t* p = reinterpret_cast<const uint32_t*>(row + (x & ~3));
    w0 = p[0];
    w1 = p[1];
    w2 = p[2];
    sh = 8 * (x & 3);
  } else {
    uint32_t b[3] = {0, 0, 0};
#pragma unroll
    for (int c = 0; c < 9; ++c)
      b[c >> 2] |= (uint32_t)row[min(max(x + c, 0), w - 1)] << (8 * (c & 3));
    w0 = b[0];
    w1 = b[1];
    w2 = b[2];
    sh = 0;
  }
  RefRow r;
  r.a0 = __funnelshift_r(w0, w1, sh);
  r.a1 = __funnelshift_r(w1, w2, sh);
  r.b0 = __funnelshift_rc(w0, w1, sh + 8);
  r.b1 = __funnelshift_rc(w1, w2, sh + 8);
  return r;
}

// (a + b + c + d + k) >> 2 of four bytes at once: bytes 0, 1 in the 16-bit
// lanes of `lo`, bytes 2, 3 in those of `hi` (each lane below 1024 before
// the shift; the bits a lane's shift takes from the next lie above its
// byte)
__device__ __forceinline__ void hpel4(uint32_t a, uint32_t b, uint32_t c,
                                      uint32_t d, uint32_t k, uint32_t& lo,
                                      uint32_t& hi) {
  lo = (__byte_perm(a, 0, 0x4140) + __byte_perm(b, 0, 0x4140) +
        __byte_perm(c, 0, 0x4140) + __byte_perm(d, 0, 0x4140) + k) >> 2;
  hi = (__byte_perm(a, 0, 0x4342) + __byte_perm(b, 0, 0x4342) +
        __byte_perm(c, 0, 0x4342) + __byte_perm(d, 0, 0x4342) + k) >> 2;
}

// four predicted bytes (lanes of hpel4) plus four int16 residuals (two
// words), each clipped to [0, 255], packed, in 16-bit lanes with Hopper's
// DPX operations: the residual first clamped to [-256, 255] (so p + r
// stays inside int16, and the clip of p + r for p in [0, 255] is
// unchanged), then max(min(p + r, 255), 0)
__device__ __forceinline__ uint32_t add_clip4(uint32_t lo, uint32_t hi,
                                              uint32_t r01, uint32_t r23) {
  const unsigned lo255 = 0x00FF00FFu, neg256 = 0xFF00FF00u;
  const unsigned a = __vimin3_s16x2(__vimax3_s16x2(r01, neg256, neg256),
                                    lo255, lo255);
  const unsigned b = __vimin3_s16x2(__vimax3_s16x2(r23, neg256, neg256),
                                    lo255, lo255);
  return __byte_perm(__viaddmin_s16x2_relu(lo & lo255, a, lo255),
                     __viaddmin_s16x2_relu(hi & lo255, b, lo255), 0x6420);
}

template <int ROWS, int MPB, int RES>
__global__ void __launch_bounds__(McShape<ROWS, MPB>::THREADS)
motion_compensate_kernel(uint8_t* __restrict__ Y, uint8_t* __restrict__ U,
                         uint8_t* __restrict__ V, int h16, int w16,
                         const int32_t* __restrict__ mb, int n_mb,
                         const int16_t* __restrict__ res,
                         const int32_t* __restrict__ items, int width,
                         int height) {
  using S = McShape<ROWS, MPB>;
  __shared__ int32_t recs[MPB * MB_FIELDS];
  __shared__ uint4 sres[RES ? MPB * MC_RES_MB : 1];
  const int t = threadIdx.x;
  const int32_t* it = items + 4 * blockIdx.y;
  const int f = it[0], ref = it[1], outs = it[2], rnd = it[3];
  const int m0 = blockIdx.x * MPB;
  const int n_live = min(MPB, n_mb - m0);
  const size_t first = (size_t)f * n_mb + m0;
  for (int i = t; i < n_live * MB_FIELDS; i += S::THREADS)
    recs[i] = mb[first * MB_FIELDS + i];
  if (RES) {
    const uint4* src = reinterpret_cast<const uint4*>(res + first * 6 * 64);
    for (int i = t; i < n_live * 48; i += S::THREADS) {
      const int k = i / 48, q = i - 48 * k;
      sres[k * MC_RES_MB + (q >> 3) * MC_RES_BLOCK + (q & 7)] = src[i];
    }
  }
  __syncthreads();
  int k, b, r0;  // macroblock, 8 x 8 block, first row in the block
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
  // the prediction's bytes 0-1, 2-3, 4-5, 6-7 of each row in 16-bit lanes
  uint32_t pl[ROWS][4];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
    pl[i][0] = pl[i][1] = pl[i][2] = pl[i][3] = 0;
  if (ref >= 0 && rec[0] != MB_INTRA) {
    int vx, vy;
    if (luma) {
      vx = rec[4 + 2 * b];
      vy = rec[5 + 2 * b];
    } else {
      vx = chroma_vector(rec[4] + rec[6] + rec[8] + rec[10]);
      vy = chroma_vector(rec[5] + rec[7] + rec[9] + rec[11]);
    }
    const int pw = luma ? width : width >> 1, ph = luma ? height : height >> 1;
    const int X = 2 * px + vx, Yh = 2 * py + vy;
    const int x0 = X >> 1, y0 = Yh >> 1;
    const bool fx = X & 1, fy = Yh & 1;
    const bool interior = x0 >= 0 && x0 + 9 <= pw;
    const uint8_t* base = P + ref * plane;
    RefRow rr[ROWS + 1];
#pragma unroll
    for (int i = 0; i <= ROWS; ++i) {
      rr[i] = RefRow{0, 0, 0, 0};
      if (i < ROWS || fy)
        rr[i] = ref_row(base + (size_t)min(max(y0 + i, 0), ph - 1) * stride,
                        x0, pw, interior);
    }
    const uint32_t kr = (2 - rnd) * 0x00010001u;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const RefRow& A = rr[i];
      const RefRow& C = fy ? rr[i + 1] : rr[i];
      hpel4(A.a0, fx ? A.b0 : A.a0, C.a0, fx ? C.b0 : C.a0, kr, pl[i][0],
            pl[i][1]);
      hpel4(A.a1, fx ? A.b1 : A.a1, C.a1, fx ? C.b1 : C.a1, kr, pl[i][2],
            pl[i][3]);
    }
  }
  uint8_t* o = P + outs * plane + (size_t)py * stride + px;
  const uint4* rv = sres + k * MC_RES_MB + b * MC_RES_BLOCK + r0;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    uint2 v;
    if (RES) {
      const uint4 r = rv[i];
      v.x = add_clip4(pl[i][0], pl[i][1], r.x, r.y);
      v.y = add_clip4(pl[i][2], pl[i][3], r.z, r.w);
    } else {
      v.x = __byte_perm(pl[i][0], pl[i][1], 0x6420);
      v.y = __byte_perm(pl[i][2], pl[i][3], 0x6420);
    }
    *reinterpret_cast<uint2*>(o + (size_t)i * stride) = v;
  }
}

// ---- V2 at quarter-pel, and V5: a warp a macroblock -----------------------
//
// One macroblock's prediction from one or two references, as
// ops/mpeg4_cuda._predict computes it, plus the residual, clipped. Bound by
// bytes on this card. chip_smoke.mp4_bound counts, each byte once, a
// macroblock's record (V5's 80 bytes; V2's mode, and its vectors where it
// predicts), its residual (768) and output (384), and 384 reference
// samples a direction it predicts from; the reads beyond those (a
// quarter-pel block's (S + 1)-square window, 17 x 17 or four 9 x 9 for
// 256 pixels, and the half-pel rows' ninth column and row) are not
// counted, and make luma read up to 1.27x what the bound counts.
//
// The first form (a CUDA block a macroblock, samples staged as int through
// shared memory behind block-wide barriers, a byte load a sample, half the
// threads idle for chroma) was 13x that bound. Here a warp makes a
// macroblock, MBS macroblocks a CUDA block, and a lane owns a row of 8
// output pixels (macroblock row R = lane / 2, half H = lane % 2: block
// (R / 8) * 2 + H). A warp's work is a dependent chain (item, record,
// reference rows, arithmetic, store), and in variants timed in turns
// (tools/mp4_variants_torch.py) its time followed the warps an SM holds:
// the kernels are capped at 64 registers (MINB). Every global load of a
// direction is issued before its arithmetic: the record (20 lanes, one
// request), the residual as 16-byte rows, and the reference rows as
// aligned chunks, clamped byte by byte only where a block's window crosses
// the clamp box's left or right edge (rows are clamped whole). A 16 x 16
// quarter-pel window row is two 16-byte chunks, one a lane of the pair
// that takes the row's halves, swapped by a shuffle (qpel_load); a 9-byte
// row is two 8-byte chunks, and a lane takes its second row from the lane
// below by a shuffle (hpel_rows). Quarter-pel luma runs FFmpeg's two
// passes in 16-bit lanes (two pixels a 32-bit operation, lowpass2): the
// horizontal pass a task a lane (a window row's 8 half samples from its 15
// taps, mirrored at the block's edges by fixed byte orders, qpel_hrow),
// its rows into an 8-byte tile in shared memory together with their
// mirror images, the vertical pass a lane its output row from 8
// consecutive tile rows (qpel_vrow); a pass whose phase is 0 is skipped,
// and a 16 x 16 block's 17th window row (four 8 x 8 blocks' 9th rows) are
// extra tasks of lanes 0-1 (0-3). Half-pel luma and all chroma are PR
// 19's four-tap 16-bit-lane averages (hpel4); chroma takes 2 planes x 8
// rows of a direction, 16 lanes, so V5's two directions fill the warp and
// meet by a shuffle. Both predictions, their mean (f + b + 1) >> 1 (a
// byte-wise rounding average) and the residual (DPX clips, add_clip4) stay
// in registers. Only the warp synchronises (__syncwarp), except where a
// block's rows are staged (STAGE): then its warps, which share the stage,
// meet at a named barrier and store each picture row of their macroblocks
// from consecutive threads, whole 32-byte sectors where a warp alone
// would write half ones.
constexpr int GM_TILE = 60;         // 8-byte half-sample rows a direction:
                                    // two halves of 17 + 6 mirrored rows, or
                                    // four blocks of 9 + 6
constexpr uint32_t QP_BIAS = 3584;  // 112 * 32: keeps lowpass2's lanes >= 0

// the half-pel luma vector of a one-vector quarter-pel macroblock's chroma
// (ops/mpeg4_cuda.qpel_half): v / 2, or FFmpeg's DivX workarounds (rule 2
// adds (0, 0, 1, 1, 0, 0, 0, 1)[v & 7], the bits of 0x8C)
__device__ __forceinline__ int qpel_half(int v, int rule) {
  if (rule == 1) return (v >> 1) | (v & 1);
  if (rule == 2) return (v >> 1) + ((0x8C >> (v & 7)) & 1);
  return v / 2;  // truncated toward zero
}

// the chroma vector (x or y: component k) in half pels
// (ops/mpeg4_cuda.chroma_vectors)
__device__ __forceinline__ int chroma_of(const int32_t* vec, int k,
                                         bool four, bool qpel, int rule) {
  if (!qpel)
    return chroma_vector(vec[k] + vec[2 + k] + vec[4 + k] + vec[6 + k]);
  if (four)
    return chroma_vector(vec[k] / 2 + vec[2 + k] / 2 + vec[4 + k] / 2 +
                         vec[6 + k] / 2);
  return chroma_vector(4 * qpel_half(vec[k], rule));
}

// The 8-tap filter of two outputs in the 16-bit lanes of a word, from the
// lane-wise sums of its taps s0 = t3 + t4, s1 = t2 + t5, s2 = t1 + t6, s3 =
// t0 + t7 (each below 511): clip((20 s0 - 6 s1 + 3 s2 - s3 + 16 - rnd) >>
// 5, 0, 255), with k = (QP_BIAS + 16 - rnd) in both lanes. The biased sum
// stays in [29, 15330] in every lane and the subtrahend below the
// minuend, so no lane borrows from or carries into the next; the shift's
// bits from the upper lane are masked off, and the bias (112 after the
// shift) comes off inside the DPX clip max(min(x - 112, 255), 0).
__device__ __forceinline__ uint32_t lowpass2(uint32_t s0, uint32_t s1,
                                             uint32_t s2, uint32_t s3,
                                             uint32_t k) {
  const uint32_t u = (s0 * 20u + k + s2 * 3u) - (s1 * 6u + s3);
  return __viaddmin_s16x2_relu((u >> 5) & 0x07FF07FFu, 0xFF90FF90u,
                               0x00FF00FFu);
}

// (a + b + 1 - rnd) >> 1 in both 16-bit lanes (k1 = 1 - rnd in each)
__device__ __forceinline__ uint32_t mean2(uint32_t a, uint32_t b,
                                          uint32_t k1) {
  return ((a + b + k1) >> 1) & 0x00FF00FFu;
}

// (a + b + 1) >> 1 of each byte
__device__ __forceinline__ uint32_t avg8(uint32_t a, uint32_t b) {
  return (a | b) - (((a ^ b) >> 1) & 0x7F7F7F7Fu);
}

__device__ __forceinline__ uint2 avg8(uint2 a, uint2 b) {
  return make_uint2(avg8(a.x, b.x), avg8(a.y, b.y));
}

// 8 predicted bytes plus a row of 8 int16 residuals, clipped
__device__ __forceinline__ uint2 add_res(uint2 p, uint4 r) {
  return make_uint2(add_clip4(__byte_perm(p.x, 0, 0x4140),
                              __byte_perm(p.x, 0, 0x4342), r.x, r.y),
                    add_clip4(__byte_perm(p.y, 0, 0x4140),
                              __byte_perm(p.y, 0, 0x4342), r.z, r.w));
}

// A task of a quarter-pel direction's horizontal pass: window row `row` of
// block b (0 for a 16 x 16 block) in case c: 0 and 1 the left and right
// half of a 16 x 16 block's row (window bytes 0-11 and 5-16), 2 an 8 x 8
// block's row (bytes 0-8). base() is its block's first row in the
// direction's tile: rows -3 .. S + 3 of the half samples, those outside 0
// .. S holding their mirror images (-1 -> 0, S + 1 -> S, ...).
struct QTask {
  int b, row, c;
  __device__ int base() const { return c == 2 ? 15 * b : 23 * c; }
  __device__ int size() const { return c == 2 ? 8 : 16; }
};

// lane (R, H)'s own task, and the extra task of lanes 0-1 (0-3): the last
// window row
__device__ __forceinline__ QTask main_task(int lane, bool four) {
  const int R = lane >> 1, H = lane & 1;
  return four ? QTask{(R >> 3) * 2 + H, R & 7, 2} : QTask{0, R, H};
}
__device__ __forceinline__ QTask extra_task(int lane, bool four) {
  return four ? QTask{lane & 3, 8, 2} : QTask{0, 16, lane & 1};
}

// bytes o .. o + 11 (o <= 20) of the 32 bytes in w as three words: the
// word o / 4 picked by a select for each of its bits, then a funnel shift
__device__ __forceinline__ void take12(const uint32_t (&w)[8], int o,
                                       uint32_t (&v)[3]) {
  uint32_t s[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) s[i] = i < 8 ? w[i] : 0u;
  const int k = o >> 2;
#pragma unroll
  for (int i = 0; i < 9; ++i) s[i] = (k & 1) ? s[i + 1] : s[i];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = (k & 2) ? s[i + 2] : s[i];
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = (k & 4) ? s[i + 4] : s[i];
  const int sh = 8 * (o & 3);
#pragma unroll
  for (int j = 0; j < 3; ++j) v[j] = __funnelshift_r(s[j], s[j + 1], sh);
}

// bytes x .. x + n - 1 of a row as three words, each column clamped into
// [0, ew): the path of windows that cross the clamp box's edge
__device__ __forceinline__ void clamped_words(const uint8_t* __restrict__ row,
                                              int x, int n, int ew,
                                              uint32_t (&w)[3]) {
  w[0] = w[1] = w[2] = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i)
    if (i < n)
      w[i >> 2] |= (uint32_t)row[min(max(x + i, 0), ew - 1)] << (8 * (i & 3));
}

// an 8 x 8 block's task: its window row's 9 bytes from the aligned 16-byte
// chunk that holds the first and, where they reach past it, the next
__device__ __forceinline__ void block8_words(const uint8_t* __restrict__ P,
                                             int w16, int mx, int my,
                                             const int32_t* vec, QTask t,
                                             int ew, int eh,
                                             uint32_t (&v)[3]) {
  const int bx = mx * 16 + 8 * (t.b & 1) + (vec[2 * t.b] >> 2);
  const int by = my * 16 + 8 * (t.b >> 1) + (vec[2 * t.b + 1] >> 2);
  const uint8_t* row = P + (size_t)min(max(by + t.row, 0), eh - 1) * w16;
  if (bx >= 0 && bx + 9 <= ew) {
    const uint4* p = reinterpret_cast<const uint4*>(row + (bx & ~15));
    const uint4 c0 = p[0];
    const uint4 c1 = (bx & 15) + 9 > 16 ? p[1] : make_uint4(0, 0, 0, 0);
    const uint32_t w[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    take12(w, bx & 15, v);
  } else {
    clamped_words(row, bx, 9, ew, v);
  }
}

// The horizontal pass of a task: its 8 half samples (two words of bytes)
// at phase fx from its window words. t0-t3 hold the 15 taps of the 8
// outputs (positions -3 .. 11 from the task's first output), mirrored at
// the block's edges (-1 -> 0, S + 1 -> S, ...): fixed byte orders a case.
// e[i] = (t[2i], t[2i + 1]) and o[i] = (t[2i + 1], t[2i + 2]) in 16-bit
// lanes; outputs 2q, 2q + 1 take taps e[q], o[q], ..., o[q + 3].
__device__ __forceinline__ uint2 qpel_hrow(const uint32_t (&w)[3], int c,
                                           int fx, uint32_t k, uint32_t k1) {
  uint32_t t[4];
  if (c == 1) {  // bytes 5 .. 16, then 16, 15, 14
    t[0] = w[0];
    t[1] = w[1];
    t[2] = w[2];
    t[3] = __byte_perm(w[2], 0, 0x0123);
  } else {  // 2, 1, 0, then bytes 0 .. 11 (case 0) or 0 .. 8, 8, 7, 6
    t[0] = __byte_perm(w[0], 0, 0x0012);
    t[1] = __byte_perm(w[0], w[1], 0x4321);
    t[2] = __byte_perm(w[1], w[2], 0x4321);
    t[3] = c == 0 ? __byte_perm(w[2], 0, 0x0321) : __byte_perm(w[1], w[2],
                                                              0x0234);
  }
  if (fx == 0)  // the integer samples: taps 3 .. 10
    return make_uint2(__funnelshift_r(t[0], t[1], 24),
                      __funnelshift_r(t[1], t[2], 24));
  uint32_t e[8], o[7], p[4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    e[i] = __byte_perm(t[i >> 1], 0, (i & 1) ? 0x4342 : 0x4140);
#pragma unroll
  for (int i = 0; i < 7; ++i) o[i] = __funnelshift_r(e[i], e[i + 1], 16);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t h = lowpass2(o[q + 1] + e[q + 2], e[q + 1] + o[q + 2],
                                o[q] + e[q + 3], e[q] + o[q + 3], k);
    // the mean with sample c (fx 1) or c + 1 (fx 3)
    p[q] = (fx & 1) ? mean2(h, fx == 1 ? o[q + 1] : e[q + 2], k1) : h;
  }
  return make_uint2(__byte_perm(p[0], p[1], 0x6420),
                    __byte_perm(p[2], p[3], 0x6420));
}

// The vertical pass: row r's 8 outputs at phase fy (1 .. 3) from the 8
// tile rows of its taps r - 3 .. r + 4 (mirrored rows stored as such)
__device__ __forceinline__ uint2 qpel_vrow(const uint2* taps, int fy,
                                           uint32_t k, uint32_t k1) {
  uint32_t c[8][4], p[4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint2 v = taps[i];
    c[i][0] = __byte_perm(v.x, 0, 0x4140);
    c[i][1] = __byte_perm(v.x, 0, 0x4342);
    c[i][2] = __byte_perm(v.y, 0, 0x4140);
    c[i][3] = __byte_perm(v.y, 0, 0x4342);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t h = lowpass2(c[3][j] + c[4][j], c[2][j] + c[5][j],
                                c[1][j] + c[6][j], c[0][j] + c[7][j], k);
    // the mean with half row r (fy 1) or r + 1 (fy 3)
    p[j] = (fy & 1) ? mean2(h, fy == 1 ? c[3][j] : c[4][j], k1) : h;
  }
  return make_uint2(__byte_perm(p[0], p[1], 0x6420),
                    __byte_perm(p[2], p[3], 0x6420));
}

// a task's half samples into the tile: row w at base + 3 + w, and where
// the vertical taps mirror it (w <= 2, w >= S - 2) at its image too
__device__ __forceinline__ void tile_put(uint2* tile, QTask t, uint2 h) {
  const int b = t.base(), S = t.size();
  tile[b + 3 + t.row] = h;
  if (t.row <= 2) tile[b + 2 - t.row] = h;
  if (t.row >= S - 2) tile[b + 2 * S + 4 - t.row] = h;
}

// What a lane loads of one quarter-pel direction: its task's window words
// and, for lanes 0-1 (0-3), the extra task's
struct QLoad {
  uint32_t m[3], x[3];
};

// whether any block of a quarter-pel direction has a vertical phase (the
// tile and its extra rows are needed): uniform over the warp
__device__ __forceinline__ bool qpel_vertical(const int32_t* vec, bool four) {
  return ((four ? vec[1] | vec[3] | vec[5] | vec[7] : vec[1]) & 3) != 0;
}

// A quarter-pel direction's loads (every lane of the warp calls it): each
// task's window bytes (12 from byte 5 in case 1, else from byte 0) as
// three words, samples clamped into the ew x eh box. Row indices are
// clamped whole; where a block's window (S + 1 columns from bx) lies
// inside [0, ew) its rows are read as aligned 16-byte chunks
// (mpeg4_cuda.qpel_words), else a byte at a time. A 16 x 16 block's row
// is two chunks, one a lane of the pair (R, 0), (R, 1), swapped by a
// shuffle, so that one warp-wide load serves 16 rows; an 8 x 8 block's
// row is read by its own lane.
__device__ __forceinline__ void qpel_load(const uint8_t* __restrict__ P,
                                          int w16, int mx, int my,
                                          const int32_t* vec, bool four,
                                          int ew, int eh, int lane,
                                          QLoad& q) {
  const bool extra = lane < (four ? 4 : 2) && qpel_vertical(vec, four);
  if (four) {
    block8_words(P, w16, mx, my, vec, main_task(lane, true), ew, eh, q.m);
    if (extra)
      block8_words(P, w16, mx, my, vec, extra_task(lane, true), ew, eh, q.x);
    return;
  }
  const int bx = mx * 16 + (vec[0] >> 2), by = my * 16 + (vec[1] >> 2);
  const int H = lane & 1;
  const uint8_t* row =
      P + (size_t)min(max(by + (lane >> 1), 0), eh - 1) * w16;
  const uint8_t* last = P + (size_t)min(max(by + 16, 0), eh - 1) * w16;
  if (bx >= 0 && bx + 17 <= ew) {  // uniform over the warp
    const uint4 c = reinterpret_cast<const uint4*>(row + (bx & ~15))[H];
    const uint32_t mine[4] = {c.x, c.y, c.z, c.w};
    uint32_t w[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t other = __shfl_xor_sync(0xffffffffu, mine[i], 1);
      w[i] = H ? other : mine[i];
      w[4 + i] = H ? mine[i] : other;
    }
    take12(w, (bx & 15) + 5 * H, q.m);
    if (extra) {
      const uint4* p = reinterpret_cast<const uint4*>(last + (bx & ~15));
      const uint4 c0 = p[0], c1 = p[1];
      const uint32_t x[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      take12(x, (bx & 15) + 5 * H, q.x);
    }
  } else {
    clamped_words(row, bx + 5 * H, 12, ew, q.m);
    if (extra) clamped_words(last, bx + 5 * H, 12, ew, q.x);
  }
}

// The lane's 8 predicted luma bytes of a quarter-pel direction. Every lane
// of the warp calls it (it may __syncwarp).
__device__ __forceinline__ uint2 qpel_luma(const QLoad& q, const int32_t* vec,
                                           bool four, int lane, uint2* tile,
                                           uint32_t k, uint32_t k1) {
  const QTask mt = main_task(lane, four);
  const int fy = vec[2 * mt.b + 1] & 3;
  const uint2 h = qpel_hrow(q.m, mt.c, vec[2 * mt.b] & 3, k, k1);
  if (!qpel_vertical(vec, four)) return h;
  tile_put(tile, mt, h);
  const QTask xt = extra_task(lane, four);
  if (lane < (four ? 4 : 2) && (vec[2 * xt.b + 1] & 3))
    tile_put(tile, xt, qpel_hrow(q.x, xt.c, vec[2 * xt.b] & 3, k, k1));
  __syncwarp();
  if (fy == 0) return h;  // four vectors: this block has no vertical phase
  return qpel_vrow(tile + mt.base() + mt.row, fy, k, k1);
}

// a reference row's bytes x .. x + 8 as ref_row gives them, read as the
// two aligned 8-byte chunks that hold them where `interior`, else a byte
// at a time, each column clamped into [0, w)
__device__ __forceinline__ RefRow ref_row8(const uint8_t* __restrict__ row,
                                           int x, int w, bool interior) {
  uint32_t w0, w1, w2;
  int sh = 0;
  if (interior) {
    const uint2* p = reinterpret_cast<const uint2*>(row + (x & ~7));
    const uint2 c0 = p[0], c1 = p[1];
    const bool hi = x & 4;
    w0 = hi ? c0.y : c0.x;
    w1 = hi ? c1.x : c0.y;
    w2 = hi ? c1.y : c1.x;
    sh = 8 * (x & 3);
  } else {
    uint32_t b[3] = {0, 0, 0};
#pragma unroll
    for (int c = 0; c < 9; ++c)
      b[c >> 2] |= (uint32_t)row[min(max(x + c, 0), w - 1)] << (8 * (c & 3));
    w0 = b[0];
    w1 = b[1];
    w2 = b[2];
  }
  RefRow r;
  r.a0 = __funnelshift_r(w0, w1, sh);
  r.a1 = __funnelshift_r(w1, w2, sh);
  r.b0 = __funnelshift_rc(w0, w1, sh + 8);
  r.b1 = __funnelshift_rc(w1, w2, sh + 8);
  return r;
}

// The two reference rows of a half-pel row prediction of 8 pixels at (px,
// py) with vector (vx, vy) in the pw x ph picture: y0's, and for an odd Y
// y0 + 1's (else y0's again). Lanes d apart within segments of `seg` lanes
// predict consecutive rows with one vector, so a lane's second row is the
// next one's first (a shuffle); the last d lanes of a segment load their
// own. `act`: the lane predicts (the others only shuffle). Every lane of
// the warp calls it.
__device__ __forceinline__ void hpel_rows(const uint8_t* __restrict__ P,
                                          int stride, int px, int py, int vx,
                                          int vy, int pw, int ph, bool act,
                                          int d, int seg, int lane,
                                          RefRow& a, RefRow& c) {
  const int X = 2 * px + vx, Yh = 2 * py + vy, x0 = X >> 1, y0 = Yh >> 1;
  const bool interior = x0 >= 0 && x0 + 9 <= pw;
  a = RefRow{0, 0, 0, 0};
  if (act)
    a = ref_row8(P + (size_t)min(max(y0, 0), ph - 1) * stride, x0, pw,
                 interior);
  RefRow n;
  n.a0 = __shfl_down_sync(0xffffffffu, a.a0, d, seg);
  n.a1 = __shfl_down_sync(0xffffffffu, a.a1, d, seg);
  n.b0 = __shfl_down_sync(0xffffffffu, a.b0, d, seg);
  n.b1 = __shfl_down_sync(0xffffffffu, a.b1, d, seg);
  if (!(Yh & 1))
    c = a;
  else if (lane % seg < seg - d)
    c = n;
  else if (act)
    c = ref_row8(P + (size_t)min(max(y0 + 1, 0), ph - 1) * stride, x0, pw,
                 interior);
}

// the 8 predicted bytes from those rows at x phase fx (kr = 2 - rnd in
// each 16-bit lane)
__device__ __forceinline__ uint2 hpel_row(const RefRow& A, const RefRow& C,
                                          bool fx, uint32_t kr) {
  uint32_t l0, h0, l1, h1;
  hpel4(A.a0, fx ? A.b0 : A.a0, C.a0, fx ? C.b0 : C.a0, kr, l0, h0);
  hpel4(A.a1, fx ? A.b1 : A.a1, C.a1, fx ? C.b1 : C.a1, kr, l1, h1);
  return make_uint2(__byte_perm(l0, h0, 0x6420), __byte_perm(l1, h1, 0x6420));
}

// the chroma rows of lane (plane lane / 8 % 2, row lane % 8) of a
// direction (segments of 8 lanes; every lane of the warp calls it)
__device__ __forceinline__ void chroma_load(
    const uint8_t* __restrict__ U, const uint8_t* __restrict__ V, int w16,
    int mx, int my, int cx, int cy, int ew, int eh, bool act, int lane,
    RefRow& a, RefRow& c) {
  hpel_rows((lane & 8) ? V : U, w16 >> 1, mx * 8, my * 8 + (lane & 7), cx,
            cy, ew >> 1, eh >> 1, act, 1, 8, lane, a, c);
}

// the lane's luma (16 bytes from R) and chroma (lanes 0-15) residual rows
__device__ __forceinline__ void residual_rows(const int16_t* __restrict__ r,
                                              int lane, uint4& rl,
                                              uint4& rc) {
  rl = rc = make_uint4(0, 0, 0, 0);
  if (!r) return;
  const uint4* v = reinterpret_cast<const uint4*>(r);
  const int R = lane >> 1;
  rl = v[((R >> 3) * 2 + (lane & 1)) * 8 + (R & 7)];
  if (lane < 16) rc = v[32 + lane];
}

__device__ __forceinline__ void store_rows(uint8_t* Y, uint8_t* U,
                                           uint8_t* V, int w16, int mx,
                                           int my, int lane, uint2 lum,
                                           uint2 chr) {
  const int R = lane >> 1;
  *reinterpret_cast<uint2*>(Y + (size_t)(my * 16 + R) * w16 + mx * 16 +
                            8 * (lane & 1)) = lum;
  if (lane < 16)
    *reinterpret_cast<uint2*>(((lane & 8) ? V : U) +
                              (size_t)(my * 8 + (lane & 7)) * (w16 >> 1) +
                              mx * 8) = chr;
}

// The outputs of a CUDA block's MBS macroblocks, staged in shared memory:
// luma as 16-byte rows (row, macroblock), chroma as 8-byte rows (plane * 8
// + row, macroblock), so that the block stores each picture row of its
// macroblocks (consecutive in a macroblock row) from consecutive threads.
template <int MBS>
struct GmOut {
  uint4 lum[16 * MBS];
  uint2 chr[16 * MBS];
};

// macroblock wi's lane writes its rows into the stage
template <int MBS>
__device__ __forceinline__ void stage_rows(GmOut<MBS>& o, int wi, int lane,
                                           uint2 lum, uint2 chr) {
  reinterpret_cast<uint2*>(o.lum)[((lane >> 1) * MBS + wi) * 2 + (lane & 1)] =
      lum;
  if (lane < 16) o.chr[lane * MBS + wi] = chr;
}

// the named barrier of the block's warps (they share the stage)
template <int MBS>
__device__ __forceinline__ void block_bar() {
  asm volatile("bar.sync 1, %0;" ::"r"(32 * MBS) : "memory");
}

// thread t stores row t / MBS (luma rows 0-15, then the 16 chroma rows) of
// macroblock m0 + t % MBS: a warp writes whole 32-byte sectors
template <int MBS>
__device__ __forceinline__ void store_block(const GmOut<MBS>& o, uint8_t* Y,
                                            uint8_t* U, uint8_t* V, int w16,
                                            int m0, int n_mb) {
  const int t = threadIdx.x, k = t % MBS, u = t / MBS, m = m0 + k;
  if (m >= n_mb) return;
  const int mbw = w16 >> 4, my = m / mbw, mx = m - my * mbw;
  if (u < 16) {
    *reinterpret_cast<uint4*>(Y + (size_t)(my * 16 + u) * w16 + mx * 16) =
        o.lum[u * MBS + k];
  } else {
    const int pr = u - 16;
    *reinterpret_cast<uint2*>(((pr & 8) ? V : U) +
                              (size_t)(my * 8 + (pr & 7)) * (w16 >> 1) +
                              mx * 8) = o.chr[pr * MBS + k];
  }
}

// V2 at quarter-pel: items (f, reference slot, output slot, rounding)
// over records (F, M, MB_FIELDS), a warp a macroblock and item, MBS
// macroblocks a CUDA block (MINB: the CUDA blocks an SM must hold, which
// caps the registers; STAGE: the block's rows staged, then stored whole).
template <int MBS, int MINB, bool STAGE>
__global__ void __launch_bounds__(32 * MBS, MINB)
motion_compensate_qpel_kernel(uint8_t* __restrict__ Y, uint8_t* __restrict__ U,
                              uint8_t* __restrict__ V, int h16, int w16,
                              const int32_t* __restrict__ mb, int n_mb,
                              const int16_t* __restrict__ res,
                              const int32_t* __restrict__ items, int ew,
                              int eh, int rule) {
  __shared__ int32_t recs[MBS][MB_FIELDS];
  __shared__ uint2 tiles[MBS][GM_TILE];
  __shared__ GmOut<STAGE ? MBS : 1> stage;
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int m0 = blockIdx.x * MBS, m = m0 + wi;
  const int32_t* it = items + 4 * blockIdx.y;
  const int f = it[0], ref = it[1], outs = it[2], rnd = it[3];
  const size_t lp = (size_t)h16 * w16, cp = lp >> 2;
  const int mbw = w16 >> 4, my = m / mbw, mx = m - my * mbw;
  uint2 lum = make_uint2(0, 0), chr = make_uint2(0, 0);
  if (m < n_mb) {  // uniform over the warp
    const size_t k = (size_t)f * n_mb + m;
    int32_t* rec = recs[wi];
    if (lane < MB_FIELDS) rec[lane] = mb[k * MB_FIELDS + lane];
    uint4 rl, rc;
    residual_rows(res ? res + k * 384 : nullptr, lane, rl, rc);
    __syncwarp();
    if (ref >= 0 && rec[0] != MB_INTRA) {  // uniform over the warp
      const int32_t* vec = rec + 4;
      const bool four = rec[0] == MB_INTER4V;
      QLoad q;
      qpel_load(Y + ref * lp, w16, mx, my, vec, four, ew, eh, lane, q);
      const int cx = chroma_of(vec, 0, four, true, rule);
      const int cy = chroma_of(vec, 1, four, true, rule);
      RefRow ca, cc;
      chroma_load(U + ref * cp, V + ref * cp, w16, mx, my, cx, cy, ew, eh,
                  lane < 16, lane, ca, cc);
      lum = qpel_luma(q, vec, four, lane, tiles[wi],
                      (QP_BIAS + 16 - rnd) * 0x00010001u,
                      (1 - rnd) * 0x00010001u);
      if (lane < 16) chr = hpel_row(ca, cc, cx & 1, (2 - rnd) * 0x00010001u);
    }
    if (res) {
      lum = add_res(lum, rl);
      chr = add_res(chr, rc);
    }
    if constexpr (STAGE)
      stage_rows<MBS>(stage, wi, lane, lum, chr);
    else
      store_rows(Y + outs * lp, U + outs * cp, V + outs * cp, w16, mx, my,
                 lane, lum, chr);
  }
  if constexpr (STAGE) {
    block_bar<MBS>();
    store_block<MBS>(stage, Y + outs * lp, U + outs * cp, V + outs * cp, w16,
                     m0, n_mb);
  }
}

// V5: the B-VOPs of a batch. Items (j, past slot, future slot, output
// slot) over records (FB, M, B_FIELDS) and residuals (FB, M, 6, 64); a warp
// a macroblock and item, MBS macroblocks a CUDA block (MINB, STAGE as for
// V2); QPEL: quarter-pel luma vectors. Rounding type 0. A macroblock without B_FWD predicts from
// the future slot alone (as bidir_compensate_plain does). It replaces no
// TPU kernel: cv2's decoding of B-VOPs (faceoff_tpu/io/video.py:61).
template <int MBS, bool QPEL, int MINB, bool STAGE>
__global__ void __launch_bounds__(32 * MBS, MINB)
bidir_compensate_kernel(uint8_t* __restrict__ Y, uint8_t* __restrict__ U,
                        uint8_t* __restrict__ V, int h16, int w16,
                        const int32_t* __restrict__ bmb, int n_mb,
                        const int16_t* __restrict__ res,
                        const int32_t* __restrict__ items, int ew, int eh,
                        int rule) {
  __shared__ int32_t recs[MBS][B_FIELDS];
  __shared__ uint2 tiles[MBS][2][GM_TILE];
  __shared__ GmOut<STAGE ? MBS : 1> stage;
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int m0 = blockIdx.x * MBS, m = m0 + wi;
  const int32_t* it = items + 4 * blockIdx.y;
  const int j = it[0], past = it[1], future = it[2], outs = it[3];
  const size_t lp = (size_t)h16 * w16, cp = lp >> 2;
  const int mbw = w16 >> 4, my = m / mbw, mx = m - my * mbw;
  if (m < n_mb) {  // uniform over the warp
    const size_t k = (size_t)j * n_mb + m;
    int32_t* rec = recs[wi];
    if (lane < B_FIELDS) rec[lane] = bmb[k * B_FIELDS + lane];
    uint4 rl, rc;
    residual_rows(res ? res + k * 384 : nullptr, lane, rl, rc);
    __syncwarp();
    const int dir = rec[3];
    const bool four = dir & B_8X8;
    const bool fwd = dir & B_FWD, bwd = (dir & B_BWD) || !fwd;
    const int32_t* fv = rec + 4;
    const int32_t* bv = rec + 12;
    const uint8_t* fy_ = Y + past * lp;
    const uint8_t* by_ = Y + future * lp;
    // the loads of both directions first
    const int R = lane >> 1, H = lane & 1, b = (R >> 3) * 2 + H;
    QLoad qf, qb;
    RefRow fa, fc, ba, bc;
    if (QPEL) {
      if (fwd) qpel_load(fy_, w16, mx, my, fv, four, ew, eh, lane, qf);
      if (bwd) qpel_load(by_, w16, mx, my, bv, four, ew, eh, lane, qb);
    } else {
      // rows R and R + 1 of a block: lanes 2 apart, 16 lanes a block row
      const int px = mx * 16 + 8 * H, py = my * 16 + R;
      if (fwd)
        hpel_rows(fy_, w16, px, py, fv[2 * b], fv[2 * b + 1], ew, eh, true, 2,
                  16, lane, fa, fc);
      if (bwd)
        hpel_rows(by_, w16, px, py, bv[2 * b], bv[2 * b + 1], ew, eh, true, 2,
                  16, lane, ba, bc);
    }
    // chroma: lanes 0-15 the forward direction, 16-31 the backward one
    const bool cd = lane >= 16;
    const int32_t* cvec = cd ? bv : fv;
    const int cx = chroma_of(cvec, 0, four, QPEL, rule);
    const int cy = chroma_of(cvec, 1, four, QPEL, rule);
    const int cslot = cd ? future : past;
    RefRow ca, cc;
    chroma_load(U + cslot * cp, V + cslot * cp, w16, mx, my, cx, cy, ew, eh,
                cd ? bwd : fwd, lane, ca, cc);
    uint2 fl = make_uint2(0, 0), bl = make_uint2(0, 0);
    const uint32_t k0 = (QP_BIAS + 16) * 0x00010001u, k1 = 0x00010001u;
    const uint32_t kr = 2 * 0x00010001u;
    if (QPEL) {
      if (fwd) fl = qpel_luma(qf, fv, four, lane, tiles[wi][0], k0, k1);
      if (bwd) bl = qpel_luma(qb, bv, four, lane, tiles[wi][1], k0, k1);
    } else {
      if (fwd) fl = hpel_row(fa, fc, fv[2 * b] & 1, kr);
      if (bwd) bl = hpel_row(ba, bc, bv[2 * b] & 1, kr);
    }
    uint2 c = make_uint2(0, 0);
    if (cd ? bwd : fwd) c = hpel_row(ca, cc, cx & 1, kr);
    const uint2 o = make_uint2(__shfl_xor_sync(0xffffffffu, c.x, 16),
                               __shfl_xor_sync(0xffffffffu, c.y, 16));
    uint2 lum = fwd && bwd ? avg8(fl, bl) : (fwd ? fl : bl);
    uint2 chr = fwd && bwd ? avg8(c, o) : (fwd ? c : o);  // lanes 0-15
    if (res) {
      lum = add_res(lum, rl);
      chr = add_res(chr, rc);
    }
    if constexpr (STAGE)
      stage_rows<MBS>(stage, wi, lane, lum, chr);
    else
      store_rows(Y + outs * lp, U + outs * cp, V + outs * cp, w16, mx, my,
                 lane, lum, chr);
  }
  if constexpr (STAGE) {
    block_bar<MBS>();
    store_block<MBS>(stage, Y + outs * lp, U + outs * cp, V + outs * cp, w16,
                     m0, n_mb);
  }
}

// V3: the full search, then the half-pel step and the intra decision.
// Bound by the SAD's integer instructions (one VABSDIFF4 sums four bytes'
// absolute differences), so the design spends as few others as it can on
// each byte. A "run" thread scores MS_RUN consecutive dx at MS_DY
// consecutive dy; the runs tile dx -16 .. 15 exactly, and a "column"
// thread scores dx 16 at MS_DY dy (its words are aligned: no shifts).
// Each window row a run thread loads (MS_RUN / 4 + 4 words) and the three
// byte shifts of those words (one __byte_perm each) serve MS_RUN x MS_DY
// candidate rows of four VABSDIFF4 each; the rows where every dy is live
// run without a branch, so the shifts are made once a row. The current
// macroblock's row is one broadcast 16-byte load from shared memory. Run
// threads come first and column threads after, so that warps run one
// path. The key packs SAD, Chebyshev length, dy and dx into 31 bits
// (search_key) and is reduced by warp shuffles over each macroblock's
// threads, then one shared atomicMin a warp. The half-pel and intra sums
// take a column of 4 pixels a task (a 6 x 3 neighbourhood of window bytes
// serves all 4) and are reduced by __reduce_add_sync, one shared atomicAdd
// a warp. The window is filled with 16-byte loads of clamped rows, bytes
// clamped one by one only in chunks that cross the picture's left or
// right edge.
constexpr int RANGE = 16;
constexpr int SIDE = 2 * RANGE + 1;
constexpr int WIN_ROWS = 52;    // rows -18 .. +33 of the macroblock
constexpr int WIN_Y = 18;
constexpr int WIN_X = 32;       // columns -32 .. +47: 16-byte aligned loads
constexpr int WIN_LOAD = 80;    // bytes of a row filled
constexpr int WIN_STRIDE = 88;  // bytes of a row in shared memory: 22 words
                                // put rows 1 and 3 apart on distinct banks
constexpr int ORDER_BITS = 15;  // (cheb * 33 + dy + 16) * 33 + dx + 16

// chosen from tools/mp4_variants_torch.py's readings (PERF.md, section 6)
constexpr int MS_RUN = 8, MS_DY = 3, MS_MBS = 2;
constexpr int FQ_MBS = 4;
constexpr int V1_BPB = 32, V1_RPT = 2;
constexpr int MC_RES_ROWS = 1, MC_RES_MBS = 4;    // with a residual
constexpr int MC_PRED_ROWS = 2, MC_PRED_MBS = 4;  // without
// V2 at quarter-pel and V5: macroblocks (warps) a CUDA block, the CUDA
// blocks an SM must hold (a cap of 64 registers a thread), and whether the
// block's rows are staged for whole-sector stores (V2: 8 % faster; V5,
// whose warps' work varies more, 5 % slower behind the barrier)
constexpr int MCQ_MBS = 4, MCQ_MINB = 8;
constexpr bool MCQ_STAGE = true;
constexpr int BD_MBS = 4, BD_MINB = 8;
constexpr bool BD_STAGE = false;

template <int R, int D, int MPB>
struct SearchShape {
  static_assert(32 % R == 0 && R % 4 == 0, "runs tile dx -16 .. 15");
  static_assert(SIDE % D == 0, "dy groups tile dy -16 .. 16");
  static constexpr int NRUN = 32 / R;
  static constexpr int NDY = SIDE / D;
  static constexpr int RUNS = NRUN * NDY;    // run threads a macroblock
  static constexpr int RUN_THREADS = RUNS * MPB;
  static constexpr int THREADS = (RUN_THREADS + NDY * MPB + 31) / 32 * 32;
  static_assert(WIN_Y + (NDY - 1) * D - RANGE + D + 14 < WIN_ROWS &&
                    WIN_Y + 2 * RANGE + 1 < WIN_ROWS,
                "the window holds every row read");
  static_assert(WIN_X + RANGE + 16 < WIN_LOAD,
                "the window holds every column read");
};

// the half-pel offsets of _HALF_ORDER: (0, 0), then the eight neighbours
// row by row
__device__ constexpr int half_dx(int i) {
  return i == 0 ? 0 : (i < 5 ? i - 1 : i) % 3 - 1;
}
__device__ constexpr int half_dy(int i) {
  return i == 0 ? 0 : (i < 5 ? i - 1 : i) / 3 - 1;
}

// acc + the sum of the absolute differences of a's and b's four bytes
__device__ __forceinline__ unsigned sad4(unsigned a, unsigned b,
                                         unsigned acc) {
  unsigned d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(d) : "r"(a), "r"(b), "r"(acc));
  return d;
}

// the plain order's key (SAD, Chebyshev length, dy, dx) in 31 bits: the
// SAD is below 2^16 and the mixed-radix order below 33^2 * 17 < 2^15
__device__ __forceinline__ unsigned search_key(unsigned sad, int dx, int dy) {
  int cheb = max(abs(dx), abs(dy));
  return (sad << ORDER_BITS) |
         (unsigned)((cheb * SIDE + dy + RANGE) * SIDE + dx + RANGE);
}

// One window row r (relative to dy0) against the current rows r - i of
// candidates (dx0 + j, dy0 + i): R consecutive dx from a word boundary of
// `row`. LIVE: every r - i is a row of the macroblock.
template <int R, int D, bool LIVE>
__device__ __forceinline__ void search_row(const uint8_t* row,
                                           const uint4* cur, int r,
                                           unsigned (&acc)[D][R]) {
  constexpr int NW = R / 4 + 4;  // words of a row a thread loads
  uint32_t w[NW], sh[3][NW - 1];
  if constexpr (NW % 2 == 0) {
    const uint2* p = reinterpret_cast<const uint2*>(row);
#pragma unroll
    for (int q = 0; q < NW / 2; ++q) {
      const uint2 v = p[q];
      w[2 * q] = v.x;
      w[2 * q + 1] = v.y;
    }
  } else {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(row);
#pragma unroll
    for (int q = 0; q < NW; ++q) w[q] = p[q];
  }
#pragma unroll
  for (int s = 1; s < 4; ++s)
#pragma unroll
    for (int q = 0; q < NW - 1; ++q)
      sh[s - 1][q] = __byte_perm(w[q], w[q + 1], 0x3210 + 0x1111 * s);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const int py = r - i;
    if (!LIVE && (py < 0 || py >= 16)) continue;
    const uint4 c = cur[py];
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

// The SADs of candidates (dx0 + j, dy0 + i), j < R, i < D, over the
// window rows from `base` (the window at dy0, dx0).
template <int R, int D>
__device__ __forceinline__ void search_block(const uint8_t* base,
                                             const uint4* cur,
                                             unsigned (&acc)[D][R]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0;
#pragma unroll 1
  for (int r = 0; r < D - 1; ++r)
    search_row<R, D, false>(base + r * WIN_STRIDE, cur, r, acc);
#pragma unroll 1
  for (int r = D - 1; r < 16; ++r)
    search_row<R, D, true>(base + r * WIN_STRIDE, cur, r, acc);
#pragma unroll 1
  for (int r = 16; r < D + 15; ++r)
    search_row<R, D, false>(base + r * WIN_STRIDE, cur, r, acc);
}

template <int R, int D, int MPB>
__global__ void __launch_bounds__(SearchShape<R, D, MPB>::THREADS)
motion_search_kernel(const uint8_t* __restrict__ Y, int h16, int w16,
                     const int32_t* __restrict__ items, int n_mb, int width,
                     int height, int32_t* __restrict__ out) {
  using S = SearchShape<R, D, MPB>;
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
      const int wy = i / (WIN_LOAD / 16);
      const int x0 = ox + 16 * (i - wy * (WIN_LOAD / 16));
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
  // the integer search: segment `seg` is a macroblock's run threads
  // (seg < MPB) or its column threads (seg - MPB)
  const bool run = t < S::RUN_THREADS;
  const int seg = run ? t / S::RUNS : MPB + (t - S::RUN_THREADS) / S::NDY;
  const int k = seg < MPB ? seg : seg - MPB;
  const bool live = k < MPB && m0 + k < n_mb;
  unsigned key = ~0u;
  if (live && run) {
    const int u = t - k * S::RUNS;
    const int dy0 = (u % S::NDY) * D - RANGE, dx0 = (u / S::NDY) * R - RANGE;
    unsigned acc[D][R];
    search_block<R, D>(win[k] + (WIN_Y + dy0) * WIN_STRIDE + WIN_X + dx0,
                       cur[k], acc);
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j)
        key = min(key, search_key(acc[i][j], dx0 + j, dy0 + i));
  } else if (live) {
    const int dy0 = (t - S::RUN_THREADS - k * S::NDY) * D - RANGE;
    unsigned acc[D][1];
    search_block<1, D>(win[k] + (WIN_Y + dy0) * WIN_STRIDE + WIN_X + RANGE,
                       cur[k], acc);
#pragma unroll
    for (int i = 0; i < D; ++i)
      key = min(key, search_key(acc[i][0], RANGE, dy0 + i));
  }
  // a segment's threads are consecutive: a segmented warp minimum
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned o = __shfl_down_sync(0xffffffffu, key, off);
    const int t2 = t + off;
    const int seg2 = t2 < S::RUN_THREADS
                         ? t2 / S::RUNS
                         : MPB + (t2 - S::RUN_THREADS) / S::NDY;
    if (lane + off < 32 && seg2 == seg) key = min(key, o);
  }
  const bool first = run ? t % S::RUNS == 0
                         : (t - S::RUN_THREADS) % S::NDY == 0;
  if (live && (lane == 0 || first)) atomicMin(&best[k], key);
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
        // hx is odd), row y0 (and y0 + 1 where hy is odd)
        const int X = 2 + half_dx(i), Yh = 2 + half_dy(i);
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
    o[1] = intra ? 0 : 2 * bx + half_dx(bi);
    o[2] = intra ? 0 : 2 * by + half_dy(bi);
  }
}

// V4: a thread a row of an 8 x 8 block (8 threads a block, 48 a
// macroblock), MPB macroblocks a CUDA block. Each thread loads its source
// and prediction rows as 8-byte vectors, runs the row pass in registers
// with the even/odd butterfly (C[u][7 - k] = (-1)^u C[u][k]), hands its
// row to the block's 8 threads through a padded shared tile (one warp,
// no barrier), runs the column pass for its output row v the same way,
// and quantises by multiply-high with the reciprocals of kRecip (exact
// for every value the inputs reach; ops/mpeg4_cuda.py's tests). Integer
// sums do not depend on their order and stay below 2^27, so the result is
// the plain version's. One 16-byte store a row.
constexpr int T_ROW = 12;               // ints of a tile row (8 used)
constexpr int T_BLOCK = 8 * T_ROW + 4;  // ints of a block's tile

__constant__ uint32_t kRecip[64];       // ceil(2^32 / d), d = 2 .. 63

__device__ __forceinline__ int div_recip(int n, int d) {
  return (int)__umulhi((unsigned)n, kRecip[d]);
}

template <int MPB>
__global__ void __launch_bounds__(48 * MPB)
fdct_quant_kernel(const uint8_t* __restrict__ sy,
                  const uint8_t* __restrict__ su,
                  const uint8_t* __restrict__ sv,
                  const uint8_t* __restrict__ py_,
                  const uint8_t* __restrict__ pu,
                  const uint8_t* __restrict__ pv, int h16, int w16,
                  const int32_t* __restrict__ mb, int n_mb, int total,
                  const int32_t* __restrict__ items,
                  int16_t* __restrict__ out) {
  __shared__ __align__(16) int tile[6 * MPB * T_BLOCK];
  const int t = threadIdx.x, r = t & 7;
  const int j = blockIdx.x * 6 * MPB + (t >> 3);  // (item, macroblock, block)
  const int gm = j / 6, b = j - gm * 6;
  const bool live = gm < total;
  int* row = tile + (t >> 3) * T_BLOCK;
  bool intra = false;
  int qp = 1;
  if (live) {
    const int g = gm / n_mb, m = gm - g * n_mb;
    const int32_t* rec = mb + (size_t)gm * MB_FIELDS;
    const int s_i = items[2 * g], p_i = items[2 * g + 1];
    const int mbw = w16 >> 4, my = m / mbw, mx = m - my * mbw;
    const uint8_t *s, *p;
    if (b < 4) {
      const size_t o = (size_t)(my * 16 + (b >> 1) * 8 + r) * w16 + mx * 16 +
                       (b & 1) * 8;
      const size_t lplane = (size_t)h16 * w16;
      s = sy + s_i * lplane + o;
      p = py_ + p_i * lplane + o;
    } else {
      const size_t o = (size_t)(my * 8 + r) * (w16 >> 1) + mx * 8;
      const size_t cplane = (size_t)h16 * w16 >> 2;
      s = (b == 4 ? su : sv) + s_i * cplane + o;
      p = (b == 4 ? pu : pv) + p_i * cplane + o;
    }
    const uint2 sa = *reinterpret_cast<const uint2*>(s);
    const uint2 pa = *reinterpret_cast<const uint2*>(p);
    intra = rec[0] == MB_INTRA;
    qp = rec[1];
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
    int tr[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int* h = (u & 1) ? o : e;
      int acc = 512;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc += kFdct[u * 8 + k] * h[k];
      tr[u] = acc >> 10;
    }
    int4* d = reinterpret_cast<int4*>(row + r * T_ROW);
    d[0] = make_int4(tr[0], tr[1], tr[2], tr[3]);
    d[1] = make_int4(tr[4], tr[5], tr[6], tr[7]);
  }
  __syncwarp();
  if (!live) return;
  // column pass for output row v = r: F[v][u] = sum_y C[v][y] tr[y][u]
  int c[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) c[k] = kFdct[r * 8 + k];
  const int sgn = (r & 1) ? -1 : 1;
  int acc[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) acc[u] = 32768;
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    const int4* a = reinterpret_cast<const int4*>(row + y * T_ROW);
    const int4* z = reinterpret_cast<const int4*>(row + (7 - y) * T_ROW);
    const int4 a0 = a[0], a1 = a[1], z0 = z[0], z1 = z[1];
    const int ta[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const int tz[8] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[u] += c[y] * (ta[u] + sgn * tz[u]);
  }
  const int d2 = 2 * qp, half = qp >> 1;
  int lv[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int f = acc[u] >> 16;
    const int a = abs(f);
    const int n = intra ? a : max(a - half, 0);
    const int mag = min(div_recip(n, d2), 2047);
    lv[u] = f < 0 ? -mag : mag;
  }
  if (intra && r == 0) {
    const int sc = d_dc_scaler(qp, b < 4);
    const int q = (acc[0] >> 16) + (sc >> 1);
    const int dc = q >= 0 ? div_recip(q, sc) : -div_recip(-q + sc - 1, sc);
    lv[0] = min(max(dc, 1), 254);
  }
  uint4 packed;
  packed.x = (uint16_t)lv[0] | ((unsigned)(uint16_t)lv[1] << 16);
  packed.y = (uint16_t)lv[2] | ((unsigned)(uint16_t)lv[3] << 16);
  packed.z = (uint16_t)lv[4] | ((unsigned)(uint16_t)lv[5] << 16);
  packed.w = (uint16_t)lv[6] | ((unsigned)(uint16_t)lv[7] << 16);
  *reinterpret_cast<uint4*>(out + (size_t)j * 64 + r * 8) = packed;
}

int status(cudaError_t e) { return e == cudaSuccess ? 0 : 1000 + (int)e; }

// V1 at the form a call asks for (template arguments of the kernel)
template <int FIELDS, bool MPEG, bool XVID>
int launch_v1(const int16_t* blocks, const int32_t* bidx, int nb,
              const int32_t* mb, int16_t* out, cudaStream_t stream) {
  dequant_idct_kernel<V1_BPB, V1_RPT, FIELDS, MPEG, XVID>
      <<<(nb + V1_BPB - 1) / V1_BPB, 8 / V1_RPT * V1_BPB, 0, stream>>>(
          blocks, bidx, nb, mb, out);
  return status(cudaGetLastError());
}

template <int FIELDS>
int launch_v1(int mpeg, int xvid, const int16_t* blocks, const int32_t* bidx,
              int nb, const int32_t* mb, int16_t* out, cudaStream_t stream) {
  if (mpeg)
    return xvid ? launch_v1<FIELDS, true, true>(blocks, bidx, nb, mb, out,
                                                stream)
                : launch_v1<FIELDS, true, false>(blocks, bidx, nb, mb, out,
                                                 stream);
  return xvid ? launch_v1<FIELDS, false, true>(blocks, bidx, nb, mb, out,
                                               stream)
              : launch_v1<FIELDS, false, false>(blocks, bidx, nb, mb, out,
                                                stream);
}

}  // namespace

extern "C" {

// fields: the records' stride (MB_FIELDS or B_FIELDS); mpeg: MPEG
// quantisation with the matrices of mpeg4_set_matrices; xvid: the Xvid
// IDCT
int mpeg4_dequant_idct(const int16_t* blocks, const int32_t* bidx, int nb,
                       const int32_t* mb, int16_t* out, int fields, int mpeg,
                       int xvid, cudaStream_t stream) {
  if (fields == MB_FIELDS)
    return launch_v1<MB_FIELDS>(mpeg, xvid, blocks, bidx, nb, mb, out,
                                stream);
  if (fields == B_FIELDS)
    return launch_v1<B_FIELDS>(mpeg, xvid, blocks, bidx, nb, mb, out,
                               stream);
  return 1;
}

// width, height: the edge at which reference samples are clamped; qpel:
// quarter-pel vectors (the warp-a-macroblock kernel; half-pel takes the
// row kernel), rule: the quarter-pel chroma rule
int mpeg4_motion_compensate(uint8_t* y, uint8_t* u, uint8_t* v, int h16,
                            int w16, const int32_t* mb, int n_mb,
                            const int16_t* res, const int32_t* items, int g,
                            int width, int height, int qpel, int rule,
                            cudaStream_t stream) {
  if (qpel) {
    motion_compensate_qpel_kernel<MCQ_MBS, MCQ_MINB, MCQ_STAGE>
        <<<dim3((n_mb + MCQ_MBS - 1) / MCQ_MBS, g), 32 * MCQ_MBS, 0,
           stream>>>(y, u, v, h16, w16, mb, n_mb, res, items, width, height,
                     rule);
  } else if (res) {
    using S = McShape<MC_RES_ROWS, MC_RES_MBS>;
    motion_compensate_kernel<MC_RES_ROWS, MC_RES_MBS, 1>
        <<<dim3((n_mb + MC_RES_MBS - 1) / MC_RES_MBS, g), S::THREADS, 0,
           stream>>>(y, u, v, h16, w16, mb, n_mb, res, items, width, height);
  } else {
    using S = McShape<MC_PRED_ROWS, MC_PRED_MBS>;
    motion_compensate_kernel<MC_PRED_ROWS, MC_PRED_MBS, 0>
        <<<dim3((n_mb + MC_PRED_MBS - 1) / MC_PRED_MBS, g), S::THREADS, 0,
           stream>>>(y, u, v, h16, w16, mb, n_mb, res, items, width, height);
  }
  return status(cudaGetLastError());
}

int mpeg4_bidir_compensate(uint8_t* y, uint8_t* u, uint8_t* v, int h16,
                           int w16, const int32_t* bmb, int n_mb,
                           const int16_t* res, const int32_t* items, int g,
                           int width, int height, int qpel, int rule,
                           cudaStream_t stream) {
  const dim3 grid((n_mb + BD_MBS - 1) / BD_MBS, g);
  if (qpel)
    bidir_compensate_kernel<BD_MBS, true, BD_MINB, BD_STAGE>
        <<<grid, 32 * BD_MBS, 0, stream>>>(y, u, v, h16, w16, bmb, n_mb, res,
                                           items, width, height, rule);
  else
    bidir_compensate_kernel<BD_MBS, false, BD_MINB, BD_STAGE>
        <<<grid, 32 * BD_MBS, 0, stream>>>(y, u, v, h16, w16, bmb, n_mb, res,
                                           items, width, height, rule);
  return status(cudaGetLastError());
}

int mpeg4_motion_search(const uint8_t* y, int n, int h16, int w16,
                        const int32_t* items, int g, int width, int height,
                        int32_t* out, cudaStream_t stream) {
  (void)n;
  using S = SearchShape<MS_RUN, MS_DY, MS_MBS>;
  const int n_mb = (h16 / 16) * (w16 / 16);
  dim3 grid((n_mb + MS_MBS - 1) / MS_MBS, g);
  motion_search_kernel<MS_RUN, MS_DY, MS_MBS><<<grid, S::THREADS, 0, stream>>>(
      y, h16, w16, items, n_mb, width, height, out);
  return status(cudaGetLastError());
}

int mpeg4_fdct_quant(const uint8_t* sy, const uint8_t* su, const uint8_t* sv,
                     int n_src, const uint8_t* py, const uint8_t* pu,
                     const uint8_t* pv, int n_pred, int h16, int w16,
                     const int32_t* mb, const int32_t* items, int g,
                     int16_t* out, cudaStream_t stream) {
  (void)n_src;
  (void)n_pred;
  const int n_mb = (h16 / 16) * (w16 / 16), total = g * n_mb;
  fdct_quant_kernel<FQ_MBS><<<(total + FQ_MBS - 1) / FQ_MBS, 48 * FQ_MBS, 0,
                              stream>>>(sy, su, sv, py, pu, pv, h16, w16, mb,
                                        n_mb, total, items, out);
  return status(cudaGetLastError());
}

// MPEG quantisation's matrices (128 values: intra, inter; raster), into
// the constant memory of the stream's device; synchronous
int mpeg4_set_matrices(const uint16_t* table, int n, cudaStream_t stream) {
  if (n != 128) return 1;
  cudaError_t e = cudaMemcpyToSymbolAsync(kMatrix, table, sizeof(kMatrix), 0,
                                          cudaMemcpyHostToDevice, stream);
  if (e == cudaSuccess) e = cudaStreamSynchronize(stream);
  return status(e);
}

// V4's reciprocals (ops/mpeg4_cuda.recip_table), into the constant memory
// of the stream's device; synchronous
int mpeg4_set_recip(const uint32_t* table, int n, cudaStream_t stream) {
  if (n != 64) return 1;
  cudaError_t e = cudaMemcpyToSymbolAsync(kRecip, table, sizeof(kRecip), 0,
                                          cudaMemcpyHostToDevice, stream);
  if (e == cudaSuccess) e = cudaStreamSynchronize(stream);
  return status(e);
}

}  // extern "C"

#endif  // __CUDACC__
