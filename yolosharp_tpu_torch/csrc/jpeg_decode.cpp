// JPEG decode on the host, bit-exact to libjpeg-turbo 3.1's defaults (the
// decoder behind cv2.imread), in two steps. First every scan's entropy-
// coded data is decoded into per-component int16 coefficient planes:
// Huffman (jdhuff.c, jdphuff.c) or arithmetic (jdarith.c's QM decoder), a
// sequential scan whole, a progressive one as its DC first / DC refine / AC
// first / AC refine pass over its band and bits; with libjpeg's recovery:
// zero bits past the data and the MCUs after skipped, restart markers
// resynchronised (jdmarker.c), a bad code taken as libjpeg takes it. Then,
// once over those planes, block smoothing where a progressive frame's
// scans left low coefficients inexact (jdcoefct.c), dequantisation with the
// integer ISLOW IDCT as the x86 SIMD computes it, "fancy" upsampling
// (jdsample.c, with the context rows of jdmainct.c) and the colour step:
// the fixed-point YCbCr -> RGB of jdcolor.c, or for CMYK / YCCK (YCC ->
// CMYK first) the integer CMYK -> BGR of OpenCV's imgcodecs
// (icvCvt_CMYK2BGR_8u_C4C3R). Integer arithmetic only, so every compiler
// and machine gives the same bytes.
//
// The markers are parsed in Python (yolosharp_tpu_torch/data/jpeg.py); this
// file takes the frame's geometry, each scan's header, Huffman tables,
// arithmetic conditioning and entropy-coded bytes (byte stuffing and RSTn
// markers included, up to and with the marker that ends the scan), the
// quantisation table each component latched at its first scan, and writes
// (height, width, 3) uint8 RGB into the caller's buffer.
//
// Build: c++ -O2 -std=c++17 -fPIC -shared -ffp-contract=off.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kOk = 0;
constexpr int kBadHuffman = 2;    // a code no table holds, a bad table
constexpr int kBadLayout = 3;     // sampling factors this file cannot take
constexpr int kBadScan = 5;       // a scan header this frame cannot take
constexpr int kBadMarker = 6;     // an unknown marker where a scan ends

// jpeg_natural_order: the zig-zag index -> the row-major index, with 16
// extra entries so that a corrupt run past 63 stays in the block
const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ------------------------------------------------------------- Huffman
struct HuffTable {
  // code lengths 1..16: the largest code of each length (-1: none) and the
  // offset of its first symbol in vals
  int32_t maxcode[18];
  int32_t valoffset[17];
  uint8_t vals[256];
  // 9-bit lookahead: (length << 8) | symbol, 0 where the code is longer
  uint16_t look[1 << 9];
};

// jpeg_make_d_derived_tbl; false on a table whose codes overflow, or a DC
// table with a symbol past 15
bool build_table(const uint8_t* bits, const uint8_t* vals, bool dc,
                 HuffTable* t) {
  int huffsize[257];
  uint32_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    for (int i = 0; i < bits[l]; i++) {
      if (p >= 256) return false;
      huffsize[p++] = l;
    }
  }
  huffsize[p] = 0;
  for (int i = 0; dc && i < p; i++) {
    if (vals[i] > 15) return false;
  }
  uint32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1u << si)) return false;
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (bits[l]) {
      t->valoffset[l] = p - static_cast<int>(huffcode[p]);
      p += bits[l];
      t->maxcode[l] = static_cast<int32_t>(huffcode[p - 1]);
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->maxcode[17] = 0x7FFFFFFF;
  std::memcpy(t->vals, vals, 256);
  std::memset(t->look, 0, sizeof(t->look));
  p = 0;
  for (int l = 1; l <= 9; l++) {
    for (int i = 0; i < bits[l]; i++, p++) {
      uint32_t lookbits = huffcode[p] << (9 - l);
      for (int c = 0; c < (1 << (9 - l)); c++) {
        t->look[lookbits + c] = static_cast<uint16_t>((l << 8) | vals[p]);
      }
    }
  }
  return true;
}

// The bytes after an SOS header as libjpeg's data source and marker reader
// (jdatasrc.c, jdmarker.c) hand them to the entropy decoder. A marker that
// the data runs into is kept as the unread marker, and no byte is read past
// it; past the end of the bytes given, the source repeats FF D9 (jdatasrc.c
// inserts a fake EOI at the end of a file).
struct Source {
  const uint8_t* p;
  const uint8_t* end;
  int marker = 0;          // unread_marker: 0 where none is pending
  int next_restart = 0;    // the n of the RSTn due next
  int fake = 0;

  int get() {
    if (p < end) return *p++;
    return (fake++ & 1) ? 0xD9 : 0xFF;
  }
  // next_marker: skip to the next marker (FF xx, xx not 0; fill FFs
  // swallowed) and keep it unread
  void next_marker() {
    for (;;) {
      int c = get();
      while (c != 0xFF) c = get();
      do {
        c = get();
      } while (c == 0xFF);
      if (c != 0) {
        marker = c;
        return;
      }
    }
  }
  // read_restart_marker, with jpeg_resync_to_restart where the marker is
  // not the RSTn due: one of the next two RSTn, or any other valid marker,
  // stays unread (the segments up to it decode as empty); one of the two
  // before it is skipped to the next marker; the rest are swallowed.
  void read_restart_marker() {
    if (marker == 0) next_marker();
    const int want = next_restart;
    next_restart = (next_restart + 1) & 7;
    for (;;) {
      if (marker == 0xD0 + want) {
        marker = 0;
        return;
      }
      int action = 1;
      if (marker < 0xC0) {
        action = 2;
      } else if (marker < 0xD0 || marker > 0xD7) {
        action = 3;
      } else if (marker == 0xD0 + ((want + 1) & 7) ||
                 marker == 0xD0 + ((want + 2) & 7)) {
        action = 3;
      } else if (marker == 0xD0 + ((want - 1) & 7) ||
                 marker == 0xD0 + ((want - 2) & 7)) {
        action = 2;
      }
      if (action == 1) {
        marker = 0;
        return;
      }
      if (action == 3) return;
      next_marker();
    }
  }
};

// jdhuff.c's bit reader over a Source: 0xFF 0x00 is a data byte 0xFF, a
// marker stops the data. Bits taken past the data are zeros, and taking
// one sets insufficient (libjpeg's insufficient_data): the MCU that does so
// is decoded from those zeros, and the MCUs after it up to the next
// restart are skipped.
struct BitReader {
  Source* s;
  uint64_t buf = 0;      // MSB first; the bits past n are zero
  int n = 0;
  bool insufficient = false;

  void fill() {
    while (n <= 56 && s->marker == 0) {
      int c = s->get();
      if (c == 0xFF) {
        do {
          c = s->get();
        } while (c == 0xFF);
        if (c != 0) {
          s->marker = c;
          return;
        }
        c = 0xFF;
      }
      buf |= static_cast<uint64_t>(c) << (56 - n);
      n += 8;
    }
  }
  int peek(int k) {
    if (n < k) fill();
    return static_cast<int>(buf >> (64 - k));
  }
  void skip(int k) {
    if (k > n) {
      fill();
      if (k > n) {
        insufficient = true;
        n = 64;
      }
    }
    buf <<= k;
    n -= k;
  }
  int get(int k) {
    if (k == 0) return 0;
    int v = peek(k);
    skip(k);
    return v;
  }
  // process_restart: the bits left are dropped, the RSTn read; the data
  // counts as there again unless a marker is still pending
  void restart() {
    buf = 0;
    n = 0;
    s->read_restart_marker();
    if (s->marker == 0) insufficient = false;
  }
};

// jpeg_huff_decode: one symbol; a code no table holds takes 17 bits and
// gives 0 (JWRN_HUFF_BAD_CODE)
inline int decode_symbol(BitReader* br, const HuffTable* t) {
  int look = br->peek(9);
  int e = t->look[look];
  if (e) {
    br->skip(e >> 8);
    return e & 0xFF;
  }
  const int code = br->peek(17);
  for (int l = 10; l <= 16; l++) {
    int c = code >> (17 - l);
    if (c <= t->maxcode[l]) {
      br->skip(l);
      return t->vals[(t->valoffset[l] + c) & 0xFF];
    }
  }
  br->skip(17);
  return 0;
}

// HUFF_EXTEND: the s-bit value as a signed coefficient
inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// ------------------------------------------------------------ IDCT ISLOW
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446;
constexpr int32_t FIX_0_390180644 = 3196;
constexpr int32_t FIX_0_541196100 = 4433;
constexpr int32_t FIX_0_765366865 = 6270;
constexpr int32_t FIX_0_899976223 = 7373;
constexpr int32_t FIX_1_175875602 = 9633;
constexpr int32_t FIX_1_501321110 = 12299;
constexpr int32_t FIX_1_847759065 = 15137;
constexpr int32_t FIX_1_961570560 = 16069;
constexpr int32_t FIX_2_053119869 = 16819;
constexpr int32_t FIX_2_562915447 = 20995;
constexpr int32_t FIX_3_072711026 = 25172;

// libjpeg-turbo's x86 SIMD ISLOW IDCT (jidctint-sse2.asm / -avx2.asm, the
// one the x86-64 builds behind cv2 run) in 16-bit lanes: the dequantising
// products, in0 +- in4 and the odd part's z3 / z4 sums wrap at 16 bits,
// the products of two lanes sum in 32 bits, each pass ends in a saturating
// pack to 16 bits, the output in a clamp to [0, 255] (packsswb, + 128). On
// the coefficients of a real image it equals jidctint.c; on wild ones
// (garbage decoded past a cut) it differs from the C, as the SIMD does.
inline int32_t w16(int32_t x) { return static_cast<int16_t>(static_cast<uint16_t>(x)); }
inline int32_t sat16(int32_t x) {
  return x < -32768 ? -32768 : (x > 32767 ? 32767 : x);
}
inline int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
inline int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
// pmaddwd: a * ca + b * cb, the sum wrapping at 32 bits
inline int32_t madd(int32_t a, int32_t ca, int32_t b, int32_t cb) {
  return add32(a * ca, b * cb);
}

// One pass over 8 vectors of 16-bit lanes in[0..7] (the rows of a column,
// or the columns of a row): the 8 outputs, descaled by `shift` with
// rounding and saturated to 16 bits (the dodct macro).
inline void idct_pass(const int32_t* in, int shift, int32_t* out) {
  const int32_t tmp3 = madd(in[2], FIX_0_541196100 + FIX_0_765366865, in[6],
                            FIX_0_541196100);
  const int32_t tmp2 = madd(in[2], FIX_0_541196100, in[6],
                            FIX_0_541196100 - FIX_1_847759065);
  const int32_t tmp0 = w16(in[0] + in[4]) * (1 << kConstBits);
  const int32_t tmp1 = w16(in[0] - in[4]) * (1 << kConstBits);
  const int32_t tmp10 = add32(tmp0, tmp3), tmp13 = sub32(tmp0, tmp3);
  const int32_t tmp11 = add32(tmp1, tmp2), tmp12 = sub32(tmp1, tmp2);
  const int32_t t0 = in[7], t1 = in[5], t2 = in[3], t3 = in[1];
  const int32_t z3 = w16(t0 + t2), z4 = w16(t1 + t3);
  const int32_t z3v = madd(z3, FIX_1_175875602 - FIX_1_961570560, z4,
                           FIX_1_175875602);
  const int32_t z4v = madd(z3, FIX_1_175875602, z4,
                           FIX_1_175875602 - FIX_0_390180644);
  const int32_t o0 = add32(madd(t0, FIX_0_298631336 - FIX_0_899976223, t3,
                                -FIX_0_899976223), z3v);
  const int32_t o3 = add32(madd(t0, -FIX_0_899976223, t3,
                                FIX_1_501321110 - FIX_0_899976223), z4v);
  const int32_t o1 = add32(madd(t1, FIX_2_053119869 - FIX_2_562915447, t2,
                                -FIX_2_562915447), z4v);
  const int32_t o2 = add32(madd(t1, -FIX_2_562915447, t2,
                                FIX_3_072711026 - FIX_2_562915447), z3v);
  const int32_t half = 1 << (shift - 1);
  auto d = [&](int32_t x) { return sat16(add32(x, half) >> shift); };
  out[0] = d(add32(tmp10, o3));
  out[7] = d(sub32(tmp10, o3));
  out[1] = d(add32(tmp11, o2));
  out[6] = d(sub32(tmp11, o2));
  out[2] = d(add32(tmp12, o1));
  out[5] = d(sub32(tmp12, o1));
  out[3] = d(add32(tmp13, o0));
  out[4] = d(sub32(tmp13, o0));
}

// jsimd_idct_islow of one block of coefficients (row-major, natural order)
// with its quantisation table (natural order) into 8 rows of out. Where
// rows 1-7 of the block are all zero, pass 1 is the DC shifted left in 16
// bits.
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                int stride) {
  int32_t ws[64];
  bool ac = false;
  for (int i = 8; i < 64 && !ac; i++) ac = coef[i] != 0;
  if (!ac) {
    for (int c = 0; c < 8; c++) {
      const int32_t dc = w16(w16(coef[c] * static_cast<int32_t>(q[c])) * 4);
      for (int r = 0; r < 8; r++) ws[8 * r + c] = dc;
    }
  } else {
    for (int c = 0; c < 8; c++) {
      int32_t in[8], o[8];
      for (int r = 0; r < 8; r++) {
        in[r] = w16(coef[8 * r + c] * static_cast<int32_t>(q[8 * r + c]));
      }
      idct_pass(in, kConstBits - kPass1Bits, o);
      for (int r = 0; r < 8; r++) ws[8 * r + c] = o[r];
    }
  }
  for (int r = 0; r < 8; r++) {
    int32_t o[8];
    idct_pass(ws + 8 * r, kConstBits + kPass1Bits + 3, o);
    uint8_t* row = out + static_cast<int64_t>(r) * stride;
    for (int c = 0; c < 8; c++) {
      const int32_t v = o[c] < -128 ? -128 : (o[c] > 127 ? 127 : o[c]);
      row[c] = static_cast<uint8_t>(v + 128);
    }
  }
}

// ------------------------------------------------------------ upsampling
struct Plane {
  std::vector<uint8_t> px;   // the IDCT output, whole blocks
  int stride = 0;            // blocks across * 8
  int rows = 0;              // blocks down * 8
  int dw = 0, dh = 0;        // downsampled_width / _height
  int h = 1, v = 1;          // sampling factors
  const uint8_t* row(int r) const {
    return px.data() + static_cast<int64_t>(r) * stride;
  }
};

inline int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// One component at full resolution (height rows of width samples) as
// jdsample.c's method for its expansion computes it: the fancy triangle
// filters at 2x (the 2x horizontal ones only where downsampled_width > 2),
// edge samples replicated, the rows above the first and below the last
// real row replicated as jdmainct.c supplies them; box replication
// otherwise.
void upsample(const Plane& p, int hx, int vx, int width, int height,
              uint8_t* out) {
  if (hx == 1 && vx == 1) {
    for (int y = 0; y < height; y++) {
      std::memcpy(out + static_cast<int64_t>(y) * width, p.row(y), width);
    }
    return;
  }
  const int dw = p.dw, dh = p.dh;
  if (hx == 2 && vx == 1 && dw > 2) {          // h2v1_fancy_upsample
    for (int y = 0; y < height; y++) {
      const uint8_t* in = p.row(y);
      uint8_t* o = out + static_cast<int64_t>(y) * width;
      for (int x = 0; x < width; x++) {
        int i = x >> 1;
        int near = in[i] * 3;
        o[x] = static_cast<uint8_t>(
            (x & 1) ? (near + in[clampi(i + 1, 0, dw - 1)] + 2) >> 2
                    : (near + in[clampi(i - 1, 0, dw - 1)] + 1) >> 2);
      }
    }
    return;
  }
  if (hx == 1 && vx == 2) {                    // h1v2_fancy_upsample
    for (int y = 0; y < height; y++) {
      int r = y >> 1;
      const uint8_t* in0 = p.row(r);
      const uint8_t* in1 = p.row(clampi((y & 1) ? r + 1 : r - 1, 0, dh - 1));
      int bias = (y & 1) ? 2 : 1;
      uint8_t* o = out + static_cast<int64_t>(y) * width;
      for (int x = 0; x < width; x++) {
        o[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
      }
    }
    return;
  }
  if (hx == 2 && vx == 2 && dw > 2) {          // h2v2_fancy_upsample
    std::vector<int> sum(dw);
    for (int y = 0; y < height; y++) {
      int r = y >> 1;
      const uint8_t* in0 = p.row(r);
      const uint8_t* in1 = p.row(clampi((y & 1) ? r + 1 : r - 1, 0, dh - 1));
      for (int i = 0; i < dw; i++) sum[i] = in0[i] * 3 + in1[i];
      uint8_t* o = out + static_cast<int64_t>(y) * width;
      for (int x = 0; x < width; x++) {
        int i = x >> 1;
        int near = sum[i] * 3;
        o[x] = static_cast<uint8_t>(
            (x & 1) ? (near + sum[clampi(i + 1, 0, dw - 1)] + 7) >> 4
                    : (near + sum[clampi(i - 1, 0, dw - 1)] + 8) >> 4);
      }
    }
    return;
  }
  // h2v1_upsample, h2v2_upsample and int_upsample: box replication
  for (int y = 0; y < height; y++) {
    const uint8_t* in = p.row(y / vx);
    uint8_t* o = out + static_cast<int64_t>(y) * width;
    for (int x = 0; x < width; x++) o[x] = in[x / hx];
  }
}

// ------------------------------------------------------------ colour
// jdcolor.c's build_ycc_rgb_table (SCALEBITS 16)
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t one_half = int64_t{1} << 15;
    auto fix = [](double x) {
      return static_cast<int64_t>(x * 65536.0 + 0.5);
    };
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = static_cast<int32_t>(-fix(0.71414) * x);
      cb_g[i] = static_cast<int32_t>(-fix(0.34414) * x + one_half);
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

}  // namespace

namespace {


// ------------------------------------------------------------ coefficients
// One component's quantised DCT coefficients, row-major (natural order)
// within each block, blocks in raster order over the frame's MCU grid
// (bw x bh blocks; the dummy blocks of the last MCU row / column included).
struct Coefs {
  int h = 1, v = 1;          // sampling factors
  int dw = 0, dh = 0;        // downsampled_width / _height
  int cbw = 0, cbh = 0;      // blocks that cover the component
  int bw = 0, bh = 0;        // blocks of the MCU grid
  std::vector<int16_t> c;
  int16_t* block(int bx, int by) {
    return c.data() + (static_cast<int64_t>(by) * bw + bx) * 64;
  }
};

// The fields of one scan header, as jpeg.py packs them (kScanFields int32
// a scan): Ns, then for each of 4 slots the component index, its DC and AC
// table, then Ss, Se, Ah, Al, the restart interval in force, and the
// arithmetic conditioning in force (DAC): L | U << 4 of DC tables 0-15,
// then Kx of AC tables 0-15.
constexpr int kScanFields = 50;

// ------------------------------------------------------------ arithmetic
// T.81 Table D.3, packed as jaricom.c packs it: Qe << 16 | Next_Index_MPS
// << 8 | Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed
// probability 0.5 of fixed_bin.
#define QM(qe, lps, mps, sw) \
  ((static_cast<int64_t>(qe) << 16) | ((mps) << 8) | ((sw) << 7) | (lps))
const int64_t kAritab[114] = {
    QM(0x5a1d, 1, 1, 1),     QM(0x2586, 14, 2, 0),    QM(0x1114, 16, 3, 0),
    QM(0x080b, 18, 4, 0),    QM(0x03d8, 20, 5, 0),    QM(0x01da, 23, 6, 0),
    QM(0x00e5, 25, 7, 0),    QM(0x006f, 28, 8, 0),    QM(0x0036, 30, 9, 0),
    QM(0x001a, 33, 10, 0),   QM(0x000d, 35, 11, 0),   QM(0x0006, 9, 12, 0),
    QM(0x0003, 10, 13, 0),   QM(0x0001, 12, 13, 0),   QM(0x5a7f, 15, 15, 1),
    QM(0x3f25, 36, 16, 0),   QM(0x2cf2, 38, 17, 0),   QM(0x207c, 39, 18, 0),
    QM(0x17b9, 40, 19, 0),   QM(0x1182, 42, 20, 0),   QM(0x0cef, 43, 21, 0),
    QM(0x09a1, 45, 22, 0),   QM(0x072f, 46, 23, 0),   QM(0x055c, 48, 24, 0),
    QM(0x0406, 49, 25, 0),   QM(0x0303, 51, 26, 0),   QM(0x0240, 52, 27, 0),
    QM(0x01b1, 54, 28, 0),   QM(0x0144, 56, 29, 0),   QM(0x00f5, 57, 30, 0),
    QM(0x00b7, 59, 31, 0),   QM(0x008a, 60, 32, 0),   QM(0x0068, 62, 33, 0),
    QM(0x004e, 63, 34, 0),   QM(0x003b, 32, 35, 0),   QM(0x002c, 33, 9, 0),
    QM(0x5ae1, 37, 37, 1),   QM(0x484c, 64, 38, 0),   QM(0x3a0d, 65, 39, 0),
    QM(0x2ef1, 67, 40, 0),   QM(0x261f, 68, 41, 0),   QM(0x1f33, 69, 42, 0),
    QM(0x19a8, 70, 43, 0),   QM(0x1518, 72, 44, 0),   QM(0x1177, 73, 45, 0),
    QM(0x0e74, 74, 46, 0),   QM(0x0bfb, 75, 47, 0),   QM(0x09f8, 77, 48, 0),
    QM(0x0861, 78, 49, 0),   QM(0x0706, 79, 50, 0),   QM(0x05cd, 48, 51, 0),
    QM(0x04de, 50, 52, 0),   QM(0x040f, 50, 53, 0),   QM(0x0363, 51, 54, 0),
    QM(0x02d4, 52, 55, 0),   QM(0x025c, 53, 56, 0),   QM(0x01f8, 54, 57, 0),
    QM(0x01a4, 55, 58, 0),   QM(0x0160, 56, 59, 0),   QM(0x0125, 57, 60, 0),
    QM(0x00f6, 58, 61, 0),   QM(0x00cb, 59, 62, 0),   QM(0x00ab, 61, 63, 0),
    QM(0x008f, 61, 32, 0),   QM(0x5b12, 65, 65, 1),   QM(0x4d04, 80, 66, 0),
    QM(0x412c, 81, 67, 0),   QM(0x37d8, 82, 68, 0),   QM(0x2fe8, 83, 69, 0),
    QM(0x293c, 84, 70, 0),   QM(0x2379, 86, 71, 0),   QM(0x1edf, 87, 72, 0),
    QM(0x1aa9, 87, 73, 0),   QM(0x174e, 72, 74, 0),   QM(0x1424, 72, 75, 0),
    QM(0x119c, 74, 76, 0),   QM(0x0f6b, 74, 77, 0),   QM(0x0d51, 75, 78, 0),
    QM(0x0bb6, 77, 79, 0),   QM(0x0a40, 77, 48, 0),   QM(0x5832, 80, 81, 1),
    QM(0x4d1c, 88, 82, 0),   QM(0x438e, 89, 83, 0),   QM(0x3bdd, 90, 84, 0),
    QM(0x34ee, 91, 85, 0),   QM(0x2eae, 92, 86, 0),   QM(0x299a, 93, 87, 0),
    QM(0x2516, 86, 71, 0),   QM(0x5570, 88, 89, 1),   QM(0x4ca9, 95, 90, 0),
    QM(0x44d9, 96, 91, 0),   QM(0x3e22, 97, 92, 0),   QM(0x3824, 99, 93, 0),
    QM(0x32b4, 99, 94, 0),   QM(0x2e17, 93, 86, 0),   QM(0x56a8, 95, 96, 1),
    QM(0x4f46, 101, 97, 0),  QM(0x47e5, 102, 98, 0),  QM(0x41cf, 103, 99, 0),
    QM(0x3c3d, 104, 100, 0), QM(0x375e, 99, 93, 0),   QM(0x5231, 105, 102, 0),
    QM(0x4c0f, 106, 103, 0), QM(0x4639, 107, 104, 0), QM(0x415e, 103, 99, 0),
    QM(0x5627, 105, 106, 1), QM(0x50e7, 108, 107, 0), QM(0x4b85, 109, 103, 0),
    QM(0x5597, 110, 109, 0), QM(0x504f, 111, 107, 0), QM(0x5a10, 110, 111, 1),
    QM(0x5522, 112, 109, 0), QM(0x59eb, 112, 111, 1), QM(0x5a1d, 113, 113, 0)};
#undef QM

// jdarith.c's QM decoder over a Source: C and A registers, the bit counter
// ct (-16 until two bytes are in; -1 after JWRN_ARITH_BAD_CODE, which makes
// the rest of the scan up to the next restart decode as nothing), zero
// bytes supplied once a marker is hit.
struct Arith {
  Source* s;
  int64_t c = 0, a = 0;
  int ct = -16;
  uint8_t dc_stats[16][64] = {};
  uint8_t ac_stats[16][256] = {};
  uint8_t fixed_bin[4] = {113, 0, 0, 0};

  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int data = 0;
        if (s->marker == 0) {
          data = s->get();
          if (data == 0xFF) {
            do {
              data = s->get();
            } while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              s->marker = data;
              data = 0;
            }
          }
        }
        c = (c << 8) | data;
        if ((ct += 8) < 0) {
          if (++ct == 0) a = 0x8000;
        }
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    const int nl = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    const int nm = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

struct ScanState {
  Source src;
  BitReader br{&src};
  Arith ar{&src};
  const HuffTable* dct[4] = {};
  const HuffTable* act[4] = {};
  int dtbl[4] = {}, atbl[4] = {};
  int dc_l[16] = {}, dc_u[16] = {}, ac_k[16] = {};
  int pred[4] = {0, 0, 0, 0};
  int dc_context[4] = {0, 0, 0, 0};
  int eobrun = 0;
  int ss = 0, se = 63, ah = 0, al = 0;
};

// jdhuff.c decode_mcu_slow for one block of a sequential scan
void block_sequential(ScanState* s, int k, int16_t* blk) {
  BitReader* br = &s->br;
  int t = decode_symbol(br, s->dct[k]);
  int d = t ? extend(br->get(t), t) : 0;
  s->pred[k] = static_cast<int>(static_cast<unsigned>(s->pred[k]) +
                                static_cast<unsigned>(d));
  blk[0] = static_cast<int16_t>(s->pred[k]);
  for (int i = 1; i < 64; i++) {
    int rs = decode_symbol(br, s->act[k]);
    int r = rs >> 4;
    t = rs & 15;
    if (t) {
      i += r;
      blk[kNaturalOrder[i]] = static_cast<int16_t>(extend(br->get(t), t));
    } else {
      if (r != 15) break;
      i += 15;
    }
  }
}

// jdphuff.c decode_mcu_DC_first / decode_mcu_DC_refine for one block
void block_dc(ScanState* s, int k, int16_t* blk) {
  BitReader* br = &s->br;
  if (s->ah) {
    if (br->get(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << s->al));
    return;
  }
  int t = decode_symbol(br, s->dct[k]);
  int d = t ? extend(br->get(t), t) : 0;
  s->pred[k] = static_cast<int>(static_cast<unsigned>(s->pred[k]) +
                                static_cast<unsigned>(d));
  blk[0] = static_cast<int16_t>(static_cast<uint32_t>(s->pred[k]) << s->al);
}

// jdphuff.c decode_mcu_AC_first for one block
void block_ac_first(ScanState* s, int16_t* blk) {
  if (s->eobrun > 0) {
    s->eobrun--;
    return;
  }
  BitReader* br = &s->br;
  for (int k = s->ss; k <= s->se; k++) {
    int rs = decode_symbol(br, s->act[0]);
    int r = rs >> 4, t = rs & 15;
    if (t) {
      k += r;
      int v = extend(br->get(t), t);
      blk[kNaturalOrder[k]] =
          static_cast<int16_t>(static_cast<uint32_t>(v) << s->al);
    } else if (r == 15) {
      k += 15;
    } else {
      s->eobrun = 1 << r;
      if (r) s->eobrun += br->get(r);
      s->eobrun--;
      break;
    }
  }
}

// jdphuff.c decode_mcu_AC_refine for one block: a correction bit for each
// coefficient of the band that is already nonzero (inside an EOB run too),
// a new coefficient of +-1 << Al where a symbol places one (a symbol of
// another size is a warning there: it places one all the same).
void block_ac_refine(ScanState* s, int16_t* blk) {
  BitReader* br = &s->br;
  const int p1 = 1 << s->al;
  const int m1 = -p1;
  int k = s->ss;
  auto correct = [&](int16_t* c) {
    if (br->get(1) && (*c & p1) == 0) {
      *c = static_cast<int16_t>(*c + (*c >= 0 ? p1 : m1));
    }
  };
  if (s->eobrun == 0) {
    for (; k <= s->se; k++) {
      int rs = decode_symbol(br, s->act[0]);
      int r = rs >> 4, t = rs & 15, value = 0;
      if (t) {
        value = br->get(1) ? p1 : m1;
      } else if (r != 15) {
        s->eobrun = 1 << r;
        if (r) s->eobrun += br->get(r);
        break;                   // the rest of the band: the EOB run below
      }
      // pass r zero coefficients, correcting the nonzero ones on the way
      do {
        int16_t* c = blk + kNaturalOrder[k];
        if (*c != 0) {
          correct(c);
        } else if (--r < 0) {
          break;                 // the zero that takes the new value
        }
        k++;
      } while (k <= s->se);
      if (value) blk[kNaturalOrder[k]] = static_cast<int16_t>(value);
    }
  }
  if (s->eobrun > 0) {
    for (; k <= s->se; k++) {
      int16_t* c = blk + kNaturalOrder[k];
      if (*c != 0) correct(c);
    }
    s->eobrun--;
  }
}

// jdarith.c's DC difference (Figures F.19 to F.24) of the scan's k-th
// component, added to its prediction; false on JWRN_ARITH_BAD_CODE
bool arith_dc(ScanState* s, int k) {
  Arith& e = s->ar;
  const int tbl = s->dtbl[k];
  uint8_t* st = e.dc_stats[tbl] + s->dc_context[k];
  if (e.decode(st) == 0) {
    s->dc_context[k] = 0;
    return true;
  }
  const int sign = e.decode(st + 1);
  st += 2 + sign;
  int m = e.decode(st);
  if (m != 0) {
    st = e.dc_stats[tbl] + 20;
    while (e.decode(st)) {
      if ((m <<= 1) == 0x8000) {
        e.ct = -1;
        return false;
      }
      st += 1;
    }
  }
  if (m < static_cast<int>((1L << s->dc_l[tbl]) >> 1)) {
    s->dc_context[k] = 0;
  } else if (m > static_cast<int>((1L << s->dc_u[tbl]) >> 1)) {
    s->dc_context[k] = 12 + sign * 4;
  } else {
    s->dc_context[k] = 4 + sign * 4;
  }
  int v = m;
  st += 14;
  while (m >>= 1) {
    if (e.decode(st)) v |= m;
  }
  v += 1;
  if (sign) v = -v;
  s->pred[k] = (s->pred[k] + v) & 0xFFFF;
  return true;
}

// jdarith.c's AC coefficients k0..k1 of one block of the scan's c-th
// component (Figure F.20), each scaled by << al; false on
// JWRN_ARITH_BAD_CODE
bool arith_ac(ScanState* s, int c, int k0, int k1, int al, int16_t* blk) {
  Arith& e = s->ar;
  const int tbl = s->atbl[c];
  for (int k = k0; k <= k1; k++) {
    uint8_t* st = e.ac_stats[tbl] + 3 * (k - 1);
    if (e.decode(st)) break;                   // EOB
    while (e.decode(st + 1) == 0) {
      st += 3;
      if (++k > k1) {
        e.ct = -1;                             // spectral overflow
        return false;
      }
    }
    const int sign = e.decode(e.fixed_bin);
    st += 2;
    int m = e.decode(st);
    if (m != 0) {
      if (e.decode(st)) {
        m <<= 1;
        st = e.ac_stats[tbl] + (k <= s->ac_k[tbl] ? 189 : 217);
        while (e.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            e.ct = -1;                         // magnitude overflow
            return false;
          }
          st += 1;
        }
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1) {
      if (e.decode(st)) v |= m;
    }
    v += 1;
    if (sign) v = -v;
    blk[kNaturalOrder[k]] =
        static_cast<int16_t>(static_cast<uint32_t>(v) << al);
  }
  return true;
}

// jdarith.c decode_mcu_AC_refine for one block
void arith_ac_refine(ScanState* s, int16_t* blk) {
  Arith& e = s->ar;
  const int tbl = s->atbl[0];
  const int p1 = 1 << s->al;
  const int m1 = -p1;
  int kex = s->se;
  for (; kex > 0; kex--) {
    if (blk[kNaturalOrder[kex]]) break;
  }
  for (int k = s->ss; k <= s->se; k++) {
    uint8_t* st = e.ac_stats[tbl] + 3 * (k - 1);
    if (k > kex && e.decode(st)) break;        // EOB
    for (;;) {
      int16_t* c = blk + kNaturalOrder[k];
      if (*c) {
        if (e.decode(st + 2)) *c = static_cast<int16_t>(*c + (*c < 0 ? m1 : p1));
        break;
      }
      if (e.decode(st + 1)) {
        *c = static_cast<int16_t>(e.decode(e.fixed_bin) ? m1 : p1);
        break;
      }
      st += 3;
      if (++k > s->se) {
        e.ct = -1;
        return;
      }
    }
  }
}

// The start of an arithmetic scan or restart interval: the statistics of
// the tables the scan codes with zeroed, the predictions reset, the
// registers emptied (jdarith.c start_pass / process_restart).
void arith_reset(ScanState* s, int ns, bool progressive) {
  for (int k = 0; k < ns; k++) {
    if (!progressive || (s->ss == 0 && s->ah == 0)) {
      std::memset(s->ar.dc_stats[s->dtbl[k]], 0, 64);
      s->pred[k] = 0;
      s->dc_context[k] = 0;
    }
    if (!progressive || s->ss) std::memset(s->ar.ac_stats[s->atbl[k]], 0, 256);
  }
  s->ar.c = 0;
  s->ar.a = 0;
  s->ar.ct = -16;
}

// Decode one scan into the coefficient planes. An interleaved scan (Ns > 1)
// walks the MCU grid, hmax x vmax blocks of samples an MCU; a scan of one
// component walks the blocks that cover that component, one an MCU. A
// restart interval starts with its RSTn (resynchronised as libjpeg does);
// Huffman MCUs after the data ran out are skipped up to the next restart,
// arithmetic ones after a bad code likewise. Sets last_good_row to
// libjpeg's last_good_iMCU_row: the iMCU row of the last MCU that was
// started with the data not yet run out. Returns kBadMarker where the
// marker after the scan (past any RSTn or TEM, which libjpeg's marker
// reader skips) is one below 0xC0, which it refuses (JERR_UNKNOWN_MARKER),
// else kOk.
int decode_scan(std::vector<Coefs>& comps, bool progressive, bool arith,
                const int32_t* f, const uint8_t* data, int64_t len,
                const HuffTable* dc, const HuffTable* ac, int mcux, int mcuy,
                int* last_good_row) {
  const int ns = f[0];
  ScanState s{Source{data, data + len}};
  int idx[4];
  for (int k = 0; k < ns; k++) {
    idx[k] = f[1 + 3 * k];
    s.dtbl[k] = f[2 + 3 * k];
    s.atbl[k] = f[3 + 3 * k];
    s.dct[k] = &dc[s.dtbl[k] & 3];
    s.act[k] = &ac[s.atbl[k] & 3];
  }
  s.ss = f[13];
  s.se = f[14];
  s.ah = f[15];
  s.al = f[16];
  const int restart_interval = f[17];
  for (int t = 0; t < 16; t++) {
    s.dc_l[t] = f[18 + t] & 15;
    s.dc_u[t] = f[18 + t] >> 4;
    s.ac_k[t] = f[34 + t];
  }
  if (arith) arith_reset(&s, ns, progressive);
  int16_t* mcu[40];  // one MCU of blocks, in MCU order
  int nblk = 0;
  Coefs& lone = comps[idx[0]];
  const int64_t n_mcu = ns > 1 ? static_cast<int64_t>(mcux) * mcuy
                               : static_cast<int64_t>(lone.cbw) * lone.cbh;
  int comp_of[40];
  int64_t restarts_to_go = restart_interval;
  int last_good = 0;
  for (int64_t m = 0; m < n_mcu; m++) {
    if (!s.br.insufficient) {
      last_good = static_cast<int>(ns > 1 ? m / mcux
                                          : m / lone.cbw / lone.v);
    }
    if (restart_interval) {
      if (restarts_to_go == 0) {
        if (arith) {
          s.src.read_restart_marker();
          arith_reset(&s, ns, progressive);
        } else {
          s.br.restart();
          for (int k = 0; k < 4; k++) s.pred[k] = 0;
          s.eobrun = 0;
        }
        restarts_to_go = restart_interval;
      }
      restarts_to_go--;
    }
    nblk = 0;
    if (ns > 1) {
      int my = static_cast<int>(m / mcux), mx = static_cast<int>(m % mcux);
      for (int k = 0; k < ns; k++) {
        Coefs& c = comps[idx[k]];
        for (int by = 0; by < c.v; by++) {
          for (int bx = 0; bx < c.h; bx++) {
            comp_of[nblk] = k;
            mcu[nblk++] = c.block(mx * c.h + bx, my * c.v + by);
          }
        }
      }
    } else {
      comp_of[0] = 0;
      mcu[nblk++] = lone.block(static_cast<int>(m % lone.cbw),
                               static_cast<int>(m / lone.cbw));
    }
    if (!arith) {
      if (s.br.insufficient) continue;
      for (int b = 0; b < nblk; b++) {
        const int k = comp_of[b];
        if (!progressive) {
          block_sequential(&s, k, mcu[b]);
        } else if (s.ss == 0) {
          block_dc(&s, k, mcu[b]);
        } else if (s.ah) {
          block_ac_refine(&s, mcu[b]);
        } else {
          block_ac_first(&s, mcu[b]);
        }
      }
      continue;
    }
    // arithmetic: decode_mcu / _DC_first / _AC_first / _DC_refine /
    // _AC_refine; all but DC refine do nothing after a bad code
    if (progressive && s.ss == 0 && s.ah) {
      for (int b = 0; b < nblk; b++) {
        if (s.ar.decode(s.ar.fixed_bin)) {
          mcu[b][0] = static_cast<int16_t>(mcu[b][0] | (1 << s.al));
        }
      }
      continue;
    }
    if (s.ar.ct == -1) continue;
    for (int b = 0; b < nblk; b++) {
      const int k = comp_of[b];
      if (!progressive) {
        if (!arith_dc(&s, k)) break;
        mcu[b][0] = static_cast<int16_t>(s.pred[k]);
        if (!arith_ac(&s, k, 1, 63, 0, mcu[b])) break;
      } else if (s.ss == 0) {
        if (!arith_dc(&s, k)) break;
        mcu[b][0] = static_cast<int16_t>(
            static_cast<uint32_t>(s.pred[k]) << s.al);
      } else if (s.ah) {
        arith_ac_refine(&s, mcu[b]);
      } else {
        arith_ac(&s, 0, s.ss, s.se, s.al, mcu[b]);
      }
    }
  }
  *last_good_row = last_good;
  for (;;) {
    if (s.src.marker == 0) s.src.next_marker();
    const int m = s.src.marker;
    if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
      s.src.marker = 0;
      continue;
    }
    return m < 0xC0 ? kBadMarker : kOk;
  }
}

// ------------------------------------------------------------ smoothing
// jdcoefct.c decompress_smooth_data for one block of a progressive frame
// whose scans left some of the first 9 AC coefficients inexact: the block
// (coefficients as decoded) copied into w, then each of those coefficients
// that is still 0 and not known exactly (coef_bits, libjpeg's
// coef_bits_latch: the Al of the last scan of each, -1 for none) estimated
// from the DC values of the 5 x 5 blocks around it; where no AC
// coefficient was sent at all, the DC too. Columns past the frame's edge
// repeat the edge; rows repeat it as libjpeg's image_block_row test does.
void smooth_block(Coefs& p, int bx, int by, int imcu_rows, const uint16_t* q,
                  const int32_t* bits, int16_t* w) {
  std::memcpy(w, p.block(bx, by), 64 * sizeof(int16_t));
  const int v = p.v, R = by / v, b = by % v, last = imcu_rows - 1;
  int block_rows = v;
  if (R == last) {
    block_rows = p.cbh % v;
    if (block_rows == 0) block_rows = v;
  }
  // image_block_row against block_rows * total_iMCU_rows, block_rows
  // being the current iMCU row's (fewer in a short last one)
  const int image_rows = block_rows * imcu_rows, r = R * block_rows + b;
  const int prev = r > 0 ? by - 1 : by;
  const int pprev = r > 1 ? by - 2 : prev;
  const int next = r < image_rows - 1 ? by + 1 : by;
  const int nnext = r < image_rows - 2 ? by + 2 : next;
  const int rows[5] = {pprev, prev, by, next, nnext};
  int64_t d[26];
  for (int r = 0; r < 5; r++) {
    for (int c = 0; c < 5; c++) {
      d[1 + 5 * r + c] = p.block(clampi(bx + c - 2, 0, p.cbw - 1), rows[r])[0];
    }
  }
  bool change_dc = true;
  for (int i = 1; i <= 9; i++) change_dc = change_dc && bits[i] == -1;
  const int64_t q00 = q[0];
  auto set = [&](int pos, int coef, int64_t dcsum) {
    const int al = bits[coef];
    if (al == 0 || w[pos] != 0) return;
    const int64_t num = q00 * dcsum;
    const int64_t qk = q[pos];
    int pred;
    if (num >= 0) {
      pred = static_cast<int>(((qk << 7) + num) / (qk << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    } else {
      pred = static_cast<int>(((qk << 7) - num) / (qk << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      pred = -pred;
    }
    w[pos] = static_cast<int16_t>(pred);
  };
#define DC(i) d[i]
  // AC01
  set(1, 1, change_dc
      ? (-DC(1) - DC(2) + DC(4) + DC(5) - 3 * DC(6) + 13 * DC(7) -
         13 * DC(9) + 3 * DC(10) - 3 * DC(11) + 38 * DC(12) - 38 * DC(14) +
         3 * DC(15) - 3 * DC(16) + 13 * DC(17) - 13 * DC(19) + 3 * DC(20) -
         DC(21) - DC(22) + DC(24) + DC(25))
      : (-7 * DC(11) + 50 * DC(12) - 50 * DC(14) + 7 * DC(15)));
  // AC10
  set(8, 2, change_dc
      ? (-DC(1) - 3 * DC(2) - 3 * DC(3) - 3 * DC(4) - DC(5) - DC(6) +
         13 * DC(7) + 38 * DC(8) + 13 * DC(9) - DC(10) + DC(16) -
         13 * DC(17) - 38 * DC(18) - 13 * DC(19) + DC(20) + DC(21) +
         3 * DC(22) + 3 * DC(23) + 3 * DC(24) + DC(25))
      : (-7 * DC(3) + 50 * DC(8) - 50 * DC(18) + 7 * DC(23)));
  // AC20
  set(16, 3, change_dc
      ? (DC(3) + 2 * DC(7) + 7 * DC(8) + 2 * DC(9) - 5 * DC(12) -
         14 * DC(13) - 5 * DC(14) + 2 * DC(17) + 7 * DC(18) + 2 * DC(19) +
         DC(23))
      : (-DC(3) + 13 * DC(8) - 24 * DC(13) + 13 * DC(18) - DC(23)));
  // AC11
  set(9, 4, change_dc
      ? (-DC(1) + DC(5) + 9 * DC(7) - 9 * DC(9) - 9 * DC(17) + 9 * DC(19) +
         DC(21) - DC(25))
      : (DC(10) + DC(16) - 10 * DC(17) + 10 * DC(19) - DC(2) - DC(20) +
         DC(22) - DC(24) + DC(4) - DC(6) + 10 * DC(7) - 10 * DC(9)));
  // AC02
  set(2, 5, change_dc
      ? (2 * DC(7) - 5 * DC(8) + 2 * DC(9) + DC(11) + 7 * DC(12) -
         14 * DC(13) + 7 * DC(14) + DC(15) + 2 * DC(17) - 5 * DC(18) +
         2 * DC(19))
      : (-DC(11) + 13 * DC(12) - 24 * DC(13) + 13 * DC(14) - DC(15)));
  if (change_dc) {
    set(3, 6, DC(7) - DC(9) + 2 * DC(12) - 2 * DC(14) + DC(17) - DC(19));
    set(10, 7, DC(7) - 3 * DC(8) + DC(9) - DC(17) + 3 * DC(18) - DC(19));
    set(17, 8, DC(7) - DC(9) - 3 * DC(12) + 3 * DC(14) + DC(17) - DC(19));
    set(24, 9, DC(7) + 2 * DC(8) + DC(9) - DC(17) - 2 * DC(18) - DC(19));
    const int64_t num = q00 * (
        -2 * DC(1) - 6 * DC(2) - 8 * DC(3) - 6 * DC(4) - 2 * DC(5) -
        6 * DC(6) + 6 * DC(7) + 42 * DC(8) + 6 * DC(9) - 6 * DC(10) -
        8 * DC(11) + 42 * DC(12) + 152 * DC(13) + 42 * DC(14) - 8 * DC(15) -
        6 * DC(16) + 6 * DC(17) + 42 * DC(18) + 6 * DC(19) - 6 * DC(20) -
        2 * DC(21) - 6 * DC(22) - 8 * DC(23) - 6 * DC(24) - 2 * DC(25));
    int pred;
    if (num >= 0) {
      pred = static_cast<int>(((q00 << 7) + num) / (q00 << 8));
    } else {
      pred = -static_cast<int>(((q00 << 7) - num) / (q00 << 8));
    }
    w[0] = static_cast<int16_t>(pred);
  }
#undef DC
}

}  // namespace

extern "C" {

// Decode a frame of ncomp (1, 3 or 4) components from its scans.
//   width, height: the frame's size; comp_h / comp_v: each component's
//     sampling factors, in the frame's order; mode: bit 0 progressive
//     (SOF2 / SOF10), bit 1 arithmetic-coded (SOF9 / SOF10);
//   n_scans scans: the bytes of scan i are data[offsets[i] ..
//     offsets[i + 1]) (after its SOS header, up to and with the marker that
//     ends it); fields: kScanFields int32 a scan (see above);
//     dc_bits / ac_bits: 4 x 17 code counts (index 0 unused) a scan,
//     dc_vals / ac_vals: 4 x 256 symbols a scan, the tables defined at its
//     SOS; tables: bit t of a DC, bit 4 + t of an AC table defined there;
//   qtables: ncomp x 64 quantisation values in natural order, the table
//     each component latched at its first scan;
//   coef_bits: ncomp x 20 where the blocks are smoothed, else null: of each
//     component libjpeg's coef_bits_latch (10), then the latch of its bits
//     before its last scan (10), which the iMCU rows past the data of an
//     incomplete last scan take;
//   color: 0 grayscale, 1 YCbCr, 2 RGB (no conversion), 3 CMYK (Adobe, as
//     libjpeg hands the four channels over), 4 YCCK;
//   out: height * width * 3 bytes, RGB.
// Returns 0, or an error code (see kBadHuffman ... kBadMarker).
int ys_jpeg_decode(int width, int height, int ncomp, const int32_t* comp_h,
                   const int32_t* comp_v, int mode, int n_scans,
                   const uint8_t* data, const int64_t* offsets,
                   const int32_t* fields, const uint8_t* dc_bits,
                   const uint8_t* dc_vals, const uint8_t* ac_bits,
                   const uint8_t* ac_vals, const int32_t* tables,
                   const uint16_t* qtables, const int32_t* coef_bits,
                   int color, uint8_t* out) {
  const bool progressive = mode & 1, arith = mode & 2;
  if (ncomp < 1 || ncomp > 4 || width < 1 || height < 1) return kBadLayout;
  int hmax = 1, vmax = 1;
  for (int c = 0; c < ncomp; c++) {
    if (comp_h[c] < 1 || comp_h[c] > 4 || comp_v[c] < 1 || comp_v[c] > 4) {
      return kBadLayout;
    }
    hmax = comp_h[c] > hmax ? comp_h[c] : hmax;
    vmax = comp_v[c] > vmax ? comp_v[c] : vmax;
  }
  for (int c = 0; c < ncomp; c++) {
    if (hmax % comp_h[c] || vmax % comp_v[c]) return kBadLayout;
  }
  const int mcux = (width + 8 * hmax - 1) / (8 * hmax);
  const int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
  std::vector<Coefs> comps(ncomp);
  for (int c = 0; c < ncomp; c++) {
    Coefs& p = comps[c];
    p.h = comp_h[c];
    p.v = comp_v[c];
    p.dw = static_cast<int>((static_cast<int64_t>(width) * p.h + hmax - 1) /
                            hmax);
    p.dh = static_cast<int>((static_cast<int64_t>(height) * p.v + vmax - 1) /
                            vmax);
    p.cbw = (p.dw + 7) / 8;
    p.cbh = (p.dh + 7) / 8;
    p.bw = mcux * p.h;
    p.bh = mcuy * p.v;
    p.c.assign(static_cast<size_t>(p.bw) * p.bh * 64, 0);
  }

  HuffTable dc[4], ac[4];
  int last_good = mcuy - 1;
  for (int i = 0; i < n_scans; i++) {
    const int32_t* f = fields + kScanFields * i;
    const int ns = f[0];
    if (ns < 1 || ns > 4 || (progressive && f[13] > 0 && ns != 1)) {
      return kBadScan;
    }
    int blocks = 0;
    // the tables this scan decodes with (the Huffman ones built from those
    // of its SOS); only those must exist
    const bool dc_used = !progressive || (f[13] == 0 && f[15] == 0);
    const bool ac_used = !progressive || f[13] > 0;
    for (int k = 0; k < ns; k++) {
      const int c = f[1 + 3 * k];
      const int top = arith ? 15 : 3;   // NUM_ARITH_TBLS, NUM_HUFF_TBLS
      if (c < 0 || c >= ncomp || (dc_used && f[2 + 3 * k] > top) ||
          (ac_used && f[3 + 3 * k] > top)) {
        return kBadScan;
      }
      blocks += ns > 1 ? comps[c].h * comps[c].v : 1;
    }
    if (blocks > 10) return kBadLayout;    // D_MAX_BLOCKS_IN_MCU
    for (int k = 0; k < ns && !arith; k++) {
      int td = f[2 + 3 * k], ta = f[3 + 3 * k];
      if (dc_used) {
        if (!((tables[i] >> td) & 1) ||
            !build_table(dc_bits + (4 * i + td) * 17,
                         dc_vals + (4 * i + td) * 256, true, &dc[td])) {
          return kBadHuffman;
        }
      }
      if (ac_used) {
        if (!((tables[i] >> (4 + ta)) & 1) ||
            !build_table(ac_bits + (4 * i + ta) * 17,
                         ac_vals + (4 * i + ta) * 256, false, &ac[ta])) {
          return kBadHuffman;
        }
      }
    }
    const int st = decode_scan(comps, progressive, arith, f,
                               data + offsets[i], offsets[i + 1] - offsets[i],
                               dc, ac, mcux, mcuy, &last_good);
    // one sequential scan of every component: cv2 has the image by then
    if (st && (progressive || ns < ncomp || n_scans > 1)) return st;
  }

  // IDCT of the blocks that cover each component (smoothed first where
  // coef_bits is given), then upsampling
  const int64_t npx = static_cast<int64_t>(width) * height;
  std::vector<uint8_t> full(static_cast<size_t>(npx) * ncomp);
  int16_t work[64];
  for (int c = 0; c < ncomp; c++) {
    Coefs& p = comps[c];
    Plane pl;
    pl.h = p.h;
    pl.v = p.v;
    pl.dw = p.dw;
    pl.dh = p.dh;
    pl.stride = p.cbw * 8;
    pl.rows = p.cbh * 8;
    pl.px.resize(static_cast<size_t>(pl.stride) * pl.rows);
    const uint16_t* q = qtables + 64 * c;
    for (int by = 0; by < p.cbh; by++) {
      for (int bx = 0; bx < p.cbw; bx++) {
        const int16_t* blk = p.block(bx, by);
        if (coef_bits) {
          const int32_t* bits = coef_bits + 20 * c;
          smooth_block(p, bx, by, mcuy, q,
                       by / p.v > last_good ? bits + 10 : bits, work);
          blk = work;
        }
        idct_islow(blk, q,
                   pl.px.data() + static_cast<int64_t>(by) * 8 * pl.stride +
                       bx * 8,
                   pl.stride);
      }
    }
    std::vector<int16_t>().swap(p.c);
    upsample(pl, hmax / p.h, vmax / p.v, width, height,
             full.data() + npx * c);
  }
  uint8_t* c0 = full.data();
  if (ncomp == 1) {
    for (int64_t i = 0; i < npx; i++) {
      out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = c0[i];
    }
    return kOk;
  }
  uint8_t* c1 = c0 + npx;
  uint8_t* c2 = c1 + npx;
  if (ncomp == 4 && (color == 3 || color == 4)) {
    if (color == 4) {
      // jdcolor.c ycck_cmyk_convert: YCC -> RGB, inverted, K as it is
      for (int64_t i = 0; i < npx; i++) {
        int y = c0[i], cb = c1[i], cr = c2[i];
        c0[i] = clamp255(255 - (y + kYcc.cr_r[cr]));
        c1[i] = clamp255(255 - (y + static_cast<int>(
                                        (kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16)));
        c2[i] = clamp255(255 - (y + kYcc.cb_b[cb]));
      }
    }
    // icvCvt_CMYK2BGR_8u_C4C3R on the channels as stored (Adobe-inverted)
    const uint8_t* c3 = c2 + npx;
    for (int64_t i = 0; i < npx; i++) {
      int k = c3[i];
      out[3 * i] = static_cast<uint8_t>(k - (((255 - c0[i]) * k) >> 8));
      out[3 * i + 1] = static_cast<uint8_t>(k - (((255 - c1[i]) * k) >> 8));
      out[3 * i + 2] = static_cast<uint8_t>(k - (((255 - c2[i]) * k) >> 8));
    }
    return kOk;
  }
  if (ncomp != 3) return kBadLayout;
  if (color == 2) {
    for (int64_t i = 0; i < npx; i++) {
      out[3 * i] = c0[i];
      out[3 * i + 1] = c1[i];
      out[3 * i + 2] = c2[i];
    }
    return kOk;
  }
  for (int64_t i = 0; i < npx; i++) {
    int y = c0[i], cb = c1[i], cr = c2[i];
    out[3 * i] = clamp255(y + kYcc.cr_r[cr]);
    out[3 * i + 1] = clamp255(
        y + static_cast<int>((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
    out[3 * i + 2] = clamp255(y + kYcc.cb_b[cb]);
  }
  return kOk;
}

}  // extern "C"
