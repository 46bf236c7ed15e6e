// Baseline JPEG decode on the host, bit-exact to libjpeg-turbo's defaults
// (the decoder behind cv2.imread): Huffman entropy decode, dequantisation,
// the integer ISLOW IDCT (jidctint.c), "fancy" upsampling (jdsample.c, with
// the context rows of jdmainct.c) and the fixed-point YCbCr -> RGB of
// jdcolor.c. Integer arithmetic only, so every compiler and machine gives
// the same bytes.
//
// The markers are parsed in Python (yolosharp_tpu_torch/data/jpeg.py); this
// file takes the tables, the frame's geometry and the one scan's entropy-
// coded bytes (byte stuffing and RSTn markers included) and writes
// (height, width, 3) uint8 RGB into the caller's buffer.
//
// Build: c++ -O2 -std=c++17 -fPIC -shared -ffp-contract=off.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kOk = 0;
constexpr int kTruncated = 1;     // the data ran out (or hit a marker)
constexpr int kBadHuffman = 2;    // a code no table holds, a bad table
constexpr int kBadLayout = 3;     // sampling factors this file cannot take
constexpr int kBadRestart = 4;    // no RSTn marker where one is due

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

// jpeg_make_d_derived_tbl; false on a table whose codes overflow
bool build_table(const uint8_t* bits, const uint8_t* vals, HuffTable* t) {
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

// The entropy-coded bytes as bits: 0xFF 0x00 is a data byte 0xFF; any
// other marker stops the data, and zero bits follow it (as libjpeg fills
// them). Taking one of those zero bits is the error kTruncated.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int nbits = 0;
  int fake = 0;          // zero bits appended past the data, at the end
  bool at_marker = false;

  void fill() {
    while (nbits <= 56) {
      uint32_t b = 0;
      if (!at_marker && p < end) {
        b = *p++;
        if (b == 0xFF) {
          if (p < end && *p == 0x00) {
            p++;
          } else {
            p--;               // leave the marker to the restart logic
            at_marker = true;
            b = 0;
            fake += 8;
          }
        }
      } else {
        fake += 8;
      }
      buf |= static_cast<uint64_t>(b) << (56 - nbits);
      nbits += 8;
    }
  }
  bool overrun() const { return nbits < fake; }
  int peek(int n) {
    if (nbits < n) fill();
    return static_cast<int>(buf >> (64 - n));
  }
  void skip(int n) {
    buf <<= n;
    nbits -= n;
  }
  int get(int n) {
    if (n == 0) return 0;
    int v = peek(n);
    skip(n);
    return v;
  }
  // After a restart interval: drop the padding bits, then the RSTn marker.
  bool restart(int expected) {
    buf = 0;
    nbits = 0;
    fake = 0;
    at_marker = false;
    while (p + 1 < end) {
      if (p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7) {
        bool ok = p[1] == 0xD0 + expected;
        p += 2;
        return ok;
      }
      p++;
    }
    return false;
  }
};

// jpeg_huff_decode: one symbol, or -1 where no code matches
inline int decode_symbol(BitReader* br, const HuffTable* t) {
  int look = br->peek(9);
  int e = t->look[look];
  if (e) {
    br->skip(e >> 8);
    return e & 0xFF;
  }
  int l = 10;
  int code = br->peek(l);
  while (l <= 16 && code > t->maxcode[l]) {
    l++;
    code = br->peek(l);
  }
  if (l > 16) return -1;
  br->skip(l);
  return t->vals[(t->valoffset[l] + code) & 0xFF];
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

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t{1} << (n - 1))) >> n;
}

// jdmaster.c's post-IDCT range limit: x + 128 clamped to [0, 255] for x in
// [-512, 511], indexed by x & 1023 (so a wild value wraps as libjpeg's)
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; i++) {
      int x = i < 512 ? i : i - 1024;
      int v = x + 128;
      t[i] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
};
const RangeLimit kRange;

// jpeg_idct_islow of one block of coefficients (row-major, natural order)
// with its quantisation table (natural order) into 8 rows of out
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const uint16_t* qt = q + c;
    int32_t* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      int32_t dc = (static_cast<int32_t>(in[0]) * qt[0]) * (1 << kPass1Bits);
      for (int k = 0; k < 8; k++) w[8 * k] = dc;
      continue;
    }
    int64_t z2 = static_cast<int64_t>(in[16]) * qt[16];
    int64_t z3 = static_cast<int64_t>(in[48]) * qt[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = static_cast<int64_t>(in[0]) * qt[0];
    z3 = static_cast<int64_t>(in[32]) * qt[32];
    int64_t tmp0 = (z2 + z3) * (int64_t{1} << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t{1} << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = static_cast<int64_t>(in[56]) * qt[56];
    tmp1 = static_cast<int64_t>(in[40]) * qt[40];
    tmp2 = static_cast<int64_t>(in[24]) * qt[24];
    tmp3 = static_cast<int64_t>(in[8]) * qt[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    w[0] = static_cast<int32_t>(descale(tmp10 + tmp3, sh));
    w[56] = static_cast<int32_t>(descale(tmp10 - tmp3, sh));
    w[8] = static_cast<int32_t>(descale(tmp11 + tmp2, sh));
    w[48] = static_cast<int32_t>(descale(tmp11 - tmp2, sh));
    w[16] = static_cast<int32_t>(descale(tmp12 + tmp1, sh));
    w[40] = static_cast<int32_t>(descale(tmp12 - tmp1, sh));
    w[24] = static_cast<int32_t>(descale(tmp13 + tmp0, sh));
    w[32] = static_cast<int32_t>(descale(tmp13 - tmp0, sh));
  }
  const int sh = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; r++) {
    const int32_t* w = ws + 8 * r;
    uint8_t* o = out + static_cast<int64_t>(r) * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      uint8_t dc = kRange.t[descale(w[0], kPass1Bits + 3) & 1023];
      for (int k = 0; k < 8; k++) o[k] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (static_cast<int64_t>(w[0]) + w[4]) * (1 << kConstBits);
    int64_t tmp1 = (static_cast<int64_t>(w[0]) - w[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = kRange.t[descale(tmp10 + tmp3, sh) & 1023];
    o[7] = kRange.t[descale(tmp10 - tmp3, sh) & 1023];
    o[1] = kRange.t[descale(tmp11 + tmp2, sh) & 1023];
    o[6] = kRange.t[descale(tmp11 - tmp2, sh) & 1023];
    o[2] = kRange.t[descale(tmp12 + tmp1, sh) & 1023];
    o[5] = kRange.t[descale(tmp12 - tmp1, sh) & 1023];
    o[3] = kRange.t[descale(tmp13 + tmp0, sh) & 1023];
    o[4] = kRange.t[descale(tmp13 - tmp0, sh) & 1023];
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

extern "C" {

// Decode one baseline frame with one scan.
//   scan, scan_len: the entropy-coded bytes after the SOS header, up to
//     (not including) the marker that ends the scan;
//   width, height: the frame's size; ncomp: 1 or 3 components, in the
//     frame's order, with sampling factors comp_h / comp_v and quantisation
//     table index comp_tq (0-3);
//   ns, scan_comp, scan_td, scan_ta: the scan's components (indices into
//     the frame's) and their DC / AC table indices (0-3); ns is ncomp;
//   qtables: 4 x 64 quantisation values in natural (row-major) order;
//   dc_bits / ac_bits: 4 x 17 code counts (index 0 unused), dc_vals /
//     ac_vals: 4 x 256 symbols; table_present: bit t of a DC, bit 4 + t of
//     an AC table that the file defines;
//   restart_interval: MCUs between RSTn markers (0: none);
//   color: 0 grayscale, 1 YCbCr, 2 RGB;
//   out: height * width * 3 bytes, RGB.
// Returns 0, or an error code (see kTruncated ... kBadRestart).
int ys_jpeg_decode(const uint8_t* scan, int64_t scan_len, int width,
                   int height, int ncomp, const int32_t* comp_h,
                   const int32_t* comp_v, const int32_t* comp_tq, int ns,
                   const int32_t* scan_comp, const int32_t* scan_td,
                   const int32_t* scan_ta, const uint16_t* qtables,
                   const uint8_t* dc_bits, const uint8_t* dc_vals,
                   const uint8_t* ac_bits, const uint8_t* ac_vals,
                   int table_present, int restart_interval, int color,
                   uint8_t* out) {
  if (ncomp < 1 || ncomp > 4 || ns != ncomp || width < 1 || height < 1) {
    return kBadLayout;
  }
  HuffTable dc[4], ac[4];
  for (int t = 0; t < 4; t++) {
    if ((table_present >> t) & 1) {
      if (!build_table(dc_bits + 17 * t, dc_vals + 256 * t, &dc[t])) {
        return kBadHuffman;
      }
    }
    if ((table_present >> (4 + t)) & 1) {
      if (!build_table(ac_bits + 17 * t, ac_vals + 256 * t, &ac[t])) {
        return kBadHuffman;
      }
    }
  }
  for (int k = 0; k < ns; k++) {
    if (!((table_present >> scan_td[k]) & 1) ||
        !((table_present >> (4 + scan_ta[k])) & 1)) {
      return kBadHuffman;
    }
  }
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
  // A lone component's scan is not interleaved: its blocks cover the
  // component alone, one MCU each. Otherwise an MCU is hmax x vmax blocks
  // of 8 x 8 samples of the image.
  const bool interleaved = ns > 1;
  const int mcux = interleaved ? (width + 8 * hmax - 1) / (8 * hmax) : 0;
  const int mcuy = interleaved ? (height + 8 * vmax - 1) / (8 * vmax) : 0;
  std::vector<Plane> planes(ncomp);
  for (int c = 0; c < ncomp; c++) {
    Plane& p = planes[c];
    p.h = comp_h[c];
    p.v = comp_v[c];
    p.dw = static_cast<int>((static_cast<int64_t>(width) * p.h + hmax - 1) /
                            hmax);
    p.dh = static_cast<int>((static_cast<int64_t>(height) * p.v + vmax - 1) /
                            vmax);
    int bx = interleaved ? mcux * p.h : (p.dw + 7) / 8;
    int by = interleaved ? mcuy * p.v : (p.dh + 7) / 8;
    p.stride = bx * 8;
    p.rows = by * 8;
    p.px.assign(static_cast<size_t>(p.stride) * p.rows, 0);
  }

  BitReader br{scan, scan + scan_len};
  int pred[4] = {0, 0, 0, 0};
  int16_t block[64];
  const int64_t n_mcu = interleaved
                            ? static_cast<int64_t>(mcux) * mcuy
                            : static_cast<int64_t>(planes[scan_comp[0]].stride /
                                                   8) *
                                  (planes[scan_comp[0]].rows / 8);
  int next_rst = 0;
  auto decode_block = [&](int k, uint8_t* dst, int stride) -> int {
    const HuffTable* dct = &dc[scan_td[k]];
    const HuffTable* act = &ac[scan_ta[k]];
    std::memset(block, 0, sizeof(block));
    int s = decode_symbol(&br, dct);
    if (s < 0 || s > 15) return br.overrun() ? kTruncated : kBadHuffman;
    int diff = s ? extend(br.get(s), s) : 0;
    pred[k] += diff;
    block[0] = static_cast<int16_t>(pred[k]);
    for (int i = 1; i < 64; i++) {
      int rs = decode_symbol(&br, act);
      if (rs < 0) return br.overrun() ? kTruncated : kBadHuffman;
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        i += r;
        int v = extend(br.get(s), s);
        block[kNaturalOrder[i]] = static_cast<int16_t>(v);
      } else {
        if (r != 15) break;
        i += 15;
      }
    }
    if (br.overrun()) return kTruncated;
    int c = scan_comp[k];
    idct_islow(block, qtables + 64 * comp_tq[c], dst, stride);
    return kOk;
  };
  for (int64_t m = 0; m < n_mcu; m++) {
    if (restart_interval && m > 0 && m % restart_interval == 0) {
      if (!br.restart(next_rst)) return kBadRestart;
      next_rst = (next_rst + 1) & 7;
      for (int k = 0; k < 4; k++) pred[k] = 0;
    }
    if (interleaved) {
      int my = static_cast<int>(m / mcux), mx = static_cast<int>(m % mcux);
      for (int k = 0; k < ns; k++) {
        Plane& p = planes[scan_comp[k]];
        for (int by = 0; by < p.v; by++) {
          for (int bx = 0; bx < p.h; bx++) {
            int row = (my * p.v + by) * 8, col = (mx * p.h + bx) * 8;
            int st = decode_block(
                k, p.px.data() + static_cast<int64_t>(row) * p.stride + col,
                p.stride);
            if (st) return st;
          }
        }
      }
    } else {
      Plane& p = planes[scan_comp[0]];
      int bxn = p.stride / 8;
      int row = static_cast<int>(m / bxn) * 8;
      int col = static_cast<int>(m % bxn) * 8;
      int st = decode_block(
          0, p.px.data() + static_cast<int64_t>(row) * p.stride + col,
          p.stride);
      if (st) return st;
    }
  }

  const int64_t npx = static_cast<int64_t>(width) * height;
  std::vector<uint8_t> full(static_cast<size_t>(npx) * ncomp);
  for (int c = 0; c < ncomp; c++) {
    upsample(planes[c], hmax / planes[c].h, vmax / planes[c].v, width, height,
             full.data() + npx * c);
  }
  if (ncomp == 1) {
    for (int64_t i = 0; i < npx; i++) {
      out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = full[i];
    }
    return kOk;
  }
  if (ncomp != 3) return kBadLayout;
  const uint8_t* c0 = full.data();
  const uint8_t* c1 = c0 + npx;
  const uint8_t* c2 = c1 + npx;
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
