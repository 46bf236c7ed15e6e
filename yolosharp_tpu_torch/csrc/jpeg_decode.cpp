// JPEG decode on the host, bit-exact to libjpeg-turbo's defaults (the
// decoder behind cv2.imread), in two steps. First every scan's Huffman
// data is decoded into per-component int16 coefficient planes: a baseline
// (sequential) scan whole, a progressive one (jdphuff.c) as its DC first /
// DC refine / AC first / AC refine pass over its band and bits. Then, once
// over those planes, dequantisation with the integer ISLOW IDCT
// (jidctint.c), "fancy" upsampling (jdsample.c, with the context rows of
// jdmainct.c) and the colour step: the fixed-point YCbCr -> RGB of
// jdcolor.c, or for CMYK the integer CMYK -> BGR of OpenCV's imgcodecs
// (icvCvt_CMYK2BGR_8u_C4C3R). Integer arithmetic only, so every compiler
// and machine gives the same bytes.
//
// The markers are parsed in Python (yolosharp_tpu_torch/data/jpeg.py); this
// file takes the frame's geometry, each scan's header, Huffman tables and
// entropy-coded bytes (byte stuffing and RSTn markers included), the
// quantisation table each component latched at its first scan, and writes
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
constexpr int kBadScan = 5;       // a scan header this frame cannot take

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
// table, then Ss, Se, Ah, Al and the restart interval in force.
constexpr int kScanFields = 18;

struct ScanState {
  BitReader br;
  const HuffTable* dct[4] = {};
  const HuffTable* act[4] = {};
  int pred[4] = {0, 0, 0, 0};
  int eobrun = 0;
  int ss = 0, se = 63, ah = 0, al = 0;
};

// jdhuff.c decode_mcu for one block of a sequential scan
int block_sequential(ScanState* s, int k, int16_t* blk) {
  int t = decode_symbol(&s->br, s->dct[k]);
  if (t < 0 || t > 15) return s->br.overrun() ? kTruncated : kBadHuffman;
  s->pred[k] += t ? extend(s->br.get(t), t) : 0;
  blk[0] = static_cast<int16_t>(s->pred[k]);
  for (int i = 1; i < 64; i++) {
    int rs = decode_symbol(&s->br, s->act[k]);
    if (rs < 0) return s->br.overrun() ? kTruncated : kBadHuffman;
    int r = rs >> 4;
    t = rs & 15;
    if (t) {
      i += r;
      blk[kNaturalOrder[i]] = static_cast<int16_t>(extend(s->br.get(t), t));
    } else {
      if (r != 15) break;
      i += 15;
    }
  }
  return s->br.overrun() ? kTruncated : kOk;
}

// jdphuff.c decode_mcu_DC_first / decode_mcu_DC_refine for one block
int block_dc(ScanState* s, int k, int16_t* blk) {
  if (s->ah) {
    if (s->br.get(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << s->al));
  } else {
    int t = decode_symbol(&s->br, s->dct[k]);
    if (t < 0 || t > 15) return s->br.overrun() ? kTruncated : kBadHuffman;
    s->pred[k] += t ? extend(s->br.get(t), t) : 0;
    blk[0] = static_cast<int16_t>(
        static_cast<uint32_t>(s->pred[k]) << s->al);
  }
  return s->br.overrun() ? kTruncated : kOk;
}

// jdphuff.c decode_mcu_AC_first for one block
int block_ac_first(ScanState* s, int16_t* blk) {
  if (s->eobrun > 0) {
    s->eobrun--;
    return kOk;
  }
  for (int k = s->ss; k <= s->se; k++) {
    int rs = decode_symbol(&s->br, s->act[0]);
    if (rs < 0) return s->br.overrun() ? kTruncated : kBadHuffman;
    int r = rs >> 4, t = rs & 15;
    if (t) {
      k += r;
      int v = extend(s->br.get(t), t);
      blk[kNaturalOrder[k]] =
          static_cast<int16_t>(static_cast<uint32_t>(v) << s->al);
    } else if (r == 15) {
      k += 15;
    } else {
      s->eobrun = 1 << r;
      if (r) s->eobrun += s->br.get(r);
      s->eobrun--;
      break;
    }
  }
  return s->br.overrun() ? kTruncated : kOk;
}

// jdphuff.c decode_mcu_AC_refine for one block: a correction bit for each
// coefficient of the band that is already nonzero (inside an EOB run too),
// a new coefficient of +-1 << Al where a symbol places one.
int block_ac_refine(ScanState* s, int16_t* blk) {
  const int p1 = 1 << s->al;
  const int m1 = -p1;
  int k = s->ss;
  auto correct = [&](int16_t* c) {
    if (s->br.get(1) && (*c & p1) == 0) {
      *c = static_cast<int16_t>(*c + (*c >= 0 ? p1 : m1));
    }
  };
  if (s->eobrun == 0) {
    for (; k <= s->se; k++) {
      int rs = decode_symbol(&s->br, s->act[0]);
      if (rs < 0) return s->br.overrun() ? kTruncated : kBadHuffman;
      int r = rs >> 4, t = rs & 15, value = 0;
      if (t) {
        if (t != 1) return kBadHuffman;     // JWRN_HUFF_BAD_CODE
        value = s->br.get(1) ? p1 : m1;
      } else if (r != 15) {
        s->eobrun = 1 << r;
        if (r) s->eobrun += s->br.get(r);
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
  return s->br.overrun() ? kTruncated : kOk;
}

// Decode one scan into the coefficient planes. An interleaved scan (Ns > 1)
// walks the MCU grid, hmax x vmax blocks of samples an MCU; a scan of one
// component walks the blocks that cover that component, one an MCU.
int decode_scan(std::vector<Coefs>& comps, bool progressive,
                const int32_t* f, const uint8_t* data, int64_t len,
                const HuffTable* dc, const HuffTable* ac, int mcux,
                int mcuy) {
  const int ns = f[0];
  ScanState s{BitReader{data, data + len}};
  int idx[4];
  for (int k = 0; k < ns; k++) {
    idx[k] = f[1 + 3 * k];
    s.dct[k] = &dc[f[2 + 3 * k]];
    s.act[k] = &ac[f[3 + 3 * k]];
  }
  s.ss = f[13];
  s.se = f[14];
  s.ah = f[15];
  s.al = f[16];
  const int restart_interval = f[17];
  auto one = [&](int k, int16_t* blk) -> int {
    if (!progressive) return block_sequential(&s, k, blk);
    if (s.ss == 0) return block_dc(&s, k, blk);
    return s.ah ? block_ac_refine(&s, blk) : block_ac_first(&s, blk);
  };
  Coefs& lone = comps[idx[0]];
  const int64_t n_mcu = ns > 1 ? static_cast<int64_t>(mcux) * mcuy
                               : static_cast<int64_t>(lone.cbw) * lone.cbh;
  int next_rst = 0;
  for (int64_t m = 0; m < n_mcu; m++) {
    if (restart_interval && m > 0 && m % restart_interval == 0) {
      if (!s.br.restart(next_rst)) return kBadRestart;
      next_rst = (next_rst + 1) & 7;
      for (int k = 0; k < 4; k++) s.pred[k] = 0;
      s.eobrun = 0;
    }
    if (ns > 1) {
      int my = static_cast<int>(m / mcux), mx = static_cast<int>(m % mcux);
      for (int k = 0; k < ns; k++) {
        Coefs& c = comps[idx[k]];
        for (int by = 0; by < c.v; by++) {
          for (int bx = 0; bx < c.h; bx++) {
            int st = one(k, c.block(mx * c.h + bx, my * c.v + by));
            if (st) return st;
          }
        }
      }
    } else {
      int st = one(0, lone.block(static_cast<int>(m % lone.cbw),
                                 static_cast<int>(m / lone.cbw)));
      if (st) return st;
    }
  }
  return kOk;
}

}  // namespace

extern "C" {

// Decode a frame of ncomp (1, 3 or 4) components from its scans.
//   width, height: the frame's size; comp_h / comp_v: each component's
//     sampling factors, in the frame's order; progressive: 1 for SOF2;
//   n_scans scans: the entropy-coded bytes of scan i are
//     data[offsets[i] .. offsets[i + 1]) (after its SOS header, up to the
//     marker that ends it); fields: kScanFields int32 a scan (see above);
//     dc_bits / ac_bits: 4 x 17 code counts (index 0 unused) a scan,
//     dc_vals / ac_vals: 4 x 256 symbols a scan, the tables defined at its
//     SOS; tables: bit t of a DC, bit 4 + t of an AC table defined there;
//   qtables: ncomp x 64 quantisation values in natural order, the table
//     each component latched at its first scan;
//   color: 0 grayscale, 1 YCbCr, 2 RGB, 3 CMYK (Adobe, as libjpeg hands
//     the four channels over);
//   out: height * width * 3 bytes, RGB.
// Returns 0, or an error code (see kTruncated ... kBadScan).
int ys_jpeg_decode(int width, int height, int ncomp, const int32_t* comp_h,
                   const int32_t* comp_v, int progressive, int n_scans,
                   const uint8_t* data, const int64_t* offsets,
                   const int32_t* fields, const uint8_t* dc_bits,
                   const uint8_t* dc_vals, const uint8_t* ac_bits,
                   const uint8_t* ac_vals, const int32_t* tables,
                   const uint16_t* qtables, int color, uint8_t* out) {
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
  for (int i = 0; i < n_scans; i++) {
    const int32_t* f = fields + kScanFields * i;
    const int ns = f[0];
    if (ns < 1 || ns > 4 || (progressive && f[13] > 0 && ns != 1)) {
      return kBadScan;
    }
    for (int k = 0; k < ns; k++) {
      if (f[1 + 3 * k] < 0 || f[1 + 3 * k] >= ncomp) return kBadScan;
    }
    // the tables this scan decodes with, built from those of its SOS
    const bool dc_used = !progressive || (f[13] == 0 && f[15] == 0);
    const bool ac_used = !progressive || f[13] > 0;
    for (int k = 0; k < ns; k++) {
      int td = f[2 + 3 * k] & 3, ta = f[3 + 3 * k] & 3;
      if (dc_used) {
        if (!((tables[i] >> td) & 1) ||
            !build_table(dc_bits + (4 * i + td) * 17,
                         dc_vals + (4 * i + td) * 256, &dc[td])) {
          return kBadHuffman;
        }
      }
      if (ac_used) {
        if (!((tables[i] >> (4 + ta)) & 1) ||
            !build_table(ac_bits + (4 * i + ta) * 17,
                         ac_vals + (4 * i + ta) * 256, &ac[ta])) {
          return kBadHuffman;
        }
      }
    }
    int st = decode_scan(comps, progressive != 0, f, data + offsets[i],
                         offsets[i + 1] - offsets[i], dc, ac, mcux, mcuy);
    if (st) return st;
  }

  // IDCT of the blocks that cover each component, then upsampling
  const int64_t npx = static_cast<int64_t>(width) * height;
  std::vector<uint8_t> full(static_cast<size_t>(npx) * ncomp);
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
    for (int by = 0; by < p.cbh; by++) {
      for (int bx = 0; bx < p.cbw; bx++) {
        idct_islow(p.block(bx, by), qtables + 64 * c,
                   pl.px.data() + static_cast<int64_t>(by) * 8 * pl.stride +
                       bx * 8,
                   pl.stride);
      }
    }
    std::vector<int16_t>().swap(p.c);
    upsample(pl, hmax / p.h, vmax / p.v, width, height,
             full.data() + npx * c);
  }
  const uint8_t* c0 = full.data();
  if (ncomp == 1) {
    for (int64_t i = 0; i < npx; i++) {
      out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = c0[i];
    }
    return kOk;
  }
  const uint8_t* c1 = c0 + npx;
  const uint8_t* c2 = c1 + npx;
  if (ncomp == 4 && color == 3) {
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
