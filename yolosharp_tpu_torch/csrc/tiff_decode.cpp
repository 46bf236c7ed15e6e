// The byte work of TIFF on the host: the LZW, PackBits and CCITT (modified
// Huffman, T.4 and T.6) decoders of a strip or tile, as libtiff's
// tif_lzw.c, tif_packbits.c and tif_fax3.c decode them for cv2.imread. The
// header, the directory, Deflate (Python's zlib), JPEG (the port's own
// decoder), the predictor and the pixel mapping stay in Python
// (yolosharp_tpu_torch/data/tiff.py).
//
// Build: c++ -O2 -std=c++17 -fPIC -shared -ffp-contract=off.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kClear = 256;
constexpr int kEoi = 257;
constexpr int kFirst = 258;
constexpr int kMaxBits = 12;
constexpr int kTableSize = 1 << kMaxBits;

constexpr int64_t kShort = -1;     // the codes end before the chunk is full
constexpr int64_t kCorrupt = -2;   // a code the table does not hold yet

}  // namespace

extern "C" {

// LZW codes of one strip or tile (src, n bytes) into dst, size bytes:
// 9- to 12-bit codes, a table reset by each Clear code (the first code),
// ended by EOI, the end of the data or a full dst. Codes are read MSB
// first with the width growing one code early (TIFF 6.0), or, where the
// data begins 0x00 then an odd byte, as the old-style LSB-first codes
// whose width grows one code later (libtiff's LZWDecodeCompat). Returns
// size, or kShort / kCorrupt.
int64_t ys_tiff_lzw(const uint8_t* src, int64_t n, uint8_t* dst,
                    int64_t size) {
  // each entry from 258 on as where its string was written in dst, and
  // its length: prev's string followed at once by the first byte of the
  // next string out, so an entry's string is a copy of earlier output
  static thread_local int64_t where[kTableSize];
  static thread_local int32_t length[kTableSize];
  const bool compat = n >= 2 && src[0] == 0 && (src[1] & 1);
  const int late = compat ? 1 : 0;
  uint64_t acc = 0;
  int nacc = 0;
  int64_t at = 0, out = 0, prev_at = 0;
  int nbits = 9, next = -1, prev = -1;   // next -1: no Clear code yet
  while (out < size) {
    while (nacc < nbits && at < n) {
      if (compat) {
        acc |= static_cast<uint64_t>(src[at++]) << nacc;
      } else {
        acc = (acc << 8) | src[at++];
      }
      nacc += 8;
    }
    if (nacc < nbits) break;               // the data ends: taken as EOI
    int code;
    if (compat) {
      code = static_cast<int>(acc & ((1u << nbits) - 1));
      acc >>= nbits;
    } else {
      code = static_cast<int>((acc >> (nacc - nbits)) & ((1u << nbits) - 1));
    }
    nacc -= nbits;
    if (!compat) acc &= (uint64_t{1} << nacc) - 1;
    if (code == kEoi) break;
    if (code == kClear) {
      nbits = 9;
      next = kFirst;
      prev = -1;
      continue;
    }
    if (next < 0) return kCorrupt;         // the data must open with Clear
    if (prev >= 0) {
      // the new entry: prev's string and the first byte of code's (of
      // prev's own where code is the entry being made)
      if (code > next || next >= kTableSize) return kCorrupt;
      where[next] = prev_at;
      length[next] = (prev < 256 ? 1 : length[prev]) + 1;
      next++;
      if (next + 1 - late >= (1 << nbits) && nbits < kMaxBits) nbits++;
    } else if (code > 255) {
      return kCorrupt;                     // the first code after a Clear
    }
    prev = code;
    prev_at = out;
    if (code < 256) {
      dst[out++] = static_cast<uint8_t>(code);
      continue;
    }
    // a copy of earlier output; forward byte by byte, since the string of
    // the entry just made overlaps the bytes it is copied to
    int64_t len = length[code];
    if (len > size - out) len = size - out;
    const uint8_t* from = dst + where[code];
    uint8_t* to = dst + out;
    for (int64_t i = 0; i < len; i++) to[i] = from[i];
    out += len;
  }
  return out < size ? kShort : size;
}

// PackBits runs of one strip or tile (src, n bytes) into dst, size bytes,
// as libtiff's PackBitsDecode: a header byte h, then h + 1 literal bytes
// (h < 128) or one byte repeated 257 - h times (h > 128; 128 is a no-op),
// a run past the end of dst cut. Returns size, or kShort.
int64_t ys_tiff_packbits(const uint8_t* src, int64_t n, uint8_t* dst,
                         int64_t size) {
  int64_t at = 0, out = 0;
  while (at < n && out < size) {
    int h = src[at++];
    if (h == 128) continue;
    if (h > 128) {
      if (at >= n) break;
      int64_t run = 257 - h;
      if (run > size - out) run = size - out;
      std::memset(dst + out, src[at++], static_cast<size_t>(run));
      out += run;
    } else {
      int64_t run = h + 1;
      if (run > size - out) run = size - out;
      if (at + run > n) break;
      std::memcpy(dst + out, src + at, static_cast<size_t>(run));
      out += run;
      at += run;
    }
  }
  return out < size ? kShort : size;
}

}  // extern "C"

namespace {

// ------------------------------------------------------------------ CCITT
// T.4 Tables 2 and 3: (code length, code, run) of the terminating (run
// < 64) and make-up codes of each colour, then the extended make-up codes
// both colours share.
struct FaxCode {
  int len, code, run;
};
const FaxCode kWhite[] = {
    {8, 0x35, 0},    {6, 0x07, 1},    {4, 0x07, 2},    {4, 0x08, 3},
    {4, 0x0B, 4},    {4, 0x0C, 5},    {4, 0x0E, 6},    {4, 0x0F, 7},
    {5, 0x13, 8},    {5, 0x14, 9},    {5, 0x07, 10},   {5, 0x08, 11},
    {6, 0x08, 12},   {6, 0x03, 13},   {6, 0x34, 14},   {6, 0x35, 15},
    {6, 0x2A, 16},   {6, 0x2B, 17},   {7, 0x27, 18},   {7, 0x0C, 19},
    {7, 0x08, 20},   {7, 0x17, 21},   {7, 0x03, 22},   {7, 0x04, 23},
    {7, 0x28, 24},   {7, 0x2B, 25},   {7, 0x13, 26},   {7, 0x24, 27},
    {7, 0x18, 28},   {8, 0x02, 29},   {8, 0x03, 30},   {8, 0x1A, 31},
    {8, 0x1B, 32},   {8, 0x12, 33},   {8, 0x13, 34},   {8, 0x14, 35},
    {8, 0x15, 36},   {8, 0x16, 37},   {8, 0x17, 38},   {8, 0x28, 39},
    {8, 0x29, 40},   {8, 0x2A, 41},   {8, 0x2B, 42},   {8, 0x2C, 43},
    {8, 0x2D, 44},   {8, 0x04, 45},   {8, 0x05, 46},   {8, 0x0A, 47},
    {8, 0x0B, 48},   {8, 0x52, 49},   {8, 0x53, 50},   {8, 0x54, 51},
    {8, 0x55, 52},   {8, 0x24, 53},   {8, 0x25, 54},   {8, 0x58, 55},
    {8, 0x59, 56},   {8, 0x5A, 57},   {8, 0x5B, 58},   {8, 0x4A, 59},
    {8, 0x4B, 60},   {8, 0x32, 61},   {8, 0x33, 62},   {8, 0x34, 63},
    {5, 0x1B, 64},   {5, 0x12, 128},  {6, 0x17, 192},  {7, 0x37, 256},
    {8, 0x36, 320},  {8, 0x37, 384},  {8, 0x64, 448},  {8, 0x65, 512},
    {8, 0x68, 576},  {8, 0x67, 640},  {9, 0xCC, 704},  {9, 0xCD, 768},
    {9, 0xD2, 832},  {9, 0xD3, 896},  {9, 0xD4, 960},  {9, 0xD5, 1024},
    {9, 0xD6, 1088}, {9, 0xD7, 1152}, {9, 0xD8, 1216}, {9, 0xD9, 1280},
    {9, 0xDA, 1344}, {9, 0xDB, 1408}, {9, 0x98, 1472}, {9, 0x99, 1536},
    {9, 0x9A, 1600}, {6, 0x18, 1664}, {9, 0x9B, 1728}};
const FaxCode kBlack[] = {
    {10, 0x37, 0},    {3, 0x02, 1},     {2, 0x03, 2},     {2, 0x02, 3},
    {3, 0x03, 4},     {4, 0x03, 5},     {4, 0x02, 6},     {5, 0x03, 7},
    {6, 0x05, 8},     {6, 0x04, 9},     {7, 0x04, 10},    {7, 0x05, 11},
    {7, 0x07, 12},    {8, 0x04, 13},    {8, 0x07, 14},    {9, 0x18, 15},
    {10, 0x17, 16},   {10, 0x18, 17},   {10, 0x08, 18},   {11, 0x67, 19},
    {11, 0x68, 20},   {11, 0x6C, 21},   {11, 0x37, 22},   {11, 0x28, 23},
    {11, 0x17, 24},   {11, 0x18, 25},   {12, 0xCA, 26},   {12, 0xCB, 27},
    {12, 0xCC, 28},   {12, 0xCD, 29},   {12, 0x68, 30},   {12, 0x69, 31},
    {12, 0x6A, 32},   {12, 0x6B, 33},   {12, 0xD2, 34},   {12, 0xD3, 35},
    {12, 0xD4, 36},   {12, 0xD5, 37},   {12, 0xD6, 38},   {12, 0xD7, 39},
    {12, 0x6C, 40},   {12, 0x6D, 41},   {12, 0xDA, 42},   {12, 0xDB, 43},
    {12, 0x54, 44},   {12, 0x55, 45},   {12, 0x56, 46},   {12, 0x57, 47},
    {12, 0x64, 48},   {12, 0x65, 49},   {12, 0x52, 50},   {12, 0x53, 51},
    {12, 0x24, 52},   {12, 0x37, 53},   {12, 0x38, 54},   {12, 0x27, 55},
    {12, 0x28, 56},   {12, 0x58, 57},   {12, 0x59, 58},   {12, 0x2B, 59},
    {12, 0x2C, 60},   {12, 0x5A, 61},   {12, 0x66, 62},   {12, 0x67, 63},
    {10, 0x0F, 64},   {12, 0xC8, 128},  {12, 0xC9, 192},  {12, 0x5B, 256},
    {12, 0x33, 320},  {12, 0x34, 384},  {12, 0x35, 448},  {13, 0x6C, 512},
    {13, 0x6D, 576},  {13, 0x4A, 640},  {13, 0x4B, 704},  {13, 0x4C, 768},
    {13, 0x4D, 832},  {13, 0x72, 896},  {13, 0x73, 960},  {13, 0x74, 1024},
    {13, 0x75, 1088}, {13, 0x76, 1152}, {13, 0x77, 1216}, {13, 0x52, 1280},
    {13, 0x53, 1344}, {13, 0x54, 1408}, {13, 0x55, 1472}, {13, 0x5A, 1536},
    {13, 0x5B, 1600}, {13, 0x64, 1664}, {13, 0x65, 1728}};
const FaxCode kExtended[] = {
    {11, 0x08, 1792}, {11, 0x0C, 1856}, {11, 0x0D, 1920}, {12, 0x12, 1984},
    {12, 0x13, 2048}, {12, 0x14, 2112}, {12, 0x15, 2176}, {12, 0x16, 2240},
    {12, 0x17, 2304}, {12, 0x1C, 2368}, {12, 0x1D, 2432}, {12, 0x1E, 2496},
    {12, 0x1F, 2560}};

// The run-length codes of one colour looked up by their first 13 bits:
// (length << 12 | run) + 1, 0 where no code starts so.
struct FaxTable {
  std::vector<uint32_t> look;
  explicit FaxTable(const FaxCode* codes, int n) : look(1 << 13, 0) {
    auto add = [&](const FaxCode& c) {
      const int shift = 13 - c.len;
      for (int i = 0; i < (1 << shift); i++) {
        look[(c.code << shift) | i] =
            (static_cast<uint32_t>(c.len) << 12 | c.run) + 1;
      }
    };
    for (int i = 0; i < n; i++) add(codes[i]);
    for (const FaxCode& c : kExtended) add(c);
  }
};
const FaxTable kWhiteTable(kWhite, sizeof(kWhite) / sizeof(FaxCode));
const FaxTable kBlackTable(kBlack, sizeof(kBlack) / sizeof(FaxCode));

constexpr int64_t kBadCode = -3;   // a code no table holds

// The compressed bits of a strip, MSB first (each byte reversed where
// FillOrder is 2); zeros past the end.
struct FaxBits {
  const uint8_t* p;
  int64_t n;
  int64_t at = 0;           // bit position
  bool reverse;
  int bit(int64_t i) const {
    if (i >= 8 * n) return 0;
    const int b = p[i >> 3];
    const int k = static_cast<int>(i & 7);
    return reverse ? (b >> k) & 1 : (b >> (7 - k)) & 1;
  }
  uint32_t peek(int k) const {
    uint32_t v = 0;
    for (int i = 0; i < k; i++) v = (v << 1) | bit(at + i);
    return v;
  }
  bool done() const { return at >= 8 * n; }
};

// One run of a colour: make-up codes then a terminating code; -1 where
// the bits hold no code of that colour.
int64_t fax_run(FaxBits* b, bool black) {
  const FaxTable& t = black ? kBlackTable : kWhiteTable;
  int64_t run = 0;
  for (;;) {
    if (b->done()) return -1;
    const uint32_t e = t.look[b->peek(13)];
    if (!e) return -1;
    b->at += (e - 1) >> 12;
    const int r = (e - 1) & 0xFFF;
    run += r;
    if (r < 64) return run;
  }
}

// Skip to past the next EOL (eleven or more 0 bits, then a 1); false where
// none is left.
bool fax_sync_eol(FaxBits* b) {
  int zeros = 0;
  while (!b->done()) {
    const int v = b->bit(b->at++);
    if (v) {
      if (zeros >= 11) return true;
      zeros = 0;
    } else {
      zeros++;
    }
  }
  return false;
}

// A row coded in one dimension: alternate white and black runs from white
// to the width, their changing positions into changes.
bool fax_row_1d(FaxBits* b, int width, std::vector<int>* changes) {
  changes->clear();
  int64_t a0 = 0;
  bool black = false;
  while (a0 < width) {
    const int64_t run = fax_run(b, black);
    if (run < 0) return false;
    a0 += run;
    if (a0 > width) a0 = width;
    changes->push_back(static_cast<int>(a0));
    black = !black;
  }
  return true;
}

// A row coded in two dimensions against the changing positions of the
// reference row (T.4 4.2.1.3): pass, horizontal and vertical modes.
bool fax_row_2d(FaxBits* b, int width, const std::vector<int>& ref,
                std::vector<int>* changes) {
  changes->clear();
  int64_t a0 = -1;
  bool black = false;
  size_t r = 0;                 // ref[r] is the first candidate for b1
  auto ref_at = [&](size_t i) -> int64_t {
    return i < ref.size() ? ref[i] : width;
  };
  while (a0 < width) {
    // b1: the first change on the reference row right of a0 to the
    // colour opposite a0's (even changes go to black, odd to white)
    while (r > 0 && ref_at(r - 1) > a0) r--;
    while (ref_at(r) <= a0 && r < ref.size()) r++;
    if ((r & 1) != (black ? 1u : 0u)) r++;
    const int64_t b1 = ref_at(r), b2 = ref_at(r + 1);
    if (b->done()) return false;
    const uint32_t w7 = b->peek(7);
    int64_t a1;
    if (w7 >> 6) {                               // 1: V0
      b->at += 1;
      a1 = b1;
    } else if ((w7 >> 4) == 0x3 || (w7 >> 4) == 0x2) {   // 011 / 010
      b->at += 3;
      a1 = (w7 >> 4) == 0x3 ? b1 + 1 : b1 - 1;
    } else if ((w7 >> 4) == 0x1) {               // 001: horizontal
      b->at += 3;
      const int64_t start = a0 < 0 ? 0 : a0;
      const int64_t r1 = fax_run(b, black);
      if (r1 < 0) return false;
      const int64_t r2 = fax_run(b, !black);
      if (r2 < 0) return false;
      int64_t p1 = start + r1, p2 = p1 + r2;
      if (p1 > width) p1 = width;
      if (p2 > width) p2 = width;
      changes->push_back(static_cast<int>(p1));
      changes->push_back(static_cast<int>(p2));
      a0 = p2;
      continue;
    } else if ((w7 >> 3) == 0x1) {               // 0001: pass
      b->at += 4;
      a0 = b2;
      continue;
    } else if ((w7 >> 1) == 0x3 || (w7 >> 1) == 0x2) {   // 000011 / 000010
      b->at += 6;
      a1 = (w7 >> 1) == 0x3 ? b1 + 2 : b1 - 2;
    } else if (w7 == 0x3 || w7 == 0x2) {         // 0000011 / 0000010
      b->at += 7;
      a1 = w7 == 0x3 ? b1 + 3 : b1 - 3;
    } else {
      return false;                              // extensions, EOL
    }
    if (a1 < 0 || a1 < a0) return false;
    if (a1 > width) a1 = width;
    changes->push_back(static_cast<int>(a1));
    a0 = a1;
    black = !black;
  }
  return true;
}

// The changing positions of a row as packed bits, 1 for black
// (_TIFFFax3fillruns).
void fax_fill(const std::vector<int>& changes, int width, uint8_t* row) {
  std::memset(row, 0, static_cast<size_t>((width + 7) / 8));
  int x = 0;
  for (size_t i = 0; i < changes.size(); i++) {
    const int end = changes[i] < width ? changes[i] : width;
    if (i & 1) {
      for (int p = x; p < end; p++) row[p >> 3] |= 0x80 >> (p & 7);
    }
    x = end;
  }
}

}  // namespace

extern "C" {

// CCITT bilevel codes of one strip or tile (src, n bytes) into rows of
// packed bits (1 for black, as libtiff's fax decoder fills them), `rows`
// rows of `width` pixels: mode 2 modified Huffman (each row byte-aligned,
// no EOL), 3 T.4 (every row after an EOL; options bit 0: a tag bit after
// the EOL says 1D or 2D), 4 T.6 (2D, no EOL); reverse: FillOrder 2.
// Returns the rows decoded (fewer where the codes end early), or kBadCode.
int64_t ys_tiff_fax(const uint8_t* src, int64_t n, uint8_t* dst, int width,
                    int rows, int mode, int options, int reverse) {
  FaxBits b{src, n, 0, reverse != 0};
  std::vector<int> ref, cur;
  const int64_t stride = (width + 7) / 8;
  for (int y = 0; y < rows; y++) {
    bool two_d = mode == 4;
    if (mode == 3) {
      if (!fax_sync_eol(&b)) return y;
      if (options & 1) two_d = b.bit(b.at++) == 0;
    }
    if (b.done()) return y;
    const bool ok = two_d ? fax_row_2d(&b, width, ref, &cur)
                          : fax_row_1d(&b, width, &cur);
    if (!ok) return kBadCode;
    fax_fill(cur, width, dst + y * stride);
    ref.swap(cur);
    if (mode == 2) b.at = (b.at + 7) & ~int64_t{7};
  }
  return rows;
}

}  // extern "C"
