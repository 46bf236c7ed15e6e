// The byte work of baseline TIFF on the host: the LZW and PackBits
// decoders of a strip or tile, as libtiff's tif_lzw.c and tif_packbits.c
// decode them for cv2.imread. The header, the directory, Deflate (Python's
// zlib), the predictor and the pixel mapping stay in Python
// (yolosharp_tpu_torch/data/tiff.py).
//
// Build: c++ -O2 -std=c++17 -fPIC -shared -ffp-contract=off.

#include <cstdint>
#include <cstring>

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
