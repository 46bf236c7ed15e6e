// The LZW codes of a GIF frame on the host, decoded as cv2 5.0's own GIF
// decoder (grfmt_gif.cpp) decodes them for cv2.imread: the code width
// grows when the table reaches 1 << width (up to 12 bits), a Clear code
// resets it, the End code resets it too and decoding goes on while bytes
// remain, a full table (4096 entries) takes no more entries. The frame
// must come out at exactly its size: a code that would write past it
// fails; once it is full, the next code that is neither Clear nor End
// stops the decoding, and then no byte of the data may be left unread. The file's blocks, the colour tables,
// interlacing and transparency stay in Python
// (yolosharp_tpu_torch/data/gif.py).
//
// Build: c++ -O2 -std=c++17 -fPIC -shared -ffp-contract=off.

#include <cstdint>

namespace {

constexpr int kMaxTable = 1 << 12;

struct Entry {
  int32_t prev;         // the entry this one extends, -1 for a literal
  uint8_t suffix;       // its last index
  uint8_t first;        // its first index
  int32_t length;       // its length in indices
};

}  // namespace

extern "C" {

// The frame's LZW data (its sub-blocks joined: data, n bytes) of minimum
// code size min_code_size (2 to 11) into out, size indices (each literal
// cast to 8 bits). Returns 0, or 1 where cv2 fails the frame: a code past
// the table, more indices than the frame holds, fewer, or data left over
// once it is full.
int ys_gif_lzw(const uint8_t* data, int64_t n, int min_code_size,
               uint8_t* out, int64_t size) {
  const int clear = 1 << min_code_size;
  const int end = clear + 1;
  static thread_local Entry table[kMaxTable + 1];
  int width = min_code_size + 1;
  // cv2's count: the entry the next code completes (end right after a
  // reset, a placeholder)
  int next = end;
  int prev = -1;
  int64_t at = 0, idx = 0;
  uint32_t src = 0;
  int left = 0;
  bool full = false;
  auto entry = [&](int c) {
    return c < clear ? Entry{-1, static_cast<uint8_t>(c),
                             static_cast<uint8_t>(c), 1}
                     : table[c];
  };
  while (at < n && !full) {
    if (left < width) {
      src |= static_cast<uint32_t>(data[at++]) << left;
      left += 8;
    }
    while (left >= width) {
      const int code = static_cast<int>(src & ((1u << width) - 1));
      src >>= width;
      left -= width;
      if (code == clear || code == end) {
        width = min_code_size + 1;
        next = end;
        prev = -1;
        if (code == end) break;
        continue;
      }
      if (idx == size) {       // the frame is full: cv2 stops here
        full = true;
        break;
      }
      // the string of this code
      Entry cur;
      if (code < clear) {
        cur = entry(code);
      } else if (next < kMaxTable && code == next && prev >= 0) {
        // the entry this very code completes: prev's string and its first
        const Entry p = entry(prev);
        cur = Entry{prev, p.first, p.first, p.length + 1};
      } else if (code > end && code < next) {
        cur = table[code];
      } else {
        return 1;
      }
      if (next < kMaxTable) {
        if (prev >= 0 && next > end) {
          const Entry p = entry(prev);
          table[next] = Entry{prev, cur.first, p.first, p.length + 1};
        }
        next++;
        if (next == (1 << width) && width < 12) width++;
      }
      if (idx + cur.length > size) return 1;
      // the string, back to front
      Entry e = cur;
      for (int64_t pos = idx + cur.length;;) {
        out[--pos] = e.suffix;
        if (e.prev < 0) break;
        e = entry(e.prev);
      }
      idx += cur.length;
      prev = code;
    }
  }
  // stopped at a full frame, no byte may be left unread
  if (full) return at == n ? 0 : 1;
  return idx == size ? 0 : 1;
}

}  // extern "C"
