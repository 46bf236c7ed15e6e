// The scanlines of a Radiance HDR file on the host, read as cv2 5.0's
// rgbe.cpp (Bruce Walter's RGBE_ReadPixels_RLE) reads them for
// cv2.imread: images narrower than 8 or wider than 0x7fff pixels flat;
// otherwise each scanline new-style run-length encoded (2, 2, width, then
// each of the four channels as runs 128 + n and dumps n), until a
// scanline that does not open so, from which on the rest of the image is
// read flat (old-style RLE markers among them are taken as pixels). The
// header and the float / 8-bit conversion stay in Python
// (yolosharp_tpu_torch/data/hdr.py).
//
// Build: c++ -O2 -std=c++17 -fPIC -shared -ffp-contract=off.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// The RGBE bytes of width x height pixels from data (n bytes) into out
// (height * width * 4). Returns 0, or 1 where cv2 fails: the data ends
// short, a scanline of another width, a bad run or dump.
int ys_hdr_pixels(const uint8_t* data, int64_t n, int width, int height,
                  uint8_t* out) {
  int64_t at = 0;
  const int64_t total = static_cast<int64_t>(width) * height;
  auto flat = [&](int64_t from) {
    const int64_t need = (total - from) * 4;
    if (n - at < need) return 1;
    std::memcpy(out + from * 4, data + at, static_cast<size_t>(need));
    return 0;
  };
  if (width < 8 || width > 0x7fff) return flat(0);
  std::vector<uint8_t> line(static_cast<size_t>(width) * 4);
  for (int y = 0; y < height; y++) {
    if (n - at < 4) return 1;
    const uint8_t* p = data + at;
    at += 4;
    if (p[0] != 2 || p[1] != 2 || (p[2] & 0x80)) {
      std::memcpy(out + static_cast<int64_t>(y) * width * 4, p, 4);
      return flat(static_cast<int64_t>(y) * width + 1);
    }
    if (((p[2] << 8) | p[3]) != width) return 1;
    for (int c = 0; c < 4; c++) {
      uint8_t* q = line.data() + static_cast<size_t>(c) * width;
      const uint8_t* q_end = q + width;
      while (q < q_end) {
        if (n - at < 2) return 1;
        int count = data[at];
        const uint8_t v = data[at + 1];
        at += 2;
        if (count > 128) {
          count -= 128;
          if (count > q_end - q) return 1;
          std::memset(q, v, static_cast<size_t>(count));
          q += count;
        } else {
          if (count == 0 || count > q_end - q) return 1;
          *q++ = v;
          if (--count > 0) {
            if (n - at < count) return 1;
            std::memcpy(q, data + at, static_cast<size_t>(count));
            at += count;
            q += count;
          }
        }
      }
    }
    uint8_t* o = out + static_cast<int64_t>(y) * width * 4;
    for (int x = 0; x < width; x++) {
      for (int c = 0; c < 4; c++) o[4 * x + c] = line[c * width + x];
    }
  }
  return 0;
}

}  // extern "C"
