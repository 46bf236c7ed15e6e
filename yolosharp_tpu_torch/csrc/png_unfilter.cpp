// PNG scanline reconstruction on the host: the five row filters of the PNG
// specification (None, Sub, Up, Average, Paeth) undone byte by byte, as
// libpng does, for the inflated image data of one image or of one Adam7
// pass of it, at any bit depth. The zlib inflate, the chunk parsing, the
// unpacking of samples and the Adam7 scatter stay in Python
// (yolosharp_tpu_torch/data/image_ops.py::decode_png_rgb).
//
// Build: c++ -O2 -std=c++17 -fPIC -shared -ffp-contract=off.

#include <cstdint>
#include <cstdlib>

extern "C" {

// raw: height rows of (1 + stride) bytes, each a filter type then the
// filtered bytes; bpp: bytes a pixel, at least 1 (the filters' left
// neighbour distance: max(1, bits a pixel / 8)); out: height * stride bytes. Returns 0, or 1 + the row index
// of a filter type above 4.
int ys_png_unfilter(const uint8_t* raw, int height, int stride, int bpp,
                    uint8_t* out) {
  const uint8_t* prev = nullptr;
  for (int y = 0; y < height; y++) {
    const uint8_t* in = raw + static_cast<int64_t>(y) * (stride + 1);
    uint8_t* cur = out + static_cast<int64_t>(y) * stride;
    const int type = in[0];
    in++;
    for (int i = 0; i < stride; i++) {
      const int a = i >= bpp ? cur[i - bpp] : 0;
      const int b = prev ? prev[i] : 0;
      const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
      int pred;
      switch (type) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return 1 + y;
      }
      cur[i] = static_cast<uint8_t>(in[i] + pred);
    }
    prev = cur;
  }
  return 0;
}

}  // extern "C"
