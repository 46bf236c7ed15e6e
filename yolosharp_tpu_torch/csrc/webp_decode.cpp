// WebP on the host, to the bit what libwebp decodes for cv2.imread
// (WebPDecodeBGRInto / BGRAInto): the VP8L lossless bitstream and the
// VP8 lossy key frame, then libwebp's fancy upsampling and its 14-bit
// fixed-point YUV -> BGR. The RIFF container, VP8X, ANIM / ANMF, EXIF
// and the checks libwebp makes of them stay in Python
// (yolosharp_tpu_torch/data/webp.py).
//
// - VP8L (WebP lossless specification): the prefix codes (simple and
//   normal, the code-length code, the meta prefix image and its groups),
//   the colour cache, LZ77 backward references with the 120 short
//   distance codes, and the predictor, cross-colour, subtract-green and
//   colour-indexing transforms (with pixel bundling), inverted in
//   reverse order. Codes must be complete, as libwebp requires; reading
//   past the end of the data fails the image.
// - VP8 (RFC 6386): the boolean decoder, segments and their quantiser and
//   filter deltas, the token partitions, the 16x16, 4x4 and chroma intra
//   predictions (from unfiltered neighbours, 127 above the frame, 129 to
//   its left), the inverse DCT and WHT, and the simple and normal loop
//   filters over the frame in macroblock order. libwebp's SIMD paths are
//   bit-exact to its C, which is what is followed here.
//
// Build: c++ -O2 -std=c++17 -fPIC -shared -ffp-contract=off.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// RFC 6386 section 13.5: the default coefficient probabilities
// [type][band][context][node], flattened.
constexpr uint8_t kCoeffProba0[4 * 8 * 3 * 11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
// RFC 6386 section 13.4: the probabilities that a coefficient
// probability is updated, [type][band][context][node], flattened.
constexpr uint8_t kCoeffUpdateProba[4 * 8 * 3 * 11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
// RFC 6386 section 11.5: key-frame subblock mode probabilities
// [above][left][node], the modes in this file's order (kModeDC ...).
constexpr uint8_t kBModesProba[10 * 10 * 9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};
// RFC 6386 section 14.1: dequantisation of the DC and AC indices.
constexpr uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
constexpr uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
// WebP lossless specification, section 4.2.2: the 120 short distance
// codes, each (dy << 4) | (8 - dx).
constexpr uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

// ------------------------------------------------------------------ VP8L

// LSB-first bits. Past the data the bits read as zero; libwebp's reader
// flags the end of the stream once more bits were taken than the data
// holds (its 64-bit window: never within the first 8 bytes).
struct BitReader {
  const uint8_t* data;
  int64_t size;
  int64_t at = 0;          // next byte to load
  uint64_t val = 0;        // loaded, not yet taken bits
  int nbits = 0;
  int64_t taken = 0;

  BitReader(const uint8_t* d, int64_t n) : data(d), size(n) {}
  void fill() {
    while (nbits <= 56) {
      uint64_t b = at < size ? data[at] : 0;
      ++at;
      val |= b << nbits;
      nbits += 8;
    }
  }
  uint32_t peek(int n) {
    if (nbits < n) fill();
    return static_cast<uint32_t>(val & ((1ull << n) - 1));
  }
  void skip(int n) {
    val >>= n;
    nbits -= n;
    taken += n;
  }
  uint32_t read(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return v;
  }
  bool eos() const { return taken > 8 * std::max<int64_t>(size, 8); }
};

constexpr int kMaxCodeLength = 15;
constexpr int kRootBits = 8;

// A canonical prefix code: an 8-bit root table for the short codes, the
// counts and sorted symbols for the rest (read bit by bit), or one
// symbol read with no bits.
struct Huffman {
  bool single = false;
  int single_symbol = 0;
  uint16_t root_symbol[1 << kRootBits];
  uint8_t root_length[1 << kRootBits];   // 0: a longer code
  int count[kMaxCodeLength + 1];
  std::vector<uint16_t> symbols;

  // libwebp's VP8LBuildHuffmanTable: false for no code, an
  // over-subscribed or an incomplete one; one symbol of a length below 15
  // (and any number of length 15) is read with no bits.
  bool build(const int* lengths, int n) {
    int cnt[kMaxCodeLength + 1] = {0};
    for (int s = 0; s < n; ++s) {
      if (lengths[s] > kMaxCodeLength) return false;
      ++cnt[lengths[s]];
    }
    if (cnt[0] == n) return false;
    int offset[kMaxCodeLength + 1];
    offset[1] = 0;
    for (int len = 1; len < kMaxCodeLength; ++len) {
      if (cnt[len] > (1 << len)) return false;
      offset[len + 1] = offset[len] + cnt[len];
    }
    symbols.assign(n, 0);
    int pos[kMaxCodeLength + 1];
    std::memcpy(pos, offset, sizeof(pos));
    int total = 0;
    for (int s = 0; s < n; ++s) {
      if (lengths[s] > 0) {
        symbols[pos[lengths[s]]++] = static_cast<uint16_t>(s);
        ++total;
      }
    }
    if (offset[kMaxCodeLength] == 1) {
      single = true;
      single_symbol = symbols[0];
      return true;
    }
    int open = 1;
    for (int len = 1; len <= kMaxCodeLength; ++len) {
      open = (open << 1) - cnt[len];
      if (open < 0) return false;
    }
    if (open != 0) return false;
    std::memcpy(count, cnt, sizeof(count));
    symbols.resize(total);
    std::memset(root_length, 0, sizeof(root_length));
    int code = 0, k = 0;
    for (int len = 1; len <= kMaxCodeLength; ++len) {
      for (int i = 0; i < cnt[len]; ++i, ++k, ++code) {
        if (len > kRootBits) continue;
        int rev = 0;
        for (int b = 0; b < len; ++b) rev |= ((code >> (len - 1 - b)) & 1) << b;
        for (int key = rev; key < (1 << kRootBits); key += 1 << len) {
          root_symbol[key] = symbols[k];
          root_length[key] = static_cast<uint8_t>(len);
        }
      }
      code <<= 1;
    }
    return true;
  }

  int read(BitReader& br) const {
    if (single) return single_symbol;
    uint32_t bits = br.peek(24);
    int len = root_length[bits & ((1 << kRootBits) - 1)];
    if (len) {
      br.skip(len);
      return root_symbol[bits & ((1 << kRootBits) - 1)];
    }
    int code = 0, first = 0, index = 0;
    for (len = 1; len <= kMaxCodeLength; ++len) {
      code |= (bits >> (len - 1)) & 1;
      int c = count[len];
      if (code - c < first) {
        br.skip(len);
        return symbols[index + (code - first)];
      }
      index += c;
      first = (first + c) << 1;
      code <<= 1;
    }
    return -1;      // unreachable for a complete code
  }
};

constexpr int kNumLiteral = 256, kNumLength = 24, kNumDistance = 40;
constexpr int kAlphabet[5] = {kNumLiteral + kNumLength, 256, 256, 256,
                              kNumDistance};
constexpr int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7,
                                      8, 9, 10, 11, 12, 13, 14, 15};

struct Group {
  Huffman h[5];   // green (+ lengths + cache), red, blue, alpha, distance
};

struct Transform {
  int type = 0, bits = 0, xsize = 0;
  std::vector<uint32_t> data;
};

struct LosslessDecoder {
  BitReader br;
  unsigned seen = 0;
  std::vector<Transform> transforms;
  explicit LosslessDecoder(const uint8_t* d, int64_t n) : br(d, n) {}

  bool read_code_lengths(const int* cl_lengths, int n, int* lengths) {
    Huffman table;
    if (!table.build(cl_lengths, 19)) return false;
    int max_symbol = n;
    if (br.read(1)) {
      int nbits = 2 + 2 * static_cast<int>(br.read(3));
      max_symbol = 2 + static_cast<int>(br.read(nbits));
      if (max_symbol > n) return false;
    }
    int prev = 8, s = 0;
    while (s < n) {
      if (max_symbol-- == 0) break;
      int len = table.read(br);
      if (len < 16) {
        lengths[s++] = len;
        if (len) prev = len;
      } else {
        static const int extra[3] = {2, 3, 7}, base[3] = {3, 3, 11};
        int slot = len - 16;
        int repeat = static_cast<int>(br.read(extra[slot])) + base[slot];
        if (s + repeat > n) return false;
        int v = slot == 0 ? prev : 0;
        while (repeat-- > 0) lengths[s++] = v;
      }
    }
    return true;
  }

  bool read_code(int alphabet, Huffman& out) {
    std::vector<int> lengths(std::max(alphabet, 256), 0);
    if (br.read(1)) {            // simple: one or two symbols of length 1
      int num = static_cast<int>(br.read(1)) + 1;
      int first_bits = br.read(1) ? 8 : 1;
      lengths[br.read(first_bits)] = 1;
      if (num == 2) lengths[br.read(8)] = 1;
    } else {
      int cl[19] = {0};
      int num = static_cast<int>(br.read(4)) + 4;
      for (int i = 0; i < num; ++i) cl[kCodeLengthOrder[i]] = br.read(3);
      if (!read_code_lengths(cl, alphabet, lengths.data())) return false;
    }
    if (br.eos()) return false;
    return out.build(lengths.data(), alphabet);
  }

  static int subsample(int size, int bits) {
    return (size + (1 << bits) - 1) >> bits;
  }

  // One entropy-coded image into `out`: level 0 reads the transforms
  // first (a colour-indexing transform packs the width its data is coded
  // at) and may hold a meta prefix image.
  bool decode_stream(int xsize, int ysize, bool level0,
                     std::vector<uint32_t>& out) {
    if (level0) {
      while (br.read(1)) {
        int type = static_cast<int>(br.read(2));
        if (seen & (1u << type)) return false;
        seen |= 1u << type;
        Transform t;
        t.type = type;
        t.xsize = xsize;
        if (type == 0 || type == 1) {           // predictor, cross-colour
          t.bits = static_cast<int>(br.read(3)) + 2;
          if (!decode_stream(subsample(xsize, t.bits),
                             subsample(ysize, t.bits), false, t.data))
            return false;
        } else if (type == 3) {                 // colour indexing
          int n = static_cast<int>(br.read(8)) + 1;
          t.bits = n > 16 ? 0 : n > 4 ? 1 : n > 2 ? 2 : 3;
          std::vector<uint32_t> pal;
          if (!decode_stream(n, 1, false, pal)) return false;
          int final_n = 1 << (8 >> t.bits);
          t.data.assign(final_n, 0);
          const uint8_t* src = reinterpret_cast<const uint8_t*>(pal.data());
          uint8_t* dst = reinterpret_cast<uint8_t*>(t.data.data());
          std::memcpy(dst, src, 4);
          for (int i = 4; i < 4 * n; ++i) dst[i] = (src[i] + dst[i - 4]) & 0xff;
          xsize = subsample(xsize, t.bits);
        }
        transforms.push_back(std::move(t));
      }
    }
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = static_cast<int>(br.read(4));
      if (cache_bits < 1 || cache_bits > 11) return false;
    }
    // the prefix codes, and the meta prefix image that picks a group
    int huff_bits = 0, hx = 0;
    std::vector<uint32_t> huff_image;
    int num_groups = 1;
    if (level0 && br.read(1)) {
      huff_bits = static_cast<int>(br.read(3)) + 2;
      hx = subsample(xsize, huff_bits);
      if (!decode_stream(hx, subsample(ysize, huff_bits), false, huff_image))
        return false;
      for (uint32_t& p : huff_image) {
        p = (p >> 8) & 0xffff;
        num_groups = std::max(num_groups, static_cast<int>(p) + 1);
      }
    }
    if (br.eos()) return false;
    // groups no pixel uses are read and checked, not kept
    std::vector<int> slot(num_groups, -1);
    int used = 0;
    if (huff_bits) {
      for (uint32_t& p : huff_image) {
        if (slot[p] < 0) slot[p] = used++;
        p = static_cast<uint32_t>(slot[p]);
      }
    } else {
      slot[0] = used++;
    }
    std::vector<Group> groups(used);
    Huffman scratch;
    for (int g = 0; g < num_groups; ++g) {
      for (int j = 0; j < 5; ++j) {
        int alphabet = kAlphabet[j] + (j == 0 && cache_bits ? 1 << cache_bits : 0);
        Huffman& h = slot[g] >= 0 ? groups[slot[g]].h[j] : scratch;
        if (!read_code(alphabet, h)) return false;
      }
    }
    std::vector<uint32_t> pixels(static_cast<size_t>(xsize) * ysize);
    if (!decode_pixels(pixels, xsize, ysize, cache_bits, groups, huff_image,
                       huff_bits, hx))
      return false;
    out.swap(pixels);
    return true;
  }

  bool decode_pixels(std::vector<uint32_t>& px, int w, int h, int cache_bits,
                     const std::vector<Group>& groups,
                     const std::vector<uint32_t>& huff_image, int huff_bits,
                     int hx) {
    const int64_t total = static_cast<int64_t>(w) * h;
    std::vector<uint32_t> cache(cache_bits ? 1u << cache_bits : 0);
    const int cache_shift = 32 - cache_bits;
    int64_t pos = 0, cached = 0;
    int col = 0, row = 0;
    auto insert = [&](int64_t upto) {
      if (!cache_bits) return;
      for (; cached < upto; ++cached) {
        uint32_t v = px[cached];
        cache[(0x1e35a7bdu * v) >> cache_shift] = v;
      }
    };
    while (pos < total) {
      const Group& g = groups[huff_bits ? huff_image[(row >> huff_bits) * hx +
                                                     (col >> huff_bits)]
                                        : 0];
      int code = g.h[0].read(br);
      if (code < 0) return false;
      if (code < kNumLiteral) {
        uint32_t r = g.h[1].read(br), b = g.h[2].read(br), a = g.h[3].read(br);
        if (br.eos()) return false;
        px[pos++] = (a << 24) | (r << 16) | (static_cast<uint32_t>(code) << 8) | b;
        if (++col >= w) {
          col = 0;
          ++row;
        }
      } else if (code < kNumLiteral + kNumLength) {
        auto copy_value = [&](int sym) -> int {
          if (sym < 4) return sym + 1;
          int extra = (sym - 2) >> 1;
          int offset = (2 + (sym & 1)) << extra;
          return offset + static_cast<int>(br.read(extra)) + 1;
        };
        int length = copy_value(code - kNumLiteral);
        int dsym = g.h[4].read(br);
        int dcode = copy_value(dsym);
        int64_t dist;
        if (dcode > 120) {
          dist = dcode - 120;
        } else {
          int plane = kCodeToPlane[dcode - 1];
          int yoff = plane >> 4, xoff = 8 - (plane & 0xf);
          dist = static_cast<int64_t>(yoff) * w + xoff;
          if (dist < 1) dist = 1;
        }
        if (br.eos()) return false;
        if (pos < dist || total - pos < length) return false;
        for (int i = 0; i < length; ++i) px[pos + i] = px[pos + i - dist];
        pos += length;
        col += length;
        while (col >= w) {
          col -= w;
          ++row;
        }
        insert(pos);
      } else if (code < kNumLiteral + kNumLength + (cache_bits ? 1 << cache_bits : 0)) {
        insert(pos);
        px[pos++] = cache[code - kNumLiteral - kNumLength];
        if (++col >= w) {
          col = 0;
          ++row;
        }
      } else {
        return false;
      }
      if (cache_bits && col == 0) insert(pos);
    }
    return !br.eos();
  }
};

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }

inline uint32_t select(uint32_t a, uint32_t b, uint32_t c) {   // T, L, TL
  int d = sub3(a >> 24, b >> 24, c >> 24) +
          sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
          sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
          sub3(a & 0xff, b & 0xff, c & 0xff);
  return d <= 0 ? a : b;
}

inline uint32_t clamp_add_sub_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    int v = static_cast<int>((c0 >> s) & 0xff) + ((c1 >> s) & 0xff) - ((c2 >> s) & 0xff);
    out |= clip255(static_cast<uint32_t>(v)) << s;
  }
  return out;
}

inline uint32_t clamp_add_sub_half(uint32_t c0, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    int a = (c0 >> s) & 0xff, b = (c2 >> s) & 0xff;
    out |= clip255(static_cast<uint32_t>(a + (a - b) / 2)) << s;
  }
  return out;
}

uint32_t predict(int mode, uint32_t L, const uint32_t* top) {
  const uint32_t T = top[0], TL = top[-1], TR = top[1];
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: return select(T, L, TL);
    case 12: return clamp_add_sub_full(L, T, TL);
    case 13: return clamp_add_sub_half(average2(L, T), TL);
    default: return 0xff000000u;     // 0, and the unused 14 and 15
  }
}

// The transforms inverted in reverse order, in place, `px` coded at the
// last transform's width; returns the pixels at the image's width.
std::vector<uint32_t> invert_transforms(const std::vector<Transform>& ts,
                                        std::vector<uint32_t> px, int h) {
  for (auto it = ts.rbegin(); it != ts.rend(); ++it) {
    const Transform& t = *it;
    const int w = t.xsize;
    if (t.type == 0) {                       // predictor
      const int tiles = (w + (1 << t.bits) - 1) >> t.bits;
      for (int y = 0; y < h; ++y) {
        uint32_t* row = px.data() + static_cast<size_t>(y) * w;
        for (int x = 0; x < w; ++x) {
          uint32_t pred;
          if (y == 0) {
            pred = x == 0 ? 0xff000000u : row[x - 1];
          } else if (x == 0) {
            pred = row[x - w];
          } else {
            int mode = (t.data[(y >> t.bits) * tiles + (x >> t.bits)] >> 8) & 0xf;
            pred = predict(mode, row[x - 1], row + x - w);
          }
          row[x] = add_pixels(row[x], pred);
        }
      }
    } else if (t.type == 1) {                // cross-colour
      const int tiles = (w + (1 << t.bits) - 1) >> t.bits;
      for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
          uint32_t m = t.data[(y >> t.bits) * tiles + (x >> t.bits)];
          int8_t g2r = static_cast<int8_t>(m & 0xff);
          int8_t g2b = static_cast<int8_t>((m >> 8) & 0xff);
          int8_t r2b = static_cast<int8_t>((m >> 16) & 0xff);
          uint32_t& p = px[static_cast<size_t>(y) * w + x];
          int8_t green = static_cast<int8_t>(p >> 8);
          int r = (p >> 16) & 0xff, b = p & 0xff;
          r = (r + ((static_cast<int>(g2r) * green) >> 5)) & 0xff;
          b += (static_cast<int>(g2b) * green) >> 5;
          b += (static_cast<int>(r2b) * static_cast<int8_t>(r)) >> 5;
          b &= 0xff;
          p = (p & 0xff00ff00u) | (static_cast<uint32_t>(r) << 16) | b;
        }
      }
    } else if (t.type == 2) {                // subtract green
      for (uint32_t& p : px) {
        uint32_t g = (p >> 8) & 0xff;
        uint32_t rb = ((p & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
        p = (p & 0xff00ff00u) | rb;
      }
    } else {                                 // colour indexing
      const int packed_w = (w + (1 << t.bits) - 1) >> t.bits;
      std::vector<uint32_t> out(static_cast<size_t>(w) * h);
      const int bpp = 8 >> t.bits, per = 1 << t.bits;
      const uint32_t mask = (1u << bpp) - 1;
      for (int y = 0; y < h; ++y) {
        const uint32_t* src = px.data() + static_cast<size_t>(y) * packed_w;
        uint32_t* dst = out.data() + static_cast<size_t>(y) * w;
        uint32_t packed = 0;
        for (int x = 0; x < w; ++x) {
          if ((x & (per - 1)) == 0) packed = (*src++ >> 8) & 0xff;
          dst[x] = t.data[packed & mask];
          packed >>= bpp;
        }
      }
      px.swap(out);
    }
  }
  return px;
}

// ------------------------------------------------------------------- VP8

// RFC 6386's boolean decoder. Past the data it reads zeros; `eof` is set
// where libwebp's reader sets it: when a read needs a byte the data does
// not hold (the decode then fails).
struct BoolDecoder {
  const uint8_t* data = nullptr;
  int64_t size = 0, at = 0;
  uint32_t value = 0, range = 255;
  int bit_count = 0;
  int64_t shifts = 0;
  bool eof = false;

  void init(const uint8_t* d, int64_t n) {
    data = d;
    size = n;
    at = 0;
    value = next() << 8;
    value |= next();
    range = 255;
    bit_count = 0;
    shifts = 0;
    eof = false;
  }
  uint32_t next() { return at < size ? data[at++] : (++at, 0u); }
  int get(int prob) {
    if (1 + (shifts + 7) / 8 > size) eof = true;
    uint32_t split = 1 + (((range - 1) * static_cast<uint32_t>(prob)) >> 8);
    uint32_t big = split << 8;
    int bit;
    if (value >= big) {
      bit = 1;
      range -= split;
      value -= big;
    } else {
      bit = 0;
      range = split;
    }
    while (range < 128) {
      value <<= 1;
      range <<= 1;
      ++shifts;
      if (++bit_count == 8) {
        bit_count = 0;
        value |= next();
      }
    }
    return bit;
  }
  int literal(int bits) {
    int v = 0;
    while (bits-- > 0) v = (v << 1) | get(128);
    return v;
  }
  int signed_literal(int bits) {
    int v = literal(bits);
    return get(128) ? -v : v;
  }
};

enum {
  kModeDC = 0, kModeTM, kModeVE, kModeHE, kModeRD, kModeVR, kModeLD,
  kModeVL, kModeHD, kModeHU,
  // 16x16 and chroma modes share the first four numbers
  kDCNoTop = 10, kDCNoLeft, kDCNoTopLeft
};

constexpr uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7,
                                 11, 14, 15};
constexpr uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6,
                                7, 0};
constexpr uint8_t kCat3[] = {173, 148, 140, 0};
constexpr uint8_t kCat4[] = {176, 155, 140, 135, 0};
constexpr uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133,
                             130, 129, 0};
const uint8_t* const kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

struct MBInfo {
  uint8_t nz = 0, nz_dc = 0;   // the non-zero flags of the right column /
                               // bottom row of blocks, and of the Y2 block
};

struct MBData {
  int16_t coeffs[384];
  uint8_t is_i4x4, modes[16], uvmode, segment, skip;
  bool inner;                  // the loop filter's inner edges
};

struct FilterInfo {
  int limit = 0, ilevel = 0, hev_thresh = 0;
  bool inner = false;
};

struct Quant {
  int y1[2], y2[2], uv[2];
};

struct Vp8Decoder {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  BoolDecoder br;
  BoolDecoder parts[8];
  int num_parts = 1;
  bool use_segment = false, update_map = false, absolute_delta = false;
  int quantizer[4] = {0}, filter_strength[4] = {0};
  int seg_proba[3] = {255, 255, 255};
  int simple = 0, level = 0, sharpness = 0;
  bool use_lf_delta = false;
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  int filter_type = 0;
  Quant dqm[4];
  uint8_t proba[4][8][3][11];
  bool use_skip = false;
  int skip_p = 0;
  FilterInfo fstrengths[4][2];
  // planes with a margin: row -1 and column -1 hold the frame's border
  int ystride = 0, uvstride = 0;
  std::vector<uint8_t> ybuf, ubuf, vbuf;

  uint8_t* Y(int x, int y) { return &ybuf[(y + 1) * ystride + x + 1]; }
  uint8_t* U(int x, int y) { return &ubuf[(y + 1) * uvstride + x + 1]; }
  uint8_t* V(int x, int y) { return &vbuf[(y + 1) * uvstride + x + 1]; }
};

bool parse_header(Vp8Decoder& d, const uint8_t* buf, int64_t size) {
  if (size < 10) return false;
  uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
  bool key = !(bits & 1);
  int profile = (bits >> 1) & 7, show = (bits >> 4) & 1;
  int64_t part0 = bits >> 5;
  if (profile > 3 || !show || !key) return false;
  if (buf[3] != 0x9d || buf[4] != 0x01 || buf[5] != 0x2a) return false;
  d.width = ((buf[7] << 8) | buf[6]) & 0x3fff;
  d.height = ((buf[9] << 8) | buf[8]) & 0x3fff;
  if (d.width == 0 || d.height == 0) return false;
  d.mb_w = (d.width + 15) >> 4;
  d.mb_h = (d.height + 15) >> 4;
  buf += 10;
  size -= 10;
  if (part0 > size) return false;
  BoolDecoder& br = d.br;
  br.init(buf, part0);
  buf += part0;
  size -= part0;
  br.get(128);      // colour space
  br.get(128);      // clamping type
  d.use_segment = br.get(128);
  if (d.use_segment) {
    d.update_map = br.get(128);
    if (br.get(128)) {
      d.absolute_delta = br.get(128);
      for (int s = 0; s < 4; ++s) d.quantizer[s] = br.get(128) ? br.signed_literal(7) : 0;
      for (int s = 0; s < 4; ++s) d.filter_strength[s] = br.get(128) ? br.signed_literal(6) : 0;
    }
    if (d.update_map) {
      for (int s = 0; s < 3; ++s) d.seg_proba[s] = br.get(128) ? br.literal(8) : 255;
    }
  }
  if (br.eof) return false;
  d.simple = br.get(128);
  d.level = br.literal(6);
  d.sharpness = br.literal(3);
  d.use_lf_delta = br.get(128);
  if (d.use_lf_delta && br.get(128)) {
    for (int i = 0; i < 4; ++i)
      if (br.get(128)) d.ref_lf_delta[i] = br.signed_literal(6);
    for (int i = 0; i < 4; ++i)
      if (br.get(128)) d.mode_lf_delta[i] = br.signed_literal(6);
  }
  d.filter_type = d.level == 0 ? 0 : d.simple ? 1 : 2;
  if (br.eof) return false;
  // the token partitions
  d.num_parts = 1 << br.literal(2);
  const int64_t last = d.num_parts - 1;
  if (size < 3 * last) return false;
  const uint8_t* sz = buf;
  const uint8_t* start = buf + 3 * last;
  int64_t left = size - 3 * last;
  for (int p = 0; p < last; ++p) {
    int64_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > left) psize = left;
    d.parts[p].init(start, psize);
    start += psize;
    left -= psize;
    sz += 3;
  }
  d.parts[last].init(start, left);
  if (left <= 0) return false;
  // quantisers
  int base_q = br.literal(7);
  int dq[5];
  for (int i = 0; i < 5; ++i) dq[i] = br.get(128) ? br.signed_literal(4) : 0;
  auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  for (int s = 0; s < 4; ++s) {
    int q = d.use_segment ? d.quantizer[s] + (d.absolute_delta ? 0 : base_q) : base_q;
    Quant& m = d.dqm[s];
    m.y1[0] = kDcTable[clip(q + dq[0], 127)];
    m.y1[1] = kAcTable[clip(q, 127)];
    m.y2[0] = kDcTable[clip(q + dq[1], 127)] * 2;
    m.y2[1] = (kAcTable[clip(q + dq[2], 127)] * 101581) >> 16;
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip(q + dq[3], 117)];
    m.uv[1] = kAcTable[clip(q + dq[4], 127)];
  }
  br.get(128);      // refresh_entropy_probs: ignored
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p) {
          int i = ((t * 8 + b) * 3 + c) * 11 + p;
          d.proba[t][b][c][p] = br.get(kCoeffUpdateProba[i]) ? br.literal(8) : kCoeffProba0[i];
        }
  d.use_skip = br.get(128);
  if (d.use_skip) d.skip_p = br.literal(8);
  // the loop filter's strengths
  if (d.filter_type > 0) {
    for (int s = 0; s < 4; ++s) {
      int base = d.use_segment ? d.filter_strength[s] + (d.absolute_delta ? 0 : d.level) : d.level;
      for (int i4 = 0; i4 <= 1; ++i4) {
        FilterInfo& f = d.fstrengths[s][i4];
        int lvl = base;
        if (d.use_lf_delta) {
          lvl += d.ref_lf_delta[0];
          if (i4) lvl += d.mode_lf_delta[0];
        }
        lvl = lvl < 0 ? 0 : lvl > 63 ? 63 : lvl;
        if (lvl > 0) {
          int il = lvl;
          if (d.sharpness > 0) {
            il >>= d.sharpness > 4 ? 2 : 1;
            if (il > 9 - d.sharpness) il = 9 - d.sharpness;
          }
          if (il < 1) il = 1;
          f.ilevel = il;
          f.limit = 2 * lvl + il;
          f.hev_thresh = lvl >= 40 ? 2 : lvl >= 15 ? 1 : 0;
        } else {
          f.limit = 0;
        }
        f.inner = i4;
      }
    }
  }
  return true;
}

void parse_modes(Vp8Decoder& d, MBData& mb, uint8_t* top, uint8_t* left) {
  BoolDecoder& br = d.br;
  mb.segment = d.update_map
      ? (!br.get(d.seg_proba[0]) ? br.get(d.seg_proba[1]) : br.get(d.seg_proba[2]) + 2)
      : 0;
  mb.skip = d.use_skip ? br.get(d.skip_p) : 0;
  mb.is_i4x4 = !br.get(145);
  if (!mb.is_i4x4) {
    int ymode = br.get(156) ? (br.get(128) ? kModeTM : kModeHE)
                            : (br.get(163) ? kModeVE : kModeDC);
    mb.modes[0] = ymode;
    std::memset(top, ymode, 4);
    std::memset(left, ymode, 4);
  } else {
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* p = kBModesProba + (top[x] * 10 + ymode) * 9;
        ymode = !br.get(p[0]) ? kModeDC
              : !br.get(p[1]) ? kModeTM
              : !br.get(p[2]) ? kModeVE
              : !br.get(p[3])
                  ? (!br.get(p[4]) ? kModeHE : (!br.get(p[5]) ? kModeRD : kModeVR))
                  : (!br.get(p[6]) ? kModeLD
                     : (!br.get(p[7]) ? kModeVL : (!br.get(p[8]) ? kModeHD : kModeHU)));
        top[x] = ymode;
        mb.modes[y * 4 + x] = ymode;
      }
      left[y] = ymode;
    }
  }
  mb.uvmode = !br.get(142) ? kModeDC : !br.get(114) ? kModeVE
            : br.get(183) ? kModeTM : kModeHE;
}

int large_value(BoolDecoder& br, const uint8_t* p) {
  if (!br.get(p[3])) {
    if (!br.get(p[4])) return 2;
    return 3 + br.get(p[5]);
  }
  if (!br.get(p[6])) {
    if (!br.get(p[7])) return 5 + br.get(159);
    int v = 7 + 2 * br.get(165);
    return v + br.get(145);
  }
  int bit1 = br.get(p[8]);
  int bit0 = br.get(p[9 + bit1]);
  int cat = 2 * bit1 + bit0;
  int v = 0;
  for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get(*tab);
  return v + 3 + (8 << cat);
}

// libwebp's GetCoeffs: the tokens of one block from position n, returns
// where the block ended (16 if a run of zeros reached its end).
int get_coeffs(BoolDecoder& br, const uint8_t (*prob)[3][11], int ctx,
               const int* dq, int n, int16_t* out) {
  const uint8_t* p = prob[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.get(p[0])) return n;
    while (!br.get(p[1])) {
      p = prob[kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    if (!br.get(p[2])) {
      v = 1;
      p = prob[kBands[n + 1]][1];
    } else {
      v = large_value(br, p);
      p = prob[kBands[n + 1]][2];
    }
    out[kZigzag[n]] = static_cast<int16_t>((br.get(128) ? -v : v) * dq[n > 0]);
  }
  return 16;
}

void inverse_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    int dc = tmp[0 + i * 4] + 3;
    int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

// returns whether the macroblock has non-zero coefficients (libwebp's
// !skip of ParseResiduals)
bool parse_residuals(Vp8Decoder& d, MBData& mb, MBInfo& top, MBInfo& left,
                     BoolDecoder& br) {
  const Quant& q = d.dqm[mb.segment];
  int16_t* dst = mb.coeffs;
  std::memset(dst, 0, sizeof(mb.coeffs));
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  int first;
  const uint8_t (*ac)[3][11];
  if (!mb.is_i4x4) {
    int16_t dc[16] = {0};
    int ctx = top.nz_dc + left.nz_dc;
    int nz = get_coeffs(br, d.proba[1], ctx, q.y2, 0, dc);
    top.nz_dc = left.nz_dc = nz > 0;
    if (nz > 1) {
      inverse_wht(dc, dst);
    } else {
      int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 256; i += 16) dst[i] = static_cast<int16_t>(dc0);
    }
    first = 1;
    ac = d.proba[0];
  } else {
    first = 0;
    ac = d.proba[3];
  }
  auto code_bits = [](uint32_t acc, int nz, int dc_nz) {
    return (acc << 2) | (nz > 3 ? 3 : nz > 1 ? 2 : dc_nz);
  };
  uint8_t tnz = top.nz & 0x0f, lnz = left.nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nzc = 0;
    for (int x = 0; x < 4; ++x) {
      int ctx = l + (tnz & 1);
      int nz = get_coeffs(br, ac, ctx, q.y1, first, dst);
      l = nz > first;
      tnz = (tnz >> 1) | (l << 7);
      nzc = code_bits(nzc, nz, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = (lnz >> 1) | (l << 7);
    non_zero_y = (non_zero_y << 8) | nzc;
  }
  uint32_t out_t = tnz, out_l = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nzc = 0;
    tnz = top.nz >> (4 + ch);
    lnz = left.nz >> (4 + ch);
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        int ctx = l + (tnz & 1);
        int nz = get_coeffs(br, d.proba[2], ctx, q.uv, 0, dst);
        l = nz > 0;
        tnz = (tnz >> 1) | (l << 3);
        nzc = code_bits(nzc, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = (lnz >> 1) | (l << 5);
    }
    non_zero_uv |= nzc << (4 * ch);
    out_t |= (tnz << 4) << ch;
    out_l |= (lnz & 0xf0) << ch;
  }
  top.nz = static_cast<uint8_t>(out_t);
  left.nz = static_cast<uint8_t>(out_l);
  return (non_zero_y | non_zero_uv) != 0;
}

// ---------------------------------------------------- reconstruction

constexpr int kC1 = 20091, kC2 = 35468;
inline int mul1(int a) { return ((a * kC1) >> 16) + a; }
inline int mul2(int a) { return (a * kC2) >> 16; }

void add_idct(const int16_t* in, uint8_t* dst, int stride) {
  int c[16];
  int* tmp = c;
  for (int i = 0; i < 4; ++i) {
    int a = in[0] + in[8], b = in[0] - in[8];
    int cc = mul2(in[4]) - mul1(in[12]);
    int dd = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + dd;
    tmp[1] = b + cc;
    tmp[2] = b - cc;
    tmp[3] = a - dd;
    tmp += 4;
    ++in;
  }
  tmp = c;
  for (int i = 0; i < 4; ++i) {
    int dc = tmp[0] + 4;
    int a = dc + tmp[8], b = dc - tmp[8];
    int cc = mul2(tmp[4]) - mul1(tmp[12]);
    int dd = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + dd) >> 3));
    dst[1] = clip8(dst[1] + ((b + cc) >> 3));
    dst[2] = clip8(dst[2] + ((b - cc) >> 3));
    dst[3] = clip8(dst[3] + ((a - dd) >> 3));
    ++tmp;
    dst += stride;
  }
}

#define AVG3(a, b, c) (static_cast<uint8_t>(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (static_cast<uint8_t>(((a) + (b) + 1) >> 1))

// 4x4 prediction into dst (stride s); `top` holds the 8 pixels above
// from column 0 (top[-1] the corner), `left` the 4 to the left.
void predict4(int mode, uint8_t* dst, int s, const uint8_t* top,
              const uint8_t* left) {
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3],
            E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = left[0], J = left[1], K = left[2], L = left[3];
#define DST(x, y) dst[(x) + (y) * s]
  switch (mode) {
    case kModeDC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + left[i];
      dc >>= 3;
      for (int y = 0; y < 4; ++y) std::memset(dst + y * s, dc, 4);
      break;
    }
    case kModeTM:
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) DST(x, y) = clip8(top[x] + left[y] - X);
      break;
    case kModeVE: {
      uint8_t v[4] = {AVG3(X, A, B), AVG3(A, B, C), AVG3(B, C, D), AVG3(C, D, E)};
      for (int y = 0; y < 4; ++y) std::memcpy(dst + y * s, v, 4);
      break;
    }
    case kModeHE: {
      uint8_t v[4] = {AVG3(X, I, J), AVG3(I, J, K), AVG3(J, K, L), AVG3(K, L, L)};
      for (int y = 0; y < 4; ++y) std::memset(dst + y * s, v[y], 4);
      break;
    }
    case kModeRD:
      DST(0, 3) = AVG3(J, K, L);
      DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
      DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
      DST(3, 0) = AVG3(D, C, B);
      break;
    case kModeLD:
      DST(0, 0) = AVG3(A, B, C);
      DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
      DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
      DST(3, 3) = AVG3(G, H, H);
      break;
    case kModeVR:
      DST(0, 0) = DST(1, 2) = AVG2(X, A);
      DST(1, 0) = DST(2, 2) = AVG2(A, B);
      DST(2, 0) = DST(3, 2) = AVG2(B, C);
      DST(3, 0) = AVG2(C, D);
      DST(0, 3) = AVG3(K, J, I);
      DST(0, 2) = AVG3(J, I, X);
      DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
      DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
      DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
      DST(3, 1) = AVG3(B, C, D);
      break;
    case kModeVL:
      DST(0, 0) = AVG2(A, B);
      DST(1, 0) = DST(0, 2) = AVG2(B, C);
      DST(2, 0) = DST(1, 2) = AVG2(C, D);
      DST(3, 0) = DST(2, 2) = AVG2(D, E);
      DST(0, 1) = AVG3(A, B, C);
      DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
      DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
      DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
      DST(3, 2) = AVG3(E, F, G);
      DST(3, 3) = AVG3(F, G, H);
      break;
    case kModeHD:
      DST(0, 0) = DST(2, 1) = AVG2(I, X);
      DST(0, 1) = DST(2, 2) = AVG2(J, I);
      DST(0, 2) = DST(2, 3) = AVG2(K, J);
      DST(0, 3) = AVG2(L, K);
      DST(3, 0) = AVG3(A, B, C);
      DST(2, 0) = AVG3(X, A, B);
      DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
      DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
      DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
      DST(1, 3) = AVG3(L, K, J);
      break;
    case kModeHU:
      DST(0, 0) = AVG2(I, J);
      DST(2, 0) = DST(0, 1) = AVG2(J, K);
      DST(2, 1) = DST(0, 2) = AVG2(K, L);
      DST(1, 0) = AVG3(I, J, K);
      DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
      DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
  }
#undef DST
}

// size x size prediction (16 luma, 8 chroma) of mode (after the DC
// variants' choice), top / left / corner given.
void predict_block(int mode, int size, uint8_t* dst, int s, const uint8_t* top,
                   const uint8_t* left, int corner) {
  const int shift = size == 16 ? 5 : 4;
  int dc = 0;
  switch (mode) {
    case kModeDC:
      for (int i = 0; i < size; ++i) dc += top[i] + left[i];
      dc = (dc + size) >> shift;
      break;
    case kDCNoTop:
      for (int i = 0; i < size; ++i) dc += left[i];
      dc = (dc + size / 2) >> (shift - 1);
      break;
    case kDCNoLeft:
      for (int i = 0; i < size; ++i) dc += top[i];
      dc = (dc + size / 2) >> (shift - 1);
      break;
    case kDCNoTopLeft:
      dc = 0x80;
      break;
    case kModeTM:
      for (int y = 0; y < size; ++y)
        for (int x = 0; x < size; ++x) dst[y * s + x] = clip8(top[x] + left[y] - corner);
      return;
    case kModeVE:
      for (int y = 0; y < size; ++y) std::memcpy(dst + y * s, top, size);
      return;
    case kModeHE:
      for (int y = 0; y < size; ++y) std::memset(dst + y * s, left[y], size);
      return;
  }
  for (int y = 0; y < size; ++y) std::memset(dst + y * s, dc, size);
}

int check_mode(int mb_x, int mb_y, int mode) {
  if (mode == kModeDC) {
    if (mb_x == 0) return mb_y == 0 ? kDCNoTopLeft : kDCNoLeft;
    return mb_y == 0 ? kDCNoTop : kModeDC;
  }
  return mode;
}

// one macroblock into the planes, predicted from its unfiltered
// neighbours (the planes are filtered only after the whole frame)
void reconstruct(Vp8Decoder& d, const MBData& mb, int mb_x, int mb_y) {
  const int ys = d.ystride, uvs = d.uvstride;
  const int x0 = mb_x * 16, y0 = mb_y * 16;
  // the row above (127 over the frame) and the column to the left (129
  // left of it); the corner is 127 in the first row, else 129 in the
  // first column, else the pixel up and left
  uint8_t top[16 + 4 + 1], left[16];
  uint8_t* t = top + 1;
  if (mb_y == 0) {
    std::memset(top, 127, sizeof(top));
  } else {
    std::memcpy(t, d.Y(x0, y0 - 1), 16);
    if (mb_x < d.mb_w - 1) {
      std::memcpy(t + 16, d.Y(x0 + 16, y0 - 1), 4);
    } else {
      std::memset(t + 16, t[15], 4);
    }
    top[0] = mb_x == 0 ? 129 : *d.Y(x0 - 1, y0 - 1);
  }
  for (int j = 0; j < 16; ++j) left[j] = mb_x == 0 ? 129 : *d.Y(x0 - 1, y0 + j);
  uint8_t* dst = d.Y(x0, y0);
  if (mb.is_i4x4) {
    // each 4x4 block in turn: its top (and top-right) from the row above
    // or the blocks already done; the right column's top-right is the
    // macroblock's own top-right
    for (int n = 0; n < 16; ++n) {
      int bx = n & 3, by = n >> 2;
      uint8_t btop[9];
      uint8_t* bt = btop + 1;
      uint8_t bleft[4];
      uint8_t* bdst = dst + by * 4 * ys + bx * 4;
      if (by == 0) {
        std::memcpy(btop, t + bx * 4 - 1, 9);
      } else {
        btop[0] = bx == 0 ? left[by * 4 - 1] : bdst[-ys - 1];
        std::memcpy(bt, bdst - ys, 4);
        if (bx == 3) {
          std::memcpy(bt + 4, t + 16, 4);
        } else {
          std::memcpy(bt + 4, bdst - ys + 4, 4);
        }
      }
      for (int j = 0; j < 4; ++j) bleft[j] = bx == 0 ? left[by * 4 + j] : bdst[j * ys - 1];
      predict4(mb.modes[n], bdst, ys, bt, bleft);
      add_idct(mb.coeffs + n * 16, bdst, ys);
    }
  } else {
    predict_block(check_mode(mb_x, mb_y, mb.modes[0]), 16, dst, ys, t, left, top[0]);
    for (int n = 0; n < 16; ++n) {
      add_idct(mb.coeffs + n * 16, dst + (n >> 2) * 4 * ys + (n & 3) * 4, ys);
    }
  }
  // chroma
  const int cx = mb_x * 8, cy = mb_y * 8;
  for (int p = 0; p < 2; ++p) {
    uint8_t ctop[8], cleft[8];
    int corner;
    auto P = [&](int x, int y) { return p == 0 ? d.U(x, y) : d.V(x, y); };
    if (mb_y == 0) {
      std::memset(ctop, 127, 8);
      corner = 127;
    } else {
      std::memcpy(ctop, P(cx, cy - 1), 8);
      corner = mb_x == 0 ? 129 : *P(cx - 1, cy - 1);
    }
    for (int j = 0; j < 8; ++j) cleft[j] = mb_x == 0 ? 129 : *P(cx - 1, cy + j);
    uint8_t* cdst = P(cx, cy);
    predict_block(check_mode(mb_x, mb_y, mb.uvmode), 8, cdst, uvs, ctop, cleft, corner);
    const int16_t* co = mb.coeffs + (16 + 4 * p) * 16;
    for (int n = 0; n < 4; ++n) add_idct(co + n * 16, cdst + (n >> 1) * 4 * uvs + (n & 1) * 4, uvs);
  }
}

// ------------------------------------------------------------ loop filter

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void filter2(uint8_t* p, int step) {
  int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void filter4(uint8_t* p, int step) {
  int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  int a = 3 * (q0 - p0);
  int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void filter6(uint8_t* p, int step) {
  int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int t) {
  return std::abs(p[-2 * step] - p[-step]) > t || std::abs(p[step] - p[0]) > t;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  return 4 * std::abs(p[-step] - p[0]) + std::abs(p[-2 * step] - p[step]) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// hstride: across the edge, vstride: along it
void simple_edge(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) filter2(p, hstride);
}

void normal_edge(uint8_t* p, int hstride, int vstride, int size, int thresh,
                 int ithresh, int hev_t, bool mb_edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_t)) {
      filter2(p, hstride);
    } else if (mb_edge) {
      filter6(p, hstride);
    } else {
      filter4(p, hstride);
    }
  }
}

void loop_filter(Vp8Decoder& d, const FilterInfo& f, int mb_x, int mb_y) {
  const int limit = f.limit;
  if (limit == 0) return;
  const int ys = d.ystride, uvs = d.uvstride;
  uint8_t* y = d.Y(mb_x * 16, mb_y * 16);
  if (d.filter_type == 1) {
    if (mb_x > 0) simple_edge(y, 1, ys, limit + 4);
    if (f.inner)
      for (int k = 4; k < 16; k += 4) simple_edge(y + k, 1, ys, limit);
    if (mb_y > 0) simple_edge(y, ys, 1, limit + 4);
    if (f.inner)
      for (int k = 4; k < 16; k += 4) simple_edge(y + k * ys, ys, 1, limit);
    return;
  }
  uint8_t* u = d.U(mb_x * 8, mb_y * 8);
  uint8_t* v = d.V(mb_x * 8, mb_y * 8);
  const int il = f.ilevel, ht = f.hev_thresh;
  if (mb_x > 0) {
    normal_edge(y, 1, ys, 16, limit + 4, il, ht, true);
    normal_edge(u, 1, uvs, 8, limit + 4, il, ht, true);
    normal_edge(v, 1, uvs, 8, limit + 4, il, ht, true);
  }
  if (f.inner) {
    for (int k = 4; k < 16; k += 4) normal_edge(y + k, 1, ys, 16, limit, il, ht, false);
    normal_edge(u + 4, 1, uvs, 8, limit, il, ht, false);
    normal_edge(v + 4, 1, uvs, 8, limit, il, ht, false);
  }
  if (mb_y > 0) {
    normal_edge(y, ys, 1, 16, limit + 4, il, ht, true);
    normal_edge(u, uvs, 1, 8, limit + 4, il, ht, true);
    normal_edge(v, uvs, 1, 8, limit + 4, il, ht, true);
  }
  if (f.inner) {
    for (int k = 4; k < 16; k += 4) normal_edge(y + k * ys, ys, 1, 16, limit, il, ht, false);
    normal_edge(u + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
    normal_edge(v + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
  }
}

// ------------------------------------------------- YUV -> BGR, upsampled

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip(int v) {
  return ((v & ~16383) == 0) ? static_cast<uint8_t>(v >> 6) : v < 0 ? 0 : 255;
}
inline void yuv_to_bgr(int y, int u, int v, uint8_t* bgr) {
  bgr[0] = yuv_clip(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
  bgr[1] = yuv_clip(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  bgr[2] = yuv_clip(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
}

// libwebp's UpsampleBgrLinePair: two output rows (bottom may be null)
// from their luma rows and the chroma rows above (top_*) and below
// (cur_*) them, the chroma interpolated 9-3-3-1.
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y,
                   const uint8_t* top_u, const uint8_t* top_v,
                   const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  const int last_pair = (len - 1) >> 1;
  int tl_u = top_u[0], tl_v = top_v[0], l_u = cur_u[0], l_v = cur_v[0];
  yuv_to_bgr(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst);
  if (bottom_y)
    yuv_to_bgr(bottom_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bottom_dst);
  for (int x = 1; x <= last_pair; ++x) {
    const int t_u = top_u[x], t_v = top_v[x], u = cur_u[x], v = cur_v[x];
    const int avg_u = tl_u + t_u + l_u + u + 8, avg_v = tl_v + t_v + l_v + v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + u)) >> 3, d03_v = (avg_v + 2 * (tl_v + v)) >> 3;
    yuv_to_bgr(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1, top_dst + (2 * x - 1) * 3);
    yuv_to_bgr(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, top_dst + (2 * x) * 3);
    if (bottom_y) {
      yuv_to_bgr(bottom_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1, bottom_dst + (2 * x - 1) * 3);
      yuv_to_bgr(bottom_y[2 * x], (d12_u + u) >> 1, (d12_v + v) >> 1, bottom_dst + (2 * x) * 3);
    }
    tl_u = t_u; tl_v = t_v; l_u = u; l_v = v;
  }
  if (!(len & 1)) {
    yuv_to_bgr(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst + (len - 1) * 3);
    if (bottom_y)
      yuv_to_bgr(bottom_y[len - 1], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bottom_dst + (len - 1) * 3);
  }
}

}  // namespace

extern "C" {

// A VP8L stream (data, n bytes) of a width x height image into argb
// (width * height, 0xAARRGGBB). `headerless` for an ALPH chunk's stream,
// whose size its container gives; else the stream opens with the 0x2f
// signature, the 14-bit sizes, the alpha hint and the version (0), and
// the sizes must be width x height. Returns 0, or 1 for a stream libwebp
// refuses.
int ys_webp_lossless(const uint8_t* data, int64_t n, int width, int height,
                     int headerless, uint32_t* argb) {
  LosslessDecoder dec(data, n);
  if (!headerless) {
    if (dec.br.read(8) != 0x2f) return 1;
    int w = static_cast<int>(dec.br.read(14)) + 1;
    int h = static_cast<int>(dec.br.read(14)) + 1;
    dec.br.read(1);
    if (dec.br.read(3) != 0 || dec.br.eos() || w != width || h != height) return 1;
  }
  std::vector<uint32_t> px;
  if (!dec.decode_stream(width, height, true, px)) return 1;
  px = invert_transforms(dec.transforms, std::move(px), height);
  std::memcpy(argb, px.data(), px.size() * sizeof(uint32_t));
  return 0;
}

// A VP8 key frame (data, n bytes: the frame tag, the key-frame header and
// the partitions) of width x height into bgr (height rows of width * 3),
// with libwebp's fancy upsampling. Returns 0, or 1 for a frame libwebp
// refuses (a bad header or partition, data that ends early).
int ys_webp_lossy(const uint8_t* data, int64_t n, int width, int height,
                  uint8_t* bgr) {
  Vp8Decoder d;
  if (!parse_header(d, data, n) || d.width != width || d.height != height) return 1;
  d.ystride = d.mb_w * 16 + 1;
  d.uvstride = d.mb_w * 8 + 1;
  d.ybuf.assign(static_cast<size_t>(d.ystride) * (d.mb_h * 16 + 1), 0);
  d.ubuf.assign(static_cast<size_t>(d.uvstride) * (d.mb_h * 8 + 1), 0);
  d.vbuf.assign(d.ubuf.size(), 0);
  std::vector<MBInfo> top_info(d.mb_w);
  std::vector<uint8_t> intra_top(4 * d.mb_w, kModeDC);
  std::vector<FilterInfo> finfo(static_cast<size_t>(d.mb_w) * d.mb_h);
  std::vector<MBData> row(d.mb_w);
  for (int mb_y = 0; mb_y < d.mb_h; ++mb_y) {
    uint8_t intra_left[4];
    std::memset(intra_left, kModeDC, 4);
    for (int mb_x = 0; mb_x < d.mb_w; ++mb_x)
      parse_modes(d, row[mb_x], &intra_top[4 * mb_x], intra_left);
    if (d.br.eof) return 1;
    BoolDecoder& tokens = d.parts[mb_y & (d.num_parts - 1)];
    MBInfo left;
    for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) {
      MBData& mb = row[mb_x];
      bool coded = false;
      if (!mb.skip) {
        coded = parse_residuals(d, mb, top_info[mb_x], left, tokens);
      } else {
        left.nz = top_info[mb_x].nz = 0;
        if (!mb.is_i4x4) left.nz_dc = top_info[mb_x].nz_dc = 0;
        std::memset(mb.coeffs, 0, sizeof(mb.coeffs));
      }
      if (tokens.eof) return 1;
      if (d.filter_type > 0) {
        FilterInfo f = d.fstrengths[mb.segment][mb.is_i4x4];
        f.inner = f.inner || coded;
        finfo[static_cast<size_t>(mb_y) * d.mb_w + mb_x] = f;
      }
      reconstruct(d, mb, mb_x, mb_y);
    }
  }
  if (d.filter_type > 0) {
    for (int mb_y = 0; mb_y < d.mb_h; ++mb_y)
      for (int mb_x = 0; mb_x < d.mb_w; ++mb_x)
        loop_filter(d, finfo[static_cast<size_t>(mb_y) * d.mb_w + mb_x], mb_x, mb_y);
  }
  // rows: the first with the first chroma row alone, then pairs (2j - 1,
  // 2j) between chroma rows j - 1 and j, the last of an even height alone
  const int w = width, h = height;
  auto yrow = [&](int y) { return d.Y(0, y); };
  auto urow = [&](int j) { return d.U(0, j); };
  auto vrow = [&](int j) { return d.V(0, j); };
  upsample_pair(yrow(0), nullptr, urow(0), vrow(0), urow(0), vrow(0), bgr, nullptr, w);
  for (int y = 1; y + 1 < h; y += 2) {
    int j = (y + 1) >> 1;
    upsample_pair(yrow(y), yrow(y + 1), urow(j - 1), vrow(j - 1), urow(j), vrow(j),
                  bgr + static_cast<size_t>(y) * w * 3,
                  bgr + static_cast<size_t>(y + 1) * w * 3, w);
  }
  if (h > 1 && !(h & 1)) {
    int j = (h >> 1) - 1;
    upsample_pair(yrow(h - 1), nullptr, urow(j), vrow(j), urow(j), vrow(j),
                  bgr + static_cast<size_t>(h - 1) * w * 3, nullptr, w);
  }
  return 0;
}

}  // extern "C"
