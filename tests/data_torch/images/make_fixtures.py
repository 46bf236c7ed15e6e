"""Write the committed image fixtures of this folder and their manifest:
the JPEG kinds beyond baseline (progressive, Adobe CMYK), the PNG kinds
beyond 8-bit gray / RGB / RGBA, baseline TIFF kinds, BMP kinds beyond 8-,
24- and 32-bit (1 / 4 / 16 bits, bit fields, RLE, OS/2), PNM and PAM, and
WebP (lossy, lossless, alpha, EXIF, animated, the simple loop filter, and
WebP bytes under a .jpg name).

    python tests/data_torch/images/make_fixtures.py          # missing ones
    python tests/data_torch/images/make_fixtures.py --all    # all of them
    python tests/data_torch/images/make_fixtures.py --time   # time decodes

The kinds cv2.imread reads with libjpeg-turbo's and libtiff's recovery
and rarer codecs: JPEG cut short (baseline and progressive), without EOI,
with restart markers misnumbered or missing, progressive with low
coefficients left unrefined (block smoothing), YCCK, sequential of several
scans, arithmetic-coded (sequential with restarts, progressive); TIFF of
uncompressed YCbCr (4:2:0, 4:2:2), an LZW strip that ends short,
JPEG-in-TIFF (YCbCr, PIL's RGB, cv2's gray), CCITT (modified Huffman, T.4
2D, T.6 with FillOrder 2) and CMYK (PIL's LZW, planar).

Needs cv2 and PIL (the machines that only read the fixtures need neither):
cv2.imencode and PIL write what they write, ``writers.py`` the kinds
neither writes (Adam7 PNG, tiled, planar, big-endian, min-is-white,
old-style LZW and oriented TIFF, the BMP kinds, ASCII and odd-maxval PNM,
PAM), tests/libwebp_encode.py the VP8 options only libwebp's advanced API
sets. Each file holds the smooth synthetic content of
../jpeg/make_fixtures.py. The fixtures on disk are kept unless ``--all``
is given; the manifest is rewritten from them: its entry records how each
was written, its size, the shape of cv2.imread(IMREAD_COLOR) -> RGB and
the SHA-256 of those RGB bytes: the port's reader must give the same
bytes.
``--time`` writes nothing: it prints the host ms of the port's
read_image_rgb and of cv2.imread for each fixture (the median of 50), on
this machine's CPU."""

import hashlib
import io
import json
import os
import struct
import sys
import time

import cv2
import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "jpeg"))
from make_fixtures import encode, smooth_image  # noqa: E402
from writers import (BI_BITFIELDS, BI_RLE4, BI_RLE8,  # noqa: E402
                     jpeg_coefficients, quant_table, rle_encode, write_bmp,
                     write_jpeg, write_jpeg_tiff, write_pam, write_png,
                     write_pnm, write_tiff, ycc_planes)


def _pil(img, fmt, mode=None, **kw):
    bio = io.BytesIO()
    Image.fromarray(img, mode).save(bio, fmt, **kw)
    return bio.getvalue()


def _pil_image(im, **kw):
    bio = io.BytesIO()
    im.save(bio, "TIFF", **kw)
    return bio.getvalue()


def _pil_quantized(img, colors, fmt, **kw):
    bio = io.BytesIO()
    Image.fromarray(img).quantize(colors).save(bio, fmt, **kw)
    return bio.getvalue()


def _cv2(img, ext, params=()):
    ok, buf = cv2.imencode(ext, img, list(params))
    assert ok
    return buf.tobytes()


def _cmyk(h, w, seed):
    """uint8 CMYK: the smooth content inverted, K from another draw."""
    rgb = smooth_image(h, w, seed)
    return np.dstack([255 - rgb, smooth_image(h, w, seed + 1)[..., 0]])


def _wide(h, w, seed):
    """uint16 RGB: the smooth content scaled to 16 bits, low bits random."""
    rng = np.random.default_rng(seed)
    return (smooth_image(h, w, seed).astype(np.uint16) * 256
            + rng.integers(0, 256, (h, w, 3)).astype(np.uint16))


# name: (how it is written, a function of the fixture's index giving bytes)
FIXTURES = {
    "cmyk_q90_96x64.jpg": (
        "PIL, Adobe CMYK (APP14 transform 0), quality 90",
        lambda i: _pil(_cmyk(64, 96, i), "JPEG", "CMYK", quality=90)),
    "cmyk_progressive_q85_80x60.jpg": (
        "PIL, Adobe CMYK, progressive, quality 85",
        lambda i: _pil(_cmyk(60, 80, i), "JPEG", "CMYK", quality=85,
                       progressive=True)),
    "progressive_q75_641x479.jpg": (
        "cv2, progressive 4:2:0, quality 75",
        lambda i: encode(smooth_image(479, 641, i), "420", 75, 0, 0, 1)),
    "progressive_pil_s422_opt_150x100.jpg": (
        "PIL, progressive 4:2:2, optimised tables, quality 85",
        lambda i: _pil(smooth_image(100, 150, i), "JPEG", quality=85,
                       progressive=True, optimize=True, subsampling=1)),
    "progressive_rst2_s444_120x80.jpg": (
        "cv2, progressive 4:4:4, restart interval 2, quality 90",
        lambda i: encode(smooth_image(80, 120, i), "444", 90, 2, 0, 1)),
    "progressive_gray_64x48.jpg": (
        "cv2, progressive grayscale, quality 80",
        lambda i: encode(smooth_image(48, 64, i)[..., 1], "gray", 80, 0, 0,
                         1)),
    "palette8_trns_64x48.png": (
        "PIL, paletted 8-bit (200 colours) with a tRNS chunk",
        lambda i: _pil_quantized(smooth_image(48, 64, i), 200, "PNG",
                                 transparency=bytes(range(0, 200)))),
    "palette4_64x48.png": (
        "PIL, paletted 4-bit",
        lambda i: _pil_quantized(smooth_image(48, 64, i), 16, "PNG", bits=4)),
    "gray1_64x48.png": (
        "PIL, 1-bit gray",
        lambda i: _pil(smooth_image(48, 64, i)[..., 0] > 128, "PNG")),
    "gray_alpha_64x48.png": (
        "PIL, 8-bit gray + alpha",
        lambda i: _pil(smooth_image(48, 64, i)[..., :2], "PNG", "LA")),
    "rgb16_64x48.png": (
        "cv2, 16-bit RGB",
        lambda i: _cv2(_wide(48, 64, i)[..., ::-1], ".png")),
    "gray16_64x48.png": (
        "cv2, 16-bit gray",
        lambda i: _cv2(_wide(48, 64, i)[..., 0], ".png")),
    "rgb_adam7_64x48.png": (
        "writers.write_png, 8-bit RGB, Adam7, random filters",
        lambda i: write_png(smooth_image(48, 64, i), 8, 2, interlace=1,
                            seed=i)),
    "gray2_adam7_52x36.png": (
        "writers.write_png, 2-bit gray, Adam7, random filters",
        lambda i: write_png(smooth_image(36, 52, i)[..., :1] >> 6, 2, 0,
                            interlace=1, seed=i)),
    "lzw_pred2_64x48.tif": (
        "PIL, RGB, LZW with the horizontal predictor",
        lambda i: _pil(smooth_image(48, 64, i), "TIFF",
                       compression="tiff_lzw", tiffinfo={317: 2})),
    "deflate_64x48.tif": (
        "PIL, RGB, Deflate (Adobe, 8)",
        lambda i: _pil(smooth_image(48, 64, i), "TIFF",
                       compression="tiff_adobe_deflate")),
    "packbits_64x48.tif": (
        "PIL, RGB, PackBits",
        lambda i: _pil(smooth_image(48, 64, i), "TIFF",
                       compression="packbits")),
    "tiled_lzw_100x70.tif": (
        "writers.write_tiff, RGB, 32x32 tiles (edge tiles cropped), LZW "
        "with the predictor",
        lambda i: write_tiff(smooth_image(70, 100, i), compression=5,
                             predictor=2, tile=(32, 32))),
    "planar_deflate_64x48.tif": (
        "writers.write_tiff, RGB, planar configuration 2, Deflate with the "
        "predictor, strips of 16 rows",
        lambda i: write_tiff(smooth_image(48, 64, i), compression=8,
                             predictor=2, planar=2, rows_per_strip=16)),
    "palette_lzw_64x48.tif": (
        "PIL, paletted 8-bit, LZW",
        lambda i: _pil_quantized(smooth_image(48, 64, i), 64, "TIFF",
                                 compression="tiff_lzw")),
    "rgba_unassoc_64x48.tif": (
        "PIL, RGBA (ExtraSamples 2, unassociated alpha), LZW",
        lambda i: _pil(np.dstack([smooth_image(48, 64, i),
                                  smooth_image(48, 64, i + 1)[..., 0]]),
                       "TIFF", "RGBA", compression="tiff_lzw")),
    "gray16_mm_miniswhite_64x48.tif": (
        "writers.write_tiff, big-endian (MM), 16-bit gray min-is-white, LZW "
        "with the predictor",
        lambda i: write_tiff(_wide(48, 64, i)[..., :1], bits=16,
                             photometric=0, big_endian=True, compression=5,
                             predictor=2)),
    "bilevel_packbits_64x48.tif": (
        "PIL, 1-bit, PackBits",
        lambda i: _pil(smooth_image(48, 64, i)[..., 0] > 128, "TIFF",
                       compression="packbits")),
    "orient3_lzw_64x48.tif": (
        "writers.write_tiff, RGB, Orientation 3, LZW, strips of 10 rows",
        lambda i: write_tiff(smooth_image(48, 64, i), compression=5,
                             orientation=3, rows_per_strip=10)),
    "lzw_old_style_64x48.tif": (
        "writers.write_tiff, RGB, old-style (LSB-first) LZW codes",
        lambda i: write_tiff(smooth_image(48, 64, i), compression=5,
                             compat=True)),
}


def _index(img, n):
    """(h, w) palette indices of `img` in n levels of its gray, and the n
    colours (B, G, R) of a palette along the content's colours."""
    gray = img.astype(np.int32).sum(-1) * n // (3 * 256)
    pal = np.stack([np.linspace(20, 250, n), np.linspace(240, 10, n),
                    (np.arange(n) * 97) % 256], -1).astype(np.uint8)
    return gray, pal


def _rle_ops(idx):
    """RLE ops of (h, w) indices (stored bottom-up) that use a delta to
    skip a run of index 0 and an end-of-line to end each row early where
    it ends in index 0."""
    ops = []
    for row in idx[::-1]:
        x, w = 0, len(row)
        end = w
        while end > 0 and row[end - 1] == 0:
            end -= 1
        while x < end:
            if row[x] == 0 and x + 3 < end and not row[x:x + 3].any():
                n = 3
                while x + n < end and row[x + n] == 0:
                    n += 1
                ops.append(("delta", n, 0))
                x += n
                continue
            n = 1
            while x + n < end and n < 255 and row[x + n] == row[x]:
                n += 1
            ops.append(("run", n, int(row[x])))
            x += n
        ops.append(("eol",))
    ops.append(("eob",))
    return ops


def _webp(img, **kw):
    bio = io.BytesIO()
    Image.fromarray(img).save(bio, "WEBP", **kw)
    return bio.getvalue()


def _exif(orientation):
    exif = Image.Exif()
    exif[0x0112] = orientation
    return exif.tobytes()


def _animation(i):
    frames = [Image.fromarray(smooth_image(48, 64, i + k)) for k in range(3)]
    bio = io.BytesIO()
    frames[0].save(bio, "WEBP", save_all=True, append_images=frames[1:],
                   duration=100, quality=80)
    return bio.getvalue()


def _libwebp(img, **kw):
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import libwebp_encode

    return libwebp_encode.encode(img, **kw)


def _gray(i, h=48, w=64):
    return smooth_image(h, w, i)[..., 1]


FIXTURES.update({
    "bmp1_os2_64x48.bmp": (
        "writers.write_bmp, OS/2 12-byte header, 1-bit, 2 colours",
        lambda i: write_bmp(_index(smooth_image(48, 64, i), 2)[0], 1,
                            header=12, palette=_index(smooth_image(
                                48, 64, i), 2)[1])),
    "bmp4_short_palette_64x48.bmp": (
        "writers.write_bmp, 4-bit, a palette of 12 colours",
        lambda i: write_bmp(_index(smooth_image(48, 64, i), 12)[0], 4,
                            palette=_index(smooth_image(48, 64, i), 12)[1])),
    "bmp16_565_64x48.bmp": (
        "writers.write_bmp, 16-bit BI_BITFIELDS 5-6-5, 40-byte header",
        lambda i: write_bmp(_565(smooth_image(48, 64, i)), 16,
                            compression=BI_BITFIELDS,
                            masks=(0xF800, 0x7E0, 0x1F))),
    "bmp16_555_v5_topdown_64x48.bmp": (
        "writers.write_bmp, 16-bit BI_RGB (5-5-5), V5 header, top-down",
        lambda i: write_bmp(_555(smooth_image(48, 64, i)), 16, header=124,
                            top_down=True)),
    "bmp32_bitfields10_v4_64x48.bmp": (
        "writers.write_bmp, 32-bit BI_BITFIELDS 10-10-10 masks, V4 header",
        lambda i: write_bmp(_ten_bit(smooth_image(48, 64, i)), 32,
                            header=108, compression=BI_BITFIELDS,
                            masks=(0x3FF00000, 0xFFC00, 0x3FF, 0))),
    "bmp_rle8_deltas_64x48.bmp": (
        "writers.write_bmp, RLE8: runs, deltas, early end-of-lines",
        lambda i: write_bmp(np.zeros((48, 64), int), 8, compression=BI_RLE8,
                            palette=_index(smooth_image(48, 64, i), 40)[1],
                            rle=rle_encode(None, 8, _rle_ops(np.where(
                                _index(smooth_image(48, 64, i), 40)[0] < 12,
                                0, _index(smooth_image(48, 64, i), 40)[0]))))),
    "bmp_rle4_64x48.bmp": (
        "writers.write_bmp, RLE4, runs and absolute runs",
        lambda i: write_bmp(np.zeros((48, 64), int), 4, compression=BI_RLE4,
                            palette=_index(smooth_image(48, 64, i), 16)[1],
                            rle=rle_encode(_index(smooth_image(48, 64, i),
                                                  16)[0], 4))),
    "p2_maxval100_40x30.pgm": (
        "writers.write_pnm, P2 (ASCII), maxval 100, comments",
        lambda i: write_pnm(_gray(i, 30, 40) * 100 // 255, 2, 100,
                            comment="fixture", per_line=17)),
    "p3_maxval1000_40x30.ppm": (
        "writers.write_pnm, P3 (ASCII), maxval 1000",
        lambda i: write_pnm(smooth_image(30, 40, i).astype(int) * 1000 // 255,
                            3, 1000)),
    "p4_64x48.pbm": (
        "writers.write_pnm, P4 (binary bitmap)",
        lambda i: write_pnm(_gray(i) < 128, 4)),
    "p5_maxval65535_64x48.pgm": (
        "writers.write_pnm, P5, 16-bit samples",
        lambda i: write_pnm(_gray(i).astype(np.int64) * 257 + 3, 5, 65535)),
    "p6_64x48.ppm": (
        "writers.write_pnm, P6",
        lambda i: write_pnm(smooth_image(48, 64, i), 6)),
    "pam_rgb_64x48.pam": (
        "writers.write_pam, TUPLTYPE RGB, MAXVAL 255",
        lambda i: write_pam(smooth_image(48, 64, i), 255, "RGB")),
    "pam_gray16_64x48.pam": (
        "writers.write_pam, TUPLTYPE GRAYSCALE, MAXVAL 65535",
        lambda i: write_pam(_gray(i)[..., None].astype(np.int64) * 257,
                            65535, "GRAYSCALE")),
    "pam_blackandwhite_64x48.pam": (
        "writers.write_pam, TUPLTYPE BLACKANDWHITE (cv2's bit mode)",
        lambda i: write_pam((_gray(i) < 128)[..., None], 1,
                            "BLACKANDWHITE")),
    "webp_lossy_q80_640x480.webp": (
        "PIL, lossy, quality 80, method 4",
        lambda i: _webp(smooth_image(480, 640, i), quality=80)),
    "webp_lossless_48colours_640x480.webp": (
        "PIL, lossless, the content quantised to 48 colours",
        lambda i: _webp(np.asarray(Image.fromarray(smooth_image(
            480, 640, i)).quantize(48).convert("RGB")), lossless=True)),
    "webp_alpha_lossy_96x64.webp": (
        "PIL, RGBA: VP8X, compressed ALPH, VP8 quality 70",
        lambda i: _webp(np.dstack([smooth_image(64, 96, i),
                                   _gray(i + 1, 64, 96)]), quality=70)),
    "webp_exif6_64x48.webp": (
        "PIL, lossy, an EXIF chunk with Orientation 6",
        lambda i: _webp(smooth_image(48, 64, i), quality=85,
                        exif=_exif(6))),
    "webp_animated_64x48.webp": (
        "PIL, an animation of 3 lossy frames (imread: the first)",
        _animation),
    "webp_simple_filter_96x64.webp": (
        "libwebp WebPEncode: simple loop filter, strength 70, 4 segments",
        lambda i: _libwebp(smooth_image(64, 96, i), filter_type=0,
                           filter_strength=70, segments=4)),
    "webp_bytes_64x48.jpg": (
        "PIL, lossy WebP quality 75 under a .jpg name",
        lambda i: _webp(smooth_image(48, 64, i), quality=75)),
})


def _cut(data, frac):
    """A JPEG cut inside its first scan's data, frac of the way through
    (cv2 reads it, warning "Premature end of JPEG file")."""
    sos = data.index(b"\xff\xda")
    return data[:sos + int((len(data) - sos) * frac)]


def _renumber_restart(data, k, new):
    """The k-th RSTn of a JPEG's scan data given the number new, or
    removed (new None)."""
    pos = data.index(b"\xff\xda")
    for _ in range(k + 1):
        pos = data.index(b"\xff", pos + 2)
        while not 0xD0 <= data[pos + 1] <= 0xD7:
            pos = data.index(b"\xff", pos + 2)
    if new is None:
        return data[:pos] + data[pos + 2:]
    return data[:pos + 1] + bytes([0xD0 + new]) + data[pos + 2:]


def _unrefined(data):
    """A progressive JPEG without its last scan (cv2's script ends with the
    luma AC refinement to Al 0), so libjpeg smooths its blocks."""
    return data[:data.rindex(b"\xff\xda")] + b"\xff\xd9"


# the progressive scan script of libjpeg's jpeg_simple_progression (3
# components)
PROGRESSION = ([((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
                ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
                ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
                ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)])


def _numpy_jpeg(img, factors, quality, scans=None, **kw):
    """writers.write_jpeg of an RGB image's YCbCr planes."""
    qt = [quant_table(False, quality), quant_table(True, quality)]
    coefs = jpeg_coefficients(ycc_planes(img), factors, qt, [0, 1, 1])
    return write_jpeg(coefs, qt, [0, 1, 1], factors, img.shape[1],
                      img.shape[0], scans or [((0, 1, 2), 0, 63, 0, 0)], **kw)


def _ycck(i, quality=90):
    """writers.write_jpeg of CMYK as YCCK (Adobe transform 2): Y, Cb, Cr
    of the inverted C, M, Y, then K; 4:2:0 chroma."""
    cmyk = _cmyk(48, 64, i)
    planes = ycc_planes(255 - cmyk[..., :3]) + [
        cmyk[..., 3].astype(np.float64)]
    qt = [quant_table(False, quality), quant_table(True, quality)]
    tq = [0, 1, 1, 0]
    factors = [(2, 2), (1, 1), (1, 1), (2, 2)]
    return write_jpeg(jpeg_coefficients(planes, factors, qt, tq), qt, tq,
                      factors, 64, 48, [((0, 1, 2, 3), 0, 63, 0, 0)],
                      adobe_transform=2)


def _ycbcr_tiff(i, subsampling):
    ycc = np.clip(np.round(np.stack(ycc_planes(smooth_image(48, 64, i)),
                                    -1)), 0, 255).astype(np.uint8)
    return write_tiff(ycc, photometric=6, subsampling=subsampling,
                      rows_per_strip=16)


def _short_lzw(i):
    """An LZW TIFF (strips of 16 rows, the predictor) whose second strip's
    byte count is cut to 60%: libtiff decodes it short, leaves zeros and
    drops that strip's predictor."""
    data = bytearray(write_tiff(smooth_image(48, 64, i), compression=5,
                                predictor=2, rows_per_strip=16))
    count_at = data.index(struct.pack("<HHI", 279, 4, 3))
    at = struct.unpack("<I", data[count_at + 8:count_at + 12])[0] + 4
    (count,) = struct.unpack("<I", data[at:at + 4])
    data[at:at + 4] = struct.pack("<I", count * 6 // 10)
    return bytes(data)


def _bilevel(i):
    return Image.fromarray(smooth_image(48, 64, i)[..., 0] > 128)


FIXTURES.update({
    "cut_baseline_q75_64x48.jpg": (
        "cv2.imencode 4:2:0 q75, cut 60% into its scan",
        lambda i: _cut(encode(smooth_image(48, 64, i), "420", 75, 0, 0, 0),
                       0.6)),
    "cut_progressive_q75_64x48.jpg": (
        "cv2.imencode progressive 4:2:0 q75, cut 45% into its scans",
        lambda i: _cut(encode(smooth_image(48, 64, i), "420", 75, 0, 0, 1),
                       0.45)),
    "no_eoi_q85_64x48.jpg": (
        "cv2.imencode 4:4:4 q85 without its EOI marker",
        lambda i: encode(smooth_image(48, 64, i), "444", 85, 0, 0, 0)[:-2]),
    "rst_misnumbered_64x48.jpg": (
        "cv2.imencode 4:2:0 q80, restart interval 1, RST2 numbered RST5",
        lambda i: _renumber_restart(encode(smooth_image(48, 64, i), "420", 80,
                                           1, 0, 0), 2, 5)),
    "rst_missing_64x48.jpg": (
        "cv2.imencode progressive 4:2:2 q80, restart interval 1, its "
        "fourth RSTn removed",
        lambda i: _renumber_restart(encode(smooth_image(48, 64, i), "422", 80,
                                           1, 0, 1), 3, None)),
    "progressive_unrefined_64x48.jpg": (
        "cv2.imencode progressive 4:2:0 q75 without its last scan (block "
        "smoothing)",
        lambda i: _unrefined(encode(smooth_image(48, 64, i), "420", 75, 0, 0,
                                    1))),
    "ycck_q90_64x48.jpg": (
        "writers.write_jpeg, YCCK (Adobe transform 2), 4:2:0 chroma, q90",
        _ycck),
    "sequential_3scans_64x48.jpg": (
        "writers.write_jpeg, baseline 4:2:0 q80 in three scans of one "
        "component each",
        lambda i: _numpy_jpeg(smooth_image(48, 64, i), [(2, 2), (1, 1),
                                                        (1, 1)], 80,
                              [((0,), 0, 63, 0, 0), ((1,), 0, 63, 0, 0),
                               ((2,), 0, 63, 0, 0)])),
    "arith_rst2_64x48.jpg": (
        "writers.write_jpeg, arithmetic-coded (SOF9) 4:2:0 q80, restart "
        "interval 2",
        lambda i: _numpy_jpeg(smooth_image(48, 64, i), [(2, 2), (1, 1),
                                                        (1, 1)], 80,
                              arithmetic=True, restart=2)),
    "arith_progressive_64x48.jpg": (
        "writers.write_jpeg, arithmetic-coded progressive (SOF10) 4:4:4 "
        "q85, jpeg_simple_progression's scans",
        lambda i: _numpy_jpeg(smooth_image(48, 64, i), [(1, 1)] * 3, 85,
                              PROGRESSION, arithmetic=True,
                              progressive=True)),
    "ycbcr420_64x48.tif": (
        "writers.write_tiff, uncompressed YCbCr 2x2 subsampled, strips of "
        "16 rows",
        lambda i: _ycbcr_tiff(i, (2, 2))),
    "ycbcr422_64x48.tif": (
        "writers.write_tiff, uncompressed YCbCr 2x1 subsampled, strips of "
        "16 rows",
        lambda i: _ycbcr_tiff(i, (2, 1))),
    "lzw_short_strip_64x48.tif": (
        "writers.write_tiff, LZW with the predictor, its second strip cut "
        "to 60%", _short_lzw),
    "jpeg_ycbcr420_64x48.tif": (
        "writers.write_jpeg_tiff, JPEG-in-TIFF YCbCr 4:2:0 q80, strips of "
        "16 rows, JPEGTables",
        lambda i: write_jpeg_tiff(smooth_image(48, 64, i), 16,
                                  [(2, 2), (1, 1), (1, 1)], 80)),
    "jpeg_rgb_pil_64x48.tif": (
        "PIL, RGB, JPEG-in-TIFF (Photometric 2)",
        lambda i: _pil(smooth_image(48, 64, i), "TIFF", compression="jpeg")),
    "jpeg_gray_cv2_64x48.tif": (
        "cv2.imencode, gray, IMWRITE_TIFF_COMPRESSION 7",
        lambda i: _cv2(_gray(i), ".tif", (cv2.IMWRITE_TIFF_COMPRESSION, 7))),
    "ccitt_mh_64x48.tif": (
        "PIL, 1-bit, CCITT modified Huffman (Compression 2)",
        lambda i: _pil_image(_bilevel(i), compression="tiff_ccitt")),
    "ccitt_g3_2d_64x48.tif": (
        "PIL, 1-bit, CCITT T.4 2D (Compression 3, Group3Options 1)",
        lambda i: _pil_image(_bilevel(i), compression="group3",
                             tiffinfo={292: 1})),
    "ccitt_g4_lsb_64x48.tif": (
        "PIL, 1-bit, CCITT T.6 (Compression 4), FillOrder 2",
        lambda i: _pil_image(_bilevel(i), compression="group4",
                             tiffinfo={266: 2})),
    "cmyk_lzw_64x48.tif": (
        "PIL, CMYK, LZW",
        lambda i: _pil(_cmyk(48, 64, i), "TIFF", "CMYK",
                       compression="tiff_lzw")),
    "cmyk_planar_64x48.tif": (
        "writers.write_tiff, CMYK, PlanarConfiguration 2, uncompressed",
        lambda i: write_tiff(_cmyk(48, 64, i), photometric=5, planar=2)),
})


def _565(img):
    b, g, r = (img[..., 2].astype(int), img[..., 1].astype(int),
               img[..., 0].astype(int))
    return ((r >> 3) << 11) | ((g >> 2) << 5) | (b >> 3)


def _555(img):
    b, g, r = (img[..., 2].astype(int), img[..., 1].astype(int),
               img[..., 0].astype(int))
    return ((r >> 3) << 10) | ((g >> 3) << 5) | (b >> 3)


def _ten_bit(img):
    r, g, b = (img[..., c].astype(np.uint64) * 4 + 1 for c in range(3))
    return (r << np.uint64(20)) | (g << np.uint64(10)) | b


def main(rewrite=False):
    manifest = {}
    for i, (name, (how, make)) in enumerate(FIXTURES.items()):
        path = os.path.join(HERE, name)
        if rewrite or not os.path.exists(path):
            data = make(100 + i)
            with open(path, "wb") as f:
                f.write(data)
        else:
            with open(path, "rb") as f:
                data = f.read()
        rgb = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR),
                           cv2.COLOR_BGR2RGB)
        manifest[name] = dict(written=how, bytes=len(data),
                              shape=list(rgb.shape),
                              sha256=hashlib.sha256(rgb.tobytes()).hexdigest())
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"{len(manifest)} fixtures, "
          f"{sum(m['bytes'] for m in manifest.values())} bytes")


def time_decodes(reps=50):
    """The median host ms of read_image_rgb and of cv2.imread a fixture."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        HERE))))
    from yolosharp_tpu_torch.data.image_ops import read_image_rgb

    for name in FIXTURES:
        path = os.path.join(HERE, name)
        read_image_rgb(path)              # builds the decoders once
        times = {}
        for label, fn in (("port", read_image_rgb), ("cv2", cv2.imread)):
            t = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn(path)
                t.append(time.perf_counter() - t0)
            times[label] = np.median(t) * 1e3
        print(f"{name}: read_image_rgb {times['port']:.3f} ms, cv2.imread "
              f"{times['cv2']:.3f} ms (median of {reps})")


if __name__ == "__main__":
    if sys.argv[1:] == ["--time"]:
        time_decodes()
    else:
        main(rewrite=sys.argv[1:] == ["--all"])
